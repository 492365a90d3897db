"""Matrix-free stencil operator, on one piece or on a mesh of pieces.

Port of ``legionsolvers_tpu/parallel/stencil_op.py``.  A stencil matrix is
exactly banded, so ``matvec`` needs no stored matrix.  Two paths, chosen
when the operator is built:

* **kernel view** (``_view``, f32, unpadded blocks): 2-D grids (kind
  ``2d``, each piece an ``[Br, C]`` row block; kernels of
  ``ops/cuda/stencil2d.py`` and ``bicgstab2d.py``), 1-D grids viewed as
  ``[n // C, C]`` (kind ``2d`` with ``flat``: the 1-D shifts rewritten as
  (dy, dx) terms by ``decompose_flat_offsets``, whose row-wrap terms have
  |dx| = C - 1; the kernels run them as the 1-D stencil over the flat
  index, ``stencil2d.route``) and 3-D grids (kind ``3d``, each piece an
  ``[Br, Y, Z]`` block of whole x-planes; kernels of
  ``ops/cuda/stencil3d.py`` and ``bicgstab3d.py``, z shifts up to 128 as
  in JAX).  Every pass is a
  hand-written CUDA kernel (its plain PyTorch version on CPU tensors).
  The names ``_plan_pallas_view``/``_pallas_local``/``uses_pallas`` are
  kept from the JAX package for parity.
* **linearized path** (any dimension and dtype, and stencils beyond the
  kernels' reach): shifted 1-D slices with integer-computed boundary
  masks, in torch.

The fused runners drive the whole loop.  CG (``make_fused_cg_runner``):
the s-step schedule (one K1 pass per two iterations, 2-D), the two-pass
schedule (K4 + K3 ``update`` in 2-D, K6b + K6a ``update`` in 3-D) and the
torch recompute runner.  BiCGStab (``make_fused_bicgstab_runner``): the
three K5 (2-D) or K7 (3-D, one piece) passes per iteration.  Scalars stay
on the device throughout; no runner reads one back to the host.

Pieces (``parallel/mesh.py``): on a mesh of S shards, which all live on one
device, a vector is one tensor and piece s its row block.  Each kernel
pass runs once per piece.  2-D passes run with ZERO halo blocks: the halo
rows are copied out of the neighbouring pieces into fresh blocks before the
first piece's pass, and the terms the passes left out at the piece edges
are patched afterwards (``parallel/overlap.py`` for the matvec, the
two-pass CG and the BiCGStab passes, ``parallel/sstep_sharded.py`` for the
s-step CG).  3-D passes take their neighbours' edge x-planes as halo
planes, copied out before the first piece's pass, and need no fix-up, as
in the JAX package.  Dots are summed over the pieces in piece order.  The
per-piece steps are methods (``_*_pieces``) that the runners here and the
block phases of ``parallel/block_fused.py`` share.  The linearized path
reads its band from the neighbouring pieces.  A sharded operator runs
these paths or raises; it never falls back to one piece.  The fused 3-D
BiCGStab runner is one piece only, as in the JAX package: on 3-D pieces
BiCGStab runs ``step()`` over the sharded matvec.

On a mesh over processes (``parallel/mesh.py``) an operator runs every
path it runs on one process's pieces: the kernel view of 2-D grids, of
the 1-D view and of 3-D grids (its matvec, its CG runners, its fused
BiCGStab runner where the pieces have one) and the linearized path, each
process on its own pieces (``_nloc`` of them from piece ``_lo``).  Its
first piece's top halo rows (3-D: plane) come from the previous process
and its last piece's bottom rows from the next; the edge flags and the
linearized path's masks go by global piece index; every per-piece
partial (the dots, the Grams) is gathered and summed in piece order as on
one process, and every per-piece sum over a stack of pieces runs at the
whole mesh's stack (``mesh.full_stack``), so every rank computes the
one-process mesh's coefficients bit for bit and holds the same history.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.partition import BlockPartition
from ..options import DEFAULT_OPTIONS, SolverOptions
from .mesh import (
    full_stack,
    gather_pieces,
    local_stack,
    num_shards,
    ordered_sum,
    piece_range,
    resolve_mesh,
    shift_pieces,
    spans_processes,
)
from ..problems.stencil import (
    Stencil,
    _strides,
    calculate_stencil_size,
    create_coo_stencil_matrix,
    linear_offset,
)


class StencilOperator:
    """y = A @ x for an N-D stencil over a row-major-linearized grid."""

    def __init__(
        self,
        shape: Sequence[int],
        offsets: Stencil,
        partition: Optional[BlockPartition] = None,
        mesh=None,
        options: SolverOptions = DEFAULT_OPTIONS,
        use_pallas: bool = True,
        device=None,
    ):
        self.shape = tuple(int(d) for d in shape)
        self.offsets = [(tuple(int(c) for c in o), float(v)) for o, v in offsets]
        self.n = int(np.prod(self.shape))
        self.options = options
        if partition is None:
            S = num_shards(mesh) if mesh is not None else 1
            partition = BlockPartition(self.n, S)
        self.partition = partition
        self.mesh, self.device = resolve_mesh(mesh, partition, device)
        # the pieces this process runs: all of them but on a process mesh
        self._lo, hi = piece_range(self.mesh, partition.num_pieces)
        self._nloc = hi - self._lo
        self.strides = _strides(self.shape)
        self.lin_offsets = [linear_offset(self.shape, o) for o, _ in self.offsets]
        self.band_lo = max(0, -min(self.lin_offsets, default=0))
        self.band_hi = max(0, max(self.lin_offsets, default=0))
        # a band wider than a block reaches past the neighbouring pieces:
        # the sharded linearized path then gathers its window from the
        # whole vector instead of the ring of neighbours
        self._wide_band = (partition.num_pieces > 1 and max(
            self.band_lo, self.band_hi) > partition.block_size)
        self._view = self._plan_pallas_view() if use_pallas else None
        self._diag_cache = {}

    # -- interface parity with the explicit operators ---------------------
    @property
    def n_domain(self) -> int:
        return self.n

    @property
    def n_range(self) -> int:
        return self.n

    def nnz(self) -> int:
        return calculate_stencil_size(self.shape, self.offsets)

    def to_coo(self):
        """The explicit COO form (for parity and tests; O(nnz) host
        memory)."""
        return create_coo_stencil_matrix(self.shape, self.offsets,
                                         options=self.options)

    @property
    def uses_pallas(self) -> bool:
        """Whether the kernel view is active (name kept from the JAX
        package, where the kernels are Pallas)."""
        return self._view is not None

    @property
    def supports_matvec_dot(self) -> bool:
        """Whether :meth:`matvec_dot` is available: one piece, or pieces on
        a mesh."""
        return self.partition.num_pieces == 1 or self.mesh is not None

    @property
    def _sharded(self) -> bool:
        return self.mesh is not None and self.partition.num_pieces > 1

    # ======================================================================
    # kernel view
    # ======================================================================
    def _plan_pallas_view(self):
        """The grid view the kernels run on, or None.  Requires unpadded
        blocks that are whole rows of the grid (2-D: ``[Br, C]``; 1-D: the
        first C of 4096, 2048, ..., 128 that divides the block into at
        least 8 rows, as in the JAX package; 3-D: whole x-planes), f32 and
        a stencil within the kernels' gate: K3/K4 for 2-D grids and 1-D
        views, K6 for 3-D ones.  On several pieces each piece's halo rows
        must come from one neighbour (``Br`` >= the stencil's row reach).
        JAX's TPU gates (C % 128, row tiles that fit VMEM) are not
        Hopper's, so the port also views some 2-D grids, and 1-D blocks
        whose row count is not a multiple of 8, that JAX runs
        linearized."""
        from ..ops.cuda.stencil2d import decompose_flat_offsets
        from ..ops.cuda.stencil3d import supports3d

        if self.partition.padded_size != self.n:
            return None  # padded tail rows would need masking
        if self.options.entry_dtype != torch.float32:
            return None  # fp64 goldens take the linearized path, as in JAX
        B = self.partition.block_size
        vals = tuple(v for _, v in self.offsets)
        if len(self.shape) == 2:
            C = self.shape[1]
            if B % C:
                return None
            offs = tuple((o[0], o[1]) for o, _ in self.offsets)
            return self._view2d(B // C, C, offs, vals)
        elif len(self.shape) == 1:
            for C in (4096, 2048, 1024, 512, 256, 128):
                if B % C == 0 and B // C >= 8:
                    offs, dvals = decompose_flat_offsets(self.lin_offsets,
                                                         vals, C)
                    view = self._view2d(B // C, C, offs, dvals)
                    if view is not None:
                        return dict(view, flat=True)
        elif len(self.shape) == 3:
            _, Y, Z = self.shape
            if B % (Y * Z):
                return None  # blocks must be whole x-planes
            offs3 = tuple(o for o, _ in self.offsets)
            if supports3d(B // (Y * Z), Y, Z, offs3):
                return {"kind": "3d", "Y": Y, "Z": Z, "Br": B // (Y * Z),
                        "offs3": offs3, "vals": vals}
        return None

    def _view2d(self, Br, C, offs, vals):
        """The ``2d`` view of ``[Br, C]`` pieces, or None outside the
        kernels' gate or where a piece's halo rows would come from more
        than one neighbour."""
        from ..ops.cuda.stencil2d import supports

        reach = max(abs(dy) for dy, _ in offs)
        if self.partition.num_pieces > 1 and Br < reach:
            return None
        if supports(Br, C, offs):
            return {"kind": "2d", "C": C, "Br": Br, "offs": offs,
                    "vals": vals, "flat": False}
        return None

    def _kw(self):
        v = self._view
        offs = v["offs3"] if v["kind"] == "3d" else v["offs"]
        return dict(offsets=offs, values=v["vals"])

    def _grid(self, a: torch.Tensor) -> torch.Tensor:
        """``a`` in the grid layout of all pieces: ``[S * Br, C]`` or
        ``[S * Br, Y, Z]``."""
        v = self._view
        rows = self._nloc * v["Br"]
        if v["kind"] == "3d":
            return a.reshape(rows, v["Y"], v["Z"])
        return a.reshape(rows, v["C"])

    def _pieces(self, g: torch.Tensor) -> torch.Tensor:
        """The ``[S, Br, ...]`` view of a grid of all pieces (``[S * Br, C]``
        or ``[S * Br, Y, Z]``; on a process mesh this process's): piece s
        is ``[s]``, a contiguous view."""
        return g.view(self._nloc, self._view["Br"], *g.shape[1:])

    def _rows_reach(self):
        """(rows above, rows below) a piece that its stencil reads."""
        offs = self._view["offs"]
        return (max(0, -min(dy for dy, _ in offs)),
                max(0, max(dy for dy, _ in offs)))

    def _coeff(self, k, row_slice):
        """The multiplier of offset ``k`` (``overlap.edge_missing``)."""
        return self._view["vals"][k]

    def _exchange(self, *grids):
        """Per grid of all pieces, its ``[S, 8, C]`` (top, bottom) halo
        blocks for the stencil's row reach (``overlap.exchange_halos``)."""
        from .overlap import exchange_halos

        return exchange_halos(grids, self._nloc, *self._rows_reach(),
                              mesh=self.mesh)

    def _psum(self, parts: torch.Tensor) -> torch.Tensor:
        """The sum of per-piece f32 reductions ``[S]`` (or ``[S, k]``) in
        piece order (on a process mesh every process's, gathered)."""
        return ordered_sum(gather_pieces(self.mesh, parts), torch.float32)

    def _piece_dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """<a, b> in the entry dtype: on pieces each piece's sum, the sums
        added in piece order (the JAX package's psum of per-shard sums);
        on one piece one sum."""
        if not self._sharded:
            return torch.sum(a * b)
        S = self._nloc
        parts = local_stack(self.mesh, torch.sum(
            full_stack(self.mesh, a.reshape(S, -1) * b.reshape(S, -1)),
            dim=1))
        return ordered_sum(gather_pieces(self.mesh, parts), a.dtype)

    def _edge_flags(self, device):
        """([S, 1, 1] is-first-piece, [S, 1, 1] is-last-piece) bool masks,
        made once per device."""
        key = ("edge flags", device)
        flags = self._diag_cache.get(key)
        if flags is None:
            index = torch.arange(self._lo, self._lo + self._nloc,
                                 device=device).view(-1, 1, 1)
            flags = (index == 0, index == self.partition.num_pieces - 1)
            self._diag_cache[key] = flags
        return flags

    # -- 2-D passes on pieces: zero-halo kernels plus edge fix-ups ---------
    def _pq_pieces(self, p):
        """(<p, A p>, p's halo blocks): a zero-halo K3 ``pq`` per piece, its
        edge terms (``overlap.dot_fixup``) from p's exchanged halo rows,
        summed in piece order; the two-pass prologue."""
        from ..ops.cuda.stencil2d import grid2d_cg_pq
        from .overlap import dot_fixup

        kw = self._kw()
        (top,), (bot,) = self._exchange(p)
        p3 = self._pieces(p)
        pq = torch.stack([grid2d_cg_pq(p3[s], **kw)
                          for s in range(self._nloc)])
        pq = self._psum(pq + dot_fixup(p3, kw["offsets"], top, bot,
                                       self._coeff, mesh=self.mesh))
        return pq, (top, bot)

    def _xpay_pq_pieces(self, r, p, beta, out):
        """(p' = r + beta p written to ``out``, <p', A p'>, p''s halo
        blocks): the halo rows of r and p exchanged first; a zero-halo K4
        per piece, its <p', A p'> patched from p''s halo rows r_halo + beta
        p_halo; summed in piece order."""
        from ..ops.cuda.stencil2d import grid2d_cg_xpay_pq
        from .overlap import dot_fixup

        kw = self._kw()
        (r_top, p_top), (r_bot, p_bot) = self._exchange(r, p)
        r3, p3, o3 = (self._pieces(a) for a in (r, p, out))
        pq = torch.stack([
            grid2d_cg_xpay_pq(r3[s], p3[s], beta, out=o3[s], **kw)[1]
            for s in range(self._nloc)])
        b = beta.to(p.dtype)
        top = r_top + b * p_top
        bot = r_bot + b * p_bot
        pq = self._psum(pq + dot_fixup(o3, kw["offsets"], top, bot,
                                       self._coeff, mesh=self.mesh))
        return out, pq, (top, bot)

    def _update_pieces(self, p, x, r, alpha, halos):
        """K3 ``update`` on every piece: x and r updated in place, each
        piece reading p's halo rows from its ``[8, C]`` blocks of ``halos``
        = (top, bot); <r', r'> summed in piece order."""
        from ..ops.cuda.stencil2d import grid2d_cg_update

        kw = self._kw()
        top, bot = halos
        p3, x3, r3 = (self._pieces(a) for a in (p, x, r))
        return self._psum(torch.stack([
            grid2d_cg_update(p3[s], x3[s], r3[s], alpha, top[s], bot[s],
                             **kw)[2]
            for s in range(self._nloc)]))

    def _gram2_pieces(self, r, p):
        """The Gram vector of (r, p): a zero-halo K2 per piece, repaired
        from 4-row halos of r and p (``sstep_sharded.gram2_fixup``),
        summed in piece order."""
        from ..ops.cuda.stencil2d import grid2d_cg_gram2
        from .sstep_sharded import exchange_halo4, gram2_fixup

        kw = self._kw()
        S = self._nloc
        halos = exchange_halo4(r, p, S, self.mesh)
        r3, p3 = self._pieces(r), self._pieces(p)
        g = torch.stack([grid2d_cg_gram2(r3[s], p3[s], **kw)
                         for s in range(S)])
        return self._psum(gram2_fixup(g, r, p, halos, kw["offsets"],
                                      kw["values"], S, self.mesh))

    def _step2_pieces(self, x, r, p, coef, spare):
        """One s-step pass on every piece: x'' over x, r'' and p'' into the
        pair ``spare``; a zero-halo K1 per piece after the 4-row halos of r
        and p (and x's edge strips, which K1 overwrites) are taken, the
        edges and Grams repaired (``sstep_sharded.step2_fixup``), the Grams
        summed in piece order.  Returns (x, r'', p'', gram)."""
        from ..ops.cuda.stencil2d import grid2d_cg_step2
        from .sstep_sharded import STRIP, exchange_halo4, step2_fixup

        kw = self._kw()
        S = self._nloc
        Br = self._view["Br"]
        halos = exchange_halo4(r, p, S, self.mesh)
        x3, r3, p3 = (self._pieces(a) for a in (x, r, p))
        # r and p are not written by the passes (r'' and p'' go to the
        # spares), x is: its strips are copied first
        saves = (x3[:, :STRIP].clone(), r3[:, :STRIP], p3[:, :STRIP],
                 x3[:, Br - STRIP:].clone(), r3[:, Br - STRIP:],
                 p3[:, Br - STRIP:])
        sr3, sp3 = self._pieces(spare[0]), self._pieces(spare[1])
        g = torch.stack([
            grid2d_cg_step2(x3[s], r3[s], p3[s], coef,
                            out=(sr3[s], sp3[s]), **kw)[3]
            for s in range(S)])
        x, rn, pn, g = step2_fixup((x, spare[0], spare[1], g), saves, halos,
                                   coef, kw["offsets"], kw["values"], S,
                                   self.mesh)
        return x, rn, pn, self._psum(g)

    def _odd_update_pieces(self, p, x, r, alpha):
        """One CG update of x and r (in place) with the current p, on p's
        exchanged halo rows: the s-step schedule's odd trailing iteration.
        Returns <r', r'>."""
        (top,), (bot,) = self._exchange(p)
        return self._update_pieces(p, x, r, alpha, (top, bot))

    def _pallas_sharded(self, x: torch.Tensor, *, with_dot: bool = False):
        """The matvec on S pieces: a zero-halo K3 pass per piece into its
        rows of y, then the edge terms it left out (and their share of <x,
        A x>) from the exchanged halo rows."""
        from ..ops.cuda.stencil2d import grid2d_stencil_matvec
        from .overlap import apply_edge_fixup, dot_fixup

        xg = self._grid(x)
        (top,), (bot,) = self._exchange(xg)
        y = torch.empty_like(xg)
        x3, y3 = self._pieces(xg), self._pieces(y)
        kw = self._kw()
        outs = [grid2d_stencil_matvec(x3[s], with_dot=with_dot, out=y3[s],
                                      **kw)
                for s in range(self._nloc)]
        offs = kw["offsets"]
        if with_dot:
            dots = torch.stack([d for _, d in outs])
            dots = dots + dot_fixup(x3, offs, top, bot, self._coeff,
                                    mesh=self.mesh)
        apply_edge_fixup(y3, offs, top, bot, self._coeff)
        if with_dot:
            return y.reshape(x.shape), self._psum(dots)
        return y.reshape(x.shape)

    # -- 3-D passes on pieces: real halo planes, no fix-up -----------------
    def _planes3d(self, *grids):
        """(tops, bots): per 3-D grid of all pieces (``[S * Br, Y, Z]``),
        its ``[S, Y, Z]`` x-halo planes: piece s's top plane is the last
        x-plane of piece s - 1, its bottom plane the first x-plane of piece
        s + 1, zeros at the grid's ends.  The planes of all grids are cut
        from one fresh tensor per side (two torch launches per side for any
        number of grids and pieces), so they are copies taken before any
        pass writes; piece s's plane ``[s]`` is a contiguous ``[Y, Z]``
        tensor.  A side the stencil does not read (no ``ox < 0``, or no
        ``ox > 0``) and every side of one piece is ``None``: zero planes.
        On a mesh over processes the grids hold this process's pieces: the
        first one's top plane comes from the previous process's last
        piece, the last one's bottom plane from the next process's first
        (``mesh.shift_pieces``, zeros at the grid's ends by global piece
        index)."""
        S = self.partition.num_pieces
        offs3 = self._view["offs3"]
        vols = [self._pieces(g) for g in grids]
        across = spans_processes(self.mesh)

        def side(top):
            need = any((o[0] < 0) if top else (o[0] > 0) for o in offs3)
            if S == 1 or not need:
                return (None,) * len(grids)
            if across:
                edge = torch.stack([v[:, -1] if top else v[:, 0]
                                    for v in vols], 1)
                return shift_pieces(self.mesh, edge, 1 if top else -1,
                                    wrap=False).unbind(1)
            edge = torch.stack([v[:-1, -1] if top else v[1:, 0]
                                for v in vols], 1)
            pad = (0, 0, 0, 0, 0, 0, 1, 0) if top else (0, 0, 0, 0, 0, 0, 0,
                                                       1)
            return F.pad(edge, pad).unbind(1)

        return side(True), side(False)

    def _exchange_planes3d(self, g: torch.Tensor):
        """([S, Y, Z] top, [S, Y, Z] bot) x-halo planes of the 3-D grid
        ``g`` of all pieces (:meth:`_planes3d`): the neighbours' edge
        planes, zeros at the grid's ends, ``None`` where the stencil does
        not read them and on one piece, whose neighbours are the grid's
        boundary."""
        (top,), (bot,) = self._planes3d(g)
        return top, bot

    @staticmethod
    def _plane(planes, s):
        """Piece s's ``[Y, Z]`` plane of ``[S, Y, Z]`` planes (None stays
        None)."""
        return None if planes is None else planes[s]

    def _pq3d_pieces(self, p):
        """(<p, A p>, p's planes): K6a ``pq`` per piece on p's halo planes,
        summed in piece order."""
        from ..ops.cuda.stencil3d import grid3d_cg_pq

        kw, pl = self._kw(), self._plane
        top, bot = self._exchange_planes3d(p)
        p3 = self._pieces(p)
        pq = torch.stack([grid3d_cg_pq(p3[s], pl(top, s), pl(bot, s), **kw)
                          for s in range(self._nloc)])
        return self._psum(pq), (top, bot)

    def _xpay_pq3d_pieces(self, r, p, beta, out):
        """(p' = r + beta p written to ``out``, <p', A p'>, p''s planes):
        the planes of r and p exchanged first, p''s planes r_plane + beta
        p_plane; K6b per piece on them; summed in piece order."""
        from ..ops.cuda.stencil3d import grid3d_cg_xpay_pq

        kw, pl = self._kw(), self._plane
        (r_top, p_top), (r_bot, p_bot) = self._planes3d(r, p)
        b = beta.to(p.dtype)
        top = None if r_top is None else r_top + b * p_top
        bot = None if r_bot is None else r_bot + b * p_bot
        r3, p3, o3 = (self._pieces(a) for a in (r, p, out))
        pq = torch.stack([
            grid3d_cg_xpay_pq(r3[s], p3[s], beta, pl(top, s), pl(bot, s),
                              out=o3[s], **kw)[1]
            for s in range(self._nloc)])
        return out, self._psum(pq), (top, bot)

    def _update3d_pieces(self, p, x, r, alpha, planes):
        """K6a ``update`` per piece on p's ``planes`` = (top, bot): x and r
        updated in place, <r', r'> summed in piece order."""
        from ..ops.cuda.stencil3d import grid3d_cg_update

        kw, pl = self._kw(), self._plane
        top, bot = planes
        p3, x3, r3 = (self._pieces(a) for a in (p, x, r))
        return self._psum(torch.stack([
            grid3d_cg_update(p3[s], x3[s], r3[s], alpha, pl(top, s),
                             pl(bot, s), **kw)[2]
            for s in range(self._nloc)]))

    def _pallas_local_3d(self, x: torch.Tensor, *, with_dot: bool = False):
        """The 3-D matvec: on one piece one K6a pass with zero planes; on S
        pieces K6a per piece into its planes of y, each with its
        neighbours' edge planes (the same terms in the same order per
        element as on one piece), the dots summed in piece order."""
        from ..ops.cuda.stencil3d import grid3d_stencil_matvec

        g = self._grid(x)
        kw = self._kw()
        if not self._sharded:
            out = grid3d_stencil_matvec(g, with_dot=with_dot, **kw)
            if with_dot:
                y, dot = out
                return y.reshape(x.shape), dot
            return out.reshape(x.shape)
        top, bot = self._exchange_planes3d(g)
        y = torch.empty_like(g)
        g3, y3 = self._pieces(g), self._pieces(y)
        pl = self._plane
        outs = [grid3d_stencil_matvec(g3[s], pl(top, s), pl(bot, s),
                                      with_dot=with_dot, out=y3[s], **kw)
                for s in range(self._nloc)]
        if with_dot:
            return y.reshape(x.shape), self._psum(
                torch.stack([d for _, d in outs]))
        return y.reshape(x.shape)

    def _pallas_local(self, x: torch.Tensor, *, with_dot: bool = False):
        from ..ops.cuda.stencil2d import grid2d_stencil_matvec

        if self._view["kind"] == "3d":
            return self._pallas_local_3d(x, with_dot=with_dot)
        if self._sharded:
            return self._pallas_sharded(x, with_dot=with_dot)
        out = grid2d_stencil_matvec(self._grid(x), with_dot=with_dot,
                                    **self._kw())
        if with_dot:
            y, dot = out
            return y.reshape(x.shape), dot
        return out.reshape(x.shape)

    # ======================================================================
    # linearized path: shifted 1-D slices + integer boundary masks
    # ======================================================================
    def _diag_values(self, dtype, device):
        """Per-offset masked diagonal values over the padded index space."""
        key = (dtype, device)
        if key not in self._diag_cache:
            B = self.partition.block_size
            g = torch.arange(self._lo * B, (self._lo + self._nloc) * B,
                             device=device)
            dvals = []
            for off, v in self.offsets:
                m = g < self.n
                for d, o in enumerate(off):
                    if o:
                        p_d = (g // self.strides[d]) % self.shape[d]
                        m = m & (p_d + o >= 0) & (p_d + o < self.shape[d])
                dvals.append(m.to(dtype) * torch.tensor(v, dtype=dtype))
            self._diag_cache[key] = dvals
        return self._diag_cache[key]

    def _linear_local(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x over the flat padded vector."""
        N = self.partition.padded_size
        lo = self.band_lo
        x_ext = F.pad(x, (lo, self.band_hi))
        y = torch.zeros_like(x)
        for dval, doff in zip(self._diag_values(x.dtype, x.device),
                              self.lin_offsets):
            y = y + dval * x_ext[lo + doff: lo + doff + N]
        return y

    def _piece_windows(self, x: torch.Tensor) -> torch.Tensor:
        """``[S, lo + B + hi]``: each piece's block of the flat vector with
        its band from the neighbouring pieces
        (``overlap.piece_windows``)."""
        from .overlap import piece_windows

        return piece_windows(x, self._nloc, self.band_lo, self.band_hi,
                             self._wide_band, self._diag_cache, self.mesh)

    def _linear_pieces(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x over the flat padded vector of several pieces, piece by
        piece (all pieces in one set of torch launches) from
        :meth:`_piece_windows`: the JAX package's sharded ``_linear_local``
        and, without a mesh, its ``_unsharded_multiblock`` (same
        values)."""
        S, B = self._nloc, self.partition.block_size
        lo = self.band_lo
        x_ext = self._piece_windows(x)
        y = x.new_zeros(S, B)
        for dval, doff in zip(self._diag_values(x.dtype, x.device),
                              self.lin_offsets):
            y = y + dval.view(S, B) * x_ext[:, lo + doff: lo + doff + B]
        return y.reshape(-1)

    def _whole(self) -> "StencilOperator":
        """The same stencil on one piece over the whole grid: the matvec
        of a multi-piece kernel view without a mesh (same values)."""
        if not hasattr(self, "_whole_op"):
            self._whole_op = StencilOperator(
                self.shape, self.offsets, partition=BlockPartition(self.n, 1),
                options=self.options, device=self.device)
        return self._whole_op

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x.  ``x`` may be flat or (with the kernel view) the grid
        layout; the result matches the input layout."""
        if x.dim() > 1 and self._view is None:
            raise ValueError("grid-layout input requires the kernel view")
        if self.partition.num_pieces > 1 and self.mesh is None:
            if x.dim() > 1:
                raise ValueError(
                    "grid/fused-dot input needs a mesh or a single piece")
            if self._view is not None:
                return self._whole().matvec(x)
            return self._linear_pieces(x)
        if self._view is not None:
            return self._pallas_local(x)
        if self._sharded:
            return self._linear_pieces(x)
        return self._linear_local(x)

    def matvec_dot(self, x: torch.Tensor):
        """(A @ x, <x, A x>), the reduction fused into the kernel pass on
        the kernel view; on pieces the per-piece dots summed in piece
        order."""
        if not self.supports_matvec_dot:
            raise ValueError(
                "grid/fused-dot input needs a mesh or a single piece")
        if self._view is not None:
            return self._pallas_local(x, with_dot=True)
        y = self.matvec(x)
        return y, self._piece_dot(x, y)

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    # ======================================================================
    # fused CG runners
    # ======================================================================
    @property
    def supports_fused_cg(self) -> bool:
        """A fused runner exists for every single-piece operator and every
        operator on a mesh: the kernel schedules on the view, the torch
        recompute runner otherwise.  Several pieces without a mesh have
        none."""
        return self.partition.num_pieces == 1 or self.mesh is not None

    @property
    def step2_eligible(self) -> bool:
        """Whether the s-step schedule (two iterations per K1 pass) applies:
        2-D kernel view within K1's gate (``stencil2d.step2_supported``:
        |dy| <= 1 and |dx| < C; the strip march for a reach-1 stencil, the
        march along the flat index for the 1-D view of a 1-D stencil that
        ``csrc/flat1d.cu`` compiles, the general route for any other), not
        disabled by LEGIONSOLVERS_NO_SSTEP.  Pieces qualify on
        a mesh with blocks of at least 2 * STRIP rows, so that the two edge
        strips of a piece do not overlap, and with no |dx| past MAX_DX, as
        in the JAX package; the passes stay zero-halo and
        ``parallel/sstep_sharded.py`` repairs their edges.  A 1-D view on
        pieces does not qualify: as in the JAX package, whose edge fix-ups
        do not model the row-wrap terms, it runs the two-pass schedule."""
        from ..ops.cuda.stencil2d import step2_supported
        from .sstep_sharded import MAX_DX, STRIP

        if os.environ.get("LEGIONSOLVERS_NO_SSTEP"):
            return False
        v = self._view
        if v is None or v["kind"] == "3d":
            return False
        if self.partition.num_pieces > 1:
            if (self.mesh is None or v["Br"] < 2 * STRIP or v["flat"]
                    or any(abs(dx) > MAX_DX for _, dx in v["offs"])):
                return False
        return step2_supported(v["Br"], v["C"], v["offs"], v["vals"])

    def _make_step2_cg_runner(self, num_iterations: int):
        """s-step fused CG: one K1 pass per TWO iterations, both
        iterations' coefficients derived (cg2_coeffs) from the Gram matrix
        of {r, Ar, p, Ap, A^2p} that the previous pass emitted.  A K2 pass
        bootstraps the recurrence from any (x, r, p, rr) state; an odd
        trailing iteration runs as a K3 ``update`` plus a torch xpay.

        ``run(x, r, p, rr0) -> (x, r, p, history)``: x is updated in place
        and r, p alternate with one ping-pong pair of buffers, so the
        inputs must not share storage with anything the caller keeps.
        History entries after odd iterations are the Gram-derived rr1,
        after even iterations the next Gram's <r, r>.

        Every LEGIONSOLVERS_SSTEP_REFRESH passes (default 16; 0 disables)
        the Gram is re-measured by a K2 pass, bounding the drift of the
        monomial basis.

        On S pieces every K1 and K2 pass runs once per piece with zero
        halos, after the 4-row input halos of every piece (and K1's input
        strips of x, which K1 overwrites) have been taken; the edges and
        Grams are repaired (``parallel/sstep_sharded.py``) and the Grams
        summed in piece order before the one ``cg2_coeffs`` of the pass.
        The odd tail runs K3 ``update`` per piece on p's exchanged halo
        rows, as the two-pass runner on pieces does."""
        from ..ops.cuda.stencil2d import (
            cg2_coeffs,
            grid2d_cg_gram2,
            grid2d_cg_step2,
            grid2d_cg_update,
        )

        kw = self._kw()
        K, odd = divmod(num_iterations, 2)
        refresh = int(os.environ.get("LEGIONSOLVERS_SSTEP_REFRESH", "16"))
        sharded = self.partition.num_pieces > 1

        def gram(r, p):
            if not sharded:
                return grid2d_cg_gram2(r, p, **kw)
            return self._gram2_pieces(r, p)

        def step2(x, r, p, coef, spare):
            if not sharded:
                return grid2d_cg_step2(x, r, p, coef, out=spare, **kw)
            return self._step2_pieces(x, r, p, coef, spare)

        def odd_update(x, r, p, alpha):
            """One CG update of x and r with the current p; <r', r'>."""
            if not sharded:
                return grid2d_cg_update(p, x, r, alpha, **kw)[2]
            return self._odd_update_pieces(p, x, r, alpha)

        def run(x, r, p, rr0):
            shape = x.shape
            x, r, p = self._grid(x), self._grid(r), self._grid(p)
            hist = [torch.as_tensor(rr0, dtype=torch.float32,
                                    device=x.device)]
            spare = (torch.empty_like(r), torch.empty_like(p))

            def passes(g, r, p, spare, count):
                for _ in range(count):
                    coef, rr1, _ = cg2_coeffs(g)
                    _, rn, pn, g = step2(x, r, p, coef, spare)
                    spare, r, p = (r, p), rn, pn
                    hist.extend((rr1, g[0]))
                return g, r, p, spare

            g = gram(r, p)
            if refresh > 0 and K > refresh:
                n_blocks, rem = divmod(K, refresh)
                g, r, p, spare = passes(g, r, p, spare, refresh)
                for _ in range(n_blocks - 1):
                    g = gram(r, p)
                    g, r, p, spare = passes(g, r, p, spare, refresh)
                if rem:
                    g = gram(r, p)
                    g, r, p, spare = passes(g, r, p, spare, rem)
            else:
                g, r, p, spare = passes(g, r, p, spare, K)
            if odd:
                rr_new = odd_update(x, r, p, g[0] / g[1])
                hist.append(rr_new)
                p = r + (rr_new / g[0]).to(p.dtype) * p
            return (x.reshape(shape), r.reshape(shape), p.reshape(shape),
                    torch.stack(hist))

        return run

    def make_fused_cg_runner(self, num_iterations: int):
        """A whole-loop CG runner, ``run(x, r, p, rr0) -> (x, r, p,
        history)`` with history[0] = rr0; inputs flat or grid layout, and
        consumed (updated in place).  On the 2-D kernel view it is the
        s-step schedule where :attr:`step2_eligible`, otherwise two passes
        per iteration:

        * K4 ``xpay_pq``: p = r + beta p and <p, A p> (A p never stored);
        * K3 ``update``: x += alpha p, r -= alpha A p, <r, r>.

        Iteration 0 uses the incoming p (a K3 ``pq`` pass instead of
        ``xpay_pq``), so the loop continues standard CG exactly from any
        (x, r, p, rr) state.  The 3-D view runs the same schedule on K6
        (:meth:`_make_pallas3d_cg_runner`)."""
        if num_iterations < 1:
            raise ValueError("fused CG runner needs at least one iteration")
        if not self.supports_fused_cg:
            raise ValueError("a fused runner over several pieces needs a "
                             "mesh")
        if self._view is None:
            return self._make_jnp_cg_runner(num_iterations)
        if self._view["kind"] == "3d":
            return self._make_pallas3d_cg_runner(num_iterations)
        if num_iterations >= 2 and self.step2_eligible:
            return self._make_step2_cg_runner(num_iterations)

        from ..ops.cuda.stencil2d import (
            grid2d_cg_pq,
            grid2d_cg_update,
            grid2d_cg_xpay_pq,
        )

        if self._sharded:
            return self._sharded_two_pass_cg_runner(num_iterations)
        return self._two_pass_cg_runner(num_iterations, grid2d_cg_pq,
                                        grid2d_cg_update, grid2d_cg_xpay_pq)

    def _make_pallas3d_cg_runner(self, num_iterations: int):
        """Fused CG over the 3-D kernels: a K6a ``pq`` + ``update``
        prologue on the incoming p, then per iteration K6b ``xpay_pq`` (p =
        r + beta p formed while loading, 12 B/elt) + K6a ``update`` (20
        B/elt), 32 B/unknown.  On one piece p's halo planes are zero
        (``None``); on S pieces every pass runs once per piece with its
        neighbours' planes (:meth:`_sharded_two_pass_cg_runner`).  Same
        contract as the 2-D runners."""
        from ..ops.cuda.stencil3d import (
            grid3d_cg_pq,
            grid3d_cg_update,
            grid3d_cg_xpay_pq,
        )

        if self._sharded:
            return self._sharded_two_pass_cg_runner(
                num_iterations, self._pq3d_pieces, self._xpay_pq3d_pieces,
                self._update3d_pieces)
        return self._two_pass_cg_runner(num_iterations, grid3d_cg_pq,
                                        grid3d_cg_update, grid3d_cg_xpay_pq)

    def _two_pass_cg_runner(self, num_iterations, cg_pq, cg_update,
                            cg_xpay_pq):
        """The two-pass schedule on the given pass wrappers (2-D or 3-D,
        which take the same arguments).  x and r are updated in place; p
        alternates with one spare, because ``xpay_pq`` cannot write p over
        the p_old that neighbouring blocks read."""
        kw = self._kw()

        def run(x, r, p, rr0):
            shape = x.shape
            x, r, p = self._grid(x), self._grid(r), self._grid(p)
            rr = torch.as_tensor(rr0, dtype=torch.float32, device=x.device)
            hist = [rr]
            pq = cg_pq(p, **kw)
            _, r, rr_new = cg_update(p, x, r, rr / pq, **kw)
            hist.append(rr_new)
            spare = torch.empty_like(p)
            for _ in range(1, num_iterations):
                rr_prev, rr = rr, rr_new
                pn, pq = cg_xpay_pq(r, p, rr / rr_prev, out=spare, **kw)
                spare, p = p, pn
                _, r, rr_new = cg_update(p, x, r, rr / pq, **kw)
                hist.append(rr_new)
            return (x.reshape(shape), r.reshape(shape), p.reshape(shape),
                    torch.stack(hist))

        return run

    def _sharded_two_pass_cg_runner(self, num_iterations: int,
                                    pq_pieces=None, xpay_pq_pieces=None,
                                    update_pieces=None):
        """The two-pass schedule on S pieces, on the per-piece steps given
        (default: the 2-D ones).  2-D: per iteration the halo rows of r
        and p are exchanged first; K4 runs per piece with zero halos and
        its <p, A p> is patched from p's halo rows r_halo + beta p_halo
        (``overlap.dot_fixup``); K3 ``update`` runs per piece with those
        halo rows; the prologue is a zero-halo K3 ``pq`` per piece with the
        same fix-up.  3-D: the x-planes of r and p are exchanged first and
        K6b and K6a ``update`` run per piece on p's planes r_plane + beta
        p_plane; the prologue is K6a ``pq`` and ``update`` on p's planes.
        Every plane and halo row is copied out before the iteration's first
        launch: ``update`` writes x and r in place, K4 and K6b write p'
        into the spare.  Dots are summed in piece order.  Buffers as in
        :meth:`_two_pass_cg_runner`."""
        pq_pieces = pq_pieces or self._pq_pieces
        xpay_pq_pieces = xpay_pq_pieces or self._xpay_pq_pieces
        update_pieces = update_pieces or self._update_pieces

        def run(x, r, p, rr0):
            shape = x.shape
            x, r, p = self._grid(x), self._grid(r), self._grid(p)
            rr = torch.as_tensor(rr0, dtype=torch.float32, device=x.device)
            hist = [rr]
            pq, halos = pq_pieces(p)
            rr_new = update_pieces(p, x, r, rr / pq, halos)
            hist.append(rr_new)
            spare = torch.empty_like(p)
            for _ in range(1, num_iterations):
                rr_prev, rr = rr, rr_new
                pn, pq, halos = xpay_pq_pieces(r, p, rr / rr_prev, spare)
                spare, p = p, pn
                rr_new = update_pieces(p, x, r, rr / pq, halos)
                hist.append(rr_new)
            return (x.reshape(shape), r.reshape(shape), p.reshape(shape),
                    torch.stack(hist))

        return run

    def _make_jnp_cg_runner(self, num_iterations: int):
        """Whole-loop CG for operators without the kernel view (fp64
        goldens, 1-D grids, stencils beyond the kernels' reach): the
        classic schedule with the linearized matvec, in the arithmetic
        order of ``CGSolver.step``
        (reference: CGSolver.hpp:46-55).  On a mesh the matvec reads each
        piece's band from its neighbours and the dots are summed in piece
        order.  Name kept from the JAX package."""
        matvec = self._linear_pieces if self._sharded else self._linear_local
        dot = self._piece_dot

        def run(x, r, p, rr0):
            shape = x.shape
            x, r, p = (a.reshape(-1) for a in (x, r, p))
            rr = torch.as_tensor(rr0, dtype=x.dtype, device=x.device)
            hist = [rr]
            for _ in range(num_iterations):
                q = matvec(p)
                alpha = rr / dot(p, q)
                x = x + alpha * p
                r = r - alpha * q
                rr_new = dot(r, r)
                hist.append(rr_new)
                p = r + (rr_new / rr) * p
                rr = rr_new
            return (x.reshape(shape), r.reshape(shape), p.reshape(shape),
                    torch.stack(hist))

        return run

    # ======================================================================
    # fused BiCGStab runner
    # ======================================================================
    @property
    def supports_fused_bicgstab(self) -> bool:
        """Whether :meth:`make_fused_bicgstab_runner` is available: the
        kernel view within the K5 (2-D) or K7 (3-D) gate, not disabled by
        LEGIONSOLVERS_NO_FUSED_BICGSTAB; pieces on a mesh with blocks of at
        least 16 rows, as in the JAX package (zero-halo passes whose edge
        terms are repaired, :meth:`_sharded_bicgstab_runner`); never on
        3-D pieces, whose fused runner the JAX package has for one piece
        only."""
        from ..ops.cuda.bicgstab2d import bicgstab_supported
        from ..ops.cuda.bicgstab3d import supports3d_bicgstab

        if os.environ.get("LEGIONSOLVERS_NO_FUSED_BICGSTAB"):
            return False
        v = self._view
        if v is None:
            return False
        if v["kind"] == "3d":
            if self.partition.num_pieces > 1:
                return False
            return supports3d_bicgstab(v["Br"], v["Y"], v["Z"], v["offs3"])
        if self.partition.num_pieces > 1:
            if self.mesh is None or v["Br"] < 16:
                return False
        return bicgstab_supported(v["Br"], v["C"], v["offs"])

    def make_fused_bicgstab_runner(self, num_iterations: int):
        """Whole-loop BiCGStab on the three K5 passes (K7 on the 3-D view:
        :meth:`_make_bicgstab3d_runner`; 60 B/unknown per iteration at
        f32), or None where :attr:`supports_fused_bicgstab` is False.
        Contract: ``run(x, r, p, v, rt, rho, alpha, omega) -> (x, r, p, v,
        rho, alpha, omega, history)`` with history[0] = <r, r>
        on entry; an exact continuation of the transcription recurrence
        (reference: BiCGStabSolver.hpp:64-82) from any state.  Inputs are
        flat or grid layout; outputs take the input layout.

        Per iteration: ``pv`` gives p', v' = A p' and <r~, v'> (alpha);
        ``st`` gives <t, s> and <t, t> (omega); ``update`` gives x', r',
        <r', r'> (history) and <r~, r'> (the next rho).  About six scalar
        ops on 0-dim device tensors join them; nothing is read back.

        Buffers: x is updated in place.  p, v and r alternate with
        ping-pong spares, because a pass writing p, v or r in place would
        race a neighbouring block's halo read.  So the runner holds eight
        live grid vectors (x, r, r', p, p', v', v, r~: 537 MB at 4096^2,
        537 MB at 256^3) where the JAX runner holds five; it writes into
        the x, r, p and v it is given (which must share no storage with r~
        or each other) and never into r~."""
        if not self.supports_fused_bicgstab:
            return None
        if self._sharded:
            return self._sharded_bicgstab_runner(num_iterations)
        if self._view["kind"] == "3d":
            return self._make_bicgstab3d_runner(num_iterations)
        from ..ops.cuda.bicgstab2d import bicg_pv, bicg_st, bicg_update

        return self._bicgstab_runner(num_iterations, bicg_pv, bicg_st,
                                     bicg_update)

    def _make_bicgstab3d_runner(self, num_iterations: int):
        """The fused BiCGStab loop on the three K7 passes; single device,
        so the combined operands' halo planes are zero (``None``)."""
        from ..ops.cuda.bicgstab3d import bicg3d_pv, bicg3d_st, bicg3d_update

        return self._bicgstab_runner(num_iterations, bicg3d_pv, bicg3d_st,
                                     bicg3d_update)

    def _bicgstab_runner(self, num_iterations, pv, st, update):
        """The loop of :meth:`make_fused_bicgstab_runner` on the given pass
        wrappers (2-D or 3-D, which take the same arguments)."""
        from ..ops.cuda.bicgstab2d import _pdot

        kw = self._bicg_kw()
        dot = lambda a, b: _pdot(a, b, kw["compensated"])

        def run(x, r, p, v, rt, rho, alpha, omega):
            shape = x.shape
            x, r, p, v, rt = (self._grid(a) for a in (x, r, p, v, rt))
            rho, alpha, omega = (
                torch.as_tensor(a).to(device=x.device, dtype=torch.float32)
                for a in (rho, alpha, omega))
            hist = [dot(r, r)]
            rtr = dot(rt, r)
            spare_r, spare_p, spare_v = (torch.empty_like(a)
                                         for a in (r, p, v))
            for _ in range(num_iterations):
                rho_new = rtr
                beta = (rho_new / rho) * (alpha / omega)
                pn, vn, rtv = pv(r, p, v, rt, beta, omega,
                                 out=(spare_p, spare_v), **kw)
                spare_p, spare_v, p, v = p, v, pn, vn
                alpha = rho_new / rtv
                ts, tt = st(r, v, alpha, **kw)
                omega = ts / tt
                _, rn, rr, rtr = update(r, v, x, p, rt, alpha, omega,
                                        out=spare_r, **kw)
                spare_r, r = r, rn
                hist.append(rr)
                rho = rho_new
            x, r, p, v = (a.reshape(shape) for a in (x, r, p, v))
            return x, r, p, v, rho, alpha, omega, torch.stack(hist)

        return run

    # -- 2-D BiCGStab passes on pieces: zero-halo kernels plus fix-ups -----
    def _bicg_kw(self):
        return dict(self._kw(),
                    compensated=bool(self.options.compensated_dots))

    def _bicg_boot_pieces(self, r, rt):
        """(<r, r>, <r~, r>) on pieces: one dot per piece (compensated: one
        rounding of a float64 sum per piece), each summed at the whole
        mesh's stack, the sums added in piece order."""
        S, mesh = self._nloc, self.mesh
        if self.options.compensated_dots:
            def d(a, b):
                a2, b2 = (full_stack(mesh, t.reshape(S, -1))
                          .to(torch.float32).double() for t in (a, b))
                return local_stack(mesh, torch.sum(a2 * b2, dim=1)).to(
                    torch.float32)
        else:
            def d(a, b):
                return local_stack(mesh, torch.sum(
                    full_stack(mesh, a.reshape(S, -1) * b.reshape(S, -1)),
                    dim=1, dtype=torch.float32))
        return self._psum(d(r, r)), self._psum(d(rt, r))

    def _edge_sum(self, *terms):
        """Per piece, the f32 sum of the ``[S, rows, C]`` edge terms given
        (None: a side the stencil does not read), one term after the
        other, each summed at the whole mesh's stack; 0.0 where there is
        none."""
        f = None
        for t in terms:
            if t is not None:
                t = local_stack(self.mesh, torch.sum(
                    full_stack(self.mesh, t), dim=(-2, -1),
                    dtype=torch.float32))
                f = t if f is None else f + t
        return 0.0 if f is None else f

    def _pad8(self, top, bot):
        """``[S, 8, C]`` halo blocks in the kernels' and ``overlap.py``'s
        contract, the top rows last and the bottom rows first, from the
        ``[S, rlo, C]`` and ``[S, rhi, C]`` rows (None where the stencil
        reads no row on that side)."""
        rlo, rhi = self._rows_reach()
        return (F.pad(top, (0, 0, 8 - rlo, 0)) if rlo else None,
                F.pad(bot, (0, 0, 0, 8 - rhi)) if rhi else None)

    def _bicg_pv_pieces(self, r, p, v, rt, beta, omega, out):
        """The pv pass on S pieces.  ONE exchange per iteration: the rows
        of r, p and v at depth 2 rlo above and 2 rhi below every piece,
        copied out before any launch.  K5a runs per piece with zero halos,
        p' and v' into the pair ``out``; p' on the halo rows follows
        elementwise (r + beta (p - omega v)) and v' = A p' is repaired at
        the piece edges from it (``overlap.edge_missing``), in place in
        ``out[1]``, the buffer the st pass reads; <r~, v'> per piece plus
        its edge terms, summed in piece order.  Returns (p', v', <r~, v'>,
        ctx for :meth:`_bicg_st_pieces`)."""
        from ..ops.cuda.bicgstab2d import bicg_pv
        from .overlap import edge_missing, exchange_halos

        S = self._nloc
        Br = self._view["Br"]
        rlo, rhi = self._rows_reach()
        kw = self._bicg_kw()
        depth = max(2 * rlo, 2 * rhi, 1)
        tops, bots = exchange_halos((r, p, v), S, 2 * rlo, 2 * rhi, depth,
                                    mesh=self.mesh)
        r_t, p_t, v_t = (a[:, depth - 2 * rlo:] for a in tops)
        r_b, p_b, v_b = (a[:, :2 * rhi] for a in bots)
        r3, p3, v3, rt3 = (self._pieces(a) for a in (r, p, v, rt))
        pn, vn = out
        pn3, vn3 = self._pieces(pn), self._pieces(vn)
        rtv0 = torch.stack([
            bicg_pv(r3[s], p3[s], v3[s], rt3[s], beta, omega,
                    out=(pn3[s], vn3[s]), **kw)[2] for s in range(S)])
        bb, om = beta.to(r.dtype), omega.to(r.dtype)
        pn2_t = r_t + bb * (p_t - om * v_t) if rlo else r_t
        pn2_b = r_b + bb * (p_b - om * v_b) if rhi else r_b
        mv_t, mv_b = edge_missing(
            kw["offsets"], *self._pad8(pn2_t[:, rlo:], pn2_b[:, :rhi]), Br,
            self._coeff)
        if mv_t is not None:
            vn3[:, :rlo] += mv_t
        if mv_b is not None:
            vn3[:, Br - rhi:] += mv_b
        rtv = self._psum(rtv0 + self._edge_sum(
            None if mv_t is None else rt3[:, :rlo] * mv_t,
            None if mv_b is None else rt3[:, Br - rhi:] * mv_b))
        return pn, vn, rtv, (r_t, r_b, pn2_t, pn2_b)

    def _bicg_st_pieces(self, r, v, p, alpha, ctx):
        """The st pass on S pieces (v and p the pv pass's repaired v' and
        p'): K5b per piece with zero halos.  s = r - alpha v' on the halo
        rows is DERIVED, not exchanged: v' there is A p' on the derived p'
        rows beside the piece's own first (last) rows, zero beyond the
        grid's ends.  The edge terms of t = A s that K5b left out (miss)
        and t's zero-halo edge rows t0 (recomputed from the piece's edge
        strips of s) give <t, s> + sum(s miss) and <t, t> + sum(2 t0 miss
        + miss^2) per piece, summed in piece order.  Returns (<t, s>, <t,
        t>, ctx for :meth:`_bicg_update_pieces`)."""
        from ..ops.cuda.bicgstab2d import bicg_st
        from .overlap import edge_missing
        from .sstep_sharded import _apply

        r_t, r_b, pn2_t, pn2_b = ctx
        S = self._nloc
        Br = self._view["Br"]
        rlo, rhi = self._rows_reach()
        kw = self._bicg_kw()
        offs, vals = kw["offsets"], kw["values"]
        first, last = self._edge_flags(r.device)
        al = alpha.to(r.dtype)
        r3, v3, p3 = (self._pieces(a) for a in (r, v, p))
        s_t = s_b = s_loc_t = s_loc_b = t0t = t0b = None
        ctx_rows = rlo + rhi
        if rlo:
            # A at rows [-rlo, 0) reads rows [-2 rlo, rhi)
            v2_t = _apply(torch.cat([pn2_t, p3[:, :rhi]], 1), offs,
                          vals)[:, rlo: 2 * rlo]
            s_t = r_t[:, rlo:] - al * torch.where(first, 0.0, v2_t)
            s_loc_t = r3[:, :rlo + ctx_rows] - al * v3[:, :rlo + ctx_rows]
            t0t = _apply(F.pad(s_loc_t, (0, 0, rlo, 0)), offs,
                         vals)[:, rlo: 2 * rlo]
        if rhi:
            # A at rows [Br, Br + rhi) reads rows [Br - rlo, Br + 2 rhi)
            v2_b = _apply(torch.cat([p3[:, Br - rlo:], pn2_b], 1), offs,
                          vals)[:, rlo: rlo + rhi]
            s_b = r_b[:, :rhi] - al * torch.where(last, 0.0, v2_b)
            s_loc_b = (r3[:, Br - rhi - ctx_rows:]
                       - al * v3[:, Br - rhi - ctx_rows:])
            t0b = _apply(F.pad(s_loc_b, (0, 0, 0, rhi)), offs,
                         vals)[:, -2 * rhi: -rhi]
        outs = [bicg_st(r3[s], v3[s], alpha, **kw) for s in range(S)]
        ts0 = torch.stack([o[0] for o in outs])
        tt0 = torch.stack([o[1] for o in outs])
        mt_t, mt_b = edge_missing(offs, *self._pad8(s_t, s_b), Br,
                                  self._coeff)
        ts = self._psum(ts0 + self._edge_sum(
            None if mt_t is None else s_loc_t[:, :rlo] * mt_t,
            None if mt_b is None else s_loc_b[:, -rhi:] * mt_b))
        tt = self._psum(tt0 + self._edge_sum(
            None if mt_t is None else 2.0 * t0t * mt_t + mt_t * mt_t,
            None if mt_b is None else 2.0 * t0b * mt_b + mt_b * mt_b))
        return ts, tt, (mt_t, mt_b, t0t, t0b, s_loc_t, s_loc_b)

    def _bicg_update_pieces(self, r, v, x, p, rt, alpha, omega, ctx, out):
        """The update pass on S pieces: K5c per piece with zero halos, x'
        into x and r' into ``out``; r' = s - omega t is repaired at the
        piece edges by -omega miss (in place in ``out``, the buffer the
        next iteration reads), and <r', r'> and <r~, r'> by their edge
        terms from the kernel's edge values s - omega t0; both summed in
        piece order.  Returns (x, r', <r', r'>, <r~, r'>)."""
        from ..ops.cuda.bicgstab2d import bicg_update

        mt_t, mt_b, t0t, t0b, s_loc_t, s_loc_b = ctx
        S = self._nloc
        Br = self._view["Br"]
        rlo, rhi = self._rows_reach()
        kw = self._bicg_kw()
        om = omega.to(r.dtype)
        r3, v3, x3, p3, rt3, o3 = (self._pieces(a)
                                   for a in (r, v, x, p, rt, out))
        outs = [bicg_update(r3[s], v3[s], x3[s], p3[s], rt3[s], alpha, omega,
                            out=o3[s], **kw) for s in range(S)]
        rr0 = torch.stack([o[2] for o in outs])
        rtr0 = torch.stack([o[3] for o in outs])
        drr, drtr = [], []
        if mt_t is not None:
            d = -om * mt_t
            r0e = s_loc_t[:, :rlo] - om * t0t
            o3[:, :rlo] += d
            drr.append(2.0 * r0e * d + d * d)
            drtr.append(rt3[:, :rlo] * d)
        if mt_b is not None:
            d = -om * mt_b
            r0e = s_loc_b[:, -rhi:] - om * t0b
            o3[:, Br - rhi:] += d
            drr.append(2.0 * r0e * d + d * d)
            drtr.append(rt3[:, Br - rhi:] * d)
        rr = self._psum(rr0 + self._edge_sum(*drr))
        rtr = self._psum(rtr0 + self._edge_sum(*drtr))
        return x, out, rr, rtr

    def _sharded_bicgstab_runner(self, num_iterations: int):
        """The fused BiCGStab loop on S pieces of the 2-D view: per
        iteration :meth:`_bicg_pv_pieces` (the one exchange),
        :meth:`_bicg_st_pieces` and :meth:`_bicg_update_pieces`, each a
        zero-halo K5 pass per piece plus its edge fix-ups; every dot summed
        in piece order.  Contract and buffers as in
        :meth:`make_fused_bicgstab_runner`."""

        def run(x, r, p, v, rt, rho, alpha, omega):
            shape = x.shape
            x, r, p, v, rt = (self._grid(a) for a in (x, r, p, v, rt))
            rho, alpha, omega = (
                torch.as_tensor(a).to(device=x.device, dtype=torch.float32)
                for a in (rho, alpha, omega))
            rr0, rtr = self._bicg_boot_pieces(r, rt)
            hist = [rr0]
            spare_r, spare_p, spare_v = (torch.empty_like(a)
                                         for a in (r, p, v))
            for _ in range(num_iterations):
                rho_new = rtr
                beta = (rho_new / rho) * (alpha / omega)
                pn, vn, rtv, ctx = self._bicg_pv_pieces(
                    r, p, v, rt, beta, omega, (spare_p, spare_v))
                spare_p, spare_v, p, v = p, v, pn, vn
                alpha = rho_new / rtv
                ts, tt, ctx = self._bicg_st_pieces(r, v, p, alpha, ctx)
                omega = ts / tt
                _, rn, rr, rtr = self._bicg_update_pieces(
                    r, v, x, p, rt, alpha, omega, ctx, spare_r)
                spare_r, r = r, rn
                hist.append(rr)
                rho = rho_new
            x, r, p, v = (a.reshape(shape) for a in (x, r, p, v))
            return x, r, p, v, rho, alpha, omega, torch.stack(hist)

        return run

    def transpose(self) -> "StencilOperator":
        """A^T: offset o with value v becomes offset -o.  Cached."""
        if not hasattr(self, "_transpose_op"):
            self._transpose_op = StencilOperator(
                self.shape,
                [(tuple(-c for c in o), v) for o, v in self.offsets],
                partition=self.partition,
                mesh=self.mesh,
                options=self.options,
                use_pallas=self._view is not None,
                device=self.device,
            )
        return self._transpose_op

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^T @ x."""
        return self.transpose().matvec(x)
