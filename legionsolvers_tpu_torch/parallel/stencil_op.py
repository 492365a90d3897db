"""Matrix-free stencil operator, on one piece or on a mesh of pieces.

Port of ``legionsolvers_tpu/parallel/stencil_op.py``.  A stencil matrix is
exactly banded, so ``matvec`` needs no stored matrix.  Two paths, chosen
when the operator is built:

* **kernel view** (``_view``, f32, unpadded blocks): 2-D grids (kind
  ``2d``, each piece an ``[Br, C]`` row block; kernels of
  ``ops/cuda/stencil2d.py`` and ``bicgstab2d.py``) and 3-D grids on one
  piece (kind ``3d``, the ``[X, Y, Z]`` volume, kernels of
  ``ops/cuda/stencil3d.py`` and ``bicgstab3d.py``).  Every pass is a
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
three K5 (2-D) or K7 (3-D) passes per iteration.  Scalars stay on the
device throughout; no runner reads one back to the host.

Pieces (``parallel/mesh.py``): on a mesh of S shards, which all live on one
device, a vector is one tensor and piece s its row block.  Each kernel
pass runs once per piece with ZERO halo blocks; the halo rows are copied
out of the neighbouring pieces into fresh blocks before the first piece's
pass, and the terms the passes left out at the piece edges are patched
afterwards (``parallel/overlap.py`` for the matvec and the two-pass CG,
``parallel/sstep_sharded.py`` for the s-step CG).  Dots are summed over
the pieces in piece order.  The linearized path reads its band from the
neighbouring pieces.  A sharded operator runs these paths or raises; it
never falls back to one piece.

Not ported yet: 3-D stencils on a mesh of several pieces (ROADMAP §1
item 5b: ``_exchange_planes3d`` keeps the JAX package's name and gives
zero planes on one piece), the fused BiCGStab runners of sharded
operators (item 5c) and the 1-D flat-offset view (item 3).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.partition import BlockPartition
from ..options import DEFAULT_OPTIONS, SolverOptions
from .mesh import num_shards, ordered_sum, resolve_mesh
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
        if (self._sharded and self._view is not None
                and self._view["kind"] == "3d"):
            raise NotImplementedError(
                f"a 3-D stencil on a mesh of {partition.num_pieces} pieces: "
                "the sharded 3-D kernel path is not ported (ROADMAP §1 item "
                "5b)")
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
        blocks that are whole rows of the grid (2-D: ``[Br, C]``; 3-D:
        whole x-planes), f32 and a stencil within the kernels' gate: K3/K4
        for 2-D grids, K6 for 3-D ones.  On several pieces each piece's
        halo rows must come from one neighbour (``Br`` >= the stencil's
        row reach)."""
        from ..ops.cuda.stencil2d import supports
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
            Br = B // C
            offs = tuple((o[0], o[1]) for o, _ in self.offsets)
            reach = max(abs(dy) for dy, _ in offs)
            if self.partition.num_pieces > 1 and Br < reach:
                return None
            if supports(Br, C, offs):
                return {"kind": "2d", "C": C, "Br": Br, "offs": offs,
                        "vals": vals}
        elif len(self.shape) == 3:
            _, Y, Z = self.shape
            if B % (Y * Z):
                return None  # blocks must be whole x-planes
            offs3 = tuple(o for o, _ in self.offsets)
            if supports3d(B // (Y * Z), Y, Z, offs3):
                return {"kind": "3d", "Y": Y, "Z": Z, "Br": B // (Y * Z),
                        "offs3": offs3, "vals": vals}
        return None  # the 1-D flat view is not ported

    def _kw(self):
        v = self._view
        offs = v["offs3"] if v["kind"] == "3d" else v["offs"]
        return dict(offsets=offs, values=v["vals"])

    def _grid(self, a: torch.Tensor) -> torch.Tensor:
        """``a`` in the grid layout of all pieces: ``[S * Br, C]`` or
        ``[S * Br, Y, Z]``."""
        v = self._view
        rows = self.partition.num_pieces * v["Br"]
        if v["kind"] == "3d":
            return a.reshape(rows, v["Y"], v["Z"])
        return a.reshape(rows, v["C"])

    def _pieces(self, g: torch.Tensor) -> torch.Tensor:
        """The ``[S, Br, C]`` view of a 2-D grid of all pieces: piece s is
        ``[s]``, a contiguous ``[Br, C]`` view."""
        v = self._view
        return g.view(self.partition.num_pieces, v["Br"], v["C"])

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

        return exchange_halos(grids, self.partition.num_pieces,
                              *self._rows_reach())

    @staticmethod
    def _psum(parts: torch.Tensor) -> torch.Tensor:
        """The sum of per-piece f32 reductions ``[S]`` (or ``[S, k]``) in
        piece order."""
        return ordered_sum(parts, torch.float32)

    def _update_pieces(self, x3, r3, p3, alpha, top, bot):
        """K3 ``update`` on every piece of the ``[S, Br, C]`` stacks x3, r3
        (updated in place) and p3, each piece reading p's halo rows from
        its ``[8, C]`` blocks of ``top`` and ``bot``; <r', r'> summed in
        piece order."""
        from ..ops.cuda.stencil2d import grid2d_cg_update

        kw = self._kw()
        return self._psum(torch.stack([
            grid2d_cg_update(p3[s], x3[s], r3[s], alpha, top[s], bot[s],
                             **kw)[2]
            for s in range(self.partition.num_pieces)]))

    def _exchange_planes3d(self, g: torch.Tensor):
        """([Y, Z] top, [Y, Z] bot) x-halo planes of the local [X, Y, Z]
        block.  On one piece the volume's neighbours are the grid's
        boundary, so both are zero planes, passed as ``None``; the
        exchange between 3-D pieces is ROADMAP §1 item 5b."""
        return None, None

    def _pallas_local_3d(self, x: torch.Tensor, *, with_dot: bool = False):
        from ..ops.cuda.stencil3d import grid3d_stencil_matvec

        g = self._grid(x)
        top, bot = self._exchange_planes3d(g)
        out = grid3d_stencil_matvec(g, top, bot, with_dot=with_dot,
                                    **self._kw())
        if with_dot:
            y, dot = out
            return y.reshape(x.shape), dot
        return out.reshape(x.shape)

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
                for s in range(self.partition.num_pieces)]
        offs = kw["offsets"]
        if with_dot:
            dots = torch.stack([d for _, d in outs])
            dots = dots + dot_fixup(x3, offs, top, bot, self._coeff)
        apply_edge_fixup(y3, offs, top, bot, self._coeff)
        if with_dot:
            return y.reshape(x.shape), self._psum(dots)
        return y.reshape(x.shape)

    # ======================================================================
    # linearized path: shifted 1-D slices + integer boundary masks
    # ======================================================================
    def _diag_values(self, dtype, device):
        """Per-offset masked diagonal values over the padded index space."""
        key = (dtype, device)
        if key not in self._diag_cache:
            N = self.partition.padded_size
            g = torch.arange(N, device=device)
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
        the ``lo`` entries before it and the ``hi`` after it, from the
        neighbouring pieces (piece 0's tail from the last piece's end, as
        the JAX package's ring of ppermutes delivers it); where the band is
        wider than a block, gathered from the whole vector modulo its
        padded size (JAX's all_gather).  Wrapped entries meet zero
        diagonal values."""
        S, B = self.partition.num_pieces, self.partition.block_size
        lo, hi = self.band_lo, self.band_hi
        if not self._wide_band:
            x2 = x.view(S, B)
            parts = [x2]
            if lo:
                parts.insert(0, torch.roll(x2[:, B - lo:], 1, 0))
            if hi:
                parts.append(torch.roll(x2[:, :hi], -1, 0))
            return torch.cat(parts, 1) if len(parts) > 1 else x2
        key = ("window", x.device)
        idx = self._diag_cache.get(key)
        if idx is None:
            N = self.partition.padded_size
            idx = (torch.arange(B + lo + hi, device=x.device)
                   + (torch.arange(S, device=x.device) * B - lo)[:, None]) % N
            self._diag_cache[key] = idx
        return x[idx]

    def _linear_pieces(self, x: torch.Tensor) -> torch.Tensor:
        """y = A x over the flat padded vector of several pieces, piece by
        piece (all pieces in one set of torch launches) from
        :meth:`_piece_windows`: the JAX package's sharded ``_linear_local``
        and, without a mesh, its ``_unsharded_multiblock`` (same
        values)."""
        S, B = self.partition.num_pieces, self.partition.block_size
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
        if self._sharded:
            S = self.partition.num_pieces
            parts = torch.sum(x.view(S, -1) * y.view(S, -1), dim=1)
            return y, ordered_sum(parts, x.dtype)
        return y, torch.sum(x * y)

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
        2-D kernel view, stencil reach 1, not disabled by
        LEGIONSOLVERS_NO_SSTEP.  Pieces qualify on a mesh with blocks of at
        least 2 * STRIP rows, so that the two edge strips of a piece do not
        overlap; the passes stay zero-halo and ``parallel/sstep_sharded.py``
        repairs their edges.  (The JAX package's condition on the lane
        offsets of flat 1-D views holds here: reach 1 has |dx| <= 1.)"""
        from ..ops.cuda.stencil2d import step2_supported
        from .sstep_sharded import STRIP

        if os.environ.get("LEGIONSOLVERS_NO_SSTEP"):
            return False
        v = self._view
        if v is None or v["kind"] == "3d":
            return False
        if self.partition.num_pieces > 1:
            if self.mesh is None or v["Br"] < 2 * STRIP:
                return False
        return step2_supported(v["Br"], v["C"], v["offs"])

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
        from .sstep_sharded import (
            STRIP,
            exchange_halo4,
            gram2_fixup,
            step2_fixup,
        )

        kw = self._kw()
        offs, vals = kw["offsets"], kw["values"]
        K, odd = divmod(num_iterations, 2)
        refresh = int(os.environ.get("LEGIONSOLVERS_SSTEP_REFRESH", "16"))
        S = self.partition.num_pieces
        sharded = S > 1
        Br = self._view["Br"]
        pieces = self._pieces

        def gram(r, p):
            if not sharded:
                return grid2d_cg_gram2(r, p, **kw)
            halos = exchange_halo4(r, p, S)
            r3, p3 = pieces(r), pieces(p)
            g = torch.stack([grid2d_cg_gram2(r3[s], p3[s], **kw)
                             for s in range(S)])
            return self._psum(gram2_fixup(g, r, p, halos, offs, vals, S))

        def step2(x, r, p, coef, spare):
            if not sharded:
                return grid2d_cg_step2(x, r, p, coef, out=spare, **kw)
            halos = exchange_halo4(r, p, S)
            x3, r3, p3 = pieces(x), pieces(r), pieces(p)
            # r and p are not written by the passes (r'' and p'' go to the
            # spares), x is: its strips are copied first
            saves = (x3[:, :STRIP].clone(), r3[:, :STRIP], p3[:, :STRIP],
                     x3[:, Br - STRIP:].clone(), r3[:, Br - STRIP:],
                     p3[:, Br - STRIP:])
            sr3, sp3 = pieces(spare[0]), pieces(spare[1])
            g = torch.stack([
                grid2d_cg_step2(x3[s], r3[s], p3[s], coef,
                                out=(sr3[s], sp3[s]), **kw)[3]
                for s in range(S)])
            x, rn, pn, g = step2_fixup((x, spare[0], spare[1], g), saves,
                                       halos, coef, offs, vals, S)
            return x, rn, pn, self._psum(g)

        def odd_update(x, r, p, alpha):
            """One CG update of x and r with the current p; <r', r'>."""
            if not sharded:
                return grid2d_cg_update(p, x, r, alpha, **kw)[2]
            (top,), (bot,) = self._exchange(p)
            return self._update_pieces(pieces(x), pieces(r), pieces(p),
                                       alpha, top, bot)

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
        B/elt), 32 B/unknown.  On one device p's halo planes are zero
        (``None``).  Same contract as the 2-D runners."""
        from ..ops.cuda.stencil3d import (
            grid3d_cg_pq,
            grid3d_cg_update,
            grid3d_cg_xpay_pq,
        )

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

    def _sharded_two_pass_cg_runner(self, num_iterations: int):
        """The two-pass schedule on S pieces.  Per iteration the halo rows
        of r and p are exchanged first; K4 runs per piece with zero halos
        and its <p, A p> is patched from p's halo rows r_halo + beta
        p_halo (``overlap.dot_fixup``); K3 ``update`` runs per piece with
        those halo rows.  The prologue is a zero-halo K3 ``pq`` per piece
        with the same fix-up.  Dots are summed in piece order.  Buffers as
        in :meth:`_two_pass_cg_runner`."""
        from ..ops.cuda.stencil2d import grid2d_cg_pq, grid2d_cg_xpay_pq
        from .overlap import dot_fixup

        kw = self._kw()
        offs = kw["offsets"]
        S = self.partition.num_pieces
        pieces = self._pieces
        update_all = self._update_pieces

        def run(x, r, p, rr0):
            shape = x.shape
            x, r, p = self._grid(x), self._grid(r), self._grid(p)
            x3, r3, p3 = pieces(x), pieces(r), pieces(p)
            rr = torch.as_tensor(rr0, dtype=torch.float32, device=x.device)
            hist = [rr]
            (p_top,), (p_bot,) = self._exchange(p)
            pq = torch.stack([grid2d_cg_pq(p3[s], **kw) for s in range(S)])
            pq = self._psum(pq + dot_fixup(p3, offs, p_top, p_bot,
                                           self._coeff))
            rr_new = update_all(x3, r3, p3, rr / pq, p_top, p_bot)
            hist.append(rr_new)
            spare = torch.empty_like(p)
            for _ in range(1, num_iterations):
                rr_prev, rr = rr, rr_new
                beta = rr / rr_prev
                (r_top, p_top), (r_bot, p_bot) = self._exchange(r, p)
                sp3 = pieces(spare)
                pq = torch.stack([
                    grid2d_cg_xpay_pq(r3[s], p3[s], beta, out=sp3[s],
                                      **kw)[1] for s in range(S)])
                spare, p, p3 = p, spare, sp3
                b = beta.to(p.dtype)
                top = r_top + b * p_top
                bot = r_bot + b * p_bot
                pq = self._psum(pq + dot_fixup(p3, offs, top, bot,
                                               self._coeff))
                rr_new = update_all(x3, r3, p3, rr / pq, top, bot)
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
        S = self.partition.num_pieces
        if self._sharded:
            matvec = self._linear_pieces

            def dot(a, b):
                parts = torch.sum(a.view(S, -1) * b.view(S, -1), dim=1)
                return ordered_sum(parts, a.dtype)
        else:
            matvec = self._linear_local
            dot = lambda a, b: torch.sum(a * b)

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
        least 16 rows, as in the JAX package (whose sharded runner the
        port does not have yet: building it raises)."""
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
            raise NotImplementedError(
                "the fused BiCGStab runner on a mesh of "
                f"{self.partition.num_pieces} pieces (its edge fix-ups) is "
                "not ported (ROADMAP §1 item 5c)")
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

        kw = dict(self._kw(), compensated=bool(self.options.compensated_dots))
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
