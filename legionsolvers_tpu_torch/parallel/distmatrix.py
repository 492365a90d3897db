"""Row-partitioned sparse operator with an explicit halo exchange.

Port of ``legionsolvers_tpu/parallel/distmatrix.py`` (reference:
COOMatrix.cpp:144-191, SquarePlanner.hpp:209-235).  The reference gives
each piece (a) its block of output rows, (b) the nonzeros whose row lands
in that block and (c) a ghost partition of the source vector that Legion
fills by copying remote entries.  Here the ghost traffic is a static
schedule computed once on the host
(:func:`~legionsolvers_tpu_torch.core.partition.build_halo_exchange`).

Without a mesh the matrix is one global ELL slab over the padded range:
row ``i`` holds its nonzeros in COO order, padded slots carry value 0 and
column 0.  The planner keeps explicit matrices there when none of its
upgrades applies and for several pieces without a mesh.

On a mesh (``parallel/mesh.py``: S shards, all on one device) a vector is
one padded tensor, piece ``s`` its block of B rows.  Each piece keeps its
nonzeros as an ELL slab ``[S, B_r, L]`` whose columns index the piece's
*extended buffer*: its own block, then its halo slots (sorted by global
id), then one dump slot for padding.  JAX's ``ppermute`` of each ring
offset ``d`` becomes one gather of every piece's send buffer, a roll by
``d`` along the piece axis and one scatter into the receivers' halo slots;
all of them read x and write fresh buffers before any kernel runs.  The
local SpMV is kernel K9 (``ops/cuda/winell.py``) once per piece whenever
per-piece windowed-ELL planning over a banded-ordered extended layout
succeeds (``_plan_sharded_winell``, the JAX package's plans array for
array), and otherwise the gather-ELL in torch (JAX's XLA-gather fallback,
which has no kernel).  LEGIONSOLVERS_NO_WINELL=1 turns the windowed path
off.

On a mesh over processes the host plans every piece as above and each
process keeps its pieces' slabs, schedules and plans; the roll of each
ring offset becomes ``parallel/mesh.shift_pieces``, which sends the
blocks that cross a process boundary through host memory.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.matrix import AbstractMatrix
from ..core.partition import (
    BlockPartition,
    HaloExchange,
    build_halo_exchange,
    kernel_partition_from_range,
)
from ..options import DEFAULT_OPTIONS, SolverOptions
from .mesh import piece_range, resolve_mesh, shift_pieces


class RowPartitionedMatrix:
    """A sparse operator over block partitions of its domain and range
    (which may differ in extent but share their piece count)."""

    def __init__(
        self,
        matrix: AbstractMatrix,
        domain_partition: BlockPartition,
        range_partition: BlockPartition,
        mesh=None,
        options: SolverOptions = DEFAULT_OPTIONS,
        device=None,
    ):
        if domain_partition.num_pieces != range_partition.num_pieces:
            raise ValueError("domain/range piece counts must match")
        self.matrix = matrix
        self.domain_partition = domain_partition
        self.range_partition = range_partition
        self.mesh, self.device = resolve_mesh(mesh, range_partition, device)
        self.options = options
        self._S = range_partition.num_pieces
        # the pieces this process runs: all of them but on a process mesh
        self._lo, self._hi = piece_range(self.mesh, self._S)
        self._B_r = range_partition.block_size
        self._B_d = domain_partition.block_size
        self._win = None
        if self.mesh is None:
            self._build_global()
        else:
            self._build_pieces()

    def _build_global(self) -> None:
        """The unsharded path: one global ELL slab with global padded
        column indices."""
        matrix, rp = self.matrix, self.range_partition
        rows = matrix.rows
        order = np.argsort(rows, kind="stable")
        counts = np.bincount(rows, minlength=rp.padded_size)
        L = max(int(counts.max(initial=0)), 1)
        self.row_length = L
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        r_sorted = rows[order]
        slot = np.arange(len(rows)) - starts[r_sorted]
        g_cols = np.zeros((rp.padded_size, L), dtype=np.int64)
        g_vals = np.zeros((rp.padded_size, L), dtype=np.float64)
        g_cols[r_sorted, slot] = matrix.cols[order]
        g_vals[r_sorted, slot] = np.asarray(matrix.vals)[order]
        self.g_ell_cols = torch.as_tensor(
            g_cols, dtype=self.options.index_dtype, device=self.device)
        self.g_ell_vals = torch.as_tensor(
            g_vals, dtype=self.options.entry_dtype, device=self.device)

    def _build_pieces(self) -> None:
        """The dependent partitioning on the host (JAX's constructor): the
        kernel pieces, the halo schedule, the per-piece ELL slabs with
        remapped columns, and the windowed plans."""
        from ..native import pack_ell_shard

        matrix = self.matrix
        S, B_r, B_d = self._S, self._B_r, self._B_d
        kernel_pieces = kernel_partition_from_range(matrix.rows,
                                                    self.range_partition)
        self.kernel_pieces = kernel_pieces
        self.halo: HaloExchange = build_halo_exchange(
            matrix.cols, kernel_pieces, self.domain_partition)
        dump = self.halo.ext_size - 1

        vals_all = np.asarray(matrix.vals)
        pieces, L = [], 1
        for s in range(S):
            knz = kernel_pieces[s]
            lrows = (matrix.rows[knz] - s * B_r).astype(np.int64)
            order = np.argsort(lrows, kind="stable")
            lr_s = lrows[order]
            pieces.append((lr_s, matrix.cols[knz][order], vals_all[knz][order]))
            if len(lr_s):
                L = max(L, int(np.bincount(lr_s).max()))
        self.row_length = L
        ell_cols = np.empty((S, B_r, L), np.int32)
        ell_vals = np.empty((S, B_r, L), np.float64)
        for s, (lr_s, gc_s, vals_s) in enumerate(pieces):
            ell_cols[s], ell_vals[s] = pack_ell_shard(
                lr_s, gc_s, vals_s, B_r, B_d, s * B_d,
                self.halo.halo_global[s], L, dump)
        del pieces

        dev = self.device
        mine = slice(self._lo, self._hi)
        idx = lambda a: torch.as_tensor(np.asarray(a)[mine],
                                        dtype=torch.int64, device=dev)
        self.ell_cols = idx(ell_cols)
        self.ell_vals = torch.as_tensor(ell_vals[mine],
                                        dtype=self.options.entry_dtype,
                                        device=dev)
        self.send_idx = {d: idx(self.halo.send_idx[d])
                         for d in self.halo.offsets}
        self.recv_pos = {d: idx(self.halo.recv_pos[d])
                         for d in self.halo.offsets}
        if not bool(int(os.environ.get("LEGIONSOLVERS_NO_WINELL", "0"))):
            self._win = self._plan_sharded_winell(ell_cols, ell_vals, dump)

    # ------------------------------------------------------------------
    def _plan_sharded_winell(self, ell_cols, ell_vals, dump):
        """Per-piece windowed-ELL plans over a BANDED-ORDERED extended
        layout, or None when any piece is ineligible (the JAX package's
        planning, unchanged).

        The gather-ELL buffer appends halo slots after the local block,
        which scatters an edge row's columns across the whole buffer.  The
        windowed path therefore uses its own layout, ``[lo-halo
        (right-aligned to n_lo_max) | local block | hi-halo | dump]``,
        where a banded matrix's columns stay contiguous per row.  Per-piece
        halo counts differ; the shapes are the maxima, and only the
        scatter positions (``recv_pos2``) and column ids are per piece.
        Two planning passes give every piece one kernel geometry (the L
        and KR maxima) at Rt = 8."""
        from .dia_op import numpy_dtype
        from .winell_op import plan_winell

        S, B_r, B_d = self._S, self._B_r, self._B_d
        dtype = numpy_dtype(self.options.entry_dtype)
        hg = self.halo.halo_global
        n_lo = np.array([int((hg[s] < s * B_d).sum()) for s in range(S)])
        n_hi = np.array([len(hg[s]) - n_lo[s] for s in range(S)])
        n_lo_u = int(n_lo.max(initial=0))
        n_hi_u = int(n_hi.max(initial=0))
        ext2 = n_lo_u + B_d + n_hi_u + 1  # + dump slot
        pad_n = max(B_r, ext2)

        def remap(s, e):
            """old ext id -> banded-ordered ext2 id (vectorized)."""
            e = np.asarray(e, np.int64)
            out = np.empty_like(e)
            local = e < B_d
            out[local] = n_lo_u + e[local]
            lo = (~local) & (e < B_d + n_lo[s])
            out[lo] = n_lo_u - n_lo[s] + (e[lo] - B_d)
            hi = (~local) & (e >= B_d + n_lo[s]) & (e < B_d + len(hg[s]))
            out[hi] = n_lo_u + B_d + (e[hi] - B_d - n_lo[s])
            out[e >= B_d + len(hg[s])] = ext2 - 1  # dump
            return out

        coos, recv2 = [], {}
        for s in range(S):
            rows_idx, slot_idx = np.nonzero(ell_cols[s] != dump)
            coos.append((
                rows_idx.astype(np.int64),
                remap(s, ell_cols[s][rows_idx, slot_idx]),
                ell_vals[s][rows_idx, slot_idx],
            ))
        for d in self.halo.offsets:
            recv2[d] = np.stack([
                remap(s, self.halo.recv_pos[d][s]) for s in range(S)])

        def plan_all(kr_min=0, l_min=0):
            plans = []
            for lr, lc, lv in coos:
                p = plan_winell(lr, lc, lv, pad_n, pad_n, dtype,
                                tile_rows_of_128=8,
                                window_rows_min=kr_min,
                                row_length_min=l_min)
                if p is None:
                    return None
                plans.append(p)
            return plans

        plans = plan_all()
        if plans is None:
            return None
        Lmax = max(p["row_length"] for p in plans)
        KRmax = max(p["window_rows"] for p in plans)
        if any(p["row_length"] != Lmax or p["window_rows"] != KRmax
               for p in plans):
            plans = plan_all(kr_min=KRmax, l_min=Lmax)
            if plans is None:
                return None
        dev = self.device
        mine = slice(self._lo, self._hi)
        stack = lambda k: torch.as_tensor(
            np.stack([p[k] for p in plans[mine]]), device=dev)
        return {
            "N": plans[0]["N"],
            "KR": KRmax,
            "ext2": ext2,
            "n_lo_u": n_lo_u,
            "wstart": stack("wstart"),
            "cols": stack("cols"),
            "vals": stack("vals"),
            "recv_pos2": {d: torch.as_tensor(recv2[d][mine],
                                             dtype=torch.int64, device=dev)
                          for d in self.halo.offsets},
        }

    @property
    def num_pieces(self) -> int:
        return self._S

    def nnz(self) -> int:
        return self.matrix.n_kernel

    # device buffers, carried by SquarePlanner.dump_state/load_state
    def device_state(self):
        if self.mesh is None:
            return {"g_ell_cols": self.g_ell_cols,
                    "g_ell_vals": self.g_ell_vals}
        s = {
            "ell_cols": self.ell_cols,
            "ell_vals": self.ell_vals,
            "send_idx": self.send_idx,
            "recv_pos": self.recv_pos,
        }
        if self._win is not None:
            for k in ("wstart", "cols", "vals", "recv_pos2"):
                s["win_" + k] = self._win[k]
        return s

    def set_device_state(self, state) -> None:
        for k, v in state.items():
            if k.startswith("win_"):
                self._win[k[len("win_"):]] = v
            else:
                setattr(self, k, v)

    # ------------------------------------------------------------------
    @property
    def _local(self) -> int:
        """The number of pieces this process runs."""
        return self._hi - self._lo

    def _exchange(self, x2: torch.Tensor, ext: torch.Tensor,
                  recv_pos) -> torch.Tensor:
        """Fill the halo slots of ``ext`` ([S, E], one extended buffer per
        piece) from ``x2`` ([S, B_d], the pieces' blocks): for each ring
        offset ``d``, piece s's ``x2[s, send_idx[d][s]]`` lands in piece
        (s + d) % S's buffer at ``recv_pos[d]`` (JAX's ppermute; across
        processes ``mesh.shift_pieces``).  Padded sends read index 0 and
        land in the dump slot."""
        for d in self.halo.offsets:
            send = torch.gather(x2, 1, self.send_idx[d])
            ext.scatter_(1, recv_pos[d], shift_pieces(self.mesh, send, d))
        return ext

    def _matvec_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The gather-ELL on pieces: every piece's extended buffer, one
        gather through its ELL columns and the row sums (JAX's
        ``_local_matvec``, all pieces in one set of torch launches)."""
        S, B_d = self._local, self._B_d
        x2 = x.reshape(S, B_d)
        ext = x2.new_zeros(S, self.halo.ext_size)
        ext[:, :B_d] = x2
        self._exchange(x2, ext, self.recv_pos)
        g = torch.gather(ext, 1, self.ell_cols.view(S, -1))
        return torch.sum(self.ell_vals * g.view(self.ell_vals.shape),
                         dim=2).reshape(-1)

    def _matvec_win(self, x: torch.Tensor) -> torch.Tensor:
        """K9 once per piece over its banded-ordered extended buffer
        (JAX's ``_local_matvec_win``)."""
        from ..ops.cuda.winell import winell_spmv

        w = self._win
        S, B_d, B_r = self._local, self._B_d, self._B_r
        x2 = x.reshape(S, B_d)
        ext = x2.new_zeros(S, max(w["N"], w["ext2"]))
        ext[:, w["n_lo_u"]: w["n_lo_u"] + B_d] = x2
        self._exchange(x2, ext, w["recv_pos2"])
        ys = [winell_spmv(ext[s].view(-1, 128), w["wstart"][s], w["cols"][s],
                          w["vals"][s], window_rows=w["KR"]).view(-1)[:B_r]
              for s in range(S)]
        return torch.cat(ys)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x over padded vectors: x over the domain's padded size,
        y over the range's.  Padded ELL slots point at column 0 (the dump
        slot on pieces) with value 0; padded x slots are 0 by the vector
        invariant; padded output rows have all-zero ELL rows, so y's
        padding stays 0."""
        if self.mesh is None:
            from ..ops.spmv import spmv_ell

            return spmv_ell(self.g_ell_cols, self.g_ell_vals, x)
        if self._win is not None:
            return self._matvec_win(x)
        return self._matvec_gather(x)

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^T @ x over padded vectors (x over the range space, y over
        the domain space, its padding 0).  Without a mesh: the COO
        transpose product of the matrix's nonzeros, as the JAX package's
        unsharded path computes it.  On pieces: the adjoint of the halo
        schedule (JAX's ``_local_rmatvec``): each piece scatters its
        contributions into its extended-buffer coordinates, then the sums
        in each halo slot go back along the reversed ring to the owning
        piece and are added there."""
        if self.mesh is not None:
            S, B_d = self._local, self._B_d
            x2 = x.reshape(S, self._B_r)
            contrib = (self.ell_vals * x2[:, :, None]).reshape(S, -1)
            c_ext = x2.new_zeros(S, self.halo.ext_size)
            c_ext.scatter_add_(1, self.ell_cols.view(S, -1), contrib)
            y = c_ext[:, :B_d].clone()
            for d in self.halo.offsets:
                outgoing = torch.gather(c_ext, 1, self.recv_pos[d])
                y.scatter_add_(1, self.send_idx[d],
                               shift_pieces(self.mesh, outgoing, -d))
            return y.reshape(-1)
        from ..ops.spmv import rmatvec_coo

        m = self.matrix
        idx = dict(dtype=torch.int64, device=x.device)
        y = rmatvec_coo(
            torch.as_tensor(m.rows, **idx), torch.as_tensor(m.cols, **idx),
            torch.as_tensor(np.asarray(m.vals), dtype=x.dtype,
                            device=x.device),
            x[: m.n_range], m.n_domain)
        out = torch.zeros(self.domain_partition.padded_size, dtype=y.dtype,
                          device=y.device)
        out[: m.n_domain] = y
        return out
