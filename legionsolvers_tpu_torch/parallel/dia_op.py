"""Explicit-DIA operator: the fast path for explicit matrices with few
diagonals, on one piece or on the pieces of a mesh.

Port of ``legionsolvers_tpu/parallel/dia_op.py`` (reference:
CSRMatrixTasks.cu:14-156, COOMatrixTasks.cu:12-146, which run cuSPARSE
SpMV).  For each distinct (col - row) offset the host extracts a
coefficient array over the rows, zero where the matrix has no entry; SpMV
is then a sum of shifted elementwise products.  In f32 the flat diagonals
are rewritten onto an [R, C] view and run on kernel K8
(``ops/cuda/dia2d.py``), (2 + D) * 4 B per element; f64 runs a linearized
torch path of shifted slices, as the JAX package routes it.

``SquarePlanner.add_row_partitioned_matrix`` upgrades square matrices with
few, well-filled diagonals here when they have one piece or a mesh, as in
the JAX package; several pieces without a mesh stay on the ELL operator.

Pieces (``parallel/mesh.py``): on a mesh of S shards, all on one device, a
vector is one tensor and piece s its block of B rows.  The view then has
``Br = B / C`` rows per piece, and K8 runs once per piece with ZERO halo
blocks; the neighbours' edge rows are copied out before the first launch
and the terms the passes left out at the piece edges, with their share of
<x, A x>, are added afterwards with the per-row coefficients
(``parallel/overlap.py``), as the JAX package's overlapped matvec does.
The linearized path reads each piece's band from its neighbours (a ring)
or, for a band wider than a block, gathers it from the whole vector.
Per-piece dots are summed in piece order.  On a mesh over processes the
host extracts the diagonals of every row and each process keeps its
pieces' rows; the halo rows, the ring and the gather cross the processes
(``parallel/mesh.py``) and the per-piece dots are gathered before their
sum, as on one process.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.partition import BlockPartition
from ..options import DEFAULT_OPTIONS, SolverOptions
from .mesh import (
    full_stack,
    gather_pieces,
    local_stack,
    ordered_sum,
    piece_range,
    resolve_mesh,
)

# The gate of the JAX package: at most MAX_DIAGONALS distinct diagonals,
# and nnz / (D * padded_size) >= MIN_DIA_FILL (a 16x storage bloat cap).
MAX_DIAGONALS = 256
MIN_DIA_FILL = 1.0 / 16

# view widths tried, widest first, as in the JAX package
_VIEW_WIDTHS = (4096, 2048, 1024, 512, 256, 128)


def numpy_dtype(torch_dtype) -> np.dtype:
    return np.dtype({torch.float32: np.float32,
                     torch.float64: np.float64}[torch_dtype])


def dia_offsets(matrix, padded_size: int) -> Optional[np.ndarray]:
    """The matrix's distinct diagonal offsets when it passes the DIA gate
    (at most MAX_DIAGONALS of them, filled at least MIN_DIA_FILL over the
    padded rows), else None."""
    from ..native import bindings as native

    uoffs = native.dia_unique_offsets(matrix.rows, matrix.cols,
                                      MAX_DIAGONALS)
    if uoffs is None or matrix.n_kernel < (MIN_DIA_FILL * len(uoffs)
                                           * padded_size):
        return None
    return uoffs


def dia_extract(matrix, padded_size: int, dtype) -> Optional[tuple]:
    """(offsets [D], coefficients [D, padded_size] in ``dtype``) with
    duplicate entries summed, or None when the matrix fails the DIA gate."""
    from ..native import bindings as native

    uoffs = dia_offsets(matrix, padded_size)
    if uoffs is None:
        return None
    coef = native.dia_accumulate(matrix.rows, matrix.cols,
                                 np.asarray(matrix.vals), uoffs, padded_size,
                                 dtype)
    return uoffs, coef


class _Swapped:
    """The transpose's COO view: rows and columns exchanged."""

    def __init__(self, m):
        self.rows, self.cols, self.vals = m.cols, m.rows, m.vals
        self.n_domain, self.n_range = m.n_range, m.n_domain
        self.n_kernel = m.n_kernel


class DiaOperator:
    """y = A @ x for an explicit square matrix stored as diagonals."""

    def __init__(
        self,
        matrix,
        partition: BlockPartition,
        mesh=None,
        options: SolverOptions = DEFAULT_OPTIONS,
        device=None,
    ):
        if matrix.n_domain != matrix.n_range:
            raise ValueError("DiaOperator requires a square matrix")
        if partition.num_pieces > 1 and mesh is None:
            raise ValueError("multi-piece DiaOperator requires a mesh")
        self.matrix = matrix
        self.partition = partition
        self.mesh, self.device = resolve_mesh(mesh, partition, device)
        # the pieces this process runs: all of them but on a process mesh
        self._lo, hi = piece_range(self.mesh, partition.num_pieces)
        self._nloc = hi - self._lo
        self.options = options
        extracted = dia_extract(matrix, partition.padded_size,
                                numpy_dtype(options.entry_dtype))
        if extracted is None:
            raise ValueError(
                f"matrix has more than {MAX_DIAGONALS} distinct diagonals "
                "or fills them below the DIA gate")
        self.flat_offsets, flat_coefs = extracted
        self.band_lo = max(0, -int(self.flat_offsets.min(initial=0)))
        self.band_hi = max(0, int(self.flat_offsets.max(initial=0)))
        S = partition.num_pieces
        # a band wider than a block reaches past the neighbouring pieces:
        # the linearized path then gathers its window from the whole vector
        self._wide_band = S > 1 and max(self.band_lo, self.band_hi) > (
            partition.block_size)
        # f32 runs on K8; f64, a band wider than a block and a matrix of
        # zeros on the linearized path
        self._view = None
        if options.entry_dtype == torch.float32 and not self._wide_band:
            self._view = self._plan_view(flat_coefs)
            if self._view is None and flat_coefs.any():
                raise ValueError("no K8 view fits this f32 DIA matrix")
        if self._view is None:
            B = partition.block_size
            self.flat_coefs = torch.as_tensor(np.ascontiguousarray(
                flat_coefs[:, self._lo * B: (self._lo + self._nloc) * B]),
                device=self.device)
        self._transpose_op = None
        self._cache = {}

    def _plan_view(self, flat_coefs: np.ndarray):
        """The flat diagonals rewritten onto a [rows, C] view for K8: a
        shift s = q C + rr becomes (q, rr) on the columns where c + rr
        stays in the row and (q + 1, rr - C) on the others, each term
        keeping its coefficients only there.  JAX's width order and its
        B % C == 0, B // C >= 8 rule at the block size B of one piece; the
        card's gate (``supports_dia``) instead of the VMEM budget.  Where
        none of JAX's widths fits, one row of width B per piece: K8 takes
        any width, and every term then has |dy| <= 1.  The coefficients
        are ``[D, S * Br, C]``, as in the JAX package; piece s's are the
        rows ``[s * Br, (s + 1) * Br)`` of each diagonal, which K8 reads
        with the diagonals' stride (on a process mesh this process's
        pieces' rows only)."""
        from ..ops.cuda.dia2d import supports_dia

        B = self.partition.block_size
        N = self.partition.padded_size
        widths = [C for C in _VIEW_WIDTHS if B % C == 0 and B // C >= 8]
        for C in widths + [B]:
            c = np.arange(N, dtype=np.int64) % C
            offs, coefs = [], []
            for s, a in zip(self.flat_offsets, flat_coefs):
                q, rr = divmod(int(s), C)
                if rr == 0:
                    offs.append((q, 0))
                    coefs.append(a)
                    continue
                in_row = (c + rr) < C
                a1 = np.where(in_row, a, 0)
                a2 = np.where(in_row, 0, a)
                if a1.any():
                    offs.append((q, rr))
                    coefs.append(a1)
                if a2.any():
                    offs.append((q + 1, rr - C))
                    coefs.append(a2)
            Br = B // C
            if not supports_dia(Br, C, offs, len(offs)):
                continue
            diags = np.stack(coefs).reshape(len(offs), N // C, C)
            diags = np.ascontiguousarray(
                diags[:, self._lo * Br: (self._lo + self._nloc) * Br])
            return {
                "C": C,
                "Br": Br,
                "offs": tuple(offs),
                "diags": torch.as_tensor(diags, dtype=torch.float32,
                                         device=self.device),
            }
        return None

    # ------------------------------------------------------------------
    @property
    def uses_pallas(self) -> bool:
        """True when the matvec runs on K8 (the name of the JAX flag)."""
        return self._view is not None

    @property
    def supports_matvec_dot(self) -> bool:
        return self.partition.num_pieces == 1 or self.mesh is not None

    @property
    def _sharded(self) -> bool:
        return self.mesh is not None and self.partition.num_pieces > 1

    @property
    def n_domain(self) -> int:
        return self.matrix.n_domain

    @property
    def n_range(self) -> int:
        return self.matrix.n_range

    def nnz(self) -> int:
        return self.matrix.n_kernel

    # ------------------------------------------------------------------
    def _kernel_local(self, x, with_dot: bool):
        """K8 on the view: one launch on one piece; on S pieces one
        zero-halo launch per piece into its rows of y, then the edge terms
        it left out (and their share of <x, A x>) from the neighbours'
        edge rows, copied out before the first launch."""
        from ..ops.cuda.dia2d import dia2d_matvec
        from .overlap import (
            apply_edge_fixup,
            dot_fixup,
            edge_missing,
            exchange_halos,
        )

        v = self._view
        S, Br, C, offs = self._nloc, v["Br"], v["C"], v["offs"]
        diags = v["diags"]
        if not self._sharded:
            out = dia2d_matvec(x.reshape(Br, C), None, None, diags,
                               offsets=offs, with_dot=with_dot)
            if with_dot:
                return out[0].reshape(-1), out[1]
            return out.reshape(-1)
        xg = x.reshape(S * Br, C)
        rlo = max(0, -min(dy for dy, _ in offs))
        rhi = max(0, max(dy for dy, _ in offs))
        if rlo or rhi:
            (top,), (bot,) = exchange_halos([xg], S, rlo, rhi,
                                            mesh=self.mesh)
        x3 = xg.view(S, Br, C)
        y3 = torch.empty_like(x3)
        outs = [dia2d_matvec(x3[s], None, None,
                             diags[:, s * Br: (s + 1) * Br], offsets=offs,
                             with_dot=with_dot, out=y3[s]) for s in range(S)]
        if rlo or rhi:
            # the omitted edge terms, once for y and the dot
            miss = edge_missing(offs, top, bot, Br,
                                lambda k, sl: diags[k].view(S, Br, C)[:, sl])
        if with_dot:
            dots = torch.stack([d for _, d in outs])
            if rlo or rhi:
                dots = dots + dot_fixup(x3, offs, top, bot, None, miss,
                                        mesh=self.mesh)
        if rlo or rhi:
            apply_edge_fixup(y3, offs, top, bot, None, miss)
        y = y3.reshape(-1)
        if with_dot:
            return y, ordered_sum(gather_pieces(self.mesh, dots),
                                  torch.float32)
        return y

    def _windows(self, x: torch.Tensor) -> torch.Tensor:
        """``[S, lo + B + hi]``: each piece's block of the flat vector with
        its band: zeros on one piece, else from the neighbouring pieces or,
        for a band wider than a block, the whole vector
        (``overlap.piece_windows``)."""
        from .overlap import piece_windows

        S, B = self._nloc, self.partition.block_size
        if not self._wide_band:
            lo, hi = min(self.band_lo, B), min(self.band_hi, B)
            if not self._sharded:
                return F.pad(x.reshape(S, B), (lo, hi))
        else:
            lo, hi = self.band_lo, self.band_hi
        return piece_windows(x.reshape(-1), S, lo, hi, self._wide_band,
                             self._cache, self.mesh)

    def _linear_local(self, x, with_dot: bool):
        """Shifted slices of each piece's window (:meth:`_windows`)
        weighted by the coefficient rows (zeros encode the boundaries),
        summed in offset order; the dot in the entry dtype, per piece, the
        pieces' sums added in piece order."""
        S, B = self._nloc, self.partition.block_size
        lo = self.band_lo if self._wide_band else min(self.band_lo, B)
        x_ext = self._windows(x)
        y = x.new_zeros(S, B)
        for k, s in enumerate(self.flat_offsets):
            y = y + self.flat_coefs[k].view(S, B) * x_ext[
                :, lo + int(s): lo + int(s) + B]
        y = y.reshape(-1)
        if not with_dot:
            return y
        if not self._sharded:
            return y, torch.sum(x.reshape(-1) * y)
        parts = local_stack(self.mesh, torch.sum(
            full_stack(self.mesh, (x.reshape(-1) * y).view(S, B)), dim=1))
        return y, ordered_sum(gather_pieces(self.mesh, parts), y.dtype)

    def _apply(self, x, with_dot: bool):
        if self._view is not None:
            return self._kernel_local(x, with_dot)
        return self._linear_local(x, with_dot)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x over the padded flat layout."""
        return self._apply(x, False)

    def matvec_dot(self, x: torch.Tensor):
        """(A @ x, <x, A x>), the reduction fused into K8 on the view."""
        return self._apply(x, True)

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    # device buffers, carried by SquarePlanner.dump_state/load_state
    def device_state(self):
        if self._view is not None:
            return (self._view["diags"],)
        return (self.flat_coefs,)

    def set_device_state(self, state) -> None:
        if self._view is not None:
            self._view["diags"] = state[0]
        else:
            self.flat_coefs = state[0]

    # ------------------------------------------------------------------
    def transpose(self) -> "DiaOperator":
        """A^T as a DiaOperator (the reference stubs rmatvec,
        COOMatrixTasks.cpp:78-83)."""
        if self._transpose_op is None:
            self._transpose_op = DiaOperator(
                _Swapped(self.matrix), partition=self.partition,
                mesh=self.mesh, options=self.options, device=self.device)
        return self._transpose_op

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.transpose().matvec(x)
