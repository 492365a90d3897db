"""Reordered-basis solves: RCM or degree order at build time, permutation
only at the edges of a solve.

Port of ``legionsolvers_tpu/parallel/reorder.py``.  An explicit matrix that
fails the direct DIA gate is made banded (RCM) or degree-sorted at build
time and solved as

    (P A P^T) (P x) = P b

Krylov recurrences are invariant under the orthogonal similarity, so the
residual histories match the unpermuted iteration up to rounding.  The
planner permutes the space's vectors once when a solve enters the basis
(``SquarePlanner.to_solver_basis``) and once when it leaves.

:class:`ReorderedOperator` wraps an operator built on the permuted matrix:
inside the basis its matvec is the base operator's, with no extra work;
outside (eager ``step()``s) it permutes on every call.  On the pieces of a
mesh (``parallel/mesh.py``) the permuted matrix becomes a DIA operator on
pieces or the sharded windowed ELL of ``parallel/distmatrix.py``; the
windowed-ELL, sliced and routed-gather operators are one piece only, as in
the JAX package.  On a mesh over processes every rank computes the
permutation from the whole matrix (the host library's RCM), checks that
every other rank computed the same one, and keeps its rows of the padded
permutation; a permute gathers the whole vector from every process and
takes those rows (``mesh.permute_rows``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..options import resolve_device
from .mesh import check_same_on_ranks, permute_rows, piece_range, resolve_mesh


class _PermutedMatrix:
    """Host-side view of A under a permutation of each side: entry (r, c)
    moves to (iperm_row[r], iperm_col[c]).  ``iperm_col`` defaults to
    ``iperm_row`` (the symmetric similarity P A P^T); ``None`` on a side is
    the identity (cross-space operators where one space has no basis)."""

    _SAME = object()

    def __init__(self, matrix, iperm_row, iperm_col=_SAME):
        if iperm_col is _PermutedMatrix._SAME:
            iperm_col = iperm_row
        rows = np.asarray(matrix.rows, np.int64)
        cols = np.asarray(matrix.cols, np.int64)
        self.rows = rows if iperm_row is None else iperm_row[rows]
        self.cols = cols if iperm_col is None else iperm_col[cols]
        self.vals = matrix.vals
        self.n_domain = matrix.n_domain
        self.n_range = matrix.n_range
        self.n_kernel = matrix.n_kernel


def inverse_perm(perm: np.ndarray) -> np.ndarray:
    iperm = np.empty(len(perm), np.int64)
    iperm[perm] = np.arange(len(perm))
    return iperm


def padded_perm(perm: np.ndarray, padded: int, device, mesh=None,
                num_pieces: int = 1) -> torch.Tensor:
    """``perm`` extended by the identity over the padding slots, as an
    int64 device index; on a mesh over processes (``mesh``, the padded
    size in ``num_pieces`` pieces) this process's rows of it."""
    lo, hi = piece_range(mesh, num_pieces)
    B = padded // num_pieces
    tail = np.arange(len(perm), padded, dtype=np.int64)
    return torch.as_tensor(np.concatenate([perm, tail])[lo * B: hi * B],
                           device=device)


def rcm_reorder(matrix) -> tuple:
    """(permuted matrix, perm, iperm), perm from scipy's RCM: perm[i] =
    original index at reordered position i."""
    from ..native.bindings import rcm_permutation

    perm = rcm_permutation(matrix.n_range, np.asarray(matrix.rows, np.int64),
                           np.asarray(matrix.cols, np.int64))
    iperm = inverse_perm(perm)
    return _PermutedMatrix(matrix, iperm), perm, iperm


class ReorderedOperator:
    """A in the original basis, computed by ``base`` in the reordered one.
    On a mesh over processes ``perm_dev`` and ``iperm_dev`` are this
    process's rows of the padded permutations."""

    def __init__(self, base, perm: np.ndarray, iperm: np.ndarray, partition,
                 options, device=None, mesh=None):
        self.base = base
        self.partition = partition
        self.options = options
        self.device = resolve_device(device)
        self.mesh = mesh
        P, S = partition.padded_size, partition.num_pieces
        self.perm_np, self.iperm_np = perm, iperm
        self.perm_dev = padded_perm(perm, P, self.device, mesh, S)
        self.iperm_dev = padded_perm(iperm, P, self.device, mesh, S)
        self.in_basis = False  # toggled by SquarePlanner.to_solver_basis

    @property
    def n_domain(self) -> int:
        return self.base.n_domain

    @property
    def n_range(self) -> int:
        return self.base.n_range

    def nnz(self) -> int:
        return self.base.nnz()

    @property
    def uses_pallas(self) -> bool:
        return getattr(self.base, "uses_pallas", False)

    @property
    def supports_matvec_dot(self) -> bool:
        return getattr(self.base, "supports_matvec_dot", False)

    def device_state(self):
        base_state = (self.base.device_state()
                      if hasattr(self.base, "device_state") else None)
        return (base_state, self.perm_dev, self.iperm_dev)

    def set_device_state(self, state) -> None:
        base_state, self.perm_dev, self.iperm_dev = state
        if base_state is not None:
            self.base.set_device_state(base_state)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_basis:
            return self.base.matvec(x)
        py = self.base.matvec(permute_rows(self.mesh, x, self.perm_dev))
        return permute_rows(self.mesh, py, self.iperm_dev)

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    def matvec_dot(self, x: torch.Tensor):
        if self.in_basis:
            return self.base.matvec_dot(x)
        py, d = self.base.matvec_dot(permute_rows(self.mesh, x,
                                                  self.perm_dev))
        return permute_rows(self.mesh, py, self.iperm_dev), d

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_basis:
            return self.base.rmatvec(x)
        py = self.base.rmatvec(permute_rows(self.mesh, x, self.perm_dev))
        return permute_rows(self.mesh, py, self.iperm_dev)


def _env_flag(name: str) -> bool:
    return bool(os.environ.get(name))


def try_reordered_operator(
    matrix, partition, options, perm: Optional[np.ndarray] = None,
    mesh=None, force: bool = False, device=None,
) -> Optional[ReorderedOperator]:
    """The best reordered operator for an explicit matrix that failed the
    direct DIA gate, or None when reordering does not help.

    On the permuted matrix, in order: DIA, then windowed ELL (sliced or
    uniform), then (no band found) the routed gather in the matrix's own
    degree-sorted basis.  ``perm`` forces a permutation (every matrix of a
    space shares its basis); ``force=True`` (with ``perm``) never returns
    None: without a fast kernel in that basis the permuted matrix goes to
    the ELL ``RowPartitionedMatrix``.  Matrices below n = 1024 stay
    unpermuted.  On pieces (``mesh``): DIA on pieces, else the sharded
    ``RowPartitionedMatrix`` of the permuted matrix, kept when its windowed
    plan exists or under ``force``.  On a mesh over processes every rank
    computes (or is given) the permutation and raises RuntimeError unless
    every other rank holds the same one.  LEGIONSOLVERS_NO_SLICED_ELL and
    LEGIONSOLVERS_NO_GENSPMV turn off those two operators."""
    from .dia_op import DiaOperator, dia_offsets, numpy_dtype

    mesh, device = resolve_mesh(mesh, partition, device)
    if not force:
        if partition.num_pieces > 1 and mesh is None:
            return None
        if matrix.n_domain != matrix.n_range:
            return None
    n = matrix.n_range
    if not force and n < 1024:
        return None
    if perm is None:
        pm, perm, iperm = rcm_reorder(matrix)
    else:
        perm = np.asarray(perm, np.int64)
        iperm = inverse_perm(perm)
        pm = _PermutedMatrix(matrix, iperm)
    check_same_on_ranks(mesh, perm, "the reordered basis's permutation")
    dtype = numpy_dtype(options.entry_dtype)
    one_piece = partition.num_pieces == 1

    base = None
    if ((one_piece or mesh is not None)
            and dia_offsets(pm, partition.padded_size) is not None):
        base = DiaOperator(pm, partition=partition, mesh=mesh,
                           options=options, device=device)
    if base is None and one_piece:
        from .winell_op import (
            SlicedWinEllOperator,
            WinEllOperator,
            plan_winell,
            plan_winell_classes,
        )

        planc = None
        if not _env_flag("LEGIONSOLVERS_NO_SLICED_ELL"):
            planc = plan_winell_classes(
                pm.rows, pm.cols, np.asarray(pm.vals), n,
                partition.padded_size, dtype)
        if planc is not None and "classes" in planc:
            base = SlicedWinEllOperator(pm, partition, options, plan=planc,
                                        device=device)
        elif planc is not None:
            base = WinEllOperator(pm, partition, options, plan=planc,
                                  device=device)
        else:
            plan = plan_winell(pm.rows, pm.cols, np.asarray(pm.vals), n,
                               partition.padded_size, dtype)
            if plan is not None:
                base = WinEllOperator(pm, partition, options, plan=plan,
                                      device=device)
    if (base is None and one_piece
            and not _env_flag("LEGIONSOLVERS_NO_GENSPMV")):
        # no band: the routed gather, in its own degree-sorted basis when
        # the basis is free, else in the given one
        from .genspmv import GeneralSpmvOperator, degree_sort_perm

        if not force:
            dperm = degree_sort_perm(matrix)
            diperm = inverse_perm(dperm)
            try:
                base_d = GeneralSpmvOperator(
                    _PermutedMatrix(matrix, diperm), partition, options,
                    device=device)
                return ReorderedOperator(base_d, dperm, diperm, partition,
                                         options, device=device)
            except ValueError:
                pass  # no feasible routing geometry (tiny or degenerate)
        else:
            try:
                base = GeneralSpmvOperator(pm, partition, options,
                                           device=device)
            except ValueError:
                pass
    if base is None and not one_piece:
        from .distmatrix import RowPartitionedMatrix

        rpm = RowPartitionedMatrix(
            pm, domain_partition=partition, range_partition=partition,
            mesh=mesh, options=options, device=device)
        # the basis pays only with the windowed plan (the unpermuted
        # gather-ELL is as fast), unless the basis exists already
        if rpm._win is not None or force:
            base = rpm
    if base is None and force:
        from .distmatrix import RowPartitionedMatrix

        base = RowPartitionedMatrix(
            pm, domain_partition=partition, range_partition=partition,
            mesh=mesh, options=options, device=device)
    if base is None:
        return None
    return ReorderedOperator(base, perm, iperm, partition, options,
                             device=device, mesh=mesh)


class CrossBasisOperator:
    """A cross-space operator expressed in the spaces' solver bases
    (identity on a side without one).  ``base`` is the ELL operator of the
    two-sided-permuted matrix; outside the basis every call permutes at
    the edges (on a mesh over processes through ``mesh.permute_rows``)."""

    supports_matvec_dot = False

    def __init__(self, base, dom_basis, rng_basis, dom_partition,
                 rng_partition, device=None, mesh=None):
        self.base = base
        self.in_basis = False
        self.device = resolve_device(device)
        self.mesh = mesh

        def pair(basis, part):
            if basis is None:
                return None, None
            return tuple(padded_perm(basis[k], part.padded_size, self.device,
                                     mesh, part.num_pieces)
                         for k in ("perm_np", "iperm_np"))

        self.dom_perm_dev, self.dom_iperm_dev = pair(dom_basis, dom_partition)
        self.rng_perm_dev, self.rng_iperm_dev = pair(rng_basis, rng_partition)

    @property
    def n_domain(self) -> int:
        return self.base.n_domain

    @property
    def n_range(self) -> int:
        return self.base.n_range

    def nnz(self) -> int:
        return self.base.nnz()

    @property
    def uses_pallas(self) -> bool:
        return getattr(self.base, "uses_pallas", False)

    def device_state(self):
        base_state = (self.base.device_state()
                      if hasattr(self.base, "device_state") else None)
        return (base_state, self.dom_perm_dev, self.dom_iperm_dev,
                self.rng_perm_dev, self.rng_iperm_dev)

    def set_device_state(self, state) -> None:
        (base_state, self.dom_perm_dev, self.dom_iperm_dev,
         self.rng_perm_dev, self.rng_iperm_dev) = state
        if base_state is not None:
            self.base.set_device_state(base_state)

    def _gather(self, x, idx):
        return x if idx is None else permute_rows(self.mesh, x, idx)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        if self.in_basis:
            return self.base.matvec(x)
        py = self.base.matvec(self._gather(x, self.dom_perm_dev))
        return self._gather(py, self.rng_iperm_dev)

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^T @ x: x over the range space, y over the domain space,
        in the solver bases or, outside them, in the natural order."""
        if self.in_basis:
            return self.base.rmatvec(x)
        py = self.base.rmatvec(self._gather(x, self.rng_perm_dev))
        return self._gather(py, self.dom_iperm_dev)


def cross_basis_operator(matrix, dom_partition, rng_partition, dom_basis,
                         rng_basis, mesh, options,
                         device=None) -> CrossBasisOperator:
    """Wrap ``matrix`` (spanning two planner spaces) so that it computes in
    the spaces' solver bases; ``dom_basis``/``rng_basis`` are the planner's
    per-space basis entries (None for the identity)."""
    from .distmatrix import RowPartitionedMatrix

    pm = _PermutedMatrix(
        matrix,
        rng_basis["iperm_np"] if rng_basis else None,
        dom_basis["iperm_np"] if dom_basis else None,
    )
    base = RowPartitionedMatrix(
        pm, domain_partition=dom_partition, range_partition=rng_partition,
        mesh=mesh, options=options, device=device)
    return CrossBasisOperator(base, dom_basis, rng_basis, dom_partition,
                              rng_partition, device=device, mesh=base.mesh)
