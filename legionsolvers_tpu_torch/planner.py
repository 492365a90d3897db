"""SquarePlanner: assembles vectors + operators into a solvable system.

Port of ``legionsolvers_tpu/planner.py`` (reference:
SquarePlanner.hpp:30-357) for one device.  It keeps the reference's
vector-index algebra: index 0 is the solution vector set, 1 the right-hand
side set, ``2 + k`` the k-th workspace set, each set holding one vector per
registered space, so the solvers are near-transcriptions of the reference.

Every vector and operator must live on the planner's ``device``; the
registration methods check it.  An explicit square matrix on a one-piece
space is upgraded as in the JAX package: few well-filled diagonals become a
:class:`~.parallel.dia_op.DiaOperator` (kernel K8); otherwise
``parallel/reorder.py`` tries an RCM basis (DIA or windowed ELL, K9) and
then the routed gather in a degree-sorted basis (K10).  Everything else,
multi-piece partitions included, becomes the ELL
:class:`~.parallel.distmatrix.RowPartitionedMatrix`.  A space that adopts a
reordered basis keeps it: later operators on it are expressed in it, and
solvers enter the basis for the duration of ``solve()``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .core.matrix import AbstractMatrix
from .core.partition import BlockPartition
from .core.scalar import Scalar
from .core.vector import PartitionedVector
from .ops import blas1
from .ops.ddsum import dd_dot
from .options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from .parallel.distmatrix import RowPartitionedMatrix

SOL = 0
RHS = 1


class SquarePlanner:
    def __init__(
        self, mesh=None, options: SolverOptions = DEFAULT_OPTIONS,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "sharded planners are not ported to the torch package yet"
            )
        self.mesh = None
        self.options = options
        self.device = resolve_device(device)
        self.canonical_partitions: List[BlockPartition] = []
        self.canonical_grid_shapes: List[Optional[tuple]] = []
        self.sol_vectors: List[PartitionedVector] = []
        self.rhs_vectors: List[PartitionedVector] = []
        self.workspace_vectors: List[List[PartitionedVector]] = []
        self.row_partitioned_matrices: List[Tuple[object, int, int]] = []
        # reordered-basis state, per space (parallel/reorder.py): perm_np,
        # iperm_np (host) and perm_dev, iperm_dev (padded device indices)
        self.basis_perms: Dict[int, Dict] = {}
        self._in_solver_basis = False

    @property
    def basis_perm(self):
        """Space 0's basis entry, or None (the JAX package's single-basis
        view)."""
        return self.basis_perms.get(0)

    def adopt_basis(self, space: int, perm) -> None:
        """Put ``space`` in the solver basis ``perm`` (perm[i] = the
        original index at position i) before any operator touches it; the
        space's matrices are then expressed in that basis, as when the
        planner's own RCM upgrade chose it."""
        from .parallel.reorder import inverse_perm, padded_perm

        if any(space in (d, r) for _, d, r in self.row_partitioned_matrices):
            raise ValueError(f"space {space} already has operators")
        perm = np.asarray(perm, np.int64)
        iperm = inverse_perm(perm)
        P = self.canonical_partitions[space].padded_size
        self.basis_perms[space] = {
            "perm_np": perm, "iperm_np": iperm,
            "perm_dev": padded_perm(perm, P, self.device),
            "iperm_dev": padded_perm(iperm, P, self.device),
        }

    def _check_device(self, what: str, device) -> None:
        if device != self.device:
            raise ValueError(
                f"{what} lives on {device}, the planner on {self.device}"
            )

    # -- registration (reference: SquarePlanner.hpp:99-188) ----------------
    def _register_canonical(self, idx: int, v: PartitionedVector) -> None:
        self._check_device(f"vector {v.name!r}", v.device)
        if len(self.canonical_partitions) > idx:
            if self.canonical_partitions[idx] != v.partition:
                raise ValueError("vector partition disagrees with canonical")
            if self.canonical_grid_shapes[idx] != v.grid_shape:
                raise ValueError("vector layout disagrees with canonical")
        else:
            if len(self.canonical_partitions) != idx:
                raise ValueError("sol/rhs vectors must be added alternately")
            self.canonical_partitions.append(v.partition)
            self.canonical_grid_shapes.append(v.grid_shape)

    def add_sol_vector(self, v: PartitionedVector) -> int:
        if self.workspace_vectors:
            raise RuntimeError("cannot add vectors after allocate_workspace")
        idx = len(self.sol_vectors)
        self._register_canonical(idx, v)
        self.sol_vectors.append(v)
        return idx

    def add_rhs_vector(self, v: PartitionedVector) -> int:
        if self.workspace_vectors:
            raise RuntimeError("cannot add vectors after allocate_workspace")
        idx = len(self.rhs_vectors)
        self._register_canonical(idx, v)
        self.rhs_vectors.append(v)
        return idx

    @property
    def num_spaces(self) -> int:
        n = len(self.canonical_partitions)
        assert n == len(self.sol_vectors) == len(self.rhs_vectors)
        return n

    def allocate_workspace(self, num_vectors: int) -> None:
        """``num_vectors`` workspace sets, one lazy vector per space
        (reference: SquarePlanner.hpp:153-188)."""
        if self.workspace_vectors:
            raise RuntimeError("workspace already allocated")
        for j in range(num_vectors):
            self.workspace_vectors.append([
                PartitionedVector(
                    f"workspace_{j}_{i}",
                    self.canonical_partitions[i],
                    options=self.options,
                    grid_shape=self.canonical_grid_shapes[i],
                    lazy=True,
                    device=self.device,
                )
                for i in range(self.num_spaces)
            ])

    def add_row_partitioned_matrix(
        self, matrix: AbstractMatrix, domain_index: int, range_index: int,
        prefer_dia: bool = True,
    ) -> None:
        """reference: SquarePlanner.hpp:209-235.  The storage follows the
        JAX planner's layout analysis: a space in a reordered basis gets
        the matrix in that basis (a second square matrix through the forced
        path of ``try_reordered_operator``, a cross-space one as a
        ``CrossBasisOperator``); a square one-piece matrix with few
        well-filled diagonals becomes a ``DiaOperator``; otherwise an RCM or
        degree-sorted basis is tried on a space no operator touches yet;
        the rest is the ELL ``RowPartitionedMatrix``.  ``prefer_dia=False``
        or LEGIONSOLVERS_NO_DIA=1 skip the DIA upgrade, ``prefer_dia=False``
        or LEGIONSOLVERS_NO_RCM=1 the basis upgrade."""
        from .parallel.dia_op import DiaOperator, dia_offsets
        from .parallel.reorder import (
            cross_basis_operator,
            try_reordered_operator,
        )

        if domain_index >= self.num_spaces or range_index >= self.num_spaces:
            raise ValueError("space index out of range")
        dp = self.canonical_partitions[domain_index]
        rp = self.canonical_partitions[range_index]
        dist = None
        same_space = domain_index == range_index
        dom_basis = self.basis_perms.get(domain_index)
        rng_basis = self.basis_perms.get(range_index)
        # once a space is in a basis, every operator touching it must be
        # expressed in that basis: to_solver_basis permutes its vectors
        if same_space and rng_basis is not None:
            dist = try_reordered_operator(
                matrix, rp, self.options, perm=rng_basis["perm_np"],
                force=True, device=self.device)
        elif not same_space and (dom_basis is not None
                                 or rng_basis is not None):
            dist = cross_basis_operator(
                matrix, dp, rp, dom_basis, rng_basis, None, self.options,
                device=self.device)
        one_piece_flat = (
            matrix.n_domain == matrix.n_range and dp == rp
            and dp.num_pieces == 1
            and self.canonical_grid_shapes[domain_index] is None)
        if (dist is None and prefer_dia and one_piece_flat
                and not bool(int(os.environ.get("LEGIONSOLVERS_NO_DIA", "0")))
                and dia_offsets(matrix, rp.padded_size) is not None):
            dist = DiaOperator(matrix, partition=rp, options=self.options,
                               device=self.device)
        if (dist is None and prefer_dia and same_space and one_piece_flat
                and not bool(int(os.environ.get("LEGIONSOLVERS_NO_RCM", "0")))
                # a fresh basis only on a space no other operator touches
                and not any(range_index in (d, r)
                            for _, d, r in self.row_partitioned_matrices)):
            dist = try_reordered_operator(matrix, rp, self.options,
                                          device=self.device)
            if dist is not None:
                self.basis_perms[range_index] = {
                    "perm_np": dist.perm_np,
                    "iperm_np": dist.iperm_np,
                    "perm_dev": dist.perm_dev,
                    "iperm_dev": dist.iperm_dev,
                }
        if dist is None:
            dist = RowPartitionedMatrix(
                matrix, domain_partition=dp, range_partition=rp,
                options=self.options, device=self.device)
        self.row_partitioned_matrices.append((dist, domain_index, range_index))

    def add_operator(self, op, domain_index: int, range_index: int) -> None:
        """Register a pre-built operator (e.g. a matrix-free
        :class:`~.parallel.stencil_op.StencilOperator`) exposing
        ``matvec``/``matvec_add`` over the space's vectors."""
        if domain_index >= self.num_spaces or range_index >= self.num_spaces:
            raise ValueError("space index out of range")
        if domain_index in self.basis_perms or range_index in self.basis_perms:
            # a matrix-free operator cannot be re-expressed in the basis
            raise ValueError(
                "cannot register a matrix-free operator on a space already "
                "in an RCM solver basis; register it before any reorderable "
                "matrix, or pass prefer_dia=False / set "
                "LEGIONSOLVERS_NO_RCM=1 for the explicit matrices")
        self._check_device("operator", op.device)
        part = getattr(op, "partition", None)
        if part is not None and part != self.canonical_partitions[range_index]:
            raise ValueError("operator partition disagrees with canonical")
        self.row_partitioned_matrices.append((op, domain_index, range_index))

    # -- vector access (reference: SquarePlanner.hpp:237-246) --------------
    def get_vector(self, vec_idx: int, space_idx: int) -> PartitionedVector:
        if vec_idx == SOL:
            return self.sol_vectors[space_idx]
        if vec_idx == RHS:
            return self.rhs_vectors[space_idx]
        return self.workspace_vectors[vec_idx - 2][space_idx]

    def _vectors(self, vec_idx: int) -> List[PartitionedVector]:
        return [self.get_vector(vec_idx, i) for i in range(self.num_spaces)]

    # -- algebra (reference: SquarePlanner.hpp:248-357) --------------------
    def zero_fill(self, vec_idx: int) -> None:
        for v in self._vectors(vec_idx):
            v.zero_fill()

    def copy(self, dst_idx: int, src_idx: int) -> None:
        """dst = src by sharing the buffer, as the JAX package does."""
        for d, s in zip(self._vectors(dst_idx), self._vectors(src_idx)):
            d.assign(s)

    def scal(self, dst_idx: int, *alpha) -> None:
        """dst *= alpha, with the vectors' future-ratio protocol."""
        for v in self._vectors(dst_idx):
            v.scal(*alpha)

    def axpy(self, dst_idx: int, *args) -> None:
        """axpy(dst, alpha..., src): dst += alpha * src with the 1/2/3-scalar
        future-ratio protocol (reference: SquarePlanner.hpp:275-310)."""
        *alpha, src_idx = args
        for d, s in zip(self._vectors(dst_idx), self._vectors(src_idx)):
            d.axpy(*alpha, s)

    def xpay(self, dst_idx: int, *args) -> None:
        *alpha, src_idx = args
        for d, s in zip(self._vectors(dst_idx), self._vectors(src_idx)):
            d.xpay(*alpha, s)

    def dot(self, v_idx: int, w_idx: int) -> Scalar:
        """Sum of per-space dots (reference: SquarePlanner.hpp:331-338).
        Under ``options.compensated_dots`` each dot is :func:`dd_dot`."""
        if self.options.compensated_dots:
            dtype = self.options.entry_dtype
            d = lambda a, b: dd_dot(a, b).to(dtype)
        else:
            d = blas1.dot
        parts = [
            d(v.data, w.data)
            for v, w in zip(self._vectors(v_idx), self._vectors(w_idx))
        ]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return Scalar(total)

    def _operators_by_range(self):
        by_range = {}
        for dist, domain_index, range_index in self.row_partitioned_matrices:
            by_range.setdefault(range_index, []).append((dist, domain_index))
        return by_range

    def matvec(self, dst_idx: int, src_idx: int) -> None:
        """dst = sum over registered operators of A @ src, per range space
        (reference: SquarePlanner.hpp:340-357)."""
        by_range = self._operators_by_range()
        for i in range(self.num_spaces):
            dst = self.get_vector(dst_idx, i)
            ops = by_range.get(i, [])
            if not ops:
                dst.zero_fill()
                continue
            first = True
            for dist, domain_index in ops:
                src = self.get_vector(src_idx, domain_index)
                if first:
                    dst.data = dist.matvec(src.data)
                    first = False
                else:
                    dst.data = dist.matvec_add(dst.data, src.data)

    def matvec_dot(self, dst_idx: int, src_idx: int) -> Scalar:
        """dst = A src and <src, dst> in one pass where every space has one
        square operator advertising ``supports_matvec_dot``; matvec + dot
        otherwise."""
        by_range = self._operators_by_range()
        fusable = all(
            len(ops) == 1
            and getattr(ops[0][0], "supports_matvec_dot", False)
            and ops[0][1] == rng
            for rng, ops in by_range.items()
        ) and len(by_range) == self.num_spaces
        if not fusable:
            self.matvec(dst_idx, src_idx)
            return self.dot(src_idx, dst_idx)
        total = None
        for i in range(self.num_spaces):
            dist, _ = by_range[i][0]
            src = self.get_vector(src_idx, i)
            dst = self.get_vector(dst_idx, i)
            y, part = dist.matvec_dot(src.data)
            dst.data = y
            part = part.to(self.options.entry_dtype)
            total = part if total is None else total + part
        return Scalar(total)

    # -- reordered-basis solves (parallel/reorder.py) ----------------------
    def to_solver_basis(self) -> None:
        """Enter the reordered basis: permute every materialized vector of
        each space that has one, and switch the reordered operators to
        their no-permute path.  A no-op without a basis."""
        if not self.basis_perms or self._in_solver_basis:
            return
        self._permute_vectors("perm_dev")
        self._in_solver_basis = True
        self._set_ops_in_basis(True)

    def from_solver_basis(self) -> None:
        if not self.basis_perms or not self._in_solver_basis:
            return
        self._permute_vectors("iperm_dev")
        self._in_solver_basis = False
        self._set_ops_in_basis(False)

    def _permute_vectors(self, key: str) -> None:
        """Permute each space's vectors with that space's own basis; lazy
        vectors never materialized are zeros and stay lazy."""
        for space, basis in self.basis_perms.items():
            idx = basis[key]
            for vset in (self.sol_vectors, self.rhs_vectors,
                         *self.workspace_vectors):
                v = vset[space]
                if v._data is not None:
                    v.data = v.data.reshape(-1)[idx].reshape(v.data.shape)

    def _set_ops_in_basis(self, flag: bool) -> None:
        for op, _, _ in self.row_partitioned_matrices:
            if hasattr(op, "in_basis"):
                op.in_basis = flag

    # -- state snapshots -----------------------------------------------------
    def dump_state(self) -> Dict:
        """The vectors and each operator's device buffers, by reference."""
        state = {
            "sol": tuple(v.data for v in self.sol_vectors),
            "rhs": tuple(v.data for v in self.rhs_vectors),
            "ops": tuple(
                op.device_state() if hasattr(op, "device_state") else None
                for op, _, _ in self.row_partitioned_matrices
            ),
        }
        for j, ws in enumerate(self.workspace_vectors):
            state[f"ws{j}"] = tuple(v.data for v in ws)
        return state

    def load_state(self, state: Dict) -> None:
        for v, d in zip(self.sol_vectors, state["sol"]):
            v.data = d
        for v, d in zip(self.rhs_vectors, state["rhs"]):
            v.data = d
        for (op, _, _), s in zip(
            self.row_partitioned_matrices, state.get("ops", ())
        ):
            if s is not None:
                op.set_device_state(s)
        for j, ws in enumerate(self.workspace_vectors):
            for v, d in zip(ws, state[f"ws{j}"]):
                v.data = d
