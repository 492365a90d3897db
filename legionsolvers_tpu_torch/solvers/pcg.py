"""Preconditioned Conjugate Gradient + Jacobi preconditioner.

Port of ``legionsolvers_tpu/solvers/pcg.py``.  The reference's interface
mentions preconditioners but implements none (its README.md:31); the JAX
package adds textbook PCG over the planner algebra with a pluggable
preconditioner and the diagonal (Jacobi) one.  On a stencil operator the
diagonal is a constant, so Jacobi is a scaling and PCG's iterates equal
CG's in exact arithmetic.

``solve`` loops over eager ``step()``s: q = A p and <p, q> come from one
kernel pass where the operator fuses them (K3 ``y_dot`` on the 2-D view,
K6a on the 3-D one), the rest is torch.  No step reads a scalar back to
the host.  On a mesh over processes each process holds its rows of the
Jacobi diagonal, and the planner's dots are collectives.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.scalar import Scalar
from ..parallel.mesh import piece_range
from ..planner import SquarePlanner


class JacobiPreconditioner:
    """z = D^{-1} r with D = diag(A), elementwise.

    Basis-aware: when the planner upgraded a matrix to a
    :class:`~legionsolvers_tpu_torch.parallel.reorder.ReorderedOperator`,
    the wrapped base holds the permuted matrix and the solver applies M
    inside the solver basis, so the inverse diagonal is kept in both bases
    (built once, on the device) and :meth:`apply` picks by
    ``planner._in_solver_basis``.  On a mesh over processes the device
    tensors hold this process's pieces, as its vectors do."""

    def __init__(self, planner: SquarePlanner):
        from ..parallel.reorder import ReorderedOperator

        self.planner = planner
        self.inv_diags = []        # original basis
        self.inv_diags_basis = []  # solver (reordered) basis
        dtype = planner.options.entry_dtype
        for space in range(planner.num_spaces):
            part = planner.canonical_partitions[space]
            diag = np.zeros(part.padded_size)
            for dist, dom, rng in planner.row_partitioned_matrices:
                if rng != space or dom != space:
                    continue
                base, perm = dist, None
                if isinstance(dist, ReorderedOperator):
                    # base.matrix lives in the reordered basis: position i
                    # holds original index perm[i]
                    base, perm = dist.base, dist.perm_np
                m = getattr(base, "matrix", None)
                if m is not None:
                    rows = np.asarray(m.rows)
                    on_diag = rows == np.asarray(m.cols)
                    r = rows[on_diag]
                    if perm is not None:
                        r = perm[r]
                    np.add.at(diag, r, np.asarray(m.vals)[on_diag])
                else:  # stencil operator: constant diagonal
                    for off, v in dist.offsets:
                        if all(c == 0 for c in off):
                            diag[: part.n] += v
            inv = np.zeros_like(diag)
            nz = diag != 0
            inv[nz] = 1.0 / diag[nz]
            gs = planner.canonical_grid_shapes[space]
            lo, hi = piece_range(planner.mesh, part.num_pieces)
            B, S = part.block_size, part.num_pieces

            def to_dev(a):
                a = a[lo * B: hi * B]  # this process's pieces
                if gs:
                    a = a.reshape((gs[0] // S * (hi - lo),) + tuple(gs[1:]))
                return torch.as_tensor(a, dtype=dtype, device=planner.device)

            arr = to_dev(inv)
            self.inv_diags.append(arr)
            basis = planner.basis_perms.get(space)
            if basis is None:
                self.inv_diags_basis.append(arr)
            else:
                perm_np = basis["perm_np"]
                tail = np.arange(len(perm_np), part.padded_size)
                self.inv_diags_basis.append(
                    to_dev(inv[np.concatenate([perm_np, tail])]))

    def state(self):
        """The per-space inverse diagonals of the current basis."""
        src = (self.inv_diags_basis if self.planner._in_solver_basis
               else self.inv_diags)
        return tuple(src)

    def apply(self, space: int, r: torch.Tensor) -> torch.Tensor:
        return self.state()[space] * r


class PCGSolver:
    """Preconditioned CG: the planner discipline of CGSolver (SOL=0,
    RHS=1) with workspace P=2, Q=3, R=4, Z=5."""

    SOL = 0
    RHS = 1
    P = 2
    Q = 3
    R = 4
    Z = 5

    def __init__(self, planner: SquarePlanner,
                 preconditioner: Optional[object] = None):
        self.planner = planner
        self.M = preconditioner
        planner.allocate_workspace(4)
        self.reset()

    def reset(self) -> None:
        """Derive the workspace from the CURRENT sol/rhs vectors, assuming
        x0 = 0 as the reference does (callers restarting from scratch
        zero-fill the solution vector first)."""
        planner = self.planner
        planner.copy(self.R, self.RHS)
        self._apply_M(self.Z, self.R)
        planner.copy(self.P, self.Z)
        self.rz: List[Scalar] = [planner.dot(self.R, self.Z)]
        self.residual_norm_squared: List[Scalar] = [
            planner.dot(self.R, self.R)]

    def _apply_M(self, dst_idx: int, src_idx: int) -> None:
        planner = self.planner
        for i in range(planner.num_spaces):
            src = planner.get_vector(src_idx, i)
            dst = planner.get_vector(dst_idx, i)
            dst.data = self.M.apply(i, src.data) if self.M else src.data

    def step(self) -> None:
        planner = self.planner
        pq = planner.matvec_dot(self.Q, self.P)
        rz_old = self.rz[-1]
        planner.axpy(self.SOL, rz_old, pq, self.P)
        planner.axpy(self.R, Scalar(-1.0), rz_old, pq, self.Q)
        self._apply_M(self.Z, self.R)
        rz_new = planner.dot(self.R, self.Z)
        self.rz.append(rz_new)
        self.residual_norm_squared.append(planner.dot(self.R, self.R))
        planner.xpay(self.P, rz_new, rz_old, self.Z)

    def solve(self, num_iterations: int) -> torch.Tensor:
        """Run ``num_iterations`` steps and return the residual² history
        (length ``num_iterations + 1``; entry 0 is <r, r> on entry) as a
        device tensor, in the solver basis of a reordered system."""
        self.planner.to_solver_basis()
        try:
            return self._solve_in_basis(num_iterations)
        finally:
            self.planner.from_solver_basis()

    def _solve_in_basis(self, num_iterations: int) -> torch.Tensor:
        planner = self.planner
        rr0 = planner.dot(self.R, self.R).value
        history = torch.empty(num_iterations + 1, dtype=rr0.dtype,
                              device=planner.device)
        history[0] = rr0
        self.rz = self.rz[-1:]
        for i in range(num_iterations):
            self.step()
            history[i + 1] = self.residual_norm_squared[-1].value
        self.rz = self.rz[-1:]
        self.residual_norm_squared = [Scalar(history[-1])]
        return history
