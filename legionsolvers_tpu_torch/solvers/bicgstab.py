"""BiCGStab solver (preconditioner-free) over the planner algebra.

Port of ``legionsolvers_tpu/solvers/bicgstab.py`` (reference:
BiCGStabSolver.hpp:13-84): same vector indices (SOL=0, RHS=1, P=2, R=3,
R_TILDE=4, U=5, V=6), same rho/alpha/omega recurrences carried as deferred
scalars, two matvecs per ``step()``.  :meth:`BiCGStabSolver.solve` hands the
whole loop to the operator's fused runner where one exists (the three
hand-written CUDA passes of ``ops/cuda/bicgstab2d.py`` or ``bicgstab3d.py``
on a card), on a block-diagonal multi-space system to the block runner of
``parallel/block_fused.py``, and loops over ``step()`` otherwise.  No step reads a scalar
back to the host.

Numerics: at large n the f32 trajectory depends on the order in which the
carried dots are summed.  ``SolverOptions(compensated_dots=True)`` sums them
from exact products in float64 (``ops/ddsum.py``), on the fused and the
transcription path alike.

On a mesh over processes both paths run as on one process: the fused
runner on each process's pieces (every dot gathered and added in piece
order, bit for bit the one-process mesh's), ``step()`` over the planner's
collective dots.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.scalar import Scalar
from ..planner import SquarePlanner
from .cg import _unshare_for_inplace


class BiCGStabSolver:
    SOL = 0
    RHS = 1
    P = 2
    R = 3
    R_TILDE = 4
    U = 5
    V = 6

    def __init__(self, planner: SquarePlanner):
        self.planner = planner
        planner.allocate_workspace(5)
        self._solve_cache = {}
        self.reset()

    def _scalar(self, value: float) -> Scalar:
        planner = self.planner
        return Scalar(torch.tensor(value, dtype=planner.options.entry_dtype,
                                   device=planner.device))

    def reset(self) -> None:
        """Re-derive the workspace state from the CURRENT sol/rhs vectors
        (the constructor's initialization without reallocating; callers
        restarting from scratch zero-fill the solution vector first)."""
        planner = self.planner
        planner.copy(self.R, self.RHS)
        planner.copy(self.R_TILDE, self.RHS)
        self.rho: List[Scalar] = [self._scalar(1.0)]
        self.alpha: List[Scalar] = [self._scalar(0.0)]
        self.omega: List[Scalar] = [self._scalar(1.0)]
        planner.zero_fill(self.P)
        planner.zero_fill(self.V)

    def step(self) -> None:
        """One BiCGStab iteration (reference: BiCGStabSolver.hpp:64-82)."""
        planner = self.planner
        rho_new = planner.dot(self.R, self.R_TILDE)
        beta = (rho_new / self.rho[-1]) * (self.alpha[-1] / self.omega[-1])
        self.rho.append(rho_new)
        planner.axpy(self.P, -self.omega[-1], self.V)
        planner.xpay(self.P, beta, self.R)
        planner.matvec(self.V, self.P)
        temp = planner.dot(self.R_TILDE, self.V)
        planner.axpy(self.R, Scalar(-1.0), self.rho[-1], temp, self.V)
        self.alpha.append(self.rho[-1] / temp)
        # U = A R with <R, A R> fused into the stencil pass where the
        # operator supports it (matvec + dot otherwise)
        r_anorm2 = planner.matvec_dot(self.U, self.R)
        u_norm2 = planner.dot(self.U, self.U)
        self.omega.append(r_anorm2 / u_norm2)
        planner.axpy(self.SOL, self.alpha[-1], self.P)
        planner.axpy(self.SOL, self.omega[-1], self.R)
        planner.axpy(self.R, -self.omega[-1], self.U)

    def residual_norm_squared(self) -> Scalar:
        return self.planner.dot(self.R, self.R)

    def _make_fused_runner(self, num_iterations: int):
        """The fused whole-loop runner, else None: for a single-space system
        its one operator's where it supports one, for a block-diagonal
        multi-space system the per-space phases of
        ``parallel/block_fused.py``.  ``r~`` is passed as the RHS data
        itself (R_TILDE is always a copy of b in this solver)."""
        from ..parallel.block_fused import (
            block_bicgstab_supported,
            diagonal_block_ops,
            make_block_bicgstab_runner,
        )

        ops = diagonal_block_ops(self.planner)
        if ops is None:
            return None
        if self.planner.num_spaces == 1:
            op = ops[0]
            if not getattr(op, "supports_fused_bicgstab", False):
                return None
            return op.make_fused_bicgstab_runner(num_iterations)
        if not block_bicgstab_supported(ops) or num_iterations < 1:
            return None
        return make_block_bicgstab_runner(ops, num_iterations)

    def solve(self, num_iterations: int) -> torch.Tensor:
        """Run ``num_iterations`` iterations and return the ||r||^2 history
        (length ``num_iterations + 1``, starting with the initial residual)
        as a device tensor; the planner holds the final vectors.  On the
        fused path the U workspace vector is left untouched (s and t = A s
        never reach device memory)."""
        # a reordered-basis system solves in its basis (parallel/reorder.py)
        self.planner.to_solver_basis()
        try:
            return self._solve_in_basis(num_iterations)
        finally:
            self.planner.from_solver_basis()

    def _solve_in_basis(self, num_iterations: int) -> torch.Tensor:
        planner = self.planner
        if num_iterations >= 1:
            if num_iterations not in self._solve_cache:
                self._solve_cache[num_iterations] = self._make_fused_runner(
                    num_iterations)
            frun = self._solve_cache[num_iterations]
            if frun is not None:
                nsp = planner.num_spaces
                xs, rs, ps, vs, rts = (
                    [planner.get_vector(i, s) for s in range(nsp)]
                    for i in (self.SOL, self.R, self.P, self.V, self.RHS))
                _unshare_for_inplace((*xs, *rs, *ps, *vs), *rts)
                scalars = (self.rho[-1].value, self.alpha[-1].value,
                           self.omega[-1].value)
                data = lambda vecs: tuple(v.data for v in vecs)
                if nsp == 1:
                    (xd, rd, pd, vd, rho, alpha, omega, history) = frun(
                        xs[0].data, rs[0].data, ps[0].data, vs[0].data,
                        rts[0].data, *scalars)
                    xd, rd, pd, vd = (xd,), (rd,), (pd,), (vd,)
                else:
                    (xd, rd, pd, vd, rho, alpha, omega, history) = frun(
                        data(xs), data(rs), data(ps), data(vs), data(rts),
                        *scalars)
                for s in range(nsp):
                    xs[s].data, rs[s].data = xd[s], rd[s]
                    ps[s].data, vs[s].data = pd[s], vd[s]
                dtype = planner.options.entry_dtype
                self.rho = [Scalar(rho.to(dtype))]
                self.alpha = [Scalar(alpha.to(dtype))]
                self.omega = [Scalar(omega.to(dtype))]
                return history

        rr0 = self.residual_norm_squared().value
        history = torch.empty(num_iterations + 1, dtype=rr0.dtype,
                              device=planner.device)
        history[0] = rr0
        for i in range(num_iterations):
            self.step()
            history[i + 1] = self.residual_norm_squared().value
        self.rho, self.alpha, self.omega = (
            s[-1:] for s in (self.rho, self.alpha, self.omega))
        return history
