"""BiCGStab solver (preconditioner-free) over the planner algebra.

Port of ``legionsolvers_tpu/solvers/bicgstab.py`` (reference:
BiCGStabSolver.hpp:13-84): same vector indices (SOL=0, RHS=1, P=2, R=3,
R_TILDE=4, U=5, V=6), same rho/alpha/omega recurrences carried as deferred
scalars, two matvecs per ``step()``.  :meth:`BiCGStabSolver.solve` hands the
whole loop to the operator's fused runner where one exists (the three
hand-written CUDA passes of ``ops/cuda/bicgstab2d.py`` or ``bicgstab3d.py``
on a card) and loops over ``step()`` otherwise.  No step reads a scalar
back to the host.

Numerics: at large n the f32 trajectory depends on the order in which the
carried dots are summed.  ``SolverOptions(compensated_dots=True)`` sums them
from exact products in float64 (``ops/ddsum.py``), on the fused and the
transcription path alike.
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
        """The operator's fused whole-loop runner for a single-space system
        whose one operator supports it, else None.  ``r~`` is passed as the
        RHS data itself (R_TILDE is always a copy of b in this solver).
        Multi-space block systems take the step() loop until the block
        runners of ``parallel/block_fused.py`` are ported."""
        from ..parallel.block_fused import diagonal_block_ops

        ops = diagonal_block_ops(self.planner)
        if ops is None or self.planner.num_spaces != 1:
            return None
        op = ops[0]
        if not getattr(op, "supports_fused_bicgstab", False):
            return None
        return op.make_fused_bicgstab_runner(num_iterations)

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
                x, r, p, v = (planner.get_vector(i, 0)
                              for i in (self.SOL, self.R, self.P, self.V))
                rhs = planner.get_vector(self.RHS, 0)
                _unshare_for_inplace((x, r, p, v), rhs)
                (x.data, r.data, p.data, v.data, rho, alpha, omega,
                 history) = frun(x.data, r.data, p.data, v.data, rhs.data,
                                 self.rho[-1].value, self.alpha[-1].value,
                                 self.omega[-1].value)
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
