"""Conjugate Gradient solver over the planner algebra.

Port of ``legionsolvers_tpu/solvers/cg.py`` (reference: CGSolver.hpp:13-57):
same vector indices (SOL=0, RHS=1, P=2, Q=3, R=4), same future-ratio
coefficient passing, same residual-norm-squared history.  ``step()`` is
eager torch; :meth:`solve` hands the whole loop to the operator's fused
runner where one exists (the hand-written CUDA passes of
``ops/cuda/stencil2d.py`` or ``stencil3d.py`` on a card) and loops over
``step()`` otherwise.
No step reads a scalar back to the host.
"""

from __future__ import annotations

from typing import List

import torch

from ..core.scalar import Scalar, ScalarHistory
from ..planner import SquarePlanner


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _unshare_for_inplace(vectors, *protected) -> None:
    """Give each vector a buffer of its own before a runner writes into it.

    ``planner.copy`` shares buffers (P and R alias the RHS after
    ``__init__``/``reset``).  Harmless in immutable JAX, but the fused
    runners update x and r in place, which would corrupt b.  This is the
    torch form of the JAX package's ``_unshare_for_donation``."""
    seen = {_storage(v.data) for v in protected}
    for v in vectors:
        if _storage(v.data) in seen:
            v.data = v.data.clone()
        seen.add(_storage(v.data))


class CGSolver:
    SOL = 0
    RHS = 1
    P = 2
    Q = 3
    R = 4

    def __init__(self, planner: SquarePlanner):
        self.planner = planner
        planner.allocate_workspace(3)
        planner.copy(self.P, self.RHS)
        planner.copy(self.R, self.RHS)
        self.residual_norm_squared: List[Scalar] = [planner.dot(self.R, self.R)]
        self._solve_cache = {}

    def reset(self) -> None:
        """Re-derive the workspace from the CURRENT sol/rhs vectors: P = R =
        b and history = [<b, b>].  Callers restarting from scratch
        ``zero_fill`` the solution vector first (the init assumes x0 = 0)."""
        planner = self.planner
        planner.copy(self.P, self.RHS)
        planner.copy(self.R, self.RHS)
        self.residual_norm_squared = [planner.dot(self.R, self.R)]

    def step(self) -> None:
        """One CG iteration (reference: CGSolver.hpp:46-55).  q = A p and
        <p, q> come from one kernel pass where the operator fuses them."""
        planner = self.planner
        p_norm = planner.matvec_dot(self.Q, self.P)
        r_norm2_old = self.residual_norm_squared[-1]
        planner.axpy(self.SOL, r_norm2_old, p_norm, self.P)
        planner.axpy(self.R, Scalar(-1.0), r_norm2_old, p_norm, self.Q)
        r_norm2_new = planner.dot(self.R, self.R)
        self.residual_norm_squared.append(r_norm2_new)
        planner.xpay(self.P, r_norm2_new, r_norm2_old, self.R)

    def _make_fused_runner(self, num_iterations: int):
        """The operator's fused whole-loop runner for a single-space system
        (s-step or two-pass on the 2-D view, two-pass on the 3-D view, or
        the torch recompute runner), else None.
        Multi-space block systems take the eager path until
        ``parallel/block_fused.py``'s phase runners are ported."""
        from ..parallel.block_fused import diagonal_block_ops

        ops = diagonal_block_ops(self.planner)
        if ops is None or self.planner.num_spaces != 1:
            return None
        op = ops[0]
        if not getattr(op, "supports_fused_cg", False):
            return None
        return op.make_fused_cg_runner(num_iterations)

    def solve(self, num_iterations: int) -> torch.Tensor:
        """Run ``num_iterations`` iterations and return the residual²
        history (length ``num_iterations + 1``) as a device tensor; the
        planner holds the final vectors.  On the fused path the Q workspace
        is left untouched."""
        # a reordered-basis system solves in its basis, permuting at the
        # edges only (a no-op otherwise): parallel/reorder.py
        self.planner.to_solver_basis()
        try:
            return self._solve_in_basis(num_iterations)
        finally:
            self.planner.from_solver_basis()

    def _solve_in_basis(self, num_iterations: int) -> torch.Tensor:
        planner = self.planner
        if num_iterations >= 1:
            fkey = (num_iterations, "fused")
            if fkey not in self._solve_cache:
                self._solve_cache[fkey] = self._make_fused_runner(
                    num_iterations
                )
            frun = self._solve_cache[fkey]
            if frun is not None:
                x, r, p = (planner.get_vector(i, 0)
                           for i in (self.SOL, self.R, self.P))
                _unshare_for_inplace(
                    (x, r, p), planner.get_vector(self.RHS, 0)
                )
                rr0 = self.residual_norm_squared[-1].value
                x.data, r.data, p.data, history = frun(
                    x.data, r.data, p.data, rr0
                )
                self.residual_norm_squared = ScalarHistory(history)
                return history

        rr0 = self.residual_norm_squared[-1].value
        history = torch.empty(
            num_iterations + 1, dtype=rr0.dtype, device=planner.device
        )
        history[0] = rr0
        for i in range(num_iterations):
            self.step()
            history[i + 1] = self.residual_norm_squared[-1].value
        self.residual_norm_squared = ScalarHistory(history)
        return history
