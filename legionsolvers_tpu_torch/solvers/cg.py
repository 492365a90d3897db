"""Conjugate Gradient solver over the planner algebra.

Port of ``legionsolvers_tpu/solvers/cg.py`` (reference: CGSolver.hpp:13-57):
same vector indices (SOL=0, RHS=1, P=2, Q=3, R=4), same future-ratio
coefficient passing, same residual-norm-squared history.  ``step()`` is
eager torch; :meth:`solve` hands the whole loop to the operator's fused
runner where one exists (the hand-written CUDA passes of
``ops/cuda/stencil2d.py`` or ``stencil3d.py`` on a card; on the pieces
of a mesh the sharded runners of ``parallel/stencil_op.py``), on a
block-diagonal multi-space system to the block runner of
``parallel/block_fused.py`` (the same passes per space), and loops over
``step()`` otherwise.
No step reads a scalar back to the host, except on a mesh over processes,
where the per-piece partials of every dot cross the processes through
host memory; every rank then holds the same history.
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
        """The fused whole-loop runner, else None.  Single space: the
        operator's own (s-step or two-pass on the 2-D view, two-pass on the
        3-D view, or the torch recompute runner).  Block-diagonal
        multi-space systems (the reference's benchmark stress
        configuration, BenchmarkStencil.cpp:201-207): per-space fused
        phases with cross-space scalar sums (``parallel/block_fused.py``)."""
        from ..parallel.block_fused import (
            block_cg_supported,
            diagonal_block_ops,
            make_block_cg_runner,
        )

        ops = diagonal_block_ops(self.planner)
        if ops is None:
            return None
        if self.planner.num_spaces == 1:
            op = ops[0]
            if not getattr(op, "supports_fused_cg", False):
                return None
            return op.make_fused_cg_runner(num_iterations)
        if not block_cg_supported(ops) or num_iterations < 1:
            return None
        return make_block_cg_runner(ops, num_iterations)

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
                nsp = planner.num_spaces
                xs, rs, ps = ([planner.get_vector(i, s) for s in range(nsp)]
                              for i in (self.SOL, self.R, self.P))
                _unshare_for_inplace(
                    (*xs, *rs, *ps),
                    *(planner.get_vector(self.RHS, s) for s in range(nsp)))
                rr0 = self.residual_norm_squared[-1].value
                data = lambda vs: tuple(v.data for v in vs)
                if nsp == 1:
                    xd, rd, pd, history = frun(xs[0].data, rs[0].data,
                                               ps[0].data, rr0)
                    xd, rd, pd = (xd,), (rd,), (pd,)
                else:
                    xd, rd, pd, history = frun(data(xs), data(rs), data(ps),
                                               rr0)
                for s in range(nsp):
                    xs[s].data, rs[s].data, ps[s].data = xd[s], rd[s], pd[s]
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
