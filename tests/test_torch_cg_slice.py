"""The port's 2-D CG main path against the JAX package, end to end.

The same system (2-D 5-point negative Laplacian on a (64, 128) grid, f32,
b = 1, x0 = 0) goes through both packages' ``CGSolver.solve``: the s-step
schedule (K2 bootstrap, K1 passes, K3 ``update`` tail), its Gram refresh,
and the two-pass schedule (K3 ``pq``/``update`` + K4) under
LEGIONSOLVERS_NO_SSTEP.  JAX runs its Pallas kernels in interpret mode; the
port runs the plain versions its wrappers take on CPU tensors.

Tolerances: x atol 1e-4 * max|x|; history rtol 1e-4, except 3e-4 for
the s-step schedule.  Both schedules are algebraically classic CG, so the
packages differ only by f32 rounding in another order, but the s-step
history chains each pass's coefficients through the previous pass's Gram
entries and so carries that rounding forward: without a refresh the two
packages drift apart to 1.2e-4 after 20 iterations and 2.2e-4 after 40
(1e-5 on the two-pass schedule).  test_20 holds s-step against classic
CG at 5e-4 for the same reason.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import __graft_entry__ as ge
import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu_torch.entry import build_system
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TK
from legionsolvers_tpu_torch.utils import convert

torch.set_num_threads(2)

SHAPE = (64, 128)
F32J = J.SolverOptions(entry_dtype=jnp.float32)
F32T = T.SolverOptions(entry_dtype=torch.float32)
SSTEP_RTOL = 3e-4
DEV = "cpu"


def build_jax(shape=SHAPE):
    n = int(np.prod(shape))
    part = J.BlockPartition(n, 1)
    op = J.StencilOperator(shape, J.laplacian_stencil(2), partition=part,
                           mesh=None, options=F32J)
    planner = J.SquarePlanner(mesh=None, options=F32J)
    planner.add_sol_vector(J.PartitionedVector(
        "sol", part, options=F32J, grid_shape=shape).zero_fill())
    planner.add_rhs_vector(J.PartitionedVector(
        "rhs", part, options=F32J, grid_shape=shape).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    return planner, op


def build_port(shape=SHAPE):
    n = int(np.prod(shape))
    part = T.BlockPartition(n, 1)
    op = T.StencilOperator(shape, T.laplacian_stencil(2), partition=part,
                           options=F32T, device=DEV)
    planner = T.SquarePlanner(options=F32T, device=DEV)
    planner.add_sol_vector(T.PartitionedVector(
        "sol", part, options=F32T, grid_shape=shape, device=DEV).zero_fill())
    planner.add_rhs_vector(T.PartitionedVector(
        "rhs", part, options=F32T, grid_shape=shape,
        device=DEV).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    return planner, op


def assert_same_run(hist_t, x_t, hist_j, x_j, hist_rtol=1e-4):
    np.testing.assert_allclose(np.asarray(hist_t), np.asarray(hist_j),
                               rtol=hist_rtol)
    np.testing.assert_allclose(x_t, x_j, rtol=0,
                               atol=1e-4 * np.abs(x_j).max())


def solve_both(iters):
    pj, opj = build_jax()
    pt, opt = build_port()
    hist_j = np.asarray(J.CGSolver(pj).solve(iters))
    hist_t = T.CGSolver(pt).solve(iters)
    return (hist_t, pt.sol_vectors[0].to_numpy(), hist_j,
            pj.sol_vectors[0].to_numpy(), opt, opj, pt)


@pytest.mark.parametrize("iters", [2, 7, 20])
def test_sstep_solve_matches_jax(iters):
    hist_t, x_t, hist_j, x_j, opt, opj, pt = solve_both(iters)
    assert opt.step2_eligible and opj.step2_eligible
    assert_same_run(hist_t.numpy(), x_t, hist_j, x_j, SSTEP_RTOL)
    # the fused runner wrote x and r in place: b must be intact
    assert (pt.rhs_vectors[0].to_numpy() == 1.0).all()


def test_sstep_refresh_matches_jax(monkeypatch):
    monkeypatch.setenv("LEGIONSOLVERS_SSTEP_REFRESH", "2")
    hist_t, x_t, hist_j, x_j, *_ = solve_both(20)
    assert_same_run(hist_t.numpy(), x_t, hist_j, x_j, SSTEP_RTOL)


@pytest.mark.parametrize("iters", [1, 7])
def test_two_pass_solve_matches_jax(iters, monkeypatch):
    """LEGIONSOLVERS_NO_SSTEP=1: the K3 pq/update + K4 xpay_pq schedule
    (one iteration takes it too: the s-step runner needs two)."""
    monkeypatch.setenv("LEGIONSOLVERS_NO_SSTEP", "1")
    hist_t, x_t, hist_j, x_j, opt, opj, _ = solve_both(iters)
    assert not opt.step2_eligible and not opj.step2_eligible
    assert opt.supports_fused_cg
    assert_same_run(hist_t.numpy(), x_t, hist_j, x_j)


def test_eager_steps_match_jax():
    """step() goes through matvec_dot, i.e. the K3 y_dot pass."""
    pj, _ = build_jax()
    pt, _ = build_port()
    sj, st = J.CGSolver(pj), T.CGSolver(pt)
    for _ in range(3):
        sj.step()
        st.step()
    np.testing.assert_allclose(
        [s.get_value() for s in st.residual_norm_squared],
        [float(s.value) for s in sj.residual_norm_squared], rtol=1e-5)
    np.testing.assert_allclose(
        pt.sol_vectors[0].to_numpy(), pj.sol_vectors[0].to_numpy(),
        rtol=0, atol=1e-5 * np.abs(pj.sol_vectors[0].to_numpy()).max())


def test_exact_continuation_from_jax_state():
    """JAX runs two step()s; convert.py carries its state into the port;
    both then run solve(4) from the same state."""
    pj, _ = build_jax()
    sj = J.CGSolver(pj)
    sj.step()
    sj.step()
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k != "ops"}
    rr = [float(s.value) for s in sj.residual_norm_squared]
    pt, st = convert.stencil_cg_system(
        SHAPE, T.laplacian_stencil(2), state, rr[-1:], options=F32T,
        device=DEV)
    hist_t = st.solve(4)
    hist_j = np.asarray(sj.solve(4))
    assert hist_t[0].item() == np.float32(rr[-1])
    assert_same_run(hist_t.numpy(), pt.sol_vectors[0].to_numpy(),
                    hist_j, pj.sol_vectors[0].to_numpy(), SSTEP_RTOL)


def test_entry_build_system_matches_graft_entry():
    """entry.build_system mirrors __graft_entry__._build_system."""
    pj = ge._build_system(128, mesh=None, pieces=1, options=F32J)
    pt = build_system(128, F32T, DEV)
    opj = pj.row_partitioned_matrices[0][0]
    opt = pt.row_partitioned_matrices[0][0]
    assert opt.uses_pallas and opj.uses_pallas
    assert opt.step2_eligible and opj.step2_eligible
    assert pt.rhs_vectors[0].grid_shape == pj.rhs_vectors[0].grid_shape
    hist_j = np.asarray(J.CGSolver(pj).solve(6))
    hist_t = T.CGSolver(pt).solve(6)
    assert_same_run(hist_t.numpy(), pt.sol_vectors[0].to_numpy(),
                    hist_j, pj.sol_vectors[0].to_numpy(), SSTEP_RTOL)


class _Count:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


@pytest.mark.parametrize("iters,step2,gram2,update", [
    (200, 100, 7, 0), (201, 100, 7, 1), (50, 25, 2, 0),
])
def test_sstep_schedule_pass_counts(iters, step2, gram2, update,
                                    monkeypatch):
    """The refresh structure: blocks of 16 passes with a gram2 between
    blocks, and an odd tail as one update pass."""
    counts = {}
    for name in ("grid2d_cg_step2", "grid2d_cg_gram2", "grid2d_cg_update"):
        counts[name] = _Count(getattr(TK, name))
        monkeypatch.setattr(TK, name, counts[name])
    planner, _ = build_port()
    hist = T.CGSolver(planner).solve(iters)
    assert hist.shape == (iters + 1,) and torch.isfinite(hist).all()
    assert counts["grid2d_cg_step2"].calls == step2
    assert counts["grid2d_cg_gram2"].calls == gram2
    assert counts["grid2d_cg_update"].calls == update


def test_fp64_stencil_matches_jax():
    """fp64 has no kernel view on either side: both run the recompute
    runner over the linearized matvec."""
    F64J = J.SolverOptions(entry_dtype=jnp.float64)
    F64T = T.SolverOptions(entry_dtype=torch.float64)
    shape = (24, 40)
    n = int(np.prod(shape))
    pj = J.SquarePlanner(mesh=None, options=F64J)
    pj.add_sol_vector(J.PartitionedVector("s", J.BlockPartition(n, 1),
                                          options=F64J))
    pj.add_rhs_vector(J.PartitionedVector(
        "b", J.BlockPartition(n, 1), options=F64J).constant_fill(1.0))
    opj = J.StencilOperator(shape, J.laplacian_stencil(2), options=F64J)
    pj.add_operator(opj, 0, 0)
    pt = T.SquarePlanner(options=F64T, device=DEV)
    pt.add_sol_vector(T.PartitionedVector("s", T.BlockPartition(n, 1),
                                          options=F64T, device=DEV))
    pt.add_rhs_vector(T.PartitionedVector(
        "b", T.BlockPartition(n, 1), options=F64T,
        device=DEV).constant_fill(1.0))
    opt = T.StencilOperator(shape, T.laplacian_stencil(2), options=F64T,
                            device=DEV)
    pt.add_operator(opt, 0, 0)
    assert not opt.uses_pallas and not opj.uses_pallas
    hist_j = np.asarray(J.CGSolver(pj).solve(15))
    hist_t = T.CGSolver(pt).solve(15).numpy()
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-12)
    np.testing.assert_allclose(pt.sol_vectors[0].to_numpy(),
                               pj.sol_vectors[0].to_numpy(), rtol=1e-12)
