"""The port's BiCGStab path against the JAX package, end to end.

* 2-D 5-point negative Laplacian, f32, b = 1, x0 = 0: the port's fused
  solve (K5 ``pv``/``st``/``update``, plain versions on CPU tensors) against
  the JAX fused solve (Pallas interpret mode) and against the port's own
  transcription under LEGIONSOLVERS_NO_FUSED_BICGSTAB, to rtol 2e-3 on the
  history and atol 5e-3 * max|x| (test_23's envelope).  f32 BiCGStab on
  this system amplifies rounding quickly: JAX's own f32 history leaves a
  float64 BiCGStab by 1e-3 at iteration 8 and by 5.8e-2 at iteration 12,
  so two f32 codes that sum in different orders cannot agree to 2e-3 at
  iteration 12.  Against JAX the port is therefore held to 2e-3 on the
  entries where JAX's f32 run stays within 1e-3 of float64, and over all
  entries to no more than twice JAX's own distance from float64;
* a JAX trajectory continued in the port (``bicgstab_solver_from_state``);
* float64 on the 1-D ELL path: test_06's asymmetric recurrence against its
  numpy transcription and JAX to rtol 1e-7, and the SPD solve;
* compensated dots against plain ones (test_25's 5e-3) and against JAX.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
from legionsolvers_tpu_torch.utils import convert
from torch_stencil_cases import apply_np

torch.set_num_threads(2)

SHAPE = (32, 128)
F64T = T.SolverOptions(entry_dtype=torch.float64)
F64J = J.SolverOptions(entry_dtype=jnp.float64)
DEV = "cpu"


def build_jax(shape=SHAPE, compensated=False):
    F = J.SolverOptions(entry_dtype=jnp.float32, compensated_dots=compensated)
    n = int(np.prod(shape))
    part = J.BlockPartition(n, 1)
    op = J.StencilOperator(shape, J.laplacian_stencil(2), partition=part,
                           mesh=None, options=F)
    planner = J.SquarePlanner(mesh=None, options=F)
    planner.add_sol_vector(J.PartitionedVector(
        "sol", part, options=F, grid_shape=shape).zero_fill())
    planner.add_rhs_vector(J.PartitionedVector(
        "rhs", part, options=F, grid_shape=shape).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    return planner, J.BiCGStabSolver(planner)


def port_planner(shape=SHAPE, compensated=False):
    F = T.SolverOptions(entry_dtype=torch.float32,
                        compensated_dots=compensated)
    n = int(np.prod(shape))
    part = T.BlockPartition(n, 1)
    op = T.StencilOperator(shape, T.laplacian_stencil(2), partition=part,
                           options=F, device=DEV)
    planner = T.SquarePlanner(options=F, device=DEV)
    planner.add_sol_vector(T.PartitionedVector(
        "sol", part, options=F, grid_shape=shape, device=DEV).zero_fill())
    planner.add_rhs_vector(T.PartitionedVector(
        "rhs", part, options=F, grid_shape=shape,
        device=DEV).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    return planner


def build_port(shape=SHAPE, compensated=False):
    planner = port_planner(shape, compensated)
    return planner, T.BiCGStabSolver(planner)


def assert_same_run(hist_t, x_t, hist_j, x_j, rtol=2e-3):
    np.testing.assert_allclose(np.asarray(hist_t), np.asarray(hist_j),
                               rtol=rtol)
    np.testing.assert_allclose(x_t, x_j, rtol=0,
                               atol=5e-3 * np.abs(x_j).max())


class GridLaplacian:
    """The 5-point negative Laplacian on ``shape`` as ``A @ v`` for flat
    float64 vectors."""

    def __init__(self, shape):
        self.shape = shape

    def __matmul__(self, v):
        return apply_np(v.reshape(self.shape)).reshape(-1)


@pytest.mark.parametrize("iters", [1, 5, 12])
def test_fused_solve_matches_jax_fused(iters):
    pj, sj = build_jax()
    pt, st = build_port()
    assert st._make_fused_runner(iters) is not None
    hist_j = np.asarray(sj.solve(iters), np.float64)
    hist_t = st.solve(iters).double().numpy()
    assert hist_t.shape == (iters + 1,)
    x_j = pj.sol_vectors[0].to_numpy()
    x_t = pt.sol_vectors[0].to_numpy()
    x64, h64 = reference_bicgstab(GridLaplacian(SHAPE),
                                  np.ones(int(np.prod(SHAPE))), iters)
    dev = lambda h: np.abs(h - h64) / h64
    window = dev(hist_j) <= 1e-3
    assert window[: min(iters, 7) + 1].all()
    np.testing.assert_allclose(hist_t[window], hist_j[window], rtol=2e-3)
    assert dev(hist_t).max() <= max(2 * dev(hist_j).max(), 2e-3)
    xdev = lambda x: np.abs(x - x64).max() / np.abs(x64).max()
    assert xdev(x_t) <= max(2 * xdev(x_j), 5e-3)
    if iters <= 5:
        assert_same_run(hist_t, x_t, hist_j, x_j)
        for name in ("rho", "alpha", "omega"):
            np.testing.assert_allclose(float(getattr(st, name)[-1].value),
                                       float(getattr(sj, name)[-1].value),
                                       rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("iters", [1, 5, 12])
def test_fused_solve_matches_transcription(iters, monkeypatch):
    pt, st = build_port()
    hist_f = st.solve(iters)
    monkeypatch.setenv("LEGIONSOLVERS_NO_FUSED_BICGSTAB", "1")
    p2, s2 = build_port()
    assert s2._make_fused_runner(iters) is None
    hist_r = s2.solve(iters)
    assert_same_run(hist_f, pt.sol_vectors[0].to_numpy(), hist_r,
                    p2.sol_vectors[0].to_numpy())


def test_fused_schedule_pass_counts(monkeypatch):
    """One pv, one st and one update call per iteration, and nothing else of
    K5 (LAUNCHES counts CUDA launches only, so the wrappers are counted)."""
    calls = {"bicg_pv": 0, "bicg_st": 0, "bicg_update": 0}
    for name in calls:
        real = getattr(TB, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(TB, name, counted)
    pt, st = build_port()
    st.solve(7)
    assert calls == {"bicg_pv": 7, "bicg_st": 7, "bicg_update": 7}
    monkeypatch.setenv("LEGIONSOLVERS_NO_FUSED_BICGSTAB", "1")
    p2, s2 = build_port()
    s2.solve(3)
    assert calls == {"bicg_pv": 7, "bicg_st": 7, "bicg_update": 7}


def test_fused_solve_keeps_b_and_repeats():
    """The runner writes x, r, p, v and its spares, never b (which R and
    R_TILDE share after __init__); the same solve from the same state gives
    the same bits."""
    pt, st = build_port()
    b = pt.rhs_vectors[0].data
    h1 = st.solve(6)
    x1 = pt.sol_vectors[0].data.clone()
    assert torch.equal(b, torch.ones_like(b))
    assert pt.get_vector(st.R_TILDE, 0).data is b
    pt.zero_fill(st.SOL)
    st.reset()
    h2 = st.solve(6)
    assert torch.equal(h1, h2)
    assert torch.equal(x1, pt.sol_vectors[0].data)


def test_fused_is_continuation():
    """step() twice then a fused solve continues the trajectory of five
    transcribed steps (test_23's check, rtol 5e-3)."""
    pt, st = build_port()
    st.step()
    st.step()
    h = st.solve(3)
    p2, s2 = build_port()
    h2 = [float(s2.residual_norm_squared().value)]
    for _ in range(5):
        s2.step()
        h2.append(float(s2.residual_norm_squared().value))
    np.testing.assert_allclose(np.asarray(h), h2[2:], rtol=5e-3)


def test_continues_jax_state():
    """A JAX trajectory (two transcribed steps) continued by the port's
    fused solve agrees with JAX's own fused continuation."""
    pj, sj = build_jax()
    sj.step()
    sj.step()
    get = lambda idx: np.asarray(pj.get_vector(idx, 0).data)
    state = {"x": get(sj.SOL), "r": get(sj.R), "p": get(sj.P),
             "v": get(sj.V)}
    for name in ("rho", "alpha", "omega"):
        state[name] = float(getattr(sj, name)[-1].value)
    pt = port_planner()
    st = convert.bicgstab_solver_from_state(pt, state)
    np.testing.assert_array_equal(pt.sol_vectors[0].to_numpy(),
                                  state["x"].reshape(-1))
    hist_t = st.solve(4)
    hist_j = np.asarray(sj.solve(4))
    assert_same_run(hist_t, pt.sol_vectors[0].to_numpy(), hist_j,
                    pj.sol_vectors[0].to_numpy(), rtol=5e-3)


def test_eager_steps_match_fused_solve():
    pt, st = build_port()
    hist = [float(st.residual_norm_squared().value)]
    for _ in range(6):
        st.step()
        hist.append(float(st.residual_norm_squared().value))
    p2, s2 = build_port()
    assert_same_run(hist, pt.sol_vectors[0].to_numpy(), s2.solve(6),
                    p2.sol_vectors[0].to_numpy())


# ---------------------------------------------------------------------------
# compensated dots
# ---------------------------------------------------------------------------

def test_compensated_fused_matches_plain():
    """At small n compensation changes the noise, not the recurrence
    (test_25's check, rtol 5e-3)."""
    _, s_plain = build_port((40, 128))
    _, s_comp = build_port((40, 128), compensated=True)
    np.testing.assert_allclose(s_comp.solve(8), s_plain.solve(8), rtol=5e-3)


@pytest.mark.parametrize("fused", [True, False])
def test_compensated_matches_jax(fused, monkeypatch):
    if not fused:
        monkeypatch.setenv("LEGIONSOLVERS_NO_FUSED_BICGSTAB", "1")
    pj, sj = build_jax((40, 128), compensated=True)
    pt, st = build_port((40, 128), compensated=True)
    assert (st._make_fused_runner(8) is not None) is fused
    assert_same_run(st.solve(8), pt.sol_vectors[0].to_numpy(),
                    np.asarray(sj.solve(8)), pj.sol_vectors[0].to_numpy())


# ---------------------------------------------------------------------------
# float64 on the 1-D ELL path (test_06)
# ---------------------------------------------------------------------------

def reference_bicgstab(A, b, its):
    """test_06's numpy transcription of the reference recurrence
    (BiCGStabSolver.hpp:64-82)."""
    x = np.zeros_like(b)
    r = b.copy()
    r_tilde = b.copy()
    p = np.zeros_like(b)
    v = np.zeros_like(b)
    rho, alpha, omega = 1.0, 0.0, 1.0
    hist = [r @ r]
    for _ in range(its):
        rho_new = r @ r_tilde
        beta = (rho_new / rho) * (alpha / omega)
        rho = rho_new
        p = r + beta * (p - omega * v)
        v = A @ p
        temp = r_tilde @ v
        r = r + (-1 * rho / temp) * v
        alpha = rho / temp
        u = A @ r
        omega = (r @ u) / (u @ u)
        x = x + alpha * p + omega * r
        r = r - omega * u
        hist.append(r @ r)
    return x, np.array(hist)


def build_1d(pkg, A, n, pieces, options):
    part = pkg.BlockPartition(n, pieces)
    kw = {"device": DEV} if pkg is T else {"mesh": None}
    planner = pkg.SquarePlanner(options=options, **kw)
    planner.add_sol_vector(
        pkg.PartitionedVector("sol", part, options=options, **kw).zero_fill())
    planner.add_rhs_vector(pkg.PartitionedVector.from_array(
        "rhs", np.ones(n), part, options=options, **kw))
    planner.add_row_partitioned_matrix(A, 0, 0)
    return planner


ASYM = [((0,), 2.5), ((-1,), -1.5), ((1,), -0.5)]


@pytest.mark.parametrize("pieces", [1, 4])
def test_bicgstab_matches_reference_recurrence(pieces):
    n = 64
    At = T.create_coo_stencil_matrix((n,), ASYM, options=F64T)
    Aj = J.create_coo_stencil_matrix((n,), ASYM, options=F64J)
    hist_t = T.BiCGStabSolver(build_1d(T, At, n, pieces, F64T)).solve(12)
    hist_j = np.asarray(
        J.BiCGStabSolver(build_1d(J, Aj, n, pieces, F64J)).solve(12))
    _, ref = reference_bicgstab(Aj.to_dense(), np.ones(n), 12)
    assert hist_t.dtype == torch.float64
    np.testing.assert_allclose(hist_t.numpy(), ref, rtol=1e-7)
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-7)


@pytest.mark.parametrize("pieces", [1, 4])
def test_bicgstab_solves_spd(pieces):
    n = 100
    A = T.coo_negative_laplacian_1d(n, options=F64T)
    planner = build_1d(T, A, n, pieces, F64T)
    hist = T.BiCGStabSolver(planner).solve(120)
    x = planner.sol_vectors[0].to_numpy()
    r = np.ones(n) - A.to_dense() @ x
    assert r @ r < 1e-16
    assert float(hist[-1]) < 1e-16


def test_bicgstab_eager_matches_loop():
    n = 40
    A = T.coo_negative_laplacian_1d(n, options=F64T)
    p1 = build_1d(T, A, n, 4, F64T)
    s1 = T.BiCGStabSolver(p1)
    for _ in range(5):
        s1.step()
    p2 = build_1d(T, A, n, 4, F64T)
    T.BiCGStabSolver(p2).solve(5)
    np.testing.assert_allclose(p1.sol_vectors[0].to_numpy(),
                               p2.sol_vectors[0].to_numpy(), rtol=1e-13)
