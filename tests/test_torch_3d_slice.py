"""The port's 3-D stencil path against the JAX package, end to end.

The benchmark's 3-D systems (``-dim 3``: 7-point, ``-dim 4``: 27-point
negative Laplacian, f32, b = 1, x0 = 0) on a (8, 16, 128) grid, built by
``entry.build_stencil_system`` and by the JAX package's
``benchmark.build_planner`` (one piece), go through both packages'
solvers.  JAX runs its fused 3-D runners on Pallas kernels in interpret
mode; the port runs its fused runners on the plain versions its K6/K7
wrappers take on CPU tensors.

Tolerances.  CG: both packages run the same two-pass schedule, so they
differ only by f32 rounding in another order: history rtol 1e-4, x atol
1e-4 * max|x| (test_torch_cg_slice.py's two-pass bounds).  BiCGStab:
history rtol 3e-3, x atol 5e-3 * max|x| (test_23's 3-D bounds, fused
against the transcription).  float64 runs the linearized path in both
packages: rtol 1e-12.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.benchmark import build_planner
from legionsolvers_tpu_torch.entry import build_stencil_system
from legionsolvers_tpu_torch.ops.cuda import bicgstab3d as TB3
from legionsolvers_tpu_torch.ops.cuda import stencil3d as T3
from legionsolvers_tpu_torch.utils import convert

torch.set_num_threads(2)

DEV = "cpu"
SHAPE = (8, 16, 128)
DIMS = [3, 4]
F32J = J.SolverOptions(entry_dtype=jnp.float32)
F32T = T.SolverOptions(entry_dtype=torch.float32)


def build_jax(dim, shape=SHAPE, options=F32J):
    args = types.SimpleNamespace(dim=dim, nx=shape[0], ny=shape[1],
                                 nz=shape[2], vp=1, block=False)
    return build_planner(args, None, options)[0]


def build_port(dim, shape=SHAPE, options=F32T):
    return build_stencil_system(dim, shape, options, device=DEV)


def assert_same_run(hist_t, x_t, hist_j, x_j, hist_rtol, x_atol):
    np.testing.assert_allclose(np.asarray(hist_t), np.asarray(hist_j),
                               rtol=hist_rtol)
    np.testing.assert_allclose(x_t, x_j, rtol=0,
                               atol=x_atol * np.abs(x_j).max())


def assert_cg_run(*a):
    assert_same_run(*a, 1e-4, 1e-4)


def assert_bicg_run(*a):
    assert_same_run(*a, 3e-3, 5e-3)


@pytest.mark.parametrize("dim", DIMS)
def test_build_stencil_system_matches_build_planner(dim):
    pj, pt = build_jax(dim), build_port(dim)
    opj = pj.row_partitioned_matrices[0][0]
    opt = pt.row_partitioned_matrices[0][0]
    assert opt.uses_pallas and opj.uses_pallas
    assert opt._view["kind"] == opj._view["kind"] == "3d"
    assert opt._view["offs3"] == opj._view["offs3"]
    assert opt._view["vals"] == opj._view["vals"]
    assert pt.rhs_vectors[0].grid_shape == pj.rhs_vectors[0].grid_shape
    np.testing.assert_array_equal(pt.rhs_vectors[0].to_numpy(),
                                  pj.rhs_vectors[0].to_numpy())
    np.testing.assert_array_equal(pt.sol_vectors[0].to_numpy(),
                                  pj.sol_vectors[0].to_numpy())


def test_build_stencil_system_other_dims():
    """-dim 1 and 2 as the benchmark builds them; a grid of the wrong rank
    is refused."""
    assert not build_stencil_system(1, (64,), F32T, DEV) \
        .row_partitioned_matrices[0][0].uses_pallas
    assert build_stencil_system(2, (8, 16), F32T, DEV) \
        .rhs_vectors[0].grid_shape == (8, 16)
    with pytest.raises(ValueError, match="3-D grid"):
        build_stencil_system(4, (8, 16), F32T, DEV)


@pytest.mark.parametrize("dim", DIMS)
def test_cg_solve_matches_jax(dim):
    pj, pt = build_jax(dim), build_port(dim)
    hist_j = np.asarray(J.CGSolver(pj).solve(10))
    hist_t = T.CGSolver(pt).solve(10)
    assert hist_t.shape == (11,)
    assert_cg_run(hist_t.numpy(), pt.sol_vectors[0].to_numpy(), hist_j,
                  pj.sol_vectors[0].to_numpy())
    assert (pt.rhs_vectors[0].to_numpy() == 1.0).all()


@pytest.mark.parametrize("dim", DIMS)
def test_cg_eager_steps_match_jax(dim):
    """step() goes through matvec_dot, i.e. the K6a y_dot pass.  The first
    iterations amplify f32 rounding on this system: JAX's f32 history is up
    to 4.8e-5 off a float64 run after three steps, the port's 2e-6.  So the
    port is held to float64 at 1e-5 and to JAX at 1e-4."""
    F64T = T.SolverOptions(entry_dtype=torch.float64)
    solvers = (J.CGSolver(build_jax(dim)), T.CGSolver(build_port(dim)),
               T.CGSolver(build_port(dim, options=F64T)))
    for _ in range(3):
        for s in solvers:
            s.step()
    hj, ht, h64 = ([float(s.value) for s in sv.residual_norm_squared]
                   for sv in solvers)
    np.testing.assert_allclose(ht, h64, rtol=1e-5)
    np.testing.assert_allclose(ht, hj, rtol=1e-4)


@pytest.mark.parametrize("dim", DIMS)
def test_bicgstab_solve_matches_jax(dim):
    """The residual^2 of the 27-point system falls 1e5-fold in 8
    iterations, and its last entries are f32 rounding: JAX's own f32
    history leaves a float64 run by 4e-3 there.  So, as in
    test_torch_bicgstab_slice.py, the port is held to JAX at 3e-3 on the
    entries where JAX stays within 1e-3 of float64, and over all entries to
    no more than twice JAX's distance from float64 (a float64 run of the
    port's step() transcription)."""
    pj, pt = build_jax(dim), build_port(dim)
    st = T.BiCGStabSolver(pt)
    assert st._make_fused_runner(8) is not None
    hist_j = np.asarray(J.BiCGStabSolver(pj).solve(8), np.float64)
    hist_t = st.solve(8).double().numpy()
    p64 = build_port(dim, options=T.SolverOptions(entry_dtype=torch.float64))
    h64 = T.BiCGStabSolver(p64).solve(8).numpy()
    x_t, x_j, x64 = (p.sol_vectors[0].to_numpy() for p in (pt, pj, p64))
    dev = lambda h: np.abs(h - h64) / h64
    window = dev(hist_j) <= 1e-3
    assert window[:6].all()
    np.testing.assert_allclose(hist_t[window], hist_j[window], rtol=3e-3)
    assert dev(hist_t).max() <= max(2 * dev(hist_j).max(), 3e-3)
    xdev = lambda x: np.abs(x - x64).max() / np.abs(x64).max()
    assert xdev(x_t) <= max(2 * xdev(x_j), 5e-3)


@pytest.mark.parametrize("dim", DIMS)
def test_bicgstab_fused_matches_transcription(dim, monkeypatch):
    """test_23's 3-D check: the fused solve against the port's own step()
    transcription (LEGIONSOLVERS_NO_FUSED_BICGSTAB)."""
    pt = build_port(dim)
    hist_f = T.BiCGStabSolver(pt).solve(8)
    monkeypatch.setenv("LEGIONSOLVERS_NO_FUSED_BICGSTAB", "1")
    p2 = build_port(dim)
    s2 = T.BiCGStabSolver(p2)
    assert s2._make_fused_runner(8) is None
    assert_bicg_run(hist_f.numpy(), pt.sol_vectors[0].to_numpy(),
                    s2.solve(8).numpy(), p2.sol_vectors[0].to_numpy())


class _Count:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


def _count(monkeypatch, module, names):
    counts = {name: _Count(getattr(module, name)) for name in names}
    for name, c in counts.items():
        monkeypatch.setattr(module, name, c)
    return counts


def test_pass_counts(monkeypatch):
    """CG solve(10): one pq, ten update and nine xpay_pq passes; BiCGStab
    solve(7): seven of each K7 pass; eager steps take K6a y and y_dot."""
    cg = _count(monkeypatch, T3, ("grid3d_cg_pq", "grid3d_cg_update",
                                  "grid3d_cg_xpay_pq",
                                  "grid3d_stencil_matvec"))
    bicg = _count(monkeypatch, TB3, ("bicg3d_pv", "bicg3d_st",
                                     "bicg3d_update"))
    T.CGSolver(build_port(3)).solve(10)
    assert [c.calls for c in cg.values()] == [1, 10, 9, 0]
    s = T.BiCGStabSolver(build_port(4))
    s.solve(7)
    assert [c.calls for c in bicg.values()] == [7, 7, 7]
    s.step()
    assert cg["grid3d_stencil_matvec"].calls == 2  # y (v = A p), y_dot
    assert [c.calls for c in bicg.values()] == [7, 7, 7]


@pytest.mark.parametrize("dim", DIMS)
def test_cg_continues_jax_state(dim):
    """JAX runs two step()s; convert.py carries its 3-D state into the
    port; both then run solve(4) from the same state."""
    pj = build_jax(dim)
    sj = J.CGSolver(pj)
    sj.step()
    sj.step()
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k != "ops"}
    rr = [float(s.value) for s in sj.residual_norm_squared]
    pt, st = convert.stencil_cg_system(SHAPE, T.laplacian_stencil(dim),
                                       state, rr[-1:], options=F32T,
                                       device=DEV)
    assert pt.rhs_vectors[0].grid_shape == SHAPE
    hist_t = st.solve(4)
    assert hist_t[0].item() == np.float32(rr[-1])
    assert_cg_run(hist_t.numpy(), pt.sol_vectors[0].to_numpy(),
                  np.asarray(sj.solve(4)), pj.sol_vectors[0].to_numpy())


def test_bicgstab_continues_jax_state():
    """A JAX 3-D BiCGStab trajectory (two transcribed steps) continued by
    the port's fused solve agrees with JAX's own fused continuation."""
    pj = build_jax(4)
    sj = J.BiCGStabSolver(pj)
    sj.step()
    sj.step()
    get = lambda idx: np.asarray(pj.get_vector(idx, 0).data)
    state = {"x": get(sj.SOL), "r": get(sj.R), "p": get(sj.P),
             "v": get(sj.V)}
    for name in ("rho", "alpha", "omega"):
        state[name] = float(getattr(sj, name)[-1].value)
    pt = build_port(4)
    st = convert.bicgstab_solver_from_state(pt, state)
    assert pt.sol_vectors[0].data.shape == SHAPE
    assert_bicg_run(st.solve(4).numpy(), pt.sol_vectors[0].to_numpy(),
                    np.asarray(sj.solve(4)), pj.sol_vectors[0].to_numpy())


@pytest.mark.parametrize("dim", DIMS)
def test_fp64_linearized_matches_jax(dim):
    """float64 has no kernel view in either package: CG runs the recompute
    runner and BiCGStab the step() loop over the linearized matvec."""
    shape = (6, 7, 9)
    F64J = J.SolverOptions(entry_dtype=jnp.float64)
    F64T = T.SolverOptions(entry_dtype=torch.float64)
    pj, pt = build_jax(dim, shape, F64J), build_port(dim, shape, F64T)
    assert not pt.row_partitioned_matrices[0][0].uses_pallas
    hist_j = np.asarray(J.CGSolver(pj).solve(15))
    hist_t = T.CGSolver(pt).solve(15).numpy()
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-12)
    np.testing.assert_allclose(pt.sol_vectors[0].to_numpy(),
                               pj.sol_vectors[0].to_numpy(), rtol=1e-12)
    pj, pt = build_jax(dim, shape, F64J), build_port(dim, shape, F64T)
    hist_j = np.asarray(J.BiCGStabSolver(pj).solve(10))
    hist_t = T.BiCGStabSolver(pt).solve(10).numpy()
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-10)
