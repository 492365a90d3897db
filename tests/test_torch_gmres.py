"""The port's GMRES(m) against the JAX package.

test_07_gmres.py's systems (the 1-D Laplacian and an asymmetric 3-point
stencil as COO matrices, b = 1, x0 = 0) go through both packages in
float64.  The two run the same algorithm and differ only by the order of
their sums, so they are held together tightly: the Hessenberg matrix to
rtol 1e-10, restarted residual histories to rtol 1e-9.  The port's own
CGS2 runner is held to its MGS ``step()`` loop to rtol 1e-9 (test_07's
bound for the JAX pair).

The f32 case runs the 2-D 5-point Laplacian on a (32, 128) grid through
the kernel view: JAX's Pallas kernels in interpret mode, the port's plain
versions on CPU tensors.  Both are held to float64 GMRES of the same
system: f32 rounding, carried through ten orthogonalisations per cycle,
leaves each about 1e-5 from it over these cycles, and each is held to
1e-4, the two packages to 2e-4 of each other.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu_torch.utils import convert

torch.set_num_threads(2)

F64J = J.SolverOptions(entry_dtype=jnp.float64)
F64T = T.SolverOptions(entry_dtype=torch.float64)
DEV = "cpu"
F32_ENVELOPE = 1e-4


def lap1d(n):
    A = J.coo_negative_laplacian_1d(n, options=F64J)
    return np.asarray(A.rows), np.asarray(A.cols), np.asarray(A.vals)


def asym(n):
    A = J.create_coo_stencil_matrix(
        (n,), [((0,), 3.0), ((-1,), -2.0), ((1,), -0.5)], options=F64J)
    return np.asarray(A.rows), np.asarray(A.cols), np.asarray(A.vals)


def build_jax(coo, n, pieces=1):
    part = J.BlockPartition(n, pieces)
    planner = J.SquarePlanner(mesh=None, options=F64J)
    planner.add_sol_vector(J.PartitionedVector("sol", part,
                                               options=F64J).zero_fill())
    planner.add_rhs_vector(J.PartitionedVector.from_array(
        "rhs", np.ones(n), part, options=F64J))
    planner.add_row_partitioned_matrix(
        J.core.matrix.COOMatrix(*coo, n, n, options=F64J), 0, 0)
    return planner


def build_port(coo, n, pieces=1):
    part = T.BlockPartition(n, pieces)
    planner = T.SquarePlanner(options=F64T, device=DEV)
    planner.add_sol_vector(T.PartitionedVector("sol", part, options=F64T,
                                               device=DEV))
    planner.add_rhs_vector(T.PartitionedVector.from_array(
        "rhs", np.ones(n), part, options=F64T, device=DEV))
    planner.add_row_partitioned_matrix(
        T.COOMatrix(*coo, n, n, options=F64T), 0, 0)
    return planner


def dense(coo, n):
    A = np.zeros((n, n))
    np.add.at(A, (coo[0], coo[1]), coo[2])
    return A


def hessenberg(solver, m):
    return np.array([[float(solver.inner_products[i][j].value)
                      for j in range(m)] for i in range(m + 1)])


def test_gmres_exact_in_one_cycle():
    """GMRES(n) without restart is a direct method: one cycle solves the
    system (residual below 1e-18, test_07's bound), at JAX's x."""
    n = 24
    coo = lap1d(n)
    pt = build_port(coo, n)
    T.GMRESSolver(pt, restart=n).step()
    x = pt.sol_vectors[0].to_numpy()
    r = np.ones(n) - dense(coo, n) @ x
    assert r @ r < 1e-18
    pj = build_jax(coo, n)
    J.GMRESSolver(pj, restart=n).step()
    np.testing.assert_allclose(x, pj.sol_vectors[0].to_numpy(), rtol=1e-9)


def test_hessenberg_matches_jax_and_arnoldi_relation():
    """One MGS cycle: H against JAX's (rtol 1e-10; atol 1e-12 for the
    entries that are round-off, ~1e-15, of an O(1) matrix), upper
    Hessenberg with a positive subdiagonal, Ritz values inside A's spectrum, and A V_m =
    V_m H_m + w e_m^T on the port's own basis (the last slot holds the
    unnormalized w) to 1e-12."""
    n, m = 30, 6
    coo = lap1d(n)
    pt = build_port(coo, n)
    st = T.GMRESSolver(pt, restart=m)
    st.step()
    pj = build_jax(coo, n)
    sj = J.GMRESSolver(pj, restart=m)
    sj.step()
    H = hessenberg(st, m)
    np.testing.assert_allclose(H, hessenberg(sj, m), rtol=1e-10, atol=1e-12)
    for i in range(2, m + 1):
        assert np.all(H[i, : i - 1] == 0.0)
    assert all(H[j + 1, j] > 0 for j in range(m))
    ritz = np.linalg.eigvalsh((H[:m] + H[:m].T) / 2)
    w = np.linalg.eigvalsh(dense(coo, n))
    assert ritz.min() >= w.min() - 1e-8 and ritz.max() <= w.max() + 1e-8
    V = np.stack([pt.get_vector(st.krylov_basis(i), 0).to_numpy()
                  for i in range(m + 1)], axis=1)
    A = dense(coo, n)
    for j in range(m):
        lhs = A @ V[:, j]
        rhs = V[:, : j + 1] @ H[: j + 1, j]
        rhs = rhs + (V[:, m] if j == m - 1 else H[j + 1, j] * V[:, j + 1])
        np.testing.assert_allclose(lhs, rhs, atol=1e-12)


@pytest.mark.parametrize("pieces", [1, 4])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("system", ["restarted", "asymmetric"])
def test_histories_match_jax(system, fused, pieces):
    """test_07's restarted (1-D Laplacian, n = 64, GMRES(10) x 12) and
    asymmetric (n = 48, GMRES(8) x 10) solves: the history against JAX's
    on the same path (CGS2 runner or MGS steps) to rtol 1e-9, and ||b -
    Ax||^2 against the last entry.  The asymmetric solve reaches float64's
    attainable accuracy (||r||^2 ~ 1e-23 against 48): entries below 1e-18
    of the first are round-off and are held to that absolute bound."""
    if system == "restarted":
        n, m, cycles, coo = 64, 10, 12, lap1d(64)
    else:
        n, m, cycles, coo = 48, 8, 10, asym(48)
    pt = build_port(coo, n, pieces)
    ht = T.GMRESSolver(pt, restart=m).solve(cycles, fused=fused).numpy()
    pj = build_jax(coo, n, pieces)
    hj = np.asarray(J.GMRESSolver(pj, restart=m).solve(cycles,
                                                       use_jit=fused))
    np.testing.assert_allclose(ht, hj, rtol=1e-9, atol=1e-18 * hj[0])
    x = pt.sol_vectors[0].to_numpy()
    np.testing.assert_allclose(x, pj.sol_vectors[0].to_numpy(), rtol=1e-8,
                               atol=1e-12)
    r = np.ones(n) - dense(coo, n) @ x
    assert np.isclose(r @ r, ht[-1], rtol=1e-8, atol=1e-20)
    if system == "restarted":
        assert np.all(np.diff(ht) <= 1e-12) and ht[-1] < 0.1 * ht[0]
    else:
        assert r @ r < 1e-16


@pytest.mark.parametrize("pieces", [1, 4])
def test_cgs2_runner_matches_mgs_steps(pieces):
    """The port's CGS2 runner against its MGS step() loop (rtol 1e-9)."""
    n = 60
    coo = lap1d(n)
    p1 = build_port(coo, n, pieces)
    s1 = T.GMRESSolver(p1, restart=7)
    assert s1._make_fused_runner() is not None
    h_fused = s1.solve(6).numpy()
    p2 = build_port(coo, n, pieces)
    h_mgs = T.GMRESSolver(p2, restart=7).solve(6, fused=False).numpy()
    np.testing.assert_allclose(h_fused, h_mgs, rtol=1e-9)
    np.testing.assert_allclose(p1.sol_vectors[0].to_numpy(),
                               p2.sol_vectors[0].to_numpy(), rtol=1e-8)


def test_reconciled_state_after_solve():
    """After solve() the CGS2 path leaves the MGS path's observable state:
    basis slots hold the final cycle's basis, inner_products its
    Hessenberg, slot 0 the closing residual; the last slot is normalized
    on the CGS2 path only.  Both are held to JAX's CGS2 state too."""
    n, m = 60, 5
    coo = lap1d(n)
    p1 = build_port(coo, n)
    s1 = T.GMRESSolver(p1, restart=m)
    s1.solve(3)
    p2 = build_port(coo, n)
    s2 = T.GMRESSolver(p2, restart=m)
    s2.solve(3, fused=False)
    pj = build_jax(coo, n)
    sj = J.GMRESSolver(pj, restart=m)
    sj.solve(3)
    H1, H2, Hj = hessenberg(s1, m), hessenberg(s2, m), hessenberg(sj, m)
    np.testing.assert_allclose(H1, H2, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(H1, Hj, rtol=1e-10, atol=1e-12)
    for i in range(m):
        v1 = p1.get_vector(s1.krylov_basis(i), 0).to_numpy()
        v2 = p2.get_vector(s2.krylov_basis(i), 0).to_numpy()
        vj = np.asarray(pj.get_vector(sj.krylov_basis(i), 0).data)[:n]
        np.testing.assert_allclose(v1, v2, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(v1, vj, rtol=1e-9, atol=1e-12)
    v1 = p1.get_vector(s1.krylov_basis(m), 0).to_numpy()
    v2 = p2.get_vector(s2.krylov_basis(m), 0).to_numpy()
    np.testing.assert_allclose(np.linalg.norm(v1), 1.0, rtol=1e-6)
    np.testing.assert_allclose(v1 * np.linalg.norm(v2), v2, rtol=1e-6,
                               atol=1e-10)


def test_solve_continued_from_jax_state():
    """Three JAX cycles, then three more in each package from the JAX
    state (``convert.gmres_solver_from_state``): histories rtol 1e-9."""
    n, m = 64, 6
    coo = lap1d(n)
    pj = build_jax(coo, n)
    sj = J.GMRESSolver(pj, restart=m)
    sj.solve(3)
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k in ("sol", "rhs")}
    pt = build_port(coo, n)
    st = convert.gmres_solver_from_state(pt, state, m)
    ht = st.solve(3).numpy()
    hj = np.asarray(sj.solve(3))
    np.testing.assert_allclose(ht, hj, rtol=1e-9)


def _stencil_jax(shape, options):
    n = int(np.prod(shape))
    part = J.BlockPartition(n, 1)
    op = J.StencilOperator(shape, J.laplacian_stencil(2), partition=part,
                           mesh=None, options=options)
    planner = J.SquarePlanner(mesh=None, options=options)
    gs = shape if op.uses_pallas else None
    planner.add_sol_vector(J.PartitionedVector(
        "sol", part, options=options, grid_shape=gs).zero_fill())
    planner.add_rhs_vector(J.PartitionedVector(
        "rhs", part, options=options, grid_shape=gs).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    return planner, op


def test_f32_stencil_on_the_kernel_view():
    """GMRES(10) x 4 on the 2-D 5-point Laplacian at (32, 128), f32, on
    the kernel view (JAX: Pallas interpret mode; the port: the plain
    versions), each held to float64 GMRES within F32_ENVELOPE and to each
    other within twice that."""
    from legionsolvers_tpu_torch.entry import build_stencil_system

    shape, m, cycles = (32, 128), 10, 4
    pt = build_stencil_system(2, shape, T.SolverOptions(
        entry_dtype=torch.float32), device=DEV)
    assert pt.row_partitioned_matrices[0][0].uses_pallas
    ht = T.GMRESSolver(pt, restart=m).solve(cycles).double().numpy()
    pj, op = _stencil_jax(shape, J.SolverOptions(entry_dtype=jnp.float32))
    assert op.uses_pallas
    hj = np.asarray(J.GMRESSolver(pj, restart=m).solve(cycles),
                    dtype=np.float64)
    p64 = build_stencil_system(2, shape, F64T, device=DEV)
    h64 = T.GMRESSolver(p64, restart=m).solve(cycles).numpy()
    dev_t = np.max(np.abs(ht - h64) / h64)
    dev_j = np.max(np.abs(hj - h64) / h64)
    assert dev_t <= F32_ENVELOPE and dev_j <= F32_ENVELOPE, (dev_t, dev_j)
    np.testing.assert_allclose(ht, hj, rtol=2 * F32_ENVELOPE)
    xt = pt.sol_vectors[0].to_numpy()
    xj = np.asarray(pj.sol_vectors[0].data).reshape(-1)
    np.testing.assert_allclose(xt, xj, atol=2 * F32_ENVELOPE * np.abs(xj).max())


@pytest.mark.parametrize("setup", [
    "pass", "m.allow_tf32 = True", "m.allow_tf32 = False",
    "m.fp32_precision = 'tf32'",
    "torch.set_float32_matmul_precision('high')"])
def test_full_f32_guard_restores_the_callers_setting(setup):
    """Inside ``full_f32_matmul`` cuBLAS's TF32 flag reads off; afterwards
    the caller's setting reads back through both of torch's switches
    (torch raises on a state mixed by the two; run in a fresh process so
    that no other test sees the flags)."""
    code = f"""
import torch
from legionsolvers_tpu_torch.solvers.gmres import full_f32_matmul
m = torch.backends.cuda.matmul
{setup}
before = m.fp32_precision if hasattr(m, "fp32_precision") else m.allow_tf32
with full_f32_matmul():
    assert m.allow_tf32 is False
after = m.fp32_precision if hasattr(m, "fp32_precision") else m.allow_tf32
assert after == before, (before, after)
assert m.allow_tf32 == (before in ("tf32", True)), m.allow_tf32
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.stdout.strip() == "ok", out.stderr
