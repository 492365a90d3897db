"""The port's explicit-sparse slice end to end: ``entry.build_explicit_system``
on small forms of the three systems ``chip_smoke.py`` drives at full size,
against the JAX package.

* the 2-D 5-point Laplacian (DIA, K8), at (64, 128);
* the same Laplacian with rows and columns scrambled by
  ``default_rng(0).permutation`` (an RCM basis, then windowed ELL or DIA),
  at 64 x 64;
* a random SPD matrix, 4 entries per row symmetrized plus a diagonal of 16
  (the routed gather in the degree-sorted basis), at n = 2^16.

Tolerances: f64 histories rtol 1e-10 (the same recurrence in another
basis or summation order).  The f32 (64, 128) solve: textbook f32 CG
itself leaves float64 CG by ``drift`` over these 40 iterations (measured
here, ~1e-5), so the port is held to JAX and to float64 CG within twice
that, with a floor of 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TS
from legionsolvers_tpu_torch.utils import convert

torch.set_num_threads(2)

DEV = "cpu"
F64 = T.SolverOptions(entry_dtype=torch.float64)
F32 = T.SolverOptions(entry_dtype=torch.float32)
F64J = J.SolverOptions(entry_dtype=jnp.float64)
F32J = J.SolverOptions(entry_dtype=jnp.float32)
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]


def laplacian(shape):
    a = T.create_coo_stencil_matrix(shape, T.laplacian_stencil(2))
    return a.rows, a.cols, np.asarray(a.vals), a.n_range


def scrambled(nx):
    rows, cols, vals, n = laplacian((nx, nx))
    pr = np.random.default_rng(0).permutation(n)
    return pr[rows], pr[cols], vals, n


def random_spd(n, avg=4, seed=1):
    rng = np.random.default_rng(seed)
    m = n * avg
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    vals = rng.uniform(-1, 1, m)
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, 4.0 * avg)])
    return r, c, v, n


SYSTEMS = {
    "dia": (lambda: laplacian((64, 128)),
            ["DiaOperator"]),
    "scrambled": (lambda: scrambled(64),
                  None),  # whatever JAX's planner picks
    "random": (lambda: random_spd(1 << 16),
               ["ReorderedOperator", "GeneralSpmvOperator"]),
}


def _chain(op):
    return [type(op).__name__] + (_chain(op.base) if hasattr(op, "base")
                                  else [])


def port_system(coo, options=F64, **kw):
    rows, cols, vals, n = coo
    A = T.COOMatrix(rows, cols, vals, n, n, options=options)
    return T.build_explicit_system(A, options, device=DEV, **kw)


def jax_system(coo, options=F64J):
    rows, cols, vals, n = coo
    part = J.BlockPartition(n, 1)
    pj = J.SquarePlanner(mesh=None, options=options)
    pj.add_sol_vector(J.PartitionedVector("sol", part, options=options)
                      .zero_fill())
    pj.add_rhs_vector(J.PartitionedVector("rhs", part, options=options)
                      .constant_fill(1.0))
    pj.add_row_partitioned_matrix(
        J.COOMatrix(rows, cols, vals, n, n, options=options), 0, 0)
    return pj


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_routes_like_jax(name):
    """build_explicit_system picks the operator chain JAX's planner picks
    on the same matrix, f32 as on the card."""
    make, want = SYSTEMS[name]
    coo = make()
    pl = port_system(coo, F32)
    op = pl.row_partitioned_matrices[0][0]
    opj = jax_system(coo, F32J).row_partitioned_matrices[0][0]
    assert _chain(op) == _chain(opj)
    if want is not None:
        assert _chain(op) == want
    if name == "dia":
        assert op.uses_pallas and op._view["C"] == opj._view["C"] == 1024
        assert op._view["offs"] == opj._view["offs"]
    if name == "random":
        assert op.base._plan == opj.base._plan
        np.testing.assert_array_equal(op.perm_np, opj.perm_np)
    assert pl.sol_vectors[0]._data is None  # x0 = 0, lazy
    np.testing.assert_array_equal(pl.rhs_vectors[0].to_numpy(), 1.0)


def test_prefer_dia_false_keeps_ell():
    pl = port_system(laplacian((16, 16)), prefer_dia=False)
    assert _chain(pl.row_partitioned_matrices[0][0]) == [
        "RowPartitionedMatrix"]


def test_golden_through_build_explicit_system():
    pl = port_system((*(lambda a: (a.rows, a.cols, np.asarray(a.vals)))(
        T.coo_negative_laplacian_1d(100)), 100))
    assert isinstance(pl.row_partitioned_matrices[0][0], T.DiaOperator)
    assert T.CGSolver(pl).solve(10).tolist() == GOLDEN


def _classic_cg(A, iters, dtype):
    """Textbook CG on the scipy matrix A, b = 1, in numpy ``dtype``."""
    A = A.astype(dtype)
    b = np.ones(A.shape[0], dtype)
    x, r, p = np.zeros_like(b), b.copy(), b.copy()
    rr = r @ r
    hist = [rr]
    for _ in range(iters):
        q = A @ p
        a = rr / (p @ q)
        x = x + a * p
        r = r - a * q
        rr_new = r @ r
        hist.append(rr_new)
        p = r + (rr_new / rr) * p
        rr = rr_new
    return np.array(hist, np.float64), x.astype(np.float64)


def test_f32_dia_slice_matches_jax():
    """The f32 (64, 128) solve on K8's plain version against JAX's
    interpret-mode kernel, and both against float64 CG, within twice
    textbook f32's own drift."""
    coo = laplacian((64, 128))
    A = sp.coo_matrix((coo[2], (coo[0], coo[1])), shape=(coo[3],) * 2)
    A = A.tocsr()
    h64, x64 = _classic_cg(A, 40, np.float64)
    h32, _ = _classic_cg(A, 40, np.float32)
    drift = np.max(np.abs(h32 - h64) / h64)
    bound = max(2 * drift, 1e-5)
    pl = port_system(coo, F32)
    hist = T.CGSolver(pl).solve(40).double().numpy()
    hist_j = np.asarray(J.CGSolver(jax_system(coo, F32J)).solve(40),
                        np.float64)
    assert np.max(np.abs(hist - hist_j) / hist_j) <= bound
    assert np.max(np.abs(hist - h64) / h64) <= bound
    x = pl.sol_vectors[0].to_numpy().astype(np.float64)
    assert np.max(np.abs(x - x64)) <= bound * np.abs(x64).max()
    assert sum(TS.LAUNCHES.values()) == 0


def test_scrambled_history_is_the_laplacians():
    """b = 1 is unchanged by any permutation, so the scrambled system's CG
    history is the 2-D Laplacian's (the check chip_smoke.py makes at
    2048^2)."""
    hist = T.CGSolver(port_system(scrambled(64))).solve(30).numpy()
    ref = T.CGSolver(port_system(laplacian((64, 64)))).solve(30).numpy()
    np.testing.assert_allclose(hist, ref, rtol=1e-10)


def test_state_continues_from_jax_in_its_basis():
    """JAX takes three eager steps on the scrambled system; convert carries
    its COO arrays, vectors, history and basis into the port, whose planner
    adopts that basis, and the two solves continue together."""
    coo = scrambled(64)
    pj = jax_system(coo)
    sj = J.CGSolver(pj)
    for _ in range(3):
        sj.step()
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k != "ops"}
    rr = [float(s.value) for s in sj.residual_norm_squared]
    perm = pj.basis_perms[0]["perm_np"]
    pl, st = convert.explicit_cg_system(*coo, state, rr, options=F64,
                                        device=DEV, perm=perm)
    op = pl.row_partitioned_matrices[0][0]
    opj = pj.row_partitioned_matrices[0][0]
    assert _chain(op) == _chain(opj)
    np.testing.assert_array_equal(op.perm_np, perm)
    np.testing.assert_array_equal(pl.basis_perm["perm_np"], perm)
    hist = st.solve(12).numpy()
    hist_j = np.asarray(sj.solve(12))
    np.testing.assert_allclose(hist, hist_j, rtol=1e-10)
    np.testing.assert_allclose(pl.sol_vectors[0].to_numpy(),
                               np.asarray(pj.get_vector(0, 0).data)[:coo[3]],
                               rtol=1e-9, atol=1e-12)


def test_state_without_basis_lets_the_port_choose():
    coo = scrambled(64)
    pj = jax_system(coo)
    sj = J.CGSolver(pj)
    sj.step()
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k != "ops"}
    rr = [float(s.value) for s in sj.residual_norm_squared]
    _, st = convert.explicit_cg_system(*coo, state, rr, options=F64,
                                       device=DEV)
    np.testing.assert_allclose(st.solve(6).numpy(), np.asarray(sj.solve(6)),
                               rtol=1e-10)


def _textbook_bicgstab(A, iters):
    b = np.ones(A.shape[0])
    x, r, rt = np.zeros_like(b), b.copy(), b.copy()
    p, v = np.zeros_like(b), np.zeros_like(b)
    rho, alpha, omega = 1.0, 0.0, 1.0
    hist = [r @ r]
    for _ in range(iters):
        rho_new = r @ rt
        beta = (rho_new / rho) * (alpha / omega)
        rho = rho_new
        p = r + beta * (p - omega * v)
        v = A @ p
        alpha = rho / (rt @ v)
        s = r - alpha * v
        t = A @ s
        omega = (t @ s) / (t @ t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        hist.append(r @ r)
    return np.array(hist), x


def test_bicgstab_on_random_spd_in_its_basis():
    """BiCGStab on the routed-gather system, inside the degree-sorted
    basis, against a float64 textbook BiCGStab on scipy's matrix."""
    coo = random_spd(1 << 16)
    pl = port_system(coo)
    assert _chain(pl.row_partitioned_matrices[0][0]) == [
        "ReorderedOperator", "GeneralSpmvOperator"]
    hist = T.BiCGStabSolver(pl).solve(8).numpy()
    A = sp.coo_matrix((coo[2], (coo[0], coo[1])), shape=(coo[3],) * 2)
    ref, xref = _textbook_bicgstab(A.tocsr(), 8)
    np.testing.assert_allclose(hist, ref, rtol=1e-10)
    np.testing.assert_allclose(pl.sol_vectors[0].to_numpy(), xref,
                               rtol=1e-9, atol=1e-12)
    assert not pl._in_solver_basis
