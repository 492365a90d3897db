"""Reordered-basis solves in the port (``parallel/reorder.py`` and the
planner's basis handling) against the JAX package: test_24's reorder cases
and test_26's basis-consistency cases.

The port's RCM is scipy's and the JAX package's a C++ BFS, so the two may
pick different permutations; Krylov histories do not depend on the basis,
so both are held to the same system solved without any upgrade, to rtol
1e-10 (f64), and the operator chains must agree.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.parallel.reorder import ReorderedOperator as JRO
from legionsolvers_tpu_torch.native.bindings import rcm_permutation
from legionsolvers_tpu_torch.parallel.reorder import (
    CrossBasisOperator,
    try_reordered_operator,
)

torch.set_num_threads(2)

DEV = "cpu"
F64 = T.SolverOptions(entry_dtype=torch.float64)
F64J = J.SolverOptions(entry_dtype=jnp.float64)
NO_UPGRADE = ("LEGIONSOLVERS_NO_RCM", "LEGIONSOLVERS_NO_DIA")


def _spd_banded(n, bw, avg, seed, shift=4.0):
    """SPD: B + B^T + diag(shift * avg), shift * avg > ||B + B^T||_inf."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n * avg)
    cols = rows + rng.integers(-bw, bw + 1, n * avg)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1.0, 1.0, len(rows))
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, shift * avg)])
    return r, c, v


def _chain(op):
    return [type(op).__name__] + (_chain(op.base) if hasattr(op, "base")
                                  else [])


def _planner(n, *coo, spaces=1, env=(), monkeypatch=None):
    part = T.BlockPartition(n, 1)
    planner = T.SquarePlanner(options=F64, device=DEV)
    for i in range(spaces):
        planner.add_sol_vector(T.PartitionedVector(f"s{i}", part,
                                                   options=F64, device=DEV))
        planner.add_rhs_vector(T.PartitionedVector(
            f"b{i}", part, options=F64, device=DEV).constant_fill(1.0))
    for k in env:
        monkeypatch.setenv(k, "1")
    for r, c, v in coo:
        planner.add_row_partitioned_matrix(
            T.COOMatrix(r, c, v, n, n, options=F64), 0, 0)
    for k in env:
        monkeypatch.delenv(k)
    return planner


def _jax_planner(n, r, c, v):
    part = J.BlockPartition(n, 1)
    pj = J.SquarePlanner(mesh=None, options=F64J)
    pj.add_sol_vector(J.PartitionedVector("s", part, options=F64J))
    pj.add_rhs_vector(J.PartitionedVector("b", part, options=F64J)
                      .constant_fill(1.0))
    pj.add_row_partitioned_matrix(J.COOMatrix(r, c, v, n, n, options=F64J),
                                  0, 0)
    return pj


def test_reordered_cg_matches_plain_and_jax(monkeypatch):
    """A scattered banded SPD system: the reorder gate fires (windowed ELL,
    as in JAX); history and x match the un-upgraded solve, and the history
    JAX's reordered solve."""
    n = 4096
    coo = _spd_banded(n, 160, 4, 7)
    pl = _planner(n, coo)
    op = pl.row_partitioned_matrices[0][0]
    pj = _jax_planner(n, *coo)
    assert _chain(op) == _chain(pj.row_partitioned_matrices[0][0])
    assert isinstance(op, T.ReorderedOperator)
    assert isinstance(op.base, (T.WinEllOperator, T.SlicedWinEllOperator))
    assert pl.basis_perm is not None
    hist = T.CGSolver(pl).solve(15).numpy()
    x = pl.sol_vectors[0].to_numpy()
    plain = _planner(n, coo, env=NO_UPGRADE, monkeypatch=monkeypatch)
    assert isinstance(plain.row_partitioned_matrices[0][0],
                      T.RowPartitionedMatrix)
    hist2 = T.CGSolver(plain).solve(15).numpy()
    np.testing.assert_allclose(hist, hist2, rtol=1e-10)
    np.testing.assert_allclose(x, plain.sol_vectors[0].to_numpy(),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(hist, np.asarray(J.CGSolver(pj).solve(15)),
                               rtol=1e-10)
    assert not pl._in_solver_basis
    np.testing.assert_array_equal(pl.rhs_vectors[0].to_numpy(), 1.0)


def test_reordered_permuted_laplacian_dia():
    """A scrambled 1-D Laplacian: RCM recovers the band, the permuted
    matrix passes the DIA gate, and the history is the unscrambled one's."""
    n = 2048
    L = T.coo_negative_laplacian_1d(n, options=F64)
    pr = np.random.default_rng(11).permutation(n)
    coo = (pr[L.rows], pr[L.cols], np.asarray(L.vals))
    pl = _planner(n, coo)
    op = pl.row_partitioned_matrices[0][0]
    assert isinstance(op, T.ReorderedOperator)
    assert isinstance(op.base, T.DiaOperator)
    assert _chain(op) == _chain(_jax_planner(n, *coo)
                                .row_partitioned_matrices[0][0])
    hist = T.CGSolver(pl).solve(15).numpy()
    plu = _planner(n, (L.rows, L.cols, np.asarray(L.vals)))
    histu = T.CGSolver(plu).solve(15).numpy()
    np.testing.assert_allclose(hist, histu, rtol=1e-10)
    xu = plu.sol_vectors[0].to_numpy()
    xu_perm = np.empty(n)
    xu_perm[pr] = xu
    np.testing.assert_allclose(pl.sol_vectors[0].to_numpy(), xu_perm,
                               rtol=1e-8, atol=1e-12)


def test_eager_step_out_of_basis_matches_jax():
    """step() outside solve() permutes on every call: one eager step equals
    the first solve step, and JAX's eager step."""
    n = 4096
    coo = _spd_banded(n, 160, 4, 13)
    pl = _planner(n, coo)
    s = T.CGSolver(pl)
    s.step()
    s.step()
    rr = [v.get_value() for v in s.residual_norm_squared]
    hist = T.CGSolver(_planner(n, coo)).solve(2).numpy()
    np.testing.assert_allclose(rr, hist, rtol=1e-10)
    sj = J.CGSolver(_jax_planner(n, *coo))
    sj.step()
    sj.step()
    np.testing.assert_allclose(
        rr, [float(v.value) for v in sj.residual_norm_squared], rtol=1e-10)


@pytest.mark.parametrize("switch,want", [
    ("LEGIONSOLVERS_NO_RCM", ["RowPartitionedMatrix"]),
    ("LEGIONSOLVERS_NO_SLICED_ELL", None),
    ("LEGIONSOLVERS_NO_GENSPMV", ["RowPartitionedMatrix"]),
])
def test_kill_switches(switch, want, monkeypatch):
    """NO_RCM keeps ELL on a reorderable matrix; NO_SLICED_ELL turns a
    graded band from the sliced plan to the uniform one; NO_GENSPMV keeps
    an RCM-resistant matrix on ELL."""
    if switch == "LEGIONSOLVERS_NO_SLICED_ELL":
        # a graded band in a forced identity basis (RCM would reorder it)
        rng = np.random.default_rng(3)
        n = 32768
        deg = (3 + 24 * (np.arange(n) / n)).astype(np.int64)
        r = np.repeat(np.arange(n), deg)
        c = r + rng.integers(-512, 513, len(r))
        keep = (c >= 0) & (c < n)
        m = T.COOMatrix(r[keep], c[keep], rng.uniform(-1, 1, keep.sum()), n,
                        n, options=F64)
        build = lambda: try_reordered_operator(
            m, T.BlockPartition(n, 1), F64, perm=np.arange(n), force=True,
            device=DEV)
        assert _chain(build()) == ["ReorderedOperator",
                                   "SlicedWinEllOperator"]
        monkeypatch.setenv(switch, "1")
        assert _chain(build()) == ["ReorderedOperator", "WinEllOperator"]
        return
    if switch == "LEGIONSOLVERS_NO_RCM":
        n, coo = 4096, _spd_banded(4096, 160, 4, 17)
    else:
        n = 65536
        rng = np.random.default_rng(11)
        coo = (rng.integers(0, n, 6 * n), rng.integers(0, n, 6 * n),
               rng.uniform(-1, 1, 6 * n))
    op = _planner(n, coo, env=(switch,), monkeypatch=monkeypatch)
    assert _chain(op.row_partitioned_matrices[0][0]) == want


def test_rcm_permutation_reduces_bandwidth():
    nx = 64
    n = nx * nx
    Y, X = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    rows_l, cols_l = [], []
    for dy, dx in [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]:
        m = (Y + dy >= 0) & (Y + dy < nx) & (X + dx >= 0) & (X + dx < nx)
        rows_l.append(Y[m] * nx + X[m])
        cols_l.append((Y[m] + dy) * nx + (X[m] + dx))
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    pr = np.random.default_rng(0).permutation(n)
    perm = rcm_permutation(n, pr[rows], pr[cols])
    assert sorted(perm) == list(range(n))
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    assert np.abs(iperm[pr[rows]] - iperm[pr[cols]]).max() <= 2 * nx


def test_forced_basis_falls_back_to_ell():
    """A forced permutation under which no fast kernel fits still gives a
    ReorderedOperator (over ELL), never an original-basis operator."""
    n = 1500
    rng = np.random.default_rng(5)
    r, c = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    m = T.COOMatrix(r, c, rng.uniform(-1, 1, 4 * n), n, n, options=F64)
    perm = rng.permutation(n)
    op = try_reordered_operator(m, T.BlockPartition(n, 1), F64, perm=perm,
                                force=True, device=DEV)
    assert isinstance(op, T.ReorderedOperator)
    np.testing.assert_array_equal(op.perm_np, perm)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               m.to_dense() @ x, rtol=1e-11, atol=1e-11)
    small = T.coo_negative_laplacian_1d(500, options=F64)
    assert try_reordered_operator(small, T.BlockPartition(500, 1), F64,
                                  device=DEV) is None  # n < 1024


# -- test_26: basis consistency ------------------------------------------------

def _scipy(r, c, v, n):
    return sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()


def test_second_matrix_forced_into_basis(monkeypatch):
    n = 4096
    A, B = _spd_banded(n, 160, 4, 7), _spd_banded(n, 200, 3, 8)
    pl = _planner(n, A, B)
    op_a, op_b = (t[0] for t in pl.row_partitioned_matrices)
    assert isinstance(op_a, T.ReorderedOperator)
    assert isinstance(op_b, T.ReorderedOperator)
    np.testing.assert_array_equal(op_a.perm_np, op_b.perm_np)
    hist = T.CGSolver(pl).solve(12).numpy()
    pl2 = _planner(n, A, B, env=NO_UPGRADE, monkeypatch=monkeypatch)
    np.testing.assert_allclose(hist, T.CGSolver(pl2).solve(12).numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(pl.sol_vectors[0].to_numpy(),
                               pl2.sol_vectors[0].to_numpy(), rtol=1e-8,
                               atol=1e-12)


def test_multispace_per_space_bases():
    """Two spaces, a reorderable matrix on each: a basis per space, and the
    block-diagonal history is twice the single-space one."""
    n = 4096
    A = _spd_banded(n, 160, 4, 21)
    part = T.BlockPartition(n, 1)
    pl = _planner(n, spaces=2)
    for i in range(2):
        pl.add_row_partitioned_matrix(T.COOMatrix(*A, n, n, options=F64),
                                      i, i)
    assert 0 in pl.basis_perms and 1 in pl.basis_perms
    hist = T.CGSolver(pl).solve(10).numpy()
    pl1 = _planner(n, A)
    hist1 = T.CGSolver(pl1).solve(10).numpy()
    np.testing.assert_allclose(hist, 2.0 * hist1, rtol=1e-10)
    x1 = pl1.sol_vectors[0].to_numpy()
    for i in range(2):
        np.testing.assert_allclose(pl.sol_vectors[i].to_numpy(), x1,
                                   rtol=1e-8, atol=1e-12)
        np.testing.assert_array_equal(pl.rhs_vectors[i].to_numpy(), 1.0)
    assert part == pl.canonical_partitions[1]


def test_cross_space_operator_joins_basis():
    n = 4096
    A = _spd_banded(n, 160, 4, 31)
    rng = np.random.default_rng(32)
    k = 3 * n
    C = (rng.integers(0, n, k), rng.integers(0, n, k), rng.uniform(-1, 1, k))
    pl = _planner(n, spaces=2)
    pl.add_row_partitioned_matrix(T.COOMatrix(*A, n, n, options=F64), 0, 0)
    assert 0 in pl.basis_perms
    pl.add_row_partitioned_matrix(T.COOMatrix(*C, n, n, options=F64), 1, 0)
    assert isinstance(pl.row_partitioned_matrices[1][0], CrossBasisOperator)
    x0, x1 = rng.standard_normal(n), rng.standard_normal(n)
    pl.sol_vectors[0].data = torch.from_numpy(x0.copy())
    pl.sol_vectors[1].data = torch.from_numpy(x1.copy())
    pl.allocate_workspace(1)
    expect = _scipy(*A, n) @ x0 + _scipy(*C, n) @ x1
    pl.matvec(2, 0)
    np.testing.assert_allclose(pl.get_vector(2, 0).to_numpy(), expect,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(pl.get_vector(2, 1).to_numpy(), 0.0)
    pl.to_solver_basis()
    pl.matvec(2, 0)
    pl.from_solver_basis()
    np.testing.assert_allclose(pl.get_vector(2, 0).to_numpy(), expect,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(pl.sol_vectors[0].to_numpy(), x0)


def test_add_operator_after_basis_raises():
    n = 4096
    pl = _planner(n, _spd_banded(n, 160, 4, 41))
    assert 0 in pl.basis_perms
    op = T.StencilOperator((64, 64), T.laplacian_stencil(2), options=F64,
                           device=DEV)
    with pytest.raises(ValueError, match="matrix-free"):
        pl.add_operator(op, 0, 0)


def test_lazy_vectors_stay_lazy_through_the_basis():
    n = 4096
    pl = _planner(n, _spd_banded(n, 160, 4, 43))
    pl.allocate_workspace(1)
    pl.to_solver_basis()
    assert pl.workspace_vectors[0][0]._data is None
    assert pl.sol_vectors[0]._data is not None
    pl.from_solver_basis()
    assert pl.workspace_vectors[0][0]._data is None


def test_jax_reorder_agrees_on_chains():
    """JAX's planner picks the same chain on the three test_24 systems."""
    n = 4096
    for coo in (_spd_banded(n, 160, 4, 7), _spd_banded(n, 200, 3, 8)):
        pj = _jax_planner(n, *coo)
        assert isinstance(pj.row_partitioned_matrices[0][0], JRO)
        assert _chain(_planner(n, coo).row_partitioned_matrices[0][0]) == \
            _chain(pj.row_partitioned_matrices[0][0])
