"""The port's PCG and Jacobi preconditioner against the JAX package.

Systems of test_12_pcg.py (an SPD matrix D + tridiag(-1, 0, -1) with a
diagonal varying over [3, 100]) and test_26_basis_consistency.py (a
scattered banded SPD matrix that the planner reorders by RCM) go through
both packages in float64.  The packages run the same recurrence and differ
only in the order of their sums: histories are held together to rtol 1e-9
(test_26's bound between two bases of one system), x to 1e-8.
"""

import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.core.matrix import COOMatrix as JCOO
from legionsolvers_tpu.solvers.pcg import (
    JacobiPreconditioner as JJacobi,
    PCGSolver as JPCG,
)
from legionsolvers_tpu_torch.parallel.reorder import ReorderedOperator
from legionsolvers_tpu_torch.utils import convert

torch.set_num_threads(2)

F64J = J.SolverOptions(entry_dtype=jnp.float64)
F64T = T.SolverOptions(entry_dtype=torch.float64)
DEV = "cpu"


def variable_diag(n):
    """test_12's system: D + tridiag(-1, 0, -1), D uniform in [3, 100]."""
    rng = np.random.default_rng(7)
    d = rng.uniform(3.0, 100.0, n)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([d, -np.ones(n - 1), -np.ones(n - 1)])
    return rows, cols, vals


def spd_banded(n, bw, avg, seed, shift_scale=4.0):
    """test_26's system: B + B^T + diag(shift), shift > ||B + B^T||_inf."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n * avg)
    cols = rows + rng.integers(-bw, bw + 1, n * avg)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1.0, 1.0, len(rows))
    return (np.concatenate([rows, cols, np.arange(n)]),
            np.concatenate([cols, rows, np.arange(n)]),
            np.concatenate([vals, vals, np.full(n, shift_scale * avg)]))


def bumped(n, seed):
    """test_26:219's system: the banded SPD matrix plus (i mod 7) on the
    diagonal, so that Jacobi changes the iteration."""
    r, c, v = spd_banded(n, bw=160, avg=4, seed=seed)
    return (np.concatenate([r, np.arange(n)]),
            np.concatenate([c, np.arange(n)]),
            np.concatenate([v, (np.arange(n) % 7).astype(float)]))


class no_reorder:
    """LEGIONSOLVERS_NO_RCM and _NO_DIA set within the block."""

    def __enter__(self):
        os.environ["LEGIONSOLVERS_NO_RCM"] = "1"
        os.environ["LEGIONSOLVERS_NO_DIA"] = "1"

    def __exit__(self, *exc):
        del os.environ["LEGIONSOLVERS_NO_RCM"]
        del os.environ["LEGIONSOLVERS_NO_DIA"]


def build_port(coo, n, pieces=1):
    part = T.BlockPartition(n, pieces)
    planner = T.SquarePlanner(options=F64T, device=DEV)
    planner.add_sol_vector(T.PartitionedVector("sol", part, options=F64T,
                                               device=DEV))
    planner.add_rhs_vector(T.PartitionedVector(
        "rhs", part, options=F64T, device=DEV).constant_fill(1.0))
    planner.add_row_partitioned_matrix(T.COOMatrix(*coo, n, n, options=F64T),
                                       0, 0)
    return planner


def build_jax(coo, n, pieces=1):
    part = J.BlockPartition(n, pieces)
    planner = J.SquarePlanner(mesh=None, options=F64J)
    planner.add_sol_vector(J.PartitionedVector("sol", part,
                                               options=F64J).zero_fill())
    planner.add_rhs_vector(J.PartitionedVector(
        "rhs", part, options=F64J).constant_fill(1.0))
    planner.add_row_partitioned_matrix(JCOO(*coo, n, n, options=F64J), 0, 0)
    return planner


def dense(coo, n):
    A = np.zeros((n, n))
    np.add.at(A, (coo[0], coo[1]), coo[2])
    return A


@pytest.mark.parametrize("pieces", [1, 4])
def test_pcg_jacobi_matches_jax(pieces):
    """test_12's solve (n = 96, 20 iterations): history and x against
    JAX's, ||b - Ax||^2 against the last entry (rtol 1e-8), and Jacobi
    beating unpreconditioned CG a hundredfold."""
    n, its = 96, 20
    coo = variable_diag(n)
    pt = build_port(coo, n, pieces)
    ht = T.PCGSolver(pt, T.JacobiPreconditioner(pt)).solve(its).numpy()
    pj = build_jax(coo, n, pieces)
    hj = np.asarray(JPCG(pj, JJacobi(pj)).solve(its))
    np.testing.assert_allclose(ht, hj, rtol=1e-9)
    x = pt.sol_vectors[0].to_numpy()
    np.testing.assert_allclose(x, pj.sol_vectors[0].to_numpy(), rtol=1e-8)
    r = np.ones(n) - dense(coo, n) @ x
    assert np.isclose(r @ r, ht[-1], rtol=1e-8, atol=1e-25)
    h_cg = T.CGSolver(build_port(coo, n, pieces)).solve(its).numpy()
    assert ht[-1] < h_cg[-1] * 1e-2


def test_identity_preconditioner_is_cg():
    """PCG with M = I reproduces the port's CG (rtol 1e-12, test_12's
    bound) and JAX's PCG with M = I (rtol 1e-9)."""
    n = 64
    coo = variable_diag(n)
    h_cg = T.CGSolver(build_port(coo, n)).solve(15).numpy()
    h_pcg = T.PCGSolver(build_port(coo, n), None).solve(15).numpy()
    np.testing.assert_allclose(h_cg, h_pcg, rtol=1e-12)
    hj = np.asarray(JPCG(build_jax(coo, n), None).solve(15))
    np.testing.assert_allclose(h_pcg, hj, rtol=1e-9)


def test_eager_steps_match_solve():
    """Five step()s leave the x that solve(5) leaves (rtol 1e-12)."""
    n = 64
    coo = variable_diag(n)
    p1 = build_port(coo, n, 4)
    s1 = T.PCGSolver(p1, T.JacobiPreconditioner(p1))
    for _ in range(5):
        s1.step()
    p2 = build_port(coo, n, 4)
    T.PCGSolver(p2, T.JacobiPreconditioner(p2)).solve(5)
    np.testing.assert_allclose(p1.sol_vectors[0].to_numpy(),
                               p2.sol_vectors[0].to_numpy(), rtol=1e-12)


def _reordered_run(coo, n, reorder):
    if reorder:
        pt = build_port(coo, n)
        assert isinstance(pt.row_partitioned_matrices[0][0],
                          ReorderedOperator)
    else:
        with no_reorder():
            pt = build_port(coo, n)
    solver = T.PCGSolver(pt, T.JacobiPreconditioner(pt))
    return solver.solve(12).numpy(), pt.sol_vectors[0].to_numpy()


def test_jacobi_on_a_reordered_system():
    """test_26:219: Jacobi unwraps the ReorderedOperator and applies the
    diagonal in the solver basis.  The RCM run against the run without
    reordering (rtol 1e-9: same math, another basis), and against JAX's
    RCM run (rtol 1e-9)."""
    n = 4096
    coo = bumped(n, seed=51)
    h_r, x_r = _reordered_run(coo, n, True)
    h_p, x_p = _reordered_run(coo, n, False)
    np.testing.assert_allclose(h_r, h_p, rtol=1e-9)
    np.testing.assert_allclose(x_r, x_p, rtol=1e-8, atol=1e-12)
    assert h_r[-1] < h_r[0]
    pj = build_jax(coo, n)
    hj = np.asarray(JPCG(pj, JJacobi(pj)).solve(12))
    np.testing.assert_allclose(h_r, hj, rtol=1e-9)
    np.testing.assert_allclose(x_r, pj.sol_vectors[0].to_numpy(), rtol=1e-8,
                               atol=1e-12)


def test_inverse_diagonal_in_both_bases():
    """The inverse diagonal kept for the solver basis is the original one
    permuted by the planner's basis."""
    n = 4096
    pt = build_port(bumped(n, seed=51), n)
    M = T.JacobiPreconditioner(pt)
    perm = pt.basis_perms[0]["perm_np"]
    np.testing.assert_array_equal(M.inv_diags_basis[0].numpy(),
                                  M.inv_diags[0].numpy()[perm])
    d = dense(bumped(n, seed=51), n).diagonal()
    np.testing.assert_allclose(M.inv_diags[0].numpy(), 1.0 / d, rtol=1e-15)


def test_pcg_continued_from_jax_state():
    """Five JAX iterations, then five more in each package from the JAX
    state (``convert.pcg_solver_from_state`` with the JAX solver's rz):
    histories rtol 1e-9, x rtol 1e-8."""
    n = 96
    coo = variable_diag(n)
    pj = build_jax(coo, n)
    sj = JPCG(pj, JJacobi(pj))
    sj.solve(5)
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k != "ops"}
    rz = float(sj.rz[-1].value)
    pt = build_port(coo, n)
    st = convert.pcg_solver_from_state(pt, state, rz)
    ht = st.solve(5).numpy()
    hj = np.asarray(sj.solve(5))
    np.testing.assert_allclose(ht, hj, rtol=1e-9)
    np.testing.assert_allclose(pt.sol_vectors[0].to_numpy(),
                               pj.sol_vectors[0].to_numpy(), rtol=1e-8)


def test_stencil_pcg_equals_cg_f32():
    """On the 2-D 5-point stencil (kernel view, f32, plain versions on the
    CPU) the diagonal is the constant 4, so PCG(Jacobi) is CG in exact
    arithmetic: its history stays within 1e-4 of the float64 CG history
    over 30 iterations, as the port's f32 CG does (test_torch_cg_slice's
    bound)."""
    from legionsolvers_tpu_torch.entry import build_stencil_system

    shape = (32, 128)
    pt = build_stencil_system(2, shape, T.SolverOptions(
        entry_dtype=torch.float32), device=DEV)
    M = T.JacobiPreconditioner(pt)
    assert torch.all(M.inv_diags[0] == 0.25)
    h = T.PCGSolver(pt, M).solve(30).double().numpy()
    p64 = build_stencil_system(2, shape, F64T, device=DEV)
    h64 = T.CGSolver(p64).solve(30).numpy()
    np.testing.assert_allclose(h, h64, rtol=1e-4)
