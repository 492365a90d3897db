"""The port's fp64 CG golden trajectory (the counterpart of test_05).

10 CG iterations on the n=100 1-D negative Laplacian with b = 1, x0 = 0
must reproduce the exact-integer residual² history of the reference
(reference: test_all.py:130-133) exactly, in every combination of
{COO, CSR} x {1, 4 pieces} x {eager step(), solve()}.  The port has no
mesh yet, so the 4-piece cases are the padded block layout on one device.
The same systems are also held against the JAX package's planner on a
random right-hand side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu_torch.utils import convert

torch.set_num_threads(2)

GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]
F64 = T.SolverOptions(entry_dtype=torch.float64)
DEV = "cpu"
GEN = {"coo": T.coo_negative_laplacian_1d, "csr": T.csr_negative_laplacian_1d}


def setup_planner(fmt, n=100, pieces=4, rhs=None):
    part = T.BlockPartition(n, pieces)
    A = GEN[fmt](n, options=F64)
    if rhs is None:
        b = T.PartitionedVector("rhs", part, options=F64,
                               device=DEV).constant_fill(1.0)
    else:
        b = T.PartitionedVector.from_array("rhs", rhs, part, options=F64,
                                           device=DEV)
    sol = T.PartitionedVector("sol", part, options=F64, device=DEV).zero_fill()
    planner = T.SquarePlanner(options=F64, device=DEV)
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(b)
    planner.add_row_partitioned_matrix(A, 0, 0)
    return planner


@pytest.mark.parametrize("fmt", ["coo", "csr"])
@pytest.mark.parametrize("pieces", [1, 4])
def test_cg_golden_eager(fmt, pieces):
    solver = T.CGSolver(setup_planner(fmt, pieces=pieces))
    for _ in range(10):
        solver.step()
    assert [s.get_value() for s in solver.residual_norm_squared] == GOLDEN


@pytest.mark.parametrize("fmt", ["coo", "csr"])
@pytest.mark.parametrize("pieces", [1, 4])
def test_cg_golden_solve(fmt, pieces):
    planner = setup_planner(fmt, pieces=pieces)
    hist = T.CGSolver(planner).solve(10)
    assert hist.tolist() == GOLDEN
    # the solution solves the system to the residual the history claims
    A = GEN[fmt](100, options=F64)
    x = planner.sol_vectors[0].to_numpy()
    r = np.ones(100) - A.to_dense() @ x
    assert np.isclose(r @ r, hist[-1].item(), rtol=1e-12)


def test_cg_golden_8pieces():
    hist = T.CGSolver(setup_planner("coo", pieces=8)).solve(10)
    assert hist.tolist() == GOLDEN


def test_cg_golden_stencil_operator():
    """The same system as a matrix-free 1-D stencil: fp64 has no kernel
    view, so solve() runs the torch recompute runner."""
    part = T.BlockPartition(100, 1)
    op = T.StencilOperator((100,), T.laplacian_stencil(1), partition=part,
                           options=F64, device=DEV)
    assert not op.uses_pallas and op.supports_fused_cg
    planner = T.SquarePlanner(options=F64, device=DEV)
    planner.add_sol_vector(T.PartitionedVector("sol", part, options=F64,
                                               device=DEV))
    planner.add_rhs_vector(T.PartitionedVector(
        "rhs", part, options=F64, device=DEV).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    solver = T.CGSolver(planner)
    assert solver.solve(10).tolist() == GOLDEN
    assert solver._solve_cache[(10, "fused")] is not None


def test_cg_converges_small():
    """Full convergence: n=32 CG reaches machine precision in <= n steps.
    The one-piece system upgrades to the DIA operator, as in the JAX
    package, on its f64 linearized path.  Its fp64 arithmetic stays
    integer-exact and the residual reaches exactly 0 (at step 16); the
    recurrence has no guard after that (0/0, as in the reference), so only
    the history up to convergence is checked.  (The JAX package's XLA path
    contracts products and sums into FMAs and keeps ~1e-31 there.)"""
    planner = setup_planner("csr", n=32, pieces=1)
    assert isinstance(planner.row_partitioned_matrices[0][0], T.DiaOperator)
    hist = T.CGSolver(planner).solve(40).numpy()
    done = np.flatnonzero(hist < 1e-18 * hist[0] + 1e-20)
    assert done.size and done[0] <= 32
    assert np.isfinite(hist[: done[0] + 1]).all()


@pytest.mark.parametrize("fmt,pieces", [("coo", 1), ("csr", 4)])
def test_cg_fp64_matches_jax_random_rhs(fmt, pieces):
    """Same random b through both packages' planners (eager path)."""
    b = np.random.default_rng(12).standard_normal(100)
    hist_t = T.CGSolver(setup_planner(fmt, pieces=pieces, rhs=b)).solve(12)

    F64J = J.SolverOptions(entry_dtype=jnp.float64)
    part = J.BlockPartition(100, pieces)
    gen = (J.coo_negative_laplacian_1d if fmt == "coo"
           else J.csr_negative_laplacian_1d)
    pj = J.SquarePlanner(mesh=None, options=F64J)
    pj.add_sol_vector(J.PartitionedVector("sol", part, options=F64J))
    pj.add_rhs_vector(J.PartitionedVector.from_array("rhs", b, part,
                                                     options=F64J))
    pj.add_row_partitioned_matrix(gen(100, options=F64J), 0, 0,
                                  prefer_dia=False)
    hist_j = np.asarray(J.CGSolver(pj).solve(12))
    np.testing.assert_allclose(hist_t.numpy(), hist_j, rtol=1e-12)


def test_golden_continues_from_jax_state():
    """JAX takes three eager steps on the COO system; convert.py carries
    its COO arrays, vectors and residual history into the port, whose
    solve() continues the golden trajectory exactly."""
    F64J = J.SolverOptions(entry_dtype=jnp.float64)
    A = J.coo_negative_laplacian_1d(100, options=F64J)
    part = J.BlockPartition(100, 4)
    pj = J.SquarePlanner(mesh=None, options=F64J)
    pj.add_sol_vector(J.PartitionedVector("sol", part, options=F64J))
    pj.add_rhs_vector(J.PartitionedVector("rhs", part, options=F64J)
                      .constant_fill(1.0))
    pj.add_row_partitioned_matrix(A, 0, 0, prefer_dia=False)
    sj = J.CGSolver(pj)
    for _ in range(3):
        sj.step()
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k != "ops"}
    rr = [float(s.value) for s in sj.residual_norm_squared]
    _, st = convert.coo_cg_system(A.rows, A.cols, A.vals, 100, state, rr,
                                  pieces=4, options=F64,
                                  device=DEV)
    assert [s.get_value() for s in st.residual_norm_squared] == GOLDEN[:4]
    assert st.solve(7).tolist() == GOLDEN[3:]
