"""The port's explicit-DIA path (K8, ``DiaOperator``, the planner's DIA
upgrade) against the JAX package: test_17's cases.

JAX runs its Pallas kernel in interpret mode on the CPU; the port runs the
plain version its wrapper takes on CPU tensors.  Tolerances: host arrays
bit for bit (no duplicate entries; with duplicates the JAX package sums in
a thread-dependent order, so 1e-12); K8 f32 rtol 1e-5 (the terms are
summed in the same order, but XLA on the CPU may contract a product and a
sum into one FMA, and the dots are summed in another order); f64
(linearized) rtol 1e-11; the fp64 golden exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.native import bindings as JB
from legionsolvers_tpu.ops.pallas.dia2d import dia2d_matvec as j_dia2d
from legionsolvers_tpu_torch.native import bindings as TB
from legionsolvers_tpu_torch.ops.cuda import dia2d as TK
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TS
from legionsolvers_tpu_torch.parallel import dia_op as TD

torch.set_num_threads(2)

DEV = "cpu"
F64 = T.SolverOptions(entry_dtype=torch.float64)
F32 = T.SolverOptions(entry_dtype=torch.float32)
F64J = J.SolverOptions(entry_dtype=jnp.float64)
F32J = J.SolverOptions(entry_dtype=jnp.float32)
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]


def _pair(shape, stencil=None, f64=True):
    """The same stencil matrix in both packages."""
    stencil = stencil or J.laplacian_stencil(len(shape))
    a = J.create_coo_stencil_matrix(shape, stencil,
                                    options=F64J if f64 else F32J)
    b = T.COOMatrix(np.asarray(a.rows), np.asarray(a.cols),
                    np.asarray(a.vals), a.n_range, a.n_domain,
                    options=F64 if f64 else F32)
    return a, b


# -- host extraction --------------------------------------------------------

@pytest.mark.parametrize("shape", [(64,), (8, 8), (4, 4, 4), (32, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_extract_matches_jax(shape, dtype):
    from legionsolvers_tpu.parallel.dia_op import dia_extract as j_extract

    a, b = _pair(shape)
    n = a.n_range
    uj, cj = j_extract(a, n + 3, dtype)
    ut, ct = TD.dia_extract(b, n + 3, dtype)
    np.testing.assert_array_equal(ut, uj)
    assert ct.dtype == cj.dtype
    np.testing.assert_array_equal(ct, cj)


def test_dia_bindings_with_duplicates():
    """Duplicates summed against a dense oracle, and against the JAX
    package's C++ and numpy paths."""
    rng = np.random.default_rng(0)
    n, nnz = 50, 300
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    u = TB.dia_unique_offsets(rows, cols, 200)
    np.testing.assert_array_equal(u, JB.dia_unique_offsets(rows, cols, 200))
    oracle = np.zeros((len(u), n + 3))
    for k, s in enumerate(u):
        for r in range(n):
            if 0 <= r + s < n:
                oracle[k, r] = dense[r, r + s]
    for dt in (np.float32, np.float64):
        coef = TB.dia_accumulate(rows, cols, vals, u, n + 3, dt)
        assert coef.dtype == dt
        np.testing.assert_allclose(coef, oracle.astype(dt), rtol=1e-6)
        np.testing.assert_allclose(
            coef, JB.dia_accumulate(rows, cols, vals, u, n + 3, dt),
            rtol=1e-6 if dt == np.float32 else 1e-12)
    assert TB.dia_unique_offsets(np.arange(100), np.zeros(100, np.int64),
                                 40) is None


# -- K8 against the JAX kernel -----------------------------------------------

def _k8_inputs(R, C, offsets, seed):
    """Random x, halos and coefficients, zero where a column shift leaves
    the row (the operator's contract: the JAX kernel reads wrapped lanes
    there, the port reads zeros)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((R, C)).astype(np.float32)
    top = rng.standard_normal((8, C)).astype(np.float32)
    bot = rng.standard_normal((8, C)).astype(np.float32)
    diags = rng.standard_normal((len(offsets), R, C)).astype(np.float32)
    c = np.arange(C)
    for k, (_, dx) in enumerate(offsets):
        diags[k][:, (c + dx < 0) | (c + dx >= C)] = 0.0
    return x, top, bot, diags


K8_CASES = [
    ((16, 256), ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))),
    ((24, 384), ((-8, 3), (0, 0), (2, -200), (5, 130), (8, -1), (-3, 0))),
]


@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("shape,offsets", K8_CASES)
def test_k8_plain_matches_jax_kernel(shape, offsets, with_dot):
    x, top, bot, diags = _k8_inputs(*shape, offsets, seed=1)
    want = j_dia2d(jnp.asarray(x), jnp.asarray(top), jnp.asarray(bot),
                   jnp.asarray(diags), offsets=offsets, with_dot=with_dot,
                   interpret=True)
    got = TK.dia2d_matvec(torch.from_numpy(x), torch.from_numpy(top),
                          torch.from_numpy(bot), torch.from_numpy(diags),
                          offsets=offsets, with_dot=with_dot)
    if with_dot:
        (want, wdot), (got, gdot) = want, got
        assert float(gdot) == pytest.approx(float(wdot), rel=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    assert sum(TS.LAUNCHES.values()) == 0


def test_k8_gate_and_checks():
    offs = ((0, 0), (9, 0))
    assert not TK.supports_dia(16, 128, offs)
    assert not TK.supports_dia(16, 128, ((0, 128),))
    assert not TK.supports_dia(16, 128, ((0, 0),), itemsize=8)
    assert TK.supports_dia(3, 5, ((0, 0), (-8, 4)))
    x = torch.zeros(16, 128)
    with pytest.raises(ValueError):
        TK.dia2d_matvec(x, None, None, torch.zeros(2, 16, 128), offsets=offs)
    with pytest.raises(TypeError):
        TK.dia2d_matvec(x.double(), None, None,
                        torch.zeros(1, 16, 128).double(), offsets=((0, 0),))
    with pytest.raises(ValueError, match="contiguous"):
        TK.dia2d_matvec(x, None, None, torch.zeros(1, 128, 16).transpose(1, 2),
                        offsets=((0, 0),))


# -- the operator -------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64,), (8, 8), (4, 4, 4)])
def test_dia_f64_matches_jax(shape):
    """The f64 linearized path against JAX's, the port's ELL operator and
    the dense product."""
    a, b = _pair(shape)
    n = a.n_range
    part = T.BlockPartition(n, 1)
    op = T.DiaOperator(b, part, options=F64, device=DEV)
    assert not op.uses_pallas
    opj = J.DiaOperator(a, partition=J.BlockPartition(n, 1), mesh=None,
                        options=F64J)
    x = np.random.default_rng(0).random(n)
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(opj.matvec(jnp.asarray(x))),
                               rtol=1e-11)
    ell = T.RowPartitionedMatrix(b, part, part, options=F64, device=DEV)
    np.testing.assert_allclose(y, ell.matvec(torch.from_numpy(x)).numpy(),
                               rtol=1e-11)
    np.testing.assert_allclose(y, b.to_dense() @ x, rtol=1e-11)
    y2, d = op.matvec_dot(torch.from_numpy(x))
    assert torch.equal(y2, torch.from_numpy(y))
    assert float(d) == pytest.approx(float(x @ y), rel=1e-12)


@pytest.mark.parametrize("shape", [(32, 128), (64, 128)])
def test_dia_f32_view_matches_jax(shape):
    """The f32 kernel view: same width, same split diagonals, and matvec
    (with its dot) as JAX's interpret-mode kernel."""
    a, b = _pair(shape, f64=False)
    n = a.n_range
    op = T.DiaOperator(b, T.BlockPartition(n, 1), options=F32, device=DEV)
    opj = J.DiaOperator(a, partition=J.BlockPartition(n, 1), mesh=None,
                        options=F32J)
    assert op.uses_pallas and opj.uses_pallas
    assert op._view["C"] == opj._view["C"]
    assert op._view["offs"] == opj._view["offs"]
    np.testing.assert_array_equal(op._view["diags"].numpy(),
                                  np.asarray(opj._view["diags"]))
    x = np.random.default_rng(1).random(n).astype(np.float32)
    y, d = op.matvec_dot(torch.from_numpy(x))
    yj, dj = opj.matvec_dot(jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-6)
    assert float(d) == pytest.approx(float(dj), rel=1e-5)
    np.testing.assert_allclose(
        y.numpy(), b.to_dense() @ x.astype(np.float64), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_planner_upgrade_golden(fmt):
    """add_row_partitioned_matrix upgrades the one-piece 1-D Laplacian to
    DIA, as JAX does, and the n=100 golden is exact."""
    gen = {"coo": T.coo_negative_laplacian_1d,
           "csr": T.csr_negative_laplacian_1d}[fmt]
    part = T.BlockPartition(100, 1)
    planner = T.SquarePlanner(options=F64, device=DEV)
    planner.add_sol_vector(T.PartitionedVector("s", part, options=F64,
                                               device=DEV))
    planner.add_rhs_vector(T.PartitionedVector(
        "b", part, options=F64, device=DEV).constant_fill(1.0))
    planner.add_row_partitioned_matrix(gen(100, options=F64), 0, 0)
    assert isinstance(planner.row_partitioned_matrices[0][0], T.DiaOperator)
    assert T.CGSolver(planner).solve(10).tolist() == GOLDEN


def _planner(matrix, n, pieces=1, options=F64, **kw):
    part = T.BlockPartition(n, pieces)
    planner = T.SquarePlanner(options=options, device=DEV)
    planner.add_sol_vector(T.PartitionedVector("s", part, options=options,
                                               device=DEV))
    planner.add_rhs_vector(T.PartitionedVector(
        "b", part, options=options, device=DEV).constant_fill(1.0))
    planner.add_row_partitioned_matrix(matrix, 0, 0, **kw)
    return planner


@pytest.mark.parametrize("how", ["prefer_dia", "env", "pieces"])
def test_planner_keeps_ell(how, monkeypatch):
    """prefer_dia=False, LEGIONSOLVERS_NO_DIA=1 and a multi-piece
    partition without a mesh keep the ELL operator; the golden holds."""
    A = T.coo_negative_laplacian_1d(100, options=F64)
    if how == "env":
        monkeypatch.setenv("LEGIONSOLVERS_NO_DIA", "1")
    planner = _planner(A, 100, pieces=4 if how == "pieces" else 1,
                       prefer_dia=how != "prefer_dia")
    assert isinstance(planner.row_partitioned_matrices[0][0],
                      T.RowPartitionedMatrix)
    assert T.CGSolver(planner).solve(10).tolist() == GOLDEN


def test_dia_rmatvec_adjoint():
    """<A^T y, x> == <y, A x> through the swapped-diagonal transpose, and
    A^T y as JAX computes it."""
    offs = [((0, 0), 4.0), ((0, 1), -2.0), ((1, 0), -1.0)]
    a, b = _pair((8, 8), offs)
    op = T.DiaOperator(b, T.BlockPartition(64, 1), options=F64, device=DEV)
    opj = J.DiaOperator(a, partition=J.BlockPartition(64, 1), mesh=None,
                        options=F64J)
    rng = np.random.default_rng(2)
    xh, yh = rng.random(64), rng.random(64)
    ax = op.matvec(torch.from_numpy(xh)).numpy()
    aty = op.rmatvec(torch.from_numpy(yh)).numpy()
    assert yh @ ax == pytest.approx(aty @ xh, rel=1e-12)
    np.testing.assert_allclose(aty, np.asarray(opj.rmatvec(jnp.asarray(yh))),
                               rtol=1e-11)


def test_dia_solve_converges():
    """n = 103 through the DIA upgrade converges to the true solution (in
    52 steps: b = 1 is symmetric, and the step after an exactly zero
    residual would divide 0 by 0, as the reference does)."""
    n = 103
    A = T.coo_negative_laplacian_1d(n, options=F64)
    planner = _planner(A, n)
    assert isinstance(planner.row_partitioned_matrices[0][0], T.DiaOperator)
    solver = T.CGSolver(planner)
    for _ in range(n):
        solver.step()
        if solver.residual_norm_squared[-1].get_value() < 1e-20:
            break
    x = planner.sol_vectors[0].to_numpy()
    assert np.linalg.norm(A.to_dense() @ x - 1.0) < 1e-8


@pytest.mark.parametrize("bad", ["nonsquare", "mesh", "pieces"])
def test_dia_rejects(bad):
    """A non-square matrix and several pieces without a mesh raise; on a
    mesh of 4 pieces the operator is built and its matvec matches the
    dense oracle."""
    if bad == "mesh":
        from legionsolvers_tpu_torch.parallel.mesh import make_mesh

        n = 103
        A = T.coo_negative_laplacian_1d(n, options=F64)
        part = T.BlockPartition(n, 4)
        op = T.DiaOperator(A, part, mesh=make_mesh(4, devices=[DEV] * 4),
                           options=F64, device=DEV)
        xh = np.random.default_rng(5).random(n)
        x = T.PartitionedVector.from_array("x", xh, part, mesh=op.mesh,
                                           options=F64)
        y = op.matvec(x.data).numpy()
        np.testing.assert_allclose(y[:n], A.to_dense() @ xh, rtol=1e-12)
        assert not y[n:].any()
        return

    class Fake:
        rows = np.array([0, 1])
        cols = np.array([0, 1])
        vals = np.array([1.0, 1.0])
        n_domain = 4 if bad == "nonsquare" else 2
        n_range = 2
        n_kernel = 2

    part = T.BlockPartition(2, 2 if bad == "pieces" else 1)
    with pytest.raises(ValueError):
        T.DiaOperator(Fake(), part, options=F64, device=DEV)


def test_dia_gate_is_density_aware():
    """61 full diagonals upgrade to DIA; a scattered matrix does not, and
    both packages route each to the same operator chain."""
    n = 256
    rng = np.random.default_rng(0)
    rows, cols, vals = [], [], []
    for s in range(-30, 31):
        r = np.arange(max(0, -s), min(n, n - s))
        rows.append(r)
        cols.append(r + s)
        vals.append(rng.standard_normal(len(r)))
    r, c, v = (np.concatenate(a) for a in (rows, cols, vals))
    planner = _planner(T.COOMatrix(r, c, v, n, n, options=F64), n)
    op = planner.row_partitioned_matrices[0][0]
    assert isinstance(op, T.DiaOperator)
    x = rng.standard_normal(n)
    dense = np.zeros((n, n))
    np.add.at(dense, (r, c), v)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               dense @ x, rtol=1e-12)

    m = 2048
    rs, cs = rng.integers(0, m, 500), rng.integers(0, m, 500)
    vs = rng.standard_normal(500)
    r2 = np.concatenate([rs, np.arange(m)])
    c2 = np.concatenate([cs, np.arange(m)])
    v2 = np.concatenate([vs, np.full(m, 4.0)])
    op2 = _planner(T.COOMatrix(r2, c2, v2, m, m, options=F64),
                   m).row_partitioned_matrices[0][0]
    pj = J.SquarePlanner(mesh=None, options=F64J)
    part = J.BlockPartition(m, 1)
    pj.add_sol_vector(J.PartitionedVector("s", part, options=F64J))
    pj.add_rhs_vector(J.PartitionedVector("b", part, options=F64J))
    pj.add_row_partitioned_matrix(
        J.COOMatrix(r2, c2, v2, m, m, options=F64J), 0, 0)
    opj = pj.row_partitioned_matrices[0][0]
    chain = lambda o: [type(o).__name__] + (chain(o.base)
                                            if hasattr(o, "base") else [])
    assert chain(op2) == chain(opj)
    assert not isinstance(op2, T.DiaOperator)
    x2 = rng.standard_normal(m)
    dense2 = np.zeros((m, m))
    np.add.at(dense2, (r2, c2), v2)
    np.testing.assert_allclose(op2.matvec(torch.from_numpy(x2)).numpy(),
                               dense2 @ x2, rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("shape", [(100,), (10, 10), (4, 5, 6)])
def test_dia_f32_one_row_view(shape):
    """f32 where no width of JAX's order fits: one row of width n on K8
    (JAX runs its linearized path there), matching JAX's result and the
    dense product to rtol 1e-5, with the dot."""
    a, b = _pair(shape, f64=False)
    n = a.n_range
    op = T.DiaOperator(b, T.BlockPartition(n, 1), options=F32, device=DEV)
    opj = J.DiaOperator(a, partition=J.BlockPartition(n, 1), mesh=None,
                        options=F32J)
    assert op.uses_pallas and not opj.uses_pallas
    assert (op._view["Br"], op._view["C"]) == (1, n)
    assert all(dy == 0 for dy, _ in op._view["offs"])
    assert len(op._view["offs"]) == len(op.flat_offsets)
    x = np.random.default_rng(4).random(n).astype(np.float32)
    y, d = op.matvec_dot(torch.from_numpy(x))
    yj = np.asarray(opj.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y.numpy(), yj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), b.to_dense() @ x.astype(np.float64),
                               rtol=1e-5, atol=1e-5)
    assert float(d) == pytest.approx(float(x.astype(np.float64) @ yj),
                                     rel=1e-5)
