"""Matrix Market I/O and checkpoint/resume in the port
(``utils/io.py``) against the JAX package: the twins of test_11, files
crossing between the packages, and the port's history through its
checkpoint against JAX's through its own.

Tolerances: within the port, test_11's (f64 history rtol 1e-14, x rtol
1e-13); across the packages rtol 1e-12 (the same recurrence, summed in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.utils import io as JIO
from legionsolvers_tpu_torch.parallel.mesh import make_mesh
from legionsolvers_tpu_torch.utils import io as TIO

torch.set_num_threads(2)

DEV = "cpu"
F64 = T.SolverOptions(entry_dtype=torch.float64)
F32 = T.SolverOptions(entry_dtype=torch.float32)
F64J = J.SolverOptions(entry_dtype=jnp.float64)


def assert_same_coo(a, b):
    """Equal COO arrays bit for bit, and equal shapes."""
    for x, y in ((a.rows, b.rows), (a.cols, b.cols),
                 (np.asarray(a.vals, np.float64),
                  np.asarray(b.vals, np.float64))):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert (a.n_range, a.n_domain) == (b.n_range, b.n_domain)


def odd_matrix(pkg, options):
    """A 7 x 5 COO matrix with values that need all 17 digits, a
    subnormal, a signed zero, an integer and a duplicate entry."""
    rows = np.asarray([0, 6, 3, 3, 2, 0, 5])
    cols = np.asarray([0, 4, 1, 1, 2, 3, 0])
    vals = np.asarray([0.1, -1.0 / 3.0, 5e-324, 2.5, -0.0, 7.0,
                       1.7976931348623157e308])
    return pkg.COOMatrix(rows, cols, vals, 7, 5, name="odd", options=options)


def test_matrix_market_roundtrip(tmp_path):
    A = T.coo_negative_laplacian_1d(20, options=F64)
    path = str(tmp_path / "lap.mtx")
    TIO.write_matrix_market(path, A)
    B = TIO.read_matrix_market(path, options=F64)
    np.testing.assert_array_equal(A.to_dense(), B.to_dense())
    assert B.n_range == 20 and B.n_domain == 20 and B.name == "lap"
    assert_same_coo(A, B)


def test_matrix_market_roundtrip_csr_and_odd_values(tmp_path):
    """A CSR operator writes its COO arrays; values keep every bit."""
    path = str(tmp_path / "odd.mtx")
    A = odd_matrix(T, F64)
    TIO.write_matrix_market(path, A)
    assert_same_coo(A, TIO.read_matrix_market(path, options=F64))
    C = T.create_csr_stencil_matrix((4, 5), T.laplacian_stencil(2))
    TIO.write_matrix_market(path, C)
    B = TIO.read_matrix_market(path)
    np.testing.assert_array_equal(B.to_dense(), C.to_dense())


def test_matrix_market_symmetric(tmp_path):
    path = str(tmp_path / "sym.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real symmetric\n")
        f.write("% comment line\n")
        f.write("3 3 4\n")
        f.write("1 1 2.0\n2 2 2.0\n3 3 2.0\n2 1 -1.0\n")
    A = TIO.read_matrix_market(path)
    expected = np.array([[2, -1, 0], [-1, 2, 0], [0, 0, 2.0]])
    np.testing.assert_array_equal(A.to_dense(), expected)
    assert_same_coo(A, JIO.read_matrix_market(path))


@pytest.mark.parametrize("symmetry", ["general", "symmetric"])
def test_matrix_market_pattern_and_integer(symmetry, tmp_path):
    """``pattern`` entries read as ones, ``integer`` ones as floats; both as
    the JAX package reads them."""
    for field, lines in (("pattern", "1 1\n3 2\n2 3\n"),
                         ("integer", "1 1 4\n3 2 -2\n2 3 7\n")):
        path = str(tmp_path / f"{field}.mtx")
        with open(path, "w") as f:
            f.write(f"%%MatrixMarket matrix coordinate {field} {symmetry}\n")
            f.write("3 3 3\n" + lines)
        A = TIO.read_matrix_market(path)
        assert_same_coo(A, JIO.read_matrix_market(path))
        want = {"pattern": [1.0, 1.0, 1.0], "integer": [4.0, -2.0, 7.0]}
        assert np.asarray(A.vals)[:3].tolist() == want[field]
        assert A.n_kernel == (3 if symmetry == "general" else 5)


@pytest.mark.parametrize("text", [
    "not a matrix\n",
    "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "%%MatrixMarket matrix coordinate complex general\n1 1 1\n1 1 1 0\n",
    "%%MatrixMarket matrix coordinate real hermitian\n1 1 1\n1 1 1\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 3\n1 1 1\n2 2 1\n",
])
def test_matrix_market_rejects_garbage(text, tmp_path):
    """Each case raises ValueError, in both packages."""
    path = str(tmp_path / "bad.mtx")
    with open(path, "w") as f:
        f.write(text)
    with pytest.raises(ValueError):
        TIO.read_matrix_market(path)
    with pytest.raises(ValueError):
        JIO.read_matrix_market(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_matrix_market_crosses_between_packages(writer, tmp_path):
    """JAX writes and the port reads, the port writes and JAX reads: the
    same arrays, bit for bit (the texts differ in how values are spelt)."""
    path = str(tmp_path / "x.mtx")
    r = np.random.default_rng(0)
    n, m = 300, 2000
    rows, cols = r.integers(0, n, m), r.integers(0, n, m)
    vals = r.standard_normal(m) * 10.0 ** r.integers(-200, 200, m)
    At = T.COOMatrix(rows, cols, vals, n, n, name="x", options=F64)
    Aj = J.COOMatrix(rows, cols, vals, n, n, name="x", options=F64J)
    if writer == "jax":
        JIO.write_matrix_market(path, Aj)
        got = TIO.read_matrix_market(path, options=F64)
    else:
        TIO.write_matrix_market(path, At)
        got = JIO.read_matrix_market(path, options=F64J)
    assert got.name == "x"
    assert_same_coo(At, got)
    odd = str(tmp_path / "odd.mtx")
    (JIO if writer == "jax" else TIO).write_matrix_market(
        odd, odd_matrix(J if writer == "jax" else T,
                        F64J if writer == "jax" else F64))
    reader = TIO if writer == "jax" else JIO
    assert_same_coo(odd_matrix(T, F64), reader.read_matrix_market(odd))


def build_solver(mesh=None, solver=T.CGSolver):
    n = 60
    part = T.BlockPartition(n, 4)
    A = T.coo_negative_laplacian_1d(n, options=F64)
    kw = dict(mesh=mesh, options=F64, device=DEV)
    rhs = T.PartitionedVector("rhs", part, **kw).constant_fill(1.0)
    sol = T.PartitionedVector("sol", part, **kw).zero_fill()
    planner = T.SquarePlanner(**kw)
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(rhs)
    planner.add_row_partitioned_matrix(A, 0, 0)
    return solver(planner)


def build_jax_solver(mesh):
    n = 60
    part = J.BlockPartition(n, 4)
    A = J.coo_negative_laplacian_1d(n, options=F64J)
    rhs = J.PartitionedVector("rhs", part, mesh=mesh,
                              options=F64J).constant_fill(1.0)
    sol = J.PartitionedVector("sol", part, mesh=mesh, options=F64J).zero_fill()
    planner = J.SquarePlanner(mesh=mesh, options=F64J)
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(rhs)
    planner.add_row_partitioned_matrix(A, 0, 0)
    return J.CGSolver(planner)


def mesh4():
    return make_mesh(4, devices=[DEV] * 4)


def test_checkpoint_resume(tmp_path):
    """Running 4 + 4 iterations through a checkpoint equals 8 straight
    iterations (f64, 4 pieces, test_11's tolerances); the operator's
    device state is saved under JAX's key."""
    s1 = build_solver(mesh4())
    s1.solve(4)
    path = str(tmp_path / "ck.npz")
    TIO.save_checkpoint(path, s1)

    s2 = build_solver(mesh4())
    TIO.load_checkpoint(path, s2)
    h2 = s2.solve(4).numpy()

    s3 = build_solver(mesh4())
    h3 = s3.solve(8).numpy()
    np.testing.assert_allclose(h2[1:], h3[5:], rtol=1e-14)
    np.testing.assert_allclose(s2.planner.sol_vectors[0].to_numpy(),
                               s3.planner.sol_vectors[0].to_numpy(),
                               rtol=1e-13)
    with np.load(path) as data:
        keys = set(data.files)
    assert {"vec_sol_0", "vec_rhs_0", "vec_ws0_0", "vec_ws1_0", "vec_ws2_0",
            "scalar_residual_norm_squared"} <= keys
    ops = s1.planner.dump_state()["ops"]
    assert ("vec_ops_0" in keys) == TIO._stackable(ops[0])


def test_checkpoint_continues_the_solve_exactly(tmp_path):
    """solve(5), save, load into a fresh solver: its solve(5) is the first
    solver's next solve(5), bit for bit (history and x), in f32 on one
    piece (the matrix-free stencil operator, whose state is not saved)
    and in f64 on 4 pieces."""
    for make in (lambda: T.CGSolver(T.entry.build_system(
                     64, options=F32, device=DEV)),
                 lambda: build_solver(mesh4())):
        s1 = make()
        s1.solve(5)
        path = str(tmp_path / "ck.npz")
        TIO.save_checkpoint(path, s1)
        s2 = make()
        TIO.load_checkpoint(path, s2)
        h1, h2 = s1.solve(5), s2.solve(5)
        assert h1.dtype == h2.dtype and torch.equal(h1, h2)
        assert torch.equal(s1.planner.sol_vectors[0].data,
                           s2.planner.sol_vectors[0].data)


def test_checkpoint_bicgstab(tmp_path):
    """BiCGStab's rho, alpha and omega travel with the vectors: 3 + 3
    iterations through a checkpoint equal 6 straight ones."""
    def make():
        return build_solver(mesh4(), solver=T.BiCGStabSolver)

    s1 = make()
    s1.solve(3)
    path = str(tmp_path / "ck.npz")
    TIO.save_checkpoint(path, s1)
    with np.load(path) as data:
        assert {"scalar_rho", "scalar_alpha", "scalar_omega"} <= set(
            data.files)
    s2 = make()
    TIO.load_checkpoint(path, s2)
    h2 = s2.solve(3).numpy()
    h3 = make().solve(6).numpy()
    np.testing.assert_allclose(h2[1:], h3[4:], rtol=1e-13)


def test_checkpoint_history_matches_jax(tmp_path):
    """The port through its checkpoint and JAX through its own (4 + 4
    iterations, f64, 4 pieces): the same history and x, rtol 1e-12."""
    from legionsolvers_tpu.parallel.mesh import make_mesh as jax_mesh

    mj = jax_mesh(4)
    js1 = build_jax_solver(mj)
    js1.solve(4)
    JIO.save_checkpoint(str(tmp_path / "j.npz"), js1)
    js2 = build_jax_solver(mj)
    JIO.load_checkpoint(str(tmp_path / "j.npz"), js2)
    hj = np.asarray(js2.solve(4))

    s1 = build_solver(mesh4())
    s1.solve(4)
    TIO.save_checkpoint(str(tmp_path / "t.npz"), s1)
    s2 = build_solver(mesh4())
    TIO.load_checkpoint(str(tmp_path / "t.npz"), s2)
    ht = s2.solve(4).numpy()
    np.testing.assert_allclose(ht, hj, rtol=1e-12)
    np.testing.assert_allclose(s2.planner.sol_vectors[0].to_numpy(),
                               js2.planner.sol_vectors[0].to_numpy(),
                               rtol=1e-12)


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote resumes in the port: its keys
    and layouts are the port's."""
    from legionsolvers_tpu.parallel.mesh import make_mesh as jax_mesh

    mj = jax_mesh(4)
    js1 = build_jax_solver(mj)
    js1.solve(4)
    JIO.save_checkpoint(str(tmp_path / "j.npz"), js1)
    hj = np.asarray(js1.solve(4))
    s2 = build_solver(mesh4())
    TIO.load_checkpoint(str(tmp_path / "j.npz"), s2)
    np.testing.assert_allclose(s2.solve(4).numpy(), hj, rtol=1e-12)
