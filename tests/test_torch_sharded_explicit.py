"""Explicit matrices on the pieces of a mesh in the port (the halo schedule
of ``core/partition.py``, the host packers of ``native/bindings.py``, the
sharded ``RowPartitionedMatrix`` on K9, ``DiaOperator`` on K8 with its
edge fix-ups, the planner's upgrades on a mesh) against the JAX package.

The JAX side runs on the conftest's 8 virtual CPU devices (``mesh4``,
``mesh8``) with its Pallas kernels in interpret mode; the port puts its S
shards on the CPU (``make_mesh(S, devices=["cpu"] * S)``) and runs the
plain versions its wrappers take on CPU tensors.  Inputs are numpy arrays
made from a seed.  Tolerances: host schedules, packings and windowed plans
exactly; float64 products rtol 1e-12 (other summation orders); the K9 and
K8 f32 paths rtol 1e-6 (the JAX package's XLA may contract a product and a
sum into one FMA); the float64 golden of test_05 exactly; the solves at the
tolerance of the JAX test they mirror (test_06, test_07, test_12, test_16,
test_17, test_18, test_24).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.core import partition as JP
from legionsolvers_tpu.native import bindings as JB
from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix as JRPM
from legionsolvers_tpu_torch.core import partition as TP
from legionsolvers_tpu_torch.native import bindings as TB
from legionsolvers_tpu_torch.parallel.mesh import make_mesh
from legionsolvers_tpu_torch.utils import convert

torch.set_num_threads(2)

DEV = "cpu"
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]
F64 = T.SolverOptions(entry_dtype=torch.float64)
F32 = T.SolverOptions(entry_dtype=torch.float32)
F64J = J.SolverOptions(entry_dtype=jnp.float64)
F32J = J.SolverOptions(entry_dtype=jnp.float32)
OPTS = {"f64": (F64J, F64), "f32": (F32J, F32)}
NO_UPGRADE = ("LEGIONSOLVERS_NO_RCM", "LEGIONSOLVERS_NO_DIA")


def cpu_mesh(S):
    return make_mesh(S, devices=[DEV] * S)


def jmesh(S):
    from legionsolvers_tpu.parallel.mesh import make_mesh as jax_mesh

    return jax_mesh(S)


def chain(op):
    return [type(op).__name__] + (chain(op.base) if hasattr(op, "base")
                                  else [])


def banded(n, bw, avg, seed, spd=True, diag=None):
    """(rows, cols, vals) of a random banded matrix; ``spd``: B + B^T +
    diag(``diag``, default 4 avg)."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n * avg)
    cols = rows + rng.integers(-bw, bw + 1, n * avg)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1.0, 1.0, len(rows))
    if not spd:
        return rows, cols, vals
    d = 4.0 * avg if diag is None else diag
    return (np.concatenate([rows, cols, np.arange(n)]),
            np.concatenate([cols, rows, np.arange(n)]),
            np.concatenate([vals, vals, np.full(n, d)]))


def pair(rows, cols, vals, n, key="f64"):
    fj, ft = OPTS[key]
    return (J.COOMatrix(rows, cols, vals, n, n, options=fj),
            T.COOMatrix(rows, cols, vals, n, n, options=ft))


def planners(Aj, At, n, S, key="f64", rhs=None, prefer_dia=True, env=(),
             monkeypatch=None, spaces=1):
    """(JAX planner on a mesh of S devices, port planner on S CPU shards)
    of ``A`` x = b (b = 1 or ``rhs``; one per space), x0 = 0, every space
    registering ``A``; ``env`` flags set around the registration."""
    fj, ft = OPTS[key]
    mj, mt = jmesh(S), cpu_mesh(S)
    pj = J.SquarePlanner(mesh=mj, options=fj)
    pt = T.SquarePlanner(mesh=mt, options=ft)
    partj, partt = J.BlockPartition(n, S), T.BlockPartition(n, S)
    b = np.ones(n) if rhs is None else rhs
    for i in range(spaces):
        pj.add_sol_vector(J.PartitionedVector(f"s{i}", partj, mesh=mj,
                                              options=fj).zero_fill())
        pt.add_sol_vector(T.PartitionedVector(f"s{i}", partt, mesh=mt,
                                              options=ft).zero_fill())
    for i in range(spaces):
        pj.add_rhs_vector(J.PartitionedVector.from_array(
            f"b{i}", b, partj, mesh=mj, options=fj))
        pt.add_rhs_vector(T.PartitionedVector.from_array(
            f"b{i}", b, partt, mesh=mt, options=ft))
    for k in env:
        monkeypatch.setenv(k, "1")
    try:
        for i in range(spaces):
            pj.add_row_partitioned_matrix(Aj, i, i, prefer_dia=prefer_dia)
            pt.add_row_partitioned_matrix(At, i, i, prefer_dia=prefer_dia)
    finally:
        for k in env:
            monkeypatch.delenv(k)
    return pj, pt


def jx(a, n, S, mesh, key="f64"):
    """A JAX vector of ``a`` on ``mesh``, padded."""
    return J.PartitionedVector.from_array(
        "x", a, J.BlockPartition(n, S), mesh=mesh, options=OPTS[key][0]).data


def tx(a, n, S, key="f64"):
    return T.PartitionedVector.from_array(
        "x", a, T.BlockPartition(n, S), mesh=cpu_mesh(S),
        options=OPTS[key][1]).data


# -- the halo schedule and the host packers ----------------------------------

HALO_CASES = {
    # n not divisible by S, a band of 40 around the diagonal
    "ragged": lambda S: (1003, banded(1003, 40, 4, 11, spd=False)),
    # a band wider than a block: every piece reads from several others
    "wide": lambda S: (64 * S + 5, banded(64 * S + 5, 150, 3, 12,
                                          spd=False)),
}


@pytest.mark.parametrize("S", [4, 8])
@pytest.mark.parametrize("case", list(HALO_CASES))
def test_halo_exchange_matches_jax(case, S):
    n, (rows, cols, _) = HALO_CASES[case](S)
    for P in (JP, TP):
        part = P.BlockPartition(n, S)
        kp = P.kernel_partition_from_range(rows, part)
        if P is JP:
            hj, kj = P.build_halo_exchange(cols, kp, part), kp
        else:
            ht, kt = P.build_halo_exchange(cols, kp, part), kp
    for a, b in zip(kj, kt):
        np.testing.assert_array_equal(a, b)
    for f in ("num_pieces", "block_size", "halo_total", "offsets",
              "ext_size"):
        assert getattr(ht, f) == getattr(hj, f), f
    np.testing.assert_array_equal(ht.halo_sizes, hj.halo_sizes)
    for a, b in zip(ht.halo_global, hj.halo_global):
        np.testing.assert_array_equal(a, b)
    for f in ("send_idx", "send_count", "recv_pos"):
        dj, dt = getattr(hj, f), getattr(ht, f)
        assert sorted(dt) == sorted(dj)
        for d in dj:
            np.testing.assert_array_equal(dt[d], dj[d])
    if case == "wide":
        assert len(ht.offsets) > 2
    B = ht.block_size
    for s in range(S):
        c = cols[kt[s]]
        np.testing.assert_array_equal(
            TB.shard_halo_columns(c, s * B, B),
            JB.shard_halo_columns(c, s * B, B))
        np.testing.assert_array_equal(TB.shard_halo_columns(c, s * B, B),
                                      ht.halo_global[s])


@pytest.mark.parametrize("S", [4, 8])
def test_pack_ell_shard_matches_jax(S, monkeypatch):
    """The port's packer equals the per-piece ELL slabs of the JAX
    package's sharded RowPartitionedMatrix (its numpy packer, or its C++
    one where the library is built) and JAX's native packer where
    present.  Duplicate entries keep their own slots."""
    n = 1003
    rows, cols, vals = banded(n, 40, 4, 13, spd=False)
    rows = np.concatenate([rows, rows[:50]])
    cols = np.concatenate([cols, cols[:50]])
    vals = np.concatenate([vals, vals[:50] * 0.5])
    monkeypatch.setenv("LEGIONSOLVERS_NO_WINELL", "1")
    Aj = J.COOMatrix(rows, cols, vals, n, n, options=F64J)
    part = J.BlockPartition(n, S)
    rj = JRPM(Aj, part, part, jmesh(S), options=F64J)
    At = T.COOMatrix(rows, cols, vals, n, n, options=F64)
    rt = T.RowPartitionedMatrix(At, T.BlockPartition(n, S),
                                T.BlockPartition(n, S), mesh=cpu_mesh(S),
                                options=F64)
    assert rt.row_length == rj.row_length
    np.testing.assert_array_equal(rt.ell_cols.numpy(),
                                  np.asarray(rj.ell_cols))
    np.testing.assert_array_equal(rt.ell_vals.numpy(),
                                  np.asarray(rj.ell_vals))
    B, L, dump = part.block_size, rj.row_length, rj.halo.ext_size - 1
    for s in range(S):
        knz = rj.kernel_pieces[s]
        lr = rows[knz] - s * B
        o = np.argsort(lr, kind="stable")
        args = (lr[o], cols[knz][o], vals[knz][o], B, B, s * B,
                rj.halo.halo_global[s], L, dump)
        ct, vt = TB.pack_ell_shard(*args)
        assert ct.dtype == np.int32 and vt.dtype == np.float64
        np.testing.assert_array_equal(ct, np.asarray(rj.ell_cols)[s])
        np.testing.assert_array_equal(vt, np.asarray(rj.ell_vals)[s])
        native = JB.pack_ell_shard(*args)
        if native is not None:
            np.testing.assert_array_equal(ct, native[0])
            np.testing.assert_array_equal(vt, native[1])


# -- test_05's golden on pieces ------------------------------------------------

GEN = {"coo": (J.coo_negative_laplacian_1d, T.coo_negative_laplacian_1d),
       "csr": (J.csr_negative_laplacian_1d, T.csr_negative_laplacian_1d)}
ROUTES = {"dia": True, "ell": False}


def golden_planners(fmt, S, route):
    gj, gt = GEN[fmt]
    return planners(gj(100, options=F64J), gt(100, options=F64), 100, S,
                    prefer_dia=ROUTES[route])


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("mode", ["eager", "solve"])
@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_golden_on_4_pieces(fmt, mode, route):
    """The exact-integer fp64 history on 4 pieces through the planner's
    DIA upgrade and through the sharded ELL, with the operator JAX picks
    on mesh4."""
    pj, pt = golden_planners(fmt, 4, route)
    op = pt.row_partitioned_matrices[0][0]
    assert chain(op) == chain(pj.row_partitioned_matrices[0][0])
    assert chain(op) == (["DiaOperator"] if route == "dia"
                         else ["RowPartitionedMatrix"])
    assert op.mesh is not None
    solver = T.CGSolver(pt)
    if mode == "eager":
        for _ in range(10):
            solver.step()
        hist = [s.get_value() for s in solver.residual_norm_squared]
    else:
        hist = solver.solve(10).tolist()
    assert hist == GOLDEN
    A = GEN[fmt][1](100, options=F64)
    x = pt.sol_vectors[0].to_numpy()
    r = np.ones(100) - A.to_dense() @ x
    assert np.isclose(r @ r, hist[-1], rtol=1e-12)


@pytest.mark.parametrize("route", list(ROUTES))
def test_golden_on_8_pieces(route):
    pj, pt = golden_planners("coo", 8, route)
    assert chain(pt.row_partitioned_matrices[0][0]) == chain(
        pj.row_partitioned_matrices[0][0])
    assert T.CGSolver(pt).solve(10).tolist() == GOLDEN


# -- the sharded RowPartitionedMatrix: K9 per piece and the gather-ELL ---------

def rpm_pair(n, S, key, coo, env=(), monkeypatch=None):
    Aj, At = pair(*coo, n, key)
    for k in env:
        monkeypatch.setenv(k, "1")
    try:
        pj, pt = J.BlockPartition(n, S), T.BlockPartition(n, S)
        rj = JRPM(Aj, pj, pj, jmesh(S), options=OPTS[key][0])
        rt = T.RowPartitionedMatrix(At, pt, pt, mesh=cpu_mesh(S),
                                    options=OPTS[key][1])
    finally:
        for k in env:
            monkeypatch.delenv(k)
    return rj, rt


@pytest.mark.parametrize("key", ["f64", "f32"])
@pytest.mark.parametrize("route", ["win", "gather"])
def test_sharded_rpm_matches_jax(route, key, monkeypatch):
    """matvec and rmatvec on 4 pieces against JAX's on mesh4 and against
    the scipy oracle: f64 rtol 1e-12, f32 rtol 1e-6."""
    n, S = 8 * 1024 + 7, 4
    coo = banded(n, 300, 6, 23, spd=False)
    env = () if route == "win" else ("LEGIONSOLVERS_NO_WINELL",)
    rj, rt = rpm_pair(n, S, key, coo, env, monkeypatch)
    assert (rt._win is None) == (route == "gather") == (rj._win is None)
    rtol = 1e-12 if key == "f64" else 1e-6
    dt = np.float64 if key == "f64" else np.float32
    rng = np.random.default_rng(0)
    xh, yh = rng.standard_normal(n).astype(dt), rng.standard_normal(n)
    yh = yh.astype(dt)
    m = jmesh(S)
    A = sp.coo_matrix((coo[2].astype(dt).astype(np.float64),
                       (coo[0], coo[1])), shape=(n, n)).tocsr()
    scale = np.abs(A) @ np.abs(xh.astype(np.float64))
    y_t = rt.matvec(tx(xh, n, S, key)).numpy()
    y_j = np.asarray(rj.matvec(jx(xh, n, S, m, key)))
    assert not y_t[n:].any()
    np.testing.assert_allclose(y_t, y_j, rtol=rtol, atol=rtol * scale.max())
    np.testing.assert_allclose(y_t[:n], A @ xh.astype(np.float64),
                               rtol=rtol, atol=rtol * scale.max())
    at_t = rt.rmatvec(tx(yh, n, S, key)).numpy()
    at_j = np.asarray(rj.rmatvec(jx(yh, n, S, m, key)))
    ascale = (np.abs(A.T) @ np.abs(yh.astype(np.float64))).max()
    np.testing.assert_allclose(at_t, at_j, rtol=rtol, atol=rtol * ascale)
    np.testing.assert_allclose(at_t[:n], A.T @ yh.astype(np.float64),
                               rtol=rtol, atol=rtol * ascale)


@pytest.mark.parametrize("S", [4, 8])
def test_sharded_winell_plans_match_jax(S):
    """The per-piece windowed plans (Rt = 8, the shared L and KR maxima)
    and the halo slabs equal JAX's array for array."""
    n = 8 * 1024 * S // 4 + 3
    rj, rt = rpm_pair(n, S, "f32", banded(n, 200, 4, 29))
    assert rj._win is not None and rt._win is not None
    wj, wt = rj._win, rt._win
    for k in ("N", "KR", "ext2", "n_lo_u"):
        assert wt[k] == wj[k], k
    for k in ("wstart", "cols", "vals"):
        assert wt[k].shape == wj[k].shape
        np.testing.assert_array_equal(wt[k].numpy(), np.asarray(wj[k]))
    assert sorted(wt["recv_pos2"]) == sorted(wj["recv_pos2"])
    for d in wj["recv_pos2"]:
        np.testing.assert_array_equal(wt["recv_pos2"][d].numpy(),
                                      np.asarray(wj["recv_pos2"][d]))
        np.testing.assert_array_equal(rt.send_idx[d].numpy(),
                                      np.asarray(rj.send_idx[d]))
        np.testing.assert_array_equal(rt.recv_pos[d].numpy(),
                                      np.asarray(rj.recv_pos[d]))
    assert wt["cols"].shape[3] == 8  # Rt
    st = rt.device_state()
    assert {"ell_cols", "ell_vals", "send_idx", "recv_pos", "win_wstart",
            "win_cols", "win_vals", "win_recv_pos2"} == set(st)


def test_sharded_rpm_state_roundtrip():
    """device_state / set_device_state carry the sharded slabs and plans;
    matvec_add adds."""
    n, S = 8 * 1024, 4
    _, rt = rpm_pair(n, S, "f64", banded(n, 100, 4, 31))
    x = tx(np.random.default_rng(1).standard_normal(n), n, S)
    y = rt.matvec(x)
    st = rt.device_state()
    rt.set_device_state({k: (v.clone() if torch.is_tensor(v) else
                             {d: t.clone() for d, t in v.items()})
                         for k, v in st.items()})
    torch.testing.assert_close(rt.matvec(x), y, rtol=0, atol=0)
    torch.testing.assert_close(rt.matvec_add(y, x), 2 * y, rtol=0, atol=0)


# -- DiaOperator on pieces (test_17, test_18) ------------------------------------

def dia_pair(shape, S, key, offs=None):
    stencil = offs or J.laplacian_stencil(len(shape))
    a = J.create_coo_stencil_matrix(shape, stencil, options=OPTS[key][0])
    b = T.COOMatrix(np.asarray(a.rows), np.asarray(a.cols),
                    np.asarray(a.vals), a.n_range, a.n_domain,
                    options=OPTS[key][1])
    n = a.n_range
    dj = J.DiaOperator(a, partition=J.BlockPartition(n, S), mesh=jmesh(S),
                       options=OPTS[key][0])
    dt = T.DiaOperator(b, T.BlockPartition(n, S), mesh=cpu_mesh(S),
                       options=OPTS[key][1], device=DEV)
    return a, dj, dt


@pytest.mark.parametrize("with_dot", [False, True])
def test_sharded_dia_f32_zero_halo(with_dot):
    """test_17/test_18's f32 case: 4 pieces of [8, 128] rows (K8 zero-halo
    per piece plus the edge fix-up) against JAX's sharded DIA and the
    dense oracle."""
    shape, S = (32, 128), 4
    a, dj, dt = dia_pair(shape, S, "f32")
    assert dt.uses_pallas and dj.uses_pallas
    assert (dt._view["C"], dt._view["Br"]) == (dj._view["C"], dj._view["Br"])
    assert dt._view["offs"] == dj._view["offs"]
    np.testing.assert_array_equal(dt._view["diags"].numpy(),
                                  np.asarray(dj._view["diags"]))
    n = a.n_range
    xh = np.random.default_rng(1).random(n).astype(np.float32)
    x_t, x_j = tx(xh, n, S, "f32"), jx(xh, n, S, jmesh(S), "f32")
    ref = a.to_dense().astype(np.float64) @ xh
    if with_dot:
        (y_t, d_t), (y_j, d_j) = dt.matvec_dot(x_t), dj.matvec_dot(x_j)
        assert float(d_t) == pytest.approx(float(d_j), rel=1e-6)
        assert float(d_t) == pytest.approx(float(xh.astype(np.float64)
                                                 @ ref), rel=1e-6)
    else:
        y_t, y_j = dt.matvec(x_t), dj.matvec(x_j)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(y_t.numpy(), ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("shape", [(64,), (8, 8), (4, 4, 4)])
def test_sharded_dia_f64_linear(shape):
    """f64 DIA on 4 pieces (the linearized path, the band read from the
    neighbours) against JAX's and against the sharded gather-ELL (rtol
    1e-12: torch sums an ELL row in its own order, so the bit-for-bit
    agreement test_17 finds in JAX does not carry over)."""
    a, dj, dt = dia_pair(shape, 4, "f64")
    assert not dt.uses_pallas and not dt._wide_band
    n = a.n_range
    xh = np.random.default_rng(0).random(n)
    y_t = dt.matvec(tx(xh, n, 4)).numpy()
    np.testing.assert_allclose(y_t, np.asarray(dj.matvec(jx(xh, n, 4,
                                                            jmesh(4)))),
                               rtol=1e-12)
    part = T.BlockPartition(n, 4)
    ell = T.RowPartitionedMatrix(dt.matrix, part, part, mesh=cpu_mesh(4),
                                 options=F64)
    np.testing.assert_allclose(y_t, ell.matvec(tx(xh, n, 4)).numpy(),
                               rtol=1e-12)
    y, d = dt.matvec_dot(tx(xh, n, 4))
    assert float(d) == pytest.approx(float(xh @ y.numpy()[:n]), rel=1e-12)


def test_sharded_dia_wide_band_mesh8():
    """A band of 8 wider than blocks of 4 on 8 pieces: the gather halo."""
    a, dj, dt = dia_pair((4, 8), 8, "f64")
    assert dt._wide_band and not dt.uses_pallas
    n = 32
    xh = np.random.default_rng(3).random(n)
    y = dt.matvec(tx(xh, n, 8)).numpy()[:n]
    np.testing.assert_allclose(y, a.to_dense() @ xh, rtol=1e-12)
    np.testing.assert_allclose(
        y, np.asarray(dj.matvec(jx(xh, n, 8, jmesh(8))))[:n], rtol=1e-12)
    # the same band in f32 stays off K8 (JAX's rule)
    _, _, d32 = dia_pair((4, 8), 8, "f32")
    assert d32._wide_band and not d32.uses_pallas


@pytest.mark.parametrize("key", ["f64", "f32"])
def test_sharded_dia_rmatvec_adjoint(key):
    """<A^T y, x> == <y, A x> through the swapped-diagonal transpose on 4
    pieces, an asymmetric stencil; A^T y against JAX's."""
    offs = [((0, 0), 4.0), ((0, 1), -2.0), ((1, 0), -1.0)]
    shape = (8, 8) if key == "f64" else (32, 128)
    a, dj, dt = dia_pair(shape, 4, key, offs)
    n = a.n_range
    rng = np.random.default_rng(2)
    dtp = np.float64 if key == "f64" else np.float32
    xh, yh = rng.random(n).astype(dtp), rng.random(n).astype(dtp)
    ax = dt.matvec(tx(xh, n, 4, key)).numpy()[:n].astype(np.float64)
    aty = dt.rmatvec(tx(yh, n, 4, key)).numpy()[:n].astype(np.float64)
    rel = 1e-12 if key == "f64" else 1e-5
    assert yh.astype(np.float64) @ ax == pytest.approx(
        aty @ xh.astype(np.float64), rel=rel)
    aty_j = np.asarray(dj.rmatvec(jx(yh, n, 4, jmesh(4), key)))[:n]
    np.testing.assert_allclose(aty, aty_j, rtol=1e-12 if key == "f64"
                               else 1e-6, atol=0 if key == "f64" else 1e-5)
    assert dt.transpose().mesh is dt.mesh


def test_sharded_dia_padding_path():
    """n = 103 on 4 pieces: padded coefficient rows are zero; CG converges
    to the true solution (test_17; stepped until the residual vanishes:
    the port's float64 reaches exactly 0 and the next step would divide 0
    by 0, as the reference does)."""
    n = 103
    pj, pt = planners(J.coo_negative_laplacian_1d(n, options=F64J),
                      T.coo_negative_laplacian_1d(n, options=F64), n, 4)
    assert chain(pt.row_partitioned_matrices[0][0]) == ["DiaOperator"]
    solver = T.CGSolver(pt)
    for _ in range(n):
        solver.step()
        if solver.residual_norm_squared[-1].get_value() < 1e-20:
            break
    x = pt.sol_vectors[0].to_numpy()
    A = T.coo_negative_laplacian_1d(n, options=F64)
    assert np.linalg.norm(A.to_dense() @ x - 1.0) < 1e-8


# -- the planner's choice on a mesh ---------------------------------------------

def scrambled(n, seed=31):
    rows, cols, vals = banded(n, 200, 3, seed, diag=16.0)
    pr = np.random.default_rng(7).permutation(n)
    return pr[rows], pr[cols], vals


def random_spd(n, seed=5):
    rng = np.random.default_rng(seed)
    r, c = rng.integers(0, n, 3 * n), rng.integers(0, n, 3 * n)
    v = rng.uniform(-1, 1, 3 * n)
    return (np.concatenate([r, c, np.arange(n)]),
            np.concatenate([c, r, np.arange(n)]),
            np.concatenate([v, v, np.full(n, 16.0)]))


def laplacian2d(n):
    a = J.create_coo_stencil_matrix((64, n // 64), J.laplacian_stencil(2))
    return np.asarray(a.rows), np.asarray(a.cols), np.asarray(a.vals)


PICKS = {
    # name: (matrix, n, prefer_dia, the chain both packages pick)
    "laplacian": (laplacian2d, 4096, True, ["DiaOperator"]),
    "banded no dia": (lambda n: banded(n, 200, 3, 29, diag=16.0),
                      16 * 1024, False, ["RowPartitionedMatrix"]),
    "scrambled": (scrambled, 16 * 1024, True,
                  ["ReorderedOperator", "RowPartitionedMatrix"]),
    "random": (random_spd, 64 * 1024, True, ["RowPartitionedMatrix"]),
}


@pytest.mark.parametrize("name", list(PICKS))
def test_planner_picks_jax_operator_on_mesh4(name):
    """add_row_partitioned_matrix on a 4-shard mesh picks the operator
    JAX picks on mesh4, with or without the windowed plan as JAX."""
    make, n, prefer, want = PICKS[name]
    Aj, At = pair(*make(n), n, "f32")
    pj, pt = planners(Aj, At, n, 4, "f32", prefer_dia=prefer)
    oj, ot = (p.row_partitioned_matrices[0][0] for p in (pj, pt))
    assert chain(ot) == chain(oj) == want
    bj, bt = getattr(oj, "base", oj), getattr(ot, "base", ot)
    if isinstance(bt, T.RowPartitionedMatrix):
        assert (bt._win is None) == (bj._win is None)
        assert bt.mesh is not None
    if name == "random":
        assert bt._win is None
    if name in ("banded no dia", "scrambled"):
        assert bt._win is not None
    if name in ("laplacian", "random"):
        # the solve agrees with JAX's on the same pieces (f32, rtol 1e-4);
        # the windowed ones are held in the test_24 cases below
        hj = np.asarray(J.CGSolver(pj).solve(6))
        ht = T.CGSolver(pt).solve(6).numpy()
        np.testing.assert_allclose(ht, hj, rtol=1e-4)


def test_distinct_devices_still_raise():
    from legionsolvers_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh((torch.device("cpu"), torch.device("meta")))
    with pytest.raises(NotImplementedError, match="item 5g"):
        T.SquarePlanner(mesh=mesh)
    with pytest.raises(NotImplementedError, match="item 5g"):
        T.build_explicit_system(T.coo_negative_laplacian_1d(64), mesh=mesh)


# -- test_24's sharded solves ---------------------------------------------------

def test_sharded_winell_cg_solve(monkeypatch):
    """CG on 4 pieces through K9 per piece matches the gather-ELL's
    trajectory (rtol 1e-9) and JAX's sharded windowed solve."""
    n = 16 * 1024
    coo = banded(n, 200, 3, 29, diag=16.0)
    Aj, At = pair(*coo, n)
    hist = {}
    for no_win in (False, True):
        env = NO_UPGRADE + (("LEGIONSOLVERS_NO_WINELL",) if no_win else ())
        pj, pt = planners(Aj, At, n, 4, env=env, monkeypatch=monkeypatch)
        op = pt.row_partitioned_matrices[0][0]
        assert isinstance(op, T.RowPartitionedMatrix)
        assert (op._win is None) == no_win
        hist[no_win] = T.CGSolver(pt).solve(8).numpy()
        if not no_win:
            hj = np.asarray(J.CGSolver(pj).solve(8))
    np.testing.assert_allclose(hist[False], hist[True], rtol=1e-9)
    np.testing.assert_allclose(hist[False], hj, rtol=1e-9)


def test_sharded_reordered_solve(monkeypatch):
    """A scrambled banded system on 4 pieces re-bands (RCM) onto the
    sharded windowed path; the solve matches the un-upgraded gather-ELL
    solve (history rtol 1e-9, x rtol 1e-8) and JAX's."""
    n = 16 * 1024
    Aj, At = pair(*scrambled(n), n)
    pj, pt = planners(Aj, At, n, 4)
    op = pt.row_partitioned_matrices[0][0]
    assert chain(op) == ["ReorderedOperator", "RowPartitionedMatrix"]
    assert op.base._win is not None and op.base.mesh is not None
    h_w = T.CGSolver(pt).solve(8).numpy()
    x_w = pt.sol_vectors[0].to_numpy()
    _, pe = planners(Aj, At, n, 4, env=NO_UPGRADE + (
        "LEGIONSOLVERS_NO_WINELL",), monkeypatch=monkeypatch)
    h_e = T.CGSolver(pe).solve(8).numpy()
    x_e = pe.sol_vectors[0].to_numpy()
    np.testing.assert_allclose(h_w, h_e, rtol=1e-9)
    np.testing.assert_allclose(x_w, x_e, rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(h_w, np.asarray(J.CGSolver(pj).solve(8)),
                               rtol=1e-9)
    # eager steps outside the basis agree with the solve inside it
    _, p2 = planners(Aj, At, n, 4)
    s2 = T.CGSolver(p2)
    for _ in range(3):
        s2.step()
    np.testing.assert_allclose(
        [s.get_value() for s in s2.residual_norm_squared], h_w[:4],
        rtol=1e-10)


# -- the other solvers on explicit pieces (test_06, test_07, test_12, test_16) -

def asym_1d(n, offs):
    a = J.create_coo_stencil_matrix((n,), offs, options=F64J)
    return a, T.COOMatrix(np.asarray(a.rows), np.asarray(a.cols),
                          np.asarray(a.vals), n, n, options=F64)


def test_bicgstab_on_pieces_matches_recurrence():
    """test_06: asymmetric 1-D operator on 4 pieces (DIA on pieces) against
    the transcribed recurrence (rtol 1e-7) and JAX's on mesh4."""
    from tests.test_06_bicgstab import reference_bicgstab

    n = 64
    Aj, At = asym_1d(n, [((0,), 2.5), ((-1,), -1.5), ((1,), -0.5)])
    pj, pt = planners(Aj, At, n, 4)
    assert chain(pt.row_partitioned_matrices[0][0]) == ["DiaOperator"]
    hist = T.BiCGStabSolver(pt).solve(12).numpy()
    _, ref = reference_bicgstab(At.to_dense(), np.ones(n), 12)
    np.testing.assert_allclose(hist, ref, rtol=1e-7)
    np.testing.assert_allclose(hist, np.asarray(
        J.BiCGStabSolver(pj).solve(12)), rtol=1e-7)


@pytest.mark.parametrize("route", list(ROUTES))
def test_bicgstab_on_pieces_solves_spd(route):
    n = 100
    pj, pt = golden_planners("coo", 4, route)
    hist = T.BiCGStabSolver(pt).solve(120).numpy()
    x = pt.sol_vectors[0].to_numpy()
    A = T.coo_negative_laplacian_1d(n, options=F64).to_dense()
    r = np.ones(n) - A @ x
    assert r @ r < 1e-16 and hist[-1] < 1e-16


def test_bicgstab_on_pieces_eager_matches_solve():
    n = 40
    ps = [planners(J.coo_negative_laplacian_1d(n, options=F64J),
                   T.coo_negative_laplacian_1d(n, options=F64), n, 4)[1]
          for _ in range(2)]
    s1 = T.BiCGStabSolver(ps[0])
    for _ in range(5):
        s1.step()
    T.BiCGStabSolver(ps[1]).solve(5)
    np.testing.assert_allclose(ps[0].sol_vectors[0].to_numpy(),
                               ps[1].sol_vectors[0].to_numpy(), rtol=1e-13)


@pytest.mark.parametrize("route", list(ROUTES))
def test_gmres_on_pieces(route):
    """test_07: restarted GMRES(10) on 4 pieces, monotone with a
    consistent residual; the history against JAX's (rtol 1e-9)."""
    n = 64
    Aj = J.coo_negative_laplacian_1d(n, options=F64J)
    At = T.coo_negative_laplacian_1d(n, options=F64)
    pj, pt = planners(Aj, At, n, 4, prefer_dia=ROUTES[route])
    hist = T.GMRESSolver(pt, restart=10).solve(12).numpy()
    assert np.all(np.diff(hist) <= 1e-12)
    x = pt.sol_vectors[0].to_numpy()
    r = np.ones(n) - At.to_dense() @ x
    assert np.isclose(r @ r, hist[-1], rtol=1e-8, atol=1e-20)
    assert hist[-1] < 0.1 * hist[0]
    np.testing.assert_allclose(
        hist, np.asarray(J.GMRESSolver(pj, restart=10).solve(12)), rtol=1e-9)


def test_gmres_on_pieces_asymmetric():
    n = 48
    Aj, At = asym_1d(n, [((0,), 3.0), ((-1,), -2.0), ((1,), -0.5)])
    _, pt = planners(Aj, At, n, 4)
    T.GMRESSolver(pt, restart=8).solve(10)
    x = pt.sol_vectors[0].to_numpy()
    r = np.ones(n) - At.to_dense() @ x
    assert r @ r < 1e-16


def variable_diag(n):
    rng = np.random.default_rng(7)
    d = rng.uniform(3.0, 100.0, n)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([d, -np.ones(n - 1), -np.ones(n - 1)])
    return pair(rows, cols, vals, n)


@pytest.mark.parametrize("route", list(ROUTES))
def test_pcg_on_pieces(route):
    """test_12: Jacobi PCG on 4 pieces (the diagonal read from the sharded
    DIA or ELL operator) solves and beats CG; its inverse diagonal and
    history equal JAX's (rtol 1e-12)."""
    n, its = 96, 20
    Aj, At = variable_diag(n)
    pj, pt = planners(Aj, At, n, 4, prefer_dia=ROUTES[route])
    h_cg = T.CGSolver(pt).solve(its).numpy()
    pj, pt = planners(Aj, At, n, 4, prefer_dia=ROUTES[route])
    Mt, Mj = T.JacobiPreconditioner(pt), J.JacobiPreconditioner(pj)
    np.testing.assert_array_equal(Mt.inv_diags[0].numpy(),
                                  np.asarray(Mj.inv_diags[0]))
    h = T.PCGSolver(pt, Mt).solve(its).numpy()
    x = pt.sol_vectors[0].to_numpy()
    r = np.ones(n) - At.to_dense() @ x
    assert np.isclose(r @ r, h[-1], rtol=1e-8, atol=1e-25)
    assert h[-1] < h_cg[-1] * 1e-2
    np.testing.assert_allclose(
        h, np.asarray(J.PCGSolver(pj, Mj).solve(its)), rtol=1e-9,
        atol=1e-20 * h[0])


def test_pcg_jacobi_in_the_basis_on_pieces():
    """A reordered system on 4 pieces: the inverse diagonal in the
    original basis equals JAX's, and the one in the solver basis is its
    permutation."""
    n = 16 * 1024
    Aj, At = pair(*scrambled(n), n)
    _, pt = planners(Aj, At, n, 4)
    M = T.JacobiPreconditioner(pt)
    perm = pt.basis_perms[0]["perm_np"]
    d = np.zeros(n)
    on = At.rows == At.cols
    np.add.at(d, At.rows[on], At.vals[on])
    np.testing.assert_array_equal(M.inv_diags[0].numpy()[:n], 1.0 / d)
    np.testing.assert_array_equal(M.inv_diags_basis[0].numpy()[:n],
                                  1.0 / d[perm])


def test_pcg_on_pieces_eager_matches_solve():
    n = 64
    Aj, At = variable_diag(n)
    ps = [planners(Aj, At, n, 4)[1] for _ in range(2)]
    s1 = T.PCGSolver(ps[0], T.JacobiPreconditioner(ps[0]))
    for _ in range(5):
        s1.step()
    T.PCGSolver(ps[1], T.JacobiPreconditioner(ps[1])).solve(5)
    np.testing.assert_allclose(ps[0].sol_vectors[0].to_numpy(),
                               ps[1].sol_vectors[0].to_numpy(), rtol=1e-12)


@pytest.mark.parametrize("route", list(ROUTES))
def test_block_cg_explicit_on_pieces(route):
    """test_16 (explicit, pieces=4): the same matrix on two spaces doubles
    the golden exactly, both blocks equal."""
    pj, pt = planners(J.coo_negative_laplacian_1d(100, options=F64J),
                      T.coo_negative_laplacian_1d(100, options=F64), 100, 4,
                      prefer_dia=ROUTES[route], spaces=2)
    assert T.CGSolver(pt).solve(10).tolist() == [2 * g for g in GOLDEN]
    np.testing.assert_array_equal(pt.get_vector(0, 0).to_numpy(),
                                  pt.get_vector(0, 1).to_numpy())


def test_block_bicgstab_explicit_on_pieces():
    n = 100
    _, pt = planners(J.coo_negative_laplacian_1d(n, options=F64J),
                     T.coo_negative_laplacian_1d(n, options=F64), n, 4,
                     spaces=2)
    T.BiCGStabSolver(pt).solve(80)
    A = T.coo_negative_laplacian_1d(n, options=F64).to_dense()
    for i in range(2):
        x = pt.get_vector(0, i).to_numpy()
        assert np.linalg.norm(np.ones(n) - A @ x) < 1e-6


# -- entry and convert ----------------------------------------------------------

def test_build_explicit_system_on_pieces():
    A = T.coo_negative_laplacian_1d(100, options=F64)
    pl = T.build_explicit_system(A, F64, mesh=cpu_mesh(4))
    assert pl.mesh is not None and pl.canonical_partitions[0].num_pieces == 4
    assert pl.row_partitioned_matrices[0][0].mesh is pl.mesh
    assert T.CGSolver(pl).solve(10).tolist() == GOLDEN
    # pieces without a mesh: the padded block layout on one device
    pl1 = T.build_explicit_system(A, F64, device=DEV, pieces=4)
    assert pl1.mesh is None
    assert chain(pl1.row_partitioned_matrices[0][0]) == [
        "RowPartitionedMatrix"]
    assert T.CGSolver(pl1).solve(10).tolist() == GOLDEN


@pytest.mark.parametrize("route", list(ROUTES))
def test_continue_jax_4piece_solve(route, mesh4):
    """JAX takes four eager steps on mesh4; ``convert.explicit_cg_system``
    carries the state across onto 4 CPU shards and the port's solve
    continues JAX's trajectory (f64 rtol 1e-12)."""
    n = 96
    Aj, At = variable_diag(n)
    part = J.BlockPartition(n, 4)
    pj = J.SquarePlanner(mesh=mesh4, options=F64J)
    pj.add_sol_vector(J.PartitionedVector("s", part, mesh=mesh4,
                                          options=F64J).zero_fill())
    pj.add_rhs_vector(J.PartitionedVector("b", part, mesh=mesh4,
                                          options=F64J).constant_fill(1.0))
    pj.add_row_partitioned_matrix(Aj, 0, 0, prefer_dia=ROUTES[route])
    sj = J.CGSolver(pj)
    for _ in range(4):
        sj.step()
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k != "ops"}
    rr = [float(s.value) for s in sj.residual_norm_squared]
    pt, st = convert.explicit_cg_system(
        At.rows, At.cols, At.vals, n, state, rr, options=F64,
        prefer_dia=ROUTES[route], mesh=cpu_mesh(4))
    assert chain(pt.row_partitioned_matrices[0][0]) == chain(
        pj.row_partitioned_matrices[0][0])
    h_t = st.solve(8).numpy()
    h_j = np.asarray(sj.solve(8))
    np.testing.assert_allclose(h_t, h_j, rtol=1e-12)
    np.testing.assert_allclose(pt.sol_vectors[0].to_numpy(),
                               pj.sol_vectors[0].to_numpy(), rtol=1e-12)


def test_continue_jax_4piece_reordered_solve(mesh4):
    """The same across a reordered basis on pieces: JAX's basis adopted
    through the forced path, the operator chain JAX's."""
    n = 16 * 1024
    Aj, At = pair(*scrambled(n), n)
    part = J.BlockPartition(n, 4)
    pj = J.SquarePlanner(mesh=mesh4, options=F64J)
    pj.add_sol_vector(J.PartitionedVector("s", part, mesh=mesh4,
                                          options=F64J).zero_fill())
    pj.add_rhs_vector(J.PartitionedVector("b", part, mesh=mesh4,
                                          options=F64J).constant_fill(1.0))
    pj.add_row_partitioned_matrix(Aj, 0, 0)
    sj = J.CGSolver(pj)
    sj.solve(3)
    state = {k: tuple(np.asarray(a) for a in v)
             for k, v in pj.dump_state().items() if k != "ops"}
    rr = [float(s.value) for s in sj.residual_norm_squared]
    pt, st = convert.explicit_cg_system(
        At.rows, At.cols, At.vals, n, state, rr, options=F64,
        perm=pj.basis_perms[0]["perm_np"], mesh=cpu_mesh(4))
    assert chain(pt.row_partitioned_matrices[0][0]) == chain(
        pj.row_partitioned_matrices[0][0])
    np.testing.assert_allclose(st.solve(5).numpy(),
                               np.asarray(sj.solve(5)), rtol=1e-12)
    np.testing.assert_allclose(pt.sol_vectors[0].to_numpy(),
                               pj.sol_vectors[0].to_numpy(), rtol=1e-12,
                               atol=1e-15)
