"""Public names of the JAX package that the port adds for parity, held
against their JAX counterparts on the same numpy inputs (float64 where the
functions compute): ``RowPartitionedMatrix.rmatvec``/``nnz``/
``num_pieces``, ``StencilOperator``'s explicit-operator interface, and the
host-layer, sparse-product, compensated-sum, roofline and host-helper
names (the counterparts of test_03, test_10 and test_25)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu import options as JO
from legionsolvers_tpu.native import bindings as JB
from legionsolvers_tpu.ops import ddsum as JD
from legionsolvers_tpu.ops import spmv as JS
from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix as JRPM
from legionsolvers_tpu.parallel.stencil_op import StencilOperator as JSO
from legionsolvers_tpu.utils import roofline as JR
from legionsolvers_tpu_torch import options as TO
from legionsolvers_tpu_torch.native import bindings as TB
from legionsolvers_tpu_torch.ops import ddsum as TD
from legionsolvers_tpu_torch.ops import spmv as TS
from legionsolvers_tpu_torch.utils import roofline as TR

torch.set_num_threads(2)

DEV = "cpu"
F64 = T.SolverOptions(entry_dtype=torch.float64)
F64J = J.SolverOptions(entry_dtype=jnp.float64)
ASYM = [((0,), 2.0), ((-1,), -1.5), ((1,), -0.5)]  # test_10's system


# -- P1: RowPartitionedMatrix -------------------------------------------------

def test_rowpartitioned_rmatvec_matches_jax():
    """test_10's asymmetric 1-D system on one piece: the transpose product
    against the dense transpose and against JAX's unsharded rmatvec."""
    n = 64
    At = T.create_coo_stencil_matrix((n,), ASYM, options=F64)
    Aj = J.create_coo_stencil_matrix((n,), ASYM, options=F64J)
    pt, pj = T.BlockPartition(n, 1), J.BlockPartition(n, 1)
    dt = T.RowPartitionedMatrix(At, pt, pt, options=F64, device=DEV)
    dj = JRPM(Aj, pj, pj, None, options=F64J)
    x = np.random.default_rng(5).random(n)
    y = dt.rmatvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y[:n], At.to_dense().T @ x, rtol=1e-12)
    np.testing.assert_allclose(y, np.asarray(dj.rmatvec(jnp.asarray(x))),
                               rtol=1e-12)
    assert (dt.nnz(), dt.num_pieces) == (dj.nnz(), dj.num_pieces) == (
        3 * n - 2, 1)


@pytest.mark.parametrize("n,pieces", [(10, 3), (7, 8)])
def test_rowpartitioned_rmatvec_padded(n, pieces):
    """A padded multi-piece partition (run on one device): the padding of
    the result stays zero and the rest is the dense transpose."""
    A = T.create_coo_stencil_matrix((n,), ASYM, options=F64)
    part = T.BlockPartition(n, pieces)
    d = T.RowPartitionedMatrix(A, part, part, options=F64, device=DEV)
    x = np.zeros(part.padded_size)
    x[:n] = np.random.default_rng(6).random(n)
    y = d.rmatvec(torch.from_numpy(x)).numpy()
    assert y.shape == (part.padded_size,) and d.num_pieces == pieces
    np.testing.assert_allclose(y[:n], A.to_dense().T @ x[:n], rtol=1e-12)
    np.testing.assert_array_equal(y[n:], 0.0)


# -- P2: StencilOperator ------------------------------------------------------

@pytest.mark.parametrize("shape,dim", [((16, 24), 2), ((6, 7, 8), 3)])
def test_stencil_operator_to_coo_matches_jax(shape, dim):
    """The 2-D 5-point and 3-D 7-point operators: n_domain, n_range, nnz and
    the sorted (rows, cols, vals) of to_coo() equal JAX's."""
    ot = T.StencilOperator(shape, T.laplacian_stencil(dim), options=F64,
                           device=DEV)
    oj = JSO(shape, J.laplacian_stencil(dim), options=F64J)
    n = int(np.prod(shape))
    assert (ot.n_domain, ot.n_range, ot.nnz()) == (
        oj.n_domain, oj.n_range, oj.nnz())
    assert ot.n_domain == n and ot.nnz() == T.calculate_stencil_size(
        shape, T.laplacian_stencil(dim))
    ct, cj = ot.to_coo(), oj.to_coo()
    assert (ct.n_range, ct.n_domain, ct.n_kernel) == (
        cj.n_range, cj.n_domain, cj.n_kernel) == (n, n, ot.nnz())
    ot_ = np.lexsort((ct.cols, ct.rows))
    oj_ = np.lexsort((cj.cols, cj.rows))
    np.testing.assert_array_equal(ct.rows[ot_], cj.rows[oj_])
    np.testing.assert_array_equal(ct.cols[ot_], cj.cols[oj_])
    np.testing.assert_array_equal(np.asarray(ct.vals)[ot_],
                                  np.asarray(cj.vals)[oj_])


# -- P4: the host layer --------------------------------------------------------

def test_linearized_csr_alias_matches_jax():
    assert T.create_linearized_csr_stencil_matrix is T.create_csr_stencil_matrix
    At = T.create_linearized_csr_stencil_matrix((5, 7), T.laplacian_stencil(2))
    Aj = J.create_linearized_csr_stencil_matrix((5, 7), J.laplacian_stencil(2))
    for a, b in (("indptr",) * 2, ("cols",) * 2, ("vals",) * 2):
        np.testing.assert_array_equal(getattr(At, a), getattr(Aj, b))


@pytest.mark.parametrize("n", [1, 2, 20])
def test_csr_row_rects_match_jax(n):
    """test_03's 1-D Laplacian: (first, last) kernel index per row."""
    At, Aj = T.csr_negative_laplacian_1d(n), J.csr_negative_laplacian_1d(n)
    np.testing.assert_array_equal(At.row_rects(), Aj.row_rects())
    if n > 2:
        assert At.row_rects()[0].tolist() == [0, 1]
        assert At.row_rects()[n - 1].tolist() == [3 * n - 4, 3 * n - 3]


def test_csr_row_rects_of_an_empty_row():
    A = T.CSRMatrix(np.array([0, 1, 1, 2]), np.array([0, 2]),
                    np.array([1.0, 2.0]), 3, 3)
    assert A.row_rects().tolist() == [[0, 0], [1, 0], [1, 1]]


@pytest.mark.parametrize("fmt", ["coo", "csr"])
def test_apply_add_matches_jax(fmt):
    mk = {"coo": "create_coo_stencil_matrix",
          "csr": "create_csr_stencil_matrix"}[fmt]
    At = getattr(T, mk)((6, 5), T.laplacian_stencil(2), options=F64)
    Aj = getattr(J, mk)((6, 5), J.laplacian_stencil(2), options=F64J)
    rng = np.random.default_rng(8)
    x, y = rng.standard_normal(30), rng.standard_normal(30)
    got = At.apply_add(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(Aj.apply_add(jnp.asarray(y), jnp.asarray(x))),
        rtol=1e-12)
    np.testing.assert_allclose(got, y + At.to_dense() @ x, rtol=1e-12)


def _printed(capsys, fn):
    fn()
    return capsys.readouterr().out


def test_prints_match_jax(capsys):
    """Scalar, vector, COO and CSR debug dumps print what JAX's print."""
    At = T.create_coo_stencil_matrix((3,), T.laplacian_stencil(1))
    Aj = J.create_coo_stencil_matrix((3,), J.laplacian_stencil(1))
    pairs = [(At.print, Aj.print),
             (At.to_csr().print, Aj.to_csr().print),
             (T.Scalar(torch.tensor(2.5)).print,
              J.Scalar(jnp.asarray(2.5)).print)]
    x = np.array([1.0, -2.0, 0.25])
    vt = T.PartitionedVector.from_array("v", x, T.BlockPartition(3, 2),
                                        options=F64, device=DEV)
    vj = J.PartitionedVector.from_array("v", x, J.BlockPartition(3, 2),
                                        options=F64J)
    pairs.append((vt.print, vj.print))
    for ft, fj in pairs:
        out = _printed(capsys, ft)
        assert out and out == _printed(capsys, fj)
    assert T.Scalar(torch.tensor(1.0)).print("token") == "token"


@pytest.mark.parametrize("grid", [False, True])
def test_vector_copy_and_refill_constant_match_jax(grid):
    """copy() owns its data (an in-place change of one leaves the other);
    refill_constant fills the true entries and keeps the padding zero."""
    n, pieces = (12, 1) if grid else (10, 3)
    gs = (3, 4) if grid else None
    x = np.random.default_rng(9).standard_normal(n)
    vt = T.PartitionedVector.from_array("v", x, T.BlockPartition(n, pieces),
                                        options=F64, grid_shape=gs,
                                        device=DEV)
    vj = J.PartitionedVector.from_array("v", x, J.BlockPartition(n, pieces),
                                        options=F64J, grid_shape=gs)
    ct, cj = vt.copy("w"), vj.copy("w")
    assert (ct.name, ct.grid_shape) == (cj.name, cj.grid_shape)
    np.testing.assert_array_equal(ct.to_numpy(), np.asarray(cj.to_numpy()))
    assert ct.data.data_ptr() != vt.data.data_ptr()
    vt.data.mul_(2.0)
    np.testing.assert_array_equal(ct.to_numpy(), x)
    assert vt.copy().name == "v"
    vt.refill_constant(3.5)
    vj.refill_constant(3.5)
    np.testing.assert_array_equal(vt.data.numpy(), np.asarray(vj.data))
    assert vt.data.dtype == torch.float64 and vt.data.shape == tuple(
        vj.data.shape)


def test_options_names_match_jax():
    assert TO.SHARD_AXIS == JO.SHARD_AXIS
    assert TO.CHECK_BOUNDS == JO.CHECK_BOUNDS
    for x, m in ((0, 8), (1, 8), (8, 8), (9, 8), (1000, 128), (5, 1)):
        assert TO.round_up(x, m) == JO.round_up(x, m)


def test_host_helpers_match_jax():
    shape, offs = [5, 6], [[0, 0], [1, -1], [-2, 0], [0, 7]]
    assert TB.stencil_size(shape, offs) == JB.stencil_size(shape, offs)
    rows = np.random.default_rng(10).integers(0, 9, 40)
    np.testing.assert_array_equal(TB.build_indptr(rows, 12),
                                  JB.build_indptr(rows, 12))
    assert TB.available() is False
    assert TB.stencil_fill_coo(shape, offs, [1.0] * 4) is None


# -- P4: sparse products, compensated sums, roofline ---------------------------

def test_spmv_coo_add_matches_jax():
    rng = np.random.default_rng(11)
    n, k = 50, 300
    rows, cols = rng.integers(0, n, k), rng.integers(0, n, k)
    vals, x, y = rng.standard_normal(k), rng.standard_normal(n), \
        rng.standard_normal(n)
    yt = torch.from_numpy(y.copy())
    got = TS.spmv_coo_add(torch.from_numpy(rows), torch.from_numpy(cols),
                          torch.from_numpy(vals), torch.from_numpy(x), yt)
    want = JS.spmv_coo_add(jnp.asarray(rows), jnp.asarray(cols),
                           jnp.asarray(vals), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_array_equal(yt.numpy(), y)  # y is not changed


def test_spmv_dia_matches_jax():
    rng = np.random.default_rng(12)
    n, offsets = 40, (-7, -1, 0, 3, 39)
    diags = rng.standard_normal((len(offsets), n))
    x = rng.standard_normal(n)
    got = TS.spmv_dia(offsets, torch.from_numpy(diags), torch.from_numpy(x))
    want = JS.spmv_dia(offsets, jnp.asarray(diags), jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-14)
    dense = np.zeros((n, n))
    for k, off in enumerate(offsets):
        for i in range(max(0, -off), min(n, n - off)):
            dense[i, i + off] = diags[k, i]
    np.testing.assert_allclose(got.numpy(), dense @ x, rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("shape", [(8, 512), (3, 5), (16, 384), (1, 1)])
def test_dd_sum_2d_and_dot_tile_match_jax(shape):
    """test_25's pair: the (hi, lo) results equal JAX's bit for bit (the
    same error-free transformations in the same fold order), and the pair
    holds the float64 dot to ~2x f32's bits."""
    rng = np.random.default_rng(13)
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    ht, lt_ = TD.dd_dot_tile(torch.from_numpy(a), torch.from_numpy(b))
    hj, lj = JD.dd_dot_tile(jnp.asarray(a), jnp.asarray(b))
    assert (ht.item(), lt_.item()) == (float(hj), float(lj))
    exact = np.dot(a.reshape(-1).astype(np.float64),
                   b.reshape(-1).astype(np.float64))
    assert abs(np.float64(ht.item()) + np.float64(lt_.item()) - exact) <= \
        1e-12 * np.abs(a.astype(np.float64) * b).sum()
    h = rng.standard_normal(shape).astype(np.float32)
    lo = (h * np.float32(1e-9)).astype(np.float32)
    st = TD.dd_sum_2d(torch.from_numpy(h), torch.from_numpy(lo))
    sj = JD.dd_sum_2d(jnp.asarray(h), jnp.asarray(lo))
    assert (st[0].item(), st[1].item()) == (float(sj[0]), float(sj[1]))


def test_dd_dot_tile_keeps_the_cancelled_term():
    """test_25's cancellation: the pair recovers a 1e-3 dot whose terms
    cancel to 1e-8 of their magnitude."""
    rng = np.random.default_rng(1)
    z = rng.standard_normal(4095).astype(np.float32)
    w = rng.standard_normal(4095).astype(np.float32)
    x = np.concatenate([z, z, np.float32([1.0, 0.0])])
    y = np.concatenate([w, -w, np.float32([1e-3, 0.0])])
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    hi, lo = TD.dd_dot_tile(torch.from_numpy(x).reshape(-1, 512),
                            torch.from_numpy(y).reshape(-1, 512))
    assert abs(np.float64(hi.item()) + np.float64(lo.item()) - exact) \
        / exact < 1e-7


@pytest.mark.parametrize("itemsize", [4, 8])
def test_roofline_bytes_match_jax(itemsize):
    for schedule in JR.CG_PASSES:
        assert TR.cg_bytes_per_unknown(schedule, itemsize) == \
            JR.cg_bytes_per_unknown(schedule, itemsize)
    for fused in (True, False):
        assert TR.bicgstab_bytes_per_unknown(itemsize, fused) == \
            JR.bicgstab_bytes_per_unknown(itemsize, fused)
    for m in (1, 5, 10, 30):
        assert TR.gmres_bytes_per_cycle_per_unknown(m, itemsize) == \
            JR.gmres_bytes_per_cycle_per_unknown(m, itemsize)
