"""The port's windowed-ELL path (K9, ``plan_winell``, ``plan_winell_classes``,
``WinEllOperator``, ``SlicedWinEllOperator``) against the JAX package and
scipy: test_24's windowed-ELL cases.

The host plans are the JAX package's numpy code, so they must match it bit
for bit.  K9's plain version (the port's CPU path) is held against JAX's
interpret-mode Pallas kernel on the same plan and against scipy: f64 to
rtol 1e-11, f32 to rtol 1e-5 (the slots are summed in the same order in
both, but XLA on the CPU may contract a product and a sum into an FMA).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from legionsolvers_tpu.ops.pallas.winell import winell_spmv as j_winell
from legionsolvers_tpu.parallel import winell_op as JW
from legionsolvers_tpu_torch import BlockPartition, SolverOptions
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TS
from legionsolvers_tpu_torch.ops.cuda import winell as TK
from legionsolvers_tpu_torch.parallel import winell_op as TW

torch.set_num_threads(2)

DEV = "cpu"
F64 = SolverOptions(entry_dtype=torch.float64)
F32 = SolverOptions(entry_dtype=torch.float32)


class M:
    """A bare COO matrix (the JAX tests' stand-in)."""

    def __init__(self, rows, cols, vals, n):
        self.rows, self.cols, self.vals = rows, cols, vals
        self.n_domain = self.n_range = n
        self.n_kernel = len(rows)


def _random_banded(n, bw, avg, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n * avg)
    cols = rows + rng.integers(-bw, bw + 1, n * avg)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    return rows, cols, rng.uniform(-1.0, 1.0, len(rows))


def _graded(n=32768, bw=512, seed=3):
    rng = np.random.default_rng(seed)
    deg = (3 + 24 * (np.arange(n) / n)).astype(np.int64)
    rows = np.repeat(np.arange(n), deg)
    cols = rows + rng.integers(-bw, bw + 1, len(rows))
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    return rows, cols, rng.uniform(-1, 1, len(rows))


def _csr(rows, cols, vals, n):
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def _assert_plans_equal(p, q):
    assert p.keys() == q.keys()
    for k in p:
        if isinstance(p[k], np.ndarray):
            assert p[k].dtype == q[k].dtype, k
            np.testing.assert_array_equal(p[k], q[k], err_msg=k)
        else:
            assert p[k] == q[k], k


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", [(5000, 700, 7, 3), (4096, 160, 4, 7),
                                  (20000, 60, 9, 5)])
def test_plan_winell_matches_jax(case, dtype):
    n, bw, avg, seed = case
    rows, cols, vals = _random_banded(n, bw, avg, seed)
    args = (rows, cols, vals, n, n, dtype)
    p, q = TW.plan_winell(*args), JW.plan_winell(*args)
    assert p is not None and q is not None
    _assert_plans_equal(p, q)
    for rt in (8, 32):
        _assert_plans_equal(TW.plan_winell(*args, tile_rows_of_128=rt),
                            JW.plan_winell(*args, tile_rows_of_128=rt))


def test_plan_winell_gates_match_jax():
    """Too wide a band (window cap) and too low a fill: None in both."""
    rows, cols, vals = _random_banded(32768, 8000, 4, 1)
    args = (rows, cols, vals, 32768, 32768, np.float64)
    assert TW.plan_winell(*args) is None and JW.plan_winell(*args) is None
    rows = np.concatenate([np.zeros(100, np.int64), np.arange(4096)])
    cols = np.concatenate([np.arange(100), np.arange(4096)])
    vals = np.ones(len(rows))
    args = (rows, cols, vals, 4096, 4096, np.float64)
    assert TW.plan_winell(*args) is None and JW.plan_winell(*args) is None


@pytest.mark.parametrize("which", ["graded", "iid"])
def test_plan_winell_classes_matches_jax(which):
    if which == "graded":
        rows, cols, vals = _graded()
    else:
        rows, cols, vals = _random_banded(32768, 512, 8, 5)
    args = (rows, cols, vals, 32768, 32768, np.float64)
    p, q = TW.plan_winell_classes(*args), JW.plan_winell_classes(*args)
    assert ("classes" in p) == ("classes" in q) == (which == "graded")
    if which == "iid":
        _assert_plans_equal(p, q)
        return
    assert p["nb"] == q["nb"] and len(p["classes"]) == len(q["classes"])
    for k in ("block_src", "newpos"):
        np.testing.assert_array_equal(p[k], q[k])
    for (nb_p, cp), (nb_q, cq) in zip(p["classes"], q["classes"]):
        assert nb_p == nb_q
        _assert_plans_equal(cp, cq)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k9_plain_matches_jax_kernel(dtype):
    n = 2048
    rows, cols, vals = _random_banded(n, 200, 4, 3)
    plan = JW.plan_winell(rows, cols, vals, n, n, dtype)
    x = np.random.default_rng(0).standard_normal(plan["N"]).astype(dtype)
    x[n:] = 0
    want = np.asarray(j_winell(
        jnp.asarray(x).reshape(-1, 128), jnp.asarray(plan["wstart"]),
        jnp.asarray(plan["cols"]), jnp.asarray(plan["vals"]),
        window_rows=plan["window_rows"], interpret=True))
    got = TK.winell_spmv(
        torch.from_numpy(x).reshape(-1, 128),
        torch.from_numpy(plan["wstart"]), torch.from_numpy(plan["cols"]),
        torch.from_numpy(plan["vals"]), window_rows=plan["window_rows"])
    assert got.dtype == torch.from_numpy(x).dtype
    rtol = 1e-11 if dtype == np.float64 else 1e-5
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * scale)
    ref = _csr(rows, cols, vals, n) @ x[:n].astype(np.float64)
    np.testing.assert_allclose(got.numpy().reshape(-1)[:n], ref, rtol=rtol,
                               atol=rtol * scale)
    assert sum(TS.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["dtype", "window", "wstart", "contiguity"])
def test_k9_checks_inputs(bad):
    x = torch.zeros(64, 128)
    ws = torch.zeros(8, 2, dtype=torch.int32)
    cols = torch.zeros(1, 2, 8, 128, dtype=torch.int32)
    vals = torch.zeros(1, 2, 8, 128)
    kw = dict(window_rows=8)
    call = {
        "dtype": lambda: TK.winell_spmv(x, ws, cols, vals.double(), **kw),
        "window": lambda: TK.winell_spmv(x, ws, cols, vals, window_rows=12),
        "wstart": lambda: TK.winell_spmv(x, ws[:, :1].contiguous(), cols,
                                         vals, **kw),
        "contiguity": lambda: TK.winell_spmv(
            torch.zeros(128, 64).t(), ws, cols, vals, **kw),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        call()


def test_winell_operator_matches_scipy_and_jax():
    n = 5000
    rows, cols, vals = _random_banded(n, 700, 7, 3)
    part = BlockPartition(n, 1)
    op = TW.WinEllOperator(M(rows, cols, vals, n), part, F64, device=DEV)
    x = np.random.default_rng(0).standard_normal(n)
    A = _csr(rows, cols, vals, n)
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A @ x, rtol=1e-12, atol=1e-12)
    z = op.rmatvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(z, A.T @ x, rtol=1e-12, atol=1e-12)
    import legionsolvers_tpu as J

    opj = JW.WinEllOperator(M(rows, cols, vals, n), J.BlockPartition(n, 1),
                            J.SolverOptions(entry_dtype=jnp.float64))
    np.testing.assert_allclose(y, np.asarray(opj.matvec(jnp.asarray(x))),
                               rtol=1e-11, atol=1e-12)
    assert (op.window_rows, op.tile_rows_of_128, op.row_length) == (
        opj._KR, JW.plan_winell(rows, cols, vals, n, n, np.float64,
                                min_fill=0.0)["tile_rows_of_128"],
        opj.row_length)


def test_winell_duplicates_summed():
    n = 2048
    rows = np.array([5, 5, 5, 100, 100])
    cols = np.array([7, 7, 9, 99, 99])
    vals = np.array([1.0, 2.0, 4.0, 8.0, 16.0])
    op = TW.WinEllOperator(M(rows, cols, vals, n), BlockPartition(n, 1), F64,
                           device=DEV)
    x = torch.zeros(n, dtype=torch.float64)
    x[7] = x[9] = x[99] = 1.0
    y = op.matvec(x)
    assert y[5].item() == 7.0 and y[100].item() == 24.0


def test_winell_f32_operator():
    n = 4096
    rows, cols, vals = _random_banded(n, 160, 4, 7)
    op = TW.WinEllOperator(M(rows, cols, vals, n), BlockPartition(n, 1), F32,
                           device=DEV)
    assert op.ell_vals.dtype == torch.float32
    x = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    ref = _csr(rows, cols, vals.astype(np.float32).astype(np.float64), n) \
        @ x.astype(np.float64)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_sliced_winell_degree_coherent():
    """Per-degree-class plans on a graded band: one K9 call per class, the
    1024-row blocks un-shuffled; matvec and rmatvec as scipy's."""
    n = 32768
    rows, cols, vals = _graded(n)
    part = BlockPartition(n, 1)
    plan = TW.plan_winell_classes(rows, cols, vals, n, n, np.float64)
    Ls = [p["row_length"] for _, p in plan["classes"]]
    assert Ls == sorted(Ls, reverse=True) and len(Ls) >= 3
    op = TW.SlicedWinEllOperator(M(rows, cols, vals, n), part, F64,
                                 plan=plan, device=DEV)
    x = np.random.default_rng(0).standard_normal(n)
    A = _csr(rows, cols, vals, n)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               A @ x, rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(op.rmatvec(torch.from_numpy(x)).numpy(),
                               A.T @ x, rtol=1e-11, atol=1e-11)


def test_winell_single_piece_only():
    rows, cols, vals = _random_banded(4096, 160, 4, 7)
    with pytest.raises(ValueError):
        TW.WinEllOperator(M(rows, cols, vals, 4096), BlockPartition(4096, 2),
                          F64, device=DEV)
    with pytest.raises(ValueError):
        TW.SlicedWinEllOperator(M(rows, cols, vals, 4096),
                                BlockPartition(4096, 1), F64, device=DEV)
