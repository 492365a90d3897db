"""The port's routed general SpMV (K10, ``plan_static_gather``,
``GeneralSpmvOperator``, ``degree_sort_perm``) against the JAX package and
scipy: test_28's cases.

The routing plans are the JAX package's numpy code and must match it bit
for bit, down to the operator's index and value arrays.  K10 only gathers
and scales, so its plain version matches JAX's interpret-mode kernel bit
for bit too.  Whole matvecs: rtol 1e-11 against JAX and scipy (f64; the
segment sums run in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.ops.pallas.rowperm import blockperm_gather as j_bp
from legionsolvers_tpu.parallel import genspmv as JG
from legionsolvers_tpu_torch.ops.cuda import rowperm as TK
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TS
from legionsolvers_tpu_torch.parallel import genspmv as TG

torch.set_num_threads(2)

DEV = "cpu"
F64 = T.SolverOptions(entry_dtype=torch.float64)
F64J = J.SolverOptions(entry_dtype=jnp.float64)

# (block_rows, src_block_rows, w0_table builder, w_rows): the three hops
HOPS = [
    (64, 8, lambda br: tuple(dl // 8 for dl in range(br)), 1),
    (16, 8, lambda br: tuple(dl // 2 for dl in range(br)), 1),
    (8, 16, lambda br: tuple(dl * 2 for dl in range(br)), 2),
    (24, 24, lambda br: tuple((dl // 8) * 3 for dl in range(br)), 3),
]


def _random_coo(n, avg, seed):
    rng = np.random.default_rng(seed)
    m = n * avg
    return (rng.integers(0, n, m), rng.integers(0, n, m),
            rng.uniform(-1, 1, m))


def _csr(rows, cols, vals, n):
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


@pytest.mark.parametrize("dtype,scaled", [(np.float32, False),
                                          (np.float64, True)])
@pytest.mark.parametrize("hop", range(len(HOPS)))
def test_k10_plain_matches_jax_kernel_bitwise(hop, dtype, scaled):
    brk, srb, mk_tab, w = HOPS[hop]
    rng = np.random.default_rng(hop)
    RD = brk * 3
    src = rng.standard_normal((RD // brk) * srb * 1024).astype(dtype)
    idx = rng.integers(0, w * 1024, (RD, 1024)).astype(np.int32)
    vals = rng.standard_normal((RD, 1024)).astype(dtype) if scaled else None
    tab = mk_tab(brk)
    kw = dict(block_rows=brk, src_block_rows=srb, w0_table=tab, w_rows=w)
    want = np.asarray(j_bp(jnp.asarray(src), jnp.asarray(idx),
                           None if vals is None else jnp.asarray(vals),
                           interpret=True, **kw))
    got = TK.blockperm_gather(torch.from_numpy(src), torch.from_numpy(idx),
                              None if vals is None else torch.from_numpy(vals),
                              **kw)
    assert got.dtype == torch.from_numpy(src).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    assert sum(TS.LAUNCHES.values()) == 0


@pytest.mark.parametrize("bad", ["block_rows", "w0", "src_size", "idx_dtype",
                                 "vals_dtype", "contiguity"])
def test_k10_checks_inputs(bad):
    src = torch.zeros(8 * 1024 * 2)
    idx = torch.zeros(16, 1024, dtype=torch.int32)
    kw = dict(block_rows=8, src_block_rows=8, w0_table=(0,) * 8, w_rows=1)
    call = {
        "block_rows": lambda: TK.blockperm_gather(src, idx, **dict(
            kw, block_rows=12, w0_table=(0,) * 12)),
        "w0": lambda: TK.blockperm_gather(src, idx, **dict(
            kw, w0_table=(8,) * 8)),
        "src_size": lambda: TK.blockperm_gather(src[:8 * 1024], idx, **kw),
        "idx_dtype": lambda: TK.blockperm_gather(src, idx.long(), **kw),
        "vals_dtype": lambda: TK.blockperm_gather(
            src, idx, torch.zeros(16, 1024, dtype=torch.float64), **kw),
        "contiguity": lambda: TK.blockperm_gather(
            src, torch.zeros(1024, 16, dtype=torch.int32).t(), **kw),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        call()


@pytest.mark.parametrize("allow_cap", [True, False])
def test_plan_static_gather_matches_jax(allow_cap):
    rng = np.random.default_rng(3)
    A_rows, D = 64, 200
    src_of_dest = rng.integers(0, A_rows * 1024, D * 1024)
    src_of_dest[rng.random(D * 1024) < 0.3] = -1
    p = TG.plan_static_gather(src_of_dest, A_rows * 1024, allow_cap)
    q = JG.plan_static_gather(src_of_dest, A_rows * 1024, allow_cap)
    assert p.keys() == q.keys()
    for k in p:
        if isinstance(p[k], np.ndarray):
            np.testing.assert_array_equal(p[k], q[k], err_msg=k)
        else:
            assert p[k] == q[k], k


def _both_ops(rows, cols, vals, n):
    a = T.COOMatrix(rows, cols, vals, n, n, options=F64)
    aj = J.COOMatrix(rows, cols, vals, n, n, options=F64J)
    op = TG.GeneralSpmvOperator(a, T.BlockPartition(n, 1), options=F64,
                                device=DEV)
    opj = JG.GeneralSpmvOperator(aj, J.BlockPartition(n, 1), options=F64J)
    return op, opj


@pytest.mark.parametrize("avg", [5, 2])
def test_genspmv_operator_matches_jax(avg):
    """The operator's plan and arrays equal JAX's; matvec and rmatvec as
    JAX's and scipy's."""
    n = 32768
    rows, cols, vals = _random_coo(n, avg, seed=avg)
    op, opj = _both_ops(rows, cols, vals, n)
    assert op._plan == opj._plan and op._ovf_plan == opj._ovf_plan
    assert op._segments == opj._segments
    for k in ("idx1", "idx2", "idx3", "vals3", "diag"):
        np.testing.assert_array_equal(getattr(op, k).numpy(),
                                      np.asarray(getattr(opj, k)), err_msg=k)
    if opj.ovf_idx is not None:
        for a, b in zip(op.ovf_idx, opj.ovf_idx):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    x = np.random.default_rng(0).standard_normal(n)
    S = _csr(rows, cols, vals, n)
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, S @ x, rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(y, np.asarray(opj.matvec(jnp.asarray(x))),
                               rtol=1e-11, atol=1e-11)
    z = op.rmatvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(z, S.T @ x, rtol=1e-11, atol=1e-11)


def test_genspmv_overflow_path_launch_count():
    """A capped plan adds the overflow pipeline: 6 hops per matvec."""
    n = 32768
    rows, cols, vals = _random_coo(n, 5, seed=5)
    op, opj = _both_ops(rows, cols, vals, n)
    assert (op._ovf_plan is not None) == (opj._ovf_plan is not None)
    assert op.launches_per_matvec == (6 if op._ovf_plan else 3)


@pytest.mark.parametrize("avg", [5, 2])
def test_genspmv_matvec_runs_the_planned_hops(avg, monkeypatch):
    """A matvec runs the hops checked at plan time, in pipeline order,
    and checks no hop geometry again."""
    n = 32768
    rows, cols, vals = _random_coo(n, avg, seed=avg)
    op, _ = _both_ops(rows, cols, vals, n)
    ran, real = [], TG.gather_hop

    def record(hop, *a):
        ran.append(hop)
        return real(hop, *a)

    def no_new_hop(*a, **kw):
        raise AssertionError("a hop was checked during the matvec")

    monkeypatch.setattr(TG, "gather_hop", record)
    monkeypatch.setattr(TG, "GatherHop", no_new_hop)
    op.matvec(torch.from_numpy(np.ones(n)))
    want = (op._hops[:2] + (op._ovf_hops or ()) + op._hops[2:])
    assert len(ran) == op.launches_per_matvec == len(want)
    assert all(a is b for a, b in zip(ran, want))


def test_genspmv_duplicates_and_empty_rows():
    n = 32768
    rng = np.random.default_rng(7)
    m = n * 3
    rows = rng.integers(0, n // 2, m)
    cols = rng.integers(0, n, m)
    rows[:200] = rows[0]
    cols[:100] = cols[0]
    vals = rng.uniform(-1, 1, m)
    op = TG.GeneralSpmvOperator(T.COOMatrix(rows, cols, vals, n, n,
                                            options=F64),
                                T.BlockPartition(n, 1), F64, device=DEV)
    x = rng.standard_normal(n)
    np.testing.assert_allclose(op.matvec(torch.from_numpy(x)).numpy(),
                               _csr(rows, cols, vals, n) @ x, rtol=1e-11,
                               atol=1e-11)


def test_degree_sort_perm_matches_jax():
    rows, cols, vals = _random_coo(4096, 3, seed=9)
    a = T.COOMatrix(rows, cols, vals, 4096, 4096, options=F64)
    aj = J.COOMatrix(rows, cols, vals, 4096, 4096, options=F64J)
    np.testing.assert_array_equal(TG.degree_sort_perm(a),
                                  JG.degree_sort_perm(aj))


def _planner(matrix, n, x=None):
    part = T.BlockPartition(n, 1)
    planner = T.SquarePlanner(options=F64, device=DEV)
    sol = (T.PartitionedVector.from_array("s", x, part, options=F64,
                                          device=DEV) if x is not None
           else T.PartitionedVector("s", part, options=F64, device=DEV))
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(T.PartitionedVector(
        "b", part, options=F64, device=DEV).constant_fill(1.0))
    planner.add_row_partitioned_matrix(matrix, 0, 0)
    return planner


def test_planner_routes_rcm_resistant_to_genspmv():
    """Random sparsity: the planner lands on the routed gather in the
    degree-sorted basis, as JAX's does, and the eager (out-of-basis)
    matvec matches scipy."""
    n = 65536
    rows, cols, vals = _random_coo(n, 6, seed=11)
    x = np.random.default_rng(0).standard_normal(n)
    planner = _planner(T.COOMatrix(rows, cols, vals, n, n, options=F64), n, x)
    op = planner.row_partitioned_matrices[0][0]
    assert isinstance(op, T.ReorderedOperator)
    assert isinstance(op.base, T.GeneralSpmvOperator)
    np.testing.assert_array_equal(
        op.perm_np, JG.degree_sort_perm(J.COOMatrix(rows, cols, vals, n, n,
                                                    options=F64J)))
    planner.allocate_workspace(1)
    planner.matvec(2, 0)
    np.testing.assert_allclose(planner.get_vector(2, 0).to_numpy(),
                               _csr(rows, cols, vals, n) @ x, rtol=1e-10,
                               atol=1e-10)


def test_planner_small_matrix_falls_back():
    """Too few source rows for a routing geometry: a clean fallback, as in
    JAX, and a finite solve."""
    n = 32768
    rows, cols, vals = _random_coo(n, 3, seed=11)
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, 12.0)])
    planner = _planner(T.COOMatrix(r, c, v, n, n, options=F64), n)
    op = planner.row_partitioned_matrices[0][0]
    assert isinstance(op, (T.RowPartitionedMatrix, T.ReorderedOperator))
    hist = T.CGSolver(planner).solve(4)
    assert torch.isfinite(hist).all()
