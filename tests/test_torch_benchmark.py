"""The port's benchmark CLI, traffic model and timing harness against the
JAX package's.

``legionsolvers_tpu_torch.benchmark.main([..., "--device", "cpu"])`` and
``legionsolvers_tpu.benchmark.main`` run the same argv (every ``-dim`` and
``-solver`` at small grids, float64): the schedule label and bytes per
unknown must be equal, and the final residual² within rtol 1e-9 (the two
packages run one recurrence and differ only in the order of their sums).
Every function of the port's ``utils/roofline.py`` is held equal to the
JAX one on the same inputs.  The flags the port cannot honour yet raise
``NotImplementedError``, and the marginal timer raises where the JAX one
floors a non-positive difference (fault F1).
"""

import time
import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu import benchmark as JB
from legionsolvers_tpu.solvers.pcg import (
    JacobiPreconditioner as JJacobi,
    PCGSolver as JPCG,
)
from legionsolvers_tpu.utils import roofline as JR
from legionsolvers_tpu_torch import benchmark as TB
from legionsolvers_tpu_torch.utils import roofline as TR
from legionsolvers_tpu_torch.utils import timing

torch.set_num_threads(2)

GRIDS = {1: ["-nx", "64"], 2: ["-nx", "16", "-ny", "16"],
         3: ["-nx", "8", "-ny", "8", "-nz", "8"],
         4: ["-nx", "10", "-ny", "10", "-nz", "10"]}
SHAPES = {2: (16, 128), 3: (4, 8, 128), 4: (4, 8, 128)}
KEYS = ("dim", "solver", "n", "nnz", "pieces", "dtype", "ms_per_iter",
        "gnnz_per_s", "schedule", "bytes_per_unknown", "pct_roofline",
        "roofline_binding", "final_residual2")


def argv(dim, solver, dtype="float64"):
    return ["-dim", str(dim), "-solver", str(solver), *GRIDS[dim], "-it",
            "10", "-restart", "4", "--dtype", dtype]


@pytest.mark.parametrize("solver", [1, 2, 3, 4])
@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_cli_matches_jax(dim, solver, capsys):
    ours = TB.main(argv(dim, solver) + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "Achieved" in out and "roofline" not in out
    ref = JB.main(argv(dim, solver))
    assert tuple(ours) == KEYS and set(ref) == set(KEYS)
    for k in ("dim", "solver", "n", "nnz", "pieces", "dtype", "schedule",
              "bytes_per_unknown", "pct_roofline", "roofline_binding"):
        assert ours[k] == ref[k], k
    assert ours["ms_per_iter"] > 0
    np.testing.assert_allclose(ours["final_residual2"],
                               ref["final_residual2"], rtol=1e-9)
    assert sum(TB.RUNS.values()) >= 2 + 2 * 7 + 1


def _namespace(dim):
    shape = SHAPES[dim]
    nx, ny, nz = (list(shape) + [1, 1])[:3]
    return types.SimpleNamespace(dim=dim, nx=nx, ny=ny, nz=nz, vp=1,
                                 block=False, restart=4)


def _solvers(dim, solver):
    ns = _namespace(dim)
    pj, n, _ = JB.build_planner(ns, None, J.SolverOptions(
        entry_dtype=jnp.float32))
    pt, nt, _ = TB.build_planner(ns, T.SolverOptions(
        entry_dtype=torch.float32), "cpu")
    assert n == nt
    if solver == 1:
        return J.CGSolver(pj), T.CGSolver(pt), n
    if solver == 2:
        return J.BiCGStabSolver(pj), T.BiCGStabSolver(pt), n
    if solver == 3:
        return J.GMRESSolver(pj, 4), T.GMRESSolver(pt, 4), n
    return (JPCG(pj, JJacobi(pj)),
            T.PCGSolver(pt, T.JacobiPreconditioner(pt)), n)


@pytest.mark.parametrize("solver", [1, 2, 3, 4])
@pytest.mark.parametrize("dim", [2, 3, 4])
def test_f32_schedules_match_jax(dim, solver):
    """On the kernel views (f32, 2-D and 3-D) both packages pick the same
    schedule and charge the same bytes."""
    sj, st, n = _solvers(dim, solver)
    assert TR.solver_bytes_per_iteration(st, n) == \
        JR.solver_bytes_per_iteration(sj, n)


def test_dim1_runs_the_linearized_path(capsys):
    """-dim 1 in f32: the JAX package's 1-D kernel view is not ported, so
    the port runs the torch recompute runner and says so."""
    out = TB.main(["-dim", "1", "-nx", "256", "-it", "10", "--device",
                   "cpu"])
    assert out["schedule"] == "fused_jnp"
    assert "ROADMAP item 3" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--block"], ["-vp", "4"],
                                   ["--consume-rhs"],
                                   ["--dtype", "bfloat16"]])
def test_unported_flags_raise(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TB.main(["-dim", "2", "-nx", "16", "-ny", "16", "-it", "4",
                 "--device", "cpu", *flags])


def test_consume_rhs_env_raises(monkeypatch):
    monkeypatch.setenv("LEGIONSOLVERS_CONSUME_RHS", "1")
    with pytest.raises(NotImplementedError, match="item 3"):
        TB.main(["-dim", "2", "-nx", "16", "-ny", "16", "-it", "4",
                 "--device", "cpu"])


def test_card_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TB.main(["-dim", "2", "-nx", "16", "-ny", "16", "-it", "4"])


def test_bench_json_line(monkeypatch, capsys):
    monkeypatch.setenv("LEGIONSOLVERS_BENCH_JSON", "1")
    out = TB.main(["-dim", "2", "-nx", "16", "-ny", "16", "-it", "10",
                   "--device", "cpu", "--bw", "1e9"])
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("BENCH_JSON ")]
    import json

    assert len(line) == 1 and json.loads(line[0][11:]) == out
    # bytes at 1 GB/s: a pct under 100 and the stream roofline
    assert 0 < out["pct_roofline"] <= 100
    assert out["roofline_binding"] == "stream"


def test_impossible_time_is_refused():
    """A bandwidth so high that the schedule's bytes would take longer
    than the measured time: refused (F1), not printed."""
    with pytest.raises(RuntimeError, match="impossible"):
        TB.main(["-dim", "2", "-nx", "16", "-ny", "16", "-it", "10",
                 "--device", "cpu", "--bw", "1e3"])


def test_marginal_raises_on_a_non_positive_difference():
    """F1: a long run no slower than the short one (here faster) is
    measured again over a wider window and then refused."""
    calls = []

    def run(k):
        calls.append(k)
        time.sleep(0.002 if k == 2 else 0.0)

    with pytest.raises(RuntimeError, match="widened"):
        timing.marginal_seconds_per_iter(run, 2, 10, reps=2)
    assert max(calls) == 10 + timing.WIDEN * 8
    with pytest.raises(ValueError):
        timing.marginal_seconds_per_iter(run, 10, 10)


def test_marginal_time_per_iteration():
    sec = timing.marginal_seconds_per_iter(
        lambda k: time.sleep(0.001 * k), 1, 5, reps=3)
    assert 0.0009 < sec < 0.01


# -- utils/roofline.py against the JAX package's ----------------------------

def test_pass_tables_match():
    assert TR.CG_PASSES == JR.CG_PASSES
    for m in range(1, 13):
        assert TR.gmres_passes(m) == JR.gmres_passes(m)
        assert TR.gmres_cgs2_passes(m) == JR.gmres_cgs2_passes(m)


@pytest.mark.parametrize("refresh", [None, "0", "8"])
def test_refresh_passes_match(refresh, monkeypatch):
    if refresh is not None:
        monkeypatch.setenv("LEGIONSOLVERS_SSTEP_REFRESH", refresh)
    assert TR._sstep_refresh_passes() == JR._sstep_refresh_passes()


@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_sstep_compute_model_matches(dim):
    offsets = [o for o, _ in T.laplacian_stencil(dim)]
    values = [v for _, v in T.laplacian_stencil(dim)]
    if dim == 1:
        offsets = [(0, o[0]) for o in offsets]
    elif dim > 2:
        offsets = [(o[1], o[2]) for o in offsets]
    rates = {"vpu_fma_ops_per_s": 6.1e13,
             "vpu_roll_plus_add_reps_per_s": 1.3e12,
             "vpu_row_shift_add_reps_per_s": 9.7e11}
    counts = TR.sstep_vpu_op_counts(offsets, values)
    assert counts == JR.sstep_vpu_op_counts(offsets, values)
    assert (TR.compute_seconds_per_element(counts, rates)
            == JR.compute_seconds_per_element(counts, rates))
    assert (TR.sstep_compute_seconds_per_iteration(offsets, values, 4096**2,
                                                   rates)
            == JR.sstep_compute_seconds_per_iteration(offsets, values,
                                                      4096**2, rates))


def test_explicit_operator_passes_match():
    """operator_matvec_passes and the CG schedule of explicit systems: DIA
    (the 2-D Laplacian), ELL (four pieces, no upgrade)."""
    A = J.create_coo_stencil_matrix((16, 16), J.laplacian_stencil(2),
                                    options=J.SolverOptions(
                                        entry_dtype=jnp.float64))
    coo = (np.asarray(A.rows), np.asarray(A.cols), np.asarray(A.vals))
    f64j = J.SolverOptions(entry_dtype=jnp.float64)
    f64t = T.SolverOptions(entry_dtype=torch.float64)
    for pieces in (1, 4):
        pj = J.SquarePlanner(mesh=None, options=f64j)
        part = J.BlockPartition(256, pieces)
        pj.add_sol_vector(J.PartitionedVector("s", part, options=f64j))
        pj.add_rhs_vector(J.PartitionedVector("b", part, options=f64j))
        pj.add_row_partitioned_matrix(J.core.matrix.COOMatrix(
            *coo, 256, 256, options=f64j), 0, 0)
        pt = T.SquarePlanner(options=f64t, device="cpu")
        part_t = T.BlockPartition(256, pieces)
        pt.add_sol_vector(T.PartitionedVector("s", part_t, options=f64t,
                                              device="cpu"))
        pt.add_rhs_vector(T.PartitionedVector("b", part_t, options=f64t,
                                              device="cpu"))
        pt.add_row_partitioned_matrix(T.COOMatrix(*coo, 256, 256,
                                                  options=f64t), 0, 0)
        oj, ot = pj.row_partitioned_matrices[0][0], \
            pt.row_partitioned_matrices[0][0]
        assert type(oj).__name__ == type(ot).__name__
        assert TR.operator_matvec_passes(ot) == JR.operator_matvec_passes(oj)
        for make_j, make_t in ((J.CGSolver, T.CGSolver),
                               (J.BiCGStabSolver, T.BiCGStabSolver)):
            assert (TR.solver_bytes_per_iteration(make_t(pt), 256)
                    == JR.solver_bytes_per_iteration(make_j(pj), 256))
            pj.workspace_vectors.clear()
            pt.workspace_vectors.clear()
