"""The port's mesh over processes against one process and the JAX package.

The twin of ``tests/test_19_multiprocess.py``: each case starts two OS
processes (``tests/torch_distributed_worker.py``), which join one gloo
group through ``initialize_distributed`` and build a 4-shard mesh of 2
CPU shards each, and runs one system there; the same case functions run
here on a one-process ``make_mesh(4, devices=["cpu"] * 4)``.  Held:

* the f64 n = 100 golden through the planner's DIA upgrade, exactly;
* the 2-D 5-point CG at (64, 128) in f32, s-step and two-pass, and the
  eager matvec with its fused dot: bit for bit the one-process mesh's, on
  both ranks; in f64 (the linearized path) bit for bit too, and against
  the JAX package's 4-device mesh at rtol 1e-4 (``test_torch_sharded.py``'s
  4-piece 2-D twin, ``test_fused_cg_matches_generic_2d``);
* the sharded ELL, windowed and gathered: matvec and rmatvec bit for bit;
  the CG history within rtol 1e-4 of one process and x within 1e-3 (the
  eager dots sum per piece there, over the whole tensor on one process);
* fills, ``to_numpy``, ``random_fill`` and ``dot`` equal to one process
  (dots exactly on integer data);
* every path a process mesh refuses raises NotImplementedError naming
  item 5g, and ``initialize_distributed`` a second time is a no-op.

Each run gives its workers 240 s and kills both on a timeout; a test skips
only when no loopback port binds.
"""

import functools
import os
import socket
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
from legionsolvers_tpu_torch.parallel import mesh as M
from tests import torch_distributed_worker as W

WORKER = os.path.join(os.path.dirname(__file__), "torch_distributed_worker.py")
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]
TIMEOUT_S = 240
# the f32 solve on pieces against another summation order:
# test_torch_sharded_explicit.py's rtol for its f32 solves
ELL_HIST_RTOL = 1e-4
ELL_X_RTOL = 1e-3  # test_torch_sharded.test_fused_cg_overlap_agreement's
JAX_RTOL = 1e-4  # test_torch_sharded.test_fused_cg_matches_generic_2d's


def _free_port() -> int:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("cannot bind local ports in this environment")
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def run_case(case):
    """Both ranks' results of one worker case, ``[rank 0, rank 1]``."""
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="torch_mp_")
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    env["WORKER_TMP"] = tmp
    out = os.path.join(tmp, case)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", str(port), case, out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(logs))
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"worker {r} failed:\n{log[-3000:]}"
        assert f"WORKER_OK {case} {r}/2" in log, log[-3000:]
    res = []
    for r in range(2):
        with np.load(f"{out}.{r}.npz") as f:
            res.append({k: f[k] for k in f.files})
    return res


@functools.lru_cache(maxsize=None)
def one_process(case):
    """The same case on a one-process 4-shard CPU mesh."""
    torch.set_num_threads(1)
    ref = {}
    getattr(W, f"case_{case}")(M.make_mesh(4, devices=["cpu"] * 4), ref)
    return {k: np.asarray(v) for k, v in ref.items()}


def same(a, b) -> bool:
    """Bit for bit: same shape, dtype and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and (
        a.tobytes() == b.tobytes())


def test_initialize_distributed_noop_in_one_process(monkeypatch):
    """Without WORLD_SIZE, or with one process, nothing is initialized."""
    import torch.distributed as dist

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    M.initialize_distributed()
    M.initialize_distributed("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()
    mesh = M.make_mesh(2, devices=["cpu"] * 2)
    assert not mesh.spans_processes and mesh.local_range == (0, 2)


def test_golden_across_processes():
    """JAX's test_19: the n = 100 f64 golden, exactly, on both ranks,
    through the DiaOperator the planner picks; x equals one process's."""
    ref = one_process("golden")
    for r in run_case("golden"):
        assert str(r["operator"]) == "DiaOperator"
        assert r["hist"].tolist() == GOLDEN
        assert same(r["x"], ref["x"])


@pytest.mark.parametrize("schedule", ["sstep", "twopass"])
def test_cg2d_bit_for_bit(schedule):
    """The f32 2-D CG of the main path, s-step and two-pass: history and x
    equal the one-process 4-piece mesh's bit for bit on both ranks."""
    ref = one_process("cg2d")
    ranks = run_case("cg2d")
    assert bool(ref["sstep_eligible"]) and all(
        bool(r["sstep_eligible"]) for r in ranks)
    for r in ranks:
        assert same(r[f"{schedule}_hist"], ref[f"{schedule}_hist"])
        assert same(r[f"{schedule}_x"], ref[f"{schedule}_x"])


def test_cg2d_matvec_bit_for_bit():
    """The f32 kernel-view matvec and its fused dot on pieces: bit for
    bit one process's on both ranks."""
    ref = one_process("cg2d")
    for r in run_case("cg2d"):
        assert same(r["matvec"], ref["matvec"])
        assert same(r["matvec_dot"], ref["matvec_dot"])


def test_cg2d_f64_matches_one_process_and_jax():
    """The f64 2-D CG (the linearized path): bit for bit one process's,
    and against the JAX package's 4-device mesh within rtol 1e-4."""
    from tests.test_torch_sharded import build

    ref = one_process("cg2d")
    planner, _ = build(J, W.SHAPE, 4,
                       options=J.SolverOptions(entry_dtype=jnp.float64))
    hj = np.asarray(J.CGSolver(planner).solve(W.ITERS))
    xj = np.asarray(planner.sol_vectors[0].to_numpy())
    for r in run_case("cg2d"):
        assert same(r["f64_hist"], ref["f64_hist"])
        assert same(r["f64_x"], ref["f64_x"])
        np.testing.assert_allclose(r["f64_hist"], hj, rtol=JAX_RTOL)
        np.testing.assert_allclose(r["f64_x"], xj, rtol=JAX_RTOL,
                                   atol=JAX_RTOL * np.abs(xj).max())


@pytest.mark.parametrize("plan", ["win", "gather"])
def test_sharded_ell(plan):
    """The sharded ELL (LEGIONSOLVERS_NO_DIA=1 LEGIONSOLVERS_NO_RCM=1),
    on its windowed plan and on the gather-ELL: matvec and rmatvec bit for
    bit one process's; the CG history within rtol 1e-4 of it, x within
    rtol 1e-3; both ranks hold the same history."""
    ref = one_process("ell")
    assert bool(ref["win_windowed"]) and not bool(ref["gather_windowed"])
    for r in run_case("ell"):
        assert str(r[f"{plan}_operator"]) == "RowPartitionedMatrix"
        assert same(r[f"{plan}_windowed"], ref[f"{plan}_windowed"])
        assert same(r[f"{plan}_matvec"], ref[f"{plan}_matvec"])
        assert same(r[f"{plan}_rmatvec"], ref[f"{plan}_rmatvec"])
        np.testing.assert_allclose(r[f"{plan}_hist"], ref[f"{plan}_hist"],
                                   rtol=ELL_HIST_RTOL)
        np.testing.assert_allclose(r[f"{plan}_x"], ref[f"{plan}_x"],
                                   rtol=ELL_X_RTOL, atol=ELL_X_RTOL * np.abs(
                                       ref[f"{plan}_x"]).max())
    a, b = run_case("ell")
    assert same(a[f"{plan}_hist"], b[f"{plan}_hist"])


def test_vectors_match_one_process():
    """Fills (the last piece's padding zero), to_numpy, random_fill,
    from_array and dot on a process mesh equal the one-process vectors;
    each rank holds 2 pieces of 8, or 4 of the grid's 8 rows."""
    ref = one_process("vectors")
    ranks = run_case("vectors")
    for key in ("constant", "refill", "zero", "random", "from_array",
                "dot_exact", "planner_dot", "grid_random"):
        for r in ranks:
            assert same(r[key], ref[key]), key
    for r in ranks:
        assert int(r["local_len"]) == 16
        assert r["grid_local_shape"].tolist() == [4, 16]
        np.testing.assert_allclose(r["norm2_random"], ref["norm2_random"],
                                   rtol=1e-14)
    # rank 1 holds entries 16..31: 14 true ones, then the padding
    for key, value in (("constant_padding", 2.5), ("refill_padding", -1.0)):
        assert ranks[0][key].tolist() == [value] * 16
        assert ranks[1][key].tolist() == [value] * 14 + [0.0] * 2


@pytest.mark.parametrize("path", [
    "3-D pieces", "1-D stencil", "fused BiCGStab on pieces",
    "BiCGStabSolver", "GMRESSolver", "PCGSolver", "block system", "reorder",
    "planner basis upgrade", "adopt_basis", "save_checkpoint",
    "load_checkpoint", "distinct local devices"])
def test_refused_on_process_mesh(path):
    """Every path the process mesh does not run raises
    NotImplementedError naming ROADMAP item 5g, on both ranks."""
    for r in run_case("refused"):
        assert str(r[f"refused {path}"]) == "item 5g", r[f"refused {path}"]


def test_second_initialize_is_noop():
    """initialize_distributed on an initialized group changes nothing."""
    for rank, r in enumerate(run_case("refused")):
        before, after, same_rank = r["second init"].tolist()
        assert before == after == 2 and same_rank
