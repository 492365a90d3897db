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
* the fused 2-D BiCGStab (f32 and compensated dots) and the block systems
  of 2 spaces (CG on the s-step and two-pass phases, BiCGStab, and both on
  the f64 torch phases): bit for bit the one-process mesh's on both ranks;
* BiCGStab ``step()``, GMRES (CGS2 runner and MGS ``step()``) and
  PCG(Jacobi), whose eager dots sum per piece here and over the whole
  vector on one process: equal on both ranks and within the bound stated
  in each test of one process; their f64 runs and the f64 block systems
  also within it of the JAX package's 4-device mesh;
* ``entry.dryrun_multichip(4)`` with its shards over both processes: its
  fused sections bit for bit one process's, the others within rtol 1e-5;
* checkpoints and a mesh over distinct local devices, which a process
  mesh refuses, raise NotImplementedError naming item 5g, and
  ``initialize_distributed`` a second time is a no-op.

3-D pieces and the 1-D view are held in
``tests/test_torch_multiprocess_grids.py``, reordered bases in
``tests/test_torch_multiprocess_reorder.py``; both use this file's
helpers.

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
# the eager solvers across processes against one process (and f64 against
# JAX's 4-device mesh): f32 1e-5 and f64 1e-12 where they hold, else the
# measured gap's next step, within test_torch_sharded_solvers.py's bound
F32_RTOL = 1e-5
F64_RTOL = 1e-12
BICG_F32_RTOL = 3e-3   # step() f32: 1.33e-3 measured; its bound there 3e-3
BICG_F64_RTOL = 1e-11  # step() f64: 2.05e-12 measured, 2.65e-12 vs JAX
PCG_F32_RTOL = 3e-5    # 1.03e-5 measured; its bound there 1e-4


def _free_port() -> int:
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("cannot bind local ports in this environment")
        return s.getsockname()[1]


@functools.lru_cache(maxsize=None)
def run_case(case, inputs=None):
    """Both ranks' results of one worker case, ``[rank 0, rank 1]``;
    ``inputs``: a file the case reads (its ``WORKER_INPUT``)."""
    port = _free_port()
    tmp = tempfile.mkdtemp(prefix="torch_mp_")
    env = {k: v for k, v in os.environ.items() if k != "PYTEST_CURRENT_TEST"}
    env["WORKER_TMP"] = tmp
    if inputs is not None:
        env["WORKER_INPUT"] = inputs
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


def close(a, b, rtol):
    """History or x ``a`` within ``rtol`` of ``b``: elementwise relative
    for a history, relative to max|b| for x (``[spaces, n]``)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.ndim == 1:
        np.testing.assert_allclose(a, b, rtol=rtol)
    else:
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rtol * np.abs(b).max())


def check_ranks(case, key, rtol=None, jax=None):
    """``key``'s history and x on both ranks: equal to each other, and bit
    for bit one process's (``rtol`` None) or within ``rtol`` of it (and of
    ``jax`` = JAX's (history, x), where given)."""
    ref = one_process(case)
    ranks = run_case(case)
    for part in ("hist", "x"):
        k = f"{key}_{part}"
        assert same(ranks[0][k], ranks[1][k]), k
        for r in ranks:
            if rtol is None:
                assert same(r[k], ref[k]), k
            else:
                close(r[k], ref[k], rtol)
                if jax is not None:
                    close(r[k], jax[part == "x"], rtol)


@functools.lru_cache(maxsize=None)
def jax_run(solver, iters, num_spaces=1, use_jit=True):
    """JAX's f64 (history, x per space) on its 4-device mesh for the
    worker's ``solver_run`` system."""
    from tests.test_torch_sharded_solvers import system

    from legionsolvers_tpu.solvers.pcg import (
        JacobiPreconditioner as JJacobi,
        PCGSolver as JPCG,
    )

    n = W.SHAPE[0] * W.SHAPE[1]
    rhs = [np.full(n, 1.0 + i) for i in range(num_spaces)]
    planner, _ = system(J, W.SHAPE, 4, rhs=rhs, num_spaces=num_spaces,
                        options=J.SolverOptions(entry_dtype=jnp.float64))
    kw = {}
    if solver == "PCGSolver":
        s = JPCG(planner, JJacobi(planner))
    elif solver == "GMRESSolver":
        s, kw = J.GMRESSolver(planner, restart=W.RESTART), {
            "use_jit": use_jit}
    else:
        s = getattr(J, solver)(planner)
    h = np.asarray(s.solve(iters, **kw))
    return h, np.stack([np.asarray(v.to_numpy())
                        for v in planner.sol_vectors])


@pytest.mark.parametrize("key", ["fused", "compensated"])
def test_bicgstab2d_fused_bit_for_bit(key):
    """The fused 2-D BiCGStab on 16-row pieces (K5a-c per piece, one
    exchange per iteration, the edge fix-ups' sums at the whole mesh's
    stack), f32 dots and compensated ones: history and x bit for bit the
    one-process 4-piece mesh's on both ranks."""
    assert bool(one_process("bicgstab2d")["fused_supported"])
    assert all(bool(r["fused_supported"]) for r in run_case("bicgstab2d"))
    check_ranks("bicgstab2d", key)


def test_bicgstab2d_steps_f32():
    """BiCGStab ``step()`` in f32 (LEGIONSOLVERS_NO_FUSED_BICGSTAB=1), its
    dots per piece here: within rtol 3e-3 of one process (1.33e-3
    measured; test_torch_sharded_solvers.py's BiCGStab bound), x within
    3e-3 max|x|."""
    check_ranks("bicgstab2d", "steps", BICG_F32_RTOL)


def test_bicgstab2d_steps_f64_matches_one_process_and_jax():
    """BiCGStab in f64, which has no kernel view and runs ``step()``:
    within rtol 1e-11 of one process and of JAX's 4-device mesh (2.05e-12
    and 1.69e-12 measured)."""
    check_ranks("bicgstab2d", "f64", BICG_F64_RTOL,
                jax_run("BiCGStabSolver", W.ITERS))


@pytest.mark.parametrize("key", ["f32_fused", "f32_eager", "f64_fused",
                                 "f64_eager"])
def test_gmres_across_processes(key):
    """GMRES(4) over 2 cycles, the CGS2 runner (its dots and projections
    per piece, gathered) and the MGS ``step()``: f32 within rtol 1e-5 of
    one process, f64 within 1e-12 of one process and of JAX's 4-device
    GMRES (its runner, or ``use_jit=False``: MGS)."""
    if key.startswith("f32"):
        check_ranks("gmres", key, F32_RTOL)
    else:
        check_ranks("gmres", key, F64_RTOL, jax_run(
            "GMRESSolver", W.GMRES_CYCLES, use_jit=key == "f64_fused"))


@pytest.mark.parametrize("key", ["f32", "f64", "dia"])
def test_pcg_across_processes(key):
    """PCG(Jacobi) over 8 iterations on the stencil (f32 within rtol 3e-5
    of one process, 1.03e-5 measured, test_torch_sharded_solvers.py's PCG
    bound 1e-4; f64 within 1e-12 of one process and of JAX's 4-device
    PCG) and, in f32, on the explicit Laplacian's DiaOperator (rtol
    3e-5), each process holding its 2 pieces' rows of the diagonal."""
    if key == "f64":
        check_ranks("pcg", key, F64_RTOL, jax_run("PCGSolver", W.ITERS))
    else:
        check_ranks("pcg", key, PCG_F32_RTOL)
    if key == "dia":
        for r in run_case("pcg"):
            assert str(r["dia_operator"]) == "DiaOperator"
            assert r["dia_local_diag"].shape == (W.SHAPE[0] * W.SHAPE[1]
                                                 // 2,)
            assert np.all(r["dia_local_diag"] == 0.25)


@pytest.mark.parametrize("key", ["cg_sstep", "cg_twopass", "bicgstab",
                                 "f64_cg", "f64_bicgstab"])
def test_block_bit_for_bit(key):
    """Block systems of 2 spaces (b = 1 and 2): each space's sums gathered
    per piece, the spaces added in space order; history and x of both
    spaces bit for bit the one-process mesh's on both ranks."""
    check_ranks("block", key)


@pytest.mark.parametrize("solver", ["CGSolver", "BiCGStabSolver"])
def test_block_f64_matches_jax(solver):
    """The f64 block systems against JAX's block runners on its 4-device
    mesh: CG within rtol 1e-12, BiCGStab within 1e-11 (2.65e-12
    measured)."""
    key = "f64_cg" if solver == "CGSolver" else "f64_bicgstab"
    rtol = F64_RTOL if solver == "CGSolver" else BICG_F64_RTOL
    hj, xj = jax_run(solver, W.ITERS, num_spaces=2)
    for r in run_case("block"):
        close(r[f"{key}_hist"], hj, rtol)
        close(r[f"{key}_x"], xj, rtol)


DRYRUN_SECTIONS = ("step", "fused", "sstep", "bicgstab", "gmres", "winell",
                   "block-cg", "block-bicg", "dia", "pcg")
DRYRUN_BITS = ("fused", "sstep", "bicgstab", "block-cg", "block-bicg")


@pytest.mark.parametrize("section", DRYRUN_SECTIONS)
def test_dryrun_across_processes(section):
    """``dryrun_multichip(4)`` with 2 shards on each process: the same
    histories on both ranks; the fused runners' sections bit for bit the
    one-process run's, the eager ones (the generic step, GMRES, the
    sharded ELL's and the DIA's CG, PCG) within rtol 1e-5 (4.08e-6
    measured, GMRES)."""
    ref = one_process("dryrun")[f"dryrun {section}"]
    a, b = (r[f"dryrun {section}"] for r in run_case("dryrun"))
    assert same(a, b)
    if section in DRYRUN_BITS:
        assert same(a, ref)
    else:
        np.testing.assert_allclose(a, ref, rtol=F32_RTOL)


def test_dryrun_refuses_uneven_split():
    """3 shards over 2 processes raise ValueError on both ranks."""
    for r in run_case("dryrun"):
        assert str(r["uneven"]).startswith("ValueError: 3 shards"), r[
            "uneven"]


@pytest.mark.parametrize("path", [
    "save_checkpoint", "load_checkpoint", "distinct local devices"])
def test_refused_on_process_mesh(path):
    """Every path the process mesh does not run (checkpoints, several
    distinct devices in one process) raises NotImplementedError naming
    ROADMAP item 5g, on both ranks."""
    for r in run_case("refused"):
        assert str(r[f"refused {path}"]) == "item 5g", r[f"refused {path}"]


def test_second_initialize_is_noop():
    """initialize_distributed on an initialized group changes nothing."""
    for rank, r in enumerate(run_case("refused")):
        before, after, same_rank = r["second init"].tolist()
        assert before == after == 2 and same_rank
