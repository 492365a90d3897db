"""3-D pieces and the 1-D view on a mesh over processes, against one
process and the JAX package.

Each case starts the two worker processes of ``tests/
test_torch_multiprocess.py`` (``tests/torch_distributed_worker.py``: a
gloo group, a 4-shard mesh of 2 CPU shards each) and runs the same case
function on a one-process ``make_mesh(4, devices=["cpu"] * 4)``.  Held:

* 3-D pieces at (8, 8, 128), 2 x-planes each, their halo planes crossing
  the processes: the 7- and 27-point f32 CG (K6b + K6a per piece), one
  matvec and its fused dot, and block CG and BiCGStab of 2 spaces: bit for
  bit one process's on both ranks; BiCGStab ``step()`` (3-D pieces have no
  fused runner, as in JAX), GMRES and PCG(Jacobi), whose eager dots sum
  per piece here and over the whole vector on one process: within
  ``test_torch_multiprocess.py``'s bounds; f64 CG (the linearized path,
  also on (2, 16, 128), whose band is wider than a block and gathers from
  the whole vector) and BiCGStab bit for bit or within their bound of one
  process, and within JAX_RTOL of JAX's 4-device mesh;
* the 1-D view at n = 2^18 ([64, 4096], 16-row pieces, the row-wrap terms'
  edge fix-ups by global piece index): the f32 CG (two-pass: the s-step
  does not take the 1-D view on pieces, as in JAX), the fused BiCGStab
  with f32 and compensated dots, one matvec with its fused dot, block CG
  and BiCGStab: bit for bit; GMRES and PCG within their bounds; f64 CG
  bit for bit and within JAX_RTOL of JAX's 4-device mesh;
* a JAX 3-D CG state (two steps on its 4-device mesh, f32) carried by
  ``utils/convert.stencil_cg_system`` onto the mesh over processes, each
  rank taking its rows: its continuation within JAX_RTOL of JAX's.
"""

import functools
import os
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest

import legionsolvers_tpu as J
from tests import torch_distributed_worker as W
from tests.test_torch_multiprocess import (
    BICG_F32_RTOL,
    BICG_F64_RTOL,
    F32_RTOL,
    F64_RTOL,
    JAX_RTOL,
    PCG_F32_RTOL,
    check_ranks,
    close,
    one_process,
    run_case,
    same,
)
from tests.test_torch_sharded_solvers import system


@functools.lru_cache(maxsize=None)
def jax_f64(shape, solver, dim=None):
    """JAX's f64 (history, x) of ``solver`` on its 4-device mesh: the
    worker's system (the Laplacian of ``dim``, b = 1, x0 = 0)."""
    stencil = J.laplacian_stencil(dim or min(len(shape), 3))
    planner, _ = system(J, shape, 4, stencil=stencil,
                        options=J.SolverOptions(entry_dtype=jnp.float64))
    h = np.asarray(getattr(J, solver)(planner).solve(W.ITERS))
    return h, np.asarray(planner.sol_vectors[0].to_numpy())[None]


# -- 3-D pieces ------------------------------------------------------------------

def test_grid3d_views():
    """The 7- and 27-point stencils take the 3-D kernel view on both ranks
    and on one process, without the fused BiCGStab (one piece only, as in
    JAX); WIDE3's band is wider than a block."""
    for r in run_case("grids3d") + [one_process("grids3d")]:
        for dim in (3, 4):
            assert str(r[f"view{dim}"]) == "3d"
            assert not bool(r[f"fused_bicg{dim}"])
        assert bool(r["wide_band"])


@pytest.mark.parametrize("dim", [3, 4])
def test_grid3d_cg_bit_for_bit(dim):
    """The f32 3-D CG, two-pass on K6b + K6a per piece with the halo
    planes shifted across the processes: history and x bit for bit the
    one-process 4-piece mesh's on both ranks."""
    check_ranks("grids3d", f"cg{dim}")


@pytest.mark.parametrize("dim", [3, 4])
def test_grid3d_matvec_bit_for_bit(dim):
    """One 3-D matvec (K6a y per piece) and its fused dot (y_dot): bit
    for bit one process's on both ranks."""
    ref = one_process("grids3d")
    for r in run_case("grids3d"):
        for k in (f"mv{dim}", f"mv{dim}_y", f"mv{dim}_dot"):
            assert same(r[k], ref[k]), k
        assert same(r[f"mv{dim}"], r[f"mv{dim}_y"])


@pytest.mark.parametrize("key,rtol", [("bicg", BICG_F32_RTOL),
                                      ("gmres", F32_RTOL),
                                      ("pcg", PCG_F32_RTOL)])
def test_grid3d_eager_solvers(key, rtol):
    """BiCGStab ``step()``, GMRES(4)'s runner over 2 cycles and
    PCG(Jacobi) on the 7-point 3-D pieces in f32, their dots per piece:
    equal on both ranks, within the bound of one process stated in
    ``test_torch_multiprocess.py`` (BiCGStab 1.62e-4, GMRES 5.46e-6, PCG
    4.3e-6 measured)."""
    check_ranks("grids3d", key, rtol)


@pytest.mark.parametrize("key", ["block_cg", "block_bicg"])
def test_grid3d_block_bit_for_bit(key):
    """Block CG (the two-pass K6 phases) and block BiCGStab (the torch
    phases over the sharded matvec) of 2 spaces on 3-D pieces: both
    spaces' history and x bit for bit one process's."""
    check_ranks("grids3d", key)


@pytest.mark.parametrize("key,shape,solver,rtol", [
    ("f64", W.SHAPE3, "CGSolver", None),
    ("wide", W.WIDE3, "CGSolver", None),
    ("bicg_f64", W.SHAPE3, "BiCGStabSolver", BICG_F64_RTOL)])
def test_grid3d_f64_matches_one_process_and_jax(key, shape, solver, rtol):
    """f64 on 3-D pieces (the linearized path; on WIDE3 its window
    gathered from the whole vector): CG bit for bit one process's,
    BiCGStab ``step()`` within rtol 1e-11 of it; both within JAX_RTOL of
    JAX's 4-device mesh."""
    check_ranks("grids3d", key, rtol)
    hj, xj = jax_f64(shape, solver, 3)
    for r in run_case("grids3d"):
        close(r[f"{key}_hist"], hj, JAX_RTOL)
        close(r[f"{key}_x"], xj, JAX_RTOL)


# -- the 1-D view ----------------------------------------------------------------

def test_flat1d_view():
    """The 1-D Laplacian at 2^18 takes the [64, 4096] view in 16-row
    pieces; its s-step is not eligible on pieces (the row-wrap terms, as
    in JAX), its fused BiCGStab is."""
    for r in run_case("flat1d") + [one_process("flat1d")]:
        assert r["view"].tolist() == [1, 16, 4096]
        assert not bool(r["sstep_eligible"])
        assert bool(r["fused_bicg"])


@pytest.mark.parametrize("key", ["cg", "bicg", "bicg_comp", "block_cg",
                                 "block_bicg"])
def test_flat1d_bit_for_bit(key):
    """The fused runners on the 1-D view's pieces: two-pass CG (K4 + K3
    with WRAP), BiCGStab (K5a-c) with f32 and compensated dots, and block
    CG and BiCGStab of 2 spaces: history and x bit for bit the one-process
    4-piece mesh's on both ranks."""
    check_ranks("flat1d", key)


def test_flat1d_matvec_bit_for_bit():
    """One matvec on the 1-D view's pieces (K3 y, the row-wrap terms
    patched at the piece edges) and its fused dot: bit for bit one
    process's on both ranks."""
    ref = one_process("flat1d")
    for r in run_case("flat1d"):
        for k in ("mv", "mv_y", "mv_dot"):
            assert same(r[k], ref[k]), k


def test_flat1d_pcg():
    """PCG(Jacobi) on the 1-D view's pieces in f32: equal on both ranks,
    within PCG_F32_RTOL of one process (1.67e-6 measured)."""
    check_ranks("flat1d", "pcg", PCG_F32_RTOL)


def test_flat1d_gmres():
    """GMRES(4)'s runner over 2 cycles on the 1-D view's pieces in f32:
    equal on both ranks, the history within F32_RTOL of one process's (bit
    for bit measured).  x is the sum of a few basis vectors whose
    projections are f32 dots over 2^18 entries, per piece here and over
    the whole vector on one process: its gap to one process's x (3.56e-5
    of max|x| measured) is held to twice one process's own distance from
    the f64 run's x (3.60e-5 measured), f32's rounding at this length, and
    x across processes no farther from the f64 x than that."""
    ref = one_process("flat1d")
    a, b = run_case("flat1d")
    assert same(a["gmres_hist"], b["gmres_hist"])
    assert same(a["gmres_x"], b["gmres_x"])
    close(a["gmres_hist"], ref["gmres_hist"], F32_RTOL)
    x64 = ref["gmres_f64_x"]
    dist = lambda x, y: np.abs(x.astype(np.float64) - y).max() / np.abs(
        y).max()
    own = dist(ref["gmres_x"], x64)
    assert dist(a["gmres_x"], ref["gmres_x"]) <= 2 * own
    assert dist(a["gmres_x"], x64) <= 2 * own


def test_flat1d_f64_matches_one_process_and_jax():
    """f64 CG on the 1-D Laplacian's pieces (the linearized path): bit
    for bit one process's, within JAX_RTOL of JAX's 4-device mesh."""
    check_ranks("flat1d", "f64")
    hj, xj = jax_f64(W.SHAPE1, "CGSolver")
    for r in run_case("flat1d"):
        close(r["f64_hist"], hj, JAX_RTOL)
        close(r["f64_x"], xj, JAX_RTOL)


# -- a JAX state carried across ----------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_continued(dim):
    """(npz path of JAX's state after two f32 CG steps on its 4-device
    mesh at SHAPE3, JAX's history and x over ITERS more iterations)."""
    planner, _ = system(J, W.SHAPE3, 4, stencil=J.laplacian_stencil(dim))
    solver = J.CGSolver(planner)
    solver.step()
    solver.step()
    arrays = {"rr": np.array([float(s.value)
                              for s in solver.residual_norm_squared]),
              "dim": np.array(dim)}
    for k, vs in planner.dump_state().items():
        if k != "ops":
            for i, v in enumerate(vs):
                arrays[f"{k}/{i}"] = np.asarray(v)
    path = os.path.join(tempfile.mkdtemp(prefix="jax_state_"), "state.npz")
    np.savez(path, **arrays)
    h = np.asarray(solver.solve(W.ITERS), np.float64)
    return path, h, np.asarray(planner.sol_vectors[0].to_numpy())[None]


@pytest.mark.parametrize("dim", [3, 4])
def test_convert3d_continues_jax_state(dim):
    """``convert.stencil_cg_system(..., mesh=)``: both ranks take their
    rows of JAX's state and continue its CG on 3-D pieces across the
    processes; the same history on both ranks, its first entry JAX's last,
    history and x within JAX_RTOL of JAX's own continuation."""
    path, hj, xj = jax_continued(dim)
    a, b = run_case("convert3d", path)
    assert same(a["hist"], b["hist"]) and same(a["x"], b["x"])
    with np.load(path) as f:
        assert a["hist"][0] == np.float32(f["rr"][-1])
    close(a["hist"], hj, JAX_RTOL)
    close(a["x"][None], xj, JAX_RTOL)
