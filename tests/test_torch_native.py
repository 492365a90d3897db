"""The port's host library (``native/csrc/kernels.cpp`` through
``native/bindings.py``) against the JAX package's bindings and against the
port's own numpy versions.

* every entry point of the loaded library returns exactly what JAX's
  returns on the same inputs (``dia_accumulate`` on inputs without
  duplicates, where JAX's atomic f32 adds have one order);
* the library returns exactly what the port's numpy versions return,
  duplicates included, also across the chunks of the DIA scans;
* the RCM permutation is JAX's (ROADMAP P11: the port's was scipy's,
  which differs at the same bandwidth), also through the planner;
* LEGIONSOLVERS_NO_NATIVE leaves the library unloaded and the numpy
  versions answer.

The library is built with g++ at first use: where g++ is on PATH these
tests fail, not skip, if it does not load.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu.native.bindings as JB
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.problems.stencil import stencil_coo_arrays as j_coo
from legionsolvers_tpu_torch.native import bindings as TB
from legionsolvers_tpu_torch.problems.stencil import stencil_coo_arrays

torch.set_num_threads(2)

DEV = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_LOAD_WAIT_S = 120


@pytest.fixture(scope="module")
def jax_native():
    """JAX's bindings with their library loaded.  The JAX package builds
    its library beside its sources at first use, without a file lock, so a
    test process that loads it while another writes it falls back to
    numpy for good; this retries the load until the file is whole."""
    if shutil.which("g++") is None:
        pytest.fail("g++ is not on PATH: the libraries cannot be built")
    t0 = time.monotonic()
    while not JB.available():
        if time.monotonic() - t0 > JAX_LOAD_WAIT_S:
            pytest.fail("the JAX package's native library does not load")
        time.sleep(1.0)
        JB._lib, JB._tried = None, False
    return JB


def numpy_result(fn, *args):
    """``fn(*args)`` with the port's numpy versions."""
    with TB.numpy_versions():
        return fn(*args)


def assert_same(a, b):
    """Equal arrays of equal dtypes (or equal tuples of them), bit for
    bit: NaNs and signed zeros included."""
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def test_library_builds_and_loads():
    """Where g++ is on PATH the library must load: a build that fails is a
    fault, not a reason to skip."""
    if shutil.which("g++") is None:
        assert not TB.available()
        return
    assert TB.available(), TB.BUILD_INFO
    path = pathlib.Path(TB.BUILD_INFO["path"])
    assert path.parent == ROOT / "build" and path.exists()
    assert path == TB.library_path()


def laplacian(nx):
    r, c, v, n = stencil_coo_arrays((nx, nx), T.laplacian_stencil(2))
    return r, c, v, n


def scrambled(nx, seed=1):
    r, c, v, n = laplacian(nx)
    pr = np.random.default_rng(seed).permutation(n)
    return pr[r], pr[c], v, n


def random_pattern(n, m, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m)


def bandwidth(rows, cols, perm):
    iperm = np.empty(len(perm), np.int64)
    iperm[perm] = np.arange(len(perm))
    return int(np.abs(iperm[rows] - iperm[cols]).max())


# unsorted offsets (the fill sorts them by linear offset) in 1-D to 3-D,
# reach 1 and wider, one offset longer than its dimension
STENCILS = {
    "1d": ((17,), [((1,), -1.0), ((0,), 2.0), ((-1,), -1.0), ((3,), 0.5)]),
    "2d": ((6, 9), [((0, 1), -1.0), ((1, 0), -1.0), ((0, 0), 4.0),
                    ((-1, 0), -1.0), ((0, -1), -1.0), ((2, -3), 0.25),
                    ((0, 9), 7.0)]),
    "3d": ((4, 5, 6), [((0, 0, 1), -1.0), ((-1, 0, 0), -1.0),
                       ((0, 0, 0), 6.0), ((1, 0, 0), -1.0),
                       ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
                       ((0, 0, -1), -1.0), ((1, -2, 1), 0.125)]),
    "27-point": ((5, 4, 7), J.laplacian_stencil(4)[::-1]),
}


@pytest.mark.parametrize("case", list(STENCILS))
def test_stencil_fill_matches_jax(case, jax_native):
    """The fill in the given offset order (the raw stream) and through
    ``stencil_coo_arrays`` (sorted by (row, col)) equals JAX's, and the
    port's numpy generator's; the size too."""
    shape, stencil = STENCILS[case]
    offs = np.asarray([o for o, _ in stencil], np.int64)
    vals = np.asarray([v for _, v in stencil], np.float64)
    got = TB.stencil_fill_coo(shape, offs, vals)
    assert_same(got, jax_native.stencil_fill_coo(shape, offs, vals))
    assert TB.stencil_size(shape, offs) == jax_native.stencil_size(
        shape, offs) == len(got[0])
    assert numpy_result(TB.stencil_size, shape, offs) == len(got[0])
    assert numpy_result(TB.stencil_fill_coo, shape, offs, vals) is None
    full = stencil_coo_arrays(shape, stencil)
    assert_same(full, j_coo(shape, stencil))
    assert_same(full, numpy_result(stencil_coo_arrays, shape, stencil))


@pytest.mark.parametrize("sort", [True, False])
def test_build_indptr_matches_jax(sort, jax_native):
    rows = np.random.default_rng(2).integers(0, 50, 400)
    rows = np.sort(rows) if sort else rows
    got = TB.build_indptr(rows, 53)
    assert_same(got, jax_native.build_indptr(rows, 53))
    assert_same(got, numpy_result(TB.build_indptr, rows, 53))


def pieces_of(rows, cols, vals, n, S):
    """Per piece of S: (sorted local rows, global cols, vals, B, d0)."""
    B = -(-n // S)
    out = []
    for s in range(S):
        sel = (rows >= s * B) & (rows < (s + 1) * B)
        lr = rows[sel] - s * B
        order = np.argsort(lr, kind="stable")
        out.append((lr[order], cols[sel][order], vals[sel][order], B, s * B))
    return out


@pytest.mark.parametrize("system", ["scrambled", "random"])
def test_halo_columns_and_ell_packing_match_jax(system, jax_native):
    """Per piece of 4: the halo columns and the ELL slabs with remapped
    columns, as JAX's library and the port's numpy versions give them."""
    if system == "scrambled":
        rows, cols, vals, n = scrambled(24)
    else:
        n = 700
        rows, cols = random_pattern(n, 3000, 4)
        vals = np.random.default_rng(5).standard_normal(3000)
    for lr, gc, v, B, d0 in pieces_of(rows, cols, vals, n, 4):
        halo = TB.shard_halo_columns(gc, d0, B)
        assert_same(halo, jax_native.shard_halo_columns(gc, d0, B))
        assert_same(halo, numpy_result(TB.shard_halo_columns, gc, d0, B))
        L = max(int(np.bincount(lr).max()), 1)
        dump = B + len(halo)
        args = (lr, gc, v, B, B, d0, halo, L, dump)
        got = TB.pack_ell_shard(*args)
        assert_same(got, jax_native.pack_ell_shard(*args))
        assert_same(got, numpy_result(TB.pack_ell_shard, *args))


def test_pack_ell_shard_rejects_bad_rows():
    """The library checks what it writes through: unsorted rows, a row
    outside the piece and a row longer than L raise."""
    halo = np.empty(0, np.int64)
    cols, vals = np.arange(3), np.ones(3)
    for rows, L in (([1, 0, 2], 2), ([0, 1, 5], 2), ([0, 0, 0], 2)):
        with pytest.raises(ValueError):
            TB.pack_ell_shard(np.asarray(rows), cols, vals, 4, 4, 0, halo,
                              L, 4)


@pytest.mark.parametrize("case", ["laplacian", "wide", "over", "empty"])
def test_dia_unique_offsets_matches_jax(case, jax_native):
    """Sorted distinct offsets, and None past ``max_diags`` (over: 7
    diagonals against a cap of 6)."""
    if case == "laplacian":
        rows, cols, _, _ = laplacian(16)
        cap = 64
    elif case == "empty":
        rows = cols = np.empty(0, np.int64)
        cap = 4
    else:
        rng = np.random.default_rng(6)
        rows = rng.integers(0, 500, 4000)
        cols = np.clip(rows + rng.choice([-300, -2, 0, 1, 5, 90, 250], 4000),
                       0, 499)
        cap = 64 if case == "wide" else 6
    got = TB.dia_unique_offsets(rows, cols, cap)
    want = jax_native.dia_unique_offsets(rows, cols, cap)
    if case == "over":
        assert got is None and want is None
        assert numpy_result(TB.dia_unique_offsets, rows, cols, cap) is None
        return
    assert_same(got, want)
    assert_same(got, numpy_result(TB.dia_unique_offsets, rows, cols, cap))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_accumulate_matches_jax_without_duplicates(dtype, jax_native):
    rows, cols, _, n = scrambled(20, seed=3)
    vals = np.random.default_rng(7).standard_normal(len(rows))
    uoffs = TB.dia_unique_offsets(rows, cols, 1 << 12)
    got = TB.dia_accumulate(rows, cols, vals, uoffs, n + 16, dtype)
    assert_same(got, jax_native.dia_accumulate(rows, cols, vals, uoffs,
                                               n + 16, dtype))
    assert_same(got, numpy_result(TB.dia_accumulate, rows, cols, vals,
                                  uoffs, n + 16, dtype))


@pytest.mark.parametrize("chunk", [None, 97])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_accumulate_duplicates_bit_for_bit(dtype, chunk, monkeypatch):
    """Duplicates of mixed magnitude on few slots (each value rounded to
    ``dtype``, summed in float64 in input order, rounded once): the
    library equals the numpy version bit for bit, also with the scan cut
    into chunks of 97 entries (each chunk summed from zero, then added)."""
    if chunk is not None:
        monkeypatch.setattr(TB, "_DIA_CHUNK", chunk)
    rng = np.random.default_rng(8)
    m = 2000
    rows = rng.integers(0, 12, m)
    cols = np.clip(rows + rng.integers(-2, 3, m), 0, 11)
    vals = rng.standard_normal(m) * 10.0 ** rng.integers(-9, 9, m)
    uoffs = TB.dia_unique_offsets(rows, cols, 16)
    got = TB.dia_accumulate(rows, cols, vals, uoffs, 16, dtype)
    want = numpy_result(TB.dia_accumulate, rows, cols, vals, uoffs, 16,
                        dtype)
    assert_same(got, want)
    assert got.dtype == dtype and np.isfinite(got).all()


def test_dia_accumulate_rejects_an_offset_it_does_not_have():
    with pytest.raises(ValueError):
        TB.dia_accumulate(np.asarray([0, 1]), np.asarray([0, 3]),
                          np.ones(2), np.asarray([0]), 4, np.float32)


def disconnected():
    """Three components (two paths of different lengths and a 5-point
    Laplacian of 8 x 8), interleaved, and an isolated node."""
    r1, c1 = np.arange(29), np.arange(1, 30)
    r2, c2 = np.arange(30, 40), np.arange(31, 41)
    r3, c3, _, _ = laplacian(8)
    rows = np.concatenate([r1, r2, r3 + 41])
    cols = np.concatenate([c1, c2, c3 + 41])
    n = 41 + 64 + 1
    pr = np.random.default_rng(9).permutation(n)
    return pr[rows], pr[cols], n


RCM_CASES = {
    "scrambled 64^2": lambda: scrambled(64)[:2] + (64 * 64,),
    "scrambled 256^2": lambda: scrambled(256)[:2] + (256 * 256,),
    "random 3000": lambda: random_pattern(3000, 20000, 10) + (3000,),
    "disconnected": disconnected,
}


@pytest.mark.parametrize("case", list(RCM_CASES))
def test_rcm_permutation_is_jaxs(case, jax_native):
    """ROADMAP P11: the permutation is JAX's, bit for bit, and a
    permutation.  On the grids its bandwidth is no larger than scipy's
    (the numpy fallback's, which picks another permutation); on the random
    pattern either may be the narrower."""
    rows, cols, n = RCM_CASES[case]()
    perm = TB.rcm_permutation(n, rows, cols)
    assert_same(perm, jax_native.rcm_permutation(n, rows, cols))
    assert_same(np.sort(perm), np.arange(n))
    ref = numpy_result(TB.rcm_permutation, n, rows, cols)
    assert_same(np.sort(ref), np.arange(n))
    if case != "random 3000":
        assert bandwidth(rows, cols, perm) <= bandwidth(rows, cols, ref)


def test_rcm_permutation_rejects_out_of_range():
    with pytest.raises(ValueError):
        TB.rcm_permutation(4, np.asarray([0, 4]), np.asarray([1, 2]))


def test_planner_reorders_with_jaxs_permutation(jax_native):
    """P11 through the planners: the scrambled 32^2 Laplacian (f64) is
    reordered by both planners with the same permutation, to the same
    operator chain, and the histories agree."""
    rows, cols, vals, n = scrambled(32, seed=0)
    f64 = T.SolverOptions(entry_dtype=torch.float64)
    f64j = J.SolverOptions(entry_dtype=jnp.float64)
    pl = T.build_explicit_system(T.COOMatrix(rows, cols, vals, n, n,
                                             options=f64), f64, device=DEV)
    part = J.BlockPartition(n, 1)
    pj = J.SquarePlanner(mesh=None, options=f64j)
    pj.add_sol_vector(J.PartitionedVector("sol", part, options=f64j)
                      .zero_fill())
    pj.add_rhs_vector(J.PartitionedVector("rhs", part, options=f64j)
                      .constant_fill(1.0))
    pj.add_row_partitioned_matrix(
        J.COOMatrix(rows, cols, vals, n, n, options=f64j), 0, 0)
    assert pl.basis_perm is not None and pj.basis_perms[0] is not None
    assert_same(pl.basis_perm["perm_np"], pj.basis_perms[0]["perm_np"])
    op, opj = (p.row_partitioned_matrices[0][0] for p in (pl, pj))
    chain = lambda o: [type(o).__name__] + (chain(o.base)
                                            if hasattr(o, "base") else [])
    assert chain(op) == chain(opj)
    np.testing.assert_allclose(T.CGSolver(pl).solve(20).numpy(),
                               np.asarray(J.CGSolver(pj).solve(20)),
                               rtol=1e-12)


NO_NATIVE_SCRIPT = """
import json, sys
import numpy as np
from legionsolvers_tpu_torch.native import bindings as B
from legionsolvers_tpu_torch.problems.stencil import stencil_coo_arrays
out = {"available": B.available(), "error": B.BUILD_INFO.get("error")}
r, c, v, n = stencil_coo_arrays((12, 10), [((0, 1), -1.0), ((0, 0), 4.0),
                                           ((-1, 0), -1.0)])
u = B.dia_unique_offsets(r, c, 8)
arrays = {"r": r, "c": c, "v": v, "u": u,
          "coef": B.dia_accumulate(r, c, v, u, 128, np.float32),
          "perm": B.rcm_permutation(n, r, c),
          "indptr": B.build_indptr(r, n)}
np.savez(sys.argv[1], **arrays)
print(json.dumps(out))
"""


def test_no_native_switch_in_a_subprocess(tmp_path):
    """LEGIONSOLVERS_NO_NATIVE=1: the library stays unloaded and every
    entry point answers with its numpy version (RCM: scipy's)."""
    out = tmp_path / "arrays.npz"
    env = dict(os.environ, LEGIONSOLVERS_NO_NATIVE="1")
    proc = subprocess.run([sys.executable, "-c", NO_NATIVE_SCRIPT, str(out)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    assert info == {"available": False,
                    "error": "LEGIONSOLVERS_NO_NATIVE is set"}
    got = np.load(out)
    stencil = [((0, 1), -1.0), ((0, 0), 4.0), ((-1, 0), -1.0)]
    r, c, v, n = numpy_result(stencil_coo_arrays, (12, 10), stencil)
    u = numpy_result(TB.dia_unique_offsets, r, c, 8)
    want = {"r": r, "c": c, "v": v, "u": u,
            "coef": numpy_result(TB.dia_accumulate, r, c, v, u, 128,
                                 np.float32),
            "perm": numpy_result(TB.rcm_permutation, n, r, c),
            "indptr": numpy_result(TB.build_indptr, r, n)}
    for k, a in want.items():
        assert_same(got[k], a)


@pytest.mark.parametrize("values", ["mixed", "special"])
def test_matrix_market_lines_read_back(values, tmp_path):
    """The library's lines and the plain version's (Python's repr, as the
    JAX package writes) both read back to the same doubles."""
    rng = np.random.default_rng(11)
    m = 3000
    rows, cols = rng.integers(0, 10 ** 9, m), rng.integers(0, 5, m)
    if values == "mixed":
        vals = rng.standard_normal(m) * 10.0 ** rng.integers(-300, 300, m)
    else:
        vals = np.resize(np.asarray([0.0, -0.0, 5e-324, -1.7976931348623157e308,
                                     np.inf, -np.inf, 1.0, 0.1]), m)
    for lines in (TB.matrix_market_lines(rows, cols, vals),
                  numpy_result(lambda *a: list(TB.matrix_market_lines(*a)),
                               rows, cols, vals)):
        data = np.loadtxt(b"".join(lines).decode().splitlines(), ndmin=2)
        assert_same(data[:, 0].astype(np.int64) - 1, rows)
        assert_same(data[:, 1].astype(np.int64) - 1, cols)
        assert_same(data[:, 2], vals)
