"""Host helpers: stencil sizes and COO fills, CSR row pointers, DIA
extraction, RCM ordering, the per-piece halo and ELL packing of a
row-partitioned matrix, and the text of a Matrix Market file.

Port of ``legionsolvers_tpu/native/bindings.py``.  The loops are C++
(``csrc/kernels.cpp``, host code with no torch and no CUDA), built with
g++ at first use into ``build/`` at the repository root, as the CUDA
kernels are (``ops/cuda/build.py``): the library is named by a hash of the
source, the flags and the host CPU (``-march=native``), compiled to a
temporary file under a file lock and moved into place, so that processes
starting together build it once and a library built for another CPU is
never loaded.  LEGIONSOLVERS_NO_NATIVE (any non-empty value) keeps it
unloaded, as in the JAX package.

Every entry point calls the library when it is loaded and otherwise its
numpy version, the plain version, which returns the same arrays bit for
bit; :func:`rcm_permutation` falls back to scipy's ordering, which may
differ from the library's (JAX's) at the same bandwidth.  Duplicate
(row, col) entries are summed, as COO semantics require (reference:
COOMatrixTasks.cpp:38-39).
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading
import time
from typing import Optional

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "kernels.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
             "-march=native")

#: What loading the library did: path, build seconds, or the error.
BUILD_INFO = {}

_DIA_CHUNK = 1 << 24  # nnz per pass of the DIA scans
_MM_CHUNK = 1 << 20   # Matrix Market lines formatted per call

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_L = ctypes.c_int64

# entry point -> (restype, argtypes): JAX's declarations, with a status
# returned where an entry point writes through an index of its input
_SIGNATURES = {
    "stencil_size": (_L, [_i64p, _L, _i64p, _L]),
    "stencil_fill_coo": (_L, [_i64p, _L, _i64p, _f64p, _L, _i64p, _i64p,
                              _f64p]),
    "build_indptr": (_L, [_i64p, _L, _L, _i64p]),
    "pack_ell_shard": (_L, [_L, _i64p, _i64p, _f64p, _L, _L, _L, _i64p, _L,
                            _L, _L, _i32p, _f64p]),
    "shard_halo_columns": (_L, [_L, _i64p, _L, _L, _i64p]),
    "dia_unique_offsets": (_L, [_L, _i64p, _i64p, _L, _i64p]),
    "dia_accumulate_f32": (_L, [_L, _i64p, _i64p, _f64p, _L, _i64p, _L,
                                _f64p]),
    "dia_accumulate_f64": (_L, [_L, _i64p, _i64p, _f64p, _L, _i64p, _L,
                                _f64p]),
    "rcm_permutation": (None, [_L, _L, _i64p, _i64p, _i64p]),
    "mm_line_max": (_L, []),
    "mm_format_coo": (_L, [_L, _i64p, _i64p, _f64p, _u8p]),
}


def _host_cpu() -> bytes:
    """The CPU's model and flags, which ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return b"".join(sorted({line for line in f if line.startswith(
                (b"model name", b"flags"))}))
    except OSError:
        return os.uname().machine.encode()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_host_cpu())
    return BUILD_DIR / f"libls_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile ``csrc/kernels.cpp`` unless its library exists already."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                           check=True, capture_output=True, text=True)
            os.replace(tmp, out)
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0)
    return out


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            if os.environ.get("LEGIONSOLVERS_NO_NATIVE"):
                BUILD_INFO.update(error="LEGIONSOLVERS_NO_NATIVE is set")
                return None
            try:
                _lib = _load()
            except subprocess.CalledProcessError as e:
                BUILD_INFO.update(error=f"g++ failed: {e.stderr}")
            except OSError as e:  # no g++, no write access, a failed load
                BUILD_INFO.update(error=f"{type(e).__name__}: {e}")
    return _lib


def available() -> bool:
    """Whether the C++ library is loaded (built at the first call)."""
    return _get() is not None


@contextlib.contextmanager
def numpy_versions():
    """Within the block every entry point runs its numpy version, as
    without the library: the plain versions the library is held to."""
    global _lib, _tried
    saved = _lib, _tried
    _lib, _tried = None, True
    try:
        yield
    finally:
        _lib, _tried = saved


def _check(status: int, what: str) -> None:
    if status < 0:
        raise ValueError(f"{what}: an index of the input is out of range")


def _check_range(a: np.ndarray, n: int, what: str) -> None:
    if len(a) and (int(a.min()) < 0 or int(a.max()) >= n):
        raise ValueError(f"{what}: indices must lie in [0, {n})")


# -- entry points (the library, else the plain numpy version) ---------------

def stencil_size(shape, offsets) -> int:
    """Nonzeros of the stencil matrix over a grid of ``shape``: for each
    offset, the grid points whose neighbour at that offset is inside."""
    shape = np.ascontiguousarray(shape, np.int64)
    offs = np.ascontiguousarray(offsets, np.int64)
    lib = _get()
    if lib is not None:
        return int(lib.stencil_size(shape, len(shape), offs, offs.shape[0]))
    cnt = np.maximum(shape[None, :] - np.abs(offs), 0)
    return int(np.prod(cnt, axis=1).sum())


def stencil_fill_coo(shape, offsets, values):
    """(rows, cols, vals) of the stencil matrix, grid points in row-major
    order and the offsets in their given order per point, or None without
    the library: callers use their numpy generator."""
    shape = np.ascontiguousarray(shape, np.int64)
    offs = np.ascontiguousarray(offsets, np.int64)
    vals_in = np.ascontiguousarray(values, np.float64)
    lib = _get()
    if lib is None:
        return None
    nnz = stencil_size(shape, offs)
    rows = np.empty(nnz, np.int64)
    cols = np.empty(nnz, np.int64)
    vals = np.empty(nnz, np.float64)
    written = lib.stencil_fill_coo(shape, len(shape), offs, vals_in,
                                   offs.shape[0], rows, cols, vals)
    if written != nnz:
        raise RuntimeError(f"stencil_fill_coo wrote {written} of {nnz}")
    return rows, cols, vals


def build_indptr(rows, n_rows):
    """CSR row pointers [n_rows + 1] of a row index array."""
    rows = np.ascontiguousarray(rows, np.int64)
    lib = _get()
    if lib is not None:
        indptr = np.empty(n_rows + 1, np.int64)
        _check(lib.build_indptr(rows, len(rows), n_rows, indptr),
               "build_indptr")
        return indptr
    indptr = np.zeros(n_rows + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr)


def dia_unique_offsets(rows, cols, max_diags):
    """Sorted distinct diagonal offsets (col - row), or None when the matrix
    has more than ``max_diags`` of them.  Chunked, so that no O(nnz)
    temporary is held beyond one chunk."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    lib = _get()
    if lib is not None:
        out = np.empty(max(max_diags, 1), np.int64)
        m = lib.dia_unique_offsets(len(rows), rows, cols, max_diags, out)
        return None if m < 0 else out[:m].copy()
    u = np.empty(0, np.int64)
    for s in range(0, len(rows), _DIA_CHUNK):
        d = cols[s: s + _DIA_CHUNK] - rows[s: s + _DIA_CHUNK]
        lo = int(d.min())
        if int(d.max()) - lo < _DIA_CHUNK:  # a count per offset beats a sort
            d = np.flatnonzero(np.bincount(d - lo)) + lo
        u = np.union1d(u, d)
        if len(u) > max_diags:
            return None
    return u


def dia_accumulate(rows, cols, vals, uoffs, padded, dtype):
    """coef[D, padded] in ``dtype``: ``coef[k, r]`` is the sum of the entries
    on row r of diagonal ``uoffs[k]``.  Values are rounded to ``dtype``
    first and summed in float64, in input order within each chunk of
    ``_DIA_CHUNK`` entries (``np.bincount``), the chunks' sums added in
    order; the library sums the same way (float32 and float64 targets)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    uoffs = np.ascontiguousarray(uoffs, np.int64)
    dtype = np.dtype(dtype)
    size = len(uoffs) * padded
    flat = np.zeros(size, np.float64)
    lib = _get()
    native = (lib is not None and dtype in (np.float32, np.float64)
              and np.asarray(vals).dtype in (np.float32, np.float64))
    for s in range(0, len(rows), _DIA_CHUNK):
        e = min(s + _DIA_CHUNK, len(rows))
        if native:
            fn = (lib.dia_accumulate_f32 if dtype == np.float32
                  else lib.dia_accumulate_f64)
            part = flat if s == 0 else np.zeros(size, np.float64)
            _check(fn(e - s, rows[s:e], cols[s:e],
                      np.ascontiguousarray(vals[s:e], np.float64),
                      len(uoffs), uoffs, padded, part), "dia_accumulate")
            if s:
                flat += part
            continue
        k = np.searchsorted(uoffs, cols[s:e] - rows[s:e])
        w = np.asarray(vals[s:e], dtype).astype(np.float64)
        flat += np.bincount(k * padded + rows[s:e], weights=w, minlength=size)
    return flat.astype(dtype).reshape(len(uoffs), padded)


def rcm_permutation(n, rows, cols):
    """Reverse Cuthill-McKee ordering of the symmetrized pattern: perm[i] =
    the original index placed at position i, so that A[perm][:, perm] is
    banded.  The library's BFS with George-Liu pseudo-peripheral starts
    (the JAX package's, so both pick the same permutation); scipy's
    ordering without the library."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    lib = _get()
    if lib is not None:
        _check_range(rows, n, "rcm_permutation rows")
        _check_range(cols, n, "rcm_permutation cols")
        perm = np.empty(n, np.int64)
        lib.rcm_permutation(n, len(rows), rows, cols, perm)
        return perm
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n)
    ).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(a + a.T, symmetric_mode=True), np.int64
    )


def shard_halo_columns(cols_global, d0, B_d):
    """Sorted distinct columns outside the block ``[d0, d0 + B_d)``: the
    halo one piece reads (the ghost image of its nonzeros, reference:
    COOMatrix.cpp:98-118)."""
    c = np.ascontiguousarray(cols_global, np.int64)
    lib = _get()
    if lib is not None:
        out = np.empty(max(len(c), 1), np.int64)
        m = lib.shard_halo_columns(len(c), c, d0, B_d, out)
        return out[:m].copy()
    return np.unique(c[(c < d0) | (c >= d0 + B_d)])


def pack_ell_shard(rows_local, cols_global, vals, B_r, B_d, d0, halo_global,
                   L, dump):
    """ELL-pack one piece's nonzeros: (ell_cols int32 [B_r, L], ell_vals
    float64 [B_r, L]).  ``rows_local`` is sorted (stably) and the nonzeros
    of a row keep their order in the slots.  Columns are remapped into the
    piece's extended buffer: ``c - d0`` inside its block ``[d0, d0 +
    B_d)``, ``B_d`` + the position in the sorted ``halo_global`` outside;
    padded slots hold (``dump``, 0)."""
    rows_local = np.ascontiguousarray(rows_local, np.int64)
    c = np.ascontiguousarray(cols_global, np.int64)
    halo_global = np.ascontiguousarray(halo_global, np.int64)
    lib = _get()
    if lib is not None:
        ell_cols = np.empty((B_r, L), np.int32)
        ell_vals = np.empty((B_r, L), np.float64)
        _check(lib.pack_ell_shard(
            len(rows_local), rows_local, c,
            np.ascontiguousarray(vals, np.float64), B_r, B_d, d0,
            halo_global, len(halo_global), L, dump, ell_cols.reshape(-1),
            ell_vals.reshape(-1)), "pack_ell_shard")
        return ell_cols, ell_vals
    local = (c >= d0) & (c < d0 + B_d)
    lc = np.empty(len(c), np.int64)
    lc[local] = c[local] - d0
    lc[~local] = B_d + np.searchsorted(halo_global, c[~local])
    starts = np.concatenate([[0], np.cumsum(np.bincount(rows_local,
                                                       minlength=B_r))])
    slot = np.arange(len(rows_local)) - starts[rows_local]
    ell_cols = np.full((B_r, L), dump, np.int32)
    ell_vals = np.zeros((B_r, L), np.float64)
    ell_cols[rows_local, slot] = lc
    ell_vals[rows_local, slot] = np.asarray(vals, np.float64)
    return ell_cols, ell_vals


def matrix_market_lines(rows, cols, vals):
    """The coordinate lines of a Matrix Market file, ``"<row + 1> <col + 1>
    <value>\\n"``, as bytes: from the library in chunks (values with 17
    significant digits), else Python's ``repr`` of each value, as the JAX
    package writes them.  Either reads back to the same doubles."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    lib = _get()
    if lib is None:
        for s in range(0, len(rows), _MM_CHUNK):
            sl = slice(s, s + _MM_CHUNK)
            yield "".join(
                f"{r + 1} {c + 1} {v!r}\n" for r, c, v in zip(
                    rows[sl].tolist(), cols[sl].tolist(),
                    vals[sl].tolist())).encode()
        return
    buf = np.empty(min(len(rows), _MM_CHUNK) * lib.mm_line_max(), np.uint8)
    for s in range(0, len(rows), _MM_CHUNK):
        e = min(s + _MM_CHUNK, len(rows))
        m = lib.mm_format_coo(e - s, rows[s:e], cols[s:e], vals[s:e], buf)
        yield buf[:m].tobytes()
