"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` (all include the shared header ``csrc/common.cuh``) is
compiled by its own ``nvcc``, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library goes to ``build/`` at the repository root, named by a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as is.  Nothing is built when this module is
imported: the first CUDA launch calls :func:`load_library`.  Without
``nvcc`` it raises; there is no fallback to the plain versions for CUDA
tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

NVCC_FALLBACKS = ("/usr/local/cuda/bin/nvcc",)

#: What the last build in this process did: library path, seconds, log.
BUILD_INFO = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then the toolkit's
    default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        candidates.append(which)
    candidates.extend(NVCC_FALLBACKS)
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda); "
        "the CUDA kernels of legionsolvers_tpu_torch cannot be built"
    )


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*_sources(), *CSRC_DIR.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblegionsolvers_cuda_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the sources unless the library for them exists already."""
    out = library_path()
    if out.exists():
        BUILD_INFO.update(path=str(out), seconds=0.0, log="(cached)")
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    srcs, jobs = _sources(), []
    for src in srcs:
        obj = BUILD_DIR / f"{tmp.name}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = "", []
    for (obj, proc), src in zip(jobs, srcs):
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(src.name)
    if not failed:
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
             *(str(obj) for obj, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log += link.stdout
        if link.returncode != 0:
            failed.append("link")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    BUILD_INFO.update(path=str(out), seconds=seconds, log=log)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argument types declared (pointers and the stream as
    ``c_void_p``, so that none is cut to 32 bits)."""
    from .dia2d import DIA_ELEMS, MAX_DIA_TERMS
    from .rowperm import PIECE_ROWS
    from .stencil2d import MAX_TERMS, STEP2_COLS, STEP2_MIN_ROWS, TILE
    from .stencil2d import STEP2_WARPS
    from .stencil3d import CHUNK_X, _Stencil3, march1_geometry
    from .vpu_probe import C as VPU_C, TR as VPU_TR

    lib = ctypes.CDLL(str(build()))
    sigs = {
        "ls_stencil2d": [_I] + [_P] * 9 + [_I, _I, _P, _P],
        "ls_xpay_pq": [_P] * 10 + [_I, _I, _P, _P],
        "ls_gram2": [_P] * 4 + [_I, _I, _P, _P],
        "ls_step2": [_P] * 8 + [_I, _P, _I, _I, _P, _P],
        "ls_bicg_pv": [_P] * 10 + [_I, _I, _I, _P, _P],
        "ls_bicg_st": [_P] * 5 + [_I, _I, _I, _P, _P],
        "ls_bicg_update": [_P] * 10 + [_I, _I, _I, _P, _P],
        "ls_stencil3d": [_I] + [_P] * 9 + [_I, _P] + [_I] * 3 + [_P, _P],
        "ls_xpay_pq3d": [_P] * 8 + [_I, _P] + [_I] * 3 + [_P, _P],
        "ls_bicg3d_pv": [_P] * 12 + [_I, _P] + [_I] * 4 + [_P, _P],
        "ls_stencil3d_m1_attrs": [_I, _P],
        "ls_bicg3d_pv_m1_attrs": [_I, _P],
        "ls_xpay_pq3d_m1_attrs": [_I, _P],
        "ls_bicg3d_st_m1_attrs": [_I, _P],
        "ls_bicg3d_update_m1_attrs": [_I, _P],
        "ls_march1_blocks": [_I] * 3,
        "ls_bicg3d_st": [_P] * 7 + [_I, _P] + [_I] * 4 + [_P, _P],
        "ls_bicg3d_update": [_P] * 12 + [_I, _P] + [_I] * 4 + [_P, _P],
        "ls_dia2d": [_I] + [_P] * 5 + [_I] + [_P] * 3 + [_I, _I, _P],
        "ls_winell": [_I] + [_P] * 5 + [_I] * 3 + [_P],
        "ls_blockperm": [_I] + [_P] * 4 + [_I, _I, _P] + [_I] * 4 + [_P],
        "ls_vpu_chain": [_I, _P, _P, _I, _I, _L, _P],
        "ls_copy_probe": [_P, _P, _L, _L, _P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in ("ls_tile", "ls_max_terms", "ls_chunk_x", "ls_stencil3_size",
                 "ls_dia_max_terms", "ls_dia_elems", "ls_vpu_tile_rows",
                 "ls_vpu_tile_cols", "ls_step2_cols", "ls_step2_min_rows",
                 "ls_step2_warps", "ls_blockperm_piece_rows"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.ls_error_string.argtypes = [ctypes.c_int]
    lib.ls_error_string.restype = ctypes.c_char_p
    if (lib.ls_tile() != TILE or lib.ls_max_terms() != MAX_TERMS
            or lib.ls_step2_cols() != STEP2_COLS
            or lib.ls_step2_min_rows() != STEP2_MIN_ROWS
            or lib.ls_step2_warps() != STEP2_WARPS):
        raise RuntimeError("csrc/stencil2d.cu and ops/cuda/stencil2d.py "
                           "disagree on LS_TILE, LS_MAX_TERMS or K1's "
                           "strip geometry")
    if lib.ls_blockperm_piece_rows() != PIECE_ROWS:
        raise RuntimeError("csrc/rowperm.cu and ops/cuda/rowperm.py "
                           "disagree on LS_BLOCKPERM_PIECE_ROWS")
    if (lib.ls_chunk_x() != CHUNK_X
            or lib.ls_stencil3_size() != ctypes.sizeof(_Stencil3)):
        raise RuntimeError("csrc/common.cuh and ops/cuda/stencil3d.py "
                           "disagree on LS_CHUNK_X or the LsStencil3 layout")
    for shape in ((256, 256, 256), (37, 45, 130), (1, 1, 1), (999, 17, 5)):
        if lib.ls_march1_blocks(*shape) != march1_geometry(*shape)[2]:
            raise RuntimeError("csrc/common.cuh and ops/cuda/stencil3d.py "
                               f"disagree on march1's blocks at {shape}")
    if (lib.ls_dia_max_terms() != MAX_DIA_TERMS
            or lib.ls_dia_elems() != DIA_ELEMS):
        raise RuntimeError("csrc/dia2d.cu and ops/cuda/dia2d.py disagree on "
                           "LS_DIA_MAX_TERMS or LS_DIA_ELEMS")
    if lib.ls_vpu_tile_rows() != VPU_TR or lib.ls_vpu_tile_cols() != VPU_C:
        raise RuntimeError("csrc/vpu_probe.cu and ops/cuda/vpu_probe.py "
                           "disagree on the probe's tile")
    return lib
