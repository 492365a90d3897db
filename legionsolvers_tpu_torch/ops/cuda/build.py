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
    from .stencil2d import (FLAT_SHIFTS, FLAT_TARGETS, GEN_UNIT_ELEMS,
                            MAX_TERMS, PASS_COLS, PASS_DOTS, PASS_MAX_STRIDE,
                            PASS_MIN_ROWS, PASS_SLACK, PASS_SMEM_MAX,
                            PASS_TARGET, PASS_THREADS, STENCIL_REACH,
                            STEP2_COLS, STEP2_MIN_ROWS, STEP2_WARPS,
                            STRIP_TARGETS, TILE, WIDE_Z_REACH, _stencil_struct,
                            band_geometry, band_stride, flat_geometry,
                            general_units, gram2_layout, pass_geometry,
                            pass_layout, strip_geometry)
    from .stencil3d import (CHUNK_X, _Stencil3, march1_geometry,
                            window3d_geometry)
    from .vpu_probe import C as VPU_C, TR as VPU_TR

    lib = ctypes.CDLL(str(build()))
    sigs = {
        "ls_stencil2d": [_I] + [_P] * 9 + [_I, _P, _I, _I, _P, _I, _P],
        "ls_xpay_pq": [_P] * 10 + [_I, _P, _I, _I, _P, _I, _P],
        "ls_stencil2d_band": [_I] + [_P] * 9 + [_I, _P, _I, _I, _P, _P],
        "ls_xpay_pq_band": [_P] * 10 + [_I, _P, _I, _I, _P, _P],
        "ls_bicg_pv_band": [_P] * 10 + [_I, _P, _I, _I, _I, _P, _P],
        "ls_bicg_st_band": [_P] * 5 + [_I, _P, _I, _I, _I, _P, _P],
        "ls_bicg_update_band": [_P] * 10 + [_I, _P, _I, _I, _I, _P, _P],
        "ls_pass_band_geometry": [_I, _I, _P],
        "ls_pass_band_layout": [_I, _P, _P],
        "ls_pass_band_consts": [_P],
        "ls_pass_band_attrs": [_I, _I, _P, _P],
        "ls_gram2": [_P] * 4 + [_I, _P, _I, _I, _P, _P],
        "ls_step2": [_P] * 8 + [_I, _P, _I, _I, _P, _P],
        "ls_flat_gram2": [_P] * 4 + [_I, _P, _I, _I, _P, _P],
        "ls_flat_step2": [_P] * 8 + [_I, _P, _I, _I, _P, _P],
        "ls_flat_bicg_st": [_P] * 5 + [_I, _P, _I, _I, _I, _P, _P],
        "ls_flat_shifts": [_P],
        "ls_flat_geometry": [_I, _I, _I, _P],
        "ls_flat_target_warps": [_I],
        "ls_flat_attrs": [_I, _P],
        "ls_step2_nop": [_P] * 8 + [_I, _P, _I, _I, _P, _P],
        "ls_step2_general": [_P] * 9 + [_I, _P, _I, _I, _P, _P],
        "ls_gram2_general": [_P] * 5 + [_I, _P, _I, _I, _P, _P],
        "ls_gram2_band": [_P] * 4 + [_I, _P, _I, _I, _P, _P],
        "ls_gram2_band_layout": [_I, _I, _P],
        "ls_gram2_band_attrs": [_I, _P, _P],
        "ls_step2_band": [_P] * 8 + [_I, _P, _I, _I, _P, _P],
        "ls_step2_band_geometry": [_I, _I, _P],
        "ls_step2_band_stride": [_I, _I],
        "ls_step2_band_attrs": [_I, _P, _P],
        "ls_sstep_general_units": [_I, _I],
        "ls_sstep_general_attrs": [_I, _P],
        "ls_bicg_pv": [_P] * 10 + [_I, _I, _I, _P, _P],
        "ls_bicg_st": [_P] * 5 + [_I, _I, _I, _P, _P],
        "ls_bicg_st_strip": [_P] * 5 + [_I, _P, _I, _I, _I, _P, _P],
        "ls_strip_blocks": [_I] * 3,
        "ls_strip_target_warps": [_I],
        "ls_gram2_attrs": [_I, _P],
        "ls_bicg_st_strip_attrs": [_I, _P],
        "ls_stencil2d_strip_attrs": [_I, _P],
        "ls_xpay_pq_strip_attrs": [_I, _P],
        "ls_bicg_update": [_P] * 10 + [_I, _I, _I, _P, _P],
        "ls_stencil3d": [_I] + [_P] * 9 + [_I, _P] + [_I] * 3 + [_P, _P],
        "ls_xpay_pq3d": [_P] * 8 + [_I, _P] + [_I] * 3 + [_P, _P],
        "ls_bicg3d_pv": [_P] * 12 + [_I, _P] + [_I] * 4 + [_P, _P],
        "ls_stencil3d_m1_attrs": [_I, _P],
        "ls_stencil3d_attrs": [_I, _P],
        "ls_bicg3d_attrs": [_I, _P],
        "ls_bicg3d_pv_m1_attrs": [_I, _P],
        "ls_xpay_pq3d_m1_attrs": [_I, _P],
        "ls_bicg3d_st_m1_attrs": [_I, _P],
        "ls_bicg3d_update_m1_attrs": [_I, _P],
        "ls_march1_blocks": [_I] * 3,
        "ls_window3d_blocks": [_I] * 3,
        "ls_stencil3d_win_attrs": [_I] * 4 + [_P, _P],
        "ls_bicg3d_win_attrs": [_I] * 4 + [_P, _P],
        "ls_bicg3d_st": [_P] * 7 + [_I, _P] + [_I] * 4 + [_P, _P],
        "ls_bicg3d_update": [_P] * 12 + [_I, _P] + [_I] * 4 + [_P, _P],
        "ls_dia2d": [_I] + [_P] * 4 + [_L, _P, _I] + [_P] * 3 + [_I, _I, _P],
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
                 "ls_max_reach", "ls_wide_z",
                 "ls_dia_max_terms", "ls_dia_elems", "ls_vpu_tile_rows",
                 "ls_vpu_tile_cols", "ls_step2_cols", "ls_step2_min_rows",
                 "ls_step2_warps", "ls_blockperm_piece_rows",
                 "ls_sstep_general_unit_elems"):
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
    targets = STRIP_TARGETS
    if ([lib.ls_strip_target_warps(k) for k in range(len(targets))]
            != list(targets)):
        raise RuntimeError("csrc/march2d.cuh and ops/cuda/stencil2d.py "
                           "disagree on the strip passes' target warps")
    for shape in ((4096, 4096), (200, 328), (33, 4097), (4099, 130), (1, 5)):
        for target in targets:
            if (lib.ls_strip_blocks(*shape, target)
                    != strip_geometry(*shape, target)[3]):
                raise RuntimeError(
                    "csrc/march2d.cuh and ops/cuda/stencil2d.py disagree "
                    f"on the strip blocks at {shape}, {target} warps")
    shifts = (ctypes.c_int * 3)()
    if lib.ls_flat_shifts(shifts) or tuple(shifts) != FLAT_SHIFTS:
        raise RuntimeError("csrc/flat1d.cu and ops/cuda/stencil2d.py "
                           "disagree on the flat route's 1-D stencil")
    if ([lib.ls_flat_target_warps(k) for k in range(len(FLAT_TARGETS))]
            != list(FLAT_TARGETS)):
        raise RuntimeError("csrc/flat1d.cu and ops/cuda/stencil2d.py "
                           "disagree on the flat passes' target warps")
    fgeo = (ctypes.c_longlong * 4)()
    for shape in ((4096, 4096), (8, 128), (37, 1000), (3, 1000), (203, 4096),
                  (1, 5), (4099, 130)):
        for target in FLAT_TARGETS:
            if (lib.ls_flat_geometry(*shape, target, fgeo)
                    or tuple(fgeo) != flat_geometry(*shape, target)):
                raise RuntimeError(
                    "csrc/flat1d.cu and ops/cuda/stencil2d.py disagree on "
                    f"the flat geometry at {shape}, {target} warps")
    if lib.ls_sstep_general_unit_elems() != GEN_UNIT_ELEMS or any(
            lib.ls_sstep_general_units(*shape) != general_units(*shape)
            for shape in ((4096, 4096), (1024, 4096), (16, 128), (33, 4097),
                          (1, 5), (5000, 1))):
        raise RuntimeError("csrc/sstep_general.cu and ops/cuda/stencil2d.py "
                           "disagree on the general route's units")
    geo = (ctypes.c_int * 4)()
    for shape in ((4096, 4096), (1024, 4096), (16, 128), (33, 4097),
                  (1, 5), (5000, 1), (5, 130)):
        if (lib.ls_step2_band_geometry(*shape, geo)
                or tuple(geo) != band_geometry(*shape)):
            raise RuntimeError("csrc/sstep_general.cu and ops/cuda/"
                               "stencil2d.py disagree on the band march's "
                               f"geometry at {shape}")
    for C, q in ((4096, 100), (4096, 146), (4096, 147), (4096, 4095),
                 (128, 127), (4097, 100), (130, 129)):
        if lib.ls_step2_band_stride(C, q) != band_stride(C, ((0, q),)):
            raise RuntimeError("csrc/sstep_general.cu and ops/cuda/"
                               "stencil2d.py disagree on the band march's "
                               f"gate at C {C}, |dx| {q}")
    lay = (ctypes.c_int * 3)()
    for C, q in ((4096, 100), (4096, 200), (4096, 841), (4096, 842),
                 (4096, 4095), (128, 127), (4097, 100), (4388, 4387),
                 (4389, 4388), (5000, 4999), (5000, 841), (130, 129)):
        if (lib.ls_gram2_band_layout(C, q, lay)
                or tuple(lay) != gram2_layout(C, ((0, q),))):
            raise RuntimeError("csrc/sstep_general.cu and ops/cuda/"
                               "stencil2d.py disagree on K2's band gate at "
                               f"C {C}, |dx| {q}")
    consts = (ctypes.c_int * 8)()
    if lib.ls_pass_band_consts(consts) or tuple(consts) != (
            PASS_THREADS, PASS_COLS, PASS_MIN_ROWS, PASS_TARGET,
            PASS_MAX_STRIDE, PASS_SLACK, PASS_SMEM_MAX, PASS_DOTS):
        raise RuntimeError("csrc/band2d.cu and ops/cuda/stencil2d.py "
                           "disagree on the band route's constants")
    for shape in ((4096, 4096), (1024, 4096), (8, 128), (37, 1000),
                  (1, 101), (33, 4097), (20, 5000), (40, 130)):
        if (lib.ls_pass_band_geometry(*shape, geo)
                or tuple(geo) != pass_geometry(*shape)):
            raise RuntimeError("csrc/band2d.cu and ops/cuda/stencil2d.py "
                               "disagree on the band route's geometry at "
                               f"{shape}")
    for C, offs in ((4096, ((0, 0), (1, -4095), (-8, 100))),
                    (4096, ((0, 0), (-1, 100), (1, -100), (0, 37))),
                    (4096, ((0, 0), (-8, 0), (8, 0))), (128, ((-1, 127),)),
                    (5000, ((0, 0), (1, -4999), (-8, 100))),
                    (130, ((2, 0), (0, -129))), (4100, ((0, 0), (0, 2)))):
        st = _stencil_struct(offs, (1.0,) * len(offs))
        if (lib.ls_pass_band_layout(C, ctypes.byref(st), geo)
                or tuple(geo) != pass_layout(C, offs)):
            raise RuntimeError("csrc/band2d.cu and ops/cuda/stencil2d.py "
                               "disagree on the band route's gate at C "
                               f"{C}, {offs}")
    if lib.ls_blockperm_piece_rows() != PIECE_ROWS:
        raise RuntimeError("csrc/rowperm.cu and ops/cuda/rowperm.py "
                           "disagree on LS_BLOCKPERM_PIECE_ROWS")
    if (lib.ls_chunk_x() != CHUNK_X
            or lib.ls_stencil3_size() != ctypes.sizeof(_Stencil3)
            or lib.ls_max_reach() != STENCIL_REACH
            or lib.ls_wide_z() != WIDE_Z_REACH):
        raise RuntimeError("csrc/bicgstab3d.cu, csrc/common.cuh and "
                           "ops/cuda/stencil3d.py disagree on LS_CHUNK_X, "
                           "the LsStencil3 layout, LS_MAX_REACH or LS_WIDE_Z")
    for shape in ((256, 256, 256), (37, 45, 130), (1, 1, 1), (999, 17, 5)):
        if lib.ls_march1_blocks(*shape) != march1_geometry(*shape)[2]:
            raise RuntimeError("csrc/common.cuh and ops/cuda/stencil3d.py "
                               f"disagree on march1's blocks at {shape}")
        if lib.ls_window3d_blocks(*shape) != window3d_geometry(*shape)[2]:
            raise RuntimeError("csrc/common.cuh and ops/cuda/stencil3d.py "
                               "disagree on the window march's blocks at "
                               f"{shape}")
    if (lib.ls_dia_max_terms() != MAX_DIA_TERMS
            or lib.ls_dia_elems() != DIA_ELEMS):
        raise RuntimeError("csrc/dia2d.cu and ops/cuda/dia2d.py disagree on "
                           "LS_DIA_MAX_TERMS or LS_DIA_ELEMS")
    if lib.ls_vpu_tile_rows() != VPU_TR or lib.ls_vpu_tile_cols() != VPU_C:
        raise RuntimeError("csrc/vpu_probe.cu and ops/cuda/vpu_probe.py "
                           "disagree on the probe's tile")
    return lib
