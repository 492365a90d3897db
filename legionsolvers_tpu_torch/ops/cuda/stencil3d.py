"""3-D grid stencil SpMV and fused-CG passes: wrappers, plain versions, gates.

Port of ``legionsolvers_tpu/ops/pallas/stencil3d.py``.  Each pass has a
hand-written CUDA kernel in ``csrc/stencil3d.cu`` and a plain PyTorch
version here:

=====================  ==================================  =================
wrapper                computes                            plain version
=====================  ==================================  =================
grid3d_stencil_matvec  y = A x, optionally <x, A x>        stencil3d_plain
grid3d_cg_pq           <p, A p> (A p never stored)         stencil3d_plain
grid3d_cg_update       x += a p, r -= a A p, <r', r'>      stencil3d_plain
grid3d_cg_xpay_pq      p = r + b p_old, <p, A p>           xpay_pq3d_plain
=====================  ==================================  =================

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches its kernel (built at first use, see ``build.py``) or raises; it
never falls back.  K6a and K6b have two marches (``csrc/common.cuh``), one
launch each, the dot folded into the last block: reach-1 stencils (the 7-
and 27-point ones) run the register march ``march1``, whose launch
geometry :func:`march1_geometry` mirrors; stencils of reach 2..8, and any
stencil with a z shift past 8 (up to 128, JAX's ``PADZ``), run the window
march, whose window holds every z shift a term reads
(:func:`window3d_geometry`, :func:`window3d_smem`).  :func:`route3d` gives
the march of every 3-D pass, K7's too (whose update with compensated dots
runs ``march3d`` on reach-1 stencils, with a second launch summing its
partial dots).  All take their scratch from :func:`march_scratch`.  Every
CUDA launch adds one to :data:`~.stencil2d.LAUNCHES` under the pass's name
with a ``3d`` suffix (``y3d``, ``y_dot3d``, ``pq3d``, ``update3d``,
``xpay_pq3d``).

Semantics follow the JAX kernels.  ``x`` is the volume ``[X, Y, Z]`` (f32);
stencil offsets are ``(ox, oy, oz)`` triples.  Points outside ``[0, Y) x
[0, Z)`` read as zero; the planes outside ``[0, X)`` come from the optional
``[Y, Z]`` halo planes (``halo_top`` is plane -1, ``halo_bot`` plane X;
``None`` means zeros).  ``xpay_pq`` takes p's own halo planes (r's plus
beta times p_old's), as the JAX kernel does.  Buffers differ from the JAX
aliasing contract: ``update`` writes x and r in place, and ``xpay_pq``
writes p to ``out`` rather than over p_old, because on the GPU a block
writing p_old would race a neighbouring block reading its window.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .stencil2d import (
    MAX_TERMS,
    STENCIL_REACH,
    TILE,
    WIDE_Z_REACH,
    _MODES,
    _check_distinct,
    _dev_scalars,
    _dot,
    _launch,
    _on_cuda,
    _ptr,
    _raw_stream,
    _check_grid,
    mode_outputs,
)

CHUNK_X = 16  # x-planes one march3d block marches over (csrc: LS_CHUNK_X)
M1_TY = 16  # march1: tile rows (csrc: LS_M1_TY)
M1_TZ = 128  # march1: tile columns (LS_M1_TZ)
M1_MIN_CHUNK = 8  # march1: x chunks no more than X / 8 (LS_M1_MIN_CHUNK)
M1_TARGET_BLOCKS = 264  # march1: blocks a launch aims at (LS_M1_TARGET_BLOCKS)
W3_TY = 16  # window march: tile rows (LS_W3_TY)
W3_TZ = 256  # window march: tile columns (LS_W3_TZ)
W3_MIN_CHUNK = 4  # window march: x chunks no more than X / 4
W3_TARGET_BLOCKS = 396  # window march: blocks a launch aims at


# ===========================================================================
# gates
# ===========================================================================

def supports3d(X: int, Y: int, Z: int, offsets) -> bool:
    """Whether the K6 kernels take this geometry: any X, Y, Z >= 1, at most
    32 terms with |ox| <= 1, |oy| <= 8 and |oz| <= 128 (JAX's ``PADY`` and
    ``PADZ``), and |oz| < Z, as the 2-D gate takes |dx| < C (a term with
    |oz| >= Z reads only zeros; JAX takes |oz| = Z = 128).  The TPU's
    Z % 128 and VMEM-budget gates do not apply."""
    return (X >= 1 and Y >= 1 and Z >= 1 and 1 <= len(offsets) <= MAX_TERMS
            and all(abs(ox) <= 1 and abs(oy) <= STENCIL_REACH
                    and abs(oz) <= WIDE_Z_REACH and abs(oz) < Z
                    for ox, oy, oz in offsets))


def supports3d_xpay_pq(X: int, Y: int, Z: int, offsets) -> bool:
    """K6b's gate, which is K6a's: the JAX gate adds only a VMEM budget."""
    return supports3d(X, Y, Z, offsets)


# ===========================================================================
# plain PyTorch versions
# ===========================================================================

def apply_planes_plain(v, offsets, values, halo_top=None, halo_bot=None):
    """A v for the 3-D stencil: zero outside [0, Y) x [0, Z), planes -1
    and X from the halo planes (zeros when ``None``).  Terms are summed in
    offset order, as the kernels do.  y is padded by the y reach and z by
    the z reach, each alone."""
    X, Y, Z = v.shape
    hy = max(abs(oy) for _, oy, _ in offsets)
    hz = max(abs(oz) for _, _, oz in offsets)
    z = v.new_zeros(1, Y, Z)
    ext = torch.cat([z if halo_top is None else halo_top[None], v,
                     z if halo_bot is None else halo_bot[None]])
    ext = F.pad(ext, (hz, hz, hy, hy))
    acc = None
    for (ox, oy, oz), w in zip(offsets, values):
        term = w * ext[1 + ox: 1 + ox + X, hy + oy: hy + oy + Y,
                       hz + oz: hz + oz + Z]
        acc = term if acc is None else acc + term
    return acc


def stencil3d_plain(mode, x, halo_top, halo_bot, extra=(), *, offsets,
                    values, out=None):
    """The one-pass modes of K6a (``extra`` as in :func:`_stencil3d_call`).
    Returns ``(y,)``, ``(y, dot)``, ``(dot,)`` or ``(x', r', rr)``; the
    update mode writes x' and r' into the given x and r, the y modes y
    into ``out`` where given."""
    y = apply_planes_plain(x, offsets, values, halo_top, halo_bot)
    if out is not None:
        y = out.copy_(y)
    return mode_outputs(mode, x, y, extra)


def xpay_pq3d_plain(r, p_old, beta, pn_top=None, pn_bot=None, *, offsets,
                    values, out=None):
    """K6b: p = r + beta p_old and <p, A p>, with p's halo planes."""
    b = torch.as_tensor(beta, dtype=torch.float32).to(r.dtype)
    p = r + b * p_old
    Ap = apply_planes_plain(p, offsets, values, pn_top, pn_bot)
    if out is not None:
        p = out.copy_(p)
    return p, _dot(p, Ap)


# ===========================================================================
# CUDA launch plumbing
# ===========================================================================

class _Stencil3(ctypes.Structure):
    """Mirror of ``LsStencil3`` in csrc/common.cuh."""
    _fields_ = [
        ("n", ctypes.c_int),
        ("ox", ctypes.c_int * MAX_TERMS),
        ("oy", ctypes.c_int * MAX_TERMS),
        ("oz", ctypes.c_int * MAX_TERMS),
        ("v", ctypes.c_float * MAX_TERMS),
    ]


_STRUCTS3 = {}


def _stencil3_struct(offsets, values) -> _Stencil3:
    """The kernels' stencil argument, made once per (offsets, values) and
    shared by every call with them (the kernels only read it)."""
    key = (tuple(map(tuple, offsets)), tuple(values))
    st = _STRUCTS3.get(key)
    if st is None:
        st = _Stencil3()
        st.n = len(offsets)
        for k, ((ox, oy, oz), v) in enumerate(zip(offsets, values)):
            st.ox[k], st.oy[k], st.oz[k] = int(ox), int(oy), int(oz)
            st.v[k] = float(v)
        _STRUCTS3[key] = st
    return st


def blocks3d(X: int, Y: int, Z: int) -> int:
    """Blocks of a march3d launch (K7 update with compensated dots on a
    reach-1 stencil): (y, z) tiles times x chunks."""
    return -(-Z // TILE) * -(-Y // TILE) * -(-X // CHUNK_X)


def march1_geometry(X: int, Y: int, Z: int):
    """(tiles, planes per chunk, blocks) of a march1 launch, as
    ``m1_geometry`` in csrc/common.cuh computes them: M1_TY x M1_TZ (y, z)
    tiles, and x chunks aiming at M1_TARGET_BLOCKS blocks, no more of them
    than chunks of M1_MIN_CHUNK planes would need.  A function of the
    shape alone."""
    tiles = -(-Z // M1_TZ) * -(-Y // M1_TY)
    chunks = max(1, min(M1_TARGET_BLOCKS // tiles, -(-X // M1_MIN_CHUNK)))
    chunk = -(-X // chunks)
    return tiles, chunk, tiles * -(-X // chunk)


def window3d_geometry(X: int, Y: int, Z: int):
    """(tiles, planes per chunk, blocks) of a window-march launch (every
    3-D pass off march1), as ``w3_geometry`` in csrc/common.cuh computes
    them: W3_TY x W3_TZ (y, z) tiles, and x chunks aiming at
    W3_TARGET_BLOCKS blocks, no more of them than chunks of W3_MIN_CHUNK
    planes would need.  A function of the shape alone."""
    tiles = -(-Z // W3_TZ) * -(-Y // W3_TY)
    chunks = max(1, min(W3_TARGET_BLOCKS // tiles, -(-X // W3_MIN_CHUNK)))
    chunk = -(-X // chunks)
    return tiles, chunk, tiles * -(-X // chunk)


def window3d_smem(Z: int, offsets) -> int:
    """Shared-memory bytes of the window march's three planes on Z columns
    with this stencil: (W3_TY + 2 hy) rows of min(Z, W3_TZ + 2 hz) floats,
    hy and hz the widest |oy| and |oz| (``w3_smem``).  At most 192 KB, so
    every stencil of the gate fits."""
    hy = max(abs(oy) for _, oy, _ in offsets)
    hz = max(abs(oz) for _, _, oz in offsets)
    return 3 * (W3_TY + 2 * hy) * min(Z, W3_TZ + 2 * hz) * 4


# The 3-D passes by their LAUNCHES names: K6a's four modes, K6b and K7's
# three, each on march1 or the window march; and the one that runs
# march3d, K7 update with compensated dots on a reach-1 stencil.
PASSES3D = ("y3d", "y_dot3d", "pq3d", "update3d", "xpay_pq3d", "bicg3d_pv",
            "bicg3d_st", "bicg3d_update")
MARCH3D_PASSES = ("bicg3d_update",)


def route3d(pass_name: str, offsets, compensated: bool = False) -> str:
    """The march the 3-D pass ``pass_name`` (its LAUNCHES name) runs for
    this stencil, as ``ls_stencil3d``, ``ls_xpay_pq3d`` and
    ``ls_bicg3d_*`` in csrc choose it: for reach 1 (|oy|, |oz| <= 1:
    ``on_march1``) ``march1``, but ``march3d`` for K7 update with
    ``compensated`` dots; ``window`` (the window march) for every other
    stencil."""
    if pass_name not in PASSES3D:
        raise ValueError(f"not a 3-D pass: {pass_name!r}")
    if max(max(abs(oy), abs(oz)) for _, oy, oz in offsets) > 1:
        return "window"
    if pass_name in MARCH3D_PASSES and compensated:
        return "march3d"
    return "march1"


def xpay_pq3d_route(offsets) -> str:
    """K6b's march: ``route3d("xpay_pq3d", offsets)``."""
    return route3d("xpay_pq3d", offsets)


def march_scratch_size(X: int, Y: int, Z: int) -> int:
    """Blocks of the largest of the marches' launches on an [X, Y, Z]
    volume: the capacity :func:`march_scratch` passes to the kernels."""
    return max(blocks3d(X, Y, Z), march1_geometry(X, Y, Z)[2],
               window3d_geometry(X, Y, Z)[2])


DOTS_PER_BLOCK = 2  # the most partial dots a 3-D pass keeps per block (K7)


def march_scratch_entries(X: int, Y: int, Z: int) -> int:
    """float64 entries of :func:`march_scratch`'s partials: DOTS_PER_BLOCK
    per block of the larger march."""
    return DOTS_PER_BLOCK * march_scratch_size(X, Y, Z)


_MARCH_SCRATCH = {}


def march_scratch(device, X: int, Y: int, Z: int):
    """(partials, capacity, counter) of the 3-D passes' launches on an
    [X, Y, Z] volume: float64 partial dots with room for two per block of
    any march (K7 st and update keep two doubles; the other passes one
    float, or K7 pv one double under ``compensated``), and the last-block
    counter of march1 and the window march (zero between launches).  Made
    once per (device, stream, X, Y, Z): launches on one stream are
    ordered, so they can share them."""
    key = (device, _raw_stream(device), X, Y, Z)
    scratch = _MARCH_SCRATCH.get(key)
    if scratch is None:
        scratch = (torch.empty(march_scratch_entries(X, Y, Z),
                               dtype=torch.float64, device=device),
                   march_scratch_size(X, Y, Z),
                   torch.zeros(1, dtype=torch.int32, device=device))
        _MARCH_SCRATCH[key] = scratch
    return scratch


def check_volume(name, t, shape=None):
    _check_grid(name, t, shape, ndim=3)


def check_planes(X, Y, Z, offsets, **planes):
    """The volume's gate and its optional [Y, Z] halo planes."""
    if not supports3d(X, Y, Z, offsets):
        raise ValueError(f"unsupported stencil geometry X={X} Y={Y} Z={Z}")
    for name, h in planes.items():
        if h is not None:
            _check_grid(name, h, (Y, Z))


# ===========================================================================
# K6a: one-pass stencil modes
# ===========================================================================

def _stencil3d_call(x, halo_top, halo_bot, extra=(), *, offsets, values,
                    mode: str = "y", out=None):
    """Shared body of the K6a modes.  ``extra`` is () except for mode
    ``update``, where it is (xv, rv, alpha) and x is the search direction p.
    ``out``: where the y modes write y (a fresh buffer when ``None``; it may
    not share storage with x)."""
    check_volume("x", x)
    X, Y, Z = x.shape
    check_planes(X, Y, Z, offsets, halo_top=halo_top, halo_bot=halo_bot)
    tensors = [x, halo_top, halo_bot]
    if out is not None:
        if mode not in ("y", "y_dot"):
            raise ValueError(f"mode {mode!r} writes no y")
        check_volume("out", out, (X, Y, Z))
        _check_distinct(("x", x), ("out", out))
        tensors.append(out)
    if mode == "update":
        xv, rv, _ = extra
        check_volume("xv", xv, (X, Y, Z))
        check_volume("rv", rv, (X, Y, Z))
        _check_distinct(("p", x), ("x", xv), ("r", rv))
        tensors += [xv, rv]
    if not _on_cuda(*tensors):
        return stencil3d_plain(mode, x, halo_top, halo_bot, extra,
                               offsets=offsets, values=values, out=out)
    dev = x.device
    y = None
    if mode in ("y", "y_dot"):
        y = torch.empty_like(x) if out is None else out
    xv = rv = alpha = None
    if mode == "update":
        xv, rv, alpha = extra
        alpha = _dev_scalars(alpha, 1, dev)
    dot = torch.empty(1, dtype=torch.float32, device=dev)
    partials, capacity, counter = march_scratch(dev, X, Y, Z)
    st = _stencil3_struct(offsets, values)
    _launch(mode + "3d", "ls_stencil3d", (
        _MODES[mode], _ptr(x), _ptr(halo_top), _ptr(halo_bot), _ptr(y),
        _ptr(xv), _ptr(rv), _ptr(alpha), _ptr(dot), _ptr(partials),
        capacity, _ptr(counter), X, Y, Z, ctypes.byref(st),
    ), dev)
    if mode == "y":
        return (y,)
    if mode == "y_dot":
        return y, dot[0]
    if mode == "pq":
        return (dot[0],)
    return xv, rv, dot[0]


def grid3d_stencil_matvec(x, halo_top=None, halo_bot=None, *, offsets,
                          values, with_dot: bool = False, out=None):
    """y = A @ x (and optionally <x, y>) for the 3-D stencil
    {(ox, oy, oz): v} over the [X, Y, Z] volume, y written to ``out`` (a
    fresh buffer when ``None``)."""
    res = _stencil3d_call(x, halo_top, halo_bot, offsets=offsets,
                          values=values, mode="y_dot" if with_dot else "y",
                          out=out)
    return res if with_dot else res[0]


def grid3d_cg_pq(p, halo_top=None, halo_bot=None, *, offsets, values):
    """<p, A p> without storing A p (the 3-D fused-CG prologue)."""
    return _stencil3d_call(p, halo_top, halo_bot, offsets=offsets,
                           values=values, mode="pq")[0]


def grid3d_cg_update(p, x, r, alpha, halo_top=None, halo_bot=None, *,
                     offsets, values):
    """(x + alpha p, r - alpha A p, <r', r'>) with A p formed on chip only.
    x and r are updated in place."""
    return _stencil3d_call(p, halo_top, halo_bot, (x, r, alpha),
                           offsets=offsets, values=values, mode="update")


# ===========================================================================
# K6b: xpay + pq
# ===========================================================================

def grid3d_cg_xpay_pq(r, p_old, beta, pn_top=None, pn_bot=None, *, offsets,
                      values, out=None):
    """(p, <p, A p>) where p = r + beta p_old, written to ``out`` (a fresh
    buffer when ``None``; it may not share storage with r or p_old).
    ``pn_top``/``pn_bot`` are p's halo planes."""
    check_volume("r", r)
    X, Y, Z = r.shape
    check_planes(X, Y, Z, offsets, pn_top=pn_top, pn_bot=pn_bot)
    check_volume("p_old", p_old, (X, Y, Z))
    if out is not None:
        check_volume("out", out, (X, Y, Z))
        _check_distinct(("r", r), ("p_old", p_old), ("out", out))
    if not _on_cuda(r, p_old, pn_top, pn_bot, out):
        return xpay_pq3d_plain(r, p_old, beta, pn_top, pn_bot,
                               offsets=offsets, values=values, out=out)
    dev = r.device
    p = torch.empty_like(r) if out is None else out
    b = _dev_scalars(beta, 1, dev)
    dot = torch.empty(1, dtype=torch.float32, device=dev)
    partials, capacity, counter = march_scratch(dev, X, Y, Z)
    st = _stencil3_struct(offsets, values)
    _launch("xpay_pq3d", "ls_xpay_pq3d", (
        _ptr(r), _ptr(p_old), _ptr(b), _ptr(pn_top), _ptr(pn_bot), _ptr(p),
        _ptr(dot), _ptr(partials), capacity, _ptr(counter), X, Y, Z,
        ctypes.byref(st),
    ), dev)
    return p, dot[0]
