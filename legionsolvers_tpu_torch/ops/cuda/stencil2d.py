"""2-D grid stencil SpMV and fused-CG passes: wrappers, plain versions, gates.

Port of ``legionsolvers_tpu/ops/pallas/stencil2d.py``.  Each pass has a
hand-written CUDA kernel in ``csrc/stencil2d.cu`` and a plain PyTorch
version here:

=====================  ==================================  =================
wrapper                computes                            plain version
=====================  ==================================  =================
grid2d_stencil_matvec  y = A x, optionally <x, A x>        stencil_plain
grid2d_cg_pq           <p, A p> (A p never stored)         stencil_plain
grid2d_cg_update       x += a p, r -= a A p, <r', r'>      stencil_plain
grid2d_cg_xpay_pq      p = r + b p_old, <p, A p>           xpay_pq_plain
grid2d_cg_gram2        Gram vector of (r, p)               gram2_plain
grid2d_cg_step2        two CG iterations + next Gram       step2_plain
_grid2d_cg_nop         K1's I/O, trivial body (diagnostic)  nop_plain
=====================  ==================================  =================

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches its kernel (built from the repo's sources at first use, see
``build.py``) or raises; it never falls back.  Every CUDA launch adds one
to :data:`LAUNCHES` under the pass's name.  :func:`route` picks the
kernel: with a reach-1 stencil every pass runs the column-strip register
march (``csrc/march2d.cuh``), its dots folded into its last block (one
launch); with the flat decomposition of a reach-1 1-D stencil (the 1-D
kernel view, :func:`decompose_flat_offsets`) K3 and K4 run the same
march on the 1-D stencil with its WRAP flag, every element addressed by
its flat index, and K1, K2 and K5b march along the flat index itself
(``csrc/flat1d.cu``, :func:`flat_geometry`; the 1-D stencil of
:data:`FLAT_SHIFTS`); K3 and K4 with any other stencil (|dy| <= 8, |dx| <
C), and K5a-c with them, run the band march (``csrc/band2d.cu``, route
``band``): a march down bands of rows that keeps the operand's rows in a
shared-memory ring and reads every term from it, its dots folded into its
last block, where :func:`pass_layout` takes the width and the stencil,
else the tile kernels, whose terms with |dx| > 8 read device memory beside
the tile, and a second launch that sums their dots; K5a and K5c run the
band march also on the flat route's stencils and the tile kernels on
reach-1 ones; K1 and K2 with any other stencil
(|dy| <= 1, |dx| < C) run the general route (``csrc/sstep_general.cu``):
each on its band march, a march down bands of rows with every intermediate
in shared-memory rings (route ``general``, where :func:`band_stride`, K1's
gate, or :func:`gram2_layout`, K2's, takes the width and the widest
|dx|), else one cooperative launch of stages over the whole grid,
separated by a grid-wide barrier, the intermediates in a workspace
(``general_coop``).

Semantics follow the JAX kernels.  ``x`` is the grid ``[R, C]`` (f32);
stencil offsets are ``(dy, dx)`` pairs, |dy| <= 8 and |dx| < C.  Columns
outside ``[0, C)`` read as zero.  Rows outside ``[0, R)`` come from the
optional ``[8, C]`` halo blocks of the one-pass modes (real rows last in
the top block, first in the bottom block; ``None`` means zeros).  ``gram2``/``step2`` are zero-halo
Dirichlet passes whose chained stencil applications are the true matrix
powers.  Buffers differ from the JAX aliasing contract: ``update`` writes
x and r in place, ``step2`` writes x in place, and the new r/p of
``step2`` and p of ``xpay_pq`` go to separate buffers (``out``), because
on the GPU a block writing r or p would race a neighbouring block reading
its halo.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

GRAM_NAMES = ("rr", "pAp", "rAp", "ApAp", "rAr",
              "ApAr", "ApA2p", "ArAr", "ArA2p", "A2pA2p")

TILE = 32          # output tile edge of the tile kernels (csrc: LS_TILE)
MAX_TERMS = 32     # stencil terms a kernel accepts (csrc: LS_MAX_TERMS)
HALO_ROWS = 8      # rows in a halo block
STENCIL_REACH = 8  # 3-D gate: |oy| <= 8; tile halo of K3/K4/K5 (csrc:
                   # LS_MAX_REACH)
WIDE_Z_REACH = 128  # 3-D gate: |oz| <= 128, the TPU kernel's PADZ, which
                    # the window march's window holds (LS_WIDE_Z)
STEP2_REACH = 1    # K1/K2 gate's |dy|; the strip route's reach (K1-K5b)
STEP2_COLS = 120   # strip passes: output columns of a warp's strip
STEP2_MIN_ROWS = 16  # strip passes: shortest row chunk
STEP2_WARPS = 4    # strip passes: warps per block
# The strip passes' row chunks aim at one wave of their resident blocks on
# each of an H100 SXM's 132 SMs (csrc/march2d.cuh): K1 3 blocks per SM,
# K2 4, K5b, K3 and K4 8
STEP2_TARGET_WARPS = 132 * 3 * STEP2_WARPS
GRAM2_TARGET_WARPS = 132 * 4 * STEP2_WARPS
ST_TARGET_WARPS = 132 * 8 * STEP2_WARPS
STENCIL_TARGET_WARPS = 132 * 8 * STEP2_WARPS
XPAY_TARGET_WARPS = 132 * 8 * STEP2_WARPS
# every strip pass's target, in ls_strip_target_warps order (K1, K2, K5b,
# K3, K4)
STRIP_TARGETS = (STEP2_TARGET_WARPS, GRAM2_TARGET_WARPS, ST_TARGET_WARPS,
                 STENCIL_TARGET_WARPS, XPAY_TARGET_WARPS)
STEP2_GRAM = 10    # doubles of a block's partial sums in the strip scratch
GEN_UNIT_ELEMS = 8192  # general route: elements of a unit of whole rows
                       # (csrc/sstep_general.cu: LS_GEN_UNIT_ELEMS)
# K1's band march (csrc/sstep_general.cu: LS_BAND_*)
BAND_COLS = 1024       # output columns of a strip, at most
BAND_MIN_ROWS = 16     # shortest band
BAND_TARGET = 264      # units (strips x bands) a launch aims at
BAND_RING_ROWS = 25    # shared-memory ring rows of the seven rings
BAND_THREADS = 512     # threads of a block
# floats of a ring row, at most: the rings, one row more and a block's
# width of slack fit the kernel's 225 KB of shared memory
BAND_MAX_STRIDE = (225 * 1024 // 4 - BAND_THREADS) // (BAND_RING_ROWS + 1)
# K2's band march (csrc/sstep_general.cu: LS_G2_*): K1's strips, bands and
# threads, rings of 12 rows (p 4, r 5, A p 3)
G2_RING_ROWS = 12
G2_MAX_STRIDE = (225 * 1024 // 4 - BAND_THREADS) // (G2_RING_ROWS + 1)
# K3 and K4 on the band route (csrc/band2d.cu: LS_PASS_*)
PASS_THREADS = 512     # threads of a block
PASS_COLS = 4096       # output columns of a strip, at most
PASS_MIN_ROWS = 16     # shortest band
PASS_TARGET = 132      # units (strips x bands) a launch aims at: one per SM
PASS_MAX_STRIDE = 6144  # floats of a ring row, at most
PASS_SLACK = 4 * PASS_THREADS  # floats after the ring
PASS_SMEM_MAX = 225 * 1024     # dynamic shared memory, at most
PASS_DOTS = 2          # partial dots of a unit in the scratch (K5b's two)
# K1, K2 and K5b on the flat route (csrc/flat1d.cu: LS_FLAT_*): a warp's
# step is a segment of FLAT_SEG elements, its run at least FLAT_MIN_SEGS
# segments; runs aim at one wave of the pass's resident blocks on 132 SMs
# (K1 4 per SM, K2 5, K5b 8)
FLAT_SEG = 128
FLAT_MIN_SEGS = 16
FLAT_STEP2_TARGET_WARPS = 132 * 4 * STEP2_WARPS
FLAT_GRAM2_TARGET_WARPS = 132 * 5 * STEP2_WARPS
FLAT_ST_TARGET_WARPS = 132 * 8 * STEP2_WARPS
# every flat pass's target, in ls_flat_target_warps order (K1, K2, K5b)
FLAT_TARGETS = (FLAT_STEP2_TARGET_WARPS, FLAT_GRAM2_TARGET_WARPS,
                FLAT_ST_TARGET_WARPS)
# the shifts of the 1-D stencil that flat1d.cu compiles, in stencil order
# (LS_FLAT_SHIFTS): the 1-D Laplacian's
FLAT_SHIFTS = (0, -1, 1)

#: CUDA launches per pass name since the last :func:`reset_launch_counts`.
LAUNCHES = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


# ===========================================================================
# gates
# ===========================================================================

def _reach(offsets) -> int:
    return max(max(abs(dy), abs(dx)) for dy, dx in offsets)


def row_reach(offsets) -> int:
    return max(abs(dy) for dy, _ in offsets)


def col_reach(offsets) -> int:
    return max(abs(dx) for _, dx in offsets)


def supports(R: int, C: int, offsets) -> bool:
    """Whether the one-pass kernels (K3, K4, and K5 through
    ``bicgstab_supported``) take this geometry: |dy| <= 8 (the halo
    blocks' rows) and any |dx| < C, as the JAX gate; terms with |dx| > 8
    read device memory beside the tile (:func:`route`)."""
    return (R >= 1 and C >= 1 and 1 <= len(offsets) <= MAX_TERMS
            and row_reach(offsets) <= HALO_ROWS and col_reach(offsets) < C)


def step2_supported(R: int, C: int, offsets, values=None) -> bool:
    """Whether the s-step kernels (K1, K2) take this geometry: 1 to
    MAX_TERMS terms, |dy| <= 1 and |dx| < C, as JAX's gate.  A reach-1
    stencil runs the strip march, the flat decomposition of a reach-1 1-D
    stencil the march along the flat index, any other the general route
    (:func:`route`).  Given ``values``, a flat decomposition whose 1-D
    stencil's shifts are not :data:`FLAT_SHIFTS` (the ones compiled) is
    refused (:func:`flat_refusal`).  JAX's gate also asks C % 128 == 0 and
    its VMEM budget: TPU layout gates, which the port does not carry
    over."""
    return (R >= 1 and C >= 1 and 1 <= len(offsets) <= MAX_TERMS
            and row_reach(offsets) <= STEP2_REACH and col_reach(offsets) < C
            and (values is None or flat_refusal(offsets, values, C) is None))


def flat_refusal(offsets, values, C: int):
    """Why K1 and K2 refuse this stencil on the flat route: a message
    when it is the flat decomposition of a 1-D stencil whose shifts are
    not :data:`FLAT_SHIFTS` in that order (``csrc/flat1d.cu`` fixes them
    at compile time), None otherwise."""
    flat = flat_stencil(offsets, values, C)
    if flat is None:
        return None
    shifts = tuple(dx for _, dx in flat[0])
    if shifts == FLAT_SHIFTS:
        return None
    return (f"K1 and K2 on the flat route take the 1-D stencil with shifts "
            f"{FLAT_SHIFTS} in that order (csrc/flat1d.cu LS_FLAT_SHIFTS); "
            f"this one has {shifts}")


_FLAT = {}


def flat_stencil(offsets, values, C: int):
    """The reach-1 1-D stencil ``((0, s), ...)`` with values, s in {-1, 0,
    1} in its own order, whose :func:`decompose_flat_offsets` over ``C``
    columns is exactly (``offsets``, ``values``) and has a term of |dx| >
    1; None otherwise.  Applied with the strip kernels' WRAP flag (a
    column outside [0, C) reads the flat neighbour) it computes the same
    sums: the decomposition's other terms are masked to +0.0."""
    key = (tuple(map(tuple, offsets)), tuple(values), C)
    if key not in _FLAT:
        flat, fvals, k = [], [], 0
        while k < len(offsets):
            (dy, dx), v = offsets[k], float(values[k])
            flat.append(dy * C + dx)
            fvals.append(v)
            # a shift off the row's grid is the pair (q, r), (q + 1, r - C)
            k += 1 if dx == 0 else 2
        found = None
        if (_reach(offsets) > STEP2_REACH and all(abs(f) <= 1 for f in flat)
                and decompose_flat_offsets(flat, fvals, C)
                == (key[0], tuple(map(float, values)))):
            found = (tuple((0, f) for f in flat), tuple(fvals))
        _FLAT[key] = found
    return _FLAT[key]


BICG_PASSES = ("pv", "st", "update")  # K5a, K5b, K5c


def route(offsets, values, C: int, sstep=False,
          bicg: Optional[str] = None):
    """(kernel route, offsets, values, wrap) of a 2-D pass: ``strip`` for a
    reach-1 stencil (the column-strip march), ``flat`` for the flat
    decomposition of a reach-1 1-D stencil (on the 1-D stencil: the strip
    march with WRAP for K3 and K4, the march along the flat index of
    ``csrc/flat1d.cu`` for K1, K2 and K5b); otherwise, for K3, K4 and
    K5a-c, ``band`` where the band march's ring fits (:func:`pass_layout`),
    ``tile`` (the 32 x 32 tile kernels, terms with |dx| > 8 read from
    device memory beside the tile) where it does not; and for the s-step
    passes (``sstep``: True or ``"step2"`` for K1, ``"gram2"`` for K2;
    csrc/sstep_general.cu), ``general`` where the pass's band march takes
    the width and the widest |dx| (K1: :func:`band_stride`, K2:
    :func:`gram2_layout`), ``general_coop`` (the cooperative kernel) where
    it does not.  ``bicg`` names a BiCGStab pass (:data:`BICG_PASSES`):
    ``st`` (K5b) routes as K3 does but on the flat route, which it takes
    only for the 1-D stencil of :data:`FLAT_SHIFTS` (the one
    ``csrc/flat1d.cu`` compiles; another takes the band or tile route on
    the decomposed offsets); ``pv`` (K5a) and ``update`` (K5c), which have
    no strip kernel, take ``tile`` on reach-1 stencils and ``band`` on the
    flat route's (on the decomposed offsets).  On the cross each one's
    band march beat its tile kernel, but phase 4b's f32 BiCGStab end check
    (one draw of a chaotic recurrence) failed with it; on the 1-D view
    both beat the tile kernels and phase 4l held (``PERF.md`` §6)."""
    if bicg is not None and bicg not in BICG_PASSES:
        raise ValueError(f"bicg must be one of {BICG_PASSES}, not {bicg!r}")
    if sstep not in (False, True, "step2", "gram2"):
        raise ValueError(f"sstep must be a bool, 'step2' or 'gram2', not "
                         f"{sstep!r}")
    tile = ("tile", offsets, values, 0)
    if _reach(offsets) <= STEP2_REACH:
        return tile if bicg in ("pv", "update") else ("strip", offsets,
                                                      values, 0)
    if bicg in ("pv", "update"):
        return ("band", offsets, values, 0) if pass_layout(
            C, offsets)[0] else tile
    flat = flat_stencil(offsets, values, C)
    if flat is not None and not (
            bicg == "st" and tuple(dx for _, dx in flat[0]) != FLAT_SHIFTS):
        return ("flat", *flat, 1)
    if not sstep:
        if not pass_layout(C, offsets)[0]:
            return tile
        return "band", offsets, values, 0
    fits = (gram2_layout(C, offsets)[0] if sstep == "gram2"
            else band_stride(C, offsets))
    return ("general" if fits else "general_coop"), offsets, values, 0


def pass_geometry(R: int, C: int):
    """(strips, strip columns, band rows, bands) of a K3 or K4 launch on
    the band route on an [R, C] grid, as ``pass_geometry`` in
    csrc/band2d.cu computes them: strips of at most PASS_COLS columns (a
    multiple of 4 but the last), bands aiming at PASS_TARGET units (strips
    x bands), no shorter than PASS_MIN_ROWS rows.  A function of the shape
    alone, and so is the dot's sum order."""
    strips = -(-C // PASS_COLS)
    w = -(-C // strips)
    w = -(-w // 4) * 4  # strips start on 16-byte boundaries
    strips = -(-C // w)
    per = max(1, PASS_TARGET // strips)
    rows = min(R, max(PASS_MIN_ROWS, -(-R // per)))
    return strips, w, rows, -(-R // rows)


_LAYOUT = {}


def pass_layout(C: int, offsets):
    """(ring row floats, clipped, ring rows, dynamic shared memory bytes)
    of the band route's ring on C columns with this stencil, as
    ``pass_layout`` in csrc/band2d.cu computes them: the ring holds the
    stencil's row span (every dy and 0) plus one row, each the strip's
    window [c0 - Qm, c1 + Qp) (Qm, Qp the widest shift left and right),
    padded with zeros beside the grid where that fits (clipped 0), clipped
    to [0, C) where only that fits (clipped 1; its terms leaving the grid
    masked); the row floats are 0 (the gate: the stencil keeps the tile
    kernels) where neither fits PASS_MAX_STRIDE floats and PASS_SMEM_MAX
    bytes with PASS_SLACK floats after the ring.  Made once per (C,
    offsets): every K3 and K4 call asks for it."""
    key = (C, tuple(map(tuple, offsets)))
    if key not in _LAYOUT:
        _LAYOUT[key] = _pass_layout(C, key[1])
    return _LAYOUT[key]


def _pass_layout(C: int, offsets):
    lo = min(0, min(dy for dy, _ in offsets))
    hi = max(0, max(dy for dy, _ in offsets))
    qm = max(0, max(-dx for _, dx in offsets))
    qp = max(0, max(dx for _, dx in offsets))
    w = pass_geometry(1, C)[1]
    rows = hi - lo + 2
    for mask in (0, 1):
        wid = w + qm + qp + 6
        if mask:
            wid = min(wid, C)
        wid = -(-wid // 4) * 4
        smem = (rows * wid + PASS_SLACK) * 4
        if wid <= PASS_MAX_STRIDE and smem <= PASS_SMEM_MAX:
            return wid, mask, rows, smem
    return 0, 1, rows, 0


def band_geometry(R: int, C: int):
    """(strips, strip columns, band rows, bands) of a K1 band-march launch
    on an [R, C] grid, as ``band_geometry`` in csrc/sstep_general.cu
    computes them: strips of at most BAND_COLS columns, bands aiming at
    BAND_TARGET units (strips x bands), no shorter than BAND_MIN_ROWS
    rows.  A function of the shape alone, and so is the Gram's sum
    order."""
    strips = -(-C // BAND_COLS)
    w = -(-C // strips)
    per = max(1, BAND_TARGET // strips)
    rows = min(R, max(BAND_MIN_ROWS, -(-R // per)))
    return strips, w, rows, -(-R // rows)


def band_stride(C: int, offsets) -> int:
    """Floats of a ring row of K1's band march on C columns with this
    stencil: its widest window, min(w + 8 Q, C + 2 Q) (w the strip width,
    Q the widest |dx|), rounded up to 4; 0 when it is past
    BAND_MAX_STRIDE (the rings would not fit the kernel's shared memory),
    the gate that sends a stencil to the cooperative kernel
    (``band_stride`` in csrc/sstep_general.cu)."""
    Q = col_reach(offsets)
    wid = min(band_geometry(1, C)[1] + 8 * Q, C + 2 * Q)
    wid = -(-wid // 4) * 4
    return wid if wid <= BAND_MAX_STRIDE else 0


def gram2_layout(C: int, offsets):
    """(ring row floats, clipped, dynamic shared memory bytes) of K2's
    band march on C columns with this stencil, as ``gram2_band_stride``
    and ``gram2_band_smem`` in csrc/sstep_general.cu compute them: the
    padded window min(w + 4 Q, C + 2 Q) (clipped 0; w the strip width, Q
    the widest |dx|) where it fits G2_MAX_STRIDE floats, else the window
    clipped to the grid, min(w + 4 Q, C) (clipped 1: terms leaving the
    grid masked), rounded up to 4; (0, 1, 0) past both (the gate that sends
    a stencil to the cooperative kernel: more than 4388 columns with a
    wide |dx|)."""
    Q = col_reach(offsets)
    w = band_geometry(1, C)[1]
    for clipped, edge in ((0, C + 2 * Q), (1, C)):
        wid = -(-min(w + 4 * Q, edge) // 4) * 4
        if wid <= G2_MAX_STRIDE:
            return wid, clipped, (G2_RING_ROWS * wid + BAND_THREADS
                                  + wid) * 4
    return 0, 1, 0


def decompose_flat_offsets(flat_offsets, values, C: int):
    """Rewrite 1-D linearized shifts as (dy, dx) terms over a [R, C] view.

    A flat shift ``s = q*C + r`` (0 <= r < C) reads, for column c, either
    row+q col c+r (when c+r < C) or row+q+1 col c+r-C: two complementary
    column-masked terms."""
    offs, vals = [], []
    for s, v in zip(flat_offsets, values):
        q, r = divmod(int(s), C)
        if r == 0:
            offs.append((q, 0))
            vals.append(float(v))
        else:
            offs.append((q, r))
            vals.append(float(v))
            offs.append((q + 1, r - C))
            vals.append(float(v))
    return tuple(offs), tuple(vals)


# ===========================================================================
# plain PyTorch versions (dense-equivalent shift-and-mask algebra)
# ===========================================================================

def apply_plain(v, offsets, values, halo_top=None, halo_bot=None):
    """A v for the stencil (|dy| <= 8, any |dx| < C): zero columns outside
    the grid, rows outside from the halo blocks (zeros when ``None``).
    Terms are summed in offset order, as the kernels do."""
    R, C = v.shape
    P, Q = HALO_ROWS, col_reach(offsets)
    z = v.new_zeros(P, C)
    ext = torch.cat([z if halo_top is None else halo_top, v,
                     z if halo_bot is None else halo_bot])
    ext = F.pad(ext, (Q, Q))
    acc = None
    for (dy, dx), w in zip(offsets, values):
        term = w * ext[P + dy: P + dy + R, Q + dx: Q + dx + C]
        acc = term if acc is None else acc + term
    return acc


def _dot(a, b):
    return torch.sum(a * b, dtype=torch.float32)


def stencil_plain(mode, x, halo_top, halo_bot, extra=(), *, offsets, values,
                  out=None):
    """The one-pass modes of K3 (see :func:`_stencil_call` for ``extra``).
    Returns ``(y,)``, ``(y, dot)``, ``(dot,)`` or ``(x', r', rr)``; the
    update mode writes x' and r' into the given x and r, the y modes y
    into ``out`` where given."""
    y = apply_plain(x, offsets, values, halo_top, halo_bot)
    if out is not None:
        y = out.copy_(y)
    return mode_outputs(mode, x, y, extra)


def mode_outputs(mode, x, y, extra=()):
    """What a one-pass mode returns, given its operand x and y = A x (the
    2-D and 3-D plain versions share it)."""
    if mode == "y":
        return (y,)
    if mode == "y_dot":
        return y, _dot(x, y)
    if mode == "pq":
        return (_dot(x, y),)
    xv, rv, alpha = extra
    a = torch.as_tensor(alpha, dtype=torch.float32).to(x.dtype)
    xv.add_(a * x)
    rv.sub_(a * y)
    return xv, rv, _dot(rv, rv)


def xpay_pq_plain(r, p_old, beta, r_top=None, r_bot=None, p_top=None,
                  p_bot=None, *, offsets, values, out=None):
    """K4: p = r + beta p_old and <p, A p>, the halo of p being
    r_halo + beta p_old_halo."""
    b = torch.as_tensor(beta, dtype=torch.float32).to(r.dtype)

    def comb(rh, ph):
        if rh is None and ph is None:
            return None
        rh = r.new_zeros(HALO_ROWS, r.shape[1]) if rh is None else rh
        ph = r.new_zeros(HALO_ROWS, r.shape[1]) if ph is None else ph
        return rh + b * ph

    p = r + b * p_old
    Ap = apply_plain(p, offsets, values, comb(r_top, p_top),
                     comb(r_bot, p_bot))
    if out is not None:
        p = out.copy_(p)
    return p, _dot(p, Ap)


def gram2_plain(r, p, *, offsets, values):
    """K2: the Gram vector (ordered :data:`GRAM_NAMES`) of (r, p)."""
    A = lambda v: apply_plain(v, offsets, values)
    Ap = A(p)
    A2p = A(Ap)
    Ar = A(r)
    return torch.stack([
        _dot(r, r), _dot(p, Ap), _dot(r, Ap), _dot(Ap, Ap), _dot(r, Ar),
        _dot(Ap, Ar), _dot(Ap, A2p), _dot(Ar, Ar), _dot(Ar, A2p),
        _dot(A2p, A2p),
    ])


def step2_plain(x, r, p, coef, *, offsets, values, out=None):
    """K1: two CG iterations from the coefficients of :func:`cg2_coeffs`.
    u = c0 p + c1 r - c2 Ap; x'' = x + u (in place); r'' = r - A u;
    p'' = r'' + c3 r - c4 Ap + c5 p; plus the Gram vector of (r'', p'')."""
    A = lambda v: apply_plain(v, offsets, values)
    c0, c1, c2, c3, c4, c5 = coef.to(x.dtype).unbind()
    Ap = A(p)
    u = c0 * p + c1 * r - c2 * Ap
    rn = r - A(u)
    pn = rn + c3 * r - c4 * Ap + c5 * p
    x.add_(u)
    if out is not None:
        rn, pn = out[0].copy_(rn), out[1].copy_(pn)
    return x, rn, pn, gram2_plain(rn, pn, offsets=offsets, values=values)


def nop_plain(x, r, p, coef, *, offsets, values, out=None):
    """K1 in mode nop: x'' = x + r (in place), r'' = r, p'' = p, and
    g[0] = <r, p>, g[1..9] = 0.  ``coef``, ``offsets`` and ``values`` are
    step2's operands, unused."""
    x.add_(r)
    rn, pn = r.clone(), p.clone()
    if out is not None:
        rn, pn = out[0].copy_(r), out[1].copy_(p)
    g = torch.zeros(10, dtype=torch.float32, device=x.device)
    g[0] = _dot(r, p)
    return x, rn, pn, g


def cg2_coeffs(g: torch.Tensor):
    """(update coefficients [6], rr after iter 1, rr after iter 2) from the
    Gram vector ``g`` ordered as :data:`GRAM_NAMES`.  Scalar arithmetic on
    0-dim tensors of ``g``'s device: nothing is read back to the host.

    Algebra (A symmetric):
      a0 = rr/<p,Ap>;  r1 = r - a0 Ap;  rr1 = rr - 2 a0 <r,Ap> + a0^2 <Ap,Ap>
      b1 = rr1/rr;     p1 = r1 + b1 p;  a1 = rr1/<p1,Ap1>
      x'' = x + (a0 + a1 b1) p + a1 r - a0 a1 Ap
      p'' = r'' + b2 r - b2 a0 Ap + b2 b1 p          (b2 = rr2/rr1)"""
    rr, pAp, rAp, ApAp, rAr, ApAr, ApA2p, ArAr, ArA2p, A2pA2p = g.unbind()
    a0 = rr / pAp
    rr1 = rr - 2.0 * a0 * rAp + a0 * a0 * ApAp
    b1 = rr1 / rr
    r1Ar1 = rAr - 2.0 * a0 * ApAr + a0 * a0 * ApA2p
    r1Ap = rAp - a0 * ApAp
    p1Ap1 = r1Ar1 + 2.0 * b1 * r1Ap + b1 * b1 * pAp
    a1 = rr1 / p1Ap1
    r1Ap1 = r1Ar1 + b1 * r1Ap
    Ar1Ap = ApAr - a0 * ApA2p
    Ar1Ar1 = ArAr - 2.0 * a0 * ArA2p + a0 * a0 * A2pA2p
    Ap1Ap1 = Ar1Ar1 + 2.0 * b1 * Ar1Ap + b1 * b1 * ApAp
    rr2 = rr1 - 2.0 * a1 * r1Ap1 + a1 * a1 * Ap1Ap1
    b2 = rr2 / rr1
    coef = torch.stack(
        [a0 + a1 * b1, a1, a0 * a1, b2, b2 * a0, b2 * b1]
    ).to(torch.float32)
    return coef, rr1, rr2


# ===========================================================================
# CUDA launch plumbing
# ===========================================================================

class _Stencil(ctypes.Structure):
    """Mirror of ``LsStencil`` in csrc/stencil2d.cu."""
    _fields_ = [
        ("n", ctypes.c_int),
        ("dy", ctypes.c_int * MAX_TERMS),
        ("dx", ctypes.c_int * MAX_TERMS),
        ("v", ctypes.c_float * MAX_TERMS),
    ]


_STRUCTS = {}


def _stencil_struct(offsets, values) -> _Stencil:
    """The kernels' stencil argument, made once per (offsets, values)."""
    key = (tuple(map(tuple, offsets)), tuple(values))
    st = _STRUCTS.get(key)
    if st is None:
        st = _Stencil()
        st.n = len(offsets)
        for k, ((dy, dx), v) in enumerate(zip(offsets, values)):
            st.dy[k], st.dx[k], st.v[k] = int(dy), int(dx), float(v)
        _STRUCTS[key] = st
    return st


_MODES = {"y": 0, "y_dot": 1, "pq": 2, "update": 3}


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise or
    when the given tensors are not all on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_grid(name, t, shape=None, ndim=2):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(
            f"{name}: expected a {ndim}-D grid, got {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_halo(name, h, C):
    if h is not None:
        _check_grid(name, h, (HALO_ROWS, C))


def _check_distinct(*named):
    """Outputs that a kernel writes while other blocks read must not share
    storage with the inputs they race."""
    ptrs = {}
    for name, t in named:
        p = t.untyped_storage().data_ptr()
        if p in ptrs:
            raise ValueError(f"{name} shares storage with {ptrs[p]}")
        ptrs[p] = name


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dev_scalars(a, n: int, device) -> torch.Tensor:
    """``n`` f32 scalars as a contiguous device tensor (no host sync for a
    tensor already on the device)."""
    if (isinstance(a, torch.Tensor) and a.dtype == torch.float32
            and a.device == device and a.is_contiguous() and a.numel() == n):
        return a.reshape(-1)
    t = torch.as_tensor(a).to(device=device, dtype=torch.float32)
    t = t.reshape(-1).contiguous()
    if t.numel() != n:
        raise ValueError(f"expected {n} coefficient(s), got {t.numel()}")
    return t


_TABLES = {}


def _int32_table(values: tuple, device) -> torch.Tensor:
    """``values`` as an int32 device array, made once per (values, device):
    the small index tables a kernel reads (K8's offsets, K10's w0)."""
    key = (values, device)
    t = _TABLES.get(key)
    if t is None:
        t = torch.tensor(values, dtype=torch.int32, device=device)
        _TABLES[key] = t
    return t


def _blocks(R, C) -> int:
    return -(-R // TILE) * -(-C // TILE)


def strip_geometry(R: int, C: int, target_warps: int):
    """(strips, rows per chunk, warps, blocks) of a strip launch on an [R, C]
    grid whose row chunks aim at ``target_warps`` warps, as
    ``strip_geometry`` in csrc/march2d.cuh computes them: 120-column
    strips, and no more row chunks than chunks of STEP2_MIN_ROWS rows
    would need.  A function of the shape alone."""
    strips = -(-C // STEP2_COLS)
    chunks = max(1, min(target_warps // strips, -(-R // STEP2_MIN_ROWS)))
    chunk_rows = -(-R // chunks)
    units = strips * -(-R // chunk_rows)
    return strips, chunk_rows, units, -(-units // STEP2_WARPS)


def flat_geometry(R: int, C: int, target_warps: int):
    """(segments, segments per run, runs, blocks) of a flat-route launch
    (K1 or K2, ``csrc/flat1d.cu``) on an [R, C] view whose runs aim at
    ``target_warps`` warps, as ``flat_geometry`` there computes them: the
    n = R C elements in segments of FLAT_SEG, one warp per run of at least
    FLAT_MIN_SEGS segments (the last run may be shorter), STEP2_WARPS
    warps a block.  A function of the shape alone, and so is the Gram's
    sum order."""
    segs = -(-R * C // FLAT_SEG)
    run = max(FLAT_MIN_SEGS, -(-segs // target_warps))
    runs = -(-segs // run)
    return segs, run, runs, -(-runs // STEP2_WARPS)


def strip_capacity(R: int, C: int) -> int:
    """Blocks of the largest strip launch on an [R, C] grid, whatever its
    target: one warp per strip and row chunk of STEP2_MIN_ROWS rows."""
    units = -(-C // STEP2_COLS) * -(-R // STEP2_MIN_ROWS)
    return -(-units // STEP2_WARPS)


_STEP2_SCRATCH = {}


def _step2_scratch(device, R: int, C: int):
    """(partials, capacity, counter) of the strip passes' launches on an
    [R, C] grid (K1, K2, K3, K4 and K5b, whatever their targets; also K1's
    and K2's flat-route launches, whose runs of at least FLAT_MIN_SEGS
    segments, 2048 elements, are fewer than the strip units of 1920):
    STEP2_GRAM float64 partial sums for each of :func:`strip_capacity`
    blocks (K1 and K2 keep ten per block, K5b two, K3 and K4 one) and the
    last-block counter (zero between launches), made once per (device,
    stream, R, C): launches on one stream are ordered, so they can share
    them."""
    key = (device, _raw_stream(device), R, C)
    scratch = _STEP2_SCRATCH.get(key)
    if scratch is None:
        capacity = strip_capacity(R, C)
        scratch = (torch.empty(STEP2_GRAM * capacity, dtype=torch.float64,
                               device=device), capacity,
                   torch.zeros(1, dtype=torch.int32, device=device))
        _STEP2_SCRATCH[key] = scratch
    return scratch


def general_units(R: int, C: int) -> int:
    """Units of a general-route launch on an [R, C] grid, as
    ``gen_geometry`` in csrc/sstep_general.cu computes them: runs of whole
    rows of GEN_UNIT_ELEMS elements (at least one row).  A function of the
    shape alone, and so is the Gram's sum order."""
    rows = min(R, max(1, GEN_UNIT_ELEMS // C))
    return -(-R // rows)


_BAND_SCRATCH = {}


def _band_scratch(device, R: int, C: int):
    """(partials, units, counter) of K1's and K2's band-march launches on
    an [R, C] grid: ten float64 partial sums per unit (strips x bands) and
    the
    last-block counter (zero between launches), made once per (device,
    stream, R, C): launches on one stream are ordered, so they can share
    them."""
    key = (device, _raw_stream(device), R, C)
    scratch = _BAND_SCRATCH.get(key)
    if scratch is None:
        strips, _, _, bands = band_geometry(R, C)
        units = strips * bands
        scratch = (torch.empty(STEP2_GRAM * units, dtype=torch.float64,
                               device=device), units,
                   torch.zeros(1, dtype=torch.int32, device=device))
        _BAND_SCRATCH[key] = scratch
    return scratch


_GEN_SCRATCH = {}


def _general_scratch(device, R: int, C: int):
    """(workspace, partials, units, sync) of the cooperative K1 and K2
    launches on an [R, C] grid: two [R, C] f32 planes (K1's u, and its A p
    then A p''; K2's A p), ten float64 partial sums per unit, and three
    counters (the grid barrier's arrivals and generation, the last-block
    counter; zero before the first launch, ready for the next after each),
    made once per (device, stream, R, C): launches on one stream are
    ordered, so they can share them."""
    key = (device, _raw_stream(device), R, C)
    scratch = _GEN_SCRATCH.get(key)
    if scratch is None:
        units = general_units(R, C)
        scratch = (torch.empty(2 * R * C, dtype=torch.float32, device=device),
                   torch.empty(STEP2_GRAM * units, dtype=torch.float64,
                               device=device), units,
                   torch.zeros(3, dtype=torch.int32, device=device))
        _GEN_SCRATCH[key] = scratch
    return scratch


_PASS_SCRATCH = {}


def _pass_scratch(device, R: int, C: int):
    """(partials, units, counter) of the band-route launches (K3, K4,
    K5a-c) on an [R, C] grid: PASS_DOTS float64 partial dots per unit
    (strips x bands of :func:`pass_geometry`; K3, K4 and K5a use one, K5b
    and K5c two) and the last-block counter (zero between launches), made
    once per
    (device, stream, R, C): launches on one stream are ordered, so they
    can share them."""
    key = (device, _raw_stream(device), R, C)
    scratch = _PASS_SCRATCH.get(key)
    if scratch is None:
        strips, _, _, bands = pass_geometry(R, C)
        units = strips * bands
        scratch = (torch.empty(PASS_DOTS * units, dtype=torch.float64,
                               device=device),
                   units, torch.zeros(1, dtype=torch.int32, device=device))
        _PASS_SCRATCH[key] = scratch
    return scratch


def _one_pass_scratch(device, R: int, C: int, kind: str):
    """(partials, capacity, counter) of a K3 or K4 launch on the route
    ``kind`` (:func:`route`): the strip scratch for the strip march; the
    band route's (:func:`_pass_scratch`); one float per tile, for the
    second launch that sums the tile kernel's dot, otherwise."""
    if kind == "band":
        return _pass_scratch(device, R, C)
    if kind != "tile":
        return _step2_scratch(device, R, C)
    return (torch.empty(_blocks(R, C), dtype=torch.float32, device=device),
            0, None)


def _raw_stream(device) -> int:
    """The handle of ``device``'s current stream (no Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(name: str, fn: str, args, device) -> None:
    from .build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args, _raw_stream(device))
    if err:
        raise RuntimeError(
            f"{fn}: CUDA error {err} "
            f"({lib.ls_error_string(err).decode()})"
        )
    LAUNCHES[name] += 1


# ===========================================================================
# K3: one-pass stencil modes
# ===========================================================================

def _stencil_call(x, halo_top, halo_bot, extra=(), *, offsets, values,
                  mode: str = "y", out=None):
    """Shared driver of the K3 modes.  ``extra`` is () except for mode
    ``update``, where it is (xv, rv, alpha) and x is the search direction p.
    ``out``: where the y modes write y (a fresh buffer when ``None``; it may
    not share storage with x)."""
    R, C = x.shape
    if not supports(R, C, offsets):
        raise ValueError(f"unsupported stencil geometry R={R} C={C}")
    _check_grid("x", x)
    _check_halo("halo_top", halo_top, C)
    _check_halo("halo_bot", halo_bot, C)
    tensors = [x, halo_top, halo_bot]
    if out is not None:
        if mode not in ("y", "y_dot"):
            raise ValueError(f"mode {mode!r} writes no y")
        _check_grid("out", out, (R, C))
        _check_distinct(("x", x), ("out", out))
        tensors.append(out)
    if mode == "update":
        xv, rv, _ = extra
        _check_grid("xv", xv, (R, C))
        _check_grid("rv", rv, (R, C))
        _check_distinct(("p", x), ("x", xv), ("r", rv))
        tensors += [xv, rv]
    if not _on_cuda(*tensors):
        return stencil_plain(mode, x, halo_top, halo_bot, extra,
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
    kind, k_offs, k_vals, wrap = route(offsets, values, C)
    partials, capacity, counter = _one_pass_scratch(dev, R, C, kind)
    st = _stencil_struct(k_offs, k_vals)
    args = (_MODES[mode], _ptr(x), _ptr(halo_top), _ptr(halo_bot), _ptr(y),
            _ptr(xv), _ptr(rv), _ptr(alpha), _ptr(dot), _ptr(partials),
            capacity, _ptr(counter), R, C, ctypes.byref(st))
    if kind == "band":
        _launch(mode, "ls_stencil2d_band", args, dev)
    else:
        _launch(mode, "ls_stencil2d", (*args, wrap), dev)
    if mode == "y":
        return (y,)
    if mode == "y_dot":
        return y, dot[0]
    if mode == "pq":
        return (dot[0],)
    return xv, rv, dot[0]


def grid2d_stencil_matvec(x, halo_top=None, halo_bot=None, *, offsets,
                          values, with_dot: bool = False, out=None):
    """y = A @ x (and optionally <x, y>) for the stencil {(dy, dx): v}, y
    written to ``out`` (a fresh buffer when ``None``)."""
    res = _stencil_call(x, halo_top, halo_bot, offsets=offsets,
                        values=values, mode="y_dot" if with_dot else "y",
                        out=out)
    return res if with_dot else res[0]


def grid2d_cg_pq(p, halo_top=None, halo_bot=None, *, offsets, values):
    """<p, A p> without storing A p (two-pass CG prologue)."""
    return _stencil_call(p, halo_top, halo_bot, offsets=offsets,
                         values=values, mode="pq")[0]


def grid2d_cg_update(p, x, r, alpha, halo_top=None, halo_bot=None, *,
                     offsets, values):
    """(x + alpha p, r - alpha A p, <r', r'>) with A p formed on chip only.
    x and r are updated in place."""
    return _stencil_call(p, halo_top, halo_bot, (x, r, alpha),
                         offsets=offsets, values=values, mode="update")


# ===========================================================================
# K4: xpay + pq
# ===========================================================================

def grid2d_cg_xpay_pq(r, p_old, beta, r_top=None, r_bot=None, p_top=None,
                      p_bot=None, *, offsets, values, out=None):
    """(p, <p, A p>) where p = r + beta p_old, written to ``out`` (a fresh
    buffer when ``None``; it may not share storage with r or p_old)."""
    R, C = r.shape
    if not supports(R, C, offsets):
        raise ValueError(f"unsupported stencil geometry R={R} C={C}")
    _check_grid("r", r)
    _check_grid("p_old", p_old, (R, C))
    for name, h in (("r_top", r_top), ("r_bot", r_bot),
                    ("p_top", p_top), ("p_bot", p_bot)):
        _check_halo(name, h, C)
    if out is not None:
        _check_grid("out", out, (R, C))
        _check_distinct(("r", r), ("p_old", p_old), ("out", out))
    if not _on_cuda(r, p_old, r_top, r_bot, p_top, p_bot, out):
        return xpay_pq_plain(r, p_old, beta, r_top, r_bot, p_top, p_bot,
                             offsets=offsets, values=values, out=out)
    dev = r.device
    p = torch.empty_like(r) if out is None else out
    b = _dev_scalars(beta, 1, dev)
    dot = torch.empty(1, dtype=torch.float32, device=dev)
    kind, k_offs, k_vals, wrap = route(offsets, values, C)
    partials, capacity, counter = _one_pass_scratch(dev, R, C, kind)
    st = _stencil_struct(k_offs, k_vals)
    args = (_ptr(r), _ptr(p_old), _ptr(b), _ptr(r_top), _ptr(r_bot),
            _ptr(p_top), _ptr(p_bot), _ptr(p), _ptr(dot), _ptr(partials),
            capacity, _ptr(counter), R, C, ctypes.byref(st))
    if kind == "band":
        _launch("xpay_pq", "ls_xpay_pq_band", args, dev)
    else:
        _launch("xpay_pq", "ls_xpay_pq", (*args, wrap), dev)
    return p, dot[0]


# ===========================================================================
# K2 / K1: s-step passes
# ===========================================================================

def _check_sstep(R, C, offsets, values):
    if not step2_supported(R, C, offsets):
        raise ValueError("s-step kernels require 1 to MAX_TERMS terms with "
                         f"|dy| <= 1 and |dx| < C = {C}")
    why = flat_refusal(offsets, values, C)
    if why is not None:
        raise ValueError(why)


def grid2d_cg_gram2(r, p, *, offsets, values):
    """Gram vector (ordered :data:`GRAM_NAMES`) of (r, p): the s-step
    bootstrap and drift-refresh pass."""
    R, C = r.shape
    _check_sstep(R, C, offsets, values)
    _check_grid("r", r)
    _check_grid("p", p, (R, C))
    if not _on_cuda(r, p):
        return gram2_plain(r, p, offsets=offsets, values=values)
    dev = r.device
    # g is fresh per pass, as step2's
    g = torch.empty(10, dtype=torch.float32, device=dev)
    kind, k_offs, k_vals, _ = route(offsets, values, C, sstep="gram2")
    st = ctypes.byref(_stencil_struct(k_offs, k_vals))
    if kind == "general":
        partials, units, counter = _band_scratch(dev, R, C)
        _launch("gram2", "ls_gram2_band", (
            _ptr(r), _ptr(p), _ptr(g), _ptr(partials), units, _ptr(counter),
            R, C, st,
        ), dev)
        return g
    if kind == "general_coop":
        ws, partials, units, sync = _general_scratch(dev, R, C)
        _launch("gram2", "ls_gram2_general", (
            _ptr(r), _ptr(p), _ptr(g), _ptr(ws), _ptr(partials), units,
            _ptr(sync), R, C, st,
        ), dev)
        return g
    partials, capacity, counter = _step2_scratch(dev, R, C)
    _launch("gram2", "ls_flat_gram2" if kind == "flat" else "ls_gram2", (
        _ptr(r), _ptr(p), _ptr(g), _ptr(partials), capacity, _ptr(counter),
        R, C, st,
    ), dev)
    return g


def grid2d_cg_step2(x, r, p, coef, *, offsets, values,
                    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """TWO fused CG iterations in one pass: returns (x'', r'', p'',
    gram(r'', p'')) given the coefficient vector of :func:`cg2_coeffs`.
    x is updated in place; r'' and p'' go to ``out`` (fresh buffers when
    ``None``), which may not share storage with x, r or p."""
    R, C = r.shape
    _check_sstep(R, C, offsets, values)
    _check_grid("x", x, (R, C))
    _check_grid("r", r)
    _check_grid("p", p, (R, C))
    if out is None:
        out = (torch.empty_like(r), torch.empty_like(p))
    _check_grid("r_out", out[0], (R, C))
    _check_grid("p_out", out[1], (R, C))
    _check_distinct(("x", x), ("r", r), ("p", p), ("r_out", out[0]),
                    ("p_out", out[1]))
    if not _on_cuda(x, r, p, out[0], out[1]):
        return step2_plain(x, r, p, coef, offsets=offsets, values=values,
                           out=out)
    dev = r.device
    c = _dev_scalars(coef, 6, dev)
    # g is fresh per pass: callers keep earlier passes' g (the runner's
    # history holds g[0])
    g = torch.empty(10, dtype=torch.float32, device=dev)
    kind, k_offs, k_vals, _ = route(offsets, values, C, sstep=True)
    st = ctypes.byref(_stencil_struct(k_offs, k_vals))
    if kind == "general":
        partials, units, counter = _band_scratch(dev, R, C)
        _launch("step2", "ls_step2_band", (
            _ptr(x), _ptr(r), _ptr(p), _ptr(c), _ptr(out[0]), _ptr(out[1]),
            _ptr(g), _ptr(partials), units, _ptr(counter), R, C, st,
        ), dev)
        return x, out[0], out[1], g
    if kind == "general_coop":
        ws, partials, units, sync = _general_scratch(dev, R, C)
        _launch("step2", "ls_step2_general", (
            _ptr(x), _ptr(r), _ptr(p), _ptr(c), _ptr(out[0]), _ptr(out[1]),
            _ptr(g), _ptr(ws), _ptr(partials), units, _ptr(sync), R, C, st,
        ), dev)
        return x, out[0], out[1], g
    partials, capacity, counter = _step2_scratch(dev, R, C)
    _launch("step2", "ls_flat_step2" if kind == "flat" else "ls_step2", (
        _ptr(x), _ptr(r), _ptr(p), _ptr(c), _ptr(out[0]), _ptr(out[1]),
        _ptr(g), _ptr(partials), capacity, _ptr(counter), R, C, st,
    ), dev)
    return x, out[0], out[1], g


def _grid2d_cg_nop(x, r, p, coef, *, offsets, values,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """K1 in the JAX kernel's diagnostic mode ``nop``: step2's operands,
    buffers, loads and stores with a trivial body (:func:`nop_plain`).  No
    solve calls it; its time is K1's memory floor with step2's access
    pattern.  Takes the reach-1 stencils of K1's strip route (not the
    flat decompositions or the general route's stencils)."""
    R, C = r.shape
    if not (step2_supported(R, C, offsets)
            and _reach(offsets) <= STEP2_REACH):
        raise ValueError("K1 nop requires a reach-1 stencil")
    _check_grid("x", x, (R, C))
    _check_grid("r", r)
    _check_grid("p", p, (R, C))
    if out is None:
        out = (torch.empty_like(r), torch.empty_like(p))
    _check_grid("r_out", out[0], (R, C))
    _check_grid("p_out", out[1], (R, C))
    _check_distinct(("x", x), ("r", r), ("p", p), ("r_out", out[0]),
                    ("p_out", out[1]))
    if not _on_cuda(x, r, p, out[0], out[1]):
        return nop_plain(x, r, p, coef, offsets=offsets, values=values,
                         out=out)
    dev = r.device
    c = _dev_scalars(coef, 6, dev)
    g = torch.empty(10, dtype=torch.float32, device=dev)
    partials, capacity, counter = _step2_scratch(dev, R, C)
    _launch("nop", "ls_step2_nop", (
        _ptr(x), _ptr(r), _ptr(p), _ptr(c), _ptr(out[0]), _ptr(out[1]),
        _ptr(g), _ptr(partials), capacity, _ptr(counter), R, C,
        ctypes.byref(_stencil_struct(offsets, values)),
    ), dev)
    return x, out[0], out[1], g
