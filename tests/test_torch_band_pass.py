"""K3 (its four modes), K4, K5a, K5b and K5c on the band route, against
the JAX package.

The band route (``csrc/band2d.cu``) runs K3, K4, K5a (bicg_pv), K5b
(bicg_st) and K5c (bicg_update) for every 2-D stencil of the one-pass gate
that is neither reach 1 (the strip march) nor the flat decomposition of a
reach-1 1-D stencil (the flat route), where its shared-memory ring fits
(``stencil2d.pass_layout``).  No card is needed here:

* the route of S2_gen, S2_4x, phase 4l's ``wide_kw`` and the 1-D view of a
  5-point 1-D stencil (row-wrap terms with |dx| = C - 1, C - 2): ``band``
  for K3, K4 and K5a-c, the strip and flat routes unchanged (K5a and
  K5c keep the tile kernels with reach-1 stencils and take the band
  march on the flat route's);
* the Python mirrors of the launch geometry and of the ring's layout (the
  gate) against a line-for-line transcription of the C formulas and the
  defines read from the source (the library itself is held to the mirror
  when it loads, ``build.load_library``, and by the card tests);
* a geometry that covers the grid once and depends on the shape alone,
  and scratch sized for its units;
* a numpy transcription of the band march (each unit's ring of rows, its
  slots, padded or clipped windows and masks) against the plain version,
  with null and random halo blocks, and in K5a's and K5b's modes (the
  operand formed as its row arrives, zero outside the grid; the dots of
  exact or f32-rounded products summed in float64) against
  ``bicg_pv_plain`` and ``bicg_st_plain``, and in K5c's (x' formed in
  place as (x + alpha p) + omega s) against ``bicg_update_plain``;
* the plain K3 modes and K4, which the wrappers run on CPU tensors,
  against JAX's ``_stencil_call`` and ``grid2d_cg_xpay_pq`` in interpret
  mode on these stencils: elementwise atol 1e-4 * max|ref|, dots rtol
  1e-4 (``test_torch_flat1d.py``'s bounds).

The kernels are held to the plain versions on the card in
``test_torch_kernels_cuda.py`` and ``chip_smoke.py`` (phases 3, 4l, 4n).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legionsolvers_tpu.ops.pallas import stencil2d as JS
from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
from legionsolvers_tpu_torch.ops.cuda import stencil2d as T

torch.set_num_threads(2)

CSRC = pathlib.Path(T.__file__).resolve().parents[2] / "csrc" / "band2d.cu"
CROSS = (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (4.0,) + (-1.0,) * 4)


def s2_gen(C):
    """Phase 4n's S2_gen: the cross, (0, +-2), (0, +-37), (+-1, +-100)."""
    return (CROSS[0] + ((0, 2), (0, -2), (0, 37), (0, -37), (1, 100),
                        (-1, -100), (1, -100), (-1, 100)),
            (7.0,) + (-1.0,) * 4 + (-0.5,) * 4 + (-0.25,) * 4)


def s2_4x(C):
    """Phase 4n's S2_4x: -d_xx to fourth order, -d_yy to second."""
    return (CROSS[0] + ((0, -2), (0, 2)),
            (4.5, -1.0, -1.0, -16 / 12, -16 / 12, 1 / 12, 1 / 12))


def wide_kw(C):
    """Phase 4l's wide stencil: the cross, (0, +-37), (1, -(C - 1)) and a
    term 8 rows up, (-8, 100)."""
    return (CROSS[0] + ((0, 37), (0, -37), (1, -(C - 1)), (-8, 100)),
            CROSS[1] + (-0.25, -0.25, -0.5, -0.125))


def flat5(C):
    """The 1-D view of the 5-point 1-D stencil (shifts 0, -+1, -+2): its
    row-wrap terms have |dx| = C - 1 and C - 2."""
    return T.decompose_flat_offsets((0, -1, 1, -2, 2),
                                    (2.5, -1.0, -1.0, 0.25, 0.25), C)


STENCILS = {"S2_gen": s2_gen, "S2_4x": s2_4x, "wide_kw": wide_kw,
            "flat5": flat5}


def _define(name):
    return int(re.search(rf"#define {name} \(?(\d+)", CSRC.read_text())
               .group(1))


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [128, 256, 1000, 4096])
@pytest.mark.parametrize("stencil", list(STENCILS))
def test_route_sends_k3_k4_to_band_and_k5_to_tile(stencil, C):
    """K3, K4 and K5a-c take the band route with the stencils off the
    strip and flat routes whose ring fits (no K5 pass takes the tile
    kernels there any more); the s-step passes' route is unchanged; the
    gate of every pass takes the stencil."""
    offs, vals = STENCILS[stencil](C)
    assert T.supports(64, C, offs)
    assert T.pass_layout(C, offs)[0] > 0
    assert T.route(offs, vals, C) == ("band", offs, vals, 0)
    for k5 in T.BICG_PASSES:
        assert T.route(offs, vals, C, bicg=k5) == ("band", offs, vals, 0)
    assert TB.bicgstab_supported(64, C, offs)
    if T.step2_supported(64, C, offs):
        assert T.route(offs, vals, C, sstep=True)[0] in ("general",
                                                         "general_coop")


@pytest.mark.parametrize("C", [4, 128, 1000, 4096])
def test_strip_and_flat_routes_unchanged(C):
    """A reach-1 stencil keeps the strip march and the flat decomposition
    of the 1-D Laplacian the flat route, for K3, K4 and K5b alike; K5a
    and K5c run the tile kernels on the former and the band march on the
    latter; a pass name outside BICG_PASSES is refused."""
    nine = (tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)),
            (8.0,) + (-1.0,) * 8)
    for offs, vals in (CROSS, nine):
        for bicg in (None, "st"):
            assert T.route(offs, vals, C, bicg=bicg)[0] == "strip"
        for bicg in ("pv", "update"):
            assert T.route(offs, vals, C, bicg=bicg) == ("tile", offs, vals,
                                                         0)
    offs, vals = T.decompose_flat_offsets((0, -1, 1), (2.0, -1.0, -1.0), C)
    for bicg in (None, "st"):
        assert T.route(offs, vals, C, bicg=bicg)[0] == "flat"
    for bicg in ("pv", "update"):
        assert T.route(offs, vals, C, bicg=bicg) == ("band", offs, vals, 0)
    with pytest.raises(ValueError):
        T.route(offs, vals, C, bicg=True)


def test_stencils_past_the_gate_keep_the_tile_kernels():
    """A row span of 17 at 4096 columns (18 ring rows of 16 KB) and a
    clipped window wider than PASS_MAX_STRIDE floats are past the gate:
    K3, K4 and K5a-c keep the tile kernels there."""
    deep = (CROSS[0] + ((-8, 100), (8, -4095)), CROSS[1] + (-0.25, -0.25))
    assert T.pass_layout(4096, deep[0])[0] == 0
    assert T.route(*deep, 4096)[0] == "tile"
    for k5 in ("pv", "st", "update"):
        assert T.route(*deep, 4096, bicg=k5)[0] == "tile"
    assert T.pass_layout(1000, deep[0])[0] > 0  # 18 rows of 2108 floats
    assert T.route(*deep, 1000)[0] == "band"
    wrap = (((0, 0), (0, -6999)), (1.0, 1.0))
    assert T.pass_layout(7000, wrap[0])[0] == 0
    assert T.route(*wrap, 7000)[0] == "tile"
    assert T.route(*wrap, 7000, bicg="update")[0] == "tile"


# ---------------------------------------------------------------------------
# the geometry and the gate against csrc/band2d.cu
# ---------------------------------------------------------------------------

def _csrc_geometry(R, C):
    """``pass_geometry`` of csrc/band2d.cu, transcribed line for line."""
    cols, target = _define("LS_PASS_COLS"), _define("LS_PASS_TARGET")
    min_rows = _define("LS_PASS_MIN_ROWS")
    strips = (C + cols - 1) // cols
    w = (C + strips - 1) // strips
    w = (w + 3) // 4 * 4
    strips = (C + w - 1) // w
    per = target // strips
    if per < 1:
        per = 1
    rows = (R + per - 1) // per
    if rows < min_rows:
        rows = min_rows
    if rows > R:
        rows = R
    return strips, w, rows, (R + rows - 1) // rows


def _csrc_layout(C, offs):
    """``pass_layout`` of csrc/band2d.cu, transcribed line for line."""
    lo = hi = qm = qp = 0
    for dy, dx in offs:
        lo, hi = min(lo, dy), max(hi, dy)
        qm, qp = max(qm, -dx), max(qp, dx)
    w = _csrc_geometry(1, C)[1]
    rows = hi - lo + 2
    slack = 4 * _define("LS_PASS_THREADS")
    smem_max = 225 * 1024
    for mask in (0, 1):
        wid = w + qm + qp + 6
        if mask and wid > C:
            wid = C
        wid = (wid + 3) // 4 * 4
        smem = (rows * wid + slack) * 4
        if wid <= _define("LS_PASS_MAX_STRIDE") and smem <= smem_max:
            return wid, mask, rows, smem
    return 0, 1, rows, 0


SHAPES = [(4096, 4096), (1024, 4096), (8, 128), (37, 1000), (3, 1000),
          (203, 4096), (2, 4096), (1, 101), (33, 4097), (20, 5000),
          (40, 130), (4099, 130), (5, 8192), (100000, 16)]


def test_pass_constants_mirror_csrc():
    """The mirror's constants are csrc/band2d.cu's defines."""
    text = CSRC.read_text()
    assert (T.PASS_THREADS, T.PASS_COLS, T.PASS_MIN_ROWS, T.PASS_TARGET,
            T.PASS_MAX_STRIDE) == tuple(_define(f"LS_PASS_{k}") for k in (
                "THREADS", "COLS", "MIN_ROWS", "TARGET", "MAX_STRIDE"))
    assert "#define LS_PASS_SLACK (4 * LS_PASS_THREADS)" in text
    assert T.PASS_SLACK == 4 * T.PASS_THREADS
    assert "#define LS_PASS_SMEM_MAX (225 * 1024)" in text
    assert T.PASS_SMEM_MAX == 225 * 1024
    assert T.PASS_DOTS == _define("LS_PASS_DOTS") == 2
    # a thread's output columns and 16-byte loads per row
    assert T.PASS_COLS % T.PASS_THREADS == 0
    assert T.PASS_MAX_STRIDE % (4 * T.PASS_THREADS) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_pass_geometry_mirrors_csrc(shape):
    assert T.pass_geometry(*shape) == _csrc_geometry(*shape)


@pytest.mark.parametrize("C", [128, 130, 1000, 4096, 4097, 5000, 8192])
@pytest.mark.parametrize("stencil", list(STENCILS) + ["deep"])
def test_pass_layout_mirrors_csrc(stencil, C):
    offs = ((CROSS[0] + ((-8, 100 % C), (8, -(C - 1))))
            if stencil == "deep" else STENCILS[stencil](C)[0])
    assert T.pass_layout(C, offs) == _csrc_layout(C, offs)


def _units(R, C):
    """(c0, c1, r0, r1) of every unit in unit order (blockIdx.x)."""
    strips, w, rows, bands = T.pass_geometry(R, C)
    return [(s * w, min(s * w + w, C), b * rows, min(b * rows + rows, R))
            for b in range(bands) for s in range(strips)]


@pytest.mark.parametrize("shape", SHAPES)
def test_pass_geometry_covers_the_grid_once(shape):
    """The units' strips and bands cover the grid exactly once; strips of
    at most PASS_COLS columns start on 16-byte boundaries; bands of at
    least PASS_MIN_ROWS rows (but a grid shorter than that) aim at
    PASS_TARGET units."""
    R, C = shape
    strips, w, rows, bands = T.pass_geometry(R, C)
    assert w <= T.PASS_COLS and w % 4 == 0
    assert rows >= min(R, T.PASS_MIN_ROWS)
    units = _units(R, C)
    assert len(units) == strips * bands
    if rows > T.PASS_MIN_ROWS:
        assert len(units) <= T.PASS_TARGET
    if R * C <= 1 << 22:
        covered = np.zeros((R, C), np.int32)
        for c0, c1, r0, r1 in units:
            assert c0 < c1 and r0 < r1
            covered[r0:r1, c0:c1] += 1
        assert (covered == 1).all()


def test_pass_geometry_at_full_width():
    """At 4096^2 one strip of the whole row and 128 bands of 32 rows (one
    unit per SM, 4 SMs of 132 idle); on a quarter-height piece 64 bands of
    16; at 8192 columns two strips."""
    assert T.pass_geometry(4096, 4096) == (1, 4096, 32, 128)
    assert T.pass_geometry(1024, 4096) == (1, 4096, 16, 64)
    assert T.pass_geometry(4096, 8192) == (2, 4096, 63, 66)


@pytest.mark.parametrize("shape", [(4096, 4096), (203, 4096), (37, 1000)])
def test_pass_geometry_depends_on_the_shape_alone(shape):
    """Every stencil on a shape gets the same units in the same order
    (the ring's layout changes, the units do not): the dot's sum order,
    and with it its bits, is a function of the shape."""
    orders = {tuple(_units(*shape))}
    for fn in STENCILS.values():
        offs = fn(shape[1])[0]
        assert T.pass_layout(shape[1], offs)[0] > 0
        orders.add(tuple(_units(*shape)))
    assert len(orders) == 1


@pytest.mark.parametrize("shape", [(4096, 4096), (1024, 4096), (8, 128),
                                   (33, 4097), (20, 5000)])
def test_pass_scratch_covers_the_units(shape, monkeypatch):
    """The band route's scratch holds PASS_DOTS float64 partials per unit
    of the launch (K5b's two dots) and a zeroed last-block counter."""
    monkeypatch.setattr(T, "_raw_stream", lambda device: 0)
    monkeypatch.setattr(T, "_PASS_SCRATCH", {})
    partials, units, counter = T._one_pass_scratch(torch.device("cpu"),
                                                   *shape, "band")
    strips, _, _, bands = T.pass_geometry(*shape)
    assert units == strips * bands == len(_units(*shape))
    assert partials.dtype == torch.float64
    assert partials.numel() == T.PASS_DOTS * units
    assert counter.numel() == 1 and int(counter) == 0
    assert T._one_pass_scratch(torch.device("cpu"), *shape,
                               "band")[0] is partials


# ---------------------------------------------------------------------------
# a numpy transcription of the band march
# ---------------------------------------------------------------------------

def _floor4(c):
    return c // 4 * 4


def _march(row, R, C, offs, vals, emit, store=None):
    """The band march's steps on an [R, C] grid whose operand row q is
    ``row(q)``: each unit stores operand row s of its window into ring
    slot s mod rows (padded with zeros beside the grid, or clipped to [0,
    C) with its out-of-grid terms masked; ``store(s, c0, c1, values)`` at
    the unit's own rows, where K4 and K5a write their operand) and
    computes output row s - hi - 1 from the ring, checking that every term
    reads the slot of its row, inside the columns the row load covered;
    ``emit(unit, i, c0, c1, acc, own)`` takes (A x) at the unit's columns
    of output row i, summed in float64 in stencil order, and the operand
    there read from the ring."""
    S, mask, nring, _ = T.pass_layout(C, offs)
    assert S > 0
    lo = min(0, min(dy for dy, _ in offs))
    hi = max(0, max(dy for dy, _ in offs))
    qm = max(0, max(-dx for _, dx in offs))
    qp = max(0, max(dx for _, dx in offs))
    L = hi + 1
    for u, (c0, c1, r0, r1) in enumerate(_units(R, C)):
        wl = _floor4(max(0, c0 - qm)) if mask else _floor4(c0 - qm)
        ls, le = max(0, wl), min(C, -(-(c1 + qp) // 4) * 4)
        assert le - wl <= S
        ring = np.zeros((nring, S))
        held = [None] * nring
        ss = 0
        cols = np.arange(c0, c1)
        for s in range(r0 + lo, r1 + hi + 1):
            if s <= r1 - 1 + hi:
                ring[ss] = 0.0
                ring[ss, ls - wl:le - wl] = row(s)[ls:le]
                held[ss] = s
                if store is not None and r0 <= s < r1:
                    store(s, c0, c1, ring[ss, c0 - wl:c1 - wl])
            i = s - L
            if r0 <= i < r1:
                acc = np.zeros(c1 - c0)
                for (dy, dx), v in zip(offs, vals):
                    slot = (ss - (L - dy)) % nring
                    assert held[slot] == i + dy
                    jx = cols + dx
                    inside = (jx >= 0) & (jx < C)
                    assert ((jx[inside] >= ls) & (jx[inside] < le)).all()
                    if not mask:
                        assert (jx - wl >= 0).all() and (jx - wl < S).all()
                    t = ring[slot, np.clip(jx - wl, 0, S - 1)]
                    acc += v * np.where(inside, t, 0.0)
                own = ring[(ss - L) % nring, c0 - wl:c1 - wl]
                assert held[(ss - L) % nring] == i
                emit(u, i, c0, c1, acc, own)
            ss = (ss + 1) % nring


def band_march(x, top, bot, offs, vals):
    """y = A x by the band march's steps (:func:`_march`), the rows
    outside the grid from the halo blocks.  Returns (y, how often each
    element was written)."""
    R, C = x.shape
    ext = np.concatenate([top, x, bot])  # rows -8 .. R + 7
    y = np.zeros((R, C), np.float64)
    writes = np.zeros((R, C), np.int32)

    def emit(u, i, c0, c1, acc, own):
        y[i, c0:c1] = acc
        writes[i, c0:c1] += 1

    _march(lambda s: ext[8 + s], R, C, offs, vals, emit)
    return y, writes


def band_march_k5(mode, d, offs, vals, compensated):
    """K5a (``pv``), K5b (``st``) or K5c (``update``) by the band march's
    steps: the operand (p' = r + beta (p - omega v), or s = r - alpha v)
    formed in f32 as its row arrives, zero outside the grid (no halo
    blocks); A of it rounded to f32 (K5a writes it, v'; K5c forms r' = s -
    omega t from it and from s read from the ring, and x' = (x + alpha p) +
    omega s, into a copy of x); p' written at each unit's own rows; each
    dot's products exact (``compensated``) or rounded to f32, summed in
    float64 per unit, the units summed in unit order, rounded to f32 once.
    Returns (p', v', dots, writes of p', writes of v') for ``pv``, (dots,)
    for ``st``, (x', r', dots, writes of x', writes of r') for
    ``update``."""
    R, C = d["r"].shape
    if mode == "pv":
        def form(q):
            return d["r"][q] + d["beta"] * (d["p"][q]
                                            - d["omega"] * d["v"][q])
    else:
        def form(q):
            return d["r"][q] - d["alpha"] * d["v"][q]
    zero = np.zeros(C, np.float32)
    row = lambda q: form(q) if 0 <= q < R else zero
    nd = 1 if mode == "pv" else 2
    xn = d["x"].copy() if mode == "update" else None
    parts = np.zeros((len(_units(R, C)), nd))
    pn, vn = np.zeros((R, C), np.float32), np.zeros((R, C), np.float32)
    pw, vw = np.zeros((R, C), np.int32), np.zeros((R, C), np.int32)

    def prod(a, b):
        a, b = np.float32(a), np.float32(b)
        return (a.astype(np.float64) * b if compensated
                else (a * b).astype(np.float64))

    def store(s, c0, c1, values):
        pn[s, c0:c1] = values
        pw[s, c0:c1] += 1

    def emit(u, i, c0, c1, acc, own):
        t = acc.astype(np.float32)
        if mode == "pv":
            vn[i, c0:c1] = t
            vw[i, c0:c1] += 1
            parts[u, 0] += prod(d["rt"][i, c0:c1], t).sum()
        elif mode == "update":
            s = own.astype(np.float32)
            xn[i, c0:c1] = ((xn[i, c0:c1] + d["alpha"] * d["p"][i, c0:c1])
                            + d["omega"] * s)
            pw[i, c0:c1] += 1
            rn = s - d["omega"] * t
            vn[i, c0:c1] = rn
            vw[i, c0:c1] += 1
            parts[u, 0] += prod(rn, rn).sum()
            parts[u, 1] += prod(d["rt"][i, c0:c1], rn).sum()
        else:
            parts[u, 0] += prod(t, own).sum()
            parts[u, 1] += prod(t, t).sum()

    _march(row, R, C, offs, vals, emit, store if mode == "pv" else None)
    dots = np.zeros(nd)
    for part in parts:  # unit order
        dots += part
    dots = dots.astype(np.float32)
    if mode == "update":
        return xn, vn, dots, pw, vw
    return (pn, vn, dots, pw, vw) if mode == "pv" else (dots,)


@pytest.mark.parametrize("halos", [False, True])
@pytest.mark.parametrize("shape", [(8, 128), (37, 1000), (3, 130),
                                   (18, 4096), (5, 4100), (20, 5000)])
@pytest.mark.parametrize("stencil", list(STENCILS))
def test_band_march_transcription_matches_plain(stencil, shape, halos):
    """The band march's ring, slots, windows and masks compute A x with
    the halo blocks' rows, writing every element once: padded windows
    (S2_gen, S2_4x), clipped ones (wide_kw and flat5 at 4096 columns and
    past), two strips (4100, 5000 columns), a grid shorter than the
    ring (3 rows)."""
    R, C = shape
    offs, vals = STENCILS[stencil](C)
    if T.route(offs, vals, C)[0] != "band":
        pytest.skip(f"{stencil} at {C} columns is past the gate")
    rng = np.random.default_rng(7)
    x = rng.standard_normal(shape)
    top, bot = ((rng.standard_normal((8, C)) for _ in range(2)) if halos
                else (np.zeros((8, C)), np.zeros((8, C))))
    y, writes = band_march(x, top, bot, offs, vals)
    assert (writes == 1).all()
    want = T.apply_plain(torch.from_numpy(x), offs, vals,
                         torch.from_numpy(top), torch.from_numpy(bot)).numpy()
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-12 * np.abs(want)
                               .max())


def _k5_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("r", "p", "v", "rt", "x")}
    d.update(alpha=np.float32(0.83), beta=np.float32(0.37),
             omega=np.float32(0.41))
    return d


def _cs(a, b):
    """The Cauchy-Schwarz scale of <a, b>: sqrt(<a, a> <b, b>)."""
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.sqrt((a * a).sum() * (b * b).sum()))


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("mode", ["pv", "st", "update"])
@pytest.mark.parametrize("shape", [(8, 128), (37, 1000), (3, 130),
                                   (18, 4096), (5, 4100), (20, 5000)])
@pytest.mark.parametrize("stencil", ["S2_gen", "S2_4x", "wide_kw"])
def test_band_march_k5_transcription_matches_plain(stencil, shape, mode,
                                                   compensated):
    """K5a's, K5b's and K5c's modes of the band march against
    bicg_pv_plain, bicg_st_plain and bicg_update_plain, with exact and
    f32-rounded dot products: p' and x' bit for bit (formed in f32 in the
    same order) and written once, v' and r' within 1e-6 * max|ref| (A of
    the operand summed in another order and rounded once) and written
    once, every dot within 1e-6 of its Cauchy-Schwarz scale (the plain
    versions sum in f32, or compensated in float64 pairs)."""
    R, C = shape
    offs, vals = STENCILS[stencil](C)
    if T.route(offs, vals, C, bicg=mode)[0] != "band":
        pytest.skip(f"{stencil} at {C} columns is off the band route")
    d = _k5_inputs(shape, seed=R + C)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
    kw = dict(offsets=offs, values=vals, compensated=compensated)
    if mode == "pv":
        pn, vn, dots, pw, vw = band_march_k5(mode, d, offs, vals,
                                             compensated)
        rp, rv, rdot = TB.bicg_pv_plain(t["r"], t["p"], t["v"], t["rt"],
                                        t["beta"], t["omega"], **kw)
        assert (pw == 1).all() and (vw == 1).all()
        np.testing.assert_array_equal(pn, rp.numpy())
        np.testing.assert_allclose(vn, rv.numpy(), rtol=0,
                                   atol=1e-6 * rv.abs().max().item())
        assert abs(dots[0] - rdot.item()) <= 1e-6 * _cs(d["rt"], rv)
    elif mode == "update":
        xn, rn, dots, xw, rw = band_march_k5(mode, d, offs, vals,
                                             compensated)
        rx, rr, rrr, rtr = TB.bicg_update_plain(
            t["r"], t["v"], t["x"].clone(), t["p"], t["rt"], t["alpha"],
            t["omega"], **kw)
        assert (xw == 1).all() and (rw == 1).all()
        np.testing.assert_array_equal(xn, rx.numpy())
        np.testing.assert_allclose(rn, rr.numpy(), rtol=0,
                                   atol=1e-6 * rr.abs().max().item())
        assert abs(dots[0] - rrr.item()) <= 1e-6 * _cs(rr, rr)
        assert abs(dots[1] - rtr.item()) <= 1e-6 * _cs(d["rt"], rr)
    else:
        (dots,) = band_march_k5(mode, d, offs, vals, compensated)
        ts, tt = TB.bicg_st_plain(t["r"], t["v"], t["alpha"], **kw)
        s = t["r"] - t["alpha"] * t["v"]
        a = T.apply_plain(s, offs, vals)
        assert abs(dots[0] - ts.item()) <= 1e-6 * _cs(a, s)
        assert abs(dots[1] - tt.item()) <= 1e-6 * _cs(a, a)


def test_clipped_and_padded_layouts_both_occur():
    """The cases above take both windows: S2_gen padded at 4096 columns
    (4304 floats), wide_kw clipped to the row (4096)."""
    assert T.pass_layout(4096, s2_gen(4096)[0])[:2] == (4304, 0)
    assert T.pass_layout(4096, wide_kw(4096)[0])[:3] == (4096, 1, 11)
    assert T.pass_layout(4096, flat5(4096)[0])[:3] == (4096, 1, 4)


# ---------------------------------------------------------------------------
# the plain versions against JAX
# ---------------------------------------------------------------------------

def _inputs(shape, seed, halos):
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p")}
    for k in ("ht", "hb", "gt", "gb"):
        d[k] = (rng.standard_normal((8, shape[1])).astype(np.float32)
                if halos else np.zeros((8, shape[1]), np.float32))
    d["alpha"] = np.float32(rng.uniform(0.1, 0.5))
    d["beta"] = np.float32(rng.uniform(0.1, 0.5))
    return d


def _one_pass(jax, mode, d, offs, vals):
    """K3 ``mode`` or K4 through JAX's kernel in interpret mode or the
    port's wrapper on CPU tensors (its plain version)."""
    if jax:
        a = {k: jnp.asarray(v) for k, v in d.items()}
        kw = dict(offsets=offs, values=vals, interpret=True)
        M = JS
    else:
        a = {k: torch.tensor(np.asarray(v)) for k, v in d.items()}
        kw = dict(offsets=offs, values=vals)
        M = T
    if mode == "y":
        return {"y": M.grid2d_stencil_matvec(a["x"], a["ht"], a["hb"], **kw)}
    if mode == "y_dot":
        y, dot = M.grid2d_stencil_matvec(a["x"], a["ht"], a["hb"],
                                         with_dot=True, **kw)
        return {"y": y, "dot": dot}
    if mode == "pq":
        return {"dot": M.grid2d_cg_pq(a["p"], a["gt"], a["gb"], **kw)}
    if mode == "update":
        x, r, rr = M.grid2d_cg_update(a["p"], a["x"], a["r"], a["alpha"],
                                      a["gt"], a["gb"], **kw)
        return {"x": x, "r": r, "dot": rr}
    p, pq = M.grid2d_cg_xpay_pq(a["r"], a["p"], a["beta"], a["ht"], a["hb"],
                                a["gt"], a["gb"], **kw)
    return {"p": p, "dot": pq}


@pytest.mark.parametrize("halos", [False, True])
@pytest.mark.parametrize("stencil", list(STENCILS))
@pytest.mark.parametrize("mode", ["y", "y_dot", "pq", "update", "xpay_pq"])
def test_one_pass_plain_matches_jax(mode, stencil, halos):
    """K3's four modes and K4 with the band route's stencils at [16, 256]
    (S2_gen's |dx| = 100, wide_kw's (1, -255) and (-8, 100), flat5's
    row-wrap terms): elementwise atol 1e-4 * max|ref|, dots rtol 1e-4."""
    shape = (16, 256)
    offs, vals = STENCILS[stencil](shape[1])
    assert JS.supports(*shape, offs)
    d = _inputs(shape, seed=5 + len(mode) + 3 * halos, halos=halos)
    got = _one_pass(False, mode, d, offs, vals)
    ref = _one_pass(True, mode, d, offs, vals)
    for key, want in ref.items():
        have = np.asarray(got[key], np.float64)
        want = np.asarray(want, np.float64)
        if want.ndim == 2:
            np.testing.assert_allclose(have, want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=key)
        else:
            np.testing.assert_allclose(have, want, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("stencil", list(STENCILS))
def test_wrappers_run_plain_on_cpu(stencil):
    """On CPU tensors the K3 and K4 wrappers with the band route's
    stencils return their plain versions' results exactly and launch
    nothing."""
    shape = (24, 1000)
    offs, vals = STENCILS[stencil](shape[1])
    kw = dict(offsets=offs, values=vals)
    d = {k: torch.tensor(v) for k, v in _inputs(shape, 9, True).items()}
    T.reset_launch_counts()
    y, dot = T.grid2d_stencil_matvec(d["x"], d["ht"], d["hb"], with_dot=True,
                                     **kw)
    ref = T.stencil_plain("y_dot", d["x"], d["ht"], d["hb"], **kw)
    assert torch.equal(y, ref[0]) and torch.equal(dot, ref[1])
    p, pq = T.grid2d_cg_xpay_pq(d["r"], d["p"], d["beta"], d["ht"], d["hb"],
                                d["gt"], d["gb"], **kw)
    refp = T.xpay_pq_plain(d["r"], d["p"], d["beta"], d["ht"], d["hb"],
                           d["gt"], d["gb"], **kw)
    assert torch.equal(p, refp[0]) and torch.equal(pq, refp[1])
    assert sum(T.LAUNCHES.values()) == 0
