"""The s-step passes K1 (step2) and K2 (gram2) on the general route ("B
(general)": 2-D stencils with |dy| <= 1 and any |dx| < C that are neither
reach 1 nor a flat 1-D decomposition), the port against the JAX package on
the CPU.

Stencils, both symmetric and positive definite under Dirichlet truncation:

* S2_GEN, 13 terms: the 5-point cross with 7.0 at the centre, (0, +-2)
  and (0, +-37) with -0.5, (+-1, +-100) with -0.25 (weakly diagonally
  dominant, as ill-conditioned as the Laplacian);
* S2_4X, -d_xx to fourth order plus -d_yy to second order: (0, 0) 4.5,
  (+-1, 0) -1, (0, +-1) -16/12, (0, +-2) 1/12;
* ``wide(C)`` of ``test_torch_flat1d.py``, whose (1, -(C - 1)) spans the
  whole width of JAX's gate.

The same numpy inputs go through JAX's ``grid2d_cg_step2`` and
``grid2d_cg_gram2`` in interpret mode and through the port's wrappers,
which run their plain versions on CPU tensors (``test_torch_flat1d.py``'s
tolerances: arrays atol 1e-4 * max|ref|, Gram entries 1e-4 of their
Cauchy-Schwarz scale).  CG solves run JAX's s-step runner and the port's
on (64, 256) at ``test_20_sstep.py``'s tolerances (history rtol 5e-4, x
within 2e-3 of max|x|): one piece at 40 and 41 iterations and at 40 with
LEGIONSOLVERS_SSTEP_REFRESH=2, 4 pieces (JAX's ``mesh4``, blocks of 16
rows) and a 2-space block at 41 iterations, where the port's solve(40)
must give the first 41 entries of its solve(41) bit for bit.

Where the gates differ: JAX's also asks C % 128 == 0 and a VMEM budget
(which refuses R = 13, R = 1 or C = 8), TPU layout gates that Hopper does
not have, so the port takes those shapes; the port asks at most 32 terms
(its kernels' stencil argument, as every 2-D kernel's), JAX does not.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.ops.pallas import stencil2d as JS
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TS
from legionsolvers_tpu_torch.parallel.sstep_sharded import MAX_DX
from tests.test_torch_flat1d import close, wide
from tests.test_torch_sharded_solvers import env, hist_of, sol, system
from torch_stencil_cases import gram_bounds

torch.set_num_threads(2)

CROSS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
S2_GEN = list(zip(
    CROSS + ((0, 2), (0, -2), (0, 37), (0, -37), (1, 100), (-1, -100),
             (1, -100), (-1, 100)),
    (7.0, -1.0, -1.0, -1.0, -1.0, -0.5, -0.5, -0.5, -0.5, -0.25, -0.25,
     -0.25, -0.25)))
S2_4X = list(zip(
    ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (0, -2), (0, 2)),
    (4.5, -1.0, -1.0, -16 / 12, -16 / 12, 1 / 12, 1 / 12)))


def wide_terms(C):
    return list(zip(*wide(C)))


def edge1000(C):
    """The cross with (+-1, -+1000): past K1's band gate at 1024 columns
    (its window would take 1024 + 2000 floats a ring row), inside K2's."""
    return list(zip(CROSS + ((1, -1000), (-1, 1000)),
                    (5.0, -1.0, -1.0, -1.0, -1.0, -0.5, -0.5)))


STENCILS = {"S2_GEN": lambda C: S2_GEN, "S2_4X": lambda C: S2_4X,
            "wide": wide_terms, "edge1000": edge1000}
SHAPE = (64, 256)


def kw_of(terms):
    return dict(offsets=tuple(o for o, _ in terms),
                values=tuple(v for _, v in terms))


def offs(name, C):
    return kw_of(STENCILS[name](C))["offsets"]


# -- the gates ---------------------------------------------------------------

def pair(dx):
    """The cross with (0, +-dx), a symmetric term pair."""
    return CROSS + ((0, dx), (0, -dx))


# (R, C, offsets, JAX takes it, the port takes it)
GATES = {
    "S2_GEN 4096^2": (4096, 4096, offs("S2_GEN", 4096), True, True),
    "S2_GEN 1024 x 4096 (a piece)": (1024, 4096, offs("S2_GEN", 4096), True,
                                     True),
    "S2_GEN (64, 256)": (64, 256, offs("S2_GEN", 256), True, True),
    "S2_GEN (16, 128)": (16, 128, offs("S2_GEN", 128), True, True),
    "S2_4X 4096^2": (4096, 4096, offs("S2_4X", 4096), True, True),
    "S2_4X (16, 128)": (16, 128, offs("S2_4X", 128), True, True),
    "wide(128) (16, 128)": (16, 128, offs("wide", 128), True, True),
    "wide(4096) 4096^2": (4096, 4096, offs("wide", 4096), True, True),
    "|dx| = C - 1 = 4095": (4096, 4096, CROSS + ((1, -4095), (-1, 4095)),
                            True, True),
    # C % 128 and the VMEM budget are the TPU's, not Hopper's
    "S2_GEN C = 200": (64, 200, offs("S2_GEN", 200), False, True),
    "S2_GEN R = 13": (13, 256, offs("S2_GEN", 256), False, True),
    "S2_GEN R = 1": (1, 128, offs("S2_GEN", 128), False, True),
    "S2_4X (5, 8)": (5, 8, offs("S2_4X", 8), False, True),
    "|dy| = 2": (64, 256, CROSS + ((2, 0), (-2, 0)), False, False),
    "|dy| = 2 wide": (64, 256, CROSS + ((2, 100),), False, False),
    "|dx| = C": (64, 128, CROSS + ((0, 128),), False, False),
    # the kernels' stencil argument holds 32 terms
    "33 terms": (64, 256, tuple((0, k - 16) for k in range(33)), True,
                 False),
}


# the cases of GATES whose widest |dx| at 4096 columns is past K1's band
# march (its rings would not fit): K1 keeps the cooperative kernel there;
# K2's band march takes every case of GATES (its window clipped to the row
# for |dx| = C - 1)
COOP = {"wide(4096) 4096^2", "|dx| = C - 1 = 4095"}


@pytest.mark.parametrize("case", list(GATES))
def test_gates_of_both_packages(case):
    """JAX's ``step2_supported`` and the port's on the table above; the
    port routes what it takes past reach 1 and off the flat view to the
    general route: K1's band march (``general``), or the cooperative
    kernel for the cases of COOP (``general_coop``), and K2's band march
    for all of them."""
    R, C, o, jax_takes, port_takes = GATES[case]
    assert JS.step2_supported(R, C, o) is jax_takes
    assert TS.step2_supported(R, C, o) is port_takes
    if port_takes and TS._reach(o) > 1:
        vals = (1.0,) * len(o)
        assert TS.route(o, vals, C, sstep=True)[0] == (
            "general_coop" if case in COOP else "general")
        assert TS.route(o, vals, C, sstep="gram2")[0] == "general"
        assert TS.route(o, vals, C)[0] == "band"
        assert TS.route(o, vals, C, bicg="pv")[0] == "band"
        assert TS.route(o, vals, C, bicg="st")[0] == "band"
        assert TS.route(o, vals, C, bicg="update")[0] == "band"


# (stencil terms, pieces, JAX and the port run the s-step)
ELIGIBLE = {
    "S2_GEN": (S2_GEN, 1, True),
    "S2_GEN 4 pieces": (S2_GEN, 4, True),
    "S2_4X": (S2_4X, 1, True),
    "S2_4X 4 pieces": (S2_4X, 4, True),
    "wide(256)": (wide_terms(256), 1, True),
    # JAX's edge fix-ups on pieces take |dx| <= PADC - 8 = 120
    "wide(256) 4 pieces": (wide_terms(256), 4, False),
    "|dx| = 120 4 pieces": (list(zip(pair(120), (5.0,) + (-1.0,) * 6)), 4,
                            True),
    "|dx| = 121 4 pieces": (list(zip(pair(121), (5.0,) + (-1.0,) * 6)), 4,
                            False),
    "|dx| = 121": (list(zip(pair(121), (5.0,) + (-1.0,) * 6)), 1, True),
}


@pytest.mark.parametrize("case", list(ELIGIBLE))
def test_step2_eligible_matches_jax(case, mesh4):
    """``StencilOperator.step2_eligible`` of both packages at (64, 256)
    on one piece and on 4 (blocks of 16 rows): the port runs the s-step
    where JAX does, on pieces up to |dx| = MAX_DX."""
    terms, pieces, want = ELIGIBLE[case]
    assert MAX_DX == JS.PADC - 8
    n = SHAPE[0] * SHAPE[1]
    opj = J.StencilOperator(SHAPE, terms, partition=J.BlockPartition(
        n, pieces), mesh=mesh4 if pieces == 4 else None,
        options=J.SolverOptions(entry_dtype=jnp.float32))
    _, opt = system(T, SHAPE, pieces, stencil=terms)
    assert opj.uses_pallas and opt.uses_pallas
    assert opt._view["offs"] == opj._view["offs"]
    assert opj.step2_eligible is want
    assert opt.step2_eligible is want


# -- the wrappers against JAX's interpret-mode kernels ------------------------

# the last two are past K1's band gate and inside K2's: (+-1, -+1000) at
# 1024 columns takes K2's padded window, wide(2048)'s (1, -2047) its window
# clipped to the row
KERNEL_CASES = {"S2_GEN (16, 128)": ("S2_GEN", (16, 128)),
                "S2_GEN (64, 256)": ("S2_GEN", (64, 256)),
                "S2_4X (16, 128)": ("S2_4X", (16, 128)),
                "S2_4X (64, 256)": ("S2_4X", (64, 256)),
                "wide(128) (16, 128)": ("wide", (16, 128)),
                "(+-1, -+1000) (16, 1024)": ("edge1000", (16, 1024)),
                "wide(2048) (16, 2048)": ("wide", (16, 2048))}


@pytest.mark.parametrize("case", list(KERNEL_CASES))
@pytest.mark.parametrize("mode", ["gram2", "step2"])
def test_kernels_match_jax(mode, case):
    """K2 and K1 through the port's wrappers (the general route's plain
    versions on CPU tensors; nothing launches) against JAX's kernels; K2
    takes its band march in every case, K1 its band march or, past its
    gate, the cooperative kernel."""
    name, shape = KERNEL_CASES[case]
    kw = kw_of(STENCILS[name](shape[1]))
    k1 = ("general" if TS.band_stride(shape[1], kw["offsets"])
          else "general_coop")
    assert TS.route(kw["offsets"], kw["values"], shape[1],
                    sstep=True)[0] == k1
    assert TS.route(kw["offsets"], kw["values"], shape[1],
                    sstep="gram2")[0] == "general"
    assert (k1 == "general_coop") is (shape[1] > 256)
    rng = np.random.default_rng(41 + len(mode))
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p")}
    t = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    a = {k: jnp.asarray(v) for k, v in d.items()}
    TS.reset_launch_counts()
    if mode == "gram2":
        got = {"gram": TS.grid2d_cg_gram2(t["r"], t["p"], **kw)}
        ref = {"gram": JS.grid2d_cg_gram2(a["r"], a["p"], interpret=True,
                                          **kw)}
        close(got, ref, gram_bounds(d["r"], d["p"], kw["offsets"],
                                    kw["values"]))
    else:
        coef = TS.cg2_coeffs(TS.gram2_plain(t["r"], t["p"], **kw))[0]
        xo, ro, po, go = TS.grid2d_cg_step2(t["x"], t["r"], t["p"], coef,
                                            **kw)
        assert xo is t["x"]  # in place
        x, r, p, g = JS.grid2d_cg_step2(a["x"], a["r"], a["p"],
                                        jnp.asarray(coef.numpy()),
                                        interpret=True, **kw)
        close({"x": xo, "r": ro, "p": po}, {"x": x, "r": r, "p": p})
        close({"gram": go}, {"gram": g},
              gram_bounds(np.asarray(r), np.asarray(p), kw["offsets"],
                          kw["values"]))
    assert not TS.LAUNCHES


@pytest.mark.parametrize("bad", ["|dy| = 2", "|dx| = C", "nop"])
def test_wrappers_refuse(bad):
    """Outside the gate the wrappers raise, on the CPU as on the card; K1's
    nop mode keeps the strip route's reach-1 stencils."""
    x, r, p = (torch.zeros(16, 128) for _ in range(3))
    coef = torch.zeros(6)
    kw = {"|dy| = 2": dict(offsets=CROSS + ((2, 0),), values=(1.0,) * 6),
          "|dx| = C": dict(offsets=CROSS + ((0, 128),), values=(1.0,) * 6),
          "nop": kw_of(S2_GEN)}[bad]
    with pytest.raises(ValueError):
        if bad == "nop":
            TS._grid2d_cg_nop(x, r, p, coef, **kw)
        else:
            TS.grid2d_cg_step2(x, r, p, coef, **kw)
    if bad != "nop":
        with pytest.raises(ValueError):
            TS.grid2d_cg_gram2(r, p, **kw)


def test_general_units_mirror_csrc():
    """``general_units`` mirrors ``gen_geometry`` of
    csrc/sstep_general.cu (also checked when the library loads): units of
    whole rows, LS_GEN_UNIT_ELEMS elements, at least one row."""
    src = (TS.__file__.rsplit("ops", 1)[0] + "csrc/sstep_general.cu")
    with open(src) as f:
        elems = re.search(r"#define LS_GEN_UNIT_ELEMS (\d+)", f.read())
    assert int(elems.group(1)) == TS.GEN_UNIT_ELEMS
    assert TS.general_units(4096, 4096) == 2048
    assert TS.general_units(1024, 4096) == 512
    assert TS.general_units(16, 128) == 1
    assert TS.general_units(33, 4097) == 33
    assert TS.general_units(1, 5) == 1


# -- K1's band march: the Python mirrors of its geometry and gate ------------

# (R, C): (strips, strip columns, band rows, bands), from
# ``band_geometry`` of csrc/sstep_general.cu (also checked when the
# library loads): strips of at most 1024 columns, bands aiming at 264 units
# and no shorter than 16 rows
BAND_GEOMETRY = {
    (4096, 4096): (4, 1024, 63, 66),   # phase 4n's grid: 264 units
    (1024, 4096): (4, 1024, 16, 64),   # a quarter-height piece
    (33, 4097): (5, 820, 16, 3),
    (5, 130): (1, 130, 5, 1),
    (1, 101): (1, 101, 1, 1),
    (16, 128): (1, 128, 16, 1),
    (5000, 1): (1, 1, 19, 264),
    (64, 256): (1, 256, 16, 4),
}


@pytest.mark.parametrize("shape", list(BAND_GEOMETRY))
def test_band_geometry_mirrors_csrc(shape):
    """The band march's strips and bands are a function of the shape alone
    (so is the Gram's sum order): they cover the grid, strips within 1024
    columns, bands no shorter than 16 rows unless the grid is."""
    R, C = shape
    strips, w, rows, bands = TS.band_geometry(R, C)
    assert (strips, w, rows, bands) == BAND_GEOMETRY[shape]
    assert w <= TS.BAND_COLS and strips * w >= C > (strips - 1) * w
    assert bands * rows >= R > (bands - 1) * rows
    assert rows >= min(R, TS.BAND_MIN_ROWS)


def test_band_constants_mirror_csrc():
    """BAND_* mirror the LS_BAND_* defines of csrc/sstep_general.cu, and
    the rings' rows sum to LS_BAND_RING_ROWS."""
    src = (TS.__file__.rsplit("ops", 1)[0] + "csrc/sstep_general.cu")
    with open(src) as f:
        text = f.read()
    define = lambda n: re.search(rf"#define LS_BAND_{n} (\S+)", text).group(1)
    assert int(define("COLS")) == TS.BAND_COLS
    assert int(define("MIN_ROWS")) == TS.BAND_MIN_ROWS
    assert int(define("TARGET")) == TS.BAND_TARGET
    assert int(define("RING_ROWS")) == TS.BAND_RING_ROWS == 4 + 4 + 2 + 3 + 5 + 4 + 3
    assert int(define("THREADS")) == TS.BAND_THREADS
    assert define("SMEM_MAX") == "(225"
    assert TS.BAND_MAX_STRIDE == 2195  # (57600 - 512) // 26


# (C, stencil, ring-row floats or 0 past the gate)
BAND_GATE = {
    "S2_GEN 4096": (4096, S2_GEN, 1824),       # 1024 + 8 * 100
    "S2_4X 4096": (4096, S2_4X, 1040),         # 1024 + 8 * 2
    "|dx| = 146 at 4096": (4096, list(zip(pair(146), (5.0,) + (-1.0,) * 6)),
                           2192),               # the widest that fits
    "|dx| = 147 at 4096": (4096, list(zip(pair(147), (5.0,) + (-1.0,) * 6)),
                           0),
    "S2_GEN with |dx| = 200 at 4096": (
        4096, [((dy, 2 * dx if abs(dx) == 100 else dx), v)
               for (dy, dx), v in S2_GEN], 0),  # phase 4n's S2_far
    "|dx| = 4095 at 4096": (4096, list(zip(CROSS + ((1, -4095), (-1, 4095)),
                                           (5.0,) + (-1.0,) * 6)), 0),
    "wide(128) at 128": (128, wide_terms(128), 384),  # 128 + 2 * 127
    "S2_GEN 4097": (4097, S2_GEN, 1620),       # 820 + 8 * 100
    "|dx| = 129 at 130": (130, list(zip(pair(129), (5.0,) + (-1.0,) * 6)),
                          388),
    "|dx| = 1000 at 1024": (1024, list(zip(pair(1000), (5.0,) + (-1.0,) * 6)),
                            0),                 # 1024 + 2000 > 2304
}


@pytest.mark.parametrize("case", list(BAND_GATE))
def test_band_gate_and_route(case):
    """The gate of K1's band march (``band_stride``: the widest window,
    min(w + 8 Q, C + 2 Q) rounded up to 4, fits 2195 floats a ring row)
    and ``route``: ``general`` where it fits, ``general_coop`` (the
    cooperative kernel) where it does not.  Phase 4n's S2_gen and S2_4x
    at 4096 columns take the band march."""
    C, terms, stride = BAND_GATE[case]
    kw = kw_of(terms)
    assert TS.band_stride(C, kw["offsets"]) == stride
    assert TS.route(kw["offsets"], kw["values"], C, sstep=True)[0] == (
        "general" if stride else "general_coop")


# -- K2's band march: the Python mirrors of its gate ---------------------------

def test_gram2_constants_mirror_csrc():
    """G2_RING_ROWS and G2_MAX_STRIDE mirror the LS_G2_* defines of
    csrc/sstep_general.cu: rings of p (4 rows), r (5) and A p (3), and the
    widest ring row whose rings, one row more and a block's width of slack
    fit LS_BAND_SMEM_MAX (225 KB)."""
    src = (TS.__file__.rsplit("ops", 1)[0] + "csrc/sstep_general.cu")
    with open(src) as f:
        text = f.read()
    rows = re.search(r"#define LS_G2_RING_ROWS (\d+)", text).group(1)
    assert int(rows) == TS.G2_RING_ROWS == 4 + 5 + 3
    assert ("#define LS_G2_MAX_STRIDE \\\n  ((LS_BAND_SMEM_MAX / 4 - "
            "LS_BAND_THREADS) / (LS_G2_RING_ROWS + 1))") in text
    assert TS.G2_MAX_STRIDE == 4391  # (57600 - 512) // 13


def _csrc_gram2_stride(C, Q):
    """``gram2_band_stride`` of csrc/sstep_general.cu, transcribed line for
    line: (ring row floats, mask)."""
    g_strip_cols = TS.band_geometry(1, C)[1]
    mask = 0
    for m in range(2):
        wid = g_strip_cols + 4 * Q
        edge = C if m else C + 2 * Q
        if edge < wid:
            wid = edge
        wid = (wid + 3) // 4 * 4
        mask = m
        if wid <= TS.G2_MAX_STRIDE:
            return wid, mask
    return 0, mask


@pytest.mark.parametrize("C", [1, 5, 101, 128, 130, 1024, 2048, 4096, 4097,
                               4388, 4389, 5000, 8192])
def test_gram2_layout_mirrors_csrc(C):
    """``gram2_layout`` equals a transcription of the C gate at every |dx|
    the general route takes at C columns (a sample of them), and its
    shared memory is the rings, one row more and a block's width of
    slack."""
    for Q in sorted({0, 1, 2, 37, 100, 146, 200, 841, 842, 1000, 1700,
                     C // 2, C - 1}):
        if not 0 <= Q < C:
            continue
        stride, clipped, smem = TS.gram2_layout(C, ((0, Q),))
        assert (stride, clipped) == _csrc_gram2_stride(C, Q), (C, Q)
        want = ((TS.G2_RING_ROWS + 1) * stride + TS.BAND_THREADS) * 4
        assert smem == (want if stride else 0)
        assert smem <= 225 * 1024


# (C, stencil, (ring-row floats or 0 past the gate, clipped), K1's route)
GRAM2_GATE = {
    "S2_GEN 4096": (4096, S2_GEN, (1424, 0), "general"),  # 1024 + 4 * 100
    "S2_4X 4096": (4096, S2_4X, (1032, 0), "general"),     # 1024 + 4 * 2
    "S2_GEN with |dx| = 200 at 4096": (
        4096, [((dy, 2 * dx if abs(dx) == 100 else dx), v)
               for (dy, dx), v in S2_GEN], (1824, 0), "general_coop"),
    "|dx| = 841 at 4096": (4096, list(zip(pair(841), (5.0,) + (-1.0,) * 6)),
                           (4388, 0), "general_coop"),  # the widest padded
    "|dx| = 842 at 4096": (4096, list(zip(pair(842), (5.0,) + (-1.0,) * 6)),
                           (4096, 1), "general_coop"),  # clipped to the row
    "|dx| = 4095 at 4096": (4096, list(zip(CROSS + ((1, -4095), (-1, 4095)),
                                           (5.0,) + (-1.0,) * 6)),
                            (4096, 1), "general_coop"),
    "wide(128) at 128": (128, wide_terms(128), (384, 0), "general"),
    "S2_GEN 4097": (4097, S2_GEN, (1220, 0), "general"),   # 820 + 4 * 100
    "|dx| = 4387 at 4388": (4388, list(zip(pair(4387),
                                           (5.0,) + (-1.0,) * 6)),
                            (4388, 1), "general_coop"),
    "|dx| = 4388 at 4389": (4389, list(zip(pair(4388),
                                           (5.0,) + (-1.0,) * 6)),
                            (0, 1), "general_coop"),    # past both gates
    "|dx| = 4999 at 5000": (5000, list(zip(CROSS + ((1, -4999), (-1, 4999)),
                                           (5.0,) + (-1.0,) * 6)),
                            (0, 1), "general_coop"),
    "|dx| = 841 at 5000": (5000, list(zip(pair(841), (5.0,) + (-1.0,) * 6)),
                           (4364, 0), "general_coop"),  # 1000 + 4 * 841
}


@pytest.mark.parametrize("case", list(GRAM2_GATE))
def test_gram2_gate_and_route(case):
    """K2's gate (``gram2_layout``: its padded window min(w + 4 Q, C + 2
    Q), else the window clipped to the row, min(w + 4 Q, C), rounded up to
    4, within 4391 floats a ring row) and ``route(..., sstep="gram2")``:
    ``general`` where it fits, ``general_coop`` past it (more than 4388
    columns with a wide |dx|); K1's route beside it."""
    C, terms, want, k1 = GRAM2_GATE[case]
    kw = kw_of(terms)
    assert TS.gram2_layout(C, kw["offsets"])[:2] == want
    assert TS.route(kw["offsets"], kw["values"], C, sstep="gram2")[0] == (
        "general" if want[0] else "general_coop")
    assert TS.route(kw["offsets"], kw["values"], C, sstep=True)[0] == k1
    assert TS.route(kw["offsets"], kw["values"], C,
                    sstep="step2")[0] == k1


def _dispatch(monkeypatch, module, calls):
    """Make ``module``'s wrappers take CPU tensors for CUDA ones and record
    the entry point each would launch, (pass, entry), in ``calls``; the
    scratch comes from the CPU."""
    monkeypatch.setattr(module, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(module, "_launch", lambda name, fn, args, dev:
                        calls.append((name, fn)))
    scratch = lambda dev, R, C: (torch.zeros(10 * R * C, dtype=torch.float64),
                                 R * C, torch.zeros(3, dtype=torch.int32))
    for name in ("_band_scratch", "_step2_scratch", "_pass_scratch"):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, scratch)
    if hasattr(module, "_general_scratch"):
        monkeypatch.setattr(module, "_general_scratch", lambda dev, R, C: (
            torch.zeros(2 * R * C), torch.zeros(10 * R * C,
                                                dtype=torch.float64),
            R * C, torch.zeros(3, dtype=torch.int32)))


@pytest.mark.parametrize("case", ["S2_GEN 4096", "|dx| = 4095 at 4096",
                                  "|dx| = 4999 at 5000"])
def test_gram2_wrapper_launches_its_route(case, monkeypatch):
    """``grid2d_cg_gram2`` on a card launches ``ls_gram2_band`` on K2's
    band route and ``ls_gram2_general`` past its gate, once (the launch
    recorded, not run)."""
    C, terms, want, _ = GRAM2_GATE[case]
    calls = []
    _dispatch(monkeypatch, TS, calls)
    r = p = torch.zeros(2, C)
    TS.grid2d_cg_gram2(r, p, **kw_of(terms))
    assert calls == [("gram2", "ls_gram2_band" if want[0]
                      else "ls_gram2_general")]


# -- CG solves ---------------------------------------------------------------

# (stencil, pieces, spaces, iterations, environment)
SOLVES = {
    "one piece 40": (S2_GEN, 1, 1, 40, {}),
    "one piece 41": (S2_GEN, 1, 1, 41, {}),
    "one piece 40 refresh 2": (S2_GEN, 1, 1, 40,
                               {"LEGIONSOLVERS_SSTEP_REFRESH": "2"}),
    "4 pieces 41": (S2_GEN, 4, 1, 41, {}),
    "2-space block 41": (S2_4X, 1, 2, 41, {}),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_sstep_solve_matches_jax(case, mesh4):
    """CG on the s-step schedule in both packages (the port's K1/K2 on the
    general route, their plain versions here): history rtol 5e-4 and x
    within 2e-3 of max|x| in every space.  At 41 iterations the port's
    solve(40) must give the first 41 entries of its solve(41) bit for
    bit (the same passes, without the odd tail)."""
    terms, pieces, spaces, iters, flags = SOLVES[case]
    with env(**flags):
        pj, opj = system(J, SHAPE, pieces, stencil=terms, num_spaces=spaces)
        pt, opt = system(T, SHAPE, pieces, stencil=terms, num_spaces=spaces)
        assert opj.step2_eligible and opt.step2_eligible
        assert TS.route(opt._view["offs"], opt._view["vals"], SHAPE[1],
                        sstep=True)[0] == "general"
        hj = hist_of(J.CGSolver(pj).solve(iters))
        st = T.CGSolver(pt)
        ht = hist_of(st.solve(iters))
        assert len(ht) == len(hj) == iters + 1
        np.testing.assert_allclose(ht, hj, rtol=5e-4)
        for space in range(spaces):
            xj = sol(pj, space)
            np.testing.assert_allclose(sol(pt, space), xj, rtol=0,
                                       atol=2e-3 * np.abs(xj).max())
        if iters % 2:
            pt.zero_fill(st.SOL)
            st.reset()
            np.testing.assert_array_equal(hist_of(st.solve(iters - 1)),
                                          ht[:iters])


# -- BiCGStab with S2_gen: K5a and K5b on the band route ----------------------

@pytest.mark.parametrize("pieces", [1, 4])
def test_bicgstab_s2_gen_matches_jax(pieces, mesh4):
    """The fused BiCGStab runner with S2_gen in both packages, on one piece
    and on 4 (16-row pieces, the zero-halo passes with their edge
    fix-ups): the port's K5a-c take the band route there (their plain
    versions here, JAX's passes in interpret mode).  The history over BICG_ITERS iterations, before the f32
    recurrences part, rtol 3e-3 (test_23's), and x within 5e-3 of
    max|x|."""
    pj, opj = system(J, SHAPE, pieces, stencil=S2_GEN)
    pt, opt = system(T, SHAPE, pieces, stencil=S2_GEN)
    assert opj.supports_fused_bicgstab and opt.supports_fused_bicgstab
    v = opt._view
    for k5 in TS.BICG_PASSES:
        assert TS.route(v["offs"], v["vals"], v["C"], bicg=k5)[0] == "band"
    hj = hist_of(J.BiCGStabSolver(pj).solve(BICG_ITERS))
    ht = hist_of(T.BiCGStabSolver(pt).solve(BICG_ITERS))
    assert len(ht) == BICG_ITERS + 1 and np.isfinite(ht).all()
    np.testing.assert_allclose(ht, hj, rtol=3e-3)
    xj = sol(pj)
    np.testing.assert_allclose(sol(pt), xj, rtol=0,
                               atol=5e-3 * np.abs(xj).max())


BICG_ITERS = 8
