"""K1, K2 and K5b on the 1-D view's flat route: the launch geometry of the
march along the flat index (``csrc/flat1d.cu``), its Python mirror, the
routes, the entry points the wrappers launch and the gate of the
compile-time 1-D stencil.

No card is needed: the geometry is checked against a transcription of the
C formulas and the defines read from the source; the library itself is
held to the mirror when it loads (``build.load_library``) and by the card
tests in ``test_torch_kernels_cuda.py``.
"""

import pathlib
import re

import pytest
import torch

from legionsolvers_tpu_torch.entry import build_stencil_system
from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
from legionsolvers_tpu_torch.ops.cuda import stencil2d as T
from legionsolvers_tpu_torch.options import SolverOptions

LAP1 = ((0, -1, 1), (2.0, -1.0, -1.0))  # the 1-D Laplacian, flat shifts
# phase 4l's edge shapes and the full view, shapes one float4 past and one
# element short of a run of 16 segments, ragged and tall views
SHAPES = [(8, 128), (37, 1000), (3, 1000), (203, 4096), (4096, 4096),
          (513, 4), (23, 89), (4099, 130), (1, 5), (1024, 2048)]
CSRC = pathlib.Path(T.__file__).resolve().parents[2] / "csrc" / "flat1d.cu"


def _define(name, path=CSRC):
    return int(re.search(rf"#define {name} (\d+)", path.read_text()).group(1))


def _csrc_geometry(R, C, target):
    """``flat_geometry`` of csrc/flat1d.cu, transcribed line for line."""
    seg, min_segs = _define("LS_FLAT_SEG"), _define("LS_FLAT_MIN_SEGS")
    warps = _define("LS_STEP2_WARPS", CSRC.with_name("march2d.cuh"))
    n = R * C
    segs = (n + seg - 1) // seg
    run = (segs + target - 1) // target
    if run < min_segs:
        run = min_segs
    runs = (segs + run - 1) // run
    return segs, run, runs, (runs + warps - 1) // warps


@pytest.mark.parametrize("target", T.FLAT_TARGETS)
@pytest.mark.parametrize("shape", SHAPES)
def test_flat_geometry_covers_the_vector_once(shape, target):
    """The runs cover the n = R C elements of the view exactly once: whole
    segments of FLAT_SEG, runs of `run` segments but the last, one warp
    per run, the blocks' warps just enough."""
    n = shape[0] * shape[1]
    segs, run, runs, blocks = T.flat_geometry(*shape, target)
    assert segs * T.FLAT_SEG >= n > (segs - 1) * T.FLAT_SEG
    assert run >= T.FLAT_MIN_SEGS
    assert runs * run >= segs > (runs - 1) * run
    assert runs <= blocks * T.STEP2_WARPS < runs + T.STEP2_WARPS
    covered = torch.zeros(segs * T.FLAT_SEG, dtype=torch.int32)
    for w in range(runs):
        a, b = w * run, min(w * run + run, segs)
        covered[a * T.FLAT_SEG: b * T.FLAT_SEG] += 1
    assert bool((covered == 1).all())


@pytest.mark.parametrize("target", T.FLAT_TARGETS)
@pytest.mark.parametrize("n", [2048, 2052, 2047, 1 << 20, 1 << 24])
def test_flat_geometry_depends_on_the_shape_alone(n, target):
    """Every view of n elements gets the same runs, whatever its (R, C)
    and whatever card runs it: the Gram's sum order is a function of the
    shape."""
    views = [(R, n // R) for R in (1, 2, 4, 8, 16, 64, 4096) if n % R == 0]
    assert len(views) >= 1
    geos = {T.flat_geometry(R, C, target) for R, C in views}
    assert len(geos) == 1


@pytest.mark.parametrize("target", T.FLAT_TARGETS)
@pytest.mark.parametrize("shape", SHAPES)
def test_flat_geometry_mirrors_csrc(shape, target):
    """The Python mirror equals csrc/flat1d.cu's formulas at FLAT_EDGES,
    the full view and the edge shapes."""
    assert T.flat_geometry(*shape, target) == _csrc_geometry(*shape, target)


def test_flat_geometry_at_full_width():
    """At [4096, 4096] (2^24, `-dim 1`'s view): 131072 segments; K1's runs
    of 63 segments, 2081 warps in 521 blocks, K2's of 50, 2622 warps in
    656 blocks, and K5b's of 32, 4096 warps in 1024 blocks; two segments
    of each run read twice (3.2%, 4%, 6.3%)."""
    assert T.flat_geometry(4096, 4096, T.FLAT_STEP2_TARGET_WARPS) == (
        131072, 63, 2081, 521)
    assert T.flat_geometry(4096, 4096, T.FLAT_GRAM2_TARGET_WARPS) == (
        131072, 50, 2622, 656)
    assert T.flat_geometry(4096, 4096, T.FLAT_ST_TARGET_WARPS) == (
        131072, 32, 4096, 1024)


def test_flat_targets_and_orders_mirror_csrc():
    """FLAT_TARGETS is one wave of each flat kernel's resident blocks on
    132 SMs (LS_FLAT_*_MIN_BLOCKS: K1, K2, K5b), the constants mirror
    LS_FLAT_SEG and
    LS_FLAT_MIN_SEGS, and FLAT_SHIFTS the compiled 1-D stencil's shifts
    (LS_FLAT_SHIFTS), in its order."""
    warps = _define("LS_STEP2_WARPS", CSRC.with_name("march2d.cuh"))
    assert T.FLAT_TARGETS == tuple(
        132 * _define(f"LS_FLAT_{k}_MIN_BLOCKS") * warps
        for k in ("STEP2", "GRAM2", "ST"))
    assert (T.FLAT_SEG, T.FLAT_MIN_SEGS) == (_define("LS_FLAT_SEG"),
                                             _define("LS_FLAT_MIN_SEGS"))
    body = re.search(r"#define LS_FLAT_SHIFTS \{([-\d, ]+)\}",
                     CSRC.read_text()).group(1)
    assert tuple(int(v) for v in body.split(",")) == T.FLAT_SHIFTS


@pytest.mark.parametrize("C", [4, 89, 128, 1000, 4096])
def test_route_sends_the_1d_view_to_flat(C):
    """`route` sends the decomposed 1-D Laplacian to the flat route, for
    the one-pass kernels, for K1 and K2 (``sstep``) and for K5b alike, on
    the 1-D stencil in its order; the gate takes it."""
    offs, vals = T.decompose_flat_offsets(*LAP1, C)
    for sstep in (False, True, "step2", "gram2"):
        assert T.route(offs, vals, C, sstep=sstep) == (
            "flat", ((0, 0), (0, -1), (0, 1)), LAP1[1], 1)
    assert T.route(offs, vals, C, bicg="st") == (
        "flat", ((0, 0), (0, -1), (0, 1)), LAP1[1], 1)
    assert T.flat_refusal(offs, vals, C) is None
    assert T.step2_supported(8, C, offs, vals)


# 1-D stencils the flat route's K1 and K2 do not compile: another order,
# fewer terms, a repeated shift
REFUSED = {"order": ((-1, 0, 1), (-1.0, 2.0, -1.0)),
           "two terms": ((-1, 1), (-1.0, -1.0)),
           "repeat": ((0, -1, -1), (2.0, -0.5, -0.5))}


@pytest.mark.parametrize("stencil", list(REFUSED))
def test_gate_refuses_other_1d_stencils(stencil):
    """A flat decomposition whose 1-D stencil's shifts are not
    FLAT_SHIFTS is refused by K1's and K2's gate with a message naming the
    compiled stencil (on CPU tensors too, so both devices take one
    schedule), and the one-pass kernels keep the flat route."""
    C = 128
    offs, vals = T.decompose_flat_offsets(*REFUSED[stencil], C)
    assert T.route(offs, vals, C)[0] == "flat"
    # K5b's flat march compiles the same 1-D stencil: the band march
    assert T.route(offs, vals, C, bicg="st") == ("band", offs, vals, 0)
    assert T.step2_supported(8, C, offs)  # JAX's geometric gate
    assert not T.step2_supported(8, C, offs, vals)
    assert "LS_FLAT_SHIFTS" in T.flat_refusal(offs, vals, C)
    g = torch.Generator().manual_seed(3)
    x, r, p = (torch.randn(8, C, generator=g) for _ in range(3))
    kw = dict(offsets=offs, values=vals)
    with pytest.raises(ValueError, match="LS_FLAT_SHIFTS"):
        T.grid2d_cg_gram2(r, p, **kw)
    with pytest.raises(ValueError, match="LS_FLAT_SHIFTS"):
        T.grid2d_cg_step2(x, r, p, torch.ones(6), **kw)


def test_operator_takes_the_sstep_schedule_only_where_compiled():
    """The -dim 1 operator runs the s-step schedule on the 1-D Laplacian;
    with a 1-D stencil the flat K1 and K2 do not compile it runs the
    two-pass schedule, as `step2_eligible` says, on the same flat view."""
    f32 = SolverOptions(entry_dtype=torch.float32)
    lap = build_stencil_system(1, (8192,), f32, "cpu")
    op = lap.row_partitioned_matrices[0][0]
    assert op._view["flat"] and op.step2_eligible
    other = build_stencil_system(
        1, (8192,), f32, "cpu",
        stencil=[((-1,), -1.0), ((0,), 2.0), ((1,), -1.0)])
    op = other.row_partitioned_matrices[0][0]
    assert op._view["flat"] and not op.step2_eligible


@pytest.mark.parametrize("shape", SHAPES)
def test_strip_scratch_covers_the_flat_passes(shape):
    """K1's and K2's flat launches share the strip scratch: its capacity
    (one block per 4 strip units of 120 columns by 16 rows) holds ten
    partial sums for every block of either, whatever the view's shape."""
    capacity = T.strip_capacity(*shape)
    for target in T.FLAT_TARGETS:
        blocks = T.flat_geometry(*shape, target)[3]
        assert blocks <= capacity
        assert 10 * blocks <= T.STEP2_GRAM * capacity


def _record_launches(monkeypatch, calls):
    """Make the K5b wrapper take CPU tensors for CUDA ones and record the
    entry point it would launch, (pass, entry), in ``calls``, with the
    scratch from the CPU."""
    monkeypatch.setattr(TB, "_on_cuda", lambda *t: True)
    monkeypatch.setattr(TB, "_launch", lambda name, fn, args, dev:
                        calls.append((name, fn)))
    scratch = lambda dev, R, C: (torch.zeros(2 * R * C, dtype=torch.float64),
                                 R * C, torch.zeros(1, dtype=torch.int32))
    monkeypatch.setattr(TB, "_step2_scratch", scratch)
    monkeypatch.setattr(TB, "_pass_scratch", scratch)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("C", [4, 89, 1000, 4096])
def test_k5b_on_the_1d_view_launches_the_flat_march(C, compensated,
                                                     monkeypatch):
    """On a card, ``bicg_st`` on the 1-D view launches the march along the
    flat index (``ls_flat_bicg_st``), once, in either dot mode; a 1-D
    stencil it does not compile launches the band march; the cross keeps
    the strip march (the launches recorded, not run)."""
    calls = []
    _record_launches(monkeypatch, calls)
    r = v = torch.zeros(3, C)
    offs, vals = T.decompose_flat_offsets(*LAP1, C)
    TB.bicg_st(r, v, 0.5, offsets=offs, values=vals, compensated=compensated)
    assert calls == [("bicg_st", "ls_flat_bicg_st")]
    if C >= 89:
        offs, vals = T.decompose_flat_offsets(*REFUSED["order"], C)
        TB.bicg_st(r, v, 0.5, offsets=offs, values=vals,
                   compensated=compensated)
        assert calls[-1] == ("bicg_st", "ls_bicg_st_band")
    cross = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
    TB.bicg_st(r, v, 0.5, offsets=cross, values=(4.0,) + (-1.0,) * 4,
               compensated=compensated)
    assert calls[-1] == ("bicg_st", "ls_bicg_st_strip")


def test_flat_k5b_source_and_launch_bounds():
    """K5b's flat march in csrc/flat1d.cu: 8 blocks per SM (the strip
    K5b's), two segments in flight, its entry point taking the strip
    K5b's operands, and the strip K5b (csrc/bicgstab2d.cu) without its
    WRAP variant."""
    text = CSRC.read_text()
    assert _define("LS_FLAT_ST_MIN_BLOCKS") == 8
    assert _define("LS_FLAT_ST_DEPTH") == 2
    assert "int ls_flat_bicg_st(const float* r, const float* v," in text
    strip = CSRC.with_name("bicgstab2d.cu").read_text()
    assert "WRAP" not in strip and "int wrap" not in strip
