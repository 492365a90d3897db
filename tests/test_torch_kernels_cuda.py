"""The CUDA kernels against their plain versions, on the card.

Skips without an NVIDIA GPU.  Imports no jax, so that it runs on a machine
with the card and no JAX, as ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py`` (tests/conftest.py imports jax).
Tolerances are those of ``torch_stencil_cases.py``; the BiCGStab passes
use test_torch_bicgstab2d.py's (elementwise 2e-5 * max|ref|, dots rtol
2e-4), and their compensated dots must match the plain versions' float64
sums to 4e-7.  The 3-D passes (K6, K7) run at a ragged (37, 45, 130) and at
the edges of the reach-1 register march's tiles, chunks and 16-byte
vectors, with random halo planes, for the 7-point, 27-point, a ten-term
box and a reach-2 stencil: elementwise 2e-5 * max|ref|, dots 1e-4 of their
Cauchy-Schwarz scale sqrt(<a,a><b,b>) (chip_smoke.py's bounds); compensated
K7 dots (pv, st, update) within 4e-7 of the float64 sum of their f32
operands; the passes that fold their dots into the last block repeat bit
for bit, also with two shapes alternating on one stream.  Some tests need
no card: the shared 3-D scratch's room, and the K6b and K7 st and update
wrappers running their plain versions on CPU tensors.  K12 must match
its plain version bit for bit, also on an offset view, which takes the
scalar kernel.  The
explicit-sparse kernels K8, K9 and K10 round every product and sum as their
plain versions do, so they must match them bit for bit (K8's dot: 1e-5 of
its Cauchy-Schwarz scale).  K1 (step2) is also held at the edges of its
column strips, row chunks and 16-byte vectors, with the cross and a
9-point stencil, to chip_smoke.py's phase 3 bounds (elementwise 1e-5 *
max|ref|, Gram entries 1e-4 of their Cauchy-Schwarz scale), and must
repeat bit for bit; K10 at the interface's caps.  K5b (bicg_st, both dot
modes, with a reach-2 stencil too) and K2 (gram2) are held at the same
edges to the same bounds, and must repeat bit for bit, and so must K3 (its
four modes) and K4 (xpay_pq), with null and random halo blocks; the strip
scratch's room and the K5b, K2, K3 and K4 wrappers on CPU tensors need no
card.  A 2-D s-step solve(40) and a two-pass solve(40) on the card are held
entry by entry against the same schedules driven by the plain versions, the
two-pass one also to a bit-identical repeat.  The block runners on two
identical spaces launch every kernel twice as often as one space and give
exactly twice its history and its x in every space.  Pieces: K1 and K2 on
row-block views of a grid (non-zero storage offsets, as the pieces of a
mesh are) against their plain versions on the same views (K1's phase 3
bounds), leaving the rows outside the view alone; and a 4-piece s-step
solve(40) on the card against the same 4-piece runner driven by the plain
versions, entry by entry to rtol 1e-3 (phase 4's kernel-against-plain
bound) and x to 1e-3 of max|x|.  3-D pieces: K6a and K6b on each piece of
a 4-piece volume with the halo planes that the operator copies out of the
neighbours, against their plain versions (the 3-D bounds above), and the
4-piece 3-D CG solve(20) against the same runner driven by the plain
versions (rtol 1e-3, x 1e-3 of max|x|).  The fused 2-D BiCGStab on 4
pieces, f32 and compensated dots, one and two iterations against the
plain-driven runner and two against one piece (rtol 1e-4, x 1e-4 of
max|x|), K5a-c launched once per piece per iteration.  The 1-D view
(``-k "flat or cross_unchanged"``): K1 and K2 on the march along the flat
index (``csrc/flat1d.cu``) at views whose length falls one float4 past and
one element short of a run, their registers, spill and residency, and the
2-D cross's K1 and K2 at 4096^2 (the strip march without its WRAP
branch) under phase 3's bounds.  Wide z shifts
(``-k "wide3d or window or nop"``): K6a's four modes, K6b and K7 with the
wide-z stencil (|oz| up to 128) and the reach-2 star at Z not a multiple
of 128, X = 1, Y < 8 and |oz| = Z - 1, against their plain versions (the
3-D bounds above) and bit for bit on a repeat, each pass one window-march
kernel (a profiler trace); its CG solve(20) on 1 and 4 pieces with exact
launches against the plain-driven runner (rtol 1e-3); every window-march
kernel's registers at the largest window the gate allows, and with S_wide
at 256^3 no spill and at least 2 blocks per SM; K1's nop mode bit for bit
its plain version (g[0] within 1e-5 of its Cauchy-Schwarz scale).  The band route of K3 (four modes) and K4
(``-k band``): S2_gen, S2_4x, phase 4l's wide stencil and the 1-D view of
a 5-point 1-D stencil at phase 4l's edge shapes, a grid shorter than the
ring, widths under one strip, two strips, ragged bands, C % 4 != 0 and
4096^2, with null and random halo blocks, to phase 3's bounds, one launch
(one kernel, no reduce_partials, in a profiler trace), a repeat bit for
bit; a stencil past its gate on the tile kernels; its registers and
residency and the library's geometry and gate against the Python mirror;
and the two-pass CG solve(40) with S2_gen on one and 4 pieces against the
plain-driven runner (rtol 1e-3, x 1e-3 of max|x|).
"""

import numpy as np
import pytest
import torch

from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
from legionsolvers_tpu_torch.ops.cuda import bicgstab3d as TB3
from legionsolvers_tpu_torch.ops.cuda import stencil2d as T
from legionsolvers_tpu_torch.ops.cuda import stencil3d as T3
from torch_stencil_cases import (KW, MODES, compare, gram_bounds,
                                 make_inputs, run_port)

torch.set_num_threads(2)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (200, 328)])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_on_card(mode, shape, cuda_device):
    """Each CUDA kernel against its plain version on the same card."""
    T.reset_launch_counts()
    d = make_inputs(shape, seed=5)
    got = {k: v.cpu().numpy() for k, v in
           run_port(mode, d, device=cuda_device).items()}
    assert sum(T.LAUNCHES.values()) == 1
    ref = {k: v.numpy() for k, v in run_port(mode, d).items()}
    compare(got, ref, d, mode)



def _bicg(kernel, d, device, compensated, plain=False, stencil=KW):
    """One K5 pass on copies of ``d`` on ``device``: the wrapper, or with
    ``plain`` its plain version."""
    t = {k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()}
    kw = dict(stencil, compensated=compensated)
    fn = getattr(TB, f"bicg_{kernel}_plain" if plain else f"bicg_{kernel}")
    if kernel == "pv":
        out = fn(t["r"], t["p"], t["v"], t["rt"], 0.37, 0.41, **kw)
        names = ("p", "v", "rtv")
    elif kernel == "st":
        out = fn(t["r"], t["v"], 0.83, **kw)
        names = ("ts", "tt")
    else:
        out = fn(t["r"], t["v"], t["x"], t["p"], t["rt"], 0.83, 0.41, **kw)
        names = ("x", "r", "rr", "rtr")
    return {k: v.double().cpu().numpy() for k, v in zip(names, out)}


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("shape", [(64, 128), (200, 328)])
@pytest.mark.parametrize("kernel", ["pv", "st", "update"])
def test_bicgstab_kernel_matches_plain_on_card(kernel, shape, compensated,
                                               cuda_device):
    """K5 against its plain version on the same card."""
    rng = np.random.default_rng(9)
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p", "v", "rt")}
    T.reset_launch_counts()
    got = _bicg(kernel, d, cuda_device, compensated)
    assert dict(T.LAUNCHES) == {f"bicg_{kernel}": 1}
    ref = _bicg(kernel, d, cuda_device, compensated, plain=True)
    for key, want in ref.items():
        if want.ndim:
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=2e-5 * np.abs(want).max(),
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want, rtol=2e-4,
                                       atol=1e-2 if key == "rtr" else 0,
                                       err_msg=key)
    if compensated and kernel != "st":
        vec = got["v"] if kernel == "pv" else got["r"]
        rt = d["rt"].astype(np.float64)
        exact = ({"rtv": (rt * vec).sum()} if kernel == "pv" else
                 {"rr": (vec * vec).sum(), "rtr": (rt * vec).sum()})
        for key, want in exact.items():
            assert abs(got[key] - want) <= 4e-7 * abs(want), key


# ---------------------------------------------------------------------------
# 3-D: K6a, K6b, K7
# ---------------------------------------------------------------------------

SHAPE3 = (37, 45, 130)
# The reach-1 register march (march1: 16 x 128 (y, z) tiles, x chunks of
# at least 8 planes, 16-byte vectors where Z % 4 == 0) at its edges: Z % 4
# in {1, 2, 3} (scalar loads), a second z tile holding one vector, X shorter
# than one chunk and X = 1, Y and Z below one tile.
SHAPES3 = [SHAPE3, (40, 50, 260), (6, 20, 129), (1, 9, 131), (20, 15, 60)]
# Stencils: the 7-point star (-dim 3) and 27-point box (-dim 4) of the
# solves; ten terms of the box with random weights (the box path with zero
# weights); the 11-point star with arms of 2 in y and z (reach 2: the
# window march).
STENCILS3 = [3, 4, "box10", "reach2"]
# The wide-z stencil (the window march holds its z shifts): the 7-point
# cross with center 8.5, (0, 0, +-12) with -0.5, (0, +-3, +-100) and
# (+-1, 0, +-128) with -0.25.
WIDE3 = [((0, 0, 0), 8.5), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
         ((0, -1, 0), -1.0), ((0, 1, 0), -1.0), ((0, 0, -1), -1.0),
         ((0, 0, 1), -1.0), ((0, 0, -12), -0.5), ((0, 0, 12), -0.5),
         ((0, 3, 100), -0.25), ((0, -3, -100), -0.25), ((0, 3, -100), -0.25),
         ((0, -3, 100), -0.25), ((1, 0, 128), -0.25), ((-1, 0, -128), -0.25)]
# Its edges: Z not a multiple of 128 (and Z % 4 != 0), X = 1 and Y < 8,
# |oz| = Z - 1 (Z = 129), 17 planes (window chunks of 4, 4, 4, 4 and 1).
WIDE3_SHAPES = [(37, 45, 130), (1, 5, 301), (20, 7, 129), (17, 9, 256)]


def _kw3(dim):
    import legionsolvers_tpu_torch as lt

    if dim == "box10":
        rng = np.random.default_rng(10)
        box = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
               for c in (-1, 0, 1)]
        pick = rng.choice(len(box), 10, replace=False)
        return dict(offsets=tuple(box[k] for k in pick),
                    values=tuple(float(v) for v in rng.uniform(-1, 1, 10)))
    if dim == "wide":
        return dict(offsets=tuple(o for o, _ in WIDE3),
                    values=tuple(v for _, v in WIDE3))
    if dim == "reach2":
        offs = [(0, 0, 0), (-1, 0, 0), (1, 0, 0)]
        vals = [7.5, -1.0, -1.0]
        for k in (1, 2):
            for o in (-k, k):
                offs += [(0, o, 0), (0, 0, o)]
                vals += [-4.0 / 3.0 if k == 1 else 1.0 / 12.0] * 2
        return dict(offsets=tuple(offs), values=tuple(vals))
    stencil = lt.laplacian_stencil(dim)
    return dict(offsets=tuple(o for o, _ in stencil),
                values=tuple(v for _, v in stencil))


def _state3d(seed, shape=SHAPE3):
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p", "v", "rt")}
    for k in ("top", "bot"):
        d[k] = rng.standard_normal(shape[1:]).astype(np.float32)
    return d


def _tensors(d, device):
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in d.items()}


def _stencil3d(mode, d, device, dim, plain=False):
    """One K6 pass on copies of ``d``: the wrapper, or its plain version."""
    t, kw = _tensors(d, device), _kw3(dim)
    h = (t["top"], t["bot"])
    if mode == "xpay_pq":
        fn = T3.xpay_pq3d_plain if plain else T3.grid3d_cg_xpay_pq
        out, names = fn(t["r"], t["p"], 0.37, *h, **kw), ("p", "dot")
    else:
        src = t["p"] if mode in ("pq", "update") else t["x"]
        extra = (t["x"], t["r"], 0.3) if mode == "update" else ()
        if plain:
            out = T3.stencil3d_plain(mode, src, *h, extra, **kw)
        elif mode == "update":
            out = T3.grid3d_cg_update(src, *extra, *h, **kw)
        elif mode == "pq":
            out = (T3.grid3d_cg_pq(src, *h, **kw),)
        else:
            out = T3.grid3d_stencil_matvec(src, *h, with_dot=mode == "y_dot",
                                           **kw)
            out = out if mode == "y_dot" else (out,)
        names = {"y": ("y",), "y_dot": ("y", "dot"), "pq": ("dot",),
                 "update": ("x", "r", "dot")}[mode]
    return {k: v.double().cpu().numpy() for k, v in zip(names, out)}


def _bicg3d(kernel, d, device, dim, compensated, plain=False):
    """One K7 pass on copies of ``d``: the wrapper, or its plain version."""
    t, kw = _tensors(d, device), dict(_kw3(dim), compensated=compensated)
    h = (t["top"], t["bot"])
    fn = getattr(TB3, f"bicg3d_{kernel}" + ("_plain" if plain else ""))
    if kernel == "pv":
        out = fn(t["r"], t["p"], t["v"], t["rt"], 0.37, 0.41, *h, **kw)
        names = ("p", "v", "rtv")
    elif kernel == "st":
        out, names = fn(t["r"], t["v"], 0.83, *h, **kw), ("ts", "tt")
    else:
        out = fn(t["r"], t["v"], t["x"], t["p"], t["rt"], 0.83, 0.41, *h,
                 **kw)
        names = ("x", "r", "rr", "rtr")
    return {k: v.double().cpu().numpy() for k, v in zip(names, out)}


def _compare3d(got, ref, dot_scale):
    """Arrays to 2e-5 * max|ref|; dots to 1e-4 of ``dot_scale``, a bound on
    sqrt(<a,a><b,b>) of their operands."""
    for key, want in ref.items():
        if want.ndim:
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=2e-5 * np.abs(want).max(),
                                       err_msg=key)
        else:
            assert abs(got[key] - want) <= 1e-4 * dot_scale, key


def _norm_bound(d, *arrays):
    """||a|| ||b|| bound for dots over the inputs and outputs: the largest
    norm among them, squared, times the stencils' norm bound (< 26)."""
    n = max(np.linalg.norm(np.asarray(a, np.float64)) for a in
            (*(d[k] for k in ("x", "r", "p", "v", "rt")), *arrays))
    return 26.0 * n * n


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES3)
@pytest.mark.parametrize("dim", STENCILS3)
@pytest.mark.parametrize("mode", ["y", "y_dot", "pq", "update", "xpay_pq"])
def test_stencil3d_kernel_matches_plain_on_card(mode, dim, shape,
                                                cuda_device):
    """K6a (four modes) and K6b against their plain versions on the card,
    at ragged shapes and march1's edges, with random halo planes."""
    d = _state3d(13, shape)
    T.reset_launch_counts()
    got = _stencil3d(mode, d, cuda_device, dim)
    assert dict(T.LAUNCHES) == {f"{mode}3d": 1}
    ref = _stencil3d(mode, d, cuda_device, dim, plain=True)
    arrays = [v for v in ref.values() if v.ndim]
    _compare3d(got, ref, _norm_bound(d, *arrays))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES3)
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("dim", STENCILS3)
@pytest.mark.parametrize("kernel", ["pv", "st", "update"])
def test_bicgstab3d_kernel_matches_plain_on_card(kernel, dim, compensated,
                                                 shape, cuda_device):
    """K7 against its plain versions on the card, with halo planes, at
    ragged shapes and march1's edges; compensated pv's and st's dots within
    4e-7 of the float64 sum of their f32 operands (st's s = r - alpha v and
    t = A s formed in f32 by the plain version on the card)."""
    d = _state3d(17, shape)
    T.reset_launch_counts()
    got = _bicg3d(kernel, d, cuda_device, dim, compensated)
    assert dict(T.LAUNCHES) == {f"bicg3d_{kernel}": 1}
    ref = _bicg3d(kernel, d, cuda_device, dim, compensated, plain=True)
    arrays = [v for v in ref.values() if v.ndim]
    _compare3d(got, ref, 26.0 * _norm_bound(d, *arrays))
    if compensated and kernel == "pv":
        exact = (d["rt"].astype(np.float64) * got["v"]).sum()
        assert abs(got["rtv"] - exact) <= 4e-7 * abs(exact)
    if compensated and kernel == "st":
        t, kw = _tensors(d, cuda_device), _kw3(dim)
        s = t["r"] - torch.tensor(0.83, device=cuda_device) * t["v"]
        tv = T3.apply_planes_plain(s, kw["offsets"], kw["values"], t["top"],
                                   t["bot"])
        s, tv = s.double().cpu().numpy(), tv.double().cpu().numpy()
        for key, exact in (("ts", (tv * s).sum()), ("tt", (tv * tv).sum())):
            assert abs(got[key] - exact) <= 4e-7 * abs(exact), key
    if compensated and kernel == "update":
        rn, rt = got["r"], d["rt"].astype(np.float64)
        for key, exact in (("rr", (rn * rn).sum()), ("rtr", (rt * rn).sum())):
            assert abs(got[key] - exact) <= 4e-7 * abs(exact), key


def _march1_passes(device, shape, dim, seed):
    """Closures for the passes that fold their dots into march1's last
    block (K6a's modes with a dot, K6b, K7 pv and st with f32 and
    compensated dots, K7 update with f32 dots) on fixed inputs; each
    returns its outputs as one flat float32 tensor."""
    t, kw = _tensors(_state3d(seed, shape), device), _kw3(dim)
    h = (t["top"], t["bot"])
    outs = (torch.empty_like(t["p"]), torch.empty_like(t["v"]))

    def update():
        x, r = t["x"].clone(), t["r"].clone()
        return T3.grid3d_cg_update(t["p"], x, r, 0.3, *h, **kw)

    def pv(comp):
        return lambda: TB3.bicg3d_pv(t["r"], t["p"], t["v"], t["rt"], 0.37,
                                     0.41, *h, compensated=comp, out=outs,
                                     **kw)

    def st(comp):
        return lambda: TB3.bicg3d_st(t["r"], t["v"], 0.83, *h,
                                     compensated=comp, **kw)

    def bicg_update():
        x = t["x"].clone()
        return TB3.bicg3d_update(t["r"], t["v"], x, t["p"], t["rt"], 0.83,
                                 0.41, *h, out=outs[1], **kw)

    fns = {"y_dot": lambda: T3.grid3d_stencil_matvec(t["x"], *h,
                                                     with_dot=True, **kw),
           "pq": lambda: (T3.grid3d_cg_pq(t["p"], *h, **kw),),
           "update": update,
           "xpay_pq": lambda: T3.grid3d_cg_xpay_pq(t["r"], t["p"], 0.37, *h,
                                                   out=outs[0], **kw),
           "pv": pv(False), "pv_comp": pv(True),
           "st": st(False), "st_comp": st(True),
           "bicg_update": bicg_update}
    flat = lambda res: torch.cat([a.reshape(-1).clone() for a in res])
    return {k: (lambda f=f: flat(f())) for k, f in fns.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 4])
def test_march1_repeats_bit_for_bit_on_card(dim, cuda_device):
    """Launches in a row on one stream, and two shapes alternating, give
    the same bits: the last block's counter is back at zero after each
    launch, and the geometry (so the dots' sum order) depends on the shape
    alone."""
    a = _march1_passes(cuda_device, (64, 64, 256), dim, 3)
    b = _march1_passes(cuda_device, SHAPE3, dim, 4)
    for name in a:
        first = [a[name](), a[name](), b[name](), a[name](), b[name]()]
        torch.cuda.synchronize()
        for i, j in ((0, 1), (0, 3), (2, 4)):
            assert torch.equal(first[i].view(torch.int32),
                               first[j].view(torch.int32)), (name, i, j)


@pytest.mark.cuda
def test_march1_geometry_and_residency_on_card(cuda_device):
    """The library's march1 block counts equal the Python mirror's, and
    every march1 variant fits two blocks per SM (its launch bounds)."""
    import ctypes

    from legionsolvers_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    for shape in [(256, 256, 256), (512, 512, 512), *SHAPES3, (1, 1, 1)]:
        assert lib.ls_march1_blocks(*shape) == \
            T3.march1_geometry(*shape)[2], shape
    out = (ctypes.c_int * 3)()
    for fn, n in (("ls_stencil3d_m1_attrs", 16),
                  ("ls_xpay_pq3d_m1_attrs", 4),
                  ("ls_bicg3d_pv_m1_attrs", 8),
                  ("ls_bicg3d_st_m1_attrs", 8),
                  ("ls_bicg3d_update_m1_attrs", 4)):
        for which in range(n):
            assert getattr(lib, fn)(which, out) == 0, (fn, which)
            assert out[2] >= 2, (fn, which, list(out))


@pytest.mark.parametrize("shape", [(256, 256, 256), SHAPE3, (1, 1, 1)])
def test_march_scratch_has_room_for_two_dots(shape):
    """The shared 3-D scratch holds two partial dots (K7 st's and update's)
    for every block of any march's launch (no card needed)."""
    capacity = T3.march_scratch_size(*shape)
    entries = T3.march_scratch_entries(*shape)
    for blocks in (T3.blocks3d(*shape), T3.window3d_geometry(*shape)[2],
                   T3.march1_geometry(*shape)[2]):
        assert blocks <= capacity and 2 * blocks <= entries


@pytest.mark.parametrize("dim", STENCILS3)
def test_xpay_pq_and_st_run_plain_on_cpu(dim):
    """On CPU tensors the K6b and K7 st wrappers return their plain
    versions' results exactly and launch nothing (no card needed)."""
    d = _state3d(19, (6, 20, 129))
    T.reset_launch_counts()
    pairs = [(_stencil3d("xpay_pq", d, "cpu", dim),
              _stencil3d("xpay_pq", d, "cpu", dim, plain=True))]
    pairs += [(_bicg3d("st", d, "cpu", dim, comp),
               _bicg3d("st", d, "cpu", dim, comp, plain=True))
              for comp in (False, True)]
    for got, want in pairs:
        assert got.keys() == want.keys()
        for key in want:
            assert np.array_equal(got[key], want[key]), key
    assert sum(T.LAUNCHES.values()) == 0


@pytest.mark.parametrize("shape", [(512, 512, 512), (999, 17, 5),
                                   (6, 20, 129), (1, 9, 131)])
def test_march_scratch_covers_update_on_march1(shape):
    """K7 update's march1 launch (two partial dots per block, the
    last-block counter) fits the shared scratch's capacity and entries at
    shapes with many, few and single-plane chunks (no card needed)."""
    tiles, chunk, blocks = T3.march1_geometry(*shape)
    assert blocks == tiles * -(-shape[0] // chunk)
    assert blocks <= T3.march_scratch_size(*shape)
    assert 2 * blocks <= T3.march_scratch_entries(*shape)


@pytest.mark.parametrize("dim", STENCILS3)
def test_update_runs_plain_on_cpu(dim):
    """On CPU tensors the K7 update wrapper returns its plain version's
    results exactly (x updated in place) and launches nothing (no card
    needed)."""
    d = _state3d(23, (6, 20, 129))
    T.reset_launch_counts()
    for comp in (False, True):
        got = _bicg3d("update", d, "cpu", dim, comp)
        want = _bicg3d("update", d, "cpu", dim, comp, plain=True)
        assert got.keys() == want.keys()
        for key in want:
            assert np.array_equal(got[key], want[key]), key
    assert sum(T.LAUNCHES.values()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16384, 4096), (200, 328), (1000003,)])
def test_k12_matches_plain_on_card(shape, cuda_device):
    """K12's float4 body, with the scalar rest where n % 4 != 0, bit for
    bit with the plain version; an offset view (unaligned) takes the scalar
    kernel alone and matches too."""
    from legionsolvers_tpu_torch.ops.cuda import copy_probe as K12

    g = torch.Generator(cuda_device).manual_seed(13)
    x = torch.randn(shape, generator=g, device=cuda_device)
    T.reset_launch_counts()
    assert torch.equal(K12.copy_probe(x), K12.copy_plain(x))
    flat = torch.randn(x.numel() + 1, generator=g, device=cuda_device)
    view, out = flat[1:], torch.empty(x.numel(), device=cuda_device)
    assert K12.copy_split(view.data_ptr(), out.data_ptr(), view.numel()) == 0
    assert torch.equal(K12.copy_probe(view, out=out),
                       K12.copy_plain(view))
    torch.cuda.synchronize()
    assert dict(T.LAUNCHES) == {"copy_probe": 2}


# ---------------------------------------------------------------------------
# the explicit-sparse path: K8, K9, K10 (bit for bit: the kernels round
# every product and sum as the plain versions do; K8's dot 1e-5 relative)
# ---------------------------------------------------------------------------

from legionsolvers_tpu_torch.ops.cuda import dia2d as TD  # noqa: E402
from legionsolvers_tpu_torch.ops.cuda import rowperm as TR  # noqa: E402
from legionsolvers_tpu_torch.ops.cuda import winell as TW  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("with_dot", [False, True])
@pytest.mark.parametrize("shape,offsets", [
    ((64, 128), ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))),
    ((200, 328), ((-8, 3), (0, 0), (2, -200), (5, 130), (8, -1))),
])
def test_k8_matches_plain_on_card(shape, offsets, with_dot, cuda_device):
    rng = np.random.default_rng(3)
    R, C = shape
    t = lambda a: torch.as_tensor(a.astype(np.float32), device=cuda_device)
    x, top, bot = (t(rng.standard_normal(s)) for s in (shape, (8, C), (8, C)))
    diags = t(rng.standard_normal((len(offsets), R, C)))
    T.reset_launch_counts()
    got = TD.dia2d_matvec(x, top, bot, diags, offsets=offsets,
                          with_dot=with_dot)
    assert dict(T.LAUNCHES) == {"dia2d_dot" if with_dot else "dia2d": 1}
    want = TD.dia2d_plain(x, top, bot, diags, offsets=offsets,
                          with_dot=with_dot)
    if with_dot:
        (got, gdot), (want, wdot) = got, want
        assert abs(gdot.item() - wdot.item()) <= 1e-5 * (
            x.double().norm() * want.double().norm()).item()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k9_matches_plain_on_card(dtype, cuda_device):
    from legionsolvers_tpu_torch.parallel.winell_op import plan_winell

    rng = np.random.default_rng(4)
    n, bw = 50000, 600
    rows = rng.integers(0, n, 7 * n)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, 7 * n), 0, n - 1)
    vals = rng.uniform(-1, 1, 7 * n)
    npd = np.float32 if dtype == torch.float32 else np.float64
    plan = plan_winell(rows, cols, vals, n, n, npd)
    dev = lambda a: torch.as_tensor(a, device=cuda_device)
    x = torch.randn(plan["N"] // 128, 128, dtype=dtype, device=cuda_device)
    args = (x, dev(plan["wstart"]), dev(plan["cols"]), dev(plan["vals"]))
    T.reset_launch_counts()
    got = TW.winell_spmv(*args, window_rows=plan["window_rows"])
    assert dict(T.LAUNCHES) == {"winell": 1}
    assert torch.equal(got, TW.winell_plain(
        *args, window_rows=plan["window_rows"]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("geometry", [(192, 8, 1, 1), (8, 8, 1, 1),
                                      (8, 24, 3, 3), (8, 56, 7, 7)])
def test_k10_matches_plain_on_card(geometry, dtype, cuda_device):
    """Hop geometries (block_rows, src_block_rows, row step, w_rows) of the
    routed gather, scaled and not."""
    br, srb, step, w = geometry
    tab = tuple((dl // (br // 8)) * step for dl in range(br))
    RD = br * 5
    g = torch.Generator(device=cuda_device).manual_seed(7)
    src = torch.randn(5 * srb * 1024, generator=g, dtype=dtype,
                      device=cuda_device)
    idx = torch.randint(0, w * 1024, (RD, 1024), generator=g,
                        dtype=torch.int32, device=cuda_device)
    vals = torch.randn(RD, 1024, generator=g, dtype=dtype,
                       device=cuda_device)
    kw = dict(block_rows=br, src_block_rows=srb, w0_table=tab, w_rows=w)
    for v in (None, vals):
        T.reset_launch_counts()
        got = TR.blockperm_gather(src, idx, v, **kw)
        assert dict(T.LAUNCHES) == {"blockperm": 1}
        assert torch.equal(got, TR.blockperm_plain(src, idx, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("run", [1, 256])
def test_k10_caps_match_plain_on_card(run, dtype, cuda_device):
    """K10 at block_rows 256, src_block_rows 64, w_rows 8: one run of 256
    rows (the window staged in shared memory, 64 KB in f64) or runs of
    one row (gathered from global memory), scaled and not."""
    br, srb, w = TR.MAX_BLOCK_ROWS, TR.MAX_SRC_ROWS, TR.MAX_W_ROWS
    tab = ((srb - w,) * br if run == br else
           tuple((7 * dl) % (srb - w + 1) for dl in range(br)))
    hop = TR.GatherHop(br, srb, tab, w, cuda_device)
    assert hop.stage == (run == br)
    g = torch.Generator(device=cuda_device).manual_seed(11)
    src = torch.randn(3 * srb * 1024, generator=g, dtype=dtype,
                      device=cuda_device)
    idx = torch.randint(0, w * 1024, (3 * br, 1024), generator=g,
                        dtype=torch.int32, device=cuda_device)
    vals = torch.randn(3 * br, 1024, generator=g, dtype=dtype,
                       device=cuda_device)
    for v in (None, vals):
        T.reset_launch_counts()
        got = TR.gather_hop(hop, src, idx, v)
        assert dict(T.LAUNCHES) == {"blockperm": 1}
        assert torch.equal(got, TR.blockperm_plain(src, idx, v,
                                                   **hop.kwargs()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k10_takes_unaligned_views_on_card(dtype, cuda_device):
    """Views at an odd element offset (not 16-byte aligned) give the plain
    version's result: the wrapper copies them for the kernel's vectors."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    kw = dict(block_rows=8, src_block_rows=8, w0_table=tuple(range(8)),
              w_rows=1)
    src = torch.randn(4 * 8 * 1024 + 1, generator=g, dtype=dtype,
                      device=cuda_device)[1:]
    idx = torch.randint(0, 1024, (32 * 1024 + 1,), generator=g,
                        dtype=torch.int32, device=cuda_device)[1:]
    vals = torch.randn(32 * 1024 + 1, generator=g, dtype=dtype,
                       device=cuda_device)[1:]
    idx, vals = idx.view(32, 1024), vals.view(32, 1024)
    assert src.data_ptr() % 16 and idx.data_ptr() % 16
    for v in (None, vals):
        assert torch.equal(TR.blockperm_gather(src, idx, v, **kw),
                           TR.blockperm_plain(src, idx, v, **kw))


OFFS9 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1),
         (1, -1), (1, 1))
VALS9 = (6.0, -1.0, -1.0, -1.0, -1.0, -0.5, -0.5, -0.5, -0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("stencil", ["cross", "9-point"])
@pytest.mark.parametrize("shape", [(200, 328), (33, 4097), (4099, 130),
                                   (1, 5), (96, 132)])
def test_k1_edges_match_plain_on_card(shape, stencil, cuda_device):
    """K1 across its strip, row-chunk and vector edges against step2_plain
    on the same card, and a bit-identical repeat."""
    offs, vals = (KW["offsets"], KW["values"]) if stencil == "cross" else (
        OFFS9, VALS9)
    rng = np.random.default_rng(13)
    d = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(cuda_device) for k in ("x", "r", "p")}
    coef = T.cg2_coeffs(T.gram2_plain(d["r"], d["p"], offsets=offs,
                                      values=vals))[0]
    T.reset_launch_counts()
    runs = []
    for fn in (T.grid2d_cg_step2, T.grid2d_cg_step2, T.step2_plain):
        c = {k: v.clone() for k, v in d.items()}
        runs.append([t.cpu() for t in fn(c["x"], c["r"], c["p"], coef,
                                         offsets=offs, values=vals)])
    assert dict(T.LAUNCHES) == {"step2": 2}
    k1, k2, ref = runs
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    for have, want in zip(k1[:3], ref[:3]):
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    bound = gram_bounds(ref[1].numpy(), ref[2].numpy(), offs, vals)
    np.testing.assert_array_less(
        np.abs(k1[3].double().numpy() - ref[3].double().numpy()),
        1e-4 * bound)


@pytest.mark.cuda
def test_sstep_history_on_card(cuda_device):
    """A 2-D s-step solve(40) on the card (K1 x 20, K2 x 2) against the same
    schedule driven by the plain versions on the card, entry by entry: each
    K1 pass returns a fresh Gram vector, whose g[0] the history keeps."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_system

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    hists = []
    for plain in (False, True):
        planner = build_system(256, f32, cuda_device)
        solver = lt.CGSolver(planner)
        saved = (T.grid2d_cg_step2, T.grid2d_cg_gram2)
        if plain:
            T.grid2d_cg_step2, T.grid2d_cg_gram2 = T.step2_plain, T.gram2_plain
        T.reset_launch_counts()
        try:
            hists.append(solver.solve(40).cpu().double().numpy())
        finally:
            T.grid2d_cg_step2, T.grid2d_cg_gram2 = saved
        assert dict(T.LAUNCHES) == ({} if plain else
                                    {"step2": 20, "gram2": 2})
    kernel, plain = hists
    assert len(kernel) == 41 and len(np.unique(kernel)) == 41
    np.testing.assert_allclose(kernel, plain, rtol=1e-3)



# K5b (bicg_st) and K2 (gram2) on the column-strip march: K1's edge shapes
# (strips of 120 output columns, row chunks, 16-byte vectors where C % 4
# == 0), the cross, the 9-point stencil (the switch path) and, for K5b, a
# reach-2 stencil (the band route)
STRIP_SHAPES = [(200, 328), (33, 4097), (4099, 130), (1, 5), (96, 132)]
OFFS_R2 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-2, 0), (2, 0),
           (0, -2), (0, 2))
VALS_R2 = (5.0, -1.0, -1.0, -1.0, -1.0, -0.25, -0.25, -0.25, -0.25)
STENCILS2 = {"cross": (KW["offsets"], KW["values"]), "9-point": (OFFS9, VALS9),
             "reach2": (OFFS_R2, VALS_R2)}


def _st_case(shape, stencil, compensated, device, seed=17):
    """K5b twice and its plain version on the same inputs: (the two kernel
    runs, the plain run, the dots' Cauchy-Schwarz scales), float64."""
    offs, vals = STENCILS2[stencil]
    rng = np.random.default_rng(seed)
    r, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(device) for _ in range(2))
    kw = dict(offsets=offs, values=vals, compensated=compensated)
    runs = [torch.stack(fn(r, v, 0.83, **kw)).double().cpu()
            for fn in (TB.bicg_st, TB.bicg_st, TB.bicg_st_plain)]
    s = r - torch.tensor(0.83, device=device) * v
    t = T.apply_plain(s, offs, vals)
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    return runs, torch.tensor([nrm(t) * nrm(s), nrm(t) ** 2],
                              dtype=torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("stencil", list(STENCILS2))
@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_k5b_edges_match_plain_on_card(shape, stencil, compensated,
                                       cuda_device):
    """K5b across the strip march's edges (reach 1) and on the band route
    (reach 2) against bicg_st_plain on the same card, to chip_smoke.py's
    phase 3 bound (1e-4 of each dot's Cauchy-Schwarz scale), and a repeat
    bit for bit."""
    T.reset_launch_counts()
    (k1, k2, ref), scale = _st_case(shape, stencil, compensated, cuda_device)
    assert dict(T.LAUNCHES) == {"bicg_st": 2}
    assert torch.equal(k1, k2)
    assert bool(((k1 - ref).abs() <= 1e-4 * scale).all()), (k1, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("stencil", ["cross", "9-point"])
@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_k2_edges_match_plain_on_card(shape, stencil, cuda_device):
    """K2 across the strip march's edges against gram2_plain on the same
    card (Gram entries to 1e-4 of their Cauchy-Schwarz scale), and a
    repeat bit for bit."""
    offs, vals = STENCILS2[stencil]
    rng = np.random.default_rng(19)
    r, p = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    rt, pt = (torch.from_numpy(a).to(cuda_device) for a in (r, p))
    T.reset_launch_counts()
    g1, g2, ref = (fn(rt, pt, offsets=offs, values=vals).double().cpu()
                   for fn in (T.grid2d_cg_gram2, T.grid2d_cg_gram2,
                              T.gram2_plain))
    assert dict(T.LAUNCHES) == {"gram2": 2}
    assert torch.equal(g1, g2)
    np.testing.assert_array_less(np.abs((g1 - ref).numpy()),
                                 1e-4 * gram_bounds(r, p, offs, vals))


ONE_PASS = ["y", "y_dot", "pq", "update", "xpay_pq"]


def _one_pass(mode, d, kw, plain=False):
    """K3 ``mode`` or K4 on ``d`` (update writes d's x and r): the wrapper,
    or with ``plain`` its plain version; {output name: tensor}."""
    if mode in ("y", "y_dot", "pq"):
        src = d["p"] if mode == "pq" else d["x"]
        top, bot = (d["pt"], d["pb"]) if mode == "pq" else (d["rt"], d["rb"])
        if plain:
            out = T.stencil_plain(mode, src, top, bot, **kw)
        elif mode == "pq":
            out = (T.grid2d_cg_pq(src, top, bot, **kw),)
        elif mode == "y":
            out = (T.grid2d_stencil_matvec(src, top, bot, **kw),)
        else:
            out = T.grid2d_stencil_matvec(src, top, bot, with_dot=True, **kw)
        return dict(zip({"y": ("y",), "y_dot": ("y", "dot"),
                         "pq": ("dot",)}[mode], out))
    if mode == "update":
        out = (T.stencil_plain("update", d["p"], d["pt"], d["pb"],
                               (d["x"], d["r"], d["alpha"]), **kw) if plain
               else T.grid2d_cg_update(d["p"], d["x"], d["r"], d["alpha"],
                                       d["pt"], d["pb"], **kw))
        return dict(zip(("x", "r", "dot"), out))
    fn = T.xpay_pq_plain if plain else T.grid2d_cg_xpay_pq
    return dict(zip(("p", "dot"), fn(d["r"], d["p"], d["beta"], d["rt"],
                                     d["rb"], d["pt"], d["pb"], **kw)))


def _one_pass_state(shape, halos, device, seed=31):
    rng = np.random.default_rng(seed)
    d = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(device) for k in ("x", "r", "p")}
    for k in ("rt", "rb", "pt", "pb"):
        d[k] = (torch.from_numpy(rng.standard_normal((8, shape[1])).astype(
            np.float32)).to(device) if halos == "random" else None)
    d["alpha"] = torch.tensor(0.3, device=device)
    d["beta"] = torch.tensor(0.2, device=device)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("halos", ["null", "random"])
@pytest.mark.parametrize("stencil", list(STENCILS2))
@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("mode", ONE_PASS)
def test_k3_k4_edges_match_plain_on_card(mode, shape, stencil, halos,
                                         cuda_device):
    """K3 (four modes) and K4 across the strip march's edges (reach 1) and
    on the band route (reach 2), with null and random halo blocks,
    against their plain versions on the same card to chip_smoke.py's phase
    3 bounds (elementwise 1e-5 * max|ref|, the dot 1e-4 of its
    Cauchy-Schwarz scale), one launch each, and a repeat bit for bit."""
    offs, vals = STENCILS2[stencil]
    _check_one_pass(mode, _one_pass_state(shape, halos, cuda_device), offs,
                    vals, cuda_device)


def _check_one_pass(mode, d, offs, vals, device):
    """K3 ``mode`` or K4 twice and its plain version on copies of ``d``:
    one launch each, a repeat bit for bit, and phase 3's bounds."""
    kw = dict(offsets=offs, values=vals)
    T.reset_launch_counts()
    runs = []
    for plain in (False, False, True):
        c = {k: None if v is None else v.clone() for k, v in d.items()}
        runs.append({k: v.double().cpu()
                     for k, v in _one_pass(mode, c, kw, plain).items()})
    assert dict(T.LAUNCHES) == {mode: 2}
    k1, k2, ref = runs
    assert all(torch.equal(k1[k], k2[k]) for k in k1)
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    for key, want in ref.items():
        err = (k1[key] - want).abs().max().item()
        if key != "dot":
            assert err <= 1e-5 * want.abs().max().item(), (key, err)
            continue
        if mode == "update":
            scale = nrm(ref["r"]) ** 2
        else:
            a = ref["p"] if mode == "xpay_pq" else d["p" if mode == "pq"
                                                      else "x"]
            top, bot = ((d["pt"], d["pb"]) if mode == "pq" else
                        (d["rt"], d["rb"]))
            if mode == "xpay_pq" and top is not None:
                top, bot = (top + 0.2 * d["pt"], bot + 0.2 * d["pb"])
            scale = nrm(a) * nrm(T.apply_plain(a.float().to(device),
                                               offs, vals, top, bot))
        assert err <= 1e-4 * scale, (key, err, scale)


@pytest.mark.cuda
def test_two_pass_history_on_card(cuda_device):
    """A 2-D two-pass CG solve(40) on the card (LEGIONSOLVERS_NO_SSTEP: K3
    pq x1, K4 x39, K3 update x40) against the same schedule driven by the
    plain versions on the card, entry by entry, and the same solve again
    from the same state, bit for bit."""
    import os

    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_system

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    names = ("grid2d_cg_pq", "grid2d_cg_update", "grid2d_cg_xpay_pq")
    plain = {
        "grid2d_cg_pq": lambda p, top=None, bot=None, **kw:
            T.stencil_plain("pq", p, top, bot, **kw)[0],
        "grid2d_cg_update": lambda p, x, r, alpha, top=None, bot=None,
        **kw: T.stencil_plain("update", p, top, bot, (x, r, alpha), **kw),
        "grid2d_cg_xpay_pq": T.xpay_pq_plain}
    hists = []
    os.environ["LEGIONSOLVERS_NO_SSTEP"] = "1"
    saved = {k: getattr(T, k) for k in names}
    try:
        for run in ("kernel", "kernel", "plain"):
            planner = build_system(256, f32, cuda_device)
            if run == "plain":
                for k in names:
                    setattr(T, k, plain[k])
            T.reset_launch_counts()
            hists.append(lt.CGSolver(planner).solve(40).cpu())
            assert dict(T.LAUNCHES) == ({} if run == "plain" else
                                        {"pq": 1, "update": 40,
                                         "xpay_pq": 39})
    finally:
        del os.environ["LEGIONSOLVERS_NO_SSTEP"]
        for k, fn in saved.items():
            setattr(T, k, fn)
    kernel, again, ref = hists
    assert torch.equal(kernel, again)
    assert len(kernel) == 41 and len(np.unique(kernel.numpy())) == 41
    np.testing.assert_allclose(kernel.double().numpy(),
                               ref.double().numpy(), rtol=1e-3)


@pytest.mark.cuda
def test_strip_geometry_and_residency_on_card(cuda_device):
    """The library's strip block counts and target warps equal the Python
    mirror's, and every K2, K5b, K3 and K4 strip variant fits its launch
    bounds' resident blocks."""
    import ctypes

    from legionsolvers_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    assert [lib.ls_strip_target_warps(k) for k in range(5)] == \
        list(T.STRIP_TARGETS)
    for shape in [(4096, 4096), *STRIP_SHAPES]:
        for target in T.STRIP_TARGETS:
            assert lib.ls_strip_blocks(*shape, target) == \
                T.strip_geometry(*shape, target)[3], (shape, target)
    out = (ctypes.c_int * 3)()
    for fn, n, target in (("ls_gram2_attrs", 4, T.GRAM2_TARGET_WARPS),
                          ("ls_bicg_st_strip_attrs", 8, T.ST_TARGET_WARPS),
                          ("ls_stencil2d_strip_attrs", 16,
                           T.STENCIL_TARGET_WARPS),
                          ("ls_xpay_pq_strip_attrs", 4,
                           T.XPAY_TARGET_WARPS)):
        blocks = target // (132 * T.STEP2_WARPS)
        for which in range(n):
            assert getattr(lib, fn)(which, out) == 0, (fn, which)
            assert out[2] >= blocks, (fn, which, list(out))


@pytest.mark.parametrize("shape", [(4096, 4096), *STRIP_SHAPES])
def test_strip_scratch_covers_k2_and_k5b(shape):
    """The strip scratch holds K1's and K2's 10, K5b's 2 and K3's and K4's
    one partial sums for every block of their launches, whose strips and
    row chunks cover the grid (no card needed)."""
    R, C = shape
    capacity = T.strip_capacity(R, C)
    for target, per_block in ((T.STEP2_TARGET_WARPS, 10),
                              (T.GRAM2_TARGET_WARPS, 10),
                              (T.ST_TARGET_WARPS, 2),
                              (T.STENCIL_TARGET_WARPS, 1),
                              (T.XPAY_TARGET_WARPS, 1)):
        strips, rows, units, blocks = T.strip_geometry(R, C, target)
        assert strips * T.STEP2_COLS >= C and units % strips == 0
        assert (units // strips) * rows >= R > (units // strips - 1) * rows
        assert units <= blocks * T.STEP2_WARPS < units + T.STEP2_WARPS
        assert blocks <= capacity
        assert per_block * blocks <= T.STEP2_GRAM * capacity


@pytest.mark.parametrize("halos", ["null", "random"])
@pytest.mark.parametrize("stencil", list(STENCILS2))
def test_k3_k4_run_plain_on_cpu(stencil, halos):
    """On CPU tensors the K3 and K4 wrappers return their plain versions'
    results exactly, with null and random halo blocks, and launch nothing
    (no card needed)."""
    offs, vals = STENCILS2[stencil]
    kw = dict(offsets=offs, values=vals)
    d = _one_pass_state((33, 130), halos, "cpu")
    T.reset_launch_counts()
    for mode in ONE_PASS:
        got, ref = ({k: v.clone() for k, v in _one_pass(
            mode, {k: None if v is None else v.clone() for k, v in d.items()},
            kw, plain).items()} for plain in (False, True))
        assert all(torch.equal(got[k], ref[k]) for k in ref), mode
    assert sum(T.LAUNCHES.values()) == 0


@pytest.mark.parametrize("stencil", list(STENCILS2))
def test_k5b_and_k2_run_plain_on_cpu(stencil):
    """On CPU tensors the K5b (both dot modes) and K2 wrappers return their
    plain versions' results exactly and launch nothing (no card needed;
    K2 takes reach-1 stencils only)."""
    T.reset_launch_counts()
    for comp in (False, True):
        (k1, _, ref), _ = _st_case((96, 132), stencil, comp, "cpu")
        assert torch.equal(k1, ref)
    offs, vals = STENCILS2[stencil]
    rng = np.random.default_rng(23)
    r, p = (torch.from_numpy(rng.standard_normal((33, 130)).astype(
        np.float32)) for _ in range(2))
    if stencil == "reach2":
        with pytest.raises(ValueError):
            T.grid2d_cg_gram2(r, p, offsets=offs, values=vals)
    else:
        assert torch.equal(T.grid2d_cg_gram2(r, p, offsets=offs, values=vals),
                           T.gram2_plain(r, p, offsets=offs, values=vals))
    assert sum(T.LAUNCHES.values()) == 0

def _explicit_coo(name):
    """Small forms of chip_smoke.py's scrambled Laplacian and random SPD
    systems (numpy, from their seeds)."""
    import legionsolvers_tpu_torch as lt

    if name == "scrambled":
        a = lt.create_coo_stencil_matrix((64, 64), lt.laplacian_stencil(2))
        pr = np.random.default_rng(0).permutation(a.n_range)
        return pr[a.rows], pr[a.cols], np.asarray(a.vals), a.n_range
    n = 1 << 14
    rng = np.random.default_rng(1)
    rows, cols = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    vals = rng.uniform(-1, 1, 4 * n)
    return (np.concatenate([rows, cols, np.arange(n)]),
            np.concatenate([cols, rows, np.arange(n)]),
            np.concatenate([vals, vals, np.full(n, 16.0)]), n)


@pytest.mark.cuda
@pytest.mark.parametrize("name,chain,counter", [
    ("scrambled", ["ReorderedOperator", "WinEllOperator"], "winell"),
    ("random", ["ReorderedOperator", "GeneralSpmvOperator"], "blockperm"),
])
def test_f64_explicit_cg_on_card(name, chain, counter, cuda_device):
    """An f64 CG solve through build_explicit_system launches K9 or K10 in
    double, once per hop of every matvec, and matches the same solve on
    the CPU (plain versions) to rtol 1e-9 (reductions in another order)."""
    import legionsolvers_tpu_torch as lt

    f64 = lt.SolverOptions(entry_dtype=torch.float64)
    rows, cols, vals, n = _explicit_coo(name)
    systems = [lt.build_explicit_system(
        lt.COOMatrix(rows, cols, vals, n, n, options=f64), f64, device=d)
        for d in (cuda_device, "cpu")]
    op = systems[0].row_partitioned_matrices[0][0]
    names = lambda o: [type(o).__name__] + (names(o.base)
                                            if hasattr(o, "base") else [])
    assert names(op) == chain
    iters = 30
    T.reset_launch_counts()
    hist = lt.CGSolver(systems[0]).solve(iters)
    torch.cuda.synchronize()
    hops = getattr(op.base, "launches_per_matvec", 1)
    assert dict(T.LAUNCHES) == {counter: hops * iters}
    want = lt.CGSolver(systems[1]).solve(iters)
    np.testing.assert_allclose(hist.cpu().numpy(), want.numpy(), rtol=1e-9)
    np.testing.assert_allclose(systems[0].sol_vectors[0].to_numpy(),
                               systems[1].sol_vectors[0].to_numpy(),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [1, 2, 16])
@pytest.mark.parametrize("kind", ["fma", "roll", "row"])
def test_k11_matches_plain_on_card(kind, reps, cuda_device):
    """K11 on the probe's [256, 1024] tile: roll and row bit for bit, fma
    to fma_rtol(reps) of the largest output (one rounding per step where
    the plain version rounds twice)."""
    from legionsolvers_tpu_torch.ops.cuda import vpu_probe as K11

    g = torch.Generator(cuda_device).manual_seed(11)
    x = torch.randn(K11.TR, K11.C, generator=g, device=cuda_device)
    T.reset_launch_counts()
    got = K11.chain_probe(x, reps, kind)
    torch.cuda.synchronize()
    assert dict(T.LAUNCHES) == {f"chain_{kind}": 1}
    want = K11.chain_plain(x, reps, kind)
    if kind == "fma":
        err = (got - want).abs().max().item()
        assert err <= K11.fma_rtol(reps) * want.abs().max().item()
    else:
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16384, 4096), (200, 328), (7, 3)])
def test_k12_matches_plain_on_card(shape, cuda_device):
    """K12 bit for bit, on aligned and unaligned (offset view) inputs, and
    k chained launches give x + k exactly."""
    from legionsolvers_tpu_torch.ops.cuda import copy_probe as K12
    from legionsolvers_tpu_torch.utils.probe_roofline import copy_chain

    g = torch.Generator(cuda_device).manual_seed(12)
    x = torch.randn(shape, generator=g, device=cuda_device)
    T.reset_launch_counts()
    assert torch.equal(K12.copy_probe(x), x + 1.0)
    flat = torch.randn(x.numel() + 1, generator=g, device=cuda_device)
    assert torch.equal(K12.copy_probe(flat[1:]), flat[1:] + 1.0)
    xi = torch.randint(-50, 50, shape, generator=g, device=cuda_device,
                       dtype=torch.int32).float()
    assert torch.equal(copy_chain(xi, 5), xi + 5)
    torch.cuda.synchronize()
    assert dict(T.LAUNCHES) == {"copy_probe": 7}


@pytest.mark.cuda
@pytest.mark.parametrize("switch", ["allow_tf32", "fp32_precision"])
def test_gmres_ignores_tf32_on_card(switch, cuda_device):
    """GMRES(10) on the 2-D kernel view: with TF32 matmuls enabled
    globally (through either of torch's switches) the history is the
    same, bit for bit, as without (the solve holds its products at full
    f32 and gives the caller's setting back), and every matvec is one K3 y
    launch (m + 1 per cycle and one closing residual)."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_stencil_system

    matmul = torch.backends.cuda.matmul
    if switch == "fp32_precision" and not hasattr(matmul, switch):
        pytest.skip("this torch has no fp32_precision switch")
    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    hists = []
    try:
        for tf32 in (False, True):
            if switch == "allow_tf32":
                matmul.allow_tf32 = tf32
            else:
                matmul.fp32_precision = "tf32" if tf32 else "ieee"
            planner = build_stencil_system(2, (256, 512), f32, cuda_device)
            T.reset_launch_counts()
            hists.append(lt.GMRESSolver(planner, 10).solve(5))
            torch.cuda.synchronize()
            assert dict(T.LAUNCHES) == {"y": 5 * 11 + 1}
            assert matmul.allow_tf32 == tf32
    finally:
        matmul.allow_tf32 = False
    assert torch.equal(hists[0], hists[1])
    assert bool(torch.all(hists[0][1:] <= hists[0][:-1] * (1 + 1e-5)))


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["gmres", "pcg"])
def test_f64_gmres_pcg_on_card(solver, cuda_device):
    """f64 GMRES(10) x 6 and PCG(Jacobi) x 40 on the 2-D Laplacian at
    128^2 (linearized path) match the same solves on the CPU to rtol 1e-8
    (reductions in another order)."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_stencil_system

    f64 = lt.SolverOptions(entry_dtype=torch.float64)
    hists, xs = [], []
    for d in (cuda_device, "cpu"):
        planner = build_stencil_system(2, (128, 128), f64, d)
        if solver == "gmres":
            h = lt.GMRESSolver(planner, 10).solve(6)
        else:
            h = lt.PCGSolver(planner, lt.JacobiPreconditioner(planner)
                             ).solve(40)
        hists.append(h.cpu().numpy())
        xs.append(planner.sol_vectors[0].to_numpy())
    np.testing.assert_allclose(hists[0], hists[1], rtol=1e-8)
    np.testing.assert_allclose(xs[0], xs[1], rtol=1e-8, atol=1e-12)


@pytest.mark.cuda
def test_benchmark_cli_on_card(cuda_device):
    """The CLI's CG run at 512^2 on the card: the s-step kernels, the op
    rates from K11 and a roofline share of at most 100%."""
    from legionsolvers_tpu_torch import benchmark

    T.reset_launch_counts()
    out = benchmark.main(["-dim", "2", "-nx", "512", "-ny", "512", "-it",
                          "40", "--device", cuda_device])
    assert out["schedule"].startswith("fused2d_x2")
    assert 0 < out["pct_roofline"] <= 100
    assert T.LAUNCHES["step2"] >= 20 * benchmark.RUNS[40]


@pytest.mark.cuda
@pytest.mark.parametrize("dim,solver,env", [
    (2, "CGSolver", None), (2, "CGSolver", "LEGIONSOLVERS_NO_SSTEP"),
    (2, "BiCGStabSolver", None), (3, "CGSolver", None),
    (3, "BiCGStabSolver", None)])
def test_block_solve_doubles_one_space_on_card(dim, solver, env,
                                               monkeypatch, cuda_device):
    """The block runners on the card (``parallel/block_fused.py``): two
    identical spaces of a 2-D (200, 328) or 3-D (37, 45, 130) Laplacian,
    b = 1, solve(40).  Each kernel launches exactly twice as often as in
    the single-space solve(40), the history is exactly twice the single
    space's and each space's x is the single-space x, bit for bit."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_stencil_system

    if env:
        monkeypatch.setenv(env, "1")
    grid = (200, 328) if dim == 2 else (37, 45, 130)
    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    runs = []
    for spaces in (1, 2):
        planner = build_stencil_system(dim, grid, f32, cuda_device,
                                       num_spaces=spaces)
        T.reset_launch_counts()
        hist = getattr(lt, solver)(planner).solve(40)
        torch.cuda.synchronize()
        runs.append((dict(T.LAUNCHES), hist,
                     [v.data for v in planner.sol_vectors]))
    (c1, h1, (x1,)), (c2, h2, xs) = runs
    assert c1 and c2 == {k: 2 * v for k, v in c1.items()}
    assert torch.equal(h2, 2 * h1)
    for x in xs:
        assert torch.equal(x, x1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 328), (33, 4097)])
def test_k1_k2_on_row_block_views_on_card(shape, cuda_device):
    """K1 and K2 on pieces 1 and 3 of a 4-piece grid (contiguous row-block
    views at non-zero storage offsets) against their plain versions on the
    same views; the other pieces' rows are not touched."""
    Br, C = shape
    rng = np.random.default_rng(23)
    full = {k: torch.from_numpy(rng.standard_normal((4 * Br, C)).astype(
        np.float32)).to(cuda_device) for k in ("x", "r", "p")}
    for s in (1, 3):
        d = {k: v.clone() for k, v in full.items()}
        view = {k: v.view(4, Br, C)[s] for k, v in d.items()}
        assert view["x"].storage_offset() == s * Br * C
        coef = T.cg2_coeffs(T.gram2_plain(view["r"], view["p"], **KW))[0]
        outs = [torch.full_like(d["r"], float("nan")) for _ in range(2)]
        out_view = tuple(o.view(4, Br, C)[s] for o in outs)
        T.reset_launch_counts()
        g2 = T.grid2d_cg_gram2(view["r"], view["p"], **KW)
        got = T.grid2d_cg_step2(view["x"], view["r"], view["p"], coef,
                                out=out_view, **KW)
        assert dict(T.LAUNCHES) == {"gram2": 1, "step2": 1}
        ref_in = {k: v.view(4, Br, C)[s].clone() for k, v in full.items()}
        ref = T.step2_plain(ref_in["x"], ref_in["r"], ref_in["p"], coef,
                            **KW)
        for have, want in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(have.cpu().numpy(),
                                       want.cpu().numpy(), rtol=0,
                                       atol=1e-5 * want.abs().max().item())
        bound = gram_bounds(ref[1].cpu().numpy(), ref[2].cpu().numpy())
        np.testing.assert_array_less(
            np.abs(got[3].double().cpu().numpy()
                   - ref[3].double().cpu().numpy()), 1e-4 * bound)
        g_ref = T.gram2_plain(ref_in["r"], ref_in["p"], **KW)
        bound = gram_bounds(ref_in["r"].cpu().numpy(),
                            ref_in["p"].cpu().numpy())
        np.testing.assert_array_less(
            np.abs(g2.double().cpu().numpy()
                   - g_ref.double().cpu().numpy()), 1e-4 * bound)
        for k in (k for k in range(4) if k != s):
            assert torch.equal(d["x"].view(4, Br, C)[k],
                               full["x"].view(4, Br, C)[k])
            assert all(o.view(4, Br, C)[k].isnan().all() for o in outs)


@pytest.mark.cuda
def test_sharded_sstep_solve_on_card(cuda_device):
    """The 4-piece s-step runner on the card (256^2, solve(40): K1 4 x 20,
    K2 4 x 2) against the same 4-piece runner driven by the plain
    versions on the card: history entry by entry to rtol 1e-3, x to 1e-3
    of max|x|."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    runs = []
    for plain in (False, True):
        mesh = make_mesh(4, devices=[cuda_device] * 4)
        planner = build_system(256, f32, mesh=mesh)
        solver = lt.CGSolver(planner)
        saved = (T.grid2d_cg_step2, T.grid2d_cg_gram2)
        if plain:
            T.grid2d_cg_step2, T.grid2d_cg_gram2 = T.step2_plain, T.gram2_plain
        T.reset_launch_counts()
        try:
            hist = solver.solve(40).cpu().double().numpy()
        finally:
            T.grid2d_cg_step2, T.grid2d_cg_gram2 = saved
        assert dict(T.LAUNCHES) == ({} if plain else
                                    {"step2": 80, "gram2": 8})
        runs.append((hist, planner.sol_vectors[0].to_numpy()))
    (hk, xk), (hp, xp) = runs
    assert len(hk) == 41 and np.isfinite(hk).all()
    np.testing.assert_allclose(hk, hp, rtol=1e-3)
    np.testing.assert_allclose(xk, xp, rtol=0, atol=1e-3 * np.abs(xp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("env,iters,launches", [
    (None, 9, {"step2": 16, "gram2": 4, "update": 4}),
    ("LEGIONSOLVERS_NO_SSTEP", 20, {"pq": 4, "update": 80, "xpay_pq": 76}),
])
def test_sharded_solves_match_plain_on_card(cuda_device, monkeypatch, env,
                                            iters, launches):
    """The 4-piece s-step runner with its odd tail (K3 update per piece on
    p's exchanged halos) and the 4-piece two-pass runner (zero-halo K4 and
    its dot fix-up, K3 update on halo blocks) on the card, 256^2, against
    the same runners driven by the plain versions on the card: history
    entry by entry to rtol 1e-3, x to 1e-3 of max|x|."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    if env:
        monkeypatch.setenv(env, "1")
    plain = {
        "grid2d_cg_step2": T.step2_plain,
        "grid2d_cg_gram2": T.gram2_plain,
        "grid2d_cg_xpay_pq": T.xpay_pq_plain,
        "grid2d_cg_pq": lambda p, top=None, bot=None, **kw:
            T.stencil_plain("pq", p, top, bot, **kw)[0],
        "grid2d_cg_update": lambda p, x, r, alpha, top=None, bot=None, **kw:
            T.stencil_plain("update", p, top, bot, (x, r, alpha), **kw),
    }
    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    runs = []
    for use_plain in (False, True):
        planner = build_system(256, f32, mesh=make_mesh(
            4, devices=[cuda_device] * 4))
        with monkeypatch.context() as m:
            if use_plain:
                for name, fn in plain.items():
                    m.setattr(T, name, fn)
            T.reset_launch_counts()
            hist = lt.CGSolver(planner).solve(iters).cpu().double().numpy()
        assert dict(T.LAUNCHES) == ({} if use_plain else launches)
        runs.append((hist, planner.sol_vectors[0].to_numpy()))
    (hk, xk), (hp, xp) = runs
    assert len(hk) == iters + 1 and np.isfinite(hk).all()
    np.testing.assert_allclose(hk, hp, rtol=1e-3)
    np.testing.assert_allclose(xk, xp, rtol=0, atol=1e-3 * np.abs(xp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 4])
def test_k6_on_pieces_with_exchanged_planes_on_card(dim, cuda_device):
    """K6a (y, pq, update) and K6b on each piece of a 4-piece (36, 45, 130)
    volume (9 x-planes per piece), every piece with the halo planes that
    ``StencilOperator._exchange_planes3d`` copies out of its neighbours,
    against the plain versions on the same inputs (phase 3's bounds:
    elementwise 2e-5 * max|ref|, dots 1e-4 of their Cauchy-Schwarz
    scale); one launch per call."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    S, shape = 4, (36, 45, 130)
    kw = _kw3(dim)
    op = lt.StencilOperator(
        shape, lt.laplacian_stencil(dim),
        partition=lt.BlockPartition(int(np.prod(shape)), S),
        mesh=make_mesh(S, devices=[cuda_device] * S),
        options=lt.SolverOptions(entry_dtype=torch.float32))
    assert op._view["kind"] == "3d" and op._view["Br"] == 9
    rng = np.random.default_rng(29)
    full = {k: torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device) for k in ("x", "r", "p")}
    tops, bots = op._planes3d(full["r"], full["p"])
    for s in range(S):
        planes = {"r": (tops[0][s], bots[0][s]), "p": (tops[1][s],
                                                      bots[1][s])}
        piece = {k: v.view(S, 9, 45, 130)[s] for k, v in full.items()}
        if s == 0:
            assert not planes["p"][0].any()
        else:
            assert torch.equal(planes["p"][0],
                               full["p"].view(S, 9, 45, 130)[s - 1, -1])
        d = {k: v.cpu().numpy() for k, v in piece.items()}
        bound = _norm_bound({**d, "v": d["x"], "rt": d["x"]})
        for mode in ("y", "pq", "update", "xpay_pq"):
            t = {k: v.clone() for k, v in piece.items()}
            ref_in = {k: v.clone() for k, v in piece.items()}
            T.reset_launch_counts()
            if mode == "xpay_pq":
                pt = planes["r"][0] + 0.37 * planes["p"][0]
                pb = planes["r"][1] + 0.37 * planes["p"][1]
                got = T3.grid3d_cg_xpay_pq(t["r"], t["p"], 0.37, pt, pb,
                                           **kw)
                ref = T3.xpay_pq3d_plain(ref_in["r"], ref_in["p"], 0.37, pt,
                                         pb, **kw)
                names = ("p", "dot")
            else:
                h = planes["p"]
                if mode == "y":
                    got = (T3.grid3d_stencil_matvec(t["p"], *h, **kw),)
                elif mode == "pq":
                    got = (T3.grid3d_cg_pq(t["p"], *h, **kw),)
                else:
                    got = T3.grid3d_cg_update(t["p"], t["x"], t["r"], 0.3,
                                              *h, **kw)
                extra = ((ref_in["x"], ref_in["r"], 0.3) if mode == "update"
                         else ())
                ref = T3.stencil3d_plain(mode, ref_in["p"], *h, extra, **kw)
                names = {"y": ("y",), "pq": ("dot",),
                         "update": ("x", "r", "dot")}[mode]
            assert dict(T.LAUNCHES) == {f"{mode}3d": 1}
            np_ = lambda out: {k: v.double().cpu().numpy()
                               for k, v in zip(names, out)}
            _compare3d(np_(got), np_(ref), bound)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 4])
def test_sharded_3d_cg_matches_plain_on_card(dim, cuda_device, monkeypatch):
    """The 4-piece 3-D two-pass runner on the card at (32, 40, 132),
    solve(20): launches K6a pq 4, K6b 76, K6a update 80; against the same
    runner driven by the plain versions, history entry by entry to rtol
    1e-3 and x to 1e-3 of max|x| (phase 4's kernel-against-plain bound)."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    plain = {
        "grid3d_cg_xpay_pq": T3.xpay_pq3d_plain,
        "grid3d_cg_pq": lambda p, top=None, bot=None, **kw:
            T3.stencil3d_plain("pq", p, top, bot, **kw)[0],
        "grid3d_cg_update": lambda p, x, r, alpha, top=None, bot=None, **kw:
            T3.stencil3d_plain("update", p, top, bot, (x, r, alpha), **kw),
    }
    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    runs = []
    for use_plain in (False, True):
        planner = build_stencil_system(dim, (32, 40, 132), f32, mesh=make_mesh(
            4, devices=[cuda_device] * 4))
        with monkeypatch.context() as m:
            if use_plain:
                for name, fn in plain.items():
                    m.setattr(T3, name, fn)
            T.reset_launch_counts()
            hist = lt.CGSolver(planner).solve(20).cpu().double().numpy()
        assert dict(T.LAUNCHES) == ({} if use_plain else
                                    {"pq3d": 4, "xpay_pq3d": 76,
                                     "update3d": 80})
        runs.append((hist, planner.sol_vectors[0].to_numpy()))
    (hk, xk), (hp, xp) = runs
    assert len(hk) == 21 and np.isfinite(hk).all()
    np.testing.assert_allclose(hk, hp, rtol=1e-3)
    np.testing.assert_allclose(xk, xp, rtol=0, atol=1e-3 * np.abs(xp).max())


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
def test_sharded_bicgstab_iteration_on_card(compensated, cuda_device,
                                            monkeypatch):
    """The fused 2-D BiCGStab runner on 4 pieces of 256^2 (64 rows each),
    one iteration and then two, on the card: K5a, K5b and K5c once per
    piece per iteration, with zero halos and the runner's edge fix-ups;
    against the same runner driven by the plain versions on the card,
    history entry by entry to rtol 1e-4 and x to 1e-4 of max|x|; and the
    two-iteration history against one piece's to rtol 1e-4."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    F = lt.SolverOptions(entry_dtype=torch.float32,
                         compensated_dots=compensated)
    plain = {"bicg_pv": TB.bicg_pv_plain, "bicg_st": TB.bicg_st_plain,
             "bicg_update": TB.bicg_update_plain}
    rhs = torch.from_numpy(np.random.default_rng(31).random(
        (256, 256)).astype(np.float32)).to(cuda_device)

    def run(pieces, iters, use_plain):
        mesh = (make_mesh(pieces, devices=[cuda_device] * pieces)
                if pieces > 1 else None)
        planner = build_system(256, F, cuda_device, mesh=mesh)
        planner.rhs_vectors[0].data = rhs.clone()
        with monkeypatch.context() as m:
            if use_plain:
                for name, fn in plain.items():
                    m.setattr(TB, name, fn)
            T.reset_launch_counts()
            hist = lt.BiCGStabSolver(planner).solve(iters)
            hist = hist.cpu().double().numpy()
        want = {} if use_plain else {k: pieces * iters for k in plain}
        assert dict(T.LAUNCHES) == want
        return hist, planner.sol_vectors[0].to_numpy()

    for iters in (1, 2):
        (hk, xk), (hp, xp) = run(4, iters, False), run(4, iters, True)
        assert np.isfinite(hk).all()
        np.testing.assert_allclose(hk, hp, rtol=1e-4)
        np.testing.assert_allclose(xk, xp, rtol=0,
                                   atol=1e-4 * np.abs(xp).max())
    h1, _ = run(1, 2, False)
    np.testing.assert_allclose(hk, h1, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("with_dot", [False, True])
def test_k8_zero_halo_per_piece_with_fixup_on_card(with_dot, cuda_device):
    """An f32 DIA operator on 4 pieces of a (64, 512) grid with random
    asymmetric coefficients: each piece's K8 launch (zero halos, its rows
    of the shared [D, S * Br, C] diagonals read with their stride) against
    the plain version on the same inputs, bit for bit, its dot to 1e-5 of
    its Cauchy-Schwarz scale; then the operator's matvec (zero-halo
    launches plus the edge fix-up) against the same operator built on the
    CPU, y bit for bit (elementwise torch ops round alike on both
    devices), <x, A x> to 1e-5 of its scale; one launch per piece."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    S, shape = 4, (64, 512)
    n = shape[0] * shape[1]
    rng = np.random.default_rng(41)
    a = lt.create_coo_stencil_matrix(shape, [((0, 0), 4.0), ((-1, 0), -1.0),
                                             ((1, 0), -1.5), ((0, -1), -0.5),
                                             ((0, 1), -1.0)])
    vals = np.asarray(a.vals) * rng.uniform(0.5, 1.5, len(a.vals))
    F = lt.SolverOptions(entry_dtype=torch.float32)
    A = lt.COOMatrix(a.rows, a.cols, vals, n, n, options=F)
    part = lt.BlockPartition(n, S)
    ops = {d: lt.DiaOperator(A, part, mesh=make_mesh(S, devices=[d] * S),
                             options=F, device=d)
           for d in (cuda_device, "cpu")}
    op = ops[cuda_device]
    v = op._view
    Br, C = v["Br"], v["C"]
    assert Br * S * C == n and Br >= 8
    xh = rng.standard_normal(n).astype(np.float32)
    x = torch.from_numpy(xh).to(cuda_device)
    x3 = x.view(S, Br, C)
    for s in range(S):
        d = v["diags"][:, s * Br: (s + 1) * Br]
        assert not d.is_contiguous()
        T.reset_launch_counts()
        got = TD.dia2d_matvec(x3[s], None, None, d, offsets=v["offs"],
                              with_dot=with_dot)
        assert dict(T.LAUNCHES) == {"dia2d_dot" if with_dot else "dia2d": 1}
        want = TD.dia2d_plain(x3[s], None, None, d, offsets=v["offs"],
                              with_dot=with_dot)
        if with_dot:
            (got, gd), (want, wd) = got, want
            assert abs(gd.item() - wd.item()) <= 1e-5 * (
                x3[s].double().norm() * want.double().norm()).item()
        assert torch.equal(got, want)
    T.reset_launch_counts()
    out = op.matvec_dot(x) if with_dot else op.matvec(x)
    assert dict(T.LAUNCHES) == {"dia2d_dot" if with_dot else "dia2d": S}
    ref = (ops["cpu"].matvec_dot(torch.from_numpy(xh)) if with_dot
           else ops["cpu"].matvec(torch.from_numpy(xh)))
    if with_dot:
        (out, od), (ref, rd) = out, ref
        assert abs(od.item() - rd.item()) <= 1e-5 * float(
            np.linalg.norm(xh) * ref.double().norm())
    assert torch.equal(out.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k9_on_piece_ext2_plans_on_card(dtype, cuda_device):
    """The sharded RowPartitionedMatrix on 4 pieces of a random banded
    matrix (n = 64K + 5, band 300): K9 on each piece's banded-ordered
    extended buffer (Rt = 8, the shared L and KR) against the plain
    version, bit for bit; the matvec (the halo exchange, then one K9 per
    piece) bit for bit the same operator's on the CPU, four launches."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    S, n, bw = 4, 64 * 1024 + 5, 300
    rng = np.random.default_rng(43)
    rows = rng.integers(0, n, 6 * n)
    cols = rows + rng.integers(-bw, bw + 1, 6 * n)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1, 1, len(rows))
    F = lt.SolverOptions(entry_dtype=dtype)
    A = lt.COOMatrix(rows, cols, vals, n, n, options=F)
    part = lt.BlockPartition(n, S)
    ops = {d: lt.RowPartitionedMatrix(A, part, part,
                                      mesh=make_mesh(S, devices=[d] * S),
                                      options=F, device=d)
           for d in (cuda_device, "cpu")}
    op = ops[cuda_device]
    w = op._win
    assert w is not None and w["cols"].shape[3] == 8
    xh = np.zeros(part.padded_size)
    xh[:n] = rng.standard_normal(n)
    x = torch.as_tensor(xh, dtype=dtype, device=cuda_device)
    x2 = x.view(S, -1)
    ext = x2.new_zeros(S, max(w["N"], w["ext2"]))
    ext[:, w["n_lo_u"]: w["n_lo_u"] + part.block_size] = x2
    op._exchange(x2, ext, w["recv_pos2"])
    for s in range(S):
        args = (ext[s].view(-1, 128), w["wstart"][s], w["cols"][s],
                w["vals"][s])
        T.reset_launch_counts()
        got = TW.winell_spmv(*args, window_rows=w["KR"])
        assert dict(T.LAUNCHES) == {"winell": 1}
        assert torch.equal(got, TW.winell_plain(*args, window_rows=w["KR"]))
    T.reset_launch_counts()
    y = op.matvec(x)
    assert dict(T.LAUNCHES) == {"winell": S}
    assert torch.equal(y.cpu(), ops["cpu"].matvec(x.cpu()))


# ---------------------------------------------------------------------------
# The 1-D kernel view (K3, K4, K5b: the strip march with WRAP on the 1-D
# stencil; K1, K2: the march along the flat index) and the tile kernels'
# wide column shifts, against the plain versions on the decomposed offsets:
# widths C = 128 and 1000, ragged rows, C = 4096 with rows past one chunk
# ---------------------------------------------------------------------------

FLAT_SHAPES = [(8, 128), (37, 1000), (203, 4096), (3, 1000)]


def _flat1d(C):
    return T.decompose_flat_offsets((0, -1, 1), (2.0, -1.0, -1.0), C)


def _wide2d(C):
    """Column shifts past the tile's 8: (0, +-37), (1, -(C - 1)) and a
    term 8 rows up (from the top halo block) at column shift 100."""
    return ((KW["offsets"] + ((0, 37), (0, -37), (1, -(C - 1)), (-8, 100))),
            KW["values"] + (-0.25, -0.25, -0.5, -0.125))


WIDE = {"flat": _flat1d, "wide": _wide2d}


@pytest.mark.cuda
@pytest.mark.parametrize("halos", ["null", "random"])
@pytest.mark.parametrize("stencil", list(WIDE))
@pytest.mark.parametrize("shape", FLAT_SHAPES)
@pytest.mark.parametrize("mode", ONE_PASS)
def test_k3_k4_wide_match_plain_on_card(mode, shape, stencil, halos,
                                        cuda_device):
    """K3 (four modes) and K4 on the flat route and with wide terms on the
    band route, with null and random halo blocks (rows past the grid
    and, on the flat route, the flat elements before and after it):
    phase 3's bounds, one launch, a repeat bit for bit."""
    offs, vals = WIDE[stencil](shape[1])
    assert T.route(offs, vals, shape[1])[0] == ("flat" if stencil == "flat"
                                                else "band")
    assert T.route(offs, vals, shape[1], bicg="st")[0] == (
        "flat" if stencil == "flat" else "band")
    assert T.route(offs, vals, shape[1], bicg="update")[0] == "band"
    _check_one_pass(mode, _one_pass_state(shape, halos, cuda_device), offs,
                    vals, cuda_device)


# K1 and K2's flat march (csrc/flat1d.cu) also at views whose n = R C
# lies one float4 past (2052) and one element short of (2047) a run of 16
# segments, so that a run and the vector end in different places
FLAT_RUN_SHAPES = FLAT_SHAPES + [(513, 4), (23, 89)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLAT_RUN_SHAPES)
def test_k1_k2_flat_match_plain_on_card(shape, cuda_device):
    """K1 and K2 on the flat route (the march along the flat index)
    against step2_plain and gram2_plain on the decomposed offsets (phase
    3's bounds), repeats bit for bit."""
    offs, vals = _flat1d(shape[1])
    assert T.route(offs, vals, shape[1], sstep=True)[0] == "flat"
    rng = np.random.default_rng(29)
    d = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(cuda_device) for k in ("x", "r", "p")}
    kw = dict(offsets=offs, values=vals)
    coef = T.cg2_coeffs(T.gram2_plain(d["r"], d["p"], **kw))[0]
    T.reset_launch_counts()
    runs = []
    for fn in (T.grid2d_cg_step2, T.grid2d_cg_step2, T.step2_plain):
        c = {k: v.clone() for k, v in d.items()}
        runs.append([t.cpu() for t in fn(c["x"], c["r"], c["p"], coef,
                                         **kw)])
    g1, g2, gref = (fn(d["r"], d["p"], **kw).double().cpu() for fn in (
        T.grid2d_cg_gram2, T.grid2d_cg_gram2, T.gram2_plain))
    assert dict(T.LAUNCHES) == {"step2": 2, "gram2": 2}
    k1, k2, ref = runs
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    assert torch.equal(g1, g2)
    for have, want in zip(k1[:3], ref[:3]):
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    bound = gram_bounds(ref[1].numpy(), ref[2].numpy(), offs, vals)
    np.testing.assert_array_less(
        np.abs(k1[3].double().numpy() - ref[3].double().numpy()),
        1e-4 * bound)
    bound = gram_bounds(d["r"].cpu().numpy(), d["p"].cpu().numpy(), offs,
                        vals)
    np.testing.assert_array_less(np.abs((g1 - gref).numpy()), 1e-4 * bound)


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(range(8)))
def test_flat_attrs_on_card(which, cuda_device):
    """Each flat-route kernel (K1, K2 and K5b with f32 and compensated
    dots, scalar and 16-byte loads) fits its launch bounds' resident
    blocks per SM (K1 4, 3 with scalar loads; K2 5; K5b 8) with no spill;
    the library's flat geometry, targets and 1-D stencil equal the Python
    mirror's."""
    import ctypes

    from legionsolvers_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    out = (ctypes.c_int * 4)()
    assert lib.ls_flat_attrs(which, out) == 0
    regs, spill, per_sm, smem = out
    blocks = (3, 4, 5, 5, 8, 8, 8, 8)[which]
    assert 0 < regs <= 65536 // (128 * blocks), list(out)
    assert spill == 0 and per_sm >= blocks, list(out)
    assert 0 < smem <= 1024, smem
    assert [lib.ls_flat_target_warps(k)
            for k in range(len(T.FLAT_TARGETS))] == list(T.FLAT_TARGETS)
    geo = (ctypes.c_longlong * 4)()
    for shape in FLAT_RUN_SHAPES + [(4096, 4096)]:
        for target in T.FLAT_TARGETS:
            assert lib.ls_flat_geometry(*shape, target, geo) == 0
            assert tuple(geo) == T.flat_geometry(*shape, target), shape
    shifts = (ctypes.c_int * 3)()
    assert lib.ls_flat_shifts(shifts) == 0
    assert tuple(shifts) == T.FLAT_SHIFTS


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("shape", FLAT_RUN_SHAPES + [(1, 5), (7, 33)])
def test_k5b_flat_match_plain_and_band_on_card(shape, compensated, aligned,
                                               cuda_device, monkeypatch):
    """K5b on the 1-D view's flat route (the march along the flat index,
    ``ls_flat_bicg_st``) against bicg_st_plain on the decomposed offsets
    (each dot within 1e-4 of its Cauchy-Schwarz scale), one launch, a
    repeat bit for bit; and against the band march on the same inputs
    (the route forced), whose t = A s has the same bits: the dots differ
    only by their double sums' order, so by at most 2 ulp and 1e-9 of the
    scale.  At views whose n is not a multiple of 128 (or of 4), with 16-
    byte aligned buffers and with buffers one float past (scalar loads)."""
    offs, vals = _flat1d(shape[1])
    assert T.route(offs, vals, shape[1], bicg="st")[0] == "flat"
    n = shape[0] * shape[1]
    rng = np.random.default_rng(43)
    r, v = (torch.from_numpy(rng.standard_normal(n + 1).astype(np.float32)
                             ).to(cuda_device) for _ in range(2))
    r, v = ((a[:n] if aligned else a[1:]).view(shape) for a in (r, v))
    kw = dict(offsets=offs, values=vals, compensated=compensated)
    T.reset_launch_counts()
    k1, k2, ref = (torch.stack(fn(r, v, 0.83, **kw)).double().cpu()
                   for fn in (TB.bicg_st, TB.bicg_st, TB.bicg_st_plain))
    assert dict(T.LAUNCHES) == {"bicg_st": 2}
    assert torch.equal(k1, k2)
    s = r - torch.tensor(0.83, device=cuda_device) * v
    t = T.apply_plain(s, offs, vals)
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    scale = torch.tensor([nrm(t) * nrm(s), nrm(t) ** 2], dtype=torch.float64)
    assert bool(((k1 - ref).abs() <= 1e-4 * scale).all()), (k1, ref)
    with monkeypatch.context() as m:
        m.setattr(TB, "route", lambda o, vv, C, sstep=False, bicg=None: (
            "band", o, vv, 0))
        band = torch.stack(TB.bicg_st(r, v, 0.83, **kw)).double().cpu()
    ulp = torch.tensor([np.spacing(np.float32(abs(x))) for x in k1.numpy()],
                       dtype=torch.float64)
    assert bool(((k1 - band).abs() <= 2 * ulp + 1e-9 * scale).all()), (
        k1, band)


@pytest.mark.cuda
def test_k1_k2_cross_unchanged_on_card(cuda_device):
    """The 2-D cross's K1 and K2 at 4096^2 (the main path, on the strip
    march, which lost its WRAP branch) against step2_plain and gram2_plain
    under phase 3's bounds, repeats bit for bit, one strip launch each and
    no flat one."""
    shape = (4096, 4096)
    assert T.route(KW["offsets"], KW["values"], 4096, sstep=True)[0] == \
        "strip"
    rng = np.random.default_rng(31)
    d = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(cuda_device) for k in ("x", "r", "p")}
    coef = T.cg2_coeffs(T.gram2_plain(d["r"], d["p"], **KW))[0]
    T.reset_launch_counts()
    runs = []
    for fn in (T.grid2d_cg_step2, T.grid2d_cg_step2, T.step2_plain):
        c = {k: v.clone() for k, v in d.items()}
        runs.append([t.cpu() for t in fn(c["x"], c["r"], c["p"], coef,
                                         **KW)])
    g1, g2, gref = (fn(d["r"], d["p"], **KW).double().cpu() for fn in (
        T.grid2d_cg_gram2, T.grid2d_cg_gram2, T.gram2_plain))
    assert dict(T.LAUNCHES) == {"step2": 2, "gram2": 2}
    k1, k2, ref = runs
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    assert torch.equal(g1, g2)
    for have, want in zip(k1[:3], ref[:3]):
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    offs, vals = KW["offsets"], KW["values"]
    bound = gram_bounds(ref[1].numpy(), ref[2].numpy(), offs, vals)
    np.testing.assert_array_less(
        np.abs(k1[3].double().numpy() - ref[3].double().numpy()),
        1e-4 * bound)
    bound = gram_bounds(d["r"].cpu().numpy(), d["p"].cpu().numpy(), offs,
                        vals)
    np.testing.assert_array_less(np.abs((g1 - gref).numpy()), 1e-4 * bound)


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("stencil", list(WIDE))
@pytest.mark.parametrize("shape", FLAT_SHAPES)
@pytest.mark.parametrize("kernel", ["pv", "st", "update"])
def test_k5_wide_match_plain_on_card(kernel, shape, stencil, compensated,
                                     cuda_device):
    """K5a-c on the 1-D view (K5b on the flat route, K5a and K5c on the
    band route) and with wide 2-D terms (K5a-c on the band route),
    against their plain versions:
    elementwise 1e-5 * max|ref|, dots 1e-4 of their Cauchy-Schwarz scale,
    one launch, a repeat bit for bit."""
    offs, vals = WIDE[stencil](shape[1])
    rng = np.random.default_rng(9)
    d = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(cuda_device)
         for k in ("x", "r", "p", "v", "rt")}
    kw = dict(offsets=offs, values=vals, compensated=compensated)

    def run(fn):
        c = {k: v.clone() for k, v in d.items()}
        if kernel == "pv":
            return fn(c["r"], c["p"], c["v"], c["rt"], 0.37, 0.41, **kw)
        if kernel == "st":
            return fn(c["r"], c["v"], 0.83, **kw)
        return fn(c["r"], c["v"], c["x"], c["p"], c["rt"], 0.83, 0.41, **kw)

    T.reset_launch_counts()
    k1, k2 = (run(getattr(TB, f"bicg_{kernel}")) for _ in range(2))
    ref = run(getattr(TB, f"bicg_{kernel}_plain"))
    assert dict(T.LAUNCHES) == {f"bicg_{kernel}": 2}
    nrm = lambda a: torch.linalg.vector_norm(a.double()).item()
    for a, b, want in zip(k1, k2, ref):
        assert torch.equal(a, b)
        err = (a.double() - want.double()).abs().max().item()
        if want.dim():
            assert err <= 1e-5 * want.abs().max().item(), err
    # the dots against the Cauchy-Schwarz scales of their operands
    s = d["r"] - 0.83 * d["v"]
    t = T.apply_plain(s, offs, vals)
    if kernel == "pv":
        scales = [nrm(d["rt"]) * nrm(ref[1])]
    elif kernel == "st":
        scales = [nrm(t) * nrm(s), nrm(t) ** 2]
    else:
        scales = [nrm(ref[1]) ** 2, nrm(d["rt"]) * nrm(ref[1])]
    dots = [(a, b) for a, b in zip(k1, ref) if not b.dim()]
    for (a, want), scale in zip(dots, scales):
        assert abs(a.item() - want.item()) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# Wide z shifts and reach 2..8 off march1 (every 3-D pass on the window
# march) and K1's nop mode
# ---------------------------------------------------------------------------

def _call3d(name, t, kw, compensated=False):
    """A closure running the 3-D pass ``name`` (its LAUNCHES name) once on
    the device tensors ``t`` with device scalars, so that it copies nothing
    from the host and a trace of it holds its kernels alone."""
    a, b, om = (torch.tensor(v, device=t["x"].device)
                for v in (0.83, 0.37, 0.41))
    h = (t["top"], t["bot"])
    k7 = dict(kw, compensated=compensated)
    return {
        "y3d": lambda: T3.grid3d_stencil_matvec(t["x"], *h, **kw),
        "y_dot3d": lambda: T3.grid3d_stencil_matvec(t["x"], *h,
                                                    with_dot=True, **kw),
        "pq3d": lambda: T3.grid3d_cg_pq(t["p"], *h, **kw),
        "update3d": lambda: T3.grid3d_cg_update(t["p"], t["x"], t["r"], a,
                                                *h, **kw),
        "xpay_pq3d": lambda: T3.grid3d_cg_xpay_pq(t["r"], t["p"], b, *h,
                                                  **kw),
        "bicg3d_pv": lambda: TB3.bicg3d_pv(t["r"], t["p"], t["v"], t["rt"],
                                           b, om, *h, **k7),
        "bicg3d_st": lambda: TB3.bicg3d_st(t["r"], t["v"], a, *h, **k7),
        "bicg3d_update": lambda: TB3.bicg3d_update(
            t["r"], t["v"], t["x"], t["p"], t["rt"], a, om, *h, **k7),
    }[name]


def _kernels_of(fn, takes=4):
    """The names of the device kernels one call of ``fn`` launches (no
    memory copy), from a torch.profiler trace, taken again (at most
    ``takes`` times) when it comes back with no kernel: a trace has at
    times lost its device events (chip_smoke.device_kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # a first call makes the wrappers' scratch
    torch.cuda.synchronize()
    for _ in range(takes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        if names:
            return names
    raise AssertionError(f"{takes} traces saw no device kernel")


def _assert_route3d(name, dim, compensated=False):
    """The pass launches what ``T3.route3d`` says: one window-march
    kernel (no second launch, reduce_partials)."""
    t, kw = _tensors(_state3d(41, (20, 7, 129)), "cuda"), _kw3(dim)
    route = T3.route3d(name, kw["offsets"], compensated)
    names = _kernels_of(_call3d(name, t, kw, compensated))
    assert route == "window", route
    assert len(names) == 1 and "win_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("dim", ["wide", "reach2"])
@pytest.mark.parametrize("shape", WIDE3_SHAPES)
@pytest.mark.parametrize("mode", ["y", "y_dot", "pq", "update", "xpay_pq"])
def test_wide3d_k6_matches_plain_on_card(mode, shape, dim, cuda_device):
    """K6a (four modes) and K6b with |oz| up to 128, and with the reach-2
    star, against their plain versions (the bounds above), with random
    halo planes, one launch, a repeat bit for bit (the folded dot's sum
    order depends on the volume alone), and that launch one window-march
    kernel."""
    d = _state3d(23, shape)
    T.reset_launch_counts()
    got, again = (_stencil3d(mode, d, cuda_device, dim) for _ in range(2))
    assert dict(T.LAUNCHES) == {f"{mode}3d": 2}
    assert all(np.array_equal(got[k], again[k]) for k in got)
    ref = _stencil3d(mode, d, cuda_device, dim, plain=True)
    arrays = [v for v in ref.values() if v.ndim]
    _compare3d(got, ref, _norm_bound(d, *arrays))
    _assert_route3d(f"{mode}3d", dim)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", ["wide", "reach2"])
@pytest.mark.parametrize("shape", WIDE3_SHAPES)
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("kernel", ["pv", "st", "update"])
def test_wide3d_k7_matches_plain_on_card(kernel, compensated, shape, dim,
                                         cuda_device):
    """K7 pv, st and update with |oz| up to 128, and with the reach-2 star,
    each on the window march (one kernel); the bounds above, one call each,
    a repeat bit for bit."""
    d = _state3d(29, shape)
    T.reset_launch_counts()
    got, again = (_bicg3d(kernel, d, cuda_device, dim, compensated)
                  for _ in range(2))
    assert dict(T.LAUNCHES) == {f"bicg3d_{kernel}": 2}
    assert all(np.array_equal(got[k], again[k]) for k in got)
    ref = _bicg3d(kernel, d, cuda_device, dim, compensated, plain=True)
    arrays = [v for v in ref.values() if v.ndim]
    _compare3d(got, ref, 26.0 * _norm_bound(d, *arrays))
    _assert_route3d(f"bicg3d_{kernel}", dim, compensated)


@pytest.mark.cuda
@pytest.mark.parametrize("pieces", [1, 4])
def test_wide3d_cg_matches_plain_on_card(pieces, cuda_device, monkeypatch):
    """The wide-z system at (32, 24, 256) through ``entry.
    build_stencil_system(stencil=)``, CG solve(20) on 1 and 4 pieces:
    launches K6a pq, K6b and K6a update exactly (times the pieces), and
    the history and x against the same runner driven by the plain
    versions (rtol 1e-3, x 1e-3 of max|x|)."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    plain = {
        "grid3d_cg_xpay_pq": T3.xpay_pq3d_plain,
        "grid3d_cg_pq": lambda p, top=None, bot=None, **kw:
            T3.stencil3d_plain("pq", p, top, bot, **kw)[0],
        "grid3d_cg_update": lambda p, x, r, alpha, top=None, bot=None, **kw:
            T3.stencil3d_plain("update", p, top, bot, (x, r, alpha), **kw),
    }
    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    mesh = (make_mesh(pieces, devices=[cuda_device] * pieces) if pieces > 1
            else None)
    runs = []
    for use_plain in (False, True):
        planner = build_stencil_system(3, (32, 24, 256), f32, cuda_device,
                                       mesh=mesh, stencil=WIDE3)
        assert planner.row_partitioned_matrices[0][0]._view["kind"] == "3d"
        with monkeypatch.context() as m:
            if use_plain:
                for name, fn in plain.items():
                    m.setattr(T3, name, fn)
            T.reset_launch_counts()
            hist = lt.CGSolver(planner).solve(20).cpu().double().numpy()
        assert dict(T.LAUNCHES) == ({} if use_plain else {
            "pq3d": pieces, "xpay_pq3d": 19 * pieces,
            "update3d": 20 * pieces})
        runs.append((hist, planner.sol_vectors[0].to_numpy()))
    (hk, xk), (hp, xp) = runs
    assert len(hk) == 21 and np.isfinite(hk).all()
    np.testing.assert_allclose(hk, hp, rtol=1e-3)
    np.testing.assert_allclose(xk, xp, rtol=0, atol=1e-3 * np.abs(xp).max())


# Every window-march kernel: (its *_win_attrs and *_attrs entry, which)
WINDOW_KERNELS = {
    **{f"K6a {m}": ("ls_stencil3d", w)
       for w, m in enumerate(("y", "y_dot", "pq", "update"))},
    "K6b xpay_pq": ("ls_stencil3d", 4),
    **{f"K7 {m}{' compensated' if c else ''}": ("ls_bicg3d", 2 * p + c)
       for p, m in enumerate(("pv", "st", "update")) for c in (0, 1)},
}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(WINDOW_KERNELS))
def test_window3d_attrs_on_card(kernel, cuda_device):
    """Each window-march kernel (K6a's four modes, K6b, K7 pv, st and
    update with f32 and compensated dots) with S_wide at 256^3: no spill,
    at least 2 blocks per SM, the shared memory of ``window3d_smem`` and
    the blocks of ``window3d_geometry``; at the largest window the gate
    allows it reports its registers and fits one block per SM."""
    import ctypes

    from legionsolvers_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    kw = _kw3("wide")
    st = ctypes.byref(T3._stencil3_struct(**kw))
    shape = (256, 256, 256)
    fn, which = WINDOW_KERNELS[kernel]
    out = (ctypes.c_int * 5)()
    assert getattr(lib, fn + "_win_attrs")(which, *shape, st, out) == 0
    regs, spill, per_sm, smem, blocks = out
    assert 0 < regs <= 255 and spill == 0 and per_sm >= 2, list(out)
    assert smem == T3.window3d_smem(256, kw["offsets"]), smem
    assert blocks == T3.window3d_geometry(*shape)[2], blocks
    big = (ctypes.c_int * 3)()
    assert getattr(lib, fn + "_attrs")(which, big) == 0
    assert 0 < big[0] <= 255 and big[2] >= 1, list(big)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 4096), (200, 328), (33, 4097),
                                   (1, 5)])
def test_k1_nop_matches_plain_on_card(shape, cuda_device):
    """K1 in mode nop against its plain version: x'', r'', p'' bit for bit,
    g[0] within 1e-5 of its Cauchy-Schwarz scale, g[1..9] zero; a repeat
    bit for bit."""
    rng = np.random.default_rng(31)
    d = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(cuda_device) for k in ("x", "r", "p")}
    coef = torch.full((6,), 0.25, device=cuda_device)
    T.reset_launch_counts()
    runs = []
    for fn in (T._grid2d_cg_nop, T._grid2d_cg_nop, T.nop_plain):
        c = {k: v.clone() for k, v in d.items()}
        runs.append([t.cpu() for t in fn(c["x"], c["r"], c["p"], coef,
                                         **KW)])
    assert dict(T.LAUNCHES) == {"nop": 2}
    k1, k2, ref = runs
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    for have, want in zip(k1[:3], ref[:3]):
        assert torch.equal(have, want)
    scale = (torch.linalg.vector_norm(d["r"].double())
             * torch.linalg.vector_norm(d["p"].double())).item()
    assert abs(k1[3][0].item() - ref[3][0].item()) <= 1e-5 * scale
    assert not k1[3][1:].any()


# ---------------------------------------------------------------------------
# K1 and K2 on the general route ("B (general)"): |dy| <= 1, any |dx| < C
# ---------------------------------------------------------------------------

_S2_GEN = (KW["offsets"] + ((0, 2), (0, -2), (0, 37), (0, -37), (1, 100),
                            (-1, -100), (1, -100), (-1, 100)),
           (7.0, -1.0, -1.0, -1.0, -1.0, -0.5, -0.5, -0.5, -0.5, -0.25,
            -0.25, -0.25, -0.25))
_S2_4X = (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (0, -2), (0, 2)),
          (4.5, -1.0, -1.0, -16 / 12, -16 / 12, 1 / 12, 1 / 12))
GENERAL = {
    "S2_gen": lambda C: _S2_GEN,
    "S2_4x": lambda C: _S2_4X,
    "wide(C)": lambda C: (KW["offsets"] + ((0, 37), (0, -37), (-1, 100),
                                           (1, -(C - 1))),
                          (5.0, -1.0, -1.0, -1.0, -1.0, -0.25, -0.25, -0.5,
                           -0.5)),
    "(+-1, -+(C - 1)), no centre": lambda C: (
        ((0, 3), (1, -(C - 1)), (-1, C - 1), (0, -3)),
        (1.0, -0.25, -0.25, 1.0)),
}
# rows under 8, C not a multiple of 4 or 128, |dx| = C - 1 at 4096
GENERAL_SHAPES = [(16, 128), (5, 130), (1, 101), (33, 4097), (64, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GENERAL_SHAPES)
@pytest.mark.parametrize("stencil", list(GENERAL))
def test_k1_k2_general_match_plain_on_card(stencil, shape, cuda_device):
    """K1 and K2 on the general route against step2_plain and gram2_plain
    (chip_smoke.py's phase 3 bounds: arrays 1e-5 * max|ref|, Gram entries
    1e-4 of their Cauchy-Schwarz scale), one launch each, x updated in
    place, repeats bit for bit."""
    offs, vals = GENERAL[stencil](shape[1])
    if max(abs(dx) for _, dx in offs) >= shape[1]:
        pytest.skip("|dx| >= C: off the gate at this width")
    # K1's band march, or past its gate (|dx| = 4095) the cooperative
    # kernel; K2's band march (its window clipped to the row for
    # |dx| = 4095)
    assert T.route(offs, vals, shape[1], sstep=True)[0] == (
        "general" if T.band_stride(shape[1], offs) else "general_coop")
    assert T.route(offs, vals, shape[1], sstep="gram2")[0] == "general"
    kw = dict(offsets=offs, values=vals)
    rng = np.random.default_rng(37)
    d = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                             ).to(cuda_device) for k in ("x", "r", "p")}
    coef = T.cg2_coeffs(T.gram2_plain(d["r"], d["p"], **kw))[0]
    T.reset_launch_counts()
    runs = []
    for fn in (T.grid2d_cg_step2, T.grid2d_cg_step2, T.step2_plain):
        c = {k: v.clone() for k, v in d.items()}
        res = fn(c["x"], c["r"], c["p"], coef, **kw)
        assert res[0] is c["x"]
        runs.append([t.cpu() for t in res])
    g1, g2, gref = (fn(d["r"], d["p"], **kw).double().cpu() for fn in (
        T.grid2d_cg_gram2, T.grid2d_cg_gram2, T.gram2_plain))
    assert dict(T.LAUNCHES) == {"step2": 2, "gram2": 2}
    k1, k2, ref = runs
    assert all(torch.equal(a, b) for a, b in zip(k1, k2))
    assert torch.equal(g1, g2)
    for have, want in zip(k1[:3], ref[:3]):
        np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * want.abs().max().item())
    bound = gram_bounds(ref[1].numpy(), ref[2].numpy(), offs, vals)
    np.testing.assert_array_less(
        np.abs(k1[3].double().numpy() - ref[3].double().numpy()),
        1e-4 * bound)
    bound = gram_bounds(d["r"].cpu().numpy(), d["p"].cpu().numpy(), offs,
                        vals)
    np.testing.assert_array_less(np.abs((g1 - gref).numpy()), 1e-4 * bound)


def _gram2_ulps(a, b):
    """Units in the last place between two f32 vectors, entrywise."""
    ia, ib = (np.asarray(x, dtype=np.float32).view(np.int32).astype(np.int64)
              for x in (a, b))
    ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return np.abs(ia - ib)


# K2's band march at band and strip edges: a band of 16 rows and a ragged
# last one (37, 203 rows), C not a multiple of 4, two or more strips
# (1030, 4097 columns), and with S2_far and (+-1, -+842) at 4096 columns
# (past K1's gate; the padded window, and the window clipped to the row)
GRAM2_BAND_SHAPES = GENERAL_SHAPES + [(37, 1030), (203, 4096)]
GRAM2_BAND = dict(GENERAL, **{
    "S2_far": lambda C: (tuple((dy, 2 * dx if abs(dx) == 100 else dx)
                               for dy, dx in _S2_GEN[0]), _S2_GEN[1]),
    "(+-1, -+842)": lambda C: (KW["offsets"] + ((1, -842), (-1, 842)),
                               (5.0, -1.0, -1.0, -1.0, -1.0, -0.5, -0.5)),
})


@pytest.mark.cuda
@pytest.mark.parametrize("shape", GRAM2_BAND_SHAPES)
@pytest.mark.parametrize("stencil", list(GRAM2_BAND))
def test_k2_band_matches_plain_and_coop_on_card(stencil, shape,
                                                cuda_device, monkeypatch):
    """K2 on its band march against gram2_plain (Gram entries 1e-4 of
    their Cauchy-Schwarz scale), one launch, a repeat bit for bit, and
    against the cooperative kernel on the same inputs (the route forced):
    A p, A^2 p and A r are the same terms in the same order, so the Gram
    differs only by its double sums' order, at most 1 ulp an entry."""
    offs, vals = GRAM2_BAND[stencil](shape[1])
    if max(abs(dx) for _, dx in offs) >= shape[1]:
        pytest.skip("|dx| >= C: off the gate at this width")
    assert T.route(offs, vals, shape[1], sstep="gram2")[0] == "general"
    kw = dict(offsets=offs, values=vals)
    rng = np.random.default_rng(41)
    r, p = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    rt, pt = (torch.from_numpy(a).to(cuda_device) for a in (r, p))
    T.reset_launch_counts()
    g1, g2, ref = (fn(rt, pt, **kw).cpu() for fn in (
        T.grid2d_cg_gram2, T.grid2d_cg_gram2, T.gram2_plain))
    assert dict(T.LAUNCHES) == {"gram2": 2}
    assert torch.equal(g1, g2)
    np.testing.assert_array_less(
        np.abs(g1.double().numpy() - ref.double().numpy()),
        1e-4 * gram_bounds(r, p, offs, vals))
    route = T.route
    with monkeypatch.context() as m:
        m.setattr(T, "route", lambda o, v, C, sstep=False, bicg=None: (
            ("general_coop", o, v, 0) if sstep == "gram2"
            else route(o, v, C, sstep, bicg)))
        coop = T.grid2d_cg_gram2(rt, pt, **kw).cpu()
    assert _gram2_ulps(g1.numpy(), coop.numpy()).max() <= 1, (g1, coop)


@pytest.mark.cuda
@pytest.mark.parametrize("pieces,spaces", [(1, 1), (4, 1), (1, 2)])
def test_general_sstep_solve_matches_plain_on_card(pieces, spaces,
                                                   cuda_device, monkeypatch):
    """s-step CG solve(41) with S2_gen at (256, 512) through
    ``entry.build_stencil_system(stencil=)`` on one piece, 4 pieces and a
    2-space block: K2 2 and K1 20 per piece and space, K3 update once
    (the odd tail), and the history and x against the same runner driven
    by the plain versions (rtol 1e-3, x 1e-3 of max|x|)."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    mesh = (make_mesh(pieces, devices=[cuda_device] * pieces) if pieces > 1
            else None)
    k = pieces * spaces
    runs = []
    for use_plain in (False, True):
        planner = build_stencil_system(2, (256, 512), f32, cuda_device,
                                       num_spaces=spaces, mesh=mesh,
                                       stencil=list(zip(*_S2_GEN)))
        assert planner.row_partitioned_matrices[0][0].step2_eligible
        with monkeypatch.context() as m:
            if use_plain:
                m.setattr(T, "grid2d_cg_step2", T.step2_plain)
                m.setattr(T, "grid2d_cg_gram2", T.gram2_plain)
            T.reset_launch_counts()
            hist = lt.CGSolver(planner).solve(41).cpu().double().numpy()
        assert dict(T.LAUNCHES) == ({"update": k} if use_plain else {
            "step2": 20 * k, "gram2": 2 * k, "update": k})
        runs.append((hist, [planner.sol_vectors[s].to_numpy()
                            for s in range(spaces)]))
    (hk, xk), (hp, xp) = runs
    assert len(hk) == 42 and np.isfinite(hk).all()
    np.testing.assert_allclose(hk, hp, rtol=1e-3)
    for a, b in zip(xk, xp):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * np.abs(b).max())


@pytest.mark.cuda
def test_general_attrs_on_card(cuda_device):
    """The general route's kernels report their registers and hold at
    least one block per SM (a cooperative launch needs every block
    resident; K1's band march at S2_gen's rings); the library's units
    match ``general_units``."""
    import ctypes

    from legionsolvers_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    for which in (0, 1):
        out = (ctypes.c_int * 3)()
        assert lib.ls_sstep_general_attrs(which, out) == 0
        assert 0 < out[0] <= 255 and out[2] >= 1, list(out)
    for shape in ((4096, 4096), (1024, 4096), (5, 130), (1, 101)):
        assert lib.ls_sstep_general_units(*shape) == T.general_units(*shape)
    # K1's band march: its registers and a block per SM at S2_gen's rings
    st = T._stencil_struct(*_S2_GEN)
    out = (ctypes.c_int * 4)()
    assert lib.ls_step2_band_attrs(4096, ctypes.byref(st), out) == 0
    assert 0 < out[0] <= 255 and out[2] >= 1, list(out)
    # the rings, one more row and a block's width of slack
    stride = T.band_stride(4096, _S2_GEN[0])
    assert out[3] == 4 * ((T.BAND_RING_ROWS + 1) * stride + T.BAND_THREADS)
    # K2's band march: no spill and two blocks per SM at S2_gen's rings,
    # its shared memory as gram2_layout's; the library's gate as the
    # mirror's
    assert lib.ls_gram2_band_attrs(4096, ctypes.byref(st), out) == 0
    assert 0 < out[0] <= 64 and out[1] == 0 and out[2] >= 2, list(out)
    assert out[3] == T.gram2_layout(4096, _S2_GEN[0])[2]
    lay = (ctypes.c_int * 3)()
    for C, q in ((4096, 100), (4096, 841), (4096, 842), (4389, 4388),
                 (5000, 841)):
        assert lib.ls_gram2_band_layout(C, q, lay) == 0
        assert tuple(lay) == T.gram2_layout(C, ((0, q),))


# ---------------------------------------------------------------------------
# K3 and K4 on the band route (csrc/band2d.cu)
# ---------------------------------------------------------------------------

def _flat5(C):
    """The 1-D view of the 5-point 1-D stencil: row-wrap terms with |dx| =
    C - 1 and C - 2."""
    return T.decompose_flat_offsets((0, -1, 1, -2, 2),
                                    (2.5, -1.0, -1.0, 0.25, 0.25), C)


BAND = {"S2_gen": lambda C: _S2_GEN, "S2_4x": lambda C: _S2_4X,
        "wide": _wide2d, "flat5": _flat5}
# phase 4l's edges; a grid shorter than the ring (3 rows, wide's 11) and
# widths under one strip (128, 1000); C % 4 != 0 (130, 4097: scalar
# loads); two strips (4097, 5000); ragged last bands (203 rows of 16,
# 1000 rows of 32 at 4096^2's target); the full grid
BAND_SHAPES = [(8, 128), (37, 1000), (3, 1000), (203, 4096), (3, 4096),
               (33, 130), (33, 4097), (40, 5000), (1000, 4096),
               (4096, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("halos", ["null", "random"])
@pytest.mark.parametrize("stencil", list(BAND))
@pytest.mark.parametrize("shape", BAND_SHAPES)
@pytest.mark.parametrize("mode", ONE_PASS)
def test_band_k3_k4_match_plain_on_card(mode, shape, stencil, halos,
                                        cuda_device):
    """K3 (four modes) and K4 on the band route against their plain
    versions: phase 3's bounds, one launch, a repeat bit for bit."""
    offs, vals = BAND[stencil](shape[1])
    if max(abs(dx) for _, dx in offs) >= shape[1]:
        pytest.skip("|dx| >= C: off the gate at this width")
    if halos == "null" and shape == (4096, 4096):
        pytest.skip("the full grid runs with random halo blocks")
    assert T.route(offs, vals, shape[1])[0] == "band"
    _check_one_pass(mode, _one_pass_state(shape, halos, cuda_device), offs,
                    vals, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ONE_PASS)
def test_band_past_the_gate_keeps_the_tile_kernels_on_card(mode,
                                                           cuda_device):
    """A row span of 17 at 4096 columns is past the band route's gate: K3
    and K4 run the tile kernels and still match their plain versions."""
    offs = KW["offsets"] + ((-8, 100), (8, -4095))
    vals = KW["values"] + (-0.25, -0.25)
    assert T.route(offs, vals, 4096)[0] == "tile"
    _check_one_pass(mode, _one_pass_state((64, 4096), "random",
                                          cuda_device), offs, vals,
                    cuda_device)


def _kernels_of_each(fns, takes=4):
    """For each call in ``fns``, the device kernels it launches, from one
    torch.profiler trace of them all, split at torch's spin kernel run
    after each call (chip_smoke.device_kernels): one trace per batch, as a
    trace of a single call has at times lost its device events; a trace
    that lost some is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:  # a first call makes the wrappers' scratch
        fn()
    torch.cuda.synchronize()
    for _ in range(takes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                fn()
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
        calls, names = [], []
        for _, name in sorted((e.time_range.start, e.name)
                              for e in prof.events()
                              if e.device_type == DeviceType.CUDA):
            if "spin_kernel" in name:
                calls.append(names)
                names = []
            elif not name.startswith(("Memcpy", "Memset")):
                names.append(name)
        if len(calls) == len(fns) and not names and all(calls):
            return calls
    raise AssertionError(f"{takes} traces of {len(fns)} calls lost device "
                         "events")


@pytest.mark.cuda
@pytest.mark.parametrize("stencil", ["S2_gen", "wide"])
def test_band_one_launch_on_card(stencil, cuda_device):
    """Each band-route pass (K3's four modes, K4) is one kernel, the band
    march's, and no reduce_partials (one profiler trace of the five)."""
    offs, vals = BAND[stencil](1000)
    kw = dict(offsets=offs, values=vals)
    d = _one_pass_state((96, 1000), "random", cuda_device)
    d["alpha"] = d["alpha"] * 1e-3
    calls = _kernels_of_each([lambda m=m: _one_pass(m, d, kw)
                              for m in ONE_PASS])
    for mode, names in zip(ONE_PASS, calls):
        assert len(names) == 1 and "band_pass_kernel" in names[0], (mode,
                                                                   names)


@pytest.mark.cuda
def test_band_geometry_gate_and_attrs_on_card(cuda_device):
    """The library's band geometry and ring layout equal the Python
    mirror's; every pass's kernel (K3's four modes, K4, K5a, K5b, K5c)
    fits one block per SM at each stencil's ring, with no spill, within
    128 registers."""
    import ctypes

    from legionsolvers_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    out = (ctypes.c_int * 4)()
    for shape in BAND_SHAPES + [(1024, 4096), (1, 101)]:
        assert lib.ls_pass_band_geometry(*shape, out) == 0
        assert tuple(out) == T.pass_geometry(*shape), shape
    for name, fn in BAND.items():
        for C in (1000, 4096, 5000):
            offs, vals = fn(C)
            st = T._stencil_struct(offs, vals)
            assert lib.ls_pass_band_layout(C, ctypes.byref(st), out) == 0
            assert tuple(out) == T.pass_layout(C, offs), (name, C)
            for which in range(8):
                assert lib.ls_pass_band_attrs(which, C, ctypes.byref(st),
                                              out) == 0
                assert 0 < out[0] <= 128 and out[1] == 0, (name, C, which,
                                                          list(out))
                assert out[2] >= 1 and out[3] == T.pass_layout(C, offs)[3]


@pytest.mark.cuda
@pytest.mark.parametrize("pieces", [1, 4])
def test_band_two_pass_solve_matches_plain_on_card(pieces, cuda_device,
                                                   monkeypatch):
    """Two-pass CG solve(40) (LEGIONSOLVERS_NO_SSTEP) with S2_gen at (256,
    512) on one piece and 4 pieces: K3 pq 1, update 40 and K4 39 per piece
    on the band route, and the history and x against the same runner
    driven by the plain versions (rtol 1e-3, x 1e-3 of max|x|)."""
    import legionsolvers_tpu_torch as lt
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.parallel.mesh import make_mesh

    f32 = lt.SolverOptions(entry_dtype=torch.float32)
    mesh = (make_mesh(pieces, devices=[cuda_device] * pieces) if pieces > 1
            else None)
    monkeypatch.setenv("LEGIONSOLVERS_NO_SSTEP", "1")
    assert T.route(*_S2_GEN, 512)[0] == "band"
    runs = []
    for use_plain in (False, True):
        planner = build_stencil_system(2, (256, 512), f32, cuda_device,
                                       mesh=mesh,
                                       stencil=list(zip(*_S2_GEN)))
        with monkeypatch.context() as m:
            if use_plain:
                plain = {
                    "grid2d_cg_pq": lambda p, top=None, bot=None, **kw:
                        T.stencil_plain("pq", p, top, bot, **kw)[0],
                    "grid2d_cg_update": lambda p, x, r, a, top=None,
                        bot=None, **kw: T.stencil_plain(
                            "update", p, top, bot, (x, r, a), **kw),
                    "grid2d_cg_xpay_pq": T.xpay_pq_plain}
                for k, fn in plain.items():
                    m.setattr(T, k, fn)
            T.reset_launch_counts()
            hist = lt.CGSolver(planner).solve(40).cpu().double().numpy()
        assert dict(T.LAUNCHES) == ({} if use_plain else {
            "pq": pieces, "update": 40 * pieces, "xpay_pq": 39 * pieces})
        runs.append((hist, planner.sol_vectors[0].to_numpy()))
    (hk, xk), (hp, xp) = runs
    assert len(hk) == 41 and np.isfinite(hk).all()
    np.testing.assert_allclose(hk, hp, rtol=1e-3)
    np.testing.assert_allclose(xk, xp, rtol=0, atol=1e-3 * np.abs(xp).max())


# ---------------------------------------------------------------------------
# K5a (bicg_pv), K5b (bicg_st) and K5c (bicg_update) on the band route
# (csrc/band2d.cu)
# ---------------------------------------------------------------------------

# chip_smoke.py's BAND_EDGE_SHAPES, and the full grid
BAND_K5_SHAPES = [(8, 128), (37, 1000), (3, 1000), (203, 4096), (33, 130),
                  (40, 5000), (1024, 4096), (4096, 4096)]


def _cs(a, b):
    """The Cauchy-Schwarz scale of <a, b>: sqrt(<a, a> <b, b>)."""
    return float(np.sqrt((np.square(a, dtype=np.float64).sum())
                         * np.square(b, dtype=np.float64).sum()))


def _k5_close(kernel, d, got, ref, kw):
    """K5a's p' and v', and K5c's x' and r', within 2e-5 * max|ref|, and
    each dot of K5a, K5b or K5c within 1e-4 of its Cauchy-Schwarz scale
    (phase 3's dot bound)."""
    vecs = {"pv": ("p", "v"), "st": (), "update": ("x", "r")}[kernel]
    for key in vecs:
        np.testing.assert_allclose(got[key], ref[key], rtol=0,
                                   atol=2e-5 * np.abs(ref[key]).max(),
                                   err_msg=key)
    if kernel == "pv":
        bounds = {"rtv": _cs(d["rt"], ref["v"])}
    elif kernel == "update":
        bounds = {"rr": _cs(ref["r"], ref["r"]), "rtr": _cs(d["rt"], ref["r"])}
    else:
        s = d["r"] - np.float32(0.83) * d["v"]
        a = T.apply_plain(torch.from_numpy(s), **kw).numpy()
        bounds = {"ts": _cs(a, s), "tt": _cs(a, a)}
    for key, scale in bounds.items():
        assert abs(got[key] - ref[key]) <= 1e-4 * scale, key


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("stencil", ["S2_gen", "S2_4x", "wide"])
@pytest.mark.parametrize("shape", BAND_K5_SHAPES)
@pytest.mark.parametrize("kernel", ["pv", "st", "update"])
def test_band_k5_match_plain_on_card(kernel, shape, stencil, compensated,
                                     cuda_device):
    """K5a, K5b and K5c on the band route against their plain versions:
    p' and v', x' and r' within 2e-5 * max|ref|, each dot within 1e-4 of
    its Cauchy-Schwarz scale (phase 3's dot bound; the kernel sums exact
    or f32-rounded products in float64, the plain version in f32),
    compensated <r~, v'>, <r', r'> and <r~, r'> within 4e-7 of the
    float64 sums of the kernel's own operands; one launch; a repeat bit
    for bit."""
    offs, vals = BAND[stencil](shape[1])
    if max(abs(dx) for _, dx in offs) >= shape[1]:
        pytest.skip("|dx| >= C: off the gate at this width")
    assert T.route(offs, vals, shape[1], bicg=kernel)[0] == "band"
    kw = dict(offsets=offs, values=vals)
    rng = np.random.default_rng(shape[0] + shape[1])
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("r", "p", "v", "rt", "x")}
    T.reset_launch_counts()
    got = _bicg(kernel, d, cuda_device, compensated, stencil=kw)
    again = _bicg(kernel, d, cuda_device, compensated, stencil=kw)
    assert dict(T.LAUNCHES) == {f"bicg_{kernel}": 2}
    for key in got:
        np.testing.assert_array_equal(got[key], again[key], err_msg=key)
    ref = _bicg(kernel, d, cuda_device, compensated, plain=True, stencil=kw)
    _k5_close(kernel, d, got, ref, kw)
    if compensated and kernel != "st":
        rt = d["rt"].astype(np.float64)
        pairs = ({"rtv": (rt, got["v"])} if kernel == "pv" else
                 {"rr": (got["r"], got["r"]), "rtr": (rt, got["r"])})
        for key, (a, b) in pairs.items():
            exact = (a * b).sum()
            assert abs(got[key] - exact) <= 4e-7 * abs(exact), key


@pytest.mark.cuda
@pytest.mark.parametrize("stencil", ["S2_gen", "wide"])
def test_band_k5_one_launch_on_card(stencil, cuda_device):
    """K5a, K5b and K5c on the band route are one kernel each, the band
    march's, and no reduce_partials (one profiler trace of the three, f32
    and compensated dots)."""
    offs, vals = BAND[stencil](1000)
    rng = np.random.default_rng(3)
    t = {k: torch.from_numpy(rng.standard_normal((96, 1000))
                             .astype(np.float32)).to(cuda_device)
         for k in ("r", "p", "v", "rt", "x")}
    out = (torch.empty_like(t["p"]), torch.empty_like(t["v"]))
    r_out = torch.empty_like(t["r"])
    fns = []
    for comp in (False, True):
        kw = dict(offsets=offs, values=vals, compensated=comp)
        fns += [lambda kw=kw: TB.bicg_pv(t["r"], t["p"], t["v"], t["rt"],
                                         0.37, 0.41, out=out, **kw),
                lambda kw=kw: TB.bicg_st(t["r"], t["v"], 0.83, **kw),
                lambda kw=kw: TB.bicg_update(t["r"], t["v"], t["x"], t["p"],
                                             t["rt"], 8.3e-4, 0.41,
                                             out=r_out, **kw)]
    for names in _kernels_of_each(fns):
        assert len(names) == 1 and "band_pass_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("stencil", ["S2_gen", "S2_4x", "wide"])
def test_band_k5c_x_in_place_r_to_out_on_card(stencil, cuda_device):
    """K5c on the band route writes x' into the x it was given and r' into
    ``out``, and returns those two tensors; r, v, p and r~ are left as
    they were (the bounds of the band cases above)."""
    offs, vals = BAND[stencil](4096)
    kw = dict(offsets=offs, values=vals)
    assert T.route(offs, vals, 4096, bicg="update")[0] == "band"
    rng = np.random.default_rng(6)
    d = {k: rng.standard_normal((203, 4096)).astype(np.float32)
         for k in ("r", "p", "v", "rt", "x")}
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in d.items()}
    keep = {k: v.clone() for k, v in t.items()}
    out = torch.full_like(t["r"], float("nan"))
    x, rn, rr, rtr = TB.bicg_update(t["r"], t["v"], t["x"], t["p"], t["rt"],
                                    0.83, 0.41, out=out, **kw)
    assert x is t["x"] and rn is out
    for k in ("r", "p", "v", "rt"):
        assert torch.equal(t[k], keep[k]), k
    got = {"x": x, "r": rn, "rr": rr, "rtr": rtr}
    got = {k: v.double().cpu().numpy() for k, v in got.items()}
    ref = _bicg("update", d, cuda_device, False, plain=True, stencil=kw)
    _k5_close("update", d, got, ref, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["pv", "st", "update"])
def test_band_k5_past_the_gate_keeps_the_tile_kernels_on_card(kernel,
                                                              cuda_device):
    """A row span of 17 at 4096 columns is past the band route's gate:
    K5a-c run the tile kernels (and their second launch) and still match
    their plain versions (the bounds of the band cases above)."""
    offs = KW["offsets"] + ((-8, 100), (8, -4095))
    vals = KW["values"] + (-0.25, -0.25)
    assert T.route(offs, vals, 4096, bicg=kernel)[0] == "tile"
    kw = dict(offsets=offs, values=vals)
    rng = np.random.default_rng(4)
    d = {k: rng.standard_normal((64, 4096)).astype(np.float32)
         for k in ("r", "p", "v", "rt", "x")}
    got = _bicg(kernel, d, cuda_device, False, stencil=kw)
    ref = _bicg(kernel, d, cuda_device, False, plain=True, stencil=kw)
    _k5_close(kernel, d, got, ref, kw)
