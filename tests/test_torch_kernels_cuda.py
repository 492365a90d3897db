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
repeat bit for bit; K10 at the interface's caps.  A 2-D solve(40) on the
card is held entry by entry against the same schedule driven by the plain
versions.
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



def _bicg(kernel, d, device, compensated, plain=False):
    """One K5 pass on copies of ``d`` on ``device``: the wrapper, or with
    ``plain`` its plain version."""
    t = {k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()}
    kw = dict(KW, compensated=compensated)
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
# weights); the 11-point star with arms of 2 in y and z (reach 2: march3d).
STENCILS3 = [3, 4, "box10", "reach2"]


def _kw3(dim):
    import legionsolvers_tpu_torch as lt

    if dim == "box10":
        rng = np.random.default_rng(10)
        box = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
               for c in (-1, 0, 1)]
        pick = rng.choice(len(box), 10, replace=False)
        return dict(offsets=tuple(box[k] for k in pick),
                    values=tuple(float(v) for v in rng.uniform(-1, 1, 10)))
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
    for every block of either march's launch (no card needed)."""
    capacity = T3.march_scratch_size(*shape)
    entries = T3.march_scratch_entries(*shape)
    for blocks in (T3.blocks3d(*shape), T3.march1_geometry(*shape)[2]):
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
