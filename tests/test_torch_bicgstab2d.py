"""The port's BiCGStab passes (K5) and compensated dots against the JAX package.

The same inputs, made with numpy from a seed, go through JAX's Pallas
passes ``bicg_pv``/``bicg_st``/``bicg_update`` (interpret mode, as test_23
and test_25 run them) and the plain PyTorch versions the port's wrappers
take on CPU tensors, with compensated dots off and on.  The plain versions
are also held against a dense float64 oracle of the same recurrence, and
``ops/ddsum.py`` against JAX's ``dd_dot`` and a float64 sum.

Tolerances: elementwise outputs atol 2e-5 * max|ref| and dots rtol 2e-4
(test_23's: f32 rounding in another order); under compensation, each dot
within 4e-7 relative of a float64 sum of the same f32 operands (test_25's
bound: f32 representation of an exactly accumulated sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legionsolvers_tpu.ops import ddsum as JD
from legionsolvers_tpu.ops.pallas import bicgstab2d as JB
import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu_torch.ops import ddsum as TD
from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
from legionsolvers_tpu_torch.ops.cuda.stencil2d import apply_plain
from torch_stencil_cases import KW, OFFS, VALS, apply_np

torch.set_num_threads(2)

KERNELS = ["pv", "st", "update"]
ALPHA, BETA, OMEGA = 0.83, 0.37, 0.41
ELEMENTWISE = {"p", "v", "x", "r"}
DEV = "cpu"


def make_state(shape, seed=7):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k in ("x", "r", "p", "v", "rt")}


def run_jax(kernel, st, compensated, stencil=KW):
    a = {k: jnp.asarray(v) for k, v in st.items()}
    kw = dict(stencil, interpret=True, compensated=compensated)
    if kernel == "pv":
        out = JB.bicg_pv(a["r"], a["p"], a["v"], a["rt"], BETA, OMEGA, **kw)
        names = ("p", "v", "rtv")
    elif kernel == "st":
        out = JB.bicg_st(a["r"], a["v"], ALPHA, **kw)
        names = ("ts", "tt")
    else:
        out = JB.bicg_update(a["r"], a["v"], a["x"], a["p"], a["rt"], ALPHA,
                             OMEGA, **kw)
        names = ("x", "r", "rr", "rtr")
    return {k: np.asarray(v, np.float64) for k, v in zip(names, out)}


def run_port(kernel, st, compensated, device="cpu", stencil=KW):
    t = {k: torch.tensor(v, device=device) for k, v in st.items()}
    kw = dict(stencil, compensated=compensated)
    if kernel == "pv":
        out = TB.bicg_pv(t["r"], t["p"], t["v"], t["rt"], BETA, OMEGA, **kw)
        names = ("p", "v", "rtv")
    elif kernel == "st":
        out = TB.bicg_st(t["r"], t["v"], ALPHA, **kw)
        names = ("ts", "tt")
    else:
        out = TB.bicg_update(t["r"], t["v"], t["x"], t["p"], t["rt"], ALPHA,
                             OMEGA, **kw)
        names = ("x", "r", "rr", "rtr")
    return {k: v.double().cpu().numpy() for k, v in zip(names, out)}


def run_oracle(kernel, st):
    """Dense float64 version of each pass."""
    x, r, p, v, rt = (st[k].astype(np.float64)
                      for k in ("x", "r", "p", "v", "rt"))
    if kernel == "pv":
        pn = r + BETA * (p - OMEGA * v)
        vn = apply_np(pn)
        return {"p": pn, "v": vn, "rtv": (rt * vn).sum()}
    s = r - ALPHA * v
    t = apply_np(s)
    if kernel == "st":
        return {"ts": (t * s).sum(), "tt": (t * t).sum()}
    rn = s - OMEGA * t
    return {"x": x + ALPHA * p + OMEGA * s, "r": rn, "rr": (rn * rn).sum(),
            "rtr": (rt * rn).sum()}


def assert_close(got, want, dot_rtol=2e-4, dot_atol=None):
    for key, ref in want.items():
        have = np.asarray(got[key])
        if key in ELEMENTWISE:
            np.testing.assert_allclose(have, ref, rtol=0,
                                       atol=2e-5 * np.abs(ref).max(),
                                       err_msg=key)
        else:
            atol = 0.0 if dot_atol is None else dot_atol.get(key, 0.0)
            np.testing.assert_allclose(have, ref, rtol=dot_rtol, atol=atol,
                                       err_msg=key)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("shape", [(32, 128), (64, 256)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_jax(kernel, shape, compensated):
    st = make_state(shape)
    assert_close(run_port(kernel, st, compensated),
                 run_jax(kernel, st, compensated))


# The band route's stencils (phase 4n's S2_gen and S2_4x, phase 4l's wide
# stencil at C = 256: (1, -255) and a term 8 rows up), as
# test_torch_band_pass.py builds them
WIDE_STENCILS = {
    "S2_gen": dict(offsets=OFFS + ((0, 2), (0, -2), (0, 37), (0, -37),
                                   (1, 100), (-1, -100), (1, -100),
                                   (-1, 100)),
                   values=(7.0,) + (-1.0,) * 4 + (-0.5,) * 4 + (-0.25,) * 4),
    "S2_4x": dict(offsets=OFFS + ((0, -2), (0, 2)),
                  values=(4.5, -1.0, -1.0, -16 / 12, -16 / 12, 1 / 12,
                          1 / 12)),
    "wide_kw": dict(offsets=OFFS + ((0, 37), (0, -37), (1, -255),
                                    (-8, 100)),
                    values=VALS + (-0.25, -0.25, -0.5, -0.125)),
}


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("stencil", list(WIDE_STENCILS))
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_jax_band_stencils(kernel, stencil, compensated):
    """K5a-c's plain versions against JAX's passes in interpret mode with
    the stencils that K5a-c take on the band route, at (32, 256), a shape
    JAX's gate takes (C % 128 == 0): the tolerances above."""
    kw = WIDE_STENCILS[stencil]
    assert JB.bicgstab_supported(32, 256, kw["offsets"])
    st = make_state((32, 256), seed=17)
    assert_close(run_port(kernel, st, compensated, stencil=kw),
                 run_jax(kernel, st, compensated, stencil=kw))


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("shape", [(32, 128), (30, 100)])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_fp64_oracle(kernel, shape, compensated):
    """(30, 100) is a shape the TPU gate refuses and the port takes.  <r~, r'>
    of random vectors nearly cancels, so it gets test_23's atol."""
    st = make_state(shape, seed=11)
    assert_close(run_port(kernel, st, compensated), run_oracle(kernel, st),
                 dot_atol={"rtr": 1e-2})


@pytest.mark.parametrize("kernel", KERNELS)
def test_compensated_dots_are_f64_sums_of_the_f32_operands(kernel):
    """test_25's bound: each compensated dot within 4e-7 relative of the
    float64 sum of the f32 operands the pass formed."""
    st = make_state((32, 128))
    got = run_port(kernel, st, compensated=True)
    t = {k: torch.tensor(v) for k, v in st.items()}
    if kernel == "pv":
        want = {"rtv": (st["rt"].astype(np.float64) * got["v"]).sum()}
    elif kernel == "st":
        s = (t["r"] - ALPHA * t["v"])
        tt = apply_plain(s, OFFS, VALS)
        s64, t64 = s.double().numpy(), tt.double().numpy()
        want = {"ts": (t64 * s64).sum(), "tt": (t64 * t64).sum()}
    else:
        rn = got["r"]
        want = {"rr": (rn * rn).sum(),
                "rtr": (st["rt"].astype(np.float64) * rn).sum()}
    for key, ref in want.items():
        assert abs(got[key] - ref) <= 4e-7 * abs(ref), key


def test_update_writes_x_in_place_and_r_to_out():
    st = make_state((32, 128))
    t = {k: torch.tensor(v) for k, v in st.items()}
    out = torch.empty_like(t["r"])
    r_in = t["r"].clone()
    x, rn, _, _ = TB.bicg_update(t["r"], t["v"], t["x"], t["p"], t["rt"],
                                 ALPHA, OMEGA, out=out, **KW)
    assert x is t["x"] and rn is out
    assert torch.equal(t["r"], r_in)


@pytest.mark.parametrize("call", ["pv_out_is_p", "update_out_is_r",
                                  "update_x_is_v", "pv_float64"])
def test_wrappers_refuse(call):
    st = make_state((32, 128))
    t = {k: torch.tensor(v) for k, v in st.items()}
    fn = {
        "pv_out_is_p": lambda: TB.bicg_pv(
            t["r"], t["p"], t["v"], t["rt"], BETA, OMEGA,
            out=(t["p"], torch.empty_like(t["v"])), **KW),
        "update_out_is_r": lambda: TB.bicg_update(
            t["r"], t["v"], t["x"], t["p"], t["rt"], ALPHA, OMEGA,
            out=t["r"], **KW),
        "update_x_is_v": lambda: TB.bicg_update(
            t["r"], t["v"], t["v"], t["p"], t["rt"], ALPHA, OMEGA, **KW),
        "pv_float64": lambda: TB.bicg_pv(
            *(t[k].double() for k in ("r", "p", "v", "rt")), BETA, OMEGA,
            **KW),
    }[call]
    with pytest.raises((TypeError, ValueError)):
        fn()


def test_launch_counts_stay_zero_on_cpu():
    from legionsolvers_tpu_torch.ops.cuda import stencil2d

    stencil2d.reset_launch_counts()
    for kernel in KERNELS:
        run_port(kernel, make_state((32, 128)), compensated=False)
    assert sum(stencil2d.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,C,offs,want", [
    (4096, 4096, OFFS, True),
    (200, 328, OFFS, True),
    (4096, 100, OFFS, True),       # JAX refuses: C % 128 != 0
    (33, 7, OFFS, True),           # JAX refuses: R not a multiple of 8
    (64, 128, OFFS + ((9, 0),), False),
    (64, 128, OFFS + ((0, -128),), False),  # |dx| = C
    (64, 128, tuple((0, k - 16) for k in range(33)), False),
    (64, 128, OFFS + ((0, -9),), True),     # any |dx| < C, as JAX
])
def test_bicgstab_supported(R, C, offs, want):
    assert TB.bicgstab_supported(R, C, offs) is want


def test_bicgstab_supported_f32_only():
    assert not TB.bicgstab_supported(64, 128, OFFS, itemsize=8)
    assert JB.bicgstab_supported(4096, 4096, OFFS)


def _op(shape, dtype=torch.float32, stencil=None):
    n = int(np.prod(shape))
    return T.StencilOperator(
        shape, stencil or T.laplacian_stencil(len(shape)),
        partition=T.BlockPartition(n, 1),
        options=T.SolverOptions(entry_dtype=dtype), device=DEV)


def test_supports_fused_bicgstab(monkeypatch):
    """2-D and 3-D kernel views have a fused runner (K5, K7), also with a
    z shift past 8 (read beside the window); the 1-D linearized path and a
    3-D stencil beyond the kernels' reach (|oy| > 8) do not."""
    wide = T.laplacian_stencil(3) + [((0, 0, 9), -0.5)]
    far = T.laplacian_stencil(3) + [((0, 9, 0), -0.5)]
    assert _op((32, 128)).supports_fused_bicgstab
    assert _op((30, 100)).supports_fused_bicgstab
    assert _op((4, 8, 16)).supports_fused_bicgstab
    assert _op((4, 8, 16), stencil=wide).supports_fused_bicgstab
    assert not _op((32, 128), torch.float64).supports_fused_bicgstab
    assert not _op((64,)).supports_fused_bicgstab
    assert not _op((4, 8, 16), stencil=far).supports_fused_bicgstab
    assert _op((4, 8, 16), stencil=far).make_fused_bicgstab_runner(3) is None
    monkeypatch.setenv("LEGIONSOLVERS_NO_FUSED_BICGSTAB", "1")
    assert not _op((32, 128)).supports_fused_bicgstab
    assert not _op((4, 8, 16)).supports_fused_bicgstab


# ---------------------------------------------------------------------------
# ops/ddsum.py
# ---------------------------------------------------------------------------

def test_eft_identities_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096).astype(np.float32) * 1e3
    b = rng.standard_normal(4096).astype(np.float32) * 1e-3
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    s, e = TD.two_sum(ta, tb)
    np.testing.assert_array_equal(s.double() + e.double(),
                                  torch.from_numpy(a.astype(np.float64) + b))
    p, pe = TD.two_prod(ta, tb)
    np.testing.assert_array_equal(p.double() + pe.double(),
                                  torch.from_numpy(a.astype(np.float64) * b))
    # the same bits as the JAX transformations
    js, je = JD.two_sum(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    jp, jpe = JD.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(pe.numpy(), np.asarray(jpe))
    h, l = TD.dd_add(s, e, p, pe)
    jh, jl = JD.dd_add(js, je, jp, jpe)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


def test_dd_dot_cancellation():
    """test_25's catastrophically cancelling dot (condition > 1e8): plain
    f32 loses every digit; dd_dot keeps f32-representation accuracy, as
    JAX's dd_dot does."""
    rng = np.random.default_rng(1)
    half = (1 << 19) - 1
    z = rng.standard_normal(half).astype(np.float32)
    w = rng.standard_normal(half).astype(np.float32)
    x = np.concatenate([z, z, np.float32([1.0, 0.0])])
    y = np.concatenate([w, -w, np.float32([1e-3, 0.0])])
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    naive = float(torch.sum(torch.from_numpy(x) * torch.from_numpy(y)))
    ours = float(TD.dd_dot(torch.from_numpy(x), torch.from_numpy(y)))
    theirs = float(JD.dd_dot(jnp.asarray(x), jnp.asarray(y)))
    assert abs(naive - exact) / exact > 1e-2
    assert abs(ours - exact) <= 0.5 * np.spacing(np.float32(exact))
    assert abs(ours - theirs) / exact < 1e-4


@pytest.mark.parametrize("n", [100, 127, 1000, 4097])
def test_dd_dot_odd_sizes(n):
    rng = np.random.default_rng(2)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    ours = TD.dd_dot(torch.from_numpy(x), torch.from_numpy(y))
    assert ours.dtype == torch.float32 and ours.dim() == 0
    assert float(ours) == np.float32(exact)
    theirs = float(JD.dd_dot(jnp.asarray(x), jnp.asarray(y)))
    assert abs(float(ours) - theirs) <= 2e-7 * abs(exact) + 1e-6


@pytest.mark.parametrize("compensated", [False, True])
def test_planner_dot_compensated_flag(compensated):
    """Mirrors test_25's planner check, against the JAX planner too."""
    rng = np.random.default_rng(3)
    n = 1 << 16
    x = rng.standard_normal(n).astype(np.float32)
    y = (-x + (1e-5 * rng.standard_normal(n)).astype(np.float32)).astype(
        np.float32)
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    part = T.BlockPartition(n, 1)
    F = T.SolverOptions(entry_dtype=torch.float32,
                        compensated_dots=compensated)
    pl = T.SquarePlanner(options=F, device=DEV)
    pl.add_sol_vector(T.PartitionedVector.from_array("x", x, part, options=F,
                                                     device=DEV))
    pl.add_rhs_vector(T.PartitionedVector.from_array("y", y, part, options=F,
                                                     device=DEV))
    d = pl.dot(0, 1).value
    assert d.dtype == torch.float32
    FJ = J.SolverOptions(entry_dtype=jnp.float32,
                         compensated_dots=compensated)
    plj = J.SquarePlanner(mesh=None, options=FJ)
    partj = J.BlockPartition(n, 1)
    for name, a, add in (("x", x, plj.add_sol_vector),
                         ("y", y, plj.add_rhs_vector)):
        v = J.PartitionedVector(name, partj, options=FJ)
        v.data = jnp.asarray(a)
        add(v)
    dj = float(plj.dot(0, 1).value)
    if compensated:
        assert abs(float(d) - exact) / abs(exact) < 1e-5
        assert abs(float(d) - dj) / abs(exact) < 1e-5
    else:
        np.testing.assert_allclose(float(d), dj, rtol=1e-3)


def test_compensated_default_read_at_construction(monkeypatch):
    monkeypatch.setenv("LEGIONSOLVERS_COMPENSATED_DOTS", "1")
    assert T.SolverOptions().compensated_dots
    assert J.SolverOptions().compensated_dots
    monkeypatch.setenv("LEGIONSOLVERS_COMPENSATED_DOTS", "0")
    assert not T.SolverOptions().compensated_dots
