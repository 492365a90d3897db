"""The port's 3-D BiCGStab passes (K7) against the JAX package.

The same inputs, made with numpy from a seed, with random nonzero halo
planes, go through JAX's Pallas passes ``bicg3d_pv``/``bicg3d_st``/
``bicg3d_update`` (interpret mode, as test_23 runs them) and the plain
PyTorch versions the port's wrappers take on CPU tensors, for the 7- and
27-point stencils, with compensated dots off and on.  A ragged shape the
TPU gate refuses is held against a dense float64 oracle.

Tolerances: elementwise outputs atol 2e-5 * max|ref| (test_23's); dots
rtol 1e-5 of their Cauchy-Schwarz scale sqrt(<a,a><b,b>) (f32 sums in
another order: <r~, v'> and <r~, r'> of random vectors nearly cancel, so
a plain relative bound would measure the cancellation).  Under
compensation each of the port's dots equals the port's ``dd_dot`` of its
own f32 operands, and is within 4e-7 relative of their float64 sum
(test_25's bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu_torch as T
from legionsolvers_tpu.ops.pallas import bicgstab3d as JB3
from legionsolvers_tpu_torch.ops.ddsum import dd_dot
from legionsolvers_tpu_torch.ops.cuda import bicgstab3d as TB3
from legionsolvers_tpu_torch.ops.cuda import stencil2d as T2
from legionsolvers_tpu_torch.ops.cuda.stencil3d import apply_planes_plain

torch.set_num_threads(2)

KERNELS = ["pv", "st", "update"]
ALPHA, BETA, OMEGA = 0.83, 0.37, 0.41
ELEMENTWISE = {"p", "v", "x", "r"}
NAMES = {"pv": ("p", "v", "rtv"), "st": ("ts", "tt"),
         "update": ("x", "r", "rr", "rtr")}


def stencil_kw(dim):
    st = T.laplacian_stencil(dim)
    return dict(offsets=tuple(o for o, _ in st),
                values=tuple(v for _, v in st))


def make_state(shape, seed=7, halos=True):
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p", "v", "rt")}
    for k in ("top", "bot"):
        d[k] = (rng.standard_normal(shape[1:]).astype(np.float32) if halos
                else np.zeros(shape[1:], np.float32))
    return d


def run_jax(kernel, st, kw, compensated):
    a = {k: jnp.asarray(v) for k, v in st.items()}
    h = (a["top"], a["bot"])
    kw = dict(kw, interpret=True, compensated=compensated)
    if kernel == "pv":
        out = JB3.bicg3d_pv(a["r"], a["p"], a["v"], a["rt"], BETA, OMEGA, *h,
                            **kw)
    elif kernel == "st":
        out = JB3.bicg3d_st(a["r"], a["v"], ALPHA, *h, **kw)
    else:
        out = JB3.bicg3d_update(a["r"], a["v"], a["x"], a["p"], a["rt"],
                                ALPHA, OMEGA, *h, **kw)
    return {k: np.asarray(v, np.float64) for k, v in zip(NAMES[kernel], out)}


def run_port(kernel, st, kw, compensated, device="cpu"):
    t = {k: torch.tensor(v, device=device) for k, v in st.items()}
    h = (t["top"], t["bot"])
    kw = dict(kw, compensated=compensated)
    if kernel == "pv":
        out = TB3.bicg3d_pv(t["r"], t["p"], t["v"], t["rt"], BETA, OMEGA, *h,
                            **kw)
    elif kernel == "st":
        out = TB3.bicg3d_st(t["r"], t["v"], ALPHA, *h, **kw)
    else:
        out = TB3.bicg3d_update(t["r"], t["v"], t["x"], t["p"], t["rt"],
                                ALPHA, OMEGA, *h, **kw)
    return {k: v for k, v in zip(NAMES[kernel], out)}


def operands(kernel, st, got, kw):
    """The f32 operand pair of each dot, as the port's pass formed it."""
    t = {k: torch.tensor(v) for k, v in st.items()}
    if kernel == "pv":
        return {"rtv": (t["rt"], got["v"])}
    if kernel == "update":
        return {"rr": (got["r"], got["r"]), "rtr": (t["rt"], got["r"])}
    s = t["r"] - torch.tensor(ALPHA, dtype=torch.float32) * t["v"]
    tt = apply_planes_plain(s, kw["offsets"], kw["values"], t["top"],
                            t["bot"])
    return {"ts": (tt, s), "tt": (tt, tt)}


def assert_close(got, want, ops):
    for key, ref in want.items():
        have = np.asarray(got[key].double())
        if key in ELEMENTWISE:
            np.testing.assert_allclose(have, ref, rtol=0,
                                       atol=2e-5 * np.abs(ref).max(),
                                       err_msg=key)
        else:
            a, b = (np.linalg.norm(v.double().numpy()) for v in ops[key])
            assert abs(float(have) - float(ref)) <= 1e-5 * a * b, key


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("kernel", KERNELS)
def test_plain_matches_jax(kernel, dim, compensated):
    kw = stencil_kw(dim)
    st = make_state((8, 8, 128), seed=dim)
    got = run_port(kernel, st, kw, compensated)
    ops = operands(kernel, st, got, kw)
    assert_close(got, run_jax(kernel, st, kw, compensated), ops)
    if compensated:
        for key, (a, b) in ops.items():
            assert float(got[key]) == float(dd_dot(a, b)), key
            exact = float((a.double() * b.double()).sum())
            assert abs(float(got[key]) - exact) <= 4e-7 * abs(exact), key


def oracle(kernel, st, shape, dim):
    """Dense float64 version of each pass (zero halos), with the port's COO
    stencil matrix."""
    A = T.create_coo_stencil_matrix(shape, T.laplacian_stencil(dim)).to_dense()
    mv = lambda v: (A @ v.reshape(-1)).reshape(shape)
    x, r, p, v, rt = (st[k].astype(np.float64)
                      for k in ("x", "r", "p", "v", "rt"))
    if kernel == "pv":
        pn = r + BETA * (p - OMEGA * v)
        vn = mv(pn)
        return {"p": pn, "v": vn, "rtv": (rt * vn).sum()}
    s = r - ALPHA * v
    t = mv(s)
    if kernel == "st":
        return {"ts": (t * s).sum(), "tt": (t * t).sum()}
    rn = s - OMEGA * t
    return {"x": x + ALPHA * p + OMEGA * s, "r": rn, "rr": (rn * rn).sum(),
            "rtr": (rt * rn).sum()}


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("kernel", KERNELS)
def test_ragged_plain_matches_fp64_oracle(kernel, dim):
    """(5, 7, 9): a shape the TPU gate refuses and the port takes."""
    shape = (5, 7, 9)
    kw = stencil_kw(dim)
    st = make_state(shape, seed=11, halos=False)
    got = run_port(kernel, st, kw, compensated=False)
    assert_close(got, oracle(kernel, st, shape, dim),
                 operands(kernel, st, got, kw))


def test_update_writes_x_in_place_and_r_to_out():
    kw = stencil_kw(4)
    st = make_state((4, 8, 16))
    t = {k: torch.tensor(v) for k, v in st.items()}
    out = torch.empty_like(t["r"])
    r_in = t["r"].clone()
    x, rn, _, _ = TB3.bicg3d_update(t["r"], t["v"], t["x"], t["p"], t["rt"],
                                    ALPHA, OMEGA, out=out, **kw)
    assert x is t["x"] and rn is out
    assert torch.equal(t["r"], r_in)


@pytest.mark.parametrize("call", ["pv_out_is_p", "update_out_is_r",
                                  "update_x_is_v", "pv_float64", "st_2d",
                                  "halo_shape"])
def test_wrappers_refuse(call):
    kw = stencil_kw(3)
    st = make_state((4, 8, 16))
    t = {k: torch.tensor(v) for k, v in st.items()}
    fn = {
        "pv_out_is_p": lambda: TB3.bicg3d_pv(
            t["r"], t["p"], t["v"], t["rt"], BETA, OMEGA,
            out=(t["p"], torch.empty_like(t["v"])), **kw),
        "update_out_is_r": lambda: TB3.bicg3d_update(
            t["r"], t["v"], t["x"], t["p"], t["rt"], ALPHA, OMEGA,
            out=t["r"], **kw),
        "update_x_is_v": lambda: TB3.bicg3d_update(
            t["r"], t["v"], t["v"], t["p"], t["rt"], ALPHA, OMEGA, **kw),
        "pv_float64": lambda: TB3.bicg3d_pv(
            *(t[k].double() for k in ("r", "p", "v", "rt")), BETA, OMEGA,
            **kw),
        "st_2d": lambda: TB3.bicg3d_st(t["r"][0], t["v"][0], ALPHA, **kw),
        "halo_shape": lambda: TB3.bicg3d_st(t["r"], t["v"], ALPHA,
                                            t["top"][:4], None, **kw),
    }[call]
    with pytest.raises((TypeError, ValueError)):
        fn()


def test_launch_counts_stay_zero_on_cpu():
    T2.reset_launch_counts()
    for kernel in KERNELS:
        run_port(kernel, make_state((4, 8, 16)), stencil_kw(4),
                 compensated=True)
    assert sum(T2.LAUNCHES.values()) == 0


@pytest.mark.parametrize("X,Y,Z,offs,itemsize,want", [
    (256, 256, 256, ((0, 0, 0), (1, 1, 1), (-1, 0, 0)), 4, True),
    (37, 45, 130, ((0, 0, 0), (0, 8, 8)), 4, True),
    (37, 45, 130, ((0, 0, 0), (0, 8, 8)), 8, False),
    (37, 45, 130, ((0, 0, 0), (-2, 0, 0)), 4, False),
])
def test_supports3d_bicgstab(X, Y, Z, offs, itemsize, want):
    assert TB3.supports3d_bicgstab(X, Y, Z, offs, itemsize) is want
