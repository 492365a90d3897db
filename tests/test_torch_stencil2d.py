"""The port's 2-D stencil passes against the JAX Pallas kernels.

Each plain PyTorch version in ``legionsolvers_tpu_torch/ops/cuda/
stencil2d.py`` (what the wrappers run on CPU tensors) is held against its
JAX counterpart in ``legionsolvers_tpu/ops/pallas/stencil2d.py``, run in
interpret mode as ``tests/test_20_sstep.py`` runs it, on the same numpy
inputs, and against a dense float64 numpy oracle.  Inputs and tolerances
are those of ``torch_stencil_cases.py``.  The CUDA kernels themselves are
held against the plain versions in ``test_torch_kernels_cuda.py``.  The
K3 and K4 wrappers' plain routes are also held against the JAX kernels with
the 9-point stencil and with null and random halo blocks, and the Python
mirror of the strip passes' target warps against ``csrc/march2d.cuh``.
"""

import pathlib
import re


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from legionsolvers_tpu.ops.pallas import stencil2d as J
from legionsolvers_tpu_torch.ops.cuda import stencil2d as T
from torch_stencil_cases import (
    KW,
    MODES,
    OFFS,
    SHAPES,
    VALS,
    apply_np,
    compare,
    make_inputs,
    run_oracle,
    run_port,
)

torch.set_num_threads(2)


def run_jax(mode, d):
    a = {k: jnp.asarray(v) for k, v in d.items()}
    kw = dict(KW, interpret=True)
    if mode == "y":
        return {"y": J.grid2d_stencil_matvec(a["x"], a["rt"], a["rb"], **kw)}
    if mode == "y_dot":
        y, dot = J.grid2d_stencil_matvec(a["x"], a["rt"], a["rb"],
                                         with_dot=True, **kw)
        return {"y": y, "dot": dot}
    if mode == "pq":
        return {"dot": J.grid2d_cg_pq(a["p"], a["pt"], a["pb"], **kw)}
    if mode == "update":
        x, r, rr = J.grid2d_cg_update(a["p"], a["x"], a["r"], a["alpha"],
                                      a["pt"], a["pb"], **kw)
        return {"x": x, "r": r, "dot": rr}
    if mode == "xpay_pq":
        p, pq = J.grid2d_cg_xpay_pq(a["r"], a["p"], a["beta"], a["rt"],
                                    a["rb"], a["pt"], a["pb"], **kw)
        return {"p": p, "dot": pq}
    if mode == "gram2":
        return {"gram": J.grid2d_cg_gram2(a["r"], a["p"], **kw)}
    x, r, p, g = J.grid2d_cg_step2(a["x"], a["r"], a["p"], a["coef"], **kw)
    return {"x": x, "r": r, "p": p, "gram": g}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax(mode, shape):
    d = make_inputs(shape, seed=10 * MODES.index(mode) + SHAPES.index(shape))
    got = {k: np.asarray(v) for k, v in run_port(mode, d).items()}
    compare(got, run_jax(mode, d), d, mode)


@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_dense_oracle(mode):
    d = make_inputs((32, 128), seed=7, halos=False)
    got = {k: np.asarray(v) for k, v in run_port(mode, d).items()}
    compare(got, run_oracle(mode, d), d, mode)


def test_step2_plain_is_two_classic_iterations():
    """One step2 pass == two textbook CG iterations (fp64 oracle), with
    the coefficients from cg2_coeffs of the bootstrap Gram."""
    d = make_inputs((64, 128), seed=1, halos=False)
    t = {k: torch.from_numpy(d[k].copy()) for k in ("x", "r", "p")}
    coef, rr1, rr2 = T.cg2_coeffs(T.grid2d_cg_gram2(t["r"], t["p"], **KW))
    xo, ro, po, gn = T.grid2d_cg_step2(t["x"], t["r"], t["p"], coef, **KW)
    xe, re, pe = (d[k].astype(np.float64) for k in ("x", "r", "p"))
    hist = []
    for _ in range(2):
        Ap = apply_np(pe)
        rr = (re * re).sum()
        a = rr / (pe * Ap).sum()
        xe, re = xe + a * pe, re - a * Ap
        hist.append((re * re).sum())
        pe = re + (hist[-1] / rr) * pe
    scale = max(np.abs(v).max() for v in (xe, re, pe))
    for got, exp in ((xo, xe), (ro, re), (po, pe)):
        np.testing.assert_allclose(got.numpy(), exp, atol=1e-4 * scale)
    np.testing.assert_allclose(float(rr1), hist[0], rtol=1e-4)
    np.testing.assert_allclose(float(rr2), hist[1], rtol=1e-4)
    np.testing.assert_allclose(float(gn[0]), hist[1], rtol=1e-4)


@pytest.mark.parametrize("seed", [3, 4])
def test_cg2_coeffs_matches_jax(seed):
    d = make_inputs((32, 128), seed=seed, halos=False)
    g = np.asarray(J.grid2d_cg_gram2(jnp.asarray(d["r"]), jnp.asarray(d["p"]),
                                     interpret=True, **KW))
    cj, rr1j, rr2j = J.cg2_coeffs(jnp.asarray(g))
    ct, rr1t, rr2t = T.cg2_coeffs(torch.from_numpy(g.copy()))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6)
    np.testing.assert_allclose(float(rr1t), float(rr1j), rtol=1e-6)
    np.testing.assert_allclose(float(rr2t), float(rr2j), rtol=1e-6)


def test_decompose_flat_offsets_matches_jax():
    flat = [0, -1, 1, -128, 128, 130, -300]
    vals = [2.0, -1.0, -1.0, -0.5, -0.5, 0.25, 0.125]
    assert (T.decompose_flat_offsets(flat, vals, 128)
            == J.decompose_flat_offsets(flat, vals, 128))


def test_gates():
    nine = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    assert T.step2_supported(200, 328, OFFS)
    assert T.step2_supported(4096, 4096, nine)
    assert not T.step2_supported(64, 128, OFFS + ((2, 0),))
    assert T.supports(64, 128, OFFS + ((8, -8),))
    assert not T.supports(64, 128, OFFS + ((9, 0),))
    # any |dx| < C, as JAX's gate (terms past 8 read beside the tile)
    assert T.supports(64, 128, OFFS + ((0, -9),))
    assert T.supports(64, 128, OFFS + ((0, -127),))
    assert not T.supports(64, 128, OFFS + ((0, -128),))
    # K1/K2: |dy| <= 1 and any |dx| < C, as JAX's gate: the flat
    # decomposition of a reach-1 1-D stencil runs the strip march with
    # WRAP, any other stencil past reach 1 the general route
    flat = T.decompose_flat_offsets((0, -1, 1), (2.0, -1.0, -1.0), 128)
    assert T.step2_supported(64, 128, flat[0])
    assert T.route(*flat, 128, sstep=True)[0] == "flat"
    assert T.step2_supported(64, 128, OFFS + ((0, -9),))
    wide9 = (OFFS + ((0, -9),), VALS + (-0.5,))
    assert T.route(*wide9, 128, sstep=True)[0] == "general"
    assert T.route(*wide9, 128)[0] == "band"
    assert T.route(*wide9, 128, bicg="pv")[0] == "band"
    assert T.route(*wide9, 128, bicg="st")[0] == "band"
    assert T.route(*wide9, 128, bicg="update")[0] == "band"
    assert T.step2_supported(64, 128, OFFS + ((1, -127),))
    assert not T.step2_supported(64, 128, OFFS + ((-2, 5),))
    assert not T.step2_supported(64, 128, OFFS + ((0, 128),))
    assert not T.step2_supported(64, 128, OFFS + ((1, -128),))


def test_ragged_shape_plain_matches_dense_oracle():
    """Sides that are not multiples of the kernels' 32-wide tile."""
    d = make_inputs((40, 72), seed=11, halos=False)
    for mode in MODES:
        got = {k: np.asarray(v) for k, v in run_port(mode, d).items()}
        compare(got, run_oracle(mode, d), d, mode)


OFFS9 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1),
         (1, -1), (1, 1))
VALS9 = (6.0, -1.0, -1.0, -1.0, -1.0, -0.5, -0.5, -0.5, -0.5)
STENCILS = {"cross": (OFFS, VALS), "9-point": (OFFS9, VALS9)}
ONE_PASS = ["y", "y_dot", "pq", "update", "xpay_pq"]


def _one_pass(mode, d, kw, halos, jax):
    """K3 ``mode`` or K4 on ``d``: the port's wrapper on CPU tensors with
    halo blocks None when ``halos`` is "null", or the JAX kernel in
    interpret mode with zero blocks there."""
    if jax:
        a = {k: jnp.asarray(v) for k, v in d.items()}
        mod, kw = J, dict(kw, interpret=True)
    else:
        a = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
        mod = T
        if halos == "null":
            a.update(rt=None, rb=None, pt=None, pb=None)
    if mode in ("y", "y_dot"):
        out = mod.grid2d_stencil_matvec(a["x"], a["rt"], a["rb"],
                                        with_dot=mode == "y_dot", **kw)
        return dict(zip(("y", "dot"), out if mode == "y_dot" else (out,)))
    if mode == "pq":
        return {"dot": mod.grid2d_cg_pq(a["p"], a["pt"], a["pb"], **kw)}
    if mode == "update":
        out = mod.grid2d_cg_update(a["p"], a["x"], a["r"], a["alpha"],
                                   a["pt"], a["pb"], **kw)
        return dict(zip(("x", "r", "dot"), out))
    out = mod.grid2d_cg_xpay_pq(a["r"], a["p"], a["beta"], a["rt"], a["rb"],
                                a["pt"], a["pb"], **kw)
    return dict(zip(("p", "dot"), out))


@pytest.mark.parametrize("halos", ["null", "random"])
@pytest.mark.parametrize("stencil", list(STENCILS))
@pytest.mark.parametrize("mode", ONE_PASS)
def test_one_pass_halo_routes_match_jax(mode, stencil, halos):
    """The K3 modes and K4 on CPU tensors (their plain routes) against the
    JAX kernels in interpret mode, with the cross and the 9-point stencil
    (the strip kernels' two stencil paths) and with null (None; zero
    blocks for JAX) and random [8, C] halo blocks."""
    offs, vals = STENCILS[stencil]
    kw = dict(offsets=offs, values=vals)
    d = make_inputs((32, 128), seed=50 + ONE_PASS.index(mode),
                    halos=halos == "random")
    got = {k: np.asarray(v) for k, v in
           _one_pass(mode, d, kw, halos, jax=False).items()}
    compare(got, _one_pass(mode, d, kw, halos, jax=True), d, mode)


def _csrc_define(name):
    text = (pathlib.Path(T.__file__).resolve().parents[2] / "csrc"
            / "march2d.cuh").read_text()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


@pytest.mark.parametrize("k, min_blocks", [
    (0, "LS_STEP2_MIN_BLOCKS"), (1, "LS_GRAM2_MIN_BLOCKS"),
    (2, "LS_ST_MIN_BLOCKS"), (3, "LS_STENCIL_MIN_BLOCKS"),
    (4, "LS_XPAY_MIN_BLOCKS")])
def test_strip_targets_mirror_csrc(k, min_blocks):
    """Each strip pass's target warps in Python (STRIP_TARGETS, in
    ls_strip_target_warps order: K1, K2, K5b, K3, K4) is one wave of the
    resident blocks its csrc launch bounds name on 132 SMs, and
    strip_geometry under it covers a 4096^2 grid in one warp per strip
    and row chunk, within one wave."""
    target = 132 * _csrc_define(min_blocks) * _csrc_define("LS_STEP2_WARPS")
    assert T.STRIP_TARGETS[k] == target
    strips, rows, units, blocks = T.strip_geometry(4096, 4096, target)
    assert strips == -(-4096 // T.STEP2_COLS) and units % strips == 0
    assert (units // strips) * rows >= 4096 > (units // strips - 1) * rows
    assert units <= target and blocks == -(-units // T.STEP2_WARPS)
