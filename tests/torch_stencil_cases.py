"""Shared cases for the tests of the port's 2-D stencil passes.

Inputs made with numpy from a seed, a runner that feeds them to the port's
wrappers on a given device, a dense float64 numpy oracle, and the
comparison with its tolerances:

* elementwise outputs: atol 1e-5 * max|ref| (f32 rounding of a few
  chained multiply-adds);
* dots: rtol 2e-5, test_20's value (f32 sums in another order);
* Gram entries: 2e-5 of the Cauchy-Schwarz scale sqrt(<a,a><b,b>) of the
  entry, because the cross terms of random vectors nearly cancel (for the
  squared norms the scale is the entry itself).

No jax here: the GPU machine runs ``test_torch_kernels_cuda.py`` with it.
"""

import numpy as np
import torch

from legionsolvers_tpu_torch.ops.cuda import stencil2d as T

OFFS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
KW = dict(offsets=OFFS, values=VALS)
SHAPES = [(32, 128), (64, 128)]
MODES = ["y", "y_dot", "pq", "update", "xpay_pq", "gram2", "step2"]
ELEMENTWISE = {"y", "x", "r", "p"}


def apply_np(v, offs=OFFS, vals=VALS):
    """Dense-equivalent stencil application with Dirichlet truncation."""
    R, C = v.shape
    out = np.zeros_like(v)
    for (dy, dx), w in zip(offs, vals):
        src = np.zeros_like(v)
        ys = slice(max(0, dy), R + min(0, dy))
        yd = slice(max(0, -dy), R + min(0, -dy))
        xs = slice(max(0, dx), C + min(0, dx))
        xd = slice(max(0, -dx), C + min(0, -dx))
        src[yd, xd] = v[ys, xs]
        out += w * src
    return out


def make_inputs(shape, seed, halos=True):
    rng = np.random.default_rng(seed)
    R, C = shape
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p")}
    for k in ("rt", "rb", "pt", "pb"):
        d[k] = (rng.standard_normal((8, C)).astype(np.float32) if halos
                else np.zeros((8, C), np.float32))
    d["alpha"] = np.float32(rng.uniform(0.1, 0.5))
    d["beta"] = np.float32(rng.uniform(0.1, 0.5))
    g = T.gram2_plain(torch.from_numpy(d["r"]), torch.from_numpy(d["p"]), **KW)
    d["coef"] = T.cg2_coeffs(g)[0].numpy()
    return d


def run_port(mode, d, device="cpu"):
    t = {k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()}
    if mode == "y":
        return {"y": T.grid2d_stencil_matvec(t["x"], t["rt"], t["rb"], **KW)}
    if mode == "y_dot":
        y, dot = T.grid2d_stencil_matvec(t["x"], t["rt"], t["rb"],
                                         with_dot=True, **KW)
        return {"y": y, "dot": dot}
    if mode == "pq":
        return {"dot": T.grid2d_cg_pq(t["p"], t["pt"], t["pb"], **KW)}
    if mode == "update":
        x, r, rr = T.grid2d_cg_update(t["p"], t["x"], t["r"], t["alpha"],
                                      t["pt"], t["pb"], **KW)
        return {"x": x, "r": r, "dot": rr}
    if mode == "xpay_pq":
        p, pq = T.grid2d_cg_xpay_pq(t["r"], t["p"], t["beta"], t["rt"],
                                    t["rb"], t["pt"], t["pb"], **KW)
        return {"p": p, "dot": pq}
    if mode == "gram2":
        return {"gram": T.grid2d_cg_gram2(t["r"], t["p"], **KW)}
    x, r, p, g = T.grid2d_cg_step2(t["x"], t["r"], t["p"], t["coef"], **KW)
    return {"x": x, "r": r, "p": p, "gram": g}


def run_oracle(mode, d):
    """Dense float64 numpy version of each pass (zero halos)."""
    x, r, p = (d[k].astype(np.float64) for k in ("x", "r", "p"))
    a, b = float(d["alpha"]), float(d["beta"])
    if mode == "y":
        return {"y": apply_np(x)}
    if mode == "y_dot":
        y = apply_np(x)
        return {"y": y, "dot": (x * y).sum()}
    if mode == "pq":
        return {"dot": (p * apply_np(p)).sum()}
    if mode == "update":
        rn = r - a * apply_np(p)
        return {"x": x + a * p, "r": rn, "dot": (rn * rn).sum()}
    if mode == "xpay_pq":
        pn = r + b * p
        return {"p": pn, "dot": (pn * apply_np(pn)).sum()}
    if mode == "gram2":
        return {"gram": gram_np(r, p)}
    c0, c1, c2, c3, c4, c5 = d["coef"].astype(np.float64)
    Ap = apply_np(p)
    u = c0 * p + c1 * r - c2 * Ap
    rn = r - apply_np(u)
    pn = rn + c3 * r - c4 * Ap + c5 * p
    return {"x": x + u, "r": rn, "p": pn, "gram": gram_np(rn, pn)}


def gram_np(r, p):
    Ap, Ar = apply_np(p), apply_np(r)
    A2p = apply_np(Ap)
    pairs = {"rr": (r, r), "pAp": (p, Ap), "rAp": (r, Ap), "ApAp": (Ap, Ap),
             "rAr": (r, Ar), "ApAr": (Ap, Ar), "ApA2p": (Ap, A2p),
             "ArAr": (Ar, Ar), "ArA2p": (Ar, A2p), "A2pA2p": (A2p, A2p)}
    return np.array([(u * v).sum() for u, v in
                     (pairs[name] for name in T.GRAM_NAMES)])


def gram_bounds(r, p, offs=OFFS, vals=VALS):
    """sqrt(<a,a><b,b>) per Gram entry: the scale its rounding error has."""
    r, p = r.astype(np.float64), p.astype(np.float64)
    A = lambda v: apply_np(v, offs, vals)
    Ap, Ar = A(p), A(r)
    A2p = A(Ap)
    n2 = {k: (v * v).sum() for k, v in
          {"r": r, "p": p, "Ap": Ap, "Ar": Ar, "A2p": A2p}.items()}
    parts = {"rr": "r r", "pAp": "p Ap", "rAp": "r Ap", "ApAp": "Ap Ap",
             "rAr": "r Ar", "ApAr": "Ap Ar", "ApA2p": "Ap A2p",
             "ArAr": "Ar Ar", "ArA2p": "Ar A2p", "A2pA2p": "A2p A2p"}
    return np.array([np.sqrt(n2[a] * n2[b]) for a, b in
                     (parts[name].split() for name in T.GRAM_NAMES)])


def compare(got, ref, d, mode, gram_rtol=2e-5):
    for key, want in ref.items():
        have = np.asarray(got[key], np.float64)
        want = np.asarray(want, np.float64)
        if key in ELEMENTWISE:
            np.testing.assert_allclose(
                have, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                err_msg=f"{mode}:{key}")
        elif key == "gram":
            rr, pp = ((got["r"], got["p"]) if mode == "step2"
                      else (d["r"], d["p"]))
            bound = gram_bounds(np.asarray(rr), np.asarray(pp))
            np.testing.assert_array_less(
                np.abs(have - want), gram_rtol * bound,
                err_msg=f"{mode}:{key}")
        else:
            np.testing.assert_allclose(have, want, rtol=2e-5,
                                       err_msg=f"{mode}:{key}")
