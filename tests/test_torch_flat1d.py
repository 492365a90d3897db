"""The 1-D kernel view and the wide column shifts of the 2-D kernels, against
the JAX package.

The JAX package runs ``-dim 1`` on its 2-D kernels: a 1-D grid is viewed
as ``[n // C, C]`` and its shifts rewritten by ``decompose_flat_offsets``
into (dy, dx) terms, the row-wrap terms with |dx| = C - 1.  Here, on the
same numpy inputs made from seeds:

* every 2-D plain version (K3's four modes, K4, K2, K1, K5a-c), which the
  port's wrappers run on CPU tensors, against the JAX kernel in interpret
  mode, for flat decompositions (C = 128, 256) and for general wide terms
  ((0, +-37), (-1, 100), (1, -(C - 1)), and (-8, 100), (8, -(C - 1)) for
  the one-pass passes), with null and random halo blocks: elementwise
  atol 1e-4 * max|ref|, dots rtol 1e-4, Gram entries 1e-4 of their
  Cauchy-Schwarz scale;
* the view the operator plans (C, Br, offsets, values, ``step2_eligible``,
  ``supports_fused_bicgstab``) on one and four pieces;
* 1-D f32 solves: CG (s-step and two-pass) to rtol 1e-4 (test_14's
  bound), the fused BiCGStab over 8 iterations to rtol 2e-3 (test_23's),
  PCG(Jacobi), GMRES(5) and a 2-space block system, on one piece and on 4
  (rtol 3e-3 on pieces, test_torch_sharded_solvers.py's bound);
* the schedule label and bytes per iteration of ``-dim 1`` on 1 and 4
  pieces.

The CUDA routes themselves (the strip march with WRAP, the tile kernels'
wide terms) are held against these plain versions on the card, in
``test_torch_kernels_cuda.py`` and ``chip_smoke.py --flat1d``.
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu import benchmark as JBM
from legionsolvers_tpu.ops.pallas import bicgstab2d as JB
from legionsolvers_tpu.ops.pallas import stencil2d as JS
from legionsolvers_tpu.solvers.pcg import (
    JacobiPreconditioner as JJacobi,
    PCGSolver as JPCG,
)
from legionsolvers_tpu.utils import roofline as JR
from legionsolvers_tpu_torch.entry import build_stencil_system
from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TS
from legionsolvers_tpu_torch.parallel.mesh import make_mesh
from legionsolvers_tpu_torch.utils import roofline as TR
from torch_stencil_cases import gram_bounds

torch.set_num_threads(2)

DEV = "cpu"
LAP1 = ((0, -1, 1), (2.0, -1.0, -1.0))  # the 1-D Laplacian, flat shifts


def flat(C):
    return TS.decompose_flat_offsets(*LAP1, C)


def wide(C):
    """A 9-term stencil with |dy| <= 1 and column shifts up to C - 1."""
    return (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (0, 37), (0, -37),
             (-1, 100), (1, -(C - 1))),
            (5.0, -1.0, -1.0, -1.0, -1.0, -0.25, -0.25, -0.5, -0.5))


def deep(C):
    """Wide shifts 8 rows away: the one-pass kernels' halo blocks."""
    return (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1), (-8, 100),
             (8, -(C - 1))),
            (4.5, -1.0, -1.0, -1.0, -1.0, -0.25, -0.25))


# name -> (shape, (offsets, values))
STENCILS = {"flat128": ((16, 128), flat(128)),
            "flat256": ((8, 256), flat(256)),
            "wide128": ((16, 128), wide(128)),
            "deep256": ((16, 256), deep(256))}
SSTEP = ["flat128", "flat256", "wide128"]  # |dy| <= 1: JAX's K1/K2 gate


def inputs(shape, seed, halos=True):
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p", "v", "rt")}
    for k in ("ht", "hb", "gt", "gb"):
        d[k] = (rng.standard_normal((8, shape[1])).astype(np.float32)
                if halos else np.zeros((8, shape[1]), np.float32))
    d["alpha"] = np.float32(rng.uniform(0.1, 0.5))
    d["beta"] = np.float32(rng.uniform(0.1, 0.5))
    return d


def close(got, ref, scales=None):
    """Elementwise atol 1e-4 * max|ref|; scalar dots rtol 1e-4 (Gram
    entries: 1e-4 of ``scales``)."""
    for key, want in ref.items():
        have = np.asarray(got[key], np.float64)
        want = np.asarray(want, np.float64)
        if want.ndim == 2:
            np.testing.assert_allclose(have, want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=key)
        elif key == "gram":
            np.testing.assert_array_less(np.abs(have - want), 1e-4 * scales,
                                         err_msg=key)
        else:
            np.testing.assert_allclose(have, want, rtol=1e-4, err_msg=key)


def one_pass(pkg, mode, d, offs, vals):
    """K3 ``mode`` or K4 on ``d`` through the JAX kernel (interpret mode)
    or the port's wrapper (its plain version on CPU tensors)."""
    if pkg is J:
        a = {k: jnp.asarray(v) for k, v in d.items()}
        kw = dict(offsets=offs, values=vals, interpret=True)
        M = JS
    else:
        a = {k: torch.tensor(np.asarray(v)) for k, v in d.items()}
        kw = dict(offsets=offs, values=vals)
        M = TS
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
    """P7: K3's four modes and K4 take any |dx| < C (the plain versions
    once raised a shape error past |dx| = 8)."""
    shape, (offs, vals) = STENCILS[stencil]
    d = inputs(shape, seed=3 + len(mode), halos=halos)
    close(one_pass(T, mode, d, offs, vals), one_pass(J, mode, d, offs, vals))


def test_apply_plain_takes_the_row_wrap_terms():
    """The input of the fault: the 1-D Laplacian's decomposition on an
    [8, 128] view is the 1-D Laplacian of the flat vector."""
    x = np.random.default_rng(0).standard_normal((8, 128)).astype(np.float32)
    y = TS.apply_plain(torch.from_numpy(x), *flat(128)).numpy()
    f = x.reshape(-1).astype(np.float64)
    want = 2 * f
    want[1:] -= f[:-1]
    want[:-1] -= f[1:]
    np.testing.assert_allclose(y.reshape(-1), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("stencil", SSTEP)
@pytest.mark.parametrize("mode", ["gram2", "step2"])
def test_sstep_plain_matches_jax(mode, stencil):
    """K2 and K1: the wrappers on the flat views and on a general wide
    stencil, which the port's K1/K2 gate takes as JAX's does (the flat
    route, and the general route: ROADMAP queue 2, "B (general)")."""
    shape, (offs, vals) = STENCILS[stencil]
    kw = dict(offsets=offs, values=vals)
    d = inputs(shape, seed=11, halos=False)
    t = {k: torch.from_numpy(d[k].copy()) for k in ("x", "r", "p")}
    a = {k: jnp.asarray(d[k]) for k in ("x", "r", "p")}
    is_flat = stencil.startswith("flat")
    assert TS.step2_supported(*shape, offs)
    assert TS.route(offs, vals, shape[1], sstep=True)[0] == (
        "flat" if is_flat else "general")
    if mode == "gram2":
        got = {"gram": TS.grid2d_cg_gram2(t["r"], t["p"], **kw)}
        ref = {"gram": JS.grid2d_cg_gram2(a["r"], a["p"], interpret=True,
                                          **kw)}
        close(got, ref, gram_bounds(d["r"], d["p"], offs, vals))
        return
    coef = TS.cg2_coeffs(TS.gram2_plain(t["r"], t["p"], **kw))[0]
    xo, ro, po, go = TS.grid2d_cg_step2(t["x"], t["r"], t["p"], coef, **kw)
    x, r, p, g = JS.grid2d_cg_step2(a["x"], a["r"], a["p"],
                                    jnp.asarray(coef.numpy()),
                                    interpret=True, **kw)
    close({"x": xo, "r": ro, "p": po}, {"x": x, "r": r, "p": p})
    close({"gram": go}, {"gram": g},
          gram_bounds(np.asarray(r), np.asarray(p), offs, vals))


BICG = {"pv": ("p", "v", "rtv"), "st": ("ts", "tt"),
        "update": ("x", "r", "rr", "rtr")}


def bicg(pkg, kernel, d, offs, vals, compensated):
    if pkg is J:
        a = {k: jnp.asarray(v) for k, v in d.items()}
        kw = dict(offsets=offs, values=vals, interpret=True,
                  compensated=compensated)
        M = JB
    else:
        a = {k: torch.tensor(np.asarray(v)) for k, v in d.items()}
        kw = dict(offsets=offs, values=vals, compensated=compensated)
        M = TB
    if kernel == "pv":
        out = M.bicg_pv(a["r"], a["p"], a["v"], a["rt"], 0.37, 0.41, **kw)
    elif kernel == "st":
        out = M.bicg_st(a["r"], a["v"], 0.83, **kw)
    else:
        out = M.bicg_update(a["r"], a["v"], a["x"], a["p"], a["rt"], 0.83,
                            0.41, **kw)
    return dict(zip(BICG[kernel], out))


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("stencil", ["flat128", "wide128", "deep256"])
@pytest.mark.parametrize("kernel", list(BICG))
def test_bicgstab_plain_matches_jax(kernel, stencil, compensated):
    """K5a-c: the plain versions inherit P7's repair."""
    shape, (offs, vals) = STENCILS[stencil]
    d = inputs(shape, seed=23, halos=False)
    close(bicg(T, kernel, d, offs, vals, compensated),
          bicg(J, kernel, d, offs, vals, compensated))


def test_routes():
    """Which kernel each stencil takes on the card: the strip march for
    reach 1, the strip march with WRAP on the 1-D stencil for a flat
    decomposition, for the rest the band march for K3, K4 and K5a-c;
    K5a and K5c take the band march on the flat decomposition too; the
    gates take |dy| <= 8 and any |dx| < C."""
    assert TS.route(*flat(1024), 1024) == ("flat", ((0, 0), (0, -1), (0, 1)),
                                           LAP1[1], 1)
    cross = (((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)), (4.0,) + (-1.0,) * 4)
    assert TS.route(*cross, 128)[0] == "strip"
    assert TS.route(*wide(128), 128)[0] == "band"
    assert TS.route(*wide(128), 128, bicg="pv")[0] == "band"
    assert TS.route(*wide(128), 128, bicg="st")[0] == "band"
    assert TS.route(*wide(128), 128, bicg="update")[0] == "band"
    assert TS.route(*flat(1024), 1024, bicg="st")[0] == "flat"
    assert TS.route(*flat(1024), 1024, bicg="pv") == ("band", *flat(1024),
                                                      0)
    assert TS.route(*flat(1024), 1024, bicg="update") == (
        "band", *flat(1024), 0)
    assert TS.flat_stencil(*flat(128), 256) is None
    assert TS.flat_stencil(flat(128)[0], (2.0, -1.0, -0.5, -1.0, -1.0),
                           128) is None
    assert TS.supports(64, 128, wide(128)[0])
    assert TS.supports(64, 256, deep(256)[0])
    assert not TS.supports(64, 128, ((0, 0), (0, 128)))
    assert not TS.supports(64, 128, ((0, 0), (9, 1)))
    assert TB.bicgstab_supported(64, 128, wide(128)[0])


# ---------------------------------------------------------------------------
# the view, the solves and the roofline of -dim 1
# ---------------------------------------------------------------------------

def jax_mesh(pieces):
    if pieces == 1:
        return None
    from legionsolvers_tpu.parallel.mesh import make_mesh as jmesh

    return jmesh(pieces)


def operators(n, pieces):
    jop = J.StencilOperator((n,), J.laplacian_stencil(1),
                            partition=J.BlockPartition(n, pieces),
                            mesh=jax_mesh(pieces),
                            options=J.SolverOptions(entry_dtype=jnp.float32))
    top = T.StencilOperator((n,), T.laplacian_stencil(1),
                            partition=T.BlockPartition(n, pieces),
                            mesh=(make_mesh(pieces, devices=[DEV] * pieces)
                                  if pieces > 1 else None),
                            options=T.SolverOptions(entry_dtype=torch.float32),
                            device=DEV)
    return jop, top


@pytest.mark.parametrize("n,pieces", [(8192, 1), (65536, 1), (1000, 1),
                                      (60, 1), (8192, 4), (65536, 4)])
def test_view_matches_jax(n, pieces):
    jop, top = operators(n, pieces)
    assert top.uses_pallas == jop.uses_pallas
    if not jop.uses_pallas:
        return
    for k in ("C", "Br", "offs", "vals"):
        assert top._view[k] == jop._view[k], k
    assert top._view["flat"]
    v = top._view  # the kernels' flat route recovers the 1-D stencil
    assert TS.route(v["offs"], v["vals"], v["C"])[:3] == (
        "flat", ((0, 0), (0, -1), (0, 1)), (2.0, -1.0, -1.0))
    assert top.step2_eligible == jop.step2_eligible
    assert top.supports_fused_bicgstab == jop.supports_fused_bicgstab


def planners(n, pieces, num_spaces=1):
    """The JAX CLI's and the port's ``-dim 1`` f32 systems (b = 1, x0 =
    0), vectors in the view's [n // C, C] layout."""
    ns = types.SimpleNamespace(dim=1, nx=n, ny=1, nz=1, vp=pieces,
                               block=num_spaces == 2, restart=5)
    pj, _, _ = JBM.build_planner(ns, jax_mesh(pieces), J.SolverOptions(
        entry_dtype=jnp.float32))
    pt = build_stencil_system(
        1, (n,), T.SolverOptions(entry_dtype=torch.float32), DEV, num_spaces,
        pieces=pieces, mesh=(make_mesh(pieces, devices=[DEV] * pieces)
                             if pieces > 1 else None))
    assert pt.sol_vectors[0].grid_shape == pj.sol_vectors[0].grid_shape
    return pj, pt


def solvers(kind, pj, pt):
    if kind == "cg":
        return J.CGSolver(pj), T.CGSolver(pt)
    if kind == "bicgstab":
        return J.BiCGStabSolver(pj), T.BiCGStabSolver(pt)
    if kind == "pcg":
        return (JPCG(pj, JJacobi(pj)),
                T.PCGSolver(pt, T.JacobiPreconditioner(pt)))
    return J.GMRESSolver(pj, 5), T.GMRESSolver(pt, 5)


class env:
    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def sol(planner, space=0):
    return np.asarray(planner.get_vector(0, space).data,
                      dtype=np.float64).reshape(-1)


# (solver, environment, iterations, n, pieces, history rtol)
SOLVES = {
    "cg s-step": ("cg", {}, 20, 8192, 1, 1e-4),
    "cg two-pass": ("cg", {"LEGIONSOLVERS_NO_SSTEP": "1"}, 20, 8192, 1,
                    1e-4),
    "bicgstab": ("bicgstab", {}, 8, 8192, 1, 2e-3),
    "pcg": ("pcg", {}, 10, 8192, 1, 1e-4),
    "gmres5": ("gmres", {}, 2, 8192, 1, 1e-4),
    "cg 4 pieces": ("cg", {}, 12, 8192, 4, 3e-3),
    "bicgstab 4 pieces": ("bicgstab", {}, 8, 8192, 4, 3e-3),
    "bicgstab fused 4 pieces": ("bicgstab", {}, 6, 4 * 16 * 4096, 4, 3e-3),
    "pcg 4 pieces": ("pcg", {}, 10, 8192, 4, 3e-3),
    "gmres5 4 pieces": ("gmres", {}, 2, 8192, 4, 3e-3),
}
# what each port solve must run: (s-step, fused BiCGStab) where it applies
ROUTES = {"cg s-step": True, "cg two-pass": False, "cg 4 pieces": False,
          "bicgstab": True, "bicgstab 4 pieces": False,
          "bicgstab fused 4 pieces": True}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_matches_jax(case):
    kind, flags, iters, n, pieces, rtol = SOLVES[case]
    with env(**flags):
        pj, pt = planners(n, pieces)
        op = pt.row_partitioned_matrices[0][0]
        assert op.uses_pallas and op._view["flat"]
        if case in ROUTES:
            on = (op.step2_eligible if kind == "cg"
                  else op.supports_fused_bicgstab)
            assert on is ROUTES[case]
        sj, st = solvers(kind, pj, pt)
        hj = np.asarray(sj.solve(iters), np.float64)
        ht = st.solve(iters).double().numpy()
    assert np.isfinite(ht).all() and len(ht) == len(hj)
    np.testing.assert_allclose(ht, hj, rtol=rtol)
    xj, xt = sol(pj), sol(pt)
    np.testing.assert_allclose(xt, xj, rtol=0,
                               atol=10 * rtol * np.abs(xj).max())


@pytest.mark.parametrize("kind", ["cg", "bicgstab"])
@pytest.mark.parametrize("pieces", [1, 4])
def test_block_solve_matches_jax(kind, pieces):
    """The 2-space block system on the 1-D view (``--block``); BiCGStab on
    4 pieces with blocks of 16 rows, the fused runner's gate (the JAX
    block runner takes no other blocks in interpret mode)."""
    n = 4 * 16 * 4096 if (kind, pieces) == ("bicgstab", 4) else 8192
    pj, pt = planners(n, pieces, num_spaces=2)
    sj, st = solvers(kind, pj, pt)
    iters = 10 if kind == "cg" else 6
    hj = np.asarray(sj.solve(iters), np.float64)
    ht = st.solve(iters).double().numpy()
    rtol = 1e-4 if pieces == 1 and kind == "cg" else 3e-3
    np.testing.assert_allclose(ht, hj, rtol=rtol)
    for space in (0, 1):
        xj = sol(pj, space)
        np.testing.assert_allclose(sol(pt, space), xj, rtol=0,
                                   atol=10 * rtol * np.abs(xj).max())


@pytest.mark.parametrize("kind", ["cg", "bicgstab", "pcg", "gmres"])
@pytest.mark.parametrize("pieces", [1, 4])
def test_roofline_matches_jax(kind, pieces):
    """Both packages charge ``-dim 1`` the same schedule and bytes: on one
    piece fused2d_x2 (CG) and bicgstab_fused2d, on 4 pieces two-pass CG
    (fused2d) and, with blocks of 8 rows, the BiCGStab transcription."""
    n = 8192
    pj, pt = planners(n, pieces)
    sj, st = solvers(kind, pj, pt)
    want = JR.solver_bytes_per_iteration(sj, n)
    assert TR.solver_bytes_per_iteration(st, n) == want
    label = {("cg", 1): "fused2d_x2", ("cg", 4): "fused2d",
             ("bicgstab", 1): "bicgstab_fused2d"}.get((kind, pieces))
    if label:
        assert want[1] == label
