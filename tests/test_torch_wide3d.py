"""Wide z shifts on the 3-D kernel view (K6a, K6b, K7) and K1's nop mode,
the port against the JAX package on the CPU.

The stencil S_WIDE has 15 terms: the 7-point cross (center 8.5, the six
unit neighbours -1), (0, 0, +-12) with -0.5 (just past the kernels' 8-wide
window), (0, +-3, +-100) with -0.25 (wide in z, off-row in y) and
(+-1, 0, +-128) with -0.25 (a neighbour plane at |oz| = 128, JAX's
``PADZ``).  It is symmetric and diagonally dominant (8.5 = 6 + 1 + 1 +
0.5), so CG applies.  The same numpy inputs (random nonzero halo planes)
go through JAX's Pallas passes in interpret mode and through the port's
wrappers, which run their plain PyTorch versions on CPU tensors, at
(4, 8, 256) and at (5, 16, 128) with S_127 (S_WIDE with +-128 cut to
+-127, the widest z shift the port's gate takes at Z = 128); the solves
run at (4, 8, 256) on one piece and at (12, 4, 256) on 4 pieces (three
x-planes each), JAX's on ``mesh4``.

Where the gates differ: JAX's also asks Z % 128 == 0 and a VMEM budget,
which Hopper does not have, so the port takes Z = 200 where JAX does not;
the port asks |oz| < Z, as its 2-D gate asks |dx| < C, so at Z = 128 it
refuses S_WIDE's |oz| = 128 terms, which read only zeros there, and runs
that system on the linearized path (the same answers, held below).

Tolerances, those of ``test_torch_stencil3d.py`` (K6: arrays atol 1e-5 *
max|ref|, dots 1e-5 of their Cauchy-Schwarz scale) and
``test_torch_bicgstab3d.py`` (K7: arrays 2e-5 * max|ref|, dots 1e-5 of the
scale; compensated dots equal to ``dd_dot`` of their operands); solves
those of ``test_torch_3d_slice.py`` (CG history rtol 1e-4, x atol 1e-4 *
max|x|; BiCGStab 3e-3 and 5e-3, stopped after 6 iterations, while JAX's
f32 history is still within 1e-4 of float64); matvecs atol 1e-5 * max|y|.
K1 nop: x'', r'', p'' bit for bit (one f32 add, or none), g[0] 1e-5 of its
Cauchy-Schwarz scale, g[1..9] zero.

No JAX: the Python mirrors of the CUDA dispatch off ``march1`` (the window
march for every 3-D pass: ``route3d``, which also sends K7 update with
compensated dots on reach-1 stencils to ``march3d``), of the window
march's geometry and of the shared scratch's room.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.ops.pallas import bicgstab3d as JB3
from legionsolvers_tpu.ops.pallas import stencil2d as J2
from legionsolvers_tpu.ops.pallas import stencil3d as J3
from legionsolvers_tpu_torch.entry import build_stencil_system
from legionsolvers_tpu_torch.ops.ddsum import dd_dot
from legionsolvers_tpu_torch.ops.cuda import bicgstab3d as TB3
from legionsolvers_tpu_torch.ops.cuda import stencil2d as T2
from legionsolvers_tpu_torch.ops.cuda import stencil3d as T3
from tests import test_torch_bicgstab3d as B3
from tests import test_torch_stencil3d as S3
from tests.test_torch_sharded_solvers import hist_of, opts, sol, system

torch.set_num_threads(2)

DEV = "cpu"
S_WIDE = [((0, 0, 0), 8.5), ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
          ((0, -1, 0), -1.0), ((0, 1, 0), -1.0), ((0, 0, -1), -1.0),
          ((0, 0, 1), -1.0), ((0, 0, -12), -0.5), ((0, 0, 12), -0.5),
          ((0, 3, 100), -0.25), ((0, -3, -100), -0.25),
          ((0, 3, -100), -0.25), ((0, -3, 100), -0.25),
          ((1, 0, 128), -0.25), ((-1, 0, -128), -0.25)]
S_127 = [((ox, oy, max(-127, min(127, oz))), v)
         for (ox, oy, oz), v in S_WIDE]
# (shape, stencil) of the kernel comparisons
CASES = {"(4, 8, 256)": ((4, 8, 256), S_WIDE),
         "(5, 16, 128) |oz| = 127": ((5, 16, 128), S_127)}
SHAPE = (4, 8, 256)
SHAPE4 = (12, 4, 256)  # 3 x-planes on each of 4 pieces
F32T = T.SolverOptions(entry_dtype=torch.float32)


def kw_of(stencil):
    return dict(offsets=tuple(o for o, _ in stencil),
                values=tuple(v for _, v in stencil))


def offs(*extra):
    return ((0, 0, 0),) + extra


# -- the gates ---------------------------------------------------------------

# (X, Y, Z, offsets, JAX takes it, the port takes it)
GATES = {
    "S_WIDE at 256^3": (256, 256, 256, kw_of(S_WIDE)["offsets"], True, True),
    "S_WIDE (4, 8, 256)": (4, 8, 256, kw_of(S_WIDE)["offsets"], True, True),
    # |oz| = Z reads only zeros: the port keeps |oz| < Z (its 2-D |dx| < C)
    "S_WIDE (5, 16, 128)": (5, 16, 128, kw_of(S_WIDE)["offsets"], True,
                            False),
    "S_127 (5, 16, 128)": (5, 16, 128, kw_of(S_127)["offsets"], True, True),
    # Z % 128 and the VMEM budget are the TPU's, not Hopper's
    "S_WIDE (4, 8, 200)": (4, 8, 200, kw_of(S_WIDE)["offsets"], False, True),
    "|oz| = Z = 100": (4, 8, 100, offs((0, 0, 100)), False, False),
    "|oz| = 100 < Z = 101": (4, 8, 101, offs((0, 0, 100)), False, True),
    "|oz| = 129": (4, 8, 256, offs((0, 0, 129)), False, False),
    "|oy| = 9 wide": (4, 8, 256, offs((0, 9, 100)), False, False),
    "|ox| = 2 wide": (4, 8, 256, offs((2, 0, 100)), False, False),
    "(0, 8, -128)": (4, 8, 256, offs((0, 8, -128)), True, True),
    "33 terms": (4, 8, 256, tuple((0, 0, k - 16) for k in range(33)), True,
                 False),
}


@pytest.mark.parametrize("case", list(GATES))
def test_gates_of_both_packages(case):
    """Every 3-D gate of both packages on the table above: JAX's
    ``supports3d`` and ``supports3d_bicgstab``, the port's ``supports3d``,
    ``supports3d_xpay_pq`` and ``supports3d_bicgstab``.  Where they differ
    the table says why (the module docstring)."""
    X, Y, Z, o, jax_takes, port_takes = GATES[case]
    assert J3.supports3d(Y, Z, o) is jax_takes
    assert JB3.supports3d_bicgstab(Y, Z, o) is jax_takes
    assert T3.supports3d(X, Y, Z, o) is port_takes
    assert T3.supports3d_xpay_pq(X, Y, Z, o) is port_takes
    assert TB3.supports3d_bicgstab(X, Y, Z, o) is port_takes


# -- the plain versions against JAX's interpret-mode kernels -----------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", S3.MODES)
def test_k6_plain_matches_jax(mode, case):
    """K6a's four modes and K6b: the wide terms (|oz| 12, 100, 127 or 128;
    ox = +-1 among them) read from random halo planes."""
    shape, stencil = CASES[case]
    kw = kw_of(stencil)
    d = S3.make_inputs(shape, seed=20 + S3.MODES.index(mode))
    got = {k: v.numpy() for k, v in S3.run_port(mode, d, kw).items()}
    S3.compare(got, S3.run_jax(mode, d, kw), S3.dot_scale(mode, d, got, kw))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("kernel", B3.KERNELS)
def test_k7_plain_matches_jax(kernel, compensated, case):
    """K7 pv, st and update: the wide terms read the pass's combined
    operand (p', s) and its halo planes."""
    shape, stencil = CASES[case]
    kw = kw_of(stencil)
    st = B3.make_state(shape, seed=30 + B3.KERNELS.index(kernel))
    got = B3.run_port(kernel, st, kw, compensated)
    ops = B3.operands(kernel, st, got, kw)
    B3.assert_close(got, B3.run_jax(kernel, st, kw, compensated), ops)
    if compensated:
        for key, (a, b) in ops.items():
            assert float(got[key]) == float(dd_dot(a, b)), key


def test_plain_reads_zeros_past_z():
    """At Z = 128 S_WIDE's |oz| = 128 terms read only zeros (and halo
    zeros): the plain version agrees with JAX's kernel there, while the
    port's wrappers refuse the geometry (its gate keeps |oz| < Z)."""
    shape = (5, 16, 128)
    kw = kw_of(S_WIDE)
    d = S3.make_inputs(shape, seed=7)
    t = {k: torch.as_tensor(d[k]) for k in ("x", "top", "bot")}
    y = T3.apply_planes_plain(t["x"], *kw.values(), t["top"], t["bot"])
    want = S3.run_jax("y", d, kw)["y"]
    S3.compare({"y": y.numpy()}, {"y": want}, 0.0)
    with pytest.raises(ValueError, match="unsupported"):
        T3.grid3d_stencil_matvec(t["x"], t["top"], t["bot"], **kw)


def test_apply_planes_plain_pads_each_axis_by_its_reach(monkeypatch):
    """y is padded by the y reach (3) and z by the z reach (128), not both
    by 128; the sums are those of the uniform padding bit for bit."""
    kw = kw_of(S_WIDE)
    d = S3.make_inputs(SHAPE, seed=9)
    x, top, bot = (torch.as_tensor(d[k]) for k in ("x", "top", "bot"))
    pads = []
    real = F.pad

    def spy(a, pad, *args, **kwargs):
        pads.append(tuple(pad))
        return real(a, pad, *args, **kwargs)

    monkeypatch.setattr(T3.F, "pad", spy)
    y = T3.apply_planes_plain(x, *kw.values(), top, bot)
    monkeypatch.undo()
    assert pads == [(128, 128, 3, 3)]
    ext = real(torch.cat([top[None], x, bot[None]]), (128,) * 4)
    X, Y, Z = SHAPE
    acc = None
    for (ox, oy, oz), w in S_WIDE:
        term = w * ext[1 + ox: 1 + ox + X, 128 + oy: 128 + oy + Y,
                       128 + oz: 128 + oz + Z]
        acc = term if acc is None else acc + term
    assert torch.equal(y, acc)


# -- K6b's window march: the Python mirrors of its geometry and route -------

# (X, Y, Z): (tiles, planes per chunk, blocks), from ``w3_geometry`` of
# csrc/common.cuh (also checked when the library loads): 16 x 256 (y, z)
# tiles, x chunks aiming at 396 blocks, no more than X / 4 of them
WINDOW_GEOMETRY = {
    (256, 256, 256): (16, 11, 384),   # phase 4m's volume
    (64, 256, 256): (16, 4, 256),     # one of its 4 pieces
    (37, 45, 130): (3, 4, 30),
    (1, 5, 301): (2, 1, 2),
    (20, 7, 129): (1, 4, 5),
    (17, 9, 256): (1, 4, 5),
    (4, 8, 256): (1, 4, 1),
}


@pytest.mark.parametrize("shape", list(WINDOW_GEOMETRY))
def test_window_geometry_mirrors_csrc(shape):
    """The window march's geometry is a function of the volume alone (so
    is the sum order of K6b's dot), its chunks cover X, and
    ``march_scratch`` holds a partial for each of its blocks."""
    X, Y, Z = shape
    tiles, chunk, blocks = T3.window3d_geometry(X, Y, Z)
    assert (tiles, chunk, blocks) == WINDOW_GEOMETRY[shape]
    assert blocks // tiles * chunk >= X > (blocks // tiles - 1) * chunk
    assert T3.march_scratch_size(X, Y, Z) >= blocks


# (offsets, Z): (K6b's kernel, window bytes or None off the window march)
WINDOW_ROUTE = {
    "S_WIDE at Z = 256": (kw_of(S_WIDE)["offsets"], 256, "window",
                          3 * 22 * 256 * 4),   # phase 4m: 67.6 KB
    "S_127 at Z = 128": (kw_of(S_127)["offsets"], 128, "window",
                         3 * 22 * 128 * 4),
    "S_WIDE at Z = 301": (kw_of(S_WIDE)["offsets"], 301, "window",
                          3 * 22 * 301 * 4),
    "|oy| = 8, |oz| = 128 at Z = 4096": (offs((0, 8, -128), (0, 0, 128)),
                                         4096, "window", 3 * 32 * 512 * 4),
    "reach 2 at Z = 256": (offs((0, 2, 0), (0, 0, -2)), 256, "window",
                           3 * 20 * 256 * 4),
    "7-point": (offs((-1, 0, 0), (1, 0, 0), (0, -1, 0), (0, 1, 0),
                     (0, 0, -1), (0, 0, 1)), 256, "march1", None),
    "27-point": (tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                       for c in (-1, 0, 1)), 256, "march1", None),
}


@pytest.mark.parametrize("case", list(WINDOW_ROUTE))
def test_xpay_pq3d_route_and_window(case):
    """K6b's dispatch: reach-1 stencils keep march1, every other stencil of
    the gate (reach 2..8, wide z) takes the window march, whose three
    planes fit the kernel's 192 KB for the widest window the gate allows
    (|oy| = 8, |oz| = 128)."""
    o, Z, route, smem = WINDOW_ROUTE[case]
    assert T3.supports3d(4, 16, Z, o)
    assert T3.xpay_pq3d_route(o) == route
    if smem is not None:
        assert T3.window3d_smem(Z, o) == smem <= 3 * 32 * 512 * 4


# Every 3-D pass by its LAUNCHES name, and the march it runs off march1:
# the window march for each (csrc/stencil3d.cu, csrc/bicgstab3d.cu)
PASSES3D = {"y3d": "window", "y_dot3d": "window", "pq3d": "window",
            "update3d": "window", "xpay_pq3d": "window",
            "bicg3d_pv": "window", "bicg3d_st": "window",
            "bicg3d_update": "window"}


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("case", list(WINDOW_ROUTE))
@pytest.mark.parametrize("name", list(PASSES3D))
def test_route3d(name, case, compensated):
    """The mirror of the kernels' dispatch: reach-1 stencils run march1
    (but K7 update with compensated dots, march3d), every other stencil of
    the gate the window march."""
    o, _, k6b, _ = WINDOW_ROUTE[case]
    if k6b != "march1":
        want = PASSES3D[name]
    elif name == "bicg3d_update" and compensated:
        want = "march3d"
    else:
        want = "march1"
    assert T3.route3d(name, o, compensated) == want
    assert T3.xpay_pq3d_route(o) == k6b


def test_route3d_refuses_other_passes():
    with pytest.raises(ValueError, match="not a 3-D pass"):
        T3.route3d("bicg_pv", kw_of(S_WIDE)["offsets"])


# K7's passes on the window march and the doubles each keeps per block
# with compensated dots: pv one, st and update two
K7_DOUBLES = {"bicg3d_pv": 1, "bicg3d_st": 2, "bicg3d_update": 2}


@pytest.mark.parametrize("shape", list(WINDOW_GEOMETRY))
@pytest.mark.parametrize("name", list(K7_DOUBLES))
def test_march_scratch_holds_compensated_pv(name, shape, monkeypatch):
    """Each K7 pass on the window march with compensated dots (and st and
    update with f32 dots too) keeps its doubles per block, and the shared
    scratch has room for them: float64 partials, two for each window block
    (and each block of the other marches), the counter zero."""
    X, Y, Z = shape
    blocks = WINDOW_GEOMETRY[shape][2]
    for compensated in (False, True):
        assert T3.route3d(name, kw_of(S_WIDE)["offsets"],
                          compensated) == "window"
    monkeypatch.setattr(T3, "_raw_stream", lambda device: 0)
    monkeypatch.setattr(T3, "_MARCH_SCRATCH", {})
    partials, capacity, counter = T3.march_scratch(torch.device(DEV), X, Y,
                                                   Z)
    assert partials.dtype == torch.float64
    assert capacity >= max(blocks, T3.blocks3d(X, Y, Z),
                           T3.march1_geometry(X, Y, Z)[2])
    assert partials.numel() >= 2 * capacity >= K7_DOUBLES[name] * blocks
    assert counter.numel() == 1 and not counter.any()


# -- the view, the matvec and the solves -------------------------------------

def port_op(shape, stencil, pieces=1):
    return system(T, shape, pieces, stencil=stencil)[1]


@pytest.mark.parametrize("shape,stencil,pieces,same", [
    (SHAPE, S_WIDE, 1, True),
    ((5, 16, 128), S_127, 1, True),
    ((5, 16, 128), S_WIDE, 1, False),
    (SHAPE4, S_WIDE, 4, True),
])
def test_view_and_matvec_match_jax(shape, stencil, pieces, same, mesh4):
    """The port plans the ``3d`` view where JAX does (but (5, 16, 128)
    with |oz| = Z: linearized there); the matvec matches JAX's either
    way."""
    n = int(np.prod(shape))
    opt = port_op(shape, stencil, pieces)
    opj = J.StencilOperator(shape, stencil,
                            partition=J.BlockPartition(n, pieces),
                            mesh=mesh4 if pieces == 4 else None,
                            options=opts(J))
    assert opj.uses_pallas and opj._view["kind"] == "3d"
    assert opt.uses_pallas is same
    if same:
        assert opt._view["kind"] == "3d"
        assert opt._view["offs3"] == opj._view["offs3"]
        assert opt._view["Br"] == opj._view["Br"] == shape[0] // pieces
    x = np.random.default_rng(3).standard_normal(n).astype(np.float32)
    y = opt.matvec(torch.from_numpy(x)).numpy().reshape(-1)
    yj = np.asarray(opj.matvec(jnp.asarray(x))).reshape(-1)
    np.testing.assert_allclose(y, yj, rtol=0, atol=1e-5 * np.abs(yj).max())


def test_build_stencil_system_takes_a_stencil():
    """``stencil=`` replaces the -dim stencil, on the 3-D view with grid
    vectors; the default is the -dim Laplacian."""
    planner = build_stencil_system(3, SHAPE, F32T, DEV, stencil=S_WIDE)
    op = planner.row_partitioned_matrices[0][0]
    assert op.offsets == S_WIDE and op._view["kind"] == "3d"
    assert planner.rhs_vectors[0].grid_shape == SHAPE
    default = build_stencil_system(3, SHAPE, F32T, DEV)
    assert default.row_partitioned_matrices[0][0].offsets == \
        T.laplacian_stencil(3)


def test_fused_cg_matches_jax():
    """One piece: the two-pass 3-D runner (K6a pq, K6b, K6a update) on
    the plain versions against JAX's on its interpret-mode kernels."""
    pj, _ = system(J, SHAPE, 1, stencil=S_WIDE)
    pt = build_stencil_system(3, SHAPE, F32T, DEV, stencil=S_WIDE)
    st = T.CGSolver(pt)
    assert st._make_fused_runner(10) is not None
    hist_j = np.asarray(J.CGSolver(pj).solve(10))
    hist_t = hist_of(st.solve(10))
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    xj = sol(pj)
    np.testing.assert_allclose(sol(pt), xj, rtol=0,
                               atol=1e-4 * np.abs(xj).max())


def test_fused_bicgstab_matches_jax():
    """One piece: the fused 3-D BiCGStab (K7 pv, st, update) against
    JAX's, 6 iterations (before f32 BiCGStab leaves float64: JAX's own f32
    history stays within 1e-4 of a float64 run there, checked here)."""
    T2.reset_launch_counts()
    pj, _ = system(J, SHAPE, 1, stencil=S_WIDE)
    pt = build_stencil_system(3, SHAPE, F32T, DEV, stencil=S_WIDE)
    assert pt.row_partitioned_matrices[0][0].supports_fused_bicgstab
    hist_j = np.asarray(J.BiCGStabSolver(pj).solve(6))
    hist_t = hist_of(T.BiCGStabSolver(pt).solve(6))
    p64 = build_stencil_system(3, SHAPE, T.SolverOptions(
        entry_dtype=torch.float64), DEV, stencil=S_WIDE)
    h64 = hist_of(T.BiCGStabSolver(p64).solve(6))
    np.testing.assert_allclose(hist_j, h64, rtol=1e-4)
    np.testing.assert_allclose(hist_t, hist_j, rtol=3e-3)
    xj = sol(pj)
    np.testing.assert_allclose(sol(pt), xj, rtol=0,
                               atol=5e-3 * np.abs(xj).max())
    assert sum(T2.LAUNCHES.values()) == 0  # CPU tensors launch nothing


def test_cg_on_4_pieces_matches_jax(mesh4):
    """(12, 4, 256) on 4 pieces: K6a/K6b per piece on the neighbours'
    exchanged planes (the (+-1, 0, +-128) terms read them) against JAX's
    sharded runner on ``mesh4``, and against one piece of the port."""
    pj, _ = system(J, SHAPE4, 4, stencil=S_WIDE)
    pt, op = system(T, SHAPE4, 4, stencil=S_WIDE)
    assert op._view["kind"] == "3d" and op._view["Br"] == 3
    hist_j = hist_of(J.CGSolver(pj).solve(10))
    hist_t = hist_of(T.CGSolver(pt).solve(10))
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-4)
    xj = sol(pj)
    np.testing.assert_allclose(sol(pt), xj, rtol=0,
                               atol=1e-4 * np.abs(xj).max())
    p1, _ = system(T, SHAPE4, 1, stencil=S_WIDE)
    np.testing.assert_allclose(hist_t, hist_of(T.CGSolver(p1).solve(10)),
                               rtol=1e-4)


# -- K1 nop (item D) ----------------------------------------------------------

NOP_KW = dict(offsets=((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)),
              values=(4.0, -1.0, -1.0, -1.0, -1.0))


def test_nop_plain_matches_jax():
    """K1's nop mode: x'' = x + r, r'' = r, p'' = p, g[0] = <r, p>, the
    other Gram entries zero, against JAX's ``_sstep_call(mode="nop")`` in
    interpret mode."""
    rng = np.random.default_rng(17)
    x, r, p = (rng.standard_normal((64, 128)).astype(np.float32)
               for _ in range(3))
    coef = rng.uniform(0.1, 0.5, 6).astype(np.float32)
    xo, ro, po, g = J2._sstep_call(
        jnp.asarray(r), jnp.asarray(p), (jnp.asarray(x), jnp.asarray(coef)),
        mode="nop", interpret=True, **NOP_KW)
    xt = torch.from_numpy(x.copy())
    got = T2._grid2d_cg_nop(xt, torch.from_numpy(r), torch.from_numpy(p),
                            torch.from_numpy(coef), **NOP_KW)
    assert got[0] is xt
    for have, want in zip(got[:3], (xo, ro, po)):
        np.testing.assert_array_equal(have.numpy(), np.asarray(want))
    gj = np.asarray(g).reshape(-1)
    scale = np.linalg.norm(r.astype(np.float64)) * np.linalg.norm(
        p.astype(np.float64))
    assert abs(float(got[3][0]) - float(gj[0])) <= 1e-5 * scale
    assert not got[3][1:].any() and not gj[1:].any()


@pytest.mark.parametrize("bad", ["reach2", "alias", "shape"])
def test_nop_refuses(bad):
    x, r, p = (torch.zeros(64, 128) for _ in range(3))
    coef = torch.zeros(6)
    call = {
        "reach2": lambda: T2._grid2d_cg_nop(
            x, r, p, coef, offsets=((0, 0), (2, 0)), values=(1.0, 1.0)),
        "alias": lambda: T2._grid2d_cg_nop(x, r, p, coef, out=(r, p),
                                           **NOP_KW),
        "shape": lambda: T2._grid2d_cg_nop(x[:8], r, p, coef, **NOP_KW),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        call()
