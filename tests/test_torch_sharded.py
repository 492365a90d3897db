"""The port's pieces (``parallel/mesh.py``, ``overlap.py``,
``sstep_sharded.py`` and the sharded paths of ``stencil_op.py``) against
the JAX package's sharded code.

The JAX side runs on the conftest's 8 virtual CPU devices with its Pallas
kernels in interpret mode; the port puts its S shards on the CPU
(``make_mesh(S, devices=["cpu"] * S)``) and runs the plain versions its
wrappers take on CPU tensors.  The solve-level cases mirror
``tests/test_20_sstep.py``, ``test_18_overlap.py``, ``test_10_grid_layout
.py`` and ``test_14_fused_cg.py`` at their sizes and tolerances, and each
also holds the port's history against JAX's for the same pieces within
that tolerance.  The helpers of ``overlap.py`` and ``sstep_sharded.py``
are held against JAX's on numpy inputs from a seed (rtol 1e-6: the same
f32 algebra, summed in another order).  The float64 golden trajectory of
the 1-D Laplacian must come out exactly on 4 and on 8 pieces.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.parallel import overlap as JO
from legionsolvers_tpu.parallel import sstep_sharded as JS
from legionsolvers_tpu.parallel.mesh import make_mesh as jax_mesh
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TK
from legionsolvers_tpu_torch.parallel import overlap as TO
from legionsolvers_tpu_torch.parallel import sstep_sharded as TS
from legionsolvers_tpu_torch.parallel.mesh import make_mesh
from tests.test_08_stencil import dense_stencil

torch.set_num_threads(2)

DEV = "cpu"
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]
F32J = J.SolverOptions(entry_dtype=jnp.float32)
F32T = T.SolverOptions(entry_dtype=torch.float32)
F64T = T.SolverOptions(entry_dtype=torch.float64)
OFFS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)


def cpu_mesh(pieces):
    return make_mesh(pieces, devices=[DEV] * pieces) if pieces > 1 else None


def build(pkg, shape, pieces, grid=True, options=None):
    """(planner, operator) of the Laplacian on ``shape``, b = 1, x0 = 0, in
    ``pieces`` pieces on a mesh (none for one piece); grid layout where the
    kernel view is active and ``grid``."""
    n = int(np.prod(shape))
    part = pkg.BlockPartition(n, pieces)
    if pkg is J:
        F = options or F32J
        mesh = jax_mesh(pieces) if pieces > 1 else None
        dev = {}
    else:
        F = options or F32T
        mesh = cpu_mesh(pieces)
        dev = {"device": DEV}
    op = pkg.StencilOperator(shape, pkg.laplacian_stencil(len(shape)),
                             partition=part, mesh=mesh, options=F, **dev)
    gs = shape if grid and op.uses_pallas else None
    planner = pkg.SquarePlanner(mesh=mesh, options=F, **dev)
    planner.add_sol_vector(pkg.PartitionedVector(
        "sol", part, mesh=mesh, options=F, grid_shape=gs, **dev).zero_fill())
    planner.add_rhs_vector(pkg.PartitionedVector(
        "rhs", part, mesh=mesh, options=F, grid_shape=gs,
        **dev).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    return planner, op


def solve(pkg, shape, pieces, iters, grid=True, fused=True):
    """(history, x) of CGSolver.solve(iters) as numpy arrays."""
    planner, _ = build(pkg, shape, pieces, grid)
    solver = pkg.CGSolver(planner)
    if not fused:
        solver._make_fused_runner = lambda k: None
    hist = np.asarray(solver.solve(iters))
    return hist, planner.sol_vectors[0].to_numpy()


@functools.lru_cache(maxsize=None)
def jax_solve(shape, pieces, iters, env=(), grid=True):
    """The JAX package's (history, x), under the environment ``env``
    ((name, value) pairs), computed once per case."""
    saved = {k: os.environ.get(k) for k, _ in env}
    os.environ.update(dict(env))
    try:
        return solve(J, shape, pieces, iters, grid)
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


# -- test_20_sstep.py ------------------------------------------------------

def test_sstep_sharded_eligibility(mesh4):
    """test_20:174.  Pieces on a mesh with local blocks >= 16 rows are
    s-step eligible; 8-row blocks keep the two-pass schedule; several
    pieces without a mesh are not eligible.  Both packages agree."""
    cases = [((64, 128), 4, True), ((32, 128), 4, True),
             ((64, 128), 4, False)]
    for shape, pieces, with_mesh in cases:
        n = int(np.prod(shape))
        ops = {}
        for pkg, mesh, F, dev in ((J, mesh4, F32J, {}),
                                  (T, cpu_mesh(pieces), F32T,
                                   {"device": DEV})):
            ops[pkg] = pkg.StencilOperator(
                shape, pkg.laplacian_stencil(2),
                partition=pkg.BlockPartition(n, pieces),
                mesh=mesh if with_mesh else None, options=F, **dev)
        for attr in ("uses_pallas", "step2_eligible"):
            assert getattr(ops[T], attr) == getattr(ops[J], attr), attr
        if with_mesh:
            assert ops[T].supports_fused_cg and ops[J].supports_fused_cg
    op = T.StencilOperator((64, 128), T.laplacian_stencil(2),
                           partition=T.BlockPartition(64 * 128, 4),
                           mesh=cpu_mesh(4), options=F32T)
    assert op.step2_eligible
    small = T.StencilOperator((32, 128), T.laplacian_stencil(2),
                              mesh=cpu_mesh(4), options=F32T)
    assert small.supports_fused_cg and not small.step2_eligible


@pytest.mark.parametrize("pieces,iters", [(4, 2), (4, 9), (4, 20), (8, 12)])
def test_sstep_sharded_matches_classic(pieces, iters, monkeypatch):
    """test_20:248.  The sharded s-step solve (zero-halo K1 per piece plus
    the edge and Gram fix-ups) against the sharded two-pass solve: history
    rtol 1e-3, x atol 2e-3 max|x|; and against JAX's sharded s-step
    history, rtol 1e-3."""
    shape = (16 * pieces, 128)  # Br = 16: the smallest eligible block
    _, op = build(T, shape, pieces)
    assert op.step2_eligible
    h2, x2 = solve(T, shape, pieces, iters)
    monkeypatch.setenv("LEGIONSOLVERS_NO_SSTEP", "1")
    _, op1 = build(T, shape, pieces)
    assert not op1.step2_eligible and op1.supports_fused_cg
    h1, x1 = solve(T, shape, pieces, iters)
    monkeypatch.delenv("LEGIONSOLVERS_NO_SSTEP")
    np.testing.assert_allclose(h2, h1, rtol=1e-3)
    np.testing.assert_allclose(x2, x1, rtol=0, atol=2e-3 * np.abs(x1).max())
    hj, _ = jax_solve(shape, pieces, iters)
    np.testing.assert_allclose(h2, hj, rtol=1e-3)


def test_sstep_sharded_matches_single_shard():
    """test_20:273.  4 pieces against 1 at (128, 128) over 14 iterations:
    history rtol 5e-4, x atol 1e-4 max|x|; the 4-piece history against
    JAX's, rtol 5e-4."""
    shape = (128, 128)
    h4, x4 = solve(T, shape, 4, 14)
    h1, x1 = solve(T, shape, 1, 14)
    np.testing.assert_allclose(h4, h1, rtol=5e-4)
    np.testing.assert_allclose(x4, x1, rtol=0, atol=1e-4 * np.abs(x1).max())
    hj, _ = jax_solve(shape, 4, 14)
    np.testing.assert_allclose(h4, hj, rtol=5e-4)


def test_sstep_sharded_refresh(monkeypatch):
    """test_20:292.  With LEGIONSOLVERS_SSTEP_REFRESH=2 the K2 refresh
    passes go through the sharded fix-up too: the 4-piece s-step history
    against the two-pass one and against JAX's, rtol 1e-3."""
    monkeypatch.setenv("LEGIONSOLVERS_SSTEP_REFRESH", "2")
    shape = (128, 128)
    counts = {}
    real = TK.grid2d_cg_gram2

    def counted(*a, **kw):
        counts["gram2"] = counts.get("gram2", 0) + 1
        return real(*a, **kw)

    monkeypatch.setattr(TK, "grid2d_cg_gram2", counted)
    h, _ = solve(T, shape, 4, 20)
    # 10 passes, refresh every 2: 5 Gram passes of 4 pieces each
    assert counts["gram2"] == 5 * 4
    hj, _ = jax_solve(shape, 4, 20, (("LEGIONSOLVERS_SSTEP_REFRESH", "2"),))
    np.testing.assert_allclose(h, hj, rtol=1e-3)
    monkeypatch.setenv("LEGIONSOLVERS_NO_SSTEP", "1")
    h1, _ = solve(T, shape, 4, 20)
    np.testing.assert_allclose(h, h1, rtol=1e-3)


# -- test_18_overlap.py ------------------------------------------------------

def test_stencil_matvec_overlap_agreement(mesh4):
    """test_18:74.  The sharded f32 matvec (a zero-halo K3 pass per piece
    plus the edge fix-up) against the dense oracle (rtol 1e-4, atol 1e-6),
    the one-piece matvec (rtol 1e-5, atol 1e-7) and JAX's sharded matvec
    (rtol 1e-5, atol 1e-7); the fused dot against x . (A x), rel 1e-4."""
    shape = (32, 128)
    n = 32 * 128
    A = dense_stencil(shape, T.laplacian_stencil(2))
    xh = np.random.default_rng(0).random(n).astype(np.float32)
    _, op = build(T, shape, 4)
    _, op1 = build(T, shape, 1)
    assert op.uses_pallas
    part = T.BlockPartition(n, 4)
    x = T.PartitionedVector.from_array("x", xh, part, mesh=cpu_mesh(4),
                                       options=F32T)
    y = op.matvec(x.data).numpy()
    y1 = op1.matvec(torch.from_numpy(xh)).numpy()
    np.testing.assert_allclose(y, A @ xh, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(y, y1, rtol=1e-5, atol=1e-7)
    opj = J.StencilOperator(shape, J.laplacian_stencil(2),
                            partition=J.BlockPartition(n, 4), mesh=mesh4,
                            options=F32J)
    xj = J.PartitionedVector.from_array("x", xh, J.BlockPartition(n, 4),
                                        mesh=mesh4, options=F32J)
    np.testing.assert_allclose(y, np.asarray(opj.matvec(xj.data)),
                               rtol=1e-5, atol=1e-7)
    yd, d = op.matvec_dot(x.data)
    np.testing.assert_array_equal(yd.numpy(), y)
    assert float(d) == pytest.approx(float(xh @ (A @ xh)), rel=1e-4)
    # grid layout in, grid layout out
    yg = op.matvec(x.data.reshape(shape))
    assert yg.shape == shape and np.array_equal(yg.numpy().reshape(-1), y)


def test_pass_one_kernels_receive_no_halos(monkeypatch):
    """test_18:102's counterpart.  On pieces, the pass-1 kernels (K3 y,
    y_dot and pq, K4, K1, K2) are called with zero halo blocks (None), so
    they do not wait on the exchange; K3 update gets its halo blocks as
    fresh tensors, never views of a vector."""
    calls = []

    def spy(name):
        real = getattr(TK, name)

        def run(*a, **kw):
            calls.append((name, a, kw))
            return real(*a, **kw)

        monkeypatch.setattr(TK, name, run)

    for name in ("grid2d_stencil_matvec", "grid2d_cg_pq", "grid2d_cg_update",
                 "grid2d_cg_xpay_pq", "grid2d_cg_gram2", "grid2d_cg_step2"):
        spy(name)
    planner, op = build(T, (64, 128), 4)
    solver = T.CGSolver(planner)
    solver.solve(3)
    monkeypatch.setenv("LEGIONSOLVERS_NO_SSTEP", "1")
    planner, op = build(T, (64, 128), 4)
    solver = T.CGSolver(planner)
    solver.step()
    solver.solve(3)
    vectors = {v.data.untyped_storage().data_ptr()
               for vs in (planner.sol_vectors, planner.rhs_vectors,
                          *planner.workspace_vectors) for v in vs
               if v._data is not None}
    names = {c[0] for c in calls}
    assert names == {"grid2d_stencil_matvec", "grid2d_cg_pq",
                     "grid2d_cg_update", "grid2d_cg_xpay_pq",
                     "grid2d_cg_gram2", "grid2d_cg_step2"}
    for name, a, kw in calls:
        if name in ("grid2d_stencil_matvec", "grid2d_cg_pq"):
            assert a[1:] == () and "halo_top" not in kw, name
        elif name == "grid2d_cg_xpay_pq":
            assert len(a) == 3 and not any(
                k in kw for k in ("r_top", "r_bot", "p_top", "p_bot")), name
        elif name == "grid2d_cg_update" and len(a) > 4:
            for h in a[4:6]:
                assert h.shape == (8, 128)
                assert h.untyped_storage().data_ptr() not in vectors


def test_fused_cg_overlap_agreement():
    """test_18:131.  The sharded two-pass CG (8-row blocks: no s-step) at
    (32, 128) over 15 iterations on flat vectors against one piece:
    history rtol 2e-3, x rtol 1e-3 atol 1e-6; and against JAX's 4-shard
    history, rtol 2e-3."""
    shape = (32, 128)
    h4, x4 = solve(T, shape, 4, 15, grid=False)
    h1, x1 = solve(T, shape, 1, 15, grid=False)
    np.testing.assert_allclose(h4, h1, rtol=2e-3)
    np.testing.assert_allclose(x4, x1, rtol=1e-3, atol=1e-6)
    hj, _ = jax_solve(shape, 4, 15, grid=False)
    np.testing.assert_allclose(h4, hj, rtol=2e-3)


# -- test_10_grid_layout.py, test_14_fused_cg.py ------------------------------

def test_grid_cg_matches_flat():
    """test_10:43.  4 pieces at (128, 128), 8 iterations, grid layout
    against flat: history rtol 1e-3, x rtol 1e-2 atol 1e-5; the grid
    history against JAX's, rtol 1e-3."""
    shape = (128, 128)
    h_flat, x_flat = solve(T, shape, 4, 8, grid=False)
    h_grid, x_grid = solve(T, shape, 4, 8)
    np.testing.assert_allclose(h_grid, h_flat, rtol=1e-3)
    np.testing.assert_allclose(x_grid, x_flat, rtol=1e-2, atol=1e-5)
    hj, _ = jax_solve(shape, 4, 8)
    np.testing.assert_allclose(h_grid, hj, rtol=1e-3)


def test_fused_cg_matches_generic_2d():
    """test_14:64.  4 pieces at (64, 128), 8 iterations: the fused solve
    against the generic step() loop, history rtol 1e-4, x rtol 1e-3 atol
    1e-6; the fused history against JAX's, rtol 1e-4."""
    shape = (64, 128)
    hg, xg = solve(T, shape, 4, 8, fused=False)
    hf, xf = solve(T, shape, 4, 8)
    np.testing.assert_allclose(hf, hg, rtol=1e-4)
    np.testing.assert_allclose(xf, xg, rtol=1e-3, atol=1e-6)
    hj, _ = jax_solve(shape, 4, 8)
    np.testing.assert_allclose(hf, hj, rtol=1e-4)


# -- the fp64 golden on the linearized sharded path --------------------------

@pytest.mark.parametrize("eager", [False, True])
@pytest.mark.parametrize("pieces", [4, 8])
def test_golden_on_pieces(pieces, eager):
    """The n = 100 1-D Laplacian in float64 on 4 and 8 pieces (8: padded
    to 104) through the linearized sharded path: the exact golden
    history, by solve() (the recompute runner) and by step()."""
    part = T.BlockPartition(100, pieces)
    mesh = cpu_mesh(pieces)
    op = T.StencilOperator((100,), T.laplacian_stencil(1), partition=part,
                           mesh=mesh, options=F64T)
    assert not op.uses_pallas and op.supports_fused_cg
    planner = T.SquarePlanner(mesh=mesh, options=F64T)
    planner.add_sol_vector(T.PartitionedVector("sol", part, mesh=mesh,
                                               options=F64T))
    planner.add_rhs_vector(T.PartitionedVector(
        "rhs", part, mesh=mesh, options=F64T).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    solver = T.CGSolver(planner)
    if eager:
        for _ in range(10):
            solver.step()
        hist = [s.get_value() for s in solver.residual_norm_squared]
    else:
        hist = solver.solve(10).tolist()
    assert hist == GOLDEN


@pytest.mark.parametrize("shape,pieces", [((100,), 4), ((30,), 3),
                                          ((12, 10), 4), ((64,), 8)])
def test_linearized_pieces_match_one_piece(shape, pieces):
    """The linearized matvec on several pieces (each piece's band from
    its neighbours), with a mesh and without, equals the one-piece matvec
    exactly, in float64, padded pieces included."""
    stencil = T.laplacian_stencil(len(shape))
    n = int(np.prod(shape))
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(n))
    op1 = T.StencilOperator(shape, stencil, options=F64T, device=DEV)
    ref = op1.matvec(x)
    for mesh in (cpu_mesh(pieces), None):
        part = T.BlockPartition(n, pieces)
        op = T.StencilOperator(shape, stencil, partition=part, mesh=mesh,
                               options=F64T, device=DEV)
        xp = torch.zeros(part.padded_size, dtype=torch.float64)
        xp[:n] = x
        y = op.matvec(xp)
        assert torch.equal(y[:n], ref) and not y[n:].any()


def test_wide_band_gathers_its_window():
    """A band wider than a block (the 2-D Laplacian's row offset 8 on
    (4, 8) in 8 pieces of 4): the sharded linearized matvec gathers each
    window from the whole vector and still equals the dense product."""
    shape = (4, 8)
    op = T.StencilOperator(shape, T.laplacian_stencil(2),
                           partition=T.BlockPartition(32, 8),
                           mesh=cpu_mesh(8), options=F64T)
    assert op._wide_band and not op.uses_pallas
    x = np.random.default_rng(6).standard_normal(32)
    y = op.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, dense_stencil(shape, op.offsets) @ x,
                               rtol=1e-12, atol=1e-12)


# -- function-level: overlap.py and sstep_sharded.py against JAX --------------

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dx", [-130, -3, 0, 1, 127, 128])
def test_colshift_matches_jax(dx):
    a = _rand(np.random.default_rng(1), 5, 128)
    np.testing.assert_array_equal(
        TO.colshift(torch.from_numpy(a), dx).numpy(),
        np.asarray(JO.colshift(jnp.asarray(a), dx)))


OFFSET_SETS = {"cross": (OFFS, VALS),
               "reach2": (((0, 0), (-2, 1), (2, -1), (-1, 0), (1, 3)),
                          (3.0, -0.5, -1.5, 2.0, 0.25))}


@pytest.mark.parametrize("kind", list(OFFSET_SETS))
def test_edge_fixups_match_jax(kind):
    """edge_missing, apply_edge_fixup and dot_fixup on one [Br, C] piece
    against JAX's (rtol 1e-6), and on a stack of 3 pieces equal to the
    pieces one by one."""
    offs, vals = OFFSET_SETS[kind]
    rng = np.random.default_rng(2)
    Br, C = 16, 128
    x, y, top, bot = (_rand(rng, Br, C), _rand(rng, Br, C),
                      _rand(rng, 8, C), _rand(rng, 8, C))
    coeff_t = lambda k, sl: vals[k]
    coeff_j = lambda k, sl: jnp.asarray(vals[k], jnp.float32)
    t = [torch.from_numpy(a) for a in (x, y, top, bot)]
    j = [jnp.asarray(a) for a in (x, y, top, bot)]
    mt, mb = TO.edge_missing(offs, t[2], t[3], Br, coeff_t)
    jt, jb = JO.edge_missing(offs, j[2], j[3], Br, coeff_j)
    np.testing.assert_allclose(mt.numpy(), np.asarray(jt), rtol=1e-6)
    np.testing.assert_allclose(mb.numpy(), np.asarray(jb), rtol=1e-6)
    yt = TO.apply_edge_fixup(t[1].clone(), offs, t[2], t[3], coeff_t)
    yj = JO.apply_edge_fixup(j[1], offs, j[2], j[3], coeff_j)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        float(TO.dot_fixup(t[0], offs, t[2], t[3], coeff_t)),
        float(JO.dot_fixup(j[0], offs, j[2], j[3], coeff_j)), rtol=1e-5)
    # a stack of pieces: the same, piece by piece
    xs, ys, tops, bots = (torch.from_numpy(_rand(rng, 3, *s)) for s in
                          ((Br, C), (Br, C), (8, C), (8, C)))
    fix = TO.dot_fixup(xs, offs, tops, bots, coeff_t)
    ystack = TO.apply_edge_fixup(ys.clone(), offs, tops, bots, coeff_t)
    for s in range(3):
        assert torch.equal(fix[s], TO.dot_fixup(xs[s], offs, tops[s],
                                                 bots[s], coeff_t))
        assert torch.equal(ystack[s], TO.apply_edge_fixup(
            ys[s].clone(), offs, tops[s], bots[s], coeff_t))


def test_sstep_helpers_match_jax():
    """_apply, _gram10, _chain_step2 and _chain_gram2 on an [EXT, C] slab
    against JAX's (rtol 1e-5, atol 1e-5 * scale), and on a stack of slabs
    equal to the slabs one by one."""
    rng = np.random.default_rng(3)
    E, C = TS.EXT, 128
    x, r, p = (_rand(rng, E, C) for _ in range(3))
    invalid = np.zeros(E, np.float32)
    invalid[:TS.HALO] = 1.0
    r[:TS.HALO] = p[:TS.HALO] = 0.0
    coef = np.array([0.3, 0.2, 0.05, 0.4, 0.01, 0.3], np.float32)
    tt = [torch.from_numpy(a) for a in (x, r, p, coef, invalid)]
    jj = [jnp.asarray(a) for a in (x, r, p, coef, invalid)]

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())

    close(TS._apply(tt[1], OFFS, VALS), JS._apply(jj[1], OFFS, VALS))
    for a, b in zip(TS._chain_step2(*tt[:4], OFFS, VALS, tt[4]),
                    JS._chain_step2(*jj[:4], OFFS, VALS, jj[4])):
        close(a, b)
    qt = TS._chain_gram2(tt[1], tt[2], OFFS, VALS, tt[4])
    qj = JS._chain_gram2(jj[1], jj[2], OFFS, VALS, jj[4])
    for a, b in zip(qt, qj):
        close(a, b)
    close(TS._gram10(*qt), JS._gram10(*qj))
    # stacked slabs give the slabs' own results
    stack = [torch.stack([a, 0.5 * a]) for a in tt[:3]]
    inv2 = torch.stack([tt[4], tt[4]])
    q2 = TS._chain_step2(*stack, tt[3], OFFS, VALS, inv2)
    q1 = TS._chain_step2(*(a[1] for a in stack), tt[3], OFFS, VALS, tt[4])
    for a, b in zip(q2, q1):
        assert torch.equal(a[1], b)
    g2 = TS._gram10(*q2[1:])
    assert g2.shape == (2, 10)
    np.testing.assert_allclose(g2[1].numpy(), TS._gram10(*q1[1:]).numpy(),
                               rtol=1e-6)


def test_exchange_halo4():
    """Each piece gets its neighbours' 4 edge rows of r and p, zeros at
    the grid's edges, in fresh tensors."""
    S, Br, C = 3, 16, 8
    r = torch.arange(S * Br * C, dtype=torch.float32).reshape(S * Br, C)
    p = -r
    rt, pt, rb, pb = TS.exchange_halo4(r, p, S)
    r3 = r.view(S, Br, C)
    assert not rt[0].any() and not rb[S - 1].any()
    for s in range(1, S):
        assert torch.equal(rt[s], r3[s - 1, -4:])
        assert torch.equal(pt[s], -r3[s - 1, -4:])
    for s in range(S - 1):
        assert torch.equal(rb[s], r3[s + 1, :4])
        assert torch.equal(pb[s], -r3[s + 1, :4])
    for h in (rt, pt, rb, pb):
        assert h.untyped_storage().data_ptr() not in (
            r.untyped_storage().data_ptr(), p.untyped_storage().data_ptr())


@pytest.mark.parametrize("rows_top,rows_bot", [(1, 1), (0, 2), (3, 0)])
def test_exchange_halos(rows_top, rows_bot):
    """The kernels' halo blocks of every grid: the rows above a piece as
    the top block's last rows, the rows below as the bottom block's first,
    zeros elsewhere and at the grid's edges; each piece's block contiguous
    and in fresh storage."""
    from legionsolvers_tpu_torch.parallel.overlap import exchange_halos

    S, Br, C = 4, 6, 5
    grids = [torch.randn(S * Br, C, generator=torch.Generator().manual_seed(k))
             for k in range(3)]
    tops, bots = exchange_halos(grids, S, rows_top, rows_bot)
    assert len(tops) == len(bots) == 3
    for g, t, b in zip(grids, tops, bots):
        g3 = g.view(S, Br, C)
        want_t = torch.zeros(S, 8, C)
        want_b = torch.zeros(S, 8, C)
        if rows_top:
            want_t[1:, 8 - rows_top:] = g3[:-1, Br - rows_top:]
        if rows_bot:
            want_b[:-1, :rows_bot] = g3[1:, :rows_bot]
        assert torch.equal(t, want_t) and torch.equal(b, want_b)
        for s in range(S):
            assert t[s].is_contiguous() and b[s].is_contiguous()
        for h in (t, b):
            assert h.untyped_storage().data_ptr() not in {
                q.untyped_storage().data_ptr() for q in grids}


# -- the mesh and its errors -------------------------------------------------

def test_mesh_api():
    mesh = make_mesh(4, devices=[DEV] * 4)
    assert mesh.shape[T.options.SHARD_AXIS] == 4 == T.num_shards(mesh)
    assert T.single_device_mesh(DEV).shape[T.options.SHARD_AXIS] == 1
    part = T.BlockPartition(64, 4)
    v = T.PartitionedVector("v", part, mesh=mesh, grid_shape=(8, 8))
    assert v.device == torch.device(DEV) and v.mesh == mesh
    assert v.sharding.spec == (T.options.SHARD_AXIS, None)
    assert v.like("w").mesh == mesh and v.copy().mesh == mesh
    w = T.PartitionedVector.from_array("w", np.arange(64.0), part,
                                       mesh=mesh)
    assert w.mesh == mesh and w.sharding.spec == (T.options.SHARD_AXIS,)
    assert T.PartitionedVector("u", part, device=DEV).sharding is None


def test_mesh_errors():
    """Piece mismatch (ValueError), more shards than devices (ValueError),
    shards on two distinct devices (NotImplementedError naming ROADMAP
    item 5g); an explicit matrix on pieces is registered on the pieces
    (a DIA operator on the mesh)."""
    mesh2 = make_mesh(2, devices=[DEV] * 2)
    part4 = T.BlockPartition(64, 4)
    with pytest.raises(ValueError, match="piece count"):
        T.PartitionedVector("v", part4, mesh=mesh2)
    with pytest.raises(ValueError, match="piece count"):
        T.StencilOperator((8, 8), T.laplacian_stencil(2), partition=part4,
                          mesh=mesh2)
    planner = T.SquarePlanner(mesh=mesh2)
    with pytest.raises(ValueError, match="piece count"):
        planner.add_sol_vector(T.PartitionedVector("v", part4, device=DEV))
    with pytest.raises(ValueError, match="only 2 devices"):
        make_mesh(4, devices=[DEV] * 2)
    with pytest.raises(NotImplementedError, match="item 5g"):
        make_mesh(2, devices=[DEV, "meta"])
    with pytest.raises(ValueError, match="mesh's device"):
        T.PartitionedVector("v", T.BlockPartition(64, 2), mesh=mesh2,
                            device="meta")
    planner, op = build(T, (64, 128), 4, grid=False)
    planner.add_row_partitioned_matrix(
        T.coo_negative_laplacian_1d(64 * 128), 0, 0)
    dia = planner.row_partitioned_matrices[-1][0]
    assert isinstance(dia, T.DiaOperator) and dia.mesh is planner.mesh


def test_compensated_dots_on_pieces():
    """Under compensated dots a planner on a mesh sums one compensated
    dot per piece in piece order: within f32 rounding of the float64
    dot."""
    F = T.SolverOptions(entry_dtype=torch.float32, compensated_dots=True)
    mesh = cpu_mesh(4)
    part = T.BlockPartition(1000, 4)
    rng = np.random.default_rng(4)
    a, b = rng.standard_normal(1000), rng.standard_normal(1000)
    planner = T.SquarePlanner(mesh=mesh, options=F)
    planner.add_sol_vector(T.PartitionedVector.from_array(
        "a", a.astype(np.float32), part, mesh=mesh, options=F))
    planner.add_rhs_vector(T.PartitionedVector.from_array(
        "b", b.astype(np.float32), part, mesh=mesh, options=F))
    d = planner.dot(0, 1).get_value()
    a64, b64 = (v.astype(np.float32).astype(np.float64) for v in (a, b))
    parts = [a64[k:k + 250] @ b64[k:k + 250] for k in range(0, 1000, 250)]
    scale = sum(abs(q) for q in parts)
    assert abs(d - a64 @ b64) <= 4 * np.finfo(np.float32).eps * scale
