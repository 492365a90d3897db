"""The fused 2-D BiCGStab, BiCGStab ``step()`` on 3-D pieces, GMRES and PCG
of the port on pieces, against the JAX package's sharded code; the helpers
that ``test_torch_sharded_3d.py`` and ``test_torch_sharded_blocks.py``
share.

The JAX side runs on the conftest's 4- and 8-device CPU meshes with its
Pallas kernels in interpret mode; the port puts its S shards on the CPU
(``make_mesh(S, devices=["cpu"] * S)``) and runs the plain versions its
wrappers take on CPU tensors.  Inputs are made with numpy from seeds.  The
fused BiCGStab cases mirror the sharded cases of
``tests/test_23_bicgstab_fused.py`` (zero-halo K5 passes with their edge
fix-ups) at their sizes and tolerances, and also hold the port's history
against JAX's on the same pieces within that tolerance.  BiCGStab
``step()`` on 3-D pieces, GMRES and PCG on 2-D pieces have no sharded JAX
test of their own: their tolerances are stated in each docstring.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.parallel.mesh import make_mesh as jax_mesh
from legionsolvers_tpu.problems.stencil import stencil_coo_arrays
from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
from legionsolvers_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

DEV = "cpu"
SHAPE3 = (8, 8, 128)  # test_15's SHAPE: 2 x-planes per piece on 4 pieces
DTYPES = {J: {"f32": jnp.float32, "f64": jnp.float64},
          T: {"f32": torch.float32, "f64": torch.float64}}


def opts(pkg, dtype="f32", compensated=False):
    return pkg.SolverOptions(entry_dtype=DTYPES[pkg][dtype],
                             compensated_dots=compensated)


def mesh_of(pkg, pieces):
    if pieces == 1:
        return None
    if pkg is J:
        return jax_mesh(pieces)
    return make_mesh(pieces, devices=[DEV] * pieces)


def on_dev(pkg):
    return {} if pkg is J else {"device": DEV}


def system(pkg, shape, pieces, stencil=None, options=None, rhs=None,
           num_spaces=1, use_pallas=True):
    """(planner, operator): ``stencil`` (default the dimension's Laplacian)
    on ``shape`` in ``pieces`` pieces on a mesh, x0 = 0 and b = 1 (or one
    host array per space in ``rhs``), the operator registered on every
    space; the vectors in the grid layout where the kernel view is on."""
    F = options or opts(pkg)
    n = int(np.prod(shape))
    part = pkg.BlockPartition(n, pieces)
    mesh = mesh_of(pkg, pieces)
    stencil = stencil or pkg.laplacian_stencil(min(len(shape), 3))
    op = pkg.StencilOperator(shape, stencil, partition=part, mesh=mesh,
                             options=F, use_pallas=use_pallas, **on_dev(pkg))
    gs = shape if op.uses_pallas else None
    planner = pkg.SquarePlanner(mesh=mesh, options=F, **on_dev(pkg))
    for i in range(num_spaces):
        planner.add_sol_vector(pkg.PartitionedVector(
            f"s{i}", part, mesh=mesh, options=F, grid_shape=gs,
            **on_dev(pkg)).zero_fill())
    for i in range(num_spaces):
        if rhs is None:
            b = pkg.PartitionedVector(f"b{i}", part, mesh=mesh, options=F,
                                      grid_shape=gs, **on_dev(pkg))
            b.constant_fill(1.0)
        else:
            b = pkg.PartitionedVector.from_array(
                f"b{i}", np.asarray(rhs[i]).reshape(gs or -1), part,
                mesh=mesh, options=F, grid_shape=gs, **on_dev(pkg))
        planner.add_rhs_vector(b)
    for i in range(num_spaces):
        planner.add_operator(op, i, i)
    return planner, op


def sol(planner, space=0):
    return np.asarray(planner.get_vector(0, space).data,
                      dtype=np.float64).reshape(-1)


def hist_of(h):
    return np.asarray(h, dtype=np.float64)


class env:
    """Environment switches for the block (both packages read them when
    their runners are made and called)."""

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


def dense_ref(shape, stencil, x):
    rows, cols, vals, n = stencil_coo_arrays(shape, stencil)
    y = np.zeros(n, dtype=np.float64)
    np.add.at(y, rows, vals * x[cols].astype(np.float64))
    return y


@functools.lru_cache(maxsize=None)
def jax_history(shape, pieces, solver, iters, dim=None, env_items=(),
                compensated=False, seed=None, num_spaces=1):
    """JAX's (history, x of space 0) for ``solver`` on the Laplacian of
    ``dim`` (default the shape's), once per case."""
    stencil = J.laplacian_stencil(dim or min(len(shape), 3))
    rhs = None
    if seed is not None:
        rhs = rhs_draws(shape, num_spaces, seed)
    with env(**dict(env_items)):
        planner, _ = system(J, shape, pieces, stencil=stencil, rhs=rhs,
                            options=opts(J, compensated=compensated),
                            num_spaces=num_spaces)
        h = getattr(J, solver)(planner).solve(iters)
    return hist_of(h), sol(planner)


def rhs_draws(shape, num_spaces, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return [rng.random(n).astype(np.float32) for _ in range(num_spaces)]


# -- the fused 2-D BiCGStab on pieces (test_23) ------------------------------

@pytest.mark.parametrize("pieces,iters", [(4, 1), (4, 8), (8, 6)])
def test_fused_sharded_matches_transcription(pieces, iters):
    """test_23:243.  16-row pieces (the least the fused runner takes): the
    zero-halo K5 passes per piece with their edge fix-ups against the
    step() transcription on the same pieces, history rtol 3e-3, x atol
    5e-3 max|x|; the history against JAX's sharded fused runner, rtol
    3e-3."""
    shape = (16 * pieces, 128)
    planner, op = system(T, shape, pieces)
    assert op.supports_fused_bicgstab
    solver = T.BiCGStabSolver(planner)
    assert solver._make_fused_runner(1) is not None
    h = hist_of(solver.solve(iters))
    with env(LEGIONSOLVERS_NO_FUSED_BICGSTAB="1"):
        p2, op2 = system(T, shape, pieces)
        assert not op2.supports_fused_bicgstab
        h2 = hist_of(T.BiCGStabSolver(p2).solve(iters))
    np.testing.assert_allclose(h, h2, rtol=3e-3)
    x2 = sol(p2)
    np.testing.assert_allclose(sol(planner), x2, rtol=0,
                               atol=5e-3 * np.abs(x2).max())
    hj, _ = jax_history(shape, pieces, "BiCGStabSolver", iters)
    np.testing.assert_allclose(h, hj, rtol=3e-3)


def test_fused_sharded_matches_single_shard():
    """test_23:263.  (128, 128) on 4 pieces against one piece through the
    fused runner, 7 iterations: history rtol 5e-3, x atol 5e-3 max|x|
    (an error in the fix-up algebra would show at the piece edges); the
    4-piece history against JAX's, rtol 5e-3."""
    shape = (128, 128)
    p4, _ = system(T, shape, 4)
    h4 = hist_of(T.BiCGStabSolver(p4).solve(7))
    p1, _ = system(T, shape, 1)
    h1 = hist_of(T.BiCGStabSolver(p1).solve(7))
    np.testing.assert_allclose(h4, h1, rtol=5e-3)
    x1 = sol(p1)
    np.testing.assert_allclose(sol(p4), x1, rtol=0,
                               atol=5e-3 * np.abs(x1).max())
    hj, _ = jax_history(shape, 4, "BiCGStabSolver", 7)
    np.testing.assert_allclose(h4, hj, rtol=5e-3)


def test_fused_sharded_distinct_rhs_first_iterations():
    """A random right-hand side (default_rng(3)) on 4 pieces of (64, 128)
    against one piece: the first three history entries within 1e-5 (the
    fix-ups make the pieces' passes the whole grid's, up to the order of
    the dots' sums), and x after 8 iterations within 1e-4 max|x|."""
    shape = (64, 128)
    b = rhs_draws(shape, 1, 3)
    h, xs = {}, {}
    for pieces in (1, 4):
        planner, _ = system(T, shape, pieces, rhs=b)
        h[pieces] = hist_of(T.BiCGStabSolver(planner).solve(8))
        xs[pieces] = sol(planner)
    np.testing.assert_allclose(h[4][:3], h[1][:3], rtol=1e-5)
    np.testing.assert_allclose(xs[4], xs[1], rtol=0,
                               atol=1e-4 * np.abs(xs[1]).max())


def test_compensated_reaches_every_piece(monkeypatch):
    """With compensated dots every K5 call on pieces gets
    ``compensated=True``; the 4-piece history against JAX's compensated
    sharded runner on (64, 128) over 6 iterations, rtol 3e-3 (test_23's
    sharded bound)."""
    seen = []
    for name in ("bicg_pv", "bicg_st", "bicg_update"):
        real = getattr(TB, name)

        def run(*a, _real=real, _name=name, **kw):
            seen.append((_name, kw.get("compensated")))
            return _real(*a, **kw)

        monkeypatch.setattr(TB, name, run)
    shape = (64, 128)
    planner, _ = system(T, shape, 4, options=opts(T, compensated=True))
    h = hist_of(T.BiCGStabSolver(planner).solve(6))
    assert len(seen) == 3 * 4 * 6 and all(c is True for _, c in seen)
    hj, _ = jax_history(shape, 4, "BiCGStabSolver", 6, compensated=True)
    np.testing.assert_allclose(h, hj, rtol=3e-3)


def test_fused_sharded_is_a_continuation():
    """Four iterations and then four more from the runner's own state
    give the history of eight, within 1e-5 (the carried scalars and
    vectors are the whole state)."""
    shape = (64, 128)
    b = rhs_draws(shape, 1, 4)
    p8, _ = system(T, shape, 4, rhs=b)
    h8 = hist_of(T.BiCGStabSolver(p8).solve(8))
    p4, _ = system(T, shape, 4, rhs=b)
    s4 = T.BiCGStabSolver(p4)
    ha = hist_of(s4.solve(4))
    hb = hist_of(s4.solve(4))
    np.testing.assert_allclose(np.concatenate([ha, hb[1:]]), h8, rtol=1e-5)


# -- BiCGStab step() on 3-D pieces, GMRES and PCG on 2-D pieces -------------

def test_bicgstab_steps_on_3d_pieces():
    """The fused 3-D runner is one piece only (as in JAX), so on 4 pieces
    of (8, 8, 128) BiCGStab runs step() over the sharded matvec.  Its
    history against one piece's step() loop and against JAX's on
    ``mesh4`` (also step()), the first 6 entries rtol 2e-3 (test_27's
    tolerance for BiCGStab is 0.05; these runs share the recurrence and
    differ in the dots' sum order); ||b - A x||^2 within 1e-3 of the last
    entry."""
    planner, op = system(T, SHAPE3, 4)
    assert op._view["kind"] == "3d" and not op.supports_fused_bicgstab
    solver = T.BiCGStabSolver(planner)
    assert solver._make_fused_runner(6) is None
    h = hist_of(solver.solve(6))
    with env(LEGIONSOLVERS_NO_FUSED_BICGSTAB="1"):
        p1, _ = system(T, SHAPE3, 1)
        h1 = hist_of(T.BiCGStabSolver(p1).solve(6))
    np.testing.assert_allclose(h, h1, rtol=2e-3)
    hj, _ = jax_history(SHAPE3, 4, "BiCGStabSolver", 6)
    np.testing.assert_allclose(h, hj, rtol=2e-3)
    x = sol(planner)
    r = 1.0 - dense_ref(SHAPE3, op.offsets, x)
    assert abs(r @ r - h[-1]) <= 1e-3 * h[-1]


def test_gmres_on_pieces():
    """GMRES(10) x 4 on 4 pieces of the 2-D 5-point Laplacian at (32, 128),
    f32 (test_torch_gmres's f32 case on pieces): the batched-basis runner's
    products run over the whole vector, the matvec per piece.  The port on
    pieces and JAX on ``mesh4`` each within 1e-4 of float64 GMRES, within
    2e-4 of each other and of the port on one piece; x within 2e-4
    max|x| of JAX's."""
    from legionsolvers_tpu_torch.entry import build_stencil_system

    shape, m, cycles = (32, 128), 10, 4
    pt, opt = system(T, shape, 4)
    assert opt.uses_pallas and opt._sharded
    ht = hist_of(T.GMRESSolver(pt, restart=m).solve(cycles))
    p1, _ = system(T, shape, 1)
    h1 = hist_of(T.GMRESSolver(p1, restart=m).solve(cycles))
    pj, opj = system(J, shape, 4)
    assert opj.uses_pallas
    hj = hist_of(J.GMRESSolver(pj, restart=m).solve(cycles))
    p64 = build_stencil_system(2, shape, opts(T, "f64"), device=DEV)
    h64 = hist_of(T.GMRESSolver(p64, restart=m).solve(cycles))
    for h in (ht, hj):
        assert np.max(np.abs(h - h64) / h64) <= 1e-4
    np.testing.assert_allclose(ht, hj, rtol=2e-4)
    np.testing.assert_allclose(ht, h1, rtol=2e-4)
    xj = sol(pj)
    np.testing.assert_allclose(sol(pt), xj, atol=2e-4 * np.abs(xj).max())


def test_pcg_on_pieces():
    """PCG(Jacobi) on 4 pieces of the 2-D Laplacian at (32, 128), f32,
    30 iterations: the Jacobi diagonal is the constant 4 on every piece;
    the history within 1e-4 of float64 CG (test_torch_pcg's f32 bound),
    of JAX's PCG on ``mesh4`` and of the port's on one piece."""
    from legionsolvers_tpu.solvers.pcg import (
        JacobiPreconditioner as JJacobi,
        PCGSolver as JPCG,
    )
    from legionsolvers_tpu_torch.entry import build_stencil_system

    shape = (32, 128)
    pt, _ = system(T, shape, 4)
    M = T.JacobiPreconditioner(pt)
    assert torch.all(M.inv_diags[0] == 0.25)
    h = hist_of(T.PCGSolver(pt, M).solve(30))
    p1, _ = system(T, shape, 1)
    h1 = hist_of(T.PCGSolver(p1, T.JacobiPreconditioner(p1)).solve(30))
    pj, _ = system(J, shape, 4)
    hj = hist_of(JPCG(pj, JJacobi(pj)).solve(30))
    p64 = build_stencil_system(2, shape, opts(T, "f64"), device=DEV)
    h64 = hist_of(T.CGSolver(p64).solve(30))
    for other in (h64, hj, h1):
        np.testing.assert_allclose(h, other, rtol=1e-4)
