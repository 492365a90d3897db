"""The port's block systems (``parallel/block_fused.py``) against the JAX
package's, on one piece.

A block system registers one operator per sol/rhs space (reference:
BenchmarkStencil.cpp:201-207): diag(A_0 .. A_{S-1}), whose CG and
BiCGStab scalars couple the spaces through summed dots.  The same inputs,
made with numpy from a seed, go through both packages: JAX runs its block
runners on Pallas kernels in interpret mode, the port its block runners on
the plain versions its wrappers take on CPU tensors.  These mirror the
one-piece cases of ``tests/test_16_block_system.py`` and
``tests/test_27_block_fused.py`` (their sharded cases are in
``tests/test_torch_sharded_blocks.py``).  Each test's docstring states its
tolerance.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu import benchmark as JB
from legionsolvers_tpu.parallel import block_fused as JBF
from legionsolvers_tpu.utils import roofline as JR
from legionsolvers_tpu_torch import benchmark as TBM
from legionsolvers_tpu_torch.parallel import block_fused as TBF
from legionsolvers_tpu_torch.utils import roofline as TR
from tests.test_08_stencil import dense_stencil

torch.set_num_threads(2)

DEV = "cpu"
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]
DTYPES = {J: {"f32": jnp.float32, "f64": jnp.float64},
          T: {"f32": torch.float32, "f64": torch.float64}}


def opts(pkg, dtype, compensated=False):
    return pkg.SolverOptions(entry_dtype=DTYPES[pkg][dtype],
                             compensated_dots=compensated)


def on_dev(pkg):
    return {} if pkg is J else {"device": DEV}


def planner_of(pkg, F, part, rhs, grid_shape=None):
    """A planner with one zero solution and the given right-hand side per
    space (host arrays of length n)."""
    planner = pkg.SquarePlanner(mesh=None, options=F, **on_dev(pkg))
    for i in range(len(rhs)):
        planner.add_sol_vector(pkg.PartitionedVector(
            f"s{i}", part, options=F, grid_shape=grid_shape,
            **on_dev(pkg)).zero_fill())
    for i, b in enumerate(rhs):
        planner.add_rhs_vector(pkg.PartitionedVector.from_array(
            f"b{i}", np.asarray(b).reshape(grid_shape or -1), part,
            options=F, grid_shape=grid_shape, **on_dev(pkg)))
    return planner


def line_block(pkg, n, rhs=None, explicit=False, num_spaces=2):
    """test_16's system: the 1-D Laplacian over ``num_spaces`` spaces in
    float64, b = 1 unless ``rhs`` gives one array per space."""
    F = opts(pkg, "f64")
    part = pkg.BlockPartition(n, 1)
    rhs = rhs if rhs is not None else [np.ones(n)] * num_spaces
    planner = planner_of(pkg, F, part, rhs)
    if explicit:
        A = pkg.coo_negative_laplacian_1d(n, options=F)
        for i in range(len(rhs)):
            planner.add_row_partitioned_matrix(A, i, i)
    else:
        op = pkg.StencilOperator((n,), pkg.laplacian_stencil(1),
                                 partition=part, options=F, **on_dev(pkg))
        for i in range(len(rhs)):
            planner.add_operator(op, i, i)
    return planner


def shifted(pkg, shape, shift):
    offs = pkg.laplacian_stencil(len(shape) if len(shape) < 3 else 3)
    return [(o, v + (shift if all(c == 0 for c in o) else 0.0))
            for o, v in offs]


def draws(shape, num_spaces=2, seed=5):
    """test_27's right-hand sides: ``default_rng(seed).random(n)`` in f32,
    one per space."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return [rng.random(n).astype(np.float32) for _ in range(num_spaces)]


def grid_block(pkg, shape, rhs, shift=8.0, compensated=False, kernels=None):
    """test_27's system: the dim-matching Laplacian plus ``shift`` on the
    diagonal, f32, one right-hand side per space.  ``kernels`` (one bool
    per space, default all True): whether each space's operator takes the
    kernel view or the linearized path; the vectors take the grid layout
    when every space is on the kernel view, the flat one otherwise."""
    F = opts(pkg, "f32", compensated)
    n = int(np.prod(shape))
    part = pkg.BlockPartition(n, 1)
    kernels = kernels or [True] * len(rhs)
    planner = planner_of(pkg, F, part, rhs,
                         grid_shape=shape if all(kernels) else None)
    made = {}
    for i, k in enumerate(kernels):
        if k not in made:
            made[k] = pkg.StencilOperator(
                shape, shifted(pkg, shape, shift), partition=part,
                options=F, use_pallas=k, **on_dev(pkg))
            assert made[k].uses_pallas == k
        planner.add_operator(made[k], i, i)
    return planner


def solve(planner, solver_cls, iters, block=True):
    """(history, [x per space]); ``block``: the block runner must take
    the solve, else the transcription (LEGIONSOLVERS_NO_BLOCK_FUSED)."""
    solver = solver_cls(planner)
    if not block:
        os.environ["LEGIONSOLVERS_NO_BLOCK_FUSED"] = "1"
    try:
        runner = solver._make_fused_runner(iters)
        assert (runner is not None) == block
        hist = np.asarray(solver.solve(iters))
    finally:
        os.environ.pop("LEGIONSOLVERS_NO_BLOCK_FUSED", None)
    xs = [np.asarray(planner.get_vector(0, i).data).reshape(-1)
          for i in range(planner.num_spaces)]
    return hist, xs


def port_vs(shape, solver, iters):
    """(the port's block run, JAX's block run, the port's transcription)
    on test_27's distinct right-hand sides."""
    b = draws(shape)
    jax_run = solve(grid_block(J, shape, b), getattr(J, solver), iters)
    port = solve(grid_block(T, shape, b), getattr(T, solver), iters)
    trans = solve(grid_block(T, shape, b), getattr(T, solver), iters,
                  block=False)
    return port, jax_run, trans


# -- test_16: the float64 goldens and convergence ---------------------------

@pytest.mark.parametrize("explicit", [False, True])
def test_block_cg_doubles_golden(explicit):
    """The same matrix and b = 1 over 2 spaces: the CG residual^2 history
    is exactly twice the n = 100 golden in both packages (every dot
    doubles, the ratios do not change), and both solution blocks are
    equal.  The stencil system takes the block runner (torch phases), the
    explicit one the transcription, as in JAX."""
    tp, jp = line_block(T, 100, explicit=explicit), \
        line_block(J, 100, explicit=explicit)
    ts, js = T.CGSolver(tp), J.CGSolver(jp)
    assert (ts._make_fused_runner(10) is not None) == (not explicit)
    assert (js._make_fused_runner(10) is not None) == (not explicit)
    hist = np.asarray(ts.solve(10))
    assert hist.tolist() == [2 * g for g in GOLDEN]
    assert np.asarray(js.solve(10)).tolist() == hist.tolist()
    x0, x1 = (tp.get_vector(0, i).to_numpy() for i in range(2))
    np.testing.assert_array_equal(x0, x1)


def test_block_cg_distinct_rhs():
    """Distinct b per space (default_rng(7)): CG on diag(A, A) reaches each
    block's true solution, rtol 1e-8 (test_16's), in both packages."""
    n = 64
    rng = np.random.default_rng(7)
    b = [rng.random(n), rng.random(n)]
    A = dense_stencil((n,), J.laplacian_stencil(1))
    for pkg in (T, J):
        planner = line_block(pkg, n, rhs=b)
        _, xs = solve(planner, pkg.CGSolver, 2 * n)
        for x, bi in zip(xs, b):
            np.testing.assert_allclose(x, np.linalg.solve(A, bi), rtol=1e-8)


def test_block_bicgstab_converges():
    """BiCGStab over the 2-space float64 system (the block runner's torch
    phases) drives ||b - Ax|| under 1e-6 in every space (test_16's), in
    both packages.  Float64 BiCGStab on this system amplifies a change in
    summation order by ~10x per iteration after the tenth (JAX's and the
    port's histories part by 1e-8 at iteration 20), so the two are held
    together, rtol 1e-9, over the first 12 entries only."""
    n = 100
    A = dense_stencil((n,), J.laplacian_stencil(1))
    hist = {}
    for pkg in (T, J):
        hist[pkg], xs = solve(line_block(pkg, n), pkg.BiCGStabSolver, 80)
        for x in xs:
            assert np.linalg.norm(np.ones(n) - A @ x) < 1e-6
    np.testing.assert_allclose(hist[T][:12], hist[J][:12], rtol=1e-9)


# -- test_27: the f32 block runners against JAX's and the transcription ----

CASES = {
    # name: (shape, solver, iterations, environment)
    "s-step 2-D": ((32, 256), "CGSolver", 12, {}),
    "two-pass 2-D": ((32, 256), "CGSolver", 9,
                     {"LEGIONSOLVERS_NO_SSTEP": "1"}),
    "s-step odd tail": ((32, 256), "CGSolver", 11, {}),
    "s-step refresh": ((32, 256), "CGSolver", 12,
                       {"LEGIONSOLVERS_SSTEP_REFRESH": "2"}),
    "3-D": ((8, 16, 128), "CGSolver", 8, {}),
    "BiCGStab 2-D": ((32, 256), "BiCGStabSolver", 10, {}),
    "BiCGStab 3-D": ((8, 16, 128), "BiCGStabSolver", 8, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_block_runner_matches_jax_and_transcription(case, monkeypatch):
    """Distinct right-hand sides per space (identical ones would hide a
    wrong combination of the per-space scalars).  The port's block runner
    against JAX's block runner on the same inputs and against the port's
    transcription (LEGIONSOLVERS_NO_BLOCK_FUSED), test_27's tolerances:
    CG history rtol 2e-3 and x rtol 5e-3 / atol 1e-5 (the odd tail: the
    history); BiCGStab the first 6 history entries (3-D: 5) rtol 0.05, and
    in 2-D x rtol 0.05 / atol 1e-4 (f32 BiCGStab amplifies rounding in
    another order)."""
    shape, solver, iters, env = CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    port, jax_run, trans = port_vs(shape, solver, iters)
    for (h_f, xs_f), (h_o, xs_o) in ((port, jax_run), (port, trans)):
        if solver == "CGSolver":
            np.testing.assert_allclose(h_f, h_o, rtol=2e-3)
            if case != "s-step odd tail":
                for a, b in zip(xs_f, xs_o):
                    np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)
        else:
            k = 6 if len(shape) == 2 else 5
            np.testing.assert_allclose(h_f[:k], h_o[:k], rtol=0.05)
            if len(shape) == 2:
                for a, b in zip(xs_f, xs_o):
                    np.testing.assert_allclose(a, b, rtol=0.05, atol=1e-4)


@pytest.mark.parametrize("solver", ["CGSolver", "BiCGStabSolver"])
def test_block_runner_mixes_phases(solver):
    """Space 0 on the kernel view, space 1 on the linearized path: CG runs
    the two-pass phases beside the torch phases (the s-step needs every
    space eligible), BiCGStab the fused passes beside the torch phases.
    Against the transcription: history rtol 2e-3 (BiCGStab: the first 6
    entries, rtol 0.05), x rtol 5e-3 / atol 1e-5 (BiCGStab 0.05 /
    1e-4)."""
    shape = (32, 256)
    b = draws(shape)
    cls = getattr(T, solver)
    runs = [solve(grid_block(T, shape, b, kernels=[True, False]), cls, 10,
                  block=blk) for blk in (True, False)]
    (h_f, xs_f), (h_t, xs_t) = runs
    if solver == "CGSolver":
        np.testing.assert_allclose(h_f, h_t, rtol=2e-3)
        tol = dict(rtol=5e-3, atol=1e-5)
    else:
        np.testing.assert_allclose(h_f[:6], h_t[:6], rtol=0.05)
        tol = dict(rtol=0.05, atol=1e-4)
    for a, c in zip(xs_f, xs_t):
        np.testing.assert_allclose(a, c, **tol)


def test_block_cg_solution_actually_solves():
    """Independent of any other run: after the s-step block solve(16)
    ||b - Ax|| / ||b|| < 1e-4 in every space (test_27's)."""
    shape = (32, 256)
    b = draws(shape)
    planner = grid_block(T, shape, b)
    _, xs = solve(planner, T.CGSolver, 16)
    A = dense_stencil(shape, shifted(J, shape, 8.0))
    for x, bi in zip(xs, b):
        assert np.linalg.norm(bi - A @ x) / np.linalg.norm(bi) < 1e-4


# -- identical spaces: exactly twice one space ------------------------------

DOUBLING = {
    # name: (shape, solver, iterations, environment, compensated dots)
    "s-step": ((32, 256), "CGSolver", 12, {}, False),
    "s-step odd tail": ((32, 256), "CGSolver", 11,
                        {"LEGIONSOLVERS_SSTEP_REFRESH": "2"}, False),
    "two-pass": ((32, 256), "CGSolver", 9, {"LEGIONSOLVERS_NO_SSTEP": "1"},
                 False),
    "3-D CG": ((8, 16, 128), "CGSolver", 8, {}, False),
    "BiCGStab 2-D": ((32, 256), "BiCGStabSolver", 10, {}, False),
    "BiCGStab 2-D compensated": ((32, 256), "BiCGStabSolver", 10, {}, True),
    "BiCGStab 3-D": ((8, 16, 128), "BiCGStabSolver", 8, {}, False),
}


@pytest.mark.parametrize("case", list(DOUBLING))
def test_identical_spaces_double_one_space(case, monkeypatch):
    """The same operator and the same b in both spaces: the block history
    is exactly twice the single-space fused solve's, and each space's x
    equals the single-space x bit for bit.  Exact: every coefficient is a
    ratio of sums homogeneous in the dots (or the Gram), so doubling every
    sum, exact in binary floating point, leaves every coefficient's bits
    as they were."""
    shape, solver, iters, env, comp = DOUBLING[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (b,) = draws(shape, num_spaces=1)
    cls = getattr(T, solver)
    h1, (x1,) = solve(grid_block(T, shape, [b], compensated=comp), cls,
                      iters)
    h2, xs = solve(grid_block(T, shape, [b, b], compensated=comp), cls,
                   iters)
    np.testing.assert_array_equal(h2, 2 * h1)
    for x in xs:
        np.testing.assert_array_equal(x, x1)


# -- the gates -------------------------------------------------------------

def mixed_planner(pkg, kinds):
    """One space per kind: "stencil" (the 2-D Laplacian on the kernel
    view, f32), "line" (the 1-D stencil, linearized) or "explicit" (the
    2-D Laplacian as COO; the planner upgrades it)."""
    shape = (16, 128)
    n = int(np.prod(shape))
    F = opts(pkg, "f32")
    part = pkg.BlockPartition(n, 1)
    planner = planner_of(pkg, F, part, [np.ones(n)] * len(kinds))
    for i, kind in enumerate(kinds):
        if kind == "explicit":
            A = pkg.create_coo_stencil_matrix(shape, pkg.laplacian_stencil(2),
                                              options=F)
            planner.add_row_partitioned_matrix(A, i, i)
        else:
            grid = shape if kind == "stencil" else (n,)
            planner.add_operator(pkg.StencilOperator(
                grid, pkg.laplacian_stencil(len(grid)), partition=part,
                options=F, **on_dev(pkg)), i, i)
    return planner


@pytest.mark.parametrize("env", [None, "LEGIONSOLVERS_NO_BLOCK_FUSED",
                                 "LEGIONSOLVERS_NO_FUSED_BICGSTAB",
                                 "LEGIONSOLVERS_NO_SSTEP"])
@pytest.mark.parametrize("kinds", [("stencil", "stencil"), ("line", "line"),
                                   ("stencil", "line"),
                                   ("stencil", "explicit"),
                                   ("explicit", "explicit")])
def test_supported_gates_match_jax(kinds, env, monkeypatch):
    """block_cg_supported and block_bicgstab_supported give JAX's answer on
    the same diagonal blocks, under each environment switch."""
    if env:
        monkeypatch.setenv(env, "1")
    ops = {T: TBF.diagonal_block_ops(mixed_planner(T, kinds)),
           J: JBF.diagonal_block_ops(mixed_planner(J, kinds))}
    assert [type(o).__name__ for o in ops[T]] == \
        [type(o).__name__ for o in ops[J]]
    assert TBF.block_cg_supported(ops[T]) == JBF.block_cg_supported(ops[J])
    assert (TBF.block_bicgstab_supported(ops[T])
            == JBF.block_bicgstab_supported(ops[J]))


def test_sharded_spaces_raise():
    """Spaces of more than one piece without a mesh: not supported (as in
    JAX), and the block runners refuse them, as the single-space fused
    runners refuse several pieces without a mesh."""
    F = opts(T, "f64")
    op = T.StencilOperator((64,), T.laplacian_stencil(1),
                           partition=T.BlockPartition(64, 4), options=F,
                           device=DEV)
    assert not TBF.block_cg_supported([op, op])
    assert not TBF.block_bicgstab_supported([op, op])
    for make in (TBF.make_block_cg_runner, TBF.make_block_bicgstab_runner):
        with pytest.raises(ValueError, match="needs a mesh"):
            make([op, op], 4)


# -- the roofline and the CLI ----------------------------------------------

@pytest.mark.parametrize("env", [None, "LEGIONSOLVERS_NO_SSTEP"])
@pytest.mark.parametrize("solver", ["CGSolver", "BiCGStabSolver"])
@pytest.mark.parametrize("dim", [1, 2, 3, 4])
def test_block_roofline_matches_jax(dim, solver, env, monkeypatch):
    """``--block`` systems (2 spaces, the same operator) report the
    single-space schedule's label and bytes per unknown, over both spaces'
    unknowns, exactly as JAX's roofline does."""
    if env:
        monkeypatch.setenv(env, "1")
    import types

    shape = {1: (256,), 2: (16, 128), 3: (4, 8, 128), 4: (4, 8, 128)}[dim]
    nx, ny, nz = (list(shape) + [1, 1])[:3]
    ns = types.SimpleNamespace(dim=dim, nx=nx, ny=ny, nz=nz, vp=1,
                               block=True)
    pj, n, nnz = JB.build_planner(ns, None, opts(J, "f32"))
    pt, nt, nnzt = TBM.build_planner(ns, opts(T, "f32"), DEV)
    assert (n, nnz) == (nt, nnzt) and pt.num_spaces == 2
    st, sj = getattr(T, solver)(pt), getattr(J, solver)(pj)
    assert (TR.solver_bytes_per_iteration(st, n)
            == JR.solver_bytes_per_iteration(sj, n))
