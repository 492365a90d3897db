"""Block systems on pieces: the port's block runners on 2 spaces of 4
pieces each against the transcription on the same pieces and against the
JAX package's block runners on ``mesh4`` (``tests/test_27_block_fused.py``'s
and ``test_16_block_system.py``'s ``pieces=4`` cases at their sizes and
tolerances), and two identical spaces against one space on the same
pieces.  Helpers: ``tests/test_torch_sharded_solvers.py``.
"""

import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu_torch.parallel import block_fused as TBF
from tests.test_torch_sharded_solvers import (
    SHAPE3,
    env,
    hist_of,
    opts,
    rhs_draws,
    sol,
    system,
)

torch.set_num_threads(2)

GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]


# -- block systems on pieces (test_27, test_16) ------------------------------

def shifted(pkg, shape, shift=8.0):
    offs = pkg.laplacian_stencil(min(len(shape), 3))
    return [(o, v + (shift if all(c == 0 for c in o) else 0.0))
            for o, v in offs]


def block_pair(shape, solver, iters, pieces=4):
    """test_27's block system (shifted Laplacian, 2 spaces, distinct rhs
    from default_rng(5)) on ``pieces`` pieces: (block runner's history and
    xs, transcription's history and xs, JAX block runner's history)."""
    b = rhs_draws(shape, 2, 5)
    runs = []
    for block in (True, False):
        with env(**({} if block else {"LEGIONSOLVERS_NO_BLOCK_FUSED": "1"})):
            planner, op = system(T, shape, pieces, stencil=shifted(T, shape),
                                 rhs=b, num_spaces=2)
            assert op.uses_pallas
            s = getattr(T, solver)(planner)
            assert (s._make_fused_runner(iters) is not None) == block
            runs.append((hist_of(s.solve(iters)),
                         [sol(planner, i) for i in range(2)]))
    pj, _ = system(J, shape, pieces, stencil=shifted(J, shape), rhs=b,
                   num_spaces=2)
    sj = getattr(J, solver)(pj)
    assert sj._make_fused_runner(iters) is not None
    return runs[0], runs[1], hist_of(sj.solve(iters))


BLOCK_CASES = {
    "s-step 2-D": ((128, 256), "CGSolver", 12, {}),
    "two-pass 2-D": ((128, 256), "CGSolver", 9,
                     {"LEGIONSOLVERS_NO_SSTEP": "1"}),
    "3-D": ((8, 16, 128), "CGSolver", 8, {}),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_cg_on_pieces(case):
    """test_27:92's ``pieces=4`` case (s-step), its two-pass form and a 3-D
    block CG on 4 pieces (2 x-planes each): the block runner against the
    transcription on the same pieces, history rtol 2e-3, x rtol 5e-3 /
    atol 1e-5 (test_27's); and against JAX's block runner on ``mesh4``,
    history rtol 2e-3."""
    shape, solver, iters, switches = BLOCK_CASES[case]
    with env(**switches):
        (h_f, xs_f), (h_t, xs_t), hj = block_pair(shape, solver, iters)
    np.testing.assert_allclose(h_f, h_t, rtol=2e-3)
    for a, b in zip(xs_f, xs_t):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)
    np.testing.assert_allclose(h_f, hj, rtol=2e-3)


def test_block_bicgstab_on_pieces():
    """test_27:139's ``pieces=4`` case: 2-D block BiCGStab on 4 pieces of
    (128, 256), each space's three passes with the edge fix-ups of the
    single-space runner; against the transcription the first 6 history
    entries rtol 0.05 and x rtol 0.05 / atol 1e-4 (test_27's), against
    JAX's block runner the first 6 entries rtol 0.05."""
    (h_f, xs_f), (h_t, xs_t), hj = block_pair((128, 256), "BiCGStabSolver",
                                              10)
    np.testing.assert_allclose(h_f[:6], h_t[:6], rtol=0.05)
    for a, b in zip(xs_f, xs_t):
        np.testing.assert_allclose(a, b, rtol=0.05, atol=1e-4)
    np.testing.assert_allclose(h_f[:6], hj[:6], rtol=0.05)


@pytest.mark.parametrize("case", ["s-step", "two-pass", "3-D CG",
                                  "BiCGStab 2-D"])
def test_identical_spaces_on_pieces(case):
    """b = 1 in both spaces of a block system on 4 pieces: the block
    history exactly twice the single-space solve's on the same pieces and
    each space's x bit for bit that solve's (every coefficient is a ratio
    of sums that double exactly)."""
    shape, solver, iters, switches = {
        "s-step": ((64, 128), "CGSolver", 11, {}),
        "two-pass": ((64, 128), "CGSolver", 9,
                     {"LEGIONSOLVERS_NO_SSTEP": "1"}),
        "3-D CG": (SHAPE3, "CGSolver", 8, {}),
        "BiCGStab 2-D": ((64, 128), "BiCGStabSolver", 8, {}),
    }[case]
    with env(**switches):
        p1, _ = system(T, shape, 4)
        h1 = hist_of(getattr(T, solver)(p1).solve(iters))
        p2, _ = system(T, shape, 4, num_spaces=2)
        s2 = getattr(T, solver)(p2)
        assert s2._make_fused_runner(iters) is not None
        h2 = hist_of(s2.solve(iters))
    np.testing.assert_array_equal(h2, 2 * h1)
    for i in range(2):
        np.testing.assert_array_equal(sol(p2, i), sol(p1))


def test_block_cg_doubles_golden_on_pieces(mesh4):
    """test_16:67's stencil ``pieces=4`` case: the n = 100 1-D Laplacian in
    float64 over 2 spaces on 4 pieces; the block runner's torch phases
    (dots per piece, in piece order) give exactly twice the golden
    history, as JAX's do on ``mesh4``, and equal solution blocks."""
    hists = {}
    for pkg in (T, J):
        planner, op = system(pkg, (100,), 4, options=opts(pkg, "f64"),
                             num_spaces=2)
        assert not op.uses_pallas
        solver = pkg.CGSolver(planner)
        assert solver._make_fused_runner(10) is not None
        hists[pkg] = hist_of(solver.solve(10)).tolist()
        np.testing.assert_array_equal(sol(planner, 0)[:100],
                                      sol(planner, 1)[:100])
    assert hists[T] == [2 * g for g in GOLDEN] == hists[J]


def test_block_gates_on_pieces(mesh4):
    """block_cg_supported and block_bicgstab_supported on spaces of 4
    pieces give JAX's answers: True on a mesh; False where the spaces'
    piece counts differ."""
    from legionsolvers_tpu.parallel import block_fused as JBF

    shape = (64, 128)
    ops = {}
    for pkg in (T, J):
        _, op4 = system(pkg, shape, 4)
        _, op1 = system(pkg, shape, 1)
        ops[pkg] = ([op4, op4], [op4, op1])
    for k in range(2):
        assert TBF.block_cg_supported(ops[T][k]) == \
            JBF.block_cg_supported(ops[J][k]) == (k == 0)
        assert TBF.block_bicgstab_supported(ops[T][k]) == \
            JBF.block_bicgstab_supported(ops[J][k]) == (k == 0)
