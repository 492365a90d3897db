"""Reordered bases on a mesh over processes, against one process and the
JAX package.

Each case starts the two worker processes of ``tests/
test_torch_multiprocess.py`` (``tests/torch_distributed_worker.py``: a
gloo group, a 4-shard mesh of 2 CPU shards each) and runs the same case
function on a one-process ``make_mesh(4, devices=["cpu"] * 4)``.  The
system is the 5-point Laplacian on 64^2 with its rows and columns
scrambled (n = 4096, past the RCM upgrade's n >= 1024; the planner's
choice, not forced).  Held:

* the planner picks the one-process mesh's operator (the RCM basis on
  the sharded windowed ELL, as JAX picks on its 4-device mesh) and the
  same permutation on both ranks, JAX's RCM; each rank keeps its rows of
  the padded permutation;
* a matvec outside the basis (natural order in and out, the vector
  gathered from both processes and permuted) bit for bit one process's;
* CG in f32 within ELL_HIST_RTOL / ELL_X_RTOL of one process, x back in
  the natural order and equal on both ranks; in f64 within JAX_RTOL of
  JAX's 4-device mesh;
* a block system of 2 spaces whose second space adopts the first's basis
  (``adopt_basis``), coupled by 0.125 I both ways (``CrossBasisOperator``
  across the processes): the same chains and basis as one process, CG
  within the same bounds;
* ranks that hold different permutations raise RuntimeError on both.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

import legionsolvers_tpu as J
from legionsolvers_tpu.parallel.mesh import make_mesh as jax_mesh
from tests import torch_distributed_worker as W
from tests.test_torch_multiprocess import (
    ELL_HIST_RTOL,
    ELL_X_RTOL,
    JAX_RTOL,
    check_ranks,
    close,
    one_process,
    run_case,
    same,
)

TAGS = ["f32", "f64"]


@functools.lru_cache(maxsize=None)
def jax_reordered():
    """JAX's f64 planner on its 4-device mesh for the worker's scrambled
    Laplacian: (operator chain, permutation, CG history, x)."""
    a = J.create_coo_stencil_matrix((W.SCRAMBLED_NX, W.SCRAMBLED_NX),
                                    J.laplacian_stencil(2))
    n = a.n_range
    pr = np.random.default_rng(0).permutation(n)
    F64 = J.SolverOptions(entry_dtype=jnp.float64)
    A = J.COOMatrix(pr[np.asarray(a.rows)], pr[np.asarray(a.cols)],
                    np.asarray(a.vals), n, n, options=F64)
    mesh = jax_mesh(4)
    part = J.BlockPartition(n, 4)
    planner = J.SquarePlanner(mesh=mesh, options=F64)
    planner.add_sol_vector(J.PartitionedVector("s", part, mesh=mesh,
                                               options=F64).zero_fill())
    planner.add_rhs_vector(J.PartitionedVector(
        "b", part, mesh=mesh, options=F64).constant_fill(1.0))
    planner.add_row_partitioned_matrix(A, 0, 0)
    op = planner.row_partitioned_matrices[0][0]
    chain = [type(op).__name__, type(op.base).__name__]
    h = np.asarray(J.CGSolver(planner).solve(W.ITERS))
    return (chain, np.asarray(planner.basis_perm["perm_np"]), h,
            np.asarray(planner.sol_vectors[0].to_numpy()))


@pytest.mark.parametrize("tag", TAGS)
def test_planner_picks_one_process_operator(tag):
    """The RCM upgrade on the mesh over processes: the one-process mesh's
    chain (ReorderedOperator over the sharded RowPartitionedMatrix, its
    windowed plan) on both ranks, and JAX's."""
    ref = one_process("reorder")
    want = ["ReorderedOperator", "RowPartitionedMatrix"]
    assert ref[f"{tag}_chain"].tolist() == want
    assert jax_reordered()[0] == want
    for r in run_case("reorder"):
        assert r[f"{tag}_chain"].tolist() == want
        assert same(r[f"{tag}_windowed"], ref[f"{tag}_windowed"])
        assert bool(r[f"{tag}_windowed"])


@pytest.mark.parametrize("tag", TAGS)
def test_permutation_equal_on_every_rank(tag):
    """Both ranks compute the same RCM permutation from the whole matrix,
    one process's and JAX's, and keep their 2 pieces' rows of it."""
    ref = one_process("reorder")
    perm = ref[f"{tag}_perm"]
    assert same(perm, jax_reordered()[1])
    assert sorted(perm.tolist()) == list(range(W.SCRAMBLED_NX ** 2))
    for rank, r in enumerate(run_case("reorder")):
        assert same(r[f"{tag}_perm"], perm)
        half = len(perm) // 2
        assert r[f"{tag}_perm_local"].tolist() == perm[
            rank * half:(rank + 1) * half].tolist()


@pytest.mark.parametrize("tag", TAGS)
def test_matvec_outside_basis_bit_for_bit(tag):
    """A matvec of the reordered operator in the natural order (x
    permuted into the basis across the processes, the windowed ELL per
    piece, y permuted back): bit for bit one process's on both ranks."""
    ref = one_process("reorder")
    for r in run_case("reorder"):
        assert same(r[f"{tag}_matvec"], ref[f"{tag}_matvec"])


def test_cg_f32_within_one_process():
    """CG in f32 in the RCM basis across processes: the same history and x
    on both ranks, x in the natural order, within ELL_HIST_RTOL and
    ELL_X_RTOL of one process (the eager dots sum per piece here and over
    the whole vector on one process)."""
    ref = one_process("reorder")
    a, b = run_case("reorder")
    assert same(a["f32_hist"], b["f32_hist"]) and same(a["f32_x"],
                                                       b["f32_x"])
    close(a["f32_hist"], ref["f32_hist"], ELL_HIST_RTOL)
    close(a["f32_x"][None], ref["f32_x"][None], ELL_X_RTOL)


def test_cg_f64_matches_one_process_and_jax():
    """CG in f64 in the RCM basis across processes: within ELL_HIST_RTOL
    and ELL_X_RTOL of one process, and within JAX_RTOL of JAX's 4-device
    mesh, x in the natural order."""
    check_ranks("reorder", "f64", ELL_HIST_RTOL)
    _, _, hj, xj = jax_reordered()
    for r in run_case("reorder"):
        close(r["f64_hist"], hj, JAX_RTOL)
        close(r["f64_x"][None], xj[None], JAX_RTOL)


def test_adopt_basis_block_system():
    """Two spaces, the second adopting the first's basis, coupled by
    0.125 I: the one-process chains (two ReorderedOperators, two
    CrossBasisOperators), the same basis in both spaces, and CG within
    ELL_HIST_RTOL / ELL_X_RTOL of one process, both spaces' x in the
    natural order and equal on both ranks."""
    ref = one_process("reorder")
    a, b = run_case("reorder")
    assert ref["block_chains"].tolist() == [
        "ReorderedOperator/RowPartitionedMatrix"] * 2 + [
        "CrossBasisOperator/RowPartitionedMatrix"] * 2
    for r in (a, b):
        assert same(r["block_chains"], ref["block_chains"])
        assert bool(r["block_same_basis"])
    assert same(a["block_hist"], b["block_hist"])
    assert same(a["block_x"], b["block_x"])
    close(a["block_hist"], ref["block_hist"], ELL_HIST_RTOL)
    close(a["block_x"], ref["block_x"], ELL_X_RTOL)


def test_differing_permutation_raises():
    """``mesh.check_same_on_ranks`` on arrays that differ between the
    ranks raises RuntimeError on both."""
    for r in run_case("reorder"):
        assert str(r["differing perm"]).startswith("RuntimeError: a rank "
                                                   "differs"), r[
            "differing perm"]
