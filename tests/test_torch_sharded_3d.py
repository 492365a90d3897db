"""3-D stencils on pieces: the halo-plane exchange, the matvec and the
two-pass CG of the port on 4 and 8 pieces against the JAX package's
sharded code (``tests/test_15_stencil3d.py``'s sharded cases at its sizes
and tolerances), the JAX side on the conftest's meshes with Pallas in
interpret mode, the port on the plain versions of its wrappers on CPU
tensors.  Helpers: ``tests/test_torch_sharded_solvers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.options import SHARD_AXIS
from tests.test_torch_sharded_solvers import (
    SHAPE3,
    dense_ref,
    hist_of,
    jax_history,
    mesh_of,
    opts,
    sol,
    system,
)

torch.set_num_threads(2)


# -- 3-D: halo planes, matvec, two-pass CG (test_15) -------------------------

STENCILS3 = {"7-point": 3, "27-point": 4,
             "one-sided": [((0, 0, 0), 3.0), ((1, 0, 0), -1.0),
                           ((0, 1, -1), -0.5)]}


@pytest.mark.parametrize("kind", list(STENCILS3))
def test_exchange_planes3d_matches_jax(kind, mesh4):
    """The port's ``_exchange_planes3d`` on 4 pieces of a random volume
    equals JAX's (run inside its shard_map on ``mesh4``) exactly: each
    piece's top plane is the last x-plane of the piece before, its bottom
    plane the first of the piece after, zeros at the grid's ends.  A side
    the stencil does not read is None in the port and zeros in JAX; the
    planes are copies, not views of the volume."""
    stencil = STENCILS3[kind]
    if isinstance(stencil, int):
        stencil = T.laplacian_stencil(stencil)
    n = int(np.prod(SHAPE3))
    g = np.random.default_rng(11).standard_normal(SHAPE3).astype(np.float32)
    opj = J.StencilOperator(SHAPE3, stencil, partition=J.BlockPartition(n, 4),
                            mesh=mesh4, options=opts(J))
    opt = T.StencilOperator(SHAPE3, stencil, partition=T.BlockPartition(n, 4),
                            mesh=mesh_of(T, 4), options=opts(T))
    assert opj.uses_pallas and opt._view["kind"] == "3d"
    spec = P(SHARD_AXIS, None, None)
    fn = jax.shard_map(
        lambda xl: tuple(a[None] for a in opj._exchange_planes3d(
            xl, sharded=True)),
        mesh=mesh4, in_specs=(spec,), out_specs=(spec, spec),
        check_vma=False)
    want = [np.asarray(a) for a in fn(jnp.asarray(g))]
    vol = torch.from_numpy(g)
    got = opt._exchange_planes3d(vol)
    for w, t in zip(want, got):
        if t is None:
            assert not w.any()
        else:
            assert t.shape == (4, 8, 128)
            np.testing.assert_array_equal(t.numpy(), w)
            assert t.untyped_storage().data_ptr() != \
                vol.untyped_storage().data_ptr()
    if kind == "one-sided":
        assert got[0] is None and got[1] is not None


@pytest.mark.parametrize("dim", [3, 4])
@pytest.mark.parametrize("pieces", [4, 8])
def test_pallas3d_matvec_sharded(dim, pieces, mesh4, mesh8):
    """test_15:55.  The 3-D matvec on pieces (K6a per piece with its
    neighbours' halo planes) against the dense oracle (max error under
    1e-5 of max |y|, test_15's), bit for bit against one piece (per
    element the same terms in the same order), against JAX's sharded
    matvec (rtol 1e-6, atol 1e-6 max|y|); its fused dot within 1e-5 of
    x . (A x)."""
    st = T.laplacian_stencil(dim)
    n = int(np.prod(SHAPE3))
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y_ref = dense_ref(SHAPE3, st, x)
    _, op = system(T, SHAPE3, pieces, stencil=st)
    _, op1 = system(T, SHAPE3, 1, stencil=st)
    assert op.uses_pallas and op._view["kind"] == "3d"
    xt = torch.from_numpy(x)
    y = op.matvec(xt).numpy()
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5
    assert np.array_equal(y, op1.matvec(xt).numpy())
    yd, d = op.matvec_dot(xt.reshape(SHAPE3))
    assert np.array_equal(yd.numpy().reshape(-1), y)
    dref = float(x.astype(np.float64) @ y_ref)
    assert abs(float(d) - dref) / abs(dref) < 1e-5
    opj = J.StencilOperator(SHAPE3, J.laplacian_stencil(dim),
                            partition=J.BlockPartition(n, pieces),
                            mesh=mesh4 if pieces == 4 else mesh8,
                            options=opts(J))
    yj = np.asarray(opj.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, yj, rtol=1e-6,
                               atol=1e-6 * np.abs(yj).max())


@pytest.mark.parametrize("dim", [3, 4])
def test_pallas3d_fused_cg_matches_linearized(dim):
    """test_15:69.  CG on 4 pieces of (8, 8, 128), 8 iterations: the
    fused 3-D runner (K6a ``pq`` + ``update`` prologue, then K6b + K6a
    ``update`` per piece on the pieces' halo planes) against the
    linearized path on the same pieces, history within 5e-3 (test_15's
    rel bound); and against JAX's fused sharded history, 5e-3."""
    st = T.laplacian_stencil(dim)
    hist = {}
    for use in (True, False):
        planner, op = system(T, SHAPE3, 4, stencil=st, use_pallas=use)
        assert op.uses_pallas == use
        solver = T.CGSolver(planner)
        if use:
            assert solver._make_fused_runner(8) is not None
        hist[use] = hist_of(solver.solve(8))
    rel = np.abs(hist[True] - hist[False]) / np.maximum(
        np.abs(hist[False]), 1e-12)
    assert rel.max() < 5e-3
    hj, _ = jax_history(SHAPE3, 4, "CGSolver", 8, dim)
    assert (np.abs(hist[True] - hj) / np.abs(hj)).max() < 5e-3


def test_fused3d_xpay_pq_matches_classic_sharded():
    """test_15:96, its sharded half.  On 4 pieces of (16, 32, 128) the
    32 B/unknown schedule (``fused3d_xp``) against the classic step()
    loop: history rtol 5e-4, x atol 2e-3 max|x|; and its history against
    JAX's on ``mesh4``, rtol 5e-4."""
    from legionsolvers_tpu_torch.utils.roofline import (
        solver_bytes_per_iteration,
    )

    shape = (16, 32, 128)
    n = int(np.prod(shape))
    p1, _ = system(T, shape, 4)
    s1 = T.CGSolver(p1)
    assert solver_bytes_per_iteration(s1, n)[1] == "fused3d_xp"
    h1 = hist_of(s1.solve(8))
    p2, _ = system(T, shape, 4)
    s2 = T.CGSolver(p2)
    s2._make_fused_runner = lambda k: None
    h2 = hist_of(s2.solve(8))
    np.testing.assert_allclose(h1, h2, rtol=5e-4)
    x2 = sol(p2)
    np.testing.assert_allclose(sol(p1), x2, rtol=0,
                               atol=2e-3 * np.abs(x2).max())
    hj, _ = jax_history(shape, 4, "CGSolver", 8)
    np.testing.assert_allclose(h1, hj, rtol=5e-4)


def test_3d_pass_kernels_get_real_planes(monkeypatch):
    """On 4 pieces every K6 call of the matvec and the fused CG gets its
    piece's [Y, Z] halo planes from the neighbours (zeros only at the
    grid's ends) in fresh storage, never a view of a vector."""
    from legionsolvers_tpu_torch.ops.cuda import stencil3d as T3

    calls = []
    for name in ("grid3d_stencil_matvec", "grid3d_cg_pq", "grid3d_cg_update",
                 "grid3d_cg_xpay_pq"):
        real = getattr(T3, name)

        def run(*a, _real=real, _name=name, **kw):
            calls.append((_name, a, kw))
            return _real(*a, **kw)

        monkeypatch.setattr(T3, name, run)
    planner, op = system(T, SHAPE3, 4)
    T.CGSolver(planner).solve(3)
    op.matvec(torch.ones(SHAPE3))
    vectors = {v.data.untyped_storage().data_ptr()
               for vs in (planner.sol_vectors, planner.rhs_vectors,
                          *planner.workspace_vectors) for v in vs
               if v._data is not None}
    seen = set()
    for name, a, kw in calls:
        k = {"grid3d_cg_update": 4, "grid3d_cg_xpay_pq": 3}.get(name, 1)
        planes = a[k:k + 2]
        assert len(planes) == 2 and all(
            p is not None and p.shape == (8, 128) for p in planes), name
        for p in planes:
            assert p.untyped_storage().data_ptr() not in vectors
        seen.add(name)
    assert seen == {"grid3d_stencil_matvec", "grid3d_cg_pq",
                    "grid3d_cg_update", "grid3d_cg_xpay_pq"}
