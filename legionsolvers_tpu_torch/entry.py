"""Entry points of the port's main paths.

:func:`entry` and :func:`dryrun_multichip` are the counterparts of
``__graft_entry__.entry`` and ``__graft_entry__.dryrun_multichip``: one CG
step of the 2-D 5-point system at 256^2 through ``dump_state`` /
``load_state``, and every solver of the port sharded over an n-shard mesh
on small shapes (on one process, or after ``initialize_distributed`` over
the processes of a run).  ``python -m legionsolvers_tpu_torch.entry``
runs the step on the card; ``--dryrun N`` runs the dry run instead
(``--device cpu`` on the CPU; with WORLD_SIZE, RANK, MASTER_ADDR and
MASTER_PORT set, over the processes of a run).

:func:`build_stencil_system` mirrors ``legionsolvers_tpu.benchmark
.build_planner``: the benchmark's ``-dim`` selector (1: 1-D 3-point, 2:
2-D 5-point, 3: 3-D 7-point, 4: 3-D 27-point negative Laplacian) on the
given grid, b = 1 and x0 = 0, with the vectors in their grid layout
whenever the operator's kernel view is active (1-D vectors in the
``[n // C, C]`` layout of the view, as the JAX CLI lays them); with ``num_spaces`` > 1 the
block system of ``--block``, the same operator registered once per space
(reference: BenchmarkStencil.cpp:201-207).  ``pieces`` and ``mesh``
partition the system as the JAX CLI's ``-vp`` does: a mesh from
``parallel/mesh.make_mesh`` (its shards on one device, or, after
``initialize_distributed``, on the processes of a run, each process
building and holding its own pieces) runs the operator on its pieces.
:func:`build_system` is its 2-D square case, as
``__graft_entry__._build_system(n_grid, mesh, pieces, options)`` builds
it.  ``stencil`` replaces the ``-dim`` stencil by any stencil over the
same grid (a list of (offset, value) pairs, as ``laplacian_stencil``
returns), with everything else as the CLI builds it.
:func:`build_explicit_system` is the explicit-matrix counterpart of
``scripts/bench_explicit.py``: flat vectors, b = 1, x0 = 0, the planner
choosing the operator (DIA, a reordered windowed ELL or the routed gather,
else ELL), in ``pieces`` pieces on ``mesh`` as ``build_stencil_system``
takes them (on pieces: DIA on pieces, a reordered or plain sharded ELL
with its halo exchange).  All run on the card unless the caller asks for
another device.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from .core.partition import BlockPartition
from .core.vector import PartitionedVector
from .options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from .parallel.mesh import make_mesh, num_shards, resolve_mesh
from .parallel.stencil_op import StencilOperator
from .planner import SquarePlanner
from .problems.stencil import laplacian_stencil, stencil_grid_ndim


def build_stencil_system(dim: int, shape: Sequence[int],
                         options: SolverOptions = DEFAULT_OPTIONS,
                         device=None, num_spaces: int = 1,
                         pieces: Optional[int] = None,
                         mesh=None, stencil=None) -> SquarePlanner:
    """``pieces`` defaults to the mesh's shard count (1 without a mesh);
    the device to the mesh's (the card without a mesh); ``stencil`` to
    ``laplacian_stencil(dim)``."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != stencil_grid_ndim(dim):
        raise ValueError(f"-dim {dim} needs a {stencil_grid_ndim(dim)}-D "
                         f"grid, got {shape}")
    if pieces is None:
        pieces = num_shards(mesh) if mesh is not None else 1
    part = BlockPartition(int(np.prod(shape)), pieces)
    mesh, device = resolve_mesh(mesh, part, device)
    if stencil is None:
        stencil = laplacian_stencil(dim)
    op = StencilOperator(shape, stencil, partition=part, mesh=mesh,
                         options=options, device=device)
    gs = shape if op.uses_pallas else None
    if gs is not None and len(shape) == 1:
        # 1-D vectors in the layout of the operator's [n // C, C] view
        gs = (shape[0] // op._view["C"], op._view["C"])
    planner = SquarePlanner(mesh=mesh, options=options, device=device)
    for i in range(num_spaces):
        sol = PartitionedVector(f"sol{i}", part, mesh=mesh, options=options,
                                grid_shape=gs, device=device, lazy=True)
        planner.add_sol_vector(sol)
    for i in range(num_spaces):
        rhs = PartitionedVector(f"rhs{i}", part, mesh=mesh, options=options,
                                grid_shape=gs, device=device)
        rhs.constant_fill(1.0)
        planner.add_rhs_vector(rhs)
    for i in range(num_spaces):
        planner.add_operator(op, i, i)
    return planner


def build_system(n_grid: int, options: SolverOptions = DEFAULT_OPTIONS,
                 device=None, pieces: Optional[int] = None,
                 mesh=None) -> SquarePlanner:
    return build_stencil_system(2, (n_grid, n_grid), options, device,
                                pieces=pieces, mesh=mesh)


def build_explicit_system(matrix, options: SolverOptions = DEFAULT_OPTIONS,
                          device=None, prefer_dia: bool = True,
                          pieces: Optional[int] = None,
                          mesh=None) -> SquarePlanner:
    """The system ``matrix`` x = 1 with x0 = 0, the square explicit
    ``matrix`` registered through ``add_row_partitioned_matrix``.
    ``pieces`` defaults to the mesh's shard count (1 without a mesh); the
    device to the mesh's (the card without a mesh)."""
    if matrix.n_domain != matrix.n_range:
        raise ValueError("an explicit system needs a square matrix")
    if pieces is None:
        pieces = num_shards(mesh) if mesh is not None else 1
    part = BlockPartition(int(matrix.n_range), pieces)
    mesh, device = resolve_mesh(mesh, part, device)
    rhs = PartitionedVector("rhs", part, mesh=mesh, options=options,
                            device=device)
    rhs.constant_fill(1.0)
    sol = PartitionedVector("sol", part, mesh=mesh, options=options,
                            device=device, lazy=True)
    planner = SquarePlanner(mesh=mesh, options=options, device=device)
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(rhs)
    planner.add_row_partitioned_matrix(matrix, 0, 0, prefer_dia=prefer_dia)
    return planner


# -- the counterparts of __graft_entry__.py ---------------------------------

def _make_step(planner, solver_cls):
    """(step, (state, rr0)): ``step(state, rr_old) -> (state, rr)`` loads
    the planner's state, makes one ``solver_cls`` step from it and dumps
    the state again (``__graft_entry__._make_step``)."""
    from .core.scalar import Scalar

    solver = solver_cls(planner)
    rr0 = solver.residual_norm_squared[-1].value

    def cg_step(state, rr_old):
        planner.load_state(state)
        solver.residual_norm_squared = [Scalar(rr_old)]
        solver.step()
        return planner.dump_state(), solver.residual_norm_squared[-1].value

    return cg_step, (planner.dump_state(), rr0)


def entry(device=None):
    """(fn, example_args): one CG iteration on the f32 2-D 5-point
    Laplacian at 256^2, one piece, on the card unless ``device`` names
    another device (``__graft_entry__.entry``)."""
    from .solvers.cg import CGSolver

    options = SolverOptions(entry_dtype=torch.float32)
    planner = build_system(256, options, device=device, pieces=1)
    return _make_step(planner, CGSolver)


def _dryrun_mesh(n_devices: int, device):
    """The dry run's mesh: ``n_devices`` shards on ``device``, all of them
    on one process, or after ``initialize_distributed`` an equal share on
    each process of the group."""
    import torch.distributed as dist

    dev = resolve_device(device)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    if n_devices % world:
        raise ValueError(f"{n_devices} shards do not split evenly over "
                         f"{world} processes")
    return make_mesh(n_devices, devices=[dev] * (n_devices // world))


@contextlib.contextmanager
def _env(**values):
    """Environment switches set for a block and restored after it."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Every solver of the port sharded over an ``n_devices``-shard mesh,
    run on small shapes (``__graft_entry__.dryrun_multichip`` at its
    shapes, iteration counts and seeds): the generic CG step, the fused
    two-pass runner with real halos, the s-step schedule, the fused
    BiCGStab, GMRES(4), the windowed-gather ELL, block CG and block
    BiCGStab, an explicit matrix upgraded to DIA, and PCG(Jacobi).  The
    shards live on ``device`` (default the card): all on this process, or,
    after ``initialize_distributed``, ``n_devices // world_size`` on each
    process of the group (ValueError where they do not split evenly).
    Keeps JAX's checks, prints its line and returns the histories it
    prints, by section, as host arrays."""
    from .core.matrix import COOMatrix
    from .parallel.block_fused import diagonal_block_ops
    from .parallel.dia_op import DiaOperator
    from .parallel.distmatrix import RowPartitionedMatrix
    from .problems.stencil import create_coo_stencil_matrix
    from .solvers.bicgstab import BiCGStabSolver
    from .solvers.cg import CGSolver
    from .solvers.gmres import GMRESSolver
    from .solvers.pcg import JacobiPreconditioner, PCGSolver

    options = SolverOptions(entry_dtype=torch.float32)
    mesh = _dryrun_mesh(n_devices, device)
    out = {}

    def finite(key, h):
        out[key] = h.detach().cpu().numpy().astype(np.float64).reshape(-1)
        assert np.all(np.isfinite(out[key])), (key, out[key])
        return out[key]

    # 1) the generic CG step (eager planner algebra)
    n_grid = max(8, 2 * n_devices)
    step, (state, rr) = _make_step(
        build_system(n_grid, options, mesh=mesh), CGSolver)
    _, rr_new = step(state, rr)
    finite("step", torch.stack([rr, rr_new]))

    # 2) the fused two-pass runner: [8 n, 128], every piece 8 rows and a
    # real +-1-row halo with both neighbours
    shape = (8 * n_devices, 128)
    solver = CGSolver(build_stencil_system(2, shape, options, mesh=mesh))
    assert solver._make_fused_runner(3) is not None, (
        "fused CG runner unavailable in the multichip dryrun")
    hist = finite("fused", solver.solve(3))

    # 2b) the s-step schedule on 16-row pieces
    shape_s = (16 * n_devices, 128)
    pls = build_stencil_system(2, shape_s, options, mesh=mesh)
    op_s = pls.row_partitioned_matrices[0][0]
    if op_s.step2_eligible:
        hist_s = finite("sstep", CGSolver(pls).solve(4))
    else:
        hist_s = out["sstep"] = np.asarray([float("nan")])

    # 2c) the fused BiCGStab on pieces (zero-halo passes + edge fix-ups)
    if op_s.supports_fused_bicgstab:
        hist_b = finite("bicgstab", BiCGStabSolver(build_stencil_system(
            2, shape_s, options, mesh=mesh)).solve(3))
    else:
        hist_b = out["bicgstab"] = np.asarray([float("nan")])

    # 2d) GMRES(4): the batched-basis CGS2 cycle over the mesh
    gmres = GMRESSolver(build_stencil_system(2, shape, options, mesh=mesh),
                        restart=4)
    hist_g = finite("gmres", gmres.solve(2))
    assert hist_g.shape == (3,) and hist_g[-1] < hist_g[0], hist_g

    # 2e) general sparsity: the windowed-gather ELL over the banded
    # halo buffer, built without the DIA and basis upgrades
    nw = 16 * 1024
    rngw = np.random.default_rng(5)
    wrows = rngw.integers(0, nw, nw * 3)
    wcols = wrows + rngw.integers(-64, 65, nw * 3)
    keep = (wcols >= 0) & (wcols < nw)
    wrows, wcols = wrows[keep], wcols[keep]
    wvals = rngw.uniform(-1, 1, len(wrows))
    rw = np.concatenate([wrows, wcols, np.arange(nw)])
    cw = np.concatenate([wcols, wrows, np.arange(nw)])
    vw = np.concatenate([wvals, wvals, np.full(nw, 12.0)])
    with _env(LEGIONSOLVERS_NO_DIA="1", LEGIONSOLVERS_NO_RCM="1"):
        plw = build_explicit_system(
            COOMatrix(rw, cw, vw, nw, nw, options=options), options,
            mesh=mesh)
    opw = plw.row_partitioned_matrices[0][0]
    assert isinstance(opw, RowPartitionedMatrix)
    assert opw._win is not None, "sharded winell plan expected"
    hist_w = finite("winell", CGSolver(plw).solve(3))

    # 2f) a block system of 2 spaces (b = 1 and 2) on the fused per-space
    # phases: CG on the s-step phases, BiCGStab on the three-pass ones
    def build_block():
        plk = build_stencil_system(2, shape_s, options, mesh=mesh,
                                   num_spaces=2)
        plk.rhs_vectors[1].constant_fill(2.0)
        assert diagonal_block_ops(plk) is not None
        return plk

    sk = CGSolver(build_block())
    assert sk._make_fused_runner(4) is not None, (
        "block CG runner unavailable in the multichip dryrun")
    hist_k = finite("block-cg", sk.solve(4))
    skb = BiCGStabSolver(build_block())
    assert skb._make_fused_runner(3) is not None
    hist_kb = finite("block-bicg", skb.solve(3))

    # 3) an explicit matrix upgraded to the DIA operator over the mesh
    A = create_coo_stencil_matrix(shape, laplacian_stencil(2),
                                  options=options)
    pl3 = build_explicit_system(A, options, mesh=mesh)
    assert isinstance(pl3.row_partitioned_matrices[0][0], DiaOperator)
    hist3 = finite("dia", CGSolver(pl3).solve(3))

    # 4) PCG with the Jacobi preconditioner over the mesh
    pl4 = build_explicit_system(A, options, mesh=mesh)
    hist4 = finite("pcg", PCGSolver(pl4, JacobiPreconditioner(pl4))
                   .solve(3))

    rr0, rr1 = out["step"]
    print(
        f"[legionsolvers_tpu_torch] dryrun_multichip({n_devices}): ok, "
        f"step rr0={rr0:g} -> rr1={rr1:g}, "
        f"fused rr[3]={hist[-1]:g}, sstep rr[4]={hist_s[-1]:g}, "
        f"bicgstab rr[3]={hist_b[-1]:g}, gmres rr[2cyc]={hist_g[-1]:g}, "
        f"block-cg rr[4]={hist_k[-1]:g}, block-bicg rr[3]={hist_kb[-1]:g}, "
        f"winell rr[3]={hist_w[-1]:g}, dia rr[3]={hist3[-1]:g}, "
        f"pcg rr[3]={hist4[-1]:g}", flush=True)
    return out


def main(argv=None) -> int:
    """``python -m legionsolvers_tpu_torch.entry [--dryrun N] [--device
    DEV]``: one step of :func:`entry`, or :func:`dryrun_multichip` (N)
    after ``initialize_distributed`` (a no-op without WORLD_SIZE)."""
    import argparse

    from .parallel.mesh import initialize_distributed

    ap = argparse.ArgumentParser(prog="python -m legionsolvers_tpu_torch"
                                 ".entry")
    ap.add_argument("--dryrun", type=int, default=None, metavar="N")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        initialize_distributed()
        dryrun_multichip(args.dryrun, device=args.device)
        return 0
    fn, example = entry(device=args.device)
    _, rr = fn(*example)
    rr = float(rr)
    assert np.isfinite(rr), rr
    print(f"[legionsolvers_tpu_torch] entry(): single-device CG step ran "
          f"on {resolve_device(args.device)}, rr1={rr:g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
