"""Entry points of the port's main paths.

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
building and holding its own pieces; block systems are refused there)
runs the operator on its pieces.  :func:`build_system` is its 2-D square
case, as ``__graft_entry__._build_system(n_grid, mesh, pieces, options)``
builds it.  ``stencil`` replaces the ``-dim`` stencil by any stencil over the
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

from typing import Optional, Sequence

import numpy as np

from .core.partition import BlockPartition
from .core.vector import PartitionedVector
from .options import DEFAULT_OPTIONS, SolverOptions
from .parallel.mesh import num_shards, refuse_processes, resolve_mesh
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
    if num_spaces > 1:
        refuse_processes(mesh, "a block system")
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
