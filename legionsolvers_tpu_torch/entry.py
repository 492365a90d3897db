"""Entry points of the port's main paths.

:func:`build_stencil_system` mirrors ``legionsolvers_tpu.benchmark
.build_planner`` with one piece and no block system: the benchmark's
``-dim`` selector (1: 1-D 3-point, 2: 2-D 5-point, 3: 3-D 7-point, 4: 3-D
27-point negative Laplacian) on the given grid, b = 1 and x0 = 0, with the
vectors in their grid layout whenever the operator's kernel view is active.
:func:`build_system` is its 2-D square case, as
``__graft_entry__._build_system`` builds it for one device.
:func:`build_explicit_system` is the explicit-matrix counterpart of
``scripts/bench_explicit.py``: one piece, flat vectors, b = 1, x0 = 0,
the planner choosing the operator (DIA, a reordered windowed ELL or the
routed gather, else ELL).  All run on the card unless the caller asks for
another device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .core.partition import BlockPartition
from .core.vector import PartitionedVector
from .options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from .parallel.stencil_op import StencilOperator
from .planner import SquarePlanner
from .problems.stencil import laplacian_stencil, stencil_grid_ndim


def build_stencil_system(dim: int, shape: Sequence[int],
                         options: SolverOptions = DEFAULT_OPTIONS,
                         device=None) -> SquarePlanner:
    shape = tuple(int(s) for s in shape)
    if len(shape) != stencil_grid_ndim(dim):
        raise ValueError(f"-dim {dim} needs a {stencil_grid_ndim(dim)}-D "
                         f"grid, got {shape}")
    device = resolve_device(device)
    part = BlockPartition(int(np.prod(shape)), 1)
    op = StencilOperator(shape, laplacian_stencil(dim), partition=part,
                         options=options, device=device)
    gs = shape if op.uses_pallas else None
    rhs = PartitionedVector("rhs", part, options=options, grid_shape=gs,
                            device=device)
    rhs.constant_fill(1.0)
    sol = PartitionedVector("sol", part, options=options, grid_shape=gs,
                            device=device, lazy=True)
    planner = SquarePlanner(options=options, device=device)
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(rhs)
    planner.add_operator(op, 0, 0)
    return planner


def build_system(n_grid: int, options: SolverOptions = DEFAULT_OPTIONS,
                 device=None) -> SquarePlanner:
    return build_stencil_system(2, (n_grid, n_grid), options, device)


def build_explicit_system(matrix, options: SolverOptions = DEFAULT_OPTIONS,
                          device=None, prefer_dia: bool = True
                          ) -> SquarePlanner:
    """A one-piece system ``matrix`` x = 1 with x0 = 0, the square explicit
    ``matrix`` registered through ``add_row_partitioned_matrix``."""
    if matrix.n_domain != matrix.n_range:
        raise ValueError("an explicit system needs a square matrix")
    device = resolve_device(device)
    part = BlockPartition(int(matrix.n_range), 1)
    rhs = PartitionedVector("rhs", part, options=options, device=device)
    rhs.constant_fill(1.0)
    sol = PartitionedVector("sol", part, options=options, device=device,
                            lazy=True)
    planner = SquarePlanner(options=options, device=device)
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(rhs)
    planner.add_row_partitioned_matrix(matrix, 0, 0, prefer_dia=prefer_dia)
    return planner
