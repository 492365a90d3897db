"""Carry a solver's state across from the JAX package.

A JAX system reaches this module as plain numpy: its grid shape and
``(offset, value)`` stencil list (or its COO arrays), the vectors of
``SquarePlanner.dump_state()`` after ``np.asarray``, and the tail of its
residual² history (CG), its x, r, p, v and rho, alpha, omega (BiCGStab),
its vectors and last rz (PCG), or its x and b (GMRES, whose cycles
re-derive everything else).  The functions build the port's planner and solver holding the same state,
so both packages continue the same computation.  For an explicit system
whose JAX planner adopted a reordered basis, :func:`explicit_cg_system`
takes that basis (``basis_perms[0]["perm_np"]``) too, so that both
packages compute in it, on one piece or on the pieces of a mesh.  On a
mesh over processes every rank passes the whole JAX arrays and keeps its
rows of each (its pieces), and adopts the whole basis, so a JAX state
carries onto a mesh over processes.  Nothing here imports jax.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..core.matrix import COOMatrix
from ..core.partition import BlockPartition
from ..core.scalar import Scalar
from ..core.vector import PartitionedVector
from ..options import DEFAULT_OPTIONS, SolverOptions
from ..parallel.mesh import num_shards
from ..parallel.stencil_op import StencilOperator
from ..planner import SquarePlanner
from ..solvers.bicgstab import BiCGStabSolver
from ..solvers.cg import CGSolver
from ..solvers.gmres import GMRESSolver
from ..solvers.pcg import JacobiPreconditioner, PCGSolver


def _tensor(a, like: PartitionedVector) -> torch.Tensor:
    """A fresh buffer of ``like``'s pieces of the whole padded array ``a``
    (on a mesh over processes this process's rows): ``np.asarray`` of a
    JAX array may be a view of JAX's own memory, which the port's in-place
    runners would otherwise write."""
    t = torch.tensor(np.array(a), dtype=like.options.entry_dtype)
    return like._slice(t.reshape(-1)).reshape(like._shape()).to(like.device)


def load_state(planner: SquarePlanner, state: Mapping) -> None:
    """Copy a numpy snapshot of ``SquarePlanner.dump_state()`` (keys
    ``sol``, ``rhs``, ``ws0``...; ``ops`` is ignored) into ``planner``'s
    vectors, one fresh buffer per vector (each rank's rows of it on a
    mesh over processes)."""
    sets = [("sol", planner.sol_vectors), ("rhs", planner.rhs_vectors)]
    sets += [(f"ws{j}", ws) for j, ws in enumerate(planner.workspace_vectors)]
    for key, vectors in sets:
        if key not in state:
            continue
        for v, a in zip(vectors, state[key]):
            v.data = _tensor(a, v)


def cg_solver_from_state(planner: SquarePlanner, state: Mapping,
                         rr_history: Sequence[float]) -> CGSolver:
    """A :class:`CGSolver` on ``planner`` continuing from ``state`` with
    the given residual² history (at least its last entry)."""
    solver = CGSolver(planner)
    load_state(planner, state)
    dtype = planner.options.entry_dtype
    solver.residual_norm_squared = [
        Scalar(torch.tensor(float(v), dtype=dtype, device=planner.device))
        for v in rr_history
    ]
    return solver


def bicgstab_solver_from_state(planner: SquarePlanner,
                               state: Mapping) -> BiCGStabSolver:
    """A :class:`BiCGStabSolver` on ``planner`` continuing from ``state``:
    numpy arrays ``x``, ``r``, ``p``, ``v`` (the JAX solver's SOL, R, P and
    V vectors) and the scalars ``rho``, ``alpha`` and ``omega`` (the last
    entries of its lists).  R_TILDE stays the copy of the planner's b."""
    solver = BiCGStabSolver(planner)
    for idx, key in ((solver.SOL, "x"), (solver.R, "r"), (solver.P, "p"),
                     (solver.V, "v")):
        vec = planner.get_vector(idx, 0)
        vec.data = _tensor(state[key], vec)
    dtype = planner.options.entry_dtype
    solver.rho, solver.alpha, solver.omega = (
        [Scalar(torch.tensor(float(state[k]), dtype=dtype,
                             device=planner.device))]
        for k in ("rho", "alpha", "omega"))
    return solver


def pcg_solver_from_state(planner: SquarePlanner, state: Mapping,
                          rz: float, jacobi: bool = True) -> PCGSolver:
    """A :class:`PCGSolver` on ``planner`` (Jacobi-preconditioned unless
    ``jacobi`` is False) continuing from ``state``: a numpy snapshot of the
    JAX planner's ``dump_state()`` (sol, rhs and the workspace P, Q, R, Z
    as ``ws0``..``ws3``) and the JAX solver's last ``rz``."""
    solver = PCGSolver(planner,
                       JacobiPreconditioner(planner) if jacobi else None)
    load_state(planner, state)
    dtype = planner.options.entry_dtype
    solver.rz = [Scalar(torch.tensor(float(rz), dtype=dtype,
                                     device=planner.device))]
    solver.residual_norm_squared = [planner.dot(solver.R, solver.R)]
    return solver


def gmres_solver_from_state(planner: SquarePlanner, state: Mapping,
                            restart: int) -> GMRESSolver:
    """A :class:`GMRESSolver` on ``planner`` continuing from ``state``
    (its ``sol`` and ``rhs``; every cycle starts from x and b)."""
    solver = GMRESSolver(planner, restart)
    load_state(planner, state)
    return solver


def _planner(op_or_matrix, partition, grid_shape, options, device,
             prefer_dia: bool = True, perm=None, mesh=None):
    planner = SquarePlanner(mesh=mesh, options=options, device=device)
    for name, add in (("sol", planner.add_sol_vector),
                      ("rhs", planner.add_rhs_vector)):
        add(PartitionedVector(name, partition, mesh=mesh, options=options,
                              grid_shape=grid_shape, device=device))
    if perm is not None:
        planner.adopt_basis(0, perm)
    if isinstance(op_or_matrix, COOMatrix):
        planner.add_row_partitioned_matrix(op_or_matrix, 0, 0,
                                           prefer_dia=prefer_dia)
    else:
        planner.add_operator(op_or_matrix, 0, 0)
    return planner


def stencil_cg_system(shape: Sequence[int], stencil, state: Mapping,
                      rr_history: Sequence[float], *,
                      options: SolverOptions = DEFAULT_OPTIONS,
                      device=None, mesh=None):
    """(planner, solver) for a stencil system in the state ``state``, on
    one piece or on the pieces of ``mesh``, one per shard.  Vectors take
    the grid layout when the kernel view is active, as in
    ``entry.build_system``."""
    n = int(np.prod(shape))
    part = BlockPartition(n, num_shards(mesh) if mesh is not None else 1)
    op = StencilOperator(shape, [(tuple(o), float(v)) for o, v in stencil],
                         partition=part, mesh=mesh, options=options,
                         device=device)
    gs = tuple(shape) if op.uses_pallas else None
    planner = _planner(op, part, gs, options, op.device, mesh=mesh)
    return planner, cg_solver_from_state(planner, state, rr_history)


def coo_cg_system(rows, cols, vals, n: int, state: Mapping,
                  rr_history: Sequence[float], *, pieces: int = 1,
                  options: SolverOptions = DEFAULT_OPTIONS, device=None,
                  grid_shape: Optional[tuple] = None):
    """(planner, solver) for an explicit COO system in the state ``state``."""
    A = COOMatrix(rows, cols, vals, n, n, options=options)
    part = BlockPartition(n, pieces)
    planner = _planner(A, part, grid_shape, options, device)
    return planner, cg_solver_from_state(planner, state, rr_history)


def explicit_cg_system(rows, cols, vals, n: int, state: Mapping,
                       rr_history: Sequence[float], *,
                       options: SolverOptions = DEFAULT_OPTIONS, device=None,
                       prefer_dia: bool = True, perm=None,
                       pieces: Optional[int] = None, mesh=None):
    """(planner, solver) for an explicit system, as
    ``entry.build_explicit_system`` builds it, in the state ``state`` (the
    vectors in the original basis, as ``dump_state()`` gives them between
    solves).  ``pieces`` and ``mesh``: the JAX system's piece count and the
    port's mesh of as many shards (``make_mesh(S, devices=[dev] * S)``);
    ``pieces`` defaults to the mesh's shard count, else 1.  ``perm``: the
    JAX planner's basis, adopted through the forced path of
    ``try_reordered_operator`` (on pieces too); without it the port's
    planner chooses its own operator."""
    A = COOMatrix(rows, cols, vals, n, n, options=options)
    if pieces is None:
        pieces = num_shards(mesh) if mesh is not None else 1
    planner = _planner(A, BlockPartition(n, pieces), None, options, device,
                       prefer_dia=prefer_dia, perm=perm, mesh=mesh)
    return planner, cg_solver_from_state(planner, state, rr_history)
