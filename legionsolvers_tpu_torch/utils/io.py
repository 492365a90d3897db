"""Matrix Market I/O and solver-state checkpointing.

Port of ``legionsolvers_tpu/utils/io.py``.  The reference planned Matrix
Market import (its README.md:90-99) and has no checkpoint/resume.

Matrix Market: the ``coordinate`` subset with ``real``, ``integer`` or
``pattern`` entries, ``general`` or ``symmetric`` (off-diagonal entries
mirrored), 1-based indices.  Files cross between the two packages: each
reads the other's into the same arrays.  The lines are formatted by the
host library (``native/``) where it is loaded.

Checkpoints: a solver's restartable state is the planner's vectors plus
its scalar recurrences, saved as one ``.npz`` with the JAX package's keys
(``vec_<key>_<i>``, ``scalar_<attr>``).  Tensors come to the host to be
saved and go back onto the solver's device when loaded.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..core.matrix import COOMatrix
from ..core.scalar import Scalar
from ..native.bindings import matrix_market_lines
from ..options import DEFAULT_OPTIONS, SolverOptions

SCALARS = ("residual_norm_squared", "rho", "alpha", "omega")


def read_matrix_market(
    path: str, options: SolverOptions = DEFAULT_OPTIONS
) -> COOMatrix:
    """Read a MatrixMarket coordinate file into a COOMatrix named after the
    file."""
    with open(path, "r") as f:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path}: not a MatrixMarket file")
        parts = header.split()
        if len(parts) < 5 or parts[1] != "matrix" or parts[2] != "coordinate":
            raise ValueError(f"{path}: only coordinate matrices supported")
        field, symmetry = parts[3], parts[4]
        if field not in ("real", "integer", "pattern"):
            raise ValueError(f"{path}: unsupported field {field}")
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        n_rows, n_cols, nnz = (int(t) for t in line.split())
        data = np.loadtxt(f, ndmin=2) if nnz else np.empty((0, 3))
    if data.shape[0] != nnz:
        raise ValueError(f"{path}: expected {nnz} entries, got {data.shape[0]}")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = (data[:, 2] if field != "pattern" and data.shape[1] > 2
            else np.ones(nnz))
    if symmetry == "symmetric":
        off = rows != cols  # mirror the strictly off-diagonal entries
        rows, cols, vals = (
            np.concatenate([rows, cols[off]]),
            np.concatenate([cols, rows[off]]),
            np.concatenate([vals, vals[off]]),
        )
    elif symmetry != "general":
        raise ValueError(f"{path}: unsupported symmetry {symmetry}")
    name = os.path.splitext(os.path.basename(path))[0]
    return COOMatrix(rows, cols, vals, n_rows, n_cols, name=name,
                     options=options)


def write_matrix_market(path: str, matrix) -> None:
    """Write a COO/CSR operator as MatrixMarket coordinate real general,
    each value with enough digits to read back to the same double."""
    rows = np.asarray(matrix.rows)
    with open(path, "wb") as f:
        f.write(b"%%MatrixMarket matrix coordinate real general\n")
        f.write(f"{matrix.n_range} {matrix.n_domain} {len(rows)}\n".encode())
        for chunk in matrix_market_lines(rows, matrix.cols,
                                         np.asarray(matrix.vals, np.float64)):
            f.write(chunk)


# -- solver checkpointing ---------------------------------------------------

def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _stackable(state) -> bool:
    """An operator state the checkpoint carries: a tuple of tensors of one
    shape and dtype (what the JAX package's ``np.asarray`` stacks)."""
    return (isinstance(state, (tuple, list)) and len(state) > 0
            and all(isinstance(t, torch.Tensor) for t in state)
            and len({(t.shape, t.dtype) for t in state}) == 1)


def _scalar_lists(solver):
    """The scalar recurrences the solver keeps as lists of Scalars
    (BiCGStab's ``residual_norm_squared`` is a method, and is derived)."""
    return [a for a in SCALARS if isinstance(getattr(solver, a, None), list)]


def save_checkpoint(path: str, solver) -> None:
    """Save a solver's restartable state (planner vectors and scalar
    recurrences) to ``path`` (.npz).  Each operator's device state (the
    ``ops`` entries of ``dump_state``) is saved where it is a tuple of
    tensors of one shape, stacked, as the JAX package saves it; other
    operator states (None, nested buffers) are left out: the operator a
    solver is rebuilt with holds them already."""
    state = solver.planner.dump_state()
    arrays = {}
    for key, vecs in state.items():
        for i, v in enumerate(vecs):
            if key != "ops":
                arrays[f"vec_{key}_{i}"] = _host(v)
            elif _stackable(v):
                arrays[f"vec_{key}_{i}"] = _host(torch.stack(list(v)))
    for attr in _scalar_lists(solver):
        arrays[f"scalar_{attr}"] = _host(torch.stack(
            [torch.as_tensor(s.value) for s in getattr(solver, attr)]))
    np.savez(path, **arrays)


def _ops_entry(data, key: str, device):
    """The operator state saved under ``key``, or None where none was
    saved, or where the JAX package saved an object array (None or a dict
    of buffers: a pickle, which is not loaded)."""
    if key not in data.files:
        return None
    try:
        arr = data[key]
    except ValueError:  # an object array, which needs allow_pickle
        return None
    return tuple(torch.from_numpy(a).to(device) for a in arr)


def load_checkpoint(path: str, solver) -> None:
    """Restore state saved by :func:`save_checkpoint` (or by the JAX
    package's) into ``solver``, which must be built over an identically
    shaped system; tensors go onto the planner's device."""
    planner = solver.planner
    device = planner.device
    state = planner.dump_state()
    with np.load(path) as data:
        new_state = {}
        for key, vecs in state.items():
            if key == "ops":
                new_state[key] = tuple(
                    _ops_entry(data, f"vec_ops_{i}", device)
                    for i in range(len(vecs)))
                continue
            new_state[key] = tuple(
                torch.from_numpy(data[f"vec_{key}_{i}"]).to(device)
                for i in range(len(vecs)))
        planner.load_state(new_state)
        for attr in _scalar_lists(solver):
            k = f"scalar_{attr}"
            if k in data.files:
                vals = torch.from_numpy(data[k]).to(device)
                setattr(solver, attr, [Scalar(v) for v in vals])
