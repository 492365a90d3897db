"""N-D stencil -> sparse matrix generators.

Port of ``legionsolvers_tpu/problems/stencil.py`` (reference:
StencilGenerator.hpp:270-643).  A stencil is a list of
``(offset_vector, entry_value)`` pairs over an N-D grid; the matrix has
``A[p, p+o] = v`` for every grid point ``p`` with ``p+o`` in bounds, grid
points linearized row-major.  Only the vectorized numpy fill is ported; the
JAX package's native C++ fill waits for the ``native/`` slice.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core.matrix import COOMatrix, CSRMatrix
from ..options import DEFAULT_OPTIONS, MAX_DIM, SolverOptions

Offset = Tuple[int, ...]
Stencil = Sequence[Tuple[Offset, float]]


def calculate_stencil_size(shape: Sequence[int], offsets: Stencil) -> int:
    """Exact nonzero count: prod_d max(n_d - |o_d|, 0) summed over offsets
    (reference: calculate_stencil_size, StencilGenerator.hpp:270-323)."""
    total = 0
    for off, _ in offsets:
        cnt = 1
        for n_d, o_d in zip(shape, off):
            cnt *= max(n_d - abs(o_d), 0)
        total += cnt
    return total


def _strides(shape: Sequence[int]) -> List[int]:
    """Row-major strides (reference: StencilGenerator.hpp:231-243)."""
    s = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        s[i] = s[i + 1] * shape[i + 1]
    return s


def linear_offset(shape: Sequence[int], off: Offset) -> int:
    """The constant linearized distance of a stencil offset."""
    return int(sum(o * st for o, st in zip(off, _strides(shape))))


def stencil_coo_arrays(shape: Sequence[int], offsets: Stencil):
    """(rows, cols, vals, n), sorted row-major by (row, col) so COO and CSR
    agree on layout."""
    shape = tuple(int(n) for n in shape)
    if not (1 <= len(shape) <= MAX_DIM):
        raise ValueError(f"stencil dim must be 1..{MAX_DIM}, got {len(shape)}")
    n = int(np.prod(shape))
    strides = _strides(shape)
    rows_l, cols_l, vals_l = [], [], []
    for off, val in offsets:
        # valid points: 0 <= p_d + o_d < n_d
        ranges = [
            np.arange(max(0, -o), n_d - max(0, o), dtype=np.int64)
            for n_d, o in zip(shape, off)
        ]
        if any(len(r) == 0 for r in ranges):
            continue
        grids = np.meshgrid(*ranges, indexing="ij")
        p_lin = sum(g * st for g, st in zip(grids, strides)).ravel()
        rows_l.append(p_lin)
        cols_l.append(p_lin + linear_offset(shape, off))
        vals_l.append(np.full(len(p_lin), val))
    rows = np.concatenate(rows_l) if rows_l else np.empty(0, np.int64)
    cols = np.concatenate(cols_l) if cols_l else np.empty(0, np.int64)
    vals = np.concatenate(vals_l) if vals_l else np.empty(0, np.float64)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order], n


def create_coo_stencil_matrix(
    shape: Sequence[int],
    offsets: Stencil,
    name: str = "stencil_coo",
    options: SolverOptions = DEFAULT_OPTIONS,
) -> COOMatrix:
    """reference: create_coo_stencil_matrix, StencilGenerator.hpp:326-416."""
    rows, cols, vals, n = stencil_coo_arrays(shape, offsets)
    return COOMatrix(rows, cols, vals, n, n, name=name, options=options)


def create_csr_stencil_matrix(
    shape: Sequence[int],
    offsets: Stencil,
    name: str = "stencil_csr",
    options: SolverOptions = DEFAULT_OPTIONS,
) -> CSRMatrix:
    """reference: create_linearized_csr_stencil_matrix,
    StencilGenerator.hpp:419-643."""
    rows, cols, vals, n = stencil_coo_arrays(shape, offsets)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRMatrix(indptr, cols, vals, n, n, name=name, options=options)


# The reference distinguishes N-D-indexed CSR from linearized (1-D-indexed)
# CSR; this build always linearizes, so the two names are one function.
create_linearized_csr_stencil_matrix = create_csr_stencil_matrix


def laplacian_stencil(dim: int) -> Stencil:
    """The benchmark stencils (reference: BenchmarkStencil.cpp:24-137):
    ``dim`` in {1, 2, 3} gives the 3/5/7-point negative Laplacian;
    ``dim == 4`` is the 3-D 27-point kernel."""
    if dim == 1:
        return [((0,), 2.0), ((-1,), -1.0), ((1,), -1.0)]
    if dim == 2:
        return [
            ((0, 0), 4.0),
            ((-1, 0), -1.0), ((1, 0), -1.0),
            ((0, -1), -1.0), ((0, 1), -1.0),
        ]
    if dim == 3:
        return [
            ((0, 0, 0), 6.0),
            ((-1, 0, 0), -1.0), ((1, 0, 0), -1.0),
            ((0, -1, 0), -1.0), ((0, 1, 0), -1.0),
            ((0, 0, -1), -1.0), ((0, 0, 1), -1.0),
        ]
    if dim == 4:  # 3-D 27-point (reference: BenchmarkStencil.cpp:80-130)
        offs: List[Tuple[Offset, float]] = [((0, 0, 0), 88.0 / 26.0)]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    dist = abs(dx) + abs(dy) + abs(dz)
                    if dist == 0:
                        continue
                    val = {1: -6.0 / 26.0, 2: -3.0 / 26.0, 3: -2.0 / 26.0}[dist]
                    offs.append(((dx, dy, dz), val))
        return offs
    raise ValueError(f"dim must be 1..4, got {dim}")


def stencil_grid_ndim(dim: int) -> int:
    """Grid dimensionality for a benchmark ``dim`` selector (4 -> 3-D grid)."""
    return 3 if dim == 4 else dim
