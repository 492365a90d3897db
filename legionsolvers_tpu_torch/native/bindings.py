"""Host helpers: stencil sizes, CSR row pointers, DIA extraction, RCM
ordering and the per-piece halo and ELL packing of a row-partitioned
matrix.

Port of the numpy/scipy paths of ``legionsolvers_tpu/native/bindings.py``
(``stencil_size``, ``stencil_fill_coo``, ``build_indptr``,
``dia_unique_offsets``, ``dia_accumulate``, ``rcm_permutation``,
``shard_halo_columns``, ``pack_ell_shard``).  The JAX
package prefers a C++ library and falls back to these; the port has no
C++ host code, so :func:`available` is False and
:func:`stencil_fill_coo` leaves the work to the numpy generator of
``problems/stencil.py``, as the JAX package's does without its library.
Duplicate (row, col) entries are summed, as COO semantics require
(reference: COOMatrixTasks.cpp:38-39).
"""

from __future__ import annotations

import numpy as np

_DIA_CHUNK = 1 << 24  # nnz per pass of the offset scan


def available() -> bool:
    """Whether a native host library is loaded: never, in the port."""
    return False


def stencil_size(shape, offsets) -> int:
    """Nonzeros of the stencil matrix over a grid of ``shape``: for each
    offset, the grid points whose neighbour at that offset is inside."""
    shape = np.ascontiguousarray(shape, np.int64)
    offs = np.ascontiguousarray(offsets, np.int64)
    cnt = np.maximum(shape[None, :] - np.abs(offs), 0)
    return int(np.prod(cnt, axis=1).sum())


def stencil_fill_coo(shape, offsets, values):
    """The native generator's (rows, cols, vals), or None without a native
    library (always, here): callers use their numpy generator."""
    return None


def build_indptr(rows, n_rows):
    """CSR row pointers [n_rows + 1] of a row index array."""
    rows = np.ascontiguousarray(rows, np.int64)
    indptr = np.zeros(n_rows + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr)


def dia_unique_offsets(rows, cols, max_diags):
    """Sorted distinct diagonal offsets (col - row), or None when the matrix
    has more than ``max_diags`` of them.  Chunked, so that no O(nnz)
    temporary is held beyond one chunk."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    u = np.empty(0, np.int64)
    for s in range(0, len(rows), _DIA_CHUNK):
        d = cols[s: s + _DIA_CHUNK] - rows[s: s + _DIA_CHUNK]
        lo = int(d.min())
        if int(d.max()) - lo < _DIA_CHUNK:  # a count per offset beats a sort
            d = np.flatnonzero(np.bincount(d - lo)) + lo
        u = np.union1d(u, d)
        if len(u) > max_diags:
            return None
    return u


def dia_accumulate(rows, cols, vals, uoffs, padded, dtype):
    """coef[D, padded] in ``dtype``: ``coef[k, r]`` is the sum of the entries
    on row r of diagonal ``uoffs[k]``.  Values are rounded to ``dtype``
    first and summed with ``np.bincount`` (in float64, in input order)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    uoffs = np.asarray(uoffs, np.int64)
    dtype = np.dtype(dtype)
    size = len(uoffs) * padded
    flat = np.zeros(size, np.float64)
    for s in range(0, len(rows), _DIA_CHUNK):
        e = min(s + _DIA_CHUNK, len(rows))
        k = np.searchsorted(uoffs, cols[s:e] - rows[s:e])
        w = np.asarray(vals[s:e], dtype).astype(np.float64)
        flat += np.bincount(k * padded + rows[s:e], weights=w, minlength=size)
    return flat.astype(dtype).reshape(len(uoffs), padded)


def rcm_permutation(n, rows, cols):
    """Reverse Cuthill-McKee ordering of the symmetrized pattern (scipy):
    perm[i] = the original index placed at position i, so that
    A[perm][:, perm] is banded."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    a = coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n)
    ).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(a + a.T, symmetric_mode=True), np.int64
    )


def shard_halo_columns(cols_global, d0, B_d):
    """Sorted distinct columns outside the block ``[d0, d0 + B_d)``: the
    halo one piece reads (the ghost image of its nonzeros, reference:
    COOMatrix.cpp:98-118)."""
    c = np.ascontiguousarray(cols_global, np.int64)
    return np.unique(c[(c < d0) | (c >= d0 + B_d)])


def pack_ell_shard(rows_local, cols_global, vals, B_r, B_d, d0, halo_global,
                   L, dump):
    """ELL-pack one piece's nonzeros: (ell_cols int32 [B_r, L], ell_vals
    float64 [B_r, L]).  ``rows_local`` is sorted (stably) and the nonzeros
    of a row keep their order in the slots.  Columns are remapped into the
    piece's extended buffer: ``c - d0`` inside its block ``[d0, d0 +
    B_d)``, ``B_d`` + the position in the sorted ``halo_global`` outside;
    padded slots hold (``dump``, 0)."""
    rows_local = np.ascontiguousarray(rows_local, np.int64)
    c = np.ascontiguousarray(cols_global, np.int64)
    halo_global = np.ascontiguousarray(halo_global, np.int64)
    local = (c >= d0) & (c < d0 + B_d)
    lc = np.empty(len(c), np.int64)
    lc[local] = c[local] - d0
    lc[~local] = B_d + np.searchsorted(halo_global, c[~local])
    starts = np.concatenate([[0], np.cumsum(np.bincount(rows_local,
                                                       minlength=B_r))])
    slot = np.arange(len(rows_local)) - starts[rows_local]
    ell_cols = np.full((B_r, L), dump, np.int32)
    ell_vals = np.zeros((B_r, L), np.float64)
    ell_cols[rows_local, slot] = lc
    ell_vals[rows_local, slot] = np.asarray(vals, np.float64)
    return ell_cols, ell_vals
