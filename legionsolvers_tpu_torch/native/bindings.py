"""DIA extraction and RCM ordering on the host.

Port of the numpy/scipy paths of ``legionsolvers_tpu/native/bindings.py``
(``dia_unique_offsets``, ``dia_accumulate``, ``rcm_permutation``).  The JAX
package prefers a C++ library and falls back to these; the port has no
C++ host code.  Duplicate (row, col) entries are summed, as COO semantics
require (reference: COOMatrixTasks.cpp:38-39).
"""

from __future__ import annotations

import numpy as np

_DIA_CHUNK = 1 << 24  # nnz per pass of the offset scan


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
