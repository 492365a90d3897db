"""Global (single-device) sparse matrix-vector products in torch.

Port of ``legionsolvers_tpu/ops/spmv.py`` (reference: COOMatrixTasks.cpp,
CSRMatrixTasks.cpp).  The JAX package does these in XLA, not Pallas, so
plain torch ops are their counterpart here.  Padded nonzeros must carry
``vals == 0`` (their row/col may be any in-bounds slot).
"""

from __future__ import annotations

import torch


def spmv_coo(rows, cols, vals, x, n_range: int) -> torch.Tensor:
    """y = A @ x for COO (reference: COOMatrixTasks.cpp:67-74:
    ``out[row[k]] <<= entry[k] * in[col[k]]``)."""
    y = torch.zeros(n_range, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, vals * x[cols])


def spmv_coo_add(rows, cols, vals, x, y) -> torch.Tensor:
    """y + A @ x for COO, as a new tensor (``y`` is not changed): the
    accumulate form of the planner's multi-operator matvec."""
    return y.index_add(0, rows, vals * x[cols])


def rmatvec_coo(rows, cols, vals, x, n_domain: int) -> torch.Tensor:
    """y = A^T @ x for COO (the reference stubs it: COOMatrixTasks.cpp:78-83)."""
    y = torch.zeros(n_domain, dtype=x.dtype, device=x.device)
    return y.index_add_(0, cols, vals * x[rows])


def spmv_ell(ell_cols, ell_vals, x) -> torch.Tensor:
    """y = A @ x for ELL: ``ell_cols``/``ell_vals`` are [n_rows, L] with
    padded slots carrying ``vals == 0`` and any in-bounds column."""
    return torch.sum(ell_vals * x[ell_cols], dim=1)


def spmv_dia(offsets, diags, x) -> torch.Tensor:
    """y = A @ x for DIA storage: ``offsets`` a sequence of diagonal
    offsets, ``diags`` [n_diags, n] with ``diags[k, i] = A[i, i +
    offsets[k]]`` (zero where out of range).  Diagonals are added in
    offset order."""
    n = x.shape[0]
    y = torch.zeros_like(x)
    for k, off in enumerate(offsets):
        off = int(off)
        if off == 0:
            y = y + diags[k] * x
        elif off > 0:
            y[: n - off] += diags[k, : n - off] * x[off:]
        else:
            y[-off:] += diags[k, -off:] * x[: n + off]
    return y
