"""Windowed-ELL SpMV (K9): wrapper and plain version.

Port of ``legionsolvers_tpu/ops/pallas/winell.py``.  A matrix packed by
``parallel/winell_op.plan_winell`` is applied as

    y[t, r] = sum_s vals[t, s, r] * x[wstart[t, s] * 128 + cols[t, s, r]]

over tiles of ``Rt * 128`` rows.  :func:`winell_spmv` launches the
hand-written CUDA kernel of ``csrc/winell.cu`` (float or double) on CUDA
tensors and runs :func:`winell_plain` on CPU tensors; it never falls back.
Every CUDA launch adds one to :data:`~.stencil2d.LAUNCHES` under
``winell``.
"""

from __future__ import annotations

import torch

from .stencil2d import _launch, _on_cuda, _ptr

# window depth cap, in rows of 128 (the JAX kernel's chunk-sweep cap; the
# host planner keeps it so that both packages pick the same operator)
MAX_WINDOW_ROWS = 64


def _check(name, t, dtype, shape=None, ndim=None):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got "
                         f"{tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def winell_plain(x2d, wstart, cols, vals, *, window_rows: int):
    """K9 in PyTorch: slots summed in slot order, as the kernels sum them."""
    nt, L, Rt, _ = cols.shape
    base = wstart[:nt].to(torch.int64) * 128
    g = x2d.reshape(-1)[base[:, :, None, None] + cols.to(torch.int64)]
    acc = torch.zeros((nt, Rt, 128), dtype=x2d.dtype, device=x2d.device)
    for s in range(L):
        acc = acc + vals[:, s] * g[:, s]
    return acc.reshape(nt * Rt, 128)


def winell_spmv(x2d, wstart, cols, vals, *, window_rows: int):
    """y = A @ x with A in the per-tile windowed-ELL layout: ``x2d`` [NR,
    128], ``wstart`` [ntp >= nt, L] int32, ``cols`` [nt, L, Rt, 128] int32,
    ``vals`` like ``cols`` in x's dtype.  Returns ``[nt * Rt, 128]``."""
    if x2d.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"x2d: expected float32 or float64, got {x2d.dtype}")
    _check("x2d", x2d, x2d.dtype, ndim=2)
    if x2d.shape[1] != 128:
        raise ValueError(f"x2d: expected [NR, 128], got {tuple(x2d.shape)}")
    _check("cols", cols, torch.int32, ndim=4)
    nt, L, Rt, lanes = cols.shape
    if lanes != 128:
        raise ValueError(f"cols: expected [nt, L, Rt, 128], got "
                         f"{tuple(cols.shape)}")
    _check("vals", vals, x2d.dtype, cols.shape)
    _check("wstart", wstart, torch.int32, ndim=2)
    if wstart.shape[0] < nt or wstart.shape[1] != L:
        raise ValueError(f"wstart: shape {tuple(wstart.shape)} does not "
                         f"cover [{nt}, {L}]")
    KR = int(window_rows)
    if KR <= 0 or KR % 8 or KR > MAX_WINDOW_ROWS or KR > x2d.shape[0]:
        raise ValueError(f"unsupported window_rows={KR}")
    if not _on_cuda(x2d, wstart, cols, vals):
        return winell_plain(x2d, wstart, cols, vals, window_rows=KR)
    dev = x2d.device
    y = torch.empty((nt * Rt, 128), dtype=x2d.dtype, device=dev)
    _launch("winell", "ls_winell", (
        int(x2d.dtype == torch.float64), _ptr(x2d), _ptr(wstart), _ptr(cols),
        _ptr(vals), _ptr(y), nt, L, Rt,
    ), dev)
    return y
