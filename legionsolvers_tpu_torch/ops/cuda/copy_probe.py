"""Device-memory copy probe (K12): wrapper and plain version.

Port of ``pallas_copy_bw``'s kernel in ``scripts/probe_roofline.py``: o =
x + 1.0 over a float32 array, 8 B per element.  :func:`copy_probe`
launches the hand-written CUDA kernel of ``csrc/copy_probe.cu`` on CUDA
tensors and runs :func:`copy_plain` on CPU tensors; it never falls back.
Every CUDA launch adds one to :data:`~.stencil2d.LAUNCHES` under
``copy_probe``.  The kernel rounds the add as the plain version does: the
two match bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .stencil2d import _launch, _on_cuda, _ptr


def copy_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None):
    """K12 in PyTorch."""
    if out is None:
        return x + 1.0
    return torch.add(x, 1.0, out=out)


def copy_probe(x: torch.Tensor, out: Optional[torch.Tensor] = None):
    """o = x + 1 for a contiguous float32 ``x``, written to ``out`` (a
    fresh tensor when ``None``; otherwise of x's shape and not x)."""
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise TypeError("x: expected a contiguous float32 tensor")
    if out is None:
        out = torch.empty_like(x)
    if (out.dtype != torch.float32 or not out.is_contiguous()
            or out.shape != x.shape):
        raise ValueError("out: expected a contiguous float32 tensor of x's "
                         "shape")
    if out.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        raise ValueError("out must not share storage with x")
    if not _on_cuda(x, out):
        return copy_plain(x, out)
    _launch("copy_probe", "ls_copy_probe", (_ptr(x), _ptr(out), x.numel()),
            x.device)
    return out
