"""Device-memory copy probe (K12): wrapper and plain version.

Port of ``pallas_copy_bw``'s kernel in ``scripts/probe_roofline.py``: o =
x + 1.0 over a float32 array, 8 B per element.  :func:`copy_probe`
launches the hand-written CUDA kernel of ``csrc/copy_probe.cu`` on CUDA
tensors and runs :func:`copy_plain` on CPU tensors; it never falls back.
The array is split by :func:`copy_split`: a body of whole 16-byte vectors
when both pointers are 16-byte aligned, which takes a float4 kernel, and
the rest, which takes a scalar kernel.  Every CUDA launch adds one to
:data:`~.stencil2d.LAUNCHES` under ``copy_probe``.  The kernels round the
add as the plain version does: the two match bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch

from .stencil2d import _launch, _on_cuda, _ptr


def copy_split(x_addr: int, out_addr: int, n: int) -> int:
    """End of the body: the elements [0, body) go to the float4 kernel,
    [body, n) to the scalar one.  body is n rounded down to whole
    16-byte vectors when both addresses are 16-byte aligned, else 0."""
    if x_addr % 16 or out_addr % 16:
        return 0
    return n - n % 4


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
    n = x.numel()
    body = copy_split(x.data_ptr(), out.data_ptr(), n)
    _launch("copy_probe", "ls_copy_probe", (_ptr(x), _ptr(out), body, n),
            x.device)
    return out
