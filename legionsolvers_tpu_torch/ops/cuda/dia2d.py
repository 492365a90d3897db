"""Explicit-DIA SpMV (K8): wrapper, plain version, gate.

Port of ``legionsolvers_tpu/ops/pallas/dia2d.py``.  An explicit matrix with
few diagonals is stored as per-diagonal coefficient grids ``diags`` [D, R,
C] over the [R, C] view of its vectors (``parallel/dia_op.py``), and

    y = sum_k diags[k] * shift(x, dy_k, dx_k)     (optionally <x, y>)

is a variable-coefficient stencil.  :func:`dia2d_matvec` launches the
hand-written CUDA kernel of ``csrc/dia2d.cu`` on CUDA tensors and runs
:func:`dia2d_plain` on CPU tensors; it never falls back.  Every CUDA launch
adds one to :data:`~.stencil2d.LAUNCHES` under ``dia2d`` or ``dia2d_dot``.

Rows outside ``[0, R)`` come from the optional ``[8, C]`` halo blocks (real
rows last in the top block, first in the bottom one; ``None`` = zeros);
columns outside ``[0, C)`` read zero.  f32 only: an f64 DIA operator takes
the linearized torch path, as the JAX package routes it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .stencil2d import (
    HALO_ROWS,
    _check_grid,
    _check_halo,
    _int32_table,
    _launch,
    _on_cuda,
    _ptr,
)

MAX_DIA_TERMS = 512  # twice the planner's 256 diagonals (csrc: LS_DIA_MAX_TERMS)
DIA_ELEMS = 4        # elements per thread (csrc: LS_DIA_ELEMS)
_BLOCK = 256 * DIA_ELEMS


def supports_dia(R: int, C: int, offsets, n_diags: int = 0,
                 itemsize: int = 4) -> bool:
    """Whether K8 takes this geometry: f32, 1..512 terms, |dy| <= 8 (the
    halo blocks), |dx| < C and fewer than 2^31 elements.  JAX's tile and
    VMEM limits do not apply on the card."""
    if itemsize != 4 or R < 1 or C < 1 or R * C >= 2**31:
        return False
    if not offsets or len(offsets) > MAX_DIA_TERMS:
        return False
    return all(abs(dy) <= HALO_ROWS and abs(dx) < C for dy, dx in offsets)


def dia2d_plain(x, halo_top, halo_bot, diags, *, offsets,
                with_dot: bool = False):
    """K8 in PyTorch: terms summed in offset order, the dot in f32."""
    R, C = x.shape
    P = HALO_ROWS
    m = max(abs(dx) for _, dx in offsets)
    z = x.new_zeros(P, C)
    ext = torch.cat([z if halo_top is None else halo_top, x,
                     z if halo_bot is None else halo_bot])
    ext = F.pad(ext, (m, m))
    acc = None
    for k, (dy, dx) in enumerate(offsets):
        term = diags[k] * ext[P + dy: P + dy + R, m + dx: m + dx + C]
        acc = term if acc is None else acc + term
    if with_dot:
        return acc, torch.sum(x * acc, dtype=torch.float32)
    return acc


def dia2d_matvec(x, halo_top, halo_bot, diags, *, offsets,
                 with_dot: bool = False):
    """y = A @ x (and ``<x, y>`` with ``with_dot``) for ``diags[k, r, c]``
    multiplying ``x[r + dy_k, c + dx_k]``."""
    offsets = tuple((int(dy), int(dx)) for dy, dx in offsets)
    _check_grid("x", x)
    R, C = x.shape
    if not supports_dia(R, C, offsets):
        raise ValueError(f"unsupported DIA geometry R={R} C={C}")
    _check_grid("diags", diags, (len(offsets), R, C), ndim=3)
    _check_halo("halo_top", halo_top, C)
    _check_halo("halo_bot", halo_bot, C)
    if not _on_cuda(x, halo_top, halo_bot, diags):
        return dia2d_plain(x, halo_top, halo_bot, diags, offsets=offsets,
                           with_dot=with_dot)
    dev = x.device
    y = torch.empty_like(x)
    dot = partials = None
    if with_dot:
        dot = torch.empty(1, dtype=torch.float32, device=dev)
        partials = torch.empty(-(-R * C // _BLOCK), dtype=torch.float32,
                               device=dev)
    _launch("dia2d_dot" if with_dot else "dia2d", "ls_dia2d", (
        int(with_dot), _ptr(x), _ptr(halo_top), _ptr(halo_bot), _ptr(diags),
        _ptr(_int32_table(tuple(dy for dy, _ in offsets)
                          + tuple(dx for _, dx in offsets), dev)),
        len(offsets), _ptr(y), _ptr(dot),
        _ptr(partials), R, C,
    ), dev)
    return (y, dot[0]) if with_dot else y
