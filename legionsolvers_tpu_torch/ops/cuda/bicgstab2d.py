"""Fused BiCGStab passes on 2-D grid stencils: wrappers, plain versions, gate.

Port of ``legionsolvers_tpu/ops/pallas/bicgstab2d.py``.  One BiCGStab
iteration needs two global reductions (alpha needs <r~, A p>, omega needs
<t, s> and <t, t>), so it runs as three passes, each a hand-written CUDA
kernel in ``csrc/bicgstab2d.cu`` with a plain PyTorch version here:

===========  ===============================================  ==================
wrapper      computes                                         plain version
===========  ===============================================  ==================
bicg_pv      p' = r + beta (p - omega v), v' = A p', <r~,v'>  bicg_pv_plain
bicg_st      s = r - alpha v, t = A s: <t, s>, <t, t>         bicg_st_plain
bicg_update  x' = x + alpha p + omega s, r' = s - omega t:    bicg_update_plain
             <r', r'>, <r~, r'>
===========  ===============================================  ==================

They move 24, 8 and 28 bytes per element: 60 B per unknown per iteration.
Each pass applies A once, to an operand that is zero outside the grid; s
and t never reach device memory.  ``compensated`` sums the dots from exact
f32 products in float64 and rounds once (see ``ops/ddsum.py``).

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches its kernel or raises; it never falls back.  Every CUDA launch adds
one to :data:`~.stencil2d.LAUNCHES` under ``bicg_pv``, ``bicg_st`` or
``bicg_update``.

Buffers differ from the JAX aliasing contract.  JAX writes p' and v' over p
and v, and r' over r, which is safe only on its sequential grid.  CUDA
blocks run in no order, and a block overwriting p, v or r would race a
neighbour reading its halo, so p' and v' go to ``out`` (a pair) and r' to
``out`` (one buffer), fresh buffers when ``None``.  x is updated in place:
x, p and r~ are read only at each element's own position.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..ddsum import dd_dot
from .stencil2d import (
    _blocks,
    _check_distinct,
    _check_grid,
    _dev_scalars,
    _dot,
    _launch,
    _on_cuda,
    _ptr,
    _stencil_struct,
    apply_plain,
    supports,
)


def bicgstab_supported(R: int, C: int, offsets, itemsize: int = 4) -> bool:
    """Whether the K5 kernels take this geometry: f32, any R, C >= 1, at
    most 32 terms of reach <= 8 (the tile's halo).  The TPU's lane and
    row-tile gates do not apply."""
    return itemsize == 4 and supports(R, C, offsets)


# ===========================================================================
# plain PyTorch versions
# ===========================================================================

def _coef(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32).to(like.dtype)


def _pdot(a, b, compensated: bool):
    return dd_dot(a, b) if compensated else _dot(a, b)


# The pass arithmetic, for any stencil application ``A`` (the 2-D plain
# versions here, the 3-D ones in bicgstab3d.py).

def pv_math(A, r, p, v, rt, beta, omega, compensated, out):
    b, om = _coef(beta, r), _coef(omega, r)
    pn = r + b * (p - om * v)
    vn = A(pn)
    if out is not None:
        pn, vn = out[0].copy_(pn), out[1].copy_(vn)
    return pn, vn, _pdot(rt, vn, compensated)


def st_math(A, r, v, alpha, compensated):
    s = r - _coef(alpha, r) * v
    t = A(s)
    return _pdot(t, s, compensated), _pdot(t, t, compensated)


def update_math(A, r, v, x, p, rt, alpha, omega, compensated, out):
    al, om = _coef(alpha, r), _coef(omega, r)
    s = r - al * v
    t = A(s)
    x.copy_(x + al * p + om * s)
    rn = s - om * t
    if out is not None:
        rn = out.copy_(rn)
    return x, rn, _pdot(rn, rn, compensated), _pdot(rt, rn, compensated)


def bicg_pv_plain(r, p, v, rt, beta, omega, *, offsets, values,
                  compensated: bool = False, out=None):
    """K5a: (p', v', <r~, v'>) with p' = r + beta (p - omega v), v' = A p'."""
    A = lambda a: apply_plain(a, offsets, values)
    return pv_math(A, r, p, v, rt, beta, omega, compensated, out)


def bicg_st_plain(r, v, alpha, *, offsets, values,
                  compensated: bool = False):
    """K5b: (<t, s>, <t, t>) with s = r - alpha v, t = A s."""
    A = lambda a: apply_plain(a, offsets, values)
    return st_math(A, r, v, alpha, compensated)


def bicg_update_plain(r, v, x, p, rt, alpha, omega, *, offsets, values,
                      compensated: bool = False, out=None):
    """K5c: (x', r', <r', r'>, <r~, r'>) with s = r - alpha v, t = A s,
    x' = x + alpha p + omega s (written into x), r' = s - omega t."""
    A = lambda a: apply_plain(a, offsets, values)
    return update_math(A, r, v, x, p, rt, alpha, omega, compensated, out)


# ===========================================================================
# wrappers
# ===========================================================================

def _check(R, C, offsets, **grids):
    if not bicgstab_supported(R, C, offsets):
        raise ValueError(f"unsupported stencil geometry R={R} C={C}")
    for name, t in grids.items():
        _check_grid(name, t, (R, C))


def _scratch(R, C, k, device):
    """Per-tile partial dots: k doubles per tile (the float path uses the
    first half of the bytes)."""
    return torch.empty(k * _blocks(R, C), dtype=torch.float64, device=device)


def bicg_pv(r, p, v, rt, beta, omega, *, offsets, values,
            compensated: bool = False,
            out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(p', v' = A p', <r~, v'>) with p' = r + beta (p - omega v).  p' and v'
    go to ``out`` (fresh buffers when ``None``), which may not share
    storage with r, p, v or r~."""
    R, C = r.shape
    _check(R, C, offsets, r=r, p=p, v=v, rt=rt)
    if out is not None:
        _check(R, C, offsets, p_out=out[0], v_out=out[1])
        _check_distinct(("r", r), ("p", p), ("v", v), ("rt", rt),
                        ("p_out", out[0]), ("v_out", out[1]))
    if not _on_cuda(r, p, v, rt, *(out or ())):
        return bicg_pv_plain(r, p, v, rt, beta, omega, offsets=offsets,
                             values=values, compensated=compensated, out=out)
    dev = r.device
    if out is None:
        out = (torch.empty_like(p), torch.empty_like(v))
    b, om = _dev_scalars(beta, 1, dev), _dev_scalars(omega, 1, dev)
    dot = torch.empty(1, dtype=torch.float32, device=dev)
    st = _stencil_struct(offsets, values)
    _launch("bicg_pv", "ls_bicg_pv", (
        _ptr(r), _ptr(p), _ptr(v), _ptr(rt), _ptr(b), _ptr(om),
        _ptr(out[0]), _ptr(out[1]), _ptr(dot),
        _ptr(_scratch(R, C, 1, dev)), R, C, int(compensated),
        ctypes.byref(st),
    ), dev)
    return out[0], out[1], dot[0]


def bicg_st(r, v, alpha, *, offsets, values, compensated: bool = False):
    """(<t, s>, <t, t>) with s = r - alpha v and t = A s formed on chip
    only."""
    R, C = r.shape
    _check(R, C, offsets, r=r, v=v)
    if not _on_cuda(r, v):
        return bicg_st_plain(r, v, alpha, offsets=offsets, values=values,
                             compensated=compensated)
    dev = r.device
    al = _dev_scalars(alpha, 1, dev)
    dot = torch.empty(2, dtype=torch.float32, device=dev)
    st = _stencil_struct(offsets, values)
    _launch("bicg_st", "ls_bicg_st", (
        _ptr(r), _ptr(v), _ptr(al), _ptr(dot), _ptr(_scratch(R, C, 2, dev)),
        R, C, int(compensated), ctypes.byref(st),
    ), dev)
    return dot[0], dot[1]


def bicg_update(r, v, x, p, rt, alpha, omega, *, offsets, values,
                compensated: bool = False,
                out: Optional[torch.Tensor] = None):
    """(x', r', <r', r'>, <r~, r'>): s = r - alpha v and t = A s formed on
    chip only, x' = x + alpha p + omega s written into x, r' = s - omega t
    written to ``out`` (a fresh buffer when ``None``).  None of r, v, x, p,
    r~ and ``out`` may share storage."""
    R, C = r.shape
    _check(R, C, offsets, r=r, v=v, x=x, p=p, rt=rt)
    named = [("r", r), ("v", v), ("x", x), ("p", p), ("rt", rt)]
    if out is not None:
        _check(R, C, offsets, r_out=out)
        named.append(("r_out", out))
    _check_distinct(*named)
    if not _on_cuda(r, v, x, p, rt, out):
        return bicg_update_plain(r, v, x, p, rt, alpha, omega,
                                 offsets=offsets, values=values,
                                 compensated=compensated, out=out)
    dev = r.device
    if out is None:
        out = torch.empty_like(r)
    al, om = _dev_scalars(alpha, 1, dev), _dev_scalars(omega, 1, dev)
    dot = torch.empty(2, dtype=torch.float32, device=dev)
    st = _stencil_struct(offsets, values)
    _launch("bicg_update", "ls_bicg_update", (
        _ptr(r), _ptr(v), _ptr(x), _ptr(p), _ptr(rt), _ptr(al), _ptr(om),
        _ptr(out), _ptr(dot), _ptr(_scratch(R, C, 2, dev)), R, C,
        int(compensated), ctypes.byref(st),
    ), dev)
    return x, out, dot[0], dot[1]
