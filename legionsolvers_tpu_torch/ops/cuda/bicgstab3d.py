"""Fused BiCGStab passes on 3-D grid stencils: wrappers, plain versions, gate.

Port of ``legionsolvers_tpu/ops/pallas/bicgstab3d.py``: the three passes of
``bicgstab2d.py`` over the ``[X, Y, Z]`` volume, each a hand-written CUDA
kernel in ``csrc/bicgstab3d.cu`` (K7) with a plain PyTorch version here:

=============  ===============================================  ====================
wrapper        computes                                         plain version
=============  ===============================================  ====================
bicg3d_pv      p' = r + beta (p - omega v), v' = A p', <r~,v'>  bicg3d_pv_plain
bicg3d_st      s = r - alpha v, t = A s: <t, s>, <t, t>         bicg3d_st_plain
bicg3d_update  x' = x + alpha p + omega s, r' = s - omega t:    bicg3d_update_plain
               <r', r'>, <r~, r'>
=============  ===============================================  ====================

They move 24, 8 and 28 bytes per element.  The halo planes (``[Y, Z]``,
``None`` for zeros) are the combined operand's own: p' for pv, s for st
and update, as in the JAX passes.  ``compensated`` sums the dots from exact
f32 products in float64 and rounds once.

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches its kernel or raises.  With a reach-1 stencil each pass runs the
register march of K6a (``march1`` in ``csrc/common.cuh``), but update with
``compensated`` dots, which runs ``march3d`` (``ls_bicg3d_update`` says
why) and a second launch summing its partial dots.  With reach 2..8 or a
z shift past 8 (up to 128), each pass runs the window march of K6a and
K6b, whose window holds every z shift a term reads.  march1 and the window
march fold the dots into the last block: one launch.
:func:`~.stencil3d.route3d` gives each pass's march.  All take their scratch
(partials, capacity, the last block's counter) from
:func:`~.stencil3d.march_scratch`.  Every CUDA launch adds one to
:data:`~.stencil2d.LAUNCHES` under ``bicg3d_pv``, ``bicg3d_st`` or
``bicg3d_update``.  Buffers as in ``bicgstab2d.py``: p' and v' go to
``out`` (a pair) and r' to ``out`` (one buffer), fresh buffers when
``None``, never over the p, v and r that neighbouring blocks read through
their windows; x is updated in place.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .bicgstab2d import pv_math, st_math, update_math
from .stencil2d import _check_distinct, _dev_scalars, _launch, _on_cuda, _ptr
from .stencil3d import (
    _stencil3_struct,
    apply_planes_plain,
    check_planes,
    check_volume,
    march_scratch,
    supports3d,
)


def supports3d_bicgstab(X: int, Y: int, Z: int, offsets,
                        itemsize: int = 4) -> bool:
    """Whether the K7 kernels take this geometry: f32 and K6's gate."""
    return itemsize == 4 and supports3d(X, Y, Z, offsets)


# ===========================================================================
# plain PyTorch versions
# ===========================================================================

def _apply(offsets, values, top, bot):
    return lambda a: apply_planes_plain(a, offsets, values, top, bot)


def bicg3d_pv_plain(r, p, v, rt, beta, omega, pn_top=None, pn_bot=None, *,
                    offsets, values, compensated: bool = False, out=None):
    """K7 pv: (p', v', <r~, v'>) with p' = r + beta (p - omega v),
    v' = A p'."""
    return pv_math(_apply(offsets, values, pn_top, pn_bot), r, p, v, rt,
                   beta, omega, compensated, out)


def bicg3d_st_plain(r, v, alpha, s_top=None, s_bot=None, *, offsets, values,
                    compensated: bool = False):
    """K7 st: (<t, s>, <t, t>) with s = r - alpha v, t = A s."""
    return st_math(_apply(offsets, values, s_top, s_bot), r, v, alpha,
                   compensated)


def bicg3d_update_plain(r, v, x, p, rt, alpha, omega, s_top=None,
                        s_bot=None, *, offsets, values,
                        compensated: bool = False, out=None):
    """K7 update: (x', r', <r', r'>, <r~, r'>) with s = r - alpha v,
    t = A s, x' = x + alpha p + omega s (written into x), r' = s - omega t."""
    return update_math(_apply(offsets, values, s_top, s_bot), r, v, x, p, rt,
                       alpha, omega, compensated, out)


# ===========================================================================
# wrappers
# ===========================================================================

def _check(r, offsets, planes, **vols):
    check_volume("r", r)
    X, Y, Z = r.shape
    check_planes(X, Y, Z, offsets, **planes)
    for name, t in vols.items():
        check_volume(name, t, (X, Y, Z))
    return X, Y, Z


def bicg3d_pv(r, p, v, rt, beta, omega, pn_top=None, pn_bot=None, *,
              offsets, values, compensated: bool = False,
              out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """(p', v' = A p', <r~, v'>) with p' = r + beta (p - omega v).  p' and v'
    go to ``out`` (fresh buffers when ``None``), which may not share
    storage with r, p, v or r~."""
    planes = dict(pn_top=pn_top, pn_bot=pn_bot)
    X, Y, Z = _check(r, offsets, planes, p=p, v=v, rt=rt)
    if out is not None:
        _check(r, offsets, {}, p_out=out[0], v_out=out[1])
        _check_distinct(("r", r), ("p", p), ("v", v), ("rt", rt),
                        ("p_out", out[0]), ("v_out", out[1]))
    if not _on_cuda(r, p, v, rt, pn_top, pn_bot, *(out or ())):
        return bicg3d_pv_plain(r, p, v, rt, beta, omega, pn_top, pn_bot,
                               offsets=offsets, values=values,
                               compensated=compensated, out=out)
    dev = r.device
    if out is None:
        out = (torch.empty_like(p), torch.empty_like(v))
    b, om = _dev_scalars(beta, 1, dev), _dev_scalars(omega, 1, dev)
    dot = torch.empty(1, dtype=torch.float32, device=dev)
    partials, capacity, counter = march_scratch(dev, X, Y, Z)
    st = _stencil3_struct(offsets, values)
    _launch("bicg3d_pv", "ls_bicg3d_pv", (
        _ptr(r), _ptr(p), _ptr(v), _ptr(rt), _ptr(b), _ptr(om),
        _ptr(pn_top), _ptr(pn_bot), _ptr(out[0]), _ptr(out[1]), _ptr(dot),
        _ptr(partials), capacity, _ptr(counter), X, Y, Z, int(compensated),
        ctypes.byref(st),
    ), dev)
    return out[0], out[1], dot[0]


def bicg3d_st(r, v, alpha, s_top=None, s_bot=None, *, offsets, values,
              compensated: bool = False):
    """(<t, s>, <t, t>) with s = r - alpha v and t = A s formed on chip
    only."""
    X, Y, Z = _check(r, offsets, dict(s_top=s_top, s_bot=s_bot), v=v)
    if not _on_cuda(r, v, s_top, s_bot):
        return bicg3d_st_plain(r, v, alpha, s_top, s_bot, offsets=offsets,
                               values=values, compensated=compensated)
    dev = r.device
    al = _dev_scalars(alpha, 1, dev)
    dot = torch.empty(2, dtype=torch.float32, device=dev)
    partials, capacity, counter = march_scratch(dev, X, Y, Z)
    st = _stencil3_struct(offsets, values)
    _launch("bicg3d_st", "ls_bicg3d_st", (
        _ptr(r), _ptr(v), _ptr(al), _ptr(s_top), _ptr(s_bot), _ptr(dot),
        _ptr(partials), capacity, _ptr(counter), X, Y, Z, int(compensated),
        ctypes.byref(st),
    ), dev)
    return dot[0], dot[1]


def bicg3d_update(r, v, x, p, rt, alpha, omega, s_top=None, s_bot=None, *,
                  offsets, values, compensated: bool = False,
                  out: Optional[torch.Tensor] = None):
    """(x', r', <r', r'>, <r~, r'>): s = r - alpha v and t = A s formed on
    chip only, x' = x + alpha p + omega s written into x, r' = s - omega t
    written to ``out`` (a fresh buffer when ``None``).  None of r, v, x, p,
    r~ and ``out`` may share storage."""
    planes = dict(s_top=s_top, s_bot=s_bot)
    X, Y, Z = _check(r, offsets, planes, v=v, x=x, p=p, rt=rt)
    named = [("r", r), ("v", v), ("x", x), ("p", p), ("rt", rt)]
    if out is not None:
        _check(r, offsets, {}, r_out=out)
        named.append(("r_out", out))
    _check_distinct(*named)
    if not _on_cuda(r, v, x, p, rt, s_top, s_bot, out):
        return bicg3d_update_plain(r, v, x, p, rt, alpha, omega, s_top,
                                   s_bot, offsets=offsets, values=values,
                                   compensated=compensated, out=out)
    dev = r.device
    if out is None:
        out = torch.empty_like(r)
    al, om = _dev_scalars(alpha, 1, dev), _dev_scalars(omega, 1, dev)
    dot = torch.empty(2, dtype=torch.float32, device=dev)
    partials, capacity, counter = march_scratch(dev, X, Y, Z)
    st = _stencil3_struct(offsets, values)
    _launch("bicg3d_update", "ls_bicg3d_update", (
        _ptr(r), _ptr(v), _ptr(x), _ptr(p), _ptr(rt), _ptr(al), _ptr(om),
        _ptr(s_top), _ptr(s_bot), _ptr(out), _ptr(dot), _ptr(partials),
        capacity, _ptr(counter), X, Y, Z, int(compensated),
        ctypes.byref(st),
    ), dev)
    return x, out, dot[0], dot[1]
