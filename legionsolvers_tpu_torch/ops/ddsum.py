"""Compensated reductions for the solver dots.

Port of ``legionsolvers_tpu/ops/ddsum.py``.  At large n a dot such as
rho = <r~, r> cancels catastrophically: its true value falls below the f32
rounding noise of its terms within a few BiCGStab iterations, so a plain
f32 sum makes the trajectory depend on the order of summation.  The TPU has
no f64, so the JAX package carries such sums as two-float (hi, lo) pairs
built from error-free transformations.

The H100 has native f64.  :func:`dd_dot` therefore forms each f32 x f32
product exactly in float64 (a product of two 24-bit significands needs 48
bits, float64 has 53), sums the products in float64 and rounds the sum to
f32 once.  That is at least as accurate as the JAX hi + lo pair, whose
accumulation carries about 49 significand bits.  The fused BiCGStab
kernels do the same on the card (``csrc/bicgstab2d.cu``).

The error-free transformations themselves are kept as plain tensor
functions with the JAX names, for callers that want the f32 pair:

* :func:`two_sum`: s + e == a + b exactly (Knuth);
* :func:`two_prod`: p + e == a * b exactly for f32 inputs (Dekker split;
  each torch operation rounds on its own, so no fused multiply-add turns
  the error term into zero);
* :func:`dd_add`: double-float addition of (hi, lo) pairs.
"""

from __future__ import annotations

import torch

_SPLITTER = 4097.0  # 2^12 + 1 for f32 (Dekker): splits 24-bit significands


def two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e) with p = fl(a * b) and p + e == a * b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(xh, xl, yh, yl):
    """Double-float addition: (xh, xl) + (yh, yl) -> (hi, lo)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return two_sum(s, e)


def dd_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Compensated <x, y> of arrays of any shape, as a 0-dim float32 tensor
    on their device: the exact products of the f32 values, summed in
    float64, rounded once."""
    x = x.reshape(-1).to(torch.float32).to(torch.float64)
    y = y.reshape(-1).to(torch.float32).to(torch.float64)
    return torch.dot(x, y).to(torch.float32)
