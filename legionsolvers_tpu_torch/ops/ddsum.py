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
* :func:`dd_add`: double-float addition of (hi, lo) pairs;
* :func:`dd_sum_2d` and :func:`dd_dot_tile`: the JAX package's in-kernel
  reductions of a 2-D tile to one (hi, lo) pair, in the same fold order.
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


def _dd_reduce_axis0(h, l):
    """Fold axis 0 of (hi, lo) arrays to length 1 by repeated halving, the
    odd row folded into the first."""
    while h.shape[0] > 1:
        m = h.shape[0] // 2
        hh, ll = dd_add(h[:m], l[:m], h[m: 2 * m], l[m: 2 * m])
        if h.shape[0] % 2:
            hh0, ll0 = dd_add(hh[:1], ll[:1], h[-1:], l[-1:])
            hh = torch.cat([hh0, hh[1:]], 0)
            ll = torch.cat([ll0, ll[1:]], 0)
        h, l = hh, ll
    return h, l


def dd_sum_2d(h, l):
    """Reduce (hi, lo) arrays of shape [R, C] to 0-dim (hi, lo): columns
    fold first in chunks of 128 (when C is a larger multiple of 128), then
    rows by halving, then the remaining columns by halving."""
    R, C = h.shape
    if C % 128 == 0 and C > 128:
        hh, ll = h[:, :128], l[:, :128]
        for k in range(1, C // 128):
            hh, ll = dd_add(hh, ll, h[:, 128 * k: 128 * (k + 1)],
                            l[:, 128 * k: 128 * (k + 1)])
        h, l, C = hh, ll, 128
    h, l = _dd_reduce_axis0(h, l)
    w = C
    while w > 1:
        m = w // 2
        nh, nl = dd_add(h[:, :m], l[:, :m], h[:, m: 2 * m], l[:, m: 2 * m])
        if w % 2:
            th, tl = dd_add(nh[:, :1], nl[:, :1], h[:, -1:], l[:, -1:])
            nh = torch.cat([th, nh[:, 1:]], 1)
            nl = torch.cat([tl, nl[:, 1:]], 1)
        h, l, w = nh, nl, m
    return h[0, 0], l[0, 0]


def dd_dot_tile(a, b):
    """Compensated <a, b> over a 2-D tile as an f32 (hi, lo) pair: exact
    products (:func:`two_prod`) accumulated into an 8-row (hi, lo) array
    (one row when R is not a multiple of 8), then :func:`dd_sum_2d`."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    R = a.shape[0]
    step = 8 if R % 8 == 0 else 1
    hi = torch.zeros((step,) + tuple(a.shape[1:]), dtype=torch.float32,
                     device=a.device)
    lo = torch.zeros_like(hi)
    for k in range(R // step):
        p, e = two_prod(a[k * step: (k + 1) * step],
                        b[k * step: (k + 1) * step])
        hi, lo = dd_add(hi, lo, p, e)
    return dd_sum_2d(hi, lo)


def dd_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Compensated <x, y> of arrays of any shape, as a 0-dim float32 tensor
    on their device: the exact products of the f32 values, summed in
    float64, rounded once."""
    x = x.reshape(-1).to(torch.float32).to(torch.float64)
    y = y.reshape(-1).to(torch.float32).to(torch.float64)
    return torch.dot(x, y).to(torch.float32)
