"""Benchmark timing harness.

Port of ``legionsolvers_tpu/utils/timing.py`` (reference:
BenchmarkStencil.cpp:225-259, fence-bracketed timing with warm-up runs
excluded).  Measurements are marginal: a short and a long run of the same
loop, each timed on the host clock around work that ends in
``torch.cuda.synchronize()``, and the difference divided by the extra
iterations, so fixed costs (launch, synchronisation) cancel.

Unlike the JAX harness, :func:`marginal_seconds_per_iter` never floors a
non-positive difference to a tiny positive time (the fault that produced an
impossible 0.000 ms/iter bench): it widens the window once and then
raises.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

from ..options import resolve_device

#: How much longer the widened window's long run is than the first one's,
#: in extra iterations over ``long - short``.
WIDEN = 4


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_call(f: Callable, *args, reps: int = 7) -> float:
    """Best-of-``reps`` wall seconds of ``f(*args)``, each call ended by a
    device synchronisation."""
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        f(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best


def marginal_seconds_per_iter(run: Callable[[int], object], short: int,
                              long: int, reps: int = 7) -> float:
    """Marginal wall seconds per iteration of ``run(num_iters)``, warmed up
    by the caller.  A long run no slower than the short one is measured
    again over a window ``WIDEN`` times wider; if it still is, this raises
    instead of returning a time the loop cannot have taken."""
    if long <= short:
        raise ValueError(f"long ({long}) must exceed short ({short})")
    t_short = time_call(run, short, reps=reps)
    t_long = time_call(run, long, reps=reps)
    if t_long <= t_short:
        long = long + WIDEN * (long - short)
        t_short = time_call(run, short, reps=reps)
        t_long = time_call(run, long, reps=reps)
        if t_long <= t_short:
            raise RuntimeError(
                f"marginal timing failed: run({long}) took {t_long:.3g} s, "
                f"no longer than run({short}) at {t_short:.3g} s, even over "
                "the widened window")
    return (t_long - t_short) / (long - short)


def measure_stream_bandwidth(n: int = 1 << 26, dtype=torch.float32,
                             device=None) -> float:
    """Streaming bytes/s of a chained triad r' = 0.001 y + c_i r, one torch
    call (``torch.add(..., alpha=c_i, out=...)``) per iteration over
    ping-ponged buffers: 3 arrays of ``n`` elements per iteration, the
    traffic the solvers' models charge.  The default 256 MB arrays are far
    above the card's 50 MB L2, which would otherwise serve the carry."""
    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(0)
    x = torch.rand(n, generator=g, dtype=dtype, device=device)
    y = torch.rand(n, generator=g, dtype=dtype, device=device) * 0.001
    bufs = (torch.empty_like(x), torch.empty_like(x))

    def run(k):
        src = x
        for i in range(k):
            dst = bufs[i % 2]
            torch.add(y, src, alpha=0.5 + 1e-6 * i, out=dst)
            src = dst
        return src

    k0, k1 = 100, 500
    run(k0)
    per_iter = marginal_seconds_per_iter(run, k0, k1)
    return 3 * x.element_size() * n / per_iter


def measure_step2_compute_ceiling(offsets, values, C=4096, device=None):
    """The s-step pass's compute ceiling, measured: the same kernel (K1,
    ``grid2d_cg_step2``) on a 2^20 / C x C problem (256 x 4096 by default;
    ``C`` the view's width, which a 1-D view's offsets depend on) whose
    three 4 MB vectors stay in the card's 50 MB L2, so device memory is
    out of the loop.

    Returns (seconds per element per pass, apparent bytes/s at the pass's
    24 B/elt, K1 passes launched).  Callers treat the ceiling as
    unestablished unless the apparent rate is well above the stream
    bandwidth (residency not achieved)."""
    from ..ops.cuda.stencil2d import grid2d_cg_step2

    device = resolve_device(device)
    R = (1 << 20) // C
    g = torch.Generator(device).manual_seed(0)
    x, r, p = (torch.randn(R, C, generator=g, dtype=torch.float32,
                           device=device) for _ in range(3))
    coef = torch.full((6,), 0.01, dtype=torch.float32, device=device)
    spare = (torch.empty_like(r), torch.empty_like(p))
    launched = [0]

    def run(k):
        nonlocal r, p, spare
        for _ in range(k):
            _, rn, pn, _ = grid2d_cg_step2(x, r, p, coef, out=spare,
                                           offsets=offsets, values=values)
            spare, r, p = (r, p), rn, pn
        launched[0] += k

    k0, k1 = 20, 100
    run(k0)
    run(k1)
    sec = marginal_seconds_per_iter(run, k0, k1)
    n = R * C
    return sec / n, 24.0 * n / sec, launched[0]
