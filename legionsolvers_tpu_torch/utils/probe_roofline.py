"""Check the device-memory streaming roofline on the card.

Port of ``scripts/probe_roofline.py``.  Three probes, all marginal-timed
(fixed launch and synchronisation costs cancel):

1. the triad of ``utils/timing.py`` at n = 2^26 (256 MB per array, far
   above the 50 MB L2): 3 arrays per iteration;
2. the same triad at n = 2^24 (64 MB per array), where part of the carry
   can stay in L2;
3. K12 (``ops/cuda/copy_probe.py``), a hand-written copy kernel o = x + 1
   over a 16384 x 4096 float32 array (256 MB each way): read + write.

Run from the repository root:
    python -m legionsolvers_tpu_torch.utils.probe_roofline [--device cuda:0]
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from ..ops.cuda.copy_probe import copy_probe
from ..options import resolve_device
from .timing import marginal_seconds_per_iter, measure_stream_bandwidth


def triad_bw(n: int, device=None) -> float:
    """Bytes/s of the chained triad over arrays of ``n`` float32."""
    return measure_stream_bandwidth(n, device=device)


def copy_bw(rows: int = 16384, cols: int = 4096, k0: int = 20,
            k1: int = 100, device=None) -> float:
    """Bytes/s of K12: k launches chained a -> a + 1 over two ping-ponged
    [rows, cols] buffers, 8 B per element per launch (512 MB per launch at
    the default size), marginal over k0 and k1 launches."""
    device = resolve_device(device)
    g = torch.Generator(device).manual_seed(0)
    x = torch.rand(rows, cols, generator=g, dtype=torch.float32,
                   device=device)
    bufs = (torch.empty_like(x), torch.empty_like(x))

    def run(k):
        return copy_chain(x, k, bufs)

    run(k0)
    per_launch = marginal_seconds_per_iter(run, k0, k1)
    return 2 * 4 * rows * cols / per_launch


def copy_chain(x: torch.Tensor, k: int, bufs=None) -> torch.Tensor:
    """``k`` K12 launches from ``x``: the result is x + k (exactly, for
    small k and x).  ``bufs``: two spare buffers of x's shape."""
    if bufs is None:
        bufs = (torch.empty_like(x), torch.empty_like(x))
    a = x
    for i in range(k):
        a = copy_probe(a, out=bufs[i % 2])
    return a


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="device to probe (default: the card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise RuntimeError("the roofline probes measure a card; "
                           f"got {device}")
    card = card_line()
    print(f"[probe] device: {torch.cuda.get_device_name(device)} ({card})",
          flush=True)
    out = {"card": card}
    out["triad_2^26"] = triad_bw(1 << 26, device)
    print(f"[probe] triad n=2^26 (256 MB arrays): "
          f"{out['triad_2^26'] / 1e9:.1f} GB/s", flush=True)
    out["triad_2^24"] = triad_bw(1 << 24, device)
    print(f"[probe] triad n=2^24 (64 MB arrays): "
          f"{out['triad_2^24'] / 1e9:.1f} GB/s", flush=True)
    out["copy_k12"] = copy_bw(device=device)
    print(f"[probe] K12 copy (256 MB each way): "
          f"{out['copy_k12'] / 1e9:.1f} GB/s", flush=True)
    return out


if __name__ == "__main__":
    main()
