"""Op-rate probe: calibrates the compute side of ``utils/roofline.py``.

Port of ``legionsolvers_tpu/utils/vpu_probe.py``.  The s-step CG pass's
compute model counts three op classes (plain arithmetic, lane rolls, row
shifts); their sustained rates on the card come from K11
(``ops/cuda/vpu_probe.py``), which keeps one 1 MB tile on chip and loops
the op chain with no device-memory traffic per trip.  The rate keys keep
the JAX package's names so the roofline model reads either package's.

Rates are properties of the card, so :func:`load_or_measure` caches them
under the repository's ``build/`` directory, one file per card name; it
never reads or writes the repository's ``VPU_RATES.json``, which holds
another machine's rates.  On a card a failed or implausible measurement
raises; ``None`` comes back only for a device that is not CUDA.
"""

from __future__ import annotations

import json
import pathlib
import re

import torch

from ..ops.cuda.build import BUILD_DIR
from ..ops.cuda.vpu_probe import C, ILP, TR, UNROLL, chain_probe
from ..options import resolve_device

#: Loop trips (short, long) per kind.  One fma trip of the whole tile is
#: 16.8M fused multiply-adds, ~0.5 us at the card's f32 peak, so 80,000
#: extra trips take ~40 ms; roll and row trips pass through shared memory
#: twice per step (~4 us each at its peak rate), so 4,000 extra trips take
#: tens of ms.  Each kind's marginal stays well under 2 s.
CHAIN_LENGTHS = {"fma": (20_000, 100_000), "roll": (1_000, 5_000),
                 "row": (1_000, 5_000)}

# The plausibility window, from NVIDIA's H100 SXM data sheet and the Hopper
# white paper: 132 SMs at a 1.98 GHz boost clock; 128 f32 lanes per SM
# (2 flop per fused multiply-add): 66.9 TFLOP/s, quoted as 67; 32 shared-
# memory banks of 4 B per SM per clock: 33.4 TB/s.  A roll or row step
# stores and loads one 4 B value per chain through shared memory.
SMS, BOOST_HZ = 132, 1.98e9
F32_PEAK_FLOPS = 67e12
SMEM_BYTES_PER_S = SMS * 32 * 4 * BOOST_HZ
EXCHANGE_BYTES_PER_STEP = 8
RATE_WINDOW = {
    "vpu_fma_ops_per_s": (1e11, F32_PEAK_FLOPS),
    "vpu_roll_plus_add_reps_per_s": (
        1e9, SMEM_BYTES_PER_S / EXCHANGE_BYTES_PER_STEP),
    "vpu_row_shift_add_reps_per_s": (
        1e9, SMEM_BYTES_PER_S / EXCHANGE_BYTES_PER_STEP),
}


def _measure(kind: str, device) -> float:
    """Chain steps per second for one kind (ILP chains per element)."""
    from .timing import marginal_seconds_per_iter

    g = torch.Generator(device).manual_seed(0)
    x = torch.randn(TR, C, generator=g, dtype=torch.float32, device=device)
    short, long = CHAIN_LENGTHS[kind]
    chain_probe(x, short, kind)
    sec = marginal_seconds_per_iter(
        lambda reps: chain_probe(x, reps, kind), short, long)
    return UNROLL * ILP * TR * C / sec


def measure_rates(device=None) -> dict:
    """{"vpu_fma_ops_per_s": flop/s of the fma chain (2 per step),
    "vpu_roll_plus_add_reps_per_s", "vpu_row_shift_add_reps_per_s": chain
    steps per second}, measured on ``device`` (the card by default)."""
    device = resolve_device(device)
    rates = {
        "vpu_fma_ops_per_s": 2.0 * _measure("fma", device),
        "vpu_roll_plus_add_reps_per_s": _measure("roll", device),
        "vpu_row_shift_add_reps_per_s": _measure("row", device),
    }
    if not rates_sane(rates):
        raise RuntimeError(f"implausible op rates for this card: {rates} "
                           f"(window {RATE_WINDOW})")
    return rates


def rates_sane(rates) -> bool:
    """Whether every rate lies in :data:`RATE_WINDOW`: no higher than the
    card's data sheet allows, and not absurdly low (a collapsed marginal)."""
    try:
        return all(lo <= float(rates[k]) <= hi
                   for k, (lo, hi) in RATE_WINDOW.items())
    except (KeyError, TypeError, ValueError):
        return False


def cache_path(device_name: str) -> pathlib.Path:
    """The cache file of one card, under ``build/``."""
    slug = re.sub(r"[^A-Za-z0-9]+", "_", device_name).strip("_") or "card"
    return BUILD_DIR / "op_rates" / f"{slug}.json"


def load_or_measure(device=None):
    """The card's cached rates, or measure and cache them.  ``None`` for a
    device that is not CUDA; on a card any failure raises."""
    device = resolve_device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    path = cache_path(name)
    if path.exists():
        cached = json.loads(path.read_text())
        if cached.get("device") == name and rates_sane(cached):
            return {k: cached[k] for k in RATE_WINDOW}
        path.unlink()  # another card's, or a poisoned reading
    rates = measure_rates(device)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(dict(rates, device=name), indent=1))
    return rates
