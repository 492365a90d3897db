"""Library initialization and capability banner.

Port of ``legionsolvers_tpu/utils/initialize.py`` (reference:
``LegionSolvers::initialize``, Initialize.cpp:20-487).  The reference
prints a banner (:22-66), registers its mapper (:68-75) and preregisters
every task instantiation (:77-486).  In the port, PyTorch dispatches by
dtype and device and the CUDA kernels are built at first use
(``ops/cuda/build.py``), so what remains is the banner.
"""

from __future__ import annotations

import os
import sys

import torch

from ..options import ENTRY_DTYPES, INDEX_DTYPES, MAX_DIM

PREFIX = "[LegionSolvers]"

# the LEGIONSOLVERS_NO_* kill-switches the port reads, each turning off one
# fast path in favour of the next more general one
SWITCHES = ("NO_SSTEP", "NO_FUSED_BICGSTAB", "NO_WINELL", "NO_BLOCK_FUSED",
            "NO_SLICED_ELL", "NO_GENSPMV", "NO_DIA", "NO_RCM", "NO_NATIVE")


def _dtype_name(d: torch.dtype) -> str:
    return str(d).replace("torch.", "")


def initialize(print_info: bool = True, verbose: bool = False) -> None:
    """Print the capability banner (reference: Initialize.cpp:22-66).  Safe
    to call more than once; registers nothing."""
    if not print_info:
        return
    from .. import __version__

    print(f"{PREFIX} legionsolvers_tpu_torch {__version__} on torch "
          f"{torch.__version__}")
    if torch.cuda.is_available():
        count = torch.cuda.device_count()
        names = [torch.cuda.get_device_name(i)
                 for i in range(count if verbose else min(count, 8))]
        print(f"{PREFIX} backend: cuda {torch.version.cuda} with {count} "
              f"device(s): " + ", ".join(names))
    else:
        print(f"{PREFIX} backend: cpu (no CUDA device)")
    print(f"{PREFIX} entry types: "
          + ", ".join(_dtype_name(d) for d in ENTRY_DTYPES)
          + "; index types: "
          + ", ".join(_dtype_name(d) for d in INDEX_DTYPES)
          + f"; max stencil dim: {MAX_DIM}")
    if verbose:
        print(f"{PREFIX} TF32 matmul: "
              f"{torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr)
        active = [s for s in SWITCHES
                  if os.environ.get(f"LEGIONSOLVERS_{s}")]
        print(f"{PREFIX} kill-switches active: "
              + (", ".join(active) if active else "none")
              + f" (available: {', '.join(SWITCHES)})")
