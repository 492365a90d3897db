"""Library-wide configuration for the PyTorch port.

Mirrors ``legionsolvers_tpu/options.py``: every tensor the library creates
takes its dtype from a :class:`SolverOptions`, never from torch defaults.
Entry types are float32 and float64 only: the JAX package also lists
bfloat16, but no test there exercises a bf16 solve, so there is no oracle
to hold a port against.

Devices default to the card.  Vectors, operators, planners and entry points
take a ``device`` argument, resolved by :func:`resolve_device`: ``None``
means CUDA, and asking for CUDA on a machine without a card raises instead
of carrying on on the CPU.  The CPU runs only when the caller asks for it
(``device="cpu"``, as the tests do).
"""

from __future__ import annotations

import dataclasses
import os

import torch

ENTRY_DTYPES = (torch.float32, torch.float64)
INDEX_DTYPES = (torch.int32, torch.int64)

# Maximum problem dimensionality for stencil generators.
MAX_DIM = 3


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Per-problem dtype policy.

    entry_dtype: dtype of matrix entries and vector elements.
    index_dtype: dtype of index arrays (ELL columns, COO rows/cols).
    compensated_dots: accumulate the solver dots from exact products in
        float64 (``ops/ddsum.py``), honoured by ``SquarePlanner.dot`` and
        the fused BiCGStab kernels.  The default is read from
        LEGIONSOLVERS_COMPENSATED_DOTS each time a ``SolverOptions`` is
        constructed, as in the JAX package.
    """

    entry_dtype: torch.dtype = torch.float32
    index_dtype: torch.dtype = torch.int64
    compensated_dots: bool = dataclasses.field(
        default_factory=lambda: bool(
            int(os.environ.get("LEGIONSOLVERS_COMPENSATED_DOTS", "0"))
        )
    )

    def __post_init__(self) -> None:
        if self.entry_dtype not in ENTRY_DTYPES:
            raise ValueError(f"unsupported entry dtype {self.entry_dtype}")
        if self.index_dtype not in INDEX_DTYPES:
            raise ValueError(f"unsupported index dtype {self.index_dtype}")


DEFAULT_OPTIONS = SolverOptions()


def resolve_device(device=None) -> torch.device:
    """``torch.device`` with the CUDA index filled in, so that two spellings
    of one card compare equal; ``None`` is CUDA.  Raises when CUDA is asked
    for and absent: there is no fallback to the CPU."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(d)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d
