"""Host-side build helpers of the explicit-sparse path (numpy and scipy).

The JAX package builds these in C++ with numpy fallbacks; the port keeps
only the numpy/scipy paths, which land on the same operators.
"""

from .bindings import (
    dia_accumulate,
    dia_unique_offsets,
    pack_ell_shard,
    rcm_permutation,
    shard_halo_columns,
)

__all__ = ["dia_accumulate", "dia_unique_offsets", "pack_ell_shard",
           "rcm_permutation", "shard_halo_columns"]
