"""Host-side build helpers (C++ via ctypes, with numpy versions).

The card runs the solves; this package is the host code around them that
builds a problem once: stencil COO fills, CSR row pointers, DIA
extraction, RCM ordering, the per-piece halo and ELL packing and the text
of Matrix Market files (reference: StencilGenerator.cpp,
ExampleSystems.cpp:250-470, COOMatrix.cpp:57-141).  ``csrc/kernels.cpp``
is built with g++ at first use; without it every entry point runs its
numpy version (``bindings.py``).
"""

from .bindings import (
    available,
    build_indptr,
    dia_accumulate,
    dia_unique_offsets,
    pack_ell_shard,
    rcm_permutation,
    shard_halo_columns,
    stencil_fill_coo,
    stencil_size,
)

__all__ = ["available", "build_indptr", "dia_accumulate",
           "dia_unique_offsets", "pack_ell_shard", "rcm_permutation",
           "shard_halo_columns", "stencil_fill_coo", "stencil_size"]
