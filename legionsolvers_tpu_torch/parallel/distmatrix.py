"""Row-partitioned sparse operator, single-device (ELL) form.

Port of the unsharded path of ``legionsolvers_tpu/parallel/distmatrix.py``
(reference: COOMatrix.cpp:144-191, SquarePlanner.hpp:209-235).  The matrix
is stored as one global ELL slab over the padded range: row ``i`` holds its
nonzeros in COO order, padded slots carry value 0 and column 0.  The
planner keeps explicit matrices here when none of its upgrades applies
(DIA, a reordered windowed ELL or the routed gather, all one piece) and
for multi-piece partitions, which it runs on one device.  The sharded
halo-exchange path, with its per-shard windowed-ELL plans, waits for the
multi-device slice: a non-``None`` mesh raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.matrix import AbstractMatrix
from ..core.partition import BlockPartition
from ..options import DEFAULT_OPTIONS, SolverOptions, resolve_device


class RowPartitionedMatrix:
    """A sparse operator over block partitions of its domain and range."""

    def __init__(
        self,
        matrix: AbstractMatrix,
        domain_partition: BlockPartition,
        range_partition: BlockPartition,
        mesh=None,
        options: SolverOptions = DEFAULT_OPTIONS,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "sharded operators are not ported to the torch package yet"
            )
        if domain_partition.num_pieces != range_partition.num_pieces:
            raise ValueError("domain/range piece counts must match")
        self.matrix = matrix
        self.domain_partition = domain_partition
        self.range_partition = range_partition
        self.mesh = None
        self.options = options
        self.device = resolve_device(device)

        rows = matrix.rows
        order = np.argsort(rows, kind="stable")
        counts = np.bincount(rows, minlength=range_partition.padded_size)
        L = max(int(counts.max(initial=0)), 1)
        self.row_length = L
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        r_sorted = rows[order]
        slot = np.arange(len(rows)) - starts[r_sorted]
        g_cols = np.zeros((range_partition.padded_size, L), dtype=np.int64)
        g_vals = np.zeros((range_partition.padded_size, L), dtype=np.float64)
        g_cols[r_sorted, slot] = matrix.cols[order]
        g_vals[r_sorted, slot] = np.asarray(matrix.vals)[order]
        self.g_ell_cols = torch.as_tensor(
            g_cols, dtype=options.index_dtype, device=self.device)
        self.g_ell_vals = torch.as_tensor(
            g_vals, dtype=options.entry_dtype, device=self.device)

    @property
    def num_pieces(self) -> int:
        return self.domain_partition.num_pieces

    def nnz(self) -> int:
        return self.matrix.n_kernel

    # device buffers, carried by SquarePlanner.dump_state/load_state
    def device_state(self):
        return {"g_ell_cols": self.g_ell_cols, "g_ell_vals": self.g_ell_vals}

    def set_device_state(self, state) -> None:
        for k, v in state.items():
            setattr(self, k, v)

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x over padded vectors.  Padded rows have all-zero ELL
        rows, so y's padding stays 0."""
        from ..ops.spmv import spmv_ell

        return spmv_ell(self.g_ell_cols, self.g_ell_vals, x)

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """y = A^T @ x over padded vectors (x over the range space, y over
        the domain space, its padding 0): the COO transpose product of the
        matrix's nonzeros, as the JAX package's unsharded path computes
        it."""
        from ..ops.spmv import rmatvec_coo

        m = self.matrix
        idx = dict(dtype=torch.int64, device=x.device)
        y = rmatvec_coo(
            torch.as_tensor(m.rows, **idx), torch.as_tensor(m.cols, **idx),
            torch.as_tensor(np.asarray(m.vals), dtype=x.dtype,
                            device=x.device),
            x[: m.n_range], m.n_domain)
        out = torch.zeros(self.domain_partition.padded_size, dtype=y.dtype,
                          device=y.device)
        out[: m.n_domain] = y
        return out
