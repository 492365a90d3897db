"""Sparse operators: abstract interface + COO and CSR containers.

Port of ``legionsolvers_tpu/core/matrix.py`` (reference:
AbstractLinearOperator.hpp, AbstractMatrix.hpp, COOMatrix.cpp,
CSRMatrix.cpp).  Matrices are built on the host with numpy; device copies
are made per device on first use.  The partition derivations are the
host-side index-set computations of ``core/partition.py``.
"""

from __future__ import annotations

import abc
from typing import List, Sequence

import numpy as np
import torch

from ..options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from . import partition as pt
from .partition import BlockPartition


class AbstractLinearOperator(abc.ABC):
    """Minimal operator interface (reference: AbstractLinearOperator.hpp)."""

    @property
    @abc.abstractmethod
    def n_domain(self) -> int: ...

    @property
    @abc.abstractmethod
    def n_range(self) -> int: ...

    @abc.abstractmethod
    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """y = A @ x on global (possibly padded) vectors."""

    def apply_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y + A @ x (the planner's accumulation form)."""
        return y + self.apply(x)


class AbstractMatrix(AbstractLinearOperator):
    """An explicit sparse matrix with a kernel (nonzero) space and the four
    partition derivations (reference: AbstractMatrix.hpp:23-59)."""

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray

    @property
    def n_kernel(self) -> int:
        return len(self.rows)

    def kernel_partition_from_range_partition(
        self, range_partition: BlockPartition
    ) -> List[np.ndarray]:
        return pt.kernel_partition_from_range(self.rows, range_partition)

    def kernel_partition_from_domain_partition(
        self, domain_partition: BlockPartition
    ) -> List[np.ndarray]:
        return pt.kernel_partition_from_domain(self.cols, domain_partition)

    def domain_partition_from_kernel_partition(
        self, kernel_partition: Sequence[np.ndarray]
    ) -> List[np.ndarray]:
        return pt.domain_partition_from_kernel(self.cols, kernel_partition)

    def range_partition_from_kernel_partition(
        self, kernel_partition: Sequence[np.ndarray]
    ) -> List[np.ndarray]:
        return pt.range_partition_from_kernel(self.rows, kernel_partition)

    def domain_partition_from_range_partition(
        self, range_partition: BlockPartition
    ) -> List[np.ndarray]:
        return self.domain_partition_from_kernel_partition(
            self.kernel_partition_from_range_partition(range_partition)
        )

    def to_dense(self) -> np.ndarray:
        """Host-side densification (tests only)."""
        A = np.zeros((self.n_range, self.n_domain))
        np.add.at(A, (self.rows, self.cols), np.asarray(self.vals, np.float64))
        return A

    def device_arrays(self, device):
        """(rows, cols, vals) tensors on the caller's ``device``, made once
        per device."""
        device = resolve_device(device)
        if device not in self._dev:
            o = self.options
            self._dev[device] = (
                torch.as_tensor(self.rows, dtype=o.index_dtype, device=device),
                torch.as_tensor(self.cols, dtype=o.index_dtype, device=device),
                torch.as_tensor(self.vals, dtype=o.entry_dtype, device=device),
            )
        return self._dev[device]

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        from ..ops.spmv import spmv_coo

        rows, cols, vals = self.device_arrays(x.device)
        y = spmv_coo(rows, cols, vals, x[: self.n_domain], self.n_range)
        if x.shape[0] > self.n_domain:  # keep the padded layout
            y = torch.cat([y, y.new_zeros(x.shape[0] - self.n_range)])
        return y

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        """A^T @ x (the reference stubs it: COOMatrixTasks.cpp:78-83)."""
        from ..ops.spmv import rmatvec_coo

        rows, cols, vals = self.device_arrays(x.device)
        y = rmatvec_coo(rows, cols, vals, x[: self.n_range], self.n_domain)
        if x.shape[0] > self.n_range:
            y = torch.cat([y, y.new_zeros(x.shape[0] - self.n_domain)])
        return y


class COOMatrix(AbstractMatrix):
    """Coordinate-format sparse operator (reference: COOMatrix.hpp/.cpp)."""

    def __init__(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n_range: int,
        n_domain: int,
        name: str = "coo",
        options: SolverOptions = DEFAULT_OPTIONS,
    ):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.vals = np.asarray(vals)
        self._n_range = int(n_range)
        self._n_domain = int(n_domain)
        self.name = name
        self.options = options
        if not (len(self.rows) == len(self.cols) == len(self.vals)):
            raise ValueError("rows/cols/vals length mismatch")
        if len(self.rows) and (
            self.rows.min() < 0
            or self.rows.max() >= n_range
            or self.cols.min() < 0
            or self.cols.max() >= n_domain
        ):
            raise ValueError("COO indices out of bounds")
        self._dev = {}

    @property
    def n_domain(self) -> int:
        return self._n_domain

    @property
    def n_range(self) -> int:
        return self._n_range

    def to_csr(self) -> "CSRMatrix":
        order = np.lexsort((self.cols, self.rows))
        rows, cols, vals = self.rows[order], self.cols[order], self.vals[order]
        indptr = np.zeros(self.n_range + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRMatrix(
            indptr, cols, vals, self.n_range, self.n_domain,
            name=self.name + "_csr", options=self.options,
        )

    def print(self) -> None:
        """Debug dump (reference: COOPrintTask, COOMatrixTasks.cpp:86-127)."""
        for k in range(self.n_kernel):
            print(f"{self.name} [{self.rows[k]}, {self.cols[k]}]: "
                  f"{self.vals[k]}")


class CSRMatrix(AbstractMatrix):
    """Compressed-sparse-row operator (reference: CSRMatrix.hpp/.cpp),
    stored with the classical ``indptr``."""

    def __init__(
        self,
        indptr: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n_range: int,
        n_domain: int,
        name: str = "csr",
        options: SolverOptions = DEFAULT_OPTIONS,
    ):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.vals = np.asarray(vals)
        self._n_range = int(n_range)
        self._n_domain = int(n_domain)
        self.name = name
        self.options = options
        if self.indptr.shape != (n_range + 1,):
            raise ValueError("indptr must have length n_range + 1")
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.cols):
            raise ValueError("malformed indptr")
        # expanded row array over the kernel space: CSR shares COO's
        # partition derivations
        self.rows = np.repeat(
            np.arange(n_range, dtype=np.int64), np.diff(self.indptr)
        )
        self._dev = {}

    @property
    def n_domain(self) -> int:
        return self._n_domain

    @property
    def n_range(self) -> int:
        return self._n_range

    def row_rects(self) -> np.ndarray:
        """[n_range, 2] array of (first, last) kernel index per row: the
        reference's Rect-valued rowptr field (CSRMatrix.hpp:22-23).  A row
        with no nonzeros gets the empty rect (lo, lo - 1)."""
        return np.stack([self.indptr[:-1], self.indptr[1:] - 1], axis=1)

    def print(self) -> None:
        """Debug dump (reference: CSRPrintTask, CSRMatrixTasks.cpp:103-160)."""
        for i in range(self.n_range):
            for k in range(self.indptr[i], self.indptr[i + 1]):
                print(f"{self.name} [{i}, {self.cols[k]}]: {self.vals[k]}")

    def to_ell(self):
        """Pad rows to the max row length -> (ell_cols, ell_vals) host
        arrays; padded slots carry value 0 and column 0."""
        counts = np.diff(self.indptr)
        L = int(counts.max(initial=0))
        n = self.n_range
        ell_cols = np.zeros((n, L), dtype=np.int64)
        ell_vals = np.zeros((n, L), dtype=self.vals.dtype)
        slot = (
            np.arange(len(self.cols), dtype=np.int64)
            - self.indptr[:-1].repeat(counts)
        )
        ell_cols[self.rows, slot] = self.cols
        ell_vals[self.rows, slot] = self.vals
        return ell_cols, ell_vals
