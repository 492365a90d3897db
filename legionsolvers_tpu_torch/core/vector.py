"""Single-device block-partitioned vectors.

Port of ``legionsolvers_tpu/core/vector.py`` (reference:
PartitionedVector.hpp:13-134).  A :class:`PartitionedVector` owns one padded
tensor on an explicit device, stored flat (``[padded_size]``) or in a grid
layout (``grid_shape``, for stencil problems).  BLAS-1 methods rebind
``data`` to a new tensor, as the JAX methods do; in-place updates happen
only inside the fused CG runners, on buffers the solver owns.

Sharding is not ported yet: a non-``None`` ``mesh`` raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from ..ops import blas1
from .partition import BlockPartition
from .scalar import Scalar, alpha_from_scalars

AlphaLike = Union[int, float, torch.Tensor, Scalar]


def _resolve_alpha(args: Sequence[AlphaLike]) -> torch.Tensor:
    """One direct coefficient, or the reference's 1-4 scalar future-ratio
    protocol (reference: PartitionedVector.cpp:211-333)."""
    if len(args) == 1 and not isinstance(args[0], Scalar):
        return torch.as_tensor(args[0])
    return alpha_from_scalars(
        [a if isinstance(a, Scalar) else Scalar(a) for a in args]
    )


class PartitionedVector:
    """A named vector of true length ``n`` stored padded to
    ``partition.padded_size`` with zeros in the padding slots."""

    def __init__(
        self,
        name: str,
        partition: BlockPartition,
        mesh=None,
        data: Optional[torch.Tensor] = None,
        options: SolverOptions = DEFAULT_OPTIONS,
        grid_shape: Optional[tuple] = None,
        lazy: bool = False,
        device=None,
    ):
        """``grid_shape``: optional N-D layout, which requires an unpadded
        partition whose size it covers exactly.  ``lazy``: materialize the
        zero buffer on first read instead of now."""
        if mesh is not None:
            raise NotImplementedError(
                "sharded vectors are not ported to the torch package yet"
            )
        self.name = name
        self.partition = partition
        self.mesh = None
        self.options = options
        self.device = resolve_device(device)
        if grid_shape is not None:
            grid_shape = tuple(int(d) for d in grid_shape)
            if int(np.prod(grid_shape)) != partition.padded_size:
                raise ValueError("grid_shape must cover padded_size exactly")
            if partition.padded_size != partition.n:
                raise ValueError("grid layout requires an unpadded partition")
            if grid_shape[0] % partition.num_pieces:
                raise ValueError(
                    "grid_shape[0] must be divisible by the piece count"
                )
        self.grid_shape = grid_shape
        self._data = None
        if data is not None:
            self.data = data
        elif not lazy:
            self._data = self._zeros()

    def _shape(self):
        return self.grid_shape or (self.partition.padded_size,)

    def _zeros(self) -> torch.Tensor:
        return torch.zeros(
            self._shape(), dtype=self.options.entry_dtype, device=self.device
        )

    # ``data`` materializes lazily: workspace vectors a solver never touches
    # (Q on the fused CG path) cost no device memory.
    @property
    def data(self) -> torch.Tensor:
        if self._data is None:
            self._data = self._zeros()
        return self._data

    @data.setter
    def data(self, value: torch.Tensor):
        if value.device != self.device:
            raise ValueError(
                f"vector {self.name!r} lives on {self.device}, "
                f"got data on {value.device}"
            )
        self._data = value

    # -- construction helpers ----------------------------------------------
    @property
    def n(self) -> int:
        return self.partition.n

    def like(self, name: str) -> "PartitionedVector":
        """Fresh zero vector over the same partition, layout and device."""
        return PartitionedVector(
            name, self.partition, options=self.options,
            grid_shape=self.grid_shape, device=self.device,
        )

    @classmethod
    def from_array(
        cls,
        name: str,
        values: np.ndarray,
        partition: BlockPartition,
        mesh=None,
        options: SolverOptions = DEFAULT_OPTIONS,
        grid_shape: Optional[tuple] = None,
        device=None,
    ) -> "PartitionedVector":
        """Build from a host array of length ``n`` (pads with zeros)."""
        values = np.asarray(values).reshape(-1)
        if values.shape != (partition.n,):
            raise ValueError(
                f"expected shape ({partition.n},), got {values.shape}"
            )
        v = cls(name, partition, mesh=mesh, options=options,
                grid_shape=grid_shape, lazy=True, device=device)
        padded = torch.zeros(partition.padded_size, dtype=options.entry_dtype)
        padded[: partition.n] = torch.from_numpy(values.copy())
        v.data = padded.reshape(v._shape()).to(v.device)
        return v

    # -- fills (reference: PartitionedVector.cpp:151-172) -------------------
    def constant_fill(self, value) -> "PartitionedVector":
        if self.grid_shape is not None:  # grid layout has no padding
            self.data = torch.full_like(self.data, value)
        else:
            self.data = blas1.masked_fill(self.data, value, self.n)
        return self

    def zero_fill(self) -> "PartitionedVector":
        # back to the lazy state: zeros materialize on first read
        self._data = None
        return self

    def random_fill(
        self, generator: Optional[torch.Generator] = None, lo=0.0, hi=1.0
    ) -> "PartitionedVector":
        """Uniform fill from an explicit ``torch.Generator`` on the vector's
        device (reference: RandomFillTask, UtilityTasks.cpp:128-166).  The
        default generator is seeded with 0."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        vals = torch.rand(
            self.partition.padded_size, generator=generator,
            dtype=self.options.entry_dtype, device=self.device,
        )
        vals = vals * (hi - lo) + lo
        vals[self.n:] = 0
        self.data = vals.reshape(self._shape())
        return self

    # -- copy (reference: operator=, PartitionedVector.cpp:176-191) ---------
    def assign(self, other: "PartitionedVector") -> "PartitionedVector":
        """Share ``other``'s buffer (no copy), as the JAX package does."""
        if other.partition != self.partition:
            raise ValueError("assign requires identical partitions")
        self.data = other.data
        return self

    # -- BLAS-1 (reference: PartitionedVector.cpp:196-358) ------------------
    def scal(self, *alpha: AlphaLike) -> "PartitionedVector":
        self.data = blas1.scal(_resolve_alpha(alpha), self.data)
        return self

    def axpy(self, *args) -> "PartitionedVector":
        """axpy(alpha..., x): self += alpha * x (reference:
        PartitionedVector.cpp:211-284)."""
        *alpha, x = args
        self.data = blas1.axpy(self.data, _resolve_alpha(alpha), x.data)
        return self

    def xpay(self, *args) -> "PartitionedVector":
        """xpay(alpha..., x): self = x + alpha * self (reference:
        PartitionedVector.cpp:288-333)."""
        *alpha, x = args
        self.data = blas1.xpay(self.data, _resolve_alpha(alpha), x.data)
        return self

    def dot(self, other: "PartitionedVector") -> Scalar:
        return Scalar(blas1.dot(self.data, other.data))

    def norm2(self) -> Scalar:
        return Scalar(blas1.norm2(self.data))

    # -- materialization ----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """The true (unpadded) values on the host, flattened."""
        return self.data.detach().cpu().numpy().reshape(-1)[: self.n]

    def __repr__(self) -> str:
        return (
            f"PartitionedVector({self.name!r}, n={self.n}, "
            f"pieces={self.partition.num_pieces}, device={self.device})"
        )
