"""Block-partitioned vectors.

Port of ``legionsolvers_tpu/core/vector.py`` (reference:
PartitionedVector.hpp:13-134).  A :class:`PartitionedVector` owns one padded
tensor on an explicit device, stored flat (``[padded_size]``) or in a grid
layout (``grid_shape``, for stencil problems).  BLAS-1 methods rebind
``data`` to a new tensor, as the JAX methods do; in-place updates happen
only inside the fused CG runners, on buffers the solver owns.

On a mesh (``parallel/mesh.py``) the tensor stays one padded tensor on the
mesh's one device: piece ``s`` is the row block ``[s * B, (s + 1) * B)``
(in grid layout rows ``[s * Br, (s + 1) * Br)``), a contiguous view.  On a
mesh over processes the tensor holds this process's pieces only, ``[lo,
hi)``: ``[(hi - lo) * B]``, or ``[(hi - lo) * Br, ...]`` in grid layout;
fills, ``from_array`` and ``random_fill`` give each process its slice of
the one-process vector, and ``dot`` and ``to_numpy`` are collectives.  A
mesh over several distinct devices of one process raises
NotImplementedError (ROADMAP §1 item 5g (ii)).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..options import DEFAULT_OPTIONS, SHARD_AXIS, SolverOptions
from ..ops import blas1
from ..parallel.mesh import (
    NamedSharding,
    gather_pieces,
    gather_vector,
    ordered_sum,
    piece_range,
    resolve_mesh,
    spans_processes,
)
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


def piece_dot(mesh, a: torch.Tensor, b: torch.Tensor, num: int,
              compensated: bool = False) -> torch.Tensor:
    """<a, b> over a mesh over processes: each of the ``num`` local
    pieces' sum (compensated: exact f32 products summed in float64 and
    rounded once), gathered and added in piece order, the JAX package's
    psum of per-shard sums; in ``a``'s dtype."""
    a2, b2 = a.reshape(num, -1), b.reshape(num, -1)
    if compensated:
        parts = torch.stack([
            torch.sum(a2[s].to(torch.float32).double()
                      * b2[s].to(torch.float32).double()).to(torch.float32)
            for s in range(num)])
    else:
        parts = torch.stack([torch.sum(a2[s] * b2[s]) for s in range(num)])
    return ordered_sum(gather_pieces(mesh, parts), a.dtype)


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
        self.name = name
        self.partition = partition
        self.mesh, self.device = resolve_mesh(mesh, partition, device)
        # the pieces this process holds: all of them but on a process mesh
        self._lo, self._hi = piece_range(self.mesh, partition.num_pieces)
        self.options = options
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
        S, num = self.partition.num_pieces, self._hi - self._lo
        if self.grid_shape is not None:
            g = self.grid_shape
            return (g[0] // S * num,) + g[1:]
        return (self.partition.block_size * num,)

    def _n_local(self) -> int:
        """The true (unpadded) entries among this process's pieces."""
        B = self.partition.block_size
        return min(max(self.n - self._lo * B, 0), (self._hi - self._lo) * B)

    def _slice(self, whole: torch.Tensor) -> torch.Tensor:
        """This process's pieces of a whole padded flat vector."""
        B = self.partition.block_size
        return whole[self._lo * B: self._hi * B]

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

    @property
    def sharding(self) -> Optional[NamedSharding]:
        """The block partition of axis 0 over the mesh's shard axis, or
        None without a mesh."""
        if self.mesh is None:
            return None
        ndim = len(self.grid_shape) if self.grid_shape is not None else 1
        return NamedSharding(self.mesh, (SHARD_AXIS,) + (None,) * (ndim - 1))

    def like(self, name: str) -> "PartitionedVector":
        """Fresh zero vector over the same partition, mesh, layout and
        device."""
        return PartitionedVector(
            name, self.partition, mesh=self.mesh, options=self.options,
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
        """Build from a host array of length ``n`` (pads with zeros), on
        ``mesh``'s device when a mesh is given."""
        values = np.asarray(values).reshape(-1)
        if values.shape != (partition.n,):
            raise ValueError(
                f"expected shape ({partition.n},), got {values.shape}"
            )
        v = cls(name, partition, mesh=mesh, options=options,
                grid_shape=grid_shape, lazy=True, device=device)
        padded = torch.zeros(partition.padded_size, dtype=options.entry_dtype)
        padded[: partition.n] = torch.from_numpy(values.copy())
        v.data = v._slice(padded).reshape(v._shape()).to(v.device)
        return v

    # -- fills (reference: PartitionedVector.cpp:151-172) -------------------
    def constant_fill(self, value) -> "PartitionedVector":
        if self.grid_shape is not None:  # grid layout has no padding
            self.data = torch.full_like(self.data, value)
        else:
            self.data = blas1.masked_fill(self.data, value, self._n_local())
        return self

    def zero_fill(self) -> "PartitionedVector":
        # back to the lazy state: zeros materialize on first read
        self._data = None
        return self

    def refill_constant(self, value) -> "PartitionedVector":
        """``constant_fill`` that releases the previous buffer before it
        allocates the new one and never reads the old one: the fill for
        when two live copies of a vector would not fit."""
        self._data = None
        d = torch.full(self._shape(), value, dtype=self.options.entry_dtype,
                       device=self.device)
        if self.grid_shape is None:
            d[self._n_local():] = 0
        self.data = d
        return self

    def random_fill(
        self, generator: Optional[torch.Generator] = None, lo=0.0, hi=1.0
    ) -> "PartitionedVector":
        """Uniform fill from an explicit ``torch.Generator`` on the vector's
        device (reference: RandomFillTask, UtilityTasks.cpp:128-166).  The
        default generator is seeded with 0.  On a process mesh every
        process draws the whole vector and keeps its pieces, so the values
        are the one-process vector's."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        vals = torch.rand(
            self.partition.padded_size, generator=generator,
            dtype=self.options.entry_dtype, device=self.device,
        )
        vals = vals * (hi - lo) + lo
        vals[self.n:] = 0
        self.data = self._slice(vals).reshape(self._shape())
        return self

    # -- copy (reference: operator=, PartitionedVector.cpp:176-191) ---------
    def assign(self, other: "PartitionedVector") -> "PartitionedVector":
        """Share ``other``'s buffer (no copy), as the JAX package does."""
        if other.partition != self.partition:
            raise ValueError("assign requires identical partitions")
        self.data = other.data
        return self

    def copy(self, name: Optional[str] = None) -> "PartitionedVector":
        """A new vector with its own copy of the data (the JAX package's
        arrays are immutable, so its copy may share them; torch tensors are
        updated in place, so this one clones)."""
        return PartitionedVector(
            name or self.name, self.partition, mesh=self.mesh,
            data=self.data.clone(), options=self.options,
            grid_shape=self.grid_shape, device=self.device,
        )

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
        """<self, other>; on a process mesh a collective
        (:func:`piece_dot`)."""
        if spans_processes(self.mesh):
            return Scalar(piece_dot(self.mesh, self.data, other.data,
                                    self._hi - self._lo))
        return Scalar(blas1.dot(self.data, other.data))

    def norm2(self) -> Scalar:
        return self.dot(self)

    # -- materialization ----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """The true (unpadded) values on the host, flattened.  On a process
        mesh it gathers every process's pieces: a collective, which every
        process must call."""
        data = gather_vector(self.mesh, self.data.reshape(-1))
        return data.detach().cpu().numpy()[: self.n]

    def print(self) -> None:
        """Debug dump (reference: PrintVectorTask path)."""
        print(f"[legionsolvers] vector {self.name}: {self.to_numpy()}")

    def __repr__(self) -> str:
        return (
            f"PartitionedVector({self.name!r}, n={self.n}, "
            f"pieces={self.partition.num_pieces}, device={self.device})"
        )
