"""The solver mesh: one device per shard, several shards per device.

Port of ``legionsolvers_tpu/parallel/mesh.py``.  The JAX package lays its
1-D mesh over devices, one shard per chip, and XLA's SPMD partitioner
places each contiguous block of a vector on its chip.  The reference
itself puts several pieces on one GPU: its launch policy is "pieces = 4 x
nodes" (reference: bench_all.py:169-208) and its mapper places them.  The
port keeps that second form: a :class:`Mesh` names a ``torch.device`` for
each shard, and one device may carry every shard (``make_mesh(S,
devices=[card] * S)``).  A vector on such a mesh is one padded tensor on
that device, piece ``s`` its row block ``[s * B, (s + 1) * B)``; the
operators run their kernels once per piece and exchange halo rows by
copying the neighbours' edge rows (``parallel/stencil_op.py``,
``parallel/sstep_sharded.py``, ``parallel/dia_op.py``), or, for an
explicit matrix, its static halo schedule (``parallel/distmatrix.py``).

Not ported yet (ROADMAP §1, item 5g): shards on more than one distinct
device (torch.distributed over several cards or processes) and
``initialize_distributed``; such a mesh raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..options import SHARD_AXIS, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the axis :data:`~..options.SHARD_AXIS`: shard ``s``
    lives on ``devices[s]``.  ``shape[SHARD_AXIS]`` is the shard count, as
    for a ``jax.sharding.Mesh``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (SHARD_AXIS,)

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where an array of the mesh lives: ``spec[d]`` is SHARD_AXIS when
    dimension ``d`` is block-partitioned over the shards, None when it is
    whole on every shard (the JAX ``NamedSharding`` of a mesh and a
    ``PartitionSpec``)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def mesh_device(mesh: Mesh) -> torch.device:
    """The one device that carries every shard of ``mesh``.  Shards on
    several distinct devices raise: their placement (torch.distributed
    over cards and processes) is not ported."""
    distinct = sorted({str(d) for d in mesh.devices})
    if len(distinct) != 1:
        raise NotImplementedError(
            f"a mesh over the distinct devices {distinct}: placing shards "
            "on more than one device is not ported (ROADMAP §1 item 5g, "
            "multi-device placement)")
    return mesh.devices[0]


def make_mesh(num_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D solver mesh over the first ``num_shards`` of ``devices``
    (default: the visible CUDA devices; ``num_shards`` defaults to all of
    them).  ``devices=[card] * S`` puts S shards on one card, the
    reference's several pieces per GPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if num_shards is None:
        num_shards = len(devices)
    if num_shards < 1:
        raise ValueError(f"a mesh needs at least one shard, got {num_shards}")
    if num_shards > len(devices):
        raise ValueError(
            f"requested {num_shards} shards but only {len(devices)} devices")
    mesh = Mesh(tuple(resolve_device(d) for d in devices[:num_shards]))
    mesh_device(mesh)
    return mesh


def single_device_mesh(device=None) -> Mesh:
    """A 1-shard mesh on ``device`` (default: the card)."""
    return Mesh((resolve_device(device),))


def sharded(mesh: Mesh) -> NamedSharding:
    """Axis 0 block-partitioned over the shard axis."""
    return NamedSharding(mesh, (SHARD_AXIS,))


def replicated(mesh: Mesh) -> NamedSharding:
    """Whole on every shard (scalars, small dense workspaces)."""
    return NamedSharding(mesh, ())


def num_shards(mesh: Mesh) -> int:
    return mesh.shape[SHARD_AXIS]


def ordered_sum(parts, dtype, wide: bool = False):
    """The sum of per-piece (or per-space) reductions in their order, in
    ``dtype``; ``wide``: in float64, rounded to ``dtype`` once.  ``parts``
    is a sequence or a stacked tensor (summed along its first axis)."""
    acc = torch.float64 if wide else dtype
    total = parts[0].to(acc)
    for p in parts[1:]:
        total = total + p.to(acc)
    return total.to(dtype)


def resolve_mesh(mesh, partition, device):
    """(mesh, device) of a vector, operator or planner given ``mesh``, its
    ``partition`` (or None) and its ``device`` argument: the mesh's one
    device, which ``device`` may name but not contradict, and its shard
    count equal to the partition's pieces."""
    if mesh is None:
        return None, resolve_device(device)
    dev = mesh_device(mesh)
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"device {device} is not the mesh's device {dev}")
    if partition is not None and num_shards(mesh) != partition.num_pieces:
        raise ValueError("mesh size must equal partition piece count")
    return mesh, dev
