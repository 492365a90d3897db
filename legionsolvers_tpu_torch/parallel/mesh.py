"""The solver mesh: one device per shard, several shards per device, and
shards over the processes of one ``torch.distributed`` group.

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

A mesh may also span processes (the JAX package's mesh over
``jax.devices()`` after ``jax.distributed.initialize``): after
:func:`initialize_distributed`, ``make_mesh(S, devices=[dev] * k)`` lays
the S shards over every process's k local ones in rank order, so each
rank owns one contiguous block of pieces (``Mesh.ranks``).  A vector then
holds only its rank's pieces, and the helpers below move what crosses a
process boundary: :func:`gather_pieces` (per-piece partials, summed
afterwards in piece order by :func:`ordered_sum` as on one process),
:func:`shift_pieces` (JAX's ``ppermute`` of per-piece blocks: the 2-D
halo rows, the 3-D halo planes, the linearized windows and the ELL
ring), :func:`gather_vector` and :func:`permute_rows` (a reordered
basis's permutation of a vector, at a solve's entry and exit), and
:func:`check_same_on_ranks` (a host array every rank must agree on, such
as an RCM permutation).  The group is gloo's, and every payload is copied
through host memory, card tensors included.  NCCL and shards on several
distinct devices of one process are not ported (ROADMAP §1 item 5g
(ii)): such a mesh raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
from typing import Optional, Sequence, Tuple

import torch

from ..options import SHARD_AXIS, resolve_device

# seconds a collective of the process group waits for its peers before it
# raises: a missed receive fails, never hangs
DIST_TIMEOUT_S = 120.0

# what a process mesh refuses, named in its errors
NOT_ACROSS = "ROADMAP §1 item 5g (iii)"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the axis :data:`~..options.SHARD_AXIS`: shard ``s``
    lives on ``devices[s]``.  ``shape[SHARD_AXIS]`` is the shard count, as
    for a ``jax.sharding.Mesh``.  ``ranks[s]`` is the process that owns
    shard ``s`` and ``rank`` this process (``ranks`` None: every shard is
    this process's)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (SHARD_AXIS,)
    ranks: Optional[Tuple[int, ...]] = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        return {SHARD_AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        """Whether the shards are split over several processes."""
        return self.ranks is not None and len(set(self.ranks)) > 1

    @property
    def local_range(self) -> Tuple[int, int]:
        """[lo, hi): the pieces this process owns, one contiguous block."""
        if self.ranks is None:
            return 0, self.size
        mine = [s for s, r in enumerate(self.ranks) if r == self.rank]
        return mine[0], mine[-1] + 1

    @property
    def local_size(self) -> int:
        lo, hi = self.local_range
        return hi - lo


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """Where an array of the mesh lives: ``spec[d]`` is SHARD_AXIS when
    dimension ``d`` is block-partitioned over the shards, None when it is
    whole on every shard (the JAX ``NamedSharding`` of a mesh and a
    ``PartitionSpec``)."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def mesh_device(mesh: Mesh) -> torch.device:
    """The one device that carries every shard of ``mesh`` this process
    owns.  Local shards on several distinct devices raise: their placement
    (several cards in one process) is not ported."""
    lo, hi = mesh.local_range
    distinct = sorted({str(d) for d in mesh.devices[lo:hi]})
    if len(distinct) != 1:
        raise NotImplementedError(
            f"a mesh over the distinct devices {distinct}: placing shards "
            "on more than one device of a process is not ported (ROADMAP "
            "§1 item 5g (ii), multi-device placement)")
    return mesh.devices[lo]


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join this process to the others of a run (the analog of the
    reference's GASNet-EX bootstrap under ``Legion::Runtime::start``,
    build_legion.py:94-96 + jsrun launch, bench_all.py:44-67; JAX's
    ``jax.distributed.initialize``): a gloo ``torch.distributed`` group of
    ``num_processes`` processes rendezvousing at ``coordinator_address``
    (``host:port``), this one ``process_id``.  After it ``make_mesh`` lays
    the shard axis over every process's local shards.  Arguments default
    to MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK; a no-op when already
    initialized or single-process.  The group's collectives raise after
    DIST_TIMEOUT_S seconds instead of waiting for a peer that never
    comes."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    host, port = coordinator_address.rsplit(":", 1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://{host}:{int(port)}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))


def _process_group_size() -> int:
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def make_mesh(num_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The 1-D solver mesh over the first ``num_shards`` of ``devices``
    (default: the visible CUDA devices; ``num_shards`` defaults to all of
    them).  ``devices=[card] * S`` puts S shards on one card, the
    reference's several pieces per GPU.  After
    :func:`initialize_distributed` over several processes, ``devices``
    lists this process's local shards, and the mesh is every process's
    shards in rank order (``num_shards``, if given, must be their total):
    rank r owns one contiguous block of pieces, as JAX lays out
    ``jax.devices()``."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if _process_group_size() > 1:
        return _process_mesh(num_shards, devices)
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


def _process_mesh(num_shards, devices) -> Mesh:
    """The mesh over every process's local shards ``devices`` (a
    collective: every rank calls it)."""
    import torch.distributed as dist

    local = [str(resolve_device(d)) for d in devices]
    if not local:
        raise ValueError("every process of a mesh needs a local shard")
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, local)
    total = sum(len(d) for d in everyone)
    if num_shards is not None and num_shards != total:
        raise ValueError(
            f"requested {num_shards} shards but the processes hold {total}: "
            "a mesh over processes takes every process's local shards")
    me = dist.get_rank()
    devs, ranks = [], []
    for r, ds in enumerate(everyone):
        devs += [resolve_device(d) if r == me else torch.device(d)
                 for d in ds]
        ranks += [r] * len(ds)
    mesh = Mesh(tuple(devs), ranks=tuple(ranks), rank=me)
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
    device (this process's), which ``device`` may name but not
    contradict, and its shard count equal to the partition's pieces."""
    if mesh is None:
        return None, resolve_device(device)
    dev = mesh_device(mesh)
    if device is not None and resolve_device(device) != dev:
        raise ValueError(f"device {device} is not the mesh's device {dev}")
    if partition is not None and num_shards(mesh) != partition.num_pieces:
        raise ValueError("mesh size must equal partition piece count")
    return mesh, dev


# -- pieces over processes ---------------------------------------------------

def spans_processes(mesh) -> bool:
    """Whether ``mesh`` (or None) splits its shards over processes."""
    return mesh is not None and mesh.spans_processes


def refuse_processes(mesh, what: str) -> None:
    """Raise NotImplementedError for ``what`` on a mesh over processes."""
    if spans_processes(mesh):
        raise NotImplementedError(
            f"{what} on a mesh over processes is not ported ({NOT_ACROSS})")


def piece_range(mesh, num_pieces: int) -> Tuple[int, int]:
    """[lo, hi): the pieces of ``num_pieces`` that this process holds (all
    of them without a mesh or on one process)."""
    if not spans_processes(mesh):
        return 0, num_pieces
    return mesh.local_range


def _counts(mesh) -> list:
    """Pieces per rank, in rank order."""
    counts = [0] * (max(mesh.ranks) + 1)
    for r in mesh.ranks:
        counts[r] += 1
    return counts


def full_stack(mesh, t: torch.Tensor) -> torch.Tensor:
    """A stack of this process's pieces ``[S_local, ...]`` placed at its
    rows of a zero ``[S, ...]`` stack (unchanged off a process mesh): a
    reduction per piece over it rounds each piece as the whole mesh's
    stack does on one process, since torch may split a reduction otherwise
    for another number of outputs.  :func:`local_stack` takes the rows
    back."""
    if not spans_processes(mesh):
        return t
    lo, hi = mesh.local_range
    out = t.new_zeros((mesh.size,) + tuple(t.shape[1:]))
    out[lo:hi] = t
    return out


def local_stack(mesh, t: torch.Tensor) -> torch.Tensor:
    """This process's rows ``[lo, hi)`` of a whole mesh's stack."""
    if not spans_processes(mesh):
        return t
    lo, hi = mesh.local_range
    return t[lo:hi]


def gather_pieces(mesh, parts: torch.Tensor) -> torch.Tensor:
    """Per-piece partials ``[S_local, ...]`` of every process gathered into
    the whole mesh's ``[S, ...]`` in piece order, on ``parts``' device (a
    collective through host memory: one message to and from every other
    process, which gloo delivers faster than its ``all_gather``; unchanged
    off a process mesh)."""
    if not spans_processes(mesh):
        return parts
    import torch.distributed as dist

    counts = _counts(mesh)
    host = parts.detach().to("cpu").contiguous()
    bufs = [host if r == mesh.rank else
            host.new_empty((c,) + tuple(host.shape[1:]))
            for r, c in enumerate(counts)]
    reqs = []
    for r in range(len(counts)):
        if r != mesh.rank:
            reqs.append(dist.irecv(bufs[r], r))
            reqs.append(dist.isend(host, r))
    for req in reqs:
        req.wait()
    return torch.cat(bufs).to(parts.device)


def gather_vector(mesh, local: torch.Tensor) -> torch.Tensor:
    """The whole vector, ``[S * B, ...]`` on ``local``'s device, from every
    process's ``[S_local * B, ...]`` pieces (a collective; unchanged off a
    process mesh)."""
    if not spans_processes(mesh):
        return local
    S_loc = mesh.local_size
    blocks = local.reshape(S_loc, local.shape[0] // S_loc,
                           *local.shape[1:])
    whole = gather_pieces(mesh, blocks)
    return whole.reshape(-1, *local.shape[1:])


def shift_pieces(mesh, blocks: torch.Tensor, d: int,
                 wrap: bool = True) -> torch.Tensor:
    """JAX's ``ppermute`` of per-piece blocks along the shard axis: piece
    s's block of the result is piece s - d's block of ``blocks``
    (``[S_local, ...]``, this process's pieces), modulo S with ``wrap``
    (the ring), else zeros where s - d is outside [0, S).  Blocks moving
    within a process are copied on its device; blocks crossing processes
    go through host memory, one message per pair of processes each way,
    sent and received asynchronously and awaited before return (every
    rank takes part in every shift, also with nothing to send)."""
    if not spans_processes(mesh):
        S = blocks.shape[0]
        if wrap:
            return torch.roll(blocks, d, 0)
        out = torch.zeros_like(blocks)
        if 0 < d < S:
            out[d:] = blocks[:S - d]
        elif -S < d < 0:
            out[:S + d] = blocks[-d:]
        elif d == 0:
            out.copy_(blocks)
        return out
    import torch.distributed as dist

    S, (lo, hi) = mesh.size, mesh.local_range
    me, owner = mesh.rank, mesh.ranks
    out = torch.zeros_like(blocks)
    sends, recvs = {}, {}
    for t in range(lo, hi):  # where each of my pieces' blocks goes
        dst = t + d
        if wrap:
            dst %= S
        elif not 0 <= dst < S:
            continue
        if owner[dst] == me:
            out[dst - lo] = blocks[t - lo]
        else:
            sends.setdefault(owner[dst], []).append((dst, t - lo))
    for s in range(lo, hi):  # where each of my pieces' blocks come from
        src = s - d
        if wrap:
            src %= S
        elif not 0 <= src < S:
            continue
        if owner[src] != me:
            recvs.setdefault(owner[src], []).append(s - lo)
    if not sends and not recvs:
        return out
    host = blocks.detach().to("cpu")
    reqs, bufs, held = [], [], []
    for peer in sorted(set(sends) | set(recvs)):
        if peer in recvs:
            buf = host.new_empty((len(recvs[peer]),) + tuple(host.shape[1:]))
            reqs.append(dist.irecv(buf, peer))
            bufs.append((recvs[peer], buf))
        if peer in sends:
            held.append(host[[k for _, k in sorted(sends[peer])]])
            reqs.append(dist.isend(held[-1], peer))
    for req in reqs:
        req.wait()
    for rows, buf in bufs:
        out[rows] = buf.to(out.device)
    return out


def permute_rows(mesh, local: torch.Tensor, index: torch.Tensor):
    """This process's rows of ``x[perm]``, ``x`` the whole flat vector
    whose pieces ``local`` holds and ``index`` this process's rows of the
    padded permutation (``reorder.padded_perm``): the whole vector
    gathered from every process (:func:`gather_vector`, a collective),
    then indexed; off a process mesh ``local[index]``."""
    return gather_vector(mesh, local)[index]


def check_same_on_ranks(mesh, array, what: str) -> None:
    """Raise RuntimeError unless every process holds the same host
    ``array`` (a collective: its digest is gathered from every rank); a
    no-op off a process mesh."""
    if not spans_processes(mesh):
        return
    import numpy as np
    import torch.distributed as dist

    a = np.ascontiguousarray(array)
    digest = hashlib.sha256(
        str((a.dtype.str, a.shape)).encode() + a.tobytes()).hexdigest()
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, digest)
    if len(set(everyone)) != 1:
        raise RuntimeError(f"{what} differs between the processes of the "
                           f"mesh (digests {everyone})")
