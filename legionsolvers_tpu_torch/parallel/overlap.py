"""Edge fix-ups of zero-halo stencil passes.

Port of ``legionsolvers_tpu/parallel/overlap.py``.  The JAX package runs the
kernel pass of a sharded matvec with ZERO halo blocks, so that the pass
does not depend on the halo exchange and XLA can fly the exchange under
it, then adds the terms the pass left out at the block edges.  The port
keeps the same algebra: each piece's kernel pass runs with zero halos and
these functions patch its first and last rows from the halo blocks copied
out of the neighbouring pieces (``parallel/stencil_op.py``).  On one card
and one stream nothing overlaps yet; the structure is the JAX package's.

Layout as for the kernels: a piece is an ``[Br, C]`` grid; halo ``top`` is
an ``[8, C]`` block whose LAST ``rlo`` rows are the upper neighbour's edge
rows, ``bot``'s FIRST ``rhi`` rows the lower neighbour's; both are zeros at
the grid's edges.  Every function also takes a stack of pieces, ``[S, Br,
C]`` with ``[S, 8, C]`` halos, and then works on all pieces at once (one
set of torch launches for any S); dots then come back per piece, ``[S]``.
On a mesh over processes (``mesh``) the stack holds this process's pieces
only, and the rows and windows that cross a process boundary come through
``parallel/mesh.shift_pieces``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import (
    full_stack,
    gather_vector,
    local_stack,
    piece_range,
    shift_pieces,
    spans_processes,
)


def colshift(rows2d: torch.Tensor, dx: int) -> torch.Tensor:
    """Shift columns by ``dx`` with zero fill: out[..., c] = rows2d[...,
    c + dx] where 0 <= c + dx < C, else 0.  Any |dx| < C."""
    C = rows2d.shape[-1]
    if dx == 0:
        return rows2d
    if dx >= C or dx <= -C:
        return torch.zeros_like(rows2d)
    if dx > 0:
        return F.pad(rows2d[..., dx:], (0, dx))
    return F.pad(rows2d[..., : C + dx], (-dx, 0))


def exchange_halos(grids, S: int, rows_top: int, rows_bot: int,
                   depth: int = 8, mesh=None):
    """(tops, bots): per grid of S pieces (``[S * Br, C]``), its ``[S,
    depth, C]`` halo blocks.  A top block's LAST ``rows_top`` rows are the
    rows above the piece, copied out of the piece before it; a bottom
    block's FIRST ``rows_bot`` rows are the rows below it, from the piece
    after it; every other row, and the grid's edges, are zeros.  The blocks
    of all grids are cut from one fresh tensor per side, so an exchange
    takes four torch launches for any number of grids and pieces; piece
    ``s``'s block is a contiguous ``[depth, C]`` tensor that shares no
    storage with the grids.  Taken before any piece's pass writes.  On a
    mesh over processes the S pieces are this process's: the first one's
    top rows come from the previous process and the last one's bottom
    rows from the next (one shift each way, zeros at the grid's edges)."""
    C = grids[0].shape[-1]
    g3 = [g.view(S, -1, C) for g in grids]
    across = spans_processes(mesh)

    def side(rows, top):
        if rows == 0:
            return grids[0].new_zeros(S, len(grids), depth, C).unbind(1)
        if across:
            edge = torch.stack([t[:, -rows:] if top else t[:, :rows]
                                for t in g3], 1)
            edge = shift_pieces(mesh, edge, 1 if top else -1, wrap=False)
            pad = (0, 0, depth - rows, 0) if top else (0, 0, 0, depth - rows)
            return F.pad(edge, pad).unbind(1)
        edge = torch.stack([t[:-1, -rows:] if top else t[1:, :rows]
                            for t in g3], 1)
        pad = ((0, 0, depth - rows, 0, 0, 0, 1, 0) if top
               else (0, 0, 0, depth - rows, 0, 0, 0, 1))
        return F.pad(edge, pad).unbind(1)

    return side(rows_top, True), side(rows_bot, False)


def piece_windows(x: torch.Tensor, S: int, lo: int, hi: int, wide: bool,
                  cache: dict, mesh=None) -> torch.Tensor:
    """``[S, lo + B + hi]``: each piece's block of the flat vector ``x``
    (``S`` pieces of ``B``) with the ``lo`` entries before it and the
    ``hi`` after it, for the linearized paths on pieces.  From the
    neighbouring pieces (piece 0's tail from the last piece's end, as the
    JAX package's ring of ppermutes delivers it; such entries meet zero
    coefficients), or, where the band is wider than a block (``wide``),
    gathered from the whole vector modulo its size (JAX's all_gather),
    the index kept in ``cache`` per device.  On a mesh over processes
    ``x`` and the S pieces are this process's: the ring and the gather
    cross the processes (``mesh.shift_pieces``, ``mesh.gather_vector``)."""
    B = x.numel() // S
    if not wide:
        x2 = x.view(S, B)
        parts = [x2]
        if lo:
            parts.insert(0, shift_pieces(mesh, x2[:, B - lo:], 1))
        if hi:
            parts.append(shift_pieces(mesh, x2[:, :hi], -1))
        return torch.cat(parts, 1) if len(parts) > 1 else x2
    key = ("window", x.device)
    idx = cache.get(key)
    first, _ = piece_range(mesh, S)
    whole = gather_vector(mesh, x)
    if idx is None:
        idx = (torch.arange(B + lo + hi, device=x.device)
               + (torch.arange(first, first + S, device=x.device) * B
                  - lo)[:, None]) % whole.numel()
        cache[key] = idx
    return whole[idx]


def edge_missing(offsets, top, bot, Br: int, coeff):
    """The contributions a zero-halo stencil pass omitted at the block
    edges.  ``coeff(k, row_slice)`` is the multiplier of offset ``k`` on
    ``row_slice`` of the output rows (a scalar for a constant stencil).
    Returns (miss_top, miss_bot): ``[..., rlo, C]`` additions to y[0:rlo]
    and ``[..., rhi, C]`` additions to y[Br - rhi:], either possibly None."""
    rlo = max(0, -min(dy for dy, _ in offsets))
    rhi = max(0, max(dy for dy, _ in offsets))
    miss_top = None
    miss_bot = None
    for k, (dy, dx) in enumerate(offsets):
        if dy < 0:
            # y[r] needs x[r + dy] for r in [0, -dy): rows top[8 + dy + r]
            term = coeff(k, slice(0, -dy)) * colshift(top[..., 8 + dy: 8, :],
                                                     dx)
            if rlo + dy:
                term = F.pad(term, (0, 0, 0, rlo + dy))
            miss_top = term if miss_top is None else miss_top + term
        elif dy > 0:
            # y[r] needs x[r + dy] for r in [Br - dy, Br): rows bot[0:dy]
            term = coeff(k, slice(Br - dy, Br)) * colshift(bot[..., 0:dy, :],
                                                          dx)
            if rhi - dy:
                term = F.pad(term, (0, 0, rhi - dy, 0))
            miss_bot = term if miss_bot is None else miss_bot + term
    return miss_top, miss_bot


def apply_edge_fixup(y: torch.Tensor, offsets, top, bot, coeff,
                     missing=None):
    """y (a zero-halo pass's output, ``[..., Br, C]``) plus the omitted
    edge terms, added in place.  ``missing``: :func:`edge_missing`'s
    result when the caller has it already."""
    Br = y.shape[-2]
    miss_top, miss_bot = missing or edge_missing(offsets, top, bot, Br,
                                                 coeff)
    if miss_top is not None:
        y[..., : miss_top.shape[-2], :] += miss_top
    if miss_bot is not None:
        y[..., Br - miss_bot.shape[-2]:, :] += miss_bot
    return y


def dot_fixup(x: torch.Tensor, offsets, top, bot, coeff,
              missing=None, mesh=None) -> torch.Tensor:
    """Correction to a fused <x, A x> of a zero-halo pass: the sum over
    the edge rows of x * (the omitted A x terms), in f32; one per piece
    for a stack.  ``missing`` as for :func:`apply_edge_fixup`.  On a mesh
    over processes the stack's sums run at the whole mesh's stack
    (``mesh.full_stack``), so each piece rounds as on one process."""
    Br = x.shape[-2]
    miss_top, miss_bot = missing or edge_missing(offsets, top, bot, Br,
                                                 coeff)
    fix = torch.zeros(x.shape[:-2], dtype=torch.float32, device=x.device)

    def edge_sum(t):
        return local_stack(mesh, torch.sum(full_stack(mesh, t),
                                           dim=(-2, -1), dtype=torch.float32))

    if miss_top is not None:
        k = miss_top.shape[-2]
        fix = fix + edge_sum(x[..., :k, :] * miss_top)
    if miss_bot is not None:
        k = miss_bot.shape[-2]
        fix = fix + edge_sum(x[..., Br - k:, :] * miss_bot)
    return fix
