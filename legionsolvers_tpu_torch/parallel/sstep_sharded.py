"""Sharded s-step CG: edge fix-ups of the zero-halo K1 and K2 passes.

Port of ``legionsolvers_tpu/parallel/sstep_sharded.py``.  A K1 pass chains
up to four stencil applications, so run on one piece with zero halos it is
wrong within 4 rows of each piece edge, in the output vectors AND in the
Gram vector it emits.  The pass stays zero-halo and everything is repaired
afterwards from 4-row halos of the pass INPUTS, taken before the pass:

* every corrupted quantity (the edge rows of x'', r'', p''; the Gram
  contributions of the outer 4 rows) is recomputed on a 12-row strip in
  torch, once with the true neighbour halos and once with zero halos
  (what the kernel computed), and the difference is patched in;
* wrongness radii: x'' has depth 1, r'' and p'' depth 2, the Gram (through
  A^2 p'') depth 4, and a depth-4 quantity on strip rows [0, 4) reads
  inputs on [-4, 8): the 12-row strip;
* all strip quantities derive from pass inputs, so one exchange per pass
  suffices.

The same strips repair the K2 bootstrap and refresh pass (depth 2 <= 4).

The JAX package writes this algebra for one shard inside ``shard_map``,
with ``ppermute`` for the exchange and ``axis_index`` for the grid's
edges.  The port writes it once over ALL pieces: a piece's halos are
copies of its neighbours' edge rows in fresh ``[S, HALO, C]`` tensors
(zeros at the grid's edges), and the strips of every piece, top and
bottom, true and as the kernel saw them, are stacked into one ``[4 S,
EXT, C]`` batch.  So the torch launches of a fix-up do not grow with S.
The Gram corrections come back per piece (``[S, 10]``); the caller sums
them over the pieces in piece order.  On a mesh over processes (``mesh``)
the S pieces are this process's: the halos cross the processes through
``overlap.exchange_halos``, the edge masks follow the pieces' global
indices, and the Gram sums run at the whole mesh's stack
(``mesh.full_stack``), so that each piece rounds as on one process.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .mesh import full_stack, local_stack, piece_range
from .overlap import exchange_halos

HALO = 4        # pre-exchanged rows per edge (= max application depth)
STRIP = 8       # local rows entering each edge strip
# the widest |dx| of a stencil whose s-step passes run on pieces: the JAX
# package's limit (its PADC - 8, ``parallel/stencil_op.py``
# ``step2_eligible``), kept so that both packages run the same schedule
MAX_DX = 120
EXT = HALO + STRIP

# the order of the stacked strips of one piece in a fix-up's batch
_TRUE_TOP, _KERN_TOP, _TRUE_BOT, _KERN_BOT = range(4)


def _apply(v: torch.Tensor, offs, vals) -> torch.Tensor:
    """One stencil application on ``[..., E, C]`` slabs: out[r, c] = sum_k
    vals[k] * v[r + dy_k, c + dx_k], zero outside the slab's rows and
    outside [0, C), terms summed in offset order."""
    ry = max(abs(dy) for dy, _ in offs)
    rx = max(abs(dx) for _, dx in offs)  # up to C - 1 on the 1-D view
    E, C = v.shape[-2:]
    ext = F.pad(v, (rx, rx, ry, ry))
    acc = None
    for (dy, dx), w in zip(offs, vals):
        sh = ext[..., ry + dy: ry + dy + E, rx + dx: rx + dx + C]
        if acc is None:
            acc = sh if w == 1.0 else (-sh if w == -1.0 else w * sh)
        elif w == 1.0:
            acc = acc + sh
        elif w == -1.0:
            acc = acc - sh
        else:
            acc = acc + w * sh
    return acc


# (left, right) operands of the 10 Gram entries (ops/cuda/stencil2d.
# GRAM_NAMES order) among (r, p, Ap, A2p, Ar)
_GRAM_PAIRS = ((0, 0), (1, 2), (0, 2), (2, 2), (0, 4),
               (2, 4), (2, 3), (4, 4), (4, 3), (3, 3))


def _gram10(rb, pb, Apb, A2pb, Arb) -> torch.Tensor:
    """The 10-entry Gram vector of ``[..., rows, C]`` slabs, ``[..., 10]``,
    each entry an f32 sum of the products."""
    q = (rb, pb, Apb, A2pb, Arb)
    left = torch.stack([q[a] for a, _ in _GRAM_PAIRS], dim=-3)
    right = torch.stack([q[b] for _, b in _GRAM_PAIRS], dim=-3)
    return torch.sum(left * right, dim=(-2, -1), dtype=torch.float32)


def _chain_step2(x_e, r_e, p_e, coef, offs, vals, invalid):
    """All K1 quantities on ``[..., EXT, C]`` slabs.  ``invalid`` is an
    ``[..., EXT]`` 0/1 mask (1 = a row outside the grid) applied after
    every application, as the kernel masks rows outside its grid.  Inputs
    must already be zero on invalid rows.  Returns (xo, rn, pn, Apn, A2pn,
    Arn)."""
    keep = (1.0 - invalid)[..., None].to(r_e.dtype)
    msk = lambda u: u * keep
    c0, c1, c2, c3, c4, c5 = coef.to(r_e.dtype).unbind()
    ap = lambda u: _apply(u, offs, vals)
    s3 = msk(ap(p_e))
    u3 = c0 * p_e + c1 * r_e - c2 * s3
    t2 = msk(ap(u3))
    rn = r_e - t2
    pn = rn + c3 * r_e - c4 * s3 + c5 * p_e
    Apn = msk(ap(pn))
    A2pn = ap(Apn)
    Arn = ap(rn)
    xo = x_e + u3
    return xo, rn, pn, Apn, A2pn, Arn


def _chain_gram2(r_e, p_e, offs, vals, invalid):
    """K2 quantities on ``[..., EXT, C]`` slabs: (r, p, Ap, A2p, Ar)."""
    keep = (1.0 - invalid)[..., None].to(r_e.dtype)
    ap = lambda u: _apply(u, offs, vals)
    Ap = ap(p_e) * keep
    A2p = ap(Ap)
    Ar = ap(r_e)
    return r_e, p_e, Ap, A2p, Ar


def _pieces(g: torch.Tensor, S: int) -> torch.Tensor:
    """The ``[S, Br, C]`` view of a grid ``[S * Br, C]``."""
    return g.view(S, g.shape[0] // S, g.shape[1])


def exchange_halo4(r, p, S, mesh=None) -> Tuple:
    """(r_top, p_top, r_bot, p_bot), each ``[S, HALO, C]``: the HALO rows of
    r and p above and below every piece of the grids r and p ``[S * Br,
    C]``, copied out of the neighbouring pieces into fresh tensors, zeros
    at the grid's first and last edge (``overlap.exchange_halos``)."""
    (rt, pt), (rb, pb) = exchange_halos((r, p), S, HALO, HALO, HALO,
                                        mesh=mesh)
    return rt, pt, rb, pb


def _edge_masks(Br: int, is_first, is_last, dtype, device=None):
    """(invalid_true_top, invalid_kern_top, invalid_true_bot,
    invalid_kern_bot), ``[..., EXT]`` 0/1 masks for pieces whose
    ``is_first``/``is_last`` (bools or bool tensors ``[S]``) say whether
    they hold the grid's first/last rows.  The kernel ALWAYS masks at the
    piece's bounds (it sees only the piece); the truth masks only at the
    grid's edges."""
    rows_t = torch.arange(-HALO, STRIP, device=device)
    rows_b = torch.arange(Br - STRIP, Br + HALO, device=device)
    kern_t = (rows_t < 0).to(dtype)
    kern_b = (rows_b >= Br).to(dtype)
    first = torch.as_tensor(is_first, device=device)[..., None]
    last = torch.as_tensor(is_last, device=device)[..., None]
    true_t = torch.where(first, kern_t, torch.zeros_like(kern_t))
    true_b = torch.where(last, kern_b, torch.zeros_like(kern_b))
    return true_t, kern_t.expand_as(true_t), true_b, kern_b.expand_as(true_b)


_BATCH = {}


def _batch_consts(S: int, Br: int, C: int, dtype, device, mesh=None):
    """(zero ``[S, HALO, C]`` block, ``[4 S, EXT]`` invalid mask of the
    stacked strips), made once per geometry and never written.  The
    grid's first and last piece by global index (``mesh``: the S pieces
    are a process's)."""
    lo, _ = piece_range(mesh, S)
    total = S if mesh is None else mesh.size
    key = (S, Br, C, dtype, device, lo, total)
    consts = _BATCH.get(key)
    if consts is None:
        index = torch.arange(lo, lo + S, device=device)
        masks = _edge_masks(Br, index == 0, index == total - 1, dtype,
                            device)
        invalid = torch.stack(masks, 1).reshape(4 * S, EXT)
        consts = (torch.zeros(S, HALO, C, dtype=dtype, device=device),
                  invalid)
        _BATCH[key] = consts
    return consts


def _stack_strips(z4, top_halo, top, bot, bot_halo):
    """The ``[4 S, EXT, C]`` batch of the strips of every piece, in the
    order true top, kernel top, true bottom, kernel bottom: the ``[S,
    STRIP, C]`` edge rows ``top``/``bot`` with their ``[S, HALO, C]``
    halos, true and zero."""
    S, _, C = top.shape
    return torch.cat([top_halo, top, z4, top, bot, bot_halo, bot, z4],
                     1).view(4 * S, EXT, C)


def _gram_fix(g, q, mesh=None):
    """g ``[S, 10]`` plus the true minus the kernel's Gram contributions of
    each piece's outer 4 rows, top then bottom, in the JAX package's
    order; ``q`` holds the batch's (r, p, Ap, A2p, Ar)."""
    S = g.shape[0]
    rows = [full_stack(mesh, t[:, HALO: 2 * HALO].reshape(S, 4, HALO, -1))
            for t in q]
    G = local_stack(mesh, _gram10(*(t.reshape(-1, HALO, t.shape[-1])
                                    for t in rows)).view(-1, 4, 10))
    return (g + G[:, _TRUE_TOP] - G[:, _KERN_TOP] + G[:, _TRUE_BOT]
            - G[:, _KERN_BOT])


def step2_fixup(outs, saves, halos, coef, offs, vals, S, mesh=None):
    """Repair the S zero-halo K1 passes of one s-step pass.

    outs  = (x_out, r_out, p_out, g): the passes' grids ``[S * Br, C]``
            (repaired in place) and their Gram vectors ``[S, 10]``;
    saves = (x_t, r_t, p_t, x_b, r_b, p_b): every piece's first and last
            STRIP rows of the pass INPUTS, ``[S, STRIP, C]``, taken before
            the passes (x'' is written over x);
    halos = :func:`exchange_halo4` of the pass inputs.
    ``mesh``: the S pieces are this process's of a mesh over processes.
    Returns (x_out, r_out, p_out, g) repaired, g per piece ``[S, 10]``."""
    x_out, r_out, p_out, g = outs
    x_t, r_t, p_t, x_b, r_b, p_b = saves
    rt4, pt4, rb4, pb4 = halos
    Br = x_out.shape[0] // S
    z4, invalid = _batch_consts(S, Br, x_out.shape[1], x_out.dtype,
                                x_out.device, mesh)
    # the halos are zero at the grid's edges already, where the truth masks
    # its rows out
    xe = _stack_strips(z4, z4, x_t, x_b, z4)
    re = _stack_strips(z4, rt4, r_t, r_b, rb4)
    pe = _stack_strips(z4, pt4, p_t, p_b, pb4)
    q = [t.view(S, 4, EXT, -1)
         for t in _chain_step2(xe, re, pe, coef, offs, vals, invalid)]
    x3, r3, p3 = (_pieces(t, S) for t in (x_out, r_out, p_out))
    x3[:, 0:1] = q[0][:, _TRUE_TOP, HALO: HALO + 1]
    r3[:, 0:2] = q[1][:, _TRUE_TOP, HALO: HALO + 2]
    p3[:, 0:2] = q[2][:, _TRUE_TOP, HALO: HALO + 2]
    x3[:, Br - 1:] = q[0][:, _TRUE_BOT, STRIP - 1: STRIP]
    r3[:, Br - 2:] = q[1][:, _TRUE_BOT, STRIP - 2: STRIP]
    p3[:, Br - 2:] = q[2][:, _TRUE_BOT, STRIP - 2: STRIP]
    g = _gram_fix(g, [t.reshape(4 * S, EXT, -1) for t in q[1:]], mesh)
    return x_out, r_out, p_out, g


def gram2_fixup(g, r, p, halos, offs, vals, S, mesh=None):
    """Repair the S zero-halo K2 passes over the grids r and p ``[S * Br,
    C]``: the corrupted contributions have depth <= 2, inside the step2
    strips, so the same 12-row strips are recomputed.  g: ``[S, 10]``."""
    rt4, pt4, rb4, pb4 = halos
    r3, p3 = _pieces(r, S), _pieces(p, S)
    Br = r3.shape[1]
    z4, invalid = _batch_consts(S, Br, r.shape[1], r.dtype, r.device, mesh)
    re = _stack_strips(z4, rt4, r3[:, :STRIP], r3[:, Br - STRIP:], rb4)
    pe = _stack_strips(z4, pt4, p3[:, :STRIP], p3[:, Br - STRIP:], pb4)
    return _gram_fix(g, _chain_gram2(re, pe, offs, vals, invalid), mesh)
