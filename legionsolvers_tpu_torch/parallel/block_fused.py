"""Fused multi-space (block-system) solver schedules.

Port of ``legionsolvers_tpu/parallel/block_fused.py``.  The reference's
benchmark default stress configuration registers the same matrix once per
space over two sol/rhs spaces (reference:
BenchmarkStencil.cpp:201-207): a block-diagonal system.  A Krylov
iteration on diag(A_0 .. A_{S-1}) is the SAME per-space kernel passes with
the scalar reductions summed across spaces, because every dot of a block
vector is the sum of its per-space dots:

    global CG/BiCGStab on  diag(A_0 .. A_{S-1})
  = per-space passes + cross-space scalar sums between them,

exactly; the spaces are coupled only through alpha, beta and omega.  Each
fused schedule of ``parallel/stencil_op.py`` is cut into per-space
*phases* at its reduction boundaries, and one loop drives all spaces,
summing each reduction over the spaces in space order before the
coefficients are formed:

* CG s-step: gram (K2) / step2 (K1) / odd_update (K3 ``update`` plus a
  torch xpay), the summed Gram feeding one ``cg2_coeffs`` per pass (the
  per-space Gram matrices of {r, Ar, p, Ap, A^2p} sum to the block
  system's);
* CG two-pass: prologue (K3 ``pq``) / xpay_pq (K4) / update (K3
  ``update``), on the 3-D view K6a ``pq`` / K6b / K6a ``update``;
* BiCGStab: pv / st / update (K5a-c in 2-D, K7 in 3-D), cut at the
  rtv -> alpha, (ts, tt) -> omega and (rr, rtr) boundaries;
* torch phases from the operator's matvec (any geometry and dtype, the
  float64 golden path); names ``_cg_jnp_phases``/``_bicg_jnp_phases``
  kept from the JAX package.

Per space, the phases keep what the single-space runners keep: K1's
ping-pong spares, BiCGStab's spare buffers (no pass writes a buffer that
another block of the same launch reads as a halo) and each wrapper's
``out=`` contract.  Scalars: float64 systems carry float64 scalars and
history, everything else the kernels' float32.  A compensated dot
(``SolverOptions(compensated_dots=True)``) is, per space, one rounding of
a float64 sum; the cross-space sum of such dots is taken in float64 and
rounded once, so the block sum adds no float32 rounding per space.

Spaces of several pieces (on a mesh, every space with the same piece
count) run each phase with the multi-piece steps of their operator
(``StencilOperator._*_pieces``): the zero-halo 2-D passes with their edge
fix-ups (``parallel/overlap.py``, ``parallel/sstep_sharded.py``), the 3-D
passes on their neighbours' halo planes, and the torch phases' dots per
piece.  Sums: a phase returns its space's reduction summed over the
space's pieces in piece order, and the runner adds the spaces' totals in
space order (``mesh.ordered_sum``), as the JAX package's phases ``psum``
over the pieces before its runner adds the spaces.  On a mesh over
processes a space's total is its pieces' partials gathered from every
process first, so every rank adds the same totals and the block runners
are the one-process mesh's bit for bit.  Several pieces without a mesh
raise ValueError (:func:`_wrap`).
"""

from __future__ import annotations

import os

import torch

from .mesh import ordered_sum

# ======================================================================
# per-space phase builders
# ======================================================================

class _Phases:
    """Plain namespace; one instance per space."""


def _io(ph, grid_in):
    """The phases' layout: ``grid_in`` to the phases' own, ``grid_out``
    back to the caller's."""
    ph.grid_in = grid_in
    ph.grid_out = lambda a, ref: a.reshape(ref.shape)


def _flat(a):
    return a.reshape(-1)


def _cg_jnp_phases(op):
    """Fallback CG phases from the operator's matvec (the classic schedule,
    q stored), in the arithmetic order of ``_make_jnp_cg_runner`` so that
    float64 golden trajectories survive; on pieces the dots per piece,
    summed in piece order."""
    ph = _Phases()
    _io(ph, _flat)
    ph.start = lambda x, r, p: None
    dot = op._piece_dot

    def prologue(p):
        q = op.matvec(p)
        return dot(p, q), q

    def xpay_pq(r, p, beta):
        p = r + beta.to(p.dtype) * p
        q = op.matvec(p)
        return p, dot(p, q), q

    def update(p, x, r, alpha, q):
        a = alpha.to(p.dtype)
        x = x + a * p
        r = r - a * q
        return x, r, dot(r, r)

    ph.prologue, ph.xpay_pq, ph.update = prologue, xpay_pq, update
    return ph


def _two_pass_phases(op, cg_pq, cg_update, cg_xpay_pq, pieces):
    """Two-pass CG phases on the given pass wrappers (2-D or 3-D, which
    take the same arguments), as ``StencilOperator._two_pass_cg_runner``
    drives them: x and r in place, p alternating with one spare.  On
    several pieces the operator's per-piece steps ``pieces`` = (pq,
    xpay_pq, update), as its ``_sharded_two_pass_cg_runner`` drives them;
    their halo blocks or planes are the phases' context."""
    kw = op._kw()
    ph = _Phases()
    _io(ph, op._grid)

    def start(x, r, p):
        ph.spare = torch.empty_like(p)

    if op._sharded:
        pq_pieces, xpay_pq_pieces, update_pieces = pieces

        def xpay_pq(r, p, beta):
            pn, pq, halos = xpay_pq_pieces(r, p, beta, ph.spare)
            ph.spare = p
            return pn, pq, halos

        def update(p, x, r, alpha, halos):
            return x, r, update_pieces(p, x, r, alpha, halos)

        ph.start, ph.prologue, ph.xpay_pq, ph.update = (start, pq_pieces,
                                                        xpay_pq, update)
        return ph

    def prologue(p):
        return cg_pq(p, **kw), None

    def xpay_pq(r, p, beta):
        pn, pq = cg_xpay_pq(r, p, beta, out=ph.spare, **kw)
        ph.spare = p
        return pn, pq, None

    def update(p, x, r, alpha, ctx):
        return cg_update(p, x, r, alpha, **kw)

    ph.start, ph.prologue, ph.xpay_pq, ph.update = (start, prologue,
                                                    xpay_pq, update)
    return ph


def _cg_2d_phases(op):
    """Two-pass phases on the 2-D view: K3 ``pq``, K4, K3 ``update``
    (on pieces zero-halo, with their edge fix-ups)."""
    from ..ops.cuda.stencil2d import (
        grid2d_cg_pq,
        grid2d_cg_update,
        grid2d_cg_xpay_pq,
    )

    return _two_pass_phases(op, grid2d_cg_pq, grid2d_cg_update,
                            grid2d_cg_xpay_pq, (op._pq_pieces,
                                                op._xpay_pq_pieces,
                                                op._update_pieces))


def _cg_3d_phases(op):
    """Two-pass phases on the 3-D view: K6a ``pq``, K6b, K6a ``update``
    (on pieces with their neighbours' halo planes)."""
    from ..ops.cuda.stencil3d import (
        grid3d_cg_pq,
        grid3d_cg_update,
        grid3d_cg_xpay_pq,
    )

    return _two_pass_phases(op, grid3d_cg_pq, grid3d_cg_update,
                            grid3d_cg_xpay_pq, (op._pq3d_pieces,
                                                op._xpay_pq3d_pieces,
                                                op._update3d_pieces))


def _cg_step2_phases(op):
    """s-step CG phases (mirrors ``_make_step2_cg_runner``): the K2 Gram
    bootstrap and refresh, the K1 pass with r and p ping-ponging with one
    pair of spares, and the odd trailing iteration's K3 ``update``; on
    pieces the operator's zero-halo steps with their strip fix-ups
    (``_gram2_pieces``, ``_step2_pieces``, ``_odd_update_pieces``)."""
    from ..ops.cuda.stencil2d import (
        grid2d_cg_gram2,
        grid2d_cg_step2,
        grid2d_cg_update,
    )

    kw = op._kw()
    ph = _Phases()
    _io(ph, op._grid)

    def start(x, r, p):
        ph.spare = (torch.empty_like(r), torch.empty_like(p))

    sharded = op._sharded

    def gram(r, p):
        if sharded:
            return op._gram2_pieces(r, p)
        return grid2d_cg_gram2(r, p, **kw)

    def step2(x, r, p, coef):
        if sharded:
            _, rn, pn, g = op._step2_pieces(x, r, p, coef, ph.spare)
        else:
            _, rn, pn, g = grid2d_cg_step2(x, r, p, coef, out=ph.spare,
                                           **kw)
        ph.spare = (r, p)
        return x, rn, pn, g

    def odd_update(p, x, r, alpha):
        """One plain CG update from the current p: (x, r, <r, r>)."""
        if sharded:
            return x, r, op._odd_update_pieces(p, x, r, alpha)
        return grid2d_cg_update(p, x, r, alpha, **kw)

    ph.start, ph.gram, ph.step2, ph.odd_update = start, gram, step2, \
        odd_update
    return ph


def _bicg_jnp_phases(op):
    """Fallback BiCGStab phases from the operator's matvec (s and t
    stored; the classic schedule, any geometry and dtype), dots summed in
    the entry dtype (on pieces per piece, in piece order)."""
    ph = _Phases()
    _io(ph, _flat)
    ph.start = lambda r, p, v: None
    ph.compensated = False

    dot = op._piece_dot

    def boot(r, rt):
        return dot(r, r), dot(rt, r)

    def pv(r, p, v, rt, beta, omega):
        p = r + beta.to(p.dtype) * (p - omega.to(p.dtype) * v)
        v = op.matvec(p)
        return p, v, dot(rt, v)

    def st(r, v, alpha):
        s = r - alpha.to(r.dtype) * v
        t = op.matvec(s)
        return dot(t, s), dot(t, t), (s, t)

    def update(r, v, x, p, rt, alpha, omega, ctx):
        s, t = ctx
        a = alpha.to(x.dtype)
        w = omega.to(x.dtype)
        x = x + a * p + w * s
        r = s - w * t
        return x, r, dot(r, r), dot(rt, r)

    ph.boot, ph.pv, ph.st, ph.update = boot, pv, st, update
    return ph


def _bicg_fused_phases(op, pv, st, update):
    """Three-pass BiCGStab phases on the given pass wrappers (2-D or 3-D),
    as ``StencilOperator._bicgstab_runner`` drives them: x in place, p, v
    and r alternating with spares.  On several pieces (2-D only) the
    operator's zero-halo steps with their edge fix-ups, as its
    ``_sharded_bicgstab_runner`` drives them; the pv step's derived halo
    rows and p' are kept for the st step."""
    from ..ops.cuda.bicgstab2d import _pdot

    comp = bool(op.options.compensated_dots)
    kw = dict(op._kw(), compensated=comp)
    sharded = op._sharded
    ph = _Phases()
    _io(ph, op._grid)
    ph.compensated = comp

    def start(r, p, v):
        ph.spare_r, ph.spare_p, ph.spare_v = (torch.empty_like(a)
                                              for a in (r, p, v))

    def boot(r, rt):
        if sharded:
            return op._bicg_boot_pieces(r, rt)
        return _pdot(r, r, comp), _pdot(rt, r, comp)

    def pv_(r, p, v, rt, beta, omega):
        out = (ph.spare_p, ph.spare_v)
        if sharded:
            pn, vn, rtv, ph.pv_ctx = op._bicg_pv_pieces(r, p, v, rt, beta,
                                                        omega, out)
            ph.pn = pn
        else:
            pn, vn, rtv = pv(r, p, v, rt, beta, omega, out=out, **kw)
        ph.spare_p, ph.spare_v = p, v
        return pn, vn, rtv

    def st_(r, v, alpha):
        if sharded:
            return op._bicg_st_pieces(r, v, ph.pn, alpha, ph.pv_ctx)
        ts, tt = st(r, v, alpha, **kw)
        return ts, tt, None

    def update_(r, v, x, p, rt, alpha, omega, ctx):
        if sharded:
            _, rn, rr, rtr = op._bicg_update_pieces(r, v, x, p, rt, alpha,
                                                    omega, ctx, ph.spare_r)
        else:
            _, rn, rr, rtr = update(r, v, x, p, rt, alpha, omega,
                                    out=ph.spare_r, **kw)
        ph.spare_r = r
        return x, rn, rr, rtr

    ph.start, ph.boot, ph.pv, ph.st, ph.update = (start, boot, pv_, st_,
                                                  update_)
    return ph


def _bicg_2d_phases(op):
    """Three-pass phases on the 2-D view: K5a, K5b, K5c."""
    from ..ops.cuda.bicgstab2d import bicg_pv, bicg_st, bicg_update

    return _bicg_fused_phases(op, bicg_pv, bicg_st, bicg_update)


def _bicg_3d_phases(op):
    """Three-pass phases on the 3-D view: K7 pv, st, update."""
    from ..ops.cuda.bicgstab3d import bicg3d_pv, bicg3d_st, bicg3d_update

    return _bicg_fused_phases(op, bicg3d_pv, bicg3d_st, bicg3d_update)


# ======================================================================
# phase selection
# ======================================================================

def diagonal_block_ops(planner):
    """Per-space operator list when the system is block-diagonal with
    exactly one operator per space (dom == rng == space), else None."""
    if len(planner.row_partitioned_matrices) != planner.num_spaces:
        return None
    ops = [None] * planner.num_spaces
    for op, di, ri in planner.row_partitioned_matrices:
        if di != ri or ops[ri] is not None:
            return None
        ops[ri] = op
    return ops


def _is_stencil_like(op):
    from .stencil_op import StencilOperator

    return isinstance(op, StencilOperator)


def _same_pieces(ops) -> bool:
    """All operators on one piece count, and a mesh where it is > 1."""
    S0 = ops[0].partition.num_pieces
    if any(op.partition.num_pieces != S0 for op in ops):
        return False
    return not (S0 > 1 and any(op.mesh is None for op in ops))


def block_cg_supported(ops) -> bool:
    """All diagonal-block operators must be stencil operators sharing one
    piece count and each supporting a fused CG schedule."""
    if os.environ.get("LEGIONSOLVERS_NO_BLOCK_FUSED"):
        return False
    if not ops or not all(_is_stencil_like(op) for op in ops):
        return False
    if not all(getattr(op, "supports_fused_cg", False) for op in ops):
        return False
    return _same_pieces(ops)


def block_bicgstab_supported(ops) -> bool:
    """All diagonal-block operators must be stencil operators sharing one
    piece count.  Per space the three fused passes run where the operator
    supports them and the torch phases otherwise; mixtures are fine (the
    phases share signatures)."""
    if os.environ.get("LEGIONSOLVERS_NO_BLOCK_FUSED"):
        return False
    if not ops or not all(_is_stencil_like(op) for op in ops):
        return False
    return _same_pieces(ops)


def _cg_phases_for(op):
    v = op._view
    if v is None:
        return _cg_jnp_phases(op)
    if v["kind"] == "3d":
        return _cg_3d_phases(op)
    return _cg_2d_phases(op)


def _bicg_phases_for(op):
    if getattr(op, "supports_fused_bicgstab", False):
        if op._view["kind"] == "3d":
            return _bicg_3d_phases(op)
        return _bicg_2d_phases(op)
    return _bicg_jnp_phases(op)


# ======================================================================
# block runners
# ======================================================================

def _scalar_dtype(arrs):
    """float64 systems (the golden path) carry float64 reductions and
    history like the transcription; everything else the kernels' float32
    scalars."""
    if all(a.dtype == torch.float64 for a in arrs):
        return torch.float64
    return torch.float32


def _wrap(ops, local_run):
    """The runner over per-space tuples: the loop itself.  Every phase of
    a space of several pieces runs its operator's per-piece steps, which
    need a mesh (several pieces without one raise ValueError, as the
    single-space fused runners do)."""
    if any(op.partition.num_pieces > 1 and op.mesh is None for op in ops):
        raise ValueError("a block runner over spaces of several pieces "
                         "needs a mesh")
    return local_run


def _grid_in(phases, arrs):
    return [ph.grid_in(a) for ph, a in zip(phases, arrs)]


def _grid_out(phases, arrs, refs):
    return tuple(ph.grid_out(a, ref)
                 for ph, a, ref in zip(phases, arrs, refs))


def make_block_cg_runner(ops, num_iterations: int):
    """Whole-loop CG over a block-diagonal multi-space system.

    Contract: ``run(xs, rs, ps, rr0) -> (xs, rs, ps, history)`` with tuples
    of per-space tensors (flat or grid layout; outputs take the input
    layout) and the GLOBAL rr0 = the sum of the per-space <r, r>;
    history[0] = rr0.  An exact continuation of the planner transcription
    of CG on the block system from any state (coefficients from
    cross-space-summed reductions).  The s-step schedule runs when EVERY
    space is ``step2_eligible``, otherwise per-space two-pass / 3-D /
    torch phases (mixtures allowed).  The inputs are consumed as by the
    single-space runners (x and r updated in place, p and r ping-ponging
    with spares), so they must share no storage with anything the caller
    keeps."""
    if num_iterations < 1:
        raise ValueError("block CG runner needs at least one iteration")
    if num_iterations >= 2 and all(
        getattr(op, "step2_eligible", False) for op in ops
    ):
        return _make_block_step2_runner(ops, num_iterations)
    phases = [_cg_phases_for(op) for op in ops]
    spaces = range(len(ops))

    def local_run(xs, rs, ps, rr0):
        refs = xs
        xs, rs, ps = (_grid_in(phases, a) for a in (xs, rs, ps))
        for ph, x, r, p in zip(phases, xs, rs, ps):
            ph.start(x, r, p)
        sdt = _scalar_dtype(xs)
        rr = torch.as_tensor(rr0).to(device=xs[0].device, dtype=sdt)
        hist = [rr]

        def update_all(alpha, ctxs):
            parts = []
            for s in spaces:
                xs[s], rs[s], rr_s = phases[s].update(ps[s], xs[s], rs[s],
                                                      alpha, ctxs[s])
                parts.append(rr_s)
            return ordered_sum(parts, sdt)

        # iteration 0 with the incoming p
        pqs, ctxs = zip(*(phases[s].prologue(ps[s]) for s in spaces))
        rr_new = update_all(rr / ordered_sum(pqs, sdt), ctxs)
        hist.append(rr_new)
        for _ in range(1, num_iterations):
            rr_prev, rr = rr, rr_new
            beta = rr / rr_prev
            pqs, ctxs = [], []
            for s in spaces:
                ps[s], pq_s, ctx = phases[s].xpay_pq(rs[s], ps[s], beta)
                pqs.append(pq_s)
                ctxs.append(ctx)
            rr_new = update_all(rr / ordered_sum(pqs, sdt), ctxs)
            hist.append(rr_new)
        return (_grid_out(phases, xs, refs), _grid_out(phases, rs, refs),
                _grid_out(phases, ps, refs), torch.stack(hist))

    return _wrap(ops, local_run)


def _make_block_step2_runner(ops, num_iterations: int):
    """s-step block CG: the per-space Gram vectors sum to the block
    system's, so one ``cg2_coeffs`` of the summed Gram per pass yields the
    exact block-CG coefficients of both iterations of the pass.  Every
    LEGIONSOLVERS_SSTEP_REFRESH passes (default 16; 0 disables) the Gram
    is measured again by K2, as in the single-space runner."""
    from ..ops.cuda.stencil2d import cg2_coeffs

    phases = [_cg_step2_phases(op) for op in ops]
    spaces = range(len(ops))
    K, odd = divmod(num_iterations, 2)
    refresh = int(os.environ.get("LEGIONSOLVERS_SSTEP_REFRESH", "16"))
    f32 = torch.float32

    def local_run(xs, rs, ps, rr0):
        refs = xs
        xs, rs, ps = (_grid_in(phases, a) for a in (xs, rs, ps))
        for ph, x, r, p in zip(phases, xs, rs, ps):
            ph.start(x, r, p)
        hist = [torch.as_tensor(rr0).to(device=xs[0].device, dtype=f32)]

        def gram_all():
            return ordered_sum([phases[s].gram(rs[s], ps[s])
                                for s in spaces], f32)

        def passes(g, count):
            for _ in range(count):
                coef, rr1, _ = cg2_coeffs(g)
                parts = []
                for s in spaces:
                    xs[s], rs[s], ps[s], g_s = phases[s].step2(
                        xs[s], rs[s], ps[s], coef)
                    parts.append(g_s)
                g = ordered_sum(parts, f32)
                hist.extend((rr1, g[0]))
            return g

        g = gram_all()
        if refresh > 0 and K > refresh:
            n_blocks, rem = divmod(K, refresh)
            g = passes(g, refresh)
            for _ in range(n_blocks - 1):
                g = passes(gram_all(), refresh)
            if rem:
                g = passes(gram_all(), rem)
        else:
            g = passes(g, K)
        if odd:
            alpha = g[0] / g[1]
            parts = []
            for s in spaces:
                xs[s], rs[s], rr_s = phases[s].odd_update(ps[s], xs[s],
                                                          rs[s], alpha)
                parts.append(rr_s)
            rr_new = ordered_sum(parts, f32)
            hist.append(rr_new)
            bb = rr_new / g[0]
            for s in spaces:
                ps[s] = rs[s] + bb.to(ps[s].dtype) * ps[s]
        return (_grid_out(phases, xs, refs), _grid_out(phases, rs, refs),
                _grid_out(phases, ps, refs), torch.stack(hist))

    return _wrap(ops, local_run)


def make_block_bicgstab_runner(ops, num_iterations: int):
    """Whole-loop BiCGStab over a block-diagonal multi-space system.
    Contract: the single-space fused runner's with per-space tuples,
    ``run(xs, rs, ps, vs, rts, rho, alpha, omega) -> (xs, rs, ps, vs, rho,
    alpha, omega, history)``; an exact continuation of the transcription
    recurrence on the block system (every carried dot is summed across
    spaces before the scalar recurrences).  x is updated in place and r,
    p and v ping-pong with spares, so xs, rs, ps and vs must share no
    storage with r~ or each other; r~ is never written."""
    phases = [_bicg_phases_for(op) for op in ops]
    spaces = range(len(ops))
    wide = all(ph.compensated for ph in phases)

    def local_run(xs, rs, ps, vs, rts, rho, alpha, omega):
        refs = xs
        xs, rs, ps, vs, rts = (_grid_in(phases, a)
                               for a in (xs, rs, ps, vs, rts))
        for ph, r, p, v in zip(phases, rs, ps, vs):
            ph.start(r, p, v)
        sdt = _scalar_dtype(xs)
        total = lambda parts: ordered_sum(parts, sdt, wide)
        rho, alpha, omega = (
            torch.as_tensor(a).to(device=xs[0].device, dtype=sdt)
            for a in (rho, alpha, omega))
        rr0, rtr = (total(parts) for parts in zip(
            *(phases[s].boot(rs[s], rts[s]) for s in spaces)))
        hist = [rr0]
        for _ in range(num_iterations):
            rho_new = rtr
            beta = (rho_new / rho) * (alpha / omega)
            rtv = []
            for s in spaces:
                ps[s], vs[s], rtv_s = phases[s].pv(rs[s], ps[s], vs[s],
                                                   rts[s], beta, omega)
                rtv.append(rtv_s)
            alpha = rho_new / total(rtv)
            ts, tt, ctxs = zip(*(phases[s].st(rs[s], vs[s], alpha)
                                 for s in spaces))
            omega = total(ts) / total(tt)
            rr, rtr = [], []
            for s in spaces:
                xs[s], rs[s], rr_s, rtr_s = phases[s].update(
                    rs[s], vs[s], xs[s], ps[s], rts[s], alpha, omega,
                    ctxs[s])
                rr.append(rr_s)
                rtr.append(rtr_s)
            rtr = total(rtr)
            hist.append(total(rr))
            rho = rho_new
        out = lambda arrs: _grid_out(phases, arrs, refs)
        return (out(xs), out(rs), out(ps), out(vs), rho, alpha, omega,
                torch.stack(hist))

    return _wrap(ops, local_run)
