"""2-D grid stencil SpMV and fused-CG passes: wrappers, plain versions, gates.

Port of ``legionsolvers_tpu/ops/pallas/stencil2d.py``.  Each pass has a
hand-written CUDA kernel in ``csrc/stencil2d.cu`` and a plain PyTorch
version here:

=====================  ==================================  =================
wrapper                computes                            plain version
=====================  ==================================  =================
grid2d_stencil_matvec  y = A x, optionally <x, A x>        stencil_plain
grid2d_cg_pq           <p, A p> (A p never stored)         stencil_plain
grid2d_cg_update       x += a p, r -= a A p, <r', r'>      stencil_plain
grid2d_cg_xpay_pq      p = r + b p_old, <p, A p>           xpay_pq_plain
grid2d_cg_gram2        Gram vector of (r, p)               gram2_plain
grid2d_cg_step2        two CG iterations + next Gram       step2_plain
=====================  ==================================  =================

A wrapper given CPU tensors runs the plain version.  Given CUDA tensors it
launches its kernel (built from the repo's sources at first use, see
``build.py``) or raises; it never falls back.  Every CUDA launch adds one
to :data:`LAUNCHES` under the pass's name.

Semantics follow the JAX kernels.  ``x`` is the grid ``[R, C]`` (f32);
stencil offsets are ``(dy, dx)`` pairs.  Columns outside ``[0, C)`` read as
zero.  Rows outside ``[0, R)`` come from the optional ``[8, C]`` halo blocks
of the one-pass modes (real rows last in the top block, first in the
bottom block; ``None`` means zeros).  ``gram2``/``step2`` are zero-halo
Dirichlet passes whose chained stencil applications are the true matrix
powers.  Buffers differ from the JAX aliasing contract: ``update`` writes
x and r in place, ``step2`` writes x in place, and the new r/p of
``step2`` and p of ``xpay_pq`` go to separate buffers (``out``), because
on the GPU a block writing r or p would race a neighbouring block reading
its halo.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

GRAM_NAMES = ("rr", "pAp", "rAp", "ApAp", "rAr",
              "ApAr", "ApA2p", "ArAr", "ArA2p", "A2pA2p")

TILE = 32          # output tile edge of every kernel (csrc: LS_TILE)
MAX_TERMS = 32     # stencil terms a kernel accepts (csrc: LS_MAX_TERMS)
HALO_ROWS = 8      # rows in a halo block
STENCIL_REACH = 8  # K3/K4 gate: |dy|, |dx| <= 8
STEP2_REACH = 1    # K1/K2 gate: four chained applications inside a 4-halo

#: CUDA launches per pass name since the last :func:`reset_launch_counts`.
LAUNCHES = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


# ===========================================================================
# gates
# ===========================================================================

def _reach(offsets) -> int:
    return max(max(abs(dy), abs(dx)) for dy, dx in offsets)


def supports(R: int, C: int, offsets) -> bool:
    """Whether the one-pass kernels (K3, K4) take this geometry."""
    return (R >= 1 and C >= 1 and 1 <= len(offsets) <= MAX_TERMS
            and _reach(offsets) <= STENCIL_REACH)


def step2_supported(R: int, C: int, offsets) -> bool:
    """Whether the s-step kernels (K1, K2) take this geometry: reach 1, so
    that four chained applications fit the tile's 4-element halo."""
    return (R >= 1 and C >= 1 and 1 <= len(offsets) <= MAX_TERMS
            and _reach(offsets) <= STEP2_REACH)


def decompose_flat_offsets(flat_offsets, values, C: int):
    """Rewrite 1-D linearized shifts as (dy, dx) terms over a [R, C] view.

    A flat shift ``s = q*C + r`` (0 <= r < C) reads, for column c, either
    row+q col c+r (when c+r < C) or row+q+1 col c+r-C: two complementary
    column-masked terms."""
    offs, vals = [], []
    for s, v in zip(flat_offsets, values):
        q, r = divmod(int(s), C)
        if r == 0:
            offs.append((q, 0))
            vals.append(float(v))
        else:
            offs.append((q, r))
            vals.append(float(v))
            offs.append((q + 1, r - C))
            vals.append(float(v))
    return tuple(offs), tuple(vals)


# ===========================================================================
# plain PyTorch versions (dense-equivalent shift-and-mask algebra)
# ===========================================================================

def apply_plain(v, offsets, values, halo_top=None, halo_bot=None):
    """A v for the stencil: zero columns outside the grid, rows outside
    from the halo blocks (zeros when ``None``).  Terms are summed in
    offset order, as the kernels do."""
    R, C = v.shape
    P = HALO_ROWS
    z = v.new_zeros(P, C)
    ext = torch.cat([z if halo_top is None else halo_top, v,
                     z if halo_bot is None else halo_bot])
    ext = F.pad(ext, (P, P))
    acc = None
    for (dy, dx), w in zip(offsets, values):
        term = w * ext[P + dy: P + dy + R, P + dx: P + dx + C]
        acc = term if acc is None else acc + term
    return acc


def _dot(a, b):
    return torch.sum(a * b, dtype=torch.float32)


def stencil_plain(mode, x, halo_top, halo_bot, extra=(), *, offsets, values):
    """The one-pass modes of K3 (see :func:`_stencil_call` for ``extra``).
    Returns ``(y,)``, ``(y, dot)``, ``(dot,)`` or ``(x', r', rr)``; the
    update mode writes x' and r' into the given x and r."""
    return mode_outputs(mode, x, apply_plain(x, offsets, values, halo_top,
                                             halo_bot), extra)


def mode_outputs(mode, x, y, extra=()):
    """What a one-pass mode returns, given its operand x and y = A x (the
    2-D and 3-D plain versions share it)."""
    if mode == "y":
        return (y,)
    if mode == "y_dot":
        return y, _dot(x, y)
    if mode == "pq":
        return (_dot(x, y),)
    xv, rv, alpha = extra
    a = torch.as_tensor(alpha, dtype=torch.float32).to(x.dtype)
    xv.add_(a * x)
    rv.sub_(a * y)
    return xv, rv, _dot(rv, rv)


def xpay_pq_plain(r, p_old, beta, r_top=None, r_bot=None, p_top=None,
                  p_bot=None, *, offsets, values, out=None):
    """K4: p = r + beta p_old and <p, A p>, the halo of p being
    r_halo + beta p_old_halo."""
    b = torch.as_tensor(beta, dtype=torch.float32).to(r.dtype)

    def comb(rh, ph):
        if rh is None and ph is None:
            return None
        rh = r.new_zeros(HALO_ROWS, r.shape[1]) if rh is None else rh
        ph = r.new_zeros(HALO_ROWS, r.shape[1]) if ph is None else ph
        return rh + b * ph

    p = r + b * p_old
    Ap = apply_plain(p, offsets, values, comb(r_top, p_top),
                     comb(r_bot, p_bot))
    if out is not None:
        p = out.copy_(p)
    return p, _dot(p, Ap)


def gram2_plain(r, p, *, offsets, values):
    """K2: the Gram vector (ordered :data:`GRAM_NAMES`) of (r, p)."""
    A = lambda v: apply_plain(v, offsets, values)
    Ap = A(p)
    A2p = A(Ap)
    Ar = A(r)
    return torch.stack([
        _dot(r, r), _dot(p, Ap), _dot(r, Ap), _dot(Ap, Ap), _dot(r, Ar),
        _dot(Ap, Ar), _dot(Ap, A2p), _dot(Ar, Ar), _dot(Ar, A2p),
        _dot(A2p, A2p),
    ])


def step2_plain(x, r, p, coef, *, offsets, values, out=None):
    """K1: two CG iterations from the coefficients of :func:`cg2_coeffs`.
    u = c0 p + c1 r - c2 Ap; x'' = x + u (in place); r'' = r - A u;
    p'' = r'' + c3 r - c4 Ap + c5 p; plus the Gram vector of (r'', p'')."""
    A = lambda v: apply_plain(v, offsets, values)
    c0, c1, c2, c3, c4, c5 = coef.to(x.dtype).unbind()
    Ap = A(p)
    u = c0 * p + c1 * r - c2 * Ap
    rn = r - A(u)
    pn = rn + c3 * r - c4 * Ap + c5 * p
    x.add_(u)
    if out is not None:
        rn, pn = out[0].copy_(rn), out[1].copy_(pn)
    return x, rn, pn, gram2_plain(rn, pn, offsets=offsets, values=values)


def cg2_coeffs(g: torch.Tensor):
    """(update coefficients [6], rr after iter 1, rr after iter 2) from the
    Gram vector ``g`` ordered as :data:`GRAM_NAMES`.  Scalar arithmetic on
    0-dim tensors of ``g``'s device: nothing is read back to the host.

    Algebra (A symmetric):
      a0 = rr/<p,Ap>;  r1 = r - a0 Ap;  rr1 = rr - 2 a0 <r,Ap> + a0^2 <Ap,Ap>
      b1 = rr1/rr;     p1 = r1 + b1 p;  a1 = rr1/<p1,Ap1>
      x'' = x + (a0 + a1 b1) p + a1 r - a0 a1 Ap
      p'' = r'' + b2 r - b2 a0 Ap + b2 b1 p          (b2 = rr2/rr1)"""
    rr, pAp, rAp, ApAp, rAr, ApAr, ApA2p, ArAr, ArA2p, A2pA2p = g.unbind()
    a0 = rr / pAp
    rr1 = rr - 2.0 * a0 * rAp + a0 * a0 * ApAp
    b1 = rr1 / rr
    r1Ar1 = rAr - 2.0 * a0 * ApAr + a0 * a0 * ApA2p
    r1Ap = rAp - a0 * ApAp
    p1Ap1 = r1Ar1 + 2.0 * b1 * r1Ap + b1 * b1 * pAp
    a1 = rr1 / p1Ap1
    r1Ap1 = r1Ar1 + b1 * r1Ap
    Ar1Ap = ApAr - a0 * ApA2p
    Ar1Ar1 = ArAr - 2.0 * a0 * ArA2p + a0 * a0 * A2pA2p
    Ap1Ap1 = Ar1Ar1 + 2.0 * b1 * Ar1Ap + b1 * b1 * ApAp
    rr2 = rr1 - 2.0 * a1 * r1Ap1 + a1 * a1 * Ap1Ap1
    b2 = rr2 / rr1
    coef = torch.stack(
        [a0 + a1 * b1, a1, a0 * a1, b2, b2 * a0, b2 * b1]
    ).to(torch.float32)
    return coef, rr1, rr2


# ===========================================================================
# CUDA launch plumbing
# ===========================================================================

class _Stencil(ctypes.Structure):
    """Mirror of ``LsStencil`` in csrc/stencil2d.cu."""
    _fields_ = [
        ("n", ctypes.c_int),
        ("dy", ctypes.c_int * MAX_TERMS),
        ("dx", ctypes.c_int * MAX_TERMS),
        ("v", ctypes.c_float * MAX_TERMS),
    ]


def _stencil_struct(offsets, values) -> _Stencil:
    st = _Stencil()
    st.n = len(offsets)
    for k, ((dy, dx), v) in enumerate(zip(offsets, values)):
        st.dy[k], st.dx[k], st.v[k] = int(dy), int(dx), float(v)
    return st


_MODES = {"y": 0, "y_dot": 1, "pq": 2, "update": 3}


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises otherwise or
    when the given tensors are not all on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _check_grid(name, t, shape=None, ndim=2):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(
            f"{name}: expected a {ndim}-D grid, got {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_halo(name, h, C):
    if h is not None:
        _check_grid(name, h, (HALO_ROWS, C))


def _check_distinct(*named):
    """Outputs that a kernel writes while other blocks read must not share
    storage with the inputs they race."""
    ptrs = {}
    for name, t in named:
        p = t.untyped_storage().data_ptr()
        if p in ptrs:
            raise ValueError(f"{name} shares storage with {ptrs[p]}")
        ptrs[p] = name


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dev_scalars(a, n: int, device) -> torch.Tensor:
    """``n`` f32 scalars as a contiguous device tensor (no host sync for a
    tensor already on the device)."""
    t = torch.as_tensor(a).to(device=device, dtype=torch.float32)
    t = t.reshape(-1).contiguous()
    if t.numel() != n:
        raise ValueError(f"expected {n} coefficient(s), got {t.numel()}")
    return t


_TABLES = {}


def _int32_table(values: tuple, device) -> torch.Tensor:
    """``values`` as an int32 device array, made once per (values, device):
    the small index tables a kernel reads (K8's offsets, K10's w0)."""
    key = (values, device)
    t = _TABLES.get(key)
    if t is None:
        t = torch.tensor(values, dtype=torch.int32, device=device)
        _TABLES[key] = t
    return t


def _blocks(R, C) -> int:
    return -(-R // TILE) * -(-C // TILE)


def _launch(name: str, fn: str, args, device) -> None:
    from .build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    if err:
        raise RuntimeError(
            f"{fn}: CUDA error {err} "
            f"({lib.ls_error_string(err).decode()})"
        )
    LAUNCHES[name] += 1


# ===========================================================================
# K3: one-pass stencil modes
# ===========================================================================

def _stencil_call(x, halo_top, halo_bot, extra=(), *, offsets, values,
                  mode: str = "y"):
    """Shared driver of the K3 modes.  ``extra`` is () except for mode
    ``update``, where it is (xv, rv, alpha) and x is the search direction p."""
    R, C = x.shape
    if not supports(R, C, offsets):
        raise ValueError(f"unsupported stencil geometry R={R} C={C}")
    _check_grid("x", x)
    _check_halo("halo_top", halo_top, C)
    _check_halo("halo_bot", halo_bot, C)
    tensors = [x, halo_top, halo_bot]
    if mode == "update":
        xv, rv, _ = extra
        _check_grid("xv", xv, (R, C))
        _check_grid("rv", rv, (R, C))
        _check_distinct(("p", x), ("x", xv), ("r", rv))
        tensors += [xv, rv]
    if not _on_cuda(*tensors):
        return stencil_plain(mode, x, halo_top, halo_bot, extra,
                             offsets=offsets, values=values)
    dev = x.device
    y = torch.empty_like(x) if mode in ("y", "y_dot") else None
    xv = rv = alpha = None
    if mode == "update":
        xv, rv, alpha = extra
        alpha = _dev_scalars(alpha, 1, dev)
    dot = torch.empty(1, dtype=torch.float32, device=dev)
    partials = torch.empty(_blocks(R, C), dtype=torch.float32, device=dev)
    st = _stencil_struct(offsets, values)
    _launch(mode, "ls_stencil2d", (
        _MODES[mode], _ptr(x), _ptr(halo_top), _ptr(halo_bot), _ptr(y),
        _ptr(xv), _ptr(rv), _ptr(alpha), _ptr(dot), _ptr(partials),
        R, C, ctypes.byref(st),
    ), dev)
    if mode == "y":
        return (y,)
    if mode == "y_dot":
        return y, dot[0]
    if mode == "pq":
        return (dot[0],)
    return xv, rv, dot[0]


def grid2d_stencil_matvec(x, halo_top=None, halo_bot=None, *, offsets,
                          values, with_dot: bool = False):
    """y = A @ x (and optionally <x, y>) for the stencil {(dy, dx): v}."""
    out = _stencil_call(x, halo_top, halo_bot, offsets=offsets,
                        values=values, mode="y_dot" if with_dot else "y")
    return out if with_dot else out[0]


def grid2d_cg_pq(p, halo_top=None, halo_bot=None, *, offsets, values):
    """<p, A p> without storing A p (two-pass CG prologue)."""
    return _stencil_call(p, halo_top, halo_bot, offsets=offsets,
                         values=values, mode="pq")[0]


def grid2d_cg_update(p, x, r, alpha, halo_top=None, halo_bot=None, *,
                     offsets, values):
    """(x + alpha p, r - alpha A p, <r', r'>) with A p formed on chip only.
    x and r are updated in place."""
    return _stencil_call(p, halo_top, halo_bot, (x, r, alpha),
                         offsets=offsets, values=values, mode="update")


# ===========================================================================
# K4: xpay + pq
# ===========================================================================

def grid2d_cg_xpay_pq(r, p_old, beta, r_top=None, r_bot=None, p_top=None,
                      p_bot=None, *, offsets, values, out=None):
    """(p, <p, A p>) where p = r + beta p_old, written to ``out`` (a fresh
    buffer when ``None``; it may not share storage with r or p_old)."""
    R, C = r.shape
    if not supports(R, C, offsets):
        raise ValueError(f"unsupported stencil geometry R={R} C={C}")
    _check_grid("r", r)
    _check_grid("p_old", p_old, (R, C))
    for name, h in (("r_top", r_top), ("r_bot", r_bot),
                    ("p_top", p_top), ("p_bot", p_bot)):
        _check_halo(name, h, C)
    if out is not None:
        _check_grid("out", out, (R, C))
        _check_distinct(("r", r), ("p_old", p_old), ("out", out))
    if not _on_cuda(r, p_old, r_top, r_bot, p_top, p_bot, out):
        return xpay_pq_plain(r, p_old, beta, r_top, r_bot, p_top, p_bot,
                             offsets=offsets, values=values, out=out)
    dev = r.device
    p = torch.empty_like(r) if out is None else out
    b = _dev_scalars(beta, 1, dev)
    dot = torch.empty(1, dtype=torch.float32, device=dev)
    partials = torch.empty(_blocks(R, C), dtype=torch.float32, device=dev)
    st = _stencil_struct(offsets, values)
    _launch("xpay_pq", "ls_xpay_pq", (
        _ptr(r), _ptr(p_old), _ptr(b), _ptr(r_top), _ptr(r_bot),
        _ptr(p_top), _ptr(p_bot), _ptr(p), _ptr(dot), _ptr(partials),
        R, C, ctypes.byref(st),
    ), dev)
    return p, dot[0]


# ===========================================================================
# K2 / K1: s-step passes
# ===========================================================================

def grid2d_cg_gram2(r, p, *, offsets, values):
    """Gram vector (ordered :data:`GRAM_NAMES`) of (r, p): the s-step
    bootstrap and drift-refresh pass."""
    R, C = r.shape
    if not step2_supported(R, C, offsets):
        raise ValueError("s-step kernels require stencil reach <= 1")
    _check_grid("r", r)
    _check_grid("p", p, (R, C))
    if not _on_cuda(r, p):
        return gram2_plain(r, p, offsets=offsets, values=values)
    dev = r.device
    g = torch.empty(10, dtype=torch.float32, device=dev)
    partials = torch.empty(10 * _blocks(R, C), dtype=torch.float32,
                           device=dev)
    st = _stencil_struct(offsets, values)
    _launch("gram2", "ls_gram2", (
        _ptr(r), _ptr(p), _ptr(g), _ptr(partials), R, C, ctypes.byref(st),
    ), dev)
    return g


def grid2d_cg_step2(x, r, p, coef, *, offsets, values,
                    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """TWO fused CG iterations in one pass: returns (x'', r'', p'',
    gram(r'', p'')) given the coefficient vector of :func:`cg2_coeffs`.
    x is updated in place; r'' and p'' go to ``out`` (fresh buffers when
    ``None``), which may not share storage with x, r or p."""
    R, C = r.shape
    if not step2_supported(R, C, offsets):
        raise ValueError("s-step kernels require stencil reach <= 1")
    _check_grid("x", x, (R, C))
    _check_grid("r", r)
    _check_grid("p", p, (R, C))
    if out is None:
        out = (torch.empty_like(r), torch.empty_like(p))
    _check_grid("r_out", out[0], (R, C))
    _check_grid("p_out", out[1], (R, C))
    _check_distinct(("x", x), ("r", r), ("p", p), ("r_out", out[0]),
                    ("p_out", out[1]))
    if not _on_cuda(x, r, p, out[0], out[1]):
        return step2_plain(x, r, p, coef, offsets=offsets, values=values,
                           out=out)
    dev = r.device
    c = _dev_scalars(coef, 6, dev)
    g = torch.empty(10, dtype=torch.float32, device=dev)
    partials = torch.empty(10 * _blocks(R, C), dtype=torch.float32,
                           device=dev)
    st = _stencil_struct(offsets, values)
    _launch("step2", "ls_step2", (
        _ptr(x), _ptr(r), _ptr(p), _ptr(c), _ptr(out[0]), _ptr(out[1]),
        _ptr(g), _ptr(partials), R, C, ctypes.byref(st),
    ), dev)
    return x, out[0], out[1], g
