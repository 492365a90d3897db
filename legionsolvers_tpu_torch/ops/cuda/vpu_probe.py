"""Op-rate probe chains (K11): wrapper and plain version.

Port of ``_chain_kernel`` in ``legionsolvers_tpu/utils/vpu_probe.py``:
ILP = 8 independent chains v_j = x + j per element; each of ``reps`` loop
trips applies UNROLL = 8 steps of f to every chain, and the output is the
sum of the chains.  f depends on ``kind``:

* ``fma``:  v * 1.000001 + (0.25 + 0.01 j), both constants float32;
* ``roll``: 0.5 v + w, w[r, c] = v[r, (c - 1) mod 1024];
* ``row``:  0.5 v + w, w[r, c] = v[(r + 1) mod 256, c].

:func:`chain_probe` launches the hand-written CUDA kernel of
``csrc/vpu_probe.cu`` on CUDA tensors and runs :func:`chain_plain` on CPU
tensors; it never falls back.  Every CUDA launch adds one to
:data:`~.stencil2d.LAUNCHES` under ``chain_<kind>``.

The kernel rounds ``roll`` and ``row`` as the plain version does (bit for
bit).  ``fma`` is one fused multiply-add per step where the plain version
rounds the product and the sum apart, at most one unit in the last place
of the step's value apart; the difference is carried on by a factor
1.000001 per step, so after S = 8 reps steps each chain is within S ulp
of its plain value and their sum within S ulp of its largest magnitude:
:func:`fma_rtol` doubles that.  ``roll`` and ``row`` grow about 1.5x per
step and overflow float32 after ~218 steps: compare them at reps <= 16.
"""

from __future__ import annotations

import torch

from .stencil2d import _launch, _on_cuda, _ptr

TR, C = 256, 1024  # the probe's tile (csrc: LS_VPU_TR, LS_VPU_C)
ILP = 8
UNROLL = 8
KINDS = ("fma", "roll", "row")
_KIND_IDS = {"fma": 0, "roll": 1, "row": 2}
FMA_SCALE = 1.000001


def fma_offset(j: int) -> float:
    return 0.25 + 0.01 * j


def fma_rtol(reps: int) -> float:
    """Tolerance of the fused kernel against the plain ``fma`` chain,
    relative to the largest |output|: twice 8 reps ulp (see above)."""
    return 2.0 * UNROLL * max(reps, 1) * 2.0 ** -23


def _step(v: torch.Tensor, j: int, kind: str) -> torch.Tensor:
    if kind == "fma":
        return v * FMA_SCALE + fma_offset(j)
    if kind == "roll":
        return 0.5 * v + torch.roll(v, 1, 1)
    return 0.5 * v + torch.roll(v, -1, 0)


def chain_plain(x: torch.Tensor, reps: int, kind: str) -> torch.Tensor:
    """K11 in PyTorch."""
    vs = [x + float(j) for j in range(ILP)]
    for _ in range(reps):
        for _u in range(UNROLL):
            vs = [_step(v, j, kind) for j, v in enumerate(vs)]
    acc = vs[0]
    for v in vs[1:]:
        acc = acc + v
    return acc


def chain_probe(x: torch.Tensor, reps: int, kind: str) -> torch.Tensor:
    """One probe run: ``x`` float32, contiguous, [256, 1024] for ``roll``
    and ``row`` (any 2-D shape for ``fma``); ``reps`` >= 0 loop trips."""
    if kind not in _KIND_IDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
    if x.dtype != torch.float32:
        raise TypeError(f"x: expected float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x: expected a contiguous 2-D tensor")
    if kind != "fma" and tuple(x.shape) != (TR, C):
        raise ValueError(f"x: {kind} needs the [{TR}, {C}] tile, got "
                         f"{tuple(x.shape)}")
    reps = int(reps)
    if reps < 0:
        raise ValueError("reps must be >= 0")
    if not _on_cuda(x):
        return chain_plain(x, reps, kind)
    out = torch.empty_like(x)
    _launch(f"chain_{kind}", "ls_vpu_chain", (
        _KIND_IDS[kind], _ptr(x), _ptr(out), x.shape[0], x.shape[1], reps,
    ), x.device)
    return out
