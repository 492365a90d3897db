"""Row-structured gather (K10), one hop of the routed general SpMV:
wrapper and plain version.

Port of ``legionsolvers_tpu/ops/pallas/rowperm.py``:

    out[d, j] = src[(d // br * srb + w0_table[d % br]) * 1024 + idx[d, j]]
                (* vals[d, j])

with ``br = block_rows``, ``srb = src_block_rows`` and ``idx`` relative to
a ``w_rows``-row window.  :func:`blockperm_gather` launches the
hand-written CUDA kernel of ``csrc/rowperm.cu`` (float or double) on CUDA
tensors and runs :func:`blockperm_plain` on CPU tensors; it never falls
back.  Every CUDA launch adds one to :data:`~.stencil2d.LAUNCHES` under
``blockperm``.  The geometry caps are the JAX kernel's, so that the host
planner (``parallel/genspmv.py``) picks the same routing in both packages.
"""

from __future__ import annotations

import torch

from .stencil2d import _int32_table, _launch, _on_cuda, _ptr
from .winell import _check

MAX_W_ROWS = 8
MAX_BLOCK_ROWS = 256
MAX_SRC_ROWS = 64


class GatherHop:
    """One hop's static geometry, checked once: ``block_rows``,
    ``src_block_rows``, ``w_rows`` and ``w0_table``, with the table also
    as an int32 array on ``device`` for the kernel.  A routed matvec builds
    its hops at plan time and runs them with :func:`gather_hop`."""

    __slots__ = ("block_rows", "src_block_rows", "w_rows", "w0_table",
                 "w0_dev")

    def __init__(self, block_rows: int, src_block_rows: int,
                 w0_table: tuple, w_rows: int = 1, device="cpu"):
        BRK, SRB, W = int(block_rows), int(src_block_rows), int(w_rows)
        w0_table = tuple(int(w) for w in w0_table)
        if BRK % 8 or BRK > MAX_BLOCK_ROWS or BRK < 1:
            raise ValueError(f"unsupported block_rows={BRK}")
        if SRB % 8 or SRB > MAX_SRC_ROWS or SRB < 1:
            raise ValueError(f"unsupported src_block_rows={SRB}")
        if W < 1 or W > MAX_W_ROWS:
            raise ValueError(f"unsupported w_rows={W}")
        if len(w0_table) != BRK or any(w0 < 0 or w0 + W > SRB
                                       for w0 in w0_table):
            raise ValueError("bad w0_table")
        self.block_rows, self.src_block_rows, self.w_rows = BRK, SRB, W
        self.w0_table = w0_table
        self.w0_dev = _int32_table(w0_table, torch.device(device))

    def kwargs(self) -> dict:
        """The keyword arguments of :func:`blockperm_gather`."""
        return {"block_rows": self.block_rows,
                "src_block_rows": self.src_block_rows,
                "w0_table": self.w0_table, "w_rows": self.w_rows}


def blockperm_plain(src, idx, vals=None, *, block_rows: int,
                    src_block_rows: int, w0_table: tuple, w_rows: int = 1):
    """K10 in PyTorch."""
    RD = idx.shape[0]
    d = torch.arange(RD, device=idx.device)
    w0 = torch.as_tensor(w0_table, dtype=torch.int64, device=idx.device)
    base = (d // block_rows) * src_block_rows + w0[d % block_rows]
    g = src[base[:, None] * 1024 + idx.to(torch.int64)]
    return g * vals if vals is not None else g


def blockperm_gather(src, idx, vals=None, *, block_rows: int,
                     src_block_rows: int, w0_table: tuple,
                     w_rows: int = 1):
    """One routed-gather hop: ``src`` flat (float32 or float64), ``idx``
    [RD, 1024] int32 with values in ``[0, w_rows * 1024)``, optional
    ``vals`` [RD, 1024] in src's dtype.  Returns [RD, 1024]."""
    return gather_hop(GatherHop(block_rows, src_block_rows, w0_table,
                                w_rows, src.device), src, idx, vals)


def gather_hop(hop: GatherHop, src, idx, vals=None):
    """:func:`blockperm_gather` on a hop checked beforehand: only the
    tensors are checked here."""
    BRK, SRB = hop.block_rows, hop.src_block_rows
    if src.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"src: expected float32 or float64, got {src.dtype}")
    _check("src", src, src.dtype, ndim=1)
    _check("idx", idx, torch.int32, ndim=2)
    RD = idx.shape[0]
    if idx.shape[1] != 1024 or RD % BRK:
        raise ValueError(f"idx: shape {tuple(idx.shape)} is not [k * "
                         f"{BRK}, 1024]")
    if src.numel() % (SRB * 1024) or (RD // BRK) * SRB * 1024 > src.numel():
        raise ValueError(f"src: {src.numel()} elements do not hold "
                         f"{RD // BRK} source blocks of {SRB} rows")
    if vals is not None:
        _check("vals", vals, src.dtype, idx.shape)
    if not _on_cuda(src, idx, vals):
        return blockperm_plain(src, idx, vals, **hop.kwargs())
    dev = src.device
    if hop.w0_dev.device != dev:
        raise ValueError(f"hop built for {hop.w0_dev.device}, not {dev}")
    out = torch.empty((RD, 1024), dtype=src.dtype, device=dev)
    _launch("blockperm", "ls_blockperm", (
        int(src.dtype == torch.float64), _ptr(src), _ptr(idx), _ptr(vals),
        _ptr(hop.w0_dev), _ptr(out), RD, BRK, SRB,
    ), dev)
    return out
