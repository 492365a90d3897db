"""Windowed-ELL operators: the fast path for explicit matrices whose rows
can be banded, single device.

Port of ``legionsolvers_tpu/parallel/winell_op.py`` (reference:
CSRMatrixTasks.cu:14-156, COOMatrixTasks.cu:12-146).  The host planners
are the JAX package's numpy code, copied with their gates
(``MAX_WINDOW_ROWS`` 64 window rows, fill 1/16), so that both packages
pick the same operator and the same plan:

* :func:`plan_winell`: ELL layout with column-sorted slots, one
  1024-aligned window of x per (row tile, slot), the tile height chosen by
  the JAX package's cost model;
* :func:`plan_winell_classes`: per-degree-class plans over 1024-row
  blocks (sliced ELL), each with its own slot count.

The device matvec is kernel K9 (``ops/cuda/winell.py``), once per class;
the sliced operator un-shuffles its 1024-row blocks with a torch index
op.  Reached through the planner's RCM upgrade (``parallel/reorder.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.partition import BlockPartition
from ..ops.cuda.winell import MAX_WINDOW_ROWS, winell_spmv
from ..options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from .dia_op import _Swapped, numpy_dtype

TILE_ROWS_OF_128 = 32  # Rt: output tile = Rt*128 rows

# cost-model constants of the JAX package's tile-size choice (calibrated
# there on a TPU; kept so that both packages pick the same tile height)
_VPU_OPS_PER_SEC = 1.4e12
_DMA_ISSUE_SEC = 2e-8
_RT_CANDIDATES = (8, 16, 32, 64)


def plan_winell(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n: int,
    padded_size: int,
    dtype,
    max_window_rows: int = MAX_WINDOW_ROWS,
    tile_rows_of_128: Optional[int] = None,
    min_fill: float = 1 / 16,
    window_rows_min: int = 0,
    row_length_min: int = 0,
    n_win: Optional[int] = None,
) -> Optional[dict]:
    """Host-side windowed-ELL packing; returns None when ineligible.

    Output dict: N (device length, multiple of the tile), wstart [nt, L]
    int32, cols [nt, L, Rt, 128] int32 (window-local), vals [...] in
    ``dtype``, window_rows KR.  Duplicate (row, col) entries are summed
    (COO semantics, like the reference's reduction-accessor SpMV output,
    COOMatrixTasks.cpp:38-39).  The tile height Rt (in rows of 128) is
    chosen by a measured cost model unless forced: per-(tile, slot) window
    spans shrink with the tile (fewer gather chunks = less VPU work) while
    the window DMA count grows.
    """
    N0 = max(padded_size, 1024)
    # window (x) space may exceed the row space: sliced-ELL classes plan a
    # row RANGE whose windows still index the full x (round 5)
    N_win0 = max(n_win if n_win is not None else padded_size, N0)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals, np.float64)
    if len(rows) == 0:
        return None
    order = np.lexsort((cols, rows))
    r, c, v = rows[order], cols[order], vals[order]
    # combine duplicates (adjacent after the sort; reduceat, not ufunc.at —
    # this host pages at ~40 MB/s and ufunc.at is orders slower than the
    # vectorized reductions)
    new = np.empty(len(r), bool)
    new[0] = True
    new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    if not new.all():
        starts = np.flatnonzero(new)
        v = np.add.reduceat(v, starts)
        r, c = r[new], c[new]
    # slot within row (column-sorted: keeps per-(tile, slot) spans tight)
    counts = np.bincount(r, minlength=N0)
    L = int(counts.max(initial=0))
    if L == 0 or L > 128:
        return None
    L = max(L, row_length_min)  # SPMD: all shards share one static L
    if len(r) < min_fill * N0 * L:
        return None  # ELL padding blowup: a few long rows dominate
    row_start = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(r)) - row_start[r]

    # ---- per-(fine-tile, slot) column extents at the FINEST tiling ------
    # (Rt = 8); coarser candidate tilings aggregate these pairwise, so the
    # expensive grouped pass over nnz runs once
    TR0 = 8 * 128
    N_f = -(-N0 // TR0) * TR0
    nt0 = N_f // TR0
    ts0 = (r // TR0) * L + slot
    gorder = np.argsort(ts0, kind="stable")
    ts_s, c_s = ts0[gorder], c[gorder]
    gnew = np.empty(len(ts_s), bool)
    gnew[0] = True
    gnew[1:] = ts_s[1:] != ts_s[:-1]
    gstarts = np.flatnonzero(gnew)
    gid = ts_s[gstarts]
    BIG = np.int64(1) << 60
    min0 = np.full(nt0 * L, BIG, np.int64)
    max0 = np.full(nt0 * L, -1, np.int64)
    min0[gid] = np.minimum.reduceat(c_s, gstarts)
    max0[gid] = np.maximum.reduceat(c_s, gstarts)
    min0 = min0.reshape(nt0, L)
    max0 = max0.reshape(nt0, L)

    def extents_for(Rt):
        f = Rt // 8
        nt = -(-nt0 // f)
        pad = nt * f - nt0
        mn = np.concatenate(
            [min0, np.full((pad, L), BIG, np.int64)]
        ).reshape(nt, f, L).min(axis=1)
        mx = np.concatenate(
            [max0, np.full((pad, L), -1, np.int64)]
        ).reshape(nt, f, L).max(axis=1)
        return nt, mn.reshape(-1), mx.reshape(-1)

    def window_geometry(Rt):
        """(nt, ws, KR) for a candidate tile height, or None if the cap is
        exceeded."""
        TR = Rt * 128
        N = -(-N0 // TR) * TR
        NR = max(N, N_win0) // 128
        if NR < 8:
            return None
        nt, mn, mx = extents_for(Rt)
        occ = mx >= 0
        ws = np.zeros(nt * L, np.int64)
        ws[occ] = (mn[occ] // 1024) * 8
        span = np.zeros(nt * L, np.int64)
        span[occ] = mx[occ] // 128 - ws[occ] + 1
        KR = int(span.max(initial=1))
        KR = -(-KR // 8) * 8
        KR = max(KR, window_rows_min)  # SPMD: shared static window depth
        if KR > min(max_window_rows, NR - (NR % 8)):
            return None
        ws = np.minimum(ws, NR - KR)
        return NR * 128, nt, ws, KR  # first entry = WINDOW (x) space

    if tile_rows_of_128 is not None:
        geo = window_geometry(tile_rows_of_128)
        if geo is None:
            return None
        Rt = tile_rows_of_128
    else:
        best = None
        for cand in _RT_CANDIDATES:
            geo_c = window_geometry(cand)
            if geo_c is None:
                continue
            N_c, nt_c, _, KR_c = geo_c
            compute = N_c * L * (4 * KR_c + 3) / _VPU_OPS_PER_SEC
            dma = nt_c * (L + 3) * _DMA_ISSUE_SEC
            cost = compute + dma
            if best is None or cost < best[0]:
                best = (cost, cand, geo_c)
        if best is None:
            return None
        Rt, geo = best[1], best[2]
    N_x, nt, ws, KR = geo
    TR = Rt * 128

    ts = (r // TR) * L + slot
    ell_cols = np.zeros((nt * L, TR), np.int32)
    ell_vals = np.zeros((nt * L, TR), dtype)
    lc = c - ws[ts] * 128
    ell_cols[ts, r % TR] = lc.astype(np.int32)
    ell_vals[ts, r % TR] = v.astype(dtype)
    ws2 = ws.reshape(nt, L).astype(np.int32)
    ntp = -(-nt // 8) * 8
    if ntp != nt:  # rows padded to 8, as the JAX plan's TPU kernel needs
        ws2 = np.concatenate([ws2, np.zeros((ntp - nt, L), np.int32)])
    return {
        "N": N_x,                 # x padding (window space)
        "N_rows": nt * TR,        # output rows (row space)
        "window_rows": KR,
        "wstart": ws2,
        "cols": ell_cols.reshape(nt, L, Rt, 128),
        "vals": ell_vals.reshape(nt, L, Rt, 128),
        "row_length": L,
        "tile_rows_of_128": Rt,
    }


class WinEllOperator:
    """y = A @ x on kernel K9 (single piece).  Build via :func:`plan_winell`
    + constructor, or let the planner route here through the RCM reorder
    gate (``parallel/reorder.py``)."""

    def __init__(
        self,
        matrix,
        partition: BlockPartition,
        options: SolverOptions = DEFAULT_OPTIONS,
        plan: Optional[dict] = None,
        device=None,
    ):
        if partition.num_pieces != 1:
            raise ValueError("WinEllOperator is single-piece only")
        if matrix.n_domain != matrix.n_range:
            raise ValueError("WinEllOperator requires a square matrix")
        self.matrix = matrix
        self.partition = partition
        self.options = options
        self.device = resolve_device(device)
        if plan is None:
            # explicit construction opts out of the planner's fill gate
            plan = plan_winell(
                matrix.rows, matrix.cols, np.asarray(matrix.vals),
                matrix.n_range, partition.padded_size,
                numpy_dtype(options.entry_dtype), min_fill=0.0,
            )
        if plan is None:
            raise ValueError("matrix is not windowed-ELL eligible")
        self._N = plan["N"]
        self._KR = plan["window_rows"]
        dev = self.device
        self.wstart = torch.as_tensor(plan["wstart"], device=dev)
        self.ell_cols = torch.as_tensor(plan["cols"], device=dev)
        self.ell_vals = torch.as_tensor(plan["vals"], device=dev)
        self.row_length = plan["row_length"]
        self.tile_rows_of_128 = plan["tile_rows_of_128"]
        self._transpose_op = None

    @property
    def n_domain(self) -> int:
        return self.matrix.n_domain

    @property
    def n_range(self) -> int:
        return self.matrix.n_range

    def nnz(self) -> int:
        return self.matrix.n_kernel

    @property
    def window_rows(self) -> int:
        return self._KR

    supports_matvec_dot = False
    uses_pallas = True  # the name of the JAX flag: the matvec is K9

    def device_state(self):
        return (self.wstart, self.ell_cols, self.ell_vals)

    def set_device_state(self, state) -> None:
        self.wstart, self.ell_cols, self.ell_vals = state

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        P = self.partition.padded_size
        x = _pad_to(x.reshape(-1), self._N)
        y = winell_spmv(x.reshape(-1, 128), self.wstart, self.ell_cols,
                        self.ell_vals, window_rows=self._KR).reshape(-1)
        return y[:P]

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    def transpose(self) -> "WinEllOperator":
        """A^T on the same kernel (a fresh packing of the swapped pattern;
        the reference stubs rmatvec, COOMatrixTasks.cpp:78-83)."""
        if self._transpose_op is None:
            self._transpose_op = WinEllOperator(
                _Swapped(self.matrix), self.partition, self.options,
                device=self.device)
        return self._transpose_op

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.transpose().matvec(x)


def _pad_to(x: torch.Tensor, n: int) -> torch.Tensor:
    """x zero-extended to length n (a contiguous copy only when needed)."""
    if x.shape[0] == n:
        return x.contiguous()
    return torch.cat([x, x.new_zeros(n - x.shape[0])])


def plan_winell_classes(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n: int,
    padded_size: int,
    dtype,
    max_classes: int = 6,
    min_fill: float = 1 / 16,
):
    """Sliced-ELL planning (round 5, r4 verdict item 3): per-1024-row-block
    slot counts instead of one global L.

    Uniform-L ELL pays the MAX row degree for every row — the round-4
    randband row wasted 3.3x (L = 26 slots vs mean 8 nnz/row).  Windows are
    a per-tile property, so BLOCKS of 1024 rows can be reordered by degree
    without touching the window spans: blocks are packed into <= 6
    contiguous degree classes, each planned independently with its own L
    (and its own tile/window geometry) over the SAME x window space; the
    device matvec concatenates the class outputs and un-shuffles y by a
    1024-row block gather (~200 GB/s measured — one cheap pass).

    Returns None when ineligible, a plain :func:`plan_winell` dict when one
    class suffices, else {"classes": [(n_blocks_c, plan_c), ...],
    "block_src": int32[nbp] (shuffled block b reads original block
    block_src[b]), "newpos": int32[nbp] (original block b lands at
    newpos[b]), "nb": nb}."""
    N0 = max(padded_size, 1024)
    nb = -(-N0 // 1024)
    rows = np.asarray(rows, np.int64)
    counts = np.bincount(rows, minlength=nb * 1024)
    Lb = counts.reshape(nb, 1024).max(axis=1)
    order = np.argsort(-Lb, kind="stable")  # blocks by descending degree
    Ls = Lb[order]
    if Ls[0] == 0 or Ls[0] > 128:
        return None
    # greedy class boundaries: new class when the running max exceeds the
    # current block's L by > 30% (merge smallest until <= max_classes)
    bounds = [0]
    for i in range(1, nb):
        if Ls[bounds[-1]] > 1.3 * max(Ls[i], 1):
            bounds.append(i)
    bounds.append(nb)
    while len(bounds) - 1 > max_classes:
        # merge the pair of adjacent classes with the least added padding
        costs = [
            (Ls[bounds[i]] - Ls[bounds[i + 1]]) * (bounds[i + 2] - bounds[i + 1])
            for i in range(len(bounds) - 2)
        ]
        k = int(np.argmin(costs))
        del bounds[k + 1]
    slots = sum(
        int(Ls[bounds[i]]) * (bounds[i + 1] - bounds[i]) * 1024
        for i in range(len(bounds) - 1)
    )
    if len(rows) < min_fill * slots:
        return None
    if len(bounds) == 2:
        # one class: the classic uniform plan (no shuffle machinery)
        return plan_winell(rows, cols, np.asarray(vals), n, padded_size,
                           dtype, min_fill=0.0)

    newpos = np.empty(nb, np.int64)
    newpos[order] = np.arange(nb)
    new_r = newpos[rows // 1024] * 1024 + rows % 1024
    cols = np.asarray(cols, np.int64)
    vals = np.asarray(vals)
    classes = []
    for i in range(len(bounds) - 1):
        lo, hi = bounds[i] * 1024, bounds[i + 1] * 1024
        sel = (new_r >= lo) & (new_r < hi)
        plan_c = plan_winell(
            new_r[sel] - lo, cols[sel], vals[sel], hi - lo, hi - lo,
            dtype, min_fill=0.0, n_win=N0,
        )
        if plan_c is None:
            return None
        classes.append((bounds[i + 1] - bounds[i], plan_c))
    return {
        "classes": classes,
        "block_src": order.astype(np.int32),
        "newpos": newpos.astype(np.int32),
        "nb": nb,
    }


class SlicedWinEllOperator:
    """y = A @ x on per-degree-class windowed-ELL plans (single piece), one
    K9 launch per class.  See :func:`plan_winell_classes`."""

    def __init__(
        self,
        matrix,
        partition: BlockPartition,
        options: SolverOptions = DEFAULT_OPTIONS,
        plan: Optional[dict] = None,
        device=None,
    ):
        if partition.num_pieces != 1:
            raise ValueError("SlicedWinEllOperator is single-piece only")
        self.matrix = matrix
        self.partition = partition
        self.options = options
        self.device = resolve_device(device)
        if plan is None:
            plan = plan_winell_classes(
                matrix.rows, matrix.cols, np.asarray(matrix.vals),
                matrix.n_range, partition.padded_size,
                numpy_dtype(options.entry_dtype),
            )
        if plan is None or "classes" not in plan:
            raise ValueError("matrix is not sliced-winell eligible")
        dev = self.device
        self._nb = plan["nb"]
        self._class_meta = tuple(
            (nb_c, p["window_rows"]) for nb_c, p in plan["classes"])
        self._N = max(p["N"] for _, p in plan["classes"])
        self.class_arrays = tuple(
            (torch.as_tensor(p["wstart"], device=dev),
             torch.as_tensor(p["cols"], device=dev),
             torch.as_tensor(p["vals"], device=dev))
            for _, p in plan["classes"])
        self.newpos = torch.as_tensor(plan["newpos"], dtype=torch.int64,
                                      device=dev)
        self.row_length = float(
            sum(nb_c * p["row_length"] for nb_c, p in plan["classes"])
            / max(plan["nb"], 1))
        self._transpose_op = None

    @property
    def n_domain(self) -> int:
        return self.matrix.n_domain

    @property
    def n_range(self) -> int:
        return self.matrix.n_range

    def nnz(self) -> int:
        return self.matrix.n_kernel

    supports_matvec_dot = False
    uses_pallas = True

    def device_state(self):
        return (self.class_arrays, self.newpos)

    def set_device_state(self, state) -> None:
        self.class_arrays, self.newpos = state

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        P = self.partition.padded_size
        x2d = _pad_to(x.reshape(-1), self._N).reshape(-1, 128)
        parts = []
        for (nb_c, KR), (ws, pc, pv) in zip(self._class_meta,
                                            self.class_arrays):
            y_c = winell_spmv(x2d, ws, pc, pv, window_rows=KR).reshape(-1)
            parts.append(y_c[: nb_c * 1024])
        y_shuf = torch.cat(parts)
        # un-shuffle the 1024-row blocks
        y = y_shuf.reshape(self._nb, 1024)[self.newpos].reshape(-1)
        return y[:P]

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    def transpose(self) -> "SlicedWinEllOperator":
        if self._transpose_op is None:
            self._transpose_op = SlicedWinEllOperator(
                _Swapped(self.matrix), self.partition, self.options,
                device=self.device)
        return self._transpose_op

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.transpose().matvec(x)
