"""General-sparsity SpMV: host-planned routing + row-structured gathers,
single device.

Port of ``legionsolvers_tpu/parallel/genspmv.py`` (reference:
CSRMatrixTasks.cu:14-156, cuSPARSE's pattern-agnostic SpMV).  An arbitrary
static gather ``xg[k] = x[col(k)]`` is decomposed at build time into three
row-structured hops, each a launch of kernel K10 (``ops/cuda/rowperm.py``),
with transposes (torch ``permute(...).contiguous()``) between them:

  hop 1  fan x rows out into B1 destination groups;
  T1     transpose [A, B1, W1] -> [B1, A, W1];
  hop 2  route within each group into per-region slots;
  T2     per-group 2-D transpose;
  hop 3  gather each destination block from its region, scaled by the
         matrix values -> products in SELL slot-major order;
  sum    per-tile slot sums (torch) -> y, plus the diagonal elementwise.

A capped plan routes the tail of its hop-2 cells through a second,
uncapped pipeline (three more K10 launches) spliced in by concatenation.
:func:`plan_static_gather` is the JAX package's numpy planner, copied, so
both packages route the same way.  Rows are expected degree-sorted (the
planner's basis, ``degree_sort_perm``); any order is correct.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.partition import BlockPartition
from ..ops.cuda.rowperm import (
    MAX_BLOCK_ROWS,
    MAX_SRC_ROWS,
    MAX_W_ROWS,
    GatherHop,
    gather_hop,
)
from ..options import DEFAULT_OPTIONS, SolverOptions, resolve_device
from .dia_op import _Swapped, numpy_dtype
from .winell_op import _pad_to

_B1_CANDIDATES = (8, 16, 32, 64, 128, 256, 512, 1024)


def _hop3_block_rows(G2: int, SRB3: int):
    """Smallest dest block size whose source block is 8-divisible and within
    the kernel's caps, or None."""
    for b in (8, 16, 32, 64, 128, 256):
        if b % G2:
            continue
        srb = (b // G2) * SRB3
        if srb % 8 == 0 and srb <= MAX_SRC_ROWS:
            return b
    return None


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_static_gather(
    src_of_dest: np.ndarray,   # int64 [MD] (MD % 1024 == 0); -1 = pad slot
    n_src_pad: int,            # padded source length (multiple of 1024)
    allow_cap: bool = True,    # False for the overflow recursion (depth 1)
) -> Optional[dict]:
    """Three-hop routing plan for ``out[k] = src[src_of_dest[k]]``.

    Returns None when no feasible geometry exists (then the caller falls
    back to another operator).  Pad slots (-1) read source position 0.
    The JAX package's planner, copied with its TPU-calibrated cost model."""
    MD = len(src_of_dest)
    assert MD % 1024 == 0 and n_src_pad % 1024 == 0
    D = MD // 1024
    real = src_of_dest >= 0
    e_dest = np.flatnonzero(real)
    src = src_of_dest[e_dest]
    A = n_src_pad // 1024
    if A % 8:
        return None  # caller pads the source to 8-row multiples
    dest_row = e_dest // 1024
    a = src // 1024

    g = np.gcd(A, 1024)
    q_t1 = 1024 // g  # W1 granularity so I1' rows are 1024-aligned

    best = None
    for B1 in _B1_CANDIDATES:
        if B1 > 8 and B1 * 8 > 2 * D:
            continue  # groups saturate below 8 dest rows: no finer fan-out
        G1 = _round_up(-(-D // B1), 8)
        g1 = np.minimum(dest_row // G1, B1 - 1)
        key1 = a * B1 + g1
        cnt1 = np.bincount(key1, minlength=A * B1)
        W1 = int(cnt1.max(initial=1))
        # 128-multiple W1: T1's transpose minor dimension is W1, and a
        # sub-lane-width minor dim runs the XLA transpose ~20x below
        # bandwidth (measured 6.6 ms for 100 MB at W1=48)
        W1 = _round_up(W1, int(np.lcm(np.lcm(max(8192 // B1, 1), q_t1),
                                      128)))
        f1 = B1 * W1 // 1024
        if f1 * 8 > MAX_BLOCK_ROWS:
            continue  # hop-1 dest block (8 * f1 rows) beyond the kernel cap
        RB = A * W1 // 1024
        order1 = np.argsort(key1, kind="stable")
        starts1 = np.zeros(A * B1 + 1, np.int64)
        np.cumsum(cnt1, out=starts1[1:])
        rank1 = np.empty(len(src), np.int64)
        rank1[order1] = np.arange(len(src)) - starts1[key1[order1]]
        pos1t = g1 * (A * W1) + a * W1 + rank1
        b_global = pos1t // 1024
        NB1 = B1 * RB
        variants = [(8, False), (4, False), (2, False), (1, False)]
        if allow_cap:
            variants.append((1, True))
        for G2, capped in variants:
            NRg = G1 // G2
            region = dest_row // G2
            r_local = region - g1 * NRg
            key2 = b_global * NRg + r_local
            cnt2 = np.bincount(key2, minlength=NB1 * NRg)
            W2max = int(cnt2.max(initial=1))
            if capped:
                # cap the per-cell slot count near the MEAN and route the
                # tail through a small second pipeline: the Poisson tail
                # (measured max 23 vs mean 3.45 on random 8/row) otherwise
                # pads hop 2 + its transpose ~7x.  Only worth it when the
                # tail is THIN: with few source rows the per-(source-row,
                # dest-row) counts are structurally heavy, the overflow
                # inherits the same concentration, and its recursive plan
                # blows up (measured at n = 32768: 10% overflow, sub-plan
                # W2 = 870 -> infeasible)
                nz = cnt2[cnt2 > 0]
                W2 = max(2, int(np.ceil(2.0 * nz.mean()))) if len(nz) else 2
                if W2 >= W2max:
                    continue  # no tail to shed; identical to uncapped
                n_ovf_est = int(np.maximum(cnt2 - W2, 0).sum())
                if n_ovf_est > 0.06 * len(src):
                    continue
            else:
                W2 = W2max
            if NRg * W2 > 8192:
                continue
            P = next((pp for pp in (1, 2, 4, 8)
                      if NRg * W2 <= pp * 1024), None)
            # capped regions append the overflow splice slots (bounded by
            # one lane block per 128; exact V computed at emit time —
            # reserve a conservative 256 in the feasibility/cost check)
            v_guess = 256 if capped else 0
            SRB3 = -(-(RB * W2 + v_guess) // 1024)
            # the sweep cost is per-REGION (SRB3 rows); the source block
            # ((BR3 // G2) * SRB3 rows of VMEM) only needs to satisfy the
            # kernel's 8-divisibility and size caps
            BR3 = _hop3_block_rows(G2, SRB3)
            if P is None or SRB3 > MAX_W_ROWS or BR3 is None:
                continue
            slots1 = A * B1 * W1
            slots2 = NB1 * P * 1024
            # ns-calibrated stage model (the JAX package's, from a TPU):
            # sweeps 0.023 ns/elt/window-row, streams ~0.011 ns/B at
            # 700 GB/s, sub-lane-aligned transpose ~0.088 ns/elt
            n_ovf = int(np.maximum(cnt2 - W2, 0).sum()) if capped else 0
            cost = (slots1 * 70 + slots2 * (34 + 88)
                    + D * 1024 * (23 * SRB3 + 17)
                    + n_ovf * 400 + (D * v_guess * 40 if capped else 0))
            cand = (cost, B1, G1, G2, NRg, W1, RB, P, W2, SRB3, BR3,
                    capped, g1, rank1, pos1t, b_global, r_local, key2,
                    cnt2)
            if best is None or cost < best[0]:
                best = cand
    if best is None:
        return None
    (_, B1, G1, G2, NRg, W1, RB, P, W2, SRB3, BR3, capped,
     g1, rank1, pos1t, b_global, r_local, key2, cnt2) = best

    f1 = B1 * W1 // 1024
    RD1 = A * B1 * W1 // 1024
    idx1 = np.zeros(RD1 * 1024, np.int32)
    pos1 = a * (B1 * W1) + g1 * W1 + rank1
    idx1[pos1] = (src % 1024).astype(np.int32)

    order2 = np.argsort(key2, kind="stable")
    starts2 = np.zeros(len(cnt2) + 1, np.int64)
    np.cumsum(cnt2, out=starts2[1:])
    rank2 = np.empty(len(src), np.int64)
    rank2[order2] = np.arange(len(src)) - starts2[key2[order2]]
    b_local = b_global - g1 * RB
    D_pad = _round_up(D, BR3)
    main = rank2 < W2 if capped else slice(None)
    RD2 = B1 * RB * P
    idx2 = np.zeros(RD2 * 1024, np.int32)
    pos2 = (b_global * (P * 1024) + r_local * W2 + rank2)[main]
    idx2[pos2] = (pos1t % 1024)[main].astype(np.int32)

    V = 0
    ovf_src = None
    ovf_rank = None
    if capped:
        ovf = np.flatnonzero(rank2 >= W2)
        reg_o = dest_row[ovf]  # G2 == 1: region id = dest row
        cnt_o0 = np.bincount(reg_o, minlength=D)
        V = _round_up(int(cnt_o0.max(initial=1)), 128)
        SRB3 = -(-(RB * W2 + V) // 1024)
        BR3 = _hop3_block_rows(G2, SRB3)
        if V > 2048 or BR3 is None or SRB3 > MAX_W_ROWS:
            # the capped winner is infeasible at its EXACT overflow width
            # (the search used a conservative guess); fall back to the
            # best uncapped candidate instead of rejecting the matrix
            return plan_static_gather(src_of_dest, n_src_pad,
                                      allow_cap=False)
        D_pad = _round_up(D, BR3)
        cnt_o = np.zeros(D_pad, np.int64)
        cnt_o[: len(cnt_o0)] = cnt_o0
        ord_o = np.argsort(reg_o, kind="stable")
        st_o = np.zeros(D_pad + 1, np.int64)
        np.cumsum(cnt_o, out=st_o[1:])
        ovf_rank = np.empty(len(ovf), np.int64)
        ovf_rank[ord_o] = np.arange(len(ovf)) - st_o[reg_o[ord_o]]
        ovf_src = np.full(D_pad * V, -1, np.int64)
        ovf_src[reg_o * V + ovf_rank] = src[ovf]

    idx3 = np.zeros(D_pad * 1024, np.int32)
    # rank2-major within the region row: matches apply_static_gather's
    # lane-major T2 layout (plain 2-D transpose; see the T2 comment there)
    idx3[e_dest] = (rank2 * RB + b_local).astype(np.int32)
    if capped:
        idx3[e_dest[ovf]] = (RB * W2 + ovf_rank).astype(np.int32)

    return {
        "A": A, "B1": B1, "G1": G1, "G2": G2, "NRg": NRg, "W1": W1,
        "RB": RB, "P": P, "W2": W2, "SRB3": SRB3, "BR3": BR3, "f1": f1,
        "D": D, "D_pad": D_pad, "V": V,
        "idx1": idx1.reshape(RD1, 1024),
        "idx2": idx2.reshape(RD2, 1024),
        "idx3": idx3.reshape(D_pad, 1024),
        "ovf_src": ovf_src,
    }


def static_gather_hops(plan, device) -> tuple:
    """The three K10 hops of ``plan``, checked once (:class:`GatherHop`)."""
    f1, P, SRB3, G2, BR3 = (plan[k] for k in ("f1", "P", "SRB3", "G2", "BR3"))
    return (
        GatherHop(8 * f1, 8, [dl // f1 for dl in range(8 * f1)],
                  device=device),
        GatherHop(8 * P, 8, [dl // P for dl in range(8 * P)], device=device),
        GatherHop(BR3, (BR3 // G2) * SRB3,
                  [(dl // G2) * SRB3 for dl in range(BR3)], w_rows=SRB3,
                  device=device),
    )


def apply_static_gather(x_pad, plan, idx1, idx2, idx3, vals3, ovf=None,
                        hops=None):
    """Run the planned pipeline: [A * 1024] source -> [D_pad, 1024] products
    (gathered values scaled by ``vals3``; a pure gather when it is None).
    ``ovf`` = (plan_o, idx1_o, idx2_o, idx3_o[, hops_o]) for the capped
    tail: an uncapped pipeline gathers the overflow elements, spliced into
    each region's tail slots by concatenation.  ``hops`` are the plan's
    :func:`static_gather_hops`, made here when not given."""
    A, B1, W1 = plan["A"], plan["B1"], plan["W1"]
    RB, NRg, P, W2 = plan["RB"], plan["NRg"], plan["P"], plan["W2"]
    SRB3, G2 = plan["SRB3"], plan["G2"]
    V = plan.get("V", 0)
    h1, h2, h3 = hops or static_gather_hops(plan, x_pad.device)
    i1 = gather_hop(h1, x_pad, idx1)
    i1t = i1.reshape(A, B1, W1).permute(1, 0, 2).contiguous().reshape(-1)
    i2 = gather_hop(h2, i1t, idx2)
    i2g = i2.reshape(B1, RB, P * 1024)[:, :, : NRg * W2]
    # T2: a plain 2-D transpose per group, (RB, NRg * W2) -> (NRg * W2, RB);
    # idx3 encodes rank2 * RB + b_local to match this layout
    i2t = i2g.permute(0, 2, 1).contiguous().reshape(B1 * NRg, W2 * RB)
    n_regions = plan["D_pad"] // G2
    if i2t.shape[0] < n_regions:
        i2t = F.pad(i2t, (0, 0, 0, n_regions - i2t.shape[0]))
    elif i2t.shape[0] > n_regions:
        i2t = i2t[:n_regions]
    if V:
        plan_o, i1o, i2o, i3o, *hops_o = ovf
        flat_o = apply_static_gather(
            x_pad, plan_o, i1o, i2o, i3o, None,
            hops=hops_o[0] if hops_o else None).reshape(-1)[: n_regions * V]
        i2t = torch.cat([i2t, flat_o.reshape(n_regions, V)], dim=1)
    pad = SRB3 * 1024 - i2t.shape[1]
    if pad:
        i2t = F.pad(i2t, (0, pad))
    return gather_hop(h3, i2t.contiguous().reshape(-1), idx3, vals3)


def _plan_meta(plan):
    return {k: plan[k] for k in plan
            if not k.startswith("idx") and k != "ovf_src"}


class GeneralSpmvOperator:
    """y = A @ x for arbitrary sparsity on the routed-gather pipeline
    (single piece): 3 launches of K10 per matvec, 6 with an overflow
    sub-plan.  Rows should arrive sorted by descending degree (the
    planner's degree basis) for tight SELL tiles; any order is correct."""

    def __init__(
        self,
        matrix,
        partition: BlockPartition,
        options: SolverOptions = DEFAULT_OPTIONS,
        device=None,
    ):
        if partition.num_pieces != 1:
            raise ValueError("GeneralSpmvOperator is single-piece only")
        self.matrix = matrix
        self.partition = partition
        self.options = options
        self.device = dev = resolve_device(device)
        dtype = numpy_dtype(options.entry_dtype)
        P_vec = partition.padded_size

        rows = np.asarray(matrix.rows, np.int64)
        cols = np.asarray(matrix.cols, np.int64)
        vals = np.asarray(matrix.vals, np.float64)
        # combine duplicate (row, col) entries (COO semantics, reference:
        # COOMatrixTasks.cpp:38-39)
        order = np.lexsort((cols, rows))
        r, c, v = rows[order], cols[order], vals[order]
        if len(r):
            new = np.empty(len(r), bool)
            new[0] = True
            new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
            if not new.all():
                st = np.flatnonzero(new)
                v = np.add.reduceat(v, st)
                r, c = r[new], c[new]
        # the diagonal is elementwise, y += d * x, outside the pipeline: a
        # full diagonal would otherwise blow the routing maxima
        on_diag = r == c
        diag = np.zeros(P_vec, np.float64)
        if on_diag.any():
            diag[r[on_diag]] = v[on_diag]
            r, c, v = r[~on_diag], c[~on_diag], v[~on_diag]
        self.diag = torch.as_tensor(diag.astype(dtype), device=dev)
        counts = np.bincount(r, minlength=P_vec)
        # SELL tiles of 1024 rows: per-tile slot count = that tile's max
        nt = _round_up(P_vec, 1024) // 1024
        cpad = np.zeros(nt * 1024, np.int64)
        cpad[: len(counts)] = counts
        Lt = np.maximum(cpad.reshape(nt, 1024).max(axis=1), 1)
        row_off = np.concatenate([[0], np.cumsum(Lt)])  # dest rows per tile
        D = _round_up(int(row_off[-1]), 8)
        MD = D * 1024
        if MD > 6 * max(len(r), P_vec):
            raise ValueError("SELL padding pathological (mega-degree row)")

        row_start = np.concatenate([[0], np.cumsum(counts)])
        # slots de-biased by a per-row cyclic shift (keeps the routing
        # maxima low, as in the JAX package)
        colrank = np.arange(len(r)) - row_start[r]
        slot = (colrank + r) % counts[r].clip(min=1)
        dest = (row_off[r // 1024] + slot) * 1024 + (r % 1024)

        src_of_dest = np.full(MD, -1, np.int64)
        src_of_dest[dest] = c
        A_src = _round_up(max(P_vec, 1024) // 1024, 8)
        self._n_src_pad = A_src * 1024
        plan = plan_static_gather(src_of_dest, self._n_src_pad)
        if plan is None:
            raise ValueError("no feasible routing geometry for this matrix")
        vals3 = np.zeros(plan["D_pad"] * 1024, dtype)
        vals3[dest] = v.astype(dtype)
        as_dev = lambda a: torch.as_tensor(a, device=dev)
        self._plan = _plan_meta(plan)
        self._hops = static_gather_hops(plan, dev)
        self.idx1 = as_dev(plan["idx1"])
        self.idx2 = as_dev(plan["idx2"])
        self.idx3 = as_dev(plan["idx3"])
        self.vals3 = as_dev(vals3.reshape(plan["D_pad"], 1024))
        self._ovf_plan = self._ovf_hops = None
        self.ovf_idx = None
        if plan.get("V", 0):
            plan_o = plan_static_gather(plan["ovf_src"], self._n_src_pad,
                                        allow_cap=False)
            if plan_o is None:
                raise ValueError("overflow sub-plan failed")
            self._ovf_plan = _plan_meta(plan_o)
            self._ovf_hops = static_gather_hops(plan_o, dev)
            self.ovf_idx = tuple(as_dev(plan_o[k])
                                 for k in ("idx1", "idx2", "idx3"))
        # phase-2 segments: consecutive tiles sharing one slot count
        segs = []
        t0 = 0
        for t in range(1, nt + 1):
            if t == nt or Lt[t] != Lt[t0]:
                segs.append((int(row_off[t0]), t - t0, int(Lt[t0])))
                t0 = t
        self._segments = tuple(segs)
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
    def launches_per_matvec(self) -> int:
        return 6 if self._ovf_plan is not None else 3

    supports_matvec_dot = False
    uses_pallas = True  # the name of the JAX flag: the hops are K10

    def device_state(self):
        return (self.idx1, self.idx2, self.idx3, self.vals3, self.ovf_idx,
                self.diag)

    def set_device_state(self, state) -> None:
        (self.idx1, self.idx2, self.idx3, self.vals3, self.ovf_idx,
         self.diag) = state

    def matvec(self, x: torch.Tensor) -> torch.Tensor:
        P_vec = self.partition.padded_size
        x = x.reshape(-1)
        ovf = ((self._ovf_plan, *self.ovf_idx, self._ovf_hops)
               if self._ovf_plan is not None else None)
        prod = apply_static_gather(_pad_to(x, self._n_src_pad), self._plan,
                                   self.idx1, self.idx2, self.idx3,
                                   self.vals3, ovf=ovf, hops=self._hops)
        parts = [prod[row0: row0 + ntile * L].reshape(ntile, L, 1024)
                 .sum(dim=1).reshape(-1)
                 for row0, ntile, L in self._segments]
        y = torch.cat(parts) if len(parts) > 1 else parts[0]
        return y[:P_vec] + self.diag * x

    def matvec_add(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return y + self.matvec(x)

    def transpose(self) -> "GeneralSpmvOperator":
        """A^T on a fresh plan of the swapped pattern (the reference stubs
        rmatvec, COOMatrixTasks.cpp:78-83)."""
        if self._transpose_op is None:
            self._transpose_op = GeneralSpmvOperator(
                _Swapped(self.matrix), self.partition, self.options,
                device=self.device)
        return self._transpose_op

    def rmatvec(self, x: torch.Tensor) -> torch.Tensor:
        return self.transpose().matvec(x)


def degree_sort_perm(matrix) -> np.ndarray:
    """perm[i] = original row index at sorted position i, rows by
    descending degree (stable): packs SELL tiles tightly."""
    n = matrix.n_range
    counts = np.bincount(np.asarray(matrix.rows, np.int64), minlength=n)
    return np.argsort(-counts, kind="stable")
