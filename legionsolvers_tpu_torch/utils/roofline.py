"""Device-memory traffic model for solver benchmarks.

Port of ``legionsolvers_tpu/utils/roofline.py``: the same bytes-per-
iteration accounting, so both packages report the same schedule label and
bytes per unknown for one configuration (reference: BenchmarkStencil.cpp:
255-262).  The model counts vector passes per unknown per iteration for
the schedule ``solve()`` will run on the matrix-free stencil operator
(O(1) matrix bytes); each read or write of a length-n vector costs
``n * itemsize``, and passes the implementation provably fuses count once.

CG schedules (``solvers/cg.py``, ``parallel/stencil_op.py``):

* ``fused2d_x2``: the s-step pass (K1), read x/r/p and write x/r/p once
  per TWO iterations, 12 B/unknown at f32, plus a K2 Gram refresh every
  LEGIONSOLVERS_SSTEP_REFRESH passes;
* ``fused2d``: two passes per iteration (K4 xpay_pq 3 + K3 update 5);
* ``fused3d_xp``: the 3-D two-pass schedule (K6b 3 + K6a update 5);
* ``fused_jnp``: the whole-loop torch runner, 12 passes;
* ``classic``: ``step()`` per iteration, 14 passes.

BiCGStab: the three fused passes (K5 or K7) move 15 passes; the
``step()`` transcription 24 (25 without a fused matvec + dot).  GMRES(m)
per cycle: :func:`gmres_passes` (MGS) and :func:`gmres_cgs2_passes` (the
batched CGS2 runner).  PCG: the 6-pass step that the JAX package's
compiler fuses it into, kept as the schedule's minimum.

The s-step compute model (:func:`sstep_vpu_op_counts`) is the JAX
package's TPU op count (arithmetic, lane rolls, sublane row shifts), kept
as it is and fed with this card's K11 rates (``utils/vpu_probe.py``).
"""

from __future__ import annotations

import os

CG_PASSES = {
    "fused2d_x2": 3,  # s-step: read x/r/p + write x/r/p per TWO iterations
    "fused2d": 8,
    "fused3d_xp": 8,  # xpay_pq (12) + update (20)
    "fused3d": 9,     # xpay (12) + pq (4) + update (20)
    "fused_jnp": 12,
    "classic": 14,
}


def _sstep_refresh_passes() -> float:
    """Extra passes per iteration of the s-step drift guard: a K2 Gram
    pass (2 reads) every REFRESH passes of 2 iterations each."""
    refresh = int(os.environ.get("LEGIONSOLVERS_SSTEP_REFRESH", "16"))
    return 1.0 / refresh if refresh > 0 else 0.0


def operator_matvec_passes(op) -> int:
    """Vector-length passes one y = A x costs: read x + write y = 2 for
    matrix-free stencils; + D coefficient streams for the DIA operator; +
    2L index/value streams for the ELL layout."""
    if hasattr(op, "_view") and type(op).__name__ == "DiaOperator":
        v = op._view
        d = len(v["offs"]) if v is not None else len(op.flat_offsets)
        return 2 + d
    if type(op).__name__ == "RowPartitionedMatrix":
        return 2 + 2 * op.row_length
    return 2


def _op_cg_kind(op) -> str:
    """Per-operator fused-CG schedule label."""
    view = getattr(op, "_view", None)
    if view is None:
        return "fused_jnp"
    if view.get("kind") == "3d":
        from ..ops.cuda.stencil3d import supports3d_xpay_pq

        if supports3d_xpay_pq(view["Br"], view["Y"], view["Z"],
                              view["offs3"]):
            return "fused3d_xp"
        return "fused3d"
    if getattr(op, "step2_eligible", False):
        return "fused2d_x2"
    return "fused2d"


def cg_schedule(solver) -> str:
    """Which CG schedule ``solver.solve()`` runs, by the capability
    questions ``CGSolver._make_fused_runner`` asks.  Block systems are not
    ported (the benchmark refuses them): a multi-space planner takes the
    ``step()`` path."""
    from ..parallel.block_fused import diagonal_block_ops

    planner = solver.planner
    ops = diagonal_block_ops(planner)
    if (ops is not None and planner.num_spaces == 1
            and all(getattr(op, "supports_fused_cg", False) for op in ops)):
        return _op_cg_kind(ops[0])
    fusable = all(getattr(op, "supports_matvec_dot", False)
                  for op, _, _ in planner.row_partitioned_matrices)
    return "fused_jnp" if fusable else "classic"


def gmres_passes(m: int) -> int:
    """Vector passes per GMRES(m) cycle of the MGS transcription."""
    passes = 9  # residual: matvec(2) + xpay(3) + dot(1) + scal(3)
    for j in range(m):
        passes += 2            # matvec
        passes += 2 * (j + 1)  # MGS dots
        passes += 3 * (j + 1)  # MGS axpys
        passes += 1            # norm dot
        if j + 1 < m:
            passes += 3        # scal
    passes += 3 * m            # solution update axpys
    return passes


def gmres_cgs2_passes(m: int) -> int:
    """Vector passes per GMRES(m) cycle of the batched CGS2 runner:
    residual (read x + b, write V0, + matvec); per Arnoldi step j: matvec
    (2), two projection and two rank-update products (4 sweeps of the j+1
    basis rows plus ~4 of w), norm and scaled write of V[j+1] (2);
    solution update (read V[:m] + x, write x)."""
    passes = 4
    for j in range(m):
        passes += 2 + 4 * (j + 1) + 4 + 2
    passes += m + 2
    return passes


def solver_bytes_per_iteration(solver, n: int) -> tuple:
    """(bytes per iteration for the whole system, schedule label) for CG,
    BiCGStab, GMRES (per cycle) and PCG.  ``n``: total unknowns."""
    from ..parallel.block_fused import diagonal_block_ops

    planner = solver.planner
    itemsize = planner.options.entry_dtype.itemsize
    name = type(solver).__name__
    ops = [op for op, _, _ in planner.row_partitioned_matrices]
    # streams beyond the matrix-free 2-pass matvec (DIA coefficients, ELL
    # index/value slabs), charged once per matvec of the schedule
    extra = max((operator_matvec_passes(op) - 2 for op in ops), default=0)
    if name == "PCGSolver":
        return (6 + 2 * extra) * itemsize * n, "pcg_jacobi"
    if name == "CGSolver":
        sched = cg_schedule(solver)
        passes = CG_PASSES[sched] + (extra if sched in ("fused_jnp",
                                                        "classic") else 0)
        if sched == "fused2d_x2":
            passes = passes + _sstep_refresh_passes()
        label = sched if extra == 0 else f"{sched}+{extra}"
        return passes * itemsize * n, label
    if name == "BiCGStabSolver":
        dops = diagonal_block_ops(planner)
        if (dops is not None and planner.num_spaces == 1
                and all(getattr(op, "supports_fused_bicgstab", False)
                        for op in dops)):
            kind = getattr(dops[0], "_view", None) or {}
            label = ("bicgstab_fused3d" if kind.get("kind") == "3d"
                     else "bicgstab_fused2d")
            return 15 * itemsize * n, label
        fused = all(getattr(op, "supports_matvec_dot", False)
                    for op in ops) and len(ops) == planner.num_spaces
        passes = (24 if fused else 25) + 2 * extra
        return passes * itemsize * n, ("bicgstab_fused" if fused
                                       else "bicgstab")
    if name == "GMRESSolver":
        m = solver.restart
        fused = solver._make_fused_runner() is not None
        base = gmres_cgs2_passes(m) if fused else gmres_passes(m)
        passes = base + extra * (m + 1)  # m + 1 matvecs per cycle
        label = f"gmres{m}_cgs2" if fused else f"gmres{m}_mgs"
        return passes * itemsize * n, label
    raise ValueError(f"no traffic model for {name}")


# ---------------------------------------------------------------------------
# The s-step compute model: op counts per element of one K1 pass (the JAX
# package's TPU count, kept as it is), converted to time with rates that an
# independent probe (K11) measured on this card.
# ---------------------------------------------------------------------------

def sstep_vpu_op_counts(offsets, values) -> dict:
    """Per-element op counts for ONE step2 pass (TWO CG iterations): 5
    stencil applications, each costing per offset 1 arithmetic op (2 for a
    coefficient other than +-1), a lane roll when dx != 0 and a row shift
    when dy != 0; 3 mask multiplies; ~13 linear-combination ops; 10 Gram
    dots of 2 ops each."""
    n_apply = 5
    arith = rolls = rows = 0
    for (dy, dx), v in zip(offsets, values):
        arith += 1 if v in (1.0, -1.0) else 2
        rolls += 1 if dx != 0 else 0
        rows += 1 if dy != 0 else 0
    return {
        "arith": n_apply * arith + 3 + 13 + 20,
        "roll": n_apply * rolls,
        "row": n_apply * rows,
    }


def compute_seconds_per_element(op_counts: dict, rates: dict) -> float:
    """Seconds per element from op counts and the probe's rates: an
    arithmetic op at half the fma flop rate (one instruction), a roll or
    row shift at its measured step rate less the bundled add's cost."""
    t_arith = 1.0 / (rates["vpu_fma_ops_per_s"] / 2.0)
    t_roll = max(1.0 / rates["vpu_roll_plus_add_reps_per_s"] - t_arith, 0.0)
    t_row = max(1.0 / rates["vpu_row_shift_add_reps_per_s"] - t_arith, 0.0)
    return (op_counts["arith"] * t_arith + op_counts["roll"] * t_roll
            + op_counts["row"] * t_row)


def sstep_compute_seconds_per_iteration(offsets, values, n, rates) -> float:
    """Compute-roofline seconds per CG iteration of the s-step schedule
    (one pass = two iterations)."""
    per_elt = compute_seconds_per_element(
        sstep_vpu_op_counts(offsets, values), rates)
    return per_elt * n / 2.0
