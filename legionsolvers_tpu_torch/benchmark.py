"""BenchmarkStencil equivalent: the reference's benchmark program as a CLI.

Port of ``legionsolvers_tpu/benchmark.py`` (reference:
test/BenchmarkStencil.cpp): ``-dim 1..4`` (1-D 3-point, 2-D 5-point, 3-D
7-point, 3-D 27-point Laplacian), ``-solver 1..4`` (CG, BiCGStab,
GMRES(restart), PCG with Jacobi), grid sizes ``-nx -ny -nz``, iterations
``-it`` (cycles for GMRES).  Prints "Achieved X ms per iteration" like the
reference (:255-262), with nnz/s and the share of the binding roofline:
the traffic model of ``utils/roofline.py`` over the stream bandwidth
measured in place, or for the s-step CG schedule the compute model fed
with the card's K11 rates when that is larger.  A compute estimate the
kernel already beat is discarded, never printed as over 100%.

Runs on the card unless ``--device`` names another.  ``--block`` solves
the reference's 2-space block system (the same operator registered on
each space) on the per-space kernel passes of
``parallel/block_fused.py``.  ``-vp N`` (N > 1) partitions the system into
N pieces on a mesh of N shards on the one device
(``make_mesh(N, devices=[device] * N)``), for every ``-dim``, ``-solver``
and ``--block``: each kernel pass runs once per piece, and the report
names the pieces and the schedule.  The roofline counts the same bytes as
on one piece: the halo copies and edge fix-ups between the pieces are
glue, not minimum traffic.  What the JAX CLI does and the port cannot yet
do raises ``NotImplementedError`` and names the ROADMAP item or fault:
``--consume-rhs`` (the 3-live-vector CG schedule, item 6) and ``--dtype
bfloat16`` (no bf16 oracle, fault F2).  ``-dim 1`` runs the 1-D kernel
view where the grid has one (``-nx`` a multiple of some C in 4096 ..
128 with at least 8 rows of C per piece; vectors laid out as ``[n // C,
C]``), on the kernels JAX picks: the s-step K1/K2 for CG on one piece,
two-pass K3/K4 on pieces, K5 for BiCGStab; smaller grids run the
linearized torch path.

Usage:  python -m legionsolvers_tpu_torch.benchmark -dim 2 -nx 4096 -ny 4096 -it 200
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch

#: Solves run by the last :func:`main`, by length (iterations or cycles),
#: and the K1 passes of its compute-ceiling probe under "step2_ceiling".
RUNS = collections.Counter()

NAMES = {1: "CG", 2: "BiCGStab", 3: "GMRES({restart})", 4: "PCG(Jacobi)"}
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_planner(args, options, device, mesh=None):
    """(planner, unknowns, nnz) of the system b = 1, x0 = 0 on ``-dim``'s
    Laplacian in ``-vp`` pieces on ``mesh``, as
    ``entry.build_stencil_system`` builds it; with ``--block`` the operator
    is registered on each of two spaces, and the unknowns and nnz count
    both."""
    from .entry import build_stencil_system
    from .problems.stencil import (
        calculate_stencil_size,
        laplacian_stencil,
        stencil_grid_ndim,
    )

    nd = stencil_grid_ndim(args.dim)
    shape = tuple([args.nx, args.ny, args.nz][:nd])
    num_spaces = 2 if args.block else 1
    planner = build_stencil_system(args.dim, shape, options, device,
                                   num_spaces, pieces=args.vp, mesh=mesh)
    nnz = calculate_stencil_size(shape, laplacian_stencil(args.dim))
    return planner, int(np.prod(shape)) * num_spaces, nnz * num_spaces


def make_parser():
    """The JAX CLI's flags, and ``--device``."""
    p = argparse.ArgumentParser(
        description="BenchmarkStencil on the PyTorch port")
    p.add_argument("-dim", type=int, default=2, choices=[1, 2, 3, 4])
    p.add_argument("-solver", type=int, default=1, choices=[1, 2, 3, 4],
                   help="1=CG 2=BiCGStab 3=GMRES(restart) 4=PCG+Jacobi")
    p.add_argument("-nx", type=int, default=4096)
    p.add_argument("-ny", type=int, default=4096)
    p.add_argument("-nz", type=int, default=256)
    p.add_argument("-vp", type=int, default=1, help="pieces (mesh shards)")
    p.add_argument("-it", type=int, default=200, help="timed iterations")
    p.add_argument("-restart", type=int, default=10, help="GMRES restart")
    p.add_argument("--block", action="store_true",
                   help="2-space block system")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--bw", type=float, default=None,
                   help="pre-measured stream bandwidth (bytes/s): skips "
                   "the probe")
    p.add_argument("--consume-rhs", action="store_true",
                   help="CG with 3 live vectors (not ported)")
    p.add_argument("--device", default=None,
                   help="device to run on (default: the card)")
    return p


def _refuse_unported(args) -> None:
    consume = args.consume_rhs or (args.solver == 1 and bool(
        os.environ.get("LEGIONSOLVERS_CONSUME_RHS")))
    if consume:
        raise NotImplementedError(
            "--consume-rhs: the 3-live-vector CG schedule is not ported "
            "(ROADMAP item 6: the port holds 5 live CG vectors)")
    if args.dtype == "bfloat16":
        raise NotImplementedError(
            "--dtype bfloat16: no bf16 oracle exists (ROADMAP fault F2)")


def make_solver(args, planner):
    """The solver ``-solver`` names, on ``planner``."""
    from .solvers.bicgstab import BiCGStabSolver
    from .solvers.cg import CGSolver
    from .solvers.gmres import GMRESSolver
    from .solvers.pcg import JacobiPreconditioner, PCGSolver

    if args.solver == 1:
        return CGSolver(planner)
    if args.solver == 2:
        return BiCGStabSolver(planner)
    if args.solver == 4:
        return PCGSolver(planner, JacobiPreconditioner(planner))
    return GMRESSolver(planner, restart=args.restart)


def _seconds_per_iter(run, short, long, floor_s):
    """Marginal seconds per iteration; a time under ``floor_s`` (the
    schedule's bytes at the measured bandwidth) is measured again over a
    window four times longer and then refused."""
    from .utils.timing import marginal_seconds_per_iter

    sec = marginal_seconds_per_iter(run, short, long)
    if floor_s is not None and sec < floor_s:
        sec = marginal_seconds_per_iter(run, short, 4 * long)
        if sec < floor_s:
            raise RuntimeError(
                f"{sec * 1e3:.6f} ms per iteration moves the schedule's "
                f"bytes faster than the measured bandwidth allows "
                f"({floor_s * 1e3:.6f} ms): refusing an impossible time")
    return sec


def _compute_roofline(planner, n, ms, sol_ms, bw, device):
    """(roofline ms, binding) after the s-step compute side: the K11-fed
    model binds where it exceeds the stream time and the kernel has not
    beaten it; the measured K1 ceiling (L2-resident) is printed beside."""
    from .utils import vpu_probe
    from .utils.roofline import sstep_compute_seconds_per_iteration
    from .utils.timing import measure_step2_compute_ceiling

    view = getattr(planner.row_partitioned_matrices[0][0], "_view", None)
    rates = vpu_probe.load_or_measure(device=device)
    if rates is None or view is None:
        return sol_ms, "stream"
    comp_ms = sstep_compute_seconds_per_iteration(
        view["offs"], view["vals"], n, rates) * 1e3
    print(f"[bench] s-step compute model (op rates: fma "
          f"{rates['vpu_fma_ops_per_s'] / 1e12:.2f} TFLOP/s, roll "
          f"{rates['vpu_roll_plus_add_reps_per_s'] / 1e9:.1f} G/s, row "
          f"{rates['vpu_row_shift_add_reps_per_s'] / 1e9:.1f} G/s): "
          f"{comp_ms:.6f} ms/iter; stream {sol_ms:.6f} ms/iter",
          file=sys.stderr)
    per_elt, apparent, passes = measure_step2_compute_ceiling(
        view["offs"], view["vals"], C=view["C"], device=device)
    RUNS["step2_ceiling"] += passes
    if apparent > 1.5 * bw:
        print(f"[bench] measured step2 compute ceiling: "
              f"{per_elt * 1e12:.2f} ps/elt (resident at "
              f"{apparent / 1e9:.0f} GB/s apparent) -> "
              f"{per_elt * n / 2 * 1e3:.6f} ms/iter", file=sys.stderr)
    else:
        print(f"[bench] note: compute-ceiling probe not resident "
              f"({apparent / 1e9:.0f} GB/s apparent)", file=sys.stderr)
    if ms < comp_ms:
        print("[bench] note: the kernel beat the compute model; "
              "stream-only roofline", file=sys.stderr)
        return sol_ms, "stream"
    if comp_ms > sol_ms:
        return comp_ms, "compute"
    return sol_ms, "stream"


def main(argv=None, bw=None):
    """Run one benchmark configuration; returns the metrics dict of the
    JAX package's ``main`` (and prints its lines).  ``bw``: stream
    bandwidth in bytes/s measured beforehand (skips the probe)."""
    from .options import SolverOptions, resolve_device
    from .parallel.mesh import make_mesh
    from .utils.roofline import solver_bytes_per_iteration
    from .utils.timing import measure_stream_bandwidth

    args = make_parser().parse_args(argv)
    if bw is None:
        bw = args.bw
    _refuse_unported(args)
    device = resolve_device(args.device)
    RUNS.clear()

    options = SolverOptions(entry_dtype=DTYPES[args.dtype])
    mesh = (make_mesh(args.vp, devices=[device] * args.vp) if args.vp > 1
            else None)
    planner, n, nnz = build_planner(args, options, device, mesh)
    solver = make_solver(args, planner)
    bytes_per_iter, schedule = solver_bytes_per_iteration(solver, n)
    print(f"[bench] schedule: {schedule} "
          f"({bytes_per_iter / n:.0f} B/unknown/iter)", file=sys.stderr)

    if bw is None and device.type == "cuda":
        bw = measure_stream_bandwidth(device=device)
    if bw is not None:
        print(f"[bench] measured stream bandwidth: {bw / 1e9:.1f} GB/s",
              file=sys.stderr)

    def run(iters):
        # identical work every run: x0 = 0, b = 1, workspace re-derived
        for v in planner.sol_vectors:
            v.zero_fill()
        solver.reset()
        RUNS[iters] += 1
        return solver.solve(iters)

    short = max(args.it // 5, 1)
    run(short), run(args.it)  # warm-up of both lengths
    floor_s = bytes_per_iter / bw if bw is not None else None
    sec_per_iter = _seconds_per_iter(run, short, args.it, floor_s)
    hist = run(args.it).double().cpu().numpy()

    ms = sec_per_iter * 1e3
    name = NAMES[args.solver].format(restart=args.restart)
    print(f"[bench] dim={args.dim} {name} n={n} pieces={args.vp} "
          f"dtype={args.dtype}: residual2[{args.it}]={hist[-1]:.4g}",
          file=sys.stderr)
    pct = None
    binding = "stream"
    if bw is not None:
        sol_ms = bytes_per_iter / bw * 1e3
        if schedule.startswith("fused2d_x2") and device.type == "cuda":
            sol_ms, binding = _compute_roofline(planner, n, ms, sol_ms, bw,
                                                device)
        pct = 100 * sol_ms / ms
    roofline = (f", {pct:.1f}% of {binding} roofline"
                if pct is not None else "")
    gnnz = nnz / sec_per_iter / 1e9
    print(f"Achieved {ms:.6f} ms per iteration ({gnnz:.2f} Gnnz/s{roofline})")
    result = {
        "dim": args.dim,
        "solver": name,
        "n": n,
        "nnz": nnz,
        "pieces": args.vp,
        "dtype": args.dtype,
        "ms_per_iter": ms,
        "gnnz_per_s": gnnz,
        "schedule": schedule,
        "bytes_per_unknown": bytes_per_iter / n,
        "pct_roofline": pct,
        "roofline_binding": binding,
        "final_residual2": float(hist[-1]),
    }
    if os.environ.get("LEGIONSOLVERS_BENCH_JSON"):
        print("BENCH_JSON " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()
