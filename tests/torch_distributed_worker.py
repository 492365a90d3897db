"""Worker of ``tests/test_torch_multiprocess.py`` (run via subprocess).

The port's twin of ``tests/distributed_worker.py``: one of two OS
processes, joined by ``initialize_distributed`` into one gloo group, each
holding 2 CPU shards of a 4-shard mesh (``make_mesh(4, devices=["cpu"] *
2)``).  It runs one case and writes what it got to ``<out>.<rank>.npz``;
the test compares both ranks' files with each other and with the same
systems on one process.  Imports torch, numpy and the port only.

Usage: python torch_distributed_worker.py <rank> <nproc> <port> <case> <out>
Prints "WORKER_OK <case> <rank>/<nproc>" at the end.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import legionsolvers_tpu_torch as T  # noqa: E402
from legionsolvers_tpu_torch.entry import build_stencil_system  # noqa: E402
from legionsolvers_tpu_torch.parallel import mesh as M  # noqa: E402

DEV = "cpu"
LOCAL = 2  # shards per process
F32 = T.SolverOptions(entry_dtype=torch.float32)
F64 = T.SolverOptions(entry_dtype=torch.float64)
F32C = T.SolverOptions(entry_dtype=torch.float32, compensated_dots=True)
SHAPE = (64, 128)  # test_torch_sharded.py's 4-piece shape
ITERS = 8
GOLDEN_N = 100
RESTART, GMRES_CYCLES = 4, 2
SHAPE3 = (8, 8, 128)  # test_torch_sharded_3d.py's: 2 x-planes per piece
WIDE3 = (2, 16, 128)  # 3-D pieces of half an x-plane: the band past a block
# the 1-D view [64, 4096]: pieces of 16 rows, the least the fused BiCGStab
# runner takes on pieces
SHAPE1 = (1 << 18,)
SCRAMBLED_NX = 64  # the scrambled 64^2 Laplacian: n = 4096 >= 1024, RCM on


def stencil_cg(mesh, options, iters=ITERS):
    """(history, x) of the 2-D 5-point Laplacian's CGSolver.solve on
    ``mesh``, b = 1, x0 = 0, through ``entry.build_stencil_system``."""
    planner = build_stencil_system(2, SHAPE, options, mesh=mesh)
    hist = T.CGSolver(planner).solve(iters)
    return hist.numpy(), planner.sol_vectors[0].to_numpy()


def solver_run(mesh, options, solver, iters=ITERS, num_spaces=1,
               dim=2, shape=SHAPE, **kw):
    """(history, x of every space) of ``solver`` (a name of the package:
    BiCGStabSolver, GMRESSolver, PCGSolver or CGSolver) on the ``-dim``
    ``dim`` Laplacian (default the 2-D 5-point) at ``shape``, b = 1 (space
    i: 1 + i), x0 = 0; PCG with the Jacobi preconditioner, GMRES(RESTART)
    over ``iters`` cycles (``kw`` to its solve)."""
    planner = build_stencil_system(dim, shape, options, mesh=mesh,
                                   num_spaces=num_spaces)
    for i in range(1, num_spaces):
        planner.rhs_vectors[i].constant_fill(1.0 + i)
    if solver == "PCGSolver":
        s = T.PCGSolver(planner, T.JacobiPreconditioner(planner))
    elif solver == "GMRESSolver":
        s = T.GMRESSolver(planner, RESTART)
    else:
        s = getattr(T, solver)(planner)
    hist = s.solve(iters, **kw).numpy()
    return hist, np.stack([v.to_numpy() for v in planner.sol_vectors])


def with_env(env, fn):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def case_golden(mesh, out):
    """JAX's test_19: the f64 n = 100 1-D Laplacian through the planner,
    which upgrades it to a DiaOperator."""
    part = T.BlockPartition(GOLDEN_N, mesh.size)
    planner = T.SquarePlanner(mesh=mesh, options=F64)
    planner.add_sol_vector(T.PartitionedVector(
        "s", part, mesh=mesh, options=F64).zero_fill())
    planner.add_rhs_vector(T.PartitionedVector(
        "b", part, mesh=mesh, options=F64).constant_fill(1.0))
    planner.add_row_partitioned_matrix(
        T.coo_negative_laplacian_1d(GOLDEN_N, options=F64), 0, 0)
    op = planner.row_partitioned_matrices[0][0]
    out["operator"] = np.array(type(op).__name__)
    out["hist"] = T.CGSolver(planner).solve(10).numpy()
    out["x"] = planner.sol_vectors[0].to_numpy()


def case_cg2d(mesh, out):
    """The 2-D CG of the main path: f32 s-step and two-pass, and f64 (the
    linearized path)."""
    out["sstep_hist"], out["sstep_x"] = stencil_cg(mesh, F32)
    op = build_stencil_system(2, SHAPE, F32, mesh=mesh) \
        .row_partitioned_matrices[0][0]
    out["sstep_eligible"] = np.array(op.step2_eligible)
    out["twopass_hist"], out["twopass_x"] = with_env(
        {"LEGIONSOLVERS_NO_SSTEP": "1"}, lambda: stencil_cg(mesh, F32))
    out["f64_hist"], out["f64_x"] = stencil_cg(mesh, F64)
    # the eager matvec with its fused dot, on a seeded x
    x = np.random.default_rng(7).standard_normal(SHAPE).astype(np.float32)
    v = T.PartitionedVector.from_array("x", x.reshape(-1),
                                       T.BlockPartition(x.size, mesh.size),
                                       mesh=mesh, options=F32,
                                       grid_shape=SHAPE)
    y, dot = op.matvec_dot(v.data)
    out["matvec"] = M.gather_vector(mesh, y).numpy()
    out["matvec_dot"] = dot.numpy()


def explicit_planner(mesh, options):
    A = T.create_coo_stencil_matrix(SHAPE, T.laplacian_stencil(2),
                                     options=options)
    return T.build_explicit_system(A, options, mesh=mesh)


def case_ell(mesh, out):
    """The sharded ELL (no DIA, no basis upgrade), windowed (K9's plain
    version) and gathered: one matvec, one rmatvec, a CG history."""
    env = {"LEGIONSOLVERS_NO_DIA": "1", "LEGIONSOLVERS_NO_RCM": "1"}
    n = SHAPE[0] * SHAPE[1]
    x = np.random.default_rng(8).standard_normal(n).astype(np.float32)
    for tag, extra in (("win", {}), ("gather",
                                     {"LEGIONSOLVERS_NO_WINELL": "1"})):
        planner = with_env({**env, **extra},
                           lambda: explicit_planner(mesh, F32))
        op = planner.row_partitioned_matrices[0][0]
        out[f"{tag}_operator"] = np.array(type(op).__name__)
        out[f"{tag}_windowed"] = np.array(op._win is not None)
        v = T.PartitionedVector.from_array(
            "x", x, T.BlockPartition(n, mesh.size), mesh=mesh, options=F32)
        out[f"{tag}_matvec"] = M.gather_vector(mesh, op.matvec(v.data)) \
            .numpy()
        out[f"{tag}_rmatvec"] = M.gather_vector(mesh, op.rmatvec(v.data)) \
            .numpy()
        out[f"{tag}_hist"] = T.CGSolver(planner).solve(ITERS).numpy()
        out[f"{tag}_x"] = planner.sol_vectors[0].to_numpy()


def case_vectors(mesh, out):
    """Fills, to_numpy, random_fill and dot: n = 30 in 4 pieces of 8 (the
    last piece padded), flat, and (8, 16) in grid layout."""
    part = T.BlockPartition(30, mesh.size)
    v = T.PartitionedVector("v", part, mesh=mesh, options=F64)
    out["local_len"] = np.array(v.data.numel())
    out["constant"] = v.constant_fill(2.5).to_numpy()
    out["constant_padding"] = v.data.numpy()
    out["refill"] = v.refill_constant(-1.0).to_numpy()
    out["refill_padding"] = v.data.numpy()
    out["zero"] = v.zero_fill().to_numpy()
    gen = torch.Generator(DEV).manual_seed(11)
    out["random"] = v.random_fill(gen, -1.0, 1.0).to_numpy()
    ints = np.random.default_rng(9).integers(-8, 9, size=(2, 30))
    a = T.PartitionedVector.from_array("a", ints[0].astype(np.float64), part,
                                       mesh=mesh, options=F64)
    b = T.PartitionedVector.from_array("b", ints[1].astype(np.float64), part,
                                       mesh=mesh, options=F64)
    out["from_array"] = a.to_numpy()
    out["dot_exact"] = a.dot(b).value.numpy()
    out["norm2_random"] = v.norm2().value.numpy()
    planner = T.SquarePlanner(mesh=mesh, options=F64)
    planner.add_sol_vector(a)
    planner.add_rhs_vector(b)
    out["planner_dot"] = planner.dot(0, 1).value.numpy()
    gpart = T.BlockPartition(128, mesh.size)
    g = T.PartitionedVector("g", gpart, mesh=mesh, options=F32,
                            grid_shape=(8, 16))
    out["grid_local_shape"] = np.array(g.data.shape)
    out["grid_random"] = g.random_fill(
        torch.Generator(DEV).manual_seed(12)).to_numpy()


def case_bicgstab2d(mesh, out):
    """BiCGStab on the 2-D 5-point system: the fused runner in f32 (the
    three K5 passes per piece, 16-row pieces) with f32 and compensated
    dots; step() in f32 (LEGIONSOLVERS_NO_FUSED_BICGSTAB=1) and in f64,
    which has no kernel view and so no fused runner."""
    op = build_stencil_system(2, SHAPE, F32, mesh=mesh) \
        .row_partitioned_matrices[0][0]
    out["fused_supported"] = np.array(op.supports_fused_bicgstab)
    out["fused_hist"], out["fused_x"] = solver_run(mesh, F32,
                                                   "BiCGStabSolver")
    out["compensated_hist"], out["compensated_x"] = solver_run(
        mesh, F32C, "BiCGStabSolver")
    out["steps_hist"], out["steps_x"] = with_env(
        {"LEGIONSOLVERS_NO_FUSED_BICGSTAB": "1"},
        lambda: solver_run(mesh, F32, "BiCGStabSolver"))
    out["f64_hist"], out["f64_x"] = solver_run(mesh, F64, "BiCGStabSolver")


def case_gmres(mesh, out):
    """GMRES(RESTART) over GMRES_CYCLES cycles, the batched-basis CGS2
    runner and the MGS step(), in f32 (the K3 matvec) and f64."""
    for tag, options in (("f32", F32), ("f64", F64)):
        for path, fused in (("fused", True), ("eager", False)):
            out[f"{tag}_{path}_hist"], out[f"{tag}_{path}_x"] = solver_run(
                mesh, options, "GMRESSolver", GMRES_CYCLES, fused=fused)


def case_pcg(mesh, out):
    """PCG(Jacobi): on the stencil in f32 and f64, and on the explicit
    Laplacian, which the planner upgrades to a DiaOperator, in f32."""
    for tag, options in (("f32", F32), ("f64", F64)):
        out[f"{tag}_hist"], out[f"{tag}_x"] = solver_run(mesh, options,
                                                         "PCGSolver")
    planner = explicit_planner(mesh, F32)
    out["dia_operator"] = np.array(
        type(planner.row_partitioned_matrices[0][0]).__name__)
    M = T.JacobiPreconditioner(planner)
    out["dia_local_diag"] = M.inv_diags[0].numpy()
    out["dia_hist"] = T.PCGSolver(planner, M).solve(ITERS).numpy()
    out["dia_x"] = planner.sol_vectors[0].to_numpy()


def case_block(mesh, out):
    """Block systems of 2 spaces (b = 1 and 2): CG on the s-step phases
    and on the two-pass ones (LEGIONSOLVERS_NO_SSTEP=1), BiCGStab on the
    three-pass phases, in f32; CG and BiCGStab on the torch phases in
    f64."""
    for tag, options, solver, env in (
            ("cg_sstep", F32, "CGSolver", {}),
            ("cg_twopass", F32, "CGSolver", {"LEGIONSOLVERS_NO_SSTEP": "1"}),
            ("bicgstab", F32, "BiCGStabSolver", {}),
            ("f64_cg", F64, "CGSolver", {}),
            ("f64_bicgstab", F64, "BiCGStabSolver", {})):
        out[f"{tag}_hist"], out[f"{tag}_x"] = with_env(
            env, lambda: solver_run(mesh, options, solver, num_spaces=2))


def case_dryrun(mesh, out):
    """``entry.dryrun_multichip(4)`` on the CPU (the mesh it makes itself:
    here 2 shards on each of the 2 processes), its histories by section;
    and on 2 processes a shard count they cannot split evenly."""
    from legionsolvers_tpu_torch.entry import dryrun_multichip

    for key, h in dryrun_multichip(mesh.size, device=DEV).items():
        out[f"dryrun {key}"] = h
    if mesh.spans_processes:
        try:
            dryrun_multichip(3, device=DEV)
            got = "no error"
        except ValueError as e:
            got = f"ValueError: {e}"
        out["uneven"] = np.array(got)


def matvec_out(mesh, op, shape, seed, out, key):
    """One matvec and one fused matvec-dot of ``op`` on a seeded f32 x in
    the operator's grid layout: the whole y and the dot."""
    n = int(np.prod(shape))
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    gs = None
    if op.uses_pallas:
        v = op._view
        gs = shape if len(shape) == 3 else (n // v["C"], v["C"])
    xv = T.PartitionedVector.from_array(
        "x", x, T.BlockPartition(n, mesh.size), mesh=mesh,
        options=op.options, grid_shape=gs)
    out[key] = M.gather_vector(mesh, op.matvec(xv.data).reshape(-1)).numpy()
    y, dot = op.matvec_dot(xv.data)
    out[f"{key}_dot"] = dot.numpy()
    out[f"{key}_y"] = M.gather_vector(mesh, y.reshape(-1)).numpy()


def case_grids3d(mesh, out):
    """3-D pieces at SHAPE3: the 7- and 27-point f32 CG on the two-pass
    kernel schedule (K6b + K6a per piece on the neighbours' halo planes),
    one matvec and its fused dot each; on the 7-point: f64 CG (the
    linearized path), BiCGStab step() in f32 and f64 (no fused runner on
    3-D pieces), GMRES's runner, PCG(Jacobi) and block CG and BiCGStab of
    2 spaces; f64 CG on WIDE3, whose band gathers from the whole
    vector."""
    for dim in (3, 4):
        op = build_stencil_system(dim, SHAPE3, F32, mesh=mesh) \
            .row_partitioned_matrices[0][0]
        out[f"view{dim}"] = np.array(str(op._view and op._view["kind"]))
        out[f"fused_bicg{dim}"] = np.array(op.supports_fused_bicgstab)
        out[f"cg{dim}_hist"], out[f"cg{dim}_x"] = solver_run(
            mesh, F32, "CGSolver", dim=dim, shape=SHAPE3)
        matvec_out(mesh, op, SHAPE3, 20 + dim, out, f"mv{dim}")
    run = lambda tag, options, solver, **kw: out.update(zip(
        (f"{tag}_hist", f"{tag}_x"),
        solver_run(mesh, options, solver, dim=3, shape=SHAPE3, **kw)))
    run("f64", F64, "CGSolver")
    run("bicg", F32, "BiCGStabSolver")
    run("bicg_f64", F64, "BiCGStabSolver")
    run("gmres", F32, "GMRESSolver", iters=GMRES_CYCLES)
    run("pcg", F32, "PCGSolver")
    run("block_cg", F32, "CGSolver", num_spaces=2)
    run("block_bicg", F32, "BiCGStabSolver", num_spaces=2)
    op = build_stencil_system(3, WIDE3, F64, mesh=mesh) \
        .row_partitioned_matrices[0][0]
    out["wide_band"] = np.array(op._wide_band)
    out["wide_hist"], out["wide_x"] = solver_run(mesh, F64, "CGSolver",
                                                 dim=3, shape=WIDE3)


def case_flat1d(mesh, out):
    """The 1-D view at SHAPE1 ([64, 4096], 16-row pieces): the f32 CG
    (two-pass: the s-step does not take the 1-D view on pieces), the fused
    BiCGStab with f32 and compensated dots, one matvec and its fused dot,
    GMRES's runner (and in f64), PCG(Jacobi), block CG and BiCGStab of 2
    spaces, and f64 CG (the linearized path)."""
    op = build_stencil_system(1, SHAPE1, F32, mesh=mesh) \
        .row_partitioned_matrices[0][0]
    v = op._view
    out["view"] = np.array([v["flat"], v["Br"], v["C"]])
    out["sstep_eligible"] = np.array(op.step2_eligible)
    out["fused_bicg"] = np.array(op.supports_fused_bicgstab)
    matvec_out(mesh, op, SHAPE1, 25, out, "mv")
    run = lambda tag, options, solver, **kw: out.update(zip(
        (f"{tag}_hist", f"{tag}_x"),
        solver_run(mesh, options, solver, dim=1, shape=SHAPE1, **kw)))
    run("cg", F32, "CGSolver")
    run("bicg", F32, "BiCGStabSolver")
    run("bicg_comp", F32C, "BiCGStabSolver")
    run("gmres", F32, "GMRESSolver", iters=GMRES_CYCLES)
    run("gmres_f64", F64, "GMRESSolver", iters=GMRES_CYCLES)
    run("pcg", F32, "PCGSolver")
    run("block_cg", F32, "CGSolver", num_spaces=2)
    run("block_bicg", F32, "BiCGStabSolver", num_spaces=2)
    run("f64", F64, "CGSolver")


def scrambled_laplacian(options):
    """The 5-point Laplacian on SCRAMBLED_NX^2 with rows and columns
    scrambled by ``default_rng(0).permutation`` (the system of
    chip_smoke.py's phase 4f at another size)."""
    a = T.create_coo_stencil_matrix((SCRAMBLED_NX, SCRAMBLED_NX),
                                    T.laplacian_stencil(2))
    n = a.n_range
    pr = np.random.default_rng(0).permutation(n)
    return T.COOMatrix(pr[a.rows], pr[a.cols], a.vals, n, n, options=options)


def chain(op):
    names = [type(op).__name__]
    while hasattr(op, "base"):
        op = op.base
        names.append(type(op).__name__)
    return names


def case_reorder(mesh, out):
    """The scrambled Laplacian through the planner's RCM upgrade (f32 and
    f64): the operator chain, the permutation, one matvec in the natural
    order and a CG solve; a block system of 2 spaces whose second space
    adopts the first's basis (``adopt_basis``), coupled by eps I between
    the spaces (``CrossBasisOperator``); and a permutation that differs
    between the ranks."""
    for tag, options in (("f32", F32), ("f64", F64)):
        A = scrambled_laplacian(options)
        planner = T.build_explicit_system(A, options, mesh=mesh)
        op = planner.row_partitioned_matrices[0][0]
        out[f"{tag}_chain"] = np.array(chain(op))
        out[f"{tag}_windowed"] = np.array(op.base._win is not None)
        out[f"{tag}_perm"] = planner.basis_perms[0]["perm_np"]
        out[f"{tag}_perm_local"] = op.perm_dev.numpy()
        n = A.n_range
        x = np.random.default_rng(26).standard_normal(n)
        xv = T.PartitionedVector.from_array(
            "x", x, T.BlockPartition(n, mesh.size), mesh=mesh,
            options=options)
        out[f"{tag}_matvec"] = M.gather_vector(mesh, op.matvec(xv.data)) \
            .numpy()
        out[f"{tag}_hist"] = T.CGSolver(planner).solve(ITERS).numpy()
        out[f"{tag}_x"] = planner.sol_vectors[0].to_numpy()
    A = scrambled_laplacian(F32)
    n = A.n_range
    part = T.BlockPartition(n, mesh.size)
    planner = T.SquarePlanner(mesh=mesh, options=F32)
    for i in range(2):
        planner.add_sol_vector(T.PartitionedVector(f"s{i}", part, mesh=mesh,
                                                   options=F32))
    for i in range(2):
        planner.add_rhs_vector(T.PartitionedVector(
            f"b{i}", part, mesh=mesh, options=F32).constant_fill(1.0 + i))
    planner.add_row_partitioned_matrix(A, 0, 0)
    planner.adopt_basis(1, planner.basis_perms[0]["perm_np"])
    planner.add_row_partitioned_matrix(A, 1, 1)
    eye = np.arange(n)
    eps = T.COOMatrix(eye, eye, np.full(n, 0.125, np.float32), n, n,
                      options=F32)
    planner.add_row_partitioned_matrix(eps, 0, 1)
    planner.add_row_partitioned_matrix(eps, 1, 0)
    out["block_chains"] = np.array([
        "/".join(chain(op)) for op, _, _ in planner.row_partitioned_matrices])
    out["block_same_basis"] = np.array(np.array_equal(
        planner.basis_perms[0]["perm_np"], planner.basis_perms[1]["perm_np"]))
    out["block_hist"] = T.CGSolver(planner).solve(ITERS).numpy()
    out["block_x"] = np.stack([v.to_numpy() for v in planner.sol_vectors])
    if mesh.spans_processes:
        try:
            M.check_same_on_ranks(mesh, np.array([mesh.rank]), "a rank")
            got = "no error"
        except RuntimeError as e:
            got = f"RuntimeError: {e}"
        out["differing perm"] = np.array(got)


def case_convert3d(mesh, out):
    """A JAX 3-D CG state (``WORKER_INPUT``: the npz the test wrote from
    JAX's 4-device mesh: its ``dump_state()`` vectors as ``<key>/<space>``,
    its residual² history ``rr`` and ``dim``) continued by
    ``convert.stencil_cg_system`` on this mesh for ITERS iterations."""
    from legionsolvers_tpu_torch.utils import convert

    state = {}
    with np.load(os.environ["WORKER_INPUT"]) as f:
        for k in sorted(f.files):
            if "/" in k:
                key, i = k.split("/")
                state.setdefault(key, {})[int(i)] = f[k]
        rr, dim = f["rr"], int(f["dim"])
    state = {k: tuple(v[i] for i in sorted(v)) for k, v in state.items()}
    planner, solver = convert.stencil_cg_system(
        SHAPE3, T.laplacian_stencil(dim), state, rr[-1:], options=F32,
        mesh=mesh)
    out["hist"] = solver.solve(ITERS).numpy()
    out["x"] = planner.sol_vectors[0].to_numpy()


def refused(mesh):
    """name -> a call that must raise NotImplementedError naming item 5g."""

    def f32_planner():
        return build_stencil_system(2, SHAPE, F32, mesh=mesh)

    def checkpoint(save):
        from legionsolvers_tpu_torch.utils import io

        solver = T.CGSolver(f32_planner())
        path = os.path.join(os.environ["WORKER_TMP"], f"ck{mesh.rank}.npz")
        return (io.save_checkpoint if save else io.load_checkpoint)(path,
                                                                    solver)

    return {
        "save_checkpoint": lambda: checkpoint(True),
        "load_checkpoint": lambda: checkpoint(False),
        "distinct local devices": lambda: M.make_mesh(
            mesh.size, devices=[DEV, "meta"]),
    }


def case_refused(mesh, out):
    """Every path a process mesh refuses, and initialize_distributed a
    second time."""
    for name, call in refused(mesh).items():
        try:
            call()
            got = "no error"
        except NotImplementedError as e:
            got = "item 5g" if "item 5g" in str(e) else f"message: {e}"
        except Exception as e:  # noqa: BLE001 - reported to the test
            got = f"{type(e).__name__}: {e}"
        out[f"refused {name}"] = np.array(got)
    before = torch.distributed.get_world_size()
    M.initialize_distributed("127.0.0.1:1", 5, 3)  # ignored: initialized
    out["second init"] = np.array(
        [before, torch.distributed.get_world_size(),
         torch.distributed.get_rank() == mesh.rank])


CASES = {"golden": case_golden, "cg2d": case_cg2d, "ell": case_ell,
         "vectors": case_vectors, "refused": case_refused,
         "bicgstab2d": case_bicgstab2d, "gmres": case_gmres,
         "pcg": case_pcg, "block": case_block, "dryrun": case_dryrun,
         "grids3d": case_grids3d, "flat1d": case_flat1d,
         "reorder": case_reorder, "convert3d": case_convert3d}


def main() -> None:
    rank, nproc, port, case, path = sys.argv[1:6]
    rank, nproc = int(rank), int(nproc)
    torch.set_num_threads(1)
    M.initialize_distributed(f"127.0.0.1:{port}", nproc, rank)
    mesh = M.make_mesh(LOCAL * nproc, devices=[DEV] * LOCAL)
    assert mesh.spans_processes and mesh.rank == rank, mesh
    assert mesh.local_range == (LOCAL * rank, LOCAL * (rank + 1)), mesh
    out = {}
    CASES[case](mesh, out)
    np.savez(f"{path}.{rank}.npz", **out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"WORKER_OK {case} {rank}/{nproc}", flush=True)


if __name__ == "__main__":
    main()
