"""Package-level contracts of the PyTorch port (no GPU needed).

* importing ``legionsolvers_tpu_torch`` imports no jax;
* the CUDA build raises a clear error without nvcc, and a CUDA request
  without a card raises: nothing falls back to the CPU;
* the host layer (scalars, vectors, partitions, options) behaves as the
  JAX package's does (the counterparts of test_01/02/03).
"""

import ast
import dataclasses
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu_torch.entry import build_system
from legionsolvers_tpu_torch.ops.cuda import build
from legionsolvers_tpu_torch.ops.cuda import stencil2d as TK

torch.set_num_threads(2)

OFFS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
DEV = "cpu"


def test_import_does_not_load_jax():
    code = ("import sys, legionsolvers_tpu_torch, "
            "legionsolvers_tpu_torch.entry, "
            "legionsolvers_tpu_torch.utils.convert, "
            "legionsolvers_tpu_torch.ops.cuda.build, "
            "legionsolvers_tpu_torch.ops.cuda.stencil3d, "
            "legionsolvers_tpu_torch.ops.cuda.bicgstab3d, "
            "legionsolvers_tpu_torch.ops.cuda.dia2d, "
            "legionsolvers_tpu_torch.ops.cuda.winell, "
            "legionsolvers_tpu_torch.ops.cuda.rowperm, "
            "legionsolvers_tpu_torch.native.bindings, "
            "legionsolvers_tpu_torch.utils.io, "
            "legionsolvers_tpu_torch.utils.debug, "
            "legionsolvers_tpu_torch.utils.initialize, "
            "legionsolvers_tpu_torch.parallel.dia_op, "
            "legionsolvers_tpu_torch.parallel.winell_op, "
            "legionsolvers_tpu_torch.parallel.genspmv, "
            "legionsolvers_tpu_torch.parallel.reorder, "
            "legionsolvers_tpu_torch.solvers.gmres, "
            "legionsolvers_tpu_torch.solvers.pcg, "
            "legionsolvers_tpu_torch.benchmark, "
            "legionsolvers_tpu_torch.ops.cuda.vpu_probe, "
            "legionsolvers_tpu_torch.ops.cuda.copy_probe, "
            "legionsolvers_tpu_torch.utils.timing, "
            "legionsolvers_tpu_torch.utils.roofline, "
            "legionsolvers_tpu_torch.utils.vpu_probe, "
            "legionsolvers_tpu_torch.utils.probe_roofline; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'legionsolvers_tpu.'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


@pytest.fixture
def no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_FALLBACKS", ())
    build.load_library.cache_clear()
    yield
    build.load_library.cache_clear()


def test_build_raises_without_nvcc(no_nvcc):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load_library()


def test_library_name_follows_sources():
    path = build.library_path()
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("liblegionsolvers_cuda_")
    assert path == build.library_path()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("what", ["device", "vector", "operator", "planner",
                                  "system"])
def test_cuda_request_without_card_raises(what, no_card):
    part = T.BlockPartition(64, 1)
    make = {
        "device": lambda: T.resolve_device("cuda"),
        "vector": lambda: T.PartitionedVector("v", part, device="cuda"),
        "operator": lambda: T.StencilOperator((8, 8), T.laplacian_stencil(2),
                                              device="cuda"),
        "planner": lambda: T.SquarePlanner(device="cuda"),
        "system": lambda: build_system(8, device="cuda"),
    }[what]
    with pytest.raises(RuntimeError, match="cuda"):
        make()


@pytest.mark.parametrize("what", ["device", "vector", "from_array",
                                  "operator", "planner", "matrix", "system",
                                  "stencil_system", "convert", "dia",
                                  "explicit_system", "convert_explicit"])
def test_default_device_is_the_card(what, no_card):
    """With no device given, every public constructor and entry point asks for
    CUDA, so without a card it raises instead of running on the CPU."""
    from legionsolvers_tpu_torch.entry import build_stencil_system
    from legionsolvers_tpu_torch.utils import convert

    part = T.BlockPartition(64, 1)
    A = T.create_coo_stencil_matrix((8, 8), T.laplacian_stencil(2))
    make = {
        "device": lambda: T.resolve_device(),
        "vector": lambda: T.PartitionedVector("v", part),
        "from_array": lambda: T.PartitionedVector.from_array(
            "v", np.zeros(64), part),
        "operator": lambda: T.StencilOperator((8, 8), T.laplacian_stencil(2)),
        "planner": lambda: T.SquarePlanner(),
        "matrix": lambda: T.RowPartitionedMatrix(A, part, part),
        "system": lambda: build_system(8),
        "stencil_system": lambda: build_stencil_system(3, (4, 4, 4)),
        "convert": lambda: convert.stencil_cg_system(
            (8, 8), T.laplacian_stencil(2), {}, [1.0]),
        "dia": lambda: T.DiaOperator(A, part),
        "explicit_system": lambda: T.build_explicit_system(A),
        "convert_explicit": lambda: convert.explicit_cg_system(
            A.rows, A.cols, A.vals, 64, {}, [1.0]),
    }[what]
    with pytest.raises(RuntimeError, match="cuda"):
        make()


def test_wrapper_rejects_other_devices():
    x = torch.zeros(32, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TK.grid2d_stencil_matvec(x, offsets=OFFS, values=VALS)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "alias",
                                 "gate"])
def test_wrapper_checks_inputs(bad):
    x, r, p = (torch.zeros(32, 128) for _ in range(3))
    kw = dict(offsets=OFFS, values=VALS)
    call = {
        "dtype": lambda: TK.grid2d_cg_gram2(r.double(), p.double(), **kw),
        "shape": lambda: TK.grid2d_cg_step2(x, r, p[:16], torch.ones(6),
                                            **kw),
        "contiguity": lambda: TK.grid2d_cg_pq(p.t(), **kw),
        "alias": lambda: TK.grid2d_cg_update(p, x, x, 0.5, **kw),
        "gate": lambda: TK.grid2d_cg_gram2(r, p, offsets=OFFS + ((2, 0),),
                                           values=VALS + (1.0,)),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        call()


def test_step2_out_must_not_alias_inputs():
    x, r, p = (torch.zeros(32, 128) for _ in range(3))
    with pytest.raises(ValueError, match="shares storage"):
        TK.grid2d_cg_step2(x, r, p, torch.ones(6), offsets=OFFS,
                           values=VALS, out=(r, torch.empty_like(p)))


def test_launch_counts_stay_zero_on_cpu():
    TK.reset_launch_counts()
    x = torch.ones(32, 128)
    TK.grid2d_stencil_matvec(x, offsets=OFFS, values=VALS, with_dot=True)
    assert sum(TK.LAUNCHES.values()) == 0


def test_options(monkeypatch):
    assert T.SolverOptions(compensated_dots=True).compensated_dots
    monkeypatch.setenv("LEGIONSOLVERS_COMPENSATED_DOTS", "1")
    assert T.SolverOptions().compensated_dots
    monkeypatch.delenv("LEGIONSOLVERS_COMPENSATED_DOTS")
    assert not T.SolverOptions().compensated_dots
    with pytest.raises(ValueError):
        T.SolverOptions(entry_dtype=torch.bfloat16)


@pytest.mark.parametrize("what", ["vector", "operator", "planner"])
def test_mesh_not_ported(what):
    """A mesh whose shards span two distinct devices (several cards or
    processes) is not ported: vectors, operators and planners refuse it."""
    from legionsolvers_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh((torch.device("cpu"), torch.device("meta")))
    part = T.BlockPartition(64, 2)
    make = {
        "vector": lambda: T.PartitionedVector("v", part, mesh=mesh),
        "operator": lambda: T.StencilOperator((8, 8), T.laplacian_stencil(2),
                                              mesh=mesh),
        "planner": lambda: T.SquarePlanner(mesh=mesh),
    }[what]
    with pytest.raises(NotImplementedError, match="item 5g"):
        make()


def test_planner_checks_devices():
    part = T.BlockPartition(64, 1)
    planner = T.SquarePlanner(device="cpu")
    with pytest.raises(ValueError, match="lives on meta"):
        planner.add_sol_vector(T.PartitionedVector("v", part, device="meta"))
    planner.add_sol_vector(T.PartitionedVector("s", part, device=DEV))
    planner.add_rhs_vector(T.PartitionedVector("b", part, device=DEV))
    op = T.StencilOperator((8, 8), T.laplacian_stencil(2), device="meta")
    with pytest.raises(ValueError, match="lives on meta"):
        planner.add_operator(op, 0, 0)


# -- scalars (test_01's counterpart) -------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scalar_identity(dtype):
    x = T.Scalar(torch.tensor(0.5, dtype=dtype))
    y = T.Scalar(torch.tensor(1.5, dtype=dtype))
    assert ((x + y) / (x + x) - x).get_value() == 1.5
    assert ((x + y) / (x + x) - (x + x)).get_value() == 1.0
    a, b = T.Scalar(torch.tensor(9.0, dtype=dtype)), T.Scalar(2.0)
    assert (a * b).get_value() == 18.0 and (a - b).get_value() == 7.0
    assert (-a).get_value() == -9.0 and a.sqrt().get_value() == 3.0
    assert (1 + a).get_value() == 10.0 and (1 / b).get_value() == 0.5
    assert T.Scalar(torch.tensor(4.0, dtype=dtype)).rsqrt().get_value() == 0.5


def test_alpha_protocol():
    s = [T.Scalar(v) for v in (6.0, 4.0, 3.0, 2.0)]
    assert float(T.alpha_from_scalars([])) == 1.0
    assert [float(T.alpha_from_scalars(s[:k])) for k in (1, 2, 3, 4)] == [
        6.0, 1.5, 8.0, 4.0]
    with pytest.raises(ValueError):
        T.alpha_from_scalars(s + s)


def test_scalar_history_is_lazy():
    h = T.ScalarHistory(torch.arange(5, dtype=torch.float32))
    assert list.__getitem__(h, 3) is None
    assert h[-1].get_value() == 4.0 and list.__getitem__(h, 1) is None
    assert [s.get_value() for s in h] == [0.0, 1.0, 2.0, 3.0, 4.0]


# -- vectors and partitions (test_02/03's counterparts) --------------------

def test_vector_padding_and_fills():
    part = T.BlockPartition(10, 4)  # padded to 12
    v = T.PartitionedVector.from_array("v", np.arange(10.0), part,
                                       device=DEV)
    assert v.data.shape == (12,) and v.data[10:].eq(0).all()
    assert (v.to_numpy() == np.arange(10.0)).all()
    c = T.PartitionedVector("c", part, device=DEV).constant_fill(3.0)
    assert c.data.tolist() == [3.0] * 10 + [0.0, 0.0]
    g = torch.Generator().manual_seed(4)
    r1 = T.PartitionedVector("r", part, device=DEV).random_fill(
        g, lo=-1.0, hi=1.0)
    r2 = T.PartitionedVector("r", part, device=DEV).random_fill(
        torch.Generator().manual_seed(4), lo=-1.0, hi=1.0)
    assert torch.equal(r1.data, r2.data) and r1.data[10:].eq(0).all()
    assert r1.data[:10].abs().le(1.0).all()


def test_vector_blas1_matches_numpy():
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal(37), rng.standard_normal(37)
    part = T.BlockPartition(37, 4)
    F64 = T.SolverOptions(entry_dtype=torch.float64)
    va = T.PartitionedVector.from_array("a", a, part, options=F64,
                                        device=DEV)
    vb = T.PartitionedVector.from_array("b", b, part, options=F64,
                                        device=DEV)
    np.testing.assert_allclose(va.dot(vb).get_value(), a @ b, rtol=1e-12)
    va.axpy(T.Scalar(torch.tensor(6.0, dtype=torch.float64)),
            T.Scalar(torch.tensor(3.0, dtype=torch.float64)), vb)
    np.testing.assert_allclose(va.to_numpy(), a + 2.0 * b, rtol=1e-12)
    vb.xpay(0.5, va)
    np.testing.assert_allclose(vb.to_numpy(), a + 2.0 * b + 0.5 * b,
                               rtol=1e-12)
    w = va.like("w")
    w.assign(va)
    assert w.data is va.data


@pytest.mark.parametrize("n,pieces", [(100, 4), (10, 3), (7, 8)])
def test_partition_matches_jax(n, pieces):
    pt, pj = T.BlockPartition(n, pieces), J.BlockPartition(n, pieces)
    assert pt.index_map() == pj.index_map()
    assert (pt.padded_size, pt.block_size) == (pj.padded_size, pj.block_size)


def test_matrix_derivations_match_jax():
    At = T.create_coo_stencil_matrix((6, 5), T.laplacian_stencil(2))
    Aj = J.create_coo_stencil_matrix((6, 5), J.laplacian_stencil(2))
    np.testing.assert_array_equal(At.to_dense(), Aj.to_dense())
    part = T.BlockPartition(30, 3)
    for a, b in zip(At.domain_partition_from_range_partition(part),
                    Aj.domain_partition_from_range_partition(
                        J.BlockPartition(30, 3))):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).standard_normal(30)
    np.testing.assert_allclose(At.apply(torch.tensor(x)).numpy(),
                               At.to_dense() @ x, rtol=1e-12)
    np.testing.assert_allclose(At.rmatvec(torch.tensor(x)).numpy(),
                               At.to_dense().T @ x, rtol=1e-12)


def test_csr_to_ell_matches_jax():
    At = T.create_csr_stencil_matrix((5, 7), T.laplacian_stencil(2))
    Aj = J.create_csr_stencil_matrix((5, 7), J.laplacian_stencil(2))
    for a, b in zip(At.to_ell(), Aj.to_ell()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(6, 10), (60,), (4, 6, 10), (1024,)])
def test_stencil_rmatvec_is_the_transpose(shape):
    """A non-symmetric stencil: rmatvec == dense A^T x, on the kernel view
    (2-D and 3-D, f32, and the 1-D view of n = 1024 as [8, 128]) and on
    the linearized path (n = 60, too short for a view, as in JAX)."""
    stencil = [((0,) * len(shape), 3.0), ((1,) + (0,) * (len(shape) - 1),
                                          -2.0), ((0,) * (len(shape) - 1)
                                                  + (-1,), 0.5)]
    op = T.StencilOperator(shape, stencil, device=DEV)
    assert op.uses_pallas == (shape != (60,))
    A = T.create_coo_stencil_matrix(shape, stencil).to_dense()
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    xt = torch.from_numpy(x if len(shape) == 2 else x.reshape(-1))
    np.testing.assert_allclose(op.matvec(xt).numpy().reshape(-1),
                               A @ x.reshape(-1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(op.rmatvec(xt).numpy().reshape(-1),
                               A.T @ x.reshape(-1), rtol=1e-5, atol=1e-5)


# Public names of the JAX package the port does not have yet, each with the
# ROADMAP item that ports it (or why it does not apply to torch).  A name
# ported later must leave this list.
DEFERRED = {
    # JAX's pytree protocol (jax.tree_util registration): no torch use
    "core.vector.PartitionedVector.tree_flatten": "jax only",
    "core.vector.PartitionedVector.tree_unflatten": "jax only",
}
JAX_DIR = pathlib.Path(J.__file__).parent


def _public_names(tree):
    """{name: set of public class-body names or None} of a module's AST:
    functions, classes (with their methods, assignments and annotated
    fields) and module-level assignments."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            members = None
            if isinstance(node, ast.ClassDef):
                members = set()
                for n in node.body:
                    if isinstance(n, ast.FunctionDef):
                        members.add(n.name)
                    elif isinstance(n, ast.Assign):
                        members.update(t.id for t in n.targets
                                       if isinstance(t, ast.Name))
                    elif isinstance(n, ast.AnnAssign) and isinstance(
                            n.target, ast.Name):
                        members.add(n.target.id)
            out[node.name] = members
        elif isinstance(node, ast.Assign):
            out.update((t.id, None) for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = None
    return {k: (None if v is None else {m for m in v
                                        if not m.startswith("_")})
            for k, v in out.items() if not k.startswith("_")}


def _has_member(cls, name):
    """An attribute, or a field declared by annotation (dataclass fields
    and instance attributes a base class announces)."""
    if hasattr(cls, name):
        return True
    if dataclasses.is_dataclass(cls) and name in {
            f.name for f in dataclasses.fields(cls)}:
        return True
    return any(name in getattr(c, "__annotations__", {}) for c in cls.__mro__)


def test_public_names_match_jax():
    """Every public name of every JAX module (read with ast, so no jax is
    imported for it) exists in the port's module of the same path, except
    the stated DEFERRED ones, which must still be missing.  The Pallas
    kernels' modules are the CUDA wrappers' (ops/cuda/) and are held by
    the kernel tests instead."""
    missing = set()
    for f in sorted(JAX_DIR.rglob("*.py")):
        rel = f.relative_to(JAX_DIR).with_suffix("")
        if "pallas" in rel.parts:
            continue
        mod = ".".join(p for p in rel.parts if p != "__init__")
        try:
            m = importlib.import_module(
                "legionsolvers_tpu_torch" + (f".{mod}" if mod else ""))
        except ModuleNotFoundError:
            missing.add(mod)
            continue
        for name, members in _public_names(ast.parse(f.read_text())).items():
            if not hasattr(m, name):
                missing.add(f"{mod}.{name}")
            elif members:
                missing.update(f"{mod}.{name}.{k}" for k in members
                               if not _has_member(getattr(m, name), k))
    assert sorted(missing - set(DEFERRED)) == []
    assert sorted(set(DEFERRED) - missing) == []
