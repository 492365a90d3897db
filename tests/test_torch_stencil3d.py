"""The port's 3-D stencil passes (K6a, K6b) against the JAX Pallas kernels.

Each plain PyTorch version in ``legionsolvers_tpu_torch/ops/cuda/
stencil3d.py`` (what the wrappers run on CPU tensors) is held against its
JAX counterpart in ``legionsolvers_tpu/ops/pallas/stencil3d.py``, run in
interpret mode as ``tests/test_15_stencil3d.py`` runs it, on the same numpy
inputs with random nonzero halo planes, for the 7- and 27-point stencils.
Shapes the port's gate takes and JAX's refuses (Z not a multiple of 128)
are held against a float64 product with the port's COO stencil matrix.

Tolerances: arrays atol 1e-5 * max|ref| (f32 rounding of one stencil
application); dots rtol 1e-5 of their Cauchy-Schwarz scale sqrt(<a,a><b,b>)
(f32 sums in another order; for <r', r'> the scale is the dot itself).
The CUDA kernels are held against these plain versions on the card by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import legionsolvers_tpu_torch as T
from legionsolvers_tpu.ops.pallas import stencil3d as J3
from legionsolvers_tpu_torch.ops.cuda import stencil2d as T2
from legionsolvers_tpu_torch.ops.cuda import stencil3d as T3

torch.set_num_threads(2)

DEV = "cpu"
SHAPES = [(8, 8, 128), (4, 16, 128)]
DIMS = [3, 4]
MODES = ["y", "y_dot", "pq", "update", "xpay_pq"]
ARRAYS = {"y", "x", "r", "p"}


def stencil_kw(dim):
    st = T.laplacian_stencil(dim)
    return dict(offsets=tuple(o for o, _ in st),
                values=tuple(v for _, v in st))


def make_inputs(shape, seed, halos=True):
    rng = np.random.default_rng(seed)
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p")}
    for k in ("top", "bot"):
        d[k] = (rng.standard_normal(shape[1:]).astype(np.float32) if halos
                else np.zeros(shape[1:], np.float32))
    d["alpha"] = np.float32(rng.uniform(0.1, 0.5))
    d["beta"] = np.float32(rng.uniform(0.1, 0.5))
    return d


def run_port(mode, d, kw, device=DEV):
    """One pass through the port's wrapper; the update mode's x and r are
    fresh copies."""
    t = {k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()}
    h = (t["top"], t["bot"])
    if mode == "y":
        return {"y": T3.grid3d_stencil_matvec(t["x"], *h, **kw)}
    if mode == "y_dot":
        y, dot = T3.grid3d_stencil_matvec(t["x"], *h, with_dot=True, **kw)
        return {"y": y, "dot": dot}
    if mode == "pq":
        return {"dot": T3.grid3d_cg_pq(t["p"], *h, **kw)}
    if mode == "update":
        x, r, rr = T3.grid3d_cg_update(t["p"], t["x"], t["r"], t["alpha"],
                                       *h, **kw)
        return {"x": x, "r": r, "dot": rr}
    p, pq = T3.grid3d_cg_xpay_pq(t["r"], t["p"], t["beta"], *h, **kw)
    return {"p": p, "dot": pq}


def run_jax(mode, d, kw):
    a = {k: jnp.asarray(v) for k, v in d.items()}
    h = (a["top"], a["bot"])
    kw = dict(kw, interpret=True)
    if mode == "y":
        return {"y": J3.grid3d_stencil_matvec(a["x"], *h, **kw)}
    if mode == "y_dot":
        y, dot = J3.grid3d_stencil_matvec(a["x"], *h, with_dot=True, **kw)
        return {"y": y, "dot": dot}
    if mode == "pq":
        return {"dot": J3.grid3d_cg_pq(a["p"], *h, **kw)}
    if mode == "update":
        x, r, rr = J3.grid3d_cg_update(a["p"], a["x"], a["r"], a["alpha"],
                                       *h, **kw)
        return {"x": x, "r": r, "dot": rr}
    p, pq = J3.grid3d_cg_xpay_pq(a["r"], a["p"], a["beta"], *h, **kw)
    return {"p": p, "dot": pq}


def dot_scale(mode, d, got, kw):
    """sqrt(<a,a><b,b>) of the dot the pass returns, in float64."""
    A = lambda v: T3.apply_planes_plain(
        torch.as_tensor(v, dtype=torch.float64), kw["offsets"], kw["values"],
        torch.as_tensor(d["top"], dtype=torch.float64),
        torch.as_tensor(d["bot"], dtype=torch.float64)).numpy()
    nrm = lambda v: float(np.linalg.norm(np.asarray(v, np.float64)))
    if mode == "y":
        return 0.0  # no dot
    if mode == "y_dot":
        return nrm(d["x"]) * nrm(got["y"])
    if mode == "pq":
        return nrm(d["p"]) * nrm(A(d["p"]))
    if mode == "update":
        return nrm(got["r"]) ** 2
    return nrm(got["p"]) * nrm(A(np.asarray(got["p"], np.float64)))


def compare(got, ref, scale, rtol=1e-5):
    for key, want in ref.items():
        have = np.asarray(got[key], np.float64)
        want = np.asarray(want, np.float64)
        if key in ARRAYS:
            np.testing.assert_allclose(have, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=key)
        else:
            assert abs(have - want) <= rtol * scale, (key, have, want)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_matches_jax(mode, shape, dim):
    kw = stencil_kw(dim)
    d = make_inputs(shape, seed=10 * MODES.index(mode) + dim)
    got = {k: v.numpy() for k, v in run_port(mode, d, kw).items()}
    compare(got, run_jax(mode, d, kw), dot_scale(mode, d, got, kw))


def coo_oracle(mode, d, shape, dim):
    """Each pass in float64 with the port's COO stencil matrix (zero
    halos)."""
    A = T.create_coo_stencil_matrix(shape, T.laplacian_stencil(dim)).to_dense()
    mv = lambda v: (A @ v.reshape(-1)).reshape(shape)
    x, r, p = (d[k].astype(np.float64) for k in ("x", "r", "p"))
    a, b = float(d["alpha"]), float(d["beta"])
    if mode == "y":
        return {"y": mv(x)}
    if mode == "y_dot":
        return {"y": mv(x), "dot": (x * mv(x)).sum()}
    if mode == "pq":
        return {"dot": (p * mv(p)).sum()}
    if mode == "update":
        rn = r - a * mv(p)
        return {"x": x + a * p, "r": rn, "dot": (rn * rn).sum()}
    pn = r + b * p
    return {"p": pn, "dot": (pn * mv(pn)).sum()}


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("mode", MODES)
def test_ragged_plain_matches_coo(mode, dim):
    """(5, 7, 9): sides that are not multiples of the kernels' 32-wide tile
    or 16-plane chunk, and a Z the TPU gate refuses."""
    shape = (5, 7, 9)
    kw = stencil_kw(dim)
    d = make_inputs(shape, seed=3, halos=False)
    got = {k: v.numpy() for k, v in run_port(mode, d, kw).items()}
    compare(got, coo_oracle(mode, d, shape, dim), dot_scale(mode, d, got, kw))


@pytest.mark.parametrize("dim", DIMS)
def test_halo_planes_are_the_neighbour_planes(dim):
    """y with halo planes == the middle planes of y over the volume
    extended by those planes (COO product on (X + 2, Y, Z))."""
    shape = (4, 6, 10)
    kw = stencil_kw(dim)
    d = make_inputs(shape, seed=5)
    ext = np.concatenate([d["top"][None], d["x"], d["bot"][None]])
    A = T.create_coo_stencil_matrix(ext.shape, T.laplacian_stencil(dim))
    want = (A.to_dense() @ ext.reshape(-1).astype(np.float64)).reshape(
        ext.shape)[1:-1]
    got = run_port("y", d, kw)["y"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("X,Y,Z,offs,want", [
    (256, 256, 256, tuple(o for o, _ in T.laplacian_stencil(4)), True),
    (37, 45, 130, tuple(o for o, _ in T.laplacian_stencil(3)), True),
    (5, 7, 9, ((0, 0, 0), (0, 8, -8), (1, 0, 0)), True),   # JAX: Z % 128
    (5, 7, 9, ((0, 0, 0), (2, 0, 0)), False),              # |ox| > 1
    (5, 7, 9, ((0, 0, 0), (0, 9, 0)), False),
    (5, 7, 9, ((0, 0, 0), (0, 0, -9)), False),
    (5, 7, 9, tuple((0, 0, k - 16) for k in range(33)), False),
    (0, 7, 9, ((0, 0, 0),), False),
])
def test_gates(X, Y, Z, offs, want):
    assert T3.supports3d(X, Y, Z, offs) is want
    assert T3.supports3d_xpay_pq(X, Y, Z, offs) is want


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "alias",
                                 "halo", "gate", "xpay_out"])
def test_wrappers_refuse(bad):
    kw = stencil_kw(3)
    x, r, p = (torch.zeros(4, 8, 16) for _ in range(3))
    call = {
        "dtype": lambda: T3.grid3d_cg_pq(p.double(), **kw),
        "shape": lambda: T3.grid3d_cg_update(p, x[:2], r, 0.5, **kw),
        "contiguity": lambda: T3.grid3d_stencil_matvec(
            x.transpose(0, 2), **kw),
        "alias": lambda: T3.grid3d_cg_update(p, x, x, 0.5, **kw),
        "halo": lambda: T3.grid3d_stencil_matvec(x, torch.zeros(8, 15),
                                                 **kw),
        "gate": lambda: T3.grid3d_stencil_matvec(
            x, offsets=((0, 0, 0), (2, 0, 0)), values=(1.0, 1.0)),
        "xpay_out": lambda: T3.grid3d_cg_xpay_pq(r, p, 0.5, out=p, **kw),
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        call()


@pytest.mark.parametrize("shape,want", [
    ((256, 256, 256), (32, 32, 256)),  # 2 x 16 tiles, 8 chunks of 32
    ((37, 45, 130), (6, 8, 30)),       # 2 x 3 tiles, 5 chunks of 8
    ((1, 1, 1), (1, 1, 1)),
])
def test_march1_geometry(shape, want, monkeypatch):
    """(tiles, planes per chunk, blocks) of the reach-1 register march, from
    the shape alone: no property of a card is read."""
    def refuse(*args, **kwargs):
        raise AssertionError("march1's geometry read a device property")

    for name in ("get_device_properties", "device_count",
                 "get_device_name", "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert T3.march1_geometry(*shape) == want


@pytest.mark.parametrize("shape,want", [
    ((256, 256, 256), 1024),  # march3d's 8 x 8 tiles x 16 chunks
    ((37, 45, 130), 30),
    ((1, 1, 1), 1),
])
def test_march_scratch_size(shape, want):
    """The partials scratch holds the larger launch of the two marches."""
    assert T3.march_scratch_size(*shape) == want
    assert want >= T3.march1_geometry(*shape)[2]
    assert want >= T3.blocks3d(*shape)


def test_march1_chunks_cover_the_volume():
    """Over many shapes: the chunks cover [0, X) with no empty chunk, are
    no more than chunks of M1_MIN_CHUNK planes would need, and the launch
    aims at M1_TARGET_BLOCKS (more only where the tiles alone are more)."""
    rng = np.random.default_rng(0)
    shapes = [tuple(int(v) for v in rng.integers(1, 700, 3))
              for _ in range(300)] + [(1, 1, 5000), (5000, 1, 1), (8, 8, 8)]
    for X, Y, Z in shapes:
        tiles, chunk, blocks = T3.march1_geometry(X, Y, Z)
        assert tiles == -(-Y // T3.M1_TY) * -(-Z // T3.M1_TZ)
        n = blocks // tiles
        assert blocks == tiles * n and (n - 1) * chunk < X <= n * chunk
        assert n <= -(-X // T3.M1_MIN_CHUNK)
        assert blocks <= max(T3.M1_TARGET_BLOCKS, tiles)


def test_stencil3_struct_is_cached():
    """The kernels' stencil argument is made once per (offsets, values): a
    repeat call returns the same struct, equal field by field to a fresh
    one; the same offsets with other values get another struct."""
    kw = stencil_kw(4)
    offs, vals = kw["offsets"], kw["values"]
    cached = T3._stencil3_struct(offs, vals)
    assert T3._stencil3_struct(offs, vals) is cached
    assert T3._stencil3_struct([list(o) for o in offs], list(vals)) is cached
    T3._STRUCTS3.clear()
    fresh = T3._stencil3_struct(offs, vals)
    assert fresh is not cached
    for name, _ in T3._Stencil3._fields_:
        a, b = getattr(cached, name), getattr(fresh, name)
        assert (a == b) if name == "n" else list(a) == list(b), name
    assert cached.n == 27 and list(cached.v[:27]) == [np.float32(v)
                                                      for v in vals]
    assert [(cached.ox[k], cached.oy[k], cached.oz[k])
            for k in range(27)] == [tuple(o) for o in offs]
    other = T3._stencil3_struct(offs, tuple(2.0 * v for v in vals))
    assert other is not fresh and list(other.ox) == list(fresh.ox)
    assert list(other.v) != list(fresh.v)


def test_xpay_writes_out_and_keeps_p_old():
    kw = stencil_kw(4)
    d = make_inputs((4, 8, 16), seed=8)
    r, p = torch.from_numpy(d["r"]), torch.from_numpy(d["p"])
    p_in, out = p.clone(), torch.empty_like(p)
    pn, _ = T3.grid3d_cg_xpay_pq(r, p, 0.25, out=out, **kw)
    assert pn is out and torch.equal(p, p_in)


def test_launch_counts_stay_zero_on_cpu():
    T2.reset_launch_counts()
    d = make_inputs((4, 8, 16), seed=1)
    for mode in MODES:
        run_port(mode, d, stencil_kw(3))
    assert sum(T2.LAUNCHES.values()) == 0


@pytest.mark.parametrize("dim", DIMS)
def test_operator_3d_view(dim):
    """StencilOperator plans the 3-D view for a 3-D f32 stencil; matvec
    takes flat and grid layouts; matvec_dot and rmatvec match the COO
    matrix; float64 takes the linearized path."""
    shape = (6, 5, 40)
    stencil = T.laplacian_stencil(dim)
    op = T.StencilOperator(shape, stencil, device=DEV)
    assert op.uses_pallas and op._view["kind"] == "3d"
    assert op._view["Br"] == 6 and not op.step2_eligible
    assert op._exchange_planes3d(torch.zeros(shape)) == (None, None)
    A = T.create_coo_stencil_matrix(shape, stencil).to_dense()
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = A @ x.reshape(-1).astype(np.float64)
    atol = 1e-5 * np.abs(want).max()
    y_grid = op.matvec(torch.from_numpy(x))
    y_flat = op.matvec(torch.from_numpy(x.reshape(-1)))
    assert y_grid.shape == shape and y_flat.shape == (x.size,)
    np.testing.assert_allclose(y_grid.numpy().reshape(-1), want, atol=atol)
    np.testing.assert_allclose(y_flat.numpy(), want, atol=atol)
    y, dot = op.matvec_dot(torch.from_numpy(x))
    exact = float(x.reshape(-1).astype(np.float64) @ want)
    assert abs(float(dot) - exact) <= 1e-5 * np.linalg.norm(x) * np.linalg.norm(want)
    np.testing.assert_allclose(op.rmatvec(torch.from_numpy(x)).numpy()
                               .reshape(-1), A.T @ x.reshape(-1), atol=atol)
    f64 = T.SolverOptions(entry_dtype=torch.float64)
    assert not T.StencilOperator(shape, stencil, options=f64,
                                 device=DEV).uses_pallas


def test_stencil_grid_ndim_matches_jax():
    import legionsolvers_tpu as J

    for dim in (1, 2, 3, 4):
        assert T.stencil_grid_ndim(dim) == J.stencil_grid_ndim(dim)
