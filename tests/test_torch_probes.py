"""The roofline probes of the port: K11 (op-rate chains) and K12 (copy).

K11's plain version is held against the JAX package's ``_chain_kernel`` in
interpret mode on the probe's [256, 1024] tile: ``roll`` and ``row`` bit
for bit (both round 0.5 v and the sum alike; 0.5 v is exact), ``fma`` to
``fma_rtol`` of the largest output (the JAX kernel may contract the
multiply-add).  K12's plain version is x + 1.0, chained k times exactly.
The op-rate window is the card's data sheet's, and the rate cache lives
under ``build/``, never in the repository's ``VPU_RATES.json``.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from legionsolvers_tpu.utils import vpu_probe as JV
from legionsolvers_tpu_torch.ops.cuda import copy_probe as K12
from legionsolvers_tpu_torch.ops.cuda import vpu_probe as K11
from legionsolvers_tpu_torch.utils import probe_roofline, vpu_probe

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
H100_RATES = {"vpu_fma_ops_per_s": 6.5e13,
              "vpu_roll_plus_add_reps_per_s": 1.5e12,
              "vpu_row_shift_add_reps_per_s": 1.5e12}


def tile(seed=0):
    return np.random.default_rng(seed).standard_normal(
        (K11.TR, K11.C)).astype(np.float32)


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("kind", K11.KINDS)
def test_chain_plain_matches_jax(kind, reps):
    x = tile()
    ours = K11.chain_probe(torch.from_numpy(x), reps, kind).numpy()
    ref = np.asarray(JV._chain_kernel(jnp.asarray(x), reps=reps, kind=kind,
                                      interpret=True))
    if kind == "fma":
        atol = K11.fma_rtol(reps) * np.abs(ref).max()
        np.testing.assert_allclose(ours, ref, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(ours, ref)


def test_chain_plain_is_numpy_roll():
    """One roll and one row step against numpy's roll, exactly."""
    x = tile(1)
    v = torch.from_numpy(x)
    np.testing.assert_array_equal(K11._step(v, 0, "roll").numpy(),
                                  np.float32(0.5) * x + np.roll(x, 1, 1))
    np.testing.assert_array_equal(K11._step(v, 0, "row").numpy(),
                                  np.float32(0.5) * x + np.roll(x, -1, 0))


def test_chain_probe_checks_its_inputs():
    x = torch.zeros(K11.TR, K11.C)
    with pytest.raises(ValueError, match="kind"):
        K11.chain_probe(x, 1, "div")
    with pytest.raises(TypeError):
        K11.chain_probe(x.double(), 1, "fma")
    with pytest.raises(ValueError, match="tile"):
        K11.chain_probe(torch.zeros(8, 128), 1, "roll")
    with pytest.raises(ValueError, match="reps"):
        K11.chain_probe(x, -1, "fma")
    assert K11.chain_probe(torch.zeros(8, 128), 0, "fma").shape == (8, 128)


def test_fma_rtol_grows_with_the_chain():
    assert K11.fma_rtol(2) < 4e-6 < K11.fma_rtol(16) < 4e-5


@pytest.mark.parametrize("shape", [(16384 // 64, 4096 // 64), (200, 328),
                                   (7, 3)])
def test_copy_plain_is_x_plus_one(shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    out = K12.copy_probe(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, x + np.float32(1.0))


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_copy_chain_adds_k(k):
    """k chained launches from small integers give x + k exactly."""
    x = np.random.default_rng(3).integers(-50, 50, (200, 328)).astype(
        np.float32)
    out = probe_roofline.copy_chain(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(out, x + k)


def test_copy_probe_checks_its_inputs():
    x = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="storage"):
        K12.copy_probe(x, out=x)
    with pytest.raises(ValueError, match="shape"):
        K12.copy_probe(x, out=torch.zeros(8, 16))
    with pytest.raises(TypeError):
        K12.copy_probe(x.double())


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 4096, 16384 * 4096 + 3])
@pytest.mark.parametrize("x_off,out_off", [(0, 0), (4, 0), (0, 8), (12, 12)])
def test_copy_split_covers_once(n, x_off, out_off):
    """The body [0, body) and the scalar rest [body, n) cover [0, n) once;
    the body is whole 16-byte vectors, and empty unless both addresses are
    16-byte aligned."""
    body = K12.copy_split(1 << 20 | x_off, 1 << 24 | out_off, n)
    assert 0 <= body <= n and body % 4 == 0
    if n <= 4096:
        covered = np.zeros(n, np.int64)
        for lo, hi in ((0, body), (body, n)):
            covered[lo:hi] += 1
        assert (covered == 1).all()
    if x_off or out_off:
        assert body == 0
    else:
        assert n - body < 4


@pytest.mark.parametrize("n,offset", [(33 * 7, 0), (1001, 0), (1001, 1)])
def test_copy_probe_runs_plain_on_cpu(n, offset):
    """On CPU tensors, also an offset view, the wrapper runs the plain
    version and launches nothing."""
    from legionsolvers_tpu_torch.ops.cuda import stencil2d as T

    flat = torch.from_numpy(np.random.default_rng(4).standard_normal(
        n + offset).astype(np.float32))
    x = flat[offset:]
    T.reset_launch_counts()
    assert torch.equal(K12.copy_probe(x), x + 1.0)
    assert sum(T.LAUNCHES.values()) == 0


def test_rates_window_is_the_cards():
    """A healthy H100 reading passes where the JAX package's TPU window
    refuses it; readings above the data sheet's f32 peak or shared-memory
    rate, or missing keys, are refused."""
    assert vpu_probe.rates_sane(H100_RATES)
    assert not JV.rates_sane(dict(H100_RATES, vpu_fma_ops_per_s=6.6e13))
    assert vpu_probe.rates_sane(dict(H100_RATES, vpu_fma_ops_per_s=6.6e13))
    assert not vpu_probe.rates_sane(dict(H100_RATES,
                                         vpu_fma_ops_per_s=6.8e13))
    smem = vpu_probe.SMEM_BYTES_PER_S / vpu_probe.EXCHANGE_BYTES_PER_STEP
    assert 4.1e12 < smem < 4.3e12
    for key in ("vpu_roll_plus_add_reps_per_s",
                "vpu_row_shift_add_reps_per_s"):
        assert not vpu_probe.rates_sane(dict(H100_RATES, **{key: 1.01 * smem}))
        assert not vpu_probe.rates_sane(dict(H100_RATES, **{key: 1e6}))
    assert not vpu_probe.rates_sane({"vpu_fma_ops_per_s": 6e13})
    assert not vpu_probe.rates_sane(None)


def test_rate_cache_lives_under_build():
    path = vpu_probe.cache_path("NVIDIA H100 80GB HBM3")
    build = (REPO / "build").resolve()
    assert build in path.resolve().parents
    assert path.name != "VPU_RATES.json"
    assert path.name == "NVIDIA_H100_80GB_HBM3.json"
    assert vpu_probe.cache_path("other card") != path


def test_load_or_measure_off_the_card():
    """None for the CPU (nothing to probe), as the JAX package returns
    off a TPU; asking for the card without one raises."""
    assert vpu_probe.load_or_measure(device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            vpu_probe.load_or_measure()


def test_vpu_rates_json_is_never_the_cache(monkeypatch, tmp_path):
    """load_or_measure on a (faked) card reads and writes only the card's
    cache file, which it fills with a measurement; the repository's
    VPU_RATES.json is untouched."""
    repo_rates = (REPO / "VPU_RATES.json").read_bytes()
    monkeypatch.setattr(vpu_probe, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    monkeypatch.setattr(vpu_probe, "cache_path",
                        lambda name: tmp_path / f"{name}.json")
    monkeypatch.setattr(vpu_probe, "measure_rates",
                        lambda device: dict(H100_RATES))
    assert vpu_probe.load_or_measure() == H100_RATES
    cached = json.loads((tmp_path / "card.json").read_text())
    assert cached["device"] == "card"
    # another card's file is discarded and measured again
    (tmp_path / "card.json").write_text(json.dumps(dict(H100_RATES,
                                                        device="other")))
    monkeypatch.setattr(vpu_probe, "measure_rates",
                        lambda device: dict(H100_RATES, vpu_fma_ops_per_s=6e13))
    assert vpu_probe.load_or_measure()["vpu_fma_ops_per_s"] == 6e13
    # a failed measurement raises on the card
    (tmp_path / "card.json").unlink()

    def fail(device):
        raise RuntimeError("implausible op rates")

    monkeypatch.setattr(vpu_probe, "measure_rates", fail)
    with pytest.raises(RuntimeError, match="implausible"):
        vpu_probe.load_or_measure()
    assert (REPO / "VPU_RATES.json").read_bytes() == repo_rates
