"""The CUDA kernels against their plain versions, on the card.

Skips without an NVIDIA GPU.  Imports no jax, so that it runs on a machine
with the card and no JAX, as ``python -m pytest --noconftest
tests/test_torch_kernels_cuda.py`` (tests/conftest.py imports jax).
Tolerances are those of ``torch_stencil_cases.py``; the BiCGStab passes
use test_torch_bicgstab2d.py's (elementwise 2e-5 * max|ref|, dots rtol
2e-4), and their compensated dots must match the plain versions' float64
sums to 4e-7.
"""

import numpy as np
import pytest
import torch

from legionsolvers_tpu_torch.ops.cuda import bicgstab2d as TB
from legionsolvers_tpu_torch.ops.cuda import stencil2d as T
from torch_stencil_cases import KW, MODES, compare, make_inputs, run_port

torch.set_num_threads(2)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (200, 328)])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_matches_plain_on_card(mode, shape, cuda_device):
    """Each CUDA kernel against its plain version on the same card."""
    T.reset_launch_counts()
    d = make_inputs(shape, seed=5)
    got = {k: v.cpu().numpy() for k, v in
           run_port(mode, d, device=cuda_device).items()}
    assert sum(T.LAUNCHES.values()) == 1
    ref = {k: v.numpy() for k, v in run_port(mode, d).items()}
    compare(got, ref, d, mode)



def _bicg(kernel, d, device, compensated, plain=False):
    """One K5 pass on copies of ``d`` on ``device``: the wrapper, or with
    ``plain`` its plain version."""
    t = {k: torch.as_tensor(np.array(v), device=device) for k, v in d.items()}
    kw = dict(KW, compensated=compensated)
    fn = getattr(TB, f"bicg_{kernel}_plain" if plain else f"bicg_{kernel}")
    if kernel == "pv":
        out = fn(t["r"], t["p"], t["v"], t["rt"], 0.37, 0.41, **kw)
        names = ("p", "v", "rtv")
    elif kernel == "st":
        out = fn(t["r"], t["v"], 0.83, **kw)
        names = ("ts", "tt")
    else:
        out = fn(t["r"], t["v"], t["x"], t["p"], t["rt"], 0.83, 0.41, **kw)
        names = ("x", "r", "rr", "rtr")
    return {k: v.double().cpu().numpy() for k, v in zip(names, out)}


@pytest.mark.cuda
@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("shape", [(64, 128), (200, 328)])
@pytest.mark.parametrize("kernel", ["pv", "st", "update"])
def test_bicgstab_kernel_matches_plain_on_card(kernel, shape, compensated,
                                               cuda_device):
    """K5 against its plain version on the same card."""
    rng = np.random.default_rng(9)
    d = {k: rng.standard_normal(shape).astype(np.float32)
         for k in ("x", "r", "p", "v", "rt")}
    T.reset_launch_counts()
    got = _bicg(kernel, d, cuda_device, compensated)
    assert dict(T.LAUNCHES) == {f"bicg_{kernel}": 1}
    ref = _bicg(kernel, d, cuda_device, compensated, plain=True)
    for key, want in ref.items():
        if want.ndim:
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=2e-5 * np.abs(want).max(),
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want, rtol=2e-4,
                                       atol=1e-2 if key == "rtr" else 0,
                                       err_msg=key)
    if compensated and kernel != "st":
        vec = got["v"] if kernel == "pv" else got["r"]
        rt = d["rt"].astype(np.float64)
        exact = ({"rtv": (rt * vec).sum()} if kernel == "pv" else
                 {"rr": (vec * vec).sum(), "rtr": (rt * vec).sum()})
        for key, want in exact.items():
            assert abs(got[key] - want) <= 4e-7 * abs(want), key
