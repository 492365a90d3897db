"""``entry.entry()`` and ``entry.dryrun_multichip(n)`` against
``__graft_entry__``'s.

JAX runs its entry points on the conftest's CPU backend (its dry run on
the first 4 of the 8 virtual devices, its Pallas kernels in interpret
mode); the port runs them on the CPU (``device="cpu"``), its dry run on a
one-process 4-shard mesh, where its wrappers take their plain versions.
JAX's dry run takes about 45 s on a CPU, so each package's runs once per
file.  Held:

* ``entry()``: one f32 CG step at 256^2 from the example state, sol and
  rr within rtol 1e-6 of JAX's (sol relative to max|sol|), and the step
  a function of its arguments (the example state is not consumed);
* ``dryrun_multichip(4)``: its printed line has JAX's keys in JAX's order
  under the prefix ``[legionsolvers_tpu_torch]``, each number within rtol
  1e-3 of JAX's (JAX prints 6 significant digits: ``:g``), and the line
  prints the histories the call returns;
* ``python -m legionsolvers_tpu_torch.entry`` on the CPU, one step and
  ``--dryrun 4``.
"""

import contextlib
import functools
import io
import re

import jax
import numpy as np
import pytest
import torch

from legionsolvers_tpu_torch import entry as E

DEV = "cpu"
DRYRUN_RTOL = 1e-3  # the printed numbers carry 6 significant digits
ENTRY_RTOL = 1e-6
NUMBER = r"[-+0-9.einfa]+"


@functools.lru_cache(maxsize=None)
def jax_dryrun_line() -> str:
    import __graft_entry__ as G

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        G.dryrun_multichip(4)
    return buf.getvalue().strip().splitlines()[-1]


@functools.lru_cache(maxsize=None)
def port_dryrun():
    """(printed line, returned histories) of the port's dry run."""
    torch.set_num_threads(2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hists = E.dryrun_multichip(4, device=DEV)
    return buf.getvalue().strip().splitlines()[-1], hists


def fields(line: str):
    """[(key, number text)] of a dry run line, in order."""
    body = line.split(": ok, ", 1)[1]
    return re.findall(rf"([a-z0-9\-\[\]]+ ?[a-z0-9\[\]]*)=({NUMBER})", body)


@functools.lru_cache(maxsize=None)
def jax_entry_step():
    import __graft_entry__ as G

    fn, (state, rr) = G.entry()
    new_state, rr_new = jax.jit(fn)(state, rr)
    return (np.asarray(new_state["sol"][0], np.float64).reshape(-1),
            float(rr), float(rr_new))


def test_entry_matches_jax():
    """One CG step of ``entry()`` at 256^2 in f32: rr0, rr1 and sol within
    rtol 1e-6 of JAX's ``entry()`` (sol relative to max|sol|)."""
    fn, (state, rr) = E.entry(device=DEV)
    new_state, rr_new = fn(state, rr)
    assert new_state["sol"][0].dtype == torch.float32
    assert new_state["sol"][0].device == torch.device(DEV)
    xj, rr0j, rr1j = jax_entry_step()
    np.testing.assert_allclose(float(rr), rr0j, rtol=ENTRY_RTOL)
    np.testing.assert_allclose(float(rr_new), rr1j, rtol=ENTRY_RTOL)
    x = new_state["sol"][0].double().numpy().reshape(-1)
    np.testing.assert_allclose(x, xj, rtol=0,
                               atol=ENTRY_RTOL * np.abs(xj).max())


def test_entry_step_is_a_function_of_its_arguments():
    """Two steps from the same example state give the same state and rr:
    the step rebinds the planner's vectors and never writes into the
    state it was given."""
    fn, (state, rr) = E.entry(device=DEV)
    before = {k: [t.clone() for t in v if t is not None]
              for k, v in state.items() if k != "ops"}
    s1, rr1 = fn(state, rr)
    s2, rr2 = fn(state, rr)
    assert torch.equal(rr1, rr2)
    assert torch.equal(s1["sol"][0], s2["sol"][0])
    for k, ts in before.items():
        for a, b in zip(ts, state[k]):
            assert torch.equal(a, b), k


def test_dryrun_keys_match_jax():
    """The port's line has JAX's keys in JAX's order, under its own
    prefix."""
    line, _ = port_dryrun()
    jline = jax_dryrun_line()
    assert line.startswith("[legionsolvers_tpu_torch] dryrun_multichip(4): "
                           "ok, ")
    assert jline.startswith("[legionsolvers_tpu] dryrun_multichip(4): ok, ")
    keys = [k for k, _ in fields(line)]
    assert keys == [k for k, _ in fields(jline)]
    assert len(keys) == 11


DRYRUN_KEYS = ("step rr0", "rr1", "fused rr[3]", "sstep rr[4]",
               "bicgstab rr[3]", "gmres rr[2cyc]", "block-cg rr[4]",
               "block-bicg rr[3]", "winell rr[3]", "dia rr[3]", "pcg rr[3]")


@pytest.mark.parametrize("key", DRYRUN_KEYS)
def test_dryrun_matches_jax(key):
    """Each printed number of ``dryrun_multichip(4)`` within rtol 1e-3 of
    JAX's on its 4-device CPU mesh."""
    line, _ = port_dryrun()
    mine = dict(fields(line))
    theirs = dict(fields(jax_dryrun_line()))
    a, b = float(mine[key]), float(theirs[key])
    assert np.isfinite(a)
    np.testing.assert_allclose(a, b, rtol=DRYRUN_RTOL)


def test_dryrun_prints_its_histories():
    """The returned histories are the printed ones: each section's last
    entry (the step's two) formatted with ``:g``, and every entry
    finite."""
    line, hists = port_dryrun()
    printed = [v for _, v in fields(line)]
    want = [hists["step"][0], hists["step"][1]] + [
        hists[k][-1] for k in ("fused", "sstep", "bicgstab", "gmres",
                               "block-cg", "block-bicg", "winell", "dia",
                               "pcg")]
    assert printed == [f"{v:g}" for v in want]
    for k, h in hists.items():
        assert np.all(np.isfinite(h)), k
    assert hists["gmres"].shape == (3,)
    assert hists["gmres"][-1] < hists["gmres"][0]


def test_entry_module_main(monkeypatch, capsys):
    """``python -m legionsolvers_tpu_torch.entry --device cpu``: one step,
    its line; ``--dryrun 4``: the dry run on one process (no WORLD_SIZE:
    ``initialize_distributed`` is a no-op)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert E.main(["--device", DEV]) == 0
    out = capsys.readouterr().out
    assert "[legionsolvers_tpu_torch] entry(): single-device CG step ran " \
           "on cpu, rr1=4.16154e+06" in out
    assert E.main(["--dryrun", "4", "--device", DEV]) == 0
    assert port_dryrun()[0] in capsys.readouterr().out


def test_entry_needs_the_card_without_a_device():
    """Without ``device=`` the entry points ask for the card, and there is
    none here: they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        E.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        E.dryrun_multichip(4)
