"""The port's partition printer and banner (``utils/debug.py``,
``utils/initialize.py``): the twins of test_09's golden and banner tests,
the port's lines equal to the JAX package's."""

import re

import numpy as np
import pytest

import legionsolvers_tpu as J
import legionsolvers_tpu_torch as T
from legionsolvers_tpu.utils.debug import format_index_partition as j_format
from legionsolvers_tpu_torch.utils import initialize as TI
from legionsolvers_tpu_torch.utils.debug import (
    format_index_partition,
    print_index_partition,
)

# The reference's expected output (test_all.py:19-127), as test_09 holds
# it: the sorted lines for the three partitions of the n = 20, 4-piece
# system.
EXPECTED_HEADERS = [
    "[LegionSolvers] Printing index partition domain_partition with 4 pieces.",
    "[LegionSolvers] Printing index partition matrix_partition with 4 pieces.",
    "[LegionSolvers] Printing index partition range_partition with 4 pieces.",
]
DOMAIN = {0: range(6), 1: [4, 5, 6, 7, 8, 9, 10], 2: [9, 10, 11, 12, 13, 14, 15],
          3: [14, 15, 16, 17, 18, 19]}
MATRIX = {0: range(0, 14), 1: range(14, 29), 2: range(29, 44), 3: range(44, 58)}
RANGE = {p: range(5 * p, 5 * p + 5) for p in range(4)}


def expected_lines():
    lines = list(EXPECTED_HEADERS)
    for name, mp in [("domain_partition", DOMAIN), ("matrix_partition", MATRIX),
                     ("range_partition", RANGE)]:
        for p, idxs in mp.items():
            lines += [f"{name} ({p}) <{i}>" for i in idxs]
    return sorted(lines)


def partitions(pkg):
    A = pkg.coo_negative_laplacian_1d(20)
    part = pkg.BlockPartition(20, 4)
    kernel = A.kernel_partition_from_range_partition(part)
    return part, kernel, A.domain_partition_from_kernel_partition(kernel)


def test_partition_print_matches_reference_harness():
    part, kernel, domain = partitions(T)
    out = (format_index_partition("range_partition", part)
           + format_index_partition("matrix_partition", kernel)
           + format_index_partition("domain_partition", domain))
    assert sorted(out) == expected_lines()


@pytest.mark.parametrize("form", ["partition", "arrays", "dict"])
def test_partition_lines_equal_jaxs(form):
    """The same lines as the JAX package's, in the same order, for a
    BlockPartition, a list of arrays and a dict of pieces."""
    part, kernel, domain = partitions(T)
    jpart, jkernel, jdomain = partitions(J)
    if form == "partition":
        got, want = (format_index_partition("p", part),
                     j_format("p", jpart))
    elif form == "arrays":
        got = (format_index_partition("k", kernel)
               + format_index_partition("d", domain))
        want = j_format("k", jkernel) + j_format("d", jdomain)
    else:
        pieces = {2: np.asarray([7, 3]), 0: [1], 1: np.empty(0, np.int64)}
        got, want = (format_index_partition("m", pieces),
                     j_format("m", pieces))
    assert got == want


def test_print_index_partition(capsys):
    print_index_partition("range_partition", T.BlockPartition(6, 2))
    assert capsys.readouterr().out.splitlines() == [
        "[LegionSolvers] Printing index partition range_partition with 2 "
        "pieces.",
        *(f"range_partition ({p}) <{i}>" for p in range(2)
          for i in range(3 * p, 3 * p + 3))]


def test_initialize_banner(capsys):
    TI.initialize(print_info=True, verbose=False)
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert all(line.startswith("[LegionSolvers] ") for line in lines)
    assert re.fullmatch(r"\[LegionSolvers\] legionsolvers_tpu_torch "
                        rf"{re.escape(T.__version__)} on torch \S+", lines[0])
    assert "backend: " in lines[1]
    assert lines[2] == ("[LegionSolvers] entry types: float32, float64; "
                        "index types: int32, int64; max stencil dim: 3")
    TI.initialize(print_info=False)  # silent path
    assert capsys.readouterr().out == ""


def test_initialize_verbose_lists_the_switches(capsys, monkeypatch):
    """Verbose: the TF32 setting (on stderr, as JAX's precision line) and
    the kill-switches the port reads, with the ones set."""
    for s in TI.SWITCHES:
        monkeypatch.delenv(f"LEGIONSOLVERS_{s}", raising=False)
    monkeypatch.setenv("LEGIONSOLVERS_NO_RCM", "1")
    monkeypatch.setenv("LEGIONSOLVERS_NO_NATIVE", "1")
    TI.initialize(verbose=True)
    cap = capsys.readouterr()
    assert "TF32 matmul: " in cap.err
    last = cap.out.splitlines()[-1]
    assert last == ("[LegionSolvers] kill-switches active: NO_RCM, NO_NATIVE"
                    " (available: " + ", ".join(TI.SWITCHES) + ")")


def test_switches_are_the_ones_the_port_reads():
    """SWITCHES names every LEGIONSOLVERS_NO_* variable the port's code
    reads, and none that it does not."""
    import pathlib

    pkg = pathlib.Path(T.__file__).parent
    read = set()
    for f in pkg.rglob("*.py"):
        read.update(re.findall(
            r"(?:environ\.get|_env_flag)\(\s*\"LEGIONSOLVERS_(NO_\w+)\"",
            f.read_text()))
    assert read == set(TI.SWITCHES)
