"""Debug and observability utilities.

Port of ``legionsolvers_tpu/utils/debug.py``: ``print_index_partition``
(reference: LegionUtilities.cpp:24-69 and PrintIndexTask,
UtilityTasks.cpp:102-125) emits the line format the reference's golden
harness parses ("<name> (<piece>) <<index>>"), so that its output can be
diffed against the reference's EXPECTED_PARTITION_OUTPUT
(test_all.py:19-127) after sorting, under the "[LegionSolvers]" prefix
(reference: LegionUtilities.hpp:119-121).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from ..core.partition import BlockPartition

PREFIX = "[LegionSolvers]"

PieceMap = Union[BlockPartition, Sequence[np.ndarray], Dict[int, Sequence[int]]]


def _pieces_of(partition: PieceMap) -> List[np.ndarray]:
    if isinstance(partition, BlockPartition):
        return [partition.piece_indices(p) for p in range(partition.num_pieces)]
    if isinstance(partition, dict):
        return [np.asarray(partition[k]) for k in sorted(partition)]
    return [np.asarray(p) for p in partition]


def format_index_partition(name: str, partition: PieceMap) -> List[str]:
    """Lines in the reference's PrintIndexTask format: a banner, then one
    "<name> (<piece>) <<index>>" line per owned index."""
    pieces = _pieces_of(partition)
    lines = [
        f"{PREFIX} Printing index partition {name} with {len(pieces)} pieces."
    ]
    for p, idx in enumerate(pieces):
        lines.extend(f"{name} ({p}) <{i}>" for i in
                     np.asarray(idx).ravel().astype(np.int64).tolist())
    return lines


def print_index_partition(name: str, partition: PieceMap) -> None:
    for line in format_index_partition(name, partition):
        print(line)
