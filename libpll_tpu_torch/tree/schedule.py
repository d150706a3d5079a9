"""Operation-schedule post-processing: dependency levels for batched sweeps.

Counterpart: ``libpll_tpu/tree/schedule.py:23``, copied; its tables feed
:func:`libpll_tpu_torch.ops.clv.update_partials_leveled`.

The reference executes operations strictly sequentially
(`src/partials.c:184`); all operations in the same dependency level
of the post-order DAG are independent, so they can run as ONE batched product
per level. Levels are padded to a common width by duplicating an
op from the same level — duplicate writes are idempotent (same inputs → same
CLV/scaler values), so no masking is needed.

Padding the width to the per-tree maximum keeps the table's shape fixed
across SPR candidates.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..engine.partition import Operation, operations_to_array


def build_levels(operations: Sequence[Operation], n_scale_buffers: int,
                 width: int | None = None,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Group operations into dependency levels.

    Returns (level_ops int32 [n_levels, width, 8],
             level_valid bool [n_levels, width]).
    """
    ops = operations_to_array(operations, n_scale_buffers)
    level_of = {}  # clv index -> level it becomes available
    levels: List[List[np.ndarray]] = []
    for row in ops:
        c1, c2 = int(row[2]), int(row[5])
        lvl = max(level_of.get(c1, -1), level_of.get(c2, -1)) + 1
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append(row)
        level_of[int(row[0])] = lvl

    max_w = width or max(len(lv) for lv in levels)
    n_levels = len(levels)
    out = np.zeros((n_levels, max_w, 8), dtype=np.int32)
    valid = np.zeros((n_levels, max_w), dtype=bool)
    for i, lv in enumerate(levels):
        assert len(lv) <= max_w, "level wider than requested width"
        for j in range(max_w):
            # pad by repeating ops from the same level: duplicates recompute
            # identical values, so concurrent writes agree — which also means
            # padded lanes must scale exactly like their originals
            out[i, j] = lv[j % len(lv)]
        valid[i, :] = True
    return out, valid
