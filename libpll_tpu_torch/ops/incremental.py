"""Op-table padding for schedule-as-data updates.

Counterpart: ``libpll_tpu/ops/incremental.py:41`` (``pad_op_table``),
which ``Partition.update_partials(pad_to=...)`` needs.  The rest of that
module (the candidate scorer of tree search) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..errors import CapacityError


def pad_op_table(ops_arr: np.ndarray, capacity: int) -> np.ndarray:
    """Pad an [n, 8] op table to [capacity, 8] by repeating the final op
    (recomputing an op is idempotent: parent CLV and scaler are pure
    functions of the children).  Raises if n > capacity."""
    n = ops_arr.shape[0]
    if n > capacity:
        raise CapacityError(
            f"op subset ({n}) exceeds capacity ({capacity})")
    if n == 0:
        raise ValueError("empty op table")
    pad = np.repeat(ops_arr[-1:], capacity - n, axis=0)
    return np.concatenate([ops_arr, pad], axis=0).astype(np.int32)
