"""CLV update operations.

Counterpart: ``libpll_tpu/engine/partition.py:50-68``.  Only
:class:`Operation` is ported so far; the stateful ``Partition`` class
follows in a later slice of the port.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Operation:
    """One CLV update: mirrors pll_operation_t (reference pll.h:249-259)."""

    parent_clv_index: int
    parent_scaler_index: int
    child1_clv_index: int
    child1_matrix_index: int
    child1_scaler_index: int
    child2_clv_index: int
    child2_matrix_index: int
    child2_scaler_index: int

    def as_tuple(self):
        # NOT dataclasses.astuple: that routes through deepcopy
        return (self.parent_clv_index, self.parent_scaler_index,
                self.child1_clv_index, self.child1_matrix_index,
                self.child1_scaler_index, self.child2_clv_index,
                self.child2_matrix_index, self.child2_scaler_index)
