"""Segmenting a large tree into row-bounded subtree segments (host side).

Counterpart: ``libpll_tpu/ops/clv_pallas_seg.py:54-249`` (``Segment``,
``SegmentedSchedule``, ``build_segmented_schedule``), in numpy and plain
Python.  For the same ``max_rows`` the result is the JAX package's, entry
for entry: the dyn tier (``ops/clv_dyn.py``) pads these segments into its
tables, and the next slice's segmented kernels (K3/K4) will read them as
they are.

The cut: a DFS from the root; a node whose accumulated subtree row count
would exceed ``max_rows`` closes its larger child subtree into a segment
and replaces it with a virtual tip (size 1), until the node fits.  Each
segment references its children as ("tip", i) into its own tip list,
("imp", i) into rows imported from earlier segments, or ("loc", i) into its
own local rows; scaler references likewise, with ("zero",) for tips and
children without a scaler.  Only the few subtree-root rows that later
segments import ever cross between segments.

What ``max_rows`` should be is the caller's rule: the TPU budget of the JAX
package does not apply on the GPU (see ``clv_dyn.dyn_max_rows``).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .sweep import LevelSchedule


@dataclass
class Segment:
    """One segment: its tips, imports, ops and exported locals.

    ``ops`` hold (local_parent, csrc1, m1, csrc2, m2, ssrc1, ssrc2,
    has_scaler) in post order."""

    tip_globals: List[int] = field(default_factory=list)  # global tip ids
    imports: List[Tuple[int, int]] = field(default_factory=list)  # (seg, loc)
    ops: List[tuple] = field(default_factory=list)
    export_locals: List[int] = field(default_factory=list)

    @property
    def n_local(self) -> int:
        return len(self.ops)


@dataclass
class SegmentedSchedule:
    segments: List[Segment]
    tips: int
    n_inner: int
    tip_perm: np.ndarray  # [tips] global tip id per permuted position
    tip_slab_sizes: List[int]
    # level-major inner row -> (segment, local row)
    loc_of: Dict[int, Tuple[int, int]]
    seg_offsets: List[int]  # segment-major global row offsets

    def inner_row(self, level_major_inner_row: int) -> int:
        s, l = self.loc_of[level_major_inner_row]
        return self.seg_offsets[s] + l

    def scaler_row(self, level_major_inner_row: int) -> int:
        return self.inner_row(level_major_inner_row)


def flat_ops(schedule: LevelSchedule) -> List[tuple]:
    """(inner_row, c1, m1, c2, m2, s1, s2, has_scaler) in level order, as
    Python scalars (``clv_pallas._flatten_ops``)."""
    tips = schedule.tips
    return [(lev.offset + k - tips, int(lev.child1[k]), int(lev.matrix1[k]),
             int(lev.child2[k]), int(lev.matrix2[k]), int(lev.scaler1[k]),
             int(lev.scaler2[k]), bool(lev.has_scaler[k]))
            for lev in schedule.levels for k in range(len(lev.child1))]


def build_segmented_schedule(schedule: LevelSchedule, *, max_rows: int,
                             ensure_rows: Sequence[int] = ()
                             ) -> SegmentedSchedule:
    """Cut ``schedule`` into segments of at most ``max_rows`` rows.

    ``ensure_rows``: level-major CLV ids the *final* segment must be able to
    reference (the evaluation edge's ends), added to its tip list or
    imports where the walk did not reach them."""
    tips, n_inner = schedule.tips, schedule.n_inner
    flat = flat_ops(schedule)

    # the ops form a forest over level-major ids: an unrooted evaluation
    # has one tree per end of the evaluation edge
    op_of = {tips + o[0]: o for o in flat}
    child_set = {o[1] for o in flat} | {o[3] for o in flat}
    roots = [g for g in op_of if g not in child_set]

    segments: List[Segment] = []
    seg_of: Dict[int, Tuple[int, int]] = {}  # inner global -> (seg, local)

    def emit_segment(vs: Sequence[int]) -> None:
        """Close the uncut remainders of the subtrees at ``vs`` into one
        segment."""
        seg = Segment()
        si = len(segments)
        tip_pos: Dict[int, int] = {}
        imp_pos: Dict[Tuple[int, int], int] = {}
        local_of: Dict[int, int] = {}

        def csrc(g: int):
            if g < tips:
                if g not in tip_pos:
                    tip_pos[g] = len(seg.tip_globals)
                    seg.tip_globals.append(g)
                return ("tip", tip_pos[g])
            if g in seg_of:
                key = seg_of[g]
                if key not in imp_pos:
                    imp_pos[key] = len(seg.imports)
                    seg.imports.append(key)
                    segments[key[0]].export_locals.append(key[1])
                return ("imp", imp_pos[key])
            return ("loc", local_of[g])

        def ssrc(s_level_major: int, g_child: int):
            # as ops/sweep.py: the zero dummy for tips and children without
            # a scaler, else the child's own counter row
            if s_level_major >= n_inner or g_child < tips:
                return ("zero",)
            src = csrc(g_child)
            return ("simp", src[1]) if src[0] == "imp" else ("sloc", src[1])

        def walk(g: int) -> None:  # post order over the uncut subtree
            (_, c1, m1, c2, m2, s1, s2, has) = op_of[g]
            for c in (c1, c2):
                if c >= tips and c not in seg_of and c not in local_of:
                    walk(c)
            src1, src2 = csrc(c1), csrc(c2)
            sr1, sr2 = ssrc(s1, c1), ssrc(s2, c2)
            local_of[g] = len(seg.ops)
            seg.ops.append((local_of[g], src1, m1, src2, m2, sr1, sr2, has))

        for v in vs:
            if v not in seg_of:
                walk(v)
        segments.append(seg)
        for g, l in local_of.items():
            seg_of[g] = (si, l)

    def visit(g: int) -> int:
        (_, c1, _, c2, *_rest) = op_of[g]
        s1 = visit(c1) if c1 >= tips else 1
        s2 = visit(c2) if c2 >= tips else 1
        s = s1 + s2 + 1
        while s > max_rows:
            big, sb = ((c1, s1) if s1 >= s2 else (c2, s2))
            if big < tips or big in seg_of:
                break  # cannot shrink further: accept an oversize segment
            emit_segment([big])
            s = s - sb + 1
            if big == c1:
                s1 = 1
            else:
                s2 = 1
        return s

    # a caterpillar recurses once per node
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * (tips + n_inner) + 1000))
    try:
        sizes = {r: visit(r) for r in roots}
        # the final segment merges every root's remainder; when the union
        # exceeds the budget, the largest roots get segments of their own
        while sum(sizes.values()) > max_rows and max(sizes.values()) > 1:
            r = max(sizes, key=sizes.get)
            emit_segment([r])
            sizes[r] = 1
        emit_segment(roots)
    finally:
        sys.setrecursionlimit(old_limit)

    final_si = len(segments) - 1
    final = segments[final_si]
    for g in list(roots) + [int(r) for r in ensure_rows]:
        if g < tips:
            if g not in final.tip_globals:
                final.tip_globals.append(g)
        else:
            s_i, l = seg_of[g]
            if s_i == final_si:
                if l not in final.export_locals:
                    final.export_locals.append(l)
            else:
                if (s_i, l) not in final.imports:
                    final.imports.append((s_i, l))
                if l not in segments[s_i].export_locals:
                    segments[s_i].export_locals.append(l)

    tip_perm = np.concatenate(
        [np.asarray(s.tip_globals, np.int64) for s in segments
         if s.tip_globals])
    # ensure_rows may repeat a tip in the final segment: every tip is
    # covered, not partitioned
    assert len(set(tip_perm.tolist())) == tips, (tip_perm.size, tips)

    offsets, acc = [], 0
    for s in segments:
        offsets.append(acc)
        acc += s.n_local
    assert acc == n_inner

    loc_of = {g - tips: sl for g, sl in seg_of.items()}
    return SegmentedSchedule(segments, tips, n_inner, tip_perm,
                             [len(s.tip_globals) for s in segments],
                             loc_of, offsets)
