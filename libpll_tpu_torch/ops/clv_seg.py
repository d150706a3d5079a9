"""The segmented large-tree tier: the segment cut (host), the segmented
sweep (K3) and the segmented score (K4), their plain PyTorch versions and
the CUDA wrappers.

Counterpart: ``libpll_tpu/ops/clv_pallas_seg.py``.  The cut
(``Segment``, ``SegmentedSchedule``, ``build_segmented_schedule``,
``:54-249``) is the JAX package's, entry for entry, in numpy and plain
Python; the dyn tier (``ops/clv_dyn.py``) pads these segments into its
tables.  K3 replaces ``make_segmented_sweep`` (``:327``, ``pallas_call`` at
``:386``), K4 replaces ``make_segmented_score`` (``:425``; leaf segments at
``:600``, the root segment at ``:555``).  Both kernels are
``csrc/clv_seg.cu`` (DNA and protein, S in {4, 20} at C in {1, 2, 4, 8})
and ``csrc/clv_seg_any.cu`` (every other 2 <= S <= 64 and C, and any
schedule whose pool those instances cannot hold); those files say how they
are laid out on the card and what bounds them.

The cut: a DFS from the root; a node whose accumulated subtree row count
would exceed ``max_rows`` closes its larger child subtree into a segment
and replaces it with a virtual tip (size 1), until the node fits.  Each
segment references its children as ("tip", i) into its own tip list,
("imp", i) into rows imported from earlier segments, or ("loc", i) into its
own local rows; scaler references likewise, with ("zero",) for tips and
children without a scaler.  Only the few subtree-root rows that later
segments import ever cross between segments.

The row budget.  On the TPU a segment's rows lived in VMEM
(``_max_rows``/``_VMEM_BUDGET``, ``:94-99``, not ported).  The cut's
``max_rows`` here, :func:`seg_max_rows`, is the first kernel's: a
segment's local rows at ``TILE_SITES`` sites per block in ``SMEM_BUDGET``
(two blocks per SM; a binary subtree of s rows, tips and imports counted,
has (s - 1) / 2 locals), 23 rows for DNA at four rates in float32; where
one row is wider than a block's shared memory it is JAX's floor of 8 rows
(9 here), and the any-alphabet instance spills.  The
kernel now runs one launch per call: a block of ``SLOT_SITES`` sites walks
every segment, with each segment's live local rows in a shared-memory
pool planned on the host (:func:`segment_slots`, the dyn kernels'
planner) and the op descriptors resolved once per schedule.  Its shared
memory (:func:`kernel_smem`) is checked against ``SMEM_LIMIT`` before
anything runs (:meth:`_SegKernel.instance`): a schedule whose pool does
not fit takes the any-alphabet instance, which keeps the slots that fit
two blocks an SM (:func:`any_shared_slots`) in shared memory and spills
the rest to device rows.

K3/K4 take CLV tips only (per-segment slabs from
:func:`pack_tips_segmented`, rows rate-major: the JAX package's "mxu"
layout, the port's only one) and no +I, as on the TPU.  ``impl`` is
accepted for signature parity: the port has one contraction.  Each wrapper
takes its plain version for a tensor on the CPU, and only there: on a CUDA
tensor it launches its kernel, once per call, or raises.  Each counts its
launches in its class's ``launches``, and those of the any-alphabet
instance also in ``any_launches``.  ``block_sites`` is taken as JAX takes
it: any block that divides the sites (JAX's error otherwise); the partial
sums stay per ``TILE_SITES`` sites, their float64 total the logL.  The
slab list is checked and its addresses copied to the card the first time
its data pointers are seen.
Beside the plain versions, ``plain_walk`` runs the kernel's walk (the op
descriptors, the pool slots, the rows written as the ops make them) with
PyTorch ops, so the descriptors and the plan are tested where no kernel
runs.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import EinvalError, KernelError
from ..utils.constants import (SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE,
                               scale_consts)
from . import _build
from . import clv_fused as cf
from . import likelihood as lk
from .sweep import LevelSchedule

TABLE_FIELDS = 6  # parent, child1, child2, scaler1, scaler2, has_scaler
KERNEL_STATES = (4, 20)  # DNA and protein
TILE_SITES = cf.BLOCK_SITES  # sites per float64 partial sum
# the any-alphabet instance (csrc/clv_seg_any.cu): 2 <= S <= ANY_MAX_STATES
# at any rate count, a block of ANY_SITES sites (a thread a site)
ANY_MAX_STATES = cf.ANY_MAX_STATES
ANY_SITES = 128
# its pool's shared memory: half an SM's 228 KB less the 1 KB the card
# reserves per block (two blocks an SM)
ANY_POOL_BUDGET = 233472 // 2 - 1024
# JAX's floor of a segment's rows (clv_pallas_seg.py:_max_rows), where one
# row is wider than a block's shared memory: 2 * 4 + 1 rows
FLOOR_LOCAL_ROWS = 4
# the pool kernels (csrc/clv_seg.cu, csrc/clv_dyn.cu): sites per block
# (kTileSites) and ops staged at once (kChunk)
SLOT_SITES = 32
STAGE_OPS = 16
# dynamic shared memory of one block of csrc/clv_seg.cu.  The limit: an
# H100 block may use 227 KB (232 448 bytes), less 1 KB kept for the
# kernel's static part (a chunk of staged op descriptors, the votes, the
# tip buffers' barriers).  The cut's budget: half an SM's 228 KB (233 472
# bytes) less the 1 KB the card reserves per block and 32 bytes, for the
# first kernel's layout of local rows at TILE_SITES sites (two blocks per
# SM), kept so that the schedule stays as it was
SMEM_LIMIT = 232448 - 1024
SMEM_BUDGET = 233472 // 2 - 1024 - 32
# an op's descriptor (clv_common.cuh's OpDesc: parent, home, child1,
# child2, scaler1, scaler2, m1, m2, has_scaler, out, 2 unused), a
# segment's (op0, n_ops, n_tip, unused), and the sources they name as
# kind << INDEX_BITS | index (K_ZERO: no counter)
OP_FIELDS = 12
SEG_FIELDS = 4
K_TIP, K_IMP, K_POOL = 0, 1, 2
K_ZERO = -1
INDEX_BITS = 28


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


# --------------------------------------------------------------------------
# the row budget and the kernels' shared memory
# --------------------------------------------------------------------------
def _itemsize(dtype) -> int:
    return (dtype.itemsize if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).itemsize)


def _smem_bytes(n_local: int, rate_cats: int, states: int, dtype,
                srows: int) -> int:
    """The cut's budget of ``n_local`` rows: C·S values and ``srows``
    int32 counters per row at each of ``TILE_SITES`` sites."""
    return n_local * TILE_SITES * (rate_cats * states * _itemsize(dtype)
                                   + srows * 4)


def seg_local_rows(rate_cats: int, states: int, dtype) -> int:
    """How many local rows (C·S values and, at most, one int32 counter per
    rate, at each of ``TILE_SITES`` sites) fit ``SMEM_BUDGET``: 11 for DNA
    at four rates in float32, 6 in float64.  A row larger than the budget
    gets the one row ``SMEM_LIMIT`` holds (protein at eight rates in
    float64); a row larger than that ``FLOOR_LOCAL_ROWS``, JAX's floor
    (the any-alphabet instance spills them: 61 states at eight rates in
    float64)."""
    row = _smem_bytes(1, rate_cats, states, dtype, rate_cats)
    return SMEM_BUDGET // row or SMEM_LIMIT // row or FLOOR_LOCAL_ROWS


def seg_max_rows(rate_cats: int, states: int, dtype) -> int:
    """The cut's ``max_rows`` on the GPU: segments of at most this many
    rows (tips, imports and locals) hold at most :func:`seg_local_rows`
    local rows, since a binary subtree of s rows has (s - 1) / 2 inner
    nodes.  23 for DNA at four rates in float32."""
    return 2 * seg_local_rows(rate_cats, states, dtype) + 1


def segment_slots(table: np.ndarray, g: _Rows, keep) -> np.ndarray:
    """First-fit pool slots [r_loc] of one segment's local rows (the pool
    kernels' plan: ``clv_dyn.dyn_slot_plan`` and :class:`_SegKernel`).  A
    row lives from its op to its last reader (a child or scaler
    reference); rows in ``keep`` live to the end.  An op's children free
    their slots before its parent takes one: the kernel reads a child into
    registers before it writes the parent (the same thread's column; a
    site's counter is read and written by one lane).  Ops whose parent is
    the trash row are pad ops and get no slot (-1)."""
    n, loc0 = g.r_loc, g.loc0
    live_ops = [i for i in range(n) if table[i, 0] != g.trash_state]
    end = np.full(n, -1, np.int64)
    for i in live_ops:
        _, c1, c2, s1, s2, _ = table[i]
        for ref, base in ((c1, loc0), (c2, loc0), (s1, g.r_imp),
                          (s2, g.r_imp)):
            if base <= ref < base + n:
                end[ref - base] = max(end[ref - base], i)
    end[list(keep)] = n
    slots = np.full(n, -1, np.int32)
    free, n_used, release = [], 0, {}
    for i in live_ops:
        for slot in release.pop(i, ()):
            heapq.heappush(free, slot)
        if free:
            slot = heapq.heappop(free)
        else:
            slot, n_used = n_used, n_used + 1
        l = int(table[i, 0]) - loc0
        slots[l] = slot
        # a row no later op reads frees its slot at the next op
        release.setdefault(max(int(end[l]), i + 1), []).append(slot)
    return slots


def pool_bytes(slots: int, rate_cats: int, states: int, dtype,
               srows: int) -> int:
    """Shared memory of one block's pool: C·S values and ``srows`` int32
    counters per slot at each of the block's ``SLOT_SITES`` sites."""
    return slots * SLOT_SITES * (rate_cats * states * _itemsize(dtype)
                                 + srows * 4)


def stage_bytes(rate_cats: int, states: int, dtype) -> int:
    """Shared memory of the P-matrices a block stages per chunk of ops
    (DNA only): 8 KB at four rates in float32."""
    if states != 4:
        return 0
    return STAGE_OPS * 2 * rate_cats * states * states * _itemsize(dtype)


def kernel_smem(pool: int, rate_cats: int, states: int, dtype,
                srows: int) -> int:
    """Dynamic shared memory of one block of ``csrc/clv_seg.cu``
    (``smem_bytes`` there): the staged P-matrices, a pool of ``pool``
    slots and the edge's exchange of one term and one counter per thread
    (tips are read from device memory).  At the README cut (DNA, four
    rates, float32, per-site scaling) a pool of 4 slots: 17 920 bytes."""
    exchange = SLOT_SITES * rate_cats * (_itemsize(dtype) + 4)
    return (stage_bytes(rate_cats, states, dtype)
            + pool_bytes(pool, rate_cats, states, dtype, srows) + exchange)


def any_instance(states: int, rate_cats: int) -> bool:
    """Whether (S, C) takes the any-alphabet instance of the large tiers
    (``csrc/clv_seg_any.cu``, ``csrc/clv_dyn_any.cu``): every (S, C) but
    the DNA and protein instances' S in {4, 20} at C in {1, 2, 4, 8}."""
    return not (states in KERNEL_STATES and rate_cats in cf.KERNEL_RATE_CATS)


def any_slot_bytes(rate_cats: int, states: int, dtype, srows: int) -> int:
    """Shared memory of one pool slot of the large tiers' any-alphabet
    instances: C·S values and ``srows`` counters at each of ``ANY_SITES``
    sites."""
    return ANY_SITES * (rate_cats * states * _itemsize(dtype) + 4 * srows)


def any_shared_slots(pool: int, rate_cats: int, states: int, dtype,
                     srows: int) -> int:
    """How many of a pool's ``pool`` slots the any-alphabet instance keeps
    in shared memory: as many as fit half an SM (two blocks an SM, 3 for
    16 states at four rates in float32); the rest spill to device rows."""
    return min(pool, ANY_POOL_BUDGET
               // any_slot_bytes(rate_cats, states, dtype, srows))


def fold_tile_partials(tiles: torch.Tensor, sites: int) -> torch.Tensor:
    """The kernel's float64 partial of each ``SLOT_SITES`` sites, summed
    left to right into one per ``TILE_SITES`` sites, the order of the
    first fused kernel's block sum (``tiles`` zero past the last tile)."""
    per = TILE_SITES // SLOT_SITES
    v = tiles.view(-(-sites // TILE_SITES), per)
    out = v[:, 0]
    for k in range(1, per):
        out = out + v[:, k]
    return out


# --------------------------------------------------------------------------
# tips and tables
# --------------------------------------------------------------------------
def pack_tips_segmented(tips_clv, seg: SegmentedSchedule
                        ) -> List[torch.Tensor]:
    """[tips, C, S, L] tip CLVs (numpy or a tensor) -> per-segment slabs
    [n_tip, C·S, L] on the tips' device, rows rate-major
    (``clv_pallas_seg.py:252`` with the "mxu" packing; run once at set-up).
    A segment without tips gets one zero row, as in JAX."""
    clv = (tips_clv if isinstance(tips_clv, torch.Tensor)
           else torch.from_numpy(np.array(tips_clv)))
    t, c, s, sites = clv.shape
    packed = clv.reshape(t, c * s, sites)
    out = []
    for sg in seg.segments:
        if sg.tip_globals:
            idx = torch.as_tensor(sg.tip_globals, dtype=torch.long,
                                  device=packed.device)
            out.append(packed.index_select(0, idx))
        else:
            out.append(packed.new_zeros((1, c * s, sites)))
    return out


@dataclass(frozen=True)
class _Rows:
    """Row numbering of one segment's state and scaler space: state rows
    tips | imports | locals | trash, scaler rows imports | locals | the
    zero dummy | trash (the trash rows serve the dyn tier's padding)."""

    r_tip: int
    r_imp: int
    r_loc: int

    @property
    def loc0(self):
        return self.r_tip + self.r_imp

    @property
    def trash_state(self):
        return self.loc0 + self.r_loc

    @property
    def n_state(self):
        return self.trash_state + 1

    @property
    def dummy_scal(self):
        return self.r_imp + self.r_loc

    @property
    def trash_scal(self):
        return self.dummy_scal + 1

    @property
    def n_scal(self):
        return self.trash_scal + 1


def state_row(g: _Rows, src) -> int:
    """A ("tip" | "imp" | "loc", i) reference as a state row of ``g``."""
    kind, i = src[0], (src[1] if len(src) > 1 else 0)
    if kind == "tip":
        return i
    if kind == "imp":
        return g.r_tip + i
    return g.loc0 + i


def scaler_row(g: _Rows, src) -> int:
    """A ("zero",) | ("simp" | "sloc", i) reference as a scaler row."""
    if src[0] == "zero":
        return g.dummy_scal
    if src[0] == "simp":
        return src[1]
    return g.r_imp + src[1]


def segment_rows(s: Segment) -> _Rows:
    return _Rows(len(s.tip_globals), len(s.imports), s.n_local)


def segment_table(s: Segment, g: _Rows):
    """(table [n_local, 6], m_ops [n_local, 2]) int32 of one segment in the
    row numbering ``g``: (parent, child1, child2, scaler1, scaler2,
    has_scaler) and the two P-matrix ids of each op."""
    table = np.zeros((g.r_loc, TABLE_FIELDS), np.int32)
    m_ops = np.zeros((g.r_loc, 2), np.int32)
    for (lp, src1, m1, src2, m2, sr1, sr2, has) in s.ops:
        table[lp] = (g.loc0 + lp, state_row(g, src1), state_row(g, src2),
                     scaler_row(g, sr1), scaler_row(g, sr2), int(has))
        m_ops[lp] = (m1, m2)
    return table, m_ops


def locate(seg: SegmentedSchedule, lm: int, what: str):
    """Level-major CLV ``lm`` in the final segment's space, as ("tip" |
    "imp" | "loc", i) (``clv_pallas_seg.py:450-469``)."""
    last = len(seg.segments) - 1
    if lm < seg.tips:
        root_tips = seg.segments[last].tip_globals
        if lm not in root_tips:
            raise EinvalError(f"edge {what} tip not in root segment; build "
                              "with ensure_rows=[parent, child]")
        return ("tip", root_tips.index(lm))
    sseg, sloc = seg.loc_of[lm - seg.tips]
    if sseg == last:
        return ("loc", sloc)
    imports = seg.segments[last].imports
    if (sseg, sloc) not in imports:
        raise EinvalError(f"edge {what} not importable; build with "
                          "ensure_rows=[parent, child]")
    return ("imp", imports.index((sseg, sloc)))


def exp_pos_of(seg: SegmentedSchedule, si: int, local: int) -> int:
    """Position of segment ``si``'s local row among its exports
    (``clv_pallas_seg.py:639-641``)."""
    return sorted(set(seg.segments[si].export_locals)).index(local)


# --------------------------------------------------------------------------
# plain versions (shared with the dyn tier)
# --------------------------------------------------------------------------
def plain_segment(g: _Rows, table, m_ops, tip_rows, imp_clv, imp_scal,
                  tips_packed, tip_encoding, pmatrix, scale_mode):
    """Run one segment's op table over all sites with PyTorch ops.
    ``tip_rows`` index the tips in ``tips_packed``; ``imp_clv``
    [r_imp, C, S, L] and ``imp_scal`` [r_imp·srows, L] fill the import
    rows.  Ops whose parent is the trash row are skipped.  Returns (state
    [n_state, C, S, L], scalers [n_scal·srows, L])."""
    _, c, s, _ = pmatrix.shape
    dtype, device = pmatrix.dtype, pmatrix.device
    sites = tips_packed.shape[-1]
    srows = c if scale_mode == SCALE_PER_RATE else 1
    thresh, factor = scale_consts(dtype)
    state = pmatrix.new_zeros((g.n_state, c, s, sites))
    state[:g.r_tip] = cf.decode_tips(tips_packed, tip_encoding,
                                     tip_rows.long(), c, s, dtype)
    state[g.r_tip:g.loc0] = imp_clv
    scal = torch.zeros((g.n_scal * srows, sites), dtype=torch.int32,
                       device=device)
    scal[:g.r_imp * srows] = imp_scal
    for i, ((p, c1, c2, s1, s2, has), (m1, m2)) in enumerate(
            zip(table.tolist(), m_ops.tolist())):
        if p == g.trash_state:
            continue  # a pad op
        state[p], scal[(g.r_imp + i) * srows:(g.r_imp + i + 1) * srows] = (
            plain_op(pmatrix, m1, m2, state[c1], state[c2],
                     scal[s1 * srows:(s1 + 1) * srows]
                     + scal[s2 * srows:(s2 + 1) * srows], has, scale_mode,
                     thresh, factor))
    return state, scal


def plain_op(pmatrix, m1, m2, x1, x2, cnt, has, scale_mode, thresh, factor):
    """One op with PyTorch ops: the parent row (P[m1] x1) * (P[m2] x2)
    [C, S, L] and its counters ``cnt`` [srows, L] (the children's sum),
    both after the op's scaling test."""
    x = torch.matmul(pmatrix[m1], x1) * torch.matmul(pmatrix[m2], x2)
    if has and scale_mode == SCALE_PER_SITE:
        mask = (x < thresh).all(dim=1).all(dim=0)  # [L]
        x = torch.where(mask, x * factor, x)
        cnt = cnt + mask.to(torch.int32)
    elif has and scale_mode == SCALE_PER_RATE:
        mask = (x < thresh).all(dim=1)  # [C, L]
        x = torch.where(mask[:, None], x * factor, x)
        cnt = cnt + mask.to(torch.int32)
    return x, cnt


def plain_edge_partials(state, scal, edge, pmatrix, weight_vec,
                        pattern_weights, inv_add, scale_mode):
    """The edge log-likelihood of a segment's final state, as float64 sums
    per ``TILE_SITES`` sites (the kernels' partials).  ``edge``: (p_state,
    c_state, p_scal, c_scal, edge matrix)."""
    _, c, s, _ = pmatrix.shape
    dtype = pmatrix.dtype
    srows = c if scale_mode == SCALE_PER_RATE else 1
    ps, cs_, psc, csc, em = (int(v) for v in edge)
    termb = torch.matmul(pmatrix[em], state[cs_])
    y = state[ps] * termb * weight_vec.reshape(c, s, 1)
    snum = (scal[psc * srows:(psc + 1) * srows]
            + scal[csc * srows:(csc + 1) * srows])
    if scale_mode == SCALE_PER_RATE:
        term_r, site_scal = lk.fold_rate_scalers_inkernel(
            y.sum(dim=1), snum, scale_consts(dtype)[0])
        term = term_r.sum(dim=0)
    else:
        term, site_scal = y.sum(dim=(0, 1)), snum[0]
    if inv_add is not None:
        term = term + inv_add
    lnl = lk.site_lnl(term, site_scal, pattern_weights, dtype)
    sites = lnl.shape[0]
    blocks = -(-sites // TILE_SITES)
    padded = lnl.new_zeros(blocks * TILE_SITES, dtype=torch.float64)
    padded[:sites] = lnl
    return padded.view(blocks, TILE_SITES).sum(dim=1)


# --------------------------------------------------------------------------
# CUDA binding
# --------------------------------------------------------------------------
_WALK_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_int64]
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 11)
_ANY_WALK_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_int64]
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 12
                      + [ctypes.c_int64, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/clv_seg.cu``, once per
    process."""
    return bind(_build.load("clv_seg"))


@functools.lru_cache(maxsize=None)
def load_any_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/clv_seg_any.cu``, the
    any-alphabet instance, once per process."""
    return bind_any(_build.load("clv_seg_any"))


def bind_any(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from
    ``clv_seg_any.cu``."""
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"clv_seg_any_walk_{suffix}")
        fn.argtypes = _ANY_WALK_ARGTYPES
        fn.restype = ctypes.c_int
    lib.clv_seg_any_error_string.argtypes = [ctypes.c_int]
    lib.clv_seg_any_error_string.restype = ctypes.c_char_p
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``clv_seg.cu``."""
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"clv_seg_walk_{suffix}")
        fn.argtypes = _WALK_ARGTYPES
        fn.restype = ctypes.c_int
    lib.clv_seg_max_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.clv_seg_max_smem.restype = ctypes.c_int
    lib.clv_seg_blocks_per_sm.argtypes = [ctypes.c_int] * 4
    lib.clv_seg_blocks_per_sm.restype = ctypes.c_int
    lib.clv_seg_error_string.argtypes = [ctypes.c_int]
    lib.clv_seg_error_string.restype = ctypes.c_char_p
    return lib


def _query(got: int, what: str) -> int:
    if got < 0:
        msg = load_kernels().clv_seg_error_string(-got).decode()
        raise KernelError(f"clv_seg {what} query failed: {msg}")
    return got


def max_smem(states: int, dtype) -> int:
    """The largest dynamic shared memory one block of the kernel instance
    may ask for on the current card (bytes)."""
    return _query(load_kernels().clv_seg_max_smem(
        states, int(_itemsize(dtype) == 8)), "shared-memory")


def blocks_per_sm(states: int, dtype, rate_cats: int, smem: int) -> int:
    """How many blocks of the kernel instance an SM of the current card
    holds at once with ``smem`` bytes of dynamic shared memory."""
    return _query(load_kernels().clv_seg_blocks_per_sm(
        states, int(_itemsize(dtype) == 8), rate_cats, smem), "occupancy")


def _ptr(t: Optional[torch.Tensor], row: int = 0, row_elems: int = 0):
    """Address of ``row`` of ``t`` (rows of ``row_elems`` elements); None
    for no tensor."""
    if t is None:
        return None
    return t.data_ptr() + row * row_elems * t.element_size()


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"segment kernel input: {what}")


def check_pmatrix(pmatrix, rate_cats: int, states: int,
                  max_matrix: int) -> str:
    """What the segment kernels (K3-K6) take of the P-matrices
    [M, C, S, S]: float32 or float64, contiguous, 2 <= S <= 64 (S in
    {4, 20} at C in {1, 2, 4, 8} for the DNA and protein instances, any
    other (S, C) for the any-alphabet one), every matrix the schedule
    uses.  Returns the dtype suffix of the kernel's C entry points."""
    c, s = rate_cats, states
    _require(pmatrix.dtype in (torch.float32, torch.float64),
             f"pmatrix dtype {pmatrix.dtype} (float32 or float64)")
    _require(pmatrix.dim() == 4 and tuple(pmatrix.shape[1:]) == (c, s, s)
             and pmatrix.is_contiguous(),
             f"pmatrix {tuple(pmatrix.shape)} for C={c}, S={s}")
    _require(2 <= s <= ANY_MAX_STATES,
             f"states {s} (the kernels take 2 to {ANY_MAX_STATES})")
    _require(c >= 1, f"rate_cats {c}")
    _require(max_matrix < pmatrix.shape[0],
             f"schedule uses matrix {max_matrix} of {pmatrix.shape[0]}")
    return "f32" if pmatrix.dtype == torch.float32 else "f64"


def _offsets(counts) -> List[int]:
    out, acc = [], 0
    for n in counts:
        out.append(acc)
        acc += n
    return out


def _i32(rows, width: int = 1) -> torch.Tensor:
    """Rows (numbers, or arrays of ``width`` columns) as one int32 table."""
    a = np.asarray(rows, np.int32).reshape(-1, width)
    return torch.from_numpy(a if width > 1 else a.reshape(-1))


def _desc(kind: int, index: int) -> int:
    return (kind << INDEX_BITS) | int(index)


class _SegKernel:
    """What K3 and K4 share: the schedule and its per-segment tables
    (concatenated segment-major, segment ``si``'s ops at
    ``seg.seg_offsets[si]``) for the plain versions; the kernel's walk
    (:meth:`_plan_walk`: op and segment descriptors, pool slots); their
    per-device copies, the checks and the launch."""

    # launch once per segment, with the edge folded after the last (the
    # first kernel's launch pattern, kept to measure what one launch per
    # call saves); False: one launch per call
    split = False

    def __init__(self, seg, scale_mode, rate_cats, states, impl,
                 block_sites):
        if scale_mode not in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE):
            raise EinvalError(f"unsupported scale mode {scale_mode}")
        if impl not in ("auto", "vpu", "mxu"):
            raise EinvalError(f"unknown impl {impl!r}")
        if block_sites is not None and (not isinstance(block_sites, int)
                                        or block_sites < 1):
            raise EinvalError(f"block_sites {block_sites!r}")
        if seg.n_inner >= 1 << INDEX_BITS:
            raise EinvalError(f"{seg.n_inner} inner rows: the kernels name "
                              f"rows in {INDEX_BITS} bits")
        self.seg, self.scale_mode = seg, scale_mode
        self.rate_cats, self.states = rate_cats, states
        self.block_sites = block_sites
        self.srows = rate_cats if scale_mode == SCALE_PER_RATE else 1
        self.rows = [segment_rows(s) for s in seg.segments]
        self.tables = [segment_table(s, g) for s, g in zip(seg.segments,
                                                           self.rows)]
        self.max_matrix = max((int(m.max()) for _, m in self.tables
                               if m.size), default=0)
        self.imp_offsets = _offsets(g.r_imp for g in self.rows)
        self._host = {
            "table": _i32(np.concatenate([t for t, _ in self.tables]),
                          TABLE_FIELDS),
            "m_ops": _i32(np.concatenate([m for _, m in self.tables]), 2)}
        self._device = {}
        self._instance = {}  # dtype -> whether the any-alphabet instance
        self._slabs = {}      # slab list -> their addresses on the card

    def _plan_walk(self, imp_row, out_row, keep) -> None:
        """The kernel's walk: each segment's local rows get pool slots
        (:func:`segment_slots`; ``keep[si]``: the locals kept to the end),
        each op a descriptor [n_inner, OP_FIELDS] naming its sources
        (``imp_row(si, k)``: the device row of segment si's import k) and
        the device row it is written to (``out_row(si, l)``, -1 for none),
        each segment (op0, n_ops, n_tip, 0).  The pool is the largest
        segment's peak of live rows."""
        ops = np.zeros((self.seg.n_inner, OP_FIELDS), np.int32)
        segs = np.zeros((len(self.rows), SEG_FIELDS), np.int32)
        self.slots = []
        for si, (g, (table, m_ops)) in enumerate(zip(self.rows,
                                                     self.tables)):
            slots = segment_slots(table, g, sorted(keep.get(si, ())))
            self.slots.append(slots)
            off = self.seg.seg_offsets[si]
            segs[si] = (off, g.r_loc, g.r_tip, 0)
            for l, ((_, c1, c2, s1, s2, has), (m1, m2)) in enumerate(zip(
                    table.tolist(), m_ops.tolist())):
                ops[off + l] = (
                    l, _desc(K_POOL, slots[l]),
                    self._state_desc(si, c1, imp_row),
                    self._state_desc(si, c2, imp_row),
                    self._scal_desc(si, s1, imp_row),
                    self._scal_desc(si, s2, imp_row),
                    m1, m2, has, out_row(si, l), 0, 0)
        # (a final segment may have no ops: its edge reads imports)
        self.pool = max((int(s.max()) + 1 for s in self.slots if s.size),
                        default=1)
        self._host["ops"] = torch.from_numpy(ops)
        self._host["segs"] = torch.from_numpy(segs)

    def _state_desc(self, si, row, imp_row) -> int:
        """State row ``row`` of segment ``si`` as a descriptor."""
        g = self.rows[si]
        if row < g.r_tip:
            return _desc(K_TIP, row)
        if row < g.loc0:
            return _desc(K_IMP, imp_row(si, row - g.r_tip))
        return _desc(K_POOL, self.slots[si][row - g.loc0])

    def _scal_desc(self, si, srow, imp_row) -> int:
        """Scaler row ``srow`` of segment ``si`` as a descriptor."""
        g = self.rows[si]
        if srow < g.r_imp:
            return _desc(K_IMP, imp_row(si, srow))
        if srow < g.dummy_scal:
            return _desc(K_POOL, self.slots[si][srow - g.r_imp])
        return K_ZERO

    def static(self, name: str, device) -> torch.Tensor:
        """A static table of the schedule, copied to ``device`` once."""
        key = (name, device)
        if key not in self._device:
            self._device[key] = self._host[name].to(device)
        return self._device[key]

    def smem(self, dtype) -> int:
        """The kernel's dynamic shared memory per block at ``dtype``."""
        return kernel_smem(self.pool, self.rate_cats, self.states, dtype,
                           self.srows)

    def instance(self, dtype) -> bool:
        """Whether the call at ``dtype`` takes the any-alphabet instance:
        (S, C) outside the DNA and protein instances', or a pool whose
        layout (:func:`kernel_smem`) does not fit their block's
        ``SMEM_LIMIT``.  Raises where no instance takes S."""
        if dtype not in self._instance:
            if not 2 <= self.states <= ANY_MAX_STATES:
                raise EinvalError(f"states {self.states}: the kernels take "
                                  f"2 to {ANY_MAX_STATES}")
            self._instance[dtype] = (
                any_instance(self.states, self.rate_cats)
                or self.smem(dtype) > SMEM_LIMIT)
        return self._instance[dtype]

    def any_shared(self, dtype) -> int:
        """The any-alphabet instance's pool slots in shared memory."""
        return any_shared_slots(self.pool, self.rate_cats, self.states,
                                dtype, self.srows)

    def check_sites(self, sites: int) -> None:
        """JAX's guard: the sites divide into ``block_sites`` blocks."""
        if self.block_sites is not None and sites % self.block_sites:
            raise EinvalError(f"sites ({sites}) must be divisible by "
                              f"{self.block_sites}")

    def check(self, tip_slabs, pmatrix, vectors=()):
        """Validate what the launch takes; return (dtype suffix, the slabs'
        addresses on the card)."""
        device = pmatrix.device
        if device.type != "cuda":
            raise EinvalError(f"segmented kernels run on CUDA tensors, not "
                              f"{device}")
        suffix = check_pmatrix(pmatrix, self.rate_cats, self.states,
                               self.max_matrix)
        self.instance(pmatrix.dtype)
        _require(pmatrix.data_ptr() % 16 == 0,
                 "pmatrix is not 16-byte aligned (its rows load as vectors)")
        for name, t, shape in vectors:
            _require(t.device == device and t.dtype == pmatrix.dtype
                     and tuple(t.shape) == shape and t.is_contiguous(),
                     f"{name} {tuple(t.shape)} {t.dtype} on {t.device}")
        return suffix, self._slab_table(tip_slabs, pmatrix)

    def _slab_table(self, tip_slabs, pmatrix):
        """The slabs' addresses on the card (int64), checked the first
        time this list of slabs (each one's data pointer, shape, strides
        and dtype) is seen at this dtype and card, then cached: a call's
        host work does not grow with the segment count, and a slab that
        reuses a freed address with another shape or layout is checked
        anew."""
        _require(len(tip_slabs) == len(self.rows),
                 f"{len(tip_slabs)} tip slabs for {len(self.rows)} segments")
        sites = tip_slabs[0].shape[-1]
        key = (pmatrix.dtype, pmatrix.device,
               tuple(map(torch.Tensor.data_ptr, tip_slabs)),
               tuple(map(torch.Tensor.size, tip_slabs)),
               tuple(map(torch.Tensor.stride, tip_slabs)),
               tuple(s.dtype for s in tip_slabs))
        hit = self._slabs.get(key)
        if hit is not None:
            return hit
        cs = self.rate_cats * self.states
        _require(sites > 0, "no sites")
        for si, (slab, g) in enumerate(zip(tip_slabs, self.rows)):
            _require(slab.device == pmatrix.device
                     and slab.dtype == pmatrix.dtype
                     and tuple(slab.shape) == (max(g.r_tip, 1), cs, sites)
                     and slab.is_contiguous(),
                     f"tip slab {si}: {tuple(slab.shape)} {slab.dtype} on "
                     f"{slab.device}, want [{max(g.r_tip, 1)}, {cs}, "
                     f"{sites}] {pmatrix.dtype}")
        if len(self._slabs) >= 8:
            self._slabs.clear()
        hit = self._slabs[key] = torch.tensor(
            [slab.data_ptr() for slab in tip_slabs],
            dtype=torch.int64).to(pmatrix.device)
        return hit

    def launch(self, suffix, pmatrix, sites, ptrs, rows, rows_scal, *,
               edge=None, weight_vec=None, pattern_weights=None,
               partials=None) -> None:
        """The walk on the current stream of the tensors' card: one launch
        over every segment (``split``: one per segment), the edge folded
        after the last segment when ``edge`` is given; ``ptrs``: the
        slabs' addresses on the card.  The any-alphabet instance
        (:meth:`instance`) takes the P-matrices padded to 16-byte rows and
        its spill rows, made here."""
        device = pmatrix.device
        any_ = self.instance(pmatrix.dtype)
        n = len(self.rows)
        ranges = [(i, i + 1) for i in range(n)] if self.split else [(0, n)]
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            if any_:
                lib = load_any_kernels()
                fn = getattr(lib, f"clv_seg_any_walk_{suffix}")
                padded = cf.pad_rows(pmatrix)
                shared = self.any_shared(pmatrix.dtype)
                spilled = self.pool - shared
                cs = self.rate_cats * self.states
                spill = (torch.empty((spilled, cs, sites), dtype=pmatrix.dtype,
                                     device=device) if spilled else None)
                spill_scal = (torch.empty((spilled, self.srows, sites),
                                          dtype=torch.int32, device=device)
                              if spilled else None)
                error = lib.clv_seg_any_error_string
            else:
                lib = load_kernels()
                fn = getattr(lib, f"clv_seg_walk_{suffix}")
                error = lib.clv_seg_error_string
            for seg0, seg1 in ranges:
                common = (_ptr(self.static("segs", device)), _ptr(ptrs),
                          _ptr(self.static("ops", device)))
                tail = (_ptr(edge) if seg1 == n else None, _ptr(weight_vec),
                        _ptr(pattern_weights), _ptr(partials))
                if any_:
                    rc = fn(self.states, padded.shape[-1], self.rate_cats,
                            self.scale_mode, sites, seg0, seg1, self.pool,
                            shared, *common, _ptr(padded), _ptr(rows),
                            _ptr(rows_scal), _ptr(spill), _ptr(spill_scal),
                            *tail, 0 if partials is None
                            else partials.numel(), stream)
                else:
                    rc = fn(self.states, self.rate_cats, self.scale_mode,
                            sites, seg0, seg1, self.pool, *common,
                            _ptr(pmatrix), _ptr(rows), _ptr(rows_scal),
                            *tail, stream)
                if rc != 0:
                    msg = error(rc).decode()
                    raise KernelError(f"segments {seg0}-{seg1 - 1} launch "
                                      f"failed: CUDA error {rc} ({msg})")
                type(self).launches += 1
                type(self).any_launches += any_

    def run_plain(self, si, slab, pmatrix, imp_clv, imp_scal):
        """Segment ``si`` with PyTorch ops: (state, scalers)."""
        g, off = self.rows[si], self.seg.seg_offsets[si]
        tips = slab.view(slab.shape[0], self.rate_cats, self.states, -1)
        return plain_segment(
            g, self._host["table"][off:off + g.r_loc],
            self._host["m_ops"][off:off + g.r_loc],
            torch.arange(g.r_tip, device=pmatrix.device), imp_clv, imp_scal,
            tips, "clv", pmatrix, self.scale_mode)

    def _walk(self, tip_slabs, pmatrix, rows, rows_scal):
        """Every segment in order as the kernel walks it, with PyTorch ops
        over all sites: each op by its descriptor, its children and
        counters from the segment's tips, ``rows``/``rows_scal`` (imports)
        or the pool, its parent stored in its slot and, where it has one,
        in its row of ``rows``/``rows_scal``.  Returns the last segment's
        (row, count): a descriptor's values and counters, for the edge."""
        c, s, srows = self.rate_cats, self.states, self.srows
        sites = tip_slabs[0].shape[-1]
        thresh, factor = scale_consts(pmatrix.dtype)
        pool = pmatrix.new_zeros((self.pool, c, s, sites))
        pool_scal = torch.zeros((self.pool, srows, sites), dtype=torch.int32,
                                device=pmatrix.device)
        zero = pool_scal.new_zeros((srows, sites))
        out = rows.view(-1, c, s, sites)
        out_scal = rows_scal.view(-1, srows, sites)
        index = (1 << INDEX_BITS) - 1
        ops = self._host["ops"].tolist()

        def sources(tips):
            def row(d):
                kind = d >> INDEX_BITS
                return (tips if kind == K_TIP else out if kind == K_IMP
                        else pool)[d & index]

            def count(d):
                if d == K_ZERO:
                    return zero
                return (out_scal if d >> INDEX_BITS == K_IMP
                        else pool_scal)[d & index]
            return row, count

        for si, (op0, n_ops, _, _) in enumerate(
                self._host["segs"].tolist()):
            row, count = sources(tip_slabs[si].view(-1, c, s, sites))
            for (_, home, c1, c2, s1, s2, m1, m2, has, dst,
                 *_) in ops[op0:op0 + n_ops]:
                x, cnt = plain_op(pmatrix, m1, m2, row(c1), row(c2),
                                  count(s1) + count(s2), has,
                                  self.scale_mode, thresh, factor)
                pool[home & index], pool_scal[home & index] = x, cnt
                if dst >= 0:
                    out[dst], out_scal[dst] = x, cnt
        return row, count


class SegmentedSweep(_SegKernel):
    """K3: ``sweep(tip_slabs, pmatrix) -> (inner [n_inner, C, S, L],
    scalers)``, inner rows segment-major (``seg.inner_row`` translates
    level-major ids); scalers [n_inner + 1, L], or [n_inner + 1, C, L] per
    rate, the last row the zero dummy.  ``tip_slabs`` from
    :func:`pack_tips_segmented`."""

    launches = 0
    any_launches = 0  # those of the any-alphabet instance

    def __init__(self, seg, scale_mode, rate_cats, states, impl,
                 block_sites):
        super().__init__(seg, scale_mode, rate_cats, states, impl,
                         block_sites)
        offs = seg.seg_offsets
        self._host["imp_rows"] = _i32(
            [offs[a] + b for s in seg.segments for (a, b) in s.imports])

        def imp_row(si, k):
            a, b = seg.segments[si].imports[k]
            return offs[a] + b
        # every row goes out to its inner row as its op makes it: nothing
        # is kept in the pool past its last reader
        self._plan_walk(imp_row, lambda si, l: offs[si] + l, {})

    def _outputs(self, pmatrix, sites, fill):
        n_inner, c, s = self.seg.n_inner, self.rate_cats, self.states
        inner = fill((n_inner, c, s, sites), dtype=pmatrix.dtype,
                     device=pmatrix.device)
        scalers = fill(((n_inner + 1) * self.srows, sites),
                       dtype=torch.int32, device=pmatrix.device)
        scalers[n_inner * self.srows:] = 0  # the dummy row
        return inner, scalers

    def _shaped(self, inner, scalers):
        if self.scale_mode == SCALE_PER_RATE:
            scalers = scalers.view(self.seg.n_inner + 1, self.rate_cats, -1)
        return inner, scalers

    def plain(self, tip_slabs, pmatrix):
        """Plain version of K3: segment by segment with PyTorch ops,
        imports read from the inner rows written so far."""
        srows, sites = self.srows, tip_slabs[0].shape[-1]
        inner, scalers = self._outputs(pmatrix, sites, torch.zeros)
        node_scal = scalers.view(-1, srows, sites)
        rows = self._host["imp_rows"].long().to(pmatrix.device)
        for si, g in enumerate(self.rows):
            imp = rows[self.imp_offsets[si]:self.imp_offsets[si] + g.r_imp]
            state, scal = self.run_plain(
                si, tip_slabs[si], pmatrix, inner[imp],
                node_scal[imp].reshape(-1, sites))
            off, n = self.seg.seg_offsets[si], g.r_loc
            inner[off:off + n] = state[g.loc0:g.loc0 + n]
            scalers[off * srows:(off + n) * srows] = (
                scal[g.r_imp * srows:(g.r_imp + n) * srows])
        return self._shaped(inner, scalers)

    def plain_walk(self, tip_slabs, pmatrix):
        """K3 as the kernel walks it (:meth:`_walk`) with PyTorch ops: the
        values of :meth:`plain`, bit for bit."""
        inner, scalers = self._outputs(pmatrix, tip_slabs[0].shape[-1],
                                       torch.zeros)
        self._walk(tip_slabs, pmatrix, inner, scalers)
        return self._shaped(inner, scalers)

    def __call__(self, tip_slabs, pmatrix):
        sites = tip_slabs[0].shape[-1]
        self.check_sites(sites)
        if pmatrix.device.type == "cpu":
            return self.plain(tip_slabs, pmatrix)
        suffix, ptrs = self.check(tip_slabs, pmatrix)
        inner, scalers = self._outputs(pmatrix, sites, torch.empty)
        self.launch(suffix, pmatrix, sites, ptrs, inner, scalers)
        return self._shaped(inner, scalers)


def make_segmented_sweep(seg: SegmentedSchedule,
                         scale_mode: int = SCALE_PER_SITE, *,
                         impl: str = "auto", rate_cats: int, states: int,
                         block_sites: Optional[int] = None
                         ) -> SegmentedSweep:
    """Build K3 (``clv_pallas_seg.py:327``); see :class:`SegmentedSweep`."""
    return SegmentedSweep(seg, scale_mode, rate_cats, states, impl,
                          block_sites)


class SegmentedScore(_SegKernel):
    """K4: ``score(tip_slabs, pmatrix, weight_vec, pattern_weights) ->
    logl`` (float64).  Rows later segments import
    (``sorted(set(export_locals))``) go out to the exports as their ops
    make them; every other row stays on chip.  After the last segment the
    edge log-likelihood is folded, one float64 partial per ``SLOT_SITES``
    sites, four of them summed into each ``TILE_SITES`` partial and those
    summed here in float64.  ``weight_vec``: ``clv_fused.pack_weight_vec``
    [C·S]; ``pattern_weights`` [L]."""

    launches = 0
    any_launches = 0

    def __init__(self, seg, parent_lm, child_lm, edge_matrix, scale_mode,
                 rate_cats, states, impl, block_sites):
        super().__init__(seg, scale_mode, rate_cats, states, impl,
                         block_sites)
        if parent_lm < seg.tips:
            raise EinvalError("edge parent must be an inner node")
        last = len(self.rows) - 1
        g = self.rows[last]
        ends = [locate(seg, parent_lm, "parent"),
                locate(seg, child_lm, "child")]
        scal = [g.dummy_scal if kind == "tip" else
                scaler_row(g, ("simp" if kind == "imp" else "sloc", i))
                for kind, i in ends]
        self.edge = [state_row(g, ends[0]), state_row(g, ends[1]), *scal,
                     edge_matrix]
        self.max_matrix = max(self.max_matrix, edge_matrix)
        self.exports = [sorted(set(s.export_locals)) if si < last else []
                        for si, s in enumerate(seg.segments)]
        self.exp_offsets = _offsets(len(e) for e in self.exports)
        self.n_exports = sum(len(e) for e in self.exports)
        self._host["imp_rows"] = _i32(
            [self.exp_offsets[a] + exp_pos_of(seg, a, b)
             for s in seg.segments for (a, b) in s.imports])
        self._host["out_rows"] = _i32([l for e in self.exports for l in e])
        self._host["edge"] = _i32(self.edge)

        pos = [{l: e for e, l in enumerate(ex)} for ex in self.exports]

        def imp_row(si, k):
            a, b = seg.segments[si].imports[k]
            return self.exp_offsets[a] + pos[a][b]

        def out_row(si, l):
            e = pos[si].get(l)
            return -1 if e is None else self.exp_offsets[si] + e
        # the edge's local rows stay in the pool to the end
        self._plan_walk(imp_row, out_row, {last: [
            r - g.loc0 for r in self.edge[:2] if r >= g.loc0]})
        self._host["edge_desc"] = _i32([
            self._state_desc(last, self.edge[0], imp_row),
            self._state_desc(last, self.edge[1], imp_row),
            self._scal_desc(last, self.edge[2], imp_row),
            self._scal_desc(last, self.edge[3], imp_row), edge_matrix])

    def plain(self, tip_slabs, pmatrix, weight_vec, pattern_weights):
        """Plain version of K4: segment by segment with PyTorch ops,
        exports copied out and imported by position."""
        c, s, srows = self.rate_cats, self.states, self.srows
        sites = tip_slabs[0].shape[-1]
        exports = pmatrix.new_zeros((self.n_exports, c, s, sites))
        exp_scal = torch.zeros((self.n_exports, srows, sites),
                               dtype=torch.int32, device=pmatrix.device)
        rows = self._host["imp_rows"].long().to(pmatrix.device)
        for si, g in enumerate(self.rows):
            imp = rows[self.imp_offsets[si]:self.imp_offsets[si] + g.r_imp]
            state, scal = self.run_plain(
                si, tip_slabs[si], pmatrix, exports[imp],
                exp_scal[imp].reshape(-1, sites))
            for e, l in enumerate(self.exports[si]):
                exports[self.exp_offsets[si] + e] = state[g.loc0 + l]
                exp_scal[self.exp_offsets[si] + e] = scal[
                    (g.r_imp + l) * srows:(g.r_imp + l + 1) * srows]
        return cf.sum_block_partials(plain_edge_partials(
            state, scal, self.edge, pmatrix, weight_vec, pattern_weights,
            None, self.scale_mode))

    def plain_walk(self, tip_slabs, pmatrix, weight_vec, pattern_weights):
        """K4 as the kernel walks it (:meth:`_walk`, the edge from its
        descriptors) with PyTorch ops: the logL of :meth:`plain`, bit for
        bit."""
        c, s, srows = self.rate_cats, self.states, self.srows
        sites = tip_slabs[0].shape[-1]
        n_exp = max(self.n_exports, 1)
        exports = pmatrix.new_zeros((n_exp, c, s, sites))
        exp_scal = torch.zeros((n_exp * srows, sites), dtype=torch.int32,
                               device=pmatrix.device)
        row, count = self._walk(tip_slabs, pmatrix, exports, exp_scal)
        p, ch, ps, cs_, em = self._host["edge_desc"].tolist()
        return cf.sum_block_partials(plain_edge_partials(
            torch.stack([row(p), row(ch)]),
            torch.cat([count(ps), count(cs_)]), (0, 1, 0, 1, em), pmatrix,
            weight_vec, pattern_weights, None, self.scale_mode))

    def __call__(self, tip_slabs, pmatrix, weight_vec, pattern_weights):
        sites = tip_slabs[0].shape[-1]
        self.check_sites(sites)
        if pmatrix.device.type == "cpu":
            return self.plain(tip_slabs, pmatrix, weight_vec,
                              pattern_weights)
        cs, srows = self.rate_cats * self.states, self.srows
        suffix, ptrs = self.check(tip_slabs, pmatrix, [
            ("weight_vec", weight_vec, (cs,)),
            ("pattern_weights", pattern_weights, (sites,))])
        device, dtype = pmatrix.device, pmatrix.dtype
        n_exp = max(self.n_exports, 1)
        exports = torch.empty((n_exp, cs, sites), dtype=dtype, device=device)
        exp_scal = torch.empty((n_exp * srows, sites), dtype=torch.int32,
                               device=device)
        # one partial per SLOT_SITES sites, zero past the last tile
        tiles = torch.zeros(
            (-(-sites // TILE_SITES) * (TILE_SITES // SLOT_SITES),),
            dtype=torch.float64, device=device)
        self.launch(suffix, pmatrix, sites, ptrs, exports, exp_scal,
                    edge=self.static("edge_desc", device),
                    weight_vec=weight_vec, pattern_weights=pattern_weights,
                    partials=tiles)
        return cf.sum_block_partials(fold_tile_partials(tiles, sites))


def make_segmented_score(seg: SegmentedSchedule, parent_lm: int,
                         child_lm: int, edge_matrix: int,
                         scale_mode: int = SCALE_PER_SITE, *,
                         impl: str = "auto", rate_cats: int, states: int,
                         block_sites: Optional[int] = None
                         ) -> SegmentedScore:
    """Build K4 (``clv_pallas_seg.py:425``); see :class:`SegmentedScore`.
    ``parent_lm``/``child_lm`` are level-major CLV ids of the evaluation
    edge, which must reach the final segment (``ensure_rows``)."""
    return SegmentedScore(seg, parent_lm, child_lm, edge_matrix, scale_mode,
                          rate_cats, states, impl, block_sites)
