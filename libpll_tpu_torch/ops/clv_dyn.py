"""Schedule-as-data segment sweep (K5) and segment score (K6): the host
schedules and tip packers, the plain PyTorch versions, and the CUDA
wrappers.

Counterpart: ``libpll_tpu/ops/clv_pallas_dyn.py``.  K5 replaces
``make_dyn_sweep`` (``:383``, ``pallas_call`` at ``:521``); K6 replaces
``make_dyn_score`` (``:695``; leaf segments at ``:928``, the root segment at
``:990``).  Both kernels are ``csrc/clv_dyn.cu`` (DNA and protein, S in
{4, 20} at C in {1, 2, 4, 8}) and ``csrc/clv_dyn_any.cu`` (every other
2 <= S <= 64 and any C, a warp a rate of 32 sites); those files say how
they are laid out on the card and what bounds them.

The host part is the JAX package's, table for table: a tree is cut into
segments of at most ``max_rows`` rows (``ops/clv_seg.py``), and every
segment is padded to one shape, ``r_tip`` tip rows, ``r_imp`` import rows
and ``r_loc`` local rows, so that all segments run one kernel with other
tables.  A segment's state rows are numbered ``[0, r_tip)`` tips, then its
imports, then its locals, then one trash row; its scaler rows are the
imports' counters, the locals', one always-zero dummy and one trash row.
Table rows are (parent, child1, child2, scaler1, scaler2, has_scaler) in
those numbers; pad rows read and write the trash rows and never scale.

What differs from the TPU tier, and why:

  * **Rows on chip.**  A TPU segment lived in 10 MB of VMEM.  Here a
    segment's live rows live in a shared-memory pool of each thread
    block: :func:`dyn_slot_plan` gives every local row a slot on the host
    (first fit in op order; a row lives from its op to its last reader,
    exports and the edge's rows to the end), and a block holds each
    segment's peak number of slots up to :func:`pool_cap` (two blocks per
    SM; the any-alphabet instance's :func:`any_pool_cap`, which may be
    0).  A row whose slot is past the pool spills to device memory: K6
    keeps it in a scratch allocated only then, K5 in its own output row.
    The plan is data beside the op table (:func:`dyn_swap_args` carries
    it).  The segment cut's ``max_rows`` is unchanged: :func:`dyn_max_rows`
    sizes it from ``SCRATCH_BUDGET`` as the first port did, so schedules
    stay the JAX package's.  ``chunk`` (the TPU's ops per grid step) only
    rounds ``r_loc`` up here; it defaults to 1.
  * **Tips.**  The kernels read the one packed tip array of the whole
    tree (``clv_fused.pack_tipchars`` nibbles, int32 masks or tip CLVs) by
    global tip id, through each segment's ``tip_globals``
    (:func:`dyn_tip_globals`).  The per-segment slab packers
    (:func:`pack_tipchars_dyn` and its siblings) give the JAX package's
    slabs, for the segmented tier and for comparison.
  * **Imports.**  A segment reads its imports where they lie: K5 from the
    inner rows it has written, K6 from the export rows of earlier
    segments, by an index per import slot.  Nothing is gathered into a
    per-segment copy.
  * ``impl`` ("vpu"/"mxu") is accepted for signature parity: the port has
    one contraction.  ``mxu_precision`` "high" (JAX's bf16x3) is
    computed at "highest", full precision; any other value raises.  The
    score's partial sums are per ``BLOCK_SITES`` sites; the kernel's per
    ``SLOT_SITES`` are folded into them in order
    (:func:`clv_seg.fold_tile_partials`).

Each wrapper takes its plain version for a tensor on the CPU, and only
there: on a CUDA tensor it launches its kernel, once per segment, or
raises.  Each counts its launches in its class's ``launches``, and those
of the any-alphabet instance also in ``any_launches``.  Beside
the plain versions, ``plain_slotted`` runs the same tables through the
kernels' pool and spill addressing (:func:`plain_slotted_segment`), so the
slot plan is tested where no kernel runs.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..errors import EinvalError, KernelError
from ..utils.constants import (SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE,
                               scale_consts)
from . import _build
from . import clv_fused as cf
from .any_block import (ANY_RING_UNITS, ANY_SITES, ANY_STATIC_SMEM,
                        any_bound, any_pool_budget, any_pt, any_warps)
from .clv_seg import (SLOT_SITES, STAGE_OPS, TABLE_FIELDS, Segment,
                      _itemsize, _ptr, _Rows, any_instance,
                      build_segmented_schedule, check_pmatrix,
                      fold_tile_partials, plain_edge_partials, plain_op,
                      plain_segment, pool_bytes, segment_slots,
                      segment_table, stage_bytes)
from .sweep import LevelSchedule

BLOCK_SITES = cf.BLOCK_SITES  # sites per partial sum of the score
# JAX's MXU precisions the port takes; both run in full precision
MXU_PRECISIONS = ("highest", "high")
# shared memory of one block of csrc/clv_dyn.cu: its static part (a chunk of
# STAGE_OPS staged op descriptors and their tip codes, the per-site votes)
# and, for DNA, the chunk's P-matrices (stage_bytes); the pool takes at most
# the rest of a block's 227 KB (POOL_LIMIT), and by default what leaves two
# blocks per SM (POOL_BUDGET: half an SM's 228 KB less the 1 KB the card
# reserves per block)
STATIC_SMEM = 5120
POOL_LIMIT = 232448 - STATIC_SMEM
POOL_BUDGET = 233472 // 2 - 1024 - STATIC_SMEM
# the segment cut's row budget, kept from the first port (which held a
# segment's locals in a device scratch): 16 GiB holds 204 rows of 4 rates x
# 4 states at 2**20 sites in float32 (64 MiB of CLV and 16 MiB of per-rate
# counters each), and every row of smaller problems
SCRATCH_BUDGET = 16 << 30
# "masks" tips in the dyn tier: JAX's 31-bit guard (clv_pallas_dyn.py:235)
DYN_MASK_MAX_STATES = 31


@dataclass(frozen=True)
class DynSegment:
    table: np.ndarray        # [r_loc, 6] int32
    m_ops: np.ndarray        # [r_loc, 2] int32 matrix ids (op order)
    tip_globals: np.ndarray  # [n_tips_used] int64 global tip ids
    imports: Tuple[Tuple[int, int], ...]  # (segment, local) refs
    n_local: int             # real (unpadded) local count


@dataclass(frozen=True)
class DynSchedule:
    segments: Tuple[DynSegment, ...]
    tips: int
    n_inner: int
    r_tip: int
    r_imp: int
    r_loc: int
    n_chunks: int
    chunk: int
    seg_offsets: Tuple[int, ...]  # segment-major inner row offsets
    loc_of: dict    # level-major inner row -> (segment, local)
    min_r_exp: int = 0  # export-table row floor (table-swap envelopes)

    def inner_row(self, level_major_inner_row: int) -> int:
        s, l = self.loc_of[level_major_inner_row]
        return self.seg_offsets[s] + l

    scaler_row = inner_row


def _rows(dyn: DynSchedule) -> _Rows:
    return _Rows(dyn.r_tip, dyn.r_imp, dyn.r_loc)


def dyn_max_rows(rate_cats: int, states: int, sites: int) -> int:
    """Segment row budget on the GPU: as many local rows (a float32 CLV
    row of ``rate_cats·states·sites`` values and, at most, one int32
    counter per rate and site) as fit ``SCRATCH_BUDGET`` bytes; at least
    16.  A float64 call holds twice the budget."""
    per_row = sites * 4 * (rate_cats * states + rate_cats)
    return int(max(16, SCRATCH_BUDGET // max(per_row, 1)))


def build_dyn_schedule(schedule: LevelSchedule, *, rate_cats: int,
                       states: int, max_rows: Optional[int] = None,
                       chunk: Optional[int] = None,
                       ensure_rows: Sequence[int] = (),
                       min_r_tip: int = 0, min_r_imp: int = 0,
                       min_r_loc: int = 0, min_segments: int = 0,
                       min_r_exp: int = 0,
                       sites: Optional[int] = None) -> DynSchedule:
    """Segment ``schedule`` and pad every segment to one shape
    (``clv_pallas_dyn.py:99``).

    ``max_rows`` defaults to :func:`dyn_max_rows` at ``sites``.  The
    ``min_*`` floors pin the padded shape across topologies, so that one
    kernel instance scores another tree by a swap of its tables
    (:func:`dyn_swap_args`); ``min_segments`` adds inert all-trash segments
    just before the final (root) segment."""
    if chunk is None:
        chunk = 1
    if max_rows is None:
        if sites is None:
            raise EinvalError("build_dyn_schedule needs max_rows or sites")
        max_rows = dyn_max_rows(rate_cats, states, sites)
    seg = build_segmented_schedule(schedule, max_rows=max_rows,
                                   ensure_rows=ensure_rows)
    tips, n_inner = seg.tips, seg.n_inner
    r_tip = max(max(len(s.tip_globals) for s in seg.segments), 1, min_r_tip)
    r_imp = max(max(len(s.imports) for s in seg.segments), 1, min_r_imp)
    r_loc_real = max(max(s.n_local for s in seg.segments), min_r_loc)
    n_chunks = -(-r_loc_real // chunk)
    g = _Rows(r_tip, r_imp, n_chunks * chunk)

    def padded_table(s):
        # pad rows read and write the trash rows and never scale
        table, m_ops = segment_table(s, g)
        table[s.n_local:, 0:3] = g.trash_state
        table[s.n_local:, 3:5] = g.trash_scal
        return table, m_ops

    dsegs: List[DynSegment] = []
    offsets: List[int] = []
    acc = 0
    for s in seg.segments:
        table, m_ops = padded_table(s)
        dsegs.append(DynSegment(table, m_ops,
                                np.asarray(s.tip_globals, np.int64),
                                tuple(s.imports), s.n_local))
        offsets.append(acc)
        acc += s.n_local
    assert acc == n_inner

    loc_of = dict(seg.loc_of)
    n_pad_segs = min_segments - len(dsegs)
    if n_pad_segs > 0:
        # inert segments go just before the final segment: only its index
        # shifts, and imports always reference earlier segments
        old_last = len(dsegs) - 1
        pads = [DynSegment(*padded_table(Segment()), np.zeros(0, np.int64),
                           (), 0)
                for _ in range(n_pad_segs)]
        dsegs[old_last:old_last] = pads
        offsets[old_last:old_last] = [offsets[old_last]] * n_pad_segs
        loc_of = {k: ((old_last + n_pad_segs, l) if s == old_last
                      else (s, l))
                  for k, (s, l) in loc_of.items()}

    return DynSchedule(tuple(dsegs), tips, n_inner, r_tip, r_imp, g.r_loc,
                       n_chunks, chunk, tuple(offsets), loc_of, min_r_exp)


# --------------------------------------------------------------------------
# tip packing
# --------------------------------------------------------------------------
def _tip_slabs(rows: np.ndarray, dyn: DynSchedule, height: int):
    """Per-segment copies of ``rows[tip_globals]``, zero-padded to
    ``height`` rows."""
    out = []
    for s in dyn.segments:
        slab = np.zeros((height,) + rows.shape[1:], rows.dtype)
        slab[:len(s.tip_globals)] = rows[s.tip_globals]
        out.append(slab)
    return out


def pack_tips_dyn(tips_clv, dyn: DynSchedule) -> List[torch.Tensor]:
    """Per-segment tip CLV slabs [r_tip, C*S, L], rows rate-major (the JAX
    package's ``impl="mxu"`` packing, ``clv_pallas_dyn.py:203``)."""
    clv = np.asarray(tips_clv)
    packed = clv.reshape(clv.shape[0], -1, clv.shape[-1])
    return [torch.from_numpy(s) for s in _tip_slabs(packed, dyn, dyn.r_tip)]


def pack_tipmasks_dyn(tip_masks, dyn: DynSchedule) -> List[torch.Tensor]:
    """Per-segment slabs of one int32 ambiguity bitmask per tip and site
    [r_tip, L] (``clv_pallas_dyn.py:224``): the wide-alphabet pattern tips
    (protein masks are 20 bits)."""
    masks = np.asarray(tip_masks, dtype=np.uint32)
    if masks.max() > 0x7FFFFFFF:
        raise EinvalError("tip masks must fit 31 bits (states <= 31)")
    return [torch.from_numpy(s.astype(np.int32))
            for s in _tip_slabs(masks, dyn, dyn.r_tip)]


def pack_tipchars_dyn(tip_masks, dyn: DynSchedule) -> List[torch.Tensor]:
    """Per-segment slabs of nibble-packed 4-bit codes [ceil(r_tip/8), L]
    (``clv_pallas_dyn.py:246``, the layout of ``clv_fused.pack_tipchars``
    over each segment's tips)."""
    masks = np.asarray(tip_masks, dtype=np.uint32)
    if masks.max() > 0xF:
        raise EinvalError("tipchars mode supports 4-bit codes (states<=4)")
    words = -(-dyn.r_tip // 8)
    return [cf.pack_tipchars(s) for s in _tip_slabs(masks, dyn, words * 8)]


def dyn_tip_globals(dyn: DynSchedule) -> torch.Tensor:
    """[n_segments, r_tip] int32: the global tip id of each segment's tip
    row (padding rows read tip 0 and are never referenced)."""
    out = np.zeros((len(dyn.segments), dyn.r_tip), np.int32)
    for si, s in enumerate(dyn.segments):
        out[si, :len(s.tip_globals)] = s.tip_globals
    return torch.from_numpy(out)


# --------------------------------------------------------------------------
# tables as data
# --------------------------------------------------------------------------
def dyn_runtime_args(dyn: DynSchedule):
    """(tables, m_gathers): the per-segment op tables the kernels read."""
    return ([torch.from_numpy(s.table) for s in dyn.segments],
            [torch.from_numpy(s.m_ops) for s in dyn.segments])


def _export_tables(dyn: DynSchedule):
    """Per-segment export tables [r_exp, 2] (state row, scaler row), padded
    with trash reads; the (segment, local) -> export position map; r_exp."""
    g = _rows(dyn)
    referenced = {}
    for s in dyn.segments:
        for (a, b) in s.imports:
            referenced.setdefault(a, set()).add(b)
    r_exp = max(max((len(v) for v in referenced.values()), default=0), 1,
                dyn.min_r_exp)
    tables, pos_of = [], {}
    for si in range(len(dyn.segments)):
        tab = np.full((r_exp, 2), g.trash_state, np.int32)
        tab[:, 1] = g.trash_scal
        for i, l in enumerate(sorted(referenced.get(si, set()))):
            tab[i] = (g.loc0 + l, dyn.r_imp + l)
            pos_of[(si, l)] = i
        tables.append(tab)
    return tables, pos_of, r_exp


def dyn_score_args(dyn: DynSchedule):
    """(tables, m_gathers, exp_tables) for make_dyn_score."""
    tables, m_gathers = dyn_runtime_args(dyn)
    return (tables, m_gathers,
            [torch.from_numpy(x) for x in _export_tables(dyn)[0]])


def dyn_swap_args(dyn: DynSchedule):
    """(tables, m_gathers, exp_tables, imp_src, slot_plan) for swapping
    another topology's tables into a built make_dyn_score: ``imp_src``
    [n_segments, r_imp, 2] int32 holds each import slot's (source segment,
    export position), ``slot_plan`` the schedule's :func:`dyn_slot_plan`
    for a ``dynamic_edge`` score.  Both topologies need matching envelope
    floors, and the evaluation edge needs ``ensure_rows``
    (``clv_pallas_dyn.py:1073``)."""
    tables, m_gathers = dyn_runtime_args(dyn)
    exp_tabs, pos_of, _ = _export_tables(dyn)
    src = np.zeros((len(dyn.segments), dyn.r_imp, 2), np.int32)
    for si, s in enumerate(dyn.segments):
        for k, (a, b) in enumerate(s.imports):
            src[si, k] = (a, pos_of[(a, b)])
    return (tables, m_gathers, [torch.from_numpy(x) for x in exp_tabs],
            torch.from_numpy(src), torch.from_numpy(dyn_slot_plan(dyn).slots))


def dyn_identity_tips(dyn: DynSchedule) -> DynSchedule:
    """Remap a single-segment schedule's tip references to global tip ids,
    so its tip rows do not depend on the topology
    (``clv_pallas_dyn.py:621``)."""
    if len(dyn.segments) != 1:
        raise EinvalError("identity tip remap requires a single segment")
    s = dyn.segments[0]
    if len(s.tip_globals) != dyn.tips or dyn.r_tip != dyn.tips:
        raise EinvalError("single segment must reference every tip")
    remap = np.asarray(s.tip_globals, np.int64)
    table = s.table.copy()
    for col in (1, 2):
        is_tip = table[:, col] < dyn.r_tip
        table[is_tip, col] = remap[table[is_tip, col]]
    seg = DynSegment(table, s.m_ops, np.arange(dyn.tips, dtype=np.int64),
                     s.imports, s.n_local)
    return DynSchedule((seg,), dyn.tips, dyn.n_inner, dyn.r_tip, dyn.r_imp,
                       dyn.r_loc, dyn.n_chunks, dyn.chunk, dyn.seg_offsets,
                       dyn.loc_of, dyn.min_r_exp)


def _locate(dyn: DynSchedule, lm: int, tip_by_position: bool):
    """(state row, scaler row) of level-major CLV ``lm`` in the final
    segment.  A tip is found by its position in the final segment's tip
    list, or, for a single segment after :func:`dyn_identity_tips`
    (``tip_by_position`` false), is its own row."""
    g = _rows(dyn)
    last = len(dyn.segments) - 1
    fin = dyn.segments[last]
    if lm < dyn.tips:
        if not tip_by_position:
            return lm, g.dummy_scal
        tg = list(fin.tip_globals)
        if lm not in tg:
            raise EinvalError(f"eval tip {lm} not in the final segment's "
                              "tips: build the schedule with ensure_rows")
        return tg.index(lm), g.dummy_scal
    sseg, sloc = dyn.loc_of[lm - dyn.tips]
    if sseg == last:
        return g.loc0 + sloc, dyn.r_imp + sloc
    # the ROOT segment's import position, not the exporter's export
    # position: the two coincide only on chains
    try:
        pos = list(fin.imports).index((sseg, sloc))
    except ValueError:
        raise EinvalError(f"eval row {lm} lives in segment {sseg}, not "
                          "imported by the final segment: build the "
                          "schedule with ensure_rows") from None
    return dyn.r_tip + pos, pos


def dyn_eval_locs(dyn: DynSchedule, parent_lm: int,
                  child_lm: int) -> np.ndarray:
    """(p_state, c_state, p_scal, c_scal) int32 for make_dyn_score's
    ``dynamic_edge`` mode: the evaluation edge as data
    (``clv_pallas_dyn.py:646``).  Scaler rows are in node units."""
    by_position = len(dyn.segments) != 1
    p_state, p_scal = _locate(dyn, parent_lm, by_position)
    c_state, c_scal = _locate(dyn, child_lm, by_position)
    return np.asarray([p_state, c_state, p_scal, c_scal], np.int32)


# --------------------------------------------------------------------------
# the slot plan
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SlotPlan:
    """Where each local row of each segment lives while the kernel runs:
    ``slots`` [n_segments, r_loc] int32, a slot number per row (-1 for the
    pad rows no op writes).  Slots are numbered first fit in op order, so
    the numbers do not depend on the pool: with a pool of ``P`` slots a
    row whose slot is below ``P`` lives in shared memory, any other in
    device row ``slot - P`` of the scratch (K6) or in its own output row
    (K5).  Two rows share a number only when their lives do not overlap,
    so neither the pool nor the scratch is overwritten while live."""

    slots: np.ndarray
    n_slots: Tuple[int, ...]  # per segment: its peak live count

    def pools(self, cap: int) -> Tuple[int, ...]:
        """Each segment's pool at a cap of ``cap`` slots."""
        return tuple(min(n, cap) for n in self.n_slots)

    def spills(self, cap: int) -> int:
        """Local rows that live in device memory at a cap of ``cap``."""
        return int((self.slots >= cap).sum())

    def scratch_rows(self, cap: int) -> int:
        return max(0, max(self.n_slots, default=0) - cap)


def dyn_slot_plan(dyn: DynSchedule, final_keep=None,
                  exports: bool = True) -> SlotPlan:
    """The slot plan of ``dyn`` (:class:`SlotPlan`).  Kept to the end: with
    ``exports``, every row a later segment imports (K6 copies them out
    last); in the final segment the locals in ``final_keep`` (the rows the
    evaluation edge reads), or all of them when it is None (a
    ``dynamic_edge`` score may read any)."""
    g = _rows(dyn)
    referenced = {}
    if exports:
        for s in dyn.segments:
            for (a, b) in s.imports:
                referenced.setdefault(a, set()).add(b)
    last = len(dyn.segments) - 1
    rows = []
    for si, s in enumerate(dyn.segments):
        keep = set(referenced.get(si, ()))
        if si == last:
            keep |= (set(range(s.n_local)) if final_keep is None
                     else set(final_keep))
        rows.append(segment_slots(s.table, g, sorted(keep)))
    slots = np.stack(rows)
    return SlotPlan(slots, tuple(int(r.max()) + 1 if (r >= 0).any() else 0
                                 for r in rows))


def pool_cap(rate_cats: int, states: int, dtype, srows: int) -> int:
    """The most slots a block's pool takes: as many as fit
    ``POOL_BUDGET`` beside the staged P-matrices (two blocks per SM at
    worst); 47 for DNA at four rates in float32, 10 for protein."""
    return ((POOL_BUDGET - stage_bytes(rate_cats, states, dtype))
            // pool_bytes(1, rate_cats, states, dtype, srows))


def any_slot_bytes(rate_cats: int, states: int, dtype, srows: int) -> int:
    """Shared memory of one pool slot of the any-alphabet instance: C·S
    values and ``srows`` counters at each of ``ANY_SITES`` sites."""
    return ANY_SITES * (rate_cats * states * _itemsize(dtype) + 4 * srows)


def any_tail_bytes(rate_cats: int, states: int, dtype) -> int:
    """Dynamic shared memory of the any-alphabet instance past its pool:
    the warps' rings of staged P-matrices (S <= 16; above, they are read
    through L1), or the root's edge exchange where that is larger."""
    r = any_bound(states)
    ring = (any_warps(rate_cats)[0] * ANY_RING_UNITS * 2 * r * r
            * _itemsize(dtype)) if r <= 16 else 0
    return max(ring, rate_cats * ANY_SITES * (_itemsize(dtype) + 4))


def any_pool_cap(rate_cats: int, states: int, dtype, srows: int) -> int:
    """The most slots the any-alphabet instance's pool takes: as many as
    fit :func:`any_pool_budget` beside its rings; 4 for 16 states at four
    rates in float32, 0 for 61 states at eight rates in float64, where
    every local row spills.  Never negative."""
    free = (any_pool_budget(rate_cats)
            - any_tail_bytes(rate_cats, states, dtype))
    return max(0, free // any_slot_bytes(rate_cats, states, dtype, srows))


def any_kernel_pmatrix(pmatrix: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] P-matrices as the any-alphabet instance reads them: at
    S <= 16 each matrix transposed (entry [k, j] = P[j, k]) and padded
    with zeros to [R, R] (:func:`any_bound`); else each row padded with
    zeros to whole 16-byte vectors (``clv_fused.pad_rows``)."""
    if any_bound(pmatrix.shape[-1]) > 16:
        return cf.pad_rows(pmatrix)
    return any_pt(pmatrix)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def plain_slotted_segment(g: _Rows, table, m_ops, slots, pool: int,
                          tip_rows, imp_clv, imp_scal, tips_packed,
                          tip_encoding, pmatrix, scale_mode, spill,
                          spill_scal, sweep: bool):
    """Run one segment as the kernel addresses it, with PyTorch ops: local
    row ``l`` lives in pool slot ``slots[l]`` when that is below ``pool``,
    else in row ``l`` (``sweep``) or ``slots[l] - pool`` of ``spill``
    [n, C, S, L] / ``spill_scal`` [n·srows, L]; under ``sweep`` every row
    is also written to its row of ``spill`` (K5's output).  Returns (state,
    scalers) as :func:`clv_seg.plain_segment` does, each local read back
    where it lives at the end (``spill`` under ``sweep``): rows whose slot
    was reused hold their successor's values."""
    _, c, s, _ = pmatrix.shape
    sites = tips_packed.shape[-1]
    srows = c if scale_mode == SCALE_PER_RATE else 1
    thresh, factor = scale_consts(pmatrix.dtype)
    tips = cf.decode_tips(tips_packed, tip_encoding, tip_rows.long(), c, s,
                          pmatrix.dtype)
    pool_clv = pmatrix.new_zeros((pool, c, s, sites))
    pool_scal = torch.zeros((pool, srows, sites), dtype=torch.int32,
                            device=pmatrix.device)
    if spill_scal is not None:  # None: nothing spills
        spill_scal = spill_scal.view(-1, srows, sites)
    slots = [int(v) for v in slots]
    zero_clv = pmatrix.new_zeros((c, s, sites))
    zero_scal = pool_scal.new_zeros((srows, sites))
    done = False  # the op loop has ended: under sweep, read back outputs

    def where(l):
        """(values, counters, row) of local ``l``; None for a pad row."""
        slot = slots[l]
        if slot < 0:
            return None
        if slot < pool and not (sweep and done):
            return pool_clv, pool_scal, slot
        return spill, spill_scal, (l if sweep else slot - pool)

    def row(r):
        if r < g.r_tip:
            return tips[r]
        if r < g.loc0:
            return imp_clv[r - g.r_tip]
        at = where(r - g.loc0) if r < g.trash_state else None
        return zero_clv if at is None else at[0][at[2]]

    def counters(r):
        if r < g.r_imp:
            return imp_scal[r * srows:(r + 1) * srows]
        at = where(r - g.r_imp) if r < g.dummy_scal else None
        return zero_scal if at is None else at[1][at[2]]

    for (p, c1, c2, s1, s2, has), (m1, m2) in zip(table.tolist(),
                                                  m_ops.tolist()):
        if p == g.trash_state:
            continue
        x, cnt = plain_op(pmatrix, m1, m2, row(c1), row(c2),
                          counters(s1) + counters(s2), has, scale_mode,
                          thresh, factor)
        l = p - g.loc0
        clv, scal, k = where(l)
        clv[k], scal[k] = x, cnt
        if sweep:
            spill[l], spill_scal[l] = x, cnt
    done = True
    state = torch.stack([row(r) for r in range(g.n_state)])
    scal = torch.cat([counters(r) for r in range(g.n_scal)])
    return state, scal


# --------------------------------------------------------------------------
# CUDA binding
# --------------------------------------------------------------------------
_TIP_CODE = {"clv": 0, "chars": 1, "masks": 2}
_MODE_SWEEP, _MODE_LEAF, _MODE_ROOT = 0, 1, 2
_SEGMENT_ARGTYPES = ([ctypes.c_int] * 5 + [ctypes.c_int64]
                     + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 20)
_ANY_SEGMENT_ARGTYPES = ([ctypes.c_int] * 6 + [ctypes.c_int64]
                         + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 19
                         + [ctypes.c_int64, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/clv_dyn.cu``, once per
    process."""
    lib = _build.load("clv_dyn")
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"clv_dyn_segment_{suffix}")
        fn.argtypes = _SEGMENT_ARGTYPES
        fn.restype = ctypes.c_int
    lib.clv_dyn_error_string.argtypes = [ctypes.c_int]
    lib.clv_dyn_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_any_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/clv_dyn_any.cu``, the
    any-alphabet instance, once per process."""
    lib = _build.load("clv_dyn_any")
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"clv_dyn_any_segment_{suffix}")
        fn.argtypes = _ANY_SEGMENT_ARGTYPES
        fn.restype = ctypes.c_int
    lib.clv_dyn_any_error_string.argtypes = [ctypes.c_int]
    lib.clv_dyn_any_error_string.restype = ctypes.c_char_p
    return lib


def _stacked(x) -> torch.Tensor:
    """Per-segment tables as one [n_segments, ...] tensor."""
    return torch.stack(list(x)) if isinstance(x, (list, tuple)) else x


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"dyn kernel input: {what}")


@dataclass(frozen=True)
class PoolLayout:
    """One call's pool: the slot table it runs, each segment's pool size
    and the scratch rows of its spills."""

    slots: Optional[torch.Tensor]  # [n_segments, r_loc]; None: the plan's
    pools: Tuple[int, ...]
    scratch: int
    spills: Optional[int]  # spilled rows (None for a plan given as data)


class _DynKernel:
    """What K5 and K6 share: the schedule and its slot plan, their checks
    and per-device copies of its static tables, the pool layout, and one
    segment's launch."""

    def __init__(self, dyn, scale_mode, rate_cats, states, tip_encoding,
                 impl, mxu_precision, plan: SlotPlan):
        if scale_mode not in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE):
            raise EinvalError(f"unsupported scale mode {scale_mode}")
        cf.check_tip_encoding(tip_encoding, states)
        if tip_encoding == "masks" and states > DYN_MASK_MAX_STATES:
            raise EinvalError(f"tip masks must fit 31 bits (states <= "
                              f"{DYN_MASK_MAX_STATES}), not {states}: use "
                              "'clv' tips")
        if impl not in ("auto", "vpu", "mxu"):
            raise EinvalError(f"unknown impl {impl!r}")
        if mxu_precision not in MXU_PRECISIONS:
            raise EinvalError(f"mxu_precision {mxu_precision!r}: the port "
                              f"takes {MXU_PRECISIONS}, both computed at "
                              "full precision ('highest')")
        self.dyn, self.g = dyn, _rows(dyn)
        self.scale_mode, self.tip_encoding = scale_mode, tip_encoding
        self.rate_cats, self.states = rate_cats, states
        self.srows = rate_cats if scale_mode == SCALE_PER_RATE else 1
        # the any-alphabet instance (csrc/clv_dyn_any.cu) takes the call
        self.any = any_instance(states, rate_cats)
        self.plan = plan
        # the most pool slots a launch takes; None: pool_cap's budget
        self.slot_cap: Optional[int] = None
        self._host = {"tip_globals": dyn_tip_globals(dyn),
                      "slots": torch.from_numpy(plan.slots)}
        self._device = {}
        self.max_matrix = max(int(s.m_ops.max()) for s in dyn.segments)

    def static(self, name: str, device) -> torch.Tensor:
        """A static table of the schedule, copied to ``device`` once."""
        key = (name, str(device))
        if key not in self._device:
            self._device[key] = self._host[name].to(device)
        return self._device[key]

    def layout(self, dtype, slot_plan=None) -> PoolLayout:
        """The pool of a call at ``dtype``: each segment's pool is its
        plan's peak up to the cap.  A plan given as data (another
        topology's, from :func:`dyn_swap_args`) gets the cap, or ``r_loc``
        below it, and scratch for every row above."""
        c, s, srows = self.rate_cats, self.states, self.srows
        if self.any:
            cap = (any_pool_cap(c, s, dtype, srows) if self.slot_cap is None
                   else self.slot_cap)
            need = (cap * any_slot_bytes(c, s, dtype, srows)
                    + any_tail_bytes(c, s, dtype))
            limit = 232448 - ANY_STATIC_SMEM
        else:
            cap = (pool_cap(c, s, dtype, srows) if self.slot_cap is None
                   else self.slot_cap)
            need = (pool_bytes(cap, c, s, dtype, srows)
                    + stage_bytes(c, s, dtype))
            limit = POOL_LIMIT
        if cap < 0 or need > limit:
            raise EinvalError(f"a pool of {cap} slots takes {need} bytes "
                              f"of shared memory, over the {limit} a "
                              f"block has for it")
        if slot_plan is None:
            return PoolLayout(None, self.plan.pools(cap),
                              self.plan.scratch_rows(cap),
                              self.plan.spills(cap))
        pool = min(self.g.r_loc, cap)
        return PoolLayout(slot_plan, (pool,) * len(self.dyn.segments),
                          self.g.r_loc - pool, None)

    def _slot_table(self, lay: PoolLayout, device) -> torch.Tensor:
        if lay.slots is None:
            return self.static("slots", device)
        return _stacked(lay.slots).to(device=device, dtype=torch.int32)

    def _scratch(self, lay: PoolLayout, pmatrix, sites, fill):
        """(rows, counters) of the spilled locals, or (None, None)."""
        if lay.scratch == 0:
            return None, None
        return (fill((lay.scratch, self.rate_cats, self.states, sites),
                     dtype=pmatrix.dtype, device=pmatrix.device),
                fill((lay.scratch * self.srows, sites), dtype=torch.int32,
                     device=pmatrix.device))

    def check(self, tips_packed, pmatrix, tables) -> str:
        """Validate what every launch shares; return the dtype suffix."""
        device = tips_packed.device
        if device.type != "cuda":
            raise EinvalError(f"dyn kernels run on CUDA tensors, not {device}")
        c, s = self.rate_cats, self.states
        suffix = check_pmatrix(pmatrix, c, s, self.max_matrix)
        _require(pmatrix.data_ptr() % 16 == 0,
                 "pmatrix is not 16-byte aligned (its rows load as vectors)")
        tips, sites = self.dyn.tips, tips_packed.shape[-1]
        # the kernel stages row indices in 28 bits
        _require(max(tips, self.dyn.n_inner) < 1 << 28, "tree too large")
        if self.tip_encoding == "clv":
            _require(tips_packed.dtype == pmatrix.dtype
                     and tuple(tips_packed.shape) == (tips, c, s, sites),
                     f"clv tips {tuple(tips_packed.shape)} "
                     f"{tips_packed.dtype}")
        else:
            rows = -(-tips // 8) if self.tip_encoding == "chars" else tips
            _require(tips_packed.dtype == torch.int32
                     and tuple(tips_packed.shape) == (rows, sites),
                     f"{self.tip_encoding} tips {tuple(tips_packed.shape)} "
                     f"{tips_packed.dtype}")
        _require(sites > 0, "no sites")
        for name, t in (("tips", tips_packed), ("pmatrix", pmatrix)):
            _require(t.device == device, f"{name} on {t.device}")
            _require(t.is_contiguous(), f"{name} is not contiguous")
        n_seg = len(self.dyn.segments)
        for name, t, tail in tables:
            _require(t.dtype == torch.int32 and t.device == device
                     and t.is_contiguous()
                     and tuple(t.shape) == (n_seg,) + tail,
                     f"{name} {tuple(t.shape)} {t.dtype} on {t.device}, "
                     f"want [{n_seg}, {', '.join(map(str, tail))}] int32")
        return suffix

    def launch(self, suffix, mode, tips_packed, pmatrix, si, lay, *, table,
               m_ops, tip_globals, imp_rows, slots, src, src_scal, loc,
               loc_scal, exp_table=None, r_exp=0, exp=None, exp_scal=None,
               edge=None, weight_vec=None, pattern_weights=None,
               inv_add=None, partials=None):
        """One segment's kernel on the current stream of the tensors'
        card, with segment ``si``'s pool of ``lay``.
        ``loc``/``loc_scal``/``exp``/``exp_scal`` are addresses.  The
        any-alphabet instance takes ``pmatrix`` as
        :func:`any_kernel_pmatrix` lays it out."""
        g = self.g
        lib = load_any_kernels() if self.any else load_kernels()
        head = (mode, self.states) + ((pmatrix.shape[-1],) if self.any
                                      else ())
        with torch.cuda.device(tips_packed.device):
            stream = torch.cuda.current_stream().cuda_stream
            args = (*head, self.rate_cats,
                    _TIP_CODE[self.tip_encoding], self.scale_mode,
                    tips_packed.shape[-1], g.r_tip, g.r_imp, g.r_loc, r_exp,
                    lay.pools[si], _ptr(table[si]), _ptr(m_ops[si]),
                    _ptr(tip_globals[si]), _ptr(imp_rows[si]),
                    _ptr(slots[si]), _ptr(tips_packed), _ptr(pmatrix),
                    _ptr(src), _ptr(src_scal), loc, loc_scal,
                    None if exp_table is None else _ptr(exp_table[si]), exp,
                    exp_scal, _ptr(edge), _ptr(weight_vec),
                    _ptr(pattern_weights), _ptr(inv_add), _ptr(partials))
            if self.any:
                rc = getattr(lib, f"clv_dyn_any_segment_{suffix}")(
                    *args, 0 if partials is None else partials.numel(),
                    stream)
                error = lib.clv_dyn_any_error_string
            else:
                rc = getattr(lib, f"clv_dyn_segment_{suffix}")(*args, stream)
                error = lib.clv_dyn_error_string
        if rc != 0:
            msg = error(rc).decode()
            raise KernelError(f"dyn segment launch failed: CUDA error {rc} "
                              f"({msg})")
        type(self).launches += 1
        type(self).any_launches += self.any


class DynSweep(_DynKernel):
    """K5: ``sweep(tips_packed, tables, m_gathers, pmatrix, tip_globals=None,
    slot_plan=None) -> (inner [n_inner, C, S, L], scalers)``, inner rows
    segment-major (``dyn.inner_row`` translates level-major ids); scalers
    [n_inner + 1, L], or [n_inner + 1, C, L] per rate, the last row the
    zero dummy.  ``tables``/``m_gathers`` from :func:`dyn_runtime_args`
    (lists or stacked), on the tips' device; ``tip_globals`` defaults to
    the schedule's (:func:`dyn_tip_globals`); other tables than the
    schedule's need their ``slot_plan`` (:func:`dyn_slot_plan`)."""

    launches = 0
    any_launches = 0  # those of the any-alphabet instance

    def __init__(self, dyn, scale_mode, rate_cats, states, tip_encoding,
                 impl, mxu_precision):
        # every row goes out as it is made: nothing is kept to the end
        super().__init__(dyn, scale_mode, rate_cats, states, tip_encoding,
                         impl, mxu_precision,
                         dyn_slot_plan(dyn, final_keep=(), exports=False))
        rows = np.zeros((len(self.dyn.segments), self.g.r_imp), np.int32)
        for si, s in enumerate(self.dyn.segments):
            for k, (a, b) in enumerate(s.imports):
                rows[si, k] = self.dyn.seg_offsets[a] + b
        self._host["imp_rows"] = torch.from_numpy(rows)

    def _inputs(self, tips_packed, tables, m_gathers, tip_globals):
        device = tips_packed.device
        if tip_globals is None:
            tip_globals = self.static("tip_globals", device)
        return (_stacked(tables), _stacked(m_gathers), tip_globals,
                self.static("imp_rows", device))

    def _outputs(self, pmatrix, sites, fill):
        dyn, c, s = self.dyn, self.rate_cats, self.states
        inner = fill((dyn.n_inner, c, s, sites), dtype=pmatrix.dtype,
                     device=pmatrix.device)
        scalers = torch.zeros(((dyn.n_inner + 1) * self.srows, sites),
                              dtype=torch.int32, device=pmatrix.device)
        return inner, scalers

    def _shaped(self, inner, scalers):
        if self.scale_mode == SCALE_PER_RATE:
            scalers = scalers.view(self.dyn.n_inner + 1, self.rate_cats, -1)
        return inner, scalers

    def plain(self, tips_packed, tables, m_gathers, pmatrix,
              tip_globals=None, slot_plan=None):
        """Plain version of K5: the segment tables run segment by segment
        with PyTorch ops, imports read from the inner rows written so far.
        ``slot_plan`` is accepted for the call's signature; no pool."""
        return self._plain(tips_packed, tables, m_gathers, pmatrix,
                           tip_globals)

    def plain_slotted(self, tips_packed, tables, m_gathers, pmatrix,
                      tip_globals=None, slot_plan=None):
        """:meth:`plain` through the kernel's pool and spill addressing
        (:func:`plain_slotted_segment`), for testing the plan."""
        return self._plain(tips_packed, tables, m_gathers, pmatrix,
                           tip_globals, self.layout(pmatrix.dtype, slot_plan))

    def _plain(self, tips_packed, tables, m_gathers, pmatrix, tip_globals,
               lay=None):
        tables, m_ops, tg, imp_rows = self._inputs(tips_packed, tables,
                                                   m_gathers, tip_globals)
        g, srows, sites = self.g, self.srows, tips_packed.shape[-1]
        inner, scalers = self._outputs(pmatrix, sites, torch.zeros)
        node_scal = scalers.view(-1, srows, sites)
        for si, seg in enumerate(self.dyn.segments):
            rows = imp_rows[si].long()
            off, n = self.dyn.seg_offsets[si], seg.n_local
            args = (tg[si], inner[rows], node_scal[rows].reshape(-1, sites),
                    tips_packed, self.tip_encoding, pmatrix, self.scale_mode)
            if lay is None:
                state, scal = plain_segment(g, tables[si], m_ops[si], *args)
            else:
                state, scal = plain_slotted_segment(
                    g, tables[si], m_ops[si],
                    self._slot_table(lay, pmatrix.device)[si], lay.pools[si],
                    *args, inner[off:off + n],
                    scalers[off * srows:(off + n) * srows], sweep=True)
            inner[off:off + n] = state[g.loc0:g.loc0 + n]
            scalers[off * srows:(off + n) * srows] = (
                scal[g.r_imp * srows:(g.r_imp + n) * srows])
        return self._shaped(inner, scalers)

    def __call__(self, tips_packed, tables, m_gathers, pmatrix,
                 tip_globals=None, slot_plan=None):
        if tips_packed.device.type == "cpu":
            return self.plain(tips_packed, tables, m_gathers, pmatrix,
                              tip_globals, slot_plan)
        tables, m_ops, tg, imp_rows = self._inputs(tips_packed, tables,
                                                   m_gathers, tip_globals)
        g = self.g
        lay = self.layout(pmatrix.dtype, slot_plan)
        slots = self._slot_table(lay, tips_packed.device)
        suffix = self.check(tips_packed, pmatrix, [
            ("tables", tables, (g.r_loc, TABLE_FIELDS)),
            ("m_gathers", m_ops, (g.r_loc, 2)),
            ("tip_globals", tg, (g.r_tip,)),
            ("imp_rows", imp_rows, (g.r_imp,)),
            ("slot_plan", slots, (g.r_loc,))])
        sites = tips_packed.shape[-1]
        inner, scalers = self._outputs(pmatrix, sites, torch.empty)
        cs, srows = self.rate_cats * self.states, self.srows
        kpm = any_kernel_pmatrix(pmatrix) if self.any else pmatrix
        for si in range(len(self.dyn.segments)):
            off = self.dyn.seg_offsets[si]
            self.launch(suffix, _MODE_SWEEP, tips_packed, kpm, si, lay,
                        table=tables, m_ops=m_ops,
                        tip_globals=tg, imp_rows=imp_rows, slots=slots,
                        src=inner, src_scal=scalers,
                        loc=_ptr(inner, off, cs * sites),
                        loc_scal=_ptr(scalers, off * srows, sites))
        return self._shaped(inner, scalers)


def make_dyn_sweep(dyn: DynSchedule, scale_mode: int = SCALE_PER_SITE, *,
                   rate_cats: int, states: int, tip_encoding: str = "clv",
                   impl: str = "auto",
                   mxu_precision: str = "highest") -> DynSweep:
    """Build K5 (``clv_pallas_dyn.py:383``); see :class:`DynSweep`."""
    return DynSweep(dyn, scale_mode, rate_cats, states, tip_encoding, impl,
                    mxu_precision)


class DynScore(_DynKernel):
    """K6: ``score(tips_packed, tables, m_gathers, exp_tables, pmatrix,
    weight_vec, pattern_weights, inv_add=None, eval_locs=None,
    edge_matrix_idx=None, imp_src=None, tip_globals=None,
    return_partials=False, slot_plan=None) -> logl`` (float64).

    Leaf segments keep their live rows in the pool (spills in a scratch)
    and export the rows later segments import; the root segment folds the
    edge log-likelihood, one float64 partial per BLOCK_SITES sites, folded
    here in float64 (``return_partials`` returns them instead).
    ``weight_vec``: ``clv_fused.pack_weight_vec`` ([C*S], (1 - p_inv)
    folded in under +I); ``pattern_weights`` and ``inv_add`` [L].
    ``eval_locs`` (``dynamic_edge``, from :func:`dyn_eval_locs`),
    ``edge_matrix_idx``, ``imp_src``, ``slot_plan`` (from
    :func:`dyn_swap_args`) and ``tip_globals`` take the evaluation edge and
    the schedule from data: another topology built with the same envelope
    scores through this instance by swapping them with its tables.  On the
    card all of them are read there, without a sync to the host."""

    launches = 0
    any_launches = 0

    def __init__(self, dyn, parent_lm, child_lm, edge_matrix, scale_mode,
                 rate_cats, states, tip_encoding, impl, use_pinv,
                 dynamic_edge, mxu_precision):
        g = _rows(dyn)
        locs = ([*_locate(dyn, parent_lm, True),
                 *_locate(dyn, child_lm, True)] if not dynamic_edge else None)
        # the rows the edge reads stay to the end: under dynamic_edge any
        # row of the final segment
        plan = dyn_slot_plan(dyn, None if dynamic_edge else [
            r - g.loc0 for r in (locs[0], locs[2])
            if g.loc0 <= r < g.trash_state])
        super().__init__(dyn, scale_mode, rate_cats, states, tip_encoding,
                         impl, mxu_precision, plan)
        self.use_pinv, self.dynamic_edge = use_pinv, dynamic_edge
        self.edge_matrix = edge_matrix
        _, pos_of, self.r_exp = _export_tables(dyn)
        rows = np.zeros((len(dyn.segments), self.g.r_imp), np.int32)
        for si, s in enumerate(dyn.segments):
            for k, (a, b) in enumerate(s.imports):
                rows[si, k] = a * self.r_exp + pos_of[(a, b)]
        self._host["imp_rows"] = torch.from_numpy(rows)
        if not dynamic_edge:
            self._host["edge"] = torch.tensor(
                [locs[0], locs[2], locs[1], locs[3], edge_matrix],
                dtype=torch.int32)

    def _inputs(self, tips_packed, tables, m_gathers, exp_tables, eval_locs,
                edge_matrix_idx, imp_src, tip_globals):
        """The stacked tables, import rows and edge vector
        (p_state, c_state, p_scal, c_scal, edge matrix) on the tips'
        device."""
        device = tips_packed.device
        if tip_globals is None:
            tip_globals = self.static("tip_globals", device)
        if imp_src is None:
            imp_rows = self.static("imp_rows", device)
        else:
            src = torch.as_tensor(imp_src, device=device)
            imp_rows = (src[..., 0] * self.r_exp + src[..., 1]).to(
                torch.int32).contiguous()
        if eval_locs is None and edge_matrix_idx is None:
            edge = self.static("edge", device)
        else:
            locs = (self.static("edge", device)[:4] if eval_locs is None
                    else torch.as_tensor(eval_locs, device=device))
            if isinstance(edge_matrix_idx, torch.Tensor):
                em = edge_matrix_idx.to(device).reshape(1)
            else:
                em = torch.full((1,), self.edge_matrix
                                if edge_matrix_idx is None
                                else int(edge_matrix_idx), device=device)
            edge = torch.cat([locs.to(torch.int32).reshape(4),
                              em.to(torch.int32)])
        return (_stacked(tables), _stacked(m_gathers), _stacked(exp_tables),
                tip_globals, imp_rows, edge)

    def _check_call(self, inv_add, eval_locs):
        if (inv_add is not None) != self.use_pinv:
            raise EinvalError("inv_add is given exactly when use_pinv")
        if (eval_locs is not None) != self.dynamic_edge:
            raise EinvalError("eval_locs is given exactly when dynamic_edge")

    def plain(self, tips_packed, tables, m_gathers, exp_tables, pmatrix,
              weight_vec, pattern_weights, inv_add=None, eval_locs=None,
              edge_matrix_idx=None, imp_src=None, tip_globals=None,
              return_partials=False, slot_plan=None):
        """Plain version of K6: the same tables, segment by segment, with
        PyTorch ops; exports copied out by the export tables.
        ``slot_plan`` is accepted for the call's signature; no pool."""
        return self._plain(
            (tips_packed, tables, m_gathers, exp_tables, eval_locs,
             edge_matrix_idx, imp_src, tip_globals), pmatrix, weight_vec,
            pattern_weights, inv_add, eval_locs, return_partials)

    def plain_slotted(self, tips_packed, tables, m_gathers, exp_tables,
                      pmatrix, weight_vec, pattern_weights, inv_add=None,
                      eval_locs=None, edge_matrix_idx=None, imp_src=None,
                      tip_globals=None, return_partials=False,
                      slot_plan=None):
        """:meth:`plain` through the kernel's pool and spill addressing
        (:func:`plain_slotted_segment`), for testing the plan."""
        return self._plain(
            (tips_packed, tables, m_gathers, exp_tables, eval_locs,
             edge_matrix_idx, imp_src, tip_globals), pmatrix, weight_vec,
            pattern_weights, inv_add, eval_locs, return_partials,
            self.layout(pmatrix.dtype, slot_plan))

    def _plain(self, inputs, pmatrix, weight_vec, pattern_weights, inv_add,
               eval_locs, return_partials, lay=None):
        self._check_call(inv_add, eval_locs)
        tables, m_ops, exp_tabs, tg, imp_rows, edge = self._inputs(*inputs)
        tips_packed = inputs[0]
        g, srows, r_exp = self.g, self.srows, self.r_exp
        c, s = self.rate_cats, self.states
        sites = tips_packed.shape[-1]
        n_seg = len(self.dyn.segments)
        exports = pmatrix.new_zeros((n_seg * r_exp, c, s, sites))
        exp_scal = torch.zeros((n_seg * r_exp, srows, sites),
                               dtype=torch.int32, device=pmatrix.device)
        if lay is not None:
            scratch, scratch_scal = self._scratch(lay, pmatrix, sites,
                                                  torch.zeros)
            slots = self._slot_table(lay, pmatrix.device)
        for si in range(n_seg):
            rows = imp_rows[si].long()
            args = (tg[si], exports[rows], exp_scal[rows].reshape(-1, sites),
                    tips_packed, self.tip_encoding, pmatrix, self.scale_mode)
            if lay is None:
                state, scal = plain_segment(g, tables[si], m_ops[si], *args)
            else:
                state, scal = plain_slotted_segment(
                    g, tables[si], m_ops[si], slots[si], lay.pools[si],
                    *args, scratch, scratch_scal, sweep=False)
            if si < n_seg - 1:
                for e, (st, sc) in enumerate(exp_tabs[si].tolist()):
                    exports[si * r_exp + e] = state[st]
                    exp_scal[si * r_exp + e] = scal[sc * srows:
                                                    (sc + 1) * srows]
        partials = plain_edge_partials(
            state, scal, edge.tolist(), pmatrix, weight_vec,
            pattern_weights, inv_add, self.scale_mode)
        return partials if return_partials else cf.sum_block_partials(
            partials)

    def __call__(self, tips_packed, tables, m_gathers, exp_tables, pmatrix,
                 weight_vec, pattern_weights, inv_add=None, eval_locs=None,
                 edge_matrix_idx=None, imp_src=None, tip_globals=None,
                 return_partials=False, slot_plan=None):
        if tips_packed.device.type == "cpu":
            return self.plain(tips_packed, tables, m_gathers, exp_tables,
                              pmatrix, weight_vec, pattern_weights, inv_add,
                              eval_locs, edge_matrix_idx, imp_src,
                              tip_globals, return_partials, slot_plan)
        self._check_call(inv_add, eval_locs)
        tables, m_ops, exp_tabs, tg, imp_rows, edge = self._inputs(
            tips_packed, tables, m_gathers, exp_tables, eval_locs,
            edge_matrix_idx, imp_src, tip_globals)
        g, r_exp, srows = self.g, self.r_exp, self.srows
        device, dtype = tips_packed.device, pmatrix.dtype
        lay = self.layout(dtype, slot_plan)
        slots = self._slot_table(lay, device)
        suffix = self.check(tips_packed, pmatrix, [
            ("tables", tables, (g.r_loc, TABLE_FIELDS)),
            ("m_gathers", m_ops, (g.r_loc, 2)),
            ("exp_tables", exp_tabs, (r_exp, 2)),
            ("tip_globals", tg, (g.r_tip,)),
            ("imp_rows", imp_rows, (g.r_imp,)),
            ("slot_plan", slots, (g.r_loc,))])
        sites = tips_packed.shape[-1]
        cs = self.rate_cats * self.states
        _require(edge.dtype == torch.int32 and tuple(edge.shape) == (5,)
                 and edge.device == device, "eval_locs / edge_matrix_idx")
        vectors = [("weight_vec", weight_vec, (cs,)),
                   ("pattern_weights", pattern_weights, (sites,))]
        if inv_add is not None:
            vectors.append(("inv_add", inv_add, (sites,)))
        for name, t, shape in vectors:
            _require(t.device == device and t.dtype == dtype
                     and tuple(t.shape) == shape and t.is_contiguous(),
                     f"{name} {tuple(t.shape)} {t.dtype} on {t.device}")
        n_seg = len(self.dyn.segments)
        exports = torch.empty((n_seg * r_exp, cs, sites), dtype=dtype,
                              device=device)
        exp_scal = torch.empty((n_seg * r_exp * srows, sites),
                               dtype=torch.int32, device=device)
        scratch, scratch_scal = self._scratch(lay, pmatrix, sites,
                                              torch.empty)
        n_blocks = -(-sites // BLOCK_SITES)
        # one partial per SLOT_SITES sites, zero past the last tile
        tiles = torch.zeros((n_blocks * (BLOCK_SITES // SLOT_SITES),),
                            dtype=torch.float64, device=device)
        kpm = any_kernel_pmatrix(pmatrix) if self.any else pmatrix
        for si in range(n_seg):
            root = si == n_seg - 1
            self.launch(
                suffix, _MODE_ROOT if root else _MODE_LEAF, tips_packed,
                kpm, si, lay, table=tables, m_ops=m_ops,
                tip_globals=tg, imp_rows=imp_rows, slots=slots,
                src=exports, src_scal=exp_scal, loc=_ptr(scratch),
                loc_scal=_ptr(scratch_scal), exp_table=exp_tabs,
                r_exp=r_exp, exp=_ptr(exports, si * r_exp, cs * sites),
                exp_scal=_ptr(exp_scal, si * r_exp * srows, sites),
                edge=edge, weight_vec=weight_vec,
                pattern_weights=pattern_weights, inv_add=inv_add,
                partials=tiles)
        partials = fold_tile_partials(tiles, sites)
        return partials if return_partials else cf.sum_block_partials(
            partials)


def make_dyn_score(dyn: DynSchedule, parent_lm: int, child_lm: int,
                   edge_matrix: int, scale_mode: int = SCALE_PER_SITE, *,
                   rate_cats: int, states: int,
                   tip_encoding: str = "chars", impl: str = "auto",
                   use_pinv: bool = False, dynamic_edge: bool = False,
                   mxu_precision: str = "highest") -> DynScore:
    """Build K6 (``clv_pallas_dyn.py:695``); see :class:`DynScore`.
    ``parent_lm``/``child_lm`` are level-major CLV ids of the evaluation
    edge, which must reach the final segment (``ensure_rows``) unless
    ``dynamic_edge`` takes it from data."""
    return DynScore(dyn, parent_lm, child_lm, edge_matrix, scale_mode,
                    rate_cats, states, tip_encoding, impl, use_pinv,
                    dynamic_edge, mxu_precision)
