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
``csrc/clv_seg.cu``; that file says how they are laid out on the card and
what bounds them.

The cut: a DFS from the root; a node whose accumulated subtree row count
would exceed ``max_rows`` closes its larger child subtree into a segment
and replaces it with a virtual tip (size 1), until the node fits.  Each
segment references its children as ("tip", i) into its own tip list,
("imp", i) into rows imported from earlier segments, or ("loc", i) into its
own local rows; scaler references likewise, with ("zero",) for tips and
children without a scaler.  Only the few subtree-root rows that later
segments import ever cross between segments.

The row budget.  On the TPU a segment's rows lived in VMEM
(``_max_rows``/``_VMEM_BUDGET``, ``:94-99``, not ported).  K3/K4 keep a
segment's local rows and counters in a thread block's shared memory, at
``TILE_SITES`` sites per block: :func:`seg_local_rows` is how many local
rows fit ``SMEM_BUDGET`` (two blocks per SM), and :func:`seg_max_rows` the
cut's ``max_rows`` whose segments hold no more (a binary subtree of s
rows, tips and imports counted, has (s - 1) / 2 locals).  A call whose
segments need more shared memory than one block may have (``SMEM_LIMIT``)
raises :class:`EinvalError` before anything runs.  The dyn tier keeps only
a segment's live rows in shared memory, planned slot by slot
(``clv_dyn.dyn_slot_plan``), and cuts segments by its own budget
(``clv_dyn.dyn_max_rows``).

K3/K4 take CLV tips only (per-segment slabs from
:func:`pack_tips_segmented`, rows rate-major: the JAX package's "mxu"
layout, the port's only one) and no +I, as on the TPU.  ``impl`` is
accepted for signature parity: the port has one contraction.  Each wrapper
takes its plain version for a tensor on the CPU, and only there: on a CUDA
tensor it launches its kernel, once per segment, or raises.  Each counts
its launches in its class's ``launches``.
"""

from __future__ import annotations

import ctypes
import functools
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
TILE_SITES = cf.BLOCK_SITES  # sites per thread block, and per partial sum
# dynamic shared memory of one block of csrc/clv_seg.cu.  The limit: an
# H100 block may use 227 KB (232 448 bytes), less 1 KB kept for the
# kernel's static reduction buffer.  The budget segments are cut to: half
# an SM's 228 KB (233 472 bytes) less the 1 KB the card reserves per block
# and that buffer's 32 bytes, so that two blocks share an SM; at 1 024 taxa
# x 32 768 sites two blocks ran K4 1.8x faster than one (H100, 700 W)
SMEM_LIMIT = 232448 - 1024
SMEM_BUDGET = 233472 // 2 - 1024 - 32


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
# the row budget
# --------------------------------------------------------------------------
def _itemsize(dtype) -> int:
    return (dtype.itemsize if isinstance(dtype, torch.dtype)
            else np.dtype(dtype).itemsize)


def _smem_bytes(n_local: int, rate_cats: int, states: int, dtype,
                srows: int) -> int:
    """Shared memory of one block holding ``n_local`` rows: C·S values and
    ``srows`` int32 counters per row at each of the tile's sites."""
    return n_local * TILE_SITES * (rate_cats * states * _itemsize(dtype)
                                   + srows * 4)


def seg_local_rows(rate_cats: int, states: int, dtype) -> int:
    """How many local rows (C·S values and, at most, one int32 counter per
    rate, at each of ``TILE_SITES`` sites) fit ``SMEM_BUDGET``: 11 for DNA
    at four rates in float32, 6 in float64.  A row larger than the budget
    gets the one row ``SMEM_LIMIT`` holds (protein at eight rates in
    float64)."""
    row = _smem_bytes(1, rate_cats, states, dtype, rate_cats)
    rows = SMEM_BUDGET // row or SMEM_LIMIT // row
    if rows < 1:
        raise EinvalError(f"one row of {rate_cats} x {states} {dtype} "
                          "exceeds a block's shared memory")
    return rows


def seg_max_rows(rate_cats: int, states: int, dtype) -> int:
    """The cut's ``max_rows`` on the GPU: segments of at most this many
    rows (tips, imports and locals) hold at most :func:`seg_local_rows`
    local rows, since a binary subtree of s rows has (s - 1) / 2 inner
    nodes.  23 for DNA at four rates in float32."""
    return 2 * seg_local_rows(rate_cats, states, dtype) + 1


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
_MODE_SWEEP, _MODE_LEAF, _MODE_ROOT = 0, 1, 2
_SEGMENT_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_int64]
                     + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 15)


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/clv_seg.cu``, once per
    process."""
    lib = _build.load("clv_seg")
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"clv_seg_segment_{suffix}")
        fn.argtypes = _SEGMENT_ARGTYPES
        fn.restype = ctypes.c_int
    lib.clv_seg_max_smem.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.clv_seg_max_smem.restype = ctypes.c_int
    lib.clv_seg_error_string.argtypes = [ctypes.c_int]
    lib.clv_seg_error_string.restype = ctypes.c_char_p
    return lib


def max_smem(states: int, dtype) -> int:
    """The largest dynamic shared memory one block of the kernel instance
    may ask for on the current card (bytes)."""
    lib = load_kernels()
    got = lib.clv_seg_max_smem(states, int(_itemsize(dtype) == 8))
    if got < 0:
        msg = lib.clv_seg_error_string(-got).decode()
        raise KernelError(f"clv_seg shared-memory query failed: {msg}")
    return got


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
    [M, C, S, S]: float32 or float64, contiguous, S in {4, 20}, C in
    {1, 2, 4, 8}, every matrix the schedule uses.  Returns the dtype
    suffix of the kernel's C entry points."""
    c, s = rate_cats, states
    _require(pmatrix.dtype in (torch.float32, torch.float64),
             f"pmatrix dtype {pmatrix.dtype} (float32 or float64)")
    _require(pmatrix.dim() == 4 and tuple(pmatrix.shape[1:]) == (c, s, s)
             and pmatrix.is_contiguous(),
             f"pmatrix {tuple(pmatrix.shape)} for C={c}, S={s}")
    _require(s in KERNEL_STATES, f"states {s} (the kernels take 4 or 20)")
    _require(c in cf.KERNEL_RATE_CATS, f"rate_cats {c} (one of 1, 2, 4, 8)")
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


class _SegKernel:
    """What K3 and K4 share: the schedule and its per-segment tables
    (concatenated segment-major, segment ``si``'s ops at
    ``seg.seg_offsets[si]``), their per-device copies, the checks and one
    segment's launch."""

    def __init__(self, seg, scale_mode, rate_cats, states, impl,
                 block_sites):
        if scale_mode not in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE):
            raise EinvalError(f"unsupported scale mode {scale_mode}")
        if impl not in ("auto", "vpu", "mxu"):
            raise EinvalError(f"unknown impl {impl!r}")
        if block_sites not in (None, TILE_SITES):
            raise EinvalError(f"block_sites {block_sites}: the kernels run "
                              f"{TILE_SITES}-site tiles")
        self.seg, self.scale_mode = seg, scale_mode
        self.rate_cats, self.states = rate_cats, states
        self.srows = rate_cats if scale_mode == SCALE_PER_RATE else 1
        self.rows = [segment_rows(s) for s in seg.segments]
        tables = [segment_table(s, g) for s, g in zip(seg.segments,
                                                      self.rows)]
        self.max_matrix = max((int(m.max()) for _, m in tables if m.size),
                              default=0)
        self.imp_offsets = _offsets(g.r_imp for g in self.rows)
        self._host = {
            "table": _i32(np.concatenate([t for t, _ in tables]),
                          TABLE_FIELDS),
            "m_ops": _i32(np.concatenate([m for _, m in tables]), 2)}
        self._device = {}

    def static(self, name: str, device) -> torch.Tensor:
        """A static table of the schedule, copied to ``device`` once."""
        key = (name, str(device))
        if key not in self._device:
            self._device[key] = self._host[name].to(device)
        return self._device[key]

    def check_budget(self, dtype) -> None:
        """Every segment's local rows fit one block's shared memory."""
        for si, g in enumerate(self.rows):
            need = _smem_bytes(g.r_loc, self.rate_cats, self.states, dtype,
                               self.srows)
            if need > SMEM_LIMIT:
                raise EinvalError(
                    f"segment {si} has {g.r_loc} local rows, {need} bytes "
                    f"of shared memory over a block's {SMEM_LIMIT}: cut "
                    f"with max_rows <= seg_max_rows({self.rate_cats}, "
                    f"{self.states}, {dtype})")

    def check(self, tip_slabs, pmatrix, vectors=()) -> str:
        """Validate what every launch takes; return the dtype suffix."""
        device = pmatrix.device
        if device.type != "cuda":
            raise EinvalError(f"segmented kernels run on CUDA tensors, not "
                              f"{device}")
        c, s = self.rate_cats, self.states
        suffix = check_pmatrix(pmatrix, c, s, self.max_matrix)
        _require(len(tip_slabs) == len(self.rows),
                 f"{len(tip_slabs)} tip slabs for {len(self.rows)} segments")
        sites = tip_slabs[0].shape[-1]
        _require(sites > 0, "no sites")
        for si, (slab, g) in enumerate(zip(tip_slabs, self.rows)):
            _require(slab.device == device and slab.dtype == pmatrix.dtype
                     and tuple(slab.shape) == (max(g.r_tip, 1), c * s, sites)
                     and slab.is_contiguous(),
                     f"tip slab {si}: {tuple(slab.shape)} {slab.dtype} on "
                     f"{slab.device}, want [{max(g.r_tip, 1)}, {c * s}, "
                     f"{sites}] {pmatrix.dtype}")
        for name, t, shape in vectors:
            _require(t.device == device and t.dtype == pmatrix.dtype
                     and tuple(t.shape) == shape and t.is_contiguous(),
                     f"{name} {tuple(t.shape)} {t.dtype} on {t.device}")
        return suffix

    def launch(self, suffix, mode, si, slab, pmatrix, *, imp_rows, src,
               src_scal, n_out, out_rows=None, out=None, out_scal=None,
               edge=None, weight_vec=None, pattern_weights=None,
               partials=None):
        """Segment ``si``'s kernel on the current stream of the tensors'
        card.  ``out``/``out_scal`` are addresses."""
        g, off = self.rows[si], self.seg.seg_offsets[si]
        device = pmatrix.device
        lib = load_kernels()
        with torch.cuda.device(device):
            rc = getattr(lib, f"clv_seg_segment_{suffix}")(
                mode, self.states, self.rate_cats, self.scale_mode,
                slab.shape[-1], g.r_tip, g.r_imp, g.r_loc, n_out,
                _ptr(self.static("table", device), off, TABLE_FIELDS),
                _ptr(self.static("m_ops", device), off, 2),
                _ptr(imp_rows, self.imp_offsets[si], 1) if g.r_imp else None,
                _ptr(slab), _ptr(pmatrix), _ptr(src), _ptr(src_scal),
                out_rows, out, out_scal, _ptr(edge), _ptr(weight_vec),
                _ptr(pattern_weights), _ptr(partials),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            msg = lib.clv_seg_error_string(rc).decode()
            raise KernelError(f"segment {si} launch failed: CUDA error {rc} "
                              f"({msg})")

    def run_plain(self, si, slab, pmatrix, imp_clv, imp_scal):
        """Segment ``si`` with PyTorch ops: (state, scalers)."""
        g, off = self.rows[si], self.seg.seg_offsets[si]
        tips = slab.view(slab.shape[0], self.rate_cats, self.states, -1)
        return plain_segment(
            g, self._host["table"][off:off + g.r_loc],
            self._host["m_ops"][off:off + g.r_loc],
            torch.arange(g.r_tip, device=pmatrix.device), imp_clv, imp_scal,
            tips, "clv", pmatrix, self.scale_mode)


class SegmentedSweep(_SegKernel):
    """K3: ``sweep(tip_slabs, pmatrix) -> (inner [n_inner, C, S, L],
    scalers)``, inner rows segment-major (``seg.inner_row`` translates
    level-major ids); scalers [n_inner + 1, L], or [n_inner + 1, C, L] per
    rate, the last row the zero dummy.  ``tip_slabs`` from
    :func:`pack_tips_segmented`."""

    launches = 0

    def __init__(self, seg, scale_mode, rate_cats, states, impl,
                 block_sites):
        super().__init__(seg, scale_mode, rate_cats, states, impl,
                         block_sites)
        self._host["imp_rows"] = _i32(
            [seg.seg_offsets[a] + b for s in seg.segments
             for (a, b) in s.imports])

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

    def __call__(self, tip_slabs, pmatrix):
        self.check_budget(pmatrix.dtype)
        if pmatrix.device.type == "cpu":
            return self.plain(tip_slabs, pmatrix)
        suffix = self.check(tip_slabs, pmatrix)
        sites = tip_slabs[0].shape[-1]
        inner, scalers = self._outputs(pmatrix, sites, torch.empty)
        cs, srows = self.rate_cats * self.states, self.srows
        imp_rows = self.static("imp_rows", pmatrix.device)
        for si, g in enumerate(self.rows):
            off = self.seg.seg_offsets[si]
            self.launch(suffix, _MODE_SWEEP, si, tip_slabs[si], pmatrix,
                        imp_rows=imp_rows, src=inner, src_scal=scalers,
                        n_out=g.r_loc, out=_ptr(inner, off, cs * sites),
                        out_scal=_ptr(scalers, off * srows, sites))
            SegmentedSweep.launches += 1
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
    logl`` (float64).  Leaf segments keep their rows on chip and copy out
    only the rows later segments import (``sorted(set(export_locals))``);
    the root segment folds the edge log-likelihood, one float64 partial
    per ``TILE_SITES`` sites, folded here in float64.  ``weight_vec``:
    ``clv_fused.pack_weight_vec`` [C·S]; ``pattern_weights`` [L]."""

    launches = 0

    def __init__(self, seg, parent_lm, child_lm, edge_matrix, scale_mode,
                 rate_cats, states, impl, block_sites):
        super().__init__(seg, scale_mode, rate_cats, states, impl,
                         block_sites)
        if parent_lm < seg.tips:
            raise EinvalError("edge parent must be an inner node")
        g = self.rows[-1]
        ends = [locate(seg, parent_lm, "parent"),
                locate(seg, child_lm, "child")]
        scal = [g.dummy_scal if kind == "tip" else
                scaler_row(g, ("simp" if kind == "imp" else "sloc", i))
                for kind, i in ends]
        self.edge = [state_row(g, ends[0]), state_row(g, ends[1]), *scal,
                     edge_matrix]
        self.max_matrix = max(self.max_matrix, edge_matrix)
        self.exports = [sorted(set(s.export_locals)) if si < len(self.rows)
                        - 1 else [] for si, s in enumerate(seg.segments)]
        self.exp_offsets = _offsets(len(e) for e in self.exports)
        self.n_exports = sum(len(e) for e in self.exports)
        self._host["imp_rows"] = _i32(
            [self.exp_offsets[a] + exp_pos_of(seg, a, b)
             for s in seg.segments for (a, b) in s.imports])
        self._host["out_rows"] = _i32([l for e in self.exports for l in e])
        self._host["edge"] = _i32(self.edge)

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

    def __call__(self, tip_slabs, pmatrix, weight_vec, pattern_weights):
        self.check_budget(pmatrix.dtype)
        if pmatrix.device.type == "cpu":
            return self.plain(tip_slabs, pmatrix, weight_vec,
                              pattern_weights)
        sites = tip_slabs[0].shape[-1]
        cs, srows = self.rate_cats * self.states, self.srows
        suffix = self.check(tip_slabs, pmatrix, [
            ("weight_vec", weight_vec, (cs,)),
            ("pattern_weights", pattern_weights, (sites,))])
        device, dtype = pmatrix.device, pmatrix.dtype
        n_exp = max(self.n_exports, 1)
        exports = torch.empty((n_exp, cs, sites), dtype=dtype, device=device)
        exp_scal = torch.empty((n_exp * srows, sites), dtype=torch.int32,
                               device=device)
        partials = torch.empty((-(-sites // TILE_SITES),),
                               dtype=torch.float64, device=device)
        out_rows = self.static("out_rows", device)
        common = dict(imp_rows=self.static("imp_rows", device), src=exports,
                      src_scal=exp_scal)
        last = len(self.rows) - 1
        for si in range(len(self.rows)):
            if si == last:
                self.launch(suffix, _MODE_ROOT, si, tip_slabs[si], pmatrix,
                            n_out=0, edge=self.static("edge", device),
                            weight_vec=weight_vec,
                            pattern_weights=pattern_weights,
                            partials=partials, **common)
            else:
                e0 = self.exp_offsets[si]
                self.launch(suffix, _MODE_LEAF, si, tip_slabs[si], pmatrix,
                            n_out=len(self.exports[si]),
                            out_rows=_ptr(out_rows, e0, 1),
                            out=_ptr(exports, e0, cs * sites),
                            out_scal=_ptr(exp_scal, e0 * srows, sites),
                            **common)
            SegmentedScore.launches += 1
        return cf.sum_block_partials(partials)


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
