"""Fused pruning sweep (K2) and fused edge score (K1): the host plan of the
kernels' walk, the CUDA wrappers, their plain PyTorch versions, and the
host helpers both share.

Counterpart: ``libpll_tpu/ops/clv_pallas.py`` — K1 replaces
``make_fused_edge_score`` (``:462``), K2 replaces ``make_fused_sweep``
(``:673``): DNA (S = 4) and protein (S = 20, JAX's MXU variant)
instances at C in {1, 2, 4, 8} (``csrc/clv_fused.cu``), and one instance
for any other alphabet (2 <= S <= 64) and rate count
(``csrc/clv_any.cu``), which also takes any walk whose pool does not fit
the DNA or protein instances' shared memory.  Those files say how the
kernels are laid out on the card and what bounds them.

Layouts are the JAX package's *unpacked* ones, so the two packages compare
like with like: tip CLVs ``[tips, C, S, L]``, inner CLVs
``[n_inner, C, S, L]`` (rows rate-major, ``c*S + s``), scalers
``[n_inner + 1, L]`` or, per rate, ``[n_inner + 1, C, L]`` int32 with the
last row the always-zero dummy.  Pattern tips are :func:`pack_tipchars`
nibble words (``"chars"``) or one int32 bitmask per tip and site
(``"masks"``).

The walk (:class:`FusedPlan`, once per topology): the ops in a post order
that visits first the child needing more live rows (Sethi–Ullman order),
so that few inner rows are live at once (3 at the 64-taxon flagship, 6 at
1 000 taxa); the live rows get slots of a shared-memory pool by first fit
(``clv_seg.segment_slots``); every op becomes a descriptor naming its
children and counters (a tip, or a pool slot), its P-matrices, its
scaling flag and its level-major row.  ``FusedPlan.plain_walk`` and
``plain_walk_score`` run that walk with PyTorch ops, so the plan is tested
where no kernel runs; given the any-alphabet instance's layout
(:func:`any_layout`: 32-site blocks, a warp a rate, its pool sized for 16
warps an SM) they keep the pool's first ``shared_slots`` slots apart from
the spilled ones, as that kernel does.

Each wrapper takes its plain version for a tensor on the CPU, and only
there: on a CUDA tensor it launches its kernel, once per call, or raises.
Each counts its launches in its ``launches`` attribute, and those of the
any-alphabet instance also in ``any_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from ..errors import EinvalError, KernelError
from ..utils.constants import (SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE,
                               scale_consts)
from . import _build
from .any_block import (ANY_CHUNK, ANY_MAX_STATES, ANY_RING_UNITS, ANY_SITES,
                        any_bound, any_pool_budget, any_pt, any_warps)
from .likelihood import site_lnl
from .sweep import LevelSchedule, make_level_sweep

TIP_ENCODINGS = ("clv", "chars", "masks")
KERNEL_RATE_CATS = (1, 2, 4, 8)
KERNEL_STATES = (4, 20)  # DNA and protein
# the any-alphabet instance (any_block's block): 2 <= S <= ANY_MAX_STATES
# at any rate count; "masks" tips are one int32 word, as JAX's
# (clv_pallas.py make_tipdecode shifts an int32 word by each state)
MASK_MAX_STATES = 32
BLOCK_SITES = 128  # sites per K1 partial sum
# an op's descriptor (clv_common.cuh's OpDesc: parent, home, child1,
# child2, scaler1, scaler2, m1, m2, has_scaler, out, shift1, shift2), the
# edge's (parent, child, their counters, the edge matrix, the child's
# nibble shift, 2 unused), and the sources they name as kind << INDEX_BITS
# | index (K_ZERO: no counter)
OP_FIELDS = 12
EDGE_FIELDS = 8
K_TIP, K_POOL = 0, 2
K_ZERO = -1
INDEX_BITS = 28


def flatten_ops(schedule: LevelSchedule) -> np.ndarray:
    """[n_inner, 8] int32 op table in level order (children before parents):
    (inner_row, child1, matrix1, child2, matrix2, scaler1, scaler2,
    has_scaler) — ``clv_pallas._flatten_ops`` as data."""
    rows = [
        (lev.offset + k - schedule.tips, lev.child1[k], lev.matrix1[k],
         lev.child2[k], lev.matrix2[k], lev.scaler1[k], lev.scaler2[k],
         int(lev.has_scaler[k]))
        for lev in schedule.levels for k in range(len(lev.child1))]
    return np.asarray(rows, np.int32).reshape(-1, 8)


def walk_order(flat: np.ndarray, tips: int) -> list:
    """The ops of ``flat`` (:func:`flatten_ops`) in the kernels' walk: a
    post order that visits first, at every node, the child needing more
    live inner rows, and the roots in the same way.  A node's need is
    max(its first child's, the first child's row + the second's need, its
    children's rows): an op's children are read before its row is written,
    so it may take a child's slot.  Returns level-major inner rows."""
    op_of = {int(r[0]): r for r in flat}
    need, held = {}, {}
    for r in flat:  # level order: children first
        g = int(r[0])
        kids = sorted(((need.get(c - tips, 0), int(c >= tips), c - tips)
                       for c in (int(r[1]), int(r[3]))),
                      key=lambda k: -k[0])
        (na, ha, _), (nb, hb, _) = kids
        need[g] = max(na, ha + nb, ha + hb, 1)
        held[g] = [k[2] for k in kids if k[1]]  # inner children, first first
    children = {c for r in flat for c in (int(r[1]), int(r[3]))}
    roots = [g for g in op_of if g + tips not in children]
    roots.sort(key=lambda g: -need[g])
    order, stack = [], [(g, False) for g in reversed(roots)]
    while stack:  # iterative: a caterpillar is as deep as it is wide
        g, expanded = stack.pop()
        if expanded:
            order.append(g)
            continue
        stack.append((g, True))
        stack.extend((c, False) for c in reversed(held[g]))
    return order


def _desc(kind: int, index: int) -> int:
    return (kind << INDEX_BITS) | int(index)


class FusedPlan:
    """The walk of K1/K2 over one schedule and tip encoding (and, for K1,
    one evaluation edge ``edge = (parent_clv, child_clv, edge_matrix)``,
    whose inner rows stay in the pool to the end).

    Attributes: ``order`` (level-major inner rows in walk order), ``slots``
    (each walk position's pool slot), ``pool`` (slots: the walk's peak of
    live rows), ``max_matrix``; the descriptors ``ops`` [n_inner,
    OP_FIELDS] and, with an edge, ``edge_desc`` [EDGE_FIELDS] (int32,
    host), copied to a card once by :meth:`static`.  A pattern tip child
    is (K_TIP, its word row) with its nibble shift in ``shift``; a CLV tip
    child is (K_TIP, its tip) and an inner child (K_POOL, slot), both with
    ``shift`` 0.  An op's ``parent`` and ``out`` fields are its
    level-major inner row."""

    def __init__(self, schedule: LevelSchedule, tip_encoding: str,
                 edge: Optional[tuple] = None):
        from .clv_seg import _Rows, segment_slots

        # the encoding's name; "chars" at 20 states raises at launch
        check_tip_encoding(tip_encoding, 4)
        if schedule.n_inner >= 1 << INDEX_BITS:
            raise EinvalError(f"{schedule.n_inner} inner rows: the kernels "
                              f"name rows in {INDEX_BITS} bits")
        self.schedule, self.tip_encoding = schedule, tip_encoding
        self.edge = None if edge is None else tuple(int(v) for v in edge)
        tips, n = schedule.tips, schedule.n_inner
        flat = flatten_ops(schedule)
        ends = [] if edge is None else [r - tips for r in edge[:2]
                                        if r >= tips]
        self.order = walk_order(flat, tips)
        pos = {g: i for i, g in enumerate(self.order)}
        op_of = {int(r[0]): r for r in flat}

        # the walk as one segment of clv_seg: state rows tips | locals,
        # counter rows locals | the zero dummy (n)
        table = np.zeros((n, 6), np.int32)
        for i, g in enumerate(self.order):
            _, c1, _, c2, _, s1, s2, has = op_of[g].tolist()
            table[i] = (tips + i, *(tips + pos[c - tips] if c >= tips else c
                                    for c in (c1, c2)),
                        *(n if s == n else pos[s] for s in (s1, s2)), has)
        self.slots = segment_slots(table, _Rows(tips, 0, n),
                                   sorted(pos[e] for e in ends))
        self.pool = int(self.slots.max()) + 1 if n else 1

        ops = np.zeros((n, OP_FIELDS), np.int32)
        for i, g in enumerate(self.order):
            _, c1, m1, c2, m2, s1, s2, has = op_of[g].tolist()
            child = [self._row_desc(c, pos) for c in (c1, c2)]
            shift = [self._shift(c) for c in (c1, c2)]
            scal = [K_ZERO if s == n else _desc(K_POOL, self.slots[pos[s]])
                    for s in (s1, s2)]
            ops[i] = (g, self.slots[i], *child, *scal, m1, m2, has, g,
                      *shift)
        self._host = {"ops": torch.from_numpy(ops)}
        self.max_matrix = int(max(flat[:, 2].max(), flat[:, 4].max())
                              if n else 0)
        if edge is not None:
            parent, child_row, matrix = self.edge
            self.max_matrix = max(self.max_matrix, matrix)
            self._host["edge_desc"] = torch.tensor(
                [self._row_desc(parent, pos), self._row_desc(child_row, pos),
                 self._scal_desc(parent, pos), self._scal_desc(child_row, pos),
                 matrix, self._shift(child_row), 0, 0], dtype=torch.int32)
        self._device = {}
        self._layouts = {}

    def _shift(self, row: int) -> int:
        """A chars tip's nibble shift (0 for any other row)."""
        chars = self.tip_encoding == "chars" and row < self.schedule.tips
        return 4 * (row & 7) if chars else 0

    def _row_desc(self, row: int, pos) -> int:
        tips = self.schedule.tips
        if row >= tips:
            return _desc(K_POOL, self.slots[pos[row - tips]])
        return _desc(K_TIP, row >> 3 if self.tip_encoding == "chars"
                     else row)

    def _scal_desc(self, row: int, pos) -> int:
        tips = self.schedule.tips
        return (K_ZERO if row < tips
                else _desc(K_POOL, self.slots[pos[row - tips]]))

    @property
    def ops(self) -> torch.Tensor:
        return self._host["ops"]

    def static(self, name: str, device) -> torch.Tensor:
        """A table of the plan (``ops``, ``edge_desc``), copied to
        ``device`` once."""
        key = (name, device)
        if key not in self._device:
            self._device[key] = self._host[name].to(device)
        return self._device[key]

    def layout(self, dtype, rate_cats: int, states: int, scale_mode: int,
               score: bool) -> dict:
        """How the kernel launches this walk on the current card (asked
        once per dtype, rate count, alphabet, scale mode and kernel):
        ``smem`` (dynamic shared memory per block, bytes),
        ``blocks_per_sm``, ``threads`` and ``block_sites`` per block,
        ``chunk`` (ops staged at once), ``sms`` and ``buffers`` (the
        protein instances' P-matrix buffers, 2 or 1; DNA 1); the largest
        chunk (DNA: then block) whose shared memory fits.  A protein block
        is ``block_sites`` (32 or 64: one or two sites a thread, the most
        that fit) by ``rate_cats`` warps, each slot of its pool C·20 values
        a site, with two matrix buffers where they fit.  Every other
        (S, C), and a walk whose pool those instances cannot hold, takes
        the any-alphabet instance: :func:`any_layout`'s block, with
        ``shared_slots`` (its pool's slots in shared memory; the rest
        spill to device rows), ``warps`` and ``rates_per_warp`` among the
        keys."""
        key = (dtype, rate_cats, states, scale_mode, score)
        if key not in self._layouts:
            f64 = int(dtype == torch.float64)
            rc = _INVALID_VALUE
            if states in KERNEL_STATES and rate_cats in KERNEL_RATE_CATS:
                lib = load_kernels()
                out = (ctypes.c_int * 7)()
                rc = lib.clv_fused_layout(states, f64, rate_cats, scale_mode,
                                          int(score), self.pool, out)
            if rc == _INVALID_VALUE:  # not an instance, or its pool too big
                self._layouts[key] = self._any_layout(
                    f64, rate_cats, states, scale_mode, score)
                return self._layouts[key]
            _check_launch(lib, rc, "fused layout query")
            smem, per_sm, threads, chunk, sites, sms, buffers = out
            self._layouts[key] = dict(
                smem=smem, blocks_per_sm=per_sm, threads=threads,
                chunk=chunk, block_sites=sites, sms=sms, buffers=buffers)
        return self._layouts[key]

    def _any_layout(self, f64, rate_cats, states, scale_mode, score):
        lib = load_any_kernels()
        out = (ctypes.c_int * 3)()
        # the blocks an SM its registers allow (no shared memory)
        _check_launch(lib, lib.clv_any_query(
            states, f64, int(score), 32 * any_warps(rate_cats)[0], 0, out),
            "any layout query")
        limit, sms = out[0], out[1]
        lay = any_layout(self.pool, rate_cats, states, 8 if f64 else 4,
                         scale_mode, blocks=out[2])
        if lay["smem"] > limit:
            raise EinvalError(f"a pool of {lay['shared_slots']} slots takes "
                              f"{lay['smem']} bytes of shared memory, over "
                              f"the {limit} a block has")
        _check_launch(lib, lib.clv_any_query(
            states, f64, int(score), lay["threads"], lay["smem"], out),
            "any layout query")
        return dict(lay, blocks_per_sm=out[2], sms=sms)

    # ------------------------------------------------------ the plain walk
    def _tip(self, tips_packed, d: int, shift: int, c: int, s: int, dtype):
        """A tip child's CLV [C, S, L] from its descriptor."""
        row = tips_packed[d & ((1 << INDEX_BITS) - 1)]
        if self.tip_encoding == "clv":
            return row
        bits = torch.arange(s, device=row.device, dtype=row.dtype)
        codes = row >> shift
        onehot = ((codes[None, :] >> bits[:, None]) & 1).to(dtype)
        return onehot[None].expand(c, -1, -1)

    def _walk(self, tips_packed, pmatrix, scale_mode, out=None,
              shared_slots=None):
        """Every op in walk order with PyTorch ops over all sites: its
        children and counters from the tips or the pool by descriptor, its
        row and counter stored in its slot and, given ``out`` = (inner,
        scalers [n_inner + 1, srows, L]), in its level-major row.  With
        ``shared_slots`` (the any-alphabet instance's layout) the pool's
        first slots and the spilled ones are kept apart, as that kernel
        keeps them in shared memory and in device rows.  Returns (row,
        count): a descriptor's values and counters."""
        from .clv_seg import plain_op

        _, c, s, _ = pmatrix.shape
        sites = tips_packed.shape[-1]
        srows = c if scale_mode == SCALE_PER_RATE else 1
        thresh, factor = scale_consts(pmatrix.dtype)
        shared = self.pool if shared_slots is None else shared_slots
        homes = [(pmatrix.new_zeros((n, c, s, sites)),
                  torch.zeros((n, srows, sites), dtype=torch.int32,
                              device=pmatrix.device))
                 for n in (shared, self.pool - shared)]
        zero = homes[0][1].new_zeros((srows, sites))
        index = (1 << INDEX_BITS) - 1

        def home(slot):  # (the pool's part, its index) of a slot
            return (homes[0], slot) if slot < shared else (homes[1],
                                                           slot - shared)

        def row(d, shift=0):
            if d >> INDEX_BITS == K_POOL:
                part, i = home(d & index)
                return part[0][i]
            return self._tip(tips_packed, d, shift, c, s, pmatrix.dtype)

        def count(d):
            if d == K_ZERO:
                return zero
            part, i = home(d & index)
            return part[1][i]

        for (_, slot, c1, c2, s1, s2, m1, m2, has, dst, t1,
             t2) in self._host["ops"].tolist():
            x, cnt = plain_op(pmatrix, m1, m2, row(c1, t1), row(c2, t2),
                              count(s1) + count(s2), has, scale_mode,
                              thresh, factor)
            part, i = home(slot)
            part[0][i], part[1][i] = x, cnt
            if out is not None:
                out[0][dst], out[1][dst] = x, cnt
        return row, count

    def plain_walk(self, tips_packed, pmatrix, scale_mode=SCALE_PER_SITE,
                   shared_slots=None):
        """K2 as the kernel walks it, with PyTorch ops: ``(inner,
        scalers)`` of :func:`fused_sweep_plain`, bit for bit
        (``shared_slots``: as :meth:`_walk`)."""
        _, c, s, _ = pmatrix.shape
        n, sites = self.schedule.n_inner, tips_packed.shape[-1]
        srows = c if scale_mode == SCALE_PER_RATE else 1
        inner = pmatrix.new_zeros((n, c, s, sites))
        scalers = torch.zeros((n + 1, srows, sites), dtype=torch.int32,
                              device=pmatrix.device)
        self._walk(tips_packed, pmatrix, scale_mode, (inner, scalers),
                   shared_slots)
        return inner, (scalers if scale_mode == SCALE_PER_RATE
                       else scalers[:, 0])

    def plain_walk_score(self, tips_packed, pmatrix, weight_vec,
                         pattern_weights, inv_add=None,
                         scale_mode=SCALE_PER_SITE, shared_slots=None):
        """K1 as the kernel walks it (the edge from its descriptors), with
        PyTorch ops: the logL of :func:`fused_edge_score_plain`, bit for
        bit (``shared_slots``: as :meth:`_walk`)."""
        _, c, s, _ = pmatrix.shape
        row, count = self._walk(tips_packed, pmatrix, scale_mode,
                                shared_slots=shared_slots)
        p, ch, ps, cs_, em, shift, *_ = self._host["edge_desc"].tolist()
        termb = torch.matmul(pmatrix[em], row(ch, shift))
        site_term = (row(p) * termb
                     * weight_vec.reshape(c, s, 1)).sum(dim=(0, 1))
        if inv_add is not None:
            site_term = site_term + inv_add
        return sum_block_partials(site_lnl(
            site_term, (count(ps) + count(cs_))[0], pattern_weights,
            pmatrix.dtype))


def pad_rows(pmatrix: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] P-matrices with each row padded with zeros to a whole
    number of 16-byte vectors, as ``clv_common.cuh``'s any-alphabet op
    reads them (C1, K3/K4 and K5/K6 at S > 16)."""
    per = 16 // pmatrix.element_size()
    s = pmatrix.shape[-1]
    return torch.nn.functional.pad(pmatrix, (0, -s % per)).contiguous()


def any_layout(pool: int, rate_cats: int, states: int, itemsize: int,
               scale_mode: int, cap: Optional[int] = None,
               blocks: Optional[int] = None) -> dict:
    """The any-alphabet instance's block for a walk of ``pool`` slots:
    ``ANY_SITES`` sites, a warp a rate (``any_block.any_warps``: ``warps``,
    ``rates_per_warp``), at S <= 16 each warp's ring of ``buffers`` (op,
    rate) units of [R, R] P-matrices (:func:`any_pt`), and as many of the
    pool's slots in shared memory (``shared_slots``, each C·S values and
    ``srows`` counters a site) as fit ``any_block.any_pool_budget`` beside
    the rings (16 warps an SM, or the ``blocks`` an SM the kernel's
    registers allow where fewer), or ``cap``; the rest spilled to device
    rows.  ``smem``: the block's dynamic shared memory.  Pure: the plain
    walk follows it on the CPU."""
    srows = rate_cats if scale_mode == SCALE_PER_RATE else 1
    warps, per = any_warps(rate_cats)
    r = any_bound(states)
    buffers = ANY_RING_UNITS if r <= 16 else 0
    ring = warps * buffers * 2 * r * r * itemsize
    slot = ANY_SITES * (rate_cats * states * itemsize + 4 * srows)
    if cap is None:
        cap = max(0, (any_pool_budget(rate_cats, blocks) - ring) // slot)
    shared = min(pool, cap)
    return dict(smem=shared * slot + ring, threads=32 * warps,
                chunk=ANY_CHUNK, block_sites=ANY_SITES, buffers=buffers,
                shared_slots=shared, warps=warps, rates_per_warp=per)


def pack_tipchars(tip_masks) -> torch.Tensor:
    """[tips, L] 4-bit ambiguity codes -> nibble-packed [ceil(tips/8), L]
    int32 words (word row g holds tips 8g..8g+7, tip i at bits 4·(i%8)) —
    0.5 byte/tip/site, the reference's PLL_ATTRIB_PATTERN_TIP storage
    (src/pll.c:825-903).  Counterpart ``clv_pallas.py:444``; returns a CPU
    tensor."""
    masks = np.asarray(tip_masks, dtype=np.uint32)
    if masks.max() > 0xF:
        raise EinvalError("tipchars mode supports 4-bit codes (states<=4)")
    tips, sites = masks.shape
    words = -(-tips // 8)
    slab = np.zeros((words * 8, sites), np.uint32)
    slab[:tips] = masks
    packed = np.zeros((words, sites), np.uint32)
    for k in range(8):
        packed |= slab[k::8][:words] << np.uint32(4 * k)
    return torch.from_numpy(packed.astype(np.int32))


def pack_weight_vec(freqs_pc: torch.Tensor,
                    rate_weights: torch.Tensor) -> torch.Tensor:
    """[C, S] frequencies × [C] rate weights -> [C*S] weights in the port's
    rate-major row order, so that Σ_c w_c Σ_s f_cs·x_cs is the sum over all
    rows of (wvec ⊙ x).  Counterpart ``clv_pallas.py:416``."""
    return (freqs_pc * rate_weights[:, None]).reshape(-1)


def sum_block_partials(partials: torch.Tensor) -> torch.Tensor:
    """Fold per-site-block partial log-likelihoods in float64.  At flagship
    scale |logL| reaches 1e6-1e7, where an f32 accumulator loses about one
    ulp (0.1-1 logL units) per block.  Counterpart ``clv_pallas.py:427``."""
    return partials.to(torch.float64).sum()


def check_tip_encoding(tip_encoding: str, states: int) -> None:
    if tip_encoding not in TIP_ENCODINGS:
        raise EinvalError(f"unknown tip encoding {tip_encoding!r}")
    if tip_encoding == "chars" and states > 4:
        # a nibble holds 4 state bits (clv_pallas.py:516-521)
        raise EinvalError("tip_encoding='chars' requires states <= 4; "
                          "use 'masks' for wider alphabets")
    if tip_encoding == "masks" and states > MASK_MAX_STATES:
        # one int32 word a tip and site (clv_pallas.py make_tipdecode)
        raise EinvalError(f"tip_encoding='masks' holds {MASK_MAX_STATES} "
                          f"states in its int32 word, not {states}; use "
                          "'clv' tips")


def decode_tips(tips_packed: torch.Tensor, tip_encoding: str,
                rows: torch.Tensor, rate_cats: int, states: int,
                dtype) -> torch.Tensor:
    """CLVs [len(rows), C, S, L] of the tips ``rows`` (a 1-D index tensor)
    from a tip input of any encoding: pattern tips become 0/1 rows by the
    bit walk of the reference's set_tipclv (src/pll.c:925-931)."""
    check_tip_encoding(tip_encoding, states)
    if tip_encoding == "clv":
        return tips_packed[rows]
    if tip_encoding == "chars":
        shift = (4 * (rows % 8))[:, None].to(tips_packed.dtype)
        codes = (tips_packed[rows // 8] >> shift) & 0xF
    else:
        codes = tips_packed[rows]
    bits = torch.arange(states, device=tips_packed.device,
                        dtype=codes.dtype)
    onehot = ((codes[:, None, :] >> bits[None, :, None]) & 1).to(dtype)
    return onehot[:, None].expand(-1, rate_cats, -1, -1)


def _scaler_row(schedule: LevelSchedule, clv_row: int) -> int:
    return (clv_row - schedule.tips if clv_row >= schedule.tips
            else schedule.n_inner)


def _plain_sweep(schedule, tips_packed, pmatrix, scale_mode, tip_encoding):
    """All CLVs [tips + n_inner, C, S, L] and scalers after the level
    sweep."""
    _, c, s, _ = pmatrix.shape
    rows = torch.arange(schedule.tips, device=tips_packed.device)
    tip_clv = decode_tips(tips_packed, tip_encoding, rows, c, s,
                          pmatrix.dtype)
    sites = tip_clv.shape[-1]
    clv = torch.cat([tip_clv, tip_clv.new_zeros(
        (schedule.n_inner, c, s, sites))])
    sshape = ((schedule.n_inner + 1, c, sites) if scale_mode == SCALE_PER_RATE
              else (schedule.n_inner + 1, sites))
    scalers = torch.zeros(sshape, dtype=torch.int32, device=clv.device)
    return make_level_sweep(schedule, scale_mode)(clv, scalers, pmatrix)


def fused_sweep_plain(schedule: LevelSchedule, tips_packed, pmatrix, *,
                      scale_mode: int = SCALE_PER_SITE,
                      tip_encoding: str = "clv"):
    """Plain version of K2: ``(inner [n_inner, C, S, L], scalers)``."""
    clv, scalers = _plain_sweep(schedule, tips_packed, pmatrix, scale_mode,
                                tip_encoding)
    return clv[schedule.tips:], scalers


def check_score_scope(schedule, scale_mode, parent_clv):
    """K1's scope, as the TPU kernel's: per-site or no scaling, and an
    inner node at the parent end of the evaluation edge."""
    if scale_mode not in (SCALE_NONE, SCALE_PER_SITE):
        raise EinvalError("fused edge score: per-site or no scaling only")
    if parent_clv < schedule.tips:
        raise EinvalError("evaluation-edge parent must be an inner node")


def fused_edge_score_plain(schedule: LevelSchedule, tips_packed, pmatrix,
                           weight_vec, pattern_weights, inv_add=None, *,
                           parent_clv: int, child_clv: int, edge_matrix: int,
                           scale_mode: int = SCALE_PER_SITE,
                           tip_encoding: str = "clv"):
    """Plain version of K1: the float64 log-likelihood across the
    evaluation edge, ``Σ_sites (log(Σ_rows parent ⊙ (P child) ⊙ wvec
    (+ inv_add)) + counters·log 2^-shift) · pattern_weight``."""
    check_score_scope(schedule, scale_mode, parent_clv)
    clv, scalers = _plain_sweep(schedule, tips_packed, pmatrix, scale_mode,
                                tip_encoding)
    _, c, s, _ = pmatrix.shape
    termb = torch.matmul(pmatrix[edge_matrix], clv[child_clv])
    site_term = (clv[parent_clv] * termb
                 * weight_vec.reshape(c, s, 1)).sum(dim=(0, 1))
    if inv_add is not None:
        site_term = site_term + inv_add
    snum = (scalers[_scaler_row(schedule, parent_clv)]
            + scalers[_scaler_row(schedule, child_clv)])
    return sum_block_partials(site_lnl(site_term, snum, pattern_weights,
                                       pmatrix.dtype))


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------
_TIP_CODE = {"clv": 0, "chars": 1, "masks": 2}
_WALK_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_int64]
                  + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 11)
_ANY_ARGTYPES = ([ctypes.c_int] * 4 + [ctypes.c_int64]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 13)
_INVALID_VALUE = 1  # cudaErrorInvalidValue


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/clv_fused.cu``, once per
    process."""
    return bind(_build.load("clv_fused"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``clv_fused.cu``."""
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"clv_fused_walk_{suffix}")
        fn.argtypes = _WALK_ARGTYPES
        fn.restype = ctypes.c_int
    lib.clv_fused_layout.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.clv_fused_layout.restype = ctypes.c_int
    lib.clv_fused_error_string.argtypes = [ctypes.c_int]
    lib.clv_fused_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.clv_fused_error_string
    return lib


@functools.lru_cache(maxsize=None)
def load_any_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/clv_any.cu``, the any-alphabet
    instance, once per process."""
    return bind_any(_build.load("clv_any"))


def bind_any(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``clv_any.cu``."""
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"clv_any_walk_{suffix}")
        fn.argtypes = _ANY_ARGTYPES
        fn.restype = ctypes.c_int
    lib.clv_any_query.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.clv_any_query.restype = ctypes.c_int
    lib.clv_any_error_string.argtypes = [ctypes.c_int]
    lib.clv_any_error_string.restype = ctypes.c_char_p
    lib.error_string = lib.clv_any_error_string
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"fused kernel input: {what}")


def _check_launch(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.error_string(rc).decode()
        raise KernelError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _check(plan, schedule, tips_packed, pmatrix, scale_mode, tip_encoding):
    """Validate the inputs both kernels share; return (dtype suffix,
    rate_cats, states, sites)."""
    device = tips_packed.device
    if device.type != "cuda":
        raise EinvalError(f"fused kernels run on CUDA tensors, not {device}")
    _require(plan.schedule is schedule and plan.tip_encoding == tip_encoding,
             "the plan was built for another schedule or tip encoding")
    m, c, s, s2 = pmatrix.shape
    _require(pmatrix.dtype in (torch.float32, torch.float64),
             f"pmatrix dtype {pmatrix.dtype} (float32 or float64)")
    _require(s == s2 and 2 <= s <= ANY_MAX_STATES,
             f"states {s} (the kernels take 2 to {ANY_MAX_STATES})")
    check_tip_encoding(tip_encoding, s)
    _require(c >= 1, f"rate_cats {c}")
    _require(scale_mode in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE),
             f"scale mode {scale_mode}")
    _require(plan.max_matrix < m,
             f"schedule uses matrix {plan.max_matrix} of {m}")
    tips, sites = schedule.tips, tips_packed.shape[-1]
    if tip_encoding == "clv":
        _require(tips_packed.dtype == pmatrix.dtype
                 and tuple(tips_packed.shape) == (tips, c, s, sites),
                 f"clv tips {tuple(tips_packed.shape)} {tips_packed.dtype}")
    else:
        rows = -(-tips // 8) if tip_encoding == "chars" else tips
        _require(tips_packed.dtype == torch.int32
                 and tuple(tips_packed.shape) == (rows, sites),
                 f"{tip_encoding} tips {tuple(tips_packed.shape)} "
                 f"{tips_packed.dtype}")
    for name, t in (("tips", tips_packed), ("pmatrix", pmatrix)):
        _require(t.device == device, f"{name} on {t.device}, not {device}")
        _require(t.is_contiguous(), f"{name} is not contiguous")
    _require(pmatrix.data_ptr() % 16 == 0,
             "pmatrix is not 16-byte aligned (its rows load as vectors)")
    _require(sites > 0, "no sites")
    return ("f32" if pmatrix.dtype == torch.float32 else "f64"), c, s, sites


def launch_grid(sites: int, lay: dict) -> int:
    """The blocks of one walk under layout ``lay`` (:meth:`FusedPlan.
    layout`): the sites padded to whole 128-site partials, in tiles of
    ``block_sites``; the DNA and protein instances launch at most the
    blocks the card holds at once, the any-alphabet instance a block a
    tile."""
    padded = -(-sites // BLOCK_SITES) * BLOCK_SITES
    tiles = -(-padded // lay["block_sites"])
    if "shared_slots" in lay:
        return tiles
    return min(tiles, max(1, lay["blocks_per_sm"]) * lay["sms"])


def _launch(plan, suffix, c, s, scale_mode, sites, tips_packed, pmatrix,
            inner=None, scalers=None, edge=None, weight_vec=None,
            pattern_weights=None, inv_add=None, partials=None) -> bool:
    """One walk on the current stream of the tensors' card: K2 when
    ``edge`` is None (rows and counters out), else K1, over
    :func:`launch_grid` blocks of the instance :meth:`FusedPlan.layout`
    picks (the any-alphabet one with its spill rows made here).  Returns
    whether that was the any-alphabet instance."""
    device = tips_packed.device

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(device):
        lay = plan.layout(pmatrix.dtype, c, s, scale_mode, edge is not None)
        grid = launch_grid(sites, lay)
        stream = torch.cuda.current_stream(device).cuda_stream
        n = plan.schedule.n_inner
        if "shared_slots" in lay:  # the any-alphabet instance
            lib = load_any_kernels()
            spilled = plan.pool - lay["shared_slots"]
            srows = c if scale_mode == SCALE_PER_RATE else 1
            spill = (torch.empty((spilled, c * s, sites), dtype=pmatrix.dtype,
                                 device=device) if spilled else None)
            spill_scal = (torch.empty((spilled, srows, sites),
                                      dtype=torch.int32, device=device)
                          if spilled else None)
            pt = any_pt(pmatrix)
            rc = getattr(lib, f"clv_any_walk_{suffix}")(
                s, c, _TIP_CODE[plan.tip_encoding], scale_mode, sites, n, n,
                plan.pool, lay["shared_slots"],
                ptr(plan.static("ops", device)), ptr(tips_packed), ptr(pt),
                ptr(inner), ptr(scalers),
                ptr(spill), ptr(spill_scal), ptr(edge), ptr(weight_vec),
                ptr(pattern_weights), ptr(inv_add), ptr(partials), stream)
        else:
            lib = load_kernels()
            rc = getattr(lib, f"clv_fused_walk_{suffix}")(
                s, c, _TIP_CODE[plan.tip_encoding], scale_mode, sites, n, n,
                plan.pool, lay["chunk"], lay["threads"], grid,
                lay["block_sites"], lay["buffers"],
                ptr(plan.static("ops", device)), ptr(tips_packed),
                ptr(pmatrix), ptr(inner), ptr(scalers), ptr(edge),
                ptr(weight_vec), ptr(pattern_weights), ptr(inv_add),
                ptr(partials), stream)
    _check_launch(lib, rc, "fused_sweep" if edge is None
                  else "fused_edge_score")
    return "shared_slots" in lay


def fused_sweep(schedule: LevelSchedule, tips_packed, pmatrix, *,
                plan: Optional[FusedPlan] = None,
                scale_mode: int = SCALE_PER_SITE, tip_encoding: str = "clv"):
    """K2: the whole post-order sweep, every inner CLV and scaler written
    out.  Returns ``(inner [n_inner, C, S, L], scalers)``.

    ``plan``: a :class:`FusedPlan` of ``schedule`` and ``tip_encoding``
    (built here when omitted).  CPU tensors take
    :func:`fused_sweep_plain`."""
    if tips_packed.device.type == "cpu":
        return fused_sweep_plain(schedule, tips_packed, pmatrix,
                                 scale_mode=scale_mode,
                                 tip_encoding=tip_encoding)
    if plan is None:
        plan = FusedPlan(schedule, tip_encoding)
    suffix, c, s, sites = _check(plan, schedule, tips_packed, pmatrix,
                                 scale_mode, tip_encoding)
    device, n_inner = tips_packed.device, schedule.n_inner
    srows = c if scale_mode == SCALE_PER_RATE else 1
    inner = torch.empty((n_inner, c, s, sites), dtype=pmatrix.dtype,
                        device=device)
    scalers = torch.empty(((n_inner + 1) * srows, sites), dtype=torch.int32,
                          device=device)
    any_ = _launch(plan, suffix, c, s, scale_mode, sites, tips_packed,
                   pmatrix, inner, scalers)
    fused_sweep.launches += 1
    fused_sweep.any_launches += any_
    if scale_mode == SCALE_PER_RATE:
        scalers = scalers.view(n_inner + 1, c, sites)
    return inner, scalers


fused_sweep.launches = 0
fused_sweep.any_launches = 0  # those of the any-alphabet instance


def fused_edge_score(schedule: LevelSchedule, tips_packed, pmatrix,
                     weight_vec, pattern_weights, inv_add=None, *,
                     plan: Optional[FusedPlan] = None, parent_clv: int,
                     child_clv: int, edge_matrix: int,
                     scale_mode: int = SCALE_PER_SITE,
                     tip_encoding: str = "clv"):
    """K1: the whole sweep with the edge log-likelihood folded in; the
    live inner rows stay on chip.  Returns the float64 log-likelihood.

    ``weight_vec``: :func:`pack_weight_vec` ([C*S], with (1 - p_inv)
    folded in under +I); ``pattern_weights`` and ``inv_add``: [L] in the
    working dtype.  Per-site or no scaling.  ``plan``: a
    :class:`FusedPlan` of ``schedule``, ``tip_encoding`` and this edge
    (built here when omitted).  CPU tensors take
    :func:`fused_edge_score_plain`."""
    from .clv_seg import fold_tile_partials

    check_score_scope(schedule, scale_mode, parent_clv)
    if tips_packed.device.type == "cpu":
        return fused_edge_score_plain(
            schedule, tips_packed, pmatrix, weight_vec, pattern_weights,
            inv_add, parent_clv=parent_clv, child_clv=child_clv,
            edge_matrix=edge_matrix, scale_mode=scale_mode,
            tip_encoding=tip_encoding)
    _require(0 <= child_clv < schedule.tips + schedule.n_inner
             and parent_clv < schedule.tips + schedule.n_inner,
             "edge CLV rows")
    if plan is None:
        plan = FusedPlan(schedule, tip_encoding,
                         (parent_clv, child_clv, edge_matrix))
    _require(plan.edge == (parent_clv, child_clv, edge_matrix),
             f"the plan was built for edge {plan.edge}")
    suffix, c, s, sites = _check(plan, schedule, tips_packed, pmatrix,
                                 scale_mode, tip_encoding)
    device = tips_packed.device
    vectors = [("weight_vec", weight_vec, (c * s,)),
               ("pattern_weights", pattern_weights, (sites,))]
    if inv_add is not None:
        vectors.append(("inv_add", inv_add, (sites,)))
    for name, t, shape in vectors:
        _require(t.device == device and t.dtype == pmatrix.dtype
                 and tuple(t.shape) == shape and t.is_contiguous(),
                 f"{name} {tuple(t.shape)} {t.dtype} on {t.device}")
    # one partial per 32 sites (a warp), four to each 128-site partial
    partials = torch.empty((-(-sites // BLOCK_SITES) * 4,),
                           dtype=torch.float64, device=device)
    any_ = _launch(plan, suffix, c, s, scale_mode, sites, tips_packed,
                   pmatrix, edge=plan.static("edge_desc", device),
                   weight_vec=weight_vec, pattern_weights=pattern_weights,
                   inv_add=inv_add, partials=partials)
    fused_edge_score.launches += 1
    fused_edge_score.any_launches += any_
    return sum_block_partials(fold_tile_partials(partials, sites))


fused_edge_score.launches = 0
fused_edge_score.any_launches = 0
