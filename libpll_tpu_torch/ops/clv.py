"""Conditional-likelihood-vector (CLV) updates of the stateful Partition:
the Felsenstein pruning step on the caller's buffers.

Counterpart: ``libpll_tpu/ops/clv.py`` (``update_partials`` ``:55``,
``update_partials_leveled`` ``:109``), capability parity with
``pll_update_partials`` (libpll ``src/partials.c:177-212``).  Each
operation computes, per rate category,

    ``new[c] = (P_left[c] @ clv_left[c]) * (P_right[c] @ clv_right[c])``

with the reference's scaling (``core_partials.c:607-663``): when every
entry of a site's span (all rates × states per site, one rate's states per
rate) falls below 2**-shift, the span is multiplied by 2**shift and the
counter incremented; a parent's counter starts as the sum of its
children's.

Unlike the level sweep of :mod:`.sweep` (the evaluation modules' plain
reference), these functions keep the caller's buffer indices, accept any
op list (partial traversals, a child computed by an earlier call, a buffer
written twice) and update ``clv`` and ``scalers`` in place: JAX donates
the buffers, and at 64 × 262 144 in float64 a copy is 4.3 GB.

Scaler row ``K`` (the last) is the always-zero dummy: ops whose scaler
index is −1 reach it (``engine.partition.operations_to_array``), read
zeros there, never scale, and leave it zero.

Two executors with JAX's sequential semantics:

  * :func:`update_partials_by_op` — one op at a time, every operand a
    view of the buffers (no gather);
  * :func:`update_partials_grouped` — ops that share no row in a hazard
    (read after write, write after read, write after write, on CLV and
    scaler rows alike) run as one gather, two batched matmuls and one
    scatter per group: fewer launches, more bytes.

:func:`update_partials` picks one of them by the row size and how far
the ops group.

:func:`update_partials_leveled` runs JAX's level tables
(``tree.schedule.build_levels``) the grouped way.  All three are plain
PyTorch: JAX computes these products in XLA, outside any Pallas kernel.

:func:`replay_ops` is the Partition's executor: on CUDA tensors the
hand-written kernel U1 of ``csrc/partials.cu`` (a lane per site and rate
walks the whole table in order, the ops staged in shared memory a window
at a time; one launch laid out by :func:`replay_plan`), on CPU tensors its
plain version :func:`update_partials`.  It counts its launches in
``replay_ops.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..errors import EinvalError, KernelError
from ..utils.constants import (SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE,
                               scale_consts, scale_shift_bits)
from . import _build
from .derivatives import check_full_precision

# rows gathered per side in one grouped matmul: bounds the transient
# memory of a wide group (the gathered children, two products) near 4×
GROUP_BYTES = 1 << 30
# update_partials groups ops only below this row size.  One op at a time
# costs ~0.15 ms of host issue an op on an H100 (15 kernels), so grouping
# won 1.5-18x at rows of 0.06-8 MiB (16-2 048 taxa); from 16 MiB rows the
# card's time per op passes the host's, and the groups' gathers (1.2-1.3x
# the bytes) lost (tools/partition_times.py; PERF.md)
GROUPED_MAX_ROW_BYTES = 12 << 20
REPLAY_MAX_STATES = 64  # U1's largest alphabet (kMaxAnyStates)
REPLAY_THREADS = 128  # U1's block (csrc/partials.cu kReplayBlock)
# shared memory a U1 block stages ops into: small enough that it does not
# cap the blocks an SM holds below what the registers allow
REPLAY_STAGE_BYTES = 16 << 10
# sites an SM from which one lane a site fills the card; below it a site
# takes a lane per rate
REPLAY_FILL_SITES = 1024


def _dummy(scalers, scale_mode) -> int:
    return scalers.shape[0] - 1 if scale_mode != SCALE_NONE else 0


def _scale_in_place(x, scale_mode, has_scaler=None):
    """Scale ``x`` [..., C, S, L] in place where a span is below the
    threshold; returns the bool mask ([..., L] per site, [..., C, L] per
    rate).  ``has_scaler`` (bool tensor broadcast over the mask, or None
    for all) clears it for ops that own no scaler.  The factor is a power
    of two, applied as ``exp2(mask·shift)``: exact, one pass over ``x``."""
    thresh, _ = scale_consts(x.dtype)
    shift = scale_shift_bits(x.dtype)
    per_site = scale_mode == SCALE_PER_SITE
    mask = x.amax(dim=(-3, -2) if per_site else -2) < thresh
    if has_scaler is not None:
        mask &= has_scaler
    factor = torch.exp2(mask.to(x.dtype) * shift)
    x.mul_(factor[..., None, None, :] if per_site else factor[..., None, :])
    return mask


def update_partials(clv, scalers, ops, pmatrix, scale_mode=SCALE_PER_SITE):
    """Execute an op table with JAX's sequential result, in place (the
    Partition's executor; arguments as :func:`update_partials_by_op`).

    Picks the executor from what it sees: the grouped one while a CLV row
    is under ``GROUPED_MAX_ROW_BYTES`` and the ops fall into at most half
    as many hazard groups, else one op at a time."""
    check_full_precision(clv, "update_partials")
    ops = np.asarray(ops, np.int64).reshape(-1, 8)
    dummy = _dummy(scalers, scale_mode)
    if clv[0].numel() * clv.element_size() < GROUPED_MAX_ROW_BYTES:
        level = hazard_levels(ops, dummy, scale_mode)
        groups = level.max(initial=-1) + 1
        if groups and len(ops) >= 2 * groups:
            _run_levels(clv, scalers, ops, level, pmatrix, scale_mode,
                        dummy)
            return
    update_partials_by_op(clv, scalers, ops, pmatrix, scale_mode)


def update_partials_by_op(clv, scalers, ops, pmatrix,
                          scale_mode=SCALE_PER_SITE):
    """Execute an op table in order, one op at a time, in place.

    Args:
      clv: [N, C, S, L] all CLV buffers (tips first, inner nodes after,
        the reference's index convention).
      scalers: [K+1, L] (per-site) or [K+1, C, L] (per-rate) int32
        exponent counters; row K is the always-zero dummy.
      ops: int [n_ops, 8] host table of (parent_clv, parent_scaler,
        child1_clv, child1_matrix, child1_scaler, child2_clv,
        child2_matrix, child2_scaler); scaler −1 already remapped to K.
      pmatrix: [M, C, S, S].
      scale_mode: SCALE_NONE / SCALE_PER_SITE / SCALE_PER_RATE.
    """
    check_full_precision(clv, "update_partials")
    dummy = _dummy(scalers, scale_mode)
    for p, ps, c1, m1, s1, c2, m2, s2 in np.asarray(ops).tolist():
        right = torch.matmul(pmatrix[m2], clv[c2])
        # the product lands in the parent's row unless that row is a child
        direct = p not in (c1, c2)
        x = torch.matmul(pmatrix[m1], clv[c1],
                         out=clv[p] if direct else None).mul_(right)
        if scale_mode != SCALE_NONE and ps != dummy:
            mask = _scale_in_place(x, scale_mode)
            torch.add(scalers[s1], scalers[s2], out=scalers[ps]).add_(mask)
        if not direct:
            clv[p] = x


def hazard_levels(ops, dummy, scale_mode=SCALE_PER_SITE) -> np.ndarray:
    """Each op's group: one more than the highest group of an earlier op
    it shares a hazard with (read after write, write after read, write
    after write; CLV rows and scaler rows).  Ops of one group touch
    disjoint rows, so a group runs as one batch, and groups in ascending
    order keep the table's sequential result.  The dummy scaler row is
    never a hazard: it reads zero and its writes are dropped."""
    scaled = scale_mode != SCALE_NONE
    wrote = {}  # ("c"|"s", row) -> group of its last write
    read = {}  # ("c"|"s", row) -> highest group that read it
    level = np.empty(len(ops), np.int64)
    for i, (p, ps, c1, m1, s1, c2, m2, s2) in enumerate(
            np.asarray(ops).tolist()):
        reads = [("c", c1), ("c", c2)]
        writes = [("c", p)]
        if scaled and ps != dummy:
            reads += [("s", s) for s in (s1, s2) if s != dummy]
            writes.append(("s", ps))
        lv = 1 + max([wrote.get(r, -1) for r in reads + writes]
                     + [read.get(w, -1) for w in writes])
        for r in reads:
            read[r] = max(read.get(r, -1), lv)
        for w in writes:
            wrote[w] = lv
        level[i] = lv
    return level


def _run_group(clv, scalers, g, pmatrix, scale_mode, dummy, valid=None):
    """One batch of hazard-free ops: ``g`` [w, 8] long on the card;
    ``valid`` [w] bool or None (all valid)."""
    row_bytes = clv[0].numel() * clv.element_size()
    step = max(1, GROUP_BYTES // row_bytes)
    for a in range(0, g.shape[0], step):
        gg = g[a:a + step]
        x = torch.matmul(pmatrix[gg[:, 3]], clv[gg[:, 2]])
        x.mul_(torch.matmul(pmatrix[gg[:, 6]], clv[gg[:, 5]]))
        if scale_mode != SCALE_NONE:
            has = gg[:, 1] != dummy
            if valid is not None:
                has &= valid[a:a + step]
            has = has[:, None] if scale_mode == SCALE_PER_SITE \
                else has[:, None, None]
            mask = _scale_in_place(x, scale_mode, has)
            # lanes aimed at "no scaler" land in the dummy row; re-zeroed
            scalers[gg[:, 1]] = scalers[gg[:, 4]] + scalers[gg[:, 7]] + mask
            scalers[dummy] = 0
        clv[gg[:, 0]] = x


def update_partials_grouped(clv, scalers, ops, pmatrix,
                            scale_mode=SCALE_PER_SITE):
    """:func:`update_partials`'s result, the ops batched by
    :func:`hazard_levels` (one host-to-card copy of the table)."""
    check_full_precision(clv, "update_partials")
    ops = np.asarray(ops, np.int64).reshape(-1, 8)
    dummy = _dummy(scalers, scale_mode)
    _run_levels(clv, scalers, ops, hazard_levels(ops, dummy, scale_mode),
                pmatrix, scale_mode, dummy)


def _run_levels(clv, scalers, ops, level, pmatrix, scale_mode, dummy):
    """The ops by ascending ``level``, each level one batch."""
    order = np.argsort(level, kind="stable")
    bounds = np.searchsorted(level[order], np.arange(level.max(initial=-1)
                                                     + 2))
    table = torch.as_tensor(ops[order], device=clv.device)
    for a, b in zip(bounds[:-1], bounds[1:]):
        _run_group(clv, scalers, table[a:b], pmatrix, scale_mode, dummy)


def update_partials_leveled(clv, scalers, level_ops, level_valid, pmatrix,
                            scale_mode=SCALE_PER_SITE):
    """Level-parallel variant (JAX ``:109``): ``level_ops`` int
    [n_levels, width, 8] from ``tree.schedule.build_levels``, padded by
    repeating ops of the same level (duplicate lanes write identical
    values); ``level_valid`` bool [n_levels, width] masks lanes out of
    scaling.  In place."""
    check_full_precision(clv, "update_partials_leveled")
    dummy = _dummy(scalers, scale_mode)
    table = torch.as_tensor(np.asarray(level_ops, np.int64),
                            device=clv.device)
    valid = torch.as_tensor(np.asarray(level_valid, bool),
                            device=clv.device)
    for lev in range(table.shape[0]):
        _run_group(clv, scalers, table[lev], pmatrix, scale_mode, dummy,
                   valid[lev])


# --------------------------------------------------------------------------
# U1: the op table on the card
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/partials.cu``, once per
    process."""
    lib = _build.load("partials")
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"replay_ops_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_int64] + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.replay_error_string.argtypes = [ctypes.c_int]
    lib.replay_error_string.restype = ctypes.c_char_p
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"replay_ops input: {what}")


def _check_replay(clv, scalers, pmatrix, scale_mode) -> None:
    """Raise on what U1 does not take: dtypes, shapes, contiguity, devices."""
    device, dtype = clv.device, clv.dtype
    _require(device.type == "cuda", f"clv on {device}, not CUDA")
    _require(dtype in (torch.float32, torch.float64),
             f"dtype {dtype} (float32 or float64)")
    _require(clv.dim() == 4 and clv.is_contiguous(),
             f"clv {tuple(clv.shape)}: [N, C, S, L], contiguous")
    _, c, s, length = clv.shape
    _require(2 <= s <= REPLAY_MAX_STATES,
             f"states {s} (2 to {REPLAY_MAX_STATES})")
    _require(pmatrix.dtype == dtype and pmatrix.device == device
             and pmatrix.dim() == 4 and tuple(pmatrix.shape[1:]) == (c, s, s)
             and pmatrix.is_contiguous(),
             f"pmatrix {tuple(pmatrix.shape)} {pmatrix.dtype} on "
             f"{pmatrix.device}: [M, {c}, {s}, {s}] {dtype}, contiguous")
    want = ((length,) if scale_mode == SCALE_PER_SITE else
            (c, length) if scale_mode == SCALE_PER_RATE else None)
    _require(scale_mode in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE),
             f"scale_mode {scale_mode}")
    _require(want is None or (
        scalers.dtype == torch.int32 and scalers.device == device
        and tuple(scalers.shape[1:]) == want and scalers.is_contiguous()),
        f"scalers {tuple(scalers.shape)} {scalers.dtype}: int32 "
        f"[K+1, {', '.join(map(str, want or ()))}] on {device}, contiguous")


def _host_table(ops, clv, scalers, pmatrix, scale_mode) -> torch.Tensor:
    """A host op table checked against the buffers' extents, as an int32
    tensor on the card (one copy)."""
    ops = np.asarray(ops, np.int64).reshape(-1, 8)
    if len(ops):
        limits = [(0, clv.shape[0]), (2, clv.shape[0]), (5, clv.shape[0]),
                  (3, pmatrix.shape[0]), (6, pmatrix.shape[0])]
        if scale_mode != SCALE_NONE:
            limits += [(k, scalers.shape[0]) for k in (1, 4, 7)]
        for col, hi in limits:
            _require(bool(((ops[:, col] >= 0) & (ops[:, col] < hi)).all()),
                     f"op table column {col} outside [0, {hi})")
    return torch.from_numpy(ops.astype(np.int32)).to(clv.device)


class ReplayPlan(NamedTuple):
    """U1's launch (:func:`replay_plan`, :func:`replay_layout`): ``lanes``
    lanes a site (one a rate), ``window`` ops staged in shared memory at
    once (0: none), ``buffers`` stage buffers of ``smem`` bytes in all,
    ``grid`` blocks of REPLAY_THREADS threads.  The launcher takes lanes,
    window, grid and smem as they stand and refuses a grid that misses a
    site or a stage that does not fit smem."""
    lanes: int
    window: int
    buffers: int
    smem: int
    grid: int


def _stage_bytes(window: int, rate_cats: int, states: int,
                 itemsize: int) -> int:
    """One stage buffer of ``window`` ops (csrc/partials.cu stage_pm_bytes
    and stage_op_bytes): their P-matrix sets, each rate's matrix padded by
    one value, then eight ints and a flag an op, each part rounded up to
    16 bytes."""
    def up16(b):
        return -(-b // 16) * 16
    return (up16(window * 2 * rate_cats * (states * states + 1) * itemsize)
            + up16(window * 9 * 4))


def replay_layout(sites: int, rate_cats: int, states: int, lanes: int,
                  window: int, n_ops: int, itemsize: int) -> ReplayPlan:
    """U1's launch for ``lanes`` lanes a site and ``window`` of ``n_ops``
    ops staged at once (pure): one stage buffer where the window holds the
    whole table, two where it does not (the next window staged while one
    computes), none for window 0; the blocks that cover ``sites``."""
    window = min(window, n_ops)
    buffers = 0 if not window else 1 if window == n_ops else 2
    smem = buffers * _stage_bytes(window, rate_cats, states, itemsize)
    return ReplayPlan(lanes, window, buffers, smem,
                      -(-sites * lanes // REPLAY_THREADS))


@functools.lru_cache(maxsize=1024)
def replay_plan(sites: int, rate_cats: int, states: int, sms: int,
                n_ops: int = 8, itemsize: int = 4) -> ReplayPlan:
    """U1's launch for ``n_ops`` ops on CLV rows of ``sites`` x
    ``rate_cats`` x ``states`` values of ``itemsize`` bytes on a card of
    ``sms`` SMs (pure).  Below REPLAY_FILL_SITES sites an SM a site takes
    a lane per rate (the next power of two at or above the rates, at most
    8: a larger C loops its rates over the lanes), so a sweep's small
    tables fill the card; from there one lane a site.  The whole table is
    staged as one window where it fits REPLAY_STAGE_BYTES, else in windows
    of two buffers that fit it together, else (one op's matrices past it)
    none (:func:`replay_layout`)."""
    group = min(8, 1 << (rate_cats - 1).bit_length())
    lanes = group if sites < sms * REPLAY_FILL_SITES else 1
    n_ops = max(n_ops, 1)
    window = 0
    if _stage_bytes(n_ops, rate_cats, states, itemsize) <= REPLAY_STAGE_BYTES:
        window = n_ops
    else:
        while 2 * _stage_bytes(window + 1, rate_cats, states,
                               itemsize) <= REPLAY_STAGE_BYTES:
            window += 1
    return replay_layout(sites, rate_cats, states, lanes, window, n_ops,
                         itemsize)


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index
                                            ).multi_processor_count


def replay_ops(clv, scalers, ops, pmatrix, scale_mode=SCALE_PER_SITE):
    """U1: execute an op table in place with JAX's sequential result
    (arguments as :func:`update_partials_by_op`; ``ops`` a host table, or
    an int32 [n, 8] tensor on the buffers' card whose indices the caller
    vouches for, as the branch-length sweep's device tables).  CUDA tensors
    take one launch of ``csrc/partials.cu`` on the current stream, laid
    out by :func:`replay_plan`, with no host read; CPU tensors
    :func:`update_partials`."""
    check_full_precision(clv, "update_partials")
    if clv.device.type == "cpu":
        if torch.is_tensor(ops):
            ops = ops.numpy()
        update_partials(clv, scalers, ops, pmatrix, scale_mode)
        return
    _check_replay(clv, scalers, pmatrix, scale_mode)
    if torch.is_tensor(ops):
        _require(ops.dtype == torch.int32 and ops.device == clv.device
                 and ops.dim() == 2 and ops.shape[1] == 8
                 and ops.is_contiguous(),
                 f"op table {tuple(ops.shape)} {ops.dtype} on {ops.device}: "
                 f"int32 [n, 8] on {clv.device}, contiguous")
        table = ops
    else:
        table = _host_table(ops, clv, scalers, pmatrix, scale_mode)
    if table.shape[0] == 0:
        return
    _, c, s, length = clv.shape
    plan = replay_plan(length, c, s, _sms(clv.device.index or 0),
                       table.shape[0], clv.element_size())
    lib = load_kernels()
    with torch.cuda.device(clv.device):
        rc = getattr(lib, "replay_ops_f64" if clv.dtype == torch.float64
                     else "replay_ops_f32")(
            clv.data_ptr(), scalers.data_ptr(), pmatrix.data_ptr(),
            table.data_ptr(), table.shape[0], c, s, length, scale_mode,
            _dummy(scalers, scale_mode), plan.lanes, plan.window,
            plan.grid, plan.smem,
            torch.cuda.current_stream(clv.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"replay_ops launch failed: CUDA error {rc} "
                          f"({lib.replay_error_string(rc).decode()})")
    _replay_ops.launches += 1


replay_ops.launches = 0
_replay_ops = replay_ops  # counts even while a caller wraps replay_ops
