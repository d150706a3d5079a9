"""Schedule-as-data incremental evaluation: the device half of tree
search's batched SPR/NNI candidate scoring.

Counterpart: ``libpll_tpu/ops/incremental.py`` (``pad_op_table`` ``:41``,
``encode_candidate_ops`` ``:55``, ``make_candidate_scorer`` ``:96``).
After a topology move only O(depth) CLVs change (``tree/incremental.py``
finds the minimal post-order subset).  A candidate is scored from that
subset without touching the base buffers: its ops land in scratch rows,
children are read from base or scratch by row id, and its changed branch
lengths give new P-matrices laid over the base set for it alone.

Row encoding (per candidate), as JAX's:
  * CLV row r:    r < N -> base ``clv[r]``; r >= N -> scratch row r - N.
  * scaler row s: s <= NS -> base ``scalers[s]`` (NS is the always-zero
    dummy); s > NS -> scratch row s - NS - 1.
Op k of a subset writes CLV row ``N + k`` and scaler row ``NS + 1 + k``;
pad rows repeat the last op (recomputing it is idempotent).

A batch of B candidates is one :func:`~.pmatrix.compute_pmatrices` call
for all B×U branch lengths and one :func:`score_candidates`: on CUDA
tensors the scoring instance of kernel C1 (``csrc/partials.cu``), which
computes what JAX's ``lax.map`` body computes (``:149-197``), each
candidate's replay and then its edge log-likelihood, in one launch with no
host read; on CPU tensors its plain version :func:`score_candidates_plain`
(:func:`replay_candidates_plain` into scratch rows, then the edge fold
:func:`~.likelihood.edge_loglikelihood` with a leading batch axis).  The
kernel keeps the rows a candidate's later ops or its edge read in a small
pool in shared memory: :func:`plan_candidates` (host, numpy, once a batch)
gives each op's parent a slot, first fit in op order, freed after its last
read, and sends rows past the pool to spill rows in device memory;
:func:`score_layout` sizes the site tile so that the slots fit a block;
:func:`plain_walk` is the plan walked by plain PyTorch.  A block is one
candidate by one site tile, the candidates of a tile in adjacent blocks
(they read the same base rows, once from device memory and then from
L2); each tile's log-likelihood goes to a float64 partial, summed in a
fixed order, and the asc pseudo-columns' per-rate terms to the PyTorch
tail :func:`~.likelihood.asc_correction_terms`.  The replay instance,
:func:`replay_candidates`, writes every op's parent to its scratch row
(column 0 − N, JAX's loop index k for the encoded ops) as C1 always
has; the checks of its rows and counters use it.  An op equal to the one
before it whose parent row and scaler are none of its inputs is skipped
(U1's rule), so a padded table costs its real ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..errors import CapacityError, EinvalError, KernelError
from ..utils.constants import SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE

REPLAY_TILE = 128  # sites a block of C1's replay instance (kReplayBlock)
POOL_SOFT_SMEM = 48 * 1024  # a block's pool below this: four blocks an SM
SRC_BASE, SRC_OVERLAY, SRC_POOL, SRC_SPILL = 0, 1, 2, 3  # descriptor kinds
SRC_BITS = 28  # a descriptor is kind << SRC_BITS | index
from . import clv as clv_ops
from . import likelihood as lk_ops
from .derivatives import check_full_precision
from .pmatrix import compute_pmatrices


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


def encode_candidate_ops(operations, n_nodes: int, n_scale_buffers: int,
                         capacity: int):
    """Translate a partial-traversal op list into the scratch-row encoding.

    The k-th op's parent lands in scratch rows (CLV row ``N + k``, scaler
    row ``NS + 1 + k``); child/scaler references to a parent recomputed
    earlier in the same subset are redirected to its scratch row, and
    "no scaler" (-1) maps to the base dummy row ``NS``.

    Returns (table [capacity, 8] int32, row_of, scal_of) where the dicts
    map original clv/scaler indices to encoded rows — used to locate the
    evaluation edge (fall back to the base row for untouched nodes).
    """
    from ..engine.partition import Operation

    N, NS = n_nodes, n_scale_buffers
    row_of = {}
    scal_of = {}
    rows = []
    for k, op in enumerate(operations):
        t = op.as_tuple() if isinstance(op, Operation) else tuple(op)
        (p, ps, c1, m1, s1, c2, m2, s2) = t

        def crow(c):
            return row_of.get(c, c)

        def srow(s):
            if s < 0:
                return NS  # dummy (always-zero)
            return scal_of.get(s, s)

        enc_ps = NS if ps < 0 else NS + 1 + k
        rows.append((N + k, enc_ps, crow(c1), m1, srow(s1),
                     crow(c2), m2, srow(s2)))
        row_of[p] = N + k
        if ps >= 0:
            scal_of[ps] = NS + 1 + k
    table = pad_op_table(np.asarray(rows, np.int32), capacity)
    return table, row_of, scal_of


# --------------------------------------------------------------------------
# the replay of B candidates' op subsets into scratch rows
# --------------------------------------------------------------------------
def _repeats(op, prev, scaled: bool) -> bool:
    """C1's (and U1's) skipped op: the one before it again, reading
    neither its own parent row nor its own scaler row."""
    p, ps, c1, _, s1, c2, _, s2 = op
    return (op == prev and p not in (c1, c2)
            and not (scaled and ps in (s1, s2)))


def _scratch(clv, scalers, batch: int, rows: int, scale_mode: int):
    """Uninitialised scratch CLV rows [B, R, C, S, L] and scaler rows
    [B, R, (C,) L] (empty without scaling)."""
    scal_shape = ((batch, rows) + tuple(scalers.shape[1:])
                  if scale_mode != SCALE_NONE else (0,))
    return (clv.new_empty((batch, rows) + tuple(clv.shape[1:])),
            torch.empty(scal_shape, dtype=torch.int32, device=clv.device))


def replay_candidates_plain(clv, scalers, pmatrix, tables, upd_midx,
                            upd_pmatrix, rows: int, scale_mode: int):
    """C1's plain version: each candidate's ops in order, one op at a
    time, on the base buffers (read only) and the candidate's scratch.
    Returns (scratch [B, R, C, S, L], scaler scratch [B, R, (C,) L]); rows
    no op writes stay zero."""
    tables = np.asarray(tables.cpu() if torch.is_tensor(tables) else tables)
    midx = np.asarray(upd_midx.cpu() if torch.is_tensor(upd_midx)
                      else upd_midx)
    n, ns = clv.shape[0], scalers.shape[0] - 1
    scratch, scal_scratch = _scratch(clv, scalers, tables.shape[0], rows,
                                     scale_mode)
    scratch.zero_()
    scal_scratch.zero_()
    for b in range(tables.shape[0]):
        pm = pmatrix.clone()
        for u, m in enumerate(midx[b].tolist()):
            pm[m] = upd_pmatrix[b, u]  # the last of a repeated slot wins

        def row(r):
            return clv[r] if r < n else scratch[b, r - n]

        def srow(s):
            return scalers[s] if s <= ns else scal_scratch[b, s - ns - 1]

        prev = None
        for op in tables[b].tolist():
            p, ps, c1, m1, s1, c2, m2, s2 = op
            scaled = scale_mode != SCALE_NONE and ps != ns
            if prev is not None and _repeats(op, prev, scaled):
                continue
            prev = op
            x = torch.matmul(pm[m1], row(c1)).mul_(
                torch.matmul(pm[m2], row(c2)))
            if scaled:
                mask = clv_ops._scale_in_place(x, scale_mode)
                scal_scratch[b, ps - ns - 1] = srow(s1) + srow(s2) + mask
            scratch[b, p - n] = x
    return scratch, scal_scratch


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """C1 lives in ``csrc/partials.cu`` beside U1: the same library,
    built and loaded once per process."""
    lib = clv_ops.load_kernels()
    for name in ("candidates_f32", "candidates_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.candidates_smem_limit.argtypes = [ctypes.c_void_p]
    lib.candidates_smem_limit.restype = ctypes.c_int
    return lib


def _args_struct(real):
    """The ctypes mirror of ``CandidateArgs<T>`` (csrc/partials.cu), field
    for field, for T = ``real`` (c_float or c_double)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fields = [(n, P) for n in (
        "clv", "scalers", "pmatrix", "tables", "eval", "upd_midx",
        "upd_pmatrix", "scratch", "scal_scratch", "freqs", "rate_weights",
        "prop_invar", "invariant", "pattern_weights", "partials",
        "asc_terms", "asc_scal")]
    fields += [(n, real) for n in ("thresh", "factor", "log_scale")]
    fields += [("sites", ctypes.c_int64), ("real_sites", ctypes.c_int64)]
    fields += [(n, I) for n in (
        "n_ops", "n_upd", "rows", "n_nodes", "dummy", "rate_cats", "states",
        "scale_mode", "batch", "slots", "sp")]
    return type("CandidateArgs", (ctypes.Structure,), {"_fields_": fields})


_ARGS = {torch.float32: _args_struct(ctypes.c_float),
         torch.float64: _args_struct(ctypes.c_double)}


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    """The dynamic shared memory a C1 block may ask for on a card."""
    lib = load_kernels()
    out = ctypes.c_int()
    with torch.cuda.device(device_index):
        rc = lib.candidates_smem_limit(ctypes.byref(out))
    _launch_check(lib, rc, "candidates_smem_limit")
    return out.value


def _launch_check(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name} failed: CUDA error {rc} "
                          f"({lib.replay_error_string(rc).decode()})")


def _launch(args: dict, dtype, score: bool, tile: int, smem: int,
            device) -> None:
    """One launch of C1's instance on the current stream of ``device``;
    ``args`` the struct's fields by name (pointers as ints)."""
    lib = load_kernels()
    struct = _ARGS[dtype](**args)
    fn = lib.candidates_f64 if dtype == torch.float64 else lib.candidates_f32
    with torch.cuda.device(device):
        rc = fn(ctypes.addressof(struct), int(score), tile, smem,
                torch.cuda.current_stream(device).cuda_stream)
    _launch_check(lib, rc, "score_candidates launch" if score
                  else "replay_candidates launch")


def _padded(pmatrix, upd_pmatrix):
    """(base, overlay, sp): the P-matrices as C1's instance reads them:
    rows of S at S = 4 and S = 20, else padded with zeros to whole
    16-byte vectors (``clv_fused.pad_rows``, the any-alphabet op's
    layout), ``sp`` values a row."""
    from .clv_fused import KERNEL_STATES, pad_rows

    s = pmatrix.shape[-1]
    if s in KERNEL_STATES:
        return pmatrix, upd_pmatrix, s
    pm = pad_rows(pmatrix)
    return pm, pad_rows(upd_pmatrix), pm.shape[-1]


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"score_candidates input: {what}")


def _check_device_inputs(clv, scalers, pmatrix, tables, upd_midx,
                         upd_pmatrix, scale_mode) -> None:
    """Raise on what C1 does not take: dtypes, shapes, contiguity,
    devices (the base buffers as U1 takes them)."""
    clv_ops._check_replay(clv, scalers, pmatrix, scale_mode)
    device, dtype = clv.device, clv.dtype
    _, c, s, _ = clv.shape
    for name, t in (("tables", tables), ("upd_midx", upd_midx)):
        _require(t.dtype == torch.int32 and t.device == device
                 and t.is_contiguous(),
                 f"{name} {t.dtype} on {t.device}: int32 on {device}, "
                 f"contiguous")
    b = tables.shape[0]
    _require(tables.dim() == 3 and tables.shape[1] >= 1
             and tables.shape[2] == 8 and 1 <= b <= 65535,
             f"tables {tuple(tables.shape)}: [B, K, 8], 1 <= B <= 65535")
    _require(upd_midx.dim() == 2 and upd_midx.shape[0] == b,
             f"upd_midx {tuple(upd_midx.shape)}: [{b}, U]")
    _require(upd_pmatrix.dtype == dtype and upd_pmatrix.device == device
             and tuple(upd_pmatrix.shape) == (b, upd_midx.shape[1], c, s, s)
             and upd_pmatrix.is_contiguous(),
             f"upd_pmatrix {tuple(upd_pmatrix.shape)} {upd_pmatrix.dtype}: "
             f"[{b}, {upd_midx.shape[1]}, {c}, {s}, {s}] {dtype}, "
             f"contiguous")


def replay_candidates(clv, scalers, pmatrix, tables, upd_midx, upd_pmatrix,
                      rows: int, scale_mode: int):
    """C1's replay instance: replay B candidates' op tables (int32
    [B, K, 8] in the scratch-row encoding) with their P-matrix overlays
    (``upd_midx`` int32 [B, U], ``upd_pmatrix`` [B, U, C, S, S]) into
    fresh scratch rows; returns (scratch [B, R, C, S, L], scaler scratch
    [B, R, (C,) L]).  ``rows`` (R) bounds every op's parent row: column 0
    − N < R.  The base buffers are read only.  CUDA tensors take one
    launch of ``csrc/partials.cu`` on the current stream, with no host
    read (the caller vouches for the tables' indices: :func:`check_tables`
    checks host ones); CPU tensors :func:`replay_candidates_plain`.
    Counts its launches in ``replay_candidates.launches``.  The scorer
    does not call it: it runs the scoring instance
    (:func:`score_candidates`), which keeps the rows on chip; the checks
    of rows and counters call this one."""
    check_full_precision(clv, "score_candidates")
    if clv.device.type == "cpu":
        return replay_candidates_plain(clv, scalers, pmatrix, tables,
                                       upd_midx, upd_pmatrix, rows,
                                       scale_mode)
    _check_device_inputs(clv, scalers, pmatrix, tables, upd_midx,
                         upd_pmatrix, scale_mode)
    _require(rows >= 1, f"rows {rows}")
    b, k, _ = tables.shape
    scratch, scal_scratch = _scratch(clv, scalers, b, rows, scale_mode)
    _, c, s, length = clv.shape
    scaled = scale_mode != SCALE_NONE
    pmatrix, upd_pmatrix, sp = _padded(pmatrix, upd_pmatrix)
    _launch(dict(
        clv=clv.data_ptr(), scalers=scalers.data_ptr() if scaled else None,
        pmatrix=pmatrix.data_ptr(), tables=tables.data_ptr(),
        upd_midx=upd_midx.data_ptr(), upd_pmatrix=upd_pmatrix.data_ptr(),
        scratch=scratch.data_ptr(),
        scal_scratch=scal_scratch.data_ptr() if scaled else None,
        sites=length, real_sites=length, n_ops=k, n_upd=upd_midx.shape[1],
        rows=rows, n_nodes=clv.shape[0],
        dummy=clv_ops._dummy(scalers, scale_mode), rate_cats=c, states=s,
        scale_mode=scale_mode, batch=b, sp=sp), clv.dtype, False,
        REPLAY_TILE, 0, clv.device)
    _replay_candidates.launches += 1
    return scratch, scal_scratch


replay_candidates.launches = 0
_replay_candidates = replay_candidates  # counts while a caller wraps it


def check_tables(tables, upd_midx, eval_rows, *, n_nodes: int,
                 n_scale_buffers: int, n_matrices: int, capacity: int,
                 scale_mode: int) -> int:
    """Check host tables against the buffers' extents, as
    ``ops/clv._host_table`` does for U1, and return the scratch rows they
    need: the largest parent row − N + 1."""
    N, NS = n_nodes, n_scale_buffers
    tables = np.asarray(tables, np.int64)
    _require(tables.ndim == 3 and tables.shape[1:] == (capacity, 8),
             f"tables {tables.shape}: [B, {capacity}, 8]")
    rows = int(tables[:, :, 0].max()) - N + 1
    _require(int(tables[:, :, 0].min()) >= N and rows <= capacity,
             f"op table column 0 outside [{N}, {N + capacity})")
    limits = [(2, N + rows), (5, N + rows), (3, n_matrices),
              (6, n_matrices)]
    if scale_mode != SCALE_NONE:
        limits += [(k, NS + 1 + rows) for k in (1, 4, 7)]
    for col, hi in limits:
        _require(bool(((tables[:, :, col] >= 0)
                       & (tables[:, :, col] < hi)).all()),
                 f"op table column {col} outside [0, {hi})")
    midx = np.asarray(upd_midx, np.int64)
    _require(midx.ndim == 2 and midx.shape[0] == tables.shape[0]
             and bool(((midx >= 0) & (midx < n_matrices)).all()),
             f"upd_midx {midx.shape} outside [0, {n_matrices})")
    er = np.asarray(eval_rows, np.int64)
    _require(er.shape == (tables.shape[0], 5),
             f"eval_rows {er.shape}: [{tables.shape[0]}, 5]")
    limits = [(0, N + rows), (2, N + rows), (4, n_matrices)]
    if scale_mode != SCALE_NONE:
        limits += [(1, NS + 1 + rows), (3, NS + 1 + rows)]
    for col, hi in limits:
        _require(bool(((er[:, col] >= 0) & (er[:, col] < hi)).all()),
                 f"eval_rows column {col} outside [0, {hi})")
    return rows


def _fetch(base, scratch, rows, first: int):
    """Rows of ``base`` (index < first) or of each candidate's scratch
    (index − first), gathered on the device: [B, ...]."""
    b = torch.arange(rows.shape[0], device=rows.device)
    from_base = base.index_select(0, rows.clamp(0, base.shape[0] - 1))
    from_scratch = scratch[b, (rows - first).clamp(0, scratch.shape[1] - 1)]
    keep = (rows < first).reshape((-1,) + (1,) * (base.dim() - 1))
    return torch.where(keep, from_base, from_scratch)


# --------------------------------------------------------------------------
# the scoring instance: its plan, layout, plain walk and wrapper
# --------------------------------------------------------------------------
class CandidatePlan(NamedTuple):
    """C1's plan of one batch (:func:`plan_candidates`): ``ops`` int32
    [B, K, 8] and ``eval`` int32 [B, 5] descriptors (``kind << SRC_BITS |
    index``: a base row, scaler or matrix, an overlay slot, a pool slot or
    a spill row; ``ops[..., 0] = -1`` skips an op, ``ops[..., 1] = -1``
    means it owns no scaler), ``slots`` the pool slots it uses (the peak
    over the batch), ``spills`` the rows it sends to spill rows, ``rows``
    the spill rows a candidate (0: none used), ``live`` the ops it runs."""
    ops: np.ndarray
    eval: np.ndarray
    slots: int
    spills: int
    rows: int
    live: int


def _src(kind, index):
    return (np.int64(kind) << SRC_BITS) | index


def _matrix_src(m: np.ndarray, midx: np.ndarray) -> np.ndarray:
    """Matrix descriptors of ``m`` [B, ...]: the candidate's last overlay
    slot that names the matrix, else the base's."""
    if midx.shape[1] == 0:
        return m
    hits = midx.reshape((midx.shape[0],) + (1,) * (m.ndim - 1) + (-1,)) \
        == m[..., None]
    last = hits.shape[-1] - 1 - np.argmax(hits[..., ::-1], axis=-1)
    return np.where(hits.any(-1), _src(SRC_OVERLAY, last), m)


def plan_candidates(tables, upd_midx, eval_rows, *, n_nodes: int,
                    n_scale_buffers: int, scale_mode: int,
                    pool=None) -> CandidatePlan:
    """Plan C1's scoring instance over host tables (int [B, K, 8] in the
    scratch-row encoding), overlay slots [B, U] and edges [B, 5] (pure,
    numpy, vectorised over the batch).

    An op runs if it is not a skipped repeat (U1's rule) and a later op
    that runs, or the edge, reads its CLV row or its scaler row before the
    row is written again.  Its parent (CLV row and scaler together) takes
    the first pool slot free by then, in op order; a slot frees after its
    occupant's last read, so an op may write over a child it reads last
    (a site's child values are read before its parent's are written).
    With ``pool`` slots (None: as many as needed) an op that finds none
    free goes to the spill rows (its CLV row − N, its scaler row − NS −
    1), as does a read of a row no op of the table wrote."""
    t = np.asarray(tables, np.int64)
    midx = np.asarray(upd_midx, np.int64)
    er = np.asarray(eval_rows, np.int64)
    B, K, _ = t.shape
    N, NS = n_nodes, n_scale_buffers
    scaling = scale_mode != SCALE_NONE
    p, ps, c1, s1, c2, s2 = (t[..., i] for i in (0, 1, 2, 4, 5, 7))
    scaled = (ps != NS) & scaling
    reads_own = (p == c1) | (p == c2) | (scaled & ((ps == s1) | (ps == s2)))
    real = np.ones((B, K), bool)
    real[:, 1:] = ~((t[:, 1:] == t[:, :-1]).all(-1) & ~reads_own[:, 1:])
    R = max(int(p.max()) - N + 1, 1)
    K = int(np.nonzero(real.any(0))[0].max()) + 1  # the rest repeat
    t, real, scaled = t[:, :K], real[:, :K], scaled[:, :K]
    p, ps, c1, s1, c2, s2 = (t[..., i] for i in (0, 1, 2, 4, 5, 7))
    ks = np.arange(K)
    bi = np.arange(B)[:, None]

    # every read, of the ops' children and then of the edge, with the
    # position it happens at (K: the edge) and the op whose version it
    # sees: the last real op before it that writes that row, or -1
    at = np.concatenate([np.repeat(ks, 2), [K, K]])
    rows_c = np.concatenate([np.stack([c1, c2], -1).reshape(B, -1),
                             er[:, [0, 2]]], 1)
    rows_s = np.concatenate([np.stack([s1, s2], -1).reshape(B, -1),
                             er[:, [1, 3]]], 1)

    def writers(rows, outs, writes):
        hit = ((rows[:, :, None] == outs[:, None, :]) & writes[:, None, :]
               & (ks[None, None, :] < at[None, :, None]))
        return np.where(hit.any(-1), K - 1 - np.argmax(hit[..., ::-1], -1),
                        -1)

    wc = writers(rows_c, p, real)
    ws = writers(rows_s, ps, real & scaled)

    # an op runs if a read that happens (by the edge, or by an op that
    # runs) sees its version; reader: the last such read's position
    run = real
    while True:
        on = np.concatenate([np.repeat(run, 2, axis=1),
                             np.ones((B, 2), bool)], 1)
        reader = np.full((B, K), -1)
        for w, active in ((wc, on), (ws, on & (np.concatenate(
                [np.repeat(scaled, 2, axis=1), np.full((B, 2), scaling)],
                1)))):
            sel = active & (w >= 0)
            np.maximum.at(reader, (np.broadcast_to(bi, w.shape)[sel],
                                   w[sel]), np.broadcast_to(at, w.shape)[sel])
        now = real & (reader > ks)
        if np.array_equal(now, run):
            break
        run = now

    # first fit, in op order
    cap = K if pool is None else int(pool)
    free_at = np.full((B, max(cap, 1)), -1 if cap else K + 1)
    slot_of = np.full((B, K), -1)
    rows_b = np.arange(B)
    for k in range(K):
        avail = free_at <= k
        slot = avail.argmax(1)
        into = run[:, k] & avail[rows_b, slot]
        free_at[rows_b[into], slot[into]] = reader[into, k]
        slot_of[into, k] = slot[into]
    pooled = slot_of >= 0
    dst = np.where(pooled, _src(SRC_POOL, slot_of), _src(SRC_SPILL, p - N))
    sdst = np.where(pooled, _src(SRC_POOL, slot_of),
                    _src(SRC_SPILL, ps - NS - 1))
    src_c = np.where(wc >= 0, np.take_along_axis(dst, np.maximum(wc, 0), 1),
                     np.where(rows_c < N, rows_c, _src(SRC_SPILL, rows_c - N)))
    src_s = np.where(ws >= 0, np.take_along_axis(sdst, np.maximum(ws, 0), 1),
                     np.where(rows_s <= NS, rows_s,
                              _src(SRC_SPILL, rows_s - NS - 1)))
    desc = np.full((B, K, 8), -1, np.int64)
    desc[..., 0] = np.where(run, dst, -1)
    desc[..., 1] = np.where(run & scaled, sdst, -1)
    desc[..., 2], desc[..., 5] = src_c[:, :2 * K:2], src_c[:, 1:2 * K:2]
    if scaling:
        desc[..., 4], desc[..., 7] = src_s[:, :2 * K:2], src_s[:, 1:2 * K:2]
    desc[..., 3] = _matrix_src(t[..., 3], midx)
    desc[..., 6] = _matrix_src(t[..., 6], midx)
    ev = np.zeros((B, 5), np.int64)
    ev[:, 0], ev[:, 2] = src_c[:, 2 * K], src_c[:, 2 * K + 1]
    if scaling:
        ev[:, 1], ev[:, 3] = src_s[:, 2 * K], src_s[:, 2 * K + 1]
    ev[:, 4] = _matrix_src(er[:, 4], midx)
    keep = int(np.nonzero(run.any(0))[0].max()) + 1 if run.any() else 1
    used = np.concatenate([desc[run][:, [0, 1, 2, 4, 5, 7]].ravel(),
                           ev[:, :4].ravel()])
    spilled = bool(((used >= 0) & ((used >> SRC_BITS) == SRC_SPILL)).any())
    return CandidatePlan(desc[:, :keep].astype(np.int32),
                         ev.astype(np.int32),
                         int(slot_of.max()) + 1 if pooled.any() else 0,
                         int((run & ~pooled).sum()), R if spilled else 0,
                         int(run.sum()))


def score_layout(itemsize: int, rate_cats: int, states: int,
                 scale_mode: int, slots: int, smem_limit: int):
    """(tile, slots, smem) of C1's scoring instance (pure): the largest
    site tile of 128, 64 or 32 whose ``slots`` pool slots (C·S values and
    the counters of a site each) stay under POOL_SOFT_SMEM, else a tile of
    32 with as many slots as ``smem_limit`` holds (the rest spill)."""
    counters = (0 if scale_mode == SCALE_NONE else
                rate_cats if scale_mode == SCALE_PER_RATE else 1)
    per_site = rate_cats * states * itemsize + 4 * counters
    for tile in (128, 64, 32):
        if slots * per_site * tile <= POOL_SOFT_SMEM:
            return tile, slots, slots * per_site * tile
    fit = min(slots, smem_limit // (per_site * 32))
    return 32, fit, fit * per_site * 32


def plain_walk(plan: CandidatePlan, clv, scalers, pmatrix, upd_pmatrix,
               model, *, sites: int, scale_mode: int, asc_mode: int):
    """The scoring instance's walk in plain PyTorch: each candidate's ops
    by their descriptors over its own pool (slots of whole rows) and spill
    rows, then its edge fold (:func:`~.likelihood.edge_loglikelihood`);
    logL [B] in the buffers' dtype."""
    dtype, device = clv.dtype, clv.device
    ops, ev = plan.ops.astype(np.int64), plan.eval.astype(np.int64)
    c, s, length = clv.shape[1:]
    sshape = tuple(scalers.shape[1:]) if scale_mode != SCALE_NONE else (
        length,)
    mask = (1 << SRC_BITS) - 1
    out = []
    for b in range(ops.shape[0]):
        store = {SRC_POOL: (clv.new_zeros((plan.slots, c, s, length)),
                            torch.zeros((plan.slots,) + sshape,
                                        dtype=torch.int32, device=device)),
                 SRC_SPILL: (clv.new_zeros((plan.rows, c, s, length)),
                             torch.zeros((plan.rows,) + sshape,
                                         dtype=torch.int32, device=device))}

        def row(d, k=0):  # k 0: the CLV row, 1: the scaler row
            kind, i = int(d) >> SRC_BITS, int(d) & mask
            if kind == SRC_BASE:
                return (clv, scalers)[k][i]
            return store[kind][k][i]

        def matrix(d):
            kind, i = int(d) >> SRC_BITS, int(d) & mask
            return upd_pmatrix[b, i] if kind == SRC_OVERLAY else pmatrix[i]

        for op in ops[b]:
            if op[0] < 0:
                continue
            x = torch.matmul(matrix(op[3]), row(op[2])).mul_(
                torch.matmul(matrix(op[6]), row(op[5])))
            if op[1] >= 0:
                sc = row(op[4], 1) + row(op[7], 1)
                sc = sc + clv_ops._scale_in_place(x, scale_mode)
                row(op[1], 1).copy_(sc)
            row(op[0]).copy_(x)
        if scale_mode == SCALE_NONE:
            sp = sc = torch.zeros(length, dtype=torch.int32, device=device)
        else:
            sp, sc = row(ev[b, 1], 1), row(ev[b, 3], 1)
        out.append(lk_ops.edge_loglikelihood(
            row(ev[b, 0]), row(ev[b, 2]), sp, sc, matrix(ev[b, 4]),
            model["freqs_pc"].to(dtype), model["rate_weights"].to(dtype),
            model["pattern_weights"].to(dtype),
            model["prop_invar_pc"].to(dtype), model["invariant"],
            sites=sites, per_rate=scale_mode == SCALE_PER_RATE,
            asc_mode=asc_mode)[0])
    return torch.stack(out)


def score_candidates_plain(clv, scalers, pmatrix, model, tables, upd_midx,
                           eval_rows, upd_pmatrix, *, n_scale_buffers: int,
                           sites: int, scale_mode: int, asc_mode: int,
                           rows: int):
    """C1's scoring instance's plain version: :func:`replay_candidates_plain`
    into scratch rows, then the edge fold with a leading batch axis; host
    ``tables``/``upd_midx``/``eval_rows``; logL [B]."""
    N, NS = clv.shape[0], n_scale_buffers
    device = clv.device
    tables, upd_midx, eval_rows = (
        torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
        for a in (tables, upd_midx, eval_rows))
    b, u = upd_midx.shape
    scratch, scal_scratch = replay_candidates_plain(
        clv, scalers, pmatrix, tables, upd_midx, upd_pmatrix, rows,
        scale_mode)
    er = eval_rows.long()
    parent = _fetch(clv, scratch, er[:, 0], N)
    child = _fetch(clv, scratch, er[:, 2], N)
    if scale_mode == SCALE_NONE:
        sp = sc = torch.zeros((b, clv.shape[-1]), dtype=torch.int32,
                              device=device)
    else:
        sp = _fetch(scalers, scal_scratch, er[:, 1], NS + 1)
        sc = _fetch(scalers, scal_scratch, er[:, 3], NS + 1)
    # the edge's matrix: the candidate's last overlay slot that names it,
    # else the base's
    hit = upd_midx.long() == er[:, 4:5]
    slot = torch.where(hit, torch.arange(u, device=device), -1).amax(dim=1)
    edge_pm = torch.where(
        (slot >= 0)[:, None, None, None],
        upd_pmatrix[torch.arange(b, device=device), slot.clamp(min=0)],
        pmatrix.index_select(0, er[:, 4]))
    dtype = clv.dtype
    return lk_ops.edge_loglikelihood(
        parent, child, sp, sc, edge_pm, model["freqs_pc"].to(dtype),
        model["rate_weights"].to(dtype), model["pattern_weights"].to(dtype),
        model["prop_invar_pc"].to(dtype), model["invariant"], sites=sites,
        per_rate=scale_mode == SCALE_PER_RATE, asc_mode=asc_mode)[0]


def plan_for(clv, tables, upd_midx, eval_rows, *, n_scale_buffers: int,
             scale_mode: int):
    """(plan, (tile, slots, smem)) of one batch on ``clv``'s card: the
    plan with as many slots as it needs, re-planned with fewer where a
    block's shared memory holds fewer."""
    kw = dict(n_nodes=clv.shape[0], n_scale_buffers=n_scale_buffers,
              scale_mode=scale_mode)
    plan = plan_candidates(tables, upd_midx, eval_rows, **kw)
    layout = score_layout(clv.element_size(), clv.shape[1], clv.shape[2],
                          scale_mode, plan.slots,
                          _smem_limit(clv.device.index or 0))
    if layout[1] < plan.slots:
        plan = plan_candidates(tables, upd_midx, eval_rows, pool=layout[1],
                               **kw)
    return plan, layout


def score_candidates(clv, scalers, pmatrix, model, tables, upd_midx,
                     eval_rows, upd_pmatrix, *, n_scale_buffers: int,
                     sites: int, scale_mode: int, asc_mode: int, rows: int):
    """C1's scoring instance: B candidates' log-likelihoods [B] from the
    base buffers (read only), host ``tables`` [B, K, 8], ``upd_midx``
    [B, U] and ``eval_rows`` [B, 5] (checked by :func:`check_tables`) and
    the overlay ``upd_pmatrix`` [B, U, C, S, S] on the buffers' device.
    CUDA tensors: :func:`plan_for`, then one launch of ``csrc/partials.cu``
    on the current stream (the asc tail in PyTorch), no host read; counts
    its launches in ``score_candidates.launches``.  CPU tensors:
    :func:`score_candidates_plain`."""
    check_full_precision(clv, "score_candidates")
    kw = dict(n_scale_buffers=n_scale_buffers, sites=sites,
              scale_mode=scale_mode, asc_mode=asc_mode, rows=rows)
    if clv.device.type == "cpu":
        return score_candidates_plain(clv, scalers, pmatrix, model, tables,
                                      upd_midx, eval_rows, upd_pmatrix, **kw)
    device, dtype = clv.device, clv.dtype
    clv_ops._check_replay(clv, scalers, pmatrix, scale_mode)
    _require(upd_pmatrix.dtype == dtype and upd_pmatrix.device == device
             and tuple(upd_pmatrix.shape) == tuple(np.shape(upd_midx))
             + tuple(pmatrix.shape[1:]) and upd_pmatrix.is_contiguous(),
             f"upd_pmatrix {tuple(upd_pmatrix.shape)} {upd_pmatrix.dtype}: "
             f"[B, U, C, S, S] {dtype} on {device}, contiguous")
    plan, (tile, slots, smem) = plan_for(
        clv, tables, upd_midx, eval_rows, n_scale_buffers=n_scale_buffers,
        scale_mode=scale_mode)
    b = plan.ops.shape[0]
    _, c, s, length = clv.shape
    ops, ev = (torch.from_numpy(a).to(device) for a in (plan.ops, plan.eval))
    scratch, scal_scratch = (_scratch(clv, scalers, b, plan.rows, scale_mode)
                             if plan.rows else (None, None))
    tiles = -(-length // tile)
    partials = torch.empty((b, tiles), dtype=torch.float64, device=device)
    n_asc = length - sites
    asc_terms = clv.new_empty((b, c, n_asc)) if n_asc else None
    asc_scal = (torch.empty((b, n_asc), dtype=torch.int32, device=device)
                if n_asc else None)
    f = {k: model[k].to(dtype).contiguous()
         for k in ("freqs_pc", "rate_weights", "prop_invar_pc",
                   "pattern_weights")}
    invariant = model["invariant"].to(device, torch.int32).contiguous()
    _require(f["pattern_weights"].numel() == length
             and invariant.numel() == length
             and f["freqs_pc"].shape == (c, s),
             f"model vectors of {length} sites and [{c}, {s}] frequencies")
    scaled = scale_mode != SCALE_NONE

    def ptr(x):
        return None if x is None or not x.numel() else x.data_ptr()

    pmatrix, upd_pmatrix, sp = _padded(pmatrix, upd_pmatrix)
    _launch(dict(
        clv=clv.data_ptr(), scalers=scalers.data_ptr() if scaled else None,
        pmatrix=pmatrix.data_ptr(), tables=ops.data_ptr(),
        eval=ev.data_ptr(), upd_pmatrix=ptr(upd_pmatrix),
        scratch=ptr(scratch), scal_scratch=ptr(scal_scratch),
        freqs=f["freqs_pc"].data_ptr(),
        rate_weights=f["rate_weights"].data_ptr(),
        prop_invar=f["prop_invar_pc"].data_ptr(),
        invariant=invariant.data_ptr(),
        pattern_weights=f["pattern_weights"].data_ptr(),
        partials=partials.data_ptr(), asc_terms=ptr(asc_terms),
        asc_scal=ptr(asc_scal), log_scale=lk_ops.log_scale_threshold(dtype),
        sites=length, real_sites=sites, n_ops=ops.shape[1],
        n_upd=upd_pmatrix.shape[1], rows=plan.rows, n_nodes=clv.shape[0],
        dummy=n_scale_buffers if scaled else 0, rate_cats=c, states=s,
        scale_mode=scale_mode, batch=b, slots=slots, sp=sp), dtype, True,
        tile, smem, device)
    _score_candidates.launches += 1
    logl = partials.sum(dim=1).to(dtype)
    if asc_mode:
        pw = f["pattern_weights"]
        logl = logl + lk_ops.asc_correction_terms(
            asc_terms, asc_scal, f["rate_weights"], pw[sites:],
            pw[:sites].sum(), asc_mode, dtype)
    return logl


score_candidates.launches = 0
_score_candidates = score_candidates  # counts while a caller wraps it


# --------------------------------------------------------------------------
# the scorer
# --------------------------------------------------------------------------
class CandidateScorer:
    """The batched candidate scorer of :func:`make_candidate_scorer`.

    ``score(clv, scalers, pmatrix, model, tables, upd_midx, upd_blens,
    eval_rows) -> logl [B]``, JAX's call:

      * ``clv`` [N, C, S, L], ``scalers`` [NS+1, (C,) L], ``pmatrix``
        [M, C, S, S] — the base state, read only;
      * ``tables`` int32 [B, capacity, 8] — the candidates' op subsets in
        the scratch-row encoding;
      * ``upd_midx``/``upd_blens`` [B, U] — each candidate's changed
        P-matrix slots and branch lengths, laid over the base matrices for
        it alone (a slot may repeat; the last wins);
      * ``eval_rows`` int32 [B, 5] — (parent_row, parent_scaler_row,
        child_row, child_scaler_row, edge_matrix) in the same encoding;
        the edge matrix may be an updated slot.

    The index arrays are host arrays: they are checked against the
    buffers' extents (:func:`check_tables`).  The batch's new P-matrices
    are one :func:`~.pmatrix.compute_pmatrices` call on the buffers'
    device, then :func:`score_candidates`: on the card C1's scoring
    instance (planned on the host, one launch, the asc tail) and no host
    read, on the CPU its plain version."""

    def __init__(self, n_nodes: int, n_scale_buffers: int, capacity: int,
                 *, sites: int, scale_mode: int, asc_mode: int):
        self.n_nodes = n_nodes
        self.n_scale_buffers = n_scale_buffers
        self.capacity = capacity
        self.sites = sites
        self.scale_mode = scale_mode
        self.asc_mode = asc_mode

    def __call__(self, clv, scalers, pmatrix, model, tables, upd_midx,
                 upd_blens, eval_rows):
        check_full_precision(clv, "score_candidates")
        dtype, device = clv.dtype, clv.device
        N, NS = self.n_nodes, self.n_scale_buffers
        _require(clv.shape[0] == N and clv.shape[-1] >= self.sites,
                 f"clv {tuple(clv.shape)}: [{N}, C, S, >= {self.sites}]")
        _require(self.scale_mode == SCALE_NONE or scalers.shape[0] == NS + 1,
                 f"scalers {tuple(scalers.shape)}: [{NS + 1}, ...]")
        rows = check_tables(tables, upd_midx, eval_rows, n_nodes=N,
                            n_scale_buffers=NS, n_matrices=pmatrix.shape[0],
                            capacity=self.capacity,
                            scale_mode=self.scale_mode)
        b, u = np.shape(upd_midx)
        blens = torch.as_tensor(upd_blens, dtype=dtype, device=device)
        new = compute_pmatrices(
            blens.reshape(-1), model["rates"].to(dtype),
            model["prop_invar"].to(dtype), model["params_indices"],
            model["eigenvals"].to(dtype), model["left"].to(dtype),
            model["right"].to(dtype), dtype=dtype)
        new = new.reshape((b, u) + tuple(pmatrix.shape[1:])).contiguous()
        return score_candidates(
            clv, scalers, pmatrix, model, tables, upd_midx, eval_rows, new,
            n_scale_buffers=NS, sites=self.sites, scale_mode=self.scale_mode,
            asc_mode=self.asc_mode, rows=rows)


def make_candidate_scorer(n_nodes: int, n_scale_buffers: int, capacity: int,
                          *, sites: int, scale_mode: int = SCALE_PER_SITE,
                          asc_mode: int = 0) -> CandidateScorer:
    """Build the batched candidate scorer (:class:`CandidateScorer`).

    Everything about a topology is data, so one scorer serves every
    topology of the same (N, NS, capacity, sites) envelope."""
    return CandidateScorer(n_nodes, n_scale_buffers, capacity, sites=sites,
                           scale_mode=scale_mode, asc_mode=asc_mode)
