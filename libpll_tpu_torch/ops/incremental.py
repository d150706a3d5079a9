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
for all B×U branch lengths, one :func:`replay_candidates` (kernel C1 of
``csrc/partials.cu`` on CUDA tensors: a thread owns (candidate, site) and
walks the candidate's ops, one launch a batch; its plain version
:func:`replay_candidates_plain` on CPU tensors) and one edge fold with a
leading batch axis (:func:`~.likelihood.edge_loglikelihood`, plain
PyTorch, as JAX's fold is plain XLA), with no host read.  JAX maps the candidates one at a time
(``lax.map``).  An op's parent lands in scratch row (column 0) − N, which
for the encoded ops is JAX's loop index k; an op equal to the one before
it whose parent row and scaler are none of its inputs is skipped (U1's
rule), so a padded table costs its real ops and the scratch holds only
as many rows as the batch's largest subset.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..errors import CapacityError, EinvalError, KernelError
from ..utils.constants import SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE
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
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"score_candidates_{suffix}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


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
    """C1: replay B candidates' op tables (int32 [B, K, 8] in the scratch-
    row encoding) with their P-matrix overlays (``upd_midx`` int32 [B, U],
    ``upd_pmatrix`` [B, U, C, S, S]) into fresh scratch rows; returns
    (scratch [B, R, C, S, L], scaler scratch [B, R, (C,) L]).  ``rows``
    (R) bounds every op's parent row: column 0 − N < R.  The base buffers
    are read only.  CUDA tensors take one launch of ``csrc/partials.cu``
    on the current stream, with no host read (the caller vouches for the
    tables' indices: :func:`check_tables` checks host ones); CPU tensors
    :func:`replay_candidates_plain`.  Counts its launches in
    ``replay_candidates.launches``."""
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
    lib = load_kernels()
    scaled = scale_mode != SCALE_NONE
    with torch.cuda.device(clv.device):
        rc = getattr(lib, "score_candidates_f64" if clv.dtype ==
                     torch.float64 else "score_candidates_f32")(
            clv.data_ptr(), scalers.data_ptr() if scaled else None,
            pmatrix.data_ptr(), tables.data_ptr(), k, upd_midx.data_ptr(),
            upd_pmatrix.data_ptr(), upd_midx.shape[1], scratch.data_ptr(),
            scal_scratch.data_ptr() if scaled else None, rows, b,
            clv.shape[0], clv_ops._dummy(scalers, scale_mode), c, s, length,
            scale_mode, torch.cuda.current_stream(clv.device).cuda_stream)
    if rc != 0:
        raise KernelError(f"score_candidates launch failed: CUDA error {rc} "
                          f"({lib.replay_error_string(rc).decode()})")
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
    buffers' extents (:func:`check_tables`) and copied to the buffers'
    device once, and the scratch holds the batch's largest subset.  Every
    step runs on the buffers' device: on the card C1 and no host read, on
    the CPU the plain versions."""

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
        tables, upd_midx, eval_rows = (
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for a in (tables, upd_midx, eval_rows))
        b, u = upd_midx.shape
        blens = torch.as_tensor(upd_blens, dtype=dtype, device=device)
        new = compute_pmatrices(
            blens.reshape(-1), model["rates"].to(dtype),
            model["prop_invar"].to(dtype), model["params_indices"],
            model["eigenvals"].to(dtype), model["left"].to(dtype),
            model["right"].to(dtype), dtype=dtype)
        new = new.reshape((b, u) + tuple(pmatrix.shape[1:])).contiguous()
        scratch, scal_scratch = replay_candidates(
            clv, scalers, pmatrix, tables, upd_midx, new, rows,
            self.scale_mode)

        er = eval_rows.long()
        parent = _fetch(clv, scratch, er[:, 0], N)
        child = _fetch(clv, scratch, er[:, 2], N)
        if self.scale_mode == SCALE_NONE:
            sp = sc = torch.zeros((b, clv.shape[-1]), dtype=torch.int32,
                                  device=device)
        else:
            sp = _fetch(scalers, scal_scratch, er[:, 1], NS + 1)
            sc = _fetch(scalers, scal_scratch, er[:, 3], NS + 1)
        # the edge's matrix: the candidate's last overlay slot that names
        # it, else the base's
        hit = upd_midx.long() == er[:, 4:5]
        slot = torch.where(hit, torch.arange(u, device=device), -1).amax(
            dim=1)
        edge_pm = torch.where(
            (slot >= 0)[:, None, None, None],
            new[torch.arange(b, device=device), slot.clamp(min=0)],
            pmatrix.index_select(0, er[:, 4]))
        return lk_ops.edge_loglikelihood(
            parent, child, sp, sc, edge_pm, model["freqs_pc"].to(dtype),
            model["rate_weights"].to(dtype),
            model["pattern_weights"].to(dtype),
            model["prop_invar_pc"].to(dtype), model["invariant"],
            sites=self.sites, per_rate=self.scale_mode == SCALE_PER_RATE,
            asc_mode=self.asc_mode)[0]


def make_candidate_scorer(n_nodes: int, n_scale_buffers: int, capacity: int,
                          *, sites: int, scale_mode: int = SCALE_PER_SITE,
                          asc_mode: int = 0) -> CandidateScorer:
    """Build the batched candidate scorer (:class:`CandidateScorer`).

    Everything about a topology is data, so one scorer serves every
    topology of the same (N, NS, capacity, sites) envelope."""
    return CandidateScorer(n_nodes, n_scale_buffers, capacity, sites=sites,
                           scale_mode=scale_mode, asc_mode=asc_mode)
