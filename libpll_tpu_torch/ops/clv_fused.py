"""Fused pruning sweep (K2) and fused edge score (K1): the CUDA wrappers,
their plain PyTorch versions, and the host helpers both share.

Counterpart: ``libpll_tpu/ops/clv_pallas.py`` — K1 replaces
``make_fused_edge_score`` (``:462``), K2 replaces ``make_fused_sweep``
(``:673``).  The kernels are ``csrc/clv_fused.cu``; that file says how
they are laid out on the card and what bounds them.

Layouts are the JAX package's *unpacked* ones, so the two packages compare
like with like: tip CLVs ``[tips, C, S, L]``, inner CLVs
``[n_inner, C, S, L]`` (rows rate-major, ``c*S + s``), scalers
``[n_inner + 1, L]`` or, per rate, ``[n_inner + 1, C, L]`` int32 with the
last row the always-zero dummy.  Pattern tips are :func:`pack_tipchars`
nibble words (``"chars"``) or one int32 bitmask per tip and site
(``"masks"``).

Each wrapper takes its plain version for a tensor on the CPU, and only
there: on a CUDA tensor it launches its kernel or raises.  Each counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..errors import EinvalError, KernelError
from ..utils.constants import SCALE_NONE, SCALE_PER_RATE, SCALE_PER_SITE
from . import _build
from .likelihood import site_lnl
from .sweep import LevelSchedule, make_level_sweep

TIP_ENCODINGS = ("clv", "chars", "masks")
KERNEL_RATE_CATS = (1, 2, 4, 8)
KERNEL_STATES = 4
BLOCK_SITES = 128  # sites per thread block, and per K1 partial sum
OP_FIELDS = 8  # prow, c1, m1, c2, m2, s1, s2, has_scaler


def flatten_ops(schedule: LevelSchedule) -> np.ndarray:
    """[n_inner, 8] int32 op table in level order (children before parents):
    (inner_row, child1, matrix1, child2, matrix2, scaler1, scaler2,
    has_scaler) — ``clv_pallas._flatten_ops`` as data for the kernels."""
    rows = [
        (lev.offset + k - schedule.tips, lev.child1[k], lev.matrix1[k],
         lev.child2[k], lev.matrix2[k], lev.scaler1[k], lev.scaler2[k],
         int(lev.has_scaler[k]))
        for lev in schedule.levels for k in range(len(lev.child1))]
    return np.asarray(rows, np.int32).reshape(-1, OP_FIELDS)


def op_table(schedule: LevelSchedule, device=None) -> torch.Tensor:
    """The op table as an int32 tensor, uploaded once per topology."""
    return torch.as_tensor(flatten_ops(schedule), device=device)


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
_SWEEP_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
_SCORE_ARGTYPES = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/clv_fused.cu``, once per
    process."""
    lib = _build.load("clv_fused")
    for suffix in ("f32", "f64"):
        sweep = getattr(lib, f"clv_fused_sweep_{suffix}")
        sweep.argtypes = _SWEEP_ARGTYPES + [ctypes.c_void_p]
        sweep.restype = ctypes.c_int
        score = getattr(lib, f"clv_fused_score_{suffix}")
        score.argtypes = (_SWEEP_ARGTYPES + _SCORE_ARGTYPES
                          + [ctypes.c_void_p])
        score.restype = ctypes.c_int
    lib.clv_fused_error_string.argtypes = [ctypes.c_int]
    lib.clv_fused_error_string.restype = ctypes.c_char_p
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"fused kernel input: {what}")


def _sweep_args(schedule, tips_packed, pmatrix, ops, scale_mode,
                tip_encoding):
    """Validate the inputs both kernels share; return (dtype suffix,
    rate_cats, sites, op table, the sweep's leading C arguments minus the
    output pointers).  The op table is returned so that the caller holds
    it until the launch: ``args`` keeps only its address."""
    device = tips_packed.device
    if device.type != "cuda":
        raise EinvalError(f"fused kernels run on CUDA tensors, not {device}")
    m, c, s, s2 = pmatrix.shape
    _require(pmatrix.dtype in (torch.float32, torch.float64),
             f"pmatrix dtype {pmatrix.dtype} (float32 or float64)")
    _require(s == s2 == KERNEL_STATES, f"states {s} (the kernel takes 4)")
    _require(c in KERNEL_RATE_CATS, f"rate_cats {c} (one of 1, 2, 4, 8)")
    _require(scale_mode in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE),
             f"scale mode {scale_mode}")
    check_tip_encoding(tip_encoding, s)
    tips, n_inner = schedule.tips, schedule.n_inner
    sites = tips_packed.shape[-1]
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
    if ops is None:
        ops = op_table(schedule, device)
    _require(ops.dtype == torch.int32
             and tuple(ops.shape) == (n_inner, OP_FIELDS),
             f"op table {tuple(ops.shape)} {ops.dtype}")
    used = max(max(int(lev.matrix1.max()), int(lev.matrix2.max()))
               for lev in schedule.levels)
    _require(used < m, f"schedule uses matrix {used} of {m}")
    for name, t in (("tips", tips_packed), ("pmatrix", pmatrix),
                    ("ops", ops)):
        _require(t.device == device, f"{name} on {t.device}, not {device}")
        _require(t.is_contiguous(), f"{name} is not contiguous")
    _require(sites > 0, "no sites")
    suffix = "f32" if pmatrix.dtype == torch.float32 else "f64"
    args = [ops.data_ptr(), n_inner, tips, n_inner, sites, c,
            _TIP_CODE[tip_encoding], scale_mode, tips_packed.data_ptr(),
            pmatrix.data_ptr()]
    return suffix, c, sites, ops, args


def _check_launch(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.clv_fused_error_string(rc).decode()
        raise KernelError(f"{name} launch failed: CUDA error {rc} ({msg})")


def fused_sweep(schedule: LevelSchedule, tips_packed, pmatrix, *, ops=None,
                scale_mode: int = SCALE_PER_SITE, tip_encoding: str = "clv"):
    """K2: the whole post-order sweep, every inner CLV and scaler written
    out.  Returns ``(inner [n_inner, C, S, L], scalers)``.

    ``ops``: :func:`op_table` on the tensors' device (built here when
    omitted).  CPU tensors take :func:`fused_sweep_plain`."""
    if tips_packed.device.type == "cpu":
        return fused_sweep_plain(schedule, tips_packed, pmatrix,
                                 scale_mode=scale_mode,
                                 tip_encoding=tip_encoding)
    suffix, c, sites, ops, args = _sweep_args(
        schedule, tips_packed, pmatrix, ops, scale_mode, tip_encoding)
    device, n_inner = tips_packed.device, schedule.n_inner
    srows = c if scale_mode == SCALE_PER_RATE else 1
    inner = torch.empty((n_inner, c, KERNEL_STATES, sites),
                        dtype=pmatrix.dtype, device=device)
    scalers = torch.empty(((n_inner + 1) * srows, sites), dtype=torch.int32,
                          device=device)
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"clv_fused_sweep_{suffix}")(
            *args, inner.data_ptr(), scalers.data_ptr(), stream)
    _check_launch(lib, rc, "fused_sweep")
    fused_sweep.launches += 1
    if scale_mode == SCALE_PER_RATE:
        scalers = scalers.view(n_inner + 1, c, sites)
    return inner, scalers


fused_sweep.launches = 0


def fused_edge_score(schedule: LevelSchedule, tips_packed, pmatrix,
                     weight_vec, pattern_weights, inv_add=None, *, ops=None,
                     parent_clv: int, child_clv: int, edge_matrix: int,
                     scale_mode: int = SCALE_PER_SITE,
                     tip_encoding: str = "clv"):
    """K1: the whole sweep with the edge log-likelihood folded in; inner
    CLVs live in a scratch the call allocates and drops.  Returns the
    float64 log-likelihood.

    ``weight_vec``: :func:`pack_weight_vec` ([C*S], with (1 - p_inv)
    folded in under +I); ``pattern_weights`` and ``inv_add``: [L] in the
    working dtype.  Per-site or no scaling.  CPU tensors take
    :func:`fused_edge_score_plain`."""
    check_score_scope(schedule, scale_mode, parent_clv)
    if tips_packed.device.type == "cpu":
        return fused_edge_score_plain(
            schedule, tips_packed, pmatrix, weight_vec, pattern_weights,
            inv_add, parent_clv=parent_clv, child_clv=child_clv,
            edge_matrix=edge_matrix, scale_mode=scale_mode,
            tip_encoding=tip_encoding)
    suffix, c, sites, ops, args = _sweep_args(
        schedule, tips_packed, pmatrix, ops, scale_mode, tip_encoding)
    device, n_inner = tips_packed.device, schedule.n_inner
    cs = c * KERNEL_STATES
    _require(0 <= edge_matrix < pmatrix.shape[0],
             f"edge matrix {edge_matrix}")
    _require(0 <= child_clv < schedule.tips + n_inner
             and parent_clv < schedule.tips + n_inner, "edge CLV rows")
    vectors = [("weight_vec", weight_vec, (cs,)),
               ("pattern_weights", pattern_weights, (sites,))]
    if inv_add is not None:
        vectors.append(("inv_add", inv_add, (sites,)))
    for name, t, shape in vectors:
        _require(t.device == device and t.dtype == pmatrix.dtype
                 and tuple(t.shape) == shape and t.is_contiguous(),
                 f"{name} {tuple(t.shape)} {t.dtype} on {t.device}")
    inner = torch.empty((n_inner, cs, sites), dtype=pmatrix.dtype,
                        device=device)
    scalers = torch.empty((n_inner + 1, sites), dtype=torch.int32,
                          device=device)
    partials = torch.empty((-(-sites // BLOCK_SITES),), dtype=torch.float64,
                           device=device)
    lib = load_kernels()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"clv_fused_score_{suffix}")(
            *args, inner.data_ptr(), scalers.data_ptr(), parent_clv,
            child_clv, edge_matrix, _scaler_row(schedule, parent_clv),
            _scaler_row(schedule, child_clv), weight_vec.data_ptr(),
            pattern_weights.data_ptr(),
            None if inv_add is None else inv_add.data_ptr(),
            partials.data_ptr(), stream)
    _check_launch(lib, rc, "fused_edge_score")
    fused_edge_score.launches += 1
    return sum_block_partials(partials)


fused_edge_score.launches = 0
