"""Log-likelihood evaluation at a root CLV or across an edge.

Counterpart: ``libpll_tpu/ops/likelihood.py``.  Capability parity with
`pll_core_root_loglikelihood` / `pll_core_edge_loglikelihood_ii` (libpll
`src/core_likelihood.c:24-210, 727-1002`) and the ascertainment-bias
corrections of `src/likelihood.c:24-119,170-247,321-414`, as reductions over
the ``[C, S, L]`` CLV layout.

Scaling fold-back:
  * per-site scalers enter additively: ``site_lnl += scaler · log(2**-shift)``;
  * per-rate scalers are folded exactly like the reference
    (`core_likelihood.c:896-941`): the per-site common part is the minimum
    over rates, the per-rate remainder is capped at SCALE_RATE_MAXDIFF and
    applied multiplicatively as ``2**(-shift·diff)`` to the per-rate term
    *before* rate mixing (at the root as well as across an edge).

Ascertainment-bias corrections operate on the ``S`` extra all-one-state
columns appended to the site axis, with the three reference flavors: Lewis
(-Σw·log(1-L₀)), Felsenstein (+Σw_inv·log(L₀)), and Stamatakis (add the
weighted per-state log-likelihoods directly).
"""

from __future__ import annotations

import math

import torch

from ..utils.constants import SCALE_RATE_MAXDIFF, scale_shift_bits

# asc-bias modes (host-level enum; ASC_NONE must be falsy)
ASC_NONE = 0
ASC_LEWIS = 1
ASC_FELSENSTEIN = 2
ASC_STAMATAKIS = 3


def log_scale_threshold(dtype) -> float:
    """log(2**-shift) rounded to the working dtype (shift: 256 f64, 32
    f32), as a Python float: a scalar operand copies nothing to the card,
    so a CUDA graph can capture the ops that use it."""
    shift = scale_shift_bits(dtype)
    return float(torch.tensor(-float(shift), dtype=dtype)
                 * torch.tensor(math.log(2.0), dtype=dtype))


def scale_pow(scal, dtype):
    """Exact 2**(-shift·scal) for integer scaler counts, including gradual
    underflow to subnormals and zero (exp2 of an integer is exact)."""
    shift = scale_shift_bits(dtype)
    return torch.exp2((-shift * scal.to(torch.int64)).to(dtype))


def fold_rate_scalers(scalers):
    """min/cap fold of per-rate scalers [..., C, L] -> (site [..., L],
    capped diff [..., C, L]).

    Reference: core_likelihood.c:916-931.
    """
    site = scalers.min(dim=-2).values
    diff = torch.clamp(scalers - site[..., None, :], max=SCALE_RATE_MAXDIFF)
    return site, diff


def apply_rate_fold(term_r, diff, dtype):
    """Multiply per-rate site terms by 2**(-shift·diff) (capped)."""
    return term_r * scale_pow(diff, dtype)


def fold_rate_scalers_inkernel(term_r, snum, down):
    """The score kernels' min/cap fold of per-rate scalers (counterpart
    ``clv_pallas.py:399``): per site the minimum over rates is the common
    counter; each rate's remainder, capped at SCALE_RATE_MAXDIFF, multiplies
    its term by ``down`` (2**-shift) that many times, one product at a time
    as the kernels do it.  term_r, snum: [C, L].  Returns (folded term_r,
    site counters [L])."""
    site = snum.min(dim=0).values
    diff = torch.clamp(snum - site[None, :], max=SCALE_RATE_MAXDIFF)
    for k in range(1, SCALE_RATE_MAXDIFF + 1):
        term_r = torch.where(diff >= k, term_r * down, term_r)
    return term_r, site


def _mix_rates(term_r, freqs_pc, rate_weights, prop_invar, invariant):
    """Rate mixing with invariant-site handling.

    term_r: [..., C, L] per-rate site likelihoods.
    invariant: int [L]; -1 for variant sites, else the invariant state.
    Returns term [..., L] = Σ_c w_c · ((1-p)·term_r + p·π[inv])   (per-cat
    p).
    """
    has_inv = invariant >= 0  # [L]
    inv_idx = torch.clamp(invariant, min=0).long()
    inv_lk = torch.where(has_inv[None, :], freqs_pc[:, inv_idx],
                         torch.zeros((), dtype=freqs_pc.dtype,
                                     device=freqs_pc.device))  # [C, L]
    pinv = prop_invar[:, None]  # [C, 1]
    mixed = torch.where(pinv > 0.0,
                        term_r * (1.0 - pinv) + inv_lk * pinv,
                        term_r)
    return (rate_weights[:, None] * mixed).sum(dim=-2)


def site_lnl(term, site_scalers, pattern_weights, dtype):
    """Per-site log-likelihood with the scaler fold-back, weighted."""
    return (torch.log(term) + site_scalers.to(dtype)
            * log_scale_threshold(dtype)) * pattern_weights


def root_loglikelihood(clv_root, scaler, freqs_pc, rate_weights,
                       pattern_weights, prop_invar, invariant,
                       sites, per_rate=False, asc_mode=ASC_NONE):
    """Root log-likelihood (+ per-site vector).

    Args:
      clv_root: [C, S, L] with L = sites (+ S asc columns if asc_mode).
      scaler: [L] or [C, L] int32 (zeros when the root has no scale buffer).
      freqs_pc: [C, S] per-category frequencies (params_indices resolved).
      rate_weights: [C]. pattern_weights: [L] in the working dtype.
      prop_invar: [C]. invariant: int32 [L].
      sites: number of real sites.

    Returns:
      (logl scalar, per-site log-likelihood [sites]).
    """
    dtype = clv_root.dtype
    term_r = (clv_root * freqs_pc[:, :, None]).sum(dim=1)  # [C, L]

    if per_rate:
        site_scal, diff = fold_rate_scalers(scaler)
        term_r = apply_rate_fold(term_r, diff, dtype)
    else:
        site_scal = scaler

    term = _mix_rates(term_r, freqs_pc, rate_weights, prop_invar, invariant)
    persite = site_lnl(term[:sites], site_scal[:sites],
                       pattern_weights[:sites], dtype)
    logl = persite.sum()

    if asc_mode:
        logl = logl + _asc_correction(term_r, site_scal, rate_weights,
                                      pattern_weights, sites, asc_mode,
                                      dtype)
    return logl, persite


def edge_loglikelihood(clv_parent, clv_child, scaler_parent, scaler_child,
                       pmatrix, freqs_pc, rate_weights, pattern_weights,
                       prop_invar, invariant, sites, per_rate=False,
                       asc_mode=ASC_NONE):
    """Edge log-likelihood between two CLVs (reference "ii" kernel; tips
    are 0/1 CLVs so the "ti"/"tt" cases reduce to this one).

    pmatrix: [C, S, S] for the connecting branch.
    Other arguments as in :func:`root_loglikelihood`.  The CLVs, scalers
    and P-matrices may carry leading batch axes ([B, C, S, L], [B, (C,)
    L], [B, C, S, S]: tree search's candidates), the model's vectors
    shared; logl and the per-site values then carry them too.
    """
    dtype = clv_parent.dtype
    # termb[c,j,n] = Σ_k P[c,j,k]·clv_child[c,k,n]
    termb = torch.matmul(pmatrix, clv_child)
    # a broadcast sum, not a three-operand einsum: that one lowers to
    # GEMV calls that took 0.93 ms at 262 144 sites on an H100, against
    # 0.04 ms for this
    term_r = (clv_parent * freqs_pc[:, :, None] * termb).sum(dim=-2)

    if per_rate:
        combined = scaler_parent + scaler_child  # [C, L]
        site_scal, diff = fold_rate_scalers(combined)
        term_r = apply_rate_fold(term_r, diff, dtype)
    else:
        site_scal = scaler_parent + scaler_child  # [L]

    term = _mix_rates(term_r, freqs_pc, rate_weights, prop_invar, invariant)
    persite = site_lnl(term[..., :sites], site_scal[..., :sites],
                       pattern_weights[:sites], dtype)
    logl = persite.sum(dim=-1)

    if asc_mode:
        logl = logl + _asc_correction(term_r, site_scal, rate_weights,
                                      pattern_weights, sites, asc_mode,
                                      dtype)
    return logl, persite


def asc_correction_terms(term_r_asc, scal_asc, rate_weights, asc_weights,
                         sum_w_real, asc_mode, dtype):
    """Ascertainment-bias correction from already-evaluated pseudo-site
    terms: ``term_r_asc`` [..., C, S] per-rate likelihoods of the S
    all-one-state columns (per-rate scalers already folded), ``scal_asc``
    [..., S] their site
    scaler counts, ``asc_weights`` [S] the per-state weights, ``sum_w_real``
    the total real-site pattern weight.  No invariant-site mixing applies on
    these columns (reference likelihood.c:24-119, 170-247, 321-414)."""
    t = (rate_weights[:, None] * term_r_asc).sum(dim=-2)  # [..., S]
    scal = scal_asc.to(dtype)

    if asc_mode == ASC_STAMATAKIS:
        # weighted log-likelihood of each pseudo-site; the scaler fold-back is
        # deliberately NOT weighted, matching likelihood.c:96-101
        return (torch.log(t) * asc_weights
                + scal * log_scale_threshold(dtype)).sum(dim=-1)
    # Lewis / Felsenstein need the absolute likelihoods
    l_base = (t * scale_pow(scal_asc, dtype)).sum(dim=-1)
    if asc_mode == ASC_LEWIS:
        return -(sum_w_real * torch.log(1.0 - l_base))
    # ASC_FELSENSTEIN
    return asc_weights.sum() * torch.log(l_base)


def _asc_correction(term_r, site_scal, rate_weights, pattern_weights,
                    sites, asc_mode, dtype):
    """Asc correction from the S extra "pseudo-site" columns riding the
    site axis (everything beyond ``sites``)."""
    return asc_correction_terms(
        term_r[..., sites:], site_scal[..., sites:], rate_weights,
        pattern_weights[sites:], pattern_weights[:sites].sum(),
        asc_mode, dtype)
