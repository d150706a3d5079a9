"""Analytic first and second branch-length derivatives of the
log-likelihood, and the Newton solve on them (kernel N1).

Counterpart: ``libpll_tpu/ops/derivatives.py`` (``update_sumtable``
``:40``, ``likelihood_derivatives`` ``:71``), capability parity with
``pll_core_update_sumtable_ii`` / ``pll_core_likelihood_derivatives``
(libpll ``src/core_derivatives.c``).  The two phases stay split:

  phase 1 (:func:`update_sumtable`, once per edge): the parent and child
      CLVs projected into the eigenbasis and multiplied,
      ``sum[c,j,n] = (Σ_k clvp[c,k,n]·π_k·left[c,k,j]) ·
      (Σ_k right[c,j,k]·clvc[c,k,n])``;
  phase 2 (:func:`likelihood_derivatives`, per Newton iteration): with
      ``λ = eigenvals·r_c/(1 − p_inv)`` and ``e = exp(λt)``, per site
      (L, L', L'') = the dots of the sumtable with (e, λe, λ²e), mixed
      over rates with the invariant-site terms; ``d1 = Σ w·(−L'/L)``,
      ``d2 = Σ w·((L'/L)² − L''/L)``, plus the ascertainment-bias
      pseudo-site terms.

Layouts are JAX's: ``[C, S, L]`` sumtables, ``[C, L]`` per-rate and
``[L]`` per-site scalers.  Per-site scalers cancel in L'/L; per-rate ones
are folded into the sumtable (min/cap, ``2**(-shift·diff)``).

The Newton loop of ``libpll_tpu/engine/evaluate.py`` (``:638-659``,
``:707-725``, a ``lax.while_loop``) is :func:`newton_solve`: on a CUDA
tensor the hand-written kernel N1 of ``csrc/derivatives.cu``, the whole
loop in one cooperative launch (one grid barrier a body, every block
folding every block's partials, no host read), on a CPU tensor its plain
twin :func:`newton_solve_plain`, JAX's loop step by step.  The launch
follows :func:`plan_newton`, a pure function of the sumtable's shape and
dtype and the card's SMs and shared memory: each block's slice of sites
held in shared memory for the whole solve where it fits (resident), else
read from device memory every body (streamed).  The wrapper counts its
kernel launches in ``newton_solve.launches``, one a call.

Sites sharded across processes (``parallel.mesh``): a body needs every
rank's sums, which a launch cannot wait for, so :func:`newton_solve_mesh`
runs the loop on the host, a launch of N1's derivative mode
(:func:`newton_derivatives`: one body at t, its float64 sums out, no step)
and one reduction across the ranks a body; its plain twin is
:func:`newton_derivatives_plain`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..errors import EinvalError, KernelError
from . import _build
from .likelihood import (ASC_FELSENSTEIN, ASC_LEWIS, ASC_NONE,
                         ASC_STAMATAKIS, fold_rate_scalers, scale_pow)

# the loop of evaluate.py:625-659: t clipped to [MIN_T, MAX_T], at most
# NEWTON_ITERS bodies, stop once |d1| <= NEWTON_TOL
MIN_T, MAX_T = 1e-8, 100.0
NEWTON_ITERS = 32
NEWTON_TOL = 1e-9
KERNEL_STATES = (4, 20)
KERNEL_MAX_RATES = 8
THREADS = 512  # the kernel's block (csrc/derivatives.cu kBlock)
SLICE_ALIGN = 4  # a resident shared row's length rounds up to this (sites)
MAX_GRID = 160  # blocks a launch (kMaxGrid: warp 0 folds five a lane)
PARTIAL_SLOTS = 8  # float64 partials a block and body (kSlots)


def check_full_precision(t: torch.Tensor, what: str) -> None:
    """``what``'s products must run in full float32 on the card: a TF32
    matmul keeps ~3 decimal digits, far outside the f32 budget.  Raises
    rather than flipping the global flag."""
    if (t.dtype == torch.float32 and t.device.type == "cuda"
            and torch.backends.cuda.matmul.allow_tf32):
        raise EinvalError(f"{what} in float32 needs "
                          "torch.backends.cuda.matmul.allow_tf32 = False")


def update_sumtable(clv_parent, clv_child, scaler_parent, scaler_child,
                    freqs_pc, left_pc, right_pc, per_rate=False):
    """Phase-1 sumtable [C, S, L] of an edge (state axis: the eigenbasis
    index j).

    clv_parent, clv_child: [C, S, L]; scaler_parent, scaler_child: [C, L]
    int32, read only when ``per_rate``; freqs_pc [C, S]; left_pc, right_pc
    [C, S, S] (per-category eigen factors)."""
    check_full_precision(clv_parent, "update_sumtable")
    # lefterm[c,j,n] = Σ_k (π_k·left[c,k,j])·clvp[c,k,n]
    lefterm = torch.matmul((freqs_pc[:, :, None] * left_pc).transpose(1, 2),
                           clv_parent)
    # righterm[c,j,n] = Σ_k right[c,j,k]·clvc[c,k,n]
    righterm = torch.matmul(right_pc, clv_child)
    sumtable = lefterm * righterm
    if per_rate:
        _, diff = fold_rate_scalers(scaler_parent + scaler_child)
        sumtable = sumtable * scale_pow(diff, clv_parent.dtype)[:, None, :]
    return sumtable


def _mixed(cat, prop_invar, freqs_pc, rate_weights, invariant):
    """(L, L', L'') [3, n] of the sites of ``cat`` [3, C, n]: the invariant
    mixing of core_derivatives.c:481-491, then the rate mixing."""
    pinv = prop_invar[:, None]
    has_inv = invariant >= 0
    inv_idx = torch.clamp(invariant, min=0).long()
    inv_lk = torch.where(has_inv[None, :], freqs_pc[:, inv_idx] * pinv,
                         torch.zeros((), dtype=cat.dtype, device=cat.device))
    c0 = torch.where(pinv > 0, cat[0] * (1.0 - pinv) + inv_lk, cat[0])
    c12 = torch.where(pinv > 0, cat[1:] * (1.0 - pinv), cat[1:])
    return torch.einsum("c,dcn->dn", rate_weights,
                        torch.cat([c0[None], c12]))


def likelihood_derivatives(sumtable, branch_length, rates, prop_invar,
                           eigenvals_pc, freqs_pc, rate_weights, invariant,
                           pattern_weights, scaler_parent, scaler_child,
                           sites, asc_mode=ASC_NONE, reduce=None):
    """Phase 2: ``(d1, d2)``, d(−lnL)/dt and d²(−lnL)/dt², at
    ``branch_length``, as 0-dim tensors in the sumtable's dtype.

    rates, prop_invar, rate_weights [C]; eigenvals_pc, freqs_pc [C, S];
    invariant int32 [L] (−1: variant); pattern_weights [L];
    scaler_parent, scaler_child: [L] int32 per-site scalers or None
    (zeros), read only by the Lewis/Felsenstein pseudo-site terms;
    ``sites`` real sites (the asc pseudo columns follow them).
    ``reduce``: a mesh's ``sum`` where the sites are one rank's shard: the
    real sites' sums are reduced, then the pseudo columns' terms, which
    every rank holds alike, are added once."""
    s = sumtable.shape[1]
    ki = rates / (1.0 - prop_invar)
    lam = eigenvals_pc * ki[:, None]
    e = torch.exp(lam * branch_length)
    diag = torch.stack([e, lam * e, lam * lam * e], dim=1)  # [C, 3, S]
    cat = torch.matmul(diag, sumtable).transpose(0, 1)  # [3, C, L]

    def sums(lo, hi):
        lk0, lk1, lk2 = _mixed(cat[:, :, lo:hi], prop_invar, freqs_pc,
                               rate_weights, invariant[lo:hi])
        deriv1 = -lk1 / lk0
        deriv2 = deriv1 * deriv1 - lk2 / lk0
        w = pattern_weights[lo:hi]
        return (w * deriv1).sum(), (w * deriv2).sum()

    # Stamatakis evaluates the pseudo columns as real sites
    # (core_derivatives.c:536-545); otherwise only [:sites]
    stam = asc_mode == ASC_STAMATAKIS
    sum_w = pattern_weights[:sites].sum()
    if reduce is None:
        d1, d2 = sums(0, sites + (s if stam else 0))
    else:
        d1, d2 = sums(0, sites)
        d1, d2, sum_w = reduce(torch.stack([d1, d2, sum_w]))
        if stam:
            a1, a2 = sums(sites, sites + s)
            d1, d2 = d1 + a1, d2 + a2

    if asc_mode in (ASC_LEWIS, ASC_FELSENSTEIN):
        # pseudo sites with absolute scaling and no invariant mixing
        # (p-inv and asc-bias exclude each other, models.c:402-414)
        a = torch.einsum("c,dcn->dn", rate_weights, cat[:, :, sites:])
        scal = torch.zeros_like(invariant[sites:])
        for sv in (scaler_parent, scaler_child):
            if sv is not None:
                scal = scal + sv[sites:]
        a0, a1, a2 = (a * scale_pow(scal, sumtable.dtype)).sum(dim=1)
        if asc_mode == ASC_LEWIS:
            d1 = d1 + sum_w * (a1 / (a0 - 1.0))
            d2 = d2 + sum_w * (((a0 - 1.0) * a2 - a1 * a1)
                               / ((a0 - 1.0) * (a0 - 1.0)))
        else:
            sum_w_inv = pattern_weights[sites:].sum()
            d1 = d1 - sum_w_inv * (a1 / a0)
            d2 = d2 - sum_w_inv * ((a2 * a0 - a1 * a1) / (a0 * a0))
    return d1, d2


class Newton(NamedTuple):
    """The Newton loop's end: ``t`` (t*), the last body's ``d1`` and ``d2``
    (at the t it started from), all 0-dim in the working dtype, and the
    number of bodies run, ``iterations`` (0-dim int32)."""

    t: torch.Tensor
    d1: torch.Tensor
    d2: torch.Tensor
    iterations: torch.Tensor


def newton_solve_plain(sumtable, t0, rates, prop_invar, eigenvals_pc,
                       freqs_pc, rate_weights, invariant, pattern_weights,
                       scaler_parent=None, scaler_child=None, *, sites,
                       asc_mode=ASC_NONE, max_iters=NEWTON_ITERS,
                       abs_d2=False) -> Newton:
    """Plain twin of N1: the ``while_loop`` of evaluate.py:638-659 step by
    step.  Its condition is tested before each body on the previous body's
    d1 (``inf`` at first): ``|d1| > NEWTON_TOL`` and fewer than
    ``max_iters`` bodies; a body takes ``step = d1/d2`` (``d1`` where
    ``d2 == 0``) and ``t ← clip(t − step, MIN_T, MAX_T)``.  ``abs_d2``:
    blopt's rule ``step = d1/|d2|`` (``engine/blopt.py:59``, a step that
    stays downhill where d2 <= 0).  Reads d1 on the host each
    iteration."""
    dtype = sumtable.dtype
    t = t0.reshape(()).to(dtype)
    d1 = d2 = torch.full((), float("inf"), dtype=dtype, device=t.device)
    it = 0
    while it < max_iters and bool(torch.abs(d1) > NEWTON_TOL):
        d1, d2 = likelihood_derivatives(
            sumtable, t, rates, prop_invar, eigenvals_pc, freqs_pc,
            rate_weights, invariant, pattern_weights, scaler_parent,
            scaler_child, sites, asc_mode)
        step = torch.where(d2 != 0.0, d1 / (d2.abs() if abs_d2 else d2),
                           d1)
        t = torch.clamp(t - step, MIN_T, MAX_T)
        it += 1
    return Newton(t, d1, d2, torch.tensor(it, dtype=torch.int32,
                                          device=t.device))


# --------------------------------------------------------------------------
# CUDA wrapper
# --------------------------------------------------------------------------
_SOLVE_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_int64] * 2
                   + [ctypes.c_int] * 6 + [ctypes.c_int64]
                   + [ctypes.c_void_p] * 23)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of ``lib``'s entry points (the
    library of ``csrc/derivatives.cu``, or a variant of it)."""
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"newton_solve_{suffix}")
        fn.argtypes = _SOLVE_ARGTYPES
        fn.restype = ctypes.c_int
    lib.newton_query.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                                 ctypes.c_void_p]
    lib.newton_query.restype = ctypes.c_int
    lib.newton_device_pointer.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.newton_device_pointer.restype = ctypes.c_int
    lib.newton_error_string.argtypes = [ctypes.c_int]
    lib.newton_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/derivatives.cu``, once per
    process."""
    return bind(_build.load("derivatives"))


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"newton_solve input: {what}")


class NewtonPlan(NamedTuple):
    """One N1 launch: ``grid`` blocks of ``threads``, block b owning sites
    ``[b·block_sites, (b+1)·block_sites)`` of the evaluated ones, held in
    ``smem`` bytes of shared memory (``resident``) or read from device
    memory every body (``smem`` 0)."""

    grid: int
    threads: int
    block_sites: int
    resident: bool
    smem: int


def slice_bytes(rate_cats: int, states: int, itemsize: int,
                block_sites: int) -> int:
    """Shared memory of a resident slice: its sumtable rows, weights and
    invariant codes, each row ``block_sites`` rounded up to
    ``SLICE_ALIGN`` sites."""
    stride = -(-block_sites // SLICE_ALIGN) * SLICE_ALIGN
    return stride * (rate_cats * states * itemsize + itemsize + 4)


def plan_newton(shape, itemsize: int, sites: int, asc_mode: int, sms: int,
                smem_limit: int) -> NewtonPlan:
    """N1's launch for a sumtable of ``shape`` [C, S, L] and ``itemsize``
    bytes an entry, on a card of ``sms`` SMs whose blocks may have
    ``smem_limit`` bytes of dynamic shared memory.  One block an SM at
    most (every block resident, as the cooperative launch needs) and
    ``MAX_GRID`` in all, at least ``THREADS`` sites a block; where the
    slices fit shared memory within those blocks, resident (spread over
    as many blocks as that takes), else streamed.  Depends on sizes
    alone."""
    c, s, _ = shape
    sms = min(sms, MAX_GRID)
    ef = sites + (s if asc_mode == ASC_STAMATAKIS else 0)
    grid = max(1, min(sms, -(-ef // THREADS)))
    per_site = slice_bytes(c, s, itemsize, SLICE_ALIGN) // SLICE_ALIGN
    fit = smem_limit // per_site // SLICE_ALIGN * SLICE_ALIGN
    resident = fit > 0 and -(-ef // fit) <= sms
    if resident:
        grid = max(grid, -(-ef // fit))
    block_sites = -(-ef // grid)
    grid = -(-ef // block_sites)  # no block without sites
    smem = slice_bytes(c, s, itemsize, block_sites) if resident else 0
    return NewtonPlan(grid, THREADS, block_sites, resident, smem)


def _query(dtype, states: int, smem: int):
    """(resident block's shared-memory limit, SMs, blocks an SM holds of
    the instance ``smem`` picks) on the current card; raises the resident
    instance's limit first."""
    lib = load_kernels()
    out = (ctypes.c_int32 * 3)()
    rc = lib.newton_query(int(dtype == torch.float64), states, smem, out)
    if rc != 0:
        raise KernelError(f"newton_query failed: CUDA error {rc} "
                          f"({lib.newton_error_string(rc).decode()})")
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _limits(device_index: int, dtype, states: int):
    """(SMs, shared-memory limit) of N1's instance on the card, once per
    process."""
    with torch.cuda.device(device_index):
        limit, sms, _ = _query(dtype, states, 0)
    return sms, limit


def plan_for(sumtable: torch.Tensor, sites: int,
             asc_mode: int = ASC_NONE) -> NewtonPlan:
    """:func:`plan_newton` for ``sumtable`` on its card."""
    sms, limit = _limits(sumtable.device.index or 0, sumtable.dtype,
                         sumtable.shape[1])
    return plan_newton(tuple(sumtable.shape), sumtable.element_size(),
                       sites, asc_mode, sms, limit)


def blocks_per_sm(plan: NewtonPlan, dtype, states: int) -> int:
    """Blocks of ``plan``'s kernel instance an SM of the current card
    holds at once."""
    return _query(dtype, states, plan.smem)[2]


def _check(sumtable, t0, rates, prop_invar, eigenvals_pc, freqs_pc,
           rate_weights, invariant, pattern_weights, scaler_parent,
           scaler_child, sites, asc_mode, max_iters) -> None:
    """Raise on what N1 does not take: dtypes, shapes, contiguity, the
    asc columns, and any tensor off the sumtable's CUDA device."""
    device, dtype = sumtable.device, sumtable.dtype
    _require(dtype in (torch.float32, torch.float64),
             f"dtype {dtype} (float32 or float64)")
    _require(sumtable.dim() == 3 and sumtable.is_contiguous(),
             f"sumtable {tuple(sumtable.shape)}: [C, S, L], contiguous")
    c, s, length = sumtable.shape
    _require(1 <= c <= KERNEL_MAX_RATES, f"rate_cats {c} (1 to 8)")
    _require(s in KERNEL_STATES, f"states {s} (4 or 20)")
    _require(asc_mode in (ASC_NONE, ASC_LEWIS, ASC_FELSENSTEIN,
                          ASC_STAMATAKIS), f"asc_mode {asc_mode}")
    _require(0 < sites <= length and (
        length - sites == s if asc_mode else True),
        f"{sites} sites of {length} columns at asc_mode {asc_mode}")
    _require(1 <= max_iters <= NEWTON_ITERS, f"max_iters {max_iters}")
    typed = [("t0", t0, (1,)), ("rates", rates, (c,)),
             ("prop_invar", prop_invar, (c,)),
             ("eigenvals_pc", eigenvals_pc, (c, s)),
             ("freqs_pc", freqs_pc, (c, s)),
             ("rate_weights", rate_weights, (c,)),
             ("pattern_weights", pattern_weights, (length,))]
    ints = [("invariant", invariant), ("scaler_parent", scaler_parent),
            ("scaler_child", scaler_child)]
    for name, t, shape in typed:
        _require(t.dtype == dtype and (tuple(t.shape) == shape or (
            shape == (1,) and t.dim() == 0)),
            f"{name} {tuple(t.shape)} {t.dtype}, want {shape} {dtype}")
    for name, t in ints:
        _require(t is None or (t.dtype == torch.int32
                               and tuple(t.shape) == (length,)),
                 f"{name}: int32 [{length}]")
    for name, t in [(n, t) for n, t, _ in typed] + ints:
        if t is not None:
            _require(t.device == device and t.is_contiguous(),
                     f"{name} on {t.device}, not {device}, or not contiguous")
    _require(device.type == "cuda", f"tensors on {device}, not CUDA")


_POINTERS = ("sumtable", "clv_p", "clv_c", "lt", "right", "rscal_p",
             "rscal_c", "t0", "rates", "pinv", "evals", "freqs", "rw",
             "invariant", "weights", "scal_p", "scal_c")


class _Work(NamedTuple):
    """N1's scratch for launches of one plan: its outputs (t, d1, d2 and
    the body count), the blocks' float64 partials, and one zeroed arrival
    counter a launch (``slots`` of them)."""

    out: torch.Tensor
    iterations: torch.Tensor
    partials: torch.Tensor
    arrived: torch.Tensor


def _work(plan, dtype, device, slots=1) -> _Work:
    return _Work(torch.empty(3, dtype=dtype, device=device),
                 torch.empty(1, dtype=torch.int32, device=device),
                 torch.empty((2, plan.grid, PARTIAL_SLOTS),
                             dtype=torch.float64, device=device),
                 torch.zeros(slots, dtype=torch.int32, device=device))


def _call(plan, dtype, shape, sites, asc_mode, max_iters, abs_d2, ptrs,
          work, device, slot=0, sums_ptr=None):
    """One N1 launch of ``plan`` on ``device``'s current stream: ``ptrs``
    the C interface's pointer arguments in ``_POINTERS`` order (None:
    null), ``work`` its scratch (arrival counter ``slot``, zero),
    ``sums_ptr`` the derivative mode's output or None."""
    lib = load_kernels()
    c, s, length = shape
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, "newton_solve_f32" if dtype == torch.float32
                     else "newton_solve_f64")(
            c, s, length, sites, asc_mode, max_iters, int(abs_d2),
            plan.threads, plan.grid, plan.block_sites, plan.smem, *ptrs,
            work.partials.data_ptr(), work.arrived.data_ptr() + 4 * slot,
            work.iterations.data_ptr(), work.out.data_ptr(), sums_ptr,
            stream)
    if rc != 0:
        msg = lib.newton_error_string(rc).decode()
        raise KernelError(f"newton_solve launch failed: CUDA error {rc} "
                          f"({msg})")


def _launch(plan, dtype, shape, sites, asc_mode, max_iters, abs_d2,
            tensors):
    """One N1 launch of ``plan`` on the current stream; ``tensors`` maps the
    C interface's pointer arguments to tensors (None: null).  Returns the
    loop's end."""
    device = tensors["t0"].device
    work = _work(plan, dtype, device)
    _call(plan, dtype, shape, sites, asc_mode, max_iters, abs_d2,
          [None if tensors.get(n) is None else tensors[n].data_ptr()
           for n in _POINTERS], work, device)
    _newton_solve.launches += 1
    return Newton(work.out[0], work.out[1], work.out[2], work.iterations[0])


def newton_solve(sumtable, t0, rates, prop_invar, eigenvals_pc, freqs_pc,
                 rate_weights, invariant, pattern_weights,
                 scaler_parent=None, scaler_child=None, *, sites,
                 asc_mode=ASC_NONE, max_iters=NEWTON_ITERS,
                 abs_d2=False) -> Newton:
    """N1: the Newton loop of evaluate.py:638-659 on the card, arguments as
    :func:`newton_solve_plain` (``t0``: one element in the sumtable's
    dtype), in one launch planned by :func:`plan_for`, with no host read.
    CPU tensors take :func:`newton_solve_plain`."""
    if sumtable.device.type == "cpu":
        return newton_solve_plain(
            sumtable, t0, rates, prop_invar, eigenvals_pc, freqs_pc,
            rate_weights, invariant, pattern_weights, scaler_parent,
            scaler_child, sites=sites, asc_mode=asc_mode,
            max_iters=max_iters, abs_d2=abs_d2)
    _check(sumtable, t0, rates, prop_invar, eigenvals_pc, freqs_pc,
           rate_weights, invariant, pattern_weights, scaler_parent,
           scaler_child, sites, asc_mode, max_iters)
    return _launch(plan_for(sumtable, sites, asc_mode), sumtable.dtype,
                   tuple(sumtable.shape), sites, asc_mode, max_iters, abs_d2,
                   dict(sumtable=sumtable, t0=t0, rates=rates,
                        pinv=prop_invar, evals=eigenvals_pc, freqs=freqs_pc,
                        rw=rate_weights, invariant=invariant,
                        weights=pattern_weights, scal_p=scaler_parent,
                        scal_c=scaler_child))


newton_solve.launches = 0
_newton_solve = newton_solve  # counts even while a caller wraps it


def newton_derivatives_plain(sumtable, t, rates, prop_invar, eigenvals_pc,
                             freqs_pc, rate_weights, invariant,
                             pattern_weights, *, sites) -> torch.Tensor:
    """Plain twin of N1's derivative mode: float64 ``[d1, d2, w]`` at
    ``t``, the sums of :func:`likelihood_derivatives` over the ``sites``
    real sites (no asc terms) and their pattern weights' sum."""
    d1, d2 = likelihood_derivatives(
        sumtable, t.reshape(()), rates, prop_invar, eigenvals_pc, freqs_pc,
        rate_weights, invariant, pattern_weights, None, None, sites)
    return torch.stack([d1, d2, pattern_weights[:sites].sum()]).to(
        torch.float64)


class NewtonDerivatives:
    """N1's derivative mode for sumtables of one shape and dtype on one
    device, over ``sites`` real sites (no asc terms).  :meth:`bind` points
    it at a sumtable and the model's tensors; ``self(t)``, with t a host
    scalar (a 0-dim tensor or a numpy scalar) in the sumtable's dtype, is
    then one body at t with no step: float64 ``[d1, d2, w]`` (the sums of
    :func:`likelihood_derivatives` over the sites, in N1's fixed order,
    and the sites' weight sum) as a host tensor.  The plan, the scratch
    and the pinned host memory through which the kernel reads t and
    writes the sums are made once, so a caller keeps one instance for its
    edges (:func:`derivative_body`); on the card each call is one launch
    and a stream synchronisation, with no copy kernel.  Launches count in
    ``newton_derivatives.launches``.  On the CPU each call is
    :func:`newton_derivatives_plain`."""

    def __init__(self, shape, dtype, device, *, sites):
        self.shape, self.dtype = tuple(shape), dtype
        self.device, self.sites = torch.device(device), sites
        self.args = self.sumtable = None
        if self.device.type == "cpu":
            return
        self.t = torch.empty(1, dtype=dtype, pin_memory=True)
        self.t_host = self.t.numpy()
        self.sums = torch.empty(3, dtype=torch.float64, pin_memory=True)
        self.plan = plan_newton(self.shape, self.t.element_size(), sites,
                                ASC_NONE, *_limits(self.device.index or 0,
                                                   dtype, self.shape[1]))
        self.work = _work(self.plan, dtype, self.device, NEWTON_ITERS)
        self.slot = 0
        self.t_dev = torch.empty(1, dtype=dtype, device=self.device)
        self.t_ptr = _device_pointer(self.t)
        self.sums_ptr = _device_pointer(self.sums)

    def bind(self, sumtable, rates, prop_invar, eigenvals_pc, freqs_pc,
             rate_weights, invariant, pattern_weights
             ) -> "NewtonDerivatives":
        """Point the body at ``sumtable`` [C, S, L] (this instance's shape,
        dtype and device) and the model's tensors; returns self."""
        _require(tuple(sumtable.shape) == self.shape
                 and sumtable.dtype == self.dtype
                 and sumtable.device == self.device,
                 f"sumtable {tuple(sumtable.shape)} {sumtable.dtype} on "
                 f"{sumtable.device}, want {self.shape} {self.dtype} on "
                 f"{self.device}")
        self.sumtable = sumtable
        self.args = dict(rates=rates, prop_invar=prop_invar,
                         eigenvals_pc=eigenvals_pc, freqs_pc=freqs_pc,
                         rate_weights=rate_weights, invariant=invariant,
                         pattern_weights=pattern_weights, sites=self.sites)
        if self.device.type == "cpu":
            return self
        _check(sumtable, self.t_dev, rates, prop_invar,
               eigenvals_pc, freqs_pc, rate_weights, invariant,
               pattern_weights, None, None, self.sites, ASC_NONE, 1)
        tensors = dict(sumtable=sumtable, rates=rates, pinv=prop_invar,
                       evals=eigenvals_pc, freqs=freqs_pc, rw=rate_weights,
                       invariant=invariant, weights=pattern_weights)
        self.ptrs = [self.t_ptr if n == "t0" else
                     None if tensors.get(n) is None else
                     tensors[n].data_ptr() for n in _POINTERS]
        return self

    def __call__(self, t) -> torch.Tensor:
        if self.sumtable is None:
            raise EinvalError("NewtonDerivatives called before bind()")
        if self.device.type == "cpu":
            return newton_derivatives_plain(
                self.sumtable, torch.as_tensor(t, dtype=self.dtype),
                **self.args)
        if self.slot == NEWTON_ITERS:  # fresh counters, in stream order
            self.work.arrived.zero_()
            self.slot = 0
        self.t_host[0] = t
        _call(self.plan, self.dtype, self.shape, self.sites, ASC_NONE, 1,
              False, self.ptrs, self.work, self.device, self.slot,
              self.sums_ptr)
        self.slot += 1
        _newton_derivatives.launches += 1
        torch.cuda.current_stream(self.device).synchronize()
        return self.sums.clone()


def derivative_body(bodies: dict, sumtable, rates, prop_invar,
                    eigenvals_pc, freqs_pc, rate_weights, invariant,
                    pattern_weights, *, sites) -> NewtonDerivatives:
    """The :class:`NewtonDerivatives` of ``bodies`` (a caller's cache, by
    shape, dtype, device and sites; one made on first use) bound to this
    sumtable and model."""
    key = (tuple(sumtable.shape), sumtable.dtype, sumtable.device, sites)
    body = bodies.get(key)
    if body is None:
        body = bodies[key] = NewtonDerivatives(
            sumtable.shape, sumtable.dtype, sumtable.device, sites=sites)
    return body.bind(sumtable, rates, prop_invar, eigenvals_pc, freqs_pc,
                     rate_weights, invariant, pattern_weights)


def _device_pointer(host: torch.Tensor) -> int:
    """The device address of pinned host memory (the kernel reads and
    writes it directly)."""
    out = ctypes.c_void_p()
    rc = load_kernels().newton_device_pointer(host.data_ptr(),
                                              ctypes.byref(out))
    if rc != 0:
        raise KernelError(f"cudaHostGetDevicePointer failed: CUDA error "
                          f"{rc}")
    return out.value


def newton_derivatives(sumtable, t, rates, prop_invar, eigenvals_pc,
                       freqs_pc, rate_weights, invariant, pattern_weights, *,
                       sites) -> torch.Tensor:
    """N1's derivative mode once (:class:`NewtonDerivatives`): float64
    ``[d1, d2, w]`` at ``t`` (one element in the sumtable's dtype) on the
    host."""
    return derivative_body({}, sumtable, rates, prop_invar, eigenvals_pc,
                           freqs_pc, rate_weights, invariant,
                           pattern_weights, sites=sites)(
        t.detach().reshape(()).cpu())


newton_derivatives.launches = 0
_newton_derivatives = newton_derivatives


def newton_solve_mesh(mesh, sumtable, t0, rates, prop_invar, eigenvals_pc,
                      freqs_pc, rate_weights, invariant, pattern_weights, *,
                      sites, max_iters=NEWTON_ITERS, abs_d2=False,
                      bodies=None) -> Newton:
    """The Newton loop of :func:`newton_solve_plain` on a sumtable whose
    sites are sharded across ``mesh``'s ranks (``sites``: this rank's;
    no asc pseudo columns: blopt's solve).  Each body is one
    :class:`NewtonDerivatives` call (N1's derivative mode on the card) at
    the current t, its float64 sums added across the ranks by
    ``mesh.sum`` and rounded to the working dtype; the host then takes
    JAX's step: ``d1/d2`` (``d1/|d2|`` with ``abs_d2``), ``d1`` where
    ``d2 == 0``, t clipped to [MIN_T, MAX_T], while ``|d1| > NEWTON_TOL``
    and fewer than ``max_iters`` bodies, in numpy scalars of the working
    dtype (IEEE operations, the bits of the tensors' step).  Every rank
    reads the same reduced bits, so every rank takes the same steps.  One
    reduction and one host round trip a body.  ``bodies``: a cache for
    :func:`derivative_body` kept across the caller's solves.

    A body is a function of its t alone (N1's fold and the reduction have
    a fixed order), so once t comes back to the t some earlier body
    started from, the bodies after it repeat that cycle, and the loop's
    end is known without running them: the same (t, d1, d2) and body
    count as the full loop's.  In float32 ``|d1|`` seldom falls to
    NEWTON_TOL, and this spares most of the 32 bodies' reductions."""
    dtype, device = sumtable.dtype, sumtable.device
    body = derivative_body({} if bodies is None else bodies, sumtable, rates,
                           prop_invar, eigenvals_pc, freqs_pc, rate_weights,
                           invariant, pattern_weights, sites=sites)
    real = np.float32 if dtype == torch.float32 else np.float64
    lo, hi, tol = real(MIN_T), real(MAX_T), real(NEWTON_TOL)
    t = real(t0.reshape(()).item())
    d1 = d2 = real(np.inf)
    it = 0
    ts, ds = [t], [None]  # t after each body (t0 first), its (d1, d2)
    seen = {float(t): 0}  # t -> the first body that ended there
    while it < max_iters and abs(d1) > tol:
        sums = mesh.sum(body(t)).numpy()
        d1, d2 = real(sums[0]), real(sums[1])
        with np.errstate(all="ignore"):  # inf and NaN as the tensors'
            step = d1 / (abs(d2) if abs_d2 else d2) if d2 != 0 else d1
            t = np.minimum(np.maximum(t - step, lo), hi)
        it += 1
        ts.append(t)
        ds.append((d1, d2))
        j = seen.setdefault(float(t), it)
        if j < it and it < max_iters and abs(d1) > tol:
            # t_it == t_j: bodies j+1..it repeat with period it - j, every
            # one of them going on (their |d1| exceeded the tolerance)
            period = it - j
            t = ts[j + (max_iters - j) % period]
            d1, d2 = ds[j + (max_iters - 1 - j) % period + 1]
            it = max_iters
            break
    out = torch.tensor([t, d1, d2], dtype=dtype).to(device)
    return Newton(out[0], out[1], out[2],
                  torch.tensor(it, dtype=torch.int32, device=device))


# the arguments of update_sumtable among newton_solve_rows's
_ROW_KEYS = ("clv_parent", "clv_child", "scaler_parent", "scaler_child",
             "freqs_pc", "left_pc", "right_pc", "per_rate")


def sumtable_args(rows: dict) -> dict:
    """:func:`newton_solve`'s arguments from :func:`newton_solve_rows`'s:
    the sumtable formed by :func:`update_sumtable`."""
    args = {k: v for k, v in rows.items()
            if k not in _ROW_KEYS and k != "site_scalers"}
    args["sumtable"] = update_sumtable(*(rows[k] for k in _ROW_KEYS))
    args["freqs_pc"] = rows["freqs_pc"]
    args["scaler_parent"], args["scaler_child"] = rows["site_scalers"]
    return args


def newton_solve_rows(clv_parent, clv_child, scaler_parent, scaler_child,
                      freqs_pc, left_pc, right_pc, t0, rates, prop_invar,
                      eigenvals_pc, rate_weights, invariant, pattern_weights,
                      site_scalers=(None, None), *, per_rate=False, sites,
                      asc_mode=ASC_NONE, max_iters=NEWTON_ITERS,
                      abs_d2=False) -> Newton:
    """:func:`update_sumtable` then :func:`newton_solve`, from the edge's
    two rows (arguments as the two functions', ``site_scalers`` the
    latter's ``scaler_parent, scaler_child``).  Where N1's plan is
    resident and no Lewis/Felsenstein pseudo columns lie outside its
    slices, one launch whose prologue forms each slice of the sumtable in
    shared memory (it never reaches device memory); else, and on the CPU,
    the two functions in turn (their plain versions on the CPU)."""
    check_full_precision(clv_parent, "newton_solve_rows")
    st_args = (clv_parent, clv_child, scaler_parent, scaler_child, freqs_pc,
               left_pc, right_pc, per_rate)
    rest = dict(t0=t0, rates=rates, prop_invar=prop_invar,
                eigenvals_pc=eigenvals_pc, freqs_pc=freqs_pc,
                rate_weights=rate_weights, invariant=invariant,
                pattern_weights=pattern_weights,
                scaler_parent=site_scalers[0], scaler_child=site_scalers[1],
                sites=sites, asc_mode=asc_mode, max_iters=max_iters,
                abs_d2=abs_d2)
    if (clv_parent.device.type == "cpu"
            or asc_mode in (ASC_LEWIS, ASC_FELSENSTEIN)):
        return newton_solve(update_sumtable(*st_args), **rest)
    _check(clv_parent, t0, rates, prop_invar, eigenvals_pc, freqs_pc,
           rate_weights, invariant, pattern_weights, *site_scalers, sites,
           asc_mode, max_iters)
    plan = plan_for(clv_parent, sites, asc_mode)
    if not plan.resident:
        return newton_solve(update_sumtable(*st_args), **rest)
    c, s, length = clv_parent.shape
    dtype, device = clv_parent.dtype, clv_parent.device
    rscal = (scaler_parent, scaler_child) if per_rate else (None, None)
    for name, t, shape in (("clv_child", clv_child, (c, s, length)),
                           ("left_pc", left_pc, (c, s, s)),
                           ("right_pc", right_pc, (c, s, s))):
        _require(t.dtype == dtype and tuple(t.shape) == shape
                 and t.device == device,
                 f"{name} {tuple(t.shape)} {t.dtype} on {t.device}, want "
                 f"{shape} {dtype} on {device}")
    for name, t in zip(("scaler_parent", "scaler_child"), rscal):
        _require(t is None or (t.dtype == torch.int32 and t.device == device
                               and tuple(t.shape) == (c, length)),
                 f"{name}: int32 [{c}, {length}] on {device}")
    # lt[c, j, k] = π[c, k]·left[c, k, j]
    lt = (freqs_pc[:, :, None] * left_pc).transpose(1, 2).contiguous()
    return _launch(plan, dtype, (c, s, length), sites, asc_mode, max_iters,
                   abs_d2, dict(clv_p=clv_parent.contiguous(),
                        clv_c=clv_child.contiguous(), lt=lt,
                        right=right_pc.contiguous(),
                        rscal_p=None if rscal[0] is None
                        else rscal[0].contiguous(),
                        rscal_c=None if rscal[1] is None
                        else rscal[1].contiguous(),
                        t0=t0, rates=rates, pinv=prop_invar,
                        evals=eigenvals_pc, freqs=freqs_pc, rw=rate_weights,
                        invariant=invariant, weights=pattern_weights,
                        scal_p=site_scalers[0], scal_c=site_scalers[1]))
