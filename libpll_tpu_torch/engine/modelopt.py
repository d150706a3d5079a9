"""Model-parameter optimisation: GTR exchangeabilities and stationary
frequencies by L-BFGS through a differentiable eigendecomposition; Γ shape
(alpha) and the invariant-site proportion by derivative-free Brent; an
optional free-rate mode that optimises the category rates and weights
directly.

Counterpart: ``libpll_tpu/engine/modelopt.py`` (``ModelOptResult`` ``:55``,
``brent_maximize`` ``:74``, ``make_param_score`` ``:145``,
``_jitter_flat`` ``:221``, ``optimize_model`` ``:236``), with JAX's names,
signatures and defaults.  The reference library has no model-optimisation
entry point: libpll users assemble it from the setters
(`pll_set_subst_params` / `pll_set_frequencies`, reference
src/models.c:366-400), `pll_compute_gamma_cats` (src/gamma.c:220) and an
external optimiser.

  * The log-likelihood is differentiable end to end in the
    exchangeabilities and frequencies: the symmetrised GTR generator is
    eigendecomposed by :func:`~libpll_tpu_torch.models.gtr.
    eigen_decompose_torch` on the host in float64 (R <= 4 matrices of 4 x 4
    or 20 x 20: too small for the card, whose ``eigh`` would also stop the
    host), its factors move to the Partition's device inside the autograd
    graph, and autograd runs back through the P-matrices, the plain level
    sweep of ``engine.evaluate.make_forward`` and the scaled logL fold.
    No kernel of the port lies on this path: JAX differentiates its plain
    XLA sweep, and no Pallas kernel has a backward.
  * L-BFGS is :mod:`.lbfgs`, a copy of optax 0.2.6's ``lbfgs()``, so that
    the iterates are JAX's.
  * Alpha and p-inv ride the AS91 discretisation chain (models/gamma.py),
    an iterative host method, so they are optimised by Brent's method, each
    trial point one evaluation of the same scorer under ``torch.no_grad``.

Parameterisation keeps every iterate feasible: exchangeabilities are
``exp`` of free logs with the last rate pinned to 1 (src/models.c:196-199),
frequencies are a softmax, and the free-rate mode renormalises so the
weighted mean rate is exactly 1 (src/gamma.c:274-282).

At exactly equal exchangeabilities (JC69) the GTR eigenvalues are
degenerate and the eigh gradient is undefined, so a flat start is nudged
by a deterministic relative jitter (:func:`_jitter_flat`) first.

JAX's L-BFGS loop reports the logL one step behind the parameters (the
value is taken before the step is applied); the port keeps that as it is.

On a sharded Partition (``parallel.mesh``) the scorer sums this rank's
sites; :func:`optimize_model` adds the ranks' values and gradients in one
reduction a value-and-grad, after each rank's own backward (the
parameters are replicated, so the summed gradient is the whole
alignment's, as DDP sums its replicas'; no backward runs through the
collective, which would sum the gradients again), and reduces each Brent
evaluation.  Every rank then takes the same L-BFGS and Brent steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..errors import EinvalError, InvarError, ParamError
from ..models.gamma import compute_gamma_cats
from ..models.gtr import eigen_decompose_torch
from ..utils.constants import ALPHA_MIN, SCALE_PER_RATE
from . import lbfgs
from .evaluate import make_forward, topology_from_tree

HOST = dict(device="cpu", dtype=torch.float64)


@dataclasses.dataclass
class ModelOptResult:
    """Optimized parameters + the logL trajectory (one entry per pass)."""

    logl: float
    subst_params: np.ndarray
    frequencies: np.ndarray
    alpha: Optional[float]
    rates: np.ndarray
    rate_weights: np.ndarray
    prop_invar: float
    trajectory: List[float]


# ---------------------------------------------------------------------------
# Brent's method (derivative-free 1-D maximization), host only
# ---------------------------------------------------------------------------
_GOLD = 0.3819660112501051  # 2 - golden ratio


def brent_maximize(fn, lo: float, hi: float, *, xtol: float = 1e-4,
                   max_iter: int = 64):
    """Maximize ``fn`` on [lo, hi]; returns ``(x_best, f_best, evals)``.

    Classic Brent parabolic-interpolation/golden-section search (the
    textbook method RAxML-family tools use for alpha/p-inv); written for
    maximization by negating internally.
    """
    evals = 0

    def f(x):
        nonlocal evals
        evals += 1
        return -float(fn(x))

    a, b = float(lo), float(hi)
    x = w = v = a + _GOLD * (b - a)
    fx = fw = fv = f(x)
    d = e = b - a
    for _ in range(max_iter):
        m = 0.5 * (a + b)
        tol = xtol * abs(x) + 1e-10
        if abs(x - m) <= 2.0 * tol - 0.5 * (b - a):
            break
        p = q = r = 0.0
        if abs(e) > tol:
            # fit a parabola through (v, w, x)
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2.0 * (q - r)
            if q > 0.0:
                p = -p
            q = abs(q)
            e_prev, e = e, d
            if (abs(p) < abs(0.5 * q * e_prev) and q * (a - x) < p < q * (b - x)):
                d = p / q
                u = x + d
                if u - a < 2 * tol or b - u < 2 * tol:
                    d = tol if x < m else -tol
            else:
                e = (b - x) if x < m else (a - x)
                d = _GOLD * e
        else:
            e = (b - x) if x < m else (a - x)
            d = _GOLD * e
        u = x + d if abs(d) >= tol else x + (tol if d > 0 else -tol)
        fu = f(u)
        if fu <= fx:
            if u < x:
                b = x
            else:
                a = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, -fx, evals


# ---------------------------------------------------------------------------
# the differentiable scorer
# ---------------------------------------------------------------------------
def make_param_score(partition, tree, *, params_indices=None, dtype=None):
    """Build ``score(log_subst, freq_logits, rates, rate_weights, pinv,
    branch_lengths) -> logL`` (a 0-d tensor on the Partition's device):
    the full forward pass as a differentiable function of the model
    parameters (schedule and tip data closed over); returns ``(score,
    branch lengths in traversal order)``.

    The inputs are tensors (float64 on the host, as the optimiser passes
    them; 1-D ``log_subst``/``freq_logits`` are the single-matrix form).
    The eigendecomposition runs on the host in float64 and its factors
    move to the Partition's device in ``dtype`` (default the Partition's)
    inside the autograd graph, so gradients flow from logL back to the
    exchangeabilities and frequencies; rates / weights / p-inv / branch
    lengths are plain inputs (differentiable too, and reusable as data by
    the Brent passes).

    On a sharded Partition the score is this rank's sites' share of the
    logL (:func:`optimize_model` reduces it); asc-bias correction is not
    ported there (its tail would count once a rank).

    Mixture partitions (``rate_matrices > 1``, the LG4M/LG4X pattern of
    reference examples/lg4/lg4.c:295-370) are supported: ``log_subst`` and
    ``freq_logits`` carry a leading rate-matrix axis, every matrix is
    eigendecomposed in one batched call, and ``params_indices`` maps each
    Γ category to its matrix (default: category k -> matrix k % R, the LG4
    convention).  ``pinv`` stays a single shared proportion.
    """
    if partition.mesh is not None and partition.asc_mode:
        raise EinvalError("model fitting of a sharded Partition under "
                          "asc-bias correction is not ported")
    R = partition.rate_matrices
    if params_indices is None:
        pidx = (np.zeros(partition.rate_cats, np.int32) if R == 1 else
                np.arange(partition.rate_cats, dtype=np.int32) % R)
    else:
        pidx = np.asarray(params_indices, np.int32)
        if pidx.shape != (partition.rate_cats,):
            raise ParamError("params_indices must have rate_cats entries")
        if pidx.min() < 0 or pidx.max() >= R:
            raise ParamError("params_indices out of range")
    dtype = dtype or partition.dtype
    device = partition.device
    topo, branches = topology_from_tree(
        tree, partition.sites, scale_mode=partition.scale_mode,
        asc_mode=partition.asc_mode)
    T, I = topo.schedule.tips, topo.schedule.n_inner
    C, S, L = partition.rate_cats, partition.states, partition.sites_alloc

    clv0 = torch.zeros((T + I, C, S, L), dtype=dtype, device=device)
    clv0[:T] = partition.clv[:T].to(dtype)
    if partition.scale_mode == SCALE_PER_RATE:
        scalers0 = torch.zeros((I + 1, C, L), dtype=torch.int32,
                               device=device)
    else:
        scalers0 = torch.zeros((I + 1, L), dtype=torch.int32, device=device)
    pattern_weights = torch.as_tensor(partition.pattern_weights,
                                      dtype=dtype, device=device)
    invariant = partition._invariant_arr()
    pidx_host = torch.as_tensor(pidx, dtype=torch.long)
    pidx_dev = torch.as_tensor(pidx, dtype=torch.int32, device=device)
    forward = make_forward(topo, device=device)
    on_device = dict(device=device, dtype=dtype)

    def score(log_subst, freq_logits, rates, rate_weights, pinv,
              branch_lengths):
        log_subst = torch.atleast_2d(log_subst).to(**HOST)
        freq_logits = torch.atleast_2d(freq_logits).to(**HOST)
        # [R, E-1] free logs -> [R, E] with the last rate pinned to 1
        subst = torch.cat([torch.exp(log_subst), torch.ones((R, 1), **HOST)],
                          dim=1)
        freqs = torch.softmax(freq_logits, dim=-1)  # [R, S]
        w, left, right = eigen_decompose_torch(subst, freqs)
        pinv = torch.as_tensor(pinv).to(**on_device)
        model = {
            "branch_lengths": branch_lengths.to(**on_device),
            "rates": rates.to(**on_device),
            "prop_invar": pinv.expand(R),
            "params_indices": pidx_dev,
            "eigenvals": w.to(**on_device),
            "left": left.to(**on_device),
            "right": right.to(**on_device),
            "freqs_pc": freqs[pidx_host].to(**on_device),
            "prop_invar_pc": pinv.expand(C),
            "rate_weights": rate_weights.to(**on_device),
            "pattern_weights": pattern_weights,
            "invariant": invariant,
        }
        logl, _ = forward(model, clv0, scalers0)
        return logl

    return score, np.asarray(branches, np.float64)


def _jitter_flat(params: np.ndarray) -> np.ndarray:
    """Deterministically perturb exactly-equal exchangeabilities: eigh
    gradients are undefined at the degenerate (JC-like) point.  2-D input
    ([rate_matrices, E]) is jittered row by row."""
    if params.ndim == 2:
        return np.stack([_jitter_flat(r) for r in params])
    if np.ptp(params) > 1e-9 * abs(params).max():
        return params
    k = np.arange(params.shape[0], dtype=np.float64)
    return params * (1.0 + 1e-3 * (k - k.mean()) / max(len(k) - 1, 1))


def _host(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float64))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------
def optimize_model(partition, tree, *, opt_subst: bool = True,
                   opt_freqs: bool = True, opt_alpha: bool = True,
                   opt_pinv: bool = False, rate_mode: str = "gamma",
                   alpha: Optional[float] = None,
                   alpha_bounds=(0.02, 100.0), pinv_max: float = 0.99,
                   rounds: int = 3, lbfgs_steps: int = 80,
                   gtol: float = 1e-3, min_delta: float = 1e-4,
                   params_indices=None, dtype=None) -> ModelOptResult:
    """Optimize the partition's model parameters in place on the fixed
    topology/branch lengths of ``tree``; returns a :class:`ModelOptResult`.

    Coordinate rounds alternate (a) one L-BFGS pass over the enabled
    gradient parameters — exchangeabilities, frequencies, and in
    ``rate_mode="free"`` the category rates/weights — and (b) Brent passes
    for alpha (``rate_mode="gamma"``) and p-inv, until the logL gain of a
    full round drops under ``min_delta``.  An explicit ``alpha`` re-seeds
    the Γ discretization up front; by default the partition's current
    rates stand until the Brent pass improves on them (the result's
    ``alpha`` is then None unless Brent accepted a shape).  On exit the
    partition's ``subst_params``,
    ``frequencies``, ``rates``, ``rate_weights`` and ``prop_invar`` are
    updated through the ordinary setters, so the eigen cache invalidates
    exactly like the reference's (src/models.c:373,397).

    The evaluations run on the Partition's device in ``dtype`` (default
    the Partition's); the optimiser's state stays on the host in float64.
    """
    if rate_mode not in ("gamma", "free", "fixed"):
        raise ParamError(f"invalid rate_mode {rate_mode!r}")
    if opt_pinv:
        if partition.asc_mode != 0:
            raise InvarError(
                "p-inv optimization is incompatible with asc-bias")
        if partition.invariant is None:
            partition.update_invariant_sites()
        if not partition._has_invariant_sites():
            raise InvarError("no invariant sites found")

    score, branches = make_param_score(partition, tree,
                                       params_indices=params_indices,
                                       dtype=dtype)
    mesh = partition.mesh

    # current parameter state ([R, E] / [R, S]; R = rate_matrices — the
    # LG4-style mixtures optimize weights/rates/freqs over fixed
    # per-category empirical matrices, reference examples/lg4/lg4.c)
    R = partition.rate_matrices
    subst = _jitter_flat(np.asarray(partition.subst_params, np.float64))
    subst = subst / subst[:, -1:]
    freqs = np.asarray(partition.frequencies, np.float64)
    rates = np.asarray(partition.rates, np.float64)
    rweights = np.asarray(partition.rate_weights, np.float64)
    pinv = float(partition.prop_invar[0])
    C = partition.rate_cats
    # an explicit alpha re-seeds the Γ discretization; otherwise the
    # partition's current rates stand until Brent improves on them
    if alpha is not None and rate_mode == "gamma" and opt_alpha and C > 1:
        rates = compute_gamma_cats(alpha, C)

    bl = _host(branches)

    # --- the gradient block -------------------------------------------------
    grad_keys = []
    if opt_subst:
        grad_keys.append("log_subst")
    if opt_freqs:
        grad_keys.append("freq_logits")
    if rate_mode == "free":
        grad_keys += ["log_rates", "rweight_logits"]

    def full_args(p, rates_np, pinv_val):
        """Merge optimized leaves with the fixed current values."""
        ls = p.get("log_subst", _host(np.log(subst[:, :-1])))
        fl = p.get("freq_logits", _host(np.log(freqs)))
        if rate_mode == "free":
            r = torch.exp(p["log_rates"])
            w = torch.softmax(p["rweight_logits"], dim=-1)
            r = r / torch.sum(w * r)  # weighted mean rate pinned to 1
        else:
            r = _host(rates_np)
            w = _host(rweights)
        return ls, fl, r, w, _host(pinv_val)

    def run_lbfgs(p0: Dict[str, torch.Tensor], rates_np, pinv_val):
        # the leaves as one flat vector, in the order of JAX's pytree
        # (sorted keys)
        keys = sorted(p0)
        shapes = [p0[k].shape for k in keys]
        sizes = [p0[k].numel() for k in keys]

        def leaves(flat):
            return {k: part.reshape(shape) for k, part, shape in zip(
                keys, torch.split(flat, sizes), shapes)}

        def value_and_grad(flat):
            x = flat.detach().clone().requires_grad_(True)
            loss = -score(*full_args(leaves(x), rates_np, pinv_val), bl)
            loss.backward()
            if mesh is None:
                return float(loss.detach()), x.grad
            both = mesh.sum(torch.cat([loss.detach().reshape(1).to(**HOST),
                                       x.grad]))
            return float(both[0]), both[1:]

        p = torch.cat([p0[k].reshape(-1) for k in keys])
        state = lbfgs.init(p)
        value = np.inf
        for _ in range(lbfgs_steps):
            value, grad = lbfgs.value_and_grad_from_state(
                value_and_grad, p, state)
            updates, state = lbfgs.update(grad, state, p, value=value,
                                          value_and_grad=value_and_grad)
            p = lbfgs.apply_updates(p, updates)
            gmax = float(grad.abs().max())
            if gmax < gtol or not np.isfinite(float(value)):
                break
        return leaves(p), -float(value)

    def eval_at(rates_np, pinv_val):
        with torch.no_grad():
            logl = score(_host(np.log(subst[:, :-1])), _host(np.log(freqs)),
                         _host(rates_np), _host(rweights), _host(pinv_val),
                         bl)
        return float(logl if mesh is None else mesh.sum(logl))

    trajectory: List[float] = [eval_at(rates, pinv)]
    logl = trajectory[0]

    for _ in range(rounds):
        round_start = logl

        if grad_keys:
            p0: Dict[str, torch.Tensor] = {}
            if "log_subst" in grad_keys:
                p0["log_subst"] = _host(np.log(subst[:, :-1]))
            if "freq_logits" in grad_keys:
                p0["freq_logits"] = _host(np.log(freqs))
            if rate_mode == "free":
                p0["log_rates"] = _host(np.log(rates))
                p0["rweight_logits"] = _host(np.log(rweights))
            p, cand = run_lbfgs(p0, rates, pinv)
            if np.isfinite(cand) and cand > logl:
                logl = cand
                if "log_subst" in p:
                    subst = np.concatenate(
                        [np.exp(p["log_subst"].numpy()), np.ones((R, 1))],
                        axis=1)
                if "freq_logits" in p:
                    e = np.exp(p["freq_logits"].numpy())
                    freqs = e / e.sum(axis=1, keepdims=True)
                if rate_mode == "free":
                    r = np.exp(p["log_rates"].numpy())
                    e = np.exp(p["rweight_logits"].numpy())
                    rweights = e / e.sum()
                    rates = r / (rweights * r).sum()
            trajectory.append(logl)

        if rate_mode == "gamma" and opt_alpha and C > 1:
            a, cand, _ = brent_maximize(
                lambda a: eval_at(compute_gamma_cats(a, C), pinv),
                max(alpha_bounds[0], ALPHA_MIN), alpha_bounds[1])
            if cand > logl:
                alpha, logl = a, cand
                rates = compute_gamma_cats(alpha, C)
            trajectory.append(logl)

        if opt_pinv:
            pv, cand, _ = brent_maximize(
                lambda v: eval_at(rates, v), 0.0, pinv_max)
            if cand > logl:
                pinv, logl = pv, cand
            trajectory.append(logl)

        if logl - round_start < min_delta:
            break

    # write back through the ordinary setters (invalidates the eigen cache)
    for k in range(R):
        partition.set_subst_params(k, subst[k])
        partition.set_frequencies(k, freqs[k])
    partition.set_category_rates(rates)
    partition.set_category_weights(rweights)
    if opt_pinv and pinv > 0.0:
        for k in range(R):
            partition.update_invariant_sites_proportion(k, pinv)

    return ModelOptResult(
        logl=float(logl),
        subst_params=(subst[0] if R == 1 else subst),
        frequencies=(freqs[0] if R == 1 else freqs),
        alpha=(float(alpha) if rate_mode == "gamma" and alpha is not None
               else None),
        rates=rates, rate_weights=rweights, prop_invar=float(pinv),
        trajectory=trajectory)
