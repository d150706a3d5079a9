"""L-BFGS with a zoom line search on flat float64 host tensors: a copy of
optax 0.2.6's ``lbfgs()`` (the optimizer JAX's model fitting runs), step
for step, so that the port follows the same iterates.

What is copied (optax ``_src``):

  * ``alias.py`` ``lbfgs``: the chain of :func:`scale_by_lbfgs` (memory
    10, ``scale_init_precond=True``), the learning rate -1 and the zoom
    line search (``max_linesearch_steps=20``, ``initial_guess_strategy=
    "one"``);
  * ``transform.py`` ``scale_by_lbfgs`` and ``_precondition_by_lbfgs``:
    the memory ring (slot ``(count - 1) % m`` written, the recursion
    walked from slot ``count % m``), the two-loop recursion and the
    initial scaling (a capped reciprocal gradient norm at the first step);
  * ``linesearch.py`` ``_cubicmin``, ``_quadmin``, ``zoom_linesearch`` and
    ``scale_by_zoom_linesearch`` with their defaults: the interval search,
    the zoom's cubic / quadratic / bisection choice, the decrease and
    curvature errors, the safe step taken when the search fails;
  * ``utils.py`` ``value_and_grad_from_state``: the line search's last
    value and gradient are reused unless they are not finite.

The vectors are one flat float64 tensor (the caller concatenates its
leaves); the scalars are numpy float64, which keeps IEEE semantics
(division by zero, the square root of a negative number and NaN
comparisons) where Python floats would raise.  ``value_and_grad(p) ->
(value, grad)`` may run anywhere; it returns a float and a flat float64
tensor on ``p``'s device.  Powers are written as products in the order
``lax.integer_pow`` takes them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

MEMORY_SIZE = 10
MAX_LINESEARCH_STEPS = 20
# zoom_linesearch's defaults as scale_by_zoom_linesearch passes them
TOL = 0.0
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5  # stepsize_precision

ValueAndGrad = Callable[[torch.Tensor], Tuple[float, torch.Tensor]]
f64 = np.float64


def _dot(a: torch.Tensor, b: torch.Tensor):
    return f64(torch.dot(a, b).item())


@dataclasses.dataclass
class LBFGSState:
    """``ScaleByLBFGSState`` and ``ScaleByZoomLinesearchState``'s value
    and gradient (its learning rate serves only the "keep" initial guess,
    which ``lbfgs()`` does not take)."""

    count: int
    params: torch.Tensor
    updates: torch.Tensor
    diff_params_memory: torch.Tensor  # [m, n]
    diff_updates_memory: torch.Tensor  # [m, n]
    weights_memory: np.ndarray  # [m] float64
    value: np.float64
    grad: torch.Tensor


def init(params: torch.Tensor) -> LBFGSState:
    """``lbfgs().init``: empty memory, value +inf (so the first step
    evaluates)."""
    zeros = torch.zeros_like(params)
    mem = params.new_zeros((MEMORY_SIZE,) + params.shape)
    return LBFGSState(count=0, params=zeros, updates=zeros.clone(),
                      diff_params_memory=mem,
                      diff_updates_memory=mem.clone(),
                      weights_memory=np.zeros(MEMORY_SIZE),
                      value=f64(np.inf), grad=zeros.clone())


def value_and_grad_from_state(value_and_grad: ValueAndGrad,
                              params: torch.Tensor, state: LBFGSState):
    """The state's value and gradient where the value is finite, else a
    fresh evaluation at ``params``."""
    if np.isfinite(state.value):
        return state.value, state.grad
    value, grad = value_and_grad(params)
    return f64(value), grad


def _precondition(updates, dp_mem, du_mem, rhos, identity_scale,
                  memory_idx):
    """``_precondition_by_lbfgs``: the two-loop recursion, the right
    product walked backwards from the newest slot."""
    m = rhos.shape[0]
    indices = [(memory_idx + j) % m for j in range(m)]
    vec = updates
    alphas = [f64(0.0)] * m
    for j in reversed(range(m)):
        idx = indices[j]
        alpha = rhos[idx] * _dot(dp_mem[idx], vec)
        vec = vec + float(-alpha) * du_mem[idx]
        alphas[j] = alpha
    vec = float(identity_scale) * vec
    for j in range(m):
        idx = indices[j]
        beta = rhos[idx] * _dot(du_mem[idx], vec)
        vec = vec + float(alphas[j] - beta) * dp_mem[idx]
    return vec


def _scale_by_lbfgs(updates, state: LBFGSState, params):
    """``scale_by_lbfgs``'s update: the memory first, then the direction.
    Returns (preconditioned updates, the memory fields of the state)."""
    count = state.count
    m = MEMORY_SIZE
    memory_idx = count % m
    prev_memory_idx = (count - 1) % m

    diff_params = params - state.params
    diff_updates = updates - state.updates
    vdot = _dot(diff_updates, diff_params)
    weight = f64(0.0) if vdot == 0.0 else f64(1.0) / vdot
    if count == 0:
        diff_params = torch.zeros_like(diff_params)
        diff_updates = torch.zeros_like(diff_updates)
        weight = f64(0.0)
    dp_mem = state.diff_params_memory.clone()
    du_mem = state.diff_updates_memory.clone()
    rhos = state.weights_memory.copy()
    dp_mem[prev_memory_idx] = diff_params
    du_mem[prev_memory_idx] = diff_updates
    rhos[prev_memory_idx] = weight

    numerator = _dot(diff_updates, diff_params)
    denominator = f64(torch.sum(diff_updates * diff_updates).item())
    identity_scale = numerator / denominator if denominator > 0.0 else f64(1.0)
    if count == 0:
        update_norm = np.sqrt(f64(torch.sum(updates * updates).item()))
        identity_scale = np.minimum(f64(1.0), f64(1.0) / update_norm)

    precond = _precondition(updates, dp_mem, du_mem, rhos, identity_scale,
                            memory_idx)
    return precond, dict(count=count + 1, params=params, updates=updates,
                         diff_params_memory=dp_mem,
                         diff_updates_memory=du_mem, weights_memory=rhos)


# ---------------------------------------------------------------------------
# the zoom line search (linesearch.py)
# ---------------------------------------------------------------------------
def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The minimiser of the cubic through (a, fa, fpa), (b, fb), (c, fc);
    NaN where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = ((db * dc) * (db * dc)) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = ((dc * dc) * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * (dc * dc))) * v0 + (db * (db * db)) * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """The minimiser of the quadratic through (a, fa, fpa), (b, fb)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


def _nan_to_inf(x):
    return f64(np.inf) if np.isnan(x) else x


def _decrease_error(stepsize, value_step, slope_step, value_init,
                    slope_init):
    err = value_step - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope_step - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value_step - value_init - APPROX_DEC_RTOL * abs(value_init)
    approx = np.maximum(approx, delta_values)
    err = np.minimum(approx, err)
    return _nan_to_inf(np.maximum(err, f64(0.0)))


def _curvature_error(slope_step, slope_init):
    err = abs(slope_step) - CURV_RTOL * abs(slope_init)
    return _nan_to_inf(np.maximum(err, f64(0.0)))


@dataclasses.dataclass
class _Search:
    """``ZoomLinesearchState`` (the parameters and direction aside)."""

    count: int
    stepsize: np.float64
    value: np.float64
    grad: torch.Tensor
    slope: np.float64
    value_init: np.float64
    slope_init: np.float64
    decrease_error: np.float64
    curvature_error: np.float64
    interval_found: bool
    done: bool
    failed: bool
    low: np.float64
    value_low: np.float64
    slope_low: np.float64
    high: np.float64
    value_high: np.float64
    slope_high: np.float64
    cubic_ref: np.float64
    value_cubic_ref: np.float64
    safe_stepsize: np.float64
    safe_value: np.float64
    safe_grad: torch.Tensor


def _on_line(value_and_grad, params, stepsize, updates):
    value, grad = value_and_grad(params + float(stepsize) * updates)
    return f64(value), grad, _dot(grad, updates)


def _search_interval(s: _Search, value_and_grad, params, updates):
    prev_stepsize, prev_value, prev_slope = s.stepsize, s.value, s.slope
    new_stepsize = (f64(1.0) if s.count == 0
                    else INCREASE_FACTOR * prev_stepsize)
    value, grad, slope = _on_line(value_and_grad, params, new_stepsize,
                                  updates)
    dec = _decrease_error(new_stepsize, value, slope, s.value_init,
                          s.slope_init)
    curv = _curvature_error(slope, s.slope_init)
    error = np.maximum(dec, curv)
    if dec <= TOL:
        s.safe_stepsize, s.safe_value, s.safe_grad = new_stepsize, value, grad
    set_high_to_new = bool(dec > 0.0) or (bool(value >= prev_value)
                                          and s.count > 0)
    set_low_to_new = bool(slope >= 0.0) and not set_high_to_new
    if set_low_to_new:
        low = (new_stepsize, value, slope, prev_stepsize, prev_value,
               prev_slope)
    else:
        low = (prev_stepsize, prev_value, prev_slope, new_stepsize, value,
               slope)
    (s.low, s.value_low, s.slope_low, s.high, s.value_high,
     s.slope_high) = low
    s.interval_found = set_high_to_new or set_low_to_new or bool(error <= TOL)
    s.done = bool(error <= TOL)  # max_stepsize is None: never reached
    s.failed = s.count + 1 >= MAX_LINESEARCH_STEPS and not s.done
    s.count += 1
    s.stepsize, s.value, s.grad, s.slope = new_stepsize, value, grad, slope
    s.decrease_error, s.curvature_error = dec, curv
    s.cubic_ref, s.value_cubic_ref = s.low, s.value_low


def _zoom_into_interval(s: _Search, value_and_grad, params, updates):
    low, value_low, slope_low = s.low, s.value_low, s.slope_low
    high, value_high, slope_high = s.high, s.value_high, s.slope_high
    delta = abs(high - low)
    left, right = np.minimum(high, low), np.maximum(high, low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    too_small_int = bool(delta <= INTERVAL_THRESHOLD)

    middle_cubic = _cubicmin(low, value_low, slope_low, high, value_high,
                             s.cubic_ref, s.value_cubic_ref)
    use_cubic = bool((middle_cubic > left + cubic_chk)
                     & (middle_cubic < right - cubic_chk))
    middle_quad = _quadmin(low, value_low, slope_low, high, value_high)
    use_quad = not use_cubic and bool((middle_quad > left + quad_chk)
                                      & (middle_quad < right - quad_chk))
    if use_cubic:
        middle = middle_cubic
    elif use_quad:
        middle = middle_quad
    else:
        middle = (low + high) / 2.0

    value, grad, slope = _on_line(value_and_grad, params, middle, updates)
    dec = _decrease_error(middle, value, slope, s.value_init, s.slope_init)
    curv = _curvature_error(slope, s.slope_init)
    error = np.maximum(dec, curv)
    if dec <= TOL and value < s.safe_value:
        s.safe_stepsize, s.safe_value, s.safe_grad = middle, value, grad
    done = bool(error <= TOL)

    set_high_to_middle = bool(dec > 0.0) or bool(value >= value_low)
    set_high_to_low = (bool(slope * (high - low) >= 0.0)
                       and not set_high_to_middle)
    set_low_to_middle = not set_high_to_middle
    new_high = ((middle, value, slope) if set_high_to_middle
                else (high, value_high, slope_high))
    if set_high_to_low:
        new_high = (low, value_low, slope_low)
    new_low = ((middle, value, slope) if set_low_to_middle
               else (low, value_low, slope_low))
    if set_high_to_middle or set_high_to_low:
        s.cubic_ref, s.value_cubic_ref = high, value_high
    else:
        s.cubic_ref, s.value_cubic_ref = low, value_low

    presumably_failed = (s.count + 1 >= MAX_LINESEARCH_STEPS) or (
        too_small_int and bool(s.safe_stepsize > 0.0))
    s.failed = presumably_failed and not done
    s.done = done
    s.count += 1
    s.stepsize, s.value, s.grad, s.slope = middle, value, grad, slope
    s.decrease_error, s.curvature_error = dec, curv
    s.low, s.value_low, s.slope_low = new_low
    s.high, s.value_high, s.slope_high = new_high


def _try_safe_step(s: _Search):
    outside_domain = bool(np.isinf(s.decrease_error))
    if s.safe_stepsize > 0.0 or outside_domain:
        s.stepsize, s.value, s.grad = s.safe_stepsize, s.safe_value, \
            s.safe_grad


def _zoom_linesearch(updates, params, value, grad,
                     value_and_grad: ValueAndGrad) -> _Search:
    """``scale_by_zoom_linesearch``'s ``while_loop`` from its initial
    state; returns the final state."""
    slope = _dot(updates, grad)
    zero = f64(0.0)
    s = _Search(count=0, stepsize=zero, value=value, grad=grad, slope=slope,
                value_init=value, slope_init=slope,
                decrease_error=f64(np.inf), curvature_error=f64(np.inf),
                interval_found=False, done=False, failed=False,
                low=zero, value_low=value, slope_low=slope,
                high=zero, value_high=value, slope_high=slope,
                cubic_ref=zero, value_cubic_ref=value,
                safe_stepsize=zero, safe_value=value, safe_grad=grad)
    while not (s.done or s.failed):
        if s.interval_found:
            _zoom_into_interval(s, value_and_grad, params, updates)
        else:
            _search_interval(s, value_and_grad, params, updates)
        if s.failed:
            _try_safe_step(s)
    return s


def update(grad: torch.Tensor, state: LBFGSState, params: torch.Tensor, *,
           value, value_and_grad: ValueAndGrad):
    """``lbfgs().update(grad, state, params, value=, grad=, value_fn=)``:
    returns ``(updates, new_state)``; apply with :func:`apply_updates`."""
    with np.errstate(all="ignore"):
        precond, memory = _scale_by_lbfgs(grad, state, params)
        direction = -1.0 * precond
        s = _zoom_linesearch(direction, params, f64(value), grad,
                             value_and_grad)
    updates = float(s.stepsize) * direction
    return updates, LBFGSState(**memory, value=s.value, grad=s.grad)


def apply_updates(params: torch.Tensor, updates: torch.Tensor):
    """``optax.apply_updates``."""
    return params + updates
