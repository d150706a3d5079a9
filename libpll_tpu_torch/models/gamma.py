"""Discrete Gamma rate-heterogeneity categories (Yang 1994).

Capability parity with the reference's `pll_compute_gamma_cats`
(libpll `src/gamma.c:220-292`): ``alpha == beta`` so the mean rate is 1, K
equiprobable categories, and either the *mean* or the *median* of each
quantile slice as the category rate. Runs once per alpha on the host — not
performance relevant — but must agree with the reference to print precision,
so the quantile machinery uses the same classical algorithms the reference
uses: AS 91 (chi-square percentage points, Best & Roberts 1975) bootstrapped
by AS 70 (normal quantile, Odeh & Evans 1974) and AS 32 (incomplete gamma
ratio, Bhattacharjee 1970), with the Pike & Hill (1966) log-gamma.

Counterpart: ``libpll_tpu/models/gamma.py`` (copied; pure Python).
"""

from __future__ import annotations

import math

import numpy as np

from ..errors import ParamError
from ..utils.constants import ALPHA_MIN, GAMMA_RATES_MEAN, GAMMA_RATES_MEDIAN


def _ln_gamma(alpha: float) -> float:
    """log Gamma(alpha) for alpha > 0 (Pike & Hill 1966, Algorithm 291)."""
    x = alpha
    f = 0.0
    if x < 7.0:
        f = 1.0
        z = alpha - 1.0
        z += 1.0
        while z < 7.0:
            f *= z
            z += 1.0
        x = z
        f = -math.log(f)
    z = 1.0 / (x * x)
    return (
        f
        + (x - 0.5) * math.log(x)
        - x
        + 0.918938533204673
        + (((-0.000595238095238 * z + 0.000793650793651) * z - 0.002777777777778) * z
           + 0.083333333333333) / x
    )


def _incomplete_gamma(x: float, alpha: float, ln_gamma_alpha: float) -> float:
    """Regularized lower incomplete gamma ratio I(x, alpha) (AS 32)."""
    if x == 0.0:
        return 0.0
    if x < 0.0 or alpha <= 0.0:
        return -1.0

    accurate = 1e-8
    overflow = 1e30
    factor = math.exp(alpha * math.log(x) - x - ln_gamma_alpha)

    if x <= 1.0 or x < alpha:
        # series expansion
        gin = 1.0
        term = 1.0
        rn = alpha
        while True:
            rn += 1.0
            term *= x / rn
            gin += term
            if term <= accurate:
                break
        return gin * factor / alpha

    # continued fraction
    a = 1.0 - alpha
    b = a + x + 1.0
    term = 0.0
    pn = [1.0, x, x + 1.0, x * b, 0.0, 0.0]
    gin = pn[2] / pn[3]
    while True:
        a += 1.0
        b += 2.0
        term += 1.0
        an = a * term
        for i in range(2):
            pn[i + 4] = b * pn[i + 2] - an * pn[i]
        if pn[5] != 0.0:
            rn = pn[4] / pn[5]
            dif = abs(gin - rn)
            if dif <= accurate and dif <= accurate * rn:
                return 1.0 - factor * gin
            gin = rn
        pn[0:4] = pn[2:6]
        if abs(pn[4]) >= overflow:
            for i in range(4):
                pn[i] /= overflow


def _point_normal(prob: float) -> float:
    """Standard normal quantile (AS 70, Odeh & Evans 1974)."""
    a0, a1, a2, a3 = -0.322232431088, -1.0, -0.342242088547, -0.0204231210245
    a4 = -0.453642210148e-4
    b0, b1, b2 = 0.0993484626060, 0.588581570495, 0.531103462366
    b3, b4 = 0.103537752850, 0.0038560700634

    p1 = prob if prob < 0.5 else 1.0 - prob
    if p1 < 1e-20:
        return -9999.0
    y = math.sqrt(math.log(1.0 / (p1 * p1)))
    z = y + ((((y * a4 + a3) * y + a2) * y + a1) * y + a0) / (
        (((y * b4 + b3) * y + b2) * y + b1) * y + b0
    )
    return -z if prob < 0.5 else z


def _point_chi2(prob: float, v: float) -> float:
    """Chi-square quantile with v degrees of freedom (AS 91)."""
    e = 0.5e-6
    aa = 0.6931471805
    if prob < 0.000002 or prob > 0.999998 or v <= 0.0:
        return -1.0

    g = _ln_gamma(v / 2.0)
    xx = v / 2.0
    c = xx - 1.0

    if v < -1.24 * math.log(prob):
        ch = math.pow(prob * xx * math.exp(g + xx * aa), 1.0 / xx)
        if ch - e < 0.0:
            return ch
    elif v <= 0.32:
        ch = 0.4
        a = math.log(1.0 - prob)
        while True:
            q = ch
            p1 = 1.0 + ch * (4.67 + ch)
            p2 = ch * (6.73 + ch * (6.66 + ch))
            t = -0.5 + (4.67 + 2.0 * ch) / p1 - (6.73 + ch * (13.32 + 3.0 * ch)) / p2
            ch -= (1.0 - math.exp(a + g + 0.5 * ch + c * aa) * p2 / p1) / t
            if abs(q / ch - 1.0) - 0.01 <= 0.0:
                break
    else:
        x = _point_normal(prob)
        p1 = 0.222222 / v
        ch = v * math.pow(x * math.sqrt(p1) + 1.0 - p1, 3.0)
        if ch > 2.2 * v + 6.0:
            ch = -2.0 * (math.log(1.0 - prob) - c * math.log(0.5 * ch) + g)

    # Newton refinement via Taylor expansion of the incomplete gamma.
    while True:
        q = ch
        p1 = 0.5 * ch
        t = _incomplete_gamma(p1, xx, g)
        if t < 0.0:
            return -1.0
        p2 = prob - t
        t = p2 * math.exp(xx * aa + g + p1 - c * math.log(ch))
        b = t / ch
        a = 0.5 * t - b * c
        s1 = (210.0 + a * (140.0 + a * (105.0 + a * (84.0 + a * (70.0 + 60.0 * a))))) / 420.0
        s2 = (420.0 + a * (735.0 + a * (966.0 + a * (1141.0 + 1278.0 * a)))) / 2520.0
        s3 = (210.0 + a * (462.0 + a * (707.0 + 932.0 * a))) / 2520.0
        s4 = (252.0 + a * (672.0 + 1182.0 * a) + c * (294.0 + a * (889.0 + 1740.0 * a))) / 5040.0
        s5 = (84.0 + 264.0 * a + c * (175.0 + 606.0 * a)) / 2520.0
        s6 = (120.0 + c * (346.0 + 127.0 * c)) / 5040.0
        ch += t * (1.0 + 0.5 * t * s1 - b * c * (s1 - b * (s2 - b * (s3 - b * (s4 - b * (s5 - b * s6))))))
        if abs(q / ch - 1.0) <= e:
            return ch


def _point_gamma(prob: float, alpha: float, beta: float) -> float:
    return _point_chi2(prob, 2.0 * alpha) / (2.0 * beta)


def compute_gamma_cats(alpha: float, categories: int,
                       mode: int = GAMMA_RATES_MEAN) -> np.ndarray:
    """Discretized Gamma(alpha, alpha) rates for ``categories`` classes.

    Equivalent to `pll_compute_gamma_cats` (libpll `src/gamma.c:220`):
    ``mode`` is :data:`GAMMA_RATES_MEAN` (default) or
    :data:`GAMMA_RATES_MEDIAN`. Mean mode returns the per-slice means so the
    weighted mean rate is exactly 1; median mode normalizes the slice medians
    to sum to ``categories``.
    """
    if alpha < ALPHA_MIN or categories < 1:
        raise ParamError(f"Invalid alpha value ({alpha:f})")

    k = int(categories)
    if k == 1:
        return np.ones(1, dtype=np.float64)

    factor = float(k)  # alpha/alpha * categories
    if mode == GAMMA_RATES_MEDIAN:
        middle = 1.0 / (2.0 * k)
        rates = np.array(
            [_point_gamma((2 * i + 1) * middle, alpha, alpha) for i in range(k)],
            dtype=np.float64,
        )
        return rates * (factor / rates.sum())

    if mode != GAMMA_RATES_MEAN:
        raise ParamError(f"Invalid GAMMA discretization mode ({mode})")

    lnga1 = _ln_gamma(alpha + 1.0)
    # upper quantile boundaries of the K equiprobable slices ...
    bounds = [_point_gamma((i + 1.0) / k, alpha, alpha) for i in range(k - 1)]
    # ... converted to the cumulative mass of Gamma(alpha+1) below each bound,
    # which (scaled by K) gives the per-slice conditional means.
    probs = [_incomplete_gamma(b * alpha, alpha + 1.0, lnga1) for b in bounds]

    rates = np.empty(k, dtype=np.float64)
    rates[0] = probs[0] * factor
    rates[k - 1] = (1.0 - probs[k - 2]) * factor
    for i in range(1, k - 1):
        rates[i] = (probs[i] - probs[i - 1]) * factor
    return rates
