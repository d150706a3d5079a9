"""Numeric constants shared across the engine.

Counterpart: ``libpll_tpu/utils/constants.py`` plus ``_scale_consts`` of
``libpll_tpu/ops/clv.py``.  The values are the same, so scaler counters of
the two packages compare bit for bit.

Matches the scaling/tolerance regime of the reference implementation
(libpll `src/pll.h:89-99`): conditional-likelihood entries are rescaled by
2**shift whenever an entire site (or site×rate) block drops below 2**-shift,
and the accumulated exponent counters are folded back at log-likelihood time.
"""

from __future__ import annotations

import numpy as np
import torch

# Maximum per-rate scaler difference folded back multiplicatively when
# per-rate scalers are enabled (reference: PLL_SCALE_RATE_MAXDIFF).
SCALE_RATE_MAXDIFF = 4

# Generic epsilon used e.g. to decide whether prop_invar is "zero"
# (reference: PLL_MISC_EPSILON).
MISC_EPSILON = 1e-8

# Minimum admissible Gamma shape parameter (reference: gamma.c ALPHA_MIN).
ALPHA_MIN = 0.02

# Gamma rate discretization modes (reference: PLL_GAMMA_RATES_*).
GAMMA_RATES_MEAN = 0
GAMMA_RATES_MEDIAN = 1

# Scaler sentinel: "this node has no scale buffer".
SCALE_BUFFER_NONE = -1

# Scaling modes for partial updates.
SCALE_NONE = 0
SCALE_PER_SITE = 1
SCALE_PER_RATE = 2


def scale_shift_bits(dtype) -> int:
    """Exponent shift of one scaling event for the working dtype (torch or
    numpy): 256 at float64 (the reference's 2**256, pll.h:89) and 32 at
    float32, whose 8 exponent bits leave ~2**94 of headroom between the
    scaling trigger and denormal death with 2**32 units."""
    itemsize = (dtype.itemsize if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    return 256 if itemsize == 8 else 32


def scale_consts(dtype):
    """(threshold, factor) = (2**-shift, 2**shift) as Python floats; both
    are exact in the working dtype."""
    shift = scale_shift_bits(dtype)
    return 2.0 ** -shift, 2.0 ** shift
