"""Debug pretty-printers for P-matrices and CLVs.

Capability parity with `pll_show_pmatrix` / `pll_show_clv`
(libpll `src/output.c:26-96`): identical text layout, including on-the-fly
un-scaling of CLV entries by the accumulated exponent counters
(`output.c:48-54`), so outputs can be diffed against the reference's.

Counterpart: ``libpll_tpu/utils/output.py``: the same text; the tensors
are copied to the host first.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .constants import SCALE_BUFFER_NONE, scale_shift_bits


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def show_pmatrix(partition, index: int, float_precision: int,
                 out=None) -> None:
    """Print one transition matrix (all rate categories)."""
    out = out or sys.stdout
    pmat = _host(partition.pmatrix[index])  # [C, S, S]
    for k in range(partition.rate_cats):
        for i in range(partition.states):
            out.write("   ".join(
                f"{pmat[k, i, j]:+2.{float_precision}f}"
                for j in range(partition.states)) + "   \n")
        out.write("\n")


def show_clv(partition, clv_index: int, scaler_index: int,
             float_precision: int, out=None) -> None:
    """Print one CLV as `[ {(..),(..)} ... ]`, un-scaling on the fly."""
    out = out or sys.stdout
    clv = _host(partition.clv[clv_index])  # [C, S, L]
    rates, states, sites = clv.shape
    if scaler_index != SCALE_BUFFER_NONE:
        scal = _host(partition.scalers[scaler_index])  # [L] or [C, L]
    else:
        scal = None
    shift = scale_shift_bits(clv.dtype)

    def unscale(prob, i, j):
        if scal is None:
            return prob
        times = int(scal[i] if scal.ndim == 1 else scal[j, i])
        return prob * math.ldexp(1.0, -shift * times) if times else prob

    parts = ["[ "]
    for i in range(sites):
        parts.append("{")
        for j in range(rates):
            parts.append("(")
            vals = [f"{unscale(float(clv[j, k, i]), i, j):.{float_precision}f}"
                    for k in range(states)]
            parts.append(",".join(vals))
            parts.append(")")
            if j < rates - 1:
                parts.append(",")
        parts.append("} ")
    parts.append("]\n")
    out.write("".join(parts))
