"""The model dict the evaluation modules take, from numpy arrays.

Counterpart: the traced model dict of ``libpll_tpu/engine/evaluate.py``
(``:109-135``, ``make_forward``'s docstring): branch_lengths [B], rates [C],
prop_invar [M], params_indices [C] int32, eigenvals [M,S], left/right
[M,S,S], freqs_pc [C,S], prop_invar_pc [C], rate_weights [C],
pattern_weights [L], invariant [L] int32, and asc_weights [S] where
asc-bias is on.  A JAX model crosses over as ``{k: np.asarray(v)}``.
"""

from __future__ import annotations

import numpy as np
import torch


def model_from_numpy(model_np, device, dtype) -> dict:
    """Numpy (or array-like) model dict -> dict of tensors on ``device``:
    integer entries as int32, floating entries in ``dtype``."""
    out = {}
    for key, value in model_np.items():
        a = np.array(value, order="C")  # a writable copy torch may share
        if np.issubdtype(a.dtype, np.integer):
            t = torch.from_numpy(a.astype(np.int32))
        else:
            t = torch.from_numpy(a).to(dtype)
        out[key] = t.to(device)
    return out
