"""Transition-probability matrices: P(t) = expm(Q·t·r/(1−p_inv)).

Counterpart: ``libpll_tpu/ops/pmatrix.py:26``.  Capability parity with
`pll_core_update_pmatrix` (libpll `src/core_pmatrix.c:24-250`) as one
batched computation over (branch × rate category):

  * the eigenvalue exponentials use ``expm1`` and the identity is added back
    at the end — the numerically robust form for Qt → 0; it also makes
    ``t == 0`` produce an exact identity matrix;
  * per-rate-category parameter indirection (``params_indices``) supports
    mixtures and per-category matrices (reference `src/models.c:333-364`).

The matrices are small ([B, C, S, S]); this stays plain PyTorch, as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

import torch

from ..utils.constants import MISC_EPSILON


def compute_pmatrices(branch_lengths, rates, prop_invar, params_indices,
                      eigenvals, left, right, dtype=None):
    """Batched P-matrix computation.

    Args:
      branch_lengths: [B] branch lengths.
      rates: [C] rate-category multipliers.
      prop_invar: [M] per-rate-matrix proportion of invariant sites.
      params_indices: [C] integer rate-matrix index used by each category.
      eigenvals: [M, S].
      left: [M, S, S]  (diag(√π)⁻¹ V).
      right: [M, S, S] (Vᵀ diag(√π)).
      dtype: output dtype (defaults to eigenvals.dtype).

    Returns:
      pmatrix [B, C, S, S].
    """
    dtype = dtype or eigenvals.dtype
    pidx = params_indices.long()
    ev = eigenvals[pidx]  # [C, S]
    lf = left[pidx]  # [C, S, S]
    rt = right[pidx]  # [C, S, S]
    pinv = prop_invar[pidx]  # [C]

    # effective rate r/(1 - p_inv); p_inv below epsilon counts as zero
    # (reference core_pmatrix.c:189-199)
    denom = torch.where(pinv > MISC_EPSILON, 1.0 - pinv,
                        torch.ones_like(pinv))
    ki = rates / denom  # [C]

    # expm1(λ · k · t): [B, C, S]
    expd = torch.expm1(ev[None, :, :] * (ki[None, :, None]
                                         * branch_lengths[:, None, None]))

    # P = left @ diag(expd) @ right + I ; expm1 of zero gives exactly I.
    pmat = torch.einsum("cij,bcj,cjk->bcik", lf, expd, rt)
    eye = torch.eye(ev.shape[-1], dtype=pmat.dtype, device=pmat.device)
    return (pmat + eye).to(dtype)
