"""General time-reversible rate matrix construction and eigendecomposition.

Counterpart: ``libpll_tpu/models/gtr.py`` (its numpy part, copied).

Capability parity with the reference's model layer (libpll
`src/models.c:182-331`): the substitution parameters (upper triangle of the
exchangeability matrix, ``s(s-1)/2`` values) and the stationary frequencies π
define ``Q``; because ``Q`` is time-reversible, ``S = diag(√π) Q diag(√π)⁻¹``
is symmetric, so a symmetric eigensolver applies. The decomposition is stored
as the two scaled factors used directly by the P-matrix kernel:

    ``left  = diag(√π)⁻¹ V``            (reference "inv_eigenvecs")
    ``right = Vᵀ diag(√π)``             (reference "eigenvecs")
    ``P(t) = left @ diag(expm1(λ·t)) @ right + I``

where ``S = V diag(λ) Vᵀ``.
"""

from __future__ import annotations

import numpy as np


def rate_matrix_symmetrized(subst_params: np.ndarray,
                            frequencies: np.ndarray) -> np.ndarray:
    """Build the normalized symmetrized rate matrix S = √π Q √π⁻¹.

    Matches `create_ratematrix` (libpll `src/models.c:182-249`): parameters
    are normalized by the last one, the diagonal makes rows of Q sum to zero,
    and the whole matrix is scaled so the mean substitution rate
    ``Σ πᵢ (−qᵢᵢ)`` is 1.
    """
    freqs = np.asarray(frequencies, dtype=np.float64)
    params = np.asarray(subst_params, dtype=np.float64).copy()
    s = freqs.shape[0]
    if params.shape[0] != s * (s - 1) // 2:
        raise ValueError(
            f"expected {s*(s-1)//2} substitution parameters, got {params.shape[0]}")

    if params[-1] > 0.0:
        params = params / params[-1]

    S = np.zeros((s, s), dtype=np.float64)
    iu, ju = np.triu_indices(s, k=1)
    sqrt_pipj = np.sqrt(freqs[iu] * freqs[ju])
    S[iu, ju] = S[ju, iu] = params * sqrt_pipj
    # diagonal accumulates -Σ factor·π_other per row of the *unsymmetrized* Q
    diag = np.zeros(s, dtype=np.float64)
    np.add.at(diag, iu, -params * freqs[ju])
    np.add.at(diag, ju, -params * freqs[iu])
    S[np.arange(s), np.arange(s)] = diag

    mean = float(np.dot(freqs, -diag))
    return S / mean


def eigen_decompose(subst_params: np.ndarray, frequencies: np.ndarray):
    """Eigendecompose the GTR generator; host-side analog of
    `pll_update_eigen` (libpll `src/models.c:251-331`).

    Returns ``(eigenvals [s], left [s,s], right [s,s])`` such that
    ``expm(Q t) = left @ diag(exp(λ t)) @ right``.
    """
    freqs = np.asarray(frequencies, dtype=np.float64)
    S = rate_matrix_symmetrized(subst_params, freqs)
    w, V = np.linalg.eigh(S)
    d = np.sqrt(freqs)
    left = V / d[:, None]
    right = V.T * d[None, :]
    return w, left, right
