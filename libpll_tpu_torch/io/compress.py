"""Site-pattern compression.

Capability parity with `pll_compress_site_patterns` (libpll
`src/compress.c:138-286`): duplicate alignment columns are collapsed into
unique patterns with multiplicities; the log-likelihood then weights each
pattern by its count.  Patterns come out in first-occurrence order.

Counterpart: ``libpll_tpu/io/compress.py:23`` (``compress_site_patterns``),
whose numpy path this is: the same patterns, order and weights, without
the JAX package's native scanner.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..errors import EinvalError


def compress_site_patterns(sequences: List[str], charmap: np.ndarray,
                           ) -> Tuple[List[str], np.ndarray]:
    """Collapse duplicate columns.

    Args:
      sequences: equal-length strings (the alignment rows).
      charmap: 256-entry validity/state map; columns containing an illegal
        character (map value 0) raise.

    Returns:
      (compressed_sequences, pattern_weights int64 [n_patterns])
    """
    if not sequences:
        raise EinvalError("no sequences to compress")
    n = len(sequences[0])
    if any(len(s) != n for s in sequences):
        raise EinvalError("sequences must be equal length")

    mat = np.frombuffer("".join(sequences).encode("latin-1"),
                        dtype=np.uint8).reshape(len(sequences), n)
    if np.any(np.asarray(charmap)[mat] == 0):
        raise EinvalError("illegal character in sequences")

    cols = np.ascontiguousarray(mat.T)  # [sites, taxa]
    _, first_idx, counts = np.unique(cols, axis=0, return_index=True,
                                     return_counts=True)
    # unique patterns in order of first occurrence
    order = np.argsort(first_idx, kind="stable")
    weights = counts[order]
    kept = cols[np.sort(first_idx)]  # [n_patterns, taxa]
    out = [kept[:, t].tobytes().decode("latin-1")
           for t in range(mat.shape[0])]
    return out, weights.astype(np.int64)
