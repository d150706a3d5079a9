"""Weighted (Sankoff) parsimony: per-site per-state minimum-cost dynamic
programming with an arbitrary score matrix.

Counterpart: ``libpll_tpu/ops/sankoff.py``, capability parity with libpll
``src/parsimony.c:190-380``:

    S_parent[n] = min_k (S_c1[k] + cost[k,n]) + min_k (S_c2[k] + cost[k,n])

a min-plus product over at most 20 states, batched over a level's ops and
the sites (layout [B, S, L]); the tree score is Σ_sites min_state, and
ancestral states are reconstructed pre-order with the reference's
parent-tiebreak rule (keep the parent's state unless this node's minimum is
strictly better than ``parent_value - 1``).  JAX computes the update and
the score in XLA, outside any Pallas kernel; here they are plain PyTorch in
float64 on the buffer's device (no kernel yet), and the reconstruction is
the numpy of the JAX package, copied.
"""

from __future__ import annotations

import numpy as np


def sankoff_update(sbuffer, score_matrix, parent, child1, child2):
    """One batched level of Sankoff DP steps, in place on ``sbuffer``.

    sbuffer: [B, S, L]; score_matrix: [S, S] (cost[k, n]).
    parent/child1/child2: int64 [w] score-buffer indices; the children of
    every op are read before any parent is written.
    """
    cost = score_matrix[None, :, :, None]
    m1 = (sbuffer[child1][:, :, None, :] + cost).amin(dim=1)
    m2 = (sbuffer[child2][:, :, None, :] + cost).amin(dim=1)
    sbuffer[parent] = m1 + m2
    return sbuffer


def sankoff_score(sbuffer, index):
    """Σ_sites min_state S[index] (reference pll_parsimony_score,
    parsimony.c:283-304 — unweighted by design)."""
    return sbuffer[index].amin(dim=0).sum()


def sankoff_reconstruct(sbuffer_np: np.ndarray, recops, states: int,
                        charmap: np.ndarray) -> dict:
    """Pre-order ancestral state reconstruction
    (reference pll_parsimony_reconstruct, parsimony.c:306-380).

    recops: list of (node_score_index, parent_score_index); the first row's
    parent index is ignored (subtree root). Returns {score_index: bytes}.
    """
    # reverse map: state index -> representative character; the reference
    # keeps the LAST single-bit character in map order (parsimony.c:317-323)
    revmap = {}
    for ch in range(256):
        m = int(charmap[ch])
        if m and (m & (m - 1)) == 0:
            revmap[m.bit_length() - 1] = ch

    out = {}
    node, _ = recops[0]
    minidx = np.argmin(sbuffer_np[node], axis=0)  # [L]
    out[node] = np.array([revmap[int(k)] for k in minidx], dtype=np.uint8)

    state_of_char = {v: k for k, v in revmap.items()}
    for node, parent in recops[1:]:
        s = sbuffer_np[node]  # [S, L]
        minidx = np.argmin(s, axis=0)
        minval = s[minidx, np.arange(s.shape[1])]
        parent_chars = out[parent]
        parent_states = np.array([state_of_char.get(int(c), 0)
                                  for c in parent_chars])
        parent_val = sbuffer_np[parent][parent_states,
                                        np.arange(s.shape[1])]
        keep_parent = minval + 1 > parent_val
        chars = np.array([revmap[int(k)] for k in minidx], dtype=np.uint8)
        out[node] = np.where(keep_parent, parent_chars, chars)
    return out

