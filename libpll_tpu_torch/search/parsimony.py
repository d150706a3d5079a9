"""Parsimony engines: bit-packed Fitch and weighted Sankoff wrappers.

Counterpart: ``libpll_tpu/search/parsimony.py``, capability parity with
libpll's two parsimony engines (``pll_fastparsimony_*``,
fast_parsimony.c; ``pll_parsimony_*``, parsimony.c), holding state vectors
and score buffers on their device and executing operation schedules with
:mod:`libpll_tpu_torch.ops.fitch` (the kernels P1 and P2 on the card) and
:mod:`libpll_tpu_torch.ops.sankoff` (plain PyTorch).  Both build on the
card unless given ``device="cpu"`` (keyword-only, last): None without a
card raises :class:`KernelError`.  Fitch words and costs are ``int32``
tensors holding JAX's ``uint32`` bits (``fitch.as_uint32`` reads them).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..engine.evaluate import _resolve_device
from ..errors import ParamError, TipDataError
from ..io.maps import encode_sequence
from ..ops import fitch, sankoff


class FastParsimony:
    """Bit-packed unweighted Fitch parsimony (reference pll_fastparsimony_*).

    Score indices follow the reference convention: tips 0..tips-1, inner
    nodes tips..2·tips-2 (``inner_nodes = tips - 1``, fast_parsimony.c:530).
    """

    def __init__(self, tip_masks: np.ndarray, states: int,
                 pattern_weights=None, *, device=None):
        device = _resolve_device(device)
        tips, sites = tip_masks.shape
        if pattern_weights is None:
            pattern_weights = np.ones(sites, dtype=np.int64)
        self.tips = tips
        self.states = states
        self.sites = sites
        self.inner_nodes = tips - 1
        self.informative, self.const_cost = fitch.set_informative(
            tip_masks, states, pattern_weights)
        self.informative_count = int(self.informative.sum())
        packed = fitch.pack_vectors(tip_masks, states, self.informative,
                                    np.asarray(pattern_weights),
                                    self.inner_nodes)
        self.vectors = fitch.to_words(packed, device)
        self.costs = torch.zeros(tips + self.inner_nodes, dtype=torch.int32,
                                 device=device)

    @property
    def device(self) -> torch.device:
        return self.vectors.device

    @classmethod
    def from_partition(cls, partition, *, device=None):
        """reference pll_fastparsimony_init (fast_parsimony.c:516-548)."""
        return cls(partition._tip_masks, partition.states,
                   partition.pattern_weights[:partition.sites],
                   device=device)

    @classmethod
    def from_sequences(cls, sequences: Sequence[str], charmap: np.ndarray,
                       states: int, pattern_weights=None, *, device=None):
        masks = np.stack([encode_sequence(s, charmap) for s in sequences])
        return cls(masks, states, pattern_weights, device=device)

    def update_vectors(self, buildops: Sequence[Tuple[int, int, int]]) -> None:
        """Execute (parent, child1, child2) Fitch steps; ops grouped into
        dependency levels, all of them in one P1 launch."""
        fitch.fitch_waves(self.vectors, self.costs, _group_levels(buildops))

    def edge_score(self, node1: int, node2: int) -> int:
        s = fitch.fitch_scores(self.vectors, self.costs, [node1], [node2])
        return int(fitch.as_uint32(s)[0]) + self.const_cost

    def edge_scores_batch(self, nodes1, nodes2) -> np.ndarray:
        s = fitch.fitch_scores(self.vectors, self.costs, nodes1, nodes2)
        return fitch.as_uint32(s) + self.const_cost

    def root_score(self, root_index: int) -> int:
        cost = self.costs[root_index:root_index + 1]
        return int(fitch.as_uint32(cost)[0]) + self.const_cost


def _group_levels(buildops):
    """Group (parent, child1, child2) ops into dependency levels."""
    level_of = {}
    levels: List[list] = []
    for op in buildops:
        p, c1, c2 = op[0], op[1], op[2]
        lvl = max(level_of.get(c1, -1), level_of.get(c2, -1)) + 1
        while len(levels) <= lvl:
            levels.append([])
        levels[lvl].append((p, c1, c2))
        level_of[p] = lvl
    return levels


class Parsimony:
    """Weighted Sankoff parsimony (reference pll_parsimony_create/build/
    score/reconstruct, parsimony.c), its score buffers float64 on the
    card unless built with ``device="cpu"``."""

    def __init__(self, tips: int, states: int, sites: int,
                 score_matrix: np.ndarray, score_buffers: int,
                 ancestral_buffers: int, *, device=None):
        device = _resolve_device(device)
        sm = np.asarray(score_matrix, dtype=np.float64)
        if sm.shape != (states, states):
            raise ParamError("score matrix must be [states, states]")
        self.tips = tips
        self.states = states
        self.sites = sites
        self.score_matrix = torch.as_tensor(sm, device=device)
        self.inf = float(sm.max()) + 1.0
        n = tips + score_buffers
        self._sbuffer = torch.zeros((n, states, sites), dtype=torch.float64,
                                    device=device)
        # tip cost rows staged host-side, landed in one copy on first read
        self._staged: dict = {}
        self.ancestral: dict = {}

    @property
    def device(self) -> torch.device:
        return self._sbuffer.device

    @property
    def sbuffer(self) -> torch.Tensor:
        if self._staged:
            staged, self._staged = self._staged, {}
            idx = np.fromiter(staged.keys(), np.int64, len(staged))
            tiles = torch.as_tensor(np.stack([staged[i] for i in idx]))
            self._sbuffer[torch.as_tensor(idx, device=self.device)] = (
                tiles.to(self.device))
        return self._sbuffer

    @sbuffer.setter
    def sbuffer(self, value) -> None:
        self._sbuffer = value

    def set_sequence(self, tip_index: int, charmap: np.ndarray,
                     sequence: str) -> None:
        """reference pll_set_parsimony_sequence (parsimony.c:24-67)."""
        if len(sequence) != self.sites:
            raise TipDataError("sequence length mismatch")
        masks = encode_sequence(sequence, charmap)
        bits = (masks[:, None] >> np.arange(self.states)[None, :]) & 1
        cost = np.where(bits.astype(bool), 0.0, self.inf).T  # [S, L]
        self._staged[tip_index] = cost

    def build(self, buildops) -> float:
        """Post-order DP sweep; returns the score at the last op's parent."""
        for lv in _group_levels(buildops):
            p, c1, c2 = torch.as_tensor(lv, device=self.device).T
            sankoff.sankoff_update(self.sbuffer, self.score_matrix, p, c1,
                                   c2)
        return self.score(buildops[-1][0])

    def score(self, index: int) -> float:
        return float(sankoff.sankoff_score(self.sbuffer, index))

    def reconstruct(self, charmap: np.ndarray, recops) -> dict:
        """recops: [(node_score_index, parent_score_index)] pre-order.
        Returns {score_index: ancestral sequence string}."""
        res = sankoff.sankoff_reconstruct(self.sbuffer.cpu().numpy(),
                                          recops, self.states, charmap)
        self.ancestral = {k: bytes(v).decode("latin-1")
                          for k, v in res.items()}
        return self.ancestral
