"""Likelihood SPR/NNI search: candidate generation and batched incremental
scoring.

Counterpart: the candidate half of ``libpll_tpu/search/spr.py``
(``spr_neighborhood`` ``:104``, ``encode_candidates`` ``:259``,
``score_encoded`` ``:301``, ``make_round_scorer`` ``:339``,
``nni_candidates`` ``:351``, ``encode_nni_candidates`` ``:366``), under
JAX's names and argument order; JAX's ``_model_from_partition`` (``:80``)
is ``engine/evaluate.partition_model``.  The rounds (``spr_round``,
``nni_round``, ``local_edge_set``, the commit and rollback) are not ported
yet.

  1. **host**: for each candidate (prune node p, regraft edge r) apply the
     SPR, collect the 3 changed branches, compute the minimal dirty op
     subset via the per-direction validity flags (a read-only peek,
     ``tree/incremental.PeekIndex``), and roll back, the validity flags
     restored from a snapshot of the 5 touched rings;
  2. **device**: per batch one call of the batched scorer
     (``ops/incremental.CandidateScorer``: the 3 new P-matrices of every
     candidate, kernel C1 replaying the subsets into scratch rows with the
     base CLVs read only, the edge fold), with no host read until
     :func:`score_encoded` hands back its scores.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.evaluate import partition_model
from ..errors import SprError
from ..ops import incremental as inc_ops
from ..tree import incremental as inc
from ..tree import moves
from ..tree import utree as ut
from ..tree.utree import UNode, UTree


def spr_neighborhood(tree: UTree, radius: int = 5,
                     prune_nodes: Optional[Sequence[UNode]] = None
                     ) -> List[Tuple[UNode, UNode]]:
    """All (p, r) SPR candidates with the regraft edge within ``radius``
    edges of the pruned position (the standard SPR neighborhood; radius
    bounds the rearrangement distance as in RAxML-style hill climbing)."""
    out: List[Tuple[UNode, UNode]] = []
    pruned = prune_nodes
    if pruned is None:
        pruned = [n for n in ut.query_innernodes(tree)]
    for p in pruned:
        if p.next is None:
            continue
        # BFS outward from the two edges adjacent to the pruned position,
        # staying outside the pruned subtree (which hangs behind p)
        banned = {p, p.next, p.next.next}
        frontier = [(p.next.back, 1), (p.next.next.back, 1)]
        seen = set()
        while frontier:
            node, d = frontier.pop(0)
            if node in seen or d > radius:
                continue
            seen.add(node)
            if d > 1:  # d==1 edges touch the prune point: no-op moves
                out.append((p, node))
            if node.next is not None and node not in banned:
                for m in list(node.ring())[1:]:
                    frontier.append((m.back, d + 1))
    return out


def _eval_edge(root: UNode) -> tuple:
    return (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index)


def encode_candidates(tree: UTree, candidates):
    """Host pass: apply/encode/rollback every candidate.  Returns
    (enc list of (p, r, changed, ops, eval_edge), max op count); illegal/no-op
    candidates are dropped.  Validity flags are exactly restored.

    The dirty-set peek uses :class:`incremental.PeekIndex` — one Euler
    index built per call, O(path) per candidate instead of the O(n) full
    walk."""
    root = tree.root
    peek_idx = inc.PeekIndex(root)
    enc: List[tuple] = []
    n_ops_max = 0
    for (p, r) in candidates:
        snap = inc.snapshot_flags([p, p.next.back, p.next.next.back,
                                   r, r.back])
        rb = moves.Rollback(moves.MOVE_SPR)
        try:
            # O(1) index-based containment (the equivalent of spr_safe's
            # O(subtree) walk); moves.spr itself rejects the no-op cases
            if peek_idx.contains(p.back, r):
                raise SprError("Node r is part of the subtree to be pruned")
            with moves.record_flips() as flips:
                changed = moves.spr(p, r, rollback=rb)
        except SprError:
            inc.restore_flags(snap)
            continue
        dirty = peek_idx.peek(flips)
        pops = inc.create_partial_operations(dirty)
        # eval-edge description of the *moved* topology: the regraft may
        # bisect the evaluation edge itself, relinking root.back
        edge = _eval_edge(root)
        moves.rollback_move(rb)
        inc.restore_flags(snap)
        if not pops:
            continue
        n_ops_max = max(n_ops_max, len(pops))
        enc.append((p, r, changed, pops, edge))
    return enc, n_ops_max


def encoded_batches(enc, n_nodes: int, n_scale_buffers: int, cap: int,
                    batch: int):
    """The scorer's inputs of each batch of encoded candidates, host
    arrays: (b real candidates, tables [batch, cap, 8], upd_midx, upd_blens
    [batch, U], eval_rows [batch, 5]); the last batch is padded by
    repeating its last candidate (one batch shape)."""
    N, NS = n_nodes, n_scale_buffers
    tables, midxs, blenss, erows = [], [], [], []
    for (p, r, changed, pops, edge) in enc:
        table, row_of, scal_of = inc_ops.encode_candidate_ops(
            pops, N, NS, cap)
        tables.append(table)
        midxs.append([m for _, m in changed])
        blenss.append([b for b, _ in changed])

        def scal_row(si):
            return NS if si < 0 else scal_of.get(si, si)

        p_clv, p_scal, c_clv, c_scal, e_mat = edge
        erows.append((row_of.get(p_clv, p_clv), scal_row(p_scal),
                      row_of.get(c_clv, c_clv), scal_row(c_scal), e_mat))

    for i in range(0, len(enc), batch):
        b = min(batch, len(enc) - i)
        pad = batch - b
        yield (b, np.stack(tables[i:i + b] + [tables[i + b - 1]] * pad),
               np.asarray(midxs[i:i + b] + [midxs[i + b - 1]] * pad,
                          np.int32),
               np.asarray(blenss[i:i + b] + [blenss[i + b - 1]] * pad),
               np.asarray(erows[i:i + b] + [erows[i + b - 1]] * pad,
                          np.int32))


def score_encoded(tree: UTree, part, params_indices, enc, cap: int,
                  batch: int, scorer) -> List[float]:
    """Device pass: one scorer call per batch of encoded candidates
    (:func:`encoded_batches`); returns the real candidates'
    log-likelihoods, read back once at the end."""
    model = partition_model(part, params_indices)
    out = [scorer(part.clv, part.scalers, part.pmatrix, model, t, mi, bl,
                  er)[:b]
           for b, t, mi, bl, er in encoded_batches(
               enc, part.nodes, part.scale_buffers, cap, batch)]
    return torch.cat(out).cpu().tolist() if out else []


def make_round_scorer(part, capacity: int):
    """The batched scorer for a partition envelope (N, NS, capacity,
    sites, scale mode): one scorer serves every topology of it."""
    return inc_ops.make_candidate_scorer(
        part.nodes, part.scale_buffers, capacity,
        sites=part.sites, scale_mode=part.scale_mode,
        asc_mode=part.asc_mode)


# ---------------------------------------------------------------------------
# NNI candidates on the same incremental machinery
# ---------------------------------------------------------------------------
def nni_candidates(tree: UTree) -> List[Tuple[UNode, int]]:
    """Both interchanges across every internal edge (reference
    `pll_utree_nni`, utree_moves.c:60-109)."""
    out: List[Tuple[UNode, int]] = []
    seen = set()
    for n in ut.query_innernodes(tree):
        for m in n.ring():
            if m.back.next is None or m.pmatrix_index in seen:
                continue
            seen.add(m.pmatrix_index)
            out.append((m, moves.NNI_LEFT))
            out.append((m, moves.NNI_RIGHT))
    return out


def encode_nni_candidates(tree: UTree, candidates):
    """Host pass for NNI: apply/peek/rollback each interchange.  NNI moves
    no branch lengths, so the 'changed' P-matrix refresh re-derives an
    existing row at its current length (an idempotent no-op the batched
    scorer's fixed shape needs)."""
    root = tree.root
    peek_idx = inc.PeekIndex(root)
    enc: List[tuple] = []
    n_ops_max = 0
    for (edge, nni_type) in candidates:
        if edge.next is None or edge.back.next is None:
            continue
        snap = inc.snapshot_flags(
            [edge, edge.back, edge.next.back, edge.back.next.back,
             edge.back.next.next.back])
        rb = moves.Rollback(moves.MOVE_NNI)
        try:
            with moves.record_flips() as flips:
                moves.nni(edge, nni_type, rollback=rb)
        except SprError:
            inc.restore_flags(snap)
            continue
        dirty = peek_idx.peek(flips)
        pops = inc.create_partial_operations(dirty)
        changed = [(edge.length, edge.pmatrix_index)] * 3
        eval_edge = _eval_edge(root)
        moves.rollback_move(rb)
        inc.restore_flags(snap)
        if not pops:
            continue
        n_ops_max = max(n_ops_max, len(pops))
        enc.append((edge, nni_type, changed, pops, eval_edge))
    return enc, n_ops_max
