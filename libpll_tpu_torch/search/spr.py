"""Likelihood SPR/NNI search: candidate generation, batched incremental
scoring, and the rounds that commit the best moves.

Counterpart: ``libpll_tpu/search/spr.py`` (``SprResult`` ``:46``,
``local_edge_set`` ``:56``, ``spr_neighborhood`` ``:104``, ``spr_round``
``:135``, ``encode_candidates`` ``:259``, ``score_encoded`` ``:301``,
``make_round_scorer`` ``:339``, ``nni_candidates`` ``:351``,
``encode_nni_candidates`` ``:366``, ``nni_round`` ``:403``), under JAX's
names and argument order; JAX's ``_model_from_partition`` (``:80``) is
``engine/evaluate.partition_model``.

  1. **host**: for each candidate (prune node p, regraft edge r) apply the
     SPR, collect the 3 changed branches, compute the minimal dirty op
     subset via the per-direction validity flags (a read-only peek,
     ``tree/incremental.PeekIndex``), and roll back, the validity flags
     restored from a snapshot of the 5 touched rings;
  2. **device**: per batch one call of the batched scorer
     (``ops/incremental.CandidateScorer``: the 3 new P-matrices of every
     candidate, kernel C1 replaying the subsets into scratch rows with the
     base CLVs read only, the edge fold), with no host read until
     :func:`score_encoded` hands back its scores;
  3. **commit** (:func:`spr_round`, :func:`nni_round`): the best improving
     move is applied and its dirty subtree updated in place by
     ``Partition.update_partials`` (kernel U1 on the card), padded to the
     scorer's capacity or the next power of two above it.  ``commit`` > 1
     applies further non-overlapping moves in descending score order,
     each verified by the exact logL and rolled back on regression.

On the card the scores are C1's and the fold's (float32 where the
Partition is), while the commit's verification is U1's and the edge
logL's: a move ranked by a score is kept or rolled back by the exact
evaluation, as in JAX.

On a sharded Partition (``parallel.mesh``) each rank scores its own sites
and :func:`score_encoded` adds the ranks' scores in one reduction a round;
the verified commits read the Partition's reduced logL, so every rank
commits and rolls back the same moves.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine.blopt import _full_evaluation
from ..engine.evaluate import partition_model
from ..errors import CapacityError, EinvalError, SprError
from ..ops import incremental as inc_ops
from ..tree import incremental as inc
from ..tree import moves
from ..tree import utree as ut
from ..tree.utree import UNode, UTree


@dataclass
class SprResult:
    logl0: float
    best_logl: float
    improved: bool
    n_candidates: int
    n_ops_max: int
    best: Optional[Tuple[int, int]] = None  # (p.node_index, r.node_index)
    best_nodes: Optional[tuple] = None  # the committed move's UNodes


def local_edge_set(nodes, radius: int) -> set:
    """pmatrix indices of every edge within ``radius`` edges of ``nodes``
    — the changed neighborhood of a committed topology move (the
    reference's `pll_utree_spr` reports exactly the changed branches for
    selective updates, utree_moves.c:204-251)."""
    out = set()
    frontier = []
    for nd in nodes:
        for m in ([nd] if nd.is_tip else nd.ring()):
            frontier.append((m, 0))
    visited = set()
    while frontier:
        m, d = frontier.pop()
        if id(m) in visited:
            continue
        visited.add(id(m))
        out.add(m.pmatrix_index)
        if d < radius:
            b = m.back
            for nxt in ([b] if b.is_tip else b.ring()):
                frontier.append((nxt, d + 1))
    return out


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


def _round_capacity(capacity: Optional[int], n_ops_max: int) -> int:
    """The scorer's envelope: ``capacity``, else the next power of two at
    or above the largest subset (at least 8); raises if the subset does
    not fit."""
    cap = capacity or max(8, 1 << (n_ops_max - 1).bit_length())
    if n_ops_max > cap:
        raise CapacityError(f"candidate op subset ({n_ops_max}) exceeds "
                            f"capacity ({cap})")
    return cap


def _commit_dirty(tree: UTree, part, params_indices, cap: int):
    """Update the dirty subtree of ``tree`` in place, padded to ``cap`` or
    the next power of two above the subset (a committed subset can
    outgrow the candidate envelope: it includes the re-orientation to the
    canonical root); returns (root edge logL, the dirty nodes)."""
    root = tree.root
    dirty = inc.partial_traverse(root)
    pops = inc.create_partial_operations(dirty)
    if pops:
        part.update_partials(pops, pad_to=max(
            cap, 1 << (len(pops) - 1).bit_length()))
    logl = part.compute_edge_loglikelihood(*_eval_edge(root),
                                           params_indices)
    return float(logl), dirty


def spr_round(tree: UTree, part, params_indices, *,
              radius: int = 5, capacity: Optional[int] = None,
              batch: int = 32, min_delta: float = 1e-9,
              candidates: Optional[List[Tuple[UNode, UNode]]] = None,
              scorer=None, commit: int = 1) -> SprResult:
    """Evaluate an SPR neighborhood incrementally and apply the best
    improving move.  ``part`` is a Partition whose CLVs are assumed
    consistent with ``tree`` *or* will be made so by the initial full
    evaluation here.

    ``commit`` > 1 applies up to that many improving moves per round, in
    descending score order, skipping candidates whose neighborhoods
    overlap an already-committed move; every extra commit is verified by
    an exact incremental evaluation and rolled back if the composite
    log-likelihood regresses (scores are measured against the pre-round
    tree, so they go stale once the topology changes).

    Returns an :class:`SprResult`; on improvement the tree and partition
    are left in the post-move state, otherwise restored exactly.
    """
    logl0 = _full_evaluation(tree, part, params_indices)

    if candidates is None:
        candidates = spr_neighborhood(tree, radius)
    if not candidates:
        return SprResult(logl0, logl0, False, 0, 0)

    enc, n_ops_max = encode_candidates(tree, candidates)
    if not enc:
        return SprResult(logl0, logl0, False, 0, 0)
    cap = _round_capacity(capacity, n_ops_max)

    if scorer is None:
        scorer = make_round_scorer(part, cap)
    logls = score_encoded(tree, part, params_indices, enc, cap, batch,
                          scorer)
    best_logl = float(logls[int(np.argmax(logls))])

    if best_logl <= logl0 + min_delta:
        return SprResult(logl0, logl0, False, len(enc), n_ops_max)

    # commit improving moves in descending score order (dirty-subtree
    # updates); moves after the first are verified exactly and rolled
    # back on regression
    order = np.argsort(np.asarray(logls))[::-1]
    logl_cur = logl0
    committed: List[Tuple[UNode, UNode]] = []
    blocked: set = set()
    for ci in order:
        if len(committed) >= commit:
            break
        if float(logls[ci]) <= logl0 + min_delta:
            break
        p, r = enc[ci][0], enc[ci][1]
        if committed:
            region = local_edge_set((p, r), 2)
            if region & blocked:
                continue  # overlaps an already-committed move
        rb = moves.Rollback(moves.MOVE_SPR)
        try:
            changed = moves.spr_safe(p, r, rb)
        except SprError:
            continue  # stale candidate no longer applicable
        part.update_prob_matrices(params_indices,
                                  [m for _, m in changed],
                                  [b for b, _ in changed])
        logl_new, dirty = _commit_dirty(tree, part, params_indices, cap)
        # the top-scored move is kept even where the exact logL does not
        # beat the score's baseline (a summation-path discrepancy is the
        # only way there: scores are exact for the pre-round tree); the
        # others must improve by min_delta
        if not committed or logl_new > logl_cur + min_delta:
            logl_cur = logl_new
            committed.append((p, r))
            blocked |= local_edge_set((p, r), 2)
            continue
        restored = moves.rollback_move(rb)
        part.update_prob_matrices(params_indices,
                                  [m for _, m in restored],
                                  [b for b, _ in restored])
        for nd in dirty:  # the verification overwrote these CLV rows
            for m in nd.ring():
                m.clv_valid = False
    logl_new, _ = _commit_dirty(tree, part, params_indices, cap)
    flat = tuple(n for pair in committed for n in pair)
    return SprResult(logl0, float(logl_new), True, len(enc), n_ops_max,
                     (committed[0][0].node_index,
                      committed[0][1].node_index), flat)


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
    log-likelihoods, read back once at the end (on a sharded Partition
    summed across the ranks in that one read)."""
    model = partition_model(part, params_indices)
    out = [scorer(part.clv, part.scalers, part.pmatrix, model, t, mi, bl,
                  er)[:b]
           for b, t, mi, bl, er in encoded_batches(
               enc, part.nodes, part.scale_buffers, cap, batch)]
    if not out:
        return []
    scores = torch.cat(out)
    if part.mesh is not None:
        scores = part.mesh.sum(scores)
    return scores.cpu().tolist()


def make_round_scorer(part, capacity: int):
    """The batched scorer for a partition envelope (N, NS, capacity,
    sites, scale mode): one scorer serves every topology of it.  A
    sharded Partition's scorer takes no asc-bias correction (its tail
    would be added on every rank)."""
    if part.mesh is not None and part.asc_mode:
        raise EinvalError("SPR scoring of a sharded Partition under "
                          "asc-bias correction is not ported")
    return inc_ops.make_candidate_scorer(
        part.nodes, part.scale_buffers, capacity,
        sites=part.sites, scale_mode=part.scale_mode,
        asc_mode=part.asc_mode)


# ---------------------------------------------------------------------------
# NNI rounds on the same incremental machinery
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


def nni_round(tree: UTree, part, params_indices, *,
              capacity: Optional[int] = None, batch: int = 32,
              min_delta: float = 1e-9, scorer=None) -> SprResult:
    """Evaluate every NNI interchange incrementally (one scorer call per
    batch) and apply the best improving one; same state guarantees as
    :func:`spr_round`."""
    logl0 = _full_evaluation(tree, part, params_indices)

    enc, n_ops_max = encode_nni_candidates(tree, nni_candidates(tree))
    if not enc:
        return SprResult(logl0, logl0, False, 0, 0)
    cap = _round_capacity(capacity, n_ops_max)
    if scorer is None:
        scorer = make_round_scorer(part, cap)
    logls = score_encoded(tree, part, params_indices, enc, cap, batch,
                          scorer)
    best_i = int(np.argmax(logls))
    if float(logls[best_i]) <= logl0 + min_delta:
        return SprResult(logl0, logl0, False, len(enc), n_ops_max)

    edge, nni_type = enc[best_i][0], enc[best_i][1]
    moves.nni(edge, nni_type)
    logl_new, _ = _commit_dirty(tree, part, params_indices, cap)
    return SprResult(logl0, float(logl_new), True, len(enc), n_ops_max,
                     (edge.node_index, nni_type), (edge, edge.back))
