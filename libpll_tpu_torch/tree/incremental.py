"""Dirty-subtree (partial-traversal) re-evaluation: per-direction CLV
validity tracking.

This is the rebuild's CLV-reuse engine for tree search, the counterpart of
the reference's ``clv_valid``-per-direction trick (a flag hung off each
``pll_unode_t``'s ``data`` pointer): the CLV buffer of an inner ring holds
the partial likelihood oriented as exactly *one* of the ring's three
directed nodes, and a post-order evaluation may skip every subtree whose
root direction is still valid (reference
`examples/partial-traversal/partial.c:61-104`, `src/stepwise.c:118`).

Mechanics here:

  * every :class:`~libpll_tpu_torch.tree.utree.UNode` carries a ``clv_valid``
    flag; at most one member of a ring is ever valid (the direction the
    buffer currently represents);
  * the move primitives (:mod:`libpll_tpu_torch.tree.moves`) invalidate exactly
    the directed nodes whose immediate child links changed — the upward
    propagation to the evaluation root happens automatically inside
    :func:`partial_traverse`'s post-order recursion (a parent is
    recomputed iff it is itself stale *or any child was recomputed*);
  * :func:`partial_traverse` returns the minimal post-order op subset and
    flips ownership flags, so repeated calls with no intervening changes
    return an empty schedule.

The host walk is O(n) per call (cheap); what it saves is *device* work —
the returned subset is what `update_partials` executes.

Counterpart: ``libpll_tpu/tree/incremental.py``, copied.
"""

from __future__ import annotations

from typing import List

from ..errors import TreeError
from .utree import UNode, UTree


def invalidate(node: UNode) -> None:
    """Mark one directed CLV stale."""
    node.clv_valid = False


def invalidate_edge(u: UNode) -> None:
    """Invalidate every directed CLV whose subtree looks *through* the edge
    ``u``—``u.back`` (call after changing that edge's branch length /
    P-matrix): the other two directions of each endpoint's ring.
    """
    for end in (u, u.back):
        if end is not None and end.next is not None:
            for m in end.ring():
                if m is not end:
                    m.clv_valid = False


def invalidate_all(tree: UTree) -> None:
    for n in tree.nodes:
        for m in ([n] if n.is_tip else n.ring()):
            m.clv_valid = False


def mark_valid(trav_buffer: List[UNode]) -> None:
    """After executing a full (or partial) schedule, record which direction
    of each computed ring owns the buffer."""
    for node in trav_buffer:
        if node.is_tip:
            continue
        for m in node.ring():
            m.clv_valid = m is node


def partial_traverse(root: UNode) -> List[UNode]:
    """Minimal post-order recompute set for an evaluation at ``root``.

    Returns the inner directed nodes whose CLVs must be recomputed, in
    dependency (post-) order, and marks them as the new buffer owners.
    Equivalent to `pll_utree_traverse` with the reference's
    ``cb_partial_traversal`` callback (`src/stepwise.c:103-123`), except
    staleness propagates upward here instead of being pre-marked along the
    whole path by the caller.
    """
    if root.is_tip:
        raise TreeError("traversal root must be an inner node")
    out: List[UNode] = []

    def rec(u: UNode) -> bool:
        if u.is_tip:
            return False
        d1 = rec(u.next.back)
        d2 = rec(u.next.next.back)
        if d1 or d2 or not u.clv_valid:
            out.append(u)
            for m in u.ring():
                m.clv_valid = m is u
            return True
        return False

    rec(root.back)
    rec(root)
    return out


def peek_partial(root: UNode) -> List[UNode]:
    """Like :func:`partial_traverse` but read-only: computes the minimal
    recompute set without flipping ownership flags.  Used for *candidate*
    evaluation in tree search, where the move will be rolled back and the
    base buffers stay untouched."""
    if root.is_tip:
        raise TreeError("traversal root must be an inner node")
    out: List[UNode] = []

    def rec(u: UNode) -> bool:
        if u.is_tip:
            return False
        d1 = rec(u.next.back)
        d2 = rec(u.next.next.back)
        if d1 or d2 or not u.clv_valid:
            out.append(u)
            return True
        return False

    rec(root.back)
    rec(root)
    return out


def snapshot_flags(nodes: List[UNode]):
    """Record (directed node, clv_valid) for the rings of ``nodes`` so a
    candidate move + rollback can restore validity exactly."""
    seen = []
    for n in nodes:
        if n is None:
            continue
        for m in ([n] if n.is_tip else n.ring()):
            seen.append((m, m.clv_valid))
    return seen


def restore_flags(snapshot) -> None:
    for node, flag in snapshot:
        node.clv_valid = flag


def create_partial_operations(nodes: List[UNode]):
    """Operations for a :func:`partial_traverse` subset (the op-emitting
    half of `pll_utree_create_operations`, utree.c:284-329; branch/pmatrix
    refresh lists come from the move that caused the invalidation)."""
    from ..engine.partition import Operation

    return [Operation(
        parent_clv_index=n.clv_index,
        parent_scaler_index=n.scaler_index,
        child1_clv_index=n.next.back.clv_index,
        child1_matrix_index=n.next.back.pmatrix_index,
        child1_scaler_index=n.next.back.scaler_index,
        child2_clv_index=n.next.next.back.clv_index,
        child2_matrix_index=n.next.next.back.pmatrix_index,
        child2_scaler_index=n.next.next.back.scaler_index,
    ) for n in nodes if not n.is_tip]


class PeekIndex:
    """O(path)-per-candidate :func:`peek_partial` for tree search.

    ``peek_partial`` walks the whole tree per candidate (O(n) host time ×
    O(n) candidates per SPR round = the dominant host cost at large tree
    sizes).  This index, built ONCE per round on the *base* topology
    (all-valid flags, fixed evaluation root), prunes the walk with a
    base-tree Euler-interval oracle:

      * every toward-root direction gets its base post-order subtree
        interval ``[lo, hi]``; every ring/tip gets a scalar time;
      * a candidate move relinks a handful of ring endpoints
        (:func:`libpll_tpu_torch.tree.moves.record_flips` captures exactly the
        directions it invalidated).  If none of the flipped rings' times
        fall inside ``[lo(d), hi(d)]``, the move is entirely disjoint
        from base-subtree(d): current-subtree(d) is identical, untouched
        and valid — the walk prunes.  Otherwise it descends and applies
        the *original* exact condition.

    The oracle errs only toward "maybe" (directions missing from the
    index — e.g. orientations flipped by moving a root-containing
    subtree — always descend), so the result is exactly
    ``peek_partial``'s, at O(depth × flips) typical cost.
    """

    def __init__(self, root: UNode):
        if root.is_tip:
            raise TreeError("traversal root must be an inner node")
        self.root = root
        self.times: dict = {}
        self.intervals: dict = {}
        # the interval prune asserts "untouched subtree == all valid",
        # which holds only on a fully-valid base (as after update_partials
        # + mark_valid); otherwise peek() falls back to the full walk
        self.base_clean = True
        counter = 0

        def dfs(u: UNode):
            nonlocal counter
            if u.is_tip:
                t = counter
                counter += 1
                self.times[id(u)] = t
                return t, t
            if not u.clv_valid:
                self.base_clean = False
            lo1, _ = dfs(u.next.back)
            dfs(u.next.next.back)
            t = counter
            counter += 1
            for m in u.ring():
                self.times[id(m)] = t
            self.intervals[id(u)] = (lo1, t)
            return lo1, t

        if not root.back.is_tip:
            dfs(root.back)
        else:
            t = counter
            counter += 1
            self.times[id(root.back)] = t
        dfs(root)

    def peek(self, flipped) -> List[UNode]:
        """Read-only minimal recompute set after a candidate move whose
        invalidated directions are ``flipped`` (see
        :func:`libpll_tpu_torch.tree.moves.record_flips`).  Flags untouched."""
        times = self.times
        intervals = self.intervals
        if not self.base_clean or any(id(m) not in times for m in flipped):
            # stale base flags, or a flipped direction the base tree never
            # saw: no oracle — fall back to the exact full walk
            return peek_partial(self.root)
        marks = sorted({times[id(m)] for m in flipped})
        out: List[UNode] = []

        def rec(u: UNode) -> bool:
            if u.is_tip:
                return False
            iv = intervals.get(id(u))
            if iv is not None:
                lo, hi = iv
                # marks is tiny (≤ ~8); linear scan beats bisect here
                if not any(lo <= t <= hi for t in marks):
                    return False
            d1 = rec(u.next.back)
            d2 = rec(u.next.next.back)
            if d1 or d2 or not u.clv_valid:
                out.append(u)
                return True
            return False

        rec(self.root.back)
        rec(self.root)
        return out

    def contains(self, start: UNode, target: UNode) -> bool:
        """O(1) equivalent of :func:`libpll_tpu_torch.tree.moves._subtree_contains`
        on the *base* topology: is ``target`` inside the subtree hanging
        off directed node ``start`` (its ring plus the branches behind
        ``start.next`` / ``start.next.next``)?

        Euler identities: a computed (DFS-entered) direction's subtree is
        exactly its post-order interval; any other ring member's subtree
        is the complement of the branch behind it, which is the interval
        of its ``back`` (always a computed direction or a tip)."""
        from . import moves as _moves

        tt = self.times.get(id(target))
        if not self.base_clean or tt is None:
            return _moves._subtree_contains(start, target)
        iv = self.intervals.get(id(start))
        if iv is not None:
            return iv[0] <= tt <= iv[1]
        b = start.back
        if b is None:
            return _moves._subtree_contains(start, target)
        if b.is_tip:
            bt = self.times.get(id(b))
            if bt is None:
                return _moves._subtree_contains(start, target)
            return tt != bt
        ivb = self.intervals.get(id(b))
        if ivb is None:
            return _moves._subtree_contains(start, target)
        return not (ivb[0] <= tt <= ivb[1])
