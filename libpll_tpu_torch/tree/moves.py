"""Topological rearrangements: SPR and NNI with rollback.

Capability parity with libpll `src/utree_moves.c:24-375`. Moves mutate the
host-side tree; they return the changed ``(branch_length, pmatrix_index)``
pairs so the caller can refresh exactly those P-matrices and re-run a partial
(dirty-subtree) traversal, keeping incremental device updates cheap:

  * SPR of the subtree behind inner node ``p`` onto edge ``r``—``r.back``:
    3 changed branches (the joined orphan edge keeps its summed length; the
    bisected regraft edge gets half of ``r``'s length on each side);
  * NNI across the inner edge ``p``—``p.back``: swaps ``p.next``'s subtree
    with one of the two subtrees on the far side; branch lengths and pmatrix
    indices travel with the edges, so no P-matrix updates are needed.

Counterpart: ``libpll_tpu/tree/moves.py``, copied.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..errors import SprError, ParamError
from .utree import UNode

# when set (see record_flips), _link appends every direction it
# invalidates — the seed set tree search feeds to incremental.PeekIndex
_flip_log: Optional[List[UNode]] = None


@contextmanager
def record_flips():
    """Collect the directed nodes invalidated by moves executed in this
    context (each ring the move relinks)."""
    global _flip_log
    prev, _flip_log = _flip_log, []
    try:
        yield _flip_log
    finally:
        _flip_log = prev

MOVE_SPR = 1
MOVE_NNI = 2
NNI_LEFT = 1
NNI_RIGHT = 2


@dataclass
class Rollback:
    """Undo record (reference pll_utree_rb_t, pll.h:365-387)."""

    move_type: int
    # SPR fields
    p: Optional[UNode] = None
    r: Optional[UNode] = None
    rb: Optional[UNode] = None
    r_len: float = 0.0
    pnb: Optional[UNode] = None
    pnb_len: float = 0.0
    pnnb: Optional[UNode] = None
    pnnb_len: float = 0.0
    # NNI fields
    nni_type: int = 0


def _link(a: UNode, b: UNode, length: float, pmatrix_index: int) -> None:
    a.back = b
    b.back = a
    a.length = b.length = length
    a.pmatrix_index = b.pmatrix_index = pmatrix_index
    # every directed CLV whose children involve the relinked edge is now
    # stale (tree/incremental.py tracks per-direction validity; upward
    # propagation happens in partial_traverse)
    for end in (a, b):
        if end.next is not None:
            for m in end.ring():
                if m is not end:
                    m.clv_valid = False
                    if _flip_log is not None:
                        _flip_log.append(m)


def _swap(t1: UNode, t2: UNode) -> None:
    """Swap subtree positions; lengths/pmatrix indices travel with edges."""
    temp = t1.back
    _link(t1, t2.back, t2.back.length, t2.back.pmatrix_index)
    _link(t2, temp, temp.length, temp.pmatrix_index)


def _subtree_contains(start: UNode, target: UNode) -> bool:
    if start is None:
        return False
    if start is target:
        return True
    if start.next is None:
        return False
    if start.next is target or start.next.next is target:
        return True
    return (_subtree_contains(start.next.back, target)
            or _subtree_contains(start.next.next.back, target))


def nni(p: UNode, nni_type: int, rollback: Optional[Rollback] = None) -> None:
    """Nearest-neighbor interchange across the inner edge p—p.back."""
    if nni_type not in (NNI_LEFT, NNI_RIGHT):
        raise SprError("Invalid NNI move type")
    if p.next is None or p.back.next is None:
        raise SprError("Specified terminal branch")
    if rollback is not None:
        rollback.move_type = MOVE_NNI
        rollback.p = p
        rollback.nni_type = nni_type
    subtree1 = p.next
    subtree2 = p.back.next if nni_type == NNI_LEFT else p.back.next.next
    _swap(subtree1, subtree2)


def spr(p: UNode, r: UNode, rollback: Optional[Rollback] = None,
        ) -> List[Tuple[float, int]]:
    """Prune the subtree behind inner node ``p``; regraft on edge r—r.back.

    Returns the 3 changed (branch_length, pmatrix_index) pairs.
    ``r`` must not be inside the pruned subtree (checked by
    :func:`spr_safe`).
    """
    if p.next is None:
        raise SprError("Prune edge must be defined by an inner node")
    if r in (p, p.back, p.next, p.next.back, p.next.next, p.next.next.back):
        raise SprError("Proposed move yields the same tree")

    if rollback is not None:
        rollback.move_type = MOVE_SPR
        rollback.p = p
        rollback.r = r
        rollback.rb = r.back
        rollback.r_len = r.length
        rollback.pnb = p.next.back
        rollback.pnb_len = p.next.length
        rollback.pnnb = p.next.next.back
        rollback.pnnb_len = p.next.next.length

    changed: List[Tuple[float, int]] = []

    # (b) join the two orphaned edges
    u = p.next.back
    v = p.next.next.back
    _link(u, v, u.length + v.length, u.pmatrix_index)
    changed.append((u.length, u.pmatrix_index))

    # (a) detach the pruned node's side pointers
    p.next.back = p.next.next.back = None

    # (c) bisect the regraft edge
    length = r.length / 2
    rback = r.back
    _link(rback, p.next.next, length, p.next.next.pmatrix_index)
    changed.append((length, p.next.next.pmatrix_index))
    _link(r, p.next, length, r.pmatrix_index)
    changed.append((length, r.pmatrix_index))
    return changed


def spr_safe(p: UNode, r: UNode, rollback: Optional[Rollback] = None,
             ) -> List[Tuple[float, int]]:
    """SPR with containment check (reference `pll_utree_spr_safe`)."""
    if p is None or r is None:
        raise ParamError("p and r must be set")
    if p.next is None:
        raise SprError("Prune edge must be defined by an inner node")
    if r in (p, p.back, p.next, p.next.back, p.next.next, p.next.next.back):
        raise SprError("Proposed move yields the same tree")
    if _subtree_contains(p.back, r):
        raise SprError("Node r is part of the subtree to be pruned")
    return spr(p, r, rollback)


def rollback_move(rb: Rollback) -> List[Tuple[float, int]]:
    """Undo the recorded move (reference `pll_utree_rollback`)."""
    if rb.move_type == MOVE_NNI:
        nni(rb.p, rb.nni_type, None)
        return []
    if rb.move_type != MOVE_SPR:
        raise ParamError("Invalid move type")
    changed = []
    _link(rb.pnb, rb.p.next, rb.pnb_len, rb.pnb.pmatrix_index)
    changed.append((rb.pnb_len, rb.pnb.pmatrix_index))
    _link(rb.pnnb, rb.p.next.next, rb.pnnb_len,
          rb.p.next.next.pmatrix_index)
    changed.append((rb.pnnb_len, rb.p.next.next.pmatrix_index))
    _link(rb.r, rb.rb, rb.r_len, rb.r.pmatrix_index)
    changed.append((rb.r_len, rb.r.pmatrix_index))
    return changed
