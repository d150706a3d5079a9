"""Topology comparison: bipartitions and the Robinson-Foulds distance.

The reference library ships no tree-comparison entry point (users reach
for pll-modules/RAxML for RF); the rebuild carries it first-class because
the inference quality anchors (scripts/bench_infer.py RF-to-truth column,
tests/test_search_quality.py exhaustive comparison) need it.

An unrooted binary tree on n taxa has n-3 internal edges; each defines a
bipartition (split) of the taxon set.  The RF distance is the size of the
symmetric difference of the two trees' split sets — 0 iff the topologies
are identical, at most 2(n-3) for fully incompatible binary trees.

Counterpart: ``libpll_tpu/tree/compare.py``, copied.
"""

from __future__ import annotations

from typing import FrozenSet, Set

from .utree import UNode, UTree, query_tipnodes


def _collect_side(edge: UNode) -> FrozenSet[str]:
    """Tip labels on the subtree behind ``edge.back``."""
    labels = []

    def rec(u: UNode) -> None:
        if u.next is None:  # tip
            labels.append(u.label)
            return
        for m in list(u.ring())[1:]:
            rec(m.back)

    rec(edge.back)
    return frozenset(labels)


def bipartitions(tree: UTree) -> Set[FrozenSet[str]]:
    """The set of non-trivial splits, each canonicalized to the side NOT
    containing the lexicographically smallest taxon label (so two trees on
    the same taxon set produce directly comparable sets)."""
    tips = query_tipnodes(tree)
    all_labels = frozenset(t.label for t in tips)
    anchor = min(all_labels)
    splits: Set[FrozenSet[str]] = set()
    seen = set()

    def walk(u: UNode) -> None:
        if u.next is None:
            return
        if id(u) in seen:
            return
        for m in u.ring():
            seen.add(id(m))
        for m in u.ring():
            child = m.back
            if child.next is not None:  # inner-inner edge = real split
                side = _collect_side(m)
                if 0 < len(side) < len(all_labels):
                    canon = (all_labels - side if anchor in side else side)
                    if 1 < len(canon) < len(all_labels) - 1:
                        splits.add(canon)
                walk(child)

    start = tree.root if tree.root.next is not None else tree.root.back
    walk(start)
    return splits


def rf_distance(tree_a: UTree, tree_b: UTree) -> int:
    """Robinson-Foulds distance (symmetric-difference count) between two
    unrooted trees on the same taxon set."""
    ta = frozenset(t.label for t in query_tipnodes(tree_a))
    tb = frozenset(t.label for t in query_tipnodes(tree_b))
    if ta != tb:
        raise ValueError("trees are on different taxon sets")
    sa, sb = bipartitions(tree_a), bipartitions(tree_b)
    return len(sa ^ sb)
