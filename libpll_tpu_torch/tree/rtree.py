"""Rooted phylogenetic trees.

Capability parity with the reference's rooted-tree API (libpll `src/rtree.c`,
`src/parse_rtree.y`): binary rooted trees with left/right/parent pointers,
pre/post-order traversals with pruning callbacks, operation-schedule
generation, index conventions identical to the unrooted layer (tips DFS-first,
inner nodes post-order; root has no branch), and conversion to an unrooted
tree (`pll_rtree_unroot`, utree.c:613-738).

Counterpart: ``libpll_tpu/tree/rtree.py``, copied (host code; the
JAX package's modules cannot be imported without loading jax).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..errors import NewickError, TreeError
from ..utils.constants import SCALE_BUFFER_NONE
from .utree import (TRAVERSE_POSTORDER, TRAVERSE_PREORDER, UNode, UTree,
                    _Tokenizer, reset_template_indices as _ureset, wraptree)


class RNode:
    """reference pll_rnode_t (pll.h:346-363)."""

    __slots__ = ("label", "length", "node_index", "clv_index", "scaler_index",
                 "pmatrix_index", "left", "right", "parent", "data")

    def __init__(self, label: Optional[str] = None, length: float = 0.0):
        self.label = label
        self.length = length
        self.node_index = 0
        self.clv_index = 0
        self.scaler_index = 0
        self.pmatrix_index = 0
        self.left: Optional[RNode] = None
        self.right: Optional[RNode] = None
        self.parent: Optional[RNode] = None
        self.data = None

    @property
    def is_tip(self) -> bool:
        return self.left is None

    def __repr__(self):  # pragma: no cover
        kind = "tip" if self.is_tip else "inner"
        return f"<RNode {kind} label={self.label!r} clv={self.clv_index}>"


@dataclass
class RTree:
    """reference pll_rtree_t (pll.h:365-371)."""

    nodes: List[RNode]
    tip_count: int

    @property
    def inner_count(self) -> int:
        return self.tip_count - 1

    @property
    def edge_count(self) -> int:
        return 2 * self.tip_count - 2

    @property
    def root(self) -> RNode:
        return self.nodes[-1]


def _parse_subtree(tk: _Tokenizer) -> RNode:
    if tk.peek() == "(":
        tk.take("(")
        left = _parse_subtree(tk)
        tk.take(",")
        right = _parse_subtree(tk)
        tk.take(")")
        node = RNode(tk.label(), tk.length() or 0.0)
        node.left, node.right = left, right
        left.parent = right.parent = node
        return node
    label = tk.label()
    if label is None:
        raise NewickError("expected label")
    return RNode(label, tk.length() or 0.0)


def parse_newick_string(text: str) -> RTree:
    """Parse a rooted binary newick ``(a,b)...;``
    (reference `pll_rtree_parse_newick_string`)."""
    tk = _Tokenizer(text)
    root = _parse_subtree(tk)
    tk.take(";")
    if root.is_tip:
        raise NewickError("rooted tree must have an inner root")
    tip_count = _count_tips(root)
    reset_template_indices(root, tip_count)
    return wrap(root, tip_count)


def parse_newick(path: str) -> RTree:
    with open(path) as fh:
        return parse_newick_string(fh.read())


def _count_tips(node: RNode) -> int:
    if node.is_tip:
        return 1
    return _count_tips(node.left) + _count_tips(node.right)


def reset_template_indices(root: RNode, tip_count: int) -> None:
    """Canonical index assignment (parse_rtree.y:167-220)."""
    counters = {"tip": 0, "clv": tip_count, "scaler": 0, "node": tip_count}

    def rec(node: RNode) -> None:
        if node.is_tip:
            node.node_index = node.clv_index = node.pmatrix_index = \
                counters["tip"]
            node.scaler_index = SCALE_BUFFER_NONE
            counters["tip"] += 1
            return
        rec(node.left)
        rec(node.right)
        node.node_index = counters["node"]
        node.clv_index = node.pmatrix_index = counters["clv"]
        node.scaler_index = counters["scaler"]
        counters["clv"] += 1
        counters["scaler"] += 1
        counters["node"] += 1

    rec(root)


def wrap(root: RNode, tip_count: int) -> RTree:
    tips: List[RNode] = []
    inner: List[RNode] = []

    def fill(node: RNode) -> None:
        if node.is_tip:
            tips.append(node)
            return
        fill(node.left)
        fill(node.right)
        inner.append(node)

    fill(root)
    return RTree(nodes=tips + inner, tip_count=tip_count)


def traverse(root: RNode, order: int = TRAVERSE_POSTORDER,
             cb: Optional[Callable[[RNode], bool]] = None) -> List[RNode]:
    """Pre/post-order with pruning callback (rtree.c:306-387)."""
    if root.is_tip:
        raise TreeError("traversal root must be an inner node")
    cb = cb or (lambda n: True)
    out: List[RNode] = []

    def post(node: RNode) -> None:
        if node.is_tip:
            if cb(node):
                out.append(node)
            return
        if not cb(node):
            return
        post(node.left)
        post(node.right)
        out.append(node)

    def pre(node: RNode) -> None:
        if node.is_tip:
            if cb(node):
                out.append(node)
            return
        if not cb(node):
            return
        out.append(node)
        pre(node.left)
        pre(node.right)

    (post if order == TRAVERSE_POSTORDER else pre)(root)
    return out


def create_operations(trav_buffer: List[RNode]):
    """(operations, branches, pmatrix_indices); the root contributes no
    branch (rtree.c:262-304)."""
    from ..engine.partition import Operation

    ops, branches, pmatrix_indices = [], [], []
    for i, node in enumerate(trav_buffer):
        if i < len(trav_buffer) - 1:
            branches.append(node.length)
            pmatrix_indices.append(node.pmatrix_index)
        if not node.is_tip:
            ops.append(Operation(
                parent_clv_index=node.clv_index,
                parent_scaler_index=node.scaler_index,
                child1_clv_index=node.left.clv_index,
                child1_matrix_index=node.left.pmatrix_index,
                child1_scaler_index=node.left.scaler_index,
                child2_clv_index=node.right.clv_index,
                child2_matrix_index=node.right.pmatrix_index,
                child2_scaler_index=node.right.scaler_index,
            ))
    return ops, branches, pmatrix_indices


def export_newick(root: RNode, precision: int = 6) -> str:
    def rec(node: RNode) -> str:
        if node.is_tip:
            return f"{node.label or ''}:{node.length:.{precision}f}"
        return (f"({rec(node.left)},{rec(node.right)})"
                f"{node.label or ''}:{node.length:.{precision}f}")

    return (f"({rec(root.left)},{rec(root.right)})"
            f"{root.label or ''};")


def unroot(rtree: RTree) -> UTree:
    """Convert to an unrooted tree (`pll_rtree_unroot`, utree.c:613-738):
    the root is dissolved, its two children joined by one edge whose length
    is the sum of the two root branches; indices reassigned canonically."""
    root = rtree.root
    if root.left.is_tip and root.right.is_tip:
        raise TreeError("cannot unroot a 2-taxon tree")

    # choose an inner child to become the new trifurcation
    new_root_child = root.left if not root.left.is_tip else root.right
    other = root.right if new_root_child is root.left else root.left
    joined_length = root.left.length + root.right.length

    def build(node: RNode) -> UNode:
        """Return the up-facing unode of the unrooted copy of `node`."""
        up = UNode(node.label, node.length)
        if node.is_tip:
            return up
        n2 = UNode(node.label, node.left.length)
        n3 = UNode(node.label, node.right.length)
        up.next, n2.next, n3.next = n2, n3, up
        lsub = build(node.left)
        rsub = build(node.right)
        n2.back, lsub.back = lsub, n2
        n3.back, rsub.back = rsub, n3
        return up

    # new unrooted root ring: the inner child's two subtrees + other side
    c = new_root_child
    s1 = build(c.left)
    s2 = build(c.right)
    s3 = build(other)
    s3.length = joined_length
    uroot = UNode(c.label, s1.length)
    r2 = UNode(c.label, s2.length)
    r3 = UNode(c.label, joined_length)
    uroot.next, r2.next, r3.next = r2, r3, uroot
    uroot.back, s1.back = s1, uroot
    r2.back, s2.back = s2, r2
    r3.back, s3.back = s3, r3

    _ureset(uroot, rtree.tip_count)
    return wraptree(uroot, rtree.tip_count)


def create_pars_buildops(trav_buffer: List[RNode]):
    """reference pll_rtree_create_pars_buildops (rtree.c:458-481)."""
    return [(n.clv_index, n.left.clv_index, n.right.clv_index)
            for n in trav_buffer if not n.is_tip]


def create_pars_recops(trav_buffer: List[RNode]):
    """Pre-order (node, parent) score-index pairs for ancestral
    reconstruction (reference pll_rtree_create_pars_recops,
    rtree.c:483-520); the root points at itself."""
    ops = []
    for n in trav_buffer:
        if n.is_tip:
            continue
        parent = n.parent.clv_index if n.parent is not None else n.clv_index
        ops.append((n.clv_index, parent))
    return ops


def query_tipnodes(tree: RTree) -> List[RNode]:
    """All tip nodes (reference pll_rtree_query_tipnodes)."""
    return [n for n in tree.nodes if n.left is None]


def query_innernodes(tree: RTree) -> List[RNode]:
    """All inner nodes (reference pll_rtree_query_innernodes)."""
    return [n for n in tree.nodes if n.left is not None]


def show_ascii(root: RNode, out=None) -> str:
    """ASCII rendering of a rooted tree (capability parity with
    `pll_rtree_show_ascii`, rtree.c; layout matches tree.utree.show_ascii)."""
    lines: List[str] = []

    def rec(node: RNode, prefix: str, is_last: bool) -> None:
        connector = "`-- " if is_last else "|-- "
        name = node.label if node.is_tip else "*"
        lines.append(f"{prefix}{connector}{name}:{node.length:g}")
        if not node.is_tip:
            ext = "    " if is_last else "|   "
            rec(node.left, prefix + ext, False)
            rec(node.right, prefix + ext, True)

    lines.append("*" if root.label is None else str(root.label))
    rec(root.left, "", False)
    rec(root.right, "", True)
    text = "\n".join(lines)
    if out is not None:
        out.write(text + "\n")
    return text
