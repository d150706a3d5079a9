"""Unrooted phylogenetic trees: circular-linked-node graphs, traversals and
operation-schedule generation.

Capability parity with the reference's tree layer (libpll `src/utree.c`,
`src/parse_utree.y`): every inner node is a ring of three :class:`UNode`
records (one per incident edge) whose ``back`` pointers connect edges; tips
are single nodes with ``next is None``. The host-side tree layer produces
*operation schedules* — flat arrays of CLV-update triplets — that the device
engine executes; topology never reaches the device.

Index conventions are identical to the reference
(`pll_utree_reset_template_indices`, parse_utree.y:299-340): tips get
``clv_index == node_index == pmatrix_index`` in DFS order and
``scaler_index == -1``; each inner ring shares one ``clv_index`` (numbered
from ``tip_count``) and one ``scaler_index`` (numbered from 0); every edge's
``pmatrix_index`` equals the clv index of its child-side node (the root edge
reuses the index of the root's back node).

Counterpart: ``libpll_tpu/tree/utree.py``, copied (parsing, index
conventions, traversals, operation generation, export, cloning, integrity
checks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

from ..errors import NewickError, TreeError
from ..utils.constants import SCALE_BUFFER_NONE

TRAVERSE_POSTORDER = 1
TRAVERSE_PREORDER = 2


class UNode:
    """One directed end of an edge; inner nodes are rings of three."""

    __slots__ = ("label", "length", "node_index", "clv_index", "scaler_index",
                 "pmatrix_index", "next", "back", "data", "clv_valid")

    def __init__(self, label: Optional[str] = None, length: float = 0.0):
        self.label = label
        self.length = length
        self.node_index = 0
        self.clv_index = 0
        self.scaler_index = 0
        self.pmatrix_index = 0
        self.next: Optional[UNode] = None
        self.back: Optional[UNode] = None
        self.data = None
        # per-direction CLV validity (tree/incremental.py; the reference's
        # clv_valid-via-data-pointer trick, stepwise.c:103-123)
        self.clv_valid = False

    @property
    def is_tip(self) -> bool:
        return self.next is None

    def ring(self):
        """Iterate the nodes of this inner node's ring (self first)."""
        yield self
        n = self.next
        while n is not None and n is not self:
            yield n
            n = n.next

    def __repr__(self):  # pragma: no cover
        kind = "tip" if self.is_tip else "inner"
        return (f"<UNode {kind} label={self.label!r} clv={self.clv_index} "
                f"len={self.length}>")


@dataclass
class UTree:
    """Wrapped unrooted tree (reference pll_utree_t, pll.h:336-344)."""

    nodes: List[UNode]  # tips first, inner rings' primary nodes after
    tip_count: int

    @property
    def inner_count(self) -> int:
        return self.tip_count - 2

    @property
    def edge_count(self) -> int:
        return 2 * self.tip_count - 3

    @property
    def root(self) -> UNode:
        """The designated inner node (last in the node array)."""
        return self.nodes[-1]


# ---------------------------------------------------------------------------
# newick parsing (recursive descent; replaces the bison/flex grammar)
# ---------------------------------------------------------------------------
class _Tokenizer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def peek(self) -> str:
        self._skip_ws()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def take(self, ch: str) -> None:
        if self.peek() != ch:
            raise NewickError(
                f"syntax error: expected {ch!r} at position {self.pos}")
        self.pos += 1

    def _skip_ws(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1

    def label(self) -> Optional[str]:
        self._skip_ws()
        start = self.pos
        if self.pos < len(self.text) and self.text[self.pos] in "'\"":
            quote = self.text[self.pos]
            self.pos += 1
            while self.pos < len(self.text) and self.text[self.pos] != quote:
                self.pos += 1
            if self.pos >= len(self.text):
                raise NewickError("unterminated quoted label")
            self.pos += 1
            return self.text[start + 1:self.pos - 1]
        while (self.pos < len(self.text)
               and self.text[self.pos] not in "():,;[] \t\n\r"):
            self.pos += 1
        return self.text[start:self.pos] if self.pos > start else None

    def length(self) -> Optional[float]:
        if self.peek() == ":":
            self.take(":")
            lab = self.label()
            if lab is None:
                raise NewickError("missing branch length after ':'")
            try:
                return float(lab)
            except ValueError as e:
                raise NewickError(f"invalid branch length {lab!r}") from e
        return None


def _make_inner(child1: UNode, child2: UNode, label, length) -> UNode:
    """Ring of three; the returned node is the up-facing one
    (parse_utree.y:205-230 wiring)."""
    top = UNode(label, length or 0.0)
    n2 = UNode(label, child1.length)
    n3 = UNode(label, child2.length)
    top.next, n2.next, n3.next = n2, n3, top
    n2.back, child1.back = child1, n2
    n3.back, child2.back = child2, n3
    return top


def _parse_subtree(tk: _Tokenizer) -> UNode:
    if tk.peek() == "(":
        tk.take("(")
        c1 = _parse_subtree(tk)
        tk.take(",")
        c2 = _parse_subtree(tk)
        children = [c1, c2]
        # tolerate multifurcations by left-factoring extra children into
        # nested binary nodes is NOT reference behavior; reference rejects.
        tk.take(")")
        label = tk.label()
        length = tk.length()
        return _make_inner(children[0], children[1], label, length)
    label = tk.label()
    if label is None:
        raise NewickError("expected label")
    length = tk.length()
    return UNode(label, length or 0.0)


def parse_newick_string(text: str) -> UTree:
    """Parse an unrooted newick string ``(t1,t2,t3)...;`` into a
    :class:`UTree` (reference `pll_utree_parse_newick_string`,
    parse_utree.y:493-526)."""
    tk = _Tokenizer(text)
    tk.take("(")
    s1 = _parse_subtree(tk)
    tk.take(",")
    s2 = _parse_subtree(tk)
    tk.take(",")
    s3 = _parse_subtree(tk)
    tk.take(")")
    label = tk.label()
    tk.length()  # root length is parsed and discarded (grammar line 202)
    tk.take(";")

    root = UNode(label, s1.length)
    r2 = UNode(label, s2.length)
    r3 = UNode(label, s3.length)
    root.next, r2.next, r3.next = r2, r3, root
    root.back, s1.back = s1, root
    r2.back, s2.back = s2, r2
    r3.back, s3.back = s3, r3

    reset_template_indices(root, _count_tips(root))
    return wraptree(root)


def parse_newick(path: str) -> UTree:
    with open(path) as fh:
        return parse_newick_string(fh.read())


def _count_tips(root: UNode) -> int:
    def rec(node: UNode) -> int:
        if node.is_tip:
            return 1
        return rec(node.next.back) + rec(node.next.next.back)

    return sum(rec(n.back) for n in root.ring())


def reset_template_indices(root: UNode, tip_count: int) -> None:
    """Canonical index assignment (parse_utree.y:250-340)."""
    counters = {"tip": 0, "clv": tip_count, "scaler": 0, "node": tip_count}

    def rec(node: UNode) -> None:
        if node.is_tip:
            node.node_index = node.clv_index = node.pmatrix_index = \
                counters["tip"]
            node.scaler_index = SCALE_BUFFER_NONE
            counters["tip"] += 1
            return
        rec(node.next.back)
        rec(node.next.next.back)
        for off, n in enumerate(node.ring()):
            n.node_index = counters["node"] + off
            n.clv_index = counters["clv"]
            n.scaler_index = counters["scaler"]
        node.pmatrix_index = counters["clv"]
        node.next.pmatrix_index = node.next.back.pmatrix_index
        node.next.next.pmatrix_index = node.next.next.back.pmatrix_index
        counters["clv"] += 1
        counters["scaler"] += 1
        counters["node"] += 3

    rec(root.back)
    rec(root.next.back)
    rec(root.next.next.back)
    for off, n in enumerate(root.ring()):
        n.node_index = counters["node"] + off
        n.clv_index = counters["clv"]
        n.scaler_index = counters["scaler"]
    root.pmatrix_index = root.back.pmatrix_index
    root.next.pmatrix_index = root.next.back.pmatrix_index
    root.next.next.pmatrix_index = root.next.next.back.pmatrix_index


def wraptree(root: UNode, tip_count: int = 0) -> UTree:
    """Collect nodes into the canonical array: tips (DFS order) first, inner
    primary nodes post-order, root last (parse_utree.y:341-445)."""
    if tip_count == 0:
        tip_count = _count_tips(root)
    tips: List[UNode] = []
    inner: List[UNode] = []

    def fill(node: UNode) -> None:
        if node.is_tip:
            tips.append(node)
            return
        fill(node.next.back)
        fill(node.next.next.back)
        inner.append(node)

    for n in root.ring():
        fill(n.back)
    inner.append(root)
    return UTree(nodes=tips + inner, tip_count=tip_count)


# ---------------------------------------------------------------------------
# traversal and operation generation (utree.c:284-442)
# ---------------------------------------------------------------------------
def traverse(root: UNode, order: int = TRAVERSE_POSTORDER,
             cb: Optional[Callable[[UNode], bool]] = None) -> List[UNode]:
    """Pre/post-order traversal of the unrooted tree seen from ``root``.

    ``cb`` decides whether to descend into a subtree (partial traversals:
    return False at nodes whose CLV is still valid). Mirrors
    `pll_utree_traverse` (utree.c:403-442): both ``root.back``'s subtree and
    ``root``'s side are visited, so the buffer ends with ``root``.
    """
    if root.is_tip:
        raise TreeError("traversal root must be an inner node")
    cb = cb or (lambda n: True)
    out: List[UNode] = []

    def post(node: UNode) -> None:
        if node.is_tip:
            if cb(node):
                out.append(node)
            return
        if not cb(node):
            return
        post(node.next.back)
        post(node.next.next.back)
        out.append(node)

    def pre(node: UNode) -> None:
        if node.is_tip:
            if cb(node):
                out.append(node)
            return
        if not cb(node):
            return
        out.append(node)
        pre(node.next.back)
        pre(node.next.next.back)

    fn = post if order == TRAVERSE_POSTORDER else pre
    fn(root.back)
    fn(root)
    return out


def create_operations(trav_buffer: List[UNode]):
    """Convert a post-order traversal into (operations, branches,
    pmatrix_indices) — `pll_utree_create_operations` (utree.c:284-329).

    The duplicate root edge (the buffer's last node's ``back``) contributes
    no matrix entry.
    """
    from ..engine.partition import Operation

    ops = []
    branches = []
    pmatrix_indices = []
    skip = trav_buffer[-1].back
    for node in trav_buffer:
        if node is not skip:
            branches.append(node.length)
            pmatrix_indices.append(node.pmatrix_index)
        if not node.is_tip:
            ops.append(Operation(
                parent_clv_index=node.clv_index,
                parent_scaler_index=node.scaler_index,
                child1_clv_index=node.next.back.clv_index,
                child1_matrix_index=node.next.back.pmatrix_index,
                child1_scaler_index=node.next.back.scaler_index,
                child2_clv_index=node.next.next.back.clv_index,
                child2_matrix_index=node.next.next.back.pmatrix_index,
                child2_scaler_index=node.next.next.back.scaler_index,
            ))
    return ops, branches, pmatrix_indices


# ---------------------------------------------------------------------------
# export / clone / integrity (utree.c:122-282, 512-611)
# ---------------------------------------------------------------------------
def export_newick(root: UNode, precision: int = 6) -> str:
    """Newick string rooted at an inner node (utree.c:217-282)."""

    def rec(node: UNode) -> str:
        if node.is_tip:
            return f"{node.label or ''}:{node.length:.{precision}f}"
        subs = ",".join(rec(n.back) for n in list(node.ring())[1:])
        return f"({subs}){node.label or ''}:{node.length:.{precision}f}"

    subs = ",".join(rec(n.back) for n in root.ring())
    return f"({subs}){root.label or ''};"


def clone(tree: UTree) -> UTree:
    """Deep copy preserving all indices (`pll_utree_clone`,
    utree.c:546-611)."""

    def clone_node(node: UNode) -> UNode:
        c = UNode(node.label, node.length)
        c.node_index = node.node_index
        c.clv_index = node.clv_index
        c.scaler_index = node.scaler_index
        c.pmatrix_index = node.pmatrix_index
        c.clv_valid = node.clv_valid
        return c

    def rec(node: UNode) -> UNode:
        """Clone the subtree hanging below `node` (an up-facing unode);
        returns the cloned up-facing node."""
        c = clone_node(node)
        if node.is_tip:
            return c
        ring = list(node.ring())[1:]
        prev = c
        for n in ring:
            cn = clone_node(n)
            prev.next = cn
            sub = rec(n.back)
            cn.back, sub.back = sub, cn
            prev = cn
        prev.next = c
        return c

    root = tree.root
    croot = clone_node(root)
    prev = croot
    subs = []
    for n in list(root.ring()):
        if n is not root:
            cn = clone_node(n)
            prev.next = cn
            prev = cn
        subs.append((prev if n is not root else croot, n.back))
    prev.next = croot
    for cn, back in subs:
        sub = rec(back)
        cn.back, sub.back = sub, cn
    return wraptree(croot, tree.tip_count)


def check_integrity(tree: UTree) -> bool:
    """Structural sanity check (`pll_utree_check_integrity`,
    utree.c:512-544)."""
    for node in tree.nodes:
        if node.is_tip:
            if node.back is None or node.back.back is not node:
                return False
            if node.length != node.back.length:
                return False
            continue
        ring = list(node.ring())
        if len(ring) < 3:
            return False
        for n in ring:
            if n.back is None or n.back.back is not n:
                return False
            if n.length != n.back.length:
                return False
            if n.clv_index != node.clv_index:
                return False
    return True


def show_ascii(root: UNode, out=None) -> str:
    """ASCII rendering (capability parity with `pll_utree_show_ascii`,
    utree.c:122-176; layout differs)."""
    lines: List[str] = []

    def rec(node: UNode, prefix: str, is_last: bool) -> None:
        connector = "`-- " if is_last else "|-- "
        name = node.label if node.is_tip else "*"
        lines.append(f"{prefix}{connector}{name}:{node.length:g}")
        if not node.is_tip:
            ext = "    " if is_last else "|   "
            children = [n.back for n in list(node.ring())[1:]]
            for i, ch in enumerate(children):
                rec(ch, prefix + ext, i == len(children) - 1)

    lines.append("*")
    children = [n.back for n in root.ring()]
    for i, ch in enumerate(children):
        rec(ch, "", i == len(children) - 1)
    text = "\n".join(lines)
    if out is not None:
        out.write(text + "\n")
    return text


def create_pars_buildops(trav_buffer: List[UNode]):
    """(parent, child1, child2) score-index triplets for Fitch/Sankoff
    (reference `pll_utree_create_pars_buildops`, utree.c:740-763)."""
    return [(n.clv_index, n.next.back.clv_index, n.next.next.back.clv_index)
            for n in trav_buffer if not n.is_tip]


def query_tipnodes(tree: UTree) -> List[UNode]:
    """All tip nodes (reference pll_utree_query_tipnodes)."""
    return [n for n in tree.nodes if n.is_tip]


def query_innernodes(tree: UTree) -> List[UNode]:
    """All inner nodes, one ring representative each
    (reference pll_utree_query_innernodes)."""
    return [n for n in tree.nodes if not n.is_tip]


def every(tree: UTree, cb) -> bool:
    """Apply ``cb`` to every node (all ring members); True iff all calls
    return truthy (reference pll_utree_every / pll_utree_every_const)."""
    ok = True
    for n in tree.nodes:
        ring = [n] if n.is_tip else list(n.ring())
        for m in ring:
            ok = bool(cb(m)) and ok
    return ok
