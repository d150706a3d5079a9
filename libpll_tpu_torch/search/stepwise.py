"""Randomized stepwise-addition parsimony tree construction.

Counterpart: ``libpll_tpu/search/stepwise.py``, capability parity with
``pll_fastparsimony_stepwise`` (libpll ``src/stepwise.c:337-546``): taxa
are shuffled with the bit-exact re-entrant RNG (seed 0 = no shuffle), a
3-taxon star is grown by greedily inserting each next taxon at the edge
minimizing the Fitch parsimony score, and the final score includes the
uninformative-site constant cost.

Directional Fitch vectors persist on the partitions' device across
insertions, one row per directed node (tips keep their packed rows).
Committing an insertion recomputes only the directions whose subtree gained
the new tip, and every candidate edge is scored in one call.  Two engines:

  * ``build`` (``engine="host"``): the insertion loop on the host, as JAX's
    host engine: per insertion the candidate scores (kernel P2, one launch
    per partition) are read back for ``np.argmin``, the splice and the
    dirty-row BFS run on the host's node graph, and the refresh runs as
    waves of Fitch ops (kernel P1, one launch per insertion and
    partition);
  * ``build_device`` (``"device"``, ``"auto"``): JAX's device-resident
    build: the topology lives on the card as a ``back`` involution over
    direction rows and the ring tables of ``fitch._ring_co_tables``; per
    insertion P2 scores the candidates and P3 commits (argmin, splice,
    refresh of every partition), issued back to back with no host read;
    ``back`` and the final scores are read once, at the end.

Several partitions sum their candidate scores before the argmin (reference
stepwise.c:288-297).  Tie-breaking matches the reference exactly: candidate
edges are enumerated in the reference's edge-list order (the three star
edges, then the two edges created by each insertion appended at the end,
stepwise.c:491-520) and the first minimum wins — so the same seed produces
the same topology and score.  ``mesh=`` (a ``parallel.mesh.SitesMesh``)
runs the device build with the Fitch word axis sharded across the ranks
(:meth:`StepwiseBuilder.build_device_sharded`).  Not ported: JAX's
compile-shape padding and dispatch segmentation.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Sequence, Tuple

import numpy as np
import torch

from ..errors import EinvalError
from ..ops import fitch
from ..tree import utree as ut
from ..tree.utree import UNode, UTree, reset_template_indices, wraptree
from ..utils.rng import shuffled_order
from .parsimony import FastParsimony


@contextlib.contextmanager
def deep_recursion(tips: int):
    """Room for the tree layer's recursive walks on a caterpillar-deep tree
    of ``tips`` taxa (greedy trees of random data come close to one); the
    limit is restored on exit."""
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 8 * tips + 1000))
    try:
        yield
    finally:
        sys.setrecursionlimit(old)


def direction_rows(partitions: Sequence[FastParsimony]):
    """[(vectors, costs)] per partition for a build over n taxa:
    ``n + 3·max(n - 2, 1)`` direction rows (``4n - 6`` from n = 3), the
    tips' packed rows first, the rest zero, on the partitions' device."""
    state = []
    for part in partitions:
        n = part.tips
        vecs = torch.zeros((n + 3 * max(n - 2, 1),)
                           + tuple(part.vectors.shape[1:]),
                           dtype=torch.int32, device=part.device)
        vecs[:n] = part.vectors[:n]
        state.append((vecs, torch.zeros(vecs.shape[0], dtype=torch.int32,
                                        device=part.device)))
    return state


def _make_star(labels, tips) -> UNode:
    """3-taxon star; returns the center's first ring node. Tip nodes carry
    their original taxon index in ``.data`` (the packed-vector row)."""
    t = []
    for i in tips:
        node = UNode(labels[i], 0.0)
        node.data = i
        t.append(node)
    r = [UNode(None, 0.0) for _ in range(3)]
    r[0].next, r[1].next, r[2].next = r[1], r[2], r[0]
    for ri, ti in zip(r, t):
        ri.back, ti.back = ti, ri
    return r[0]


class StepwiseBuilder:
    """Grows a tree by stepwise addition over one or more FastParsimony
    partitions (all must share the same taxon set and device)."""

    def __init__(self, partitions: Sequence[FastParsimony],
                 labels: Sequence[str]):
        self.partitions = list(partitions)
        self.labels = list(labels)
        self.tips = partitions[0].tips
        self.device = partitions[0].device
        for p in partitions:
            if p.tips != self.tips:
                raise ValueError("partitions disagree on taxon count")
            if p.device != self.device:
                raise EinvalError(f"partitions on {p.device} and "
                                  f"{self.device}: move one")

    def build(self, seed: int) -> Tuple[UTree, int]:
        """The host engine: committing an insertion recomputes the 3 new
        ring directions plus the directions whose subtree gained the new tip
        — each such direction has exactly one dirty child, so the set
        orders into BFS waves from the splice point (P1); candidate edges
        are scored in one call per partition (P2) and read back for the
        argmin (reference loop: stepwise.c:241-323)."""
        n = self.tips
        order = shuffled_order(n, seed)
        center = _make_star(self.labels, order[:3])
        # candidate edges in the reference's enumeration order: the three
        # star edges first, then the two edges created by each insertion
        # appended at the end (stepwise.c:491-520); first minimum wins
        edge_list = [center, center.next, center.next.next]

        # persistent direction rows: tips own rows 0..n-1 (their packed
        # vectors); every inner directed node gets a fresh row from n up
        state = direction_rows(self.partitions)
        next_row = n
        for m in center.ring():
            m.data = next_row
            next_row += 1

        def row(x: UNode) -> int:
            return x.data  # taxon index for tips, direction row for inners

        def op_of(w: UNode):
            return (row(w), row(w.next.back), row(w.next.next.back))

        def run(levels):
            for vecs, costs in state:
                fitch.fitch_waves(vecs, costs, levels)

        # star directions: one wave of 3
        run([[op_of(m) for m in center.ring()]])

        for next_tip in order[3:]:
            edges = [(u, u.back) for u in edge_list]
            idx = torch.tensor([[row(u) for u, _ in edges],
                                [row(v) for _, v in edges]],
                               dtype=torch.int32).to(self.device)
            total = torch.empty(len(edges), dtype=torch.int32,
                                device=self.device)
            for k, (vecs, costs) in enumerate(state):
                fitch.fitch_scores(vecs, costs, idx[0], idx[1], tip=next_tip,
                                   out=total, accumulate=k > 0)

            best = int(np.argmin(fitch.as_uint32(total)))
            u, v = edges[best]
            new_inner = self._splice(u, v, next_tip)
            ring = list(new_inner.ring())  # r0 faces u, r1 faces v, r2 tip
            for m in ring:
                m.data = next_row
                next_row += 1
            # two new candidate edges appended, matching the reference
            edge_list.append(new_inner.next)  # faces the old far endpoint
            edge_list.append(new_inner.next.next)  # faces the new tip

            # dirty BFS from the new ring: each affected direction has
            # exactly one dirty child, so BFS levels are dependency-safe
            levels = [[op_of(m) for m in ring]]
            frontier = list(ring)
            seen = {id(m) for m in ring}
            while frontier:
                nxt = []
                for c in frontier:
                    cb = c.back
                    if cb.next is None:
                        continue
                    for w in cb.ring():
                        if w is not cb and id(w) not in seen:
                            seen.add(id(w))
                            nxt.append(w)
                if nxt:
                    levels.append([op_of(w) for w in nxt])
                frontier = nxt
            run(levels)

        # finalize: score the full tree via the partitions' own buffers
        with deep_recursion(n):
            tree = self._wrap(center)
            score = self._final_score(tree)
        return tree, score

    def build_device(self, seed: int) -> Tuple[UTree, int]:
        """The device-resident build: per insertion one P2 launch per
        partition (the candidate edges are ``edge_rows[:2i-3]`` and their
        far ends ``back`` of them, both on the card) and one P3 launch
        (first-minimum argmin, splice, refresh of every partition), issued
        with no host read; the host reads ``back`` and the per-partition
        final scores once.  Same shuffled order, edge enumeration and
        tie-break as :meth:`build`."""
        n = self.tips
        if n < 4:
            return self.build(seed)
        order = shuffled_order(n, seed)
        back, _, finals = fitch.stepwise_build(
            direction_rows(self.partitions), order)
        back = back.cpu().numpy()
        score = int(fitch.as_uint32(finals).astype(np.int64).sum()
                    + sum(p.const_cost for p in self.partitions))
        with deep_recursion(n):
            return self._reconstruct(back), score

    def build_device_sharded(self, seed: int, mesh) -> Tuple[UTree, int]:
        """The device build with the Fitch word axis sharded across
        ``mesh``'s ranks (JAX's ``build_device_sharded``,
        ``libpll_tpu/search/stepwise.py:257``): each rank holds its slice
        of every direction row's words, the tips' rows padded with
        all-ones words to equal slices (a pad word's union is all-ones: it
        costs nothing), and the costs of its words; per insertion the
        ranks' candidate scores meet in one integer reduction before P3's
        argmin (``ops.fitch.stepwise_build``), so the tree and the score
        are the one-device build's, bit for bit."""
        n = self.tips
        if n < 4:
            return self.build(seed)
        if mesh.device != self.device:
            raise EinvalError(f"partitions on {self.device}, mesh rank on "
                              f"{mesh.device}")
        order = shuffled_order(n, seed)
        parts = []
        for vecs, costs in direction_rows(self.partitions):
            pad = (-vecs.shape[-1]) % mesh.size
            if pad:
                vecs = torch.cat([vecs, vecs.new_zeros(
                    vecs.shape[:-1] + (pad,))], dim=-1)
                vecs[:n, :, -pad:] = -1  # 0xFFFFFFFF
            share = vecs.shape[-1] // mesh.size
            lo = mesh.rank * share
            parts.append((vecs[..., lo:lo + share].contiguous(), costs))
        back, _, finals = fitch.stepwise_build(parts, order, mesh=mesh)
        back = back.cpu().numpy()
        score = int(fitch.as_uint32(finals).astype(np.int64).sum()
                    + sum(p.const_cost for p in self.partitions))
        with deep_recursion(n):
            return self._reconstruct(back), score

    def _reconstruct(self, back: np.ndarray) -> UTree:
        """Rebuild the UNode graph from the device ``back`` involution +
        the static ring layout (tips 0..n-1; inner rows in ring triples)."""
        n, D = self.tips, len(back)
        if not np.array_equal(back[back], np.arange(D)):
            raise RuntimeError("device stepwise returned a corrupt topology"
                               " (back[] is not an involution)")
        nodes: list = []
        for t in range(n):
            nd = UNode(self.labels[t], 0.0)
            nd.data = t
            nodes.append(nd)
        for b in range(n, D, 3):
            r = [UNode(None, 0.0) for _ in range(3)]
            r[0].next, r[1].next, r[2].next = r[1], r[2], r[0]
            nodes.extend(r)
        for d in range(D):
            nodes[d].back = nodes[back[d]]
        return self._wrap(nodes[n])

    def _splice(self, u: UNode, v: UNode, tip_index: int) -> UNode:
        """Split edge (u, v) with a new inner ring; wiring mirrors
        utree_edgesplit + utree_link (stepwise.c:215-240, 281-283):
        ring[0] faces u, ring[1] faces v (the far endpoint), ring[2] faces
        the new tip. Returns ring[0]."""
        tip = UNode(self.labels[tip_index], 0.0)
        tip.data = tip_index
        r = [UNode(None, 0.0) for _ in range(3)]
        r[0].next, r[1].next, r[2].next = r[1], r[2], r[0]
        r[0].back, u.back = u, r[0]
        r[1].back, v.back = v, r[1]
        r[2].back, tip.back = tip, r[2]
        return r[0]

    def _wrap(self, center: UNode) -> UTree:
        root = center if center.next is not None else center.back
        reset_template_indices(root, self.tips)
        return wraptree(root)

    def _final_score(self, tree: UTree) -> int:
        trav = ut.traverse(tree.root)

        # score indices: tips use their ORIGINAL taxon index (their packed
        # vector row, kept in .data); inner nodes their canonical clv index
        def sidx(n: UNode) -> int:
            return n.data if n.is_tip else n.clv_index

        ops = [(n.clv_index, sidx(n.next.back), sidx(n.next.next.back))
               for n in trav if not n.is_tip]
        total = 0
        root = tree.root
        for part in self.partitions:
            part.update_vectors(ops)
            total += part.edge_score(sidx(root), sidx(root.back))
        return total


def fastparsimony_stepwise(partitions: Sequence[FastParsimony],
                           labels: Sequence[str], seed: int,
                           engine: str = "auto",
                           mesh=None) -> Tuple[UTree, int]:
    """reference pll_fastparsimony_stepwise (stepwise.c:337-546), on the
    partitions' device.

    engine="device" (and the default "auto") runs the device-resident
    build (P2 and P3 a insertion, no host read inside the loop);
    engine="host" keeps the insertion loop on the host (P1 and P2).  Both
    are seed- and tie-break-exact with the reference and with each other.
    ``mesh`` (a ``parallel.mesh.SitesMesh``) runs the device build with
    the word axis sharded across its ranks, whatever ``engine`` says, as
    JAX does.
    """
    builder = StepwiseBuilder(partitions, labels)
    if mesh is not None:
        from ..parallel.mesh import SitesMesh

        if not isinstance(mesh, SitesMesh):
            raise EinvalError(f"mesh={mesh!r}: a parallel.mesh.SitesMesh")
        return builder.build_device_sharded(seed, mesh)
    if engine in ("auto", "device"):
        return builder.build_device(seed)
    if engine == "host":
        return builder.build(seed)
    raise ValueError(f"unknown stepwise engine {engine!r}")
