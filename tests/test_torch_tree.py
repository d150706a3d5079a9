"""The port's tree and I/O host layer against libpll_tpu's, on the same
inputs made from a seed: utree/rtree parsing, export, traversals, cloning
and operation lists; PHYLIP in both layouts; SPR/NNI with rollback and
the partial op lists of ``tree.incremental``; bipartitions and RF
distances; SVG text; the run log's lines.  These are host modules copied
from the JAX package, so every result must be equal, not close."""

import io
import json

import numpy as np
import pytest

from libpll_tpu import errors as jerr
from libpll_tpu.io import phylip as jphy
from libpll_tpu.tree import compare as jcmp
from libpll_tpu.tree import incremental as jinc
from libpll_tpu.tree import moves as jmv
from libpll_tpu.tree import rtree as jrt
from libpll_tpu.tree import svg as jsvg
from libpll_tpu.tree import utree as jut
from libpll_tpu.utils import logging as jlog

from libpll_tpu_torch import errors as terr
from libpll_tpu_torch.io import phylip as tphy
from libpll_tpu_torch.tree import compare as tcmp
from libpll_tpu_torch.tree import incremental as tinc
from libpll_tpu_torch.tree import moves as tmv
from libpll_tpu_torch.tree import rtree as trt
from libpll_tpu_torch.tree import svg as tsvg
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.utils import logging as tlog

from test_torch_partition import random_newick


def rooted_newick(tips, rng):
    items = [f"r{i}:{rng.uniform(0.05, 0.6):.4f}" for i in range(tips)]
    while len(items) > 2:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b, a = items.pop(j), items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.6):.4f}")
    return f"({items[0]},{items[1]});"


def node_fields(n):
    return (n.label, n.length, n.node_index, n.clv_index, n.scaler_index,
            n.pmatrix_index)


def ops_tuples(ops):
    return [o.as_tuple() for o in ops]


@pytest.mark.parametrize("tips", [3, 8, 25])
def test_utree(tips, tmp_path):
    rng = np.random.default_rng(tips)
    text = random_newick(tips, rng)
    path = tmp_path / "t.nwk"
    path.write_text(text)
    j, t = jut.parse_newick(str(path)), tut.parse_newick(str(path))
    assert [node_fields(n) for n in t.nodes] == [node_fields(n)
                                                 for n in j.nodes]
    for order in (jut.TRAVERSE_POSTORDER, jut.TRAVERSE_PREORDER):
        jt, tt = jut.traverse(j.root, order), tut.traverse(t.root, order)
        assert [node_fields(n) for n in tt] == [node_fields(n) for n in jt]
    jo, tr = jut.create_operations(jut.traverse(j.root)), \
        tut.create_operations(tut.traverse(t.root))
    assert ops_tuples(tr[0]) == ops_tuples(jo[0]) and tr[1:] == jo[1:]
    assert tut.export_newick(t.root, 5) == jut.export_newick(j.root, 5)
    c = tut.clone(t)
    assert [node_fields(n) for n in c.nodes] == [node_fields(n)
                                                 for n in t.nodes]
    assert tut.check_integrity(c) and jut.check_integrity(j)
    assert tut.show_ascii(t.root) == jut.show_ascii(j.root)
    assert tut.create_pars_buildops(tut.traverse(t.root)) == \
        jut.create_pars_buildops(jut.traverse(j.root))
    assert [node_fields(n) for n in tut.query_innernodes(t)] == \
        [node_fields(n) for n in jut.query_innernodes(j)]
    seen_t, seen_j = [], []
    assert tut.every(t, lambda n: seen_t.append(n.clv_index) or True)
    assert jut.every(j, lambda n: seen_j.append(n.clv_index) or True)
    assert seen_t == seen_j
    assert repr(t.root).startswith("<UNode inner")


@pytest.mark.parametrize("tips", [3, 9])
def test_rtree(tips, tmp_path):
    rng = np.random.default_rng(tips)
    text = rooted_newick(tips, rng)
    path = tmp_path / "r.nwk"
    path.write_text(text)
    j, t = jrt.parse_newick(str(path)), trt.parse_newick(str(path))
    assert [node_fields(n) for n in t.nodes] == [node_fields(n)
                                                 for n in j.nodes]
    for order in (jut.TRAVERSE_POSTORDER, jut.TRAVERSE_PREORDER):
        jt, tt = jrt.traverse(j.root, order), trt.traverse(t.root, order)
        assert [node_fields(n) for n in tt] == [node_fields(n) for n in jt]
    jo = jrt.create_operations(jrt.traverse(j.root))
    to = trt.create_operations(trt.traverse(t.root))
    assert ops_tuples(to[0]) == ops_tuples(jo[0]) and to[1:] == jo[1:]
    assert trt.export_newick(t.root) == jrt.export_newick(j.root)
    assert trt.show_ascii(t.root) == jrt.show_ascii(j.root)
    trav_t, trav_j = trt.traverse(t.root), jrt.traverse(j.root)
    assert trt.create_pars_recops(trav_t) == jrt.create_pars_recops(trav_j)
    assert trt.create_pars_buildops(trav_t) == \
        jrt.create_pars_buildops(trav_j)
    if tips > 3:
        ju, tu = jrt.unroot(j), trt.unroot(t)
        assert [node_fields(n) for n in tu.nodes] == [node_fields(n)
                                                      for n in ju.nodes]
        assert tut.check_integrity(tu)


def test_newick_errors():
    for text in ("((A,B),C", "(A,B,C,D);", "((A,B),(C,D)"):
        names = []
        for mod in (jut, tut):
            with pytest.raises(Exception) as info:
                mod.parse_newick_string(text)
            names.append(type(info.value).__name__)
        assert names[0] == names[1], (text, names)
    with pytest.raises(terr.TreeError):
        trt.unroot(trt.parse_newick_string("(a:1,b:1);"))


def _phylip_text(labels, seqs, interleaved, width=7):
    head = f"{len(labels)} {len(seqs[0])}\n"
    if not interleaved:
        return head + "".join(f"{lab} {s[:width]}\n{s[width:]}\n"
                              for lab, s in zip(labels, seqs))
    blocks = []
    for k in range(0, len(seqs[0]), width):
        rows = [(f"{lab} " if k == 0 else "") + s[k:k + width]
                for lab, s in zip(labels, seqs)]
        blocks.append("\n".join(rows) + "\n")
    return head + "\n".join(blocks)


@pytest.mark.parametrize("interleaved", [False, True])
def test_phylip(interleaved, tmp_path):
    rng = np.random.default_rng(4)
    labels = [f"taxon{i}" for i in range(5)]
    seqs = ["".join(rng.choice(list("ACGT-N"), 23)) for _ in labels]
    path = tmp_path / "a.phy"
    path.write_text(_phylip_text(labels, seqs, interleaved))
    parse_t = (tphy.parse_phylip_interleaved if interleaved
               else tphy.parse_phylip_sequential)
    parse_j = (jphy.parse_phylip_interleaved if interleaved
               else jphy.parse_phylip_sequential)
    got, want = parse_t(str(path)), parse_j(str(path))
    assert (got.count, got.length, got.labels, got.sequences) == \
        (want.count, want.length, want.labels, want.sequences)
    assert got.sequences == seqs and got.labels == labels
    path.write_text("5 24\n" + _phylip_text(labels, seqs, interleaved)
                    .split("\n", 1)[1])
    for parse, err in ((parse_t, terr.PhylipError),
                       (parse_j, jerr.PhylipError)):
        with pytest.raises(err):
            parse(str(path))


def _legal_spr(tree, rng):
    nodes = tree.nodes
    while True:
        i, j = rng.integers(0, len(nodes), 2)
        p, r = nodes[i], nodes[j]
        if p.next is None:
            continue
        if r in (p, p.back, p.next, p.next.back, p.next.next,
                 p.next.next.back):
            continue
        if not tmv._subtree_contains(p.back, r):
            return int(i), int(j)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moves_and_partial_operations(seed):
    """The same SPR and NNI moves on both packages' trees give the same
    changed branches, the same partial op lists and the same trees; the
    rollback restores the newick; PeekIndex agrees with peek_partial."""
    rng = np.random.default_rng(seed)
    text = random_newick(14, rng)
    j, t = jut.parse_newick_string(text), tut.parse_newick_string(text)
    start = tut.export_newick(t.root)
    for inc, tree, mod in ((jinc, j, jut), (tinc, t, tut)):
        inc.mark_valid(mod.traverse(tree.root))
    for _ in range(4):
        i, k = _legal_spr(t, rng)
        idx_t = tinc.PeekIndex(t.root)
        out = []
        for mv, inc, tree in ((jmv, jinc, j), (tmv, tinc, t)):
            rb = mv.Rollback(mv.MOVE_SPR)
            with mv.record_flips() as flips:
                changed = mv.spr_safe(tree.nodes[i], tree.nodes[k], rb)
            peek = inc.peek_partial(tree.root)
            if inc is tinc:
                assert [n.clv_index for n in idx_t.peek(flips)] == \
                    [n.clv_index for n in peek]
            ops = inc.create_partial_operations(inc.partial_traverse(
                tree.root))
            out.append((changed, ops_tuples(ops), len(peek)))
        assert out[0] == out[1]
        assert 0 < len(out[1][1]) < t.inner_count
        assert tut.export_newick(t.root) == jut.export_newick(j.root)
        assert tut.check_integrity(t)
    # NNI across an inner edge, then roll back
    inner = next(n for n in t.nodes if n.next is not None
                 and n.back.next is not None)
    pos = t.nodes.index(inner)
    before = tut.export_newick(t.root)
    for mv, tree in ((jmv, j), (tmv, t)):
        rb = mv.Rollback(mv.MOVE_NNI)
        mv.nni(tree.nodes[pos], mv.NNI_LEFT, rb)
    assert tut.export_newick(t.root) == jut.export_newick(j.root) != before
    assert tmv.rollback_move(rb) == []
    assert tut.export_newick(t.root) == before
    # an SPR and its rollback restore the tree
    i, k = _legal_spr(t, rng)
    rb = tmv.Rollback(tmv.MOVE_SPR)
    mid = tut.export_newick(t.root)
    tmv.spr_safe(t.nodes[i], t.nodes[k], rb)
    assert len(tmv.rollback_move(rb)) == 3
    assert tut.export_newick(t.root) == mid != start
    with pytest.raises(terr.SprError):
        tmv.spr_safe(t.nodes[i], t.nodes[i], None)


@pytest.mark.parametrize("seed", [0, 1])
def test_rf_distance(seed):
    rng = np.random.default_rng(seed)
    a_txt = random_newick(12, rng)
    b_txt = random_newick(12, rng)
    for mod, cmp in ((jut, jcmp), (tut, tcmp)):
        a, b = mod.parse_newick_string(a_txt), mod.parse_newick_string(b_txt)
        if mod is jut:
            want = (cmp.rf_distance(a, b), cmp.bipartitions(a))
        else:
            assert (cmp.rf_distance(a, b), cmp.bipartitions(a)) == want
            assert cmp.rf_distance(a, a) == 0
    with pytest.raises(ValueError):
        tcmp.rf_distance(tut.parse_newick_string("(a,b,c);"),
                         tut.parse_newick_string("(a,b,d);"))


def test_svg_text(tmp_path):
    text = random_newick(9, np.random.default_rng(9))
    j, t = jut.parse_newick_string(text), tut.parse_newick_string(text)
    for attr in (None, tsvg.SvgAttrib(legend_show=False, node_radius=2.0)):
        jattr = None if attr is None else jsvg.SvgAttrib(
            legend_show=False, node_radius=2.0)
        assert tsvg.export_svg(t, attr=attr) == jsvg.export_svg(j,
                                                                attr=jattr)
    tsvg.export_svg_file(t, str(tmp_path / "t.svg"))
    assert (tmp_path / "t.svg").read_text() == jsvg.export_svg(j)


def test_run_log_lines(tmp_path, monkeypatch):
    """The same JSON lines, with the clock pinned."""
    lines = []
    for mod in (jlog, tlog):
        monkeypatch.setattr(mod.time, "time", lambda: 100.0)
        path = tmp_path / f"{mod.__name__}.jsonl"
        with mod.RunLog(str(path)) as log:
            log.logl(-123.5, round=1)
            log.move("spr", True, -120.25, radius=3)
            log.event("done", n=np.float32(2.5))
        lines.append(path.read_text().splitlines())
    assert lines[0] == lines[1]
    assert [json.loads(x)["kind"] for x in lines[1]] == ["logl", "move",
                                                         "done"]
    buf = io.StringIO()
    monkeypatch.setattr(tlog.sys, "stderr", buf)
    tlog.RunLog(echo=True).event("echo")
    assert json.loads(buf.getvalue())["kind"] == "echo"
