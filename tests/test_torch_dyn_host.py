"""The dyn tier's host side: the port's segment cut, padded schedules,
export/import tables, evaluation-edge locations and tip packers equal the
JAX package's, entry for entry (``np.array_equal``), on the configurations
of ``tests/test_clv_pallas_dyn.py`` and ``tests/test_dyn_tableswap.py``;
and the builders of the 10 240-taxon run."""

import numpy as np
import pytest
import torch

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas_dyn as jcd
from libpll_tpu.ops import clv_pallas_seg as jcs
from libpll_tpu.tree import utree as jut

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import clv_dyn as cd
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.ops import clv_seg as cs
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.utils.flagship import (build_flagship,
                                             build_flagship_topology,
                                             draw_tipchars_cuda)

from test_clv_pallas import _caterpillar_newick, _random_tree_newick

# (label, newick, rate_cats, states, max_rows, chunk, floors)
FLOORS = dict(min_r_tip=12, min_r_imp=5, min_r_loc=10, min_segments=6,
              min_r_exp=4)
CONFIGS = [
    ("random24", _random_tree_newick(24, np.random.default_rng(24)), 4, 4,
     24, 8, {}),
    ("caterpillar16", _caterpillar_newick(16), 4, 4, 12, 8, {}),
    ("random160", _random_tree_newick(160, np.random.default_rng(1024)), 4,
     4, 40, 16, {}),
    ("protein12", _random_tree_newick(12, np.random.default_rng(2)), 2, 20,
     12, 4, {}),
    ("floors16", _random_tree_newick(16, np.random.default_rng(7)), 4, 4, 8,
     8, FLOORS),
    ("single24", _random_tree_newick(24, np.random.default_rng(24)), 4, 4,
     1000, 8, {}),
]
IDS = [c[0] for c in CONFIGS]


def _topos(newick):
    jtopo, _ = jev.topology_from_tree(jut.parse_newick_string(newick), 128)
    ttopo, _ = tev.topology_from_tree(tut.parse_newick_string(newick), 128)
    return jtopo, ttopo


def _both(config):
    _, newick, c, s, max_rows, chunk, floors = config
    jtopo, ttopo = _topos(newick)
    ensure = [jtopo.parent_clv, jtopo.child_clv]
    want = jcd.build_dyn_schedule(jtopo.schedule, rate_cats=c, states=s,
                                  max_rows=max_rows, chunk=chunk,
                                  ensure_rows=ensure, **floors)
    got = cd.build_dyn_schedule(ttopo.schedule, rate_cats=c, states=s,
                                max_rows=max_rows, chunk=chunk,
                                ensure_rows=ensure, **floors)
    return jtopo, want, got


def _assert_tensors_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, torch.Tensor)
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_segmented_schedule_equals_jax(config):
    _, newick, c, s, max_rows, _, _ = config
    jtopo, ttopo = _topos(newick)
    ensure = [jtopo.parent_clv, jtopo.child_clv]
    want = jcs.build_segmented_schedule(jtopo.schedule, rate_cats=c,
                                        states=s, max_rows=max_rows,
                                        ensure_rows=ensure)
    got = cs.build_segmented_schedule(ttopo.schedule, max_rows=max_rows,
                                      ensure_rows=ensure)
    assert len(got.segments) == len(want.segments)
    for a, b in zip(got.segments, want.segments):
        assert a.tip_globals == b.tip_globals
        assert a.imports == b.imports
        assert a.ops == b.ops
        assert a.export_locals == b.export_locals
    assert np.array_equal(got.tip_perm, want.tip_perm)
    assert (got.tips, got.n_inner, got.tip_slab_sizes, got.loc_of,
            got.seg_offsets) == (want.tips, want.n_inner,
                                 want.tip_slab_sizes, want.loc_of,
                                 want.seg_offsets)
    if config[0] == "random160":
        assert len(got.segments) >= 8


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_dyn_schedule_and_tables_equal_jax(config):
    jtopo, want, got = _both(config)
    for a, b in zip(got.segments, want.segments):
        assert np.array_equal(a.table, b.table)
        assert np.array_equal(a.m_ops, b.m_ops)
        assert np.array_equal(a.tip_globals, b.tip_globals)
        assert (a.imports, a.n_local) == (b.imports, b.n_local)
    fields = ("tips", "n_inner", "r_tip", "r_imp", "r_loc", "n_chunks",
              "chunk", "seg_offsets", "loc_of", "min_r_exp")
    assert ([getattr(got, f) for f in fields]
            == [getattr(want, f) for f in fields])
    assert len(got.segments) == len(want.segments)
    for r in range(got.n_inner):
        assert got.inner_row(r) == want.inner_row(r)

    for a, b in zip(cd.dyn_runtime_args(got), jcd.dyn_runtime_args(want)):
        _assert_tensors_equal(a, b)
    for a, b in zip(cd.dyn_score_args(got), jcd.dyn_score_args(want)):
        _assert_tensors_equal(a, b)
    got_swap, want_swap = cd.dyn_swap_args(got), jcd.dyn_swap_args(want)
    for a, b in zip(got_swap[:3], want_swap[:3]):
        _assert_tensors_equal(a, b)
    assert np.array_equal(got_swap[3].numpy(), np.asarray(want_swap[3]))
    # the port's swap data also carries the slot plan of its pool
    assert np.array_equal(got_swap[4].numpy(), cd.dyn_slot_plan(got).slots)
    gt, gp, gr = cd._export_tables(got)
    wt, wp, wr = jcd._export_tables(want)
    assert (gp, gr) == (wp, wr)
    for a, b in zip(gt, wt):
        assert np.array_equal(a, b)

    p, c = jtopo.parent_clv, jtopo.child_clv
    assert np.array_equal(cd.dyn_eval_locs(got, p, c),
                          jcd.dyn_eval_locs(want, p, c))
    if len(got.segments) == 1:
        gi, wi = cd.dyn_identity_tips(got), jcd.dyn_identity_tips(want)
        assert np.array_equal(gi.segments[0].table, wi.segments[0].table)
        assert np.array_equal(gi.segments[0].tip_globals,
                              wi.segments[0].tip_globals)
        assert np.array_equal(cd.dyn_eval_locs(gi, p, c),
                              jcd.dyn_eval_locs(wi, p, c))
    else:
        with pytest.raises(EinvalError):
            cd.dyn_identity_tips(got)
        with pytest.raises(ValueError):
            jcd.dyn_identity_tips(want)


@pytest.mark.parametrize("config", CONFIGS, ids=IDS)
def test_tip_packers_equal_jax(config):
    _, newick, c, s, *_ = config
    jtopo, want, got = _both(config)
    rng = np.random.default_rng(len(newick))
    tips = jtopo.schedule.tips
    masks = (np.uint32(1) << rng.integers(0, s, (tips, 40)).astype(np.uint32))
    masks[rng.random((tips, 40)) < 0.1] = (1 << s) - 1
    _assert_tensors_equal(cd.pack_tipmasks_dyn(masks, got),
                          jcd.pack_tipmasks_dyn(masks, want))
    clv = np.stack([((masks >> k) & 1).astype(np.float32)
                    for k in range(s)], axis=1)[:, None]
    clv = np.ascontiguousarray(np.broadcast_to(clv, (tips, c, s, 40)))
    _assert_tensors_equal(cd.pack_tips_dyn(clv, got),
                          jcd.pack_tips_dyn(clv, want, "mxu"))
    tg = cd.dyn_tip_globals(got)
    for si, seg in enumerate(got.segments):
        n = len(seg.tip_globals)
        assert np.array_equal(tg[si, :n].numpy(), seg.tip_globals)
    if s == 4:
        _assert_tensors_equal(cd.pack_tipchars_dyn(masks, got),
                              jcd.pack_tipchars_dyn(masks, want))
    else:
        with pytest.raises(EinvalError):
            cd.pack_tipchars_dyn(masks, got)


def test_guards_and_default_row_budget():
    jtopo, ttopo = _topos(_random_tree_newick(10, np.random.default_rng(3)))
    ensure = [ttopo.parent_clv, ttopo.child_clv]
    with pytest.raises(EinvalError):  # neither max_rows nor sites
        cd.build_dyn_schedule(ttopo.schedule, rate_cats=4, states=4,
                              ensure_rows=ensure)
    with pytest.raises(EinvalError):
        cd.pack_tipmasks_dyn(np.full((2, 3), 0x80000000, np.uint32), None)
    dyn = cd.build_dyn_schedule(ttopo.schedule, rate_cats=4, states=4,
                                sites=128, ensure_rows=ensure)
    assert len(dyn.segments) == 1 and dyn.chunk == 1
    # 10 240 taxa x 2**20 sites, 4 rates of 4 states in float32
    assert cd.dyn_max_rows(4, 4, 1 << 20) == 204
    assert cd.dyn_max_rows(4, 20, 1 << 30) == 16
    for kwargs in (dict(impl="tpu"), dict(mxu_precision="default"),
                   dict(tip_encoding="bytes")):
        with pytest.raises(EinvalError):
            cd.make_dyn_score(dyn, jtopo.parent_clv, jtopo.child_clv,
                              jtopo.edge_matrix, rate_cats=4, states=4,
                              **kwargs)
    # JAX's "high" is accepted, and computed at "highest"
    cd.make_dyn_score(dyn, jtopo.parent_clv, jtopo.child_clv,
                      jtopo.edge_matrix, rate_cats=4, states=4,
                      mxu_precision="high")


def test_flagship_topology_and_card_tips():
    """The giant's builders: the topology and model without host tips
    equal build_flagship's (the JAX builder's rng order), and the tips
    drawn by the card-side drawer (here on the CPU) are single-state
    nibbles laid out as clv_fused.pack_tipchars lays them out."""
    topo, model = build_flagship_topology(12, 64, seed=2)
    want_topo, want_model, _, _ = build_flagship(12, 64, seed=2)
    assert topo.schedule.clv_map == want_topo.schedule.clv_map
    assert (topo.parent_clv, topo.child_clv, topo.edge_matrix) == (
        want_topo.parent_clv, want_topo.child_clv, want_topo.edge_matrix)
    for k in want_model:
        assert np.array_equal(model[k], want_model[k]), k
    for tips in (8, 21):
        packed = draw_tipchars_cuda(tips, 300, 3, "cpu", tips_per_chunk=8)
        rows = torch.arange(tips)
        codes = ((packed[rows // 8] >> (4 * (rows % 8))[:, None])
                 & 0xF).numpy().astype(np.uint32)
        assert set(np.unique(codes)) == {1, 2, 4, 8}
        assert torch.equal(cf.pack_tipchars(codes), packed)
        assert torch.equal(packed, draw_tipchars_cuda(tips, 300, 3, "cpu"))
