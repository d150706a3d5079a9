"""The port's host layer (libpll_tpu_torch: tree, schedule, models, maps,
errors, flagship builder) equals the JAX package's on the same inputs.
These modules are copies, so everything here is held to exact equality."""

import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from __graft_entry__ import _build_flagship  # noqa: E402
from libpll_tpu import errors as jerr  # noqa: E402
from libpll_tpu.engine.evaluate import topology_from_tree as j_topo  # noqa: E402
from libpll_tpu.io import maps as jmaps  # noqa: E402
from libpll_tpu.models.gamma import compute_gamma_cats as j_gamma  # noqa: E402
from libpll_tpu.models.gtr import eigen_decompose as j_eigen  # noqa: E402
from libpll_tpu.ops.sweep import build_level_schedule as j_schedule  # noqa: E402
from libpll_tpu.tree import utree as jut  # noqa: E402

from libpll_tpu_torch import errors as terr  # noqa: E402
from libpll_tpu_torch.engine.evaluate import topology_from_tree as t_topo  # noqa: E402
from libpll_tpu_torch.io import maps as tmaps  # noqa: E402
from libpll_tpu_torch.models.gamma import compute_gamma_cats as t_gamma  # noqa: E402
from libpll_tpu_torch.models.gtr import eigen_decompose as t_eigen  # noqa: E402
from libpll_tpu_torch.ops.sweep import build_level_schedule as t_schedule  # noqa: E402
from libpll_tpu_torch.tree import utree as tut  # noqa: E402
from libpll_tpu_torch.utils.flagship import build_flagship  # noqa: E402

from test_clv_pallas import _caterpillar_newick, _random_tree_newick  # noqa: E402

NEWICKS = [
    "((A:0.1,B:0.2):0.3,(C:0.4,D:0.5):0.6,E:0.7);",
    _random_tree_newick(12, np.random.default_rng(12)),
    _caterpillar_newick(16),
]


def _node_fields(tree):
    return [(n.label, n.length, n.node_index, n.clv_index, n.scaler_index,
             n.pmatrix_index, n.is_tip) for n in tree.nodes]


def _ops_tuples(ops):
    return [op.as_tuple() for op in ops]


@pytest.mark.parametrize("newick", NEWICKS)
def test_tree_and_operations_equal(newick):
    jt, tt = jut.parse_newick_string(newick), tut.parse_newick_string(newick)
    assert tt.tip_count == jt.tip_count
    assert _node_fields(tt) == _node_fields(jt)
    jtrav, ttrav = jut.traverse(jt.root), tut.traverse(tt.root)
    assert ([n.clv_index for n in ttrav] == [n.clv_index for n in jtrav])
    jops, jbr, jmi = jut.create_operations(jtrav)
    tops, tbr, tmi = tut.create_operations(ttrav)
    assert _ops_tuples(tops) == _ops_tuples(jops)
    assert tbr == jbr and tmi == jmi


@pytest.mark.parametrize("newick", NEWICKS)
def test_level_schedule_and_topology_equal(newick):
    jt, tt = jut.parse_newick_string(newick), tut.parse_newick_string(newick)
    jops, _, _ = jut.create_operations(jut.traverse(jt.root))
    tops, _, _ = tut.create_operations(tut.traverse(tt.root))
    js, ts = j_schedule(jops, jt.tip_count), t_schedule(tops, tt.tip_count)
    assert (ts.tips, ts.n_inner) == (js.tips, js.n_inner)
    assert ts.clv_map == js.clv_map and ts.scaler_map == js.scaler_map
    assert len(ts.levels) == len(js.levels)
    for tl, jl in zip(ts.levels, js.levels):
        assert tl.offset == jl.offset
        for f in ("child1", "matrix1", "child2", "matrix2", "scaler1",
                  "scaler2", "has_scaler"):
            np.testing.assert_array_equal(getattr(tl, f), getattr(jl, f))

    jtopo, jbr = j_topo(jt, 100, asc_mode=2)
    ttopo, tbr = t_topo(tt, 100, asc_mode=2)
    np.testing.assert_array_equal(tbr, jbr)
    np.testing.assert_array_equal(ttopo.matrix_indices, jtopo.matrix_indices)
    for f in ("n_pmatrices", "parent_clv", "child_clv", "edge_matrix",
              "sites", "scale_mode", "asc_mode"):
        assert getattr(ttopo, f) == getattr(jtopo, f), f
    assert (ttopo.scaler_row(ttopo.child_clv)
            == jtopo.scaler_row(jtopo.child_clv))


def test_newick_errors_typed():
    for bad in ("(A,B;", "(A:x,B,C);", "(A,B,C)"):
        with pytest.raises(terr.NewickError):
            tut.parse_newick_string(bad)
    tree = tut.parse_newick_string(NEWICKS[0])
    with pytest.raises(terr.TreeError):
        tut.traverse(tree.nodes[0])


def test_models_equal():
    rng = np.random.default_rng(4)
    for states in (4, 20):
        params = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
        freqs = rng.uniform(0.1, 1.0, states)
        freqs /= freqs.sum()
        for a, b in zip(t_eigen(params, freqs), j_eigen(params, freqs)):
            np.testing.assert_array_equal(a, b)
    for alpha in (0.02, 0.3, 1.0, 7.5):
        for cats in (1, 4, 8):
            for mode in (0, 1):
                np.testing.assert_array_equal(t_gamma(alpha, cats, mode),
                                              j_gamma(alpha, cats, mode))
    with pytest.raises(terr.ParamError):
        t_gamma(0.01, 4)


def test_maps_and_errors_equal():
    for name in ("pll_map_bin", "pll_map_nt", "pll_map_aa", "pll_map_fasta",
                 "pll_map_phylip"):
        np.testing.assert_array_equal(getattr(tmaps, name),
                                      getattr(jmaps, name))
    np.testing.assert_array_equal(
        tmaps.encode_sequence("ACGTRYN-", tmaps.pll_map_nt),
        jmaps.encode_sequence("ACGTRYN-", jmaps.pll_map_nt))
    with pytest.raises(terr.TipDataError):
        tmaps.encode_sequence("ACJ", tmaps.pll_map_nt)
    for name in dir(jerr):
        cls = getattr(jerr, name)
        if isinstance(cls, type) and issubclass(cls, Exception):
            port = getattr(terr, name)
            assert ([c.__name__ for c in port.__mro__]
                    == [c.__name__ for c in cls.__mro__]), name


@pytest.mark.parametrize("tip_masks,simulate", [(True, False),
                                                (False, False),
                                                (False, True)])
def test_flagship_builder_equal(tip_masks, simulate):
    """Same seed -> same tree, model and tips as __graft_entry__."""
    j = _build_flagship(12, 256, seed=0, tip_masks=tip_masks,
                        simulate=simulate)
    t = build_flagship(12, 256, seed=0, tip_masks=tip_masks,
                       simulate=simulate)
    jtopo, ttopo = j[0], t[0]
    np.testing.assert_array_equal(ttopo.matrix_indices, jtopo.matrix_indices)
    assert ttopo.schedule.clv_map == jtopo.schedule.clv_map
    assert sorted(t[1]) == sorted(j[1])
    for k, v in j[1].items():
        assert t[1][k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(t[1][k], np.asarray(v))
    assert isinstance(t[2], np.ndarray)
    np.testing.assert_array_equal(t[2], np.asarray(j[2]))
    if tip_masks:
        assert t[3] is None and j[3] is None
    else:
        np.testing.assert_array_equal(t[3], np.asarray(j[3]))
    assert t[2].dtype == (np.uint32 if tip_masks else jnp.float32)
