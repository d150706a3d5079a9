"""K3 (segmented sweep) and K4 (segmented score) of the port against the
JAX package, on the same numpy inputs.

On the CPU each wrapper runs its plain version, which follows the same
segment tables the kernel reads (tips from the segment's slab, imports by
index: K3 from the inner rows written so far, K4 from earlier segments'
exports).  The JAX side runs ``make_segmented_sweep/score`` as its own
tests run them (``interpret=True``) on the configurations of
``tests/test_clv_pallas_seg.py``, with the inputs of its ``_build``
(the model through ``engine/params.py:model_from_numpy``), and its XLA
level sweep and forward in float64.

Tolerances: float32 CLVs and scalers by ``assert_f32_sweep_agrees``
(counters at >= 99.9% of entries, CLVs at rtol 1e-5 of each node's site
block where they agree) and logL at rtol 2e-6 (the JAX test's); float64
CLVs and logL at rel 1e-12 with scalers exact.  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas as cp
from libpll_tpu.ops import clv_pallas_seg as cps
from libpll_tpu.ops.sweep import make_level_sweep as j_sweep

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.ops import clv_seg as cseg
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                              SCALE_PER_SITE)

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_clv_pallas_seg import _build
from test_torch_ops import (assert_f32_sweep_agrees, jax_model, make_case,
                            port_pmatrix)

F64_RTOL = 1e-12
LOGL_RTOL = 2e-6


def newick_of(tree, tips):
    if tree == "random":
        return _random_tree_newick(tips, np.random.default_rng(tips))
    return _caterpillar_newick(tips)


def built_case(newick, scale_mode, seed=0):
    """``test_clv_pallas_seg._build``'s float32 inputs for both packages:
    (jax topo, jax pmatrix, jax model, port topo, port model, tip CLVs)."""
    jtopo, jmodel, jpm, clv, _ = _build(newick, sites=128, seed=seed,
                                        scale_mode=scale_mode)
    ttopo, _ = tev.topology_from_tree(tut.parse_newick_string(newick), 128,
                                      scale_mode=scale_mode)
    tmodel = model_from_numpy({k: np.asarray(v) for k, v in jmodel.items()},
                              "cpu", torch.float32)
    tips = np.asarray(clv)[:jtopo.schedule.tips]
    return jtopo, jpm, jmodel, ttopo, tmodel, tips


def schedules(jtopo, ttopo, max_rows, rate_cats=4, states=4):
    """(JAX, port) segmented schedules of the same tree, edge ensured."""
    ensure = [jtopo.parent_clv, jtopo.child_clv]
    jseg = cps.build_segmented_schedule(
        jtopo.schedule, rate_cats=rate_cats, states=states,
        max_rows=max_rows, ensure_rows=ensure)
    tseg = cseg.build_segmented_schedule(
        ttopo.schedule, max_rows=max_rows,
        ensure_rows=[ttopo.parent_clv, ttopo.child_clv])
    return jseg, tseg


def port_pm(topo, model, dtype):
    idx = torch.as_tensor(topo.matrix_indices, dtype=torch.long)
    return tev._pmatrices(model, topo, dtype, idx)


def run_sweep(tseg, scale_mode, tips, pm, rate_cats=4, states=4):
    """K3's CPU wrapper and its plain version on the same slabs; they must
    agree exactly.  Returns the wrapper's (inner, scalers)."""
    sweep = cseg.make_segmented_sweep(tseg, scale_mode, rate_cats=rate_cats,
                                      states=states)
    slabs = cseg.pack_tips_segmented(tips, tseg)
    before = cseg.SegmentedSweep.launches
    got = sweep(slabs, pm)
    plain = sweep.plain(slabs, pm)
    assert cseg.SegmentedSweep.launches == before  # no launch on the CPU
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    return got


@pytest.mark.parametrize("tree,tips,max_rows,scale_mode", [
    ("random", 32, 16, SCALE_PER_SITE),
    ("caterpillar", 48, 20, SCALE_PER_SITE),   # deep chain: nested cuts
    ("caterpillar", 48, 20, SCALE_PER_RATE)])
def test_segmented_sweep_vs_jax_f32(tree, tips, max_rows, scale_mode):
    """K3 vs the JAX segmented sweep (interpret mode), float32, inner rows
    in the segment-major order both use."""
    newick = newick_of(tree, tips)
    jtopo, jpm, _, ttopo, tmodel, tip_clv = built_case(newick, scale_mode)
    jseg, tseg = schedules(jtopo, ttopo, max_rows)
    assert len(tseg.segments) > 2  # the budget forced cuts
    assert tseg.seg_offsets == jseg.seg_offsets
    j_inner, j_scal = cps.make_segmented_sweep(
        jseg, scale_mode, impl="mxu", rate_cats=4, states=4,
        block_sites=128, interpret=True)(
        cps.pack_tips_segmented(jnp.asarray(tip_clv), jseg, "mxu"), jpm)
    got, got_scal = run_sweep(tseg, scale_mode, tip_clv,
                              port_pm(ttopo, tmodel, torch.float32))
    assert tuple(got_scal.shape) == tuple(j_scal.shape)
    if tree == "caterpillar":
        assert np.asarray(j_scal).sum() > 1000  # scaling fires
    assert_f32_sweep_agrees(got, got_scal,
                            cp.unpack_clv(j_inner, 4, 4, "mxu"), j_scal)


@pytest.mark.parametrize("scale_mode", [SCALE_PER_SITE, SCALE_PER_RATE])
def test_segmented_score_vs_jax_f32(scale_mode):
    """K4 vs the JAX segmented score (interpret mode) on the 24-taxon tree
    cut at 14 rows: logL at rtol 2e-6."""
    newick = _random_tree_newick(24, np.random.default_rng(9))
    jtopo, jpm, jm, ttopo, tm, tip_clv = built_case(newick, scale_mode,
                                                    seed=9)
    jseg, tseg = schedules(jtopo, ttopo, 14)
    assert len(tseg.segments) > 2
    want = float(cps.make_segmented_score(
        jseg, jtopo.parent_clv, jtopo.child_clv, jtopo.edge_matrix,
        scale_mode, impl="mxu", rate_cats=4, states=4, block_sites=128,
        interpret=True)(
        cps.pack_tips_segmented(jnp.asarray(tip_clv), jseg, "mxu"), jpm,
        cp.pack_weight_vec(jm["freqs_pc"], jm["rate_weights"], "mxu"),
        jm["pattern_weights"][None, :].astype(jnp.float32)))
    score = cseg.make_segmented_score(
        tseg, ttopo.parent_clv, ttopo.child_clv, ttopo.edge_matrix,
        scale_mode, rate_cats=4, states=4)
    args = (cseg.pack_tips_segmented(tip_clv, tseg),
            port_pm(ttopo, tm, torch.float32),
            cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
            tm["pattern_weights"])
    before = cseg.SegmentedScore.launches
    got = score(*args)
    assert cseg.SegmentedScore.launches == before
    assert got.dtype == torch.float64 and float(score.plain(*args)) == got
    np.testing.assert_allclose(float(got), want, rtol=LOGL_RTOL)


@pytest.mark.parametrize("scale_mode", [SCALE_NONE, SCALE_PER_SITE,
                                        SCALE_PER_RATE])
def test_segmented_f64_vs_xla(scale_mode):
    """float64, tiny tip values where scaling is on, so that it fires: K3's
    rows equal the JAX level sweep through ``seg.inner_row`` (scalers
    exact, CLVs rel 1e-12), and K4's logL the JAX make_forward (rel
    1e-12)."""
    case = make_case(_random_tree_newick(32, np.random.default_rng(32)),
                     128, seed=5, scale_mode=scale_mode,
                     tiny=scale_mode != SCALE_NONE)
    jt, tt = case["jtopo"], case["ttopo"]
    tips = jt.schedule.tips
    _, tseg = schedules(jt, tt, 12)
    assert len(tseg.segments) > 2
    jpm = jev._pmatrices(jax_model(case["model"]), jt, jnp.float64)
    want_clv, want_scal = (np.asarray(a) for a in j_sweep(
        jt.schedule, scale_mode)(jnp.asarray(case["clv"]),
                                 jnp.asarray(case["scalers"]), jpm))
    pm = port_pmatrix(case, torch.float64)
    got, got_scal = (a.numpy() for a in run_sweep(
        tseg, scale_mode, case["clv"][:tips], pm))
    if scale_mode != SCALE_NONE:
        assert got_scal.sum() > 0
    for r in range(tseg.n_inner):
        row = tseg.inner_row(r)
        np.testing.assert_array_equal(got_scal[row], want_scal[r])
        np.testing.assert_allclose(got[row], want_clv[tips + r],
                                   rtol=F64_RTOL, atol=0)
    np.testing.assert_array_equal(got_scal[-1], 0)

    want = float(jev.make_forward(jt)(jax_model(case["model"]),
                                      jnp.asarray(case["clv"]),
                                      jnp.asarray(case["scalers"]))[0])
    tm = model_from_numpy(case["model"], "cpu", torch.float64)
    got = cseg.make_segmented_score(
        tseg, tt.parent_clv, tt.child_clv, tt.edge_matrix, scale_mode,
        rate_cats=4, states=4)(
        cseg.pack_tips_segmented(case["clv"][:tips], tseg), pm,
        cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
        tm["pattern_weights"])
    np.testing.assert_allclose(float(got), want, rtol=F64_RTOL)


def test_segmented_protein_vs_jax_f32():
    """S = 20 at two rates, per-rate scaling: K3 vs the JAX segmented sweep
    (interpret mode) and K4 vs the JAX segmented score."""
    case = make_case(_random_tree_newick(12, np.random.default_rng(2)), 128,
                     seed=3, states=20, rate_cats=2,
                     scale_mode=SCALE_PER_RATE, dtype=np.float32)
    jt, tt = case["jtopo"], case["ttopo"]
    tips = jt.schedule.tips
    jseg, tseg = schedules(jt, tt, 8, rate_cats=2, states=20)
    assert len(tseg.segments) > 2
    jm = jax_model(case["model"])
    jpm = jev._pmatrices(jm, jt, jnp.float32)
    jslabs = cps.pack_tips_segmented(jnp.asarray(case["clv"][:tips]), jseg,
                                     "mxu")
    j_inner, j_scal = cps.make_segmented_sweep(
        jseg, SCALE_PER_RATE, impl="mxu", rate_cats=2, states=20,
        interpret=True)(jslabs, jpm)
    pm = port_pmatrix(case, torch.float32)
    got, got_scal = run_sweep(tseg, SCALE_PER_RATE, case["clv"][:tips], pm,
                              rate_cats=2, states=20)
    assert_f32_sweep_agrees(got, got_scal,
                            cp.unpack_clv(j_inner, 2, 20, "mxu"), j_scal)

    want = float(cps.make_segmented_score(
        jseg, jt.parent_clv, jt.child_clv, jt.edge_matrix, SCALE_PER_RATE,
        impl="mxu", rate_cats=2, states=20, interpret=True)(
        jslabs, jpm,
        cp.pack_weight_vec(jm["freqs_pc"], jm["rate_weights"], "mxu"),
        jm["pattern_weights"][None, :]))
    tm = model_from_numpy(case["model"], "cpu", torch.float32)
    got = cseg.make_segmented_score(
        tseg, tt.parent_clv, tt.child_clv, tt.edge_matrix, SCALE_PER_RATE,
        rate_cats=2, states=20)(
        cseg.pack_tips_segmented(case["clv"][:tips], tseg), pm,
        cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
        tm["pattern_weights"])
    np.testing.assert_allclose(float(got), want, rtol=LOGL_RTOL)


def test_pack_tips_segmented_matches_jax():
    """The port's slabs are the JAX "mxu" slabs, a tipless segment's one
    zero row included."""
    case = make_case(_random_tree_newick(24, np.random.default_rng(24)), 64,
                     seed=4, dtype=np.float32)
    jt, tt = case["jtopo"], case["ttopo"]
    jseg, tseg = schedules(jt, tt, 6)
    tips = case["clv"][:jt.schedule.tips]
    want = cps.pack_tips_segmented(jnp.asarray(tips), jseg, "mxu")
    got = cseg.pack_tips_segmented(torch.from_numpy(tips), tseg)
    assert any(not s.tip_globals for s in tseg.segments)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_row_budget():
    """seg_local_rows / seg_max_rows: the shared-memory row budget, and
    every segment of a cut at seg_max_rows fits it (a 1 024-taxon tree)."""
    assert cseg.seg_local_rows(4, 4, torch.float32) == 11
    assert cseg.seg_local_rows(4, 4, np.float64) == 6
    assert cseg.seg_local_rows(4, 20, torch.float32) == 2
    assert cseg.seg_local_rows(8, 20, torch.float64) == 1  # one per block
    assert cseg.seg_max_rows(4, 4, torch.float32) == 23
    topo, _ = tev.topology_from_tree(tut.parse_newick_string(
        _random_tree_newick(1024, np.random.default_rng(0))), 8)
    for dtype in (torch.float32, torch.float64):
        seg = cseg.build_segmented_schedule(
            topo.schedule, max_rows=cseg.seg_max_rows(4, 4, dtype),
            ensure_rows=[topo.parent_clv, topo.child_clv])
        assert len(seg.segments) > 40
        assert max(s.n_local for s in seg.segments) <= cseg.seg_local_rows(
            4, 4, dtype)
        for mode in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE):
            # the DNA instance's block holds the layout (no any instance)
            assert not cseg.make_segmented_sweep(seg, mode, rate_cats=4,
                                                 states=4).instance(dtype)


def test_segmented_guards():
    """EinvalError where JAX raises ValueError (an edge end the root
    segment cannot reach, a tip parent, sites that a ``block_sites`` does
    not divide); a ``block_sites`` that divides the sites runs as JAX's
    does; a segment whose live rows exceed the protein instance's block
    runs (the any-alphabet instance spills them) and matches JAX."""
    case = make_case(_caterpillar_newick(48), 32, seed=6, dtype=np.float32)
    jt, tt = case["jtopo"], case["ttopo"]
    jseg, tseg = schedules(jt, tt, 10)
    last = len(tseg.segments) - 1
    # an inner row of an earlier segment that the root segment does not
    # import, and a tip outside the root segment's slab
    hidden = next(tseg.tips + r for r, (s, l) in sorted(tseg.loc_of.items())
                  if s != last and (s, l) not in tseg.segments[last].imports)
    far_tip = next(t for t in range(tseg.tips)
                   if t not in tseg.segments[last].tip_globals)
    for child in (hidden, far_tip):
        with pytest.raises(ValueError):
            cps.make_segmented_score(jseg, jt.parent_clv, child,
                                     jt.edge_matrix, rate_cats=4, states=4)
        with pytest.raises(EinvalError):
            cseg.make_segmented_score(tseg, tt.parent_clv, child,
                                      tt.edge_matrix, rate_cats=4, states=4)
    with pytest.raises(EinvalError):  # a tip at the parent end
        cseg.make_segmented_score(tseg, far_tip, tt.child_clv,
                                  tt.edge_matrix, rate_cats=4, states=4)
    # block_sites as JAX takes it: 256 and 5 do not divide 32 sites
    tips = jt.schedule.tips
    jslabs = cps.pack_tips_segmented(jnp.asarray(case["clv"][:tips]), jseg,
                                     "mxu")
    jpm = jev._pmatrices(jax_model(case["model"]), jt, jnp.float32)
    slabs = cseg.pack_tips_segmented(case["clv"][:tips], tseg)
    pm = port_pmatrix(case, torch.float32)
    for bs in (256, 5):
        with pytest.raises(ValueError, match="divisible"):
            cps.make_segmented_sweep(jseg, rate_cats=4, states=4,
                                     block_sites=bs, impl="mxu",
                                     interpret=True)(jslabs, jpm)
        with pytest.raises(EinvalError, match="divisible"):
            cseg.make_segmented_sweep(tseg, rate_cats=4, states=4,
                                      block_sites=bs)(slabs, pm)
    want = cseg.make_segmented_sweep(tseg, rate_cats=4, states=4)(slabs, pm)
    for bs in (16, 32):
        got = cseg.make_segmented_sweep(tseg, rate_cats=4, states=4,
                                        block_sites=bs)(slabs, pm)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    tm = model_from_numpy(case["model"], "cpu", torch.float32)
    got = float(cseg.make_segmented_score(
        tseg, tt.parent_clv, tt.child_clv, tt.edge_matrix, rate_cats=4,
        states=4, block_sites=16)(
        slabs, pm, cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
        tm["pattern_weights"]))
    jm = jax_model(case["model"])
    np.testing.assert_allclose(got, float(jev.make_forward(jt)(
        jm, jnp.asarray(case["clv"]), jnp.asarray(case["scalers"]))[0]),
        rtol=LOGL_RTOL)

    # one segment of a 32-taxon tree, protein at eight rates in float64:
    # its seven live rows (287 KB) exceed the protein instance's block, so
    # the any-alphabet instance takes it; the rows and logL match JAX's
    # float64 level sweep and make_forward
    big = make_case(_random_tree_newick(32, np.random.default_rng(32)), 32,
                    seed=6, states=20, rate_cats=8)
    bt = big["ttopo"]
    whole = cseg.build_segmented_schedule(
        bt.schedule, max_rows=1000, ensure_rows=[bt.parent_clv,
                                                 bt.child_clv])
    assert len(whole.segments) == 1
    pm = port_pmatrix(big, torch.float64)
    slabs = cseg.pack_tips_segmented(big["clv"][:bt.schedule.tips], whole)
    kw = dict(rate_cats=8, states=20)
    sweep = cseg.make_segmented_sweep(whole, **kw)
    assert sweep.smem(torch.float64) > cseg.SMEM_LIMIT
    assert sweep.instance(torch.float64) and not sweep.instance(
        torch.float32)
    inner, scal = sweep(slabs, pm)
    jb = big["jtopo"]
    want_clv, want_scal = (np.asarray(a) for a in j_sweep(
        jb.schedule, jb.scale_mode)(
        jnp.asarray(big["clv"]), jnp.asarray(big["scalers"]),
        jev._pmatrices(jax_model(big["model"]), jb, jnp.float64)))
    btips = jb.schedule.tips
    for r in range(whole.n_inner):
        np.testing.assert_array_equal(scal[whole.inner_row(r)].numpy(),
                                      want_scal[r])
        np.testing.assert_allclose(inner[whole.inner_row(r)].numpy(),
                                   want_clv[btips + r], rtol=F64_RTOL,
                                   atol=0)
    tm = model_from_numpy(big["model"], "cpu", torch.float64)
    got = float(cseg.make_segmented_score(
        whole, bt.parent_clv, bt.child_clv, bt.edge_matrix, **kw)(
        slabs, pm, cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
        tm["pattern_weights"]))
    np.testing.assert_allclose(got, float(jev.make_forward(jb)(
        jax_model(big["model"]), jnp.asarray(big["clv"]),
        jnp.asarray(big["scalers"]))[0]), rtol=F64_RTOL)
    with pytest.raises(EinvalError):  # a device neither CPU nor CUDA
        cseg.make_segmented_sweep(tseg, rate_cats=4, states=4)(
            [s.to("meta") for s in cseg.pack_tips_segmented(
                case["clv"][:tt.schedule.tips], tseg)],
            port_pmatrix(case, torch.float32).to("meta"))
