"""The walk of the segmented kernels K3/K4 (``csrc/clv_seg.cu``): one
launch runs every segment over a block's sites, each op by a descriptor
the host resolved once per schedule, each segment's live local rows in a
shared-memory pool planned by ``clv_seg.segment_slots``.  Checked on the
CPU, where no kernel runs:

  * The plan never hands a live row's pool slot to another row, and the
    rows the edge reads are still in the pool at the end (K4).
  * ``plain_walk`` (the kernel's walk with PyTorch ops) equals the plain
    versions bit for bit (the same PyTorch ops in the same order; only
    where rows live differs), for every scale mode, S in {4, 20}, float32
    and float64; and the JAX package's segmented kernels (interpret mode)
    or its XLA float64 paths within the tolerances of
    ``tests/test_torch_seg.py``.
  * The README cut's layout (1 024 taxa, DNA, four rates, float32) fits
    eight blocks per SM, and the slab list is checked once per list of
    data pointers.

The CUDA kernels are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
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
from libpll_tpu_torch.utils.flagship import build_flagship_topology

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_torch_ops import (assert_f32_sweep_agrees, jax_model, make_case,
                            port_pmatrix)
from test_torch_seg import (F64_RTOL, LOGL_RTOL, built_case, port_pm,
                            schedules)

INDEX = (1 << cseg.INDEX_BITS) - 1

# label: (newick, max_rows (None: one segment), states, rate categories)
TREES = {
    "random32/16": (_random_tree_newick(32, np.random.default_rng(32)), 16,
                    4, 4),
    "caterpillar48/12": (_caterpillar_newick(48), 12, 4, 4),
    "random24/one": (_random_tree_newick(24, np.random.default_rng(24)),
                     None, 4, 8),
    "protein12/8": (_random_tree_newick(12, np.random.default_rng(12)), 8,
                    20, 2),
}


def _kernels(label, scale_mode=SCALE_PER_SITE, sites=64, **case_kw):
    """(case, schedule, K3, K4) of a named tree."""
    newick, max_rows, states, rate_cats = TREES[label]
    case = make_case(newick, sites, states=states, rate_cats=rate_cats,
                     scale_mode=scale_mode, **case_kw)
    tt = case["ttopo"]
    seg = cseg.build_segmented_schedule(
        tt.schedule, max_rows=max_rows or 1 << 20,
        ensure_rows=[tt.parent_clv, tt.child_clv])
    assert (max_rows is None) == (len(seg.segments) == 1)
    kw = dict(rate_cats=rate_cats, states=states)
    return (case, seg, cseg.make_segmented_sweep(seg, scale_mode, **kw),
            cseg.make_segmented_score(seg, tt.parent_clv, tt.child_clv,
                                      tt.edge_matrix, scale_mode, **kw))


@pytest.mark.parametrize("kind", ["K3", "K4"])
@pytest.mark.parametrize("label", list(TREES))
def test_walk_never_overwrites_a_live_row(label, kind):
    """Walk every segment's descriptors as the kernel does: each pool read
    finds the row the segment's table names, each op's row goes out where
    K3 (every row, segment-major) or K4 (exports only) puts it, and K4's
    edge rows are in the pool at the end."""
    _, seg, k3, k4 = _kernels(label)
    kernel = k3 if kind == "K3" else k4
    ops = kernel._host["ops"].numpy()
    segs = kernel._host["segs"].numpy()
    assert len(ops) == seg.n_inner and segs[:, 1].sum() == seg.n_inner
    outs = []
    for si, (g, (table, _)) in enumerate(zip(kernel.rows, kernel.tables)):
        op0, n_ops, n_tip, _ = segs[si]
        assert (op0, n_ops, n_tip) == (seg.seg_offsets[si], g.r_loc, g.r_tip)
        held = {}
        for l, o in enumerate(ops[op0:op0 + n_ops]):
            for d, ref, base in ((o[2], table[l, 1], g.loc0),
                                 (o[3], table[l, 2], g.loc0),
                                 (o[4], table[l, 3], g.r_imp),
                                 (o[5], table[l, 4], g.r_imp)):
                if d >= 0 and d >> cseg.INDEX_BITS == cseg.K_POOL:
                    assert held.get(d & INDEX) == ref - base, (si, l)
            assert o[1] >> cseg.INDEX_BITS == cseg.K_POOL
            assert (o[1] & INDEX) < kernel.pool
            held[o[1] & INDEX] = l
            if o[9] >= 0:
                outs.append(int(o[9]))
            if kind == "K3":
                assert o[9] == seg.seg_offsets[si] + l
            else:
                assert (o[9] >= 0) == (l in k4.exports[si])
    if kind == "K3":
        assert outs == list(range(seg.n_inner))
    else:
        assert sorted(outs) == list(range(k4.n_exports))
        for d, end in zip(k4._host["edge_desc"].tolist()[:2], k4.edge):
            if d >> cseg.INDEX_BITS == cseg.K_POOL:
                assert held[d & INDEX] == end - k4.rows[-1].loc0


def _args(case, seg, dtype):
    tips = case["ttopo"].schedule.tips
    tm = model_from_numpy(case["model"], "cpu", dtype)
    return (cseg.pack_tips_segmented(case["clv"][:tips].astype(
                np.float32 if dtype == torch.float32 else np.float64), seg),
            port_pmatrix(case, dtype),
            cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
            tm["pattern_weights"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scale_mode", [SCALE_NONE, SCALE_PER_SITE,
                                        SCALE_PER_RATE])
@pytest.mark.parametrize("label", list(TREES))
def test_plain_walk_equals_plain(label, scale_mode, dtype):
    """K3's and K4's walk equal their plain versions bit for bit; on the
    caterpillar (tiny tips in float64) scaling fires."""
    case, seg, k3, k4 = _kernels(
        label, scale_mode,
        tiny=dtype == torch.float64 and scale_mode != SCALE_NONE)
    slabs, pm, wvec, pw = _args(case, seg, dtype)
    inner, scal = k3.plain_walk(slabs, pm)
    want_inner, want_scal = k3.plain(slabs, pm)
    assert torch.equal(inner, want_inner) and torch.equal(scal, want_scal)
    if label.startswith("caterpillar") and scale_mode != SCALE_NONE:
        assert int(scal.sum()) > 0
    got = k4.plain_walk(slabs, pm, wvec, pw)
    assert got.dtype == torch.float64
    assert float(got) == float(k4.plain(slabs, pm, wvec, pw))
    assert np.isfinite(float(got))


@pytest.mark.parametrize("tree,tips,max_rows,scale_mode", [
    ("random", 32, 16, SCALE_PER_SITE),
    ("caterpillar", 48, 20, SCALE_PER_RATE)])
def test_plain_walk_sweep_vs_jax_f32(tree, tips, max_rows, scale_mode):
    """K3's walk vs the JAX segmented sweep (interpret mode), float32."""
    newick = (_random_tree_newick(tips, np.random.default_rng(tips))
              if tree == "random" else _caterpillar_newick(tips))
    jtopo, jpm, _, ttopo, tmodel, tip_clv = built_case(newick, scale_mode)
    jseg, tseg = schedules(jtopo, ttopo, max_rows)
    j_inner, j_scal = cps.make_segmented_sweep(
        jseg, scale_mode, impl="mxu", rate_cats=4, states=4,
        block_sites=128, interpret=True)(
        cps.pack_tips_segmented(jnp.asarray(tip_clv), jseg, "mxu"), jpm)
    got, got_scal = cseg.make_segmented_sweep(
        tseg, scale_mode, rate_cats=4, states=4).plain_walk(
        cseg.pack_tips_segmented(tip_clv, tseg),
        port_pm(ttopo, tmodel, torch.float32))
    assert_f32_sweep_agrees(got, got_scal,
                            cp.unpack_clv(j_inner, 4, 4, "mxu"), j_scal)


@pytest.mark.parametrize("scale_mode", [SCALE_PER_SITE, SCALE_PER_RATE])
def test_plain_walk_score_vs_jax_f32(scale_mode):
    """K4's walk vs the JAX segmented score (interpret mode) on the
    24-taxon tree cut at 14 rows: logL at rtol 2e-6."""
    newick = _random_tree_newick(24, np.random.default_rng(9))
    jtopo, jpm, jm, ttopo, tm, tip_clv = built_case(newick, scale_mode,
                                                    seed=9)
    jseg, tseg = schedules(jtopo, ttopo, 14)
    want = float(cps.make_segmented_score(
        jseg, jtopo.parent_clv, jtopo.child_clv, jtopo.edge_matrix,
        scale_mode, impl="mxu", rate_cats=4, states=4, block_sites=128,
        interpret=True)(
        cps.pack_tips_segmented(jnp.asarray(tip_clv), jseg, "mxu"), jpm,
        cp.pack_weight_vec(jm["freqs_pc"], jm["rate_weights"], "mxu"),
        jm["pattern_weights"][None, :].astype(jnp.float32)))
    got = cseg.make_segmented_score(
        tseg, ttopo.parent_clv, ttopo.child_clv, ttopo.edge_matrix,
        scale_mode, rate_cats=4, states=4).plain_walk(
        cseg.pack_tips_segmented(tip_clv, tseg),
        port_pm(ttopo, tm, torch.float32),
        cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
        tm["pattern_weights"])
    np.testing.assert_allclose(float(got), want, rtol=LOGL_RTOL)


@pytest.mark.parametrize("scale_mode", [SCALE_NONE, SCALE_PER_SITE,
                                        SCALE_PER_RATE])
def test_plain_walk_f64_vs_xla(scale_mode):
    """float64, tiny tips where scaling is on: K3's walk equals the JAX
    level sweep (scalers exact, CLVs rel 1e-12) and K4's the JAX
    make_forward (rel 1e-12)."""
    case = make_case(_random_tree_newick(32, np.random.default_rng(32)),
                     128, seed=5, scale_mode=scale_mode,
                     tiny=scale_mode != SCALE_NONE)
    jt, tt = case["jtopo"], case["ttopo"]
    tips = jt.schedule.tips
    _, tseg = schedules(jt, tt, 12)
    jpm = jev._pmatrices(jax_model(case["model"]), jt, jnp.float64)
    want_clv, want_scal = (np.asarray(a) for a in j_sweep(
        jt.schedule, scale_mode)(jnp.asarray(case["clv"]),
                                 jnp.asarray(case["scalers"]), jpm))
    slabs = cseg.pack_tips_segmented(case["clv"][:tips], tseg)
    pm = port_pmatrix(case, torch.float64)
    got, got_scal = (a.numpy() for a in cseg.make_segmented_sweep(
        tseg, scale_mode, rate_cats=4, states=4).plain_walk(slabs, pm))
    if scale_mode != SCALE_NONE:
        assert got_scal.sum() > 0
    for r in range(tseg.n_inner):
        row = tseg.inner_row(r)
        np.testing.assert_array_equal(got_scal[row], want_scal[r])
        np.testing.assert_allclose(got[row], want_clv[tips + r],
                                   rtol=F64_RTOL, atol=0)
    want = float(jev.make_forward(jt)(jax_model(case["model"]),
                                      jnp.asarray(case["clv"]),
                                      jnp.asarray(case["scalers"]))[0])
    tm = model_from_numpy(case["model"], "cpu", torch.float64)
    got = cseg.make_segmented_score(
        tseg, tt.parent_clv, tt.child_clv, tt.edge_matrix, scale_mode,
        rate_cats=4, states=4).plain_walk(
        slabs, pm, cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
        tm["pattern_weights"])
    np.testing.assert_allclose(float(got), want, rtol=F64_RTOL)


def test_plain_walk_protein_vs_jax_f32():
    """S = 20 at two rates, per-rate scaling: K3's walk vs the JAX
    segmented sweep and K4's vs the JAX segmented score (interpret
    mode)."""
    case = make_case(_random_tree_newick(12, np.random.default_rng(2)), 128,
                     seed=3, states=20, rate_cats=2,
                     scale_mode=SCALE_PER_RATE, dtype=np.float32)
    jt, tt = case["jtopo"], case["ttopo"]
    tips = jt.schedule.tips
    jseg, tseg = schedules(jt, tt, 8, rate_cats=2, states=20)
    jm = jax_model(case["model"])
    jpm = jev._pmatrices(jm, jt, jnp.float32)
    jslabs = cps.pack_tips_segmented(jnp.asarray(case["clv"][:tips]), jseg,
                                     "mxu")
    j_inner, j_scal = cps.make_segmented_sweep(
        jseg, SCALE_PER_RATE, impl="mxu", rate_cats=2, states=20,
        interpret=True)(jslabs, jpm)
    slabs = cseg.pack_tips_segmented(case["clv"][:tips], tseg)
    pm = port_pmatrix(case, torch.float32)
    got, got_scal = cseg.make_segmented_sweep(
        tseg, SCALE_PER_RATE, rate_cats=2, states=20).plain_walk(slabs, pm)
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
        tseg, tt.parent_clv, tt.child_clv, tt.edge_matrix,
        SCALE_PER_RATE, rate_cats=2, states=20).plain_walk(
        slabs, pm, cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"]),
        tm["pattern_weights"])
    np.testing.assert_allclose(float(got), want, rtol=LOGL_RTOL)


def test_readme_cut_layout():
    """The README configuration's cut (1 024 taxa at seg_max_rows, DNA,
    four rates, float32, per-site scaling): 115 segments whose live rows
    need a pool of 4 slots, and a block's shared memory that lets eight
    blocks share an SM (228 KB, 1 KB reserved per block, 1 KB of static
    shared memory): with 32 768 sites all 1 024 blocks are resident at
    once on 132 SMs."""
    topo, _ = build_flagship_topology(1024, 8, seed=0)
    seg = cseg.build_segmented_schedule(
        topo.schedule, max_rows=cseg.seg_max_rows(4, 4, torch.float32),
        ensure_rows=[topo.parent_clv, topo.child_clv])
    assert len(seg.segments) == 115
    k3 = cseg.make_segmented_sweep(seg, SCALE_PER_SITE, rate_cats=4,
                                   states=4)
    k4 = cseg.make_segmented_score(seg, topo.parent_clv, topo.child_clv,
                                   topo.edge_matrix, SCALE_PER_SITE,
                                   rate_cats=4, states=4)
    for kernel in (k3, k4):
        assert kernel.pool == 4
        assert max(g.r_tip for g in kernel.rows) == 12
        assert kernel.smem(torch.float32) == 8192 + 4 * 32 * 68 + 128 * 8
        assert 8 * (kernel.smem(torch.float32) + 2048) <= 233472
        assert not kernel.instance(torch.float64)


def test_slab_table_checked_once():
    """The slab list is checked the first time it is seen, then served
    from the cache; a slab at a cached address with another shape or
    layout is checked anew."""
    case, seg, k3, _ = _kernels("random32/16", sites=64)
    slabs, pm, _, _ = _args(case, seg, torch.float32)
    ptrs = k3._slab_table(slabs, pm)
    assert ptrs.tolist() == [s.data_ptr() for s in slabs]
    assert k3._slab_table(slabs, pm) is ptrs
    with pytest.raises(EinvalError, match="tip slab"):
        k3._slab_table([slabs[0][:, :, :63].clone()] + slabs[1:], pm)
    # the same addresses: one slab cut to its first tip row, or read
    # strided
    i = next(i for i, s in enumerate(slabs) if s.shape[0] > 1)
    for bad in (slabs[i][:1], slabs[i].transpose(0, 1)):
        assert bad.data_ptr() == slabs[i].data_ptr()
        with pytest.raises(EinvalError, match=f"tip slab {i}"):
            k3._slab_table(slabs[:i] + [bad] + slabs[i + 1:], pm)
    odd = [s[..., :63].contiguous() for s in slabs]
    assert k3._slab_table(odd, pm).tolist() == [s.data_ptr() for s in odd]
    with pytest.raises(EinvalError, match="tip slabs"):
        k3._slab_table(slabs[:-1], pm)


def test_kernels_on_cpu_launch_nothing():
    """On CPU tensors the wrappers run their plain versions and count no
    launch, with one launch per call or one per segment."""
    case, seg, k3, k4 = _kernels("random32/16")
    args = _args(case, seg, torch.float32)
    before = (cseg.SegmentedSweep.launches, cseg.SegmentedScore.launches)
    for split in (False, True):
        k3.split = k4.split = split
        assert torch.equal(k3(*args[:2])[0], k3.plain(*args[:2])[0])
        assert float(k4(*args)) == float(k4.plain(*args))
    assert (cseg.SegmentedSweep.launches,
            cseg.SegmentedScore.launches) == before
