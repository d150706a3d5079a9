"""The walk of the fused kernels K1/K2 (``csrc/clv_fused.cu``): the ops in
a Sethi–Ullman post order planned once per topology
(``clv_fused.FusedPlan``), each live inner row in a slot of a
shared-memory pool (``clv_seg.segment_slots``), each op a descriptor.
Checked on the CPU, where no kernel runs:

  * The walk covers every op once, children before parents; the pool
    never hands a live row's slot to another row; K1's edge rows are in
    the pool at the end; the peak is 3 slots on the seed-0 flagship
    topology and 6 at 1 000 taxa.
  * ``plain_walk`` / ``plain_walk_score`` (the kernels' walk with PyTorch
    ops) equal ``fused_sweep_plain`` / ``fused_edge_score_plain`` bit for
    bit (the same PyTorch ops per op; only the order of independent ops
    and where rows live differ), for every tip encoding, scale mode, ±I,
    C in {1, 2, 4, 8}, float32 and float64; and JAX's
    ``make_fused_sweep`` / ``make_fused_edge_score`` (interpret mode)
    within the float32 rule of ``tests/test_torch_fused.py``.

The CUDA kernels are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas as cp

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                              SCALE_PER_SITE)
from libpll_tpu_torch.utils.flagship import build_flagship_topology

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_torch_fused import (IUPAC_POOL, assert_in_budget, f64_truth,
                              iupac_case, jax_tips, port_tips)
from test_torch_ops import (assert_f32_sweep_agrees, jax_model, make_case,
                            port_pmatrix)

INDEX = (1 << cf.INDEX_BITS) - 1
TREES = {
    "random24": lambda: _random_tree_newick(24, np.random.default_rng(24)),
    "caterpillar40": lambda: _caterpillar_newick(40),
}


def _walk_holds(plan):
    """Walk the descriptors as the kernel does; return the pool at the end
    (slot -> level-major inner row), asserting every pool read finds the
    row the schedule names and every chars tip its word and nibble."""
    sched = plan.schedule
    flat = {int(r[0]): r for r in cf.flatten_ops(sched)}
    held, done = {}, set()
    for o in plan.ops.numpy():
        row = flat[int(o[9])]
        for k, (c, s) in enumerate(((row[1], row[5]), (row[3], row[6]))):
            d = int(o[2 + k])
            if c >= sched.tips:
                assert c - sched.tips in done
                assert d >> cf.INDEX_BITS == cf.K_POOL
                assert held[d & INDEX] == c - sched.tips
                assert o[10 + k] == 0
            else:
                assert (d >> cf.INDEX_BITS, d & INDEX, o[10 + k]) == (
                    cf.K_TIP, c >> 3, 4 * (c & 7))
            sd = int(o[4 + k])
            if s == sched.n_inner:
                assert sd == cf.K_ZERO
            else:
                assert held[sd & INDEX] == s
        assert 0 <= o[1] < plan.pool
        held[int(o[1])] = int(o[9])
        done.add(int(o[9]))
    assert done == set(range(sched.n_inner))
    return held


@pytest.mark.parametrize("tips,seed,peak", [(64, 0, 3), (1000, 0, 6)])
def test_plan_peak_and_slots(tips, seed, peak):
    """The flagship's topology (seed 0) and 1 000 taxa: the walk needs
    3 and 6 pool slots, for K1 (edge rows kept) and K2; no slot is handed
    over while its row is live; chars tips name their word and nibble;
    K1's edge rows are in the pool at the end."""
    topo, _ = build_flagship_topology(tips, 8, seed=seed)
    sched = topo.schedule
    k1 = cf.FusedPlan(sched, "chars", (topo.parent_clv, topo.child_clv,
                                       topo.edge_matrix))
    k2 = cf.FusedPlan(sched, "chars")
    assert k1.pool == k2.pool == peak
    _walk_holds(k2)
    held = _walk_holds(k1)
    desc = k1.static("edge_desc", "cpu").tolist()
    for d, row in zip(desc[:2], (topo.parent_clv, topo.child_clv)):
        if row >= sched.tips:
            assert d >> cf.INDEX_BITS == cf.K_POOL
            assert held[d & INDEX] == row - sched.tips


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("encoding", ["clv", "chars", "masks"])
@pytest.mark.parametrize("label", list(TREES))
def test_plain_walk_equals_plain(label, encoding, dtype):
    """K2's and K1's walks equal the plain versions bit for bit at every
    scale mode (K1: per-site or none, ±I) and rate count; on the
    caterpillar scaling fires."""
    for rate_cats in (1, 2, 4, 8):
        case = make_case(TREES[label](), 67, seed=rate_cats,
                         rate_cats=rate_cats)
        tt = case["ttopo"]
        sched = tt.schedule
        rng = np.random.default_rng(rate_cats)
        masks = IUPAC_POOL[rng.integers(0, len(IUPAC_POOL),
                                        (sched.tips, 67))]
        words = torch.from_numpy(masks.astype(np.int32))
        tips = {"chars": cf.pack_tipchars(masks), "masks": words,
                "clv": cf.decode_tips(words, "masks",
                                      torch.arange(sched.tips), rate_cats,
                                      4, dtype).contiguous()}[encoding]
        pm = port_pmatrix(case, dtype)
        plan = cf.FusedPlan(sched, encoding)
        for scale in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE):
            got = plan.plain_walk(tips, pm, scale)
            want = cf.fused_sweep_plain(sched, tips, pm, scale_mode=scale,
                                        tip_encoding=encoding)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                want[1])
            if label.startswith("cat") and scale != SCALE_NONE and (
                    dtype == torch.float32):
                assert int(got[1].sum()) > 0
        edge = (tt.parent_clv, tt.child_clv, tt.edge_matrix)
        splan = cf.FusedPlan(sched, encoding, edge)
        tm = model_from_numpy(case["model"], "cpu", dtype)
        for scale in (SCALE_NONE, SCALE_PER_SITE):
            for pinv in (False, True):
                if pinv:
                    tm["prop_invar_pc"] = torch.full_like(
                        tm["prop_invar_pc"], 0.2)
                    tm["invariant"] = torch.arange(67) % 5 - 1
                    wvec, inv_add = tev._pinv_score_inputs(tm, dtype)
                else:
                    wvec = cf.pack_weight_vec(tm["freqs_pc"],
                                              tm["rate_weights"])
                    inv_add = None
                got = splan.plain_walk_score(tips, pm, wvec,
                                             tm["pattern_weights"], inv_add,
                                             scale)
                want = cf.fused_edge_score_plain(
                    sched, tips, pm, wvec, tm["pattern_weights"], inv_add,
                    parent_clv=edge[0], child_clv=edge[1],
                    edge_matrix=edge[2], scale_mode=scale,
                    tip_encoding=encoding)
                assert got.dtype == torch.float64
                assert float(got) == float(want), (rate_cats, scale, pinv)


@pytest.mark.parametrize("encoding,scale_mode", [
    ("chars", SCALE_PER_SITE), ("masks", SCALE_PER_RATE),
    ("clv", SCALE_NONE)])
def test_plain_walk_sweep_vs_jax_f32(encoding, scale_mode):
    """K2's walk vs JAX's fused sweep (interpret mode), float32."""
    case, masks = iupac_case(
        _random_tree_newick(12, np.random.default_rng(21)), 256, seed=21,
        scale_mode=scale_mode)
    jtopo = case["jtopo"]
    jpm = jev._pmatrices(jax_model(case["model"]), jtopo, jnp.float32)
    j_inner, j_scal = cp.make_fused_sweep(
        jtopo.schedule, scale_mode, impl="vpu", rate_cats=4, states=4,
        tip_encoding=encoding, interpret=True)(
        jax_tips(case, masks, encoding), jpm)
    sched = case["ttopo"].schedule
    got, got_scal = cf.FusedPlan(sched, encoding).plain_walk(
        port_tips(case, masks, encoding), port_pmatrix(case, torch.float32),
        scale_mode)
    assert_f32_sweep_agrees(got, got_scal,
                            cp.unpack_clv(j_inner, 4, 4, "vpu"), j_scal)


@pytest.mark.parametrize("encoding,pinv", [("chars", False),
                                           ("masks", True)])
def test_plain_walk_score_vs_jax_f32(encoding, pinv):
    """K1's walk vs JAX's fused edge score (interpret mode) and the
    float64 truth, float32, with and without +I."""
    case, masks = iupac_case(
        _random_tree_newick(12, np.random.default_rng(31)), 256, seed=31)
    if pinv:
        model = case["model"]
        model["prop_invar"][:] = 0.25
        model["prop_invar_pc"][:] = 0.25
        model["invariant"][:32] = np.arange(32) % 4
    want32 = float(jev.make_score(
        case["jtopo"], 4, 4, impl="vpu", use_pinv=pinv,
        tip_encoding=encoding, interpret=True)(
        jax_model(case["model"]), jax_tips(case, masks, encoding)))
    tt = case["ttopo"]
    tm = model_from_numpy(case["model"], "cpu", torch.float32)
    if pinv:
        wvec, inv_add = tev._pinv_score_inputs(tm, torch.float32)
    else:
        wvec = cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"])
        inv_add = None
    got = float(cf.FusedPlan(tt.schedule, encoding,
                             (tt.parent_clv, tt.child_clv,
                              tt.edge_matrix)).plain_walk_score(
        port_tips(case, masks, encoding), port_pmatrix(case, torch.float32),
        wvec, tm["pattern_weights"], inv_add, SCALE_PER_SITE))
    assert_in_budget(got, f64_truth(case), want32)
