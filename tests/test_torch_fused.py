"""K1 (fused edge score) and K2 (fused sweep) of the port.

On the CPU each wrapper runs its plain PyTorch version; those are held
against the JAX Pallas kernels run as the JAX tests run them
(``interpret=True``), with the same numpy inputs, for all three tip
encodings and multi-bit IUPAC codes (R/Y/N/gap) among the tips.

float32 rule (JAX and port differ in summation order): logL within
2e-6·|logL| + 5e-3 of JAX's float64 truth and of JAX's float32 kernel;
scaler counters agree at >= 99.9% of entries; inner CLVs at rtol 1e-5
(relative to each node's site block) where they agree.

The CUDA kernels themselves are tested on the card by
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.io.maps import tipmask_to_clv
from libpll_tpu.ops import clv_pallas as cp

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                              SCALE_PER_SITE)

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_torch_ops import (assert_f32_sweep_agrees, jax_model, make_case,
                            port_pmatrix)

ACC_REL, ACC_ABS = 2e-6, 5e-3
# A C G T, R=A|G, Y=C|T, W=A|T, S=C|G, N/gap
IUPAC_POOL = np.array([1, 2, 4, 8, 5, 10, 9, 6, 15], np.uint32)


def iupac_case(newick, sites, seed, scale_mode=SCALE_PER_SITE,
               dtype=np.float32):
    """make_case with IUPAC ambiguity masks as tips; returns (case, masks)
    with case["clv"] holding the matching 0/1 tip CLVs."""
    case = make_case(newick, sites, seed=seed, scale_mode=scale_mode,
                     dtype=dtype)
    tips = case["jtopo"].schedule.tips
    rng = np.random.default_rng(seed + 1000)
    masks = IUPAC_POOL[rng.integers(0, len(IUPAC_POOL), (tips, sites))]
    for i in range(tips):
        case["clv"][i] = np.asarray(tipmask_to_clv(masks[i], 4)).T[None]
    return case, masks


def port_tips(case, masks, encoding):
    if encoding == "chars":
        return cf.pack_tipchars(masks)
    if encoding == "masks":
        return torch.from_numpy(masks.astype(np.int32))
    return torch.from_numpy(case["clv"][:case["ttopo"].schedule.tips])


def jax_tips(case, masks, encoding):
    if encoding == "chars":
        return cp.pack_tipchars(masks)
    if encoding == "masks":
        return jnp.asarray(masks.astype(np.int32))
    return cp.pack_tips(jnp.asarray(case["clv"][:case["jtopo"].schedule.tips]),
                        "vpu")


def f64_truth(case):
    """JAX make_forward in float64 on the same tips (the reference)."""
    model = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
             for k, v in case["model"].items()}
    return float(jev.make_forward(case["jtopo"])(
        jax_model(model), jnp.asarray(case["clv"], jnp.float64),
        jnp.asarray(case["scalers"]))[0])


def assert_in_budget(got, *refs):
    for want in refs:
        assert abs(got - want) <= ACC_REL * abs(want) + ACC_ABS, (got, want)


@pytest.mark.parametrize("encoding", ["clv", "chars", "masks"])
@pytest.mark.parametrize("scale_mode", [SCALE_NONE, SCALE_PER_SITE,
                                        SCALE_PER_RATE])
def test_fused_sweep_plain_vs_jax(encoding, scale_mode):
    """Plain K2 vs the JAX fused sweep (interpret mode), IUPAC tips."""
    case, masks = iupac_case(
        _random_tree_newick(12, np.random.default_rng(21)), 256, seed=21,
        scale_mode=scale_mode)
    jtopo = case["jtopo"]
    jpm = jev._pmatrices(jax_model(case["model"]), jtopo, jnp.float32)
    sweep = cp.make_fused_sweep(jtopo.schedule, scale_mode, impl="vpu",
                                rate_cats=4, states=4,
                                tip_encoding=encoding, interpret=True)
    j_inner, j_scal = sweep(jax_tips(case, masks, encoding), jpm)
    want = cp.unpack_clv(j_inner, 4, 4, "vpu")
    got, got_scal = cf.fused_sweep(
        case["ttopo"].schedule, port_tips(case, masks, encoding),
        port_pmatrix(case, torch.float32), scale_mode=scale_mode,
        tip_encoding=encoding)
    assert tuple(got.shape) == tuple(want.shape)
    assert tuple(got_scal.shape) == tuple(j_scal.shape)
    assert_f32_sweep_agrees(got, got_scal, want, j_scal)


def test_fused_sweep_plain_vs_jax_scaling_events():
    """48-taxon caterpillar in float32: thousands of scaling events."""
    case = make_case(_caterpillar_newick(48), 256, seed=5, dtype=np.float32)
    jtopo = case["jtopo"]
    tips = jtopo.schedule.tips
    jpm = jev._pmatrices(jax_model(case["model"]), jtopo, jnp.float32)
    sweep = cp.make_fused_sweep(jtopo.schedule, SCALE_PER_SITE, impl="mxu",
                                rate_cats=4, states=4, interpret=True)
    j_inner, j_scal = sweep(
        cp.pack_tips(jnp.asarray(case["clv"][:tips]), "mxu"), jpm)
    got, got_scal = cf.fused_sweep(
        case["ttopo"].schedule, torch.from_numpy(case["clv"][:tips]),
        port_pmatrix(case, torch.float32))
    assert np.asarray(j_scal)[:-1].sum() > 1000
    assert_f32_sweep_agrees(got, got_scal,
                            cp.unpack_clv(j_inner, 4, 4, "mxu"), j_scal)


@pytest.mark.parametrize("encoding,scale_mode,pinv", [
    ("clv", SCALE_PER_SITE, False), ("chars", SCALE_PER_SITE, False),
    ("masks", SCALE_PER_SITE, False), ("clv", SCALE_NONE, False),
    ("chars", SCALE_NONE, True), ("masks", SCALE_PER_SITE, True),
    ("clv", SCALE_PER_SITE, True)])
def test_fused_edge_score_plain_vs_jax(encoding, scale_mode, pinv):
    """Plain K1 vs the JAX fused edge score (interpret mode) and vs the
    float64 truth, IUPAC tips, with and without +I."""
    case, masks = iupac_case(
        _random_tree_newick(12, np.random.default_rng(31)), 256, seed=31,
        scale_mode=scale_mode)
    if pinv:
        model = case["model"]
        model["prop_invar"][:] = 0.25
        model["prop_invar_pc"][:] = 0.25
        model["invariant"][:32] = np.arange(32) % 4
    truth = f64_truth(case)
    jm = jax_model(case["model"])
    jscore = jev.make_score(case["jtopo"], 4, 4, impl="vpu", use_pinv=pinv,
                            tip_encoding=encoding, interpret=True)
    want32 = float(jscore(jm, jax_tips(case, masks, encoding)))
    ttopo = case["ttopo"]
    tm = model_from_numpy(case["model"], "cpu", torch.float32)
    if pinv:
        wvec, inv_add = tev._pinv_score_inputs(tm, torch.float32)
    else:
        wvec = cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"])
        inv_add = None
    got = float(cf.fused_edge_score(
        ttopo.schedule, port_tips(case, masks, encoding),
        port_pmatrix(case, torch.float32), wvec, tm["pattern_weights"],
        inv_add, parent_clv=ttopo.parent_clv, child_clv=ttopo.child_clv,
        edge_matrix=ttopo.edge_matrix, scale_mode=scale_mode,
        tip_encoding=encoding))
    assert_in_budget(got, truth, want32)


def test_pack_helpers_match_jax():
    rng = np.random.default_rng(2)
    for tips in (7, 8, 9, 17):
        masks = IUPAC_POOL[rng.integers(0, len(IUPAC_POOL), (tips, 33))]
        packed = cf.pack_tipchars(masks)
        np.testing.assert_array_equal(packed.numpy(),
                                      np.asarray(cp.pack_tipchars(masks)))
        # decoding the nibbles (tip 7 of a word holds the sign bit) gives
        # back the reference's set_tipclv bit walk
        rows = torch.arange(tips)
        got = cf.decode_tips(packed, "chars", rows, 2, 4, torch.float64)
        want = np.stack([np.asarray(tipmask_to_clv(m, 4)).T for m in masks])
        np.testing.assert_array_equal(got.numpy(),
                                      np.broadcast_to(want[:, None],
                                                      got.shape))
    with pytest.raises(EinvalError):
        cf.pack_tipchars(np.full((2, 3), 0x1F, np.uint32))
    freqs = rng.dirichlet(np.ones(4), 3)
    weights = rng.dirichlet(np.ones(3))
    np.testing.assert_allclose(
        cf.pack_weight_vec(torch.from_numpy(freqs),
                           torch.from_numpy(weights)).numpy(),
        np.asarray(cp.pack_weight_vec(jnp.asarray(freqs),
                                      jnp.asarray(weights), "mxu"))[:, 0],
        rtol=0)
    parts = torch.full((4096,), -2441.406, dtype=torch.float32)
    total = cf.sum_block_partials(parts)
    assert total.dtype == torch.float64
    np.testing.assert_allclose(float(total), 4096 * float(parts[0]),
                               rtol=1e-12)


def test_guards():
    """Reference guards: chars needs states <= 4; K1 is per-site/none and
    needs an inner evaluation-edge parent; a wrapper given tensors on a
    device other than the CPU or CUDA raises instead of computing."""
    case = make_case(_random_tree_newick(8, np.random.default_rng(3)), 16)
    sched = case["ttopo"].schedule
    with pytest.raises(EinvalError):
        cf.check_tip_encoding("chars", 5)
    with pytest.raises(EinvalError):
        cf.check_tip_encoding("bytes", 4)
    pm = port_pmatrix(case, torch.float64)
    tips = torch.from_numpy(case["clv"][:sched.tips])
    w = torch.ones(16, dtype=torch.float64)
    with pytest.raises(EinvalError):
        cf.fused_edge_score(sched, tips, pm, w, w, parent_clv=0,
                            child_clv=1, edge_matrix=0)
    with pytest.raises(EinvalError):
        cf.fused_edge_score(sched, tips, pm, w, w, parent_clv=sched.tips,
                            child_clv=0, edge_matrix=0,
                            scale_mode=SCALE_PER_RATE)
    before = (cf.fused_sweep.launches, cf.fused_edge_score.launches)
    cf.fused_sweep(sched, tips, pm)  # the plain version: no launch
    assert (cf.fused_sweep.launches, cf.fused_edge_score.launches) == before
    meta = torch.device("meta")
    with pytest.raises(EinvalError):
        cf.fused_sweep(sched, tips.to(meta), pm.to(meta))


def test_op_table_follows_the_schedule():
    """The kernels' walk (the plan's descriptors) covers every op of the
    schedule once, children before parents, each op writing its own
    level-major row from the schedule's children and matrices."""
    case = make_case(_caterpillar_newick(10), 8)
    sched = case["ttopo"].schedule
    plan = cf.FusedPlan(sched, "clv")
    table = plan.ops.numpy()
    assert table.shape == (sched.n_inner, cf.OP_FIELDS)
    assert table.dtype == np.int32
    np.testing.assert_array_equal(np.sort(table[:, 9]),
                                  np.arange(sched.n_inner))
    flat = {int(r[0]): r for r in cf.flatten_ops(sched)}
    index = (1 << cf.INDEX_BITS) - 1
    done, home = set(range(sched.tips)), {}  # children precede parents
    for i, o in enumerate(table):
        row = flat[int(o[9])]
        for k, c in enumerate((row[1], row[3])):
            assert c in done
            want = ((cf.K_TIP, c) if c < sched.tips
                    else (cf.K_POOL, home[c]))
            assert (o[2 + k] >> cf.INDEX_BITS, o[2 + k] & index) == want
        assert (o[6], o[7]) == (row[2], row[4])
        done.add(int(o[9]) + sched.tips)
        home[int(o[9]) + sched.tips] = int(o[1])
