"""The protein path of the port: K1/K2's walk at 20 states
(``clv_fused.FusedPlan``), ``make_score``, ``make_forward_fused`` and
``make_train_step_fused`` on an LG4X+Γ4 alignment, and the
``mxu_precision="high"`` repair, against libpll_tpu on the same numpy
inputs (JAX's fused kernels in their MXU variant, ``impl="mxu"``,
``interpret=True``, the variant JAX takes above 8 states).

Inputs: ``utils/flagship.build_protein_flagship`` at 8 taxa (the DNA
flagship's tree, LG4X columns simulated on it, B/Z/X and gaps
among the tips, written to FASTA and read back), its first 512 patterns.

float64: rows rel 1e-12 of each (node, site) block's largest entry,
scalers exact, logL rel 1e-12, t* rel 1e-10.  float32: the float32 rule
of ``tests/test_torch_fused.py`` (counters agree at >= 99.9%, rows rtol
1e-5 where they agree; logL within 2e-6·|logL| + 5e-3 of JAX's float64
and float32), t* within 1e-5 rel.  The CUDA kernels are held against the
plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas as cp

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import clv_dyn as cd
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.utils.constants import SCALE_PER_RATE, SCALE_PER_SITE
from libpll_tpu_torch.utils.flagship import (build_flagship,
                                             build_protein_flagship)

from test_torch_derivatives import F32_T_REL, T_RTOL
from test_torch_fused import assert_in_budget
from test_torch_ops import assert_f32_sweep_agrees, jax_model

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from __graft_entry__ import _build_flagship  # noqa: E402

TIPS, SITES, C, S = 8, 512, 4, 20
F64_RTOL = 1e-12
_CASES = {}


def protein_case(scale_mode=SCALE_PER_SITE, seed=0):
    """(jtopo, ttopo, model, masks, clv): the first ``SITES``
    patterns at ``TIPS`` taxa; ``clv`` [tips, C, S, SITES] float64 0/1
    tip rows of the masks."""
    key = (scale_mode, seed)
    if key not in _CASES:
        topo, model, masks = build_protein_flagship(TIPS, 2 * SITES, seed)
        assert masks.shape[1] >= SITES
        masks = np.ascontiguousarray(masks[:, :SITES])
        for k in ("pattern_weights", "invariant"):
            model[k] = model[k][:SITES]
        jtopo = _build_flagship(TIPS, SITES, seed=seed)[0]
        assert jtopo.schedule.clv_map == topo.schedule.clv_map
        jtopo = jtopo._replace(scale_mode=scale_mode)
        ttopo = topo._replace(sites=SITES, scale_mode=scale_mode)
        bits = (masks[:, None, :] >> np.arange(S)[None, :, None]) & 1
        clv = np.broadcast_to(bits[:, None].astype(np.float64),
                              (TIPS, C, S, SITES)).copy()
        _CASES[key] = (jtopo, ttopo, model, masks, clv)
    return _CASES[key]


def as_dtype(model, dtype):
    return {k: (v.astype(dtype) if np.issubdtype(v.dtype, np.floating)
                else v) for k, v in model.items()}


def jax_tips(masks, clv, encoding, dtype):
    if encoding == "masks":
        return jnp.asarray(masks)
    return cp.pack_tips(jnp.asarray(clv.astype(dtype)), "mxu")


def port_tips(masks, clv, encoding, dtype):
    if encoding == "masks":
        return torch.from_numpy(masks)
    return torch.from_numpy(clv).to(dtype)


def port_pmatrix(ttopo, model, dtype):
    tm = model_from_numpy(model, "cpu", dtype)
    idx = torch.as_tensor(ttopo.matrix_indices, dtype=torch.long)
    return tm, tev._pmatrices(tm, ttopo, dtype, idx)


def assert_f64_rows(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    span = np.abs(want).max(axis=(1, 2), keepdims=True)
    err = np.abs(got - want) / np.maximum(span, np.finfo(np.float64).tiny)
    assert err.max() <= F64_RTOL, err.max()


def test_protein_flagship_inputs():
    """``build_protein_flagship``: the DNA flagship's tree, four LG4X
    eigensystems behind params_indices 0-3, pattern weights that count
    the simulated columns, 20-bit masks with B/Z/X and gaps among them."""
    topo, model, masks = build_protein_flagship(TIPS, 700, seed=1)
    dna_topo = build_flagship(TIPS, 8, seed=1)[0]
    assert topo.schedule.clv_map == dna_topo.schedule.clv_map
    assert topo.sites == masks.shape[1] == model["pattern_weights"].size
    assert model["pattern_weights"].sum() == 700
    assert model["eigenvals"].shape == (4, 20)
    assert model["left"].shape == model["right"].shape == (4, 20, 20)
    assert model["params_indices"].tolist() == [0, 1, 2, 3]
    np.testing.assert_allclose(model["freqs_pc"].sum(axis=1), 1.0)
    assert np.array_equal(model["rate_weights"], [0.1, 0.2, 0.3, 0.4])
    assert masks.dtype == np.int32 and masks.shape[0] == TIPS
    codes = set(np.unique(masks).tolist())
    # gap/X, B = D|N, Z = E|Q, and single states
    assert {0xFFFFF, (1 << 2) | (1 << 3), (1 << 5) | (1 << 6)} <= codes
    assert len(codes) > 20
    again = build_protein_flagship(TIPS, 700, seed=1)
    assert np.array_equal(again[2], masks)


@pytest.mark.parametrize("dtype,encoding,scale_mode", [
    (np.float64, "masks", SCALE_PER_SITE),
    (np.float64, "clv", SCALE_PER_RATE),
    (np.float32, "masks", SCALE_PER_SITE),
    (np.float32, "clv", SCALE_PER_RATE)])
def test_plan_walk_vs_jax(dtype, encoding, scale_mode):
    """K2's walk at 20 states (``plain_walk``) vs JAX's MXU fused sweep,
    and bit for bit vs the plain level sweep ``fused_sweep_plain``."""
    jtopo, ttopo, model, masks, clv = protein_case(scale_mode)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    jpm = jev._pmatrices(jax_model(as_dtype(model, dtype)), jtopo, dtype)
    j_inner, j_scal = cp.make_fused_sweep(
        jtopo.schedule, scale_mode, impl="mxu", rate_cats=C, states=S,
        tip_encoding=encoding, interpret=True)(
        jax_tips(masks, clv, encoding, dtype), jpm)
    want = cp.unpack_clv(j_inner, C, S, "mxu")
    tips = port_tips(masks, clv, encoding, tdtype)
    pm = port_pmatrix(ttopo, model, tdtype)[1]
    plan = cf.FusedPlan(ttopo.schedule, encoding)
    got, got_scal = plan.plain_walk(tips, pm, scale_mode)
    plain = cf.fused_sweep_plain(ttopo.schedule, tips, pm,
                                 scale_mode=scale_mode, tip_encoding=encoding)
    assert torch.equal(got, plain[0]) and torch.equal(got_scal, plain[1])
    assert tuple(got.shape) == tuple(want.shape)
    if dtype == np.float64:
        assert np.array_equal(got_scal.numpy(), np.asarray(j_scal))
        assert_f64_rows(got, want)
    else:
        assert_f32_sweep_agrees(got, got_scal, want, j_scal)


@pytest.mark.parametrize("dtype,pinv", [(np.float64, False),
                                        (np.float64, True),
                                        (np.float32, True)])
def test_plan_walk_score_vs_jax(dtype, pinv):
    """K1's walk at 20 states (``plain_walk_score``, masks) vs JAX's MXU
    fused edge score, ±I, and vs the JAX float64 truth."""
    jtopo, ttopo, model, masks, clv = protein_case()
    model = dict(model)
    if pinv:
        model["prop_invar"] = np.full(4, 0.15)
        model["prop_invar_pc"] = np.full(4, 0.15)
        model["invariant"] = np.where(np.arange(SITES) % 7 == 0,
                                      np.arange(SITES) % S, -1)
    m = as_dtype(model, dtype)
    want = float(jev.make_score(
        jtopo, C, S, impl="mxu", use_pinv=pinv, tip_encoding="masks",
        interpret=True)(jax_model(m), jnp.asarray(masks)))
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tm, pm = port_pmatrix(ttopo, model, tdtype)
    if pinv:
        wvec, inv_add = tev._pinv_score_inputs(tm, tdtype)
    else:
        wvec = cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"])
        inv_add = None
    edge = (ttopo.parent_clv, ttopo.child_clv, ttopo.edge_matrix)
    got = float(cf.FusedPlan(ttopo.schedule, "masks", edge).plain_walk_score(
        torch.from_numpy(masks), pm, wvec, tm["pattern_weights"], inv_add,
        SCALE_PER_SITE))
    if dtype == np.float64:
        assert abs(got - want) <= F64_RTOL * abs(want), (got, want)
    else:
        truth = float(jev.make_score(
            jtopo, C, S, impl="mxu", use_pinv=pinv, tip_encoding="masks",
            interpret=True)(jax_model(as_dtype(model, np.float64)),
                            jnp.asarray(masks)))
        assert_in_budget(got, want, truth)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_slice_vs_jax(dtype):
    """``make_score``, ``make_forward_fused`` and ``make_train_step_fused``
    at 20 states on the CPU (pattern tips) vs JAX's (CLV tips in the MXU
    layout; JAX's score takes masks): logL and t*."""
    jtopo, ttopo, model, masks, clv = protein_case()
    m = as_dtype(model, dtype)
    jm = jax_model(m)
    jclv = jax_tips(masks, clv, "clv", dtype)
    want_score = float(jev.make_score(
        jtopo, C, S, tip_encoding="masks", interpret=True)(
        jm, jnp.asarray(masks)))
    want_fwd = float(jev.make_forward_fused(jtopo, C, S, interpret=True)(
        jm, jclv)[0])
    want_step = [float(v) for v in jev.make_train_step_fused(
        jtopo, C, S, interpret=True)(jm, jclv)]
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tm = model_from_numpy(model, "cpu", tdtype)
    tips = torch.from_numpy(masks)
    kw = dict(tip_encoding="masks", device="cpu")
    got_score = float(tev.make_score(ttopo, C, S, **kw)(tm, tips))
    fwd = tev.make_forward_fused(ttopo, C, S, **kw)
    got_fwd, _, inner, scalers = fwd(tm, tips)
    assert tuple(inner.shape) == (ttopo.schedule.n_inner, C, S, SITES)
    got_step = [float(v) for v in tev.make_train_step_fused(
        ttopo, C, S, **kw)(tm, tips)]
    assert got_step[0] == float(got_fwd)
    assert 1e-8 < got_step[1] < 100.0
    pairs = ((got_score, want_score), (float(got_fwd), want_fwd),
             (got_step[0], want_step[0]))
    if dtype == np.float64:
        for got, want in pairs:
            assert abs(got - want) <= F64_RTOL * abs(want), (got, want)
        assert abs(got_step[1] - want_step[1]) <= T_RTOL * want_step[1]
    else:
        for got, want in pairs:
            assert_in_budget(got, want)
        assert abs(got_step[1] - want_step[1]) <= F32_T_REL * want_step[1]


def test_precision_high():
    """``mxu_precision="high"`` is accepted by every factory that takes
    it and computed at "highest": the same bits in the port, within the
    f32 budget of JAX's bf16x3 "high"; any other precision raises."""
    jtopo, ttopo, model, masks, clv = protein_case()
    m32 = as_dtype(model, np.float32)
    tm = model_from_numpy(model, "cpu", torch.float32)
    tips = torch.from_numpy(masks)
    kw = dict(tip_encoding="masks", device="cpu")
    highest = float(tev.make_score(ttopo, C, S, **kw)(tm, tips))
    high = float(tev.make_score(ttopo, C, S, mxu_precision="high", **kw)(
        tm, tips))
    assert high == highest
    want = float(jev.make_score(
        jtopo, C, S, impl="mxu", tip_encoding="masks", mxu_precision="high",
        interpret=True)(jax_model(m32), jnp.asarray(masks)))
    assert_in_budget(high, want)
    unbounded = [float(tev.make_score_unbounded(
        ttopo, C, S, masks, mxu_precision=p, device="cpu")(tm))
        for p in ("highest", "high")]
    assert unbounded[0] == unbounded[1]
    assert_in_budget(unbounded[1], want)
    dyn = cd.build_dyn_schedule(ttopo.schedule, rate_cats=C, states=S,
                                sites=SITES,
                                ensure_rows=[ttopo.parent_clv,
                                             ttopo.child_clv])
    cd.make_dyn_sweep(dyn, rate_cats=C, states=S, tip_encoding="masks",
                      mxu_precision="high")
    cd.make_dyn_score(dyn, ttopo.parent_clv, ttopo.child_clv,
                      ttopo.edge_matrix, rate_cats=C, states=S,
                      tip_encoding="masks", mxu_precision="high")
    for bad in ("default", "float32", "HIGH"):
        with pytest.raises(EinvalError):
            tev.make_score(ttopo, C, S, mxu_precision=bad, **kw)
        with pytest.raises(EinvalError):
            tev.make_score_unbounded(ttopo, C, S, masks, mxu_precision=bad,
                                     device="cpu")
        with pytest.raises(EinvalError):
            cd.make_dyn_sweep(dyn, rate_cats=C, states=S,
                              tip_encoding="masks", mxu_precision=bad)


def test_layout_raises_and_chars(monkeypatch):
    """A pool that does not fit the protein instance's block takes the
    any-alphabet instance from ``FusedPlan.layout`` (the library's
    answers stubbed here: the queries need the card), its rows spilled
    where the budget of 16 warps an SM cannot hold them; pattern tips at
    20 states are "masks", "chars" (a nibble) raises."""
    _, ttopo, *_ = protein_case()
    plan = cf.FusedPlan(ttopo.schedule, "masks")

    class NoFit:
        def clv_fused_layout(self, *args):
            self.args = args
            return 1  # cudaErrorInvalidValue

        def clv_any_query(self, states, f64, score, threads, smem, out):
            out[0], out[1], out[2] = 232448, 132, 4
            return 0

    lib = NoFit()
    monkeypatch.setattr(cf, "load_kernels", lambda: lib)
    monkeypatch.setattr(cf, "load_any_kernels", lambda: lib)
    lay = plan.layout(torch.float64, 8, 20, SCALE_PER_SITE, True)
    assert lib.args[:6] == (20, 1, 8, SCALE_PER_SITE, 1, plan.pool)
    # a block of 32 sites and eight warps: 2 slots (41 088 bytes each) fit
    # the budget of 16 warps an SM, the rest of a pool spills; capped at
    # one slot, the other spills
    assert plan.pool == 2
    assert lay["shared_slots"] == 2 and lay["smem"] == 2 * 41088
    assert (lay["threads"], lay["block_sites"], lay["blocks_per_sm"],
            lay["sms"]) == (8 * 32, cf.ANY_SITES, 4, 132)
    lay = cf.any_layout(plan.pool, 8, 20, 8, SCALE_PER_SITE, 1)
    assert lay["shared_slots"] == 1 and lay["smem"] == 41088
    for make in (tev.make_score, tev.make_forward_fused,
                 tev.make_train_step_fused):
        with pytest.raises(EinvalError):
            make(ttopo, C, S, tip_encoding="chars", device="cpu")


@pytest.mark.parametrize("block_sites, buffers", [(64, 2), (32, 2), (32, 1)])
def test_layout_tile_and_grid(monkeypatch, block_sites, buffers):
    """``FusedPlan.layout`` reads the library's seven answers (the sites a
    block, 64 at two sites a thread, and the matrix buffers among them;
    stubbed here: the query needs the card), and ``launch_grid`` covers
    the sites padded to whole 128-site partials with tiles of that many
    sites, capped at the blocks the card holds at once: one partial of
    32 sites per tile and thread row, so the kernel's 32-site partials
    are ``4 * ceil(sites / 128)`` whatever the tile."""
    _, ttopo, *_ = protein_case()
    plan = cf.FusedPlan(ttopo.schedule, "masks")

    class Fits:
        def clv_fused_layout(self, *args):
            out = args[-1]
            for k, v in enumerate((60800, 3, 128, 64, block_sites, 132,
                                   buffers)):
                out[k] = v
            return 0

    monkeypatch.setattr(cf, "load_kernels", lambda: Fits())
    lay = plan.layout(torch.float32, C, S, SCALE_PER_SITE, True)
    assert lay == dict(smem=60800, blocks_per_sm=3, threads=128, chunk=64,
                       block_sites=block_sites, sms=132, buffers=buffers)
    for sites, tiles in ((1, 128 // block_sites), (128, 128 // block_sites),
                         (129, 256 // block_sites),
                         (65132, 65152 // block_sites)):
        assert cf.launch_grid(sites, lay) == min(tiles, 3 * 132)
        assert tiles * block_sites == -(-sites // cf.BLOCK_SITES) * 128
    assert cf.launch_grid(10 ** 7, dict(lay, blocks_per_sm=0)) == 132

