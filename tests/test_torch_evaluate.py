"""The slice as a whole: the port's evaluation modules against
libpll_tpu.engine.evaluate on the same numpy inputs.

float64: ``make_forward`` and ``make_forward_fused`` (plain K2 on the
CPU) agree with the JAX XLA ``make_forward`` to rel 1e-12 in logL, scalers
exactly, inner CLVs rtol 1e-12 (same algorithm, IEEE f64, summation order
aside); ``make_asc_tail`` likewise.  float32: ``make_score`` (plain K1)
and ``make_forward_fused`` land within 2e-6·|logL| + 5e-3 of the JAX
float64 truth and of the JAX float32 Pallas kernels (``interpret=True``).
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas as cp
from libpll_tpu.ops.sweep import make_level_sweep as j_sweep
from libpll_tpu.utils.constants import SCALE_PER_RATE, SCALE_PER_SITE

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.utils.flagship import build_flagship

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_torch_fused import (assert_in_budget, f64_truth, iupac_case,
                              jax_tips, port_tips)
from test_torch_ops import jax_model, make_case

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from __graft_entry__ import _build_flagship  # noqa: E402

F64_RTOL = 1e-12
STATES = 4


def _asc_extend(case, asc_weights):
    """Append the S all-one-state pseudo columns to the tips, pattern
    weights (= asc_weights) and invariant vector, as the forward path
    wants them (tests/test_score_asc.py)."""
    clv, model = case["clv"], dict(case["model"])
    tips = case["jtopo"].schedule.tips
    nodes, c, s, sites = clv.shape
    ext = np.zeros((nodes, c, s, sites + s), clv.dtype)
    ext[..., :sites] = clv
    ext[:tips, :, :, sites:] = np.eye(s, dtype=clv.dtype)[None, None]
    model["pattern_weights"] = np.concatenate(
        [model["pattern_weights"], asc_weights.astype(clv.dtype)])
    model["invariant"] = np.full(sites + s, -1, np.int32)
    sshape = case["scalers"].shape[:-1] + (sites + s,)
    return ext, model, np.zeros(sshape, np.int32)


@pytest.mark.parametrize("scale_mode,asc_mode", [
    (SCALE_PER_SITE, 0), (SCALE_PER_RATE, 0), (SCALE_PER_SITE, 1),
    (SCALE_PER_SITE, 2), (SCALE_PER_RATE, 3)])
def test_make_forward_f64(scale_mode, asc_mode):
    case = make_case(_random_tree_newick(12, np.random.default_rng(7)), 200,
                     seed=7, scale_mode=scale_mode, tiny=True, pinv=0.15)
    case["model"]["invariant"][:20] = np.arange(20) % STATES
    clv, model, scalers = case["clv"], case["model"], case["scalers"]
    if asc_mode:
        clv, model, scalers = _asc_extend(case, np.asarray([3., 1., 2., 4.]))
    jtopo = case["jtopo"]._replace(asc_mode=asc_mode)
    ttopo = case["ttopo"]._replace(asc_mode=asc_mode)
    want, want_ps = jev.make_forward(jtopo)(
        jax_model(model), jnp.asarray(clv), jnp.asarray(scalers))
    got, got_ps = tev.make_forward(ttopo, device="cpu")(
        model_from_numpy(model, "cpu", torch.float64),
        torch.from_numpy(clv), torch.from_numpy(scalers))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(float(got), float(want), rtol=F64_RTOL)
    np.testing.assert_allclose(got_ps.numpy(), np.asarray(want_ps),
                               rtol=F64_RTOL)


@pytest.mark.parametrize("tip_encoding,scale_mode", [
    ("clv", SCALE_PER_SITE), ("chars", SCALE_PER_SITE),
    ("masks", SCALE_PER_SITE), ("chars", SCALE_PER_RATE)])
def test_make_forward_fused_f64(tip_encoding, scale_mode):
    """Plain K2 through the module, float64: logL vs the JAX make_forward,
    inner CLVs and scalers vs the JAX level sweep."""
    case, masks = iupac_case(_caterpillar_newick(16), 200, seed=8,
                             scale_mode=scale_mode, dtype=np.float64)
    jtopo, ttopo = case["jtopo"], case["ttopo"]
    jm = jax_model(case["model"])
    want, want_ps = jev.make_forward(jtopo)(
        jm, jnp.asarray(case["clv"]), jnp.asarray(case["scalers"]))
    want_clv, want_scal = j_sweep(jtopo.schedule, jtopo.scale_mode)(
        jnp.asarray(case["clv"]), jnp.asarray(case["scalers"]),
        jev._pmatrices(jm, jtopo, jnp.float64))
    fwd = tev.make_forward_fused(ttopo, 4, STATES, tip_encoding=tip_encoding,
                                 device="cpu")
    got, got_ps, inner, scal = fwd(
        model_from_numpy(case["model"], "cpu", torch.float64),
        port_tips(case, masks, tip_encoding))
    np.testing.assert_allclose(float(got), float(want), rtol=F64_RTOL)
    np.testing.assert_allclose(got_ps.numpy(), np.asarray(want_ps),
                               rtol=F64_RTOL)
    np.testing.assert_array_equal(scal.numpy(), np.asarray(want_scal))
    np.testing.assert_allclose(
        inner.numpy(), np.asarray(want_clv)[jtopo.schedule.tips:],
        rtol=F64_RTOL, atol=0)


def test_make_forward_fused_f32_vs_jax_fused():
    case, masks = iupac_case(
        _random_tree_newick(12, np.random.default_rng(9)), 256, seed=9)
    tips = case["jtopo"].schedule.tips
    jfwd = jev.make_forward_fused(case["jtopo"], 4, STATES, impl="mxu",
                                  interpret=True)
    want32 = float(jfwd(jax_model(case["model"]), cp.pack_tips(
        jnp.asarray(case["clv"][:tips]), "mxu"))[0])
    got = tev.make_forward_fused(case["ttopo"], 4, STATES,
                                 tip_encoding="chars", device="cpu")(
        model_from_numpy(case["model"], "cpu", torch.float32),
        cf.pack_tipchars(masks))[0]
    assert_in_budget(float(got), f64_truth(case), want32)


@pytest.mark.parametrize("tip_encoding,use_pinv", [
    ("clv", True), ("chars", True), ("masks", False)])
def test_make_score_f32(tip_encoding, use_pinv):
    """make_score (plain K1) with +I: f32 within budget of the JAX f32
    kernel and the f64 truth."""
    case, masks = iupac_case(_caterpillar_newick(14), 256, seed=10)
    model = case["model"]
    if use_pinv:
        model["prop_invar"][:] = 0.3
        model["prop_invar_pc"][:] = 0.3
        model["invariant"][:40] = np.arange(40) % STATES
    jscore = jev.make_score(case["jtopo"], 4, STATES, impl="vpu",
                            use_pinv=use_pinv, tip_encoding=tip_encoding,
                            interpret=True)
    want32 = float(jscore(jax_model(model),
                          jax_tips(case, masks, tip_encoding)))
    score = tev.make_score(case["ttopo"], 4, STATES, use_pinv=use_pinv,
                           tip_encoding=tip_encoding, device="cpu")
    got = score(model_from_numpy(model, "cpu", torch.float32),
                port_tips(case, masks, tip_encoding))
    assert got.dtype == torch.float64 and got.dim() == 0
    assert_in_budget(float(got), f64_truth(case), want32)


@pytest.mark.parametrize("asc_mode", [1, 2, 3])
def test_make_score_asc(asc_mode):
    """Asc-bias through make_asc_tail: the f64 tail equals JAX's; the f32
    make_score is within budget of the JAX f32 score and of the f64
    forward over the asc-extended site axis."""
    case = make_case(_random_tree_newick(12, np.random.default_rng(asc_mode)),
                     128, seed=asc_mode, dtype=np.float32)
    asc_w = np.asarray([2.0, 1.0, 3.0, 1.0])
    jtopo = case["jtopo"]._replace(asc_mode=asc_mode)
    ttopo = case["ttopo"]._replace(asc_mode=asc_mode)
    tips = jtopo.schedule.tips

    sc_model = dict(case["model"], asc_weights=asc_w.astype(np.float32))
    jscore = jev.make_score(jtopo, 4, STATES, impl="vpu", interpret=True)
    want32 = float(jscore(jax_model(sc_model), cp.pack_tips(
        jnp.asarray(case["clv"][:tips]), "vpu")))
    got = float(tev.make_score(ttopo, 4, STATES, device="cpu")(
        model_from_numpy(sc_model, "cpu", torch.float32),
        torch.from_numpy(case["clv"][:tips])))

    clv, fwd_model, scalers = _asc_extend(case, asc_w)
    fwd64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
             for k, v in fwd_model.items()}
    truth = float(jev.make_forward(jtopo)(
        jax_model(fwd64), jnp.asarray(clv, jnp.float64),
        jnp.asarray(scalers))[0])
    assert_in_budget(got, truth, want32)

    m64 = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
           for k, v in sc_model.items()}
    jm = jax_model(m64)
    want_tail = float(jev.make_asc_tail(jtopo, 4, STATES)(
        jm, jev._pmatrices(jm, jtopo, jnp.float64)))
    tm = model_from_numpy(m64, "cpu", torch.float64)
    tail = tev.make_asc_tail(ttopo, 4, STATES, device="cpu")
    got_tail = float(tail(tm, tail.pmatrices(tm, torch.float64)))
    np.testing.assert_allclose(got_tail, want_tail, rtol=F64_RTOL)


def test_model_from_numpy_carries_a_jax_model():
    jtopo, jmodel, clv, scalers = _build_flagship(12, 64, seed=2)
    model = model_from_numpy({k: np.asarray(v) for k, v in jmodel.items()},
                             "cpu", torch.float64)
    assert sorted(model) == sorted(jmodel)
    for k, v in model.items():
        want = np.asarray(jmodel[k])
        assert v.dtype == (torch.int32 if want.dtype.kind == "i"
                           else torch.float64), k
        np.testing.assert_array_equal(v.numpy(), want.astype(v.numpy().dtype))
    m64 = {k: (v.astype(jnp.float64) if v.dtype == jnp.float32 else v)
           for k, v in jmodel.items()}
    want = float(jev.make_forward(jtopo)(m64, clv.astype(jnp.float64),
                                         scalers)[0])
    topo, _, tclv, tscal = build_flagship(12, 64, seed=2)
    got = float(tev.make_forward(topo, device="cpu")(
        model, torch.from_numpy(tclv).double(), torch.from_numpy(tscal))[0])
    np.testing.assert_allclose(got, want, rtol=F64_RTOL)


def test_module_guards_and_devices():
    case = make_case(_random_tree_newick(8, np.random.default_rng(11)), 32)
    topo = case["ttopo"]
    with pytest.raises(EinvalError):
        tev.make_score(topo._replace(asc_mode=1), 4, STATES, use_pinv=True,
                       device="cpu")
    with pytest.raises(EinvalError):
        tev.make_score(topo._replace(scale_mode=SCALE_PER_RATE), 4, STATES,
                       device="cpu")
    with pytest.raises(EinvalError):
        tev.make_score(topo, 4, 8, tip_encoding="chars", device="cpu")
    score = tev.make_score(topo, 4, STATES, device="cpu")
    assert score.device == torch.device("cpu")
    model = model_from_numpy(case["model"], "cpu", torch.float64)
    tips = torch.from_numpy(case["clv"][:topo.schedule.tips])
    with pytest.raises(EinvalError):  # inputs elsewhere than the module
        score(model, tips.to("meta"))
    moved = score.to("meta")
    assert moved.device == torch.device("meta")
    assert moved.matrix_indices.is_meta
    with pytest.raises(EinvalError):
        moved(model, tips)
    with pytest.raises(EinvalError):  # a CUDA graph takes CUDA tensors
        score.graphed(model, tips)


def test_factories_take_jax_arguments_in_jax_order():
    """make_score / make_forward_fused take JAX's parameters in JAX's
    order: ``make_score(topo, 4, 4, "vpu")`` is JAX's scorer without
    p-inv (the model carries p-inv 0.25, so folding it in would move the
    logL far outside the float32 budget), ``make_forward_fused(topo, 4, 4,
    "vpu")`` JAX's forward; ``mxu_precision="high"`` is accepted and
    computed at "highest" (the same logL); ``impl`` outside ("auto",
    "vpu", "mxu") and ``mxu_precision`` outside ("highest", "high")
    raise."""
    case, masks = iupac_case(
        _random_tree_newick(10, np.random.default_rng(12)), 128, seed=12)
    model = case["model"]
    model["prop_invar"][:] = 0.25
    model["prop_invar_pc"][:] = 0.25
    model["invariant"][:40] = np.arange(40) % STATES
    jtopo, ttopo = case["jtopo"], case["ttopo"]
    tips = case["jtopo"].schedule.tips
    jm = jax_model(model)
    jtips = cp.pack_tips(jnp.asarray(case["clv"][:tips]), "vpu")
    tm = model_from_numpy(model, "cpu", torch.float32)
    ttips = torch.from_numpy(case["clv"][:tips])
    want = float(jev.make_score(jtopo, 4, STATES, "vpu", interpret=True)(
        jm, jtips))
    got = float(tev.make_score(ttopo, 4, STATES, "vpu", device="cpu")(
        tm, ttips))
    assert_in_budget(got, want)
    pinv = float(tev.make_score(ttopo, 4, STATES, "vpu", True,
                                device="cpu")(tm, ttips))
    assert abs(pinv - want) > 100 * (2e-6 * abs(want) + 5e-3)
    want_fwd = float(jev.make_forward_fused(jtopo, 4, STATES, "vpu",
                                            interpret=True)(jm, jtips)[0])
    got_fwd = float(tev.make_forward_fused(ttopo, 4, STATES, "vpu",
                                           device="cpu")(
        tm, ttips)[0])
    assert_in_budget(got_fwd, want_fwd)
    with pytest.raises(EinvalError):
        tev.make_score(ttopo, 4, STATES, "tensor", device="cpu")
    with pytest.raises(EinvalError):
        tev.make_forward_fused(ttopo, 4, STATES, "tensor", device="cpu")
    high = float(tev.make_score(ttopo, 4, STATES, "vpu",
                                mxu_precision="high", device="cpu")(
        tm, ttips))
    assert high == got
    with pytest.raises(EinvalError):
        tev.make_score(ttopo, 4, STATES, mxu_precision="default",
                       device="cpu")
