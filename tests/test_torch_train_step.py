"""The training step of the port (``make_train_step``, and
``make_train_step_fused`` with the plain K2 on the CPU) against
libpll_tpu.engine.evaluate's on the same numpy inputs, and the device rule
of every factory.

float64: logL rel 1e-12, t* rel 1e-10 and the same number of Newton
bodies as JAX's ``while_loop`` (the packages differ in summation order
only).  float32, on the flagship builder's tree-simulated tips at 16 × 512:
logL within 2e-6·|logL| + 5e-3 of JAX's float64, and t* within
F32_T_REL = 1e-5 of JAX's float32 fused step (Pallas, ``interpret=True``)
and of the float64 t*: float32 never meets |d1| <= 1e-9, so all 32
bodies run and t* moves within rounding of the optimum (~1e-7 rel here).
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas as cp
from libpll_tpu.ops import derivatives as jd
from libpll_tpu.ops.sweep import make_level_sweep as j_sweep
from libpll_tpu.utils.constants import SCALE_PER_RATE, SCALE_PER_SITE

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import KernelError
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.ops import derivatives as dv
from libpll_tpu_torch.utils.flagship import build_flagship

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_torch_derivatives import F32_T_REL, T_RTOL, jax_newton
from test_torch_evaluate import _asc_extend
from test_torch_fused import assert_in_budget, iupac_case, port_tips
from test_torch_ops import jax_model, make_case

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from __graft_entry__ import _build_flagship  # noqa: E402

F64_RTOL = 1e-12


def jax_count(jtopo, model, clv, scalers, zero_site_scalers=False):
    """JAX's t* and number of Newton bodies for this step: its level
    sweep, sumtable and while_loop (evaluate.py:684-725); the fused step
    passes zero site scalers (``zero_site_scalers``)."""
    jm = jax_model(model)
    dtype = clv.dtype
    clv, scal = j_sweep(jtopo.schedule, jtopo.scale_mode)(
        jnp.asarray(clv), jnp.asarray(scalers),
        jev._pmatrices(jm, jtopo, dtype))
    per_rate = jtopo.scale_mode == SCALE_PER_RATE
    sp, sc = (scal[jtopo.scaler_row(r)] for r in (jtopo.parent_clv,
                                                  jtopo.child_clv))
    pidx = model["params_indices"]
    st = jd.update_sumtable(
        clv[jtopo.parent_clv], clv[jtopo.child_clv], sp, sc,
        jm["freqs_pc"], jm["left"][pidx], jm["right"][pidx],
        per_rate=per_rate)
    zeros = np.zeros(clv.shape[-1], np.int32)
    site = ((zeros, zeros) if per_rate or zero_site_scalers
            else (np.asarray(sp), np.asarray(sc)))
    ec = dict(sites=jtopo.sites, asc=jtopo.asc_mode,
              t0=model["branch_lengths"][-1], derivs=dict(
                  rates=model["rates"], prop_invar=model["prop_invar_pc"],
                  eigenvals_pc=model["eigenvals"][pidx],
                  freqs_pc=model["freqs_pc"],
                  rate_weights=model["rate_weights"],
                  invariant=model["invariant"],
                  pattern_weights=model["pattern_weights"],
                  scaler_parent=site[0], scaler_child=site[1]))
    return jax_newton(ec, np.asarray(st), dtype)


@pytest.mark.parametrize("scale_mode,asc_mode", [
    (SCALE_PER_SITE, 0), (SCALE_PER_RATE, 0), (SCALE_PER_SITE, 1),
    (SCALE_PER_SITE, 2), (SCALE_PER_RATE, 3)])
def test_make_train_step_f64(scale_mode, asc_mode):
    """make_train_step: logL, t*, the bodies run, and the swept CLVs and
    scalers it returns, against JAX's make_train_step."""
    case = make_case(_random_tree_newick(12, np.random.default_rng(17)), 200,
                     seed=17, scale_mode=scale_mode, tiny=True,
                     pinv=0.0 if asc_mode else 0.15)
    case["model"]["invariant"][:20] = np.arange(20) % 4
    clv, model, scalers = case["clv"], case["model"], case["scalers"]
    if asc_mode:
        clv, model, scalers = _asc_extend(case, np.asarray([3., 1., 2., 4.]))
    jtopo = case["jtopo"]._replace(asc_mode=asc_mode)
    ttopo = case["ttopo"]._replace(asc_mode=asc_mode)
    want = jev.make_train_step(jtopo)(jax_model(model), jnp.asarray(clv),
                                      jnp.asarray(scalers))
    t_jax, bodies = jax_count(jtopo, model, clv, scalers)
    assert t_jax == float(want[1])

    step = tev.make_train_step(ttopo, device="cpu")
    tm = model_from_numpy(model, "cpu", torch.float64)
    args = (tm, torch.from_numpy(clv), torch.from_numpy(scalers))
    logl, t_star, clv_out, scal_out = step(*args)
    assert t_star.dtype == torch.float64 and t_star.dim() == 0
    np.testing.assert_allclose(float(logl), float(want[0]), rtol=F64_RTOL)
    np.testing.assert_allclose(float(t_star), t_jax, rtol=T_RTOL)
    newton = dv.newton_solve(**step.newton_inputs(*args)[3])
    assert int(newton.iterations) == bodies
    assert float(newton.t) == float(t_star)
    np.testing.assert_array_equal(scal_out.numpy(), np.asarray(want[3]))
    np.testing.assert_allclose(clv_out.numpy(), np.asarray(want[2]),
                               rtol=F64_RTOL, atol=0)


def _asc_masks(masks, states, asc_mode):
    """The tips' masks with the S single-state pseudo columns appended."""
    if not asc_mode:
        return masks
    codes = np.uint32(1) << np.arange(states, dtype=np.uint32)
    pseudo = np.broadcast_to(codes, (masks.shape[0], states))
    return np.concatenate([masks, pseudo], axis=1)


@pytest.mark.parametrize("tip_encoding,scale_mode,asc_mode", [
    ("clv", SCALE_PER_SITE, 0), ("chars", SCALE_PER_SITE, 0),
    ("masks", SCALE_PER_SITE, 0), ("chars", SCALE_PER_RATE, 0),
    ("chars", SCALE_PER_SITE, 1)])
def test_make_train_step_fused_f64(tip_encoding, scale_mode, asc_mode):
    """make_train_step_fused (plain K2 on the CPU) in float64 against JAX's
    XLA make_train_step on the same tips: logL, t*, the bodies run (the
    fused step's zero site scalers, as JAX's fused step passes them); its
    logL is make_forward_fused's, bit for bit."""
    case, masks = iupac_case(_caterpillar_newick(16), 200, seed=19,
                             scale_mode=scale_mode, dtype=np.float64)
    model, clv, scalers = case["model"], case["clv"], case["scalers"]
    model["prop_invar"][:] = model["prop_invar_pc"][:] = (
        0.0 if asc_mode else 0.2)
    model["invariant"][:25] = np.arange(25) % 4
    if asc_mode:
        clv, model, scalers = _asc_extend(case, np.asarray([2., 1., 1., 3.]))
        case = dict(case, clv=clv)
    masks = _asc_masks(masks, 4, asc_mode)
    jtopo = case["jtopo"]._replace(asc_mode=asc_mode)
    ttopo = case["ttopo"]._replace(asc_mode=asc_mode)
    want = jev.make_train_step(jtopo)(jax_model(model), jnp.asarray(clv),
                                      jnp.asarray(scalers))
    t_jax, bodies = jax_count(jtopo, model, clv, scalers,
                              zero_site_scalers=True)
    assert t_jax == float(want[1])  # no site scaler on the pseudo columns

    step = tev.make_train_step_fused(ttopo, 4, 4, tip_encoding=tip_encoding,
                                     device="cpu")
    tm = model_from_numpy(model, "cpu", torch.float64)
    tips = port_tips(case, masks, tip_encoding)
    logl, t_star = step(tm, tips)
    np.testing.assert_allclose(float(logl), float(want[0]), rtol=F64_RTOL)
    np.testing.assert_allclose(float(t_star), t_jax, rtol=T_RTOL)
    assert int(dv.newton_solve(
        **step.newton_inputs(tm, tips)[1]).iterations) == bodies
    fwd = tev.make_forward_fused(ttopo, 4, 4, tip_encoding=tip_encoding,
                                 device="cpu")
    assert float(fwd(tm, tips)[0]) == float(logl)


def test_make_train_step_fused_f32_simulated():
    """The flagship's builder at 16 × 512 with tips simulated on the tree
    (an interior optimum): the float32 fused step against JAX's float32
    fused step and JAX's float64 step; the port's simulated masks are the
    JAX builder's tips."""
    jtopo, jmodel, jclv, jscal = _build_flagship(16, 512, simulate=True)
    topo, model_np, masks, _ = build_flagship(16, 512, simulate=True,
                                              tip_masks=True)
    tips = jtopo.schedule.tips
    codes = (np.asarray(jclv[:tips, 0]) * np.asarray([1, 2, 4, 8])[:, None]
             ).sum(axis=1)
    np.testing.assert_array_equal(codes, masks)

    want32 = jev.make_train_step_fused(jtopo, 4, 4, impl="vpu",
                                       interpret=True)(
        jmodel, cp.pack_tips(jclv[:tips], "vpu"))
    m64 = {k: (v.astype(jnp.float64) if v.dtype == jnp.float32 else v)
           for k, v in jmodel.items()}
    want64 = jev.make_train_step(jtopo)(m64, jclv.astype(jnp.float64), jscal)
    t32, t64 = float(want32[1]), float(want64[1])

    m32 = model_from_numpy(model_np, "cpu", torch.float32)
    step = tev.make_train_step_fused(topo, 4, 4, tip_encoding="chars",
                                     device="cpu")
    tp = cf.pack_tipchars(masks)
    logl, t_star = step(m32, tp)
    assert t_star.dtype == torch.float32
    assert 1e-8 < float(t_star) < 100.0
    assert_in_budget(float(logl), float(want64[0]), float(want32[0]))
    assert abs(float(t_star) - t32) <= F32_T_REL * t32
    assert abs(float(t_star) - t64) <= F32_T_REL * t64
    assert int(dv.newton_solve(
        **step.newton_inputs(m32, tp)[1]).iterations) == dv.NEWTON_ITERS
    fwd = tev.make_forward_fused(topo, 4, 4, tip_encoding="chars",
                                 device="cpu")
    assert float(fwd(m32, tp)[0]) == float(logl)


def test_train_step_finds_the_interior_optimum():
    """float64 make_train_step on tree-simulated tips: t* inside the clamp,
    converged (|d1| <= 1e-9 before 32 bodies), and the edge at t* scores
    at least as well as at t0 and as at t* ± 1%."""
    topo, model_np, clv, scalers = build_flagship(16, 512, simulate=True,
                                                  dtype=np.float64)
    tm = model_from_numpy(model_np, "cpu", torch.float64)
    step = tev.make_train_step(topo, device="cpu")
    args = (tm, torch.from_numpy(clv), torch.from_numpy(scalers))
    logl, t_star, _, _ = step(*args)
    newton = dv.newton_solve(**step.newton_inputs(*args)[3])
    assert 1e-8 < float(t_star) < 100.0
    assert int(newton.iterations) < dv.NEWTON_ITERS
    assert abs(float(newton.d1)) <= dv.NEWTON_TOL
    fwd = tev.make_forward(topo, device="cpu")

    def score(t):
        m = dict(tm, branch_lengths=tm["branch_lengths"].clone())
        m["branch_lengths"][-1] = t
        return float(fwd(m, *args[1:])[0])
    best = score(t_star)
    assert best >= float(logl)
    assert best >= max(score(t_star * 0.99), score(t_star * 1.01))


def test_factories_default_to_the_card(monkeypatch):
    """device=None builds on the card, and without one raises (no CPU
    fallback); device="cpu" puts every buffer, ScoreUnbounded's tips
    included, on the CPU."""
    case, masks = iupac_case(
        _random_tree_newick(8, np.random.default_rng(23)), 64, seed=23)
    topo = case["ttopo"]
    factories = {
        "make_forward": lambda **kw: tev.make_forward(topo, **kw),
        "make_forward_fused": lambda **kw: tev.make_forward_fused(
            topo, 4, 4, **kw),
        "make_asc_tail": lambda **kw: tev.make_asc_tail(topo, 4, 4, **kw),
        "make_score": lambda **kw: tev.make_score(topo, 4, 4, **kw),
        "make_score_unbounded": lambda **kw: tev.make_score_unbounded(
            topo, 4, 4, masks, **kw),
        "make_train_step": lambda **kw: tev.make_train_step(topo, **kw),
        "make_train_step_fused": lambda **kw: tev.make_train_step_fused(
            topo, 4, 4, **kw)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name, build in factories.items():
        for device in ({}, {"device": None}, {"device": "cuda"}):
            with pytest.raises(KernelError):
                build(**device)
        module = build(device="cpu")
        assert module.device == torch.device("cpu"), name
        buffers = list(module.buffers())
        assert buffers and all(b.device.type == "cpu" for b in buffers), name
    assert tev.make_score_unbounded(topo, 4, 4, masks,
                                    device="cpu").tips.device.type == "cpu"
