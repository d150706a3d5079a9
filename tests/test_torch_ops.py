"""The port's plain numeric ops (P-matrices, the level sweep, edge and root
log-likelihoods) against the JAX package on the same numpy inputs.

Tolerances: in float64 both packages run the same algorithm in IEEE
arithmetic and differ only in summation order, so logL and CLVs agree to
rel 1e-12 and scaler counters exactly.  In float32 a value within a few
ulps of the 2**-32 threshold may scale in one package and not the other
(summation order), so counters must agree at >= 99.9% of (node, site)
entries and CLVs at rtol 1e-5 where they agree.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import likelihood as jlk
from libpll_tpu.ops.pmatrix import compute_pmatrices as j_pmat
from libpll_tpu.ops.sweep import make_level_sweep as j_sweep
from libpll_tpu.tree import utree as jut
from libpll_tpu.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                        SCALE_PER_SITE)

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.models.gamma import compute_gamma_cats
from libpll_tpu_torch.models.gtr import eigen_decompose
from libpll_tpu_torch.ops import likelihood as tlk
from libpll_tpu_torch.ops.pmatrix import compute_pmatrices as t_pmat
from libpll_tpu_torch.ops.sweep import make_level_sweep as t_sweep
from libpll_tpu_torch.tree import utree as tut

from test_clv_pallas import _caterpillar_newick, _random_tree_newick

F64_RTOL = 1e-12
F32_RTOL = 1e-5
F32_SCALER_AGREE = 0.999


def make_case(newick, sites, *, seed=0, rate_cats=4, states=4,
              scale_mode=SCALE_PER_SITE, dtype=np.float64, tiny=False,
              pinv=0.0):
    """Matched inputs for both packages, all made with numpy from ``seed``.

    Returns a dict: jtopo/ttopo, model (numpy), clv [nodes, C, S, L] with
    tips filled (one-hot, or one-hot times 10**U(-45, 0) per tip and site
    when ``tiny``, which makes float64 scaling fire in small trees),
    scalers (zeros), states [tips, L]."""
    rng = np.random.default_rng(seed)
    jtopo, branches = jev.topology_from_tree(
        jut.parse_newick_string(newick), sites, scale_mode=scale_mode)
    ttopo, _ = tev.topology_from_tree(
        tut.parse_newick_string(newick), sites, scale_mode=scale_mode)
    tips, n_inner = jtopo.schedule.tips, jtopo.schedule.n_inner
    params = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
    freqs = rng.uniform(0.1, 1.0, states)
    freqs /= freqs.sum()
    w, left, right = eigen_decompose(params, freqs)
    model = {
        "branch_lengths": np.asarray(branches, dtype),
        "rates": np.asarray(compute_gamma_cats(0.7, rate_cats), dtype),
        "prop_invar": np.full((1,), pinv, dtype),
        "params_indices": np.zeros(rate_cats, np.int32),
        "eigenvals": np.asarray(w[None], dtype),
        "left": np.asarray(left[None], dtype),
        "right": np.asarray(right[None], dtype),
        "freqs_pc": np.asarray(np.broadcast_to(freqs, (rate_cats, states)),
                               dtype),
        "prop_invar_pc": np.full((rate_cats,), pinv, dtype),
        "rate_weights": np.full((rate_cats,), 1.0 / rate_cats, dtype),
        "pattern_weights": rng.integers(1, 4, sites).astype(dtype),
        "invariant": np.full((sites,), -1, np.int32),
    }
    st = rng.integers(0, states, (tips, sites))
    clv = np.zeros((tips + n_inner, rate_cats, states, sites), dtype)
    onehot = np.eye(states, dtype=dtype)[st].transpose(0, 2, 1)
    if tiny:
        onehot = onehot * 10.0 ** rng.uniform(-45, 0, (tips, 1, sites))
    clv[:tips] = onehot[:, None]
    sshape = ((n_inner + 1, rate_cats, sites) if scale_mode == SCALE_PER_RATE
              else (n_inner + 1, sites))
    return dict(jtopo=jtopo, ttopo=ttopo, model=model, clv=clv,
                scalers=np.zeros(sshape, np.int32), states=st)


def jax_model(model):
    return {k: jnp.asarray(v) for k, v in model.items()}


def port_pmatrix(case, dtype):
    tm = model_from_numpy(case["model"], "cpu", dtype)
    idx = torch.as_tensor(case["ttopo"].matrix_indices, dtype=torch.long)
    return tev._pmatrices(tm, case["ttopo"], dtype, idx)


def assert_f32_sweep_agrees(got_clv, got_scal, want_clv, want_scal):
    """float32 rule: counters agree at >= 99.9% of entries; inner CLVs
    [n_inner, C, S, L] agree at rtol 1e-5 wherever the node's counters
    agree, relative to the largest entry of the node's site block: per-site
    scaling leaves fast-rate entries free to sink into float32 subnormals,
    where no relative precision is left."""
    got_scal, want_scal = np.asarray(got_scal), np.asarray(want_scal)
    same = got_scal == want_scal
    assert same.mean() >= F32_SCALER_AGREE, same.mean()
    keep = same[:-1]  # inner rows (the last is the dummy)
    keep = (keep[:, None, None, :] if keep.ndim == 2
            else keep[:, :, None, :])
    got, want = np.asarray(got_clv, np.float64), np.asarray(want_clv,
                                                            np.float64)
    span = np.abs(want).max(axis=(1, 2), keepdims=True)
    err = np.abs(got - want) / np.maximum(span, np.finfo(np.float32).tiny)
    assert np.broadcast_to(keep, err.shape).any()
    assert err[np.broadcast_to(keep, err.shape)].max() <= F32_RTOL


def test_pmatrices_f64_with_params_indices():
    """Two rate matrices behind the params_indices indirection, p-inv on
    one of them (the rate rescale), zero-length branch (exact identity)."""
    rng = np.random.default_rng(9)
    evs, lefts, rights = [], [], []
    for _ in range(2):
        freqs = rng.uniform(0.1, 1.0, 4)
        w, left, right = eigen_decompose(rng.uniform(0.5, 2.0, 6),
                                         freqs / freqs.sum())
        evs.append(w), lefts.append(left), rights.append(right)
    args = [rng.uniform(0.0, 1.0, 7), compute_gamma_cats(0.5, 4),
            np.asarray([0.2, 0.0]), np.asarray([0, 1, 1, 0], np.int32),
            np.stack(evs), np.stack(lefts), np.stack(rights)]
    args[0][3] = 0.0
    want = np.asarray(j_pmat(*[jnp.asarray(a) for a in args]))
    got = t_pmat(*[torch.as_tensor(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, rtol=F64_RTOL, atol=1e-15)
    np.testing.assert_array_equal(got[3], np.broadcast_to(np.eye(4),
                                                          (4, 4, 4)))


@pytest.mark.parametrize("scale_mode", [SCALE_NONE, SCALE_PER_SITE,
                                        SCALE_PER_RATE])
def test_level_sweep_f64(scale_mode):
    case = make_case(_random_tree_newick(16, np.random.default_rng(1)), 200,
                     seed=1, scale_mode=scale_mode,
                     tiny=scale_mode != SCALE_NONE)
    jpm = jev._pmatrices(jax_model(case["model"]), case["jtopo"],
                         jnp.float64)
    want_clv, want_scal = j_sweep(case["jtopo"].schedule, scale_mode)(
        jnp.asarray(case["clv"]), jnp.asarray(case["scalers"]), jpm)
    pm = port_pmatrix(case, torch.float64)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jpm), rtol=F64_RTOL,
                               atol=1e-15)
    got_clv, got_scal = t_sweep(case["ttopo"].schedule, scale_mode)(
        torch.from_numpy(case["clv"]), torch.from_numpy(case["scalers"]), pm)
    np.testing.assert_array_equal(got_scal.numpy(), np.asarray(want_scal))
    if scale_mode != SCALE_NONE:
        assert got_scal.numpy()[:-1].sum() > 0  # scaling did fire
    np.testing.assert_allclose(got_clv.numpy(), np.asarray(want_clv),
                               rtol=F64_RTOL, atol=0)


@pytest.mark.parametrize("scale_mode", [SCALE_PER_SITE, SCALE_PER_RATE])
def test_level_sweep_f32_caterpillar(scale_mode):
    """48-taxon caterpillar: many float32 scaling events."""
    case = make_case(_caterpillar_newick(48), 256, seed=2,
                     scale_mode=scale_mode, dtype=np.float32)
    jpm = jev._pmatrices(jax_model(case["model"]), case["jtopo"],
                         jnp.float32)
    want_clv, want_scal = j_sweep(case["jtopo"].schedule, scale_mode)(
        jnp.asarray(case["clv"]), jnp.asarray(case["scalers"]), jpm)
    got_clv, got_scal = t_sweep(case["ttopo"].schedule, scale_mode)(
        torch.from_numpy(case["clv"]), torch.from_numpy(case["scalers"]),
        port_pmatrix(case, torch.float32))
    assert np.asarray(want_scal)[:-1].sum() > 1000
    tips = case["ttopo"].schedule.tips
    assert_f32_sweep_agrees(got_clv[tips:], got_scal, want_clv[tips:],
                            want_scal)


def _lk_inputs(per_rate, asc, pinv, seed):
    """Random positive CLVs/scalers and model vectors for the logL ops;
    the first 8 sites are invariant (state 0..3) when ``pinv``."""
    rng = np.random.default_rng(seed)
    C, S, sites = 4, 4, 64
    L = sites + (S if asc else 0)
    freqs = rng.dirichlet(np.ones(S))
    inv = np.full(L, -1, np.int32)
    if pinv:
        inv[:8] = np.arange(8) % S
    sshape = (C, L) if per_rate else (L,)
    return dict(
        clv_parent=rng.uniform(0.01, 1.0, (C, S, L)),
        clv_child=rng.uniform(0.01, 1.0, (C, S, L)),
        scaler_parent=rng.integers(0, 4, sshape).astype(np.int32),
        scaler_child=rng.integers(0, 3, sshape).astype(np.int32),
        pmatrix=rng.dirichlet(np.ones(S), (C, S)),
        freqs_pc=np.broadcast_to(freqs, (C, S)).copy(),
        rate_weights=np.full(C, 0.25),
        pattern_weights=rng.integers(1, 5, L).astype(np.float64),
        prop_invar=np.full(C, 0.3 if pinv else 0.0),
        invariant=inv), sites


@pytest.mark.parametrize("per_rate,asc,pinv", [
    (False, 0, False), (True, 0, False), (False, 0, True), (True, 0, True),
    (False, 1, False), (False, 2, False), (True, 3, False)])
def test_edge_and_root_loglikelihood_f64(per_rate, asc, pinv):
    """Per-rate min/cap-4 fold, +I mix, Lewis/Felsenstein/Stamatakis."""
    kw, sites = _lk_inputs(per_rate, asc, pinv, seed=3 + asc)
    opts = dict(sites=sites, per_rate=per_rate, asc_mode=asc)
    want, want_ps = jlk.edge_loglikelihood(
        **{k: jnp.asarray(v) for k, v in kw.items()}, **opts)
    got, got_ps = tlk.edge_loglikelihood(
        **{k: torch.as_tensor(v) for k, v in kw.items()}, **opts)
    np.testing.assert_allclose(float(got), float(want), rtol=F64_RTOL)
    np.testing.assert_allclose(got_ps.numpy(), np.asarray(want_ps),
                               rtol=F64_RTOL)

    root = {k: kw[k] for k in ("freqs_pc", "rate_weights", "pattern_weights",
                               "prop_invar", "invariant")}
    want, want_ps = jlk.root_loglikelihood(
        jnp.asarray(kw["clv_parent"]), jnp.asarray(kw["scaler_parent"]),
        **{k: jnp.asarray(v) for k, v in root.items()}, **opts)
    got, got_ps = tlk.root_loglikelihood(
        torch.as_tensor(kw["clv_parent"]),
        torch.as_tensor(kw["scaler_parent"]),
        **{k: torch.as_tensor(v) for k, v in root.items()}, **opts)
    np.testing.assert_allclose(float(got), float(want), rtol=F64_RTOL)
    np.testing.assert_allclose(got_ps.numpy(), np.asarray(want_ps),
                               rtol=F64_RTOL)
