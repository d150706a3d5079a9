"""The port's branch-length derivatives (``ops/derivatives.py``) against
libpll_tpu.ops.derivatives on the same numpy inputs, and the plain twin of
the Newton kernel N1 against JAX's ``while_loop``.

Tolerances.  float64: both packages run the same algorithm in IEEE
arithmetic and differ only in summation order, so the sumtable agrees to
rtol 1e-12 of each (C, S) row's largest entry (its entries are sums of
terms of both signs, and one may cancel to near zero), d1 and d2 to 1e-12
of the sum of |w·term| over the sites they add up, t* to rel 1e-10 with the
same number of iterations.  float32: the same loop in float32 sums 512
terms in another order; near the optimum d1 is rounding noise, and a body
moves t by that noise over d2, far less than F32_T_REL = 1e-5 of t*.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import derivatives as jd
from libpll_tpu.ops.sweep import make_level_sweep as j_sweep
from libpll_tpu.utils.constants import SCALE_PER_RATE, SCALE_PER_SITE

from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import derivatives as dv

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_torch_evaluate import _asc_extend
from test_torch_ops import jax_model, make_case

F64_RTOL = 1e-12
T_RTOL = 1e-10
F32_T_REL = 1e-5
BRANCHES = (0.003, 0.05, 0.2, 0.9, 4.0)
VARIANTS = ("site", "rate", "pinv", "lewis", "felsenstein", "stamatakis")
ASC = {"lewis": 1, "felsenstein": 2, "stamatakis": 3}


def edge_case(variant, states, seed, dtype=np.float64, sites=160):
    """(case, sweep inputs) for one variant: the JAX level sweep's edge
    rows, their scalers and the model, as numpy.  ``site`` and ``rate``
    scale in float64 (tiny tips); ``pinv`` has p-inv 0.2 and invariant
    sites; the asc modes carry the S pseudo columns, with per-site scalers
    0/1 drawn on them so the pseudo-site factors are exercised."""
    rng = np.random.default_rng(seed)
    scale = SCALE_PER_RATE if variant == "rate" else SCALE_PER_SITE
    tiny = variant in ("site", "rate") and dtype == np.float64
    case = make_case(_random_tree_newick(10, rng), sites, seed=seed,
                     states=states, scale_mode=scale, dtype=dtype, tiny=tiny,
                     pinv=0.2 if variant == "pinv" else 0.0)
    model = case["model"]
    if variant == "pinv":
        model["invariant"][:30] = np.arange(30) % states
    clv, scalers = case["clv"], case["scalers"]
    asc = ASC.get(variant, 0)
    if asc:
        clv, model, scalers = _asc_extend(
            case, rng.uniform(1.0, 4.0, states))
    jt = case["jtopo"]._replace(asc_mode=asc)
    jm = jax_model(model)
    clv, scalers = j_sweep(jt.schedule, jt.scale_mode)(
        jnp.asarray(clv), jnp.asarray(scalers),
        jev._pmatrices(jm, jt, clv.dtype))
    clv, scalers = np.asarray(clv), np.asarray(scalers)
    sp, sc = (scalers[jt.scaler_row(r)] for r in (jt.parent_clv,
                                                  jt.child_clv))
    if asc and scale == SCALE_PER_SITE:
        sp, sc = sp.copy(), sc.copy()
        sp[sites:] = rng.integers(0, 2, states)
    pidx = model["params_indices"]
    inputs = dict(
        clv_parent=clv[jt.parent_clv], clv_child=clv[jt.child_clv],
        scaler_parent=sp, scaler_child=sc, freqs_pc=model["freqs_pc"],
        left_pc=model["left"][pidx], right_pc=model["right"][pidx],
        per_rate=scale == SCALE_PER_RATE)
    derivs = dict(
        rates=model["rates"], prop_invar=model["prop_invar_pc"],
        eigenvals_pc=model["eigenvals"][pidx], freqs_pc=model["freqs_pc"],
        rate_weights=model["rate_weights"], invariant=model["invariant"],
        pattern_weights=model["pattern_weights"],
        scaler_parent=sp if scale == SCALE_PER_SITE else np.zeros_like(
            model["invariant"]),
        scaler_child=sc if scale == SCALE_PER_SITE else np.zeros_like(
            model["invariant"]))
    return dict(inputs=inputs, derivs=derivs, sites=sites, asc=asc,
                t0=model["branch_lengths"][-1])


def jax_sumtable(ec):
    return np.asarray(jd.update_sumtable(
        *(jnp.asarray(ec["inputs"][k]) for k in (
            "clv_parent", "clv_child", "scaler_parent", "scaler_child",
            "freqs_pc", "left_pc", "right_pc")),
        per_rate=ec["inputs"]["per_rate"]))


def torch_args(ec, st):
    d = {k: torch.from_numpy(np.array(v, order="C"))
         for k, v in ec["derivs"].items()}
    return dict(sumtable=torch.from_numpy(np.array(st)), **d)


def jax_args(ec, st):
    return dict(sumtable=jnp.asarray(st),
                **{k: jnp.asarray(v) for k, v in ec["derivs"].items()})


def abs_sums(ec, st, t):
    """Σ|w·(−L'/L)| and Σ|w·((L'/L)² − L''/L)| over the sites d1 and d2
    add up: the size of those sums, against which their round-off is
    measured."""
    m, states = ec["derivs"], st.shape[1]
    ki = m["rates"] / (1.0 - m["prop_invar"])
    lam = m["eigenvals_pc"] * ki[:, None]
    e = np.exp(lam * t)
    cat = np.einsum("cjn,dcj->dcn", st, np.stack([e, lam * e, lam * lam * e]))
    ef = ec["sites"] + (states if ec["asc"] == 3 else 0)
    p = m["prop_invar"][:, None]
    inv = m["invariant"][:ef]
    inv_lk = np.where(inv >= 0, m["freqs_pc"][:, np.maximum(inv, 0)] * p, 0)
    c = cat[:, :, :ef]
    c0 = np.where(p > 0, c[0] * (1 - p) + inv_lk, c[0])
    c12 = np.where(p > 0, c[1:] * (1 - p), c[1:])
    lk = np.einsum("c,dcn->dn", m["rate_weights"],
                   np.concatenate([c0[None], c12]))
    d1 = -lk[1] / lk[0]
    w = m["pattern_weights"][:ef]
    return np.abs(w * d1).sum(), np.abs(w * (d1 * d1 - lk[2] / lk[0])).sum()


def jax_newton(ec, st, dtype):
    """JAX's Newton loop (evaluate.py:638-659) on the sumtable, with its
    iteration count: (t*, iterations)."""
    a = jax_args(ec, st)
    sp, sc = a.pop("scaler_parent"), a.pop("scaler_child")
    s = a.pop("sumtable")

    def cond(carry):
        _, d1, it = carry
        return (jnp.abs(d1) > 1e-9) & (it < 32)

    def body(carry):
        t, _, it = carry
        d1, d2 = jd.likelihood_derivatives(
            s, t, a["rates"], a["prop_invar"], a["eigenvals_pc"],
            a["freqs_pc"], a["rate_weights"], a["invariant"],
            a["pattern_weights"], sp, sc, sites=ec["sites"],
            asc_mode=ec["asc"])
        step = jnp.where(d2 != 0.0, d1 / d2, d1)
        return (jnp.clip(t - step, 1e-8, 100.0), d1, it + 1)

    t, _, it = jax.lax.while_loop(
        cond, body, (jnp.asarray(ec["t0"], dtype),
                     jnp.asarray(jnp.inf, dtype), 0))
    return float(t), int(it)


@pytest.mark.parametrize("variant", ["site", "rate", "pinv", "lewis"])
@pytest.mark.parametrize("states", [4, 20])
def test_update_sumtable_f64(variant, states):
    ec = edge_case(variant, states, seed=states + len(variant))
    want = jax_sumtable(ec)
    got = dv.update_sumtable(
        *(torch.from_numpy(np.array(ec["inputs"][k])) for k in (
            "clv_parent", "clv_child", "scaler_parent", "scaler_child",
            "freqs_pc", "left_pc", "right_pc")),
        per_rate=ec["inputs"]["per_rate"]).numpy()
    assert got.shape == want.shape and got.dtype == np.float64
    span = np.abs(want).max(axis=2, keepdims=True)
    assert np.all(np.abs(got - want) <= F64_RTOL * span)
    if variant == "rate":  # the fold moved some columns
        assert ec["inputs"]["scaler_parent"].any()


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("states", [4, 20])
def test_likelihood_derivatives_f64(variant, states):
    """d1 and d2 at five branch lengths, on JAX's sumtable."""
    ec = edge_case(variant, states, seed=3 * states + len(variant))
    st = jax_sumtable(ec)
    for t in BRANCHES:
        want = jd.likelihood_derivatives(
            **jax_args(ec, st), branch_length=jnp.asarray(t),
            sites=ec["sites"], asc_mode=ec["asc"])
        got = dv.likelihood_derivatives(
            **torch_args(ec, st), sites=ec["sites"], asc_mode=ec["asc"],
            branch_length=torch.tensor(t, dtype=torch.float64))
        for g, w, size in zip(got, want, abs_sums(ec, st, t)):
            assert g.dtype == torch.float64 and g.dim() == 0
            assert np.isfinite(float(w))
            assert abs(float(g) - float(w)) <= F64_RTOL * (size + abs(
                float(w))), (variant, t, float(g), float(w))


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("states", [4, 20])
def test_newton_solve_plain_f64(variant, states):
    """The plain twin of N1 against JAX's while_loop: t* rel 1e-10, the
    same number of bodies; the CPU wrapper takes the twin."""
    ec = edge_case(variant, states, seed=5 * states + len(variant))
    st = jax_sumtable(ec)
    want_t, want_it = jax_newton(ec, st, jnp.float64)
    args = torch_args(ec, st)
    t0 = torch.tensor([ec["t0"]], dtype=torch.float64)
    got = dv.newton_solve_plain(**args, t0=t0, sites=ec["sites"],
                                asc_mode=ec["asc"])
    assert abs(float(got.t) - want_t) <= T_RTOL * abs(want_t)
    assert int(got.iterations) == want_it
    assert 1e-8 <= want_t <= 100.0
    launches = dv.newton_solve.launches
    wrapped = dv.newton_solve(**args, t0=t0, sites=ec["sites"],
                              asc_mode=ec["asc"])
    assert dv.newton_solve.launches == launches  # no kernel on the CPU
    assert float(wrapped.t) == float(got.t)
    assert int(wrapped.iterations) == int(got.iterations)


@pytest.mark.parametrize("variant", ["site", "pinv", "lewis", "stamatakis"])
def test_newton_solve_plain_f32(variant):
    """float32: t* within F32_T_REL of JAX's float32 loop and of the
    float64 t*; all 32 bodies run (d1 never reaches 1e-9 in float32)."""
    ec = edge_case(variant, 4, seed=11 + len(variant), dtype=np.float32,
                   sites=512)
    st = jax_sumtable(ec)
    want_t, _ = jax_newton(ec, st, jnp.float32)
    args = torch_args(ec, st)
    got = dv.newton_solve_plain(
        **args, t0=torch.tensor([ec["t0"]]), sites=ec["sites"],
        asc_mode=ec["asc"])
    assert got.t.dtype == torch.float32
    assert abs(float(got.t) - want_t) <= F32_T_REL * abs(want_t)
    ec64 = dict(ec, derivs={k: (v.astype(np.float64) if v.dtype == np.float32
                                else v) for k, v in ec["derivs"].items()})
    t64, _ = jax_newton(ec64, st.astype(np.float64), jnp.float64)
    assert abs(float(got.t) - t64) <= F32_T_REL * abs(t64)


def test_newton_solve_max_iters_and_guards():
    """One body gives d1/d2 at t0 (likelihood_derivatives'); the wrapper
    refuses what N1 does not take before reaching for a card."""
    ec = edge_case("site", 4, seed=21)
    st = jax_sumtable(ec)
    args = torch_args(ec, st)
    t0 = torch.tensor([ec["t0"]], dtype=torch.float64)
    one = dv.newton_solve(**args, t0=t0, sites=ec["sites"], max_iters=1)
    d1, d2 = dv.likelihood_derivatives(
        **args, branch_length=t0[0], sites=ec["sites"])
    assert (float(one.d1), float(one.d2)) == (float(d1), float(d2))
    assert int(one.iterations) == 1
    assert float(one.t) == float(torch.clamp(
        t0[0] - d1 / d2, dv.MIN_T, dv.MAX_T))
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in args.items()}
    meta["t0"] = t0.to("meta")
    for zeros in (False, True):  # all else passes; None: zero scalers
        if zeros:
            meta["scaler_parent"] = meta["scaler_child"] = None
        with pytest.raises(EinvalError, match="not CUDA"):
            dv.newton_solve(**meta, sites=ec["sites"])
    for bad, what in (
            ({"sumtable": meta["sumtable"][:, :1].contiguous()}, "states 1"),
            ({"rates": meta["rates"].float()}, "rates"),
            ({"invariant": meta["invariant"].long()}, "invariant"),
            ({"t0": t0}, "t0 on cpu"),
            ({"sites": ec["sites"] - 1, "asc_mode": 1}, "columns")):
        with pytest.raises(EinvalError, match=what):
            dv.newton_solve(**{**meta, "sites": ec["sites"], **bad})


# N1's launch planner (plan_newton) with a fake card: H100-like (132 SMs,
# 227 KB of shared memory a block less the kernel's static share), and
# smaller ones; no card needed
H100_SMS, H100_SMEM = 132, 232448 - 8192


def covered_once(plan, ef):
    """Every evaluated site in exactly one block's slice, no empty block,
    one block an SM at most."""
    bounds = [(b * plan.block_sites, min((b + 1) * plan.block_sites, ef))
              for b in range(plan.grid)]
    assert all(lo < hi for lo, hi in bounds)
    assert bounds[0][0] == 0 and bounds[-1][1] == ef
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("shape, itemsize, resident", [
    ((4, 4, 262144), 4, True),     # the DNA flagship, float32
    ((4, 20, 65132), 4, True),     # the protein configuration, float32
    ((4, 4, 262144), 8, False),    # the float64 flagship
    ((4, 20, 65132), 8, False),    # protein, float64
])
def test_plan_newton_flagship_shapes(shape, itemsize, resident):
    """Resident where the slices fit one block an SM, streamed where they
    do not; the slices cover every site once and fit shared memory."""
    plan = dv.plan_newton(shape, itemsize, shape[2], 0, H100_SMS,
                          H100_SMEM)
    assert plan.resident == resident
    assert plan.threads == dv.THREADS
    assert plan.grid <= H100_SMS
    covered_once(plan, shape[2])
    if resident:
        assert plan.smem == dv.slice_bytes(shape[0], shape[1], itemsize,
                                           plan.block_sites) <= H100_SMEM
    else:
        assert plan.smem == 0 and plan.grid == min(
            H100_SMS, -(-shape[2] // dv.THREADS))


@pytest.mark.parametrize("states", [4, 20])
@pytest.mark.parametrize("rate_cats", [1, 4, 8])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_plan_newton_small_cases_resident(states, rate_cats, itemsize):
    """chip_smoke's phase 15 (300 sites; the asc modes' S pseudo
    columns, Stamatakis evaluating them): every case resident, on as few
    blocks as shared memory allows, at least THREADS sites a block where
    that fits."""
    for asc in (0, 1, 2, 3):
        length = 300 + (states if asc else 0)
        ef = 300 + (states if asc == 3 else 0)
        plan = dv.plan_newton((rate_cats, states, length), itemsize, 300,
                              asc, H100_SMS, H100_SMEM)
        assert plan.resident and 0 < plan.smem <= H100_SMEM
        covered_once(plan, ef)
        per_site = dv.slice_bytes(rate_cats, states, itemsize, 4) // 4
        assert plan.grid == max(1, -(-ef // (H100_SMEM // per_site // 4
                                             * 4)))


@pytest.mark.parametrize("sms", [1, 3, 8, 132])
@pytest.mark.parametrize("smem_limit", [48 * 1024 - 4096, 100_000,
                                        H100_SMEM])
def test_plan_newton_fake_cards(sms, smem_limit):
    """On cards of 1-132 SMs and 44-219 KB a block, over random shapes:
    grid <= SMs x one block an SM, every site in exactly one slice, a
    resident slice within the limit, streamed only where no grid of at
    most ``sms`` blocks fits, and the same plan for the same sizes."""
    rng = np.random.default_rng(sms * 7 + smem_limit % 97)
    for _ in range(40):
        c = int(rng.choice([1, 2, 4, 8]))
        s = int(rng.choice([4, 20]))
        sites = int(rng.integers(1, 400_000))
        asc = int(rng.integers(0, 4))
        item = int(rng.choice([4, 8]))
        length = sites + (s if asc else 0)
        ef = sites + (s if asc == 3 else 0)
        plan = dv.plan_newton((c, s, length), item, sites, asc, sms,
                              smem_limit)
        assert 1 <= plan.grid <= sms
        covered_once(plan, ef)
        per_site = dv.slice_bytes(c, s, item, 4) // 4
        fit = smem_limit // per_site // 4 * 4
        if plan.resident:
            assert plan.smem == dv.slice_bytes(c, s, item, plan.block_sites)
            assert plan.smem <= smem_limit
        else:
            assert plan.smem == 0 and (fit == 0 or -(-ef // fit) > sms)
            assert plan.grid == min(sms, -(-ef // dv.THREADS))
        assert dv.plan_newton((c, s, length), item, sites, asc, sms,
                              smem_limit) == plan


def test_eval_edge_branch_is_last():
    """t0 = branch_lengths[-1] (evaluate.py:634): create_operations lists
    the evaluation edge (the root's) last, its P-matrix index the edge
    matrix, in the port's utree as in JAX's."""
    from libpll_tpu.tree import utree as jut

    from libpll_tpu_torch.engine import evaluate as tev
    from libpll_tpu_torch.tree import utree as tut

    rng = np.random.default_rng(4)
    for newick in (_random_tree_newick(9, rng), _caterpillar_newick(12),
                   "((A:0.1,B:0.2):0.3,(C:0.4,D:0.5):0.6,E:0.7);"):
        tree = tut.parse_newick_string(newick)
        topo, branches = tev.topology_from_tree(tree, 10)
        assert int(topo.matrix_indices[-1]) == topo.edge_matrix
        assert branches[-1] == tree.root.length
        _, jbranches = jev.topology_from_tree(jut.parse_newick_string(newick),
                                              10)
        np.testing.assert_array_equal(branches, np.asarray(jbranches))
