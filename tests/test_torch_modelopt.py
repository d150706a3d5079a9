"""The port's model fitting (``engine/modelopt.py``, ``engine/lbfgs.py``,
``models/gtr.eigen_decompose_torch``) against libpll_tpu's on the CPU.

Both sides get the same data: ``tests/test_modelopt.py``'s simulations
(GTR on a random tree, Γ or invariant-site rates; LG4X protein for the
mixture), the same Newick parsed by each package's utree and the same
setters on each package's Partition (the port's with ``device="cpu"``).
The L-BFGS is held to optax's ``lbfgs()``, the optimizer JAX's fit runs.

Tolerances (float64 throughout; the packages differ in summation order
and in their LAPACK ``eigh``, ~1e-15 an entry):

  * eigendecomposition: eigenvalues rel 1e-12, P-matrices abs 1e-12;
  * ``make_param_score``: logL rel 1e-12, each gradient rel 1e-8 of its
    largest entry (against ``jax.value_and_grad``), and finite
    differences as ``tests/test_modelopt.py`` takes them;
  * L-BFGS on fixed functions: the first 10 iterates and every evaluation
    point of the line search before them rel 1e-10;
  * ``optimize_model``: the first 5 L-BFGS iterates rel 1e-8, every
    trajectory entry and the final logL rel 1e-9, the fitted
    exchangeabilities, frequencies, rates and weights 1e-4 absolute, alpha
    and p-inv rel 1e-3 (round-off compounds through the zoom's branches
    over up to 80 steps; the first iterates are held tightly, the result
    loosely);
  * Brent and the flat-start jitter: exact (the same host arithmetic).

JAX's fits are computed once per case and shared by the tests.
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

import libpll_tpu as jpll
from libpll_tpu.engine import modelopt as jmo
from libpll_tpu.models.aa_tables import AA_MIXTURE_MODELS
from libpll_tpu.models.gamma import compute_gamma_cats
from libpll_tpu.models.gtr import eigen_decompose_jax
from libpll_tpu.tree import utree as jut

import libpll_tpu_torch as tpll
from libpll_tpu_torch.engine import lbfgs
from libpll_tpu_torch.engine import modelopt as tmo
from libpll_tpu_torch.errors import InvarError, ParamError
from libpll_tpu_torch.models.gtr import eigen_decompose_torch
from libpll_tpu_torch.tree import utree as tut

from test_modelopt import (TRUE_FREQS, TRUE_PARAMS, _random_tree,
                           _simulate, _simulate_lg4x)

LOGL_REL, GRAD_REL = 1e-12, 1e-8
ITER_REL, FIT_REL, PARAM_ABS, ALPHA_REL = 1e-8, 1e-9, 1e-4, 1e-3
LBFGS_REL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs (restored after it):
    the plain sweep issues many tiny tensor operations."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


# ---------------------------------------------------------------------------
# data: the same Partition in both packages
# ---------------------------------------------------------------------------
def pair(newick, seqs, sites, cats=1, *, states=4, matrices=1, model=None,
         rates=None, weights=None, scaling="site", asc=False):
    """(jtree, jpart), (ttree, tpart): ``model`` is [(subst, freqs)] a
    matrix (default JC), ``rates``/``weights`` the categories'."""
    out = []
    for pkg, ut, kw in ((jpll, jut, {}), (tpll, tut, dict(device="cpu"))):
        tree = ut.parse_newick_string(newick)
        tips = tree.tip_count
        part = pkg.Partition(tips, tips - 2, states, sites, matrices,
                             2 * tips - 3, cats, tips - 2, scaling=scaling,
                             asc_bias_alloc=asc, **kw)
        cmap = pkg.maps.pll_map_nt if states == 4 else pkg.maps.pll_map_aa
        order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
        for lab, s in seqs.items():
            part.set_tip_states(order[lab], cmap, s)
        for k, (subst, freqs) in enumerate(model or ()):
            part.set_subst_params(k, subst)
            part.set_frequencies(k, freqs)
        if rates is not None:
            part.set_category_rates(rates)
        if weights is not None:
            part.set_category_weights(weights)
        out.append((tree, part))
    return out


def lg4x_model():
    rates4, freqs4 = AA_MIXTURE_MODELS["lg4x"]
    return [(np.asarray(rates4[k], np.float64),
             np.asarray(freqs4[k], np.float64)) for k in range(4)]


@functools.lru_cache(maxsize=None)
def dna(seed, tips, sites, alpha=None, invariant=0.0):
    """``test_modelopt``'s simulation: Γ(alpha) site rates when given, a
    share ``invariant`` of sites held still."""
    rng = np.random.default_rng(seed)
    newick = _random_tree(tips, rng)
    site_rates = np.ones(sites)
    if alpha is not None:
        site_rates = compute_gamma_cats(alpha, 4)[rng.integers(0, 4, sites)]
    if invariant:
        site_rates = site_rates * (rng.random(sites) > invariant)
    return newick, _simulate(newick, sites, rng, site_rates=site_rates)


@functools.lru_cache(maxsize=None)
def lg4x_data(seed, tips, sites):
    rng = np.random.default_rng(seed)
    newick = _random_tree(tips, rng)
    w = np.asarray([0.45, 0.30, 0.15, 0.10])
    r = np.asarray([0.3, 0.9, 1.6, 2.5])
    return newick, _simulate_lg4x(newick, sites, rng, w, r / (w * r).sum())


def step_by_step_logl(tree, part, pidx):
    """The root edge's logL through the Partition's own calls."""
    ut = jut if isinstance(part, jpll.Partition) else tut
    ops, blens, midx = ut.create_operations(ut.traverse(tree.root))
    part.update_prob_matrices(pidx, midx, blens)
    part.update_partials(ops)
    r = tree.root
    return part.compute_edge_loglikelihood(
        r.clv_index, r.scaler_index, r.back.clv_index, r.back.scaler_index,
        r.pmatrix_index, pidx)


# ---------------------------------------------------------------------------
# eigen_decompose_torch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("matrices", [1, 4])
def test_eigen_decompose_matches_jax(matrices):
    """Batched over R rate matrices (GTR at R = 1, LG4X's 20-state
    matrices at R = 4): eigenvalues and P-matrices equal JAX's vmapped
    ``eigen_decompose_jax``; the unnormalised rates (last != 1) are
    normalised the same way."""
    if matrices == 1:
        model = [(TRUE_PARAMS * 1.7, TRUE_FREQS)]
    else:
        model = lg4x_model()
    subst = np.stack([m[0] for m in model])
    freqs = np.stack([m[1] for m in model])
    jw, jl, jr = jax.vmap(eigen_decompose_jax)(jnp.asarray(subst),
                                               jnp.asarray(freqs))
    tw, tl, tr = eigen_decompose_torch(torch.as_tensor(subst),
                                       torch.as_tensor(freqs))
    assert tw.shape == jw.shape and tl.shape == jl.shape == tr.shape
    assert rel_err(tw.numpy(), jw) <= 1e-12
    for t in (0.05, 0.5, 2.0):
        jp = np.einsum("rij,rj,rjk->rik", jl, np.exp(np.asarray(jw) * t), jr)
        tp = torch.einsum("rij,rj,rjk->rik", tl, torch.exp(tw * t),
                          tr).numpy()
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tp.sum(axis=-1), 1.0, atol=1e-12)


# ---------------------------------------------------------------------------
# make_param_score: value and gradient
# ---------------------------------------------------------------------------
def score_point(case):
    """(pair arguments, the six inputs as numpy, which to differentiate)."""
    if case == "lg4x":
        newick, seqs = lg4x_data(41, 6, 60)
        model = lg4x_model()
        subst = np.stack([m[0] for m in model])
        ls = np.log(subst[:, :-1] / subst[:, -1:])
        fl = np.log(np.stack([m[1] for m in model]))
        rates = compute_gamma_cats(0.8, 4)
        weights = np.asarray([0.1, 0.2, 0.3, 0.4])
        args = (newick, seqs, 60, 4)
        kw = dict(states=20, matrices=4, model=model, rates=rates,
                  weights=weights)
        return args, kw, (ls, fl, rates, weights, 0.0), 2
    newick, seqs = dna(3, 8, 120, alpha=0.7, invariant=0.2)
    args = (newick, seqs, 120, 4)
    if case == "jc_jitter":
        # the optimizer's start: JC exchangeabilities nudged apart
        ls = np.log(jmo._jitter_flat(np.ones(6))[:-1])
        fl = np.log(np.full(4, 0.25))
        return args, {}, (ls, fl, compute_gamma_cats(1.0, 4),
                          np.full(4, 0.25), 0.0), 2
    rng = np.random.default_rng(7)
    ls = np.log(TRUE_PARAMS[:-1]) + rng.normal(0, 0.2, 5)
    fl = np.log(TRUE_FREQS) + rng.normal(0, 0.1, 4)
    w = rng.dirichlet(np.ones(4))
    kw = dict(scaling="rate") if case == "rate_scaling" else {}
    # every input differentiated: rates, weights, p-inv and lengths too
    return args, kw, (ls, fl, compute_gamma_cats(0.6, 4) * 1.1, w, 0.15), 6


@pytest.mark.parametrize("case", ["jc_jitter", "random", "rate_scaling",
                                  "lg4x"])
def test_param_score_matches_jax(case):
    """logL rel 1e-12 and the gradients rel 1e-8 against JAX's
    ``jax.value_and_grad`` of the same scorer at the same point."""
    args, kw, point, n_grad = score_point(case)
    (jt, jp), (tt, tp) = pair(*args, **kw)
    jscore, jbl = jmo.make_param_score(jp, jt)
    tscore, tbl = tmo.make_param_score(tp, tt)
    np.testing.assert_array_equal(tbl, np.asarray(jbl))
    inputs = (*point, jbl)

    jv, jg = jax.jit(jax.value_and_grad(
        jscore, argnums=tuple(range(n_grad))))(
        *(jnp.asarray(np.asarray(x, np.float64)) for x in inputs))
    targs = [torch.tensor(np.asarray(x, np.float64)) for x in inputs]
    for x in targs[:n_grad]:
        x.requires_grad_(True)
    tv = tscore(*targs)
    tv.backward()
    assert tv.dtype == torch.float64 and tv.device.type == "cpu"
    assert abs(float(tv.detach()) - float(jv)) <= LOGL_REL * abs(float(jv))
    for k in range(n_grad):
        assert targs[k].grad.shape == jg[k].shape
        assert rel_err(targs[k].grad.numpy(), jg[k]) <= GRAD_REL, k


def test_param_score_gradient_finite_differences():
    """``tests/test_modelopt.py``'s check, on the port: central
    differences of the logL in each log-exchangeability and frequency
    logit (eps 1e-6) within rtol 2e-5, atol 1e-7."""
    newick, seqs = dna(5, 6, 80)
    (_, _), (tree, part) = pair(newick, seqs, 80, 2)
    score, bl = tmo.make_param_score(part, tree)
    rest = (torch.tensor(compute_gamma_cats(1.0, 2)),
            torch.full((2,), 0.5, dtype=torch.float64),
            torch.tensor(0.0), torch.tensor(bl))
    ls0 = torch.tensor(np.log(TRUE_PARAMS[:-1] * 1.07), requires_grad=True)
    fl0 = torch.tensor(np.log(TRUE_FREQS), requires_grad=True)
    score(ls0, fl0, *rest).backward()

    def f(ls, fl):
        with torch.no_grad():
            return float(score(ls, fl, *rest))

    eps = 1e-6
    ls, fl = ls0.detach(), fl0.detach()
    for k in range(ls.shape[0]):
        e = torch.zeros_like(ls)
        e[k] = eps
        fd = (f(ls + e, fl) - f(ls - e, fl)) / (2 * eps)
        np.testing.assert_allclose(float(ls0.grad[k]), fd, rtol=2e-5,
                                   atol=1e-7)
    for k in range(fl.shape[0]):
        e = torch.zeros_like(fl)
        e[k] = eps
        fd = (f(ls, fl + e) - f(ls, fl - e)) / (2 * eps)
        np.testing.assert_allclose(float(fl0.grad[k]), fd, rtol=2e-5,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# the L-BFGS copy against optax.lbfgs()
# ---------------------------------------------------------------------------
def quadratic():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(6, 6))
    a = a @ a.T + np.eye(6)
    b = rng.normal(size=6)
    return (lambda x, m: 0.5 * x @ m.asarray(a) @ x - m.asarray(b) @ x,
            np.full(6, 0.5))


def rosenbrock():
    return (lambda x, m: m.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2
                               + (1.0 - x[:-1]) ** 2),
            np.array([-1.2, 1.0, -0.5, 0.8, 0.3]))


def barrier():
    """A log barrier: the first trial steps leave the domain (NaN), so
    the zoom takes its NaN and bisection branches."""
    return (lambda x, m: m.sum(x * x - 0.01 * m.log(x)) + 5.0 * x[0],
            np.array([0.1, 0.5, 0.3]))


class TorchMath:
    asarray = staticmethod(lambda a: torch.as_tensor(a))
    sum = staticmethod(torch.sum)
    log = staticmethod(torch.log)


def run_optax(fn, x0, steps):
    """optax.lbfgs() as JAX's model fitting drives it: (iterates, points
    at which the function was evaluated)."""
    import optax

    evals = []

    def f(x):
        jax.debug.callback(lambda v: evals.append(np.asarray(v)), x,
                           ordered=True)
        return fn(x, jnp)

    opt = optax.lbfgs()
    value_and_grad = optax.value_and_grad_from_state(f)

    @jax.jit
    def step(p, state):
        value, grad = value_and_grad(p, state=state)
        updates, state = opt.update(grad, state, p, value=value, grad=grad,
                                    value_fn=f)
        return optax.apply_updates(p, updates), state, value

    p, state = jnp.asarray(x0), opt.init(jnp.asarray(x0))
    iterates, n_evals = [], []
    for _ in range(steps):
        p, state, value = step(p, state)
        float(value)
        iterates.append(np.asarray(p))
        n_evals.append(len(evals))
    return np.array(iterates), evals, n_evals


def run_port(fn, x0, steps):
    evals = []

    def value_and_grad(x):
        evals.append(x.numpy().copy())
        x = x.detach().clone().requires_grad_(True)
        v = fn(x, TorchMath)
        v.backward()
        return float(v.detach()), x.grad

    p = torch.tensor(x0)
    state = lbfgs.init(p)
    iterates, n_evals = [], []
    for _ in range(steps):
        value, grad = lbfgs.value_and_grad_from_state(value_and_grad, p,
                                                      state)
        updates, state = lbfgs.update(grad, state, p, value=value,
                                      value_and_grad=value_and_grad)
        p = lbfgs.apply_updates(p, updates)
        iterates.append(p.numpy().copy())
        n_evals.append(len(evals))
    return np.array(iterates), evals, n_evals


@pytest.mark.parametrize("problem", [quadratic, rosenbrock, barrier])
def test_lbfgs_matches_optax(problem):
    """The first 10 iterates rel 1e-10, the same number of evaluations
    after each step (the line search's, and the reuse of its last value
    and gradient by the next step), every evaluation point rel 1e-10."""
    fn, x0 = problem()
    want, want_evals, want_n = run_optax(fn, x0, 10)
    got, got_evals, got_n = run_port(fn, x0, 10)
    assert got_n == want_n
    for k in range(10):
        assert rel_err(got[k], want[k]) <= LBFGS_REL, k
    for k, (g, w) in enumerate(zip(got_evals, want_evals)):
        assert rel_err(g, w) <= LBFGS_REL, k
    if problem is barrier:
        assert any(np.any(e <= 0) for e in got_evals)  # left the domain


def test_lbfgs_reuses_the_line_search_value():
    """``value_and_grad_from_state``: the first step evaluates (the
    state's value is +inf), later steps take the line search's last value
    and gradient, a NaN value is evaluated again."""
    calls = []

    def value_and_grad(x):
        calls.append(1)
        return float((x * x).sum()), 2 * x

    p = torch.tensor([1.0, -2.0], dtype=torch.float64)
    state = lbfgs.init(p)
    v, g = lbfgs.value_and_grad_from_state(value_and_grad, p, state)
    assert len(calls) == 1 and v == 5.0
    updates, state = lbfgs.update(g, state, p, value=v,
                                  value_and_grad=value_and_grad)
    n = len(calls)
    v2, g2 = lbfgs.value_and_grad_from_state(value_and_grad, p + updates,
                                             state)
    assert len(calls) == n and v2 == state.value and g2 is state.grad
    state.value = np.float64(np.nan)
    lbfgs.value_and_grad_from_state(value_and_grad, p, state)
    assert len(calls) == n + 1


# ---------------------------------------------------------------------------
# Brent and the flat-start jitter: the same host arithmetic
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fn, lo, hi", [
    (lambda x: -(x - 0.3) ** 2, 0.0, 1.0),
    (np.sin, 0.0, 3.0),
    (lambda x: -abs(np.log(x) - 1.2), 0.02, 100.0),
    (lambda x: x, 0.0, 0.99),
])
def test_brent_maximize_matches_jax(fn, lo, hi):
    assert tmo.brent_maximize(fn, lo, hi) == jmo.brent_maximize(fn, lo, hi)
    assert tmo.brent_maximize(fn, lo, hi, xtol=1e-8, max_iter=7) == \
        jmo.brent_maximize(fn, lo, hi, xtol=1e-8, max_iter=7)


@pytest.mark.parametrize("params", [np.ones(6), np.full((4, 190), 2.5),
                                    TRUE_PARAMS, np.ones((1, 3))])
def test_jitter_flat_matches_jax(params):
    np.testing.assert_array_equal(tmo._jitter_flat(params),
                                  jmo._jitter_flat(params))


# ---------------------------------------------------------------------------
# optimize_model against JAX's
# ---------------------------------------------------------------------------
def fit_case(case):
    """(pair arguments, optimize_model's arguments, params_indices)."""
    if case == "lg4x":
        newick, seqs = lg4x_data(43, 6, 80)
        return ((newick, seqs, 80, 4), dict(
            states=20, matrices=4, model=lg4x_model(), rates=np.ones(4),
            weights=np.full(4, 0.25)), dict(
            opt_subst=False, opt_alpha=False, rate_mode="free", rounds=1),
            [0, 1, 2, 3])
    if case == "gamma":  # from JC, alpha seeded at 1.0
        newick, seqs = dna(17, 6, 120, alpha=0.5)
        return ((newick, seqs, 120, 4), {}, dict(alpha=1.0, rounds=1),
                [0] * 4)
    if case == "free":
        newick, seqs = dna(29, 6, 120, alpha=0.6)
        return ((newick, seqs, 120, 4), dict(
            rates=compute_gamma_cats(1.0, 4)), dict(rate_mode="free",
                                                    rounds=1), [0] * 4)
    if case == "fixed":  # two rounds: the min_delta stop
        newick, seqs = dna(11, 6, 120)
        return ((newick, seqs, 120, 1), {}, dict(
            opt_alpha=False, rate_mode="fixed", rounds=2), [0])
    # pinv: 30% of sites held still, Γ4 and p-inv by Brent, GTR by L-BFGS
    newick, seqs = dna(23, 6, 120, alpha=1.0, invariant=0.3)
    return ((newick, seqs, 120, 4), dict(rates=compute_gamma_cats(1.0, 4)),
            dict(opt_pinv=True, rounds=1), [0] * 4)


FIT_CASES = ["gamma", "free", "fixed", "pinv", "lg4x"]


def lbfgs_iterates(monkeypatch, record):
    """Record every L-BFGS iterate of both packages: JAX's through
    ``optax.apply_updates`` (a debug callback inside its jitted step, the
    pytree's leaves in sorted-key order), the port's through
    ``lbfgs.apply_updates``."""
    import optax

    real_j, real_t = optax.apply_updates, lbfgs.apply_updates

    def jax_apply(p, u):
        new = real_j(p, u)
        jax.debug.callback(lambda q: record["jax"].append(np.concatenate(
            [np.ravel(q[k]) for k in sorted(q)])), new, ordered=True)
        return new

    def port_apply(p, u):
        new = real_t(p, u)
        record["port"].append(new.numpy().copy())
        return new

    monkeypatch.setattr(optax, "apply_updates", jax_apply)
    monkeypatch.setattr(lbfgs, "apply_updates", port_apply)


@functools.lru_cache(maxsize=None)
def jax_fit(case):
    """JAX's fit of ``case``: (result, its Partition's parameters and
    step-by-step logL after the write-back, the L-BFGS iterates)."""
    args, kw, fit, pidx = fit_case(case)
    (tree, part), _ = pair(*args, **kw)
    record = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        lbfgs_iterates(mp, record)
        res = jmo.optimize_model(part, tree, **fit)
    return res, partition_state(part, tree, pidx), record["jax"]


def partition_state(part, tree, pidx):
    return dict(subst=np.array(part.subst_params),
                freqs=np.array(part.frequencies), rates=np.array(part.rates),
                weights=np.array(part.rate_weights),
                pinv=np.array(part.prop_invar),
                eigen_valid=np.array(part.eigen_valid),
                logl=step_by_step_logl(tree, part, pidx))


@pytest.mark.parametrize("case", FIT_CASES)
def test_optimize_model_matches_jax(case, monkeypatch):
    """The same fit: the first 5 L-BFGS iterates rel 1e-8, the trajectory
    and logL rel 1e-9, the parameters 1e-4 absolute (alpha and p-inv rel
    1e-3); the Partition written back through its setters (eigen cache
    invalidated) and its step-by-step logL at the fitted model rel 1e-9
    to JAX's Partition's."""
    want, want_part, want_iter = jax_fit(case)
    args, kw, fit, pidx = fit_case(case)
    _, (tree, part) = pair(*args, **kw)
    record = {"jax": [], "port": []}
    lbfgs_iterates(monkeypatch, record)
    got = tmo.optimize_model(part, tree, **fit)
    got_iter = record["port"]

    assert isinstance(got, tmo.ModelOptResult)
    assert len(got_iter) >= 5 and len(want_iter) >= 5
    for k in range(5):
        assert rel_err(got_iter[k], want_iter[k]) <= ITER_REL, k
    assert len(got.trajectory) == len(want.trajectory)
    np.testing.assert_allclose(got.trajectory, want.trajectory, rtol=FIT_REL)
    np.testing.assert_allclose(got.logl, want.logl, rtol=FIT_REL)
    assert got.trajectory == sorted(got.trajectory)
    for name in ("subst_params", "frequencies", "rates", "rate_weights"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ABS,
                                   err_msg=name)
    assert (got.alpha is None) == (want.alpha is None)
    if want.alpha is not None:
        np.testing.assert_allclose(got.alpha, want.alpha, rtol=ALPHA_REL)
    np.testing.assert_allclose(got.prop_invar, want.prop_invar,
                               rtol=ALPHA_REL)

    state = partition_state(part, tree, pidx)
    R = part.rate_matrices
    np.testing.assert_array_equal(state["subst"],
                                  np.reshape(got.subst_params, (R, -1)))
    np.testing.assert_array_equal(state["freqs"],
                                  np.reshape(got.frequencies, (R, -1)))
    np.testing.assert_array_equal(state["rates"], got.rates)
    np.testing.assert_array_equal(state["weights"], got.rate_weights)
    assert np.all(state["pinv"] == (got.prop_invar if fit.get("opt_pinv")
                                    and got.prop_invar > 0 else 0.0))
    np.testing.assert_array_equal(state["eigen_valid"],
                                  want_part["eigen_valid"])
    np.testing.assert_allclose(state["logl"], want_part["logl"],
                               rtol=FIT_REL)
    if case == "free" or case == "lg4x":
        np.testing.assert_allclose((got.rates * got.rate_weights).sum(),
                                   1.0, rtol=1e-12)


def test_optimize_model_errors_are_typed():
    """The typed errors JAX raises, before any evaluation: an unknown
    rate mode (ParamError), p-inv under asc-bias and p-inv without an
    invariant site (InvarError), ``params_indices`` of the wrong length
    or out of range (ParamError)."""
    newick, seqs = dna(5, 6, 40)
    _, (tree, part) = pair(newick, seqs, 40, 2)
    with pytest.raises(ParamError, match="rate_mode"):
        tmo.optimize_model(part, tree, rate_mode="discrete")
    for bad in ([0], [0, 1]):
        with pytest.raises(ParamError, match="params_indices"):
            tmo.optimize_model(part, tree, params_indices=bad)

    _, (tree, part) = pair(newick, seqs, 40, 2, asc=True)
    part.set_asc_bias_type(tpll.ASC_LEWIS)
    with pytest.raises(InvarError, match="asc-bias"):
        tmo.optimize_model(part, tree, opt_pinv=True)

    varied = {lab: ("AC" if i % 2 else "CA") * 20
              for i, lab in enumerate(seqs)}
    _, (tree, part) = pair(newick, varied, 40, 2)
    with pytest.raises(InvarError, match="no invariant"):
        tmo.optimize_model(part, tree, opt_pinv=True)
    assert issubclass(InvarError, ParamError)
