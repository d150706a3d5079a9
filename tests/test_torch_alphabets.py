"""Every alphabet and rate count: K1/K2's any-alphabet instance and N1's
(``csrc/clv_fused.cu`` ``fused_any_kernel``, ``csrc/derivatives.cu``
``newton_any_kernel``), checked on the CPU, where no kernel runs, against
libpll_tpu on the same numpy inputs.

  * The walk of the new instance (``FusedPlan.plain_walk`` /
    ``plain_walk_score`` under :func:`clv_fused.any_layout`, its pool at
    the default cap and cut so that rows spill) at (S, C) in (2, 6), (3, 3), (16, 4), (32, 5),
    (61, 2), (4, 10), (20, 3), every tip encoding the alphabet takes
    (32 states: the widest "masks" JAX's int32 word holds), against JAX's
    ``make_fused_sweep`` and ``make_score`` in interpret mode and the
    float64 ``make_forward`` truth; the pool's split changes no bit.
  * ``make_train_step_fused`` (K2 and N1's plain twin) against JAX's.
  * A binary and a 16-state float64 ``Partition`` (tip CLVs by
    ``set_tip_clv``) under ``optimize_branch_lengths`` against
    libpll_tpu's.
  * The float64, eight-rate, 1 000-taxon protein walk now plans (the
    any-alphabet instance) where the protein instance's pool does not fit;
    the instance's block (``ANY_FUSED_LAYOUTS``: warps, rates a warp, the
    pool's cap within the budget of 16 warps an SM, the P-matrices
    transposed and padded to [R, R]); the guards raise only where JAX
    raises.

Tolerances: float64 rel 1e-12 (rows of each node's site block, logL),
scalers exact, t* rel 1e-10; float32 the f32 budget |ΔlogL| <= 2e-6·|logL|
+ 5e-3 and ``assert_f32_sweep_agrees`` for rows, t* rel 1e-5; the
Partitions ``tests/test_blopt.py``'s atol 1e-7 on logL.  The CUDA
instances are held against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import libpll_tpu as jpll
from libpll_tpu.engine import blopt as jblopt
from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas as cp
from libpll_tpu.tree import utree as jut

import libpll_tpu_torch as tpll
from libpll_tpu_torch.engine import blopt as tblopt
from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import clv_dyn as cd
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.ops import derivatives as dv
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                              SCALE_PER_SITE)
from libpll_tpu_torch.utils.flagship import build_alphabet_flagship

from test_clv_pallas import _random_tree_newick
from test_torch_derivatives import F32_T_REL, T_RTOL
from test_torch_fused import assert_in_budget
from test_torch_ops import (assert_f32_sweep_agrees, jax_model, make_case,
                            port_pmatrix)

F64_RTOL = 1e-12
SITES = 128  # JAX's fused kernels take whole 128-site blocks
CONSTANT = 16
# (states, rates, tip encoding, scale mode of the sweep, dtype): each case
# meets JAX in one dtype (interpret mode costs seconds a call)
CASES = [(2, 6, "masks", SCALE_PER_SITE, np.float64),
         (3, 3, "chars", SCALE_PER_RATE, np.float32),
         (16, 4, "masks", SCALE_PER_SITE, np.float32),
         (32, 5, "masks", SCALE_NONE, np.float64),
         (61, 2, "clv", SCALE_PER_SITE, np.float64),
         (4, 10, "chars", SCALE_PER_SITE, np.float32),
         (20, 3, "masks", SCALE_PER_RATE, np.float64)]
IDS = [f"S{s}-C{c}-{e}-{d.__name__}" for s, c, e, _, d in CASES]
_MEMO = {}


def alphabet_case(states, rate_cats, encoding, scale_mode, dtype):
    """(case, masks, tips): make_case at 8 taxa, its first ``CONSTANT``
    columns constant (the +I tests' invariant sites), the others with
    ambiguous cells (one to three states set); ``tips`` the port's input
    in ``encoding``."""
    key = (states, rate_cats, encoding, scale_mode, dtype)
    if key not in _MEMO:
        rng = np.random.default_rng(states * 31 + rate_cats)
        case = make_case(_random_tree_newick(8, rng), SITES,
                         seed=states + rate_cats, rate_cats=rate_cats,
                         states=states, scale_mode=scale_mode, dtype=dtype)
        tips = case["jtopo"].schedule.tips
        st = case["states"]
        st[:, :CONSTANT] = np.arange(CONSTANT) % states  # invariant columns
        masks = (np.uint64(1) << st.astype(np.uint64))
        for _ in range(2):  # ambiguity: up to two more states a cell
            extra = rng.integers(0, states, (tips, SITES)).astype(np.uint64)
            odd = rng.random((tips, SITES)) < 0.1
            odd[:, :CONSTANT] = False
            masks |= np.where(odd, np.uint64(1) << extra, np.uint64(0))
        bits = (masks[:, None, :] >> np.arange(states, dtype=np.uint64)[
            None, :, None]) & np.uint64(1)
        case["clv"][:tips] = bits[:, None].astype(dtype)
        masks = masks.astype(np.uint32)
        if encoding == "chars":
            port = cf.pack_tipchars(masks)
        elif encoding == "masks":
            port = torch.from_numpy(masks.view(np.int32))
        else:
            port = torch.from_numpy(case["clv"][:tips].copy())
        _MEMO[key] = (case, masks, port)
    return _MEMO[key]


def jax_tips(case, masks, encoding, states):
    if encoding == "chars":
        return cp.pack_tipchars(masks)
    if encoding == "masks":
        return jnp.asarray(masks.view(np.int32))
    tips = case["jtopo"].schedule.tips
    return cp.pack_tips(jnp.asarray(case["clv"][:tips]),
                        "vpu" if states <= 8 else "mxu")


def f64_logl(case):
    """JAX's float64 make_forward on the case's tip CLVs (the truth)."""
    model = {k: (v.astype(np.float64) if v.dtype == np.float32 else v)
             for k, v in case["model"].items()}
    return float(jev.make_forward(case["jtopo"])(
        jax_model(model), jnp.asarray(case["clv"], jnp.float64),
        jnp.asarray(case["scalers"]))[0])


def any_layout_of(plan, case, dtype, scale_mode, cap):
    """The any-alphabet instance's layout with at most ``cap`` of the
    plan's slots in shared memory (None: the default cap, the budget of 16
    warps an SM)."""
    _, c, s, _ = port_pmatrix(case, dtype).shape
    item = 8 if dtype == torch.float64 else 4
    lay = cf.any_layout(plan.pool, c, s, item, scale_mode, cap)
    if cap is not None:
        assert lay["shared_slots"] == min(cap, plan.pool)
    return lay


@pytest.mark.parametrize("states,rate_cats,encoding,scale_mode,dtype", CASES,
                         ids=IDS)
def test_any_walk_sweep_vs_jax(states, rate_cats, encoding, scale_mode,
                               dtype):
    """K2's walk under the any-alphabet layout, with the default cap, every
    slot in shared memory, one, and none (all spilled), equal bit for bit
    to the plain sweep; against JAX's fused sweep (interpret mode)."""
    case, masks, tips = alphabet_case(states, rate_cats, encoding,
                                      scale_mode, dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    pm = port_pmatrix(case, tdtype)
    sched = case["ttopo"].schedule
    plan = cf.FusedPlan(sched, encoding)
    want = cf.fused_sweep_plain(sched, tips, pm, scale_mode=scale_mode,
                                tip_encoding=encoding)
    for cap in (None, plan.pool, 1, 0):
        lay = any_layout_of(plan, case, tdtype, scale_mode, cap)
        got = plan.plain_walk(tips, pm, scale_mode, lay["shared_slots"])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    jtopo = case["jtopo"]
    jpm = jev._pmatrices(jax_model(case["model"]), jtopo, dtype)
    impl = "vpu" if states <= 8 else "mxu"
    j_inner, j_scal = cp.make_fused_sweep(
        jtopo.schedule, scale_mode, impl=impl, rate_cats=rate_cats,
        states=states, tip_encoding=encoding, interpret=True)(
        jax_tips(case, masks, encoding, states), jpm)
    j_inner = np.asarray(cp.unpack_clv(j_inner, rate_cats, states, impl))
    j_scal = np.asarray(j_scal)
    if dtype == np.float64:
        span = np.abs(j_inner).max(axis=(1, 2), keepdims=True)
        err = np.abs(want[0].numpy() - j_inner) / np.maximum(
            span, np.finfo(np.float64).tiny)
        assert err.max() <= F64_RTOL, err.max()
        assert np.array_equal(want[1].numpy(), j_scal)
    else:
        assert_f32_sweep_agrees(want[0], want[1], j_inner, j_scal)


@pytest.mark.parametrize("states,rate_cats,encoding,scale_mode,dtype", CASES,
                         ids=IDS)
def test_any_walk_score_vs_jax(states, rate_cats, encoding, scale_mode,
                               dtype):
    """K1's walk under the any-alphabet layout (per-site scaling, +I),
    pools split four ways (the default cap, all, one and no slots in
    shared memory), equal to the plain score bit for bit; against JAX's
    ``make_score`` (interpret mode) and the float64 truth."""
    case, masks, tips = alphabet_case(states, rate_cats, encoding,
                                      scale_mode, dtype)
    model = dict(case["model"])
    model["prop_invar_pc"] = np.full_like(model["prop_invar_pc"], 0.15)
    model["invariant"] = np.where(np.arange(SITES) < CONSTANT,
                                  np.arange(SITES) % states, -1).astype(
                                      np.int32)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tt = case["ttopo"]
    edge = (tt.parent_clv, tt.child_clv, tt.edge_matrix)
    plan = cf.FusedPlan(tt.schedule, encoding, edge)
    tm = model_from_numpy(model, "cpu", tdtype)
    pm = port_pmatrix(case, tdtype)
    wvec, inv_add = tev._pinv_score_inputs(tm, tdtype)
    want = float(cf.fused_edge_score_plain(
        tt.schedule, tips, pm, wvec, tm["pattern_weights"], inv_add,
        parent_clv=edge[0], child_clv=edge[1], edge_matrix=edge[2],
        tip_encoding=encoding))
    for cap in (None, plan.pool, 1, 0):
        lay = any_layout_of(plan, case, tdtype, SCALE_PER_SITE, cap)
        got = float(plan.plain_walk_score(tips, pm, wvec,
                                          tm["pattern_weights"], inv_add,
                                          SCALE_PER_SITE,
                                          lay["shared_slots"]))
        assert got == want
    jtopo = case["jtopo"]._replace(scale_mode=SCALE_PER_SITE)
    jscore = float(jev.make_score(
        jtopo, rate_cats, states, use_pinv=True, tip_encoding=encoding,
        interpret=True)(jax_model(model),
                        jax_tips(case, masks, encoding, states)))
    got_module = float(tev.make_score(
        tt._replace(scale_mode=SCALE_PER_SITE), rate_cats, states,
        use_pinv=True, tip_encoding=encoding, device="cpu")(tm, tips))
    assert got_module == want
    if dtype == np.float64:
        assert abs(want - jscore) <= F64_RTOL * abs(jscore), (want, jscore)
    else:  # and the float64 plain score, held to JAX's in float64 above
        tm64 = model_from_numpy(model, "cpu", torch.float64)
        wvec64, inv64 = tev._pinv_score_inputs(tm64, torch.float64)
        truth = float(cf.fused_edge_score_plain(
            tt.schedule, tips if encoding != "clv" else tips.double(),
            port_pmatrix(case, torch.float64), wvec64,
            tm64["pattern_weights"], inv64, parent_clv=edge[0],
            child_clv=edge[1], edge_matrix=edge[2], tip_encoding=encoding))
        assert_in_budget(want, jscore, truth)


@pytest.mark.parametrize("states,rate_cats,encoding,dtype", [
    (2, 6, "masks", np.float64), (16, 4, "masks", np.float32),
    (61, 2, "clv", np.float64), (4, 10, "chars", np.float32)])
def test_train_step_fused_vs_jax(states, rate_cats, encoding, dtype):
    """``make_train_step_fused`` (K2, the edge logL and N1's plain twin)
    and ``make_forward_fused`` against JAX's: logL and t*; the float64
    logL against the make_forward truth."""
    case, masks, tips = alphabet_case(states, rate_cats, encoding,
                                      SCALE_PER_SITE, dtype)
    tdtype = torch.float64 if dtype == np.float64 else torch.float32
    tm = model_from_numpy(case["model"], "cpu", tdtype)
    jm = jax_model(case["model"])
    jclv = cp.pack_tips(jnp.asarray(
        case["clv"][:case["jtopo"].schedule.tips]),
        "vpu" if states <= 8 else "mxu")
    want_step = [float(v) for v in jev.make_train_step_fused(
        case["jtopo"], rate_cats, states, interpret=True)(jm, jclv)]
    kw = dict(tip_encoding=encoding, device="cpu")
    got_fwd = float(tev.make_forward_fused(case["ttopo"], rate_cats,
                                           states, **kw)(tm, tips)[0])
    got_step = [float(v) for v in tev.make_train_step_fused(
        case["ttopo"], rate_cats, states, **kw)(tm, tips)]
    assert got_step[0] == got_fwd
    if dtype == np.float64:
        for got, want in ((got_step[0], want_step[0]),
                          (got_step[0], f64_logl(case))):
            assert abs(got - want) <= F64_RTOL * abs(want), (got, want)
        assert abs(got_step[1] - want_step[1]) <= T_RTOL * want_step[1]
    else:
        assert_in_budget(got_step[0], want_step[0], f64_logl(case))
        assert abs(got_step[1] - want_step[1]) <= F32_T_REL * want_step[1]


def partitions(states, rate_cats, seed, tips=9, sites=120):
    """libpll_tpu's and the port's float64 Partitions (the port's on the
    CPU) on one random tree, tip CLVs of simulated states set by
    ``set_tip_clv``, a random GTR and Γ(0.6), lengths x2: (jtree, jpart,
    ttree, tpart)."""
    rng = np.random.default_rng(seed)
    newick = _random_tree_newick(tips, rng)
    params = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
    freqs = rng.uniform(0.2, 1.0, states)
    freqs /= freqs.sum()
    clv = np.eye(states)[rng.integers(0, states, (tips, sites))]
    out = []
    for pkg, ut in ((jpll, jut), (tpll, tut)):
        tree = ut.parse_newick_string(newick)
        for n in tree.nodes:
            for m in ([n] if n.is_tip else list(n.ring())):
                m.length = m.back.length = 2.0 * m.length
        kw = {} if pkg is jpll else dict(device="cpu")
        part = pkg.Partition(tips, tips - 2, states, sites, 1,
                             2 * tips - 3, rate_cats, tips - 2, **kw)
        for n in ut.query_tipnodes(tree):
            part.set_tip_clv(n.clv_index, clv[int(n.label[1:])])
        part.set_frequencies(0, freqs)
        part.set_subst_params(0, params)
        part.set_category_rates(pkg.compute_gamma_cats(0.6, rate_cats))
        out += [tree, part]
    return out


@pytest.mark.parametrize("states,rate_cats", [(2, 6), (16, 3)])
def test_partition_blopt_vs_jax(states, rate_cats):
    """A binary (six rates) and a 16-state float64 Partition optimise
    their branch lengths as libpll_tpu's: logL within test_blopt's atol,
    the same sweeps; the port's scan optimiser agrees with its host loop."""
    jtree, jpart, ttree, tpart = partitions(states, rate_cats, states)
    pidx = [0] * rate_cats
    want, jsweeps = jblopt.optimize_branch_lengths(jtree, jpart, pidx,
                                                   max_sweeps=3)
    got, sweeps = tblopt.optimize_branch_lengths(ttree, tpart, pidx,
                                                 max_sweeps=3)
    assert sweeps == jsweeps
    np.testing.assert_allclose(got, want, atol=1e-7)
    _, _, ttree2, tpart2 = partitions(states, rate_cats, states)
    got_scan, _ = tblopt.optimize_branch_lengths_scan(ttree2, tpart2, pidx,
                                                      max_sweeps=3)
    np.testing.assert_allclose(got_scan, want, atol=1e-6)


def test_flagship_generator():
    """``build_alphabet_flagship``: the DNA flagship's tree at the seed,
    S(S-1)/2 exchangeabilities behind one eigensystem, C equiprobable Γ
    rates, every state drawn, the same columns again from the seed."""
    from libpll_tpu_torch.utils.flagship import build_flagship

    tree, topo, model, cols = build_alphabet_flagship(12, 3000, 16, 4,
                                                      seed=3)
    assert topo.schedule.clv_map == build_flagship(
        12, 8, seed=3)[0].schedule.clv_map
    assert cols.shape == (12, 3000) and cols.dtype == np.uint8
    assert set(np.unique(cols)) == set(range(16))
    assert model["eigenvals"].shape == (1, 16)
    assert model["freqs_pc"].shape == (4, 16)
    np.testing.assert_allclose(model["rate_weights"], 0.25)
    np.testing.assert_allclose((model["rates"] * 0.25).sum(), 1.0)
    assert len(tut.query_tipnodes(tree)) == 12
    assert np.array_equal(build_alphabet_flagship(12, 3000, 16, 4,
                                                  seed=3)[3], cols)


class _Card:
    """A stub of clv_fused.cu's and clv_any.cu's layout entry points (the
    queries need a card): the DNA/protein instance refuses the pool; the
    any-alphabet instance answers a 227 KB block limit, 132 SMs, 3 blocks
    an SM."""

    def clv_fused_layout(self, *args):
        self.fixed = args[:6]
        return 1  # cudaErrorInvalidValue

    def clv_any_query(self, states, f64, score, threads, smem, out):
        out[0], out[1], out[2] = 232448, 132, 3
        return 0


def thousand_taxa_plan():
    """The 1 000-taxon walk (6 live rows, CLV tips)."""
    if "plan1000" not in _MEMO:
        topo = tev.topology_from_tree(tut.parse_newick_string(
            _random_tree_newick(1000, np.random.default_rng(8))), 64)[0]
        _MEMO["plan1000"] = cf.FusedPlan(topo.schedule, "clv")
    return _MEMO["plan1000"]


@pytest.mark.parametrize("states,rate_cats,dtype,shared,warps,ring", [
    (20, 8, torch.float64, 2, 8, 0), (61, 4, torch.float64, 1, 4, 0),
    (16, 4, torch.float32, 6, 4, 16384), (2, 6, torch.float64, 6, 6, 3072)])
def test_layout_routes_to_any(monkeypatch, states, rate_cats, dtype, shared,
                              warps, ring):
    """The float64, eight-rate, 1 000-taxon protein walk (6 slots, which
    the protein instance's block cannot hold) and every (S, C) outside the
    DNA and protein instances plan on the any-alphabet instance: a block
    of 32 sites and a warp a rate, the slots that fit the budget of 16
    warps an SM, or of the stub's 3 blocks an SM where fewer, beside the
    warps' P-matrix rings in shared memory, the rest spilled; a block a
    32-site tile."""
    plan = thousand_taxa_plan()
    assert plan.pool == 6
    card = _Card()
    monkeypatch.setattr(cf, "load_kernels", lambda: card)
    monkeypatch.setattr(cf, "load_any_kernels", lambda: card)
    lay = plan.layout(dtype, rate_cats, states, SCALE_PER_SITE, True)
    assert lay["shared_slots"] == shared
    assert (lay["threads"], lay["block_sites"], lay["blocks_per_sm"],
            lay["sms"], lay["warps"]) == (32 * warps, 32, 3, 132, warps)
    item = 8 if dtype == torch.float64 else 4
    assert lay["smem"] == shared * 32 * (rate_cats * states * item + 4) + ring
    assert lay["smem"] <= cd.any_pool_budget(rate_cats, 3)
    assert cf.launch_grid(10 ** 6, lay) == -(-10 ** 6 // 128) * 4
    fixed = states in cf.KERNEL_STATES and rate_cats in cf.KERNEL_RATE_CATS
    assert hasattr(card, "fixed") == fixed
    # the instance reads each P-matrix row as whole 16-byte vectors
    pm = torch.rand((3, rate_cats, states, states), dtype=dtype)
    padded = cf.pad_rows(pm)
    assert padded.shape[-1] * padded.element_size() % 16 == 0
    assert padded.shape[-1] - states < 16 // padded.element_size()
    assert torch.equal(padded[..., :states], pm)
    assert not padded[..., states:].any()


# (rates, states, dtype, counter rows, pool, blocks an SM the registers
# allow, shared slots, bytes past the pool, warps, rates a warp) of K1/K2's
# any-alphabet block (csrc/clv_any.cu); pool None: the 1 000-taxon walk's
# plan (its layout from the stub card's 3 blocks)
ANY_FUSED_LAYOUTS = [
    (4, 16, torch.float32, 1, 3, 4, 3, 16384, 4, 1),     # the GT16 flagship
    (4, 16, torch.float32, 4, 6, 4, 4, 16384, 4, 1),     # per rate: spills
    (4, 61, torch.float32, 1, 3, None, 1, 0, 4, 1),      # 16 warps' budget
    (4, 61, torch.float32, 1, 3, 2, 3, 0, 4, 1),         # the codon cell
    (8, 20, torch.float64, 1, None, 3, 2, 0, 8, 1),      # 1 000-taxon protein
    (8, 61, torch.float64, 8, 6, None, 0, 0, 8, 1),      # no slot fits
    (10, 5, torch.float64, 10, 6, None, 4, 10240, 5, 2),  # two rates a warp
    (9, 7, torch.float32, 1, 6, None, 6, 5120, 5, 2),    # a one-rate warp
    (40, 64, torch.float64, 40, 6, None, 0, 0, 8, 5),    # five rates a warp
    (1, 16, torch.float32, 1, 6, 32, 2, 4096, 1, 1),     # one warp a block
    (2, 2, torch.float32, 1, 6, None, 6, 512, 2, 1),     # the smallest rings
]


@pytest.mark.parametrize(
    "c,s,dtype,srows,pool,blocks,shared,tail,warps,per", ANY_FUSED_LAYOUTS)
def test_fused_any_layout(monkeypatch, c, s, dtype, srows, pool, blocks,
                          shared, tail, warps, per):
    """K1/K2's any-alphabet block: the pool's default cap within the
    budget of 16 warps an SM, or of the blocks an SM its registers allow
    where fewer, beside the warps' rings (never negative; the next slot
    would not fit), a cap obeyed, the warps and rates a
    warp; the P-matrices as the kernel reads them, transposed and
    zero-padded to [R, R] at every R (4, 8, 16, 64); the float64 eight-rate
    1 000-taxon protein walk on this instance."""
    item = 8 if dtype == torch.float64 else 4
    mode = SCALE_PER_RATE if srows > 1 else SCALE_PER_SITE
    if pool is None:
        plan = thousand_taxa_plan()
        card = _Card()
        monkeypatch.setattr(cf, "load_kernels", lambda: card)
        monkeypatch.setattr(cf, "load_any_kernels", lambda: card)
        lay = plan.layout(dtype, c, s, mode, False)
        assert hasattr(card, "fixed") and plan.pool == 6
        pool = plan.pool
    else:
        lay = cf.any_layout(pool, c, s, item, mode, blocks=blocks)
    slot = 32 * (c * s * item + 4 * srows)
    budget = cd.any_pool_budget(c, blocks)
    cap = (budget - tail) // slot
    assert cap >= 0 and lay["shared_slots"] == min(pool, cap) == shared
    assert lay["smem"] == shared * slot + tail <= budget
    assert (cap + 1) * slot + tail > budget
    assert (lay["warps"], lay["rates_per_warp"], lay["threads"]) == (
        warps, per, 32 * warps)
    assert warps * per >= c > (warps - 1) * per
    assert lay["buffers"] == (cf.ANY_RING_UNITS if tail and s <= 16 else 0)
    for k in (0, 1, pool + 3):
        capped = cf.any_layout(pool, c, s, item, mode, k, blocks)
        assert capped["shared_slots"] == min(pool, k)
        assert capped["smem"] == min(pool, k) * slot + tail
    pm = torch.from_numpy(np.random.default_rng(s).random(
        (3, c, s, s))).to(dtype)
    pt = cf.any_pt(pm)
    r = cd.any_bound(s)
    assert pt.shape == (3, c, r, r) and pt.is_contiguous()
    assert torch.equal(pt[..., :s, :s], pm.transpose(-1, -2))
    assert not pt[..., s:, :].any() and not pt[..., :, s:].any()


@pytest.mark.parametrize("states,rate_cats", [(2, 6), (16, 4), (61, 2),
                                              (64, 16), (4, 10)])
def test_newton_plan_any(states, rate_cats):
    """N1's any-alphabet instance: its tables at the front of the shared
    memory (or a device row where they exceed half of it), the slices in
    what is left, every site in one slice; the fixed instances' plans
    unchanged."""
    limit, sms = 232448 - 1024, 132
    for item in (4, 8):
        for sites in (300, 262144):
            plan = dv.plan_newton((rate_cats, states, sites), item, sites,
                                  0, sms, limit)
            assert dv.any_instance(rate_cats, states)
            tables = dv.table_bytes(rate_cats, states, item)
            front = tables if plan.tables == "shared" else 0
            assert plan.tables == ("shared" if tables <= limit // 2
                                   else "device")
            slice_ = (dv.slice_bytes(rate_cats, states, item,
                                     plan.block_sites) if plan.resident
                      else 0)
            assert plan.smem == front + slice_ <= limit
            assert plan.grid * plan.block_sites >= sites > (
                plan.grid - 1) * plan.block_sites
    fixed = dv.plan_newton((4, 4, 262144), 4, 262144, 0, sms, limit)
    assert fixed.tables == "" and not dv.any_instance(4, 4)


def test_guards_raise_where_jax_raises():
    """The port raises where JAX does: one state, "chars" tips above four
    states, "masks" tips wider than JAX's int32 word; 33 and 64 states
    with CLV tips and any rate count plan and run (plain here)."""
    newick = _random_tree_newick(6, np.random.default_rng(2))
    topo = tev.topology_from_tree(tut.parse_newick_string(newick), 40)[0]
    with pytest.raises(EinvalError):
        cf.check_tip_encoding("chars", 5)
    with pytest.raises(EinvalError):
        tev.make_score(topo, 4, 33, tip_encoding="masks", device="cpu")
    cf.check_tip_encoding("masks", 32)
    for states, rate_cats in ((33, 1), (64, 16)):
        case = make_case(newick, 40, seed=1, rate_cats=rate_cats,
                         states=states)
        tm = model_from_numpy(case["model"], "cpu", torch.float64)
        tips = torch.from_numpy(case["clv"][:6].copy())
        logl = float(tev.make_score(case["ttopo"], rate_cats, states,
                                    device="cpu")(tm, tips))
        assert np.isfinite(logl)
        assert logl == float(tev.make_forward_fused(
            case["ttopo"], rate_cats, states, device="cpu")(tm, tips)[0])
    with pytest.raises(EinvalError, match="states 1"):
        dv._check(torch.zeros((1, 1, 4), dtype=torch.float64),
                  *([None] * 10), 4, 0, 1)
