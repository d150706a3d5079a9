"""The large-tree tiers at every alphabet and rate count: K3/K4
(``ops/clv_seg.py``) and K5/K6 (``ops/clv_dyn.py``) at S and C outside
the DNA and protein instances' (the any-alphabet instances
``csrc/clv_seg_any.cu`` and ``csrc/clv_dyn_any.cu``), checked on the CPU,
where no kernel runs, against libpll_tpu on the same numpy inputs.

  * The plain versions of K5/K6 (``make_dyn_sweep``/``make_dyn_score``)
    and K3/K4 (``make_segmented_sweep``/``make_segmented_score``) on a
    16-taxon tree cut into segments, at (S, C) in (2, 6), (16, 3),
    (16, 1), (4, 3) (chars and masks), (61, 3) and (61, 1) (CLV tips),
    every scale mode, float32 and float64, +I: rows against JAX's XLA
    ``make_level_sweep`` in the case's dtype, logL against JAX's float64
    ``make_forward``; the kernels' pool addressing (``plain_slotted``
    under the any-alphabet layout, pools of 0 and 1 slots; K3/K4's
    ``plain_walk``) bit for bit with the plain versions.
  * ``make_score_unbounded`` (``device="cpu"``) at S 2 and 16 and DNA at
    C = 3, with +I or an asc tail, and a ``dynamic_edge`` table swap at 16
    states, against JAX.
  * JAX's interpret-mode kernels for K3/K4 (one case).  K5/K6 meet JAX's
    XLA path only: one interpret-mode ``make_score_unbounded`` case took
    9-15 s here, a third of the file's time budget.
  * The guards: masks above 31 states in the dyn tier, JAX's
    ``block_sites`` rule, the any-alphabet pools' sizes (never negative;
    61 states at eight rates in float64 spill every row).

Tolerances: float64 logL rel 1e-12, CLVs rel 1e-12 of each node's site
block, scalers exact; float32 the f32 budget |ΔlogL| <= 2e-6·|logL| +
5e-3 and ``assert_f32_sweep_agrees`` for rows.  The CUDA instances are
held against these plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` (phase 37).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas_seg as cps
from libpll_tpu.ops.sweep import make_level_sweep as j_sweep
from libpll_tpu.tree import utree as jut

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import any_block as ab
from libpll_tpu_torch.ops import clv_dyn as cd
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.ops import clv_seg as cseg
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                              SCALE_PER_SITE)

from test_clv_pallas import _random_tree_newick
from test_torch_fused import assert_in_budget
from test_torch_ops import (assert_f32_sweep_agrees, jax_model, make_case,
                            port_pmatrix)

F64_RTOL = 1e-12
SITES = 128  # JAX's kernels take whole 128-site blocks
CONSTANT = 16  # invariant columns (+I)
TIPS = 16
DYN_ROWS, SEG_ROWS = 8, 9  # cuts of the 16-taxon tree into segments
# (states, rates, tip encoding of the dyn tier, scale mode, dtype)
# (each (S, C) costs JAX seconds of compilation, so the cases are few)
CASES = [(2, 6, "masks", SCALE_PER_SITE, np.float64),
         (16, 3, "masks", SCALE_PER_RATE, np.float32),
         (4, 3, "chars", SCALE_NONE, np.float64),
         (4, 3, "masks", SCALE_NONE, np.float64),
         (61, 1, "clv", SCALE_PER_SITE, np.float64)]
IDS = [f"S{s}-C{c}-{e}-m{m}-{d.__name__}" for s, c, e, m, d in CASES]
# the case whose rows meet JAX's level sweep row for row (seconds a case);
# the others' rows meet JAX through their edge logL
ROWS_VS_JAX = {(61, 1, SCALE_PER_SITE, np.float64)}
_MEMO = {}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch intra-op thread: the plain versions issue many small
    tensor operations, which more threads only slow down beside other
    test processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tdtype(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


def large_case(states, rate_cats, scale_mode, dtype, tips=TIPS):
    """(case, masks): make_case at ``tips`` taxa, its first ``CONSTANT``
    columns constant (+I's invariant sites, listed in the model), the
    others with ambiguous cells (one to three states); case["clv"] holds
    the matching 0/1 tip CLVs, scaled by 10**U(-45, 0) a tip and site at
    61 states in float64 so that float64 scaling fires."""
    key = (states, rate_cats, scale_mode, dtype, tips)
    if key not in _MEMO:
        rng = np.random.default_rng(states * 7 + rate_cats)
        newick = _random_tree_newick(tips, rng)
        case = make_case(newick, SITES,
                         seed=states + rate_cats, rate_cats=rate_cats,
                         states=states, scale_mode=scale_mode, dtype=dtype)
        tips = case["jtopo"].schedule.tips
        st = case["states"]
        st[:, :CONSTANT] = np.arange(CONSTANT) % states
        masks = np.uint64(1) << st.astype(np.uint64)
        for _ in range(2):
            extra = rng.integers(0, states, (tips, SITES)).astype(np.uint64)
            odd = rng.random((tips, SITES)) < 0.1
            odd[:, :CONSTANT] = False
            masks |= np.where(odd, np.uint64(1) << extra, np.uint64(0))
        bits = (masks[:, None, :] >> np.arange(states, dtype=np.uint64)[
            None, :, None]) & np.uint64(1)
        clv = bits[:, None].astype(dtype)
        if states > 32 and dtype == np.float64 and scale_mode:
            clv = clv * 10.0 ** rng.uniform(-45, 0, (tips, 1, 1, SITES))
        case["clv"][:tips] = clv
        case["newick"] = newick
        case["model"]["invariant"] = np.where(
            np.arange(SITES) < CONSTANT, np.arange(SITES) % states,
            -1).astype(np.int32)
        _MEMO[key] = (case, masks if states > 32 else masks.astype(np.uint32))
    return _MEMO[key]


def port_tips(case, masks, encoding):
    if encoding == "chars":
        return cf.pack_tipchars(masks)
    if encoding == "masks":
        return torch.from_numpy(masks.view(np.int32))
    return torch.from_numpy(case["clv"][:case["jtopo"].schedule.tips].copy())


def jax_rows(case, dtype):
    """JAX's XLA level sweep in ``dtype``: (CLVs, scalers) numpy."""
    key = ("rows", id(case), dtype)
    if key not in _MEMO:
        jt = case["jtopo"]
        jpm = jev._pmatrices(jax_model(case["model"]), jt, dtype)
        clv, scal = j_sweep(jt.schedule, jt.scale_mode)(
            jnp.asarray(case["clv"]), jnp.asarray(case["scalers"]), jpm)
        _MEMO[key] = (np.asarray(clv), np.asarray(scal))
    return _MEMO[key]


def jax_logl(case, model, dtype=np.float64):
    """JAX's make_forward in ``dtype`` (the float64 truth by default)."""
    key = ("logl", id(case), id(model), dtype)
    if key not in _MEMO:
        m = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
             for k, v in model.items()}
        _MEMO[key] = float(jev.make_forward(case["jtopo"])(
            jax_model(m), jnp.asarray(case["clv"], dtype),
            jnp.asarray(case["scalers"]))[0])
    return _MEMO[key]


def pinv_model(case):
    key = ("pinv", id(case))
    if key not in _MEMO:
        _MEMO[key] = dict(case["model"], prop_invar_pc=np.full_like(
            case["model"]["prop_invar_pc"], 0.15))
    return _MEMO[key]


def assert_rows(got, got_scal, case, dtype, row_of):
    """Port rows [n_inner, C, S, L] (``row_of``: level-major -> the
    port's row) against JAX's level sweep in the case's dtype, where
    ``ROWS_VS_JAX`` lists the case; else their edge logL against JAX's
    float64 make_forward."""
    c, s = case["model"]["freqs_pc"].shape
    if (s, c, case["jtopo"].scale_mode, dtype) not in ROWS_VS_JAX:
        assert_logl(rows_logl(got, got_scal, case, dtype, row_of), case,
                    case["model"], dtype, False)
        return
    want, want_scal = jax_rows(case, dtype)
    tips = case["jtopo"].schedule.tips
    n = case["jtopo"].schedule.n_inner
    order = [row_of(r) for r in range(n)]
    got = got.numpy()[order]
    got_scal = np.concatenate([got_scal.numpy()[order],
                               got_scal.numpy()[-1:]])
    if dtype == np.float64:
        np.testing.assert_array_equal(got_scal, want_scal)
        span = np.abs(want[tips:]).max(axis=(1, 2), keepdims=True)
        err = np.abs(got - want[tips:]) / np.maximum(
            span, np.finfo(np.float64).tiny)
        assert err.max() <= F64_RTOL, err.max()
    else:
        assert_f32_sweep_agrees(got, got_scal, want[tips:], want_scal)


def rows_logl(inner, scal, case, dtype, row_of):
    """The edge log-likelihood of the port's rows (the port's
    ``likelihood.edge_loglikelihood``)."""
    from libpll_tpu_torch.ops import likelihood as lk

    tt = case["ttopo"]
    tips = tt.schedule.tips
    f = tev._floats(model_from_numpy(case["model"], "cpu", tdtype(dtype)),
                    tdtype(dtype))

    def row(i):
        return (inner[row_of(i - tips)] if i >= tips
                else torch.from_numpy(case["clv"][i]))

    def srow(i):
        return scal[row_of(i - tips) if i >= tips else -1]

    return float(lk.edge_loglikelihood(
        row(tt.parent_clv), row(tt.child_clv), srow(tt.parent_clv),
        srow(tt.child_clv), port_pmatrix(case, tdtype(dtype))[
            tt.edge_matrix], f["freqs_pc"], f["rate_weights"],
        f["pattern_weights"], f["prop_invar_pc"],
        torch.from_numpy(case["model"]["invariant"]), sites=SITES,
        per_rate=tt.scale_mode == SCALE_PER_RATE)[0])


def assert_logl(got, case, model, dtype, pinv):
    if dtype == np.float64:
        np.testing.assert_allclose(got, jax_logl(case, model),
                                   rtol=F64_RTOL)
    else:
        # under +I the reference adds the invariant term unscaled, so the
        # float32 logL is held to JAX's float32 forward as well
        refs = [jax_logl(case, model)]
        if pinv:
            refs.append(jax_logl(case, model, np.float32))
        assert_in_budget(got, *refs)


def dyn_schedule(case):
    tt = case["ttopo"]
    c, s = case["model"]["freqs_pc"].shape
    dyn = cd.build_dyn_schedule(tt.schedule, rate_cats=c, states=s,
                                max_rows=DYN_ROWS,
                                ensure_rows=[tt.parent_clv, tt.child_clv])
    assert len(dyn.segments) > 2
    return dyn


def seg_schedule(case, max_rows=SEG_ROWS):
    tt = case["ttopo"]
    seg = cseg.build_segmented_schedule(
        tt.schedule, max_rows=max_rows,
        ensure_rows=[tt.parent_clv, tt.child_clv])
    assert len(seg.segments) > 2
    return seg


def score_inputs(case, model, dtype, pinv):
    tm = model_from_numpy(model, "cpu", dtype)
    if pinv:
        wvec, inv_add = tev._pinv_score_inputs(tm, dtype)
    else:
        wvec = cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"])
        inv_add = None
    return wvec, tm["pattern_weights"], inv_add


@pytest.mark.parametrize("states,rate_cats,encoding,scale_mode,dtype", CASES,
                         ids=IDS)
def test_dyn_sweep_any_vs_jax(states, rate_cats, encoding, scale_mode,
                              dtype):
    """K5's plain version against JAX's level sweep; its slotted runner
    under the any-alphabet layout (the budget's pool, one slot, none, the
    plan's peak) equal to it bit for bit."""
    case, masks = large_case(states, rate_cats, scale_mode, dtype)
    dyn = dyn_schedule(case)
    sweep = cd.make_dyn_sweep(dyn, scale_mode, rate_cats=rate_cats,
                              states=states, tip_encoding=encoding)
    assert sweep.any
    tips = port_tips(case, masks, encoding)
    pm = port_pmatrix(case, tdtype(dtype))
    args = (tips, *cd.dyn_runtime_args(dyn), pm)
    inner, scal = sweep(*args)
    assert_rows(inner, scal, case, dtype, dyn.inner_row)
    for cap in (None, 1, 0, max(sweep.plan.n_slots)):
        sweep.slot_cap = cap
        lay = sweep.layout(pm.dtype)
        assert min(lay.pools) >= 0 and (cap is None or max(lay.pools) <= cap)
        got = sweep.plain_slotted(*args)
        assert torch.equal(got[0], inner) and torch.equal(got[1], scal)


@pytest.mark.parametrize("states,rate_cats,encoding,scale_mode,dtype", CASES,
                         ids=IDS)
def test_dyn_score_any_vs_jax(states, rate_cats, encoding, scale_mode,
                              dtype):
    """K6's plain version, with and without +I (float64), against JAX's
    float64 make_forward; its slotted runner at pools of 0 and 1 slots
    and the plan's peak equal to it bit for bit."""
    case, masks = large_case(states, rate_cats, scale_mode, dtype)
    tt = case["ttopo"]
    dyn = dyn_schedule(case)
    tips = port_tips(case, masks, encoding)
    pm = port_pmatrix(case, tdtype(dtype))
    for pinv in (False, True) if dtype == np.float64 else (False,):
        model = pinv_model(case) if pinv else case["model"]
        score = cd.make_dyn_score(dyn, tt.parent_clv, tt.child_clv,
                                  tt.edge_matrix, scale_mode,
                                  rate_cats=rate_cats, states=states,
                                  tip_encoding=encoding, use_pinv=pinv)
        wvec, pw, inv_add = score_inputs(case, model, tdtype(dtype), pinv)
        args = (tips, *cd.dyn_score_args(dyn), pm, wvec, pw, inv_add)
        got = float(score(*args))
        assert_logl(got, case, model, dtype, pinv)
        for cap in (1, 0, max(score.plan.n_slots)):
            score.slot_cap = cap
            assert score.layout(pm.dtype).spills == int(
                (score.plan.slots >= cap).sum())
            assert float(score.plain_slotted(*args)) == got


@pytest.mark.parametrize("states,rate_cats,encoding,scale_mode,dtype", CASES,
                         ids=IDS)
def test_segmented_any_vs_jax(states, rate_cats, encoding, scale_mode,
                              dtype):
    """K3's and K4's plain versions (CLV tips) against JAX's level sweep
    and float64 make_forward, their walks (``plain_walk``) equal to them
    bit for bit; the any-alphabet instance takes the call."""
    case, _ = large_case(states, rate_cats, scale_mode, dtype)
    tt = case["ttopo"]
    seg = seg_schedule(case)
    slabs = cseg.pack_tips_segmented(case["clv"][:TIPS], seg)
    pm = port_pmatrix(case, tdtype(dtype))
    kw = dict(rate_cats=rate_cats, states=states)
    sweep = cseg.make_segmented_sweep(seg, scale_mode, **kw)
    assert sweep.instance(pm.dtype)
    inner, scal = sweep(slabs, pm)
    assert_rows(inner, scal, case, dtype, seg.inner_row)
    # the same rows as K5's plain version, node for node
    dyn = dyn_schedule(case)
    k5 = cd.make_dyn_sweep(dyn, scale_mode, tip_encoding="clv", **kw)(
        torch.from_numpy(case["clv"][:TIPS].copy()), *cd.dyn_runtime_args(
            dyn), pm)
    n = case["jtopo"].schedule.n_inner
    for lm in range(n):
        assert torch.equal(inner[seg.inner_row(lm)], k5[0][dyn.inner_row(lm)])
    walked = sweep.plain_walk(slabs, pm)
    assert torch.equal(walked[0], inner) and torch.equal(walked[1], scal)
    score = cseg.make_segmented_score(seg, tt.parent_clv, tt.child_clv,
                                      tt.edge_matrix, scale_mode, **kw)
    wvec, pw, _ = score_inputs(case, case["model"], tdtype(dtype), False)
    got = float(score(slabs, pm, wvec, pw))
    assert_logl(got, case, case["model"], dtype, False)
    assert float(score.plain_walk(slabs, pm, wvec, pw)) == got


@pytest.mark.parametrize("states,rate_cats,scale_mode,pinv,asc_mode,dtype", [
    (2, 6, SCALE_PER_SITE, True, 0, np.float64),
    (16, 3, SCALE_PER_RATE, False, 0, np.float32),
    (4, 3, SCALE_NONE, False, 1, np.float64)])
def test_make_score_unbounded_any(states, rate_cats, scale_mode, pinv,
                                  asc_mode, dtype, monkeypatch):
    """The engine's entry point on the CPU, its tree cut into segments:
    against JAX's float64 make_forward (with the asc tail where asked
    for), float64 rel 1e-12, float32 within the budget."""
    case, masks = large_case(states, rate_cats, scale_mode, dtype)
    model = dict(pinv_model(case) if pinv else case["model"],
                 asc_weights=np.arange(1.0, states + 1.0))
    jt = case["jtopo"]._replace(asc_mode=asc_mode)
    tt = case["ttopo"]._replace(asc_mode=asc_mode)
    monkeypatch.setattr(cd, "SCRATCH_BUDGET", DYN_ROWS * SITES * 4 * (
        rate_cats * states + rate_cats))
    score = tev.make_score_unbounded(tt, rate_cats, states, masks,
                                     use_pinv=pinv, device="cpu")
    assert len(score.dyn.segments) > 1 and score.kernel.any
    assert score.kernel.tip_encoding == ("chars" if states <= 4 else "masks")
    got = float(score(model_from_numpy(model, "cpu", tdtype(dtype))))
    want = jax_logl(case, model)
    if asc_mode:
        jm = jax_model({k: (v.astype(np.float64) if v.dtype.kind == "f"
                            else v) for k, v in model.items()})
        want += float(jev.make_asc_tail(jt, rate_cats, states)(
            jm, jev._pmatrices(jm, jt, jnp.float64)))
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=F64_RTOL)
    else:
        assert_in_budget(got, want)


def test_dyn_score_table_swap_any():
    """One 16-state, three-rate make_dyn_score instance (``dynamic_edge``)
    scores two topologies built with matching envelope floors by a swap of
    their tables, in float64; each result equals a fresh build's, and the
    first JAX's float64 make_forward (rel 1e-12)."""
    case, masks = large_case(16, 3, SCALE_PER_RATE, np.float32)
    c, s = 3, 16
    newicks = [case["newick"],
               _random_tree_newick(TIPS, np.random.default_rng(16))]

    def build(newick, floors):
        topo, branches = tev.topology_from_tree(
            tut.parse_newick_string(newick), SITES)
        return topo, branches, cd.build_dyn_schedule(
            topo.schedule, rate_cats=c, states=s, max_rows=DYN_ROWS,
            ensure_rows=[topo.parent_clv, topo.child_clv], **floors)

    probes = [build(n, {})[2] for n in newicks]
    floors = dict(
        min_r_tip=max(p.r_tip for p in probes) + 1,
        min_r_imp=max(p.r_imp for p in probes) + 1,
        min_r_loc=max(p.r_loc for p in probes),
        min_segments=max(len(p.segments) for p in probes) + 1,
        min_r_exp=max(cd._export_tables(p)[2] for p in probes) + 1)
    built = [build(n, floors) for n in newicks]
    tp = torch.from_numpy(masks.view(np.int32))
    topo0, _, dyn0 = built[0]
    kw = dict(rate_cats=c, states=s, tip_encoding="masks")
    shared = cd.make_dyn_score(dyn0, topo0.parent_clv, topo0.child_clv,
                               topo0.edge_matrix, dynamic_edge=True, **kw)
    for k, (topo, branches, dyn) in enumerate(built):
        # the case's own tree keeps its (float32) lengths
        model = (case["model"] if k == 0 else
                 dict(case["model"], branch_lengths=np.asarray(branches)))
        tm = model_from_numpy(model, "cpu", torch.float64)
        pm = tev._pmatrices(tm, topo, torch.float64, torch.as_tensor(
            topo.matrix_indices, dtype=torch.long))
        wvec = cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"])
        tables, m_g, exp_t, imp_src, slot_plan = cd.dyn_swap_args(dyn)
        got = float(shared(
            tp, tables, m_g, exp_t, pm, wvec, tm["pattern_weights"],
            eval_locs=torch.from_numpy(cd.dyn_eval_locs(
                dyn, topo.parent_clv, topo.child_clv)),
            edge_matrix_idx=torch.tensor(topo.edge_matrix), imp_src=imp_src,
            slot_plan=slot_plan, tip_globals=cd.dyn_tip_globals(dyn)))
        fresh = float(cd.make_dyn_score(
            dyn, topo.parent_clv, topo.child_clv, topo.edge_matrix, **kw)(
            tp, *cd.dyn_score_args(dyn), pm, wvec, tm["pattern_weights"]))
        assert got == fresh
        if k == 0:  # the case's own tree
            np.testing.assert_allclose(got, jax_logl(case, case["model"]),
                                       rtol=F64_RTOL)


def test_segmented_vs_jax_interpret():
    """K3 and K4 at two states, six rates, per-rate scaling, float32,
    against JAX's make_segmented_sweep / make_segmented_score (interpret
    mode, its "mxu" layout, the port's) on the same cut, with JAX's
    ``block_sites``."""
    from libpll_tpu.ops import clv_pallas as cp

    case, _ = large_case(2, 6, SCALE_PER_RATE, np.float32, tips=8)
    jt, tt = case["jtopo"], case["ttopo"]
    kw = dict(rate_cats=6, states=2, block_sites=SITES)
    tips = jt.schedule.tips
    jseg = cps.build_segmented_schedule(
        jt.schedule, max_rows=5, ensure_rows=[jt.parent_clv, jt.child_clv],
        rate_cats=6, states=2)
    seg = seg_schedule(case, 5)
    assert len(jseg.segments) == len(seg.segments)
    jm = jax_model(case["model"])
    jpm = jev._pmatrices(jm, jt, jnp.float32)
    jslabs = cps.pack_tips_segmented(jnp.asarray(case["clv"][:tips]), jseg,
                                     "mxu")
    j_inner, j_scal = cps.make_segmented_sweep(
        jseg, SCALE_PER_RATE, impl="mxu", interpret=True, **kw)(jslabs, jpm)
    pm = port_pmatrix(case, torch.float32)
    slabs = cseg.pack_tips_segmented(case["clv"][:tips], seg)
    inner, scal = cseg.make_segmented_sweep(seg, SCALE_PER_RATE, **kw)(
        slabs, pm)
    assert_f32_sweep_agrees(inner, scal,
                            np.asarray(j_inner).reshape(inner.shape),
                            np.asarray(j_scal))
    want = float(cps.make_segmented_score(
        jseg, jt.parent_clv, jt.child_clv, jt.edge_matrix, SCALE_PER_RATE,
        impl="mxu", interpret=True, **kw)(
        jslabs, jpm, cp.pack_weight_vec(jm["freqs_pc"], jm["rate_weights"],
                                        "mxu"),
        jm["pattern_weights"][None, :]))
    wvec, pw, _ = score_inputs(case, case["model"], torch.float32, False)
    got = float(cseg.make_segmented_score(
        seg, tt.parent_clv, tt.child_clv, tt.edge_matrix, SCALE_PER_RATE,
        **kw)(slabs, pm, wvec, pw))
    assert_in_budget(got, want, jax_logl(case, case["model"]))


def test_large_alphabet_guards():
    """Masks above 31 states raise in the dyn tier and in
    make_score_unbounded, as JAX's packers raise; a row wider than a
    block's shared memory gets JAX's floor of segment rows; the
    any-alphabet pools are never negative."""
    case, _ = large_case(16, 3, SCALE_PER_SITE, np.float64)
    dyn = dyn_schedule(case)
    with pytest.raises(EinvalError, match="31 bits"):
        cd.make_dyn_sweep(dyn, rate_cats=3, states=32, tip_encoding="masks")
    wide = np.full((TIPS, SITES), 1 << 31, np.uint32)
    with pytest.raises(ValueError, match="31 bits"):
        jev.make_score_unbounded(case["jtopo"], 3, 32, wide)
    with pytest.raises(EinvalError, match="31 bits"):
        tev.make_score_unbounded(case["ttopo"], 3, 32, wide, device="cpu")
    # 61 states at eight rates in float64: no row fits a block
    assert cseg.seg_local_rows(8, 61, torch.float64) == \
        cseg.FLOOR_LOCAL_ROWS
    assert cseg.seg_max_rows(8, 61, torch.float64) == 9
    assert cd.any_pool_cap(8, 61, torch.float64, 8) == 0
    assert cd.any_pool_cap(4, 16, torch.float32, 1) == 4
    assert cseg.any_shared_slots(5, 4, 16, torch.float32, 1) == 3
    sweep = cd.make_dyn_sweep(dyn, rate_cats=8, states=61)
    lay = sweep.layout(torch.float64)
    assert lay.pools == (0,) * len(dyn.segments)
    assert lay.spills == int((sweep.plan.slots >= 0).sum())
    for s, c in ((4, 3), (20, 5), (16, 4), (2, 1), (64, 8)):
        assert cseg.any_instance(s, c) and cd.make_dyn_sweep(
            dyn, rate_cats=c, states=s).any
    for s, c in ((4, 4), (20, 8), (4, 1)):
        assert not cseg.any_instance(s, c)


# (rates, states, dtype, counter rows, pool cap, bytes past the pool, warps,
# rates a warp) of the dyn tier's any-alphabet block (csrc/clv_dyn_any.cu)
ANY_LAYOUTS = [
    (4, 16, torch.float32, 1, 4, 16384, 4, 1),    # GT16, per site
    (4, 16, torch.float32, 4, 4, 16384, 4, 1),    # GT16, per rate
    (8, 61, torch.float64, 8, 0, 3072, 8, 1),     # no slot fits: all spill
    (2, 61, torch.float32, 1, 1, 512, 2, 1),      # P-matrices through L1
    (8, 12, torch.float64, 1, 1, 65536, 8, 1),    # the largest rings
    (10, 5, torch.float64, 10, 4, 10240, 5, 2),   # two rates a warp
    (9, 7, torch.float32, 1, 8, 5120, 5, 2),      # a warp with one rate
    (40, 64, torch.float64, 40, 0, 15360, 8, 5),  # the root's exchange
    (1, 16, torch.float32, 1, 2, 4096, 1, 1),     # one warp a block
]


@pytest.mark.parametrize("c,s,dtype,srows,cap,tail,warps,per",
                         ANY_LAYOUTS)
def test_dyn_any_layout(c, s, dtype, srows, cap, tail, warps, per):
    """The any-alphabet K5/K6 block's sizes: the pool cap beside the
    warps' rings (or the root's exchange) within the budget of 16 warps
    an SM (never negative), the warps; the P-matrices as the kernel reads
    them, transposed and zero-padded to [R, R] at S <= 16 (rows padded to
    16 bytes above)."""
    assert cd.any_pool_cap(c, s, dtype, srows) == cap
    assert cd.any_tail_bytes(c, s, dtype) == tail
    assert cd.any_warps(c) == (warps, per)
    assert warps * per >= c > (warps - 1) * per
    budget = cd.any_pool_budget(c)
    assert (ab.ANY_SM_WARPS // warps or 1) * (
        budget + 1024 + cd.ANY_STATIC_SMEM) <= 233472
    used = cap * cd.any_slot_bytes(c, s, dtype, srows) + tail
    assert used <= budget or cap == 0
    assert used + cd.any_slot_bytes(c, s, dtype, srows) > budget
    pm = torch.from_numpy(np.random.default_rng(s).random(
        (3, c, s, s))).to(dtype)
    kpm = cd.any_kernel_pmatrix(pm)
    r = cd.any_bound(s)
    if r <= 16:
        assert kpm.shape == (3, c, r, r) and kpm.is_contiguous()
        assert torch.equal(kpm[..., :s, :s], pm.transpose(-1, -2))
        assert not kpm[..., s:, :].any() and not kpm[..., :, s:].any()
    else:
        assert torch.equal(kpm, cf.pad_rows(pm))
