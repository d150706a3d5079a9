"""K5 (dyn sweep), K6 (dyn score) and ``make_score_unbounded`` of the port
against the JAX package, on the same numpy inputs.

On the CPU each wrapper runs its plain version, which follows the same
segment tables the kernel reads (imports through the export tables or
``imp_src``, tips through ``tip_globals``).  The JAX side runs its Pallas
kernels as its own tests do (``interpret=True``), or its XLA forward.

Tolerances: float64 logL rel 1e-12 against the JAX ``make_forward``,
scalers exact, CLVs rel 1e-12; float32 logL within 2e-6·|logL| + 5e-3 of
the float64 truth and of the JAX float32 kernel, scalers at >= 99.9% of
entries and CLVs at rtol 1e-5 of each node's site block where they agree
(``test_torch_ops.assert_f32_sweep_agrees``).  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.io.maps import tipmask_to_clv
from libpll_tpu.ops import clv_pallas as cp
from libpll_tpu.ops import clv_pallas_dyn as jcd
from libpll_tpu.ops.sweep import make_level_sweep as j_sweep
from libpll_tpu.tree import utree as jut

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import clv_dyn as cd
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                              SCALE_PER_SITE)

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_torch_fused import (IUPAC_POOL, assert_in_budget, f64_truth,
                              port_tips)
from test_torch_ops import (assert_f32_sweep_agrees, jax_model, make_case,
                            port_pmatrix)

F64_RTOL = 1e-12
SITES = 128
# protein pool: single states, B = D|N, Z = E|Q, X/gap (multi-bit codes)
PROTEIN_POOL = np.array([1 << k for k in range(20)]
                        + [(1 << 2) | (1 << 11), (1 << 3) | (1 << 13),
                           (1 << 20) - 1], np.uint32)


def ambiguity_case(newick, *, seed, states=4, rate_cats=4,
                   scale_mode=SCALE_PER_SITE, dtype=np.float32, pinv=0.0):
    """make_case with multi-bit ambiguity masks as tips (IUPAC for DNA,
    B/Z/X for protein); case["clv"] holds the matching 0/1 tip CLVs."""
    case = make_case(newick, SITES, seed=seed, states=states,
                     rate_cats=rate_cats, scale_mode=scale_mode, dtype=dtype,
                     pinv=pinv)
    tips = case["jtopo"].schedule.tips
    pool = IUPAC_POOL if states == 4 else PROTEIN_POOL
    rng = np.random.default_rng(seed + 1000)
    masks = pool[rng.integers(0, len(pool), (tips, SITES))]
    for i in range(tips):
        case["clv"][i] = np.asarray(tipmask_to_clv(masks[i], states)).T[None]
    if pinv:
        case["model"]["invariant"][:24] = np.arange(24) % states
    return case, masks


def schedules(case, max_rows, chunk, **floors):
    """(JAX, port) dyn schedules of the case's tree, edge ensured."""
    jt, tt = case["jtopo"], case["ttopo"]
    c, s = case["model"]["freqs_pc"].shape
    kw = dict(rate_cats=c, states=s, max_rows=max_rows, chunk=chunk,
              ensure_rows=[jt.parent_clv, jt.child_clv], **floors)
    return (jcd.build_dyn_schedule(jt.schedule, **kw),
            cd.build_dyn_schedule(tt.schedule, **kw))


def jax_slabs(case, masks, jdyn, encoding, impl):
    if encoding == "chars":
        return jcd.pack_tipchars_dyn(masks, jdyn)
    if encoding == "masks":
        return jcd.pack_tipmasks_dyn(masks, jdyn)
    tips = case["jtopo"].schedule.tips
    return jcd.pack_tips_dyn(jnp.asarray(case["clv"][:tips]), jdyn, impl)


def row_budget(monkeypatch, rows, rate_cats, states):
    """Shrink the device-memory budget of make_score_unbounded's schedule
    to ``rows`` rows at SITES sites, so that small trees cut into
    segments."""
    monkeypatch.setattr(cd, "SCRATCH_BUDGET",
                        rows * SITES * 4 * (rate_cats * states + rate_cats))


def score_vectors(case, dtype, pinv):
    """(weight_vec, pattern_weights, inv_add) of the port, as the engine
    builds them."""
    tm = model_from_numpy(case["model"], "cpu", dtype)
    if pinv:
        wvec, inv_add = tev._pinv_score_inputs(tm, dtype)
    else:
        wvec = cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"])
        inv_add = None
    return wvec, tm["pattern_weights"], inv_add


def f32_reference(case, pinv):
    """The float64 truth; under +I the JAX float32 make_forward instead.
    The reference adds the invariant-site term unscaled
    (``src/core_likelihood.c:960-978``), so once float32 scaling fires at
    an invariant site the float32 logL is, by the model's definition, not
    the float64 one."""
    if not pinv:
        return f64_truth(case)
    return float(jev.make_forward(case["jtopo"])(
        jax_model(case["model"]), jnp.asarray(case["clv"]),
        jnp.asarray(case["scalers"]))[0])


@pytest.mark.parametrize("encoding,scale_mode,tree", [
    ("clv", SCALE_PER_SITE, "random24"),
    ("chars", SCALE_PER_RATE, "caterpillar48"),
    ("masks", SCALE_PER_SITE, "caterpillar48"),
    ("masks", SCALE_PER_RATE, "protein12")])
def test_dyn_sweep_plain_vs_jax_f32(encoding, scale_mode, tree):
    """Plain K5 vs the JAX dyn sweep (interpret mode), float32, segment by
    segment; inner rows compared in the segment-major order both use."""
    states, cats, max_rows, chunk = 4, 4, 20, 8
    if tree == "random24":
        newick = _random_tree_newick(24, np.random.default_rng(24))
        max_rows = 24
    elif tree == "caterpillar48":
        newick = _caterpillar_newick(48)
    else:
        newick = _random_tree_newick(12, np.random.default_rng(2))
        states, cats, max_rows, chunk = 20, 2, 12, 4
    case, masks = ambiguity_case(newick, seed=21, states=states,
                                 rate_cats=cats, scale_mode=scale_mode)
    jdyn, tdyn = schedules(case, max_rows, chunk)
    assert len(tdyn.segments) > 1
    impl = "vpu" if states == 4 else "mxu"
    jpm = jev._pmatrices(jax_model(case["model"]), case["jtopo"], jnp.float32)
    sweep = jcd.make_dyn_sweep(jdyn, scale_mode, rate_cats=cats,
                               states=states, tip_encoding=encoding,
                               impl=impl, interpret=True)
    j_inner, j_scal = sweep(jax_slabs(case, masks, jdyn, encoding, impl),
                            *jcd.dyn_runtime_args(jdyn), jpm)
    got, got_scal = cd.make_dyn_sweep(
        tdyn, scale_mode, rate_cats=cats, states=states,
        tip_encoding=encoding)(port_tips(case, masks, encoding),
                               *cd.dyn_runtime_args(tdyn),
                               port_pmatrix(case, torch.float32))
    assert tuple(got_scal.shape) == tuple(j_scal.shape)
    if tree == "caterpillar48":
        assert np.asarray(j_scal).sum() > 1000  # scaling fires
    assert_f32_sweep_agrees(got, got_scal,
                            cp.unpack_clv(j_inner, cats, states, impl),
                            j_scal)


@pytest.mark.parametrize("scale_mode", [SCALE_NONE, SCALE_PER_SITE,
                                        SCALE_PER_RATE])
def test_dyn_sweep_plain_f64(scale_mode):
    """float64, tiny tip values where scaling is on, so that it fires
    (without scaling they would sink into subnormals): plain K5 equals the
    JAX level sweep through ``dyn.inner_row`` (scalers exact, CLVs rel
    1e-12), and the JAX dyn sweep for per-rate scaling."""
    case = make_case(_random_tree_newick(24, np.random.default_rng(6)),
                     SITES, seed=6, scale_mode=scale_mode,
                     tiny=scale_mode != SCALE_NONE)
    jt, tips = case["jtopo"], case["jtopo"].schedule.tips
    jdyn, tdyn = schedules(case, 10, 4)
    jpm = jev._pmatrices(jax_model(case["model"]), jt, jnp.float64)
    want_clv, want_scal = j_sweep(jt.schedule, scale_mode)(
        jnp.asarray(case["clv"]), jnp.asarray(case["scalers"]), jpm)
    want_clv, want_scal = np.asarray(want_clv), np.asarray(want_scal)
    got, got_scal = cd.make_dyn_sweep(tdyn, scale_mode, rate_cats=4,
                                      states=4)(
        torch.from_numpy(case["clv"][:tips]), *cd.dyn_runtime_args(tdyn),
        port_pmatrix(case, torch.float64))
    got, got_scal = got.numpy(), got_scal.numpy()
    if scale_mode != SCALE_NONE:
        assert got_scal.sum() > 0
    for r in range(tdyn.n_inner):
        row = tdyn.inner_row(r)
        np.testing.assert_array_equal(got_scal[row], want_scal[r])
        np.testing.assert_allclose(got[row], want_clv[tips + r],
                                   rtol=F64_RTOL, atol=0)
    np.testing.assert_array_equal(got_scal[-1], 0)
    if scale_mode == SCALE_PER_RATE:
        j_inner, j_scal = jcd.make_dyn_sweep(
            jdyn, scale_mode, rate_cats=4, states=4, interpret=True)(
            jcd.pack_tips_dyn(jnp.asarray(case["clv"][:tips]), jdyn, "vpu"),
            *jcd.dyn_runtime_args(jdyn), jpm)
        np.testing.assert_array_equal(got_scal, np.asarray(j_scal))
        np.testing.assert_allclose(
            got, np.asarray(cp.unpack_clv(j_inner, 4, 4, "vpu")),
            rtol=F64_RTOL, atol=0)


@pytest.mark.parametrize("tree,scale_mode,pinv", [
    ("random160", SCALE_PER_SITE, False),
    ("caterpillar48", SCALE_PER_RATE, True),
    ("caterpillar48", SCALE_PER_SITE, True)])
def test_dyn_score_plain_vs_jax_f32(tree, scale_mode, pinv):
    """Plain K6 vs the JAX dyn score (interpret mode) and the float64
    truth, chars tips with IUPAC codes; the 160-taxon tree is the branchy
    multi-segment case of ``test_clv_pallas_dyn.py:294``."""
    if tree == "random160":
        newick = _random_tree_newick(160, np.random.default_rng(1024))
        max_rows, chunk = 40, 16
    else:
        newick, max_rows, chunk = _caterpillar_newick(48), 20, 8
    case, masks = ambiguity_case(newick, seed=31, scale_mode=scale_mode,
                                 pinv=0.2 if pinv else 0.0)
    jt, tt = case["jtopo"], case["ttopo"]
    jdyn, tdyn = schedules(case, max_rows, chunk)
    if tree == "random160":
        assert len(tdyn.segments) >= 8 and tdyn.r_imp >= 2
    jm = jax_model(case["model"])
    jpm = jev._pmatrices(jm, jt, jnp.float32)
    jscore = jcd.make_dyn_score(jdyn, jt.parent_clv, jt.child_clv,
                                jt.edge_matrix, scale_mode, rate_cats=4,
                                states=4, use_pinv=pinv, interpret=True)
    if pinv:
        jw, j_inv = jev._pinv_score_inputs(jm, "vpu", jnp.float32)
        extra = [j_inv]
    else:
        jw = cp.pack_weight_vec(jm["freqs_pc"], jm["rate_weights"], "vpu")
        extra = []
    want32 = float(jscore(jcd.pack_tipchars_dyn(masks, jdyn),
                          *jcd.dyn_score_args(jdyn), jpm, jw,
                          jm["pattern_weights"][None, :], *extra))
    score = cd.make_dyn_score(tdyn, tt.parent_clv, tt.child_clv,
                              tt.edge_matrix, scale_mode, rate_cats=4,
                              states=4, use_pinv=pinv)
    wvec, pw, inv_add = score_vectors(case, torch.float32, pinv)
    args = (cf.pack_tipchars(masks), *cd.dyn_score_args(tdyn),
            port_pmatrix(case, torch.float32), wvec, pw, inv_add)
    got = score(*args)
    assert got.dtype == torch.float64
    assert_in_budget(float(got), f32_reference(case, pinv), want32)
    partials = score(*args, return_partials=True)
    assert tuple(partials.shape) == (SITES // cd.BLOCK_SITES,)
    assert float(partials.sum()) == float(got)


@pytest.mark.parametrize("scale_mode,pinv,asc_mode", [
    (SCALE_PER_SITE, False, 0), (SCALE_PER_RATE, True, 0),
    (SCALE_PER_SITE, False, 1), (SCALE_PER_RATE, False, 3)])
def test_make_score_unbounded_f64(scale_mode, pinv, asc_mode, monkeypatch):
    """The engine in float64 on a forced multi-segment tree: rel 1e-12 of
    the JAX XLA make_forward (+ asc tail where asked for)."""
    case, masks = ambiguity_case(
        _random_tree_newick(40, np.random.default_rng(40)), seed=40,
        scale_mode=scale_mode, dtype=np.float64, pinv=0.1 if pinv else 0.0)
    jt = case["jtopo"]._replace(asc_mode=asc_mode)
    tt = case["ttopo"]._replace(asc_mode=asc_mode)
    model = dict(case["model"], asc_weights=np.asarray([2., 1., 3., 1.]))
    jm = jax_model(model)
    want = float(jev.make_forward(case["jtopo"])(
        jm, jnp.asarray(case["clv"]), jnp.asarray(case["scalers"]))[0])
    if asc_mode:
        want += float(jev.make_asc_tail(jt, 4, 4)(
            jm, jev._pmatrices(jm, jt, jnp.float64)))
    row_budget(monkeypatch, 16, 4, 4)
    score = tev.make_score_unbounded(tt, 4, 4, masks, use_pinv=pinv,
                                     device="cpu")
    assert len(score.dyn.segments) > 2 and score.kernel.tip_encoding == "chars"
    got = score(model_from_numpy(model, "cpu", torch.float64))
    assert got.dtype == torch.float64 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=F64_RTOL)


@pytest.mark.parametrize("states,scale_mode,pinv", [
    (4, SCALE_PER_SITE, True), (20, SCALE_PER_SITE, False),
    (20, SCALE_PER_RATE, False)])
def test_make_score_unbounded_vs_jax_f32(states, scale_mode, pinv,
                                        monkeypatch):
    """The engine in float32 against JAX make_score_unbounded (interpret
    mode) and the float64 truth, multi-bit ambiguity codes, DNA and
    protein (20-bit masks)."""
    case, masks = ambiguity_case(
        _random_tree_newick(12, np.random.default_rng(300 + states)),
        seed=300 + states, states=states, scale_mode=scale_mode,
        pinv=0.25 if pinv else 0.0)
    jt, tt = case["jtopo"], case["ttopo"]
    jscore = jev.make_score_unbounded(jt, 4, states, masks, use_pinv=pinv,
                                      interpret=True)
    want32 = float(jscore(jax_model(case["model"])))
    row_budget(monkeypatch, 16, 4, states)
    score = tev.make_score_unbounded(tt, 4, states, masks, use_pinv=pinv,
                                     device="cpu")
    assert len(score.dyn.segments) > 1
    assert score.kernel.tip_encoding == ("chars" if states == 4 else "masks")
    got = float(score(model_from_numpy(case["model"], "cpu", torch.float32)))
    assert_in_budget(got, f32_reference(case, pinv), want32)


def _swap_topology(newick, floors):
    """A 16-taxon tree's schedule with the given envelope floors and its
    swap data (tables, eval locs, import wiring, tip rows)."""
    ttopo, branches = tev.topology_from_tree(tut.parse_newick_string(newick),
                                             SITES)
    dyn = cd.build_dyn_schedule(
        ttopo.schedule, rate_cats=4, states=4, chunk=8, max_rows=8,
        ensure_rows=[ttopo.parent_clv, ttopo.child_clv], **floors)
    return ttopo, branches, dyn


def test_dyn_score_table_swap():
    """One make_dyn_score instance (``dynamic_edge``) scores two 16-taxon
    topologies built with matching envelope floors, by swapping tables,
    eval locs, edge matrix, ``imp_src`` and ``tip_globals``; each result
    equals a fresh build for that topology (float64, the same ops) and the
    JAX make_forward (rel 1e-12)."""
    rng = np.random.default_rng(7)
    newicks = [_random_tree_newick(16, rng), _random_tree_newick(16, rng)]
    probes = [_swap_topology(n, {})[2] for n in newicks]
    floors = dict(
        min_r_tip=max(p.r_tip for p in probes) + 2,
        min_r_imp=max(p.r_imp for p in probes) + 2,
        min_r_loc=max(p.r_loc for p in probes),
        min_segments=max(len(p.segments) for p in probes) + 1,
        min_r_exp=max(cd._export_tables(p)[2] for p in probes) + 2)
    built = [_swap_topology(n, floors) for n in newicks]
    envs = {(len(d.segments), d.r_tip, d.r_imp, d.r_loc,
             cd._export_tables(d)[2]) for _, _, d in built}
    assert len(envs) == 1 and len(built[0][2].segments) > 2

    case = make_case(newicks[0], SITES, seed=8)
    tips = case["jtopo"].schedule.tips
    masks = np.uint32(1) << np.argmax(case["clv"][:tips, 0],
                                      axis=1).astype(np.uint32)
    tp = cf.pack_tipchars(masks)
    topo0, _, dyn0 = built[0]
    shared = cd.make_dyn_score(dyn0, topo0.parent_clv, topo0.child_clv,
                               topo0.edge_matrix, rate_cats=4, states=4,
                               dynamic_edge=True)
    for newick, (topo, branches, dyn) in zip(newicks, built):
        model = dict(case["model"], branch_lengths=np.asarray(branches))
        tm = model_from_numpy(model, "cpu", torch.float64)
        idx = torch.as_tensor(topo.matrix_indices, dtype=torch.long)
        pm = tev._pmatrices(tm, topo, torch.float64, idx)
        wvec = cf.pack_weight_vec(tm["freqs_pc"], tm["rate_weights"])
        tables, m_g, exp_t, imp_src, slot_plan = cd.dyn_swap_args(dyn)
        locs = torch.from_numpy(cd.dyn_eval_locs(dyn, topo.parent_clv,
                                                 topo.child_clv))
        got = float(shared(tp, tables, m_g, exp_t, pm, wvec,
                           tm["pattern_weights"], eval_locs=locs,
                           edge_matrix_idx=torch.tensor(topo.edge_matrix),
                           imp_src=imp_src, slot_plan=slot_plan,
                           tip_globals=cd.dyn_tip_globals(dyn)))
        fresh = float(cd.make_dyn_score(
            dyn, topo.parent_clv, topo.child_clv, topo.edge_matrix,
            rate_cats=4, states=4)(tp, *cd.dyn_score_args(dyn), pm, wvec,
                                   tm["pattern_weights"]))
        assert got == fresh

        jtopo, _ = jev.topology_from_tree(jut.parse_newick_string(newick),
                                          SITES)
        clv = np.zeros((tips + jtopo.schedule.n_inner, 4, 4, SITES))
        clv[:tips] = case["clv"][:tips]
        want = float(jev.make_forward(jtopo)(
            jax_model(model), jnp.asarray(clv),
            jnp.zeros((jtopo.schedule.n_inner + 1, SITES), jnp.int32))[0])
        np.testing.assert_allclose(got, want, rtol=F64_RTOL)


def test_dyn_guards():
    case, masks = ambiguity_case(
        _random_tree_newick(10, np.random.default_rng(4)), seed=4)
    tt = case["ttopo"]
    _, tdyn = schedules(case, 8, 1)
    score = cd.make_dyn_score(tdyn, tt.parent_clv, tt.child_clv,
                              tt.edge_matrix, rate_cats=4, states=4)
    wvec, pw, _ = score_vectors(case, torch.float32, False)
    args = (cf.pack_tipchars(masks), *cd.dyn_score_args(tdyn),
            port_pmatrix(case, torch.float32), wvec, pw)
    with pytest.raises(EinvalError):  # +I input without use_pinv
        score(*args, inv_add=pw)
    with pytest.raises(EinvalError):  # eval_locs without dynamic_edge
        score(*args, eval_locs=np.zeros(4, np.int32))
    with pytest.raises(EinvalError):  # a device neither CPU nor CUDA
        score(*[a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args])
    before = (cd.DynScore.launches, cd.DynSweep.launches)
    score(*args)  # the plain version: no launch
    assert (cd.DynScore.launches, cd.DynSweep.launches) == before
    with pytest.raises(EinvalError):
        tev.make_score_unbounded(tt._replace(asc_mode=1), 4, 4, masks,
                                 use_pinv=True, device="cpu")
