"""The slot plan of the dyn kernels K5/K6 (``clv_dyn.dyn_slot_plan``) and
the plain slotted runner (``clv_dyn.plain_slotted_segment``), which
follows the kernels' pool and spill addressing with PyTorch ops on the
CPU, where no kernel runs.

  * The plan never hands a live row's place (pool slot, scratch row or
    K5's output row) to another row, at every pool size from 0 (all
    spilled) to the plan's peak, for random trees, caterpillars and the
    table-swap envelopes.
  * The slotted runner equals the plain versions bit for bit (the same
    PyTorch ops in the same order; only where rows live differs), and the
    JAX package's dyn kernels (interpret mode) within the float32 budget
    of ``tests/test_torch_dyn.py``.
  * The large configuration's schedule (10 240 taxa x 2^20 sites) needs
    13 live rows at most, the planner's own count, so DNA float32 never
    spills there.

The CUDA kernel itself is held against these plain versions on the card
by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv_pallas as cp
from libpll_tpu.ops import clv_pallas_dyn as jcd

from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import clv_dyn as cd
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                              SCALE_PER_SITE)
from libpll_tpu_torch.utils.flagship import build_flagship_topology

from test_clv_pallas import _caterpillar_newick, _random_tree_newick
from test_torch_dyn import (SITES, ambiguity_case, f32_reference, jax_slabs,
                            schedules, score_vectors)
from test_torch_fused import assert_in_budget, port_tips
from test_torch_ops import assert_f32_sweep_agrees, jax_model, port_pmatrix

CAPS = (None, 0, 1, 2)  # pool caps: the budget's, then forced spills


def _swap_floors(newicks):
    """Envelope floors under which two trees' schedules share one shape
    (as ``test_torch_dyn.test_dyn_score_table_swap`` builds them)."""
    probes = [_dyn16(n, {}) for n in newicks]
    return dict(
        min_r_tip=max(p.r_tip for p in probes) + 2,
        min_r_imp=max(p.r_imp for p in probes) + 2,
        min_r_loc=max(p.r_loc for p in probes),
        min_segments=max(len(p.segments) for p in probes) + 1,
        min_r_exp=max(cd._export_tables(p)[2] for p in probes) + 2)


def _dyn16(newick, floors):
    topo, _ = tev.topology_from_tree(tut.parse_newick_string(newick), SITES)
    return cd.build_dyn_schedule(
        topo.schedule, rate_cats=4, states=4, chunk=8, max_rows=8,
        ensure_rows=[topo.parent_clv, topo.child_clv], **floors)


def _tree_schedule(tree):
    """(dyn, edge state rows of the final segment) of a named tree."""
    if tree == "swap16":
        rng = np.random.default_rng(7)
        newicks = [_random_tree_newick(16, rng), _random_tree_newick(16, rng)]
        newick, floors, max_rows = newicks[1], _swap_floors(newicks), 8
    else:
        kind, size, max_rows = {
            "random16/8": ("random", 16, 8), "random40/16": ("random", 40, 16),
            "random160/40": ("random", 160, 40),
            "random64/one": ("random", 64, None),
            "caterpillar48/12": ("caterpillar", 48, 12),
            "caterpillar48/one": ("caterpillar", 48, None)}[tree]
        newick = (_caterpillar_newick(size) if kind == "caterpillar" else
                  _random_tree_newick(size, np.random.default_rng(size)))
        floors = {}
    topo, _ = tev.topology_from_tree(tut.parse_newick_string(newick), SITES)
    dyn = cd.build_dyn_schedule(
        topo.schedule, rate_cats=4, states=4, chunk=8,
        max_rows=max_rows or 1 << 20,
        ensure_rows=[topo.parent_clv, topo.child_clv], **floors)
    ends = [cd._locate(dyn, lm, True)[0]
            for lm in (topo.parent_clv, topo.child_clv)]
    return dyn, ends


def _assert_never_overwritten(dyn, plan, pool, sweep, keep_final):
    """Walk every segment's ops as the kernel places rows at ``pool``
    slots: each child read finds its own row where the plan put it, and
    every row kept to the end (exports, the edge's rows) is still there."""
    g = cd._rows(dyn)
    imported = {}
    if not sweep:
        for s in dyn.segments:
            for (a, b) in s.imports:
                imported.setdefault(a, set()).add(b)
    last = len(dyn.segments) - 1
    for si, seg in enumerate(dyn.segments):
        slots = plan.slots[si]
        assert (slots[:seg.n_local] >= 0).all()
        assert (slots[seg.n_local:] == -1).all()
        assert slots.max(initial=-1) < plan.n_slots[si]

        def place(l):
            slot = int(slots[l])
            if slot < pool:
                return ("pool", slot)
            return ("device", l if sweep else slot - pool)

        held = {}
        for (p, c1, c2, s1, s2, _) in seg.table.tolist():
            if p == g.trash_state:
                continue
            for ref, base in ((c1, g.loc0), (c2, g.loc0), (s1, g.r_imp),
                              (s2, g.r_imp)):
                if base <= ref < base + g.r_loc:
                    assert held.get(place(ref - base)) == ref - base, (
                        si, ref)
            held[place(p - g.loc0)] = p - g.loc0
        keep = set(imported.get(si, ()))
        if si == last:
            keep |= (set(range(seg.n_local)) if keep_final is None
                     else set(keep_final))
        for l in keep:
            assert held[place(l)] == l, (si, l)


@pytest.mark.parametrize("kind", ["K5", "K6", "K6 dynamic_edge"])
@pytest.mark.parametrize("tree", [
    "random16/8", "random40/16", "random160/40", "random64/one",
    "caterpillar48/12", "caterpillar48/one", "swap16"])
def test_slot_plan_never_overwrites_a_live_row(tree, kind):
    """At every pool size from 0 (every row spilled) to the plan's peak,
    no slot, scratch row or output row is reused while its row lives."""
    dyn, ends = _tree_schedule(tree)
    g = cd._rows(dyn)
    if kind == "K5":
        keep, plan = (), cd.dyn_slot_plan(dyn, final_keep=(), exports=False)
        assert plan.slots.tolist() == cd.make_dyn_sweep(
            dyn, rate_cats=4, states=4).plan.slots.tolist()
    elif kind == "K6":
        keep = [r - g.loc0 for r in ends if g.loc0 <= r < g.trash_state]
        plan = cd.dyn_slot_plan(dyn, final_keep=keep)
    else:
        keep, plan = None, cd.dyn_slot_plan(dyn)
        assert np.array_equal(cd.dyn_swap_args(dyn)[4].numpy(), plan.slots)
    peak = max(plan.n_slots)
    for pool in range(peak + 1):
        _assert_never_overwritten(dyn, plan, pool, kind == "K5", keep)
        assert plan.spills(pool) == int((plan.slots >= pool).sum())
        assert plan.scratch_rows(pool) == max(0, peak - pool)
    assert plan.spills(peak) == 0


def _case(states, enc, scale_mode, dtype, pinv=False):
    """A small case, its port schedule and tips: DNA on a multi-segment
    random tree (CLV tips), a caterpillar whose float32 scaling fires
    (chars), protein on one segment (masks)."""
    newick, max_rows = {
        "clv": (_random_tree_newick(40, np.random.default_rng(40)), 16),
        "chars": (_caterpillar_newick(48), 20),
        "masks": (_random_tree_newick(12, np.random.default_rng(12)),
                  1 << 20)}[enc]
    case, masks = ambiguity_case(newick, seed=50 + states, states=states,
                                 scale_mode=scale_mode, dtype=dtype,
                                 pinv=0.2 if pinv else 0.0)
    _, tdyn = schedules(case, max_rows, 8)
    return case, masks, tdyn


ENCODINGS = [(4, "clv"), (4, "chars"), (20, "masks")]
SCALES = [SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale_mode", SCALES)
@pytest.mark.parametrize("states,enc", ENCODINGS)
def test_plain_slotted_sweep_equals_plain(states, enc, scale_mode, dtype):
    """K5's slotted runner equals ``DynSweep.plain`` bit for bit, at the
    budget's pool and at pools that force spills to the output rows."""
    case, masks, tdyn = _case(states, enc, scale_mode, dtype)
    sweep = cd.make_dyn_sweep(tdyn, scale_mode, rate_cats=4, states=states,
                              tip_encoding=enc)
    args = (port_tips(case, masks, enc), *cd.dyn_runtime_args(tdyn),
            port_pmatrix(case, torch.from_numpy(np.zeros(0, dtype)).dtype))
    want_clv, want_scal = sweep.plain(*args)
    spilled = 0
    for cap in CAPS:
        sweep.slot_cap = cap
        got_clv, got_scal = sweep.plain_slotted(*args)
        assert torch.equal(got_clv, want_clv) and torch.equal(got_scal,
                                                              want_scal)
        spilled += sweep.layout(args[-1].dtype).spills
    assert spilled > 0


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scale_mode", SCALES)
@pytest.mark.parametrize("states,enc", ENCODINGS)
def test_plain_slotted_score_equals_plain(states, enc, scale_mode, dtype):
    """K6's slotted runner equals ``DynScore.plain`` bit for bit, partials
    included, at the budget's pool and at pools that force spills to the
    scratch; +I on DNA."""
    pinv = states == 4
    case, masks, tdyn = _case(states, enc, scale_mode, dtype, pinv)
    tt = case["ttopo"]
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    score = cd.make_dyn_score(tdyn, tt.parent_clv, tt.child_clv,
                              tt.edge_matrix, scale_mode, rate_cats=4,
                              states=states, tip_encoding=enc,
                              use_pinv=pinv)
    wvec, pw, inv_add = score_vectors(case, tdtype, pinv)
    args = (port_tips(case, masks, enc), *cd.dyn_score_args(tdyn),
            port_pmatrix(case, tdtype), wvec, pw, inv_add)
    want = score.plain(*args, return_partials=True)
    for cap in CAPS:
        score.slot_cap = cap
        lay = score.layout(tdtype)
        if cap == 0:
            assert lay.spills == tdyn.n_inner and lay.scratch == max(
                score.plan.n_slots)
        assert torch.equal(score.plain_slotted(*args, return_partials=True),
                           want)
    assert float(score.plain_slotted(*args)) == float(score.plain(*args))


@pytest.mark.parametrize("cap", CAPS)
def test_plain_slotted_table_swap(cap):
    """One ``dynamic_edge`` instance scores two topologies through their
    swap data, slot plans included: the slotted runner equals the plain
    version and a fresh instance's slotted run bit for bit (float64)."""
    rng = np.random.default_rng(7)
    newicks = [_random_tree_newick(16, rng), _random_tree_newick(16, rng)]
    floors = _swap_floors(newicks)
    dyns = [_dyn16(n, floors) for n in newicks]
    shared = None
    for newick, dyn in zip(newicks, dyns):
        case, masks = ambiguity_case(newick, seed=9, dtype=np.float64)
        tt = case["ttopo"]
        if shared is None:
            shared = cd.make_dyn_score(dyn, tt.parent_clv, tt.child_clv,
                                       tt.edge_matrix, rate_cats=4, states=4,
                                       dynamic_edge=True)
        shared.slot_cap = cap
        tables, m_g, exp_t, imp_src, plan = cd.dyn_swap_args(dyn)
        wvec, pw, _ = score_vectors(case, torch.float64, False)
        pm = port_pmatrix(case, torch.float64)
        tp = cf.pack_tipchars(masks)
        data = dict(eval_locs=torch.from_numpy(cd.dyn_eval_locs(
                        dyn, tt.parent_clv, tt.child_clv)),
                    edge_matrix_idx=torch.tensor(tt.edge_matrix),
                    imp_src=imp_src, slot_plan=plan,
                    tip_globals=cd.dyn_tip_globals(dyn))
        lay = shared.layout(torch.float64, plan)
        assert lay.pools[0] == min(dyn.r_loc, lay.pools[0])
        assert lay.scratch == dyn.r_loc - lay.pools[0]
        got = float(shared.plain_slotted(tp, tables, m_g, exp_t, pm, wvec,
                                         pw, **data))
        assert got == float(shared.plain(tp, tables, m_g, exp_t, pm, wvec,
                                         pw, **data))
        fresh = cd.make_dyn_score(dyn, tt.parent_clv, tt.child_clv,
                                  tt.edge_matrix, rate_cats=4, states=4)
        fresh.slot_cap = cap
        assert got == float(fresh.plain_slotted(
            tp, *cd.dyn_score_args(dyn), pm, wvec, pw))


def test_plain_slotted_vs_jax_f32():
    """The slotted runners with spilling pools against the JAX dyn sweep
    and dyn score (interpret mode) and the float64 truth, float32: a
    caterpillar cut into segments whose scaling fires, per-rate counters
    for K5, per-site with +I for K6."""
    case, masks = ambiguity_case(_caterpillar_newick(48), seed=21,
                                 scale_mode=SCALE_PER_RATE)
    jdyn, tdyn = schedules(case, 20, 8)
    jpm = jev._pmatrices(jax_model(case["model"]), case["jtopo"],
                         jnp.float32)
    j_inner, j_scal = jcd.make_dyn_sweep(
        jdyn, SCALE_PER_RATE, rate_cats=4, states=4, tip_encoding="chars",
        impl="vpu", interpret=True)(
            jax_slabs(case, masks, jdyn, "chars", "vpu"),
            *jcd.dyn_runtime_args(jdyn), jpm)
    sweep = cd.make_dyn_sweep(tdyn, SCALE_PER_RATE, rate_cats=4, states=4,
                              tip_encoding="chars")
    sweep.slot_cap = 0
    got, got_scal = sweep.plain_slotted(
        cf.pack_tipchars(masks), *cd.dyn_runtime_args(tdyn),
        port_pmatrix(case, torch.float32))
    assert np.asarray(j_scal).sum() > 1000  # scaling fires
    assert_f32_sweep_agrees(got, got_scal,
                            cp.unpack_clv(j_inner, 4, 4, "vpu"), j_scal)

    case, masks = ambiguity_case(
        _random_tree_newick(160, np.random.default_rng(1024)), seed=31,
        pinv=0.2)
    jt, tt = case["jtopo"], case["ttopo"]
    jdyn, tdyn = schedules(case, 40, 16)
    jm = jax_model(case["model"])
    jw, j_inv = jev._pinv_score_inputs(jm, "vpu", jnp.float32)
    want32 = float(jcd.make_dyn_score(
        jdyn, jt.parent_clv, jt.child_clv, jt.edge_matrix, SCALE_PER_SITE,
        rate_cats=4, states=4, use_pinv=True, interpret=True)(
            jcd.pack_tipchars_dyn(masks, jdyn), *jcd.dyn_score_args(jdyn),
            jev._pmatrices(jm, jt, jnp.float32), jw,
            jm["pattern_weights"][None, :], j_inv))
    score = cd.make_dyn_score(tdyn, tt.parent_clv, tt.child_clv,
                              tt.edge_matrix, SCALE_PER_SITE, rate_cats=4,
                              states=4, use_pinv=True)
    score.slot_cap = 1
    assert score.layout(torch.float32).spills > 0
    got = float(score.plain_slotted(
        cf.pack_tipchars(masks), *cd.dyn_score_args(tdyn),
        port_pmatrix(case, torch.float32),
        *score_vectors(case, torch.float32, True)))
    assert_in_budget(got, f32_reference(case, True), want32)


def _flagship_plans(tips, sites, seed, max_rows=None):
    topo, _ = build_flagship_topology(tips, sites, seed=seed)
    dyn = cd.build_dyn_schedule(
        topo.schedule, rate_cats=4, states=4, sites=sites, max_rows=max_rows,
        ensure_rows=[topo.parent_clv, topo.child_clv])
    score = cd.make_dyn_score(dyn, topo.parent_clv, topo.child_clv,
                              topo.edge_matrix, rate_cats=4, states=4)
    sweep = cd.make_dyn_sweep(dyn, rate_cats=4, states=4)
    return dyn, score.plan, sweep.plan


def test_large_schedule_peak_live_rows():
    """make_score_unbounded's schedule at the large configuration (seed 0,
    cut at dyn_max_rows' 204 rows): 127 segments whose plan needs 13 live
    rows at most (median 8), far under the float32 DNA pool cap of 47
    slots, so no row spills and no scratch is allocated."""
    dyn, k6, k5 = _flagship_plans(10240, 1 << 20, 0)
    assert (len(dyn.segments), dyn.r_loc) == (127, 101)
    assert max(k6.n_slots) == 13 and int(np.median(k6.n_slots)) == 8
    assert max(k5.n_slots) == 13
    cap = cd.pool_cap(4, 4, torch.float32, 1)
    assert cap == 47 and k6.spills(cap) == 0 and k6.scratch_rows(cap) == 0


def test_mid_schedule_peak_live_rows():
    """The mid configuration (4 096 x 8 192, seed 1): one K6 segment of
    4 094 ops needs 19 slots, K5 cut at 1 024 rows 14; the per-rate pool
    cap (40 slots) holds both."""
    dyn, k6, _ = _flagship_plans(4096, 8192, 1)
    assert len(dyn.segments) == 1 and max(k6.n_slots) == 19
    dyn, _, k5 = _flagship_plans(4096, 8192, 1, max_rows=1024)
    assert len(dyn.segments) == 11 and max(k5.n_slots) == 14
    assert cd.pool_cap(4, 4, torch.float32, 4) == 40


def test_pool_caps_and_guards():
    """The pool cap per dtype, S and counters; a cap over a block's
    shared memory raises before anything runs."""
    assert cd.pool_cap(4, 20, torch.float32, 1) == 10
    assert cd.pool_cap(4, 4, torch.float64, 1) == 22
    assert cd.pool_bytes(13, 4, 4, torch.float32, 1) == 13 * 32 * 68
    assert cd.pool_bytes(3, 4, 20, torch.float32, 4) == 3 * 32 * 336
    assert cd.stage_bytes(4, 4, torch.float32) == 8192
    assert cd.stage_bytes(4, 20, torch.float32) == 0
    case, masks, tdyn = _case(4, "chars", SCALE_PER_SITE, np.float32)
    tt = case["ttopo"]
    score = cd.make_dyn_score(tdyn, tt.parent_clv, tt.child_clv,
                              tt.edge_matrix, rate_cats=4, states=4)
    score.slot_cap = 1000
    with pytest.raises(EinvalError):
        score.layout(torch.float32)
    score.slot_cap = -1
    with pytest.raises(EinvalError):
        score.layout(torch.float32)


def test_fold_tile_partials_order():
    """Four 32-site partials make one 128-site partial, added left to
    right as the first fused kernel added its four warp sums; ragged ends
    pad with zeros."""
    rng = np.random.default_rng(0)
    tiles = torch.from_numpy(rng.standard_normal(12) * 1e6)
    got = cd.fold_tile_partials(tiles, 300)
    want = [0.0 + tiles[4 * b] + tiles[4 * b + 1] + tiles[4 * b + 2]
            + tiles[4 * b + 3] for b in range(3)]
    assert got.tolist() == [float(w) for w in want]
    with pytest.raises(RuntimeError):
        cd.fold_tile_partials(tiles, 600)
