"""The port's CUDA kernels on the card (marker ``gpu``).

Run on a machine with an NVIDIA GPU, where jax need not be installed:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py

(``--noconftest`` skips ``tests/conftest.py``, which configures jax for the
CPU suite.)  Each test decides inside its fixture whether a card is
present and skips without one, so this file imports neither jax nor
``libpll_tpu``.  Tolerances are chip_smoke.py's: float64 logL rel 1e-12,
scalers equal; float32 logL within 2e-6·|logL| + 5e-3, scalers agree at
>= 99.9%, CLVs rtol 1e-5 where they agree.  K1/K2 (``clv_fused``, DNA
and protein),
K5/K6 (``clv_dyn``), K3/K4 (``clv_seg``), the roofline probes K7/K8
(``roofline``, rel 1e-5 at small chain lengths) and the Newton kernel N1
(``derivatives``, chip_smoke's ``newton_close``) are covered, and the
stateful Partition on the card against the CPU (chip_smoke's phase 20),
and the Fitch kernels P1-P3 (``fitch``: exact equality with their plain
versions; the stepwise build on the card against the CPU), and the
op-table kernel U1 with branch-length optimisation (chip_smoke's phase
27), and the candidate-replay kernel C1 with the batched SPR/NNI scorer
and the scaling vote's NaN rule (chip_smoke's phase 30), and the SPR/NNI
rounds and a small ``infer_tree`` on the card against the CPU (chip_smoke's
phase 32; float64 logL rel 1e-9 there, a search's tolerance), and model
fitting's small cases (chip_smoke's phase 34).
``test_partition_builds_on_the_card_by_default`` needs no card and runs
in the CPU suite.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libpll_tpu_torch import Partition
from libpll_tpu_torch.engine import evaluate as ev
from libpll_tpu_torch.engine.params import model_from_numpy
from libpll_tpu_torch.errors import EinvalError, KernelError
from libpll_tpu_torch.ops import clv_dyn as cd
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.ops import clv_seg as cseg
from libpll_tpu_torch.ops import derivatives as dv
from libpll_tpu_torch.ops import roofline as rf

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_kernels_match_plain_on_card(cuda):
    """chip_smoke's phase 3: every tip encoding, scale mode, +I, dtype and
    rate-category count, with a ragged last block, kernel vs plain."""
    before = (cf.fused_sweep.launches, cf.fused_edge_score.launches)
    assert chip_smoke.check_small(cuda)[0] > 0
    assert cf.fused_sweep.launches > before[0]
    assert cf.fused_edge_score.launches > before[1]


@pytest.mark.gpu
@pytest.mark.parametrize("tip_encoding", ["clv", "chars", "masks"])
def test_modules_on_card_match_cpu(cuda, tip_encoding):
    """make_score / make_forward_fused moved to the card (kernels) equal
    the same modules on the CPU (plain versions) in float64."""
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(10, np.random.default_rng(5)), 300, 4, 5)
    out = {}
    for device in ("cpu", cuda):
        model = model_from_numpy(model_np, device, torch.float64)
        tp = chip_smoke.tip_input(masks, tip_encoding, 4, torch.float64,
                                  device)
        score = ev.make_score(topo, 4, 4, use_pinv=True,
                              tip_encoding=tip_encoding, device=device)
        fwd = ev.make_forward_fused(topo, 4, 4, tip_encoding=tip_encoding,
                                    device=device)
        logl, persite, inner, scalers = fwd(model, tp)
        out[str(device)] = (float(score(model, tp)), float(logl),
                            inner.cpu(), scalers.cpu())
    (s0, f0, i0, c0), (s1, f1, i1, c1) = out.values()
    assert abs(s1 - s0) <= 1e-12 * abs(s0)
    assert abs(f1 - f0) <= 1e-12 * abs(f0)
    torch.testing.assert_close(i1, i0, rtol=1e-12, atol=0)
    assert torch.equal(c1, c0)
    with pytest.raises(EinvalError):  # inputs on another device
        ev.make_score(topo, 4, 4, tip_encoding=tip_encoding, device="cpu")(
            model_from_numpy(model_np, cuda, torch.float64), tp)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_kernels_large_tree_on_card(cuda, dtype):
    """K1/K2 on a 1 000-taxon tree (a pool of more slots than the
    flagship's, ops staged in chunks) against their plain versions, one
    launch per call."""
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(1000, np.random.default_rng(7)), 300, 4, 7)
    sched = topo.schedule
    tp = chip_smoke.tip_input(masks, "chars", 4, dtype, cuda)
    args = chip_smoke.kernel_inputs(topo, model_np, dtype, cuda, True)
    edge = dict(parent_clv=topo.parent_clv, child_clv=topo.child_clv,
                edge_matrix=topo.edge_matrix, tip_encoding="chars")
    plan = cf.FusedPlan(sched, "chars", (topo.parent_clv, topo.child_clv,
                                         topo.edge_matrix))
    chunk = plan.layout(dtype, 4, 4, topo.scale_mode, True)["chunk"]
    assert plan.pool > 3 and sched.n_inner > chunk
    before = (cf.fused_sweep.launches, cf.fused_edge_score.launches)
    got = cf.fused_sweep(sched, tp, args[0], tip_encoding="chars")
    ok, err, agree = chip_smoke.sweep_close(
        *got, *cf.fused_sweep_plain(sched, tp, args[0], tip_encoding="chars"),
        dtype)
    assert ok, (err, agree)
    logl = float(cf.fused_edge_score(sched, tp, *args, plan=plan, **edge))
    want = float(cf.fused_edge_score_plain(sched, tp, *args, **edge))
    assert np.isfinite(logl) and chip_smoke.logl_close(logl, want, dtype)
    assert (cf.fused_sweep.launches, cf.fused_edge_score.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_graphed_score_equals_eager(cuda):
    """make_score captured in a CUDA graph gives the eager call's logL bit
    for bit, on the captured inputs and after new branch lengths, and
    refuses inputs of another dtype."""
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(24, np.random.default_rng(9)), 1000, 4, 9)
    tp = chip_smoke.tip_input(masks, "chars", 4, torch.float32, cuda)
    model = model_from_numpy(model_np, cuda, torch.float32)
    score = ev.make_score(topo, 4, 4, use_pinv=True, tip_encoding="chars",
                          device=cuda)
    graphed = score.graphed(model, tp)
    for scale in (1.0, 1.3):
        model["branch_lengths"] = model["branch_lengths"] * scale
        want = float(score(model, tp))
        assert np.isfinite(want)
        assert float(graphed(model, tp)) == want
    with pytest.raises(EinvalError):  # inputs unlike the captured ones
        graphed(model_from_numpy(model_np, cuda, torch.float64), tp)


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    newick = chip_smoke.random_newick(8, np.random.default_rng(4))
    for rate_cats, bad in ((3, "rate_cats"), (4, "dtype"),
                           (4, "contiguity"), (4, "device")):
        topo, model_np, masks = chip_smoke.small_case(newick, 40, rate_cats,
                                                      4)
        pm = chip_smoke.kernel_inputs(topo, model_np, torch.float64, cuda,
                                      False)[0]
        tips = chip_smoke.tip_input(masks, "clv", rate_cats, torch.float64,
                                    cuda)
        if bad == "dtype":
            tips = tips.float()
        elif bad == "contiguity":
            tips = tips.transpose(1, 2)
        elif bad == "device":
            pm = pm.cpu()
        with pytest.raises(EinvalError):
            cf.fused_sweep(topo.schedule, tips, pm)


@pytest.mark.gpu
def test_dyn_kernels_match_plain_on_card(cuda):
    """chip_smoke's phase 7: K5 and K6 against their plain versions for
    every encoding, scale mode, dtype, C, S in {4, 20}, ±I, one and many
    segments, and a table swap."""
    before = (cd.DynSweep.launches, cd.DynScore.launches)
    assert chip_smoke.check_dyn_small(cuda)[0] > 0
    assert cd.DynSweep.launches > before[0]
    assert cd.DynScore.launches > before[1]


@pytest.mark.gpu
@pytest.mark.parametrize("states", [4, 20])
def test_dyn_modules_on_card_match_cpu(cuda, states, monkeypatch):
    """make_score_unbounded and make_dyn_sweep on a multi-segment tree,
    moved to the card (kernels), equal the same modules on the CPU (plain
    versions) in float64."""
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(24, np.random.default_rng(9)), 300, 4, 9,
        states=states)
    # a 16-row budget at 300 sites cuts the 24-taxon tree into segments
    monkeypatch.setattr(cd, "SCRATCH_BUDGET",
                        16 * 300 * 4 * (4 * states + 4))
    out = {}
    for device in ("cpu", cuda):
        model = model_from_numpy(model_np, device, torch.float64)
        score = ev.make_score_unbounded(topo, 4, states, masks,
                                        use_pinv=True, device=device)
        assert len(score.dyn.segments) > 2
        sweep = cd.make_dyn_sweep(score.dyn, topo.scale_mode, rate_cats=4,
                                  states=states,
                                  tip_encoding=score.kernel.tip_encoding)
        inner, scalers = sweep(score.tips, score.tables, score.m_ops,
                               score.pmatrices(model, torch.float64))
        out[str(device)] = (float(score(model)), inner.cpu(), scalers.cpu())
    (s0, i0, c0), (s1, i1, c1) = out.values()
    assert abs(s1 - s0) <= 1e-12 * abs(s0)
    torch.testing.assert_close(i1, i0, rtol=1e-12, atol=0)
    assert torch.equal(c1, c0)


@pytest.mark.gpu
@pytest.mark.parametrize("states", [4, 20])
def test_dyn_spilled_pool_on_card_matches_cpu(cuda, states, monkeypatch):
    """K5 and K6 with their pools capped at one slot, so that most local
    rows spill to device memory (K6's scratch, K5's output rows), on a
    multi-segment tree in float64: equal to the plain versions on the CPU
    and to the slotted runner that follows the same addressing."""
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(24, np.random.default_rng(11)), 300, 4, 11,
        states=states)
    monkeypatch.setattr(cd, "SCRATCH_BUDGET",
                        16 * 300 * 4 * (4 * states + 4))
    out = {}
    for device in ("cpu", cuda):
        model = model_from_numpy(model_np, device, torch.float64)
        score = ev.make_score_unbounded(topo, 4, states, masks,
                                        device=device)
        sweep = cd.make_dyn_sweep(score.dyn, topo.scale_mode, rate_cats=4,
                                  states=states,
                                  tip_encoding=score.kernel.tip_encoding)
        score.kernel.slot_cap = sweep.slot_cap = 1
        assert score.kernel.layout(torch.float64).spills > 0
        assert sweep.layout(torch.float64).spills > 0
        pm = score.pmatrices(model, torch.float64)
        args = (score.tips, score.tables, score.m_ops, pm)
        inner, scalers = sweep(*args)
        out[str(device)] = (float(score(model)), inner.cpu(), scalers.cpu())
        if device == "cpu":
            slotted = sweep.plain_slotted(*args)
            assert torch.equal(slotted[0], inner)
            assert torch.equal(slotted[1], scalers)
    (s0, i0, c0), (s1, i1, c1) = out.values()
    assert abs(s1 - s0) <= 1e-12 * abs(s0)
    torch.testing.assert_close(i1, i0, rtol=1e-12, atol=0)
    assert torch.equal(c1, c0)


@pytest.mark.gpu
def test_dyn_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    newick = chip_smoke.random_newick(8, np.random.default_rng(4))
    for rate_cats, states, bad in ((3, 4, "rate_cats"), (4, 5, "states"),
                                   (4, 4, "tables on the host")):
        topo, model_np, masks = chip_smoke.small_case(newick, 40, rate_cats,
                                                      4, states=states)
        dyn = cd.build_dyn_schedule(
            topo.schedule, rate_cats=rate_cats, states=states, sites=40,
            ensure_rows=[topo.parent_clv, topo.child_clv])
        tables = [torch.stack(t) for t in cd.dyn_runtime_args(dyn)]
        if bad != "tables on the host":
            tables = [t.to(cuda) for t in tables]
        pm = chip_smoke.kernel_inputs(topo, model_np, torch.float64, cuda,
                                      False)[0]
        tips = torch.from_numpy(masks.astype(np.int32)).to(cuda)
        sweep = cd.make_dyn_sweep(dyn, rate_cats=rate_cats, states=states,
                                  tip_encoding="masks")
        with pytest.raises(EinvalError):
            sweep(tips, *tables, pm)


@pytest.mark.gpu
def test_seg_kernels_match_plain_on_card(cuda):
    """chip_smoke's phase 12: K3 and K4 against their plain versions for
    every scale mode, dtype, C, S in {4, 20}, one and many segments."""
    before = (cseg.SegmentedSweep.launches, cseg.SegmentedScore.launches)
    assert chip_smoke.check_seg_small(cuda)[0] > 0
    assert cseg.SegmentedSweep.launches > before[0]
    assert cseg.SegmentedScore.launches > before[1]


@pytest.mark.gpu
@pytest.mark.parametrize("states", [4, 20])
def test_seg_modules_on_card_match_cpu(cuda, states):
    """K3 and K4 on a multi-segment tree on the card (kernels) equal the
    same schedule on the CPU (plain versions) in float64."""
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(24, np.random.default_rng(9)), 300, 4, 9,
        states=states)
    seg = cseg.build_segmented_schedule(
        topo.schedule, max_rows=cseg.seg_max_rows(4, states, torch.float64),
        ensure_rows=[topo.parent_clv, topo.child_clv])
    assert len(seg.segments) > 2
    out = {}
    for device in ("cpu", cuda):
        slabs = cseg.pack_tips_segmented(chip_smoke.tip_input(
            masks, "clv", 4, torch.float64, device, states), seg)
        pm, wvec, pw, _ = chip_smoke.kernel_inputs(topo, model_np,
                                                   torch.float64, device,
                                                   False)
        sweep = cseg.make_segmented_sweep(seg, topo.scale_mode, rate_cats=4,
                                          states=states)
        inner, scalers = sweep(slabs, pm)
        score = cseg.make_segmented_score(
            seg, topo.parent_clv, topo.child_clv, topo.edge_matrix,
            topo.scale_mode, rate_cats=4, states=states)
        out[str(device)] = (float(score(slabs, pm, wvec, pw)), inner.cpu(),
                            scalers.cpu())
    (s0, i0, c0), (s1, i1, c1) = out.values()
    assert abs(s1 - s0) <= 1e-12 * abs(s0)
    torch.testing.assert_close(i1, i0, rtol=1e-12, atol=0)
    assert torch.equal(c1, c0)


@pytest.mark.gpu
@pytest.mark.parametrize("sites", [300, 301])
def test_seg_one_launch_per_call(cuda, sites):
    """K3 and K4 launch once per call, and once per segment under
    ``split``, with the same bits either way, and match their plain
    versions; at 301 sites no tip row is 16-byte aligned."""
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(24, np.random.default_rng(7)), sites, 4, 7)
    seg = cseg.build_segmented_schedule(
        topo.schedule, max_rows=9,
        ensure_rows=[topo.parent_clv, topo.child_clv])
    n_seg = len(seg.segments)
    assert n_seg > 2
    for dtype in (torch.float32, torch.float64):
        slabs = cseg.pack_tips_segmented(chip_smoke.tip_input(
            masks, "clv", 4, dtype, cuda), seg)
        pm, wvec, pw, _ = chip_smoke.kernel_inputs(topo, model_np, dtype,
                                                   cuda, False)
        sweep = cseg.make_segmented_sweep(seg, topo.scale_mode, rate_cats=4,
                                          states=4)
        score = cseg.make_segmented_score(
            seg, topo.parent_clv, topo.child_clv, topo.edge_matrix,
            topo.scale_mode, rate_cats=4, states=4)
        out = []
        for split, per_call in ((False, 1), (True, n_seg)):
            sweep.split = score.split = split
            before = (cseg.SegmentedSweep.launches,
                      cseg.SegmentedScore.launches)
            inner, scalers = sweep(slabs, pm)
            logl = float(score(slabs, pm, wvec, pw))
            assert (cseg.SegmentedSweep.launches - before[0],
                    cseg.SegmentedScore.launches - before[1]) == (
                        per_call, per_call)
            out.append((inner, scalers, logl))
        (i0, c0, l0), (i1, c1, l1) = out
        assert torch.equal(i0, i1) and torch.equal(c0, c1) and l0 == l1
        want = sweep.plain(slabs, pm)
        ok, err, agree = chip_smoke.sweep_close(i0, c0, *want, dtype)
        assert ok, (err, agree)
        assert chip_smoke.logl_close(
            l0, float(score.plain(slabs, pm, wvec, pw)), dtype)


@pytest.mark.gpu
def test_seg_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(12, np.random.default_rng(4)), 40, 4, 4)
    seg = cseg.build_segmented_schedule(
        topo.schedule, max_rows=8,
        ensure_rows=[topo.parent_clv, topo.child_clv])
    pm = chip_smoke.kernel_inputs(topo, model_np, torch.float64, cuda,
                                  False)[0]
    slabs = cseg.pack_tips_segmented(chip_smoke.tip_input(
        masks, "clv", 4, torch.float64, cuda), seg)
    sweep = cseg.make_segmented_sweep(seg, rate_cats=4, states=4)
    for bad in (slabs[:-1], [s.float() for s in slabs],
                [slabs[0].cpu()] + slabs[1:]):
        with pytest.raises(EinvalError):
            sweep(bad, pm)
    with pytest.raises(EinvalError):  # three rates against a C = 4 pmatrix
        cseg.make_segmented_sweep(seg, rate_cats=3, states=4)(slabs, pm)
    assert cseg.max_smem(4, torch.float32) >= cseg.SMEM_LIMIT


@pytest.mark.gpu
def test_roofline_probes_match_plain_on_card(cuda):
    """K7 and K8 at the width that fills the card, chain lengths 1 and 16,
    against their plain versions at rel 1e-5; a chain-pair rate is
    positive."""
    before = (rf.fma_chain.launches, rf.roll_contract.launches)
    chip_smoke.check_roofline_small(cuda)
    assert rf.fma_chain.launches > before[0]
    assert rf.roll_contract.launches > before[1]
    x = rf.fma_input(1, cuda)
    rate, per_iter, dts = rf.chain_rate(lambda k: rf.fma_chain(x, k),
                                        rf.fma_flops(x), 256, 4096, pairs=3)
    assert rate > 0 and per_iter > 0 and dts
    with pytest.raises(EinvalError):  # a tile of the wrong height
        rf.roll_contract(x[:8].contiguous(), rf.roll_inputs(1, cuda)[1], 4)


@pytest.mark.gpu
def test_newton_kernel_matches_plain_on_card(cuda):
    """chip_smoke's phase 15: N1 against its plain twin for every scaling,
    +I and asc variant, float32/float64, S 4/20, C 1/4/8, from the
    sumtable and from the rows; one launch a call (``newton_close`` calls
    N1 twice, once in each form a case)."""
    before = dv.newton_solve.launches
    n = chip_smoke.check_newton_small(cuda)[0]
    assert dv.newton_solve.launches - before == 4 * n


def tiled(args, reps):
    """N1's arguments (either form) with the sites repeated ``reps`` times
    (no asc columns): the same terms, a larger sumtable."""
    length = args["pattern_weights"].shape[-1]

    def tile(t):
        if isinstance(t, tuple):
            return tuple(tile(v) for v in t)
        if isinstance(t, torch.Tensor) and t.shape[-1] == length:
            return t.repeat(*([1] * (t.dim() - 1)), reps).contiguous()
        return t
    return dict({k: tile(v) for k, v in args.items()},
                sites=args["sites"] * reps)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, resident", [(torch.float32, True),
                                             (torch.float64, False)])
def test_newton_resident_and_streamed_on_card(cuda, dtype, resident):
    """N1 past the planner's float64 limit (more sites than a block an SM
    holds in shared memory: streamed slices) and at the same size in
    float32 (resident slices) against its plain twin (``newton_close``),
    from the sumtable and from the rows (where streamed, the rows go
    through ``update_sumtable``), one launch a call, two calls the same
    bits."""
    args, rows = chip_smoke.newton_inputs(
        "pinv", chip_smoke.caterpillar_newick(48), 4, 4, dtype, cuda, seed=4,
        rows=True)
    sms, limit = dv._limits(cuda.index or 0, torch.float64, 4)
    per_site = dv.slice_bytes(4, 4, 8, dv.SLICE_ALIGN) // dv.SLICE_ALIGN
    reps = sms * (limit // per_site) // args["sites"] + 2
    args, rows = tiled(args, reps), tiled(rows, reps)
    plan = dv.plan_for(args["sumtable"], args["sites"], args["asc_mode"])
    assert plan.resident == resident and plan.grid <= sms
    before = dv.newton_solve.launches
    for form in (None, rows):
        ok, _, msg = chip_smoke.newton_close(args, dtype, form)
        assert ok, msg
    assert dv.newton_solve.launches - before == 4
    for solve in (lambda: dv.newton_solve(**args),
                  lambda: dv.newton_solve_rows(**rows)):
        first, again = solve(), solve()
        assert [float(v) for v in first] == [float(v) for v in again]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_train_step_on_card(cuda, dtype):
    """make_train_step_fused and make_train_step on the card against the
    same modules on the CPU (plain versions): logL at the f32 budget or
    rel 1e-12, t* within 1e-5 or rel 1e-10; the fused step captured in a
    CUDA graph equals the eager step bit for bit; N1 rejects what it does
    not take."""
    from libpll_tpu_torch.utils.flagship import build_flagship

    topo, model_np, masks, _ = build_flagship(24, 1000, simulate=True,
                                              tip_masks=True, seed=3)
    out = {}
    for device in ("cpu", cuda):
        model = model_from_numpy(model_np, device, dtype)
        tp = cf.pack_tipchars(masks).to(device)
        step = ev.make_train_step_fused(topo, 4, 4, tip_encoding="chars",
                                        device=device)
        logl, t_star = step(model, tp)
        out[str(device)] = (float(logl), float(t_star))
        if device != "cpu":
            graphed = step.graphed(model, tp)
            assert tuple(float(v) for v in graphed(model, tp)) == out[
                str(device)]
            args = step.newton_inputs(model, tp)[1]
    (l0, t0), (l1, t1) = out.values()
    assert chip_smoke.logl_close(l1, l0, dtype)
    rel = 1e-10 if dtype == torch.float64 else chip_smoke.F32_T_REL
    assert 1e-8 < t1 < 100 and abs(t1 - t0) <= rel * t0
    for bad in ({"t0": args["t0"].cpu()},
                {"sumtable": args["sumtable"][:, :3].contiguous()},
                {"rates": args["rates"].double() if dtype == torch.float32
                 else args["rates"].float()},
                {"invariant": args["invariant"].long()}):
        with pytest.raises(EinvalError):
            dv.newton_solve(**dict(args, **bad))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tip_encoding", ["clv", "masks"])
def test_protein_modules_on_card_match_cpu(cuda, dtype, tip_encoding):
    """The protein path (K1/K2 at 20 states): make_score,
    make_forward_fused and make_train_step_fused on the card launch one
    K1 or one K2 a call and match the same modules on the CPU (plain
    versions): float64 logL rel 1e-12, rows rtol 1e-12, scalers equal,
    t* rel 1e-10; float32 logL within the budget, t* within 1e-5; the
    step in a CUDA graph equals the eager step; mxu_precision="high"
    gives the "highest" bits."""
    from libpll_tpu_torch.utils.flagship import build_protein_flagship

    topo, model_np, masks = build_protein_flagship(12, 700, seed=2)
    c, s = 4, 20
    out = {}
    for device in ("cpu", cuda):
        model = model_from_numpy(model_np, device, dtype)
        tp = chip_smoke.tip_input(masks, tip_encoding, c, dtype, device, s)
        kw = dict(tip_encoding=tip_encoding, device=device)
        score = ev.make_score(topo, c, s, **kw)
        fwd = ev.make_forward_fused(topo, c, s, **kw)
        step = ev.make_train_step_fused(topo, c, s, **kw)
        before = (cf.fused_edge_score.launches, cf.fused_sweep.launches)
        logl = float(score(model, tp))
        f_logl, _, inner, scalers = fwd(model, tp)
        step_out = tuple(float(v) for v in step(model, tp))
        launched = (cf.fused_edge_score.launches - before[0],
                    cf.fused_sweep.launches - before[1])
        assert launched == ((0, 0) if device == "cpu" else (1, 2))
        out[str(device)] = (logl, float(f_logl), inner.cpu(), scalers.cpu(),
                            step_out)
        if device != "cpu":
            assert tuple(float(v) for v in step.graphed(model, tp)(
                model, tp)) == step_out
            high = ev.make_score(topo, c, s, mxu_precision="high", **kw)
            assert float(high(model, tp)) == logl
    (s0, f0, i0, c0, st0), (s1, f1, i1, c1, st1) = out.values()
    assert st1[0] == f1
    for got, want in ((s1, s0), (f1, f0), (st1[0], st0[0])):
        assert chip_smoke.logl_close(got, want, dtype)
    if dtype == torch.float64:
        torch.testing.assert_close(i1, i0, rtol=1e-12, atol=0)
        assert torch.equal(c1, c0)
        assert abs(st1[1] - st0[1]) <= 1e-10 * st0[1]
    else:
        ok, err, agree = chip_smoke.sweep_close(i1, c1, i0, c0, dtype)
        assert ok, (err, agree)
        assert abs(st1[1] - st0[1]) <= chip_smoke.F32_T_REL * st0[1]


@pytest.mark.gpu
@pytest.mark.parametrize("sites", [1, 63, 64, 65, 1001])
def test_protein_kernels_around_the_tile(cuda, sites):
    """The protein K1/K2 against their plain versions at site counts on
    both sides of a block's tile (32 sites, or 64 at two sites a thread):
    C in {1, 2, 4, 8}, float32 and float64, masks tips, a random tree
    without and with per-site scaling (K2 also per rate) and a caterpillar
    whose float32 values scale; chip_smoke's tolerances (float64 logL rel
    1e-12, scalers equal; float32 within the budget, rows rtol 1e-5 where
    the counters agree)."""
    from libpll_tpu_torch.utils.constants import (SCALE_NONE,
                                                  SCALE_PER_RATE,
                                                  SCALE_PER_SITE)

    rng = np.random.default_rng(sites)
    trees = ((chip_smoke.random_newick(12, rng), (SCALE_NONE,
                                                  SCALE_PER_SITE)),
             (chip_smoke.caterpillar_newick(48), (SCALE_PER_SITE,)))
    before = (cf.fused_sweep.launches, cf.fused_edge_score.launches)
    for newick, k1_scales in trees:
        for rate_cats in (1, 2, 4, 8):
            topo, model_np, masks = chip_smoke.small_case(
                newick, sites, rate_cats, seed=rate_cats, states=20)
            sched = topo.schedule
            edge = dict(parent_clv=topo.parent_clv,
                        child_clv=topo.child_clv,
                        edge_matrix=topo.edge_matrix, tip_encoding="masks")
            for dtype in (torch.float32, torch.float64):
                tp = chip_smoke.tip_input(masks, "masks", rate_cats, dtype,
                                          cuda, 20)
                pm = chip_smoke.kernel_inputs(topo, model_np, dtype, cuda,
                                              False)[0]
                for scale in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE):
                    got = cf.fused_sweep(sched, tp, pm, scale_mode=scale,
                                         tip_encoding="masks")
                    want = cf.fused_sweep_plain(sched, tp, pm,
                                                scale_mode=scale,
                                                tip_encoding="masks")
                    ok, err, agree = chip_smoke.sweep_close(*got, *want,
                                                            dtype)
                    assert ok, (rate_cats, dtype, scale, err, agree)
                for scale in k1_scales:
                    for pinv in (False, True):
                        args = chip_smoke.kernel_inputs(topo, model_np,
                                                        dtype, cuda, pinv)
                        got = float(cf.fused_edge_score(
                            sched, tp, *args, scale_mode=scale, **edge))
                        want = float(cf.fused_edge_score_plain(
                            sched, tp, *args, scale_mode=scale, **edge))
                        assert np.isfinite(got) and chip_smoke.logl_close(
                            got, want, dtype), (rate_cats, dtype, scale,
                                                pinv, got, want)
    assert cf.fused_sweep.launches > before[0]
    assert cf.fused_edge_score.launches > before[1]


def balanced_newick(lo, hi):
    if hi - lo == 1:
        return f"t{lo}:0.1"
    mid = (lo + hi) // 2
    return f"({balanced_newick(lo, mid)},{balanced_newick(mid, hi)}):0.1"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, rate_cats", [(torch.float64, 4),
                                              (torch.float32, 8)])
def test_protein_one_matrix_buffer(cuda, dtype, rate_cats):
    """Balanced trees whose walks keep 9 rows live (K2 at 1 024 taxa, K1,
    with its edge's rows held, at 512): two matrix buffers do not fit
    beside that pool (float64 at four rates, float32 at eight), so the
    layout takes one buffer, one site a thread, and the walk in chunks of
    ops; K1 and K2 still match their plain versions (chip_smoke's
    tolerances)."""
    for tips, score in ((1024, False), (512, True)):
        newick = (f"({balanced_newick(0, tips // 2)},"
                  f"{balanced_newick(tips // 2, 3 * tips // 4)},"
                  f"{balanced_newick(3 * tips // 4, tips)});")
        topo, model_np, masks = chip_smoke.small_case(newick, 70, rate_cats,
                                                      3, states=20)
        sched = topo.schedule
        edge = dict(parent_clv=topo.parent_clv, child_clv=topo.child_clv,
                    edge_matrix=topo.edge_matrix)
        plan = cf.FusedPlan(sched, "masks",
                            tuple(edge.values()) if score else None)
        assert plan.pool == 9
        lay = plan.layout(dtype, rate_cats, 20, topo.scale_mode, score)
        assert (lay["buffers"], lay["block_sites"]) == (1, 32)
        assert lay["chunk"] < sched.n_inner
        tp = chip_smoke.tip_input(masks, "masks", rate_cats, dtype, cuda, 20)
        args = chip_smoke.kernel_inputs(topo, model_np, dtype, cuda, True)
        if score:
            got = float(cf.fused_edge_score(sched, tp, *args, plan=plan,
                                            tip_encoding="masks", **edge))
            want = float(cf.fused_edge_score_plain(
                sched, tp, *args, tip_encoding="masks", **edge))
            assert np.isfinite(got) and chip_smoke.logl_close(got, want,
                                                              dtype)
        else:
            got = cf.fused_sweep(sched, tp, args[0], plan=plan,
                                 tip_encoding="masks")
            want = cf.fused_sweep_plain(sched, tp, args[0],
                                        tip_encoding="masks")
            ok, err, agree = chip_smoke.sweep_close(*got, *want, dtype)
            assert ok, (err, agree)


@pytest.mark.gpu
def test_protein_pool_that_does_not_fit_raises(cuda):
    """At 1 000 taxa the walk keeps 6 rows live: float64 protein at eight
    rates needs more shared memory than a block has, so the layout and
    both wrappers raise, and nothing falls back to the plain versions;
    float32 at four rates fits.  "chars" tips at 20 states raise."""
    topo, model_np, masks = chip_smoke.small_case(
        chip_smoke.random_newick(1000, np.random.default_rng(8)), 64, 8, 8,
        states=20)
    sched = topo.schedule
    plan = cf.FusedPlan(sched, "masks")
    assert plan.pool == 6
    assert plan.layout(torch.float32, 4, 20, 1, False)["blocks_per_sm"] > 0
    with pytest.raises(EinvalError, match="does not fit"):
        plan.layout(torch.float64, 8, 20, 1, False)
    pm, wvec, pw, _ = chip_smoke.kernel_inputs(topo, model_np, torch.float64,
                                               cuda, False)
    tp = chip_smoke.tip_input(masks, "masks", 8, torch.float64, cuda, 20)
    before = (cf.fused_sweep.launches, cf.fused_edge_score.launches)
    with pytest.raises(EinvalError, match="does not fit"):
        cf.fused_sweep(sched, tp, pm, plan=plan, tip_encoding="masks")
    with pytest.raises(EinvalError, match="does not fit"):
        cf.fused_edge_score(sched, tp, pm, wvec, pw,
                            parent_clv=topo.parent_clv,
                            child_clv=topo.child_clv,
                            edge_matrix=topo.edge_matrix,
                            tip_encoding="masks")
    assert (cf.fused_sweep.launches, cf.fused_edge_score.launches) == before
    with pytest.raises(EinvalError):
        cf.fused_sweep(sched, tp, pm, tip_encoding="chars")


@pytest.mark.gpu
def test_partition_on_card_matches_cpu(cuda):
    """chip_smoke's phase 20: every scaling mode, +I, the asc modes,
    explicit tip CLVs, protein, ``pad_to`` and a rewritten buffer, float64
    and float32, the Partition on the card against the Partition on the
    CPU; the executors of ``ops/clv`` likewise."""
    assert chip_smoke.check_partition_small(cuda) > 0


def test_partition_builds_on_the_card_by_default(monkeypatch):
    """No card: Partition(), model_from_partition and restore_partition
    with device None raise KernelError; nothing carries on on the CPU."""
    from libpll_tpu_torch.engine import checkpoint as tck

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(KernelError):
        Partition(4, 2, 4, 10, 1, 5, 1, 2)
    part = Partition(4, 2, 4, 10, 1, 5, 1, 2, device="cpu")
    assert part.clv.device.type == "cpu"
    with pytest.raises(KernelError):
        ev.model_from_partition(part, np.ones(5))
    header = {"tips": 4, "clv_buffers": 2, "states": 4, "sites": 10,
              "rate_matrices": 1, "prob_matrices": 5, "rate_cats": 1,
              "scale_buffers": 2, "scale_mode": 1, "asc_mode": 0,
              "dtype": "float64"}
    with pytest.raises(KernelError):
        tck.restore_partition(header, {})


@pytest.mark.gpu
def test_parsimony_kernels_match_plain_on_card(cuda):
    """chip_smoke's phase 24: P1-P3 (``csrc/fitch.cu``) equal their plain
    versions at every launch, exactly, over 32 configurations (4-200 taxa,
    DNA and protein with ambiguity codes, weights, 1-3 partitions); the
    card's FastParsimony, both stepwise engines and the Sankoff
    Parsimony equal the CPU's."""
    from libpll_tpu_torch.ops import fitch

    before = (fitch.fitch_waves.launches, fitch.fitch_scores.launches,
              fitch.stepwise_commit.launches)
    assert chip_smoke.check_parsimony_small(cuda) > 0
    after = (fitch.fitch_waves.launches, fitch.fitch_scores.launches,
             fitch.stepwise_commit.launches)
    assert all(a > b for a, b in zip(after, before))


@pytest.mark.gpu
@pytest.mark.parametrize("engine", ["device", "host"])
def test_stepwise_on_card_matches_cpu(cuda, engine):
    """fastparsimony_stepwise on the card (its kernels) against the CPU
    (the plain versions): the same score and Newick, two partitions."""
    from libpll_tpu_torch.search.stepwise import fastparsimony_stepwise
    from libpll_tpu_torch.tree import utree as ut

    out = []
    for device in (cuda, "cpu"):
        parts = chip_smoke.parsimony_parts(150, 700, 4, True, 2, 9, device)
        labels = [f"t{i}" for i in range(150)]
        tree, score = fastparsimony_stepwise(parts, labels, 9,
                                             engine=engine)
        out.append((score, ut.export_newick(tree.root)))
    assert out[0] == out[1]


@pytest.mark.gpu
def test_fitch_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from libpll_tpu_torch.ops import fitch

    vec = torch.zeros((10, 4, 8), dtype=torch.int32, device=cuda)
    cost = torch.zeros(10, dtype=torch.int32, device=cuda)
    with pytest.raises(EinvalError):
        fitch.fitch_scores(vec.long(), cost, [0], [1])
    with pytest.raises(EinvalError):
        fitch.fitch_scores(torch.zeros((10, 33, 8), dtype=torch.int32,
                                       device=cuda), cost, [0], [1])
    with pytest.raises(EinvalError):
        fitch.fitch_scores(vec, cost.cpu(), [0], [1])
    with pytest.raises(EinvalError):
        fitch.fitch_waves(vec, cost, [[(5, 0, 1), (6, 5, 2)]])
    parts = [(torch.zeros((10, 4, 8), dtype=torch.int32, device=cuda),
              torch.zeros(10, dtype=torch.int32, device=cuda))]
    topo = fitch.stepwise_topology([0, 1, 2, 3], cuda)
    with pytest.raises(EinvalError):
        fitch.stepwise_commit(parts, *topo, mode="insert", insertion=3,
                              tip=3)  # no scores


@pytest.mark.gpu
def test_blopt_on_card_matches_cpu(cuda):
    """chip_smoke's phase 27: U1 against the plain executor at every
    launch (phase 20's configurations and random op tables), N1 with
    blopt's |d2| rule against its plain twin, both blopt optimisers (the scan
    eager and as a CUDA graph) on the card against the CPU."""
    out = chip_smoke.check_blopt_small(cuda)
    assert out["checked"] > 0 and out["n1"] > 0


@pytest.mark.gpu
def test_replay_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from libpll_tpu_torch.ops import clv as clv_ops

    clv = torch.zeros((5, 2, 4, 16), dtype=torch.float64, device=cuda)
    scal = torch.zeros((3, 16), dtype=torch.int32, device=cuda)
    pm = torch.zeros((4, 2, 4, 4), dtype=torch.float64, device=cuda)
    op = [[3, 0, 0, 0, 1, 1, 1, 2]]
    with pytest.raises(EinvalError):  # a matrix index out of range
        clv_ops.replay_ops(clv, scal, [[3, 0, 0, 9, 1, 1, 1, 2]], pm)
    with pytest.raises(EinvalError):  # scalers of another shape
        clv_ops.replay_ops(clv, scal[:, :8], op, pm)
    with pytest.raises(EinvalError):  # P-matrices of another dtype
        clv_ops.replay_ops(clv, scal, op, pm.float())
    with pytest.raises(EinvalError):  # a device table of int64
        clv_ops.replay_ops(clv, scal, torch.tensor(op, device=cuda), pm)
    with pytest.raises(EinvalError):  # more states than U1 takes
        clv_ops.replay_ops(torch.zeros((5, 1, 65, 4), dtype=torch.float64,
                                       device=cuda), scal[:, :4],
                           op, torch.zeros((4, 1, 65, 65),
                                           dtype=torch.float64, device=cuda))


@pytest.mark.gpu
def test_scorer_on_card_matches_plain_and_cpu(cuda):
    """chip_smoke's phase 30: C1 against its plain version at every launch
    (phase 20's configurations, float64 and float32, SPR and NNI
    candidates), the scores against the plain scorer on the card, the CPU
    scorer and fresh evaluations of the moved trees, the base buffers
    unchanged; the NaN vote of U1, K2 and C1 against their plain
    versions."""
    from libpll_tpu_torch.ops import incremental as inc_ops

    before = inc_ops._replay_candidates.launches
    out = chip_smoke.check_scorer_small(cuda)
    assert out["launches"] > 0 and out["brute"] > 0 and out["nan"] > 0
    assert inc_ops._replay_candidates.launches > before


@pytest.mark.gpu
def test_candidate_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from libpll_tpu_torch.ops import incremental as inc_ops

    clv = torch.zeros((5, 2, 4, 16), dtype=torch.float64, device=cuda)
    scal = torch.zeros((3, 16), dtype=torch.int32, device=cuda)
    pm = torch.zeros((4, 2, 4, 4), dtype=torch.float64, device=cuda)
    tables = torch.tensor([[[5, 3, 0, 0, 1, 1, 1, 2]]], dtype=torch.int32,
                          device=cuda)
    midx = torch.tensor([[0, 1, 2]], dtype=torch.int32, device=cuda)
    new = torch.zeros((1, 3, 2, 4, 4), dtype=torch.float64, device=cuda)
    ok = (clv, scal, pm, tables, midx, new, 1, 1)
    scratch, scal_scratch = inc_ops.replay_candidates(*ok)
    assert scratch.shape == (1, 1, 2, 4, 16)
    assert scal_scratch.shape == (1, 1, 16)

    def bad(i, value):
        args = list(ok)
        args[i] = value
        with pytest.raises(EinvalError):
            inc_ops.replay_candidates(*args)

    bad(3, tables.long())  # an int64 table
    bad(3, tables.cpu())  # a table on the host
    bad(3, tables[0])  # not [B, K, 8]
    bad(4, midx[:, :2].contiguous().repeat(2, 1))  # another batch
    bad(5, new.float())  # overlay of another dtype
    bad(5, new[:, :2])  # overlay of another U
    bad(1, scal[:, :8])  # scalers of another shape
    bad(2, pm.float())  # P-matrices of another dtype
    bad(6, 0)  # no scratch row


@pytest.mark.gpu
def test_rounds_on_card_match_cpu(cuda):
    """chip_smoke's phase 32, rounds: SPR (commit 1, 4, 8 with a rollback)
    and NNI rounds on the card against the CPU and libpll_tpu's recorded
    results, every valid row a fresh evaluation's, a round without
    improvement restoring every valid row bit for bit, U1 and C1 held
    against their plain versions at every launch."""
    with chip_smoke.ReplayHook() as u1, chip_smoke.ScorerHook() as c1:
        out = chip_smoke.check_rounds_small(cuda)
    assert out["rounds"] > 0 and out["restored"] == 4
    assert max(out["commits"]) > 1 and u1.checked > 0 and c1.checked > 0


@pytest.mark.gpu
def test_small_infer_tree_on_card_matches_cpu(cuda):
    """A small ``infer_tree`` (tests/test_infer.py's first case) on the
    card against the same call on the CPU: float64 start score, rounds,
    topology and logL (rel 1e-9)."""
    from libpll_tpu_torch.ops import incremental as inc_ops
    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.tree.compare import rf_distance

    name, seed, tips, sites, kw = chip_smoke.INFER_SMALL[0]
    seqs = chip_smoke.search_data(seed, tips, sites)
    before = inc_ops._replay_candidates.launches
    got = infer_tree(seqs, device=cuda, **chip_smoke.SEARCH_GTR, **kw)
    assert inc_ops._replay_candidates.launches > before
    want = infer_tree(seqs, device="cpu", **chip_smoke.SEARCH_GTR, **kw)
    assert got.start_parsimony_score == want.start_parsimony_score
    assert got.rounds == want.rounds
    assert rf_distance(got.tree, want.tree) == 0
    np.testing.assert_allclose(got.logl, want.logl, rtol=1e-9)
    assert got.partition.device.type == "cuda"


@pytest.mark.gpu
def test_model_fitting_on_card_matches_cpu(cuda):
    """chip_smoke's phase 34, small: the five fits (Γ, free, fixed, p-inv,
    LG4X) and ``infer_tree(optimize_model=True)`` in float64 on the card
    against the CPU and libpll_tpu's recorded results, each Partition
    carrying its fit, U1 and C1 held against their plain versions at
    every launch."""
    with chip_smoke.ReplayHook() as u1, chip_smoke.ScorerHook() as c1:
        out = chip_smoke.check_modelopt_small(cuda)
    assert out["fits"] == len(chip_smoke.MODELOPT_SMALL)
    assert u1.checked > 0 and c1.checked > 0
