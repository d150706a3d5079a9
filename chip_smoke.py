#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py

The main path is one full-tree log-likelihood evaluation of the flagship
configuration (GTR+Γ4 DNA, 64 taxa × 262 144 site patterns, float32,
per-site scaling, nibble-packed pattern tips): model parameters →
P-matrices → the fused edge-score kernel K1 (``make_score``), and the fused
sweep kernel K2 (``make_forward_fused``).  Phases, one line each:

  1. card: name and power limit (nvidia-smi);
  2. build: nvcc builds ``libpll_tpu_torch/csrc/clv_fused.cu`` for sm_90a;
  3. small configs: each kernel against its plain PyTorch version on the
     card, for every tip encoding, scale mode, +I and rate-category count,
     in float64 (logL rel <= 1e-12, scalers equal, CLVs rel 1e-12) and
     float32 (logL within the f32 budget, scalers agree at >= 99.9% of
     entries, CLVs rtol 1e-5 where they agree);
  4. flagship: ``make_score`` and ``make_forward_fused`` in float32 against
     the plain float64 ``make_forward`` on the card, |ΔlogL| <= 2e-6·|logL|
     + 5e-3 (the engine's f32 budget), launch counters > 0;
  5. times: each kernel and its plain version at the flagship shapes, with
     CUDA events.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before either is printed; so does a machine without CUDA, or a directory
without the package.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

ACC_REL, ACC_ABS = 2e-6, 5e-3  # float32 budget (BASELINE.md, test_accuracy)
F64_REL = 1e-12
F32_RTOL = 1e-5
F32_SCALER_AGREE = 0.999
# A C G T, R=A|G, Y=C|T, W=A|T, S=C|G, N/gap
IUPAC_POOL = np.array([1, 2, 4, 8, 5, 10, 9, 6, 15], np.uint32)
TIMED_ITERS, WARMUP = 20, 3


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------- inputs
def random_newick(tips, rng):
    items = [f"t{i}:{rng.uniform(0.05, 0.5):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.5):.4f}")
    return f"({items[0]},{items[1]},{items[2]});"


def caterpillar_newick(tips):
    s = "(t0:0.1,t1:0.1)"
    for i in range(2, tips - 2):
        s = f"({s}:0.1,t{i}:0.1)"
    return f"({s}:0.1,t{tips - 2}:0.1,t{tips - 1}:0.1);"


def small_case(newick, sites, rate_cats, seed):
    """(topo, numpy model with +I, [tips, sites] IUPAC masks)."""
    from libpll_tpu_torch.engine.evaluate import topology_from_tree
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.models.gtr import eigen_decompose
    from libpll_tpu_torch.tree import utree as ut

    rng = np.random.default_rng(seed)
    topo, branches = topology_from_tree(ut.parse_newick_string(newick),
                                        sites)
    freqs = rng.uniform(0.1, 1.0, 4)
    freqs /= freqs.sum()
    w, left, right = eigen_decompose(rng.uniform(0.5, 2.0, 6), freqs)
    invariant = np.full(sites, -1, np.int32)
    invariant[: sites // 10] = rng.integers(0, 4, sites // 10)
    model = {
        "branch_lengths": np.asarray(branches),
        "rates": compute_gamma_cats(0.8, rate_cats),
        "prop_invar": np.asarray([0.2]),
        "params_indices": np.zeros(rate_cats, np.int32),
        "eigenvals": w[None], "left": left[None], "right": right[None],
        "freqs_pc": np.broadcast_to(freqs, (rate_cats, 4)),
        "prop_invar_pc": np.full(rate_cats, 0.2),
        "rate_weights": np.full(rate_cats, 1.0 / rate_cats),
        "pattern_weights": rng.integers(1, 4, sites).astype(np.float64),
        "invariant": invariant,
    }
    masks = IUPAC_POOL[rng.integers(0, len(IUPAC_POOL),
                                    (topo.schedule.tips, sites))]
    return topo, model, masks


def tip_input(masks, tip_encoding, rate_cats, dtype, device):
    import torch

    from libpll_tpu_torch.ops import clv_fused as cf

    if tip_encoding == "chars":
        return cf.pack_tipchars(masks).to(device)
    words = torch.from_numpy(masks.astype(np.int32)).to(device)
    if tip_encoding == "masks":
        return words
    rows = torch.arange(masks.shape[0], device=device)
    return cf.decode_tips(words, "masks", rows, rate_cats, 4,
                          dtype).contiguous()


def kernel_inputs(topo, model_np, dtype, device, use_pinv):
    """(pmatrix, weight_vec, pattern_weights, inv_add) as make_score builds
    them."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_fused as cf

    model = model_from_numpy(model_np, device, dtype)
    index = torch.as_tensor(topo.matrix_indices, dtype=torch.long,
                            device=device)
    pmatrix = ev._pmatrices(model, topo, dtype, index)
    if use_pinv:
        wvec, inv_add = ev._pinv_score_inputs(model, dtype)
    else:
        wvec = cf.pack_weight_vec(model["freqs_pc"], model["rate_weights"])
        inv_add = None
    return pmatrix, wvec, model["pattern_weights"], inv_add


# ------------------------------------------------------------ comparisons
def logl_close(got, want, dtype):
    import torch

    if dtype == torch.float64:
        return abs(got - want) <= F64_REL * abs(want)
    return abs(got - want) <= ACC_REL * abs(want) + ACC_ABS


def sweep_close(inner_k, scal_k, inner_p, scal_p, dtype):
    """Kernel vs plain K2 output.  Returns (ok, max abs CLV error where the
    counters agree, share of counters that agree).  CLV errors are taken
    relative to the largest entry of each (node, site) block: entries far
    below it may sit in float32 subnormals."""
    import torch

    same = scal_k == scal_p
    agree = float(same.double().mean())
    keep = same[:-1]
    keep = (keep[:, None, None, :] if keep.dim() == 2
            else keep[:, :, None, :]).expand_as(inner_p)
    diff = (inner_k.double() - inner_p.double()).abs()
    span = inner_p.double().abs().amax(dim=(1, 2), keepdim=True)
    rel = diff / span.clamp_min(torch.finfo(torch.float32).tiny)
    max_abs = float(diff[keep].max()) if keep.any() else 0.0
    max_rel = float(rel[keep].max()) if keep.any() else 0.0
    if dtype == torch.float64:
        ok = bool(same.all()) and max_rel <= F64_REL
    else:
        ok = agree >= F32_SCALER_AGREE and max_rel <= F32_RTOL
    return ok, max_abs, agree


def check_small(device):
    """Phase 3: every kernel configuration against its plain version.
    Returns (configurations checked, largest float32 K1 |d logL|, largest
    float32 K2 CLV abs error where counters agree)."""
    import torch

    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                                  SCALE_PER_SITE)

    rng = np.random.default_rng(1)
    # 1000 sites: a ragged last block of 104 sites; the caterpillar makes
    # float32 scaling fire
    trees = [("random16", random_newick(16, rng), (4,)),
             ("caterpillar48", caterpillar_newick(48), (4,)),
             ("random12", random_newick(12, rng), (1, 2, 8))]
    n, k1_err, k2_err = 0, 0.0, 0.0
    for label, newick, cats in trees:
        for rate_cats in cats:
            topo, model_np, masks = small_case(newick, 1000, rate_cats,
                                               seed=rate_cats)
            sched = topo.schedule
            edge = dict(parent_clv=topo.parent_clv,
                        child_clv=topo.child_clv,
                        edge_matrix=topo.edge_matrix)
            for dtype in (torch.float32, torch.float64):
                for enc in ("clv", "chars", "masks"):
                    tp = tip_input(masks, enc, rate_cats, dtype, device)
                    where = f"{label} C={rate_cats} {dtype} {enc}"
                    pm = kernel_inputs(topo, model_np, dtype, device,
                                       False)[0]
                    for scale in (SCALE_NONE, SCALE_PER_SITE,
                                  SCALE_PER_RATE):
                        got = cf.fused_sweep(sched, tp, pm, scale_mode=scale,
                                             tip_encoding=enc)
                        want = cf.fused_sweep_plain(
                            sched, tp, pm, scale_mode=scale,
                            tip_encoding=enc)
                        torch.cuda.synchronize()
                        ok, err, agree = sweep_close(*got, *want, dtype)
                        check(ok, f"K2 {where} scale={scale}: max abs err "
                                  f"{err}, scaler agreement {agree}")
                        if dtype == torch.float32:
                            k2_err = max(k2_err, err)
                        n += 1
                    for scale in (SCALE_NONE, SCALE_PER_SITE):
                        for pinv in (False, True):
                            args = kernel_inputs(topo, model_np, dtype,
                                                 device, pinv)
                            got = float(cf.fused_edge_score(
                                sched, tp, *args, scale_mode=scale,
                                tip_encoding=enc, **edge))
                            want = float(cf.fused_edge_score_plain(
                                sched, tp, *args, scale_mode=scale,
                                tip_encoding=enc, **edge))
                            check(np.isfinite(got) and logl_close(
                                got, want, dtype),
                                f"K1 {where} scale={scale} pinv={pinv}: "
                                f"{got} vs plain {want}")
                            if dtype == torch.float32:
                                k1_err = max(k1_err, abs(got - want))
                            n += 1
    return n, k1_err, k2_err


# ------------------------------------------------------------- timing
def time_ms(fn, iters=TIMED_ITERS, warmup=WARMUP):
    """(device ms, host ms) per call over ``iters`` back-to-back calls:
    CUDA events around the run, and the host clock around issuing it.
    Host ms near device ms means the host, not the card, sets the pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "libpll_tpu_torch" / "csrc" / "clv_fused.cu").exists():
        fail(f"no libpll_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    # float32 products stay float32 in every plain reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_RATE_CATS,
                                                 FLAGSHIP_SITES,
                                                 FLAGSHIP_STATES,
                                                 FLAGSHIP_TIPS,
                                                 build_flagship)

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1 card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    cf.load_kernels()
    build_s = time.perf_counter() - t0
    logs = sorted(_build.BUILD_DIR.glob("clv_fused-*.log"))
    usage = [ln.strip() for ln in logs[-1].read_text().splitlines()
             if "registers" in ln or "spill" in ln] if logs else []
    spills = [ln for ln in usage if "spill" in ln and " 0 bytes spill" not in ln]
    print(f"[2 build] clv_fused.cu for sm_90a in {build_s:.2f} s; "
          f"{len(usage) // 2} kernel instances; ptxas: "
          f"{usage[1] if len(usage) > 1 else 'n/a'}; "
          f"instances with spills: {len(spills)}", flush=True)

    t0 = time.perf_counter()
    n, k1_small, k2_small = check_small(device)
    print(f"[3 small] {n} kernel configurations match their plain versions "
          f"({time.perf_counter() - t0:.1f} s); largest f32 deviations: K1 "
          f"|d logL| {k1_small:.3e}, K2 CLV abs {k2_small:.3e}", flush=True)

    # ---------------------------------------------------- 4: flagship
    tips, sites = FLAGSHIP_TIPS, FLAGSHIP_SITES
    c, s = FLAGSHIP_RATE_CATS, FLAGSHIP_STATES
    topo, model_np, masks, _ = build_flagship(tips, sites, rate_cats=c,
                                              seed=0, tip_masks=True)
    sched = topo.schedule
    tp = cf.pack_tipchars(masks).to(device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    m64 = model_from_numpy(model_np, device, torch.float64)
    score = ev.make_score(topo, c, s, tip_encoding="chars").to(device)
    fwd = ev.make_forward_fused(topo, c, s, tip_encoding="chars").to(device)

    clv64 = torch.cat([
        cf.decode_tips(tp, "chars", torch.arange(tips, device=device), c, s,
                       torch.float64),
        torch.zeros((sched.n_inner, c, s, sites), dtype=torch.float64,
                    device=device)])
    scal = torch.zeros((sched.n_inner + 1, sites), dtype=torch.int32,
                       device=device)
    want = float(ev.make_forward(topo).to(device)(m64, clv64, scal)[0])
    del clv64, scal

    cf.fused_edge_score.launches = 0
    cf.fused_sweep.launches = 0
    got_score = float(score(m32, tp))
    got_fwd = float(fwd(m32, tp)[0])
    torch.cuda.synchronize()
    launches = {"fused_edge_score": cf.fused_edge_score.launches,
                "fused_sweep": cf.fused_sweep.launches}
    check(all(v > 0 for v in launches.values()),
          f"main path skipped a kernel: launches {launches}")
    budget = ACC_REL * abs(want) + ACC_ABS
    for name, got in (("make_score", got_score),
                      ("make_forward_fused", got_fwd)):
        check(np.isfinite(got) and abs(got - want) <= budget,
              f"flagship {name} f32 logL {got} vs plain f64 {want} "
              f"(budget {budget})")

    # each kernel against its plain version at the main path's shapes
    pm, wvec, pw, _ = kernel_inputs(topo, model_np, torch.float32, device,
                                    False)
    edge = dict(parent_clv=topo.parent_clv, child_clv=topo.child_clv,
                edge_matrix=topo.edge_matrix, tip_encoding="chars")
    k1 = lambda: cf.fused_edge_score(sched, tp, pm, wvec, pw, ops=score.ops,
                                     **edge)
    k1_plain = lambda: cf.fused_edge_score_plain(sched, tp, pm, wvec, pw,
                                                 **edge)
    k2 = lambda: cf.fused_sweep(sched, tp, pm, ops=fwd.ops,
                                tip_encoding="chars")
    k2_plain = lambda: cf.fused_sweep_plain(sched, tp, pm,
                                            tip_encoding="chars")
    k1_err = abs(float(k1()) - float(k1_plain()))
    check(k1_err <= budget, f"flagship K1 vs plain: |d logL| {k1_err}")
    ok, k2_err, agree = sweep_close(*k2(), *k2_plain(), torch.float32)
    check(ok, f"flagship K2 vs plain: max abs err {k2_err}, scaler "
              f"agreement {agree}")
    print(f"[4 flagship] {tips} taxa x {sites} sites x {c} rates f32 chars: "
          f"make_score {got_score:.6f}, make_forward_fused {got_fwd:.6f}, "
          f"plain f64 make_forward {want:.6f} (|d| {abs(got_score - want):.3e}"
          f", {abs(got_fwd - want):.3e} <= {budget:.3e}); launches "
          f"{launches}; K1-plain |d logL| {k1_err:.3e}; K2-plain max abs "
          f"{k2_err:.3e}, scalers agree {agree:.6f}", flush=True)

    # ---------------------------------------------------- 5: times
    updates = sched.n_inner * sites * c

    def score_plain():  # make_score's forward with the plain K1
        pmatrix = score.pmatrices(m32, torch.float32)
        w = cf.pack_weight_vec(m32["freqs_pc"], m32["rate_weights"])
        return cf.fused_edge_score_plain(sched, tp, pmatrix, w,
                                         m32["pattern_weights"], **edge)

    runs = {"score": lambda: score(m32, tp), "score_plain": score_plain,
            "forward_fused": lambda: fwd(m32, tp), "k1": k1,
            "k1_plain": k1_plain, "k2": k2, "k2_plain": k2_plain}
    timed = {name: time_ms(fn) for name, fn in runs.items()}
    ms = {name: dev for name, (dev, _) in timed.items()}
    host = {name: h for name, (_, h) in timed.items()}
    print(f"[5 times] {card}: make_score (K1) {ms['score']:.4f} ms/eval = "
          f"{updates / ms['score'] * 1e3:.4e} CLV updates/s (host issues a "
          f"call in {host['score']:.4f} ms); with the plain K1 "
          f"{ms['score_plain']:.4f} ms/eval = "
          f"{updates / ms['score_plain'] * 1e3:.4e}/s; make_forward_fused "
          f"(K2) {ms['forward_fused']:.4f} ms/eval (host "
          f"{host['forward_fused']:.4f} ms); kernel alone K1 {ms['k1']:.4f} "
          f"ms vs plain {ms['k1_plain']:.4f} ms; K2 {ms['k2']:.4f} ms vs "
          f"plain {ms['k2_plain']:.4f} ms ({TIMED_ITERS} calls after "
          f"{WARMUP} warm-up, CUDA events)", flush=True)

    src = "libpll_tpu_torch/csrc/clv_fused.cu"
    print(json.dumps({"kernels": [
        {"name": "fused_edge_score", "route": "cuda", "source": src,
         "replaces": "libpll_tpu/ops/clv_pallas.py:462",
         "launches": launches["fused_edge_score"], "max_abs_err": k1_err,
         "ms": ms["k1"], "plain_ms": ms["k1_plain"]},
        {"name": "fused_sweep", "route": "cuda", "source": src,
         "replaces": "libpll_tpu/ops/clv_pallas.py:673",
         "launches": launches["fused_sweep"], "max_abs_err": k2_err,
         "ms": ms["k2"], "plain_ms": ms["k2_plain"]}]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
