"""Time the replay kernels U1 and C1 of several checkouts, or of source
variants of ``csrc/partials.cu``, in turns on one card.

    python3 libpll_tpu_torch/tools/replay_times.py [TREE ...]
    python3 libpll_tpu_torch/tools/replay_times.py --variants SPEC.json NAME ...
    python3 libpll_tpu_torch/tools/replay_times.py --alphabet

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.  A variant is this checkout's ``partials.cu``
with the text substitutions ``SPEC.json`` names for it
(``tools/variants.py``; ``tools/replay_ablations.json``), built by nvcc
beside the package's build and called in place of its library.

Measured: U1 (``ops.clv.replay_ops``) on a full ``update_partials`` of the
float64 flagship Partition (chip_smoke's ``flagship_blopt_partition``:
64 taxa, 262 144 patterns, GTR+Γ4, 62 ops), device ms a call over
back-to-back calls (``chip_smoke.time_ms``) and a SHA-256 of its output,
to compare bits between runs; U1 at scripts/bench_infer.py's sweep
tables (this checkout's ``chip_smoke.sweep_shape_case``: a random
1 024-taxon tree's branch-length sweep tables, 32 slots each, over float32
rows of 16 384 sites; the first ``SWEEP_TIMED`` tables in turn), device µs
a launch (torch.profiler) and a SHA-256 of the buffers after one pass;
U1's float32 error on the second draw of chip_smoke's random op tables
(``chip_smoke.replay_second_draw``: against the plain executor on the card
and on the CPU, and those two against each other, by phase 3's rule) with
a SHA-256 of U1's outputs; the
round scorer (``search/spr.make_round_scorer``, C1 and whatever runs
around it) on two batches: the first of chip_smoke phase 31's SPR cell
(``spr_partition``: scripts/bench_spr.py's 1 024 taxa x 16 384 sites, 32
candidates, capacity 128) and the first of scripts/bench_infer.py's first
SPR round up to its branch lengths (the stepwise start tree of
``infer_alignment(1024, 16384)``, radius 5, 128 candidates, capacity 32):
the card's time a call and C1's alone (torch.profiler), the host's wall
time a call, the logL summed.  A variant's U1 and C1 run through the
package with the variant's library.  Each run prints one JSON line; the
card's name and power limit come first.

``--alphabet`` (this checkout, one process): U1 outside the DNA and
protein instances, a full ``update_partials`` of chip_smoke phase 36's
binary float64 Partition (``alphabet_partition``: 2 states, 6 rates,
64 taxa x 65 536 sites), device ms a call and a SHA-256 of its output
under ``replay_plan``'s own layout and under each of ``ALPHABET_FORCED``
(``chip_smoke.ForcedReplayPlan``): one lane a site with the table staged,
and one lane a site with nothing staged, the layout of the any-alphabet
op that K1/K2 and C1 run (a thread a site, P-matrices read from device
memory).
"""

import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import build_variants, card_line  # noqa: E402


def _digest(*tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def spr_cell(cs, device):
    """chip_smoke phase 31's SPR cell: (partition, tree, candidates)."""
    from libpll_tpu_torch.search import spr
    from libpll_tpu_torch.tree import utree as ut

    part, tree = cs.spr_partition(device)
    cs.full_state(tree, part, [0] * 4)
    prune = ut.query_innernodes(tree)[:cs.SPR_PRUNE]
    enc, _ = spr.encode_candidates(tree, spr.spr_neighborhood(
        tree, cs.SPR_RADIUS, prune_nodes=prune))
    return part, tree, enc


def infer_start(cs, device):
    """scripts/bench_infer.py's first SPR round up to its branch lengths:
    ``infer_alignment(1024, 16384)`` compressed, the stepwise start tree
    of seed 42 (zero lengths 0.1, as ``infer_tree`` sets them), a float32
    Partition of SEARCH_GTR with the pattern weights, fully evaluated, and
    the radius-5 SPR neighbourhood encoded: (partition, tree,
    candidates)."""
    import torch

    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.io.compress import compress_site_patterns
    from libpll_tpu_torch.search import spr
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import (deep_recursion,
                                                  fastparsimony_stepwise)
    from libpll_tpu_torch.utils.flagship import infer_alignment

    data, _ = infer_alignment(cs.BENCH_INFER_TIPS, cs.BENCH_INFER_SITES)
    labels = list(data)
    patterns, weights = compress_site_patterns([data[k] for k in labels],
                                               maps.pll_map_nt)
    pars = FastParsimony.from_sequences(patterns, maps.pll_map_nt, 4,
                                        pattern_weights=weights)
    with deep_recursion(len(labels)):
        tree, _ = fastparsimony_stepwise([pars], labels, 42)
        for n in tree.nodes:
            for m in ([n] if n.is_tip else n.ring()):
                if m.length == 0.0:
                    m.length = 0.1
                m.back.length = m.length
        part = cs.search_partition(tree, dict(zip(labels, patterns)),
                                   len(patterns[0]), "site", torch.float32,
                                   device)
        part.set_pattern_weights(weights)
        cs.full_state(tree, part, [0] * 4)
        enc, _ = spr.encode_candidates(tree, spr.spr_neighborhood(tree, 5))
    del pars
    return part, tree, enc


def scorer_batch(cs, part, tree, enc, cap, batch):
    """The round scorer on the first batch of ``enc``: under
    torch.profiler over five calls, the card's time a call (every kernel:
    the P-matrices, C1, the fold or the asc tail) and C1's kernel alone;
    the host's wall time a call (the card synchronised, median of five);
    the batch's logL summed over its real candidates."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libpll_tpu_torch.engine.evaluate import partition_model
    from libpll_tpu_torch.search import spr

    b, t, mi, bl, er = next(spr.encoded_batches(
        enc, part.nodes, part.scale_buffers, cap, batch))
    scorer = spr.make_round_scorer(part, cap)
    model = partition_model(part, [0] * 4)

    def call():
        return scorer(part.clv, part.scalers, part.pmatrix, model, t, mi,
                      bl, er)

    logl = float(call()[:b].double().sum())
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    got, _ = cs.kernel_ms(prof, ("", "candidates_kernel"))
    return {"batch": len(t), "real": b, "card_ms": got[""][0] / 5,
            "kernels_a_call": got[""][1] / 5,
            "c1_ms": got["candidates_kernel"][0] / 5,
            "wall_ms": float(np.median(walls)), "logl_sum": logl}


def sweep_u1(cs_now, clv_ops, device):
    """U1 at bench_infer's sweep tables (``sweep_shape_case`` of this
    checkout's chip_smoke, run on the measured tree's package): device µs
    a launch over the first SWEEP_TIMED tables (torch.profiler) and a
    SHA-256 of the buffers after one pass over them from the same start."""
    import torch

    clv, scal, pm, tables, _ = cs_now.sweep_shape_case(device)
    start = (clv.clone(), scal.clone())
    n = cs_now.SWEEP_TIMED

    def run():
        for e in range(n):
            clv_ops.replay_ops(clv, scal, tables[e], pm, 1)

    run()
    torch.cuda.synchronize()
    out = {"sweep_sha256": _digest(clv, scal)}
    clv.copy_(start[0])
    scal.copy_(start[1])
    out["sweep_us"] = cs_now.profiled_ms(run, "replay_kernel",
                                         iters=3) / n * 1e3
    del clv, scal, pm, tables, start
    torch.cuda.empty_cache()
    return out


ALPHABET_FORCED = ((1, None), (1, 0))  # (lanes, window): see the docstring


def measure_alphabet():
    """``--alphabet``: the numbers of the module docstring's last part."""
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.engine.partition import operations_to_array
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.tree import utree as ut

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    s, c, tips, sites = cs.BINARY_PART
    tree, part = cs.alphabet_partition(device, s, c, tips, sites, seed=0)()
    ops, branches, pmat_idx = ut.create_operations(ut.traverse(tree.root))
    part.update_prob_matrices([0] * c, pmat_idx, branches)
    table = torch.from_numpy(operations_to_array(
        ops, part.scale_buffers)).to(device)
    start = (part.clv.clone(), part.scalers.clone())
    out = {"states": s, "rate_cats": c, "tips": tips, "sites": sites}
    for lanes, window in ((None, None),) + ALPHABET_FORCED:
        key = "plan" if lanes is None else f"lanes{lanes}_window{window}"
        with cs.ForcedReplayPlan(lanes, window):
            plan = clv_ops.replay_plan(sites, c, s, clv_ops._sms(0),
                                       table.shape[0], 8)

            def run_u1():
                clv_ops.replay_ops(part.clv, part.scalers, table,
                                   part.pmatrix, part.scale_mode)

            part.clv.copy_(start[0])
            part.scalers.copy_(start[1])
            run_u1()
            out[key] = dict(lanes=plan.lanes, window=plan.window,
                            sha256=_digest(part.clv, part.scalers),
                            ms=cs.time_ms(run_u1, iters=10, warmup=2)[0])
    print(json.dumps(out), flush=True)


def measure(tree, lib_path=None):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import importlib.util

    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.engine.partition import operations_to_array
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops import incremental as inc_ops
    from libpll_tpu_torch.tree import utree as ut

    spec = importlib.util.spec_from_file_location("chip_smoke_now",
                                                  ROOT / "chip_smoke.py")
    cs_now = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs_now)
    device = torch.device("cuda", 0)
    if lib_path is not None:  # the package's U1 and C1 through the variant
        real_load = _build.load
        _build.load = lambda name: (ctypes.CDLL(str(lib_path))
                                    if name == "partials" else real_load(name))
        for fn in (clv_ops.load_kernels, inc_ops.load_kernels,
                   inc_ops._smem_limit):
            fn.cache_clear()
    out = {"tree": str(tree), "variant": lib_path and Path(lib_path).parent.name}

    part, _, tree_, pidx, _, _ = cs.flagship_blopt_partition(device)
    ops, branches, pmat_idx = ut.create_operations(ut.traverse(tree_.root))
    part.update_prob_matrices(pidx, pmat_idx, branches)
    table = torch.from_numpy(operations_to_array(
        ops, part.scale_buffers)).to(device)

    def run_u1():
        clv_ops.replay_ops(part.clv, part.scalers, table, part.pmatrix,
                           part.scale_mode)

    run_u1()
    out["u1_sha256"] = _digest(part.clv, part.scalers)
    out["u1_ms"] = cs.time_ms(run_u1, iters=10, warmup=2)[0]
    del part
    torch.cuda.empty_cache()
    out.update(sweep_u1(cs_now, clv_ops, device))
    out["f32_errors"], out["f32_sha256"] = cs_now.replay_second_draw(
        clv_ops.replay_ops, device)

    if hasattr(cs, "spr_partition"):
        out["c1_32"] = scorer_batch(cs, *spr_cell(cs, device), cs.SPR_CAP,
                                    cs.SPR_BATCH)
        out["c1_128"] = scorer_batch(cs, *infer_start(cs, device), 32, 128)
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--alphabet"]:
        print(f"card: {card_line()}", flush=True)
        measure_alphabet()
        return 0
    if argv[:1] == ["--measure"]:
        measure(Path(argv[1]), argv[2] or None)
        return 0
    print(f"card: {card_line()}", flush=True)
    if argv[:1] == ["--variants"]:
        spec = json.loads(Path(argv[1]).read_text())
        libs = build_variants(spec, argv[2:], "partials")
        runs = [(str(ROOT), str(libs[name])) for name in argv[2:]]
    else:
        runs = [(str(Path(tree).resolve()), "")
                for tree in argv or [ROOT]]
    for run in runs:
        subprocess.run([sys.executable, __file__, "--measure", *run],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
