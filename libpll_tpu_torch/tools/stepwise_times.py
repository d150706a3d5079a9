"""Time the stepwise-addition build of several checkouts in turns on one
card.

    python3 libpll_tpu_torch/tools/stepwise_times.py [TREE ...]
    python3 libpll_tpu_torch/tools/stepwise_times.py --variants SPEC.json NAME ...

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.

Measured at chip_smoke's stepwise configurations (``STEPWISE_CASES``:
scripts/bench_stepwise.py's random ACGT alignments, 2 048 x 2 048 and
500 x 10 000, stepwise seed 42) and at scripts/bench_infer.py's start
tree (``infer_alignment(1024, 16384)`` compressed to patterns with their
weights, seed 42, as ``infer_tree`` builds it), for each: the wall time of
the device engine (P2 + P3) twice and (not at bench_infer's) of the host
engine (P1 + P2) once, the card synchronised at the ends; the score and
the SHA-256 of the Newick (chip_smoke's cases must give libpll_tpu's,
``STEPWISE_JAX``; bench_infer's score must be ``BENCH_INFER_START_JAX``);
one device build under ``torch.profiler``: P2's and P3's device time a
launch and the device's idle share over the kernels' span; the peak
device memory of a device build; P3 at the last insertion (the state
before it built by the kernels, five calls on clones of it under the
profiler).  For the host engine its P1 launches in the build
(``fitch_waves.launches``: one a wave before the one-launch P1, ~10^5 at
500 x 10 000 and ~5 x 10^5 at 2 048 taxa; one a call since), and at
chip_smoke's configurations P1 over the final tree's traversal, one
``fitch_waves`` call of its waves: device ms a call (five calls on clones
of the rows, ``chip_smoke.profiled_ms``).  At 500 x 10 000 the host
engine under the profiler too: P1's and P2's device time a launch and its
idle share.  Each run prints one JSON line; the card's name and power
limit come first.  ``--variants`` times P3's text-substituted variants
(``tools/variants.py``; ``tools/stepwise_ablations.json``) at the last
insertions instead (``ablate``).
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import card_line  # noqa: E402

HOST_PROFILE_TIPS = 500  # the host engine is profiled up to this size
KERNELS = {"P1": "fitch_wave_kernel", "P2": "fitch_scores_kernel",
           "P3": "stepwise_commit_kernel"}


def per_launch(cs, prof):
    """({kernel: µs a launch, launches}, idle share) of a profile."""
    got, idle = cs.kernel_ms(prof, tuple(KERNELS.values()))
    return ({k: (got[name][0] * 1e3 / max(got[name][1], 1), got[name][1])
             for k, name in KERNELS.items()}, idle)


def infer_part(cs):
    """scripts/bench_infer.py's alignment as ``infer_tree`` packs it for
    its start tree: (FastParsimony of the patterns with their weights,
    labels)."""
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.io.compress import compress_site_patterns
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.utils.flagship import infer_alignment

    data, _ = infer_alignment(cs.BENCH_INFER_TIPS, cs.BENCH_INFER_SITES)
    labels = list(data)
    patterns, weights = compress_site_patterns([data[k] for k in labels],
                                               maps.pll_map_nt)
    return FastParsimony.from_sequences(patterns, maps.pll_map_nt, 4,
                                        pattern_weights=weights), labels


def last_insertion_us(cs, part, tips, seed):
    """P3's device µs a call at the last insertion of the device build
    (torch.profiler, five calls on clones of the state before it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search.stepwise import direction_rows
    from libpll_tpu_torch.utils.rng import shuffled_order

    order = shuffled_order(tips, seed)
    rows = direction_rows([part])
    topo = fitch.stepwise_topology(order, part.vectors.device)
    scores = torch.empty(2 * tips - 3, dtype=torch.int32,
                         device=part.vectors.device)
    fitch.stepwise_commit(rows, *topo, mode="star")
    for i in range(3, tips):
        fitch.fitch_scores(*rows[0], topo[1][:2 * i - 3], back=topo[0],
                           tip=order[i], out=scores[:2 * i - 3])
        if i < tips - 1:
            fitch.stepwise_commit(rows, *topo, mode="insert", scores=scores,
                                  insertion=i, tip=order[i])
    trials = [([(v.clone(), c.clone()) for v, c in rows],
               (topo[0].clone(), topo[1].clone()) + topo[2:])
              for _ in range(5)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r, t in trials:
            fitch.stepwise_commit(r, *t, mode="insert", scores=scores,
                                  insertion=tips - 1, tip=order[tips - 1])
        torch.cuda.synchronize()
    got, _ = cs.kernel_ms(prof, (KERNELS["P3"],))
    return got[KERNELS["P3"]][0] * 1e3 / 5


def final_tree_p1(cs, part, labels):
    """P1 over the final tree of the device build of ``part``: one
    ``fitch_waves`` call of its traversal's waves, device ms a call (five
    calls on clones of the rows under torch.profiler) and the waves."""
    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search import stepwise as sw
    from libpll_tpu_torch.search.parsimony import _group_levels
    from libpll_tpu_torch.tree import utree as ut

    tree, _ = sw.StepwiseBuilder([part], labels).build_device(
        cs.STEPWISE_SEED)
    with sw.deep_recursion(len(labels)):
        levels = _group_levels(ut.create_pars_buildops(
            ut.traverse(tree.root)))
    rows = {}

    def reset():
        rows["v"], rows["c"] = part.vectors.clone(), part.costs.clone()

    ms = cs.profiled_ms(lambda: fitch.fitch_waves(rows["v"], rows["c"],
                                                  levels),
                        KERNELS["P1"], reset)
    return float(ms), len(levels)


def measure(tree):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.ops import _build, fitch
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import fastparsimony_stepwise

    _build.build_all(["fitch"])
    out = {"tree": str(tree)}
    cases = [(tips, sites, "") for tips, sites in cs.STEPWISE_CASES] + [
        (cs.BENCH_INFER_TIPS, cs.BENCH_INFER_SITES, " bench_infer")]
    for tips, sites, name in cases:
        if name:
            part, labels = infer_part(cs)
            want = (cs.BENCH_INFER_START_JAX,)
        else:
            seqs, labels = cs.bench_stepwise_alignment(tips, sites)
            part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4)
            want = cs.STEPWISE_JAX[(tips, sites)]

        def build(engine):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree_, score = fastparsimony_stepwise([part], labels,
                                                  cs.STEPWISE_SEED,
                                                  engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = (score, *cs.newick_digest(tree_))
            if got[:len(want)] != want:
                raise SystemExit(f"{tips} x {sites} {engine}: {got} is not "
                                 f"libpll_tpu's {want}")
            out.setdefault("newick", {})[f"{tips}x{sites}"] = got[1][:16]
            return wall

        case = {"device_s": [build("device") for _ in range(2)],
                "host_s": None}
        if not name:
            fitch.fitch_waves.launches = 0
            case["host_s"] = build("host")
            case["host_p1_launches"] = fitch.fitch_waves.launches
            case["p1_final_ms"], case["p1_final_waves"] = final_tree_p1(
                cs, part, labels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            build("device")
        case["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        case["device_us"], case["device_idle"] = per_launch(cs, prof)
        case["p3_last_us"] = last_insertion_us(cs, part, tips,
                                                cs.STEPWISE_SEED)
        if tips <= HOST_PROFILE_TIPS:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                build("host")
            case["host_us"], case["host_idle"] = per_launch(cs, prof)
        out[f"{tips}x{sites}{name}"] = case
        del part
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def ablate(spec_path, names):
    """P3's variants of ``csrc/fitch.cu`` (``tools/variants.py``), timed
    in turns in this process on the same states: the last insertion of
    the 2 048 x 2 048 build and of bench_infer's start tree, each state
    built by this checkout's P3, each variant on clones of it (five calls
    a variant, device µs by CUDA events with the card kept busy while
    the call is issued, ``chip_smoke.busy_event_ms``).  Timing only: an
    ablation may compute wrong values."""
    sys.path.insert(0, str(ROOT))
    import ctypes

    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.ops import _build, fitch
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import direction_rows
    from libpll_tpu_torch.utils.rng import shuffled_order
    from variants import build_variants

    libs = build_variants(json.loads(Path(spec_path).read_text()), names,
                          "fitch")
    real_load = _build.load
    states = {}
    seqs, _ = cs.bench_stepwise_alignment(*cs.STEPWISE_CASES[0])
    for key, (part, tips) in {
            "2048x2048": (FastParsimony.from_sequences(
                seqs, maps.pll_map_nt, 4), cs.STEPWISE_CASES[0][0]),
            "1024x16384 bench_infer": (infer_part(cs)[0],
                                       cs.BENCH_INFER_TIPS)}.items():
        order = shuffled_order(tips, cs.STEPWISE_SEED)
        rows = direction_rows([part])
        topo = fitch.stepwise_topology(order, part.vectors.device)
        scores = torch.empty(2 * tips - 3, dtype=torch.int32,
                             device=part.vectors.device)
        fitch.stepwise_commit(rows, *topo, mode="star")
        for i in range(3, tips):
            fitch.fitch_scores(*rows[0], topo[1][:2 * i - 3], back=topo[0],
                               tip=order[i], out=scores[:2 * i - 3])
            if i < tips - 1:
                fitch.stepwise_commit(rows, *topo, mode="insert",
                                      scores=scores, insertion=i,
                                      tip=order[i])
        states[key] = (rows, topo, scores, tips, order[tips - 1])
    for name in names:
        _build.load = lambda n, lib=libs[name]: (
            ctypes.CDLL(str(lib)) if n == "fitch" else real_load(n))
        fitch.load_kernels.cache_clear()
        fitch._limits.cache_clear()
        out = {"variant": name}
        for key, (rows, topo, scores, tips, tip) in states.items():
            trial = {}

            def reset():
                trial["rows"] = [(v.clone(), c.clone()) for v, c in rows]
                trial["topo"] = (topo[0].clone(), topo[1].clone()) + topo[2:]

            out[key] = cs.busy_event_ms(lambda: fitch.stepwise_commit(
                trial["rows"], *trial["topo"], mode="insert", scores=scores,
                insertion=tips - 1, tip=tip), reset) * 1e3
        print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--measure"]:
        measure(Path(argv[1]))
        return 0
    print(f"card: {card_line()}", flush=True)
    if argv[:1] == ["--variants"]:
        ablate(argv[1], argv[2:])
        return 0
    for tree in argv or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--measure",
                        str(Path(tree).resolve())], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
