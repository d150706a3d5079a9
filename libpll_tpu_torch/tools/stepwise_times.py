"""Time the stepwise-addition build of several checkouts in turns on one
card.

    python3 libpll_tpu_torch/tools/stepwise_times.py [TREE ...]

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.

Measured at chip_smoke's stepwise configurations (``STEPWISE_CASES``:
scripts/bench_stepwise.py's random ACGT alignments, 2 048 x 2 048 and
500 x 10 000, stepwise seed 42), for each: the wall time of the device
engine (P2 + P3) twice and of the host engine (P1 + P2) once, the card
synchronised at the ends; the score and the SHA-256 of the Newick (each
build must give libpll_tpu's, ``STEPWISE_JAX``); one device build under
``torch.profiler``: P2's and P3's device time a launch and the device's
idle share over the kernels' span; the peak device memory of a device
build.  At 500 x 10 000 the host engine under the profiler too: P1's and
P2's device time a launch and its idle share (the host engine launches
one P1 a wave, ~10^5 of them there and ~5 x 10^5 at 2 048 taxa).  Each run
prints one JSON line; the card's name and power limit come first.
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


def measure(tree):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import fastparsimony_stepwise

    _build.build_all(["fitch"])
    out = {"tree": str(tree)}
    for tips, sites in cs.STEPWISE_CASES:
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
            if got != want:
                raise SystemExit(f"{tips} x {sites} {engine}: {got} is not "
                                 f"libpll_tpu's {want}")
            return wall

        case = {"device_s": [build("device") for _ in range(2)],
                "host_s": build("host")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            build("device")
        case["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        case["device_us"], case["device_idle"] = per_launch(cs, prof)
        if tips <= HOST_PROFILE_TIPS:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                build("host")
            case["host_us"], case["host_idle"] = per_launch(cs, prof)
        out[f"{tips}x{sites}"] = case
        del part
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv):
    if argv[:1] == ["--measure"]:
        measure(Path(argv[1]))
        return 0
    print(f"card: {card_line()}", flush=True)
    for tree in argv or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--measure",
                        str(Path(tree).resolve())], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
