"""Time the Partition's two op executors on one card, across tree sizes,
site counts and dtypes.

    python3 libpll_tpu_torch/tools/partition_times.py [--tips 64 512]
        [--sites 1024 16384 262144] [--max-gib 12]

For each (taxa, sites, dtype) a random binary tree's full post-order op
list runs through ``ops/clv.update_partials_by_op`` (one op at a time)
and ``ops/clv.update_partials_grouped`` (hazard-free groups batched) on
the same buffers (random tip rows, random P-matrices, per-site scaling),
in turns: device ms per call by CUDA events over back-to-back calls after
warm-up, and the host ms of one call with the card idle (median).  Both
results are checked equal first.  Configurations whose CLV buffer would
exceed ``--max-gib`` are skipped.  Prints one line per configuration and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def random_newick(tips, rng):
    items = [f"t{i}:{rng.uniform(0.05, 0.5):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b, a = items.pop(j), items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.5):.4f}")
    return f"({items[0]},{items[1]},{items[2]});"


def timed(fn, iters, warmup=2):
    """(device ms, host ms with the card idle) per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    dev = start.elapsed_time(end) / iters
    host = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return dev, float(np.median(host))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tips", type=int, nargs="+", default=[16, 64, 512])
    ap.add_argument("--sites", type=int, nargs="+",
                    default=[1024, 8192, 65536, 262144])
    ap.add_argument("--rate-cats", type=int, default=4)
    ap.add_argument("--max-gib", type=float, default=12.0)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("partition_times: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from libpll_tpu_torch.engine.partition import operations_to_array
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.constants import SCALE_PER_SITE

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda", 0)
    c, s = args.rate_cats, 4
    runs = {"by_op": clv_ops.update_partials_by_op,
            "grouped": clv_ops.update_partials_grouped}
    for tips in args.tips:
        rng = np.random.default_rng(tips)
        tree = ut.parse_newick_string(random_newick(tips, rng))
        ops = ut.create_operations(ut.traverse(tree.root))[0]
        inner = tips - 2
        table = operations_to_array(ops, inner)
        groups = int(clv_ops.hazard_levels(table, inner).max()) + 1
        for sites in args.sites:
            for dtype in (torch.float32, torch.float64):
                row = c * s * sites * dtype.itemsize
                if (tips + inner) * row > args.max_gib * 2**30:
                    continue
                clv = torch.zeros((tips + inner, c, s, sites), dtype=dtype,
                                  device=dev)
                clv[:tips] = torch.rand((tips, 1, s, sites), dtype=dtype,
                                        device=dev)
                pm = torch.rand((2 * tips - 3, c, s, s), dtype=dtype,
                                device=dev)
                out = {}
                for name, run in runs.items():
                    scal = torch.zeros((inner + 1, sites), dtype=torch.int32,
                                       device=dev)
                    buf = clv.clone()
                    run(buf, scal, table, pm, SCALE_PER_SITE)
                    out[name] = (buf, scal)
                if not (torch.equal(out["by_op"][1], out["grouped"][1])
                        and torch.allclose(out["by_op"][0], out["grouped"][0],
                                           rtol=1e-5, atol=0)):
                    raise SystemExit(f"executors differ at {tips} x {sites}")
                del out
                scal = torch.zeros((inner + 1, sites), dtype=torch.int32,
                                   device=dev)
                ms = {}
                for name in ("by_op", "grouped", "grouped", "by_op"):
                    ms.setdefault(name, []).append(timed(
                        lambda: runs[name](clv, scal, table, pm,
                                           SCALE_PER_SITE), args.iters))
                line = ", ".join(
                    f"{name} " + " / ".join(f"{d:.4f} ms (host {h:.4f})"
                                            for d, h in v)
                    for name, v in ms.items())
                print(f"{tips} taxa ({len(ops)} ops, {groups} groups) x "
                      f"{sites} sites {str(dtype)[6:]} (row "
                      f"{row / 2**20:.2f} MiB): {line}", flush=True)
                del clv, scal, pm
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
