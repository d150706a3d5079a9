"""Time the training step at the flagship on one card, and take its device
time apart by kernel.

    python3 libpll_tpu_torch/tools/train_times.py

At the flagship (64 taxa x 262 144 sites, GTR+Γ4, float32, nibble-packed
tips simulated on the tree, seed 0): ``make_train_step_fused`` per step,
eager and captured in a CUDA graph (device ms per call, CUDA events over
back-to-back calls, ``chip_smoke.time_ms``) and the host ms of one call
with the card idle (``chip_smoke.host_ms``); N1 alone on the step's
inputs with 1, 8 and 32 launches (float32: every launch runs a body), and
on ``make_train_step``'s float64 inputs, where the loop ends early and
the later launches return at once; and the device time of the graphed
step by kernel (``torch.profiler`` over a few replays: K2, N1 and the
rest, kernels per step, and the device's idle share between the first
kernel's start and the last one's end).  Prints the card's name and power
limit, then one JSON line.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import card_line  # noqa: E402

REPLAYS = 5


def by_kernel(prof, steps):
    """Device ms per step of K2, N1 and the other kernels, kernels per
    step, and the idle share of the device over the kernels' span, from
    the profiler's kernel events (None where it recorded none)."""
    import torch

    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    groups = {"K2": 0.0, "N1": 0.0, "other": 0.0}
    for start, end, name in spans:
        key = ("K2" if "fused_kernel" in name else
               "N1" if "newton_kernel" in name else "other")
        groups[key] += (end - start) / 1e3 / steps
    first = min(s for s, _, _ in spans)
    last = max(e for _, e, _ in spans)
    busy = sum(groups.values()) * steps
    return dict(ms=groups, kernels=len(spans) / steps,
                idle=1.0 - busy / ((last - first) / 1e3))


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.utils.flagship import build_flagship

    if not torch.cuda.is_available():
        raise SystemExit("train_times: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(), flush=True)
    device = torch.device("cuda", 0)
    topo, model_np, masks, _ = build_flagship(64, 262144, seed=0,
                                              tip_masks=True, simulate=True)
    tp = cf.pack_tipchars(masks).to(device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    step = ev.make_train_step_fused(topo, 4, 4, tip_encoding="chars",
                                    device=device)
    graphed = step.graphed(m32, tp)
    args = step.newton_inputs(m32, tp)[1]

    sched, sites = topo.schedule, tp.shape[-1]
    m64 = model_from_numpy(model_np, device, torch.float64)
    clv64 = torch.zeros((sched.tips + sched.n_inner, 4, 4, sites),
                        dtype=torch.float64, device=device)
    clv64[:sched.tips] = cf.decode_tips(
        tp, "chars", torch.arange(sched.tips, device=device), 4, 4,
        torch.float64)
    scal = torch.zeros((sched.n_inner + 1, sites), dtype=torch.int32,
                       device=device)
    args64 = ev.make_train_step(topo, device=device).newton_inputs(
        m64, clv64, scal)[3]
    del clv64, scal

    out = {"step_ms": cs.time_ms(lambda: step(m32, tp))[0],
           "graph_ms": cs.time_ms(lambda: graphed(m32, tp))[0],
           "step_host_ms": cs.host_ms(lambda: step(m32, tp)),
           "graph_host_ms": cs.host_ms(lambda: graphed(m32, tp))}
    for launches in (1, 8, 32):
        out[f"n1_ms_{launches}"] = cs.time_ms(
            lambda: dv.newton_solve(**args, max_iters=launches))[0]
    out["n1_f64_ms"] = cs.time_ms(lambda: dv.newton_solve(**args64))[0]
    out["n1_f64_bodies"] = int(dv.newton_solve(**args64).iterations)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPLAYS):
            graphed(m32, tp)
        torch.cuda.synchronize()
    out["graph_by_kernel"] = by_kernel(prof, REPLAYS)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
