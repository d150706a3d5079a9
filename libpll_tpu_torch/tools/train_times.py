"""Time the training step and the Newton kernel N1 of several checkouts, or
of source variants of ``csrc/derivatives.cu``, in turns on one card, and
take the graphed step's device time apart by kernel.

    python3 libpll_tpu_torch/tools/train_times.py [--protein] [RUN ...]
    python3 libpll_tpu_torch/tools/train_times.py [--protein] --variants SPEC.json RUN ...

Each RUN is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A RUN that is a directory is a
checkout's root, measured with its own package and its own
``chip_smoke.py`` helpers (default: this one); with ``--variants``, any
other RUN names a variant of this checkout's ``derivatives.cu`` in
``SPEC.json`` (text substitutions, as ``tools/fused_times.py``'s;
``tools/newton_ablations.json``), built by nvcc beside the package's build
and loaded in place of its library.

Measured at the flagship (64 taxa x 262 144 sites, GTR+Γ4, float32,
nibble-packed tips simulated on the tree, seed 0): ``make_train_step_fused``
per step, eager and captured in a CUDA graph (device ms per call, CUDA
events over back-to-back calls, ``chip_smoke.time_ms``) and the host ms
of one call with the card idle (``chip_smoke.host_ms``); N1 alone on the
step's inputs with ``max_iters`` 1, 8 and 32 (``n1_ms_<k>``; float32:
every body runs), from the edge's rows as the step runs it where the
checkout has ``newton_rows`` (``n1_rows_ms_32``), and on
``make_train_step``'s float64 inputs, where the loop ends early; t* of
each as its repr, to compare bits between runs;
where the checkout plans N1's launch (``derivatives.plan_for``), the plan;
and the device time of the graphed step by kernel (``torch.profiler`` over
a few replays: K2, N1 and the rest, kernels per step, and the device's
idle share between the first kernel's start and the last one's end).
``--protein`` adds the protein configuration
(``utils/flagship.build_protein_flagship``: 64 taxa x 65 536 LG4X+Γ4
columns, float32): N1 alone on its step's inputs and the step eager and
graphed.  Each run prints one JSON line; the card's name and power limit
come first.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import build_variants, card_line  # noqa: E402

REPLAYS = 5
TOP = 12  # kernels named in the split, longest first


def by_kernel(prof, steps):
    """Device ms per step of K2, N1 and the other kernels, kernels per
    step, the idle share of the device over the kernels' span, and the
    TOP longest kernels by name (ms per step), from the profiler's kernel
    events (None where it recorded none)."""
    import torch

    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return None
    groups = {"K2": 0.0, "N1": 0.0, "other": 0.0}
    names = {}
    for start, end, name in spans:
        key = ("K2" if "fused_kernel" in name else
               "N1" if "newton" in name else "other")
        groups[key] += (end - start) / 1e3 / steps
        names[name[:60]] = names.get(name[:60], 0.0) + (end - start) / 1e3 / steps
    first = min(s for s, _, _ in spans)
    last = max(e for _, e, _ in spans)
    busy = sum(groups.values()) * steps
    top = sorted(names.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(ms=groups, kernels=len(spans) / steps,
                idle=1.0 - busy / ((last - first) / 1e3), top=dict(top))


def n1_numbers(cs, dv, args, prefix, iters=(32,)):
    """N1 on ``args``: ms with each ``max_iters``, bodies, t* and the plan
    (where the checkout has one)."""
    out = {}
    for k in iters:
        out[f"{prefix}_ms_{k}"] = cs.time_ms(
            lambda: dv.newton_solve(**args, max_iters=k))[0]
    got = dv.newton_solve(**args)
    out[f"{prefix}_bodies"] = int(got.iterations)
    out[f"{prefix}_t"] = repr(float(got.t))
    if hasattr(dv, "plan_for"):
        out[f"{prefix}_plan"] = dv.plan_for(
            args["sumtable"], args["sites"], args["asc_mode"])._asdict()
    return out


def measure(tree, lib, protein):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.utils.flagship import build_flagship

    torch.backends.cuda.matmul.allow_tf32 = False
    if lib is None:
        _build.build_all(["clv_fused", "derivatives"])
    else:
        loaded = dv.bind(ctypes.CDLL(str(lib)))
        dv.load_kernels = lambda: loaded
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

    out = {"tree": str(tree),
           "variant": None if lib is None else Path(lib).parent.name,
           "step_ms": cs.time_ms(lambda: step(m32, tp))[0],
           "graph_ms": cs.time_ms(lambda: graphed(m32, tp))[0],
           "step_host_ms": cs.host_ms(lambda: step(m32, tp)),
           "graph_host_ms": cs.host_ms(lambda: graphed(m32, tp)),
           "step_t": repr(float(step(m32, tp)[1]))}
    out.update(n1_numbers(cs, dv, args, "n1", (1, 8, 32)))
    if hasattr(step, "newton_rows"):  # N1 from the rows, as the step runs
        rows = step.newton_rows(m32, tp)[1]
        out["n1_rows_ms_32"] = cs.time_ms(
            lambda: dv.newton_solve_rows(**rows))[0]
        out["n1_rows_t"] = repr(float(dv.newton_solve_rows(**rows).t))
    out.update(n1_numbers(cs, dv, args64, "n1_f64"))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPLAYS):
            graphed(m32, tp)
        torch.cuda.synchronize()
    out["graph_by_kernel"] = by_kernel(prof, REPLAYS)
    del graphed, step, args, args64
    torch.cuda.empty_cache()

    if protein:
        from libpll_tpu_torch.utils.flagship import build_protein_flagship

        topo, model_np, masks = build_protein_flagship(seed=0)
        tp = torch.from_numpy(masks).to(device)
        m32 = model_from_numpy(model_np, device, torch.float32)
        step = ev.make_train_step_fused(topo, 4, 20, tip_encoding="masks",
                                        device=device)
        graphed = step.graphed(m32, tp)
        out["protein_step_ms"] = cs.time_ms(lambda: step(m32, tp))[0]
        out["protein_graph_ms"] = cs.time_ms(lambda: graphed(m32, tp))[0]
        out.update(n1_numbers(cs, dv, step.newton_inputs(m32, tp)[1],
                              "protein_n1"))
    print(json.dumps(out), flush=True)


def main(argv):
    protein = argv[:1] == ["--protein"]
    argv = argv[1:] if protein else argv
    if argv[:1] == ["--measure"]:
        measure(argv[1], argv[2] or None, protein)
        return 0
    print(f"card: {card_line()}", flush=True)
    spec = None
    if argv[:1] == ["--variants"]:
        spec, argv = json.loads(Path(argv[1]).read_text()), argv[2:]
    names = [a for a in argv if not Path(a).is_dir()]
    if names and spec is None:
        raise SystemExit(f"not checkouts: {', '.join(names)} (variants "
                         "need --variants SPEC.json)")
    libs = build_variants(spec, names, "derivatives") if names else {}
    runs = [(ROOT, libs[a]) if a in libs else (Path(a).resolve(), None)
            for a in argv or [str(ROOT)]]
    for tree, lib in runs:
        cmd = [sys.executable, __file__, *(["--protein"] if protein else []),
               "--measure", str(tree), str(lib or "")]
        subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
