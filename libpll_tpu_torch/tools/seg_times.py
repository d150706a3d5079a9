"""Time the segmented kernels K3/K4 of several checkouts, or of source
variants of ``csrc/clv_seg.cu``, in turns on one card.

    python3 libpll_tpu_torch/tools/seg_times.py [--alphabet] [TREE ...]
    python3 libpll_tpu_torch/tools/seg_times.py --variants SPEC.json NAME ...

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.  A variant is this checkout's ``clv_seg.cu``
with the text substitutions ``SPEC.json`` names for it (as
``tools/dyn_times.py``'s; ``tools/seg_ablations.json``), built by nvcc
beside the package's build and loaded in place of its library.

Measured at chip_smoke's README configuration (1 024 taxa x 32 768 sites,
DNA, four rates, float32, per-site scaling, CLV tips, seed 0): for K4
(``make_segmented_score``) the logL, and for K3 (``make_segmented_sweep``)
the edge logL of its rows; for each, the launches of one call, the peak
device memory of one call, the device ms per call (CUDA events over
back-to-back calls, ``chip_smoke.time_ms``) and the host ms of one call
with the card idle (median).  Where the kernel can launch once per segment
(``split``) the same times that way too.  With ``--alphabet``, also K4
and K3 of the any-alphabet instance (``csrc/clv_seg_any.cu``) on the same
tree at 16 states (GT16), four rates, float32, CLV tips decoded from
16-bit masks drawn on the card (chip_smoke's phase 37 configuration); a
tree without that instance records null.  Each run prints one JSON line;
the card's name and power limit come first.
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import build_variants, card_line  # noqa: E402

HOST_ITERS = 20


def host_ms(fn):
    """Median wall time of one call with the card idle, in ms."""
    import numpy as np
    import torch

    times = []
    for _ in range(HOST_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def measure(tree, lib=None, alphabet=False):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import clv_seg as cseg
    from libpll_tpu_torch.utils.constants import SCALE_PER_SITE
    from libpll_tpu_torch.utils.flagship import (build_flagship_topology,
                                                 draw_tipchars_cuda)

    torch.backends.cuda.matmul.allow_tf32 = False
    if lib is None:
        _build.build_all(["clv_seg"])
    else:
        loaded = cseg.bind(ctypes.CDLL(str(lib)))
        cseg.load_kernels = lambda: loaded
    device = torch.device("cuda", 0)
    tips, sites = cs.README_TIPS, cs.README_SITES
    topo, model_np = build_flagship_topology(tips, sites, seed=0)
    tp = draw_tipchars_cuda(tips, sites, 0, device)
    seg = cseg.build_segmented_schedule(
        topo.schedule, max_rows=cseg.seg_max_rows(4, 4, torch.float32),
        ensure_rows=[topo.parent_clv, topo.child_clv])
    slabs = cseg.pack_tips_segmented(
        cf.decode_tips(tp, "chars", torch.arange(tips, device=device), 4, 4,
                       torch.float32), seg)
    m32 = model_from_numpy(model_np, device, torch.float32)
    pm, wvec, pw, _ = cs.kernel_inputs(topo, model_np, torch.float32, device,
                                       False)
    score = cseg.make_segmented_score(
        seg, topo.parent_clv, topo.child_clv, topo.edge_matrix,
        SCALE_PER_SITE, rate_cats=4, states=4)
    sweep = cseg.make_segmented_sweep(seg, SCALE_PER_SITE, rate_cats=4,
                                      states=4)
    k4 = lambda: score(slabs, pm, wvec, pw)  # noqa: E731
    k3 = lambda: sweep(slabs, pm)  # noqa: E731

    out = {"tree": str(tree),
           "variant": None if lib is None else Path(lib).parent.name}
    for name, fn, cls in (("k4", k4, cseg.SegmentedScore),
                          ("k3", k3, cseg.SegmentedSweep)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = cls.launches
        got = fn()
        torch.cuda.synchronize()
        out[f"{name}_launches"] = cls.launches - before
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        out[f"{name}_logl"] = (float(got) if name == "k4" else cs.sweep_logl(
            topo, seg, *got, tp, m32, pm))
        del got
        torch.cuda.empty_cache()
        out[f"{name}_ms"] = cs.time_ms(fn)[0]
        out[f"{name}_host_ms"] = host_ms(fn)
    if hasattr(cseg.SegmentedScore, "split"):
        score.split = sweep.split = True
        for name, fn in (("k4", k4), ("k3", k3)):
            out[f"{name}_split_ms"] = cs.time_ms(fn)[0]
            out[f"{name}_split_host_ms"] = host_ms(fn)
        out["k4_split_logl"] = float(k4())
    if alphabet:
        del slabs
        torch.cuda.empty_cache()
        out.update(measure_alphabet(cs, device))
    print(json.dumps(out), flush=True)


def measure_alphabet(cs, device):
    """K4 and K3 of the any-alphabet instance at GT16 (module docstring);
    None where the checkout has no such instance."""
    import torch

    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import clv_seg as cseg
    from libpll_tpu_torch.utils import flagship
    from libpll_tpu_torch.utils.constants import SCALE_PER_SITE

    if not hasattr(flagship, "draw_tipmasks_cuda"):
        return dict.fromkeys(("gt16_k4_logl", "gt16_k4_ms", "gt16_k3_ms"))
    s, c = cs.GT16_STATES, cs.GT16_RATES
    tips, sites = cs.GT16_SEG
    topo, model_np = flagship.build_alphabet_topology(tips, sites, s, c,
                                                      seed=2)
    words = flagship.draw_tipmasks_cuda(tips, sites, s, 2, device)
    seg = cseg.build_segmented_schedule(
        topo.schedule, max_rows=cseg.seg_max_rows(c, s, torch.float32),
        ensure_rows=[topo.parent_clv, topo.child_clv])
    slabs = cseg.pack_tips_segmented(cf.decode_tips(
        words, "masks", torch.arange(tips, device=device), c, s,
        torch.float32).contiguous(), seg)
    del words
    pm, wvec, pw, _ = cs.kernel_inputs(topo, model_np, torch.float32, device,
                                       False)
    score = cseg.make_segmented_score(
        seg, topo.parent_clv, topo.child_clv, topo.edge_matrix,
        SCALE_PER_SITE, rate_cats=c, states=s)
    sweep = cseg.make_segmented_sweep(seg, SCALE_PER_SITE, rate_cats=c,
                                      states=s)
    out = {"gt16_k4_logl": float(score(slabs, pm, wvec, pw))}
    out["gt16_k4_ms"] = cs.time_ms(lambda: score(slabs, pm, wvec, pw),
                                   iters=5, warmup=0)[0]
    out["gt16_k3_ms"] = cs.time_ms(lambda: sweep(slabs, pm), iters=5,
                                   warmup=1)[0]
    return out


def main(argv):
    if argv[:1] == ["--measure"]:
        alphabet = "--alphabet" in argv
        argv = [a for a in argv if a != "--alphabet"]
        measure(argv[1], argv[2] if len(argv) > 2 else None, alphabet)
        return 0
    flags = [a for a in argv if a == "--alphabet"]
    argv = [a for a in argv if a != "--alphabet"]
    print(f"card: {card_line()}", flush=True)
    if argv[:1] == ["--variants"]:
        names = argv[2:]
        libs = build_variants(json.loads(Path(argv[1]).read_text()), names,
                              "clv_seg")
        runs = [(ROOT, libs[name]) for name in names]
    else:
        runs = [(Path(tree).resolve(), None) for tree in argv or [ROOT]]
    for tree, lib in runs:
        cmd = [sys.executable, __file__, "--measure", str(tree)]
        subprocess.run(cmd + ([str(lib)] if lib else []) + flags,
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
