"""Time model fitting's evaluations at scripts/bench_infer.py's size on one
card, for several checkouts in turns.

    python3 libpll_tpu_torch/tools/modelopt_times.py [TREE ...]

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.

The alignment is ``utils/flagship.infer_alignment(1024, 16384)``
(bench_infer's), compressed to site patterns, in a float32 ``Partition``
on its generating tree under JC with Γ4(0.8), the model infer_tree's refit
after a search starts from.  ``engine/modelopt.make_param_score`` on it:
one value-and-grad (the plain float32 sweep forward and backward) and one
Brent evaluation (the forward under no_grad), each the mean wall of
``TIMED`` calls with the card synchronised; a value-and-grad under
torch.profiler (wall, the card's busy time, its idle share of the wall
and of the kernels' span, the launches) and its kernels with the most
device time; the eigendecomposition in float64 on the host with its
factors copied to the card (the fit's placement) against
``torch.linalg.eigh`` on the card.  The tree is the generating one, not a
search's final tree: the same sites and branches, another topology.  Each
run prints one JSON line; the card's name and power limit come first.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import card_line  # noqa: E402

TIMED = 5  # calls a mean


def measure(tree):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from libpll_tpu_torch import Partition
    from libpll_tpu_torch.engine import modelopt
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.io.compress import compress_site_patterns
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.models.gtr import eigen_decompose_torch
    from libpll_tpu_torch.search.stepwise import deep_recursion
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.flagship import infer_alignment

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    data, truth = infer_alignment(cs.BENCH_INFER_TIPS, cs.BENCH_INFER_SITES)
    labels = list(data)
    patterns, weights = compress_site_patterns([data[k] for k in labels],
                                               maps.pll_map_nt)
    tips, sites, c = len(labels), len(patterns[0]), 4
    with deep_recursion(tips):
        gen = ut.parse_newick_string(truth)
        part = Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, c,
                         tips - 2, dtype=torch.float32, device=device)
        order = {n.label: n.clv_index for n in ut.query_tipnodes(gen)}
        for lab, seq in zip(labels, patterns):
            part.set_tip_states(order[lab], maps.pll_map_nt, seq)
        part.set_pattern_weights(weights)
        part.set_frequencies(0, [0.25] * 4)
        part.set_subst_params(0, [1.0] * 6)
        rates = compute_gamma_cats(0.8, c)
        part.set_category_rates(rates)
        score, bl = modelopt.make_param_score(part, gen, dtype=torch.float32)

    def host(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    ls, fl = torch.zeros(5, dtype=torch.float64), torch.log(host([0.25] * 4))
    rest = (host(rates), host([1.0 / c] * c), host(0.0), host(bl))

    def value_and_grad():
        a, b = ls.clone().requires_grad_(), fl.clone().requires_grad_()
        (-score(a, b, *rest)).backward()
        return a.grad, b.grad

    def brent_eval():
        with torch.no_grad():
            return float(score(ls, fl, *rest))

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = cs.time.perf_counter()
        for _ in range(TIMED):
            fn()
        torch.cuda.synchronize()
        return (cs.time.perf_counter() - t0) * 1e3 / TIMED

    out = {"tree": str(tree), "sites": sites, "branches": len(bl),
           "vg_ms": wall_ms(value_and_grad), "brent_ms": wall_ms(brent_eval)}
    idle = cs.profiled_idle(value_and_grad)
    out.update(vg_wall_ms=idle[0], vg_busy_ms=idle[1], vg_idle=idle[2],
               vg_span_idle=idle[3], vg_kernels=idle[4])
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        value_and_grad()
        torch.cuda.synchronize()
    out["vg_top"] = cs.top_kernels(prof, 6)
    subst = torch.ones(6, dtype=torch.float64)
    freqs = torch.full((4,), 0.25, dtype=torch.float64)

    def eigen_host():
        w, left, right = eigen_decompose_torch(subst[None], freqs[None])
        return [t.to(device, torch.float32) for t in (w, left, right)]

    def eigen_card():
        return eigen_decompose_torch(subst[None].to(device),
                                     freqs[None].to(device))

    out["eigen_host_ms"] = wall_ms(eigen_host)
    out["eigen_card_ms"] = wall_ms(eigen_card)
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
