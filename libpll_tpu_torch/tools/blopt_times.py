"""Time the float64 flagship Partition and branch-length optimisation of
several checkouts in turns on one card.

    python3 libpll_tpu_torch/tools/blopt_times.py [TREE ...]

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.

Measured on the flagship alignment in a float64 ``Partition`` (chip_smoke's
``read_phylip_flagship`` and ``flagship_partition``: 64 taxa, 262 144
columns, GTR+Γ4): a full ``update_partials`` (62 ops), the root edge's
``compute_edge_loglikelihood`` and ``update_sumtable`` +
``compute_likelihood_derivatives``, each as device ms a call over
back-to-back calls (``chip_smoke.time_ms``) and host ms of a call with the
card idle (``chip_smoke.host_ms``).  Where the checkout has
``engine/blopt.py``, with every branch length times 2.5: the host loop's
ms for one sweep (less the full evaluation it starts with), the scan
program's ms a sweep on one sweep's tables, eager and as a CUDA graph
(``chip_smoke.event_ms``, the median of 3), and the logL of each optimiser
after two sweeps as its repr, to compare bits between runs.  Each run
prints one JSON line; the card's name and power limit come first.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import card_line  # noqa: E402

PERTURB = 2.5


def measure(tree):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_RATE_CATS,
                                                 FLAGSHIP_SITES,
                                                 FLAGSHIP_TIPS)

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    c = FLAGSHIP_RATE_CATS
    base, _, _, (params, freqs), patterns, weights, _ = \
        cs.read_phylip_flagship(FLAGSHIP_TIPS, FLAGSHIP_SITES)
    rates = (compute_gamma_cats(1.0, c), np.full(c, 1.0 / c))
    part = cs.flagship_partition(device, torch.float64, base, patterns,
                                 weights, params[None], freqs[None], rates)
    pidx = np.zeros(c, int)
    ops, branches, pmat_idx = ut.create_operations(ut.traverse(base.root))
    part.update_prob_matrices(pidx, pmat_idx, branches)
    pc, ps, cc, cs_, m = cs.edge_of(base)
    runs = {"update_partials": lambda: part.update_partials(ops),
            "edge_logl": lambda: part.compute_edge_loglikelihood(
                pc, ps, cc, cs_, m, pidx),
            "derivatives": lambda: part.compute_likelihood_derivatives(
                ps, cs_, branches[-1], pidx,
                part.update_sumtable(pc, cc, ps, cs_, pidx))}
    out = {"tree": str(tree)}
    for name, fn in runs.items():
        out[f"{name}_ms"] = cs.time_ms(fn, iters=10, warmup=2)[0]
        out[f"{name}_host_ms"] = cs.host_ms(fn, iters=10)

    try:
        from libpll_tpu_torch.engine import blopt
        from libpll_tpu_torch.engine.evaluate import partition_model
    except ImportError:
        blopt = None
    if blopt is not None:
        newick = ut.export_newick(base.root)

        def start():
            tree_ = ut.parse_newick_string(newick)
            for n in tree_.nodes:
                for mm in ([n] if n.is_tip else n.ring()):
                    mm.length = mm.length * PERTURB
            return tree_

        def full():
            blopt._full_evaluation(start(), part, pidx)

        full_ms = cs.event_ms(full, iters=3)
        out["host_sweep_ms"] = cs.event_ms(
            lambda: blopt.optimize_branch_lengths(start(), part, pidx,
                                                  max_sweeps=1),
            iters=3) - full_ms
        tree_ = start()
        blopt._full_evaluation(tree_, part, pidx)
        tab, er, t0, _ = blopt.sweep_tables(tree_.root, part.scale_buffers)
        tab, er = (torch.from_numpy(a).to(device) for a in (tab, er))
        t0 = torch.from_numpy(t0).to(device)
        program = blopt.make_sweep_program(
            part.nodes, part.scale_buffers, tab.shape[1], sites=part.sites,
            scale_mode=part.scale_mode)
        model = partition_model(part, pidx)
        out["scan_sweep_ms"] = cs.event_ms(
            lambda: program(part.clv, part.scalers, part.pmatrix, model,
                            tab, er, t0), iters=3)
        graph = program.graphed(part.clv, part.scalers, part.pmatrix,
                                model, tab, er, t0)
        out["graphed_sweep_ms"] = cs.event_ms(
            lambda: graph(model, tab, er, t0), iters=3)
        del graph
        out["cap"] = tab.shape[1]
        for mode in ("host", "scan", "graphed"):
            logl, sweeps = (
                blopt.optimize_branch_lengths(start(), part, pidx,
                                              max_sweeps=2)
                if mode == "host" else
                blopt.optimize_branch_lengths_scan(
                    start(), part, pidx, max_sweeps=2,
                    graphed=mode == "graphed"))
            out[f"{mode}_logl"] = repr(logl)
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
