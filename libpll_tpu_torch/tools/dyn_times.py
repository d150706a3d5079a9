"""Time the dyn kernels K5/K6 of several checkouts, or of source variants
of ``csrc/clv_dyn.cu``, in turns on one card.

    python3 libpll_tpu_torch/tools/dyn_times.py [--alphabet] [TREE ...]
    python3 libpll_tpu_torch/tools/dyn_times.py --variants SPEC.json NAME ...

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.  A variant is this checkout's ``clv_dyn.cu``
with the text substitutions ``SPEC.json`` names for it
(``{"name": [["old", "new"], ...]}``; an empty list is the source as it
stands), built by nvcc beside the package's build and loaded in place of
its library (``tools/variants.py``: a substitution may also apply to the
shared ``clv_common.cuh``).  Measured, with CUDA events
(``chip_smoke.time_ms``):

  * K6 (``make_score_unbounded``'s kernel) at the large configuration,
    10 240 taxa x 2^20 sites, DNA, float32, per-site scaling: ms per
    evaluation, the logL and the peak device memory of one evaluation;
  * K6 and K5 at the mid configuration, 4 096 x 8 192 DNA, per-rate
    scaling (K5 cut at chip_smoke's K5_MAX_ROWS);
  * K6 at the protein configuration, 256 x 16 384, 20-bit masks;
  * with ``--alphabet``, also the any-alphabet instance
    (``csrc/clv_dyn_any.cu``) at chip_smoke's phase 37 configurations,
    16 states (GT16), four rates, float32, 16-bit masks drawn on the card:
    K6 at 10 240 x 65 536 per site and K5 at 4 096 x 8 192 per rate (cut
    at K5_MAX_ROWS); a tree without that instance records null.

Each run prints one JSON line; the card's name and power limit come first.
"""

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import build_variants, card_line  # noqa: E402


def measure(tree, lib=None, alphabet=False):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.constants import SCALE_PER_RATE
    from libpll_tpu_torch.utils.flagship import (build_flagship_topology,
                                                 draw_tipchars_cuda)

    torch.backends.cuda.matmul.allow_tf32 = False
    if lib is None:
        _build.build_all(["clv_dyn"])
    else:
        loaded = ctypes.CDLL(str(lib))
        for suffix in ("f32", "f64"):
            fn = getattr(loaded, f"clv_dyn_segment_{suffix}")
            fn.argtypes = cd._SEGMENT_ARGTYPES
            fn.restype = ctypes.c_int
        loaded.clv_dyn_error_string.argtypes = [ctypes.c_int]
        loaded.clv_dyn_error_string.restype = ctypes.c_char_p
        cd.load_kernels = lambda: loaded
    device = torch.device("cuda", 0)

    def k6_args(score, model):
        pm = score.pmatrices(model, torch.float32)
        return (score.tips, score.tables, score.m_ops, score.exp_tables, pm,
                cf.pack_weight_vec(model["freqs_pc"], model["rate_weights"]),
                model["pattern_weights"])

    out = {"tree": str(tree), "variant": None if lib is None else
           Path(lib).stem}
    topo, model_np = build_flagship_topology(cs.GIANT_TIPS, cs.GIANT_SITES,
                                             seed=0)
    tp = draw_tipchars_cuda(cs.GIANT_TIPS, cs.GIANT_SITES, 0, device)
    score = ev.ScoreUnbounded(topo, 4, 4, tp, "chars").to(device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["giant_logl"] = float(score(m32))
    out["giant_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    args = k6_args(score, m32)
    out["giant_k6_ms"] = cs.time_ms(lambda: score.kernel(*args), iters=3,
                                    warmup=1)[0]
    del score, tp, args
    torch.cuda.empty_cache()

    topo, model_np = build_flagship_topology(cs.MID_TIPS, cs.MID_SITES, seed=1)
    topo = topo._replace(scale_mode=SCALE_PER_RATE)
    tp = draw_tipchars_cuda(cs.MID_TIPS, cs.MID_SITES, 1, device)
    score = ev.ScoreUnbounded(topo, 4, 4, tp, "chars").to(device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    args = k6_args(score, m32)
    out["mid_logl"] = float(score.kernel(*args))
    out["mid_k6_ms"] = cs.time_ms(lambda: score.kernel(*args))[0]
    dyn = cd.build_dyn_schedule(topo.schedule, rate_cats=4, states=4,
                                max_rows=cs.K5_MAX_ROWS,
                                ensure_rows=[topo.parent_clv, topo.child_clv])
    sweep = cd.make_dyn_sweep(dyn, SCALE_PER_RATE, rate_cats=4, states=4,
                              tip_encoding="chars")
    tables = cs.stacked(cd.dyn_runtime_args(dyn), device)
    out["mid_k5_ms"] = cs.time_ms(lambda: sweep(tp, *tables, args[4]))[0]

    ptopo, pmodel, pmasks = cs.small_case(
        cs.random_newick(cs.PROTEIN_TIPS, np.random.default_rng(3)),
        cs.PROTEIN_SITES, 4, seed=3, states=20)
    pmodel["prop_invar"] = np.zeros(1)
    pmodel["prop_invar_pc"] = np.zeros(4)
    pscore = ev.make_score_unbounded(ptopo, 4, 20, pmasks).to(device)
    pargs = k6_args(pscore, model_from_numpy(pmodel, device, torch.float32))
    out["protein_logl"] = float(pscore.kernel(*pargs))
    out["protein_k6_ms"] = cs.time_ms(lambda: pscore.kernel(*pargs))[0]
    del pscore, pargs
    torch.cuda.empty_cache()
    if alphabet:
        out.update(measure_alphabet(cs, device))
    print(json.dumps(out), flush=True)


def measure_alphabet(cs, device):
    """K6 and K5 of the any-alphabet instance at GT16 (module docstring);
    None where the checkout has no such instance."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils import flagship
    from libpll_tpu_torch.utils.constants import SCALE_PER_RATE

    keys = ("gt16_large_logl", "gt16_large_k6_ms", "gt16_mid_k5_ms")
    if not hasattr(flagship, "draw_tipmasks_cuda"):
        return dict.fromkeys(keys)
    s, c = cs.GT16_STATES, cs.GT16_RATES
    out = {}
    for name, (tips, sites), seed in (("large", cs.GT16_LARGE, 0),
                                      ("mid", cs.GT16_MID, 1)):
        topo, model_np = flagship.build_alphabet_topology(tips, sites, s, c,
                                                          seed=seed)
        tp = flagship.draw_tipmasks_cuda(tips, sites, s, seed, device)
        m32 = model_from_numpy(model_np, device, torch.float32)
        if name == "large":
            score = ev.ScoreUnbounded(topo, c, s, tp, "masks").to(device)
            pm = score.pmatrices(m32, torch.float32)
            args = (score.tips, score.tables, score.m_ops, score.exp_tables,
                    pm, cf.pack_weight_vec(m32["freqs_pc"],
                                           m32["rate_weights"]),
                    m32["pattern_weights"])
            out["gt16_large_logl"] = float(score.kernel(*args))
            out["gt16_large_k6_ms"] = cs.time_ms(
                lambda: score.kernel(*args), iters=2, warmup=0)[0]
            del score, args
        else:
            topo = topo._replace(scale_mode=SCALE_PER_RATE)
            dyn = cd.build_dyn_schedule(
                topo.schedule, rate_cats=c, states=s,
                max_rows=cs.K5_MAX_ROWS,
                ensure_rows=[topo.parent_clv, topo.child_clv])
            sweep = cd.make_dyn_sweep(dyn, SCALE_PER_RATE, rate_cats=c,
                                      states=s, tip_encoding="masks")
            tables = cs.stacked(cd.dyn_runtime_args(dyn), device)
            pm = ev._pmatrices(m32, topo, torch.float32, torch.as_tensor(
                topo.matrix_indices, dtype=torch.long, device=device))
            out["gt16_mid_k5_ms"] = cs.time_ms(
                lambda: sweep(tp, *tables, pm), iters=5, warmup=1)[0]
            del tables
        del tp, pm
        torch.cuda.empty_cache()
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
                              "clv_dyn")
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
