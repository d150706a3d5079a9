"""Time the dyn kernels K5/K6 of several checkouts, or of source variants
of ``csrc/clv_dyn.cu`` or ``csrc/clv_dyn_any.cu``, in turns on one card.

    python3 libpll_tpu_torch/tools/dyn_times.py [--alphabet] [TREE ...]
    python3 libpll_tpu_torch/tools/dyn_times.py [--alphabet | --only-alphabet]
        [--cap SLOTS] [--source clv_dyn_any] --variants SPEC.json NAME ...

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.  A variant is this checkout's ``--source``
(``clv_dyn``, the default, or ``clv_dyn_any``) with the text substitutions
``SPEC.json`` names for it (``{"name": [["old", "new"], ...]}``; an empty
list is the source as it stands), built by nvcc beside the package's build
and loaded in place of its library (``tools/variants.py``: a substitution
may also apply to the shared ``clv_common.cuh``).  Measured, with CUDA
events (``chip_smoke.time_ms``):

  * K6 (``make_score_unbounded``'s kernel) at the large configuration,
    10 240 taxa x 2^20 sites, DNA, float32, per-site scaling: ms per
    evaluation, the logL and the peak device memory of one evaluation;
  * K6 and K5 at the mid configuration, 4 096 x 8 192 DNA, per-rate
    scaling (K5 cut at chip_smoke's K5_MAX_ROWS);
  * K6 at the protein configuration, 256 x 16 384, 20-bit masks;
  * with ``--alphabet`` (``--only-alphabet``: these alone), also the
    any-alphabet instance (``csrc/clv_dyn_any.cu``) at chip_smoke's phase
    37 configurations, 16 states (GT16), four rates, float32, 16-bit masks
    drawn on the card: K6 at 10 240 x 65 536 per site (and its logL) and
    K5 at 4 096 x 8 192 per rate (cut at K5_MAX_ROWS; an integer checksum
    of its rows' and counters' bits); and K6 at 61 states (codon-sized),
    four rates, float32, one-hot CLV tips drawn on the card, 1 024 x 8 192
    on phase 37's tree helpers, per site.  Beside each any-alphabet time:
    the pool's slots (its largest segment's) and the spilled rows;
    ``--cap SLOTS`` caps the GT16 cells' pools (the kernels'
    ``slot_cap``), to trade spilled rows against warps an SM.  A tree without that
    instance records null.

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

CODON_K6 = (61, 4, 1024, 8192)  # states, rates, taxa, sites


def load_variant(cd, lib, source):
    """Load a variant library in place of ``source``'s."""
    loaded = ctypes.CDLL(str(lib))
    prefix = "clv_dyn" if source == "clv_dyn" else "clv_dyn_any"
    argtypes = (cd._SEGMENT_ARGTYPES if source == "clv_dyn"
                else cd._ANY_SEGMENT_ARGTYPES)
    for suffix in ("f32", "f64"):
        fn = getattr(loaded, f"{prefix}_segment_{suffix}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    getattr(loaded, f"{prefix}_error_string").argtypes = [ctypes.c_int]
    getattr(loaded, f"{prefix}_error_string").restype = ctypes.c_char_p
    if source == "clv_dyn":
        cd.load_kernels = lambda: loaded
    else:
        cd.load_any_kernels = lambda: loaded


def measure(tree, lib=None, alphabet=False, dna=True, source="clv_dyn",
            cap=None):
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
    _build.build_all(["clv_dyn", "clv_dyn_any"] if alphabet else ["clv_dyn"])
    if lib is not None:
        load_variant(cd, lib, source)
    device = torch.device("cuda", 0)

    def k6_args(score, model):
        pm = score.pmatrices(model, torch.float32)
        return (score.tips, score.tables, score.m_ops, score.exp_tables, pm,
                cf.pack_weight_vec(model["freqs_pc"], model["rate_weights"]),
                model["pattern_weights"])

    out = {"tree": str(tree), "variant": None if lib is None else
           Path(lib).parent.name, "cap": cap}
    if dna:
        topo, model_np = build_flagship_topology(cs.GIANT_TIPS,
                                                 cs.GIANT_SITES, seed=0)
        tp = draw_tipchars_cuda(cs.GIANT_TIPS, cs.GIANT_SITES, 0, device)
        score = ev.ScoreUnbounded(topo, 4, 4, tp, "chars").to(device)
        m32 = model_from_numpy(model_np, device, torch.float32)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out["giant_logl"] = float(score(m32))
        out["giant_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        args = k6_args(score, m32)
        out["giant_k6_ms"] = cs.time_ms(lambda: score.kernel(*args),
                                        iters=3, warmup=1)[0]
        del score, tp, args
        torch.cuda.empty_cache()

        topo, model_np = build_flagship_topology(cs.MID_TIPS, cs.MID_SITES,
                                                 seed=1)
        topo = topo._replace(scale_mode=SCALE_PER_RATE)
        tp = draw_tipchars_cuda(cs.MID_TIPS, cs.MID_SITES, 1, device)
        score = ev.ScoreUnbounded(topo, 4, 4, tp, "chars").to(device)
        m32 = model_from_numpy(model_np, device, torch.float32)
        args = k6_args(score, m32)
        out["mid_logl"] = float(score.kernel(*args))
        out["mid_k6_ms"] = cs.time_ms(lambda: score.kernel(*args))[0]
        dyn = cd.build_dyn_schedule(topo.schedule, rate_cats=4, states=4,
                                    max_rows=cs.K5_MAX_ROWS,
                                    ensure_rows=[topo.parent_clv,
                                                 topo.child_clv])
        sweep = cd.make_dyn_sweep(dyn, SCALE_PER_RATE, rate_cats=4,
                                  states=4, tip_encoding="chars")
        tables = cs.stacked(cd.dyn_runtime_args(dyn), device)
        out["mid_k5_ms"] = cs.time_ms(lambda: sweep(tp, *tables, args[4]))[0]

        ptopo, pmodel, pmasks = cs.small_case(
            cs.random_newick(cs.PROTEIN_TIPS, np.random.default_rng(3)),
            cs.PROTEIN_SITES, 4, seed=3, states=20)
        pmodel["prop_invar"] = np.zeros(1)
        pmodel["prop_invar_pc"] = np.zeros(4)
        pscore = ev.make_score_unbounded(ptopo, 4, 20, pmasks).to(device)
        pargs = k6_args(pscore, model_from_numpy(pmodel, device,
                                                 torch.float32))
        out["protein_logl"] = float(pscore.kernel(*pargs))
        out["protein_k6_ms"] = cs.time_ms(lambda: pscore.kernel(*pargs))[0]
        del pscore, pargs
        torch.cuda.empty_cache()
    if alphabet:
        out.update(measure_alphabet(cs, device, cap))
    print(json.dumps(out), flush=True)


def rows_checksum(x):
    """The sum of a tensor's 32-bit words as an int64, a row at a time:
    equal bits give equal sums."""
    import torch

    words = x.reshape(x.shape[0], -1).view(torch.int32)
    return sum(int(words[i].sum(dtype=torch.int64))
               for i in range(words.shape[0]))


def measure_alphabet(cs, device, cap=None):
    """The any-alphabet instance's K6 and K5 at GT16 and K6 at 61 states
    (module docstring); None where the checkout has no such instance."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils import flagship
    from libpll_tpu_torch.utils.constants import SCALE_PER_RATE

    keys = ("gt16_large_logl", "gt16_large_k6_ms", "gt16_mid_k5_ms",
            "codon_k6_ms")
    if not hasattr(flagship, "draw_tipmasks_cuda"):
        return dict.fromkeys(keys)
    s, c = cs.GT16_STATES, cs.GT16_RATES
    out = {}

    def pool(kernel, capped=True):
        if capped and cap is not None:
            kernel.slot_cap = cap
        lay = kernel.layout(torch.float32)
        return max(lay.pools), lay.spills

    def k6_time(name, topo, tp, enc, states, model_np, iters, capped=True):
        score = ev.ScoreUnbounded(topo, c, states, tp, enc).to(device)
        m32 = model_from_numpy(model_np, device, torch.float32)
        out[f"{name}_pool_slots"], out[f"{name}_spills"] = pool(
            score.kernel, capped)
        args = (score.tips, score.tables, score.m_ops, score.exp_tables,
                score.pmatrices(m32, torch.float32),
                cf.pack_weight_vec(m32["freqs_pc"], m32["rate_weights"]),
                m32["pattern_weights"])
        out[f"{name}_logl"] = float(score.kernel(*args))
        out[f"{name}_k6_ms"] = cs.time_ms(lambda: score.kernel(*args),
                                          iters=iters, warmup=0)[0]

    tips, sites = cs.GT16_LARGE
    topo, model_np = flagship.build_alphabet_topology(tips, sites, s, c,
                                                      seed=0)
    tp = flagship.draw_tipmasks_cuda(tips, sites, s, 0, device)
    k6_time("gt16_large", topo, tp, "masks", s, model_np, 2)
    del tp
    torch.cuda.empty_cache()

    tips, sites = cs.GT16_MID
    topo, model_np = flagship.build_alphabet_topology(tips, sites, s, c,
                                                      seed=1)
    topo = topo._replace(scale_mode=SCALE_PER_RATE)
    tp = flagship.draw_tipmasks_cuda(tips, sites, s, 1, device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    dyn = cd.build_dyn_schedule(
        topo.schedule, rate_cats=c, states=s, max_rows=cs.K5_MAX_ROWS,
        ensure_rows=[topo.parent_clv, topo.child_clv])
    sweep = cd.make_dyn_sweep(dyn, SCALE_PER_RATE, rate_cats=c, states=s,
                              tip_encoding="masks")
    out["gt16_mid_pool_slots"], out["gt16_mid_spills"] = pool(sweep)
    tables = cs.stacked(cd.dyn_runtime_args(dyn), device)
    pm = ev._pmatrices(m32, topo, torch.float32, torch.as_tensor(
        topo.matrix_indices, dtype=torch.long, device=device))
    inner, scal = sweep(tp, *tables, pm)
    out["gt16_mid_k5_checksum"] = [rows_checksum(inner),
                                   rows_checksum(scal)]
    del inner, scal
    out["gt16_mid_k5_ms"] = cs.time_ms(lambda: sweep(tp, *tables, pm),
                                       iters=5, warmup=1)[0]
    del tables, tp, pm
    torch.cuda.empty_cache()

    states, rates, tips, sites = CODON_K6
    topo, model_np = flagship.build_alphabet_topology(tips, sites, states,
                                                      rates, seed=3)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    tp = torch.empty((tips, rates, states, sites), device=device)
    for t in range(tips):  # one-hot tips, one row at a time
        cols = torch.randint(0, states, (sites,), generator=gen,
                             device=device)
        tp[t] = torch.nn.functional.one_hot(cols, states).T.to(tp.dtype)
    k6_time("codon", topo, tp, "clv", states, model_np, 3, capped=False)
    del tp
    torch.cuda.empty_cache()
    return out


def main(argv):
    def option(name):
        if name not in argv:
            return None
        k = argv.index(name)
        value = argv[k + 1]
        del argv[k:k + 2]
        return value

    argv = list(argv)
    source = option("--source") or "clv_dyn"
    cap = option("--cap")
    only = "--only-alphabet" in argv
    alphabet = only or "--alphabet" in argv
    argv = [a for a in argv if a not in ("--alphabet", "--only-alphabet")]
    if argv[:1] == ["--measure"]:
        measure(argv[1], argv[2] if len(argv) > 2 else None, alphabet,
                not only, source, None if cap is None else int(cap))
        return 0
    flags = (["--only-alphabet"] if only else
             ["--alphabet"] if alphabet else [])
    flags += ["--source", source] + (["--cap", cap] if cap else [])
    print(f"card: {card_line()}", flush=True)
    if argv[:1] == ["--variants"]:
        names = argv[2:]
        libs = build_variants(json.loads(Path(argv[1]).read_text()), names,
                              source)
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
