"""Time the fused kernels K1/K2 of several checkouts, or of source variants
of ``csrc/clv_fused.cu`` or ``csrc/clv_any.cu``, in turns on one card.

    python3 libpll_tpu_torch/tools/fused_times.py [--protein] [TREE ...]
    python3 libpll_tpu_torch/tools/fused_times.py [--protein] --variants SPEC.json NAME ...
    python3 libpll_tpu_torch/tools/fused_times.py --alphabet [--cap SLOTS] [TREE ...]
    python3 libpll_tpu_torch/tools/fused_times.py --alphabet [--cap SLOTS]
        --source clv_any --variants SPEC.json NAME ...

Each run is its own process, in the order given (parent, change, change,
parent compares two commits on one card).  A TREE is a checkout's root
(default: this one); it is measured with its own package and its own
``chip_smoke.py`` helpers.  A variant is this checkout's ``clv_fused.cu``
with the text substitutions ``SPEC.json`` names for it (as
``tools/dyn_times.py``'s; ``tools/fused_ablations.json``), built by nvcc
beside the package's build and loaded in place of its library.

Measured at the flagship (64 taxa x 262 144 sites, GTR+Γ4, float32,
per-site scaling, nibble-packed tips, seed 0): K1 alone
(``fused_edge_score`` with the module's cached op table or plan) and K2
alone (``fused_sweep``), ``make_score`` and ``make_forward_fused`` per
evaluation (device ms per call, CUDA events over back-to-back calls,
``chip_smoke.time_ms``), the host ms of one call of each with the card
idle (median, ``chip_smoke.host_ms``), the peak device memory of one call
of each, the logL
of ``make_score`` to the last digit and whether K2's rows and counters
are the first run's, bit for bit (a SHA-256 of their bytes).  Where the
tree has the walk's plan (``FusedPlan``), the host time of one
``make_score`` call is also taken apart into its sections, each timed
alone with the card idle; where it has ``Score.graphed``, ``make_score``
captured in a CUDA graph is timed too, with its logL.  Each run prints one JSON line; the card's name
and power limit come first.

``--protein`` measures the 20-state instances instead, at the protein
configuration (``utils/flagship.build_protein_flagship``: 64 taxa × 65 536
LG4X+Γ4 columns read from FASTA, 20-bit masks, float32, seed 0), and adds
``make_train_step_fused`` eager and graphed (``step``) with its t*.  In
``tools/fused_ablations.json`` the ``protein_*`` variants take one design
choice out each (``protein_one_buffer``: the next op's matrices copied
behind the op, not beside it; ``protein_one_site``: one site a thread)
or, timed only (their values are wrong), one piece of the work
(``protein_no_p_reads``, ``protein_no_stage_barrier``,
``protein_no_row_writes``).

``--alphabet`` measures the any-alphabet instance (``csrc/clv_any.cu``)
instead, K1 and K2 alone (CUDA events, ``chip_smoke.time_ms``) at chip_smoke
phase 36's two cells, each built in the run by the tree's own helpers:
the GT16 flagship (``utils/flagship.build_alphabet_flagship``: 64 taxa x
262 144 sites, 16 states, Γ4, float32, per-site scaling, 16-bit masks)
and the codon cell (``chip_smoke.CODON``: 61 states, Γ4, 64 x 16 384,
CLV tips) in float32 and in float64 (``codon_f64``).  For each: K1's logL to the last digit, a SHA-256 of
K2's rows and counters, and for K1 and K2 the pool's slots in shared
memory, its spilled rows (walk positions whose slot lies past them), the
warps a block and the blocks an SM of its layout.  ``--cap SLOTS`` caps
the slots in shared memory (``chip_smoke.AnyCap``); ``--source clv_any
--variants tools/fused_any_ablations.json NAME ...`` times variants of
``clv_any.cu`` (``kernel``: the source as it stands; the others take one
design choice out, or, timed only, one piece of the work).
"""

import ctypes
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(Path(__file__).resolve().parent))

from variants import build_variants, card_line  # noqa: E402

ALPHABET_ITERS = 10  # timed calls of K1 and K2 a cell

def digest(*tensors):
    """SHA-256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().data)
    return h.hexdigest()


def host_sections(host_ms, score, sched, tp, m32, edge):
    """The host ms of each section of one ``make_score`` call (this
    checkout's ``Score.forward``), each timed alone with the card idle
    (``host_ms``: chip_smoke's)."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops.clv_seg import fold_tile_partials
    from libpll_tpu_torch.utils.constants import SCALE_PER_SITE

    dtype = torch.float32
    pm = score.pmatrices(m32, dtype)
    f = ev._floats(m32, dtype)
    w = cf.pack_weight_vec(f["freqs_pc"], f["rate_weights"])
    sites = tp.shape[-1]
    partials = torch.empty((-(-sites // cf.BLOCK_SITES) * 4,),
                           dtype=torch.float64, device=tp.device)
    parts = {
        "pmatrices": lambda: score.pmatrices(m32, dtype),
        "floats": lambda: ev._floats(m32, dtype),
        "weight_vec": lambda: cf.pack_weight_vec(f["freqs_pc"],
                                                 f["rate_weights"]),
        "checks": lambda: cf._check(score.plan, sched, tp, pm,
                                    SCALE_PER_SITE, "chars"),
        "allocations": lambda: torch.empty(
            (-(-sites // cf.BLOCK_SITES) * 4,), dtype=torch.float64,
            device=tp.device),
        # the launch takes the alphabet since the protein instances
        "launch": lambda: cf._launch(
            score.plan, "f32", 4, *([4] if "s" in inspect.signature(
                cf._launch).parameters else []), SCALE_PER_SITE, sites, tp,
            pm, edge=score.plan.static("edge_desc", tp.device),
            weight_vec=w, pattern_weights=f["pattern_weights"],
            partials=partials),
        "f64_sum": lambda: cf.sum_block_partials(
            fold_tile_partials(partials, sites)),
        "kernel_wrapper": lambda: cf.fused_edge_score(
            sched, tp, pm, w, f["pattern_weights"], plan=score.plan,
            tip_encoding="chars", **edge),
        "make_score": lambda: score(m32, tp),
    }
    return {name: host_ms(fn) for name, fn in parts.items()}


def layout(plan, c, s, scale_mode, score):
    """The plan's float32 layout (the query takes the alphabet since the
    protein instances)."""
    import torch

    if "states" in inspect.signature(plan.layout).parameters:
        return plan.layout(torch.float32, c, s, scale_mode, score)
    return plan.layout(torch.float32, c, scale_mode, score)


def measure(tree, lib=None, protein=False):
    """One run in this process: the numbers of the module docstring."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_SITES,
                                                 FLAGSHIP_TIPS,
                                                 build_flagship)

    torch.backends.cuda.matmul.allow_tf32 = False
    if lib is None:
        _build.build_all(["clv_fused"])
    else:
        loaded = cf.bind(ctypes.CDLL(str(lib)))
        cf.load_kernels = lambda: loaded
    device = torch.device("cuda", 0)
    if protein:
        from libpll_tpu_torch.utils.flagship import build_protein_flagship

        topo, model_np, masks = build_protein_flagship(seed=0)
        tp = torch.from_numpy(masks).to(device)
        enc, c, s = "masks", 4, 20
    else:
        topo, model_np, masks, _ = build_flagship(
            FLAGSHIP_TIPS, FLAGSHIP_SITES, seed=0, tip_masks=True)
        tp = cf.pack_tipchars(masks).to(device)
        enc, c, s = "chars", 4, 4
    sched = topo.schedule
    m32 = model_from_numpy(model_np, device, torch.float32)
    score = ev.make_score(topo, c, s, tip_encoding=enc).to(device)
    fwd = ev.make_forward_fused(topo, c, s, tip_encoding=enc).to(device)
    pm, wvec, pw, _ = cs.kernel_inputs(topo, model_np, torch.float32, device,
                                       False)
    edge = dict(parent_clv=topo.parent_clv, child_clv=topo.child_clv,
                edge_matrix=topo.edge_matrix)
    # the module's cached walk: the plan, or the parent's op table
    k1_extra = ({"plan": score.plan} if hasattr(score, "plan")
                else {"ops": score.ops})
    k2_extra = ({"plan": fwd.plan} if hasattr(fwd, "plan")
                else {"ops": fwd.ops})
    runs = {
        "k1": lambda: cf.fused_edge_score(sched, tp, pm, wvec, pw,
                                          tip_encoding=enc, **edge,
                                          **k1_extra),
        "k2": lambda: cf.fused_sweep(sched, tp, pm, tip_encoding=enc,
                                     **k2_extra),
        "score": lambda: score(m32, tp),
        "forward_fused": lambda: fwd(m32, tp),
    }
    if protein:
        step = ev.make_train_step_fused(topo, c, s, tip_encoding=enc,
                                        device=device)
        runs["step"] = lambda: step(m32, tp)
    out = {"tree": str(tree), "protein": protein, "patterns": tp.shape[-1],
           "variant": None if lib is None else Path(lib).parent.name}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        got = fn()
        torch.cuda.synchronize()
        out[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if name in ("k1", "score"):
            out[f"{name}_logl"] = repr(float(got))
        elif name == "step":
            out["step_logl_t"] = [repr(float(v)) for v in got]
        elif name == "k2":
            out["k2_sha256"] = digest(*got)
        del got
        torch.cuda.empty_cache()
        out[f"{name}_ms"] = cs.time_ms(fn)[0]
        out[f"{name}_host_ms"] = cs.host_ms(fn)
    if hasattr(score, "graphed"):  # make_score as one CUDA graph
        graphed = score.graphed(m32, tp)
        out["score_graph_logl"] = repr(float(graphed(m32, tp)))
        out["score_graph_ms"] = cs.time_ms(lambda: graphed(m32, tp))[0]
        out["score_graph_host_ms"] = cs.host_ms(lambda: graphed(m32, tp))
    if protein:
        graphed = step.graphed(m32, tp)
        out["step_graph_ms"] = cs.time_ms(lambda: graphed(m32, tp))[0]
    if hasattr(score, "plan"):
        out["k1_layout"] = dict(layout(score.plan, c, s, topo.scale_mode,
                                       True), pool=score.plan.pool)
        out["k2_layout"] = dict(layout(fwd.plan, c, s, topo.scale_mode,
                                       False), pool=fwd.plan.pool)
        if not protein:
            out["host_sections"] = host_sections(cs.host_ms, score, sched,
                                                 tp, m32, edge)
    print(json.dumps(out), flush=True)


def measure_alphabet(tree, lib=None, cap=None):
    """One ``--alphabet`` run in this process: the numbers of the module
    docstring."""
    sys.path.insert(0, str(tree))
    from contextlib import nullcontext

    import numpy as np
    import torch

    import chip_smoke as cs
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.flagship import (ALPHABET_STATES,
                                                 FLAGSHIP_SITES,
                                                 build_alphabet_flagship)

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["clv_any"])
    if lib is not None:
        loaded = cf.bind_any(ctypes.CDLL(str(lib)))
        cf.load_any_kernels = lambda: loaded
    device = torch.device("cuda", 0)
    out = {"tree": str(tree), "cap": cap,
           "variant": None if lib is None else Path(lib).parent.name}
    cells = (("gt16", (ALPHABET_STATES, cs.ALPHABET_RATE_CATS,
                       cs.ALPHABET_TIPS, FLAGSHIP_SITES, "masks"),
              torch.float32),
             ("codon", (*cs.CODON, "clv"), torch.float32),
             ("codon_f64", (*cs.CODON, "clv"), torch.float64))
    for name, (s, c, tips, sites, enc), dtype in cells:
        _, topo, model_np, cols = build_alphabet_flagship(tips, sites, s, c,
                                                          seed=0)
        masks = np.uint64(1) << cols.astype(np.uint64)
        tp = cs.tip_input(masks, enc, c, dtype, device, s)
        pm, wvec, pw, _ = cs.kernel_inputs(topo, model_np, dtype, device,
                                           False)
        sched = topo.schedule
        edge = (topo.parent_clv, topo.child_clv, topo.edge_matrix)
        with cs.AnyCap(cap) if cap is not None else nullcontext():
            plans = {"k1": cf.FusedPlan(sched, enc, edge),
                     "k2": cf.FusedPlan(sched, enc)}
            runs = {
                "k1": lambda: cf.fused_edge_score(
                    sched, tp, pm, wvec, pw, plan=plans["k1"],
                    parent_clv=edge[0], child_clv=edge[1],
                    edge_matrix=edge[2], tip_encoding=enc),
                "k2": lambda: cf.fused_sweep(sched, tp, pm, plan=plans["k2"],
                                             tip_encoding=enc)}
            before = (cf.fused_edge_score.any_launches,
                      cf.fused_sweep.any_launches)
            out[f"{name}_k1_logl"] = repr(float(runs["k1"]()))
            got = runs["k2"]()
            torch.cuda.synchronize()
            out[f"{name}_k2_sha256"] = digest(*got)
            del got
            torch.cuda.empty_cache()
            out[f"{name}_any_launches"] = [
                cf.fused_edge_score.any_launches - before[0],
                cf.fused_sweep.any_launches - before[1]]
            for key, fn in runs.items():
                out[f"{name}_{key}_ms"] = cs.time_ms(
                    fn, iters=ALPHABET_ITERS, warmup=1)[0]
                plan = plans[key]
                lay = plan.layout(dtype, c, s, topo.scale_mode, key == "k1")
                shared = lay["shared_slots"]
                out[f"{name}_{key}_layout"] = dict(
                    pool=plan.pool, shared_slots=shared,
                    spilled_rows=int((plan.slots >= shared).sum()),
                    warps=lay["threads"] // 32,
                    blocks_per_sm=lay["blocks_per_sm"], smem=lay["smem"])
        del tp, pm
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv):
    def option(name):
        if name not in argv:
            return None
        k = argv.index(name)
        value = argv[k + 1]
        del argv[k:k + 2]
        return value

    argv = list(argv)
    protein = "--protein" in argv
    alphabet = "--alphabet" in argv
    argv = [a for a in argv if a not in ("--protein", "--alphabet")]
    cap = option("--cap")
    source = option("--source") or ("clv_any" if alphabet else "clv_fused")
    if argv[:1] == ["--measure"]:
        lib = argv[2] if len(argv) > 2 and argv[2] else None
        if alphabet:
            measure_alphabet(argv[1], lib, None if cap is None else int(cap))
        else:
            measure(argv[1], lib, protein)
        return 0
    flags = (["--protein"] if protein else []) + (
        ["--alphabet"] if alphabet else []) + (["--cap", cap] if cap else [])
    print(f"card: {card_line()}", flush=True)
    if argv[:1] == ["--variants"]:
        names = argv[2:]
        libs = build_variants(json.loads(Path(argv[1]).read_text()), names,
                              source)
        runs = [(ROOT, libs[name]) for name in names]
    else:
        runs = [(Path(tree).resolve(), None) for tree in argv or [ROOT]]
    for tree, lib in runs:
        cmd = [sys.executable, __file__, "--measure", str(tree),
               str(lib or ""), *flags]
        subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
