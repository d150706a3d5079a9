#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py

Thirteen main paths, each driven once with the launch counters set to 0 just
before it and read just after:

  * the flagship (GTR+Γ4 DNA, 64 taxa × 262 144 site patterns, float32,
    per-site scaling, nibble-packed pattern tips): model parameters →
    P-matrices → the fused edge-score kernel K1 (``make_score``), and the
    fused sweep kernel K2 (``make_forward_fused``);
  * the large-tree tier: ``make_score_unbounded`` (the dyn score kernel
    K6 over the tree's segments) at BASELINE.json's large configuration,
    10 240 taxa × 1 048 576 sites, GTR+Γ4, float32, per-site scaling,
    nibble-packed tips drawn on the card; and the dyn sweep kernel K5
    (``make_dyn_sweep``) at 4 096 × 8 192;
  * the segmented tier at the README's configuration, 1 024 taxa × 32 768
    sites, GTR+Γ4, float32, per-site scaling, CLV tips: the segmented
    score K4 (``make_segmented_score``) and the segmented sweep K3
    (``make_segmented_sweep``), cut at the shared-memory row budget;
  * the roofline probes: the FP32 multiply-add peak K7 and the DNA
    contraction K8 (``ops/roofline.py``), timed over two chain lengths;
  * the training step at the flagship with tips simulated on the tree
    (``make_train_step_fused``): K2, the edge logL, the sumtable and the
    Newton solve of the evaluation edge's branch length, kernel N1
    (``ops/derivatives.py``, the whole solve in one cooperative launch);
  * the protein path: an LG4X+Γ4 alignment of 64 taxa × 65 536 columns
    simulated on the flagship's tree, written to FASTA, read back,
    compressed to site patterns and encoded as 20-bit masks, through
    ``make_score`` (K1 at 20 states), ``make_forward_fused`` (K2) and
    ``make_train_step_fused`` (K2 and N1);
  * the stateful Partition: the flagship's alignment simulated on its
    tree, written as PHYLIP, read back and compressed, in a float64
    ``Partition`` on the card (setters, P-matrices, ``update_partials``,
    the edge logL, sumtable and derivatives), and its parameters through
    ``model_from_partition`` into ``make_score`` (K1),
    ``make_forward_fused`` (K2) and ``make_train_step_fused`` (K2 and
    N1); the protein configuration in a float64 Partition into K1;
  * parsimony: ``fastparsimony_stepwise`` at scripts/bench_stepwise.py's
    two configurations (random ACGT, 2 048 taxa x 2 048 sites and 500 x
    10 000, seed 42), the device engine (the Fitch kernels P2 and P3 of
    ``csrc/fitch.cu``, no host read inside the insertion loop) and the
    host engine (P1 and P2), each against libpll_tpu's score and Newick;
  * branch-length optimisation (``engine/blopt.py``) of the flagship's
    alignment in a float64 Partition, every length times 2.5:
    ``optimize_branch_lengths`` (the host loop) and
    ``optimize_branch_lengths_scan`` (a sweep with no host read, eager and
    as a CUDA graph), on the op-table kernel U1 (``csrc/partials.cu``,
    which also runs every ``Partition.update_partials`` on the card) and
    N1 with blopt's Newton step;
  * tree search's candidate scorer (``search/spr.py``,
    ``ops/incremental.py``) at scripts/bench_spr.py's configuration
    (1 024 taxa x 16 384 random ACGT sites, float32, GTR+Γ4): the radius-3
    SPR neighbourhood of the first 64 inner nodes, encoded on the host and
    scored by ``score_encoded`` in batches of 32, each batch one launch of
    the replay kernel C1 (``csrc/partials.cu``) and the edge fold;
  * the inference driver (``search/infer.py``) at scripts/bench_infer.py's
    call: 1 024 taxa x 16 384 sites simulated under GTR+Γ4
    (``utils/flagship.infer_alignment``), ``infer_tree`` in float32 with
    batches of 128 to convergence: the device stepwise build (P2, P3),
    branch-length sweeps (U1, N1), SPR rounds (C1, and U1 for the
    verified commits);
  * model fitting (``engine/modelopt.py``) on that search's final tree
    and Partition: ``optimize_model`` as infer_tree's refit after a search
    calls it (L-BFGS through the plain float32 sweep and its backward, no
    kernel of the port), then a full branch-length sweep pair under the
    fitted model (U1, N1);
  * site sharding (``parallel/mesh.py``): two ranks on the one card
    through gloo, ``make_score_sharded`` at the flagship (K1),
    ``make_score_unbounded_sharded`` at the giant (K6), the word-sharded
    stepwise build (P2, P3) and ``infer_tree(mesh=)`` at
    scripts/bench_infer.py's call (P2, P3, U1, C1 and N1's derivative
    mode, one reduction a Newton body).

Phases, one line each:

  1. card: name and power limit (nvidia-smi);
  2. build: nvcc builds ``csrc/clv_fused.cu``, ``clv_dyn.cu``,
     ``clv_seg.cu``, ``roofline.cu``, ``derivatives.cu``, ``fitch.cu`` and
     ``partials.cu`` for sm_90a,
     one process each, all at once; the protein instances' registers,
     spills and stack (one and two sites a thread);
  3. small configs: K1/K2 against their plain PyTorch versions on the
     card, DNA and protein, for every tip encoding (protein: clv and
     masks; 1, 63, 64, 65, 300 and 1 000 sites, around a block's tile of
     32 or 64), scale mode, +I and rate-category count, in float64 (logL rel
     <= 1e-12, scalers equal, CLVs rel 1e-12) and float32 (logL within
     the f32 budget, scalers agree at >= 99.9% of entries, CLVs rtol 1e-5
     where they agree);
  4. flagship: ``make_score`` and ``make_forward_fused`` in float32 against
     the plain float64 ``make_forward`` on the card, |ΔlogL| <= 2e-6·|logL|
     + 5e-3 (the engine's f32 budget), launch counters > 0;
  5. times: K1/K2 and their plain versions at the flagship shapes, with
     CUDA events;
  6. dyn build: ``clv_dyn.cu``'s instances, registers and spills (built
     in phase 2);
  7. small dyn configs: K5 and K6 against their plain versions on the
     card with phase 3's tolerances: every tip encoding (masks only for
     protein), scale mode, float32/float64, C in {1, 2, 4, 8}, S in
     {4, 20}, ±I, single- and multi-segment trees; the same with the
     shared-memory pool capped at ``SPILL_CAPS`` slots, so that rows spill
     to device memory; and one instance scoring two topologies by a table
     swap (``dynamic_edge``, slot plan included);
  8. mid configs (BASELINE.md): 4 096 × 8 192 DNA with per-rate scalers
     through ``make_score_unbounded`` and ``make_dyn_sweep`` (K5, cut into
     segments), and 256 × 16 384 protein (20-bit masks) through
     ``make_score_unbounded``, each against the plain float64
     ``make_forward`` on the card within the f32 budget; the pool of each
     (slots, spilled rows, scratch rows), DNA without spills;
  9. giant: ``make_score_unbounded`` at 10 240 × 1 048 576; the logL is
     finite and the kernel's partial sums of eight 128-site blocks (the
     last among them) match the plain float64 ``make_forward`` run on
     those sites' tip columns, each within 2e-6·|block| + 5e-3; K6 matches
     its plain version (segment by segment, float32) on the same inputs,
     in logL and in every block, within the f32 budget; segments, row
     budget, the pool (no spills, no scratch), peak device memory,
     schedule time, ms/eval, K6's time against its bound;
 10. dyn times: K5 and K6 against their plain versions and their bounds
     at 4 096 × 8 192, K6 at the protein configuration, and K6 against
     its plain version and its bound at the giant;
 11. seg build: ``clv_seg.cu``'s and ``roofline.cu``'s instances,
     registers and spills;
 12. small seg configs: K3 and K4 against their plain versions on the card
     with phase 3's tolerances: CLV tips, every scale mode, float32/float64,
     C in {1, 2, 4, 8}, S in {4, 20}, one and many segments, a deep
     caterpillar that scales, segments as large as a block's shared memory
     holds, an odd site count, one launch per call (and once one per
     segment);
 13. README configuration: K4 and K3 (see ``phase_readme``), one launch
     per call each, segments, the pool, shared memory and blocks per SM,
     the peak device memory of each call (K4's below K3's), ms per call
     for K3, K4 and their plain versions, the host's time per call with
     the card idle, and the logLs to the last digit;
 14. roofline: K7 and K8 against their plain versions at small chain
     lengths (rel 1e-5), their sustained rates and K7's share of the FP32
     peak, and the contraction rates K1 (flagship) and K3 (README
     configuration) imply against K8's;
 15. newton small: N1 against its plain twin on the card
     (``newton_close``: one body's d1/d2, and t* with the bodies run) for
     per-site and per-rate scaling, +I, each asc mode, float32/float64,
     S in {4, 20}, C in {1, 4, 8}, and the path each took (resident or
     streamed slices);
 16. train step: ``make_train_step_fused`` at the flagship (float32,
     chars tips simulated on the tree): K2 once and N1 once,
     t* inside the clamp, the logL ``make_forward_fused``'s bit for bit,
     ``make_score`` at t* no worse than at t0 less the f32 budget, t*
     within 1e-5 of the float64 ``make_train_step``'s on the card (its N1
     on streamed slices, against its plain twin), two eager steps and two
     N1 calls equal, N1 against its plain twin;
 17. train times: the step eager and captured in a CUDA graph (its
     replay equal to the eager step bit for bit; the capture fails on any
     host sync), the host's time per call with the card idle, N1 against
     its bound and its plain twin, its time a body, path, blocks and
     shared memory;
 18. protein: the three entry points on the card (K1 once, K2 once, K2
     once and N1 once), each logL within the f32 budget of the
     plain float64 ``make_forward``, the step's logL
     ``make_forward_fused``'s bits, ``mxu_precision="high"`` equal to
     "highest" bit for bit, t* within 1e-5 of the float64
     ``make_train_step``'s, K1 against its plain version and K2's rows and
     counters against the plain walk (``FusedPlan.plain_walk``, phase 3's
     float32 rule), the peak device memory of each call, the walk's
     layout, and which (rate count, dtype, pool) combinations fit a block;
 19. protein times: ms per evaluation and per step, eager and as CUDA
     graphs (equal to the eager calls bit for bit), K1/K2 against their
     plain versions and their bounds, each with its share of the bound
     and its blocks per SM; N1 alone on the step's inputs, its time a
     body and path, against its plain twin;
 20. partition small: 37 configurations, the Partition on the card
     against the Partition on the CPU (every scaling mode, +I, the three
     asc modes, several rate matrices, explicit tip CLVs that scale,
     protein, one rate; ``pad_to`` and an op list that rewrites a
     buffer), float64 logL rel 1e-12, derivatives rel 1e-10, scalers
     equal, CLVs rel 1e-12, float32 within the budget; the executors of
     ``ops/clv`` on random op tables likewise;
 21. partition: the flagship in a float64 Partition: logL, CLVs and
     scalers against ``make_forward`` (rel 1e-12, equal), derivatives
     against ``make_train_step`` (rel 1e-10); K1/K2 on
     ``model_from_partition`` within the f32 budget, K2 + N1's t*
     confirmed by the Partition's derivatives, each entry point with its
     counters at 0 around it; the float32 Partition within the budget,
     its rows K2's (phase 3's float32 rule), the TF32 guard; an SPR
     whose partial traversal equals a full one, its rollback; a
     checkpoint restored on the card to the same logL bit for bit; the
     peak device memory;
 22. partition times: ``update_partials`` (float64 and float32: kernel
     U1, and the plain grouped executor), K2 at the same size,
     the partial traversal, the edge logL, sumtable and derivatives, the
     host's time of each call with the card idle;
 23. partition protein: the protein configuration in a float64
     Partition (four rate matrices) against ``make_forward`` (rel 1e-12)
     and ``make_score`` (K1 at S = 20, within the budget);
 24. parsimony small: P1-P3 against their plain versions on the card,
     exactly (words, costs, scores, ``back``, ``edge_rows``), at every
     launch of 32 configurations (4-200 taxa, DNA and 20 states with
     ambiguity codes, weighted patterns, 1-3 partitions, seeds 0, 1, 42
     and 12345); the card's FastParsimony, both stepwise engines and the
     Sankoff Parsimony (float64, rel 0) against the CPU's (the CPU's
     builds and engines computed beside phases 3-23 in a process of their
     own, ``CpuRefs``); P3's builds
     with its walk's tables forced into device or shared memory over
     other grids equal to its own plan's (``COMMIT_FORCED`` at
     ``COMMIT_FORCED_CASES``), and a build past the
     shared-memory budget (``PAST_BUDGET``), its last insertion against
     the plain version;
 25. stepwise: the device engine at 2 048 x 2 048 and 500 x 10 000, the
     host engine at 500 x 10 000 (``STEPWISE_HOST_CASES``; its 2 048 x
     2 048 build is tools/stepwise_times.py's), with their counters at 0
     around each: score and Newick equal to libpll_tpu's
     (``STEPWISE_JAX``, recorded from the JAX package on the CPU), the
     score re-derived by the plain Fitch of the final tree, which kernels
     ran (the host engine one P1 launch a call);
 26. stepwise times: each build's wall time, at 2 048 x 2 048 P2's and
     P3's device time a launch under torch.profiler and the device's idle
     share; P2 and P3
     at the last insertion and P1 over the final tree against their plain
     versions and their bounds (integer logic and popcount throughput,
     bytes at 3.35 TB/s); P1 at forced block counts (one, its plan's and
     a ragged split; its own with the table in device memory) over the
     final tree and over a 150-taxon tree at 20 states, each equal to the
     plain version (``check_wave_grids``); a whole build at 200 x 2 000
     by the plain versions (``stepwise_profile``, ``last_insertion_p3``);
 27. blopt small: U1 against the plain executor at every launch
     (``ReplayHook``) of phase 20's configurations and of random op
     tables (every scale mode, S 4/20/5, C 1-8, float64 rel 1e-12 with
     scalers equal, float32 by phase 3's rule; again under
     ``REPLAY_FORCED``'s plans, one lane a site, one op a window and
     nothing staged, each bit for bit U1's own plan's; a second draw of
     those tables, ``replay_second_draw``, its float64 ones under the
     hook and its float32 ones by the rule against the plain executor on
     the CPU) and of a bench_infer-shaped sweep's first tables
     (``sweep_shape_case``: 16 384 sites, float32), N1 with blopt's |d2| rule
     against its plain twin, both optimisers (the scan eager and graphed) at
     14 taxa on the card against the CPU Partition;
 28. blopt flagship: each optimiser two sweeps with its counters at 0
     around it (U1 and N1 launched): the logL rises and equals a fresh
     Partition's on the resulting tree (rel 1e-12), the plain versions on
     the card agree (logL rel 1e-10, lengths rel 1e-7), an eager scan
     sweep makes no host read (``torch.cuda.set_sync_debug_mode``);
 29. blopt times: U1 on a full ``update_partials`` against its bound and
     the plain executor, and at bench_infer's sweep tables (µs a launch
     under torch.profiler against the bytes its tables move, and the plain
     executor a table); ms a sweep and an edge of each optimiser, and the
     device's idle share over one (torch.profiler);
 30. scorer small: C1 at every launch (``ScorerHook``: its scoring
     instance's logL against the plain scorer's, float64 rel 1e-12,
     float32 the budget; its replay instance's scratch rows and scalers
     against the plain replay's, float64 rel 1e-12 with scalers equal,
     float32 by phase 3's rule) for phase 20's configurations (every
     scale mode, +I, the asc modes, S 4/20, C 1-4) and ``SCORER_EXTRA``
     (five states at eight rates, eight rates per-rate with +I) in float64
     (also with the pool capped at ``SCORER_POOL_CAPS`` slots, so that
     rows spill) and float32, SPR and NNI candidates; the
     logL on the card against the plain scorer on the card and the CPU
     scorer, the base buffers bit-identical, six candidates a case
     against a fresh Partition's evaluation of the moved tree; the NaN
     vote (one NaN at state 1 of rate 0 of every P-matrix): U1, K2 and C1
     give their plain versions' counters;
 31. spr: the configuration above with C1's counter at 0 around the
     scoring: one launch a batch, finite scores, the base unchanged;
     candidates, ``n_ops_max`` and the real ops a candidate, the host
     encode time, the scoring's wall time, the card's busy time and idle
     share, on one batch (``measure_batch``) the scoring instance against
     its bound and the plain scorer, the batch's card time, the plan's
     pool and spills, the replay instance against its bound and its
     plain version, and
     four candidates (the best among them) against a fresh evaluation of
     the moved tree within the f32 budget;
 32. search small: ``spr_round`` (commit 1, 4 and 8, per-site and
     per-rate scalers, one round with a rolled-back commit) and
     ``nni_round``, two rounds each, and ``infer_tree`` (SPR and NNI,
     local passes of radius 3 and none, 12 and 16 taxa) on the card
     against the same calls on the CPU, in float64 (the same results,
     moves, Newick and topology, logL rel 1e-9) and float32 (the f32
     budget, the same start score; the CPU's ``infer_tree`` runs from
     ``CpuRefs``), float64 against libpll_tpu's results recorded on the
     CPU (``SEARCH_JAX``); every valid CLV row after a
     round a fresh evaluation's; a round without improvement restores
     every valid row, scaler and flag bit for bit; the typed errors
     (capacity 2, a contained regraft, ``moves="tbr"``, ``mesh=``); U1
     and C1 against their plain versions at every launch (``ReplayHook``,
     ``ScorerHook``); ``optimize_model=True`` runs in phase 34;
 33. infer: scripts/bench_infer.py's call, ``max_rounds`` cut from its
     20 to ``BENCH_INFER_MAX_ROUNDS``, with every launch counter at 0
     around it: the alignment's SHA-256, the start parsimony score equal
     to libpll_tpu's (``BENCH_INFER_START_JAX``), the trajectory
     non-decreasing, the final logL within the f32 budget of a fresh
     float64 Partition on the card, U1, C1, N1, P2 and P3 launched and no
     plain version run; time-to-tree and the timings by phase, each
     round's candidates and seconds, each branch-length pass, RF to the
     generating tree, the peak device memory, and the card's idle share
     over one SPR round and a pass over 256 of a sweep's edges
     (torch.profiler) with C1's, U1's and N1's time a launch in them; C1 on the final tree's first batch of
     128 (``measure_batch``); the start tree's device build again, P2 and
     P3 a launch, and P3 at its last insertion against the plain
     version; N1 at this shape (the final tree's root edge, from the
     rows, blopt's rule) against its plain twin and the bound of one
     solve;
 34. model fitting: small fits in float64 on the card against the CPU and
     against libpll_tpu's results recorded on the CPU (``MODELOPT_JAX``):
     Γ, free and fixed rates, p-inv, an LG4X mixture (free rates and
     weights over four 20-state matrices) and ``infer_tree(
     optimize_model=True)`` at 12 taxa, under ``ReplayHook`` and
     ``ScorerHook``; then phase 33's final tree and Partition fitted
     (float32, from JC with α 0.8, one round): the trajectory
     non-decreasing, the Partition carrying the fit, the fit's logL within
     the f32 budget of a fresh float64 Partition under the fitted model,
     U1 and N1 launched in the sweep pair after it and no plain version
     run; the fitted parameters beside the generating ones, L-BFGS steps
     and evaluations, s a fit, ms a value-and-grad and a Brent
     evaluation, the eigendecomposition's placement and cost, the peak
     device memory and the card's idle share over one value-and-grad;
 35. mesh: site sharding (``parallel/mesh.py``), two ranks, each a
     process of this script (``--mesh-rank``), joined by gloo on cuda:0
     with the same arguments: ``make_score_sharded`` at the flagship (K1
     on 131 072 sites a rank, against its plain version there) and
     ``make_score_unbounded_sharded`` at the giant (K6 on 524 288 a
     rank) within the f32 budget of phases 4 and 9, the word-sharded
     stepwise build at 2 048 x 2 048 equal to libpll_tpu's, and
     ``infer_tree(mesh=)`` at phase 33's call against phase 33's one-rank
     result (the start score, the logL within the f32 budget, RF
     printed), U1, C1, N1's derivative mode, P2 and P3 launched and no
     plain version run; both ranks' results equal; N1's derivative mode
     against its plain twin at the final tree's root edge, its time and
     bound; the reductions and their time of each path.

The line before the last is a JSON summary of the kernels, each with its
bound (the larger of its operations at the card's FP32 peak, or for the
Fitch kernels its integer logic and popcounts at their pipes' rates, and
its bytes at 3.35 TB/s, from this run's shapes; U1 in float64 at the
FP64 vector peak, half the FP32 one); the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero
before either is printed; so does a machine without CUDA, or a directory
without the package.
"""

import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

ACC_REL, ACC_ABS = 2e-6, 5e-3  # float32 budget (BASELINE.md, test_accuracy)
F64_REL = 1e-12
F32_RTOL = 1e-5
F32_SCALER_AGREE = 0.999
# A C G T, R=A|G, Y=C|T, W=A|T, S=C|G, N/gap
IUPAC_POOL = np.array([1, 2, 4, 8, 5, 10, 9, 6, 15], np.uint32)
TIMED_ITERS, WARMUP = 20, 3


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------- inputs
def random_newick(tips, rng):
    items = [f"t{i}:{rng.uniform(0.05, 0.5):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.5):.4f}")
    return f"({items[0]},{items[1]},{items[2]});"


def caterpillar_newick(tips):
    s = "(t0:0.1,t1:0.1)"
    for i in range(2, tips - 2):
        s = f"({s}:0.1,t{i}:0.1)"
    return f"({s}:0.1,t{tips - 2}:0.1,t{tips - 1}:0.1);"


# protein: single states, B = D|N, Z = E|Q, X/gap
PROTEIN_POOL = np.array([1 << k for k in range(20)]
                        + [(1 << 2) | (1 << 11), (1 << 3) | (1 << 13),
                           (1 << 20) - 1], np.uint32)


def small_case(newick, sites, rate_cats, seed, states=4):
    """(topo, numpy model with +I, [tips, sites] ambiguity masks: IUPAC
    for DNA, B/Z/X among the protein states)."""
    from libpll_tpu_torch.engine.evaluate import topology_from_tree
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.models.gtr import eigen_decompose
    from libpll_tpu_torch.tree import utree as ut

    rng = np.random.default_rng(seed)
    topo, branches = topology_from_tree(ut.parse_newick_string(newick),
                                        sites)
    freqs = rng.uniform(0.1, 1.0, states)
    freqs /= freqs.sum()
    w, left, right = eigen_decompose(
        rng.uniform(0.5, 2.0, states * (states - 1) // 2), freqs)
    invariant = np.full(sites, -1, np.int32)
    invariant[: sites // 10] = rng.integers(0, states, sites // 10)
    model = {
        "branch_lengths": np.asarray(branches),
        "rates": compute_gamma_cats(0.8, rate_cats),
        "prop_invar": np.asarray([0.2]),
        "params_indices": np.zeros(rate_cats, np.int32),
        "eigenvals": w[None], "left": left[None], "right": right[None],
        "freqs_pc": np.broadcast_to(freqs, (rate_cats, states)),
        "prop_invar_pc": np.full(rate_cats, 0.2),
        "rate_weights": np.full(rate_cats, 1.0 / rate_cats),
        "pattern_weights": rng.integers(1, 4, sites).astype(np.float64),
        "invariant": invariant,
    }
    pool = IUPAC_POOL if states == 4 else PROTEIN_POOL
    masks = pool[rng.integers(0, len(pool), (topo.schedule.tips, sites))]
    return topo, model, masks


def tip_input(masks, tip_encoding, rate_cats, dtype, device, states=4):
    import torch

    from libpll_tpu_torch.ops import clv_fused as cf

    if tip_encoding == "chars":
        return cf.pack_tipchars(masks).to(device)
    words = torch.from_numpy(masks.astype(np.int32)).to(device)
    if tip_encoding == "masks":
        return words
    rows = torch.arange(masks.shape[0], device=device)
    return cf.decode_tips(words, "masks", rows, rate_cats, states,
                          dtype).contiguous()


def kernel_inputs(topo, model_np, dtype, device, use_pinv):
    """(pmatrix, weight_vec, pattern_weights, inv_add) as make_score builds
    them."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_fused as cf

    model = model_from_numpy(model_np, device, dtype)
    index = torch.as_tensor(topo.matrix_indices, dtype=torch.long,
                            device=device)
    pmatrix = ev._pmatrices(model, topo, dtype, index)
    if use_pinv:
        wvec, inv_add = ev._pinv_score_inputs(model, dtype)
    else:
        wvec = cf.pack_weight_vec(model["freqs_pc"], model["rate_weights"])
        inv_add = None
    return pmatrix, wvec, model["pattern_weights"], inv_add


# ------------------------------------------------------------ comparisons
def logl_close(got, want, dtype):
    import torch

    if dtype == torch.float64:
        return abs(got - want) <= F64_REL * abs(want)
    return abs(got - want) <= ACC_REL * abs(want) + ACC_ABS


def sweep_close(inner_k, scal_k, inner_p, scal_p, dtype):
    """Kernel vs plain K2 output.  Returns (ok, max abs CLV error where the
    counters agree, share of counters that agree).  CLV errors are taken
    relative to the largest entry of each (node, site) block: entries far
    below it may sit in float32 subnormals."""
    import torch

    same = scal_k == scal_p
    agree = float(same.double().mean())
    keep = same[:-1]
    keep = (keep[:, None, None, :] if keep.dim() == 2
            else keep[:, :, None, :]).expand_as(inner_p)
    diff = (inner_k.double() - inner_p.double()).abs()
    span = inner_p.double().abs().amax(dim=(1, 2), keepdim=True)
    rel = diff / span.clamp_min(torch.finfo(torch.float32).tiny)
    max_abs = float(diff[keep].max()) if keep.any() else 0.0
    max_rel = float(rel[keep].max()) if keep.any() else 0.0
    if dtype == torch.float64:
        ok = bool(same.all()) and max_rel <= F64_REL
    else:
        ok = agree >= F32_SCALER_AGREE and max_rel <= F32_RTOL
    return ok, max_abs, agree


def check_small(device):
    """Phase 3: every kernel configuration against its plain version.
    Returns (configurations checked, largest float32 K1 |d logL|, largest
    float32 K2 CLV abs error where counters agree)."""
    import torch

    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                                  SCALE_PER_SITE)

    rng = np.random.default_rng(1)
    # 1000 sites: a ragged last block of 104 sites; the caterpillars make
    # float32 scaling fire; 1 000 taxa need a larger pool and more staged
    # P-matrices than the flagship (chunks of ops).  The two large trees
    # underflow float32 without scaling (logL -inf in K1 and its plain
    # version alike): their K1 runs scaled only
    # Protein (S = 20, masks with B/Z/X among the tips; clv and masks
    # tips) on the same shapes: all four rate counts, a caterpillar, and
    # 1 000 taxa, whose walk is staged in chunks of ops; the protein
    # caterpillar underflows float32 without scaling
    scaled = (SCALE_PER_SITE,)
    both = (SCALE_NONE, SCALE_PER_SITE)
    trees = [("random16", random_newick(16, rng), (4,), 1000, both, 4),
             ("caterpillar48", caterpillar_newick(48), (4,), 1000, both, 4),
             ("random12", random_newick(12, rng), (1, 2, 8), 1000, both, 4),
             ("caterpillar400", caterpillar_newick(400), (4,), 300, scaled,
              4),
             ("random1000", random_newick(1000, rng), (4,), 300, scaled, 4),
             ("protein random12", random_newick(12, rng), (1, 2, 4, 8), 1000,
              both, 20),
             ("protein caterpillar48", caterpillar_newick(48), (4,), 1000,
              scaled, 20),
             ("protein random1000", random_newick(1000, rng), (4,), 300,
              scaled, 20),
             # on both sides of a block's tile (32 or 64 sites)
             ("protein random12", random_newick(12, rng), (4,), 1, both,
              20),
             ("protein random12", random_newick(12, rng), (2, 8), 63, both,
              20),
             ("protein caterpillar48", caterpillar_newick(48), (4,), 64,
              scaled, 20),
             ("protein random12", random_newick(12, rng), (1, 4), 65, both,
              20)]
    n, k1_err, k2_err = 0, 0.0, 0.0
    for label, newick, cats, sites, k1_scales, states in trees:
        encodings = ("clv", "chars", "masks") if states == 4 else ("clv",
                                                                   "masks")
        for rate_cats in cats:
            topo, model_np, masks = small_case(newick, sites, rate_cats,
                                               seed=rate_cats, states=states)
            sched = topo.schedule
            edge = dict(parent_clv=topo.parent_clv,
                        child_clv=topo.child_clv,
                        edge_matrix=topo.edge_matrix)
            for dtype in (torch.float32, torch.float64):
                for enc in encodings:
                    tp = tip_input(masks, enc, rate_cats, dtype, device,
                                   states)
                    where = (f"{label} {sites} sites C={rate_cats} {dtype} "
                             f"{enc}")
                    pm = kernel_inputs(topo, model_np, dtype, device,
                                       False)[0]
                    for scale in (SCALE_NONE, SCALE_PER_SITE,
                                  SCALE_PER_RATE):
                        got = cf.fused_sweep(sched, tp, pm, scale_mode=scale,
                                             tip_encoding=enc)
                        want = cf.fused_sweep_plain(
                            sched, tp, pm, scale_mode=scale,
                            tip_encoding=enc)
                        torch.cuda.synchronize()
                        ok, err, agree = sweep_close(*got, *want, dtype)
                        check(ok, f"K2 {where} scale={scale}: max abs err "
                                  f"{err}, scaler agreement {agree}")
                        if dtype == torch.float32:
                            k2_err = max(k2_err, err)
                        n += 1
                    for scale in k1_scales:
                        for pinv in (False, True):
                            args = kernel_inputs(topo, model_np, dtype,
                                                 device, pinv)
                            got = float(cf.fused_edge_score(
                                sched, tp, *args, scale_mode=scale,
                                tip_encoding=enc, **edge))
                            want = float(cf.fused_edge_score_plain(
                                sched, tp, *args, scale_mode=scale,
                                tip_encoding=enc, **edge))
                            check(np.isfinite(got) and logl_close(
                                got, want, dtype),
                                f"K1 {where} scale={scale} pinv={pinv}: "
                                f"{got} vs plain {want}")
                            if dtype == torch.float32:
                                k1_err = max(k1_err, abs(got - want))
                            n += 1
    return n, k1_err, k2_err


# --------------------------------------------------------------- dyn tier
def stacked(tables, device):
    """Per-segment tables as [n_segments, ...] tensors on ``device``."""
    import torch

    return [torch.stack(list(t)).to(device) for t in tables]


def check_dyn_small(device):
    """Phase 7: K5 and K6 against their plain versions.  Returns
    (configurations checked, largest float32 K5 CLV abs error, largest
    float32 K6 |d logL|, configurations with forced spills)."""
    import torch

    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                                  SCALE_PER_SITE)

    rng = np.random.default_rng(2)
    # (label, newick, states, rate categories, row budget; None: one
    # segment); 1000 sites leave a ragged last block of 104
    trees = [("random16", random_newick(16, rng), 4, (4,), None),
             ("random16/8rows", random_newick(16, rng), 4, (4,), 8),
             ("caterpillar48/12rows", caterpillar_newick(48), 4, (4,), 12),
             ("random12/6rows", random_newick(12, rng), 4, (1, 2, 8), 6),
             ("protein12/6rows", random_newick(12, rng), 20, (1, 2, 4, 8),
              6)]
    n, k5_err, k6_err = 0, 0.0, 0.0
    for label, newick, states, cats, max_rows in trees:
        for rate_cats in cats:
            topo, model_np, masks = small_case(newick, 1000, rate_cats,
                                               seed=rate_cats, states=states)
            dyn = cd.build_dyn_schedule(
                topo.schedule, rate_cats=rate_cats, states=states,
                max_rows=max_rows, sites=1000,
                ensure_rows=[topo.parent_clv, topo.child_clv])
            check((max_rows is None) == (len(dyn.segments) == 1),
                  f"{label}: {len(dyn.segments)} segments")
            tables = stacked(cd.dyn_score_args(dyn), device)
            edge = (topo.parent_clv, topo.child_clv, topo.edge_matrix)
            for dtype in (torch.float32, torch.float64):
                for enc in (("clv", "chars", "masks") if states == 4
                            else ("masks",)):
                    tp = tip_input(masks, enc, rate_cats, dtype, device,
                                   states)
                    where = (f"{label} S={states} C={rate_cats} {dtype} "
                             f"{enc}")
                    for scale in (SCALE_NONE, SCALE_PER_SITE,
                                  SCALE_PER_RATE):
                        pm = kernel_inputs(topo, model_np, dtype, device,
                                           False)[0]
                        sweep = cd.make_dyn_sweep(
                            dyn, scale, rate_cats=rate_cats, states=states,
                            tip_encoding=enc)
                        got = sweep(tp, *tables[:2], pm)
                        want = sweep.plain(tp, *tables[:2], pm)
                        torch.cuda.synchronize()
                        ok, err, agree = sweep_close(*got, *want, dtype)
                        check(ok, f"K5 {where} scale={scale}: max abs err "
                                  f"{err}, scaler agreement {agree}")
                        if dtype == torch.float32:
                            k5_err = max(k5_err, err)
                        n += 1
                        for pinv in (False, True):
                            args = kernel_inputs(topo, model_np, dtype,
                                                 device, pinv)
                            score = cd.make_dyn_score(
                                dyn, *edge, scale, rate_cats=rate_cats,
                                states=states, tip_encoding=enc,
                                use_pinv=pinv)
                            got = float(score(tp, *tables, *args))
                            want = float(score.plain(tp, *tables, *args))
                            check(np.isfinite(got) and logl_close(
                                got, want, dtype),
                                f"K6 {where} scale={scale} pinv={pinv}: "
                                f"{got} vs plain {want}")
                            if dtype == torch.float32:
                                k6_err = max(k6_err, abs(got - want))
                            n += 1
    n_spill = check_dyn_spill(device)
    return n + n_spill + check_dyn_swap(device), k5_err, k6_err, n_spill


SPILL_CAPS = (0, 1, 2)  # pool slots that force spills in the small trees


def check_dyn_spill(device):
    """K5 and K6 with their pools capped below the plan's peak (at each of
    ``SPILL_CAPS`` that is), so that local rows spill to device memory
    (K6's scratch, K5's output rows), against their plain versions with
    phase 3's tolerances: DNA (chars tips) on one segment, on many and on a
    caterpillar that scales, protein (masks) at four rates; every scale
    mode, float32/float64, +I under per-site scaling.  Returns the
    configurations checked."""
    import torch

    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                                  SCALE_PER_SITE)

    rng = np.random.default_rng(5)
    trees = [("random24", random_newick(24, rng), 4, "chars", None),
             ("random64/24rows", random_newick(64, rng), 4, "chars", 24),
             ("caterpillar48", caterpillar_newick(48), 4, "chars", None),
             ("protein16", random_newick(16, rng), 20, "masks", None)]
    n = 0
    for label, newick, states, enc, max_rows in trees:
        topo, model_np, masks = small_case(newick, 1000, 4, seed=5,
                                           states=states)
        dyn = cd.build_dyn_schedule(
            topo.schedule, rate_cats=4, states=states, max_rows=max_rows,
            sites=1000, ensure_rows=[topo.parent_clv, topo.child_clv])
        tables = stacked(cd.dyn_score_args(dyn), device)
        edge = (topo.parent_clv, topo.child_clv, topo.edge_matrix)
        tp = tip_input(masks, enc, 4, None, device, states)
        for dtype in (torch.float32, torch.float64):
            for scale in (SCALE_NONE, SCALE_PER_SITE, SCALE_PER_RATE):
                pm = kernel_inputs(topo, model_np, dtype, device, False)[0]
                sweep = cd.make_dyn_sweep(dyn, scale, rate_cats=4,
                                          states=states, tip_encoding=enc)
                pinv = scale == SCALE_PER_SITE
                args = kernel_inputs(topo, model_np, dtype, device, pinv)
                score = cd.make_dyn_score(dyn, *edge, scale, rate_cats=4,
                                          states=states, tip_encoding=enc,
                                          use_pinv=pinv)
                k5_want = sweep.plain(tp, *tables[:2], pm)
                k6_want = float(score.plain(tp, *tables, *args))
                peak = min(max(sweep.plan.n_slots), max(score.plan.n_slots))
                caps = [cap for cap in SPILL_CAPS if cap < peak]
                check(caps, f"{label}: peak {peak} live rows")
                for cap in caps:
                    where = (f"{label} S={states} {dtype} scale={scale} "
                             f"pool cap {cap}")
                    sweep.slot_cap = score.slot_cap = cap
                    got = sweep(tp, *tables[:2], pm)
                    torch.cuda.synchronize()
                    ok, err, agree = sweep_close(*got, *k5_want, dtype)
                    check(ok, f"K5 {where}: max abs err {err}, scaler "
                              f"agreement {agree}")
                    got = float(score(tp, *tables, *args))
                    check(np.isfinite(got) and logl_close(got, k6_want,
                                                          dtype),
                          f"K6 {where} pinv={pinv}: {got} vs plain "
                          f"{k6_want}")
                    n += 2
    return n


def check_dyn_swap(device):
    """One K6 instance (``dynamic_edge``) scores two 16-taxon topologies
    built with matching envelope floors by swapping their tables, eval
    locations, edge matrix, import wiring and tip rows: each result equals
    a fresh instance's bit for bit and the plain version's within
    tolerance.  Returns the configurations checked."""
    import torch

    from libpll_tpu_torch.ops import clv_dyn as cd

    rng = np.random.default_rng(7)
    cases = [small_case(random_newick(16, rng), 1000, 4, seed=7)
             for _ in range(2)]

    def schedule(topo, floors):
        return cd.build_dyn_schedule(
            topo.schedule, rate_cats=4, states=4, max_rows=8,
            ensure_rows=[topo.parent_clv, topo.child_clv], **floors)

    probes = [schedule(topo, {}) for topo, _, _ in cases]
    floors = dict(
        min_r_tip=max(p.r_tip for p in probes) + 2,
        min_r_imp=max(p.r_imp for p in probes) + 2,
        min_r_loc=max(p.r_loc for p in probes),
        min_segments=max(len(p.segments) for p in probes) + 1,
        min_r_exp=max(cd._export_tables(p)[2] for p in probes) + 2)
    dyns = [schedule(topo, floors) for topo, _, _ in cases]
    topo0 = cases[0][0]
    shared = cd.make_dyn_score(dyns[0], topo0.parent_clv, topo0.child_clv,
                               topo0.edge_matrix, rate_cats=4, states=4,
                               dynamic_edge=True)
    n = 0
    for (topo, model_np, masks), dyn in zip(cases, dyns):
        tp = tip_input(masks, "chars", 4, None, device)
        tables, m_g, exp_t, imp_src, plan = cd.dyn_swap_args(dyn)
        data = dict(
            eval_locs=torch.from_numpy(cd.dyn_eval_locs(
                dyn, topo.parent_clv, topo.child_clv)).to(device),
            edge_matrix_idx=torch.tensor(topo.edge_matrix, device=device),
            imp_src=imp_src.to(device), slot_plan=plan.to(device),
            tip_globals=cd.dyn_tip_globals(dyn).to(device))
        tabs = stacked((tables, m_g, exp_t), device)
        fresh = cd.make_dyn_score(dyn, topo.parent_clv, topo.child_clv,
                                  topo.edge_matrix, rate_cats=4, states=4)
        for dtype in (torch.float32, torch.float64):
            args = kernel_inputs(topo, model_np, dtype, device, False)
            got = float(shared(tp, *tabs, *args, **data))
            want = float(fresh(tp, *tabs, *args))
            plain = float(shared.plain(tp, *tabs, *args, **data))
            check(got == want and logl_close(got, plain, dtype),
                  f"K6 table swap {dtype}: {got} vs fresh {want}, plain "
                  f"{plain}")
            n += 1
    return n


def plain_forward_f64(topo, tips_packed, tip_encoding, model64, states):
    """The plain float64 make_forward on the card: (logL, per-site)."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.constants import SCALE_PER_RATE

    device = tips_packed.device
    sched, sites = topo.schedule, tips_packed.shape[-1]
    c = model64["freqs_pc"].shape[0]
    clv = torch.zeros((sched.tips + sched.n_inner, c, states, sites),
                      dtype=torch.float64, device=device)
    clv[:sched.tips] = cf.decode_tips(
        tips_packed, tip_encoding, torch.arange(sched.tips, device=device),
        c, states, torch.float64)
    sshape = ((sched.n_inner + 1, c, sites)
              if topo.scale_mode == SCALE_PER_RATE
              else (sched.n_inner + 1, sites))
    scal = torch.zeros(sshape, dtype=torch.int32, device=device)
    logl, persite = ev.make_forward(topo).to(device)(model64, clv, scal)
    return float(logl), persite


def sweep_logl(topo, dyn, inner, scalers, tips_packed, model, pmatrix):
    """The edge log-likelihood of a K5 output (segment-major rows)."""
    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import likelihood as lk
    from libpll_tpu_torch.utils.constants import SCALE_PER_RATE

    import torch

    tips, c = dyn.tips, pmatrix.shape[1]

    def row(idx):
        if idx >= tips:
            return inner[dyn.inner_row(idx - tips)]
        rows = torch.arange(idx, idx + 1, device=tips_packed.device)
        return cf.decode_tips(tips_packed, "chars", rows, c, 4,
                              pmatrix.dtype)[0]

    def srow(idx):
        return scalers[dyn.scaler_row(idx - tips) if idx >= tips
                       else dyn.n_inner]

    f = ev._floats(model, pmatrix.dtype)
    return float(lk.edge_loglikelihood(
        row(topo.parent_clv), row(topo.child_clv), srow(topo.parent_clv),
        srow(topo.child_clv), pmatrix[topo.edge_matrix], f["freqs_pc"],
        f["rate_weights"], f["pattern_weights"], f["prop_invar_pc"],
        model["invariant"], sites=topo.sites,
        per_rate=topo.scale_mode == SCALE_PER_RATE)[0])


def ptxas_report(name, kernel=""):
    """[(instance, registers, spill bytes, stack bytes)] from nvcc's
    -Xptxas -v log of ``csrc/<name>.cu``, of the kernels whose mangled
    name holds ``kernel``.  An instance is labelled by its template
    arguments (``<float,4>``; a trailing bool, K1's score flag, as
    ``<float,4,1>``; then an int, the protein instances' sites a thread,
    as ``<float,4,1,2>``) or else by its kernel's name."""
    import re

    from libpll_tpu_torch.ops import _build

    rows, current, spill, stack = [], None, 0, 0
    log = _build.library_path(name).with_suffix(".log")
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if kernel in m.group(1) else None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m:
            stack, spill = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            t = re.search(r"I([fd])Li(\d+)E(?:Lb([01])E)?(?:Li(\d+)E)?",
                          current)
            k = re.search(r"\d([a-z_]+_kernel)", current)
            label = (f"<{'float' if t.group(1) == 'f' else 'double'},"
                     + ",".join(g for g in t.groups()[1:] if g) + ">"
                     if t else k.group(1) if k else current)
            rows.append((label, int(m.group(1)), spill, stack))
            current = None
    return rows


# ------------------------------------------------------------- timing
def time_ms(fn, iters=TIMED_ITERS, warmup=WARMUP):
    """(device ms, host ms) per call over ``iters`` back-to-back calls:
    CUDA events around the run, and the host clock around issuing it.
    Host ms near device ms means the host, not the card, sets the pace."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def graph_ms(fn, iters=TIMED_ITERS, warmup=WARMUP):
    """Device ms per call of ``fn`` captured once in a CUDA graph and
    replayed back to back (``time_ms``): the call's device time, without
    the host's time to launch it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(graph.replay, iters, warmup)[0]


def host_ms(fn, iters=TIMED_ITERS):
    """Median wall time of one call's issue, in ms, with the card idle
    (synchronised before each call, the clock stopped before the
    synchronisation after it)."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


HBM_BYTES_PER_S = 3.35e12  # an H100 SXM's device memory (data sheet)
CONTRACT_FLOP = (2 * 4 - 1) * 4  # per contracted child, rate and site (DNA)


def bound(flop, nbytes, peak):
    """(ms, "operations" or "bytes"): the least time the card could take
    for ``flop`` float32 operations at ``peak`` flop/s and ``nbytes``
    moved at HBM_BYTES_PER_S, the larger of the two."""
    ops_ms, bytes_ms = flop / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def pool_line(kernel, dtype):
    """The pool of a K5/K6 instance at ``dtype``: (text, layout)."""
    lay = kernel.layout(dtype)
    return (f"pool {max(lay.pools)} slots (plan peak "
            f"{max(kernel.plan.n_slots)}), {lay.spills} spilled rows, "
            f"scratch rows {lay.scratch}"), lay


MID_TIPS, MID_SITES = 4096, 8192
K5_MAX_ROWS = 1024  # cuts the mid tree into segments, so K5 imports
PROTEIN_TIPS, PROTEIN_SITES = 256, 16384
GIANT_TIPS, GIANT_SITES = 10240, 1 << 20
GIANT_BLOCKS = 8
PLAIN_ITERS = 3  # the plain dyn versions take ~1 s a call at the mid size


def phase_mid(device, peak):
    """Phase 8, and the times of phase 10.  Returns the numbers the JSON
    line reports.  DNA float32 runs without spills: the pools hold each
    segment's live rows and no scratch is allocated."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.constants import SCALE_PER_RATE
    from libpll_tpu_torch.utils.flagship import (build_flagship_topology,
                                                 draw_tipchars_cuda)

    t0 = time.perf_counter()
    topo, model_np = build_flagship_topology(MID_TIPS, MID_SITES, seed=1)
    topo = topo._replace(scale_mode=SCALE_PER_RATE)
    tp = draw_tipchars_cuda(MID_TIPS, MID_SITES, 1, device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    want = plain_forward_f64(topo, tp, "chars", model_from_numpy(
        model_np, device, torch.float64), 4)[0]
    torch.cuda.empty_cache()
    budget = ACC_REL * abs(want) + ACC_ABS
    score = ev.ScoreUnbounded(topo, 4, 4, tp, "chars").to(device)
    got = float(score(m32))
    check(np.isfinite(got) and abs(got - want) <= budget,
          f"mid make_score_unbounded {got} vs plain f64 {want}")

    dyn = cd.build_dyn_schedule(
        topo.schedule, rate_cats=4, states=4, max_rows=K5_MAX_ROWS,
        ensure_rows=[topo.parent_clv, topo.child_clv])
    sweep = cd.make_dyn_sweep(dyn, SCALE_PER_RATE, rate_cats=4, states=4,
                              tip_encoding="chars")
    tables = stacked(cd.dyn_runtime_args(dyn), device)
    pm = score.pmatrices(m32, torch.float32)
    cd.DynSweep.launches = 0
    inner, scal = sweep(tp, *tables, pm)
    torch.cuda.synchronize()
    k5_launches = cd.DynSweep.launches
    check(k5_launches > 0, "make_dyn_sweep launched no K5")
    got_k5 = sweep_logl(topo, dyn, inner, scal, tp, m32, pm)
    check(abs(got_k5 - want) <= budget,
          f"mid K5 logL {got_k5} vs plain f64 {want}")
    ok, k5_err, agree = sweep_close(inner, scal, *sweep.plain(tp, *tables,
                                                             pm),
                                    torch.float32)
    check(ok, f"mid K5 vs plain: max abs err {k5_err}, scalers agree "
              f"{agree}")
    del inner, scal
    wvec = cf.pack_weight_vec(m32["freqs_pc"], m32["rate_weights"])
    k6_args = (score.tips, score.tables, score.m_ops, score.exp_tables, pm,
               wvec, m32["pattern_weights"])
    k6_err = abs(float(score.kernel(*k6_args))
                 - float(score.kernel.plain(*k6_args)))
    check(k6_err <= budget, f"mid K6 vs plain: |d logL| {k6_err}")
    k6_pool, k6_lay = pool_line(score.kernel, torch.float32)
    k5_pool, k5_lay = pool_line(sweep, torch.float32)
    check(k6_lay.spills == k5_lay.spills == k6_lay.scratch == 0,
          f"mid DNA f32 spills: K6 {k6_pool}; K5 {k5_pool}")
    print(f"[8 dyn mid] {MID_TIPS} x {MID_SITES} DNA per-rate f32: "
          f"make_score_unbounded {got:.6f} ({len(score.dyn.segments)} "
          f"segment(s)), K5 make_dyn_sweep logL {got_k5:.6f} "
          f"({len(dyn.segments)} segments, {k5_launches} launches), plain "
          f"f64 make_forward {want:.6f} (|d| {abs(got - want):.3e}, "
          f"{abs(got_k5 - want):.3e} <= {budget:.3e}); K5-plain max abs "
          f"{k5_err:.3e}, scalers agree {agree:.6f}; K6-plain |d logL| "
          f"{k6_err:.3e}; K6 {k6_pool}; K5 {k5_pool}", flush=True)

    ptopo, pmodel, pmasks = small_case(
        random_newick(PROTEIN_TIPS, np.random.default_rng(3)),
        PROTEIN_SITES, 4, seed=3, states=20)
    pmodel["prop_invar"] = np.zeros(1)
    pmodel["prop_invar_pc"] = np.zeros(4)
    pwant = plain_forward_f64(
        ptopo, torch.from_numpy(pmasks.astype(np.int32)).to(device),
        "masks", model_from_numpy(pmodel, device, torch.float64), 20)[0]
    torch.cuda.empty_cache()
    pscore = ev.make_score_unbounded(ptopo, 4, 20, pmasks).to(device)
    pgot = float(pscore(model_from_numpy(pmodel, device, torch.float32)))
    pbudget = ACC_REL * abs(pwant) + ACC_ABS
    check(np.isfinite(pgot) and abs(pgot - pwant) <= pbudget,
          f"protein make_score_unbounded {pgot} vs plain f64 {pwant}")
    p_pool = pool_line(pscore.kernel, torch.float32)[0]
    print(f"[8 dyn mid] {PROTEIN_TIPS} x {PROTEIN_SITES} protein (20-bit "
          f"masks, B/Z/X codes) f32: make_score_unbounded {pgot:.6f} vs "
          f"plain f64 make_forward {pwant:.6f} (|d| {abs(pgot - pwant):.3e}"
          f" <= {pbudget:.3e}); {len(pscore.dyn.segments)} segment(s), "
          f"K6 {p_pool} ({time.perf_counter() - t0:.1f} s)", flush=True)
    pm32 = model_from_numpy(pmodel, device, torch.float32)
    p_args = (pscore.tips, pscore.tables, pscore.m_ops, pscore.exp_tables,
              pscore.pmatrices(pm32, torch.float32),
              cf.pack_weight_vec(pm32["freqs_pc"], pm32["rate_weights"]),
              pm32["pattern_weights"])
    protein_ms = time_ms(lambda: pscore.kernel(*p_args))[0]
    del pscore, p_args

    ms = {"k6": time_ms(lambda: score.kernel(*k6_args))[0],
          "k6_plain": time_ms(lambda: score.kernel.plain(*k6_args),
                              PLAIN_ITERS, 1)[0],
          "k5": time_ms(lambda: sweep(tp, *tables, pm))[0],
          "k5_plain": time_ms(lambda: sweep.plain(tp, *tables, pm),
                              PLAIN_ITERS, 1)[0]}
    ms["protein_k6"] = protein_ms
    sched = topo.schedule
    k5_bytes = (sched.n_inner * 4 * 4 * MID_SITES * 4  # rows out
                + (sched.n_inner + 1) * 4 * MID_SITES * 4  # counters out
                + -(-MID_TIPS // 8) * MID_SITES * 4)  # tip words in
    k6_flop = (2 * sched.n_inner + 1) * MID_SITES * 4 * CONTRACT_FLOP
    return dict(k5_launches=k5_launches, k5_err=k5_err, k6_err=k6_err,
                k5_segments=len(dyn.segments), ms=ms,
                k5_bound=bound(2 * sched.n_inner * MID_SITES * 4
                               * CONTRACT_FLOP, k5_bytes, peak),
                k6_bound=bound(k6_flop, -(-MID_TIPS // 8) * MID_SITES * 4,
                               peak))


def phase_giant(device, peak):
    """Phase 9: the large-tree tier at full width on one card, without
    spills: the pools hold every segment's live rows, so K6 allocates no
    scratch."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.flagship import (build_flagship_topology,
                                                 draw_tipchars_cuda)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    topo, model_np = build_flagship_topology(GIANT_TIPS, GIANT_SITES, seed=0)
    topo_s = time.perf_counter() - t0
    tp = draw_tipchars_cuda(GIANT_TIPS, GIANT_SITES, 0, device)
    t0 = time.perf_counter()
    score = ev.ScoreUnbounded(topo, 4, 4, tp, "chars").to(device)
    sched_s = time.perf_counter() - t0
    m32 = model_from_numpy(model_np, device, torch.float32)

    cd.DynScore.launches = 0
    logl = float(score(m32))
    torch.cuda.synchronize()
    launches = cd.DynScore.launches
    check(launches > 0, "make_score_unbounded launched no K6")
    check(np.isfinite(logl), f"giant logL {logl}")
    pool, lay = pool_line(score.kernel, torch.float32)
    check(lay.spills == lay.scratch == 0, f"giant spills: {pool}")
    partials = score(m32, return_partials=True)
    check(abs(float(partials.sum()) - logl) <= 1e-9 * abs(logl),
          "giant partials do not sum to the logL")
    peak_mem = torch.cuda.max_memory_allocated()

    # per-site scaling is site-local: the plain f64 path on the tip
    # columns of a few blocks gives those blocks' per-site values
    n_blocks = partials.shape[0]
    blocks = sorted({int(b) for b in
                     np.linspace(0, n_blocks - 1, GIANT_BLOCKS).round()})
    check(len(blocks) == GIANT_BLOCKS and blocks[-1] == n_blocks - 1,
          f"sampled blocks {blocks}")
    spans = [np.arange(b * cd.BLOCK_SITES,
                       min((b + 1) * cd.BLOCK_SITES, GIANT_SITES))
             for b in blocks]
    cols = np.concatenate(spans)
    sub = dict(model_np, pattern_weights=model_np["pattern_weights"][cols],
               invariant=model_np["invariant"][cols])
    idx = torch.from_numpy(cols).to(device)
    persite = plain_forward_f64(
        topo._replace(sites=len(cols)), tp[:, idx].contiguous(), "chars",
        model_from_numpy(sub, device, torch.float64), 4)[1]
    want = torch.stack([p.sum() for p in
                        persite.split([len(x) for x in spans])])
    got = partials[blocks]
    diff = (got - want).abs()
    tol = ACC_REL * want.abs() + ACC_ABS
    check(bool((diff <= tol).all()),
          f"giant blocks {blocks}: kernel {got.tolist()} vs plain f64 "
          f"{want.tolist()}")
    del persite
    torch.cuda.empty_cache()

    # K6 against its plain version on the same inputs at these shapes: the
    # plain version runs segment by segment, ~14 GB of state at a time
    pm = score.pmatrices(m32, torch.float32)
    wvec = cf.pack_weight_vec(m32["freqs_pc"], m32["rate_weights"])
    k6_args = (score.tips, score.tables, score.m_ops, score.exp_tables, pm,
               wvec, m32["pattern_weights"])
    plain = score.kernel.plain(*k6_args, return_partials=True)
    k6_err = abs(float(partials.sum()) - float(plain.sum()))
    block_err = (partials - plain).abs()
    check(k6_err <= ACC_REL * abs(logl) + ACC_ABS and bool(
        (block_err <= ACC_REL * plain.abs() + ACC_ABS).all()),
        f"giant K6 vs plain: |d logL| {k6_err}, largest block |d| "
        f"{float(block_err.max())}")
    del plain, partials
    torch.cuda.empty_cache()
    ms, host = time_ms(lambda: score(m32), iters=3, warmup=1)
    k6_ms = time_ms(lambda: score.kernel(*k6_args), iters=3, warmup=1)[0]
    k6_plain_ms = time_ms(lambda: score.kernel.plain(*k6_args), iters=1,
                          warmup=0)[0]
    # every child of every op and the edge's child is contracted; the tip
    # words are read once, the rest is small
    k6_bound = bound((2 * topo.schedule.n_inner + 1) * GIANT_SITES * 4
                     * CONTRACT_FLOP, tp.numel() * 4, peak)
    print(f"[9 giant] {GIANT_TIPS} taxa x {GIANT_SITES} sites x 4 rates "
          f"f32 chars, per-site scaling, one card: make_score_unbounded "
          f"logL {logl:.6f} (finite); {len(score.dyn.segments)} segments, "
          f"max_rows {cd.dyn_max_rows(4, 4, GIANT_SITES)} (r_tip "
          f"{score.dyn.r_tip}, r_imp {score.dyn.r_imp}, r_loc "
          f"{score.dyn.r_loc}), {launches} K6 launches per eval; blocks "
          f"{blocks} match the plain f64 path on their columns (largest "
          f"|d| {float(diff.max()):.3e}, tolerance >= "
          f"{float(tol.min()):.3e}); K6 vs its plain version |d logL| "
          f"{k6_err:.3e}, largest block |d| {float(block_err.max()):.3e}; "
          f"K6 {pool}; peak device memory "
          f"{peak_mem / 2**30:.2f} GiB; host: topology {topo_s:.2f} s, "
          f"schedule {sched_s:.2f} s; {ms:.2f} ms/eval (host issues a call "
          f"in {host:.2f} ms); K6 {k6_ms:.2f} ms against its bound "
          f"{k6_bound[0]:.2f} ms ({k6_bound[1]}): "
          f"{k6_bound[0] / k6_ms * 100:.1f}%", flush=True)
    return dict(logl=logl, launches=launches, ms=ms, k6_err=k6_err,
                k6_ms=k6_ms,
                k6_plain_ms=k6_plain_ms, k6_bound=k6_bound,
                peak_gib=peak_mem / 2**30, pool=pool)


# ---------------------------------------------------------- segmented tier
def seg_pair(device, topo, model_np, masks, seg, rate_cats, states, dtype,
             where, scales, split=False):
    """K3 and K4 on one schedule against their plain versions at each of
    ``scales``, phase 3's tolerances; one launch per call (``split``: one
    per segment).  Returns (configurations, largest K3 CLV abs error,
    largest K4 |d logL|, largest dynamic shared memory per block)."""
    import torch

    from libpll_tpu_torch.ops import clv_seg as cseg

    slabs = cseg.pack_tips_segmented(tip_input(
        masks, "clv", rate_cats, dtype, device, states), seg)
    pm, wvec, pw, _ = kernel_inputs(topo, model_np, dtype, device, False)
    edge = (topo.parent_clv, topo.child_clv, topo.edge_matrix)
    per_call = len(seg.segments) if split else 1
    n, k3_err, k4_err, smem = 0, 0.0, 0.0, 0
    for scale in scales:
        sweep = cseg.make_segmented_sweep(seg, scale, rate_cats=rate_cats,
                                          states=states)
        score = cseg.make_segmented_score(seg, *edge, scale,
                                          rate_cats=rate_cats, states=states)
        sweep.split = score.split = split
        smem = max(smem, sweep.smem(dtype), score.smem(dtype))
        before = cseg.SegmentedSweep.launches
        got = sweep(slabs, pm)
        check(cseg.SegmentedSweep.launches - before == per_call,
              f"K3 {where}: {cseg.SegmentedSweep.launches - before} "
              f"launches, want {per_call}")
        want = sweep.plain(slabs, pm)
        torch.cuda.synchronize()
        ok, err, agree = sweep_close(*got, *want, dtype)
        check(ok, f"K3 {where} scale={scale}: max abs err {err}, scaler "
                  f"agreement {agree}")
        before = cseg.SegmentedScore.launches
        got = float(score(slabs, pm, wvec, pw))
        check(cseg.SegmentedScore.launches - before == per_call,
              f"K4 {where}: {cseg.SegmentedScore.launches - before} "
              f"launches, want {per_call}")
        want = float(score.plain(slabs, pm, wvec, pw))
        check(np.isfinite(got) and logl_close(got, want, dtype),
              f"K4 {where} scale={scale}: {got} vs plain {want}")
        if dtype == torch.float32:
            k3_err = max(k3_err, err)
            k4_err = max(k4_err, abs(got - want))
        n += 2
    return n, k3_err, k4_err, smem


def limit_cut(topo, rate_cats, states, dtype):
    """The schedule of the largest cut of ``topo`` whose K3/K4 layout
    (per-rate counters, the largest) fits one block's ``SMEM_LIMIT``."""
    from libpll_tpu_torch.ops import clv_seg as cseg
    from libpll_tpu_torch.utils.constants import SCALE_PER_RATE

    ensure = [topo.parent_clv, topo.child_clv]
    for max_rows in range(2 * topo.schedule.tips, 2, -1):
        seg = cseg.build_segmented_schedule(topo.schedule, max_rows=max_rows,
                                            ensure_rows=ensure)
        kw = dict(rate_cats=rate_cats, states=states)
        kernels = (cseg.make_segmented_sweep(seg, SCALE_PER_RATE, **kw),
                   cseg.make_segmented_score(
                       seg, *ensure, topo.edge_matrix, SCALE_PER_RATE, **kw))
        if max(k.smem(dtype) for k in kernels) <= cseg.SMEM_LIMIT:
            return seg
    fail(f"no cut of a {topo.schedule.tips}-taxon tree fits a block")


def check_seg_small(device):
    """Phase 12: K3 and K4 against their plain versions, CLV tips: every
    scale mode, float32/float64, C in {1, 2, 4, 8}, S in {4, 20}, one
    segment and many (cut at the row budget where it is smaller), a deep
    caterpillar that scales; segments cut as large as a block's shared
    memory holds (``limit_cut``); an odd site count (tip rows not 16-byte
    aligned); one launch per segment (``split``).  Returns
    (configurations checked, largest float32 K3 CLV abs error, largest
    float32 K4 |d logL|, the largest layout checked in bytes)."""
    import torch

    from libpll_tpu_torch.ops import clv_seg as cseg
    from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                                  SCALE_PER_SITE)

    rng = np.random.default_rng(3)
    # (label, newick, states, rate categories, row budget; None: one
    # segment, "limit": limit_cut), dtypes, sites; 1000 sites leave a
    # ragged last tile of 8, 1001 one of 9 and rows that are not 16-byte
    # aligned.  Every scale mode, but the 256-taxon protein tree underflows
    # float32 unscaled
    both = (torch.float32, torch.float64)
    scaled = (SCALE_PER_SITE, SCALE_PER_RATE)
    trees = [("random10", random_newick(10, rng), 4, (4,), None, both, 1000),
             ("random16/8rows", random_newick(16, rng), 4, (4,), 8, both,
              1000),
             ("caterpillar48/12rows", caterpillar_newick(48), 4, (4,), 12,
              both, 1000),
             ("random12/6rows", random_newick(12, rng), 4, (1, 2, 8), 6,
              both, 1000),
             ("protein12/6rows", random_newick(12, rng), 20, (1, 2, 4, 8),
              6, both, 1000),
             ("protein64/limit", random_newick(64, rng), 20, (8,), "limit",
              (torch.float64,), 1000),
             ("protein256/limit", random_newick(256, rng), 20, (8,), "limit",
              (torch.float32,), 1000),
             ("random16/8rows/1001", random_newick(16, rng), 4, (4,), 8,
              both, 1001)]
    n, k3_err, k4_err, smem = 0, 0.0, 0.0, 0
    for label, newick, states, cats, max_rows, dtypes, sites in trees:
        for rate_cats in cats:
            topo, model_np, masks = small_case(newick, sites, rate_cats,
                                               seed=rate_cats, states=states)
            for dtype in dtypes:
                if max_rows == "limit":
                    seg = limit_cut(topo, rate_cats, states, dtype)
                else:
                    budget = cseg.seg_max_rows(rate_cats, states, dtype)
                    seg = cseg.build_segmented_schedule(
                        topo.schedule, max_rows=(1 << 20 if max_rows is None
                                                 else min(max_rows, budget)),
                        ensure_rows=[topo.parent_clv, topo.child_clv])
                    check((max_rows is None) == (len(seg.segments) == 1),
                          f"{label}: {len(seg.segments)} segments")
                got = seg_pair(device, topo, model_np, masks, seg, rate_cats,
                               states, dtype,
                               f"{label} S={states} C={rate_cats} {dtype}",
                               scaled if label == "protein256/limit"
                               else (SCALE_NONE,) + scaled,
                               split=label == "random16/8rows"
                               and dtype == torch.float64)
                n += got[0]
                k3_err, k4_err = max(k3_err, got[1]), max(k4_err, got[2])
                smem = max(smem, got[3])
    return n, k3_err, k4_err, smem


README_TIPS, README_SITES = 1024, 32768  # README "Performance": segmented
F64_CHUNK = 64  # inner rows per step of the float64 deviation
# K3's float32 rows against the float64 level sweep, relative to each
# (node, site) block's largest value.  Not F32_RTOL: that rule holds float32
# against float32, while here float32 rounding of the P-matrices and of
# every contraction and product below a row adds up over the README tree's
# 1 022 inner nodes (1.85e-5 measured on an H100, 1.6e-5 on a CPU at 256
# sites).  A wrong row or a missed scaling event is off by O(1).
F32_VS_F64_RTOL = 1e-4


def f64_deviation(seg, inner, scal, clv64, scal64):
    """Largest |K3 - float64 level sweep| relative to each (node, site)
    block's largest value, the float64 rows carried into K3's scaling
    units (exact powers of two)."""
    import torch

    tips, worst = seg.tips, 0.0
    for r0 in range(0, seg.n_inner, F64_CHUNK):
        lm = range(r0, min(r0 + F64_CHUNK, seg.n_inner))
        idx = torch.as_tensor([seg.inner_row(r) for r in lm],
                              device=inner.device)
        got = inner[idx].double()
        shift = (32 * scal[idx].long() - 256 * scal64[r0:lm.stop].long())
        want = torch.ldexp(clv64[tips + r0:tips + lm.stop],
                           shift[:, None, None, :].double())
        span = want.abs().amax(dim=(1, 2), keepdim=True)
        worst = max(worst, float(((got - want).abs() / span).max()))
    return worst


def phase_readme(device, peak):
    """Phase 13: the README's segmented configuration, 1 024 taxa x 32 768
    sites, GTR+Γ4, float32, per-site scaling, CLV tips, seed 0, cut at
    ``seg_max_rows``.  K4 (``make_segmented_score``) and K3
    (``make_segmented_sweep``) are the main path, each with its counter at
    0 (one launch per call) and its device memory peak; K4's logL, and the
    edge logL of K3's
    rows, are held to the plain float64 ``make_forward`` within the f32
    budget; K3 to its plain version (scalers at >= 99.9%, CLVs at rtol 1e-5
    where they agree) and K4 to its plain version within the budget; K3's
    rows to the float64 level sweep within ``F32_VS_F64_RTOL``."""
    import torch

    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import clv_seg as cseg
    from libpll_tpu_torch.ops.sweep import make_level_sweep
    from libpll_tpu_torch.utils.constants import SCALE_PER_SITE
    from libpll_tpu_torch.utils.flagship import (build_flagship_topology,
                                                 draw_tipchars_cuda)

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    topo, model_np = build_flagship_topology(README_TIPS, README_SITES,
                                             seed=0)
    tp = draw_tipchars_cuda(README_TIPS, README_SITES, 0, device)
    tip_rows = torch.arange(README_TIPS, device=device)
    max_rows = cseg.seg_max_rows(4, 4, torch.float32)
    seg = cseg.build_segmented_schedule(
        topo.schedule, max_rows=max_rows,
        ensure_rows=[topo.parent_clv, topo.child_clv])
    slabs = cseg.pack_tips_segmented(
        cf.decode_tips(tp, "chars", tip_rows, 4, 4, torch.float32), seg)
    m32 = model_from_numpy(model_np, device, torch.float32)
    pm, wvec, pw, _ = kernel_inputs(topo, model_np, torch.float32, device,
                                    False)
    score = cseg.make_segmented_score(
        seg, topo.parent_clv, topo.child_clv, topo.edge_matrix,
        SCALE_PER_SITE, rate_cats=4, states=4)
    sweep = cseg.make_segmented_sweep(seg, SCALE_PER_SITE, rate_cats=4,
                                      states=4)
    setup_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cseg.SegmentedScore.launches = 0
    logl = float(score(slabs, pm, wvec, pw))
    torch.cuda.synchronize()
    k4_launches = cseg.SegmentedScore.launches
    k4_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cseg.SegmentedSweep.launches = 0
    inner, scal = sweep(slabs, pm)
    torch.cuda.synchronize()
    k3_launches = cseg.SegmentedSweep.launches
    k3_peak = torch.cuda.max_memory_allocated()
    check(k4_launches == 1 and k3_launches == 1,
          f"README config: launches K4 {k4_launches}, K3 {k3_launches}; "
          f"want one per call")
    check(k4_peak < k3_peak, f"K4 peak {k4_peak} B not below K3's {k3_peak}")

    m64 = model_from_numpy(model_np, device, torch.float64)
    want = plain_forward_f64(topo, tp, "chars", m64, 4)[0]
    torch.cuda.empty_cache()
    budget = ACC_REL * abs(want) + ACC_ABS
    k3_logl = sweep_logl(topo, seg, inner, scal, tp, m32, pm)
    check(np.isfinite(logl) and abs(logl - want) <= budget,
          f"README K4 logL {logl} vs plain f64 {want}")
    check(abs(k3_logl - want) <= budget,
          f"README K3 logL {k3_logl} vs plain f64 {want}")
    ok, k3_err, agree = sweep_close(inner, scal, *sweep.plain(slabs, pm),
                                    torch.float32)
    check(ok, f"README K3 vs plain: max abs err {k3_err}, scalers agree "
              f"{agree}")
    k4_err = abs(logl - float(score.plain(slabs, pm, wvec, pw)))
    check(k4_err <= budget, f"README K4 vs plain: |d logL| {k4_err}")
    torch.cuda.empty_cache()

    sched = topo.schedule
    clv64 = torch.cat([
        cf.decode_tips(tp, "chars", tip_rows, 4, 4, torch.float64),
        torch.zeros((sched.n_inner, 4, 4, README_SITES), dtype=torch.float64,
                    device=device)])
    pm64 = kernel_inputs(topo, model_np, torch.float64, device, False)[0]
    clv64, scal64 = make_level_sweep(sched, SCALE_PER_SITE)(
        clv64, torch.zeros((sched.n_inner + 1, README_SITES),
                           dtype=torch.int32, device=device), pm64)
    deviation = f64_deviation(seg, inner, scal, clv64, scal64)
    check(deviation <= F32_VS_F64_RTOL,
          f"README K3 rows vs the f64 level sweep: deviation {deviation}")
    del clv64, scal64, inner, scal
    torch.cuda.empty_cache()

    ms = {"k4": time_ms(lambda: score(slabs, pm, wvec, pw))[0],
          "k4_plain": time_ms(lambda: score.plain(slabs, pm, wvec, pw),
                              PLAIN_ITERS, 1)[0],
          "k3": time_ms(lambda: sweep(slabs, pm))[0],
          "k3_plain": time_ms(lambda: sweep.plain(slabs, pm),
                              PLAIN_ITERS, 1)[0]}
    host = {"k4": host_ms(lambda: score(slabs, pm, wvec, pw)),
            "k3": host_ms(lambda: sweep(slabs, pm))}
    smem = score.smem(torch.float32)
    per_sm = cseg.blocks_per_sm(4, torch.float32, 4, smem)
    cs_bytes = 4 * 4 * 4 * README_SITES  # one float32 row
    tip_bytes = README_TIPS * cs_bytes
    k3_bytes = tip_bytes + sched.n_inner * (cs_bytes + 4 * README_SITES)
    local = max(s.n_local for s in seg.segments)
    print(f"[13 seg README] {README_TIPS} taxa x {README_SITES} sites x 4 "
          f"rates f32 CLV tips, per-site scaling: {len(seg.segments)} "
          f"segments (max_rows {max_rows}, at most {local} local rows, "
          f"{max(g.r_tip for g in score.rows)} tip rows); a block of "
          f"{cseg.SLOT_SITES} sites "
          f"x 4 rates walks them all: pool of {score.pool} slots (K3 "
          f"{sweep.pool}), {smem} B of shared memory per block of the "
          f"card's {cseg.max_smem(4, torch.float32)}, {per_sm} blocks per "
          f"SM; set-up {setup_s:.2f} s); K4 make_segmented_score {logl!r}, "
          f"K3 rows' edge logL {k3_logl!r}, plain f64 make_forward "
          f"{want:.6f} (|d| {abs(logl - want):.3e}, "
          f"{abs(k3_logl - want):.3e} <= {budget:.3e}); K3 vs plain max abs "
          f"{k3_err:.3e}, scalers agree {agree:.6f}; K4 vs plain |d logL| "
          f"{k4_err:.3e}; K3 rows vs the f64 level sweep: largest deviation "
          f"{deviation:.3e} of a block's maximum (<= {F32_VS_F64_RTOL:.0e}); "
          f"launches K4 {k4_launches}, "
          f"K3 {k3_launches}; peak device memory K4 "
          f"{k4_peak / 2**30:.2f} GiB < K3 {k3_peak / 2**30:.2f} GiB",
          flush=True)
    print(f"[13 seg README times] K4 {ms['k4']:.4f} ms vs plain "
          f"{ms['k4_plain']:.2f} ms; K3 {ms['k3']:.4f} ms vs plain "
          f"{ms['k3_plain']:.2f} ms; host time of one call with the card "
          f"idle: K4 {host['k4']:.4f} ms, K3 {host['k3']:.4f} ms; K4 reads "
          f"{tip_bytes / 1e9:.2f} GB of "
          f"tips: {tip_bytes / ms['k4'] / 1e9:.3f} TB/s; K3 moves "
          f"{k3_bytes / 1e9:.2f} GB (tips in, rows and counters out): "
          f"{k3_bytes / ms['k3'] / 1e9:.3f} TB/s; CUDA events", flush=True)
    flop = 2 * sched.n_inner * README_SITES * 4 * CONTRACT_FLOP
    return dict(k3_launches=k3_launches, k4_launches=k4_launches,
                k3_err=k3_err, k4_err=k4_err, ms=ms,
                n_inner=sched.n_inner, k3_bound=bound(flop, k3_bytes, peak),
                k4_bound=bound(flop, tip_bytes, peak))


# --------------------------------------------------------------- roofline
PROBE_K = (1, 16)  # chain lengths at which the probes meet their plain
PROBE_REL = 1e-5


def check_roofline_small(device):
    """K7 and K8 against their plain versions at small chain lengths, at
    the width that fills the card's SMs, each value within rel 1e-5.
    Returns the largest (abs, rel) error of K7 and of K8."""
    import torch

    from libpll_tpu_torch.ops import roofline as rf

    w = rf.probe_width(
        torch.cuda.get_device_properties(device).multi_processor_count)
    x = rf.fma_input(w, device)
    rx, coeff = rf.roll_inputs(w, device)
    errs = [(0.0, 0.0), (0.0, 0.0)]
    for k in PROBE_K:
        for i, (got, want) in enumerate((
                (rf.fma_chain(x, k), rf.fma_chain_plain(x, k)),
                (rf.roll_contract(rx, coeff, k),
                 rf.roll_contract_plain(rx, coeff, k)))):
            diff = (got - want).abs()
            rel = float((diff / want.abs()).max())
            check(rel <= PROBE_REL, f"K{7 + i} at k={k}: rel err {rel}")
            errs[i] = (max(errs[i][0], float(diff.max())),
                       max(errs[i][1], rel))
    return errs[0], errs[1]


def phase_roofline(device, card, k1_ms, k3_ms, n_inner_k3):
    """Phase 14: K7 and K8 against their plain versions at small k, then
    their sustained rates (the main path of the probes, counters at 0),
    the FP32 peak share, and the contraction rates K1 (flagship) and K3
    (README configuration) imply."""
    import torch

    from libpll_tpu_torch.ops import roofline as rf
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_RATE_CATS,
                                                 FLAGSHIP_SITES,
                                                 FLAGSHIP_TIPS)

    (k7_abs, k7_err), (k8_abs, k8_err) = check_roofline_small(device)
    w = rf.probe_width(
        torch.cuda.get_device_properties(device).multi_processor_count)
    x = rf.fma_input(w, device)
    rx, coeff = rf.roll_inputs(w, device)
    k = PROBE_K[-1]
    ms = {"k7": time_ms(lambda: rf.fma_chain(x, k))[0],
          "k7_plain": time_ms(lambda: rf.fma_chain_plain(x, k))[0],
          "k8": time_ms(lambda: rf.roll_contract(rx, coeff, k))[0],
          "k8_plain": time_ms(lambda: rf.roll_contract_plain(rx, coeff,
                                                             k))[0]}
    rf.fma_chain.launches = 0
    rf.roll_contract.launches = 0
    m = rf.measure(device)
    launches = {"k7": rf.fma_chain.launches, "k8": rf.roll_contract.launches}
    check(all(v > 0 for v in launches.values()),
          f"the roofline probes launched no kernel: {launches}")
    print(f"[14 roofline] {card}: {m['sm_count']} SMs, max SM clock "
          f"{m['max_clock_mhz']:.0f} MHz, FP32 peak {m['peak'] / 1e12:.2f} "
          f"Tflop/s; K7 vs plain at k in {PROBE_K}: rel err {k7_err:.2e}, "
          f"K8 {k8_err:.2e}; K7 multiply-add sustained "
          f"{m['fma'] / 1e12:.3f} Tflop/s ({m['fma'] / m['peak'] * 100:.1f}% "
          f"of the peak), K8 DNA contraction sustained "
          f"{m['roll'] / 1e12:.3f} Tflop/s ({m['roll'] / m['fma'] * 100:.1f}%"
          f" of K7), [16, {512 * m['width']}] tiles, chain pairs by CUDA "
          f"events; at k={k}: K7 {ms['k7']:.4f} ms vs plain "
          f"{ms['k7_plain']:.4f} ms, K8 {ms['k8']:.4f} ms vs plain "
          f"{ms['k8_plain']:.4f} ms", flush=True)

    # every child of every op and the edge's child is contracted:
    # (2S - 1)·S flop per rate and site (the script's count, :169-172)
    per = (2 * 4 - 1) * 4
    k1_flop = (2 * (FLAGSHIP_TIPS - 2) + 1) * FLAGSHIP_SITES * \
        FLAGSHIP_RATE_CATS * per
    k3_flop = 2 * n_inner_k3 * README_SITES * 4 * per
    for name, flop, t in (("K1 at the flagship", k1_flop, k1_ms),
                          ("K3 at the README configuration", k3_flop,
                           k3_ms)):
        rate = flop / (t * 1e-3)
        print(f"[14 roofline] {name}: {flop / 1e9:.3f} Gflop of "
              f"contraction in {t:.4f} ms = {rate / 1e12:.3f} Tflop/s, "
              f"{rate / m['roll'] * 100:.2f}% of K8's rate, "
              f"{rate / m['peak'] * 100:.2f}% of the FP32 peak", flush=True)
    return dict(launches=launches, k7_err=k7_abs, k8_err=k8_abs, ms=ms,
                k7_bound=bound(rf.fma_flops(x) * k, 2 * x.numel() * 4,
                               m["peak"]),
                k8_bound=bound(rf.roll_flops(rx) * k,
                               (2 * rx.numel() + coeff.numel()) * 4,
                               m["peak"]))


# ------------------------------------------------------------ train step
F32_T_REL = 1e-5  # float32 t*: see check_newton_small
NEWTON_SITES = 300
NEWTON_VARIANTS = ("site", "rate", "pinv", "lewis", "felsenstein",
                   "stamatakis")


def newton_flop(rate_cats, states):
    """Operations of one N1 body per site: three dots of C·S (an FMA each,
    2 flop), the rate mixing (three FMAs a rate), and the site's
    quotients, products and weighted sums (10)."""
    return rate_cats * states * 6 + rate_cats * 6 + 10


def sumtable_flop(rate_cats, states):
    """Operations of forming one site's sumtable column from the edge's
    rows, once a solve: two dots of S a state and rate, and their
    product."""
    return rate_cats * states * (4 * states + 1)


def newton_inputs(variant, newick, rate_cats, states, dtype, device, seed,
                  rows=False):
    """N1's arguments on the card, as ``make_train_step`` makes them, for
    one variant of ``small_case``: per-site scaling (``site``), per-rate
    (``rate``), +I with invariant sites (``pinv``), or an asc mode with its
    S pseudo columns (p-inv 0), per-site scalers 0/1 set on those columns
    so that their factors count.  ``rows``: (``newton_solve``'s arguments,
    ``newton_solve_rows``'s)."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.utils.constants import SCALE_PER_RATE

    topo, model_np, masks = small_case(newick, NEWTON_SITES, rate_cats, seed,
                                       states=states)
    asc = {"lewis": 1, "felsenstein": 2, "stamatakis": 3}.get(variant, 0)
    model_np = dict(model_np)
    if variant != "pinv":
        model_np["prop_invar"] = np.zeros(1)
        model_np["prop_invar_pc"] = np.zeros(rate_cats)
    if asc:
        rng = np.random.default_rng(seed)
        codes = np.uint32(1) << np.arange(states, dtype=np.uint32)
        masks = np.concatenate(
            [masks, np.broadcast_to(codes, (masks.shape[0], states))], 1)
        model_np["pattern_weights"] = np.concatenate(
            [model_np["pattern_weights"], rng.uniform(1.0, 4.0, states)])
        model_np["invariant"] = np.full(NEWTON_SITES + states, -1, np.int32)
    topo = topo._replace(asc_mode=asc, scale_mode=(
        SCALE_PER_RATE if variant == "rate" else topo.scale_mode))
    sched, sites = topo.schedule, masks.shape[1]
    clv = torch.zeros((sched.tips + sched.n_inner, rate_cats, states, sites),
                      dtype=dtype, device=device)
    clv[:sched.tips] = tip_input(masks, "clv", rate_cats, dtype, device,
                                 states)
    sshape = ((sched.n_inner + 1, rate_cats, sites) if variant == "rate"
              else (sched.n_inner + 1, sites))
    scal = torch.zeros(sshape, dtype=torch.int32, device=device)
    step = ev.make_train_step(topo, device=device)
    model = model_from_numpy(model_np, device, dtype)
    row_args = step.newton_rows(model, clv, scal)[3]
    if asc and variant != "rate":
        parent = row_args["site_scalers"][0].clone()
        parent[NEWTON_SITES::2] += 1
        row_args["site_scalers"] = (parent, row_args["site_scalers"][1])
    args = dv.sumtable_args(row_args)
    return (args, row_args) if rows else args


def newton_abs_sums(args, t):
    """Σ|w·(−L'/L)| and Σ|w·((L'/L)² − L''/L)| over the sites d1 and d2
    add up at ``t``, plus nothing for the pseudo-site terms (the caller
    adds |d|): the size of the sums whose round-off a comparison allows."""
    import torch

    from libpll_tpu_torch.ops import derivatives as dv

    st = args["sumtable"]
    ki = args["rates"] / (1.0 - args["prop_invar"])
    lam = args["eigenvals_pc"] * ki[:, None]
    e = torch.exp(lam * t)
    cat = torch.matmul(torch.stack([e, lam * e, lam * lam * e], 1),
                       st).transpose(0, 1)
    ef = args["sites"] + (st.shape[1] if args["asc_mode"] == 3 else 0)
    lk0, lk1, lk2 = dv._mixed(cat[:, :, :ef], args["prop_invar"],
                              args["freqs_pc"], args["rate_weights"],
                              args["invariant"][:ef])
    w = args["pattern_weights"][:ef]
    d1 = -lk1 / lk0
    return (float((w * d1).abs().sum()),
            float((w * (d1 * d1 - lk2 / lk0)).abs().sum()))


def newton_close(args, dtype, rows=None):
    """N1 against its plain twin on the same inputs.  One body: d1 and d2
    at t0 within REL of the size of their sums (float64 1e-12: summation
    order; float32 1e-5: the twin sums float32 terms in float32, N1 in
    float64).  The whole loop: float64 t* rel 1e-10 with the same number
    of bodies; float32 t* within F32_T_REL (d1's rounding floor over d2
    moves t* far less).  With ``rows`` (``newton_solve_rows``'s arguments
    for the same edge), N1 runs from the rows and the twin from
    ``args``' sumtable (``update_sumtable``'s).  Returns (ok, |t* - plain
    t*|, message)."""
    import torch

    from libpll_tpu_torch.ops import derivatives as dv

    def run(**kw):
        if rows is None:
            return dv.newton_solve(**args, **kw)
        return dv.newton_solve_rows(**rows, **kw)

    f64 = dtype == torch.float64
    rel = 1e-12 if f64 else 1e-5
    one = run(max_iters=1)
    d1, d2 = dv.likelihood_derivatives(
        **{k: v for k, v in args.items() if k != "t0"},
        branch_length=args["t0"][0])
    sizes = newton_abs_sums(args, args["t0"][0])
    errs = [abs(float(g) - float(w)) for g, w in ((one.d1, d1),
                                                  (one.d2, d2))]
    ok = all(np.isfinite(float(w)) and e <= rel * (size + abs(float(w)))
             for e, w, size in zip(errs, (d1, d2), sizes))
    got = run()
    want = dv.newton_solve_plain(**args)
    t_err = abs(float(got.t) - float(want.t))
    if f64:
        ok = ok and t_err <= 1e-10 * abs(float(want.t)) and int(
            got.iterations) == int(want.iterations)
    else:
        ok = ok and t_err <= F32_T_REL * abs(float(want.t))
    return ok, t_err, (f"d1 {float(one.d1)!r} vs {float(d1)!r}, d2 "
                       f"{float(one.d2)!r} vs {float(d2)!r}; t* "
                       f"{float(got.t)!r} ({int(got.iterations)} bodies) "
                       f"vs {float(want.t)!r} ({int(want.iterations)})")


def plan_text(plan):
    """N1's launch plan in a few words."""
    return (f"{'resident' if plan.resident else 'streamed'}, {plan.grid} "
            f"blocks of {plan.threads} threads x {plan.block_sites} sites, "
            f"{plan.smem} B shared memory")


def check_newton_small(device):
    """Phase 15: N1 against its plain twin on the card (``newton_close``)
    at every variant (per-site and per-rate scaling, +I with invariant
    sites, each asc mode), float32 and float64, S in {4, 20}, C in {1, 4,
    8}, on a 48-taxon caterpillar (float32 scaling fires).  Returns
    (configurations, largest float32 |d t*|, {case: "R" resident or "S"
    streamed, by variant}).  Each configuration runs N1 from the sumtable
    (``newton_solve``) and from the edge's rows (``newton_solve_rows``:
    the sumtable formed in N1's prologue where resident, outside Lewis
    and Felsenstein)."""
    import torch

    from libpll_tpu_torch.ops import derivatives as dv

    n, f32_err, paths = 0, 0.0, {}
    newick = caterpillar_newick(48)
    for states in (4, 20):
        for rate_cats in (1, 4, 8):
            for dtype in (torch.float32, torch.float64):
                case = f"S{states}C{rate_cats}f{dtype.itemsize * 8}"
                paths[case] = ""
                for variant in NEWTON_VARIANTS:
                    args, rows = newton_inputs(variant, newick, rate_cats,
                                               states, dtype, device,
                                               seed=rate_cats, rows=True)
                    plan = dv.plan_for(args["sumtable"], args["sites"],
                                       args["asc_mode"])
                    for form in (None, rows):
                        ok, err, msg = newton_close(args, dtype, form)
                        check(ok, f"N1 {variant} S={states} C={rate_cats} "
                                  f"{dtype} ({plan_text(plan)}; from "
                                  f"{'rows' if form else 'sumtable'}): "
                                  f"{msg}")
                        if dtype == torch.float32:
                            f32_err = max(f32_err, err)
                    paths[case] += "R" if plan.resident else "S"
                    n += 1
    return n, f32_err, paths


def phase_train_step(device, card, peak):
    """Phases 16-17: the flagship through ``make_train_step_fused`` (the
    main path of the training step, counters at 0 around one call), its
    checks, the step as a CUDA graph, and the times.  Returns the numbers
    the JSON line reports."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_RATE_CATS,
                                                 FLAGSHIP_SITES,
                                                 FLAGSHIP_STATES,
                                                 FLAGSHIP_TIPS,
                                                 build_flagship)

    tips, sites = FLAGSHIP_TIPS, FLAGSHIP_SITES
    c, s = FLAGSHIP_RATE_CATS, FLAGSHIP_STATES
    t0 = time.perf_counter()
    topo, model_np, masks, _ = build_flagship(tips, sites, rate_cats=c,
                                              seed=0, tip_masks=True,
                                              simulate=True)
    sim_s = time.perf_counter() - t0
    tp = cf.pack_tipchars(masks).to(device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    step = ev.make_train_step_fused(topo, c, s, tip_encoding="chars",
                                    device=device)
    fwd = ev.make_forward_fused(topo, c, s, tip_encoding="chars",
                                device=device)
    score = ev.make_score(topo, c, s, tip_encoding="chars", device=device)

    torch.cuda.synchronize()
    cf.fused_sweep.launches = 0
    cf.fused_edge_score.launches = 0
    dv.newton_solve.launches = 0
    logl, t_star = step(m32, tp)
    torch.cuda.synchronize()
    launches = {"fused_sweep": cf.fused_sweep.launches,
                "newton_solve": dv.newton_solve.launches,
                "fused_edge_score": cf.fused_edge_score.launches}
    check(launches["fused_sweep"] == 1 and launches["fused_edge_score"] == 0
          and launches["newton_solve"] == 1,
          f"train step: launches {launches}, want K2 and N1 once each")
    logl, t_star = float(logl), float(t_star)
    again = step(m32, tp)
    check((float(again[0]), float(again[1])) == (logl, t_star),
          f"two eager steps differ: {(logl, t_star)} then "
          f"{tuple(float(v) for v in again)}")
    check(dv.MIN_T < t_star < dv.MAX_T,
          f"t* {t_star!r} on the clamp [{dv.MIN_T}, {dv.MAX_T}]")
    fused_logl = float(fwd(m32, tp)[0])
    check(fused_logl == logl, f"the step's logL {logl!r} is not "
                              f"make_forward_fused's {fused_logl!r}")

    budget = ACC_REL * abs(logl) + ACC_ABS
    at_t0 = float(score(m32, tp))
    m_opt = dict(m32, branch_lengths=m32["branch_lengths"].clone())
    m_opt["branch_lengths"][-1] = t_star
    at_opt = float(score(m_opt, tp))
    check(at_opt >= at_t0 - budget,
          f"make_score at t* {at_opt!r} below make_score at t0 {at_t0!r} "
          f"less the budget {budget}")

    # the float64 make_train_step on the card, from the same tips
    sched = topo.schedule
    m64 = model_from_numpy(model_np, device, torch.float64)
    clv64 = torch.zeros((sched.tips + sched.n_inner, c, s, sites),
                        dtype=torch.float64, device=device)
    clv64[:sched.tips] = cf.decode_tips(
        tp, "chars", torch.arange(sched.tips, device=device), c, s,
        torch.float64)
    scal = torch.zeros((sched.n_inner + 1, sites), dtype=torch.int32,
                       device=device)
    step64 = ev.make_train_step(topo, device=device)
    logl64, _, _, args64 = step64.newton_inputs(m64, clv64, scal)
    logl64 = float(logl64)
    t64 = float(dv.newton_solve(**args64).t)
    plan64 = dv.plan_for(args64["sumtable"], args64["sites"],
                         args64["asc_mode"])
    check(not plan64.resident, f"float64 flagship N1: {plan_text(plan64)}, "
                               f"want streamed")
    ok, _, msg64 = newton_close(args64, torch.float64)
    check(ok, f"float64 flagship N1 (streamed) vs plain: {msg64}")
    del clv64, scal, args64
    torch.cuda.empty_cache()
    check(abs(t_star - t64) <= F32_T_REL * t64,
          f"float32 t* {t_star!r} vs float64 make_train_step t* {t64!r}")
    check(abs(logl - logl64) <= budget,
          f"float32 step logL {logl!r} vs float64 {logl64!r}")

    # N1 against its plain twin at the main path's shapes: from the
    # sumtable, and from the rows as the step runs it
    args = step.newton_inputs(m32, tp)[1]
    rows = step.newton_rows(m32, tp)[1]
    ok, _, msg_st = newton_close(args, torch.float32)
    check(ok, f"flagship N1 (from the sumtable) vs plain: {msg_st}")
    ok, n1_err, msg = newton_close(args, torch.float32, rows)
    check(ok, f"flagship N1 (from the rows) vs plain: {msg}")
    n1 = dv.newton_solve_rows(**rows)
    iters = int(n1.iterations)
    check(float(n1.t) == t_star, f"N1 from the rows {float(n1.t)!r} is not "
                                 f"the step's t* {t_star!r}")
    n1_again = dv.newton_solve_rows(**rows)
    check(all(float(x) == float(y) for x, y in zip(n1, n1_again)),
          f"two N1 calls differ: {tuple(map(float, n1))} then "
          f"{tuple(map(float, n1_again))}")
    plan = dv.plan_for(args["sumtable"], args["sites"], args["asc_mode"])
    print(f"[16 train step] {tips} taxa x {sites} sites x {c} rates f32 "
          f"chars, tips simulated on the tree ({sim_s:.1f} s): logL "
          f"{logl!r} (make_forward_fused's, bit for bit; float64 "
          f"make_train_step {logl64!r}, |d| {abs(logl - logl64):.3e} <= "
          f"{budget:.3e}); t0 {float(m32['branch_lengths'][-1])!r} -> t* "
          f"{t_star!r} (float64 t* {t64!r}, rel "
          f"{abs(t_star - t64) / t64:.3e} <= {F32_T_REL}); make_score at t0 "
          f"{at_t0!r}, at t* {at_opt!r}; launches {launches}; N1 {iters} "
          f"bodies ({plan_text(plan)}), two calls equal; two eager steps "
          f"equal; N1 from the rows vs plain: {msg}; from the sumtable: "
          f"{msg_st}; float64 N1 ({plan_text(plan64)}) vs plain: {msg64}",
          flush=True)

    # one step captured in a CUDA graph: the capture fails on a host sync
    graphed = step.graphed(m32, tp)
    g_logl, g_t = (float(v) for v in graphed(m32, tp))
    check((g_logl, g_t) == (logl, t_star),
          f"train step as a CUDA graph {(g_logl, g_t)} vs eager "
          f"{(logl, t_star)}")

    runs = {"step": lambda: step(m32, tp),
            "step_graph": lambda: graphed(m32, tp)}
    timed = {name: time_ms(fn) for name, fn in runs.items()}
    ms = {name: dev for name, (dev, _) in timed.items()}
    # N1 alone as a graph: its wrapper's host time exceeds the kernel's
    ms["n1"] = graph_ms(lambda: dv.newton_solve_rows(**rows))
    ms["n1_sumtable"] = graph_ms(lambda: dv.newton_solve(**args))
    idle = {name: host_ms(runs[name]) for name in ("step", "step_graph")}
    ms["n1_plain"] = time_ms(
        lambda: dv.newton_solve_plain(**dv.sumtable_args(rows)), iters=3,
        warmup=1)[0]
    n1_bound = bound((newton_flop(c, s) * iters + sumtable_flop(c, s))
                     * sites, (2 * c * s * sites + 2 * sites) * 4, peak)
    print(f"[17 train times] {card}: make_train_step_fused "
          f"{ms['step']:.4f} ms/step eager (host issues a call in "
          f"{timed['step'][1]:.4f} ms; {idle['step']:.4f} ms with the card "
          f"idle), {ms['step_graph']:.4f} ms/step as a CUDA graph (host "
          f"{idle['step_graph']:.4f} ms with the card idle; equal to the "
          f"eager step bit for bit); N1 from the rows {ms['n1']:.4f} ms "
          f"for {iters} bodies in one launch "
          f"({ms['n1'] / iters * 1e3:.3f} us a body; {plan_text(plan)}, "
          f"{dv.blocks_per_sm(plan, torch.float32, s)} blocks an SM fit), "
          f"bound {n1_bound[0]:.4f} ms ({n1_bound[1]}, "
          f"{n1_bound[0] / ms['n1'] * 100:.1f}% of it), plain "
          f"(update_sumtable and the plain twin) {ms['n1_plain']:.4f} ms; "
          f"from the sumtable {ms['n1_sumtable']:.4f} ms (N1 times: the "
          f"call captured in a CUDA graph); CUDA events",
          flush=True)
    return dict(launches=launches["newton_solve"], n1_err=n1_err, ms=ms,
                n1_bound=n1_bound)



PROTEIN_FLOP = 2 * 2 * 20 * 20  # per inner node, rate and site: two children


def protein_layouts():
    """Which (rate count, dtype, pool) combinations of the protein K1/K2
    fit a block's shared memory under per-site scaling (pools of 3 slots:
    the 64-taxon walk; 6: 1 000 taxa; up to 10): {(C, dtype, pool):
    (K1 blocks per SM or 0, K2's)}."""
    import ctypes

    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.utils.constants import SCALE_PER_SITE

    lib = cf.load_kernels()
    out = (ctypes.c_int * 7)()
    fits = {}
    for c in cf.KERNEL_RATE_CATS:
        for f64 in (0, 1):
            for pool in (3, 6, 10):
                per = []
                for score in (1, 0):
                    rc = lib.clv_fused_layout(20, f64, c, SCALE_PER_SITE,
                                              score, pool, out)
                    check(rc in (0, 1), f"protein layout query: CUDA error "
                                        f"{rc}")
                    per.append(out[1] if rc == 0 else 0)
                fits[(c, "f64" if f64 else "f32", pool)] = tuple(per)
    return fits


def phase_protein(device, card, peak):
    """Phases 18-19: the 64-taxon LG4X+Γ4 protein configuration, read
    from FASTA (``utils/flagship.build_protein_flagship``), through
    ``make_score`` (K1 at 20 states), ``make_forward_fused`` (K2) and
    ``make_train_step_fused`` (K2 + N1), each driven once with the
    counters at 0 around it; the checks, the graphs, the times.  Returns
    the numbers the JSON line reports."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.utils.constants import SCALE_PER_SITE
    from libpll_tpu_torch.utils.flagship import (PROTEIN_RATE_CATS,
                                                 PROTEIN_SITES,
                                                 PROTEIN_STATES,
                                                 PROTEIN_TIPS,
                                                 build_protein_flagship)

    tips, columns = PROTEIN_TIPS, PROTEIN_SITES
    c, s = PROTEIN_RATE_CATS, PROTEIN_STATES
    t0 = time.perf_counter()
    topo, model_np, masks = build_protein_flagship(tips, columns, seed=0)
    build_s = time.perf_counter() - t0
    sites, sched = masks.shape[1], topo.schedule
    multi = float(((masks & (masks - 1)) != 0).mean())  # several bits
    tp = torch.from_numpy(masks).to(device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    m64 = model_from_numpy(model_np, device, torch.float64)
    kw = dict(tip_encoding="masks", device=device)
    score = ev.make_score(topo, c, s, **kw)
    fwd = ev.make_forward_fused(topo, c, s, **kw)
    step = ev.make_train_step_fused(topo, c, s, **kw)
    want = plain_forward_f64(topo, tp, "masks", m64, s)[0]
    budget = ACC_REL * abs(want) + ACC_ABS

    # the main path: each entry point once, its counters at 0 around it
    runs = {"make_score": lambda: (score(m32, tp),),
            "make_forward_fused": lambda: fwd(m32, tp)[:1],
            "make_train_step_fused": lambda: step(m32, tp)}
    out, launches, peaks = {}, {}, {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cf.fused_edge_score.launches = 0
        cf.fused_sweep.launches = 0
        dv.newton_solve.launches = 0
        out[name] = tuple(float(v) for v in run())
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        launches[name] = (cf.fused_edge_score.launches,
                          cf.fused_sweep.launches, dv.newton_solve.launches)
    check(launches["make_score"] == (1, 0, 0)
          and launches["make_forward_fused"] == (0, 1, 0)
          and launches["make_train_step_fused"] == (0, 1, 1),
          f"protein main path: launches (K1, K2, N1) {launches}")
    got_score = out["make_score"][0]
    got_fwd = out["make_forward_fused"][0]
    logl, t_star = out["make_train_step_fused"]
    for name, got in (("make_score", got_score),
                      ("make_forward_fused", got_fwd)):
        check(np.isfinite(got) and abs(got - want) <= budget,
              f"protein {name} f32 logL {got} vs plain f64 {want} (budget "
              f"{budget})")
    check(logl == got_fwd, f"protein step logL {logl!r} is not "
                           f"make_forward_fused's {got_fwd!r}")
    check(dv.MIN_T < t_star < dv.MAX_T, f"protein t* {t_star!r} on the clamp")

    # "high" is computed at "highest": the same bits
    high = float(ev.make_score(topo, c, s, mxu_precision="high", **kw)(
        m32, tp))
    check(high == got_score, f"protein make_score 'high' {high!r} vs "
                             f"'highest' {got_score!r}")

    # the float64 make_train_step on the card, from the same tips
    clv64 = torch.zeros((sched.tips + sched.n_inner, c, s, sites),
                        dtype=torch.float64, device=device)
    clv64[:sched.tips] = cf.decode_tips(
        tp, "masks", torch.arange(sched.tips, device=device), c, s,
        torch.float64)
    scal = torch.zeros((sched.n_inner + 1, sites), dtype=torch.int32,
                       device=device)
    logl64, t64 = (float(v) for v in ev.make_train_step(
        topo, device=device)(m64, clv64, scal)[:2])
    del clv64, scal
    torch.cuda.empty_cache()
    check(abs(t_star - t64) <= F32_T_REL * t64,
          f"protein float32 t* {t_star!r} vs float64 t* {t64!r}")
    check(abs(logl64 - want) <= F64_REL * abs(want),
          f"protein float64 step logL {logl64!r} vs make_forward {want!r}")

    # each kernel against its plain version at the main path's shapes
    pm, wvec, pw, _ = kernel_inputs(topo, model_np, torch.float32, device,
                                    False)
    edge = dict(parent_clv=topo.parent_clv, child_clv=topo.child_clv,
                edge_matrix=topo.edge_matrix, tip_encoding="masks")
    k1 = lambda: cf.fused_edge_score(sched, tp, pm, wvec, pw,
                                     plan=score.plan, **edge)
    k1_plain = lambda: cf.fused_edge_score_plain(sched, tp, pm, wvec, pw,
                                                 **edge)
    k2 = lambda: cf.fused_sweep(sched, tp, pm, plan=fwd.plan,
                                tip_encoding="masks")
    k2_plain = lambda: cf.fused_sweep_plain(sched, tp, pm,
                                            tip_encoding="masks")
    k1_err = abs(float(k1()) - float(k1_plain()))
    check(k1_err <= budget, f"protein K1 vs plain: |d logL| {k1_err}")
    ok, k2_err, agree = sweep_close(
        *k2(), *fwd.plan.plain_walk(tp, pm, SCALE_PER_SITE), torch.float32)
    check(ok, f"protein K2 vs the plain walk: max abs err {k2_err}, "
              f"scalers agree {agree}")
    lay = {name: mod.plan.layout(torch.float32, c, s, topo.scale_mode,
                                 is_k1)
           for name, mod, is_k1 in (("K1", score, True), ("K2", fwd, False))}
    fits = protein_layouts()
    print(f"[18 protein] {tips} taxa x {columns} columns LG4X+G4 f32 masks "
          f"(FASTA round trip, compression, encoding in {build_s:.2f} s): "
          f"{sites} patterns, {multi * 100:.2f}% multi-bit masks; logL: "
          f"make_score {got_score!r}, make_forward_fused {got_fwd!r}, "
          f"make_train_step_fused {logl!r} (make_forward_fused's bits), "
          f"plain f64 make_forward {want!r} (|d| "
          f"{abs(got_score - want):.3e}, {abs(got_fwd - want):.3e} <= "
          f"{budget:.3e}); 'high' equal to 'highest' bit for bit; t0 "
          f"{float(m32['branch_lengths'][-1])!r} -> t* {t_star!r} (float64 "
          f"t* {t64!r}, rel {abs(t_star - t64) / t64:.3e} <= {F32_T_REL}); "
          f"launches (K1, K2, N1) {launches}; K1-plain |d logL| "
          f"{k1_err:.3e}; K2-plain walk max abs {k2_err:.3e}, scalers agree "
          f"{agree:.6f}; peak device memory GiB " + ", ".join(
              f"{k} {v:.4f}" for k, v in peaks.items()) + "; walk: pool "
          f"{score.plan.pool} slots (K2 {fwd.plan.pool}), " + "; ".join(
              f"{name} {v['smem']} B shared memory per block of "
              f"{v['threads']} threads x {v['block_sites']} sites, chunks of "
              f"{v['chunk']} ops, {v['blocks_per_sm']} blocks per SM"
              for name, v in lay.items()) + "; fits (K1, K2 blocks per SM; "
          "0: does not fit) by (C, dtype, pool): " + ", ".join(
              f"{k[0]}/{k[1]}/{k[2]}: {v}" for k, v in fits.items()),
          flush=True)

    graphed = {"score": score.graphed(m32, tp), "step": step.graphed(m32, tp)}
    g_score = float(graphed["score"](m32, tp))
    g_step = tuple(float(v) for v in graphed["step"](m32, tp))
    check(g_score == got_score and g_step == (logl, t_star),
          f"protein CUDA graphs {g_score!r}, {g_step} vs eager "
          f"{got_score!r}, {(logl, t_star)}")
    # N1 alone on the step's inputs (from the rows, as the step runs it),
    # against its plain twin
    n1_args = step.newton_inputs(m32, tp)[1]
    n1_rows = step.newton_rows(m32, tp)[1]
    ok, n1_err, n1_msg = newton_close(n1_args, torch.float32, n1_rows)
    check(ok, f"protein N1 vs plain: {n1_msg}")
    n1_bodies = int(dv.newton_solve_rows(**n1_rows).iterations)
    n1_plan = dv.plan_for(n1_args["sumtable"], n1_args["sites"],
                          n1_args["asc_mode"])
    timed_runs = {"score": lambda: score(m32, tp),
                  "score_graph": lambda: graphed["score"](m32, tp),

                  "forward_fused": lambda: fwd(m32, tp),
                  "step": lambda: step(m32, tp),
                  "step_graph": lambda: graphed["step"](m32, tp),
                  "k1": k1, "k1_plain": k1_plain, "k2": k2,
                  "k2_plain": k2_plain}
    ms = {name: time_ms(fn)[0] for name, fn in timed_runs.items()}
    ms["n1"] = graph_ms(lambda: dv.newton_solve_rows(**n1_rows))
    flop = sched.n_inner * sites * c * PROTEIN_FLOP
    k1_bound = bound(flop, (tp.numel() + sites) * 4, peak)
    k2_bound = bound(flop, (tp.numel() + sched.n_inner * c * s * sites
                            + (sched.n_inner + 1) * sites) * 4, peak)
    n1_bound = bound((newton_flop(c, s) * n1_bodies + sumtable_flop(c, s))
                     * sites, (2 * c * s * sites + 2 * sites) * 4, peak)
    print(f"[19 protein times] {card}: make_score (K1) {ms['score']:.4f} "
          f"ms/eval eager, {ms['score_graph']:.4f} ms/eval as a CUDA graph; "
          f"make_forward_fused (K2) {ms['forward_fused']:.4f} ms/eval; "
          f"make_train_step_fused {ms['step']:.4f} ms/step eager, "
          f"{ms['step_graph']:.4f} ms/step as a CUDA graph (graphs equal "
          f"to the eager calls bit for bit); kernel alone " + "; ".join(
              f"{name} {ms[key]:.4f} ms vs plain {ms[key + '_plain']:.4f} "
              f"ms, bound {b[0]:.4f} ms ({b[1]}), {b[0] / ms[key] * 100:.1f}% "
              f"of it, {lay[name]['blocks_per_sm']} blocks per SM of "
              f"{lay[name]['block_sites']} sites"
              for name, key, b in (("K1", "k1", k1_bound),
                                   ("K2", "k2", k2_bound)))
          + f"; {flop:.4e} flop of contraction; N1 from the rows "
          f"{ms['n1']:.4f} ms for "
          f"{n1_bodies} bodies in one launch "
          f"({ms['n1'] / n1_bodies * 1e3:.3f} us a body; "
          f"{plan_text(n1_plan)}), bound {n1_bound[0]:.4f} ms "
          f"({n1_bound[1]}; captured in a CUDA graph), vs plain: {n1_msg}; "
          f"CUDA events", flush=True)
    return dict(launches=launches, k1_err=k1_err, k2_err=k2_err, ms=ms,
                k1_bound=k1_bound, k2_bound=k2_bound, n1_err=n1_err)



# ------------------------------------------------------------ partition
PART_DERIV_REL = 1e-10  # Partition vs make_train_step derivatives, f64
# (name, keyword arguments of partition_case): every scaling mode, +I,
# the three asc modes, several rate matrices, explicit tip CLVs (tiny
# entries, so that float64 scaling fires), protein, one rate category
PARTITION_SMALL = (
    ("site", {}), ("rate", {"scaling": "rate"}),
    ("none", {"scaling": "none"}), ("pinv", {"pinv": 0.3}),
    ("pinv_rate", {"pinv": 0.2, "scaling": "rate"}),
    ("lewis", {"asc": 1}), ("felsenstein", {"asc": 2}),
    ("stamatakis", {"asc": 3}), ("lewis_rate", {"asc": 1, "scaling": "rate"}),
    ("matrices", {"rate_matrices": 3}),
    ("tip_clv", {"tip_clv": True, "tips": 24}),
    ("tip_clv_rate", {"tip_clv": True, "tips": 24, "scaling": "rate"}),
    ("protein", {"states": 20, "rate_cats": 2}),
    ("one_rate", {"rate_cats": 1}))


def partition_case(device, dtype, seed, tips=9, sites=203, states=4,
                   rate_cats=4, scaling="site", pinv=0.0, asc=None,
                   rate_matrices=1, tip_clv=False):
    """A small Partition on ``device``, every setter applied from numpy
    draws of ``seed``, its P-matrices and a full traversal computed.
    Returns (partition, tree, full ops, params_indices)."""
    from libpll_tpu_torch import Partition
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.tree import utree as ut

    rng = np.random.default_rng(seed)
    tree = ut.parse_newick_string(random_newick(tips, rng))
    part = Partition(tips, tips - 2, states, sites, rate_matrices,
                     2 * tips - 3, rate_cats, tips - 2, scaling=scaling,
                     asc_bias_alloc=asc is not None, dtype=dtype,
                     device=device)
    n_par = states * (states - 1) // 2
    for k in range(rate_matrices):
        part.set_subst_params(k, rng.uniform(0.5, 3.0, n_par))
        f = rng.uniform(0.2, 1.0, states)
        part.set_frequencies(k, f / f.sum())
    part.set_category_rates(compute_gamma_cats(0.6, rate_cats))
    w = rng.uniform(0.5, 1.0, rate_cats)
    part.set_category_weights(w / w.sum())
    part.set_pattern_weights(rng.integers(1, 4, sites))
    chars, charmap = (("ACGTRYN-", maps.pll_map_nt) if states == 4
                      else ("ARNDCQEGHILKMFPSTWYVBZX-", maps.pll_map_aa))
    for node in ut.query_tipnodes(tree):
        if tip_clv:
            part.set_tip_clv(node.clv_index, rng.uniform(
                0.0, 1.0, (sites, states)) * 10.0 ** rng.uniform(
                    -12, 0, (sites, 1)))
        else:
            seq = "".join(rng.choice(list(chars), sites))
            part.set_tip_states(node.clv_index, charmap,
                                chars[0] * 5 + seq[5:] if pinv else seq)
    if pinv:
        part.update_invariant_sites_proportion(0, pinv)
    if asc is not None:
        part.set_asc_bias_type(asc)
        part.set_asc_state_weights(np.arange(1, states + 1))
    pidx = (rng.integers(0, rate_matrices, rate_cats) if rate_matrices > 1
            else np.zeros(rate_cats, int))
    ops, branches, pmat_idx = ut.create_operations(ut.traverse(tree.root))
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    return part, tree, ops, pidx


def edge_of(tree):
    """(parent clv, parent scaler, child clv, child scaler, matrix) of the
    evaluation edge at ``tree.root``."""
    r = tree.root
    return (r.clv_index, r.scaler_index, r.back.clv_index,
            r.back.scaler_index, r.pmatrix_index)


def rows_close(got, want, rel):
    """Each entry within ``rel`` of its (row, rate, site) block's largest
    magnitude: (ok, largest relative error)."""
    got, want = got.double().cpu(), want.double().cpu()
    span = want.abs().amax(dim=-2, keepdim=True)
    err = (got - want).abs() / span.clamp_min(np.finfo(np.float64).tiny)
    err = float(err.max()) if err.numel() else 0.0
    return err <= rel, err


def partition_results(part, tree, pidx):
    """(edge logL, root logL, per-site edge logL, d1, d2) at the root edge,
    the branch's own length."""
    pc, ps, cc, cs, m = edge_of(tree)
    logl, persite = part.compute_edge_loglikelihood(pc, ps, cc, cs, m, pidx,
                                                    persite=True)
    root = part.compute_root_loglikelihood(pc, ps, pidx)
    st = part.update_sumtable(pc, cc, ps, cs, pidx)
    d1, d2 = part.compute_likelihood_derivatives(ps, cs, tree.root.length,
                                                 pidx, st)
    return logl, root, persite, d1, d2


def check_partition_small(device):
    """Phase 20: the Partition on the card against the Partition on the
    CPU, the same setters and op lists: float64 logL (edge, root, per
    site) rel 1e-12, derivatives rel 1e-10, scalers equal, CLVs rel 1e-12
    of each block's largest; float32 logL within the budget, derivatives
    rel 1e-3.  Per configuration, after the full traversal: ``pad_to``
    (the table padded by repeating its last op) and an op list that
    rewrites an inner buffer after a child read it, with a "no scaler"
    write.  Then the three executors of ``ops/clv`` on random op tables
    (hazards of every kind) against the CPU.  Returns the number of
    configurations."""
    import torch

    from libpll_tpu_torch import Operation
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.tree import schedule as sch
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.constants import (SCALE_NONE,
                                                  SCALE_PER_RATE,
                                                  SCALE_PER_SITE)

    cpu = torch.device("cpu")
    n = 0
    for seed, (name, kw) in enumerate(PARTITION_SMALL):
        for dtype in (torch.float64, torch.float32):
            got, want = (partition_case(dev, dtype, seed, **kw)
                         for dev in (device, cpu))
            tips = got[0].tips
            rewrite = [Operation(tips, 0, 0, 0, -1, 1, 1, -1),
                       Operation(tips + 1, 1, tips, 2, 0, 2, 2, -1),
                       Operation(tips, -1, 3, 3, -1, 4, 4, -1),
                       Operation(tips + 2, 2, tips, 5, -1, tips + 1, 6, 1)]
            for part, tree, ops, pidx in (got, want):
                part.update_partials(ops[-3:], pad_to=7)
                part.update_partials(rewrite)
                part.update_partials(ops)
            res = [partition_results(p, t, i) for p, t, _, i in (got, want)]
            (gl, gr, gps, g1, g2), (wl, wr, wps, w1, w2) = res
            label = f"partition {name} {dtype}"
            if dtype == torch.float64:
                check(all(logl_close(a, b, dtype) for a, b in
                          ((gl, wl), (gr, wr))),
                      f"{label}: logL {gl!r}/{gr!r} vs CPU {wl!r}/{wr!r}")
                check(np.allclose(gps, wps, rtol=F64_REL, atol=0),
                      f"{label}: per-site logL")
                check(abs(g1 - w1) <= PART_DERIV_REL * abs(w1)
                      and abs(g2 - w2) <= PART_DERIV_REL * abs(w2),
                      f"{label}: derivatives {(g1, g2)} vs {(w1, w2)}")
                check(torch.equal(got[0].scalers.cpu(), want[0].scalers),
                      f"{label}: scalers differ")
                ok, err = rows_close(got[0].clv, want[0].clv, F64_REL)
                check(ok, f"{label}: CLVs rel {err}")
                if name.startswith("tip_clv"):
                    check(bool(want[0].scalers.any()),
                          f"{label}: scaling never fired")
            else:
                check(logl_close(gl, wl, dtype) and logl_close(gr, wr, dtype),
                      f"{label}: logL {gl!r}/{gr!r} vs CPU {wl!r}/{wr!r}")
                check(np.allclose((g1, g2), (w1, w2), rtol=1e-3, atol=1e-2),
                      f"{label}: derivatives {(g1, g2)} vs {(w1, w2)}")
            n += 1

    # the executors on random op tables, and on build_levels' tables
    rng = np.random.default_rng(20)
    tips, inner, c, s, sites, m = 5, 6, 3, 4, 203, 9
    for mode in (SCALE_PER_SITE, SCALE_PER_RATE, SCALE_NONE):
        clv = np.zeros((tips + inner, c, s, sites))
        clv[:tips + 1] = rng.uniform(0.05, 1, (tips + 1, 1, s, sites)) \
            * 10.0 ** rng.uniform(-60, 0, (tips + 1, 1, 1, sites))
        pm = rng.uniform(0.05, 1, (m, c, s, s))
        shape = ((inner + 1, sites) if mode == SCALE_PER_SITE else
                 (inner + 1, c, sites) if mode == SCALE_PER_RATE
                 else (1, sites))
        ops = np.empty((40, 8), np.int32)
        ops[:, 0] = rng.integers(tips, tips + inner, 40)
        ops[:, [2, 5]] = rng.integers(0, tips + inner, (40, 2))
        ops[:, [3, 6]] = rng.integers(0, m, (40, 2))
        ops[:, [1, 4, 7]] = rng.integers(0, inner + 1, (40, 3))
        tree = ut.parse_newick_string(random_newick(tips + 1, rng))
        levels = sch.build_levels(
            ut.create_operations(ut.traverse(tree.root))[0], inner, width=3)
        runs = {"by_op": lambda cl, sc, p: clv_ops.update_partials_by_op(
                    cl, sc, ops, p, mode),
                "grouped": lambda cl, sc, p: clv_ops.update_partials_grouped(
                    cl, sc, ops, p, mode),
                "leveled": lambda cl, sc, p: clv_ops.update_partials_leveled(
                    cl, sc, *levels, p, mode)}
        for name, run in runs.items():
            out = []
            for dev in (device, cpu):
                cl = torch.tensor(clv, device=dev)
                sc = torch.zeros(shape, dtype=torch.int32, device=dev)
                run(cl, sc, torch.tensor(pm, device=dev))
                out.append((cl.cpu(), sc.cpu()))
            (gc, gs), (wc, ws) = out
            ok, err = rows_close(gc, wc, F64_REL)
            check(ok and torch.equal(gs, ws),
                  f"ops.clv {name} mode {mode}: CLVs rel {err}, scalers "
                  f"equal {torch.equal(gs, ws)}")
            n += 1
    return n


def flagship_partition(device, dtype, tree, patterns, weights, params, freqs,
                       rates, states=4, rate_matrices=1, charmap=None):
    """The Partition of an alignment on ``tree``: ``patterns`` (compressed
    rows by tip CLV index) and their ``weights``, exchangeabilities and
    frequencies per rate matrix, the category rates (weights equal unless
    given as ``rates = (rates, weights)``)."""
    from libpll_tpu_torch import Partition
    from libpll_tpu_torch.io import maps

    tips, sites = tree.tip_count, len(patterns[0])
    part = Partition(tips, tips - 2, states, sites, rate_matrices,
                     2 * tips - 3, len(rates[0]), tips - 2, dtype=dtype,
                     device=device)
    for k in range(rate_matrices):
        part.set_subst_params(k, params[k])
        part.set_frequencies(k, freqs[k])
    part.set_category_rates(rates[0])
    part.set_category_weights(rates[1])
    part.set_pattern_weights(weights)
    for i, seq in enumerate(patterns):
        part.set_tip_states(i, maps.pll_map_nt if charmap is None
                            else charmap, seq)
    return part


def read_phylip_flagship(tips, sites):
    """The flagship alignment simulated on its tree (seed 0), written as
    sequential PHYLIP to a temporary directory, read back with
    ``io/phylip`` and compressed: (tree, topo, model, (params, freqs),
    patterns by tip CLV index, pattern weights, seconds)."""
    import os
    import tempfile

    from libpll_tpu_torch.io.compress import compress_site_patterns
    from libpll_tpu_torch.io.maps import NT_STATES, pll_map_nt
    from libpll_tpu_torch.io.phylip import parse_phylip_sequential
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.flagship import simulate_flagship

    t0 = time.perf_counter()
    tree, topo, model, gtr, states = simulate_flagship(tips, sites, seed=0)
    letters = np.frombuffer(NT_STATES.encode(), np.uint8)[states]
    labels = {n.clv_index: n.label for n in ut.query_tipnodes(tree)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.phy")
        with open(path, "w", encoding="latin-1") as fh:
            fh.write(f"{tips} {sites}\n")
            for i in range(tips):
                fh.write(f"{labels[i]} "
                         f"{letters[i].tobytes().decode('latin-1')}\n")
        msa = parse_phylip_sequential(path)
    row = {label: k for k, label in enumerate(msa.labels)}
    patterns, weights = compress_site_patterns(
        [msa.sequences[row[labels[i]]] for i in range(tips)], pll_map_nt)
    return (tree, topo, model, gtr, patterns, weights,
            time.perf_counter() - t0)


def pattern_masks(patterns, charmap):
    """[tips, patterns] uint32 state masks of compressed rows."""
    n = len(patterns[0])
    return charmap[np.frombuffer("".join(patterns).encode("latin-1"),
                                 np.uint8).reshape(len(patterns), n)]


def phase_partition(device, card, peak):
    """Phases 21-22: the stateful Partition path at the DNA flagship in
    float64 (the alignment through PHYLIP and compression; setters, P-
    matrices, a full ``update_partials``, the edge logL), held against
    ``make_forward``; ``model_from_partition`` into ``make_score`` (K1),
    ``make_forward_fused`` (K2) and ``make_train_step_fused`` (K2 + N1),
    each with its counters at 0 around it; the sumtable and derivatives
    against ``make_train_step``; an SPR with its partial traversal and
    rollback; a checkpoint round trip; the float32 Partition; then the
    times.  Returns the numbers later phases print."""
    import os
    import tempfile

    import torch

    from libpll_tpu_torch.engine import checkpoint as ck
    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.partition import operations_to_array
    from libpll_tpu_torch.errors import EinvalError
    from libpll_tpu_torch.io.maps import pll_map_nt
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.tree import incremental as inc
    from libpll_tpu_torch.tree import moves
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_RATE_CATS,
                                                 FLAGSHIP_SITES,
                                                 FLAGSHIP_STATES,
                                                 FLAGSHIP_TIPS)

    tips, c, s = FLAGSHIP_TIPS, FLAGSHIP_RATE_CATS, FLAGSHIP_STATES
    tree, _, model_np, (params, freqs), patterns, weights, io_s = \
        read_phylip_flagship(tips, FLAGSHIP_SITES)
    sites = len(patterns[0])
    rates = (compute_gamma_cats(1.0, c), np.full(c, 1.0 / c))
    pidx = np.zeros(c, int)
    trav = ut.traverse(tree.root)
    ops, branches, pmat_idx = ut.create_operations(trav)
    f64, f32 = torch.float64, torch.float32

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    part = flagship_partition(device, f64, tree, patterns, weights,
                              params[None], freqs[None], rates)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    pc, ps, cc, cs, m = edge_of(tree)
    logl = part.compute_edge_loglikelihood(pc, ps, cc, cs, m, pidx)
    torch.cuda.synchronize()
    part_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    inc.mark_valid(trav)

    # make_forward (f64) on the same tree, rows mapped level-major
    topo, _ = ev.topology_from_tree(tree, sites)
    sched = topo.schedule
    m64 = ev.model_from_partition(part, branches, dtype=f64, device=device)
    clv = torch.zeros((sched.tips + sched.n_inner, c, s, sites), dtype=f64,
                      device=device)
    clv[:tips] = part.clv[:tips]
    scal = torch.zeros((sched.n_inner + 1, sites), dtype=torch.int32,
                       device=device)
    want, _, fclv, fscal = ev.make_forward(topo, device=device).swept(
        m64, clv, scal)
    want = float(want)
    check(abs(logl - want) <= F64_REL * abs(want),
          f"flagship Partition logL {logl!r} vs make_forward {want!r}")
    inner = [n.clv_index for n in trav if not n.is_tip]
    lm = torch.as_tensor([sched.clv_map[i] for i in inner], device=device)
    ok, clv_err = rows_close(part.clv[inner], fclv[lm], F64_REL)
    check(ok, f"flagship Partition CLVs vs make_forward: rel {clv_err}")
    sidx = sorted(sched.scaler_map)
    check(torch.equal(part.scalers[sidx], fscal[[sched.scaler_map[k]
                                                 for k in sidx]]),
          "flagship Partition scalers differ from make_forward's")
    n_scaled = int(part.scalers.sum())
    del clv, scal, fclv, fscal

    # derivatives at the root edge against make_train_step's
    st = part.update_sumtable(pc, cc, ps, cs, pidx)
    d1, d2 = part.compute_likelihood_derivatives(ps, cs, branches[-1], pidx,
                                                 st)
    step64 = ev.make_train_step(topo, device=device)
    clv = torch.zeros((sched.tips + sched.n_inner, c, s, sites), dtype=f64,
                      device=device)
    clv[:tips] = part.clv[:tips]
    scal = torch.zeros((sched.n_inner + 1, sites), dtype=torch.int32,
                       device=device)
    args = step64.newton_inputs(m64, clv, scal)[3]
    args["branch_length"] = args.pop("t0")
    w1, w2 = (float(v) for v in dv.likelihood_derivatives(**args))
    check(abs(d1 - w1) <= PART_DERIV_REL * abs(w1)
          and abs(d2 - w2) <= PART_DERIV_REL * abs(w2),
          f"Partition derivatives {(d1, d2)} vs make_train_step {(w1, w2)}")
    del clv, scal, args, st, m64
    torch.cuda.empty_cache()

    # the fused entry points on model_from_partition, counters at 0 each
    m32 = ev.model_from_partition(part, branches, device=device)
    tp = cf.pack_tipchars(pattern_masks(patterns, pll_map_nt)).to(device)
    kw = dict(tip_encoding="chars", device=device)
    score = ev.make_score(topo, c, s, **kw)
    fwd = ev.make_forward_fused(topo, c, s, **kw)
    step = ev.make_train_step_fused(topo, c, s, **kw)
    runs = {"make_score": lambda: (score(m32, tp),),
            "make_forward_fused": lambda: fwd(m32, tp),
            "make_train_step_fused": lambda: step(m32, tp)}
    out, launches = {}, {}
    for name, run in runs.items():
        torch.cuda.synchronize()
        cf.fused_edge_score.launches = 0
        cf.fused_sweep.launches = 0
        dv.newton_solve.launches = 0
        out[name] = run()
        torch.cuda.synchronize()
        launches[name] = (cf.fused_edge_score.launches,
                          cf.fused_sweep.launches, dv.newton_solve.launches)
    check(launches["make_score"] == (1, 0, 0)
          and launches["make_forward_fused"] == (0, 1, 0)
          and launches["make_train_step_fused"] == (0, 1, 1),
          f"Partition main path: launches (K1, K2, N1) {launches}")
    budget = ACC_REL * abs(logl) + ACC_ABS
    k1_logl = float(out["make_score"][0])
    k2_logl, _, k2_inner, k2_scal = out["make_forward_fused"]
    k2_logl = float(k2_logl)
    t_star = float(out["make_train_step_fused"][1])
    for name, got in (("make_score", k1_logl),
                      ("make_forward_fused", k2_logl)):
        check(abs(got - logl) <= budget, f"{name} on model_from_partition "
                                         f"{got!r} vs the Partition {logl!r}")
    check(dv.MIN_T < t_star < dv.MAX_T, f"Partition t* {t_star!r} clamped")
    st = part.update_sumtable(pc, cc, ps, cs, pidx)
    t1, t2 = part.compute_likelihood_derivatives(ps, cs, t_star, pidx, st)
    check(t2 > 0 and abs(t1) <= t2 * F32_T_REL * t_star,
          f"K2 + N1's t* {t_star!r}: the Partition's d1 {t1!r}, d2 {t2!r}")
    del st

    # the float32 Partition: logL in budget, rows equal to K2's
    part32 = flagship_partition(device, f32, tree, patterns, weights,
                                params[None], freqs[None], rates)
    part32.update_prob_matrices(pidx, pmat_idx, branches)
    part32.update_partials(ops)
    logl32 = part32.compute_edge_loglikelihood(pc, ps, cc, cs, m, pidx)
    check(abs(logl32 - logl) <= budget,
          f"float32 Partition logL {logl32!r} vs float64 {logl!r}")
    order = sorted(inner, key=lambda i: sched.clv_map[i])
    srows = [sched.clv_map[i] - tips for i in order]
    check(srows == list(range(sched.n_inner)), "schedule rows not dense")
    scaler_of = {n.clv_index: n.scaler_index for n in trav if not n.is_tip}
    p_inner = part32.clv[order]
    p_scal = torch.cat([part32.scalers[[scaler_of[i] for i in order]],
                        part32.scalers[-1:]])
    ok, k2_err, k2_agree = sweep_close(k2_inner, k2_scal, p_inner, p_scal,
                                       f32)
    check(ok, f"K2 rows vs the float32 Partition's: max abs {k2_err}, "
              f"scalers agree {k2_agree}")
    del p_inner, p_scal, k2_inner, k2_scal, out
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        part32.update_partials(ops)
        fail("float32 update_partials ran with TF32 matmuls on")
    except EinvalError:
        pass
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[21 partition] {tips} taxa x {FLAGSHIP_SITES} columns GTR+G4 "
          f"simulated on the flagship's tree, written as PHYLIP, read back "
          f"and compressed in {io_s:.2f} s: {sites} patterns; float64 "
          f"Partition on the card: edge logL {logl!r}, make_forward "
          f"{want!r} (rel {abs(logl - want) / abs(want):.3e}), CLVs rel "
          f"{clv_err:.3e}, scalers equal ({n_scaled} scaling events); "
          f"d1/d2 {d1!r}/{d2!r} vs make_train_step {w1!r}/{w2!r}; "
          f"model_from_partition: make_score (K1) {k1_logl!r}, "
          f"make_forward_fused (K2) {k2_logl!r} (|d| "
          f"{abs(k1_logl - logl):.3e}, {abs(k2_logl - logl):.3e} <= "
          f"{budget:.3e}), make_train_step_fused t0 {branches[-1]!r} -> t* "
          f"{t_star!r} (the Partition's d1 {t1:.3e}, d2 {t2:.3e} there); "
          f"launches (K1, K2, N1) {launches}; float32 Partition logL "
          f"{logl32!r} (|d| {abs(logl32 - logl):.3e}), K2's rows vs its "
          f"rows max abs {k2_err:.3e}, scalers agree {k2_agree:.6f}; "
          f"TF32 guard raises; peak device memory of the float64 Partition "
          f"{part_gib:.4f} GiB", flush=True)

    # an SPR, its partial traversal, a full recomputation, the rollback
    nodes = tree.nodes
    i_p, i_r = next(
        (i, j) for i in range(len(nodes)) if nodes[i].next is not None
        for j in range(len(nodes)) if nodes[j] not in (
            nodes[i], nodes[i].back, nodes[i].next, nodes[i].next.back,
            nodes[i].next.next, nodes[i].next.next.back)
        and not moves._subtree_contains(nodes[i].back, nodes[j]))
    rb = moves.Rollback(moves.MOVE_SPR)
    changed = moves.spr_safe(nodes[i_p], nodes[i_r], rb)
    part.update_prob_matrices(pidx, [k for _, k in changed],
                              [t for t, _ in changed])
    partial = inc.create_partial_operations(inc.partial_traverse(tree.root))
    check(0 < len(partial) < len(ops),
          f"SPR: {len(partial)} partial ops of {len(ops)}")
    part.update_partials(partial)
    e_spr = edge_of(tree)
    logl_partial = part.compute_edge_loglikelihood(*e_spr, pidx)
    part.update_partials(ut.create_operations(ut.traverse(tree.root))[0])
    logl_full = part.compute_edge_loglikelihood(*e_spr, pidx)
    check(abs(logl_partial - logl_full) <= F64_REL * abs(logl_full),
          f"SPR: partial {logl_partial!r} vs full {logl_full!r}")
    timed = {"partial": time_ms(lambda: part.update_partials(partial),
                                iters=5, warmup=1)}
    idle = {"partial": host_ms(lambda: part.update_partials(partial),
                               iters=5)}
    back = moves.rollback_move(rb)
    part.update_prob_matrices(pidx, [k for _, k in back],
                              [t for t, _ in back])
    undo = inc.create_partial_operations(inc.partial_traverse(tree.root))
    part.update_partials(undo)
    logl_back = part.compute_edge_loglikelihood(pc, ps, cc, cs, m, pidx)
    check(abs(logl_back - logl) <= F64_REL * abs(logl),
          f"rollback: {logl_back!r} vs the first logL {logl!r}")

    # checkpoint round trip on the card: the same logL bit for bit
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.npz")
        ck.save_checkpoint(path, ut.export_newick(tree.root), part)
        header, arrays = ck.load_checkpoint(path)
    part.update_partials(ops)
    logl_ref = part.compute_edge_loglikelihood(pc, ps, cc, cs, m, pidx)
    del part32
    torch.cuda.empty_cache()
    tree2 = ut.parse_newick_string(header["newick"])
    ops2, branches2, pmat2 = ut.create_operations(ut.traverse(tree2.root))
    restored = ck.restore_partition(header, arrays, device=device)
    row_of = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
    for n in ut.query_tipnodes(tree2):
        restored.set_tip_states(n.clv_index, pll_map_nt,
                                patterns[row_of[n.label]])
    restored.update_prob_matrices(pidx, pmat2, branches2)
    restored.update_partials(ops2)
    logl_ck = restored.compute_edge_loglikelihood(*edge_of(tree2), pidx)
    check(logl_ck == logl_ref, f"checkpoint round trip: {logl_ck!r} vs "
                               f"{logl_ref!r}")
    del restored
    torch.cuda.empty_cache()
    print(f"[21 partition] SPR (prune {i_p}, regraft {i_r}): "
          f"{len(partial)} partial ops of {len(ops)}, logL {logl_partial!r}"
          f" = full recomputation {logl_full!r}; rollback: {len(undo)} ops,"
          f" logL {logl_back!r} (first {logl!r}); checkpoint "
          f"{header['dtype']} header -> restore_partition on the card -> "
          f"{logl_ck!r}, bit for bit", flush=True)

    # times, CUDA events after warm-up; host ms with the card idle
    part32 = flagship_partition(device, f32, tree, patterns, weights,
                                params[None], freqs[None], rates)
    part32.update_prob_matrices(pidx, pmat_idx, branches)
    ops_table = operations_to_array(ops, part.scale_buffers)
    levels = clv_ops.hazard_levels(ops_table, part.scale_buffers)

    def grouped(p):
        return lambda: clv_ops.update_partials_grouped(
            p.clv, p.scalers, ops_table, p.pmatrix, p.scale_mode)

    pm32 = fwd.pmatrices(m32, f32)
    runs = {"part64": lambda: part.update_partials(ops),
            "grouped64": grouped(part),
            "part32": lambda: part32.update_partials(ops),
            "grouped32": grouped(part32),
            "edge64": lambda: part.compute_edge_loglikelihood(
                pc, ps, cc, cs, m, pidx),
            "deriv64": lambda: part.compute_likelihood_derivatives(
                ps, cs, branches[-1], pidx,
                part.update_sumtable(pc, cc, ps, cs, pidx)),
            "fwd32": lambda: fwd(m32, tp),
            "k2": lambda: cf.fused_sweep(sched, tp, pm32, plan=fwd.plan,
                                         tip_encoding="chars")}
    for name, run in runs.items():
        timed[name] = time_ms(run, iters=5, warmup=2)
        idle[name] = host_ms(run, iters=5)
    ms = {k: v[0] for k, v in timed.items()}
    print(f"[22 partition times] {card}: update_partials (full, "
          f"{len(ops)} ops) float64 {ms['part64']:.4f} ms (kernel U1), "
          f"{ms['grouped64']:.4f} ms in "
          f"{int(levels.max()) + 1} hazard groups (ops/clv."
          f"update_partials_grouped); float32 {ms['part32']:.4f} / "
          f"{ms['grouped32']:.4f} ms; K2 at the same size (float32) "
          f"{ms['k2']:.4f} ms, make_forward_fused {ms['fwd32']:.4f} ms; "
          f"partial traversal after the SPR ({len(partial)} ops, float64) "
          f"{ms['partial']:.4f} ms; compute_edge_loglikelihood "
          f"{ms['edge64']:.4f} ms; update_sumtable + "
          f"compute_likelihood_derivatives {ms['deriv64']:.4f} ms; host ms "
          f"of a call with the card idle: " + ", ".join(
              f"{k} {v:.4f}" for k, v in idle.items())
          + "; CUDA events, 5 calls after 2 warm-up", flush=True)
    return dict(ms=ms, idle=idle, part_gib=part_gib)


def phase_partition_protein(device):
    """Phase 23: the protein configuration (LG4X+Γ4 through FASTA,
    ``utils/flagship.protein_flagship_alignment``) in a float64 Partition:
    four rate matrices, ``params_indices`` [0, 1, 2, 3], category weights
    0.1-0.4; its logL against ``make_forward`` (rel 1e-12) and against
    ``make_score`` on ``model_from_partition`` (K1 at S = 20, counters at
    0 around the call, within the f32 budget)."""
    import torch

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.io.maps import pll_map_aa
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.flagship import protein_flagship_alignment

    tree, _, _, patterns, counts, lg4x = protein_flagship_alignment(seed=0)
    exch, freqs, _, cat_rates, weights = lg4x
    c, s = len(cat_rates), 20
    sites = len(patterns[0])
    pidx = np.arange(c)
    ops, branches, pmat_idx = ut.create_operations(ut.traverse(tree.root))
    part = flagship_partition(device, torch.float64, tree, patterns, counts,
                              exch, freqs, (cat_rates, weights), states=s,
                              rate_matrices=c, charmap=pll_map_aa)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    e = edge_of(tree)
    logl = part.compute_edge_loglikelihood(*e, pidx)

    topo, _ = ev.topology_from_tree(tree, sites)
    sched = topo.schedule
    m64 = ev.model_from_partition(part, branches, pidx, torch.float64,
                                  device=device)
    clv = torch.zeros((sched.tips + sched.n_inner, c, s, sites),
                      dtype=torch.float64, device=device)
    clv[:sched.tips] = part.clv[:sched.tips]
    scal = torch.zeros((sched.n_inner + 1, sites), dtype=torch.int32,
                       device=device)
    want = float(ev.make_forward(topo, device=device)(m64, clv, scal)[0])
    check(abs(logl - want) <= F64_REL * abs(want),
          f"protein Partition logL {logl!r} vs make_forward {want!r}")
    del clv, scal
    m32 = ev.model_from_partition(part, branches, pidx, device=device)
    tp = torch.from_numpy(pattern_masks(patterns, pll_map_aa).astype(
        np.int32)).to(device)
    score = ev.make_score(topo, c, s, tip_encoding="masks", device=device)
    torch.cuda.synchronize()
    cf.fused_edge_score.launches = 0
    cf.fused_sweep.launches = 0
    dv.newton_solve.launches = 0
    k1 = float(score(m32, tp))
    torch.cuda.synchronize()
    launches = (cf.fused_edge_score.launches, cf.fused_sweep.launches,
                dv.newton_solve.launches)
    check(launches == (1, 0, 0), f"protein Partition path: launches (K1, "
                                 f"K2, N1) {launches}")
    budget = ACC_REL * abs(logl) + ACC_ABS
    check(abs(k1 - logl) <= budget,
          f"protein make_score (K1, S = 20) {k1!r} vs the Partition {logl!r}")
    print(f"[23 partition protein] {tree.tip_count} taxa, {sites} patterns "
          f"LG4X+G4 from FASTA, float64 Partition on the card (four rate "
          f"matrices, params_indices {pidx.tolist()}, weights "
          f"{weights.tolist()}): edge logL {logl!r}, make_forward {want!r} "
          f"(rel {abs(logl - want) / abs(want):.3e}); make_score (K1, "
          f"S = 20) on model_from_partition {k1!r} (|d| "
          f"{abs(k1 - logl):.3e} <= {budget:.3e}); launches (K1, K2, N1) "
          f"{launches}", flush=True)
    del part
    torch.cuda.empty_cache()


# ------------------------------------------------------------- parsimony
# (tips, sites, states, weighted, partitions), each at PARSIMONY_SEEDS: 32
# configurations; a second and third partition take the other alphabet
# and fewer sites
PARSIMONY_SMALL = ((4, 40, 4, False, 1), (5, 33, 20, True, 1),
                   (17, 300, 4, True, 2), (33, 97, 20, False, 1),
                   (64, 500, 4, False, 3), (100, 1000, 4, True, 1),
                   (150, 257, 20, True, 2), (200, 2000, 4, False, 1))
PARSIMONY_SEEDS = (0, 1, 42, 12345)
ENGINES_UP_TO = 64  # tips: both engines on the card against the CPU
DNA_CODES = "ACGTACGTACGT-RYKMSWN"  # IUPAC ambiguity codes and gaps
PROTEIN_CODES = "ARNDCQEGHILKMFPSTWYVBZX-"
# scripts/bench_stepwise.py's configurations: random ACGT from
# default_rng(7), one FastParsimony partition, stepwise seed 42
STEPWISE_CASES = ((2048, 2048), (500, 10000))
# the host engine's builds (P1 and P2); its 2 048 x 2 048 build takes
# 13-22 s, and tools/stepwise_times.py times it
STEPWISE_HOST_CASES = ((500, 10000),)
STEPWISE_SEED = 42
# libpll_tpu's fastparsimony_stepwise(engine="device") on these inputs,
# run on the CPU (JAX_PLATFORMS=cpu): the score, and the SHA-256 and length
# of export_newick(tree.root)
STEPWISE_JAX = {
    (2048, 2048): (2236462, "d8ce04bcc5a033dfe91c5addee105bc1"
                            "35d8bbbe21ff99bbbb2d8cd7385bc92c", 52107),
    (500, 10000): (2713550, "2a5ac5ecdd60fc12baca1377aed11a27"
                            "39fe202ebac83d9ffa3924f826bba7da", 12359)}
# integer throughput of an H100 SM a clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0): 32-bit
# logic 64, population count 16
LOGIC_PER_SM_CLOCK, POPC_PER_SM_CLOCK = 64, 16


def parsimony_parts(tips, sites, states, weighted, n_parts, seed, device):
    """``n_parts`` FastParsimony partitions of one taxon set on
    ``device``, alignments with ambiguity codes drawn from ``seed``."""
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.search.parsimony import FastParsimony

    parts = []
    for k in range(n_parts):
        s = states if k % 2 == 0 else 24 - states
        rng = np.random.default_rng(7 * seed + k)
        length = max(1, sites // (k + 1))
        codes = DNA_CODES if s == 4 else PROTEIN_CODES
        seqs = ["".join(rng.choice(list(codes), length))
                for _ in range(tips)]
        weights = rng.integers(1, 5, length) if weighted else None
        parts.append(FastParsimony.from_sequences(
            seqs, maps.pll_map_nt if s == 4 else maps.pll_map_aa, s, weights,
            device=device))
    return parts


def insert_scores_plain(rows, topo, i, tip):
    """The summed candidate scores of insertion i by P2's plain version."""
    from libpll_tpu_torch.ops import fitch

    back, edge_rows = topo[0], topo[1]
    u = edge_rows[:2 * i - 3].long()
    total = 0
    for v, c in rows:
        total = total + fitch._uint(fitch.fitch_insert_scores_plain(
            v, c, v[tip], u, back[u].long()))
    return fitch._bits(total)


def commit_pair(rows, topo, **kw):
    """P3 on ``rows``/``topo`` and its plain version on clones of them;
    every row, cost, ``back``, ``edge_rows`` and the final scores must be
    equal.  Returns (the kernel's result, the largest difference: 0)."""
    from libpll_tpu_torch.ops import fitch

    twins = [(v.clone(), c.clone()) for v, c in rows]
    ttopo = (topo[0].clone(), topo[1].clone()) + topo[2:]
    want = fitch.stepwise_commit_plain(twins, *ttopo, **kw)
    got = fitch.stepwise_commit(rows, *topo, **kw)
    pairs = [(topo[0], ttopo[0]), (topo[1], ttopo[1])] + [
        (a, b) for pair in zip(rows, twins) for a, b in zip(*pair)]
    err = max(max_diff(a, b) for a, b in pairs + (
        [] if want is None else [(got, want)]))
    check(err == 0, f"P3 stepwise_commit ({kw['mode']}, insertion "
                    f"{kw.get('insertion')}) differs from its plain version "
                    f"by {err}")
    return got, err


def stepwise_pair(parts, order):
    """The device build step by step on the card, every P2 launch (summed
    over the partitions) and every P3 launch held against its plain
    version on the same state, exactly.  Returns (back, finals)."""
    import torch

    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search.stepwise import direction_rows

    n = len(order)
    rows = direction_rows(parts)
    topo = fitch.stepwise_topology(order, parts[0].device)
    scores = torch.empty(2 * n - 3, dtype=torch.int32,
                         device=parts[0].device)
    commit_pair(rows, topo, mode="star")
    for i in range(3, n):
        ne = 2 * i - 3
        for k, (v, c) in enumerate(rows):
            fitch.fitch_scores(v, c, topo[1][:ne], back=topo[0],
                               tip=order[i], out=scores[:ne],
                               accumulate=k > 0)
        check(torch.equal(scores[:ne], insert_scores_plain(rows, topo, i,
                                                           order[i])),
              f"P2 insert scores of insertion {i} differ from the plain "
              "version")
        commit_pair(rows, topo, mode="insert", scores=scores, insertion=i,
                    tip=order[i])
    return topo[0], commit_pair(rows, topo, mode="final")[0]


class ForcedCommitPlan:
    """While active, P3 keeps its walk's tables in ``tables`` ("shared" or
    "global") memory and splits the words over ``grid`` blocks (None: the
    plan's own): ``ops.fitch.commit_plan`` at the card's shared-memory
    limit, or at 0 for device memory."""

    def __init__(self, tables, grid=None):
        from libpll_tpu_torch.ops import fitch

        self.fitch, self.tables, self.grid = fitch, tables, grid
        self.real = fitch.plan_for

    def __enter__(self):
        fitch = self.fitch

        def plan_for(parts, n_tips):
            sms, smem = fitch._limits(parts[0][0].device.index or 0)
            plan = fitch.commit_plan(
                [v.shape[2] for v, _ in parts], n_tips, sms,
                smem if self.tables == "shared" else 0)
            check(plan.shared == (self.tables == "shared"),
                  f"{n_tips} taxa: P3's tables do not fit shared memory")
            return plan._replace(grid=self.grid) if self.grid else plan
        fitch.plan_for = plan_for
        return self

    def __exit__(self, *exc):
        self.fitch.plan_for = self.real


def parsimony_cpu_side(seed, cfg):
    """The CPU's side of phase 24's device build at one configuration:
    the partitions (their inner rows set by the random tree's traversal,
    as on the card), then the device build's ``back`` and final scores
    and, up to ENGINES_UP_TO taxa, fastparsimony_stepwise's (score,
    Newick), all on the CPU."""
    import torch

    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search.stepwise import (direction_rows,
                                                  fastparsimony_stepwise)
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.rng import shuffled_order

    tips = cfg[0]
    host = parsimony_parts(*cfg, seed, torch.device("cpu"))
    tree = ut.parse_newick_string(random_newick(tips,
                                                np.random.default_rng(seed)))
    for part in host:
        part.update_vectors(ut.create_pars_buildops(ut.traverse(tree.root)))
    hback, _, hfinals = fitch.stepwise_build(direction_rows(host),
                                             shuffled_order(tips, seed))
    engines = None
    if tips <= ENGINES_UP_TO:
        found = fastparsimony_stepwise(host, [f"t{i}" for i in range(tips)],
                                       seed)
        engines = (found[1], ut.export_newick(found[0].root))
    return hback, hfinals, engines


def check_parsimony_small(device, cpu_refs=None):
    """Phase 24: P1-P3 against their plain versions on the card, exactly,
    at PARSIMONY_SMALL x PARSIMONY_SEEDS (4-200 taxa, DNA and 20 states
    with ambiguity codes, weighted patterns, 1-3 partitions): P1 over a
    random tree's traversal (and the card's FastParsimony against the
    CPU's: vectors, costs, edge scores, root scores), P2 in edge mode on
    random pairs, and the device build step by step (every P2 and P3
    launch), its final scores and ``back`` against the CPU's; both
    engines of ``fastparsimony_stepwise`` on the card against the CPU up
    to ENGINES_UP_TO taxa (score and Newick); the Sankoff ``Parsimony`` on
    the card against the CPU (float64, rel 0).  The CPU's builds and
    engines (``parsimony_cpu_side``) come from ``cpu_refs`` (a
    :class:`CpuRefs`, computed beside the earlier phases) or, without
    it, are run here.  Returns the configurations checked."""
    import torch

    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search.parsimony import Parsimony, _group_levels
    from libpll_tpu_torch.search.stepwise import fastparsimony_stepwise
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.rng import shuffled_order

    cpu = torch.device("cpu")
    n = 0
    for seed in PARSIMONY_SEEDS:
        for cfg in PARSIMONY_SMALL:
            tips, sites = cfg[:2]
            what = f"parsimony {cfg} seed {seed}"
            card, host = (parsimony_parts(*cfg, seed, dev)
                          for dev in (device, cpu))
            rng = np.random.default_rng(seed)
            tree = ut.parse_newick_string(random_newick(tips, rng))
            ops = ut.create_pars_buildops(ut.traverse(tree.root))
            root = tree.root
            for pc, ph in zip(card, host):
                v, c = pc.vectors.clone(), pc.costs.clone()
                table, offsets = fitch.wave_table(_group_levels(ops),
                                                  v.shape[0])
                fitch.fitch_run_waves_plain(
                    v, c, torch.from_numpy(table).to(device), offsets)
                pc.update_vectors(ops)
                ph.update_vectors(ops)
                check(torch.equal(pc.vectors, v) and torch.equal(pc.costs, c),
                      f"{what}: P1 differs from its plain version")
                check(torch.equal(pc.vectors.cpu(), ph.vectors)
                      and torch.equal(pc.costs.cpu(), ph.costs),
                      f"{what}: FastParsimony on the card differs from the "
                      "CPU's")
                n1, n2 = rng.integers(0, 2 * tips - 1, (2, 64))
                got = fitch.fitch_scores(pc.vectors, pc.costs, n1, n2)
                want = fitch.fitch_edge_scores_plain(
                    pc.vectors, pc.costs, torch.as_tensor(n1, device=device),
                    torch.as_tensor(n2, device=device))
                check(torch.equal(got, want),
                      f"{what}: P2 edge scores differ from the plain version")
                check(np.array_equal(pc.edge_scores_batch(n1, n2),
                                     ph.edge_scores_batch(n1, n2))
                      and pc.edge_score(root.clv_index, root.back.clv_index)
                      == ph.edge_score(root.clv_index, root.back.clv_index)
                      and pc.root_score(root.clv_index)
                      == ph.root_score(root.clv_index),
                      f"{what}: FastParsimony scores on the card differ")
            order = shuffled_order(tips, seed)
            back, finals = stepwise_pair(card, order)
            hback, hfinals, want = (
                parsimony_cpu_side(seed, cfg) if cpu_refs is None
                else cpu_refs.result()["parsimony"][seed, cfg])
            check(torch.equal(back.cpu(), hback)
                  and torch.equal(finals.cpu(), hfinals),
                  f"{what}: the device build on the card differs from the "
                  "CPU's")
            if tips <= ENGINES_UP_TO:
                labels = [f"t{i}" for i in range(tips)]
                for engine in ("device", "host"):
                    got = fastparsimony_stepwise(card, labels, seed,
                                                 engine=engine)
                    got = (got[1], ut.export_newick(got[0].root))
                    check(got == want, f"{what}: fastparsimony_stepwise "
                                       f"{engine} on the card {got[0]} vs "
                                       f"the CPU {want[0]}")
            n += 1
    for tips, sites, states in ((10, 200, 4), (30, 500, 20)):
        rng = np.random.default_rng(tips)
        charmap = maps.pll_map_nt if states == 4 else maps.pll_map_aa
        codes = DNA_CODES if states == 4 else PROTEIN_CODES
        seqs = ["".join(rng.choice(list(codes), sites)) for _ in range(tips)]
        sm = rng.integers(1, 6, (states, states)).astype(np.float64)
        sm = (sm + sm.T) / 2
        np.fill_diagonal(sm, 0)
        ops, avail = [], list(range(tips))
        while len(avail) > 1:
            a, b = (avail.pop(int(rng.integers(len(avail))))
                    for _ in range(2))
            ops.append((tips + len(ops), a, b))
            avail.append(ops[-1][0])
        recops = [(ops[-1][0], ops[-1][0])] + [
            (ch, p) for p, c1, c2 in reversed(ops) for ch in (c1, c2)
            if ch >= tips]
        out = []
        for dev in (device, cpu):
            sank = Parsimony(tips, states, sites, sm, tips - 1, tips - 1,
                             device=dev)
            for i, s in enumerate(seqs):
                sank.set_sequence(i, charmap, s)
            out.append((sank.build(ops), sank.sbuffer.cpu(),
                        sank.reconstruct(charmap, recops)))
        check(out[0][0] == out[1][0] and torch.equal(out[0][1], out[1][1])
              and out[0][2] == out[1][2],
              f"Sankoff {tips} x {sites} x {states}: the card "
              f"{out[0][0]!r} vs the CPU {out[1][0]!r}")
        n += 1
    return n


# P3's plan forced at three of phase 24's configurations (seed 0: three
# DNA partitions, two of 20 states and one, and 63 words at 200 taxa):
# its tables in device memory over the plan's grid and over three blocks,
# in shared memory over five
COMMIT_FORCED = (("global", None), ("global", 3), ("shared", 5))
COMMIT_FORCED_CASES = tuple(PARSIMONY_SMALL[i] for i in (4, 6, 7))
PAST_BUDGET = (3000, 300)  # taxa x sites whose walk tables exceed a block's


def check_commit_plans(device):
    """P3 under each of COMMIT_FORCED: the device build of each of
    COMMIT_FORCED_CASES (seed 0) by the kernels, its ``back``,
    ``edge_rows``, final scores, rows and costs equal to the build under
    P3's own plan (which phase 24 holds against the plain version at
    every launch).  Returns the configurations checked."""
    import torch

    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search.stepwise import direction_rows
    from libpll_tpu_torch.utils.rng import shuffled_order

    def build(cfg):
        rows = direction_rows(parsimony_parts(*cfg, 0, device))
        return (*fitch.stepwise_build(rows, shuffled_order(cfg[0], 0)),
                *(t for pair in rows for t in pair))

    n = 0
    for cfg in COMMIT_FORCED_CASES:
        want = build(cfg)
        for tables, grid in COMMIT_FORCED:
            with ForcedCommitPlan(tables, grid):
                got = build(cfg)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"P3 {tables} memory, {grid} blocks, {cfg}: the build "
                  f"differs from the one under P3's own plan")
        n += 1
    return n


def past_budget_p3(device, sms, clock_mhz):
    """The device build at PAST_BUDGET (bench_stepwise's data; its walk's
    tables in device memory), its last insertion held against the plain
    version (``last_insertion_p3``)."""
    import torch

    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.utils.rng import shuffled_order

    tips, sites = PAST_BUDGET
    seqs, _ = bench_stepwise_alignment(tips, sites)
    part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4)
    peaks = (sms * LOGIC_PER_SM_CLOCK * clock_mhz * 1e6,
             sms * POPC_PER_SM_CLOCK * clock_mhz * 1e6)
    last = last_insertion_p3(part, shuffled_order(tips, STEPWISE_SEED),
                             peaks)
    check(not last["plan"].shared, f"{tips} taxa: P3's tables fit shared "
                                   f"memory ({last['plan']})")
    del part, last["state"]
    torch.cuda.empty_cache()
    return last


def bench_stepwise_alignment(tips, sites):
    """scripts/bench_stepwise.py's alignment and labels."""
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ACGT"), sites)) for _ in range(tips)]
    return seqs, [f"t{i}" for i in range(tips)]


def newick_digest(tree):
    import hashlib

    from libpll_tpu_torch.search.stepwise import deep_recursion
    from libpll_tpu_torch.tree import utree as ut

    with deep_recursion(tree.tip_count):
        text = ut.export_newick(tree.root)
    return hashlib.sha256(text.encode()).hexdigest(), len(text)


def plain_tree_score(tree, seqs):
    """The tree's Fitch score by the plain versions, on the CPU: a
    FastParsimony of ``seqs`` and the traversal of ``tree`` (tips by their
    labels ``t<i>``)."""
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import deep_recursion
    from libpll_tpu_torch.tree import utree as ut

    part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4,
                                        device="cpu")

    def sidx(node):
        return int(node.label[1:]) if node.is_tip else node.clv_index

    with deep_recursion(tree.tip_count):
        trav = ut.traverse(tree.root)
    part.update_vectors([(x.clv_index, sidx(x.next.back),
                          sidx(x.next.next.back))
                         for x in trav if not x.is_tip])
    return part.edge_score(sidx(tree.root), sidx(tree.root.back))


def phase_stepwise(device):
    """Phase 25: fastparsimony_stepwise at STEPWISE_CASES on
    scripts/bench_stepwise.py's data, the device engine (P2 + P3) and the
    host engine (P1 + P2), each with the counters at 0 before it and read
    after it: both equal libpll_tpu's score and Newick (STEPWISE_JAX), the
    score re-derived by the plain Fitch of the final tree on the CPU, the
    counters show which kernels ran.  Returns per case the wall times, the
    launches and the peak device memory."""
    import torch

    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import fastparsimony_stepwise

    counters = (fitch.fitch_waves, fitch.fitch_scores, fitch.stepwise_commit)
    out = {}
    for tips, sites in STEPWISE_CASES:
        seqs, labels = bench_stepwise_alignment(tips, sites)
        part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4)
        res = {"words": part.vectors.shape[-1]}
        want = STEPWISE_JAX[(tips, sites)]
        engines = ("device", "host") if (tips, sites) in (
            STEPWISE_HOST_CASES) else ("device",)
        for engine in engines:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            for kernel in counters:
                kernel.launches = 0
            t0 = time.perf_counter()
            tree, score = fastparsimony_stepwise([part], labels,
                                                 STEPWISE_SEED, engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: kernel.launches
                        for k, kernel in zip(("P1", "P2", "P3"), counters)}
            digest, length = newick_digest(tree)
            check((score, digest, length) == want,
                  f"stepwise {tips} x {sites} {engine}: score {score}, "
                  f"Newick {digest[:16]}.. of {length} chars; libpll_tpu "
                  f"{want[0]}, {want[1][:16]}.. of {want[2]}")
            # device: P2 a insertion, P3 a insertion plus the star and
            # the final; host: P1 a call (the star, each insertion, the
            # final tree), P2 a insertion plus the final edge score
            ran = ({"P1": 0, "P2": tips - 3, "P3": tips - 1}
                   if engine == "device" else
                   {"P1": tips - 1, "P2": tips - 2, "P3": 0})
            check(launches == ran, f"stepwise {tips} x {sites} {engine}: "
                                   f"launches {launches}, want {ran}")
            res[engine] = {"s": wall, "launches": launches,
                           "peak": torch.cuda.max_memory_allocated() - held}
        plain = plain_tree_score(tree, seqs)
        check(plain == score, f"stepwise {tips} x {sites}: the plain Fitch "
                              f"of the final tree {plain} vs {score}")
        res["score"] = score
        out[(tips, sites)] = res
        d, h = res["device"], res.get("host")
        print(f"[25 stepwise] {tips} taxa x {sites} sites (ACGT, "
              f"default_rng(7), seed {STEPWISE_SEED}, {res['words']} words "
              f"a state): score {score}, Newick sha256 {want[1][:16]}.. "
              f"({want[2]} chars), libpll_tpu's; the plain Fitch of "
              f"the final tree {plain}; device engine {d['s']:.3f} s "
              f"(launches {d['launches']}, peak "
              f"{d['peak'] / 2**20:.1f} MiB)" + (
                  f", host engine {h['s']:.3f} s (launches "
                  f"{h['launches']})" if h else ", host engine not run "
                  "here"), flush=True)
        del part
        torch.cuda.empty_cache()
    return out


# integer operations a word position of S states: a Fitch step 5S logic
# (S and and S - 1 or for the union, 3S for the parent's words, one not)
# and one popcount; an insertion score 7S logic (a Fitch step, then the
# union against the far end) and two popcounts
FITCH_LOGIC, INSERT_LOGIC = 5, 7


def fitch_bound(peaks, logic, popc, nbytes):
    """(ms, "operations" or "bytes"): integer logic ops and popcounts at
    ``peaks`` (per second, each on its own pipe: the larger time), bytes at
    HBM_BYTES_PER_S."""
    ops_ms = max(logic / peaks[0], popc / peaks[1]) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def fitch_work(peaks, words, states, edges=0, rows=0, ops=0):
    """The bound of ``edges`` insertion scores (two rows read each),
    ``rows`` refreshed rows (a clean child read, the row written) and
    ``ops`` Fitch ops (two children read, the parent written), each row
    ``states`` x ``words`` words, 16 bytes of indices and costs each."""
    row = states * words * 4
    logic = words * states * (INSERT_LOGIC * edges + FITCH_LOGIC
                              * (rows + ops))
    popc = words * (2 * edges + rows + ops)
    nbytes = (2 * edges * row + 2 * rows * row + 3 * ops * row
              + 16 * (edges + rows + ops))
    return fitch_bound(peaks, logic, popc, nbytes)


def refresh_levels(back, co1, co2, n, first):
    """(rows, dependent levels) of the refresh from rows first..first+2
    on the topology ``back`` (host numpy): the chain P3 walks."""
    rows, levels, level = 0, 0, [first, first + 1, first + 2]
    while level:
        rows += len(level)
        levels += 1
        level = [d for r in level if back[r] >= n
                 for d in (co1[back[r]], co2[back[r]])]
    return rows, levels


def max_diff(a, b):
    """Largest |a - b| of two int32 tensors of uint32 bits, as an int."""
    from libpll_tpu_torch.ops import fitch

    return int((fitch._uint(a) - fitch._uint(b)).abs().max())


def event_ms(fn, prepare=None, iters=5):
    """Median ms of ``fn()`` on the card's clock over ``iters`` runs, CUDA
    events around each with the card idle before it (``prepare()`` first,
    outside the events): the call's whole time, its host work included."""
    import torch

    times = []
    for _ in range(iters):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def busy_event_ms(fn, prepare=None, iters=5):
    """Median device ms of ``fn()`` by CUDA events with the card kept busy
    (``torch.cuda._sleep``) while the host issues the call, so that the
    events bracket its kernels back to back and not the host's issue
    (``prepare()`` first, outside the events)."""
    import torch

    times = []
    for _ in range(iters):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of the card's clock
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class DeviceMs(float):
    """A device time in ms, with how it was measured (``by``)."""

    def __new__(cls, ms, by):
        out = super().__new__(cls, ms)
        out.by = by
        return out


def profiled_ms(fn, name, prepare=None, iters=5, sessions=3):
    """Device ms a call of the kernels whose name holds ``name`` inside
    ``fn()``, from torch.profiler over ``iters`` calls (``prepare()``
    before each): the kernels' own time, without the host's.  A session
    opens with one call and a mark (``torch.cuda._sleep``'s spin_kernel),
    and counts only the kernels after the mark: the profiler misses some
    of a session's first kernels.  Every kernel's launches counted must be
    a whole number a call (it has also dropped some late in a long
    process); after ``sessions`` sessions that fail this,
    ``busy_event_ms`` of the call, which also holds the host's work after
    a blocking copy.  Returns a ``DeviceMs`` whose ``by`` says which, and
    says so on stdout at the fallback."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters + 1):
                if prepare is not None:
                    prepare()
                fn()
                if i == 0:
                    torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        marks = [i for i, (*_, k) in enumerate(spans) if "spin_kernel" in k]
        after = spans[marks[-1] + 1:] if marks else []
        mine = [(s, e, k) for s, e, k in after if name in k]
        counts = collections.Counter(k for *_, k in mine)
        if mine and all(c % iters == 0 for c in counts.values()):
            return DeviceMs(sum(e - s for s, e, _ in mine) / 1e3 / iters,
                            "profiler")
    ms = busy_event_ms(fn, prepare, iters)
    print(f"[profiler] {name or 'kernels'}: launches counted over {iters} "
          f"calls {dict(counts) if marks else 'none (no mark)'}, not a "
          f"whole number a call: {ms:.4f} ms by CUDA events with the card "
          f"kept busy", flush=True)
    return DeviceMs(ms, "CUDA events, the card kept busy, the host's work "
                        "after a blocking copy included")


def kernel_ms(prof, names):
    """{name: (device ms in all, launches)} of the profiler's kernel
    events whose name holds each of ``names``; and the device's idle share
    over the span of all kernel events."""
    import torch

    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    check(spans, "the profiler recorded no kernel on the card")
    out = {}
    for name in names:
        mine = [(s, e) for s, e, k in spans if name in k]
        out[name] = (sum(e - s for s, e in mine) / 1e3, len(mine))
    busy = sum(e - s for s, e, _ in spans)
    span = max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
    return out, 1.0 - busy / span


def plain_build(parts, order):
    """The device build by the plain versions alone, on the parts' device
    (P2's plain sum and P3's plain version, step by step).  Returns the
    final scores."""
    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search.stepwise import direction_rows

    rows = direction_rows(parts)
    topo = fitch.stepwise_topology(order, parts[0].device)
    fitch.stepwise_commit_plain(rows, *topo, mode="star")
    for i in range(3, len(order)):
        fitch.stepwise_commit_plain(
            rows, *topo, mode="insert", insertion=i, tip=order[i],
            scores=insert_scores_plain(rows, topo, i, order[i]))
    return fitch.stepwise_commit_plain(rows, *topo, mode="final")


def last_insertion_p3(part, order, peaks):
    """P3 at the last insertion of the device build of ``part`` in
    ``order``: the state before it built by the kernels, then P3 and its
    plain version on clones of it (exactly equal), P3's device time by
    torch.profiler (5 calls), the plain version's by CUDA events, the rows
    and dependent levels it refreshes and its bound.  Returns a dict."""
    import torch

    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search import stepwise as sw

    tips = len(order)
    device = part.vectors.device
    s, w = part.vectors.shape[1:]
    rows = sw.direction_rows([part])
    topo = fitch.stepwise_topology(order, device)
    plan = fitch.plan_for(rows, tips)
    work = fitch.commit_workspace(plan, 1, tips, device)
    scores = torch.empty(2 * tips - 3, dtype=torch.int32, device=device)
    fitch.stepwise_commit(rows, *topo, mode="star", plan=plan, work=work)
    for i in range(3, tips - 1):
        fitch.fitch_scores(*rows[0], topo[1][:2 * i - 3], back=topo[0],
                           tip=order[i], out=scores[:2 * i - 3])
        fitch.stepwise_commit(rows, *topo, mode="insert", scores=scores,
                              insertion=i, tip=order[i], plan=plan, work=work)
    i, tip = tips - 1, order[tips - 1]
    fitch.fitch_scores(*rows[0], topo[1][:2 * i - 3], back=topo[0], tip=tip,
                       out=scores[:2 * i - 3])
    kw = dict(mode="insert", scores=scores, insertion=i, tip=tip)
    trial = {}

    def reset():  # the state before the last insertion, afresh
        trial["rows"] = [(v.clone(), c.clone()) for v, c in rows]
        trial["topo"] = (topo[0].clone(), topo[1].clone()) + topo[2:]

    ms = profiled_ms(lambda: fitch.stepwise_commit(
        trial["rows"], *trial["topo"], plan=plan, work=work, **kw),
        "stepwise_commit_kernel", reset)
    plain_ms = event_ms(lambda: fitch.stepwise_commit_plain(
        trial["rows"], *trial["topo"], **kw), reset)
    reset()
    err = commit_pair(trial["rows"], trial["topo"], **kw)[1]
    co1, co2 = fitch._ring_co_tables(tips)
    n_rows, levels = refresh_levels(trial["topo"][0].cpu().numpy(), co1, co2,
                                    tips, tips + 3 * (i - 2))
    check(n_rows == 2 * i - 1, f"the last insertion refreshed {n_rows} "
                               f"rows, not {2 * i - 1}")
    return dict(ms=ms, plain_ms=plain_ms, err=err, rows=n_rows,
                levels=levels, bound=fitch_work(peaks, w, s, rows=n_rows),
                plan=plan, words=w, state=(rows, topo, scores))


def stepwise_profile(part, labels, seed, peaks):
    """A device build of ``part`` under torch.profiler: P2's and P3's
    device time and launches, the device's idle share, the build's wall
    time, and P3's bound over the build ((n - 1)^2 - 1 rows refreshed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libpll_tpu_torch.search import stepwise as sw

    tips = len(labels)
    s, w = part.vectors.shape[1:]
    names = ("fitch_scores_kernel", "stepwise_commit_kernel")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sw.StepwiseBuilder([part], labels).build_device(seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if any(e.device_type == torch.autograd.DeviceType.CUDA
           for e in prof.events()):
        by_name, idle = kernel_ms(prof, names)
    else:  # not measured: the profiler recorded no kernel
        by_name, idle = {k: (float("nan"), 0) for k in names}, float("nan")
    refreshed = (tips - 1) ** 2 - 1
    edges = sum(2 * i - 3 for i in range(3, tips))
    return dict(p2=by_name[names[0]], p3=by_name[names[1]], idle=idle,
                wall=wall, refreshed=refreshed,
                p2_bound=fitch_work(peaks, w, s, edges=edges),
                p3_bound=fitch_work(peaks, w, s, rows=refreshed))


def stepwise_text(prof):
    """``stepwise_profile``'s numbers as text."""
    (p2_ms, p2_n), (p3_ms, p3_n) = prof["p2"], prof["p3"]
    p2, p3 = prof["p2_bound"], prof["p3_bound"]
    return (f"P2 {p2_n} launches, {p2_ms / max(p2_n, 1) * 1e3:.2f} us a "
            f"launch ({p2_ms:.2f} ms in all, bound {p2[0]:.2f} ms ({p2[1]}),"
            f" {p2[0] / p2_ms * 100:.1f}%); P3 {p3_n} launches, "
            f"{p3_ms / max(p3_n, 1) * 1e3:.2f} us a launch ({p3_ms:.2f} ms "
            f"in all, {prof['refreshed']} rows refreshed, bound {p3[0]:.2f} "
            f"ms ({p3[1]}), {p3[0] / p3_ms * 100:.2f}%); device idle "
            f"{prof['idle'] * 100:.1f}% of the kernels' span; the build "
            f"{prof['wall']:.3f} s wall under the profiler")


class ForcedWaveGrid:
    """While active, P1 splits the words over ``grid`` blocks
    (``ops.fitch.wave_grid``; None: its own) and, unless ``staged``, reads
    its table from device memory (``ops.fitch.wave_smem`` 0)."""

    def __init__(self, grid, staged=True):
        from libpll_tpu_torch.ops import fitch

        self.fitch, self.grid, self.staged = fitch, grid, staged
        self.real = fitch.wave_grid, fitch.wave_smem

    def __enter__(self):
        if self.grid:
            self.fitch.wave_grid = lambda vectors: self.grid
        if not self.staged:
            self.fitch.wave_smem = lambda *args: 0
        return self

    def __exit__(self, *exc):
        self.fitch.wave_grid, self.fitch.wave_smem = self.real


def check_wave_grids(part, levels, what):
    """P1 over ``levels`` on clones of ``part``'s rows at one block, at
    ``ops.fitch.wave_grid``'s count and at a ragged split (3, 5, 7 or 9
    blocks, the first that does not divide the words), and at its own
    count with the table left in device memory: one launch each, every
    row and cost equal to ``fitch_run_waves_plain``'s.  Returns the block
    counts (0: its own, unstaged)."""
    import torch

    from libpll_tpu_torch.ops import fitch

    vec = part.vectors
    table, offsets = fitch.wave_table(levels, vec.shape[0])
    want = (vec.clone(), part.costs.clone())
    fitch.fitch_run_waves_plain(*want, torch.from_numpy(table).to(
        vec.device), offsets)
    words = vec.shape[2]
    grids = tuple(dict.fromkeys((1, fitch.wave_grid(vec), next(
        g for g in (3, 5, 7, 9) if words % g)))) + (0,)
    for grid in grids:
        v, c = vec.clone(), part.costs.clone()
        before = fitch.fitch_waves.launches
        with ForcedWaveGrid(grid or None, staged=grid > 0):
            fitch.fitch_waves(v, c, levels)
        check(fitch.fitch_waves.launches == before + 1
              and torch.equal(v, want[0]) and torch.equal(c, want[1]),
              f"P1 over {what} at {grid} blocks ({words} words): "
              f"{fitch.fitch_waves.launches - before} launches, rows equal "
              f"{torch.equal(v, want[0])}, costs equal "
              f"{torch.equal(c, want[1])} to the plain version's")
    return grids


def phase_stepwise_times(device, card, sms, clock_mhz, runs):
    """Phase 26: at the first of STEPWISE_CASES, a device build under
    torch.profiler (P2's and P3's device time a launch, the device's idle
    share, each against its bound over the build); at the largest, the
    state before the last insertion, where P2 and P3 and their plain
    versions run on clones of the same state, and the final tree's
    traversal by P1 and its plain version: each kernel's device time by
    the profiler (and the wrapper's whole call by CUDA events), each plain
    version's time by CUDA events with the card idle before the call,
    host work included; each against its bound from this run's work
    (integer logic at 64 and popcounts at 16 a clock and SM, bytes at
    3.35 TB/s); a whole build at 200 x 2 000 by the plain versions and by
    the kernels.  Returns the numbers the JSON line takes."""
    import torch

    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.search import stepwise as sw
    from libpll_tpu_torch.search.parsimony import FastParsimony, _group_levels
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.rng import shuffled_order

    peaks = (sms * LOGIC_PER_SM_CLOCK * clock_mhz * 1e6,
             sms * POPC_PER_SM_CLOCK * clock_mhz * 1e6)
    for tips, sites in STEPWISE_CASES[:1]:
        seqs, labels = bench_stepwise_alignment(tips, sites)
        part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4)
        prof = stepwise_profile(part, labels, STEPWISE_SEED, peaks)
        run = runs[(tips, sites)]
        host = (f"host engine {run['host']['s']:.3f} s" if "host" in run
                else "host engine not run")
        print(f"[26 stepwise times] {card}: {tips} x {sites}: device build "
              f"{run['device']['s']:.3f} s wall, {host}; under the profiler "
              + stepwise_text(prof), flush=True)

    # the largest case up to its last insertion
    tips, sites = STEPWISE_CASES[0]
    seqs, labels = bench_stepwise_alignment(tips, sites)
    part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4)
    s, w = part.vectors.shape[1:]
    order = shuffled_order(tips, STEPWISE_SEED)
    last = last_insertion_p3(part, order, peaks)
    # P2 at the same state
    rows, topo, scores = last["state"]
    i, tip = tips - 1, order[tips - 1]
    ne = 2 * i - 3
    u = topo[1][:ne]

    def p2_run():
        return fitch.fitch_scores(*rows[0], u, back=topo[0], tip=tip,
                                  out=scores[:ne])

    def p2_plain():
        return fitch.fitch_insert_scores_plain(
            *rows[0], rows[0][0][tip], u.long(), topo[0][u.long()].long())

    err = {"p2": max_diff(p2_run(), p2_plain()), "p3": last["err"]}
    check(err["p2"] == 0, f"P2 at the last insertion differs from its "
                          f"plain version by {err['p2']}")
    ms = {"p2": profiled_ms(p2_run, "fitch_scores_kernel"),
          "p2_call": event_ms(p2_run), "p2_plain": event_ms(p2_plain),
          "p3": last["ms"], "p3_plain": last["plain_ms"]}
    last_rows, last_levels = last["rows"], last["levels"]
    bounds = {"p2": fitch_work(peaks, w, s, edges=ne), "p3": last["bound"]}

    # P1 over the final tree's traversal
    tree, _ = sw.StepwiseBuilder([part], labels).build_device(STEPWISE_SEED)
    with sw.deep_recursion(tips):
        ops = ut.create_pars_buildops(ut.traverse(tree.root))
    levels = _group_levels(ops)
    table, offsets = fitch.wave_table(levels, part.vectors.shape[0])
    table = torch.from_numpy(table).to(device)
    p1 = {}

    def reset_p1():
        p1["v"], p1["c"] = part.vectors.clone(), part.costs.clone()

    def p1_run():
        fitch.fitch_waves(p1["v"], p1["c"], levels)

    ms["p1"] = profiled_ms(p1_run, "fitch_wave_kernel", reset_p1)
    ms["p1_call"] = event_ms(p1_run, reset_p1)
    ms["p1_plain"] = event_ms(lambda: fitch.fitch_run_waves_plain(
        p1["v"], p1["c"], table, offsets), reset_p1)
    reset_p1()
    p1_run()
    got = (p1["v"], p1["c"])
    reset_p1()
    fitch.fitch_run_waves_plain(p1["v"], p1["c"], table, offsets)
    err["p1"] = max(max_diff(got[0], p1["v"]), max_diff(got[1], p1["c"]))
    check(err["p1"] == 0, f"P1 over the final tree differs from its plain "
                          f"version by {err['p1']}")
    bounds["p1"] = fitch_work(peaks, w, s, ops=len(ops))
    # P1 at forced block counts: the final tree (4 states) and a random
    # 150-taxon tree over 20 states
    grids = {"4 states": (w, check_wave_grids(part, levels,
                                              "the final tree"))}
    prot = parsimony_parts(150, 2000, 20, True, 1, 0, device)[0]
    prot_tree = ut.parse_newick_string(random_newick(
        150, np.random.default_rng(26)))
    prot_levels = _group_levels(ut.create_pars_buildops(
        ut.traverse(prot_tree.root)))
    grids["20 states"] = (prot.vectors.shape[2], check_wave_grids(
        prot, prot_levels, "a 150-taxon tree at 20 states"))
    del prot
    print(f"[26 stepwise times] {card}: {tips} x {sites}, the last "
          f"insertion ({ne} candidate edges, {last_rows} rows refreshed in "
          f"{last_levels} dependent levels; P3 {last['plan'].grid} blocks of "
          f"{last['words']} words, tables in "
          f"{'shared' if last['plan'].shared else 'device'} memory), "
          f"each kernel's device time a call (torch.profiler, 5 calls, "
          f"unless said) against its plain version's time a call (CUDA "
          f"events with the card idle before it, host work included, median"
          f" of 5): P2 {ms['p2'] * 1e3:.2f} us ({ms['p2'].by}; the wrapper's"
          f" whole call "
          f"{ms['p2_call'] * 1e3:.2f} us) vs plain {ms['p2_plain'] * 1e3:.2f}"
          f" us, bound {bounds['p2'][0] * 1e3:.3f} us ({bounds['p2'][1]}); "
          f"P3 {ms['p3'] * 1e3:.2f} us ({ms['p3'].by}) vs plain "
          f"{ms['p3_plain']:.3f} ms, "
          f"bound {bounds['p3'][0] * 1e3:.3f} us ({bounds['p3'][1]}); P1 "
          f"over the final tree ({len(ops)} ops in {len(levels)} waves) "
          f"{ms['p1']:.4f} ms ({ms['p1'].by}; the wrapper's whole call "
          f"{ms['p1_call']:.4f} "
          f"ms; one launch, {fitch.wave_grid(part.vectors)} blocks) vs plain "
          f"{ms['p1_plain']:.4f} ms, bound "
          f"{bounds['p1'][0] * 1e3:.3f} us ({bounds['p1'][1]}); P1 at forced "
          f"block counts equal to the plain version, one launch each: "
          + "; ".join(f"{k} ({words} words) at {', '.join(map(str, g))} "
                      f"blocks (0: its own, the table in device memory)"
                      for k, (words, g) in grids.items()),
          flush=True)

    # a whole build at a small size: the kernels, then the plain versions
    small = (200, 2000)
    seqs, _ = bench_stepwise_alignment(*small)
    order = shuffled_order(small[0], STEPWISE_SEED)
    small_part = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4)
    walls = []
    for build in (lambda: fitch.stepwise_build(
            sw.direction_rows([small_part]), order)[2],
            lambda: plain_build([small_part], order)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        finals = build()
        torch.cuda.synchronize()
        walls.append(((time.perf_counter() - t0) * 1e3, finals))
    check(torch.equal(walls[0][1], walls[1][1]),
          "the small build by the plain versions differs from the kernels'")
    print(f"[26 stepwise times] {card}: a whole device build at {small[0]} "
          f"x {small[1]}: kernels {walls[0][0]:.1f} ms, plain versions "
          f"{walls[1][0]:.1f} ms (wall, the card synchronised at the ends)",
          flush=True)
    del part, rows, p1, small_part
    torch.cuda.empty_cache()
    big = runs[STEPWISE_CASES[0]]
    return {"ms": ms, "bounds": bounds, "err": err,
            "launches": {**big["device"]["launches"],
                         "P1": runs[STEPWISE_HOST_CASES[0]]["host"][
                             "launches"]["P1"]}}


# ---------------------------------------------------------- branch lengths
BLOPT_TIPS = 14  # phase 27's trees (12-16 taxa)
BLOPT_SITES = 301
BLOPT_PERTURB = 2.5  # every branch length times this before optimising
BLOPT_SWEEPS = 2
BLOPT_LOGL_REL, BLOPT_LEN_REL = 1e-10, 1e-7  # kernel vs plain path, f64
# (scale mode, states, rate categories) of phase 27's random op tables;
# S = 5 takes U1's instance for any alphabet
REPLAY_SMALL = tuple((mode, s, c) for mode in (0, 1, 2) for s in (4, 20)
                     for c in (1, 2, 3, 4, 8)) + ((1, 5, 3), (2, 5, 2))


class ReplayHook:
    """While active, every U1 launch (``ops.clv.replay_ops`` on a CUDA
    tensor) is held against the plain executor on copies of its inputs,
    on the card: float64 CLVs rel F64_REL of each (row, rate, site)
    block's largest entry with the scalers equal, float32 by phase 3's
    rule (``sweep_close``).  Counts the launches it checked."""

    def __init__(self):
        from libpll_tpu_torch.ops import clv as clv_ops

        self.clv_ops = clv_ops
        self.real = clv_ops.replay_ops
        self.checked = 0
        self.f32_err = 0.0

    def __enter__(self):
        self.clv_ops.replay_ops = self.replay
        return self

    def __exit__(self, *exc):
        self.clv_ops.replay_ops = self.real

    def replay(self, clv, scalers, ops, pmatrix, scale_mode=1):
        import torch

        if clv.device.type != "cuda":
            return self.real(clv, scalers, ops, pmatrix, scale_mode)
        table = ops.cpu().numpy() if torch.is_tensor(ops) else ops
        want_clv, want_scal = clv.clone(), scalers.clone()
        self.clv_ops.update_partials_by_op(want_clv, want_scal, table,
                                           pmatrix, scale_mode)
        launches = self.real.launches
        self.real(clv, scalers, ops, pmatrix, scale_mode)
        check(self.real.launches == launches + (len(table) > 0),
              "replay_ops did not launch U1")
        torch.cuda.synchronize()
        what = (f"U1 {tuple(clv.shape)} {clv.dtype} mode {scale_mode}, "
                f"{len(table)} ops")
        if clv.dtype == torch.float64:
            ok, err = rows_close(clv, want_clv, F64_REL)
            check(ok and torch.equal(scalers, want_scal),
                  f"{what}: CLVs rel {err}, scalers equal "
                  f"{torch.equal(scalers, want_scal)}")
        else:
            ok, err, agree = replay_close_f32(clv, scalers, want_clv,
                                              want_scal)
            check(ok, f"{what}: CLVs rel {err}, scalers agree {agree}")
            self.f32_err = max(self.f32_err, err)
        self.checked += 1


def replay_close_f32(clv, scalers, want_clv, want_scal):
    """Phase 3's float32 rule (``sweep_close``) for an op table's buffers:
    the scalers agree at >= F32_SCALER_AGREE of their entries, and at the
    sites whose scalers all agree every CLV entry is within F32_RTOL of
    its (row, rate, site) block's largest.  Returns (ok, largest relative
    error, share of scalers that agree)."""
    import torch

    same = scalers == want_scal
    agree = float(same.double().mean())
    site_ok = same.reshape(-1, same.shape[-1]).all(dim=0)
    got, want = (t[..., site_ok].double() for t in (clv, want_clv))
    # as sweep_close: a block's largest entry counts as at least float32's
    # smallest normal (below it float32 keeps fewer than 24 bits)
    span = want.abs().amax(dim=-2, keepdim=True).clamp_min(
        torch.finfo(torch.float32).tiny)
    err = float(((got - want).abs() / span).max()) if got.numel() else 0.0
    return err <= F32_RTOL and agree >= F32_SCALER_AGREE, err, agree


class PlainKernels:
    """While active, U1 and N1 take their plain versions on the card: the
    Partition's and the sweep's op tables run ``update_partials_by_op``,
    the Newton solves ``newton_solve_plain`` (after ``update_sumtable``
    where the sweep hands N1 the edge's rows)."""

    def __init__(self):
        from libpll_tpu_torch.ops import clv as clv_ops
        from libpll_tpu_torch.ops import derivatives as dv

        self.clv_ops, self.dv = clv_ops, dv
        self.real = (clv_ops.replay_ops, dv.newton_solve,
                     dv.newton_solve_rows)

    def __enter__(self):
        import torch

        clv_ops, dv = self.clv_ops, self.dv

        def replay(clv, scalers, ops, pmatrix, scale_mode=1):
            table = ops.cpu().numpy() if torch.is_tensor(ops) else ops
            clv_ops.update_partials_by_op(clv, scalers, table, pmatrix,
                                          scale_mode)

        def rows(clv_parent, clv_child, scaler_parent, scaler_child,
                 freqs_pc, left_pc, right_pc, t0, *rest,
                 site_scalers=(None, None), per_rate=False, **kw):
            st = dv.update_sumtable(clv_parent, clv_child, scaler_parent,
                                    scaler_child, freqs_pc, left_pc,
                                    right_pc, per_rate)
            rates, pinv, evals, rw, inv, pw = rest
            return dv.newton_solve_plain(st, t0, rates, pinv, evals,
                                         freqs_pc, rw, inv, pw,
                                         *site_scalers, **kw)

        clv_ops.replay_ops = replay
        dv.newton_solve = dv.newton_solve_plain
        dv.newton_solve_rows = rows
        return self

    def __exit__(self, *exc):
        (self.clv_ops.replay_ops, self.dv.newton_solve,
         self.dv.newton_solve_rows) = self.real


def blopt_wrappers():
    """U1's and N1's wrappers, which keep the counts even while
    ``ReplayHook`` or ``PlainKernels`` stands in for them."""
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops import derivatives as dv

    return clv_ops._replay_ops, dv._newton_solve


def reset_blopt_counters():
    for wrapper in blopt_wrappers():
        wrapper.launches = 0


def blopt_counters():
    """(U1 launches, N1 launches) since the last reset, after a sync."""
    import torch

    torch.cuda.synchronize()
    return tuple(w.launches for w in blopt_wrappers())


def tree_lengths(tree):
    """{pmatrix index: length} of every edge."""
    return {m.pmatrix_index: m.length for n in tree.nodes
            for m in ([n] if n.is_tip else n.ring())}


def scaled_tree(newick, factor):
    """The tree of ``newick`` with every branch length times ``factor``."""
    from libpll_tpu_torch.tree import utree as ut

    tree = ut.parse_newick_string(newick)
    for n in tree.nodes:
        for m in ([n] if n.is_tip else n.ring()):
            m.length = m.length * factor
    return tree


def lengths_close(got, want, rel):
    """(ok, largest relative difference) of two {edge: length} maps."""
    err = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    return got.keys() == want.keys() and err <= rel, err


def run_blopt(mode, tree, part, pidx, **kw):
    """One optimiser on ``tree`` and ``part``, its counters at 0 around it:
    (logL, sweeps, lengths, (U1, N1) launches, seconds)."""
    from libpll_tpu_torch.engine import blopt

    reset_blopt_counters()
    t0 = time.perf_counter()
    if mode == "host":
        logl, sweeps = blopt.optimize_branch_lengths(
            tree, part, pidx, max_sweeps=BLOPT_SWEEPS, **kw)
    else:
        logl, sweeps = blopt.optimize_branch_lengths_scan(
            tree, part, pidx, max_sweeps=BLOPT_SWEEPS,
            graphed=mode == "graphed", **kw)
    counts = blopt_counters()
    return logl, sweeps, tree_lengths(tree), counts, time.perf_counter() - t0


def random_op_table(rng, n, tips, inner, matrices, scalers):
    """``n`` random ops over ``tips + inner`` rows (parents inner), with
    hazards of every kind; scaler indices in [0, scalers)."""
    ops = np.empty((n, 8), np.int32)
    ops[:, 0] = rng.integers(tips, tips + inner, n)
    ops[:, [2, 5]] = rng.integers(0, tips + inner, (n, 2))
    ops[:, [3, 6]] = rng.integers(0, matrices, (n, 2))
    ops[:, [1, 4, 7]] = rng.integers(0, scalers, (n, 3))
    return ops


# U1's plan forced in phase 27 as (lanes a site, ops staged at once; None:
# ops.clv.replay_plan's own): one lane a site (several rates a lane), two
# lanes with one op a window (two buffers: the next op staged while one
# computes), nothing staged (the table and matrices through L1/L2)
REPLAY_FORCED = ((1, None), (2, 1), (None, 0))
SWEEP_CHECKED = 8  # phase 27: bench_infer-shaped sweep tables checked
SWEEP_TIMED = 512  # phase 29: bench_infer-shaped sweep tables timed
SWEEP_PLAIN = 16  # phase 29: the plain executor's tables timed


class ForcedReplayPlan:
    """While active, U1 runs with ``lanes`` lanes a site and ``window`` ops
    staged at once (None: ``ops.clv.replay_plan``'s own), its grid and
    shared memory laid out for them by ``ops.clv.replay_layout``."""

    def __init__(self, lanes=None, window=None):
        from libpll_tpu_torch.ops import clv as clv_ops

        self.clv_ops, self.lanes, self.window = clv_ops, lanes, window
        self.real = clv_ops.replay_plan

    def __enter__(self):
        real, lanes, window = self.real, self.lanes, self.window

        def replay_plan(sites, rate_cats, states, sms, n_ops=8, itemsize=4):
            plan = real(sites, rate_cats, states, sms, n_ops, itemsize)
            return self.clv_ops.replay_layout(
                sites, rate_cats, states, lanes or plan.lanes,
                plan.window if window is None else window, n_ops, itemsize)
        self.clv_ops.replay_plan = replay_plan
        return self

    def __exit__(self, *exc):
        self.clv_ops.replay_plan = self.real


def random_replay_inputs(rng, device):
    """REPLAY_SMALL x float64, float32 draws of U1's random inputs from
    ``rng``: (scale mode, dtype, CLVs, scalers, P-matrices, a table of 40
    ops), over rows whose products shrink and scale."""
    import torch

    tips, inner, m, sites = 5, 6, 9, 203
    for mode, s, c in REPLAY_SMALL:
        for dtype in (torch.float64, torch.float32):
            clv = np.zeros((tips + inner, c, s, sites))
            clv[:tips + 1] = rng.uniform(
                0.05, 1, (tips + 1, 1, s, sites)) * 10.0 ** rng.uniform(
                    -60 if dtype == torch.float64 else -12, 0,
                    (tips + 1, 1, 1, sites))
            # rows summing below one: the products shrink, and scale
            pm = rng.uniform(0.05, 1, (m, c, s, s)) / s
            shape = ((inner + 1, sites) if mode == 1 else
                     (inner + 1, c, sites) if mode == 2 else (1, sites))
            ops = random_op_table(rng, 40, tips, inner, m, inner + 1)
            yield (mode, dtype, torch.tensor(clv, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=torch.int32, device=device),
                   torch.tensor(pm, dtype=dtype, device=device), ops)


def replay_random(hook, rng, device, forced=()):
    """U1 under ``hook`` on random_replay_inputs, each a host table of 40
    ops and a device table of 7 padded to 16 (repeats); then each table
    again under each of ``forced``'s plans (ForcedReplayPlan) from the
    same state, its CLVs and scalers equal bit for bit to those of U1's
    own plan.  Returns the forced launches."""
    import torch

    from libpll_tpu_torch.ops.incremental import pad_op_table

    n = 0
    for mode, dtype, cl, sc, p, ops in random_replay_inputs(rng, device):
        for table in (ops, torch.from_numpy(pad_op_table(
                ops[:7], 16)).to(device)):
            starts = [(cl.clone(), sc.clone()) for _ in forced]
            hook.replay(cl, sc, table, p, mode)
            for plan, (fc, fs) in zip(forced, starts):
                with ForcedReplayPlan(*plan):
                    hook.real(fc, fs, table, p, mode)
                check(torch.equal(fc, cl) and torch.equal(fs, sc),
                      f"U1 {tuple(cl.shape)} {dtype} mode {mode} under "
                      f"(lanes, window) {plan}: CLVs equal "
                      f"{torch.equal(fc, cl)}, scalers equal "
                      f"{torch.equal(fs, sc)} to U1's own plan's")
                n += 1
    return n


def replay_second_draw(replay, device, hook=None, seed=27):
    """U1 on the second draw of random_replay_inputs(default_rng(seed))
    (phase 27's random tables are the first).  Float64 tables, where
    ``hook`` is given, through it (the 40-op host table and the padded
    device table).  Float32 host tables by U1 (``replay``, some checkout's
    ``ops.clv.replay_ops``) and by the plain executor on the card and on
    the CPU, each pair held by phase 3's float32 rule
    (``replay_close_f32``).  Returns, for each float32 table, (mode, S, C,
    U1 vs the card's plain executor, U1 vs the CPU's, the card's vs the
    CPU's) as (largest relative error, share of scalers that agree), and
    a SHA-256 of U1's float32 outputs."""
    import hashlib

    import torch

    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops.incremental import pad_op_table

    rows, digest = [], hashlib.sha256()
    rng = np.random.default_rng(seed)
    for _ in random_replay_inputs(rng, device):
        pass
    for mode, dtype, cl, sc, p, ops in random_replay_inputs(rng, device):
        if dtype == torch.float64:
            if hook is not None:
                hook.replay(cl, sc, ops, p, mode)
                hook.replay(cl, sc, torch.from_numpy(
                    pad_op_table(ops[:7], 16)).to(device), p, mode)
            continue
        card = (cl.clone(), sc.clone())
        clv_ops.update_partials_by_op(*card, ops, p, mode)
        host = (cl.to("cpu", copy=True), sc.to("cpu", copy=True))
        clv_ops.update_partials_by_op(*host, ops, p.cpu(), mode)
        host = tuple(t.to(device) for t in host)
        replay(cl, sc, ops, p, mode)
        torch.cuda.synchronize()
        digest.update(cl.cpu().numpy().tobytes())
        digest.update(sc.cpu().numpy().tobytes())
        rows.append((mode, cl.shape[2], cl.shape[1]) + tuple(
            replay_close_f32(*a, *b)[1:] for a, b in
            (((cl, sc), card), ((cl, sc), host), (card, host))))
    return rows, digest.hexdigest()[:16]


def sweep_shape_case(device, seed=29):
    """A branch-length sweep's U1 tables at scripts/bench_infer.py's shape:
    a random tree of BENCH_INFER_TIPS taxa, its validity flags set as after
    a full evaluation, and its sweep's tables (``blopt.sweep_tables``: an
    edge's re-orientation ops padded by repeats to one capacity, the next
    power of two at or above the sweep's longest table and at least 8 --
    32 slots at this tree, where infer_tree's sweeps see 8-64 -- the flags
    replayed), over float32 buffers of the Partition's rows at
    BENCH_INFER_SITES sites (4 rates x 4 states, per-site scaling): random
    CLVs, a tenth of the tips' sites tiny so that products scale, random
    P-matrices whose rows sum below one.  Returns (clv, scalers, pmatrix,
    the tables on the card [E, slots, 8] and on the host)."""
    import torch

    from libpll_tpu_torch.engine import blopt
    from libpll_tpu_torch.tree import incremental as inc
    from libpll_tpu_torch.tree import utree as ut

    tips, sites = BENCH_INFER_TIPS, BENCH_INFER_SITES
    rng = np.random.default_rng(seed)
    tree = ut.parse_newick_string(random_newick(tips, rng))
    inc.mark_valid(ut.traverse(tree.root))
    tables = blopt.sweep_tables(tree.root, tips - 2)[0]
    gen = torch.Generator(device=device).manual_seed(seed)
    clv = torch.rand((2 * tips - 2, 4, 4, sites), generator=gen,
                     device=device) * 0.95 + 0.05
    tiny = torch.rand((tips, 1, 1, sites), generator=gen,
                      device=device) < 0.1
    clv[:tips] *= torch.where(tiny, 1e-12, 1.0)
    scalers = torch.zeros((tips - 1, sites), dtype=torch.int32,
                          device=device)
    pmatrix = torch.rand((2 * tips - 3, 4, 4, 4), generator=gen,
                         device=device) / 4
    return clv, scalers, pmatrix, torch.from_numpy(tables).to(device), \
        tables


def replay_bytes(table, row, scal_row, mat, scaled=True):
    """The bytes one U1 launch of ``table`` (host [K, 8]) must move: each
    CLV row it reads before writing it once, each row it writes once, the
    scaler rows likewise (when ``scaled``), each distinct P-matrix set
    and the table; padded repeats (an op equal to the one before it whose
    parent is none of its inputs) add nothing."""
    written, read, swritten, sread, mats = set(), set(), set(), set(), set()
    prev = None
    for op in table.tolist():
        p, ps, c1, m1, s1, c2, m2, s2 = op
        if op == prev and p not in (c1, c2) and ps not in (s1, s2):
            continue
        prev = op
        read |= {c for c in (c1, c2) if c not in written}
        sread |= {c for c in (s1, s2) if c not in swritten}
        written.add(p)
        swritten.add(ps)
        mats |= {m1, m2}
    scal = (len(sread) + len(swritten)) * scal_row if scaled else 0
    return (len(read) + len(written)) * row + scal + len(mats) * mat \
        + table.size * 4


def check_blopt_small(device):
    """Phase 27: U1 against the plain executor at every launch (``ReplayHook``)
    of phase 20's configurations (setters, full traversal, ``pad_to``, an op
    list that rewrites a buffer, in float64 and float32) and of random op
    tables (every scale mode, S 4/20/5, C 1-8, host and device tables, a
    padded one), each again under REPLAY_FORCED's plans (equal bit for bit
    to U1's own plan's), and the first
    SWEEP_CHECKED of a bench_infer-shaped sweep's tables
    (``sweep_shape_case``: 16 384 sites, float32); N1 with blopt's rule
    (``abs_d2``) against its plain twin
    (``newton_close``'s rule, from the sumtable and from the rows) from t0
    near and far from the optimum; both blopt optimisers (the scan eager and
    as a CUDA graph) on the card against the CPU Partition, at
    ``BLOPT_TIPS`` taxa.  Returns a summary dict."""
    import torch

    from libpll_tpu_torch import Operation, Partition
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.ops import derivatives as dv

    cpu = torch.device("cpu")
    out = {}
    with ReplayHook() as hook:
        for seed, (name, kw) in enumerate(PARTITION_SMALL):
            for dtype in (torch.float64, torch.float32):
                part, tree, ops, pidx = partition_case(device, dtype, seed,
                                                       **kw)
                tips = part.tips
                part.update_partials(ops[-3:], pad_to=7)
                part.update_partials(
                    [Operation(tips, 0, 0, 0, -1, 1, 1, -1),
                     Operation(tips + 1, 1, tips, 2, 0, 2, 2, -1),
                     Operation(tips, -1, 3, 3, -1, 4, 4, -1),
                     Operation(tips + 2, 2, tips, 5, -1, tips + 1, 6, 1)])
                part.update_partials(ops)
        out["partition_launches"] = hook.checked
        out["forced"] = replay_random(hook, np.random.default_rng(27),
                                      device, REPLAY_FORCED)
        # the second draw: float32 U1 within phase 3's rule of the plain
        # executor on the CPU, which sums in dot_n's order; the card's
        # (cuBLAS) sums in another, and read rel 1.005e-5 against both on
        # one table (PERF.md section 7)
        f32, _ = replay_second_draw(hook.real, device, hook)
        for mode, states, rates, _, (err, agree), _ in f32:
            check(err <= F32_RTOL and agree >= F32_SCALER_AGREE,
                  f"U1 float32 mode {mode} S {states} C {rates}, 40 ops, "
                  f"second draw: rel {err} against the plain executor on "
                  f"the CPU, "
                  f"scalers agree {agree}")
        out["second"] = {
            "f32": len(f32),
            "equal": sum(r[4] == (0.0, 1.0) for r in f32),
            "u1_cpu": max(r[4][0] for r in f32),
            "u1_card": max(r[3][0] for r in f32),
            "card_cpu": max(r[5][0] for r in f32)}
        out["random_launches"] = hook.checked - out["partition_launches"]
        # bench_infer's sweep tables: the first ones, real ops 1-3
        clv, scal, pm, tables, host = sweep_shape_case(device)
        for e in range(SWEEP_CHECKED):
            hook.replay(clv, scal, tables[e], pm, 1)
        out["sweep_real_ops"] = sorted({int((np.diff(
            host[e], axis=0) != 0).any(1).sum()) + 1
            for e in range(SWEEP_CHECKED)})
        del clv, scal, pm, tables
        torch.cuda.empty_cache()
        out["launches"] = hook.checked
        out["u1_f32_err"] = hook.f32_err

        # N1 with blopt's rule, from t0 near and far from the optimum
        n1, parted = 0, 0
        newick = caterpillar_newick(24)
        for states in (4, 20):
            for rate_cats in (1, 4):
                for dtype in (torch.float32, torch.float64):
                    for variant in ("site", "rate", "pinv"):
                        args, rows = newton_inputs(variant, newick, rate_cats,
                                                   states, dtype, device,
                                                   seed=rate_cats, rows=True)
                        far = (1e-4, 3.0, 30.0) if dtype == torch.float64 \
                            else (3.0,)
                        for t0 in (float(args["t0"][0]),) + far:
                            a = dict(args, t0=torch.tensor(
                                [t0], dtype=dtype, device=device))
                            r = dict(rows, t0=a["t0"])
                            want = dv.newton_solve_plain(**a, abs_d2=True)
                            for form in (a, r):
                                run = (dv.newton_solve if form is a
                                       else dv.newton_solve_rows)
                                got = run(**form, abs_d2=True)
                                err = abs(float(got.t) - float(want.t))
                                ok = (err <= 1e-10 * abs(float(want.t))
                                      and int(got.iterations)
                                      == int(want.iterations)
                                      if dtype == torch.float64 else
                                      err <= F32_T_REL * abs(float(want.t)))
                                check(ok, f"N1 |d2| rule {variant} S={states}"
                                          f" C={rate_cats} {dtype} t0 {t0}: "
                                          f"t* {float(got.t)!r} vs plain "
                                          f"{float(want.t)!r}")
                                n1 += 1
                            parted += float(dv.newton_solve_plain(
                                **a).t) != float(want.t)
        check(parted > 0, "the |d2| rule never changed t*")
        out["n1"], out["n1_parted"] = n1, parted

        # both optimisers on the card against the CPU
        rng = np.random.default_rng(15)
        newick = random_newick(BLOPT_TIPS, rng)
        seqs = ["".join(rng.choice(list("ACGT"), BLOPT_SITES))
                for _ in range(BLOPT_TIPS)]
        rates = compute_gamma_cats(0.7, 4)
        runs = {}
        for mode in ("host", "scan", "graphed"):
            for where, dev in (("card", device), ("cpu", cpu)):
                if mode == "graphed" and where == "cpu":
                    continue
                tree = scaled_tree(newick, BLOPT_PERTURB)
                part = Partition(BLOPT_TIPS, BLOPT_TIPS - 2, 4, BLOPT_SITES,
                                 1, 2 * BLOPT_TIPS - 3, 4, BLOPT_TIPS - 2,
                                 dtype=torch.float64, device=dev)
                part.set_subst_params(0, [1.1, 2.6, 0.8, 1.3, 2.9, 1.0])
                part.set_frequencies(0, [0.28, 0.26, 0.22, 0.24])
                part.set_category_rates(rates)
                for node in tree.nodes:
                    if node.is_tip:
                        part.set_tip_states(node.clv_index, maps.pll_map_nt,
                                            seqs[int(node.label[1:])])
                if mode == "graphed":
                    hook.__exit__()  # a capture reads nothing back
                    try:
                        runs[mode, where] = run_blopt(
                            mode, tree, part, [0] * 4)
                    finally:
                        hook.__enter__()
                else:
                    runs[mode, where] = run_blopt(mode, tree, part,
                                                    [0] * 4)
        for mode in ("host", "scan", "graphed"):
            got = runs[mode, "card"]
            want = runs["host" if mode == "host" else "scan", "cpu"]
            ok, err = lengths_close(got[2], want[2], BLOPT_LEN_REL)
            check(ok and abs(got[0] - want[0]) <= BLOPT_LOGL_REL * abs(
                want[0]) and got[1] == want[1] and min(got[3]) > 0,
                  f"blopt {mode} on the card: logL {got[0]!r}, sweeps "
                  f"{got[1]}, launches {got[3]} vs the CPU {want[0]!r}, "
                  f"{want[1]}; lengths rel {err}")
        out["runs"] = {k: (v[0], v[1], v[3]) for k, v in runs.items()}
        out["checked"] = hook.checked
    return out


def top_kernels(prof, count):
    """The ``count`` kernels of a profile with the most device time, as
    (name cut to 60 characters, ms in all, launches)."""
    import torch

    totals = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = totals.get(e.name, (0.0, 0))
            totals[e.name] = (t + (e.time_range.end - e.time_range.start)
                              / 1e3, n + 1)
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:count]
    return [(name[:60], t, n) for name, (t, n) in ranked]


def flagship_blopt_partition(device):
    """Phase 21's float64 Partition of the flagship alignment (PHYLIP,
    compression) and its tree: (part, tree newick, pidx, pattern count)."""
    import torch

    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_RATE_CATS,
                                                 FLAGSHIP_SITES,
                                                 FLAGSHIP_TIPS)

    c = FLAGSHIP_RATE_CATS
    tree, _, _, (params, freqs), patterns, weights, _ = \
        read_phylip_flagship(FLAGSHIP_TIPS, FLAGSHIP_SITES)
    rates = (compute_gamma_cats(1.0, c), np.full(c, 1.0 / c))
    part = flagship_partition(device, torch.float64, tree, patterns, weights,
                              params[None], freqs[None], rates)
    return part, ut.export_newick(tree.root), tree, np.zeros(c, int), \
        len(patterns[0]), (patterns, weights, params, freqs, rates)


def fresh_logl(part, tree, pidx):
    """The root edge's logL of ``tree`` in ``part`` computed from scratch:
    every P-matrix, a full traversal."""
    from libpll_tpu_torch.tree import utree as ut

    ops, branches, pmat_idx = ut.create_operations(ut.traverse(tree.root))
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    return part.compute_edge_loglikelihood(*edge_of(tree), pidx)


def sweep_shape_times(device, peak):
    """Phase 29's U1 at bench_infer's sweep shape: the first SWEEP_TIMED of
    ``sweep_shape_case``'s tables in turn, U1's device µs a launch
    (``profiled_ms``) against the bytes its tables move (``replay_bytes``)
    and the operations of their real ops at ``peak`` (float32), the plain
    executor's µs a table (CUDA events, SWEEP_PLAIN tables), and the first
    table by U1 and by the plain executor on the same rows (phase 3's
    float32 rule).  Returns a dict of them and U1's plan there."""
    import torch

    from libpll_tpu_torch.ops import clv as clv_ops

    clv, scal, pm, dev_tabs, host_tabs = sweep_shape_case(device)
    sw_plan = clv_ops.replay_plan(BENCH_INFER_SITES, 4, 4,
                                  clv_ops._sms(device.index or 0), 8, 4)

    def sweep_u1():
        for e in range(SWEEP_TIMED):
            clv_ops.replay_ops(clv, scal, dev_tabs[e], pm, 1)

    def sweep_plain():
        for e in range(SWEEP_PLAIN):
            clv_ops.update_partials_by_op(clv, scal, host_tabs[e], pm, 1)

    sweep_ms = profiled_ms(sweep_u1, "replay_kernel", iters=3)
    sweep_plain_ms = event_ms(sweep_plain, iters=3)
    # one table by U1 and by the plain executor on the same rows
    rows = sorted({int(r) for r in host_tabs[0][:, [0, 2, 5]].ravel()})
    before = (clv[rows].clone(), scal.clone())
    clv_ops.replay_ops(clv, scal, dev_tabs[0], pm, 1)
    got = (clv[rows].clone(), scal.clone())
    clv[rows], scal[:] = before
    clv_ops.update_partials_by_op(clv, scal, host_tabs[0], pm, 1)
    ok, sweep_err, agree = replay_close_f32(got[0], got[1], clv[rows], scal)
    check(ok, f"U1 at bench_infer's sweep shape vs the plain executor: rel "
              f"{sweep_err}, scalers agree {agree}")
    sweep_abs = float((got[0] - clv[rows]).abs().max())
    del before, got
    row_b = 4 * 4 * BENCH_INFER_SITES * 4
    n_real = sum(int((np.diff(t, axis=0) != 0).any(1).sum()) + 1
                 for t in host_tabs[:SWEEP_TIMED])
    sweep_bytes = sum(replay_bytes(t, row_b, BENCH_INFER_SITES * 4,
                                   4 * 4 * 4 * 4)
                      for t in host_tabs[:SWEEP_TIMED])
    sweep_bound = bound(n_real * BENCH_INFER_SITES * 4 * 4 * (2 * 7 + 1),
                        sweep_bytes, peak)
    sweep = dict(us=sweep_ms / SWEEP_TIMED * 1e3, by=sweep_ms.by,
                 plain_us=sweep_plain_ms / SWEEP_PLAIN * 1e3,
                 bound_us=sweep_bound[0] / SWEEP_TIMED * 1e3,
                 bound_by=sweep_bound[1], real_ops=n_real / SWEEP_TIMED,
                 err=sweep_abs, plan=sw_plan)
    del clv, scal, pm, dev_tabs
    torch.cuda.empty_cache()
    return sweep


def phase_blopt(device, card, peak):
    """Phases 28-29: branch-length optimisation at the float64 flagship.
    28: the flagship alignment in a float64 Partition (phase 21's build),
    branch lengths times BLOPT_PERTURB; ``optimize_branch_lengths`` and
    ``optimize_branch_lengths_scan`` (eager and ``graphed``), BLOPT_SWEEPS
    sweeps each with its counters at 0 around it (U1 and N1 launched):
    the logL rises and equals a fresh Partition's on the resulting tree
    (rel F64_REL); the same optimisers on the plain versions on the card
    (``PlainKernels``) agree (logL rel BLOPT_LOGL_REL, lengths rel
    BLOPT_LEN_REL); an eager scan sweep runs under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read).  29: U1's
    time for a full ``update_partials`` against its bound and the plain
    executor; ms a sweep and an edge of each optimiser; the device's idle
    share over a sweep of each (torch.profiler).  Returns the numbers the
    JSON line reports."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libpll_tpu_torch.engine import blopt
    from libpll_tpu_torch.engine.evaluate import partition_model
    from libpll_tpu_torch.engine.partition import operations_to_array
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.tree import utree as ut

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    part, newick, base_tree, pidx, sites, data = \
        flagship_blopt_partition(device)
    fresh = flagship_partition(device, torch.float64, base_tree, data[0],
                               data[1], data[2][None], data[3][None],
                               data[4])
    start = scaled_tree(newick, BLOPT_PERTURB)
    logl0 = fresh_logl(part, start, pidx)
    n_edges = 2 * base_tree.tip_count - 3

    # each optimiser on the kernels, then on the plain versions
    real_call = blopt.SweepProgram.__call__

    def no_host_read(self, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_call(self, *args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    runs = {}
    for mode in ("host", "scan", "graphed"):
        tree = scaled_tree(newick, BLOPT_PERTURB)
        if mode == "scan":
            blopt.SweepProgram.__call__ = no_host_read
        try:
            runs[mode] = run_blopt(mode, tree, part, pidx)
        finally:
            blopt.SweepProgram.__call__ = real_call
        logl, sweeps, lens, counts, secs = runs[mode]
        want = fresh_logl(fresh, tree, pidx)
        check(logl > logl0 and abs(logl - want) <= F64_REL * abs(want)
              and min(counts) > 0,
              f"flagship blopt {mode}: logL {logl0!r} -> {logl!r} "
              f"({sweeps} sweeps, launches (U1, N1) {counts}), a fresh "
              f"Partition on the result {want!r}")
        runs[mode] += (want,)
    plain = {}
    with PlainKernels():
        for mode in ("host", "scan"):
            tree = scaled_tree(newick, BLOPT_PERTURB)
            plain[mode] = run_blopt(mode, tree, part, pidx)
    for mode in ("host", "scan", "graphed"):
        got = runs[mode]
        want = plain["host" if mode == "host" else "scan"]
        ok, err = lengths_close(got[2], want[2], BLOPT_LEN_REL)
        check(ok and abs(got[0] - want[0]) <= BLOPT_LOGL_REL * abs(want[0])
              and want[3] == (0, 0),
              f"flagship blopt {mode}: kernels {got[0]!r} vs plain "
              f"{want[0]!r} (plain launches {want[3]}), lengths rel {err}")
        runs[mode] += (err, abs(got[0] - want[0]) / abs(want[0]))
    print(f"[28 blopt flagship] {base_tree.tip_count} taxa x {sites} "
          f"patterns GTR+G4 float64 Partition, {n_edges} edges, lengths x"
          f"{BLOPT_PERTURB}: start logL {logl0!r}; " + "; ".join(
              f"{d} {runs[d][0]!r} in {runs[d][1]} sweeps ({runs[d][4]:.2f} "
              f"s, launches (U1, N1) {runs[d][3]}; fresh Partition "
              f"{runs[d][5]!r}; vs plain: logL rel {runs[d][7]:.3e}, lengths "
              f"rel {runs[d][6]:.3e})" for d in runs)
          + f"; plain host loop {plain['host'][4]:.2f} s, plain scan "
          f"{plain['scan'][4]:.2f} s; an eager scan sweep under "
          f"set_sync_debug_mode('error'): no host read", flush=True)

    # 29: U1 on a full traversal, against the plain executor and its bound
    trav = ut.traverse(start.root)
    ops, branches, pmat_idx = ut.create_operations(trav)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    table = operations_to_array(ops, part.scale_buffers)
    dev_table = torch.from_numpy(table).to(device)
    snap = (part.clv.clone(), part.scalers.clone())

    def u1():
        clv_ops.replay_ops(part.clv, part.scalers, dev_table, part.pmatrix,
                           part.scale_mode)

    def u1_plain():
        clv_ops.update_partials_by_op(part.clv, part.scalers, table,
                                      part.pmatrix, part.scale_mode)

    u1_plain()
    want_clv = part.clv.clone()
    part.clv.copy_(snap[0])
    part.scalers.copy_(snap[1])
    reset_blopt_counters()
    u1()
    check(blopt_counters()[0] == 1, "U1: one launch a table")
    u1_err = float((part.clv - want_clv).abs().max())
    ok, rel = rows_close(part.clv, want_clv, F64_REL)
    check(ok, f"flagship U1 vs the plain executor: rel {rel}")
    del want_clv, snap
    torch.cuda.empty_cache()
    ms = {"u1": time_ms(u1, iters=10, warmup=2)[0],
          "u1_plain": time_ms(u1_plain, iters=3, warmup=1)[0],
          "part_update": time_ms(lambda: part.update_partials(ops), iters=10,
                                 warmup=2)[0]}
    row = part.clv[0].numel() * part.clv.element_size()
    written, read_first = set(), set()
    for p, _, c1, _, _, c2, _, _ in table.tolist():
        read_first |= {c for c in (c1, c2) if c not in written}
        written.add(p)
    scal_row = part.scalers[0].numel() * 4
    u1_bytes = (len(read_first) + len(written)) * row \
        + len(written) * scal_row + part.pmatrix.numel() * 8
    s, c = part.states, part.rate_cats
    u1_flop = len(table) * sites * c * s * (2 * (2 * s - 1) + 1)
    # float64 work: the FP64 vector peak is half the FP32 one (data sheet)
    u1_bound = bound(u1_flop, u1_bytes, peak / 2)
    per_op = 3 * len(table) * row / HBM_BYTES_PER_S * 1e3

    sweep = sweep_shape_times(device, peak)

    # ms a sweep and an edge: the host loop (one sweep, less the full
    # evaluation it starts with), the scan program eager and as a graph on
    # one sweep's inputs; the idle share over a sweep of each
    tree = scaled_tree(newick, BLOPT_PERTURB)
    blopt._full_evaluation(tree, part, pidx)
    tab, er, t0, _ = blopt.sweep_tables(tree.root, part.scale_buffers)
    tab, er = (torch.from_numpy(a).to(device) for a in (tab, er))
    t0 = torch.from_numpy(t0).to(device)
    program = blopt.make_sweep_program(part.nodes, part.scale_buffers,
                                       tab.shape[1], sites=sites,
                                       scale_mode=part.scale_mode)
    model = partition_model(part, pidx)
    graph = program.graphed(part.clv, part.scalers, part.pmatrix, model,
                            tab, er, t0)

    def host_sweep():
        blopt.optimize_branch_lengths(scaled_tree(newick, BLOPT_PERTURB),
                                      part, pidx, max_sweeps=1)

    sweeps = {"host": host_sweep,
              "scan": lambda: program(part.clv, part.scalers, part.pmatrix,
                                      model, tab, er, t0),
              "graphed": lambda: graph(model, tab, er, t0)}
    full_ms = event_ms(lambda: fresh_logl(part, start, pidx), iters=3)
    times, idle = {}, {}
    for mode, fn in sweeps.items():
        times[mode] = event_ms(fn, iters=3) - (
            full_ms if mode == "host" else 0.0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        idle[mode] = kernel_ms(prof, ())[1]
        if mode == "graphed":
            top = top_kernels(prof, 8)
    del graph
    print(f"[29 blopt times] {card}: U1 full update_partials ({len(table)} "
          f"ops, float64, {sites} patterns) {ms['u1']:.4f} ms vs bound "
          f"{u1_bound[0]:.4f} ms ({u1_bound[1]}: {len(read_first)} rows read"
          f" once, {len(written)} written; {per_op:.4f} ms at three rows an "
          f"op), {u1_bound[0] / ms['u1'] * 100:.1f}% of it; plain "
          f"update_partials_by_op {ms['u1_plain']:.4f} ms; "
          f"Partition.update_partials (host table) {ms['part_update']:.4f} "
          f"ms; U1 vs plain max abs {u1_err:.3e}; a sweep of {n_edges} edges"
          f" (the host loop less the {full_ms:.2f} ms full evaluation it "
          f"starts with; the scan program on one sweep's tables, cap "
          f"{tab.shape[1]}): " + ", ".join(
              f"{d} {times[d]:.2f} ms ({times[d] / n_edges:.4f} ms an edge, "
              f"device idle {idle[d] * 100:.1f}%)" for d in times)
          + "; CUDA events, median of 3; a graphed sweep's longest kernels "
          "(torch.profiler, ms a sweep, launches): " + "; ".join(
              f"{name} {t:.3f} ({n})" for name, t, n in top), flush=True)
    print(f"[29 blopt times] {card}: U1 at scripts/bench_infer.py's sweep "
          f"shape ({BENCH_INFER_TIPS} taxa x {BENCH_INFER_SITES} sites, "
          f"float32, 4 rates, per-site scaling; sweep_shape_case's first "
          f"{SWEEP_TIMED} edges' tables, {sweep['real_ops']:.2f} real ops "
          f"a table; plan: {sweep['plan'].lanes} lanes a site, "
          f"{sweep['plan'].window} ops staged in {sweep['plan'].smem} B, "
          f"{sweep['plan'].grid} blocks of {clv_ops.REPLAY_THREADS} "
          f"threads): {sweep['us']:.2f} us a launch ({sweep['by']}) vs bound "
          f"{sweep['bound_us']:.3f} us ({sweep['bound_by']}: the rows a table "
          f"reads once and writes, its scaler rows and matrices), "
          f"{sweep['bound_us'] / sweep['us'] * 100:.1f}% of it; the plain "
          f"executor {sweep['plain_us']:.1f} us a table (CUDA events, "
          f"{SWEEP_PLAIN} tables, host work included); one table vs the "
          f"plain executor max abs {sweep['err']:.3e}", flush=True)
    out = dict(ms=ms, u1_bound=u1_bound, u1_err=u1_err, times=times,
               idle=idle, launches=runs["scan"][3][0], sweep=sweep)
    del part, fresh
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- tree search
SPR_TIPS, SPR_SITES = 1024, 16384  # scripts/bench_spr.py's defaults
SPR_PRUNE, SPR_RADIUS, SPR_CAP, SPR_BATCH = 64, 3, 128, 32
SCORER_RADIUS = 4  # phase 30's SPR neighbourhoods
SCORER_BRUTE = 6  # candidates a case checked by a fresh evaluation
SCORER_BRUTE_ATOL = 1e-8  # float64, tests/test_spr_search.py's
# phase 30's configurations beyond phase 20's: five states (tip CLVs) at
# eight rates, and eight rates per-rate with +I
SCORER_EXTRA = (("five_states", {"states": 5, "tip_clv": True,
                                 "rate_cats": 8}),
                ("eight_rates", {"rate_cats": 8, "scaling": "rate",
                                 "pinv": 0.2}))
SCORER_POOL_CAPS = (0, 1)  # pool slots that force spills (float64 cases)


class PoolCap:
    """While active, C1's scoring instance gets at most ``slots`` pool
    slots (``ops.incremental.score_layout`` capped), so that rows spill."""

    def __init__(self, slots):
        from libpll_tpu_torch.ops import incremental as inc_ops

        self.inc_ops, self.slots = inc_ops, slots
        self.real = inc_ops.score_layout

    def __enter__(self):
        def capped(*args):
            tile, slots, smem = self.real(*args)
            return tile, min(slots, self.slots), smem
        self.inc_ops.score_layout = capped
        return self

    def __exit__(self, *exc):
        self.inc_ops.score_layout = self.real


def written_rows(table, n_nodes, n_scalers, scale_mode):
    """The scratch CLV and scaler rows a candidate's op table writes
    (C1's rule: skipped repeats write nothing)."""
    from libpll_tpu_torch.ops import incremental as inc_ops

    clv_rows, scal_rows, prev = [], [], None
    for op in table.tolist():
        scaled = scale_mode != 0 and op[1] != n_scalers
        if prev is None or not inc_ops._repeats(op, prev, scaled):
            clv_rows.append(op[0] - n_nodes)
            if scaled:
                scal_rows.append(op[1] - n_scalers - 1)
        prev = op
    return clv_rows, scal_rows


class ScorerHook:
    """While active, every launch of C1's scoring instance
    (``ops.incremental.score_candidates`` on a CUDA tensor) is held against
    the plain scorer (``score_candidates_plain``) on the same inputs on the
    card: the logL float64 rel F64_REL, float32 within the budget
    (``logl_close``); and C1's replay instance (``replay_candidates``) on
    the same tables against its plain version over the scratch rows the
    tables write: float64 CLVs rel F64_REL of each (row, rate, site)
    block's largest entry and the scalers equal, float32 by phase 3's rule
    (``replay_close_f32``).  Counts the scoring launches it checked; keeps
    the largest |d logL| and CLV errors."""

    def __init__(self):
        from libpll_tpu_torch.ops import incremental as inc_ops

        self.inc_ops = inc_ops
        self.real = inc_ops.score_candidates
        self.checked = 0
        self.max_abs = 0.0
        self.f32_err = 0.0
        self.logl_err = 0.0

    def __enter__(self):
        self.inc_ops.score_candidates = self.score
        return self

    def __exit__(self, *exc):
        self.inc_ops.score_candidates = self.real

    def score(self, clv, scalers, pmatrix, model, tables, upd_midx, eval_rows,
              upd_pmatrix, **kw):
        import torch

        args = (clv, scalers, pmatrix, model, tables, upd_midx, eval_rows,
                upd_pmatrix)
        if clv.device.type != "cuda":
            return self.real(*args, **kw)
        want = self.inc_ops.score_candidates_plain(*args, **kw)
        launches = self.real.launches
        got = self.real(*args, **kw)
        check(self.real.launches == launches + 1,
              "score_candidates did not launch C1")
        g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
        what = (f"C1 {tuple(clv.shape)} {clv.dtype} mode "
                f"{kw['scale_mode']} asc {kw['asc_mode']}, {len(g)} "
                f"candidates")
        ok = all(logl_close(x, y, clv.dtype) or (np.isnan(x) and np.isnan(y))
                 for x, y in zip(g, w))
        d = np.abs(g - w)
        d = float(d[np.isfinite(d)].max()) if np.isfinite(d).any() else 0.0
        check(ok, f"{what}: the scoring instance's logL vs the plain "
                  f"scorer's max |d| {d}")
        self.logl_err = max(self.logl_err, d)
        tab, midx = (torch.from_numpy(np.ascontiguousarray(x, np.int32))
                     .to(clv.device) for x in (tables, upd_midx))
        self.replay(clv, scalers, pmatrix, tab, midx, upd_pmatrix,
                    kw["rows"], kw["scale_mode"])
        self.checked += 1
        return got

    def replay(self, clv, scalers, pmatrix, tables, upd_midx, upd_pmatrix,
               rows, scale_mode):
        """C1's replay instance against its plain version on one batch."""
        import torch

        args = (clv, scalers, pmatrix, tables, upd_midx, upd_pmatrix, rows,
                scale_mode)
        want = self.inc_ops.replay_candidates_plain(*args)
        launches = self.inc_ops._replay_candidates.launches
        got = self.inc_ops.replay_candidates(*args)
        check(self.inc_ops._replay_candidates.launches == launches + 1,
              "replay_candidates did not launch C1")
        torch.cuda.synchronize()
        n, ns = clv.shape[0], scalers.shape[0] - 1
        pick = [written_rows(t, n, ns, scale_mode)
                for t in tables.cpu().numpy()]
        g_clv, w_clv = (torch.cat([x[b, c] for b, (c, _) in enumerate(pick)])
                        for x in (got[0], want[0]))
        if scale_mode:
            g_sc, w_sc = (torch.cat([x[b, s] for b, (_, s) in
                                     enumerate(pick)]) for x in (got[1],
                                                                 want[1]))
        else:  # no counters: every site is compared
            g_sc = w_sc = torch.zeros((1, clv.shape[-1]), dtype=torch.int32,
                                      device=clv.device)
        what = (f"C1 replay {tuple(clv.shape)} {clv.dtype} mode {scale_mode}"
                f", {tables.shape[0]} candidates")
        if clv.dtype == torch.float64:
            ok, err = rows_close(g_clv, w_clv, F64_REL)
            check(ok and torch.equal(g_sc, w_sc),
                  f"{what}: CLVs rel {err}, scalers equal "
                  f"{torch.equal(g_sc, w_sc)}")
        else:
            ok, err, agree = replay_close_f32(g_clv, g_sc, w_clv, w_sc)
            check(ok, f"{what}: CLVs rel {err}, scalers agree {agree}")
            self.f32_err = max(self.f32_err, err)
        diff = (g_clv.double() - w_clv.double()).abs()
        self.max_abs = max(self.max_abs, float(diff.max()) if diff.numel()
                           else 0.0)


class PlainScorer:
    """While active, the scorer runs C1's plain version on the card
    (``score_candidates_plain``)."""

    def __enter__(self):
        from libpll_tpu_torch.ops import incremental as inc_ops

        self.inc_ops, self.real = inc_ops, inc_ops.score_candidates
        inc_ops.score_candidates = inc_ops.score_candidates_plain
        return self

    def __exit__(self, *exc):
        self.inc_ops.score_candidates = self.real


def full_state(tree, part, pidx):
    """P-matrices and CLVs of the whole tree, validity flags set."""
    from libpll_tpu_torch.tree import incremental as inc
    from libpll_tpu_torch.tree import utree as ut

    trav = ut.traverse(tree.root)
    ops, branches, pmat_idx = ut.create_operations(trav)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    inc.mark_valid(trav)


def apply_move(item):
    """Apply an encoded candidate's move (SPR: (p, r, ...); NNI: (edge,
    type, ...)); returns its rollback."""
    from libpll_tpu_torch.tree import moves

    if isinstance(item[1], int):
        rb = moves.Rollback(moves.MOVE_NNI)
        moves.nni(item[0], item[1], rollback=rb)
    else:
        rb = moves.Rollback(moves.MOVE_SPR)
        moves.spr(item[0], item[1], rollback=rb)
    return rb


def base_snapshot(part):
    return tuple(t.clone() for t in (part.clv, part.scalers, part.pmatrix))


def base_unchanged(part, snap):
    import torch

    return all(torch.equal(a, b) for a, b in
               zip((part.clv, part.scalers, part.pmatrix), snap))


def check_scorer_small(device):
    """Phase 30: the batched candidate scorer at 9-24 taxa, phase 20's
    Partition configurations (per-site, per-rate and no scaling, +I, the
    asc modes, S 4/20, C 1-4) in float64 and float32, SPR (radius
    SCORER_RADIUS) and NNI candidates: C1 against its plain version at
    every launch (``ScorerHook``), the logL against the scorer on C1's
    plain version on the card (float64 rel F64_REL, float32 the budget)
    and against the same scorer on the CPU Partition, the base buffers
    bit-identical after scoring, and SCORER_BRUTE candidates a case
    (the best among them) against a fresh Partition's full evaluation of
    the moved tree (float64 atol SCORER_BRUTE_ATOL, float32 the budget).
    Then the NaN vote: U1, K2 and C1 with one NaN at state 1 of rate 0 of
    every P-matrix, tiny rows that would scale without it; each kernel's
    counters equal its plain version's.  Returns a summary dict."""
    import torch

    from libpll_tpu_torch.search import spr
    from libpll_tpu_torch.tree import incremental as inc
    from libpll_tpu_torch.tree import moves

    cpu = torch.device("cpu")
    out = {"cases": 0, "candidates": 0, "brute": 0, "logl_err": 0.0}
    with ScorerHook() as hook:
        for seed, (name, kw) in enumerate(PARTITION_SMALL + SCORER_EXTRA):
            for dtype in (torch.float64, torch.float32):
                built = {}
                for where, dev in (("card", device), ("cpu", cpu)):
                    part, tree, _, pidx = partition_case(dev, dtype, seed,
                                                         **kw)
                    full_state(tree, part, pidx)
                    built[where] = part, tree, pidx
                scores = {}
                wheres = ("card", "cpu", "plain") + (
                    tuple(f"spill{k}" for k in SCORER_POOL_CAPS)
                    if dtype == torch.float64 else ())
                for kind in ("spr", "nni"):
                    for where in wheres:
                        part, tree, pidx = built["cpu" if where == "cpu"
                                                 else "card"]
                        cands = (spr.spr_neighborhood(tree, SCORER_RADIUS)
                                 if kind == "spr"
                                 else spr.nni_candidates(tree))
                        enc, n_max = (spr.encode_candidates if kind == "spr"
                                      else spr.encode_nni_candidates)(
                                          tree, cands)
                        cap = max(8, 1 << (n_max - 1).bit_length())
                        snap = base_snapshot(part)
                        scorer = spr.make_round_scorer(part, cap)
                        run = lambda: spr.score_encoded(  # noqa: E731
                            tree, part, pidx, enc, cap, 8, scorer)
                        if where == "plain":
                            with PlainScorer():
                                got = run()
                        elif where.startswith("spill"):
                            with PoolCap(int(where[5:])):
                                got = run()
                        else:
                            got = run()
                        check(base_unchanged(part, snap),
                              f"scorer {name} {dtype} {kind} on the {where}"
                              f": the base buffers changed")
                        scores[kind, where] = np.asarray(got)
                        if where == "card":
                            kept = (enc, pidx)
                    card = scores[kind, "card"]
                    for other in [w for w in wheres if w != "card"]:
                        want = scores[kind, other]
                        ok = len(card) == len(want) > 0 and all(
                            logl_close(g, w, dtype)
                            for g, w in zip(card, want))
                        err = float(np.abs(card - want).max())
                        check(ok, f"scorer {name} {dtype} {kind}: card vs "
                                  f"{other} max |d logL| {err}")
                        if other == "plain":
                            out["logl_err"] = max(out["logl_err"], err)
                    # a fresh Partition's full evaluation of moved trees
                    enc, pidx = kept
                    part, tree, _ = built["card"]
                    fresh = partition_case(device, dtype, seed, **kw)[0]
                    flags = inc.snapshot_flags(list(tree.nodes))
                    for i in np.argsort(card)[::-1][:SCORER_BRUTE]:
                        rb = apply_move(enc[i])
                        want = fresh_logl(fresh, tree, pidx)
                        moves.rollback_move(rb)
                        ok = (abs(card[i] - want) <= SCORER_BRUTE_ATOL
                              if dtype == torch.float64
                              else logl_close(card[i], want, dtype))
                        check(ok, f"scorer {name} {dtype} {kind} candidate "
                                  f"{i}: {card[i]!r} vs a fresh Partition "
                                  f"{want!r}")
                        out["brute"] += 1
                    inc.restore_flags(flags)
                    out["candidates"] += len(card)
                    out["cases"] += 1
        out["launches"] = hook.checked
        out["f32_err"] = hook.f32_err
        out["hook_logl"] = hook.logl_err
    out["nan"] = check_nan_vote(device)
    return out


def nan_rows(rng, rows, c, s, sites, dtype, device):
    """``rows`` CLV rows of uniform(0.5, 1) values times a scale whose
    products fall below the dtype's threshold (1e-40 float64, 1e-6
    float32)."""
    import torch

    tiny = 1e-40 if dtype == torch.float64 else 1e-6
    return torch.tensor(rng.uniform(0.5, 1.0, (rows, c, s, sites)) * tiny,
                        dtype=dtype, device=device)


def check_nan_vote(device):
    """The NaN vote of phase 30: with P[:, 0, 1, :] NaN in every matrix
    (one NaN at state 1 of rate 0 of each product), a span scales only
    where no entry is NaN, as JAX's ``jnp.all(x < thresh)``; U1
    (``replay_ops``), K2 (``fused_sweep``) and C1 (``replay_candidates``) give
    their plain versions' counters, and without the NaN the same inputs
    scale (the check has teeth).  Returns the configurations checked."""
    import torch

    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import incremental as inc_ops

    rng = np.random.default_rng(30)
    n = 0
    c, s, sites = 4, 4, 97
    for dtype in (torch.float64, torch.float32):
        for mode in (1, 2):
            # U1 on a chain of three ops over four tip rows
            ops = np.array([[4, 0, 0, 0, 3, 1, 1, 3],
                            [5, 1, 2, 2, 3, 4, 3, 0],
                            [6, 2, 3, 4, 3, 5, 5, 1]], np.int32)
            shape = (4, sites) if mode == 1 else (4, c, sites)
            pm = torch.tensor(rng.uniform(0.05, 1, (6, c, s, s)) / s,
                              dtype=dtype, device=device)
            nan_pm = pm.clone()
            nan_pm[:, 0, 1, :] = float("nan")
            clv = torch.cat([nan_rows(rng, 4, c, s, sites, dtype, device),
                             torch.zeros((3, c, s, sites), dtype=dtype,
                                         device=device)])
            counts = {}
            for label, p in (("clean", pm), ("nan", nan_pm)):
                want_c, want_s = clv.clone(), torch.zeros(
                    shape, dtype=torch.int32, device=device)
                clv_ops.update_partials_by_op(want_c, want_s, ops, p, mode)
                got_c, got_s = clv.clone(), torch.zeros_like(want_s)
                clv_ops.replay_ops(got_c, got_s, ops, p, mode)
                torch.cuda.synchronize()
                check(torch.equal(got_s, want_s),
                      f"NaN vote U1 {dtype} mode {mode} {label}: counters "
                      f"{int(got_s.sum())} vs plain {int(want_s.sum())}")
                counts[label] = int(want_s.sum())
                n += 1
            check(counts["clean"] > counts["nan"],
                  f"NaN vote U1 {dtype} mode {mode}: nothing scales "
                  f"without the NaN ({counts})")

            # K2 on a small tree, CLV tips of tiny values
            topo, model_np, masks = small_case(random_newick(8, rng), sites,
                                               c, seed=30)
            tp = tip_input(masks, "clv", c, dtype, device) * (
                1e-40 if dtype == torch.float64 else 1e-6)
            kpm = kernel_inputs(topo, model_np, dtype, device, False)[0]
            knan = kpm.clone()
            knan[:, 0, 1, :] = float("nan")
            counts = {}
            for label, p in (("clean", kpm), ("nan", knan)):
                got = cf.fused_sweep(topo.schedule, tp, p, scale_mode=mode,
                                     tip_encoding="clv")[1]
                want = cf.fused_sweep_plain(topo.schedule, tp, p,
                                            scale_mode=mode,
                                            tip_encoding="clv")[1]
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"NaN vote K2 {dtype} mode {mode} {label}: counters "
                      f"{int(got.sum())} vs plain {int(want.sum())}")
                counts[label] = int(want.sum())
                n += 1
            check(counts["clean"] > counts["nan"],
                  f"NaN vote K2 {dtype} mode {mode}: nothing scales "
                  f"without the NaN ({counts})")

            # C1: two candidates over the tip rows, every op's matrices
            # from the overlay, which holds the NaN
            nodes, ns = 4, 3
            tables = torch.tensor(
                [[[4, 4, 0, 0, 3, 1, 1, 3], [5, 5, 2, 2, 3, 4, 0, 4],
                  [5, 5, 2, 2, 3, 4, 0, 4]],
                 [[4, 4, 3, 1, 3, 2, 2, 3], [5, 3, 4, 0, 4, 0, 1, 0],
                  [6, 5, 5, 2, 3, 1, 2, 3]]], dtype=torch.int32,
                device=device)
            midx = torch.tensor([[0, 1, 2], [0, 1, 2]], dtype=torch.int32,
                                device=device)
            base_pm = torch.tensor(rng.uniform(0.05, 1, (3, c, s, s)) / s,
                                   dtype=dtype, device=device)
            scal = torch.zeros((ns + 1,) + shape[1:], dtype=torch.int32,
                               device=device)
            base = nan_rows(rng, nodes, c, s, sites, dtype, device)
            counts = {}
            for label, p in (("clean", pm[:3]), ("nan", nan_pm[:3])):
                over = p[None].expand(2, 3, c, s, s).contiguous()
                args = (base, scal, base_pm, tables, midx, over, 3, mode)
                want = inc_ops.replay_candidates_plain(*args)[1]
                got = inc_ops._replay_candidates(*args)[1]
                torch.cuda.synchronize()
                rows = [written_rows(t, nodes, ns, mode)[1]
                        for t in tables.cpu().numpy()]
                same = all(torch.equal(got[b, r], want[b, r])
                           for b, r in enumerate(rows))
                check(same, f"NaN vote C1 {dtype} mode {mode} {label}: "
                            f"counters differ from the plain version's")
                counts[label] = sum(int(want[b, r].sum())
                                    for b, r in enumerate(rows))
                n += 1
            check(counts["clean"] > counts["nan"],
                  f"NaN vote C1 {dtype} mode {mode}: nothing scales "
                  f"without the NaN ({counts})")
    return n


def spr_partition(device):
    """scripts/bench_spr.py's configuration built with the port: the
    random-join tree of SPR_TIPS taxa and SPR_SITES random ACGT sites from
    ``default_rng(3)``, a float32 Partition, GTR [1.2, 2.4, 0.9, 1.1, 3.0,
    1.0], frequencies [0.3, 0.25, 0.25, 0.2], Γ4 at α = 1.  Returns
    (partition, tree)."""
    import torch

    from libpll_tpu_torch import Partition
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.tree import utree as ut

    tips, sites = SPR_TIPS, SPR_SITES
    rng = np.random.default_rng(3)
    items = [f"t{i}:{rng.uniform(0.05, 0.4):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.4):.4f}")
    tree = ut.parse_newick_string(f"({items[0]},{items[1]},{items[2]});")
    part = Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, 4,
                     tips - 2, dtype=torch.float32, device=device)
    order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
    alpha = np.frombuffer(b"ACGT", np.uint8)
    for i in range(tips):
        seq = alpha[rng.integers(0, 4, sites)].tobytes().decode()
        part.set_tip_states(order[f"t{i}"], maps.pll_map_nt, seq)
    part.set_frequencies(0, [0.3, 0.25, 0.25, 0.2])
    part.set_subst_params(0, [1.2, 2.4, 0.9, 1.1, 3.0, 1.0])
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    return part, tree


def c1_bytes(tables, n_nodes, n_scalers, scale_mode, row, scal_row):
    """C1's bytes on one batch's tables: (each input read once and each
    output written once: the distinct base CLV and scaler rows the real
    ops read and every scratch row they write; the real ops; three rows a
    real op).  The P-matrices are a few KiB and not counted."""
    base, base_scal, written, scal_written = set(), set(), 0, 0
    for t in tables:
        clv_rows, scal_rows = written_rows(t, n_nodes, n_scalers,
                                           scale_mode)
        written += len(clv_rows)
        scal_written += len(scal_rows)
        for op in t.tolist():
            base |= {c for c in (op[2], op[5]) if c < n_nodes}
            if scale_mode and op[1] != n_scalers:
                base_scal |= {s for s in (op[4], op[7]) if s < n_scalers}
    strict = ((len(base) + written) * row
              + (len(base_scal) + scal_written) * scal_row)
    return strict, written, 3 * written * row


def score_bytes(plan, n_scalers, scale_mode, row, scal_row, site_bytes):
    """The scoring instance's bytes on one batch's plan: each input read
    once and each output written once: the distinct base CLV and scaler
    rows its running ops and its edges read, the per-site model vectors
    (``site_bytes``) and the B logLs; no scratch row is written.  The
    P-matrices are a few KiB and not counted."""
    ops, ev = plan.ops.astype(np.int64), plan.eval.astype(np.int64)
    live = ops[..., 0] >= 0

    def base(d):  # the base rows among descriptors
        d = d.ravel()
        return set(d[(d >= 0) & ((d >> 28) == 0)].tolist())

    rows = base(ops[live][:, [2, 5]]) | base(ev[:, [0, 2]])
    scal = set()
    if scale_mode:
        scaled = live & (ops[..., 1] >= 0)
        scal = (base(ops[scaled][:, [4, 7]]) | base(ev[:, [1, 3]])) - {
            n_scalers}
    return (len(rows) * row + len(scal) * scal_row + site_bytes
            + 8 * len(ev))


def op_flop(states):
    """Flops of one replayed op at one site and rate: two contractions of
    S (2S - 1) and the S products."""
    return 2 * states * (2 * states - 1) + states


def fold_flop(states):
    """Flops of the edge fold at one site and rate: the contraction, the
    parent times the frequencies times it and their sum, the rate's
    weight and +I."""
    return states * (2 * states - 1) + 3 * states + 4


def measure_batch(scorer, part, model, batch, cap, peak):
    """One batch of the scorer through C1's scoring instance at its real
    shapes: its logL against the plain scorer's (the largest |d| over the
    real candidates), the kernel's device time (torch.profiler), the whole
    call's time (CUDA events, the host's planning included), the batch's
    card time (every kernel of one scorer call: the P-matrices, C1, the
    asc tail), the plain scorer's time; the replay instance on the same
    tables against its plain version and their times; the plan (slots,
    spills, running ops) and layout; the scoring instance's bound."""
    import torch

    from libpll_tpu_torch.ops import incremental as inc_ops

    b, t, mi, bl, er = batch
    device = part.clv.device
    rows = inc_ops.check_tables(t, mi, er, n_nodes=part.nodes,
                                n_scale_buffers=part.scale_buffers,
                                n_matrices=part.pmatrix.shape[0],
                                capacity=cap, scale_mode=part.scale_mode)
    dtype = part.clv.dtype
    new = inc_ops.compute_pmatrices(
        torch.from_numpy(bl).to(device, dtype).reshape(-1),
        model["rates"], model["prop_invar"], model["params_indices"],
        model["eigenvals"], model["left"], model["right"],
        dtype=dtype).reshape(mi.shape + tuple(part.pmatrix.shape[1:])
                             ).contiguous()
    kw = dict(n_scale_buffers=part.scale_buffers, sites=part.sites,
              scale_mode=part.scale_mode, asc_mode=part.asc_mode, rows=rows)
    args = (part.clv, part.scalers, part.pmatrix, model, t, mi, er, new)

    def run():
        return inc_ops.score_candidates(*args, **kw)

    def plain():
        return inc_ops.score_candidates_plain(*args, **kw)

    got, want = run()[:b].double().cpu().numpy(), plain()[:b].double(
        ).cpu().numpy()
    err = float(np.abs(got - want).max())
    check(all(logl_close(g, w, dtype) for g, w in zip(got, want)),
          f"C1 on a batch of {len(t)}: the scoring instance vs the plain "
          f"scorer max |d logL| {err}")
    ms = {"c1": profiled_ms(run, "score_candidates_kernel"),
          "c1_call": event_ms(run), "c1_plain": event_ms(plain, iters=2),
          "batch_card": profiled_ms(lambda: scorer(
              part.clv, part.scalers, part.pmatrix, model, t, mi, bl, er),
              "")}
    tab, midx = (torch.from_numpy(a).to(device) for a in (t, mi))
    rargs = (part.clv, part.scalers, part.pmatrix, tab, midx, new, rows,
             part.scale_mode)
    ms["c1r"] = time_ms(lambda: inc_ops.replay_candidates(*rargs))[0]
    ms["c1r_plain"] = time_ms(
        lambda: inc_ops.replay_candidates_plain(*rargs), iters=2,
        warmup=1)[0]
    with ScorerHook() as hook:
        hook.replay(*rargs)
    plan, layout = inc_ops.plan_for(part.clv, t, mi, er,
                                    n_scale_buffers=part.scale_buffers,
                                    scale_mode=part.scale_mode)
    row = part.clv[0].numel() * part.clv.element_size()
    scal_row = part.scalers[0].numel() * 4
    site_bytes = part.clv.shape[-1] * (4 + part.clv.element_size())
    nbytes = score_bytes(plan, part.scale_buffers, part.scale_mode, row,
                         scal_row, site_bytes)
    rbytes = c1_bytes(t[:b], part.nodes, part.scale_buffers,
                      part.scale_mode, row, scal_row)
    _, c, s, length = part.clv.shape
    if dtype == torch.float64:
        peak = peak / 2
    flop = (plan.live * op_flop(s) + len(t) * fold_flop(s)) * c * length
    return dict(err=err, replay_err=hook.max_abs, ms=ms, plan=plan,
                layout=layout, bound=bound(flop, nbytes, peak),
                replay_bound=bound(rbytes[1] * op_flop(s) * c * length,
                                   rbytes[0], peak),
                real_ops=rbytes[1], rows=rows, b=b, size=len(t))


def batch_text(m):
    """One line of ``measure_batch``'s numbers."""
    ms, plan, (tile, slots, smem) = m["ms"], m["plan"], m["layout"]
    return (f"batch of {m['size']} ({m['b']} real, {m['real_ops']} real ops,"
            f" {plan.live} run by the scoring instance, pool {plan.slots} "
            f"slots, {plan.spills} spilled; tile {tile} sites, {slots} "
            f"slots, {smem} B shared memory a block): the scoring instance "
            f"{ms['c1']:.4f} ms ({ms['c1'].by}) vs bound "
            f"{m['bound'][0]:.4f} ms "
            f"({m['bound'][1]}), {m['bound'][0] / ms['c1'] * 100:.1f}% of it;"
            f" the whole call {ms['c1_call']:.4f} ms (CUDA events, the host's"
            f" planning included); the batch's card time (every kernel of "
            f"one scorer call) {ms['batch_card']:.4f} ms "
            f"({ms['batch_card'].by}); the plain scorer "
            f"{ms['c1_plain']:.2f} ms; logL vs the plain scorer max |d| "
            f"{m['err']:.3e}; the replay instance {ms['c1r']:.4f} ms vs its "
            f"bound {m['replay_bound'][0]:.4f} ms, its plain version "
            f"{ms['c1r_plain']:.2f} ms, CLV max abs vs plain "
            f"{m['replay_err']:.3e}")


def phase_spr(device, card, peak):
    """Phase 31: SPR scoring at scripts/bench_spr.py's configuration
    (``spr_partition``): a full evaluation (U1), the radius-SPR_RADIUS
    neighbourhood of the first SPR_PRUNE inner nodes, ``encode_candidates``
    on the host, then ``score_encoded`` (capacity SPR_CAP, batches of
    SPR_BATCH) with the launch counters at 0 around it: one C1 launch a
    batch, every score finite, the base buffers bit-identical.  Then the
    host encode time, the scoring's wall time and the device's busy time
    and idle share (torch.profiler), C1's ms a launch against its bound
    and its plain version, on batch 0 (``measure_batch``: the scoring
    instance against the plain scorer and its bound, the batch's card
    time, the replay instance against its plain version), the scoring
    under ``ScorerHook``, and a fresh evaluation of the moved tree (U1
    through ``Partition.update_partials``) for four candidates, the best
    among them, within the f32 budget.  Returns the numbers the JSON line
    reports."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libpll_tpu_torch.engine.evaluate import partition_model
    from libpll_tpu_torch.ops import incremental as inc_ops
    from libpll_tpu_torch.search import spr
    from libpll_tpu_torch.tree import incremental as inc
    from libpll_tpu_torch.tree import moves
    from libpll_tpu_torch.tree import utree as ut

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    part, tree = spr_partition(device)
    pidx = [0] * 4
    full_state(tree, part, pidx)
    logl0 = part.compute_edge_loglikelihood(*edge_of(tree), pidx)
    setup_s = time.perf_counter() - t0
    prune = ut.query_innernodes(tree)[:SPR_PRUNE]
    cands = spr.spr_neighborhood(tree, SPR_RADIUS, prune_nodes=prune)
    enc_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        enc, n_max = spr.encode_candidates(tree, cands)
        enc_times.append(time.perf_counter() - t0)
    enc_ms = float(np.median(enc_times)) * 1e3
    n_ops = np.array([len(e[3]) for e in enc])
    check(len(enc) > 0 and n_max <= SPR_CAP,
          f"SPR: {len(enc)} candidates, n_ops_max {n_max}")
    scorer = spr.make_round_scorer(part, SPR_CAP)
    snap = base_snapshot(part)
    n_batches = -(-len(enc) // SPR_BATCH)

    def score():
        return spr.score_encoded(tree, part, pidx, enc, SPR_CAP, SPR_BATCH,
                                 scorer)

    # the main path, its counters at 0 around it
    inc_ops._score_candidates.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logls = np.asarray(score())
    first_s = time.perf_counter() - t0
    launches = inc_ops._score_candidates.launches
    check(launches == n_batches and len(logls) == len(enc)
          and np.isfinite(logls).all(),
          f"SPR scoring: C1 launches {launches} for {n_batches} batches, "
          f"{len(logls)} scores for {len(enc)} candidates, finite "
          f"{np.isfinite(logls).all()}")
    check(base_unchanged(part, snap), "SPR scoring changed the base buffers")
    del snap

    # where the time of a round's scoring goes
    wall = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        score()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(wall))
    score_ev = event_ms(score, iters=3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        score()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    by, span_idle = kernel_ms(prof, ("score_candidates_kernel",))
    busy = sum((e.time_range.end - e.time_range.start) / 1e3
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    c1_prof = (by["score_candidates_kernel"][0]
               / max(by["score_candidates_kernel"][1], 1))

    # one batch: C1 alone against its plain version and its bound
    batch = next(spr.encoded_batches(
        enc, part.nodes, part.scale_buffers, SPR_CAP, SPR_BATCH))
    b, t, mi, bl, er = batch
    model = partition_model(part, pidx)
    one = measure_batch(scorer, part, model, batch, SPR_CAP, peak)
    ms = one["ms"]
    with ScorerHook() as hook:
        hooked = scorer(part.clv, part.scalers, part.pmatrix, model, t, mi,
                        bl, er)[:b].cpu().numpy()
    check(hook.checked == 1 and np.array_equal(hooked, logls[:b]),
          "SPR batch 0 under the hook: not checked, or other scores")

    # fresh evaluations of moved trees (U1), the best candidate among them
    picks = [int(np.argmax(logls))] + [
        int(i) for i in np.linspace(0, len(enc) - 1, 3).round()]
    brute = []
    flags = inc.snapshot_flags(list(tree.nodes))
    for i in picks:
        rb = apply_move(enc[i])
        want = fresh_logl(part, tree, pidx)
        moves.rollback_move(rb)
        brute.append((i, float(logls[i]), want))
        check(logl_close(logls[i], want, torch.float32),
              f"SPR candidate {i}: scored {logls[i]!r}, a fresh evaluation "
              f"of the moved tree {want!r}")
    inc.restore_flags(flags)
    hist = np.bincount(n_ops)
    print(f"[31 spr] {card}: scripts/bench_spr.py's {SPR_TIPS} taxa x "
          f"{SPR_SITES} sites float32 Partition (set-up {setup_s:.1f} s, "
          f"logL {logl0!r}); radius {SPR_RADIUS} around {SPR_PRUNE} prune "
          f"nodes: {len(cands)} candidates, {len(enc)} encoded, n_ops_max "
          f"{n_max}, real ops a candidate min {n_ops.min()} median "
          f"{np.median(n_ops):g} mean {n_ops.mean():.2f} max {n_ops.max()} "
          f"(count by ops: " + ", ".join(
              f"{k}: {v}" for k, v in enumerate(hist) if v)
          + f"); host encode_candidates {enc_ms:.2f} ms "
          f"({enc_ms / len(enc):.4f} ms a candidate, median of 3); "
          f"score_encoded (capacity {SPR_CAP}, {n_batches} batches of "
          f"{SPR_BATCH}, {launches} C1 launches): first call {first_s * 1e3:.2f}"
          f" ms, wall {wall_ms:.2f} ms ({wall_ms / n_batches:.3f} ms a batch, "
          f"{wall_ms / len(enc) * 1e3:.1f} us a candidate; median of 3), "
          f"CUDA events {score_ev:.2f} ms; under torch.profiler {prof_wall:.2f}"
          f" ms wall, the card busy {busy:.3f} ms ({busy / n_batches:.4f} ms a"
          f" batch), idle {(1 - busy / prof_wall) * 100:.1f}% of the wall and "
          f"{span_idle * 100:.1f}% of the kernels' span; a round's scoring "
          f"(encode + score) {enc_ms + wall_ms:.2f} ms, the host encode "
          f"{enc_ms / (enc_ms + wall_ms) * 100:.1f}% of it; C1's scoring "
          f"instance a launch {c1_prof:.4f} ms over the round (profiler, "
          f"{by['score_candidates_kernel'][1]} of {n_batches} launches "
          f"recorded); "
          f"batch 0: " + batch_text(one) + "; fresh "
          f"evaluations of moved trees (candidate, scored, fresh): "
          + "; ".join(f"{i} {g!r} {w!r}" for i, g, w in brute)
          + f"; best candidate {picks[0]} (+{logls[picks[0]] - logl0:.4f})",
          flush=True)
    out = dict(launches=launches, batch=one)
    del part
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# 32-33: the SPR/NNI rounds and the inference driver
# ---------------------------------------------------------------------------
# tests/test_spr_search.py's simulation: GTR+Γ4 DNA on a random tree
SEARCH_PARAMS = (1.1, 2.6, 0.8, 1.3, 2.9, 1.0)
SEARCH_FREQS = (0.28, 0.26, 0.22, 0.24)
SEARCH_ALPHA, SEARCH_CATS = 0.8, 4
SEARCH_GTR = dict(rate_cats=SEARCH_CATS, alpha=SEARCH_ALPHA,
                  frequencies=SEARCH_FREQS, subst_params=SEARCH_PARAMS)
SEARCH_REL = 1e-9  # float64 card vs CPU and vs libpll_tpu: logL
# phase 32's rounds at 12 taxa x 40 sites: (name, seed, round, arguments,
# scaling); the data evolved on one random tree of the seed, the round
# started on a second (tests/test_torch_rounds.py's start_pair).  Seed 173
# keeps three moves and rolls one back.
ROUND_CASES = (
    ("spr commit 1", 21, "spr", dict(radius=5, batch=8, commit=1), "site"),
    ("spr commit 4", 22, "spr", dict(radius=6, batch=16, commit=4), "rate"),
    ("spr commit 8", 173, "spr", dict(radius=6, batch=16, commit=8), "site"),
    ("nni", 32, "nni", dict(batch=16), "rate"),
)
# phase 32's inference: (name, seed, tips, sites, arguments); the first
# four are tests/test_infer.py's data and arguments, max_rounds cut to 3-4
# (8 and 6 there) to keep the phase near a minute
INFER_SMALL = (
    ("spr local 3", 41, 12, 40, dict(seed=42, radius=8, max_rounds=4)),
    ("spr local 0", 12, 12, 40, dict(seed=5, radius=6, max_rounds=4,
                                     local_blopt=0)),
    ("nni local 3", 9, 12, 40, dict(seed=7, moves="nni", max_rounds=3)),
    ("nni local 0", 13, 12, 40, dict(seed=5, moves="nni", max_rounds=3,
                                     local_blopt=0)),
    ("spr 16 taxa", 50, 16, 40, dict(seed=42, max_rounds=3)),
)
# libpll_tpu on the CPU (float64, JAX_PLATFORMS=cpu) on the same data:
# rounds: (logl0, best_logl, best, n_candidates, n_ops_max, Newick after);
# inference: (start parsimony score, rounds, logL, final Newick)
SEARCH_JAX = {
    'nni': (
        (-637.8882867835907, -632.4764442692311, (15, 1), 18, 5,
         '(t7:0.266600,((((t9:0.331000,(t8:0.219200,t10:0.073600):'
         '0.167700):0.151600,(t2:0.173400,t4:0.387100):0.300700):0'
         '.147600,(t0:0.363900,t1:0.088900):0.178600):0.317500,t5:'
         '0.094500):0.370400,(t6:0.068000,(t3:0.089400,t11:0.13440'
         '0):0.230000):0.357900);'),
        (-632.4764442692311, -629.0909073738123, (24, 1), 18, 6,
         '(t7:0.266600,(((t4:0.387100,(t2:0.173400,(t9:0.331000,(t'
         '8:0.219200,t10:0.073600):0.167700):0.151600):0.300700):0'
         '.147600,(t0:0.363900,t1:0.088900):0.178600):0.317500,t5:'
         '0.094500):0.370400,(t6:0.068000,(t3:0.089400,t11:0.13440'
         '0):0.230000):0.357900);'),
    ),
    'nni local 0': (137, 3, -532.4927639871983,
        '((((t8:0.939401,t5:0.506111):0.628587,(t10:0.000000,t7:0'
        '.181447):0.125474):0.000000,t3:0.508263):0.179890,((((t4'
        ':0.027602,t9:0.605673):0.042112,t6:0.520155):0.296640,t0'
        ':0.131576):0.113817,t1:0.495007):0.177936,(t11:0.357869,'
        't2:0.666804):0.507385);'),
    'nni local 3': (139, 3, -529.8332126117535,
        '((t10:0.478297,t4:0.134950):0.000000,(((t3:0.599659,t11:'
        '0.036273):0.000000,(t0:0.461851,t7:0.769522):0.728769):0'
        '.448298,t9:1.282887):1.292848,(t8:0.092409,(((t6:0.28275'
        '1,t5:0.385941):0.150699,t1:0.165751):0.000000,t2:0.24131'
        '9):0.279277):0.580138);'),
    'spr 16 taxa': (168, 3, -646.116683309679,
        '((t11:0.290014,t12:0.119697):0.023243,((((t15:0.319976,t'
        '6:0.000000):0.275849,t7:0.433335):0.000000,(((t8:0.16582'
        '9,t2:0.281022):0.069903,t9:0.273083):0.406034,(t10:0.262'
        '300,((t13:0.059089,((t3:0.187491,t1:0.416204):0.565689,t'
        '14:0.000000):0.090274):1.024825,t0:0.354757):0.000000):0'
        '.212305):0.733361):0.000000,t5:0.498003):0.254510,t4:0.3'
        '81935);'),
    'spr commit 1': (
        (-581.8837259284089, -580.8395928592811, (36, 10), 28, 4,
         '((t4:0.298000,(t0:0.292900,(t9:0.313400,(t5:0.382400,t7:'
         '0.207600):0.144900):0.078800):0.181800):0.314700,((t2:0.'
         '394400,t6:0.381000):0.121700,(t3:0.146500,t11:0.214300):'
         '0.050600):0.050300,(t1:0.147600,(t8:0.212700,t10:0.63070'
         '0):0.147600):0.379500);'),
        (-580.8395928592811, -579.6408814313365, (30, 7), 42, 5,
         '((t4:0.298000,(t0:0.292900,(t9:0.313400,(t5:0.382400,t7:'
         '0.207600):0.144900):0.078800):0.181800):0.314700,(t3:0.0'
         '73250,(t11:0.214300,(t2:0.394400,t6:0.381000):0.172300):'
         '0.073250):0.050300,(t1:0.147600,(t8:0.212700,t10:0.63070'
         '0):0.147600):0.379500);'),
    ),
    'spr commit 4': (
        (-593.4588597315068, -582.7834906475919, (39, 10), 40, 5,
         '((t4:0.272700,t10:0.117600):0.386300,t7:0.061700,(t11:0.'
         '222500,((t0:0.171600,(t2:0.129750,(t3:0.378600,((t9:0.11'
         '4300,(t6:0.326600,t5:0.091900):0.114300):0.425500,t1:0.1'
         '64600):0.185300):0.129750):0.180500):0.628700,t8:0.24440'
         '0):0.289900):0.061700);'),
        (-582.7834906475919, -576.3950672136576, (21, 3), 70, 9,
         '((t4:0.272700,t10:0.117600):0.386300,t7:0.061700,(t11:0.'
         '222500,((t0:0.171600,(t2:0.129750,(t3:0.378600,((t9:0.11'
         '4300,t5:0.206200):0.425500,(t6:0.326600,t1:0.082300):0.0'
         '82300):0.185300):0.129750):0.180500):0.628700,t8:0.24440'
         '0):0.289900):0.061700);'),
    ),
    'spr commit 8': (
        (-632.3305087650839, -617.5270419760307, (39, 5), 46, 5,
         '(t5:0.269600,t9:0.163150,((((t10:0.115900,(((t11:0.03820'
         '0,(t1:0.626100,t0:0.361300):0.038200):0.693100,t7:0.1167'
         '00):0.309300,t3:0.220600):0.115900):0.106300,(t2:0.35110'
         '0,t8:0.099800):0.459300):0.182500,t4:0.082300):0.225000,'
         't6:0.359100):0.163150);'),
        (-617.5270419760307, -603.8920833093862, (36, 7), 78, 9,
         '(((t10:0.115900,(((t11:0.038200,(t1:0.626100,((t2:0.3511'
         '00,t8:0.099800):0.459300,t0:0.180650):0.180650):0.038200'
         '):0.693100,t7:0.116700):0.309300,t3:0.220600):0.115900):'
         '0.288800,t5:0.134800):0.134800,t9:0.163150,(t4:0.307300,'
         't6:0.359100):0.163150);'),
    ),
    'spr local 0': (126, 4, -494.22432043778457,
        '((t11:0.120467,t6:0.378024):1.011292,(t7:0.239459,(t3:0.'
        '068302,t4:0.153764):0.240185):0.070778,((t0:0.004505,((('
        '(t5:0.021919,t1:0.686332):0.366089,t9:0.602476):0.184805'
        ',t2:0.136551):0.277191,t8:0.389390):0.127364):0.620574,t'
        '10:0.108148):0.032467);'),
    'spr local 3': (157, 4, -559.1043660073608,
        '((t9:0.000000,(t0:0.284758,(t11:0.281620,t4:0.711687):1.'
        '108078):0.678572):2.754274,t8:0.000000,(t5:0.060665,((t3'
        ':0.000000,(t6:0.278351,t10:1.367571):1.486563):0.872806,'
        '(t1:0.172937,(t7:0.300659,t2:0.248128):0.404393):0.43485'
        '2):0.191869):0.114277);'),
}

# scripts/bench_infer.py's call (phase 33)
BENCH_INFER_TIPS, BENCH_INFER_SITES = 1024, 16384
PROFILED_EDGES = 256  # phase 33's profiled branch-length pass
BENCH_INFER_ARGS = dict(alpha=0.8, seed=42, min_delta=1e-2, spr_batch=128)
# the script runs infer_tree's default, 20; cut to 1, which keeps phase
# 33's one-rank run, phase 35's reference, and phase 35 short
BENCH_INFER_MAX_ROUNDS = 1
# SHA-256 of the alignment (">label\nsequence\n" in label order) from
# utils/flagship.infer_alignment(1024, 16384), equal to the script's
# simulate; libpll_tpu's FastParsimony + fastparsimony_stepwise (seed 42)
# on its 16 384 compressed patterns, on the CPU (BASELINE.md:244)
BENCH_INFER_SHA256 = ("913fb1f53e034c1a2e01c6ab40f9e546"
                      "5d14dd18655b266debe5ca1a02abb2b5")
BENCH_INFER_START_JAX = 3802156


def search_newick(tips, rng):
    """tests/test_spr_search.py's ``_random_tree``."""
    items = [f"t{i}:{rng.uniform(0.05, 0.4):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.4):.4f}")
    return f"({items[0]},{items[1]},{items[2]});"


def search_simulate(newick, sites, rng):
    """tests/test_spr_search.py's ``_simulate`` (sites a parameter): the
    same draws in the same order."""
    from libpll_tpu_torch.models.gtr import eigen_decompose
    from libpll_tpu_torch.tree import utree as ut

    tree = ut.parse_newick_string(newick)
    w, left, right = eigen_decompose(np.asarray(SEARCH_PARAMS),
                                     np.asarray(SEARCH_FREQS))

    def pmat(t):
        return (left * np.expm1(w * t)) @ right + np.eye(4)

    seqs = {}

    def walk(node, state):
        if node.is_tip:
            seqs[node.label] = state
            return
        for m in list(node.ring())[1:]:
            child = m.back
            P = pmat(max(child.length, 1e-6))
            walk(child, np.array([rng.choice(4, p=P[s] / P[s].sum())
                                  for s in state]))

    root = tree.root
    base = rng.choice(4, sites, p=list(SEARCH_FREQS))
    for m in root.ring():
        child = m.back
        P = pmat(max(child.length, 1e-6))
        walk(child, np.array([rng.choice(4, p=P[s] / P[s].sum())
                              for s in base]))
    return {lab: "".join("ACGT"[s] for s in st) for lab, st in seqs.items()}


def search_data(seed, tips=12, sites=40, start=False):
    """The sequences of ``seed`` (and, with ``start``, a second random
    tree's Newick to start a round from)."""
    rng = np.random.default_rng(seed)
    seqs = search_simulate(search_newick(tips, rng), sites, rng)
    return (seqs, search_newick(tips, rng)) if start else seqs


def search_partition(tree, seqs, sites, scaling, dtype, device):
    """tests/test_torch_spr.py's ``_partition``: the model of
    SEARCH_GTR, the tips from ``seqs`` by label."""
    from libpll_tpu_torch import Partition
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.tree import utree as ut

    tips = tree.tip_count
    part = Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, SEARCH_CATS,
                     tips - 2, scaling=scaling, dtype=dtype, device=device)
    order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
    for lab, s in seqs.items():
        part.set_tip_states(order[lab], maps.pll_map_nt, s)
    part.set_frequencies(0, SEARCH_FREQS)
    part.set_subst_params(0, SEARCH_PARAMS)
    part.set_category_rates(compute_gamma_cats(SEARCH_ALPHA, SEARCH_CATS))
    return part


def valid_dirs(tree):
    """The inner directions whose CLV row is marked valid."""
    return [m for n in tree.nodes if not n.is_tip for m in n.ring()
            if m.clv_valid]


def tree_flags(tree):
    return [(n.node_index, m.clv_valid) for n in tree.nodes
            for m in ([n] if n.is_tip else n.ring())]


def stale_rows(tree, part, seqs, scaling):
    """Every valid row against a fresh Partition's evaluation of its
    direction on the same device (float64 rel 1e-10, scalers equal;
    float32 by ``replay_close_f32``): (rows checked, largest error);
    fails on a stale row."""
    import torch

    from libpll_tpu_torch.tree import utree as ut

    fresh = search_partition(tree, seqs, part.sites, scaling, part.dtype,
                             part.device)
    _, branches, pmat_idx = ut.create_operations(ut.traverse(tree.root))
    fresh.update_prob_matrices([0] * SEARCH_CATS, pmat_idx, branches)
    worst, dirs = 0.0, valid_dirs(tree)
    for m in dirs:
        fresh.update_partials(ut.create_operations(ut.traverse(m))[0])
        got, want = part.clv[m.clv_index], fresh.clv[m.clv_index]
        scaled = m.scaler_index >= 0 and part.scale_mode
        sc = [part.scalers[m.scaler_index], fresh.scalers[m.scaler_index]] \
            if scaled else [torch.zeros(got.shape[-1], dtype=torch.int32,
                                        device=got.device)] * 2
        if part.dtype == torch.float64:
            ok, err = rows_close(got, want, 1e-10)
            ok = ok and torch.equal(*sc)
        else:
            ok, err, _ = replay_close_f32(got[None], sc[0][None],
                                          want[None], sc[1][None])
        check(ok, f"a valid row of direction {m.node_index} ({part.dtype} "
                  f"on {part.device}) is stale: rel {err}")
        worst = max(worst, err)
    return len(dirs), worst


def state_snapshot(tree, part):
    from libpll_tpu_torch.tree import utree as ut

    return (tree_flags(tree), ut.export_newick(tree.root),
            part.clv.clone(), part.scalers.clone())


def state_restored(tree, part, snap):
    """Flags and Newick as in ``snap``, every valid row, its scalers and
    the tips bit for bit."""
    import torch

    from libpll_tpu_torch.tree import utree as ut

    flags, newick, clv, scalers = snap
    rows = [m.clv_index for m in valid_dirs(tree)] + list(range(part.tips))
    scal = [m.scaler_index for m in valid_dirs(tree)
            if m.scaler_index >= 0 and part.scale_mode]
    return (tree_flags(tree) == flags and ut.export_newick(tree.root)
            == newick and torch.equal(part.clv[rows], clv[rows])
            and torch.equal(part.scalers[scal], scalers[scal]))


def fresh_f64_logl(tree, seqs, sites, device, weights=None, model=None):
    """A fresh float64 Partition of ``tree`` on ``device`` (the tips from
    ``seqs`` by label; ``model``: infer_tree's (frequencies, subst params,
    alpha), default SEARCH_GTR's): the root edge's logL."""
    import torch

    from libpll_tpu_torch import Partition
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.tree import utree as ut

    freqs, params, alpha = model or (SEARCH_FREQS, SEARCH_PARAMS,
                                     SEARCH_ALPHA)
    tips = tree.tip_count
    part = Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, SEARCH_CATS,
                     tips - 2, dtype=torch.float64, device=device)
    order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
    for lab, s in seqs.items():
        part.set_tip_states(order[lab], maps.pll_map_nt, s)
    if weights is not None:
        part.set_pattern_weights(weights)
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, params)
    part.set_category_rates(compute_gamma_cats(alpha, SEARCH_CATS))
    logl = fresh_logl(part, tree, [0] * SEARCH_CATS)
    del part
    return logl


def check_rounds_small(device):
    """Phase 32, rounds: ROUND_CASES on the card against the same round on
    the CPU, float64 (the same ``SprResult``: logL rel SEARCH_REL,
    improved, candidates, ``n_ops_max``, best move and committed nodes
    equal; the same Newick; valid rows rel 1e-10 to the CPU's) and float32
    (``logl0`` and, where the same move won, ``best_logl`` within the
    budget); float64 against SEARCH_JAX; every valid row on the card a
    fresh evaluation's (no stale row after a rolled-back commit); a
    round with no improvement restores every valid row, scaler and flag
    bit for bit; capacity 2 raises CapacityError, a contained regraft is
    dropped.  Returns a summary dict."""
    import torch

    from libpll_tpu_torch.errors import CapacityError
    from libpll_tpu_torch.search import spr
    from libpll_tpu_torch.tree import utree as ut

    cpu = torch.device("cpu")
    pidx = [0] * SEARCH_CATS
    out = {"rounds": 0, "rows": 0, "stale_err": 0.0, "f32_d": 0.0,
           "commits": [], "restored": 0}

    def start(seed, scaling, dtype, dev):
        seqs, newick = search_data(seed, start=True)
        tree = ut.parse_newick_string(newick)
        part = search_partition(tree, seqs, 40, scaling, dtype, dev)
        full_state(tree, part, pidx)
        return seqs, tree, part

    for name, seed, kind, kw, scaling in ROUND_CASES:
        fn = spr.spr_round if kind == "spr" else spr.nni_round
        for dtype in (torch.float64, torch.float32):
            got = {}
            for where, dev in (("card", device), ("cpu", cpu)):
                seqs, tree, part = start(seed, scaling, dtype, dev)
                res, newicks = [], []
                for _ in range(2):
                    res.append(fn(tree, part, pidx, **kw))
                    newicks.append(ut.export_newick(tree.root))
                got[where] = res, newicks, tree, part
                if where == "card":
                    n, err = stale_rows(tree, part, seqs, scaling)
                    out["rows"] += n
                    out["stale_err"] = max(out["stale_err"], err)
            (rc, nc, tc, pc), (rh, nh, th, ph) = got["card"], got["cpu"]
            what = f"round {name} {dtype}"
            for a, b in zip(rc, rh):
                if dtype == torch.float64:
                    check(round_key(a) == round_key(b) and logl_close(
                        a.logl0, b.logl0, dtype) and abs(
                        a.best_logl - b.best_logl) <= SEARCH_REL * abs(
                        b.best_logl), f"{what}: card {a} vs CPU {b}")
                else:
                    ok = logl_close(a.logl0, b.logl0, dtype) and (
                        a.best != b.best or logl_close(a.best_logl,
                                                       b.best_logl, dtype))
                    check(ok and a.improved, f"{what}: card {a} vs CPU {b}")
                    out["f32_d"] = max(out["f32_d"],
                                       abs(a.best_logl - b.best_logl))
                out["rounds"] += 1
            if dtype == torch.float64:
                check(nc == nh, f"{what}: Newick on the card {nc}, on the "
                                f"CPU {nh}")
                rows = [m.clv_index for m in valid_dirs(tc)]
                ok, err = rows_close(pc.clv[rows], ph.clv[rows], 1e-10)
                check(ok and tree_flags(tc) == tree_flags(th),
                      f"{what}: valid rows card vs CPU rel {err}, flags "
                      f"equal {tree_flags(tc) == tree_flags(th)}")
                for r, newick, want in zip(rc, nc, SEARCH_JAX[name]):
                    check(abs(r.logl0 - want[0]) <= SEARCH_REL * abs(want[0])
                          and abs(r.best_logl - want[1]) <= SEARCH_REL
                          * abs(want[1]) and round_key(r)[:4] == (
                              True, want[3], want[4], tuple(want[2]))
                          and newick == want[5],
                          f"{what}: {r} vs libpll_tpu {want}")
                out["commits"].append(len(rc[0].best_nodes) // 2)
            del got

    # no improvement: every valid row, scaler and flag as it was
    for kind in ("spr", "nni"):
        for dtype in (torch.float64, torch.float32):
            _, tree, part = start(27, "rate", dtype, device)
            snap = state_snapshot(tree, part)
            fn = spr.spr_round if kind == "spr" else spr.nni_round
            res = fn(tree, part, pidx, min_delta=1e6)
            check(not res.improved and state_restored(tree, part, snap),
                  f"{kind} round without improvement ({dtype}): improved "
                  f"{res.improved}, or the state changed")
            out["restored"] += 1

    # the typed errors
    _, tree, part = start(28, "site", torch.float64, device)
    try:
        spr.spr_round(tree, part, pidx, radius=6, capacity=2)
        fail("spr_round at capacity 2 did not raise CapacityError")
    except CapacityError:
        pass
    p = next(n for n in ut.query_innernodes(tree) if n.back.next is not None)
    before = ut.export_newick(tree.root)
    res = spr.spr_round(tree, part, pidx, candidates=[(p, p.back.next.back)])
    check(not res.improved and res.n_candidates == 0
          and ut.export_newick(tree.root) == before
          and ut.check_integrity(tree),
          f"a contained regraft was not dropped: {res}")
    return out


def round_key(r):
    """A round's integers: (improved, candidates, n_ops_max, best, the
    committed nodes' indices)."""
    return (r.improved, r.n_candidates, r.n_ops_max, r.best,
            None if r.best_nodes is None
            else tuple(n.node_index for n in r.best_nodes))


def infer_cpu_side(name):
    """Phase 32's CPU reruns: INFER_SMALL case ``name`` through
    ``infer_tree`` on the CPU in float64 and float32, with one intra-op
    thread as the card's runs have.  Returns, by ``str(dtype)``, its start
    score, trajectory, rounds, logL, Newick and seconds."""
    import torch

    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.tree import utree as ut

    _, seed, tips, sites, kw = next(c for c in INFER_SMALL if c[0] == name)
    seqs = search_data(seed, tips, sites)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    for dtype in (torch.float64, torch.float32):
        t0 = time.perf_counter()
        b = infer_tree(seqs, dtype=dtype, device="cpu", **SEARCH_GTR, **kw)
        out[str(dtype)] = dict(
            start=b.start_parsimony_score, trajectory=b.trajectory,
            rounds=b.rounds, logl=b.logl,
            newick=ut.export_newick(b.tree.root),
            s=time.perf_counter() - t0)
    torch.set_num_threads(threads)
    return out


def check_infer_small(device, cpu_refs=None):
    """Phase 32, inference: INFER_SMALL through ``infer_tree`` on the card
    and on the CPU in float64 (start score, rounds and topology equal,
    trajectory and logL rel SEARCH_REL) and float32 (the start score
    equal, the trajectory non-decreasing, the final logL within the
    budget of a fresh float64 Partition of the card's tree, the CPU's
    logL within the budget where the topology is the same); float64 on
    the card against SEARCH_JAX (start score, rounds, RF 0, logL rel
    SEARCH_REL); ``moves="tbr"`` and ``mesh=`` raise their typed errors.
    The CPU's runs (``infer_cpu_side``) come from ``cpu_refs`` (a
    :class:`CpuRefs`, computed beside the earlier phases) or, without
    it, are run here.  Returns a summary dict."""
    import torch

    from libpll_tpu_torch.errors import EinvalError
    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.tree.compare import rf_distance

    out = {"cases": 0, "f32_rf": [], "f32_d": 0.0, "s": {}}
    for name, seed, tips, sites, kw in INFER_SMALL:
        seqs = search_data(seed, tips, sites)
        cpu_runs = (infer_cpu_side(name) if cpu_refs is None
                    else cpu_refs.result()["infer"][name])
        for dtype in (torch.float64, torch.float32):
            t0 = time.perf_counter()
            a = infer_tree(seqs, dtype=dtype, device=device, **SEARCH_GTR,
                           **kw)
            b = cpu_runs[str(dtype)]
            out["s"][name, str(dtype), "card"] = time.perf_counter() - t0
            out["s"][name, str(dtype), "cpu"] = b["s"]
            what = f"infer_tree {name} {dtype}"
            rf = rf_distance(a.tree, ut.parse_newick_string(b["newick"]))
            check(a.start_parsimony_score == b["start"]
                  and a.trajectory == sorted(a.trajectory)
                  and set(a.timings) == {"compress", "stepwise", "setup",
                                         "blopt", "spr"},
                  f"{what}: start {a.start_parsimony_score} vs "
                  f"{b['start']}, trajectory {a.trajectory}")
            if dtype == torch.float64:
                traj = len(a.trajectory) == len(b["trajectory"]) and all(
                    abs(x - y) <= SEARCH_REL * abs(y)
                    for x, y in zip(a.trajectory, b["trajectory"]))
                check(a.rounds == b["rounds"] and rf == 0 and traj,
                      f"{what}: card rounds {a.rounds}, RF {rf} to the "
                      f"CPU's, trajectory {a.trajectory} vs "
                      f"{b['trajectory']}")
                start, rounds, logl, newick = SEARCH_JAX[name]
                rf_jax = rf_distance(a.tree, ut.parse_newick_string(newick))
                check(a.start_parsimony_score == start and a.rounds == rounds
                      and rf_jax == 0 and abs(a.logl - logl) <= SEARCH_REL
                      * abs(logl), f"{what}: ({a.start_parsimony_score}, "
                      f"{a.rounds}, {a.logl!r}), RF {rf_jax}; libpll_tpu "
                      f"({start}, {rounds}, {logl!r})")
            else:
                want = fresh_f64_logl(a.tree, seqs, sites, device)
                check(logl_close(a.logl, want, dtype)
                      and (rf or logl_close(a.logl, b["logl"], dtype)),
                      f"{what}: logL {a.logl!r}, a fresh float64 "
                      f"evaluation {want!r}, the CPU's {b['logl']!r} (RF "
                      f"{rf})")
                check(a.start_parsimony_score == (
                    SEARCH_JAX[name][0]), f"{what}: start score")
                out["f32_rf"].append(rf)
                out["f32_d"] = max(out["f32_d"], abs(a.logl - want))
            out["cases"] += 1
            del a
    seqs = search_data(12)
    for bad, exc in ((dict(moves="tbr"), ValueError),
                     (dict(mesh=object()), EinvalError)):
        try:
            infer_tree(seqs, device=device, **bad)
            fail(f"infer_tree({bad}) did not raise")
        except exc as err:
            check(exc is ValueError or "SitesMesh" in str(err),
                  f"infer_tree({bad}): {err}")
    return out


CPU_REFS_TIMEOUT = 900  # s: the background CPU references' whole run


def cpu_refs_main(out_path):
    """``chip_smoke.py --cpu-refs <out>``: the CPU's sides of phases 24 and
    32, ``parsimony_cpu_side`` at every configuration and
    ``infer_cpu_side`` at every case, one intra-op thread, pickled to
    ``out`` with their seconds (:class:`CpuRefs` runs it)."""
    import pickle

    import torch

    sys.path.insert(0, str(ROOT))
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = {"parsimony": {(seed, cfg): parsimony_cpu_side(seed, cfg)
                         for seed in PARSIMONY_SEEDS
                         for cfg in PARSIMONY_SMALL},
           "infer": {case[0]: infer_cpu_side(case[0])
                     for case in INFER_SMALL}}
    out["s"] = time.perf_counter() - t0
    part = Path(out_path + ".part")
    with open(part, "wb") as f:
        pickle.dump(out, f)
    part.rename(out_path)
    return 0


class CpuRefs:
    """The CPU's sides of phases 24 and 32 (the CPU reference builds and
    engines, the CPU's infer_tree runs) computed in a process of their own
    (``chip_smoke.py --cpu-refs``) while the card's phases run, so that
    the checks compare against them without waiting for the CPU.
    :meth:`result` waits for them (a failed process, or one past
    CPU_REFS_TIMEOUT from its start, fails the run); :meth:`stop` ends the
    process and runs at exit."""

    def __init__(self):
        import atexit
        import tempfile

        self.dir = Path(tempfile.mkdtemp(prefix="chip_smoke_cpu_refs_"))
        self.path = self.dir / "refs.pkl"
        self.log = open(self.dir / "log", "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cpu-refs",
             str(self.path)], cwd=ROOT, stdout=self.log,
            stderr=subprocess.STDOUT)
        self.refs = None
        atexit.register(self.stop)

    def result(self):
        import pickle

        if self.refs is None:
            left = CPU_REFS_TIMEOUT - (time.perf_counter() - self.t0)
            try:
                code = self.proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                self.log.flush()
                tail = (self.dir / "log").read_text()[-3000:]
                self.stop()
                fail(f"the CPU references' process failed or timed out "
                     f"(exit {code}):\n{tail}")
            with open(self.path, "rb") as f:
                self.refs = pickle.load(f)
        return self.refs

    def stop(self):
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if not self.log.closed:
            self.log.close()
        shutil.rmtree(self.dir, ignore_errors=True)


def alignment_digest(data):
    """SHA-256 of an alignment as ">label\nsequence\n" in label order."""
    import hashlib

    text = "".join(f">{k}\n{v}\n" for k, v in data.items())
    return hashlib.sha256(text.encode()).hexdigest()


class PlainCalls:
    """While active, every plain version of the kernels U1, C1, N1 and
    P1-P3 counts its calls (``calls``): on the card none should run."""

    def __init__(self):
        from libpll_tpu_torch.ops import clv as clv_ops
        from libpll_tpu_torch.ops import derivatives as dv
        from libpll_tpu_torch.ops import fitch
        from libpll_tpu_torch.ops import incremental as inc_ops

        self.names = [(clv_ops, "update_partials"),
                      (clv_ops, "update_partials_by_op"),
                      (clv_ops, "update_partials_grouped"),
                      (inc_ops, "replay_candidates_plain"),
                      (inc_ops, "score_candidates_plain"),
                      (dv, "newton_solve_plain"),
                      (dv, "newton_derivatives_plain"),
                      (fitch, "fitch_run_waves_plain"),
                      (fitch, "fitch_edge_scores_plain"),
                      (fitch, "fitch_insert_scores_plain"),
                      (fitch, "stepwise_commit_plain")]
        self.calls = {name: 0 for _, name in self.names}
        self.real = {}

    def __enter__(self):
        for module, name in self.names:
            real = getattr(module, name)
            self.real[module, name] = real

            def counting(*a, _real=real, _name=name, **k):
                self.calls[_name] += 1
                return _real(*a, **k)

            setattr(module, name, counting)
        return self

    def __exit__(self, *exc):
        for (module, name), real in self.real.items():
            setattr(module, name, real)


class Recorder:
    """While active, the inference driver's rounds and branch-length
    passes are timed and recorded (card synchronised after each):
    ``rounds`` [(seconds, SprResult)], ``blopt`` [(seconds, edges or
    None, sweeps)]."""

    def __init__(self):
        from libpll_tpu_torch.engine import blopt
        from libpll_tpu_torch.search import infer as infer_mod

        self.infer_mod, self.blopt = infer_mod, blopt
        self.rounds, self.passes = [], []

    def __enter__(self):
        import torch

        infer_mod, blopt = self.infer_mod, self.blopt
        self.real = (infer_mod.spr_round, infer_mod.nni_round,
                     blopt.optimize_branch_lengths_scan)

        def timed(fn, out, info):
            def call(*a, **k):
                t0 = time.perf_counter()
                res = fn(*a, **k)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0, info(res, k)))
                return res
            return call

        infer_mod.spr_round = timed(self.real[0], self.rounds,
                                    lambda r, k: r)
        infer_mod.nni_round = timed(self.real[1], self.rounds,
                                    lambda r, k: r)
        blopt.optimize_branch_lengths_scan = timed(
            self.real[2], self.passes,
            lambda r, k: (None if k.get("edges") is None
                          else len(k["edges"]), r[1]))
        return self

    def __exit__(self, *exc):
        (self.infer_mod.spr_round, self.infer_mod.nni_round,
         self.blopt.optimize_branch_lengths_scan) = self.real


def roofline_card(device):
    """(SMs, the SM clock's maximum MHz) of the card, for the peaks."""
    import torch

    from libpll_tpu_torch.ops import roofline

    return (torch.cuda.get_device_properties(device).multi_processor_count,
            roofline.max_sm_clock_mhz())


def profiled_idle(fn, names=()):
    """(wall ms, the card's busy ms, idle share of the wall, idle share
    of the kernels' span, kernel launches, {name: (device ms in all,
    launches)} of the kernels whose name holds each of ``names``) of
    ``fn()`` under torch.profiler (CUDA activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum((e.time_range.end - e.time_range.start) / 1e3
               for e in kernels)
    by_name, span_idle = kernel_ms(prof, names)
    return wall, busy, 1.0 - busy / wall, span_idle, len(kernels), by_name


def newton_at_edge(part, u, peak):
    """N1 at an edge of a Partition, as a sweep calls it (phase 33: the
    final tree's root edge at infer_tree's shape): ``newton_solve_rows``
    with blopt's |d2| rule from the edge's two rows, against its plain
    twin ``newton_solve_plain`` on ``update_sumtable``'s sumtable (t* within
    F32_T_REL in float32, rel 1e-10 in float64); ms a solve on the card by
    torch.profiler and a call's by CUDA events, the twin's by CUDA events;
    the bound of one solve: the two rows, the weights and the
    invariant codes read once, the sumtable formed once and the bodies
    run (N1's count) at the FP32 peak.  Per-site scaling (the rows'
    scalers cancel).  Returns a dict."""
    import torch

    from libpll_tpu_torch.engine.evaluate import partition_model
    from libpll_tpu_torch.ops import derivatives as dv

    model = partition_model(part, [0] * part.rate_cats)
    pidx = model["params_indices"].long()
    rows = (part.clv[u.clv_index], part.clv[u.back.clv_index])
    kw = dict(t0=torch.tensor([u.length], dtype=part.dtype,
                              device=part.device),
              rates=model["rates"], prop_invar=model["prop_invar_pc"],
              eigenvals_pc=model["eigenvals"][pidx],
              rate_weights=model["rate_weights"],
              invariant=model["invariant"],
              pattern_weights=model["pattern_weights"], sites=part.sites,
              abs_d2=True)
    left, right = model["left"][pidx], model["right"][pidx]

    def kernel():
        return dv.newton_solve_rows(rows[0], rows[1], None, None,
                                    model["freqs_pc"], left, right, **kw)

    def plain():
        return dv.newton_solve_plain(dv.update_sumtable(
            rows[0], rows[1], None, None, model["freqs_pc"], left, right),
            freqs_pc=model["freqs_pc"], **kw)

    got, want = kernel(), plain()
    err = abs(float(got.t) - float(want.t))
    rel = F32_T_REL if part.dtype == torch.float32 else 1e-10
    check(err <= rel * abs(float(want.t)),
          f"N1 at the edge: t* {float(got.t)!r}, plain {float(want.t)!r}")
    plan = dv.plan_for(rows[0], part.sites)
    c, s, length = rows[0].shape
    item = rows[0].element_size()
    nbytes = 2 * c * s * length * item + length * (item + 4)
    flop = (int(got.iterations) * newton_flop(c, s)
            + sumtable_flop(c, s)) * part.sites
    return dict(err=err, t=float(got.t), iterations=int(got.iterations),
                ms=float(profiled_ms(kernel, "newton_solve_kernel")),
                call_ms=time_ms(kernel)[0],
                plain_ms=time_ms(plain, iters=5, warmup=1)[0],
                bound=bound(flop, nbytes, peak), plan=plan_text(plan),
                shape=(c, s, length))


def phase_infer(device, card):
    """Phase 33: scripts/bench_infer.py's call on the card:
    ``infer_alignment(1024, 16384)`` (its SHA-256 BENCH_INFER_SHA256),
    then ``infer_tree(data, alpha=0.8, seed=42, dtype=torch.float32,
    min_delta=1e-2, spr_batch=128)`` with every launch counter at 0 around
    it: the start parsimony score BENCH_INFER_START_JAX, the trajectory
    non-decreasing, the final logL within the f32 budget of a fresh
    float64 Partition on the card (the exported Newick, the compressed
    alignment), U1, C1, N1, P2 and P3 launched and no plain version run.
    Prints time-to-tree and the timings by phase, each round's candidates,
    commits and seconds, the branch-length passes, RF to the generating
    tree, the peak device memory, and the card's idle share over one SPR
    round and one branch-length pass over PROFILED_EDGES edges
    (torch.profiler).  Returns the
    result and the compressed alignment (label -> patterns, weights)."""
    import torch

    from libpll_tpu_torch.engine import blopt
    from libpll_tpu_torch.engine.evaluate import partition_model
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.io.compress import compress_site_patterns
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.ops import incremental as inc_ops
    from libpll_tpu_torch.ops import roofline
    from libpll_tpu_torch.search import spr
    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.utils.rng import shuffled_order
    from libpll_tpu_torch.search.stepwise import deep_recursion
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.tree.compare import rf_distance
    from libpll_tpu_torch.utils.flagship import infer_alignment

    tips, sites = BENCH_INFER_TIPS, BENCH_INFER_SITES
    t0 = time.perf_counter()
    data, truth = infer_alignment(tips, sites)
    sim_s = time.perf_counter() - t0
    digest = alignment_digest(data)
    check(digest == BENCH_INFER_SHA256,
          f"bench_infer alignment SHA-256 {digest}, recorded "
          f"{BENCH_INFER_SHA256} (numpy or scipy draw otherwise here)")

    counters = {"U1": clv_ops._replay_ops, "C1": inc_ops._score_candidates,
                "N1": dv._newton_solve, "P2": fitch.fitch_scores,
                "P3": fitch.stepwise_commit}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counters.values():
        wrapper.launches = 0
    with PlainCalls() as plain, Recorder() as rec:
        t0 = time.perf_counter()
        res = infer_tree(data, dtype=torch.float32,
                         max_rounds=BENCH_INFER_MAX_ROUNDS,
                         **BENCH_INFER_ARGS)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters.items()}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(v > 0 for v in launches.values())
          and not any(plain.calls.values()),
          f"bench_infer: launches {launches}, plain versions run "
          f"{plain.calls}")
    check(res.start_parsimony_score == BENCH_INFER_START_JAX,
          f"bench_infer start parsimony {res.start_parsimony_score}, "
          f"libpll_tpu {BENCH_INFER_START_JAX}")
    check(res.trajectory == sorted(res.trajectory)
          and np.isfinite(res.logl),
          f"bench_infer trajectory {res.trajectory}")

    labels = list(data)
    patterns, weights = compress_site_patterns([data[k] for k in labels],
                                               maps.pll_map_nt)
    with deep_recursion(tips):
        newick = ut.export_newick(res.tree.root)
        tree64 = ut.parse_newick_string(newick)
        t0 = time.perf_counter()
        want = fresh_f64_logl(tree64, dict(zip(labels, patterns)),
                              len(patterns[0]), device, weights,
                              ([0.25] * 4, [1.0] * 6, 0.8))
        fresh_s = time.perf_counter() - t0
        rf = rf_distance(res.tree, ut.parse_newick_string(truth))
    budget = ACC_REL * abs(want) + ACC_ABS
    check(abs(res.logl - want) <= budget,
          f"bench_infer logL {res.logl!r}, a fresh float64 Partition "
          f"{want!r} (budget {budget})")

    # N1 at this shape against its plain twin and its bound (the final
    # tree's root edge, as a sweep solves it)
    part, tree, pidx = res.partition, res.tree, [0] * 4
    n1 = newton_at_edge(part, tree.root,
                        roofline.fp32_peak(*roofline_card(device)))

    # the card's idle share over one more SPR round and one full sweep
    torch.cuda.empty_cache()
    with deep_recursion(tips):
        scorer = spr.make_round_scorer(part, 32)
        rnd = {}
        spr_idle = profiled_idle(lambda: rnd.setdefault("r", spr.spr_round(
            tree, part, pidx, radius=5, capacity=32, batch=128,
            scorer=scorer, min_delta=1e-2, commit=8)),
            ("score_candidates_kernel", "replay_kernel"))
        # the round's host encode alone, on the tree it left
        cands = spr.spr_neighborhood(tree, 5)
        t0 = time.perf_counter()
        n_enc = len(spr.encode_candidates(tree, cands)[0])
        enc_ms = (time.perf_counter() - t0) * 1e3
        # a pass over the first PROFILED_EDGES edges in the sweep's order
        # (the profiler's record of a whole sweep's ~166 000 kernels costs
        # more than the sweep)
        first = {u.pmatrix_index for u, _ in zip(blopt._edges(tree.root),
                                                  range(PROFILED_EDGES))}
        sweep = profiled_idle(lambda: blopt.optimize_branch_lengths_scan(
            tree, part, pidx, max_sweeps=1, capacity=64, edges=first,
            edge_pad=PROFILED_EDGES), ("replay_kernel", "newton_solve_kernel"))
        # C1 on the first batch of 128 of that neighbourhood
        enc, n_max = spr.encode_candidates(tree, cands)
        check(n_max <= 32, f"bench_infer's round needs capacity {n_max}")
        batch128 = measure_batch(
            scorer, part, partition_model(part, pidx), next(
                spr.encoded_batches(enc, part.nodes, part.scale_buffers, 32,
                                    128)), 32,
            roofline.fp32_peak(*roofline_card(device)))
    del scorer, part, enc
    torch.cuda.empty_cache()
    # the start tree's build again, P3 under the profiler, and its last
    # insertion against the plain version
    sms, clock = roofline_card(device)
    peaks = (sms * LOGIC_PER_SM_CLOCK * clock * 1e6,
             sms * POPC_PER_SM_CLOCK * clock * 1e6)
    pars = FastParsimony.from_sequences(patterns, maps.pll_map_nt, states=4,
                                        pattern_weights=weights)
    with deep_recursion(tips):
        build = stepwise_profile(pars, labels, BENCH_INFER_ARGS["seed"],
                                 peaks)
    last = last_insertion_p3(pars, shuffled_order(
        tips, BENCH_INFER_ARGS["seed"]), peaks)
    del pars, last["state"]
    torch.cuda.empty_cache()

    t = res.timings
    print(f"[33 infer] {card}: scripts/bench_infer.py's call, "
          f"infer_alignment({tips}, {sites}) (simulated in {sim_s:.1f} s, "
          f"SHA-256 as recorded, {len(patterns[0])} patterns), infer_tree "
          f"float32 spr_batch 128 min_delta 1e-2, max_rounds "
          f"{BENCH_INFER_MAX_ROUNDS}: time-to-tree {total_s:.2f} s (phases "
          + ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
          + f"); start parsimony {res.start_parsimony_score} (libpll_tpu "
          f"{BENCH_INFER_START_JAX}); rounds {res.rounds}; logL "
          f"{res.logl!r}, a fresh float64 Partition {want!r} (|d| "
          f"{abs(res.logl - want):.4f} <= {budget:.3f}, built and evaluated "
          f"in {fresh_s:.1f} s); trajectory "
          + ", ".join(f"{x:.3f}" for x in res.trajectory)
          + f"; RF to the generating tree {rf} of {2 * (tips - 3)}; peak "
          f"device memory {peak_gib:.3f} GiB; launches {launches}, plain "
          f"versions run {sum(plain.calls.values())}; rounds (s, candidates, n_ops_max, moves kept, "
          f"logL gain): " + "; ".join(
              f"{s:.3f} {r.n_candidates} {r.n_ops_max} "
              f"{len(r.best_nodes or ()) // 2} "
              f"{r.best_logl - r.logl0:.3f}" for s, r in rec.rounds)
          + f"; branch-length passes (s, edges or full, sweeps): "
          + "; ".join(f"{s:.3f} {e or 'full'} {n}"
                      for s, (e, n) in rec.passes), flush=True)
    r = rnd["r"]
    print(f"[33 infer] {card}: one more SPR round on the final tree "
          f"({r.n_candidates} candidates, improved {r.improved}): wall "
          f"{spr_idle[0]:.1f} ms, the card busy {spr_idle[1]:.1f} ms in "
          f"{spr_idle[4]} kernels, idle {spr_idle[2] * 100:.1f}% of the wall"
          f" ({spr_idle[3] * 100:.1f}% of the kernels' span), "
          f"encode_candidates alone {enc_ms:.1f} ms for {n_enc} candidates "
          f"({enc_ms / max(n_enc, 1):.4f} ms a candidate); a "
          f"branch-length pass over the sweep's first {PROFILED_EDGES} "
          f"edges (eager): wall {sweep[0]:.1f} ms "
          f"({sweep[0] / PROFILED_EDGES:.3f} ms an edge), "
          f"busy {sweep[1]:.1f} ms in {sweep[4]} kernels, idle "
          f"{sweep[2] * 100:.1f}% ({sweep[3] * 100:.1f}% of the span); "
          f"a launch in them: " + "; ".join(
              f"{label} {ms / max(n, 1) * 1e3:.2f} us ({n} launches in the "
              f"{where})" for label, where, (ms, n) in (
                  ("C1", "round", spr_idle[5]["score_candidates_kernel"]),
                  ("U1", "round", spr_idle[5]["replay_kernel"]),
                  ("U1", "sweep", sweep[5]["replay_kernel"]),
                  ("N1", "sweep", sweep[5]["newton_solve_kernel"])))
          + "; torch.profiler", flush=True)
    print(f"[33 infer] {card}: C1 on that neighbourhood's first "
          + batch_text(batch128), flush=True)
    print(f"[33 infer] {card}: N1 at this shape (the final tree's root "
          f"edge, {n1['shape']} float32 rows, blopt's |d2| rule, from the "
          f"rows; {n1['plan']}): t* {n1['t']!r} in {n1['iterations']} "
          f"bodies, equal to its plain twin within {F32_T_REL} (|d t*| "
          f"{n1['err']:.3e}); {n1['ms'] * 1e3:.2f} us a solve on the card "
          f"(torch.profiler), {n1['call_ms'] * 1e3:.2f} us a call (CUDA "
          f"events, {TIMED_ITERS} back to back, the host's work included) "
          f"vs plain {n1['plain_ms']:.3f} ms; "
          f"bound {n1['bound'][0] * 1e3:.3f} us ({n1['bound'][1]}: the two "
          f"rows, weights and codes read once, the sumtable formed once, "
          f"{n1['iterations']} bodies at the FP32 peak), "
          f"{n1['bound'][0] / n1['ms'] * 100:.1f}%", flush=True)
    print(f"[33 infer] {card}: the start tree's device build again "
          f"({tips} taxa, {last['words']} words; P3 {last['plan'].grid} "
          f"blocks, tables in "
          f"{'shared' if last['plan'].shared else 'device'} memory): "
          + stepwise_text(build) + f"; the last insertion ({last['rows']} "
          f"rows in {last['levels']} dependent levels) P3 "
          f"{last['ms'] * 1e3:.2f} us ({last['ms'].by}, equal to its plain "
          f"version"
          f") vs plain {last['plain_ms']:.3f} ms, bound "
          f"{last['bound'][0] * 1e3:.3f} us ({last['bound'][1]})",
          flush=True)
    return res, (dict(zip(labels, patterns)), weights), launches, dict(
        n1=n1, data=data, newick=newick)


# ---------------------------------------------------------------------------
# 34: model fitting
# ---------------------------------------------------------------------------
# phase 34's small fits, float64 on the card against the CPU and against
# libpll_tpu: (name, seed, tips, sites, Γ shape of the site rates or None,
# share of sites held still, optimize_model's arguments).  The DNA evolved
# under SEARCH_PARAMS/SEARCH_FREQS on a random tree of the seed
# (modelopt_simulate), fitted on that tree from JC with Γ4(1.0) rates (one
# rate for "fixed"); "lg4x": protein evolved on such a tree under the LG4X
# mixture (LG4X_WEIGHTS, LG4X_RATES; lg4x_simulate), its rates and weights
# fitted over LG4X's four fixed matrices from uniform ones (reference
# examples/lg4/lg4.c's lg4x_opt_weights_and_rates).
MODELOPT_SMALL = (
    ("gamma", 61, 12, 200, 0.5, 0.0, dict(alpha=1.0, rounds=1)),
    ("free", 62, 12, 200, 0.6, 0.0, dict(rate_mode="free", rounds=1)),
    ("fixed", 63, 12, 200, None, 0.0, dict(opt_alpha=False,
                                           rate_mode="fixed", rounds=2)),
    ("pinv", 64, 12, 200, 1.0, 0.3, dict(opt_pinv=True, rounds=1)),
    ("lg4x", 65, 8, 120, None, 0.0, dict(opt_subst=False, opt_freqs=False,
                                         opt_alpha=False, rate_mode="free",
                                         rounds=1)),
)
# tests/test_modelopt.py's generating LG4X mixture (its rates normalised
# to a weighted mean of 1 there)
LG4X_WEIGHTS = (0.45, 0.30, 0.15, 0.10)
LG4X_RATES = (0.3, 0.9, 1.6, 2.5)
# infer_tree(optimize_model=True) on modelopt_data(seed, tips, sites, 0.5)
# from JC with Γ4(1.0) (tests/test_modelopt.py:289's setting): (seed, tips,
# sites, infer_tree's arguments)
MODELOPT_INFER = (66, 12, 160, dict(rate_cats=4, seed=5, radius=4,
                                    max_rounds=2, optimize_model=True,
                                    model_rounds=1))
MODELOPT_PARAM_ABS, MODELOPT_ALPHA_REL = 1e-4, 1e-3
# the fit at scripts/bench_infer.py's size: run_modelopt's call after a
# search (libpll_tpu/search/infer.py:226-229)
BENCH_FIT_ARGS = dict(opt_alpha=True, opt_pinv=False, alpha=0.8, rounds=1)
MODELOPT_TIMED = 5  # value-and-grad and Brent evaluations timed
# libpll_tpu's fits on the same data and partitions, on the CPU in float64
# (JAX_PLATFORMS=cpu, x64): fit_summary of each MODELOPT_SMALL case, and
# for MODELOPT_INFER the start score, rounds, trajectory, final Newick and
# the last fit
MODELOPT_JAX = {'gamma': {'logl': -2052.585205810269,
               'trajectory': [-2103.726318974098, -2067.2444018043047,
                              -2052.585205810269],
               'subst_params': [0.6156604280670243, 2.930610739278195,
                                0.908692645125377, 0.9088420245681136,
                                2.0081561660554517, 1.0],
               'frequencies': [0.2700768752952801, 0.2760773146971612,
                               0.20918675369146256, 0.2446590563160961],
               'rates': [0.033398768393440664, 0.25195471086005117,
                         0.8203117170869909, 2.8943348036595173],
               'rate_weights': [0.25, 0.25, 0.25, 0.25],
               'alpha': 0.5000594263163146,
               'prop_invar': 0.0},
     'free': {'logl': -2219.8529329227354,
              'trajectory': [-2250.335707413798, -2219.8529329227354],
              'subst_params': [1.654606689378731, 3.4806295908799214,
                               1.4719489363777827, 2.0192660117167103,
                               3.5073675900148475, 1.0],
              'frequencies': [0.2928894356802425, 0.2484590565170689,
                              0.22653851171158865, 0.23211299609109978],
              'rates': [0.15326442256725575, 0.202230655140101,
                        1.2326640230239605, 4.258153179145446],
              'rate_weights': [0.38343483314790316, 0.06021679581580728,
                               0.4759432643445243, 0.08040510669176516],
              'alpha': None,
              'prop_invar': 0.0},
     'fixed': {'logl': -2627.6061558498423,
               'trajectory': [-2670.1819572847503, -2627.6061558509064,
                              -2627.6061558498423],
               'subst_params': [1.1226305843124054, 1.7928613537448022,
                                0.506802598756688, 1.0288153821880501,
                                2.1519356212308507, 1.0],
               'frequencies': [0.28597054737630895, 0.2518990367514135,
                               0.21203512920547168, 0.25009528666680586],
               'rates': [1.0],
               'rate_weights': [1.0],
               'alpha': None,
               'prop_invar': 0.0},
     'pinv': {'logl': -1788.6298254674982,
              'trajectory': [-1855.8598813327812, -1812.0419150468636,
                             -1789.0454304505613, -1788.6298254674982],
              'subst_params': [0.8571237674543521, 2.0171189510912164,
                               0.2140738477213911, 1.311032829168747,
                               2.156364025864722, 1.0],
              'frequencies': [0.3127526079186615, 0.2584976454247575,
                              0.17798542360130434, 0.25076432305527663],
              'rates': [0.020655244456352924, 0.20098093087175858,
                        0.7580618027627615, 3.020302021909127],
              'rate_weights': [0.25, 0.25, 0.25, 0.25],
              'alpha': 0.4261157350404224,
              'prop_invar': 0.05476835447672689},
     'lg4x': {'logl': -1350.7586424206818,
              'trajectory': [-1393.6111620109, -1350.7586424206818],
              'subst_params': None,
              'frequencies': None,
              'rates': [0.32638328937469824, 1.1215905551463292,
                        1.5046692907763548, 2.297590169613763],
              'rate_weights': [0.4365491700940493, 0.3422175436840878,
                               0.04365346335184253, 0.17757982287002025],
              'alpha': None,
              'prop_invar': 0.0},
     'infer': {'start': 400,
               'rounds': 2,
               'trajectory': [-1631.7263629597294, -1585.7138902492181,
                              -1585.58403661714, -1585.5766444435053,
                              -1585.5762434719627, -1584.0551198239225],
               'newick': ('((((t2:0.076156,t1:0.209290):0.143960,(t8:0.4010'
                          '11,t4:0.205872):0.100429):0.564818,(t5:0.601725,'
                          't0:0.381833):0.565826):0.000000,(t6:0.000000,t7:'
                          '0.188342):0.305561,((t9:0.476226,(t11:0.158084,t'
                          '10:0.486869):0.183394):0.184503,t3:0.496046):0.5'
                          '57565);'),
               'model': {'logl': -1584.2691843308148,
                         'trajectory': [-1585.5762434719627,
                                        -1584.6788861512189,
                                        -1584.2691843308148],
                         'subst_params': [3.6468091180511197,
                                          8.214318465398398,
                                          1.9689923890716274,
                                          3.252958362741572, 6.558723193986145,
                                          1.0],
                         'frequencies': [0.2917784356619151,
                                         0.2492834659908171,
                                         0.20853991075050432,
                                         0.25039818759676347],
                         'rates': [0.021294450054532954, 0.20390210579465848,
                                   0.7619547416009932, 3.0128487025498156],
                         'rate_weights': [0.25, 0.25, 0.25, 0.25],
                         'alpha': 0.4301564572004039,
                         'prop_invar': 0.0}}}


def modelopt_simulate(newick, sites, rng, site_rates):
    """tests/test_modelopt.py's ``_simulate`` under SEARCH_PARAMS and
    SEARCH_FREQS: sequences evolved down ``newick``, each site's branch
    lengths scaled by its rate."""
    from libpll_tpu_torch.models.gtr import eigen_decompose
    from libpll_tpu_torch.tree import utree as ut

    tree = ut.parse_newick_string(newick)
    freqs = np.asarray(SEARCH_FREQS)
    w, left, right = eigen_decompose(np.asarray(SEARCH_PARAMS), freqs)

    def evolve(child, state):
        t = max(child.length, 1e-6) * site_rates
        e = np.expm1(w[None, :] * t[:, None])
        P = np.einsum("ij,sj,jk->sik", left, e, right) + np.eye(4)
        cdf = np.cumsum(P[np.arange(sites), state], axis=1)
        cdf /= cdf[:, -1:]
        return (rng.random(sites)[:, None] > cdf).sum(axis=1)

    seqs = {}

    def descend(node, state):
        if node.is_tip:
            seqs[node.label] = state
            return
        for m in list(node.ring())[1:]:
            descend(m.back, evolve(m.back, state))

    base = rng.choice(4, sites, p=freqs / freqs.sum())
    for m in tree.root.ring():
        descend(m.back, evolve(m.back, base))
    return {lab: "".join("ACGT"[s] for s in st) for lab, st in seqs.items()}


def lg4x_simulate(newick, sites, rng):
    """tests/test_modelopt.py's ``_simulate_lg4x``: each site draws a
    category from LG4X_WEIGHTS and evolves under that category's LG4X
    matrix at its rate."""
    from libpll_tpu_torch.models.aa_tables import AA_MIXTURE_MODELS
    from libpll_tpu_torch.models.gtr import eigen_decompose
    from libpll_tpu_torch.tree import utree as ut

    rates4, freqs4 = AA_MIXTURE_MODELS["lg4x"]
    w, r = np.asarray(LG4X_WEIGHTS), np.asarray(LG4X_RATES)
    tree = ut.parse_newick_string(newick)
    cat = rng.choice(4, sites, p=w)
    eig = [eigen_decompose(rates4[k], freqs4[k]) for k in range(4)]
    site_rate = (r / (w * r).sum())[cat]

    def step(child, state):
        t = max(child.length, 1e-6)
        P = np.zeros((sites, 20, 20))
        for k, (lam, left, right) in enumerate(eig):
            sel = cat == k
            if sel.any():
                e = np.expm1(lam[None, :] * (t * site_rate[sel])[:, None])
                P[sel] = np.einsum("ij,sj,jk->sik", left, e,
                                   right) + np.eye(20)
        cdf = np.cumsum(P[np.arange(sites), state], axis=1)
        cdf /= cdf[:, -1:]
        return (rng.random(sites)[:, None] > cdf).sum(axis=1)

    seqs = {}

    def descend(node, state):
        if node.is_tip:
            seqs[node.label] = state
            return
        for m in list(node.ring())[1:]:
            descend(m.back, step(m.back, state))

    base = np.zeros(sites, np.int64)
    for k in range(4):
        sel = cat == k
        fk = np.asarray(freqs4[k], np.float64)
        base[sel] = rng.choice(20, int(sel.sum()), p=fk / fk.sum())
    for m in tree.root.ring():
        descend(m.back, step(m.back, base))
    aas = "ARNDCQEGHILKMFPSTWYV"
    return {lab: "".join(aas[s] for s in st) for lab, st in seqs.items()}


def modelopt_data(seed, tips, sites, alpha=None, invariant=0.0,
                  protein=False):
    """(Newick, sequences) of phase 34's small fits: a random tree of the
    seed (search_newick) and DNA evolved on it with Γ(alpha)-distributed
    site rates (four categories) and a share ``invariant`` of sites held
    still, or protein under LG4X (lg4x_simulate)."""
    from libpll_tpu_torch.models.gamma import compute_gamma_cats

    rng = np.random.default_rng(seed)
    newick = search_newick(tips, rng)
    if protein:
        return newick, lg4x_simulate(newick, sites, rng)
    rates = np.ones(sites)
    if alpha is not None:
        rates = compute_gamma_cats(alpha, 4)[rng.integers(0, 4, sites)]
    if invariant:
        rates = rates * (rng.random(sites) > invariant)
    return newick, modelopt_simulate(newick, sites, rng, rates)


def modelopt_partition(case, dtype, device):
    """(tree, Partition) of a MODELOPT_SMALL case on ``device``."""
    from libpll_tpu_torch import Partition
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.models.aa_tables import AA_MIXTURE_MODELS
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.tree import utree as ut

    name, seed, tips, sites, alpha, invariant, _ = case
    protein = name == "lg4x"
    newick, seqs = modelopt_data(seed, tips, sites, alpha, invariant,
                                 protein)
    tree = ut.parse_newick_string(newick)
    states, matrices = (20, 4) if protein else (4, 1)
    cats = 1 if name == "fixed" else 4
    part = Partition(tips, tips - 2, states, sites, matrices, 2 * tips - 3,
                     cats, tips - 2, dtype=dtype, device=device)
    cmap = maps.pll_map_aa if protein else maps.pll_map_nt
    order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
    for lab, s in seqs.items():
        part.set_tip_states(order[lab], cmap, s)
    if protein:
        rates4, freqs4 = AA_MIXTURE_MODELS["lg4x"]
        for k in range(4):
            part.set_subst_params(k, rates4[k])
            part.set_frequencies(k, freqs4[k])
        part.set_category_rates(np.ones(4))
    elif cats > 1:
        part.set_category_rates(compute_gamma_cats(1.0, cats))
    return tree, part


def fit_summary(res):
    """A ModelOptResult as MODELOPT_JAX holds one."""
    return dict(logl=res.logl, trajectory=list(res.trajectory),
                subst_params=np.asarray(res.subst_params).tolist(),
                frequencies=np.asarray(res.frequencies).tolist(),
                rates=np.asarray(res.rates).tolist(),
                rate_weights=np.asarray(res.rate_weights).tolist(),
                alpha=res.alpha, prop_invar=res.prop_invar)


def fits_close(got, want):
    """(ok, why): trajectory and logL rel SEARCH_REL, the parameters
    MODELOPT_PARAM_ABS, alpha and p-inv rel MODELOPT_ALPHA_REL."""
    traj = len(got["trajectory"]) == len(want["trajectory"]) and all(
        abs(x - y) <= SEARCH_REL * abs(y)
        for x, y in zip(got["trajectory"], want["trajectory"]))
    if not (traj and abs(got["logl"] - want["logl"])
            <= SEARCH_REL * abs(want["logl"])):
        return False, "trajectory or logL"
    for key in ("subst_params", "frequencies", "rates", "rate_weights"):
        if want[key] is None:
            continue
        g, w = np.asarray(got[key]), np.asarray(want[key])
        if g.shape != w.shape or np.abs(g - w).max() > MODELOPT_PARAM_ABS:
            return False, key
    for key in ("alpha", "prop_invar"):
        g, w = got[key], want[key]
        if (g is None) != (w is None) or (
                w is not None and abs(g - w) > MODELOPT_ALPHA_REL * abs(w)):
            return False, key
    return True, ""


def written_back(part, res):
    """The Partition carries the fit: its parameters are the result's."""
    R = part.rate_matrices
    return (np.array_equal(part.subst_params,
                           np.reshape(res.subst_params, (R, -1)))
            and np.array_equal(part.frequencies,
                               np.reshape(res.frequencies, (R, -1)))
            and np.array_equal(part.rates, res.rates)
            and np.array_equal(part.rate_weights, res.rate_weights))


def check_modelopt_small(device):
    """Phase 34, small: each MODELOPT_SMALL fit on the card and on the CPU
    in float64 (fits_close, the Partition written back) and against
    MODELOPT_JAX; ``infer_tree(optimize_model=True)`` (MODELOPT_INFER) on
    the card and the CPU (start score, rounds, RF 0, trajectory rel
    SEARCH_REL, the last fit close) and against MODELOPT_JAX.  Returns a
    summary dict."""
    import torch

    from libpll_tpu_torch.engine import modelopt
    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.tree.compare import rf_distance

    cpu = torch.device("cpu")
    out = {"fits": 0, "s": {}}
    for case in MODELOPT_SMALL:
        name, kw = case[0], case[-1]
        got = {}
        for where, dev in (("card", device), ("cpu", cpu)):
            tree, part = modelopt_partition(case, torch.float64, dev)
            t0 = time.perf_counter()
            res = modelopt.optimize_model(part, tree, **kw)
            out["s"][name, where] = time.perf_counter() - t0
            # written back through the setters: the eigen cache invalid
            check(written_back(part, res) and not part.eigen_valid.any()
                  and res.trajectory == sorted(res.trajectory),
                  f"fit {name} on the {where}: not written back, or "
                  f"trajectory {res.trajectory}")
            got[where] = fit_summary(res)
        want = MODELOPT_JAX[name]  # None: LG4X's own, not fitted
        for other, ref in (("the CPU", got["cpu"]), ("libpll_tpu", want)):
            ok, why = fits_close(got["card"], ref)
            check(ok, f"fit {name}: the card's {got['card']} vs {other}'s "
                      f"{ref} ({why})")
        out["fits"] += 1

    seed, tips, sites, kw = MODELOPT_INFER
    seqs = modelopt_data(seed, tips, sites, 0.5)[1]
    res = {}
    for where, dev in (("card", device), ("cpu", cpu)):
        t0 = time.perf_counter()
        res[where] = infer_tree(seqs, device=dev, **kw)
        out["s"]["infer", where] = time.perf_counter() - t0
    a, b = res["card"], res["cpu"]
    want = MODELOPT_JAX["infer"]
    traj = len(a.trajectory) == len(b.trajectory) == len(
        want["trajectory"]) and all(
        abs(x - y) <= SEARCH_REL * abs(y) and abs(x - z) <= SEARCH_REL
        * abs(z) for x, y, z in zip(a.trajectory, b.trajectory,
                                    want["trajectory"]))
    rf = (rf_distance(a.tree, b.tree),
          rf_distance(a.tree, ut.parse_newick_string(want["newick"])))
    check(a.start_parsimony_score == b.start_parsimony_score == want["start"]
          and a.rounds == b.rounds == want["rounds"] and rf == (0, 0)
          and traj and "modelopt" in a.timings
          and written_back(a.partition, a.model),
          f"infer_tree(optimize_model=True): card ({a.start_parsimony_score},"
          f" {a.rounds}, {a.trajectory}), CPU ({b.start_parsimony_score}, "
          f"{b.rounds}, {b.trajectory}), libpll_tpu ({want['start']}, "
          f"{want['rounds']}, {want['trajectory']}), RF {rf}")
    for other, ref in (("the CPU", fit_summary(b.model)),
                       ("libpll_tpu", want["model"])):
        ok, why = fits_close(fit_summary(a.model), ref)
        check(ok, f"infer_tree(optimize_model=True)'s last fit: the card's "
                  f"{fit_summary(a.model)} vs {other}'s {ref} ({why})")
    out["infer"] = (a.logl, a.model.alpha)
    return out


class FitCounter:
    """While active, model fitting's L-BFGS steps (``steps``) and its
    scorer's evaluations are counted: ``grad`` under autograd (each one
    backward: a value-and-grad), ``plain`` under no_grad (Brent)."""

    def __init__(self):
        from libpll_tpu_torch.engine import lbfgs, modelopt

        self.lbfgs, self.modelopt = lbfgs, modelopt
        self.steps = self.grad = self.plain = 0

    def __enter__(self):
        import torch

        real_update = self.lbfgs.update
        real_make = self.modelopt.make_param_score
        self.real = real_update, real_make

        def update(*a, **k):
            self.steps += 1
            return real_update(*a, **k)

        def make(*a, **k):
            score, branches = real_make(*a, **k)

            def counted(*args):
                if torch.is_grad_enabled():
                    self.grad += 1
                else:
                    self.plain += 1
                return score(*args)
            return counted, branches

        self.lbfgs.update = update
        self.modelopt.make_param_score = make
        return self

    def __exit__(self, *exc):
        self.lbfgs.update, self.modelopt.make_param_score = self.real


def sweep_pair(tree, part, pidx):
    """infer_tree's ``run_blopt()``: two full sweeps of the scan driver,
    the capacity doubled on CapacityError.  Returns (logL, sweeps)."""
    from libpll_tpu_torch.engine import blopt
    from libpll_tpu_torch.errors import CapacityError

    cap = 32
    while True:
        try:
            return blopt.optimize_branch_lengths_scan(
                tree, part, pidx, max_sweeps=2, capacity=cap)
        except CapacityError:
            cap *= 2


def phase_modelopt(device, card, res, alignment):
    """Phase 34: model fitting on phase 33's final tree and Partition
    (scripts/bench_infer.py's 1 024 x 16 384, float32), with no second
    search: ``optimize_model(part, tree, **BENCH_FIT_ARGS,
    dtype=torch.float32)`` from JC with α 0.8, as infer_tree's refit after
    a search makes it, then one run_blopt-style sweep pair with the U1
    and N1 counters at 0 around it.  Checks: the trajectory
    non-decreasing, the Partition carrying the fit, the fit's logL within
    the f32 budget of a fresh float64 Partition on the card under the
    fitted model (the tree as the fit saw it), U1 and N1 launched in the
    sweeps and no plain version run (PlainCalls).  Prints the fitted
    parameters beside the generating ones, the logL before and after, the
    L-BFGS steps and evaluations, s a fit, ms a value-and-grad and a Brent
    evaluation (CUDA-synchronised wall), where the eigendecomposition runs
    and what it costs, the peak device memory and the card's idle share
    over one value-and-grad and its kernels with the most device time
    (torch.profiler).  Returns the numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine import modelopt
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.models.gtr import eigen_decompose_torch
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.search.stepwise import deep_recursion
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.flagship import (INFER_ALPHA, INFER_FREQS,
                                                 INFER_PARAMS)

    part, tree, pidx = res.partition, res.tree, [0] * 4
    seqs, weights = alignment
    tips = tree.tip_count
    # the search fixed the model at JC with α 0.8: the fit starts there
    check(np.all(part.subst_params == 1.0) and np.all(part.frequencies
                                                      == 0.25),
          "phase 33's Partition is not at JC")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with deep_recursion(tips), FitCounter() as cnt:
        t0 = time.perf_counter()
        fit = modelopt.optimize_model(part, tree, dtype=torch.float32,
                                      **BENCH_FIT_ARGS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        newick = ut.export_newick(tree.root)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(fit.trajectory == sorted(fit.trajectory) and np.isfinite(fit.logl)
          and written_back(part, fit) and np.allclose(
              part.rates, compute_gamma_cats(fit.alpha, 4), rtol=0, atol=0),
          f"bench fit: trajectory {fit.trajectory}, or the Partition does "
          f"not carry the fit")

    counters = {"U1": clv_ops._replay_ops, "N1": dv._newton_solve}
    torch.cuda.synchronize()
    for wrapper in counters.values():
        wrapper.launches = 0
    with deep_recursion(tips), PlainCalls() as plain:
        t0 = time.perf_counter()
        logl_bl, sweeps = sweep_pair(tree, part, pidx)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counters.items()}
    check(all(v > 0 for v in launches.values())
          and not any(plain.calls.values()),
          f"after the fit: launches {launches}, plain versions run "
          f"{plain.calls}")
    check(logl_bl >= fit.logl - ACC_REL * abs(fit.logl) - ACC_ABS,
          f"the sweeps after the fit lost logL: {logl_bl!r} < {fit.logl!r}")

    with deep_recursion(tips):
        tree64 = ut.parse_newick_string(newick)
        t0 = time.perf_counter()
        want = fresh_f64_logl(tree64, seqs, len(next(iter(seqs.values()))),
                              device, weights,
                              (fit.frequencies, fit.subst_params, fit.alpha))
        fresh_s = time.perf_counter() - t0
    budget = ACC_REL * abs(want) + ACC_ABS
    check(abs(fit.logl - want) <= budget,
          f"bench fit logL {fit.logl!r}, a fresh float64 Partition under "
          f"the fitted model {want!r} (budget {budget})")

    # a value-and-grad and a Brent evaluation alone, timed and profiled,
    # on the swept tree under the fitted model
    torch.cuda.empty_cache()
    score, bl = modelopt.make_param_score(part, tree, dtype=torch.float32)
    host = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa
    ls = torch.log(host(fit.subst_params[:-1]))
    fl = torch.log(host(fit.frequencies))
    rest = (host(fit.rates), host(fit.rate_weights), host(0.0), host(bl))

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
        t0 = time.perf_counter()
        for _ in range(MODELOPT_TIMED):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / MODELOPT_TIMED

    vg_ms, brent_ms = wall_ms(value_and_grad), wall_ms(brent_eval)
    vg_idle = profiled_idle(value_and_grad)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        value_and_grad()
        torch.cuda.synchronize()
    vg_top = top_kernels(prof, 6)
    levels = len(ev.topology_from_tree(tree, part.sites)[0].schedule.levels)
    # the eigendecomposition: on the host in float64 with its factors
    # copied to the card (the fit's placement), against the card's eigh
    subst = torch.cat([torch.exp(ls), torch.ones(1, dtype=torch.float64)])
    freqs = torch.softmax(fl, dim=0)

    def eigen_host():
        w, left, right = eigen_decompose_torch(subst[None], freqs[None])
        return [t.to(device, torch.float32) for t in (w, left, right)]

    def eigen_card():
        return eigen_decompose_torch(subst[None].to(device),
                                     freqs[None].to(device))

    eig_host_ms, eig_card_ms = wall_ms(eigen_host), wall_ms(eigen_card)
    del score
    torch.cuda.empty_cache()

    gen = dict(zip(("A-C", "A-G", "A-T", "C-G", "C-T", "G-T"),
                   INFER_PARAMS))
    print(f"[34 modelopt] {card}: scripts/bench_infer.py's {tips} x "
          f"{BENCH_INFER_SITES} ({len(bl)} branches, "
          f"{len(next(iter(seqs.values())))} patterns), phase 33's final "
          f"tree, float32: optimize_model(alpha=0.8, rounds="
          f"{BENCH_FIT_ARGS['rounds']}) from JC in "
          f"{fit_s:.2f} s: logL {fit.trajectory[0]!r} -> {fit.logl!r} "
          f"(trajectory " + ", ".join(f"{x:.3f}" for x in fit.trajectory)
          + f"), a fresh float64 Partition under the fitted model {want!r} "
          f"(|d| {abs(fit.logl - want):.4f} <= {budget:.3f}, built in "
          f"{fresh_s:.1f} s); L-BFGS steps {cnt.steps}, value-and-grad "
          f"evaluations {cnt.grad}, Brent evaluations {cnt.plain}; fitted "
          f"(generating): " + ", ".join(
              f"{k} {v:.4f} ({g})" for k, v, g in zip(
                  gen, fit.subst_params, INFER_PARAMS))
          + ", freqs " + ", ".join(f"{v:.4f}" for v in fit.frequencies)
          + f" ({', '.join(str(v) for v in INFER_FREQS)}), alpha "
          f"{fit.alpha:.4f} ({INFER_ALPHA}); peak device memory "
          f"{peak_gib:.3f} GiB; then {sweeps} full branch-length sweeps in "
          f"{sweep_s:.2f} s: logL {logl_bl!r}, launches {launches}, plain "
          f"versions run {sum(plain.calls.values())}", flush=True)
    print(f"[34 modelopt] {card}: one value-and-grad (plain float32 sweep "
          f"forward and backward) {vg_ms:.2f} ms, one Brent evaluation "
          f"(forward under no_grad) {brent_ms:.2f} ms (mean of "
          f"{MODELOPT_TIMED}, wall with the card synchronised); a "
          f"value-and-grad under torch.profiler: wall {vg_idle[0]:.1f} ms, "
          f"the card busy {vg_idle[1]:.1f} ms in {vg_idle[4]} kernels, idle "
          f"{vg_idle[2] * 100:.1f}% of the wall ({vg_idle[3] * 100:.1f}% "
          f"of the kernels' span); the tree's {levels} levels; its kernels "
          f"with the most device time (ms, launches): " + "; ".join(
              f"{name} {t:.2f} {n}" for name, t, n in vg_top)
          + f"; the eigendecomposition on the host in "
          f"float64 with its factors copied to the card (the fit's "
          f"placement) {eig_host_ms:.3f} ms, torch.linalg.eigh on the card "
          f"{eig_card_ms:.3f} ms", flush=True)
    return dict(fit_s=fit_s, vg_ms=vg_ms, brent_ms=brent_ms,
                idle=vg_idle[2], steps=cnt.steps, grad=cnt.grad,
                plain=cnt.plain, launches=launches)


# ---------------------------------------------------------------------------
# 35: site sharding, two ranks on the one card
# ---------------------------------------------------------------------------
MESH_WORLD = 2
MESH_TIMEOUT = 600  # s: the two ranks' whole run
MESH_COLLECTIVE_TIMEOUT = 300  # s: one collective's (a dead peer's) limit
MESH_REPEATS = 3  # sharded score calls timed
MESH_PROBES = 500  # reductions of three float64 timed by themselves


def mesh_counters():
    """The wrappers whose launches phase 35 reads: K1, K6, U1, C1, N1 (the
    one-launch solve and the derivative mode), P2, P3."""
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.ops import incremental as inc_ops

    return {"K1": cf.fused_edge_score, "K6": cd.DynScore,
            "U1": clv_ops._replay_ops, "C1": inc_ops._score_candidates,
            "N1": dv._newton_solve, "N1d": dv._newton_derivatives,
            "P2": fitch.fitch_scores, "P3": fitch.stepwise_commit}


class MeshRun:
    """One main path of a rank: every counter at 0 and the mesh's
    reduction count and time noted on entry; on exit the launches, the
    reductions and their seconds, and the wall (the card synchronised)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        for w in mesh_counters().values():
            w.launches = 0
        self.red = (self.mesh.reductions, self.mesh.reduce_seconds)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.s = time.perf_counter() - self.t0
        self.launches = {k: w.launches for k, w in mesh_counters().items()}
        self.reductions = self.mesh.reductions - self.red[0]
        self.reduce_s = self.mesh.reduce_seconds - self.red[1]

    def record(self, **kw):
        return dict(kw, s=self.s, launches=self.launches,
                    reductions=self.reductions, reduce_s=self.reduce_s)


def mesh_rank(init_method, rank, data_path, out_path):
    """Phase 35 in one rank (``chip_smoke.py --mesh-rank``, spawned by
    ``phase_mesh``): join the gloo group on cuda:0 and run this rank's
    share of the four sharded paths with the same arguments as the other
    rank, writing their results to ``out_path`` (JSON): the flagship
    through ``make_score_sharded`` (K1 on the rank's 131 072 sites, and
    that K1 launch against its plain version), the giant through
    ``make_score_unbounded_sharded`` (K6 on 524 288 sites, the tips drawn
    on the card as phase 9 draws them), the word-sharded stepwise build at
    2 048 x 2 048, and ``infer_tree(mesh=)`` at phase 33's call with no
    plain version run; then N1's derivative mode against its plain twin at
    the final tree's root edge, both timed, with its bound."""
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.evaluate import partition_model
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.ops import roofline
    from libpll_tpu_torch.parallel import mesh as pm
    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import (deep_recursion,
                                                  fastparsimony_stepwise)
    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_SITES,
                                                 FLAGSHIP_TIPS,
                                                 build_flagship,
                                                 build_flagship_topology,
                                                 draw_tipchars_cuda)

    rank = int(rank)
    device = torch.device("cuda", 0)
    # one intra-op thread a rank: the host side issues many tiny operations
    torch.set_num_threads(1)
    pm.initialize_distributed(init_method, MESH_WORLD, rank, backend="gloo",
                              device=device, timeout=MESH_COLLECTIVE_TIMEOUT)
    mesh = pm.make_sites_mesh(device=device)
    out = {"rank": rank, "size": mesh.size}

    # a reduction by itself: mesh.sum's exchange against gloo's all_reduce
    probe = {}
    for name, reduce in (("exchange", mesh.sum),
                         ("all_reduce", lambda x: dist.all_reduce(x))):
        for k in range(MESH_PROBES + 50):  # the first 50 warm up
            if k == 50:
                t0 = time.perf_counter()
            reduce(torch.ones(3, dtype=torch.float64))
        probe[name] = (time.perf_counter() - t0) / MESH_PROBES * 1e3
    out["probe"] = probe

    # the flagship: K1 on this rank's sites, one reduction a call
    topo, model_np, masks, _ = build_flagship(
        FLAGSHIP_TIPS, FLAGSHIP_SITES, rate_cats=4, seed=0, tip_masks=True)
    lo, hi = mesh.local(FLAGSHIP_SITES)
    tp = cf.pack_tipchars(np.ascontiguousarray(masks[:, lo:hi])).to(device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    score = ev.make_score_sharded(topo, 4, 4, mesh, tip_encoding="chars")
    with MeshRun(mesh) as run:
        logl = float(score(m32, tp))
    local = score.local
    pm_ = local.pmatrices(m32, torch.float32)
    wvec = cf.pack_weight_vec(m32["freqs_pc"], m32["rate_weights"])
    pw = m32["pattern_weights"][lo:hi]
    edge = dict(parent_clv=topo.parent_clv, child_clv=topo.child_clv,
                edge_matrix=topo.edge_matrix, tip_encoding="chars")
    k1 = float(cf.fused_edge_score(topo.schedule, tp, pm_, wvec, pw,
                                   plan=local.plan, **edge))
    k1_plain = float(cf.fused_edge_score_plain(topo.schedule, tp, pm_, wvec,
                                               pw, **edge))
    times = []
    for _ in range(MESH_REPEATS):
        with MeshRun(mesh) as t:
            score(m32, tp)
        times.append(t.s * 1e3)
    out["flagship"] = run.record(logl=logl, sites=hi - lo, k1=k1,
                                 k1_plain=k1_plain, ms=times)
    del score, local, tp, masks
    torch.cuda.empty_cache()

    # the giant: K6 on this rank's sites, its layout from the rank's share
    topo, model_np = build_flagship_topology(GIANT_TIPS, GIANT_SITES, seed=0)
    lo, hi = mesh.local(GIANT_SITES)
    full = draw_tipchars_cuda(GIANT_TIPS, GIANT_SITES, 0, device)
    tp = full[:, lo:hi].contiguous()
    del full
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    score = ev.ScoreUnboundedSharded(topo, 4, 4, mesh, tp, "chars")
    sched_s = time.perf_counter() - t0
    m32 = model_from_numpy(model_np, device, torch.float32)
    with MeshRun(mesh) as run:
        logl = float(score(m32))
    with MeshRun(mesh) as t:
        score(m32)
    out["giant"] = run.record(
        logl=logl, sites=hi - lo, ms=t.s * 1e3, schedule_s=sched_s,
        segments=len(score.local.dyn.segments),
        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del score, tp
    torch.cuda.empty_cache()

    # the word-sharded stepwise build
    tips, sites = STEPWISE_CASES[0]
    seqs, labels = bench_stepwise_alignment(tips, sites)
    pars = FastParsimony.from_sequences(seqs, maps.pll_map_nt, 4,
                                        device=device)
    with MeshRun(mesh) as run:
        tree, pscore = fastparsimony_stepwise([pars], labels, STEPWISE_SEED,
                                              mesh=mesh)
    digest, length = newick_digest(tree)
    out["stepwise"] = run.record(score=pscore, digest=digest, length=length,
                                 words=int(pars.vectors.shape[-1]))
    del pars, tree
    torch.cuda.empty_cache()

    # infer_tree(mesh=) at phase 33's call
    with open(data_path, "rb") as f:
        data = pickle.load(f)
    with PlainCalls() as plain, MeshRun(mesh) as run:
        res = infer_tree(data, dtype=torch.float32,
                         max_rounds=BENCH_INFER_MAX_ROUNDS, mesh=mesh,
                         **BENCH_INFER_ARGS)
    with deep_recursion(len(data)):
        newick = ut.export_newick(res.tree.root)
    part = res.partition
    out["infer"] = run.record(
        logl=res.logl, start=res.start_parsimony_score, rounds=res.rounds,
        trajectory=res.trajectory, timings=res.timings, newick=newick,
        plain=sum(plain.calls.values()), sites=part.sites,
        global_sites=part.global_sites)

    # N1's derivative mode against its plain twin at the root edge
    u = res.tree.root
    model = partition_model(part, [0] * 4)
    pidx = model["params_indices"].long()
    st = dv.update_sumtable(part.clv[u.clv_index], part.clv[u.back.clv_index],
                            None, None, model["freqs_pc"],
                            model["left"][pidx], model["right"][pidx])
    t = torch.tensor([u.length], dtype=torch.float32, device=device)
    args = dict(rates=model["rates"], prop_invar=model["prop_invar_pc"],
                eigenvals_pc=model["eigenvals"][pidx],
                freqs_pc=model["freqs_pc"],
                rate_weights=model["rate_weights"],
                invariant=model["invariant"],
                pattern_weights=model["pattern_weights"], sites=part.sites)
    body = dv.derivative_body({}, st, **args)
    t_host = t.cpu()[0]
    got = body(t_host)
    want = dv.newton_derivatives_plain(st, t, **args).cpu()
    sizes = newton_abs_sums(dict(args, sumtable=st, asc_mode=0), t[0])
    errs = [abs(float(got[i]) - float(want[i])) for i in range(2)]
    ok = all(e <= F32_RTOL * (size + abs(float(want[i])))
             for i, (e, size) in enumerate(zip(errs, sizes)))
    c, s_, length = st.shape
    peak = roofline.fp32_peak(*roofline_card(device))
    out["n1d"] = dict(
        ok=ok, err=max(errs), got=got.tolist(), want=want.tolist(),
        ms=float(profiled_ms(lambda: body(t_host), "newton_solve_kernel")),
        body_ms=time_ms(lambda: body(t_host), iters=50)[0],
        plain_ms=time_ms(lambda: dv.newton_derivatives_plain(st, t, **args),
                         iters=10)[0],
        bound=bound(newton_flop(c, s_) * part.sites,
                    st.numel() * 4 + length * 8 + 3 * 8, peak),
        plan=plan_text(dv.plan_for(st, part.sites)), shape=[c, s_, length])
    with open(out_path, "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def phase_mesh(device, card, refs):
    """Phase 35: two ranks, each a process of its own (``mesh_rank``),
    joined by gloo on the one card (NCCL takes one rank a card); the
    parent frees its cached device memory first.  Both ranks' results are
    read back and must be equal; against ``refs`` (the one-rank runs of
    phases 4, 9 and 33): the flagship's and the giant's logL within the
    f32 budget of phases 4 and 9 (the same per-site values summed in
    another order), each rank's K1 launch against its plain version; the
    stepwise build's score and Newick libpll_tpu's (STEPWISE_JAX), P2 and
    P3 once an insertion; infer_tree(mesh=)'s start score phase 33's and
    libpll_tpu's, its logL within the f32 budget of phase 33's, RF
    printed, U1, C1, N1's derivative mode, P2 and P3 launched and neither
    the one-launch solve nor a plain version run; N1's derivative mode
    within F32_RTOL of its plain twin.  A rank that fails, or outlasts
    MESH_TIMEOUT, fails the phase; the other is killed.  Returns the
    numbers the JSON line takes."""
    import pickle
    import tempfile

    import torch

    from libpll_tpu_torch.tree import utree as ut
    from libpll_tpu_torch.tree.compare import rf_distance
    from libpll_tpu_torch.search.stepwise import deep_recursion

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with open(tmp / "data.pkl", "wb") as f:
            pickle.dump(refs["data"], f)
        logs = [open(tmp / f"rank{r}.log", "w") for r in range(MESH_WORLD)]
        # both ranks on this host: gloo over the loopback device, not the
        # (slower) interface the host name resolves to
        env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
             f"file://{tmp}/rendezvous", str(r), str(tmp / "data.pkl"),
             str(tmp / f"rank{r}.json")], cwd=ROOT, stdout=logs[r],
            stderr=subprocess.STDOUT, env=env) for r in range(MESH_WORLD)]
        try:
            while any(p.poll() is None for p in procs):
                failed = [p.returncode for p in procs
                          if p.returncode not in (None, 0)]
                if failed or time.perf_counter() - t0 > MESH_TIMEOUT:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        wall = time.perf_counter() - t0
        codes = [p.returncode for p in procs]
        if any(codes):
            tails = "\n".join(
                f"--- rank {r} (exit {c}):\n"
                + (tmp / f"rank{r}.log").read_text()[-3000:]
                for r, c in enumerate(codes))
            fail(f"phase 35: a rank failed or timed out after {wall:.0f} s "
                 f"(exit codes {codes}):\n{tails}")
        ranks = [json.loads((tmp / f"rank{r}.json").read_text())
                 for r in range(MESH_WORLD)]

    r0, r1 = ranks
    same = {k: (r0[k].get("logl"), r0[k].get("score"), r0[k].get("newick"))
            == (r1[k].get("logl"), r1[k].get("score"), r1[k].get("newick"))
            for k in ("flagship", "giant", "stepwise", "infer")}
    check(all(same.values()), f"phase 35: the ranks disagree: {same}")
    fl, gi, sw, inf, nd = (r0[k] for k in ("flagship", "giant", "stepwise",
                                           "infer", "n1d"))

    def within(got, want, what):
        budget = ACC_REL * abs(want) + ACC_ABS
        check(np.isfinite(got) and abs(got - want) <= budget,
              f"phase 35 {what}: logL {got!r}, one rank {want!r} (budget "
              f"{budget})")
        return abs(got - want)

    d_fl = within(fl["logl"], refs["flagship"], "flagship")
    for r in ranks:
        check(r["flagship"]["launches"]["K1"] == 1,
              f"phase 35 flagship: K1 launches {r['flagship']['launches']}")
        err = abs(r["flagship"]["k1"] - r["flagship"]["k1_plain"])
        check(err <= ACC_REL * abs(r["flagship"]["k1_plain"]) + ACC_ABS,
              f"phase 35 rank {r['rank']}: K1 on its sites "
              f"{r['flagship']['k1']!r}, plain {r['flagship']['k1_plain']!r}")
    d_gi = within(gi["logl"], refs["giant"], "giant")
    check(all(r["giant"]["launches"]["K6"] > 0 for r in ranks),
          f"phase 35 giant: K6 launches {gi['launches']}")
    want = STEPWISE_JAX[STEPWISE_CASES[0]]
    tips = STEPWISE_CASES[0][0]
    check((sw["score"], sw["digest"], sw["length"]) == want,
          f"phase 35 stepwise: score {sw['score']}, Newick "
          f"{sw['digest'][:16]}.., libpll_tpu {want[0]}, {want[1][:16]}..")
    check(sw["launches"]["P2"] == tips - 3 and sw["launches"]["P3"]
          == tips - 1, f"phase 35 stepwise: launches {sw['launches']}")
    check(inf["start"] == refs["infer"]["start"] == BENCH_INFER_START_JAX,
          f"phase 35 infer: start {inf['start']}, one rank "
          f"{refs['infer']['start']}")
    check(inf["trajectory"] == sorted(inf["trajectory"]),
          f"phase 35 infer: trajectory {inf['trajectory']}")
    d_inf = within(inf["logl"], refs["infer"]["logl"], "infer_tree")
    ran = inf["launches"]
    check(all(ran[k] > 0 for k in ("U1", "C1", "N1d", "P2", "P3"))
          and ran["N1"] == 0 and inf["plain"] == 0,
          f"phase 35 infer: launches {ran}, plain versions {inf['plain']}")
    with deep_recursion(BENCH_INFER_TIPS):
        rf = rf_distance(ut.parse_newick_string(inf["newick"]),
                         ut.parse_newick_string(refs["infer"]["newick"]))
    check(all(r["n1d"]["ok"] for r in ranks),
          f"phase 35: N1's derivative mode against its plain twin: "
          f"{[(r['n1d']['got'], r['n1d']['want']) for r in ranks]}")

    def red(x):
        return (f"{x['reductions']} reductions in {x['reduce_s']:.3f} s "
                f"({x['reduce_s'] / max(x['reductions'], 1) * 1e3:.3f} ms "
                f"each)")

    one = refs["infer"]["s"]
    print(f"[35 mesh] {card}: {MESH_WORLD} gloo ranks on cuda:0, one "
          f"process each, {wall:.1f} s in all; flagship "
          f"{refs['flagship_shape'][0]} x {refs['flagship_shape'][1]} "
          f"through make_score_sharded ({fl['sites']} "
          f"sites a rank, one K1 launch each, K1 equal to its plain version "
          f"on each rank's sites): logL {fl['logl']!r} on both ranks, phase "
          f"4's {refs['flagship']!r} (|d| {d_fl:.3e}); wall a call "
          + ", ".join(f"{x:.2f}" for x in fl["ms"]) + f" ms, {red(fl)} in "
          f"the first; giant {GIANT_TIPS} x {GIANT_SITES} through "
          f"make_score_unbounded_sharded ({gi['sites']} sites a rank, "
          f"{gi['segments']} segments, {gi['launches']['K6']} K6 launches "
          f"a rank, schedule {gi['schedule_s']:.1f} s, peak "
          f"{gi['peak_gib']:.2f} GiB a rank): logL {gi['logl']!r}, phase "
          f"9's {refs['giant']!r} (|d| {d_gi:.3e}); {gi['ms']:.1f} ms a "
          f"call (wall), {red(gi)}", flush=True)
    print(f"[35 mesh] {card}: the word-sharded stepwise build at {tips} x "
          f"{STEPWISE_CASES[0][1]} ({sw['words']} words, "
          f"{sw['words'] // MESH_WORLD} a rank): score {sw['score']} and "
          f"Newick libpll_tpu's (phase 25's), P2 {sw['launches']['P2']} "
          f"and P3 {sw['launches']['P3']} launches a rank, "
          f"{sw['s']:.2f} s, {red(sw)}", flush=True)
    print(f"[35 mesh] {card}: infer_tree(mesh=) at phase 33's call "
          f"(max_rounds {BENCH_INFER_MAX_ROUNDS}; {inf['global_sites']} "
          f"patterns with the pad, {inf['sites']} a rank): time-to-tree "
          f"{inf['s']:.2f} s (phases " + ", ".join(
              f"{k} {v:.2f} s" for k, v in inf["timings"].items())
          + f"; one rank, phase 33: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in one.items())
          + f"); start parsimony {inf['start']} (one rank "
          f"{refs['infer']['start']}); rounds {inf['rounds']} (one rank "
          f"{refs['infer']['rounds']}); logL {inf['logl']!r}, one rank "
          f"{refs['infer']['logl']!r} (|d| {d_inf:.4f}); RF to the one-rank "
          f"tree {rf}; launches a rank {ran}, plain versions run 0; "
          f"{red(inf)}", flush=True)
    print(f"[35 mesh] {card}: a reduction of three float64 by itself, "
          f"{MESH_PROBES} back to back after 50 (host clock, rank 0 / rank "
          f"1): SitesMesh.sum's exchange " + " / ".join(
              f"{r['probe']['exchange']:.4f}" for r in ranks)
          + " ms, gloo's all_reduce " + " / ".join(
              f"{r['probe']['all_reduce']:.4f}" for r in ranks) + " ms",
          flush=True)
    print(f"[35 mesh] {card}: N1's derivative mode at the final tree's root"
          f" edge ({nd['shape']} float32 sumtable a rank; {nd['plan']}): "
          f"[d1, d2, w] {nd['got']} vs its plain twin {nd['want']} (largest"
          f" |d| {nd['err']:.3e}, within {F32_RTOL} of the sums' size); "
          f"{nd['ms'] * 1e3:.2f} us a launch on the card (torch.profiler), "
          f"{nd['body_ms'] * 1e3:.1f} us a body's wall (the launch, the "
          f"stream synchronised, the host's work; CUDA events, 50 back to "
          f"back) vs plain {nd['plain_ms']:.3f} ms; bound "
          f"{nd['bound'][0] * 1e3:.4f} us ({nd['bound'][1]}), "
          f"{nd['bound'][0] / nd['ms'] * 100:.1f}%", flush=True)
    return dict(n1d=nd, launches=ran["N1d"], probe=r0["probe"])


def main():
    if sys.argv[1:2] == ["--mesh-rank"]:  # phase 35's ranks
        return mesh_rank(*sys.argv[2:])
    if sys.argv[1:2] == ["--cpu-refs"]:  # phases 24 and 32's CPU sides
        return cpu_refs_main(*sys.argv[2:])
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (ROOT / "libpll_tpu_torch" / "csrc" / "clv_fused.cu").exists():
        fail(f"no libpll_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    # float32 products stay float32 in every plain reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from libpll_tpu_torch.engine import evaluate as ev
    from libpll_tpu_torch.engine.params import model_from_numpy
    from libpll_tpu_torch.ops import _build
    from libpll_tpu_torch.ops import clv as clv_ops
    from libpll_tpu_torch.ops import clv_dyn as cd
    from libpll_tpu_torch.ops import clv_fused as cf
    from libpll_tpu_torch.ops import clv_seg as cseg
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.ops import fitch
    from libpll_tpu_torch.ops import incremental as inc_ops
    from libpll_tpu_torch.ops import roofline as rf
    from libpll_tpu_torch.utils.flagship import (FLAGSHIP_RATE_CATS,
                                                 FLAGSHIP_SITES,
                                                 FLAGSHIP_STATES,
                                                 FLAGSHIP_TIPS,
                                                 build_flagship)

    starts = [("1-3", time.perf_counter())]  # (phases, start), printed last
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = rf.max_sm_clock_mhz()
    fp32_peak = rf.fp32_peak(sms, clock_mhz)
    print(f"[1 card] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    sources = _build.SOURCES
    _build.build_all(sources)  # one nvcc each, all at once
    build_s = time.perf_counter() - t0
    for module in (cf, cd, cseg, rf, dv, fitch, clv_ops, inc_ops):
        module.load_kernels()
    fused = ptxas_report("clv_fused")
    print(f"[2 build] {', '.join(f'{n}.cu' for n in sources)} for sm_90a "
          f"in {build_s:.2f} s (in parallel); clv_fused: {len(fused)} kernel "
          f"instances, at most {max(r for _, r, _, _ in fused)} registers, "
          f"instances with spills: {sum(1 for _, _, b, _ in fused if b)}, "
          f"largest stack frame {max(st for *_, st in fused)} bytes",
          flush=True)
    print("[2 build] clv_fused.cu protein instances <dtype,C,K1,sites a "
          "thread> (registers, spill bytes, stack bytes): " + "; ".join(
              f"{lab} {r}, {b}, {st}" for lab, r, b, st in
              ptxas_report("clv_fused", "fused_protein_kernel")),
          flush=True)
    cpu_refs = CpuRefs()  # phases 24 and 32's CPU sides, beside the card's

    t0 = time.perf_counter()
    n, k1_small, k2_small = check_small(device)
    print(f"[3 small] {n} kernel configurations match their plain versions "
          f"({time.perf_counter() - t0:.1f} s); largest f32 deviations: K1 "
          f"|d logL| {k1_small:.3e}, K2 CLV abs {k2_small:.3e}", flush=True)

    # ---------------------------------------------------- 4: flagship
    starts.append(("4", time.perf_counter()))
    tips, sites = FLAGSHIP_TIPS, FLAGSHIP_SITES
    c, s = FLAGSHIP_RATE_CATS, FLAGSHIP_STATES
    topo, model_np, masks, _ = build_flagship(tips, sites, rate_cats=c,
                                              seed=0, tip_masks=True)
    sched = topo.schedule
    tp = cf.pack_tipchars(masks).to(device)
    m32 = model_from_numpy(model_np, device, torch.float32)
    m64 = model_from_numpy(model_np, device, torch.float64)
    score = ev.make_score(topo, c, s, tip_encoding="chars").to(device)
    fwd = ev.make_forward_fused(topo, c, s, tip_encoding="chars").to(device)

    clv64 = torch.cat([
        cf.decode_tips(tp, "chars", torch.arange(tips, device=device), c, s,
                       torch.float64),
        torch.zeros((sched.n_inner, c, s, sites), dtype=torch.float64,
                    device=device)])
    scal = torch.zeros((sched.n_inner + 1, sites), dtype=torch.int32,
                       device=device)
    want = float(ev.make_forward(topo).to(device)(m64, clv64, scal)[0])
    del clv64, scal

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cf.fused_edge_score.launches = 0
    cf.fused_sweep.launches = 0
    got_score = float(score(m32, tp))
    torch.cuda.synchronize()
    score_peak = torch.cuda.max_memory_allocated()
    got_fwd = float(fwd(m32, tp)[0])
    torch.cuda.synchronize()
    launches = {"fused_edge_score": cf.fused_edge_score.launches,
                "fused_sweep": cf.fused_sweep.launches}
    check(all(v == 1 for v in launches.values()),
          f"main path: launches {launches}, want one of each")
    budget = ACC_REL * abs(want) + ACC_ABS
    for name, got in (("make_score", got_score),
                      ("make_forward_fused", got_fwd)):
        check(np.isfinite(got) and abs(got - want) <= budget,
              f"flagship {name} f32 logL {got} vs plain f64 {want} "
              f"(budget {budget})")

    # each kernel against its plain version at the main path's shapes
    pm, wvec, pw, _ = kernel_inputs(topo, model_np, torch.float32, device,
                                    False)
    edge = dict(parent_clv=topo.parent_clv, child_clv=topo.child_clv,
                edge_matrix=topo.edge_matrix, tip_encoding="chars")
    k1 = lambda: cf.fused_edge_score(sched, tp, pm, wvec, pw,
                                     plan=score.plan, **edge)
    k1_plain = lambda: cf.fused_edge_score_plain(sched, tp, pm, wvec, pw,
                                                 **edge)
    k2 = lambda: cf.fused_sweep(sched, tp, pm, plan=fwd.plan,
                                tip_encoding="chars")
    k2_plain = lambda: cf.fused_sweep_plain(sched, tp, pm,
                                            tip_encoding="chars")
    k1_err = abs(float(k1()) - float(k1_plain()))
    check(k1_err <= budget, f"flagship K1 vs plain: |d logL| {k1_err}")
    ok, k2_err, agree = sweep_close(*k2(), *k2_plain(), torch.float32)
    check(ok, f"flagship K2 vs plain: max abs err {k2_err}, scaler "
              f"agreement {agree}")
    lay = {name: mod.plan.layout(torch.float32, c, s, topo.scale_mode,
                                 is_k1)
           for name, mod, is_k1 in (("K1", score, True), ("K2", fwd, False))}
    print(f"[4 flagship] {tips} taxa x {sites} sites x {c} rates f32 chars: "
          f"make_score {got_score!r}, make_forward_fused {got_fwd:.6f}, "
          f"plain f64 make_forward {want:.6f} (|d| {abs(got_score - want):.3e}"
          f", {abs(got_fwd - want):.3e} <= {budget:.3e}); launches "
          f"{launches}; K1-plain |d logL| {k1_err:.3e}; K2-plain max abs "
          f"{k2_err:.3e}, scalers agree {agree:.6f}; walk: pool "
          f"{score.plan.pool} slots (K2 {fwd.plan.pool}), " + "; ".join(
              f"{name} {v['smem']} B shared memory per block of "
              f"{v['threads']} threads x {v['block_sites']} sites, chunks of "
              f"{v['chunk']} ops, {v['blocks_per_sm']} blocks per SM"
              for name, v in lay.items())
          + f"; make_score peak device memory {score_peak / 2**30:.4f} GiB",
          flush=True)

    # ---------------------------------------------------- 5: times
    starts.append(("5", time.perf_counter()))
    updates = sched.n_inner * sites * c

    def score_plain():  # make_score's forward with the plain K1
        pmatrix = score.pmatrices(m32, torch.float32)
        w = cf.pack_weight_vec(m32["freqs_pc"], m32["rate_weights"])
        return cf.fused_edge_score_plain(sched, tp, pmatrix, w,
                                         m32["pattern_weights"], **edge)

    k1_bound = bound((2 * (tips - 2) + 1) * sites * c * CONTRACT_FLOP,
                     (tp.numel() + sites) * 4, fp32_peak)
    k2_bound = bound(2 * sched.n_inner * sites * c * CONTRACT_FLOP,
                     (tp.numel() + sched.n_inner * c * s * sites
                      + (sched.n_inner + 1) * sites) * 4, fp32_peak)
    graphed = score.graphed(m32, tp)  # make_score as one CUDA graph
    got_graph = float(graphed(m32, tp))
    check(got_graph == got_score, f"flagship make_score in a CUDA graph "
                                  f"{got_graph!r}, eager {got_score!r}")
    runs = {"score": lambda: score(m32, tp), "score_plain": score_plain,
            "forward_fused": lambda: fwd(m32, tp), "k1": k1,
            "k1_plain": k1_plain, "k2": k2, "k2_plain": k2_plain,
            "score_graph": lambda: graphed(m32, tp)}
    timed = {name: time_ms(fn) for name, fn in runs.items()}
    ms = {name: dev for name, (dev, _) in timed.items()}
    host = {name: h for name, (_, h) in timed.items()}
    idle = {name: host_ms(runs[name])
            for name in ("score", "forward_fused", "score_graph")}
    print(f"[5 times] {card}: make_score (K1) {ms['score']:.4f} ms/eval = "
          f"{updates / ms['score'] * 1e3:.4e} CLV updates/s (host issues a "
          f"call in {host['score']:.4f} ms); with the plain K1 "
          f"{ms['score_plain']:.4f} ms/eval = "
          f"{updates / ms['score_plain'] * 1e3:.4e}/s; make_forward_fused "
          f"(K2) {ms['forward_fused']:.4f} ms/eval (host "
          f"{host['forward_fused']:.4f} ms); kernel alone K1 {ms['k1']:.4f} "
          f"ms vs plain {ms['k1_plain']:.4f} ms; K2 {ms['k2']:.4f} ms vs "
          f"plain {ms['k2_plain']:.4f} ms ({TIMED_ITERS} calls after "
          f"{WARMUP} warm-up, CUDA events); host time of one call with the "
          f"card idle: make_score {idle['score']:.4f} ms, "
          f"make_forward_fused {idle['forward_fused']:.4f} ms; make_score "
          f"captured in a CUDA graph {ms['score_graph']:.4f} ms/eval (host "
          f"{host['score_graph']:.4f} ms a call, {idle['score_graph']:.4f} "
          f"ms with the card idle; logL equal to the eager call's)",
          flush=True)

    # ---------------------------------------------------- 6-10: dyn tier
    starts.append(("6-10", time.perf_counter()))
    dyn_rows = ptxas_report("clv_dyn")
    print(f"[6 dyn build] clv_dyn.cu: {len(dyn_rows)} kernel instances "
          f"(dtype, states): " + "; ".join(
              f"{lab} {r} registers, {b} B spill"
              for lab, r, b, _ in dyn_rows),
          flush=True)
    del score, fwd, tp, graphed
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    n, k5_small, k6_small, n_spill = check_dyn_small(device)
    print(f"[7 dyn small] {n} kernel configurations match their plain "
          f"versions, {n_spill} of them with pools capped at "
          f"{SPILL_CAPS} slots so that rows spill "
          f"({time.perf_counter() - t0:.1f} s); largest f32 "
          f"deviations: K5 CLV abs {k5_small:.3e}, K6 |d logL| "
          f"{k6_small:.3e}", flush=True)

    mid = phase_mid(device, fp32_peak)
    giant = phase_giant(device, fp32_peak)

    def share(ms_, b):
        return f"bound {b[0]:.4f} ms ({b[1]}), {b[0] / ms_ * 100:.1f}%"

    print(f"[10 dyn times] {card}: at {MID_TIPS} x {MID_SITES} (DNA, "
          f"per-rate) K6 "
          f"{mid['ms']['k6']:.4f} ms vs plain {mid['ms']['k6_plain']:.4f} "
          f"ms, {share(mid['ms']['k6'], mid['k6_bound'])}; K5 "
          f"{mid['ms']['k5']:.4f} ms vs plain "
          f"{mid['ms']['k5_plain']:.4f} ms ({mid['k5_segments']} segments), "
          f"{share(mid['ms']['k5'], mid['k5_bound'])}; protein "
          f"{PROTEIN_TIPS} x {PROTEIN_SITES} K6 {mid['ms']['protein_k6']:.4f}"
          f" ms; at {GIANT_TIPS} x {GIANT_SITES} K6 {giant['k6_ms']:.2f} ms "
          f"vs plain {giant['k6_plain_ms']:.2f} ms, "
          f"{share(giant['k6_ms'], giant['k6_bound'])} "
          f"(make_score_unbounded {giant['ms']:.2f} ms/eval, {giant['pool']},"
          f" peak device memory {giant['peak_gib']:.2f} GiB); CUDA events",
          flush=True)

    # ---------------------------------------------------- 11-14: seg tier
    starts.append(("11-14", time.perf_counter()))
    for name in ("clv_seg", "roofline"):
        rows = ptxas_report(name)
        print(f"[11 seg build] {name}.cu: {len(rows)} kernel instances: "
              + "; ".join(f"{lab} {r} registers, {b} B spill"
                          for lab, r, b, _ in rows), flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n, k3_small, k4_small, smem = check_seg_small(device)
    print(f"[12 seg small] {n} kernel configurations match their plain "
          f"versions ({time.perf_counter() - t0:.1f} s), layouts up to "
          f"{smem} of a block's {cseg.SMEM_LIMIT} bytes of shared memory; "
          f"largest f32 deviations: K3 CLV abs {k3_small:.3e}, K4 |d logL| "
          f"{k4_small:.3e}", flush=True)
    readme = phase_readme(device, fp32_peak)
    roof = phase_roofline(device, card, ms["k1"], readme["ms"]["k3"],
                          readme["n_inner"])

    # ---------------------------------------------------- 15-17: train step
    starts.append(("15-19", time.perf_counter()))
    rows = ptxas_report("derivatives")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n, n1_small, paths = check_newton_small(device)
    print(f"[15 newton small] derivatives.cu: {len(rows)} kernel instances: "
          + "; ".join(f"{lab} {r} registers, {b} B spill"
                      for lab, r, b, _ in rows)
          + f"; {n} configurations of N1 match its plain twin "
          f"({time.perf_counter() - t0:.1f} s); largest f32 |d t*| "
          f"{n1_small:.3e}; path (R resident, S streamed) of "
          f"{'/'.join(NEWTON_VARIANTS)}: " + ", ".join(
              f"{case} {p}" for case, p in paths.items()), flush=True)
    train = phase_train_step(device, card, fp32_peak)
    torch.cuda.empty_cache()
    protein = phase_protein(device, card, fp32_peak)

    # ---------------------------------------------------- 20-23: partition
    starts.append(("20-23", time.perf_counter()))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n = check_partition_small(device)
    print(f"[20 partition small] {n} configurations: the Partition and the "
          f"executors of ops/clv on the card match the CPU "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    phase_partition(device, card, fp32_peak)
    torch.cuda.empty_cache()
    phase_partition_protein(device)

    # ---------------------------------------------------- 24-26: parsimony
    starts.append(("24-26", time.perf_counter()))
    torch.cuda.empty_cache()
    rows = ptxas_report("fitch")
    t0 = time.perf_counter()
    n = check_parsimony_small(device, cpu_refs)
    print(f"[24 parsimony small] fitch.cu: {len(rows)} kernels: "
          + "; ".join(f"{lab} {r} registers, {b} B spill"
                      for lab, r, b, _ in rows)
          + f"; {n} configurations: P1-P3 equal their plain versions at "
          f"every launch, FastParsimony, both stepwise engines and the "
          f"Sankoff Parsimony on the card equal the CPU "
          f"({time.perf_counter() - t0:.1f} s; the CPU's builds, engines "
          f"and phase 32's CPU runs took {cpu_refs.result()['s']:.1f} s "
          f"in a process beside phases 3-23)", flush=True)
    t0 = time.perf_counter()
    n = check_commit_plans(device)
    past = past_budget_p3(device, sms, clock_mhz)
    print(f"[24 parsimony small] P3 with its tables and grid forced "
          f"({', '.join(f'{t} memory, {g or 'its own'} blocks'
                        for t, g in COMMIT_FORCED)}"
          f"): {n} configurations each equal to the build under its own "
          f"plan (rows, costs, back, edge_rows, scores); past the "
          f"shared-memory budget ({PAST_BUDGET[0]} taxa x {PAST_BUDGET[1]} "
          f"sites, plan {past['plan']}) the last insertion ({past['rows']} "
          f"rows in {past['levels']} levels) equal to the plain version, P3 "
          f"{past['ms'] * 1e3:.1f} us ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    runs = phase_stepwise(device)
    pars = phase_stepwise_times(device, card, sms, clock_mhz, runs)

    # ---------------------------------------------------- 27-29: blopt
    starts.append(("27-29", time.perf_counter()))
    torch.cuda.empty_cache()
    rows = ptxas_report("partials")
    t0 = time.perf_counter()
    small = check_blopt_small(device)
    print(f"[27 blopt small] partials.cu: {len(rows)} kernels: "
          + "; ".join(f"{lab} {r} registers, {b} B spill"
                      for lab, r, b, _ in rows)
          + f"; U1 equal to the plain executor at every launch: "
          f"{small['partition_launches']} of phase 20's {len(PARTITION_SMALL)}"
          f" configurations (float64, float32), {small['random_launches']} "
          f"with the random op tables ({len(REPLAY_SMALL)} (mode, S, C) x 2 "
          f"dtypes, host and padded device tables; {small['forced']} more "
          f"forced to (lanes, window) {REPLAY_FORCED}, each equal bit for "
          f"bit to U1's own plan), the second draw's float64 tables among "
          f"them; its {small['second']['f32']} float32 tables within the "
          f"rule of the plain executor on the CPU (largest rel "
          f"{small['second']['u1_cpu']:.3e}, {small['second']['equal']} "
          f"equal), the card's plain executor (cuBLAS) reading "
          f"{small['second']['u1_card']:.3e} against U1 and "
          f"{small['second']['card_cpu']:.3e} against the CPU's; "
          f"{SWEEP_CHECKED} of a "
          f"bench_infer-shaped sweep's tables ({BENCH_INFER_SITES} sites, "
          f"float32; real ops {small['sweep_real_ops']}), largest f32 rel "
          f"{small['u1_f32_err']:.3e}; N1 with blopt's |d2| rule equal to "
          f"its plain twin in {small['n1']} solves (the rule changed t* in "
          f"{small['n1_parted']} of them); both optimisers at {BLOPT_TIPS} "
          f"taxa x {BLOPT_SITES} sites, {BLOPT_SWEEPS} sweeps, on the card "
          f"against the CPU (logL, sweeps, (U1, N1) launches): " + "; ".join(
              f"{d} {dev} {v[0]!r} {v[1]} {v[2]}"
              for (d, dev), v in small["runs"].items())
          + f"; {small['checked']} U1 launches checked in all "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    bl = phase_blopt(device, card, fp32_peak)

    # ---------------------------------------------------- 30-31: search
    starts.append(("30-31", time.perf_counter()))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    inc_ops._replay_candidates.launches = 0  # the rows check's own path
    small = check_scorer_small(device)
    replay_launches = inc_ops._replay_candidates.launches
    print(f"[30 scorer small] C1's scoring instance equal to the plain "
          f"scorer at every launch ({small['launches']} launches, largest "
          f"|d logL| {small['hook_logl']:.3e}) and its replay instance's rows "
          f"and counters to its plain version's on the same tables "
          f"({replay_launches} launches, largest f32 rel "
          f"{small['f32_err']:.3e}): {small['cases']} cases "
          f"({len(PARTITION_SMALL)} of phase 20's configurations and "
          f"{len(SCORER_EXTRA)} more (five states, eight rates) x float64, "
          f"float32 x SPR radius {SCORER_RADIUS}, NNI; {small['candidates']} "
          f"candidates; float64 also with the pool capped at "
          f"{SCORER_POOL_CAPS} slots, so that rows spill); the logL on "
          f"the card equal to the plain scorer's on the card (largest |d| "
          f"{small['logl_err']:.3e}) and to the CPU scorer's; the base "
          f"buffers bit-identical after every scoring; {small['brute']} "
          f"candidates equal to a fresh Partition's evaluation of the moved "
          f"tree (float64 atol {SCORER_BRUTE_ATOL}, float32 the budget); the "
          f"NaN vote: U1, K2 and C1 give their plain versions' counters in "
          f"{small['nan']} configurations ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    sp = phase_spr(device, card, fp32_peak)

    # ---------------------------------------------------- 32-33: inference
    starts.append(("32-33", time.perf_counter()))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # one intra-op thread: the CPU halves issue many tiny tensor
    # operations, which more threads only slow down
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with ReplayHook() as u1_hook, ScorerHook() as c1_hook:
        rnd = check_rounds_small(device)
        inf = check_infer_small(device, cpu_refs)
    torch.set_num_threads(threads)
    cpu_refs.stop()
    secs = inf["s"]
    print(f"[32 search small] {len(ROUND_CASES)} rounds x float64, float32 "
          f"(two rounds each: {rnd['rounds']} results) on the card equal "
          f"to the CPU's (float64: the same results, moves, Newick and valid"
          f" rows; float32 within the budget, largest |d best logL| "
          f"{rnd['f32_d']:.3e}) and, in float64, to libpll_tpu's; moves "
          f"kept by the float64 first rounds {rnd['commits']}; {rnd['rows']}"
          f" valid rows on the card equal a fresh evaluation's (largest rel"
          f" {rnd['stale_err']:.3e}); {rnd['restored']} rounds without "
          f"improvement restored every valid row, scaler and flag bit for "
          f"bit; CapacityError at capacity 2, a contained regraft dropped; "
          f"infer_tree in {inf['cases']} cases ({len(INFER_SMALL)} x float64,"
          f" float32) on the card equal to the CPU's and, in float64, to "
          f"libpll_tpu's (start score, rounds, RF 0, logL rel {SEARCH_REL}); "
          f"float32 within the budget of a fresh float64 Partition (largest "
          f"|d| {inf['f32_d']:.3e}, RF to the CPU's float32 tree "
          f"{inf['f32_rf']}); moves='tbr' and mesh= raise their typed "
          f"errors (optimize_model=True runs in phase 34); U1 equal to "
          f"the plain executor at "
          f"{u1_hook.checked} launches, C1 to its plain version at "
          f"{c1_hook.checked}; card / CPU seconds a case: " + "; ".join(
              f"{name} {secs[name, str(d), 'card']:.2f}/"
              f"{secs[name, str(d), 'cpu']:.2f}"
              for name, *_ in INFER_SMALL
              for d in (torch.float64, torch.float32))
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    found, alignment, infer_launches, infer_more = phase_infer(device, card)
    infer_ref = dict(logl=found.logl, start=found.start_parsimony_score,
                     rounds=found.rounds, newick=infer_more["newick"],
                     s=found.timings)

    # ---------------------------------------------------- 34: model fitting
    starts.append(("34", time.perf_counter()))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    with ReplayHook() as u1_hook, ScorerHook() as c1_hook:
        mo = check_modelopt_small(device)
    torch.set_num_threads(threads)
    secs = mo["s"]
    print(f"[34 modelopt small] {mo['fits']} fits ("
          + ", ".join(name for name, *_ in MODELOPT_SMALL)
          + f") and infer_tree(optimize_model=True) at {MODELOPT_INFER[1]} "
          f"taxa x {MODELOPT_INFER[2]} sites (logL {mo['infer'][0]!r}, "
          f"alpha {mo['infer'][1]!r}) on the card in float64 equal to the "
          f"CPU's and to libpll_tpu's (trajectory and logL rel {SEARCH_REL},"
          f" parameters {MODELOPT_PARAM_ABS} absolute, alpha and p-inv rel "
          f"{MODELOPT_ALPHA_REL}); each Partition carries its fit; U1 equal "
          f"to the plain executor at {u1_hook.checked} launches, C1 to its "
          f"plain version at {c1_hook.checked}; card / CPU seconds: "
          + "; ".join(f"{name} {secs[name, 'card']:.2f}/"
                      f"{secs[name, 'cpu']:.2f}"
                      for name in [n for n, *_ in MODELOPT_SMALL]
                      + ["infer"])
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    phase_modelopt(device, card, found, alignment)
    del found, alignment

    # ---------------------------------------------------- 35: site sharding
    starts.append(("35", time.perf_counter()))
    mesh = phase_mesh(device, card, dict(
        flagship=got_score, flagship_shape=(FLAGSHIP_TIPS, FLAGSHIP_SITES),
        giant=giant["logl"], infer=infer_ref, data=infer_more.pop("data")))

    def bound_keys(b):
        # no single PyTorch call computes any of these functions (a whole
        # tree sweep, a dependent multiply-add chain, or a Fitch step on
        # popcounts, which PyTorch lacks): no library time
        return {"bound_ms": b[0], "bound_by": b[1], "library_ms": None}

    fused_src = "libpll_tpu_torch/csrc/clv_fused.cu"
    dyn_src = "libpll_tpu_torch/csrc/clv_dyn.cu"
    seg_src = "libpll_tpu_torch/csrc/clv_seg.cu"
    roof_src = "libpll_tpu_torch/csrc/roofline.cu"
    deriv_src = "libpll_tpu_torch/csrc/derivatives.cu"
    fitch_src = "libpll_tpu_torch/csrc/fitch.cu"
    partials_src = "libpll_tpu_torch/csrc/partials.cu"
    starts.append(("", time.perf_counter()))
    print("[wall] seconds a group of phases: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (a, t0), (_, t1) in zip(starts, starts[1:]))
        + f"; in all {starts[-1][1] - starts[0][1]:.1f}", flush=True)
    print(json.dumps({"kernels": [
        {"name": "fused_edge_score", "route": "cuda", "source": fused_src,
         "replaces": "libpll_tpu/ops/clv_pallas.py:462",
         "launches": launches["fused_edge_score"], "max_abs_err": k1_err,
         "ms": ms["k1"], "plain_ms": ms["k1_plain"],
         **bound_keys(k1_bound)},
        {"name": "fused_sweep", "route": "cuda", "source": fused_src,
         "replaces": "libpll_tpu/ops/clv_pallas.py:673",
         "launches": launches["fused_sweep"], "max_abs_err": k2_err,
         "ms": ms["k2"], "plain_ms": ms["k2_plain"],
         **bound_keys(k2_bound)},
        {"name": "dyn_sweep", "route": "cuda", "source": dyn_src,
         "replaces": "libpll_tpu/ops/clv_pallas_dyn.py:383",
         "launches": mid["k5_launches"], "max_abs_err": mid["k5_err"],
         "ms": mid["ms"]["k5"], "plain_ms": mid["ms"]["k5_plain"],
         **bound_keys(mid["k5_bound"])},
        {"name": "dyn_score", "route": "cuda", "source": dyn_src,
         "replaces": "libpll_tpu/ops/clv_pallas_dyn.py:695",
         "launches": giant["launches"], "max_abs_err": giant["k6_err"],
         "ms": giant["k6_ms"], "plain_ms": giant["k6_plain_ms"],
         **bound_keys(giant["k6_bound"])},
        {"name": "segmented_sweep", "route": "cuda", "source": seg_src,
         "replaces": "libpll_tpu/ops/clv_pallas_seg.py:327",
         "launches": readme["k3_launches"], "max_abs_err": readme["k3_err"],
         "ms": readme["ms"]["k3"], "plain_ms": readme["ms"]["k3_plain"],
         **bound_keys(readme["k3_bound"])},
        {"name": "segmented_score", "route": "cuda", "source": seg_src,
         "replaces": "libpll_tpu/ops/clv_pallas_seg.py:425",
         "launches": readme["k4_launches"], "max_abs_err": readme["k4_err"],
         "ms": readme["ms"]["k4"], "plain_ms": readme["ms"]["k4_plain"],
         **bound_keys(readme["k4_bound"])},
        {"name": "fma_chain", "route": "cuda", "source": roof_src,
         "replaces": "scripts/bench_vpu_roofline.py:84",
         "launches": roof["launches"]["k7"], "max_abs_err": roof["k7_err"],
         "ms": roof["ms"]["k7"], "plain_ms": roof["ms"]["k7_plain"],
         **bound_keys(roof["k7_bound"])},
        {"name": "roll_contract", "route": "cuda", "source": roof_src,
         "replaces": "scripts/bench_vpu_roofline.py:110",
         "launches": roof["launches"]["k8"], "max_abs_err": roof["k8_err"],
         "ms": roof["ms"]["k8"], "plain_ms": roof["ms"]["k8_plain"],
         **bound_keys(roof["k8_bound"])},
        # a lax.while_loop in JAX, not a Pallas kernel
        {"name": "newton_solve", "route": "cuda", "source": deriv_src,
         "replaces": "libpll_tpu/engine/evaluate.py:657",
         "launches": train["launches"], "max_abs_err": train["n1_err"],
         "ms": train["ms"]["n1"], "plain_ms": train["ms"]["n1_plain"],
         **bound_keys(train["n1_bound"])},
        {"name": "fused_edge_score_protein", "route": "cuda",
         "source": fused_src, "replaces": "libpll_tpu/ops/clv_pallas.py:462",
         "launches": protein["launches"]["make_score"][0],
         "max_abs_err": protein["k1_err"], "ms": protein["ms"]["k1"],
         "plain_ms": protein["ms"]["k1_plain"],
         **bound_keys(protein["k1_bound"])},
        {"name": "fused_sweep_protein", "route": "cuda", "source": fused_src,
         "replaces": "libpll_tpu/ops/clv_pallas.py:673",
         "launches": protein["launches"]["make_forward_fused"][1],
         "max_abs_err": protein["k2_err"], "ms": protein["ms"]["k2"],
         "plain_ms": protein["ms"]["k2_plain"],
         **bound_keys(protein["k2_bound"])},
        # port-only: JAX's Fitch is plain XLA (population_count), no Pallas
        *({"name": name, "route": "cuda", "source": fitch_src,
           "replaces": f"libpll_tpu/ops/fitch.py:{line}",
           "launches": pars["launches"][key.upper()],
           "max_abs_err": pars["err"][key], "ms": pars["ms"][key],
           "plain_ms": pars["ms"][f"{key}_plain"],
           **bound_keys(pars["bounds"][key])}
          for name, key, line in (("fitch_waves", "p1", 126),
                                  ("fitch_scores", "p2", 172),
                                  ("stepwise_commit", "p3", 273))),
        # N1 at infer_tree's shape, as a sweep solves an edge (phase 33);
        # JAX's blopt Newton is a lax.while_loop
        {"name": "newton_solve_rows", "route": "cuda", "source": deriv_src,
         "replaces": "libpll_tpu/engine/blopt.py:41",
         "launches": infer_launches["N1"],
         "max_abs_err": infer_more["n1"]["err"],
         "ms": infer_more["n1"]["ms"],
         "plain_ms": infer_more["n1"]["plain_ms"],
         **bound_keys(infer_more["n1"]["bound"])},
        # N1's derivative mode: a body of that loop (likelihood_derivatives)
        # a launch under a mesh (phase 35, rank 0's infer_tree)
        {"name": "newton_derivatives", "route": "cuda", "source": deriv_src,
         "replaces": "libpll_tpu/ops/derivatives.py:71",
         "launches": mesh["launches"], "max_abs_err": mesh["n1d"]["err"],
         "ms": mesh["n1d"]["ms"], "plain_ms": mesh["n1d"]["plain_ms"],
         **bound_keys(mesh["n1d"]["bound"])},
        # port-only: JAX's op-table executor is an XLA lax.scan
        {"name": "replay_ops", "route": "cuda", "source": partials_src,
         "replaces": "libpll_tpu/ops/clv.py:58",
         "launches": bl["launches"], "max_abs_err": bl["u1_err"],
         "ms": bl["ms"]["u1"], "plain_ms": bl["ms"]["u1_plain"],
         **bound_keys(bl["u1_bound"])},
        # the same kernel at infer_tree's sweep tables (phase 29's timing,
        # phase 33's launches); JAX's blopt op_body (engine/blopt.py:230)
        {"name": "replay_ops_sweep", "route": "cuda",
         "source": partials_src, "replaces": "libpll_tpu/engine/blopt.py:230",
         "launches": infer_launches["U1"], "max_abs_err": bl["sweep"]["err"],
         "ms": bl["sweep"]["us"] / 1e3,
         "plain_ms": bl["sweep"]["plain_us"] / 1e3,
         **bound_keys((bl["sweep"]["bound_us"] / 1e3,
                       bl["sweep"]["bound_by"]))},
        # port-only: JAX's candidate scorer is an XLA lax.map; the scoring
        # instance is its body (replay and edge logL), the replay instance
        # the rows check's (phase 30: one a scoring launch under the hook)
        {"name": "score_candidates", "route": "cuda", "source": partials_src,
         "replaces": "libpll_tpu/ops/incremental.py:96",
         "launches": sp["launches"], "max_abs_err": sp["batch"]["err"],
         "ms": sp["batch"]["ms"]["c1"],
         "plain_ms": sp["batch"]["ms"]["c1_plain"],
         **bound_keys(sp["batch"]["bound"])},
        {"name": "replay_candidates", "route": "cuda", "source": partials_src,
         "replaces": "libpll_tpu/ops/incremental.py:96",
         "launches": replay_launches,
         "max_abs_err": sp["batch"]["replay_err"],
         "ms": sp["batch"]["ms"]["c1r"],
         "plain_ms": sp["batch"]["ms"]["c1r_plain"],
         **bound_keys(sp["batch"]["replay_bound"])}]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
