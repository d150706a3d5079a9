"""End-to-end maximum-likelihood tree inference.

Counterpart: ``libpll_tpu/search/infer.py`` (``InferResult`` ``:42``,
``infer_tree`` ``:53``), the workflow libpll users assemble by hand from
the library's pieces (reference: stepwise.c starting trees +
utree_moves.c SPR loops + the newton example's branch-length
optimization), packaged as one driver:

  1. site-pattern compression (``io/compress.py``), then a randomized
     stepwise-addition parsimony starting tree (seed-exact RNG; the device
     engine of ``search/stepwise.py``, kernels P2 and P3);
  2. full-tree Newton branch-length sweeps (``engine/blopt.py``'s scan
     driver: U1 and N1 an edge), then alternating rounds of
       a. likelihood SPR (or NNI) rounds — batched incremental candidate
          scoring (kernel C1) and the verified commits (U1), and
       b. Newton sweeps over the committed moves' neighbourhoods, with a
          full sweep as the convergence check,
     until neither improves the log-likelihood.

With ``optimize_model=True`` the model (GTR rates, frequencies and Γ
shape, ``engine/modelopt.py``) is fitted on the start tree after the
initial sweeps and again on the final tree, each fit followed by a full
branch-length pass.

Everything runs on the card unless ``device="cpu"`` is given (the plain
versions of the kernels).  ``mesh=`` (a ``parallel.mesh.SitesMesh``; every
rank calls ``infer_tree`` with the same arguments) runs the whole
inference sites-sharded: the stepwise build shards its Fitch word axis
(one integer reduction an insertion), the Partition keeps the rank's
sites (weight-0 pad columns even out the division), and every sum over
sites in the sweeps, rounds and fits meets the other ranks' in the mesh's
reduction, so every rank ends with the same tree and logL.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..engine import blopt, modelopt
from ..engine.partition import Partition
from ..errors import CapacityError, EinvalError
from ..io import maps
from ..models.gamma import compute_gamma_cats
from ..tree import utree as ut
from .parsimony import FastParsimony
from .spr import local_edge_set, make_round_scorer, nni_round, spr_round
from .stepwise import deep_recursion, fastparsimony_stepwise


@dataclass
class InferResult:
    tree: ut.UTree
    partition: Partition
    logl: float
    start_parsimony_score: int
    rounds: int
    trajectory: List[float] = field(default_factory=list)
    timings: Dict[str, float] = field(default_factory=dict)
    model: Optional[modelopt.ModelOptResult] = None  # the last fit's


def infer_tree(sequences: Dict[str, str], *, states: int = 4,
               rate_cats: int = 4, alpha: float = 1.0,
               frequencies: Optional[Sequence[float]] = None,
               subst_params: Optional[Sequence[float]] = None,
               charmap: Optional[np.ndarray] = None, seed: int = 42,
               radius: int = 5, max_rounds: int = 20,
               blopt_sweeps: int = 2, spr_batch: int = 32,
               min_delta: float = 1e-6, compress: bool = True,
               moves: str = "spr", mesh=None, local_blopt: int = 3,
               spr_commit: int = 8, optimize_model: bool = False,
               model_rounds: int = 2, opt_pinv: bool = False,
               dtype=torch.float64, device=None) -> InferResult:
    """Infer an ML tree for ``sequences`` (label -> aligned sequence).

    Model: GTR(+Γ) with fixed ``frequencies``/``subst_params`` (defaults:
    uniform) and Γ shape ``alpha``.  ``dtype`` selects the numeric path
    (float64 by default; float32 for throughput on the card).
    ``compress`` dedups site patterns into weighted columns
    (`pll_compress_site_patterns`) before any device work; the inferred
    logL equals the uncompressed one.  ``moves`` selects the topology
    search: ``"spr"`` (radius-bounded SPR rounds, default) or ``"nni"``
    (nearest-neighbor interchanges).  ``local_blopt`` (edge radius, 0 to
    disable) optimizes only the branches within that radius of a
    committed move instead of a full 2n−3-edge Newton sweep every round;
    full sweeps still run at the start and as the convergence check.
    ``spr_commit`` applies up to that many non-overlapping improving moves
    per scored round (each after the first verified exactly, rolled back
    on regression).  ``device``: the card when None (the kernels), or
    ``"cpu"`` (their plain versions).

    ``optimize_model`` fits the model (``engine.modelopt.optimize_model``,
    ``model_rounds`` coordinate rounds, Γ shape when ``rate_cats > 1``,
    p-inv with ``opt_pinv``) after the initial sweeps and after the
    search, each fit followed by a full branch-length pass; the result's
    ``model`` is the last fit's ``ModelOptResult``.  ``mesh``: a
    ``parallel.mesh.SitesMesh`` whose ranks share the sites; every rank
    makes this call with the same arguments (and ``device`` its own, the
    mesh's when None) and gets the same result.
    """
    from ..io.compress import compress_site_patterns

    if mesh is not None:
        from ..parallel.mesh import SitesMesh

        if not isinstance(mesh, SitesMesh):
            raise EinvalError(f"mesh={mesh!r}: a parallel.mesh.SitesMesh")
        device = mesh.device if device is None else device
    if moves not in ("spr", "nni"):
        raise ValueError(f"moves must be 'spr' or 'nni', got {moves!r}")
    labels = list(sequences)
    seqs = [sequences[lab] for lab in labels]
    tips = len(labels)
    cmap = charmap if charmap is not None else (
        maps.pll_map_nt if states == 4 else maps.pll_map_aa)

    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    weights = None
    if compress:
        seqs, weights = compress_site_patterns(seqs, cmap)
    sites = len(seqs[0])
    if mesh is not None:
        # zero-weight pad columns make the sites divide the mesh evenly
        # (the reference's zero-weight SIMD padding)
        pad = (-sites) % mesh.size
        if pad:
            if weights is None:
                weights = np.ones(sites, np.int64)
            padchar = chr(int(np.argmax(cmap > 0))) * pad
            seqs = [s + padchar for s in seqs]
            weights = np.concatenate([np.asarray(weights),
                                      np.zeros(pad, np.int64)])
            sites += pad
    timings["compress"] = time.perf_counter() - t0

    # the tree layer's walks recurse once a level: room for a deep tree
    with deep_recursion(tips):
        # 1. parsimony starting tree
        t0 = time.perf_counter()
        pars = FastParsimony.from_sequences(seqs, cmap, states=states,
                                            pattern_weights=weights,
                                            device=device)
        tree, pscore = fastparsimony_stepwise([pars], labels, seed,
                                              mesh=mesh)
        timings["stepwise"] = time.perf_counter() - t0
        del pars
        for n in tree.nodes:  # stepwise emits zero-length branches
            for m in ([n] if n.is_tip else n.ring()):
                if m.length == 0.0:
                    m.length = 0.1
                m.back.length = m.length

        # 2. likelihood engine
        t0 = time.perf_counter()
        part = Partition(tips, tips - 2, states, sites, 1, 2 * tips - 3,
                         rate_cats, tips - 2, dtype=dtype, device=device)
        order = {n.label: n.clv_index for n in ut.query_tipnodes(tree)}
        for lab, s in zip(labels, seqs):
            part.set_tip_states(order[lab], cmap, s)
        if weights is not None:
            part.set_pattern_weights(weights)
        n_params = states * (states - 1) // 2
        part.set_frequencies(0, frequencies if frequencies is not None
                             else [1.0 / states] * states)
        part.set_subst_params(0, subst_params if subst_params is not None
                              else [1.0] * n_params)
        part.set_category_rates(compute_gamma_cats(alpha, rate_cats))
        if mesh is not None:
            from ..parallel.mesh import shard_partition

            shard_partition(part, mesh)
        pidx = [0] * rate_cats

        # 3. alternate branch-length sweeps and SPR rounds: one blopt
        # program and one SPR scorer serve every round (envelopes bumped
        # only if a dirty subset outgrows them)
        bl_cap = 32
        bl_program = blopt.make_sweep_program(
            part.nodes, part.scale_buffers, bl_cap, sites=part.sites,
            scale_mode=part.scale_mode, mesh=part.mesh)
        timings["setup"] = time.perf_counter() - t0

        # the local sweeps' edge envelope, sized for spr_commit moves'
        # merged radius-local_blopt neighbourhoods
        local_edge_pad = min(256, 1 << (2 * tips - 4).bit_length())

        def run_blopt(edges=None, sweeps=blopt_sweeps):
            # capacity overflow (a re-orientation subset outgrew the
            # envelope) is the only retryable condition, bounded by the
            # power-of-two ladder up to the full schedule size
            nonlocal bl_cap, bl_program
            max_cap = 1 << (2 * tips - 3).bit_length()
            edge_pad = None
            if edges is not None:
                if len(edges) > local_edge_pad:
                    edges = None  # unusually wide move: pay the full sweep
                else:
                    edge_pad = local_edge_pad
            while True:
                try:
                    return blopt.optimize_branch_lengths_scan(
                        tree, part, pidx, max_sweeps=sweeps,
                        capacity=bl_cap, program=bl_program,
                        edges=edges, edge_pad=edge_pad)
                except CapacityError:
                    if bl_cap >= max_cap:
                        raise
                    bl_cap *= 2
                    bl_program = blopt.make_sweep_program(
                        part.nodes, part.scale_buffers, bl_cap,
                        sites=part.sites, scale_mode=part.scale_mode,
                        mesh=part.mesh)

        t0 = time.perf_counter()
        # the stepwise start's crude branch lengths need the initial full
        # optimization run to (near) convergence: with local sweeps inside
        # the rounds, under-optimization here is not recovered until the
        # final convergence sweep and degrades SPR candidate ranking
        logl, _ = run_blopt(
            sweeps=max(blopt_sweeps, 6) if local_blopt else blopt_sweeps)
        timings["blopt"] = time.perf_counter() - t0
        timings["spr"] = 0.0
        trajectory = [logl]

        mres = None

        def run_modelopt():
            # fit the model on the current tree, then re-optimize branch
            # lengths under the new model (they were tuned under the old
            # one)
            nonlocal mres, logl
            t0 = time.perf_counter()
            mres = modelopt.optimize_model(
                part, tree, opt_alpha=rate_cats > 1, opt_pinv=opt_pinv,
                alpha=mres.alpha if mres is not None else alpha,
                rounds=model_rounds, dtype=dtype)
            timings["modelopt"] = (timings.get("modelopt", 0.0)
                                   + time.perf_counter() - t0)
            t0 = time.perf_counter()
            new_logl, _ = run_blopt()
            timings["blopt"] += time.perf_counter() - t0
            logl = max(logl, mres.logl, new_logl)
            trajectory.append(logl)

        if optimize_model:
            run_modelopt()
        scorer = None
        # a radius-r candidate's dirty path is bounded by the prune ->
        # regraft path plus the eval-edge re-orientation: 2·radius + O(1)
        # ops, the constant pre-sized generously so that the default
        # radius never pays a scorer rebuild
        cap = 1 << (2 * radius + 16 - 1).bit_length()
        rounds = 0
        improved = False
        for rounds in range(1, max_rounds + 1):
            t0 = time.perf_counter()
            if scorer is None:
                scorer = make_round_scorer(part, cap)

            def one_round():
                if moves == "nni":
                    return nni_round(tree, part, pidx, capacity=cap,
                                     batch=spr_batch, scorer=scorer,
                                     min_delta=min_delta)
                return spr_round(tree, part, pidx, radius=radius,
                                 capacity=cap, batch=spr_batch,
                                 scorer=scorer, min_delta=min_delta,
                                 commit=spr_commit)

            try:
                res = one_round()
            except CapacityError:
                # a candidate's dirty subset outgrew the pre-sized
                # envelope: rebuild the scorer once with a doubled
                # envelope; any other error propagates untouched
                cap *= 2
                scorer = make_round_scorer(part, cap)
                res = one_round()
            improved = res.improved
            logl = res.best_logl
            timings["spr"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            if improved and local_blopt and res.best_nodes is not None:
                # optimize only the changed neighbourhood; the full sweep
                # runs as the convergence check once SPR stops improving
                new_logl, _ = run_blopt(
                    edges=local_edge_set(res.best_nodes, local_blopt))
                logl = max(logl, new_logl)
            else:
                new_logl, _ = run_blopt()
                improved |= new_logl > logl + min_delta
                logl = max(logl, new_logl)
            timings["blopt"] += time.perf_counter() - t0
            trajectory.append(logl)
            if not improved:
                break

        if local_blopt and improved:
            # max_rounds exit on a local sweep: leave fully optimized
            t0 = time.perf_counter()
            new_logl, _ = run_blopt()
            timings["blopt"] += time.perf_counter() - t0
            logl = max(logl, new_logl)
            trajectory.append(logl)

        if optimize_model:
            # refit on the final topology (branch re-sweep included)
            run_modelopt()

    return InferResult(tree, part, float(logl), int(pscore), rounds,
                       trajectory, timings, model=mres)
