"""Site sharding (``libpll_tpu_torch/parallel/mesh.py``) with two gloo
ranks on the CPU, against libpll_tpu's sharded functions on a 2-device
slice of conftest's virtual mesh and against the port's one-rank run.

One module fixture spawns the two ranks once.  Each rank imports this file
(without jax), joins a ``file://`` rendezvous in the test's temporary
directory, runs every case of ``CASES`` on the inputs the test process
made with numpy and pickled, and pickles its results; the tests then
compare them.  The one-rank run is the same case function on a mesh of
one rank (no process group).  Everything runs in float64, on the plain
versions of the kernels, with one torch thread a process.

Tolerances.  ``make_score_sharded`` (plain, +I, asc) and
``make_score_unbounded_sharded``: logL rel 1e-12 (two float64 partials
added in another order than one device's fold), and a one-rank mesh gives
``make_score``'s bits.  The word-sharded stepwise build: the same tree and
score, integers.  Blopt, ``spr_round``, model fitting and ``infer_tree``:
rel 1e-9 in logL and lengths (float64 sums in another order, carried
through every Newton iteration), the same commits, RF 0.  The two ranks:
identical results.
"""

import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libpll_tpu_torch.errors import EinvalError, KernelError

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
REL_SCORE = 1e-12
REL = 1e-9
RANK_TIMEOUT = 600  # seconds: the two ranks' whole run, and a collective
PARAMS = [1.2, 2.1, 0.7, 1.4, 3.3, 1.0]  # tests/test_parallel.py's build
FREQS = [0.3, 0.25, 0.2, 0.25]


# ---------------------------------------------------------------------------
# the cases, run by each rank on its mesh and by the test process on a
# mesh of one rank; they import the port only
# ---------------------------------------------------------------------------
def _topo(inp):
    from libpll_tpu_torch.engine import evaluate as tev
    from libpll_tpu_torch.tree import utree as tut

    return tev.topology_from_tree(tut.parse_newick_string(inp["newick"]),
                                  inp["sites"],
                                  asc_mode=inp.get("asc_mode", 0))[0]


def port_score(inp, mesh):
    """make_score_sharded on this rank's tips slab."""
    from libpll_tpu_torch.engine import evaluate as tev
    from libpll_tpu_torch.engine.params import model_from_numpy

    lo, hi = mesh.local(inp["sites"])
    score = tev.make_score_sharded(_topo(inp), 4, 4, mesh,
                                   use_pinv=inp["pinv"], device="cpu")
    tips = torch.from_numpy(np.ascontiguousarray(inp["tips"][..., lo:hi]))
    before = mesh.reductions
    logl = float(score(model_from_numpy(inp["model"], "cpu", torch.float64),
                       tips))
    return dict(logl=logl, reductions=mesh.reductions - before)


def port_unbounded(inp, mesh):
    from libpll_tpu_torch.engine import evaluate as tev
    from libpll_tpu_torch.engine.params import model_from_numpy

    score = tev.make_score_unbounded_sharded(_topo(inp), 4, 4, inp["masks"],
                                             mesh, device="cpu")
    before = mesh.reductions
    logl = float(score(model_from_numpy(inp["model"], "cpu",
                                        torch.float64)))
    return dict(logl=logl, reductions=mesh.reductions - before)


def port_stepwise(inp, mesh):
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import fastparsimony_stepwise
    from libpll_tpu_torch.tree import utree as tut

    part = FastParsimony.from_sequences(inp["seqs"], maps.pll_map_nt, 4,
                                        device="cpu")
    cut = part.vectors[:part.tips, :, inp.get("words", 1 << 30):]
    if "words" in inp:  # drop trailing all-ones pad words (they cost 0)
        part.vectors = part.vectors[..., :inp["words"]].contiguous()
    tree, score = fastparsimony_stepwise([part], inp["labels"], inp["seed"],
                                         mesh=mesh)
    return dict(newick=tut.export_newick(tree.root), score=score,
                words=int(part.vectors.shape[-1]),
                cut_pad=bool((cut == -1).all()))


def port_partition(inp, mesh):
    """tests/test_parallel.py's ``build`` in the port, sharded."""
    from libpll_tpu_torch.engine.partition import Partition
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.models.gamma import compute_gamma_cats
    from libpll_tpu_torch.parallel.mesh import shard_partition
    from libpll_tpu_torch.tree import utree as tut

    tips, sites = inp["tips"], inp["sites"]
    tree = tut.parse_newick_string(inp["newick"])
    part = Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, 4, tips - 2,
                     asc_bias_alloc=bool(inp.get("asc")), device="cpu")
    for n in tut.query_tipnodes(tree):
        part.set_tip_states(n.clv_index, maps.pll_map_nt,
                            inp["seqs"][n.label])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, PARAMS)
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    if "weights" in inp:
        part.set_pattern_weights(inp["weights"])
    if inp.get("asc"):
        part.set_asc_bias_type(inp["asc"])
        part.set_asc_state_weights([3, 1, 2, 4])
    shard_partition(part, mesh)
    return tree, part


def _traverse(tree):
    import libpll_tpu_torch.tree.utree as tut

    return tut.traverse(tree.root, tut.TRAVERSE_PREORDER)


def port_blopt(inp, mesh):
    from libpll_tpu_torch.engine import blopt
    from libpll_tpu_torch.tree import utree as tut

    out = {}
    for name, fn in (("scan", blopt.optimize_branch_lengths_scan),
                     ("host", blopt.optimize_branch_lengths)):
        tree, part = port_partition(inp, mesh)
        logl, sweeps = fn(tree, part, [0] * 4, max_sweeps=2)
        out[name] = dict(logl=logl, sweeps=sweeps,
                         lengths=[n.length for n in _traverse(tree)],
                         newick=tut.export_newick(tree.root))
    return out


def port_partition_asc(inp, mesh):
    """Edge logL and derivatives of a sharded Partition under each asc
    mode: the pseudo columns' terms counted once."""
    out = {}
    for asc in (1, 2, 3):
        tree, part = port_partition(dict(inp, asc=asc), mesh)
        from libpll_tpu_torch.engine import blopt

        root = tree.root
        logl = blopt._full_evaluation(tree, part, [0] * 4)
        st = part.update_sumtable(root.clv_index, root.back.clv_index,
                                  root.scaler_index,
                                  root.back.scaler_index, [0] * 4)
        d1, d2 = part.compute_likelihood_derivatives(
            root.scaler_index, root.back.scaler_index, root.length,
            [0] * 4, st)
        out[asc] = dict(logl=logl, d1=d1, d2=d2,
                        weights=part.pattern_weight_sum)
    return out


def port_spr(inp, mesh):
    from libpll_tpu_torch.search import spr
    from libpll_tpu_torch.tree import utree as tut

    tree, part = port_partition(inp, mesh)
    res = spr.spr_round(tree, part, [0] * 4, radius=3, batch=16)
    return dict(n_candidates=res.n_candidates, logl0=res.logl0,
                best_logl=res.best_logl, best=res.best,
                newick=tut.export_newick(tree.root))


def port_modelopt(inp, mesh):
    from libpll_tpu_torch.engine import modelopt

    tree, part = port_partition(inp, mesh)
    res = modelopt.optimize_model(part, tree, rounds=1, lbfgs_steps=20)
    return dict(logl=res.logl, frequencies=res.frequencies,
                subst_params=res.subst_params, alpha=res.alpha,
                trajectory=res.trajectory)


def port_infer(inp, mesh):
    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.tree import utree as tut

    res = infer_tree(inp["seqs"], mesh=mesh, device="cpu", **inp["kw"])
    return dict(logl=res.logl, start=res.start_parsimony_score,
                rounds=res.rounds, trajectory=res.trajectory,
                newick=tut.export_newick(res.tree.root),
                sites=res.partition.sites,
                global_sites=res.partition.global_sites)


CASES = {
    "score_plain": port_score, "score_pinv": port_score,
    "score_asc": port_score, "unbounded": port_unbounded,
    "stepwise_even": port_stepwise, "stepwise_odd": port_stepwise,
    "blopt": port_blopt, "partition_asc": port_partition_asc,
    "spr": port_spr, "modelopt": port_modelopt,
    "infer": port_infer, "infer_pad": port_infer, "infer_model": port_infer,
}


def rank_main(init_method, rank, inputs_path, out_dir):
    """One rank: join the group, run each case it has inputs for, pickle
    the results."""
    import torch.distributed as dist

    from libpll_tpu_torch.parallel import mesh as pm

    torch.set_num_threads(1)
    rank = int(rank)
    pm.initialize_distributed(init_method, WORLD, rank, backend="gloo",
                              device="cpu", timeout=RANK_TIMEOUT)
    mesh = pm.make_sites_mesh(device="cpu")
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    results = {name: CASES[name](inp, mesh) for name, inp in inputs.items()}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# inputs, made with numpy in the test process
# ---------------------------------------------------------------------------
def _random_newick(tips, rng, lo=0.05, hi=0.5):
    items = [f"t{i}:{rng.uniform(lo, hi):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(lo, hi):.4f}")
    return f"({items[0]},{items[1]},{items[2]});"


def _partition_inputs(tips, sites, seed):
    """tests/test_parallel.py's ``build(tips, sites, seed)`` data."""
    rng = np.random.default_rng(seed)
    newick = _random_newick(tips, rng)
    alpha = np.array(list("ACGT"))
    seqs = rng.integers(0, 4, (tips, sites))
    return dict(tips=tips, sites=sites, newick=newick,
                seqs={f"t{i}": "".join(alpha[seqs[i]]) for i in range(tips)})


def _score_inputs(kind, tips=8):
    from test_torch_ops import make_case

    rng = np.random.default_rng({"plain": 3, "pinv": 5, "asc": 7}[kind])
    newick = _random_newick(tips, rng)
    case = make_case(newick, 256, seed=11, pinv=(
        0.2 if kind == "pinv" else 0.0))
    model = dict(case["model"])
    tips = case["jtopo"].schedule.tips
    if kind == "pinv":
        model["invariant"] = np.where(np.arange(256) % 5 == 0,
                                      case["states"][0], -1).astype(np.int32)
    if kind == "asc":
        model["asc_weights"] = np.asarray([3.0, 1.0, 2.0, 4.0])
    return dict(newick=newick, sites=256, model=model,
                tips=case["clv"][:tips], pinv=kind == "pinv",
                asc_mode=1 if kind == "asc" else 0)


def _stepwise_inputs(sites, seed, **kw):
    """16 random taxa; ``words``: the packed vectors cut to that many
    words, the rest being all-ones pad (an odd count needs pad words on
    two ranks)."""
    rng = np.random.default_rng(seed)
    tips = 16
    return dict(seqs=["".join(rng.choice(list("ACGT"), sites))
                      for _ in range(tips)],
                labels=[f"t{i}" for i in range(tips)], seed=42, **kw)


def _infer_inputs(seed, sites, **kw):
    from test_spr_search import ALPHA, CATS, FREQS as SFREQS, PARAMS as SP

    rng = np.random.default_rng(seed)
    newick = _random_newick(10, rng, 0.05, 0.4)
    seqs = _evolve(newick, sites, rng, SP, SFREQS)
    return dict(seqs=seqs, kw=dict(dict(rate_cats=CATS, alpha=ALPHA,
                                        frequencies=SFREQS, subst_params=SP,
                                        seed=3, radius=5, max_rounds=3),
                                   **kw))


def _evolve(newick, sites, rng, params, freqs):
    """Sequences evolved along ``newick`` under GTR (signal for search)."""
    from libpll_tpu_torch.models.gtr import eigen_decompose
    from libpll_tpu_torch.tree import utree as tut

    w, left, right = eigen_decompose(np.asarray(params), np.asarray(freqs))
    out = {}

    def walk(node, state):
        if node.is_tip:
            out[node.label] = "".join("ACGT"[s] for s in state)
            return
        for m in list(node.ring())[1:]:
            p = (left * np.expm1(w * max(m.back.length, 1e-6))) @ right
            p = np.clip(p + np.eye(4), 0, None)
            walk(m.back, np.array([rng.choice(4, p=p[s] / p[s].sum())
                                   for s in state]))

    root = tut.parse_newick_string(newick).root
    base = rng.choice(4, sites, p=freqs)
    for m in root.ring():
        p = (left * np.expm1(w * max(m.back.length, 1e-6))) @ right
        p = np.clip(p + np.eye(4), 0, None)
        walk(m.back, np.array([rng.choice(4, p=p[s] / p[s].sum())
                               for s in base]))
    return out


@functools.lru_cache(maxsize=None)
def inputs():
    masks_case = _score_inputs("plain")
    st = masks_case["tips"][:, 0]  # one-hot [tips, S, L]
    masks = (st > 0).astype(np.uint32)
    masks = (masks << np.arange(4, dtype=np.uint32)[None, :, None]).sum(1)
    return {
        "score_plain": _score_inputs("plain"),
        "score_pinv": _score_inputs("pinv"),
        "score_asc": _score_inputs("asc"),
        "unbounded": dict(masks_case, masks=masks.astype(np.uint32)),
        "stepwise_even": _stepwise_inputs(600, 5),
        "stepwise_odd": _stepwise_inputs(200, 6, words=7),
        "blopt": _partition_inputs(16, 256, 0),
        "partition_asc": _partition_inputs(9, 64, 4),
        "spr": _partition_inputs(16, 256, 0),
        "modelopt": _partition_inputs(10, 64, 2),
        "infer": _infer_inputs(41, 40),
        "infer_pad": _infer_inputs(12, 41, compress=False, radius=4,
                                   local_blopt=0),
        "infer_model": _infer_inputs(9, 40, optimize_model=True,
                                     model_rounds=1, max_rounds=2),
        "sum": {},
    }


def port_sum(inp, mesh):
    """``mesh.sum`` itself: float64 values and int32 bits near the
    wrap."""
    r = mesh.rank
    f = mesh.sum(torch.tensor([0.1 * (r + 1), -2.5], dtype=torch.float32))
    i = mesh.sum(torch.tensor([2**31 - 1, -7, 5 + r], dtype=torch.int32))
    return dict(float=f.tolist(), dtype=str(f.dtype), int=i.tolist(),
                idtype=str(i.dtype), reductions=mesh.reductions)


CASES["sum"] = port_sum


def _run_ranks(tmp, meanwhile=lambda: None):
    """Spawn the ranks on the cases of ``CASES`` and, while they run, call
    ``meanwhile``; returns (each rank's results, what ``meanwhile``
    returned).  A rank that fails or outlasts RANK_TIMEOUT fails the
    run; both are killed on the way out."""
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump({name: inputs()[name] for name in CASES}, f)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import test_torch_mesh as t; t.rank_main(*sys.argv[2:])")
    # both ranks on this host: gloo over the loopback device
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(ROOT / "tests"),
         f"file://{tmp}/rendezvous", str(r), str(path), str(tmp)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    outs = []
    try:
        other = meanwhile()
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    results = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results, other


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results, spawned once for the module, and, computed
    while they run, JAX's sharded results, the port's one-rank run and
    examples_torch/multichip_inference.py's output (its own two ranks)."""
    example = subprocess.Popen(
        [sys.executable, str(ROOT / "examples_torch" /
                             "multichip_inference.py"), "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(os.environ, OMP_NUM_THREADS="1",
                            GLOO_SOCKET_IFNAME="lo"))
    try:
        def references():
            jax_results = {name: JAX[name](inputs()[name]) for name in JAX}
            return jax_results, {name: one_rank(name) for name in CASES}

        ranks, (jax_results, one) = _run_ranks(
            tmp_path_factory.mktemp("mesh"), references)
        out = example.communicate(timeout=RANK_TIMEOUT)[0]
    finally:
        if example.poll() is None:
            example.kill()
            example.wait()
    return dict(ranks=ranks, jax=jax_results, one=one,
                example=(example.returncode, out))


@functools.lru_cache(maxsize=None)
def one_rank(name):
    """The case on a mesh of one rank (no process group)."""
    from libpll_tpu_torch.parallel.mesh import make_sites_mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return CASES[name](inputs()[name], make_sites_mesh(device="cpu"))
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# libpll_tpu's sharded functions on a 2-device slice of the virtual mesh
# ---------------------------------------------------------------------------
def jax_mesh(axis="sites"):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()[:WORLD]), (axis,))


def jax_partition(inp, shard=True):
    import libpll_tpu as pll
    from libpll_tpu.io import maps as jmaps
    from libpll_tpu.models.gamma import compute_gamma_cats
    from libpll_tpu.parallel import mesh as jpmesh
    from libpll_tpu.tree import utree as jut

    tips, sites = inp["tips"], inp["sites"]
    tree = jut.parse_newick_string(inp["newick"])
    part = pll.Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, 4,
                         tips - 2, asc_bias_alloc=bool(inp.get("asc")))
    for n in jut.query_tipnodes(tree):
        part.set_tip_states(n.clv_index, jmaps.pll_map_nt,
                            inp["seqs"][n.label])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, PARAMS)
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    if inp.get("asc"):
        part.set_asc_bias_type(inp["asc"])
        part.set_asc_state_weights([3, 1, 2, 4])
    if shard:
        jpmesh.shard_partition(part, jax_mesh())
    return tree, part


def jax_score(inp):
    import jax.numpy as jnp

    from libpll_tpu.engine import evaluate as jev
    from libpll_tpu.ops import clv_pallas as cp
    from libpll_tpu.tree import utree as jut

    topo = jev.topology_from_tree(jut.parse_newick_string(inp["newick"]),
                                  inp["sites"],
                                  asc_mode=inp.get("asc_mode", 0))[0]
    model = {k: jnp.asarray(v) for k, v in inp["model"].items()}
    if "masks" in inp:
        return float(jev.make_score_unbounded_sharded(
            topo, 4, 4, inp["masks"], jax_mesh(), interpret=True)(model))
    tips = cp.pack_tips(jnp.asarray(inp["tips"]), "vpu")
    return float(jev.make_score_sharded(
        topo, 4, 4, jax_mesh(), impl="vpu", use_pinv=inp["pinv"],
        interpret=True)(model, tips))


def jax_stepwise(inp):
    from libpll_tpu.io import maps as jmaps
    from libpll_tpu.search.parsimony import FastParsimony
    from libpll_tpu.search.stepwise import fastparsimony_stepwise
    from libpll_tpu.tree import utree as jut

    part = FastParsimony.from_sequences(inp["seqs"], jmaps.pll_map_nt, 4)
    if "words" in inp:
        part.vectors = part.vectors[..., :inp["words"]]
    tree, score = fastparsimony_stepwise([part], inp["labels"], inp["seed"],
                                         mesh=jax_mesh("words"))
    return dict(newick=jut.export_newick(tree.root), score=score)


def jax_blopt(inp):
    from libpll_tpu.engine import blopt
    from libpll_tpu.tree import utree as jut

    out = {}
    for name, fn in (("scan", blopt.optimize_branch_lengths_scan),
                     ("host", blopt.optimize_branch_lengths)):
        tree, part = jax_partition(inp)
        logl, sweeps = fn(tree, part, [0] * 4, max_sweeps=2)
        out[name] = dict(logl=logl, sweeps=sweeps, lengths=[
            n.length for n in jut.traverse(tree.root,
                                           jut.TRAVERSE_PREORDER)])
    return out


def jax_partition_asc(inp):
    from libpll_tpu.tree import utree as jut

    out = {}
    for asc in (1, 2, 3):
        tree, part = jax_partition(dict(inp, asc=asc), shard=False)
        root = tree.root
        ops, blens, midx = jut.create_operations(jut.traverse(root))
        part.update_prob_matrices([0] * 4, midx, blens)
        part.update_partials(ops)
        logl = part.compute_edge_loglikelihood(
            root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, [0] * 4)
        st = part.update_sumtable(root.clv_index, root.back.clv_index,
                                  root.scaler_index,
                                  root.back.scaler_index, [0] * 4)
        d1, d2 = part.compute_likelihood_derivatives(
            root.scaler_index, root.back.scaler_index, root.length,
            [0] * 4, st)
        out[asc] = dict(logl=float(logl), d1=float(d1), d2=float(d2),
                        weights=part.pattern_weight_sum)
    return out


def jax_spr(inp):
    from libpll_tpu.search import spr
    from libpll_tpu.tree import utree as jut

    tree, part = jax_partition(inp)
    res = spr.spr_round(tree, part, [0] * 4, radius=3, batch=16)
    return dict(n_candidates=res.n_candidates, logl0=res.logl0,
                best_logl=res.best_logl, best=res.best,
                newick=jut.export_newick(tree.root))


def jax_infer(inp):
    from libpll_tpu.search.infer import infer_tree
    from libpll_tpu.tree import utree as jut

    res = infer_tree(inp["seqs"], mesh=jax_mesh(), **inp["kw"])
    return dict(logl=res.logl, start=res.start_parsimony_score,
                rounds=res.rounds, trajectory=res.trajectory,
                newick=jut.export_newick(res.tree.root))


@functools.lru_cache(maxsize=None)
def jax_plain_score():
    return jax_score(inputs()["score_plain"])


def jax_unbounded(inp):
    """JAX's make_score_sharded on the same alignment (``score_plain``'s,
    its K1 in interpret mode): JAX's dyn kernel in interpret mode takes
    ~25 s here, and JAX's two tiers give one alignment one logL
    (tests/test_sharded_score.py)."""
    return jax_plain_score()


JAX = {"score_plain": lambda inp: jax_plain_score(), "score_pinv": jax_score,
       "score_asc": jax_score, "unbounded": jax_unbounded,
       "stepwise_even": jax_stepwise, "stepwise_odd": jax_stepwise,
       "blopt": jax_blopt, "partition_asc": jax_partition_asc,
       "spr": jax_spr, "infer": jax_infer,
       "infer_pad": jax_infer, "infer_model": jax_infer}


# ---------------------------------------------------------------------------
# the comparisons
# ---------------------------------------------------------------------------
def _rf0(newick_a, newick_b):
    from libpll_tpu_torch.tree import utree as tut
    from libpll_tpu_torch.tree.compare import rf_distance

    return rf_distance(tut.parse_newick_string(newick_a),
                       tut.parse_newick_string(newick_b)) == 0


def assert_case(name, got, want, rel=REL):
    """``got`` (a rank's) against ``want`` (JAX's or the one-rank port's)
    by the case's kind."""
    close = functools.partial(np.testing.assert_allclose, rtol=rel, atol=0)
    if name.startswith("score") or name == "unbounded":
        close(got["logl"], want if np.isscalar(want) else want["logl"],
              rtol=REL_SCORE)
    elif name.startswith("stepwise"):
        assert (got["newick"], got["score"]) == (want["newick"],
                                                 want["score"])
    elif name == "blopt":
        for path in ("scan", "host"):
            g, w = got[path], want[path]
            assert g["sweeps"] == w["sweeps"]
            close(g["logl"], w["logl"])
            close(g["lengths"], w["lengths"])
    elif name == "partition_asc":
        for asc in (1, 2, 3):
            g, w = got[asc], want[asc]
            assert g["weights"] == w["weights"]
            for k in ("logl", "d1", "d2"):
                close(g[k], w[k], rtol=REL_SCORE)
    elif name == "spr":
        assert (got["n_candidates"], got["best"], got["newick"]) == (
            want["n_candidates"], want["best"], want["newick"])
        close([got["logl0"], got["best_logl"]],
              [want["logl0"], want["best_logl"]])
    elif name == "modelopt":
        close(got["logl"], want["logl"])
        close(got["trajectory"], want["trajectory"])
        for k in ("frequencies", "subst_params"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)
        close(got["alpha"], want["alpha"], rtol=1e-6)
    elif name.startswith("infer"):
        assert (got["start"], got["rounds"]) == (want["start"],
                                                 want["rounds"])
        close(got["trajectory"], want["trajectory"])
        close(got["logl"], want["logl"])
        assert _rf0(got["newick"], want["newick"])
    else:
        raise AssertionError(f"no comparison for {name}")


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_return_identical_results(runs, name):
    """Every decision reads reduced values, so both ranks end with the
    same results, bit for bit."""
    r0, r1 = runs["ranks"]
    assert repr(r0[name]) == repr(r1[name])


@pytest.mark.parametrize("name", [n for n in CASES if n != "sum"])
def test_two_ranks_match_the_one_rank_port(runs, name):
    """Among them ``modelopt``: optimize_model's fit on a sharded
    Partition (its value and gradient reduced once) equals the one-rank
    fit, which tests/test_torch_modelopt.py holds to JAX's."""
    assert_case(name, runs["ranks"][0][name], runs["one"][name])


@pytest.mark.parametrize("name", list(JAX))
def test_two_ranks_match_jax_sharded(runs, name):
    """libpll_tpu's sharded run on two virtual devices: make_score_sharded,
    build_device_sharded, shard_partition under blopt and spr_round,
    infer_tree(mesh=) with and without optimize_model; the asc case
    against its unsharded Partition."""
    assert_case(name, runs["ranks"][0][name], runs["jax"][name])


def test_one_reduction_a_score_and_padding(runs):
    """A sharded score reduces once a call (the asc tail after it); the
    word-sharded build pads an odd word count; infer_tree pads 41 sites
    to 42, 21 a rank."""
    r0 = runs["ranks"][0]
    for name in ("score_plain", "score_pinv", "score_asc", "unbounded"):
        assert r0[name]["reductions"] == 1, name
    assert r0["stepwise_odd"]["words"] % WORLD == 1
    assert r0["stepwise_odd"]["cut_pad"]  # the cut dropped pad words only
    assert r0["stepwise_even"]["words"] % WORLD == 0
    assert r0["infer_pad"]["global_sites"] == 42
    assert r0["infer_pad"]["sites"] == 21
    assert runs["one"]["infer_pad"]["sites"] == 41


def test_mesh_sum(runs):
    """float32 values are summed in float64 and returned in float32; int32
    values (Fitch's uint32 bits) wrap modulo 2**32."""
    got = runs["ranks"][0]["sum"]
    assert got["dtype"] == "torch.float32" and got["idtype"] == "torch.int32"
    want = torch.tensor([0.1, 0.2], dtype=torch.float32).to(torch.float64)
    assert got["float"] == [float(torch.tensor(float(want.sum()),
                                               dtype=torch.float32)), -5.0]
    assert got["int"] == [-2, -14, 11]


def test_asc_counted_once(runs):
    """Each asc mode's pseudo columns, which both ranks hold, count once in
    the sharded Partition's logL and derivatives (JAX's unsharded values,
    rel 1e-12), and the pattern weight sum is the alignment's."""
    assert_case("partition_asc", runs["ranks"][0]["partition_asc"],
                runs["jax"]["partition_asc"])
    assert runs["ranks"][0]["partition_asc"][1]["weights"] == 64


@pytest.mark.parametrize("name", ["score_plain", "score_pinv", "score_asc",
                                  "unbounded"])
def test_one_rank_mesh_is_the_unsharded_scorer_bit_for_bit(name):
    from libpll_tpu_torch.engine import evaluate as tev
    from libpll_tpu_torch.engine.params import model_from_numpy

    inp = inputs()[name]
    model = model_from_numpy(inp["model"], "cpu", torch.float64)
    if name == "unbounded":
        want = float(tev.make_score_unbounded(_topo(inp), 4, 4, inp["masks"],
                                              device="cpu")(model))
    else:
        want = float(tev.make_score(_topo(inp), 4, 4, use_pinv=inp["pinv"],
                                    device="cpu")(
            model, torch.from_numpy(inp["tips"])))
    assert one_rank(name)["logl"] == want


def test_no_graph_under_a_mesh():
    """A CUDA graph cannot hold a collective: a graphed sweep or score
    under a mesh raises a typed error (before any CUDA work)."""
    from libpll_tpu_torch.engine import blopt
    from libpll_tpu_torch.engine import evaluate as tev
    from libpll_tpu_torch.parallel.mesh import make_sites_mesh

    mesh = make_sites_mesh(device="cpu")
    tree, part = port_partition(inputs()["spr"], mesh)
    with pytest.raises(EinvalError, match="graph"):
        blopt.optimize_branch_lengths_scan(tree, part, [0] * 4,
                                           graphed=True)
    program = blopt.make_sweep_program(part.nodes, part.scale_buffers, 8,
                                       sites=part.sites,
                                       scale_mode=part.scale_mode, mesh=mesh)
    with pytest.raises(EinvalError, match="graph"):
        program.graphed(part.clv, part.scalers, part.pmatrix, {}, None,
                        None, None)
    with pytest.raises(EinvalError, match="another mesh"):
        blopt.optimize_branch_lengths_scan(
            tree, part, [0] * 4, program=blopt.make_sweep_program(
                part.nodes, part.scale_buffers, 8, sites=part.sites,
                scale_mode=part.scale_mode))
    score = tev.make_score_sharded(_topo(inputs()["score_plain"]), 4, 4,
                                   mesh, device="cpu")
    with pytest.raises(EinvalError, match="graph"):
        score.graphed({}, None)


def test_typed_errors():
    """Padding and slices, and the refusals: sites that do not divide the
    ranks, a second shard, no card without ``device="cpu"``, a mesh that
    is not a SitesMesh, asc-bias where a sharded path does not port it."""
    from libpll_tpu_torch.engine import modelopt
    from libpll_tpu_torch.io import maps
    from libpll_tpu_torch.parallel import mesh as pm
    from libpll_tpu_torch.search import spr
    from libpll_tpu_torch.search.infer import infer_tree
    from libpll_tpu_torch.search.parsimony import FastParsimony
    from libpll_tpu_torch.search.stepwise import fastparsimony_stepwise

    two = pm.SitesMesh(None, 1, 2, torch.device("cpu"), "gloo")
    assert pm.pad_sites(41, two) == 42 and two.local(41) == (21, 42)
    inp = dict(inputs()["spr"], sites=255,
               seqs={k: v[:255] for k, v in inputs()["spr"]["seqs"].items()})
    with pytest.raises(EinvalError, match="divide"):
        port_partition(inp, two)
    one = pm.make_sites_mesh(device="cpu")
    tree, part = port_partition(inputs()["spr"], one)
    with pytest.raises(EinvalError, match="sharded already"):
        pm.shard_partition(part, one)
    if not torch.cuda.is_available():
        with pytest.raises(KernelError):
            pm.make_sites_mesh()
    seqs = inputs()["infer"]["seqs"]
    with pytest.raises(EinvalError, match="SitesMesh"):
        infer_tree(seqs, mesh=object(), device="cpu")
    pars = FastParsimony.from_sequences(list(seqs.values()),
                                        maps.pll_map_nt, 4, device="cpu")
    with pytest.raises(EinvalError, match="SitesMesh"):
        fastparsimony_stepwise([pars], list(seqs), 1, mesh=object())
    tree, part = port_partition(dict(inputs()["partition_asc"], asc=1), one)
    with pytest.raises(EinvalError, match="asc"):
        spr.make_round_scorer(part, 32)
    with pytest.raises(EinvalError, match="asc"):
        modelopt.make_param_score(part, tree)


def test_mesh_names_are_jax_packages():
    """The port's parallel.mesh and evaluate carry the JAX names that
    mean something without XLA's sharding objects."""
    import libpll_tpu.engine.evaluate as jev
    import libpll_tpu.parallel.mesh as jpm

    from libpll_tpu_torch.engine import evaluate as tev
    from libpll_tpu_torch.parallel import mesh as tpm

    for n in ("initialize_distributed", "make_sites_mesh", "pad_sites",
              "shard_partition", "SITES_AXIS"):
        assert hasattr(jpm, n) and hasattr(tpm, n), n
    assert tpm.SITES_AXIS == jpm.SITES_AXIS
    for n in ("make_score_sharded", "make_score_unbounded_sharded"):
        assert hasattr(jev, n) and hasattr(tev, n), n


def test_multichip_example_runs(runs):
    """examples_torch/multichip_inference.py: two gloo ranks on the CPU
    (run beside the module's ranks), exit 0, the fields of
    examples/multichip_inference.py, printed once (by rank 0)."""
    code, out = runs["example"]
    assert code == 0, out
    for field in ("mesh: 2 x cpu", "parsimony start score:", "final logL",
                  "clv sharding:", "tree:"):
        assert out.count(field) == 1, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_mesh_newton_is_the_loop_bit_for_bit(dtype):
    """``newton_solve_mesh`` on a one-rank mesh gives the plain loop's t*,
    d1, d2 and body count bit for bit: its early end at a fixed point or a
    2-cycle of t ends where the full loop ends.  Random sumtables, both
    step rules; the shortcut must have saved reductions somewhere."""
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.parallel.mesh import make_sites_mesh

    mesh = make_sites_mesh(device="cpu")
    rng = np.random.default_rng(21)
    saved = 0
    for _ in range(40):
        c, s, n = 4, 4, int(rng.integers(20, 300))
        st = torch.from_numpy(rng.uniform(0.01, 1.0, (c, s, n))).to(dtype)
        st[:, 0] += 2.0
        evals = np.concatenate([np.zeros((c, 1)),
                                -rng.uniform(0.1, 3.0, (c, s - 1))], 1)
        args = (st, torch.tensor([rng.uniform(1e-3, 2.0)], dtype=dtype),
                torch.from_numpy(rng.uniform(0.2, 2.0, c)).to(dtype),
                torch.zeros(c, dtype=dtype),
                torch.from_numpy(evals).to(dtype),
                torch.full((c, s), 0.25, dtype=dtype),
                torch.full((c,), 0.25, dtype=dtype),
                torch.full((n,), -1, dtype=torch.int32),
                torch.from_numpy(rng.integers(1, 4, n).astype(float)).to(
                    dtype))
        for abs_d2 in (False, True):
            want = dv.newton_solve_plain(*args, sites=n, abs_d2=abs_d2)
            before = mesh.reductions
            got = dv.newton_solve_mesh(mesh, *args, sites=n, abs_d2=abs_d2)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (got, want)
            saved += int(want.iterations) - (mesh.reductions - before)
    assert saved > 0


def test_derivative_bodies_are_kept_across_solves():
    """A caller's ``bodies`` cache holds one N1 derivative body a sumtable
    shape: solves of two edges of one shape share it (and give the
    results of solves with fresh bodies), another shape gets its own, and
    a body refuses a sumtable of another shape."""
    from libpll_tpu_torch.errors import EinvalError
    from libpll_tpu_torch.ops import derivatives as dv
    from libpll_tpu_torch.parallel.mesh import make_sites_mesh

    mesh = make_sites_mesh(device="cpu")
    rng = np.random.default_rng(5)
    dtype, c, s = torch.float32, 4, 4

    def edge(n):
        st = torch.from_numpy(rng.uniform(0.01, 1.0, (c, s, n))).to(dtype)
        st[:, 0] += 2.0
        evals = np.concatenate([np.zeros((c, 1)),
                                -rng.uniform(0.1, 3.0, (c, s - 1))], 1)
        return (st, torch.tensor([0.2], dtype=dtype),
                torch.from_numpy(rng.uniform(0.2, 2.0, c)).to(dtype),
                torch.zeros(c, dtype=dtype),
                torch.from_numpy(evals).to(dtype),
                torch.full((c, s), 0.25, dtype=dtype),
                torch.full((c,), 0.25, dtype=dtype),
                torch.full((n,), -1, dtype=torch.int32),
                torch.ones(n, dtype=dtype))

    bodies = {}
    for n in (64, 64, 96):
        args = edge(n)
        kept = dv.newton_solve_mesh(mesh, *args, sites=n, abs_d2=True,
                                    bodies=bodies)
        fresh = dv.newton_solve_mesh(mesh, *args, sites=n, abs_d2=True)
        for g, w in zip(kept, fresh):
            assert torch.equal(g, w)
    assert sorted(k[0][2] for k in bodies) == [64, 96]
    body = next(b for k, b in bodies.items() if k[0][2] == 64)
    with pytest.raises(EinvalError, match="sumtable"):
        body.bind(*(edge(96)[:1] + edge(96)[2:]))
