"""The port's inference driver (``search/infer.py``: ``infer_tree``) and
scripts/bench_infer.py's alignment (``utils/flagship.infer_alignment``)
against libpll_tpu on the CPU.

Each case runs ``infer_tree`` on the same sequences in both packages (the
port with ``device="cpu"``: the plain versions of P2/P3, U1, C1 and N1),
with ``tests/test_infer.py``'s and ``tests/test_search_quality.py``'s
data and arguments (``max_rounds`` at most 4 here): SPR and NNI moves, local branch-length passes of
radius 3 and none, compressed and uncompressed columns, protein (20
states, two rates) and the 7-taxon exhaustive case's alignment; and
``optimize_model=True`` on ``tests/test_modelopt.py``'s inference data.

Tolerances.  The starting parsimony score and the number of rounds are
integers and are held equal; the final topologies are at RF distance 0.
The trajectory and the final logL rel 1e-9: float64 sums in another order
than JAX's, carried through every Newton sweep and round.  JAX's results
are computed once per case and shared by the tests.
"""

import ast
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from libpll_tpu.models.gamma import compute_gamma_cats as jgamma
from libpll_tpu.search.infer import infer_tree as jinfer
from libpll_tpu.tree import utree as jut

from libpll_tpu_torch.engine.modelopt import ModelOptResult
from libpll_tpu_torch.errors import (CapacityError, EinvalError,
                                     KernelError, PllError)
from libpll_tpu_torch.search import infer as infer_mod
from libpll_tpu_torch.search.infer import infer_tree
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.tree.compare import rf_distance
from libpll_tpu_torch.utils.flagship import infer_alignment

from test_modelopt import TRUE_FREQS, TRUE_PARAMS
from test_modelopt import _random_tree as modelopt_tree
from test_modelopt import _simulate as simulate_sites
from test_spr_search import (ALPHA, CATS, FREQS, PARAMS, TIPS, _random_tree,
                             _simulate)

REL = 1e-9
ROOT = Path(__file__).resolve().parents[1]
GTR = dict(rate_cats=CATS, alpha=ALPHA, frequencies=FREQS,
           subst_params=PARAMS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs (restored after it):
    the port's plain versions issue many tiny tensor operations, which
    more threads only slow down, most of all beside other test
    processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def dna(seed):
    rng = np.random.default_rng(seed)
    return _simulate(_random_tree(TIPS, rng), rng)


def protein():
    """``test_infer_protein``'s 6 x 40 random amino acids."""
    rng = np.random.default_rng(2)
    aas = "ARNDCQEGHILKMFPSTWYV"
    return {f"p{i}": "".join(rng.choice(list(aas), 40)) for i in range(6)}


def exhaustive():
    """``test_infer_tree_reaches_exhaustive_optimum``'s 7 x 300 alignment
    (Γ site rates on a tree with clear structure)."""
    rng = np.random.default_rng(77)
    truth = ("((t0:0.12,t1:0.18):0.22,((t2:0.15,t3:0.2):0.18,"
             "(t4:0.1,t5:0.25):0.2):0.15,t6:0.3);")
    rates = jgamma(0.8, 4)
    return simulate_sites(truth, 300, rng,
                          site_rates=rates[rng.integers(0, 4, 300)])


CASES = {  # name: (sequences, infer_tree's arguments)
    "spr_local3": (lambda: dna(41),
                   dict(GTR, seed=42, radius=8, max_rounds=4)),
    "spr_local0": (lambda: dna(12),
                   dict(GTR, seed=5, radius=6, max_rounds=4, local_blopt=0)),
    "nni": (lambda: dna(9), dict(GTR, seed=7, moves="nni", max_rounds=4)),
    "nni_local0": (lambda: dna(13), dict(GTR, seed=5, moves="nni",
                                         max_rounds=4, local_blopt=0)),
    "uncompressed": (lambda: dna(8), dict(GTR, seed=7, radius=5,
                                          max_rounds=3, compress=False)),
    "protein": (protein, dict(states=20, rate_cats=2, alpha=1.0, seed=3,
                              radius=4, max_rounds=2)),
    "exhaustive7": (exhaustive, dict(rate_cats=4, alpha=0.8,
                                     frequencies=TRUE_FREQS,
                                     subst_params=TRUE_PARAMS, seed=3,
                                     radius=5, max_rounds=8)),
}


@functools.lru_cache(maxsize=None)
def sequences(case):
    return CASES[case][0]()


@functools.lru_cache(maxsize=None)
def jax_result(case):
    return jinfer(sequences(case), **CASES[case][1])


@pytest.mark.parametrize("case", list(CASES))
def test_infer_tree_matches_jax(case):
    """The same start score, rounds and topology (RF 0), the trajectory
    and logL rel 1e-9, the same timings keys; the Partition on the CPU."""
    want = jax_result(case)
    got = infer_tree(sequences(case), device="cpu", **CASES[case][1])
    assert got.start_parsimony_score == want.start_parsimony_score
    assert got.rounds == want.rounds
    np.testing.assert_allclose(got.trajectory, want.trajectory, rtol=REL)
    np.testing.assert_allclose(got.logl, want.logl, rtol=REL)
    assert got.trajectory == sorted(got.trajectory)
    jtree = tut.parse_newick_string(jut.export_newick(want.tree.root))
    assert rf_distance(got.tree, jtree) == 0
    assert set(got.timings) == set(want.timings)
    assert got.model is None and tut.check_integrity(got.tree)
    assert got.partition.device == torch.device("cpu")


def test_infer_tree_errors_are_typed():
    """A ``mesh=`` that is not a ``parallel.mesh.SitesMesh`` raises a
    PllError before any work (the sharded inference itself:
    tests/test_torch_mesh.py); an unknown move set raises ValueError as
    JAX's; without a card the default device raises KernelError (no
    fallback to the CPU)."""
    seqs = dna(12)
    with pytest.raises(EinvalError, match="SitesMesh") as err:
        infer_tree(seqs, mesh=object(), device="cpu")
    assert isinstance(err.value, PllError)
    with pytest.raises(ValueError):
        infer_tree(seqs, moves="tbr", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(KernelError):
            infer_tree(seqs, **GTR)


@functools.lru_cache(maxsize=None)
def model_fit_case():
    """``tests/test_modelopt.py:289``'s data (10 taxa, Γ(0.5) site rates)
    at 200 sites, its arguments with ``max_rounds`` 2, and JAX's result."""
    rng = np.random.default_rng(37)
    newick = modelopt_tree(10, rng)
    site_rates = jgamma(0.5, 4)[rng.integers(0, 4, 200)]
    seqs = simulate_sites(newick, 200, rng, site_rates=site_rates)
    kw = dict(rate_cats=4, seed=5, radius=4, max_rounds=2,
              optimize_model=True, model_rounds=1)
    return seqs, kw, jinfer(seqs, **kw)


def test_infer_tree_with_model_optimization_matches_jax():
    """``infer_tree(optimize_model=True)``: the model fitted after the
    initial sweeps and after the search, as JAX's: the same start score,
    rounds and topology (RF 0), the trajectory and logL rel 1e-9, the
    ``modelopt`` timing, the last fit's ``ModelOptResult`` (logL rel
    1e-9, parameters 1e-4 absolute, alpha rel 1e-3) and the Partition
    carrying it."""
    seqs, kw, want = model_fit_case()
    got = infer_tree(seqs, device="cpu", **kw)
    assert got.start_parsimony_score == want.start_parsimony_score
    assert got.rounds == want.rounds
    np.testing.assert_allclose(got.trajectory, want.trajectory, rtol=REL)
    np.testing.assert_allclose(got.logl, want.logl, rtol=REL)
    assert got.trajectory == sorted(got.trajectory)
    jtree = tut.parse_newick_string(jut.export_newick(want.tree.root))
    assert rf_distance(got.tree, jtree) == 0
    assert "modelopt" in got.timings
    assert set(got.timings) == set(want.timings)
    m, w = got.model, want.model
    assert isinstance(m, ModelOptResult)
    np.testing.assert_allclose(m.trajectory, w.trajectory, rtol=REL)
    np.testing.assert_allclose(m.logl, w.logl, rtol=REL)
    for name in ("subst_params", "frequencies", "rates"):
        np.testing.assert_allclose(getattr(m, name), getattr(w, name),
                                   rtol=0, atol=1e-4)
    np.testing.assert_allclose(m.alpha, w.alpha, rtol=1e-3)
    np.testing.assert_array_equal(got.partition.subst_params[0],
                                  m.subst_params)
    np.testing.assert_array_equal(got.partition.frequencies[0],
                                  m.frequencies)
    np.testing.assert_array_equal(got.partition.rates, m.rates)


def test_infer_does_not_mask_unrelated_errors(monkeypatch):
    """An unrelated failure inside a round propagates at once, with no
    capacity-style retry (``tests/test_infer.py:76``)."""
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise RuntimeError("injected unrelated failure")

    monkeypatch.setattr(infer_mod, "spr_round", boom)
    with pytest.raises(RuntimeError, match="injected"):
        infer_tree(dna(12), seed=5, radius=3, max_rounds=2, device="cpu",
                   **GTR)
    assert calls["n"] == 1


def test_infer_one_scorer_and_one_retry(monkeypatch):
    """The default radius's pre-sized envelope builds one scorer for the
    whole search; a round that overflows it doubles the envelope once and
    runs again."""
    builds, overflow = [], {"n": 0}
    real_make, real_round = infer_mod.make_round_scorer, infer_mod.spr_round

    def counting(part, cap):
        builds.append(cap)
        return real_make(part, cap)

    monkeypatch.setattr(infer_mod, "make_round_scorer", counting)
    res = infer_tree(dna(13), seed=5, radius=5, max_rounds=4, device="cpu",
                     **GTR)
    assert np.isfinite(res.logl) and builds == [32]

    def overflow_once(*a, **k):
        if not overflow["n"]:
            overflow["n"] += 1
            raise CapacityError("injected overflow")
        return real_round(*a, **k)

    builds.clear()
    monkeypatch.setattr(infer_mod, "spr_round", overflow_once)
    res = infer_tree(dna(13), seed=5, radius=5, max_rounds=2, device="cpu",
                     **GTR)
    assert np.isfinite(res.logl) and builds == [32, 64]


# ------------------------------------------------------------ the alignment
def bench_infer_functions():
    """scripts/bench_infer.py's ``simulate`` and ``expm_gtr``, taken from
    its source by ``ast`` (the script reads sys.argv and configures jax at
    import)."""
    tree = ast.parse((ROOT / "scripts" / "bench_infer.py").read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("simulate", "expm_gtr")]
    assert len(body) == 2
    ns = {"np": np}
    exec(compile(ast.Module(body=body, type_ignores=[]),
                 "scripts/bench_infer.py", "exec"), ns)
    return ns["simulate"]


@pytest.mark.parametrize("tips, sites, seed", [(40, 300, 11), (17, 64, 3),
                                               (130, 50, 11)])
def test_infer_alignment_is_bench_infers(tips, sites, seed):
    """The same sequences and generating Newick as the script's
    ``simulate`` (whose recursive Newick writer the port writes as a
    loop)."""
    want = bench_infer_functions()(tips, sites, seed)
    got = infer_alignment(tips, sites, seed)
    assert got == want
    assert len(got[0]) == tips
