"""The port's stepwise addition against libpll_tpu's, on the same random
alignments made from a seed with numpy: both of the port's engines
(``"host"``: P1 + P2 with the argmin on the host; ``"device"``: P2 + P3's
plain twins on the CPU) against JAX's ``engine="device"``, in score and in
``export_newick`` bit for bit, for each size and seed; two partitions;
the small-tree fallback; what is not ported raises."""

import functools

import numpy as np
import pytest

from libpll_tpu.io import maps as jmaps
from libpll_tpu.search import parsimony as jpars
from libpll_tpu.search import stepwise as jstep
from libpll_tpu.tree import utree as jut

from libpll_tpu_torch.errors import EinvalError, PllError
from libpll_tpu_torch.search import parsimony as tpars
from libpll_tpu_torch.search import stepwise as tstep
from libpll_tpu_torch.tree import utree as tut

SIZES = [(8, 60), (16, 120), (64, 500)]
SEEDS = [0, 1, 42, 12345]


def alignment(tips, sites, seed, alphabet="ACGT"):
    rng = np.random.default_rng(1000 * tips + seed)
    seqs = ["".join(rng.choice(list(alphabet), sites)) for _ in range(tips)]
    return seqs, [f"t{i}" for i in range(tips)]


@functools.lru_cache(maxsize=None)
def jax_build(tips, sites, seed):
    """(score, newick) of JAX's device engine."""
    seqs, labels = alignment(tips, sites, seed)
    part = jpars.FastParsimony.from_sequences(seqs, jmaps.pll_map_nt, 4)
    tree, score = jstep.fastparsimony_stepwise([part], labels, seed,
                                               engine="device")
    assert jut.check_integrity(tree)
    return score, jut.export_newick(tree.root)


@pytest.mark.parametrize("engine", ["host", "device"])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("tips, sites", SIZES)
def test_stepwise_matches_jax(tips, sites, seed, engine):
    seqs, labels = alignment(tips, sites, seed)
    part = tpars.FastParsimony.from_sequences(seqs, jmaps.pll_map_nt, 4,
                                              device="cpu")
    tree, score = tstep.fastparsimony_stepwise([part], labels, seed,
                                               engine=engine)
    assert tut.check_integrity(tree)
    assert tree.tip_count == tips
    assert (score, tut.export_newick(tree.root)) == jax_build(tips, sites,
                                                              seed)


@pytest.mark.parametrize("engine", ["host", "device"])
def test_stepwise_two_partitions(engine):
    """Candidate scores of a DNA and a protein partition summed before the
    argmin (reference stepwise.c:288-297), on the same taxa."""
    tips = 24
    seqs_d, labels = alignment(tips, 200, 5)
    seqs_p, _ = alignment(tips, 90, 6, "ARNDCQEGHILKMFPSTWYV")
    weights = np.random.default_rng(3).integers(1, 4, 90)
    jparts = [jpars.FastParsimony.from_sequences(seqs_d, jmaps.pll_map_nt,
                                                 4),
              jpars.FastParsimony.from_sequences(seqs_p, jmaps.pll_map_aa,
                                                 20, weights)]
    tparts = [tpars.FastParsimony.from_sequences(seqs_d, jmaps.pll_map_nt,
                                                 4, device="cpu"),
              tpars.FastParsimony.from_sequences(seqs_p, jmaps.pll_map_aa,
                                                 20, weights, device="cpu")]
    jt, js = jstep.fastparsimony_stepwise(jparts, labels, 5, engine="device")
    tt, ts = tstep.fastparsimony_stepwise(tparts, labels, 5, engine=engine)
    assert ts == js
    assert tut.export_newick(tt.root) == jut.export_newick(jt.root)


@pytest.mark.parametrize("tips", [3, 4, 5])
def test_stepwise_small_trees(tips):
    """n < 4 takes the host engine in both packages (JAX's fallback)."""
    seqs, labels = alignment(tips, 40, 9)
    jp = jpars.FastParsimony.from_sequences(seqs, jmaps.pll_map_nt, 4)
    jt, js = jstep.fastparsimony_stepwise([jp], labels, 9, engine="device")
    for engine in ("host", "device", "auto"):
        tp = tpars.FastParsimony.from_sequences(seqs, jmaps.pll_map_nt, 4,
                                                device="cpu")
        tt, ts = tstep.fastparsimony_stepwise([tp], labels, 9, engine=engine)
        assert ts == js
        assert tut.export_newick(tt.root) == jut.export_newick(jt.root)


def test_stepwise_refuses_what_is_not_ported():
    seqs, labels = alignment(8, 30, 2)
    part = tpars.FastParsimony.from_sequences(seqs, jmaps.pll_map_nt, 4,
                                              device="cpu")
    with pytest.raises(EinvalError, match="SitesMesh") as err:
        tstep.fastparsimony_stepwise([part], labels, 1, mesh=object())
    assert isinstance(err.value, PllError)
    with pytest.raises(ValueError):
        tstep.fastparsimony_stepwise([part], labels, 1, engine="gpu")
    other = tpars.FastParsimony.from_sequences(seqs[:7], jmaps.pll_map_nt,
                                               4, device="cpu")
    with pytest.raises(ValueError):
        tstep.StepwiseBuilder([part, other], labels)


def test_device_engine_call_sequence(monkeypatch):
    """The device build issues P2 per partition and P3 per insertion, plus
    the star and the final P3: counted through the wrappers on CPU
    tensors (their plain versions)."""
    calls = {"scores": 0, "commit": []}
    scores, commit = tstep.fitch.fitch_scores, tstep.fitch.stepwise_commit

    def count_scores(*a, **k):
        calls["scores"] += 1
        return scores(*a, **k)

    def count_commit(*a, **k):
        calls["commit"].append(k["mode"])
        return commit(*a, **k)

    monkeypatch.setattr(tstep.fitch, "fitch_scores", count_scores)
    monkeypatch.setattr(tstep.fitch, "stepwise_commit", count_commit)
    seqs, labels = alignment(16, 120, 42)
    part = tpars.FastParsimony.from_sequences(seqs, jmaps.pll_map_nt, 4,
                                              device="cpu")
    _, score = tstep.fastparsimony_stepwise([part, part], labels, 42)
    assert calls["scores"] == 2 * 13
    assert calls["commit"] == ["star"] + ["insert"] * 13 + ["final"]
    assert score == 2 * jax_build(16, 120, 42)[0]


@pytest.mark.parametrize("grid", [2, 9])
def test_stepwise_with_sliced_commit_matches_jax(monkeypatch, grid):
    """The device engine with P3 as its slice plan's plain walk (the
    words split across ``grid`` blocks, the slices' costs summed) gives
    JAX's score and Newick, one and two partitions."""
    real = tstep.fitch.stepwise_commit

    def sliced(parts, *topo, **kw):
        assert kw.pop("plan", None) is None and kw.pop("work", None) is None
        return tstep.fitch.stepwise_commit_sliced_plain(parts, *topo,
                                                        grid=grid, **kw)

    monkeypatch.setattr(tstep.fitch, "stepwise_commit", sliced)
    seqs, labels = alignment(16, 120, 42)
    part = tpars.FastParsimony.from_sequences(seqs, jmaps.pll_map_nt, 4,
                                              device="cpu")
    tree, score = tstep.fastparsimony_stepwise([part], labels, 42)
    assert (score, tut.export_newick(tree.root)) == jax_build(16, 120, 42)
    tree, score = tstep.fastparsimony_stepwise([part, part], labels, 42)
    assert score == 2 * jax_build(16, 120, 42)[0]
    assert real is not tstep.fitch.stepwise_commit
