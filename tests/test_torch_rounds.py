"""The port's SPR and NNI rounds (``search/spr.py``: ``local_edge_set``,
``spr_round``, ``nni_round``) against libpll_tpu's on the CPU.

Both sides start from ``tests/test_spr_search.py``'s simulation (12 taxa
x 40 sites, GTR+Γ4, float64), the data evolved on one random tree and the
search started from another, so that a round has several improving moves
to commit: the same Newick parsed by each package's utree, the same
setters on each package's Partition (the port's with ``device="cpu"``,
where U1 and C1 take their plain versions).

Tolerances.  ``logl0`` and ``best_logl`` rel 1e-10: the port sums in
another order than JAX, and a committed round adds a few incremental
updates to the full evaluation.  ``improved``, ``n_candidates``,
``n_ops_max``, ``best`` and the committed nodes are integers and are held
equal, as are the Newick after the round and the validity flags.  Every
CLV row marked valid: rel 1e-10 of its (rate, state) block's largest
entry to JAX's row and to a fresh evaluation of that direction, the
scalers equal.  A round that does not improve leaves every valid row,
scaler and flag bit for bit as it was.
"""

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

import libpll_tpu as jpll
from libpll_tpu.errors import CapacityError as JCapacityError
from libpll_tpu.search import spr as jspr
from libpll_tpu.tree import utree as jut

import libpll_tpu_torch as tpll
from libpll_tpu_torch.errors import CapacityError
from libpll_tpu_torch.search import spr
from libpll_tpu_torch.tree import utree as tut

from test_spr_search import TIPS, _random_tree, _simulate
from test_torch_spr import PIDX, _evaluate, _partition, flags
from libpll_tpu.tree import incremental as jinc
from libpll_tpu_torch.tree import incremental as tinc

REL = 1e-10


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


def start_pair(seed, **kw):
    """(jtree, jpart, ttree, tpart, seqs): data evolved on one random
    tree, both packages' Partitions on another, evaluated, flags set."""
    rng = np.random.default_rng(seed)
    seqs = _simulate(_random_tree(TIPS, rng), rng)
    newick = _random_tree(TIPS, rng)
    jtree, ttree = (jut.parse_newick_string(newick),
                    tut.parse_newick_string(newick))
    jpart = _partition(jpll, jtree, seqs, **kw)
    tpart = _partition(tpll, ttree, seqs, device="cpu", **kw)
    _evaluate(jut, jinc, jtree, jpart)
    _evaluate(tut, tinc, ttree, tpart)
    return jtree, jpart, ttree, tpart, seqs


def valid_dirs(tree):
    """The inner directions whose CLV row is marked valid."""
    return [m for n in tree.nodes if not n.is_tip for m in n.ring()
            if m.clv_valid]


def assert_rows_close(got, want, rel=REL):
    """float64 [..., S, L]: each entry within ``rel`` of its block's
    largest magnitude."""
    scale = np.abs(want).max(axis=-2, keepdims=True)
    err = np.abs(got - want) - rel * scale
    assert (err <= 0).all(), f"beyond rel {rel} of the block: {err.max()}"


def assert_valid_rows_match(jtree, jpart, ttree, tpart):
    """The same flags; every valid CLV row rel REL to JAX's, scalers
    equal."""
    assert flags(ttree) == flags(jtree)
    dirs = valid_dirs(ttree)
    assert dirs
    rows = sorted({m.clv_index for m in dirs})
    scal = sorted({m.scaler_index for m in dirs
                   if m.scaler_index >= 0 and tpart.scale_mode})
    assert_rows_close(tpart.clv.numpy()[rows], np.asarray(jpart.clv)[rows])
    if scal:
        np.testing.assert_array_equal(tpart.scalers.numpy()[scal],
                                      np.asarray(jpart.scalers)[scal])


def assert_no_stale_row(ttree, tpart, seqs, scaling):
    """Every valid row equals a fresh Partition's evaluation of its
    direction (the subtree behind it), scalers equal: no row left stale
    by a rolled-back commit is marked valid."""
    fresh = _partition(tpll, ttree, seqs, scaling=scaling, device="cpu")
    ops, blens, midx = tut.create_operations(tut.traverse(ttree.root))
    fresh.update_prob_matrices(PIDX, midx, blens)
    for m in valid_dirs(ttree):
        fresh.update_partials(tut.create_operations(tut.traverse(m))[0])
        assert_rows_close(tpart.clv[m.clv_index].numpy(),
                          fresh.clv[m.clv_index].numpy())
        if m.scaler_index >= 0 and tpart.scale_mode:
            assert torch.equal(tpart.scalers[m.scaler_index],
                               fresh.scalers[m.scaler_index])


def snapshot(ttree, tpart):
    return (flags(ttree), tut.export_newick(ttree.root),
            tpart.clv.clone(), tpart.scalers.clone())


def assert_restored(ttree, tpart, snap):
    """Flags and Newick as before; every valid row and its scalers bit
    for bit."""
    before_flags, before_newick, clv, scalers = snap
    assert flags(ttree) == before_flags
    assert tut.export_newick(ttree.root) == before_newick
    for m in valid_dirs(ttree):
        assert torch.equal(tpart.clv[m.clv_index], clv[m.clv_index])
        if m.scaler_index >= 0 and tpart.scale_mode:
            assert torch.equal(tpart.scalers[m.scaler_index],
                               scalers[m.scaler_index])
    tips = range(tpart.tips)
    assert torch.equal(tpart.clv[list(tips)], clv[list(tips)])


def assert_results_match(got, want):
    np.testing.assert_allclose(got.logl0, float(want.logl0), rtol=REL)
    np.testing.assert_allclose(got.best_logl, float(want.best_logl),
                               rtol=REL)
    assert (got.improved, got.n_candidates, got.n_ops_max, got.best) == (
        want.improved, want.n_candidates, want.n_ops_max, want.best)
    key = lambda nodes: None if nodes is None else tuple(  # noqa: E731
        n.node_index for n in nodes)
    assert key(got.best_nodes) == key(want.best_nodes)


class CommitCount:
    """Counts the verified commits of a port round (each
    ``_commit_dirty`` call but the closing one)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        real = spr._commit_dirty

        def counting(*a, **k):
            self.calls += 1
            return real(*a, **k)

        monkeypatch.setattr(spr, "_commit_dirty", counting)

    def rollbacks(self, res):
        commits = len(res.best_nodes) // 2 if res.best_nodes else 0
        return self.calls - 1 - commits if self.calls else 0


# ------------------------------------------------------------ local_edge_set
@pytest.mark.parametrize("seed", [0, 3, 9])
def test_local_edge_set_matches_jax(seed):
    """Equal sets to JAX's around tips, inner nodes and move pairs, radii
    0-4."""
    newick = _random_tree(TIPS + 4 * seed, np.random.default_rng(seed))
    jtree, ttree = (jut.parse_newick_string(newick),
                    tut.parse_newick_string(newick))
    for k in range(0, len(jtree.nodes), 3):
        picks = [(jtree.nodes[k],), (jtree.nodes[k], jtree.nodes[-1 - k])]
        tpicks = [(ttree.nodes[k],), (ttree.nodes[k], ttree.nodes[-1 - k])]
        for jn, tn in zip(picks, tpicks):
            for radius in range(5):
                assert (spr.local_edge_set(tn, radius)
                        == jspr.local_edge_set(jn, radius))


# ------------------------------------------------------------ spr_round
SPR_CASES = [  # (seed, commit, radius, batch, scaling)
    (21, 1, 5, 8, "site"),
    (22, 4, 6, 16, "rate"),
    (23, 8, 5, 16, "none"),
    (24, 4, 5, 8, "site"),
    (25, 8, 6, 8, "rate"),
    (26, 1, 6, 16, "none"),
]


@pytest.mark.parametrize("seed, commit, radius, batch, scaling", SPR_CASES)
def test_spr_round_matches_jax(seed, commit, radius, batch, scaling):
    """One round in each package: the same ``SprResult``, the same
    Newick and flags, every valid row rel 1e-10 to JAX's and to a fresh
    evaluation of its direction; a second round on the moved tree
    likewise."""
    jtree, jpart, ttree, tpart, seqs = start_pair(seed, scaling=scaling)
    for _ in range(2):
        kw = dict(radius=radius, batch=batch, commit=commit)
        want = jspr.spr_round(jtree, jpart, PIDX, **kw)
        got = spr.spr_round(ttree, tpart, PIDX, **kw)
        assert_results_match(got, want)
        assert got.improved
        if commit > 1:
            assert len(got.best_nodes) <= 2 * commit
        assert tut.export_newick(ttree.root) == jut.export_newick(jtree.root)
        assert_valid_rows_match(jtree, jpart, ttree, tpart)
        assert_no_stale_row(ttree, tpart, seqs, scaling)
        assert tut.check_integrity(ttree)


# seeds whose first radius-6 round keeps more than one move and rolls
# back at least one verified commit (found by a scan of seeds 30-400)
ROLLBACK_SEEDS = (173, 280)


@pytest.mark.parametrize("seed", ROLLBACK_SEEDS)
def test_spr_round_rollback_leaves_no_stale_row(seed, monkeypatch):
    """A round whose extra commits are rolled back (verified logL
    regressed): the rolled-back rows are not marked valid, every valid
    row is a fresh evaluation's, and the state equals JAX's."""
    jtree, jpart, ttree, tpart, seqs = start_pair(seed)
    count = CommitCount(monkeypatch)
    kw = dict(radius=6, batch=16, commit=8)
    want = jspr.spr_round(jtree, jpart, PIDX, **kw)
    got = spr.spr_round(ttree, tpart, PIDX, **kw)
    assert_results_match(got, want)
    assert count.rollbacks(got) > 0
    assert len(got.best_nodes) > 2  # more than the first move kept
    assert tut.export_newick(ttree.root) == jut.export_newick(jtree.root)
    assert_valid_rows_match(jtree, jpart, ttree, tpart)
    assert_no_stale_row(ttree, tpart, seqs, "site")


@pytest.mark.parametrize("kind", ["spr", "nni", "empty"])
def test_round_without_improvement_restores_state(kind):
    """A round whose best score does not beat the baseline (min_delta
    above any gain; for "empty", no candidate) leaves every valid row,
    its scalers, the flags and the tree bit for bit; the result equals
    JAX's."""
    jtree, jpart, ttree, tpart, _ = start_pair(27, scaling="rate")
    snap = snapshot(ttree, tpart)
    if kind == "nni":
        want = jspr.nni_round(jtree, jpart, PIDX, min_delta=1e6)
        got = spr.nni_round(ttree, tpart, PIDX, min_delta=1e6)
    else:
        kw = (dict(min_delta=1e6) if kind == "spr"
              else dict(candidates=[]))
        want = jspr.spr_round(jtree, jpart, PIDX, **kw)
        got = spr.spr_round(ttree, tpart, PIDX, **kw)
    assert not got.improved and got.best is None
    assert_results_match(got, want)
    assert_restored(ttree, tpart, snap)


def test_spr_round_capacity_and_contained_regraft():
    """capacity 2 raises CapacityError, as JAX's; a caller's candidate
    whose regraft edge lies inside the pruned subtree is dropped with the
    tree intact (``n_candidates`` 0), as JAX's."""
    jtree, jpart, ttree, tpart, _ = start_pair(28)
    with pytest.raises(JCapacityError):
        jspr.spr_round(jtree, jpart, PIDX, radius=6, capacity=2)
    with pytest.raises(CapacityError):
        spr.spr_round(ttree, tpart, PIDX, radius=6, capacity=2)
    for ut, tree, part, mod in ((jut, jtree, jpart, jspr),
                                (tut, ttree, tpart, spr)):
        p = next(n for n in ut.query_innernodes(tree)
                 if n.back.next is not None)
        before = ut.export_newick(tree.root)
        res = mod.spr_round(tree, part, PIDX, candidates=[(p, p.back.next
                                                           .back)])
        assert not res.improved and res.n_candidates == 0
        assert ut.export_newick(tree.root) == before
        assert ut.check_integrity(tree)


# ------------------------------------------------------------ nni_round
@pytest.mark.parametrize("seed, batch, scaling", [(31, 8, "site"),
                                                  (32, 16, "rate"),
                                                  (33, 8, "none")])
def test_nni_round_matches_jax(seed, batch, scaling):
    """Three NNI rounds in each package: the same ``SprResult`` (``best``
    the edge's node index and the interchange), Newick, flags and valid
    rows, no stale row."""
    jtree, jpart, ttree, tpart, seqs = start_pair(seed, scaling=scaling)
    improved = 0
    for _ in range(3):
        want = jspr.nni_round(jtree, jpart, PIDX, batch=batch)
        got = spr.nni_round(ttree, tpart, PIDX, batch=batch)
        assert_results_match(got, want)
        improved += got.improved
        assert tut.export_newick(ttree.root) == jut.export_newick(jtree.root)
        assert_valid_rows_match(jtree, jpart, ttree, tpart)
        assert_no_stale_row(ttree, tpart, seqs, scaling)
    assert improved
