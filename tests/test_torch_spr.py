"""The port's batched SPR/NNI candidate scorer (``ops/incremental.py``,
``search/spr.py``) against libpll_tpu's on the CPU.

Both sides start from ``tests/test_spr_search.py``'s simulation (12 taxa
x 40 sites, GTR+Γ4, float64): the same newick parsed by each package's
utree, the same setters on each package's Partition (the port's with
``device="cpu"``, where the scorer's replay is C1's plain version).  Where
scaling has to fire in float64 (threshold 2^-256), the tips are explicit
CLVs of tiny values, the same on both sides.

Tolerances.  The encodings, candidates, op subsets and evaluation edges
are integers and are held equal.  The scores are float64 sums in another
order than JAX's: logL rel 1e-12.  Fresh evaluations of each moved tree:
``test_candidate_scores_match_bruteforce``'s atol 1e-8.  Counters are
integers and are held equal.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, "tests")

import libpll_tpu as jpll
from libpll_tpu.ops import clv as jclv
from libpll_tpu.ops import incremental as jinc_ops
from libpll_tpu.search import spr as jspr
from libpll_tpu.tree import incremental as jinc
from libpll_tpu.tree import utree as jut

import libpll_tpu_torch as tpll
from libpll_tpu_torch.engine.evaluate import partition_model
from libpll_tpu_torch.errors import CapacityError, EinvalError
from libpll_tpu_torch.ops import incremental as inc_ops
from libpll_tpu_torch.ops import likelihood as lk_ops
from libpll_tpu_torch.search import spr
from libpll_tpu_torch.tree import incremental as tinc
from libpll_tpu_torch.tree import moves as tmoves
from libpll_tpu_torch.tree import utree as tut

from test_spr_search import (ALPHA, CATS, FREQS, PARAMS, SITES, TIPS,
                             _random_tree, _simulate)

REL = 1e-12
BRUTE_ATOL = 1e-8
PIDX = [0] * CATS
CAP, BATCH = 16, 8


def _partition(pkg, tree, seqs, *, scaling="site", pinv=0.0, asc=None,
               tip_clv=None, **kw):
    """``test_spr_search._partition_for`` in either package, with a
    scaling mode, +I (on five constant columns), an asc mode or explicit
    tip CLVs."""
    part = pkg.Partition(TIPS, TIPS - 2, 4, SITES, 1, 2 * TIPS - 3, CATS,
                         TIPS - 2, scaling=scaling,
                         asc_bias_alloc=asc is not None, **kw)
    order = {n.label: n.clv_index for n in
             (jut if pkg is jpll else tut).query_tipnodes(tree)}
    for lab, s in seqs.items():
        if tip_clv is not None:
            part.set_tip_clv(order[lab], tip_clv[lab])
        else:  # +I needs constant columns: the first five made 'A'
            part.set_tip_states(order[lab], pkg.maps.pll_map_nt,
                                "AAAAA" + s[5:] if pinv else s)
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, PARAMS)
    part.set_category_rates(pkg.compute_gamma_cats(ALPHA, CATS))
    if pinv:
        part.update_invariant_sites_proportion(0, pinv)
    if asc is not None:
        part.set_asc_bias_type(asc)
        part.set_asc_state_weights([1, 2, 3, 4])
    return part


def _evaluate(ut, inc, tree, part):
    """Full P-matrices and CLVs, validity flags set."""
    trav = ut.traverse(tree.root)
    ops, blens, midx = ut.create_operations(trav)
    part.update_prob_matrices(PIDX, midx, blens)
    part.update_partials(ops)
    inc.mark_valid(trav)


def pair(seed=11, tiny_tips=False, **kw):
    """(jtree, jpart, ttree, tpart, seqs): the same simulation in both
    packages, evaluated, flags set.  ``tiny_tips``: explicit tip CLVs of
    uniform values times 1e-45, so that float64 scaling fires."""
    rng = np.random.default_rng(seed)
    newick = _random_tree(TIPS, rng)
    seqs = _simulate(newick, rng)
    if tiny_tips:
        kw["tip_clv"] = {lab: rng.uniform(0.05, 1.0, (SITES, 4)) * 1e-45
                         for lab in sorted(seqs)}
    jtree, ttree = jut.parse_newick_string(newick), \
        tut.parse_newick_string(newick)
    jpart = _partition(jpll, jtree, seqs, **kw)
    tpart = _partition(tpll, ttree, seqs, device="cpu", **kw)
    _evaluate(jut, jinc, jtree, jpart)
    _evaluate(tut, tinc, ttree, tpart)
    return jtree, jpart, ttree, tpart, seqs


def flags(tree):
    return [(n.node_index, m.clv_valid) for n in tree.nodes
            for m in ([n] if n.is_tip else n.ring())]


def as_ints(enc):
    """An encoding as integers: (candidate's node indices, its op tuples,
    changed (length, slot) pairs, eval edge)."""
    out = []
    for a, b, changed, pops, edge in enc:
        key = (a.node_index, b if isinstance(b, int) else b.node_index)
        out.append((key, [tuple(op.as_tuple()) for op in pops],
                    [(float(x), int(m)) for x, m in changed], tuple(edge)))
    return out


# ------------------------------------------------------------ encodings
@pytest.mark.parametrize("kind", ["traversal", "scalers"])
def test_encode_candidate_ops_matches_jax(kind):
    """``encode_candidate_ops`` equals JAX's exactly: a partial traversal
    whose parents are recomputed inside the subset, and a hand-made list
    with -1 scalers and a buffer written twice."""
    if kind == "traversal":
        jtree = jut.parse_newick_string(
            _random_tree(TIPS, np.random.default_rng(4)))
        jops = jut.create_operations(jut.traverse(jtree.root))[0]
        ops = [op.as_tuple() for op in jops]
        assert any(op[2] >= TIPS or op[5] >= TIPS for op in ops)
    else:
        ops = [(12, -1, 0, 0, -1, 1, 1, -1), (13, 1, 12, 2, -1, 2, 2, 4),
               (12, 0, 13, 3, 1, 3, 3, -1), (14, -1, 12, 4, 0, 13, 5, 1)]
    n, ns = 2 * TIPS - 2, TIPS - 2
    got = inc_ops.encode_candidate_ops(ops, n, ns, 32)
    want = jinc_ops.encode_candidate_ops(ops, n, ns, 32)
    assert np.array_equal(got[0], want[0]) and got[0].dtype == np.int32
    assert got[1] == want[1] and got[2] == want[2]
    if kind == "scalers":
        assert (got[0][:, [1, 4, 7]] == ns).any()


def test_capacity_error():
    ops = [(12 + k, k, k, k, -1, k + 1, k + 1, -1) for k in range(5)]
    with pytest.raises(CapacityError):
        inc_ops.encode_candidate_ops(ops, 22, 10, 4)
    assert inc_ops.encode_candidate_ops(ops, 22, 10, 5)[0].shape == (5, 8)


@pytest.mark.parametrize("kind", ["spr", "nni"])
def test_candidates_and_encodings_match_jax(kind):
    """``spr_neighborhood`` (radius 4) / ``nni_candidates`` and the
    encoders give JAX's candidates by node index, op subsets, changed
    branches, eval edges and ``n_ops_max``; every validity flag is
    restored exactly."""
    jtree, _, ttree, _, _ = pair()
    if kind == "spr":
        jc, tc = (jspr.spr_neighborhood(jtree, radius=4),
                  spr.spr_neighborhood(ttree, radius=4))
        assert [(p.node_index, r.node_index) for p, r in jc] == \
            [(p.node_index, r.node_index) for p, r in tc]
        # a prune set, as scripts/bench_spr.py passes one
        jp = jut.query_innernodes(jtree)[:4]
        tp = tut.query_innernodes(ttree)[:4]
        assert [(p.node_index, r.node_index) for p, r in
                jspr.spr_neighborhood(jtree, 3, prune_nodes=jp)] == \
            [(p.node_index, r.node_index) for p, r in
             spr.spr_neighborhood(ttree, 3, prune_nodes=tp)]
        jenc_fn, tenc_fn = jspr.encode_candidates, spr.encode_candidates
    else:
        jc, tc = jspr.nni_candidates(jtree), spr.nni_candidates(ttree)
        assert [(m.node_index, t) for m, t in jc] == \
            [(m.node_index, t) for m, t in tc]
        jenc_fn, tenc_fn = (jspr.encode_nni_candidates,
                            spr.encode_nni_candidates)
    before = flags(ttree)
    assert before == flags(jtree)
    jenc, jmax = jenc_fn(jtree, jc)
    tenc, tmax = tenc_fn(ttree, tc)
    assert flags(ttree) == before
    assert len(tenc) > 5 and tmax == jmax
    assert as_ints(tenc) == as_ints(jenc)


# -------------------------------------------------------------- scoring
def jax_scores(jtree, jpart, jenc, cap=CAP):
    return np.asarray(jspr.score_encoded(
        jtree, jpart, PIDX, jenc, cap, BATCH,
        jspr.make_round_scorer(jpart, cap)))


def port_scores(ttree, tpart, tenc, cap=CAP, scorer=None):
    return np.asarray(spr.score_encoded(
        ttree, tpart, PIDX, tenc, cap, BATCH,
        scorer or spr.make_round_scorer(tpart, cap)))


CASES = {"site": {}, "rate": {"scaling": "rate"},
         "none": {"scaling": "none"}, "pinv": {"pinv": 0.25},
         "lewis": {"asc": 1},
         "tiny_site": {"tiny_tips": True},
         "tiny_rate": {"tiny_tips": True, "scaling": "rate"}}


@pytest.mark.parametrize("case", list(CASES))
def test_scorer_matches_jax(case):
    """The plain scorer on the same candidates and partition state as
    JAX's ``make_candidate_scorer`` (through each ``score_encoded``):
    SPR (radius 4) and NNI candidates, float64 logL rel 1e-12."""
    jtree, jpart, ttree, tpart, _ = pair(seed=5, **CASES[case])
    for jfn, tfn, jgen, tgen in (
            (jspr.encode_candidates, spr.encode_candidates,
             lambda t: jspr.spr_neighborhood(t, radius=4),
             lambda t: spr.spr_neighborhood(t, radius=4)),
            (jspr.encode_nni_candidates, spr.encode_nni_candidates,
             jspr.nni_candidates, spr.nni_candidates)):
        jenc, _ = jfn(jtree, jgen(jtree))
        tenc, _ = tfn(ttree, tgen(ttree))
        want = jax_scores(jtree, jpart, jenc)
        got = port_scores(ttree, tpart, tenc)
        assert len(got) == len(want) > 5
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    if case.startswith("tiny"):  # the counters did fire
        assert int(tpart.scalers.sum()) > 0


def test_candidate_scores_match_bruteforce():
    """``tests/test_spr_search.py``'s brute-force check on the port alone:
    every scored candidate equals a fresh Partition's full evaluation of
    the moved tree (atol 1e-8)."""
    _, _, tree, part, seqs = pair(seed=11)
    enc, n_max = spr.encode_candidates(
        tree, spr.spr_neighborhood(tree, radius=4)[:12])
    cap = max(8, 1 << (n_max - 1).bit_length())
    logls = port_scores(tree, part, enc, cap)
    assert n_max < TIPS - 2 and len(enc) >= 6
    for (p, r, *_), got in zip(enc, logls):
        rb = tmoves.Rollback(tmoves.MOVE_SPR)
        tmoves.spr(p, r, rollback=rb)
        moved = tut.parse_newick_string(tut.export_newick(tree.root))
        fresh = _partition(tpll, moved, seqs, device="cpu")
        _evaluate(tut, tinc, moved, fresh)
        rt = moved.root
        want = fresh.compute_edge_loglikelihood(
            rt.clv_index, rt.scaler_index, rt.back.clv_index,
            rt.back.scaler_index, rt.pmatrix_index, PIDX)
        tmoves.rollback_move(rb)
        assert abs(got - want) <= BRUTE_ATOL, (got, want)


def test_base_unchanged_and_one_scorer_for_two_topologies():
    """``score_encoded`` leaves the base buffers bit-identical; one scorer
    serves a second topology (after a committed move) without a rebuild,
    and scores it as a fresh scorer does."""
    _, _, tree, part, _ = pair(seed=7, tiny_tips=True, scaling="rate")
    scorer = spr.make_round_scorer(part, CAP)
    snap = [t.clone() for t in (part.clv, part.scalers, part.pmatrix)]
    enc, _ = spr.encode_candidates(tree, spr.spr_neighborhood(tree, 4))
    first = port_scores(tree, part, enc, scorer=scorer)
    assert all(torch.equal(a, b) for a, b in
               zip((part.clv, part.scalers, part.pmatrix), snap))
    # commit the best move, evaluate the new topology, score again
    p, r = enc[int(np.argmax(first))][:2]
    tmoves.spr(p, r)
    tinc.invalidate_all(tree)
    _evaluate(tut, tinc, tree, part)
    enc2, _ = spr.encode_candidates(tree, spr.spr_neighborhood(tree, 4))
    again = port_scores(tree, part, enc2, scorer=scorer)
    fresh = port_scores(tree, part, enc2)
    assert np.array_equal(again, fresh)
    assert len(enc2) > 5


def test_batched_fold_equals_per_candidate():
    """``edge_loglikelihood`` with a leading batch axis (the scorer's
    fold) against the same one candidate at a time: per-site and per-rate
    counters, +I, the three asc modes; rel 1e-12."""
    rng = np.random.default_rng(3)
    b, c, s, sites = 5, 4, 4, 30
    length = sites + s
    for per_rate in (False, True):
        for asc in (0, 1, 2, 3):
            t = lambda *shape: torch.from_numpy(  # noqa: E731
                rng.uniform(0.05, 1.0, shape))
            parent, child = t(b, c, s, length), t(b, c, s, length)
            pm = t(b, c, s, s) / s
            sshape = (b, c, length) if per_rate else (b, length)
            sp = torch.from_numpy(rng.integers(0, 3, sshape).astype(np.int32))
            sc = torch.from_numpy(rng.integers(0, 3, sshape).astype(np.int32))
            freqs = t(c, s)
            freqs = freqs / freqs.sum(dim=1, keepdim=True)
            rw = torch.full((c,), 1.0 / c, dtype=torch.float64)
            pw = torch.from_numpy(rng.integers(1, 4, length).astype(float))
            pinv = torch.full((c,), 0.2, dtype=torch.float64)
            inv = torch.from_numpy(np.where(
                rng.uniform(size=length) < 0.3,
                rng.integers(0, s, length), -1).astype(np.int32))
            got = lk_ops.edge_loglikelihood(
                parent, child, sp, sc, pm, freqs, rw, pw, pinv, inv,
                sites=sites, per_rate=per_rate, asc_mode=asc)[0]
            assert got.shape == (b,)
            for k in range(b):
                want = lk_ops.edge_loglikelihood(
                    parent[k], child[k], sp[k], sc[k], pm[k], freqs, rw, pw,
                    pinv, inv, sites=sites, per_rate=per_rate,
                    asc_mode=asc)[0]
                assert abs(float(got[k]) - float(want)) <= REL * abs(
                    float(want)), (per_rate, asc, k)


def test_host_tables_are_checked():
    """Host tables are checked against the buffers' extents before
    anything runs (as U1's host tables): a parent outside the scratch, a
    child past the rows, a matrix or an eval row out of range."""
    _, _, tree, part, _ = pair(seed=11)
    enc, _ = spr.encode_candidates(tree, spr.spr_neighborhood(tree, 4))
    b, t, mi, bl, er = next(spr.encoded_batches(
        enc, part.nodes, part.scale_buffers, CAP, BATCH))
    scorer = spr.make_round_scorer(part, CAP)
    model = partition_model(part, PIDX)

    def call(t=t, mi=mi, er=er):
        return scorer(part.clv, part.scalers, part.pmatrix, model, t, mi, bl,
                      er)

    assert call().shape == (BATCH,)
    for col, value in ((0, 3), (2, part.nodes + CAP), (3, 10 ** 6),
                       (4, -1)):
        bad = t.copy()
        bad[0, 0, col] = value
        with pytest.raises(EinvalError):
            call(t=bad)
    bad = mi.copy()
    bad[0, 0] = part.pmatrix.shape[0]
    with pytest.raises(EinvalError):
        call(mi=bad)
    bad = er.copy()
    bad[0, 0] = part.nodes + CAP
    with pytest.raises(EinvalError):
        call(er=bad)
    with pytest.raises(EinvalError):
        call(t=t[:, :CAP - 1])


@pytest.mark.parametrize("scaling", ["site", "rate"])
def test_nan_vote_counters_match_jax(scaling):
    """One NaN at state 1 of rate 0 of every P-matrix, tiny rows that
    scale without it: the plain replay's counters equal JAX's
    ``update_partials`` on the same ops (the scratch rows laid after the
    base rows, every op owning a scaler), and with the NaN fewer spans
    scale (JAX's ``jnp.all(x < thresh)`` is False on a NaN)."""
    rng = np.random.default_rng(8)
    mode = {"site": 1, "rate": 2}[scaling]
    n, ns, c, s, sites, rows = 4, 3, 4, 4, 23, 4
    base = rng.uniform(0.5, 1.0, (n, c, s, sites)) * 1e-40
    pm = rng.uniform(0.05, 1.0, (3, c, s, s)) / s
    table = np.array([[4, 4, 0, 0, 3, 1, 1, 3], [5, 5, 2, 2, 3, 4, 0, 4],
                      [6, 6, 5, 1, 5, 3, 2, 3]], np.int32)
    sshape = (ns + 1, sites) if mode == 1 else (ns + 1, c, sites)
    counts = {}
    for label in ("clean", "nan"):
        p = pm.copy()
        if label == "nan":
            p[:, 0, 1, :] = np.nan
        tp = torch.from_numpy(p)
        _, got = inc_ops.replay_candidates_plain(
            torch.from_numpy(base), torch.zeros(sshape, dtype=torch.int32),
            tp, torch.from_numpy(table[None]),
            torch.tensor([[0, 1, 2]], dtype=torch.int32), tp[None], rows,
            mode)
        clv_all = jnp.asarray(np.concatenate(
            [base, np.zeros((rows, c, s, sites))]))
        scal_all = jnp.zeros((ns + 1 + rows,) + sshape[1:], jnp.int32)
        _, want = jclv.update_partials(clv_all, scal_all, jnp.asarray(table),
                                       jnp.asarray(p), scale_mode=mode)
        want = np.asarray(want)[ns + 1:]
        assert np.array_equal(got[0].numpy(), want), label
        counts[label] = int(want.sum())
    assert counts["clean"] > counts["nan"]
