"""The port's stateful Partition path against libpll_tpu's on the CPU.

The same numpy inputs, made from a seed, go through ``libpll_tpu``'s
Partition and the port's (``device="cpu"``): the same setters, op lists,
CLVs, scalers, root and edge logL (and per site), sumtables and
derivatives.  float64: logL, CLVs and derivatives to rel 1e-12, scalers
exactly.  float32: logL within the engine's budget |ΔlogL| <= 2e-6·|logL|
+ 5e-3 of JAX's float32 and float64 results.  The ops executors
(``ops.clv``) and ``build_levels`` are held against JAX's directly, and
``model_from_partition`` feeds ``make_score`` and ``make_forward_fused``
(the plain versions of K1/K2 on the CPU) against JAX's kernels run in
interpret mode, as JAX's own tests run them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import libpll_tpu as jpll
from libpll_tpu.engine import evaluate as jev
from libpll_tpu.ops import clv as jclv
from libpll_tpu.ops import clv_pallas as cp
from libpll_tpu.tree import schedule as jsched
from libpll_tpu.tree import utree as jut

import libpll_tpu_torch as tpll
from libpll_tpu_torch.engine import evaluate as tev
from libpll_tpu_torch.io import maps as tmaps
from libpll_tpu_torch.models.gamma import compute_gamma_cats
from libpll_tpu_torch.ops import clv as tclv
from libpll_tpu_torch.ops import clv_fused as cf
from libpll_tpu_torch.tree import schedule as tsched
from libpll_tpu_torch.tree import utree as tut
from libpll_tpu_torch.utils.constants import (SCALE_NONE, SCALE_PER_RATE,
                                              SCALE_PER_SITE)

F64_RTOL = 1e-12
ACC_REL, ACC_ABS = 2e-6, 5e-3
DNA = "ACGTRYN-"
AA = "ARNDCQEGHILKMFPSTWYVBZX-"


def random_newick(tips, rng):
    items = [f"t{i}:{rng.uniform(0.05, 0.6):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b, a = items.pop(j), items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.6):.4f}")
    return f"({items[0]},{items[1]},{items[2]});"


class Pair:
    """One configuration built in both packages from one seed."""

    def __init__(self, tips=7, sites=41, states=4, rate_cats=4,
                 scaling="site", f64=True, pinv=0.0, asc=None,
                 rate_matrices=1, tip_clv=False, seed=0):
        rng = np.random.default_rng(seed)
        self.newick = random_newick(tips, rng)
        self.jtree = jut.parse_newick_string(self.newick)
        self.ttree = tut.parse_newick_string(self.newick)
        inner, nbr = tips - 2, 2 * tips - 3
        self.args = (tips, inner, states, sites, rate_matrices, nbr,
                     rate_cats, inner)
        kw = dict(scaling=scaling, asc_bias_alloc=asc is not None)
        self.jp = jpll.Partition(*self.args, **kw,
                                 dtype=jnp.float64 if f64 else jnp.float32)
        self.tp = tpll.Partition(*self.args, **kw,
                                 dtype=torch.float64 if f64 else
                                 torch.float32, device="cpu")
        self.f64 = f64
        n_par = states * (states - 1) // 2
        params = rng.uniform(0.5, 3.0, (rate_matrices, n_par))
        freqs = rng.uniform(0.2, 1.0, (rate_matrices, states))
        freqs /= freqs.sum(1, keepdims=True)
        rates = compute_gamma_cats(0.6, rate_cats)
        weights = rng.uniform(0.5, 1.0, rate_cats)
        weights /= weights.sum()
        pw = rng.integers(1, 4, sites)
        chars, charmap = ((DNA, tmaps.pll_map_nt) if states == 4
                          else (AA, tmaps.pll_map_aa))
        # a constant prefix keeps invariant sites for +I
        seqs = ["".join(rng.choice(list(chars), sites)) for _ in range(tips)]
        if pinv:
            seqs = [chars[0] * 5 + s[5:] for s in seqs]
        tip_clvs = [rng.uniform(0.0, 1.0, (sites, states))
                    * 10.0 ** rng.uniform(-12, 0, (sites, 1))
                    for _ in range(tips)]
        self.tip_data = (tip_clvs if tip_clv else seqs), charmap
        for p in (self.jp, self.tp):
            for k in range(rate_matrices):
                p.set_subst_params(k, params[k])
                p.set_frequencies(k, freqs[k])
            p.set_category_rates(rates)
            p.set_category_weights(weights)
            p.set_pattern_weights(pw)
            self.set_tips(p, self.ttree)
            if pinv:
                p.update_invariant_sites_proportion(0, pinv)
            if asc is not None:
                p.set_asc_bias_type(asc)
                p.set_asc_state_weights(np.arange(1, states + 1))
        self.pidx = (rng.integers(0, rate_matrices, rate_cats)
                     if rate_matrices > 1 else np.zeros(rate_cats, int))
        self.full_traversal()

    def set_tips(self, part, tree):
        """The tips by label, as a user re-applies them from the
        alignment."""
        data, charmap = self.tip_data
        for n in tut.query_tipnodes(tree):
            i = int(n.label[1:])
            if isinstance(data[i], str):
                part.set_tip_states(n.clv_index, charmap, data[i])
            else:
                part.set_tip_clv(n.clv_index, data[i])

    def full_traversal(self):
        trav = tut.traverse(self.ttree.root)
        self.ops, self.branches, self.pmat_idx = tut.create_operations(trav)
        jops, jbr, jpm = jut.create_operations(jut.traverse(self.jtree.root))
        assert [o.as_tuple() for o in self.ops] == [o.as_tuple()
                                                    for o in jops]
        assert (self.branches, self.pmat_idx) == (jbr, jpm)
        for p in (self.jp, self.tp):
            p.update_prob_matrices(self.pidx, self.pmat_idx, self.branches)
        self.jp.update_partials(jops)
        self.tp.update_partials(self.ops)

    def edge(self):
        r = self.ttree.root
        return (r.clv_index, r.scaler_index, r.back.clv_index,
                r.back.scaler_index, r.pmatrix_index)

    def run(self, method, *args, **kw):
        return (getattr(self.jp, method)(*args, **kw),
                getattr(self.tp, method)(*args, **kw))


def assert_rows_close(got, want):
    """float64 [..., S, L] arrays (CLVs, sumtables): each entry within rel
    1e-12 of its (row, rate, site) block's largest magnitude (the same
    algorithm; only the summation order differs)."""
    scale = np.abs(want).max(axis=-2, keepdims=True)
    err = np.abs(got - want) - F64_RTOL * scale
    assert (err <= 0).all(), f"beyond rel 1e-12 of the block: {err.max()}"


def assert_buffers_equal(jp, tp):
    """float64: CLVs (:func:`assert_rows_close`), scalers exactly,
    P-matrices rel 1e-12."""
    assert_rows_close(tp.clv.numpy(), np.asarray(jp.clv))
    np.testing.assert_array_equal(tp.scalers.numpy(), np.asarray(jp.scalers))
    np.testing.assert_allclose(tp.pmatrix.numpy(), np.asarray(jp.pmatrix),
                               rtol=F64_RTOL, atol=1e-15)


def assert_logl(got, want, f64, truth=None):
    if f64:
        np.testing.assert_allclose(got, want, rtol=F64_RTOL)
    else:
        for ref in (want,) if truth is None else (want, truth):
            assert abs(got - ref) <= ACC_REL * abs(ref) + ACC_ABS, (got, ref)


CONFIGS = {
    "site": dict(),
    "rate": dict(scaling="rate"),
    "none": dict(scaling="none"),
    "pinv": dict(pinv=0.3),
    "pinv_rate": dict(pinv=0.2, scaling="rate"),
    "lewis": dict(asc=tpll.ASC_LEWIS),
    "felsenstein": dict(asc=tpll.ASC_FELSENSTEIN),
    "stamatakis": dict(asc=tpll.ASC_STAMATAKIS),
    "lewis_rate": dict(asc=tpll.ASC_LEWIS, scaling="rate"),
    "matrices": dict(rate_matrices=3),
    "tip_clv": dict(tip_clv=True, tips=24),
    "tip_clv_rate": dict(tip_clv=True, tips=24, scaling="rate"),
    "protein": dict(states=20, rate_cats=2, sites=23),
    "one_rate": dict(rate_cats=1),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_partition_f64(name):
    """Buffers, edge and root logL (per site too), sumtable and
    derivatives at the root edge equal JAX's."""
    pr = Pair(**CONFIGS[name], seed=len(name))
    assert_buffers_equal(pr.jp, pr.tp)
    assert pr.tp.pattern_weight_sum == pr.jp.pattern_weight_sum
    if not name.startswith(("tip_clv", "lewis", "felsenstein", "stamatakis")):
        assert pr.tp.count_invariant_sites() == pr.jp.count_invariant_sites()
        np.testing.assert_array_equal(pr.tp.invariant, pr.jp.invariant)
    pc, ps, cc, cs, m = pr.edge()
    (jl, jps), (tl, tps) = pr.run("compute_edge_loglikelihood", pc, ps, cc,
                                  cs, m, pr.pidx, persite=True)
    np.testing.assert_allclose(tl, jl, rtol=F64_RTOL)
    np.testing.assert_allclose(tps, np.asarray(jps), rtol=F64_RTOL)
    (jr, jrps), (tr, trps) = pr.run("compute_root_loglikelihood", pc, ps,
                                    pr.pidx, persite=True)
    np.testing.assert_allclose(tr, jr, rtol=F64_RTOL)
    np.testing.assert_allclose(trps, np.asarray(jrps), rtol=F64_RTOL)
    js, ts = pr.run("update_sumtable", pc, cc, ps, cs, pr.pidx)
    assert_rows_close(ts.numpy(), np.asarray(js))
    t = pr.branches[-1]
    jd = pr.jp.compute_likelihood_derivatives(ps, cs, t, pr.pidx, js)
    td = pr.tp.compute_likelihood_derivatives(ps, cs, t, pr.pidx, ts)
    np.testing.assert_allclose(td, jd, rtol=1e-10)
    if name.startswith("tip_clv"):
        assert pr.tp.scalers.numpy().any(), "scaling never fired"


@pytest.mark.parametrize("name", ["site", "rate", "pinv", "lewis",
                                  "protein"])
def test_partition_f32(name):
    """float32: logL within the budget of JAX's float32 and float64;
    derivatives within float32 round-off of JAX's."""
    pr = Pair(**CONFIGS[name], f64=False, seed=len(name))
    truth = Pair(**CONFIGS[name], seed=len(name))
    pc, ps, cc, cs, m = pr.edge()
    jl, tl = pr.run("compute_edge_loglikelihood", pc, ps, cc, cs, m, pr.pidx)
    want = truth.jp.compute_edge_loglikelihood(pc, ps, cc, cs, m, pr.pidx)
    assert_logl(tl, jl, False, want)
    js, ts = pr.run("update_sumtable", pc, cc, ps, cs, pr.pidx)
    t = pr.branches[-1]
    jd = pr.jp.compute_likelihood_derivatives(ps, cs, t, pr.pidx, js)
    td = pr.tp.compute_likelihood_derivatives(ps, cs, t, pr.pidx, ts)
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-2)


def test_partial_traversal_and_rewritten_buffers():
    """An SPR move, then the partial op list; an op list that writes a
    buffer twice and reads a child before overwriting it; ``pad_to``."""
    from libpll_tpu.tree import incremental as jinc
    from libpll_tpu.tree import moves as jmv
    from libpll_tpu_torch.tree import incremental as tinc
    from libpll_tpu_torch.tree import moves as tmv

    pr = Pair(tips=10, sites=33, seed=3)
    for inc, tree in ((jinc, pr.jtree), (tinc, pr.ttree)):
        inc.mark_valid(tut.traverse(tree.root) if inc is tinc
                       else jut.traverse(tree.root))
    # the same move in both trees: the first legal (p, r) by position in
    # .nodes
    nodes = pr.ttree.nodes
    k_p, k_r = next(
        (i, j) for i in range(len(nodes)) for j in range(len(nodes))
        if nodes[i].next is not None and nodes[j] not in (
            nodes[i], nodes[i].back, nodes[i].next, nodes[i].next.back,
            nodes[i].next.next, nodes[i].next.next.back)
        and not tmv._subtree_contains(nodes[i].back, nodes[j]))
    for mv, inc, tree, part in ((jmv, jinc, pr.jtree, pr.jp),
                                (tmv, tinc, pr.ttree, pr.tp)):
        p, r = tree.nodes[k_p], tree.nodes[k_r]
        changed = mv.spr_safe(p, r)
        lens, idx = zip(*changed)
        part.update_prob_matrices(pr.pidx, idx, lens)
        ops = inc.create_partial_operations(inc.partial_traverse(tree.root))
        assert 0 < len(ops) < tree.inner_count
        part.update_partials(ops, pad_to=len(ops) + 3)
    assert_buffers_equal(pr.jp, pr.tp)
    pc, ps, cc, cs, m = pr.edge()
    jl, tl = pr.run("compute_edge_loglikelihood", pc, ps, cc, cs, m, pr.pidx)
    np.testing.assert_allclose(tl, jl, rtol=F64_RTOL)

    # node 10 is an inner buffer: write it, read it into 11, rewrite it
    # from other children, read it again; scaler -1 on one write
    tips = pr.args[0]
    ops = [(tips, 0, 0, 0, -1, 1, 1, -1),
           (tips + 1, 1, tips, 2, 0, 2, 2, -1),
           (tips, -1, 3, 3, -1, 4, 4, -1),
           (tips + 2, 2, tips, 5, -1, tips + 1, 6, 1),
           (tips + 1, 1, tips + 2, 7, 2, 5, 8, -1)]
    pr.jp.update_partials([jpll.Operation(*o) for o in ops])
    pr.tp.update_partials([tpll.Operation(*o) for o in ops])
    assert_buffers_equal(pr.jp, pr.tp)


def _random_ops(rng, tips, inner, n, scale_buffers, matrices):
    """Arbitrary op tables: parents among inner rows, children anywhere
    (rows never computed read as zeros or earlier values), scalers −1 or
    any row."""
    ops = np.empty((n, 8), np.int32)
    ops[:, 0] = rng.integers(tips, tips + inner, n)
    ops[:, [2, 5]] = rng.integers(0, tips + inner, (n, 2))
    ops[:, [3, 6]] = rng.integers(0, matrices, (n, 2))
    ops[:, [1, 4, 7]] = rng.integers(-1, scale_buffers, (n, 3))
    return ops


@pytest.mark.parametrize("mode", [SCALE_PER_SITE, SCALE_PER_RATE,
                                  SCALE_NONE])
def test_executors_against_jax(mode):
    """``update_partials`` (and its two executors, one op at a time and
    grouped) run random op tables (hazards of every kind) to JAX's ``update_partials`` result;
    ``update_partials_leveled`` on ``build_levels`` to JAX's leveled one.
    (XLA flushes subnormal results to zero on the CPU, PyTorch keeps them:
    the P-matrix entries stay >= 0.05, so every entry of a product stays
    within a few decades of its site's largest, in the normal range.)"""
    rng = np.random.default_rng(mode)
    tips, inner, C, S, L, M = 5, 6, 3, 4, 29, 9
    clv = np.zeros((tips + inner, C, S, L))
    # one more tip row for the tree of the leveled run below
    clv[:tips + 1] = rng.uniform(0.05, 1, (tips + 1, 1, S, L)) * 10.0 ** (
        rng.uniform(-60, 0, (tips + 1, 1, 1, L)))
    p = rng.uniform(0.05, 1, (M, C, S, S))
    shape = ((inner + 1, L) if mode == SCALE_PER_SITE else
             (inner + 1, C, L) if mode == SCALE_PER_RATE else (1, L))
    ops = _random_ops(rng, tips, inner, 40, inner, M)
    table = jpll.engine.partition.operations_to_array(
        [tuple(o) for o in ops], inner)
    np.testing.assert_array_equal(
        tpll.engine.partition.operations_to_array(
            [tuple(o) for o in ops], inner), table)
    jc, js = jclv.update_partials(jnp.asarray(clv), jnp.zeros(shape,
                                                              jnp.int32),
                                  jnp.asarray(table), jnp.asarray(p),
                                  scale_mode=mode)
    for run in (tclv.update_partials, tclv.update_partials_by_op,
                tclv.update_partials_grouped):
        tc, ts = torch.tensor(clv), torch.zeros(shape, dtype=torch.int32)
        run(tc, ts, table, torch.tensor(p), scale_mode=mode)
        assert_rows_close(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if mode != SCALE_NONE:
        assert np.asarray(js).any(), "scaling never fired"

    # a proper post order through build_levels
    tree = jut.parse_newick_string(random_newick(tips + 1, rng))
    post, _, _ = jut.create_operations(jut.traverse(tree.root))
    lev, valid = jsched.build_levels(post, inner, width=3)
    tlev, tvalid = tsched.build_levels(
        [tpll.Operation(*o.as_tuple()) for o in post], inner, width=3)
    np.testing.assert_array_equal(tlev, lev)
    np.testing.assert_array_equal(tvalid, valid)
    clv = clv[:tips + inner - 1]
    jc, js = jclv.update_partials_leveled(
        jnp.asarray(clv), jnp.zeros(shape, jnp.int32), jnp.asarray(lev),
        jnp.asarray(valid), jnp.asarray(p), scale_mode=mode)
    tc, ts = torch.tensor(clv), torch.zeros(shape, dtype=torch.int32)
    tclv.update_partials_leveled(tc, ts, lev, valid, torch.tensor(p),
                                 scale_mode=mode)
    assert_rows_close(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_update_partials_picks_its_executor(monkeypatch):
    """Grouped while rows are small and the ops group at least two to a
    group; one op at a time for a chain (a partial traversal) or for rows
    of GROUPED_MAX_ROW_BYTES and more."""
    calls = []
    monkeypatch.setattr(tclv, "_run_levels",
                        lambda *a: calls.append("grouped"))
    monkeypatch.setattr(tclv, "update_partials_by_op",
                        lambda *a: calls.append("by_op"))
    tree = tut.parse_newick_string(random_newick(16, np.random.default_rng(1)))
    full = tpll.engine.partition.operations_to_array(
        tut.create_operations(tut.traverse(tree.root))[0], 14)
    chain = np.array([(16 + k, k, 15 + k if k else 0, 0, k - 1 if k else -1,
                       k + 1, 1, -1) for k in range(5)], np.int32)
    chain[chain == -1] = 14
    clv = torch.zeros((30, 4, 4, 8), dtype=torch.float64)
    scal = torch.zeros((15, 8), dtype=torch.int32)
    pm = torch.zeros((29, 4, 4, 4), dtype=torch.float64)
    for ops in (full, chain):
        tclv.update_partials(clv, scal, ops, pm)
    monkeypatch.setattr(tclv, "GROUPED_MAX_ROW_BYTES", clv[0].numel() * 8)
    tclv.update_partials(clv, scal, full, pm)
    assert calls == ["grouped", "by_op", "by_op"]


def _rows(op, dummy):
    """(rows written, rows read) of one op; an op whose scaler is the
    dummy neither writes nor (usefully) reads scaler rows."""
    writes, reads = {("c", op[0])}, {("c", op[2]), ("c", op[5])}
    if op[1] != dummy:
        writes.add(("s", op[1]))
        reads |= {("s", s) for s in (op[4], op[7]) if s != dummy}
    return writes, reads


def test_hazard_levels_keep_order():
    """Ops of one group touch disjoint rows; a group never precedes an
    op it depends on."""
    rng = np.random.default_rng(7)
    ops = _random_ops(rng, 4, 5, 60, 5, 3)
    ops[ops == -1] = 5  # remapped "no scaler"
    level = tclv.hazard_levels(ops, 5)
    for i in range(len(ops)):
        for j in range(i + 1, len(ops)):
            a, b = ops[i], ops[j]
            wa, ra = _rows(a, 5)
            wb, rb = _rows(b, 5)
            if (wa & (rb | wb)) or (ra & wb):
                assert level[j] > level[i], (i, j)


def test_model_from_partition_feeds_the_factories():
    """The dict equals JAX's; ``make_score`` and ``make_forward_fused`` on
    it equal JAX's kernels (interpret mode) within the f32 budget, and
    the float64 ``make_forward`` equals the Partition's logL."""
    pr = Pair(tips=9, sites=128, rate_matrices=2, seed=11)
    pidx = pr.pidx
    jm = jev.model_from_partition(pr.jp, pr.branches, pidx)
    tm = tev.model_from_partition(pr.tp, pr.branches, pidx, device="cpu")
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, err_msg=k)
        assert tm[k].dtype == (torch.int32 if k in ("params_indices",
                                                    "invariant")
                               else torch.float32), k
    tm64 = tev.model_from_partition(pr.tp, pr.branches, pidx,
                                    torch.float64, device="cpu")
    topo, _ = tev.topology_from_tree(pr.ttree, pr.tp.sites)
    jtopo, _ = jev.topology_from_tree(pr.jtree, pr.jp.sites)
    sched = topo.schedule
    rows = [sched.clv_map[i] for i in range(pr.tp.tips)]
    tipclv = pr.tp.clv[:pr.tp.tips]
    clv = torch.zeros((sched.tips + sched.n_inner,) + tipclv.shape[1:],
                      dtype=torch.float64)
    clv[rows] = tipclv
    scal = torch.zeros((sched.n_inner + 1, pr.tp.sites), dtype=torch.int32)
    f64 = float(tev.make_forward(topo, device="cpu")(tm64, clv, scal)[0])
    pc, ps, cc, cs, m = pr.edge()
    want = pr.tp.compute_edge_loglikelihood(pc, ps, cc, cs, m, pidx)
    np.testing.assert_allclose(f64, want, rtol=F64_RTOL)

    C, S = pr.tp.rate_cats, pr.tp.states
    t32 = clv.to(torch.float32)[:sched.tips]
    got_score = float(tev.make_score(topo, C, S, device="cpu")(tm, t32))
    got_fwd = float(tev.make_forward_fused(topo, C, S, device="cpu")(
        tm, t32)[0])
    jtips = cp.pack_tips(jnp.asarray(t32.numpy()), impl="vpu")
    jscore = float(jev.make_score(jtopo, C, S, interpret=True)(jm, jtips))
    jfwd = float(jev.make_forward_fused(jtopo, C, S, interpret=True)(
        jm, jtips)[0])
    for got, ref in ((got_score, jscore), (got_fwd, jfwd),
                     (got_score, want)):
        assert abs(got - ref) <= ACC_REL * abs(ref) + ACC_ABS, (got, ref)
    assert cf.fused_edge_score.launches == 0  # the plain K1 on the CPU


def test_show_pmatrix_and_clv_text():
    import io

    from libpll_tpu.utils import output as jout
    from libpll_tpu_torch.utils import output as tout

    pr = Pair(tips=5, sites=6, rate_cats=2, tip_clv=True, seed=2)
    node = pr.ttree.root
    for jf, tf, args in (
            (jout.show_pmatrix, tout.show_pmatrix, (3, 7)),
            (jout.show_clv, tout.show_clv,
             (node.clv_index, node.scaler_index, 9)),
            (jout.show_clv, tout.show_clv, (1, -1, 5))):
        a, b = io.StringIO(), io.StringIO()
        jf(pr.jp, *args, out=a)
        tf(pr.tp, *args, out=b)
        assert b.getvalue() == a.getvalue()


ERROR_CASES = {
    "tips": lambda m, P: P(2, 1, 4, 10, 1, 3, 1, 1, device="cpu")
    if m is tpll else P(2, 1, 4, 10, 1, 3, 1, 1),
    "scaling": lambda m, P: P(4, 2, 4, 10, 1, 5, 1, 2, scaling="x",
                              **_cpu(m)),
    "tip_range": lambda m, P: _part(m, P).set_tip_states(
        9, m.maps.pll_map_nt, "A" * 10),
    "tip_length": lambda m, P: _part(m, P).set_tip_states(
        0, m.maps.pll_map_nt, "A" * 9),
    "tip_char": lambda m, P: _part(m, P).set_tip_states(
        0, m.maps.pll_map_nt, "J" * 10),
    "tip_clv_shape": lambda m, P: _part(m, P).set_tip_clv(0, np.ones((9, 4))),
    "subst": lambda m, P: _part(m, P).set_subst_params(0, np.ones(5)),
    "freqs": lambda m, P: _part(m, P).set_frequencies(0, np.ones(3)),
    "pattern_weights": lambda m, P: _part(m, P).set_pattern_weights(
        np.ones(3)),
    "asc_alloc": lambda m, P: _part(m, P).set_asc_bias_type(m.ASC_LEWIS),
    "asc_weights": lambda m, P: _part(m, P).set_asc_state_weights(
        np.ones(4)),
    "asc_type": lambda m, P: _part(m, P, asc_bias_alloc=True
                                   ).set_asc_bias_type(7),
    "pinv_range": lambda m, P: _part(m, P).update_invariant_sites_proportion(
        0, 1.0),
    "pinv_index": lambda m, P: _part(m, P).update_invariant_sites_proportion(
        3, 0.1),
    "pinv_none": lambda m, P: _tipped(m, P, "ACGTACGTAC", "CGTACGTACG"
                                      ).update_invariant_sites_proportion(
        0, 0.1),
    "pinv_asc": lambda m, P: _asc_then_pinv(m, P),
    "negative_branch": lambda m, P: _part(m, P).update_prob_matrices(
        [0], [0], [-0.1]),
    "pad_to": lambda m, P: _part(m, P).update_partials(
        [m.Operation(4, 0, 0, 0, -1, 1, 1, -1)] * 3, pad_to=2),
}


def _cpu(m):
    return {"device": "cpu"} if m is tpll else {}


def _part(m, P, **kw):
    return P(4, 2, 4, 10, 1, 5, 1, 2, **kw, **_cpu(m))


def _tipped(m, P, *seqs):
    p = _part(m, P)
    for i in range(4):
        p.set_tip_states(i, m.maps.pll_map_nt, seqs[i % len(seqs)])
    return p


def _asc_then_pinv(m, P):
    p = _part(m, P, asc_bias_alloc=True)
    p.set_asc_bias_type(m.ASC_LEWIS)
    p.update_invariant_sites_proportion(0, 0.1)


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_same_errors(case):
    """The same PllError subclass (by name) in the same cases."""
    names = []
    for m in (jpll, tpll):
        with pytest.raises(m.PllError) as info:
            ERROR_CASES[case](m, m.Partition)
        names.append(type(info.value).__name__)
    assert names[0] == names[1], names


def test_checkpoint_crosses_both_ways(tmp_path):
    """A file either package writes restores in the other to the same
    parameters; the port's restored Partition, tips re-applied, gives the
    same logL bit for bit; the version guard holds in both."""
    import json

    from libpll_tpu.engine import checkpoint as jck
    from libpll_tpu_torch.engine import checkpoint as tck

    for f64 in (True, False):
        pr = Pair(tips=6, sites=30, rate_cats=2, f64=f64, seed=5)
        pc, ps, cc, cs, m = pr.edge()
        logl = pr.tp.compute_edge_loglikelihood(pc, ps, cc, cs, m, pr.pidx)
        for save, load, restore, part, kw in (
                (jck.save_checkpoint, tck.load_checkpoint,
                 tck.restore_partition, pr.jp, {"device": "cpu"}),
                (tck.save_checkpoint, jck.load_checkpoint,
                 jck.restore_partition, pr.tp, {})):
            path = str(tmp_path / "ck.npz")
            save(path, tut.export_newick(pr.ttree.root), part,
                 rng_state=np.arange(4), extra={"round": 3})
            header, arrays = load(path)
            assert header["dtype"] == ("float64" if f64 else "float32")
            assert header["extra"] == {"round": 3}
            np.testing.assert_array_equal(arrays["rng_state"], np.arange(4))
            back = restore(header, arrays, **kw)
            for k in ("subst_params", "frequencies", "rates",
                      "rate_weights", "prop_invar", "pattern_weights"):
                np.testing.assert_array_equal(getattr(back, k),
                                              getattr(pr.tp, k))
            if restore is not tck.restore_partition:
                continue
            assert back.dtype == (torch.float64 if f64 else torch.float32)
            tree = tut.parse_newick_string(header["newick"])
            ops, branches, pmat_idx = tut.create_operations(
                tut.traverse(tree.root))
            pr.set_tips(back, tree)
            back.update_prob_matrices(pr.pidx, pmat_idx, branches)
            back.update_partials(ops)
            r = tree.root
            got = back.compute_edge_loglikelihood(
                r.clv_index, r.scaler_index, r.back.clv_index,
                r.back.scaler_index, r.pmatrix_index, pr.pidx)
            assert got == logl

    bad = tmp_path / "bad.npz"
    np.savez(bad, header=np.frombuffer(json.dumps({"version": 99}).encode(),
                                       dtype=np.uint8))
    for load in (jck.load_checkpoint, tck.load_checkpoint):
        with pytest.raises(ValueError, match="unsupported checkpoint"):
            load(str(bad))
