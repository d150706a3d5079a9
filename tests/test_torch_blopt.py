"""The port's branch-length optimisation (``engine/blopt.py``) against
libpll_tpu's on the CPU.

Both sides start from ``tests/test_spr_search.py``'s simulation (12 taxa x
40 sites, GTR+Γ4, float64) with ``tests/test_blopt.py``'s perturbed
lengths: the same newick parsed by each package's utree, the same lengths
scaled by the same factor, the same setters on each package's Partition
(the port's with ``device="cpu"``: U1's and N1's plain versions run).

Tolerances.  float64 throughout; the two packages differ only in summation
order.  Newton's t* to rel 1e-12 (its last step is ~1e-9 / d2, and the
rounding of d1 moves it far less).  The host loop: logL rel 1e-10 and
every length rel 1e-8 (an edge's t* feeds the next edge's CLVs, so
rounding compounds over ~4 sweeps x 21 edges), the same sweep count, and
test_blopt's own check of the result: a fresh evaluation of the exported
tree (``export_newick`` writes six decimals) within its
``assert_allclose(atol=1e-7)`` (1e-6 after the scan optimiser).  The
scan program on the same inputs: CLVs, P-matrices, t and logL rel 1e-12,
scalers equal.
"""

import sys
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, "tests")

from libpll_tpu.engine import blopt as jblopt
from libpll_tpu.search.spr import _model_from_partition as j_model
from libpll_tpu.tree import incremental as jinc
from libpll_tpu.tree import utree as jut

import libpll_tpu_torch as tpll
from libpll_tpu_torch.engine import blopt as tblopt
from libpll_tpu_torch.engine.evaluate import partition_model
from libpll_tpu_torch.errors import CapacityError
from libpll_tpu_torch.ops import derivatives as dv
from libpll_tpu_torch.tree import utree as tut

from test_blopt import _setup
from test_spr_search import (ALPHA, CATS, FREQS, PARAMS, SITES, TIPS,
                             _full_logl, _random_tree,
                             _simulate)

T_REL = 1e-12
LOGL_REL, LEN_REL = 1e-10, 1e-8
F64_REL = 1e-12
PIDX = [0] * CATS


def port_pair(seed, perturb):
    """JAX's ``_setup(seed, perturb)`` and the port's twin of it: (jtree,
    jpart, ttree, tpart, seqs)."""
    jtree, jpart, seqs = _setup(seed=seed, perturb=perturb)
    rng = np.random.default_rng(seed)
    newick = _random_tree(TIPS, rng)
    assert _simulate(newick, rng) == seqs
    ttree = tut.parse_newick_string(newick)
    for n in ttree.nodes:
        for m in ([n] if n.is_tip else list(n.ring())):
            m.length = m.length * perturb
    for n in ttree.nodes:
        for m in ([n] if n.is_tip else list(n.ring())):
            m.back.length = m.length
    return jtree, jpart, ttree, port_partition(ttree, seqs), seqs


def port_partition(tree, seqs):
    """``_partition_for`` in the port, on the CPU."""
    part = tpll.Partition(TIPS, TIPS - 2, 4, SITES, 1, 2 * TIPS - 3, CATS,
                          TIPS - 2, device="cpu")
    order = {n.label: n.clv_index for n in tut.query_tipnodes(tree)}
    for lab, s in seqs.items():
        part.set_tip_states(order[lab], tpll.maps.pll_map_nt, s)
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, PARAMS)
    part.set_category_rates(tpll.compute_gamma_cats(ALPHA, CATS))
    return part


def port_full_logl(tree, part):
    ops, blens, midx = tut.create_operations(tut.traverse(tree.root))
    part.update_prob_matrices(PIDX, midx, blens)
    part.update_partials(ops)
    r = tree.root
    return part.compute_edge_loglikelihood(
        r.clv_index, r.scaler_index, r.back.clv_index, r.back.scaler_index,
        r.pmatrix_index, PIDX)


def lengths(tree):
    return {m.pmatrix_index: m.length for n in tree.nodes
            for m in ([n] if n.is_tip else n.ring())}


def assert_lengths(got, want, rel=LEN_REL):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= rel * abs(want[k]), (k, got[k],
                                                            want[k])


@partial(jax.jit, static_argnames=("abs_d2",))
def jax_loop(st, t0, args, abs_d2):
    """Newton with either step (d1/d2, or blopt's d1/|d2|) as a JAX
    while_loop over libpll_tpu's derivatives: (t*, bodies)."""
    from libpll_tpu.ops import derivatives as jd

    def cond(c):
        return (jnp.abs(c[1]) > 1e-9) & (c[2] < 32)

    def body(c):
        t, _, it = c
        d1, d2 = jd.likelihood_derivatives(st, t, *args, sites=SITES,
                                           asc_mode=0)
        step = jnp.where(d2 != 0.0, d1 / (jnp.abs(d2) if abs_d2 else d2),
                         d1)
        return (jnp.clip(t - step, 1e-8, 100.0), d1, it + 1)

    t, _, it = jax.lax.while_loop(
        cond, body, (jnp.asarray(t0, jnp.float64),
                     jnp.asarray(jnp.inf, jnp.float64), 0))
    return t, it


@pytest.mark.parametrize("abs_d2", [True, False])
def test_newton_rule(abs_d2):
    """``newton_solve_plain`` on JAX's sumtable of every inner edge, from
    the edge's length and from lengths far from the optimum (where d2 <= 0
    and the two rules part): blopt's rule against ``blopt._newton_edge``
    and a JAX loop, the default rule against a JAX loop (d1/d2), t* rel
    1e-12 and the same bodies."""
    jtree, jpart, _, _, _ = port_pair(3, 2.5)
    _full_logl(jtree, jpart)
    jinc.mark_valid(jut.traverse(jtree.root))
    zeros = jnp.zeros((jpart.sites_alloc,), jnp.int32)
    jargs = (jnp.asarray(jpart.rates), jpart._pinv_pc(PIDX),
             jnp.asarray(jpart.eigenvals[np.zeros(CATS, np.int64)]),
             jpart._freqs_pc(PIDX), jnp.asarray(jpart.rate_weights),
             jpart._invariant_arr(), jpart._pattern_weights_arr(), zeros,
             zeros)
    targs = [torch.from_numpy(np.array(a)) for a in jargs[:7]]
    parted = 0
    for u in tblopt._edges(jtree.root):
        if u.is_tip:
            continue
        pops = jinc.create_partial_operations(jinc.partial_traverse(u))
        if pops:
            jpart.update_partials(pops)
        st = jpart.update_sumtable(u.clv_index, u.back.clv_index,
                                   u.scaler_index, u.back.scaler_index, PIDX)
        tst = torch.from_numpy(np.array(st))
        for t0 in (u.length, 1e-4, 3.0, 20.0):
            want, bodies = (float(v) for v in jax_loop(st, t0, jargs,
                                                       abs_d2=abs_d2))
            got = dv.newton_solve_plain(
                tst, torch.tensor([t0], dtype=torch.float64), *targs,
                sites=SITES, abs_d2=abs_d2)
            assert abs(float(got.t) - want) <= T_REL * abs(want), (t0, want)
            assert int(got.iterations) == bodies
            if abs_d2:
                ref = float(jblopt._newton_edge(
                    st, t0, *jargs, sites=SITES, per_rate=False))
                assert ref == want
                parted += float(jax_loop(st, t0, jargs,
                                         abs_d2=False)[0]) != want
    if abs_d2:
        assert parted > 0  # the rules part somewhere on these inputs


def test_host_loop_matches_jax():
    """``optimize_branch_lengths`` (seed 3, max_sweeps=4) against JAX."""
    jtree, jpart, ttree, tpart, seqs = port_pair(3, 2.5)
    l0 = port_full_logl(ttree, tpart)
    want, want_sweeps = jblopt.optimize_branch_lengths(jtree, jpart, PIDX,
                                                       max_sweeps=4)
    got, sweeps = tblopt.optimize_branch_lengths(ttree, tpart, PIDX,
                                                 max_sweeps=4)
    assert got > l0 + 1.0
    assert abs(got - want) <= LOGL_REL * abs(want), (got, want)
    assert sweeps == want_sweeps
    assert_lengths(lengths(ttree), lengths(jtree))
    tree_chk = tut.parse_newick_string(tut.export_newick(ttree.root))
    fresh = port_full_logl(tree_chk, port_partition(tree_chk, seqs))
    np.testing.assert_allclose(got, fresh, atol=1e-7)


def test_sweep_program_matches_jax():
    """``make_sweep_program`` against JAX's on the same inputs (JAX's
    buffers after a full evaluation, one sweep's tables from the port's
    ``sweep_tables`` on JAX's tree, whose nodes the port's host layer
    walks as its own): the buffers,
    t_out and logL rel 1e-12, scalers equal; and ``partition_model``
    against JAX's ``_model_from_partition``."""
    jtree, jpart, _, tpart, _ = port_pair(5, 2.2)
    _full_logl(jtree, jpart)
    jinc.mark_valid(jut.traverse(jtree.root))
    tab, er, t0, _ = tblopt.sweep_tables(jtree.root, jpart.scale_buffers)
    cap = tab.shape[1]
    jmodel = j_model(jpart, PIDX)
    tmodel = partition_model(tpart, PIDX)
    assert tmodel.keys() == jmodel.keys()
    for k, v in jmodel.items():
        got = tmodel[k].numpy()
        assert got.dtype == np.asarray(v).dtype, k
        np.testing.assert_allclose(got, np.asarray(v), rtol=F64_REL, atol=0,
                                   err_msg=k)

    want = jblopt.make_sweep_program(jpart.nodes, jpart.scale_buffers, cap,
                                     sites=SITES, scale_mode=jpart.scale_mode)(
        jpart.clv, jpart.scalers, jpart.pmatrix, jmodel, jnp.asarray(tab),
        jnp.asarray(er), jnp.asarray(t0))
    bufs = [torch.from_numpy(np.array(a)) for a in (jpart.clv, jpart.scalers,
                                                    jpart.pmatrix)]
    tmodel = {k: torch.from_numpy(np.array(v)) for k, v in jmodel.items()}
    got = tblopt.make_sweep_program(tpart.nodes, tpart.scale_buffers, cap,
                                    sites=SITES,
                                    scale_mode=tpart.scale_mode)(
        *bufs, tmodel, torch.from_numpy(tab), torch.from_numpy(er),
        torch.from_numpy(t0))
    for name, g, w in zip(("clv", "scalers", "pmatrix", "ts", "logls"),
                          got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, name
        if name == "scalers":
            assert np.array_equal(g, w)
        else:
            span = np.abs(w).max(axis=-1, keepdims=True) if g.ndim > 1 \
                else np.abs(w)
            assert np.all(np.abs(g - w) <= F64_REL * span), name
    assert got[2] is bufs[2]  # in place
    assert np.any(np.asarray(want[3]) != t0)  # some edge moved


@pytest.mark.parametrize("mode", ["host", "scan"])
def test_optimisers_seed5(mode):
    """Both optimisers (seed 5, perturb 2.2, max_sweeps=4) against JAX's
    same optimiser: logL, every length, the sweep count; the scan's result
    re-derived from scratch."""
    jtree, jpart, ttree, tpart, seqs = port_pair(5, 2.2)
    name = ("optimize_branch_lengths" if mode == "host"
            else "optimize_branch_lengths_scan")
    want, want_sweeps = getattr(jblopt, name)(jtree, jpart, PIDX,
                                              max_sweeps=4)
    got, sweeps = getattr(tblopt, name)(ttree, tpart, PIDX, max_sweeps=4)
    assert abs(got - want) <= LOGL_REL * abs(want), (got, want)
    assert sweeps == want_sweeps
    assert_lengths(lengths(ttree), lengths(jtree))
    tree_chk = tut.parse_newick_string(tut.export_newick(ttree.root))
    fresh = port_full_logl(tree_chk, port_partition(tree_chk, seqs))
    np.testing.assert_allclose(got, fresh, atol=1e-6)


@pytest.mark.parametrize("edge_pad", [8, None])
def test_local_subset(edge_pad):
    """The local pass (seed 7, perturb 2.0): five edges, padded to 8 or
    not, two sweeps, against JAX's; only the subset's lengths change; a
    subset larger than ``edge_pad`` raises ``CapacityError``."""
    jtree, jpart, ttree, tpart, _ = port_pair(7, 2.0)
    before = lengths(ttree)
    subset = set(list(before)[:5])
    l0 = port_full_logl(ttree, tpart)
    want, want_sweeps = jblopt.optimize_branch_lengths_scan(
        jtree, jpart, PIDX, max_sweeps=2, edges=subset, edge_pad=edge_pad)
    got, sweeps = tblopt.optimize_branch_lengths_scan(
        ttree, tpart, PIDX, max_sweeps=2, edges=subset, edge_pad=edge_pad)
    assert got >= l0 - 1e-9
    assert abs(got - want) <= LOGL_REL * abs(want) and sweeps == want_sweeps
    after = lengths(ttree)
    assert_lengths(after, lengths(jtree))
    assert all(after[k] == before[k] for k in before if k not in subset)
    assert any(after[k] != before[k] for k in subset)
    if edge_pad is not None:
        with pytest.raises(CapacityError):
            tblopt.optimize_branch_lengths_scan(
                ttree, tpart, PIDX, max_sweeps=1,
                edges=set(list(before)[:9]), edge_pad=edge_pad)


def test_graphed_needs_the_card():
    """A CUDA graph of the sweep takes CUDA tensors only."""
    from libpll_tpu_torch.errors import EinvalError

    program = tblopt.make_sweep_program(3, 1, 8, sites=4, scale_mode=1)
    with pytest.raises(EinvalError):
        program.graphed(torch.zeros(3, 1, 4, 4), None, None, {}, None, None,
                        None)
