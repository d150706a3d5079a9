"""The port's parsimony layer against libpll_tpu's, on the same inputs made
from a seed with numpy: the glibc ``random_r`` streams and the shuffle,
informative sites and packed vectors, every Fitch step and score and the
device build's plain twin (against JAX's jitted functions), the
``FastParsimony`` and Sankoff ``Parsimony`` engines.  This is integer work
(Sankoff: float64 sums of integer costs), so every result must be equal,
not close; Fitch words, costs and scores compare as ``uint32``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libpll_tpu.io import maps as jmaps
from libpll_tpu.ops import fitch as jfitch
from libpll_tpu.ops import sankoff as jsank
from libpll_tpu.search import parsimony as jpars
from libpll_tpu.tree import utree as jut
from libpll_tpu.utils import rng as jrng

from libpll_tpu_torch import Partition
from libpll_tpu_torch.engine import evaluate as ev
from libpll_tpu_torch.errors import EinvalError, KernelError
from libpll_tpu_torch.io import maps as tmaps
from libpll_tpu_torch.ops import fitch as tfitch
from libpll_tpu_torch.ops import sankoff as tsank
from libpll_tpu_torch.search import parsimony as tpars
from libpll_tpu_torch.utils import rng as trng

from test_torch_partition import random_newick

DNA = "ACGT-RYN"
PROTEIN = "ARNDCQEGHILKMFPSTWYVX-"
U32 = np.uint32


def words(t):
    return tfitch.as_uint32(t)


def random_words(rng, shape, pad=1):
    """Random uint32 words (the high bit set about half the time), the last
    ``pad`` words of every row all ones, as packed rows end."""
    a = rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(U32)
    a[..., -pad:] = 0xFFFFFFFF
    return a


def random_costs(rng, n):
    """Costs near 2**32, so that sums wrap as JAX's uint32 sums do."""
    return (rng.integers(2 ** 32 - 3000, 2 ** 32, n, dtype=np.uint64)
            .astype(U32))


def sequences(rng, tips, sites, alphabet):
    return ["".join(rng.choice(list(alphabet), sites)) for _ in range(tips)]


# ------------------------------------------------------------------ rng
@pytest.mark.parametrize("seed", [1, 42, 12345, 2 ** 31 + 5, 0])
@pytest.mark.parametrize("state_bytes", [8, 32, 64, 128, 256])
def test_glibc_random_streams(seed, state_bytes):
    j, t = (jrng.GlibcRandom(seed, state_bytes),
            trng.GlibcRandom(seed, state_bytes))
    assert [t.next() for _ in range(500)] == [j.next() for _ in range(500)]


@pytest.mark.parametrize("seed", [0, 1, 42, 12345])
def test_shuffled_order(seed):
    for n in (1, 2, 3, 8, 100, 2048):
        assert trng.shuffled_order(n, seed) == jrng.shuffled_order(n, seed)


# ------------------------------------------------------------------ packing
@pytest.mark.parametrize("states, alphabet", [(4, DNA), (20, PROTEIN)])
@pytest.mark.parametrize("weighted", [False, True])
def test_informative_and_packed_vectors(states, alphabet, weighted):
    rng = np.random.default_rng(3 + states + weighted)
    charmap = jmaps.pll_map_nt if states == 4 else jmaps.pll_map_aa
    for tips, sites in ((5, 7), (12, 333), (30, 1000)):
        masks = np.stack([tmaps.encode_sequence(s, charmap)
                          for s in sequences(rng, tips, sites, alphabet)])
        weights = (rng.integers(1, 5, sites) if weighted
                   else np.ones(sites, np.int64))
        inf_j, const_j = jfitch.set_informative(masks, states, weights)
        inf_t, const_t = tfitch.set_informative(masks, states, weights)
        assert np.array_equal(inf_t, inf_j) and const_t == const_j
        want = jfitch.pack_vectors(masks, states, inf_j, weights, tips - 1)
        got = tfitch.pack_vectors(masks, states, inf_t, weights, tips - 1)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(words(tfitch.to_words(got, "cpu")), want)


def test_ring_co_tables():
    for n in (3, 4, 17, 200):
        for got, want in zip(tfitch._ring_co_tables(n),
                             jfitch._ring_co_tables(n)):
            assert np.array_equal(got, want)


# -------------------------------------------------------------- Fitch steps
@pytest.mark.parametrize("states, w", [(4, 8), (20, 16), (5, 8)])
def test_popcount_and_fitch_update(states, w):
    rng = np.random.default_rng(states * w)
    x = random_words(rng, (64, w))
    assert np.array_equal(
        tfitch.popcount(tfitch.to_words(x, "cpu")).numpy(),
        np.asarray(jax.lax.population_count(jnp.asarray(x))))
    n = 40
    vec, cost = random_words(rng, (n, states, w)), random_costs(rng, n)
    parent = np.array([30, 31, 32, 33, 34], np.int32)
    # no op reads another's parent: on such a wave JAX's XLA result was
    # seen to depend on the process (the port's P1 refuses one)
    c1 = np.array([0, 2, 4, 6, 9], np.int32)
    c2 = np.array([1, 3, 5, 7, 8], np.int32)
    jv, jc = jfitch.fitch_update(jnp.asarray(vec), jnp.asarray(cost),
                                 jnp.asarray(parent), jnp.asarray(c1),
                                 jnp.asarray(c2))
    tv, tc = tfitch.to_words(vec, "cpu"), tfitch.to_words(cost, "cpu")
    tfitch.fitch_update_plain(tv, tc, torch.as_tensor(parent).long(),
                              torch.as_tensor(c1).long(),
                              torch.as_tensor(c2).long())
    assert np.array_equal(words(tv), np.asarray(jv))
    assert np.array_equal(words(tc), np.asarray(jc))


@pytest.mark.parametrize("states", [4, 20])
def test_fitch_waves_match_run_waves(states):
    """P1's wrapper on CPU tensors against JAX's ``fitch_run_waves`` on the
    same waves padded by repeated ops, as JAX pads them."""
    rng = np.random.default_rng(11 + states)
    n, w = 50, 24
    vec, cost = random_words(rng, (n, states, w)), random_costs(rng, n)
    waves = [[(20, 0, 1), (21, 2, 3), (22, 4, 5)], [(23, 20, 21)],
             [(24, 23, 22), (25, 6, 7)], [(26, 24, 25), (27, 8, 9),
                                          (28, 10, 11), (29, 12, 13)]]
    width = max(len(wv) for wv in waves)
    table = np.asarray([wv + [wv[-1]] * (width - len(wv)) for wv in waves],
                       np.int32)
    jv, jc = jfitch.fitch_run_waves(jnp.asarray(vec), jnp.asarray(cost),
                                    jnp.asarray(table))
    tv, tc = tfitch.to_words(vec, "cpu"), tfitch.to_words(cost, "cpu")
    before = tfitch.fitch_waves.launches
    tfitch.fitch_waves(tv, tc, waves)
    assert tfitch.fitch_waves.launches == before  # plain on the CPU
    assert np.array_equal(words(tv), np.asarray(jv))
    assert np.array_equal(words(tc), np.asarray(jc))


def test_fitch_waves_refuse_hazards():
    vec = torch.zeros((10, 4, 8), dtype=torch.int32)
    cost = torch.zeros(10, dtype=torch.int32)
    for waves in ([[(5, 0, 1), (6, 5, 2)]], [[(5, 0, 1), (5, 2, 3)]],
                  [[(5, 0, 10)]], [[(-1, 0, 1)]]):
        with pytest.raises(EinvalError):
            tfitch.fitch_waves(vec, cost, waves)


@pytest.mark.parametrize("states", [4, 20])
def test_edge_and_insert_scores(states):
    rng = np.random.default_rng(5 * states)
    n, w, e = 60, 16, 37
    vec, cost = random_words(rng, (n, states, w)), random_costs(rng, n)
    n1 = rng.integers(0, n, e).astype(np.int32)
    n2 = rng.integers(0, n, e).astype(np.int32)
    jv, jc = jnp.asarray(vec), jnp.asarray(cost)
    tv, tc = tfitch.to_words(vec, "cpu"), tfitch.to_words(cost, "cpu")
    got = words(tfitch.fitch_scores(tv, tc, n1, n2))
    assert np.array_equal(got, np.asarray(jfitch.fitch_edge_scores_batch(
        jv, jc, jnp.asarray(n1), jnp.asarray(n2))))
    assert int(got[3]) == int(jfitch.fitch_edge_score(jv, jc, int(n1[3]),
                                                      int(n2[3])))
    tip = 7
    want = np.asarray(jfitch.fitch_insert_scores(
        jv, jc, jv[tip], jnp.asarray(n1), jnp.asarray(n2)))
    assert np.array_equal(words(tfitch.fitch_scores(tv, tc, n1, n2,
                                                    tip=tip)), want)
    # v = back[u] on the device's side, and a second partition added
    back = torch.as_tensor(rng.permutation(n).astype(np.int32))
    out = tfitch.fitch_scores(tv, tc, n1, back=back, tip=tip)
    v = np.asarray(back)[n1]
    want1 = np.asarray(jfitch.fitch_insert_scores(
        jv, jc, jv[tip], jnp.asarray(n1), jnp.asarray(v)))
    assert np.array_equal(words(out), want1)
    tfitch.fitch_scores(tv, tc, n1, n2, tip=tip, out=out, accumulate=True)
    assert np.array_equal(words(out), want1 + want)  # uint32 wraps


def _jax_build(parts_np, order):
    """JAX's device build on ``parts_np`` [(vectors, costs)] (D rows):
    the range body over every insertion, then the final body."""
    n = len(order)
    D, E = 4 * n - 6, 2 * n - 3
    back = np.full(D, -1, np.int32)
    for k in range(3):
        back[n + k] = order[k]
        back[order[k]] = n + k
    edge_rows = np.array([n, n + 1, n + 2] + [0] * (E - 3), np.int32)
    vecs_t = tuple(jnp.asarray(v) for v, _ in parts_np)
    costs_t = tuple(jnp.asarray(c) for _, c in parts_np)
    vecs_t, costs_t, back, edge_rows = jfitch._stepwise_insert_range(
        n, vecs_t, costs_t, jnp.asarray(back), jnp.asarray(edge_rows),
        jnp.asarray(order, jnp.int32), jnp.int32(3), jnp.int32(n))
    _, finals = jfitch._stepwise_final(n, vecs_t, costs_t, back)
    return vecs_t, costs_t, back, edge_rows, finals


@pytest.mark.parametrize("tips, seed", [(4, 1), (9, 42), (40, 12345)])
def test_stepwise_build_plain_twin(tips, seed):
    """The device build's plain twin (P2 + P3 plain, two partitions: DNA
    and protein, of different word counts) against JAX's range and final
    bodies: every direction row, cost, ``back``, ``edge_rows`` and the
    final scores."""
    rng = np.random.default_rng(seed)
    D = 4 * tips - 6
    parts_np = []
    for states, alphabet, sites in ((4, DNA, 300), (20, PROTEIN, 150)):
        charmap = jmaps.pll_map_nt if states == 4 else jmaps.pll_map_aa
        masks = np.stack([tmaps.encode_sequence(s, charmap)
                          for s in sequences(rng, tips, sites, alphabet)])
        weights = rng.integers(1, 4, sites)
        inf, _ = tfitch.set_informative(masks, states, weights)
        packed = tfitch.pack_vectors(masks, states, inf, weights, 0)
        vec = np.zeros((D,) + packed.shape[1:], U32)
        vec[:tips] = packed
        parts_np.append((vec, np.zeros(D, U32)))
    order = trng.shuffled_order(tips, seed)
    jv, jc, jback, jedges, jfinals = _jax_build(parts_np, order)
    parts = [(tfitch.to_words(v, "cpu"), tfitch.to_words(c, "cpu"))
             for v, c in parts_np]
    back, edge_rows, finals = tfitch.stepwise_build(parts, order)
    assert np.array_equal(back.numpy(), np.asarray(jback))
    assert np.array_equal(edge_rows.numpy(), np.asarray(jedges))
    assert np.array_equal(words(finals),
                          np.asarray([int(f) for f in jfinals], U32))
    for (tv, tc), v, c in zip(parts, jv, jc):
        assert np.array_equal(words(tv), np.asarray(v))
        assert np.array_equal(words(tc), np.asarray(c))


def _sliced_build(parts, order, grid):
    """The device build with P3 as its slice plan's plain walk
    (``stepwise_commit_sliced_plain`` at ``grid`` blocks) and P2's plain
    scores summed over the partitions."""
    n = len(order)
    topo = tfitch.stepwise_topology(order, "cpu")
    back, edge_rows = topo[0], topo[1]
    scores = torch.empty(2 * n - 3, dtype=torch.int32)
    tfitch.stepwise_commit_sliced_plain(parts, *topo, grid=grid,
                                        mode="star")
    for i in range(3, n):
        ne = 2 * i - 3
        for k, (vecs, costs) in enumerate(parts):
            tfitch.fitch_scores(vecs, costs, edge_rows[:ne], back=back,
                                tip=order[i], out=scores[:ne],
                                accumulate=k > 0)
        tfitch.stepwise_commit_sliced_plain(
            parts, *topo, grid=grid, mode="insert", scores=scores,
            insertion=i, tip=order[i])
    return back, edge_rows, tfitch.stepwise_commit_sliced_plain(
        parts, *topo, grid=grid, mode="final")


@pytest.mark.parametrize("n_parts", [1, 2])
@pytest.mark.parametrize("grid", [1, 2, 3, 5, 24])
def test_commit_slice_plan_walk(grid, n_parts):
    """P3's slice plan walked with the plain version (one
    ``stepwise_commit_plain`` per word slice, the slices' costs summed,
    slice 0 carrying the rows' own costs) equals the unsliced plain build
    and JAX's device build: every direction row, cost, ``back``,
    ``edge_rows`` and the final scores.  One or two partitions (DNA of 16
    words and protein of 8), from one block to more blocks than either
    has words (empty slices); tip costs near 2**32 so that the slices'
    sums wrap."""
    tips, seed = 14, 7 + grid
    rng = np.random.default_rng(seed)
    D = 4 * tips - 6
    parts_np = []
    for states, alphabet, sites in ((4, DNA, 500), (20, PROTEIN, 200)
                                    )[:n_parts]:
        charmap = jmaps.pll_map_nt if states == 4 else jmaps.pll_map_aa
        masks = np.stack([tmaps.encode_sequence(s, charmap)
                          for s in sequences(rng, tips, sites, alphabet)])
        weights = rng.integers(1, 4, sites)
        inf, _ = tfitch.set_informative(masks, states, weights)
        packed = tfitch.pack_vectors(masks, states, inf, weights, 0)
        vec = np.zeros((D,) + packed.shape[1:], U32)
        vec[:tips] = packed
        cost = np.zeros(D, U32)
        cost[:tips] = random_costs(rng, tips)
        parts_np.append((vec, cost))
    order = trng.shuffled_order(tips, seed)
    jv, jc, jback, jedges, jfinals = _jax_build(parts_np, order)
    plain = [(tfitch.to_words(v, "cpu"), tfitch.to_words(c, "cpu"))
             for v, c in parts_np]
    sliced = [(v.clone(), c.clone()) for v, c in plain]
    want = tfitch.stepwise_build(plain, order)
    got = _sliced_build(sliced, order, grid)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert np.array_equal(got[0].numpy(), np.asarray(jback))
    assert np.array_equal(got[1].numpy(), np.asarray(jedges))
    assert np.array_equal(words(got[2]),
                          np.asarray([int(f) for f in jfinals], U32))
    for (sv, sc), (pv, pc), v, c in zip(sliced, plain, jv, jc):
        assert torch.equal(sv, pv) and torch.equal(sc, pc)
        assert np.array_equal(words(sv), np.asarray(v))
        assert np.array_equal(words(sc), np.asarray(c))


def test_commit_plan():
    """P3's launch plan: a block per 32 words of the widest partition (one
    below 64 words, at most one per SM), the word slices contiguous and
    whole, the walk's tables in shared memory up to the limit and in
    device memory past it (always at a limit of 0)."""
    limit = 232448 - 5 * 1024
    plan = tfitch.commit_plan([512], 1024, 132, limit)
    assert plan == tfitch.CommitPlan(16, True, 4 * 5 * 4090)
    assert tfitch.commit_plan([64, 8], 2048, 132, limit)[:2] == (2, True)
    assert tfitch.commit_plan([63], 100, 132, limit).grid == 1
    assert tfitch.commit_plan([8], 10, 132, limit).grid == 1
    assert tfitch.commit_plan([32 * 500], 100, 132, limit).grid == 132
    past = tfitch.commit_plan([512], 3000, 132, limit)
    assert not past.shared and past.smem == 0 and 20 * (4 * 3000 - 6) > limit
    assert tfitch.commit_plan([512], 100, 132, 0) == (16, False, 0)
    for w, g in ((16, 5), (8, 24), (512, 16), (7, 3)):
        cuts = tfitch.word_slices(w, g)
        assert len(cuts) == g and cuts[0][0] == 0 and cuts[-1][1] == w
        assert all(a[1] == b[0] and a[0] <= a[1]
                   for a, b in zip(cuts, cuts[1:]))


def _host_engine_calls(parts, labels, seed):
    """Every ``fitch_waves`` call of the host engine's build on the CPU:
    (the rows and costs before it, its waves), per partition."""
    from libpll_tpu_torch.search import stepwise as tstep

    calls, real = [], tfitch.fitch_waves

    def record(vectors, costs, waves):
        calls.append((vectors.clone(), costs.clone(), waves))
        return real(vectors, costs, waves)

    tfitch.fitch_waves = record
    try:
        tstep.StepwiseBuilder(parts, labels).build(seed)
    finally:
        tfitch.fitch_waves = real
    return calls


def _padded_waves(waves, n_waves, width):
    """Waves as JAX's int32 [n_waves, width, 3] table: each wave padded by
    its last op, the table by its last wave (both idempotent)."""
    rows = [w + [w[-1]] * (width - len(w)) for w in waves]
    rows += [rows[-1]] * (n_waves - len(rows))
    return np.asarray(rows, np.int32)


@pytest.mark.parametrize("states, alphabet, sites", [(4, DNA, 600),
                                                     (20, PROTEIN, 320)])
def test_wave_slices_match_run_waves(states, alphabet, sites):
    """P1's slice plan walked with its plain version
    (``fitch_run_waves_sliced_plain``: each slice every wave over its own
    words, the costs from the slices' shares wave by wave) on the host
    engine's waves of a 24-taxon build, bit for bit against JAX's
    ``fitch_run_waves`` and the unsliced plain version, at one block, two,
    three (word counts that are not multiples of the slice) and more
    blocks than words; tip costs near 2**32 so that the shares' sums
    wrap."""
    tips, seed = 24, 3 + states
    rng = np.random.default_rng(seed)
    charmap = jmaps.pll_map_nt if states == 4 else jmaps.pll_map_aa
    part = tpars.FastParsimony.from_sequences(
        sequences(rng, tips, sites, alphabet), charmap, states,
        rng.integers(1, 4, sites), device="cpu")
    part.costs[:tips] = tfitch.to_words(random_costs(rng, tips), "cpu")
    calls = _host_engine_calls([part], [f"t{i}" for i in range(tips)],
                               seed)
    # one call an insertion, the star's and the final tree's
    assert len(calls) == tips - 1
    w = part.vectors.shape[-1]
    assert w % tfitch.SLICE_WORDS  # no whole number of slices
    n_waves = max(len(waves) for *_, waves in calls)
    width = max(len(wave) for *_, waves in calls for wave in waves)
    for vec, cost, waves in calls:
        jv, jc = jfitch.fitch_run_waves(
            jnp.asarray(words(vec)), jnp.asarray(words(cost)),
            jnp.asarray(_padded_waves(waves, n_waves, width)))
        table, offsets = tfitch.wave_table(waves, vec.shape[0])
        table = torch.from_numpy(table)
        for grid in (1, 2, 3, w + 3):
            v, c = vec.clone(), cost.clone()
            tfitch.fitch_run_waves_sliced_plain(v, c, table, offsets, grid)
            assert np.array_equal(words(v), np.asarray(jv))
            assert np.array_equal(words(c), np.asarray(jc))
        v, c = vec.clone(), cost.clone()
        tfitch.fitch_run_waves_plain(v, c, table, offsets)
        assert np.array_equal(words(c), np.asarray(jc))


@pytest.mark.parametrize("words_, sms, grid", [
    (8, 132, 1), (63, 132, 1), (64, 132, 2), (72, 132, 2), (512, 132, 16),
    (32 * 500, 132, 132), (2048, 7, 7)])
def test_wave_plan(words_, sms, grid):
    """P1's blocks: one per SLICE_WORDS words (one below 2 * SLICE_WORDS),
    at most one per SM, as P3's plan splits them; the slices whole,
    contiguous and at least a slice wide."""
    assert tfitch.wave_plan(words_, sms) == grid
    assert grid == tfitch.commit_plan([words_], 10, sms, 0).grid
    cuts = tfitch.word_slices(words_, grid)
    assert cuts[0][0] == 0 and cuts[-1][1] == words_
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert grid == 1 or min(hi - lo for lo, hi in cuts) >= tfitch.SLICE_WORDS
    # the table, its offsets and the totals staged where they fit
    n_ops, n_waves = 2046, 295
    need = 4 * (4 * n_ops + n_waves + 1)
    assert tfitch.wave_smem(n_ops, n_waves, need) == need
    assert tfitch.wave_smem(n_ops, n_waves, need - 1) == 0


# ----------------------------------------------------------- FastParsimony
@pytest.mark.parametrize("states, alphabet", [(4, DNA), (20, PROTEIN)])
@pytest.mark.parametrize("weighted", [False, True])
def test_fast_parsimony(states, alphabet, weighted):
    rng = np.random.default_rng(7 + states + weighted)
    tips, sites = 12, 211
    charmap = jmaps.pll_map_nt if states == 4 else jmaps.pll_map_aa
    seqs = sequences(rng, tips, sites, alphabet)
    weights = rng.integers(1, 4, sites) if weighted else None
    jp = jpars.FastParsimony.from_sequences(seqs, charmap, states, weights)
    tp = tpars.FastParsimony.from_sequences(seqs, charmap, states, weights,
                                            device="cpu")
    assert tp.device == torch.device("cpu")
    assert (tp.const_cost, tp.informative_count, tp.inner_nodes) == (
        jp.const_cost, jp.informative_count, jp.inner_nodes)
    assert np.array_equal(words(tp.vectors), np.asarray(jp.vectors))
    tree = jut.parse_newick_string(random_newick(tips, rng))
    ops = jut.create_pars_buildops(jut.traverse(tree.root))
    jp.update_vectors(ops)
    tp.update_vectors(ops)
    assert np.array_equal(words(tp.vectors), np.asarray(jp.vectors))
    assert np.array_equal(words(tp.costs), np.asarray(jp.costs))
    root = tree.root
    assert (tp.edge_score(root.clv_index, root.back.clv_index)
            == jp.edge_score(root.clv_index, root.back.clv_index))
    inner = range(tips, 2 * tips - 2)
    for k in inner:
        assert tp.root_score(k) == jp.root_score(k)
    n1 = rng.integers(0, 2 * tips - 2, 25)
    n2 = rng.integers(0, 2 * tips - 2, 25)
    got, want = tp.edge_scores_batch(n1, n2), jp.edge_scores_batch(n1, n2)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_fast_parsimony_from_partition():
    rng = np.random.default_rng(19)
    tips, sites = 9, 120
    seqs = sequences(rng, tips, sites, DNA)
    weights = rng.integers(1, 5, sites)
    part = Partition(tips, tips - 2, 4, sites, 1, 2 * tips - 3, 4, tips - 2,
                     device="cpu")
    for i, s in enumerate(seqs):
        part.set_tip_states(i, tmaps.pll_map_nt, s)
    part.set_pattern_weights(weights)
    tp = tpars.FastParsimony.from_partition(part, device="cpu")
    jp = jpars.FastParsimony.from_sequences(seqs, jmaps.pll_map_nt, 4,
                                            weights)
    assert tp.const_cost == jp.const_cost
    assert np.array_equal(words(tp.vectors), np.asarray(jp.vectors))


# ------------------------------------------------------------------ Sankoff
@pytest.mark.parametrize("states, alphabet", [(4, "ACGT-RWS"), (20, PROTEIN)])
def test_sankoff(states, alphabet):
    """A random integer score matrix: buffers, scores and the ancestral
    reconstruction equal JAX's."""
    rng = np.random.default_rng(23 + states)
    tips, sites = 10, 77
    charmap = jmaps.pll_map_nt if states == 4 else jmaps.pll_map_aa
    seqs = sequences(rng, tips, sites, alphabet)
    sm = rng.integers(1, 6, (states, states)).astype(np.float64)
    sm = (sm + sm.T) / 2
    np.fill_diagonal(sm, 0)
    jp = jpars.Parsimony(tips, states, sites, sm, tips - 1, tips - 1)
    tp = tpars.Parsimony(tips, states, sites, sm, tips - 1, tips - 1,
                         device="cpu")
    for i, s in enumerate(seqs):
        jp.set_sequence(i, charmap, s)
        tp.set_sequence(i, charmap, s)
    # a random rooted tree: pairs of subtrees joined until one is left
    ops, avail = [], list(range(tips))
    while len(avail) > 1:
        a, b = (avail.pop(int(rng.integers(len(avail)))) for _ in range(2))
        ops.append((tips + len(ops), a, b))
        avail.append(ops[-1][0])
    assert tp.build(ops) == jp.build(ops)
    assert tp.sbuffer.dtype == torch.float64
    assert np.array_equal(tp.sbuffer.numpy(), np.asarray(jp.sbuffer))
    for p, _, _ in ops:
        assert tp.score(p) == jp.score(p)
    root = ops[-1][0]
    recops = [(root, root)] + [(c, p) for p, c1, c2 in reversed(ops)
                               for c in (c1, c2) if c >= tips]
    assert tp.reconstruct(charmap, recops) == jp.reconstruct(charmap,
                                                             recops)
    sb = np.asarray(jp.sbuffer)
    got = tsank.sankoff_reconstruct(sb, recops, states, charmap)
    want = jsank.sankoff_reconstruct(sb, recops, states, charmap)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_parsimony_errors_are_jax_classes():
    with pytest.raises(tpars.ParamError):
        tpars.Parsimony(4, 4, 10, np.zeros((3, 3)), 3, 3, device="cpu")
    with pytest.raises(jpars.ParamError):
        jpars.Parsimony(4, 4, 10, np.zeros((3, 3)), 3, 3)
    tp = tpars.Parsimony(4, 4, 10, np.zeros((4, 4)), 3, 3, device="cpu")
    with pytest.raises(tpars.TipDataError):
        tp.set_sequence(0, tmaps.pll_map_nt, "ACGT")
    assert tpars.TipDataError.__name__ == jpars.TipDataError.__name__


def test_entry_points_need_a_card(monkeypatch):
    """device=None builds on the card; without one, KernelError."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    masks = np.ones((4, 10), np.uint32)
    for build in (
            lambda: tpars.FastParsimony(masks, 4),
            lambda: tpars.FastParsimony.from_sequences(
                ["ACGT"] * 4, tmaps.pll_map_nt, 4),
            lambda: tpars.Parsimony(4, 4, 10, np.zeros((4, 4)), 3, 3)):
        with pytest.raises(KernelError):
            build()
    with pytest.raises(KernelError):
        ev._resolve_device(None)
