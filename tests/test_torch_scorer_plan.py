"""C1's scoring instance on the CPU: its host plan
(``ops/incremental.plan_candidates``: pool slots first fit in op order,
spill rows past the pool), its layout (``score_layout``) and the plan
walked by plain PyTorch (``plain_walk``: each candidate's ops through the
pool and spill rows, then its edge log-likelihood) against libpll_tpu's
``make_candidate_scorer`` on the same random inputs made with numpy.

The tables follow ``encode_candidate_ops``'s encoding (op k writes CLV row
N + k and, when it owns one, scaler row NS + 1 + k; pad rows repeat the
last op), the children drawn from the base rows and earlier ops' rows.

Tolerances.  The plan is integer work and is held exactly.  The logL is a
float64 sum in another order than JAX's: rel 1e-12; a NaN in one
P-matrix gives NaN in the same candidates on both sides.  The plain walk with a
pool too small (rows spill) equals the walk with the whole pool exactly:
the same operations on the same values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from libpll_tpu.ops import incremental as jinc_ops

from libpll_tpu_torch.ops import incremental as inc_ops
from libpll_tpu_torch.ops.pmatrix import compute_pmatrices

REL = 1e-12
N, NS, M, K, U = 7, 5, 9, 6, 3  # base rows, scaler rows, matrices, ops, slots


def random_model(rng, c, s):
    """A reversible model as numpy arrays: eigen factors of a random
    exchangeability matrix and frequencies, Γ-like rates, weights."""
    freqs = rng.uniform(0.2, 1.0, s)
    freqs /= freqs.sum()
    ex = rng.uniform(0.5, 3.0, (s, s))
    ex = (ex + ex.T) / 2
    q = ex * freqs[None, :]
    np.fill_diagonal(q, 0)
    np.fill_diagonal(q, -q.sum(1))
    q /= -(np.diag(q) * freqs).sum()
    sq = np.sqrt(freqs)
    w, v = np.linalg.eigh(sq[:, None] * q / sq[None, :])
    rates = np.sort(rng.uniform(0.2, 2.0, c))
    rw = rng.uniform(0.5, 1.0, c)
    return {"rates": rates, "prop_invar": np.zeros(1),
            "params_indices": np.zeros(c, np.int32), "eigenvals": w[None],
            "left": (v / sq[:, None])[None],
            "right": (v.T * sq[None, :])[None],
            "freqs_pc": np.repeat(freqs[None], c, 0),
            "rate_weights": rw / rw.sum()}


def random_case(rng, c, s, sites, scale_mode, asc, pinv, nan):
    """(clv, scalers, pmatrix, model, tables, midx, blens, eval_rows) as
    numpy: B random candidates in the scratch-row encoding."""
    length = sites + (s if asc else 0)
    clv = rng.uniform(0.05, 1.0, (N, c, s, length))
    if scale_mode:  # rows small enough that a product scales in float64
        clv[rng.uniform(size=N) < 0.5] *= 1e-60
    if asc:
        clv[..., sites:] *= 0.01
    sshape = (NS + 1, length) if scale_mode != 2 else (NS + 1, c, length)
    scalers = rng.integers(0, 3, sshape).astype(np.int32)
    scalers[NS] = 0  # the dummy row
    if not scale_mode:  # no scaling: no counters (JAX would still add them)
        scalers[:] = 0
    pmatrix = rng.uniform(0.05, 1.0, (M, c, s, s)) / s
    if nan:  # one matrix: the candidates that use it score NaN
        pmatrix[M - 1, 0, 1, :] = np.nan
    model = random_model(rng, c, s)
    model["prop_invar_pc"] = np.full(c, pinv)
    model["pattern_weights"] = rng.integers(1, 4, length).astype(float)
    model["invariant"] = np.where(rng.uniform(size=length) < 0.4,
                                  rng.integers(0, s, length), -1
                                  ).astype(np.int32)
    B = 6
    tables = np.zeros((B, K, 8), np.int32)
    evals = np.zeros((B, 5), np.int32)
    for b in range(B):
        n_ops = int(rng.integers(1, K + 1))
        owns = rng.uniform(size=n_ops) < 0.8
        ops = []
        for k in range(n_ops):
            row = []
            for _ in range(2):
                j = int(rng.integers(-N, k)) if k else -1
                if j >= 0:  # an earlier op's row
                    row.append((N + j, NS + 1 + j if owns[j] else NS))
                else:
                    base = int(rng.integers(0, N))
                    row.append((base, int(rng.integers(0, NS + 1))))
            (c1, s1), (c2, s2) = row
            ops.append((N + k, NS + 1 + k if owns[k] else NS, c1,
                        int(rng.integers(0, M)), s1, c2,
                        int(rng.integers(0, M)), s2))
        tables[b] = inc_ops.pad_op_table(np.asarray(ops, np.int32), K)
        last = n_ops - 1
        other = int(rng.integers(-N, last)) if last else -1
        evals[b] = (N + last, NS + 1 + last if owns[last] else NS,
                    N + other if other >= 0 else int(rng.integers(0, N)),
                    (NS + 1 + other if owns[other] else NS) if other >= 0
                    else int(rng.integers(0, NS + 1)),
                    int(rng.integers(0, M)))
    midx = rng.integers(0, M, (B, U)).astype(np.int32)
    midx[0, 2] = midx[0, 0]  # a repeated slot: the last wins
    evals[1, 4] = midx[1, 1]  # an edge matrix that is an overlay slot
    blens = rng.uniform(0.01, 0.5, (B, U))
    return clv, scalers, pmatrix, model, tables, midx, blens, evals


CASES = [  # (C, S, scale mode, asc, p-inv, NaN)
    (4, 4, 1, 0, 0.0, False), (4, 4, 2, 0, 0.0, False),
    (4, 4, 0, 0, 0.0, False), (4, 4, 1, 0, 0.25, False),
    (4, 4, 1, 1, 0.0, False), (4, 4, 2, 2, 0.0, False),
    (1, 4, 1, 3, 0.2, False), (1, 20, 1, 0, 0.0, False),
    (4, 20, 2, 1, 0.0, False), (4, 2, 1, 0, 0.3, False),
    (1, 2, 2, 3, 0.0, False), (4, 4, 1, 0, 0.0, True),
    (4, 4, 2, 0, 0.0, True)]


@pytest.mark.parametrize("c, s, mode, asc, pinv, nan", CASES)
def test_plan_walk_matches_jax(c, s, mode, asc, pinv, nan):
    """The plan walked by plain PyTorch (the whole pool, then one slot and
    none, so that rows spill) against JAX's ``make_candidate_scorer`` on
    the same candidates: every scale mode, +I, each asc mode, S 4/20/2, C
    1/4, a NaN in one P-matrix; float64 rel 1e-12."""
    rng = np.random.default_rng(100 * c + 10 * s + mode + 3 * asc)
    sites = 37
    clv, scalers, pm, model, tables, midx, blens, evals = random_case(
        rng, c, s, sites, mode, asc, pinv, nan)
    score = jinc_ops.make_candidate_scorer(N, NS, K, sites=sites,
                                           scale_mode=mode, asc_mode=asc)
    jmodel = {k: jnp.asarray(v) for k, v in model.items()}
    want = np.asarray(score(jnp.asarray(clv), jnp.asarray(scalers),
                            jnp.asarray(pm), jmodel, jnp.asarray(tables),
                            jnp.asarray(midx), jnp.asarray(blens),
                            jnp.asarray(evals)))
    tmodel = {k: torch.from_numpy(np.asarray(v)) for k, v in model.items()}
    new = compute_pmatrices(
        torch.from_numpy(blens).reshape(-1), tmodel["rates"],
        tmodel["prop_invar"], tmodel["params_indices"], tmodel["eigenvals"],
        tmodel["left"], tmodel["right"], dtype=torch.float64).reshape(
            (len(tables), U, c, s, s))
    base = [torch.from_numpy(a) for a in (clv, scalers, pm)]
    kw = dict(sites=sites, scale_mode=mode, asc_mode=asc)
    plan = inc_ops.plan_candidates(tables, midx, evals, n_nodes=N,
                                   n_scale_buffers=NS, scale_mode=mode)
    got = inc_ops.plain_walk(plan, *base, new, tmodel, **kw).numpy()
    assert np.isnan(got).any() == nan and np.isfinite(want).any()
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=REL, atol=0)
    for pool in (1, 0):
        small = inc_ops.plan_candidates(tables, midx, evals, n_nodes=N,
                                        n_scale_buffers=NS, scale_mode=mode,
                                        pool=pool)
        assert (small.spills > 0) == (pool < plan.slots)
        again = inc_ops.plain_walk(small, *base, new, tmodel, **kw).numpy()
        np.testing.assert_array_equal(again, got)
    # the plain scorer (C1's plain version) on the same inputs
    rows = int(tables[..., 0].max()) - N + 1
    plain = inc_ops.score_candidates_plain(
        *base, tmodel, tables, midx, evals, new, n_scale_buffers=NS,
        rows=rows, **kw).numpy()
    np.testing.assert_allclose(plain, got, rtol=REL, atol=0)


def _versions(tables, n_nodes, n_scalers, scaling):
    """For each candidate, per op k the writer (an op index, or -1 for
    the base) of each row it reads (CLV children, then scalers), and of
    the edge's rows, by a plain walk of the raw table with U1's rule for
    repeats."""
    out = []
    for t in np.asarray(tables).tolist():
        writer_c, writer_s, reads, prev = {}, {}, [], None
        for k, op in enumerate(t):
            p, ps, c1, _, s1, c2, _, s2 = op
            scaled = scaling and ps != n_scalers
            if prev is not None and inc_ops._repeats(op, prev, scaled):
                reads.append(None)
                continue
            prev = op
            reads.append(([writer_c.get(c1, -1), writer_c.get(c2, -1)],
                          [writer_s.get(s1, -1), writer_s.get(s2, -1)]))
            writer_c[p] = k
            if scaled:
                writer_s[ps] = k
        out.append((reads, writer_c, writer_s))
    return out


@pytest.mark.parametrize("pool", [None, 2, 1, 0])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plan_invariants(pool, mode):
    """No pool slot is written while a row it holds is still to be read;
    every read of a row an op wrote finds a slot or a spill row holding
    that op's version (CLV and scaler); ops that nothing reads do not run;
    spills are counted and occur only when the pool is short."""
    rng = np.random.default_rng(7 + mode)
    mask = (1 << inc_ops.SRC_BITS) - 1
    for trial in range(4):
        *_, tables, midx, _, evals = random_case(rng, 2, 4, 11, mode, 0,
                                                 0.0, False)
        plan = inc_ops.plan_candidates(tables, midx, evals, n_nodes=N,
                                       n_scale_buffers=NS, scale_mode=mode,
                                       pool=pool)
        full = inc_ops.plan_candidates(tables, midx, evals, n_nodes=N,
                                       n_scale_buffers=NS, scale_mode=mode)
        assert full.spills == 0 and full.rows == 0
        assert (plan.spills == 0) == (pool is None or pool >= full.slots)
        assert plan.slots <= (full.slots if pool is None else pool)
        spills = 0
        for b, (reads, wc, ws) in enumerate(_versions(
                tables, N, NS, mode != 0)):
            holder = {}  # (kind, index) -> the op whose row it holds
            ops = plan.ops[b]

            def check(desc, want):
                kind, i = int(desc) >> inc_ops.SRC_BITS, int(desc) & mask
                if want < 0:
                    assert kind == inc_ops.SRC_BASE
                else:
                    assert kind in (inc_ops.SRC_POOL, inc_ops.SRC_SPILL)
                    assert holder[kind, i] == want

            for k in range(ops.shape[0]):
                if ops[k, 0] < 0:
                    continue
                got_reads = reads[k]
                assert got_reads is not None  # repeats never run
                check(ops[k, 2], got_reads[0][0])
                check(ops[k, 5], got_reads[0][1])
                if ops[k, 1] >= 0:
                    check(ops[k, 4], got_reads[1][0])
                    check(ops[k, 7], got_reads[1][1])
                for col in (0, 1):
                    if ops[k, col] >= 0:
                        d = int(ops[k, col])
                        holder[d >> inc_ops.SRC_BITS, d & mask] = k
                spills += int(ops[k, 0]) >> inc_ops.SRC_BITS \
                    == inc_ops.SRC_SPILL
            pr, psr, cr, csr, _ = evals[b].tolist()
            check(plan.eval[b, 0], wc.get(int(pr), -1))
            check(plan.eval[b, 2], wc.get(int(cr), -1))
            if mode:
                check(plan.eval[b, 1], ws.get(int(psr), -1))
                check(plan.eval[b, 3], ws.get(int(csr), -1))
        assert spills == plan.spills


def test_spill_count_on_a_known_table():
    """Three rows live at once (two read by op 3, one by op 4): three
    slots at the peak; two slots spill one op, one slot two, none all
    five; an op only dead ops read does not run either."""
    ops = np.array([[N + 0, NS, 0, 0, NS, 1, 1, NS],
                    [N + 1, NS, 2, 2, NS, 3, 3, NS],
                    [N + 2, NS, 4, 4, NS, 5, 5, NS],
                    [N + 3, NS, N + 0, 6, NS, N + 1, 7, NS],
                    [N + 4, NS, N + 3, 8, NS, N + 2, 0, NS]], np.int32)
    tables = inc_ops.pad_op_table(ops, K)[None]
    evals = np.array([[N + 4, NS, 6, NS, 1]], np.int32)
    midx = np.array([[0, 1, 2]], np.int32)
    spills = {}
    for pool in (None, 3, 2, 1, 0):
        plan = inc_ops.plan_candidates(tables, midx, evals, n_nodes=N,
                                       n_scale_buffers=NS, scale_mode=1,
                                       pool=pool)
        spills[pool] = (plan.slots, plan.spills, plan.live)
    assert spills == {None: (3, 0, 5), 3: (3, 0, 5), 2: (2, 1, 5),
                      1: (1, 2, 5), 0: (0, 5, 5)}
    # an op whose row nothing reads does not run
    dead = ops.copy()
    dead[4, 2] = 0
    plan = inc_ops.plan_candidates(inc_ops.pad_op_table(dead, K)[None], midx,
                                   evals, n_nodes=N, n_scale_buffers=NS,
                                   scale_mode=1)
    assert plan.live == 2 and plan.slots == 1  # op 4 reads only op 2


def test_score_layout():
    """The tile is the largest of 128, 64, 32 sites whose slots stay under
    the soft budget; past it a tile of 32 with the slots the block holds
    (none: every row spills)."""
    limit = 232448 - 64
    assert inc_ops.score_layout(4, 4, 4, 1, 3, limit) == (128, 3,
                                                           3 * 68 * 128)
    assert inc_ops.score_layout(8, 4, 4, 2, 3, limit) == (64, 3,
                                                          3 * 144 * 64)
    assert inc_ops.score_layout(4, 4, 4, 0, 0, limit) == (128, 0, 0)
    tile, slots, smem = inc_ops.score_layout(8, 8, 64, 2, 4, limit)
    assert tile == 32 and slots == limit // (8 * 64 * 8 * 32 + 32 * 32)
    assert smem <= limit and slots < 4
    assert inc_ops.score_layout(8, 64, 64, 1, 2, limit) == (32, 0, 0)
