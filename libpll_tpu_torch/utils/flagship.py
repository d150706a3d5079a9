"""The flagship configuration, as numpy: a random binary topology, a
GTR+Γ model and tips, all made from one seed.

Counterpart: ``__graft_entry__.py:22-145`` (``_draw_tip_masks``,
``_simulate_tips``, ``_build_flagship``).  The rng is consumed in the same
order, so a seed gives the same tree, model and tips as the JAX builder;
the arrays come back as numpy (hand the model to
:func:`libpll_tpu_torch.engine.params.model_from_numpy`).  The flagship
itself is 64 taxa × 262 144 site patterns, DNA, four Γ categories,
per-site scaling.

:func:`build_protein_flagship` is the repo's 64-taxon protein
configuration (``BASELINE.md:72``: 64 taxa × 65 536 sites, four Γ
categories) under the LG4X mixture: columns simulated on the flagship's
tree, written to a FASTA file, read back, compressed to site patterns and
encoded as 20-bit masks, the path a user's alignment takes.

:func:`build_alphabet_flagship` is an S-state alignment (2 <= S <= 64:
binary characters, CellPhy's 16 diploid genotypes, 61 codons) simulated
on the flagship's tree under a GTR model with S(S-1)/2 exchangeabilities
and Γ at C rates, all drawn from the seed.

:func:`infer_alignment` is scripts/bench_infer.py's data (1 024 taxa x
16 384 sites by default): DNA simulated under GTR+Γ4 down a random
leaf-split tree, with the generating Newick.
"""

from __future__ import annotations

import numpy as np

FLAGSHIP_TIPS = 64
FLAGSHIP_SITES = 262144
FLAGSHIP_RATE_CATS = 4
FLAGSHIP_STATES = 4


def draw_tip_masks(rng, tips, sites, step=None):
    """[tips, sites] uint32 single-state ambiguity bitmasks, drawn in
    row-chunks of ``step`` to bound host staging.  Each row comes from its
    own spawned child generator, so the result does not depend on the
    chunk layout."""
    if step is None:
        step = max(1, (1 << 28) // max(sites, 1))
    masks = np.empty((tips, sites), np.uint32)
    for i in range(0, tips, step):
        j = min(tips, i + step)
        for r, child in zip(range(i, j), rng.spawn(j - i)):
            st = child.integers(0, 4, sites, dtype=np.uint8)
            masks[r] = np.uint32(1) << st.astype(np.uint32)
    return masks


def _pmat(w, left, right, t):
    """P(t) = left @ diag(expm1(w t)) @ right + I (ops/pmatrix.py), its
    rows clipped at 0 and renormalised: parent state -> child state."""
    p = (left * np.expm1(w * t)[None, :]) @ right + np.eye(len(w))
    p = np.clip(p, 0.0, None)
    return p / p.sum(1, keepdims=True)


def _evolve_down(tree, tips, root_seq, evolve):
    """[tips, sites] uint8 states: ``root_seq`` at the root's vertex,
    carried down every branch by ``evolve(seq, length)``."""
    states = np.empty((tips, root_seq.shape[0]), np.uint8)
    root = tree.root
    # stack of (node entered via its .back edge, sequence at that vertex)
    stack = [(m.back, evolve(root_seq, m.length))
             for m in (root, root.next, root.next.next)]
    while stack:
        node, seq = stack.pop()
        if node.is_tip:
            states[node.clv_index] = seq
            continue
        for m in (node.next, node.next.next):
            stack.append((m.back, evolve(seq, m.length)))
    return states


def simulate_tips(tree, tips, sites, w, left, right, freqs, rng):
    """Evolve sequences down the (unrooted) tree under the GTR process;
    returns [tips, sites] uint8 states."""
    def evolve(seq, t):
        p = _pmat(w, left, right, t)
        u = rng.random(sites)
        cdf = np.cumsum(p, axis=1)[seq]  # [sites, states]
        return (u[:, None] > cdf).sum(1).astype(np.uint8)

    root_seq = rng.choice(len(freqs), size=sites, p=freqs).astype(np.uint8)
    return _evolve_down(tree, tips, root_seq, evolve)


def simulate_mixture(tree, tips, sites, eigen, freqs, cat_rates, weights,
                     rng):
    """Evolve sequences down the tree under a mixture: each column draws a
    category k with probability ``weights[k]``, its root state from
    ``freqs[k]``, and evolves under eigensystem ``eigen[k]`` = (w, left,
    right) at rate ``cat_rates[k]``: one P-matrix per category and branch.
    Returns [tips, sites] uint8 states."""
    states = freqs.shape[1]
    cat = rng.choice(len(weights), size=sites, p=np.asarray(weights))
    cols = [np.flatnonzero(cat == k) for k in range(len(weights))]
    root_seq = np.empty(sites, np.uint8)
    for k, idx in enumerate(cols):
        root_seq[idx] = rng.choice(states, size=idx.size, p=freqs[k])

    def evolve(seq, t):
        u = rng.random(sites)
        out = np.empty_like(seq)
        for k, idx in enumerate(cols):
            cdf = np.cumsum(_pmat(*eigen[k], t * cat_rates[k]), axis=1)
            # rounding may leave a row's last cdf value below u
            out[idx] = np.minimum(
                (u[idx, None] > cdf[seq[idx]]).sum(1), states - 1)
        return out

    return _evolve_down(tree, tips, root_seq, evolve)


def _topology_and_model(tips, sites, rate_cats, dtype, rng):
    """(tree, topo, model, (w, left, right, freqs, params)) drawn from
    ``rng`` in the order of ``__graft_entry__._build_flagship``: the
    topology, then the GTR+Γ model (``params`` its six
    exchangeabilities)."""
    from ..engine.evaluate import topology_from_tree
    from ..models.gamma import compute_gamma_cats
    from ..models.gtr import eigen_decompose
    from ..tree import utree as ut
    from .constants import SCALE_PER_SITE

    # random binary topology
    items = [f"t{i}:{rng.uniform(0.05, 0.5):.4f}" for i in range(tips)]
    while len(items) > 3:
        i, j = sorted(rng.choice(len(items), 2, replace=False))
        b = items.pop(j)
        a = items.pop(i)
        items.append(f"({a},{b}):{rng.uniform(0.05, 0.5):.4f}")
    tree = ut.parse_newick_string(f"({items[0]},{items[1]},{items[2]});")

    topo, branches = topology_from_tree(tree, sites,
                                        scale_mode=SCALE_PER_SITE)

    # model: GTR + Gamma
    params = rng.uniform(0.5, 2.0, 6)
    freqs = rng.uniform(0.1, 1.0, 4)
    freqs /= freqs.sum()
    w, left, right = eigen_decompose(params, freqs)
    rates = compute_gamma_cats(1.0, rate_cats)

    model = {
        "branch_lengths": np.asarray(branches, dtype),
        "rates": np.asarray(rates, dtype),
        "prop_invar": np.zeros((1,), dtype),
        "params_indices": np.zeros(rate_cats, np.int32),
        "eigenvals": np.asarray(w[None], dtype),
        "left": np.asarray(left[None], dtype),
        "right": np.asarray(right[None], dtype),
        "freqs_pc": np.asarray(np.broadcast_to(freqs, (rate_cats, 4)),
                               dtype),
        "prop_invar_pc": np.zeros((rate_cats,), dtype),
        "rate_weights": np.full((rate_cats,), 1.0 / rate_cats, dtype),
        "pattern_weights": np.ones((sites,), dtype),
        "invariant": np.full((sites,), -1, np.int32),
    }
    return tree, topo, model, (w, left, right, freqs, params)


def simulate_flagship(tips, sites, rate_cats=4, seed=0):
    """(tree, topo, model, (params, freqs), states): the flagship's tree
    and GTR+Γ model with [tips, sites] uint8 states simulated on the tree
    (row = tip CLV index), as :func:`build_flagship` with ``simulate``
    draws them.  The model is float64 numpy; ``params``/``freqs`` are the
    GTR exchangeabilities and frequencies a Partition's setters take."""
    rng = np.random.default_rng(seed)
    tree, topo, model, (w, left, right, freqs, params) = \
        _topology_and_model(tips, sites, rate_cats, np.float64, rng)
    states = simulate_tips(tree, tips, sites, w, left, right, freqs, rng)
    return tree, topo, model, (params, freqs), states


def build_flagship_topology(tips, sites, rate_cats=4, dtype=np.float32,
                            seed=0):
    """(topo, model) of :func:`build_flagship` without drawing tips: at
    10 240 taxa × 2**20 sites host tip masks would take 43 GB
    (:func:`draw_tipchars_cuda` draws them on the card instead)."""
    _, topo, model, _ = _topology_and_model(
        tips, sites, rate_cats, dtype, np.random.default_rng(seed))
    return topo, model


def draw_tipchars_cuda(tips, sites, seed, device, tips_per_chunk=256):
    """Random single-state DNA tips, drawn on ``device`` from a seeded
    ``torch.Generator`` and nibble-packed as ``clv_fused.pack_tipchars``
    lays them out: [ceil(tips/8), sites] int32.  Rows are drawn
    ``tips_per_chunk`` at a time, so the card never holds more than that
    many unpacked rows.  (The numbers are not numpy's: a card-drawn
    alignment has no host twin.)"""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    words = -(-tips // 8)
    out = torch.empty((words, sites), dtype=torch.int32, device=device)
    step = max(8, tips_per_chunk // 8 * 8)
    shifts = (4 * torch.arange(8, device=device))[:, None]
    for t0 in range(0, words * 8, step):
        rows = min(step, words * 8 - t0)
        codes = torch.ones((), dtype=torch.int64, device=device) << (
            torch.randint(0, 4, (rows, sites), generator=gen, device=device))
        codes[max(0, tips - t0):] = 0  # padding tips of the last word
        # nibbles are disjoint, so the sum is their bitwise or; the top
        # bit of a word becomes int32's sign bit
        packed = (codes.view(rows // 8, 8, sites) << shifts).sum(dim=1)
        out[t0 // 8:(t0 + rows) // 8] = torch.where(
            packed >= 1 << 31, packed - (1 << 32), packed)
    return out


def build_flagship(tips, sites, rate_cats=4, dtype=np.float32, seed=0,
                   tip_masks=False, simulate=False):
    """(topo, model, tips_data, scalers) for a flagship-shaped problem.

    ``tip_masks=True``: ``tips_data`` is [tips, sites] uint32 ambiguity
    bitmasks and ``scalers`` is None; with ``simulate`` too, the masks of
    the states simulated on the tree (the tips the CLV array of the same
    seed holds; JAX's builder draws random masks there).  Otherwise
    ``tips_data`` is the [2·tips − 2, C, 4, sites] CLV array (tips one-hot,
    inner rows zero) and ``scalers`` the zero [n_inner + 1, sites] int32
    counters."""
    if tip_masks and simulate:
        _, topo, model, _, states = simulate_flagship(tips, sites,
                                                      rate_cats, seed)
        model = {k: v.astype(dtype) if v.dtype == np.float64 else v
                 for k, v in model.items()}
        return topo, model, np.uint32(1) << states.astype(np.uint32), None
    rng = np.random.default_rng(seed)
    tree, topo, model, (w, left, right, freqs, _) = _topology_and_model(
        tips, sites, rate_cats, dtype, rng)

    if tip_masks:
        return topo, model, draw_tip_masks(rng, tips, sites), None

    # tip CLVs from random (or tree-simulated) sequences; inner CLVs zero
    nodes = 2 * tips - 2
    clv = np.zeros((nodes, rate_cats, 4, sites), dtype=np.float32)
    if simulate:
        states = simulate_tips(tree, tips, sites, w, left, right, freqs, rng)
    else:
        states = rng.integers(0, 4, (tips, sites))
    onehot = np.eye(4, dtype=np.float32)[states]  # [tips, sites, 4]
    clv[:tips] = onehot.transpose(0, 2, 1)[:, None, :, :]
    scalers = np.zeros((topo.schedule.n_inner + 1, sites), np.int32)
    return topo, model, clv.astype(dtype), scalers


ALPHABET_STATES = 16  # CellPhy's GT16 alphabet (unphased genotypes)
ALPHABET_ALPHA = 1.0


def build_alphabet_flagship(tips, sites, states, rate_cats=4, seed=0,
                            alpha=ALPHABET_ALPHA):
    """(tree, topo, model, columns): the flagship's tree (the topology of
    :func:`build_flagship` at this seed) with an S-state GTR+Γ model and
    [tips, sites] uint8 states simulated on it, one column a site (pattern
    weights 1, no invariant codes, per-site scaling).  The model draws
    S(S-1)/2 exchangeabilities in [0.5, 2) and S frequencies in [0.1, 1)
    (normalised) from the seed's stream after the tree; each column draws
    one of the C equiprobable Γ(alpha) categories and evolves at its rate.
    The model is float64 numpy; ``np.uint32(1) << columns`` are the
    columns as tip masks (at most 32 states), a one-hot of them the tip
    CLVs; row i of ``columns`` is the tip whose CLV index is i in
    ``tree``."""
    from ..models.gamma import compute_gamma_cats
    from ..models.gtr import eigen_decompose

    rng = np.random.default_rng(seed)
    tree, topo, model, _ = _topology_and_model(tips, sites, rate_cats,
                                               np.float64, rng)
    params = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
    freqs = rng.uniform(0.1, 1.0, states)
    freqs /= freqs.sum()
    w, left, right = eigen_decompose(params, freqs)
    rates = np.asarray(compute_gamma_cats(alpha, rate_cats), np.float64)
    weights = np.full(rate_cats, 1.0 / rate_cats)
    columns = simulate_mixture(tree, tips, sites, [(w, left, right)] *
                               rate_cats, np.tile(freqs, (rate_cats, 1)),
                               rates, weights, rng)
    model.update(
        rates=rates, eigenvals=w[None], left=left[None], right=right[None],
        freqs_pc=np.tile(freqs, (rate_cats, 1)), rate_weights=weights)
    return tree, topo, model, columns


def build_alphabet_topology(tips, sites, states, rate_cats=4, seed=0,
                            alpha=ALPHABET_ALPHA):
    """(topo, model) of :func:`build_alphabet_flagship` without simulating
    columns: the same tree and S-state GTR+Γ model, drawn from the seed's
    stream in the same order, for the large tiers' sizes (10 240 taxa,
    where simulated host columns would take most of a run;
    :func:`draw_tipmasks_cuda` draws the tips on the card)."""
    from ..models.gamma import compute_gamma_cats
    from ..models.gtr import eigen_decompose

    rng = np.random.default_rng(seed)
    _, topo, model, _ = _topology_and_model(tips, sites, rate_cats,
                                            np.float64, rng)
    params = rng.uniform(0.5, 2.0, states * (states - 1) // 2)
    freqs = rng.uniform(0.1, 1.0, states)
    freqs /= freqs.sum()
    w, left, right = eigen_decompose(params, freqs)
    rates = np.asarray(compute_gamma_cats(alpha, rate_cats), np.float64)
    model.update(
        rates=rates, eigenvals=w[None], left=left[None], right=right[None],
        freqs_pc=np.tile(freqs, (rate_cats, 1)),
        rate_weights=np.full(rate_cats, 1.0 / rate_cats))
    return topo, model


def draw_tipmasks_cuda(tips, sites, states, seed, device, ambiguity=0.02,
                       tips_per_chunk=256):
    """Random S-state tips (S <= 31) as one int32 bitmask a tip and site,
    [tips, sites], drawn on ``device`` from a seeded ``torch.Generator``:
    one state a cell, and in a share ``ambiguity`` of the cells a second
    state (an ambiguous genotype call).  Rows are drawn ``tips_per_chunk``
    at a time.  (The numbers are not numpy's: a card-drawn alignment has
    no host twin.)"""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((tips, sites), dtype=torch.int32, device=device)
    one = torch.ones((), dtype=torch.int32, device=device)
    for t0 in range(0, tips, tips_per_chunk):
        rows = min(tips_per_chunk, tips - t0)
        codes = one << torch.randint(0, states, (rows, sites), generator=gen,
                                     device=device, dtype=torch.int32)
        extra = one << torch.randint(0, states, (rows, sites), generator=gen,
                                     device=device, dtype=torch.int32)
        odd = torch.rand((rows, sites), generator=gen,
                         device=device) < ambiguity
        out[t0:t0 + rows] = torch.where(odd, codes | extra, codes)
    return out


PROTEIN_TIPS = 64
PROTEIN_SITES = 65536  # simulated columns; the patterns are fewer
PROTEIN_RATE_CATS = 4
PROTEIN_STATES = 20
PROTEIN_ALPHA = 0.8
PROTEIN_RATE_WEIGHTS = (0.1, 0.2, 0.3, 0.4)
PROTEIN_AMBIGUITY = 0.03  # share of cells turned into '-', 'X', 'B', 'Z'


def protein_flagship_alignment(tips=PROTEIN_TIPS, sites=PROTEIN_SITES,
                               seed=0):
    """The alignment of :func:`build_protein_flagship`, compressed:
    ``(tree, topo, branches, patterns, counts, lg4x)`` with ``patterns``
    the compressed rows in tip-CLV-index order, ``counts`` their int64
    pattern weights and ``lg4x`` = (exchangeabilities [4, 190],
    frequencies [4, 20], eigen factors per matrix, Γ category rates,
    category weights): what a Partition's setters take."""
    import os
    import tempfile

    from ..io.compress import compress_site_patterns
    from ..io.fasta import parse_fasta
    from ..io.maps import AA_STATES, pll_map_aa
    from ..models.aa_tables import AA_MIXTURE_MODELS
    from ..models.gamma import compute_gamma_cats
    from ..models.gtr import eigen_decompose

    c = PROTEIN_RATE_CATS
    rng = np.random.default_rng(seed)
    tree, topo, dna_model, _ = _topology_and_model(tips, sites, c,
                                                   np.float64, rng)
    rates4, freqs4 = AA_MIXTURE_MODELS["lg4x"]
    freqs = np.asarray(freqs4, np.float64)
    freqs = freqs / freqs.sum(axis=1, keepdims=True)
    eigen = [eigen_decompose(rates4[k], freqs[k]) for k in range(c)]
    cat_rates = compute_gamma_cats(PROTEIN_ALPHA, c)
    weights = np.asarray(PROTEIN_RATE_WEIGHTS, np.float64)
    states = simulate_mixture(tree, tips, sites, eigen, freqs, cat_rates,
                              weights, rng)

    letters = np.frombuffer(AA_STATES.encode(), np.uint8)[states]
    odd = rng.random(letters.shape) < PROTEIN_AMBIGUITY
    letters[odd] = np.frombuffer(b"-XBZ", np.uint8)[
        rng.integers(0, 4, int(odd.sum()))]
    labels = {}
    stack = [tree.root.back, tree.root.next.back, tree.root.next.next.back]
    while stack:
        node = stack.pop()
        if node.is_tip:
            labels[node.label] = node.clv_index
        else:
            stack.extend((node.next.back, node.next.next.back))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "protein.fasta")
        with open(path, "w", encoding="latin-1") as fh:
            for label, row in labels.items():
                seq = letters[row].tobytes().decode("latin-1")
                fh.write(f">{label}\n")
                fh.writelines(seq[i:i + 80] + "\n"
                              for i in range(0, sites, 80))
        headers, seqs = parse_fasta(path)
    rows = sorted(range(tips), key=lambda i: labels[headers[i]])
    patterns, counts = compress_site_patterns([seqs[i] for i in rows],
                                              pll_map_aa)
    lg4x = (np.asarray(rates4, np.float64), freqs, eigen, cat_rates,
            weights)
    return tree, topo, dna_model["branch_lengths"], patterns, counts, lg4x


def build_protein_flagship(tips=PROTEIN_TIPS, sites=PROTEIN_SITES, seed=0):
    """(topo, model, masks) of the LG4X+Γ4 protein configuration.

    The tree is :func:`build_flagship`'s of the same seed.  The model is
    the LG4X mixture (``models/aa_tables``): four rate matrices, one per
    category (``params_indices`` 0-3), each with its frequencies
    (``freqs_pc``), Γ(α = 0.8) category rates and weights 0.1, 0.2, 0.3,
    0.4.  ``sites`` columns are simulated on the tree under the mixture
    (:func:`simulate_mixture`), ``PROTEIN_AMBIGUITY`` of the cells become
    '-', 'X', 'B' or 'Z' (multi-bit masks), the alignment is written to a
    FASTA file in a temporary directory and read back (``io.fasta``),
    compressed to site patterns (``io.compress``) and encoded
    (``io.maps.pll_map_aa``).  Returns the topology (its ``sites`` the
    pattern count), the model as float64 numpy (pattern weights the
    pattern counts) and the [tips, patterns] int32 masks."""
    from ..io.maps import pll_map_aa

    c = PROTEIN_RATE_CATS
    _, topo, branches, patterns, counts, lg4x = protein_flagship_alignment(
        tips, sites, seed)
    _, freqs, eigen, cat_rates, weights = lg4x
    n = counts.shape[0]
    masks = pll_map_aa[np.frombuffer("".join(patterns).encode("latin-1"),
                                     np.uint8).reshape(tips, n)]

    model = {
        "branch_lengths": branches,
        "rates": np.asarray(cat_rates, np.float64),
        "prop_invar": np.zeros((c,), np.float64),
        "params_indices": np.arange(c, dtype=np.int32),
        "eigenvals": np.stack([e[0] for e in eigen]),
        "left": np.stack([e[1] for e in eigen]),
        "right": np.stack([e[2] for e in eigen]),
        "freqs_pc": freqs,
        "prop_invar_pc": np.zeros((c,), np.float64),
        "rate_weights": weights,
        "pattern_weights": counts.astype(np.float64),
        "invariant": np.full((n,), -1, np.int32),
    }
    return topo._replace(sites=n), model, masks.astype(np.int32)


# ---------------------------------------------------------------------------
# scripts/bench_infer.py's alignment (its simulate and expm_gtr, :48-119)
# ---------------------------------------------------------------------------
INFER_TIPS = 1024
INFER_SITES = 16384
INFER_ALPHA = 0.8
INFER_FREQS = (0.3, 0.25, 0.2, 0.25)
INFER_PARAMS = (1.2, 2.7, 0.8, 1.1, 3.2, 1.0)


def expm_gtr(params, freqs, t):
    """P(t) = exp(Qt) of the normalised GTR matrix, by scipy's expm."""
    from scipy.linalg import expm

    s = np.zeros((4, 4))
    iu = np.triu_indices(4, 1)
    s[iu] = params
    s = s + s.T
    q = s * freqs[None, :]
    q[np.diag_indices(4)] = -q.sum(1)
    q /= -(np.diag(q) * freqs).sum()
    return expm(q * t)


def infer_alignment(tips=INFER_TIPS, sites=INFER_SITES, seed=11):
    """DNA evolved down a random binary tree under GTR+Γ4 (α 0.8,
    ``INFER_FREQS``, ``INFER_PARAMS``): data with real signal, so that a
    tree search has work to do.  Returns ({"t<i>": sequence}, the
    generating tree's Newick).  The draws are scripts/bench_infer.py's,
    in its order, so a seed gives its alignment."""
    from ..models.gamma import compute_gamma_cats

    rng = np.random.default_rng(seed)
    freqs = np.array(INFER_FREQS)
    params = np.array(INFER_PARAMS)
    rates = np.asarray(compute_gamma_cats(INFER_ALPHA, 4))

    # random binary tree by leaf splitting; parents get smaller ids than
    # their children, so evolving in id order is top-down
    parent, blen = {0: -1}, {0: 0.0}
    leaves, next_id = [0], 1
    while len(leaves) < tips:
        node = leaves.pop(rng.integers(len(leaves)))
        for _ in range(2):
            parent[next_id] = node
            blen[next_id] = rng.uniform(0.02, 0.4)
            leaves.append(next_id)
            next_id += 1

    children = {}
    for node, par in parent.items():
        if node:
            children.setdefault(par, []).append(node)
    leaf_label = {n: f"t{i}" for i, n in enumerate(leaves)}

    def nw(node):
        # a loop, not the script's recursion: no recursion limit to
        # meet however deep the tree
        out, stack = [], [(node, 0)]
        while stack:
            n, state = stack.pop()
            if n in leaf_label:
                out.append(f"{leaf_label[n]}:{blen[n]:.5f}")
            elif state == 0:
                l, r = children[n]
                out.append("(")
                stack += [(n, 2), (r, 0), (n, 1), (l, 0)]
            elif state == 1:
                out.append(",")
            else:
                out.append(f"):{blen[n]:.5f}")
        return "".join(out)

    l, r = children[0]
    rl, rr = children[r] if r in children else (None, None)
    if rl is None:  # root child r is a leaf: expand the left side instead
        l, r = r, l
        rl, rr = children[r]
    truth_newick = f"({nw(l)},{nw(rl)},{nw(rr)});"

    cat = rng.integers(0, 4, sites)  # per-site Γ category
    seq = {0: rng.choice(4, sites, p=freqs)}
    # branch lengths are i.i.d. uniform, so bucket them for P-matrix reuse
    pm_cache = {}
    for node in range(1, next_id):
        key = round(blen[node], 3)
        if key not in pm_cache:
            pm_cache[key] = np.stack(
                [expm_gtr(params, freqs, r * key) for r in rates])
        P = pm_cache[key]                    # [cats, 4, 4]
        probs = P[cat, seq[parent[node]]]    # [sites, 4]
        u = rng.random(sites)
        seq[node] = (probs.cumsum(1) > u[:, None]).argmax(1)

    alpha = np.array(list("ACGT"))
    return ({f"t{i}": "".join(alpha[seq[n]]) for i, n in enumerate(leaves)},
            truth_newick)
