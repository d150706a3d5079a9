"""Bit-packed unweighted (Fitch) parsimony: the host packing, plain
PyTorch versions of the Fitch steps, and the wrappers of the kernels
P1-P3 of ``csrc/fitch.cu``.

Counterpart: ``libpll_tpu/ops/fitch.py``, capability parity with libpll
``src/fast_parsimony.c``.  Informative sites are found and bit-packed on
the host with numpy (``set_informative`` ``:34``, ``pack_vectors``
``:60``, ``_ring_co_tables`` ``:196``, copied), into per-state 32-site
words; the Fitch step per word is

    union    = OR_k (c1_k & c2_k)
    parent_k = (c1_k & c2_k) | (~union & (c1_k | c2_k))
    cost    += popcount(~union)

Words are held as ``int32`` tensors carrying the ``uint32`` bit patterns of
JAX's arrays (PyTorch has no popcount and no ``~``/``>>``/``argmin`` on
``uint32``); node costs and scores likewise, with JAX's wrapping ``uint32``
sums.  :func:`as_uint32` reads a tensor back as numpy ``uint32``.  The plain
versions count bits by SWAR on words widened to int64 and masked to 32
bits, so ``int32``'s arithmetic ``>>`` never reaches them.

JAX computes all of this in XLA with ``jax.lax.population_count`` (no
Pallas kernel); the port's kernels are port-only, on ``__popc``:

  P1 :func:`fitch_waves`: dependency-ordered waves of Fitch ops, all of a
     call in one launch, as JAX's one compiled scan (``fitch_update``
     ``:103``, ``fitch_run_waves`` ``:126``); its words split across blocks
     (:func:`wave_plan`), each block walking every wave over its slice and
     the last one forming the costs from the slices' popcounts
     (:func:`fitch_run_waves_sliced_plain` is that plan walked with the
     plain version);
  P2 :func:`fitch_scores`: the score of every edge (``fitch_edge_score``
     ``:145``, ``fitch_edge_scores_batch`` ``:158``) or of splicing a tip
     onto every candidate edge (``fitch_insert_scores`` ``:172``), written
     or added into one score vector;
  P3 :func:`stepwise_commit`: one greedy insertion of the device-resident
     stepwise build: the first-minimum argmin, the splice of ``back`` and
     ``edge_rows``, and the dirty-row refresh of every partition; or the
     star's first refresh, or the final edge score
     (``_stepwise_range_body`` ``:273``, ``_stepwise_final_body``
     ``:408``).  Its words are split across blocks (:func:`commit_plan`),
     as JAX's ``_stepwise_range_body`` splits them across devices: each
     block refreshes its slice and the slices' costs are summed
     (:func:`stepwise_commit_sliced_plain` is that plan walked with the
     plain version).  :func:`stepwise_build` issues the whole build (JAX's
     ``_stepwise_build_body`` ``:232``): P2 and P3 a insertion, back to
     back, no host read.

Each wrapper takes its kernel on CUDA tensors and its plain version
(``*_plain``) on CPU tensors, and counts its kernel launches in
``<wrapper>.launches``.  Not ported: JAX's padding of waves and candidate
lists by repeated ops (compile-shape tricks) and the watchdog segmentation
of the build.  The plain versions update ``vectors``/``costs`` (and the
build's ``back``/``edge_rows``) in place where JAX returns new arrays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..errors import EinvalError, KernelError
from . import _build

BITS = 32
MASK32 = 0xFFFFFFFF
MAX_PARTS = 32  # partitions one P3 launch refreshes (csrc/fitch.cu kMaxParts)
SLICE_WORDS = 32  # the fewest words a P1/P3 block's slice pays for: a warp-width
STEP_MODES = {"star": 0, "insert": 1, "final": 2}


# --------------------------------------------------------------------------
# host packing (numpy, copied)
# --------------------------------------------------------------------------
def set_informative(tip_masks: np.ndarray, states: int,
                    pattern_weights: np.ndarray):
    """Identify parsimony-informative sites.

    tip_masks: uint32 [tips, sites] state bitmasks.
    Returns (informative bool [sites], const_cost int).
    """
    tips, sites = tip_masks.shape
    # per-column value-run analysis, vectorized over the alignment
    m = np.sort(tip_masks, axis=0)                      # [tips, sites]
    start = np.ones((tips, sites), dtype=bool)
    start[1:] = m[1:] != m[:-1]
    # a run is a singleton iff its start is immediately followed by
    # another start (or by the end of the column)
    nxt = np.ones((tips, sites), dtype=bool)
    nxt[:-1] = start[1:]
    single = (start & nxt).sum(axis=0)
    multi = start.sum(axis=0) - single
    informative = multi > 1
    const_cost = int((single[~informative]
                      * np.asarray(pattern_weights)[~informative]).sum())
    return informative, const_cost


def pack_vectors(tip_masks: np.ndarray, states: int,
                 informative: np.ndarray, pattern_weights: np.ndarray,
                 n_inner: int, pad_words: int = 8) -> np.ndarray:
    """Bit-pack informative sites (×weight) into uint32 state vectors.

    Returns uint32 [tips + n_inner, states, words]; tip rows filled, inner
    rows zero. Pad bits/words are all-ones (they never contribute cost).
    """
    tips, sites = tip_masks.shape
    bitcount = int(pattern_weights[informative].sum())
    words = (bitcount + BITS - 1) // BITS
    words = ((words + pad_words - 1) // pad_words) * pad_words
    words = max(words, pad_words)

    out = np.zeros((tips + n_inner, states, words), dtype=np.uint32)

    # site index replicated by weight, bit position assignment
    rep_sites = np.repeat(np.nonzero(informative)[0],
                          pattern_weights[informative].astype(int))
    bitpos = np.arange(rep_sites.size)
    word_idx = bitpos // BITS
    bit_in_word = (bitpos % BITS).astype(np.uint32)

    for i in range(tips):
        masks = tip_masks[i, rep_sites]  # [bits]
        for k in range(states):
            hasbit = ((masks >> k) & 1).astype(bool)
            np.add.at(out[i, k], word_idx[hasbit],
                      (np.uint32(1) << bit_in_word[hasbit]))
    # pad bits within the last used word + all padding words -> ones
    used = rep_sites.size
    if used % BITS:
        last = used // BITS
        padmask = np.uint32(0xFFFFFFFF) << np.uint32(used % BITS)
        out[:tips, :, last] |= padmask
        full_from = last + 1
    else:
        full_from = used // BITS
    out[:tips, :, full_from:] = 0xFFFFFFFF
    return out


def _ring_co_tables(n_tips: int) -> tuple[np.ndarray, np.ndarray]:
    """Static ring co-member tables for the device-resident stepwise build.

    Direction rows: tips occupy rows 0..n-1; inner directed nodes are
    allocated in ring triples (b, b+1, b+2) — the star ring at rows
    n..n+2, then one triple per insertion.  Ring membership never changes
    after creation, so ``co1[d]``/``co2[d]`` (= d.next / d.next.next in the
    reference's ring representation, pll.h:312-334) are constants; tips map
    to themselves (never dereferenced).
    """
    D = n_tips + 3 * (n_tips - 2)
    co1 = np.arange(D, dtype=np.int32)
    co2 = np.arange(D, dtype=np.int32)
    for b in range(n_tips, D, 3):
        co1[b], co1[b + 1], co1[b + 2] = b + 1, b + 2, b
        co2[b], co2[b + 1], co2[b + 2] = b + 2, b, b + 1
    return co1, co2


def to_words(a: np.ndarray, device) -> torch.Tensor:
    """A numpy ``uint32`` array as an ``int32`` tensor of the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


def as_uint32(t: torch.Tensor) -> np.ndarray:
    """An ``int32`` tensor of words, costs or scores as numpy ``uint32``."""
    return t.detach().cpu().numpy().view(np.uint32)


# --------------------------------------------------------------------------
# plain versions (PyTorch, any device)
# --------------------------------------------------------------------------
def _uint(t: torch.Tensor) -> torch.Tensor:
    """``int32`` bit patterns as their ``uint32`` values, in int64."""
    return t.to(torch.int64) & MASK32


def _bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values modulo 2**32 as ``int32`` bit patterns (the wrap of
    JAX's ``uint32`` sums)."""
    x = x & MASK32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each ``int32`` word (SWAR on the word masked to 32 bits),
    int64."""
    x = _uint(words)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _union(land: torch.Tensor) -> torch.Tensor:
    """OR over the state axis (-2) of [..., S, W] words."""
    union = land[..., 0, :]
    for k in range(1, land.shape[-2]):
        union = union | land[..., k, :]
    return union


def _fitch(a: torch.Tensor, b: torch.Tensor):
    """The Fitch step of [..., S, W] children: (parent words, mutations
    int64 [...])."""
    land = a & b
    union = _union(land)
    parent = land | (~union.unsqueeze(-2) & (a | b))
    return parent, popcount(~union).sum(-1)


def fitch_update_plain(vectors, costs, parent, child1, child2):
    """One wave of independent Fitch ops (JAX's ``fitch_update``): the
    children of every op gathered before any parent row is written."""
    new, mut = _fitch(vectors[child1], vectors[child2])
    vectors[parent] = new
    costs[parent] = _bits(_uint(costs[child1]) + _uint(costs[child2]) + mut)
    return vectors, costs


def fitch_run_waves_plain(vectors, costs, table, offsets):
    """P1's plain version: wave w is rows ``offsets[w]:offsets[w+1]`` of
    ``table`` int32 [ops, 3] (parent, child1, child2), in order."""
    for lo, hi in zip(offsets[:-1], offsets[1:]):
        ops = table[lo:hi].long()
        fitch_update_plain(vectors, costs, ops[:, 0], ops[:, 1], ops[:, 2])
    return vectors, costs


def fitch_run_waves_sliced_plain(vectors, costs, table, offsets, grid):
    """P1's plan walked with its plain version: each of :func:`word_slices`'
    ``grid`` slices runs every wave in order over its own words, keeping
    its popcounts of each op (its share); then the costs wave by wave in
    table order, ``cost[p] = cost[c1] + cost[c2] + sum of the op's
    shares`` (wrapping), as the kernel's last block forms them.  Same
    arguments and effect as :func:`fitch_run_waves_plain`."""
    ops = table.long()
    shares = torch.zeros((grid, ops.shape[0]), dtype=torch.int64,
                         device=vectors.device)
    waves = list(zip(offsets[:-1], offsets[1:]))
    for g, (lo, hi) in enumerate(word_slices(vectors.shape[-1], grid)):
        v = vectors[..., lo:hi]
        for a, b in waves:
            new, mut = _fitch(v[ops[a:b, 1]], v[ops[a:b, 2]])
            v[ops[a:b, 0]] = new
            shares[g, a:b] = mut
    total = shares.sum(0)
    for a, b in waves:
        p, c1, c2 = ops[a:b].unbind(1)
        costs[p] = _bits(_uint(costs[c1]) + _uint(costs[c2]) + total[a:b])
    return vectors, costs


def fitch_edge_scores_plain(vectors, costs, nodes1, nodes2):
    """P2's plain version, edge mode: the Fitch score of joining each
    nodes1[e]--nodes2[e], without the constant cost; int32 [E]."""
    mut = popcount(~_union(vectors[nodes1] & vectors[nodes2])).sum(-1)
    return _bits(mut + _uint(costs[nodes1]) + _uint(costs[nodes2]))


def fitch_insert_scores_plain(vectors, costs, tipvec, u_idx, v_idx):
    """P2's plain version, insert mode (JAX's ``_insert_scores``): the score
    of splicing tip words ``tipvec`` [S, W] onto each edge u--v,
    ``C[u] + C[v] + mut(V[u], T) + mut(X, V[v])`` with ``X = fitch(V[u],
    T)``; int32 [E]."""
    x, mut1 = _fitch(vectors[u_idx], tipvec.unsqueeze(0))
    mut2 = popcount(~_union(x & vectors[v_idx])).sum(-1)
    return _bits(_uint(costs[u_idx]) + _uint(costs[v_idx]) + mut1 + mut2)


def stepwise_commit_plain(parts, back, edge_rows, co1, co2, n_tips, *,
                          mode, scores=None, insertion=0, tip=0):
    """P3's plain version.  ``parts``: [(vectors, costs)] of the build's
    direction rows, one pair per partition.

    ``mode="insert"``: insertion ``insertion`` of tip ``tip``: the first
    minimum of ``scores[:2i-3]`` picks edge ``u = edge_rows[e]``,
    ``v = back[u]``; the ring at rows ``r0..r2 = n + 3(i-2) + (0, 1, 2)``
    splices in (``back``: u-r0, v-r1, tip-r2; ``edge_rows`` gains r1 and
    r2), then every row whose subtree gained the tip is recomputed, level
    by level from r0..r2 (the dependents of row d are ``co1[back[d]]``,
    ``co2[back[d]]`` when ``back[d]`` is an inner row).  ``mode="star"``:
    that refresh from rows n..n+2.  ``mode="final"``: returns int32 [P],
    each partition's score at the edge of row n."""
    if mode == "final":
        u = torch.tensor([n_tips], device=back.device)
        v = back[u].long()
        return torch.cat([fitch_edge_scores_plain(vec, cost, u, v)
                          for vec, cost in parts])
    first = n_tips
    if mode == "insert":
        ne = 2 * insertion - 3
        first = n_tips + 3 * (insertion - 2)
        e = torch.argmin(_uint(scores[:ne]))  # the first minimum
        u = edge_rows[e].long()
        v = back[u].long()
        back[u] = first
        back[first] = u.to(back.dtype)
        back[v] = first + 1
        back[first + 1] = v.to(back.dtype)
        back[tip] = first + 2
        back[first + 2] = tip
        edge_rows[ne] = first + 1
        edge_rows[ne + 1] = first + 2
    level = torch.arange(first, first + 3, device=back.device)
    co1, co2 = co1.long(), co2.long()
    while level.numel():
        c1 = back[co1[level]].long()
        c2 = back[co2[level]].long()
        for vec, cost in parts:
            fitch_update_plain(vec, cost, level, c1, c2)
        b = back[level].long()
        b = b[b >= n_tips]
        level = torch.stack([co1[b], co2[b]], 1).reshape(-1)
    return None


def word_slices(words: int, grid: int):
    """The word range [lo, hi) of each of P1's or P3's ``grid`` blocks in a
    partition of ``words`` words (csrc/fitch.cu's split): contiguous,
    in block order, some empty when ``grid`` exceeds ``words``."""
    return [(words * g // grid, words * (g + 1) // grid)
            for g in range(grid)]


def stepwise_commit_sliced_plain(parts, back, edge_rows, co1, co2, n_tips,
                                 *, grid, mode, scores=None, insertion=0,
                                 tip=0):
    """P3's plan walked with its plain version: one
    :func:`stepwise_commit_plain` per word slice of :func:`word_slices`,
    each on its own copy of ``back``/``edge_rows``, slice 0 from the rows'
    costs and the others from zero; a refreshed row's cost is the
    (wrapping) sum of its slices' costs, as the kernel's last block forms
    it.  Same arguments and effect as :func:`stepwise_commit_plain`."""
    if mode == "final":
        return stepwise_commit_plain(parts, back, edge_rows, co1, co2,
                                     n_tips, mode=mode)
    shares, topo = [], None
    for g in range(grid):
        b, e = back.clone(), edge_rows.clone()
        sliced = []
        for vec, cost in parts:
            lo, hi = word_slices(vec.shape[-1], grid)[g]
            sliced.append((vec[..., lo:hi].clone(),
                           cost.clone() if g == 0 else torch.zeros_like(cost)))
        stepwise_commit_plain(sliced, b, e, co1, co2, n_tips, mode=mode,
                              scores=scores, insertion=insertion, tip=tip)
        for (vec, _), (v, _) in zip(parts, sliced):
            lo, hi = word_slices(vec.shape[-1], grid)[g]
            vec[..., lo:hi] = v
        shares.append([c for _, c in sliced])
        if topo is None:
            topo = (b, e)
        elif not (torch.equal(b, topo[0]) and torch.equal(e, topo[1])):
            raise AssertionError("slices spliced different topologies")
    back.copy_(topo[0])
    edge_rows.copy_(topo[1])
    for q, (_, cost) in enumerate(parts):
        cost.copy_(_bits(sum(_uint(share[q]) for share in shares)))
    return None


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------
_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/fitch.cu``, once per process."""
    lib = _build.load("fitch")
    lib.fitch_waves.argtypes = [_P, _P, _I, _I, _P, _I, _I, _I, _P, _P,
                                _I, _P]
    lib.fitch_scores.argtypes = [_P, _P, _I, _I, _P, _P, _P, _I, _I, _P,
                                 _I, _P]
    lib.stepwise_commit.argtypes = [_I, _I, _P, _P, _P, _P, _I, _P, _I, _I,
                                    _I, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                                    _P, _P]
    lib.stepwise_commit_limits.argtypes = [_P, _P]
    for fn in (lib.fitch_waves, lib.fitch_scores, lib.stepwise_commit,
               lib.stepwise_commit_limits):
        fn.restype = ctypes.c_int
    lib.fitch_error_string.argtypes = [ctypes.c_int]
    lib.fitch_error_string.restype = ctypes.c_char_p
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"fitch kernel input: {what}")


def _check(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.fitch_error_string(rc).decode()
        raise KernelError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _check_rows(vectors, costs) -> None:
    _require(vectors.dtype == torch.int32 and vectors.dim() == 3
             and vectors.is_contiguous(),
             f"vectors {tuple(vectors.shape)} {vectors.dtype}, want "
             "[N, S, W] int32 contiguous")
    _require(costs.dtype == torch.int32 and costs.is_contiguous()
             and tuple(costs.shape) == (vectors.shape[0],)
             and costs.device == vectors.device,
             f"costs {tuple(costs.shape)} {costs.dtype} on {costs.device}, "
             f"want [{vectors.shape[0]}] int32 on {vectors.device}")
    _require(1 <= vectors.shape[1] <= 32, f"{vectors.shape[1]} states")


def _indices(idx, device, n_rows, what) -> torch.Tensor:
    """``idx`` as int32 on ``device``; host indices are range-checked
    (indices already on the card are the caller's, read by no host)."""
    t = torch.as_tensor(idx, dtype=torch.int32)
    if t.device.type == "cpu" and t.numel():
        _require(int(t.min()) >= 0 and int(t.max()) < n_rows,
                 f"{what} outside [0, {n_rows})")
    return t.to(device).contiguous()


def wave_table(waves, n_rows: int):
    """(table int32 numpy [ops, 3], offsets) of a list of waves of
    (parent, child1, child2) ops.  Raises unless every index lies in
    [0, n_rows) and no row that a wave writes is written twice or read by
    an op of the same wave (the kernel's blocks run a wave's ops in no
    order)."""
    sizes = [len(w) for w in waves]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    table = np.asarray([op[:3] for w in waves for op in w],
                       np.int64).reshape(-1, 3)
    _require(table.size == 0 or (table.min() >= 0 and table.max() < n_rows),
             f"op rows outside [0, {n_rows})")
    wave = np.repeat(np.arange(len(waves)), sizes)
    keys_p = table[:, 0] * len(waves) + wave
    keys_c = table[:, 1:] * len(waves) + wave[:, None]
    _require(np.unique(keys_p).size == keys_p.size
             and not np.isin(keys_c, keys_p).any(),
             "a wave writes a row twice, or a row that one of its ops "
             "reads")
    return table.astype(np.int32), offsets


def wave_plan(words: int, sms: int) -> int:
    """P1's (and P3's, :func:`commit_plan`) blocks for rows of ``words``
    words on a card of ``sms`` SMs (pure): a block per ``SLICE_WORDS``
    words, at most one per SM, one below 2 * SLICE_WORDS words."""
    return max(1, min(sms, words // SLICE_WORDS))


def wave_grid(vectors) -> int:
    """:func:`wave_plan` for ``vectors`` on their card."""
    sms, _ = _limits(vectors.device.index or 0)
    return wave_plan(vectors.shape[2], sms)


def wave_smem(n_ops: int, n_waves: int, smem_limit: int) -> int:
    """P1's shared memory (pure): the table's ints, its wave offsets and
    the ops' totals, ``4 * (4 n_ops + n_waves + 1)`` bytes, where that
    fits ``smem_limit``; else 0 (both read from device memory)."""
    need = 4 * (4 * n_ops + n_waves + 1)
    return need if need <= smem_limit else 0


def fitch_waves(vectors, costs, waves):
    """P1: run ``waves`` (a list of waves, each a list of independent
    (parent, child1, child2) ops; JAX's ``fitch_run_waves``) in order, in
    place, in one launch over :func:`wave_grid`'s blocks (the table and
    its wave offsets copied to the card at once, staged in shared memory
    where :func:`wave_smem` finds room).  CPU tensors take
    :func:`fitch_run_waves_plain`."""
    _check_rows(vectors, costs)
    table, offsets = wave_table(waves, vectors.shape[0])
    if vectors.device.type == "cpu":
        return fitch_run_waves_plain(vectors, costs, torch.from_numpy(table),
                                     offsets)
    n_ops = table.shape[0]
    if not n_ops:
        return vectors, costs
    packed = torch.from_numpy(np.concatenate(
        [table.reshape(-1), np.asarray(offsets, np.int32)])).to(
            vectors.device)
    grid = wave_grid(vectors)
    # the blocks' shares [grid, n_ops], then their counter at 0
    work = torch.zeros(grid * n_ops + 1, dtype=torch.int32,
                       device=vectors.device)
    smem = wave_smem(n_ops, len(offsets) - 1,
                     _limits(vectors.device.index or 0)[1])
    lib = load_kernels()
    _, s, w = vectors.shape
    with torch.cuda.device(vectors.device):
        rc = lib.fitch_waves(
            vectors.data_ptr(), costs.data_ptr(), s, w, packed.data_ptr(),
            n_ops, len(offsets) - 1, grid, work.data_ptr(),
            work[-1:].data_ptr(), smem,
            torch.cuda.current_stream().cuda_stream)
    _check(lib, rc, "fitch_waves")
    fitch_waves.launches += 1
    return vectors, costs


fitch_waves.launches = 0


def fitch_scores(vectors, costs, nodes1, nodes2=None, *, back=None,
                 tip=None, out=None, accumulate=False):
    """P2: one score per edge e, int32 [E] (``uint32`` bits).  ``tip`` None:
    the Fitch score of joining nodes1[e]--nodes2[e] (edge mode); ``tip`` a
    row of ``vectors``: the score of splicing that tip onto the edge
    (insert mode).  ``nodes2`` None takes ``back[nodes1[e]]`` on the card.
    ``out`` given: written into (``accumulate``: added to, wrapping, as
    partitions' scores sum).  CPU tensors take the plain versions."""
    _check_rows(vectors, costs)
    n_rows = vectors.shape[0]
    device = vectors.device
    n1 = _indices(nodes1, device, n_rows, "nodes1")
    _require(n1.dim() == 1, "nodes1 must be one-dimensional")
    if nodes2 is None:
        _require(back is not None and back.dtype == torch.int32
                 and back.device == device and back.is_contiguous()
                 and back.numel() == n_rows,
                 f"back must be [{n_rows}] int32 on {device}")
        n2 = None
    else:
        n2 = _indices(nodes2, device, n_rows, "nodes2")
        _require(n2.shape == n1.shape, "nodes1 and nodes2 differ in shape")
    _require(tip is None or 0 <= tip < n_rows, f"tip row {tip}")
    E = n1.numel()
    if out is None:
        _require(not accumulate, "accumulate needs out")
        out = torch.empty(E, dtype=torch.int32, device=device)
    _require(out.dtype == torch.int32 and out.device == device
             and out.is_contiguous() and out.numel() == E,
             f"out must be [{E}] int32 contiguous on {device}")
    if device.type == "cpu":
        v = back[n1.long()].long() if n2 is None else n2.long()
        s = (fitch_edge_scores_plain(vectors, costs, n1.long(), v)
             if tip is None else
             fitch_insert_scores_plain(vectors, costs, vectors[tip],
                                       n1.long(), v))
        out.copy_(_bits(_uint(out) + _uint(s)) if accumulate else s)
        return out
    if not E:
        return out
    lib = load_kernels()
    _, s, w = vectors.shape
    with torch.cuda.device(device):
        rc = lib.fitch_scores(
            vectors.data_ptr(), costs.data_ptr(), s, w, n1.data_ptr(),
            None if n2 is None else n2.data_ptr(),
            None if back is None else back.data_ptr(),
            -1 if tip is None else int(tip), E, out.data_ptr(),
            int(accumulate), torch.cuda.current_stream().cuda_stream)
    _check(lib, rc, "fitch_scores")
    fitch_scores.launches += 1
    return out


fitch_scores.launches = 0


class CommitPlan(NamedTuple):
    """P3's launch (:func:`commit_plan`): ``grid`` blocks, each over a
    slice of every partition's words; the walk's tables in shared memory
    (``shared``, ``smem`` bytes of it) or in the workspace."""
    grid: int
    shared: bool
    smem: int


def commit_plan(words, n_tips: int, sms: int, smem_limit: int) -> CommitPlan:
    """P3's launch for partitions of ``words`` words each at ``n_tips``
    taxa on a card of ``sms`` SMs whose block may ask for ``smem_limit``
    bytes of dynamic shared memory (pure).  A block per ``SLICE_WORDS``
    words of the widest partition, at most one per SM: one block below
    2 * SLICE_WORDS words.  ``back``, co1, co2, the queue and its sources
    (``4 * 5D`` bytes, D = 4n - 6 rows: a row is queued at most once) in
    shared memory where they fit, else in device memory (always at a
    ``smem_limit`` of 0)."""
    rows = 4 * n_tips - 6
    grid = wave_plan(max(words), sms)
    smem = 4 * 5 * rows
    shared = smem <= smem_limit
    return CommitPlan(grid, shared, smem if shared else 0)


@functools.lru_cache(maxsize=None)
def _limits(device_index: int):
    """(SMs, dynamic shared memory a P3 block may ask for) of a card."""
    lib = load_kernels()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        _check(lib, lib.stepwise_commit_limits(ctypes.byref(sms),
                                               ctypes.byref(smem)),
               "stepwise_commit_limits")
    return sms.value, smem.value


def plan_for(parts, n_tips: int) -> CommitPlan:
    """:func:`commit_plan` for ``parts`` on their card."""
    sms, smem = _limits(parts[0][0].device.index or 0)
    return commit_plan([v.shape[2] for v, _ in parts], n_tips, sms, smem)


def commit_workspace(plan: CommitPlan, n_parts: int, n_tips: int, device):
    """P3's device workspace for ``plan``: (the tables when not in shared
    memory, each block's share of the costs, the blocks' counter at 0).
    One workspace serves every launch of a build on one stream."""
    rows = 4 * n_tips - 6
    tables = torch.empty(0 if plan.shared
                         else plan.grid * 3 * rows,
                         dtype=torch.int32, device=device)
    chain = torch.empty(plan.grid * n_parts * rows, dtype=torch.int32,
                        device=device)
    return tables, chain, torch.zeros(1, dtype=torch.int32, device=device)


def stepwise_commit(parts, back, edge_rows, co1, co2, n_tips, *, mode,
                    scores=None, insertion=0, tip=0, plan=None, work=None):
    """P3: one step of the device-resident stepwise build (see
    :func:`stepwise_commit_plain` for ``mode``), in place on ``parts``'
    rows, ``back`` and ``edge_rows``; ``mode="final"`` returns int32 [P].
    ``plan`` (:func:`plan_for` when None) splits the words across blocks;
    ``work`` (:func:`commit_workspace`, made afresh when None) is the
    launch's device workspace.  Inputs stay on the card: no host read.
    CPU tensors take :func:`stepwise_commit_plain`."""
    _require(mode in STEP_MODES, f"mode {mode!r}")
    device = back.device
    D = 4 * n_tips - 6
    _require(n_tips >= 3 and 1 <= len(parts) <= MAX_PARTS,
             f"{n_tips} tips, {len(parts)} partitions (at most {MAX_PARTS})")
    for t, n in ((back, D), (co1, D), (co2, D), (edge_rows, 2 * n_tips - 3)):
        _require(t.dtype == torch.int32 and t.device == device
                 and t.is_contiguous() and t.numel() == n,
                 f"back/co1/co2 [{D}] and edge_rows [{2 * n_tips - 3}] "
                 f"int32 on {device}")
    for vec, cost in parts:
        _check_rows(vec, cost)
        _require(vec.shape[0] == D and vec.device == device,
                 f"partition rows {tuple(vec.shape)} on {vec.device}, want "
                 f"[{D}, S, W] on {device}")
    if mode == "insert":
        _require(3 <= insertion < n_tips and 0 <= tip < n_tips,
                 f"insertion {insertion} of tip {tip}")
        _require(scores is not None and scores.dtype == torch.int32
                 and scores.device == device and scores.is_contiguous()
                 and scores.numel() >= 2 * insertion - 3,
                 f"scores: at least {2 * insertion - 3} int32 on {device}")
    if device.type == "cpu":
        return stepwise_commit_plain(parts, back, edge_rows, co1, co2,
                                     n_tips, mode=mode, scores=scores,
                                     insertion=insertion, tip=tip)
    lib = load_kernels()
    n = len(parts)
    plan = plan or plan_for(parts, n_tips)
    if mode == "final":
        plan = plan._replace(grid=1)
    if work is None:
        work = commit_workspace(plan, n, n_tips, device)
    tables, chain, done = work
    _require(tables.numel() >= (0 if plan.shared else
                                plan.grid * 3 * D)
             and chain.numel() >= plan.grid * n * D
             and all(t.device == device and t.dtype == torch.int32
                     for t in work),
             "workspace smaller than the plan or not int32 on the card")
    vec_ptrs = (ctypes.c_int64 * n)(*(v.data_ptr() for v, _ in parts))
    cost_ptrs = (ctypes.c_int64 * n)(*(c.data_ptr() for _, c in parts))
    states = (ctypes.c_int32 * n)(*(v.shape[1] for v, _ in parts))
    words = (ctypes.c_int32 * n)(*(v.shape[2] for v, _ in parts))
    finals = (torch.empty(n, dtype=torch.int32, device=device)
              if mode == "final" else None)
    ptr = lambda a: ctypes.cast(a, ctypes.c_void_p)  # noqa: E731
    with torch.cuda.device(device):
        rc = lib.stepwise_commit(
            STEP_MODES[mode], n, ptr(vec_ptrs), ptr(cost_ptrs), ptr(states),
            ptr(words), n_tips,
            None if scores is None else scores.data_ptr(),
            2 * insertion - 3, n_tips + 3 * (insertion - 2), int(tip),
            back.data_ptr(), edge_rows.data_ptr(), co1.data_ptr(),
            co2.data_ptr(), plan.grid, int(plan.shared),
            tables.data_ptr() if tables.numel() else None, chain.data_ptr(),
            done.data_ptr(), None if finals is None else finals.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, rc, "stepwise_commit")
    stepwise_commit.launches += 1
    return finals


stepwise_commit.launches = 0


def stepwise_topology(order, device):
    """The star of the build on ``device``: (``back`` int32 [D] with the
    first three taxa of ``order`` linked to rows n..n+2 and -1 elsewhere,
    ``edge_rows`` int32 [2n-3] holding the star's three edges, ``co1``,
    ``co2``, n), the arguments :func:`stepwise_commit` takes first."""
    n = len(order)
    back = np.full(4 * n - 6, -1, np.int32)
    for k in range(3):
        back[n + k] = order[k]
        back[order[k]] = n + k
    edge_rows = np.zeros(2 * n - 3, np.int32)
    edge_rows[:3] = (n, n + 1, n + 2)
    return tuple(torch.from_numpy(t).to(device)
                 for t in (back, edge_rows, *_ring_co_tables(n))) + (n,)


def stepwise_build(parts, order, mesh=None):
    """The whole greedy build (JAX's ``_stepwise_build_body``) on ``parts``:
    [(vectors, costs)] per partition, ``4n - 6`` direction rows each with
    the tips' packed rows first; ``order`` the taxa's insertion order
    (host ints).  The star's refresh, then per insertion i one
    :func:`fitch_scores` per partition over the candidate edges
    ``edge_rows[:2i-3]`` (their sum is the score vector) and one
    :func:`stepwise_commit`, then the final scores: on the card all
    issued back to back with no host read.  Updates ``parts`` in place;
    returns (``back`` int32 [D], ``edge_rows`` int32 [2n-3], the final
    scores int32 [P]), on the parts' device.

    ``mesh``: the words are this rank's slice of the Fitch word axis
    (``search.stepwise.StepwiseBuilder.build_device_sharded``); each
    insertion's scores are summed across the ranks (``mesh.sum``, wrapping
    as uint32) between P2 and P3, before P3's argmin over the first 2i-3,
    and so are the final scores (JAX's ``psum``s, ``fitch.py:386-387``,
    ``:422-423``): every rank splices the same edges."""
    n = len(order)
    topo = stepwise_topology(order, parts[0][0].device)
    back, edge_rows = topo[0], topo[1]
    scores = torch.empty(2 * n - 3, dtype=torch.int32, device=back.device)
    kw = {}
    if back.device.type == "cuda":  # one plan and workspace a build
        plan = plan_for(parts, n)
        kw = dict(plan=plan, work=commit_workspace(plan, len(parts), n,
                                                   back.device))

    stepwise_commit(parts, *topo, mode="star", **kw)
    for i in range(3, n):
        ne = 2 * i - 3
        for k, (vecs, costs) in enumerate(parts):
            fitch_scores(vecs, costs, edge_rows[:ne], back=back,
                         tip=order[i], out=scores[:ne], accumulate=k > 0)
        if mesh is not None:
            scores[:ne] = mesh.sum(scores[:ne])
        stepwise_commit(parts, *topo, mode="insert", scores=scores,
                        insertion=i, tip=order[i], **kw)
    finals = stepwise_commit(parts, *topo, mode="final", **kw)
    return back, edge_rows, (finals if mesh is None else mesh.sum(finals))
