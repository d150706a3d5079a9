"""Full-tree Newton–Raphson branch-length optimisation with CLV reuse.

Counterpart: ``libpll_tpu/engine/blopt.py`` (``MIN_BL, MAX_BL`` ``:37``,
``_newton_edge`` ``:40``, ``optimize_branch_lengths`` ``:74``,
``make_sweep_program`` ``:180``, ``optimize_branch_lengths_scan``
``:322``), the reference's per-branch pattern (``examples/newton/
newton.c:31-100``: one sumtable per branch, then Newton on it) over all
2n−3 edges:

  * edges are visited in pre-order, so consecutive evaluation roots are
    adjacent and the dirty-subtree machinery (``tree/incremental.py``)
    re-orients only O(1) CLVs per step on average (the reference's
    partial-traversal trick, ``examples/partial-traversal/partial.c:61-
    104``);
  * the re-orientation ops run on the Partition's executor, kernel U1 on
    the card (``ops.clv.replay_ops``), padded to a fixed capacity as JAX
    pads them for its one compiled executor;
  * the Newton iteration is kernel N1 (``ops.derivatives.newton_solve``)
    with blopt's step ``d1/|d2|`` (``abs_d2=True``), which keeps the step
    downhill where d2 <= 0; JAX's is one ``lax.while_loop``.

Lengths are clamped to [MIN_BL, MAX_BL], and a Newton step that would
lower the likelihood backtracks, then keeps the old length.

:func:`optimize_branch_lengths` is the per-edge host loop (a host read an
edge, for the acceptance).  :func:`make_sweep_program` runs a whole sweep
with no host read: every edge's re-orientation table, edge rows and start
length are device tensors, and each edge is U1, the sumtable and N1
(``newton_solve_rows``), the new P-matrix and the edge logL under the new
and the old matrix, accepted by ``torch.where``; :meth:`SweepProgram.
graphed` captures that sweep in a CUDA graph.  JAX jit-compiles the same
sweep as one ``lax.scan``.  :func:`optimize_branch_lengths_scan` drives
it.

On CPU tensors every step takes its plain version (the Partition's plain
executors, N1's plain twin).

On a sharded Partition (``parallel.mesh.shard_partition``) each rank
replays its own sites and every sum over sites meets the other ranks' in
the mesh's reduction: a Newton body's (d1, d2)
(``ops.derivatives.newton_solve_mesh``: N1's derivative mode, one
reduction and one host round trip a body) and an edge's two logLs (one
reduction).  Every rank then takes the same steps and the same
acceptances.  No CUDA graph under a mesh: a collective cannot be captured
in one, so ``graphed=True`` and :meth:`SweepProgram.graphed` raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..errors import CapacityError, EinvalError, ParamError
from ..ops import clv as clv_ops
from ..ops import derivatives as deriv_ops
from ..ops import likelihood as lk_ops
from ..ops.pmatrix import compute_pmatrices
from ..tree import incremental as inc
from ..tree import utree as ut
from ..utils.constants import SCALE_NONE, SCALE_PER_RATE

MIN_BL, MAX_BL = deriv_ops.MIN_T, deriv_ops.MAX_T  # 1e-8, 100


def _newton_edge(sumtable, t0, rates, prop_invar_pc, evals_pc, freqs_pc,
                 rate_weights, invariant, pattern_weights, sp_site=None,
                 sc_site=None, *, sites, mesh=None, bodies=None):
    """Newton with blopt's step on one edge's sumtable -> t* (0-dim tensor):
    N1 on the card, its plain twin on the CPU.  ``t0``: one element in the
    sumtable's dtype; ``sp_site``, ``sc_site`` the per-site scalers (None:
    zeros, as blopt passes them).  ``mesh``: the sites are this rank's
    shard (``ops.derivatives.newton_solve_mesh``, its derivative bodies
    kept in ``bodies`` across the caller's edges)."""
    if mesh is not None:
        return deriv_ops.newton_solve_mesh(
            mesh, sumtable, t0, rates, prop_invar_pc, evals_pc, freqs_pc,
            rate_weights, invariant, pattern_weights, sites=sites,
            abs_d2=True, bodies=bodies).t
    return deriv_ops.newton_solve(
        sumtable, t0, rates, prop_invar_pc, evals_pc, freqs_pc, rate_weights,
        invariant, pattern_weights, sp_site, sc_site, sites=sites,
        asc_mode=lk_ops.ASC_NONE, abs_d2=True).t


def _edge_logl(part, u, params_indices):
    return part.compute_edge_loglikelihood(
        u.clv_index, u.scaler_index, u.back.clv_index, u.back.scaler_index,
        u.pmatrix_index, params_indices)


def _edges(root, edges=None):
    """The evaluation side ``u`` of each edge in pre-order, each edge once
    (an edge's inner end; ``edges``: only these pmatrix indices)."""
    seen = set()
    for node in ut.traverse(root, ut.TRAVERSE_PREORDER):
        if node.pmatrix_index in seen:
            continue
        seen.add(node.pmatrix_index)
        if edges is not None and node.pmatrix_index not in edges:
            continue
        yield node if not node.is_tip else node.back


def _full_evaluation(tree, part, pidx):
    """P-matrices and CLVs of the whole tree, validity flags set; returns
    the root edge's logL."""
    trav = ut.traverse(tree.root)
    ops, blens, midx = ut.create_operations(trav)
    part.update_prob_matrices(pidx, midx, blens)
    part.update_partials(ops)
    inc.mark_valid(trav)
    return _edge_logl(part, tree.root, pidx)


def optimize_branch_lengths(tree, part, params_indices, *,
                            max_sweeps: int = 8, tol: float = 1e-6,
                            pad_to: Optional[int] = None
                            ) -> Tuple[float, int]:
    """Optimise every branch length in place; returns (final logL, sweeps
    used).  ``part`` must hold the model for ``tree`` (tips set, params
    set); CLVs are (re)computed here."""
    if max_sweeps < 1:
        raise ParamError("max_sweeps must be >= 1")
    root = tree.root
    pidx = list(params_indices)
    np_pidx = np.asarray(pidx, np.int64)
    # start small: per-step dirty subsets are O(1) on the pre-order sweep;
    # grow on demand instead of padding every step to the full schedule
    cap = pad_to or 32
    logl = _full_evaluation(tree, part, pidx)
    bodies = {}  # N1's derivative bodies under a mesh, kept across edges

    for sweep in range(max_sweeps):
        max_delta = 0.0
        for u in _edges(root):
            if u.is_tip:
                continue  # 2-tip edge cannot occur in an unrooted tree

            # re-orient: recompute only the CLVs invalid for this rooting
            pops = inc.create_partial_operations(inc.partial_traverse(u))
            if pops:
                if len(pops) > cap:
                    cap = 1 << (len(pops) - 1).bit_length()
                part.update_partials(pops, pad_to=cap)

            st = part.update_sumtable(u.clv_index, u.back.clv_index,
                                      u.scaler_index, u.back.scaler_index,
                                      pidx)
            # site scalers cancel in d1 = -L'/L (and per-rate scalers are
            # folded into the sumtable), so the derivatives see zeros
            t_star = float(_newton_edge(
                st, part._t([u.length]), part._param("rates"),
                part._pinv_pc(pidx), part._param("eigenvals", np_pidx),
                part._freqs_pc(pidx), part._param("rate_weights"),
                part._invariant_arr(), part._pattern_weights_arr(),
                sites=part.sites, mesh=part.mesh, bodies=bodies))

            if not np.isfinite(t_star):
                continue
            old = u.length
            # safeguarded acceptance with backtracking: keep the best
            # non-worsening candidate on the segment [old, t*]
            accepted = None
            cand = t_star
            for _ in range(4):
                part.update_prob_matrices(pidx, [u.pmatrix_index], [cand])
                new_logl = _edge_logl(part, u, pidx)
                if new_logl + 1e-12 >= logl:
                    accepted = (cand, new_logl)
                    break
                cand = 0.5 * (cand + old)
            if accepted is None:
                part.update_prob_matrices(pidx, [u.pmatrix_index], [old])
                continue
            t_acc, new_logl = accepted
            u.length = u.back.length = t_acc
            inc.invalidate_edge(u)
            logl = new_logl
            max_delta = max(max_delta, abs(t_acc - old))
        if max_delta < tol:
            break

    # final consistent evaluation at the canonical root
    pops = inc.create_partial_operations(inc.partial_traverse(root))
    if pops:
        part.update_partials(pops, pad_to=max(
            cap, 1 << (len(pops) - 1).bit_length()))
    logl = _edge_logl(part, root, pidx)
    return float(logl), sweep + 1


# ---------------------------------------------------------------------------
# the whole sweep with no host read
# ---------------------------------------------------------------------------
class SweepProgram:
    """One branch-length sweep over a table of edges (counterpart
    ``make_sweep_program``'s jitted ``sweep``).  Per edge it replays the
    edge's padded re-orientation op table into the live buffers (U1),
    forms the sumtable and runs Newton with blopt's step
    (``newton_solve_rows``, N1), computes the P-matrix at t*, and keeps it
    only if the edge logL does not drop; a rejection leaves the P-matrix
    untouched, and the host's later op tables stay valid because
    recomputing an op is idempotent.

    ``program(clv, scalers, pmatrix, model, tables [E, K, 8] int32,
    erows [E, 5] int32, t0s [E]) -> (clv, scalers, pmatrix, t_out [E],
    logl [E])``, updating the three buffers in place; ``erows`` =
    (parent_clv, parent_scaler_row, child_clv, child_scaler_row,
    pmatrix_index), scaler row ``n_scale_buffers`` the zero dummy.  Every
    tensor lies on one device; on the card the sweep reads nothing back to
    the host.  ``mesh``: the sites are this rank's shard; each Newton body
    and each edge's pair of logLs is then reduced across the ranks (host
    reads)."""

    def __init__(self, *, sites: int, scale_mode: int, mesh=None):
        self.sites = sites
        self.scale_mode = scale_mode
        self.mesh = mesh
        self.bodies = {}  # N1's derivative bodies under a mesh, by shape

    def __call__(self, clv, scalers, pmatrix, model, tables, erows, t0s):
        dtype = clv.dtype
        sites, scale_mode = self.sites, self.scale_mode
        per_rate = scale_mode == SCALE_PER_RATE
        freqs_pc = model["freqs_pc"].to(dtype)
        rw = model["rate_weights"].to(dtype)
        pw = model["pattern_weights"].to(dtype)
        pidx = model["params_indices"]
        left, right = model["left"].to(dtype), model["right"].to(dtype)
        evals = model["eigenvals"].to(dtype)
        left_pc, right_pc = left[pidx.long()], right[pidx.long()]
        evals_pc = evals[pidx.long()]
        rates = model["rates"].to(dtype)
        prop_invar = model["prop_invar"].to(dtype)
        pinv_pc = model["prop_invar_pc"].to(dtype)
        invariant = model["invariant"]
        er = erows.long()
        row_idx, scal_idx, mat_idx = er[:, 0:3:2], er[:, 1:4:2], er[:, 4:5]
        if scale_mode == SCALE_NONE:
            zeros = torch.zeros((2,) + tuple(scalers.shape[1:]),
                                dtype=scalers.dtype, device=scalers.device)

        ts, logls = [], []
        for e in range(tables.shape[0]):
            clv_ops.replay_ops(clv, scalers, tables[e], pmatrix, scale_mode)
            rows = clv.index_select(0, row_idx[e])  # parent, child
            srows = (zeros if scale_mode == SCALE_NONE
                     else scalers.index_select(0, scal_idx[e]))
            t0 = t0s[e:e + 1]
            rscal = ((srows[0], srows[1]) if per_rate else (None, None))
            if self.mesh is None:
                t_star = deriv_ops.newton_solve_rows(
                    rows[0], rows[1], *rscal, freqs_pc, left_pc, right_pc,
                    t0, rates, pinv_pc, evals_pc, rw, invariant, pw,
                    per_rate=per_rate, sites=sites,
                    asc_mode=lk_ops.ASC_NONE, abs_d2=True).t
            else:
                t_star = _newton_edge(
                    deriv_ops.update_sumtable(rows[0], rows[1], *rscal,
                                              freqs_pc, left_pc, right_pc,
                                              per_rate=per_rate),
                    t0, rates, pinv_pc, evals_pc, freqs_pc, rw, invariant,
                    pw, sites=sites, mesh=self.mesh, bodies=self.bodies)
            pm_new = compute_pmatrices(t_star.reshape(1), rates, prop_invar,
                                       pidx, evals, left, right,
                                       dtype=dtype)[0]
            pm_old = pmatrix.index_select(0, mat_idx[e])[0]

            def elogl(pm_row):
                logl, _ = lk_ops.edge_loglikelihood(
                    rows[0], rows[1], srows[0], srows[1], pm_row, freqs_pc,
                    rw, pw, pinv_pc, invariant, sites=sites,
                    per_rate=per_rate, asc_mode=lk_ops.ASC_NONE)
                return logl

            l_new, l_old = elogl(pm_new), elogl(pm_old)
            if self.mesh is not None:
                l_new, l_old = self.mesh.sum(torch.stack([l_new, l_old]))
            accept = l_new >= l_old
            pmatrix.index_copy_(0, mat_idx[e],
                                torch.where(accept, pm_new, pm_old)[None])
            ts.append(torch.where(accept, t_star, t0[0]))
            logls.append(torch.maximum(l_new, l_old))
        return clv, scalers, pmatrix, torch.stack(ts), torch.stack(logls)

    def graphed(self, clv, scalers, pmatrix, model, tables, erows, t0s
                ) -> "GraphedSweep":
        """This sweep captured in a CUDA graph for these buffers and this
        envelope (edge count, table capacity): :class:`GraphedSweep`.
        Raises under a mesh."""
        return GraphedSweep(self, clv, scalers, pmatrix, model, tables,
                            erows, t0s)


class GraphedSweep:
    """A :class:`SweepProgram` call captured once in a CUDA graph and
    replayed, the counterpart of JAX's single jitted dispatch a sweep.

    The graph updates the ``clv``, ``scalers`` and ``pmatrix`` it was
    captured with (a Partition's own buffers) in place.
    ``graphed(model, tables, erows, t0s)`` copies each input into the
    graph's static buffer (``graphed.model``, ``.tables``, ``.erows``,
    ``.t0s``), replays, and returns ``(t_out, logl)``, overwritten by the
    next replay; the inputs keep the captured shapes.  The warm-up before
    the capture runs on copies of the three buffers, so building the graph
    changes no state (it holds a second copy of them for that moment).  A
    replay launches U1 and N1 without passing through their wrappers: the
    launch counters count the capture, not the replays."""

    def __init__(self, program: SweepProgram, clv, scalers, pmatrix, model,
                 tables, erows, t0s):
        device = clv.device
        if program.mesh is not None:
            raise EinvalError("no CUDA graph under a mesh: a collective "
                              "cannot be captured in one")
        if device.type != "cuda":
            raise EinvalError(f"a CUDA graph takes CUDA tensors, not {device}")
        self.model = {k: v.clone() for k, v in model.items()}
        self.tables, self.erows, self.t0s = (tables.clone(), erows.clone(),
                                             t0s.clone())
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # kernel loads, plans, handles
            program(clv.clone(), scalers.clone(), pmatrix.clone(), self.model,
                    self.tables, self.erows, self.t0s)
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = program(clv, scalers, pmatrix, self.model,
                               self.tables, self.erows, self.t0s)[3:]

    def __call__(self, model, tables, erows, t0s):
        from .evaluate import copy_to_static

        copy_to_static([(self.model[k], v) for k, v in model.items()]
                       + [(self.tables, tables), (self.erows, erows),
                          (self.t0s, t0s)])
        self.graph.replay()
        return self.out


def make_sweep_program(n_nodes: int, n_scale_buffers: int, capacity: int,
                       *, sites: int, scale_mode: int,
                       mesh=None) -> SweepProgram:
    """The whole branch-length sweep as one program with no host read
    (counterpart ``blopt.py:180``, one ``lax.scan`` over edges):
    :class:`SweepProgram`.  ``n_nodes``, ``n_scale_buffers`` and
    ``capacity`` are JAX's static shapes, kept for its signature; here the
    tensors a call takes carry them.  ``mesh``: a sharded Partition's (its
    ``sites`` then the rank's)."""
    return SweepProgram(sites=sites, scale_mode=scale_mode, mesh=mesh)


def _stand_in(u):
    """An idempotent op for an edge with nothing to re-orient: recompute
    ``u`` from its children."""
    from .partition import Operation

    return Operation(u.clv_index, u.scaler_index,
                     u.next.back.clv_index, u.next.back.pmatrix_index,
                     u.next.back.scaler_index, u.next.next.back.clv_index,
                     u.next.next.back.pmatrix_index,
                     u.next.next.back.scaler_index)


def sweep_tables(root, n_scale_buffers: int, *, edges=None,
                 edge_pad: Optional[int] = None,
                 capacity: Optional[int] = None):
    """One sweep's inputs, by the host's replay of the flag dynamics under
    assume-accept: every edge's re-orientation op table padded to one
    capacity, its rows and its start length, in pre-order; ``edges`` and
    ``edge_pad`` as :func:`optimize_branch_lengths_scan`'s.  Flips the
    tree's validity flags as the sweep will leave them.  Returns (tables
    [E, K, 8] int32, erows [E, 5] int32, t0s [E] float64, edges before
    padding), or None for an empty subset."""
    from .partition import operations_to_array
    from ..ops.incremental import pad_op_table

    NS = n_scale_buffers

    def srow(si):
        return NS if si < 0 else si

    tables, erows, t0s = [], [], []
    for u in _edges(root, edges):
        pops = inc.create_partial_operations(inc.partial_traverse(u))
        tables.append(operations_to_array(pops or [_stand_in(u)], NS))
        erows.append((u.clv_index, srow(u.scaler_index), u.back.clv_index,
                      srow(u.back.scaler_index), u.pmatrix_index))
        t0s.append(u.length)
        inc.invalidate_edge(u)  # assume accepted
    if not tables:
        return None
    n_real = len(tables)
    if edge_pad is not None:
        if n_real > edge_pad:
            raise CapacityError(
                f"edge subset ({n_real}) exceeds edge_pad ({edge_pad})")
        tables += [tables[n_real - 1]] * (edge_pad - n_real)
        erows += [erows[n_real - 1]] * (edge_pad - n_real)
        t0s += [t0s[n_real - 1]] * (edge_pad - n_real)
    cap = capacity or max(
        8, 1 << (max(t.shape[0] for t in tables) - 1).bit_length())
    return (np.stack([pad_op_table(t, cap) for t in tables]),
            np.asarray(erows, np.int32), np.asarray(t0s, np.float64), n_real)


def optimize_branch_lengths_scan(tree, part, params_indices, *,
                                 max_sweeps: int = 8, tol: float = 1e-6,
                                 capacity: Optional[int] = None,
                                 program=None, edges=None,
                                 edge_pad: Optional[int] = None,
                                 graphed: bool = False):
    """Branch-length optimisation a whole sweep at a time on the device
    (:class:`SweepProgram`, in place of ~4 host round trips an edge in
    :func:`optimize_branch_lengths`).  Per sweep the host replays the flag
    dynamics to precompute every edge's re-orientation op table (all data:
    ``program`` can be reused across sweeps and trees).  Returns (final
    logL, sweeps used).

    ``edges`` (a set of pmatrix indices) restricts the sweep to a subset,
    the local pass after a topology move (the reference's
    ``pll_utree_spr`` hands back the changed branches for this,
    ``utree_moves.c:204-251``).  ``edge_pad`` pads the edge axis to a fixed
    count by repeating the last edge; repeats are harmless (replaying an op
    table is idempotent and acceptance is monotone).  Raises
    :class:`CapacityError` if the subset exceeds ``edge_pad``.
    ``graphed``: run each sweep as a CUDA graph replay
    (:meth:`SweepProgram.graphed`; the card only): one capture, again only
    when a sweep's tables outgrow the graph's capacity (smaller ones are
    padded to it).  A second sweep's first edge re-orients the tree back
    towards the root, so its tables usually need more than the first
    sweep's; a ``capacity`` that holds both captures once."""
    from .evaluate import partition_model

    if max_sweeps < 1:
        raise ParamError("max_sweeps must be >= 1")
    if graphed and part.mesh is not None:
        raise EinvalError("graphed=True on a sharded Partition: a "
                          "collective cannot be captured in a CUDA graph")
    if (program is not None
            and getattr(program, "mesh", None) is not part.mesh):
        raise EinvalError("the sweep program was made for another mesh "
                          "than the Partition's")
    root = tree.root
    pidx = list(params_indices)
    logl = _full_evaluation(tree, part, pidx)
    model = partition_model(part, pidx)
    graph = None
    last_logl = logl
    for sweep_i in range(max_sweeps):
        inputs = sweep_tables(root, part.scale_buffers, edges=edges,
                              edge_pad=edge_pad, capacity=capacity)
        if inputs is None:
            break  # empty subset: nothing to optimise
        tab = inputs[0]
        if graphed and graph is not None and graph.tables.shape[0] == len(
                tab) and graph.tables.shape[1] > tab.shape[1]:
            # pad to the graph's capacity (repeats are idempotent)
            tab = np.concatenate([tab, np.repeat(
                tab[:, -1:], graph.tables.shape[1] - tab.shape[1], 1)], 1)
        dev = part.device
        tab, er = (torch.from_numpy(a).to(dev) for a in (tab, inputs[1]))
        t0 = torch.from_numpy(inputs[2]).to(dev, part.dtype)
        n_real = inputs[3]
        if program is None:
            program = make_sweep_program(part.nodes, part.scale_buffers,
                                         tab.shape[1], sites=part.sites,
                                         scale_mode=part.scale_mode,
                                         mesh=part.mesh)
        if graphed:
            if graph is None or graph.tables.shape != tab.shape:
                graph = program.graphed(part.clv, part.scalers,
                                        part.pmatrix, model, tab, er, t0)
            ts, logls = graph(model, tab, er, t0)
        else:
            _, _, _, ts, logls = program(part.clv, part.scalers,
                                         part.pmatrix, model, tab, er, t0)

        ts = ts.cpu().numpy()
        max_delta = 0.0
        k = 0
        for k, u in enumerate(_edges(root, edges), 1):
            max_delta = max(max_delta, abs(float(ts[k - 1]) - u.length))
            u.length = u.back.length = float(ts[k - 1])
        assert k == n_real, (k, n_real)
        logl = float(logls[-1])
        if max_delta < tol or logl <= last_logl + 1e-10:
            break
        last_logl = logl
    return logl, sweep_i + 1
