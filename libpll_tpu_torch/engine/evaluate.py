"""Full-tree evaluation: P-matrices → pruning sweep → log-likelihood.

Counterpart: ``libpll_tpu/engine/evaluate.py`` (``:31-335``).  The
``make_*`` factories keep their names and return ``nn.Module``s whose
forward takes the model dict (:func:`libpll_tpu_torch.engine.params.
model_from_numpy`) and the CLV or tip input.  Topology (the operation
schedule and the evaluation edge) is fixed when a module is built; its
index tables are buffers, so ``.to(device)`` moves the module, and a call
whose inputs lie on another device raises.

  * :func:`make_forward` — plain level sweep + edge logL (the float64
    reference path);
  * :func:`make_forward_fused` — K2 (``ops.clv_fused.fused_sweep``) + edge
    logL;
  * :func:`make_score` — K1 (``ops.clv_fused.fused_edge_score``), the
    tree-search scoring path, with +I in the kernel and asc-bias through
    :func:`make_asc_tail`; ``Score.graphed`` captures one call in a CUDA
    graph (:class:`GraphedCall`) for callers whose host, not the card,
    sets the pace;
  * :func:`make_score_unbounded` — K6 (``ops.clv_dyn.make_dyn_score``),
    the same scoring for trees of any size: the tree is cut into segments
    whose rows fit a device-memory budget, and tips are pattern tips;
  * :func:`make_score_sharded`, :func:`make_score_unbounded_sharded` — K1
    and K6 with the sites sharded across the ranks of a
    ``parallel.mesh.SitesMesh``: each rank scores its own sites and one
    reduction adds the partial logLs;
  * :func:`make_train_step_fused` — K2, the edge logL, the sumtable and
    the Newton solve of the evaluation edge's branch length (kernel N1,
    ``ops.derivatives.newton_solve``); :func:`make_train_step` the same
    on the plain level sweep;
  * :func:`model_from_partition` — a ``Partition``'s parameters as the
    model dict the factories take; :func:`partition_model` the same
    without branch lengths, in the Partition's dtype, as the branch-length
    sweep (``engine.blopt``) takes it.

Every factory builds its module on ``device``: the card when it is None
(a :class:`KernelError` without one), the CPU only when asked for.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..errors import EinvalError, KernelError
from ..ops import clv_dyn as cd
from ..ops import clv_fused as cf
from ..ops import derivatives as dv
from ..ops import likelihood as lk_ops
from ..ops.pmatrix import compute_pmatrices
from ..ops.sweep import LevelSchedule, build_level_schedule, make_level_sweep
from ..utils.constants import SCALE_PER_RATE, SCALE_PER_SITE


class EvalTopology(NamedTuple):
    """Static description of one evaluation: schedule + evaluation edge.

    CLV/scaler indices are in the *level-major* space of the schedule
    (see ops/sweep.py); ``topology_from_tree`` performs the translation from
    the reference index conventions.
    """

    schedule: LevelSchedule
    matrix_indices: np.ndarray  # [B] int32
    n_pmatrices: int
    parent_clv: int
    child_clv: int
    edge_matrix: int
    sites: int
    scale_mode: int = SCALE_PER_SITE
    asc_mode: int = 0

    @property
    def dummy_scaler(self) -> int:
        return self.schedule.n_inner

    def scaler_row(self, clv_row: int) -> int:
        return (clv_row - self.schedule.tips
                if clv_row >= self.schedule.tips else self.dummy_scaler)


def topology_from_tree(tree, sites, scale_mode=SCALE_PER_SITE, asc_mode=0):
    """Static evaluation description from a UTree; returns (topo, branches)."""
    from ..tree import utree as ut

    trav = ut.traverse(tree.root)
    ops, branches, pmat_idx = ut.create_operations(trav)
    schedule = build_level_schedule(ops, tree.tip_count)
    root = tree.root

    return EvalTopology(
        schedule=schedule,
        matrix_indices=np.asarray(pmat_idx, dtype=np.int32),
        n_pmatrices=len(branches),
        parent_clv=schedule.clv_map[root.clv_index],
        child_clv=schedule.clv_map[root.back.clv_index],
        edge_matrix=root.pmatrix_index,
        sites=sites,
        scale_mode=scale_mode,
        asc_mode=asc_mode,
    ), np.asarray(branches)


def _pmatrices(model, topo, dtype, matrix_indices):
    """[n_pmatrices, C, S, S] with each branch's matrix at its reference
    pmatrix index (``matrix_indices``: the topology's, on the device)."""
    pmat = compute_pmatrices(
        model["branch_lengths"], model["rates"], model["prop_invar"],
        model["params_indices"], model["eigenvals"], model["left"],
        model["right"], dtype=dtype)
    pmatrix = pmat.new_zeros((topo.n_pmatrices,) + pmat.shape[1:])
    pmatrix[matrix_indices] = pmat
    return pmatrix


def model_from_partition(partition, branches, params_indices=None,
                         dtype=None, *, device=None) -> dict:
    """The model dict of the ``make_*`` modules from a Partition's
    parameter state (counterpart ``evaluate.py:90``), as tensors on
    ``device`` (None: the card, a KernelError without one).

    ``branches``: branch lengths in traversal order (from
    create_operations).  ``params_indices``: per-category rate-matrix
    indices (defaults to all zeros).  ``dtype`` defaults to float32 (the
    fused kernels' fast path).  The eigen factors are recomputed for
    every rate matrix, as JAX does."""
    from ..models.gtr import eigen_decompose
    from .params import model_from_numpy

    C = partition.rate_cats
    pidx = np.zeros(C, np.int32) if params_indices is None else \
        np.asarray(params_indices, np.int32)
    eigen = [eigen_decompose(partition.subst_params[k],
                             partition.frequencies[k])
             for k in range(partition.rate_matrices)]
    invariant = (np.full(partition.sites_alloc, -1, np.int32)
                 if partition.invariant is None else partition.invariant)
    f64 = lambda a: np.asarray(a, np.float64)  # noqa: E731
    return model_from_numpy({
        "branch_lengths": f64(branches),
        "rates": f64(partition.rates),
        "prop_invar": f64(partition.prop_invar),
        "params_indices": pidx,
        "eigenvals": f64([w for w, _, _ in eigen]),
        "left": f64([left for _, left, _ in eigen]),
        "right": f64([right for _, _, right in eigen]),
        "freqs_pc": f64(partition.frequencies[pidx]),
        "prop_invar_pc": f64(partition.prop_invar[pidx]),
        "rate_weights": f64(partition.rate_weights),
        "pattern_weights": f64(partition.pattern_weights),
        "invariant": invariant.astype(np.int32),
    }, _resolve_device(device), dtype or torch.float32)


def partition_model(part, params_indices) -> dict:
    """The model dict of a Partition's parameter state, without branch
    lengths, as tensors in its dtype on its device (counterpart
    ``libpll_tpu/search/spr.py:80 _model_from_partition``): the eigen
    factors are the Partition's own, brought up to date for the
    categories' rate matrices."""
    pidx = np.asarray(params_indices, np.int32).reshape(part.rate_cats)
    for idx in np.unique(pidx):
        if not part.eigen_valid[idx]:
            part.update_eigen(int(idx))
    return {
        "rates": part._param("rates"),
        "prop_invar": part._param("prop_invar"),
        "params_indices": part._t(pidx, torch.int32),
        "eigenvals": part._param("eigenvals"),
        "left": part._param("eigen_left"),
        "right": part._param("eigen_right"),
        "freqs_pc": part._freqs_pc(pidx),
        "prop_invar_pc": part._pinv_pc(pidx),
        "rate_weights": part._param("rate_weights"),
        "pattern_weights": part._pattern_weights_arr(),
        "invariant": part._invariant_arr(),
    }


def _floats(model, dtype):
    """The model's per-category and per-site vectors in the working dtype."""
    return {k: model[k].to(dtype)
            for k in ("freqs_pc", "rate_weights", "pattern_weights",
                      "prop_invar_pc")}


def _resolve_device(device=None) -> torch.device:
    """The device a module is built on: the card when ``device`` is None;
    a CUDA device without a card raises :class:`KernelError` (no fallback
    to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise KernelError("no CUDA card: pass device='cpu' to build the "
                          "module on the CPU (plain versions of the kernels)")
    return device


class _TopologyModule(nn.Module):
    """Holds one evaluation topology; its device is that of its buffers
    (built on :func:`_resolve_device` of ``device``)."""

    def __init__(self, topo: EvalTopology, device=None):
        super().__init__()
        self.topo = topo
        self.register_buffer(
            "matrix_indices",
            torch.as_tensor(topo.matrix_indices, dtype=torch.long,
                            device=_resolve_device(device)),
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.matrix_indices.device

    def _check_device(self, model, *tensors):
        for t in (*model.values(), *tensors):
            if isinstance(t, torch.Tensor) and t.device != self.device:
                raise EinvalError(f"input on {t.device}, module on "
                                  f"{self.device}: move one with .to()")

    def pmatrices(self, model, dtype):
        return _pmatrices(model, self.topo, dtype, self.matrix_indices)


class Forward(_TopologyModule):
    """``forward(model, clv, scalers) -> (logl, persite)``: the plain
    level sweep and edge log-likelihood (counterpart ``make_forward``).

    clv: [tips + n_inner, C, S, L] level-major; scalers [n_inner+1, (C,) L].
    """

    def __init__(self, topo: EvalTopology, device=None):
        super().__init__(topo, device)
        self.sweep = make_level_sweep(topo.schedule, topo.scale_mode)

    def forward(self, model, clv, scalers):
        return self.swept(model, clv, scalers)[:2]

    def swept(self, model, clv, scalers):
        """``(logl, persite, clv, scalers)``, the CLVs and scalers after
        the sweep."""
        self._check_device(model, clv, scalers)
        topo = self.topo
        pmatrix = self.pmatrices(model, clv.dtype)
        clv, scalers = self.sweep(clv, scalers, pmatrix)
        f = _floats(model, clv.dtype)
        logl, persite = lk_ops.edge_loglikelihood(
            clv[topo.parent_clv], clv[topo.child_clv],
            scalers[topo.scaler_row(topo.parent_clv)],
            scalers[topo.scaler_row(topo.child_clv)],
            pmatrix[topo.edge_matrix], f["freqs_pc"], f["rate_weights"],
            f["pattern_weights"], f["prop_invar_pc"], model["invariant"],
            sites=topo.sites, per_rate=topo.scale_mode == SCALE_PER_RATE,
            asc_mode=topo.asc_mode)
        return logl, persite, clv, scalers


def make_forward(topo: EvalTopology, *, device=None) -> Forward:
    """Build the float64 reference forward (``evaluate.py:138``)."""
    return Forward(topo, device)


def _working_dtype(model, tips_packed, tip_encoding):
    return (model["freqs_pc"].dtype if tip_encoding in ("chars", "masks")
            else tips_packed.dtype)


class ForwardFused(_TopologyModule):
    """``forward(model, tips_packed) -> (logl, persite, inner, scalers)``:
    P-matrices → K2 → edge log-likelihood (counterpart
    ``make_forward_fused``).

    ``tips_packed``: [tips, C, S, L] tip CLVs ("clv"), pack_tipchars words
    ("chars") or [tips, L] int32 bitmasks ("masks"); the asc-bias pseudo
    columns, when asked for, ride the site axis.  ``inner`` [n_inner, C, S,
    L] and ``scalers`` are returned for reuse.
    """

    def __init__(self, topo, rate_cats, states, tip_encoding="clv",
                 device=None):
        super().__init__(topo, device)
        cf.check_tip_encoding(tip_encoding, states)
        self.rate_cats, self.states = rate_cats, states
        self.tip_encoding = tip_encoding
        # K2's walk, planned once per topology
        self.plan = cf.FusedPlan(topo.schedule, tip_encoding)

    def _row(self, tips_packed, inner, idx, dtype):
        tips = self.topo.schedule.tips
        if idx >= tips:
            return inner[idx - tips]
        rows = torch.arange(idx, idx + 1, device=tips_packed.device)
        return cf.decode_tips(tips_packed, self.tip_encoding, rows,
                              self.rate_cats, self.states, dtype)[0]

    def forward(self, model, tips_packed):
        self._check_device(model, tips_packed)
        topo = self.topo
        dtype = _working_dtype(model, tips_packed, self.tip_encoding)
        pmatrix = self.pmatrices(model, dtype)
        inner, scalers = cf.fused_sweep(
            topo.schedule, tips_packed, pmatrix, plan=self.plan,
            scale_mode=topo.scale_mode, tip_encoding=self.tip_encoding)
        f = _floats(model, dtype)
        logl, persite = lk_ops.edge_loglikelihood(
            self._row(tips_packed, inner, topo.parent_clv, dtype),
            self._row(tips_packed, inner, topo.child_clv, dtype),
            scalers[topo.scaler_row(topo.parent_clv)],
            scalers[topo.scaler_row(topo.child_clv)],
            pmatrix[topo.edge_matrix], f["freqs_pc"], f["rate_weights"],
            f["pattern_weights"], f["prop_invar_pc"], model["invariant"],
            sites=topo.sites, per_rate=topo.scale_mode == SCALE_PER_RATE,
            asc_mode=topo.asc_mode)
        return logl, persite, inner, scalers


def _check_impl(impl: str, mxu_precision: str = "highest") -> None:
    """JAX's kernel choice, taken for signature parity: the port has one
    contraction, in full float32 (or float64) precision.  JAX's "high"
    (bf16x3 on the TPU's matrix unit, within the float32 budget) is
    accepted and computed at "highest"; any other precision raises."""
    if impl not in ("auto", "vpu", "mxu"):
        raise EinvalError(f"unknown impl {impl!r}")
    if mxu_precision not in cd.MXU_PRECISIONS:
        raise EinvalError(f"mxu_precision {mxu_precision!r}: the port "
                          f"takes {cd.MXU_PRECISIONS}, both computed at "
                          "full precision ('highest')")


def make_forward_fused(topo: EvalTopology, rate_cats: int, states: int,
                       impl: str = "auto", *, tip_encoding: str = "clv",
                       device=None) -> ForwardFused:
    """Build the K2 forward (``evaluate.py:167``), with JAX's parameters
    in JAX's order (``impl`` checked, else ignored; ``interpret`` is not
    ported); unlike the JAX one it also takes pattern tips, as K2 does."""
    _check_impl(impl)
    return ForwardFused(topo, rate_cats, states, tip_encoding, device)


class AscTail(_TopologyModule):
    """``forward(model, pmatrix) -> correction``: the ascertainment-bias
    correction as a plain side sweep over the S all-one-state pseudo
    columns (reference `src/pll.c:490-495`), so the score kernel stays
    asc-free.  ``model`` carries ``asc_weights`` [S] (Lewis ignores them).
    Counterpart ``make_asc_tail``."""

    def __init__(self, topo, rate_cats, states, device=None):
        super().__init__(topo, device)
        self.rate_cats, self.states = rate_cats, states
        self.sweep = make_level_sweep(topo.schedule, topo.scale_mode)

    def forward(self, model, pmatrix):
        self._check_device(model, pmatrix)
        topo = self.topo
        c, s = self.rate_cats, self.states
        tips, n_inner = topo.schedule.tips, topo.schedule.n_inner
        per_rate = topo.scale_mode == SCALE_PER_RATE
        dtype = pmatrix.dtype
        eye = torch.eye(s, dtype=dtype, device=pmatrix.device)
        clv = torch.cat([eye[None, None].expand(tips, c, s, s),
                         pmatrix.new_zeros((n_inner, c, s, s))])
        sshape = (n_inner + 1, c, s) if per_rate else (n_inner + 1, s)
        clv, scalers = self.sweep(
            clv, torch.zeros(sshape, dtype=torch.int32,
                             device=pmatrix.device), pmatrix)

        f = _floats(model, dtype)
        termb = torch.matmul(pmatrix[topo.edge_matrix], clv[topo.child_clv])
        term_r = (clv[topo.parent_clv] * f["freqs_pc"][:, :, None]
                  * termb).sum(dim=1)
        comb = (scalers[topo.scaler_row(topo.parent_clv)]
                + scalers[topo.scaler_row(topo.child_clv)])
        if per_rate:
            site_scal, diff = lk_ops.fold_rate_scalers(comb)
            term_r = lk_ops.apply_rate_fold(term_r, diff, dtype)
        else:
            site_scal = comb
        return lk_ops.asc_correction_terms(
            term_r, site_scal, f["rate_weights"],
            model["asc_weights"].to(dtype), f["pattern_weights"].sum(),
            topo.asc_mode, dtype)


def make_asc_tail(topo: EvalTopology, rate_cats: int, states: int, *,
                  device=None) -> AscTail:
    """Build the asc-bias side sweep (``evaluate.py:219``)."""
    return AscTail(topo, rate_cats, states, device)


def _pinv_score_inputs(model, dtype):
    """(weight_vec, inv_add) for the linear in-kernel prop-invar fold:
    ``Σ_c w_c[(1-p_c)·term_c + p_c·f_c[inv]]`` splits into a re-scaled
    weight vector and a per-site additive term [L] (reference mix order,
    `src/core_likelihood.c:960-978`: the invariant likelihood enters
    unscaled)."""
    f = _floats(model, dtype)
    freqs, pinv, rw = f["freqs_pc"], f["prop_invar_pc"], f["rate_weights"]
    inv = model["invariant"]
    wvec = cf.pack_weight_vec(freqs * (1.0 - pinv)[:, None], rw)
    has = inv >= 0
    inv_lk = torch.where(has[None, :], freqs[:, torch.clamp(inv, min=0).long()],
                         torch.zeros((), dtype=dtype, device=freqs.device))
    inv_add = ((rw * pinv)[:, None] * inv_lk).sum(dim=0)
    return wvec, inv_add


class Score(_TopologyModule):
    """``forward(model, tips_packed) -> logl`` (float64): P-matrices → K1,
    the whole sweep with the edge log-likelihood folded in (counterpart
    ``make_score``).  Per-site or no scaling; +I through the in-kernel
    linear fold (``use_pinv``); asc-bias (``topo.asc_mode``) through
    :class:`AscTail`.  ``tips_packed`` as in :class:`ForwardFused`."""

    def __init__(self, topo, rate_cats, states, use_pinv=False,
                 tip_encoding="clv", device=None):
        super().__init__(topo, device)
        if topo.asc_mode and use_pinv:
            raise EinvalError("asc-bias and prop-invar are mutually exclusive")
        cf.check_score_scope(topo.schedule, topo.scale_mode, topo.parent_clv)
        cf.check_tip_encoding(tip_encoding, states)
        self.use_pinv = use_pinv
        self.tip_encoding = tip_encoding
        # K1's walk, planned once per topology and edge
        self.plan = cf.FusedPlan(topo.schedule, tip_encoding,
                                 (topo.parent_clv, topo.child_clv,
                                  topo.edge_matrix))
        self.asc_tail = (AscTail(topo, rate_cats, states, self.device)
                         if topo.asc_mode else None)

    def forward(self, model, tips_packed):
        self._check_device(model, tips_packed)
        topo = self.topo
        dtype = _working_dtype(model, tips_packed, self.tip_encoding)
        pmatrix = self.pmatrices(model, dtype)
        f = _floats(model, dtype)
        if self.use_pinv:
            wvec, inv_add = _pinv_score_inputs(model, dtype)
        else:
            wvec = cf.pack_weight_vec(f["freqs_pc"], f["rate_weights"])
            inv_add = None
        logl = cf.fused_edge_score(
            topo.schedule, tips_packed, pmatrix, wvec, f["pattern_weights"],
            inv_add, plan=self.plan, parent_clv=topo.parent_clv,
            child_clv=topo.child_clv, edge_matrix=topo.edge_matrix,
            scale_mode=topo.scale_mode, tip_encoding=self.tip_encoding)
        if self.asc_tail is not None:
            logl = logl + self.asc_tail(model, pmatrix)
        return logl

    def graphed(self, model, tips_packed) -> "GraphedCall":
        """This scorer's call on inputs shaped as ``model`` and
        ``tips_packed`` (CUDA tensors), captured in a CUDA graph."""
        return GraphedCall(self, model, tips_packed)


class GraphedCall:
    """One call of a module taking ``(model, tips_packed)`` (:class:`Score`,
    :class:`TrainStepFused`) captured in a CUDA graph and replayed, the
    counterpart of the JAX package's single jitted dispatch: the call's
    device work (P-matrices, the kernels, the float64 fold) replays as one
    graph, so the host issues a few input copies and one launch in place
    of the eager call's dozens of operations.  The capture fails if the
    call reads anything back to the host.

    ``graphed(model, tips_packed)`` copies each input that is not already
    the graph's own (``graphed.model``, ``graphed.tips``: update those in
    place to skip the copy) and replays; inputs keep the captured call's
    shapes, dtypes and device.  It returns the graph's output tensors,
    overwritten by the next replay.  A replay runs the kernels without
    passing through their wrappers, so the launch counters count the
    capture, not the replays."""

    def __init__(self, module: nn.Module, model, tips_packed):
        device = tips_packed.device
        if device.type != "cuda":
            raise EinvalError(f"a CUDA graph takes CUDA tensors, not {device}")
        self.module = module  # the graph reads its plans' device tables
        self.model = {k: v.clone() for k, v in model.items()}
        self.tips = tips_packed.clone()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):  # build, plan layout, cached tables
            module(self.model, self.tips)
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = module(self.model, self.tips)

    def __call__(self, model, tips_packed):
        copy_to_static([(self.model[k], v) for k, v in model.items()]
                       + [(self.tips, tips_packed)])
        self.graph.replay()
        return self.out


def copy_to_static(pairs) -> None:
    """Copy each ``(static, value)`` pair's value into a CUDA graph's static
    input (none where they are one tensor); raises where the shape, dtype
    or device differs from the captured one."""
    for static, value in pairs:
        if value is static:
            continue
        if (value.shape, value.dtype, value.device) != (
                static.shape, static.dtype, static.device):
            raise EinvalError(
                f"input {tuple(value.shape)} {value.dtype} on "
                f"{value.device}; the graph was captured with "
                f"{tuple(static.shape)} {static.dtype} on {static.device}")
        static.copy_(value)


def make_score(topo: EvalTopology, rate_cats: int, states: int,
               impl: str = "auto", use_pinv: bool = False,
               tip_encoding: str = "clv",
               mxu_precision: str = "highest", *, device=None) -> Score:
    """Build the K1 scorer (``evaluate.py:288``), with JAX's parameters in
    JAX's order (``impl`` checked, else ignored; ``mxu_precision``
    "highest" or "high", the latter computed at "highest";
    ``interpret`` is not ported)."""
    _check_impl(impl, mxu_precision)
    return Score(topo, rate_cats, states, use_pinv, tip_encoding, device)


class ScoreUnbounded(_TopologyModule):
    """``forward(model, return_partials=False) -> logl`` (float64):
    P-matrices → K6 over the tree's segments, tips baked in at build time
    (counterpart ``make_score_unbounded``, ``evaluate.py:451``).

    ``tips_packed``: the whole tree's pattern tips, ``clv_fused.
    pack_tipchars`` nibbles (``"chars"``) or [tips, L] int32 bitmasks
    (``"masks"``), copied to the module's device; its buffers follow
    ``.to()``.
    Segments take at most ``clv_dyn.dyn_max_rows`` rows at the tips' site
    count.  +I through the in-kernel linear fold, asc-bias through
    :class:`AscTail`.  ``return_partials`` returns the float64 partial
    sums of each 128-site block instead of their total."""

    def __init__(self, topo, rate_cats, states, tips_packed, tip_encoding,
                 use_pinv=False, mxu_precision="highest", device=None):
        super().__init__(topo, device)
        if topo.asc_mode and use_pinv:
            raise EinvalError("asc-bias and prop-invar are mutually exclusive")
        self.dyn = cd.build_dyn_schedule(
            topo.schedule, rate_cats=rate_cats, states=states,
            sites=tips_packed.shape[-1],
            ensure_rows=[topo.parent_clv, topo.child_clv])
        self.kernel = cd.make_dyn_score(
            self.dyn, topo.parent_clv, topo.child_clv, topo.edge_matrix,
            topo.scale_mode, rate_cats=rate_cats, states=states,
            tip_encoding=tip_encoding, use_pinv=use_pinv,
            mxu_precision=mxu_precision)
        self.use_pinv = use_pinv
        tables, m_ops, exp_tables = cd.dyn_score_args(self.dyn)
        for name, t in (("tips", tips_packed),
                        ("tables", torch.stack(tables)),
                        ("m_ops", torch.stack(m_ops)),
                        ("exp_tables", torch.stack(exp_tables))):
            self.register_buffer(name, t.to(self.device), persistent=False)
        self.asc_tail = (AscTail(topo, rate_cats, states, self.device)
                         if topo.asc_mode else None)

    def forward(self, model, return_partials=False):
        self._check_device(model, self.tips)
        dtype = model["freqs_pc"].dtype
        pmatrix = self.pmatrices(model, dtype)
        f = _floats(model, dtype)
        if self.use_pinv:
            wvec, inv_add = _pinv_score_inputs(model, dtype)
        else:
            wvec = cf.pack_weight_vec(f["freqs_pc"], f["rate_weights"])
            inv_add = None
        out = self.kernel(self.tips, self.tables, self.m_ops,
                          self.exp_tables, pmatrix, wvec,
                          f["pattern_weights"], inv_add,
                          return_partials=return_partials)
        if self.asc_tail is not None and not return_partials:
            out = out + self.asc_tail(model, pmatrix)
        return out


def make_score_unbounded(topo: EvalTopology, rate_cats: int, states: int,
                         tip_masks, use_pinv: bool = False,
                         mxu_precision: str = "highest", *, device=None
                         ) -> ScoreUnbounded:
    """Build the K6 scorer from [tips, sites] ambiguity bitmasks
    (``evaluate.py:451``): nibble-packed where DNA masks fit four bits,
    one int32 word per tip and site otherwise.  ``mxu_precision``
    "highest" or "high", the latter computed at "highest"."""
    enc, tips = _pattern_tips(np.asarray(tip_masks), states)
    return ScoreUnbounded(topo, rate_cats, states, tips, enc, use_pinv,
                          mxu_precision, device)


def _pattern_tips(masks: np.ndarray, states: int):
    """(encoding, packed tips) of [tips, sites] bitmasks for K6: nibbles
    where DNA masks fit four bits, else one int32 word a tip and site,
    which must fit 31 bits (JAX's guard, ``clv_pallas_dyn.py:235``)."""
    if states <= 4 and int(masks.max()) <= 0xF:
        return "chars", cf.pack_tipchars(masks)
    if int(masks.max()) > 0x7FFFFFFF or int(masks.min()) < 0:
        raise EinvalError("tip masks must fit 31 bits (states <= 31)")
    return "masks", torch.from_numpy(masks.astype(np.int32))


# ---------------------------------------------------------------------------
# site-sharded scoring: one rank per shard of the sites axis
# ---------------------------------------------------------------------------
class _Sharded(nn.Module):
    """A scorer over one rank's sites (``local``, asc-free) whose float64
    partial logL meets the other ranks' in one ``mesh.sum``; the asc tail
    (:class:`AscTail`, replicated) is added once, after the reduction.  The
    model is the whole alignment's: its pattern weights and invariant codes
    are cut to the rank's sites here."""

    def __init__(self, topo, rate_cats, states, mesh, local, device):
        super().__init__()
        if topo.sites % mesh.size:
            raise EinvalError(f"{topo.sites} sites do not divide "
                              f"{mesh.size} ranks: pad with pad_sites")
        self.topo, self.mesh, self.local = topo, mesh, local
        self.site_range = mesh.local(topo.sites)
        self.asc_tail = (AscTail(topo, rate_cats, states, device)
                         if topo.asc_mode else None)

    def _local_model(self, model):
        lo, hi = self.site_range
        out = dict(model)
        for k in ("pattern_weights", "invariant"):
            if model[k].shape[-1] != self.topo.sites:
                raise EinvalError(f"model {k} of {model[k].shape[-1]} "
                                  f"sites, topology of {self.topo.sites}")
            out[k] = model[k][lo:hi]
        return out

    def _reduced(self, model, partial, dtype):
        logl = self.mesh.sum(partial)
        if self.asc_tail is not None:
            logl = logl + self.asc_tail(model,
                                        self.local.pmatrices(model, dtype))
        return logl

    def graphed(self, *args):
        raise EinvalError("no CUDA graph under a mesh: a collective cannot "
                          "be captured in one")


class ScoreSharded(_Sharded):
    """``forward(model, tips_packed) -> logl`` (float64): K1 on this rank's
    sites, then one ``mesh.sum`` (counterpart ``make_score_sharded``);
    ``tips_packed`` the rank's columns ``mesh.local(topo.sites)`` in
    :class:`Score`'s layout."""

    def __init__(self, topo, rate_cats, states, mesh, use_pinv=False,
                 tip_encoding="clv", device=None):
        device = mesh.device if device is None else device
        if topo.asc_mode and use_pinv:
            raise EinvalError("asc-bias and prop-invar are mutually exclusive")
        lo, hi = mesh.local(topo.sites)
        local = Score(topo._replace(sites=hi - lo, asc_mode=0), rate_cats,
                      states, use_pinv, tip_encoding, device)
        super().__init__(topo, rate_cats, states, mesh, local, device)

    def forward(self, model, tips_packed):
        dtype = _working_dtype(model, tips_packed, self.local.tip_encoding)
        return self._reduced(model, self.local(self._local_model(model),
                                               tips_packed), dtype)


def make_score_sharded(topo: EvalTopology, rate_cats: int, states: int,
                       mesh, impl: str = "auto", use_pinv: bool = False, *,
                       tip_encoding: str = "clv", device=None
                       ) -> ScoreSharded:
    """K1 with the sites sharded across ``mesh``'s ranks
    (``evaluate.py:338``), JAX's arguments in JAX's order (``interpret`` is
    not ported): each rank calls the module on its own tips slab, all with
    the same model, and every rank gets the same logL.  Per-site scaling is
    shard-local by construction; +I through ``inv_add`` cut like the
    sites; the asc tail replicated and added once, after the reduction.
    ``device``: the mesh's when None."""
    _check_impl(impl)
    return ScoreSharded(topo, rate_cats, states, mesh, use_pinv,
                        tip_encoding, device)


class ScoreUnboundedSharded(_Sharded):
    """``forward(model) -> logl`` (float64): K6 on this rank's sites, then
    one ``mesh.sum`` (counterpart ``make_score_unbounded_sharded``).
    ``tips_packed``: the rank's columns of the pattern tips, as
    :class:`ScoreUnbounded` takes them; the schedule's layout follows the
    rank's share (``evaluate.py:544-547``)."""

    def __init__(self, topo, rate_cats, states, mesh, tips_packed,
                 tip_encoding, use_pinv=False, mxu_precision="highest",
                 device=None):
        device = mesh.device if device is None else device
        lo, hi = mesh.local(topo.sites)
        if tips_packed.shape[-1] != hi - lo:
            raise EinvalError(f"tips of {tips_packed.shape[-1]} sites, the "
                              f"rank's share is {hi - lo}")
        local = ScoreUnbounded(topo._replace(sites=hi - lo, asc_mode=0),
                               rate_cats, states, tips_packed, tip_encoding,
                               use_pinv, mxu_precision, device)
        super().__init__(topo, rate_cats, states, mesh, local, device)

    def forward(self, model):
        return self._reduced(model, self.local(self._local_model(model)),
                             model["freqs_pc"].dtype)


def make_score_unbounded_sharded(topo: EvalTopology, rate_cats: int,
                                 states: int, tip_masks, mesh,
                                 use_pinv: bool = False, *, device=None
                                 ) -> ScoreUnboundedSharded:
    """K6 with the sites sharded across ``mesh``'s ranks
    (``evaluate.py:514``), JAX's arguments in JAX's order: every rank
    passes the whole alignment's [tips, sites] bitmasks and keeps its
    columns, packed as :func:`make_score_unbounded` packs them.
    ``device``: the mesh's when None."""
    lo, hi = mesh.local(topo.sites)
    masks = np.asarray(tip_masks)
    if masks.shape[1] != topo.sites:
        raise EinvalError(f"masks of {masks.shape[1]} sites, topology of "
                          f"{topo.sites}")
    enc, tips = _pattern_tips(np.ascontiguousarray(masks[:, lo:hi]), states)
    return ScoreUnboundedSharded(topo, rate_cats, states, mesh, tips, enc,
                                 use_pinv, device=device)


def _newton_rows(model, topo, clv_parent, clv_child, scal_parent, scal_child,
                 site_scalers):
    """N1's arguments in the form of ``ops.derivatives.newton_solve_rows``
    for the evaluation edge: its two CLVs and their scaler rows (folded
    into the sumtable under per-rate scaling), the model's vectors in the
    CLVs' dtype, and ``site_scalers`` (parent, child) for the asc
    pseudo-site terms.  ``ops.derivatives.sumtable_args`` turns them into
    ``newton_solve``'s, the sumtable formed."""
    dtype = clv_parent.dtype
    pidx = model["params_indices"].long()
    f = _floats(model, dtype)
    # t0: create_operations lists the evaluation edge's branch last
    return dict(
        clv_parent=clv_parent, clv_child=clv_child,
        scaler_parent=scal_parent, scaler_child=scal_child,
        freqs_pc=f["freqs_pc"], left_pc=model["left"][pidx].to(dtype),
        right_pc=model["right"][pidx].to(dtype),
        per_rate=topo.scale_mode == SCALE_PER_RATE,
        t0=model["branch_lengths"][-1:].to(dtype),
        rates=model["rates"].to(dtype), prop_invar=f["prop_invar_pc"],
        eigenvals_pc=model["eigenvals"][pidx].to(dtype),
        rate_weights=f["rate_weights"], invariant=model["invariant"],
        pattern_weights=f["pattern_weights"], site_scalers=site_scalers,
        sites=topo.sites, asc_mode=topo.asc_mode)


class TrainStepFused(ForwardFused):
    """``forward(model, tips_packed) -> (logl, t_star)``: the Newton
    branch-length update of the evaluation edge on the fused path
    (counterpart ``make_train_step_fused``, ``evaluate.py:596-661``):
    P-matrices → K2 → edge logL (the :class:`ForwardFused` call, so the
    logL is its bits) → the sumtable of the edge's two rows, once → N1
    from ``t0 = branch_lengths[-1]``, all on the card with no host read.
    The derivative call's site scalers are zeros, asc modes included, as
    JAX's (``:636``, ``:648``).  ``tips_packed`` as in
    :class:`ForwardFused`; DNA or protein on the card, as K2.  Where N1
    runs resident, its kernel forms the sumtable from the two rows
    (``ops.derivatives.newton_solve_rows``)."""

    def newton_rows(self, model, tips_packed):
        """``(logl, N1's arguments in rows form)`` of one step."""
        logl, _, inner, scalers = ForwardFused.forward(self, model,
                                                       tips_packed)
        topo = self.topo
        dtype = _working_dtype(model, tips_packed, self.tip_encoding)
        ends = (topo.parent_clv, topo.child_clv)
        clv_p, clv_c = (self._row(tips_packed, inner, r, dtype) for r in ends)
        scal_p, scal_c = (scalers[topo.scaler_row(r)] for r in ends)
        return logl, _newton_rows(model, topo, clv_p, clv_c, scal_p, scal_c,
                                  (None, None))

    def newton_inputs(self, model, tips_packed):
        """``(logl, N1's arguments)`` of one step, the sumtable formed."""
        logl, rows = self.newton_rows(model, tips_packed)
        return logl, dv.sumtable_args(rows)

    def forward(self, model, tips_packed):
        logl, rows = self.newton_rows(model, tips_packed)
        return logl, dv.newton_solve_rows(**rows).t

    def graphed(self, model, tips_packed) -> GraphedCall:
        """This step on inputs shaped as ``model`` and ``tips_packed``
        (CUDA tensors), captured in a CUDA graph."""
        return GraphedCall(self, model, tips_packed)


def make_train_step_fused(topo: EvalTopology, rate_cats: int, states: int,
                          impl: str = "auto", *, tip_encoding: str = "clv",
                          device=None) -> TrainStepFused:
    """Build the fused Newton step (``evaluate.py:596``), with JAX's
    parameters in JAX's order (``impl`` checked, else ignored;
    ``interpret`` is not ported); it takes pattern tips, as K2 does."""
    _check_impl(impl)
    return TrainStepFused(topo, rate_cats, states, tip_encoding, device)


class TrainStep(Forward):
    """``forward(model, clv, scalers) -> (logl, t_star, clv, scalers)``:
    the plain level sweep and edge logL of :class:`Forward`, then the
    sumtable and N1 (counterpart ``make_train_step``,
    ``evaluate.py:664-727``), any alphabet N1 takes.  Under per-rate
    scaling the derivative call's site scalers are zeros (``:701-703``)."""

    def newton_rows(self, model, clv, scalers):
        """``(logl, clv, scalers, N1's arguments in rows form)`` of one
        step."""
        logl, _, clv, scalers = self.swept(model, clv, scalers)
        topo = self.topo
        ends = (topo.parent_clv, topo.child_clv)
        scal_p, scal_c = (scalers[topo.scaler_row(r)] for r in ends)
        site = ((None, None) if topo.scale_mode == SCALE_PER_RATE
                else (scal_p, scal_c))
        return logl, clv, scalers, _newton_rows(
            model, topo, clv[ends[0]], clv[ends[1]], scal_p, scal_c, site)

    def newton_inputs(self, model, clv, scalers):
        """``(logl, clv, scalers, N1's arguments)`` of one step, the
        sumtable formed."""
        logl, clv, scalers, rows = self.newton_rows(model, clv, scalers)
        return logl, clv, scalers, dv.sumtable_args(rows)

    def forward(self, model, clv, scalers):
        logl, clv, scalers, rows = self.newton_rows(model, clv, scalers)
        return logl, dv.newton_solve_rows(**rows).t, clv, scalers


def make_train_step(topo: EvalTopology, *, device=None) -> TrainStep:
    """Build the Newton step on the plain level sweep (``evaluate.py:664``)."""
    return TrainStep(topo, device)
