"""Partition: the stateful instance owning CLVs, P-matrices and parameters.

Counterpart: ``libpll_tpu/engine/partition.py`` (``Operation`` ``:50``,
``operations_to_array`` ``:71``, ``Partition`` ``:87``), capability parity
with ``pll_partition_create`` and its setter/compute API (libpll
``src/pll.c:399-1116``, ``src/partials.c``, ``src/likelihood.c``,
``src/derivatives.c``, ``src/models.c``).  The methods keep JAX's names,
argument order and error classes; the layouts are JAX's:

  * bulk state is a handful of dense tensors on the partition's device:
    CLVs ``[nodes, rate_cats, states, sites_alloc]``, int32 exponent
    counters ``[scale_buffers + 1, sites_alloc]`` per site,
    ``[scale_buffers + 1, rate_cats, sites_alloc]`` per rate and
    ``[1, sites_alloc]`` without scaling, P-matrices
    ``[prob_matrices, rate_cats, states, states]``;
  * model parameters (frequencies, substitution rates, Γ rates, p-inv,
    pattern weights) and the eigen cache live on the host in float64
    numpy, as in the reference (``models.c:342-349``); the tensors the
    compute methods take from them are made on the partition's device once
    and kept until the next setter call (change them through the setters);
  * an operation schedule from the tree layer is an int32 table that
    :func:`..ops.clv.replay_ops` executes on the buffers in place: kernel
    U1 on the card, the plain executors on the CPU.

A Partition is built on the card unless ``device="cpu"`` is asked for;
with no card it raises :class:`~..errors.KernelError` (the factories'
rule, ``engine.evaluate._resolve_device``).  In float32 on the card every
product must run in full float32: a method raises
:class:`~..errors.EinvalError` while TF32 matmuls are on.

Index conventions match the reference: CLV buffers 0..tips-1 are tips,
tips..tips+clv_buffers-1 are inner nodes; scaler index -1 means "none".
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..errors import AscBiasError, InvarError, ParamError, TipDataError
from ..io.maps import encode_sequence, tipmask_to_clv
from ..models.gtr import eigen_decompose
from ..ops import clv as clv_ops
from ..ops import derivatives as deriv_ops
from ..ops import likelihood as lk_ops
from ..ops.pmatrix import compute_pmatrices
from ..utils.constants import (SCALE_BUFFER_NONE, SCALE_NONE, SCALE_PER_RATE,
                               SCALE_PER_SITE)

ASC_NONE = lk_ops.ASC_NONE
ASC_LEWIS = lk_ops.ASC_LEWIS
ASC_FELSENSTEIN = lk_ops.ASC_FELSENSTEIN
ASC_STAMATAKIS = lk_ops.ASC_STAMATAKIS


@dataclasses.dataclass(frozen=True)
class Operation:
    """One CLV update: mirrors pll_operation_t (reference pll.h:249-259)."""

    parent_clv_index: int
    parent_scaler_index: int
    child1_clv_index: int
    child1_matrix_index: int
    child1_scaler_index: int
    child2_clv_index: int
    child2_matrix_index: int
    child2_scaler_index: int

    def as_tuple(self):
        # NOT dataclasses.astuple: that routes through deepcopy
        return (self.parent_clv_index, self.parent_scaler_index,
                self.child1_clv_index, self.child1_matrix_index,
                self.child1_scaler_index, self.child2_clv_index,
                self.child2_matrix_index, self.child2_scaler_index)


def operations_to_array(operations, n_scale_buffers: int) -> np.ndarray:
    """Flatten operations into the int32 table the CLV executors take.

    Scaler index -1 is remapped to the dummy row ``n_scale_buffers``.
    """
    rows = []
    for op in operations:
        t = list(op.as_tuple() if isinstance(op, Operation) else tuple(op))
        for k in (1, 4, 7):
            if t[k] == SCALE_BUFFER_NONE:
                t[k] = n_scale_buffers
        rows.append(t)
    return np.asarray(rows, dtype=np.int32)


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or type, or a name
    such as ``"float64"`` (the checkpoint header's)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return np.dtype(str(dtype).removeprefix("torch."))


class Partition:
    """Phylogenetic likelihood partition instance.

    ``device``: None builds on the card (a KernelError without one);
    ``"cpu"`` builds on the CPU."""

    def __init__(self, tips: int, clv_buffers: int, states: int, sites: int,
                 rate_matrices: int, prob_matrices: int, rate_cats: int,
                 scale_buffers: int, *, scaling: str = "site",
                 asc_bias_alloc: bool = False, dtype=torch.float64,
                 device=None):
        from .evaluate import _resolve_device

        if tips < 3:
            raise ParamError("tips must be >= 3")
        if states < 2 or sites < 1 or rate_cats < 1:
            raise ParamError("invalid partition dimensions")
        if scaling not in ("none", "site", "rate"):
            raise ParamError(f"invalid scaling mode {scaling!r}")
        self.device = _resolve_device(device)

        self.tips = tips
        self.clv_buffers = clv_buffers
        self.nodes = tips + clv_buffers
        self.states = states
        self.sites = sites
        self.rate_matrices = rate_matrices
        self.prob_matrices = prob_matrices
        self.rate_cats = rate_cats
        self.scale_buffers = scale_buffers
        self.asc_bias_alloc = asc_bias_alloc
        self.asc_mode = ASC_NONE
        self.dtype = torch_dtype(dtype)
        self.scale_mode = {"none": SCALE_NONE, "site": SCALE_PER_SITE,
                           "rate": SCALE_PER_RATE}[scaling]

        # asc-bias correction appends `states` pseudo-sites (pll.c:490-495)
        self.sites_alloc = sites + (states if asc_bias_alloc else 0)
        L, C, S = self.sites_alloc, rate_cats, states

        dev = dict(device=self.device)
        self._clv = torch.zeros((self.nodes, C, S, L), dtype=self.dtype,
                                **dev)
        # tip rows staged host-side and landed with ONE copy at the next
        # read: a per-tip write into the whole tensor makes a giant
        # tree's set-up O(nodes²) in JAX, where each write copies it
        self._staged_tips: dict = {}
        if self.scale_mode == SCALE_PER_RATE:
            shape = (scale_buffers + 1, C, L)
        elif self.scale_mode == SCALE_PER_SITE:
            shape = (scale_buffers + 1, L)
        else:
            shape = (1, L)
        self.scalers = torch.zeros(shape, dtype=torch.int32, **dev)
        self.pmatrix = torch.zeros((prob_matrices, C, S, S),
                                   dtype=self.dtype, **dev)

        # host-side (small) model parameters, float64 like the reference
        n_params = states * (states - 1) // 2
        self.subst_params = np.ones((rate_matrices, n_params))
        self.frequencies = np.full((rate_matrices, states), 1.0 / states)
        self.rates = np.ones(rate_cats)
        self.rate_weights = np.full(rate_cats, 1.0 / rate_cats)
        self.prop_invar = np.zeros(rate_matrices)
        self.pattern_weights = np.ones(self.sites_alloc, dtype=np.int64)
        self.pattern_weights[sites:] = 0  # pseudo-sites weigh 0 by default
        self.invariant: Optional[np.ndarray] = None

        # eigen cache (host, lazy — models.c:342-349)
        self.eigenvals = np.zeros((rate_matrices, states))
        self.eigen_left = np.zeros((rate_matrices, states, states))
        self.eigen_right = np.zeros((rate_matrices, states, states))
        self.eigen_valid = np.zeros(rate_matrices, dtype=bool)

        # tip state bitmasks, kept for invariant-site detection
        self._tip_masks = np.zeros((tips, sites), dtype=np.uint32)
        # device copies of the host parameters, cleared by every setter
        self._params: dict = {}

    # ------------------------------------------------------------------
    # setters (reference: pll.c / models.c)
    # ------------------------------------------------------------------
    def set_tip_states(self, tip_index: int, charmap: np.ndarray,
                       sequence: str) -> None:
        """Encode an ASCII sequence into a bit-encoded tip CLV
        (`set_tipclv`, pll.c:905-964)."""
        if not (0 <= tip_index < self.tips):
            raise TipDataError(f"tip index {tip_index} out of range")
        if len(sequence) != self.sites:
            raise TipDataError(
                f"sequence length {len(sequence)} != sites {self.sites}")
        masks = encode_sequence(sequence, charmap)
        self._tip_masks[tip_index] = masks
        site_clv = tipmask_to_clv(masks, self.states)  # [sites, S]
        self._install_tip_clv(tip_index, site_clv.T)  # [S, sites]

    def set_tip_clv(self, tip_index: int, tip_clv: np.ndarray) -> None:
        """Set an explicit per-site tip CLV [sites, states]
        (`pll_set_tip_clv`, pll.c:1001-1045)."""
        arr = np.asarray(tip_clv, dtype=np.float64)
        if arr.shape != (self.sites, self.states):
            raise TipDataError(
                f"expected tip CLV of shape {(self.sites, self.states)}")
        # approximate the bitmask for invariant detection: nonzero -> bit set
        self._tip_masks[tip_index] = (
            (arr > 0).astype(np.uint32)
            << np.arange(self.states, dtype=np.uint32)[None, :]
        ).sum(axis=1).astype(np.uint32)
        self._install_tip_clv(tip_index, arr.T)

    def _install_tip_clv(self, tip_index: int, clv_sl: np.ndarray) -> None:
        """clv_sl: [S, sites]; appends asc pseudo-sites (identity states)
        when allocated.  Staged host-side in the working dtype; all staged
        tips land in one copy at the next ``clv`` read."""
        L, S = self.sites_alloc, self.states
        full = np.zeros((S, L), dtype=numpy_dtype(self.dtype))
        full[:, :self.sites] = clv_sl
        if self.asc_bias_alloc:
            full[:, self.sites:] = np.eye(S)
        self._staged_tips[tip_index] = full

    def _flush_tips(self) -> None:
        if not self._staged_tips:
            return
        staged, self._staged_tips = self._staged_tips, {}
        idx = torch.as_tensor(list(staged.keys()), device=self.device)
        tiles = torch.from_numpy(np.stack(list(staged.values()))).to(
            self.device)  # [k, S, L]
        # broadcast over the rate categories on the device, one rate at a
        # time: an expanded source would be materialised C times over
        for c in range(self.rate_cats):
            self._clv[idx, c] = tiles

    @property
    def clv(self) -> torch.Tensor:
        self._flush_tips()
        return self._clv

    @clv.setter
    def clv(self, value) -> None:
        self._clv = value

    def set_subst_params(self, params_index: int, params) -> None:
        p = np.asarray(params, dtype=np.float64)
        if p.shape != (self.states * (self.states - 1) // 2,):
            raise ParamError("wrong number of substitution parameters")
        self.subst_params[params_index] = p
        self.eigen_valid[params_index] = False
        self._params.clear()

    def set_frequencies(self, freqs_index: int, frequencies) -> None:
        f = np.asarray(frequencies, dtype=np.float64)
        if f.shape != (self.states,):
            raise ParamError("wrong number of frequencies")
        self.frequencies[freqs_index] = f
        self.eigen_valid[freqs_index] = False
        self._params.clear()

    def set_category_rates(self, rates) -> None:
        self.rates = np.asarray(rates, dtype=np.float64).reshape(self.rate_cats)
        self._params.clear()

    def set_category_weights(self, weights) -> None:
        self.rate_weights = np.asarray(weights, dtype=np.float64).reshape(
            self.rate_cats)
        self._params.clear()

    def set_pattern_weights(self, weights) -> None:
        w = np.asarray(weights)
        if w.shape != (self.sites,):
            raise ParamError("pattern weights must have length sites")
        self.pattern_weights[:self.sites] = w
        self._params.clear()

    @property
    def pattern_weight_sum(self) -> int:
        return int(self.pattern_weights[:self.sites].sum())

    def set_asc_bias_type(self, asc_mode: int) -> None:
        """reference: pll_set_asc_bias_type (pll.c:1061-1107)."""
        if not self.asc_bias_alloc and asc_mode != ASC_NONE:
            raise AscBiasError(
                "partition was not created with ascertainment bias support")
        if asc_mode != ASC_NONE and np.any(self.prop_invar > 0):
            raise InvarError(
                "invariant sites are not compatible with asc bias correction")
        if asc_mode not in (ASC_NONE, ASC_LEWIS, ASC_FELSENSTEIN,
                            ASC_STAMATAKIS):
            raise AscBiasError(f"illegal ascertainment bias type {asc_mode}")
        self.asc_mode = asc_mode

    def set_asc_state_weights(self, weights) -> None:
        if not self.asc_bias_alloc:
            raise AscBiasError("partition has no asc-bias pseudo-sites")
        w = np.asarray(weights)
        if w.shape != (self.states,):
            raise ParamError("asc state weights must have length states")
        self.pattern_weights[self.sites:] = w
        self._params.clear()

    # ------------------------------------------------------------------
    # invariant sites (reference: models.c:402-647)
    # ------------------------------------------------------------------
    def update_invariant_sites(self) -> None:
        gap_state = (1 << self.states) - 1
        state = np.full(self.sites, gap_state, dtype=np.uint32)
        for t in range(self.tips):
            state &= self._tip_masks[t]
        popcount = np.array([bin(x).count("1") for x in state])
        inv = np.where(popcount == 1,
                       np.array([(int(x) & -int(x)).bit_length() - 1
                                 for x in state]),
                       -1).astype(np.int32)
        full = np.full(self.sites_alloc, -1, dtype=np.int32)
        full[:self.sites] = inv
        self.invariant = full
        self._params.clear()

    def update_invariant_sites_proportion(self, params_index: int,
                                          prop_invar: float) -> None:
        if prop_invar != 0.0 and self.asc_mode != ASC_NONE:
            raise InvarError(
                "invariant sites are not compatible with asc bias correction")
        if prop_invar < 0 or prop_invar >= 1:
            raise InvarError(
                f"invalid proportion of invariant sites ({prop_invar})")
        if params_index >= self.rate_matrices:
            raise InvarError(f"invalid params index ({params_index})")
        if prop_invar > 0.0 and self.invariant is None:
            self.update_invariant_sites()
            if not np.any(self.invariant >= 0):
                raise InvarError("no invariant sites found")
        self.prop_invar[params_index] = prop_invar
        self._params.clear()

    def count_invariant_sites(self) -> int:
        if self.invariant is None:
            self.update_invariant_sites()
        mask = self.invariant[:self.sites] >= 0
        return int(self.pattern_weights[:self.sites][mask].sum())

    # ------------------------------------------------------------------
    # eigen / P-matrices (reference: models.c:251-364, core_pmatrix.c)
    # ------------------------------------------------------------------
    def _t(self, a, dtype=None) -> torch.Tensor:
        """A host array as a tensor on the partition's device, in the
        working dtype unless ``dtype`` is given."""
        return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                               device=self.device)

    def _param(self, name: str, index=None, dtype=None) -> torch.Tensor:
        """The host parameter ``name`` (its rows ``index``, when given) as
        :meth:`_t` makes it, made once and kept until the next setter."""
        key = (name, None if index is None else
               tuple(np.asarray(index).tolist()), dtype)
        t = self._params.get(key)
        if t is None:
            a = getattr(self, name)
            t = self._t(a if index is None else a[np.asarray(index)], dtype)
            self._params[key] = t
        return t

    def _check_precision(self, what: str) -> None:
        deriv_ops.check_full_precision(self.pmatrix, what)

    def update_eigen(self, params_index: int) -> None:
        w, left, right = eigen_decompose(self.subst_params[params_index],
                                         self.frequencies[params_index])
        self.eigenvals[params_index] = w
        self.eigen_left[params_index] = left
        self.eigen_right[params_index] = right
        self.eigen_valid[params_index] = True
        self._params.clear()

    def update_prob_matrices(self, params_indices, matrix_indices,
                             branch_lengths) -> None:
        self._check_precision("update_prob_matrices")
        pi = np.asarray(params_indices, dtype=np.int32).reshape(self.rate_cats)
        mi = np.asarray(matrix_indices, dtype=np.int64)
        bl = np.asarray(branch_lengths, dtype=np.float64)
        if np.any(bl < 0):
            raise ParamError("negative branch length")
        for idx in np.unique(pi):
            if not self.eigen_valid[idx]:
                self.update_eigen(int(idx))
        new = compute_pmatrices(
            self._t(bl), self._param("rates"), self._param("prop_invar"),
            self._t(pi, torch.int32), self._param("eigenvals"),
            self._param("eigen_left"), self._param("eigen_right"))
        self.pmatrix[self._t(mi, torch.long)] = new

    # ------------------------------------------------------------------
    # CLV updates (reference: partials.c:177-212)
    # ------------------------------------------------------------------
    def update_partials(self, operations: Sequence[Operation],
                        pad_to: Optional[int] = None) -> None:
        """``pad_to``: pad the op table to a fixed capacity by repeating the
        final op (idempotent), as JAX does to reuse one compiled schedule
        executor across incremental updates of varying size.  On the card
        one launch of kernel U1 (``ops.clv.replay_ops``)."""
        ops = operations_to_array(operations, self.scale_buffers)
        if pad_to is not None:
            from ..ops.incremental import pad_op_table
            ops = pad_op_table(ops, pad_to)
        clv_ops.replay_ops(self.clv, self.scalers, ops, self.pmatrix,
                           scale_mode=self.scale_mode)

    # ------------------------------------------------------------------
    # likelihood (reference: likelihood.c)
    # ------------------------------------------------------------------
    def _freqs_pc(self, freqs_indices) -> torch.Tensor:
        fi = np.asarray(freqs_indices, dtype=np.int64).reshape(self.rate_cats)
        return self._param("frequencies", fi)

    def _pinv_pc(self, freqs_indices) -> torch.Tensor:
        fi = np.asarray(freqs_indices, dtype=np.int64).reshape(self.rate_cats)
        return self._param("prop_invar", fi)

    def _scaler_row(self, scaler_index: int) -> torch.Tensor:
        if self.scale_mode == SCALE_NONE:
            return self.scalers[0]
        idx = self.scale_buffers if scaler_index == SCALE_BUFFER_NONE \
            else scaler_index
        return self.scalers[idx]

    def _invariant_arr(self) -> torch.Tensor:
        key = ("invariant", None, torch.int32)
        if key not in self._params:
            inv = (np.full(self.sites_alloc, -1, np.int32)
                   if self.invariant is None else self.invariant)
            self._params[key] = self._t(inv, torch.int32)
        return self._params[key]

    def _pattern_weights_arr(self) -> torch.Tensor:
        return self._param("pattern_weights")

    def _logl(self, logl, persite, persite_wanted):
        return ((float(logl), persite.cpu().numpy()) if persite_wanted
                else float(logl))

    def compute_root_loglikelihood(self, clv_index: int, scaler_index: int,
                                   freqs_indices, persite: bool = False):
        self._check_precision("compute_root_loglikelihood")
        logl, ps = lk_ops.root_loglikelihood(
            self.clv[clv_index], self._scaler_row(scaler_index),
            self._freqs_pc(freqs_indices), self._param("rate_weights"),
            self._pattern_weights_arr(), self._pinv_pc(freqs_indices),
            self._invariant_arr(), sites=self.sites,
            per_rate=self.scale_mode == SCALE_PER_RATE,
            asc_mode=self.asc_mode)
        return self._logl(logl, ps, persite)

    def compute_edge_loglikelihood(self, parent_clv_index: int,
                                   parent_scaler_index: int,
                                   child_clv_index: int,
                                   child_scaler_index: int,
                                   matrix_index: int, freqs_indices,
                                   persite: bool = False):
        self._check_precision("compute_edge_loglikelihood")
        logl, ps = lk_ops.edge_loglikelihood(
            self.clv[parent_clv_index], self.clv[child_clv_index],
            self._scaler_row(parent_scaler_index),
            self._scaler_row(child_scaler_index),
            self.pmatrix[matrix_index], self._freqs_pc(freqs_indices),
            self._param("rate_weights"), self._pattern_weights_arr(),
            self._pinv_pc(freqs_indices), self._invariant_arr(),
            sites=self.sites, per_rate=self.scale_mode == SCALE_PER_RATE,
            asc_mode=self.asc_mode)
        return self._logl(logl, ps, persite)

    # ------------------------------------------------------------------
    # derivatives (reference: derivatives.c)
    # ------------------------------------------------------------------
    def update_sumtable(self, parent_clv_index: int, child_clv_index: int,
                        parent_scaler_index: int, child_scaler_index: int,
                        params_indices) -> torch.Tensor:
        pi = np.asarray(params_indices, dtype=np.int64).reshape(self.rate_cats)
        for idx in np.unique(pi):
            if not self.eigen_valid[idx]:
                self.update_eigen(int(idx))
        per_rate = self.scale_mode == SCALE_PER_RATE
        zeros = torch.zeros_like(self._scaler_row(SCALE_BUFFER_NONE))
        sp = self._scaler_row(parent_scaler_index) if per_rate else zeros
        sc = self._scaler_row(child_scaler_index) if per_rate else zeros
        return deriv_ops.update_sumtable(
            self.clv[parent_clv_index], self.clv[child_clv_index], sp, sc,
            self._freqs_pc(pi), self._param("eigen_left", pi),
            self._param("eigen_right", pi), per_rate=per_rate)

    def compute_likelihood_derivatives(self, parent_scaler_index: int,
                                       child_scaler_index: int,
                                       branch_length: float, params_indices,
                                       sumtable) -> tuple[float, float]:
        self._check_precision("compute_likelihood_derivatives")
        pi = np.asarray(params_indices, dtype=np.int64).reshape(self.rate_cats)
        if self.asc_mode != ASC_NONE and self.scale_mode == SCALE_PER_SITE:
            sp = self._scaler_row(parent_scaler_index)
            sc = self._scaler_row(child_scaler_index)
        else:
            # per-rate scalers were folded into the sumtable already; the
            # per-site asc part below then sees zero scalers like the
            # reference's rate-scaler asc path
            sp = sc = torch.zeros((self.sites_alloc,), dtype=torch.int32,
                                  device=self.device)
        d1, d2 = deriv_ops.likelihood_derivatives(
            sumtable, self._t(branch_length), self._param("rates"),
            self._pinv_pc(pi), self._param("eigenvals", pi),
            self._freqs_pc(pi), self._param("rate_weights"),
            self._invariant_arr(), self._pattern_weights_arr(), sp, sc,
            sites=self.sites, asc_mode=self.asc_mode)
        return float(d1), float(d2)
