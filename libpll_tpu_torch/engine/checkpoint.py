"""Checkpoint / resume for phylogenetic analyses.

The reference has no checkpoint facility — its de-facto serialization is
newick export plus the model setters (SURVEY §5.4).  The rebuild makes that
explicit: a snapshot is (newick topology with branch lengths, the full model
parameter state, optional RNG state), from which every derived quantity
(CLVs, P-matrices, eigendecompositions, scalers) is recomputed — CLVs are
derived state, so snapshots stay tiny regardless of alignment size.

Format: a single ``.npz`` file (numpy archive) with a JSON header — no
external dependencies, stable across hosts.

Counterpart: ``libpll_tpu/engine/checkpoint.py``: the same format, header
and version, so a file written by either package loads in the other.  The
header's ``dtype`` is a numpy name (``"float32"``/``"float64"``), mapped
to and from torch dtypes here.
"""

from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

from ..errors import EinvalError
from .partition import numpy_dtype

FORMAT_VERSION = 1


def save_checkpoint(path: str, newick: str, partition,
                    rng_state: Optional[np.ndarray] = None,
                    extra: Optional[dict] = None) -> None:
    """Snapshot (topology, model parameters, RNG) to ``path``.

    ``partition`` is an engine Partition; only its *parameter* state is
    stored (subst params, frequencies, rates + weights, prop-invar,
    pattern weights, asc-bias mode and weights), never derived buffers.
    A sharded Partition (``parallel.mesh``) holds one rank's weights and
    raises.
    """
    if getattr(partition, "mesh", None) is not None:
        raise EinvalError("checkpoint of a sharded Partition: save it "
                          "before shard_partition")
    header = {
        "version": FORMAT_VERSION,
        "newick": newick,
        "tips": partition.tips,
        "clv_buffers": partition.clv_buffers,
        "states": partition.states,
        "sites": partition.sites,
        "rate_matrices": partition.rate_matrices,
        "prob_matrices": partition.prob_matrices,
        "rate_cats": partition.rate_cats,
        "scale_buffers": partition.scale_buffers,
        "scale_mode": int(partition.scale_mode),
        "asc_mode": int(partition.asc_mode),
        "dtype": numpy_dtype(partition.dtype).name,
        "extra": extra or {},
    }
    arrays = {
        "subst_params": np.asarray(partition.subst_params),
        "frequencies": np.asarray(partition.frequencies),
        "rates": np.asarray(partition.rates),
        "rate_weights": np.asarray(partition.rate_weights),
        "prop_invar": np.asarray(partition.prop_invar),
        "pattern_weights": np.asarray(partition.pattern_weights),
    }
    if getattr(partition, "invariant", None) is not None:
        arrays["invariant"] = np.asarray(partition.invariant)
    if rng_state is not None:
        arrays["rng_state"] = np.asarray(rng_state)
    np.savez(path, header=np.frombuffer(
        json.dumps(header).encode(), dtype=np.uint8), **arrays)


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """Load a snapshot -> (header dict, arrays dict).

    Rebuild flow: parse ``header['newick']``, construct a Partition from the
    header geometry, apply the returned parameter arrays via the setters,
    re-encode tip states from the alignment, and recompute partials.
    """
    with np.load(path) as z:
        header = json.loads(bytes(z["header"]).decode())
        if header.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint version {header.get('version')}")
        arrays = {k: z[k] for k in z.files if k != "header"}
    return header, arrays


def restore_partition(header: dict, arrays: dict, *, device=None):
    """Construct a fresh Partition from a loaded snapshot (tip states must
    be re-applied by the caller from the alignment) on ``device`` (None:
    the card, as ``Partition``)."""
    from .partition import Partition

    scale_mode_name = {0: "none", 1: "site", 2: "rate"}[header["scale_mode"]]
    part = Partition(header["tips"], header["clv_buffers"],
                     header["states"], header["sites"],
                     header["rate_matrices"], header["prob_matrices"],
                     header["rate_cats"], header["scale_buffers"],
                     asc_bias_alloc=bool(header["asc_mode"]),
                     dtype=header["dtype"], scaling=scale_mode_name,
                     device=device)
    for i in range(header["rate_matrices"]):
        part.set_subst_params(i, arrays["subst_params"][i])
        part.set_frequencies(i, arrays["frequencies"][i])
    part.set_category_rates(arrays["rates"])
    part.set_category_weights(arrays["rate_weights"])
    part.set_pattern_weights(arrays["pattern_weights"])
    for i, p in enumerate(np.asarray(arrays["prop_invar"])):
        if p > 0:
            part.update_invariant_sites_proportion(i, float(p))
    return part
