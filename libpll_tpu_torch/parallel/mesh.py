"""Site sharding across processes: one rank per shard of the sites axis.

Counterpart: ``libpll_tpu/parallel/mesh.py`` (``initialize_distributed``
``:28``, ``make_sites_mesh`` ``:38``, ``pad_sites`` ``:59``,
``shard_partition`` ``:65``).  The phylogenetic likelihood is exactly
decomposable over sites, so each rank holds only its own columns of the
CLVs, scalers, tip states, pattern weights and invariant codes, while the
P-matrices, eigen data, frequencies and rates are small and replicated.

JAX places one program's arrays over a device mesh and lets XLA insert the
reductions.  PyTorch has no sharding annotation: here every rank is a
process that runs the same call with the same arguments (the SPMD idiom of
``torchrun``), and every sum over sites meets the other ranks' in an
explicit collective, :meth:`SitesMesh.sum`, the package's one reduction
point.  Every rank adds the same partial sums in the same order, so every
rank holds the same bits, every decision made on a reduced value (a
Newton step, an argmin, an acceptance) is the same on every rank, and so
are the results.

The backend is the caller's: ``gloo`` on the CPU and for several ranks on
one card, ``nccl`` where each rank has its own card.  Nothing switches
backend or device on its own.
"""

from __future__ import annotations

import datetime
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..errors import EinvalError

SITES_AXIS = "sites"
COLLECTIVE_TIMEOUT = 600.0  # seconds a collective waits for its peers


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None, *, backend: str,
                           device=None,
                           timeout: float = COLLECTIVE_TIMEOUT) -> None:
    """Join this process to the job's default process group (JAX's
    ``jax.distributed.initialize``): ``init_method`` (``file://`` or
    ``tcp://host:port``), the world size and this process's rank, with
    ``backend`` (``"gloo"``, ``"nccl"``) and a ``timeout`` in seconds on
    every collective, so that a rank whose peer died fails instead of
    hanging.  ``device``: a CUDA device this rank works on becomes the
    current one.  A world size of None or 1 is a no-op, as in JAX."""
    if world_size in (None, 1):
        return
    device = None if device is None else torch.device(device)
    if device is not None and device.type == "cuda" and (
            device.index is not None):
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout))


class SitesMesh:
    """The ranks that share the sites axis: ``group`` (None: the default
    group, or no process group at all for a single rank), this process's
    ``rank``, the world ``size``, the rank's ``device`` and the group's
    ``backend``.  :meth:`local` is the rank's slice of a padded site
    count; :meth:`sum` the one reduction across the ranks.

    ``reductions`` and ``reduce_seconds`` count the calls of :meth:`sum`
    and their host time since construction (or the last reset)."""

    def __init__(self, group, rank: int, size: int, device: torch.device,
                 backend: Optional[str] = None):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = device
        self.backend = backend
        self.reductions = 0
        self.reduce_seconds = 0.0

    def local(self, n_sites: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of ``pad_sites(n_sites)`` sites: equal
        contiguous shares in rank order."""
        share = pad_sites(n_sites, self) // self.size
        return self.rank * share, (self.rank + 1) * share

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, the same bits on every rank, on
        ``t``'s device: a floating tensor reduced in float64 and returned
        in its dtype; an int32 tensor (Fitch's uint32 bits) summed modulo
        2**32, as JAX's uint32 ``psum`` wraps.  One rank: ``t`` itself.

        Every rank sends its widened copy to every other rank and adds the
        ``size`` copies in rank order: one message each way a pair, where
        gloo's ``all_reduce`` of a few values also passes through its
        worker thread and its algorithm's steps, at about twice the
        latency (chip_smoke.py's phase 35 times both).  Gloo's
        point-to-point takes host tensors only, so its copies lie on the
        host; NCCL's lie on the rank's card.  Never part of an
        autograd graph (a backward through an all-reduce would sum the
        gradients again)."""
        self.reductions += 1
        if self.size == 1:
            return t
        start = time.perf_counter()
        if t.is_floating_point():
            wide = torch.float64
        elif t.dtype == torch.int32:
            wide = torch.int64
        else:
            raise EinvalError(f"mesh sum of {t.dtype}: float or int32 only")
        where = self.device if self.backend == "nccl" else torch.device("cpu")
        parts = torch.empty((self.size, t.numel()), dtype=wide, device=where)
        mine = parts[self.rank]
        mine.copy_(t.detach().reshape(-1))
        ops = []
        for peer in range(self.size):
            if peer != self.rank:
                glob = self._global(peer)
                ops.append(dist.P2POp(dist.irecv, parts[peer], glob,
                                      self.group))
                ops.append(dist.P2POp(dist.isend, mine, glob, self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        buf = parts[0].clone()
        for r in range(1, self.size):
            buf += parts[r]
        if not t.is_floating_point():
            buf = torch.remainder(buf, 1 << 32)
            buf = torch.where(buf >= 1 << 31, buf - (1 << 32), buf)
        out = buf.reshape(t.shape).to(t.device, t.dtype)
        self.reduce_seconds += time.perf_counter() - start
        return out

    def _global(self, rank: int) -> int:
        """The default group's rank of ``group``'s rank ``rank``."""
        if self.group is None:
            return rank
        return dist.get_global_rank(self.group, rank)

    def __repr__(self) -> str:
        return (f"SitesMesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend})")


def make_sites_mesh(group=None, *, device=None) -> SitesMesh:
    """A 1-D mesh over the ranks of ``group`` (the default process group
    when None; without one, a single rank).  ``device``: the rank's device,
    the card when None (a :class:`~..errors.KernelError` without one) or
    ``"cpu"``."""
    from ..engine.evaluate import _resolve_device

    device = _resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if group is not None:
            raise EinvalError("a process group without torch.distributed "
                              "initialized")
        return SitesMesh(None, 0, 1, device)
    return SitesMesh(group, dist.get_rank(group), dist.get_world_size(group),
                     device, dist.get_backend(group))


def pad_sites(n_sites: int, mesh: SitesMesh) -> int:
    """Sites must divide evenly across the mesh; pad with weight-0
    columns."""
    n = mesh.size
    return ((n_sites + n - 1) // n) * n


def shard_partition(partition, mesh: SitesMesh) -> None:
    """Cut an existing Partition down to this rank's sites, in place.

    The Partition keeps the columns ``mesh.local(sites)`` of its CLVs,
    scalers, tip states, pattern weights and invariant codes (and the asc
    pseudo columns, which every rank holds: their terms are added once,
    after the reduction); P-matrices, eigen data, frequencies and rates
    stay as they are, replicated.  From then on ``partition.sites`` is the
    rank's count, ``partition.mesh`` the mesh and ``partition.site_range``
    the rank's slice of ``partition.global_sites``; every method that sums
    over sites reduces through ``mesh.sum``.  The site count must divide
    the mesh (create the Partition with ``sites = pad_sites(...)`` and
    zero pattern weights in the pad, as the reference pads SIMD widths
    with zero-weight columns)."""
    if getattr(partition, "mesh", None) is not None:
        raise EinvalError("the Partition is sharded already")
    sites = partition.sites
    if sites % mesh.size:
        raise EinvalError(f"{sites} sites do not divide {mesh.size} ranks: "
                          "create the Partition with pad_sites(...) sites")
    if partition.device != mesh.device:
        raise EinvalError(f"Partition on {partition.device}, mesh rank on "
                          f"{mesh.device}")
    lo, hi = mesh.local(sites)
    keep = np.concatenate([np.arange(lo, hi),
                           np.arange(sites, partition.sites_alloc)])
    cols = torch.from_numpy(keep).to(partition.device)
    partition.clv = partition.clv.index_select(-1, cols).contiguous()
    partition.scalers = partition.scalers.index_select(-1, cols).contiguous()
    partition.pattern_weights = partition.pattern_weights[keep].copy()
    if partition.invariant is not None:
        partition.invariant = partition.invariant[keep].copy()
    partition._tip_masks = partition._tip_masks[:, lo:hi].copy()
    partition.global_sites = sites
    partition.site_range = (lo, hi)
    partition.sites = hi - lo
    partition.sites_alloc = len(keep)
    partition.mesh = mesh
    partition._params.clear()
