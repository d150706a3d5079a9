"""The block of the warp-a-rate any-alphabet instances: K1/K2
(``csrc/clv_any.cu``, wrapped by :mod:`clv_fused`) and K5/K6
(``csrc/clv_dyn_any.cu``, wrapped by :mod:`clv_dyn`), which share it
through ``csrc/any_warp.cuh``.

A block is a tile of ``ANY_SITES`` sites, a lane a site and a warp a rate,
up to ``ANY_MAX_WARPS`` warps (:func:`any_warps`); op descriptors and their
tip codes are staged ``ANY_CHUNK`` ops at a time in static shared memory
(``ANY_STATIC_SMEM`` with the votes); at S <= 16 each warp copies its next
(op, rate) unit of P-matrices into a ring of ``ANY_RING_UNITS`` units (the
kernels' kDepth: a double buffer).  The pool and rings of a block take what
leaves ``ANY_SM_WARPS`` warps an SM (:func:`any_pool_budget`): at GT16 the
registers hold an SM to 16 warps, and 16 with most rows spilled ran faster
than 4, 8 or 12 with fewer spills (PERF.md).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# 2 <= S <= ANY_MAX_STATES at any rate count (the kernels' kAnyMaxStates)
ANY_MAX_STATES = 64
ANY_SITES = 32
ANY_CHUNK = 16
ANY_MAX_WARPS = 8
ANY_STATIC_SMEM = 5120
ANY_SM_WARPS = 16
ANY_RING_UNITS = 2


def any_bound(states: int) -> int:
    """The compile-time state bound R of the instance that takes
    ``states``: 4, 8 or 16 (P-matrices staged in the warps' rings), else
    64."""
    return next(r for r in (4, 8, 16, ANY_MAX_STATES) if states <= r)


def any_warps(rate_cats: int) -> Tuple[int, int]:
    """(warps a block, rates a warp): a warp a rate up to
    ``ANY_MAX_WARPS``, then ceil(C/8) rates a warp (warp w runs rates w,
    w + W, ...)."""
    per = -(-rate_cats // ANY_MAX_WARPS)
    return -(-rate_cats // per), per


def any_pool_budget(rate_cats: int, blocks: Optional[int] = None) -> int:
    """Dynamic shared memory of one block (pool and rings) that leaves
    room for ``ANY_SM_WARPS`` warps an SM: the SM's 228 KB over the
    blocks, less the 1 KB the card reserves per block and the static part;
    four blocks of four warps at four rates.  ``blocks``: the blocks an SM
    the kernel's registers allow, where fewer share the SM (K1/K2's
    64-state instances)."""
    per_sm = max(1, ANY_SM_WARPS // any_warps(rate_cats)[0])
    if blocks:
        per_sm = min(per_sm, blocks)
    return 233472 // per_sm - 1024 - ANY_STATIC_SMEM


def any_pt(pmatrix: torch.Tensor) -> torch.Tensor:
    """[M, C, S, S] P-matrices with each matrix transposed (entry [k, j] =
    P[j, k]) and padded with zeros to [R, R], R = :func:`any_bound` (4, 8,
    16 or 64): as K1/K2 read them at every R and K5/K6 at R <= 16."""
    s = pmatrix.shape[-1]
    r = any_bound(s)
    return torch.nn.functional.pad(pmatrix.transpose(-1, -2),
                                   (0, r - s, 0, r - s)).contiguous()
