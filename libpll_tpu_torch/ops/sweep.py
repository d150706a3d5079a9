"""Level-major pruning sweep: the plain PyTorch reference of the fused
kernels.

Counterpart: ``libpll_tpu/ops/sweep.py``.  :func:`build_level_schedule` is
copied (host numpy); :func:`make_level_sweep` is the same algorithm in
PyTorch:

  * inner CLVs are renumbered *level-major* so each dependency level's
    parents occupy one contiguous row range and land with one slice write;
  * children are fetched with one batched gather per side and contracted by
    a single batched ``[S,S] @ [S, L]`` matmul per side.

Scaler rows are also level-major: inner node at CLV row ``tips + k`` owns
scaler row ``k``; row ``n_inner`` is the always-zero dummy used for tips.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..utils.constants import (SCALE_NONE, SCALE_PER_SITE, scale_consts)


@dataclass(frozen=True)
class Level:
    """One dependency level, child indices in renumbered (level-major) space."""

    child1: np.ndarray  # [w] int32 CLV rows
    matrix1: np.ndarray  # [w] int32
    child2: np.ndarray  # [w] int32
    matrix2: np.ndarray  # [w] int32
    scaler1: np.ndarray  # [w] int32 scaler rows (dummy for tips/no-scaler)
    scaler2: np.ndarray  # [w] int32
    offset: int  # first parent CLV row (parents are offset..offset+w-1)
    has_scaler: np.ndarray  # [w] bool (parent writes a scaler row)


@dataclass(frozen=True)
class LevelSchedule:
    levels: Tuple[Level, ...]
    tips: int
    n_inner: int
    clv_map: dict  # original clv index -> level-major row
    scaler_map: dict  # original scaler index -> level-major scaler row


def build_level_schedule(operations: Sequence, tips: int) -> LevelSchedule:
    """Group ops into dependency levels and renumber CLVs level-major.

    Tips keep rows 0..tips-1; the k-th inner node *in level order* gets CLV
    row tips+k and scaler row k. Returns the schedule plus index maps for
    translating evaluation-edge indices.
    """
    from ..engine.partition import Operation

    rows = []
    for op in operations:
        t = op.as_tuple() if isinstance(op, Operation) else tuple(op)
        rows.append(t)

    level_of = {}
    levels_raw: List[List[tuple]] = []
    for t in rows:
        c1, c2 = t[2], t[5]
        lvl = max(level_of.get(c1, -1), level_of.get(c2, -1)) + 1
        while len(levels_raw) <= lvl:
            levels_raw.append([])
        levels_raw[lvl].append(t)
        level_of[t[0]] = lvl

    clv_map = {i: i for i in range(tips)}
    scaler_map = {}
    n_inner = 0
    dummy_scaler = sum(len(lv) for lv in levels_raw)  # row n_inner at the end

    levels: List[Level] = []
    for lv in levels_raw:
        w = len(lv)
        offset = tips + n_inner

        def srow(orig_scaler, child_row):
            # child scaler row in level-major space: derived from the child's
            # clv row (inner nodes own their row), dummy for tips / -1
            if orig_scaler < 0 or child_row < tips:
                return dummy_scaler
            return child_row - tips

        c1 = np.empty(w, np.int32)
        m1 = np.empty(w, np.int32)
        c2 = np.empty(w, np.int32)
        m2 = np.empty(w, np.int32)
        s1 = np.empty(w, np.int32)
        s2 = np.empty(w, np.int32)
        has = np.empty(w, bool)
        for k, t in enumerate(lv):
            (p, ps, tc1, tm1, ts1, tc2, tm2, ts2) = t
            c1[k] = clv_map[tc1]
            c2[k] = clv_map[tc2]
            m1[k], m2[k] = tm1, tm2
            s1[k] = srow(ts1, c1[k])
            s2[k] = srow(ts2, c2[k])
            has[k] = ps >= 0
            clv_map[p] = offset + k
            if ps >= 0:
                scaler_map[ps] = offset + k - tips
        levels.append(Level(c1, m1, c2, m2, s1, s2, offset, has))
        n_inner += w

    return LevelSchedule(tuple(levels), tips, n_inner, clv_map, scaler_map)


def make_level_sweep(schedule: LevelSchedule, scale_mode: int = SCALE_PER_SITE):
    """Build ``sweep(clv, scalers, pmatrix) -> (clv, scalers)``.

    clv: [tips + n_inner, C, S, L] (level-major rows).
    scalers: [n_inner + 1, L] / [n_inner + 1, C, L] int32; last row dummy.
    The inputs are left untouched: the sweep writes into copies.
    """
    tips = schedule.tips

    def sweep(clv, scalers, pmatrix):
        thresh, factor = scale_consts(clv.dtype)
        clv, scalers = clv.clone(), scalers.clone()

        def rows(a):
            return torch.as_tensor(a, dtype=torch.long, device=clv.device)

        for lev in schedule.levels:
            x = (torch.matmul(pmatrix[rows(lev.matrix1)],
                              clv[rows(lev.child1)])
                 * torch.matmul(pmatrix[rows(lev.matrix2)],
                                clv[rows(lev.child2)]))
            w = x.shape[0]
            if scale_mode != SCALE_NONE:
                has = torch.as_tensor(lev.has_scaler, device=clv.device)
                if scale_mode == SCALE_PER_SITE:
                    mask = (x < thresh).all(dim=2).all(dim=1) & has[:, None]
                    x = torch.where(mask[:, None, None, :], x * factor, x)
                else:  # SCALE_PER_RATE
                    mask = (x < thresh).all(dim=2) & has[:, None, None]
                    x = torch.where(mask[:, :, None, :], x * factor, x)
                off = lev.offset - tips
                # the dummy row is never written (scaler writes are
                # contiguous level rows), so it stays zero
                scalers[off:off + w] = (scalers[rows(lev.scaler1)]
                                        + scalers[rows(lev.scaler2)]
                                        + mask.to(scalers.dtype))
            clv[lev.offset:lev.offset + w] = x
        return clv, scalers

    return sweep
