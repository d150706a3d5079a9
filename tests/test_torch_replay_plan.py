"""U1's launch plan (``ops/clv.replay_plan``), which lays out the op-table
replay kernel of ``csrc/partials.cu`` on the card: lanes a site, the ops
staged in shared memory a window at a time, the grid.  Pure host
arithmetic, checked here at the shapes the port launches U1 at: a
branch-length sweep's tables at scripts/bench_infer.py's 16 384 sites
(8-64 slots: the smallest capacity and the 32 of chip_smoke's sweep
tables), and the float64 flagship's full ``update_partials`` (262 144
sites, 62 ops); the kernel itself runs only on the card (chip_smoke phases
27-29 hold it against the plain executor at every launch), and its
launcher refuses a grid or shared memory short of what this plan gives."""

import numpy as np
import pytest

from libpll_tpu_torch.ops import clv as clv_ops

SMS = 132  # an H100 SXM
THREADS = clv_ops.REPLAY_THREADS


def lane_cover(plan, sites, rate_cats):
    """The (site, rate) pairs the plan's lanes own, by csrc/partials.cu's
    map (a warp 32 / lanes sites, lane q * (32 / lanes) + j rate q of site
    j, rates q, q + lanes, ...), as a count array [sites, rate_cats]."""
    per_warp = 32 // plan.lanes
    thread = np.arange(plan.grid * THREADS)
    lane = thread % 32
    warp = thread // 32
    site = warp * per_warp + lane % per_warp
    first = lane // per_warp
    count = np.zeros((sites, rate_cats), np.int64)
    live = site < sites
    for c in range(rate_cats):
        mine = live & (first == c % plan.lanes)
        np.add.at(count[:, c], site[mine], 1)
    return count


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("rate_cats", [1, 4, 8])
@pytest.mark.parametrize("sites, n_ops", [(16384, 8), (16384, 32),
                                          (262144, 62)])
def test_replay_plan(sites, n_ops, rate_cats, itemsize):
    """At 16 384 sites a lane per rate (C times the old lane a site, so at
    four rates 4x its threads) and the whole table staged as one window;
    at 262 144 sites one lane a site (the card is full) and the table in
    windows of two buffers; the stage within its budget; every (site,
    rate) owned by exactly one lane; the grid no larger than it must be."""
    plan = clv_ops.replay_plan(sites, rate_cats, 4, SMS, n_ops, itemsize)
    small = sites < SMS * clv_ops.REPLAY_FILL_SITES
    assert plan.lanes == (rate_cats if small else 1)
    threads = plan.grid * THREADS
    old = -(-sites // THREADS) * THREADS  # a thread a site
    assert threads >= rate_cats * old if small else threads == old
    assert plan.grid == -(-sites * plan.lanes // THREADS)
    assert plan.smem <= clv_ops.REPLAY_STAGE_BYTES
    one = clv_ops._stage_bytes(1, rate_cats, 4, itemsize)
    if plan.buffers == 1:
        assert plan.window == n_ops
        assert plan.smem == clv_ops._stage_bytes(n_ops, rate_cats, 4,
                                                 itemsize)
    else:
        assert plan.buffers == 2 and 1 <= plan.window < n_ops
        assert plan.smem == 2 * clv_ops._stage_bytes(plan.window, rate_cats,
                                                     4, itemsize)
        assert 2 * clv_ops._stage_bytes(plan.window + 1, rate_cats, 4,
                                        itemsize) > \
            clv_ops.REPLAY_STAGE_BYTES
    assert one <= clv_ops.REPLAY_STAGE_BYTES
    if n_ops == 8 and rate_cats <= 4:  # the smallest sweep tables
        assert plan.buffers == 1
    assert np.array_equal(lane_cover(plan, sites, rate_cats),
                          np.ones((sites, rate_cats), np.int64))


@pytest.mark.parametrize("rate_cats, lanes", [(2, 2), (3, 4), (5, 8),
                                              (8, 8), (16, 8)])
def test_replay_plan_lanes_and_staging(rate_cats, lanes):
    """Lanes a site: the next power of two at or above C, at most 8 (C = 16
    loops two rates a lane); protein's matrices at float64 past the stage
    budget stage nothing (window 0); the stage's sizes as csrc/partials.cu
    lays them out (each rate's matrix padded by one value, eight ints and a
    flag an op, each part rounded up to 16 bytes)."""
    plan = clv_ops.replay_plan(203, rate_cats, 4, SMS, 40, 8)
    assert plan.lanes == lanes and plan.grid == -(-203 * lanes // THREADS)
    cover = lane_cover(plan, 203, rate_cats)
    assert np.array_equal(cover, np.ones_like(cover))
    assert clv_ops._stage_bytes(3, rate_cats, 4, 8) == (
        -(-3 * 2 * rate_cats * 17 * 8 // 16) * 16 + 112)
    protein = clv_ops.replay_plan(16384, rate_cats, 20, SMS, 8, 8)
    assert protein.window == 0 and protein.smem == 0
    assert protein.lanes == lanes


@pytest.mark.parametrize("lanes, window, buffers", [(1, 32, 2), (2, 1, 2),
                                                    (4, 0, 0), (8, 40, 1)])
def test_replay_layout(lanes, window, buffers):
    """A forced layout (chip_smoke's ForcedReplayPlan): the window clipped
    to the table, one stage buffer for the whole table, two for part of
    it, none unstaged; the blocks that cover the sites at ``lanes``."""
    plan = clv_ops.replay_layout(203, 3, 4, lanes, window, 40, 4)
    assert plan.lanes == lanes and plan.window == min(window, 40)
    assert plan.buffers == buffers
    assert plan.smem == buffers * clv_ops._stage_bytes(plan.window, 3, 4, 4)
    assert plan.grid == -(-203 * lanes // THREADS)
    assert np.array_equal(lane_cover(plan, 203, 3), np.ones((203, 3),
                                                            np.int64))
