"""The roofline probes of the port (K7 multiply-add peak, K8 DNA
contraction) against a numpy transcription of the TPU probes' loop bodies
(``scripts/bench_vpu_roofline.py:95-98`` and ``:127-133``) at small chain
lengths, and their flop counts against the script's (``:107``,
``:144``).

On the CPU each wrapper runs its plain version.  numpy and PyTorch round
the same float32 operations in the same order here, so the probes agree to
rel 1e-6; the CUDA kernels fuse multiply and add (one rounding) and are
held against the plain versions at rel 1e-5 on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from libpll_tpu_torch.errors import EinvalError
from libpll_tpu_torch.ops import roofline as rf

RTOL = 1e-6


def fma_body_np(x, k):
    """``bench_vpu_roofline.py:91-98``: fori_loop(0, k, acc * c + x, x)
    with c = x[0, 0]."""
    c = x[0, 0]
    acc = x.copy()
    for _ in range(k):
        acc = acc * c + x
    return acc


def roll_body_np(x, coeff, k, states=4, rate_cats=4):
    """``bench_vpu_roofline.py:127-133``, with pltpu.roll read as np.roll
    along the rows."""
    cs = states * rate_cats
    for _ in range(k):
        acc = coeff[:, 0:1] * x
        for d in range(1, states):
            shift = int((cs - d * rate_cats) % cs)
            acc = acc + coeff[:, d:d + 1] * np.roll(x, shift, 0)
        x = acc * np.float32(1.0 / (states * 0.25))
    return x


@pytest.mark.parametrize("w,k", [(1, 1), (1, 16), (3, 7)])
def test_fma_chain_plain_matches_script(w, k):
    x = rf.fma_input(w)
    assert tuple(x.shape) == (16, 512 * w) and x.dtype == torch.float32
    want = fma_body_np(x.numpy(), k)
    before = rf.fma_chain.launches
    got = rf.fma_chain(x, k)
    assert rf.fma_chain.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert torch.equal(got, rf.fma_chain_plain(x, k))


@pytest.mark.parametrize("w,k", [(1, 1), (1, 16), (2, 5)])
def test_roll_contract_plain_matches_script(w, k):
    x, coeff = rf.roll_inputs(w)
    assert tuple(x.shape) == (16, 512 * w) and tuple(coeff.shape) == (16, 4)
    want = roll_body_np(x.numpy(), coeff.numpy(), k)
    got = rf.roll_contract(x, coeff, k)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # the roll's direction: row r reads row (r + d·C) mod C·S
    one = torch.zeros((16, 1))
    one[4, 0] = 1.0
    c = torch.zeros((16, 4))
    c[0, 1] = 1.0
    assert rf.roll_contract_plain(one, c, 1)[0, 0] == 1.0


def test_flop_counts_match_script():
    """2·CS·BL·w per K7 iteration (``:107``) and (2S - 1)·CS·BL·W per K8
    iteration (``:144``), with the script's CS = 16, BL = 512, W = 8."""
    cs, bl, big_w = 16, 512, 8
    for w in (1, 8, 264):
        assert rf.fma_flops(rf.fma_input(w)) == 2 * cs * bl * w
    x, _ = rf.roll_inputs(big_w)
    assert rf.roll_flops(x) == (2 * 4 - 1) * cs * bl * big_w
    assert rf.probe_width(132) * bl * cs == 132 * 8 * 256 * 8  # K7's grid
    assert rf.fp32_peak(132, 1980) == pytest.approx(66.91e12, rel=1e-3)


def test_probe_guards():
    x = rf.fma_input(1)
    with pytest.raises(EinvalError):  # a device neither CPU nor CUDA
        rf.fma_chain(x.to("meta"), 4)
    rx, coeff = rf.roll_inputs(1)
    with pytest.raises(EinvalError):
        rf.roll_contract(rx.to("meta"), coeff.to("meta"), 4)
