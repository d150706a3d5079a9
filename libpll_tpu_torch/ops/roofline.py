"""Roofline probes of one card: the float32 multiply-add peak (K7) and the
speed of light of the DNA contraction on resident data (K8), their plain
PyTorch versions, the CUDA wrappers and the chain timing.

    python3 -m libpll_tpu_torch.ops.roofline

Counterpart: ``scripts/bench_vpu_roofline.py``.  K7 replaces
``vpu_fma_peak`` (``:84``, ``pallas_call`` at ``:102``), K8 replaces
``roll_contract_sustained`` (``:110``, ``pallas_call`` at ``:139``); both
kernels are ``csrc/roofline.cu``, which says how they are laid out on the
card.  ``main`` is the counterpart of the script's ``main`` (``:147-183``):
it prints the sustained rate of each probe, and K7's share of the card's
FP32 peak computed from its SM count and clock.

Method (the script's, with CUDA events): the repetition loop lives inside
one launch; two chain lengths ``k1 < k2`` are timed as interleaved pairs,
each pair's difference divided by ``k2 - k1`` is the time of one
iteration, pairs with a difference <= 0 are dropped, and the rate is the
flop count of one iteration over the median.  Flop counts are the
script's: 2 per element and iteration for K7 (``:107``), (2S - 1)·C·S per
column and iteration for K8 (``:144``).

Each wrapper takes its plain version for a tensor on the CPU, and only
there: on a CUDA tensor it launches its kernel or raises.  Each counts its
launches in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..errors import EinvalError, KernelError
from . import _build

PROBE_ROWS, PROBE_LANES = 16, 512  # the TPU probes' [C*S, bl] tile
STATES = RATE_CATS = 4             # K8's DNA contraction
FP32_LANES_PER_SM = 128            # Hopper (sm_90): FP32 lanes per SM
# the two chain lengths of each probe: their difference is ~10 ms on an
# H100 at the width that fills its SMs
CHAIN = {"fma": (1 << 12, 1 << 17), "roll": (1 << 10, 1 << 14)}
PAIRS = 7


# --------------------------------------------------------------------------
# inputs and counts
# --------------------------------------------------------------------------
def probe_width(sm_count: int) -> int:
    """Tile width ``w`` (the tile is [16, 512·w]) that fills ``sm_count``
    SMs: eight K7 blocks of 256 threads × 8 accumulators per SM, and
    1 024 K8 columns (one thread each) per SM."""
    return 2 * sm_count


def fma_input(w: int, device=None) -> torch.Tensor:
    """K7's tile, as the script draws it: uniform(0.9, 1.1) from seed 0,
    [16, 512·w] float32."""
    x = np.random.default_rng(0).uniform(0.9, 1.1,
                                         (PROBE_ROWS, PROBE_LANES * w))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def roll_inputs(w: int, device=None):
    """K8's tile and coefficients, as the script draws them:
    uniform(0.9, 1.1) [C·S, 512·w] from seed 1, uniform(0.2, 0.3) [C·S, S]
    from seed 2, float32."""
    cs = STATES * RATE_CATS
    x = np.random.default_rng(1).uniform(0.9, 1.1, (cs, PROBE_LANES * w))
    c = np.random.default_rng(2).uniform(0.2, 0.3, (cs, STATES))
    return (torch.from_numpy(x.astype(np.float32)).to(device),
            torch.from_numpy(c.astype(np.float32)).to(device))


def fma_flops(x: torch.Tensor) -> int:
    """Flops of one K7 iteration: 2 per element (``:107``)."""
    return 2 * x.numel()


def roll_flops(x: torch.Tensor, states: int = STATES) -> int:
    """Flops of one K8 iteration: (2S - 1)·C·S per column (``:144``)."""
    return (2 * states - 1) * x.numel()


def renorm(states: int = STATES) -> float:
    """The script's per-iteration renormalisation, 1 / (S·0.25)."""
    return 1.0 / (states * 0.25)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def fma_chain_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain K7: ``acc <- acc·c + x`` k times from acc = x, c = x[0, 0]."""
    c = x[0, 0]
    acc = x.clone()
    for _ in range(k):
        acc = acc * c + x
    return acc


def roll_contract_plain(x: torch.Tensor, coeff: torch.Tensor, k: int,
                        states: int = STATES,
                        rate_cats: int = RATE_CATS) -> torch.Tensor:
    """Plain K8: k times ``x <- (Σ_d coeff[:, d]·roll(x, (C·S - d·C) % C·S,
    0)) · renorm`` (jnp.roll's direction: row r reads row (r + d·C) mod
    C·S)."""
    cs = states * rate_cats
    for _ in range(k):
        acc = coeff[:, 0:1] * x
        for d in range(1, states):
            acc = acc + coeff[:, d:d + 1] * torch.roll(
                x, (cs - d * rate_cats) % cs, 0)
        x = acc * renorm(states)
    return x


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def load_kernels() -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/roofline.cu``, once per
    process."""
    lib = _build.load("roofline")
    lib.roofline_fma_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_void_p]
    lib.roofline_roll_contract.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    for fn in (lib.roofline_fma_chain, lib.roofline_roll_contract):
        fn.restype = ctypes.c_int
    lib.roofline_error_string.argtypes = [ctypes.c_int]
    lib.roofline_error_string.restype = ctypes.c_char_p
    return lib


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise EinvalError(f"roofline probe input: {what}")


def _check(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.roofline_error_string(rc).decode()
        raise KernelError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _check_tile(x: torch.Tensor, rows: int) -> None:
    _require(x.device.type == "cuda", f"probes run on CUDA tensors, not "
             f"{x.device}")
    _require(x.dtype == torch.float32 and x.dim() == 2
             and x.shape[0] == rows and x.is_contiguous(),
             f"tile {tuple(x.shape)} {x.dtype}, want [{rows}, N] float32 "
             "contiguous")
    _require(x.numel() > 0, "empty tile")


def fma_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """K7: ``acc <- acc·x[0, 0] + x``, k times, over a [16, N] float32
    tile; returns acc.  CPU tensors take :func:`fma_chain_plain`."""
    if x.device.type == "cpu":
        return fma_chain_plain(x, k)
    _check_tile(x, PROBE_ROWS)
    _require(0 <= k < 2 ** 31, f"chain length {k}")
    out = torch.empty_like(x)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        rc = lib.roofline_fma_chain(
            x.data_ptr(), out.data_ptr(), x.numel(), k,
            torch.cuda.current_stream().cuda_stream)
    _check(lib, rc, "fma_chain")
    fma_chain.launches += 1
    return out


fma_chain.launches = 0


def roll_contract(x: torch.Tensor, coeff: torch.Tensor,
                  k: int) -> torch.Tensor:
    """K8: the DNA contraction carried k times over a [16, N] float32 tile
    with [16, 4] coefficients (C = S = 4).  CPU tensors take
    :func:`roll_contract_plain`."""
    if x.device.type == "cpu":
        return roll_contract_plain(x, coeff, k)
    cs = STATES * RATE_CATS
    _check_tile(x, cs)
    _require(coeff.device == x.device and coeff.dtype == torch.float32
             and tuple(coeff.shape) == (cs, STATES)
             and coeff.is_contiguous(),
             f"coeff {tuple(coeff.shape)} {coeff.dtype} on {coeff.device}")
    _require(0 <= k < 2 ** 31, f"chain length {k}")
    out = torch.empty_like(x)
    lib = load_kernels()
    with torch.cuda.device(x.device):
        rc = lib.roofline_roll_contract(
            x.data_ptr(), coeff.data_ptr(), out.data_ptr(), x.shape[1], k,
            renorm(), torch.cuda.current_stream().cuda_stream)
    _check(lib, rc, "roll_contract")
    roll_contract.launches += 1
    return out


roll_contract.launches = 0


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------
def event_ms(fn) -> float:
    """Device time of one call of ``fn``, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def chain_rate(run, flops_per_iter: int, k1: int, k2: int,
               pairs: int = PAIRS):
    """(flop/s, seconds per iteration, kept differences) from ``run(k)``
    timed at two chain lengths in interleaved pairs; differences <= 0 are
    dropped, and the rate is taken at their median."""
    run(k1)
    run(k2)  # warm-up
    dts = []
    for i in range(pairs):
        order = (k1, k2) if i % 2 == 0 else (k2, k1)
        t = {k: event_ms(lambda k=k: run(k)) for k in order}
        dt = (t[k2] - t[k1]) * 1e-3 / (k2 - k1)
        if dt > 0:
            dts.append(dt)
    if not dts:
        raise KernelError("every timed pair gave a difference <= 0")
    per_iter = statistics.median(dts)
    return flops_per_iter / per_iter, per_iter, dts


def fp32_peak(sm_count: int, clock_mhz: float) -> float:
    """The card's FP32 multiply-add peak in flop/s: SMs × 128 lanes × 2
    flop per clock."""
    return sm_count * FP32_LANES_PER_SM * 2 * clock_mhz * 1e6


def max_sm_clock_mhz() -> float:
    """The card's maximum SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()
    return float(out[0])


def measure(device) -> dict:
    """Both probes' sustained rates on ``device`` at the width that fills
    its SMs, and K7's share of the FP32 peak."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    w = probe_width(sms)
    x = fma_input(w, device)
    fma, fma_iter, _ = chain_rate(lambda k: fma_chain(x, k), fma_flops(x),
                                  *CHAIN["fma"])
    rx, coeff = roll_inputs(w, device)
    roll, roll_iter, _ = chain_rate(lambda k: roll_contract(rx, coeff, k),
                                    roll_flops(rx), *CHAIN["roll"])
    clock = max_sm_clock_mhz()
    return dict(sm_count=sms, width=w, max_clock_mhz=clock,
                peak=fp32_peak(sms, clock), fma=fma, fma_iter_s=fma_iter,
                roll=roll, roll_iter_s=roll_iter)


def main() -> int:
    if not torch.cuda.is_available():
        print("roofline: FAILED: torch.cuda.is_available() is false: the "
              "probes need a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    m = measure(device)
    print(f"card: {card}; {m['sm_count']} SMs, max SM clock "
          f"{m['max_clock_mhz']:.0f} MHz: FP32 peak {m['peak'] / 1e12:.2f} "
          f"Tflop/s", flush=True)
    print(f"K7 FP32 multiply-add sustained ([16, {PROBE_LANES * m['width']}]"
          f" tile): {m['fma'] / 1e12:.2f} Tflop/s, "
          f"{m['fma'] / m['peak'] * 100:.1f}% of the peak", flush=True)
    print(f"K8 DNA contraction sustained (registers, [16, "
          f"{PROBE_LANES * m['width']}] tile): {m['roll'] / 1e12:.2f} "
          f"Tflop/s ({m['roll'] / m['fma'] * 100:.0f}% of K7)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
