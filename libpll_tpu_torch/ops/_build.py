"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library that
ctypes loads; nothing includes PyTorch's headers, so a build takes seconds.
The library lands in ``libpll_tpu_torch/_build/`` under a file name keyed
on the hash of the source and the flags, at first use: a changed source
builds anew, an unchanged one loads what is there.  ``nvcc``'s resource
report (``-Xptxas -v``: registers, spills, shared memory per kernel) is
kept beside the library as ``<name>-<hash>.log``.

Counterpart: none in ``libpll_tpu`` (Pallas kernels compile inside jit).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..errors import KernelError

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library for this exact source and
    these flags exists; return the library's path."""
    src = CSRC_DIR / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private temporary name, then an atomic rename: concurrent builds
    # (test workers) never load a half-written library
    tmp = BUILD_DIR / f"{name}-{key}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelError(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name)))
