"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library that
ctypes loads; nothing includes PyTorch's headers, so a build takes seconds.
The library lands in ``libpll_tpu_torch/_build/`` under a file name keyed
on the hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, at first use: a changed source builds anew, an unchanged one loads
what is there.  :func:`build_all` starts one ``nvcc`` per source at once.
``nvcc``'s resource report (``-Xptxas -v``: registers, spills, shared
memory per kernel) is kept beside the library as ``<name>-<hash>.log``.

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
# every csrc/<name>.cu of the port
SOURCES = ("clv_fused", "clv_any", "clv_dyn", "clv_dyn_any", "clv_seg",
           "clv_seg_any", "roofline", "derivatives", "fitch", "partials")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` as it stands now lives."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_all(names) -> list:
    """Compile each ``csrc/<name>.cu`` that has no library for its exact
    sources and flags, one ``nvcc`` per source, all at once; return the
    libraries' paths."""
    outs = [library_path(name) for name in names]
    jobs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a private temporary name, then an atomic rename: concurrent
        # builds (test workers) never load a half-written library
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        src = CSRC_DIR / f"{name}.cu"
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {src.name} "
                          f"(exit {proc.returncode}):\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if failed:
        raise KernelError("\n".join(failed))
    return outs


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build_all([name])[0]))
