"""The port stands apart from jax, and chip_smoke.py refuses to run where
it cannot drive the card.

The test process itself imports jax (tests/conftest.py), so the import
checks run in a fresh interpreter."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = [
    "libpll_tpu_torch", "libpll_tpu_torch.errors",
    "libpll_tpu_torch.utils.constants", "libpll_tpu_torch.utils.flagship",
    "libpll_tpu_torch.io.maps", "libpll_tpu_torch.engine.partition",
    "libpll_tpu_torch.engine.evaluate", "libpll_tpu_torch.engine.params",
    "libpll_tpu_torch.tree.utree", "libpll_tpu_torch.models.gamma",
    "libpll_tpu_torch.models.gtr", "libpll_tpu_torch.ops.sweep",
    "libpll_tpu_torch.ops.pmatrix", "libpll_tpu_torch.ops.likelihood",
    "libpll_tpu_torch.ops.clv_fused", "libpll_tpu_torch.ops._build",
    "libpll_tpu_torch.ops.clv_seg", "libpll_tpu_torch.ops.clv_dyn",
    "libpll_tpu_torch.ops.roofline", "libpll_tpu_torch.tools.dyn_times",
    "libpll_tpu_torch.ops.derivatives",
]


def _run(code, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import importlib, json, sys\n"
            f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m in "
            "('jax', 'libpll_tpu') or m.startswith(('jax.', "
            "'libpll_tpu.')))))")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_a_card(alone, tmp_path):
    """No CUDA device (or no package beside the script): non-zero exit,
    and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    proc = _smoke(cwd)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    assert "FAILED" in proc.stderr
