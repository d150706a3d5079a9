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
# every module of the port (tools included), found on disk so that a new
# module cannot be missed
PORT_MODULES = sorted(
    ".".join(path.relative_to(ROOT).with_suffix("").parts).removesuffix(
        ".__init__")
    for path in (ROOT / "libpll_tpu_torch").rglob("*.py")
    if "_build" not in path.parts)


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


def test_port_modules_listed():
    for m in ("libpll_tpu_torch.io.fasta", "libpll_tpu_torch.io.compress",
              "libpll_tpu_torch.io.phylip", "libpll_tpu_torch.models.aa_tables",
              "libpll_tpu_torch.tools.fused_times",
              "libpll_tpu_torch.ops.clv", "libpll_tpu_torch.engine.checkpoint",
              "libpll_tpu_torch.tree.moves", "libpll_tpu_torch.utils.logging",
              "libpll_tpu_torch.search.stepwise",
              "libpll_tpu_torch.search.parsimony",
              "libpll_tpu_torch.ops.fitch", "libpll_tpu_torch.ops.sankoff",
              "libpll_tpu_torch.utils.rng",
              "libpll_tpu_torch.tools.stepwise_times",
              "libpll_tpu_torch.engine.blopt",
              "libpll_tpu_torch.tools.blopt_times",
              "libpll_tpu_torch.ops.incremental",
              "libpll_tpu_torch.search.spr",
              "libpll_tpu_torch.search.infer",
              "libpll_tpu_torch.parallel.mesh"):
        assert m in PORT_MODULES, m


def test_top_level_names_are_jax_packages():
    """``libpll_tpu_torch`` exports ``libpll_tpu``'s top-level names, the
    model fitting (``optimize_model``, ``ModelOptResult``) among them."""
    import types

    import numpy as np

    import libpll_tpu as jpll
    import libpll_tpu_torch as tpll

    def names(pkg):
        return {n for n in dir(pkg) if not n.startswith("_")
                and not (isinstance(getattr(pkg, n), types.ModuleType)
                         and n != "maps")}

    assert names(tpll) == names(jpll)
    assert {"optimize_model", "ModelOptResult"} <= names(tpll)
    for n in ("ASC_NONE", "ASC_LEWIS", "ASC_FELSENSTEIN", "ASC_STAMATAKIS",
              "GAMMA_RATES_MEAN", "GAMMA_RATES_MEDIAN", "SCALE_BUFFER_NONE"):
        assert getattr(tpll, n) == getattr(jpll, n), n
    assert tpll.PllError.__name__ == jpll.PllError.__name__
    assert np.array_equal(tpll.compute_gamma_cats(0.5, 4),
                          jpll.compute_gamma_cats(0.5, 4))
    assert np.array_equal(tpll.maps.pll_map_nt, jpll.maps.pll_map_nt)


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
