"""The port stands alone: every module of ``repro_torch`` and
``chip_smoke.py`` load with ``jax`` and the reference package blocked, and
no file of theirs imports the reference package."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
    for p in PORT.rglob("*.py") if p.name != "__init__.py")

_BLOCKED = r"""
import importlib, sys
for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
    sys.modules[name] = None  # any import of these raises ImportError
for mod in sys.argv[1:]:
    importlib.import_module(mod)
    assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                   for m, v in sys.modules.items() if v is not None), mod
"""


def test_port_modules_found():
    assert "repro_torch.kernels.fused_gemm" in MODULES
    assert "repro_torch.serve.engine" in MODULES
    assert "repro_torch.bridge" in MODULES
    for name in ("w4a4", "prologue", "actquant", "context"):
        assert f"repro_torch.kernels.{name}" in MODULES
    assert "repro_torch.configs.phi3_mini_3_8b" in MODULES
    assert "repro_torch.kernels.flash_attn" in MODULES
    assert "repro_torch.serve.kvquant" in MODULES
    for name in ("data.tokens", "data.loader", "core.stats", "core.hadamard",
                 "core.rotation", "core.gptq", "core.lrc", "quant.rotate",
                 "quant.calibrate", "bench.kv_sweep", "kernels.hadamard",
                 "bench.latency_kernels", "bench.common", "checkpoint.ckpt",
                 "serve.faults", "serve.journal", "launch.serve", "models.remat",
                 "train.optimizer", "train.steps", "train.trainer", "launch.train",
                 "bench.table1_w4a4", "bench.table2_groups", "bench.table3_weightonly",
                 "bench.fig2_rank_sweep", "bench.fig3_quantizer", "bench.run"):
        assert f"repro_torch.{name}" in MODULES


@pytest.mark.parametrize("chunk", [MODULES[0::2], MODULES[1::2] + ["chip_smoke"]])
def test_modules_import_with_jax_blocked(chunk):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    subprocess.run([sys.executable, "-c", _BLOCKED, *chunk], check=True,
                   env=env, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("first", ["repro_torch.models.common",
                                   "repro_torch.quant.calibrate",
                                   "repro_torch.serve.kvquant",
                                   "repro_torch.serve"])
def test_no_import_cycle(first):
    """Each of these, imported first in a fresh interpreter, loads: the
    model's attention imports ``serve.kvquant`` and the engine imports the
    model, so the serve package must not import the engine eagerly."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    subprocess.run([sys.executable, "-c", _BLOCKED, first,
                    "repro_torch.serve.engine"], check=True, env=env, cwd=ROOT,
                   timeout=300)


_REFERENCE_IMPORT = re.compile(r"^\s*(from|import)\s+repro(\.|\s|$)", re.M)


def test_no_file_imports_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [str(p) for p in files
                 if _REFERENCE_IMPORT.search(p.read_text())
                 or re.search(r"^\s*(from|import)\s+jax", p.read_text(), re.M)]
    assert not offenders
