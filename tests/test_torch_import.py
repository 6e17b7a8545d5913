"""The PyTorch port imports without JAX or Triton, and `chip_smoke.py`
refuses to run (non-zero exit, no "ok" line) where torch sees no CUDA card."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import smelter_tpu_torch
names = [m.name for m in pkgutil.walk_packages(smelter_tpu_torch.__path__, "smelter_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names), "jax" in sys.modules, "triton" in sys.modules)
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_port_imports_without_jax_or_triton():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    n_modules, has_jax, has_triton = out.stdout.split()
    assert int(n_modules) >= 10  # every module of the port was imported
    assert has_jax == "False"
    assert has_triton == "False"


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
