"""The PyTorch port imports without JAX, Triton or PIL (and renders a
View/Tiles scene without them), and `chip_smoke.py` refuses to run (non-zero
exit, no "ok" line) where torch sees no CUDA card."""

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

import numpy as np
from smelter_tpu.core.types import Frame, FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu.scene import components as comp
from smelter_tpu_torch.render.renderer import Renderer

r = Renderer()
inputs = {}
for i in range(2):
    r.register_input(f"in_{i}")
    planes = (np.full((32, 64), 16 + 60 * i, np.uint8), np.full((16, 32), 128, np.uint8),
              np.full((16, 32), 128, np.uint8))
    inputs[f"in_{i}"] = Frame(data=planes, format=PixelFormat.PLANAR_YUV420,
                              resolution=Resolution(64, 32), pts=0.0)
r.update_scene("out", comp.View(background_color=RGBAColor(0, 0, 0), children=[
    comp.Tiles(children=[comp.InputStream(input_id=i) for i in inputs]),
    comp.View(position=comp.AbsolutePosition(width=40.0, height=20.0, top=4.0, left=4.0),
              background_color=RGBAColor(200, 0, 0, 200))]),
    Resolution(128, 72), PixelFormat.PLANAR_YUV420)
y, u, v = r.render(FrameSet(pts=0.0, frames=inputs)).frames["out"].data
assert tuple(y.shape) == (72, 128) and tuple(u.shape) == (36, 64)
print(len(names), "jax" in sys.modules, "triton" in sys.modules, "PIL" in sys.modules)
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
    n_modules, has_jax, has_triton, has_pil = out.stdout.split()
    assert int(n_modules) >= 10  # every module of the port was imported
    assert has_jax == "False"
    assert has_triton == "False"
    assert has_pil == "False"


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
