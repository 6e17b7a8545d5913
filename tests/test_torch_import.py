"""The PyTorch port imports without JAX, Triton, PIL or any module of the
reference package (and renders a View/Tiles scene built from its own
components without them), and its pipeline without aiohttp or pydantic; its
entry points refuse to run without a card unless given `device="cpu"`; and
`chip_smoke.py` refuses to run (non-zero exit, no "ok" line) where torch
sees no CUDA card."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import smelter_tpu_torch
names = [m.name for m in pkgutil.walk_packages(smelter_tpu_torch.__path__, "smelter_tpu_torch.")]
for name in names:
    importlib.import_module(name)

import numpy as np
from smelter_tpu_torch.core.types import Frame, FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu_torch.render.renderer import Renderer
from smelter_tpu_torch.scene import components as comp

r = Renderer(device="cpu")
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
reference = [m for m in sys.modules if m == "smelter_tpu" or m.startswith("smelter_tpu.")]
print(len(names), "jax" in sys.modules, "triton" in sys.modules, "PIL" in sys.modules,
      len(reference))
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
    n_modules, has_jax, has_triton, has_pil, n_reference = out.stdout.split()
    assert int(n_modules) >= 10  # every module of the port was imported
    assert has_jax == "False"
    assert has_triton == "False"
    assert has_pil == "False"
    assert n_reference == "0"  # no module of the reference package loaded


def test_pipeline_imports_without_the_server_stack():
    """The card's machine has neither aiohttp nor pydantic: the pipeline
    must import without them (only the server and the API schema need
    them)."""
    code = ("import sys, smelter_tpu_torch.pipeline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'aiohttp', 'pydantic', 'jax', 'smelter_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_need_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here: the entry points would run on it")
    from smelter_tpu_torch.core.types import PixelFormat, Resolution
    from smelter_tpu_torch.parallel.flagship import (
        make_flagship_compose,
        make_flagship_general_compose,
    )
    from smelter_tpu_torch.pipeline import Pipeline
    from smelter_tpu_torch.render.program import OutputProgram
    from smelter_tpu_torch.render.renderer import Renderer

    tiny = dict(n_inputs=1, in_res=Resolution(64, 32), out_res=Resolution(64, 32))
    for entry in (Renderer, Pipeline, lambda: make_flagship_compose(**tiny),
                  lambda: make_flagship_general_compose(**tiny),
                  lambda: OutputProgram(None, Resolution(64, 32), PixelFormat.RGBA)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            entry()
    assert Renderer(device="cpu").device == torch.device("cpu")
    assert Pipeline(device="cpu").renderer.device == torch.device("cpu")


def test_chip_smoke_fails_without_cuda():
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT,
        env=_env(CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
