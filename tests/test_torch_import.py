"""The PyTorch port imports without JAX, Triton, PIL, websockets or any
module of the reference package (and renders a scene of its own components
with a shader, an image asset and a WebView without them: PIL is loaded
only to raster a Text or decode an image, websockets only to reach a
browser), and its pipeline without aiohttp, pydantic or cryptography; its
MoQ and QUIC edges without the reference package; its multi-device steps
(`parallel/mesh.py`, `graft_entry.py`) without JAX or the reference, in
the launching process and in the ranks it spawns; its benchmark
(`bench.py`), examples and measurement tools (`tools/`) without them
either; the protocol edges load their native helpers (DTLS, DeckLink) only
when an endpoint is made; its
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
r.register_shader("fade", "def main(inputs, params, resolution, time):\\n"
                  "    return inputs[0] * (0.5 + 0.5 * jnp.sin(time))\\n")
from smelter_tpu_torch.render.image import ImageAsset
from smelter_tpu_torch.render.web import WebRendererSpec
r.images.put("logo", ImageAsset("bitmap", [np.full((8, 8, 4), 200, np.uint8)], [0.0], 8, 8))
r.web.register(WebRendererSpec(instance_id="page", url="about:blank", resolution=(16, 8)))
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
              background_color=RGBAColor(200, 0, 0, 200)),
    comp.Shader(shader_id="fade", width=64.0, height=32.0,
                children=[comp.InputStream(input_id="in_0")]),
    comp.Image(image_id="logo"), comp.WebView(instance_id="page")]),
    Resolution(128, 72), PixelFormat.PLANAR_YUV420)
y, u, v = r.render(FrameSet(pts=0.0, frames=inputs)).frames["out"].data
assert tuple(y.shape) == (72, 128) and tuple(u.shape) == (36, 64)
reference = [m for m in sys.modules if m == "smelter_tpu" or m.startswith("smelter_tpu.")]
edges = [n for n in names if n.startswith("smelter_tpu_torch.io.")
         and n.split(".")[-1] not in ("codec", "native_lib")]
print(len(edges), len(names), "jax" in sys.modules, "triton" in sys.modules, "PIL" in sys.modules,
      "websockets" in sys.modules, len(reference))
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
    n_edges, n_modules, has_jax, has_triton, has_pil, has_ws, n_reference = out.stdout.split()
    assert int(n_modules) >= 10  # every module of the port was imported
    # the protocol edges: rtp, rtcp, rtmp/*, webrtc/*, v4l2, decklink, moq/*, quic/*
    assert int(n_edges) == 34
    assert has_jax == "False"
    assert has_triton == "False"
    assert has_pil == "False"  # no Text rendered, no image decoded
    assert has_ws == "False"  # no web renderer sidecar connected
    assert n_reference == "0"  # no module of the reference package loaded


_EDGE_LIBRARIES = """
import sys
def loaded():
    with open("/proc/self/maps") as f:
        maps = f.read()
    return [n for n in ("libsmelter_dtls", "libsmelter_decklink") if n in maps]

import smelter_tpu_torch.server.app, smelter_tpu_torch.io.webrtc, smelter_tpu_torch.io.decklink
from smelter_tpu_torch.io.rtmp import RtmpServerInput
before = loaded()
from smelter_tpu_torch.io.webrtc.dtls import DtlsEndpoint
DtlsEndpoint(is_server=True).close()
after_dtls = loaded()
from smelter_tpu_torch.io.decklink import DeckLinkInput
try:
    DeckLinkInput()
except OSError:
    pass
print(before, after_dtls, loaded(), sorted({m.split(".")[0] for m in sys.modules}
                                           & {"jax", "smelter_tpu"}))
"""


def test_edge_libraries_load_only_when_an_endpoint_is_made():
    """Importing the server and the edges loads neither native helper: the
    DTLS helper loads with the first `DtlsEndpoint`, the DeckLink shim with
    the first DeckLink input, as in the reference."""
    out = subprocess.run([sys.executable, "-c", _EDGE_LIBRARIES], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "[] ['libsmelter_dtls'] ['libsmelter_dtls', 'libsmelter_decklink'] []")


def test_pipeline_imports_without_the_server_stack():
    """The card's machine has neither aiohttp nor pydantic: the pipeline
    must import without them (only the server and the API schema need
    them), and without `cryptography` (only the MoQ, QUIC and WebRTC edges
    need it)."""
    code = ("import sys, smelter_tpu_torch.pipeline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'aiohttp', 'pydantic', 'jax', 'smelter_tpu', 'cryptography'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_MOQ_QUIC = """
import importlib, pkgutil, sys
import smelter_tpu_torch.io.moq, smelter_tpu_torch.io.quic
names = sorted(m.name for p in ("moq", "quic") for m in pkgutil.walk_packages(
    getattr(smelter_tpu_torch.io, p).__path__, f"smelter_tpu_torch.io.{p}."))
for name in names:
    importlib.import_module(name)
print(len(names), sorted({m.split(".")[0] for m in sys.modules} & {"jax", "smelter_tpu"}),
      "aiohttp" in sys.modules, "pydantic" in sys.modules)
"""


def test_moq_and_quic_import_without_the_reference():
    """The 13 modules under `io/moq/` and `io/quic/` (and the packages
    themselves) load neither JAX nor any module of the reference package,
    nor the server stack."""
    out = subprocess.run([sys.executable, "-c", _MOQ_QUIC], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["13", "[]", "False", "False"]


_MESH = """
import sys, tempfile
from smelter_tpu_torch import graft_entry
from smelter_tpu_torch.parallel import mesh
with tempfile.TemporaryDirectory() as tmp:
    ranks = mesh.launch(graft_entry.run_cases, 2, ("cpu", 1, (), 0, tmp))
print(sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "smelter_tpu"}),
      [r["foreign_modules"] for r in ranks])
"""


def test_mesh_and_its_ranks_import_without_jax():
    """`parallel/mesh.py` and `graft_entry.py` load neither JAX nor the
    reference, and neither does a rank they spawn (each reports the modules
    of its own process): a spawned process imports its target's module
    afresh, with the launcher's environment (JAX_PLATFORMS, XLA_FLAGS)."""
    out = subprocess.run([sys.executable, "-c", _MESH], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] [[], []]"


_BENCH_EXAMPLES = """
import sys
import smelter_tpu_torch.bench
import smelter_tpu_torch.examples.offline_compose
import smelter_tpu_torch.examples.flagship_live
import smelter_tpu_torch.examples.moq_relay
print(sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "smelter_tpu"}))
"""


def test_bench_and_examples_import_without_jax():
    """`smelter_tpu_torch.bench` and the examples load neither JAX nor any
    module of the reference package."""
    out = subprocess.run([sys.executable, "-c", _BENCH_EXAMPLES], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_TOOLS = """
import importlib, pkgutil, sys
import smelter_tpu_torch.tools
names = sorted(m.name for m in pkgutil.iter_modules(smelter_tpu_torch.tools.__path__))
for name in names:
    importlib.import_module(f"smelter_tpu_torch.tools.{name}")
print(" ".join(names), sorted({m.split(".")[0] for m in sys.modules} & {"jax", "jaxlib", "smelter_tpu"}))
"""


def test_tools_import_without_jax():
    """Every module of `smelter_tpu_torch.tools` (the measurement tools and
    the rest of the reference's `tools/`) loads neither JAX nor any module
    of the reference package."""
    out = subprocess.run([sys.executable, "-c", _TOOLS], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "_ab _inputs _profile bench_align_ab bench_animations bench_assembly_ab "
        "bench_canvas_ab bench_flagship_ops bench_latency bench_offline "
        "bench_overlap bench_scenes bench_streams dependency_check docs_examples "
        "frame_inspector generate_schemas generate_ts_types release soak_live soak_web "
        "waveform_inspector []")


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
