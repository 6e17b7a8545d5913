"""The Tiles scene (`benchmark/scenes/tiles.py`) over NV12 inputs, the
layout GPU decoders write, through the port's RGBA input route, on the CPU
at a small size: 16 NV12 inputs of 192x108 into 384x216, the rest as the
configuration `benchmark/configs/tiles16_4k_nv12.json` gives it.

  - (a) the port's `Renderer` against the benchmark's plain reference
    (`benchmark/references/tiles_nv12.py`, loaded by path), over two seeded
    ticks, within the cell's limits;
  - (b) the reference one precision below the stated bf16 (float8) fails
    those limits;
  - (c) the general program's counters per call: 16 NV12 tiles made by
    the fused convert-and-resize pass, no input converted to
    full-resolution RGBA and no mip level built (both counters read 0),
    no RGBA tile resized by GEMMs; and no call of the YUV grid program,
    which the same scene over I420 inputs takes, with none of those
    counters.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smelter_tpu_torch.core import types as tt
from smelter_tpu_torch.render import program
from smelter_tpu_torch.render.renderer import Renderer
from smelter_tpu_torch.scene import components
from smelter_tpu_torch.utils import tracing

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CFG = {**json.loads((BENCH / "configs" / "tiles16_4k_nv12.json").read_text()),
       "input_width": 192, "input_height": 108, "output_width": 384, "output_height": 216}
LIMITS = json.loads((BENCH / "limits" / "tiles16_4k_nv12.steady.json").read_text())
INPUTS = [f"input_{i}" for i in range(16)]
# (a), besides the cell's limits: on the CPU the port's GEMMs sum in the
# reference's order; its conversion multiplies by 1/255 where the
# reference divides, so an f32 value moves by an ulp here and there and a
# bf16 rounding of the GEMM's operand with it (48 samples a million at
# this size): never more than one step
MAX_LSB = 1


def _load(kind: str, name: str):
    spec = importlib.util.spec_from_file_location(f"test_nv12_{kind}", BENCH / kind / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("references", "tiles_nv12.py")
SCENE = _load("scenes", "tiles.py")


def _nv12(seed: int):
    """{input id: ("NV12", (y, uv))} of random u8 planes."""
    gen = torch.Generator().manual_seed(seed)
    h, w = CFG["input_height"], CFG["input_width"]
    return {iid: ("NV12", (torch.randint(0, 256, (h, w), dtype=torch.uint8, generator=gen),
                           torch.randint(0, 256, (h // 2, w // 2, 2), dtype=torch.uint8,
                                         generator=gen)))
            for iid in INPUTS}


def _i420(planes):
    """The same frames with their chroma split into planes (I420)."""
    return {iid: ("PLANAR_YUV420", (y, uv[..., 0].contiguous(), uv[..., 1].contiguous()))
            for iid, (_, (y, uv)) in planes.items()}


def _renderer() -> Renderer:
    r = Renderer(device="cpu")
    for iid in INPUTS:
        r.register_input(iid)
    api = SimpleNamespace(comp=components, types=tt)
    r.update_scene("out_0", SCENE.build(api, CFG, 0, "out_0"),
                   tt.Resolution(CFG["output_width"], CFG["output_height"]),
                   tt.PixelFormat.PLANAR_YUV420)
    return r


def _render(r: Renderer, k: int, planes) -> tuple:
    res = tt.Resolution(CFG["input_width"], CFG["input_height"])
    frames = {iid: tt.Frame(data=data, format=tt.PixelFormat[fmt], resolution=res, pts=k / 32)
              for iid, (fmt, data) in planes.items()}
    out = r.render(tt.FrameSet(pts=k / 32, frames=frames)).frames["out_0"]
    return tuple(p.numpy() for p in out.data)


def _lsb_and_ppm(a: tuple, b: tuple):
    d = [np.abs(x.astype(np.int16) - y.astype(np.int16)) for x, y in zip(a, b)]
    return (max(int(x.max()) for x in d),
            1e6 * sum(int(np.count_nonzero(x)) for x in d) / sum(x.size for x in d))


@pytest.fixture(scope="module")
def ticks():
    """The port's frames and the reference's in bf16 and float8, at two
    ticks of other inputs."""
    r = _renderer()
    out = []
    for k, seed in enumerate((2**31 + 28, 2**31 + 29)):
        planes = _nv12(seed)
        out.append((_render(r, k, planes),
                    REF.render(CFG, INPUTS, planes, "cpu", torch.bfloat16),
                    REF.render(CFG, INPUTS, planes, "cpu", torch.float8_e4m3fn)))
    return out


def test_the_port_meets_the_reference(ticks):
    for got, ref, _ in ticks:
        lsb, ppm = _lsb_and_ppm(got, ref)
        assert lsb <= min(MAX_LSB, LIMITS["max_lsb"]) and ppm <= LIMITS["diff_ppm"], (lsb, ppm)
    # another tick is another frame
    assert _lsb_and_ppm(ticks[0][0], ticks[1][1])[1] > 1e5


def test_the_float8_reference_fails_the_limits(ticks):
    for _, ref, lower in ticks:
        lsb, ppm = _lsb_and_ppm(lower, ref)
        assert lsb > LIMITS["max_lsb"] and ppm > LIMITS["diff_ppm"], (lsb, ppm)


def test_the_reference_clamps_at_full_resolution():
    """A saturated input: Y 255 and the chroma at its extremes convert to
    RGB clamped to [0, 1] before the resize, so the tile is white, black
    or a primary's clamp, and the resize of a flat picture keeps it flat."""
    h, w = CFG["input_height"], CFG["input_width"]
    y = torch.full((h, w), 255, dtype=torch.uint8)
    uv = torch.full((h // 2, w // 2, 2), 255, dtype=torch.uint8)
    rgba = REF.nv12_rgba(y, uv)
    # Y' = 1 (clamped from 239 / 219), U' = V' = 0.5 (clamped from 239 / 224)
    assert torch.equal(rgba[:, 0, 0], torch.tensor([1.0, 1.0 - 0.1873 * 0.5 - 0.4681 * 0.5,
                                                    1.0, 1.0]))
    assert torch.equal(rgba, rgba[:, :1, :1].expand_as(rgba))
    planes = {iid: ("NV12", (y, uv)) for iid in INPUTS}
    out_y, out_u, out_v = REF.render(CFG, INPUTS, planes, "cpu", torch.bfloat16)
    assert len(np.unique(out_y)) == len(np.unique(out_u)) == len(np.unique(out_v)) == 1


def test_general_counters_per_call():
    """Each call of the general program counts the NV12 tiles its fused
    pass makes (16), and registers the inputs it converts to
    full-resolution RGBA and the mip levels it builds for them beyond
    level 0 with none: no static upright tile reads them (`_mip_levels`
    gives 2 levels at 108 rows and 5 at 1080, which each converted input
    would build); no RGBA tile is resized by GEMMs and the YUV grid program
    never runs. The same scene over I420 inputs takes the grid program,
    which counts none of them."""
    assert program._mip_levels(tt.Resolution(192, 108)) == 2
    assert program._mip_levels(tt.Resolution(1920, 1080)) == 5
    planes = _nv12(2**31 + 30)
    for inputs, route in ((planes, "general"), (_i420(planes), "grid")):
        r = _renderer()
        _render(r, 0, inputs)  # the capture
        tracing.reset()
        try:
            for k in range(1, 4):
                _render(r, k, inputs)
            c = tracing.counters()
        finally:
            tracing.reset()
        assert c["program.calls"] == c[f"program.calls.{route}"] == 3
        per_call = {k: c.get(f"program.general.{k}", 0) / 3
                    for k in ("rgba_converts", "mip_levels", "rgba_tiles", "tile_converts",
                              "nv12_tiles")}
        if route == "general":
            assert "program.calls.grid" not in c
            assert per_call == {"rgba_converts": 0, "mip_levels": 0, "rgba_tiles": 0,
                                "tile_converts": 0, "nv12_tiles": 16}
            # registered, so that their readers read 0 and not nothing
            assert c["program.general.rgba_converts"] == c["program.general.mip_levels"] == 0
        else:
            assert per_call == dict.fromkeys(per_call, 0)
            assert c["program.grid.tile_planes"] == 3 * 48
