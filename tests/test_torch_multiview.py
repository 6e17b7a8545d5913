"""The styled multiview (`benchmark/scenes/multiview.py`: a Tiles of 16
Rescaler cards, even ones rounded and bordered, odd ones rounded and
shadowed) through the port's general RGBA route, on the CPU at a small
size: 16 inputs of 192x108 into 768x432, the style values as the
configuration `benchmark/configs/multiview16_4k.json` gives them.

  - (a) the port's `Renderer` against the benchmark's plain reference
    (`benchmark/references/multiview.py`, loaded by path), over two seeded
    ticks;
  - (b) the reference by hand: the Tiles rects, a rounded corner's
    coverage, the border's and the background's BT.709 values, a shadow;
  - (c) the reference one precision below the stated bf16 (float8) fails
    the tolerances of (a);
  - (d) the general program's counters per call equal what the compose
    runs: its groups, its K1 members, the colour and shadow members K4
    evaluates, its tile converts, and no shear.
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
from smelter_tpu_torch.ops import color_convert, compose
from smelter_tpu_torch.ops.hopper import group_blend, scene_assembly
from smelter_tpu_torch.render.renderer import Renderer
from smelter_tpu_torch.scene import components
from smelter_tpu_torch.utils import tracing

torch.set_num_threads(2)

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
CFG = {**json.loads((BENCH / "configs" / "multiview16_4k.json").read_text()),
       "input_width": 192, "input_height": 108, "output_width": 768, "output_height": 432}
INPUTS = [f"input_{i}" for i in range(16)]
# (a): on the CPU the port's GEMMs sum in the reference's order; its colour
# tail multiplies by 1/255 where the reference divides, and its BT.709
# matrix out is written in another order, so a rounding tie moves by one
# step here and there (2-8 samples a million measured at this size)
MAX_LSB, MAX_PPM = 1, 100


def _load(kind: str, name: str):
    spec = importlib.util.spec_from_file_location(f"test_multiview_{kind}", BENCH / kind / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _load("references", "multiview.py")
SCENE = _load("scenes", "multiview.py")


def _planes(seed: int):
    """{input id: ("PLANAR_YUV420", (y, u, v))} of random u8 planes."""
    gen = torch.Generator().manual_seed(seed)
    h, w = CFG["input_height"], CFG["input_width"]
    return {iid: ("PLANAR_YUV420", tuple(
        torch.randint(0, 256, s, dtype=torch.uint8, generator=gen)
        for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))) for iid in INPUTS}


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
    frames = {iid: tt.Frame(data=data, format=tt.PixelFormat.PLANAR_YUV420, resolution=res,
                            pts=k / 32) for iid, (_, data) in planes.items()}
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
    for k, seed in enumerate((2**31 + 5, 2**31 + 6)):
        planes = _planes(seed)
        out.append((_render(r, k, planes),
                    REF.render(CFG, INPUTS, planes, "cpu", torch.bfloat16),
                    REF.render(CFG, INPUTS, planes, "cpu", torch.float8_e4m3fn)))
    return out


def test_the_port_meets_the_reference(ticks):
    for got, ref, _ in ticks:
        lsb, ppm = _lsb_and_ppm(got, ref)
        assert lsb <= MAX_LSB and ppm <= MAX_PPM, (lsb, ppm)
    # another tick is another frame
    assert _lsb_and_ppm(ticks[0][0], ticks[1][1])[1] > 1e5


def test_the_float8_reference_fails_the_tolerances(ticks):
    for _, ref, lower in ticks:
        lsb, ppm = _lsb_and_ppm(lower, ref)
        assert lsb > MAX_LSB and ppm > MAX_PPM, (lsb, ppm)


def test_tiles_rects_at_4k_with_margin_10():
    rects = REF.tile_rects(16, 3840, 2160, (16, 9), 10.0, 0.0)
    # 4 x 4: the height is the narrower side, (2160 - 5 x 10) / 4 = 527.5,
    # so the width is 527.5 x 16 / 9 = 937.78, centred in 3840 - 5 x 10
    th, tw = 527.5, 527.5 * 16 / 9
    left0 = (3840 - 4 * tw - 5 * 10) / 2 + 10
    assert len(rects) == 16
    for i, (top, left, h, w) in enumerate(rects):
        assert (h, w) == pytest.approx((th, tw))
        assert top == pytest.approx(10 + (i // 4) * (th + 10))
        assert left == pytest.approx(left0 + (i % 4) * (tw + 10))
    assert rects[5][:2] == pytest.approx((547.5, 977.222), abs=1e-3)
    # a bordered tile's picture fits the box less 4 pixels a side, centred
    top, left, h, w = REF.picture_rect(rects[0], 4.0, 1920, 1080)
    assert (top, h) == pytest.approx((14.0, 519.5))
    assert w == pytest.approx(519.5 * 16 / 9) and left == pytest.approx(left0 + tw / 2 - w / 2)


def test_rounded_corner_coverage():
    box = (10.0, 20.0, 100.0, 200.0)
    px = torch.tensor([25.5, 20.5, 70.5, 20.5, 219.5, 240.5])
    py = torch.tensor([60.5, 10.5, 10.5, 12.5, 109.5, 60.5])
    cov = REF.coverage(px, py, box, 24.0).tolist()
    # inside; the corner's cut (far outside the quarter circle); an edge's
    # middle, half a pixel in; inside the box but outside the rounded
    # corner; the opposite corner's cut; outside
    assert cov == [1.0, 0.0, 1.0, 0.0, 0.0, 0.0]
    # on the straight edge, a pixel centre on it is half covered
    assert REF.coverage(torch.tensor([20.0]), torch.tensor([60.5]), box, 24.0).item() == 0.5


def test_border_background_and_shadow_values():
    planes = _planes(2**31 + 7)
    y, u, v = REF.render(CFG, INPUTS, planes, "cpu", torch.bfloat16)
    # the background #52505B in BT.709 limited range, where no tile lies
    r, g, b = 82 / 255, 80 / 255, 91 / 255
    luma = 0.2126 * r + 0.7152 * g + 0.0722 * b
    bg = (round(16 + 219 * luma), round(128 + 224 * (b - luma) / 1.8556),
          round(128 + 224 * (r - luma) / 1.5748))
    assert (y[0, 0], u[0, 0], v[0, 0]) == bg
    # tile 0's box is at top 10: rows 10-13 its white border (235, 128, 128)
    # along the straight top edge; row 14 its picture's first row
    top, left, _, w = REF.tile_rects(16, 768, 432, (16, 9), 10.0, 0.0)[0]
    assert top == 10.0
    mid = int(left + w / 2) // 2 * 2
    assert (y[10:14, mid] == 235).all()
    assert (u[5:7, mid // 2] == 128).all() and (v[5:7, mid // 2] == 128).all()
    # a shadow's alpha: full at the moved box's centre, half on its edge,
    # none beyond half its blur
    shadow = CFG["style"]["odd"]["box_shadow"][0]
    box = (100.0, 100.0, 200.0, 300.0)
    at = REF.shadow_alpha(torch.tensor([258.0, 108.0, 108.0 - 12.5]),
                          torch.tensor([208.0, 208.0, 208.0]), box, 24.0, shadow)
    assert at.tolist() == [1.0, 0.5, 0.0]


def test_general_counters_per_call(monkeypatch):
    """Each call of the general program counts the groups K4 blends (the
    plain version's calls here), the members K1 paints, the colour and
    shadow members K4 evaluates (the "sdf" members `_group_member` makes),
    the deferred YUV tile converts, and no K5 pass."""
    seen = {"groups": 0, "assembly_members": 0, "sdf_members": 0, "tile_converts": 0}

    def spy(name, fn, n=lambda *a: 1):
        def wrapped(*args, **kwargs):
            seen[name] += n(*args)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(group_blend, "blend_group", spy("groups", group_blend.blend_group))
    monkeypatch.setattr(scene_assembly, "assemble_scene_planar",
                        spy("assembly_members", scene_assembly.assemble_scene_planar,
                            lambda res, specs, *a: len(specs)))
    monkeypatch.setattr(color_convert, "yuv_tile_products",
                        spy("tile_converts", color_convert.yuv_tile_products))
    group_member = compose._group_member

    def sdf_spy(*args):
        m = group_member(*args)
        seen["sdf_members"] += m.kind == "sdf"
        return m

    monkeypatch.setattr(compose, "_group_member", sdf_spy)
    r = _renderer()
    planes = _planes(2**31 + 8)
    _render(r, 0, planes)  # the capture
    seen.update({k: 0 for k in seen})
    tracing.reset()
    try:
        for k in range(1, 4):
            _render(r, k, planes)
        c = tracing.counters()
    finally:
        tracing.reset()
    assert c["program.calls.general"] == 3
    per_call = {k: c.get(f"program.general.{k}", 0) / 3 for k in seen}
    assert per_call == {k: n / 3 for k, n in seen.items()}
    assert per_call["tile_converts"] == 16 and per_call["groups"] >= 1
    # the 7 rings and 8 shadows behind a picture (K1 paints the first ring)
    assert per_call["sdf_members"] == 15
    assert per_call["assembly_members"] >= 1
    assert "program.general.shears" not in c
