"""The golden snapshots of `tests/test_snapshots.py`, rendered through the
PyTorch port's `Renderer` on the CPU and compared with the committed PNGs at
`harness.ALLOWED_ERROR` (mean absolute u8 error per channel).

Only the goldens are read here: nothing is written, so a missing golden
fails instead of being created. The scenes are built with the reference's
components and reach the port's renderer (on the CPU) through
`interop.from_reference`.

Scenes of `tests/test_snapshots.py` left out, with what stops each (ROADMAP
Queue 1):
  - text_align_center_fixed, text_wrap_word, text_background_bold,
    text_lower_third_overlay: Text components, item 7;
  - image_png_fit, image_natural_size_absolute, image_svg_circle: Image
    components, item 7;
  - shader_invert, shader_param_gradient: Shader components, item 7;
  - pixel_format_rgba, pixel_format_bgra: inputs that are not planar YUV,
    item 1;
  - transition_spin_midpoint (a texture whose angle animates) and
    transition_zoom_midpoint (a texture whose size animates): animated
    texture paths, item 6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from harness import ALLOWED_ERROR, SNAPSHOT_DIR, make_test_input
from smelter_tpu.core.types import FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu.scene import components as comp
from smelter_tpu.scene.components import (
    AbsolutePosition,
    BoxShadow,
    Easing,
    HorizontalAlign,
    Overflow,
    Padding,
    RescaleMode,
    StaticPosition,
    Transition,
    VerticalAlign,
    ViewDirection,
)
from smelter_tpu.scene.layout_types import BorderRadius
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.render.renderer import Renderer

torch.set_num_threads(2)

RES = Resolution(320, 180)
IN_RES = Resolution(160, 90)
BLUE = RGBAColor(0, 0, 128, 255)
RED = RGBAColor(180, 30, 30, 255)
GREEN = RGBAColor(30, 160, 60, 255)
WHITE = RGBAColor(255, 255, 255, 255)
DARK = RGBAColor(16, 16, 16, 255)


def _inputs(n):
    return [comp.InputStream(input_id=f"input_{i}") for i in range(n)]


def _abs_view(w, h, color, children=(), **pos):
    return comp.View(position=AbsolutePosition(width=w, height=h, **pos),
                     background_color=color, children=list(children))


# name -> (number of inputs, [(pts, scene), ...]); update_scene and a render
# per step, the last render compared with the golden
CASES = {
    "view_row_3_inputs": (3, [(0.0, comp.View(background_color=BLUE,
                                              children=_inputs(3)))]),
    "view_column_3_inputs": (3, [(0.0, comp.View(
        background_color=BLUE, direction=ViewDirection.COLUMN,
        children=_inputs(3)))]),
    "view_fixed_and_dynamic_widths": (0, [(0.0, comp.View(
        background_color=BLUE, children=[
            comp.View(position=StaticPosition(width=60.0), background_color=RED),
            comp.View(background_color=GREEN),
            comp.View(position=StaticPosition(width=80.0), background_color=WHITE),
        ]))]),
    "view_absolute_positioning": (1, [(0.0, comp.View(
        background_color=BLUE, children=[
            _abs_view(120.0, 70.0, RED, _inputs(1), top=20.0, left=30.0),
            _abs_view(90.0, 50.0, GREEN, bottom=10.0, right=15.0),
        ]))]),
    "view_rotation_30deg": (1, [(0.0, comp.View(
        background_color=BLUE, children=[_abs_view(
            120.0, 70.0, RED, _inputs(1), top=50.0, left=90.0,
            rotation_degrees=30.0)]))]),
    "view_overflow_hidden": (0, [(0.0, comp.View(
        background_color=BLUE, overflow=Overflow.HIDDEN,
        children=[comp.View(position=StaticPosition(width=500.0),
                            background_color=RED)]))]),
    "view_overflow_fit": (0, [(0.0, comp.View(
        background_color=BLUE, overflow=Overflow.FIT, children=[
            comp.View(position=StaticPosition(width=400.0, height=200.0),
                      background_color=RED),
            comp.View(position=StaticPosition(width=200.0, height=100.0),
                      background_color=GREEN),
        ]))]),
    "view_padding_border": (1, [(0.0, comp.View(
        background_color=BLUE,
        padding=Padding(top=12.0, right=20.0, bottom=12.0, left=20.0),
        border_width=6.0, border_color=WHITE, children=_inputs(1)))]),
    "view_border_radius_clip": (1, [(0.0, comp.View(
        background_color=BLUE, children=[comp.View(
            position=AbsolutePosition(width=160.0, height=120.0, top=30.0,
                                      left=80.0),
            background_color=RED,
            border_radius=BorderRadius(40.0, 40.0, 40.0, 40.0),
            children=_inputs(1))]))]),
    "view_box_shadow": (0, [(0.0, comp.View(
        background_color=WHITE, children=[comp.View(
            position=AbsolutePosition(width=140.0, height=90.0, top=40.0,
                                      left=90.0),
            background_color=RED,
            border_radius=BorderRadius(12.0, 12.0, 12.0, 12.0),
            box_shadow=[BoxShadow(offset_x=10.0, offset_y=10.0, blur_radius=16.0,
                                  color=RGBAColor(0, 0, 0, 160))])]))]),
    "view_nested_layouts": (2, [(0.0, comp.View(
        background_color=BLUE, direction=ViewDirection.COLUMN, children=[
            comp.View(children=_inputs(2)),
            comp.View(background_color=GREEN, children=[comp.View(
                position=StaticPosition(width=100.0), background_color=RED)]),
        ]))]),
    **{f"tiles_{n:02d}_inputs": (n, [(0.0, comp.Tiles(
        background_color=DARK, children=_inputs(n)))]) for n in (1, 2, 3, 5, 8)},
    "tiles_margin_padding": (4, [(0.0, comp.Tiles(
        background_color=DARK, margin=8.0, padding=6.0, children=_inputs(4)))]),
    "tiles_square_align_topleft": (3, [(0.0, comp.Tiles(
        background_color=DARK, tile_aspect_ratio=(1, 1),
        horizontal_align=HorizontalAlign.LEFT, vertical_align=VerticalAlign.TOP,
        children=_inputs(3)))]),
    **{f"rescaler_{mode.value}": (1, [(0.0, comp.View(
        background_color=BLUE,
        children=[comp.Rescaler(child=_inputs(1)[0], mode=mode)]))])
       for mode in (RescaleMode.FIT, RescaleMode.FILL)},
    "rescaler_fit_align_bottom_right": (1, [(0.0, comp.View(
        background_color=BLUE, children=[comp.Rescaler(
            child=_inputs(1)[0], position=StaticPosition(width=100.0),
            mode=RescaleMode.FIT, horizontal_align=HorizontalAlign.RIGHT,
            vertical_align=VerticalAlign.BOTTOM)]))]),
    "rescaler_border_radius": (1, [(0.0, comp.View(
        background_color=WHITE, children=[comp.Rescaler(
            child=_inputs(1)[0], border_radius=BorderRadius(24.0, 24.0, 24.0, 24.0),
            border_width=4.0, border_color=RED)]))]),
    "transition_width_midpoint": (0, [
        (0.0, comp.View(background_color=BLUE, children=[comp.View(
            id="box", position=StaticPosition(width=40.0), background_color=RED)])),
        (1.0, comp.View(background_color=BLUE, children=[comp.View(
            id="box", position=StaticPosition(width=240.0), background_color=RED,
            transition=Transition(duration=2.0))])),
    ]),
    "transition_bounce_late": (0, [
        (0.0, comp.View(background_color=BLUE, children=[comp.View(
            id="box", position=AbsolutePosition(width=60.0, height=60.0, top=60.0,
                                                left=0.0),
            background_color=GREEN)])),
        (1.6, comp.View(background_color=BLUE, children=[comp.View(
            id="box", position=AbsolutePosition(width=60.0, height=60.0, top=60.0,
                                                left=240.0),
            background_color=GREEN,
            transition=Transition(duration=2.0, easing=Easing.BOUNCE))])),
    ]),
    "tiles_transition_midpoint": (3, [
        (0.0, comp.Tiles(id="t", background_color=DARK, children=_inputs(2),
                         transition=Transition(duration=2.0))),
        (1.0, comp.Tiles(id="t", background_color=DARK, children=_inputs(3),
                         transition=Transition(duration=2.0))),
    ]),
    "view_rotation_masked_opaque_bg": (1, [(0.0, comp.View(
        background_color=BLUE, children=[_abs_view(
            200.0, 110.0, WHITE, _inputs(1), top=35.0, left=60.0,
            rotation_degrees=25.0)]))]),
    "simple_passthrough": (1, [(0.0, comp.Rescaler(child=_inputs(1)[0]))]),
}


def _golden(name: str) -> np.ndarray:
    path = SNAPSHOT_DIR / f"{name}.png"
    assert path.exists(), f"no golden {path}"
    return np.asarray(PILImage.open(path).convert("RGB"), np.uint8)


def _mean_error(name: str, rgb: np.ndarray) -> float:
    golden = _golden(name)
    assert golden.shape == rgb.shape, f"{name}: shape {rgb.shape} != {golden.shape}"
    return float(np.abs(golden.astype(np.float32) - rgb.astype(np.float32)).mean())


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_renders_golden(name):
    n_inputs, steps = CASES[name]
    r = Renderer(device="cpu")
    for i in range(n_inputs):
        r.register_input(f"input_{i}")
    out = None
    for pts, scene in steps:
        r.update_scene("out", *from_reference((scene, RES, PixelFormat.RGBA)))
        frames = {f"input_{i}": make_test_input(i, IN_RES, pts)
                  for i in range(n_inputs)}
        out = r.render(from_reference(FrameSet(pts=pts, frames=frames))).frames["out"]
    rgb = out.data.numpy()[..., :3]
    err = _mean_error(name, rgb)
    assert err <= ALLOWED_ERROR, f"{name}: mean error {err:.3f} > {ALLOWED_ERROR}"


@pytest.mark.parametrize("fmt", [PixelFormat.PLANAR_YUV420, PixelFormat.PLANAR_YUVJ420])
def test_port_renders_golden_yuv_input(fmt):
    """The bar pattern of `test_pixel_format_roundtrip_snapshot` through a
    limited- and a full-range planar YUV420 input."""
    import jax.numpy as jnp

    from smelter_tpu.core.types import Frame
    from smelter_tpu.ops import color_convert as jcc

    h, w = IN_RES.height, IN_RES.width
    rgba = np.zeros((h, w, 4), np.float32)
    rgba[:, : w // 3] = (230, 40, 40, 255)
    rgba[:, w // 3 : 2 * w // 3] = (40, 230, 40, 255)
    rgba[:, 2 * w // 3 :] = (40, 40, 230, 255)
    rgba[: h // 6, :] = (255, 255, 255, 255)
    rgba[-h // 6 :, :] = (0, 0, 0, 255)
    rgba /= 255.0
    planes = jcc.rgba_to_planar_yuv420(
        jnp.asarray(rgba), full_range=fmt == PixelFormat.PLANAR_YUVJ420)
    frame = Frame(data=tuple(np.asarray(p) for p in planes), format=fmt,
                  resolution=IN_RES, pts=0.0)
    r = Renderer(device="cpu")
    r.register_input("input_0")
    r.update_scene("out", *from_reference((comp.View(background_color=BLUE, children=[
        comp.Rescaler(child=_inputs(1)[0])]), RES, PixelFormat.RGBA)))
    out = r.render(from_reference(FrameSet(pts=0.0, frames={"input_0": frame}))).frames["out"]
    name = f"pixel_format_{fmt.value}"
    err = _mean_error(name, out.data.numpy()[..., :3])
    assert err <= ALLOWED_ERROR, f"{name}: mean error {err:.3f} > {ALLOWED_ERROR}"
