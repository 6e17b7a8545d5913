"""The golden snapshots of `tests/test_snapshots.py`, and the transition
sequences and input formats of `tests/test_snapshots_extended.py` and
`tests/test_snapshots_round5.py`, rendered through the PyTorch port's
`Renderer` on the CPU and compared with the committed PNGs at
`harness.ALLOWED_ERROR` (mean absolute u8 error per channel).

Only the goldens are read here: nothing is written, so a missing golden
fails instead of being created. The scenes are built with the reference's
components and reach the port's renderer (on the CPU) through
`interop.from_reference`. A transition renders as its snapshot test does:
the first scene at pts 0, the second scene, two warm-up frames (so that
the planner sees the layout animate and takes the traced routes), then the
frames compared.

Scenes of those files left out, with what stops each (ROADMAP Queue 1):
  - every Text scene (`text_*`): Text components, item 7;
  - every Image scene (`image_*`): Image components, item 7;
  - every Shader scene (`shader_*`, the circle layout of
    `tests/test_snapshots_round5b.py`): Shader components, item 7;
  - the static scenes of `tests/test_snapshots_extended.py` and
    `tests/test_snapshots_round5.py` (4K outputs, rotated and bordered
    layouts, tile counts): they need nothing the port lacks, and wait only
    for a test of their own.
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
    # tests/test_snapshots_extended.py
    "rescaler_rotated_shadow_border": (1, [(0.0, comp.View(
        background_color=BLUE, children=[comp.Rescaler(
            child=_inputs(1)[0], border_radius=BorderRadius(14.0, 14.0, 14.0, 14.0),
            border_width=3.0, border_color=RGBAColor(255, 255, 255, 220),
            box_shadow=[BoxShadow(offset_x=8.0, offset_y=8.0, blur_radius=18.0,
                                  color=RGBAColor(0, 0, 0, 170))],
            position=AbsolutePosition(width=200.0, height=110.0, top=35.0, left=60.0,
                                      rotation_degrees=20.0))]))]),
    "rescaler_rotated_negative": (1, [(0.0, comp.View(
        background_color=BLUE, children=[comp.Rescaler(
            child=_inputs(1)[0], border_radius=BorderRadius(10.0, 10.0, 10.0, 10.0),
            position=AbsolutePosition(width=200.0, height=110.0, top=35.0, left=60.0,
                                      rotation_degrees=-25.0))]))]),
    "view_border_radius_asymmetric": (1, [(0.0, comp.View(
        background_color=BLUE, children=[comp.View(
            position=AbsolutePosition(width=220.0, height=120.0, top=30.0, left=50.0),
            background_color=WHITE, border_radius=BorderRadius(40.0, 0.0, 24.0, 8.0),
            overflow=Overflow.HIDDEN, children=_inputs(1))]))]),
    "view_box_shadow_large_blur": (0, [(0.0, comp.View(
        background_color=BLUE, children=[comp.View(
            position=AbsolutePosition(width=140.0, height=80.0, top=50.0, left=90.0),
            background_color=WHITE, border_radius=BorderRadius(12.0, 12.0, 12.0, 12.0),
            box_shadow=[BoxShadow(offset_x=0.0, offset_y=0.0, blur_radius=48.0,
                                  color=RGBAColor(0, 0, 0, 220))])]))]),
    "absolute_overlap_stacking": (3, [(0.0, comp.View(
        background_color=BLUE, children=[
            _abs_view(160.0, 90.0, WHITE, [comp.InputStream(input_id=f"input_{i}")],
                      top=10.0 + 25.0 * i, left=20.0 + 45.0 * i) for i in range(3)]))]),
    "tiles_07_inputs": (7, [(0.0, comp.Tiles(background_color=DARK,
                                             children=_inputs(7)))]),
    "rescaler_fill_tall_slot": (1, [(0.0, comp.View(
        background_color=BLUE, children=[comp.Rescaler(
            child=_inputs(1)[0], mode=RescaleMode.FILL,
            position=AbsolutePosition(width=90.0, height=160.0, top=10.0,
                                      left=115.0))]))]),
    # tests/test_snapshots_round5.py
    "view_rotation_75deg": (1, [(0.0, comp.View(
        background_color=BLUE, children=[_abs_view(
            160.0, 90.0, WHITE, _inputs(1), top=45.0, left=80.0,
            rotation_degrees=75.0)]))]),
    "tiles_13_inputs": (13, [(0.0, comp.Tiles(background_color=RGBAColor(24, 24, 24, 255),
                                              children=_inputs(13)))]),
    "rescaler_fill_wide_slot": (1, [(0.0, comp.View(
        background_color=BLUE, children=[comp.View(
            position=AbsolutePosition(width=300.0, height=60.0, top=60.0, left=10.0),
            children=[comp.Rescaler(child=_inputs(1)[0], mode=RescaleMode.FILL)])]))]),
    "view_border_radius_circle": (1, [(0.0, comp.View(
        background_color=BLUE, children=[comp.View(
            position=AbsolutePosition(width=120.0, height=120.0, top=30.0, left=100.0),
            border_radius=BorderRadius(200.0, 200.0, 200.0, 200.0),
            background_color=WHITE, children=_inputs(1))]))]),
}


def _card(tr=None, **pos):
    """The card of the transition snapshots: a white absolute View around
    input_0."""
    return comp.View(background_color=BLUE, children=[comp.View(
        id="card", position=AbsolutePosition(**pos), background_color=WHITE,
        transition=tr, children=[comp.InputStream(input_id="input_0")])])


def _tiles(order, tr=None):
    return comp.Tiles(id="t", background_color=DARK, transition=tr, children=[
        comp.InputStream(id=f"tile_{i}", input_id=f"input_{i}") for i in order])


def _grid(n):
    return comp.Tiles(id="grid", background_color=RGBAColor(24, 24, 24, 255),
                      children=_inputs(n), transition=Transition(duration=2.0))


def _box(tr=None, **kw):
    return comp.View(background_color=BLUE, children=[comp.View(id="box", transition=tr,
                                                                **kw)])


T2 = Transition(duration=2.0)
# name -> (number of inputs, first scene, second scene, warm-up pts, compared
# pts): `_transition_midpoint` of tests/test_snapshots.py (golden `name`),
# `_transition_sequence` of tests/test_snapshots_extended.py and `_sequence`
# of tests/test_snapshots_round5.py (goldens `name_t05`, ...)
TRANSITIONS = {
    "transition_spin_midpoint": (
        1, _card(width=180.0, height=100.0, top=40.0, left=70.0, rotation_degrees=0.0),
        _card(T2, width=180.0, height=100.0, top=40.0, left=70.0, rotation_degrees=80.0),
        (0.2, 0.4), (1.0,)),
    "transition_zoom_midpoint": (
        1, _card(width=80.0, height=45.0, top=70.0, left=120.0),
        _card(T2, width=280.0, height=158.0, top=10.0, left=20.0), (0.2, 0.4), (1.0,)),
    "seq_spin": (
        1, _card(width=180.0, height=100.0, top=40.0, left=70.0, rotation_degrees=0.0),
        _card(T2, width=180.0, height=100.0, top=40.0, left=70.0, rotation_degrees=80.0),
        (0.1, 0.2), (0.5, 1.0, 1.5)),
    "seq_zoom": (
        1, _card(width=80.0, height=45.0, top=70.0, left=120.0),
        _card(T2, width=280.0, height=158.0, top=10.0, left=20.0), (0.1, 0.2),
        (0.5, 1.0, 1.5)),
    "seq_slide": (
        1, _card(width=120.0, height=68.0, top=10.0, left=10.0),
        _card(T2, width=120.0, height=68.0, top=100.0, left=190.0), (0.1, 0.2),
        (0.5, 1.0, 1.5)),
    "seq_tiles_reorder": (3, _tiles([0, 1, 2]), _tiles([2, 0, 1], T2), (0.1, 0.2),
                          (0.5, 1.0, 1.5)),
    "seq_rotozoom": (
        1, _card(width=80.0, height=45.0, top=20.0, left=30.0, rotation_degrees=0.0),
        _card(T2, width=240.0, height=135.0, top=30.0, left=60.0, rotation_degrees=70.0),
        (0.1, 0.2), (1.0,)),
    "seq_cubic_bezier": (
        1, _card(width=100.0, height=60.0, top=60.0, left=10.0),
        _card(Transition(duration=2.0, easing=Easing.cubic_bezier(0.65, 0.0, 0.35, 1.0)),
              width=100.0, height=60.0, top=60.0, left=210.0), (0.1, 0.2), (1.0,)),
    "seq_width": (
        0, _box(position=StaticPosition(width=40.0), background_color=RED),
        _box(T2, position=StaticPosition(width=280.0), background_color=RED),
        (0.1, 0.2), (0.5, 1.0, 1.5)),
    "seq_bounce": (
        0, _box(position=AbsolutePosition(width=60.0, height=60.0, top=60.0, left=0.0),
                background_color=GREEN),
        _box(Transition(duration=2.0, easing=Easing.BOUNCE),
             position=AbsolutePosition(width=60.0, height=60.0, top=60.0, left=240.0),
             background_color=GREEN),
        (0.1, 0.2), (0.5, 1.0, 1.5)),
    "seq_tiles_add": (3, _grid(2), _grid(3), (0.1, 0.2), (0.5, 1.0, 1.5)),
}
TRANSITION_GOLDENS = [
    (name, pts, name if name.startswith("transition_")
     else f"{name}_t{str(pts).replace('.', '')}")
    for name in sorted(TRANSITIONS) for pts in TRANSITIONS[name][4]
]


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


@pytest.mark.parametrize("name,pts,golden", TRANSITION_GOLDENS,
                         ids=[g for _, _, g in TRANSITION_GOLDENS])
def test_port_renders_golden_transition(name, pts, golden):
    """The transition frames up to `pts` (the planner's history included),
    the last one compared."""
    n_inputs, scene0, scene1, warm, compared = TRANSITIONS[name]
    r = Renderer(device="cpu")
    for i in range(n_inputs):
        r.register_input(f"input_{i}")

    def render(p, frame_pts):
        frames = {f"input_{i}": make_test_input(i, IN_RES, frame_pts)
                  for i in range(n_inputs)}
        return r.render(from_reference(FrameSet(pts=p, frames=frames))).frames["out"]

    r.update_scene("out", *from_reference((scene0, RES, PixelFormat.RGBA)))
    render(0.0, 0.0)
    r.update_scene("out", *from_reference((scene1, RES, PixelFormat.RGBA)))
    for p in warm + compared[: compared.index(pts) + 1]:
        out = render(p, p)
    err = _mean_error(golden, out.data.numpy()[..., :3])
    assert err <= ALLOWED_ERROR, f"{golden}: mean error {err:.3f} > {ALLOWED_ERROR}"


def _format_frame(fmt):
    """The bar pattern of the pixel-format snapshots in `fmt`, built as the
    snapshot test of that format builds it."""
    import test_snapshots
    import test_snapshots_extended

    from smelter_tpu.core.types import Frame

    if fmt in (PixelFormat.RGBA, PixelFormat.BGRA):
        return test_snapshots._frame_from_rgba(
            test_snapshots._rgb_test_pattern(IN_RES), fmt, IN_RES)
    rgba = test_snapshots_extended._rgb_test_pattern(IN_RES)
    if fmt == PixelFormat.PLANAR_YUVJ422:  # tests/test_snapshots_round5.py
        import jax.numpy as jnp

        from smelter_tpu.ops import color_convert as jcc

        planes = jcc.rgba_to_planar_yuv422(jnp.asarray(rgba.astype(np.float32) / 255.0),
                                           full_range=True)
        return Frame(data=tuple(np.asarray(p) for p in planes), format=fmt,
                     resolution=IN_RES, pts=0.0)
    return test_snapshots_extended._frame_from_rgba(rgba, fmt, IN_RES)


# every input format but the planar YUV420 pair (test_port_renders_golden_yuv_input)
OTHER_FORMATS = [f for f in PixelFormat
                 if f not in (PixelFormat.PLANAR_YUV420, PixelFormat.PLANAR_YUVJ420)]


@pytest.mark.parametrize("fmt", OTHER_FORMATS, ids=lambda f: f.value)
def test_port_renders_golden_input_format(fmt):
    """The bar pattern through every other input format, converted to a
    full-resolution RGBA mip pyramid (planar YUV: deferred, converted where
    a route asks for mips) under a Rescaler."""
    r = Renderer(device="cpu")
    r.register_input("input_0")
    r.update_scene("out", *from_reference((comp.View(background_color=BLUE, children=[
        comp.Rescaler(child=_inputs(1)[0])]), RES, PixelFormat.RGBA)))
    frame = _format_frame(fmt)
    out = r.render(from_reference(FrameSet(pts=0.0, frames={"input_0": frame}))).frames["out"]
    name = f"pixel_format_{fmt.value}"
    err = _mean_error(name, out.data.numpy()[..., :3])
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
