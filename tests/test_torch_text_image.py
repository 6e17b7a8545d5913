"""Text and Image nodes on the port against the JAX package, on the CPU.

  - The aux textures themselves: the port's `TextRenderer` and `ImageStore`
    (copies of the reference's, PIL imported lazily) must raster and decode
    byte-equal RGBA textures: text alignment, wrapping, weight, style,
    sizing modes and a bidi run; PNG, JPEG, GIF frame selection by pts and
    SVG (natural size and vector-scaled).
  - Renderer frames of text and image scenes against the JAX renderer,
    frame by frame at <= 1 u8 LSB, RGBA and PLANAR_YUV420, an animated GIF
    through its frames.
  - The live scene keeps an image that is unregistered after
    `update_scene` (the reference's pinning); the next scene update refuses
    it.
"""

from __future__ import annotations

from io import BytesIO

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from harness import make_test_input
from smelter_tpu.core.types import FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu.render.image import ImageStore as JaxImageStore
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.render.text import TextRenderer as JaxTextRenderer
from smelter_tpu.scene import components as comp
from smelter_tpu.scene.components import HorizontalAlign, TextDimensions, TextStyle, TextWeight, TextWrap
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.render.image import ImageStore
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer
from smelter_tpu_torch.render.text import TextRenderer

torch.set_num_threads(2)

WHITE = RGBAColor(255, 255, 255, 255)
FIXED = TextDimensions(mode="fixed", width=320.0, height=180.0)

TEXTS = {
    "align_left": comp.Text(text="left aligned", font_size=24.0, dimensions=FIXED),
    "align_center": comp.Text(text="Hello TPU", font_size=32.0, color=WHITE,
                              align=HorizontalAlign.CENTER, dimensions=FIXED),
    "align_right": comp.Text(text="right aligned", font_size=24.0,
                             align=HorizontalAlign.RIGHT,
                             background_color=RGBAColor(30, 30, 30, 255), dimensions=FIXED),
    "wrap_word": comp.Text(text="the quick brown fox jumps over the lazy dog", font_size=26.0,
                           color=RGBAColor(255, 220, 80, 255), wrap=TextWrap.WORD,
                           dimensions=TextDimensions(mode="fitted_column", width=200.0)),
    "wrap_glyph": comp.Text(text="unbreakablesupercalifragilistic glyph wrap", font_size=26.0,
                            wrap=TextWrap.GLYPH,
                            dimensions=TextDimensions(mode="fitted_column", width=180.0)),
    "wrap_none": comp.Text(text="this long single line never wraps and simply clips",
                           font_size=26.0, wrap=TextWrap.NONE, dimensions=FIXED),
    "bold_background": comp.Text(text="BOLD", font_size=48.0, weight=TextWeight.BOLD,
                                 color=RGBAColor(20, 20, 20, 255),
                                 background_color=RGBAColor(240, 240, 240, 255)),
    "italic_light": comp.Text(text="Italic Light 28", font_size=28.0, style=TextStyle.ITALIC,
                              weight=TextWeight.LIGHT, dimensions=FIXED),
    "mono_serif_lines": comp.Text(text="mono\nline two", font_size=20.0, line_height=30.0,
                                  font_family="DejaVu Sans Mono"),
    "serif_fitted": comp.Text(text="fitted box", font_size=28.0, font_family="serif",
                              background_color=RGBAColor(160, 30, 30, 255),
                              dimensions=TextDimensions(mode="fitted")),
    "rtl_bidi": comp.Text(text="مرحبا TPU بك", font_size=30.0, font_family="DejaVu Sans",
                          dimensions=FIXED),
}


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_text_texture_is_byte_equal(name):
    ref = JaxTextRenderer().render(TEXTS[name])
    got = TextRenderer().render(from_reference(TEXTS[name]))
    assert (got.width, got.height) == (ref.width, ref.height)
    assert got.rgba.dtype == np.uint8 and np.array_equal(got.rgba, ref.rgba)
    assert TextRenderer().measure(from_reference(TEXTS[name])) == (ref.width, ref.height)


def _png(w, h, rgba, fmt="PNG"):
    arr = np.zeros((h, w, 4), np.uint8)
    arr[:] = rgba
    for i in range(min(w, h)):
        arr[i, i] = (255, 255, 255, 255)
    buf = BytesIO()
    img = PILImage.fromarray(arr if fmt == "PNG" else arr[..., :3])
    img.save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _gif():
    frames = []
    for i, color in enumerate([(255, 40, 40), (40, 255, 40), (40, 40, 255), (255, 255, 40)]):
        a = np.zeros((40, 40, 3), np.uint8)
        a[:] = color
        a[:10, : 10 * (i + 1)] = 255
        frames.append(PILImage.fromarray(a))
    buf = BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:],
                   duration=[100, 150, 100, 200], loop=0)
    return buf.getvalue()


SVG = (b'<svg xmlns="http://www.w3.org/2000/svg" width="100" height="100">'
       b'<circle cx="50" cy="50" r="40" fill="red"/>'
       b'<rect x="10" y="10" width="30" height="30" fill="#00ff00"/></svg>')

IMAGES = {
    "png": dict(data=_png(64, 48, (200, 40, 40, 180)), kind="png"),
    "png_auto": dict(data=_png(33, 21, (40, 200, 90, 255))),
    "jpeg": dict(data=_png(80, 60, (90, 120, 200, 255), "JPEG"), kind="jpeg"),
    "gif": dict(data=_gif(), kind="gif"),
    "svg": dict(data=SVG, kind="svg"),
    "svg_scaled": dict(data=SVG, kind="svg", resolution=(240, 120)),
}


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_image_asset_is_byte_equal(name):
    ref = JaxImageStore().register("i", **IMAGES[name])
    got = ImageStore().register("i", **IMAGES[name])
    assert (got.kind, got.width, got.height, got.durations) == (
        ref.kind, ref.width, ref.height, ref.durations)
    assert len(got.frames) == len(ref.frames)
    for a, b in zip(ref.frames, got.frames):
        assert np.array_equal(a, b)
    for pts in (0.0, 0.05, 0.1, 0.2, 0.3, 0.45, 0.55, 1.0, 7.3):
        assert np.array_equal(got.frame_at(pts), ref.frame_at(pts)), pts


def test_image_store_refuses_as_the_reference_does():
    from smelter_tpu.render.image import ImageError as JaxImageError
    from smelter_tpu_torch.render.image import ImageError

    for store, err in ((JaxImageStore(), JaxImageError), (ImageStore(), ImageError)):
        store.register("a", data=_png(8, 8, (1, 2, 3, 4)))
        with pytest.raises(err, match="already registered"):
            store.register("a", data=_png(8, 8, (1, 2, 3, 4)))
        with pytest.raises(err, match="one of path/url/data"):
            store.register("b")
        store.unregister("a")
        with pytest.raises(err, match="not registered"):
            store.get("a")


# ------------------------------------------------------------ renderer frames

OUT = Resolution(320, 180)


def _scenes():
    return {
        "text_over_input": (1, comp.View(background_color=RGBAColor(0, 0, 128, 255), children=[
            comp.Rescaler(child=comp.InputStream(input_id="input_0")),
            comp.View(position=comp.AbsolutePosition(width=320.0, height=40.0, bottom=0.0,
                                                     left=0.0),
                      background_color=RGBAColor(0, 0, 0, 150),
                      children=[comp.Text(text="lower third", font_size=24.0, color=WHITE)])])),
        "text_root": (0, comp.Text(text="Hello", font_size=40.0, color=WHITE,
                                   background_color=RGBAColor(10, 60, 10, 255),
                                   dimensions=FIXED)),
        "images": (0, comp.View(background_color=RGBAColor(32, 32, 48, 255), children=[
            comp.Rescaler(child=comp.Image(image_id="png")),
            comp.View(position=comp.AbsolutePosition(width=40.0, height=40.0, top=70.0,
                                                     left=140.0),
                      children=[comp.Image(image_id="gif")]),
            comp.View(position=comp.AbsolutePosition(width=100.0, height=100.0, top=10.0,
                                                     left=210.0),
                      children=[comp.Image(image_id="svg")]),
            comp.Rescaler(position=comp.AbsolutePosition(width=90.0, height=60.0, top=110.0,
                                                         left=10.0),
                          child=comp.Image(image_id="jpeg"), mode=comp.RescaleMode.FILL)])),
        "image_root": (0, comp.Image(image_id="png")),
    }


def _render(cls, scene_name, fmt, pts_seq):
    port = cls is TorchRenderer
    r = cls(device="cpu") if port else cls()
    conv = from_reference if port else (lambda x: x)
    n, scene = _scenes()[scene_name]
    for i in range(n):
        r.register_input(f"input_{i}")
    for name in ("png", "jpeg", "gif", "svg"):
        r.register_image(name, **IMAGES[name])
    res = OUT if scene_name != "image_root" else Resolution(64, 48)
    r.update_scene("out", *conv((scene, res, fmt)))
    outs = []
    for pts in pts_seq:
        frames = {f"input_{i}": make_test_input(i, Resolution(160, 90), pts) for i in range(n)}
        data = r.render(conv(FrameSet(pts=pts, frames=frames))).frames["out"].data
        data = data if isinstance(data, tuple) else (data,)
        outs.append([p.numpy() if torch.is_tensor(p) else np.asarray(p) for p in data])
    r.close()
    return outs


@pytest.mark.parametrize("fmt", [PixelFormat.RGBA, PixelFormat.PLANAR_YUV420],
                         ids=lambda f: f.value)
@pytest.mark.parametrize("scene", sorted(_scenes()))
def test_renderer_frames_match_the_reference(scene, fmt):
    pts_seq = (0.0, 0.12, 0.3, 0.45)
    ref = _render(JaxRenderer, scene, fmt, pts_seq)
    got = _render(TorchRenderer, scene, fmt, pts_seq)
    for k, (a_planes, b_planes) in enumerate(zip(ref, got)):
        for a, b in zip(a_planes, b_planes):
            assert a.shape == b.shape and b.dtype == np.uint8
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert int(d.max()) <= 1, f"{scene} {fmt.value} frame {k}: {int(d.max())} LSB"


def test_gif_frames_change_numbers_not_the_structure():
    """The next GIF frame uploads a new aux texture but builds no new
    program: the structure key holds the texture's resolution only."""
    r = TorchRenderer(device="cpu")
    r.register_image("gif", **IMAGES["gif"])
    r.update_scene("out", *from_reference((comp.View(
        background_color=RGBAColor(0, 0, 0, 255), children=[comp.Image(image_id="gif")]),
        Resolution(64, 48), PixelFormat.RGBA)))
    prog = r._programs["out"]
    seen = []
    for pts in (0.0, 0.05, 0.12, 0.3, 0.45):
        r.render(from_reference(FrameSet(pts=pts)))
        seen.append(prog._aux_dev[next(iter(prog._aux_dev))][1])
    assert len(prog._build_cache) == 1
    assert seen[0] is seen[1] and seen[1] is not seen[2]  # re-upload on change only


def test_unregistered_image_stays_pinned_in_the_live_scene():
    scene = comp.View(background_color=RGBAColor(0, 0, 0, 255),
                      children=[comp.Rescaler(child=comp.Image(image_id="png"))])
    outs = []
    for cls in (JaxRenderer, TorchRenderer):
        port = cls is TorchRenderer
        r = cls(device="cpu") if port else cls()
        conv = from_reference if port else (lambda x: x)
        r.register_image("png", **IMAGES["png"])
        r.update_scene("out", *conv((scene, OUT, PixelFormat.RGBA)))
        r.unregister_image("png")  # before the first frame
        data = r.render(conv(FrameSet(pts=0.0))).frames["out"].data
        outs.append(data.numpy() if torch.is_tensor(data) else np.asarray(data))
        with pytest.raises(ValueError, match="not registered"):
            r.update_scene("out", *conv((scene, OUT, PixelFormat.RGBA)))
        r.close()
    assert int(np.abs(outs[0].astype(int) - outs[1].astype(int)).max()) <= 1
    assert outs[1][..., :3].max() > 100  # the image still shows
