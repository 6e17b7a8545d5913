"""The port's output formats against the JAX package, on the CPU.

  - The four converters of `ops/color_convert.py` that the YUV444 and NV12
    outputs use (`rgba_to_planar_yuv444`, `planar_rgba_to_yuv444`,
    `planar_rgba_to_nv12`, `rgba_to_nv12`) on numpy-seeded canvases.
  - Renderer frames to NV12 and PLANAR_YUV444 (and RGBA, YUV420) against the
    JAX renderer, frame by frame, for a layout root (channel-major canvas)
    and a shader root (interleaved), through a transition.
  - The pipeline's yuv444p and yuv422p encoder profiles
    (`tests/test_pipeline.py::test_encoder_pixel_format_yuv444_and_422`)
    through both packages, and a raw yuv444p output frame by frame.
  - `make_flagship_compose` on a Tiles shape that the reference's
    `_analyze_opaque_grid` refuses: both fall back to the general compose.

Tolerance: <= 1 u8 LSB per pixel on every plane.
"""

from __future__ import annotations

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import make_test_input
from smelter_tpu.core.types import FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.scene import components as comp
from smelter_tpu_torch import interop
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.ops import color_convert as tcc
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer
from test_torch_pipeline import PORT, REF, _new_pipeline, _pkg

torch.set_num_threads(2)


def _assert_within_1(ref, got, label):
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(ref) == len(got), label
    for i, (a, b) in enumerate(zip(ref, got)):
        a = np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape and b.dtype == np.uint8, (label, i, a.shape, b.shape)
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert int(d.max()) <= 1, f"{label} plane {i}: {int(d.max())} LSB"


# ---------------------------------------------------------------- converters


def _canvas(h=90, w=160, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w, 4), dtype=np.float32) * 1.2 - 0.1).astype(np.float32)


CONVERTERS = {
    "rgba_to_planar_yuv444": (lambda x: jcc.rgba_to_planar_yuv444(jnp.asarray(x)),
                              lambda x: tcc.rgba_to_planar_yuv444(torch.from_numpy(x))),
    "rgba_to_planar_yuv444_full_range": (
        lambda x: jcc.rgba_to_planar_yuv444(jnp.asarray(x), full_range=True),
        lambda x: tcc.rgba_to_planar_yuv444(torch.from_numpy(x), full_range=True)),
    "planar_rgba_to_yuv444": (
        lambda x: jcc.planar_rgba_to_yuv444(jnp.asarray(x.transpose(2, 0, 1))),
        lambda x: tcc.planar_rgba_to_yuv444(torch.from_numpy(x.transpose(2, 0, 1).copy()))),
    "planar_rgba_to_nv12": (
        lambda x: jcc.planar_rgba_to_nv12(jnp.asarray(x.transpose(2, 0, 1))),
        lambda x: tcc.planar_rgba_to_nv12(torch.from_numpy(x.transpose(2, 0, 1).copy()))),
    "rgba_to_nv12": (lambda x: jcc.rgba_to_nv12(jnp.asarray(x)),
                     lambda x: tcc.rgba_to_nv12(torch.from_numpy(x))),
}


@pytest.mark.parametrize("name", sorted(CONVERTERS))
@pytest.mark.parametrize("shape", [(90, 160), (37, 51)], ids=["even", "odd"])
def test_converter_matches_reference(name, shape):
    ref_fn, port_fn = CONVERTERS[name]
    x = _canvas(*shape)
    ref, got = tuple(ref_fn(x)), tuple(port_fn(x))
    _assert_within_1(ref, got, name)
    if "nv12" in name:
        h, w = shape
        assert tuple(got[1].shape) == (h // 2, w // 2, 2)


def test_nv12_is_yuv420_interleaved():
    x = torch.from_numpy(_canvas().transpose(2, 0, 1).copy())
    y, u, v = tcc.planar_rgba_to_yuv420(x)
    ny, uv = tcc.planar_rgba_to_nv12(x)
    assert torch.equal(ny, y) and torch.equal(uv, torch.stack([u, v], dim=-1))


# ------------------------------------------------------------------ renderer

OUT = Resolution(320, 180)
IN = Resolution(96, 54)
FORMATS = [PixelFormat.RGBA, PixelFormat.PLANAR_YUV420, PixelFormat.PLANAR_YUV444,
           PixelFormat.NV12]
INVERT = ("def main(inputs, params, resolution, time):\n"
          "    tex = inputs[0]\n"
          "    return jnp.concatenate([1.0 - tex[..., :3], tex[..., 3:4]], axis=-1)\n")


def _layout_scene(left, **position):
    return comp.View(background_color=RGBAColor(20, 20, 20), **position, children=[
        comp.Tiles(children=[comp.InputStream(input_id=f"input_{i}") for i in range(2)],
                   background_color=RGBAColor(16, 16, 16), margin=4.0),
        comp.View(id="box", position=comp.AbsolutePosition(
            width=120.0, height=40.0, top=120.0, left=left),
            background_color=RGBAColor(200, 30, 30, 230),
            transition=comp.Transition(duration=1.0))])


def _shader_scene(left):
    return comp.Shader(shader_id="invert", width=320.0, height=180.0, children=[
        _layout_scene(left, position=comp.StaticPosition(width=320.0, height=180.0))])


def _render_seq(cls, scene_fn, fmt):
    port = cls is TorchRenderer
    r = cls(device="cpu") if port else cls()
    conv = from_reference if port else (lambda x: x)
    for i in range(2):
        r.register_input(f"input_{i}")
    r.register_shader("invert", INVERT)
    outs = []
    for scene, pts in ((scene_fn(20.0), 0.0), (scene_fn(180.0), 0.25), (None, 0.5),
                       (None, 1.0), (None, 1.1)):
        if scene is not None:
            r.update_scene("out", *conv((scene, OUT, fmt)))
        frames = {f"input_{i}": make_test_input(i, IN, pts) for i in range(2)}
        data = r.render(conv(FrameSet(pts=pts, frames=frames))).frames["out"].data
        outs.append(tuple(data) if isinstance(data, tuple) else data)
    r.close()
    return outs


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.value)
@pytest.mark.parametrize("root", ["layout", "shader"])
def test_renderer_output_format_matches_reference(fmt, root):
    scene_fn = _layout_scene if root == "layout" else _shader_scene
    ref = _render_seq(JaxRenderer, scene_fn, fmt)
    got = _render_seq(TorchRenderer, scene_fn, fmt)
    for k, (a, b) in enumerate(zip(ref, got)):
        _assert_within_1(a, b, f"{root} {fmt.value} frame {k}")
    if fmt == PixelFormat.NV12:
        assert tuple(got[0][1].shape) == (90, 160, 2)


# ------------------------------------------------------------------ pipeline


def _sps_profile(extradata):
    i = extradata.find(b"\x00\x00\x01")
    while i >= 0:
        j = i + 3
        if j < len(extradata) and (extradata[j] & 0x1F) == 7:
            return extradata[j + 1]
        i = extradata.find(b"\x00\x00\x01", i + 3)
    return None


def _pixel_format_run(name: str, pix_fmt: str, codec: str):
    """tests/test_pipeline.py's 4:4:4 / 4:2:2 flow through package `name`:
    10 grey frames of a rising level into a 128x96 output. Returns the
    sink's packets (or raw frames) and its extradata."""
    pkg = _pkg(name)
    pl, t = pkg.pipeline, pkg.types
    pipeline = _new_pipeline(pkg, name)
    src = pkg.input.RawDataInput(has_video=True, has_audio=False)
    pipeline.register_input("cam", src, pl.RegisterInputOptions(required=True, offset=0.0))
    sink = pl.RawDataOutputSink() if codec == "raw" else pl.EncodedDataOutputSink()
    pipeline.register_output(
        "out", sink,
        video=pl.OutputVideoOptions(
            resolution=t.Resolution(128, 96),
            encoder=pl.VideoEncoderOptions(codec=codec, preset="ultrafast",
                                           pixel_format=pix_fmt),
            initial_root=pkg.comp.Rescaler(child=pkg.comp.InputStream(input_id="cam")),
            end_condition=pl.EndCondition(all_inputs=True)))
    pipeline.start()
    rng = np.random.RandomState(3)
    for i in range(10):
        y = np.full((96, 128), 60 + i * 10, np.uint8)
        u = rng.randint(16, 240, (48, 64), dtype=np.uint8)
        v = rng.randint(16, 240, (48, 64), dtype=np.uint8)
        src.video.send(t.Frame(data=(y, u, v), format=t.PixelFormat.PLANAR_YUV420,
                               resolution=t.Resolution(128, 96), pts=max(i / 30.0 - 1e-6, 0.0)))
    src.video.close()
    out = []
    deadline = time.time() + 120
    while time.time() < deadline:
        try:
            out.append(sink.video.recv(timeout=5.0))
        except (pkg.channels.Closed, TimeoutError):
            break
    pipeline.close()
    return out, getattr(sink, "video_extradata", None)


@pytest.mark.parametrize("pix_fmt,profile", [("yuv444p", 244), ("yuv422p", 122)])
def test_pipeline_encoder_profile_matches_reference(pix_fmt, profile):
    ref, ref_extra = _pixel_format_run(REF, pix_fmt, "h264")
    got, got_extra = _pixel_format_run(PORT, pix_fmt, "h264")
    assert _sps_profile(ref_extra) == profile
    assert _sps_profile(got_extra) == profile
    # whether the last frame is encoded depends on when the input's end
    # reaches the queue, in either package (tests/test_pipeline.py asks 8+)
    assert len(got) >= 8 and abs(len(got) - len(ref)) <= 1


def test_pipeline_raw_yuv444_frames_match_reference():
    ref, _ = _pixel_format_run(REF, "yuv444p", "raw")
    got, _ = _pixel_format_run(PORT, "yuv444p", "raw")
    assert len(got) >= 8 and abs(len(got) - len(ref)) <= 1
    for k, (a, b) in enumerate(zip(ref, got)):
        assert abs((b.pts - got[0].pts) - (a.pts - ref[0].pts)) < 1e-6
        assert b.format.name == "PLANAR_YUV444"
        assert all(isinstance(p, np.ndarray) and p.shape == (96, 128) for p in b.data)
        _assert_within_1(tuple(a.data), tuple(b.data), f"raw yuv444p frame {k}")


# ------------------------------------------------------------------ flagship

# a Tiles shape the reference's `_analyze_opaque_grid` refuses (its tiles'
# even-rounded rects leave the canvas), found by search on the CPU
REFUSED = (2, Resolution(64, 36), Resolution(198, 108))


def test_flagship_falls_back_to_the_general_compose():
    import jax

    from smelter_tpu.parallel import flagship as jflag
    from smelter_tpu_torch.parallel import flagship as tflag

    n, in_res, out_res = REFUSED
    assert jflag._analyze_opaque_grid(jflag._tiles_layouts(n, in_res, out_res), out_res) is None
    t_in, t_out = from_reference((in_res, out_res))
    assert tflag._analyze_opaque_grid(tflag._tiles_layouts(n, t_in, t_out), t_out) is None
    rng = np.random.RandomState(0)
    planes = (rng.randint(16, 235, (n, 36, 64), np.uint8),
              rng.randint(16, 240, (n, 18, 32), np.uint8),
              rng.randint(16, 240, (n, 18, 32), np.uint8))
    fn, _ = jflag.make_flagship_compose(n, in_res, out_res)
    ref = tuple(np.asarray(p) for p in jax.jit(fn)(*planes))
    tfn, example = tflag.make_flagship_compose(n, t_in, t_out, device="cpu")
    assert "_make_general_compose" in tfn.__qualname__
    got = interop.planes_to_host(tfn(*interop.planes_to_device(planes, "cpu")))
    _assert_within_1(ref, got, "flagship fallback")


def test_flagship_fallback_runs_k3_and_k2(monkeypatch):
    """The general compose splits the layouts as the reference does (not
    planner-stable): the background is a colour layer without a static rect,
    so K3 paints it, and K2 converts the canvas."""
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
    from smelter_tpu_torch.parallel import flagship as tflag

    calls = []
    for mod, name in ((scene_assembly, "assemble_scene_planar"),
                      (sdf_layers, "compose_sdf_layers_planar"),
                      (yuv_out, "rgba_cm_to_yuv420")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    n, in_res, out_res = from_reference(REFUSED)
    tflag.make_flagship_compose(n, in_res, out_res, device="cpu")
    assert sorted(calls) == ["compose_sdf_layers_planar", "rgba_cm_to_yuv420"]

