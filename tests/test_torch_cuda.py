"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. These need a CUDA device and nvcc, so they skip elsewhere; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(This file imports no JAX: the machine with the card need not have it.)

Tolerances: K2 <= 1 u8 LSB per plane; K1, K3, K4 and K5 max abs err 0 on the f32
canvas: the kernels are built without FMA contraction, repeat their plain
versions' operations, and skip only what is exactly the identity (their
tile classes, `ops/hopper/tile_class.py`).
"""

from __future__ import annotations

import time

import pytest
import torch

from smelter_tpu_torch import interop
from smelter_tpu_torch.ops import compose
from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(4, 200, 520), (4, 201, 519), (4, 1, 1), (4, 1080, 1920)])
@pytest.mark.parametrize("full_range", [False, True])
def test_yuv_out_kernel_matches_plain(cuda, shape, full_range):
    gen = torch.Generator(device=cuda).manual_seed(1)
    canvas = torch.rand(shape, generator=gen, device=cuda) * 1.3 - 0.1
    before = yuv_out.LAUNCHES
    got = yuv_out.rgba_cm_to_yuv420(canvas, full_range)
    torch.cuda.synchronize()
    assert yuv_out.LAUNCHES == before + 1
    ref = yuv_out.rgba_cm_to_yuv420_plain(canvas, full_range)
    for a, b in zip(ref, got):
        assert a.shape == b.shape and b.dtype == torch.uint8
        if a.numel():  # a 1x1 canvas has empty chroma planes
            assert int((a.to(torch.int32) - b.to(torch.int32)).abs().max()) <= 1


def test_yuv_out_kernel_on_a_band_of_rows(cuda):
    """A multi-device step converts a copy of its band of rows
    (`StreamsStep.finish`): K2 on it equals the same rows of K2 on the
    whole canvas, bit for bit (even bands)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    canvas = torch.rand((4, 2160, 3840), generator=gen, device=cuda) * 1.3 - 0.1
    whole = yuv_out.rgba_cm_to_yuv420(canvas)
    for r0, r1 in ((0, 540), (540, 1080), (1620, 2160), (2, 4)):
        band = yuv_out.rgba_cm_to_yuv420(canvas[:, r0:r1].contiguous())
        for a, b in zip(band, (whole[0][r0:r1], whole[1][r0 // 2:r1 // 2],
                               whole[2][r0 // 2:r1 // 2])):
            assert torch.equal(a, b), (r0, r1)


def test_yuv_out_kernel_refuses_a_strided_canvas(cuda):
    canvas = torch.zeros((4, 64, 64), device=cuda)[:, :, ::2]
    with pytest.raises(ValueError):
        yuv_out.rgba_cm_to_yuv420(canvas)


def _member(dev, kind, rect, **kw):
    fields = dict(top=rect[0], left=rect[1], height=rect[2], width=rect[3],
                  rotation_degrees=0, border_radius=(0, 0, 0, 0), border_width=0,
                  border_color=(0, 0, 0, 0), color=(0, 0, 0, 0), crop=(0, 0, 0, 0),
                  blur_radius=0, masks=[[0.0] * 9])
    fields.update(kw)
    static = dict(content=kind, static_rect=rect)
    return static, interop.layout_params(fields, dev)


def test_scene_assembly_kernel_matches_plain(cuda):
    h, w = 200, 520  # partial tiles on both axes
    members = [
        _member(cuda, "color", (0, 0, h, w), color=(0.1, 0.1, 0.15, 1.0)),
        _member(cuda, "box_shadow", (30, 40, 100, 150), blur_radius=18.0,
                border_radius=(12, 12, 12, 12), color=(0, 0, 0, 0.6)),
        _member(cuda, "color", (25, 35, 110, 160), rotation_degrees=20.0,
                border_radius=(8, 8, 8, 8), border_width=5.0,
                border_color=(1, 1, 1, 0.9), color=(0.8, 0.2, 0.2, 0.9)),
        _member(cuda, "color", (20, 300, 100, 200), border_radius=(10, 10, 10, 10),
                color=(0.9, 0.4, 0.1, 0.95),
                masks=[[8, 8, 8, 8, 25, 305, 180, 80, 0.0],
                       [12, 12, 12, 12, 30, 320, 150, 70, 0.4]]),
    ]
    statics = [
        compose.LayoutStatic(**members[0][0], no_radius=True),
        compose.LayoutStatic(**members[1][0], static_blur=18.0),
        compose.LayoutStatic(**members[2][0], has_border=True, has_rotation=True,
                             static_rotation=20.0),
        compose.LayoutStatic(**members[3][0], n_masks=2, rotated_masks=(False, True)),
    ]
    items = list(zip(statics, [p for _, p in members]))
    specs, plist, group = compose._assembly_members(items, 0, len(items),
                                                    compose.canvas_clipper(h, w))
    assert len(specs) == 4 and not group
    params = scene_assembly.pack_member_params(plist, 2)
    before = scene_assembly.LAUNCHES
    got = scene_assembly.assemble_scene_planar((w, h), specs, params)
    torch.cuda.synchronize()
    assert scene_assembly.LAUNCHES == before + 1
    ref = scene_assembly.assemble_scene_planar_plain((w, h), specs, params)
    assert float((got - ref).abs().max()) == 0.0


def _layer_rows(dev, n, h, w, seed):
    """(n, 19) K3 rows and kinds: colour, bordered and shadow layers, every
    third one rotated, scattered over (and past the edges of) an h x w canvas."""
    gen = torch.Generator().manual_seed(seed)
    rows, kinds = [], []
    for i in range(n):
        u = torch.rand(19, generator=gen)
        content = ("color", "color", "box_shadow")[i % 3]
        has_border = content == "color" and i % 2 == 1
        kinds.append((content, has_border, i % 3 == 1))
        lw, lh = 30 + u[2] * w * 0.6, 20 + u[3] * h * 0.6
        rows.append([
            u[0] * h - 10, u[1] * w - 10, lw, lh, u[4] * 360 - 180,
            *(u[5:9] * min(lw, lh) * 0.4), *u[9:12], 0.3 + 0.7 * u[12],
            1 + u[13] * 8, *u[14:18], u[18] * 30,
        ])
    return torch.tensor(rows, dtype=torch.float32, device=dev), tuple(kinds)


@pytest.mark.parametrize("n,h,w", [(1, 1, 1), (4, 257, 511), (16, 200, 520)])
def test_sdf_layers_kernel_matches_plain(cuda, n, h, w):
    params, kinds = _layer_rows(cuda, n, h, w, seed=n)
    gen = torch.Generator(device=cuda).manual_seed(2)
    canvas = torch.rand((4, h, w), generator=gen, device=cuda)
    ref = sdf_layers.compose_sdf_layers_planar_plain(canvas, params, kinds)
    before = sdf_layers.LAUNCHES
    got = sdf_layers.compose_sdf_layers_planar(canvas, params, kinds)
    torch.cuda.synchronize()
    assert sdf_layers.LAUNCHES == before + 1
    assert got.data_ptr() == canvas.data_ptr()  # in place
    assert float((got - ref).abs().max()) == 0.0


def test_sdf_layers_kernel_leaves_tiles_no_layer_reaches(cuda):
    params, kinds = _layer_rows(cuda, 6, 256, 512, seed=7)
    params[:, 1] += 2000.0  # every layer right of the canvas
    gen = torch.Generator(device=cuda).manual_seed(3)
    canvas = torch.rand((4, 256, 512), generator=gen, device=cuda)
    canvas[0, 0, 0] = -0.0  # a plain OVER with a zero layer would make it +0
    before = canvas.clone()
    got = sdf_layers.compose_sdf_layers_planar(canvas, params, kinds)
    torch.cuda.synchronize()
    assert torch.equal(got, before) and got[0, 0, 0].signbit()


def test_sdf_layers_kernel_refuses_bad_tables(cuda):
    params, kinds = _layer_rows(cuda, 2, 64, 64, seed=0)
    canvas = torch.zeros((4, 64, 64), device=cuda)
    with pytest.raises(ValueError):
        sdf_layers.compose_sdf_layers_planar(canvas, params[:, :18].contiguous(), kinds)
    with pytest.raises(ValueError):
        sdf_layers.compose_sdf_layers_planar(canvas[:, :, ::2], params, kinds)
    with pytest.raises(ValueError):
        sdf_layers.compose_sdf_layers_planar(canvas, params.cpu(), kinds)


def _pipeline_run(device):
    """An offline Pipeline on `device`: 2 raw 192x108 inputs of 20 frames
    under a rounded, bordered, shadowed box, raw 384x216 YUV420 out. Returns
    the delivered frames' host planes."""
    import numpy as np

    from smelter_tpu_torch.core.types import Frame, Framerate, PixelFormat, RGBAColor, Resolution
    from smelter_tpu_torch.pipeline import (
        EndCondition, OutputVideoOptions, Pipeline, PipelineOptions, RawDataOutputSink,
        RegisterInputOptions, VideoEncoderOptions)
    from smelter_tpu_torch.pipeline.input import RawDataInput
    from smelter_tpu_torch.scene import components as comp
    from smelter_tpu_torch.scene.layout_types import BorderRadius, BoxShadow
    from smelter_tpu_torch.utils.channels import Closed

    p = Pipeline(PipelineOptions(output_framerate=Framerate(30), ahead_of_time_processing=True,
                                 never_drop_output_frames=True), device=device)
    sources = [RawDataInput(has_video=True, has_audio=False) for _ in range(2)]
    for i, src in enumerate(sources):
        p.register_input(f"in_{i}", src, RegisterInputOptions(required=True, offset=0.0))
    box = comp.View(position=comp.AbsolutePosition(width=120.0, height=60.0, top=30.0, left=40.0),
                    background_color=RGBAColor(230, 40, 40, 220),
                    border_radius=BorderRadius(10.0, 10.0, 10.0, 10.0), border_width=3.0,
                    border_color=RGBAColor(255, 255, 255, 255),
                    box_shadow=[BoxShadow(blur_radius=8.0, color=RGBAColor(0, 0, 0, 160))])
    root = comp.View(background_color=RGBAColor(0, 0, 0), children=[
        comp.Tiles(children=[comp.InputStream(input_id=f"in_{i}") for i in range(2)]), box])
    sink = RawDataOutputSink()
    p.register_output("out", sink, video=OutputVideoOptions(
        resolution=Resolution(384, 216), encoder=VideoEncoderOptions(codec="raw"),
        initial_root=root, end_condition=EndCondition(all_inputs=True)))
    p.start()
    rng = np.random.RandomState(0)
    for k in range(20):
        for src in sources:
            planes = (rng.randint(16, 235, (108, 192), dtype=np.uint8),
                      rng.randint(16, 240, (54, 96), dtype=np.uint8),
                      rng.randint(16, 240, (54, 96), dtype=np.uint8))
            # a microsecond early: the queue's mapping of output pts to
            # input time may round below k / 30
            src.video.send(Frame(data=planes, format=PixelFormat.PLANAR_YUV420,
                                 resolution=Resolution(192, 108), pts=max(k / 30 - 1e-6, 0.0)))
    for src in sources:
        src.video.close()
    frames = []
    while True:
        try:
            frames.append(sink.video.recv(timeout=60))
        except (Closed, TimeoutError):
            break
    p.close()
    return [f.data for f in frames]


def test_pipeline_on_the_card_matches_the_cpu(cuda):
    """The port's Pipeline on the card against itself on the CPU: the frames
    reach the sink as host u8 planes, within 1 LSB."""
    import numpy as np

    before = (scene_assembly.LAUNCHES, yuv_out.LAUNCHES)
    got = _pipeline_run(cuda)
    assert scene_assembly.LAUNCHES > before[0] and yuv_out.LAUNCHES >= before[1] + len(got)
    ref = _pipeline_run("cpu")
    assert len(got) == len(ref) >= 18
    for a, b in zip(ref, got):
        for pa, pb in zip(a, b):
            assert isinstance(pb, np.ndarray) and pb.dtype == np.uint8 and pb.shape == pa.shape
            assert int(np.abs(pa.astype(np.int32) - pb.astype(np.int32)).max()) <= 1


# the shaders of the repo's tests and docs, in the wire contract's JAX
# syntax: (source, number of input textures, params)
SHADERS = {
    "invert": ("def main(inputs, params, resolution, time):\n"
               "    tex = inputs[0]\n"
               "    return jnp.concatenate([1.0 - tex[..., :3], tex[..., 3:4]], axis=-1)\n",
               1, None),
    "gain": ("def main(inputs, params, resolution, time):\n"
             "    g = params['gain'] if params else 1.0\n"
             "    tex = inputs[0]\n"
             "    rgb = jnp.clip(tex[..., :3] * g, 0.0, 1.0)\n"
             "    return jnp.concatenate([rgb, tex[..., 3:4]], axis=-1)\n", 1, {"gain": 1.7}),
    "swap": ("def main(inputs, params, resolution, time):\n"
             "    tex = inputs[0]\n"
             "    rgb = tex[..., :3][..., ::-1]\n"
             "    return jnp.concatenate([rgb, tex[..., 3:4]], axis=-1)\n", 1, None),
    "contract": ("def main(inputs, params, resolution, time):\n"
                 "    h, w = resolution[1], resolution[0]\n"
                 "    n = len(inputs)\n"
                 "    col = jnp.array([n / 8.0, time / 4.0, w / 1024.0, 1.0], jnp.float32)\n"
                 "    return jnp.broadcast_to(col, (h, w, 4))\n", 2, None),
    "wave": ("def main(inputs, params, resolution, time):\n"
             "    w, h = resolution[0], resolution[1]\n"
             "    x = jnp.linspace(0.0, 6.28, w)\n"
             "    y = jnp.linspace(0.0, 6.28, h)\n"
             "    g = 0.5 + 0.5 * jnp.sin(jnp.outer(y, x) * 0.5 + time * 4.0)\n"
             "    rgba = jnp.stack([g, 0.2 + 0.0 * g, 1.0 - g, jnp.ones_like(g)], axis=-1)\n"
             "    return rgba.astype(jnp.float32)\n", 0, None),
    "circle": ("def main(inputs, params, resolution, time):\n"
               "    w, h = resolution[0], resolution[1]\n"
               "    canvas = jnp.zeros((h, w, 4), jnp.float32)\n"
               "    for i, ang in enumerate(params['angles_deg']):\n"
               "        tile = inputs[i][::2, ::2]\n"
               "        a = ang * math.pi / 180.0\n"
               "        x = jnp.round(40.0 + 30.0 * jnp.cos(a) - tile.shape[1] / 2)\n"
               "        y = jnp.round(24.0 + 30.0 * jnp.sin(a) - tile.shape[0] / 2)\n"
               "        canvas = lax.dynamic_update_slice(canvas, tile,\n"
               "            (y.astype(jnp.int32), x.astype(jnp.int32), jnp.zeros((), jnp.int32)))\n"
               "    return canvas\n", 4, {"angles_deg": [0.0, 90.0, 180.0, 270.0]}),
    "where_max": ("def main(inputs, params, resolution, time):\n"
                  "    tex = jnp.maximum(inputs[0], 0.25)\n"
                  "    tex = jnp.where(tex > 0.5, tex, 0.0)\n"
                  "    tex = tex.at[0, 0].set(jnp.float32(0.5)).at[1].add(jnp.cos(0.5))\n"
                  "    return tex.at[..., 3].set(jnp.clip(jnp.sin(time) + tex[..., 0], 0.0, 1.0))\n",
                  1, None),
    "time_slide": ("def main(inputs, params, resolution, time):\n"
                   "    canvas = jnp.zeros((resolution[1], resolution[0], 4), jnp.float32)\n"
                   "    x = (time * 10.0).astype(jnp.int32)\n"
                   "    return lax.dynamic_update_slice(canvas, inputs[0][:16, :16], (4, x, 0))\n",
                   1, None),
}


@pytest.mark.parametrize("name", sorted(SHADERS))
def test_shader_on_the_card_matches_the_cpu(cuda, name):
    """A shader through the port's torch `jnp` on the card and on the CPU,
    on the same textures: equal to 1e-5, with no synchronising call on the
    card (a value derived from `time` stays on the device; index maths on
    params stays on the host)."""
    from smelter_tpu_torch.render.program import ShaderRegistry

    source, n, params = SHADERS[name]
    gen = torch.Generator().manual_seed(5)
    textures = [torch.rand((48, 80, 4), generator=gen) for _ in range(n)]
    outs = []
    for dev in ("cpu", cuda):
        reg = ShaderRegistry(dev)
        reg.register(name, source)
        fn = reg.get(name)
        ins = [t.to(dev) for t in textures]
        time = torch.full((), 2.5, device=dev)
        if dev == cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(ins, params, (80, 48), time)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        outs.append(out.cpu())
    assert outs[1].shape == (48, 80, 4) and outs[1].dtype == torch.float32
    assert float((outs[0] - outs[1]).abs().max()) <= 1e-5


# ---------------------------------------------------------------- captured programs


def _capture_scene(kind, left):
    """Port scenes at 384x216 over four 96x54 inputs: a Tiles grid under a
    bordered, shadowed banner at `left` ("overlay": K1, the texture groups
    and, while the banner moves, K3), or a shader of input 0 beside the
    grid ("shader")."""
    from smelter_tpu_torch.core.types import RGBAColor
    from smelter_tpu_torch.scene import components as comp
    from smelter_tpu_torch.scene.layout_types import BorderRadius, BoxShadow

    tiles = comp.Tiles(children=[comp.Rescaler(child=comp.InputStream(input_id=f"input_{i}"))
                                 for i in range(4)],
                       background_color=RGBAColor(16, 16, 16), margin=4.0)
    if kind == "shader":
        over = comp.View(position=comp.AbsolutePosition(width=160.0, height=90.0, top=20.0,
                                                        left=left),
                         children=[comp.Shader(shader_id="wave", width=160.0, height=90.0,
                                               children=[comp.InputStream(input_id="input_0")])])
    else:
        over = comp.View(id="banner", position=comp.AbsolutePosition(
                             width=240.0, height=40.0, top=150.0, left=left),
                         background_color=RGBAColor(200, 30, 30, 230),
                         border_radius=BorderRadius(12, 12, 12, 12), border_width=3.0,
                         border_color=RGBAColor(255, 255, 255, 255),
                         box_shadow=[BoxShadow(offset_x=4, offset_y=4, blur_radius=10,
                                               color=RGBAColor(0, 0, 0, 160))],
                         transition=comp.Transition(duration=1.0))
    return comp.View(background_color=RGBAColor(20, 20, 20), children=[tiles, over])


def _capture_frames(pts, seed):
    import numpy as np

    from smelter_tpu_torch.core.types import Frame, FrameSet, PixelFormat, Resolution

    rng = np.random.RandomState(seed)
    return FrameSet(pts=pts, frames={f"input_{i}": Frame(
        data=(rng.randint(16, 235, (54, 96), dtype=np.uint8),
              rng.randint(16, 240, (27, 48), dtype=np.uint8),
              rng.randint(16, 240, (27, 48), dtype=np.uint8)),
        format=PixelFormat.PLANAR_YUV420, resolution=Resolution(96, 54), pts=0.0)
        for i in range(4)})


def _capture_renderer(dev, kind):
    from smelter_tpu_torch.core.types import PixelFormat, Resolution
    from smelter_tpu_torch.render.renderer import Renderer

    r = Renderer(device=dev)
    for i in range(4):
        r.register_input(f"input_{i}")
    r.register_shader("wave", SHADERS["wave"][0])
    r.update_scene("out", _capture_scene(kind, 20.0), Resolution(384, 216),
                   PixelFormat.PLANAR_YUV420)
    return r


def _render_at(r, pts, seed):
    return r.render(_capture_frames(pts, seed)).frames["out"].data


@pytest.mark.parametrize("kind", ["overlay", "shader"])
def test_replay_equals_the_eager_closure(cuda, kind, monkeypatch):
    """Each frame of a transition through the renderer (captured on a
    structure's first frame, replayed after) against the structure's
    closure run eagerly on the same frame's arguments: bit for bit."""
    from smelter_tpu_torch.core.types import PixelFormat, Resolution
    from smelter_tpu_torch.render import program
    from smelter_tpu_torch.render.capture import _map_tensors

    plans = []
    orig = program.OutputProgram.plan

    def spy(self, pts, input_frames):
        out = orig(self, pts, input_frames)
        plans.append((self, input_frames, out))
        return out

    monkeypatch.setattr(program.OutputProgram, "plan", spy)
    r = _capture_renderer(cuda, kind)
    _render_at(r, 0.0, 0)
    r.update_scene("out", _capture_scene(kind, 120.0), Resolution(384, 216),
                   PixelFormat.PLANAR_YUV420)
    replays = 0
    for k, pts in enumerate((0.25, 0.5, 0.6, 0.75, 1.0, 1.3, 1.4)):
        prog = r._programs["out"]
        cached = len(prog._build_cache)
        got = _render_at(r, pts, k)
        _, frames, (key, plan) = plans[-1]
        replays += len(prog._build_cache) == cached
        args = _map_tensors(prog._args(plan), lambda t: t.to(cuda))
        want = prog._build(key, frames)(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (kind, pts)
    assert replays >= 4


def test_a_capture_refuses_an_upload(cuda):
    from smelter_tpu_torch.render.capture import CaptureError, capture

    def fn(x):
        return x + interop.upload(torch.ones(3), x.device)

    with pytest.raises(CaptureError, match="interop.py"):
        capture(fn, (torch.zeros(3, device=cuda),), cuda)


def test_replays_neither_synchronise_nor_copy_from_the_host(cuda):
    """A replay frame makes no synchronising call, and its only copies from
    the host are the two buffers of the frame (planes and numbers): the
    graph holds none."""
    from torch.profiler import ProfilerActivity, profile

    r = _capture_renderer(cuda, "overlay")
    _render_at(r, 0.0, 0)
    _render_at(r, 0.1, 1)  # a replay: warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _render_at(r, 0.2, 2)
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(r._programs["out"]._build_cache) == 1
    h2d = sum(e.count for e in prof.key_averages() if "HtoD" in e.key)
    assert h2d == 2, [(e.key, e.count) for e in prof.key_averages()]


def test_kernel_counts_follow_replays(cuda):
    r = _capture_renderer(cuda, "overlay")
    counts = []
    for k in range(4):
        before = (scene_assembly.LAUNCHES, yuv_out.LAUNCHES)
        _render_at(r, k * 0.1, k)
        counts.append((scene_assembly.LAUNCHES - before[0], yuv_out.LAUNCHES - before[1]))
    assert len(r._programs["out"]._build_cache) == 1  # frames 1-3 replay
    assert counts == [(1, 1)] * 4


def _rtp_input_into_the_server(tmp_path):
    """One RTP input (UDP, H.264 at 320x240, 1 s) registered over HTTP into
    the port's server, under a rounded overlay (K1), recorded as YUV420 (K2)
    into an MP4. Returns the decoded frames and the K1/K2 launches."""
    import socket

    from chip_smoke import _ApiServer, edge_frame
    from smelter_tpu_torch.config import Config, LoggerConfig
    from smelter_tpu_torch.core.types import Framerate
    from smelter_tpu_torch.io import rtcp
    from smelter_tpu_torch.io.codec import Codec, Demuxer, VideoDecoder, VideoEncoder
    from smelter_tpu_torch.io.rtp import H264Payloader
    from smelter_tpu_torch.server.app import ApiState

    state = ApiState(Config(output_framerate=Framerate(30), ahead_of_time_processing=True,
                            never_drop_output_frames=True, logger=LoggerConfig(level="warning")))
    server = _ApiServer(state)
    out_path = str(tmp_path / "out.mp4")
    try:
        status, reply = server.call("POST", "/api/input/cam/register", {
            "type": "rtp_stream", "port": 0, "video": {"decoder": "ffmpeg_h264"},
            "required": True, "offset_ms": 0})
        assert status == 200, reply
        status, reply = server.call("POST", "/api/output/out/register", {
            "type": "mp4", "path": out_path,
            "video": {"resolution": {"width": 320, "height": 240},
                      "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
                      "initial": {"root": {"type": "view", "background_color": "#000000FF",
                                           "children": [
                          {"type": "rescaler", "child": {"type": "input_stream",
                                                         "input_id": "cam"}},
                          {"type": "view", "top": 20, "left": 20, "width": 120, "height": 60,
                           "border_radius": 12, "background_color": "#FF000080"}]}},
                      "send_eos_when": {"all_inputs": True}}})
        assert (status, reply) == (200, {})
        before = (scene_assembly.LAUNCHES, yuv_out.LAUNCHES)
        assert server.call("POST", "/api/start", {})[0] == 200
        enc = VideoEncoder(Codec.H264, 320, 240, 30, opts="global_header=0")
        pay = H264Payloader(ssrc=7)
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        port = state.pipeline._inputs["cam"].port
        for k in range(30):
            enc.send(*edge_frame(1, k, 320, 240), k / 30)
            while True:
                p = enc.receive()
                if p is None or p == "eof":
                    break
                for rp in pay.payload(p.data, p.pts_s or 0.0):
                    sock.sendto(rp.serialize(), ("127.0.0.1", port))
            time.sleep(1 / 30)
        enc.send_eof()
        while True:
            p = enc.receive()
            if p is None or p == "eof":
                break
            for rp in pay.payload(p.data, p.pts_s or 0.0):
                sock.sendto(rp.serialize(), ("127.0.0.1", port))
        sock.sendto(rtcp.build_bye([7]), ("127.0.0.1", port))
        sock.close()
        deadline = time.time() + 60
        while ("OUTPUT_DONE", "out") not in {(e.kind, e.entity_id)
                                             for e in state.pipeline.events.history()}:
            assert time.time() < deadline, "no OUTPUT_DONE"
            time.sleep(0.1)
        launches = (scene_assembly.LAUNCHES - before[0], yuv_out.LAUNCHES - before[1])
    finally:
        state.pipeline.close()
        server.stop()
    d = Demuxer(out_path)
    info = next(s for s in d.streams() if s.media_type == "video")
    dec, frames = VideoDecoder(info.codec, info.extradata), []
    while True:
        pkt = d.read()
        if pkt is None:
            dec.send_eof()
        else:
            dec.send(pkt.data, pkt.pts_s or 0.0)
        while True:
            f = dec.receive()
            if f is None or f == "eof":
                break
            frames.append(f)
        if pkt is None:
            break
    return frames, launches


def test_rtp_input_into_the_server_on_the_card(cuda, tmp_path, monkeypatch):
    """The server composes one RTP input on the card (its default device):
    K1 and K2 launch, and the MP4 holds the input's frames. Skips where the
    codec service cannot load (FFmpeg's shared libraries absent)."""
    from smelter_tpu_torch.io import codec

    try:
        codec.caps()
    except RuntimeError as exc:
        pytest.skip(f"the codec service cannot load here: {exc}")
    monkeypatch.delenv("SMELTER_DEVICE", raising=False)
    frames, (k1, k2) = _rtp_input_into_the_server(tmp_path)
    assert k1 > 0 and k2 > 0, (k1, k2)
    assert len(frames) >= 20 and frames[0][0].shape == (240, 320)


def test_grid_step_on_a_1x1_nccl_mesh(cuda):
    """The multi-device grid step on a mesh of this process alone (NCCL,
    world size 1): its all-gather is a copy through the collective, and the
    planes equal the single-device grid's on the card."""
    from smelter_tpu_torch import graft_entry
    from smelter_tpu_torch.core.types import Resolution
    from torch.distributed.device_mesh import init_device_mesh

    from smelter_tpu_torch.parallel import flagship, mesh as meshes

    in_res, out_res = Resolution(192, 108), Resolution(384, 216)
    inputs = graft_entry.case_inputs(16, in_res, seed=0)
    with meshes.process_group("cuda"):
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("streams", "space"))
        step, _ = flagship.make_multichip_step(mesh, 16, in_res, out_res, device=cuda)
        got = step(*inputs)
        torch.cuda.synchronize()
    fn, _ = flagship.make_flagship_compose(16, in_res, out_res, device=cuda)
    ref = fn(*(torch.from_numpy(p).to(cuda) for p in inputs))
    for name, a, b in zip("yuv", ref, got):
        assert torch.equal(a, b), name


# ------------------------------------------------------------- resize GEMMs
# Each resize site's card route (bf16 operands on the tensor cores, f32
# accumulation, `resample.gemm`) against its plain route (f32 GEMMs on the
# same bf16 values) on the card, within `chip_smoke.parity_vs_cpu`'s gate:
# <= 2 u8 LSB, and fewer than 0.01% of the values at 2 (a sum of another
# order can land on the other side of a bf16 tie between the axes). Sizes
# odd and cropped as well as the main path's.


def _resize_sites(dev):
    """name -> (card route's call, plain route's call, dtype the card
    returns, GEMMs a call, the site's own u8 rounding)."""
    from smelter_tpu_torch.ops import color_convert as cc
    from smelter_tpu_torch.ops import resample as rs
    from smelter_tpu_torch.ops.hopper.grid_resize import round_u8 as _round_u8

    gen = torch.Generator(device=dev).manual_seed(11)

    def u8(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)

    def f32(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def tile(y, u, v, crop, oh, ow):
        # what `yuv_tile_rgba_cm` runs: its weights, its three `_rs` calls
        w = cc.tile_weights(tuple(y.shape), tuple(u.shape), crop, oh, ow, "lanczos3", dev)
        ct, cl, chh, cww = crop

        def run(card):
            return torch.stack([cc._rs(y[ct:ct + chh, cl:cl + cww], w[0], w[1], card),
                                cc._rs(u, w[2], w[3], card), cc._rs(v, w[2], w[3], card)])
        return run

    def traced(img, bh, bw, oh, ow, crop, centered):
        args = (img, bh, bw, torch.tensor(oh, device=dev), torch.tensor(ow, device=dev),
                tuple(torch.tensor(c, device=dev) for c in crop), centered)
        return lambda card: rs._resize_matmul_traced(*args, card)

    def static(img, oh, ow):
        return lambda card: rs._resize_matmul(img, oh, ow, "lanczos3", card)

    patch = f32(270, 511, 4)[7:207, 13:313].permute(2, 0, 1)  # compose._src_tile_cm
    as_u8 = lambda x: cc.f32_to_u8(x.to(torch.float32))  # noqa: E731
    sites = {
        "grid luma 4x1080x1920->540x960": (static(u8(4, 1080, 1920), 540, 960),
                                           torch.bfloat16, 2, _round_u8),
        "grid chroma 4x540x960->270x480": (static(u8(4, 540, 960), 270, 480),
                                           torch.bfloat16, 2, _round_u8),
        "grid odd 3x270x511->135x255": (static(u8(3, 270, 511), 135, 255),
                                        torch.bfloat16, 2, _round_u8),
        "patch 4x200x300->150x221": (static(patch, 150, 221), torch.bfloat16, 2, as_u8),
        "tile cropped 270x510->156x277": (
            tile(u8(270, 510), u8(135, 255), u8(135, 255), (3, 5, 250, 480), 156, 277),
            torch.float32, 6, _round_u8),
        "tile 1080x1920->540x960": (
            tile(u8(1080, 1920), u8(540, 960), u8(540, 960), (0, 0, 1080, 1920), 540, 960),
            torch.float32, 6, _round_u8),
        "traced 4x270x511->192x320": (
            traced(f32(4, 270, 511), 192, 320, 150.3, 290.7, (3.5, 7.25, 480.0, 250.0), False),
            torch.float32, 2, as_u8),
        "traced centered 4x270x511->192x320": (
            traced(f32(4, 270, 511), 192, 320, 101.0, 170.4, (0.0, 0.0, 511.0, 270.0), True),
            torch.float32, 2, as_u8),
    }
    return {name: (lambda f=f: f(True), lambda f=f: f(False), dt, n, rnd)
            for name, (f, dt, n, rnd) in sites.items()}


SITE_NAMES = ["grid luma 4x1080x1920->540x960", "grid chroma 4x540x960->270x480",
              "grid odd 3x270x511->135x255", "patch 4x200x300->150x221",
              "tile cropped 270x510->156x277", "tile 1080x1920->540x960",
              "traced 4x270x511->192x320", "traced centered 4x270x511->192x320"]


@pytest.mark.parametrize("site", SITE_NAMES)
def test_resize_gemm_card_route_matches_the_plain_route(cuda, site):
    from smelter_tpu_torch.ops import resample as rs

    card, plain, dtype, n_gemms, to_u8 = _resize_sites(cuda)[site]
    before = rs.LAUNCHES
    got = card()
    assert rs.LAUNCHES == before + n_gemms
    want = plain()
    assert rs.LAUNCHES == before + n_gemms  # the plain route counts nothing
    assert got.dtype == dtype and want.dtype == torch.float32
    assert got.shape == want.shape
    d = (to_u8(got).to(torch.int32) - to_u8(want).to(torch.int32)).abs()
    mx, n_gt1 = int(d.max()), int((d > 1).sum())
    print(f"{site}: max {mx} LSB, {int((d > 0).sum())} of {d.numel()} values differ, "
          f"{n_gt1} by 2+")
    assert mx <= 2 and n_gt1 * 10000 < d.numel()


def test_resize_gemms_replay_bit_equal_in_a_graph(cuda):
    """Every site's card route captured in one CUDA graph and replayed:
    bit-equal to the same calls run eagerly, and counted on each replay."""
    from smelter_tpu_torch.ops import resample as rs
    from smelter_tpu_torch.render.capture import capture

    sites = _resize_sites(cuda)
    calls = [sites[name][0] for name in SITE_NAMES]

    def fn(x):
        return [call() + x for call in calls]

    prog, _ = capture(fn, (torch.zeros((), device=cuda),), cuda)
    before = rs.LAUNCHES
    got = prog(torch.zeros((), device=cuda))
    assert rs.LAUNCHES == before + sum(sites[name][3] for name in SITE_NAMES)
    want = fn(torch.zeros((), device=cuda))
    for name, a, b in zip(SITE_NAMES, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_the_card_route_raises_on_f32_operands(cuda):
    from smelter_tpu_torch.ops import resample as rs

    w = torch.ones((3, 5), device=cuda)
    with pytest.raises(TypeError, match="bf16 operands"):
        rs.gemm(w, torch.ones((5, 4), device=cuda), -2, torch.bfloat16, True)


def _group_case(dev, masks=True):
    """Members of every kind at 511 x 257 built through
    `compose._group_member` from sources on `dev`: a bordered YUV tile, an
    RGBA tile, a bordered tile rotated 30 degrees (K5), and "sdf" members:
    a box shadow, a bordered colour rotated 12 degrees, an upright ring and
    a colour rotated -40 degrees; each under two masks (the second rotated),
    and a tile clipped at the canvas edge."""
    from smelter_tpu_torch.ops import color_convert as cc

    h, w = 257, 511
    gen = torch.Generator(device=dev).manual_seed(44)
    y = torch.randint(0, 256, (270, 480), generator=gen, device=dev, dtype=torch.uint8)
    u = torch.randint(0, 256, (135, 240), generator=gen, device=dev, dtype=torch.uint8)
    v = torch.randint(0, 256, (135, 240), generator=gen, device=dev, dtype=torch.uint8)
    sources = [cc.DeferredYuvSource(y, u, v), [torch.rand((200, 300, 4), generator=gen,
                                                          device=dev)]]
    mrows = ([[8, 8, 8, 8, 12, 24, 400, 160, 0.0], [14, 14, 14, 14, 30, 100, 300, 150, 0.4]]
             if masks else [[0.0] * 9])
    n = 2 if masks else 0

    def member(content, rect, src=0, border=False, rotation=None, blur=0.0):
        top, left, hh, ww = rect
        st = compose.LayoutStatic(
            content=content, source_index=src if content == "texture" else -1, n_masks=n,
            rotated_masks=(False, True)[:n], has_rotation=rotation is not None,
            has_border=border, static_rect=rect,
            static_crop=(0, 0, 180, 260) if content == "texture" else None,
            static_blur=blur, static_rotation=rotation)
        p = interop.layout_params(dict(
            top=top, left=left, width=ww, height=hh, rotation_degrees=rotation or 0.0,
            border_radius=(10, 14, 6, 12), border_width=3.5 if border else 0.0,
            border_color=(1.0, 0.9, 0.7, 0.85), color=(0.8, 0.3, 0.2, 0.9),
            crop=(0, 0, 0, 0), blur_radius=blur, masks=mrows), dev)
        return st, p

    items = [member("box_shadow", (100, 40, 90, 160), blur=14.0),
             member("texture", (20, 30, 120, 200), border=True),
             member("texture", (60, 250, 150, 220), src=1),
             member("color", (10, 300, 80, 150), border=True, rotation=12.0),
             member("texture", (70, 120, 100, 180), border=True, rotation=30.0),
             member("color", (150, 260, 90, 170), border=True),
             member("color", (30, 180, 70, 120), rotation=-40.0),
             member("texture", (200, 420, 120, 200), border=True)]
    canvas = torch.rand((4, h, w), generator=gen, device=dev)
    canvas[:3] *= canvas[3:4]
    return canvas, items, sources


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint16, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("masks", [False, True])
def test_group_blend_kernel_matches_plain(cuda, dtype, masks):
    """K4 on a group of every member kind, on each canvas storage, and on a
    union clipped at the canvas edge: max abs err 0 (the same bits), in one
    launch a group."""
    from smelter_tpu_torch.ops.color_convert import canvas_decode
    from smelter_tpu_torch.ops.hopper import group_blend

    canvas, items, sources = _group_case(cuda, masks)
    _, h, w = canvas.shape
    base = compose._canvas_encode(canvas, dtype)
    for union, chosen in (((0, 0, h, w), items), ((192, 384, 65, 127), items[-1:])):
        members = [compose._group_member(st, p, sources) for st, p in chosen]
        before = group_blend.LAUNCHES
        got = group_blend.blend_group(base.clone(), members, union, h, w)
        torch.cuda.synchronize()
        assert group_blend.LAUNCHES == before + 1
        want = group_blend.blend_group_plain(base.clone(), members, union, h, w)
        assert got.dtype == dtype
        assert float((canvas_decode(got) - canvas_decode(want)).abs().max()) == 0.0


@pytest.mark.parametrize("k", [-0.2679, 0.5, 0.1317, -0.7071, 0.001])
@pytest.mark.parametrize("axis", [-1, -2])
def test_row_shear_kernel_matches_plain(cuda, k, axis):
    """K5 along each axis, on a contiguous and on a transposed (strided)
    input: bit-equal to the barrel shifter."""
    from smelter_tpu_torch.ops.hopper import row_shear

    gen = torch.Generator(device=cuda).manual_seed(5)
    img = torch.rand((4, 480, 853), generator=gen, device=cuda)
    for x in (img, img.transpose(-2, -1)):
        before = row_shear.LAUNCHES
        got = row_shear.shear(x, k, axis)
        torch.cuda.synchronize()
        assert row_shear.LAUNCHES == before + 1
        want = row_shear.shear_plain(x, k, axis)
        assert got.shape == want.shape and torch.equal(got, want)


def test_group_kernels_replay_equal_to_eager_without_a_sync(cuda):
    """general_4k at 4 x 256x144 -> 768x432 captured: a replay launches K4
    once per group and K5 six times, equals the eager function bit for bit,
    and makes no synchronising call."""
    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.ops.hopper import group_blend, row_shear
    from smelter_tpu_torch.parallel.flagship import make_flagship_general_compose
    from smelter_tpu_torch.render.capture import capture

    fn, args = make_flagship_general_compose(4, Resolution(256, 144), Resolution(768, 432),
                                             device=cuda)
    groups = []
    blend = group_blend.blend_group
    group_blend.blend_group = lambda c, m, u, h, w: groups.append(u) or blend(c, m, u, h, w)
    try:
        want = fn(*args)
    finally:
        group_blend.blend_group = blend
    prog, _ = capture(fn, args, cuda)
    prog(*args)  # warm
    torch.cuda.synchronize()
    before = (group_blend.LAUNCHES, row_shear.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = prog(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert (group_blend.LAUNCHES - before[0], row_shear.LAUNCHES - before[1]) == (len(groups), 6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# the banded grid resize (`ops/hopper/grid_resize.py`): layouts as (tiles,
# canvas (w, h), source (w, h)), each tile (top, left, height, width, crop)
def _grid_of(side, canvas, src):
    w, h = canvas[0] // side, canvas[1] // side
    return [(r * h, c * w, h, w, (0, 0, src[1], src[0])) for r in range(side) for c in range(side)]


GRID_LAYOUTS = {
    "tiles16_4k": (_grid_of(4, (3840, 2160), (1920, 1080)), (3840, 2160), (1920, 1080)),
    "tiles4to1_1080p": (_grid_of(2, (1920, 1080), (1920, 1080)), (1920, 1080), (1920, 1080)),
    "cropped": ([(100, 200, 540, 960, (120, 240, 800, 1400))], (1920, 1080), (1920, 1080)),
    "upscaled": ([(0, 0, 810, 1440, (0, 0, 360, 640)), (820, 1500, 200, 300, (0, 0, 360, 640))],
                 (1920, 1080), (640, 360)),
    "odd_width": ([(0, 0, 480, 854, (0, 0, 1080, 1920)), (480, 854, 600, 1066, (0, 0, 1080, 1920))],
                  (1920, 1080), (1920, 1080)),
    "overlapping": ([(0, 0, 720, 1280, (0, 0, 1080, 1920)), (360, 640, 720, 1280, (0, 0, 1080, 1920)),
                     (100, 1500, 300, 400, (10, 20, 900, 1600))], (1920, 1080), (1920, 1080)),
    "many_small": (_grid_of(8, (1920, 1072), (1920, 1080)), (1920, 1072), (1920, 1080)),
    "odd_source": (_grid_of(2, (1920, 1080), (1919, 1079)), (1920, 1080), (1919, 1079)),
}


def _grid_sources(dev, n, src, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w, h = src
    return [tuple(torch.randint(0, 256, s, dtype=torch.uint8, generator=gen, device=dev)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))) for _ in range(n)]


def _lsb_and_ppm(got, want):
    d = [(a.to(torch.int32) - b.to(torch.int32)).abs() for a, b in zip(got, want)]
    n = sum(x.numel() for x in d)
    return max(int(x.max()) for x in d), sum(int((x > 0).sum()) for x in d) * 1e6 / n


@pytest.mark.parametrize("layout", sorted(GRID_LAYOUTS))
def test_grid_resize_kernel_matches_the_plain_chain(cuda, layout):
    """The kernel against the plain chain on the card (the bf16 cast,
    cuBLAS's GEMMs, `round_u8` and the placement): at most 1 step, on a
    few samples a million (the two sum their f32 products in other
    orders). Disjoint tiles take one launch (of up to MAX_PLANES tile
    planes), overlapping ones one each."""
    from smelter_tpu_torch.ops.hopper import grid_resize

    tiles, (w, h), src = GRID_LAYOUTS[layout]
    g = grid_resize.GridResize(tiles, h, w, (16, 128, 128))
    sources = _grid_sources(cuda, len(tiles), src, seed=len(layout))
    before = grid_resize.LAUNCHES
    got = g(sources, cuda)
    torch.cuda.synchronize()
    assert grid_resize.LAUNCHES - before == len(g.launches)
    # disjoint tiles: one launch a MAX_PLANES tile planes
    assert len(g.launches) == (len(tiles) if layout == "overlapping"
                               else -(-3 * len(tiles) // grid_resize.MAX_PLANES))
    want = g.resize_tiles_plain(sources, cuda)
    assert [t.shape for t in got] == [t.shape for t in want]
    mx, ppm = _lsb_and_ppm(got, want)
    print(f"grid_resize {layout}: max {mx} LSB, {ppm:.3f} samples a million differ")
    assert mx <= 1 and ppm <= 10


@pytest.mark.parametrize("n,in_res,out_res", [(16, (1920, 1080), (3840, 2160)),
                                              (4, (1919, 1079), (1920, 1080))])
def test_flagship_grid_launches_grid_resize_once_a_call(cuda, n, in_res, out_res):
    """`make_flagship_compose`'s opaque grid (16 x 1080p -> 4K, and inputs of
    odd size): one `grid_resize` launch a call and no resize GEMM, eagerly
    and as a captured replay (bit-equal), its planes within 1 step of
    `GridResize.resize_tiles_plain` of the analysis's tiles on at most 10
    samples a million."""
    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.ops import resample
    from smelter_tpu_torch.ops.hopper import grid_resize
    from smelter_tpu_torch.parallel import flagship
    from smelter_tpu_torch.render.capture import capture

    in_r, out_r = Resolution(*in_res), Resolution(*out_res)
    fn, _ = flagship.make_flagship_compose(n, in_r, out_r, device=cuda)
    sources = _grid_sources(cuda, n, in_res, seed=n)
    args = tuple(torch.stack(planes) for planes in zip(*sources))
    prog, _ = capture(fn, args, cuda)
    torch.cuda.synchronize()
    counts = [(grid_resize.LAUNCHES, resample.LAUNCHES)]
    outs = []
    for run in (fn, prog):  # eagerly, then replayed
        outs.append(run(*args))
        torch.cuda.synchronize()
        counts.append((grid_resize.LAUNCHES, resample.LAUNCHES))
    assert [(b[0] - a[0], b[1] - a[1]) for a, b in zip(counts, counts[1:])] == [(1, 0), (1, 0)]
    eager, out = outs
    assert all(torch.equal(a, b) for a, b in zip(eager, out))
    bg, tiles = flagship._analyze_opaque_grid(flagship._tiles_layouts(n, in_r, out_r), out_r)
    g = grid_resize.GridResize([(t, l, h, w, (0, 0, in_res[1], in_res[0]))
                                for _, t, l, h, w in tiles], out_res[1], out_res[0], bg)
    mx, ppm = _lsb_and_ppm(out, g.resize_tiles_plain([sources[i] for i, *_ in tiles], cuda))
    print(f"flagship grid {n} x {in_res} -> {out_res}: max {mx} LSB, {ppm:.3f} ppm")
    assert mx <= 1 and ppm <= 10


@pytest.mark.parametrize("n,out_res,planes", [(16, (3840, 2160), 48), (4, (1920, 1080), 12)])
def test_grid_resize_runs_once_a_replay_of_the_grid_program(cuda, n, out_res, planes):
    """The renderer's grid program of a Tiles of `n` 1080p inputs, captured:
    each replay launches the kernel once and counts its tile planes in
    `program.grid.tile_planes`, and its frames stay within 1 step of the
    plain chain."""
    from smelter_tpu_torch.core import types as tt
    from smelter_tpu_torch.ops.hopper import grid_resize
    from smelter_tpu_torch.render.renderer import Renderer, RendererOptions
    from smelter_tpu_torch.scene import components as comp
    from smelter_tpu_torch.utils import tracing

    r = Renderer(RendererOptions(async_compile=False), device=cuda)
    for i in range(n):
        r.register_input(f"input_{i}")
    r.update_scene("out", comp.Tiles(background_color=tt.RGBAColor(0, 0, 0, 255),
                                     tile_aspect_ratio=(16, 9),
                                     children=[comp.InputStream(input_id=f"input_{i}")
                                               for i in range(n)]),
                   tt.Resolution(*out_res), tt.PixelFormat.PLANAR_YUV420)
    sources = _grid_sources(cuda, n, (1920, 1080), seed=n)
    frames = {f"input_{i}": tt.Frame(data=planes_, format=tt.PixelFormat.PLANAR_YUV420,
                                     resolution=tt.Resolution(1920, 1080), pts=0.0)
              for i, planes_ in enumerate(sources)}
    r.render(tt.FrameSet(pts=0.0, frames=frames))  # the capture
    torch.cuda.synchronize()
    tracing.reset()
    before = grid_resize.LAUNCHES
    try:
        for k in range(1, 4):
            out = r.render(tt.FrameSet(pts=k / 32, frames=frames)).frames["out"].data
        torch.cuda.synchronize()
        assert grid_resize.LAUNCHES - before == 3
        assert tracing.counters()["program.grid.tile_planes"] == 3 * planes
    finally:
        tracing.reset()
    (program,) = r._programs["out"]._build_cache.values()
    assert program.fn.route == "grid"
    grid = dict(zip(program.fn.__code__.co_freevars,
                    (c.cell_contents for c in program.fn.__closure__)))["grid"]
    mx, _ = _lsb_and_ppm(out, grid.resize_tiles_plain(sources, cuda))
    assert mx <= 1


# the tile converts' banded resize (`ops/hopper/tile_resize.py`): sites as
# (luma (w, h), crop, out_h, out_w), the two tile sites of `_resize_sites`,
# the multiview's two picture sizes at 4K, an upscale and an odd crop
TILE_SITES = {
    "tile cropped 270x510->156x277": ((510, 270), (3, 5, 250, 480), 156, 277),
    "tile 1080x1920->540x960": ((1920, 1080), (0, 0, 1080, 1920), 540, 960),
    "multiview bordered 1080x1920->528x938": ((1920, 1080), (0, 0, 1080, 1920), 528, 938),
    "multiview shadowed 1080x1920->520x924": ((1920, 1080), (0, 0, 1080, 1920), 520, 924),
    "upscale 360x640->810x1440": ((640, 360), (0, 0, 360, 640), 810, 1440),
    "odd crop 1080x1920->377x615": ((1920, 1080), (7, 13, 1001, 1777), 377, 615),
}


@pytest.mark.parametrize("site", sorted(TILE_SITES))
def test_tile_resize_matches_the_gemm_and_plain_routes(cuda, site):
    """One tile through the kernel against the GEMM route on the card
    (`color_convert._rs`, cuBLAS) and the plain route (f32 GEMMs on the same
    bf16 values), within `chip_smoke.parity_vs_cpu`'s gate: <= 2 u8 steps
    after `round_u8`, under 0.01% of the values at 2 (a sum of another order
    can land on the other side of a bf16 tie between the axes). One launch,
    no resize GEMM."""
    from smelter_tpu_torch.ops import color_convert as cc
    from smelter_tpu_torch.ops import resample
    from smelter_tpu_torch.ops.hopper import tile_resize
    from smelter_tpu_torch.ops.hopper.grid_resize import round_u8

    src, crop, oh, ow = TILE_SITES[site]
    (y, u, v), = _grid_sources(cuda, 1, src, seed=len(site))
    before = (tile_resize.LAUNCHES, resample.LAUNCHES)
    got = cc.yuv_tile_products(y, u, v, crop, oh, ow)
    torch.cuda.synchronize()
    assert (tile_resize.LAUNCHES - before[0], resample.LAUNCHES - before[1]) == (1, 0)
    w = cc.tile_weights(tuple(y.shape), tuple(u.shape), crop, oh, ow, "lanczos3", cuda)
    ct, cl, chh, cww = crop
    for card in (True, False):
        want = (cc._rs(y[ct:ct + chh, cl:cl + cww], w[0], w[1], card),
                cc._rs(u, w[2], w[3], card), cc._rs(v, w[2], w[3], card))
        assert all(a.dtype == b.dtype == torch.float32 and a.shape == b.shape == (oh, ow)
                   for a, b in zip(got, want))
        d = torch.stack([(round_u8(a).to(torch.int32) - round_u8(b).to(torch.int32)).abs()
                         for a, b in zip(got, want)])
        mx, n_gt1 = int(d.max()), int((d > 1).sum())
        print(f"tile_resize {site} vs {'GEMM' if card else 'plain'} route: max {mx} LSB, "
              f"{int((d > 0).sum())} of {d.numel()} values differ, {n_gt1} by 2+")
        assert mx <= 2 and n_gt1 * 10000 < d.numel()


def test_tile_resize_batch_equals_each_tile_alone_and_replays_bit_equal(cuda):
    """The multiview's 16 tiles at 4K in one call (one launch of 48 tile
    planes) give each tile's products bit for bit as a call of that tile
    alone, and a captured replay gives them again."""
    from smelter_tpu_torch.ops import color_convert as cc
    from smelter_tpu_torch.ops.hopper import tile_resize
    from smelter_tpu_torch.render.capture import capture

    sizes = [(528, 938) if k % 2 else (520, 924) for k in range(16)]
    planes = _grid_sources(cuda, 16, (1920, 1080), seed=26)
    tiles = [(p, (0, 0, 1080, 1920), h, w) for p, (h, w) in zip(planes, sizes)]
    before = tile_resize.LAUNCHES
    got = tile_resize.resize_tiles(tiles)
    torch.cuda.synchronize()
    assert tile_resize.LAUNCHES - before == 1
    for (p, crop, h, w), products in zip(tiles, got):
        alone = cc.yuv_tile_products(*p, crop, h, w)
        assert all(torch.equal(a, b) for a, b in zip(products, alone))

    def fn(x):
        return [t + x for products in tile_resize.resize_tiles(tiles) for t in products]

    prog, _ = capture(fn, (torch.zeros((), device=cuda),), cuda)
    replayed = prog(torch.zeros((), device=cuda))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(replayed, [t for ps in got for t in ps]))


@pytest.mark.parametrize("out_res", [(768, 432), (3840, 2160)])
def test_styled_multiview_counters_follow_the_kernels(cuda, out_res):
    """The benchmark's styled multiview (16 Rescaler cards, bordered and
    shadowed; `benchmark/scenes/multiview.py`) through the renderer's
    general program, captured: on each replay the general counters equal
    the kernels' launches (a K4 launch a group, one K1 launch for its
    members, one `tile_resize` launch for the run's 16 tile converts, 3
    tile planes each, no resize GEMM, no K5), K4 evaluates the 15 rings and
    shadows behind a picture (`program.general.sdf_members`), and the frame
    meets the benchmark's plain reference within the cell's limits."""
    import importlib.util
    import json
    from pathlib import Path
    from types import SimpleNamespace

    from smelter_tpu_torch.core import types as tt
    from smelter_tpu_torch.ops import resample
    from smelter_tpu_torch.ops.hopper import group_blend, row_shear, tile_resize
    from smelter_tpu_torch.render.renderer import Renderer, RendererOptions
    from smelter_tpu_torch.scene import components as comp
    from smelter_tpu_torch.utils import tracing

    bench = Path(__file__).resolve().parents[1] / "benchmark"

    def load(path):
        spec = importlib.util.spec_from_file_location(f"cuda_multiview_{path.parent.name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    scene = load(bench / "scenes" / "multiview.py")
    ref = load(bench / "references" / "multiview.py")
    limits = json.loads((bench / "limits" / "multiview16_4k.steady.json").read_text())
    cfg = {**json.loads((bench / "configs" / "multiview16_4k.json").read_text()),
           "output_width": out_res[0], "output_height": out_res[1]}
    ids = [f"input_{i}" for i in range(16)]
    r = Renderer(RendererOptions(async_compile=False), device=cuda)
    for iid in ids:
        r.register_input(iid)
    r.update_scene("out", scene.build(SimpleNamespace(comp=comp, types=tt), cfg, 0, "out"),
                   tt.Resolution(*out_res), tt.PixelFormat.PLANAR_YUV420)
    sources = _grid_sources(cuda, 16, (1920, 1080), seed=3)
    frames = {iid: tt.Frame(data=p, format=tt.PixelFormat.PLANAR_YUV420,
                            resolution=tt.Resolution(1920, 1080), pts=0.0)
              for iid, p in zip(ids, sources)}
    r.render(tt.FrameSet(pts=0.0, frames=frames))  # the capture
    torch.cuda.synchronize()
    tracing.reset()
    before = (group_blend.LAUNCHES, scene_assembly.LAUNCHES, resample.LAUNCHES,
              row_shear.LAUNCHES, yuv_out.LAUNCHES, tile_resize.LAUNCHES)
    try:
        for k in range(1, 4):
            out = r.render(tt.FrameSet(pts=k / 32, frames=frames)).frames["out"].data
        torch.cuda.synchronize()
        c = tracing.counters()
    finally:
        tracing.reset()
    launched = [after - b for after, b in zip(
        (group_blend.LAUNCHES, scene_assembly.LAUNCHES, resample.LAUNCHES,
         row_shear.LAUNCHES, yuv_out.LAUNCHES, tile_resize.LAUNCHES), before)]
    print(out_res, {k: v for k, v in c.items() if k.startswith("program.general")}, launched)
    assert c["program.calls.general"] == 3
    assert launched == [c["program.general.groups"], 3, 0, 0, 3, 3]
    assert c["program.general.tile_converts"] == 3 * 16
    assert c["program.general.tile_resize_planes"] == 3 * 3 * 16
    assert c["program.general.assembly_members"] % 3 == 0 and "program.general.shears" not in c
    # the 7 rings and 8 shadows behind a picture, evaluated inside K4
    assert c["program.general.sdf_members"] == 3 * 15
    want = ref.render(cfg, ids, {iid: ("PLANAR_YUV420", p) for iid, p in zip(ids, sources)},
                      cuda, torch.bfloat16)
    mx, ppm = _lsb_and_ppm(out, tuple(torch.from_numpy(p).to(cuda) for p in want))
    print(out_res, "against the reference: max", mx, "steps,", ppm, "ppm")
    assert mx <= limits["max_lsb"] and ppm <= limits["diff_ppm"]


# the fused NV12 convert-and-resize pass (`ops/hopper/nv12_resize.py`): sites
# as (luma (w, h), crop, out_h, out_w, tiles): the NV12 Tiles cell's 16
# tiles, a cropped tile, a size no multiple of 16, an upscale
NV12_SITES = {
    "cell 16 x 1080x1920->540x960": ((1920, 1080), (0, 0, 1080, 1920), 540, 960, 16),
    "cropped 1080x1920->377x615": ((1920, 1080), (7, 13, 1001, 1777), 377, 615, 1),
    "odd size 1080x1920->531x947": ((1920, 1080), (0, 0, 1080, 1920), 531, 947, 2),
    "upscale 360x640->810x1440": ((640, 360), (0, 0, 360, 640), 810, 1440, 1),
}


def _nv12_sources(dev, n, src, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    w, h = src
    return [(torch.randint(0, 256, (h, w), dtype=torch.uint8, generator=gen, device=dev),
             torch.randint(0, 256, (h // 2, w // 2, 2), dtype=torch.uint8, generator=gen,
                           device=dev)) for _ in range(n)]


def _bf16_steps(got, want):
    """|got - want| in bf16 steps of `want`, a step being 2^-16 (a 256th of
    a u8 step) at least: where the resize's f32 sums cancel to nearly 0,
    their rounding in another order moves them by more than their own
    bf16 step."""
    step = torch.clamp(torch.exp2(torch.floor(torch.log2(torch.clamp(want.abs(), min=2.0 ** -40)))
                                  - 7), min=2.0 ** -16)
    return (got - want).abs() / step


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("site", sorted(NV12_SITES))
def test_nv12_resize_matches_the_gemm_route(cuda, site, seed):
    """The kernel against the parent's route on the card (the eager
    conversion of the whole picture, `resize_matmul`'s bf16 cuBLAS GEMMs
    of the crop), which sums the same bf16 products in f32 in another
    order: R, G and B within `nv12_resize.gemm_route_bound`, which is one
    bf16 step of the output (and the width pass's f32 error) where no
    height-pass tie reaches it, so a value beyond one step is one a tie
    reaches; at most 1% of the values differ; alpha equal; the tiles of a
    call in one launch, no resize GEMM."""
    from smelter_tpu_torch.ops import color_convert as cc
    from smelter_tpu_torch.ops import resample
    from smelter_tpu_torch.ops.hopper import nv12_resize

    src, crop, oh, ow, n = NV12_SITES[site]
    tiles = [(p, crop, oh, ow) for p in _nv12_sources(cuda, n, src, seed=1000 * seed + len(site))]
    before = (nv12_resize.LAUNCHES, resample.LAUNCHES)
    got = nv12_resize.resize_tiles(tiles)
    torch.cuda.synchronize()
    assert (nv12_resize.LAUNCHES - before[0], resample.LAUNCHES - before[1]) == (1, 0)
    worst, ratio, differ, beyond, untied, reached, total = 0.0, 0.0, 0, 0, 0, 0, 0
    for (planes, _, _, _), rgba in zip(tiles, got):
        want = resample.resize_crop_cm(cc.nv12_to_rgba(*planes), crop, oh, ow)
        assert rgba.dtype == torch.float32 and rgba.shape == want.shape == (4, oh, ow)
        assert torch.equal(rgba[3], want[3])
        bound, tied = nv12_resize.gemm_route_bound(planes, crop, oh, ow)
        d = (rgba[:3].double() - want[:3].double()).abs()
        worst = max(worst, float(_bf16_steps(rgba[:3], want[:3]).max()))
        ratio = max(ratio, float((d / bound).max()))
        over = d > bound - tied  # beyond the one-step limit
        beyond += int(over.sum())
        untied += int((over & (tied == 0)).sum())
        reached += int((tied > 0).sum())
        differ += int((d > 0).sum())
        total += d.numel()
    print(f"nv12_resize {site} seed {seed} vs the GEMM route: {worst} bf16 steps at most, "
          f"{ratio:.4f} of the bound, {differ} of {total} values differ, {beyond} beyond one "
          f"step ({untied} of them where no tie reaches; ties reach {reached})")
    assert ratio <= 1.0 and untied == 0 and differ * 100 < total


def test_nv12_resize_converts_as_the_eager_chain_at_an_unchanged_size(cuda):
    """At an unchanged size (one tap of 1 on each axis) the kernel's
    products are the eager chain's picture on the card rounded to bf16,
    bit for bit: its conversion repeats the chain's operations."""
    from smelter_tpu_torch.ops import color_convert as cc
    from smelter_tpu_torch.ops.hopper import nv12_resize

    (y, uv), = _nv12_sources(cuda, 1, (1920, 1080), seed=29)
    for crop in ((0, 0, 1080, 1920), (3, 5, 777, 1001)):
        rgba, = nv12_resize.resize_tiles([((y, uv), crop, crop[2], crop[3])])
        ct, cl, ch, cw = crop
        want = cc.nv12_to_rgba(y, uv)[ct:ct + ch, cl:cl + cw].permute(2, 0, 1)
        assert torch.equal(rgba, want.to(torch.bfloat16).to(torch.float32))


def test_nv12_resize_batch_equals_each_tile_alone_and_replays_bit_equal(cuda):
    """The cell's 16 tiles in one call give each tile's RGBA bit for bit as
    a call of that tile alone, and a captured replay gives them again."""
    from smelter_tpu_torch.ops.hopper import nv12_resize
    from smelter_tpu_torch.render.capture import capture

    tiles = [(p, (0, 0, 1080, 1920), 540, 960)
             for p in _nv12_sources(cuda, 16, (1920, 1080), seed=30)]
    got = nv12_resize.resize_tiles(tiles)
    for tile, rgba in zip(tiles, got):
        assert torch.equal(rgba, nv12_resize.resize_tiles([tile])[0])

    def fn(x):
        return [t + x for t in nv12_resize.resize_tiles(tiles)]

    prog, _ = capture(fn, (torch.zeros((), device=cuda),), cuda)
    before = nv12_resize.LAUNCHES
    replayed = prog(torch.zeros((), device=cuda))
    torch.cuda.synchronize()
    assert nv12_resize.LAUNCHES - before == 1
    assert all(torch.equal(a, b) for a, b in zip(replayed, got))


def test_nv12_resize_refuses_a_downscale_past_its_strips(cuda):
    """A 1080p picture into 71x40 (27x) has no strip whose window fits a
    block's shared memory: the card's call raises, also for a deferred
    source's tile, launches nothing and takes no other route (no resize
    GEMM, no conversion of the picture)."""
    from smelter_tpu_torch.ops import color_convert as cc
    from smelter_tpu_torch.ops import resample
    from smelter_tpu_torch.ops.hopper import nv12_resize
    from smelter_tpu_torch.utils import tracing

    planes, = _nv12_sources(cuda, 1, (1920, 1080), seed=32)
    crop = (0, 0, 1080, 1920)
    src = cc.DeferredNv12Source(*planes)
    before = (nv12_resize.LAUNCHES, resample.LAUNCHES)
    tracing.reset()
    try:
        with pytest.raises(ValueError, match="shared memory"):
            nv12_resize.resize_tiles([(planes, crop, 40, 71)])
        with pytest.raises(ValueError, match="shared memory"):
            src.tile_cm(crop, 40, 71)
        torch.cuda.synchronize()
        c = tracing.counters()
    finally:
        tracing.reset()
    assert (nv12_resize.LAUNCHES, resample.LAUNCHES) == before
    assert "program.general.rgba_converts" not in c and "program.general.nv12_tiles" not in c


@pytest.mark.parametrize("out_res", [(768, 432), (3840, 2160)])
def test_nv12_tiles_counters_follow_the_kernel(cuda, out_res):
    """The benchmark's NV12 Tiles (16 NV12 inputs of 1080p) through the
    renderer's general program, captured: each replay launches the fused
    pass once for the 16 tiles, no resize GEMM, K1 and K2 once and K4 a
    group; it counts 16 `nv12_tiles` and registers no conversion and no
    mip level (both 0); the frame meets the benchmark's plain reference
    within the cell's limits."""
    import importlib.util
    import json
    from pathlib import Path
    from types import SimpleNamespace

    from smelter_tpu_torch.core import types as tt
    from smelter_tpu_torch.ops import resample
    from smelter_tpu_torch.ops.hopper import group_blend, nv12_resize
    from smelter_tpu_torch.render.renderer import Renderer, RendererOptions
    from smelter_tpu_torch.scene import components as comp
    from smelter_tpu_torch.utils import tracing

    bench = Path(__file__).resolve().parents[1] / "benchmark"

    def load(path):
        spec = importlib.util.spec_from_file_location(f"cuda_nv12_{path.parent.name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    scene = load(bench / "scenes" / "tiles.py")
    ref = load(bench / "references" / "tiles_nv12.py")
    limits = json.loads((bench / "limits" / "tiles16_4k_nv12.steady.json").read_text())
    cfg = {**json.loads((bench / "configs" / "tiles16_4k_nv12.json").read_text()),
           "output_width": out_res[0], "output_height": out_res[1]}
    ids = [f"input_{i}" for i in range(16)]
    r = Renderer(RendererOptions(async_compile=False), device=cuda)
    for iid in ids:
        r.register_input(iid)
    r.update_scene("out_0", scene.build(SimpleNamespace(comp=comp, types=tt), cfg, 0, "out_0"),
                   tt.Resolution(*out_res), tt.PixelFormat.PLANAR_YUV420)
    sources = _nv12_sources(cuda, 16, (1920, 1080), seed=31)
    frames = {iid: tt.Frame(data=p, format=tt.PixelFormat.NV12,
                            resolution=tt.Resolution(1920, 1080), pts=0.0)
              for iid, p in zip(ids, sources)}
    r.render(tt.FrameSet(pts=0.0, frames=frames))  # the capture
    torch.cuda.synchronize()
    tracing.reset()
    mods = (nv12_resize, resample, scene_assembly, yuv_out, group_blend)
    before = [m.LAUNCHES for m in mods]
    try:
        for k in range(1, 4):
            out = r.render(tt.FrameSet(pts=k / 32, frames=frames)).frames["out_0"].data
        torch.cuda.synchronize()
        c = tracing.counters()
    finally:
        tracing.reset()
    launched = [m.LAUNCHES - b for m, b in zip(mods, before)]
    print(out_res, {k: v for k, v in c.items() if k.startswith("program.general")}, launched)
    assert c["program.calls.general"] == 3
    assert launched == [3, 0, 3, 3, c["program.general.groups"]]
    assert c["program.general.nv12_tiles"] == 3 * 16
    assert c["program.general.rgba_converts"] == c["program.general.mip_levels"] == 0
    assert "program.general.rgba_tiles" not in c
    want = ref.render(cfg, ids, {iid: ("NV12", p) for iid, p in zip(ids, sources)}, cuda,
                      torch.bfloat16)
    mx, ppm = _lsb_and_ppm(out, tuple(torch.from_numpy(p).to(cuda) for p in want))
    print(out_res, "against the reference: max", mx, "steps,", ppm, "ppm")
    assert mx <= limits["max_lsb"] and ppm <= limits["diff_ppm"]


def _resize_digests(dev):
    """{case: sha256 of its output bytes} of `grid_resize` on the two Tiles
    cells' layouts and of `tile_resize` on the multiview's 16 tiles at 4K,
    from u8 planes numpy's PCG64 draws from one seed (the same bytes on any
    machine and version)."""
    import hashlib

    import numpy as np

    from smelter_tpu_torch.ops.hopper import grid_resize, tile_resize

    rng = np.random.default_rng(2026)

    def planes(w, h):
        return tuple(torch.from_numpy(rng.integers(0, 256, s, dtype=np.uint8)).to(dev)
                     for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))

    def sha(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()

    out = {}
    for name in ("tiles16_4k", "tiles4to1_1080p"):
        tiles, (w, h), src = GRID_LAYOUTS[name]
        g = grid_resize.GridResize(tiles, h, w, (16, 128, 128))
        out[f"grid_resize {name}"] = sha(g([planes(*src) for _ in tiles], dev))
    sizes = [(528, 938) if k % 2 else (520, 924) for k in range(16)]
    tiles = [(planes(1920, 1080), (0, 0, 1080, 1920), h, w) for h, w in sizes]
    out["tile_resize multiview16_4k"] = sha(
        [t for products in tile_resize.resize_tiles(tiles) for t in products])
    return out


# `_resize_digests` as the parent tree of the fused NV12 pass gave them on an
# NVIDIA H100 80GB HBM3 (700 W): the banded resizes' body was split into
# passes that the NV12 pass shares, and computes what it computed
RESIZE_DIGESTS = {
    "grid_resize tiles16_4k": "21c68a660e2378b22d385b8f0a256909356988c44ed25e59b86ddb25051b136c",
    "grid_resize tiles4to1_1080p":
        "91b383004e54a1ac1b396380016ea6c655bf23dd5c7473c552886476b08950e1",
    "tile_resize multiview16_4k":
        "a982349e87e9baf17235f103853e0fcaa5eb153e7238f4c3cb89e5959ef135ba",
}


def test_banded_resizes_give_the_bytes_they_gave(cuda):
    assert _resize_digests(cuda) == RESIZE_DIGESTS
