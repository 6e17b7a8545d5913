"""The port's captured frame programs (`render/capture.py`) and the
renderer's freeze-frame, on the CPU, against the JAX package.

On the CPU a captured program has no graph: it copies each frame's
arguments into its static buffers, runs the closure on them and copies the
outputs out, the plumbing the card runs around its replays. Here:

  - the reference's `test_scene_update_does_not_stall_render_loop`, run on
    the port (`test_torch_web.PortRenderer`);
  - with `async_compile`, a structural update shows the previous frame, bit
    for bit with the new pts, until the background build lands; the first
    frame after that is within 1 u8 LSB of the JAX renderer's;
  - a new resolution or format, and an output unregistered and registered
    again, never freeze a stale frame;
  - the static-buffer program equals the closure run directly on the same
    frame, bit for bit, over a transition (animating frames included) and on
    the YUV grid program;
  - a frame's output is unchanged after the next frame renders;
  - the 33rd structure evicts the oldest; `close()` drains a running build;
  - `each_run`, `hold` and `device_constant` inside and outside a build.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

import test_renderer
from test_torch_renderer import (
    _assert_frames_match,
    _banner_scene,
    _frames,
    _planes,
    _render_seq,
)
from test_torch_web import PortRenderer
from smelter_tpu.core.types import PixelFormat, Resolution, RGBAColor
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.scene import components as comp
from smelter_tpu_torch.core import types as tt
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.render import capture as cap
from smelter_tpu_torch.render import program as tprog
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer
from smelter_tpu_torch.render.renderer import RendererOptions

torch.set_num_threads(2)

OUT = Resolution(384, 216)  # the size of test_torch_renderer's scenes


def test_scene_update_does_not_stall_render_loop_on_the_port(monkeypatch):
    import smelter_tpu.render.renderer as ref_renderer

    monkeypatch.setattr(ref_renderer, "Renderer", PortRenderer)
    test_renderer.test_scene_update_does_not_stall_render_loop()


@pytest.fixture
def gate(monkeypatch):
    """Holds every background build of the port until `gate.set()`."""
    event = threading.Event()
    orig = tprog.capture

    def gated(*args, **kwargs):
        if threading.current_thread().name == "program-capture":
            assert event.wait(30), "the test never opened the gate"
        return orig(*args, **kwargs)

    monkeypatch.setattr(tprog, "capture", gated)
    yield event
    event.set()
    tprog._drain_background_compiles(30)


def _solid(color):
    return comp.View(background_color=color, children=[
        comp.Rescaler(position=comp.AbsolutePosition(width=96.0, height=54.0, top=10.0,
                                                     left=20.0),
                      child=comp.InputStream(input_id="input_0"))])


def _async_renderer():
    r = TorchRenderer(RendererOptions(async_compile=True), device="cpu")
    r.register_input("input_0")
    return r


def _port_frames(pts, n=1):
    return from_reference(_frames(n, pts))


@pytest.mark.parametrize("fmt", [PixelFormat.RGBA, PixelFormat.PLANAR_YUV420],
                         ids=lambda f: f.value)
def test_async_update_freezes_until_the_build_lands(fmt, gate):
    scene_a, scene_b = _solid(RGBAColor(200, 0, 0)), _banner_scene(40.0, n_inputs=1)
    r = _async_renderer()
    r.update_scene("out", *from_reference((scene_a, OUT, fmt)))
    first = r.render(_port_frames(0.0)).frames["out"]  # no last frame: built now
    r.update_scene("out", *from_reference((scene_b, OUT, fmt)))
    for pts in (0.1, 0.2, 0.3):
        frozen = r.render(_port_frames(pts)).frames["out"]
        assert frozen.pts == pts and frozen.resolution == first.resolution
        assert frozen.format == first.format
        assert all(torch.equal(a, b) for a, b in zip(_tensors(frozen.data),
                                                       _tensors(first.data)))
    gate.set()
    tprog._drain_background_compiles(30)
    got = _planes(r.render(_port_frames(0.4)).frames["out"].data)
    ref, _ = _render_seq(JaxRenderer, [(scene_a, 0.0), (scene_b, 0.1), (None, 0.2),
                                       (None, 0.3), (None, 0.4)], fmt, 1, OUT)
    _assert_frames_match(ref[-1:], [got], f"after the build {fmt.value}")
    assert not np.array_equal(got[0], _planes(first.data)[0])


def _tensors(data):
    return data if isinstance(data, tuple) else (data,)


@pytest.mark.parametrize("change", ["resolution", "format", "re-register"])
def test_no_stale_frame_is_frozen(change, gate):
    r = _async_renderer()
    fmt = tt.PixelFormat.RGBA
    r.update_scene("out", from_reference(_solid(RGBAColor(200, 0, 0))), from_reference(OUT),
                   fmt)
    r.render(_port_frames(0.0))
    res, new_fmt = from_reference(OUT), fmt
    if change == "resolution":
        res = tt.Resolution(128, 72)
    elif change == "format":
        new_fmt = tt.PixelFormat.PLANAR_YUV420
    else:
        r.unregister_output("out")
    r.update_scene("out", from_reference(_solid(RGBAColor(0, 0, 200))), res, new_fmt)
    out = r.render(_port_frames(0.1)).frames["out"]  # built now, never frozen
    assert out.resolution == res and out.format == new_fmt and out.pts == 0.1
    y = _tensors(out.data)[0]
    assert tuple(y.shape[:2]) == (res.height, res.width)
    if new_fmt == tt.PixelFormat.RGBA:
        assert int(y[2, 2, 2]) == 200 and int(y[2, 2, 0]) == 0  # the new scene


@pytest.fixture
def planned(monkeypatch):
    """The (key, plan) of every `OutputProgram.plan` call, in order."""
    plans = []
    orig = tprog.OutputProgram.plan

    def spy(self, pts, input_frames):
        out = orig(self, pts, input_frames)
        plans.append((self, input_frames, out))
        return out

    monkeypatch.setattr(tprog.OutputProgram, "plan", spy)
    return plans


def _direct(prog, input_frames, key, plan):
    """The structure's closure, built afresh, run straight on the frame's
    arguments (no static buffers)."""
    return prog._build(key, input_frames)(*prog._args(plan))


@pytest.mark.parametrize("scene", ["banner transition", "tiles grid"])
def test_static_buffer_program_equals_the_direct_closure(scene, planned):
    fmt = tt.PixelFormat.PLANAR_YUV420
    if scene == "tiles grid":
        tiles = comp.Tiles(children=[comp.Rescaler(child=comp.InputStream(input_id=f"input_{i}"))
                                     for i in range(4)],
                           background_color=RGBAColor(16, 16, 16), margin=4.0)
        steps = [(tiles, 0.0), (None, 0.1), (None, 0.2)]
    else:
        steps = [(_banner_scene(20.0), 0.0), (_banner_scene(120.0), 0.25), (None, 0.5),
                 (None, 0.75), (None, 1.0), (None, 1.1)]
    r = TorchRenderer(device="cpu")
    for i in range(4):
        r.register_input(f"input_{i}")
    for k, (s, pts) in enumerate(steps):
        if s is not None:
            r.update_scene("out", *from_reference((s, OUT)), fmt)
        got = r.render(_port_frames(pts, 4)).frames["out"].data
        prog, frames, (key, plan) = planned[-1]
        want = _direct(prog, frames, key, plan)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (scene, k)
    programs = list(r._programs["out"]._build_cache.values())
    if scene == "tiles grid":
        assert len(programs) == 1
        assert "_try_yuv_grid_program" in programs[0].fn.__qualname__
    else:  # the settled, the first animating and the animating structures
        assert len(programs) >= 2


def _random_frames(seed, n=4, w=96, h=54):
    rng = np.random.RandomState(seed)
    return {f"input_{i}": tt.Frame(
        data=(rng.randint(16, 235, (h, w), dtype=np.uint8),
              rng.randint(16, 240, (h // 2, w // 2), dtype=np.uint8),
              rng.randint(16, 240, (h // 2, w // 2), dtype=np.uint8)),
        format=tt.PixelFormat.PLANAR_YUV420, resolution=tt.Resolution(w, h), pts=0.0)
        for i in range(n)}


def test_an_output_is_never_written_again():
    r = TorchRenderer(device="cpu")
    for i in range(4):
        r.register_input(f"input_{i}")
    r.update_scene("out", *from_reference((_banner_scene(20.0), OUT)), tt.PixelFormat.RGBA)
    outs = [r.render(tt.FrameSet(pts=pts, frames=_random_frames(k))).frames["out"].data
            for k, pts in enumerate((0.0, 0.1, 0.2))]
    kept = outs[1].clone()
    outs.append(r.render(tt.FrameSet(pts=0.3, frames=_random_frames(3))).frames["out"].data)
    assert len(r._programs["out"]._build_cache) == 1  # frames 1-3 replay
    assert torch.equal(outs[1], kept)
    assert not torch.equal(outs[1], outs[2]) and not torch.equal(outs[2], outs[3])


def test_the_33rd_structure_evicts_the_oldest():
    """An RGBA input whose resolution changes every frame: a new structure
    each frame."""
    from smelter_tpu_torch.scene.scene_state import OutputScene, SceneState

    res = tt.Resolution(32, 18)
    root = from_reference(comp.View(background_color=RGBAColor(10, 10, 10),
                                     children=[comp.InputStream(input_id="input_0")]))
    node = SceneState().update_scene(OutputScene("out", root, res),
                                     text_measurer=None, image_store=None).node
    prog = tprog.OutputProgram(node, res, tt.PixelFormat.RGBA, device="cpu")
    keys = []
    for i in range(tprog.OutputProgram.MAX_CACHED_PROGRAMS + 1):
        w = 16 + 2 * i
        rgba = np.full((8, w, 4), 255, np.uint8)
        prog.render(0.0, {"input_0": tt.Frame(data=rgba, format=tt.PixelFormat.RGBA,
                                              resolution=tt.Resolution(w, 8), pts=0.0)})
        keys.append(list(prog._build_cache)[-1])
    assert len(set(keys)) == len(keys)
    assert list(prog._build_cache) == keys[1:]


def test_close_drains_a_running_build(gate):
    r = _async_renderer()
    fmt = tt.PixelFormat.RGBA
    r.update_scene("out", from_reference(_solid(RGBAColor(200, 0, 0))), from_reference(OUT), fmt)
    r.render(_port_frames(0.0))
    r.update_scene("out", from_reference(_banner_scene(40.0, n_inputs=1)), from_reference(OUT),
                   fmt)
    r.render(_port_frames(0.1))  # frozen: the build waits at the gate
    prog = r._programs["out"]
    assert prog._compiling and not prog._build_cache
    threading.Timer(0.3, gate.set).start()
    t0 = time.perf_counter()
    r.close()
    assert time.perf_counter() - t0 >= 0.25
    assert not [t for t in tprog._CAPTURE_THREADS if t.is_alive()]
    assert len(prog._build_cache) == 1 and not prog._compiling


def test_each_run_hold_and_device_constants_belong_to_a_build():
    counts = []
    made = []

    @cap.device_constant(maxsize=4)
    def const(n, device):
        made.append(n)
        return torch.full((n,), float(n), device=device)

    cap.each_run(lambda: counts.append("now"))
    shared = const(3, "cpu")
    assert const(3, "cpu") is shared and made == [3]

    def fn(x):
        cap.each_run(lambda: counts.append("run"))
        c = const(3, x.device)
        return x + cap.hold(c)

    program, out = cap.capture(fn, (torch.ones(3),), "cpu")
    # the build made its own constant and holds it; the shared one is untouched
    assert made == [3, 3] and program._scope.held[0] is not shared
    assert torch.equal(out, torch.full((3,), 4.0))
    assert torch.equal(program(torch.zeros(3)), torch.full((3,), 3.0))
    assert counts == ["now", "run", "run"]  # the CPU runs the closure each call
    with pytest.raises(ValueError):
        program(torch.zeros(4))
