"""The port's measurement tools (`smelter_tpu_torch/tools/`), the
counterparts of the reference repo's `tools/bench_*.py`, on the CPU at small
sizes, against the reference's scripts (loaded from `tools/` by path, with
`SMELTER_XLA_CACHE_DIR` empty so that no persistent JAX cache is opened):

  - `_inputs.make_test_input` is byte-equal to `tests/harness.make_test_input`
    and `seeded_frame_sets` to the reference `bench_scenes.py`'s frames;
  - `bench_scenes`: each of the six scenes equals the reference's
    `scene_defs()` scene through `interop.from_reference`, and one frame of
    each, rendered by the reference's `Renderer` and the port's from the
    same inputs, is within 1 u8 LSB (at 640x360: at 192x108 the rotated
    scenes lie off the canvas);
  - `bench_overlap.make_compose` is within 1 LSB of the reference's
    compose, rebuilt from `smelter_tpu.ops`;
  - every tool's JSON line holds every key of the reference's line (and
    "card", null on the CPU); `bench_latency` gives samples in a 2 s run;
  - every tool raises without a card unless given `--device cpu`.
`bench_animations` is held to the reference in
`tests/test_torch_tools_animations.py`, the codec tools (`bench_offline`,
`bench_streams`, `bench_overlap`'s codec stages) in
`tests/test_torch_tools_codecs.py`, so that each file runs on its own
worker.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import harness
from smelter_tpu.core import types as jt
from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.ops import resample as jresample
from smelter_tpu.render import renderer as jrenderer
from smelter_tpu_torch.core.types import FrameSet, Resolution
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.tools import (
    _inputs,
    bench_flagship_ops,
    bench_latency,
    bench_overlap,
    bench_scenes,
)

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT, IN = Resolution(192, 108), Resolution(96, 54)
REF_IN = jt.Resolution(IN.width, IN.height)
SCENES_OUT = Resolution(640, 360)

TOOLS = ("bench_scenes", "bench_animations", "bench_latency", "bench_flagship_ops",
         "bench_overlap", "bench_offline", "bench_streams")


def load_reference(name: str, monkeypatch):
    """The reference's `tools/<name>.py` as a module, loaded by path with an
    empty SMELTER_XLA_CACHE_DIR; the scripts' additions to sys.path are
    undone by `monkeypatch`."""
    monkeypatch.setenv("SMELTER_XLA_CACHE_DIR", "")
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _reference_frame(frame) -> jt.Frame:
    return jt.Frame(data=tuple(frame.data), format=jt.PixelFormat[frame.format.name],
                    resolution=jt.Resolution(frame.resolution.width, frame.resolution.height),
                    pts=frame.pts)


def _max_lsb(ref, got) -> int:
    return max(int(np.abs(np.asarray(r).astype(np.int32) - np.asarray(g).astype(np.int32)).max())
               for r, g in zip(ref, got))


# -- inputs ---------------------------------------------------------------------


@pytest.mark.parametrize("pts", [0.0, 0.7])
def test_make_test_input_equals_the_harness(pts):
    for index in range(8):
        ref = harness.make_test_input(index, REF_IN, pts)
        got = _inputs.make_test_input(index, IN, pts)
        assert got.pts == ref.pts == pts and got.format.name == ref.format.name
        for name, r, g in zip("yuv", ref.data, got.data):
            np.testing.assert_array_equal(g, r, err_msg=f"input {index} plane {name}")


def test_seeded_frame_sets_equal_the_reference_frames():
    """`bench_scenes.py:77-90`: one RandomState(7), every frame of the first
    set drawn before the second, RGBA -> planar YUV420."""
    n = 3
    rng = np.random.RandomState(7)
    want = []
    for _ in range(2 * n):
        rgba = rng.randint(0, 255, (IN.height, IN.width, 4), np.uint8)
        rgba[..., 3] = 255
        want.append([np.asarray(p) for p in jcc.rgba_to_planar_yuv420(
            rgba.astype(np.float32) / 255.0)])
    first, second = _inputs.seeded_frame_sets(n, IN)
    got = [first[f"cam_{i}"] for i in range(n)] + [second[f"cam_{i}"] for i in range(n)]
    for k, (w, g) in enumerate(zip(want, got)):
        for name, r, p in zip("yuv", w, g.data):
            np.testing.assert_array_equal(p, r, err_msg=f"frame {k} plane {name}")


# -- bench_scenes ---------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_scenes():
    with pytest.MonkeyPatch.context() as mp:
        return load_reference("bench_scenes", mp).scene_defs()


@pytest.mark.parametrize("name", list(bench_scenes.scene_defs()))
def test_bench_scenes_scene_and_frame_equal_the_reference(name, reference_scenes):
    make, n = bench_scenes.scene_defs()[name]
    ref_make, ref_n = reference_scenes[name]
    assert n == ref_n
    assert make() == from_reference(ref_make())

    frames, _ = _inputs.seeded_frame_sets(n, IN)
    jr = jrenderer.Renderer()
    for i in range(n):
        jr.register_input(f"cam_{i}")
    jr.update_scene("out", ref_make(), jt.Resolution(SCENES_OUT.width, SCENES_OUT.height),
                    jt.PixelFormat.PLANAR_YUV420)
    ref = jr.render(jt.FrameSet(pts=0.0, frames={k: _reference_frame(f)
                                                 for k, f in frames.items()}))
    r = bench_scenes.scene_renderer(make, n, SCENES_OUT, "cpu")
    try:
        got = r.render(FrameSet(pts=0.0, frames=frames))
    finally:
        r.close()
        jr.close()
    ref_planes = ref.frames["out"].data
    got_planes = [p.numpy() for p in got.frames["out"].data]
    assert [p.shape for p in got_planes] == [np.asarray(p).shape for p in ref_planes]
    assert _max_lsb(ref_planes, got_planes) <= 1


def test_bench_scenes_line_has_the_reference_keys(capsys):
    results = bench_scenes.main(["--device", "cpu", "--scene", "rounded", "--iters", "3",
                                 "--out", f"{OUT.width}x{OUT.height}",
                                 "--inres", f"{IN.width}x{IN.height}", "--ops"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == json.loads(json.dumps(results)) and len(results) == 1
    res = results[0]
    # bench_scenes.py:140-146
    assert set(res) == {"scene", "device_p50_ms", "device_p95_ms", "frames",
                        "top_ops_ms_per_frame", "card"}
    assert res["scene"] == "rounded" and res["frames"] == 3 and res["card"] is None
    assert 0 < res["device_p50_ms"] <= res["device_p95_ms"]
    assert 0 < len(res["top_ops_ms_per_frame"]) <= 12
    assert all(len(name) <= 70 and ms >= 0 for name, ms in res["top_ops_ms_per_frame"])


# -- bench_overlap --------------------------------------------------------------


def test_make_compose_equals_the_reference_compose():
    """`tools/bench_overlap.py:62-71`: N YUV inputs -> RGBA -> bilinear
    tiles of a grid -> YUV420."""
    n, w, h = 4, OUT.width, OUT.height
    cols = int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    tw, th = w // cols, h // rows

    def reference(ys, us, vs):
        grid = jnp.zeros((h, w, 4), jnp.float32)
        for i in range(n):
            rgba = jcc.planar_yuv_to_rgba(ys[i], us[i], vs[i])
            r, c = divmod(i, cols)
            grid = grid.at[r * th:(r + 1) * th, c * tw:(c + 1) * tw].set(
                jresample.resize_bilinear(rgba, th, tw))
        return jcc.rgba_to_planar_yuv420(grid)

    rng = np.random.default_rng(0)
    planes = (rng.integers(16, 235, (n, IN.height, IN.width), np.uint8),
              rng.integers(16, 240, (n, IN.height // 2, IN.width // 2), np.uint8),
              rng.integers(16, 240, (n, IN.height // 2, IN.width // 2), np.uint8))
    ref = [np.asarray(p) for p in jax.jit(reference)(*planes)]
    got = [p.numpy() for p in bench_overlap.make_compose(n, w, h, "cpu")(
        *(torch.from_numpy(p) for p in planes))]
    assert [p.shape for p in got] == [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    assert _max_lsb(ref, got) <= 1


def test_bench_overlap_line_has_the_reference_keys(capsys):
    res = bench_overlap.main(["--device", "cpu", "--width", str(OUT.width), "--height",
                              str(OUT.height), "--frames", "6", "--no-codec"])
    assert json.loads(capsys.readouterr().out) == res
    # bench_overlap.py:156-167
    assert set(res) == {"metric", "value", "unit", "serial_fps", "pipelined_fps", "inputs",
                        "resolution", "depth", "codec_stages", "device", "card"}
    assert res["metric"] == "overlap_speedup" and res["codec_stages"] is False
    assert res["device"] == "cpu" and res["card"] is None and res["inputs"] == 4
    assert res["serial_fps"] > 0 and res["pipelined_fps"] > 0


# -- bench_flagship_ops ---------------------------------------------------------


@pytest.mark.parametrize("general", [False, True])
def test_bench_flagship_ops_line_has_the_reference_keys(general):
    # the general scene's layout needs inputs of 192x108 or more
    res = bench_flagship_ops.run(4, general, "cpu", in_res=Resolution(192, 108),
                                 out_res=Resolution(384, 216), iters=3)
    # bench_flagship_ops.py:90-98
    assert set(res) == {"program", "device_p50_ms", "frames", "top_ops_ms_per_frame", "card"}
    assert res["program"] == ("general_4k" if general else "flagship_grid")
    assert res["frames"] == 3 and res["card"] is None and res["device_p50_ms"] > 0
    assert 0 < len(res["top_ops_ms_per_frame"]) <= 32


# -- bench_latency --------------------------------------------------------------


def test_bench_latency_gives_samples_in_two_seconds(capsys):
    res = bench_latency.main(["--device", "cpu", "--width", str(OUT.width), "--height",
                              str(OUT.height), "--seconds", "2"])
    assert json.loads(capsys.readouterr().out) == res
    # bench_latency.py:152-163
    assert set(res) == {"metric", "value", "unit", "p50_ms", "p95_ms", "p99_ms", "samples",
                        "fps", "resolution", "buffer_ms", "card"}
    assert res["samples"] > 0 and res["card"] is None
    assert 0 < res["p50_ms"] <= res["p95_ms"] <= res["p99_ms"]


# -- every tool -----------------------------------------------------------------


@pytest.mark.parametrize("tool", TOOLS)
def test_tool_needs_a_card_unless_given_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here: the tool would run on it")
    module = importlib.import_module(f"smelter_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        module.main([])
