"""The port's `bench_animations` tool (`smelter_tpu_torch/tools/
bench_animations.py`) against the reference's `tools/bench_animations.py`,
on the CPU at out 192x108, in 96x54, 4 frames a box animation:

  - the calls the reference script makes (recorded through a stand-in
    `Renderer`: no JAX render, no profiler) and the port's are the same
    scenes (through `interop.from_reference`, the positions scaled to the
    output as the tool scales them), inputs and pts, and the JSON lines hold
    the reference's keys plus "card";
  - every render of the port's run (the Tiles re-layout's 23, each box
    animation's 2 + 4) is within 1 u8 LSB of the reference `Renderer` on
    the same calls, with the harness's inputs;
  - over slide, spin and zoom, the port's program cache holds as many
    structure keys as the reference's jit cache, frame for frame.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import gzip
import importlib
import io
import json
import types

import jax
import numpy as np
import pytest
import torch

import harness
from smelter_tpu.core import types as jt
from smelter_tpu.render import renderer as jrenderer
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.tools import _inputs, bench_animations
from tests.test_torch_tools import IN, OUT, REF_IN, _max_lsb, load_reference

torch.set_num_threads(2)

ANIMATION_FRAMES = 4


class _Recorder:
    """A stand-in for the reference `Renderer`: records each call, renders
    nothing."""

    instances: list = []

    def __init__(self, *args, **kwargs):
        self.calls = []
        self._programs = {"out": types.SimpleNamespace(_jit_cache={})}
        _Recorder.instances.append(self)

    def register_input(self, input_id):
        self.calls.append(("register_input", input_id))

    def update_scene(self, output_id, root, resolution, fmt):
        self.calls.append(("update_scene", output_id, root, resolution, fmt))

    def render(self, frame_set):
        self.calls.append(("render", frame_set.pts, dict(frame_set.frames)))

    def close(self):
        pass


def _scaled_tree(node, out):
    """A component tree (of either package) with every AbsolutePosition
    scaled as `bench_animations.scaled` scales the tool's positions."""
    if isinstance(node, list):
        return [_scaled_tree(x, out) for x in node]
    if not dataclasses.is_dataclass(node) or isinstance(node, type):
        return node
    if type(node).__name__ == "AbsolutePosition":
        return bench_animations.scaled(node, out)
    changes = {f.name: _scaled_tree(getattr(node, f.name), out)
               for f in dataclasses.fields(node) if f.name in ("children", "position", "child")}
    return dataclasses.replace(node, **changes)


@pytest.fixture(scope="module")
def reference_animation_calls(tmp_path_factory):
    """The calls the reference's `bench_animations.main()` makes, one list
    per renderer, and the JSON lines it prints (no profiler, no frames)."""
    trace = tmp_path_factory.mktemp("trace") / "empty.trace.json.gz"
    with gzip.open(trace, "wt") as f:
        json.dump({"traceEvents": []}, f)
    _Recorder.instances = []
    with pytest.MonkeyPatch.context() as mp:
        module = load_reference("bench_animations", mp)
        mp.setattr(jrenderer, "Renderer", _Recorder)
        mp.setattr(harness, "make_test_input", lambda index, res, pts=0.0: (index, pts))
        mp.setattr(jax.profiler, "trace", lambda _dir: contextlib.nullcontext())
        mp.setattr(module, "glob", types.SimpleNamespace(glob=lambda *a, **k: [str(trace)]))
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            module.main()
    lines = [json.loads(line) for line in printed.getvalue().splitlines()]
    return [r.calls for r in _Recorder.instances], lines


@pytest.fixture(scope="module")
def port_animation_run():
    """The port's `bench_animations.main()` at 192x108 with a spy on its
    renderers: (every renderer's calls, each render's RGBA output, the
    printed lines)."""
    calls, outputs = [], []

    class Spy(bench_animations.Renderer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.calls, self.outputs = [], []
            calls.append(self.calls)
            outputs.append(self.outputs)

        def register_input(self, input_id):
            self.calls.append(("register_input", input_id))
            super().register_input(input_id)

        def update_scene(self, output_id, root, resolution, fmt):
            self.calls.append(("update_scene", output_id, root, resolution, fmt))
            super().update_scene(output_id, root, resolution, fmt)

        def render(self, frame_set):
            self.calls.append(("render", frame_set.pts, dict(frame_set.frames)))
            out = super().render(frame_set)
            self.outputs.append(out.frames["out"].data.numpy().copy())
            return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_animations, "Renderer", Spy)
        lines = bench_animations.main(["--device", "cpu", "--out", f"{OUT.width}x{OUT.height}",
                                       "--inres", f"{IN.width}x{IN.height}",
                                       "--frames", str(ANIMATION_FRAMES)])
    return calls, outputs, lines


def test_bench_animations_makes_the_reference_calls(reference_animation_calls,
                                                   port_animation_run):
    ref_calls, ref_lines = reference_animation_calls
    calls, _, lines = port_animation_run
    assert len(calls) == len(ref_calls) == 5
    for k, (mine, ref) in enumerate(zip(calls, ref_calls)):
        if k:  # the port's box animations time --frames frames, the reference's 30
            ref = ref[:len(ref) - 30 + ANIMATION_FRAMES]
        assert len(mine) == len(ref), f"renderer {k}"
        for m, r in zip(mine, ref):
            assert m[0] == r[0]
            if m[0] == "register_input":
                assert m[1] == r[1]
            elif m[0] == "update_scene":
                assert m[1] == r[1] and m[4].name == r[4].name
                assert (m[3].width, m[3].height) == (OUT.width, OUT.height)
                assert m[2] == _scaled_tree(from_reference(r[2]), OUT)
            else:
                assert m[1] == r[1] and list(m[2]) == list(r[2])
                for iid, (index, pts) in r[2].items():
                    want = _inputs.make_test_input(index, IN, pts)
                    assert m[2][iid].pts == pts
                    for got, plane in zip(m[2][iid].data, want.data):
                        np.testing.assert_array_equal(got, plane)
    # bench_animations.py:105-109 and 207-214, plus "card"
    assert [set(line) for line in lines] == [set(line) | {"card"} for line in ref_lines]
    assert [line["animation"] for line in lines] == [line["animation"] for line in ref_lines]
    assert [line["frames"] for line in lines] == [20] + [ANIMATION_FRAMES] * 4
    assert all(line["card"] is None for line in lines)


def test_bench_animations_frames_equal_the_reference(port_animation_run):
    """Every render of the tool's five renderers, replayed on the reference
    renderer with the reference's inputs at the same pts: <= 1 LSB."""
    calls, outputs, _ = port_animation_run
    worst = {}
    for k, (mine, outs) in enumerate(zip(calls, outputs)):
        jr = jrenderer.Renderer()
        got = iter(outs)
        try:
            for call in mine:
                if call[0] == "register_input":
                    jr.register_input(call[1])
                elif call[0] == "update_scene":
                    _, output_id, root, res, fmt = call
                    jr.update_scene(output_id, _reference_tree(root),
                                    jt.Resolution(res.width, res.height), jt.PixelFormat[fmt.name])
                else:
                    _, pts, frames = call
                    inputs = {iid: harness.make_test_input(int(iid.split("_")[-1]) if "_" in iid
                                                           else 0, REF_IN, pts)
                              for iid in frames}
                    ref = np.asarray(jr.render(jt.FrameSet(pts=pts, frames=inputs))
                                     .frames["out"].data)
                    worst[(k, pts)] = _max_lsb([ref], [next(got)])
        finally:
            jr.close()
    assert len(worst) == 23 + 4 * (2 + ANIMATION_FRAMES)
    assert max(worst.values()) <= 1, {key: v for key, v in worst.items() if v > 1}


def _reference_tree(node):
    """The port's component tree as the reference's objects, field by field
    (the inverse of `interop.from_reference` for scene components)."""
    if isinstance(node, (list, tuple)):
        return type(node)(_reference_tree(x) for x in node)
    cls = type(node)
    if not cls.__module__.startswith("smelter_tpu_torch."):
        return node
    module = importlib.import_module("smelter_tpu." + cls.__module__.split(".", 1)[1])
    target = getattr(module, cls.__qualname__)
    if isinstance(node, enum.Enum):
        return target[node.name]
    fields = dataclasses.fields(node)
    return target(**{f.name: _reference_tree(getattr(node, f.name)) for f in fields if f.init})


@pytest.mark.parametrize("name", ["slide_position", "spin_rotation", "zoom_size"])
def test_structure_keys_grow_as_the_reference(name):
    """A fault both packages share (ROADMAP Queue 3): the first frame of a
    transition still builds a static structure and the next frame the
    animating one. Frame for frame, the port's program cache holds as many
    structures as the reference's jit cache."""
    out = OUT
    pos0, pos1 = (bench_animations.scaled(p, out) for p in bench_animations.ANIMATIONS[name])
    steps = [(bench_animations.box_scene(pos0), 0.0),
             (bench_animations.box_scene(pos1, bench_animations.Transition(duration=4.0)), 0.2),
             (None, 0.3), (None, 0.4)]
    r, jr = bench_animations.Renderer(device="cpu"), jrenderer.Renderer()
    mine, ref = [], []
    try:
        r.register_input("cam")
        jr.register_input("cam")
        for scene, pts in steps:
            if scene is not None:
                r.update_scene("out", scene, out, bench_animations.PixelFormat.RGBA)
                jr.update_scene("out", _reference_tree(scene), jt.Resolution(out.width, out.height),
                                jt.PixelFormat.RGBA)
            r.render(bench_animations.FrameSet(
                pts=pts, frames={"cam": _inputs.make_test_input(0, IN, pts)}))
            jr.render(jt.FrameSet(pts=pts, frames={"cam": harness.make_test_input(0, REF_IN, pts)}))
            mine.append(len(r._programs["out"]._build_cache))
            ref.append(len(jr._programs["out"]._jit_cache))
    finally:
        r.close()
        jr.close()
    assert mine == ref == [1, 1, 2, 2]
