"""The port's soak tools (`smelter_tpu_torch/tools/soak_live.py`,
`soak_web.py`) against the reference's `tools/soak_live.py` and
`tools/soak_web.py`, and the pipeline's profiler setting, on the CPU:

  - a `soak_live` round of 2 s at 192x108 from 96x54 is CLEAN, with at
    least one structure update, each captured, and the tool needs a card
    unless given `--device cpu`;
  - the calls a round makes on its `Renderer` (recorded through a stand-in
    on both sides, with one stepped clock in place of `time.monotonic`) are
    the reference's: the same scenes (through `interop.from_reference`),
    inputs and pts;
  - every frame a round renders on the CPU at 192x108 (the clock waits for
    the background captures, so that each burst shows its scene) is within
    1 u8 LSB of the reference `Renderer` on the same calls;
  - `soak_web` runs pytest on `tests/test_torch_web.py` with the reference's
    flags, once a round, and exits 1 on a failed round;
  - a pipeline with only the reference's SMELTER_JAX_PROFILER_DIR writes its
    torch.profiler `trace.json` there; with both names set, the port's
    SMELTER_TORCH_PROFILER_DIR wins.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import chip_smoke
from smelter_tpu.core import types as jt
from smelter_tpu.render import renderer as jrenderer
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.render.program import _drain_background_compiles
from smelter_tpu_torch.tools import soak_live, soak_web
from tests.test_torch_tools import IN, OUT, _max_lsb, _reference_frame, load_reference
from tests.test_torch_tools_animations import _reference_tree

torch.set_num_threads(2)


class _Clock:
    """A stand-in for the `time` module of a soak: `monotonic()` steps by
    `step` seconds a call (after `on_tick`), `perf_counter` is the real
    one."""

    def __init__(self, step, on_tick=lambda: None):
        self.t, self.step, self.on_tick = 0.0, step, on_tick
        self.perf_counter = time.perf_counter

    def monotonic(self):
        self.on_tick()
        self.t += self.step
        return self.t


class _Recorder:
    """A stand-in for either package's `Renderer`: records each call,
    renders nothing (each render returns fresh planes)."""

    instances: list = []

    def __init__(self, *args, **kwargs):
        self.calls = []
        self._programs = {}
        _Recorder.instances.append(self)

    def register_input(self, input_id):
        self.calls.append(("register_input", input_id))

    def update_scene(self, output_id, root, resolution, fmt):
        self.calls.append(("update_scene", output_id, root, resolution, fmt))
        self._programs[output_id] = types.SimpleNamespace(_build_cache={})

    def render(self, frame_set):
        self.calls.append(("render", frame_set.pts, dict(frame_set.frames)))
        return types.SimpleNamespace(frames={"out": types.SimpleNamespace(
            data=(torch.zeros(1, dtype=torch.uint8),))})

    def close(self):
        pass


def test_soak_live_round_is_clean_on_the_cpu(monkeypatch, capsys):
    rounds = []
    run_round = soak_live.run_round
    monkeypatch.setattr(soak_live, "run_round",
                        lambda *a, **k: rounds.append(run_round(*a, **k)) or rounds[-1])
    code = soak_live.main(["--rounds", "1", "--seconds", "2", "--device", "cpu",
                           "--out", f"{OUT.width}x{OUT.height}",
                           "--inres", f"{IN.width}x{IN.height}"])
    lines = capsys.readouterr().out.splitlines()
    assert code == 0
    assert lines[0].startswith("round 1/1: CLEAN (") and lines[-1] == "soak result: 1/1 clean"
    (info,) = rounds
    assert info["updates"] >= 1 and info["frames"] == sum(info["frames_by_update"])
    assert all(len(c) >= 1 for c in info["captures"])  # each update captured its program
    assert all(fz <= n for fz, n in zip(info["frozen_by_update"], info["frames_by_update"]))
    assert [p.shape for p in info["last"]["planes"]] == [
        (OUT.height, OUT.width), (OUT.height // 2, OUT.width // 2),
        (OUT.height // 2, OUT.width // 2)]


def test_soak_live_needs_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        soak_live.main(["--rounds", "1", "--seconds", "1"])


def test_soak_live_makes_the_reference_calls(monkeypatch):
    """At the reference's own sizes (1280x720 from 640x360, seconds 8) and
    one clock of 0.25 s steps: the same register, update and render calls,
    scene for scene, plane for plane and pts for pts."""
    reference = load_reference("soak_live", monkeypatch)
    monkeypatch.setattr(jrenderer, "Renderer", _Recorder)
    monkeypatch.setattr(reference, "time", _Clock(0.25))
    _Recorder.instances = []
    assert reference.run_round(3, 8.0) == {"round": 3, "frames": 33, "updates": 3}
    (ref,) = _Recorder.instances

    monkeypatch.setattr(soak_live, "Renderer", _Recorder)
    monkeypatch.setattr(soak_live, "time", _Clock(0.25))
    _Recorder.instances = []
    info = soak_live.run_round(3, 8.0, "cpu")
    (mine,) = _Recorder.instances
    assert (info["frames"], info["updates"]) == (33, 3)
    assert info["frozen_by_update"] == [0, 0, 0]

    assert [c[0] for c in mine.calls] == [c[0] for c in ref.calls]
    assert [c[1] for c in mine.calls if c[0] == "register_input"] == ["cam_0", "cam_1"]
    for m, r in zip(mine.calls, ref.calls):
        if m[0] == "update_scene":
            assert m[1] == r[1] == "out" and m[4].name == r[4].name == "PLANAR_YUV420"
            assert (m[3].width, m[3].height) == (r[3].width, r[3].height) == (1280, 720)
            assert m[2] == from_reference(r[2])
        elif m[0] == "render":
            assert m[1] == r[1]
            assert list(m[2]) == list(r[2]) == ["cam_0", "cam_1"]
            for iid in m[2]:
                got, want = m[2][iid], r[2][iid]
                assert got.pts == want.pts and got.format.name == want.format.name
                assert (got.resolution.width, got.resolution.height) == (640, 360)
                for name, a, b in zip("yuv", got.data, want.data):
                    np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"{iid} {name}")


def test_soak_live_frames_equal_the_reference(monkeypatch):
    """A round at 192x108 whose clock waits for the background captures:
    each burst re-emits the last frame once, then shows its scene. Every
    frame of a scene shown is within 1 LSB of the reference `Renderer` given
    the same scene, inputs and pts."""
    calls, outputs = [], []

    class Spy(soak_live.Renderer):
        def update_scene(self, output_id, root, resolution, fmt):
            calls.append(("update_scene", output_id, root, resolution, fmt))
            super().update_scene(output_id, root, resolution, fmt)

        def render(self, frame_set):
            out = super().render(frame_set)
            calls.append(("render", frame_set.pts, dict(frame_set.frames)))
            outputs.append(out.frames["out"].data)
            return out

    monkeypatch.setattr(soak_live, "Renderer", Spy)
    monkeypatch.setattr(soak_live, "time", _Clock(0.5, _drain_background_compiles))
    info = soak_live.run_round(1, 8.0, "cpu", OUT, IN)
    assert info["updates"] == 2 and info["frames_by_update"] == [5, 5]
    assert info["frozen_by_update"] == [1, 1]

    jr = jrenderer.Renderer()
    compared = 0
    try:
        jr.register_input("cam_0")
        jr.register_input("cam_1")
        got = iter(outputs)
        previous = None
        for call in calls:
            if call[0] == "update_scene":
                _, output_id, root, res, fmt = call
                jr.update_scene(output_id, _reference_tree(root),
                                jt.Resolution(res.width, res.height), jt.PixelFormat[fmt.name])
                continue
            _, pts, frames = call
            planes = next(got)
            if planes is previous:  # the freeze-frame: the last frame again
                continue
            previous = planes
            ref = jr.render(jt.FrameSet(pts=pts, frames={
                iid: _reference_frame(f) for iid, f in frames.items()})).frames["out"].data
            assert _max_lsb([np.asarray(p) for p in ref], [p.numpy() for p in planes]) <= 1, pts
            compared += 1
    finally:
        jr.close()
    assert compared == 1 + 2 * 4


def test_soak_web_runs_the_port_web_tests(monkeypatch, capsys):
    runs = []

    def fake_run(cmd, **kwargs):
        runs.append((cmd, kwargs))
        return subprocess.CompletedProcess(cmd, 0 if len(runs) < 3 else 1, "out", "err")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert soak_web.main(["--rounds", "2"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "soak clean: 2/2"
    # the reference's command and flags (tools/soak_web.py:22-25), on the port's module
    assert [cmd for cmd, _ in runs] == [
        [sys.executable, "-m", "pytest", "tests/test_torch_web.py", "-q", "-p",
         "no:cacheprovider"]] * 2
    assert all(kw == {"capture_output": True, "text": True} for _, kw in runs)
    assert soak_web.main(["--rounds", "3"]) == 1  # its first round fails
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("round 1/3: FAIL") and "soak clean" not in "".join(lines)


@pytest.mark.parametrize("names", [("SMELTER_JAX_PROFILER_DIR",),
                                   ("SMELTER_JAX_PROFILER_DIR", "SMELTER_TORCH_PROFILER_DIR")])
def test_pipeline_profiler_setting(names, tmp_path, monkeypatch):
    for name in ("SMELTER_JAX_PROFILER_DIR", "SMELTER_TORCH_PROFILER_DIR"):
        monkeypatch.delenv(name, raising=False)
    for name in names:
        monkeypatch.setenv(name, str(tmp_path / name))
    assert chip_smoke.profiled_offline_run("cpu", 64, 36, n_frames=3) >= 1
    written = sorted(p.parent.name for p in tmp_path.glob("*/trace.json"))
    # the port's own name wins where both are set
    assert written == [names[-1]]
    assert os.path.getsize(tmp_path / names[-1] / "trace.json") > 0
