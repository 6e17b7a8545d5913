"""The port's Pipeline (`smelter_tpu_torch.pipeline`) against the JAX
package's, on the CPU (`device="cpu"`), at small sizes.

  - An offline run (ahead-of-time processing, never-drop) through both
    packages: 3 numpy-seeded raw inputs at 192x108 (audio on two), raw video
    and audio out at 384x216, a scene update with a transition scheduled at
    0.5 s, and an input unregistered at 1.2 s. The two runs must deliver the
    same output pts (relative to the queue's start) and frame count, planes
    within 1 u8 LSB, the same mixed audio, and the same events per entity.
  - `_frame_to_planes` on tensor and numpy planes; a yuv444p encoder refused
    at `register_output` (output format not ported: ROADMAP Queue 1 item 1).
  - An MP4 -> MP4 run through both packages, the decoded frames compared at
    the harness tolerance.

Each package's pipeline runs once per module (fixtures)."""

from __future__ import annotations

import importlib
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.harness import ALLOWED_ERROR
from tests.test_pipeline import _decode_output, _make_source_mp4

torch.set_num_threads(2)

REF, PORT = "smelter_tpu", "smelter_tpu_torch"
FPS = 30
N_FRAMES = 60  # 2 s per input
IN_W, IN_H = 192, 108
OUT_W, OUT_H = 384, 216
AUDIO_CHUNK = 960  # 20 ms at 48 kHz
TONES = {"in_0": 440.0, "in_1": 660.0}  # in_2 carries no audio


def _pkg(name: str) -> SimpleNamespace:
    mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
    return SimpleNamespace(
        types=mod("core.types"), comp=mod("scene.components"),
        layout=mod("scene.layout_types"), pipeline=mod("pipeline"),
        input=mod("pipeline.input"), mixer=mod("audio.mixer"),
        channels=mod("utils.channels"),
    )


def _new_pipeline(pkg: SimpleNamespace, name: str):
    opts = pkg.pipeline.PipelineOptions(
        output_framerate=pkg.types.Framerate(FPS),
        ahead_of_time_processing=True, never_drop_output_frames=True)
    if name == PORT:
        return pkg.pipeline.Pipeline(opts, device="cpu")
    return pkg.pipeline.Pipeline(opts)


def _scene(pkg: SimpleNamespace, stage: int):
    """A Tiles grid of the three inputs under a bordered, shadowed box that
    moves across the canvas in a 0.5 s transition after the update."""
    t, comp = pkg.types, pkg.comp
    box = comp.View(
        id="box",
        position=comp.AbsolutePosition(width=120.0, height=60.0, top=(20.0, 130.0)[stage],
                                       left=(24.0, 240.0)[stage]),
        background_color=t.RGBAColor(230, 40, 40, 220),
        border_radius=pkg.layout.BorderRadius(10.0, 10.0, 10.0, 10.0),
        border_width=3.0, border_color=t.RGBAColor(255, 255, 255, 255),
        box_shadow=[pkg.layout.BoxShadow(blur_radius=8.0, color=t.RGBAColor(0, 0, 0, 160))],
        transition=comp.Transition(duration=0.5))
    tiles = comp.Tiles(background_color=t.RGBAColor(16, 16, 16), margin=4.0,
                       children=[comp.InputStream(input_id=f"in_{i}") for i in range(3)])
    return comp.View(background_color=t.RGBAColor(0, 0, 0), children=[tiles, box])


def _input_frames(seed: int):
    rng = np.random.RandomState(seed)
    y = rng.randint(16, 235, (N_FRAMES, IN_H, IN_W), dtype=np.uint8)
    u = rng.randint(16, 240, (N_FRAMES, IN_H // 2, IN_W // 2), dtype=np.uint8)
    v = rng.randint(16, 240, (N_FRAMES, IN_H // 2, IN_W // 2), dtype=np.uint8)
    return y, u, v


class Delivered:
    """Counts the frames the sink has delivered. `barrier(n)` is a queue
    event that waits for the n-th: scheduled at the pts of a scene update
    or an unregister, just before it, it holds the queue until the renderer
    thread has caught up, so that the update lands between the same two
    renders in every run (the renderer thread may otherwise work up to two
    frames behind the queue when the queue runs the event)."""

    def __init__(self) -> None:
        self.count = 0
        self.cond = threading.Condition()

    def add(self) -> None:
        with self.cond:
            self.count += 1
            self.cond.notify_all()

    def barrier(self, n: int):
        def wait() -> None:
            with self.cond:
                self.cond.wait_for(lambda: self.count >= n, timeout=60)

        return wait


def input_pts(k: int) -> float:
    """Input frame k's pts: a microsecond before k / FPS. The queue maps an
    output pts to input time as (pts + start) - start, which rounds below
    k / FPS for some start times, and would then take frame k - 1 (in both
    packages); a frame a microsecond early is taken either way."""
    return max(k / FPS - 1e-6, 0.0)


def _feed_video(pkg, src, seed: int) -> None:
    """Push 2 s of video to one input, then close the channel. A send
    refused because the channel closed (the input was unregistered) ends
    the feed."""
    t = pkg.types
    y, u, v = _input_frames(seed)
    try:
        for k in range(N_FRAMES):
            src.video.send(t.Frame(data=(y[k], u[k], v[k]), format=t.PixelFormat.PLANAR_YUV420,
                                   resolution=t.Resolution(IN_W, IN_H), pts=input_pts(k)))
    except pkg.channels.Closed:
        return
    src.video.close()


def _feed_audio(pkg, src, hz: float) -> None:
    """Push 2 s of a stereo tone to one input in 20 ms chunks, then close
    the channel (or stop where it was closed: the queue may leave the last
    chunks unread)."""
    try:
        for chunk in range(int(N_FRAMES / FPS * 48000) // AUDIO_CHUNK):
            n = np.arange(chunk * AUDIO_CHUNK, (chunk + 1) * AUDIO_CHUNK)
            tone = 0.3 * np.sin(2 * np.pi * hz * n / 48000.0)
            src.audio.send(pkg.types.AudioSamples(np.stack([tone, tone], 1),
                                                  chunk * AUDIO_CHUNK / 48000))
    except pkg.channels.Closed:
        return
    src.audio.close()


def _close(src) -> None:
    src.video.close()
    if src.audio is not None:
        src.audio.close()


def _offline_run(name: str) -> dict:
    pkg = _pkg(name)
    pipeline = _new_pipeline(pkg, name)
    pl = pkg.pipeline
    sources = {}
    for i in range(3):
        iid = f"in_{i}"
        sources[iid] = pkg.input.RawDataInput(has_video=True, has_audio=iid in TONES)
        pipeline.register_input(iid, sources[iid],
                                pl.RegisterInputOptions(required=True, offset=0.0))
    sink = pl.RawDataOutputSink()
    mixer = pkg.mixer
    pipeline.register_output(
        "out", sink,
        video=pl.OutputVideoOptions(
            resolution=pkg.types.Resolution(OUT_W, OUT_H),
            encoder=pl.VideoEncoderOptions(codec="raw"), initial_root=_scene(pkg, 0),
            end_condition=pl.EndCondition(all_inputs=True)),
        audio=pl.OutputAudioOptions(
            encoder=pl.AudioEncoderOptions(codec="raw"),
            initial_mixer_config=mixer.AudioMixerConfig(inputs=[
                mixer.AudioMixerInputConfig("in_0", volume=1.0),
                mixer.AudioMixerInputConfig("in_1", volume=0.5)]),
            end_condition=pl.EndCondition(all_inputs=True)))
    delivered = Delivered()
    # frames 0..15 have pts <= 0.5 s, frames 0..36 pts <= 1.2 s
    pipeline.queue.schedule_event(0.5, delivered.barrier(16))
    pipeline.update_output("out", root=_scene(pkg, 1), schedule_time=0.5)
    pipeline.queue.schedule_event(1.2, delivered.barrier(37))
    pipeline.unregister_input("in_2", schedule_time=1.2)
    pipeline.start()
    feeders = [threading.Thread(target=_feed_video, args=(pkg, src, seed), daemon=True)
               for seed, src in enumerate(sources.values())]
    feeders += [threading.Thread(target=_feed_audio, args=(pkg, sources[iid], hz),
                                 daemon=True) for iid, hz in TONES.items()]
    for f in feeders:
        f.start()
    video, audio = [], []

    def drain(channel, into, on_item=None):
        while True:
            try:
                into.append(channel.recv(timeout=60))
            except (pkg.channels.Closed, TimeoutError):
                return
            if on_item is not None:
                on_item()

    audio_thread = threading.Thread(target=drain, args=(sink.audio, audio), daemon=True)
    audio_thread.start()
    drain(sink.video, video, delivered.add)
    audio_thread.join(timeout=60)
    pipeline.wait_for_outputs_done(timeout=60)
    start = pipeline.queue.start_pts
    # the unregistered input's feeder waits on a channel nobody reads
    for src in sources.values():
        _close(src)
    for f in feeders:
        f.join(timeout=10)
    pipeline.close()
    assert not audio_thread.is_alive() and not any(f.is_alive() for f in feeders)
    return dict(
        pts=[round(f.pts - start, 6) for f in video],
        planes=[tuple(f.data) for f in video],
        audio_pts=[round(pts - start, 6) for _, pts in audio],
        audio=[np.asarray(s) for s, _ in audio],
        events=[(e.kind, e.entity_id) for e in pipeline.events.history()],
    )


@pytest.fixture(scope="module")
def offline_runs():
    return _offline_run(REF), _offline_run(PORT)


def test_offline_run_delivers_the_same_frames(offline_runs):
    ref, port = offline_runs
    assert abs(len(ref["pts"]) - N_FRAMES) <= 1
    assert port["pts"] == ref["pts"]
    for k, (a, b) in enumerate(zip(ref["planes"], port["planes"])):
        for pa, pb in zip(a, b):
            assert isinstance(pb, np.ndarray) and pb.dtype == np.uint8
            assert pb.shape == np.asarray(pa).shape
            diff = np.abs(np.asarray(pa).astype(np.int32) - pb.astype(np.int32))
            assert int(diff.max()) <= 1, f"frame {k}: {int(diff.max())} LSB"


def test_offline_run_frames_do_not_change_after_delivery(offline_runs):
    """Every frame the port delivered differs from the next (the inputs are
    random per frame), so a buffer reused after delivery would show as two
    equal frames."""
    _, port = offline_runs
    ys = [p[0] for p in port["planes"]]
    assert all(not np.array_equal(a, b) for a, b in zip(ys, ys[1:]))


def test_offline_run_mixes_the_same_audio(offline_runs):
    ref, port = offline_runs
    assert len(ref["audio"]) >= 90
    assert port["audio_pts"] == ref["audio_pts"]
    for a, b in zip(ref["audio"], port["audio"]):
        np.testing.assert_array_equal(a, b)


def test_offline_run_emits_the_same_events(offline_runs):
    ref, port = offline_runs
    assert ("OUTPUT_DONE", "out") in ref["events"]
    assert not any(kind == "OUTPUT_ERROR" for kind, _ in port["events"])

    def per_entity(events):
        out = {}
        for kind, entity in events:
            out.setdefault(entity, []).append(kind)
        return out

    # the queue, the output threads and the scheduled events emit from
    # their own threads: the order within each entity is what is fixed
    assert per_entity(port["events"]) == per_entity(ref["events"])
    assert sorted(port["events"]) == sorted(ref["events"])


@pytest.mark.parametrize("fmt", ["PLANAR_YUV420", "RGBA"])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_frame_to_planes_matches_the_reference(fmt, as_tensor):
    from smelter_tpu.pipeline.output import _frame_to_planes as ref_planes
    from smelter_tpu.core import types as rt

    from smelter_tpu_torch.core import types as pt
    from smelter_tpu_torch.pipeline.output import _frame_to_planes

    rng = np.random.RandomState(7)
    h, w = 36, 64
    if fmt == "RGBA":
        data = rng.randint(0, 256, (h, w, 4), dtype=np.uint8)
    else:
        data = (rng.randint(0, 256, (h, w), dtype=np.uint8),
                rng.randint(0, 256, (h // 2, w // 2), dtype=np.uint8),
                rng.randint(0, 256, (h // 2, w // 2), dtype=np.uint8))
    port_data = data
    if as_tensor:  # planes as the renderer returns them (CPU tensors here)
        port_data = (torch.from_numpy(data) if fmt == "RGBA"
                     else tuple(torch.from_numpy(p) for p in data))
    ref = ref_planes(rt.Frame(data=data, format=rt.PixelFormat[fmt],
                              resolution=rt.Resolution(w, h), pts=0.0), rt.Resolution(w, h))
    got = _frame_to_planes(pt.Frame(data=port_data, format=pt.PixelFormat[fmt],
                                    resolution=pt.Resolution(w, h), pts=0.0), pt.Resolution(w, h))
    for a, b in zip(ref, got):
        assert isinstance(b, np.ndarray) and b.dtype == np.uint8
        diff = np.abs(np.asarray(a).astype(np.int32) - b.astype(np.int32))
        assert int(diff.max()) <= 1


def test_yuv444_encoder_output_is_not_ported():
    pkg = _pkg(PORT)
    pl = pkg.pipeline
    pipeline = _new_pipeline(pkg, PORT)
    try:
        pipeline.register_input("cam", pkg.input.RawDataInput(has_video=True, has_audio=False),
                                pl.RegisterInputOptions(required=True, offset=0.0))
        with pytest.raises(NotImplementedError, match="item 1"):
            pipeline.register_output(
                "out", pl.EncodedDataOutputSink(),
                video=pl.OutputVideoOptions(
                    resolution=pkg.types.Resolution(128, 96),
                    encoder=pl.VideoEncoderOptions(codec="h264", pixel_format="yuv444p"),
                    initial_root=pkg.comp.Rescaler(child=pkg.comp.InputStream(input_id="cam"))))
        assert "out" not in pipeline._outputs
    finally:
        pipeline.close()


def _mp4_run(name: str, tmp: str, src_a: str, src_b: str):
    pkg = _pkg(name)
    pl, t, comp = pkg.pipeline, pkg.types, pkg.comp
    pipeline = _new_pipeline(pkg, name)
    out_path = f"{tmp}/out_{name}.mp4"
    scene = comp.View(background_color=t.RGBAColor(0, 0, 0, 255), direction="row", children=[
        comp.Rescaler(child=comp.InputStream(input_id="in_a")),
        comp.Rescaler(child=comp.InputStream(input_id="in_b"))])
    opts = pl.RegisterInputOptions(required=True, offset=0.0)
    pipeline.register_input("in_a", pl.Mp4Input(pl.Mp4InputOptions(path=src_a)), opts)
    pipeline.register_input("in_b", pl.Mp4Input(pl.Mp4InputOptions(path=src_b)), opts)
    pipeline.register_output(
        "out", pl.Mp4OutputSink(out_path),
        video=pl.OutputVideoOptions(
            resolution=t.Resolution(640, 240),
            encoder=pl.VideoEncoderOptions(codec="h264", preset="ultrafast"),
            initial_root=scene, end_condition=pl.EndCondition(all_inputs=True)),
        audio=pl.OutputAudioOptions(
            encoder=pl.AudioEncoderOptions(codec="aac"),
            initial_mixer_config=pkg.mixer.AudioMixerConfig(inputs=[
                pkg.mixer.AudioMixerInputConfig("in_a"), pkg.mixer.AudioMixerInputConfig("in_b")]),
            end_condition=pl.EndCondition(all_inputs=True)))
    pipeline.start()
    deadline = time.time() + 300
    while ("OUTPUT_DONE", "out") not in {(e.kind, e.entity_id)
                                         for e in pipeline.events.history()}:
        assert time.time() < deadline, "OUTPUT_DONE not observed"
        time.sleep(0.1)
    pipeline.close()
    return _decode_output(out_path)


def test_mp4_to_mp4_matches_the_reference(tmp_path):
    src_a, src_b = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    _make_source_mp4(src_a, "red", 440.0)
    _make_source_mp4(src_b, "blue", 880.0)
    ref_frames, ref_audio, ref_infos = _mp4_run(REF, str(tmp_path), src_a, src_b)
    frames, audio, infos = _mp4_run(PORT, str(tmp_path), src_a, src_b)
    # whether the last frame makes it depends on when the inputs' ends
    # reach the queue, in either package (tests/test_pipeline.py allows 1)
    assert abs(len(frames) - 60) <= 1 and abs(len(ref_frames) - 60) <= 1
    assert (infos["video"].width, infos["video"].height) == (640, 240)
    for a, b in zip(ref_frames, frames):
        for pa, pb in zip(a[:3], b[:3]):
            assert pa.shape == pb.shape
            err = np.abs(pa.astype(np.float64) - pb.astype(np.float64)).mean()
            assert err <= ALLOWED_ERROR, err
    assert abs(audio.shape[0] - ref_audio.shape[0]) <= 2048 and audio.shape[1] == 2
