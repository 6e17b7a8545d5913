"""The port's side channel (`smelter_tpu_torch.pipeline.side_channel`)
against the reference's, on the CPU: the flow of `tests/test_side_channel.py`
through each package's server, consumed with the SDK's readers
(`smelter_tpu.sdk`, a client that loads no JAX).

Tolerances: the serialised frame and audio messages are byte-equal; the
RGBA frames and PCM batches that the SDK reads from the port's server are
byte-equal to the reference's, matched by pts over what both runs
delivered, and each run meets the reference test's bounds (>= 30 frames of
320x240 red, > 40000 samples at 48 kHz)."""

from __future__ import annotations

import importlib
import os
import shutil
import tempfile
import threading
import time

import httpx
import numpy as np
import torch

from smelter_tpu.sdk import AudioSideChannelReader, VideoSideChannelReader, discover_side_channels
from tests.test_pipeline import _make_source_mp4
from tests.test_torch_rtp import BOTH, PORT
from tests.test_torch_server import PortServer, _stop, _wait_done

torch.set_num_threads(2)


def test_serialized_messages_are_byte_equal():
    rng = np.random.RandomState(12)
    rgba = rng.randint(0, 256, (24, 32, 4), dtype=np.uint8)
    samples = rng.standard_normal((480, 2))
    msgs = []
    for name in BOTH:
        m = importlib.import_module(f"{name}.pipeline.side_channel")
        msgs.append((m.serialize_rgba_frame(32, 24, 1.5, rgba.tobytes()),
                     m.serialize_audio_batch(0.25, 48000, samples)))
    assert msgs[1] == msgs[0]


def _config(name: str, socket_dir: str):
    config = importlib.import_module(f"{name}.config")
    types = importlib.import_module(f"{name}.core.types")
    return config.Config(
        instance_id="test", output_framerate=types.Framerate(30),
        ahead_of_time_processing=True, never_drop_output_frames=True,
        side_channel_socket_dir=socket_dir, logger=config.LoggerConfig(level="warning"))


def _side_channel_flow(name: str, tmp_path, src: str) -> tuple:
    """An MP4 input registered over HTTP with its video and audio side
    channels on; the SDK reads both while the server records an MP4."""
    from tests.test_server import ServerThread

    # a short directory: a unix socket's path holds at most 107 bytes
    sc_dir = tempfile.mkdtemp(prefix="smelter-sc-")
    s = PortServer(_config(name, sc_dir)) if name == PORT else ServerThread(_config(name, sc_dir))
    frames, batches = [], []
    threads = []
    try:
        with httpx.Client(base_url=s.base, timeout=120) as c:
            r = c.post("/api/input/cam/register", json={
                "type": "mp4", "path": src, "required": True, "offset_ms": 0,
                "side_channel": {"video": True, "audio": True}})
            assert r.status_code == 200, r.text
            found = discover_side_channels(sc_dir)
            assert set(found["cam"]) == {"video", "audio"}

            def consume(reader_cls, path, out):
                reader = reader_cls(path, timeout=30)
                out.extend(reader)
                reader.close()

            for cls, kind, out in ((VideoSideChannelReader, "video", frames),
                                   (AudioSideChannelReader, "audio", batches)):
                threads.append(threading.Thread(target=consume, daemon=True,
                                                args=(cls, found["cam"][kind], out)))
                threads[-1].start()
            time.sleep(0.2)  # let the readers connect before frames flow
            r = c.post("/api/output/out/register", json={
                "type": "mp4", "path": str(tmp_path / f"out_{name}.mp4"),
                "video": {"resolution": {"width": 320, "height": 240},
                          "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
                          "initial": {"root": {"type": "rescaler", "child": {
                              "type": "input_stream", "input_id": "cam"}}},
                          "send_eos_when": {"all_inputs": True}},
                "audio": {"encoder": {"type": "aac"}, "initial": {"inputs": [{"input_id": "cam"}]},
                          "send_eos_when": {"all_inputs": True}}})
            assert r.status_code == 200, r.text
            assert c.post("/api/start", json={}).status_code == 200
            _wait_done(s, "out")
    finally:
        _stop(s)
        for t in threads:
            t.join(timeout=10)
        shutil.rmtree(sc_dir, ignore_errors=True)
    assert not any(t.is_alive() for t in threads)
    return frames, batches


def test_side_channel_through_the_server_matches_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("SMELTER_DEVICE", "cpu")
    src = str(tmp_path / "a.mp4")
    _make_source_mp4(src, "red", 440.0)
    (ref_frames, ref_batches), (frames, batches) = (
        _side_channel_flow(name, tmp_path, src) for name in BOTH)
    for fr, ba in ((ref_frames, ref_batches), (frames, batches)):
        assert len(fr) >= 30, len(fr)
        f = fr[len(fr) // 2]
        assert f.rgba.shape == (240, 320, 4)
        assert float(f.rgba[..., 0].mean()) > 150 and float(f.rgba[..., 2].mean()) < 80
        assert fr[-1].pts_s > fr[0].pts_s
        assert ba and ba[0].sample_rate == 48000
        assert np.concatenate([b.samples for b in ba]).shape[0] > 40000
    # a reader may connect after the first frames or batches went out:
    # what both runs delivered is matched by pts
    ref_by_pts = {f.pts_s: f for f in ref_frames}
    shared = [(ref_by_pts[f.pts_s], f) for f in frames if f.pts_s in ref_by_pts]
    assert len(shared) >= 20, len(shared)
    for a, b in shared:
        assert (a.width, a.height) == (b.width, b.height)
        np.testing.assert_array_equal(a.rgba, b.rgba)
    # AAC's first frames share pts 0: batches are matched by pts and content,
    # after the later of the two runs' first pts
    ref_pcm = {(b.start_pts_s, b.sample_rate, b.channels, b.samples.tobytes())
               for b in ref_batches}
    after = max(ref_batches[0].start_pts_s, batches[0].start_pts_s)
    until = min(ref_batches[-1].start_pts_s, batches[-1].start_pts_s)
    shared = [b for b in batches if after < b.start_pts_s <= until]
    assert len(shared) >= len(batches) // 2, (len(shared), len(batches))
    assert all((b.start_pts_s, b.sample_rate, b.channels, b.samples.tobytes()) in ref_pcm
               for b in shared)


def _rtp_side_channel_socket(name: str, want: str) -> None:
    """Registers an RTP input with its video side channel through package
    `name`'s glue (`register_rtp_input`) and checks, while it is registered,
    that a live socket listens at `want`."""
    import socket

    api = importlib.import_module(f"{name}.api.schema")
    types = importlib.import_module(f"{name}.core.types")
    rtp = importlib.import_module(f"{name}.io.rtp")
    P = importlib.import_module(f"{name}.pipeline")
    opts = P.PipelineOptions(output_framerate=types.Framerate(30))
    pipe = P.Pipeline(opts, device="cpu") if name == PORT else P.Pipeline(opts)
    spec = api.RtpInput.model_validate({"type": "rtp_stream", "port": 0,
                                        "video": {"decoder": "ffmpeg_h264"},
                                        "side_channel": {"video": True}})
    try:
        rtp.register_rtp_input(pipe, "cam", spec)
        assert os.path.exists(want), f"{name}: no {want}"
        # the socket this input listens on, not a file left by another run
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.settimeout(5)
            c.connect(want)
    finally:
        pipe.close()
    assert not os.path.exists(want), f"{name}: {want} outlived its pipeline"


def test_rtp_input_side_channel_socket_created(monkeypatch):
    """`side_channel` on an RTP input registered through the port's glue
    (`tests/test_side_channel.py::test_rtp_input_side_channel_socket_created`).
    Neither package's `register_rtp_input` passes a side-channel directory
    (a fault shared with the reference; ROADMAP Queue 3), so the socket lies
    in `<tempdir>/smelter_side_channel`: here the tempdir is a short
    directory of this test's own. In both packages a live `video_cam.sock`
    listens there while the input is registered, and is removed when the
    pipeline closes."""
    # a short directory: a unix socket's path holds at most 107 bytes
    root = tempfile.mkdtemp(prefix="smelter-sc-")
    monkeypatch.setattr(tempfile, "tempdir", root)
    try:
        for name in BOTH:
            _rtp_side_channel_socket(
                name, os.path.join(root, "smelter_side_channel", "video_cam.sock"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
