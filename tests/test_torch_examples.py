"""The port's examples (`smelter_tpu_torch/examples/`), the counterparts of
the JAX package's `examples/offline_compose.py`, `flagship_live.py` and
`moq_relay.py`, each run on the CPU at a small size on short generated MP4s
(`tests/test_pipeline._make_source_mp4`: 2 s of 320x240 at 30 fps with a
tone): the output must decode at the asked size with the expected frames.
`tests/test_torch_import.py` shows that they load neither JAX nor the
reference package.
"""

from __future__ import annotations

import pytest
import torch

from smelter_tpu_torch.core.types import Resolution
from smelter_tpu_torch.examples import device_from_env, flagship_live, moq_relay, offline_compose
from smelter_tpu_torch.io.codec import Demuxer, VideoDecoder
from tests.test_pipeline import _decode_output, _make_source_mp4

torch.set_num_threads(2)


def _decode_video(path: str):
    """(frames, the video stream's info) of an MP4 with no audio stream."""
    d = Demuxer(path)
    info = next(s for s in d.streams() if s.media_type == "video")
    dec = VideoDecoder(info.codec, info.extradata)
    frames = []

    def drain():
        while (f := dec.receive()) not in (None, "eof"):
            frames.append(f)

    while (pkt := d.read()) is not None:
        dec.send(pkt.data, pkt.pts_s or 0.0)
        drain()
    dec.send_eof()
    drain()
    d.close()
    return frames, info


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("example_sources")
    paths = (str(tmp / "red.mp4"), str(tmp / "blue.mp4"))
    _make_source_mp4(paths[0], "red", 440.0)
    _make_source_mp4(paths[1], "blue", 880.0)
    return paths


def test_offline_compose(sources, tmp_path):
    out = str(tmp_path / "out.mp4")
    offline_compose.run(out, list(sources), resolution=Resolution(320, 180), device="cpu")
    frames, audio, infos = _decode_output(out)
    # tests/test_pipeline.py allows the last frame to miss the output
    assert abs(len(frames) - 60) <= 1
    assert (infos["video"].width, infos["video"].height) == (320, 180)
    assert audio.shape[1] == 2 and audio.shape[0] > 80000


def test_flagship_live(sources, tmp_path):
    out = str(tmp_path / "live.mp4")
    stats = flagship_live.run(sources[0], out, duration=2.0, n_inputs=4,
                              resolution=Resolution(320, 180), framerate=30, device="cpu")
    frames, info = _decode_video(out)
    assert (info.width, info.height) == (320, 180)
    # a live run on a loaded CPU drops frames; the frames rendered last, as
    # the pipeline closes, may not reach the encoder
    rendered = stats.video_frames_rendered
    assert rendered >= 5
    assert rendered - 2 <= len(frames) <= rendered


@pytest.mark.parametrize("container", ["cmaf", "legacy"])
def test_moq_relay(sources, tmp_path, container):
    out = str(tmp_path / "relay.mp4")
    moq_relay.run(sources[1], out, container, resolution=Resolution(320, 180),
                  cert_dir=str(tmp_path / "certs"), device="cpu")
    frames, audio, infos = _decode_output(out)
    assert (infos["video"].width, infos["video"].height) == (320, 180)
    # the receiver's timeline starts at the first object it gets: up to 20
    # of the clip's 60 frames may fall before it, as in the MoQ pipeline
    # loopback of tests/test_torch_moq.py
    assert 40 <= len(frames) <= 61
    assert audio.shape[0] > 40000


def test_examples_pick_their_device(monkeypatch):
    monkeypatch.setenv("SMELTER_DEVICE", "cpu")
    assert device_from_env() == "cpu"
    monkeypatch.delenv("SMELTER_DEVICE")
    assert device_from_env() is None
