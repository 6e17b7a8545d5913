"""The port's documentation and inspection tools against the reference's, on
the CPU:

  - `generate_schemas` writes files byte-equal to the reference's
    `tools/generate_schemas.py` run into another directory, and
    `generate_ts_types` a file byte-equal to the committed
    `ts/smelter/src/api.generated.ts`;
  - `docs_examples --list` prints the reference's catalog; `--only text
    --duration 1` under SMELTER_DEVICE=cpu writes `components/text.mp4`,
    whose `.requests.json` equals the reference tool's once each tool's
    output directory is replaced by one placeholder, and whose decoded
    frames are within 1.0 mean abs u8 per plane of the reference's clip's
    frames of the same index;
  - `frame_inspector` and `waveform_inspector` on a clip made here: the
    same PNG names, byte-equal frame PNGs, and the same decoded samples
    under the waveform plot (its PNG bytes are not compared).
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

import numpy as np
import pytest
import torch

from smelter_tpu.io.codec import AudioEncoder, Codec, Demuxer, Muxer, VideoDecoder, VideoEncoder
from smelter_tpu_torch.tools import (
    docs_examples,
    frame_inspector,
    generate_schemas,
    generate_ts_types,
    waveform_inspector,
)
from tests.test_torch_tools import ROOT, load_reference

torch.set_num_threads(2)


def _run_script(main, argv, monkeypatch):
    """`main()` of a script that reads `sys.argv`, with `argv`; its stdout."""
    monkeypatch.setattr(sys, "argv", ["tool", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main()
    return out.getvalue()


# -- schemas --------------------------------------------------------------------


def test_generated_schemas_equal_the_reference(tmp_path, monkeypatch):
    reference = load_reference("generate_schemas", monkeypatch)
    _run_script(reference.main, [str(tmp_path / "ref")], monkeypatch)
    _run_script(generate_schemas.main, [str(tmp_path / "port")], monkeypatch)
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names == ["openapi_specification.json", "scene.schema.json"]
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_generated_ts_types_equal_the_committed_file(tmp_path, monkeypatch):
    out = tmp_path / "api.generated.ts"
    printed = _run_script(generate_ts_types.main, [str(out)], monkeypatch)
    assert printed.startswith(f"wrote {out} (")
    assert out.read_bytes() == (ROOT / "ts" / "smelter" / "src" / "api.generated.ts").read_bytes()


# -- docs_examples --------------------------------------------------------------


def test_docs_examples_lists_the_reference_catalog(monkeypatch):
    reference = load_reference("docs_examples", monkeypatch)
    want = _run_script(reference.main, ["--list"], monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert docs_examples.main(["--list"]) == 0
    assert out.getvalue() == want and len(want.splitlines()) == len(docs_examples.CATALOG) == 12


@pytest.fixture(scope="module")
def text_clips(tmp_path_factory):
    """`--only text --duration 1` of both tools on the CPU: their output
    directories."""
    root = tmp_path_factory.mktemp("docs")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SMELTER_DEVICE", "cpu")
        reference = load_reference("docs_examples", mp)
        _run_script(reference.main, ["--only", "text", "--duration", "1", "--out",
                                     str(root / "ref")], mp)
        with contextlib.redirect_stdout(io.StringIO()):
            assert docs_examples.main(["--only", "text", "--duration", "1", "--out",
                                       str(root / "port")]) == 0
    return root / "ref", root / "port"


def _video_planes(path):
    """Every frame of the clip's video, the decoder drained: [(y, u, v)]."""
    d = Demuxer(str(path))
    info = next(s for s in d.streams() if s.media_type == "video")
    dec = VideoDecoder(info.codec, info.extradata)
    frames = []

    def receive():
        while True:
            f = dec.receive()
            if f is None or f == "eof":
                return
            frames.append(f[:3])

    while (pkt := d.read()) is not None:
        if pkt.stream_index == info.index:
            dec.send(pkt.data, pkt.pts_s or 0.0)
            receive()
    dec.send_eof()
    receive()
    dec.close()
    d.close()
    return frames


def test_docs_examples_text_clip_matches_the_reference(text_clips):
    ref_root, port_root = text_clips
    clip = port_root / "components" / "text.mp4"
    assert clip.exists() and (port_root / "assets" / "logo.svg").exists()

    def requests(root):
        text = (root / "components" / "text.requests.json").read_text()
        return json.loads(text.replace(str(root), "<out>"))

    assert requests(port_root) == requests(ref_root)
    assert requests(port_root)[0]["body"]["path"] == "<out>/components/text.mp4"

    ref, port = _video_planes(ref_root / "components" / "text.mp4"), _video_planes(clip)
    # 30 frames at most: in both packages the frames still in flight between
    # the queue and the sink when the scheduled unregister runs (the
    # renderer's bounded(2) channel, the frame it renders) are not written,
    # so each clip may lack up to 3 at its end
    assert 27 <= len(port) <= 30 and 27 <= len(ref) <= 30, (len(port), len(ref))
    for k, (a, b) in enumerate(zip(ref, port)):
        for name, pa, pb in zip("yuv", a, b):
            err = np.abs(pa.astype(np.float32) - pb.astype(np.float32)).mean()
            assert err <= 1.0, f"frame {k} plane {name}: mean abs {err}"


# -- inspectors -----------------------------------------------------------------

W, H, FPS, SECONDS = 128, 96, 30, 1.0


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """1 s of H.264 (a luma ramp that moves each frame, chroma from a seed)
    and AAC (a 440 Hz tone), muxed into an MP4."""
    path = tmp_path_factory.mktemp("clip") / "clip.mp4"
    rng = np.random.RandomState(5)
    venc, aenc = VideoEncoder(Codec.H264, W, H, FPS), AudioEncoder(Codec.AAC, 48000, 2)

    def drain(enc, into):
        while (p := enc.receive()) not in (None, "eof"):
            into.append(p)

    vpkts, apkts = [], []
    ramp = np.arange(W, dtype=np.int32)
    for i in range(int(SECONDS * FPS)):
        y = np.broadcast_to((16 + (ramp * 2 + i * 7) % 219).astype(np.uint8), (H, W))
        u, v = (rng.randint(64, 192, (H // 2, W // 2)).astype(np.uint8) for _ in range(2))
        venc.send(np.ascontiguousarray(y), u, v, i / FPS)
        drain(venc, vpkts)
    venc.send_eof()
    drain(venc, vpkts)
    t = np.arange(int(SECONDS * 48000)) / 48000.0
    tone = (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    aenc.send(np.stack([tone, tone], axis=1), 0.0)
    aenc.send_eof()
    drain(aenc, apkts)
    mux = Muxer(str(path))
    vs = mux.add_video(Codec.H264, W, H, FPS, 1, venc.extradata())
    as_ = mux.add_audio(Codec.AAC, 48000, 2, aenc.extradata())
    mux.write_header()
    for s, pkts in ((vs, vpkts), (as_, apkts)):
        for p in pkts:
            mux.write(s, p.data, p.pts_s, p.dts_s, p.is_keyframe)
    mux.close()
    venc.close()
    aenc.close()
    return path


@pytest.mark.parametrize("argv", [[], ["--every", "3", "--max", "5"]])
def test_frame_inspector_writes_the_reference_pngs(clip, argv, tmp_path, monkeypatch):
    reference = load_reference("frame_inspector", monkeypatch)
    want = _run_script(reference.main, [str(clip), str(tmp_path / "ref"), *argv], monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        frame_inspector.main([str(clip), str(tmp_path / "port"), *argv])
    assert out.getvalue() == want.replace(str(tmp_path / "ref"), str(tmp_path / "port"))
    names = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert names and sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


def test_waveform_inspector_plots_the_reference_samples(clip, tmp_path, monkeypatch):
    from matplotlib.axes import Axes

    plotted = []
    plot = Axes.plot
    monkeypatch.setattr(Axes, "plot", lambda ax, *a, **k: plotted.append(a) or plot(ax, *a, **k))
    reference = load_reference("waveform_inspector", monkeypatch)
    _run_script(reference.main, [str(clip), str(tmp_path / "ref.png")], monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        waveform_inspector.main([str(clip), str(tmp_path / "port.png")])
    assert (tmp_path / "ref.png").exists() and (tmp_path / "port.png").exists()
    # each tool's waveform (its first plot) and its spectrum
    (ref_t, ref_mono), _, (t, mono), _ = plotted
    assert len(mono) > 40000
    np.testing.assert_array_equal(t, ref_t)
    np.testing.assert_array_equal(mono, ref_mono)
