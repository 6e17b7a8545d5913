"""The port's RTMP edge (`smelter_tpu_torch.io.rtmp`) against the reference's
(`smelter_tpu.io.rtmp`), on the CPU (`tests/test_rtmp.py`).

Tolerances:
  - pure protocol code is byte-equal: AMF0 and AMF3 encodings (and their
    decodings), RTMP chunks and the messages read back from them, the
    AVC/hvcC/vpcC records, AnnexB <-> AVCC, FLV video and audio tags and
    the enhanced-RTMP tag parser;
  - the flows that decode (our client -> our server, RTMPS, the enhanced
    HEVC and VP9 publish, libavformat's RTMP client publishing) run through
    both packages, the port's pipelines on the CPU: every decoded frame both
    runs have (matched by the input frame it shows: the clips' frame mark,
    or the luma ramp) is within a mean abs error of 1.0 u8 per plane, and
    each run meets the reference test's count and colour bounds;
  - garbage connections, the RTMPS server configured from the environment
    and the refused URL scheme meet the reference tests' bounds on the
    port."""

from __future__ import annotations

import importlib
import socket
import ssl
import threading
import time
from types import SimpleNamespace

import httpx
import numpy as np
import pytest
import torch

from tests.test_pipeline import _decode_output
from tests.test_torch_rtp import (
    BOTH,
    PORT,
    REF,
    _assert_frames_close,
    _drain,
    _make_marked_mp4,
    _mark_index,
    _ramp_index,
)

torch.set_num_threads(2)


def _pkg(name: str) -> SimpleNamespace:
    mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
    return SimpleNamespace(
        name=name, amf0=mod("io.rtmp.amf0"), amf3=mod("io.rtmp.amf3"),
        chunk=mod("io.rtmp.chunk"), h264=mod("io.rtmp.h264_utils"),
        hevc=mod("io.rtmp.hevc_utils"), session=mod("io.rtmp.session"),
        rtmp=mod("io.rtmp"), tls=mod("io.rtmp.tls"), codec=mod("io.codec"),
        types=mod("core.types"), comp=mod("scene.components"), pipeline=mod("pipeline"),
        mixer=mod("audio.mixer"), input=mod("pipeline.input"),
        channels=mod("utils.channels"))


_AMF0_VALUES = [1.5, True, "hello", None, {"app": "live", "nested": {"x": 2.0}, "flag": False},
                [1.0, "two", None], "connect", 1.0, {"app": "live", "tcUrl": "rtmp://h/live"}]
_AMF3_VALUES = [None, True, False, 42, -7, 1 << 20, 3.5, "hello", "", b"\x00\x01\x02",
                [1, 2.5, "x"], {"a": 1, "b": [True, None], "nested": {"k": "v"}}]


def _amf_script(pkg) -> list:
    amf0, amf3 = pkg.amf0, pkg.amf3
    rng = np.random.RandomState(4)
    floats = [float(x) for x in rng.standard_normal(8)]
    out = [amf0.encode_all(*_AMF0_VALUES), amf0.encode_all(*floats),
           amf3.encode_all(*_AMF3_VALUES)]
    u29 = [0, 127, 128, 16383, 16384, 0x1FFFFF, 0x200000, 0x0FFFFFFF, -1, -0x10000000]
    out += [amf3.encode(v) for v in u29]
    escaped = (amf0.encode("before") + bytes([amf0.AVMPLUS]) + amf3.encode({"x": 1})
               + amf0.encode(2.0))
    out += [amf0.decode_all(out[0]), amf0.decode_all(out[1]), amf3.decode_all(out[2]),
            [amf3.decode_all(amf3.encode(v)) for v in u29], amf0.decode_all(escaped),
            amf3.decode_all(amf3.encode("dup") + bytes([amf3.STRING, 0x00]))]
    msg = pkg.chunk.RtmpMessage
    cmd = pkg.session.decode_command_message
    out.append(cmd(msg(pkg.chunk.COMMAND_AMF3, 0, 0, b"\x00" + amf0.encode_all(
        "connect", 1.0, {"app": "live", "objectEncoding": 3.0}))))
    out.append(cmd(msg(pkg.chunk.COMMAND_AMF3, 0, 0, amf3.encode_all("publish", 5, None,
                                                                      "key"))))
    return out


def test_amf0_and_amf3_are_byte_equal():
    ref, port = _amf_script(_pkg(REF)), _amf_script(_pkg(PORT))
    assert port == ref
    assert port[13] == _AMF0_VALUES and port[15] == _AMF3_VALUES
    assert port[17] == ["before", {"x": 1}, 2.0] and port[18] == ["dup", "dup"]
    assert port[19][0] == "connect" and port[20][0] == "publish"


def _chunk_script(pkg, kind: str) -> tuple:
    c = pkg.chunk
    rng = np.random.RandomState(6)
    if kind == "large_payload":
        writer = c.ChunkWriter(chunk_size=128)
        stream = writer.serialize(c.RtmpMessage(9, 123456, 1, bytes(range(256)) * 40,
                                                chunk_stream_id=4))
        pieces = [stream]
    elif kind == "interleaved_partial":
        writer = c.ChunkWriter(chunk_size=64)
        stream = writer.serialize(writer.set_chunk_size_message(64))
        for k in range(6):
            stream += writer.serialize(c.RtmpMessage(
                9 if k % 2 == 0 else 8, 10 + 33 * k, 1,
                rng.randint(0, 256, int(rng.randint(1, 400)), dtype=np.uint8).tobytes(),
                chunk_stream_id=4 + k % 2))
        pieces = [stream[i:i + 7] for i in range(0, len(stream), 7)]
    else:  # "size_negotiation"
        writer = c.ChunkWriter(chunk_size=128)
        stream = writer.serialize(writer.set_chunk_size_message(4096))
        writer.chunk_size = 4096
        stream += writer.serialize(c.RtmpMessage(9, 0, 1, b"x" * 3000))
        pieces = [stream]
    reader = c.ChunkReader()
    got = []
    for piece in pieces:
        got += [(m.message_type, m.timestamp, m.stream_id, m.payload) for m in reader.feed(piece)]
    return stream, got, reader.chunk_size


@pytest.mark.parametrize("kind", ["large_payload", "interleaved_partial", "size_negotiation"])
def test_chunks_are_byte_equal(kind):
    ref, port = _chunk_script(_pkg(REF), kind), _chunk_script(_pkg(PORT), kind)
    assert port == ref
    stream, got, chunk_size = port
    if kind == "large_payload":
        assert got == [(9, 123456, 1, bytes(range(256)) * 40)]
    elif kind == "interleaved_partial":
        assert [m[0] for m in got] == [1, 9, 8, 9, 8, 9, 8]
    else:
        assert chunk_size == 4096 and got[-1][3] == b"x" * 3000


def _records_script(pkg, h264_au: bytes, hevc_extradata: bytes) -> list:
    h, s = pkg.h264, pkg.session
    sps, pps = h.extract_parameter_sets(h264_au)
    record = h.build_avcc_record(sps, pps)
    avcc = h.annexb_to_avcc(h264_au)
    out = [sps, pps, record, h.parse_avcc_record(record), avcc, h.avcc_to_annexb(avcc),
           h.split_annexb(h264_au), h.is_keyframe_annexb(h264_au),
           pkg.hevc.build_hvcc_record(hevc_extradata),
           pkg.hevc.extract_hevc_parameter_sets(hevc_extradata),
           s.video_tag(avcc, True, cts_ms=33), s.video_tag(avcc, False),
           s.audio_tag(b"\x12\x10", is_header=True), s.audio_tag(b"abc")]
    tags = [bytes([0x90]) + b"hvc1" + b"\x01\x02",
            bytes([0x91]) + b"hvc1" + b"\x00\x00\x21" + b"DATA",
            bytes([0xA3]) + b"av01" + b"OBUS", bytes([0x90]) + b"xxxx" + b"zz",
            s.ex_video_tag(b"hvc1", b"\x00\x00\x00\x02ab", True, 1, cts_ms=40),
            s.ex_video_tag(b"av01", b"\x12\x00", False, 3),
            s.ex_video_tag(b"vp09", s.build_vpcc_record(), True, 0),
            s.video_tag(avcc, True, cts_ms=33)]
    out += tags + [s.parse_video_tag(t) for t in tags]
    out += [s.parse_audio_tag(s.audio_tag(b"\x12\x10", is_header=True)),
            s.parse_audio_tag(s.audio_tag(b"abc"))]
    out.append(s.extract_av1_sequence_header(
        bytes([0x12, 0x00]) + bytes([0x0A, 0x03, 1, 2, 3]) + bytes([0x32, 0x01, 0xFF])))
    return out


def test_flv_tags_and_records_are_byte_equal():
    from smelter_tpu_torch.io.codec import Codec, VideoEncoder

    enc = VideoEncoder(Codec.H264, 128, 96, 30, opts="global_header=0")
    u = np.full((48, 64), 128, np.uint8)
    enc.send(np.full((96, 128), 90, np.uint8), u, u.copy(), 0.0)
    enc.send_eof()
    pkt = enc.receive()
    enc.close()
    henc = VideoEncoder(Codec.H265, 128, 96, 30)
    hevc_extradata = henc.extradata()
    henc.close()
    ref = _records_script(_pkg(REF), pkt.data, hevc_extradata)
    port = _records_script(_pkg(PORT), pkt.data, hevc_extradata)
    assert port == ref
    sps, pps, record, parsed = port[:4]
    assert parsed == ([sps], [pps], 4)
    hvcc = port[8]
    assert hvcc[0] == 1 and (hvcc[21] & 0x03) == 3 and hvcc[22] == 3
    assert port[-1] == bytes([0x0A, 0x03, 1, 2, 3])
    assert ("hevc_header", True, 0, b"\x01\x02") in port
    assert ("av1_frame", False, 0, b"OBUS") in port


# ------------------------------------------------------------------- flows


def _pipeline(pkg):
    P = pkg.pipeline
    opts = P.PipelineOptions(output_framerate=pkg.types.Framerate(30),
                             ahead_of_time_processing=True, never_drop_output_frames=True)
    return P.Pipeline(opts, device="cpu") if pkg.name == PORT else P.Pipeline(opts)


def _video(pkg, input_id: str, w: int, h: int, codec: str = "h264", preset="ultrafast"):
    P = pkg.pipeline
    return P.OutputVideoOptions(
        resolution=pkg.types.Resolution(w, h),
        encoder=(P.VideoEncoderOptions(codec=codec, preset=preset) if preset
                 else P.VideoEncoderOptions(codec=codec)),
        initial_root=pkg.comp.Rescaler(child=pkg.comp.InputStream(input_id=input_id)),
        end_condition=P.EndCondition(all_inputs=True))


def _audio(pkg, input_id: str):
    P = pkg.pipeline
    return P.OutputAudioOptions(
        encoder=P.AudioEncoderOptions(codec="aac"),
        initial_mixer_config=pkg.mixer.AudioMixerConfig(
            inputs=[pkg.mixer.AudioMixerInputConfig(input_id)]),
        end_condition=P.EndCondition(all_inputs=True))


def _wait_done(pipeline, output_id: str, timeout: float) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if ("OUTPUT_DONE", output_id) in {(e.kind, e.entity_id)
                                          for e in pipeline.events.history()}:
            return True
        time.sleep(0.1)
    return False


def _receiver(pkg, out_path: str, tls: bool = False, audio: bool = True):
    rx = _pipeline(pkg)
    server = pkg.rtmp.RtmpServerInput(pkg.rtmp.RtmpInputOptions(tls=tls))
    rx.register_input("in", server,
                      pkg.pipeline.RegisterInputOptions(required=True, offset=0.0))
    rx.register_output("out", pkg.pipeline.Mp4OutputSink(out_path),
                       video=_video(pkg, "in", 320, 240),
                       audio=_audio(pkg, "in") if audio else None)
    rx.start()
    return rx, server


def _loopback(name: str, tmp_path, color: str, scheme: str = "rtmp", codec: str = "h264",
              audio: bool = True) -> tuple:
    """`tests/test_rtmp.py`'s client -> server loopbacks on package `name`:
    an MP4 published by `RtmpClientOutput` to `RtmpServerInput`, recorded."""
    pkg = _pkg(name)
    src = str(tmp_path / f"src_{color}.mp4")
    if not (tmp_path / f"src_{color}.mp4").exists():
        _make_marked_mp4(src, color, 440.0)
    out_path = str(tmp_path / f"{name}_{scheme}_{codec}.mp4")
    rx, server = _receiver(pkg, out_path, tls=scheme == "rtmps", audio=audio)
    tx = _pipeline(pkg)
    tx.register_input("a", pkg.input.Mp4Input(pkg.input.Mp4InputOptions(path=src)),
                      pkg.pipeline.RegisterInputOptions(required=True, offset=0.0))
    sink = pkg.rtmp.RtmpClientOutput(f"{scheme}://127.0.0.1:{server.port}/live/key",
                                     **({"tls_verify": False} if scheme == "rtmps" else {}))
    tx.register_output("rtmp", sink,
                       video=_video(pkg, "a", 320, 240, codec,
                                    preset="ultrafast" if codec == "h264" else None),
                       audio=_audio(pkg, "a") if audio else None)
    tx.start()
    try:
        assert _wait_done(tx, "rtmp", 180), "tx OUTPUT_DONE not observed"
        assert _wait_done(rx, "out", 180), "rx OUTPUT_DONE not observed"
    finally:
        tx.close()
        rx.close()
    return _decode_output(out_path)[:2] if audio else (_decode_video(out_path), None)


def _decode_video(path: str) -> list:
    from tests.test_api_features import _decode_video as decode

    return decode(path)


@pytest.mark.parametrize("scheme,color,codec,audio", [
    ("rtmp", "red", "h264", True), ("rtmps", "blue", "h264", True),
    ("rtmp", "red", "h265", False), ("rtmp", "red", "vp9", False)],
    ids=["rtmp", "rtmps", "enhanced_hevc", "enhanced_vp9"])
def test_client_to_server_loopback_matches_the_reference(tmp_path, scheme, color, codec,
                                                          audio):
    """Our client output -> our server input (RTMPS: a self-signed TLS
    server; enhanced RTMP: FourCC tags), each package to itself."""
    runs = {name: _loopback(name, tmp_path, color, scheme, codec, audio) for name in BOTH}
    min_frames = {"rtmp": 50, "rtmps": 40}.get(scheme if codec == "h264" else "", 40)
    for frames, pcm in runs.values():
        assert len(frames) >= min_frames, len(frames)
        if pcm is not None and scheme == "rtmp":
            assert pcm.shape[0] > 60000
        plane, bound = (1, 180) if color == "blue" else (2, 170 if codec != "h264" else 180)
        assert float(np.mean([float(f[plane].mean()) for f in frames])) > bound
    _assert_frames_close(runs[REF][0], runs[PORT][0], _mark_index, 30)


def _publish_with_libavformat(pkg, port: int) -> None:
    """`tests/test_rtmp.py::test_ffmpeg_client_publishes_to_our_server`'s
    publisher: FFmpeg's RTMP client sends 1 s of a luma ramp (V = 200) and
    a tone, then closes."""
    codec = pkg.codec
    venc = codec.VideoEncoder(codec.Codec.H264, 160, 120, 30)
    aenc = codec.AudioEncoder(codec.Codec.AAC, 44100, 2)
    mux = codec.Muxer(f"rtmp://127.0.0.1:{port}/live/test", format="flv")
    vs = mux.add_video(codec.Codec.H264, 160, 120, 30, 1, venc.extradata())
    u = np.full((60, 80), 128, np.uint8)
    v = np.full((60, 80), 200, np.uint8)
    vpkts = []
    for i in range(30):
        venc.send(np.full((120, 160), 40 + i * 6, np.uint8), u, v, i / 30)
        _drain(venc, vpkts)
    venc.send_eof()
    _drain(venc, vpkts)
    t = np.arange(44100) / 44100.0
    aenc.send(np.stack([np.sin(2 * np.pi * 440 * t)] * 2, axis=1).astype(np.float32), 0.0)
    aenc.send_eof()
    apkts = []
    _drain(aenc, apkts)
    as_ = mux.add_audio(codec.Codec.AAC, 44100, 2, aenc.extradata())
    mux.write_header()
    for p in vpkts:
        mux.write(vs, p.data, p.pts_s, p.dts_s, p.is_keyframe)
    for p in apkts:
        mux.write(as_, p.data, p.pts_s, p.dts_s, p.is_keyframe)
    mux.close()


def _ffmpeg_publish(name: str, tmp_path) -> tuple:
    pkg = _pkg(name)
    out_path = str(tmp_path / f"{name}.mp4")
    rx = _pipeline(pkg)
    source = pkg.rtmp.RtmpServerInput(pkg.rtmp.RtmpInputOptions())
    rx.register_input("live", source,
                      pkg.pipeline.RegisterInputOptions(required=True, offset=0.0))
    rx.register_output("out", pkg.pipeline.Mp4OutputSink(out_path),
                       video=_video(pkg, "live", 160, 120), audio=_audio(pkg, "live"))
    rx.start()
    pub = threading.Thread(target=_publish_with_libavformat, args=(pkg, source.port),
                           daemon=True)
    pub.start()
    try:
        assert _wait_done(rx, "out", 120), "OUTPUT_DONE not observed"
    finally:
        rx.close()
        pub.join(timeout=10)
    return _decode_output(out_path)[:2]


def test_ffmpeg_client_publish_matches_the_reference(tmp_path):
    """libavformat's RTMP client -> the server input -> compose -> MP4."""
    runs = {name: _ffmpeg_publish(name, tmp_path) for name in BOTH}
    for frames, pcm in runs.values():
        assert len(frames) >= 25, len(frames)
        assert pcm.shape[0] > 30000
        ys = [float(f[0].mean()) for f in frames]
        assert max(ys) - min(ys) > 50
        assert float(np.mean([float(f[2].mean()) for f in frames])) > 170
    _assert_frames_close(runs[REF][0], runs[PORT][0],
                         lambda i, f: _ramp_index(i, f, base=40), 12)


def test_rtmp_input_survives_garbage_connections():
    """`tests/test_rtmp.py::test_rtmp_input_survives_garbage_connections` on
    the port: after an empty close, noise and a truncated handshake, a real
    publisher still delivers >= 10 frames."""
    pkg = _pkg(PORT)
    codec = pkg.codec
    source = pkg.rtmp.RtmpServerInput(pkg.rtmp.RtmpInputOptions(port=0, app="live",
                                                                 stream_key="k"))
    vch = pkg.channels.Channel(256)
    source.start(pkg.input.InputCtx(input_id="g", video_channel=vch, audio_channel=None))
    try:
        for payload in (b"", b"GET / HTTP/1.1\r\n\r\n", b"\x03" + b"x" * 100):
            s = socket.create_connection(("127.0.0.1", source.port), timeout=5)
            if payload:
                s.sendall(payload)
            s.close()
        time.sleep(0.5)
        venc = codec.VideoEncoder(codec.Codec.H264, 128, 96, 30)
        mux = codec.Muxer(f"rtmp://127.0.0.1:{source.port}/live/k", format="flv")
        mux.add_video(codec.Codec.H264, 128, 96, 30, 1, venc.extradata())
        mux.write_header()
        u = np.full((48, 64), 128, np.uint8)
        pkts = []
        for i in range(30):
            venc.send(np.full((96, 128), 40 + i * 6, np.uint8), u, u, i / 30)
            _drain(venc, pkts)
        venc.send_eof()
        _drain(venc, pkts)
        for p in pkts:
            mux.write(0, p.data, p.pts_s, p.dts_s, p.is_keyframe)
        mux.close()
        venc.close()
        got = 0
        deadline = time.time() + 30
        while time.time() < deadline and got < 10:
            try:
                vch.recv(timeout=1)
                got += 1
            except TimeoutError:
                continue
        assert got >= 10, f"only {got} frames after garbage connections"
    finally:
        source.stop()


def test_rtmp_client_rejects_unknown_scheme():
    with pytest.raises(ValueError):
        _pkg(PORT).rtmp.RtmpClientOutput("http://example/live/x")


def test_rtmp_tls_env_files_enable_rtmps(tmp_path, monkeypatch):
    """`SMELTER_RTMP_TLS_CERT_FILE`/`_KEY_FILE` make the port's server
    register RTMPS inputs: a TLS client handshake succeeds on the port it
    answers."""
    from smelter_tpu_torch.config import read_config
    from tests.test_torch_server import PortServer, _stop

    cert_pem, key_pem = _pkg(PORT).tls._self_signed_pem()
    (tmp_path / "cert.pem").write_bytes(cert_pem)
    (tmp_path / "key.pem").write_bytes(key_pem)
    monkeypatch.setenv("SMELTER_RTMP_TLS_CERT_FILE", str(tmp_path / "cert.pem"))
    monkeypatch.setenv("SMELTER_RTMP_TLS_KEY_FILE", str(tmp_path / "key.pem"))
    monkeypatch.setenv("SMELTER_DEVICE", "cpu")
    cfg = read_config()
    assert cfg.rtmp_tls_cert_file == str(tmp_path / "cert.pem")
    cfg.logger.level = "warning"
    s = PortServer(cfg)
    try:
        with httpx.Client(base_url=s.base, timeout=60) as c:
            r = c.post("/api/input/cam/register", json={"type": "rtmp_server"})
            assert r.status_code == 200, r.text
            raw = socket.create_connection(("127.0.0.1", r.json()["port"]), timeout=10)
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            tls = ctx.wrap_socket(raw)
            assert tls.version() is not None
            tls.close()
            assert c.post("/api/input/cam/unregister", json={}).status_code == 200
    finally:
        _stop(s)
