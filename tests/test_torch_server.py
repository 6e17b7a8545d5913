"""The port's HTTP server (`smelter_tpu_torch.server`) on the CPU
(``SMELTER_DEVICE=cpu``), beside the reference's where the two must answer
alike: the MP4 end-to-end flow, validation errors, the `/status`
configuration block, the HLS output and the `/ws` events, the shader, image,
web-renderer and font routes (and a shader registered over HTTP rendering
into an MP4); the RTP, RTMP, WHIP, WHEP and preview routes (an RTP input
registered over HTTP recorded into an MP4, and an MP4 composed into RTP, RTMP
and WHIP outputs registered over HTTP: decoded frames within a mean abs error
of 1.0 u8 per plane of the reference's); and the MoQ routes: a
`moq_server` input and a `moq_client` output registered, listed and
unregistered as on the reference's."""

from __future__ import annotations

import concurrent.futures
import dataclasses
import importlib
import json
import time

import httpx
import numpy as np
import pytest
import torch

from tests.test_api_features import _decode_video
from tests.test_pipeline import _decode_output, _make_source_mp4
from tests.test_server import ServerThread, _scene_json

torch.set_num_threads(2)


def _config(pkg: str):
    config = importlib.import_module(f"{pkg}.config")
    types = importlib.import_module(f"{pkg}.core.types")
    return config.Config(
        instance_id="test", output_framerate=types.Framerate(30),
        ahead_of_time_processing=True, never_drop_output_frames=True,
        logger=config.LoggerConfig(level="warning"))


class PortServer(ServerThread):
    """`tests.test_server.ServerThread` around the port's app."""

    def __init__(self, config) -> None:
        import tests.test_server as reference_harness
        from smelter_tpu_torch.server import app

        saved = reference_harness.ApiState, reference_harness.build_app
        reference_harness.ApiState, reference_harness.build_app = app.ApiState, app.build_app
        try:
            super().__init__(config)
        finally:
            reference_harness.ApiState, reference_harness.build_app = saved


def _stop(server) -> None:
    try:
        server.state.pipeline.close()
        if server.state.moq_server is not None:
            server.state.moq_server.close()
    finally:
        server.stop()


def _with_moq_tls(config, tmp_path, pkg: str):
    """`config` with a TLS pair for the server's MoQ listener, written for
    this test: the MoQ server's default certificate directory is a fixed
    path that other workers write at the same time. Handed over as
    SMELTER_MOQ_TLS_CERT_FILE and SMELTER_MOQ_TLS_KEY_FILE set it."""
    from smelter_tpu_torch.io.quic.tls import generate_self_signed

    cert, key = generate_self_signed()
    paths = tmp_path / f"moq_cert_{pkg}.der", tmp_path / f"moq_key_{pkg}.pem"
    paths[0].write_bytes(cert)
    paths[1].write_bytes(key)
    return dataclasses.replace(config, moq_tls_cert_file=str(paths[0]),
                               moq_tls_key_file=str(paths[1]))


@pytest.fixture()
def server(monkeypatch, tmp_path):
    monkeypatch.setenv("SMELTER_DEVICE", "cpu")
    pkg = "smelter_tpu_torch"
    s = PortServer(_with_moq_tls(_config(pkg), tmp_path, pkg))
    yield s
    _stop(s)


@pytest.fixture()
def reference_server(tmp_path):
    pkg = "smelter_tpu"
    s = ServerThread(_with_moq_tls(_config(pkg), tmp_path, pkg))
    yield s
    _stop(s)


def _wait_done(server, output_id: str, timeout: float = 120) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        kinds = {(e.kind, e.entity_id) for e in server.state.pipeline.events.history()}
        if ("OUTPUT_DONE", output_id) in kinds:
            return
        time.sleep(0.2)
    pytest.fail(f"OUTPUT_DONE not observed for {output_id}")


def test_server_runs_the_port_on_the_cpu_only_when_asked(server, monkeypatch):
    assert server.state.pipeline.device == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here: the server would run on it")
    from smelter_tpu_torch.server.app import ApiState

    monkeypatch.setenv("SMELTER_DEVICE", "gpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ApiState(_config("smelter_tpu_torch"))


def test_server_mp4_end_to_end(server, tmp_path):
    """`tests/test_server.py::test_server_mp4_end_to_end` through the port."""
    src_a, src_b = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    out_path = str(tmp_path / "out.mp4")
    _make_source_mp4(src_a, "red", 440.0)
    _make_source_mp4(src_b, "blue", 880.0)

    with httpx.Client(base_url=server.base, timeout=120) as c:
        r = c.post("/api/input/in_a/register",
                   json={"type": "mp4", "path": src_a, "required": True, "offset_ms": 0})
        assert r.status_code == 200, r.text
        assert r.json().get("video_duration_ms") == 2000
        r = c.post("/api/input/in_b/register",
                   json={"type": "mp4", "path": src_b, "required": True, "offset_ms": 0})
        assert r.status_code == 200, r.text
        r = c.post("/api/output/out/register", json={
            "type": "mp4", "path": out_path,
            "video": {
                "resolution": {"width": 640, "height": 240},
                "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
                "initial": _scene_json(),
                "send_eos_when": {"all_inputs": True},
            },
            "audio": {
                "encoder": {"type": "aac"},
                "initial": {"inputs": [{"input_id": "in_a"},
                                       {"input_id": "in_b", "volume": 0.5}]},
                "send_eos_when": {"all_inputs": True},
            },
        })
        assert r.status_code == 200, r.text
        st = c.get("/status").json()
        assert {i["input_id"] for i in st["inputs"]} == {"in_a", "in_b"}
        assert [o["output_id"] for o in st["outputs"]] == ["out"]
        assert st["outputs"][0]["output_type"] == "mp4"
        assert c.post("/api/start", json={}).status_code == 200
        _wait_done(server, "out")
        stats = c.get("/stats").json()
        assert stats["video_frames_rendered"] >= 55
        assert stats["compose_latency"]["p95_ms"] is not None

    frames, audio, infos = _decode_output(out_path)
    assert abs(len(frames) - 60) <= 1
    assert infos["video"].width == 640
    y, u, v, _, _ = frames[len(frames) // 2]
    # left half red (V high), right half blue (U high)
    half = v.shape[1] // 2
    assert float(v[:, :half].mean()) > 200 and float(u[:, half:].mean()) > 200
    assert audio.shape[0] > 48000 * 1.5


def _shader_flow(s, src: str, out_path: str, tmp_path) -> list:
    """`tests/test_api_features.py`'s shader flow on server `s`: a channel
    swapping shader registered over HTTP (and two refused ones), an MP4 of
    the red source through it at 320x240, an image and a font route. Returns
    the (status, error code) of every request."""
    from io import BytesIO

    from PIL import Image as PILImage

    png = BytesIO()
    PILImage.new("RGBA", (16, 8), (10, 200, 30, 255)).save(png, format="PNG")
    png_path = tmp_path / f"logo_{id(s)}.png"
    png_path.write_bytes(png.getvalue())
    source = ("def main(inputs, params, resolution, time):\n"
              "    tex = inputs[0]\n"
              "    rgb = tex[..., :3][..., ::-1]  # swap R<->B\n"
              "    return jnp.concatenate([rgb, tex[..., 3:4]], axis=-1)\n")
    requests = [
        ("/api/shader/swap/register", {"source": source}),
        ("/api/shader/evil/register",
         {"source": "def main(i, p, r, t):\n    return __import__('os').system('true')\n"}),
        ("/api/shader/badshape/register",
         {"source": "def main(inputs, params, resolution, time):\n"
                    "    return jnp.zeros((10, 10, 4), jnp.float32)\n"}),
        ("/api/shader/swap/register", {"source": source}),  # already registered
        ("/api/image/logo/register", {"asset_type": "png", "path": str(png_path)}),
        ("/api/image/logo/unregister", {}),
        ("/api/image/logo/unregister", {}),
        ("/api/font/register", {"path": "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"}),
        ("/api/input/a/register", {"type": "mp4", "path": src, "required": True,
                                   "offset_ms": 0}),
        ("/api/output/out/register", {
            "type": "mp4", "path": out_path,
            "video": {"resolution": {"width": 320, "height": 240},
                      "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
                      "initial": {"root": {
                          "type": "shader", "shader_id": "swap",
                          "resolution": {"width": 320, "height": 240},
                          "children": [{"type": "input_stream", "input_id": "a"}]}},
                      "send_eos_when": {"all_inputs": True}}}),
        ("/api/start", {}),
    ]
    answers = []
    with httpx.Client(base_url=s.base, timeout=120) as c:
        for path, body in requests:
            r = c.post(path, json=body)
            answers.append((path, r.status_code, r.json().get("error_code")))
    _wait_done(s, "out")
    return answers


def test_server_shader_flow_matches_the_reference(server, reference_server, tmp_path):
    """The shader, image and font routes answer as the reference's, and the
    MP4 rendered through a shader registered over HTTP decodes to the
    reference's frames at the harness tolerance."""
    from tests.harness import ALLOWED_ERROR

    src = str(tmp_path / "a.mp4")
    _make_source_mp4(src, "red", 440.0)
    runs = []
    for name, s in (("ref", reference_server), ("port", server)):
        out_path = str(tmp_path / f"out_{name}.mp4")
        answers = _shader_flow(s, src, out_path, tmp_path)
        runs.append((answers, _decode_video(out_path)))
    (ref_answers, ref_frames), (answers, frames) = runs
    assert answers == ref_answers
    assert [a[1] for a in answers[:4]] == [200, 400, 400, 400]
    assert frames[0][0].shape == (240, 320)
    assert abs(len(frames) - len(ref_frames)) <= 1 and len(frames) >= 55
    for a, b in zip(ref_frames, frames):
        for pa, pb in zip(a[:3], b[:3]):
            err = abs(pa.astype(float) - pb.astype(float)).mean()
            assert err <= ALLOWED_ERROR, err
    # the red input swapped to blue: U high, V low
    mid = frames[len(frames) // 2]
    assert float(mid[1].mean()) > 170 and float(mid[2].mean()) < 140


def _bad_requests(tmp_path):
    """(method, path, json body) of requests the reference refuses."""
    return [
        ("post", "/api/input/x/register",
         {"type": "mp4", "path": "/nonexistent.mp4", "bogus": 1}),
        ("post", "/api/input/x/register",
         {"type": "mp4", "path": "/a.mp4", "url": "http://x/a.mp4"}),
        ("post", "/api/input/x/register", {"type": "moq_server"}),
        ("post", "/api/input/x/register", {"type": "no_such_protocol"}),
        ("post", "/api/output/nope/unregister", {}),
        ("post", "/api/input/nope/unregister", {}),
        ("post", "/api/output/nope/update", {"video": {"root": {"type": "view"}}}),
        ("post", "/api/output/o/register", {
            "type": "mp4", "path": str(tmp_path / "o.mp4"),
            "video": {"resolution": {"width": 64, "height": 64},
                      "encoder": {"type": "ffmpeg_h264"},
                      "initial": {"root": {"type": "view", "background_color": "#zzz"}}}}),
        ("post", "/api/output/o/register", {"type": "mp4", "path": str(tmp_path / "o.mp4")}),
        ("post", "/api/output/o/unregister", {"schedule_ms": 1}),
    ]


def test_server_validation_errors_match_the_reference(server, reference_server, tmp_path):
    for method, path, body in _bad_requests(tmp_path):
        answers = []
        for s in (reference_server, server):
            with httpx.Client(base_url=s.base, timeout=30) as c:
                r = getattr(c, method)(path, json=body)
            answers.append((r.status_code, r.json()["error_code"], sorted(r.json())))
        assert answers[1] == answers[0], (path, body)
        assert answers[0][0] >= 400


def test_server_status_reports_the_reference_configuration(server, reference_server):
    blocks = []
    for s in (reference_server, server):
        with httpx.Client(base_url=s.base, timeout=30) as c:
            st = c.get("/status").json()
        blocks.append(st)
    assert blocks[1]["configuration"] == blocks[0]["configuration"]
    assert blocks[1]["instance_id"] == "test"
    assert sorted(blocks[1]) == sorted(blocks[0])


_VIEW_64 = {"resolution": {"width": 64, "height": 64}, "encoder": {"type": "ffmpeg_h264"},
            "initial": {"root": {"type": "view", "background_color": "#000000FF"}}}


@pytest.mark.parametrize("path,body", [
    ("/api/input/x/register", {"type": "rtp_stream", "port": 9000, "video": {
        "decoder": "ffmpeg_h264"}, "audio": {"decoder": "aac"}}),
    ("/api/input/x/register", {"type": "rtmp_server", "app": "live",
                               "stream_key": "k", "port": 70000}),
    ("/api/output/x/register", {"type": "rtp_stream", "port": 9002, "video": {
        "resolution": {"width": 64, "height": 64}, "encoder": {"type": "ffmpeg_h264"},
        "initial": {"root": {"type": "view", "background_color": "#zzz"}}}}),
    ("/api/shader/s/register", {"source": "def shader(ctx): return ctx.texture(0)"}),
    ("/api/image/i/register", {"asset_type": "png", "path": "/a.png"}),
    ("/api/web-renderer/w/register", {"url": "http://localhost/",
                                      "resolution": {"width": 64, "height": 64}}),
    ("/api/font/register", {"path": "/a.ttf"}),
    ("/api/shader/s/unregister", {}),
    ("/whip/x", None),
    ("/whep/x", None),
    ("/api/input/x/register", {"type": "moq_server", "auth_token": "t"}),
    ("/api/input/x/register", {"type": "moq_client", "endpoint_url": "https://localhost:1/",
                               "broadcast_path": "a"}),
    ("/api/output/x/register", {"type": "moq_client", "endpoint_url": "https://localhost:1/",
                                "broadcast_path": "a", "video": _VIEW_64}),
])
def test_edge_and_resource_requests_answer_as_the_reference(server, reference_server, path,
                                                            body):
    """The shader, image, web-renderer and font routes (ROADMAP item 7) and
    the RTP, RTMP, WHIP, WHEP and MoQ edges (item 10) answer as the
    reference's server does to the same request: the same status, the same
    `error_code` (the shader source given fails validation, /a.png and
    /a.ttf do not exist, an AAC RTP input lacks its config, port 70000
    cannot be bound, `#zzz` is no colour, no WHIP input or WHEP output `x`
    exists, nothing answers QUIC on localhost:1 within the MoQ client's 15 s)
    and the same body where 200 (a `moq_server` input answers the port of
    the server's own MoQ listener, which differs between the two). `/status`
    then lists what the reference's lists: nothing, the `moq_server` input
    `x`, or (a fault of both: ROADMAP Queue 3) the `moq_client` input `x`
    whose start failed. The two servers take the request at once (the MoQ
    clients' waits overlap)."""
    def ask(s):
        with httpx.Client(base_url=s.base, timeout=60) as c:
            r = c.post(path, json=body) if body is not None else c.post(path, content=b"v=0")
            st = c.get("/status").json()
        return r.status_code, r.json(), st["inputs"], st["outputs"]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        answers = list(pool.map(ask, (reference_server, server)))
    (ref_status, ref_body, ref_inputs, ref_outputs), (status, got, inputs, outputs) = answers
    assert status == ref_status, (path, answers)
    assert sorted(got) == sorted(ref_body) and got.get("error_code") == ref_body.get(
        "error_code"), (path, answers)
    assert (inputs, outputs) == (ref_inputs, ref_outputs), (path, answers)
    assert outputs == []
    if status == 200 and "port" in ref_body:
        assert got["port"] == server.state.moq_server.port > 0
        assert ref_body["port"] == reference_server.state.moq_server.port > 0
    elif status == 200:
        assert got == ref_body
    for s in (reference_server, server):
        for entry in inputs:
            with httpx.Client(base_url=s.base, timeout=30) as c:
                r = c.post(f"/api/input/{entry['input_id']}/unregister", json={})
                assert r.status_code == 200, r.text
                assert c.get("/status").json()["inputs"] == []
        if s.state.moq_state is not None:
            assert s.state.moq_state.find("x") is None


def test_moq_registrations_over_http_match_the_reference(server, reference_server):
    """A `moq_server` input and a `moq_client` output publishing into it,
    both registered over HTTP on each server (its output connects to its own
    MoQ listener; TLS verification off, as SMELTER_MOQ_DISABLE_TLS_VERIFICATION
    sets it): the same answers, `/status` entries and unregisters as the
    reference's, and the MoQ threads end once the listeners close."""
    import threading

    before = {t for t in threading.enumerate() if t.name.startswith(("quic", "moq"))}
    answers = []
    for s in (reference_server, server):
        s.state.config.moq_disable_tls_verification = True
        with httpx.Client(base_url=s.base, timeout=60) as c:
            r_in = c.post("/api/input/m/register", json={"type": "moq_server",
                                                          "auth_token": "t0k"})
            assert r_in.status_code == 200, r_in.text
            r_out = c.post("/api/output/o/register", json={
                "type": "moq_client", "container": "legacy", "broadcast_path": "composed",
                "endpoint_url": f"moql://127.0.0.1:{r_in.json()['port']}/m?token=t0k",
                "video": _VIEW_64})
            st = c.get("/status").json()
            gone = [c.post("/api/output/o/unregister", json={}).status_code,
                    c.post("/api/input/m/unregister", json={}).status_code]
            after = c.get("/status").json()
        answers.append((sorted(r_in.json()), r_out.status_code, r_out.json(), st["inputs"],
                        st["outputs"], gone, after["inputs"], after["outputs"]))
    assert answers[1] == answers[0]
    assert answers[1][1:] == (200, {}, [{"input_id": "m", "input_type": "moq_server"}],
                              [{"output_id": "o", "output_type": "moq_client"}], [200, 200], [],
                              [])
    for s in (reference_server, server):
        s.state.moq_server.close()
        s.state.pipeline.close()
    deadline = time.time() + 15
    left = None
    while left is None or (left and time.time() < deadline):
        time.sleep(0.1)
        left = [t.name for t in threading.enumerate()
                if t.name.startswith(("quic", "moq")) and t not in before]
    assert not left, left


@pytest.mark.parametrize("stage", [0, 1])
def test_chip_smoke_edges_scene_is_the_renderer_scene(stage):
    """`chip_smoke.py` phase 12 registers `renderer_scene` as wire JSON:
    the server's conversion of it is that scene."""
    import chip_smoke
    from smelter_tpu_torch.api import convert, schema as api

    for w, h, n in ((3840, 2160, 16), (640, 360, 4)):
        wire = chip_smoke.edge_scene_wire(w, h, n, stage)
        got = convert.video_scene(api.VideoScene.model_validate({"root": wire}))
        assert got == chip_smoke.renderer_scene(w, h, n, stage)


def test_preview_page_matches_the_reference(server, reference_server):
    """/preview/{id}: the WHEP preview page with the output id escaped."""
    pages = []
    for s in (reference_server, server):
        with httpx.Client(base_url=s.base, timeout=30) as c:
            r = c.get('/preview/cam"<x>')
            pages.append((r.status_code, r.headers["content-type"], r.text))
    assert pages[1] == pages[0]
    assert pages[1][0] == 200 and "cam&quot;&lt;x&gt;" in pages[1][2]


def _rtp_over_http(s, tmp_path, wire: list, name: str) -> list:
    """An RTP input registered over HTTP (TCP server; H.264 + Opus) recorded
    into a 128x96 MP4 by server `s`."""
    from tests.test_torch_rtp import _tcp_send

    out_path = str(tmp_path / f"rtp_{name}.mp4")
    with httpx.Client(base_url=s.base, timeout=120) as c:
        r = c.post("/api/input/cam/register", json={
            "type": "rtp_stream", "port": 0, "transport_protocol": "tcp_server",
            "video": {"decoder": "ffmpeg_h264"}, "audio": {"decoder": "opus"},
            "required": True, "offset_ms": 0})
        assert r.status_code == 200, r.text
        port = r.json()["port"]
        assert port > 0
        r = c.post("/api/output/out/register", json={
            "type": "mp4", "path": out_path,
            "video": {"resolution": {"width": 128, "height": 96},
                      "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
                      "initial": {"root": {"type": "rescaler", "child": {
                          "type": "input_stream", "input_id": "cam"}}},
                      "send_eos_when": {"all_inputs": True}},
            "audio": {"encoder": {"type": "aac"}, "initial": {"inputs": [{"input_id": "cam"}]},
                      "send_eos_when": {"all_inputs": True}}})
        assert r.status_code == 200, r.text
        st = c.get("/status").json()
        assert st["inputs"] == [{"input_id": "cam", "input_type": "rtp"}]
        assert c.post("/api/start", json={}).status_code == 200
        _tcp_send(port, wire)
        _wait_done(s, "out")
    return _decode_output(out_path)[:2]


def test_rtp_input_over_http_matches_the_reference(server, reference_server, tmp_path):
    """RTP in (registered over HTTP) -> MP4 through both servers: every
    decoded frame both have (by the input frame it shows) within a mean abs
    error of 1.0 u8 per plane, each run >= 25 frames."""
    from tests.test_torch_rtp import (
        _assert_frames_close,
        _encode_video,
        _pkg,
        _ramp_index,
        _rtp_stream,
        _wire,
    )

    wire = _wire(_rtp_stream(_pkg("smelter_tpu_torch"),
                             _encode_video("h264", 30, opts="global_header=0,g=10")))
    runs = [_rtp_over_http(s, tmp_path, wire, n)
            for n, s in (("ref", reference_server), ("port", server))]
    for frames, pcm in runs:
        assert len(frames) >= 25, len(frames)
        assert pcm.shape[0] > 30000
    _assert_frames_close(runs[0][0], runs[1][0], _ramp_index, 12)


def _av_options(input_id: str, audio_encoder: str) -> tuple:
    """(video, audio) wire options of a 320x240 output of one input, both
    ending with it."""
    video = {"resolution": {"width": 320, "height": 240},
             "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
             "initial": {"root": {"type": "rescaler", "child": {
                 "type": "input_stream", "input_id": input_id}}},
             "send_eos_when": {"all_inputs": True}}
    audio = {"encoder": {"type": audio_encoder}, "initial": {"inputs": [{"input_id": input_id}]},
             "send_eos_when": {"all_inputs": True}}
    return video, audio


def _udp_receive(sock) -> list:
    """The RTP packets that reach `sock` until it has been idle for 2 s."""
    from smelter_tpu_torch.io.rtp import RtpPacket

    sock.settimeout(2.0)
    received = []
    while True:
        try:
            data = sock.recv(65536)
        except TimeoutError:
            return received
        pkt = RtpPacket.parse(data)
        if pkt:
            received.append(pkt)


class _NetworkOutput:
    """What receives one network output of a server: `body` is the output's
    registration (its protocol's fields); `frames()` waits for the stream's
    end and returns its decoded frames and audio samples (None where the
    receiver keeps no audio)."""

    def __init__(self, kind: str, name: str, tmp_path) -> None:
        self.kind, self.name = kind, name
        self._rx = self._sock = self._server = None
        if kind == "rtp_stream":
            import socket

            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
            self._sock.bind(("127.0.0.1", 0))
            self.body = {"type": "rtp_stream", "ip": "127.0.0.1",
                         "port": self._sock.getsockname()[1], "transport_protocol": "udp"}
            audio = "opus"
        elif kind == "rtmp_client":
            from tests.test_torch_rtmp import _pkg, _receiver

            self._out = str(tmp_path / f"rtmp_{name}.mp4")
            self._rx, server = _receiver(_pkg(name), self._out)
            self.body = {"type": "rtmp_client",
                         "url": f"rtmp://127.0.0.1:{server.port}/live/key"}
            audio = "aac"
        else:
            from tests.test_torch_webrtc import _server

            self._out = str(tmp_path / f"whip_{name}.mp4")
            self._server = _server(name, ahead_of_time_processing=True,
                                   never_drop_output_frames=True)
            video, audio_opts = _av_options("cam", "aac")
            video["send_eos_when"] = audio_opts["send_eos_when"] = {"any_input": True}
            with httpx.Client(base_url=self._server.base, timeout=120) as c:
                r = c.post("/api/input/cam/register",
                           json={"type": "whip_server", "required": True, "offset_ms": 0})
                assert r.status_code == 200, r.text
                token = r.json()["bearer_token"]
                r = c.post("/api/output/out/register", json={
                    "type": "mp4", "path": self._out, "video": video, "audio": audio_opts})
                assert r.status_code == 200, r.text
                assert c.post("/api/start", json={}).status_code == 200
            self.body = {"type": "whip_client",
                         "endpoint_url": f"{self._server.base}/whip/cam", "bearer_token": token}
            audio = "opus"
        self.body["video"], self.body["audio"] = _av_options("a", audio)

    def frames(self) -> tuple:
        if self._sock is not None:
            from tests.test_torch_rtp import _decode_rtp_output

            return _decode_rtp_output(_udp_receive(self._sock))[0], None
        if self._rx is not None:
            from tests.test_torch_rtmp import _wait_done as wait_pipeline

            assert wait_pipeline(self._rx, "out", 180), f"{self.name}: the RTMP receiver"
        else:
            _wait_done(self._server, "out")
        return _decode_output(self._out)[:2]

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
        if self._rx is not None:
            self._rx.close()
        if self._server is not None:
            _stop(self._server)


@pytest.mark.parametrize("kind", ["rtp_stream", "rtmp_client", "whip_client"])
def test_network_output_over_http_matches_the_reference(server, reference_server, tmp_path,
                                                        kind):
    """An MP4 composed into an RTP (UDP), RTMP or WHIP output, both
    registered over HTTP, through both servers; each package's own receiver
    (an RTP client, an RTMP server input, a WHIP server input) decodes what
    arrives. The registration answers as the reference's; every frame both
    runs have, matched by the input frame it shows, is within a mean abs
    error of 1.0 u8 per plane; the frames that show the input (after the
    receiver's black ones) meet the bounds of the reference's tests of the
    protocol (>= 55, 50 and 30 frames; red content: V high), and the RTMP
    and WHIP receivers' audio theirs."""
    from tests.test_torch_rtp import _assert_frames_close, _make_marked_mp4, _mark_index

    src = str(tmp_path / "a.mp4")
    _make_marked_mp4(src, "red", 440.0)
    answers, runs = [], []
    for name, s in (("smelter_tpu", reference_server), ("smelter_tpu_torch", server)):
        out = _NetworkOutput(kind, name, tmp_path)
        try:
            with httpx.Client(base_url=s.base, timeout=120) as c:
                r = c.post("/api/input/a/register",
                           json={"type": "mp4", "path": src, "required": True, "offset_ms": 0})
                assert r.status_code == 200, r.text
                r = c.post("/api/output/out/register", json=out.body)
                answers.append((r.status_code, r.json()))
                assert r.status_code == 200, r.text
                st = c.get("/status").json()
                assert [o["output_id"] for o in st["outputs"]] == ["out"]
                assert c.post("/api/start", json={}).status_code == 200
                _wait_done(s, "out")
            runs.append(out.frames())
        finally:
            out.close()
    assert answers[1] == answers[0] == (200, {})
    min_frames, v_bound, min_samples = {"rtp_stream": (55, 180, None),
                                        "rtmp_client": (50, 180, 60000),
                                        "whip_client": (30, 170, 30000)}[kind]
    for frames, pcm in runs:
        # a live receiver shows black until the stream arrives
        shown = [f for k, f in enumerate(frames) if _mark_index(k, f) >= 0]
        assert len(shown) >= min_frames, (len(shown), len(frames))
        assert float(np.mean([float(f[2].mean()) for f in shown])) > v_bound
        if min_samples is not None:
            assert pcm.shape[0] > min_samples, pcm.shape
    _assert_frames_close(runs[0][0], runs[1][0], _mark_index, 25)


def test_server_hls_output_and_ws_events(server, tmp_path):
    """MP4 in -> HLS out through the port's API, with the events on /ws."""
    import glob

    import websockets.sync.client as ws_client

    src = str(tmp_path / "a.mp4")
    _make_source_mp4(src, "blue", 440.0)
    playlist = str(tmp_path / "out.m3u8")
    ws = ws_client.connect(f"ws://127.0.0.1:{server.port}/ws")
    try:
        with httpx.Client(base_url=server.base, timeout=120) as c:
            r = c.post("/api/input/a/register",
                       json={"type": "mp4", "path": src, "required": True, "offset_ms": 0})
            assert r.status_code == 200, r.text
            rescaled = {"root": {"type": "rescaler",
                                 "child": {"type": "input_stream", "input_id": "a"}}}
            r = c.post("/api/output/hls/register", json={
                "type": "hls", "path": playlist,
                "video": {"resolution": {"width": 320, "height": 240},
                          "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
                          "initial": rescaled, "send_eos_when": {"all_inputs": True}},
                "audio": {"encoder": {"type": "aac"},
                          "initial": {"inputs": [{"input_id": "a"}]},
                          "send_eos_when": {"all_inputs": True}},
            })
            assert r.status_code == 200, r.text
            assert c.post("/api/start", json={}).status_code == 200
            got = set()
            deadline = time.time() + 120
            while "OUTPUT_DONE" not in got and time.time() < deadline:
                try:
                    got.add(json.loads(ws.recv(timeout=5))["type"])
                except TimeoutError:
                    continue
            assert {"VIDEO_INPUT_PLAYING", "OUTPUT_DONE"} <= got, got
    finally:
        ws.close()
    with open(playlist) as f:
        content = f.read()
    assert "#EXTM3U" in content and "#EXT-X-ENDLIST" in content
    assert glob.glob(str(tmp_path / "*.ts")), "no HLS segments written"
