"""The port's HTTP server (`smelter_tpu_torch.server`) on the CPU
(``SMELTER_DEVICE=cpu``), beside the reference's where the two must answer
alike: the MP4 end-to-end flow, validation errors, the `/status`
configuration block, the HLS output and the `/ws` events; requests for what
is not ported answer NOT_IMPLEMENTED with the ROADMAP item and register
nothing."""

from __future__ import annotations

import importlib
import json
import time

import httpx
import pytest
import torch

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
    finally:
        server.stop()


@pytest.fixture()
def server(monkeypatch):
    monkeypatch.setenv("SMELTER_DEVICE", "cpu")
    s = PortServer(_config("smelter_tpu_torch"))
    yield s
    _stop(s)


@pytest.fixture()
def reference_server():
    s = ServerThread(_config("smelter_tpu"))
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


@pytest.mark.parametrize("path,body,item", [
    ("/api/input/x/register", {"type": "rtp_stream", "port": 9000, "video": {
        "decoder": "ffmpeg_h264"}}, "item 10"),
    ("/api/input/x/register", {"type": "rtmp_server", "app": "live",
                               "stream_key": "k"}, "item 10"),
    ("/api/output/x/register", {"type": "rtp_stream", "port": 9002, "video": {
        "resolution": {"width": 64, "height": 64}, "encoder": {"type": "ffmpeg_h264"},
        "initial": {"root": {"type": "view", "background_color": "#000000FF"}}}}, "item 10"),
    ("/api/shader/s/register", {"source": "def shader(ctx): return ctx.texture(0)"}, "item 7"),
    ("/api/image/i/register", {"asset_type": "png", "path": "/a.png"}, "item 7"),
    ("/api/web-renderer/w/register", {"url": "http://localhost/",
                                      "resolution": {"width": 64, "height": 64}}, "item 7"),
    ("/api/font/register", {"path": "/a.ttf"}, "item 7"),
    ("/api/shader/s/unregister", {}, "item 7"),
    ("/whip/x", None, "item 10"),
    ("/whep/x", None, "item 10"),
])
def test_unported_requests_register_nothing(server, path, body, item):
    with httpx.Client(base_url=server.base, timeout=30) as c:
        r = c.post(path, json=body) if body is not None else c.post(path, content=b"v=0")
        assert r.status_code == 501, r.text
        err = r.json()
        assert sorted(err) == ["error_code", "message", "stack"]
        assert err["error_code"] == "NOT_IMPLEMENTED"
        assert f"ROADMAP Queue 1 {item}" in err["message"]
        st = c.get("/status").json()
    assert st["inputs"] == [] and st["outputs"] == []


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
