"""HTTP/WS server, wire-compatible with the reference REST API.

Routes mirror `src/routes.rs:33-79`:
  POST /api/input/:id/{register,unregister,update}
  POST /api/output/:id/{register,unregister,update,request_keyframe}
  POST /api/{image,shader,web-renderer}/:id/{register,unregister}
  POST /api/font/register
  POST /api/start, /api/reset
  GET  /ws (event push), /status, /stats

aiohttp front end; the pipeline itself is threaded, so blocking pipeline
calls run in the default executor. Responses follow the reference `Response`
enum shapes (`src/state.rs:20-33`): `{}` for ok, `{"video_duration_ms": ...}`
for registered MP4s, error bodies `{"error_code", "message", ...}`.

The port's server composes on the CUDA card; ``SMELTER_DEVICE=cpu`` runs
it on the CPU, and without a card it refuses to start. It carries MP4 and
HLS inputs and outputs. The other protocols (RTP, RTMP, WHIP/WHEP, MoQ,
V4L2, DeckLink; ROADMAP Queue 1 item 10) and the shader, image,
web-renderer and font resources (item 7) answer NOT_IMPLEMENTED (501) with
the reference's error body, after validating the request, and register
nothing.
"""

from __future__ import annotations

import asyncio
import logging
import os
import queue as _queue
import threading
import time
from typing import Optional

from aiohttp import WSMsgType, web

from smelter_tpu_torch.api import convert
from smelter_tpu_torch.api import schema as api
from smelter_tpu_torch.config import Config, read_config

from smelter_tpu_torch.pipeline import (
    Mp4OutputSink,
    Pipeline,
    PipelineOptions,
)

import pydantic

logger = logging.getLogger("smelter.server")

PROTOCOL_EDGES = "ROADMAP Queue 1 item 10 (protocol edges)"
RENDER_NODES = "ROADMAP Queue 1 item 7 (shader, text, image, web)"

_REGISTER_INPUT = pydantic.TypeAdapter(api.RegisterInput)
_REGISTER_OUTPUT = pydantic.TypeAdapter(api.RegisterOutput)


class ApiError(Exception):
    def __init__(self, error_code: str, message: str, http_status: int = 400) -> None:
        super().__init__(message)
        self.error_code = error_code
        self.message = message
        self.http_status = http_status


def _not_ported(what: str, item: str) -> ApiError:
    return ApiError(
        "NOT_IMPLEMENTED", f"{what} is not ported to smelter_tpu_torch yet: {item}", 501
    )


def _error_response(exc: Exception) -> web.Response:
    if isinstance(exc, ApiError):
        code, message, status = exc.error_code, exc.message, exc.http_status
    elif isinstance(exc, pydantic.ValidationError):
        code, message, status = "MALFORMED_REQUEST", str(exc), 400
    elif isinstance(exc, (convert.ConversionError, ValueError, KeyError, SyntaxError)):
        code, message, status = "INVALID_REQUEST", str(exc), 400
    elif isinstance(exc, NotImplementedError):
        code, message, status = "NOT_IMPLEMENTED", str(exc), 501
    else:
        logger.exception("internal error")
        code, message, status = "INTERNAL_SERVER_ERROR", str(exc), 500
    return web.json_response(
        {"error_code": code, "message": message, "stack": [message]},
        status=status,
    )


class ApiState:
    """Owns the pipeline; /api/reset swaps it for a fresh one. The pipeline
    runs on the CUDA card, or on the CPU under ``SMELTER_DEVICE=cpu``."""

    def __init__(self, config: Config) -> None:
        self.config = config
        self.lock = threading.Lock()
        cpu = os.environ.get("SMELTER_DEVICE", "").strip().lower() == "cpu"
        self.device = "cpu" if cpu else None
        self.pipeline = self._new_pipeline()
        self.start_time: Optional[float] = None
        self.input_kinds: dict = {}
        self.output_kinds: dict = {}

    def _new_pipeline(self) -> Pipeline:
        c = self.config
        return Pipeline(
            PipelineOptions(
                output_framerate=c.output_framerate,
                mixing_sample_rate=c.mixing_sample_rate,
                ahead_of_time_processing=c.ahead_of_time_processing,
                never_drop_output_frames=c.never_drop_output_frames,
                run_late_scheduled_events=c.run_late_scheduled_events,
                stream_fallback_timeout=c.stream_fallback_timeout,
            ),
            device=self.device,
        )

    def reset(self) -> None:
        with self.lock:
            old = self.pipeline
            self.pipeline = self._new_pipeline()
            self.start_time = None
            self.input_kinds.clear()
            self.output_kinds.clear()
        old.close()
        from smelter_tpu_torch.utils import tracing

        tracing.reset()  # span aggregates restart with the fresh pipeline


def _json_ok(payload: Optional[dict] = None) -> web.Response:
    return web.json_response(payload or {})


async def _run_blocking(fn, *args):
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, fn, *args)


async def _unregister_schedule(request: web.Request) -> Optional[float]:
    """Parse an unregister body into a schedule time (seconds) or None.

    Mirrors `src/routes/unregister_request.rs:18-37`: the body is optional;
    `schedule_time_ms` defers the unregister to that queue PTS (0 = start).
    """
    raw = await request.read()
    if not raw:
        return None
    req = api.UnregisterRequest.model_validate_json(raw)
    if req.schedule_time_ms is None:
        return None
    return req.schedule_time_ms / 1000.0


def _schedule_unregister(state: ApiState, when: float, what: str, fn) -> None:
    """Queue `fn` at PTS `when`; scheduled failures log (routes.rs behavior —
    the HTTP 200 already went out, so errors can only be reported here)."""

    def run() -> None:
        try:
            fn()
        except Exception:  # noqa: BLE001
            logger.exception(
                "scheduled unregister of %s at %.3fs failed", what, when
            )

    state.pipeline.queue.schedule_event(when, run)


_STATE_KEY = web.AppKey("state", object)


def build_app(state: ApiState) -> web.Application:
    app = web.Application(client_max_size=50 * 1024 * 1024)
    app[_STATE_KEY] = state

    # ------------------------------------------------------------- inputs

    async def register_input(request: web.Request) -> web.Response:
        input_id = request.match_info["id"]
        try:
            body = await request.json()
            spec = _REGISTER_INPUT.validate_python(body)

            def do() -> dict:
                if isinstance(spec, api.Mp4Input):
                    source, opts = convert.mp4_input(
                        spec, side_channel_dir=state.config.side_channel_socket_dir or None
                    )
                    state.pipeline.register_input(input_id, source, opts)
                    state.input_kinds[input_id] = "mp4"
                    vd = source._video_info.duration_s if source._video_info else None
                    ad = source._audio_info.duration_s if source._audio_info else None
                    return {
                        "video_duration_ms": int(vd * 1000) if vd else None,
                        "audio_duration_ms": int(ad * 1000) if ad else None,
                    }
                if isinstance(spec, api.HlsInput):
                    from smelter_tpu_torch.pipeline.input import HlsInput as _HlsInput
                    from smelter_tpu_torch.pipeline.input import HlsInputOptions
                    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

                    source = _HlsInput(HlsInputOptions(url=spec.url))
                    sc = spec.side_channel or {}
                    state.pipeline.register_input(
                        input_id,
                        source,
                        RegisterInputOptions(
                            required=bool(spec.required),
                            offset=(spec.offset_ms / 1000.0)
                            if spec.offset_ms is not None
                            else None,
                            side_channel_video=bool(sc.get("video")),
                            side_channel_audio=bool(sc.get("audio")),
                            side_channel_dir=state.config.side_channel_socket_dir or None,
                            side_channel_delay=float(sc.get("delay_ms") or 0.0) / 1000.0,
                        ),
                    )
                    state.input_kinds[input_id] = "hls"
                    return {}
                raise _not_ported(f"input protocol {spec.type!r}", PROTOCOL_EDGES)

            result = await _run_blocking(do)
            return _json_ok(result)
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def unregister_input(request: web.Request) -> web.Response:
        input_id = request.match_info["id"]

        def do() -> None:
            state.pipeline.unregister_input(input_id)
            state.input_kinds.pop(input_id, None)

        try:
            when = await _unregister_schedule(request)
            if when is not None:
                _schedule_unregister(state, when, f"input {input_id!r}", do)
            else:
                await _run_blocking(do)
            return _json_ok()
        except KeyError:
            return _error_response(
                ApiError(
                    "INPUT_STREAM_NOT_FOUND",
                    f"Input stream \"{input_id}\" does not exist.",
                    404,
                )
            )
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def update_input(request: web.Request) -> web.Response:
        input_id = request.match_info["id"]
        try:
            body = await request.json()
            pause = body.get("pause")
            seek_ms = body.get("seek_ms")
            unknown = set(body) - {"pause", "seek_ms"}
            if unknown:
                raise convert.ConversionError(f"unknown fields {sorted(unknown)}")
            await _run_blocking(
                lambda: state.pipeline.update_input(
                    input_id,
                    pause=pause,
                    seek=(seek_ms / 1000.0) if seek_ms is not None else None,
                )
            )
            return _json_ok()
        except KeyError:
            return _error_response(
                ApiError(
                    "INPUT_STREAM_NOT_FOUND",
                    f"Input stream \"{input_id}\" does not exist.",
                    404,
                )
            )
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    # ------------------------------------------------------------- outputs

    async def register_output(request: web.Request) -> web.Response:
        output_id = request.match_info["id"]
        try:
            body = await request.json()
            spec = _REGISTER_OUTPUT.validate_python(body)

            def do() -> dict:
                if isinstance(spec, api.Mp4Output):
                    video = (
                        convert.output_video_options(spec.video, "mp4")
                        if spec.video
                        else None
                    )
                    audio = (
                        convert.output_audio_options(spec.audio)
                        if spec.audio
                        else None
                    )
                    sink = Mp4OutputSink(spec.path)
                    state.pipeline.register_output(output_id, sink, video, audio)
                    state.output_kinds[output_id] = "mp4"
                    return {}
                if isinstance(spec, api.HlsOutput):
                    from smelter_tpu_torch.pipeline.output import HlsOutputSink

                    video = (
                        convert.output_video_options(spec.video, "hls")
                        if spec.video
                        else None
                    )
                    audio = (
                        convert.output_audio_options(spec.audio)
                        if spec.audio
                        else None
                    )
                    sink = HlsOutputSink(spec.path, spec.max_playlist_size,
                                         ffmpeg_options=spec.ffmpeg_options)
                    state.pipeline.register_output(output_id, sink, video, audio)
                    state.output_kinds[output_id] = "hls"
                    return {}
                raise _not_ported(f"output protocol {spec.type!r}", PROTOCOL_EDGES)

            result = await _run_blocking(do)
            return _json_ok(result)
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def unregister_output(request: web.Request) -> web.Response:
        output_id = request.match_info["id"]

        def do() -> None:
            state.pipeline.unregister_output(output_id)
            state.output_kinds.pop(output_id, None)

        try:
            when = await _unregister_schedule(request)
            if when is not None:
                _schedule_unregister(state, when, f"output {output_id!r}", do)
            else:
                await _run_blocking(do)
            return _json_ok()
        except KeyError:
            return _error_response(
                ApiError(
                    "OUTPUT_STREAM_NOT_FOUND",
                    f"Output stream \"{output_id}\" does not exist.",
                    404,
                )
            )
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def update_output(request: web.Request) -> web.Response:
        output_id = request.match_info["id"]
        try:
            body = await request.json()
            req = api.UpdateOutputRequest.model_validate(body)
            root = convert.video_scene(req.video) if req.video else None
            audio_cfg = convert.audio_config(req.audio) if req.audio else None
            schedule = (
                req.schedule_time_ms / 1000.0
                if req.schedule_time_ms is not None
                else None
            )
            await _run_blocking(
                lambda: state.pipeline.update_output(
                    output_id, root, audio_cfg, schedule_time=schedule
                )
            )
            return _json_ok()
        except KeyError as exc:
            return _error_response(
                ApiError(
                    "OUTPUT_STREAM_NOT_FOUND",
                    f"Output stream {exc} does not exist.",
                    404,
                )
            )
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def request_keyframe(request: web.Request) -> web.Response:
        output_id = request.match_info["id"]
        try:
            await _run_blocking(state.pipeline.request_keyframe, output_id)
            return _json_ok()
        except KeyError:
            return _error_response(
                ApiError(
                    "OUTPUT_STREAM_NOT_FOUND",
                    f"Output stream \"{output_id}\" does not exist.",
                    404,
                )
            )
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    # ------------------------------------------------------------- resources

    def unported_resource(kind: str, schema=None):
        """A handler that validates the request like the reference's and
        answers that `kind` is not ported (item 7)."""

        async def handler(request: web.Request) -> web.Response:
            try:
                if schema is not None:
                    schema.model_validate(await request.json())
                else:
                    await _unregister_schedule(request)
                raise _not_ported(kind, RENDER_NODES)
            except Exception as exc:  # noqa: BLE001
                return _error_response(exc)

        return handler

    # ------------------------------------------------------------- control

    async def start(request: web.Request) -> web.Response:
        try:
            def do() -> None:
                with state.lock:
                    state.pipeline.start()
                    state.start_time = time.time()

            await _run_blocking(do)
            return _json_ok()
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def reset(request: web.Request) -> web.Response:
        try:
            await _run_blocking(state.reset)
            return _json_ok()
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    # ------------------------------------------------------------- observability

    async def status(request: web.Request) -> web.Response:
        p = state.pipeline
        c = state.config
        fr = c.output_framerate
        return web.json_response(
            {
                "instance_id": c.instance_id,
                # reference routes/status.rs InstanceConfiguration
                "configuration": {
                    "api_port": c.api_port,
                    "output_framerate": fr.num / fr.den,
                    "mixing_sample_rate": c.mixing_sample_rate,
                    "ahead_of_time_processing": c.ahead_of_time_processing,
                    "never_drop_output_frames": c.never_drop_output_frames,
                    "run_late_scheduled_events": c.run_late_scheduled_events,
                    "download_root": c.download_dir or "/tmp",
                    "web_renderer_enable": c.web_renderer_enable,
                    "web_renderer_enable_gpu": False,
                    "whip_whep_server_port": c.whip_whep_server_port,
                    "whip_whep_enable": c.start_whip_whep_server,
                    "webrtc_stun_servers": [
                        x for x in os.environ.get(
                            "SMELTER_WEBRTC_STUN_SERVERS", ""
                        ).split(",") if x
                    ],
                    # the fast/general program split plays the
                    # reference's rendering-mode role
                    "rendering_mode": "gpu_optimized",
                },
                "inputs": [
                    {"input_id": iid, "input_type": state.input_kinds.get(iid, "raw_data")}
                    for iid in p._inputs
                ],
                "outputs": [
                    {"output_id": oid, "output_type": state.output_kinds.get(oid, "raw_data")}
                    for oid in p._outputs
                ],
            }
        )

    async def stats(request: web.Request) -> web.Response:
        from smelter_tpu_torch.pipeline.stats import collect_stats

        report = await _run_blocking(collect_stats, state.pipeline)
        for iid, entry in report.get("inputs", {}).items():
            entry["input_type"] = state.input_kinds.get(iid, "raw_data")
        for oid, entry in report.get("outputs", {}).items():
            entry["output_type"] = state.output_kinds.get(oid, "raw_data")
        return web.json_response(report)

    async def ws_handler(request: web.Request) -> web.WebSocketResponse:
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        # replay buffer: `?replay=1` (or replay=<n> for the last n) sends the
        # event history before live events, so late subscribers can catch up
        # on INPUT_EOS/OUTPUT_DONE they would otherwise have missed
        replay = request.query.get("replay")
        sub = state.pipeline.events.subscribe()
        if replay:
            try:
                n = int(replay)
            except ValueError:
                n = 0
            history = state.pipeline.events.history()
            if n > 1:
                history = history[-n:]
            for event in history:
                await ws.send_json(
                    {"type": event.kind, "replayed": True,
                     **({"input_id": event.entity_id}
                        if "INPUT" in event.kind
                        else {"output_id": event.entity_id}),
                     **event.properties}
                )
        try:
            while not ws.closed:
                try:
                    event = await _run_blocking(lambda: sub.get(timeout=0.5))
                except _queue.Empty:
                    # also service incoming messages (ping/close)
                    try:
                        msg = await asyncio.wait_for(ws.receive(), timeout=0.001)
                        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING, WSMsgType.ERROR):
                            break
                    except asyncio.TimeoutError:
                        pass
                    continue
                await ws.send_json(
                    {"type": event.kind, **({"input_id": event.entity_id}
                     if "INPUT" in event.kind else {"output_id": event.entity_id}),
                     **event.properties}
                )
        finally:
            state.pipeline.events.unsubscribe(sub)
        return ws

    async def webrtc_unported(request: web.Request) -> web.Response:
        return _error_response(
            _not_ported("WebRTC (WHIP/WHEP signalling, the WHEP preview page)",
                        PROTOCOL_EDGES))

    for path in ("/whip/{id}", "/whep/{id}"):
        app.router.add_post(path, webrtc_unported)
        app.router.add_route("PATCH", path + "/session", webrtc_unported)
        app.router.add_route("DELETE", path + "/session", webrtc_unported)
    app.router.add_post("/api/input/{id}/register", register_input)
    app.router.add_post("/api/input/{id}/unregister", unregister_input)
    app.router.add_post("/api/input/{id}/update", update_input)
    app.router.add_post("/api/output/{id}/register", register_output)
    app.router.add_post("/api/output/{id}/unregister", unregister_output)
    app.router.add_post("/api/output/{id}/update", update_output)
    app.router.add_post("/api/output/{id}/request_keyframe", request_keyframe)
    for kind, schema in (("shader", api.ShaderSpec), ("image", api.ImageSpec),
                         ("web-renderer", api.WebRendererSpec)):
        app.router.add_post(f"/api/{kind}/{{id}}/register",
                            unported_resource(f"{kind} registration", schema))
        app.router.add_post(f"/api/{kind}/{{id}}/unregister",
                            unported_resource(f"{kind} registration"))
    app.router.add_post("/api/font/register",
                        unported_resource("font registration", api.FontSpec))
    app.router.add_post("/api/start", start)
    app.router.add_post("/api/reset", reset)
    app.router.add_get("/status", status)
    app.router.add_get("/stats", stats)
    app.router.add_get("/ws", ws_handler)
    app.router.add_get("/preview/{id}", webrtc_unported)
    return app


def run(config: Optional[Config] = None) -> None:
    """Serve the API on the configured port. `Config.xla_debug` and the
    WebRTC, MoQ, RTMP and WHIP/WHEP server settings are read and reported
    but have no effect: nothing they configure is ported yet."""
    cfg = config or read_config()
    from smelter_tpu_torch.config import init_logger

    init_logger(cfg.logger)
    state = ApiState(cfg)
    app = build_app(state)
    logger.info("smelter_tpu_torch listening on :%d", cfg.api_port)
    web.run_app(app, port=cfg.api_port, print=None)
