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
it on the CPU, and without a card it refuses to start. It carries the
reference's MP4, HLS, RTP, RTMP(S), WHIP/WHEP, V4L2, DeckLink and MoQ
inputs and outputs, the /whip, /whep and /preview endpoints, and the shader,
image, web-renderer and font resources.
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

_REGISTER_INPUT = pydantic.TypeAdapter(api.RegisterInput)
_REGISTER_OUTPUT = pydantic.TypeAdapter(api.RegisterOutput)


class ApiError(Exception):
    def __init__(self, error_code: str, message: str, http_status: int = 400) -> None:
        super().__init__(message)
        self.error_code = error_code
        self.message = message
        self.http_status = http_status


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
        from smelter_tpu_torch.io.webrtc.session import configure_udp

        configure_udp(
            mux_port=config.webrtc_udp_mux_port,
            port_range=config.webrtc_udp_port_range,
            nat_1to1_ips=config.webrtc_nat_1to1_ips,
        )
        cpu = os.environ.get("SMELTER_DEVICE", "").strip().lower() == "cpu"
        self.device = "cpu" if cpu else None
        self.pipeline = self._new_pipeline()
        self.start_time: Optional[float] = None
        self.input_kinds: dict = {}
        self.output_kinds: dict = {}
        self.moq_server = None
        self.moq_state = None
        if config.start_moq_server:
            self._start_moq_server()

    def _start_moq_server(self):
        """Start (or return) the shared MoQ QUIC server (reference
        spawn_moq_server, instance.rs:630-646 + moq/server.rs). Lazily
        started on first moq_server input when SMELTER_START_MOQ_SERVER
        is unset, so tests and ad-hoc registrations just work."""
        if self.moq_server is None:
            from smelter_tpu_torch.io.moq import MoqServer, MoqServerState

            cert = key = None
            c = self.config
            if c.moq_tls_cert_file and c.moq_tls_key_file:
                with open(c.moq_tls_cert_file, "rb") as f:
                    cert = f.read()
                with open(c.moq_tls_key_file, "rb") as f:
                    key = f.read()
            self.moq_state = MoqServerState()
            self.moq_server = MoqServer(
                c.moq_server_port if c.start_moq_server else 0,
                self.moq_state, cert_der=cert, key_pem=key,
            )
        return self.moq_server

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
                if isinstance(spec, api.RtpInput):
                    from smelter_tpu_torch.io.rtp import register_rtp_input

                    port = register_rtp_input(state.pipeline, input_id, spec)
                    state.input_kinds[input_id] = "rtp"
                    return {"port": port}
                if isinstance(spec, api.RtmpInput):
                    from smelter_tpu_torch.io.rtmp import RtmpInputOptions, RtmpServerInput
                    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

                    # SMELTER_RTMP_TLS_CERT_FILE/KEY_FILE turn the server
                    # RTMPS (reference config.rs:335-351 rtmp_tls_config)
                    tls_cert = state.config.rtmp_tls_cert_file
                    tls_key = state.config.rtmp_tls_key_file
                    source = RtmpServerInput(
                        RtmpInputOptions(
                            port=spec.port or 0,
                            app=spec.app or "",
                            stream_key=spec.stream_key or "",
                            tls=bool(tls_cert and tls_key),
                            tls_cert_path=tls_cert,
                            tls_key_path=tls_key,
                        )
                    )
                    sc = spec.side_channel or {}
                    state.pipeline.register_input(
                        input_id,
                        source,
                        RegisterInputOptions(
                            required=bool(spec.required),
                            offset=(spec.offset_ms / 1000.0)
                            if spec.offset_ms is not None
                            else None,
                            # reference applies a 2s buffer rule for RTMP
                            # inputs (queue.rs:110-115)
                            buffer_duration=2.0,
                            side_channel_video=bool(sc.get("video")),
                            side_channel_audio=bool(sc.get("audio")),
                            side_channel_dir=state.config.side_channel_socket_dir or None,
                            side_channel_delay=float(sc.get("delay_ms") or 0.0) / 1000.0,
                        ),
                    )
                    state.input_kinds[input_id] = "rtmp"
                    return {"port": source.port}
                if isinstance(spec, api.DeckLinkInput):
                    from smelter_tpu_torch.io.decklink import (
                        DeckLinkInput,
                        list_decklink_devices,
                    )
                    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

                    # device selection by display_name / persistent_id
                    # (reference decklink/find_device.rs), else index
                    subdevice = spec.subdevice_index or 0
                    if spec.display_name or spec.persistent_id:
                        matches = [
                            d for d in list_decklink_devices()
                            if (spec.display_name is None
                                or d.name == spec.display_name)
                            and (spec.persistent_id is None
                                 or d.persistent_id == spec.persistent_id)
                        ]
                        if not matches:
                            raise ApiError(
                                "DECKLINK_DEVICE_NOT_FOUND",
                                "no DeckLink device matches "
                                f"display_name={spec.display_name!r} "
                                f"persistent_id={spec.persistent_id!r}",
                                404,
                            )
                        subdevice = matches[0].subdevice_index
                    source = DeckLinkInput(
                        subdevice_index=subdevice,
                        enable_audio=bool(spec.enable_audio),
                    )
                    state.pipeline.register_input(
                        input_id, source,
                        RegisterInputOptions(required=bool(spec.required)),
                    )
                    state.input_kinds[input_id] = "decklink"
                    return {}
                if isinstance(spec, api.V4l2Input):
                    from smelter_tpu_torch.io.v4l2 import V4l2Input, V4l2InputOptions
                    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

                    if spec.format and spec.format.lower() not in (
                        "yuyv", "nv12",
                    ):
                        raise ApiError(
                            "V4L2_FORMAT_UNSUPPORTED",
                            f"v4l2 format {spec.format!r} not supported "
                            "(yuyv | nv12)", 400,
                        )
                    res = spec.resolution
                    source = V4l2Input(
                        V4l2InputOptions(
                            device_path=spec.path or spec.device_path
                            or "/dev/video0",
                            width=res.width if res else 1280,
                            height=res.height if res else 720,
                            framerate=spec.framerate,
                            format=(spec.format or "yuyv").lower(),
                        )
                    )
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
                    state.input_kinds[input_id] = "v4l2"
                    return {}
                if isinstance(spec, api.WhipInput):
                    import secrets

                    from smelter_tpu_torch.io.webrtc import WhipServerInput
                    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

                    token = spec.bearer_token or secrets.token_urlsafe(24)
                    # decoder_preferences restricts AND orders negotiation
                    # (reference offer_codec_filter.rs)
                    prefs = ((spec.video or {}).get("decoder_preferences")
                             or []) if spec.video else []
                    codec_map = {"ffmpeg_h264": "h264", "vulkan_h264": "h264",
                                 "ffmpeg_vp8": "vp8", "ffmpeg_vp9": "vp9",
                                 "ffmpeg_av1": "av1",
                                 "any": None}
                    codecs = []
                    for pref in prefs:
                        mapped = codec_map.get(str(pref), "")
                        if mapped is None:   # "any": no restriction
                            codecs = None
                            break
                        if mapped and mapped not in codecs:
                            codecs.append(mapped)
                    source = WhipServerInput(
                        bearer_token=token,
                        jitter_window_s=(spec.buffer_size_ms / 1000.0)
                        if spec.buffer_size_ms is not None else None,
                        video_codecs=codecs or None,
                    )
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
                    state.input_kinds[input_id] = "whip"
                    return {
                        "bearer_token": token,
                        "endpoint_route": f"/whip/{input_id}",
                    }
                if isinstance(spec, api.WhepInput):
                    from smelter_tpu_torch.io.webrtc import WhepClientInput
                    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

                    # decoder_preferences (reference whep.rs): first
                    # supported preference becomes the offered codec
                    prefs = ((spec.video or {}).get("decoder_preferences")
                             or []) if spec.video else []
                    codec = "h264"
                    for pref in prefs:
                        mapped = {"ffmpeg_h264": "h264", "vulkan_h264": "h264",
                                  "ffmpeg_vp8": "vp8", "ffmpeg_vp9": "vp9",
                                  "ffmpeg_av1": "av1"}.get(str(pref))
                        if mapped:
                            codec = mapped
                            break
                    source = WhepClientInput(
                        spec.endpoint_url, bearer_token=spec.bearer_token,
                        video_codec=codec,
                        jitter_window_s=(spec.buffer_size_ms / 1000.0)
                        if spec.buffer_size_ms is not None else None,
                    )
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
                    state.input_kinds[input_id] = "whep"
                    return {}
                if isinstance(spec, api.MoqServerInput):
                    from smelter_tpu_torch.io.moq.input import (
                        MoqServerInput as _MoqSrc,
                        MoqServerInputOptions,
                    )
                    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

                    server = state._start_moq_server()
                    source = _MoqSrc(MoqServerInputOptions(
                        auth_token=spec.auth_token,
                        decoder_map=spec.decoder_map,
                    ))
                    sc = spec.side_channel or {}
                    state.pipeline.register_input(
                        input_id,
                        source,
                        RegisterInputOptions(
                            required=bool(spec.required),
                            # no offset_ms: the reference MoqServerInput
                            # schema has none (input/moq_server.rs)
                            side_channel_video=bool(sc.get("video")),
                            side_channel_audio=bool(sc.get("audio")),
                            side_channel_dir=state.config.side_channel_socket_dir
                            or None,
                        ),
                    )
                    state.moq_state.register(input_id, source)
                    state.input_kinds[input_id] = "moq_server"
                    return {"port": server.port}
                if isinstance(spec, api.MoqClientInput):
                    from smelter_tpu_torch.io.moq.input import (
                        MoqClientInput as _MoqCli,
                        MoqClientInputOptions,
                    )
                    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

                    source = _MoqCli(MoqClientInputOptions(
                        endpoint_url=spec.endpoint_url,
                        broadcast_path=spec.broadcast_path,
                        decoder_map=spec.decoder_map,
                        verify_tls=not state.config.moq_disable_tls_verification,
                    ))
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
                            side_channel_dir=state.config.side_channel_socket_dir
                            or None,
                        ),
                    )
                    state.input_kinds[input_id] = "moq_client"
                    return {}
                raise NotImplementedError(
                    f"input protocol {spec.type!r} is not implemented yet"
                )

            result = await _run_blocking(do)
            return _json_ok(result)
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def unregister_input(request: web.Request) -> web.Response:
        input_id = request.match_info["id"]

        def do() -> None:
            state.pipeline.unregister_input(input_id)
            state.input_kinds.pop(input_id, None)
            if state.moq_state is not None:
                state.moq_state.unregister(input_id)

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
                if isinstance(spec, api.RtpOutput):
                    from smelter_tpu_torch.io.rtp import register_rtp_output

                    register_rtp_output(state.pipeline, output_id, spec)
                    state.output_kinds[output_id] = "rtp"
                    return {}
                if isinstance(spec, api.RtmpOutput):
                    from smelter_tpu_torch.io.rtmp import RtmpClientOutput

                    video = (
                        convert.output_video_options(spec.video, "rtmp")
                        if spec.video
                        else None
                    )
                    audio = (
                        convert.output_audio_options(spec.audio)
                        if spec.audio
                        else None
                    )
                    # rtmps:// cert verification is on by default; private
                    # deployments with self-signed endpoints can opt out
                    # (same spirit as FFmpeg's tls_verify)
                    insecure = os.environ.get(
                        "SMELTER_RTMPS_INSECURE", ""
                    ).lower() in ("1", "true", "yes")
                    sink = RtmpClientOutput(spec.url, tls_verify=not insecure)
                    state.pipeline.register_output(output_id, sink, video, audio)
                    state.output_kinds[output_id] = "rtmp"
                    return {}
                if isinstance(spec, api.MoqClientOutput):
                    from smelter_tpu_torch.io.moq import MoqClientOutput as _MoqSink

                    video = (
                        convert.output_video_options(spec.video, "moq")
                        if spec.video
                        else None
                    )
                    audio = (
                        convert.output_audio_options(spec.audio)
                        if spec.audio
                        else None
                    )
                    sink = _MoqSink(
                        spec.endpoint_url,
                        spec.broadcast_path,
                        container=spec.container or "cmaf",
                        has_video=video is not None,
                        has_audio=audio is not None,
                        verify_tls=not state.config.moq_disable_tls_verification,
                    )
                    state.pipeline.register_output(output_id, sink, video, audio)
                    state.output_kinds[output_id] = "moq_client"
                    return {}
                if isinstance(spec, (api.WhepOutput, api.WhipOutput)):
                    video = (
                        convert.whip_output_video_options(spec.video, "webrtc")
                        if spec.video
                        else None
                    )
                    audio = (
                        convert.whip_output_audio_options(spec.audio)
                        if spec.audio
                        else None
                    )
                    if video is not None:
                        extra = video.encoder.ffmpeg_options
                        import dataclasses

                        video.encoder = dataclasses.replace(
                            video.encoder,
                            ffmpeg_options=(extra + "," if extra else "")
                            + "global_header=0",
                        )
                    if audio is not None and audio.encoder.codec != "opus":
                        from smelter_tpu_torch.pipeline.output import AudioEncoderOptions

                        audio.encoder = AudioEncoderOptions(
                            codec="opus", sample_rate=48000
                        )
                    if isinstance(spec, api.WhepOutput):
                        import secrets

                        from smelter_tpu_torch.io.webrtc import WhepServerOutput

                        token = spec.bearer_token or secrets.token_urlsafe(24)
                        sink = WhepServerOutput(
                            bearer_token=token,
                            video_codec=(video.encoder.codec if video
                                         else "h264"),
                        )
                        state.pipeline.register_output(output_id, sink, video, audio)
                        state.output_kinds[output_id] = "whep"
                        return {
                            "bearer_token": token,
                            "endpoint_route": f"/whep/{output_id}",
                        }
                    from smelter_tpu_torch.io.webrtc import WhipClientOutput

                    sink = WhipClientOutput(
                        spec.endpoint_url, bearer_token=spec.bearer_token,
                        video_codec=(video.encoder.codec if video else "h264"),
                    )
                    state.pipeline.register_output(output_id, sink, video, audio)
                    state.output_kinds[output_id] = "whip"
                    return {}
                raise NotImplementedError(
                    f"output protocol {spec.type!r} is not implemented yet"
                )

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

    async def register_shader(request: web.Request) -> web.Response:
        shader_id = request.match_info["id"]
        try:
            body = await request.json()
            spec = api.ShaderSpec.model_validate(body)
            await _run_blocking(
                state.pipeline.renderer.register_shader, shader_id, spec.source
            )
            return _json_ok()
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def unregister_shader(request: web.Request) -> web.Response:
        shader_id = request.match_info["id"]
        try:
            when = await _unregister_schedule(request)
            if when is not None:
                _schedule_unregister(
                    state, when, f"shader {shader_id!r}",
                    lambda: state.pipeline.renderer.unregister_shader(shader_id),
                )
            else:
                await _run_blocking(
                    state.pipeline.renderer.unregister_shader, shader_id
                )
            return _json_ok()
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def register_image(request: web.Request) -> web.Response:
        image_id = request.match_info["id"]
        try:
            body = await request.json()
            spec = api.ImageSpec.model_validate(body)

            def do() -> None:
                state.pipeline.renderer.register_image(
                    image_id,
                    path=spec.path,
                    url=spec.url,
                    kind=None if spec.asset_type == "auto" else spec.asset_type,
                    resolution=(
                        (spec.resolution.width, spec.resolution.height)
                        if spec.resolution is not None else None
                    ),
                )

            await _run_blocking(do)
            return _json_ok()
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def unregister_image(request: web.Request) -> web.Response:
        image_id = request.match_info["id"]
        try:
            when = await _unregister_schedule(request)
            if when is not None:
                _schedule_unregister(
                    state, when, f"image {image_id!r}",
                    lambda: state.pipeline.renderer.unregister_image(image_id),
                )
            else:
                await _run_blocking(
                    state.pipeline.renderer.unregister_image, image_id
                )
            return _json_ok()
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def register_web_renderer(request: web.Request) -> web.Response:
        instance_id = request.match_info["id"]
        try:
            body = await request.json()
            spec = api.WebRendererSpec.model_validate(body)
            from smelter_tpu_torch.render.web import WebRendererSpec as _Spec

            def do() -> dict:
                inst = state.pipeline.renderer.web.register(_Spec(
                    instance_id=instance_id,
                    url=spec.url,
                    resolution=(spec.resolution.width, spec.resolution.height),
                    embedding_method=spec.embedding_method
                    or "chromium_embedding",
                ))
                # reference behavior: registration succeeds; without a
                # browser the instance renders transparent
                # (web_renderer_fallback.rs)
                return {"sidecar_active": inst.active}

            return _json_ok(await _run_blocking(do))
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def unregister_web_renderer(request: web.Request) -> web.Response:
        instance_id = request.match_info["id"]
        try:
            when = await _unregister_schedule(request)
            if when is not None:
                _schedule_unregister(
                    state, when, f"web renderer {instance_id!r}",
                    lambda: state.pipeline.renderer.web.unregister(instance_id),
                )
            else:
                await _run_blocking(
                    state.pipeline.renderer.web.unregister, instance_id
                )
            return _json_ok()
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def register_font(request: web.Request) -> web.Response:
        try:
            body = await request.json()
            spec = api.FontSpec.model_validate(body)
            from smelter_tpu_torch.render.text import register_font

            await _run_blocking(register_font, spec.path or spec.url)
            return _json_ok()
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

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

    async def whip_endpoint(request: web.Request) -> web.Response:
        input_id = request.match_info["id"]
        try:
            from smelter_tpu_torch.io.webrtc import WhipServerInput

            source = state.pipeline._inputs.get(input_id)
            if not isinstance(source, WhipServerInput):
                return _error_response(
                    ApiError("INPUT_STREAM_NOT_FOUND",
                             f"No WHIP input \"{input_id}\".", 404)
                )
            if source.bearer_token:
                auth = request.headers.get("Authorization", "")
                if auth != f"Bearer {source.bearer_token}":
                    return _error_response(
                        ApiError("UNAUTHORIZED", "invalid bearer token", 401)
                    )
            offer = (await request.read()).decode()
            answer = await _run_blocking(source.handle_offer, offer)
            return web.Response(
                status=201,
                content_type="application/sdp",
                text=answer,
                headers={"Location": f"/whip/{input_id}/session"},
            )
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def whip_session(request: web.Request) -> web.Response:
        input_id = request.match_info["id"]
        from smelter_tpu_torch.io.webrtc import WhipServerInput

        source = state.pipeline._inputs.get(input_id)
        if not isinstance(source, WhipServerInput):
            return web.Response(status=404)
        if request.method == "DELETE":
            await _run_blocking(source.disconnect)
            return web.Response(status=200)
        # trickle-ICE PATCH (RFC 8840 sdpfrag): feed late remote candidates
        # to the live session (reference webrtc/trickle_ice_utils.rs)
        from smelter_tpu_torch.io.webrtc import sdp as _sdp

        body = (await request.read()).decode(errors="replace")
        cands = _sdp.parse_candidate_fragment(body)
        if cands and source.session is not None:
            source.session.add_remote_candidates(cands)
        return web.Response(status=204)

    async def whep_endpoint(request: web.Request) -> web.Response:
        output_id = request.match_info["id"]
        try:
            from smelter_tpu_torch.io.webrtc import WhepServerOutput

            out = state.pipeline._outputs.get(output_id)
            sink = out.sink if out else None
            if not isinstance(sink, WhepServerOutput):
                return _error_response(
                    ApiError("OUTPUT_STREAM_NOT_FOUND",
                             f"No WHEP output \"{output_id}\".", 404)
                )
            if sink.bearer_token:
                auth = request.headers.get("Authorization", "")
                if auth != f"Bearer {sink.bearer_token}":
                    return _error_response(
                        ApiError("UNAUTHORIZED", "invalid bearer token", 401)
                    )
            offer = (await request.read()).decode()
            answer = await _run_blocking(sink.handle_offer, offer)
            return web.Response(
                status=201,
                content_type="application/sdp",
                text=answer,
                headers={"Location": f"/whep/{output_id}/session"},
            )
        except Exception as exc:  # noqa: BLE001
            return _error_response(exc)

    async def whep_session(request: web.Request) -> web.Response:
        output_id = request.match_info["id"]
        from smelter_tpu_torch.io.webrtc import WhepServerOutput

        out = state.pipeline._outputs.get(output_id)
        sink = out.sink if out else None
        if not isinstance(sink, WhepServerOutput):
            return web.Response(status=404)
        if request.method == "DELETE":
            await _run_blocking(sink.detach)
            return web.Response(status=200)
        from smelter_tpu_torch.io.webrtc import sdp as _sdp

        body = (await request.read()).decode(errors="replace")
        cands = _sdp.parse_candidate_fragment(body)
        if cands and sink.session is not None:
            sink.session.add_remote_candidates(cands)
        return web.Response(status=204)

    # WHIP/WHEP signaling rides the main API port AND, like the reference's
    # dedicated WhipWhepServer (SMELTER_WHIP_WHEP_SERVER_PORT), a second
    # listener when enabled (run() binds `app["whip_app"]` there)
    whip_routers = [app.router]
    if state.config.start_whip_whep_server:
        whip_app = web.Application(client_max_size=50 * 1024 * 1024)
        app["whip_app"] = whip_app
        whip_routers.append(whip_app.router)
    for router in whip_routers:
        router.add_post("/whip/{id}", whip_endpoint)
        router.add_route("PATCH", "/whip/{id}/session", whip_session)
        router.add_route("DELETE", "/whip/{id}/session", whip_session)
        router.add_post("/whep/{id}", whep_endpoint)
        router.add_route("PATCH", "/whep/{id}/session", whep_session)
        router.add_route("DELETE", "/whep/{id}/session", whep_session)
    app.router.add_post("/api/input/{id}/register", register_input)
    app.router.add_post("/api/input/{id}/unregister", unregister_input)
    app.router.add_post("/api/input/{id}/update", update_input)
    app.router.add_post("/api/output/{id}/register", register_output)
    app.router.add_post("/api/output/{id}/unregister", unregister_output)
    app.router.add_post("/api/output/{id}/update", update_output)
    app.router.add_post("/api/output/{id}/request_keyframe", request_keyframe)
    app.router.add_post("/api/shader/{id}/register", register_shader)
    app.router.add_post("/api/shader/{id}/unregister", unregister_shader)
    app.router.add_post("/api/image/{id}/register", register_image)
    app.router.add_post("/api/image/{id}/unregister", unregister_image)
    app.router.add_post("/api/web-renderer/{id}/register", register_web_renderer)
    app.router.add_post("/api/web-renderer/{id}/unregister", unregister_web_renderer)
    app.router.add_post("/api/font/register", register_font)
    app.router.add_post("/api/start", start)
    app.router.add_post("/api/reset", reset)
    async def preview(request: web.Request) -> web.Response:
        """Self-contained WHEP preview page for an output (the thin browser
        client replacing the reference's in-browser WASM rendering layer
        for server deployments — docs/BROWSER_RENDERING.md)."""
        output_id = request.match_info["id"]
        import html as _html
        import importlib.resources as _res

        page = (_res.files("smelter_tpu_torch.server") / "preview.html").read_text()
        safe = _html.escape(output_id, quote=True).replace("</", "<\\/")
        return web.Response(
            content_type="text/html", text=page.replace("__OUTPUT_ID__", safe)
        )

    app.router.add_get("/status", status)
    app.router.add_get("/stats", stats)
    app.router.add_get("/ws", ws_handler)
    app.router.add_get("/preview/{id}", preview)
    return app


def run(config: Optional[Config] = None) -> None:
    """Serve the API on the configured port (and the WHIP/WHEP endpoints on
    their own port too when `start_whip_whep_server`). `Config.xla_debug`
    arms the debug mode (`config.apply_xla_debug`), as in the reference."""
    cfg = config or read_config()
    from smelter_tpu_torch.config import apply_xla_debug, init_logger

    init_logger(cfg.logger)
    apply_xla_debug(cfg.xla_debug)
    state = ApiState(cfg)
    app = build_app(state)
    whip_app = app.get("whip_app")
    if whip_app is not None:
        async def _start_whip_server(_app):
            runner = web.AppRunner(whip_app)
            await runner.setup()
            site = web.TCPSite(runner, port=cfg.whip_whep_server_port)
            await site.start()
            logger.info("WHIP/WHEP server listening on :%d",
                        cfg.whip_whep_server_port)

        app.on_startup.append(_start_whip_server)
    logger.info("smelter_tpu_torch listening on :%d", cfg.api_port)
    web.run_app(app, port=cfg.api_port, print=None)
