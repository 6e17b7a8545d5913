"""Env-var configuration (reference `src/config.rs:17-59,96-390`).

Same `SMELTER_*` variable names and defaults and the same fields, so that
`/status` reports the reference's configuration block; knobs the port has no
use for are accepted but ignored so existing deployments' env files keep
working. Not ported (ROADMAP "Do not port"): the XLA kernel guard
(`force_xla_kernels`) and the XLA compile cache (`apply_compile_cache`).
`SMELTER_XLA_DEBUG` arms the port's counterpart of the reference's debug
mode (`apply_xla_debug`, `check_finite`).
"""

from __future__ import annotations

import logging
import os
import uuid
from dataclasses import dataclass, field

from typing import Optional

import torch

from smelter_tpu_torch.core.types import Framerate
from smelter_tpu_torch.render.capture import in_program


def _env_bool(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    return int(v) if v else default


def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return float(v) if v else default


def _env_port(name: str) -> Optional[int]:
    """Optional port; invalid values warn and fall back to None
    (reference config.rs:294-304 inspect_err + ok)."""
    v = os.environ.get(name)
    if not v:
        return None
    try:
        port = int(v)
        if not 0 < port < 65536:
            raise ValueError(port)
        return port
    except ValueError:
        logging.getLogger("smelter.config").warning(
            "CONFIG ERROR: %s has to be valid port number", name
        )
        return None


def _env_port_range(name: str) -> Optional[tuple]:
    """"START:END" with START < END; invalid values warn and fall back to
    None (reference config.rs:283-292 + port_range_from_str:510-519)."""
    v = os.environ.get(name)
    if not v:
        return None
    try:
        start_s, end_s = v.split(":", 1)
        start, end = int(start_s), int(end_s)
        if not (0 < start < end < 65536):
            raise ValueError(v)
        return (start, end)
    except ValueError:
        logging.getLogger("smelter.config").warning(
            'CONFIG ERROR: "%s" is not a valid port range for %s: '
            'Port range needs to be in the "START:END" format, where '
            "START < END.", v, name,
        )
        return None


def _env_framerate(name: str, default: Framerate) -> Framerate:
    """Accepts "30" or "30000/1001" (reference config.rs framerate parsing)."""
    v = os.environ.get(name)
    if not v:
        return default
    if "/" in v:
        num, den = v.split("/", 1)
        return Framerate(int(num), int(den))
    return Framerate(int(v))


@dataclass
class LoggerConfig:
    level: str = "info"
    format: str = "compact"   # json | compact | pretty
    log_file: Optional[str] = None
    # per-sink overrides (reference config.rs:170-176: SMELTER_LOGGER_LEVEL
    # is the base, SMELTER_STDIO_LOGGER_LEVEL / SMELTER_FILE_LOGGER_LEVEL
    # refine the stdout and file sinks independently)
    stdio_level: Optional[str] = None
    file_level: Optional[str] = None


@dataclass
class Config:
    instance_id: str = ""
    api_port: int = 8081
    output_framerate: Framerate = Framerate(30)
    mixing_sample_rate: int = 48000
    ahead_of_time_processing: bool = False
    never_drop_output_frames: bool = False
    run_late_scheduled_events: bool = False
    offline_processing: bool = False
    stream_fallback_timeout: float = 0.5        # seconds
    input_buffer_duration: Optional[float] = None
    download_dir: str = ""
    side_channel_socket_dir: str = ""
    max_layouts_count: int = 100
    load_system_fonts: bool = True
    web_renderer_enable: bool = False
    start_whip_whep_server: bool = False
    whip_whep_server_port: int = 9000
    start_rtmp_server: bool = False
    rtmp_server_port: int = 1935
    rtmp_tls_cert_file: str = ""
    rtmp_tls_key_file: str = ""
    # WebRTC UDP strategy (reference config.rs:283-316 + webrtc/
    # setting_engine.rs): mux all sessions on one port, or restrict
    # ephemeral session sockets to a range; mux wins when both are set
    webrtc_udp_mux_port: Optional[int] = None
    webrtc_udp_port_range: Optional[tuple] = None
    webrtc_nat_1to1_ips: tuple = ()
    start_moq_server: bool = False
    moq_server_port: int = 9001
    moq_disable_tls_verification: bool = False
    moq_tls_cert_file: str = ""
    moq_tls_key_file: str = ""
    # the reference's debug mode (its jax NaN/inf checks): `apply_xla_debug`
    xla_debug: bool = False
    logger: LoggerConfig = field(default_factory=LoggerConfig)


# the debug mode is process-wide, as the jax flags it stands for
_debug_nans_infs = False


def apply_xla_debug(enabled: bool) -> None:
    """The reference's debug mode (`SMELTER_XLA_DEBUG`), as it behaves: it
    arms jax's NaN/Inf checks, which raise FloatingPointError when a float
    result of a jitted function, called from the top level, holds NaN or
    Inf. Here, from this call on in the process, `check_finite` raises on
    the float results of the port's counterparts of those functions (the
    kernels K1 and K3) and on a canvas handed to the YUV420 output, when
    they are called outside a frame program. A frame program returns u8
    planes, which no check sees in either package: a shader that yields NaN
    still renders a frame, and a replay makes no synchronising call.
    `False` leaves the mode as it is, as in the reference. The checks
    synchronise with the card: a debugging mode only."""
    global _debug_nans_infs
    if enabled:
        _debug_nans_infs = True


def check_finite(t: torch.Tensor, where: str) -> torch.Tensor:
    """Raise FloatingPointError naming `where`, as jax's NaN/Inf checks do,
    when the debug mode is on, the caller runs outside a frame program
    (`render.capture.in_program`) and the float tensor `t` holds NaN or
    Inf. Returns `t`."""
    if not _debug_nans_infs or in_program() or not t.is_floating_point():
        return t
    for kind, bad in (("nan", torch.isnan), ("inf", torch.isinf)):
        if bool(bad(t).any()):
            raise FloatingPointError(f"invalid value ({kind}) encountered in {where}")
    return t


def read_config() -> Config:
    offline = _env_bool("SMELTER_OFFLINE_PROCESSING_ENABLE", False)
    # offline processing implies AOT + never-drop (reference config.rs:210-226)
    aot = _env_bool("SMELTER_AHEAD_OF_TIME_PROCESSING_ENABLE", offline)
    never_drop = _env_bool("SMELTER_NEVER_DROP_OUTPUT_FRAMES", offline)
    buffer_ms = os.environ.get("SMELTER_INPUT_BUFFER_DURATION_MS")
    cfg = Config(
        instance_id=os.environ.get(
            "SMELTER_INSTANCE_ID", f"smelter_tpu_torch-{uuid.uuid4().hex[:12]}"
        ),
        api_port=_env_int("SMELTER_API_PORT", 8081),
        output_framerate=_env_framerate("SMELTER_OUTPUT_FRAMERATE", Framerate(30)),
        mixing_sample_rate=_env_int("SMELTER_MIXING_SAMPLE_RATE", 48000),
        ahead_of_time_processing=aot,
        never_drop_output_frames=never_drop,
        run_late_scheduled_events=_env_bool("SMELTER_RUN_LATE_SCHEDULED_EVENTS", offline),
        offline_processing=offline,
        stream_fallback_timeout=_env_float("SMELTER_STREAM_FALLBACK_TIMEOUT_MS", 500.0)
        / 1000.0,
        input_buffer_duration=float(buffer_ms) / 1000.0 if buffer_ms else None,
        download_dir=os.environ.get("SMELTER_DOWNLOAD_DIR", ""),
        side_channel_socket_dir=os.environ.get("SMELTER_SIDE_CHANNEL_SOCKET_DIR", ""),
        max_layouts_count=_env_int("SMELTER_RENDER_MAX_LAYOUTS_COUNT", 100),
        load_system_fonts=_env_bool("SMELTER_LOAD_SYSTEM_FONTS", True),
        web_renderer_enable=_env_bool("SMELTER_WEB_RENDERER_ENABLE", False),
        start_whip_whep_server=_env_bool("SMELTER_START_WHIP_WHEP_SERVER", False),
        whip_whep_server_port=_env_int("SMELTER_WHIP_WHEP_SERVER_PORT", 9000),
        start_rtmp_server=_env_bool("SMELTER_START_RTMP_SERVER", False),
        rtmp_server_port=_env_int("SMELTER_RTMP_SERVER_PORT", 1935),
        rtmp_tls_cert_file=os.environ.get("SMELTER_RTMP_TLS_CERT_FILE", ""),
        rtmp_tls_key_file=os.environ.get("SMELTER_RTMP_TLS_KEY_FILE", ""),
        webrtc_udp_mux_port=_env_port("SMELTER_WEBRTC_UDP_MUX_PORT"),
        webrtc_udp_port_range=_env_port_range("SMELTER_WEBRTC_UDP_PORT_RANGE"),
        webrtc_nat_1to1_ips=tuple(
            ip.strip()
            for ip in os.environ.get("SMELTER_WEBRTC_1_TO_1_NAT_IPS", "").split(",")
            if ip.strip()
        ),
        start_moq_server=_env_bool("SMELTER_START_MOQ_SERVER", False),
        moq_server_port=_env_int("SMELTER_MOQ_SERVER_PORT", 9001),
        moq_disable_tls_verification=_env_bool(
            "SMELTER_MOQ_DISABLE_TLS_VERIFICATION", False
        ),
        moq_tls_cert_file=os.environ.get("SMELTER_MOQ_TLS_CERT_FILE", ""),
        moq_tls_key_file=os.environ.get("SMELTER_MOQ_TLS_KEY_FILE", ""),
        xla_debug=_env_bool("SMELTER_XLA_DEBUG", False),
        logger=LoggerConfig(
            level=os.environ.get("SMELTER_LOGGER_LEVEL", "info"),
            format=os.environ.get("SMELTER_LOGGER_FORMAT", "compact"),
            log_file=os.environ.get("SMELTER_LOG_FILE"),
            stdio_level=os.environ.get("SMELTER_STDIO_LOGGER_LEVEL"),
            file_level=os.environ.get("SMELTER_FILE_LOGGER_LEVEL"),
        ),
    )
    if cfg.webrtc_udp_mux_port is not None and cfg.webrtc_udp_port_range:
        logging.getLogger("smelter.config").warning(
            'CONFIG ERROR: Options "SMELTER_WEBRTC_UDP_MUX_PORT" and '
            '"SMELTER_WEBRTC_UDP_PORT_RANGE" are conflicting. Ignoring '
            '"SMELTER_WEBRTC_UDP_PORT_RANGE"'
        )
        cfg.webrtc_udp_port_range = None
    return cfg


def init_logger(cfg: LoggerConfig) -> None:
    """Structured logging setup (reference `src/logger.rs`); the stdio and
    file sinks take SMELTER_STDIO_LOGGER_LEVEL / SMELTER_FILE_LOGGER_LEVEL
    refinements over the base level (config.rs:170-176)."""

    def _level(name: Optional[str], fallback: int) -> int:
        if not name:
            return fallback
        return getattr(logging, name.upper(), fallback)

    level = _level(cfg.level, logging.INFO)
    stdio = logging.StreamHandler()
    stdio.setLevel(_level(cfg.stdio_level, level))
    handlers: list = [stdio]
    if cfg.log_file:
        fh = logging.FileHandler(cfg.log_file)
        fh.setLevel(_level(cfg.file_level, level))
        handlers.append(fh)
    # the root logger must pass records through to the most verbose sink
    level = min([level] + [h.level for h in handlers])
    if cfg.format == "json":
        fmt = (
            '{"ts":"%(asctime)s","level":"%(levelname)s",'
            '"target":"%(name)s","msg":"%(message)s"}'
        )
    elif cfg.format == "pretty":
        fmt = "%(asctime)s %(levelname)-8s %(name)s\n    %(message)s"
    else:
        fmt = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
    logging.basicConfig(level=level, format=fmt, handlers=handlers, force=True)
