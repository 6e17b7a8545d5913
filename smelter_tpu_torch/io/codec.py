"""ctypes bindings for the native smelter_io codec/container service.

Python-facing wrapper over ``native/libsmelter_io.so`` (FFmpeg-based). This is
the port's copy of the reference's codec layer
(`smelter-core/src/pipeline/{decoder,encoder}/ffmpeg_*.rs` and
`pipeline/{mp4,hls}/`): decode/encode/demux/mux run in native code on the
host; decoded YUV420 frames go to numpy, and from there to the card in the
renderer's pinned upload.

The port never writes under `native/`: it loads the committed
``native/libsmelter_io.so``. Where that library is missing, or older than
its source, the source in ``native/smelter_io/`` is compiled into the
git-ignored ``smelter_tpu_torch/_build/`` (named by a hash of the source
and the flags) and that library is loaded. A library that cannot load (the
FFmpeg shared libraries absent, say) raises with the loader's message.
"""

from __future__ import annotations

import ctypes
import enum
import hashlib
import os
import subprocess
import tempfile
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsmelter_io.so")
_SRC_DIR = os.path.join(_NATIVE_DIR, "smelter_io")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# the flags and libraries of native/Makefile's libsmelter_io.so rule
_CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
_LD_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lswresample")

_lib = None
_lib_lock = threading.Lock()

#: 4 MB packet staging buffer (larger than any sane AU at 4K).
_PKT_CAP = 4 * 1024 * 1024


class Codec(enum.IntEnum):
    UNKNOWN = 0
    H264 = 1
    H265 = 2
    VP8 = 3
    VP9 = 4
    AV1 = 5
    AAC = 10
    OPUS = 11

    @classmethod
    def from_name(cls, name: str) -> "Codec":
        return {
            "h264": cls.H264,
            "h265": cls.H265,
            "hevc": cls.H265,
            "vp8": cls.VP8,
            "vp9": cls.VP9,
            "av1": cls.AV1,
            "aac": cls.AAC,
            "opus": cls.OPUS,
        }[name.lower()]


PKT_KEYFRAME = 1
PKT_CORRUPT = 2


class _StreamInfoC(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_int32),
        ("media_type", ctypes.c_int32),
        ("codec", ctypes.c_int32),
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("duration_s", ctypes.c_double),
        ("fps", ctypes.c_double),
        ("extradata_size", ctypes.c_int32),
    ]


@dataclass
class StreamInfo:
    index: int
    media_type: str  # "video" | "audio" | "other"
    codec: Codec
    width: int
    height: int
    sample_rate: int
    channels: int
    duration_s: Optional[float]
    fps: Optional[float]
    extradata: bytes


@dataclass
class Packet:
    stream_index: int
    data: bytes
    pts_s: Optional[float]
    dts_s: Optional[float]
    is_keyframe: bool
    is_corrupt: bool = False


def _build_lib() -> str:
    """Compile native/smelter_io/ into _build/ (never under native/) and
    return the library's path; an unchanged source reuses its library."""
    src = os.path.join(_SRC_DIR, "smelter_io.cpp")
    h = hashlib.sha256(" ".join(_CXX_FLAGS + _LD_LIBS).encode())
    for name in ("smelter_io.cpp", "smelter_io.h"):
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    lib = os.path.join(_BUILD_DIR, f"libsmelter_io-{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, os.path.basename(lib))
        cmd = [os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", tmp, src, *_LD_LIBS]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(
                f"building the codec service failed ({out.returncode}): "
                f"{' '.join(cmd)}\n{out.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib


def _library_path() -> str:
    """The committed library unless it is missing or older than its source
    (the reference's rule), else one built into _build/."""
    src = os.path.join(_SRC_DIR, "smelter_io.cpp")
    if os.path.exists(_LIB_PATH) and not (
        os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)
    ):
        return _LIB_PATH
    return _build_lib()


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            raise RuntimeError(f"the codec service {path} cannot load: {exc}") from exc
        lib.sm_last_error.restype = ctypes.c_char_p
        lib.sm_caps.restype = ctypes.c_uint32
        lib.sm_demux_open.argtypes = [ctypes.c_char_p]
        lib.sm_demux_open2.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.sm_demux_interrupt.argtypes = [ctypes.c_int]
        lib.sm_demux_is_live.argtypes = [ctypes.c_int]
        lib.sm_demux_read.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.c_int32,
        ]
        lib.sm_demux_seek.argtypes = [ctypes.c_int, ctypes.c_double]
        lib.sm_vdec_new.argtypes = [ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]
        lib.sm_vdec_send.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int32, ctypes.c_double,
        ]
        lib.sm_vdec_receive.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.sm_adec_new.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.sm_adec_send.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int32, ctypes.c_double,
        ]
        lib.sm_adec_receive.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.sm_venc_new.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_char_p,
        ]
        lib.sm_venc_send.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_double, ctypes.c_int32,
        ]
        lib.sm_venc_receive.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.c_int32,
        ]
        lib.sm_venc_extradata.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int32]
        lib.sm_aenc_new.argtypes = [
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_char_p,
        ]
        lib.sm_aenc_extradata.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int32]
        lib.sm_aenc_send.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int32, ctypes.c_double,
        ]
        lib.sm_aenc_receive.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p,
            ctypes.c_int32,
        ]
        lib.sm_mux_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.sm_mux_add_video.argtypes = [
            ctypes.c_int, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.sm_mux_add_audio.argtypes = [
            ctypes.c_int, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.sm_mux_write.argtypes = [
            ctypes.c_int, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_double, ctypes.c_double, ctypes.c_int32,
        ]
        lib.sm_set_log_level(_ffmpeg_log_level())
        _lib = lib
        return lib


def _ffmpeg_log_level() -> int:
    """SMELTER_FFMPEG_LOGGER_LEVEL bridge to the native FFmpeg service
    (reference `src/config.rs:189-194` FfmpegLogLevel, default warn)."""
    levels = {
        "error": 16,   # AV_LOG_ERROR
        "warn": 24,    # AV_LOG_WARNING
        "info": 32,    # AV_LOG_INFO
        "debug": 48,   # AV_LOG_DEBUG
    }
    name = os.environ.get("SMELTER_FFMPEG_LOGGER_LEVEL", "").strip().lower()
    return levels.get(name, levels["warn"])


class CodecError(RuntimeError):
    pass


def _check(ret: int, lib) -> int:
    if ret == -2:
        raise CodecError(lib.sm_last_error().decode("utf-8", "replace"))
    return ret


def caps() -> dict:
    lib = _load()
    c = lib.sm_caps()
    return {
        "h264_decode": bool(c & 1),
        "h264_encode": bool(c & 2),
        "vp8": bool(c & 4),
        "vp9": bool(c & 8),
        "aac_decode": bool(c & 16),
        "aac_encode": bool(c & 32),
        "opus_decode": bool(c & 64),
        "opus_encode": bool(c & 128),
    }


_NO_PTS = -1e18


def _opt_pts(v: float) -> Optional[float]:
    return None if v <= -1e17 else v


class Demuxer:
    """Container demuxer (MP4/HLS/TS/anything FFmpeg opens).

    Mirrors the read side of the reference's `mp4/reader.rs` / `hls_input.rs`.
    """

    def __init__(self, url: str, options: Optional[Dict[str, str]] = None) -> None:
        """``options`` is an FFmpeg protocol-options dictionary (the
        reference passes protocol_whitelist etc. for HLS, hls_input.rs:557);
        passing any options also arms the interrupt callback."""
        self._lib = _load()
        if options:
            opts = "\n".join(f"{k}={v}" for k, v in options.items())
            self._h = _check(
                self._lib.sm_demux_open2(url.encode(), opts.encode()), self._lib
            )
        else:
            self._h = _check(self._lib.sm_demux_open(url.encode()), self._lib)
        if self._h < 0:
            raise CodecError(self._lib.sm_last_error().decode())
        self._buf = ctypes.create_string_buffer(_PKT_CAP)

    def interrupt(self) -> None:
        """Abort any blocking network read (thread-safe; the reference's
        interrupt callback, hls_input.rs:583-605). Subsequent reads EOF."""
        if self._h >= 0:
            self._lib.sm_demux_interrupt(self._h)

    def is_live(self) -> bool:
        """True when the container reports no duration (live playlist)."""
        return self._h >= 0 and self._lib.sm_demux_is_live(self._h) == 1

    def streams(self) -> List[StreamInfo]:
        n = _check(self._lib.sm_demux_nb_streams(self._h), self._lib)
        out = []
        for i in range(n):
            info = _StreamInfoC()
            _check(self._lib.sm_demux_stream_info(self._h, i, ctypes.byref(info)), self._lib)
            extradata = b""
            if info.extradata_size > 0:
                ebuf = ctypes.create_string_buffer(info.extradata_size)
                got = _check(
                    self._lib.sm_demux_extradata(self._h, i, ebuf, info.extradata_size),
                    self._lib,
                )
                extradata = ebuf.raw[:got]
            out.append(
                StreamInfo(
                    index=info.index,
                    media_type={0: "video", 1: "audio"}.get(info.media_type, "other"),
                    codec=Codec(info.codec) if info.codec in Codec._value2member_map_ else Codec.UNKNOWN,
                    width=info.width,
                    height=info.height,
                    sample_rate=info.sample_rate,
                    channels=info.channels,
                    duration_s=info.duration_s if info.duration_s >= 0 else None,
                    fps=info.fps if info.fps > 0 else None,
                    extradata=extradata,
                )
            )
        return out

    def read(self) -> Optional[Packet]:
        """Next packet, or None at EOF."""
        si = ctypes.c_int32()
        pts = ctypes.c_double()
        dts = ctypes.c_double()
        flags = ctypes.c_int32()
        ret = self._lib.sm_demux_read(
            self._h, ctypes.byref(si), ctypes.byref(pts), ctypes.byref(dts),
            ctypes.byref(flags), self._buf, _PKT_CAP,
        )
        if ret == -1:
            return None
        _check(ret, self._lib)
        return Packet(
            stream_index=si.value,
            data=self._buf.raw[: ret],
            pts_s=_opt_pts(pts.value),
            dts_s=_opt_pts(dts.value),
            is_keyframe=bool(flags.value & PKT_KEYFRAME),
            is_corrupt=bool(flags.value & PKT_CORRUPT),
        )

    def seek(self, pts_s: float) -> None:
        _check(self._lib.sm_demux_seek(self._h, pts_s), self._lib)

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sm_demux_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class VideoDecoder:
    """H.264/H.265/VP8/VP9 decoder → YUV420 numpy planes.

    Matches the reference decoder trait contract
    (`smelter-core/src/pipeline/decoder.rs:48-60`).
    """

    def __init__(self, codec: Codec, extradata: bytes = b"") -> None:
        self._lib = _load()
        self._h = _check(
            self._lib.sm_vdec_new(int(codec), extradata, len(extradata)), self._lib
        )
        self._cap = 0
        self._buf = None

    def send(self, data: bytes, pts_s: float) -> None:
        from smelter_tpu_torch.utils import tracing

        with tracing.span("codec.video_decode"):
            _check(
                self._lib.sm_vdec_send(self._h, data, len(data), pts_s),
                self._lib,
            )

    def send_eof(self) -> None:
        _check(self._lib.sm_vdec_send_eof(self._h), self._lib)

    def receive(self) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[float], object]]:
        """Poll one frame: (y, u, v, pts_s, 'frame') or None (need input) or 'eof'."""
        if self._buf is None:
            self._cap = 3840 * 2176 * 3 // 2
            self._buf = np.empty(self._cap, dtype=np.uint8)
        w = ctypes.c_int32()
        h = ctypes.c_int32()
        pts = ctypes.c_double()
        ret = self._lib.sm_vdec_receive(
            self._h, ctypes.byref(w), ctypes.byref(h), ctypes.byref(pts),
            self._buf.ctypes.data_as(ctypes.c_void_p), self._cap,
        )
        if ret == 0:
            return None
        if ret == -1:
            return "eof"  # type: ignore[return-value]
        _check(ret, self._lib)
        W, H = w.value, h.value
        ysz, csz = W * H, (W // 2) * (H // 2)
        y = self._buf[:ysz].reshape(H, W).copy()
        u = self._buf[ysz : ysz + csz].reshape(H // 2, W // 2).copy()
        v = self._buf[ysz + csz : ysz + 2 * csz].reshape(H // 2, W // 2).copy()
        return (y, u, v, _opt_pts(pts.value), "frame")

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sm_vdec_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AudioDecoder:
    """AAC/Opus decoder → interleaved f32 numpy at a fixed output rate."""

    def __init__(
        self,
        codec: Codec,
        out_sample_rate: int = 48000,
        out_channels: int = 2,
        extradata: bytes = b"",
        in_sample_rate: int = 0,
        in_channels: int = 0,
    ) -> None:
        self._lib = _load()
        self._h = _check(
            self._lib.sm_adec_new(
                int(codec), out_sample_rate, out_channels,
                extradata, len(extradata), in_sample_rate, in_channels,
            ),
            self._lib,
        )
        self.out_sample_rate = out_sample_rate
        self.out_channels = out_channels
        self._buf = np.empty(48000 * out_channels, dtype=np.float32)

    def send(self, data: bytes, pts_s: float) -> None:
        _check(self._lib.sm_adec_send(self._h, data, len(data), pts_s), self._lib)

    def send_eof(self) -> None:
        _check(self._lib.sm_adec_send_eof(self._h), self._lib)

    def receive(self):
        """(samples f32 [n, ch], pts_s) | None | 'eof'."""
        pts = ctypes.c_double()
        ret = self._lib.sm_adec_receive(
            self._h, ctypes.byref(pts),
            self._buf.ctypes.data_as(ctypes.c_void_p),
            len(self._buf) // self.out_channels,
        )
        if ret == 0:
            return None
        if ret == -1:
            return "eof"
        _check(ret, self._lib)
        samples = self._buf[: ret * self.out_channels].reshape(ret, self.out_channels).copy()
        return (samples, _opt_pts(pts.value))

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sm_adec_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class VideoEncoder:
    """x264 / VP8 / VP9 encoder, YUV420 numpy in → packets out.

    Matches the reference encoder trait contract
    (`smelter-core/src/pipeline/encoder.rs:35-65`), incl. keyframe requests.
    """

    def __init__(
        self,
        codec: Codec,
        width: int,
        height: int,
        fps_num: int,
        fps_den: int = 1,
        preset: str = "ultrafast",
        bitrate: int = 0,
        opts: str = "",
        pix_fmt: str = "yuv420p",   # yuv420p | yuv422p | yuv444p
    ) -> None:
        self._lib = _load()
        if pix_fmt != "yuv420p":
            opts = (opts + "," if opts else "") + f"pix_fmt={pix_fmt}"
        self._h = _check(
            self._lib.sm_venc_new(
                int(codec), width, height, fps_num, fps_den,
                preset.encode(), bitrate, opts.encode(),
            ),
            self._lib,
        )
        self.width, self.height = width, height
        self.pix_fmt = pix_fmt
        self._cw = width // 2 if pix_fmt in ("yuv420p", "yuv422p") else width
        self._chh = height // 2 if pix_fmt == "yuv420p" else height
        self._buf = ctypes.create_string_buffer(_PKT_CAP)
        self._stage = np.empty(
            width * height + 2 * self._cw * self._chh, dtype=np.uint8
        )
        self._pending: list = []  # packets drained while retrying EAGAIN sends

    def extradata(self) -> bytes:
        got = _check(self._lib.sm_venc_extradata(self._h, self._buf, _PKT_CAP), self._lib)
        return self._buf.raw[:got]

    def _drain_pending(self) -> None:
        while True:
            pkt = self._receive_raw()
            if pkt is None or pkt == "eof":
                return
            self._pending.append(pkt)

    def send(self, y: np.ndarray, u: np.ndarray, v: np.ndarray, pts_s: float,
             force_keyframe: bool = False) -> None:
        from smelter_tpu_torch.utils import tracing

        with tracing.span("codec.video_encode"):
            self._send(y, u, v, pts_s, force_keyframe)

    def _send(self, y: np.ndarray, u: np.ndarray, v: np.ndarray, pts_s: float,
              force_keyframe: bool = False) -> None:
        ysz = self.width * self.height
        csz = self._cw * self._chh
        self._stage[:ysz] = np.ascontiguousarray(y, dtype=np.uint8).ravel()
        self._stage[ysz : ysz + csz] = np.ascontiguousarray(u, dtype=np.uint8).ravel()
        self._stage[ysz + csz :] = np.ascontiguousarray(v, dtype=np.uint8).ravel()
        while True:
            ret = _check(
                self._lib.sm_venc_send(
                    self._h, self._stage.ctypes.data_as(ctypes.c_void_p),
                    pts_s, 1 if force_keyframe else 0,
                ),
                self._lib,
            )
            if ret != 1:
                return
            self._drain_pending()

    def send_eof(self) -> None:
        # drain first: x264 may require receive before accepting the flush
        self._drain_pending()
        _check(self._lib.sm_venc_send_eof(self._h), self._lib)

    def _receive_raw(self):
        pts = ctypes.c_double()
        dts = ctypes.c_double()
        flags = ctypes.c_int32()
        ret = self._lib.sm_venc_receive(
            self._h, ctypes.byref(pts), ctypes.byref(dts), ctypes.byref(flags),
            self._buf, _PKT_CAP,
        )
        if ret == 0:
            return None
        if ret == -1:
            return "eof"
        _check(ret, self._lib)
        return Packet(
            stream_index=0,
            data=self._buf.raw[: ret],
            pts_s=_opt_pts(pts.value),
            dts_s=_opt_pts(dts.value),
            is_keyframe=bool(flags.value & PKT_KEYFRAME),
        )

    def receive(self):
        """Packet | None | 'eof'."""
        if self._pending:
            return self._pending.pop(0)
        return self._receive_raw()

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sm_venc_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class AudioEncoder:
    """AAC / Opus encoder, interleaved f32 in → packets out."""

    def __init__(self, codec: Codec, sample_rate: int = 48000, channels: int = 2,
                 bitrate: int = 0, input_sample_rate: int = 0,
                 opts: str = "") -> None:
        """`input_sample_rate`: rate of PCM passed to send() when it differs
        from the encoder's output rate (internally resampled). `opts`:
        codec-private "k=v,k=v" options (libopus fec/packet_loss/...)."""
        self._lib = _load()
        self._h = _check(
            self._lib.sm_aenc_new(
                int(codec), sample_rate, channels, bitrate, input_sample_rate,
                opts.encode(),
            ),
            self._lib,
        )
        self.sample_rate = sample_rate
        self.channels = channels
        self._buf = ctypes.create_string_buffer(_PKT_CAP)

    def extradata(self) -> bytes:
        got = _check(self._lib.sm_aenc_extradata(self._h, self._buf, _PKT_CAP), self._lib)
        return self._buf.raw[:got]

    def frame_size(self) -> int:
        return _check(self._lib.sm_aenc_frame_size(self._h), self._lib)

    def send(self, samples: np.ndarray, pts_s: float) -> None:
        s = np.ascontiguousarray(samples, dtype=np.float32)
        n = s.shape[0]
        _check(
            self._lib.sm_aenc_send(
                self._h, s.ctypes.data_as(ctypes.c_void_p), n, pts_s
            ),
            self._lib,
        )

    def send_eof(self) -> None:
        _check(self._lib.sm_aenc_send_eof(self._h), self._lib)

    def receive(self):
        pts = ctypes.c_double()
        dts = ctypes.c_double()
        flags = ctypes.c_int32()
        ret = self._lib.sm_aenc_receive(
            self._h, ctypes.byref(pts), ctypes.byref(dts), ctypes.byref(flags),
            self._buf, _PKT_CAP,
        )
        if ret == 0:
            return None
        if ret == -1:
            return "eof"
        _check(ret, self._lib)
        return Packet(
            stream_index=0,
            data=self._buf.raw[: ret],
            pts_s=_opt_pts(pts.value),
            dts_s=_opt_pts(dts.value),
            is_keyframe=bool(flags.value & PKT_KEYFRAME),
        )

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sm_aenc_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class Muxer:
    """Container muxer (MP4/HLS/TS). Mirrors `mp4_output.rs`/`hls_output.rs`."""

    def __init__(self, url: str, format: Optional[str] = None, opts: str = "") -> None:
        self._lib = _load()
        self._h = _check(
            self._lib.sm_mux_open(url.encode(), (format or "").encode(), opts.encode()),
            self._lib,
        )

    def add_video(self, codec: Codec, width: int, height: int,
                  fps_num: int, fps_den: int = 1, extradata: bytes = b"") -> int:
        return _check(
            self._lib.sm_mux_add_video(
                self._h, int(codec), width, height, fps_num, fps_den,
                extradata, len(extradata),
            ),
            self._lib,
        )

    def add_audio(self, codec: Codec, sample_rate: int, channels: int,
                  extradata: bytes = b"") -> int:
        return _check(
            self._lib.sm_mux_add_audio(
                self._h, int(codec), sample_rate, channels, extradata, len(extradata)
            ),
            self._lib,
        )

    def write_header(self) -> None:
        _check(self._lib.sm_mux_write_header(self._h), self._lib)

    def write(self, stream: int, data: bytes, pts_s: float,
              dts_s: Optional[float] = None, is_keyframe: bool = False) -> None:
        _check(
            self._lib.sm_mux_write(
                self._h, stream, data, len(data), pts_s,
                dts_s if dts_s is not None else _NO_PTS,
                PKT_KEYFRAME if is_keyframe else 0,
            ),
            self._lib,
        )

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sm_mux_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
