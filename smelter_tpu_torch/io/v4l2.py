"""V4L2 camera input (reference `smelter-core/src/pipeline/v4l2/`).

Pure-Python implementation of the V4L2 streaming API via ioctl + mmap:
query caps, negotiate format (YUYV or NV12, like `v4l2_input.rs:38-47`),
request/queue mmap buffers, stream on, dequeue frames. YUYV frames enter
the queue as INTERLEAVED_YUYV422, NV12 frames as PixelFormat.NV12 (y, uv)
planes — the render core's converters handle both (reference
interleaved_yuyv_to_rgba.wgsl / nv12_to_rgba.wgsl).

Format negotiation mirrors `v4l2_input.rs:try_set_format` (188-204): request
the configured fourcc, accept whatever the driver negotiates with a warning
if it differs, and fail only when the negotiated fourcc is neither YUYV nor
NV12 (UnsupportedFormat).
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import mmap
import os
import select
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from smelter_tpu_torch.core.types import Frame, PixelFormat, Resolution
from smelter_tpu_torch.pipeline.input import InputCtx, InputSource
from smelter_tpu_torch.utils.channels import Closed

logger = logging.getLogger("smelter.v4l2")

# ioctl codes (from linux/videodev2.h)
VIDIOC_QUERYCAP = 0x80685600
VIDIOC_S_FMT = 0xC0D05605
VIDIOC_REQBUFS = 0xC0145608
VIDIOC_QUERYBUF = 0xC0585609
VIDIOC_QBUF = 0xC058560F
VIDIOC_DQBUF = 0xC0585611
VIDIOC_STREAMON = 0x40045612
VIDIOC_STREAMOFF = 0x40045613
VIDIOC_S_PARM = 0xC0CC5616

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_PIX_FMT_YUYV = 0x56595559  # 'YUYV'
V4L2_PIX_FMT_NV12 = 0x3231564E  # 'NV12'
FOURCC_BY_FORMAT = {"yuyv": V4L2_PIX_FMT_YUYV, "nv12": V4L2_PIX_FMT_NV12}
FORMAT_BY_FOURCC = {v: k for k, v in FOURCC_BY_FORMAT.items()}
V4L2_CAP_VIDEO_CAPTURE = 0x00000001
V4L2_CAP_STREAMING = 0x04000000


class v4l2_capability(ctypes.Structure):
    _fields_ = [
        ("driver", ctypes.c_char * 16),
        ("card", ctypes.c_char * 32),
        ("bus_info", ctypes.c_char * 32),
        ("version", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("device_caps", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32 * 3),
    ]


class v4l2_pix_format(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("pixelformat", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("bytesperline", ctypes.c_uint32),
        ("sizeimage", ctypes.c_uint32),
        ("colorspace", ctypes.c_uint32),
        ("priv", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("enc", ctypes.c_uint32),
        ("quantization", ctypes.c_uint32),
        ("xfer_func", ctypes.c_uint32),
    ]


class v4l2_fract(ctypes.Structure):
    _fields_ = [("numerator", ctypes.c_uint32),
                ("denominator", ctypes.c_uint32)]


class v4l2_captureparm(ctypes.Structure):
    _fields_ = [("capability", ctypes.c_uint32),
                ("capturemode", ctypes.c_uint32),
                ("timeperframe", v4l2_fract),
                ("extendedmode", ctypes.c_uint32),
                ("readbuffers", ctypes.c_uint32),
                ("reserved", ctypes.c_uint32 * 4)]


class v4l2_streamparm(ctypes.Structure):
    _fields_ = [("type", ctypes.c_uint32),
                ("parm", v4l2_captureparm),
                ("_pad", ctypes.c_uint8 * (200 - ctypes.sizeof(v4l2_captureparm)))]


class v4l2_format(ctypes.Structure):
    class _u(ctypes.Union):
        _fields_ = [
            ("pix", v4l2_pix_format),
            ("raw_data", ctypes.c_uint8 * 200),
        ]

    _fields_ = [("type", ctypes.c_uint32), ("fmt", _u)]


class v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32 * 2),
    ]


class _timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _timecode(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
        ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
        ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
        ("userbits", ctypes.c_uint8 * 4),
    ]


class v4l2_buffer(ctypes.Structure):
    class _m(ctypes.Union):
        _fields_ = [
            ("offset", ctypes.c_uint32),
            ("userptr", ctypes.c_ulong),
            ("planes", ctypes.c_void_p),
            ("fd", ctypes.c_int32),
        ]

    _fields_ = [
        ("index", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("bytesused", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("timestamp", _timeval),
        ("timecode", _timecode),
        ("sequence", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("m", _m),
        ("length", ctypes.c_uint32),
        ("reserved2", ctypes.c_uint32),
        ("reserved", ctypes.c_uint32),
    ]


@dataclass
class V4l2Device:
    path: str
    card: str
    driver: str


def list_v4l2_devices() -> List[V4l2Device]:
    """Enumerate capture-capable devices (reference `list_v4l2_devices`,
    pipeline.rs:52)."""
    out: List[V4l2Device] = []
    for name in sorted(os.listdir("/dev")) if os.path.isdir("/dev") else []:
        if not name.startswith("video"):
            continue
        path = f"/dev/{name}"
        try:
            fd = os.open(path, os.O_RDWR | os.O_NONBLOCK)
        except OSError:
            continue
        try:
            caps = v4l2_capability()
            fcntl.ioctl(fd, VIDIOC_QUERYCAP, caps)
            if caps.device_caps & V4L2_CAP_VIDEO_CAPTURE:
                out.append(
                    V4l2Device(
                        path=path,
                        card=caps.card.decode("utf-8", "replace"),
                        driver=caps.driver.decode("utf-8", "replace"),
                    )
                )
        except OSError:
            pass
        finally:
            os.close(fd)
    return out


@dataclass
class V4l2InputOptions:
    device_path: str = "/dev/video0"
    width: int = 1280
    height: int = 720
    n_buffers: int = 4
    framerate: Optional[int] = None  # requested fps (VIDIOC_S_PARM); None = driver default
    format: str = "yuyv"  # requested fourcc: "yuyv" | "nv12" (V4l2InputFormat)


class V4l2Input(InputSource):
    """Camera capture input: YUYV/NV12 mmap streaming on a dedicated thread."""

    has_video = True
    has_audio = False

    def __init__(self, options: V4l2InputOptions = V4l2InputOptions()) -> None:
        self.options = options
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # open + configure now so registration fails fast on a bad device
        self._fd = os.open(options.device_path, os.O_RDWR | os.O_NONBLOCK)
        try:
            caps = v4l2_capability()
            fcntl.ioctl(self._fd, VIDIOC_QUERYCAP, caps)
            if not caps.device_caps & V4L2_CAP_VIDEO_CAPTURE:
                raise OSError("not a capture device")
            requested = FOURCC_BY_FORMAT.get(options.format.lower())
            if requested is None:
                raise OSError(f"unsupported v4l2 format {options.format!r} "
                              "(yuyv | nv12)")
            fmt = v4l2_format()
            fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            fmt.fmt.pix.width = options.width
            fmt.fmt.pix.height = options.height
            fmt.fmt.pix.pixelformat = requested
            fmt.fmt.pix.field = 1  # V4L2_FIELD_NONE
            fcntl.ioctl(self._fd, VIDIOC_S_FMT, fmt)
            negotiated = fmt.fmt.pix.pixelformat
            if negotiated != requested:
                # v4l2_input.rs:188-204: the driver is free to negotiate a
                # different format — warn, then accept it only if supported
                logger.warning(
                    "requested %s but driver configured %s",
                    options.format,
                    FORMAT_BY_FOURCC.get(
                        negotiated,
                        negotiated.to_bytes(4, "little").decode(
                            "ascii", "replace"),
                    ),
                )
            self.format = FORMAT_BY_FOURCC.get(negotiated)
            if self.format is None:
                raise OSError(
                    "device negotiated unsupported format "
                    + negotiated.to_bytes(4, "little").decode("ascii",
                                                              "replace")
                )
            self.width = fmt.fmt.pix.width
            self.height = fmt.fmt.pix.height
            self._stride = fmt.fmt.pix.bytesperline or 0
            if options.framerate:
                # wire `framerate` (api.V4l2Input.framerate): request the
                # capture interval; drivers clamp to what the sensor does
                parm = v4l2_streamparm()
                parm.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
                parm.parm.timeperframe.numerator = 1
                parm.parm.timeperframe.denominator = int(options.framerate)
                try:
                    fcntl.ioctl(self._fd, VIDIOC_S_PARM, parm)
                except OSError:
                    logger.warning("VIDIOC_S_PARM failed; using driver default rate")
        except Exception:
            os.close(self._fd)
            raise

    def _frame_data(self, raw: np.ndarray):
        """Copy one dequeued buffer into queue-frame arrays, honoring the
        driver's row stride (bytesperline can exceed the visible width)."""
        h, w = self.height, self.width
        if self.format == "nv12":
            # contiguous Y plane (h rows) then interleaved UV (h/2 rows)
            stride = self._stride or w
            y = raw[: stride * h].reshape(h, stride)[:, :w].copy()
            uv = (
                raw[stride * h : stride * h + stride * (h // 2)]
                .reshape(h // 2, stride)[:, :w]
                .reshape(h // 2, w // 2, 2)
                .copy()
            )
            return (y, uv), PixelFormat.NV12
        stride = self._stride or w * 2
        data = (
            raw[: stride * h]
            .reshape(h, stride)[:, : w * 2]
            .reshape(h, w // 2, 4)
            .copy()
        )
        return data, PixelFormat.INTERLEAVED_YUYV422

    def start(self, ctx: InputCtx) -> None:
        self._thread = threading.Thread(
            target=self._run, args=(ctx,), name=f"v4l2:{ctx.input_id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self, ctx: InputCtx) -> None:
        vch = ctx.video_channel
        assert vch is not None
        fd = self._fd
        mmaps: List[mmap.mmap] = []
        try:
            req = v4l2_requestbuffers()
            req.count = self.options.n_buffers
            req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            req.memory = V4L2_MEMORY_MMAP
            fcntl.ioctl(fd, VIDIOC_REQBUFS, req)
            for i in range(req.count):
                buf = v4l2_buffer()
                buf.index = i
                buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
                buf.memory = V4L2_MEMORY_MMAP
                fcntl.ioctl(fd, VIDIOC_QUERYBUF, buf)
                mm = mmap.mmap(fd, buf.length, offset=buf.m.offset)
                mmaps.append(mm)
                fcntl.ioctl(fd, VIDIOC_QBUF, buf)
            buf_type = ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE)
            fcntl.ioctl(fd, VIDIOC_STREAMON, buf_type)
            first_ts: Optional[float] = None
            while not self._stop.is_set():
                r, _, _ = select.select([fd], [], [], 0.25)
                if not r:
                    continue
                buf = v4l2_buffer()
                buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
                buf.memory = V4L2_MEMORY_MMAP
                try:
                    fcntl.ioctl(fd, VIDIOC_DQBUF, buf)
                except BlockingIOError:
                    continue
                ts = buf.timestamp.tv_sec + buf.timestamp.tv_usec / 1e6
                if first_ts is None:
                    first_ts = ts
                raw = np.frombuffer(
                    mmaps[buf.index], dtype=np.uint8, count=buf.bytesused
                )
                data, pixfmt = self._frame_data(raw)
                frame = Frame(
                    data=data,
                    format=pixfmt,
                    resolution=Resolution(self.width, self.height),
                    pts=ts - first_ts,
                )
                fcntl.ioctl(fd, VIDIOC_QBUF, buf)
                try:
                    vch.send(frame)
                except Closed:
                    break
            buf_type = ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE)
            try:
                fcntl.ioctl(fd, VIDIOC_STREAMOFF, buf_type)
            except OSError:
                pass
        except Exception:
            logger.exception("v4l2 capture failed")
        finally:
            for mm in mmaps:
                try:
                    mm.close()
                except Exception:
                    pass
            try:
                os.close(fd)
            except OSError:
                pass
            vch.close()
