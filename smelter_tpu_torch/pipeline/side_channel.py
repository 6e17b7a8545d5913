"""Side channel: publishes decoded RGBA frames + PCM audio over Unix sockets.

Wire-compatible with the reference (`smelter-core/src/queue/side_channel/`):

- socket naming: ``video_<input_id>.sock`` / ``audio_<input_id>.sock`` in the
  configured socket dir (`side_channel/mod.rs:31`)
- video message: u32 width, u32 height, u64 pts_nanos, RGBA bytes
  (`serialize.rs:18-37`)
- audio message: u64 start_pts_nanos, u32 sample_rate, u8 channels,
  u32 sample_count, f64 interleaved samples (`serialize.rs:8-16,39+`)

External ML consumers (YOLO/Whisper-style) subscribe, process frames ahead
of their due time (``delay_ms`` budget), and feed results back via the HTTP
API. Publishing is non-blocking: slow subscribers drop messages instead of
stalling the decode path.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import struct
import threading
from typing import List

import numpy as np

from smelter_tpu_torch.core.types import AudioSamples, Frame, PixelFormat
from smelter_tpu_torch.utils.channels import Channel

logger = logging.getLogger("smelter.side_channel")

_VIDEO_QUEUE_CAP = 60
_AUDIO_QUEUE_CAP = 100


class _UnixSocketFanout:
    """Unix socket server broadcasting byte messages to all connected clients."""

    def __init__(self, path: str, name: str) -> None:
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(path)
        self._listener.listen(8)
        self._listener.settimeout(0.25)
        self._clients: List[socket.socket] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{name}-accept", daemon=True
        )
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.setblocking(True)
            with self._lock:
                self._clients.append(conn)

    def has_clients(self) -> bool:
        with self._lock:
            return bool(self._clients)

    def broadcast(self, data: bytes) -> None:
        with self._lock:
            clients = list(self._clients)
        dead = []
        for c in clients:
            try:
                c.sendall(data)
            except OSError:
                dead.append(c)
        if dead:
            with self._lock:
                for c in dead:
                    if c in self._clients:
                        self._clients.remove(c)
                    try:
                        c.close()
                    except OSError:
                        pass

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()
        try:
            os.unlink(self.path)
        except OSError:
            pass


def serialize_rgba_frame(width: int, height: int, pts_s: float, rgba: bytes) -> bytes:
    return struct.pack("!IIQ", width, height, max(int(pts_s * 1e9), 0)) + rgba


def serialize_audio_batch(
    start_pts_s: float, sample_rate: int, samples: np.ndarray
) -> bytes:
    s = np.asarray(samples, dtype=">f8")
    if s.ndim == 1:
        s = s[:, None]
    channels = s.shape[1]
    header = struct.pack(
        "!QIBI", max(int(start_pts_s * 1e9), 0), sample_rate, channels, s.shape[0]
    )
    return header + s.tobytes()


def _frame_to_rgba_bytes(frame: Frame) -> bytes:
    """Host-side convert of any input frame format to tightly packed RGBA.

    Pure numpy (BT.709 limited-range, same matrix as
    `ops/color_convert.py` / reference `planar_yuv_to_rgba.wgsl:44-57`):
    the publisher must not touch the card — it runs
    beside the hot path and drops frames when slow."""
    if frame.format == PixelFormat.RGBA:
        return np.ascontiguousarray(np.asarray(frame.data, dtype=np.uint8)).tobytes()
    if frame.format.is_planar_yuv or frame.format == PixelFormat.NV12:
        if frame.format == PixelFormat.NV12:
            y, uv = frame.data
            u = np.asarray(uv)[..., 0]
            v = np.asarray(uv)[..., 1]
        else:
            y, u, v = frame.data
        y = np.asarray(y, dtype=np.float32)
        h, w = y.shape
        # upsample chroma to luma resolution (nearest)
        u = np.asarray(u, dtype=np.float32)
        v = np.asarray(v, dtype=np.float32)
        ry = h // u.shape[0]
        rx = w // u.shape[1]
        if ry > 1 or rx > 1:
            u = np.repeat(np.repeat(u, ry, axis=0), rx, axis=1)[:h, :w]
            v = np.repeat(np.repeat(v, ry, axis=0), rx, axis=1)[:h, :w]
        if frame.format.is_full_range:
            yf = y / 255.0
            uf = (u - 128.0) / 255.0
            vf = (v - 128.0) / 255.0
        else:
            yf = (y - 16.0) / 219.0
            uf = (u - 128.0) / 224.0
            vf = (v - 128.0) / 224.0
        r = yf + 1.5748 * vf
        g = yf - 0.1873 * uf - 0.4681 * vf
        b = yf + 1.8556 * uf
        rgba = np.empty((h, w, 4), dtype=np.uint8)
        rgba[..., 0] = np.clip(r * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rgba[..., 1] = np.clip(g * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rgba[..., 2] = np.clip(b * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rgba[..., 3] = 255
        return rgba.tobytes()
    raise ValueError(f"side channel: unsupported format {frame.format}")


class VideoSideChannel:
    """Publishes every decoded frame as RGBA (reference VideoSideChannel)."""

    def __init__(self, socket_dir: str, input_id: str) -> None:
        self.server = _UnixSocketFanout(
            os.path.join(socket_dir, f"video_{input_id}.sock"), f"video-sc:{input_id}"
        )
        self._q: "queue.Queue" = queue.Queue(maxsize=_VIDEO_QUEUE_CAP)
        self._thread = threading.Thread(
            target=self._run, name=f"video-sc-send:{input_id}", daemon=True
        )
        self._thread.start()

    def publish(self, frame: Frame) -> None:
        if not self.server.has_clients():
            return
        try:
            self._q.put_nowait(frame)
        except queue.Full:
            pass  # drop instead of stalling the decoder

    def _run(self) -> None:
        while True:
            frame = self._q.get()
            if frame is None:
                return
            try:
                rgba = _frame_to_rgba_bytes(frame)
                msg = serialize_rgba_frame(
                    frame.resolution.width, frame.resolution.height, frame.pts, rgba
                )
                self.server.broadcast(msg)
            except Exception:
                logger.exception("video side channel publish failed")

    def close(self) -> None:
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self.server.close()


class AudioSideChannel:
    """Publishes decoded PCM batches (reference AudioSideChannel)."""

    def __init__(self, socket_dir: str, input_id: str, sample_rate: int) -> None:
        self.sample_rate = sample_rate
        self.server = _UnixSocketFanout(
            os.path.join(socket_dir, f"audio_{input_id}.sock"), f"audio-sc:{input_id}"
        )
        self._q: "queue.Queue" = queue.Queue(maxsize=_AUDIO_QUEUE_CAP)
        self._thread = threading.Thread(
            target=self._run, name=f"audio-sc-send:{input_id}", daemon=True
        )
        self._thread.start()

    def publish(self, batch: AudioSamples) -> None:
        if not self.server.has_clients():
            return
        try:
            self._q.put_nowait(batch)
        except queue.Full:
            pass

    def _run(self) -> None:
        while True:
            batch = self._q.get()
            if batch is None:
                return
            try:
                msg = serialize_audio_batch(
                    batch.start_pts, self.sample_rate, np.asarray(batch.samples)
                )
                self.server.broadcast(msg)
            except Exception:
                logger.exception("audio side channel publish failed")

    def close(self) -> None:
        try:
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self.server.close()


class TeeChannel(Channel):
    """A Channel that also publishes every sent item to a side channel."""

    def __init__(self, inner: Channel, publish) -> None:
        # do not call super().__init__; delegate everything to inner
        self._inner = inner
        self._publish = publish

    def send(self, item) -> None:
        self._publish(item)
        self._inner.send(item)

    def send_deadline(self, item, deadline, clock=None) -> bool:
        self._publish(item)
        if clock is None:
            import time as _t

            clock = _t.monotonic
        return self._inner.send_deadline(item, deadline, clock)

    def try_send(self, item) -> bool:
        ok = self._inner.try_send(item)
        if ok:
            self._publish(item)
        return ok

    def close(self) -> None:
        self._inner.close()

    def recv(self, timeout=None):
        return self._inner.recv(timeout)

    def try_recv(self):
        return self._inner.try_recv()

    @property
    def closed(self) -> bool:
        return self._inner.closed

    def __len__(self) -> int:
        return len(self._inner)

    def __bool__(self) -> bool:
        return True
