"""Pipeline outputs: end conditions, encoder threads, sinks.

Mirrors the reference output model (`smelter-core/src/pipeline/output.rs`):
a registered output owns a video and/or audio encoding chain fed by the
renderer / audio-mixer threads, an EOS *end condition* deciding when the
output finishes (`output.rs:229,297-307`), and a sink (MP4 file, raw
channel, ...). Encoding runs on a dedicated thread per output so x264 work
overlaps the card's compose of the next frame.

Rendered frames are tensors on the card, returned before the card is done
with them. The renderer thread hands each output `to_host_async(frame)`: the
frame's u8 planes copied without waiting into fresh pinned host memory, and
a CUDA event recorded after the copy. The output's thread waits on that
event alone (`HostCopy.wait`, inside the `render.fetch_host` span) and hands
its sink, encoder or raw consumer, numpy planes: what the reference's sinks
get from `np.asarray`. Each frame has its own buffers, so a consumer may keep
a frame as long as it likes.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Set, Tuple

import numpy as np
import torch

from smelter_tpu_torch.core.types import Frame, PixelFormat, Resolution
from smelter_tpu_torch.utils.channels import Channel, Closed

logger = logging.getLogger("smelter.pipeline.output")


@dataclass(frozen=True)
class EndCondition:
    """When is this output considered ended (reference `output.rs:117+`).

    Exactly one of the fields should be set; default = never ends.
    """

    any_of: Optional[Tuple[str, ...]] = None
    all_of: Optional[Tuple[str, ...]] = None
    any_input: bool = False
    all_inputs: bool = False

    @staticmethod
    def from_json(obj: Optional[dict]) -> "EndCondition":
        if not obj:
            return EndCondition()
        return EndCondition(
            any_of=tuple(obj["any_of"]) if obj.get("any_of") is not None else None,
            all_of=tuple(obj["all_of"]) if obj.get("all_of") is not None else None,
            any_input=bool(obj.get("any_input", False)),
            all_inputs=bool(obj.get("all_inputs", False)),
        )


class EndConditionState:
    """Tracks EOS per input and evaluates the end condition.

    `all_inputs` means: all inputs that were ever registered while this output
    existed have ended (and at least one existed) — reference
    `PipelineOutputEndConditionState::on_input_eos` (`output.rs:297-307`).
    """

    def __init__(self, condition: EndCondition, current_inputs: Set[str]) -> None:
        self.condition = condition
        self.seen_inputs: Set[str] = set(current_inputs)
        self.eos_inputs: Set[str] = set()
        self.ended = False

    def on_input_registered(self, input_id: str) -> None:
        self.seen_inputs.add(input_id)

    def on_input_eos(self, input_id: str) -> bool:
        """Returns True when this EOS transitions the output to ended."""
        self.eos_inputs.add(input_id)
        self.seen_inputs.add(input_id)
        return self._evaluate()

    def on_input_unregistered(self, input_id: str) -> bool:
        """Unregistering an input counts as its EOS (reference behavior)."""
        return self.on_input_eos(input_id)

    def _evaluate(self) -> bool:
        if self.ended:
            return False
        c = self.condition
        done = False
        if c.any_of is not None:
            done = any(i in self.eos_inputs for i in c.any_of)
        elif c.all_of is not None:
            done = all(i in self.eos_inputs for i in c.all_of)
        elif c.any_input:
            done = len(self.eos_inputs) > 0
        elif c.all_inputs:
            done = bool(self.seen_inputs) and self.seen_inputs <= self.eos_inputs
        if done:
            self.ended = True
        return done


# ---------------------------------------------------------------------------
# encoder options
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VideoEncoderOptions:
    codec: str = "h264"           # h264 | vp8 | vp9 | av1 | raw
    preset: str = "ultrafast"
    bitrate: int = 0              # 0 = CRF default
    ffmpeg_options: str = ""      # extra "k=v,k=v" passed to the encoder
    keyframe_interval_s: Optional[float] = None  # None = encoder default
    pixel_format: str = "yuv420p"  # yuv420p | yuv422p | yuv444p


@dataclass(frozen=True)
class AudioEncoderOptions:
    codec: str = "aac"            # aac | opus | raw
    sample_rate: int = 48000
    channels: int = 2
    bitrate: int = 0
    ffmpeg_options: str = ""      # codec-private "k=v,k=v" (opus fec etc.)


@dataclass
class OutputVideoOptions:
    resolution: Resolution = Resolution(1920, 1080)
    encoder: VideoEncoderOptions = field(default_factory=VideoEncoderOptions)
    initial_root: Optional[object] = None   # scene Component
    end_condition: EndCondition = field(default_factory=EndCondition)


@dataclass
class OutputAudioOptions:
    encoder: AudioEncoderOptions = field(default_factory=AudioEncoderOptions)
    initial_mixer_config: Optional[object] = None  # AudioMixerConfig
    end_condition: EndCondition = field(default_factory=EndCondition)


# sentinel for EOS on encoder channels
class _Eos:
    pass


EOS = _Eos()


class OutputSink:
    """Receives encoded packets (or raw frames for raw outputs)."""

    def setup_video(self, opts: OutputVideoOptions, extradata: bytes,
                    fps_num: int, fps_den: int) -> None: ...

    def setup_audio(self, opts: OutputAudioOptions, extradata: bytes) -> None: ...

    def write_video_packet(self, pkt) -> None: ...

    def write_audio_packet(self, pkt) -> None: ...

    def on_done(self) -> None:
        """Called once after both chains flushed."""


class PipelineOutput:
    """One registered output: encoder threads + sink + end-condition state."""

    def __init__(
        self,
        output_id: str,
        sink: OutputSink,
        video: Optional[OutputVideoOptions],
        audio: Optional[OutputAudioOptions],
        fps_num: int,
        fps_den: int,
        current_inputs: Set[str],
        on_done: Callable[[str], None],
        mixing_sample_rate: int = 48000,
        on_error: Optional[Callable[[str, str, str], None]] = None,
    ) -> None:
        self.mixing_sample_rate = mixing_sample_rate
        self.output_id = output_id
        self.sink = sink
        self.video_opts = video
        self.audio_opts = audio
        self.fps = (fps_num, fps_den)
        self.video_end = EndConditionState(
            video.end_condition if video else EndCondition(), current_inputs
        )
        self.audio_end = EndConditionState(
            audio.end_condition if audio else EndCondition(), current_inputs
        )
        self._on_done = on_done
        self._on_error = on_error
        self.encoded_video_packets = 0
        # per-track byte meters for /stats protocol reports (set by the
        # pipeline at register time; every sink type shares this boundary)
        self.video_meter = None
        self.audio_meter = None
        self._done_lock = threading.Lock()
        self._video_done = video is None
        self._audio_done = audio is None
        self._done_emitted = False
        self._keyframe_request = threading.Event()

        # bounded(5): lets encode lag a few frames behind compose without
        # stalling the renderer thread (reference uses bounded channels too)
        self.video_channel: Optional[Channel] = Channel(5) if video else None
        self.audio_channel: Optional[Channel] = Channel(20) if audio else None
        self._threads: List[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self.video_opts:
            t = threading.Thread(
                target=self._run_video, name=f"venc:{self.output_id}", daemon=True
            )
            t.start()
            self._threads.append(t)
        if self.audio_opts:
            t = threading.Thread(
                target=self._run_audio, name=f"aenc:{self.output_id}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def request_keyframe(self) -> None:
        self._keyframe_request.set()

    def send_video_eos(self) -> None:
        if self.video_channel is not None:
            try:
                self.video_channel.send(EOS)
            except Closed:
                pass

    def send_audio_eos(self) -> None:
        if self.audio_channel is not None:
            try:
                self.audio_channel.send(EOS)
            except Closed:
                pass

    def close(self) -> None:
        for ch in (self.video_channel, self.audio_channel):
            if ch is not None:
                ch.close()
        for t in self._threads:
            t.join(timeout=5.0)

    def join(self, timeout: Optional[float] = None) -> None:
        for t in self._threads:
            t.join(timeout=timeout)

    # -- encoder threads ------------------------------------------------------

    def _chain_done(self, which: str) -> None:
        with self._done_lock:
            if which == "video":
                self._video_done = True
            else:
                self._audio_done = True
            if self._video_done and self._audio_done and not self._done_emitted:
                self._done_emitted = True
                try:
                    self.sink.on_done()
                finally:
                    self._on_done(self.output_id)

    def _run_video(self) -> None:
        opts = self.video_opts
        assert opts is not None and self.video_channel is not None
        enc = None
        try:
            if opts.encoder.codec != "raw":
                from smelter_tpu_torch.io.codec import Codec, VideoEncoder

                ff_opts = opts.encoder.ffmpeg_options
                interval = getattr(opts.encoder, "keyframe_interval_s", None)
                if interval:
                    # gop size in frames (reference ffmpeg_h264.rs maps
                    # keyframe_interval_ms the same way)
                    gop = max(int(round(
                        interval * self.fps[0] / self.fps[1])), 1)
                    ff_opts = (ff_opts + "," if ff_opts else "") + f"g={gop}"
                enc = VideoEncoder(
                    Codec.from_name(opts.encoder.codec),
                    opts.resolution.width,
                    opts.resolution.height,
                    self.fps[0],
                    self.fps[1],
                    preset=opts.encoder.preset,
                    bitrate=opts.encoder.bitrate,
                    opts=ff_opts,
                    pix_fmt=getattr(opts.encoder, "pixel_format", "yuv420p"),
                )
                self.sink.setup_video(opts, enc.extradata(), *self.fps)
            else:
                self.sink.setup_video(opts, b"", *self.fps)
            while True:
                try:
                    item = self.video_channel.recv()
                except Closed:
                    break
                if isinstance(item, _Eos):
                    break
                from smelter_tpu_torch.utils import tracing

                # the wait for the card's compose and copy lands here, so it
                # gets its own span — otherwise the wait would be silently
                # attributed to codec.video_encode
                with tracing.span("render.fetch_host"):
                    frame: Frame = item.wait()
                if enc is None:
                    self.sink.write_video_packet(frame)
                    continue
                y, u, v = _frame_to_planes(
                    frame, opts.resolution,
                    getattr(opts.encoder, "pixel_format", "yuv420p"),
                )
                force_kf = self._keyframe_request.is_set()
                if force_kf:
                    self._keyframe_request.clear()
                enc.send(y, u, v, frame.pts, force_keyframe=force_kf)
                while True:
                    pkt = enc.receive()
                    if pkt is None or pkt == "eof":
                        break
                    self.encoded_video_packets += 1
                    if self.video_meter is not None:
                        self.video_meter.add_bytes(len(pkt.data))
                    self.sink.write_video_packet(pkt)
            if enc is not None:
                enc.send_eof()
                while True:
                    pkt = enc.receive()
                    if pkt is None or pkt == "eof":
                        break
                    self.sink.write_video_packet(pkt)
        except Exception as exc:  # noqa: BLE001
            self._report_error("video", exc)
        finally:
            if enc is not None:
                enc.close()
            self._chain_done("video")

    def _report_error(self, which: str, exc: Exception) -> None:
        """An encoder/sink chain died: surface it as an OUTPUT_ERROR event
        (event.rs OutputError, severity Critical — the chain fully stopped)
        instead of a silent thread death."""
        import traceback

        logger.exception("output %s %s chain failed", self.output_id, which)
        if self._on_error is not None:
            try:
                self._on_error(
                    self.output_id,
                    f"{which} chain: {type(exc).__name__}: {exc}",
                    "".join(traceback.format_exception(exc)).strip(),
                )
            except Exception:  # noqa: BLE001
                pass

    def _run_audio(self) -> None:
        opts = self.audio_opts
        assert opts is not None and self.audio_channel is not None
        enc = None
        try:
            if opts.encoder.codec != "raw":
                from smelter_tpu_torch.io.codec import AudioEncoder, Codec

                enc = AudioEncoder(
                    Codec.from_name(opts.encoder.codec),
                    opts.encoder.sample_rate,
                    opts.encoder.channels,
                    opts.encoder.bitrate,
                    input_sample_rate=self.mixing_sample_rate,
                    opts=getattr(opts.encoder, "ffmpeg_options", ""),
                )
                self.sink.setup_audio(opts, enc.extradata())
            else:
                self.sink.setup_audio(opts, b"")
            while True:
                try:
                    item = self.audio_channel.recv()
                except Closed:
                    break
                if isinstance(item, _Eos):
                    break
                samples, pts = item  # (np (n, ch) f32/f64, start_pts)
                if enc is None:
                    self.sink.write_audio_packet((samples, pts))
                    continue
                enc.send(np.asarray(samples, dtype=np.float32), pts)
                while True:
                    pkt = enc.receive()
                    if pkt is None or pkt == "eof":
                        break
                    if self.audio_meter is not None:
                        self.audio_meter.add_bytes(len(pkt.data))
                    self.sink.write_audio_packet(pkt)
            if enc is not None:
                enc.send_eof()
                while True:
                    pkt = enc.receive()
                    if pkt is None or pkt == "eof":
                        break
                    self.sink.write_audio_packet(pkt)
        except Exception as exc:  # noqa: BLE001
            self._report_error("audio", exc)
        finally:
            if enc is not None:
                enc.close()
            self._chain_done("audio")


class HostCopy:
    """A rendered frame on its way to the host: `frame` holds numpy views of
    pinned buffers that the card fills after the compose; `ready` is the CUDA
    event recorded after the copy (None when nothing was left to wait for)."""

    __slots__ = ("frame", "ready")

    def __init__(self, frame: Frame, ready: Optional[torch.cuda.Event]) -> None:
        self.frame = frame
        self.ready = ready

    def wait(self) -> Frame:
        """The frame with host numpy planes, once the card has copied them:
        waits on this frame's event, never on the whole device."""
        if self.ready is not None:
            self.ready.synchronize()
        return self.frame


def _yuv420_on_device(frame: Frame) -> Tuple[torch.Tensor, ...]:
    """The planes of a rendered PLANAR_YUV420 frame; an RGBA frame converts
    on its device to PLANAR_YUV420 (BT.709 limited range, K2 on the card)."""
    if frame.format == PixelFormat.PLANAR_YUV420:
        return tuple(frame.data)
    if frame.format == PixelFormat.RGBA:
        from smelter_tpu_torch.ops.color_convert import rgba_to_planar_yuv420, u8_to_f32

        return rgba_to_planar_yuv420(u8_to_f32(torch.as_tensor(frame.data)))
    raise ValueError(f"unsupported output frame format {frame.format}")


def to_host_async(frame: Frame) -> HostCopy:
    """On the renderer thread, right after `render()`: enqueue the copy of a
    rendered frame's u8 planes into fresh pinned host memory, after the
    frame's compose on the same stream, and record an event; nothing waits.
    A frame on the CPU is its own host copy. The pipeline's outputs are
    YUV420 (RGBA converts on the card first); PLANAR_YUV444 is not ported
    (ROADMAP Queue 1 item 1: `Renderer.update_scene` refuses it)."""
    planes = _yuv420_on_device(frame)
    ready = None
    if planes[0].device.type == "cuda":
        pinned = tuple(torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                       for p in planes)
        for dst, src in zip(pinned, planes):
            dst.copy_(src, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        planes = pinned
    # numpy views keep their tensors (and so the pinned memory) alive for as
    # long as a consumer holds the frame
    host = Frame(data=tuple(p.numpy() for p in planes), format=PixelFormat.PLANAR_YUV420,
                 resolution=frame.resolution, pts=frame.pts)
    return HostCopy(host, ready)


def _host(plane) -> np.ndarray:
    if isinstance(plane, torch.Tensor):
        return plane.cpu().numpy()
    return np.asarray(plane)


def _frame_to_planes(frame: Frame, resolution: Resolution,
                     pix_fmt: str = "yuv420p"):
    """Rendered output frame → host planar-YUV numpy planes matching the
    encoder's pixel format. The renderer emits 4:2:0 for yuv420p encoders
    and 4:4:4 for the high-chroma formats (4:2:2 is the 4:4:4 output with
    a horizontal chroma pair-average — full vertical resolution kept).
    Planes may be numpy arrays or tensors on any device; an RGBA frame
    converts on its device."""
    if frame.format == PixelFormat.PLANAR_YUV444:
        y, u, v = (_host(p) for p in frame.data)
        if pix_fmt == "yuv422p":
            u = ((u[:, 0::2].astype(np.uint16) + u[:, 1::2]) // 2).astype(np.uint8)
            v = ((v[:, 0::2].astype(np.uint16) + v[:, 1::2]) // 2).astype(np.uint8)
        return (y, u, v)
    return tuple(_host(p) for p in _yuv420_on_device(frame))


# ---------------------------------------------------------------------------
# concrete sinks
# ---------------------------------------------------------------------------


class Mp4OutputSink(OutputSink):
    """Muxes encoded streams into an MP4 file (reference `mp4_output.rs`).
    With format/opts it serves any FFmpeg container — `HlsOutputSink` uses it
    for HLS playlists (reference `hls_output.rs`)."""

    def __init__(self, path: str, format: Optional[str] = None, opts: str = "") -> None:
        self.path = path
        self._format = format
        self._opts = opts
        self._lock = threading.Lock()
        self._mux = None
        self._video_stream: Optional[int] = None
        self._audio_stream: Optional[int] = None
        self._need_video = False
        self._need_audio = False
        self._header = False
        self._pending: List[Tuple[str, object]] = []
        self._ts_offset: Optional[float] = None

    def _maybe_open(self) -> None:
        ready = (not self._need_video or self._video_stream is not None) and (
            not self._need_audio or self._audio_stream is not None
        )
        if ready and not self._header and self._mux is not None:
            self._mux.write_header()
            self._header = True
            for kind, pkt in self._pending:
                self._write(kind, pkt)
            self._pending.clear()

    def expect(self, video: bool, audio: bool) -> None:
        self._need_video = video
        self._need_audio = audio

    def setup_video(self, opts, extradata, fps_num, fps_den) -> None:
        from smelter_tpu_torch.io.codec import Codec, Muxer

        with self._lock:
            if self._mux is None:
                self._mux = Muxer(self.path, self._format, self._opts)
            self._video_stream = self._mux.add_video(
                Codec.from_name(opts.encoder.codec),
                opts.resolution.width,
                opts.resolution.height,
                fps_num,
                fps_den,
                extradata,
            )
            self._maybe_open()

    def setup_audio(self, opts, extradata) -> None:
        from smelter_tpu_torch.io.codec import Codec, Muxer

        with self._lock:
            if self._mux is None:
                self._mux = Muxer(self.path, self._format, self._opts)
            self._audio_stream = self._mux.add_audio(
                Codec.from_name(opts.encoder.codec),
                opts.encoder.sample_rate,
                opts.encoder.channels,
                extradata,
            )
            self._maybe_open()

    def _write(self, kind: str, pkt) -> None:
        stream = self._video_stream if kind == "video" else self._audio_stream
        # rebase to the first packet so the file starts at pts 0 regardless
        # of when the output was registered on the pipeline clock
        # (mp4_output.rs:305-381 timestamp_offset)
        if self._ts_offset is None:
            self._ts_offset = pkt.pts_s or 0.0
        pts = max((pkt.pts_s or 0.0) - self._ts_offset, 0.0)
        dts = None if pkt.dts_s is None else max(pkt.dts_s - self._ts_offset, 0.0)
        self._mux.write(stream, pkt.data, pts, dts, pkt.is_keyframe)

    def write_video_packet(self, pkt) -> None:
        with self._lock:
            if not self._header:
                self._pending.append(("video", pkt))
                return
            self._write("video", pkt)

    def write_audio_packet(self, pkt) -> None:
        with self._lock:
            if not self._header:
                self._pending.append(("audio", pkt))
                return
            self._write("audio", pkt)

    def on_done(self) -> None:
        with self._lock:
            if self._mux is not None:
                if not self._header:
                    # no packets at all; still write a valid (empty) file
                    try:
                        self._mux.write_header()
                    except Exception:
                        pass
                self._mux.close()
                self._mux = None


class HlsOutputSink(Mp4OutputSink):
    """HLS output: segments + playlist via the FFmpeg hls muxer
    (reference `hls/hls_output.rs`). ``path`` is the .m3u8 playlist path."""

    def __init__(self, path: str, max_playlist_size: Optional[int] = None,
                 ffmpeg_options: Optional[dict] = None) -> None:
        opts = "hls_time=2,hls_flags=independent_segments"
        if max_playlist_size:
            opts += f",hls_list_size={max_playlist_size}"
        else:
            opts += ",hls_list_size=0"
        for k, v in (ffmpeg_options or {}).items():
            opts += f",{k}={v}"
        super().__init__(path, format="hls", opts=opts)


class RawDataOutputSink(OutputSink):
    """Delivers raw rendered frames / mixed samples to in-process consumers
    (reference `channel/raw_data_output.rs`). Use with codec='raw'."""

    def __init__(self, video_capacity: int = 60, audio_capacity: int = 120) -> None:
        self.video: Channel[Frame] = Channel(video_capacity)
        self.audio: Channel = Channel(audio_capacity)
        self.done = threading.Event()

    def setup_video(self, opts, extradata, fps_num, fps_den) -> None:
        pass

    def setup_audio(self, opts, extradata) -> None:
        pass

    def write_video_packet(self, frame) -> None:
        try:
            self.video.send(frame)
        except Closed:
            pass

    def write_audio_packet(self, chunk) -> None:
        try:
            self.audio.send(chunk)
        except Closed:
            pass

    def on_done(self) -> None:
        self.done.set()
        self.video.close()
        self.audio.close()


class EncodedDataOutputSink(OutputSink):
    """Delivers encoded packets to in-process consumers
    (reference `channel/encoded_data_output.rs`)."""

    def __init__(self, capacity: int = 500) -> None:
        self.video: Channel = Channel(capacity)
        self.audio: Channel = Channel(capacity)
        self.video_extradata = b""
        self.audio_extradata = b""
        self.done = threading.Event()

    def setup_video(self, opts, extradata, fps_num, fps_den) -> None:
        self.video_extradata = extradata

    def setup_audio(self, opts, extradata) -> None:
        self.audio_extradata = extradata

    def write_video_packet(self, pkt) -> None:
        try:
            self.video.send(pkt)
        except Closed:
            pass

    def write_audio_packet(self, pkt) -> None:
        try:
            self.audio.send(pkt)
        except Closed:
            pass

    def on_done(self) -> None:
        self.done.set()
        self.video.close()
        self.audio.close()
