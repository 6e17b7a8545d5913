"""Pipeline: the orchestrator that owns inputs, outputs, queue, renderer and
audio mixer, and runs the real-time loops.

Port of the redesign of the reference pipeline
(`smelter-core/src/pipeline/instance.rs`):

- `register_input` creates a queue track and starts the source's demux/decode
  threads (instance.rs:85 → pipeline/input.rs:121+)
- `register_output` registers a scene with the renderer + a mixer config, and
  starts per-output encoder threads (instance.rs:150+)
- `start()` spawns the queue tick thread, the renderer thread (bounded(2)
  video channel) and the audio mixer thread (bounded(100) audio channel)
  (instance.rs:338-354)
- EOS end-conditions per output finish outputs and emit OUTPUT_DONE
  (instance.rs:418-431, 490-503)
- `update_output` swaps scenes/mixer configs live; `schedule_event` defers an
  update to a PTS (instance.rs:363-384)

The renderer thread is where host ↔ card overlap happens: frame N's encoded
output is written by the encoder threads while frame N+1 composes on the
card. The renderer runs on the CUDA card unless the pipeline is given
another device (`device="cpu"`); without a card it raises. After each
`render()` the renderer thread enqueues each output frame's copy into pinned
host memory (`output.to_host_async`) and hands the output thread the frame
with its CUDA event; nothing on the renderer thread waits for the card.

With ``SMELTER_TORCH_PROFILER_DIR`` set, `start()` opens a torch.profiler
trace (host and CUDA activity) that `close()` writes there as
``trace.json``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Set


from smelter_tpu_torch.audio.mixer import AudioMixer, AudioMixerConfig
from smelter_tpu_torch.core.types import FrameSet, Framerate, PixelFormat
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.pipeline.events import Emitter, Event
from smelter_tpu_torch.pipeline.input import InputCtx, InputSource
from smelter_tpu_torch.pipeline.output import (
    OutputAudioOptions,
    OutputSink,
    OutputVideoOptions,
    PipelineOutput,
    to_host_async,
)
from smelter_tpu_torch.pipeline.stats import (
    PipelineStats,
    ProtocolReport,
    RtpTrackStats,
    TrackStats,
)
from smelter_tpu_torch.queue.sync_queue import (
    MonotonicClock,
    Queue,
    QueueAudioOutput,
    QueueInputOptions,
    QueueOptions,
    QueueVideoOutput,
)
from smelter_tpu_torch.render.renderer import Renderer, RendererOptions
from smelter_tpu_torch.utils.channels import Channel, Closed


@dataclass
class PipelineOptions:
    output_framerate: Framerate = Framerate(30)
    mixing_sample_rate: int = 48000
    ahead_of_time_processing: bool = False
    never_drop_output_frames: bool = False
    run_late_scheduled_events: bool = False
    stream_fallback_timeout: float = 0.5
    tick_duration: float = 0.005
    audio_chunk_duration: float = 0.020


@dataclass
class RegisterInputOptions:
    required: bool = False
    offset: Optional[float] = None        # None = "from start of first frame"
    buffer_duration: float = 0.3
    # side channel (reference `input/side_channel.rs`): publish decoded
    # frames/PCM on unix sockets for external ML consumers
    side_channel_video: bool = False
    side_channel_audio: bool = False
    side_channel_dir: Optional[str] = None
    side_channel_delay: float = 0.0


def _render_format_for(encoder) -> PixelFormat:
    """Renderer output format per encoder pixel format: 4:2:0 encodes
    render straight to 4:2:0 (chroma work at half res); 4:2:2/4:4:4
    render full-chroma 4:4:4 (the output thread pair-averages for 422)."""
    pf = getattr(encoder, "pixel_format", "yuv420p")
    if pf in ("yuv444p", "yuv422p"):
        return PixelFormat.PLANAR_YUV444
    return PixelFormat.PLANAR_YUV420


class Pipeline:
    """Thread-safe pipeline facade (reference `Pipeline`, instance.rs:45-66);
    the renderer runs on `device`: the CUDA card unless given another, such
    as "cpu"."""

    def __init__(self, options: PipelineOptions = PipelineOptions(),
                 device=None) -> None:
        self.options = options
        self.device = resolve_device(device)
        self.events = Emitter()
        self.renderer = Renderer(
            RendererOptions(
                stream_fallback_timeout=options.stream_fallback_timeout,
                # live: new structures are captured in the background
                async_compile=not options.ahead_of_time_processing,
            ),
            device=self.device,
        )
        self.audio_mixer = AudioMixer(mixing_sample_rate=options.mixing_sample_rate)
        self.queue = Queue(
            QueueOptions(
                output_framerate=options.output_framerate,
                ahead_of_time_processing=options.ahead_of_time_processing,
                run_late_scheduled_events=options.run_late_scheduled_events,
                never_drop_output_frames=options.never_drop_output_frames,
                tick_duration=options.tick_duration,
                audio_chunk_duration=options.audio_chunk_duration,
            ),
            event_callback=self.events.emit_queue_event,
            drop_callback=self._on_queue_drop,
        )
        self._lock = threading.RLock()
        self.stats = PipelineStats()
        self._inputs: Dict[str, InputSource] = {}
        self._outputs: Dict[str, PipelineOutput] = {}
        self._started = False
        self._closed = threading.Event()
        self._video_channel: Optional[Channel] = None
        self._audio_channel: Optional[Channel] = None
        self._threads: list = []
        # inputs whose EOS has been dispatched to end conditions
        self._video_eos_seen: Set[str] = set()
        self._audio_eos_seen: Set[str] = set()
        self._side_channels: Dict[str, list] = {}
        self._profiler = None

    def _on_queue_drop(self) -> None:
        with self.stats._lock:
            self.stats.video_frames_dropped += 1

    # ------------------------------------------------------------------ inputs

    # class name → (report type, rtp-family); mirrors the reference's
    # per-protocol report variants (`stats/input_reports.rs`)
    _INPUT_STATS_TYPES = {
        "Mp4Input": ("mp4", False),
        "HlsInput": ("hls", False),
        "RtpInputSource": ("rtp", True),
        "WhipServerInput": ("whip", True),
        "WhepClientInput": ("whep", True),
        "RtmpServerInput": ("rtmp", False),
        "MoqServerInput": ("moq_server", False),
        "MoqClientInput": ("moq_client", False),
    }
    _OUTPUT_STATS_TYPES = {
        "Mp4OutputSink": "mp4",
        "HlsOutputSink": "hls",
        "RtpOutputSink": "rtp",
        "RtmpClientOutput": "rtmp",
        "WhipClientOutput": "whip",
        "WhepServerOutput": "whep",
        "MoqClientOutput": "moq_client",
    }

    def register_input(
        self,
        input_id: str,
        source: InputSource,
        options: RegisterInputOptions = RegisterInputOptions(),
    ) -> InputSource:
        with self._lock:
            if input_id in self._inputs:
                raise ValueError(f"input {input_id!r} already registered")
            # offset semantics match the reference's `offset_ms`: the stream
            # starts exactly `offset` seconds after queue start (queue.rs:76-95)
            # side_channel_delay extends the input buffer so subscribers see
            # frames that long before they are due (reference queue.rs:96-102)
            qopts = QueueInputOptions(
                required=options.required,
                offset=("from_start", options.offset)
                if options.offset is not None
                else None,
                buffer_duration=options.buffer_duration
                + max(options.side_channel_delay, 0.0),
            )
            qi = self.queue.add_input(
                input_id, qopts,
                has_video=source.has_video, has_audio=source.has_audio,
            )
            vch, ach = qi.current.video, qi.current.audio
            video_channel = vch.channel if vch else None
            audio_channel = ach.channel if ach else None
            # wrap in side-channel tees if requested
            side_channels = []
            if options.side_channel_video or options.side_channel_audio:
                import tempfile

                from smelter_tpu_torch.pipeline.side_channel import (
                    AudioSideChannel,
                    TeeChannel,
                    VideoSideChannel,
                )

                sc_dir = options.side_channel_dir or os.path.join(
                    tempfile.gettempdir(), "smelter_side_channel"
                )
                if options.side_channel_video and video_channel is not None:
                    vsc = VideoSideChannel(sc_dir, input_id)
                    side_channels.append(vsc)
                    video_channel = TeeChannel(video_channel, vsc.publish)
                if options.side_channel_audio and audio_channel is not None:
                    asc = AudioSideChannel(
                        sc_dir, input_id, self.options.mixing_sample_rate
                    )
                    side_channels.append(asc)
                    audio_channel = TeeChannel(audio_channel, asc.publish)
            self._side_channels[input_id] = side_channels
            in_report = self._make_input_report(source)
            if in_report is not None:
                self.stats.register_input_report(input_id, in_report)
            ctx = InputCtx(
                input_id=input_id,
                video_channel=video_channel,
                audio_channel=audio_channel,
                mixing_sample_rate=self.options.mixing_sample_rate,
                video_meter=(
                    in_report.tracks.get("video") or in_report.tracks.get("video_rtp")
                ) if in_report else None,
                audio_meter=(
                    in_report.tracks.get("audio") or in_report.tracks.get("audio_rtp")
                ) if in_report else None,
            )
            if source.has_video:
                self.renderer.register_input(input_id)
            if source.has_audio:
                self.audio_mixer.register_input(
                    input_id, sample_rate=self.options.mixing_sample_rate
                )
            for out in self._outputs.values():
                out.video_end.on_input_registered(input_id)
                out.audio_end.on_input_registered(input_id)
            self._inputs[input_id] = source
            source.start(ctx)
            return source

    def _make_input_report(self, source: InputSource) -> Optional[ProtocolReport]:
        entry = self._INPUT_STATS_TYPES.get(type(source).__name__)
        if entry is None:
            return None
        kind, is_rtp = entry
        track_cls = RtpTrackStats if is_rtp else TrackStats
        suffix = "_rtp" if is_rtp else ""
        tracks = {}
        if source.has_video:
            tracks[f"video{suffix}"] = track_cls()
        if source.has_audio:
            tracks[f"audio{suffix}"] = track_cls()
        return ProtocolReport(type=kind, tracks=tracks)

    def unregister_input(
        self, input_id: str, schedule_time: Optional[float] = None
    ) -> None:
        """Remove an input now, or at queue PTS `schedule_time` (seconds
        since start) via the scheduled-event machinery, like update_output
        (unregister_request.rs). Scheduled removals raise nothing if the
        input is already gone by then."""
        if schedule_time is not None:
            def _run() -> None:
                try:
                    self.unregister_input(input_id)
                except KeyError:
                    pass
            self.queue.schedule_event(schedule_time, _run)
            return
        with self._lock:
            source = self._inputs.pop(input_id, None)
            if source is None:
                raise KeyError(input_id)
            source.stop()
            self.stats.unregister_input_report(input_id)
            for sc in self._side_channels.pop(input_id, []):
                sc.close()
            self.queue.remove_input(input_id)
            self.renderer.unregister_input(input_id)
            self.audio_mixer.unregister_input(input_id)
            for out in list(self._outputs.values()):
                if out.video_end.on_input_unregistered(input_id):
                    out.send_video_eos()
                if out.audio_end.on_input_unregistered(input_id):
                    out.send_audio_eos()

    def update_input(
        self,
        input_id: str,
        pause: Optional[bool] = None,
        seek: Optional[float] = None,
    ) -> None:
        """Pause/resume any input; seek MP4 inputs (reference
        `update_input.rs`: Pipeline::update_input)."""
        with self._lock:
            source = self._inputs.get(input_id)
            qi = self.queue.inputs.get(input_id)
            if source is None or qi is None:
                raise KeyError(input_id)
            if seek is not None:
                if not hasattr(source, "seek"):
                    raise ValueError(
                        f"input {input_id!r} does not support seeking"
                    )
                old = qi.current
                vch, ach = qi.add_track(
                    qi.options.offset,
                    has_video=source.has_video,
                    has_audio=source.has_audio,
                )
                # release the old reader (its sends fail) and drop the track
                if old.video is not None:
                    old.video.channel.close()
                if old.audio is not None:
                    old.audio.channel.close()
                qi.abort_current_track()
                ctx = InputCtx(
                    input_id=input_id,
                    video_channel=vch,
                    audio_channel=ach,
                    mixing_sample_rate=self.options.mixing_sample_rate,
                )
                source.seek(seek, ctx)
            if pause is True:
                qi.pause()
            elif pause is False:
                qi.resume()

    # ------------------------------------------------------------------ outputs

    def register_output(
        self,
        output_id: str,
        sink: OutputSink,
        video: Optional[OutputVideoOptions] = None,
        audio: Optional[OutputAudioOptions] = None,
    ) -> PipelineOutput:
        if video is None and audio is None:
            raise ValueError("output needs video and/or audio")
        with self._lock:
            if output_id in self._outputs:
                raise ValueError(f"output {output_id!r} already registered")
            if video is not None:
                if video.initial_root is None:
                    raise ValueError("video output requires an initial scene root")
                self.renderer.update_scene(
                    output_id, video.initial_root, video.resolution,
                    _render_format_for(video.encoder),
                )
            if audio is not None:
                cfg = audio.initial_mixer_config or AudioMixerConfig()
                self.audio_mixer.register_output(output_id, cfg)
            if hasattr(sink, "expect"):
                sink.expect(video is not None, audio is not None)
            fr = self.options.output_framerate
            out = PipelineOutput(
                output_id, sink, video, audio, fr.num, fr.den,
                current_inputs=set(self._inputs.keys()),
                on_done=self._on_output_done,
                mixing_sample_rate=self.options.mixing_sample_rate,
                on_error=self._on_output_error,
            )
            # sinks that receive RTCP PLI feedback propagate keyframe
            # requests into the encoder (reference handle_keyframe_requests)
            if hasattr(sink, "on_keyframe_request"):
                sink.on_keyframe_request = out.request_keyframe
            kind = self._OUTPUT_STATS_TYPES.get(type(sink).__name__)
            if kind is not None:
                tracks = {}
                if video is not None:
                    tracks["video"] = out.video_meter = TrackStats()
                if audio is not None:
                    tracks["audio"] = out.audio_meter = TrackStats()
                extras = None
                if kind == "whip":
                    extras = lambda: {  # noqa: E731
                        "is_connected": bool(getattr(sink, "is_connected", False)),
                        # receiver-report feedback (RFC 3550 §6.4.1)
                        "rtt_seconds": getattr(sink, "last_rtt_s", None),
                        "remote_fraction_lost": getattr(
                            sink, "remote_fraction_lost", None
                        ),
                    }
                elif kind == "whep":
                    extras = lambda: {  # noqa: E731
                        "connected_peers": int(getattr(sink, "connected_peers", 0)),
                        "rtt_seconds": getattr(sink, "last_rtt_s", None),
                        "remote_fraction_lost": getattr(
                            sink, "remote_fraction_lost", None
                        ),
                    }
                self.stats.register_output_report(
                    output_id, ProtocolReport(type=kind, tracks=tracks, extras=extras)
                )
            self._outputs[output_id] = out
            out.start()
            return out

    def unregister_output(
        self, output_id: str, schedule_time: Optional[float] = None
    ) -> None:
        """Remove an output now, or at queue PTS `schedule_time` (seconds
        since start), mirroring unregister_input."""
        if schedule_time is not None:
            def _run() -> None:
                try:
                    self.unregister_output(output_id)
                except KeyError:
                    pass
            self.queue.schedule_event(schedule_time, _run)
            return
        with self._lock:
            out = self._outputs.pop(output_id, None)
            if out is None:
                raise KeyError(output_id)
            self.stats.unregister_output_report(output_id)
            self.renderer.unregister_output(output_id)
            self.audio_mixer.unregister_output(output_id)
            out.send_video_eos()
            out.send_audio_eos()

    def update_output(
        self,
        output_id: str,
        root=None,
        audio_config: Optional[AudioMixerConfig] = None,
        schedule_time: Optional[float] = None,
    ) -> None:
        """Update video scene and/or audio mix live, or at `schedule_time`
        (seconds since start) via the queue's scheduled events."""
        if schedule_time is not None:
            self.queue.schedule_event(
                schedule_time,
                lambda: self.update_output(output_id, root, audio_config),
            )
            return
        with self._lock:
            out = self._outputs.get(output_id)
            if out is None:
                raise KeyError(output_id)
            if root is not None:
                if out.video_opts is None:
                    raise ValueError(f"output {output_id!r} has no video")
                self.renderer.update_scene(
                    output_id, root, out.video_opts.resolution,
                    _render_format_for(out.video_opts.encoder),
                )
            if audio_config is not None:
                if out.audio_opts is None:
                    raise ValueError(f"output {output_id!r} has no audio")
                self.audio_mixer.update_output(output_id, audio_config)

    def request_keyframe(self, output_id: str) -> None:
        with self._lock:
            out = self._outputs.get(output_id)
            if out is None:
                raise KeyError(output_id)
            out.request_keyframe()

    def _on_output_done(self, output_id: str) -> None:
        self.events.emit(Event("OUTPUT_DONE", output_id))

    def _on_output_error(self, output_id: str, err: str, stack: str) -> None:
        """A track chain of an output fully stopped. Wire properties match
        event.rs:63-68 exactly: output_id, severity, err, stack."""
        self.events.emit(Event(
            "OUTPUT_ERROR", output_id,
            properties={"severity": "critical", "err": err, "stack": stack},
        ))

    # ------------------------------------------------------------------ control

    def start(self) -> None:
        """Start the real-time loops (reference instance.rs:338-354)."""
        with self._lock:
            if self._started:
                raise RuntimeError("pipeline already started")
            self._started = True
            import time as _time

            self.stats.started_at = _time.time()
            if self.device.type == "cuda":
                # build and load the kernels now, so that the real-time
                # loop never waits on nvcc
                from smelter_tpu_torch.ops.hopper import build

                build.library()
            # tracing subsystem (reference uses `tracing` spans; here the
            # device-side story is a torch.profiler trace, env-gated)
            trace_dir = os.environ.get("SMELTER_TORCH_PROFILER_DIR")
            if trace_dir:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                self._profiler = profile(activities=activities)
                self._profiler.start()
                self._trace_dir = trace_dir
            self._video_channel = Channel(2)
            self._audio_channel = Channel(100)
            self.queue.start(self._video_channel, self._audio_channel)
            self.queue.spawn_thread()
            rt = threading.Thread(
                target=self._run_renderer, name="renderer", daemon=True
            )
            at = threading.Thread(target=self._run_mixer, name="mixer", daemon=True)
            rt.start()
            at.start()
            self._threads += [rt, at]

    def close(self) -> None:
        if self._profiler is not None:
            self._profiler.stop()
            os.makedirs(self._trace_dir, exist_ok=True)
            self._profiler.export_chrome_trace(os.path.join(self._trace_dir, "trace.json"))
            self._profiler = None
        self._closed.set()
        # close the render/mixer channels BEFORE joining the queue thread:
        # in AOT mode the queue sends without a deadline, so a stopped
        # renderer would otherwise leave it blocked forever
        if self._video_channel is not None:
            self._video_channel.close()
        if self._audio_channel is not None:
            self._audio_channel.close()
        self.queue.close()
        with self._lock:
            inputs = list(self._inputs.values())
            for src in inputs:
                src.stop()
            for scs in self._side_channels.values():
                for sc in scs:
                    sc.close()
            self._side_channels.clear()
            outs = list(self._outputs.values())
        for out in outs:
            out.close()
        # Join every stage so short-lived scripts exit cleanly: daemon
        # threads killed mid-codec-call at interpreter exit abort noisily
        # (the reference tears stages down via ownership drop; here an
        # explicit join-all plays that role).
        for src in inputs:
            join = getattr(src, "join", None)
            if join is not None:
                join(timeout=5.0)
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        self.renderer.close()

    def wait_for_outputs_done(self, timeout: Optional[float] = None) -> None:
        with self._lock:
            outs = list(self._outputs.values())
        for out in outs:
            out.join(timeout=timeout)

    # ------------------------------------------------------------------ loops

    def _run_renderer(self) -> None:
        """Renderer thread (reference run_renderer_thread, instance.rs:402-468)."""
        assert self._video_channel is not None
        while not self._closed.is_set():
            try:
                batch: QueueVideoOutput = self._video_channel.recv(timeout=0.5)
            except Closed:
                break
            except TimeoutError:
                continue
            if batch is None:
                continue
            # EOS bookkeeping → end conditions
            with self._lock:
                for iid, qf in batch.frames.items():
                    if qf.is_eos and iid not in self._video_eos_seen:
                        # the queue already emitted VIDEO_INPUT_EOS when it
                        # built this batch (single wire event per track,
                        # video_input.rs check_eos); here only end conditions
                        self._video_eos_seen.add(iid)
                        for out in self._outputs.values():
                            if out.video_end.on_input_eos(iid):
                                out.send_video_eos()
                outputs = dict(self._outputs)
            frames = {
                iid: qf.frame
                for iid, qf in batch.frames.items()
                if qf.frame is not None
            }
            frame_set = FrameSet(pts=batch.pts, frames=frames)
            import time as _time

            t0 = _time.perf_counter()
            rendered = self.renderer.render(frame_set)
            self.stats.on_render(_time.perf_counter() - t0, len(frames))
            for iid in frames:
                self.stats.on_input_frame(iid)
            for oid, frame in rendered.frames.items():
                out = outputs.get(oid)
                if out is None or out.video_channel is None:
                    continue
                if out.video_end.ended:
                    continue
                host = to_host_async(frame)
                try:
                    out.video_channel.send(host)
                    self.stats.on_output_frame(oid)
                except Closed:
                    pass

    def _run_mixer(self) -> None:
        """Audio mixer thread (reference run_audio_mixer_thread,
        instance.rs:470-534)."""
        assert self._audio_channel is not None
        while not self._closed.is_set():
            try:
                batch: QueueAudioOutput = self._audio_channel.recv(timeout=0.5)
            except Closed:
                break
            except TimeoutError:
                continue
            if batch is None:
                continue
            with self._lock:
                for iid, is_eos in batch.eos.items():
                    if is_eos and iid not in self._audio_eos_seen:
                        self._audio_eos_seen.add(iid)
                        for out in self._outputs.values():
                            if out.audio_end.on_input_eos(iid):
                                out.send_audio_eos()
                outputs = dict(self._outputs)
            mixed = self.audio_mixer.process_batch_set(
                batch.start_pts, batch.end_pts, batch.samples
            )
            self.stats.on_audio_chunk()
            for oid, (samples, pts) in mixed.items():
                out = outputs.get(oid)
                if out is None or out.audio_channel is None:
                    continue
                if out.audio_end.ended:
                    continue
                try:
                    out.audio_channel.send((samples, pts))
                except Closed:
                    pass
