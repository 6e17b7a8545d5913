"""Queue: the real-time A/V synchronization engine.

Python re-implementation of the reference queue
(`smelter-core/src/queue.rs` + `queue/queue_thread.rs` + `queue/video_input.rs`
+ `queue/audio_input.rs`):

- All queue PTS are seconds measured from ``sync_point`` (captured at queue
  construction). ``start_pts`` is when `start()` was called.
- Inputs produce PTS in their own track timebase; a per-track offset maps them
  into queue time. Offset modes: explicit ``pts`` (realtime protocols align to
  sync_point), ``from_start`` (files start at queue start + d), or ``None``
  (resolved on first packet).
- A tick loop (default 5 ms) arbitrates: the earliest of next-video-PTS
  (frame counter / output framerate), next-audio-chunk (20 ms chunks), or a
  scheduled event fires. Video framesets pick, per input, the newest frame
  not newer than the tick PTS; non-required batches are sent with a deadline
  and dropped when late.
- ``required`` inputs block the tick until ready; optional inputs only until
  the real-time deadline passes.
- Multiple tracks queue back-to-back (MP4 seek/loop); `abort_old_track`
  forces an immediate swap.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from smelter_tpu_torch.core.types import AudioSamples, Frame, Framerate
from smelter_tpu_torch.utils.channels import Channel, Closed

logger = logging.getLogger("smelter.queue")

DEFAULT_AUDIO_CHUNK = 0.020
DEFAULT_TICK = 0.005
DEFAULT_BUFFER = 0.100  # per-input frame buffer (reference max_size 100ms)
MAX_PENDING_TRACKS = 2


class MonotonicClock:
    """Seconds since an arbitrary origin; swap for a fake clock in tests."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


@dataclass
class QueueVideoFrame:
    frame: Optional[Frame]
    is_eos: bool = False


@dataclass
class QueueVideoOutput:
    pts: float
    frames: Dict[str, QueueVideoFrame]
    required: bool = False


@dataclass
class QueueAudioOutput:
    start_pts: float
    end_pts: float
    samples: Dict[str, List[AudioSamples]]
    eos: Dict[str, bool] = field(default_factory=dict)
    required: bool = False


@dataclass
class QueueInputOptions:
    required: bool = False
    # offset mode: ("pts", seconds) | ("from_start", seconds) | None
    offset: Optional[Tuple[str, float]] = None
    buffer_duration: float = DEFAULT_BUFFER


class _TrackOffset:
    """Offset shared between a track's video and audio receivers."""

    def __init__(self, value: Optional[float] = None) -> None:
        self._value = value

    def get(self) -> Optional[float]:
        return self._value

    def get_or_init(self, value: float) -> float:
        if self._value is None:
            self._value = value
        return self._value


class _VideoReceiver:
    """Per-track frame buffer (reference VideoInputReceiver)."""

    def __init__(self, buffer_duration: float) -> None:
        self.channel: Channel[Optional[Frame]] = Channel(1)
        self.buffer: deque = deque()
        self.max_size = buffer_duration
        self.disconnected = False
        self.state = "new"  # new | running | done

    def _try_enqueue(self) -> None:
        while not self.disconnected:
            if self._size() >= self.max_size:
                return
            try:
                frame = self.channel.try_recv()
            except Closed:
                frame = None
                self.disconnected = True
                self._maybe_done()
                return
            if frame is None:
                if self.channel.closed:
                    self.disconnected = True
                    self._maybe_done()
                return
            self.buffer.append(frame)
            self.state = "running"

    def _size(self) -> float:
        if len(self.buffer) >= 2:
            return self.buffer[-1].pts - self.buffer[0].pts
        return 0.0

    def _maybe_done(self) -> None:
        if self.disconnected and not self.buffer:
            self.state = "done"

    def _prepare_for_pts(self, pts: float) -> None:
        while True:
            self._try_enqueue()
            dropped = False
            while len(self.buffer) >= 2 and self.buffer[1].pts <= pts:
                self.buffer.popleft()
                dropped = True
            if not dropped:
                self._maybe_done()
                return

    def get_for_pts(self, pts: float) -> Optional[Frame]:
        if self.state == "done":
            return None
        self._prepare_for_pts(pts)
        if not self.buffer or self.buffer[0].pts > pts:
            return None
        if self.disconnected and len(self.buffer) == 1:
            frame = self.buffer.popleft()
            self._maybe_done()
            return frame
        return self.buffer[0]

    def is_ready_for_pts(self, pts: float) -> bool:
        if self.disconnected:
            return True
        self._prepare_for_pts(pts)
        if self.buffer and self.buffer[0].pts > pts:
            return True
        if len(self.buffer) >= 2 and self.buffer[1].pts > pts:
            return True
        return False

    def get_state(self) -> str:
        self._try_enqueue()
        return self.state


class _AudioReceiver:
    """Per-track audio chunk buffer (reference AudioInputReceiver)."""

    def __init__(self, buffer_duration: float) -> None:
        self.channel: Channel[Optional[AudioSamples]] = Channel(2)
        self.buffer: deque = deque()
        self.max_size = buffer_duration + 0.080  # + mixer stretch buffer
        self.disconnected = False
        self.state = "new"

    def _try_enqueue(self, needed_pts: Optional[float] = None) -> None:
        """Fill the buffer from the channel. `max_size` bounds steady-state
        depth, but when the caller needs samples up to `needed_pts` the
        buffer may grow PAST it until that pts is covered (reference
        audio_input.rs try_enqueue_until:296-311) — otherwise a pause longer
        than the buffer leaves stale batches pinned at max_size and a
        required input deadlocks the whole queue on resume."""
        while not self.disconnected:
            has_needed = (
                needed_pts is None
                or (bool(self.buffer)
                    and self.buffer[-1].start_pts >= needed_pts)
            )
            if has_needed and self._size() >= self.max_size:
                return
            try:
                item = self.channel.try_recv()
            except Closed:
                self.disconnected = True
                self._maybe_done()
                return
            if item is None:
                if self.channel.closed:
                    self.disconnected = True
                    self._maybe_done()
                return
            self.buffer.append(item)
            self.state = "running"

    def _size(self) -> float:
        if len(self.buffer) >= 2:
            return self.buffer[-1].start_pts - self.buffer[0].start_pts
        return 0.0

    def _maybe_done(self) -> None:
        if self.disconnected and not self.buffer:
            self.state = "done"

    def pop_for_range(self, end_pts: float) -> List[AudioSamples]:
        """Pop every batch with start_pts < end_pts (each exactly once)."""
        self._try_enqueue(end_pts)
        out = []
        while self.buffer and self.buffer[0].start_pts < end_pts:
            out.append(self.buffer.popleft())
            self._try_enqueue(end_pts)
        self._maybe_done()
        return out

    def is_ready_for_range(self, end_pts: float) -> bool:
        if self.disconnected:
            return True
        self._try_enqueue(end_pts)
        return bool(self.buffer) and self.buffer[-1].start_pts >= end_pts

    def get_state(self) -> str:
        self._try_enqueue()
        return self.state


@dataclass
class _Track:
    offset_mode: Optional[Tuple[str, float]]
    track_offset: _TrackOffset
    video: Optional[_VideoReceiver]
    audio: Optional[_AudioReceiver]
    video_eos_sent: bool = False
    audio_eos_sent: bool = False


class QueueInput:
    """One input: current track + pending tracks, pause state, events."""

    def __init__(
        self,
        input_id: str,
        options: QueueInputOptions,
        queue: "Queue",
        has_video: bool = True,
        has_audio: bool = True,
    ) -> None:
        self.input_id = input_id
        self.options = options
        self.queue = queue
        self._lock = threading.RLock()
        self.paused_pts: Optional[float] = None
        self.paused_frame: Optional[Frame] = None
        self._tracks: deque = deque()
        self._events_emitted: set = set()
        self.add_track(options.offset, has_video=has_video, has_audio=has_audio)

    # -- track management (reference queue_input.rs:300-324) --------------------

    def add_track(
        self,
        offset: Optional[Tuple[str, float]],
        has_video: bool = True,
        has_audio: bool = True,
    ) -> Tuple[Optional[Channel], Optional[Channel]]:
        with self._lock:
            if len(self._tracks) > MAX_PENDING_TRACKS:
                raise RuntimeError("too many pending tracks")
            offset_value = offset[1] if offset and offset[0] == "pts" else None
            track = _Track(
                offset_mode=offset,
                track_offset=_TrackOffset(offset_value),
                video=_VideoReceiver(self.options.buffer_duration) if has_video else None,
                audio=_AudioReceiver(self.options.buffer_duration) if has_audio else None,
            )
            self._tracks.append(track)
            return (
                track.video.channel if track.video else None,
                track.audio.channel if track.audio else None,
            )

    def abort_current_track(self) -> None:
        with self._lock:
            if len(self._tracks) > 1:
                self._tracks.popleft()

    def maybe_start_next_track(self) -> None:
        """Swap to the next queued track once the current one fully ended."""
        with self._lock:
            if len(self._tracks) <= 1:
                return
            cur = self._tracks[0]
            video_done = cur.video is None or (
                cur.video.get_state() == "done" and cur.video_eos_sent
            )
            audio_done = cur.audio is None or (
                cur.audio.get_state() == "done" and cur.audio_eos_sent
            )
            if video_done and audio_done:
                self._tracks.popleft()

    @property
    def current(self) -> _Track:
        return self._tracks[0]

    def required(self) -> bool:
        return self.options.required

    def media_done(self) -> bool:
        """True once every track fully ended (EOS sent for both media)."""
        with self._lock:
            if len(self._tracks) > 1:
                return False
            t = self.current
            video_done = t.video is None or (
                t.video.get_state() == "done" and t.video_eos_sent
            )
            audio_done = t.audio is None or (
                t.audio.get_state() == "done" and t.audio_eos_sent
            )
            return video_done and audio_done

    # -- pause/resume -------------------------------------------------------------

    def pause(self) -> None:
        with self._lock:
            if self.paused_pts is not None:
                return
            pts = self.queue.last_pts
            self.paused_frame = None
            if self.queue.start_pts is not None:
                offset = self._resolve_offset(pts, self.queue.start_pts)
                if offset is not None and self.current.video is not None:
                    input_pts = pts - offset
                    if input_pts >= 0:
                        self.paused_frame = self.current.video.get_for_pts(input_pts)
            self.paused_pts = pts
            # PAUSED is not once-guarded (each pause re-notifies,
            # video_input.rs:106-108); emit per present track
            if self.current.video is not None:
                self.queue.emit_event(self.input_id, "paused")
            if self.current.audio is not None:
                self.queue.emit_event(self.input_id, "audio:paused")

    def resume(self) -> None:
        with self._lock:
            if self.paused_pts is None:
                return
            self.paused_pts = None
            self.paused_frame = None
            self._rearm_playing()

    # -- offset resolution (reference video_input.rs resolve_offset) --------------

    def _offset_from_start(self) -> Optional[float]:
        mode = self.current.offset_mode
        if mode and mode[0] == "from_start":
            return mode[1]
        return None

    def _resolve_offset(
        self, buffer_pts: float, start_pts: float, media: str = "video"
    ) -> Optional[float]:
        track = self.current
        receiver = track.video or track.audio
        if receiver is None or receiver.get_state() != "running":
            return track.track_offset.get()
        # DELIVERED is per track: only emit when THIS media's receiver has
        # actually received something (offset resolution stays driven by the
        # primary receiver, but a lagging audio decoder must not look
        # delivered just because video is)
        own = track.video if media == "video" else track.audio
        if own is receiver or (
            own is not None and own.get_state() == "running"
        ):
            self._emit_once("delivered", media)
        ofs = self._offset_from_start()
        if ofs is not None:
            return track.track_offset.get_or_init(ofs + start_pts)
        return track.track_offset.get_or_init(buffer_pts)

    def _emit_once(self, kind: str, media: str = "video") -> None:
        """Per-track one-shot wire events (the reference keeps one
        EmitOnceGuard per VideoQueueInput / AudioQueueInput; this input
        handles both media, so the guard key carries the track)."""
        key = kind if media == "video" else f"audio:{kind}"
        if key not in self._events_emitted:
            self._events_emitted.add(key)
            self.queue.emit_event(self.input_id, key)

    def _rearm_playing(self) -> None:
        """After resume, the next served frame/samples re-emit PLAYING
        (video_input.rs resume: 'it will send playing event on next
        frame')."""
        self._events_emitted.discard("playing")
        self._events_emitted.discard("audio:playing")

    # -- video -----------------------------------------------------------------------

    def get_frame(self, pts: float, start_pts: float) -> QueueVideoFrame:
        with self._lock:
            track = self.current
            if track.video is None:
                return QueueVideoFrame(None)
            if self.paused_pts is not None:
                offset = track.track_offset.get()
                if offset is None or self.paused_frame is None:
                    return QueueVideoFrame(None)
                f = self.paused_frame
                shifted = Frame(f.data, f.format, f.resolution,
                                f.pts + offset + max(pts - self.paused_pts, 0.0))
                return QueueVideoFrame(shifted)
            offset = self._resolve_offset(pts, start_pts)
            if offset is None or pts < offset:
                return QueueVideoFrame(None, is_eos=self._check_video_eos())
            frame = track.video.get_for_pts(pts - offset)
            if frame is not None:
                self._emit_once("playing", "video")
                frame = Frame(
                    frame.data, frame.format, frame.resolution, frame.pts + offset
                )
            return QueueVideoFrame(frame, is_eos=self._check_video_eos())

    def _check_video_eos(self) -> bool:
        track = self.current
        if track.video is None:
            return False
        if track.video.get_state() == "done" and not track.video_eos_sent:
            track.video_eos_sent = True
            self._emit_once("eos", "video")
            return True
        return False

    def is_video_ready(self, pts: float, start_pts: float) -> bool:
        with self._lock:
            track = self.current
            if track.video is None or self.paused_pts is not None:
                return True
            offset = self._resolve_offset(pts, start_pts)
            if offset is not None:
                return track.video.is_ready_for_pts(max(pts - offset, 0.0))
            state = track.video.get_state()
            if state == "new":
                ofs = self._offset_from_start()
                if ofs is not None:
                    return pts - start_pts < ofs
                return True
            return True

    # -- audio ---------------------------------------------------------------------

    def pop_audio(
        self, pts_range: Tuple[float, float], start_pts: float
    ) -> Tuple[List[AudioSamples], bool]:
        with self._lock:
            track = self.current
            if track.audio is None or self.paused_pts is not None:
                return ([], False)
            offset = self._resolve_offset(pts_range[0], start_pts, "audio")
            if offset is None:
                return ([], self._check_audio_eos())
            batches = track.audio.pop_for_range(pts_range[1] - offset)
            if batches:
                self._emit_once("playing", "audio")
            shifted = [
                AudioSamples(b.samples, b.start_pts + offset) for b in batches
            ]
            return (shifted, self._check_audio_eos())

    def _check_audio_eos(self) -> bool:
        track = self.current
        if track.audio is None:
            return False
        if track.audio.get_state() == "done" and not track.audio_eos_sent:
            track.audio_eos_sent = True
            self._emit_once("eos", "audio")
            return True
        return False

    def is_audio_ready(self, pts_range: Tuple[float, float], start_pts: float) -> bool:
        with self._lock:
            track = self.current
            if track.audio is None or self.paused_pts is not None:
                return True
            offset = self._resolve_offset(pts_range[0], start_pts, "audio")
            if offset is not None:
                return track.audio.is_ready_for_range(pts_range[1] - offset)
            state = track.audio.get_state()
            if state == "new":
                ofs = self._offset_from_start()
                if ofs is not None:
                    return pts_range[0] - start_pts < ofs
                return True
            return True

    def drop_old_before_start(self, now: float) -> None:
        """Pre-start cleanup: realtime inputs with no explicit offset align to
        wall clock and discard stale frames (reference
        drop_old_frames_before_start)."""
        with self._lock:
            track = self.current
            if track.offset_mode is not None:
                # explicit offsets keep everything buffered
                if track.offset_mode[0] == "pts" and track.video is not None:
                    if track.video.get_state() != "new":
                        offset = track.track_offset.get() or 0.0
                        track.video.is_ready_for_pts(max(now - offset, 0.0))
                return
            if track.video is not None and track.video.get_state() != "new":
                self._emit_once("delivered")
                offset = track.track_offset.get_or_init(now)
                track.video.is_ready_for_pts(max(now - offset, 0.0))


@dataclass
class QueueOptions:
    output_framerate: Framerate = Framerate(30)
    ahead_of_time_processing: bool = False
    run_late_scheduled_events: bool = False
    never_drop_output_frames: bool = False
    tick_duration: float = DEFAULT_TICK
    audio_chunk_duration: float = DEFAULT_AUDIO_CHUNK


class Queue:
    """Owns inputs and the tick loop; emits QueueVideoOutput/QueueAudioOutput
    into bounded channels provided at `start`."""

    def __init__(
        self,
        options: QueueOptions = QueueOptions(),
        clock: Optional[MonotonicClock] = None,
        event_callback: Optional[Callable[[str, str], None]] = None,
        drop_callback: Optional[Callable[[], None]] = None,
    ) -> None:
        self._drop_callback = drop_callback
        self.options = options
        self.clock = clock or MonotonicClock()
        self._sync_origin = self.clock.now()
        self.inputs: Dict[str, QueueInput] = {}
        self._lock = threading.RLock()
        self.start_pts: Optional[float] = None
        self.last_pts: float = 0.0
        self._video_counter = 0
        self._audio_counter = 0
        self._video_sender: Optional[Channel] = None
        self._audio_sender: Optional[Channel] = None
        self._scheduled: List[Tuple[float, Callable[[], None]]] = []
        self._should_close = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._event_callback = event_callback

    # -- time ---------------------------------------------------------------------

    def now(self) -> float:
        """Queue PTS now: seconds since sync_point."""
        return self.clock.now() - self._sync_origin

    def emit_event(self, input_id: str, kind: str) -> None:
        if self._event_callback:
            self._event_callback(input_id, kind)

    # -- registration ----------------------------------------------------------------

    def add_input(
        self,
        input_id: str,
        options: QueueInputOptions,
        has_video: bool = True,
        has_audio: bool = True,
    ) -> QueueInput:
        with self._lock:
            qi = QueueInput(input_id, options, self, has_video, has_audio)
            self.inputs[input_id] = qi
            return qi

    def remove_input(self, input_id: str) -> None:
        with self._lock:
            self.inputs.pop(input_id, None)

    def schedule_event(self, pts: float, callback: Callable[[], None]) -> None:
        with self._lock:
            if self.start_pts is not None:
                next_video = self._next_video_pts()
                next_audio = self._next_audio_range()[0]
                min_pts = min(next_video, next_audio)
                if (
                    pts + self.start_pts < min_pts
                    and not self.options.run_late_scheduled_events
                ):
                    return
            self._scheduled.append((pts, callback))
            self._scheduled.sort(key=lambda x: x[0])

    # -- start / stop --------------------------------------------------------------------

    def start(self, video_sender: Channel, audio_sender: Channel) -> None:
        with self._lock:
            self.start_pts = self.now()
            self._video_sender = video_sender
            self._audio_sender = audio_sender

    def spawn_thread(self) -> threading.Thread:
        t = threading.Thread(target=self._run, name="queue", daemon=True)
        self._thread = t
        t.start()
        return t

    def buffer_report(self) -> Dict[str, Dict[str, float]]:
        """Per-input buffered media duration (seconds) in the current
        track — the live analogue of the reference's EffectiveBuffer
        stats (stats/input/hls.rs:59): how much decoded media sits
        between the decoder and the tick consumer right now."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for iid, qi in self.inputs.items():
                entry: Dict[str, float] = {}
                tracks = getattr(qi, "_tracks", None)
                if tracks:
                    cur = tracks[0]
                    if cur.video is not None:
                        entry["video_buffer_s"] = round(cur.video._size(), 4)
                    if cur.audio is not None:
                        entry["audio_buffer_s"] = round(cur.audio._size(), 4)
                out[iid] = entry
        return out

    def close(self) -> None:
        self._should_close.set()
        # unblock any producer stuck on a bounded per-track channel (AOT
        # mode sends without deadline), otherwise decode threads outlive
        # the pipeline and short scripts abort noisily at interpreter exit
        with self._lock:
            inputs = list(self.inputs.values())
        for qi in inputs:
            for track in list(getattr(qi, "_tracks", ())):
                for recv in (track.video, track.audio):
                    if recv is not None:
                        recv.channel.close()
        if self._thread:
            self._thread.join(timeout=5.0)

    def _run(self) -> None:
        from smelter_tpu_torch.utils import tracing

        while not self._should_close.is_set():
            with tracing.span("queue.tick"):
                if self.start_pts is None:
                    self.cleanup_before_start()
                else:
                    self.on_tick()
            self.clock.sleep(self.options.tick_duration)

    # -- pre-start --------------------------------------------------------------------

    def cleanup_before_start(self) -> None:
        now = self.now()
        with self._lock:
            for qi in self.inputs.values():
                qi.drop_old_before_start(now)

    # -- tick (reference queue_thread.rs:136-192) ------------------------------------

    def _next_video_pts(self) -> float:
        fr = self.options.output_framerate
        return self._video_counter * fr.den / fr.num + (self.start_pts or 0.0)

    def _next_audio_range(self) -> Tuple[float, float]:
        d = self.options.audio_chunk_duration
        s = self.start_pts or 0.0
        return (s + d * self._audio_counter, s + d * (self._audio_counter + 1))

    def on_tick(self) -> None:
        """Process as many buffers as are due; called every tick."""
        while not self._should_close.is_set():
            callback = None
            with self._lock:
                audio_range = self._next_audio_range()
                video_pts = self._next_video_pts()
                event_pts = (
                    self._scheduled[0][0] + (self.start_pts or 0.0)
                    if self._scheduled
                    else None
                )
                if (
                    event_pts is not None
                    and event_pts < video_pts
                    and event_pts < audio_range[0]
                ):
                    self.last_pts = event_pts
                    _, callback = self._scheduled.pop(0)
            if callback is not None:
                # run OUTSIDE self._lock: callbacks re-enter pipeline methods
                # that take Pipeline._lock then Queue._lock — invoking them
                # under Queue._lock inverts that order against concurrent
                # immediate register/unregister calls (ABBA deadlock). And a
                # raising callback must not kill the queue thread.
                try:
                    callback()
                except Exception:  # noqa: BLE001
                    logger.exception("scheduled queue event failed")
                continue
            if video_pts > audio_range[0]:
                if not self._try_push_audio(audio_range):
                    break
            else:
                if not self._try_push_video(video_pts):
                    break

    def _try_push_video(self, pts: float) -> bool:
        with self._lock:
            for qi in self.inputs.values():
                qi.maybe_start_next_track()
            statuses = [
                (qi.is_video_ready(pts, self.start_pts), qi.required())
                for qi in self.inputs.values()
            ]
            if not self.options.ahead_of_time_processing and pts > self.now():
                return False
            if (
                self.options.ahead_of_time_processing
                and pts > self.now()
                and all(qi.media_done() for qi in self.inputs.values())
            ):
                # nothing left to process ahead of time - pace by the clock
                return False
            all_ready = all(ready for ready, _ in statuses)
            if not all_ready:
                required_ready = all(ready for ready, req in statuses if req)
                if not required_ready:
                    return False
                if pts >= self.now():
                    return False
            frames = {}
            required = False
            for iid, qi in self.inputs.items():
                ev = qi.get_frame(pts, self.start_pts)
                required = required or qi.required() or ev.is_eos
                frames[iid] = ev
            self.last_pts = pts
            batch = QueueVideoOutput(pts=pts, frames=frames, required=required)
            batch.required = batch.required or self.options.never_drop_output_frames
            self._video_counter += 1
        self._send(self._video_sender, batch, batch.required, pts)
        return True

    def _try_push_audio(self, pts_range: Tuple[float, float]) -> bool:
        with self._lock:
            ready = all(
                qi.is_audio_ready(pts_range, self.start_pts) or not qi.required()
                for qi in self.inputs.values()
            )
            all_ready = all(
                qi.is_audio_ready(pts_range, self.start_pts)
                for qi in self.inputs.values()
            )
            if not self.options.ahead_of_time_processing and pts_range[0] > self.now():
                return False
            if (
                self.options.ahead_of_time_processing
                and pts_range[0] > self.now()
                and all(qi.media_done() for qi in self.inputs.values())
            ):
                return False
            if not all_ready:
                if not ready:
                    return False
                if pts_range[0] >= self.now():
                    return False
            samples: Dict[str, List[AudioSamples]] = {}
            eos: Dict[str, bool] = {}
            required = False
            for iid, qi in self.inputs.items():
                batches, is_eos = qi.pop_audio(pts_range, self.start_pts)
                samples[iid] = batches
                eos[iid] = is_eos
                required = required or qi.required() or is_eos
            self.last_pts = pts_range[0]
            batch = QueueAudioOutput(
                start_pts=pts_range[0],
                end_pts=pts_range[1],
                samples=samples,
                eos=eos,
                required=required or self.options.never_drop_output_frames,
            )
            self._audio_counter += 1
        self._send(self._audio_sender, batch, batch.required, batch.start_pts)
        return True

    def _send(self, sender: Optional[Channel], item, required: bool, pts: float):
        if sender is None:
            return
        try:
            if required:
                sender.send(item)
            else:
                deadline = self._sync_origin + pts
                delivered = sender.send_deadline(
                    item, deadline, clock=self.clock.now
                )
                if not delivered and self._drop_callback is not None:
                    self._drop_callback()
        except Closed:
            pass
