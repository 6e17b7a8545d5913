"""Pipeline statistics for the /stats endpoint.

Scaled-down analogue of the reference stats monitor
(`smelter-core/src/stats/mod.rs:28-58`): the reference runs a dedicated
thread aggregating per-protocol input/output event streams; here the hot
loops bump atomic counters on a shared `PipelineStats` and `/stats` reads a
snapshot. Latency percentiles come from a fixed-size ring of recent frame
compose times.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional


class RollingLatency:
    """Keeps the last N samples; reports p50/p95/p99 in milliseconds."""

    def __init__(self, size: int = 600) -> None:
        self._samples: deque = deque(maxlen=size)
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        with self._lock:
            self._samples.append(seconds)

    def percentiles(self) -> Dict[str, Optional[float]]:
        with self._lock:
            data = sorted(self._samples)
        if not data:
            return {"p50_ms": None, "p95_ms": None, "p99_ms": None}

        def pct(p: float) -> float:
            idx = min(int(len(data) * p), len(data) - 1)
            return round(data[idx] * 1000.0, 3)

        return {"p50_ms": pct(0.50), "p95_ms": pct(0.95), "p99_ms": pct(0.99)}


class BitrateWindow:
    """Sliding-window byte meter: bits/sec over the last 1s and 60s windows
    (reference `stats/utils.rs` bitrate trackers; every per-protocol report
    in `stats/{input,output}_reports.rs` carries these two numbers)."""

    def __init__(self) -> None:
        self._events: deque = deque()  # (monotonic_t, nbytes)
        self._lock = threading.Lock()

    def add(self, nbytes: int) -> None:
        now = time.monotonic()
        with self._lock:
            self._events.append((now, nbytes))
            cutoff = now - 60.0
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()

    def report(self) -> Dict[str, int]:
        now = time.monotonic()
        with self._lock:
            cutoff = now - 60.0
            while self._events and self._events[0][0] < cutoff:
                self._events.popleft()
            b1 = sum(n for t, n in self._events if t >= now - 1.0)
            b60 = sum(n for _, n in self._events)
        return {
            "bitrate_1_second": b1 * 8,
            "bitrate_1_minute": (b60 * 8) // 60,
        }


class TrackStats:
    """Per-track meter for protocols whose report is just the bitrates
    (mp4/hls/rtmp tracks in the reference reports)."""

    def __init__(self) -> None:
        self.bitrate = BitrateWindow()

    def add_bytes(self, nbytes: int) -> None:
        self.bitrate.add(nbytes)

    def report(self) -> dict:
        return self.bitrate.report()


class RtpTrackStats(TrackStats):
    """RTP-family track meter (`RtpJitterBufferStatsReport`,
    `stats/input/rtp.rs:60-180`): packet totals, bitrates, and 10-second
    sliding windows of the effective buffer sampled at jitter-buffer WRITE
    (network-side margin: output pts + buffer vs wall clock as the packet
    lands) and at POP (slack left after reorder/buffering, rtp.rs:64-76),
    plus the input-buffer size sampled on pop."""

    def __init__(self) -> None:
        super().__init__()
        self.packets_received = 0
        self.packets_lost = 0
        self.packets_discarded = 0
        # (t, lost_delta, received_delta, eff_write, eff_pop, buffer_size)
        self._window: deque = deque()
        self._lock = threading.Lock()

    def on_packet(self, nbytes: int, effective_on_write: float) -> None:
        """A packet landed in the jitter buffer (rtp.rs EffectiveBufferOnWrite
        + RtpPacketReceived + BytesReceived)."""
        self.bitrate.add(nbytes)
        now = time.monotonic()
        with self._lock:
            self.packets_received += 1
            self._window.append((now, 0, 1, effective_on_write, None, None))
            self._prune(now)

    def on_pop(self, effective_on_pop: float, buffer_seconds: float) -> None:
        """A packet left the jitter buffer toward the decoder (rtp.rs
        EffectiveBufferOnPop + InputBufferSize, jitter_buffer.rs:247-252)."""
        now = time.monotonic()
        with self._lock:
            self._window.append(
                (now, 0, 0, None, effective_on_pop, buffer_seconds)
            )
            self._prune(now)

    def on_lost(self, count: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            self.packets_lost += count
            self._window.append((now, count, 0, None, None, None))
            self._prune(now)

    def on_discarded(self, count: int = 1) -> None:
        """A packet arrived too late to play (already skipped past). The gap
        was counted as a loss when the buffer skipped it; count the late
        arrival separately so /stats loss figures aren't double-inflated."""
        with self._lock:
            self.packets_discarded += count

    def _prune(self, now: float) -> None:
        cutoff = now - 10.0
        while self._window and self._window[0][0] < cutoff:
            self._window.popleft()

    def report(self) -> dict:
        with self._lock:
            self._prune(time.monotonic())
            entries = list(self._window)
            received = self.packets_received
            lost = self.packets_lost

        def agg(values, name):
            vals = [v for v in values if v is not None]
            if not vals:
                return {
                    f"{name}_avg_seconds": 0.0,
                    f"{name}_max_seconds": 0.0,
                    f"{name}_min_seconds": 0.0,
                }
            return {
                f"{name}_avg_seconds": round(sum(vals) / len(vals), 6),
                f"{name}_max_seconds": round(max(vals), 6),
                f"{name}_min_seconds": round(min(vals), 6),
            }

        win = {
            "packets_received": sum(r for _, _, r, _, _, _ in entries),
            "packets_lost": sum(l for _, l, _, _, _, _ in entries),
            **agg([w for *_, w, _, _ in entries], "effective_buffer_on_write"),
            **agg([p for *_, p, _ in entries], "effective_buffer_on_pop"),
            **agg([b for *_, b in entries], "input_buffer"),
        }
        return {
            "packets_received": received,
            "packets_lost": lost,
            "packets_discarded": self.packets_discarded,
            **self.bitrate.report(),
            "last_10_seconds": win,
        }


@dataclass
class ProtocolReport:
    """Per-input/output protocol stats (reference `InputStatsReport` /
    `OutputStatsReport` tagged unions): {"type": ..., <track>: {...}}."""

    type: str
    tracks: Dict[str, TrackStats]
    extras: Optional[object] = None  # callable returning extra fields

    def snapshot(self) -> dict:
        out: dict = {"type": self.type}
        for name, track in self.tracks.items():
            out[name] = track.report()
        if callable(self.extras):
            try:
                out.update(self.extras())
            except Exception:
                pass
        return out


@dataclass
class PipelineStats:
    started_at: Optional[float] = None
    video_frames_rendered: int = 0
    video_frames_dropped: int = 0
    audio_chunks_mixed: int = 0
    render_latency: RollingLatency = field(default_factory=RollingLatency)
    input_frames: Dict[str, int] = field(default_factory=dict)
    output_frames: Dict[str, int] = field(default_factory=dict)
    input_reports: Dict[str, ProtocolReport] = field(default_factory=dict)
    output_reports: Dict[str, ProtocolReport] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def register_input_report(self, input_id: str, report: ProtocolReport) -> None:
        with self._lock:
            self.input_reports[input_id] = report

    def register_output_report(self, output_id: str, report: ProtocolReport) -> None:
        with self._lock:
            self.output_reports[output_id] = report

    def unregister_input_report(self, input_id: str) -> None:
        with self._lock:
            self.input_reports.pop(input_id, None)

    def unregister_output_report(self, output_id: str) -> None:
        with self._lock:
            self.output_reports.pop(output_id, None)

    def on_render(self, seconds: float, n_inputs: int) -> None:
        with self._lock:
            self.video_frames_rendered += 1
        self.render_latency.record(seconds)

    def on_output_frame(self, output_id: str) -> None:
        with self._lock:
            self.output_frames[output_id] = self.output_frames.get(output_id, 0) + 1

    def on_input_frame(self, input_id: str) -> None:
        with self._lock:
            self.input_frames[input_id] = self.input_frames.get(input_id, 0) + 1

    def on_audio_chunk(self) -> None:
        with self._lock:
            self.audio_chunks_mixed += 1


def collect_stats(pipeline) -> dict:
    """Builds the /stats JSON report."""
    stats: PipelineStats = pipeline.stats
    with stats._lock:
        report = {
            "uptime_s": round(time.time() - stats.started_at, 3)
            if stats.started_at
            else None,
            "video_frames_rendered": stats.video_frames_rendered,
            "video_frames_dropped": stats.video_frames_dropped,
            "audio_chunks_mixed": stats.audio_chunks_mixed,
            "compose_latency": stats.render_latency.percentiles(),
            "inputs": {
                iid: {"frames_delivered": n} for iid, n in stats.input_frames.items()
            },
            "outputs": {
                oid: {
                    "frames_rendered": n,
                    "encoded_packets": getattr(
                        pipeline._outputs.get(oid), "encoded_video_packets", 0
                    )
                    if oid in pipeline._outputs
                    else 0,
                }
                for oid, n in stats.output_frames.items()
            },
        }
        input_reports = dict(stats.input_reports)
        output_reports = dict(stats.output_reports)
    # per-protocol reports (reference InputStatsReport / OutputStatsReport)
    for iid, rep in input_reports.items():
        report["inputs"].setdefault(iid, {})["stats"] = rep.snapshot()
    for oid, rep in output_reports.items():
        report["outputs"].setdefault(oid, {})["stats"] = rep.snapshot()
    # live queue occupancy per input (reference EffectiveBuffer reports)
    try:
        for iid, buf in pipeline.queue.buffer_report().items():
            report["inputs"].setdefault(iid, {})["buffer"] = buf
    except Exception:
        pass
    # per-subsystem spans (SURVEY §5 tracing row; utils/tracing.py)
    from smelter_tpu_torch.utils import tracing

    report["spans"] = tracing.report()
    report["counters"] = tracing.counters()
    return report
