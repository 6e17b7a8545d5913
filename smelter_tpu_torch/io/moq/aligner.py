"""A/V timestamp aligner for MoQ inputs.

Behavioral match of the reference's
`moq/input/connection/timestamp_aligner.rs` (constants and semantics):
both tracks normalize raw PTS epochs against one shared wall-clock anchor.
If the measured A/V skew between first frames is small (<= AV_SKEW_MAX)
the stream locks immediately to the first timestamp seen on either track
(anchor mode, relative A/V offset preserved by construction); otherwise —
large skew, a warmup deadline firing before the counterpart's first frame,
or an epoch discontinuity — every track runs per-track live-edge
estimation: running max of (raw - elapsed), locking when the max plateaus
for PLATEAU_FRAMES frames or the warmup deadline passes. Frames are held
until lock so output is monotonic by construction; `flush()` force-locks
at EOS so sub-warmup clips still render.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

AV_SKEW_MAX = 2.0                 # timestamp_aligner.rs:15
MOQ_EPOCH_MAX_WARMUP = 1.0        # :18
PLATEAU_FRAMES = 3                # :22
PLATEAU_EPSILON = 0.005           # :24
MOQ_EPOCH_MIN_STEP = 0.100        # :27
MOQ_EPOCH_OFFSET_JUMP = 2.0       # :33

MODE_ANCHOR = "anchor"
MODE_LIVE_EDGE = "live_edge"


@dataclass
class AlignedChunk:
    pts: float
    keyframe: bool
    data: bytes


class EpochShared:
    """Shared across the audio and video track tasks (set-once slots)."""

    def __init__(self, clock=time.monotonic) -> None:
        self._clock = clock
        self._lock = threading.Lock()
        self._anchor: Optional[float] = None
        self._anchor_offset: Optional[float] = None
        self._first_offsets: dict = {}
        self._mode: Optional[str] = None

    def elapsed(self) -> float:
        with self._lock:
            if self._anchor is None:
                self._anchor = self._clock()
            return self._clock() - self._anchor

    def set_first_track_offset(self, kind: str, offset: float) -> None:
        with self._lock:
            self._first_offsets.setdefault(kind, offset)

    def first_offset(self, kind: str) -> Optional[float]:
        with self._lock:
            return self._first_offsets.get(kind)

    def set_anchor_offset(self, offset: float) -> None:
        with self._lock:
            if self._anchor_offset is None:
                self._anchor_offset = offset

    def anchor_offset(self) -> Optional[float]:
        with self._lock:
            return self._anchor_offset

    def decide_mode(self, mode: str) -> str:
        with self._lock:
            if self._mode is None:
                self._mode = mode
            return self._mode

    def mode(self) -> Optional[str]:
        with self._lock:
            return self._mode


class TimestampAligner:
    """Per-track; see module docstring."""

    def __init__(self, shared: EpochShared, kind: str,
                 single_track_stream: bool) -> None:
        self.shared = shared
        self.kind = kind
        self.other = "audio" if kind == "video" else "video"
        self.single_track_stream = single_track_stream
        self.epoch_start_elapsed: Optional[float] = None
        self.max_offset: Optional[float] = None
        self.plateau_frames = 0
        self.held: List[AlignedChunk] = []
        self.locked_offset: Optional[float] = None
        self.first_epoch = True
        self.previous: Optional[Tuple[float, float]] = None  # (raw, offset)

    def is_locked(self) -> bool:
        return self.locked_offset is not None

    def reset(self) -> None:
        self.locked_offset = None
        self.max_offset = None
        self.plateau_frames = 0
        self.epoch_start_elapsed = None
        self.first_epoch = False
        self.held.clear()

    def on_chunk(self, keyframe: bool, raw_pts: float,
                 data: bytes) -> List[AlignedChunk]:
        elapsed = self.shared.elapsed()
        offset = raw_pts - elapsed
        if self._is_discontinuity(keyframe, raw_pts, offset):
            # a discontinuity proves the publisher is not single-epoch
            self.shared.decide_mode(MODE_LIVE_EDGE)
            self.reset()
        self.previous = (raw_pts, offset)
        if self.locked_offset is not None:
            return [AlignedChunk(max(raw_pts - self.locked_offset, 0.0),
                                 keyframe, data)]
        return self._advance_warmup(raw_pts, elapsed, keyframe, data)

    def _is_discontinuity(self, keyframe: bool, raw: float,
                          offset: float) -> bool:
        if not keyframe or self.previous is None:
            return False
        prev_raw, prev_offset = self.previous
        if raw >= prev_raw and raw - prev_raw < MOQ_EPOCH_MIN_STEP:
            return False
        if raw < prev_raw:
            return True
        return abs(offset - prev_offset) > MOQ_EPOCH_OFFSET_JUMP

    def _advance_warmup(self, raw: float, elapsed: float, keyframe: bool,
                        data: bytes) -> List[AlignedChunk]:
        offset = raw - elapsed
        if self.first_epoch and self.epoch_start_elapsed is None:
            self.shared.set_first_track_offset(self.kind, offset)
            self.shared.set_anchor_offset(offset)
        prev = self.max_offset
        self.max_offset = offset if prev is None else max(prev, offset)
        if prev is not None and abs(self.max_offset - prev) <= PLATEAU_EPSILON:
            self.plateau_frames += 1
        else:
            self.plateau_frames = 0
        self.held.append(AlignedChunk(raw, keyframe, data))
        if self.epoch_start_elapsed is None:
            self.epoch_start_elapsed = elapsed
        started = self.epoch_start_elapsed

        if self.first_epoch:
            mode = self._resolve_mode(elapsed, started)
            if mode == MODE_ANCHOR:
                anchor = self.shared.anchor_offset()
                assert anchor is not None
                return self._lock_and_flush(anchor)
            if mode is None:
                return []
            # live-edge: fall through

        if self.plateau_frames >= PLATEAU_FRAMES or \
                elapsed - started > MOQ_EPOCH_MAX_WARMUP:
            return self._lock_and_flush(self.max_offset)
        return []

    def _resolve_mode(self, elapsed: float, started: float) -> Optional[str]:
        mode = self.shared.mode()
        if mode is not None:
            return mode
        if self.single_track_stream:
            return self.shared.decide_mode(MODE_ANCHOR)
        other_first = self.shared.first_offset(self.other)
        if other_first is None:
            if elapsed - started > MOQ_EPOCH_MAX_WARMUP:
                return self.shared.decide_mode(MODE_LIVE_EDGE)
            return None
        own_first = self.shared.first_offset(self.kind)
        assert own_first is not None
        measured = MODE_ANCHOR if abs(own_first - other_first) <= AV_SKEW_MAX \
            else MODE_LIVE_EDGE
        return self.shared.decide_mode(measured)

    def _lock_and_flush(self, offset: float) -> List[AlignedChunk]:
        self.locked_offset = offset
        self.first_epoch = False
        out = [
            AlignedChunk(max(c.pts - offset, 0.0), c.keyframe, c.data)
            for c in self.held
        ]
        self.held.clear()
        return out

    def flush(self) -> List[AlignedChunk]:
        """Force-lock at the running max and drain (EOS during warmup)."""
        if self.max_offset is None:
            return []
        return self._lock_and_flush(self.max_offset)
