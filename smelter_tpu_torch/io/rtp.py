"""RTP input/output: packetization, jitter buffer, UDP/TCP transports.

The port's copy of the redesign of the reference RTP layer
(`smelter-core/src/rtp/`):

- `RtpPacket` — RFC 3550 header parse/build
- `JitterBuffer` — seq-ordered reorder window with rollover handling
  (reference `rtp_input/jitter_buffer.rs`, FixedWindow mode) and extended
  RTP-timestamp unrolling (reference `rollover_state.rs`)
- depayloaders: H264 (RFC 6184: single NAL / STAP-A / FU-A), VP8 (RFC 7741),
  Opus (RFC 7587) (reference `rtp_input/depayloader/`)
- payloaders: H264 FU-A/single-NAL with inline SPS/PPS, Opus
  (reference `rtp_output/payloader.rs`)
- `RtpInputSource` — binds a UDP socket or TCP server, spawns recv + decode
  threads feeding the queue (reference `rtp_input/{udp,tcp_server}.rs`)
- `RtpOutputSink` — encodes via the pipeline encoder threads, payloads and
  sends over UDP or to connected TCP clients (reference `rtp_output/`)

TCP framing uses the same 2-byte big-endian length prefix as the reference
(`rtp_output/tcp_server.rs`).
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


from smelter_tpu_torch.core.types import AudioSamples, Frame, PixelFormat, Resolution
from smelter_tpu_torch.pipeline.input import InputCtx, InputSource
from smelter_tpu_torch.pipeline.output import OutputSink
from smelter_tpu_torch.utils.channels import Channel, Closed

logger = logging.getLogger("smelter.rtp")

VIDEO_CLOCK = 90_000
OPUS_CLOCK = 48_000

# default payload types (match the reference's register defaults)
PT_H264 = 96
PT_VP8 = 97
PT_VP9 = 98
PT_AV1 = 99
PT_OPUS = 111


# ---------------------------------------------------------------------------
# RFC 3550 packet
# ---------------------------------------------------------------------------


@dataclass
class RtpPacket:
    payload_type: int
    sequence_number: int
    timestamp: int              # 32-bit RTP timestamp
    ssrc: int
    payload: bytes
    marker: bool = False

    def serialize(self) -> bytes:
        b0 = 0x80  # V=2, P=0, X=0, CC=0
        b1 = (0x80 if self.marker else 0) | (self.payload_type & 0x7F)
        return (
            struct.pack(
                "!BBHII",
                b0,
                b1,
                self.sequence_number & 0xFFFF,
                self.timestamp & 0xFFFFFFFF,
                self.ssrc & 0xFFFFFFFF,
            )
            + self.payload
        )

    @staticmethod
    def parse(data: bytes) -> Optional["RtpPacket"]:
        if len(data) < 12:
            return None
        b0, b1, seq, ts, ssrc = struct.unpack("!BBHII", data[:12])
        version = b0 >> 6
        if version != 2:
            return None
        cc = b0 & 0x0F
        has_ext = bool(b0 & 0x10)
        padding = bool(b0 & 0x20)
        offset = 12 + 4 * cc
        if has_ext:
            if len(data) < offset + 4:
                return None
            ext_len = struct.unpack("!H", data[offset + 2 : offset + 4])[0]
            offset += 4 + 4 * ext_len
        end = len(data)
        if padding and end > offset:
            pad = data[-1]
            end = max(offset, end - pad)
        return RtpPacket(
            payload_type=b1 & 0x7F,
            sequence_number=seq,
            timestamp=ts,
            ssrc=ssrc,
            payload=data[offset:end],
            marker=bool(b1 & 0x80),
        )


class TimestampUnroller:
    """32-bit RTP timestamp → monotonically increasing 64-bit
    (reference `rollover_state.rs`)."""

    def __init__(self) -> None:
        self._last: Optional[int] = None
        self._rollovers = 0

    def unroll(self, ts: int) -> int:
        if self._last is not None:
            diff = ts - self._last
            if diff < -(1 << 31):
                self._rollovers += 1
            elif diff > (1 << 31) and self._rollovers > 0:
                # late packet from before a rollover
                return ts + (self._rollovers - 1) * (1 << 32)
        self._last = ts
        return ts + self._rollovers * (1 << 32)


class JitterBuffer:
    """Sequence-number reordering window.

    Two modes like the reference (`jitter_buffer.rs:26-36`):
      - fixed window (default 50 ms): a gap is skipped once the oldest
        buffered packet outlives the window
      - adaptive: the window follows the RFC 3550 §6.4.1 interarrival jitter
        estimate (J += (|D| - J)/16), clamped to [min_window, max_window] —
        clean networks release almost immediately, jittery ones wait longer
    """

    def __init__(self, window_s: float = 0.050, clock=time.monotonic,
                 adaptive: bool = False, min_window_s: float = 0.005,
                 max_window_s: float = 0.500,
                 clock_rate: int = VIDEO_CLOCK,
                 stats=None) -> None:
        self.window = window_s
        self.clock = clock
        self.stats = stats  # optional pipeline.stats.RtpTrackStats
        self.adaptive = adaptive
        self.min_window = min_window_s
        self.max_window = max_window_s
        self.clock_rate = clock_rate
        self._jitter = 0.0            # RFC 3550 jitter, in seconds
        self._last_transit: Optional[float] = None
        # play-out anchor for effective-buffer stats (reference
        # jitter_buffer.rs reference_time/ntp_sync_point): first packet maps
        # its media timestamp to the wall clock
        self._anchor_wall: Optional[float] = None
        self._anchor_media: Optional[int] = None
        self._buffer: Dict[int, Tuple[float, RtpPacket]] = {}
        self._next_seq: Optional[int] = None
        self._max_ext_seq: Optional[int] = None
        self._seq_rollovers = 0
        self._late_streak = 0

    def _update_jitter(self, pkt: RtpPacket, now: float) -> None:
        transit = now - pkt.timestamp / self.clock_rate
        if self._last_transit is not None:
            d = abs(transit - self._last_transit)
            self._jitter += (d - self._jitter) / 16.0
            # 4x jitter is the usual de-jitter buffer sizing rule
            self.window = min(max(4.0 * self._jitter, self.min_window),
                              self.max_window)
        self._last_transit = transit

    def _extend_seq(self, seq: int) -> int:
        if self._max_ext_seq is not None:
            last16 = self._max_ext_seq & 0xFFFF
            diff = seq - last16
            if diff < -(1 << 15):
                self._seq_rollovers += 1
            elif diff > (1 << 15) and self._seq_rollovers > 0:
                return seq + (self._seq_rollovers - 1) * (1 << 16)
        ext = seq + self._seq_rollovers * (1 << 16)
        if self._max_ext_seq is None or ext > self._max_ext_seq:
            self._max_ext_seq = ext
        return ext

    def push(self, pkt: RtpPacket) -> List[RtpPacket]:
        """Insert a packet; returns packets ready for release in order."""
        now = self.clock()
        if self.adaptive:
            self._update_jitter(pkt, now)
        ext = self._extend_seq(pkt.sequence_number)
        if self._next_seq is None:
            self._next_seq = ext
        if ext < self._next_seq:
            # already skipped past: the gap was counted as lost when skip_to
            # advanced _next_seq — count the late arrival separately instead
            # of inflating the loss figure a second time
            self._late_streak += 1
            if self._late_streak >= 10:
                # every recent packet "too late": the sender restarted (or
                # hostile random-seq packets inflated the rollover state) —
                # resync like RFC 3550 source probation instead of locking
                # the stream out forever
                self._buffer.clear()
                self._next_seq = None
                self._max_ext_seq = None
                self._seq_rollovers = 0
                self._late_streak = 0
                return self.push(pkt)
            if self.stats is not None:
                self.stats.on_discarded(1)
            return []  # too late
        self._late_streak = 0
        self._buffer[ext] = (now, pkt)
        if self.stats is not None:
            # write-side effective buffer (jitter_buffer.rs:180-191): margin
            # between this packet's play-out deadline (pts + buffer window)
            # and the wall clock, at the moment it lands
            self.stats.on_packet(
                len(pkt.payload) + 12,
                max(0.0, self._playout_at(pkt, now) + self.window - now),
            )
        return self._release()

    def _playout_at(self, pkt: RtpPacket, now: float) -> float:
        """Wall-clock play-out time of a packet, from the first packet's
        media-timestamp anchor (stats only; queue offsets are applied
        downstream)."""
        if self._anchor_wall is None:
            self._anchor_wall = now
            self._anchor_media = pkt.timestamp
        rel = (pkt.timestamp - (self._anchor_media or 0)) & 0xFFFFFFFF
        if rel >= 1 << 31:  # media timestamp wrapped / reordered before anchor
            rel -= 1 << 32
        return self._anchor_wall + rel / self.clock_rate

    def _release(self) -> List[RtpPacket]:
        out: List[RtpPacket] = []
        now = self.clock()
        while self._buffer:
            assert self._next_seq is not None
            item = self._buffer.pop(self._next_seq, None)
            if item is not None:
                if self.stats is not None:
                    # pop-side margin + current buffer size
                    # (jitter_buffer.rs:244-252 EffectiveBufferOnPop +
                    # InputBufferSize)
                    self.stats.on_pop(
                        max(
                            0.0,
                            self._playout_at(item[1], now) + self.window - now,
                        ),
                        self.window,
                    )
                out.append(item[1])
                self._next_seq += 1
                continue
            # gap: skip only if the oldest buffered packet outlived the window
            oldest = min(t for t, _ in self._buffer.values())
            if now - oldest > self.window:
                skip_to = min(self._buffer.keys())
                if self.stats is not None:
                    self.stats.on_lost(skip_to - self._next_seq)
                self._next_seq = skip_to
                continue
            break
        return out

    def flush(self) -> List[RtpPacket]:
        out = [pkt for _, (_, pkt) in sorted(self._buffer.items())]
        self._buffer.clear()
        return out

    # NACK retry budget per missing seq (reference webrtc NACK behavior:
    # request a few times, then give up and let the window skip)
    MAX_NACK_RETRIES = 4

    def nack_candidates(self, limit: int = 16) -> List[int]:
        """Missing 16-bit seqs in the current reorder gap, for an RTCP
        Generic NACK. Each seq is reported at most MAX_NACK_RETRIES times
        across calls; call on every push and throttle at the transport."""
        if self._next_seq is None or not self._buffer:
            return []
        if not hasattr(self, "_nack_counts"):
            self._nack_counts: Dict[int, int] = {}
        top = max(self._buffer.keys())
        out: List[int] = []
        for ext in range(self._next_seq, top):
            if ext in self._buffer:
                continue
            n = self._nack_counts.get(ext, 0)
            if n >= self.MAX_NACK_RETRIES:
                continue
            self._nack_counts[ext] = n + 1
            out.append(ext & 0xFFFF)
            if len(out) >= limit:
                break
        # drop bookkeeping for seqs already released/skipped
        if len(self._nack_counts) > 1024:
            self._nack_counts = {
                k: v for k, v in self._nack_counts.items() if k >= self._next_seq
            }
        return out


# ---------------------------------------------------------------------------
# depayloaders (RTP payload → encoded access units)
# ---------------------------------------------------------------------------


@dataclass
class AccessUnit:
    data: bytes
    pts_s: float
    is_keyframe: bool = False


_ANNEXB = b"\x00\x00\x00\x01"


class H264Depayloader:
    """RFC 6184 → AnnexB access units. Handles single NAL, STAP-A (24),
    FU-A (28). An AU is emitted on the marker bit or timestamp change."""

    def __init__(self) -> None:
        self._nals: List[bytes] = []
        self._fu: Optional[bytearray] = None
        self._ts: Optional[int] = None
        self._unroller = TimestampUnroller()
        self._first_ts: Optional[int] = None

    def _ts_to_pts(self, ts: int) -> float:
        ext = self._unroller.unroll(ts)
        if self._first_ts is None:
            self._first_ts = ext
        return (ext - self._first_ts) / VIDEO_CLOCK

    def push(self, pkt: RtpPacket) -> List[AccessUnit]:
        out: List[AccessUnit] = []
        if self._ts is not None and pkt.timestamp != self._ts and self._nals:
            out.extend(self._emit(self._ts))
        self._ts = pkt.timestamp
        p = pkt.payload
        if not p:
            return out
        nal_type = p[0] & 0x1F
        if nal_type == 24:  # STAP-A
            i = 1
            while i + 2 <= len(p):
                size = struct.unpack("!H", p[i : i + 2])[0]
                i += 2
                self._nals.append(p[i : i + size])
                i += size
        elif nal_type == 28:  # FU-A
            if len(p) < 2:
                return out
            fu_header = p[1]
            start = bool(fu_header & 0x80)
            end = bool(fu_header & 0x40)
            orig_type = fu_header & 0x1F
            if start:
                indicator = (p[0] & 0xE0) | orig_type
                self._fu = bytearray([indicator])
            if self._fu is not None:
                self._fu.extend(p[2:])
                if end:
                    self._nals.append(bytes(self._fu))
                    self._fu = None
        elif 1 <= nal_type <= 23:
            self._nals.append(p)
        if pkt.marker and self._nals:
            out.extend(self._emit(pkt.timestamp))
        return out

    def _emit(self, ts: int) -> List[AccessUnit]:
        nals, self._nals = self._nals, []
        data = b"".join(_ANNEXB + n for n in nals)
        keyframe = any((n[0] & 0x1F) == 5 for n in nals if n)
        return [AccessUnit(data, self._ts_to_pts(ts), keyframe)]


class Vp8Depayloader:
    """RFC 7741: strips the VP8 payload descriptor, reassembles frames."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []
        self._unroller = TimestampUnroller()
        self._first_ts: Optional[int] = None

    def push(self, pkt: RtpPacket) -> List[AccessUnit]:
        p = pkt.payload
        if not p:
            return []
        i = 1
        x = p[0] & 0x80
        s = p[0] & 0x10
        if x:
            if i >= len(p):
                return []
            ext = p[i]
            i += 1
            if ext & 0x80:  # PictureID
                if i < len(p) and p[i] & 0x80:
                    i += 2
                else:
                    i += 1
            if ext & 0x40:  # TL0PICIDX
                i += 1
            if ext & 0x30:  # TID/KEYIDX
                i += 1
        if s and not self._parts:
            pass
        self._parts.append(p[i:])
        if pkt.marker:
            data = b"".join(self._parts)
            self._parts = []
            if not data:
                return []
            ext_ts = self._unroller.unroll(pkt.timestamp)
            if self._first_ts is None:
                self._first_ts = ext_ts
            keyframe = not (data[0] & 0x01)
            return [AccessUnit(data, (ext_ts - self._first_ts) / VIDEO_CLOCK, keyframe)]
        return []


class Vp9Depayloader:
    """draft-ietf-payload-vp9: strips the VP9 payload descriptor and
    reassembles frames (flexible + non-flexible modes, SS skipped)."""

    def __init__(self) -> None:
        self._parts: List[bytes] = []
        self._keyframe = False
        self._unroller = TimestampUnroller()
        self._first_ts: Optional[int] = None

    def push(self, pkt: RtpPacket) -> List[AccessUnit]:
        p = pkt.payload
        if not p:
            return []
        b0 = p[0]
        i_bit = b0 & 0x80
        p_bit = b0 & 0x40
        l_bit = b0 & 0x20
        f_bit = b0 & 0x10
        b_bit = b0 & 0x08
        v_bit = b0 & 0x02
        i = 1
        if i_bit:
            if i >= len(p):
                return []
            if p[i] & 0x80:
                i += 2
            else:
                i += 1
        if l_bit:
            i += 1
            if not f_bit:
                i += 1  # TL0PICIDX
        if v_bit and i < len(p):
            # scalability structure: N_S|Y|G
            ss = p[i]
            i += 1
            n_s = (ss >> 5) + 1
            if ss & 0x10:  # Y: width/height per layer
                i += 4 * n_s
            if ss & 0x08:  # G
                if i < len(p):
                    n_g = p[i]
                    i += 1
                    for _ in range(n_g):
                        if i >= len(p):
                            break
                        g = p[i]
                        i += 1
                        r = (g >> 2) & 0x03
                        i += r
        if b_bit and not self._parts:
            self._keyframe = not p_bit
        self._parts.append(p[i:])
        if pkt.marker:
            data = b"".join(self._parts)
            self._parts = []
            keyframe = self._keyframe
            self._keyframe = False
            if not data:
                return []
            ext = self._unroller.unroll(pkt.timestamp)
            if self._first_ts is None:
                self._first_ts = ext
            return [AccessUnit(data, (ext - self._first_ts) / VIDEO_CLOCK, keyframe)]
        return []


class Vp9Payloader:
    """Minimal VP9 payloader (flexible mode, no picture id / layers)."""

    def __init__(self, ssrc: int, payload_type: int = PT_VP9, mtu: int = 1200) -> None:
        self.ssrc = ssrc
        self.pt = payload_type
        self.mtu = mtu
        self.seq = 0

    def payload(self, frame: bytes, pts_s: float, keyframe: bool = False
                ) -> List[RtpPacket]:
        ts = int(round(pts_s * VIDEO_CLOCK)) & 0xFFFFFFFF
        out: List[RtpPacket] = []
        pos = 0
        first = True
        while pos < len(frame) or first:
            chunk = frame[pos : pos + self.mtu - 1]
            pos += len(chunk)
            last = pos >= len(frame)
            desc = (0x08 if first else 0x00) | (0x04 if last else 0x00)
            if not keyframe:
                desc |= 0x40  # P: inter-picture predicted
            out.append(RtpPacket(
                payload_type=self.pt, sequence_number=self.seq, timestamp=ts,
                ssrc=self.ssrc, payload=bytes([desc]) + chunk, marker=last,
            ))
            self.seq = (self.seq + 1) & 0xFFFF
            first = False
        return out


# -- AV1 RTP payload (aomediacodec av1-rtp-spec v1.0) -----------------------
#
# Beyond-reference: smelter's RTP stack stops at VP9 (rtp_input/depayloader/).
# This build already decodes/encodes AV1 (native FFmpeg service), so AV1 rides
# RTP/WebRTC too. Payload = 1-byte aggregation header (Z|Y|W|N) + OBU
# elements; we emit W=0 (every element LEB128-length-prefixed) and accept any
# W on receive. OBUs travel without obu_size fields (lengths come from the
# elements); the depayloader re-adds size fields so the output is a standard
# low-overhead bitstream for the decoder.


def _leb128_encode(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _leb128_read(data: bytes, pos: int) -> Tuple[int, int]:
    val = 0
    for i in range(8):
        if pos >= len(data):
            raise ValueError("truncated LEB128")
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return val, pos
    raise ValueError("LEB128 too long")


_OBU_TEMPORAL_DELIMITER = 2
_OBU_PADDING = 15


def split_obus(stream: bytes) -> List[bytes]:
    """Split a low-overhead AV1 bitstream (OBUs with obu_size fields, as
    FFmpeg emits) into individual OBUs (header + payload, size field kept).
    A final OBU without a size field consumes the rest."""
    obus: List[bytes] = []
    pos = 0
    n = len(stream)
    while pos < n:
        start = pos
        hdr = stream[pos]
        pos += 1
        if hdr & 0x04:  # extension flag
            pos += 1
        if hdr & 0x02:  # has_size
            size, pos = _leb128_read(stream, pos)
            pos += size
            obus.append(stream[start:pos])
        else:
            obus.append(stream[start:])
            break
    return obus


def _obu_strip_size(obu: bytes) -> bytes:
    """OBU with size field -> same OBU, has_size=0, length implicit."""
    hdr = obu[0]
    hlen = 2 if hdr & 0x04 else 1
    if not hdr & 0x02:
        return obu
    size, pos = _leb128_read(obu, hlen)
    return bytes([hdr & ~0x02]) + obu[1:hlen] + obu[pos : pos + size]


def _obu_add_size(obu: bytes) -> bytes:
    """OBU without size field -> has_size=1 + LEB128 payload length."""
    hdr = obu[0]
    hlen = 2 if hdr & 0x04 else 1
    if hdr & 0x02:
        return obu
    payload = obu[hlen:]
    return bytes([hdr | 0x02]) + obu[1:hlen] + _leb128_encode(len(payload)) + payload


def _obu_type(obu: bytes) -> int:
    return (obu[0] >> 3) & 0x0F


class Av1Payloader:
    """AV1 temporal unit -> RTP packets (W=0 mode, fragmentation via Z/Y)."""

    def __init__(self, ssrc: int, payload_type: int = PT_AV1, mtu: int = 1200) -> None:
        self.ssrc = ssrc
        self.pt = payload_type
        self.mtu = mtu
        self.seq = 0

    def payload(self, frame: bytes, pts_s: float, keyframe: bool = False
                ) -> List[RtpPacket]:
        ts = int(round(pts_s * VIDEO_CLOCK)) & 0xFFFFFFFF
        elements = [
            _obu_strip_size(o)
            for o in split_obus(frame)
            if _obu_type(o) not in (_OBU_TEMPORAL_DELIMITER, _OBU_PADDING)
        ]
        if not elements:
            return []
        out: List[RtpPacket] = []
        budget = self.mtu - 1  # after the aggregation header
        cur: List[bytes] = []  # length-prefixed element bytes
        cur_z = False          # first element continues a fragment
        first_packet = True

        def flush(y_bit: bool, marker: bool) -> None:
            nonlocal cur, cur_z, first_packet
            agg = (0x80 if cur_z else 0) | (0x40 if y_bit else 0)
            if first_packet and keyframe:
                agg |= 0x08  # N: new coded video sequence
            out.append(RtpPacket(
                payload_type=self.pt, sequence_number=self.seq, timestamp=ts,
                ssrc=self.ssrc, payload=bytes([agg]) + b"".join(cur),
                marker=marker,
            ))
            self.seq = (self.seq + 1) & 0xFFFF
            cur = []
            cur_z = False
            first_packet = False

        used = 0
        for ei, el in enumerate(elements):
            last_el = ei == len(elements) - 1
            pos = 0
            continuing = False
            while True:
                remaining = el[pos:]
                prefix_guess = len(_leb128_encode(len(remaining)))
                space = budget - used - prefix_guess
                if space <= 0:
                    flush(y_bit=False, marker=False)
                    used = 0
                    continue
                take = remaining[:space]
                pos += len(take)
                done = pos >= len(el)
                cur.append(_leb128_encode(len(take)) + take)
                if continuing:
                    cur_z = cur_z or len(cur) == 1
                used += len(cur[-1])
                if done:
                    break
                # element continues in the next packet
                flush(y_bit=True, marker=False)
                used = 0
                continuing = True
                cur_z = True
            if last_el:
                flush(y_bit=False, marker=True)
        return out


class Av1Depayloader:
    """RTP packets -> AV1 temporal units (low-overhead bitstream with size
    fields restored). Keyframes from the N bit."""

    def __init__(self) -> None:
        self._obus: List[bytes] = []
        self._partial: Optional[bytearray] = None
        self._keyframe = False
        self._unroller = TimestampUnroller()
        self._first_ts: Optional[int] = None

    def push(self, pkt: RtpPacket) -> List[AccessUnit]:
        p = pkt.payload
        if not p:
            return []
        agg = p[0]
        z, y = agg & 0x80, agg & 0x40
        w = (agg >> 4) & 0x03
        n_bit = agg & 0x08
        if n_bit and not self._obus and self._partial is None:
            self._keyframe = True
        # parse elements
        elements: List[bytes] = []
        pos = 1
        try:
            if w == 0:
                while pos < len(p):
                    ln, pos = _leb128_read(p, pos)
                    elements.append(p[pos : pos + ln])
                    pos += ln
            else:
                for i in range(w - 1):
                    ln, pos = _leb128_read(p, pos)
                    elements.append(p[pos : pos + ln])
                    pos += ln
                elements.append(p[pos:])
        except ValueError:
            elements = []
        if not elements:
            return []
        if z:
            if self._partial is None:
                # mid-fragment join: drop until a fresh element boundary
                elements = elements[1:]
            else:
                self._partial.extend(elements[0])
                elements = elements[1:]
                # the continued OBU ends here unless it was the only
                # element AND Y says it keeps going; close it BEFORE any
                # following elements so OBU order is preserved
                if elements or not y:
                    self._obus.append(bytes(self._partial))
                    self._partial = None
        elif self._partial is not None:
            # lost the tail of a fragmented OBU (seq gap): drop the partial
            self._partial = None
        if elements:
            if y:
                *complete, frag = elements
                self._obus.extend(complete)
                if self._partial is None:
                    self._partial = bytearray(frag)
                else:
                    self._partial.extend(frag)
            else:
                if self._partial is not None:
                    self._obus.append(bytes(self._partial))
                    self._partial = None
                self._obus.extend(elements)
        if not pkt.marker:
            return []
        if self._partial is not None and not y:
            self._obus.append(bytes(self._partial))
            self._partial = None
        obus = [o for o in self._obus if o]
        self._obus = []
        keyframe = self._keyframe
        self._keyframe = False
        if not obus:
            return []
        data = b"".join(_obu_add_size(o) for o in obus)
        ext = self._unroller.unroll(pkt.timestamp)
        if self._first_ts is None:
            self._first_ts = ext
        return [AccessUnit(data, (ext - self._first_ts) / VIDEO_CLOCK, keyframe)]


class AacDepayloader:
    """RFC 3640 mpeg4-generic (AAC-hbr): 13-bit AU sizes in AU headers."""

    def __init__(self, clock_rate: int = 48000) -> None:
        self.clock = clock_rate
        self._unroller = TimestampUnroller()
        self._first_ts: Optional[int] = None

    def push(self, pkt: RtpPacket) -> List[AccessUnit]:
        p = pkt.payload
        if len(p) < 2:
            return []
        hdr_bits = struct.unpack("!H", p[:2])[0]
        n_headers = hdr_bits // 16
        sizes = []
        pos = 2
        for _ in range(n_headers):
            if pos + 2 > len(p):
                return []
            au = struct.unpack("!H", p[pos : pos + 2])[0]
            sizes.append(au >> 3)
            pos += 2
        ext = self._unroller.unroll(pkt.timestamp)
        if self._first_ts is None:
            self._first_ts = ext
        base = (ext - self._first_ts) / self.clock
        out = []
        # 1024 samples per AAC frame
        for k, size in enumerate(sizes):
            au = p[pos : pos + size]
            pos += size
            out.append(AccessUnit(au, base + k * 1024.0 / self.clock, True))
        return out


class AacPayloader:
    """RFC 3640 AAC-hbr payloader (one AU per packet)."""

    def __init__(self, ssrc: int, payload_type: int, clock_rate: int = 48000) -> None:
        self.ssrc = ssrc
        self.pt = payload_type
        self.clock = clock_rate
        self.seq = 0

    def payload(self, au: bytes, pts_s: float) -> List[RtpPacket]:
        hdr = struct.pack("!HH", 16, (len(au) << 3))
        pkt = RtpPacket(
            payload_type=self.pt, sequence_number=self.seq,
            timestamp=int(round(pts_s * self.clock)) & 0xFFFFFFFF,
            ssrc=self.ssrc, payload=hdr + au, marker=True,
        )
        self.seq = (self.seq + 1) & 0xFFFF
        return [pkt]


class OpusDepayloader:
    """RFC 7587: each packet is one Opus frame."""

    def __init__(self) -> None:
        self._unroller = TimestampUnroller()
        self._first_ts: Optional[int] = None

    def push(self, pkt: RtpPacket) -> List[AccessUnit]:
        if not pkt.payload:
            return []
        ext = self._unroller.unroll(pkt.timestamp)
        if self._first_ts is None:
            self._first_ts = ext
        return [AccessUnit(pkt.payload, (ext - self._first_ts) / OPUS_CLOCK, True)]


# ---------------------------------------------------------------------------
# payloaders (encoded packets → RTP payloads)
# ---------------------------------------------------------------------------


def _split_annexb(data: bytes) -> List[bytes]:
    """AnnexB byte stream → NAL units (no start codes)."""
    nals = []
    i = 0
    n = len(data)
    start = -1
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and (
            data[i + 2] == 1 or (data[i + 2] == 0 and i + 3 < n and data[i + 3] == 1)
        ):
            code_len = 3 if data[i + 2] == 1 else 4
            if start >= 0:
                nals.append(data[start:i].rstrip(b"\x00") or data[start:i])
            start = i + code_len
            i += code_len
        else:
            i += 1
    if start >= 0:
        nals.append(data[start:])
    return [n_ for n_ in nals if n_]


class H264Payloader:
    """AnnexB AU → RTP packets, FU-A fragmentation (reference payloader)."""

    def __init__(self, ssrc: int, payload_type: int = PT_H264, mtu: int = 1200) -> None:
        self.ssrc = ssrc
        self.pt = payload_type
        self.mtu = mtu
        self.seq = 0

    def payload(self, au: bytes, pts_s: float) -> List[RtpPacket]:
        ts = int(round(pts_s * VIDEO_CLOCK)) & 0xFFFFFFFF
        nals = _split_annexb(au)
        out: List[RtpPacket] = []
        for idx, nal in enumerate(nals):
            last_nal = idx == len(nals) - 1
            if len(nal) <= self.mtu:
                out.append(self._pkt(nal, ts, marker=last_nal))
            else:
                indicator = (nal[0] & 0xE0) | 28
                nal_type = nal[0] & 0x1F
                body = nal[1:]
                pos = 0
                while pos < len(body):
                    chunk = body[pos : pos + self.mtu - 2]
                    start = pos == 0
                    pos += len(chunk)
                    end = pos >= len(body)
                    fu_header = (0x80 if start else 0) | (0x40 if end else 0) | nal_type
                    out.append(
                        self._pkt(
                            bytes([indicator, fu_header]) + chunk,
                            ts,
                            marker=last_nal and end,
                        )
                    )
        return out

    def _pkt(self, payload: bytes, ts: int, marker: bool) -> RtpPacket:
        pkt = RtpPacket(
            payload_type=self.pt,
            sequence_number=self.seq,
            timestamp=ts,
            ssrc=self.ssrc,
            payload=payload,
            marker=marker,
        )
        self.seq = (self.seq + 1) & 0xFFFF
        return pkt


class Vp8Payloader:
    """RFC 7741 payloader: 1-byte descriptor (S bit on first fragment)."""

    def __init__(self, ssrc: int, payload_type: int = PT_VP8, mtu: int = 1200) -> None:
        self.ssrc = ssrc
        self.pt = payload_type
        self.mtu = mtu
        self.seq = 0

    def payload(self, frame: bytes, pts_s: float) -> List[RtpPacket]:
        ts = int(round(pts_s * VIDEO_CLOCK)) & 0xFFFFFFFF
        out: List[RtpPacket] = []
        pos = 0
        first = True
        while pos < len(frame) or first:
            chunk = frame[pos : pos + self.mtu - 1]
            pos += len(chunk)
            desc = bytes([0x10 if first else 0x00])
            pkt = RtpPacket(
                payload_type=self.pt,
                sequence_number=self.seq,
                timestamp=ts,
                ssrc=self.ssrc,
                payload=desc + chunk,
                marker=pos >= len(frame),
            )
            self.seq = (self.seq + 1) & 0xFFFF
            out.append(pkt)
            first = False
        return out


class OpusPayloader:
    def __init__(self, ssrc: int, payload_type: int = PT_OPUS) -> None:
        self.ssrc = ssrc
        self.pt = payload_type
        self.seq = 0

    def payload(self, frame: bytes, pts_s: float) -> List[RtpPacket]:
        pkt = RtpPacket(
            payload_type=self.pt,
            sequence_number=self.seq,
            timestamp=int(round(pts_s * OPUS_CLOCK)) & 0xFFFFFFFF,
            ssrc=self.ssrc,
            payload=frame,
            marker=True,
        )
        self.seq = (self.seq + 1) & 0xFFFF
        return [pkt]


# ---------------------------------------------------------------------------
# RTP input source
# ---------------------------------------------------------------------------


@dataclass
class RtpInputOptions:
    port: int = 0                       # 0 = pick free port
    transport: str = "udp"              # udp | tcp_server
    video_codec: Optional[str] = None   # h264 | vp8 | vp9 | None
    audio_codec: Optional[str] = None   # opus | aac | None
    audio_extradata: bytes = b""        # AAC AudioSpecificConfig (RFC 3640)
    jitter_window_s: float = 0.050
    jitter_adaptive: bool = False       # RealTime adaptive mode


class RtpInputSource(InputSource):
    """RTP stream input. Binds the socket at construction so the bound port
    is known before `register_input` returns (reference returns the port in
    the register response)."""

    def __init__(self, options: RtpInputOptions) -> None:
        self.options = options
        self.has_video = options.video_codec is not None
        self.has_audio = options.audio_codec is not None
        if not self.has_video and not self.has_audio:
            raise ValueError("rtp input needs video and/or audio")
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        if options.transport == "udp":
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 * 1024 * 1024)
            self._sock.bind(("0.0.0.0", options.port))
            self.port = self._sock.getsockname()[1]
        elif options.transport == "tcp_server":
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind(("0.0.0.0", options.port))
            self._sock.listen(1)
            self.port = self._sock.getsockname()[1]
        else:
            raise ValueError(f"unknown transport {options.transport!r}")

    def start(self, ctx: InputCtx) -> None:
        video_au: Optional[Channel] = Channel(64) if self.has_video else None
        audio_au: Optional[Channel] = Channel(256) if self.has_audio else None
        self._video_meter = ctx.video_meter
        self._audio_meter = ctx.audio_meter

        def _guard(fn):
            def run(*args):
                try:
                    fn(*args)
                except Exception:
                    logger.exception("rtp %s thread crashed", fn.__name__)
            return run

        recv = threading.Thread(
            target=_guard(self._run_recv),
            args=(video_au, audio_au),
            name=f"rtp-recv:{ctx.input_id}",
            daemon=True,
        )
        recv.start()
        self._threads.append(recv)

        if video_au is not None and ctx.video_channel is not None:
            t = threading.Thread(
                target=_guard(self._run_video_decode),
                args=(video_au, ctx),
                name=f"rtp-vdec:{ctx.input_id}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        if audio_au is not None and ctx.audio_channel is not None:
            t = threading.Thread(
                target=_guard(self._run_audio_decode),
                args=(audio_au, ctx),
                name=f"rtp-adec:{ctx.input_id}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # -- receive thread -------------------------------------------------------

    def _make_depayloaders(self):
        vd = None
        if self.options.video_codec == "h264":
            vd = H264Depayloader()
        elif self.options.video_codec == "vp8":
            vd = Vp8Depayloader()
        elif self.options.video_codec == "vp9":
            vd = Vp9Depayloader()
        elif self.options.video_codec == "av1":
            vd = Av1Depayloader()
        ad = None
        if self.options.audio_codec == "opus":
            ad = OpusDepayloader()
        elif self.options.audio_codec == "aac":
            ad = AacDepayloader()
        return vd, ad

    def _run_recv(self, video_au: Optional[Channel], audio_au: Optional[Channel]) -> None:
        vd, ad = self._make_depayloaders()
        vjb = JitterBuffer(self.options.jitter_window_s,
                           adaptive=self.options.jitter_adaptive,
                           clock_rate=VIDEO_CLOCK,
                           stats=getattr(self, "_video_meter", None))
        ajb = JitterBuffer(self.options.jitter_window_s,
                           adaptive=self.options.jitter_adaptive,
                           clock_rate=OPUS_CLOCK,
                           stats=getattr(self, "_audio_meter", None))
        video_pts = {PT_H264, PT_VP8, PT_VP9, PT_AV1}

        from smelter_tpu_torch.io import rtcp as rtcp_mod

        sync = rtcp_mod.RtcpSyncState()
        vslew = rtcp_mod.TrackSyncSlew()
        aslew = rtcp_mod.TrackSyncSlew()
        bye = threading.Event()

        def on_datagram(data: bytes) -> None:
            try:
                _on_datagram(data)
            except Exception:
                # RTP rides plain UDP/TCP (no auth): one malformed packet
                # crashing a depayloader must not kill the input thread
                logger.exception("dropping RTP datagram that broke parsing")

        def _on_datagram(data: bytes) -> None:
            if rtcp_mod.is_rtcp(data):
                for item in rtcp_mod.parse_compound(data):
                    if isinstance(item, rtcp_mod.SenderReport):
                        sync.on_sender_report(item)
                    elif isinstance(item, rtcp_mod.Bye):
                        bye.set()
                return
            pkt = RtpPacket.parse(data)
            if pkt is None:
                return
            if vd is not None and pkt.payload_type in video_pts:
                for ordered in vjb.push(pkt):
                    for au in vd.push(ordered):
                        # cross-track A/V alignment from SRs (reference
                        # rtcp_sync.rs): slewed onto the shared NTP line
                        delta = sync.track_delta(
                            pkt.ssrc, vd._first_ts or 0, VIDEO_CLOCK
                        ) if vd._first_ts is not None else None
                        if delta is not None:
                            vslew.set_target(delta)
                        au = AccessUnit(au.data, vslew.apply(au.pts_s),
                                        au.is_keyframe)
                        if video_au is not None:
                            try:
                                video_au.send(au)
                            except Closed:
                                pass
            elif ad is not None:
                for ordered in ajb.push(pkt):
                    for au in ad.push(ordered):
                        aclock = getattr(ad, "clock", OPUS_CLOCK)
                        delta = sync.track_delta(
                            pkt.ssrc, ad._first_ts or 0, aclock
                        ) if ad._first_ts is not None else None
                        if delta is not None:
                            aslew.set_target(delta)
                        au = AccessUnit(au.data, aslew.apply(au.pts_s),
                                        au.is_keyframe)
                        if audio_au is not None:
                            try:
                                audio_au.send(au)
                            except Closed:
                                pass

        try:
            if self.options.transport == "udp":
                try:
                    self._sock.settimeout(0.25)
                except OSError:
                    return  # stop() closed the socket before the loop started
                while not self._stop.is_set() and not bye.is_set():
                    try:
                        data, _addr = self._sock.recvfrom(65536)
                    except socket.timeout:
                        continue
                    except OSError:
                        break
                    if not data:
                        continue
                    on_datagram(data)
            else:
                try:
                    self._sock.settimeout(0.25)
                except OSError:
                    return  # stop() closed the socket before the loop started
                conn = None
                while not self._stop.is_set() and conn is None:
                    try:
                        conn, _ = self._sock.accept()
                    except socket.timeout:
                        continue
                    except OSError:
                        return
                if conn is None:
                    return
                conn.settimeout(0.25)
                buf = b""
                while not self._stop.is_set():
                    try:
                        chunk = conn.recv(65536)
                    except socket.timeout:
                        continue
                    except OSError:
                        break
                    if not chunk:
                        break  # peer closed → EOS
                    buf += chunk
                    while len(buf) >= 2:
                        size = struct.unpack("!H", buf[:2])[0]
                        if len(buf) < 2 + size:
                            break
                        on_datagram(buf[2 : 2 + size])
                        buf = buf[2 + size :]
        finally:
            # flush jitter buffers, then signal AU EOS
            if vd is not None and video_au is not None:
                for ordered in vjb.flush():
                    for au in vd.push(ordered):
                        try:
                            video_au.send(au)
                        except Closed:
                            pass
                video_au.close()
            if ad is not None and audio_au is not None:
                for ordered in ajb.flush():
                    for au in ad.push(ordered):
                        try:
                            audio_au.send(au)
                        except Closed:
                            pass
                audio_au.close()

    # -- decode threads ---------------------------------------------------------

    def _run_video_decode(self, aus: Channel, ctx: InputCtx) -> None:
        run_video_decode(aus, ctx, self.options.video_codec or "h264")

    def _run_audio_decode(self, aus: Channel, ctx: InputCtx) -> None:
        run_audio_decode(
            aus, ctx,
            codec_name=self.options.audio_codec or "opus",
            extradata=self.options.audio_extradata,
        )


def run_video_decode(aus: Channel, ctx: InputCtx, codec_name: str = "h264") -> None:
    from smelter_tpu_torch.io.codec import Codec, VideoDecoder

    codec = Codec.from_name(codec_name)
    dec = VideoDecoder(codec)
    out = ctx.video_channel
    assert out is not None
    try:
        while True:
            try:
                au: AccessUnit = aus.recv()
            except Closed:
                break
            try:
                dec.send(au.data, au.pts_s)
            except Exception:
                # corrupt access unit off the wire (unauthenticated RTP):
                # drop it and keep decoding — FFmpeg recovers at the next
                # keyframe (reference decoder threads log-and-continue too)
                logger.warning("dropping undecodable %s access unit "
                               "(%d bytes)", codec_name, len(au.data))
                continue
            while True:
                f = dec.receive()
                if f is None or f == "eof":
                    break
                y, u, v, pts, _ = f
                h, w = y.shape
                try:
                    out.send(
                        Frame(
                            data=(y, u, v),
                            format=PixelFormat.PLANAR_YUV420,
                            resolution=Resolution(w, h),
                            pts=pts or 0.0,
                        )
                    )
                except Closed:
                    return
        dec.send_eof()
        while True:
            f = dec.receive()
            if f is None or f == "eof":
                break
            y, u, v, pts, _ = f
            h, w = y.shape
            try:
                out.send(
                    Frame(
                        data=(y, u, v),
                        format=PixelFormat.PLANAR_YUV420,
                        resolution=Resolution(w, h),
                        pts=pts or 0.0,
                    )
                )
            except Closed:
                return
    finally:
        dec.close()
        out.close()



def run_audio_decode(aus: Channel, ctx: InputCtx, codec_name: str = "opus",
                     extradata: bytes = b"") -> None:
    from smelter_tpu_torch.io.codec import AudioDecoder, Codec

    if codec_name == "aac":
        dec = AudioDecoder(
            Codec.AAC, ctx.mixing_sample_rate, 2, extradata=extradata
        )
    else:
        dec = AudioDecoder(
            Codec.OPUS, ctx.mixing_sample_rate, 2,
            in_sample_rate=OPUS_CLOCK, in_channels=2,
        )
    out = ctx.audio_channel
    assert out is not None
    try:
        while True:
            try:
                au: AccessUnit = aus.recv()
            except Closed:
                break
            try:
                dec.send(au.data, au.pts_s)
            except Exception:
                logger.warning("dropping undecodable %s access unit "
                               "(%d bytes)", codec_name, len(au.data))
                continue
            while True:
                s = dec.receive()
                if s is None or s == "eof":
                    break
                samples, pts = s
                try:
                    out.send(AudioSamples(samples=samples, start_pts=pts or 0.0))
                except Closed:
                    return
    finally:
        dec.close()
        out.close()


# ---------------------------------------------------------------------------
# RTP output sink
# ---------------------------------------------------------------------------


@dataclass
class RtpOutputOptions:
    ip: str = "127.0.0.1"
    port: int = 0
    transport: str = "udp"          # udp | tcp_server
    video_codec: str = "h264"       # h264 | vp8 | vp9 | av1
    video_payload_type: Optional[int] = None  # default: codec convention
    audio_payload_type: int = PT_OPUS
    mtu: int = 1200


class RtpOutputSink(OutputSink):
    """Sends encoded packets as RTP over UDP, or to TCP clients with 2-byte
    length framing. Use with the pipeline's encoder threads (codec h264 video,
    opus audio, with global_header=0 so parameter sets stay inline).

    RTCP: periodic Sender Reports ride the same socket (rtcp-mux); inbound
    PLI feedback triggers `on_keyframe_request` (set by the pipeline when
    registering the output, reference handle_keyframe_requests.rs)."""

    def __init__(self, options: RtpOutputOptions) -> None:
        self.options = options
        self._lock = threading.Lock()
        payloader_cls = {
            "vp8": Vp8Payloader,
            "vp9": Vp9Payloader,
            "av1": Av1Payloader,
        }.get(options.video_codec, H264Payloader)
        default_pt = {"vp8": PT_VP8, "vp9": PT_VP9, "av1": PT_AV1}.get(
            options.video_codec, PT_H264
        )
        self._vp = payloader_cls(
            ssrc=0x53544956,
            payload_type=(options.video_payload_type
                          if options.video_payload_type is not None
                          else default_pt),
            mtu=options.mtu,
        )
        self._ap = OpusPayloader(ssrc=0x53544941, payload_type=options.audio_payload_type)
        from smelter_tpu_torch.io.rtcp import RtcpSenderState

        self._v_rtcp = RtcpSenderState(self._vp.ssrc, VIDEO_CLOCK)
        self._a_rtcp = RtcpSenderState(self._ap.ssrc, OPUS_CLOCK)
        self.on_keyframe_request = None  # set by the pipeline
        self._video_extradata = b""
        self._stop = threading.Event()
        self._clients: List[socket.socket] = []
        if options.transport == "udp":
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._dest = (options.ip, options.port)
            self.port = options.port
            self._fb_thread = threading.Thread(
                target=self._feedback_loop, name="rtp-out-fb", daemon=True
            )
            self._fb_thread.start()
        elif options.transport == "tcp_server":
            self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._sock.bind(("0.0.0.0", options.port))
            self._sock.listen(8)
            self.port = self._sock.getsockname()[1]
            self._accept_thread = threading.Thread(
                target=self._accept_loop, name="rtp-out-accept", daemon=True
            )
            self._accept_thread.start()
        else:
            raise ValueError(f"unknown transport {options.transport!r}")

    def _feedback_loop(self) -> None:
        try:
            self._sock.settimeout(0.25)
        except OSError:
            return  # closed before the loop started
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                return
            self.handle_inbound(data)

    def _accept_loop(self) -> None:
        try:
            self._sock.settimeout(0.25)
        except OSError:
            return  # closed before the loop started
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with self._lock:
                self._clients.append(conn)

    def _send_raw(self, data: bytes) -> None:
        if self.options.transport == "udp":
            try:
                self._sock.sendto(data, self._dest)
            except OSError:
                pass
        else:
            framed = struct.pack("!H", len(data)) + data
            with self._lock:
                dead = []
                for c in self._clients:
                    try:
                        c.sendall(framed)
                    except OSError:
                        dead.append(c)
                for c in dead:
                    self._clients.remove(c)
                    try:
                        c.close()
                    except OSError:
                        pass

    def _send_pkt(self, pkt: RtpPacket) -> None:
        data = pkt.serialize()
        if self.options.transport == "udp":
            try:
                self._sock.sendto(data, self._dest)
            except OSError:
                pass
        else:
            framed = struct.pack("!H", len(data)) + data
            with self._lock:
                dead = []
                for c in self._clients:
                    try:
                        c.sendall(framed)
                    except OSError:
                        dead.append(c)
                for c in dead:
                    self._clients.remove(c)
                    try:
                        c.close()
                    except OSError:
                        pass

    # -- OutputSink interface ----------------------------------------------------

    def setup_video(self, opts, extradata, fps_num, fps_den) -> None:
        self._video_extradata = extradata

    def setup_audio(self, opts, extradata) -> None:
        pass

    def write_video_packet(self, pkt) -> None:
        data = pkt.data
        # inline parameter sets before keyframes if the encoder used
        # global headers (AnnexB extradata; h264 only)
        if (self.options.video_codec == "h264" and pkt.is_keyframe
                and self._video_extradata and not _has_sps(data)):
            data = self._video_extradata + data
        if isinstance(self._vp, (Vp9Payloader, Av1Payloader)):
            rtp_pkts = self._vp.payload(data, pkt.pts_s or 0.0,
                                        keyframe=pkt.is_keyframe)
        else:
            rtp_pkts = self._vp.payload(data, pkt.pts_s or 0.0)
        for rtp_pkt in rtp_pkts:
            self._send_pkt(rtp_pkt)
            self._v_rtcp.on_packet(len(rtp_pkt.payload))
        sr = self._v_rtcp.maybe_build_sr(pkt.pts_s or 0.0)
        if sr:
            self._send_raw(sr)

    def write_audio_packet(self, pkt) -> None:
        for rtp_pkt in self._ap.payload(pkt.data, pkt.pts_s or 0.0):
            self._send_pkt(rtp_pkt)
            self._a_rtcp.on_packet(len(rtp_pkt.payload))
        sr = self._a_rtcp.maybe_build_sr(pkt.pts_s or 0.0)
        if sr:
            self._send_raw(sr)

    def handle_inbound(self, data: bytes) -> None:
        """Inbound datagrams on the output socket: RTCP feedback (PLI)."""
        from smelter_tpu_torch.io import rtcp as rtcp_mod

        if not rtcp_mod.is_rtcp(data):
            return
        for item in rtcp_mod.parse_compound(data):
            if isinstance(item, rtcp_mod.Pli) and self.on_keyframe_request:
                self.on_keyframe_request()

    def on_done(self) -> None:
        self._stop.set()
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()
        try:
            self._sock.close()
        except OSError:
            pass


def _has_sps(annexb: bytes) -> bool:
    return any((n[0] & 0x1F) == 7 for n in _split_annexb(annexb) if n)


# ---------------------------------------------------------------------------
# server integration
# ---------------------------------------------------------------------------


# wire decoder names (reference RtpVideoDecoderOptions) → internal codec names
_DECODER_NAME_MAP = {
    "ffmpeg_h264": "h264",
    "vulkan_h264": "h264",
    "ffmpeg_vp8": "vp8",
    "ffmpeg_vp9": "vp9",
    # beyond-reference: AV1 over RTP (aomediacodec av1-rtp-spec)
    "ffmpeg_av1": "av1",
    "h264": "h264",
    "vp8": "vp8",
    "vp9": "vp9",
    "av1": "av1",
}


def register_rtp_input(pipeline, input_id: str, spec) -> int:
    """Wire-API glue: api.RtpInput → RtpInputSource. Returns the bound port."""
    from smelter_tpu_torch.pipeline.instance import RegisterInputOptions

    port = spec.port if isinstance(spec.port, int) else 0
    video_codec = None
    if spec.video is not None:
        wire_name = spec.video.decoder or "ffmpeg_h264"
        video_codec = _DECODER_NAME_MAP.get(wire_name)
        if video_codec is None:
            raise ValueError(f"unknown video decoder {wire_name!r}")
    audio_codec = None
    audio_extradata = b""
    if spec.audio is not None:
        name = (spec.audio.decoder or "opus").lower()
        audio_codec = {"opus": "opus", "aac": "aac", "fdk_aac": "aac"}.get(name)
        if audio_codec is None:
            raise ValueError(f"unknown audio decoder {name!r}")
        if audio_codec == "aac":
            asc = getattr(spec.audio, "audio_specific_config", None)
            if not asc:
                raise ValueError(
                    "aac rtp input requires audio_specific_config (hex)"
                )
            audio_extradata = bytes.fromhex(asc)
    jb = spec.jitter_buffer or {}
    mode = str(jb.get("mode", "fixed_window"))
    # window: richer jitter_buffer extension wins; else the reference's
    # buffer_size_ms (rtp.rs:32) sets the minimum depth
    window_ms = jb.get("window_ms")
    if window_ms is None and getattr(spec, "buffer_size_ms", None) is not None:
        window_ms = spec.buffer_size_ms
    source = RtpInputSource(
        RtpInputOptions(
            port=port,
            transport=spec.transport_protocol or "udp",
            video_codec=video_codec,
            audio_codec=audio_codec,
            audio_extradata=audio_extradata,
            jitter_window_s=(float(window_ms) / 1000.0) if window_ms else 0.050,
            jitter_adaptive=(mode == "real_time"),
        )
    )
    sc = getattr(spec, "side_channel", None) or {}
    pipeline.register_input(
        input_id,
        source,
        RegisterInputOptions(
            required=bool(spec.required),
            offset=(spec.offset_ms / 1000.0) if spec.offset_ms is not None else None,
            side_channel_video=bool(sc.get("video")),
            side_channel_audio=bool(sc.get("audio")),
            side_channel_delay=float(sc.get("delay_ms") or 0.0) / 1000.0,
        ),
    )
    return source.port


def register_rtp_output(pipeline, output_id: str, spec) -> None:
    """Wire-API glue: api.RtpOutput → RtpOutputSink + encoder options."""
    from smelter_tpu_torch.api import convert

    video = convert.output_video_options(spec.video, "rtp") if spec.video else None
    audio = convert.output_audio_options(spec.audio) if spec.audio else None
    if video is not None:
        # inline SPS/PPS for live streams
        extra = video.encoder.ffmpeg_options
        import dataclasses

        video.encoder = dataclasses.replace(
            video.encoder,
            ffmpeg_options=(extra + "," if extra else "") + "global_header=0",
        )
    if audio is not None and audio.encoder.codec != "opus":
        from smelter_tpu_torch.pipeline.output import AudioEncoderOptions

        audio.encoder = AudioEncoderOptions(
            codec="opus", sample_rate=48000, channels=audio.encoder.channels
        )
    sink = RtpOutputSink(
        RtpOutputOptions(
            ip=spec.ip or "127.0.0.1",
            port=int(spec.port),
            transport=spec.transport_protocol or "udp",
            video_codec=(video.encoder.codec if video else "h264"),
        )
    )
    pipeline.register_output(output_id, sink, video, audio)
