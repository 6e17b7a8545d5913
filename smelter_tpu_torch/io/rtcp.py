"""RTCP packets (RFC 3550) + NTP-based A/V sync state.

Covers the reference's RTCP handling (`smelter-core/src/rtp/rtp_input/
rtcp_sync.rs`, `webrtc/handle_keyframe_requests.rs`):
  - Sender Reports out (NTP↔RTP timestamp mapping for receiver-side sync)
  - Sender Report parsing in + `RtcpSyncState` aligning multiple streams'
    PTS timelines through their NTP clocks
  - PLI (Picture Loss Indication) build/parse → keyframe requests
  - BYE build/parse → EOS for connectionless transports
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

PT_SR = 200
PT_RR = 201
PT_SDES = 202
PT_BYE = 203
PT_APP = 204
PT_RTPFB = 205
PT_PSFB = 206

NTP_EPOCH_OFFSET = 2208988800  # 1900 → 1970


def ntp_now() -> Tuple[int, int]:
    t = time.time() + NTP_EPOCH_OFFSET
    sec = int(t)
    frac = int((t - sec) * (1 << 32))
    return sec, frac


def ntp_to_unix(sec: int, frac: int) -> float:
    return sec - NTP_EPOCH_OFFSET + frac / (1 << 32)


@dataclass
class SenderReport:
    ssrc: int
    ntp_sec: int
    ntp_frac: int
    rtp_timestamp: int
    packet_count: int
    octet_count: int

    @property
    def ntp_unix(self) -> float:
        return ntp_to_unix(self.ntp_sec, self.ntp_frac)


@dataclass
class ReportBlock:
    """RFC 3550 §6.4.1 reception report block."""

    ssrc: int
    fraction_lost: int      # 0..255 (fixed point /256)
    cumulative_lost: int
    highest_seq: int        # extended highest sequence number received
    jitter: int             # interarrival jitter, timestamp units
    lsr: int                # middle 32 bits of the last SR's NTP timestamp
    dlsr: int               # delay since last SR, 1/65536 s units


@dataclass
class ReceiverReport:
    """RFC 3550 §6.4.2 RR — reception quality feedback from a receiver."""

    ssrc: int
    reports: List[ReportBlock]


@dataclass
class Pli:
    sender_ssrc: int
    media_ssrc: int


@dataclass
class Bye:
    ssrcs: List[int]


@dataclass
class Nack:
    """RTCP Generic NACK (RFC 4585 §6.2.1, RTPFB FMT=1) — the WebRTC
    retransmission-request feedback (reference `webrtc/` NACK handling)."""

    sender_ssrc: int
    media_ssrc: int
    lost_seqs: List[int]  # 16-bit sequence numbers


def build_sender_report(sr: SenderReport) -> bytes:
    return struct.pack(
        "!BBHIIIIII",
        0x80, PT_SR, 6,
        sr.ssrc, sr.ntp_sec, sr.ntp_frac, sr.rtp_timestamp,
        sr.packet_count, sr.octet_count,
    )


def build_receiver_report(rr: ReceiverReport) -> bytes:
    n = len(rr.reports)
    out = struct.pack("!BBHI", 0x80 | n, PT_RR, 1 + 6 * n, rr.ssrc)
    for block in rr.reports:
        lost24 = block.cumulative_lost & 0xFFFFFF
        out += struct.pack(
            "!IIIIII",
            block.ssrc,
            ((block.fraction_lost & 0xFF) << 24) | lost24,
            block.highest_seq & 0xFFFFFFFF,
            block.jitter & 0xFFFFFFFF,
            block.lsr & 0xFFFFFFFF,
            block.dlsr & 0xFFFFFFFF,
        )
    return out


def build_pli(sender_ssrc: int, media_ssrc: int) -> bytes:
    # PSFB, FMT=1 (PLI)
    return struct.pack("!BBHII", 0x81, PT_PSFB, 2, sender_ssrc, media_ssrc)


def build_nack(sender_ssrc: int, media_ssrc: int, lost_seqs: List[int]) -> bytes:
    """Pack lost 16-bit seqs into (PID, BLP) FCI pairs."""
    fci = []
    seqs = sorted(set(s & 0xFFFF for s in lost_seqs))
    i = 0
    while i < len(seqs):
        pid = seqs[i]
        blp = 0
        j = i + 1
        while j < len(seqs) and 0 < ((seqs[j] - pid) & 0xFFFF) <= 16:
            blp |= 1 << (((seqs[j] - pid) & 0xFFFF) - 1)
            j += 1
        fci.append((pid, blp))
        i = j
    length = 2 + len(fci)
    out = struct.pack("!BBHII", 0x81, PT_RTPFB, length, sender_ssrc, media_ssrc)
    for pid, blp in fci:
        out += struct.pack("!HH", pid, blp)
    return out


def build_bye(ssrcs: List[int]) -> bytes:
    n = len(ssrcs)
    return struct.pack(f"!BBH{n}I", 0x80 | n, PT_BYE, n, *ssrcs)


def is_rtcp(data: bytes) -> bool:
    return len(data) >= 4 and PT_SR <= data[1] <= PT_PSFB


def parse_compound(data: bytes) -> List[object]:
    """Parses a compound RTCP packet into SenderReport/Pli/Bye items."""
    out: List[object] = []
    pos = 0
    while pos + 4 <= len(data):
        b0, pt, length = struct.unpack("!BBH", data[pos : pos + 4])
        if (b0 >> 6) != 2:
            break
        size = (length + 1) * 4
        body = data[pos : pos + size]
        if pt == PT_SR and len(body) >= 28:
            vals = struct.unpack("!IIIIII", body[4:28])
            out.append(SenderReport(*vals))
        elif pt == PT_RR and len(body) >= 8:
            ssrc = struct.unpack("!I", body[4:8])[0]
            blocks: List[ReportBlock] = []
            count = b0 & 0x1F
            for i in range(count):
                off = 8 + 24 * i
                if off + 24 > len(body):
                    break
                (bssrc, lost_word, highest, jitter, lsr, dlsr) = struct.unpack(
                    "!IIIIII", body[off : off + 24]
                )
                blocks.append(ReportBlock(
                    ssrc=bssrc,
                    fraction_lost=lost_word >> 24,
                    cumulative_lost=lost_word & 0xFFFFFF,
                    highest_seq=highest,
                    jitter=jitter,
                    lsr=lsr,
                    dlsr=dlsr,
                ))
            out.append(ReceiverReport(ssrc, blocks))
        elif pt == PT_PSFB and (b0 & 0x1F) == 1 and len(body) >= 12:
            sender, media = struct.unpack("!II", body[4:12])
            out.append(Pli(sender, media))
        elif pt == PT_RTPFB and (b0 & 0x1F) == 1 and len(body) >= 12:
            sender, media = struct.unpack("!II", body[4:12])
            lost: List[int] = []
            for off in range(12, len(body) - 3, 4):
                pid, blp = struct.unpack("!HH", body[off : off + 4])
                lost.append(pid)
                for bit in range(16):
                    if blp & (1 << bit):
                        lost.append((pid + bit + 1) & 0xFFFF)
            out.append(Nack(sender, media, lost))
        elif pt == PT_BYE:
            n = b0 & 0x1F
            ssrcs = list(struct.unpack(f"!{n}I", body[4 : 4 + 4 * n])) if n else []
            out.append(Bye(ssrcs))
        pos += size
    return out


class RtcpSyncState:
    """Aligns multiple RTP streams onto one PTS timeline via SR NTP anchors
    (reference `rtcp_sync.rs`).

    Each stream registers with its clock rate; `pts_for` converts an
    extended RTP timestamp into a shared NTP-derived timeline once an SR for
    that SSRC arrived, else falls back to the first-packet-rebased timeline
    the depayloaders use.
    """

    def __init__(self) -> None:
        self._anchors: Dict[int, Tuple[float, int]] = {}  # ssrc -> (ntp_unix, rtp_ts)
        self._clock: Dict[int, int] = {}
        self._base_ntp: Optional[float] = None

    def register_stream(self, ssrc: int, clock_rate: int) -> None:
        self._clock[ssrc] = clock_rate

    def on_sender_report(self, sr: SenderReport) -> None:
        self._anchors[sr.ssrc] = (sr.ntp_unix, sr.rtp_timestamp)
        if self._base_ntp is None:
            self._base_ntp = sr.ntp_unix

    def has_anchor(self, ssrc: int) -> bool:
        return ssrc in self._anchors

    def track_delta(self, ssrc: int, first_ext_ts: int,
                    clock_rate: int) -> Optional[float]:
        """Offset that maps a track's first-packet-rebased timeline onto
        the shared NTP timeline: corrected_pts = local_pts + delta. The
        delta is constant per track (pts_for(ts) - local(ts) cancels ts),
        so depayloaded AU pts can be corrected without re-unrolling."""
        anchor = self._anchors.get(ssrc)
        if anchor is None or self._base_ntp is None or not clock_rate:
            return None
        ntp, anchor_ts = anchor
        diff = (first_ext_ts & 0xFFFFFFFF) - anchor_ts
        if diff < -(1 << 31):
            diff += 1 << 32
        elif diff > (1 << 31):
            diff -= 1 << 32
        return (ntp - self._base_ntp) + diff / clock_rate

    def pts_for(self, ssrc: int, rtp_ts_ext: int) -> Optional[float]:
        """NTP-aligned PTS (seconds since the first SR's NTP time), or None
        if no anchor for this SSRC yet."""
        anchor = self._anchors.get(ssrc)
        clock = self._clock.get(ssrc)
        if anchor is None or not clock or self._base_ntp is None:
            return None
        ntp, anchor_ts = anchor
        # wrapped distance between this timestamp and the SR's anchor
        diff = (rtp_ts_ext & 0xFFFFFFFF) - anchor_ts
        if diff < -(1 << 31):
            diff += 1 << 32
        elif diff > (1 << 31):
            diff -= 1 << 32
        return (ntp - self._base_ntp) + diff / clock


class RtcpSenderState:
    """Per-SSRC send stats + periodic SR emission for an output stream."""

    def __init__(self, ssrc: int, clock_rate: int, interval_s: float = 1.0) -> None:
        self.ssrc = ssrc
        self.clock_rate = clock_rate
        self.interval = interval_s
        self.packet_count = 0
        self.octet_count = 0
        self._last_sr = 0.0

    def on_packet(self, payload_len: int) -> None:
        self.packet_count += 1
        self.octet_count += payload_len

    def maybe_build_sr(self, media_pts_s: float, now: Optional[float] = None
                       ) -> Optional[bytes]:
        now = now if now is not None else time.monotonic()
        if now - self._last_sr < self.interval:
            return None
        self._last_sr = now
        sec, frac = ntp_now()
        return build_sender_report(
            SenderReport(
                ssrc=self.ssrc,
                ntp_sec=sec,
                ntp_frac=frac,
                rtp_timestamp=int(round(media_pts_s * self.clock_rate)) & 0xFFFFFFFF,
                packet_count=self.packet_count,
                octet_count=self.octet_count,
            )
        )


class TrackSyncSlew:
    """Applies the SR-derived cross-track offset to depayloaded AU pts.

    Mirrors rtcp_sync.rs convergence semantics: the offset slews toward
    the target by CONVERGENCE_RATIO of the media-time progress per AU
    (bitrate-independent), and SNAPs when the target is further than
    SNAP_THRESHOLD (SFU rewrote RTP but not RTCP, resume after pause)."""

    CONVERGENCE_RATIO = 0.01      # rtcp_sync.rs:18
    SNAP_THRESHOLD = 0.300        # rtcp_sync.rs:25 (seconds)

    def __init__(self) -> None:
        self._current = 0.0
        self._target: Optional[float] = None
        self._last_pts: Optional[float] = None

    def set_target(self, delta: float) -> None:
        self._target = delta

    def apply(self, pts: float) -> float:
        if self._target is not None:
            diff = self._target - self._current
            if self._last_pts is None or abs(diff) > self.SNAP_THRESHOLD:
                self._current = self._target
            else:
                step = max(pts - self._last_pts, 0.0) * self.CONVERGENCE_RATIO
                self._current += max(-step, min(step, diff))
        self._last_pts = pts
        return pts + self._current


class ReceptionTracker:
    """Per-SSRC reception statistics feeding RTCP Receiver Reports
    (RFC 3550 §6.4.1 + appendix A.8 — the receiver-side feedback the
    reference gets from webrtc-rs: fraction lost, cumulative lost, extended
    highest seq, interarrival jitter, LSR/DLSR for sender RTT)."""

    def __init__(self, ssrc: int, clock_rate: int) -> None:
        self.ssrc = ssrc
        self.clock_rate = clock_rate
        self._base_seq: Optional[int] = None
        self._max_seq: Optional[int] = None
        self._cycles = 0
        self.received = 0
        self._expected_prior = 0
        self._received_prior = 0
        self.jitter = 0.0  # timestamp units
        self._last_transit: Optional[float] = None
        self._lsr = 0
        self._lsr_arrival: Optional[float] = None

    def on_packet(self, seq: int, rtp_ts: int,
                  now: Optional[float] = None) -> None:
        now = time.time() if now is None else now
        if self._max_seq is None:
            self._base_seq = seq
            self._max_seq = seq
        else:
            max16 = self._max_seq & 0xFFFF
            if seq < max16 and max16 - seq > 0x8000:
                # wrapped forward into the next cycle
                self._cycles += 1 << 16
                ext = self._cycles + seq
            elif seq > max16 and seq - max16 > 0x8000 and self._cycles > 0:
                # reordered pre-wrap straggler (e.g. seq 65530 arriving just
                # after max wrapped to a small value): it belongs to the
                # PREVIOUS cycle — without this, ext would jump max_seq a
                # whole cycle forward and inflate expected/cumulative_lost by
                # ~65536 in the next Receiver Report (RFC 3550 A.1).
                ext = self._cycles - (1 << 16) + seq
            else:
                ext = self._cycles + seq
            if ext > self._max_seq:
                self._max_seq = ext
        self.received += 1
        # interarrival jitter (RFC 3550 §6.4.1 / A.8)
        transit = now * self.clock_rate - rtp_ts
        if self._last_transit is not None:
            d = abs(transit - self._last_transit)
            self.jitter += (d - self.jitter) / 16.0
        self._last_transit = transit

    def on_sender_report(self, sr: SenderReport,
                         now: Optional[float] = None) -> None:
        self._lsr = ((sr.ntp_sec & 0xFFFF) << 16) | (sr.ntp_frac >> 16)
        self._lsr_arrival = time.time() if now is None else now

    def report_block(self, now: Optional[float] = None) -> ReportBlock:
        now = time.time() if now is None else now
        base = self._base_seq or 0
        max_seq = self._max_seq if self._max_seq is not None else base
        expected = max_seq - base + 1
        lost = max(0, expected - self.received)
        expected_interval = expected - self._expected_prior
        received_interval = self.received - self._received_prior
        self._expected_prior = expected
        self._received_prior = self.received
        lost_interval = expected_interval - received_interval
        if expected_interval <= 0 or lost_interval <= 0:
            fraction = 0
        else:
            fraction = min(255, (lost_interval << 8) // expected_interval)
        dlsr = 0
        if self._lsr_arrival is not None:
            dlsr = int((now - self._lsr_arrival) * 65536.0) & 0xFFFFFFFF
        return ReportBlock(
            ssrc=self.ssrc,
            fraction_lost=fraction,
            cumulative_lost=min(lost, 0xFFFFFF),
            highest_seq=max_seq & 0xFFFFFFFF,
            jitter=int(self.jitter) & 0xFFFFFFFF,
            lsr=self._lsr,
            dlsr=dlsr,
        )


def rtt_from_report(block: ReportBlock,
                    now: Optional[float] = None) -> Optional[float]:
    """Sender-side RTT from a received report block (RFC 3550 §6.4.1):
    rtt = now(middle-32 NTP) - LSR - DLSR. None when no SR was mirrored."""
    if block.lsr == 0:
        return None
    now = time.time() if now is None else now
    ntp = now + NTP_EPOCH_OFFSET
    now32 = ((int(ntp) & 0xFFFF) << 16) | (int((ntp % 1.0) * 65536.0) & 0xFFFF)
    rtt32 = (now32 - block.lsr - block.dlsr) & 0xFFFFFFFF
    if rtt32 > 0x7FFFFFFF:  # clock skew / garbage
        return None
    return rtt32 / 65536.0
