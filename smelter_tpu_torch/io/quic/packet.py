"""QUIC v1 wire format: varints, packet headers, frames (RFC 9000 §16-19)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

QUIC_V1 = 0x00000001

# long header packet types (RFC 9000 §17.2)
PKT_INITIAL = 0
PKT_0RTT = 1
PKT_HANDSHAKE = 2
PKT_RETRY = 3

# frame types (RFC 9000 §19)
FT_PADDING = 0x00
FT_PING = 0x01
FT_ACK = 0x02            # ..0x03 with ECN
FT_RESET_STREAM = 0x04
FT_STOP_SENDING = 0x05
FT_CRYPTO = 0x06
FT_NEW_TOKEN = 0x07
FT_STREAM = 0x08         # ..0x0f (OFF/LEN/FIN bits)
FT_MAX_DATA = 0x10
FT_MAX_STREAM_DATA = 0x11
FT_MAX_STREAMS_BIDI = 0x12
FT_MAX_STREAMS_UNI = 0x13
FT_DATA_BLOCKED = 0x14
FT_STREAM_DATA_BLOCKED = 0x15
FT_STREAMS_BLOCKED_BIDI = 0x16
FT_STREAMS_BLOCKED_UNI = 0x17
FT_NEW_CONNECTION_ID = 0x18
FT_RETIRE_CONNECTION_ID = 0x19
FT_PATH_CHALLENGE = 0x1A
FT_PATH_RESPONSE = 0x1B
FT_CONNECTION_CLOSE = 0x1C   # transport
FT_CONNECTION_CLOSE_APP = 0x1D
FT_HANDSHAKE_DONE = 0x1E
FT_DATAGRAM = 0x30           # ..0x31 (RFC 9221)


# ---------------------------------------------------------------------------
# varints (RFC 9000 §16)
# ---------------------------------------------------------------------------


def encode_varint(v: int) -> bytes:
    if v < 0x40:
        return bytes([v])
    if v < 0x4000:
        return (0x4000 | v).to_bytes(2, "big")
    if v < 0x40000000:
        return (0x80000000 | v).to_bytes(4, "big")
    if v < 0x4000000000000000:
        return (0xC000000000000000 | v).to_bytes(8, "big")
    raise ValueError("varint too large")


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    """-> (value, new_pos)"""
    first = data[pos]
    n = 1 << (first >> 6)
    v = int.from_bytes(data[pos : pos + n], "big") & ((1 << (8 * n - 2)) - 1)
    return v, pos + n


class Buf:
    """Cursor over bytes for frame decoding."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def varint(self) -> int:
        v, self.pos = decode_varint(self.data, self.pos)
        return v

    def bytes(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        if len(out) < n:
            raise ValueError("short read")
        self.pos += n
        return out

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v


# ---------------------------------------------------------------------------
# packet numbers (RFC 9000 §17.1, A.2/A.3)
# ---------------------------------------------------------------------------


def encode_packet_number(pn: int, largest_acked: int) -> bytes:
    """Smallest encoding distinguishing pn from largest_acked."""
    num_unacked = pn - largest_acked if largest_acked >= 0 else pn + 1
    min_bits = max(num_unacked.bit_length() + 1, 8)
    length = (min_bits + 7) // 8
    length = min(length, 4)
    return pn.to_bytes(4, "big")[-length:]


def decode_packet_number(truncated: int, pn_nbits: int, largest_pn: int) -> int:
    expected = largest_pn + 1
    pn_win = 1 << pn_nbits
    pn_hwin = pn_win // 2
    pn_mask = pn_win - 1
    candidate = (expected & ~pn_mask) | truncated
    if candidate <= expected - pn_hwin and candidate < (1 << 62) - pn_win:
        return candidate + pn_win
    if candidate > expected + pn_hwin and candidate >= pn_win:
        return candidate - pn_win
    return candidate


# ---------------------------------------------------------------------------
# headers
# ---------------------------------------------------------------------------


@dataclass
class LongHeader:
    packet_type: int
    version: int
    dcid: bytes
    scid: bytes
    token: bytes = b""       # Initial only
    # filled by the unprotect step:
    packet_number: int = 0
    payload: bytes = b""


def parse_long_header_prefix(data: bytes) -> Tuple[LongHeader, int]:
    """Parse up to (not including) the length field. -> (hdr, pos)."""
    if not data or not (data[0] & 0x80):
        raise ValueError("not a long header")
    version = int.from_bytes(data[1:5], "big")
    ptype = (data[0] >> 4) & 0x03
    pos = 5
    dcil = data[pos]; pos += 1
    dcid = data[pos : pos + dcil]; pos += dcil
    scil = data[pos]; pos += 1
    scid = data[pos : pos + scil]; pos += scil
    token = b""
    if ptype == PKT_INITIAL:
        tl, pos = decode_varint(data, pos)
        token = data[pos : pos + tl]
        pos += tl
    return LongHeader(ptype, version, dcid, scid, token), pos


def build_long_header_prefix(h: LongHeader, pn_len: int) -> bytes:
    first = 0xC0 | (h.packet_type << 4) | (pn_len - 1)
    out = bytearray([first])
    out += h.version.to_bytes(4, "big")
    out += bytes([len(h.dcid)]) + h.dcid
    out += bytes([len(h.scid)]) + h.scid
    if h.packet_type == PKT_INITIAL:
        out += encode_varint(len(h.token)) + h.token
    return bytes(out)


def build_retry(version: int, dcid: bytes, scid: bytes, token: bytes,
                odcid: bytes) -> bytes:
    """Retry packet (RFC 9000 §17.2.5): long header + token + integrity tag
    computed over the ODCID-prefixed pseudo-packet (RFC 9001 §5.8)."""
    from smelter_tpu_torch.io.quic.crypto import retry_integrity_tag

    out = bytearray([0xC0 | (PKT_RETRY << 4)])
    out += version.to_bytes(4, "big")
    out += bytes([len(dcid)]) + dcid
    out += bytes([len(scid)]) + scid
    out += token
    return bytes(out) + retry_integrity_tag(odcid, bytes(out))


def parse_retry(data: bytes) -> Tuple[LongHeader, bytes, bytes]:
    """-> (header, token, integrity_tag). Raises ValueError on truncation."""
    hdr, pos = parse_long_header_prefix(data)
    if hdr.packet_type != PKT_RETRY:
        raise ValueError("not a retry packet")
    if len(data) < pos + 16:
        raise ValueError("retry too short")
    return hdr, data[pos:-16], data[-16:]


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


@dataclass
class AckFrame:
    largest: int
    delay_us: int
    ranges: List[Tuple[int, int]]  # [(lo, hi)] descending by hi


@dataclass
class CryptoFrame:
    offset: int
    data: bytes


@dataclass
class StreamFrame:
    stream_id: int
    offset: int
    data: bytes
    fin: bool


@dataclass
class ResetStreamFrame:
    stream_id: int
    error_code: int
    final_size: int


@dataclass
class StopSendingFrame:
    stream_id: int
    error_code: int


@dataclass
class MaxDataFrame:
    maximum: int


@dataclass
class MaxStreamDataFrame:
    stream_id: int
    maximum: int


@dataclass
class MaxStreamsFrame:
    bidi: bool
    maximum: int


@dataclass
class ConnectionCloseFrame:
    error_code: int
    frame_type: Optional[int]  # None = application close
    reason: bytes


@dataclass
class DatagramFrame:
    data: bytes


@dataclass
class HandshakeDoneFrame:
    pass


@dataclass
class PingFrame:
    pass


@dataclass
class PathChallengeFrame:
    data: bytes


@dataclass
class PathResponseFrame:
    data: bytes


def encode_ack(ack: AckFrame, delay_exponent: int = 3) -> bytes:
    out = bytearray(encode_varint(FT_ACK))
    out += encode_varint(ack.largest)
    out += encode_varint(ack.delay_us >> delay_exponent)
    ranges = sorted(ack.ranges, key=lambda r: -r[1])
    first_lo, first_hi = ranges[0]
    assert first_hi == ack.largest
    out += encode_varint(len(ranges) - 1)
    out += encode_varint(first_hi - first_lo)
    prev_lo = first_lo
    for lo, hi in ranges[1:]:
        out += encode_varint(prev_lo - hi - 2)  # gap
        out += encode_varint(hi - lo)
        prev_lo = lo
    return bytes(out)


def encode_crypto(offset: int, data: bytes) -> bytes:
    return (encode_varint(FT_CRYPTO) + encode_varint(offset)
            + encode_varint(len(data)) + data)


def encode_stream(stream_id: int, offset: int, data: bytes, fin: bool) -> bytes:
    ftype = FT_STREAM | 0x02  # LEN always set
    if offset:
        ftype |= 0x04
    if fin:
        ftype |= 0x01
    out = bytearray(encode_varint(ftype))
    out += encode_varint(stream_id)
    if offset:
        out += encode_varint(offset)
    out += encode_varint(len(data)) + data
    return bytes(out)


def encode_datagram(data: bytes) -> bytes:
    return encode_varint(FT_DATAGRAM | 0x01) + encode_varint(len(data)) + data


def encode_connection_close(error_code: int, frame_type: Optional[int],
                            reason: bytes) -> bytes:
    if frame_type is None:
        out = bytearray(encode_varint(FT_CONNECTION_CLOSE_APP))
        out += encode_varint(error_code)
    else:
        out = bytearray(encode_varint(FT_CONNECTION_CLOSE))
        out += encode_varint(error_code)
        out += encode_varint(frame_type)
    out += encode_varint(len(reason)) + reason
    return bytes(out)


def decode_frames(payload: bytes, delay_exponent: int = 3) -> List[object]:
    """Decode every frame in a plaintext packet payload."""
    buf = Buf(payload)
    out: List[object] = []
    while buf.remaining() > 0:
        ftype = buf.varint()
        if ftype == FT_PADDING:
            continue
        if ftype == FT_PING:
            out.append(PingFrame())
        elif ftype in (FT_ACK, FT_ACK + 1):
            largest = buf.varint()
            delay = buf.varint() << delay_exponent
            n_ranges = buf.varint()
            first_range = buf.varint()
            hi = largest
            lo = largest - first_range
            ranges = [(lo, hi)]
            for _ in range(n_ranges):
                gap = buf.varint()
                rng = buf.varint()
                hi = lo - gap - 2
                lo = hi - rng
                ranges.append((lo, hi))
            if ftype == FT_ACK + 1:  # ECN counts
                buf.varint(); buf.varint(); buf.varint()
            out.append(AckFrame(largest, delay, ranges))
        elif ftype == FT_RESET_STREAM:
            out.append(ResetStreamFrame(buf.varint(), buf.varint(), buf.varint()))
        elif ftype == FT_STOP_SENDING:
            out.append(StopSendingFrame(buf.varint(), buf.varint()))
        elif ftype == FT_CRYPTO:
            off = buf.varint()
            ln = buf.varint()
            out.append(CryptoFrame(off, buf.bytes(ln)))
        elif ftype == FT_NEW_TOKEN:
            ln = buf.varint()
            buf.bytes(ln)
        elif FT_STREAM <= ftype <= FT_STREAM | 0x07:
            sid = buf.varint()
            off = buf.varint() if ftype & 0x04 else 0
            ln = buf.varint() if ftype & 0x02 else buf.remaining()
            out.append(StreamFrame(sid, off, buf.bytes(ln), bool(ftype & 0x01)))
        elif ftype == FT_MAX_DATA:
            out.append(MaxDataFrame(buf.varint()))
        elif ftype == FT_MAX_STREAM_DATA:
            out.append(MaxStreamDataFrame(buf.varint(), buf.varint()))
        elif ftype in (FT_MAX_STREAMS_BIDI, FT_MAX_STREAMS_UNI):
            out.append(MaxStreamsFrame(ftype == FT_MAX_STREAMS_BIDI, buf.varint()))
        elif ftype in (FT_DATA_BLOCKED,):
            buf.varint()
        elif ftype in (FT_STREAM_DATA_BLOCKED,):
            buf.varint(); buf.varint()
        elif ftype in (FT_STREAMS_BLOCKED_BIDI, FT_STREAMS_BLOCKED_UNI):
            buf.varint()
        elif ftype == FT_NEW_CONNECTION_ID:
            buf.varint()      # seq
            buf.varint()      # retire prior to
            cil = buf.u8()
            buf.bytes(cil + 16)  # cid + reset token
        elif ftype == FT_RETIRE_CONNECTION_ID:
            buf.varint()
        elif ftype == FT_PATH_CHALLENGE:
            out.append(PathChallengeFrame(buf.bytes(8)))
        elif ftype == FT_PATH_RESPONSE:
            out.append(PathResponseFrame(buf.bytes(8)))
        elif ftype == FT_CONNECTION_CLOSE:
            code = buf.varint()
            ft = buf.varint()
            ln = buf.varint()
            out.append(ConnectionCloseFrame(code, ft, buf.bytes(ln)))
        elif ftype == FT_CONNECTION_CLOSE_APP:
            code = buf.varint()
            ln = buf.varint()
            out.append(ConnectionCloseFrame(code, None, buf.bytes(ln)))
        elif ftype == FT_HANDSHAKE_DONE:
            out.append(HandshakeDoneFrame())
        elif ftype in (FT_DATAGRAM, FT_DATAGRAM | 0x01):
            ln = buf.varint() if ftype & 0x01 else buf.remaining()
            out.append(DatagramFrame(buf.bytes(ln)))
        else:
            raise ValueError(f"unknown frame type 0x{ftype:x}")
    return out


# ---------------------------------------------------------------------------
# transport parameters (RFC 9000 §18)
# ---------------------------------------------------------------------------

TP_MAX_IDLE_TIMEOUT = 0x01
TP_MAX_UDP_PAYLOAD = 0x03
TP_INITIAL_MAX_DATA = 0x04
TP_INITIAL_MAX_STREAM_DATA_BIDI_LOCAL = 0x05
TP_INITIAL_MAX_STREAM_DATA_BIDI_REMOTE = 0x06
TP_INITIAL_MAX_STREAM_DATA_UNI = 0x07
TP_INITIAL_MAX_STREAMS_BIDI = 0x08
TP_INITIAL_MAX_STREAMS_UNI = 0x09
TP_ACK_DELAY_EXPONENT = 0x0A
TP_MAX_ACK_DELAY = 0x0B
TP_DISABLE_ACTIVE_MIGRATION = 0x0C
TP_ORIGINAL_DCID = 0x00
TP_INITIAL_SCID = 0x0F
TP_RETRY_SCID = 0x10
TP_MAX_DATAGRAM_FRAME_SIZE = 0x20


@dataclass
class TransportParams:
    max_idle_timeout_ms: int = 30000
    max_udp_payload: int = 65527
    initial_max_data: int = 16 * 1024 * 1024
    initial_max_stream_data: int = 4 * 1024 * 1024
    initial_max_streams_bidi: int = 128
    initial_max_streams_uni: int = 1024
    ack_delay_exponent: int = 3
    max_ack_delay_ms: int = 25
    original_dcid: Optional[bytes] = None   # server only
    initial_scid: Optional[bytes] = None
    retry_scid: Optional[bytes] = None       # server only, after Retry
    max_datagram_frame_size: int = 65527


def encode_transport_params(tp: TransportParams) -> bytes:
    def param(pid: int, value: bytes) -> bytes:
        return encode_varint(pid) + encode_varint(len(value)) + value

    def vi(pid: int, v: int) -> bytes:
        return param(pid, encode_varint(v))

    out = bytearray()
    out += vi(TP_MAX_IDLE_TIMEOUT, tp.max_idle_timeout_ms)
    out += vi(TP_MAX_UDP_PAYLOAD, tp.max_udp_payload)
    out += vi(TP_INITIAL_MAX_DATA, tp.initial_max_data)
    out += vi(TP_INITIAL_MAX_STREAM_DATA_BIDI_LOCAL, tp.initial_max_stream_data)
    out += vi(TP_INITIAL_MAX_STREAM_DATA_BIDI_REMOTE, tp.initial_max_stream_data)
    out += vi(TP_INITIAL_MAX_STREAM_DATA_UNI, tp.initial_max_stream_data)
    out += vi(TP_INITIAL_MAX_STREAMS_BIDI, tp.initial_max_streams_bidi)
    out += vi(TP_INITIAL_MAX_STREAMS_UNI, tp.initial_max_streams_uni)
    out += vi(TP_ACK_DELAY_EXPONENT, tp.ack_delay_exponent)
    out += vi(TP_MAX_ACK_DELAY, tp.max_ack_delay_ms)
    out += param(TP_DISABLE_ACTIVE_MIGRATION, b"")
    out += vi(TP_MAX_DATAGRAM_FRAME_SIZE, tp.max_datagram_frame_size)
    if tp.original_dcid is not None:
        out += param(TP_ORIGINAL_DCID, tp.original_dcid)
    if tp.initial_scid is not None:
        out += param(TP_INITIAL_SCID, tp.initial_scid)
    if tp.retry_scid is not None:
        out += param(TP_RETRY_SCID, tp.retry_scid)
    return bytes(out)


def decode_transport_params(data: bytes) -> TransportParams:
    tp = TransportParams()
    buf = Buf(data)
    while buf.remaining() > 0:
        pid = buf.varint()
        ln = buf.varint()
        val = buf.bytes(ln)

        def vi() -> int:
            return decode_varint(val, 0)[0] if val else 0

        if pid == TP_MAX_IDLE_TIMEOUT:
            tp.max_idle_timeout_ms = vi()
        elif pid == TP_INITIAL_MAX_DATA:
            tp.initial_max_data = vi()
        elif pid in (TP_INITIAL_MAX_STREAM_DATA_BIDI_LOCAL,
                     TP_INITIAL_MAX_STREAM_DATA_BIDI_REMOTE,
                     TP_INITIAL_MAX_STREAM_DATA_UNI):
            tp.initial_max_stream_data = vi()
        elif pid == TP_INITIAL_MAX_STREAMS_BIDI:
            tp.initial_max_streams_bidi = vi()
        elif pid == TP_INITIAL_MAX_STREAMS_UNI:
            tp.initial_max_streams_uni = vi()
        elif pid == TP_ACK_DELAY_EXPONENT:
            tp.ack_delay_exponent = vi()
        elif pid == TP_MAX_ACK_DELAY:
            tp.max_ack_delay_ms = vi()
        elif pid == TP_ORIGINAL_DCID:
            tp.original_dcid = val
        elif pid == TP_INITIAL_SCID:
            tp.initial_scid = val
        elif pid == TP_RETRY_SCID:
            tp.retry_scid = val
        elif pid == TP_MAX_DATAGRAM_FRAME_SIZE:
            tp.max_datagram_frame_size = vi()
    return tp
