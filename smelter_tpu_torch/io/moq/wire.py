"""MoQ session wire protocol (moq-lite-flavored) over QUIC.

ALPN: "moql/1". The reference uses moq-lite over WebTransport via
moq-native; with no browser endpoint in this deployment the WebTransport
framing is dead weight, so sessions run straight over QUIC streams — the
session semantics (broadcast paths, announce, track subscribe, group-per-
stream delivery with keyframe-started groups) match the reference's
`moq/server.rs` + `input/connection.rs` behavior.

Control stream (first client-opened bidi stream): length-prefixed
messages, each `varint type + varint body_len + body`:

  0x01 SETUP        c->s  {version u8, path str, token str}
  0x02 SETUP_OK     s->c  {version u8}
  0x03 SETUP_ERROR  s->c  {code varint, reason str}
  0x10 ANNOUNCE     pub->sub {broadcast_path str}
  0x11 SUBSCRIBE    sub->pub {subscribe_id varint, track_name str}
  0x12 SUBSCRIBE_OK pub->sub {subscribe_id varint}
  0x13 SUBSCRIBE_ERROR pub->sub {subscribe_id varint, code varint, reason str}
  0x14 UNANNOUNCE   pub->sub {broadcast_path str}

Media: each GROUP is one QUIC unidirectional stream:
  header: varint 0x20, varint subscribe_id, varint group_sequence
  then frames until FIN: {varint timestamp_us, u8 flags(bit0 keyframe),
  varint payload_len, payload}

Strings are varint-length-prefixed UTF-8.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from smelter_tpu_torch.io.quic.packet import decode_varint, encode_varint

ALPN = "moql/1"
VERSION = 1

MSG_SETUP = 0x01
MSG_SETUP_OK = 0x02
MSG_SETUP_ERROR = 0x03
MSG_ANNOUNCE = 0x10
MSG_SUBSCRIBE = 0x11
MSG_SUBSCRIBE_OK = 0x12
MSG_SUBSCRIBE_ERROR = 0x13
MSG_UNANNOUNCE = 0x14

GROUP_HEADER = 0x20
OBJECT_DATAGRAM = 0x21


def _s(text: str) -> bytes:
    raw = text.encode()
    return encode_varint(len(raw)) + raw


class Reader:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos

    def varint(self) -> int:
        v, self.pos = decode_varint(self.data, self.pos)
        return v

    def string(self) -> str:
        n = self.varint()
        out = self.data[self.pos : self.pos + n].decode()
        self.pos += n
        return out

    def u8(self) -> int:
        v = self.data[self.pos]
        self.pos += 1
        return v

    def take(self, n: int) -> bytes:
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def remaining(self) -> int:
        return len(self.data) - self.pos


def msg(mtype: int, body: bytes) -> bytes:
    return encode_varint(mtype) + encode_varint(len(body)) + body


def setup(path: str, token: str) -> bytes:
    return msg(MSG_SETUP, bytes([VERSION]) + _s(path) + _s(token))


def setup_ok() -> bytes:
    return msg(MSG_SETUP_OK, bytes([VERSION]))


def setup_error(code: int, reason: str) -> bytes:
    return msg(MSG_SETUP_ERROR, encode_varint(code) + _s(reason))


def announce(path: str) -> bytes:
    return msg(MSG_ANNOUNCE, _s(path))


def unannounce(path: str) -> bytes:
    return msg(MSG_UNANNOUNCE, _s(path))


def subscribe(subscribe_id: int, track: str) -> bytes:
    return msg(MSG_SUBSCRIBE, encode_varint(subscribe_id) + _s(track))


def subscribe_ok(subscribe_id: int) -> bytes:
    return msg(MSG_SUBSCRIBE_OK, encode_varint(subscribe_id))


def subscribe_error(subscribe_id: int, code: int, reason: str) -> bytes:
    return msg(
        MSG_SUBSCRIBE_ERROR,
        encode_varint(subscribe_id) + encode_varint(code) + _s(reason),
    )


@dataclass
class ControlMessage:
    mtype: int
    body: bytes


class ControlParser:
    """Incremental parser for the control byte stream."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, data: bytes) -> List[ControlMessage]:
        self._buf += data
        out: List[ControlMessage] = []
        while True:
            try:
                r = Reader(self._buf)
                mtype = r.varint()
                blen = r.varint()
                if r.remaining() < blen:
                    break
                body = r.take(blen)
            except (IndexError, ValueError):
                break
            self._buf = self._buf[r.pos :]
            out.append(ControlMessage(mtype, body))
        return out


def group_header(subscribe_id: int, group_seq: int) -> bytes:
    return (encode_varint(GROUP_HEADER) + encode_varint(subscribe_id)
            + encode_varint(group_seq))


def frame(timestamp_us: int, keyframe: bool, payload: bytes) -> bytes:
    return (encode_varint(timestamp_us) + bytes([1 if keyframe else 0])
            + encode_varint(len(payload)) + payload)


def object_datagram(subscribe_id: int, group_seq: int, timestamp_us: int,
                    keyframe: bool, payload: bytes) -> bytes:
    """Self-contained low-latency object riding a QUIC DATAGRAM frame
    (unreliable, unordered — no stream head-of-line blocking). Mirrors
    MoQT's OBJECT_DATAGRAM message shape."""
    return (encode_varint(OBJECT_DATAGRAM) + encode_varint(subscribe_id)
            + encode_varint(group_seq) + encode_varint(timestamp_us)
            + bytes([1 if keyframe else 0]) + payload)


def parse_object_datagram(data: bytes):
    """-> (subscribe_id, group_seq, MediaFrame) or None if not an object
    datagram / truncated."""
    try:
        r = Reader(data)
        if r.varint() != OBJECT_DATAGRAM:
            return None
        sid = r.varint()
        seq = r.varint()
        ts = r.varint()
        flags = r.u8()
        payload = data[r.pos:]
    except (IndexError, ValueError):
        return None
    return sid, seq, MediaFrame(ts, bool(flags & 1), payload)


@dataclass
class MediaFrame:
    timestamp_us: int
    keyframe: bool
    payload: bytes


class GroupParser:
    """Incremental parser for one group (uni) stream."""

    def __init__(self) -> None:
        self._buf = b""
        self.subscribe_id: Optional[int] = None
        self.group_seq: Optional[int] = None

    def feed(self, data: bytes) -> List[MediaFrame]:
        self._buf += data
        out: List[MediaFrame] = []
        while True:
            try:
                r = Reader(self._buf)
                if self.subscribe_id is None:
                    marker = r.varint()
                    if marker != GROUP_HEADER:
                        raise ValueError(f"bad group marker {marker:#x}")
                    sid = r.varint()
                    seq = r.varint()
                    self._buf = self._buf[r.pos :]
                    self.subscribe_id = sid
                    self.group_seq = seq
                    continue
                ts = r.varint()
                flags = r.u8()
                plen = r.varint()
                if r.remaining() < plen:
                    break
                payload = r.take(plen)
            except (IndexError, ValueError) as exc:
                if isinstance(exc, ValueError) and "bad group marker" in str(exc):
                    raise
                break
            self._buf = self._buf[r.pos :]
            out.append(MediaFrame(ts, bool(flags & 1), payload))
        return out
