"""RTMP chunk stream protocol (reference `rtmp/src/protocol/chunk.rs`).

Message (de)multiplexing over chunks: fmt 0-3 headers, per-chunk-stream
state, extended timestamps, dynamic chunk sizes, message reassembly.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# message type ids
SET_CHUNK_SIZE = 1
ABORT = 2
ACK = 3
USER_CONTROL = 4
WINDOW_ACK_SIZE = 5
SET_PEER_BANDWIDTH = 6
AUDIO = 8
VIDEO = 9
DATA_AMF3 = 15
COMMAND_AMF3 = 17
DATA_AMF0 = 18
SHARED_OBJECT_AMF0 = 19
COMMAND_AMF0 = 20
AGGREGATE = 22

DEFAULT_CHUNK_SIZE = 128
EXT_TS = 0xFFFFFF


@dataclass
class RtmpMessage:
    message_type: int
    timestamp: int          # milliseconds (absolute)
    stream_id: int
    payload: bytes
    chunk_stream_id: int = 3


@dataclass
class _CsState:
    timestamp: int = 0
    timestamp_delta: int = 0
    length: int = 0
    message_type: int = 0
    stream_id: int = 0
    buffer: bytearray = field(default_factory=bytearray)


class ChunkReader:
    """Incremental parser: feed() bytes, collect complete RtmpMessages."""

    def __init__(self) -> None:
        self.chunk_size = DEFAULT_CHUNK_SIZE
        self._buf = bytearray()
        self._streams: Dict[int, _CsState] = {}

    def feed(self, data: bytes) -> List[RtmpMessage]:
        self._buf.extend(data)
        out: List[RtmpMessage] = []
        while True:
            msg = self._try_parse_one()
            if msg is None:
                break
            if msg.message_type == SET_CHUNK_SIZE and len(msg.payload) >= 4:
                self.chunk_size = struct.unpack(">I", msg.payload[:4])[0] & 0x7FFFFFFF
            out.append(msg)
        return out

    def _try_parse_one(self) -> Optional[RtmpMessage]:
        buf = self._buf
        if not buf:
            return None
        # basic header
        b0 = buf[0]
        fmt = b0 >> 6
        csid = b0 & 0x3F
        pos = 1
        if csid == 0:
            if len(buf) < 2:
                return None
            csid = 64 + buf[1]
            pos = 2
        elif csid == 1:
            if len(buf) < 3:
                return None
            csid = 64 + buf[1] + buf[2] * 256
            pos = 3
        st = self._streams.setdefault(csid, _CsState())
        # message header
        if fmt == 0:
            need = pos + 11
            if len(buf) < need:
                return None
            ts, = struct.unpack(">I", b"\x00" + bytes(buf[pos : pos + 3]))
            length, = struct.unpack(">I", b"\x00" + bytes(buf[pos + 3 : pos + 6]))
            mtype = buf[pos + 6]
            stream_id = struct.unpack("<I", bytes(buf[pos + 7 : pos + 11]))[0]
            pos = need
            if ts == EXT_TS:
                if len(buf) < pos + 4:
                    return None
                ts = struct.unpack(">I", bytes(buf[pos : pos + 4]))[0]
                pos += 4
            if not st.buffer:
                st.timestamp = ts
            st.timestamp_delta = 0
            st.length = length
            st.message_type = mtype
            st.stream_id = stream_id
        elif fmt == 1:
            need = pos + 7
            if len(buf) < need:
                return None
            delta, = struct.unpack(">I", b"\x00" + bytes(buf[pos : pos + 3]))
            length, = struct.unpack(">I", b"\x00" + bytes(buf[pos + 3 : pos + 6]))
            mtype = buf[pos + 6]
            pos = need
            if delta == EXT_TS:
                if len(buf) < pos + 4:
                    return None
                delta = struct.unpack(">I", bytes(buf[pos : pos + 4]))[0]
                pos += 4
            if not st.buffer:
                st.timestamp += delta
            st.timestamp_delta = delta
            st.length = length
            st.message_type = mtype
        elif fmt == 2:
            need = pos + 3
            if len(buf) < need:
                return None
            delta, = struct.unpack(">I", b"\x00" + bytes(buf[pos : pos + 3]))
            pos = need
            if delta == EXT_TS:
                if len(buf) < pos + 4:
                    return None
                delta = struct.unpack(">I", bytes(buf[pos : pos + 4]))[0]
                pos += 4
            if not st.buffer:
                st.timestamp += delta
            st.timestamp_delta = delta
        else:  # fmt == 3: continuation — everything from state
            if not st.buffer and st.timestamp_delta:
                st.timestamp += st.timestamp_delta

        remaining = st.length - len(st.buffer)
        take = min(remaining, self.chunk_size)
        if len(buf) < pos + take:
            return None
        st.buffer += buf[pos : pos + take]
        del buf[: pos + take]
        if len(st.buffer) < st.length:
            return self._try_parse_one() if buf else None
        payload = bytes(st.buffer)
        st.buffer = bytearray()
        return RtmpMessage(
            message_type=st.message_type,
            timestamp=st.timestamp,
            stream_id=st.stream_id,
            payload=payload,
            chunk_stream_id=csid,
        )


class ChunkWriter:
    """Serializes RtmpMessages into chunks (fmt 0 + fmt 3 continuations)."""

    def __init__(self, chunk_size: int = DEFAULT_CHUNK_SIZE) -> None:
        self.chunk_size = chunk_size

    def set_chunk_size_message(self, size: int) -> RtmpMessage:
        return RtmpMessage(
            SET_CHUNK_SIZE, 0, 0, struct.pack(">I", size), chunk_stream_id=2
        )

    def serialize(self, msg: RtmpMessage) -> bytes:
        csid = msg.chunk_stream_id
        ts = msg.timestamp & 0xFFFFFFFF
        ext = ts >= EXT_TS
        hdr_ts = EXT_TS if ext else ts
        out = bytearray()
        basic = bytes([(0 << 6) | csid]) if csid < 64 else None
        if basic is None:
            raise ValueError("csid >= 64 not supported by writer")
        header = (
            basic
            + struct.pack(">I", hdr_ts)[1:]
            + struct.pack(">I", len(msg.payload))[1:]
            + bytes([msg.message_type])
            + struct.pack("<I", msg.stream_id)
        )
        out += header
        if ext:
            out += struct.pack(">I", ts)
        pos = 0
        first = True
        while pos < len(msg.payload) or first:
            if not first:
                out += bytes([(3 << 6) | csid])
                if ext:
                    out += struct.pack(">I", ts)
            chunk = msg.payload[pos : pos + self.chunk_size]
            out += chunk
            pos += len(chunk)
            first = False
        return bytes(out)
