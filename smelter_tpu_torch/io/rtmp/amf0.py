"""AMF0 encoding/decoding (reference `rtmp/src/amf0/`).

Implements the types RTMP command/data messages use: number, boolean,
string/long-string, object, null, undefined, ECMA array, strict array, date.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

NUMBER = 0x00
BOOLEAN = 0x01
STRING = 0x02
OBJECT = 0x03
NULL = 0x05
UNDEFINED = 0x06
REFERENCE = 0x07
ECMA_ARRAY = 0x08
OBJECT_END = 0x09
STRICT_ARRAY = 0x0A
DATE = 0x0B
LONG_STRING = 0x0C
AVMPLUS = 0x11  # escape to an AMF3-encoded value (objectEncoding=3 peers)


class Amf0Error(ValueError):
    pass


def encode(value: Any) -> bytes:
    """Python value → AMF0 bytes. dict → object, list → strict array."""
    if value is None:
        return bytes([NULL])
    if isinstance(value, bool):
        return bytes([BOOLEAN, 1 if value else 0])
    if isinstance(value, (int, float)):
        return bytes([NUMBER]) + struct.pack(">d", float(value))
    if isinstance(value, str):
        raw = value.encode("utf-8")
        if len(raw) < 0x10000:
            return bytes([STRING]) + struct.pack(">H", len(raw)) + raw
        return bytes([LONG_STRING]) + struct.pack(">I", len(raw)) + raw
    if isinstance(value, dict):
        out = bytearray([OBJECT])
        for k, v in value.items():
            kb = str(k).encode("utf-8")
            out += struct.pack(">H", len(kb)) + kb + encode(v)
        out += struct.pack(">H", 0) + bytes([OBJECT_END])
        return bytes(out)
    if isinstance(value, (list, tuple)):
        out = bytearray([STRICT_ARRAY]) + struct.pack(">I", len(value))
        for v in value:
            out += encode(v)
        return bytes(out)
    raise Amf0Error(f"cannot AMF0-encode {type(value)}")


def encode_all(*values: Any) -> bytes:
    return b"".join(encode(v) for v in values)


def decode(data: bytes, offset: int = 0) -> Tuple[Any, int]:
    """Returns (value, next_offset)."""
    if offset >= len(data):
        raise Amf0Error("truncated AMF0")
    marker = data[offset]
    offset += 1
    if marker == NUMBER:
        (v,) = struct.unpack_from(">d", data, offset)
        return v, offset + 8
    if marker == BOOLEAN:
        return bool(data[offset]), offset + 1
    if marker == STRING:
        (n,) = struct.unpack_from(">H", data, offset)
        offset += 2
        return data[offset : offset + n].decode("utf-8", "replace"), offset + n
    if marker == LONG_STRING:
        (n,) = struct.unpack_from(">I", data, offset)
        offset += 4
        return data[offset : offset + n].decode("utf-8", "replace"), offset + n
    if marker in (NULL, UNDEFINED):
        return None, offset
    if marker == OBJECT or marker == ECMA_ARRAY:
        if marker == ECMA_ARRAY:
            offset += 4  # approximate length, keys are self-terminating
        obj = {}
        while True:
            (n,) = struct.unpack_from(">H", data, offset)
            offset += 2
            if n == 0 and data[offset] == OBJECT_END:
                return obj, offset + 1
            key = data[offset : offset + n].decode("utf-8", "replace")
            offset += n
            val, offset = decode(data, offset)
            obj[key] = val
    if marker == STRICT_ARRAY:
        (n,) = struct.unpack_from(">I", data, offset)
        offset += 4
        arr = []
        for _ in range(n):
            v, offset = decode(data, offset)
            arr.append(v)
        return arr, offset
    if marker == DATE:
        (ms,) = struct.unpack_from(">d", data, offset)
        return ms, offset + 10  # skip timezone i16
    if marker == AVMPLUS:
        from smelter_tpu_torch.io.rtmp import amf3

        dec = amf3.Decoder(data, offset)
        v = dec.value()
        return v, dec.pos
    raise Amf0Error(f"unsupported AMF0 marker 0x{marker:02x}")


def decode_all(data: bytes) -> List[Any]:
    out = []
    offset = 0
    while offset < len(data):
        v, offset = decode(data, offset)
        out.append(v)
    return out
