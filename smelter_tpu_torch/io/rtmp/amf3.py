"""AMF3 (Action Message Format 3) encode/decode.

Complements amf0.py for "enhanced" RTMP clients that negotiate
objectEncoding=3: COMMAND_AMF3/DATA_AMF3 message bodies and AMF0 values
escaped with the avmplus marker (0x11) carry AMF3-encoded values
(reference `rtmp/src/protocol/amf` handles the same escape).

Spec: Adobe AMF3 (January 2013). Implemented: undefined, null, bool,
integer (U29), double, string (with reference table), array (dense +
associative), anonymous/dynamic objects (with trait references), date,
byte-array. Not implemented (never sent by RTMP encoders): XML, vectors,
dictionaries — these decode to an error.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Optional, Tuple

UNDEFINED = 0x00
NULL = 0x01
FALSE = 0x02
TRUE = 0x03
INTEGER = 0x04
DOUBLE = 0x05
STRING = 0x06
XML_DOC = 0x07
DATE = 0x08
ARRAY = 0x09
OBJECT = 0x0A
XML = 0x0B
BYTE_ARRAY = 0x0C


class Amf3Error(ValueError):
    pass


class _Undefined:
    _inst: Optional["_Undefined"] = None

    def __new__(cls):
        if cls._inst is None:
            cls._inst = super().__new__(cls)
        return cls._inst

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "amf3.undefined"


undefined = _Undefined()


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class Decoder:
    def __init__(self, data: bytes, pos: int = 0) -> None:
        self.data = data
        self.pos = pos
        self.strings: List[str] = []
        self.objects: List[Any] = []
        self.traits: List[Tuple[bool, List[str]]] = []  # (dynamic, sealed names)

    def _byte(self) -> int:
        if self.pos >= len(self.data):
            raise Amf3Error("truncated AMF3")
        b = self.data[self.pos]
        self.pos += 1
        return b

    def _u29(self) -> int:
        """Variable-length 29-bit unsigned int (1-4 bytes)."""
        value = 0
        for i in range(3):
            b = self._byte()
            value = (value << 7) | (b & 0x7F)
            if not b & 0x80:
                return value
        return (value << 8) | self._byte()

    def _double(self) -> float:
        if self.pos + 8 > len(self.data):
            raise Amf3Error("truncated double")
        (v,) = struct.unpack_from(">d", self.data, self.pos)
        self.pos += 8
        return v

    def _string(self) -> str:
        ref = self._u29()
        if not ref & 1:
            return self.strings[ref >> 1]
        n = ref >> 1
        s = self.data[self.pos : self.pos + n].decode("utf-8", "replace")
        self.pos += n
        if s:
            self.strings.append(s)
        return s

    def value(self) -> Any:
        marker = self._byte()
        if marker == UNDEFINED:
            return undefined
        if marker == NULL:
            return None
        if marker == FALSE:
            return False
        if marker == TRUE:
            return True
        if marker == INTEGER:
            v = self._u29()
            return v - 0x20000000 if v & 0x10000000 else v
        if marker == DOUBLE:
            return self._double()
        if marker == STRING:
            return self._string()
        if marker == DATE:
            ref = self._u29()
            if not ref & 1:
                return self.objects[ref >> 1]
            ms = self._double()
            self.objects.append(ms / 1000.0)
            return ms / 1000.0
        if marker == ARRAY:
            ref = self._u29()
            if not ref & 1:
                return self.objects[ref >> 1]
            dense_len = ref >> 1
            out_assoc: Dict[str, Any] = {}
            placeholder: Any = out_assoc
            self.objects.append(placeholder)
            while True:
                key = self._string()
                if key == "":
                    break
                out_assoc[key] = self.value()
            dense = [self.value() for _ in range(dense_len)]
            if out_assoc:
                out_assoc["__dense__"] = dense
                return out_assoc
            idx = self.objects.index(placeholder)
            self.objects[idx] = dense
            return dense
        if marker == OBJECT:
            ref = self._u29()
            if not ref & 1:
                return self.objects[ref >> 1]
            obj: Dict[str, Any] = {}
            self.objects.append(obj)
            if ref & 2:
                if ref & 4:
                    raise Amf3Error("externalizable objects unsupported")
                dynamic = bool(ref & 8)
                n_sealed = ref >> 4
                self._string()  # class name (anonymous = empty)
                names = [self._string() for _ in range(n_sealed)]
                self.traits.append((dynamic, names))
            else:
                dynamic, names = self.traits[ref >> 2]
            for name in names:
                obj[name] = self.value()
            if dynamic:
                while True:
                    key = self._string()
                    if key == "":
                        break
                    obj[key] = self.value()
            return obj
        if marker == BYTE_ARRAY:
            ref = self._u29()
            if not ref & 1:
                return self.objects[ref >> 1]
            n = ref >> 1
            b = self.data[self.pos : self.pos + n]
            self.pos += n
            self.objects.append(b)
            return b
        raise Amf3Error(f"unsupported AMF3 marker 0x{marker:02x}")


def decode_all(data: bytes) -> List[Any]:
    dec = Decoder(data)
    out = []
    while dec.pos < len(data):
        out.append(dec.value())
    return out


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


def _u29(value: int) -> bytes:
    if value < 0x80:
        return bytes([value])
    if value < 0x4000:
        return bytes([0x80 | (value >> 7), value & 0x7F])
    if value < 0x200000:
        return bytes([0x80 | (value >> 14), 0x80 | ((value >> 7) & 0x7F), value & 0x7F])
    if value < 0x40000000:
        return bytes(
            [
                0x80 | (value >> 22),
                0x80 | ((value >> 15) & 0x7F),
                0x80 | ((value >> 8) & 0x7F),
                value & 0xFF,
            ]
        )
    raise Amf3Error("U29 overflow")


def _encode_string_body(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _u29((len(raw) << 1) | 1) + raw


def encode(value: Any) -> bytes:
    """Encode one value (no reference-table compression — always inline)."""
    if value is undefined:
        return bytes([UNDEFINED])
    if value is None:
        return bytes([NULL])
    if value is True:
        return bytes([TRUE])
    if value is False:
        return bytes([FALSE])
    if isinstance(value, int) and -0x10000000 <= value < 0x10000000:
        return bytes([INTEGER]) + _u29(value & 0x1FFFFFFF)
    if isinstance(value, (int, float)):
        return bytes([DOUBLE]) + struct.pack(">d", float(value))
    if isinstance(value, str):
        return bytes([STRING]) + _encode_string_body(value)
    if isinstance(value, (bytes, bytearray)):
        return bytes([BYTE_ARRAY]) + _u29((len(value) << 1) | 1) + bytes(value)
    if isinstance(value, (list, tuple)):
        out = bytes([ARRAY]) + _u29((len(value) << 1) | 1) + _u29(1)  # empty assoc
        for v in value:
            out += encode(v)
        return out
    if isinstance(value, dict):
        # anonymous dynamic object, zero sealed members: traits = 0b1011
        out = bytes([OBJECT]) + _u29(0x0B) + _u29(1)  # traits + empty class name
        for k, v in value.items():
            out += _encode_string_body(str(k)) + encode(v)
        out += _u29(1)  # empty key terminator
        return out
    raise Amf3Error(f"cannot encode {type(value)!r} as AMF3")


def encode_all(*values: Any) -> bytes:
    return b"".join(encode(v) for v in values)
