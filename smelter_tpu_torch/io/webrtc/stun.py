"""Minimal STUN (RFC 5389) for ICE connectivity checks.

Implements what an ICE-lite responder + a simple full-agent sender need:
Binding request/response with USERNAME, MESSAGE-INTEGRITY (HMAC-SHA1 over the
short-term credential), FINGERPRINT, XOR-MAPPED-ADDRESS, USE-CANDIDATE,
ICE-CONTROLL{ING,ED}, PRIORITY.
"""

from __future__ import annotations

import hmac
import os
import socket
import struct
import zlib
from dataclasses import dataclass, field
from hashlib import sha1
from typing import List, Optional, Tuple

MAGIC_COOKIE = 0x2112A442

BINDING_REQUEST = 0x0001
BINDING_RESPONSE = 0x0101
BINDING_ERROR = 0x0111

ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A


@dataclass
class StunMessage:
    msg_type: int
    transaction_id: bytes
    attributes: List[Tuple[int, bytes]] = field(default_factory=list)

    def attr(self, attr_type: int) -> Optional[bytes]:
        for t, v in self.attributes:
            if t == attr_type:
                return v
        return None


def is_stun(data: bytes) -> bool:
    return (
        len(data) >= 20
        and data[0] < 4
        and struct.unpack("!I", data[4:8])[0] == MAGIC_COOKIE
    )


def parse(data: bytes) -> Optional[StunMessage]:
    if not is_stun(data):
        return None
    msg_type, length = struct.unpack("!HH", data[:4])
    tid = data[8:20]
    attrs: List[Tuple[int, bytes]] = []
    pos = 20
    end = min(20 + length, len(data))
    while pos + 4 <= end:
        at, alen = struct.unpack("!HH", data[pos : pos + 4])
        pos += 4
        attrs.append((at, data[pos : pos + alen]))
        pos += alen + ((4 - alen % 4) % 4)
    return StunMessage(msg_type, tid, attrs)


def _serialize(msg_type: int, tid: bytes, attrs: List[Tuple[int, bytes]]) -> bytes:
    body = b""
    for at, val in attrs:
        body += struct.pack("!HH", at, len(val)) + val
        body += b"\x00" * ((4 - len(val) % 4) % 4)
    return struct.pack("!HHI", msg_type, len(body), MAGIC_COOKIE) + tid + body


def build(
    msg_type: int,
    tid: Optional[bytes] = None,
    attrs: Optional[List[Tuple[int, bytes]]] = None,
    password: Optional[str] = None,
) -> bytes:
    """Serialize with MESSAGE-INTEGRITY (if password) and FINGERPRINT."""
    tid = tid or os.urandom(12)
    attrs = list(attrs or [])
    if password is not None:
        # integrity is computed over the message with the length field
        # covering up to and including the MI attribute
        trial = _serialize(msg_type, tid, attrs + [(ATTR_MESSAGE_INTEGRITY, b"\x00" * 20)])
        mac = hmac.new(password.encode(), trial[: -24], sha1).digest()
        attrs.append((ATTR_MESSAGE_INTEGRITY, mac))
    with_fp = _serialize(msg_type, tid, attrs + [(ATTR_FINGERPRINT, b"\x00" * 4)])
    crc = (zlib.crc32(with_fp[:-8]) ^ 0x5354554E) & 0xFFFFFFFF
    attrs.append((ATTR_FINGERPRINT, struct.pack("!I", crc)))
    return _serialize(msg_type, tid, attrs)


def check_integrity(data: bytes, msg: StunMessage, password: str) -> bool:
    """Validates MESSAGE-INTEGRITY of a parsed message."""
    mi = msg.attr(ATTR_MESSAGE_INTEGRITY)
    if mi is None:
        return False
    # find MI attr offset to truncate; rebuild header with adjusted length
    pos = 20
    length = struct.unpack("!HH", data[:4])[1]
    end = 20 + length
    while pos + 4 <= end:
        at, alen = struct.unpack("!HH", data[pos : pos + 4])
        if at == ATTR_MESSAGE_INTEGRITY:
            covered_len = pos + 4 + 20 - 20
            hdr = struct.pack("!HHI", msg.msg_type, covered_len, MAGIC_COOKIE)
            covered = hdr + data[8:pos]
            mac = hmac.new(password.encode(), covered, sha1).digest()
            return hmac.compare_digest(mac, mi)
        pos += 4 + alen + ((4 - alen % 4) % 4)
    return False


def xor_mapped_address(addr: Tuple[str, int], tid: bytes) -> bytes:
    ip = socket.inet_aton(addr[0])
    port = addr[1] ^ (MAGIC_COOKIE >> 16)
    xip = bytes(b ^ m for b, m in zip(ip, struct.pack("!I", MAGIC_COOKIE)))
    return struct.pack("!BBH", 0, 0x01, port) + xip


def parse_xor_mapped_address(value: bytes, tid: bytes) -> Tuple[str, int]:
    port = struct.unpack("!H", value[2:4])[0] ^ (MAGIC_COOKIE >> 16)
    xip = bytes(b ^ m for b, m in zip(value[4:8], struct.pack("!I", MAGIC_COOKIE)))
    return socket.inet_ntoa(xip), port
