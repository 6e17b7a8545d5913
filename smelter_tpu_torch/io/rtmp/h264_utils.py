"""H.264 AnnexB ↔ AVCC helpers (reference `pipeline/utils/` h264 module).

RTMP/FLV and MP4 carry AVCC (length-prefixed NALUs + avcC config record);
encoders/decoders in this stack speak AnnexB (start codes, inline SPS/PPS).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

NAL_SPS = 7
NAL_PPS = 8
NAL_IDR = 5


def split_annexb(data: bytes) -> List[bytes]:
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
                nals.append(bytes(data[start:i]).rstrip(b"\x00") or bytes(data[start:i]))
            start = i + code_len
            i += code_len
        else:
            i += 1
    if start >= 0:
        nals.append(bytes(data[start:]))
    return [x for x in nals if x]


def annexb_to_avcc(data: bytes) -> bytes:
    out = bytearray()
    for nal in split_annexb(data):
        out += struct.pack(">I", len(nal)) + nal
    return bytes(out)


def avcc_to_annexb(data: bytes, length_size: int = 4) -> bytes:
    out = bytearray()
    i = 0
    while i + length_size <= len(data):
        n = int.from_bytes(data[i : i + length_size], "big")
        i += length_size
        out += b"\x00\x00\x00\x01" + data[i : i + n]
        i += n
    return bytes(out)


def extract_parameter_sets(annexb: bytes) -> Tuple[Optional[bytes], Optional[bytes]]:
    sps = pps = None
    for nal in split_annexb(annexb):
        t = nal[0] & 0x1F
        if t == NAL_SPS and sps is None:
            sps = nal
        elif t == NAL_PPS and pps is None:
            pps = nal
    return sps, pps


def build_avcc_record(sps: bytes, pps: bytes) -> bytes:
    """AVCDecoderConfigurationRecord (ISO 14496-15 §5.2.4.1)."""
    return (
        bytes([1, sps[1], sps[2], sps[3], 0xFF, 0xE1])
        + struct.pack(">H", len(sps))
        + sps
        + bytes([1])
        + struct.pack(">H", len(pps))
        + pps
    )


def parse_avcc_record(record: bytes) -> Tuple[List[bytes], List[bytes], int]:
    """Returns (sps_list, pps_list, nalu_length_size)."""
    if len(record) < 7 or record[0] != 1:
        raise ValueError("not an avcC record")
    length_size = (record[4] & 0x03) + 1
    n_sps = record[5] & 0x1F
    i = 6
    sps = []
    for _ in range(n_sps):
        n = struct.unpack_from(">H", record, i)[0]
        i += 2
        sps.append(record[i : i + n])
        i += n
    n_pps = record[i]
    i += 1
    pps = []
    for _ in range(n_pps):
        n = struct.unpack_from(">H", record, i)[0]
        i += 2
        pps.append(record[i : i + n])
        i += n
    return sps, pps, length_size


def is_keyframe_annexb(data: bytes) -> bool:
    return any((n[0] & 0x1F) == NAL_IDR for n in split_annexb(data) if n)
