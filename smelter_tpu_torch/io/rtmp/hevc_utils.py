"""HEVC helpers for enhanced-RTMP (hvc1 FourCC) tags.

Mirrors h264_utils for HEVC: build an HEVCDecoderConfigurationRecord
(ISO/IEC 14496-15 §8.3.3.1 "hvcC") from AnnexB parameter sets, so encoder
extradata (libx265 with global headers emits AnnexB VPS/SPS/PPS) can seed
an enhanced-RTMP SequenceStart packet, and so received hvcC records can be
fed straight to the decoder as extradata.
"""

from __future__ import annotations

import struct
from typing import Dict, List

from smelter_tpu_torch.io.rtmp.h264_utils import split_annexb

NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34


def hevc_nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F


def extract_hevc_parameter_sets(annexb: bytes) -> Dict[int, List[bytes]]:
    """{nal_type: [nals]} for VPS/SPS/PPS found in an AnnexB stream."""
    out: Dict[int, List[bytes]] = {NAL_VPS: [], NAL_SPS: [], NAL_PPS: []}
    for nal in split_annexb(annexb):
        t = hevc_nal_type(nal)
        if t in out:
            out[t].append(nal)
    return out


def build_hvcc_record(annexb_headers: bytes) -> bytes:
    """AnnexB VPS/SPS/PPS → hvcC record (4-byte NALU lengths)."""
    ps = extract_hevc_parameter_sets(annexb_headers)
    if not ps[NAL_SPS]:
        raise ValueError("no HEVC SPS in extradata")
    sps = ps[NAL_SPS][0]
    # general profile_tier_level sits at a fixed offset in the SPS:
    # 2-byte NAL header, then 1 byte (vps_id u4 + max_sub_layers u3 +
    # temporal_id_nesting u1), then the 12-byte general PTL
    ptl = sps[3:15]
    if len(ptl) < 12:
        ptl = ptl + b"\x00" * (12 - len(ptl))
    rec = bytearray()
    rec += bytes([1]) + ptl[:12]
    rec += b"\xf0\x00"          # reserved(4)=1111 + min_spatial_segmentation=0
    rec += b"\xfc"              # reserved(6) + parallelismType=0
    rec += b"\xfd"              # reserved(6) + chroma_format_idc=1 (4:2:0)
    rec += b"\xf8"              # reserved(5) + bit_depth_luma_minus8=0
    rec += b"\xf8"              # reserved(5) + bit_depth_chroma_minus8=0
    rec += b"\x00\x00"          # avgFrameRate = 0 (unspecified)
    # constantFrameRate=0, numTemporalLayers=1, temporalIdNested=1,
    # lengthSizeMinusOne=3 (4-byte lengths)
    rec += bytes([(1 << 3) | (1 << 2) | 3])
    arrays = [(t, ps[t]) for t in (NAL_VPS, NAL_SPS, NAL_PPS) if ps[t]]
    rec += bytes([len(arrays)])
    for nal_type, nals in arrays:
        rec += bytes([0x80 | nal_type])  # array_completeness=1
        rec += struct.pack(">H", len(nals))
        for nal in nals:
            rec += struct.pack(">H", len(nal)) + nal
    return bytes(rec)
