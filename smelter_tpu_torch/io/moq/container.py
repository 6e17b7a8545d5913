"""MoQ media containers: Legacy, LOC, CMAF (reference moq-mux containers +
`moq/output/cmaf_init_segment.rs`).

- legacy: 8-byte big-endian microsecond timestamp + raw codec payload
  (the API's documented format for MoqOutputContainer::Legacy)
- loc: raw codec payload (timing in the group-frame header)
- cmaf: each frame is one complete `moof`+`mdat` fragment; the init
  segment (ftyp+moov, timescale 90000 video / sample-rate audio, track 1)
  travels in the catalog

The fMP4 writer/reader below is minimal but emits well-formed segments
(the reference notes its init segments are handed to players verbatim).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from smelter_tpu_torch.io.moq.catalog import VIDEO_TIMESCALE

TRACK_ID = 1


# ---------------------------------------------------------------------------
# mp4 box helpers
# ---------------------------------------------------------------------------


def box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack("!I", 8 + len(payload)) + btype + payload


def fullbox(btype: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(btype, struct.pack("!I", (version << 24) | flags) + payload)


def walk_boxes(data: bytes, pos: int = 0, end: Optional[int] = None):
    """Yield (type, payload_start, payload_end) of top-level boxes."""
    end = len(data) if end is None else end
    while pos + 8 <= end:
        size = struct.unpack("!I", data[pos : pos + 4])[0]
        btype = data[pos + 4 : pos + 8]
        if size == 1:
            size = struct.unpack("!Q", data[pos + 8 : pos + 16])[0]
            yield btype, pos + 16, pos + size
        elif size == 0:
            yield btype, pos + 8, end
            return
        else:
            yield btype, pos + 8, pos + size
        pos += max(size, 8)


def find_box(data: bytes, path: List[bytes], pos: int = 0,
             end: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """(payload_start, payload_end) of the first box at a nested path."""
    for btype, p0, p1 in walk_boxes(data, pos, end):
        if btype == path[0]:
            if len(path) == 1:
                return p0, p1
            return find_box(data, path[1:], p0, p1)
    return None


# ---------------------------------------------------------------------------
# init segments (reference cmaf_init_segment.rs)
# ---------------------------------------------------------------------------


def _visual_sample_entry(fourcc: bytes, width: int, height: int,
                         config_box: bytes) -> bytes:
    body = (
        b"\x00" * 6 + struct.pack("!H", 1)          # reserved + data_ref_index
        + b"\x00" * 16                               # pre_defined/reserved
        + struct.pack("!HH", width, height)
        + struct.pack("!II", 0x00480000, 0x00480000)  # 72 dpi
        + b"\x00" * 4
        + struct.pack("!H", 1)                       # frame_count
        + b"\x00" * 32                               # compressorname
        + struct.pack("!Hh", 0x0018, -1)             # depth, pre_defined
        + config_box
    )
    return box(fourcc, body)


def _audio_sample_entry(fourcc: bytes, sample_rate: int, channels: int,
                        config_box: bytes) -> bytes:
    body = (
        b"\x00" * 6 + struct.pack("!H", 1)
        + b"\x00" * 8
        + struct.pack("!HH", channels, 16)
        + b"\x00" * 4
        + struct.pack("!I", sample_rate << 16)
        + config_box
    )
    return box(fourcc, body)


def _esds(asc: bytes) -> bytes:
    """MP4 elementary stream descriptor wrapping an AudioSpecificConfig."""
    def desc(tag: int, payload: bytes) -> bytes:
        # 4-byte expandable length like FFmpeg emits
        ln = len(payload)
        size = bytes([0x80, 0x80, 0x80, ln & 0x7F])
        return bytes([tag]) + size + payload

    dec_specific = desc(0x05, asc)
    dec_config = desc(
        0x04,
        bytes([0x40, 0x15]) + b"\x00\x00\x00" + struct.pack("!II", 0, 0)
        + dec_specific,
    )
    sl = desc(0x06, b"\x02")
    es = desc(0x03, struct.pack("!HB", TRACK_ID, 0) + dec_config + sl)
    return fullbox(b"esds", 0, 0, es)


def _stbl(sample_entry: bytes) -> bytes:
    stsd = fullbox(b"stsd", 0, 0, struct.pack("!I", 1) + sample_entry)
    stts = fullbox(b"stts", 0, 0, struct.pack("!I", 0))
    stsc = fullbox(b"stsc", 0, 0, struct.pack("!I", 0))
    stsz = fullbox(b"stsz", 0, 0, struct.pack("!II", 0, 0))
    stco = fullbox(b"stco", 0, 0, struct.pack("!I", 0))
    return box(b"stbl", stsd + stts + stsc + stsz + stco)


def _minf(is_video: bool, stbl: bytes) -> bytes:
    if is_video:
        mhd = fullbox(b"vmhd", 0, 1, b"\x00" * 8)
    else:
        mhd = fullbox(b"smhd", 0, 0, b"\x00" * 4)
    url = fullbox(b"url ", 0, 1, b"")
    dref = fullbox(b"dref", 0, 0, struct.pack("!I", 1) + url)
    dinf = box(b"dinf", dref)
    return box(b"minf", mhd + dinf + stbl)


def _trak(is_video: bool, timescale: int, width: int, height: int,
          sample_entry: bytes) -> bytes:
    tkhd = fullbox(
        b"tkhd", 0, 7,
        struct.pack("!IIII", 0, 0, TRACK_ID, 0)
        + struct.pack("!I", 0)
        + b"\x00" * 8
        + struct.pack("!HHHH", 0, 0, 0x0100 if not is_video else 0, 0)
        + struct.pack("!9I", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                      0x40000000)
        + struct.pack("!II", width << 16, height << 16),
    )
    mdhd = fullbox(
        b"mdhd", 0, 0,
        struct.pack("!IIII", 0, 0, timescale, 0) + struct.pack("!HH", 0x55C4, 0),
    )
    handler = b"vide" if is_video else b"soun"
    hdlr = fullbox(b"hdlr", 0, 0,
                   b"\x00" * 4 + handler + b"\x00" * 12 + b"smelter\x00")
    mdia = box(b"mdia", mdhd + hdlr + _minf(is_video, _stbl(sample_entry)))
    return box(b"trak", tkhd + mdia)


def build_init_segment(is_video: bool, codec: str, timescale: int,
                       description: Optional[bytes],
                       width: int = 0, height: int = 0,
                       sample_rate: int = 48000, channels: int = 2) -> bytes:
    """ftyp+moov for one track (reference cmaf_init_segment.rs builders)."""
    if is_video:
        if codec == "h264":
            if not description:
                raise ValueError("h264 CMAF needs an avcC record")
            cfg = box(b"avcC", description)
            entry = _visual_sample_entry(b"avc1", width, height, cfg)
        elif codec in ("vp8", "vp9"):
            from smelter_tpu_torch.io.rtmp.session import build_vpcc_record

            vpcc = fullbox(b"vpcC", 1, 0, (description or build_vpcc_record())[4:]
                           if description and len(description) > 4
                           else build_vpcc_record()[4:])
            fourcc = b"vp09" if codec == "vp9" else b"vp08"
            entry = _visual_sample_entry(fourcc, width, height, vpcc)
        elif codec == "av1":
            # AV1CodecConfigurationBox: marker|version=0x81, profile/level,
            # 4:2:0 flags, no presentation delay, + optional sequence
            # header OBU as configOBUs (decoders also read it in-band)
            av1c = box(b"av1C", bytes([0x81, 0x00, 0x0C, 0x00])
                       + (description or b""))
            entry = _visual_sample_entry(b"av01", width, height, av1c)
        else:
            raise ValueError(f"unsupported CMAF video codec {codec}")
    else:
        if codec == "aac":
            if not description:
                raise ValueError("aac CMAF needs an AudioSpecificConfig")
            entry = _audio_sample_entry(b"mp4a", sample_rate, channels,
                                        _esds(description))
        elif codec == "opus":
            # dOps: version, channels, pre-skip, input rate, gain, mapping 0
            dops = box(b"dOps", bytes([0, channels]) + struct.pack("!H", 312)
                       + struct.pack("!I", sample_rate) + b"\x00\x00\x00")
            entry = _audio_sample_entry(b"Opus", sample_rate, channels, dops)
        else:
            raise ValueError(f"unsupported CMAF audio codec {codec}")

    ftyp = box(b"ftyp", b"iso5" + struct.pack("!I", 512)
               + b"iso5" + b"iso6" + b"mp41" + b"cmfc")
    mvhd = fullbox(
        b"mvhd", 0, 0,
        struct.pack("!IIII", 0, 0, 1000, 0)
        + struct.pack("!IH", 0x00010000, 0x0100) + b"\x00" * 10
        + struct.pack("!9I", 0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0,
                      0x40000000)
        + b"\x00" * 24
        + struct.pack("!I", TRACK_ID + 1),
    )
    trex = fullbox(b"trex", 0, 0,
                   struct.pack("!IIIII", TRACK_ID, 1, 0, 0, 0))
    mvex = box(b"mvex", trex)
    moov = box(b"moov", mvhd + _trak(is_video, timescale, width, height, entry)
               + mvex)
    return ftyp + moov


def parse_init_segment(init: bytes) -> Tuple[int, Optional[bytes], str]:
    """-> (timescale, codec description, codec fourcc). The reference's
    fmp4::Wire reads back mdhd.timescale, tkhd.track_id and stsd
    (catalog.rs extract_codec_description)."""
    mdhd = find_box(init, [b"moov", b"trak", b"mdia", b"mdhd"])
    timescale = VIDEO_TIMESCALE
    if mdhd is not None:
        p0, _ = mdhd
        version = init[p0]
        timescale = struct.unpack(
            "!I", init[p0 + 4 + (16 if version == 1 else 8) :][:4]
        )[0]
    stsd = find_box(init, [b"moov", b"trak", b"mdia", b"minf", b"stbl", b"stsd"])
    desc: Optional[bytes] = None
    fourcc = ""
    if stsd is not None:
        p0, p1 = stsd
        entry_start = p0 + 8  # fullbox header + entry count
        for btype, e0, e1 in walk_boxes(init, entry_start, p1):
            fourcc = btype.decode(errors="replace")
            if btype == b"avc1":
                got = find_box(init, [b"avcC"], e0 + 78, e1)
                if got:
                    desc = init[got[0] : got[1]]
            elif btype in (b"vp09", b"vp08"):
                got = find_box(init, [b"vpcC"], e0 + 78, e1)
                if got:
                    desc = init[got[0] : got[1]]
            elif btype == b"av01":
                got = find_box(init, [b"av1C"], e0 + 78, e1)
                if got:
                    # configOBUs after the 4 fixed av1C bytes
                    desc = init[got[0] + 4 : got[1]] or None
            elif btype == b"mp4a":
                got = find_box(init, [b"esds"], e0 + 28, e1)
                if got:
                    desc = _extract_asc(init[got[0] : got[1]])
            break
    return timescale, desc, fourcc


def _extract_asc(esds_payload: bytes) -> Optional[bytes]:
    """AudioSpecificConfig out of an esds fullbox payload."""
    data = esds_payload[4:]  # skip version/flags
    pos = 0

    def read_desc(p: int) -> Tuple[int, int, int]:
        tag = data[p]
        p += 1
        size = 0
        for _ in range(4):
            b = data[p]
            p += 1
            size = (size << 7) | (b & 0x7F)
            if not (b & 0x80):
                break
        return tag, size, p

    while pos < len(data):
        tag, size, body = read_desc(pos)
        if tag == 0x03:  # ES descriptor: skip es_id(2)+flags(1)
            pos = body + 3
        elif tag == 0x04:  # DecoderConfig: skip 13 bytes of config
            pos = body + 13
        elif tag == 0x05:  # DecoderSpecificInfo = the ASC
            return data[body : body + size]
        else:
            pos = body + size
    return None


# ---------------------------------------------------------------------------
# fragments
# ---------------------------------------------------------------------------


def build_fragment(seq: int, timescale_time: int, payload: bytes,
                   keyframe: bool, duration: int = 0) -> bytes:
    """One moof+mdat CMAF fragment carrying a single sample."""
    mfhd = fullbox(b"mfhd", 0, 0, struct.pack("!I", seq))
    # tfhd: default-base-is-moof | default-sample-duration
    tfhd = fullbox(b"tfhd", 0, 0x020008,
                   struct.pack("!II", TRACK_ID, max(duration, 1)))
    tfdt = fullbox(b"tfdt", 1, 0, struct.pack("!Q", timescale_time))
    # trun: data-offset | sample-size | sample-flags
    sample_flags = 0x02000000 if keyframe else 0x01010000
    trun_payload = struct.pack("!I", 1)  # sample count
    # data offset placeholder patched below
    trun = fullbox(b"trun", 0, 0x000305,
                   trun_payload + struct.pack("!iII", 0, len(payload),
                                              sample_flags))
    traf = box(b"traf", tfhd + tfdt + trun)
    moof = box(b"moof", mfhd + traf)
    # patch the trun data offset: mdat payload starts at len(moof)+8
    data_offset = len(moof) + 8
    idx = moof.rfind(b"trun")
    # trun payload: 4 fullbox + 4 count, then 4-byte data offset
    moof = moof[: idx + 12] + struct.pack("!i", data_offset) + moof[idx + 16 :]
    return moof + box(b"mdat", payload)


def parse_fragment(data: bytes) -> Optional[Tuple[int, bytes, bool]]:
    """moof+mdat -> (timescale_time, payload, keyframe)."""
    tfdt = find_box(data, [b"moof", b"traf", b"tfdt"])
    mdat = find_box(data, [b"mdat"])
    if tfdt is None or mdat is None:
        return None
    p0, _ = tfdt
    version = data[p0]
    if version == 1:
        t = struct.unpack("!Q", data[p0 + 4 : p0 + 12])[0]
    else:
        t = struct.unpack("!I", data[p0 + 4 : p0 + 8])[0]
    keyframe = True
    trun = find_box(data, [b"moof", b"traf", b"trun"])
    if trun is not None:
        q0, q1 = trun
        flags = struct.unpack("!I", data[q0 : q0 + 4])[0] & 0xFFFFFF
        pos = q0 + 8
        if flags & 0x01:
            pos += 4
        if flags & 0x04:
            pos += 4
        # first-sample or per-sample flags
        if flags & 0x04 or flags & 0x400:
            pass
        if flags & 0x100:
            pos += 0
        # per-sample fields: duration(0x100) size(0x200) flags(0x400) cts(0x800)
        sflags = None
        spos = pos
        if flags & 0x100:
            spos += 4
        if flags & 0x200:
            spos += 4
        if flags & 0x400:
            sflags = struct.unpack("!I", data[spos : spos + 4])[0]
        if sflags is not None:
            keyframe = not (sflags & 0x01010000)
    return t, data[mdat[0] : mdat[1]], keyframe


# ---------------------------------------------------------------------------
# container codecs (payload <-> wire frame payload)
# ---------------------------------------------------------------------------


@dataclass
class ContainerWriter:
    kind: str               # legacy | loc | cmaf
    timescale: int = VIDEO_TIMESCALE
    _seq: int = 0

    def pack(self, timestamp_us: int, payload: bytes, keyframe: bool) -> bytes:
        if self.kind == "legacy":
            return struct.pack("!Q", timestamp_us) + payload
        if self.kind == "loc":
            return payload
        self._seq += 1
        t = timestamp_us * self.timescale // 1_000_000
        return build_fragment(self._seq, t, payload, keyframe)


@dataclass
class ContainerReader:
    kind: str
    timescale: int = VIDEO_TIMESCALE

    def unpack(self, frame_ts_us: int, data: bytes) -> Tuple[int, bytes]:
        """-> (timestamp_us, payload)."""
        if self.kind == "legacy":
            if len(data) < 8:
                return frame_ts_us, data
            ts = struct.unpack("!Q", data[:8])[0]
            return ts, data[8:]
        if self.kind == "loc":
            return frame_ts_us, data
        parsed = parse_fragment(data)
        if parsed is None:
            return frame_ts_us, data
        t, payload, _key = parsed
        return t * 1_000_000 // self.timescale, payload
