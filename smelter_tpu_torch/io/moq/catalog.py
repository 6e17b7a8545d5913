"""Hang-style JSON catalog (reference `moq/output/catalog.rs`,
`input/connection/catalog.rs`).

The catalog is itself a track named "catalog.json" whose frames carry the
JSON document describing every rendition: codec, container (legacy / loc /
cmaf with a base64 init segment), out-of-band codec description, coded
dimensions, sample rate/channels.
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

CATALOG_TRACK = "catalog.json"
VIDEO_TRACK = "video0"   # reference client_output.rs VIDEO_TRACK_NAME
AUDIO_TRACK = "audio0"

# reference cmaf_init_segment.rs: encoder timestamps are microseconds;
# 90 kHz is the MPEG convention for video tracks
VIDEO_TIMESCALE = 90_000


@dataclass
class TrackEntry:
    name: str
    codec: str                      # "h264" | "vp8" | "vp9" | "aac" | "opus"
    container: str                  # "legacy" | "loc" | "cmaf"
    description: Optional[bytes] = None  # avcC / AudioSpecificConfig / vpcC
    init_segment: Optional[bytes] = None  # CMAF only
    timescale: Optional[int] = None
    width: Optional[int] = None
    height: Optional[int] = None
    sample_rate: Optional[int] = None
    channels: Optional[int] = None

    def to_json(self) -> dict:
        out: dict = {"codec": self.codec, "container": {"kind": self.container}}
        if self.container == "cmaf" and self.init_segment is not None:
            out["container"]["init"] = base64.b64encode(self.init_segment).decode()
            out["container"]["timescale"] = self.timescale
            out["container"]["track_id"] = 1
        if self.description is not None:
            out["description"] = base64.b64encode(self.description).decode()
        if self.width is not None:
            out["coded_width"] = self.width
            out["coded_height"] = self.height
        if self.sample_rate is not None:
            out["sample_rate"] = self.sample_rate
            out["channel_count"] = self.channels
        return out

    @classmethod
    def from_json(cls, name: str, d: dict) -> "TrackEntry":
        cont = d.get("container") or {"kind": "legacy"}
        init = cont.get("init")
        desc = d.get("description")
        return cls(
            name=name,
            codec=d.get("codec", ""),
            container=cont.get("kind", "legacy"),
            description=base64.b64decode(desc) if desc else None,
            init_segment=base64.b64decode(init) if init else None,
            timescale=cont.get("timescale"),
            width=d.get("coded_width"),
            height=d.get("coded_height"),
            sample_rate=d.get("sample_rate"),
            channels=d.get("channel_count"),
        )


@dataclass
class Catalog:
    video: Dict[str, TrackEntry] = field(default_factory=dict)
    audio: Dict[str, TrackEntry] = field(default_factory=dict)

    def to_bytes(self) -> bytes:
        doc = {
            "version": 1,
            "video": {n: e.to_json() for n, e in self.video.items()},
            "audio": {n: e.to_json() for n, e in self.audio.items()},
        }
        return json.dumps(doc).encode()

    @classmethod
    def from_bytes(cls, data: bytes) -> "Catalog":
        doc = json.loads(data.decode())
        cat = cls()
        for name, d in (doc.get("video") or {}).items():
            cat.video[name] = TrackEntry.from_json(name, d)
        for name, d in (doc.get("audio") or {}).items():
            cat.audio[name] = TrackEntry.from_json(name, d)
        return cat

    def first_video(self) -> Optional[TrackEntry]:
        """First supported video rendition (reference
        catalog.rs find_first_video is H264/VP8/VP9; AV1 is accepted
        beyond-reference — the native decoder handles it)."""
        for name in sorted(self.video):
            e = self.video[name]
            if e.codec in ("h264", "vp8", "vp9", "av1"):
                return e
        return None

    def first_audio(self) -> Optional[TrackEntry]:
        for name in sorted(self.audio):
            e = self.audio[name]
            if e.codec in ("aac", "opus"):
                return e
        return None
