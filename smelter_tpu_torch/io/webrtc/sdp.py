"""Minimal SDP offer/answer for WHIP/WHEP (BUNDLE + rtcp-mux, audio+video).

Covers what the reference negotiates (`smelter-core/src/webrtc/
negotiated_codecs.rs`): H264 (packetization-mode=1) / VP8 video, Opus audio;
answers echo the offerer's payload types.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class MediaDescription:
    kind: str                       # "audio" | "video"
    mid: str
    payload_types: List[int]
    rtpmap: Dict[int, str]          # pt -> "H264/90000"
    fmtp: Dict[int, str]
    direction: str = "sendrecv"


@dataclass
class SessionDescription:
    ice_ufrag: str = ""
    ice_pwd: str = ""
    fingerprint: str = ""           # "AB:CD:..."
    fingerprint_alg: str = "sha-256"
    setup: str = "actpass"
    ice_lite: bool = False
    media: List[MediaDescription] = field(default_factory=list)
    candidates: List[Tuple[str, int]] = field(default_factory=list)

    def find_codec(self, kind: str, names: List[str]) -> Optional[Tuple[int, str]]:
        """First offered (pt, codec_name) among `names` for a media kind."""
        for m in self.media:
            if m.kind != kind:
                continue
            for name in names:
                for pt in m.payload_types:
                    codec = m.rtpmap.get(pt, "").split("/")[0].lower()
                    if codec == name.lower():
                        return pt, codec
        return None


def parse(sdp: str) -> SessionDescription:
    desc = SessionDescription()
    current: Optional[MediaDescription] = None
    for raw in sdp.replace("\r\n", "\n").split("\n"):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("m="):
            parts = line[2:].split()
            kind = parts[0]
            pts = [int(p) for p in parts[3:] if p.isdigit()]
            current = MediaDescription(
                kind=kind, mid=str(len(desc.media)), payload_types=pts,
                rtpmap={}, fmtp={},
            )
            desc.media.append(current)
        elif line.startswith("a="):
            attr = line[2:]
            if attr.startswith("ice-ufrag:"):
                desc.ice_ufrag = attr.split(":", 1)[1]
            elif attr.startswith("ice-pwd:"):
                desc.ice_pwd = attr.split(":", 1)[1]
            elif attr == "ice-lite":
                desc.ice_lite = True
            elif attr.startswith("fingerprint:"):
                alg, fp = attr.split(":", 1)[1].split(None, 1)
                desc.fingerprint_alg = alg
                desc.fingerprint = fp.strip()
            elif attr.startswith("setup:"):
                desc.setup = attr.split(":", 1)[1]
            elif attr.startswith("mid:") and current is not None:
                current.mid = attr.split(":", 1)[1]
            elif attr.startswith("rtpmap:") and current is not None:
                body = attr.split(":", 1)[1]
                pt_str, codec = body.split(None, 1)
                current.rtpmap[int(pt_str)] = codec.strip()
            elif attr.startswith("fmtp:") and current is not None:
                body = attr.split(":", 1)[1]
                pt_str, params = body.split(None, 1)
                current.fmtp[int(pt_str)] = params.strip()
            elif attr in ("sendrecv", "sendonly", "recvonly", "inactive"):
                if current is not None:
                    current.direction = attr
            elif attr.startswith("candidate:"):
                parts = attr.split()
                if len(parts) >= 6 and parts[2].lower() == "udp":
                    cand = (parts[4], int(parts[5]))
                    if cand not in desc.candidates:
                        desc.candidates.append(cand)
    return desc


def parse_candidate_fragment(text: str) -> List[Tuple[str, int]]:
    """Candidates from a trickle-ICE SDP fragment
    (application/trickle-ice-sdpfrag, RFC 8840 — the WHIP/WHEP PATCH body;
    reference `webrtc/trickle_ice_utils.rs`). Tolerates bare
    ``candidate:`` lines as some clients send them."""
    out: List[Tuple[str, int]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("a="):
            line = line[2:]
        if not line.startswith("candidate:"):
            continue
        parts = line.split()
        if len(parts) >= 6 and parts[2].lower() == "udp":
            cand = (parts[4], int(parts[5]))
            if cand not in out:
                out.append(cand)
    return out


def _media_block(
    m: MediaDescription,
    direction: str,
    ssrc: Optional[int],
) -> List[str]:
    pts = " ".join(str(p) for p in m.payload_types)
    lines = [
        f"m={m.kind} 9 UDP/TLS/RTP/SAVPF {pts}",
        "c=IN IP4 0.0.0.0",
        f"a=mid:{m.mid}",
        "a=rtcp-mux",
        f"a={direction}",
    ]
    for pt in m.payload_types:
        if pt in m.rtpmap:
            lines.append(f"a=rtpmap:{pt} {m.rtpmap[pt]}")
        if pt in m.fmtp:
            lines.append(f"a=fmtp:{pt} {m.fmtp[pt]}")
    if ssrc is not None:
        lines.append(f"a=ssrc:{ssrc} cname:smelter-tpu")
    return lines


def build(
    ice_ufrag: str,
    ice_pwd: str,
    fingerprint: str,
    setup: str,
    media: List[MediaDescription],
    directions: List[str],
    candidate: Optional[Tuple[str, int]] = None,
    ice_lite: bool = False,
    ssrcs: Optional[List[Optional[int]]] = None,
    srflx_candidate: Optional[Tuple[str, int]] = None,
) -> str:
    sid = secrets.randbelow(1 << 62)
    mids = " ".join(m.mid for m in media)
    lines = [
        "v=0",
        f"o=- {sid} 2 IN IP4 127.0.0.1",
        "s=-",
        "t=0 0",
        f"a=group:BUNDLE {mids}",
        "a=msid-semantic: WMS smelter",
    ]
    if ice_lite:
        lines.append("a=ice-lite")
    ssrcs = ssrcs or [None] * len(media)
    for i, (m, direction) in enumerate(zip(media, directions)):
        lines += _media_block(m, direction, ssrcs[i])
        lines += [
            f"a=ice-ufrag:{ice_ufrag}",
            f"a=ice-pwd:{ice_pwd}",
            f"a=fingerprint:sha-256 {fingerprint}",
            f"a=setup:{setup}",
        ]
        if candidate is not None:
            ip, port = candidate
            lines.append(
                f"a=candidate:1 1 udp 2130706431 {ip} {port} typ host"
            )
            if srflx_candidate is not None:
                sip, sport = srflx_candidate
                lines.append(
                    f"a=candidate:2 1 udp 1694498815 {sip} {sport} "
                    f"typ srflx raddr {ip} rport {port}"
                )
            lines.append("a=end-of-candidates")
    return "\r\n".join(lines) + "\r\n"


def default_offer_media(video_codec: str = "h264") -> List[MediaDescription]:
    """Media sections for an offer our clients create (WHIP client / WHEP
    client): opus + one video codec with the conventional payload types."""
    audio = MediaDescription(
        kind="audio", mid="0", payload_types=[111],
        rtpmap={111: "opus/48000/2"}, fmtp={111: "minptime=10;useinbandfec=1"},
    )
    if video_codec == "vp8":
        video = MediaDescription(
            kind="video", mid="1", payload_types=[97],
            rtpmap={97: "VP8/90000"}, fmtp={},
        )
    elif video_codec == "vp9":
        video = MediaDescription(
            kind="video", mid="1", payload_types=[98],
            rtpmap={98: "VP9/90000"}, fmtp={98: "profile-id=0"},
        )
    elif video_codec == "av1":
        video = MediaDescription(
            kind="video", mid="1", payload_types=[99],
            rtpmap={99: "AV1/90000"}, fmtp={99: "profile=0;level-idx=0"},
        )
    else:
        video = MediaDescription(
            kind="video", mid="1", payload_types=[96],
            rtpmap={96: "H264/90000"},
            fmtp={96: "level-asymmetry-allowed=1;packetization-mode=1;"
                      "profile-level-id=42e01f"},
        )
    return [audio, video]


def new_ice_credentials() -> Tuple[str, str]:
    return secrets.token_urlsafe(6)[:8], secrets.token_urlsafe(24)[:24]
