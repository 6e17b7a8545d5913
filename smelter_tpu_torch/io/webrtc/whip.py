"""WHIP/WHEP endpoints and peers (reference `smelter-core/src/webrtc/`).

Four roles, same as the reference:
  - WHIP server input  (`whip_input/`):  POST /whip/:id  — publisher sends us
    media; we answer recvonly, ICE-lite, DTLS passive
  - WHEP server output (`whep_output/`): POST /whep/:id  — subscriber pulls
    our output; we answer sendonly
  - WHIP client output (`whip_output/`): we POST an offer to an external
    WHIP endpoint and publish (sendonly, ICE full, DTLS active)
  - WHEP client input  (`whep_input/`):  we POST an offer and receive

Media: H264/VP8/VP9 + Opus; payload types follow the offer. Trickle-ICE
PATCH candidates feed the live session (reference trickle_ice_utils.rs);
DELETE tears the session down. Receive sides send Generic NACKs for gaps
and send sides answer them from a retransmit cache; client roles gather a
server-reflexive candidate when SMELTER_WEBRTC_STUN_SERVERS is set.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Optional


from smelter_tpu_torch.io.rtp import (
    Av1Depayloader,
    Av1Payloader,
    H264Depayloader,
    H264Payloader,
    Vp8Payloader,
    Vp9Payloader,
    JitterBuffer,
    OpusDepayloader,
    OpusPayloader,
    RtpPacket,
    Vp8Depayloader,
    Vp9Depayloader,
    run_audio_decode,
    run_video_decode,
    _has_sps,
)
from smelter_tpu_torch.io.webrtc import sdp as sdp_mod
from smelter_tpu_torch.io.webrtc.session import WebRtcSession
from smelter_tpu_torch.pipeline.input import InputCtx, InputSource
from smelter_tpu_torch.pipeline.output import OutputSink
from smelter_tpu_torch.utils.channels import Channel, Closed

logger = logging.getLogger("smelter.whip")


@dataclass
class NegotiatedMedia:
    video_pt: Optional[int]
    video_codec: Optional[str]   # "h264" | "vp8" | "vp9" | "av1"
    audio_pt: Optional[int]      # opus


def negotiate(offer: sdp_mod.SessionDescription,
              video_codecs: Optional[list] = None) -> NegotiatedMedia:
    """Codec selection in the reference's preference order
    (`webrtc/negotiated_codecs.rs` / `offer_codec_filter.rs`): H264 first,
    then VP8, then VP9; AV1 accepted beyond-reference (av1-rtp-spec
    payloaders in io/rtp.py). `video_codecs` restricts AND orders the
    candidates (the wire `decoder_preferences` filter)."""
    video = offer.find_codec(
        "video", video_codecs or ["h264", "vp8", "vp9", "av1"]
    )
    audio = offer.find_codec("audio", ["opus"])
    return NegotiatedMedia(
        video_pt=video[0] if video else None,
        video_codec=video[1] if video else None,
        audio_pt=audio[0] if audio else None,
    )


def _answer_media(offer: sdp_mod.SessionDescription, neg: NegotiatedMedia):
    """Answer media sections echoing the chosen payload types."""
    out = []
    dirs = []
    for m in offer.media:
        if m.kind == "audio" and neg.audio_pt is not None:
            out.append(sdp_mod.MediaDescription(
                kind="audio", mid=m.mid, payload_types=[neg.audio_pt],
                rtpmap={neg.audio_pt: m.rtpmap.get(neg.audio_pt, "opus/48000/2")},
                fmtp={k: v for k, v in m.fmtp.items() if k == neg.audio_pt},
            ))
        elif m.kind == "video" and neg.video_pt is not None:
            out.append(sdp_mod.MediaDescription(
                kind="video", mid=m.mid, payload_types=[neg.video_pt],
                rtpmap={neg.video_pt: m.rtpmap.get(neg.video_pt, "H264/90000")},
                fmtp={k: v for k, v in m.fmtp.items() if k == neg.video_pt},
            ))
        else:
            continue
        dirs.append(m.direction)
    return out, dirs


def _flip(direction: str) -> str:
    return {"sendonly": "recvonly", "recvonly": "sendonly"}.get(direction, direction)


def _maybe_gather_srflx(session: WebRtcSession):
    """Server-reflexive candidate when STUN servers are configured
    (SMELTER_WEBRTC_STUN_SERVERS / SMELTER_STUN_SERVERS — reference
    config.rs:269-281). Skipped when unset so LAN/test setups pay no
    STUN round-trip at offer time."""
    import os

    if not (os.environ.get("SMELTER_WEBRTC_STUN_SERVERS")
            or os.environ.get("SMELTER_STUN_SERVERS")):
        return None
    return session.gather_srflx()


# ---------------------------------------------------------------------------
# media plumbing
# ---------------------------------------------------------------------------


class _RtpReceiverBridge:
    """session.on_rtp → jitter buffers → depayloaders → decode threads."""

    def __init__(self, session: WebRtcSession, ctx: InputCtx,
                 neg: NegotiatedMedia,
                 jitter_window_s: Optional[float] = None) -> None:
        self.session = session
        self.neg = neg
        self.video_aus: Optional[Channel] = (
            Channel(64) if neg.video_pt is not None and ctx.video_channel else None
        )
        self.audio_aus: Optional[Channel] = (
            Channel(512) if neg.audio_pt is not None and ctx.audio_channel else None
        )
        # wire `buffer_size_ms` (reference whip.rs buffer_size_ms): minimum
        # jitter buffer depth; adaptive mode still grows it under jitter
        win = jitter_window_s if jitter_window_s is not None else 0.05
        self._vjb = JitterBuffer(win, stats=ctx.video_meter)
        self._ajb = JitterBuffer(win, stats=ctx.audio_meter)
        from smelter_tpu_torch.io import rtcp as rtcp_mod

        # cross-track A/V alignment from the publisher's SRs (reference
        # rtcp_sync.rs — browsers send SRs on both tracks)
        self._sync = rtcp_mod.RtcpSyncState()
        self._vslew = rtcp_mod.TrackSyncSlew()
        self._aslew = rtcp_mod.TrackSyncSlew()
        # reception stats -> RTCP Receiver Reports (RFC 3550 §6.4; the
        # feedback loop publishers use for loss/RTT estimation)
        import time as _time

        self._trackers = {}
        # first RR after a short warmup (stats need a few packets), then
        # standard ~1/s pacing — short AOT sessions still get feedback
        self._last_rr = _time.monotonic() - (self._RR_INTERVAL_S - self._RR_FIRST_S)
        self._vd = {
            "h264": H264Depayloader,
            "vp8": Vp8Depayloader,
            "vp9": Vp9Depayloader,
            "av1": Av1Depayloader,
        }.get(neg.video_codec or "h264", H264Depayloader)()
        self._last_nack = 0.0
        self._ad = OpusDepayloader()
        self._threads = []
        if self.video_aus is not None:
            t = threading.Thread(
                target=run_video_decode,
                args=(self.video_aus, ctx, neg.video_codec or "h264"),
                daemon=True, name="whip-vdec",
            )
            t.start()
            self._threads.append(t)
        if self.audio_aus is not None:
            t = threading.Thread(
                target=run_audio_decode, args=(self.audio_aus, ctx),
                daemon=True, name="whip-adec",
            )
            t.start()
            self._threads.append(t)
        session.on_rtp = self._on_rtp
        session.on_rtcp = self._on_rtcp_in

    def _on_rtcp_in(self, data: bytes) -> None:
        from smelter_tpu_torch.io import rtcp as rtcp_mod

        for item in rtcp_mod.parse_compound(data):
            if isinstance(item, rtcp_mod.SenderReport):
                self._sync.on_sender_report(item)
                tracker = self._trackers.get(item.ssrc)
                if tracker is not None:
                    tracker.on_sender_report(item)

    def _on_rtp(self, data: bytes) -> None:
        from smelter_tpu_torch.io.rtp import OPUS_CLOCK, VIDEO_CLOCK, AccessUnit

        pkt = RtpPacket.parse(data)
        if pkt is None:
            return
        if pkt.payload_type == self.neg.video_pt and self.video_aus is not None:
            for ordered in self._vjb.push(pkt):
                for au in self._vd.push(ordered):
                    first = getattr(self._vd, "_first_ts", None)
                    if first is not None:
                        delta = self._sync.track_delta(pkt.ssrc, first, VIDEO_CLOCK)
                        if delta is not None:
                            self._vslew.set_target(delta)
                    au = AccessUnit(au.data, self._vslew.apply(au.pts_s),
                                    au.is_keyframe)
                    try:
                        self.video_aus.send(au)
                    except Closed:
                        pass
            self._track_reception(pkt, VIDEO_CLOCK)
            self._maybe_nack(pkt.ssrc)
        elif pkt.payload_type == self.neg.audio_pt and self.audio_aus is not None:
            for ordered in self._ajb.push(pkt):
                for au in self._ad.push(ordered):
                    first = getattr(self._ad, "_first_ts", None)
                    if first is not None:
                        delta = self._sync.track_delta(pkt.ssrc, first, OPUS_CLOCK)
                        if delta is not None:
                            self._aslew.set_target(delta)
                    au = AccessUnit(au.data, self._aslew.apply(au.pts_s),
                                    au.is_keyframe)
                    try:
                        self.audio_aus.send(au)
                    except Closed:
                        pass
            self._track_reception(pkt, OPUS_CLOCK)

    # standard RTCP report pacing (RFC 3550 recommends ~5 s minimum for
    # multiparty; WebRTC stacks report about once per second). The first
    # report goes out after a short warmup so short sessions get feedback.
    _RR_INTERVAL_S = 1.0
    _RR_FIRST_S = 0.25

    def _track_reception(self, pkt, clock_rate: int) -> None:
        from smelter_tpu_torch.io import rtcp as rtcp_mod

        tracker = self._trackers.get(pkt.ssrc)
        if tracker is None:
            tracker = rtcp_mod.ReceptionTracker(pkt.ssrc, clock_rate)
            self._trackers[pkt.ssrc] = tracker
        tracker.on_packet(pkt.sequence_number, pkt.timestamp)
        import time as _time

        now = _time.monotonic()
        if now - self._last_rr < self._RR_INTERVAL_S or not self._trackers:
            return
        self._last_rr = now
        rr = rtcp_mod.ReceiverReport(
            ssrc=0x534D4C54,
            reports=[t.report_block() for t in self._trackers.values()],
        )
        try:
            self.session.send_rtcp(rtcp_mod.build_receiver_report(rr))
        except Exception:
            logger.debug("RR send failed", exc_info=True)

    # at most one NACK burst per 20 ms (standard libwebrtc pacing)
    _NACK_INTERVAL_S = 0.020

    def _maybe_nack(self, media_ssrc: int) -> None:
        """Request retransmission of missing video packets (RFC 4585
        Generic NACK — reference webrtc NACK/RTX receive hardening)."""
        import time as _time

        now = _time.monotonic()
        if now - self._last_nack < self._NACK_INTERVAL_S:
            return
        lost = self._vjb.nack_candidates()
        if not lost:
            return
        self._last_nack = now
        from smelter_tpu_torch.io import rtcp as rtcp_mod

        try:
            self.session.send_rtcp(
                rtcp_mod.build_nack(0x534D4C54, media_ssrc, lost)
            )
        except Exception:
            logger.debug("NACK send failed", exc_info=True)

    def close(self) -> None:
        for ch in (self.video_aus, self.audio_aus):
            if ch is not None:
                ch.close()


# ---------------------------------------------------------------------------
# input sources
# ---------------------------------------------------------------------------


class WhipServerInput(InputSource):
    """Input registered via the API; media arrives when a publisher POSTs an
    offer to /whip/:id (reference `whip_input/`). `handle_offer` is called by
    the HTTP layer."""

    def __init__(self, bearer_token: Optional[str] = None,
                 jitter_window_s: Optional[float] = None,
                 video_codecs: Optional[list] = None) -> None:
        self.bearer_token = bearer_token
        self.jitter_window_s = jitter_window_s
        self.video_codecs = video_codecs  # wire decoder_preferences order
        self.ctx: Optional[InputCtx] = None
        self.session: Optional[WebRtcSession] = None
        self._bridge: Optional[_RtpReceiverBridge] = None

    def start(self, ctx: InputCtx) -> None:
        self.ctx = ctx

    def stop(self) -> None:
        self.disconnect()

    def handle_offer(self, offer_sdp: str) -> str:
        """Publisher's SDP offer → our answer."""
        if self.ctx is None:
            raise RuntimeError("input not registered")
        if self.session is not None:
            self.disconnect()
        offer = sdp_mod.parse(offer_sdp)
        neg = negotiate(offer, video_codecs=self.video_codecs)
        if neg.video_pt is None and neg.audio_pt is None:
            raise ValueError("no supported codecs in offer (need H264/VP8/Opus)")
        session = WebRtcSession(is_offerer=False)
        session.set_remote(offer)
        media, offer_dirs = _answer_media(offer, neg)
        answer = sdp_mod.build(
            session.local_ufrag,
            session.local_pwd,
            session.fingerprint(),
            setup="passive",
            media=media,
            directions=[_flip(d) for d in offer_dirs],
            candidate=session.candidate,
            ice_lite=True,
        )
        self._bridge = _RtpReceiverBridge(
            session, self.ctx, neg, jitter_window_s=self.jitter_window_s
        )
        session.start()
        self.session = session
        return answer

    def disconnect(self) -> None:
        if self._bridge is not None:
            self._bridge.close()
            self._bridge = None
        if self.session is not None:
            self.session.close()
            self.session = None


class WhepClientInput(InputSource):
    """Input that subscribes to an external WHEP endpoint
    (reference `whep_input/`): we offer recvonly, DTLS active."""

    def __init__(self, endpoint_url: str, bearer_token: Optional[str] = None,
                 video_codec: str = "h264",
                 jitter_window_s: Optional[float] = None) -> None:
        self.endpoint_url = endpoint_url
        self.bearer_token = bearer_token
        self.video_codec = video_codec
        self.jitter_window_s = jitter_window_s
        self.session: Optional[WebRtcSession] = None
        self._bridge = None

    def start(self, ctx: InputCtx) -> None:
        import httpx

        session = WebRtcSession(is_offerer=True)
        media = sdp_mod.default_offer_media(self.video_codec)
        offer = sdp_mod.build(
            session.local_ufrag, session.local_pwd, session.fingerprint(),
            setup="actpass", media=media,
            directions=["recvonly", "recvonly"],
            candidate=session.candidate,
            srflx_candidate=_maybe_gather_srflx(session),
        )
        headers = {"Content-Type": "application/sdp"}
        if self.bearer_token:
            headers["Authorization"] = f"Bearer {self.bearer_token}"
        resp = httpx.post(self.endpoint_url, content=offer, headers=headers,
                          timeout=15)
        if resp.status_code not in (200, 201):
            raise RuntimeError(f"WHEP endpoint returned {resp.status_code}")
        answer = sdp_mod.parse(resp.text)
        session.set_remote(answer)
        neg = negotiate(sdp_mod.parse(offer))
        self._bridge = _RtpReceiverBridge(
            session, ctx, neg, jitter_window_s=self.jitter_window_s
        )
        session.start()
        self.session = session

    def stop(self) -> None:
        if self._bridge is not None:
            self._bridge.close()
        if self.session is not None:
            self.session.close()


# ---------------------------------------------------------------------------
# output sinks
# ---------------------------------------------------------------------------


class _RtpSenderBridge(OutputSink):
    """Encoded packets → payloaders → session.send_rtp. Base for WHIP client
    and WHEP server outputs. Video encoder should keep parameter sets inline
    (global_header=0)."""

    def __init__(self) -> None:
        self.session: Optional[WebRtcSession] = None
        self.video_pt = 96
        self.audio_pt = 111
        self.video_codec = "h264"
        self.on_keyframe_request = None  # set by the pipeline
        self._vp: Optional[H264Payloader] = None
        self._ap: Optional[OpusPayloader] = None
        self._video_extradata = b""
        self._lock = threading.Lock()
        # receiver feedback (RFC 3550 RRs), surfaced in /stats
        self.last_rtt_s: Optional[float] = None
        self.remote_fraction_lost: Optional[float] = None
        self.remote_jitter: Optional[int] = None

    @property
    def is_connected(self) -> bool:
        """True while a transport is attached and DTLS-established
        (reference WhipOutputStatsReport.is_connected)."""
        s = self.session
        return bool(s is not None and s.established.is_set())

    @property
    def connected_peers(self) -> int:
        """Subscriber count (reference WhepOutputStatsReport.connected_peers;
        this implementation is single-subscriber)."""
        return 1 if self.is_connected else 0

    # retransmission cache depth (seq ring; ~0.5-2 s of video at typical
    # packet rates — matches libwebrtc's history sizing order of magnitude)
    RETRANSMIT_CACHE = 512

    def attach(self, session: WebRtcSession, video_pt: int, audio_pt: int) -> None:
        from smelter_tpu_torch.io import rtcp as rtcp_mod

        def on_rtcp(data: bytes) -> None:
            for item in rtcp_mod.parse_compound(data):
                if isinstance(item, rtcp_mod.Pli) and self.on_keyframe_request:
                    self.on_keyframe_request()
                elif isinstance(item, rtcp_mod.Nack):
                    self._retransmit(item.lost_seqs)
                elif isinstance(item, rtcp_mod.ReceiverReport):
                    # receiver feedback -> sender-side RTT + remote loss
                    # (RFC 3550 §6.4.1 LSR/DLSR; surfaces in /stats)
                    for block in item.reports:
                        rtt = rtcp_mod.rtt_from_report(block)
                        if rtt is not None:
                            self.last_rtt_s = rtt
                        self.remote_fraction_lost = block.fraction_lost / 256.0
                        self.remote_jitter = block.jitter

        session.on_rtcp = on_rtcp
        with self._lock:
            self.session = session
            self.video_pt = video_pt
            self.audio_pt = audio_pt
            payloader = {
                "vp8": Vp8Payloader,
                "vp9": Vp9Payloader,
                "av1": Av1Payloader,
            }.get(self.video_codec, H264Payloader)
            self._vp = payloader(ssrc=0x574950, payload_type=video_pt, mtu=1200)
            self._ap = OpusPayloader(ssrc=0x574941, payload_type=audio_pt)
            self._sent_cache: dict = {}

    def _retransmit(self, lost_seqs) -> None:
        """Answer a Generic NACK by resending cached packets verbatim
        (plain retransmission; RTX ssrc-multiplexing is not negotiated)."""
        with self._lock:
            session = self.session
            cache = getattr(self, "_sent_cache", None)
        if session is None or not cache:
            return
        for seq in lost_seqs:
            data = cache.get(seq & 0xFFFF)
            if data is not None:
                session.send_rtp(data)

    def detach(self) -> None:
        with self._lock:
            if self.session is not None:
                self.session.close()
            self.session = None

    # -- OutputSink ----------------------------------------------------------

    def setup_video(self, opts, extradata, fps_num, fps_den) -> None:
        self._video_extradata = extradata

    def setup_audio(self, opts, extradata) -> None:
        pass

    def write_video_packet(self, pkt) -> None:
        with self._lock:
            session, vp = self.session, self._vp
        if session is None or vp is None or not session.established.is_set():
            return
        data = pkt.data
        if (pkt.is_keyframe and self._video_extradata
                and self.video_codec == "h264" and not _has_sps(data)):
            data = self._video_extradata + data
        for rtp_pkt in vp.payload(data, pkt.pts_s or 0.0):
            wire = rtp_pkt.serialize()
            # NACK retransmit cache (bounded ring by 16-bit seq)
            cache = self._sent_cache
            cache[rtp_pkt.sequence_number & 0xFFFF] = wire
            if len(cache) > self.RETRANSMIT_CACHE:
                cache.pop(next(iter(cache)))
            session.send_rtp(wire)

    def write_audio_packet(self, pkt) -> None:
        with self._lock:
            session, ap = self.session, self._ap
        if session is None or ap is None or not session.established.is_set():
            return
        for rtp_pkt in ap.payload(pkt.data, pkt.pts_s or 0.0):
            session.send_rtp(rtp_pkt.serialize())

    def on_done(self) -> None:
        self.detach()


class WhepServerOutput(_RtpSenderBridge):
    """Output whose media is pulled by WHEP subscribers POSTing offers to
    /whep/:id (reference `whep_output/`). Single-subscriber for now.

    The media codec is fixed by the REGISTERED encoder (we can't transcode
    per subscriber), so negotiation must find THAT codec in the
    subscriber's offer — not the generic preference order (an h264-first
    pick against a vp8 encoder would mislabel every packet)."""

    def __init__(self, bearer_token: Optional[str] = None,
                 video_codec: str = "h264") -> None:
        super().__init__()
        self.bearer_token = bearer_token
        self.video_codec = video_codec

    def handle_offer(self, offer_sdp: str) -> str:
        offer = sdp_mod.parse(offer_sdp)
        video = offer.find_codec("video", [self.video_codec])
        audio = offer.find_codec("audio", ["opus"])
        if video is None and audio is None:
            raise ValueError(
                f"offer includes neither {self.video_codec} video nor opus "
                "audio (this output's encoders)"
            )
        neg = NegotiatedMedia(
            video_pt=video[0] if video else None,
            video_codec=video[1] if video else None,
            audio_pt=audio[0] if audio else None,
        )
        session = WebRtcSession(is_offerer=False)
        session.set_remote(offer)
        media, offer_dirs = _answer_media(offer, neg)
        answer = sdp_mod.build(
            session.local_ufrag, session.local_pwd, session.fingerprint(),
            setup="passive", media=media,
            directions=[_flip(d) for d in offer_dirs],
            candidate=session.candidate,
            ice_lite=True,
        )
        self.attach(session, neg.video_pt or 96, neg.audio_pt or 111)
        session.start()
        return answer


class WhipClientOutput(_RtpSenderBridge):
    """Output publishing to an external WHIP endpoint
    (reference `whip_output/`): we offer sendonly, DTLS active."""

    def __init__(self, endpoint_url: str, bearer_token: Optional[str] = None,
                 video_codec: str = "h264") -> None:
        super().__init__()
        self.video_codec = video_codec
        import httpx

        session = WebRtcSession(is_offerer=True)
        media = sdp_mod.default_offer_media(video_codec)
        offer = sdp_mod.build(
            session.local_ufrag, session.local_pwd, session.fingerprint(),
            setup="actpass", media=media,
            directions=["sendonly", "sendonly"],
            candidate=session.candidate,
            srflx_candidate=_maybe_gather_srflx(session),
        )
        headers = {"Content-Type": "application/sdp"}
        if bearer_token:
            headers["Authorization"] = f"Bearer {bearer_token}"
        resp = httpx.post(endpoint_url, content=offer, headers=headers, timeout=15)
        if resp.status_code not in (200, 201):
            raise RuntimeError(f"WHIP endpoint returned {resp.status_code}")
        answer = sdp_mod.parse(resp.text)
        session.set_remote(answer)
        # session resource for teardown (WHIP DELETE)
        loc = resp.headers.get("Location")
        if loc:
            import urllib.parse as _up

            self._session_url = _up.urljoin(endpoint_url, loc)
        else:
            self._session_url = None
        self._headers = headers
        # payload types follow the answer's rtpmap (falling back to the
        # conventional defaults when the answer omits one)
        audio_pt = 111
        video_pt = {"vp8": 97, "vp9": 98, "av1": 99}.get(video_codec, 96)
        vid = answer.find_codec("video", [video_codec])
        if vid:
            video_pt = vid[0]
        aud = answer.find_codec("audio", ["opus"])
        if aud:
            audio_pt = aud[0]
        self.attach(session, video_pt, audio_pt)
        session.start()
        # wait for the transport before encoded frames start flowing
        if not session.established.is_set():
            session.established.wait(timeout=15)
        if not session.established.is_set():
            raise RuntimeError("WHIP DTLS transport did not establish")

    def on_done(self) -> None:
        # WHIP teardown: DELETE the session resource so the server side
        # closes the input (EOS for its end conditions)
        if getattr(self, "_session_url", None):
            import httpx

            try:
                httpx.delete(self._session_url, headers=self._headers, timeout=5)
            except Exception:
                logger.debug("WHIP DELETE failed", exc_info=True)
        self.detach()
