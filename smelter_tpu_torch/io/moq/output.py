"""MoQ client output (reference `moq/output/client_output.rs`): connect to
a relay/server, announce a broadcast, publish the hang-style catalog and
per-track groups (keyframe-started video groups; one group per audio
frame)."""

from __future__ import annotations

import logging
import threading
import urllib.parse
from typing import Dict, Optional

from smelter_tpu_torch.io.moq import catalog as catalog_mod
from smelter_tpu_torch.io.moq import wire
from smelter_tpu_torch.io.moq.container import ContainerWriter, build_init_segment
from smelter_tpu_torch.io.moq.session import MoqSession, TrackProducer
from smelter_tpu_torch.pipeline.output import OutputSink

logger = logging.getLogger("smelter.moq")


class BroadcastPublisher:
    """Publisher half of a session: answers subscribes, owns producers.
    Shared by MoqClientOutput and tests."""

    def __init__(self, session: MoqSession, broadcast_path: str) -> None:
        self.session = session
        self.broadcast_path = broadcast_path
        self.catalog = catalog_mod.Catalog()
        self._catalog_bytes: Optional[bytes] = None
        self._producers: Dict[str, TrackProducer] = {}
        self._lock = threading.Lock()
        session.on_subscribe = self._on_subscribe
        self._announced = False

    def set_catalog(self, cat: catalog_mod.Catalog) -> None:
        with self._lock:
            self.catalog = cat
            self._catalog_bytes = cat.to_bytes()
        if not self._announced:
            self.session.announce(self.broadcast_path)
            self._announced = True

    def _track_names(self) -> set:
        return ({catalog_mod.CATALOG_TRACK}
                | set(self.catalog.video) | set(self.catalog.audio))

    def _on_subscribe(self, track: str, sub_id: int) -> bool:
        with self._lock:
            if track not in self._track_names():
                return False
            prod = self.session.producer_for(sub_id)
            self._producers[track] = prod
        if track == catalog_mod.CATALOG_TRACK and self._catalog_bytes:
            # each catalog update is one group (reference: catalog track
            # yields the current catalog first, then updates)
            prod.write(0, True, self._catalog_bytes, new_group=True)
            prod.finish_group()
        return True

    def producer(self, track: str) -> Optional[TrackProducer]:
        with self._lock:
            return self._producers.get(track)

    def finish(self) -> None:
        with self._lock:
            producers = list(self._producers.values())
        for p in producers:
            try:
                p.finish()
            except Exception:
                pass


class MoqClientOutput(OutputSink):
    """OutputSink publishing over MoQ. ``endpoint_url``:
    moql://host:port/<path>?token=... (https:// accepted for parity with
    the reference API; it maps to the same QUIC endpoint)."""

    def __init__(self, endpoint_url: str, broadcast_path: str,
                 container: str = "cmaf", has_video: bool = True,
                 has_audio: bool = True, fps: int = 30,
                 verify_tls: bool = False) -> None:
        from smelter_tpu_torch.io.quic import QuicClient

        if container not in ("legacy", "loc", "cmaf"):
            raise ValueError(f"unknown MoQ container {container!r}")
        self.container = container
        self.broadcast_path = broadcast_path.lstrip("/")
        self.has_video = has_video
        self.has_audio = has_audio
        self.fps = fps
        parsed = urllib.parse.urlparse(endpoint_url)
        if parsed.scheme not in ("moql", "https", "http"):
            raise ValueError(f"unsupported MoQ scheme {parsed.scheme!r}")
        host = parsed.hostname or "127.0.0.1"
        port = parsed.port or 443
        token = dict(urllib.parse.parse_qsl(parsed.query)).get("token", "")
        path = (parsed.path or "/").lstrip("/")
        # verify_tls=True performs real chain+hostname verification against
        # the system trust store (io/quic/tls.py:_verify_peer_chain) — the
        # reference's quinn/rustls default, disabled by
        # SMELTER_MOQ_DISABLE_TLS_VERIFICATION
        self._client = QuicClient(
            host, port, [wire.ALPN], server_name=host, verify_peer=verify_tls
        )
        handle = self._client.connect(timeout=15.0)
        self.session = MoqSession(handle, is_quic_client=True)
        self.publisher = BroadcastPublisher(self.session, self.broadcast_path)
        self.session.start_client(path, token)
        self.session.wait_setup(timeout=10.0)
        self._video_writer: Optional[ContainerWriter] = None
        self._audio_writer: Optional[ContainerWriter] = None
        self._video_entry: Optional[catalog_mod.TrackEntry] = None
        self._audio_entry: Optional[catalog_mod.TrackEntry] = None
        self._catalog_published = False
        self._lock = threading.Lock()

    # -- OutputSink -------------------------------------------------------------

    def setup_video(self, opts, extradata: bytes, fps_num: int,
                    fps_den: int) -> None:
        codec = (getattr(getattr(opts, "encoder", None), "codec", None)
                 or "h264").lower()
        codec = {"hevc": "h265"}.get(codec, codec)
        if codec not in ("h264", "vp8", "vp9", "av1"):
            raise ValueError(
                f"MoQ output supports h264/vp8/vp9/av1, got {codec}"
            )
        res = getattr(opts, "resolution", None)
        w = getattr(res, "width", 0) or 0
        h = getattr(res, "height", 0) or 0
        desc = extradata if codec == "h264" else None
        if codec == "av1" and extradata:
            from smelter_tpu_torch.io.rtmp.session import extract_av1_sequence_header

            desc = extract_av1_sequence_header(extradata) or extradata
        init = None
        if self.container == "cmaf":
            if codec == "h264" and (not desc or not desc.startswith(b"\x01")):
                # CMAF needs the out-of-band avcC record
                # (reference catalog.rs:38-49); build from AnnexB extradata
                from smelter_tpu_torch.io.rtmp.h264_utils import (
                    build_avcc_record,
                    extract_parameter_sets,
                )

                sps, pps = extract_parameter_sets(desc or b"")
                if not (sps and pps):
                    raise ValueError("h264 CMAF needs parameter sets")
                desc = build_avcc_record(sps, pps)
            init = build_init_segment(
                True, codec, catalog_mod.VIDEO_TIMESCALE, desc, w, h
            )
        entry = catalog_mod.TrackEntry(
            name=catalog_mod.VIDEO_TRACK, codec=codec, container=self.container,
            description=desc, init_segment=init,
            timescale=catalog_mod.VIDEO_TIMESCALE, width=w, height=h,
        )
        with self._lock:
            self._video_entry = entry
            self._video_writer = ContainerWriter(
                self.container, catalog_mod.VIDEO_TIMESCALE
            )
        self._maybe_publish_catalog()

    def setup_audio(self, opts, extradata: bytes) -> None:
        codec = (getattr(getattr(opts, "encoder", None), "codec", None)
                 or "aac").lower()
        if codec not in ("aac", "opus"):
            raise ValueError(f"MoQ output supports aac/opus audio, got {codec}")
        sample_rate = getattr(getattr(opts, "encoder", None), "sample_rate",
                              None) or 48000
        channels = 2
        desc = extradata or None
        init = None
        timescale = sample_rate
        if self.container == "cmaf":
            if codec == "aac" and not desc:
                raise ValueError(
                    "aac CMAF needs an AudioSpecificConfig "
                    "(reference catalog.rs MissingAacEncoderConfig)"
                )
            init = build_init_segment(
                False, codec, timescale, desc,
                sample_rate=sample_rate, channels=channels,
            )
        entry = catalog_mod.TrackEntry(
            name=catalog_mod.AUDIO_TRACK, codec=codec, container=self.container,
            description=desc, init_segment=init, timescale=timescale,
            sample_rate=sample_rate, channels=channels,
        )
        with self._lock:
            self._audio_entry = entry
            self._audio_writer = ContainerWriter(self.container, timescale)
        self._maybe_publish_catalog()

    def _maybe_publish_catalog(self) -> None:
        with self._lock:
            if self._catalog_published:
                return
            if self.has_video and self._video_entry is None:
                return
            if self.has_audio and self._audio_entry is None:
                return
            cat = catalog_mod.Catalog()
            if self._video_entry is not None:
                cat.video[self._video_entry.name] = self._video_entry
            if self._audio_entry is not None:
                cat.audio[self._audio_entry.name] = self._audio_entry
            self._catalog_published = True
        self.publisher.set_catalog(cat)
        logger.info("MoQ broadcast %r announced", self.broadcast_path)

    def write_video_packet(self, pkt) -> None:
        prod = self.publisher.producer(catalog_mod.VIDEO_TRACK)
        writer = self._video_writer
        if prod is None or writer is None:
            return
        ts_us = int(round((pkt.pts_s or 0.0) * 1e6))
        payload = pkt.data
        # CMAF h264 samples are AVCC length-prefixed; convert AnnexB encoder
        # output (legacy/loc keep parameter sets inline, catalog.rs:51-59)
        if (self.container == "cmaf" and self._video_entry is not None
                and self._video_entry.codec == "h264"
                and payload[:3] in (b"\x00\x00\x01", b"\x00\x00\x00")):
            from smelter_tpu_torch.io.rtmp.h264_utils import annexb_to_avcc

            payload = annexb_to_avcc(payload)
        prod.write(ts_us, pkt.is_keyframe,
                   writer.pack(ts_us, payload, pkt.is_keyframe),
                   new_group=pkt.is_keyframe)

    def write_audio_packet(self, pkt) -> None:
        prod = self.publisher.producer(catalog_mod.AUDIO_TRACK)
        writer = self._audio_writer
        if prod is None or writer is None:
            return
        ts_us = int(round((pkt.pts_s or 0.0) * 1e6))
        # audio has no keyframes: every frame starts its own group
        # (reference client_output.rs send_chunk finish_group)
        prod.write(ts_us, True, writer.pack(ts_us, pkt.data, True),
                   new_group=True)
        prod.finish_group()

    def on_done(self) -> None:
        self.publisher.finish()
        self.session.close()
        self._client.close()
