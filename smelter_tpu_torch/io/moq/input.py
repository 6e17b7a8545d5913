"""MoQ pipeline inputs (reference `moq/input/`): the shared broadcast
consumer (catalog read → per-track decode threads with timestamp
alignment), the server-accepted input, and the outbound client input."""

from __future__ import annotations

import logging
import threading
import urllib.parse
from dataclasses import dataclass
from typing import Dict, Optional

from smelter_tpu_torch.core.types import AudioSamples, Frame, PixelFormat, Resolution
from smelter_tpu_torch.io.moq import catalog as catalog_mod
from smelter_tpu_torch.io.moq import wire
from smelter_tpu_torch.io.moq.aligner import EpochShared, TimestampAligner
from smelter_tpu_torch.io.moq.container import ContainerReader, parse_init_segment
from smelter_tpu_torch.io.moq.session import MoqSession, TrackConsumer
from smelter_tpu_torch.pipeline.input import InputCtx, InputSource
from smelter_tpu_torch.utils.channels import Closed

logger = logging.getLogger("smelter.moq")

# reference input/connection.rs:41 — queue-offset buffer absorbing network
# jitter and decode latency at the cost of a fixed delay
MOQ_BUFFER_S = 2.2


def _annexb_or_avcc(codec: str, container: str) -> bool:
    """True when frames are AVCC length-prefixed (CMAF h264)."""
    return codec == "h264" and container == "cmaf"


def run_broadcast(session: MoqSession, ctx: InputCtx,
                  stop: threading.Event) -> None:
    """Consume one announced broadcast into the pipeline input channels
    (reference `input/connection.rs` handle_broadcast): read the catalog,
    pick the first supported video/audio rendition, and run a decode
    thread per track with the shared-epoch timestamp aligner."""
    cat_consumer = session.subscribe_track(catalog_mod.CATALOG_TRACK)
    first = cat_consumer.read(timeout=10.0)
    if first is None:
        raise ConnectionError("MoQ catalog track produced no frames")
    cat = catalog_mod.Catalog.from_bytes(first.payload)
    video = cat.first_video()
    audio = cat.first_audio()
    if video is None and audio is None:
        raise ConnectionError("MoQ catalog contains no supported tracks")

    epoch = EpochShared()
    single = video is None or audio is None
    threads = []

    if video is not None and ctx.video_channel is not None:
        vcons = session.subscribe_track(video.name)
        t = threading.Thread(
            target=_run_video_track,
            args=(video, vcons, ctx, epoch, single, stop),
            name=f"moq-video:{ctx.input_id}", daemon=True,
        )
        t.start()
        threads.append(t)
    elif ctx.video_channel is not None:
        ctx.video_channel.close()

    if audio is not None and ctx.audio_channel is not None:
        acons = session.subscribe_track(audio.name)
        t = threading.Thread(
            target=_run_audio_track,
            args=(audio, acons, ctx, epoch, single, stop),
            name=f"moq-audio:{ctx.input_id}", daemon=True,
        )
        t.start()
        threads.append(t)
    elif ctx.audio_channel is not None:
        ctx.audio_channel.close()

    for t in threads:
        t.join()


def _container_reader(entry: catalog_mod.TrackEntry) -> ContainerReader:
    timescale = entry.timescale or catalog_mod.VIDEO_TIMESCALE
    if entry.container == "cmaf" and entry.init_segment:
        ts, _desc, _fourcc = parse_init_segment(entry.init_segment)
        timescale = ts
    return ContainerReader(entry.container, timescale)


def _decoder_description(entry: catalog_mod.TrackEntry) -> bytes:
    """Codec config: catalog description, else extracted from the CMAF init
    segment (reference catalog.rs extract_codec_description)."""
    if entry.description:
        return entry.description
    if entry.init_segment:
        _ts, desc, _fourcc = parse_init_segment(entry.init_segment)
        return desc or b""
    return b""


def _run_video_track(entry: catalog_mod.TrackEntry, consumer: TrackConsumer,
                     ctx: InputCtx, epoch: EpochShared, single: bool,
                     stop: threading.Event) -> None:
    from smelter_tpu_torch.io.codec import Codec, VideoDecoder

    vch = ctx.video_channel
    assert vch is not None
    reader = _container_reader(entry)
    desc = _decoder_description(entry)
    if entry.codec == "h264" and entry.container == "cmaf" and not desc:
        logger.error("MoQ CMAF h264 track without avcC; dropping video")
        vch.close()
        return
    try:
        dec = VideoDecoder(Codec.from_name(entry.codec),
                           desc if entry.codec == "h264" else b"")
    except Exception:
        logger.exception("MoQ video decoder init failed")
        vch.close()
        return
    aligner = TimestampAligner(epoch, "video", single)

    def pump() -> bool:
        while True:
            f = dec.receive()
            if f is None or f == "eof":
                return True
            y, u, v, pts, _ = f
            h, w = y.shape
            try:
                vch.send(Frame(data=(y, u, v), format=PixelFormat.PLANAR_YUV420,
                               resolution=Resolution(w, h), pts=pts or 0.0))
            except Closed:
                return False

    try:
        eos = False
        while not stop.is_set():
            tf = consumer.read(timeout=0.5)
            if tf is None:
                if session_dead(consumer):
                    eos = True
                    break
                continue
            if ctx.video_meter is not None:
                ctx.video_meter.add_bytes(len(tf.payload))
            ts_us, payload = reader.unpack(tf.timestamp_us, tf.payload)
            for chunk in aligner.on_chunk(tf.keyframe, ts_us / 1e6, payload):
                dec.send(chunk.data, chunk.pts)
                if not pump():
                    return
        if eos and not aligner.is_locked():
            # EOS before warmup finished: force-lock so the clip renders
            for chunk in aligner.flush():
                dec.send(chunk.data, chunk.pts)
                if not pump():
                    return
        dec.send_eof()
        pump()
    except Exception:
        logger.exception("MoQ video track failed")
    finally:
        dec.close()
        vch.close()


def _run_audio_track(entry: catalog_mod.TrackEntry, consumer: TrackConsumer,
                     ctx: InputCtx, epoch: EpochShared, single: bool,
                     stop: threading.Event) -> None:
    from smelter_tpu_torch.io.codec import AudioDecoder, Codec

    ach = ctx.audio_channel
    assert ach is not None
    reader = _container_reader(entry)
    desc = _decoder_description(entry)
    try:
        dec = AudioDecoder(
            Codec.from_name(entry.codec), ctx.mixing_sample_rate, 2,
            extradata=desc,
            in_sample_rate=entry.sample_rate or 48000,
            in_channels=entry.channels or 2,
        )
    except Exception:
        logger.exception("MoQ audio decoder init failed")
        ach.close()
        return
    aligner = TimestampAligner(epoch, "audio", single)

    def pump() -> bool:
        while True:
            out = dec.receive()
            if out is None or out == "eof":
                return True
            samples, pts = out
            try:
                ach.send(AudioSamples(samples=samples, start_pts=pts or 0.0))
            except Closed:
                return False

    try:
        eos = False
        while not stop.is_set():
            tf = consumer.read(timeout=0.5)
            if tf is None:
                if session_dead(consumer):
                    eos = True
                    break
                continue
            if ctx.audio_meter is not None:
                ctx.audio_meter.add_bytes(len(tf.payload))
            ts_us, payload = reader.unpack(tf.timestamp_us, tf.payload)
            for chunk in aligner.on_chunk(tf.keyframe, ts_us / 1e6, payload):
                dec.send(chunk.data, chunk.pts)
                if not pump():
                    return
        if eos and not aligner.is_locked():
            for chunk in aligner.flush():
                dec.send(chunk.data, chunk.pts)
                if not pump():
                    return
        dec.send_eof()
        pump()
    except Exception:
        logger.exception("MoQ audio track failed")
    finally:
        dec.close()
        ach.close()


# sentinel pushed by the session loop on close; TrackConsumer.read returns
# None both on timeout and on that sentinel, so peek the queue state
def session_dead(consumer: TrackConsumer) -> bool:
    return consumer.error is not None or getattr(consumer, "_closed", False)


@dataclass
class MoqServerInputOptions:
    auth_token: str = ""
    # decoder_map accepted for wire parity; the host decode service has a
    # single software decoder per codec, so it has no effect here
    decoder_map: Optional[Dict[str, str]] = None


class MoqServerInput(InputSource):
    """Input fed by a publisher connecting to the shared MoQ server
    (reference `moq/input/server_input.rs` + `server.rs`): the URL path is
    the input name and a `token` query parameter must match."""

    has_video = True
    has_audio = True

    def __init__(self, options: MoqServerInputOptions) -> None:
        self.options = options
        self.ctx: Optional[InputCtx] = None
        self._stop = threading.Event()
        self._session: Optional[MoqSession] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, ctx: InputCtx) -> None:
        self.ctx = ctx

    def stop(self) -> None:
        self._stop.set()
        if self._session is not None:
            self._session.close()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    # called by MoqServer when a publisher's broadcast is announced
    def attach_session(self, session: MoqSession) -> bool:
        if self.ctx is None:
            return False
        if self._session is not None and not self._session.closed.is_set():
            logger.warning("MoQ input already has an active connection")
            return False
        self._session = session
        self._thread = threading.Thread(
            target=self._run, args=(session,), name="moq-server-input",
            daemon=True,
        )
        self._thread.start()
        return True

    def _run(self, session: MoqSession) -> None:
        try:
            path = session.next_announce(timeout=15.0)
            if path is None:
                logger.warning("MoQ session closed before announcing")
                return
            logger.info("MoQ broadcast %r announced", path)
            run_broadcast(session, self.ctx, self._stop)
        except Exception:
            logger.exception("MoQ server input failed")
        finally:
            for ch in (self.ctx.video_channel, self.ctx.audio_channel):
                if ch is not None:
                    ch.close()


@dataclass
class MoqClientInputOptions:
    endpoint_url: str = ""       # moql://host:port/path?token=...
    broadcast_path: str = ""
    decoder_map: Optional[Dict[str, str]] = None
    # Chain+hostname verification against the system trust store — on by
    # default like quinn/rustls in the reference's MoQ client input;
    # SMELTER_MOQ_DISABLE_TLS_VERIFICATION turns it off (wired by the
    # server layer, mirroring io/moq/output.py).
    verify_tls: bool = False


class MoqClientInput(InputSource):
    """Outbound subscriber (reference `moq/input/client_input.rs`):
    connects to a relay, waits for the broadcast at `broadcast_path`."""

    has_video = True
    has_audio = True

    def __init__(self, options: MoqClientInputOptions) -> None:
        self.options = options
        self._stop = threading.Event()
        self._client = None
        self._session: Optional[MoqSession] = None
        self._thread: Optional[threading.Thread] = None

    def start(self, ctx: InputCtx) -> None:
        from smelter_tpu_torch.io.quic import QuicClient

        parsed = urllib.parse.urlparse(self.options.endpoint_url)
        if parsed.scheme not in ("moql", "https", "http"):
            raise ValueError(f"unsupported MoQ scheme {parsed.scheme!r}")
        host = parsed.hostname or "127.0.0.1"
        port = parsed.port or 443
        token = dict(urllib.parse.parse_qsl(parsed.query)).get("token", "")
        path = (parsed.path or "/").lstrip("/")
        self._client = QuicClient(
            host, port, [wire.ALPN], server_name=host,
            verify_peer=self.options.verify_tls,
        )
        handle = self._client.connect(timeout=15.0)
        session = MoqSession(handle, is_quic_client=True)
        session.start_client(path, token)
        session.wait_setup(timeout=10.0)
        self._session = session
        self._thread = threading.Thread(
            target=self._run, args=(session, ctx), name="moq-client-input",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._session is not None:
            self._session.close()
        if self._client is not None:
            self._client.close()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout=timeout)

    def _run(self, session: MoqSession, ctx: InputCtx) -> None:
        try:
            want = self.options.broadcast_path.lstrip("/")
            deadline_tries = 30
            while deadline_tries > 0 and not self._stop.is_set():
                path = session.next_announce(timeout=1.0)
                if path is None:
                    deadline_tries -= 1
                    continue
                if not want or path.lstrip("/") == want:
                    break
                logger.info("ignoring announce %r (waiting for %r)", path, want)
            else:
                logger.warning("MoQ broadcast %r never announced", want)
                return
            run_broadcast(session, ctx, self._stop)
        except Exception:
            logger.exception("MoQ client input failed")
        finally:
            for ch in (ctx.video_channel, ctx.audio_channel):
                if ch is not None:
                    ch.close()
