"""Pipeline inputs: sources that feed decoded frames/samples into the queue.

Mirrors the reference input model (`smelter-core/src/pipeline/input.rs`):
`register_input` spawns source threads (demux + decode) that push `Frame`s /
`AudioSamples` into the queue's per-track bounded channels; closing the
channels signals EOS. Decode runs on the host via the native
smelter_io service (see `smelter_tpu_torch/io/codec.py`).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass
from typing import Optional


from smelter_tpu_torch.core.types import AudioSamples, Frame, PixelFormat, Resolution
from smelter_tpu_torch.utils.channels import Channel, Closed

logger = logging.getLogger("smelter.input")


@dataclass
class InputCtx:
    """Handed to a source's `start`: where to push media."""

    input_id: str
    video_channel: Optional[Channel]   # push Frame; close = EOS
    audio_channel: Optional[Channel]   # push AudioSamples; close = EOS
    mixing_sample_rate: int = 48000
    # per-track protocol stats meters (pipeline/stats.py TrackStats or
    # RtpTrackStats); protocol code feeds compressed byte counts when set
    video_meter: Optional[object] = None
    audio_meter: Optional[object] = None


class InputSource:
    """Base class for input sources."""

    has_video: bool = True
    has_audio: bool = True

    def start(self, ctx: InputCtx) -> None:
        raise NotImplementedError

    def stop(self) -> None:
        pass


class RawDataInput(InputSource):
    """In-process push input (reference `channel/raw_data_input.rs`):
    the caller gets the channels and pushes frames/samples directly."""

    def __init__(self, has_video: bool = True, has_audio: bool = True) -> None:
        self.has_video = has_video
        self.has_audio = has_audio
        self.ctx: Optional[InputCtx] = None

    def start(self, ctx: InputCtx) -> None:
        self.ctx = ctx

    @property
    def video(self) -> Optional[Channel]:
        return self.ctx.video_channel if self.ctx else None

    @property
    def audio(self) -> Optional[Channel]:
        return self.ctx.audio_channel if self.ctx else None


@dataclass
class Mp4InputOptions:
    path: str = ""
    loop: bool = False
    initial_seek_s: Optional[float] = None  # wire seek_ms: start offset
    # decode ahead is bounded by the queue track channels (cap 1/2) plus the
    # queue-side buffer, so no extra pacing is needed here.


class Mp4Input(InputSource):
    """MP4/MOV file or URL input (reference `mp4/mp4_input.rs`):
    demux + decode on a dedicated thread, with loop support (PTS re-based
    on each pass so the timeline is continuous) and seek (restarts the
    reader against a fresh queue track — reference mp4_input.rs:39-70)."""

    # subclasses (HlsInput) keep the probe demuxer open for reuse: a live
    # playlist re-open means re-fetching segments
    _keep_probe_open = False

    def __init__(self, options: Mp4InputOptions) -> None:
        self.options = options
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seek_to: Optional[float] = options.initial_seek_s
        self._probe_demux = None
        # probe streams up front so has_video/has_audio are correct before
        # the queue track is created
        demux = self._open_demuxer()
        infos = demux.streams()
        if self._keep_probe_open:
            self._probe_demux = demux
        else:
            demux.close()
        self._video_info = next(
            (s for s in infos if s.media_type == "video" and s.codec != 0), None
        )
        self._audio_info = next(
            (s for s in infos if s.media_type == "audio" and s.codec != 0), None
        )
        self.has_video = self._video_info is not None
        self.has_audio = self._audio_info is not None
        if not self.has_video and not self.has_audio:
            raise ValueError(f"no decodable streams in {self.options.path}")

    def _open_demuxer(self):
        from smelter_tpu_torch.io.codec import Demuxer

        return Demuxer(self.options.path)

    def _acquire_demuxer(self):
        """First pass reuses the probe demuxer when kept open."""
        d, self._probe_demux = self._probe_demux, None
        if d is None:
            d = self._open_demuxer()
        self._active_demux = d
        return d

    def _filter_packet(self, pkt):
        """Hook: adjust or drop (return None) a demuxed packet before it is
        fanned out to the decoder threads."""
        return pkt

    def start(self, ctx: InputCtx) -> None:
        self._thread = threading.Thread(
            target=self._run, args=(ctx,), name=f"mp4:{ctx.input_id}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread:
            self._thread.join(timeout=timeout)

    def seek(self, seek_s: float, new_ctx: InputCtx) -> None:
        """Stop the current reader and restart from ``seek_s`` into a fresh
        queue track (the pipeline closed the old track's channels)."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10.0)
        self._stop = threading.Event()
        self._seek_to = seek_s
        self.start(new_ctx)

    def _run(self, ctx: InputCtx) -> None:
        """Demux thread: fans packets out to per-media decoder threads over
        bounded channels (reference spawns VideoDecoderThread /
        AudioDecoderThread per input, decoder_thread_video.rs:89). Separate
        threads are required so one stalled media type can't block the other
        (poorly interleaved files, or a consumer pausing one track)."""
        from smelter_tpu_torch.io.codec import AudioDecoder, Codec, Demuxer, VideoDecoder

        vch = ctx.video_channel if self.has_video else None
        ach = ctx.audio_channel if self.has_audio else None
        # packet channels demux → decoders; None = EOF for this pass,
        # ("rebase", pts_base) precedes each loop pass
        vpkts: Optional[Channel] = Channel(256) if vch is not None else None
        apkts: Optional[Channel] = Channel(256) if ach is not None else None

        vinfo, ainfo = self._video_info, self._audio_info
        loop_pts: dict = {"video_end": 0.0, "audio_end": 0.0}

        def video_worker() -> None:
            assert vpkts is not None and vch is not None and vinfo is not None
            frame_dur = 1.0 / (vinfo.fps or 30.0)
            try:
                while True:
                    try:
                        item = vpkts.recv()
                    except Closed:
                        break
                    pts_base, packets_done = item
                    vdec = VideoDecoder(vinfo.codec, vinfo.extradata)
                    end = pts_base

                    def drain() -> bool:
                        nonlocal end
                        while True:
                            f = vdec.receive()
                            if f is None or f == "eof":
                                return True
                            y, u, v, pts, _ = f
                            pts = (pts or 0.0) + pts_base
                            end = max(end, pts + frame_dur)
                            h, w = y.shape
                            try:
                                vch.send(
                                    Frame(
                                        data=(y, u, v),
                                        format=PixelFormat.PLANAR_YUV420,
                                        resolution=Resolution(w, h),
                                        pts=pts,
                                    )
                                )
                            except Closed:
                                return False

                    alive = True
                    while alive:
                        try:
                            pkt = vpkts.recv()
                        except Closed:
                            pkt = None
                        if pkt is None or isinstance(pkt, tuple):
                            break
                        vdec.send(pkt.data, pkt.pts_s or 0.0)
                        alive = drain()
                    vdec.send_eof()
                    drain()
                    vdec.close()
                    loop_pts["video_end"] = end
                    packets_done.set()
                    if not alive:
                        break
            finally:
                vch.close()

        def audio_worker() -> None:
            assert apkts is not None and ach is not None and ainfo is not None
            try:
                while True:
                    try:
                        item = apkts.recv()
                    except Closed:
                        break
                    pts_base, packets_done = item
                    adec = AudioDecoder(
                        ainfo.codec,
                        ctx.mixing_sample_rate,
                        2,
                        extradata=ainfo.extradata,
                        in_sample_rate=ainfo.sample_rate,
                        in_channels=ainfo.channels,
                    )
                    end = pts_base

                    def drain() -> bool:
                        nonlocal end
                        while True:
                            out = adec.receive()
                            if out is None or out == "eof":
                                return True
                            samples, pts = out
                            pts = (pts or 0.0) + pts_base
                            end = max(
                                end, pts + samples.shape[0] / ctx.mixing_sample_rate
                            )
                            try:
                                ach.send(AudioSamples(samples=samples, start_pts=pts))
                            except Closed:
                                return False

                    alive = True
                    while alive:
                        try:
                            pkt = apkts.recv()
                        except Closed:
                            pkt = None
                        if pkt is None or isinstance(pkt, tuple):
                            break
                        adec.send(pkt.data, pkt.pts_s or 0.0)
                        alive = drain()
                    adec.send_eof()
                    drain()
                    adec.close()
                    loop_pts["audio_end"] = end
                    packets_done.set()
                    if not alive:
                        break
            finally:
                ach.close()

        workers = []
        if vpkts is not None:
            t = threading.Thread(
                target=video_worker, name=f"mp4video:{ctx.input_id}", daemon=True
            )
            t.start()
            workers.append((t, vpkts))
        if apkts is not None:
            t = threading.Thread(
                target=audio_worker, name=f"mp4audio:{ctx.input_id}", daemon=True
            )
            t.start()
            workers.append((t, apkts))

        try:
            pts_base = 0.0
            seek_to = self._seek_to
            self._seek_to = None
            while not self._stop.is_set():
                demux = self._acquire_demuxer()
                if seek_to:
                    try:
                        demux.seek(seek_to)
                    except Exception:
                        logger.warning("mp4 seek to %.3fs failed", seek_to)
                    seek_to = None  # loop passes restart from 0
                dones = []
                for _t, ch in workers:
                    done = threading.Event()
                    dones.append(done)
                    try:
                        ch.send((pts_base, done))
                    except Closed:
                        pass
                while not self._stop.is_set():
                    pkt = demux.read()
                    if pkt is None:
                        break
                    pkt = self._filter_packet(pkt)
                    if pkt is None:
                        continue
                    target = None
                    meter = None
                    if vinfo and vpkts is not None and pkt.stream_index == vinfo.index:
                        target = vpkts
                        meter = ctx.video_meter
                    elif (
                        ainfo and apkts is not None and pkt.stream_index == ainfo.index
                    ):
                        target = apkts
                        meter = ctx.audio_meter
                    if target is not None:
                        if meter is not None:
                            meter.add_bytes(len(pkt.data))
                        try:
                            target.send(pkt)
                        except Closed:
                            pass
                demux.close()
                # signal per-pass EOF (None) and wait for decoders to flush
                for _t, ch in workers:
                    try:
                        ch.send(None)
                    except Closed:
                        pass
                for done in dones:
                    done.wait(timeout=30.0)
                if not self.options.loop or self._stop.is_set():
                    break
                pts_base = max(loop_pts["video_end"], loop_pts["audio_end"])
        finally:
            for _t, ch in workers:
                ch.close()


@dataclass
class HlsInputOptions:
    url: str = ""


class HlsInput(Mp4Input):
    """HLS playlist input (reference `hls/hls_input.rs`).

    Differences from the generic URL demuxer that justify a dedicated
    input (hls_input.rs:554-605):

    - the FFmpeg context opens with a ``protocol_whitelist`` options
      dictionary AND an armed interrupt callback, so ``stop()`` aborts a
      blocking segment fetch instead of hanging the demux thread;
    - live playlists (no container duration) re-anchor raw PTS (which is
      wall-clock-ish) against the first received packet;
    - packets flagged corrupt by the demuxer are dropped, and decode
      resumes at the next keyframe (hls_input.rs:318-326);
    - a PTS jump beyond 10 s (hls_input.rs:500 DISCONTINUITY_THRESHOLD)
      marks an ``#EXT-X-DISCONTINUITY``; the timeline re-anchors so output
      stays continuous.
    """

    DISCONTINUITY_THRESHOLD_S = 10.0
    # reference hls_input.rs:557
    FFMPEG_OPTIONS = {"protocol_whitelist": "tcp,hls,http,https,file,tls"}

    _keep_probe_open = True

    def __init__(self, options: HlsInputOptions) -> None:
        self.hls_options = options
        self._pts_offset: Optional[float] = None
        self._last_pts: dict = {}
        self._wait_keyframe = False
        self._live = False
        super().__init__(Mp4InputOptions(path=options.url, loop=False))
        if self._probe_demux is not None:
            self._live = self._probe_demux.is_live()

    def _open_demuxer(self):
        from smelter_tpu_torch.io.codec import Demuxer

        return Demuxer(self.options.path, options=dict(self.FFMPEG_OPTIONS))

    def stop(self) -> None:
        super().stop()
        for d in (getattr(self, "_active_demux", None), self._probe_demux):
            if d is not None:
                try:
                    d.interrupt()
                except Exception:
                    pass

    def _filter_packet(self, pkt):
        if pkt.is_corrupt:
            logger.warning("hls: dropping corrupted packet")
            self._wait_keyframe = True
            return None
        if self._wait_keyframe:
            if not pkt.is_keyframe:
                return None
            self._wait_keyframe = False
        raw = pkt.pts_s if pkt.pts_s is not None else pkt.dts_s
        if raw is None:
            return pkt
        if self._pts_offset is None:
            # live playlists start at an arbitrary (wall-clock) PTS
            self._pts_offset = raw if self._live else 0.0
        last = self._last_pts.get(pkt.stream_index)
        if last is not None and abs(raw - self._pts_offset - last) > self.DISCONTINUITY_THRESHOLD_S:
            # #EXT-X-DISCONTINUITY: re-anchor so the output timeline stays
            # continuous (reference restarts tracks, hls_input.rs:396-420)
            logger.warning(
                "hls: discontinuity (raw=%.3f last=%.3f), re-anchoring", raw, last
            )
            self._pts_offset = raw - (last + 0.033)
            self._wait_keyframe = True
            if not pkt.is_keyframe:
                return None
        self._last_pts[pkt.stream_index] = raw - self._pts_offset
        if pkt.pts_s is not None:
            pkt.pts_s -= self._pts_offset
        if pkt.dts_s is not None:
            pkt.dts_s -= self._pts_offset
        return pkt
