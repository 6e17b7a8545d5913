"""RTMP server input + client output (reference `rtmp/src/{server,client}/`).

From-scratch protocol implementation (not an FFmpeg wrapper), like the
reference's `rtmp` crate:

- handshake: plain C0/C1/C2 ↔ S0/S1/S2 (un-digested variant; interops with
  FFmpeg/OBS clients which fall back to plain when the server echoes)
- `RtmpServerInput`: accepts one publisher (connect → createStream →
  publish → audio/video messages), parses FLV tag bodies (AVC sequence
  header / AVCC NALUs, AAC AudioSpecificConfig / raw), decodes via the
  native codec service, feeds the queue
- `RtmpClientOutput`: OutputSink that connects to an rtmp:// URL, publishes
  a stream, and sends FLV-tagged H264/AAC packets

Note the reference applies a 2s buffer offset rule for RTMP inputs
(`queue.rs:110-115`); callers should register RTMP inputs with a matching
`buffer_duration`.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
import time
import urllib.parse
from dataclasses import dataclass
from typing import List, Optional, Tuple


from smelter_tpu_torch.core.types import AudioSamples, Frame, PixelFormat, Resolution
from smelter_tpu_torch.io.rtmp import amf0, amf3
from smelter_tpu_torch.io.rtmp.chunk import (
    AUDIO,
    COMMAND_AMF0,
    COMMAND_AMF3,
    DATA_AMF0,
    DATA_AMF3,
    ChunkReader,
    ChunkWriter,
    RtmpMessage,
    SET_CHUNK_SIZE,
    SET_PEER_BANDWIDTH,
    USER_CONTROL,
    VIDEO,
    WINDOW_ACK_SIZE,
)
from smelter_tpu_torch.io.rtmp.h264_utils import (
    annexb_to_avcc,
    avcc_to_annexb,
    build_avcc_record,
    extract_parameter_sets,
    is_keyframe_annexb,
)
from smelter_tpu_torch.pipeline.input import InputCtx, InputSource
from smelter_tpu_torch.pipeline.output import OutputSink
from smelter_tpu_torch.utils.channels import Channel, Closed

logger = logging.getLogger("smelter.rtmp")

HANDSHAKE_SIZE = 1536


def _server_handshake(conn: socket.socket) -> None:
    c0 = _read_exact(conn, 1)
    if c0 != b"\x03":
        raise ConnectionError(f"unsupported RTMP version {c0!r}")
    c1 = _read_exact(conn, HANDSHAKE_SIZE)
    s1 = struct.pack(">II", 0, 0) + os.urandom(HANDSHAKE_SIZE - 8)
    conn.sendall(b"\x03" + s1 + c1)  # S0 S1 S2(=echo C1)
    _read_exact(conn, HANDSHAKE_SIZE)  # C2


def _client_handshake(conn: socket.socket) -> None:
    c1 = struct.pack(">II", 0, 0) + os.urandom(HANDSHAKE_SIZE - 8)
    conn.sendall(b"\x03" + c1)
    s0 = _read_exact(conn, 1)
    if s0 != b"\x03":
        raise ConnectionError(f"unsupported RTMP version {s0!r}")
    s1 = _read_exact(conn, HANDSHAKE_SIZE)
    _read_exact(conn, HANDSHAKE_SIZE)  # S2
    conn.sendall(s1)  # C2 = echo S1


def decode_command_message(msg: "RtmpMessage") -> List[object]:
    """Decode COMMAND_AMF0 or COMMAND_AMF3 message bodies to a value list.

    AMF3 command bodies from real encoders carry a leading 0x00 format byte
    followed by AMF0 values (which may themselves escape to AMF3 via the
    avmplus marker); pure-AMF3 bodies are also accepted."""
    if msg.message_type in (COMMAND_AMF3, DATA_AMF3):
        body = msg.payload
        if body[:1] == b"\x00":
            return amf0.decode_all(body[1:])
        return amf3.decode_all(body)
    return amf0.decode_all(msg.payload)


def _read_exact(conn: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed during read")
        buf.extend(chunk)
    return bytes(buf)


# ---------------------------------------------------------------------------
# FLV tag bodies
# ---------------------------------------------------------------------------


# enhanced-RTMP (E-RTMP v1) FourCC → codec key used in tag kinds
_EX_FOURCC = {b"hvc1": "hevc", b"av01": "av1", b"vp09": "vp9"}


def parse_video_tag(payload: bytes) -> Optional[Tuple[str, bool, int, bytes]]:
    """FLV VIDEODATA → (kind, keyframe, composition_time_ms, body).

    Legacy AVC tags yield 'avc_header' / 'avc_nalu'. Enhanced-RTMP tags
    (IsExHeader bit set, 4-byte FourCC: hvc1/av01/vp09) yield
    '<codec>_header' (sequence start: hvcC/av1C/vpcC config record) and
    '<codec>_frame' (coded frames; CodedFrames carries a 3-byte CTS for
    HEVC, CodedFramesX implies CTS 0)."""
    if len(payload) < 5:
        return None
    if payload[0] & 0x80:  # IsExHeader → enhanced-RTMP
        frame_type = (payload[0] >> 4) & 0x07
        packet_type = payload[0] & 0x0F
        codec = _EX_FOURCC.get(payload[1:5])
        if codec is None:
            return ("other", frame_type == 1, 0, payload[5:])
        body = payload[5:]
        cts = 0
        if packet_type == 0:  # SequenceStart: config record
            return (f"{codec}_header", frame_type == 1, 0, body)
        if packet_type == 1:  # CodedFrames (HEVC: 3-byte CTS prefix)
            if codec == "hevc" and len(body) >= 3:
                cts = int.from_bytes(body[:3], "big", signed=False)
                if cts & 0x800000:
                    cts -= 0x1000000
                body = body[3:]
            return (f"{codec}_frame", frame_type == 1, cts, body)
        if packet_type == 3:  # CodedFramesX: no CTS
            return (f"{codec}_frame", frame_type == 1, 0, body)
        return ("other", frame_type == 1, 0, body)
    frame_type = payload[0] >> 4
    codec_id = payload[0] & 0x0F
    if codec_id != 7:  # legacy non-AVC codecs unsupported
        return ("other", frame_type == 1, 0, payload[1:])
    packet_type = payload[1]
    cts = int.from_bytes(payload[2:5], "big", signed=False)
    if cts & 0x800000:
        cts -= 0x1000000
    body = payload[5:]
    kind = "avc_header" if packet_type == 0 else "avc_nalu" if packet_type == 1 else "other"
    return (kind, frame_type == 1, cts, body)


def parse_audio_tag(payload: bytes) -> Optional[Tuple[str, bytes]]:
    """FLV AUDIODATA → (kind, body). kind: 'aac_header' | 'aac_raw' | 'other'."""
    if len(payload) < 2:
        return None
    fmt = payload[0] >> 4
    if fmt != 10:  # AAC only
        return ("other", payload[1:])
    return ("aac_header" if payload[1] == 0 else "aac_raw", payload[2:])


def video_tag(avcc_nalus: bytes, keyframe: bool, cts_ms: int = 0,
              is_header: bool = False) -> bytes:
    first = (0x17 if keyframe else 0x27)
    ptype = 0 if is_header else 1
    return bytes([first, ptype]) + int(cts_ms).to_bytes(3, "big", signed=False) + avcc_nalus


def ex_video_tag(fourcc: bytes, body: bytes, keyframe: bool,
                 packet_type: int, cts_ms: int = 0) -> bytes:
    """Enhanced-RTMP (E-RTMP v1) ExVideoTagHeader: IsExHeader bit + frame
    type + VideoPacketType, then the 4-byte FourCC (reference
    `rtmp/src/flv/` ExVideo tags). CodedFrames (1) carries a 3-byte signed
    CTS for HEVC; CodedFramesX (3) implies CTS 0."""
    assert len(fourcc) == 4
    first = 0x80 | ((1 if keyframe else 2) << 4) | (packet_type & 0x0F)
    out = bytes([first]) + fourcc
    if packet_type == 1 and fourcc == b"hvc1":
        out += (int(cts_ms) & 0xFFFFFF).to_bytes(3, "big")
    return out + body


def extract_av1_sequence_header(data: bytes) -> Optional[bytes]:
    """First OBU_SEQUENCE_HEADER in a low-overhead AV1 bitstream (used as
    the av01 SequenceStart config when the encoder gives no extradata)."""
    i = 0
    n = len(data)
    while i < n:
        b = data[i]
        if b & 0x80:  # forbidden bit
            return None
        obu_type = (b >> 3) & 0x0F
        ext = (b >> 2) & 1
        has_size = (b >> 1) & 1
        j = i + 1 + ext
        if has_size:
            size = 0
            shift = 0
            while j < n:
                c = data[j]
                j += 1
                size |= (c & 0x7F) << shift
                if not (c & 0x80):
                    break
                shift += 7
        else:
            size = n - j
        if j + size > n:
            return None
        if obu_type == 1:  # OBU_SEQUENCE_HEADER
            return data[i : j + size]
        i = j + size
    return None


def build_vpcc_record(profile: int = 0, level: int = 10, bit_depth: int = 8,
                      chroma_subsampling: int = 1, full_range: bool = False) -> bytes:
    """Minimal VPCodecConfigurationRecord (vpcC box payload) for a vp09
    SequenceStart tag: version, flags, profile, level, packed depth/
    subsampling/range, BT.709 colour triple, no init data."""
    packed = (bit_depth << 4) | (chroma_subsampling << 1) | (1 if full_range else 0)
    return bytes([1, 0, 0, 0, profile, level, packed, 1, 1, 1, 0, 0])


def audio_tag(body: bytes, is_header: bool = False) -> bytes:
    # SoundFormat=10 (AAC), 44kHz flag, 16-bit, stereo → 0xAF
    return bytes([0xAF, 0 if is_header else 1]) + body


# ---------------------------------------------------------------------------
# server input
# ---------------------------------------------------------------------------


@dataclass
class RtmpInputOptions:
    port: int = 0               # 0 = pick free port
    app: str = ""               # accept any app/stream key when empty
    stream_key: str = ""
    # RTMPS (extension beyond the reference server, which is plain RTMP):
    # wrap accepted connections in TLS; self-signed cert when paths omitted
    tls: bool = False
    tls_cert_path: str = ""
    tls_key_path: str = ""


class RtmpServerInput(InputSource):
    """RTMP server accepting one publisher (reference `rtmp/rtmp_input/`)."""

    has_video = True
    has_audio = True

    def __init__(self, options: RtmpInputOptions = RtmpInputOptions()) -> None:
        self.options = options
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", options.port))
        self._sock.listen(2)
        self.port = self._sock.getsockname()[1]
        self._threads: List[threading.Thread] = []

    def start(self, ctx: InputCtx) -> None:
        t = threading.Thread(
            target=self._run, args=(ctx,), name=f"rtmp-in:{ctx.input_id}", daemon=True
        )
        t.start()
        self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass

    # -- session ------------------------------------------------------------------

    def _run(self, ctx: InputCtx) -> None:
        vch, ach = ctx.video_channel, ctx.audio_channel
        try:
            try:
                self._sock.settimeout(0.5)
            except OSError:
                return  # stop() closed the listener before the loop started
            while not self._stop.is_set():
                conn = None
                while not self._stop.is_set() and conn is None:
                    try:
                        conn, addr = self._sock.accept()
                    except socket.timeout:
                        continue
                    except OSError:
                        return
                if conn is None:
                    return
                # a connection that fails TLS/handshake (port scanner,
                # wrong protocol) must NOT kill the registered input —
                # close it and keep listening for a real publisher
                try:
                    conn.settimeout(10.0)
                    if self.options.tls:
                        from smelter_tpu_torch.io.rtmp.tls import server_context

                        tls_ctx = server_context(
                            self.options.tls_cert_path or None,
                            self.options.tls_key_path or None,
                        )
                        conn = tls_ctx.wrap_socket(conn, server_side=True)
                    _server_handshake(conn)
                except Exception:
                    logger.warning(
                        "rtmp connection from %s failed before handshake "
                        "completed; still listening", addr, exc_info=True
                    )
                    try:
                        conn.close()
                    except OSError:
                        pass
                    continue
                try:
                    self._serve_publisher(conn, ctx)
                except Exception:
                    logger.exception("rtmp publisher session failed")
                return  # publisher session ended → EOS (reference behavior)
        finally:
            for ch in (vch, ach):
                if ch is not None:
                    ch.close()

    def _serve_publisher(self, conn: socket.socket, ctx: InputCtx) -> None:
        """Protocol thread: parses messages and fans media out to per-media
        decode threads (one stalled media type must not block the other —
        same structure as Mp4Input / RtpInputSource)."""
        reader = ChunkReader()
        writer = ChunkWriter(chunk_size=4096)

        def send(msg: RtmpMessage) -> None:
            conn.sendall(writer.serialize(msg))

        def send_command(payload: bytes, stream_id: int = 0) -> None:
            send(RtmpMessage(COMMAND_AMF0, 0, stream_id, payload, chunk_stream_id=3))

        # control burst (window ack, peer bw, chunk size)
        send(RtmpMessage(WINDOW_ACK_SIZE, 0, 0, struct.pack(">I", 2_500_000),
                         chunk_stream_id=2))
        send(RtmpMessage(SET_PEER_BANDWIDTH, 0, 0, struct.pack(">IB", 2_500_000, 2),
                         chunk_stream_id=2))
        send(writer.set_chunk_size_message(4096))
        writer.chunk_size = 4096

        # media AU channels protocol thread -> decode threads;
        # payload: (kind, ts_ms, body) or None for per-stream EOS
        v_aus: Optional[Channel] = Channel(64) if ctx.video_channel else None
        a_aus: Optional[Channel] = Channel(512) if ctx.audio_channel else None
        workers = []
        if v_aus is not None:
            t = threading.Thread(
                target=self._video_decode_worker, args=(v_aus, ctx),
                name="rtmp-vdec", daemon=True,
            )
            t.start()
            workers.append(t)
        if a_aus is not None:
            t = threading.Thread(
                target=self._audio_decode_worker, args=(a_aus, ctx),
                name="rtmp-adec", daemon=True,
            )
            t.start()
            workers.append(t)

        conn.settimeout(0.5)
        alive = True
        try:
            while not self._stop.is_set() and alive:
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                for msg in reader.feed(data):
                    if msg.message_type in (COMMAND_AMF0, COMMAND_AMF3):
                        vals = decode_command_message(msg)
                        cmd = vals[0] if vals else None
                        tid = vals[1] if len(vals) > 1 else 0
                        if cmd == "connect":
                            requested_enc = 0.0
                            if len(vals) > 2 and isinstance(vals[2], dict):
                                requested_enc = float(
                                    vals[2].get("objectEncoding", 0.0) or 0.0
                                )
                            send_command(amf0.encode_all(
                                "_result", tid,
                                {"fmsVer": "FMS/3,0,1,123", "capabilities": 31.0},
                                {"level": "status",
                                 "code": "NetConnection.Connect.Success",
                                 "description": "Connection succeeded.",
                                 "objectEncoding": requested_enc},
                            ))
                        elif cmd == "createStream":
                            send_command(amf0.encode_all("_result", tid, None, 1.0))
                        elif cmd == "publish":
                            stream_key = vals[3] if len(vals) > 3 else ""
                            if (
                                self.options.stream_key
                                and stream_key != self.options.stream_key
                            ):
                                send_command(amf0.encode_all(
                                    "onStatus", 0.0, None,
                                    {"level": "error",
                                     "code": "NetStream.Publish.BadName",
                                     "description": "invalid stream key"}),
                                    stream_id=1)
                                alive = False
                                break
                            send_command(amf0.encode_all(
                                "onStatus", 0.0, None,
                                {"level": "status",
                                 "code": "NetStream.Publish.Start",
                                 "description": "Publishing started."}),
                                stream_id=1)
                        elif cmd in ("releaseStream", "FCPublish", "FCUnpublish"):
                            send_command(amf0.encode_all("_result", tid, None, None))
                        elif cmd in ("deleteStream", "closeStream"):
                            alive = False
                            break
                    elif msg.message_type in (DATA_AMF0, DATA_AMF3):
                        # @setDataFrame/onMetaData — informational only
                        try:
                            meta = decode_command_message(msg)
                        except (amf0.Amf0Error, amf3.Amf3Error):
                            meta = []
                        if meta:
                            logger.debug("rtmp data message: %r", meta[0])
                    elif msg.message_type == VIDEO and v_aus is not None:
                        tag = parse_video_tag(msg.payload)
                        if tag is None:
                            continue
                        if ctx.video_meter is not None:
                            ctx.video_meter.add_bytes(len(msg.payload))
                        kind, keyframe, cts, body = tag
                        try:
                            v_aus.send((kind, msg.timestamp + cts, body))
                        except Closed:
                            v_aus = None
                    elif msg.message_type == AUDIO and a_aus is not None:
                        tag = parse_audio_tag(msg.payload)
                        if tag is None:
                            continue
                        if ctx.audio_meter is not None:
                            ctx.audio_meter.add_bytes(len(msg.payload))
                        kind, body = tag
                        try:
                            a_aus.send((kind, msg.timestamp, body))
                        except Closed:
                            a_aus = None
        finally:
            for ch in (v_aus, a_aus):
                if ch is not None:
                    ch.close()
            for t in workers:
                t.join(timeout=10.0)

    def _video_decode_worker(self, aus: Channel, ctx: InputCtx) -> None:
        from smelter_tpu_torch.io.codec import Codec, VideoDecoder

        vch = ctx.video_channel
        assert vch is not None
        vdec: Optional[object] = None

        def pump(dec) -> bool:
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

        # 'avc' is the legacy AVCC path; the rest are enhanced-RTMP FourCCs
        codecs = {"avc": Codec.H264, "hevc": Codec.H265,
                  "av1": Codec.AV1, "vp9": Codec.VP9}
        try:
            while True:
                try:
                    kind, ts_ms, body = aus.recv()
                except Closed:
                    break
                if kind.endswith("_header") and kind.split("_")[0] in codecs:
                    if vdec is not None:
                        vdec.close()
                    vdec = VideoDecoder(Codec(codecs[kind.split("_")[0]]), body)
                elif kind.endswith(("_nalu", "_frame")) and vdec is not None:
                    vdec.send(body, ts_ms / 1000.0)
                    if not pump(vdec):
                        return
            if vdec is not None:
                vdec.send_eof()
                pump(vdec)
        except Exception:
            logger.exception("rtmp video decode failed")
        finally:
            if vdec is not None:
                vdec.close()
            vch.close()

    def _audio_decode_worker(self, aus: Channel, ctx: InputCtx) -> None:
        from smelter_tpu_torch.io.codec import AudioDecoder, Codec

        ach = ctx.audio_channel
        assert ach is not None
        adec: Optional[object] = None

        def pump(dec) -> bool:
            while True:
                s = dec.receive()
                if s is None or s == "eof":
                    return True
                samples, pts = s
                try:
                    ach.send(AudioSamples(samples=samples, start_pts=pts or 0.0))
                except Closed:
                    return False

        try:
            while True:
                try:
                    kind, ts_ms, body = aus.recv()
                except Closed:
                    break
                if kind == "aac_header":
                    if adec is not None:
                        adec.close()
                    adec = AudioDecoder(
                        Codec.AAC, ctx.mixing_sample_rate, 2, extradata=body
                    )
                elif kind == "aac_raw" and adec is not None:
                    adec.send(body, ts_ms / 1000.0)
                    if not pump(adec):
                        return
            if adec is not None:
                adec.send_eof()
                pump(adec)
        except Exception:
            logger.exception("rtmp audio decode failed")
        finally:
            if adec is not None:
                adec.close()
            ach.close()


# ---------------------------------------------------------------------------
# client output
# ---------------------------------------------------------------------------


class RtmpClientOutput(OutputSink):
    """Publishes the pipeline output to an RTMP server
    (reference `rtmp/rtmp_output.rs`). Video encoder must keep parameter sets
    inline (global_header=0) OR provide AnnexB extradata; both are handled."""

    def __init__(self, url: str, timeout: float = 10.0,
                 tls_verify: bool = True) -> None:
        parsed = urllib.parse.urlparse(url)
        if parsed.scheme not in ("rtmp", "rtmps"):
            raise ValueError(
                f'unsupported scheme {parsed.scheme!r}, expected "rtmp" or "rtmps"'
            )
        self.use_tls = parsed.scheme == "rtmps"
        self.tls_verify = tls_verify
        self.host = parsed.hostname or "127.0.0.1"
        self.port = parsed.port or (443 if self.use_tls else 1935)
        path_parts = [p for p in (parsed.path or "").split("/") if p]
        self.app = path_parts[0] if path_parts else "live"
        self.stream_key = "/".join(path_parts[1:]) if len(path_parts) > 1 else "stream"
        self.url = url
        self._lock = threading.Lock()
        self._writer = ChunkWriter(chunk_size=4096)
        self._conn: Optional[socket.socket] = None
        self._video_header_sent = False
        self._audio_header_sent = False
        self._video_extradata = b""
        self._connect(timeout)

    # -- protocol -----------------------------------------------------------------

    def _connect(self, timeout: float) -> None:
        conn = socket.create_connection((self.host, self.port), timeout=timeout)
        conn.settimeout(timeout)
        if self.use_tls:
            from smelter_tpu_torch.io.rtmp.tls import client_context

            conn = client_context(insecure=not self.tls_verify).wrap_socket(
                conn, server_hostname=self.host
            )
        _client_handshake(conn)
        reader = ChunkReader()

        def send_command(payload: bytes, stream_id: int = 0) -> None:
            conn.sendall(self._writer.serialize(
                RtmpMessage(COMMAND_AMF0, 0, stream_id, payload, chunk_stream_id=3)
            ))

        def wait_for(pred, what: str) -> list:
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                try:
                    data = conn.recv(65536)
                except socket.timeout:
                    continue
                if not data:
                    raise ConnectionError(f"peer closed waiting for {what}")
                for msg in reader.feed(data):
                    if msg.message_type in (COMMAND_AMF0, COMMAND_AMF3):
                        vals = decode_command_message(msg)
                        if pred(vals):
                            return vals
            raise TimeoutError(f"timeout waiting for {what}")

        conn.sendall(self._writer.serialize(
            self._writer.set_chunk_size_message(4096)
        ))
        scheme = "rtmps" if self.use_tls else "rtmp"
        tc_url = f"{scheme}://{self.host}:{self.port}/{self.app}"
        send_command(amf0.encode_all(
            "connect", 1.0,
            {"app": self.app, "type": "nonprivate",
             "flashVer": "FMLE/3.0 (compatible; smelter-tpu)", "tcUrl": tc_url},
        ))
        wait_for(lambda v: v and v[0] == "_result", "connect result")
        send_command(amf0.encode_all("releaseStream", 2.0, None, self.stream_key))
        send_command(amf0.encode_all("FCPublish", 3.0, None, self.stream_key))
        send_command(amf0.encode_all("createStream", 4.0, None))
        vals = wait_for(lambda v: v and v[0] == "_result" and len(v) > 3, "createStream")
        self.stream_id = int(vals[3] or 1)
        send_command(amf0.encode_all(
            "publish", 5.0, None, self.stream_key, "live"), stream_id=self.stream_id)
        wait_for(
            lambda v: v and v[0] == "onStatus"
            and any(isinstance(x, dict) and x.get("code") == "NetStream.Publish.Start"
                    for x in v if x),
            "publish start",
        )
        conn.settimeout(timeout)
        self._conn = conn

    def _send_media(self, mtype: int, payload: bytes, ts_ms: int) -> None:
        with self._lock:
            if self._conn is None:
                return
            try:
                self._conn.sendall(self._writer.serialize(
                    RtmpMessage(mtype, max(ts_ms, 0), self.stream_id, payload,
                                chunk_stream_id=4 if mtype == VIDEO else 5)
                ))
            except OSError:
                self._conn = None

    # -- OutputSink ------------------------------------------------------------

    def setup_video(self, opts, extradata, fps_num, fps_den) -> None:
        self._video_extradata = extradata
        enc = getattr(opts, "encoder", None)
        self._video_codec = (getattr(enc, "codec", None) or "h264").lower()

    def setup_audio(self, opts, extradata) -> None:
        if extradata:
            self._send_media(AUDIO, audio_tag(extradata, is_header=True), 0)
            self._audio_header_sent = True

    # enhanced-RTMP publish FourCCs (reference rtmp/src/flv/ ExVideo tags)
    _PUBLISH_FOURCC = {"h265": b"hvc1", "hevc": b"hvc1",
                       "av1": b"av01", "vp9": b"vp09"}

    def write_video_packet(self, pkt) -> None:
        codec = getattr(self, "_video_codec", "h264")
        if codec in self._PUBLISH_FOURCC:
            return self._write_ex_video_packet(pkt, self._PUBLISH_FOURCC[codec])
        # two encoder modes: GLOBAL_HEADER on → avcC extradata + AVCC packets;
        # global_header=0 → AnnexB packets with inline parameter sets
        avcc_mode = self._video_extradata.startswith(b"\x01")
        if not self._video_header_sent:
            if avcc_mode:
                self._send_media(
                    VIDEO,
                    video_tag(self._video_extradata, keyframe=True, is_header=True),
                    0,
                )
                self._video_header_sent = True
            else:
                src = self._video_extradata if self._video_extradata else pkt.data
                sps, pps = extract_parameter_sets(src)
                if sps and pps:
                    self._send_media(
                        VIDEO,
                        video_tag(build_avcc_record(sps, pps), keyframe=True,
                                  is_header=True),
                        0,
                    )
                    self._video_header_sent = True
                elif not pkt.is_keyframe:
                    return  # wait for a keyframe carrying parameter sets
        ts = int(round((pkt.pts_s or 0.0) * 1000.0))
        dts = int(round((pkt.dts_s if pkt.dts_s is not None else pkt.pts_s or 0.0) * 1000.0))
        cts = ts - dts
        body = pkt.data if avcc_mode else annexb_to_avcc(pkt.data)
        self._send_media(
            VIDEO,
            video_tag(body, keyframe=pkt.is_keyframe, cts_ms=cts),
            dts,
        )

    def _write_ex_video_packet(self, pkt, fourcc: bytes) -> None:
        """Enhanced-RTMP publish (reference rtmp/src/flv/ ExVideo):
        SequenceStart once (hvcC for hvc1, sequence-header OBU for av01,
        vpcC for vp09), then CodedFrames (HEVC, with CTS) / CodedFramesX."""
        if not self._video_header_sent:
            config = b""
            if fourcc == b"hvc1":
                from smelter_tpu_torch.io.rtmp.hevc_utils import build_hvcc_record

                src = self._video_extradata or (pkt.data if pkt.is_keyframe else b"")
                try:
                    config = build_hvcc_record(src) if src else b""
                except Exception:
                    config = b""
            elif fourcc == b"av01":
                config = self._video_extradata
                if not config and pkt.is_keyframe:
                    config = extract_av1_sequence_header(pkt.data) or b""
            elif fourcc == b"vp09":
                config = build_vpcc_record()
            if not config:
                return  # wait for a keyframe carrying the config
            self._send_media(VIDEO, ex_video_tag(fourcc, config, True, 0), 0)
            self._video_header_sent = True
        ts = int(round((pkt.pts_s or 0.0) * 1000.0))
        dts = int(round((pkt.dts_s if pkt.dts_s is not None else pkt.pts_s or 0.0) * 1000.0))
        if fourcc == b"hvc1":
            body = annexb_to_avcc(pkt.data)
            tag = ex_video_tag(fourcc, body, pkt.is_keyframe, 1, cts_ms=ts - dts)
        else:
            tag = ex_video_tag(fourcc, pkt.data, pkt.is_keyframe, 3)
        self._send_media(VIDEO, tag, dts)

    def write_audio_packet(self, pkt) -> None:
        if not self._audio_header_sent:
            return
        ts = int(round((pkt.pts_s or 0.0) * 1000.0))
        self._send_media(AUDIO, audio_tag(pkt.data), ts)

    def on_done(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None
