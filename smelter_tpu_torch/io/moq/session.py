"""MoQ session: broadcasts, tracks, group delivery over one QUIC connection.

Mirrors the reference's session semantics (`moq/server.rs` accept loop,
`input/connection.rs` broadcast/track consumption, `output/client_output.rs`
broadcast publication): a session carries one announced broadcast; the
subscriber subscribes to named tracks; media flows as groups, each group a
QUIC unidirectional stream started by a keyframe (audio: one group per
frame, matching `client_output.rs` finish_group per audio frame).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from smelter_tpu_torch.io.moq import wire
from smelter_tpu_torch.io.quic.endpoint import QuicConnectionHandle

logger = logging.getLogger("smelter.moq")


@dataclass
class TrackFrame:
    group_seq: int
    timestamp_us: int
    keyframe: bool
    payload: bytes


class TrackConsumer:
    """Subscriber-side handle for one track: ordered frame queue."""

    def __init__(self, name: str, subscribe_id: int) -> None:
        self.name = name
        self.subscribe_id = subscribe_id
        self.frames: "queue.Queue[Optional[TrackFrame]]" = queue.Queue()
        self.accepted = threading.Event()
        self.error: Optional[str] = None
        self._closed = False

    def read(self, timeout: Optional[float] = None) -> Optional[TrackFrame]:
        """Next frame; None on timeout or at end of track/session (check
        `_closed`/`session_dead` to distinguish)."""
        if self._closed:
            return None
        try:
            item = self.frames.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is None:
            self._closed = True
        return item


class TrackProducer:
    """Publisher-side handle: groups map to uni streams."""

    def __init__(self, session: "MoqSession", subscribe_id: int) -> None:
        self._session = session
        self.subscribe_id = subscribe_id
        self._group_seq = -1
        self._stream_id: Optional[int] = None

    def write(self, timestamp_us: int, keyframe: bool, payload: bytes,
              new_group: bool) -> None:
        h = self._session.handle
        if new_group or self._stream_id is None:
            self.finish_group()
            self._group_seq += 1
            self._stream_id = h.open_stream(bidi=False)
            h.send_stream(
                self._stream_id,
                wire.group_header(self.subscribe_id, self._group_seq),
            )
        h.send_stream(self._stream_id, wire.frame(timestamp_us, keyframe, payload))

    # one QUIC datagram must fit a UDP packet after QUIC overhead
    MAX_DATAGRAM_PAYLOAD = 1100

    def write_datagram(self, timestamp_us: int, keyframe: bool,
                       payload: bytes, new_group: bool = False) -> bool:
        """Low-latency delivery: send the object as an unreliable QUIC
        DATAGRAM (no stream head-of-line blocking; lost = gone, like RTP
        over UDP). Returns False when the payload exceeds one datagram —
        the caller should fall back to `write()` (reliable stream). Suits
        audio frames and other sub-MTU objects."""
        if len(payload) > self.MAX_DATAGRAM_PAYLOAD:
            return False
        if new_group or self._group_seq < 0:
            self._group_seq += 1
        self._session.handle.send_datagram(wire.object_datagram(
            self.subscribe_id, self._group_seq, timestamp_us, keyframe,
            payload,
        ))
        return True

    def finish_group(self) -> None:
        if self._stream_id is not None:
            self._session.handle.send_stream(self._stream_id, b"", fin=True)
            self._stream_id = None

    def finish(self) -> None:
        self.finish_group()


class MoqSession:
    """One MoQ session over an established QuicConnectionHandle.

    Role-agnostic: either side may publish (announce + serve subscribes) or
    subscribe. The owner drives it by callbacks:
      on_announce(path), on_subscribe(track_name) -> bool (publisher side),
      on_closed().
    """

    def __init__(self, handle: QuicConnectionHandle,
                 is_quic_client: bool) -> None:
        self.handle = handle
        self.is_quic_client = is_quic_client
        self.control_stream: Optional[int] = None
        self.setup_done = threading.Event()
        self.setup_error: Optional[str] = None
        self.announced: "queue.Queue[str]" = queue.Queue()
        self.on_subscribe: Optional[Callable[[str, int], bool]] = None
        self.on_closed: Optional[Callable[[], None]] = None
        self.closed = threading.Event()
        self.path = ""
        self.token = ""
        self._parser = wire.ControlParser()
        self._groups: Dict[int, wire.GroupParser] = {}
        self._consumers: Dict[int, TrackConsumer] = {}
        self._consumers_by_name: Dict[str, TrackConsumer] = {}
        self._producers: Dict[int, TrackProducer] = {}
        self._next_subscribe_id = 0
        self._lock = threading.Lock()
        self._on_setup: Optional[Callable[["MoqSession"], bool]] = None
        self._thread = threading.Thread(
            target=self._run, name="moq-session", daemon=True
        )

    # -- establishment ---------------------------------------------------------

    def start_client(self, path: str, token: str = "") -> None:
        """QUIC client side: open the control stream and SETUP."""
        self.control_stream = self.handle.open_stream(bidi=True)
        self.handle.send_stream(self.control_stream, wire.setup(path, token))
        self._thread.start()

    def start_server(self, on_setup: Callable[["MoqSession"], bool]) -> None:
        """QUIC server side: wait for SETUP; `on_setup` validates
        path/token (reference server.rs handle_incoming_connection)."""
        self._on_setup = on_setup
        self._thread.start()

    def wait_setup(self, timeout: float = 10.0) -> None:
        if not self.setup_done.wait(timeout=timeout):
            raise TimeoutError("MoQ SETUP timed out")
        if self.setup_error:
            raise ConnectionError(f"MoQ setup failed: {self.setup_error}")

    # -- publisher API -----------------------------------------------------------

    def announce(self, path: str) -> None:
        assert self.control_stream is not None
        self.handle.send_stream(self.control_stream, wire.announce(path))

    # -- subscriber API ------------------------------------------------------------

    def subscribe_track(self, name: str, timeout: float = 10.0) -> TrackConsumer:
        with self._lock:
            sid = self._next_subscribe_id
            self._next_subscribe_id += 1
            consumer = TrackConsumer(name, sid)
            self._consumers[sid] = consumer
            self._consumers_by_name[name] = consumer
        assert self.control_stream is not None
        self.handle.send_stream(self.control_stream, wire.subscribe(sid, name))
        if not consumer.accepted.wait(timeout=timeout):
            raise TimeoutError(f"subscribe to {name!r} timed out")
        if consumer.error:
            raise ConnectionError(f"subscribe to {name!r}: {consumer.error}")
        return consumer

    def next_announce(self, timeout: float = 10.0) -> Optional[str]:
        try:
            return self.announced.get(timeout=timeout)
        except queue.Empty:
            return None

    def close(self) -> None:
        self.handle.close()
        self.closed.set()

    # -- event loop -----------------------------------------------------------------

    def _run(self) -> None:
        try:
            while not self.closed.is_set():
                ev = self.handle.recv_event(timeout=0.25)
                if ev is None:
                    if self.handle.closed.is_set():
                        break
                    continue
                self._dispatch(ev)
        except Exception:
            logger.exception("MoQ session loop failed")
        finally:
            self.closed.set()
            for consumer in list(self._consumers.values()):
                consumer.frames.put(None)
            if self.on_closed:
                try:
                    self.on_closed()
                except Exception:
                    logger.exception("on_closed failed")

    def _dispatch(self, ev) -> None:
        sid = ev.stream_id
        if sid == -1:
            # datagram track mode: self-contained low-latency objects
            parsed = wire.parse_object_datagram(ev.data)
            if parsed is not None:
                dsid, seq, f = parsed
                consumer = self._consumers.get(dsid)
                if consumer is not None:
                    consumer.frames.put(TrackFrame(
                        seq, f.timestamp_us, f.keyframe, f.payload,
                    ))
            return
        # control stream: the FIRST bidi stream the client opens, which is
        # QUIC stream id 0 by numbering (client-bidi ids are 0,4,8,...).
        # Pinning to id 0 (not "first bidi stream seen") keeps a reordered
        # data stream from being mistaken for control.
        if self.control_stream is None and sid == 0 and not self.is_quic_client:
            self.control_stream = sid
        if sid == self.control_stream:
            for m in self._parser.feed(ev.data):
                self._control(m)
            return
        # group (uni) stream
        parser = self._groups.get(sid)
        if parser is None:
            parser = wire.GroupParser()
            self._groups[sid] = parser
        frames = parser.feed(ev.data)
        if parser.subscribe_id is not None:
            consumer = self._consumers.get(parser.subscribe_id)
            if consumer is not None:
                for f in frames:
                    consumer.frames.put(TrackFrame(
                        parser.group_seq or 0, f.timestamp_us, f.keyframe,
                        f.payload,
                    ))
        if ev.fin:
            self._groups.pop(sid, None)

    def _control(self, m: wire.ControlMessage) -> None:
        r = wire.Reader(m.body)
        if m.mtype == wire.MSG_SETUP:
            version = r.u8()
            self.path = r.string()
            self.token = r.string()
            ok = True
            if self._on_setup is not None:
                try:
                    ok = self._on_setup(self)
                except Exception:
                    logger.exception("on_setup failed")
                    ok = False
            assert self.control_stream is not None
            if ok and version == wire.VERSION:
                self.handle.send_stream(self.control_stream, wire.setup_ok())
                self.setup_done.set()
            else:
                self.handle.send_stream(
                    self.control_stream,
                    wire.setup_error(401, "unauthorized or bad version"),
                )
                self.setup_error = "rejected"
                self.setup_done.set()
                self.handle.close(error_code=401)
        elif m.mtype == wire.MSG_SETUP_OK:
            self.setup_done.set()
        elif m.mtype == wire.MSG_SETUP_ERROR:
            code = r.varint()
            self.setup_error = f"{code}: {r.string()}"
            self.setup_done.set()
        elif m.mtype == wire.MSG_ANNOUNCE:
            self.announced.put(r.string())
        elif m.mtype == wire.MSG_UNANNOUNCE:
            r.string()
        elif m.mtype == wire.MSG_SUBSCRIBE:
            sub_id = r.varint()
            track = r.string()
            accept = False
            if self.on_subscribe is not None:
                try:
                    accept = self.on_subscribe(track, sub_id)
                except Exception:
                    logger.exception("on_subscribe failed")
            assert self.control_stream is not None
            if accept:
                self.handle.send_stream(self.control_stream,
                                        wire.subscribe_ok(sub_id))
            else:
                self.handle.send_stream(
                    self.control_stream,
                    wire.subscribe_error(sub_id, 404, "no such track"),
                )
        elif m.mtype == wire.MSG_SUBSCRIBE_OK:
            sub_id = r.varint()
            consumer = self._consumers.get(sub_id)
            if consumer is not None:
                consumer.accepted.set()
        elif m.mtype == wire.MSG_SUBSCRIBE_ERROR:
            sub_id = r.varint()
            code = r.varint()
            reason = r.string()
            consumer = self._consumers.get(sub_id)
            if consumer is not None:
                consumer.error = f"{code}: {reason}"
                consumer.accepted.set()

    def producer_for(self, subscribe_id: int) -> TrackProducer:
        prod = self._producers.get(subscribe_id)
        if prod is None:
            prod = TrackProducer(self, subscribe_id)
            self._producers[subscribe_id] = prod
        return prod
