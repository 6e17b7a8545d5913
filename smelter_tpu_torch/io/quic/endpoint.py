"""Threaded UDP endpoints driving QuicConnection state machines.

Server demuxes datagrams to connections by destination CID (our 8-byte
scid) and accepts new connections on unknown-DCID Initials; the client
drives a single connection. Both run one receive thread with a short
socket timeout that doubles as the timer pump. The application reads
ordered stream events from a thread-safe queue per connection.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import queue
import socket
import struct
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from smelter_tpu_torch.io.quic import packet as pkt
from smelter_tpu_torch.io.quic.connection import QuicConnection, QuicStreamEvent

logger = logging.getLogger("smelter.quic")


class QuicConnectionHandle:
    """Thread-safe facade over one QuicConnection."""

    def __init__(self, conn: QuicConnection, endpoint: "_EndpointBase",
                 addr: Tuple[str, int]) -> None:
        self._conn = conn
        self._endpoint = endpoint
        self.addr = addr
        self.events: "queue.Queue[QuicStreamEvent]" = queue.Queue()
        self.established = threading.Event()
        self.closed = threading.Event()
        conn.on_established = self.established.set

    @property
    def alpn(self) -> Optional[str]:
        return self._conn.tls.negotiated_alpn

    def open_stream(self, bidi: bool = True) -> int:
        with self._endpoint._lock:
            return self._conn.open_stream(bidi)

    def send_stream(self, stream_id: int, data: bytes, fin: bool = False) -> None:
        with self._endpoint._lock:
            self._conn.send_stream_data(stream_id, data, fin)
        self._endpoint.wake()

    def send_datagram(self, data: bytes) -> None:
        with self._endpoint._lock:
            self._conn.send_datagram(data)
        self._endpoint.wake()

    def close(self, error_code: int = 0, reason: bytes = b"") -> None:
        with self._endpoint._lock:
            self._conn.close(error_code, reason)
        self._endpoint.wake()

    def recv_event(self, timeout: Optional[float] = None) -> Optional[QuicStreamEvent]:
        try:
            return self.events.get(timeout=timeout)
        except queue.Empty:
            return None


class _EndpointBase:
    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.sock.settimeout(0.01)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def wake(self) -> None:
        """Interrupt the blocking recvfrom so queued data sends NOW instead
        of at the next 10 ms poll — matters for MoQ, a low-latency
        protocol. A zero-byte datagram to our own socket is ignored by the
        dispatchers but unblocks the loop."""
        try:
            self.sock.sendto(b"", ("127.0.0.1", self.sock.getsockname()[1]))
        except OSError:
            pass

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, name="quic-endpoint",
                                        daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        try:
            self.sock.close()
        except OSError:
            pass

    # subclass interface
    def _run(self) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def _sendto(self, data: bytes, addr: Tuple[str, int]) -> None:
        """Single egress point (tests inject loss here)."""
        try:
            self.sock.sendto(data, addr)
        except OSError:
            pass

    def _pump_connection(self, handle: QuicConnectionHandle, now: float) -> None:
        conn = handle._conn
        conn.maybe_keepalive(now)
        timer = conn.next_timer()
        if timer is not None and now >= timer:
            conn.handle_timer(now)
        for dgram in conn.datagrams_to_send(now):
            self._sendto(dgram, handle.addr)
        while True:
            ev = conn.poll_event()
            if ev is None:
                break
            handle.events.put(ev)
        if conn.closed and not handle.closed.is_set():
            handle.closed.set()


class QuicClient(_EndpointBase):
    """One outbound QUIC connection."""

    def __init__(self, host: str, port: int, alpn: List[str],
                 server_name: Optional[str] = None,
                 verify_peer: bool = False) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("0.0.0.0", 0))
        super().__init__(sock)
        addr = (socket.gethostbyname(host), port)
        self.conn = QuicConnection(
            is_client=True, alpn=alpn, server_name=server_name or host,
            verify_peer=verify_peer,
        )
        self.handle = QuicConnectionHandle(self.conn, self, addr)

    def connect(self, timeout: float = 10.0) -> QuicConnectionHandle:
        self.start()
        if not self.handle.established.wait(timeout=timeout):
            self.close()
            raise ConnectionError("QUIC handshake timed out")
        return self.handle

    def _run(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                self._pump_connection(self.handle, now)
                if self.conn.closed:
                    self.handle.closed.set()
                    break
            try:
                data, addr = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            with self._lock:
                try:
                    self.conn.receive_datagram(data, time.monotonic())
                except Exception:
                    logger.exception("dropping datagram that broke receive")


class QuicServer(_EndpointBase):
    """Accepts QUIC connections; hands each to `on_connection`.

    With ``require_retry`` (RFC 9000 §8.1 address validation, quinn's
    ``use_retry`` equivalent for public deployments), a token-less Initial
    is answered with a Retry packet carrying an HMAC-sealed token binding
    (client address, ODCID, the Retry SCID we minted, a timestamp); only
    an Initial echoing a valid, fresh token from the same address creates
    connection state — a spoofed-source Initial costs the server one
    stateless datagram instead of a TLS handshake."""

    TOKEN_LIFETIME = 30.0  # seconds a retry token stays valid

    def __init__(self, port: int, cert_der: bytes, key_pem: bytes,
                 alpn: List[str],
                 on_connection: Callable[[QuicConnectionHandle], None],
                 require_retry: bool = False) -> None:
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sock.bind(("0.0.0.0", port))
        super().__init__(sock)
        self.port = sock.getsockname()[1]
        self.cert_der = cert_der
        self.key_pem = key_pem
        self.alpn = alpn
        self.on_connection = on_connection
        self.require_retry = require_retry
        self._token_key = os.urandom(32)
        self._by_scid: Dict[bytes, QuicConnectionHandle] = {}
        self._by_addr: Dict[Tuple[str, int], QuicConnectionHandle] = {}

    # -- retry tokens (stateless; HMAC-SHA256 over addr-bound context) -------

    def _mint_token(self, addr: Tuple[str, int], odcid: bytes,
                    retry_scid: bytes, now: float) -> bytes:
        body = (
            struct.pack("!d", now)
            + bytes([len(odcid)]) + odcid
            + bytes([len(retry_scid)]) + retry_scid
        )
        mac = hmac.new(
            self._token_key, body + repr(addr).encode(), hashlib.sha256
        ).digest()
        return body + mac

    def _check_token(self, addr: Tuple[str, int], token: bytes,
                     now: float) -> Optional[Tuple[bytes, bytes]]:
        """-> (odcid, retry_scid) if the token is authentic, address-bound
        and fresh; None otherwise."""
        if len(token) < 8 + 2 + 32:
            return None
        body, mac = token[:-32], token[-32:]
        expect = hmac.new(
            self._token_key, body + repr(addr).encode(), hashlib.sha256
        ).digest()
        if not hmac.compare_digest(mac, expect):
            return None
        (ts,) = struct.unpack("!d", body[:8])
        if not (now - self.TOKEN_LIFETIME <= ts <= now + 1.0):
            return None
        pos = 8
        ol = body[pos]; pos += 1
        odcid = body[pos : pos + ol]; pos += ol
        if pos >= len(body) or len(odcid) != ol:
            return None
        rl = body[pos]; pos += 1
        retry_scid = body[pos : pos + rl]; pos += rl
        if len(retry_scid) != rl or pos != len(body):
            return None
        return odcid, retry_scid

    def _send_retry(self, hdr: pkt.LongHeader, addr: Tuple[str, int],
                    now: float) -> None:
        retry_scid = os.urandom(8)
        token = self._mint_token(addr, hdr.dcid, retry_scid, now)
        self._sendto(
            pkt.build_retry(pkt.QUIC_V1, dcid=hdr.scid, scid=retry_scid,
                            token=token, odcid=hdr.dcid),
            addr,
        )

    def _run(self) -> None:
        while not self._stop.is_set():
            now = time.monotonic()
            with self._lock:
                dead = []
                for scid, handle in self._by_scid.items():
                    self._pump_connection(handle, now)
                    if handle._conn.closed:
                        handle.closed.set()
                        dead.append((scid, handle.addr))
                for scid, addr in dead:
                    self._by_scid.pop(scid, None)
                    self._by_addr.pop(addr, None)
            try:
                data, addr = self.sock.recvfrom(65535)
            except socket.timeout:
                continue
            except OSError:
                break
            with self._lock:
                try:
                    self._dispatch(data, addr, time.monotonic())
                except Exception:
                    # a hostile/truncated datagram must never take down the
                    # server thread (it serves every connection)
                    logger.exception("dropping datagram that broke dispatch")

    def _dispatch(self, data: bytes, addr: Tuple[str, int], now: float) -> None:
        handle: Optional[QuicConnectionHandle] = None
        if data and (data[0] & 0x80):
            try:
                hdr, _ = pkt.parse_long_header_prefix(data)
            except ValueError:
                return
            handle = self._by_scid.get(hdr.dcid) or self._by_addr.get(addr)
            if handle is None and hdr.packet_type == pkt.PKT_INITIAL \
                    and hdr.version == pkt.QUIC_V1 and len(data) >= 1200:
                odcid, retry_scid = hdr.dcid, None
                if self.require_retry:
                    if not hdr.token:
                        self._send_retry(hdr, addr, now)
                        return
                    valid = self._check_token(addr, hdr.token, now)
                    if valid is None or valid[1] != hdr.dcid:
                        # forged / stale / replayed-from-elsewhere token:
                        # drop statelessly (RFC 9000 §8.1.3 allows discard)
                        logger.warning("dropping Initial with bad retry "
                                       "token from %s", addr)
                        return
                    odcid, retry_scid = valid
                conn = QuicConnection(
                    is_client=False, odcid=odcid, alpn=self.alpn,
                    cert_der=self.cert_der, key_pem=self.key_pem,
                    retry_scid=retry_scid,
                )
                handle = QuicConnectionHandle(conn, self, addr)
                self._by_scid[conn.scid] = handle
                self._by_addr[addr] = handle
                try:
                    self.on_connection(handle)
                except Exception:
                    logger.exception("on_connection callback failed")
        else:
            # short header: dcid is the first 8 bytes after the flags
            handle = self._by_scid.get(data[1:9]) or self._by_addr.get(addr)
        if handle is None:
            return
        handle.addr = addr
        handle._conn.receive_datagram(data, now)
