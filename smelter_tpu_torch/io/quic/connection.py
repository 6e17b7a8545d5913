"""QUIC v1 connection state machine (sans-io core).

One `QuicConnection` owns: three packet-number spaces (Initial/Handshake/
1-RTT) with their protection keys, the TLS session, streams with flow
control, ACK tracking and PTO loss recovery. It is sans-io: feed datagrams
with `receive_datagram(data, now)`, collect outbound datagrams from
`datagrams_to_send(now)`, and drive timers via `next_timer()` +
`handle_timer(now)` — the endpoint (`endpoint.py`) does the socket work.

Recovery (RFC 9002 subset): ack-eliciting packets are tracked per space;
acked ranges retire them; a PTO (smoothed-RTT based, exponential backoff)
retransmits the frames of the oldest unacked packet. Packet-threshold loss
(3 reordering) also retransmits. CRYPTO and STREAM payloads are
re-emitted from their send buffers, so retransmission is loss-safe even
if individual packets are dropped repeatedly.
"""

from __future__ import annotations

import os
import struct
import time
from collections import deque

from cryptography.exceptions import InvalidTag
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple

from smelter_tpu_torch.io.quic import packet as pkt
from smelter_tpu_torch.io.quic.crypto import PacketProtection, initial_secrets
from smelter_tpu_torch.io.quic.tls import (
    EPOCH_1RTT,
    EPOCH_HANDSHAKE,
    EPOCH_INITIAL,
    TlsError,
    TlsSession,
)

MAX_DATAGRAM = 1200
PACKET_THRESHOLD = 3
GRANULARITY = 0.001
INITIAL_RTT = 0.1

SPACE_INITIAL = 0
SPACE_HANDSHAKE = 1
SPACE_APP = 2

_EPOCH_TO_SPACE = {EPOCH_INITIAL: SPACE_INITIAL, EPOCH_HANDSHAKE: SPACE_HANDSHAKE,
                   EPOCH_1RTT: SPACE_APP}


class QuicError(Exception):
    pass


@dataclass
class QuicStreamEvent:
    """Delivered to the application: ordered stream data or datagram."""

    stream_id: int
    data: bytes
    fin: bool


@dataclass
class _SentPacket:
    pn: int
    time_sent: float
    ack_eliciting: bool
    in_flight: bool
    size: int
    # enough info to retransmit: crypto ranges and stream ranges
    crypto: List[Tuple[int, int]] = field(default_factory=list)  # (off, len)
    streams: List[Tuple[int, int, int, bool]] = field(default_factory=list)
    # (sid, off, len, fin)
    handshake_done: bool = False
    max_data: Optional[int] = None
    max_stream_data: List[Tuple[int, int]] = field(default_factory=list)


class _SendBuffer:
    """Reliable byte stream out: data queued, unacked ranges resendable."""

    def __init__(self) -> None:
        self.data = bytearray()
        self.base = 0                       # offset of data[0]
        self.next_send = 0                  # next new offset to send
        self.acked_ranges: List[Tuple[int, int]] = []
        self.retransmit: Deque[Tuple[int, int]] = deque()  # (off, len)
        self.fin_offset: Optional[int] = None
        self.fin_sent = False
        self.fin_acked = False
        self.blocked = False

    def write(self, data: bytes) -> None:
        self.data += data

    @property
    def end(self) -> int:
        return self.base + len(self.data)

    def pending(self) -> bool:
        return bool(self.retransmit) or self.next_send < self.end or (
            self.fin_offset is not None and not self.fin_sent
        )

    def take(self, max_len: int, flow_limit: int) -> Optional[Tuple[int, bytes, bool]]:
        """-> (offset, data, fin) respecting flow control for NEW data."""
        if self.retransmit:
            off, ln = self.retransmit.popleft()
            take = min(ln, max_len)
            if take < ln:
                self.retransmit.appendleft((off + take, ln - take))
            chunk = bytes(self.data[off - self.base : off - self.base + take])
            fin = (self.fin_offset is not None
                   and off + take == self.fin_offset)
            return off, chunk, fin
        if self.next_send < self.end:
            limit = min(self.end, flow_limit)
            if self.next_send >= limit:
                self.blocked = True
                return None
            take = min(limit - self.next_send, max_len)
            off = self.next_send
            chunk = bytes(self.data[off - self.base : off - self.base + take])
            self.next_send += take
            fin = (self.fin_offset is not None and self.next_send == self.fin_offset)
            if fin:
                self.fin_sent = True
            return off, chunk, fin
        if self.fin_offset is not None and not self.fin_sent:
            self.fin_sent = True
            return self.next_send, b"", True
        return None

    def on_ack(self, off: int, ln: int, fin: bool) -> None:
        if fin:
            self.fin_acked = True
        # drop fully-acked prefix from memory
        self.acked_ranges.append((off, off + ln))
        self.acked_ranges.sort()
        merged: List[Tuple[int, int]] = []
        for lo, hi in self.acked_ranges:
            if merged and lo <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(hi, merged[-1][1]))
            else:
                merged.append((lo, hi))
        self.acked_ranges = merged
        while self.acked_ranges and self.acked_ranges[0][0] <= self.base:
            hi = self.acked_ranges[0][1]
            if hi <= self.base:
                self.acked_ranges.pop(0)
                continue
            cut = min(hi, self.base + len(self.data)) - self.base
            del self.data[:cut]
            self.base += cut
            if self.acked_ranges[0][1] <= self.base:
                self.acked_ranges.pop(0)
            break

    def on_loss(self, off: int, ln: int) -> None:
        # skip already-acked spans
        spans = [(off, off + ln)]
        for lo, hi in self.acked_ranges:
            nxt = []
            for s0, s1 in spans:
                if hi <= s0 or lo >= s1:
                    nxt.append((s0, s1))
                    continue
                if s0 < lo:
                    nxt.append((s0, lo))
                if hi < s1:
                    nxt.append((hi, s1))
            spans = nxt
        for s0, s1 in spans:
            if s1 > s0:
                self.retransmit.append((s0, s1 - s0))


class _RecvBuffer:
    """Reliable byte stream in: reorder, deliver in order."""

    def __init__(self) -> None:
        self.delivered = 0
        self.chunks: Dict[int, bytes] = {}
        self.fin_at: Optional[int] = None
        self.fin_delivered = False

    def insert(self, off: int, data: bytes, fin: bool) -> List[bytes]:
        if fin:
            self.fin_at = off + len(data)
        if data and off + len(data) > self.delivered:
            self.chunks[off] = data
        out: List[bytes] = []
        while True:
            # find a chunk covering `delivered`
            found = None
            for o, d in self.chunks.items():
                if o <= self.delivered < o + len(d):
                    found = (o, d)
                    break
                if o == self.delivered and not d:
                    found = (o, d)
                    break
            if found is None:
                break
            o, d = found
            del self.chunks[o]
            piece = d[self.delivered - o :]
            if piece:
                out.append(piece)
                self.delivered += len(piece)
        return out

    @property
    def fin_ready(self) -> bool:
        return (self.fin_at is not None and self.delivered >= self.fin_at
                and not self.fin_delivered)


class _Space:
    """One packet-number space."""

    def __init__(self) -> None:
        self.protection = PacketProtection()
        self.next_pn = 0
        self.largest_acked = -1
        self.largest_received = -1
        self.received: Set[int] = set()
        self.ack_needed = False
        self.ack_time: Optional[float] = None
        self.sent: Dict[int, _SentPacket] = {}
        self.crypto_send = _SendBuffer()
        self.crypto_recv = _RecvBuffer()
        self.loss_time: Optional[float] = None
        self.discarded = False

    def ack_ranges(self) -> List[Tuple[int, int]]:
        if not self.received:
            return []
        nums = sorted(self.received, reverse=True)
        ranges: List[Tuple[int, int]] = []
        hi = lo = nums[0]
        for n in nums[1:]:
            if n == lo - 1:
                lo = n
            else:
                ranges.append((lo, hi))
                hi = lo = n
        ranges.append((lo, hi))
        return ranges


class _Stream:
    def __init__(self, stream_id: int, max_stream_data_local: int,
                 max_stream_data_remote: int) -> None:
        self.stream_id = stream_id
        self.send = _SendBuffer()
        self.recv = _RecvBuffer()
        self.max_stream_data_local = max_stream_data_local   # we allow peer
        self.max_stream_data_remote = max_stream_data_remote  # peer allows us
        self.recv_highest = 0
        self.reset_received = False
        self.stop_sending = False


class QuicConnection:
    """See module docstring. Thread-unsafe: callers hold their own lock
    (endpoint.py serializes on the socket loop)."""

    def __init__(
        self,
        is_client: bool,
        odcid: Optional[bytes] = None,
        alpn: Optional[List[str]] = None,
        server_name: Optional[str] = None,
        cert_der: Optional[bytes] = None,
        key_pem: Optional[bytes] = None,
        transport_params: Optional[pkt.TransportParams] = None,
        verify_peer: bool = False,
        retry_scid: Optional[bytes] = None,
    ) -> None:
        self.is_client = is_client
        self.scid = os.urandom(8)
        self.dcid = os.urandom(8) if is_client else None  # set on first packet
        self.original_dcid = self.dcid if is_client else odcid
        self.local_params = transport_params or pkt.TransportParams()
        self.local_params.initial_scid = self.scid
        if not is_client:
            self.local_params.original_dcid = odcid
            # server resumed after a Retry: odcid is recovered from the
            # validated token; Initial keys derive from the CID we minted in
            # the Retry (= the client's new DCID, RFC 9001 §5.2), and the
            # retry_source_connection_id transport param authenticates the
            # Retry to the client (RFC 9000 §7.3)
            if retry_scid is not None:
                self.local_params.retry_scid = retry_scid
        # the token the client must echo in every Initial after a Retry
        self._initial_token = b""
        self._retry_source_cid: Optional[bytes] = None
        self.peer_params = pkt.TransportParams()
        self.spaces = [_Space(), _Space(), _Space()]
        initial_cid = retry_scid if retry_scid is not None else self.original_dcid
        tx, rx = initial_secrets(initial_cid, is_client)
        self.spaces[SPACE_INITIAL].protection.set_tx(tx)
        self.spaces[SPACE_INITIAL].protection.set_rx(rx)
        self.handshake_confirmed = False
        self.established = False
        self.closed = False
        self.close_error: Optional[Tuple[int, bytes]] = None
        self._close_frame: Optional[bytes] = None
        self._close_sent = 0
        self.streams: Dict[int, _Stream] = {}
        self.events: Deque[object] = deque()
        self._next_stream_bidi = 0 if is_client else 1
        self._next_stream_uni = 2 if is_client else 3
        self.max_data_local = self.local_params.initial_max_data
        self.max_data_remote = 0  # learned from peer params
        self.data_sent = 0
        self.data_received = 0
        self.data_delivered = 0
        self.datagrams_out: Deque[bytes] = deque()
        # recovery state
        self.smoothed_rtt = INITIAL_RTT
        self.rttvar = INITIAL_RTT / 2
        self.min_rtt = INITIAL_RTT
        self.latest_rtt = 0.0
        self.pto_count = 0
        self._pending_ping = False
        self.peer_max_streams_bidi = 0
        self.peer_max_streams_uni = 0
        self.local_max_streams_bidi = self.local_params.initial_max_streams_bidi
        self.local_max_streams_uni = self.local_params.initial_max_streams_uni
        self._anti_amp_budget = 0  # server: 3x received before validated
        # a validated Retry token proves the address (RFC 9000 §8.1.2)
        self._address_validated = is_client or retry_scid is not None
        self.idle_timeout = self.local_params.max_idle_timeout_ms / 1000.0
        self.last_activity = time.monotonic()
        self.on_established: Optional[Callable[[], None]] = None

        self.tls = TlsSession(
            is_client,
            alpn or [],
            pkt.encode_transport_params(self.local_params),
            server_name=server_name,
            cert_der=cert_der,
            key_pem=key_pem,
            verify_peer=verify_peer,
        )
        self.tls.on_handshake_secrets = self._install_handshake_secrets
        self.tls.on_app_secrets = self._install_app_secrets
        self.tls.on_handshake_complete = self._on_tls_complete
        if is_client:
            self._flush_tls()

    # -- TLS plumbing ----------------------------------------------------------

    def _flush_tls(self) -> None:
        for out in self.tls.take_outputs():
            space = _EPOCH_TO_SPACE[out.epoch]
            self.spaces[space].crypto_send.write(out.data)

    def _install_handshake_secrets(self, tx: bytes, rx: bytes) -> None:
        self.spaces[SPACE_HANDSHAKE].protection.set_tx(tx)
        self.spaces[SPACE_HANDSHAKE].protection.set_rx(rx)

    def _install_app_secrets(self, tx: bytes, rx: bytes) -> None:
        self.spaces[SPACE_APP].protection.set_tx(tx)
        self.spaces[SPACE_APP].protection.set_rx(rx)

    def _on_tls_complete(self) -> None:
        if self.tls.peer_transport_params:
            self.peer_params = pkt.decode_transport_params(
                self.tls.peer_transport_params
            )
        # authenticate the CIDs used during the handshake (RFC 9000 §7.3):
        # the server must echo our original DCID, and — if a Retry happened —
        # the exact SCID it sent in the Retry. A MITM that injected a Retry
        # or rewrote Initials fails here.
        if self.is_client and self.tls.peer_transport_params:
            if self.peer_params.original_dcid != self.original_dcid or (
                self.peer_params.retry_scid != self._retry_source_cid
            ):
                self._close_frame = pkt.encode_connection_close(
                    0x08, 0x00, b"transport parameter cid mismatch"
                )
                return
        self.established = True
        if self.tls.peer_transport_params:
            self.max_data_remote = self.peer_params.initial_max_data
            self.peer_max_streams_bidi = self.peer_params.initial_max_streams_bidi
            self.peer_max_streams_uni = self.peer_params.initial_max_streams_uni
            if self.peer_params.max_idle_timeout_ms:
                self.idle_timeout = min(
                    self.idle_timeout,
                    self.peer_params.max_idle_timeout_ms / 1000.0,
                ) if self.idle_timeout else self.peer_params.max_idle_timeout_ms / 1000.0
        if not self.is_client:
            # server: handshake complete → HANDSHAKE_DONE + confirm
            self.handshake_confirmed = True
            self._pending_handshake_done = True
            self._discard_space(SPACE_INITIAL)
            self._discard_space(SPACE_HANDSHAKE)
        if self.on_established:
            self.on_established()

    # -- streams API ------------------------------------------------------------

    def open_stream(self, bidi: bool = True) -> int:
        if bidi:
            sid = self._next_stream_bidi
            self._next_stream_bidi += 4
        else:
            sid = self._next_stream_uni
            self._next_stream_uni += 4
        self._get_stream(sid)
        return sid

    def _get_stream(self, sid: int) -> _Stream:
        st = self.streams.get(sid)
        if st is None:
            st = _Stream(
                sid,
                self.local_params.initial_max_stream_data,
                self.peer_params.initial_max_stream_data
                or self.local_params.initial_max_stream_data,
            )
            self.streams[sid] = st
        return st

    def send_stream_data(self, sid: int, data: bytes, fin: bool = False) -> None:
        st = self._get_stream(sid)
        st.send.write(data)
        if fin:
            st.send.fin_offset = st.send.end

    def send_datagram(self, data: bytes) -> None:
        self.datagrams_out.append(data)

    def close(self, error_code: int = 0, reason: bytes = b"") -> None:
        if self._close_frame is None:
            self._close_frame = pkt.encode_connection_close(error_code, None, reason)

    # -- inbound -----------------------------------------------------------------

    def receive_datagram(self, data: bytes, now: float) -> None:
        if self.closed:
            return
        self.last_activity = now
        if not self._address_validated:
            self._anti_amp_budget += 3 * len(data)
        pos = 0
        while pos < len(data):
            remaining = data[pos:]
            if not remaining or remaining[0] == 0:
                break  # padding
            try:
                consumed = self._receive_packet(remaining, now)
            except (ValueError, KeyError, IndexError, struct.error,
                    InvalidTag):
                # undecryptable/garbage/truncated — including AEAD auth
                # failures on spoofed packets (InvalidTag is NOT a
                # ValueError): drop the rest of the datagram, never let a
                # single hostile packet take down the endpoint
                break
            except TlsError as exc:
                self._close_frame = pkt.encode_connection_close(
                    0x0128, 0x06, str(exc).encode()[:64]
                )
                self.closed = True
                return
            if consumed <= 0:
                break
            pos += consumed

    def _receive_packet(self, data: bytes, now: float) -> int:
        if data[0] & 0x80:
            hdr, pos = pkt.parse_long_header_prefix(data)
            if hdr.version != pkt.QUIC_V1:
                return len(data)  # ignore other versions
            if hdr.packet_type == pkt.PKT_RETRY:
                self._handle_retry(data, now)
                return len(data)
            if hdr.packet_type == pkt.PKT_0RTT:
                return len(data)
            space_idx = SPACE_INITIAL if hdr.packet_type == pkt.PKT_INITIAL \
                else SPACE_HANDSHAKE
            length, pos = pkt.decode_varint(data, pos)
            packet_end = pos + length
            space = self.spaces[space_idx]
            if space.discarded or space.protection.rx is None:
                return packet_end
            pn, plain = space.protection.open(
                data[:packet_end], pos, space.largest_received
            )
            if self.dcid is None or (not self.is_client
                                     and space_idx == SPACE_INITIAL):
                self.dcid = hdr.scid
            if not self.is_client and space_idx == SPACE_HANDSHAKE:
                # a handshake packet proves address ownership (RFC 9001 §4.9)
                self._address_validated = True
            self._process_plain(space_idx, pn, plain, now)
            return packet_end
        # short header: dcid is our scid (8 bytes)
        space = self.spaces[SPACE_APP]
        if space.protection.rx is None:
            return len(data)
        pn_offset = 1 + len(self.scid)
        pn, plain = space.protection.open(
            data, pn_offset, space.largest_received, short_header=True
        )
        self._address_validated = True
        self._process_plain(SPACE_APP, pn, plain, now)
        return len(data)

    def _handle_retry(self, data: bytes, now: float) -> None:
        """Client address validation (RFC 9000 §8.1, §17.2.5.2): adopt the
        server's Retry SCID as our DCID, re-derive Initial keys from it
        (RFC 9001 §5.2), echo the token in every subsequent Initial, and
        resend the ClientHello. At most one Retry is honored, and only
        before any other server packet arrives; the integrity tag binds the
        Retry to our original DCID so an off-path attacker can't forge it."""
        from smelter_tpu_torch.io.quic.crypto import retry_integrity_tag

        if not self.is_client or self._retry_source_cid is not None:
            return
        space = self.spaces[SPACE_INITIAL]
        if space.discarded or space.largest_received >= 0:
            return  # already past address validation
        hdr, token, tag = pkt.parse_retry(data)
        if not token:
            return  # MUST discard empty-token Retry (§17.2.5.2)
        if hdr.scid == self.dcid:
            return  # no CID change: forgery or corruption
        expect = retry_integrity_tag(self.original_dcid, data[:-16])
        if tag != expect:
            return
        self._retry_source_cid = hdr.scid
        self.dcid = hdr.scid
        self._initial_token = token
        tx, rx = initial_secrets(hdr.scid, True)
        space.protection = type(space.protection)()
        space.protection.set_tx(tx)
        space.protection.set_rx(rx)
        # resend everything outstanding (the ClientHello); packet numbers
        # continue (§17.2.5.3)
        for pn in list(space.sent.keys()):
            self._mark_lost(SPACE_INITIAL, space.sent.pop(pn))

    def _process_plain(self, space_idx: int, pn: int, plain: bytes,
                       now: float) -> None:
        space = self.spaces[space_idx]
        if pn in space.received:
            return
        space.received.add(pn)
        space.largest_received = max(space.largest_received, pn)
        if len(space.received) > 4096:
            # bound the ack set: forget the oldest acked ranges
            cutoff = space.largest_received - 2048
            space.received = {p for p in space.received if p >= cutoff}
        frames = pkt.decode_frames(
            plain, self.peer_params.ack_delay_exponent if space_idx == SPACE_APP else 3
        )
        ack_eliciting = False
        for fr in frames:
            if isinstance(fr, pkt.AckFrame):
                self._on_ack(space_idx, fr, now)
            elif isinstance(fr, pkt.CryptoFrame):
                ack_eliciting = True
                for piece in space.crypto_recv.insert(fr.offset, fr.data, False):
                    epoch = {SPACE_INITIAL: EPOCH_INITIAL,
                             SPACE_HANDSHAKE: EPOCH_HANDSHAKE,
                             SPACE_APP: EPOCH_1RTT}[space_idx]
                    self.tls.handle_crypto(epoch, piece)
                self._flush_tls()
                if self.is_client and self.tls.complete \
                        and not self.spaces[SPACE_INITIAL].discarded:
                    self._discard_space(SPACE_INITIAL)
            elif isinstance(fr, pkt.StreamFrame):
                ack_eliciting = True
                self._on_stream_frame(fr)
            elif isinstance(fr, pkt.DatagramFrame):
                ack_eliciting = True
                self.events.append(QuicStreamEvent(-1, fr.data, False))
            elif isinstance(fr, pkt.HandshakeDoneFrame):
                ack_eliciting = True
                if self.is_client:
                    self.handshake_confirmed = True
                    self._discard_space(SPACE_HANDSHAKE)
            elif isinstance(fr, pkt.MaxDataFrame):
                ack_eliciting = True
                self.max_data_remote = max(self.max_data_remote, fr.maximum)
            elif isinstance(fr, pkt.MaxStreamDataFrame):
                ack_eliciting = True
                st = self.streams.get(fr.stream_id)
                if st is not None:
                    st.max_stream_data_remote = max(
                        st.max_stream_data_remote, fr.maximum
                    )
            elif isinstance(fr, pkt.MaxStreamsFrame):
                ack_eliciting = True
                if fr.bidi:
                    self.peer_max_streams_bidi = max(
                        self.peer_max_streams_bidi, fr.maximum
                    )
                else:
                    self.peer_max_streams_uni = max(
                        self.peer_max_streams_uni, fr.maximum
                    )
            elif isinstance(fr, pkt.ResetStreamFrame):
                ack_eliciting = True
                st = self._get_stream(fr.stream_id)
                st.reset_received = True
                self.events.append(QuicStreamEvent(fr.stream_id, b"", True))
            elif isinstance(fr, pkt.StopSendingFrame):
                ack_eliciting = True
                st = self.streams.get(fr.stream_id)
                if st is not None:
                    st.stop_sending = True
            elif isinstance(fr, pkt.ConnectionCloseFrame):
                self.closed = True
                self.close_error = (fr.error_code, fr.reason)
            elif isinstance(fr, (pkt.PingFrame, pkt.PathChallengeFrame)):
                ack_eliciting = True
                if isinstance(fr, pkt.PathChallengeFrame):
                    self._path_response = fr.data
        if ack_eliciting:
            space.ack_needed = True
            if space.ack_time is None:
                # immediate ack in handshake spaces; small delay in app space
                space.ack_time = now if space_idx != SPACE_APP else now + 0.025

    def _on_stream_frame(self, fr: pkt.StreamFrame) -> None:
        st = self._get_stream(fr.stream_id)
        end = fr.offset + len(fr.data)
        if end > st.recv_highest:
            self.data_received += end - st.recv_highest
            st.recv_highest = end
        pieces = st.recv.insert(fr.offset, fr.data, fr.fin)
        for piece in pieces:
            self.data_delivered += len(piece)
            self.events.append(QuicStreamEvent(fr.stream_id, piece, False))
        if st.recv.fin_ready:
            st.recv.fin_delivered = True
            self.events.append(QuicStreamEvent(fr.stream_id, b"", True))

    def _on_ack(self, space_idx: int, ack: pkt.AckFrame, now: float) -> None:
        space = self.spaces[space_idx]
        newly_acked: List[_SentPacket] = []
        for lo, hi in ack.ranges:
            for pn in list(space.sent.keys()):
                if lo <= pn <= hi:
                    newly_acked.append(space.sent.pop(pn))
        if not newly_acked:
            return
        largest = max(p.pn for p in newly_acked)
        space.largest_acked = max(space.largest_acked, largest)
        # RTT sample from the largest newly acked, if it was ack-eliciting
        for p in newly_acked:
            if p.pn == largest and p.ack_eliciting:
                self.latest_rtt = max(now - p.time_sent, GRANULARITY)
                self.min_rtt = min(self.min_rtt, self.latest_rtt)
                adj = self.latest_rtt
                if space_idx == SPACE_APP:
                    adj = max(self.latest_rtt - ack.delay_us / 1e6, self.min_rtt)
                err = abs(self.smoothed_rtt - adj)
                self.rttvar = 0.75 * self.rttvar + 0.25 * err
                self.smoothed_rtt = 0.875 * self.smoothed_rtt + 0.125 * adj
        self.pto_count = 0
        for p in newly_acked:
            self._mark_acked(space_idx, p)
        # packet-threshold loss detection
        lost = [
            p for p in space.sent.values()
            if p.pn + PACKET_THRESHOLD <= space.largest_acked
        ]
        for p in lost:
            del space.sent[p.pn]
            self._mark_lost(space_idx, p)

    def _mark_acked(self, space_idx: int, p: _SentPacket) -> None:
        space = self.spaces[space_idx]
        for off, ln in p.crypto:
            space.crypto_send.on_ack(off, ln, False)
        for sid, off, ln, fin in p.streams:
            st = self.streams.get(sid)
            if st is not None:
                st.send.on_ack(off, ln, fin)

    def _mark_lost(self, space_idx: int, p: _SentPacket) -> None:
        space = self.spaces[space_idx]
        for off, ln in p.crypto:
            space.crypto_send.on_loss(off, ln)
        for sid, off, ln, fin in p.streams:
            st = self.streams.get(sid)
            if st is not None:
                st.send.on_loss(off, ln)
                if fin:
                    st.send.fin_sent = False
        if p.handshake_done:
            self._pending_handshake_done = True

    def _discard_space(self, space_idx: int) -> None:
        self.spaces[space_idx].discarded = True
        self.spaces[space_idx].sent.clear()

    # -- outbound ------------------------------------------------------------------

    _pending_handshake_done = False
    _path_response: Optional[bytes] = None

    def datagrams_to_send(self, now: float) -> List[bytes]:
        if self.dcid is None:
            return []
        if self._close_frame is not None:
            if self._close_sent >= 3:
                self.closed = True
                return []
            self._close_sent += 1
            out = self._build_close_datagram()
            if self._close_sent >= 3:
                self.closed = True
            return out
        out: List[bytes] = []
        budget = 10  # max datagrams per call
        while budget > 0:
            dgram = self._build_datagram(now)
            if dgram is None:
                break
            if not self._address_validated:
                if len(dgram) > self._anti_amp_budget:
                    break
                self._anti_amp_budget -= len(dgram)
            out.append(dgram)
            budget -= 1
        return out

    def _build_close_datagram(self) -> List[bytes]:
        space_idx = SPACE_APP if self.spaces[SPACE_APP].protection.tx else (
            SPACE_HANDSHAKE if self.spaces[SPACE_HANDSHAKE].protection.tx
            else SPACE_INITIAL
        )
        space = self.spaces[space_idx]
        pn = space.next_pn
        space.next_pn += 1
        data = self._seal_packet(space_idx, pn, self._close_frame)
        return [data] if data else []

    def _build_datagram(self, now: float) -> Optional[bytes]:
        """One UDP datagram, possibly coalescing Initial+Handshake packets."""
        # rotate 1-RTT keys before the AES-GCM per-key packet limit
        # (RFC 9001 §6); only once the handshake is confirmed and any prior
        # update has been answered by the peer
        app_prot = self.spaces[SPACE_APP].protection
        if (
            self.handshake_confirmed
            and app_prot.ready
            and app_prot.should_initiate_update()
        ):
            app_prot.initiate_key_update()
        parts: List[bytes] = []
        total = 0
        for space_idx in (SPACE_INITIAL, SPACE_HANDSHAKE, SPACE_APP):
            space = self.spaces[space_idx]
            if space.discarded or space.protection.tx is None:
                continue
            built = self._build_payload(space_idx, now, MAX_DATAGRAM - total - 64)
            if built is None:
                continue
            payload, pn = built
            sealed = self._seal_packet(space_idx, pn, payload)
            if sealed is None:
                continue
            parts.append(sealed)
            total += len(sealed)
        if not parts:
            return None
        dgram = b"".join(parts)
        # client Initials must ride >=1200-byte datagrams (RFC 9000 §14.1)
        if self.is_client and not self.spaces[SPACE_INITIAL].discarded \
                and len(dgram) < 1200:
            dgram += b"\x00" * (1200 - len(dgram))
        return dgram

    def _build_payload(self, space_idx: int, now: float,
                       max_len: int) -> Optional[Tuple[bytes, int]]:
        """Collect frames for one packet. -> (payload, pn) or None."""
        if max_len < 32:
            return None
        space = self.spaces[space_idx]
        frames = bytearray()
        sent = _SentPacket(pn=space.next_pn, time_sent=now,
                           ack_eliciting=False, in_flight=True, size=0)
        # ACK
        if space.ack_needed:
            ranges = space.ack_ranges()
            if ranges:
                ack = pkt.AckFrame(
                    largest=ranges[0][1],
                    delay_us=0,
                    ranges=ranges,
                )
                frames += pkt.encode_ack(
                    ack, self.local_params.ack_delay_exponent
                )
                space.ack_needed = False
                space.ack_time = None
        # CRYPTO
        cs = space.crypto_send
        while cs.pending() and len(frames) < max_len - 16:
            room = max_len - len(frames) - 12
            got = cs.take(room, 1 << 60)
            if got is None:
                break
            off, chunk, _fin = got
            frames += pkt.encode_crypto(off, chunk)
            sent.crypto.append((off, len(chunk)))
            sent.ack_eliciting = True
        if space_idx == SPACE_APP:
            self._build_app_frames(frames, sent, max_len)
        if self._pending_ping and space_idx == SPACE_APP:
            frames += pkt.encode_varint(pkt.FT_PING)
            sent.ack_eliciting = True
            self._pending_ping = False
        if not frames:
            return None
        pn = space.next_pn
        space.next_pn += 1
        # only ack-eliciting packets participate in loss/PTO tracking —
        # tracking ACK-only packets would arm PTO for data the peer never
        # acknowledges (RFC 9002 §2)
        if sent.ack_eliciting:
            space.sent[pn] = sent
        return bytes(frames), pn

    def _build_app_frames(self, frames: bytearray, sent: _SentPacket,
                          max_len: int) -> None:
        if self._pending_handshake_done and not self.is_client:
            frames += pkt.encode_varint(pkt.FT_HANDSHAKE_DONE)
            sent.handshake_done = True
            sent.ack_eliciting = True
            self._pending_handshake_done = False
        if self._path_response is not None:
            frames += pkt.encode_varint(pkt.FT_PATH_RESPONSE) + self._path_response
            self._path_response = None
            sent.ack_eliciting = True
        # flow-control updates: replenish when half consumed
        if self.data_delivered * 2 > self.max_data_local:
            self.max_data_local = self.data_delivered + \
                self.local_params.initial_max_data
            frames += pkt.encode_varint(pkt.FT_MAX_DATA) \
                + pkt.encode_varint(self.max_data_local)
            sent.max_data = self.max_data_local
            sent.ack_eliciting = True
        for st in list(self.streams.values()):
            if st.recv.delivered * 2 > st.max_stream_data_local:
                st.max_stream_data_local = st.recv.delivered + \
                    self.local_params.initial_max_stream_data
                frames += pkt.encode_varint(pkt.FT_MAX_STREAM_DATA) \
                    + pkt.encode_varint(st.stream_id) \
                    + pkt.encode_varint(st.max_stream_data_local)
                sent.max_stream_data.append((st.stream_id,
                                             st.max_stream_data_local))
                sent.ack_eliciting = True
        # datagrams
        while self.datagrams_out and len(frames) < max_len - 8:
            d = self.datagrams_out[0]
            enc = pkt.encode_datagram(d)
            if len(frames) + len(enc) > max_len:
                if len(frames) == 0:
                    self.datagrams_out.popleft()  # too big ever: drop
                break
            self.datagrams_out.popleft()
            frames += enc
            sent.ack_eliciting = True
        # stream data (round-robin)
        if self.established:
            for st in list(self.streams.values()):
                while st.send.pending() and len(frames) < max_len - 16:
                    room = max_len - len(frames) - 16
                    prev_next = st.send.next_send
                    # connection-level flow control applies to NEW data only
                    # (retransmits were already counted); cap the stream's
                    # new-data window by the connection window
                    conn_room = max(self.max_data_remote - self.data_sent, 0)
                    flow_limit = min(st.max_stream_data_remote,
                                     prev_next + conn_room)
                    got = st.send.take(room, flow_limit)
                    if got is None:
                        break
                    off, chunk, fin = got
                    new_bytes = max(0, off + len(chunk) - prev_next)
                    self.data_sent += new_bytes
                    frames += pkt.encode_stream(st.stream_id, off, chunk, fin)
                    sent.streams.append((st.stream_id, off, len(chunk), fin))
                    sent.ack_eliciting = True
                    if fin:
                        break

    def _seal_packet(self, space_idx: int, pn: int,
                     payload: bytes) -> Optional[bytes]:
        space = self.spaces[space_idx]
        if space.protection.tx is None:
            return None
        pn_bytes = pkt.encode_packet_number(pn, space.largest_acked)
        if space_idx == SPACE_APP:
            first = (
                0x40
                | (space.protection.key_phase << 2)
                | (len(pn_bytes) - 1)
            )
            prefix = bytes([first]) + self.dcid
        else:
            ptype = pkt.PKT_INITIAL if space_idx == SPACE_INITIAL \
                else pkt.PKT_HANDSHAKE
            token = (self._initial_token
                     if ptype == pkt.PKT_INITIAL and self.is_client else b"")
            hdr = pkt.LongHeader(ptype, pkt.QUIC_V1, self.dcid, self.scid,
                                 token=token)
            prefix = pkt.build_long_header_prefix(hdr, len(pn_bytes))
            # payload must give >=4 bytes for HP sampling post-AEAD (16-byte
            # tag guarantees it) but pn+payload >= 4 needed pre-protection
            while len(pn_bytes) + len(payload) < 4:
                payload += b"\x00"
            prefix += pkt.encode_varint(len(pn_bytes) + len(payload) + 16)
        if space_idx == SPACE_APP and len(pn_bytes) + len(payload) < 4:
            payload += b"\x00" * (4 - len(pn_bytes) - len(payload))
        return space.protection.seal(prefix, pn, pn_bytes, payload)

    # -- timers ---------------------------------------------------------------------

    def next_timer(self) -> Optional[float]:
        """Earliest absolute time an action is due."""
        times: List[float] = []
        for space in self.spaces:
            if space.discarded:
                continue
            if space.ack_time is not None:
                times.append(space.ack_time)
            if space.sent:
                oldest = min(p.time_sent for p in space.sent.values())
                pto = self.smoothed_rtt + max(4 * self.rttvar, GRANULARITY) + \
                    self.local_params.max_ack_delay_ms / 1000.0
                times.append(oldest + pto * (2 ** self.pto_count))
        if self.idle_timeout:
            times.append(self.last_activity + self.idle_timeout)
        return min(times) if times else None

    _last_keepalive = 0.0

    def maybe_keepalive(self, now: float) -> None:
        """Queue a PING at half the idle timeout so quiet-but-live sessions
        (e.g. a MoQ publisher between SETUP and its first frame) don't
        idle out — the peer's ACK refreshes last_activity. A dead peer
        never ACKs, so the idle timeout still fires for it."""
        if not self.established or self.closed or not self.idle_timeout:
            return
        if (now - self.last_activity > self.idle_timeout / 2
                and now - self._last_keepalive > 2.0):
            self._pending_ping = True
            self._last_keepalive = now

    def handle_timer(self, now: float) -> None:
        if self.idle_timeout and now >= self.last_activity + self.idle_timeout:
            self.closed = True
            return
        for space_idx, space in enumerate(self.spaces):
            if space.discarded or not space.sent:
                continue
            oldest = min(p.time_sent for p in space.sent.values())
            pto = self.smoothed_rtt + max(4 * self.rttvar, GRANULARITY) + \
                self.local_params.max_ack_delay_ms / 1000.0
            if now >= oldest + pto * (2 ** self.pto_count):
                # PTO fired: retransmit everything outstanding in this space
                self.pto_count = min(self.pto_count + 1, 10)
                for pn in list(space.sent.keys()):
                    p = space.sent.pop(pn)
                    self._mark_lost(space_idx, p)
                if not space.crypto_send.pending():
                    self._pending_ping = True

    # -- app events -----------------------------------------------------------------

    def poll_event(self) -> Optional[QuicStreamEvent]:
        return self.events.popleft() if self.events else None
