"""WebRTC media transport session: ICE (lite responder or minimal full
agent), DTLS-SRTP, RTP/RTCP mux over one UDP socket.

The analogue of the reference's webrtc-rs peer connections
(`smelter-core/src/webrtc/peer_connection_recvonly.rs` etc.), built on:
  - `stun.py` connectivity checks (RFC 5389/8445 subset)
  - the native DTLS helper (`dtls.py`) + `srtp.py` (RFC 3711)
  - demux by first byte (RFC 7983): 0-3 STUN, 20-63 DTLS, 128-191 RTP/RTCP

Roles:
  - answerer (WHIP/WHEP server endpoints): ICE-lite responder,
    DTLS passive (server)
  - offerer (WHIP/WHEP clients): minimal full ICE (sends checks),
    DTLS active (client)
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
import time
from typing import Callable, Optional, Tuple

from smelter_tpu_torch.io.webrtc import sdp as sdp_mod
from smelter_tpu_torch.io.webrtc import stun
from smelter_tpu_torch.io.webrtc.dtls import DtlsEndpoint
from smelter_tpu_torch.io.webrtc.srtp import SrtpSession, sessions_from_dtls

logger = logging.getLogger("smelter.webrtc")


def _local_ip() -> str:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


# -- UDP port strategy (reference webrtc/setting_engine.rs) ------------------
#
# Mirrors WebrtcSettingEngineCtx: AnyPort (default ephemeral sockets),
# PortRange (ephemeral sockets restricted to [start, end]), or
# MuxOnSinglePort (every session shares ONE socket; inbound packets demux
# to sessions by the ICE ufrag in STUN USERNAME, then by source address).
# nat_1to1_ips substitutes the advertised host-candidate IP.

_udp_config: dict = {"mux_port": None, "port_range": None, "nat_1to1_ips": ()}
_udp_lock = threading.Lock()
_mux_instance: Optional["UdpMux"] = None


def configure_udp(
    mux_port: Optional[int] = None,
    port_range: Optional[Tuple[int, int]] = None,
    nat_1to1_ips: Tuple[str, ...] = (),
) -> None:
    """Install the process-wide WebRTC UDP strategy (config.rs:283-321).
    Mux wins over range when both are given (config.rs:305-315)."""
    with _udp_lock:
        _udp_config["mux_port"] = mux_port
        _udp_config["port_range"] = None if mux_port is not None else port_range
        _udp_config["nat_1to1_ips"] = tuple(nat_1to1_ips)


class UdpMux:
    """One shared UDP socket for every WebRTC session
    (setting_engine.rs MuxOnSinglePort / webrtc-rs UDPMuxDefault).

    Demux: STUN binding requests carry USERNAME "<local_ufrag>:<remote>",
    which identifies the session; once a request from an address is routed,
    all later packets (DTLS/SRTP) from that address go to the same session.
    """

    def __init__(self, port: int) -> None:
        self.port = port
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", port))
        self._by_ufrag: dict = {}
        self._by_addr: dict = {}
        self._lock = threading.Lock()
        self._refs = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._recv_loop, name="webrtc-mux", daemon=True
        )
        self._thread.start()

    def register(self, session: "WebRtcSession") -> None:
        with self._lock:
            self._by_ufrag[session.local_ufrag] = session
            self._refs += 1

    def unregister(self, session: "WebRtcSession") -> bool:
        """Returns True when this was the last session (mux closed)."""
        with self._lock:
            self._by_ufrag.pop(session.local_ufrag, None)
            self._by_addr = {
                a: s for a, s in self._by_addr.items() if s is not session
            }
            self._refs -= 1
            last = self._refs <= 0
        if last:
            self._stop.set()
            try:
                self.sock.close()
            except OSError:
                pass
        return last

    def _route_stun(self, data: bytes, addr) -> Optional["WebRtcSession"]:
        msg = stun.parse(data)
        if msg is None:
            return None
        user = msg.attr(stun.ATTR_USERNAME)
        if user:
            local = user.split(b":", 1)[0].decode("utf-8", "replace")
            with self._lock:
                session = self._by_ufrag.get(local)
            if session is not None:
                # Authenticate BEFORE committing the addr→session demux
                # mapping: ufrags are visible in SDP, so a spoofed-source
                # packet with a stolen ufrag could otherwise rebind the
                # session's DTLS/SRTP routing to an attacker address until
                # the real peer's next binding request (RFC 5389 §10.2).
                if not stun.check_integrity(data, msg, session.local_pwd):
                    with self._lock:
                        return self._by_addr.get(addr)
                with self._lock:
                    self._by_addr[addr] = session
                return session
        with self._lock:
            return self._by_addr.get(addr)

    def _recv_loop(self) -> None:
        try:
            self.sock.settimeout(0.25)
        except OSError:
            return
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                continue
            first = data[0]
            if first < 4:
                session = self._route_stun(data, addr)
                if session is not None:
                    session._handle_stun(data, addr)
            else:
                with self._lock:
                    session = self._by_addr.get(addr)
                if session is None:
                    continue
                if 20 <= first <= 63:
                    session._handle_dtls(data, addr)
                elif 128 <= first <= 191:
                    session._handle_srtp(data)


def _get_mux(port: int) -> UdpMux:
    global _mux_instance
    with _udp_lock:
        if _mux_instance is None or _mux_instance._stop.is_set():
            _mux_instance = UdpMux(port)
        return _mux_instance


def _bind_in_range(sock: socket.socket, start: int, end: int) -> int:
    """Bind within [start, end] (setting_engine.rs EphemeralUDP range)."""
    for port in range(start, end + 1):
        try:
            sock.bind(("0.0.0.0", port))
            return port
        except OSError:
            continue
    raise OSError(
        f"no free WebRTC UDP port in configured range {start}:{end}"
    )


class WebRtcSession:
    """One peer transport. Construct, exchange SDP, then start()."""

    def __init__(self, is_offerer: bool) -> None:
        self.is_offerer = is_offerer
        self.local_ufrag, self.local_pwd = sdp_mod.new_ice_credentials()
        self.remote_ufrag = ""
        self.remote_pwd = ""
        self.remote_candidates: list = []
        # offerer takes the DTLS client (active) role; answerer passive
        self.dtls = DtlsEndpoint(is_server=not is_offerer)
        self._mux: Optional[UdpMux] = None
        # the mux exists to accept MANY inbound sessions on one well-known
        # port (server roles); client/offerer sessions keep their own
        # ephemeral sockets — their traffic targets remote servers, and a
        # shared socket would break source-address demux for loopback peers
        if _udp_config["mux_port"] is not None and not is_offerer:
            self._mux = _get_mux(_udp_config["mux_port"])
            self.sock = self._mux.sock
            self.port = self._mux.port
            self._mux.register(self)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            rng = _udp_config["port_range"]
            if rng:
                self.port = _bind_in_range(self.sock, rng[0], rng[1])
            else:
                self.sock.bind(("0.0.0.0", 0))
                self.port = self.sock.getsockname()[1]
        nat_ips = _udp_config["nat_1to1_ips"]
        self.ip = nat_ips[0] if nat_ips else _local_ip()
        self.peer_addr: Optional[Tuple[str, int]] = None
        self.srflx: Optional[Tuple[str, int]] = None  # NAT-mapped (STUN)
        self.srtp_tx: Optional[SrtpSession] = None
        self.srtp_rx: Optional[SrtpSession] = None
        self.on_rtp: Optional[Callable[[bytes], None]] = None
        self.on_rtcp: Optional[Callable[[bytes], None]] = None
        self.established = threading.Event()
        self._stop = threading.Event()
        self._threads: list = []
        self._ice_ok = threading.Event()
        self._dtls_lock = threading.Lock()

    # -- SDP glue ------------------------------------------------------------

    def set_remote(self, desc: sdp_mod.SessionDescription) -> None:
        self.remote_ufrag = desc.ice_ufrag
        self.remote_pwd = desc.ice_pwd
        self.remote_candidates = list(desc.candidates)

    def gather_srflx(self, stun_servers: Optional[list] = None,
                     timeout: float = 1.0) -> Optional[Tuple[str, int]]:
        """Learn our server-reflexive (NAT-mapped) address from a STUN
        server and remember it for SDP (reference
        SMELTER_WEBRTC_STUN_SERVERS, config.rs:269-281; default Google
        STUN). Returns the srflx (ip, port) or None (no server reachable —
        host candidates still work on a LAN)."""
        if self._mux is not None:
            # muxed deployments advertise a known forwarded port (usually
            # with SMELTER_WEBRTC_1_TO_1_NAT_IPS); inline STUN would fight
            # the shared recv loop for responses
            return None
        servers = stun_servers
        if servers is None:
            raw = os.environ.get(
                "SMELTER_WEBRTC_STUN_SERVERS",
                os.environ.get("SMELTER_STUN_SERVERS", ""),
            )
            servers = [s for s in raw.split(",") if s.strip()]
        for server in servers:
            target = server.strip()
            if target.startswith("stun:"):
                target = target[5:]
            host, _, port_s = target.partition(":")
            try:
                addr = (socket.gethostbyname(host), int(port_s or 3478))
            except OSError:
                continue
            req = stun.build(stun.BINDING_REQUEST)
            tid = req[8:20]
            old_timeout = self.sock.gettimeout()
            try:
                self.sock.settimeout(timeout)
                self.sock.sendto(req, addr)
                deadline = time.monotonic() + timeout
                while time.monotonic() < deadline:
                    data, _src = self.sock.recvfrom(2048)
                    msg = stun.parse(data)
                    if msg is None or msg.transaction_id != tid:
                        continue
                    val = msg.attr(stun.ATTR_XOR_MAPPED_ADDRESS)
                    if val is None:
                        break
                    self.srflx = stun.parse_xor_mapped_address(val, tid)
                    return self.srflx
            except OSError:
                continue
            finally:
                try:
                    self.sock.settimeout(old_timeout)
                except OSError:
                    pass  # socket closed concurrently by close()
        return None

    def add_remote_candidates(self, candidates: list) -> None:
        """Trickle ICE (reference `webrtc/trickle_ice_utils.rs`): remote
        candidates arriving after the answer (WHIP/WHEP PATCH). The offerer
        ICE loop re-reads the list every round, so late candidates get
        connectivity checks; the ICE-lite answerer learns the peer from
        inbound checks but records them for completeness."""
        for cand in candidates:
            if cand not in self.remote_candidates:
                self.remote_candidates.append(cand)

    @property
    def candidate(self) -> Tuple[str, int]:
        return (self.ip, self.port)

    def fingerprint(self) -> str:
        return self.dtls.fingerprint()

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> None:
        if self._mux is None:
            t = threading.Thread(
                target=self._recv_loop, name="webrtc-recv", daemon=True
            )
            t.start()
            self._threads.append(t)
        if self.is_offerer:
            t2 = threading.Thread(target=self._ice_client_loop,
                                  name="webrtc-ice", daemon=True)
            t2.start()
            self._threads.append(t2)

    def close(self) -> None:
        self._stop.set()
        if self._mux is not None:
            self._mux.unregister(self)  # shared socket closes with last session
        else:
            try:
                self.sock.close()
            except OSError:
                pass
        self.dtls.close()

    # -- send ---------------------------------------------------------------------

    def send_rtp(self, packet_bytes: bytes) -> None:
        if self.srtp_tx is None or self.peer_addr is None:
            return
        try:
            self.sock.sendto(self.srtp_tx.protect_rtp(packet_bytes), self.peer_addr)
        except OSError:
            pass

    def send_rtcp(self, packet_bytes: bytes) -> None:
        if self.srtp_tx is None or self.peer_addr is None:
            return
        try:
            self.sock.sendto(self.srtp_tx.protect_rtcp(packet_bytes), self.peer_addr)
        except OSError:
            pass

    # -- ICE client (offerer) -----------------------------------------------------

    def _ice_client_loop(self) -> None:
        """Send connectivity checks until answered, then run DTLS client."""
        while not self._stop.is_set() and not self._ice_ok.is_set():
            for cand in self.remote_candidates or []:
                req = stun.build(
                    stun.BINDING_REQUEST,
                    attrs=[
                        (stun.ATTR_USERNAME,
                         f"{self.remote_ufrag}:{self.local_ufrag}".encode()),
                        (stun.ATTR_ICE_CONTROLLING, struct.pack("!Q", 1)),
                        (stun.ATTR_PRIORITY, struct.pack("!I", 0x7E0000FF)),
                        (stun.ATTR_USE_CANDIDATE, b""),
                    ],
                    password=self.remote_pwd,
                )
                try:
                    self.sock.sendto(req, cand)
                except OSError:
                    return
            self._ice_ok.wait(timeout=0.25)
        # kick off the DTLS client flight
        if self._stop.is_set():
            return
        with self._dtls_lock:
            flight = self.dtls.handshake(b"")
        if flight and self.peer_addr:
            self.sock.sendto(flight, self.peer_addr)
        # retransmit the first flight until progress (lossy startup)
        for _ in range(20):
            if self.established.is_set() or self._stop.is_set():
                return
            time.sleep(0.5)
            if not self.established.is_set() and self.peer_addr:
                with self._dtls_lock:
                    flight = self.dtls.handshake(b"")
                if flight:
                    try:
                        self.sock.sendto(flight, self.peer_addr)
                    except OSError:
                        return

    # -- receive/demux ---------------------------------------------------------------

    def _recv_loop(self) -> None:
        try:
            self.sock.settimeout(0.25)
        except OSError:
            return  # close() already ran (unregister racing thread start)
        while not self._stop.is_set():
            try:
                data, addr = self.sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                return
            if not data:
                continue
            first = data[0]
            if first < 4:
                self._handle_stun(data, addr)
            elif 20 <= first <= 63:
                self._handle_dtls(data, addr)
            elif 128 <= first <= 191:
                self._handle_srtp(data)

    def _handle_stun(self, data: bytes, addr) -> None:
        msg = stun.parse(data)
        if msg is None:
            return
        if msg.msg_type == stun.BINDING_REQUEST:
            # requests to us are signed with OUR password
            if not stun.check_integrity(data, msg, self.local_pwd):
                logger.debug("stun integrity failed from %s", addr)
                return
            self.peer_addr = addr
            resp = stun.build(
                stun.BINDING_RESPONSE,
                tid=msg.transaction_id,
                attrs=[(stun.ATTR_XOR_MAPPED_ADDRESS,
                        stun.xor_mapped_address(addr, msg.transaction_id))],
                password=self.local_pwd,
            )
            try:
                self.sock.sendto(resp, addr)
            except OSError:
                pass
        elif msg.msg_type == stun.BINDING_RESPONSE:
            self.peer_addr = addr
            self._ice_ok.set()

    def _handle_dtls(self, data: bytes, addr) -> None:
        self.peer_addr = addr
        with self._dtls_lock:
            try:
                out = self.dtls.handshake(data)
            except Exception:
                logger.exception("dtls handshake failed")
                return
            if out:
                try:
                    self.sock.sendto(out, addr)
                except OSError:
                    return
            if self.dtls.established and self.srtp_tx is None:
                keys = self.dtls.export_srtp_keys()
                self.srtp_tx, self.srtp_rx = sessions_from_dtls(
                    keys, is_server=self.dtls.is_server
                )
                self.established.set()
                logger.info("dtls-srtp established with %s", addr)

    def _handle_srtp(self, data: bytes) -> None:
        if self.srtp_rx is None or len(data) < 12:
            return
        # RTCP: payload type field 200..206 (second byte)
        pt = data[1] & 0x7F
        is_rtcp = 72 <= pt <= 78  # 200-206 minus marker bit
        try:
            if is_rtcp:
                plain = self.srtp_rx.unprotect_rtcp(data)
                if self.on_rtcp:
                    self.on_rtcp(plain)
            else:
                plain = self.srtp_rx.unprotect_rtp(data)
                if self.on_rtp:
                    self.on_rtp(plain)
        except ValueError:
            logger.debug("srtp auth failure (%d bytes)", len(data))
        except Exception:
            # a malformed-but-authenticated packet crashing a depayloader
            # (or any on_rtp/on_rtcp consumer bug) must not kill the
            # session's receive thread
            logger.exception("srtp packet handler failed")
