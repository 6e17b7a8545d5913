"""SRTP/SRTCP (RFC 3711) — AES_CM_128_HMAC_SHA1_80 protect/unprotect.

Pure-python packet handling with `cryptography` primitives for AES-CTR and
HMAC-SHA1. Covers what WebRTC media needs: the default cipher suite, ROC
tracking per SSRC, 80-bit auth tags, SRTCP with explicit index.
"""

from __future__ import annotations

import hmac
import struct
from hashlib import sha1
from typing import Dict, Tuple

from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes


def _aes_ctr(key: bytes, iv16: bytes, data: bytes) -> bytes:
    enc = Cipher(algorithms.AES(key), modes.CTR(iv16)).encryptor()
    return enc.update(data) + enc.finalize()


def _kdf(master_key: bytes, master_salt: bytes, label: int, n: int) -> bytes:
    """RFC 3711 §4.3.1 AES-CM key derivation (kdr = 0)."""
    x = bytearray(master_salt)  # 14 bytes
    x[7] ^= label
    iv = bytes(x) + b"\x00\x00"
    return _aes_ctr(master_key, iv, b"\x00" * n)


class SrtpSession:
    """One direction of SRTP (tx or rx) derived from a master key/salt."""

    TAG_LEN = 10

    def __init__(self, master_key: bytes, master_salt: bytes) -> None:
        self.rtp_key = _kdf(master_key, master_salt, 0x00, 16)
        self.rtp_auth = _kdf(master_key, master_salt, 0x01, 20)
        self.rtp_salt = _kdf(master_key, master_salt, 0x02, 14)
        self.rtcp_key = _kdf(master_key, master_salt, 0x03, 16)
        self.rtcp_auth = _kdf(master_key, master_salt, 0x04, 20)
        self.rtcp_salt = _kdf(master_key, master_salt, 0x05, 14)
        # per-SSRC rollover counters and last seq (tx and rx share the object
        # because each direction gets its own SrtpSession)
        self._roc: Dict[int, int] = {}
        self._last_seq: Dict[int, int] = {}
        self._rtcp_index = 0
        # RFC 3711 §3.3.2 replay protection: per-SSRC sliding window over
        # the 48-bit packet index (ROC||SEQ), updated only after auth passes
        self._replay: Dict[int, Tuple[int, int]] = {}  # ssrc -> (max_index, bitmask)

    REPLAY_WINDOW = 64

    def _check_replay(self, ssrc: int, index: int) -> None:
        """Raise on a replayed or too-old packet index (pre-auth check)."""
        state = self._replay.get(ssrc)
        if state is None:
            return
        max_index, mask = state
        if index > max_index:
            return
        delta = max_index - index
        if delta >= self.REPLAY_WINDOW:
            raise ValueError("srtp replay: packet index too old")
        if mask & (1 << delta):
            raise ValueError("srtp replay: duplicate packet index")

    def _commit_replay(self, ssrc: int, index: int) -> None:
        """Mark an authenticated index as seen (post-auth update)."""
        max_index, mask = self._replay.get(ssrc, (-1, 0))
        if index > max_index:
            shift = index - max_index
            mask = ((mask << shift) | 1) & ((1 << self.REPLAY_WINDOW) - 1)
            max_index = index
        else:
            mask |= 1 << (max_index - index)
        self._replay[ssrc] = (max_index, mask)

    # -- helpers ---------------------------------------------------------------

    def _rtp_iv(self, ssrc: int, roc: int, seq: int) -> bytes:
        index = (roc << 16) | seq
        iv = int.from_bytes(self.rtp_salt + b"\x00\x00", "big")
        iv ^= ssrc << 64
        iv ^= index << 16
        return iv.to_bytes(16, "big")

    def _rtcp_iv(self, ssrc: int, index: int) -> bytes:
        iv = int.from_bytes(self.rtcp_salt + b"\x00\x00", "big")
        iv ^= ssrc << 64
        iv ^= index << 16
        return iv.to_bytes(16, "big")

    def _estimate_rx_roc(self, ssrc: int, seq: int):
        """Estimate ROC for an incoming seq (RFC 3711 §3.3.1, simplified).

        Side-effect-free: returns ``(roc, commit)`` where ``roc`` is the
        rollover counter to authenticate/decrypt under and ``commit`` is the
        ``(roc, last_seq)`` state to store ONLY after the packet passes the
        HMAC check (or None when nothing should be stored). Committing the
        estimate before authentication would let a spoofed wrap-looking
        sequence permanently advance the ROC and break every subsequent
        legitimate packet (RFC 3711 §3.3.2 ordering)."""
        roc = self._roc.get(ssrc, 0)
        last = self._last_seq.get(ssrc)
        if last is None:
            return roc, (roc, seq)
        if seq < last and last - seq > 0x8000:
            # wrapped forward into the next era (same test as _tx_roc)
            return roc + 1, (roc + 1, seq)
        if seq > last and seq - last > 0x8000 and roc > 0:
            # Late pre-rollover packet delivered after the wrap: decrypt under
            # the previous ROC, but do NOT regress the tracked seq — storing
            # the old high seq here would make the next in-order packet
            # re-trigger the rollover test, double-incrementing ROC and
            # permanently failing auth from then on (RFC 3711 §3.3.1).
            return roc - 1, None
        return roc, (roc, seq)

    def _tx_roc(self, ssrc: int, seq: int) -> int:
        last = self._last_seq.get(ssrc)
        if last is not None and seq < last and last - seq > 0x8000:
            self._roc[ssrc] = self._roc.get(ssrc, 0) + 1
        self._last_seq[ssrc] = seq
        return self._roc.setdefault(ssrc, 0)

    # -- RTP -------------------------------------------------------------------

    def protect_rtp(self, packet: bytes) -> bytes:
        seq = struct.unpack("!H", packet[2:4])[0]
        ssrc = struct.unpack("!I", packet[8:12])[0]
        roc = self._tx_roc(ssrc, seq)
        header_len = 12 + 4 * (packet[0] & 0x0F)
        payload = packet[header_len:]
        enc = _aes_ctr(self.rtp_key, self._rtp_iv(ssrc, roc, seq), payload)
        authed = packet[:header_len] + enc
        tag = hmac.new(
            self.rtp_auth, authed + struct.pack("!I", roc), sha1
        ).digest()[: self.TAG_LEN]
        return authed + tag

    def unprotect_rtp(self, packet: bytes) -> bytes:
        """Returns the plain RTP packet; raises ValueError on bad auth."""
        if len(packet) < 12 + self.TAG_LEN:
            raise ValueError("srtp packet too short")
        tag = packet[-self.TAG_LEN :]
        body = packet[: -self.TAG_LEN]
        seq = struct.unpack("!H", body[2:4])[0]
        ssrc = struct.unpack("!I", body[8:12])[0]
        roc, commit = self._estimate_rx_roc(ssrc, seq)
        index = (roc << 16) | seq
        self._check_replay(ssrc, index)
        expect = hmac.new(
            self.rtp_auth, body + struct.pack("!I", roc), sha1
        ).digest()[: self.TAG_LEN]
        if not hmac.compare_digest(tag, expect):
            raise ValueError("srtp auth failed")
        if commit is not None:
            self._roc[ssrc], self._last_seq[ssrc] = commit
        self._commit_replay(ssrc, index)
        header_len = 12 + 4 * (body[0] & 0x0F)
        payload = body[header_len:]
        dec = _aes_ctr(self.rtp_key, self._rtp_iv(ssrc, roc, seq), payload)
        return body[:header_len] + dec

    # -- RTCP ------------------------------------------------------------------

    def protect_rtcp(self, packet: bytes) -> bytes:
        ssrc = struct.unpack("!I", packet[4:8])[0]
        self._rtcp_index = (self._rtcp_index + 1) & 0x7FFFFFFF
        index = self._rtcp_index
        enc = _aes_ctr(self.rtcp_key, self._rtcp_iv(ssrc, index), packet[8:])
        body = packet[:8] + enc + struct.pack("!I", index | 0x80000000)
        tag = hmac.new(self.rtcp_auth, body, sha1).digest()[: self.TAG_LEN]
        return body + tag

    def unprotect_rtcp(self, packet: bytes) -> bytes:
        if len(packet) < 8 + 4 + self.TAG_LEN:
            raise ValueError("srtcp packet too short")
        tag = packet[-self.TAG_LEN :]
        body = packet[: -self.TAG_LEN]
        expect = hmac.new(self.rtcp_auth, body, sha1).digest()[: self.TAG_LEN]
        if not hmac.compare_digest(tag, expect):
            raise ValueError("srtcp auth failed")
        e_index = struct.unpack("!I", body[-4:])[0]
        index = e_index & 0x7FFFFFFF
        encrypted = bool(e_index & 0x80000000)
        payload = body[8:-4]
        if encrypted:
            ssrc = struct.unpack("!I", body[4:8])[0]
            payload = _aes_ctr(self.rtcp_key, self._rtcp_iv(ssrc, index), payload)
        return body[:8] + payload


def sessions_from_dtls(
    keys: Tuple[bytes, bytes, bytes, bytes], is_server: bool
) -> Tuple[SrtpSession, SrtpSession]:
    """(tx, rx) sessions from DTLS exported material. The DTLS *client*'s
    write direction uses (client_key, client_salt)."""
    ck, sk, cs, ss = keys
    client = SrtpSession(ck, cs)
    server = SrtpSession(sk, ss)
    return (server, client) if is_server else (client, server)
