"""QUIC v1 packet protection (RFC 9001): initial secrets, HKDF-Expand-Label,
AEAD payload protection, AES-ECB header protection."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

from cryptography.hazmat.primitives import hashes, hmac
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

# RFC 9001 §5.2
INITIAL_SALT_V1 = bytes.fromhex("38762cf7f55934b34d179ae6a4c80cadccbb7f0a")

# RFC 9001 §5.8: fixed key/nonce for the Retry Integrity Tag (v1)
RETRY_KEY_V1 = bytes.fromhex("be0c690b9f66575a1d766b54e368c84e")
RETRY_NONCE_V1 = bytes.fromhex("461599d35d632bf2239825bb")


def retry_integrity_tag(odcid: bytes, retry_sans_tag: bytes) -> bytes:
    """Retry Integrity Tag (RFC 9001 §5.8): AES-128-GCM over an empty
    plaintext with the Retry *pseudo-packet* (ODCID-prefixed Retry packet
    minus the tag itself) as AAD; the 16-byte GCM tag is the result.
    Known-answer vector: RFC 9001 A.4."""
    pseudo = bytes([len(odcid)]) + odcid + retry_sans_tag
    return AESGCM(RETRY_KEY_V1).encrypt(RETRY_NONCE_V1, b"", pseudo)


def hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    h = hmac.HMAC(salt, hashes.SHA256())
    h.update(ikm)
    return h.finalize()


def hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        h = hmac.HMAC(prk, hashes.SHA256())
        h.update(t + info + bytes([i]))
        t = h.finalize()
        out += t
        i += 1
    return out[:length]


def hkdf_expand_label(secret: bytes, label: str, context: bytes, length: int) -> bytes:
    full = b"tls13 " + label.encode()
    info = struct.pack("!H", length) + bytes([len(full)]) + full \
        + bytes([len(context)]) + context
    return hkdf_expand(secret, info, length)


@dataclass
class DirectionKeys:
    key: bytes
    iv: bytes
    hp: bytes

    @classmethod
    def from_secret(cls, secret: bytes) -> "DirectionKeys":
        return cls(
            key=hkdf_expand_label(secret, "quic key", b"", 16),
            iv=hkdf_expand_label(secret, "quic iv", b"", 12),
            hp=hkdf_expand_label(secret, "quic hp", b"", 16),
        )


def initial_secrets(dcid: bytes, is_client: bool) -> Tuple[bytes, bytes]:
    """-> (tx_secret, rx_secret) for this endpoint."""
    initial = hkdf_extract(INITIAL_SALT_V1, dcid)
    client = hkdf_expand_label(initial, "client in", b"", 32)
    server = hkdf_expand_label(initial, "server in", b"", 32)
    return (client, server) if is_client else (server, client)


class PacketProtection:
    """Seals/opens packets for one direction pair in one packet-number
    space. AEAD = AES-128-GCM, HP = AES-128-ECB (TLS_AES_128_GCM_SHA256).

    1-RTT key update (RFC 9001 §6): the APP space rotates AEAD keys via
    the "quic ku" HKDF label before the AES-GCM confidentiality limit.
    Header-protection keys never rotate (§6.1). Receive handles all three
    generations in flight: current, next (peer initiated — trial decrypt
    on a flipped phase bit promotes it), and previous (reordered packets
    from before our promotion)."""

    # initiate a key update after this many sealed packets (AES-GCM
    # confidentiality limit is 2^23 per key, RFC 9001 §B.1.1; update at
    # half that for headroom)
    KEY_UPDATE_AT = 1 << 22

    def __init__(self, tx_secret: Optional[bytes] = None,
                 rx_secret: Optional[bytes] = None) -> None:
        self.tx: Optional[DirectionKeys] = None
        self.rx: Optional[DirectionKeys] = None
        self._tx_aead: Optional[AESGCM] = None
        self._rx_aead: Optional[AESGCM] = None
        self.tx_secret: Optional[bytes] = None
        self.rx_secret: Optional[bytes] = None
        self.key_phase = 0          # phase bit we currently send (TX)
        self.rx_phase = 0           # phase bit of the current RX generation
        self.sealed_count = 0       # packets sealed with the current tx key
        self._update_unacked = False  # we flipped; peer hasn't flipped back
        self._rx_next: Optional[Tuple[DirectionKeys, AESGCM]] = None
        self._rx_prev: Optional[Tuple[DirectionKeys, AESGCM]] = None
        if tx_secret:
            self.set_tx(tx_secret)
        if rx_secret:
            self.set_rx(rx_secret)

    def set_tx(self, secret: bytes) -> None:
        self.tx_secret = secret
        self.tx = DirectionKeys.from_secret(secret)
        self._tx_aead = AESGCM(self.tx.key)
        self.sealed_count = 0

    def set_rx(self, secret: bytes) -> None:
        self.rx_secret = secret
        self.rx = DirectionKeys.from_secret(secret)
        self._rx_aead = AESGCM(self.rx.key)
        self._prepare_rx_next()

    @staticmethod
    def _next_secret(secret: bytes) -> bytes:
        return hkdf_expand_label(secret, "quic ku", b"", 32)

    def _prepare_rx_next(self) -> None:
        nxt = DirectionKeys.from_secret(self._next_secret(self.rx_secret))
        self._rx_next = (nxt, AESGCM(nxt.key))

    # -- key update ----------------------------------------------------------

    def should_initiate_update(self) -> bool:
        return (
            self.sealed_count >= self.KEY_UPDATE_AT
            and not self._update_unacked
        )

    def initiate_key_update(self) -> None:
        """Flip to next-generation TX keys (we keep accepting the peer's
        current-phase packets until it flips too)."""
        hp = self.tx.hp  # header protection never rotates
        self.tx_secret = self._next_secret(self.tx_secret)
        new = DirectionKeys.from_secret(self.tx_secret)
        self.tx = DirectionKeys(key=new.key, iv=new.iv, hp=hp)
        self._tx_aead = AESGCM(self.tx.key)
        self.sealed_count = 0
        self.key_phase ^= 1
        self._update_unacked = True

    def _promote_rx(self) -> None:
        """Peer's flipped phase decrypted with next-gen keys: make them
        current (keep the old ones for reordered packets) and, if the peer
        initiated, move our TX forward too."""
        hp = self.rx.hp
        self._rx_prev = (self.rx, self._rx_aead)
        self.rx_secret = self._next_secret(self.rx_secret)
        nxt, aead = self._rx_next
        self.rx = DirectionKeys(key=nxt.key, iv=nxt.iv, hp=hp)
        self._rx_aead = aead
        self._prepare_rx_next()
        self.rx_phase ^= 1
        if self._update_unacked:
            # the peer flipped in response to our update: both sides are
            # on the new generation now
            self._update_unacked = False
        else:
            # peer-initiated update: advance our TX to match; the peer
            # already has these keys, so nothing is pending
            self.initiate_key_update()
            self._update_unacked = False

    @property
    def ready(self) -> bool:
        return self.tx is not None and self.rx is not None

    @staticmethod
    def _nonce(iv: bytes, pn: int) -> bytes:
        return (int.from_bytes(iv, "big") ^ pn).to_bytes(12, "big")

    @staticmethod
    def _hp_mask(hp_key: bytes, sample: bytes) -> bytes:
        enc = Cipher(algorithms.AES(hp_key), modes.ECB()).encryptor()
        return enc.update(sample) + enc.finalize()

    # -- seal ---------------------------------------------------------------

    def seal(self, header_prefix: bytes, pn: int, pn_bytes: bytes,
             payload: bytes) -> bytes:
        """header_prefix excludes the pn field; returns the full protected
        packet (header + encrypted pn + ciphertext)."""
        assert self.tx is not None and self._tx_aead is not None
        header = header_prefix + pn_bytes
        self.sealed_count += 1
        ct = self._tx_aead.encrypt(self._nonce(self.tx.iv, pn), payload, header)
        pn_offset = len(header_prefix)
        sample = ct[4 - len(pn_bytes) : 20 - len(pn_bytes)]
        mask = self._hp_mask(self.tx.hp, sample)
        out = bytearray(header + ct)
        if out[0] & 0x80:  # long header: low 4 bits protected
            out[0] ^= mask[0] & 0x0F
        else:              # short header: low 5 bits
            out[0] ^= mask[0] & 0x1F
        for i in range(len(pn_bytes)):
            out[pn_offset + i] ^= mask[1 + i]
        return bytes(out)

    # -- open ---------------------------------------------------------------

    def open(self, packet: bytes, pn_offset: int, largest_pn: int,
             short_header: bool = False) -> Tuple[int, bytes]:
        """Removes header protection + AEAD. packet is the FULL datagram
        slice for this packet. -> (packet_number, plaintext)."""
        assert self.rx is not None and self._rx_aead is not None
        sample = packet[pn_offset + 4 : pn_offset + 20]
        if len(sample) < 16:
            raise ValueError("packet too short for HP sample")
        mask = self._hp_mask(self.rx.hp, sample)
        first = packet[0] ^ (mask[0] & (0x1F if short_header else 0x0F))
        pn_len = (first & 0x03) + 1
        pn_trunc = 0
        pn_bytes = bytearray()
        for i in range(pn_len):
            b = packet[pn_offset + i] ^ mask[1 + i]
            pn_bytes.append(b)
            pn_trunc = (pn_trunc << 8) | b
        from smelter_tpu_torch.io.quic.packet import decode_packet_number

        pn = decode_packet_number(pn_trunc, pn_len * 8, largest_pn)
        header = bytes([first]) + packet[1:pn_offset] + bytes(pn_bytes)
        ct = packet[pn_offset + pn_len :]
        if short_header:
            phase = (first >> 2) & 1
            if phase != self.rx_phase:
                # flipped phase: either a reordered packet from the
                # previous generation or the peer moving to the next one
                # (both carry phase == rx_phase ^ 1) — AEAD disambiguates
                if self._rx_prev is not None:
                    keys, aead = self._rx_prev
                    try:
                        pt = aead.decrypt(self._nonce(keys.iv, pn), ct, header)
                        return pn, pt
                    except Exception:
                        pass
                keys, aead = self._rx_next
                pt = aead.decrypt(self._nonce(keys.iv, pn), ct, header)
                self._promote_rx()
                return pn, pt
        pt = self._rx_aead.decrypt(self._nonce(self.rx.iv, pn), ct, header)
        return pn, pt
