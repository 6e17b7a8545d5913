"""Minimal TLS 1.3 (RFC 8446) for QUIC handshakes (RFC 9001).

Implements exactly the profile QUIC needs — handshake messages carried in
CRYPTO frames (no record layer): X25519 key exchange,
TLS_AES_128_GCM_SHA256, ECDSA-P256 certificates (self-signed by default,
like the reference MoQ server's load_or_create_self_signed_tls,
`moq/server/certificate.rs`). No PSK/0-RTT/HelloRetryRequest/client-auth.

Certificate verification: by default the client accepts the presented
certificate but REQUIRES a valid CertificateVerify + Finished over it
(authenticating the handshake against the presented key). Full chain/name
verification is out of scope — the reference client runs with
`tls.disable_verify` against self-signed MoQ relays the same way
(`moq/output/client_output.rs:161`).
"""

from __future__ import annotations

import datetime
import os
import struct
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, hmac, serialization
from cryptography.hazmat.primitives.asymmetric import ec
from cryptography.hazmat.primitives.asymmetric.x25519 import (
    X25519PrivateKey,
    X25519PublicKey,
)

from smelter_tpu_torch.io.quic.crypto import hkdf_expand_label, hkdf_extract

# handshake message types
HT_CLIENT_HELLO = 1
HT_SERVER_HELLO = 2
HT_NEW_SESSION_TICKET = 4
HT_ENCRYPTED_EXTENSIONS = 8
HT_CERTIFICATE = 11
HT_CERTIFICATE_VERIFY = 15
HT_FINISHED = 20

# extensions
EXT_SNI = 0
EXT_SUPPORTED_GROUPS = 10
EXT_SIGNATURE_ALGORITHMS = 13
EXT_ALPN = 16
EXT_SUPPORTED_VERSIONS = 43
EXT_PSK_MODES = 45
EXT_KEY_SHARE = 51
EXT_QUIC_TRANSPORT_PARAMS = 0x39

TLS13 = 0x0304
CIPHER_AES128_GCM_SHA256 = 0x1301
GROUP_X25519 = 0x001D
SIG_ECDSA_P256_SHA256 = 0x0403
SIG_RSA_PSS_SHA256 = 0x0804

HASH_LEN = 32


class TlsError(Exception):
    pass


def _sha256(data: bytes) -> bytes:
    h = hashes.Hash(hashes.SHA256())
    h.update(data)
    return h.finalize()


def _hmac_sha256(key: bytes, data: bytes) -> bytes:
    h = hmac.HMAC(key, hashes.SHA256())
    h.update(data)
    return h.finalize()


def derive_secret(secret: bytes, label: str, transcript_hash: bytes) -> bytes:
    return hkdf_expand_label(secret, label, transcript_hash, HASH_LEN)


# ---------------------------------------------------------------------------
# self-signed certificates (reference moq/server/certificate.rs behavior)
# ---------------------------------------------------------------------------


def load_ca_bundle(pem: bytes) -> List[x509.Certificate]:
    """Parse a PEM CA bundle one certificate at a time, skipping entries the
    parser rejects (and silencing its deprecation warnings).

    System bundles ship decades-old roots with RFC 5280 violations — e.g.
    negative serial numbers — that `cryptography` currently parses with a
    CryptographyDeprecationWarning and will eventually hard-reject. A single
    bad root must not take down the whole verification path (rustls, which
    the reference's quinn uses, likewise skips unparseable anchors)."""
    import re
    import warnings

    blocks = re.findall(
        b"-----BEGIN CERTIFICATE-----.*?-----END CERTIFICATE-----",
        pem,
        re.DOTALL,
    )
    roots: List[x509.Certificate] = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for block in blocks:
            try:
                roots.append(x509.load_pem_x509_certificate(block))
            except Exception:
                continue
    return roots


def generate_self_signed(common_name: str = "smelter-tpu") -> Tuple[bytes, bytes]:
    """-> (cert_der, key_pem) — ECDSA P-256, 1 year validity."""
    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(x509.NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(
            x509.SubjectAlternativeName([x509.DNSName("localhost")]),
            critical=False,
        )
        .sign(key, hashes.SHA256())
    )
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    return cert.public_bytes(serialization.Encoding.DER), key_pem


def load_or_create_self_signed(dir_path: str) -> Tuple[bytes, bytes]:
    """Persist the self-signed pair like the reference
    (`certificate.rs` load_or_create_self_signed_tls)."""
    os.makedirs(dir_path, exist_ok=True)
    cert_path = os.path.join(dir_path, "moq_cert.der")
    key_path = os.path.join(dir_path, "moq_key.pem")
    if os.path.exists(cert_path) and os.path.exists(key_path):
        with open(cert_path, "rb") as f:
            cert = f.read()
        with open(key_path, "rb") as f:
            key = f.read()
        try:
            parsed = x509.load_der_x509_certificate(cert)
            if parsed.not_valid_after_utc > datetime.datetime.now(
                datetime.timezone.utc
            ) + datetime.timedelta(days=7):
                return cert, key
        except Exception:
            pass
    cert, key = generate_self_signed()
    with open(cert_path, "wb") as f:
        f.write(cert)
    with open(key_path, "wb") as f:
        f.write(key)
    return cert, key


# ---------------------------------------------------------------------------
# wire helpers
# ---------------------------------------------------------------------------


def _u16(v: int) -> bytes:
    return struct.pack("!H", v)


def _vec8(data: bytes) -> bytes:
    return bytes([len(data)]) + data


def _vec16(data: bytes) -> bytes:
    return _u16(len(data)) + data


def _vec24(data: bytes) -> bytes:
    return len(data).to_bytes(3, "big") + data


def _ext(etype: int, body: bytes) -> bytes:
    return _u16(etype) + _vec16(body)


def _handshake_msg(htype: int, body: bytes) -> bytes:
    return bytes([htype]) + _vec24(body)


def _parse_extensions(data: bytes) -> Dict[int, bytes]:
    out: Dict[int, bytes] = {}
    pos = 0
    while pos + 4 <= len(data):
        et, ln = struct.unpack("!HH", data[pos : pos + 4])
        out[et] = data[pos + 4 : pos + 4 + ln]
        pos += 4 + ln
    return out


# epoch = which QUIC packet-number space carries the message
EPOCH_INITIAL = 0
EPOCH_HANDSHAKE = 2
EPOCH_1RTT = 3


@dataclass
class TlsOutput:
    """One handshake flight fragment to be sent in CRYPTO frames."""

    epoch: int
    data: bytes


class TlsSession:
    """Drives one TLS 1.3 handshake over QUIC CRYPTO streams.

    Feed inbound handshake bytes per epoch with `handle_crypto`; collect
    outbound flights from `.outputs`. Secrets are delivered via callbacks
    set by the QUIC connection:
      on_handshake_secrets(tx, rx), on_app_secrets(tx, rx),
      on_handshake_complete().
    """

    def __init__(
        self,
        is_client: bool,
        alpn: List[str],
        transport_params: bytes,
        server_name: Optional[str] = None,
        cert_der: Optional[bytes] = None,
        key_pem: Optional[bytes] = None,
        verify_peer: bool = False,
    ) -> None:
        self.is_client = is_client
        self.alpn = alpn
        self.negotiated_alpn: Optional[str] = None
        self.transport_params = transport_params
        self.peer_transport_params: Optional[bytes] = None
        self.server_name = server_name
        self.cert_der = cert_der
        self.key_pem = key_pem
        self.verify_peer = verify_peer
        self.peer_cert_der: Optional[bytes] = None
        self.peer_cert_chain_der: List[bytes] = []
        self.outputs: List[TlsOutput] = []
        self.on_handshake_secrets: Optional[Callable[[bytes, bytes], None]] = None
        self.on_app_secrets: Optional[Callable[[bytes, bytes], None]] = None
        self.on_handshake_complete: Optional[Callable[[], None]] = None
        self.complete = False

        self._transcript = b""
        self._privkey = X25519PrivateKey.generate()
        self._client_random = os.urandom(32)
        self._buffers: Dict[int, bytes] = {EPOCH_INITIAL: b"", EPOCH_HANDSHAKE: b"",
                                           EPOCH_1RTT: b""}
        self._hs_secret: Optional[bytes] = None
        self._master: Optional[bytes] = None
        self._c_hs: Optional[bytes] = None
        self._s_hs: Optional[bytes] = None
        self._sent_finished = False

        if is_client:
            self._send_client_hello()

    # -- transcript ----------------------------------------------------------

    def _th(self) -> bytes:
        return _sha256(self._transcript)

    # -- client side -----------------------------------------------------------

    def _send_client_hello(self) -> None:
        pub = self._privkey.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
        exts = bytearray()
        if self.server_name:
            host = self.server_name.encode()
            exts += _ext(EXT_SNI, _vec16(b"\x00" + _vec16(host)))
        exts += _ext(EXT_SUPPORTED_GROUPS, _vec16(_u16(GROUP_X25519)))
        exts += _ext(
            EXT_SIGNATURE_ALGORITHMS,
            _vec16(_u16(SIG_ECDSA_P256_SHA256) + _u16(SIG_RSA_PSS_SHA256)),
        )
        if self.alpn:
            alpn_list = b"".join(_vec8(a.encode()) for a in self.alpn)
            exts += _ext(EXT_ALPN, _vec16(alpn_list))
        exts += _ext(EXT_SUPPORTED_VERSIONS, _vec8(_u16(TLS13)))
        exts += _ext(EXT_PSK_MODES, _vec8(bytes([1])))  # psk_dhe_ke
        exts += _ext(EXT_KEY_SHARE, _vec16(_u16(GROUP_X25519) + _vec16(pub)))
        exts += _ext(EXT_QUIC_TRANSPORT_PARAMS, self.transport_params)
        body = (
            _u16(0x0303)
            + self._client_random
            + _vec8(b"")                        # legacy session id
            + _vec16(_u16(CIPHER_AES128_GCM_SHA256))
            + _vec8(b"\x00")                    # null compression
            + _vec16(bytes(exts))
        )
        msg = _handshake_msg(HT_CLIENT_HELLO, body)
        self._transcript += msg
        self.outputs.append(TlsOutput(EPOCH_INITIAL, msg))

    # -- inbound dispatch -------------------------------------------------------

    def handle_crypto(self, epoch: int, data: bytes) -> None:
        """Feed reassembled CRYPTO bytes for an epoch (in stream order)."""
        self._buffers[epoch] += data
        while True:
            buf = self._buffers[epoch]
            if len(buf) < 4:
                return
            ln = int.from_bytes(buf[1:4], "big")
            if len(buf) < 4 + ln:
                return
            msg, self._buffers[epoch] = buf[: 4 + ln], buf[4 + ln :]
            self._handle_message(epoch, msg[0], msg)

    def _handle_message(self, epoch: int, htype: int, msg: bytes) -> None:
        if htype == HT_NEW_SESSION_TICKET:
            return  # no session resumption
        if self.is_client:
            self._client_handle(epoch, htype, msg)
        else:
            self._server_handle(epoch, htype, msg)

    # -- key schedule ------------------------------------------------------------

    def _compute_handshake_secrets(self, peer_pub: bytes) -> None:
        shared = self._privkey.exchange(X25519PublicKey.from_public_bytes(peer_pub))
        early = hkdf_extract(b"\x00" * HASH_LEN, b"\x00" * HASH_LEN)
        derived = derive_secret(early, "derived", _sha256(b""))
        self._hs_secret = hkdf_extract(derived, shared)
        th = self._th()  # CH..SH
        self._c_hs = derive_secret(self._hs_secret, "c hs traffic", th)
        self._s_hs = derive_secret(self._hs_secret, "s hs traffic", th)
        derived2 = derive_secret(self._hs_secret, "derived", _sha256(b""))
        self._master = hkdf_extract(derived2, b"\x00" * HASH_LEN)
        if self.on_handshake_secrets:
            if self.is_client:
                self.on_handshake_secrets(self._c_hs, self._s_hs)
            else:
                self.on_handshake_secrets(self._s_hs, self._c_hs)

    def _compute_app_secrets(self) -> Tuple[bytes, bytes]:
        """Call with transcript = CH..server Finished."""
        th = self._th()
        c_ap = derive_secret(self._master, "c ap traffic", th)
        s_ap = derive_secret(self._master, "s ap traffic", th)
        return c_ap, s_ap

    @staticmethod
    def _finished_verify(base_secret: bytes, transcript_hash: bytes) -> bytes:
        fk = hkdf_expand_label(base_secret, "finished", b"", HASH_LEN)
        return _hmac_sha256(fk, transcript_hash)

    _CV_CONTEXT_SERVER = b" " * 64 + b"TLS 1.3, server CertificateVerify" + b"\x00"

    # -- client message handling ---------------------------------------------------

    def _client_handle(self, epoch: int, htype: int, msg: bytes) -> None:
        if htype == HT_SERVER_HELLO:
            body = msg[4:]
            # parse: version(2) random(32) sid_len+sid cipher(2) comp(1) exts
            pos = 2 + 32
            sid_len = body[pos]; pos += 1 + sid_len
            cipher = struct.unpack("!H", body[pos : pos + 2])[0]; pos += 2
            pos += 1  # compression
            ext_len = struct.unpack("!H", body[pos : pos + 2])[0]; pos += 2
            exts = _parse_extensions(body[pos : pos + ext_len])
            if cipher != CIPHER_AES128_GCM_SHA256:
                raise TlsError(f"unsupported cipher {cipher:#x}")
            ks = exts.get(EXT_KEY_SHARE)
            if not ks:
                raise TlsError("no key_share in ServerHello")
            group = struct.unpack("!H", ks[:2])[0]
            if group != GROUP_X25519:
                raise TlsError("server chose unsupported group")
            klen = struct.unpack("!H", ks[2:4])[0]
            peer_pub = ks[4 : 4 + klen]
            self._transcript += msg
            self._compute_handshake_secrets(peer_pub)
        elif htype == HT_ENCRYPTED_EXTENSIONS:
            exts = _parse_extensions(msg[4 + 2 :])
            tp = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
            if tp is not None:
                self.peer_transport_params = tp
            alpn = exts.get(EXT_ALPN)
            if alpn:
                n = alpn[2]
                self.negotiated_alpn = alpn[3 : 3 + n].decode()
            self._transcript += msg
        elif htype == HT_CERTIFICATE:
            body = msg[4:]
            ctx_len = body[0]
            pos = 1 + ctx_len
            list_len = int.from_bytes(body[pos : pos + 3], "big"); pos += 3
            end = pos + list_len
            self.peer_cert_chain_der = []
            while pos + 3 <= end:
                cert_len = int.from_bytes(body[pos : pos + 3], "big"); pos += 3
                self.peer_cert_chain_der.append(body[pos : pos + cert_len])
                pos += cert_len
                if pos + 2 > end:
                    break
                ext_len = struct.unpack("!H", body[pos : pos + 2])[0]
                pos += 2 + ext_len
            self.peer_cert_der = (
                self.peer_cert_chain_der[0] if self.peer_cert_chain_der else None
            )
            if self.verify_peer:
                self._verify_peer_chain()
            self._transcript += msg
        elif htype == HT_CERTIFICATE_VERIFY:
            self._handle_certificate_verify(msg)
        elif htype == HT_FINISHED:
            self._handle_server_finished(msg)
        else:
            raise TlsError(f"unexpected handshake message {htype}")

    def _verify_peer_chain(self) -> None:
        """Chain + hostname verification against the system trust store
        (quinn/rustls default behavior in the reference's MoQ client;
        SMELTER_MOQ_DISABLE_TLS_VERIFICATION turns it off). The CA bundle
        can be overridden with SSL_CERT_FILE."""
        import ipaddress

        from cryptography.x509.verification import PolicyBuilder, Store

        if not self.peer_cert_chain_der:
            raise TlsError("server sent no certificate")
        bundle = os.environ.get(
            "SSL_CERT_FILE", "/etc/ssl/certs/ca-certificates.crt"
        )
        try:
            with open(bundle, "rb") as f:
                roots = load_ca_bundle(f.read())
        except OSError as exc:
            raise TlsError(
                f"TLS verification enabled but no CA bundle at {bundle}: {exc}"
            ) from exc
        if not roots:
            raise TlsError(f"no usable root certificates in {bundle}")
        name = self.server_name or ""
        try:
            subject = x509.IPAddress(ipaddress.ip_address(name))
        except ValueError:
            subject = x509.DNSName(name)
        verifier = (
            PolicyBuilder().store(Store(roots)).build_server_verifier(subject)
        )
        leaf = x509.load_der_x509_certificate(self.peer_cert_chain_der[0])
        intermediates = [
            x509.load_der_x509_certificate(c)
            for c in self.peer_cert_chain_der[1:]
        ]
        try:
            verifier.verify(leaf, intermediates)
        except Exception as exc:
            raise TlsError(
                f"server certificate verification failed for "
                f"{name!r}: {exc}"
            ) from exc

    def _handle_certificate_verify(self, msg: bytes) -> None:
        body = msg[4:]
        sig_alg = struct.unpack("!H", body[:2])[0]
        sig_len = struct.unpack("!H", body[2:4])[0]
        sig = body[4 : 4 + sig_len]
        signed = self._CV_CONTEXT_SERVER + self._th()
        if self.peer_cert_der is None:
            raise TlsError("CertificateVerify before Certificate")
        cert = x509.load_der_x509_certificate(self.peer_cert_der)
        pub = cert.public_key()
        try:
            if sig_alg == SIG_ECDSA_P256_SHA256:
                pub.verify(sig, signed, ec.ECDSA(hashes.SHA256()))
            elif sig_alg == SIG_RSA_PSS_SHA256:
                from cryptography.hazmat.primitives.asymmetric import padding

                pub.verify(
                    sig, signed,
                    padding.PSS(mgf=padding.MGF1(hashes.SHA256()),
                                salt_length=32),
                    hashes.SHA256(),
                )
            else:
                raise TlsError(f"unsupported signature algorithm {sig_alg:#x}")
        except TlsError:
            raise
        except Exception as exc:
            raise TlsError(f"CertificateVerify failed: {exc}") from exc
        self._transcript += msg

    def _handle_server_finished(self, msg: bytes) -> None:
        expect = self._finished_verify(self._s_hs, self._th())
        if msg[4:] != expect:
            raise TlsError("server Finished verify_data mismatch")
        self._transcript += msg
        # client app secrets use transcript through server Finished
        c_ap, s_ap = self._compute_app_secrets()
        # client Finished (transcript through server Finished)
        verify = self._finished_verify(self._c_hs, self._th())
        fin = _handshake_msg(HT_FINISHED, verify)
        self._transcript += fin
        self.outputs.append(TlsOutput(EPOCH_HANDSHAKE, fin))
        self._sent_finished = True
        if self.on_app_secrets:
            self.on_app_secrets(c_ap, s_ap)
        self.complete = True
        if self.on_handshake_complete:
            self.on_handshake_complete()

    # -- server message handling ---------------------------------------------------

    def _server_handle(self, epoch: int, htype: int, msg: bytes) -> None:
        if htype == HT_CLIENT_HELLO:
            self._transcript += msg
            self._respond_to_client_hello(msg[4:])
        elif htype == HT_FINISHED:
            expect = self._finished_verify(self._c_hs, self._th())
            if msg[4:] != expect:
                raise TlsError("client Finished verify_data mismatch")
            self._transcript += msg
            self.complete = True
            if self.on_handshake_complete:
                self.on_handshake_complete()
        else:
            raise TlsError(f"unexpected handshake message {htype}")

    def _respond_to_client_hello(self, body: bytes) -> None:
        pos = 2 + 32
        sid_len = body[pos]
        session_id = body[pos + 1 : pos + 1 + sid_len]
        pos += 1 + sid_len
        cs_len = struct.unpack("!H", body[pos : pos + 2])[0]; pos += 2
        ciphers = [struct.unpack("!H", body[pos + i : pos + i + 2])[0]
                   for i in range(0, cs_len, 2)]
        pos += cs_len
        comp_len = body[pos]; pos += 1 + comp_len
        ext_len = struct.unpack("!H", body[pos : pos + 2])[0]; pos += 2
        exts = _parse_extensions(body[pos : pos + ext_len])
        if CIPHER_AES128_GCM_SHA256 not in ciphers:
            raise TlsError("client offers no supported cipher")
        ks = exts.get(EXT_KEY_SHARE)
        if not ks:
            raise TlsError("no key_share in ClientHello")
        # key_share list: len(2) then entries
        kpos = 2
        peer_pub = None
        while kpos + 4 <= len(ks):
            group, klen = struct.unpack("!HH", ks[kpos : kpos + 4])
            if group == GROUP_X25519:
                peer_pub = ks[kpos + 4 : kpos + 4 + klen]
                break
            kpos += 4 + klen
        if peer_pub is None:
            raise TlsError("no x25519 key share offered")
        tp = exts.get(EXT_QUIC_TRANSPORT_PARAMS)
        if tp is not None:
            self.peer_transport_params = tp
        # ALPN selection
        alpn_ext = exts.get(EXT_ALPN)
        offered: List[str] = []
        if alpn_ext and len(alpn_ext) >= 2:
            apos = 2
            while apos < len(alpn_ext):
                n = alpn_ext[apos]
                offered.append(alpn_ext[apos + 1 : apos + 1 + n].decode())
                apos += 1 + n
        chosen = next((a for a in self.alpn if a in offered), None)
        if self.alpn and offered and chosen is None:
            raise TlsError(f"no common ALPN (offered {offered})")
        self.negotiated_alpn = chosen

        pub = self._privkey.public_key().public_bytes(
            serialization.Encoding.Raw, serialization.PublicFormat.Raw
        )
        sh_exts = (
            _ext(EXT_SUPPORTED_VERSIONS, _u16(TLS13))
            + _ext(EXT_KEY_SHARE, _u16(GROUP_X25519) + _vec16(pub))
        )
        sh_body = (
            _u16(0x0303)
            + os.urandom(32)
            + _vec8(session_id)
            + _u16(CIPHER_AES128_GCM_SHA256)
            + b"\x00"
            + _vec16(sh_exts)
        )
        sh = _handshake_msg(HT_SERVER_HELLO, sh_body)
        self._transcript += sh
        self.outputs.append(TlsOutput(EPOCH_INITIAL, sh))
        self._compute_handshake_secrets(peer_pub)

        # EncryptedExtensions
        ee_exts = _ext(EXT_QUIC_TRANSPORT_PARAMS, self.transport_params)
        if chosen:
            ee_exts += _ext(EXT_ALPN, _vec16(_vec8(chosen.encode())))
        ee = _handshake_msg(HT_ENCRYPTED_EXTENSIONS, _vec16(ee_exts))
        self._transcript += ee

        # Certificate
        if self.cert_der is None or self.key_pem is None:
            raise TlsError("server has no certificate")
        cert_entry = _vec24(self.cert_der) + _u16(0)  # no per-cert extensions
        cert_body = _vec8(b"") + _vec24(cert_entry)
        cert_msg = _handshake_msg(HT_CERTIFICATE, cert_body)
        self._transcript += cert_msg

        # CertificateVerify
        key = serialization.load_pem_private_key(self.key_pem, password=None)
        signed = self._CV_CONTEXT_SERVER + self._th()
        sig = key.sign(signed, ec.ECDSA(hashes.SHA256()))
        cv = _handshake_msg(
            HT_CERTIFICATE_VERIFY, _u16(SIG_ECDSA_P256_SHA256) + _vec16(sig)
        )
        self._transcript += cv

        # Finished
        verify = self._finished_verify(self._s_hs, self._th())
        fin = _handshake_msg(HT_FINISHED, verify)
        self._transcript += fin
        self.outputs.append(TlsOutput(EPOCH_HANDSHAKE, ee + cert_msg + cv + fin))

        # app secrets (transcript through server Finished)
        c_ap, s_ap = self._compute_app_secrets()
        if self.on_app_secrets:
            self.on_app_secrets(s_ap, c_ap)

    # -- misc ---------------------------------------------------------------------

    def take_outputs(self) -> List[TlsOutput]:
        out, self.outputs = self.outputs, []
        return out
