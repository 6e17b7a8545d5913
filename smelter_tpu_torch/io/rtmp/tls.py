"""TLS support for RTMPS (reference `smelter-core/src/protocols/rtmp.rs:31`
accepts the "rtmps" scheme; `rtmp/src/client.rs:94` wraps the TCP stream).

Client contexts verify against the system trust store by default, with an
``insecure`` escape hatch for self-signed endpoints (FFmpeg's rtmps behaves
the same with ``tls_verify``). The server side (an extension beyond the
reference, useful for loopback testing and private deployments) mints a
self-signed ECDSA P-256 certificate via ``cryptography``.
"""

from __future__ import annotations

import datetime
import os
import ssl
import tempfile
from typing import Optional, Tuple


def client_context(insecure: bool = False) -> ssl.SSLContext:
    ctx = ssl.create_default_context()
    if insecure:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    return ctx


def _self_signed_pem(common_name: str = "smelter-rtmps") -> Tuple[bytes, bytes]:
    """(cert_pem, key_pem) for a 10-year self-signed ECDSA P-256 cert."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now - datetime.timedelta(days=1))
        .not_valid_after(now + datetime.timedelta(days=3650))
        .sign(key, hashes.SHA256())
    )
    return (
        cert.public_bytes(serialization.Encoding.PEM),
        key.private_bytes(
            serialization.Encoding.PEM,
            serialization.PrivateFormat.PKCS8,
            serialization.NoEncryption(),
        ),
    )


def server_context(
    cert_path: Optional[str] = None, key_path: Optional[str] = None
) -> ssl.SSLContext:
    """Server TLS context; mints a self-signed cert when paths are omitted."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    if cert_path and key_path:
        ctx.load_cert_chain(cert_path, key_path)
        return ctx
    cert_pem, key_pem = _self_signed_pem()
    # load_cert_chain requires files; use a private tmpdir removed on load
    with tempfile.TemporaryDirectory(prefix="smelter-tls-") as d:
        cp, kp = os.path.join(d, "cert.pem"), os.path.join(d, "key.pem")
        with open(cp, "wb") as f:
            f.write(cert_pem)
        with open(kp, "wb") as f:
            f.write(key_pem)
        ctx.load_cert_chain(cp, kp)
    return ctx
