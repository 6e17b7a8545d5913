"""From-scratch QUIC v1 (RFC 9000/9001/9002) — the transport under MoQ.

The reference consumes QUIC through the quinn crate
(`smelter-core/src/pipeline/moq/` via moq-native); this image ships no QUIC
library (OpenSSL 3.0 exposes no QUIC API), so the transport is implemented
here from scratch on `cryptography` hazmat primitives, the same way the
RTMP/DTLS-SRTP stacks in this repo are from-scratch protocol
implementations.

Profile implemented (enough for MoQT media sessions, client+server):
  - v1 long/short headers, Initial/Handshake/1-RTT packet protection
    (AES-128-GCM + AES-ECB header protection, RFC 9001)
  - TLS 1.3 handshake in CRYPTO frames (X25519, TLS_AES_128_GCM_SHA256,
    ECDSA-P256 self-signed certs) — `tls.py`
  - streams (bidi+uni), connection & stream flow control, MAX_* updates
  - ACK generation/processing, PTO-based loss recovery with
    retransmission of CRYPTO/STREAM data (RFC 9002 subset)
  - connection close, idle timeout, anti-amplification (3x) pre-handshake

Not implemented (not needed for this framework's MoQ use): 0-RTT, Retry,
key update, connection migration, version negotiation beyond v1, ECN.
"""

from smelter_tpu_torch.io.quic.connection import QuicConnection, QuicStreamEvent
from smelter_tpu_torch.io.quic.endpoint import QuicClient, QuicServer

__all__ = ["QuicConnection", "QuicStreamEvent", "QuicClient", "QuicServer"]
