"""WebRTC (WHIP/WHEP) transport: ICE + DTLS-SRTP + RTP over one UDP socket.

The port's copy of the equivalent of the reference's webrtc layer
(`smelter-core/src/webrtc/`, built on webrtc-rs): the DTLS handshake runs in
native code (OpenSSL), SRTP/STUN/SDP/session logic in Python.
"""

from smelter_tpu_torch.io.webrtc.session import WebRtcSession
from smelter_tpu_torch.io.webrtc.whip import (
    WhepClientInput,
    WhepServerOutput,
    WhipClientOutput,
    WhipServerInput,
)

__all__ = [
    "WebRtcSession",
    "WhipServerInput",
    "WhipClientOutput",
    "WhepServerOutput",
    "WhepClientInput",
]
