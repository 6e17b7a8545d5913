"""MoQ (Media over QUIC) protocol family over the from-scratch QUIC stack.

Behavioral spec: the reference's `smelter-core/src/pipeline/moq/` (server,
client input, client output, hang-style JSON catalogs, Legacy/LOC/CMAF
containers, A/V timestamp aligner). The reference rides moq-lite sessions
over WebTransport (moq-native); this implementation uses a moq-lite-
flavored session protocol directly over raw QUIC with ALPN "moql/1"
(no browser endpoint exists in this deployment, so the WebTransport/H3
layer adds nothing — documented divergence, see wire.py).
"""

from smelter_tpu_torch.io.moq.input import MoqClientInput, MoqServerInput
from smelter_tpu_torch.io.moq.output import MoqClientOutput
from smelter_tpu_torch.io.moq.server import MoqServer, MoqServerState

__all__ = [
    "MoqClientInput",
    "MoqServerInput",
    "MoqClientOutput",
    "MoqServer",
    "MoqServerState",
]
