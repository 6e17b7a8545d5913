"""From-scratch RTMP protocol stack (reference `rtmp/` crate, 9.5k LoC Rust):
handshake, chunk streams, AMF0, FLV tag bodies, server input, client output.
"""

from smelter_tpu_torch.io.rtmp import amf0
from smelter_tpu_torch.io.rtmp.chunk import ChunkReader, ChunkWriter, RtmpMessage
from smelter_tpu_torch.io.rtmp.session import (
    RtmpClientOutput,
    RtmpInputOptions,
    RtmpServerInput,
)

__all__ = [
    "amf0",
    "ChunkReader",
    "ChunkWriter",
    "RtmpMessage",
    "RtmpClientOutput",
    "RtmpInputOptions",
    "RtmpServerInput",
]
