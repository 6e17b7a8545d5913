"""Pipeline orchestration: inputs → queue → renderer/mixer → encoders → sinks."""

from smelter_tpu_torch.pipeline.events import Emitter, Event
from smelter_tpu_torch.pipeline.input import (
    InputCtx,
    InputSource,
    Mp4Input,
    Mp4InputOptions,
    RawDataInput,
)
from smelter_tpu_torch.pipeline.instance import (
    Pipeline,
    PipelineOptions,
    RegisterInputOptions,
)
from smelter_tpu_torch.pipeline.output import (
    AudioEncoderOptions,
    EncodedDataOutputSink,
    EndCondition,
    HlsOutputSink,
    Mp4OutputSink,
    OutputAudioOptions,
    OutputVideoOptions,
    RawDataOutputSink,
    VideoEncoderOptions,
)

__all__ = [
    "Emitter",
    "Event",
    "InputCtx",
    "InputSource",
    "Mp4Input",
    "Mp4InputOptions",
    "RawDataInput",
    "Pipeline",
    "PipelineOptions",
    "RegisterInputOptions",
    "AudioEncoderOptions",
    "EncodedDataOutputSink",
    "EndCondition",
    "HlsOutputSink",
    "Mp4OutputSink",
    "OutputAudioOptions",
    "OutputVideoOptions",
    "RawDataOutputSink",
    "VideoEncoderOptions",
]
