"""Wire-format API schema (pydantic), JSON-compatible with the reference.

Mirrors `smelter-api/` serde types: tag="type", snake_case variants,
deny_unknown_fields (pydantic extra="forbid"). A client written against the
reference server's JSON API (`smelter-api/src/video/component.rs:10-21`,
`src/routes/register_request.rs:25-50`) can talk to this server unchanged.
"""

from __future__ import annotations

from typing import Annotated, Dict, List, Literal, Optional, Tuple, Union

from pydantic import BaseModel, ConfigDict, Field


class ApiModel(BaseModel):
    model_config = ConfigDict(extra="forbid")


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------


class Resolution(ApiModel):
    width: int
    height: int


# "#RRGGBB", "#RRGGBBAA" or a named CSS color
RGBAColorStr = str
# "W:H"
AspectRatioStr = str


class Transition(ApiModel):
    duration_ms: float
    easing_function: Optional["EasingFunction"] = None
    should_interrupt: Optional[bool] = None


class EasingLinear(ApiModel):
    function_name: Literal["linear"]


class EasingBounce(ApiModel):
    function_name: Literal["bounce"]


class EasingCubicBezier(ApiModel):
    function_name: Literal["cubic_bezier"]
    points: Tuple[float, float, float, float]


EasingFunction = Annotated[
    Union[EasingLinear, EasingBounce, EasingCubicBezier],
    Field(discriminator="function_name"),
]


class BoxShadow(ApiModel):
    offset_x: Optional[float] = None
    offset_y: Optional[float] = None
    color: Optional[RGBAColorStr] = None
    blur_radius: Optional[float] = None


# ---------------------------------------------------------------------------
# video components (smelter-api/src/video/component.rs)
# ---------------------------------------------------------------------------

Overflow = Literal["visible", "hidden", "fit"]
ViewDirection = Literal["row", "column"]
RescaleMode = Literal["fit", "fill"]
HorizontalAlign = Literal["left", "right", "justified", "center"]
VerticalAlign = Literal["top", "center", "bottom", "justified"]
TextStyle = Literal["normal", "italic", "oblique"]
TextWrapMode = Literal["none", "glyph", "word"]
TextWeight = Literal[
    "thin", "extra_light", "light", "normal", "medium",
    "semi_bold", "bold", "extra_bold", "black",
]


class InputStream(ApiModel):
    type: Literal["input_stream"]
    id: Optional[str] = None
    input_id: str


class View(ApiModel):
    type: Literal["view"]
    id: Optional[str] = None
    children: Optional[List["Component"]] = None
    width: Optional[float] = None
    height: Optional[float] = None
    direction: Optional[ViewDirection] = None
    top: Optional[float] = None
    left: Optional[float] = None
    bottom: Optional[float] = None
    right: Optional[float] = None
    rotation: Optional[float] = None
    transition: Optional[Transition] = None
    overflow: Optional[Overflow] = None
    background_color: Optional[RGBAColorStr] = None
    border_radius: Optional[float] = None
    border_width: Optional[float] = None
    border_color: Optional[RGBAColorStr] = None
    box_shadow: Optional[List[BoxShadow]] = None
    padding: Optional[float] = None
    padding_vertical: Optional[float] = None
    padding_horizontal: Optional[float] = None
    padding_top: Optional[float] = None
    padding_right: Optional[float] = None
    padding_bottom: Optional[float] = None
    padding_left: Optional[float] = None


class Rescaler(ApiModel):
    type: Literal["rescaler"]
    id: Optional[str] = None
    child: "Component"
    mode: Optional[RescaleMode] = None
    horizontal_align: Optional[HorizontalAlign] = None
    vertical_align: Optional[VerticalAlign] = None
    width: Optional[float] = None
    height: Optional[float] = None
    top: Optional[float] = None
    left: Optional[float] = None
    bottom: Optional[float] = None
    right: Optional[float] = None
    rotation: Optional[float] = None
    transition: Optional[Transition] = None
    border_radius: Optional[float] = None
    border_width: Optional[float] = None
    border_color: Optional[RGBAColorStr] = None
    box_shadow: Optional[List[BoxShadow]] = None


class Tiles(ApiModel):
    type: Literal["tiles"]
    id: Optional[str] = None
    children: Optional[List["Component"]] = None
    width: Optional[float] = None
    height: Optional[float] = None
    background_color: Optional[RGBAColorStr] = None
    tile_aspect_ratio: Optional[AspectRatioStr] = None
    margin: Optional[float] = None
    padding: Optional[float] = None
    horizontal_align: Optional[HorizontalAlign] = None
    vertical_align: Optional[VerticalAlign] = None
    transition: Optional[Transition] = None


class Text(ApiModel):
    type: Literal["text"]
    id: Optional[str] = None
    text: str
    width: Optional[float] = None
    height: Optional[float] = None
    max_width: Optional[float] = None
    max_height: Optional[float] = None
    font_size: float
    line_height: Optional[float] = None
    color: Optional[RGBAColorStr] = None
    background_color: Optional[RGBAColorStr] = None
    font_family: Optional[str] = None
    style: Optional[TextStyle] = None
    align: Optional[HorizontalAlign] = None
    wrap: Optional[TextWrapMode] = None
    weight: Optional[TextWeight] = None


class Image(ApiModel):
    type: Literal["image"]
    id: Optional[str] = None
    image_id: str
    width: Optional[float] = None
    height: Optional[float] = None


class ShaderParamF32(ApiModel):
    type: Literal["f32"]
    value: float


class ShaderParamU32(ApiModel):
    type: Literal["u32"]
    value: int


class ShaderParamI32(ApiModel):
    type: Literal["i32"]
    value: int


class ShaderParamList(ApiModel):
    type: Literal["list"]
    value: List["ShaderParam"]


class ShaderParamStruct(ApiModel):
    type: Literal["struct"]
    value: List["ShaderParamStructField"]


ShaderParam = Annotated[
    Union[ShaderParamF32, ShaderParamU32, ShaderParamI32, ShaderParamList,
          ShaderParamStruct],
    Field(discriminator="type"),
]


class ShaderParamStructField(BaseModel):
    # (reference uses #[serde(flatten)] — field_name + the param fields)
    model_config = ConfigDict(extra="forbid")
    field_name: str
    type: str
    value: object


class Shader(ApiModel):
    type: Literal["shader"]
    id: Optional[str] = None
    children: Optional[List["Component"]] = None
    shader_id: str
    shader_param: Optional[ShaderParam] = None
    resolution: Resolution


class WebView(ApiModel):
    type: Literal["web_view"]
    id: Optional[str] = None
    children: Optional[List["Component"]] = None
    instance_id: str


Component = Annotated[
    Union[InputStream, View, WebView, Shader, Image, Text, Tiles, Rescaler],
    Field(discriminator="type"),
]


class VideoScene(ApiModel):
    root: Component


# ---------------------------------------------------------------------------
# audio (smelter-api/src/audio.rs)
# ---------------------------------------------------------------------------


class AudioSceneInput(ApiModel):
    input_id: str
    volume: Optional[float] = None


class AudioScene(ApiModel):
    inputs: List[AudioSceneInput]


AudioMixingStrategy = Literal["sum_clip", "sum_scale"]
AudioChannels = Literal["mono", "stereo"]


# ---------------------------------------------------------------------------
# outputs (smelter-api/src/output/)
# ---------------------------------------------------------------------------


class OutputEndCondition(ApiModel):
    any_of: Optional[List[str]] = None
    all_of: Optional[List[str]] = None
    any_input: Optional[bool] = None
    all_inputs: Optional[bool] = None


H264EncoderPreset = Literal[
    "ultrafast", "superfast", "veryfast", "faster", "fast",
    "medium", "slow", "slower", "veryslow", "placebo",
]


class FfmpegH264Encoder(ApiModel):
    type: Literal["ffmpeg_h264"]
    preset: Optional[H264EncoderPreset] = None
    bitrate: Optional[Union[int, Dict[str, int]]] = None
    keyframe_interval_ms: Optional[float] = None
    pixel_format: Optional[Literal["yuv420p", "yuv422p", "yuv444p"]] = None
    ffmpeg_options: Optional[Dict[str, str]] = None


class FfmpegVp8Encoder(ApiModel):
    type: Literal["ffmpeg_vp8"]
    bitrate: Optional[Union[int, Dict[str, int]]] = None
    keyframe_interval_ms: Optional[float] = None
    ffmpeg_options: Optional[Dict[str, str]] = None


class FfmpegVp9Encoder(ApiModel):
    type: Literal["ffmpeg_vp9"]
    bitrate: Optional[Union[int, Dict[str, int]]] = None
    keyframe_interval_ms: Optional[float] = None
    pixel_format: Optional[Literal["yuv420p", "yuv422p", "yuv444p"]] = None
    ffmpeg_options: Optional[Dict[str, str]] = None


class FfmpegAv1Encoder(ApiModel):
    """Beyond-reference: AV1 encode (libaom via the native service); usable
    on mp4/rtmp (enhanced-RTMP av01) /rtp/webrtc outputs (av1-rtp-spec)."""

    type: Literal["ffmpeg_av1"]
    bitrate: Optional[Union[int, Dict[str, int]]] = None
    keyframe_interval_ms: Optional[float] = None
    pixel_format: Optional[Literal["yuv420p", "yuv422p", "yuv444p"]] = None
    ffmpeg_options: Optional[Dict[str, str]] = None


VideoEncoderOptions = Annotated[
    Union[FfmpegH264Encoder, FfmpegVp8Encoder, FfmpegVp9Encoder,
          FfmpegAv1Encoder],
    Field(discriminator="type"),
]


class AacEncoder(ApiModel):
    type: Literal["aac"]
    sample_rate: Optional[int] = None


class OpusEncoder(ApiModel):
    type: Literal["opus"]
    preset: Optional[Literal["quality", "voip", "lowest_latency"]] = None
    sample_rate: Optional[int] = None
    forward_error_correction: Optional[bool] = None
    expected_packet_loss: Optional[int] = None


AudioEncoderOptions = Annotated[
    Union[AacEncoder, OpusEncoder], Field(discriminator="type")
]


class OutputVideoOptions(ApiModel):
    resolution: Resolution
    send_eos_when: Optional[OutputEndCondition] = None
    encoder: VideoEncoderOptions
    initial: VideoScene


class OutputAudioOptions(ApiModel):
    mixing_strategy: Optional[AudioMixingStrategy] = None
    send_eos_when: Optional[OutputEndCondition] = None
    encoder: AudioEncoderOptions
    channels: Optional[AudioChannels] = None
    initial: AudioScene


class Mp4Output(ApiModel):
    type: Literal["mp4"]
    path: str
    video: Optional[OutputVideoOptions] = None
    audio: Optional[OutputAudioOptions] = None
    ffmpeg_options: Optional[Dict[str, str]] = None


class HlsOutput(ApiModel):
    type: Literal["hls"]
    path: str
    max_playlist_size: Optional[int] = None
    video: Optional[OutputVideoOptions] = None
    audio: Optional[OutputAudioOptions] = None
    ffmpeg_options: Optional[Dict[str, str]] = None


class RtpOutput(ApiModel):
    type: Literal["rtp_stream"]
    port: Union[int, str]
    ip: Optional[str] = None
    transport_protocol: Optional[Literal["udp", "tcp_server"]] = None
    video: Optional[OutputVideoOptions] = None
    audio: Optional[OutputAudioOptions] = None


class RtmpOutput(ApiModel):
    type: Literal["rtmp_client"]
    url: str
    video: Optional[OutputVideoOptions] = None
    audio: Optional[OutputAudioOptions] = None


class VulkanH264Encoder(ApiModel):
    """Accepted for wire parity (reference WhipVideoEncoderOptions::VulkanH264);
    no video ASIC on TPU hosts, so it resolves to the software h264 encoder."""

    type: Literal["vulkan_h264"]
    bitrate: Optional[Union[int, Dict[str, int]]] = None
    keyframe_interval_ms: Optional[float] = None


class AnyVideoEncoder(ApiModel):
    type: Literal["any"]


WhipVideoEncoderPreference = Annotated[
    Union[FfmpegH264Encoder, FfmpegVp8Encoder, FfmpegVp9Encoder,
          FfmpegAv1Encoder, VulkanH264Encoder, AnyVideoEncoder],
    Field(discriminator="type"),
]


class AnyAudioEncoder(ApiModel):
    type: Literal["any"]


WhipAudioEncoderPreference = Annotated[
    Union[OpusEncoder, AnyAudioEncoder], Field(discriminator="type")
]


class WhipOutputVideoOptions(ApiModel):
    """Reference OutputWhipVideoOptions: `encoder_preferences` list; this
    build also accepts a direct `encoder` (one of the two must be set)."""

    resolution: Resolution
    send_eos_when: Optional[OutputEndCondition] = None
    encoder: Optional[VideoEncoderOptions] = None
    encoder_preferences: Optional[List[WhipVideoEncoderPreference]] = None
    initial: VideoScene


class WhipOutputAudioOptions(ApiModel):
    mixing_strategy: Optional[AudioMixingStrategy] = None
    send_eos_when: Optional[OutputEndCondition] = None
    encoder: Optional[AudioEncoderOptions] = None
    encoder_preferences: Optional[List[WhipAudioEncoderPreference]] = None
    channels: Optional[AudioChannels] = None
    initial: AudioScene


class WhipOutput(ApiModel):
    type: Literal["whip_client"]
    endpoint_url: str
    bearer_token: Optional[str] = None
    video: Optional[WhipOutputVideoOptions] = None
    audio: Optional[WhipOutputAudioOptions] = None


class WhepOutput(ApiModel):
    type: Literal["whep_server"]
    bearer_token: Optional[str] = None
    video: Optional[WhipOutputVideoOptions] = None
    audio: Optional[WhipOutputAudioOptions] = None


class MoqClientOutput(ApiModel):
    """Reference smelter-api/src/output/moq_client.rs MoqClientOutput."""

    type: Literal["moq_client"]
    endpoint_url: str
    broadcast_path: str
    container: Optional[Literal["legacy", "cmaf", "loc"]] = None
    video: Optional[OutputVideoOptions] = None
    audio: Optional[OutputAudioOptions] = None


RegisterOutput = Annotated[
    Union[RtpOutput, RtmpOutput, MoqClientOutput, Mp4Output, WhipOutput,
          WhepOutput, HlsOutput],
    Field(discriminator="type"),
]


# ---------------------------------------------------------------------------
# inputs (smelter-api/src/input/)
# ---------------------------------------------------------------------------


class Mp4Input(ApiModel):
    type: Literal["mp4"]
    url: Optional[str] = None
    path: Optional[str] = None
    loop_: Optional[bool] = Field(default=None, alias="loop")
    required: Optional[bool] = None
    offset_ms: Optional[float] = None
    seek_ms: Optional[float] = None
    decoder_map: Optional[Dict[str, str]] = None
    side_channel: Optional[Dict[str, object]] = None

    model_config = ConfigDict(extra="forbid", populate_by_name=True)


class InputVideoDecoder(ApiModel):
    pass


class RtpInputVideoOptions(ApiModel):
    decoder: Optional[str] = None


class RtpInputAudioOptions(ApiModel):
    decoder: Optional[str] = None
    sample_rate: Optional[int] = None
    forward_error_correction: Optional[bool] = None
    # AAC AudioSpecificConfig as hex (RFC 3640 out-of-band config)
    audio_specific_config: Optional[str] = None


class RtpInput(ApiModel):
    type: Literal["rtp_stream"]
    port: Union[int, str]
    transport_protocol: Optional[Literal["udp", "tcp_server"]] = None
    video: Optional[RtpInputVideoOptions] = None
    audio: Optional[RtpInputAudioOptions] = None
    required: Optional[bool] = None
    offset_ms: Optional[float] = None
    # reference rtp.rs buffer_size_ms (minimum jitter buffer depth);
    # jitter_buffer is this build's richer extension (mode + window)
    buffer_size_ms: Optional[float] = None
    jitter_buffer: Optional[Dict[str, object]] = None
    side_channel: Optional[Dict[str, object]] = None


class HlsInput(ApiModel):
    type: Literal["hls"]
    url: str
    required: Optional[bool] = None
    offset_ms: Optional[float] = None
    decoder_map: Optional[Dict[str, str]] = None
    side_channel: Optional[Dict[str, object]] = None


class RtmpInput(ApiModel):
    type: Literal["rtmp_server"]
    port: Optional[int] = None
    app: Optional[str] = None
    stream_key: Optional[str] = None
    required: Optional[bool] = None
    offset_ms: Optional[float] = None
    decoder_map: Optional[Dict[str, str]] = None
    side_channel: Optional[Dict[str, object]] = None


class WhipInput(ApiModel):
    type: Literal["whip_server"]
    bearer_token: Optional[str] = None
    video: Optional[Dict[str, object]] = None  # {"decoder_preferences": [...]}
    required: Optional[bool] = None
    offset_ms: Optional[float] = None
    buffer_size_ms: Optional[float] = None
    side_channel: Optional[Dict[str, object]] = None


class WhepInput(ApiModel):
    type: Literal["whep_client"]
    endpoint_url: str
    bearer_token: Optional[str] = None
    video: Optional[Dict[str, object]] = None  # {"decoder_preferences": [...]}
    required: Optional[bool] = None
    offset_ms: Optional[float] = None
    buffer_size_ms: Optional[float] = None
    side_channel: Optional[Dict[str, object]] = None


class V4l2Input(ApiModel):
    type: Literal["v4l2"]
    # reference v4l2.rs names the device field `path`; `device_path` is
    # kept as an accepted alias for earlier clients of this build
    path: Optional[str] = None
    device_path: Optional[str] = None
    format: Optional[str] = None        # reference V4l2InputFormat (yuyv | nv12)
    resolution: Optional[Resolution] = None
    framerate: Optional[int] = None
    required: Optional[bool] = None
    offset_ms: Optional[float] = None
    side_channel: Optional[Dict[str, object]] = None


class DeckLinkInput(ApiModel):
    type: Literal["decklink"]
    subdevice_index: Optional[int] = None
    display_name: Optional[str] = None
    persistent_id: Optional[str] = None
    enable_audio: Optional[bool] = None
    required: Optional[bool] = None


class MoqServerInput(ApiModel):
    """Reference smelter-api/src/input/moq_server.rs MoqServerInput."""

    type: Literal["moq_server"]
    auth_token: str
    required: Optional[bool] = None
    decoder_map: Optional[Dict[str, str]] = None
    side_channel: Optional[Dict[str, object]] = None


class MoqClientInput(ApiModel):
    """Reference smelter-api/src/input/moq_client.rs MoqClientInput."""

    type: Literal["moq_client"]
    endpoint_url: str
    broadcast_path: str
    required: Optional[bool] = None
    offset_ms: Optional[float] = None
    decoder_map: Optional[Dict[str, str]] = None
    side_channel: Optional[Dict[str, object]] = None


RegisterInput = Annotated[
    Union[RtpInput, RtmpInput, MoqServerInput, MoqClientInput, Mp4Input,
          WhipInput, WhepInput, HlsInput, V4l2Input, DeckLinkInput],
    Field(discriminator="type"),
]


# ---------------------------------------------------------------------------
# resources + requests
# ---------------------------------------------------------------------------


class ShaderSpec(ApiModel):
    source: str


class ImageSpec(ApiModel):
    url: Optional[str] = None
    path: Optional[str] = None
    asset_type: Literal["png", "jpeg", "svg", "gif", "auto"] = "auto"
    # reference ImageSpec::Svg resolution: raster size for SVG assets
    resolution: Optional[Resolution] = None


class WebRendererSpec(ApiModel):
    url: str
    resolution: Resolution
    embedding_method: Optional[str] = None


class FontSpec(ApiModel):
    url: Optional[str] = None
    path: Optional[str] = None


class UpdateOutputRequest(ApiModel):
    video: Optional[VideoScene] = None
    audio: Optional[AudioScene] = None
    schedule_time_ms: Optional[float] = None


class UnregisterRequest(ApiModel):
    """Body for input/output/renderer unregister routes.

    `schedule_time_ms` defers the unregister to a queue PTS (0 = the start
    request), matching `src/routes/unregister_request.rs:18-37`; an empty
    body unregisters immediately.
    """

    schedule_time_ms: Optional[float] = None


View.model_rebuild()
Rescaler.model_rebuild()
Tiles.model_rebuild()
Shader.model_rebuild()
WebView.model_rebuild()
ShaderParamList.model_rebuild()
ShaderParamStruct.model_rebuild()
Transition.model_rebuild()
