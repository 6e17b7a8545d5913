"""Wire schema → internal types.

The analogue of the reference's `TryFrom` conversions
(`smelter-api/src/video/component_into.rs`, `output/*_into.rs`,
`input/*_into.rs`): every pydantic request model converts into the internal
scene/pipeline dataclasses, applying the same defaults the reference applies.
"""

from __future__ import annotations

from typing import Optional

from smelter_tpu_torch.api import schema as api
from smelter_tpu_torch.audio.mixer import AudioMixerConfig, AudioMixerInputConfig
from smelter_tpu_torch.core.types import RGBAColor, Resolution
from smelter_tpu_torch.pipeline import output as pout
from smelter_tpu_torch.pipeline.input import Mp4Input, Mp4InputOptions
from smelter_tpu_torch.pipeline.instance import RegisterInputOptions
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.layout_types import BorderRadius, BoxShadow


class ConversionError(ValueError):
    pass


def color(value: Optional[str], default: RGBAColor = RGBAColor(0, 0, 0, 0)) -> RGBAColor:
    if value is None:
        return default
    try:
        return RGBAColor.parse(value)
    except (ValueError, KeyError) as exc:
        raise ConversionError(str(exc)) from exc


def transition(t: Optional[api.Transition]) -> Optional[comp.Transition]:
    if t is None:
        return None
    easing = comp.Easing.LINEAR
    ef = t.easing_function
    if ef is not None:
        if ef.function_name == "linear":
            easing = comp.Easing.LINEAR
        elif ef.function_name == "bounce":
            easing = comp.Easing.BOUNCE
        else:
            x1, y1, x2, y2 = ef.points
            if not (0.0 <= x1 <= 1.0):
                raise ConversionError("Control point x1 has to be in the range [0, 1].")
            if not (0.0 <= x2 <= 1.0):
                raise ConversionError("Control point x2 has to be in the range [0, 1].")
            easing = comp.Easing.cubic_bezier(x1, y1, x2, y2)
    return comp.Transition(
        duration=t.duration_ms / 1000.0,
        easing=easing,
        should_interrupt=bool(t.should_interrupt),
    )


def _position(c) -> comp.Position:
    absolute = any(
        getattr(c, f, None) is not None
        for f in ("top", "left", "bottom", "right", "rotation")
    )
    if absolute:
        return comp.AbsolutePosition(
            width=c.width,
            height=c.height,
            top=c.top,
            bottom=c.bottom,
            left=c.left,
            right=c.right,
            rotation_degrees=c.rotation or 0.0,
        )
    return comp.StaticPosition(width=c.width, height=c.height)


def _box_shadow(shadows) -> list:
    out = []
    for s in shadows or []:
        out.append(
            BoxShadow(
                offset_x=s.offset_x or 0.0,
                offset_y=s.offset_y or 0.0,
                blur_radius=s.blur_radius or 0.0,
                color=color(s.color, RGBAColor(0, 0, 0, 255)),
            )
        )
    return out


def _padding(v: api.View) -> comp.Padding:
    base = v.padding or 0.0
    vert = v.padding_vertical if v.padding_vertical is not None else base
    horiz = v.padding_horizontal if v.padding_horizontal is not None else base
    return comp.Padding(
        top=v.padding_top if v.padding_top is not None else vert,
        bottom=v.padding_bottom if v.padding_bottom is not None else vert,
        left=v.padding_left if v.padding_left is not None else horiz,
        right=v.padding_right if v.padding_right is not None else horiz,
    )


def component(c) -> comp.Component:
    if isinstance(c, api.InputStream):
        return comp.InputStream(input_id=c.input_id, id=c.id)
    if isinstance(c, api.View):
        return comp.View(
            id=c.id,
            children=[component(ch) for ch in (c.children or [])],
            direction=comp.ViewDirection(c.direction or "row"),
            position=_position(c),
            transition=transition(c.transition),
            overflow=comp.Overflow(c.overflow or "hidden"),
            background_color=color(c.background_color),
            border_radius=BorderRadius(
                *([c.border_radius or 0.0] * 4)
            ),
            border_width=c.border_width or 0.0,
            border_color=color(c.border_color),
            box_shadow=_box_shadow(c.box_shadow),
            padding=_padding(c),
        )
    if isinstance(c, api.Rescaler):
        return comp.Rescaler(
            id=c.id,
            child=component(c.child),
            position=_position(c),
            transition=transition(c.transition),
            mode=comp.RescaleMode(c.mode or "fit"),
            horizontal_align=comp.HorizontalAlign(c.horizontal_align or "center"),
            vertical_align=comp.VerticalAlign(c.vertical_align or "center"),
            border_radius=BorderRadius(*([c.border_radius or 0.0] * 4)),
            border_width=c.border_width or 0.0,
            border_color=color(c.border_color),
            box_shadow=_box_shadow(c.box_shadow),
        )
    if isinstance(c, api.Tiles):
        ratio = (16, 9)
        if c.tile_aspect_ratio:
            try:
                w, h = c.tile_aspect_ratio.split(":")
                ratio = (int(w), int(h))
            except ValueError as exc:
                raise ConversionError(
                    "Aspect ratio needs to be a \"W:H\" string, where W and H are integers."
                ) from exc
        return comp.Tiles(
            id=c.id,
            children=[component(ch) for ch in (c.children or [])],
            width=c.width,
            height=c.height,
            background_color=color(c.background_color),
            tile_aspect_ratio=ratio,
            margin=c.margin or 0.0,
            padding=c.padding or 0.0,
            horizontal_align=comp.HorizontalAlign(c.horizontal_align or "center"),
            vertical_align=comp.VerticalAlign(c.vertical_align or "center"),
            transition=transition(c.transition),
        )
    if isinstance(c, api.Text):
        if c.height is not None and c.width is None:
            raise ConversionError(
                "Field \"height\" couldn't be provided without \"width\""
            )
        if c.width is not None and c.height is not None:
            dims = comp.TextDimensions("fixed", width=c.width, height=c.height)
        elif c.width is not None:
            dims = comp.TextDimensions("fitted_column", width=c.width,
                                       max_height=c.max_height or 4320.0)
        else:
            dims = comp.TextDimensions(
                "fitted",
                max_width=c.max_width or 7682.0,
                max_height=c.max_height or 4320.0,
            )
        return comp.Text(
            id=c.id,
            text=c.text,
            font_size=c.font_size,
            line_height=c.line_height,
            color=color(c.color, RGBAColor(255, 255, 255, 255)),
            background_color=color(c.background_color),
            font_family=c.font_family or "Verdana",
            style=comp.TextStyle(c.style or "normal"),
            align=comp.HorizontalAlign(c.align or "left"),
            wrap=comp.TextWrap(c.wrap or "none"),
            weight=comp.TextWeight(c.weight or "normal"),
            dimensions=dims,
        )
    if isinstance(c, api.Image):
        return comp.Image(id=c.id, image_id=c.image_id, width=c.width, height=c.height)
    if isinstance(c, api.Shader):
        return comp.Shader(
            id=c.id,
            shader_id=c.shader_id,
            children=[component(ch) for ch in (c.children or [])],
            shader_param=shader_param(c.shader_param),
            width=float(c.resolution.width),
            height=float(c.resolution.height),
        )
    if isinstance(c, api.WebView):
        return comp.WebView(
            id=c.id,
            instance_id=c.instance_id,
            children=[component(ch) for ch in (c.children or [])],
        )
    raise ConversionError(f"unknown component {type(c)}")


def shader_param(p):
    if p is None:
        return None
    if p.type in ("f32", "u32", "i32"):
        return (p.type, p.value)
    if p.type == "list":
        return ("list", [shader_param(v) for v in p.value])
    if p.type == "struct":
        return (
            "struct",
            [(f.field_name, shader_param_from_field(f)) for f in p.value],
        )
    raise ConversionError(f"unknown shader param {p.type}")


def shader_param_from_field(f: api.ShaderParamStructField):
    import pydantic

    inner = pydantic.TypeAdapter(api.ShaderParam).validate_python(
        {"type": f.type, "value": f.value}
    )
    return shader_param(inner)


def video_scene(scene: api.VideoScene) -> comp.Component:
    return component(scene.root)


def audio_config(
    scene: api.AudioScene,
    mixing_strategy: Optional[str] = None,
    channels: Optional[str] = None,
) -> AudioMixerConfig:
    inputs = []
    for i in scene.inputs:
        vol = 1.0 if i.volume is None else float(i.volume)
        if not (0.0 <= vol <= 2.0):
            raise ConversionError("Input volume has to be in [0, 2] range.")
        inputs.append(AudioMixerInputConfig(i.input_id, volume=vol))
    return AudioMixerConfig(
        inputs=inputs,
        mixing_strategy=mixing_strategy or "sum_clip",
        channels=channels or "stereo",
    )


def end_condition(c: Optional[api.OutputEndCondition]) -> pout.EndCondition:
    if c is None:
        return pout.EndCondition()
    set_fields = sum(
        1
        for v in (c.any_of, c.all_of, c.any_input, c.all_inputs)
        if v is not None
    )
    if set_fields > 1:
        raise ConversionError(
            "Only one of \"any_of, all_of, any_input or all_inputs\" is allowed."
        )
    return pout.EndCondition(
        any_of=tuple(c.any_of) if c.any_of is not None else None,
        all_of=tuple(c.all_of) if c.all_of is not None else None,
        any_input=bool(c.any_input),
        all_inputs=bool(c.all_inputs),
    )


def _bitrate(b) -> int:
    if b is None:
        return 0
    if isinstance(b, int):
        return b
    return int(b.get("average_bitrate", 0))


def video_encoder(e: api.VideoEncoderOptions, for_container: str) -> pout.VideoEncoderOptions:
    extra = ",".join(f"{k}={v}" for k, v in (e.ffmpeg_options or {}).items())
    interval = (
        e.keyframe_interval_ms / 1000.0
        if getattr(e, "keyframe_interval_ms", None)
        else None
    )
    pixel_format = getattr(e, "pixel_format", None) or "yuv420p"
    if isinstance(e, api.FfmpegH264Encoder):
        return pout.VideoEncoderOptions(
            codec="h264",
            preset=e.preset or ("fast" if for_container != "rtp" else "fast"),
            bitrate=_bitrate(e.bitrate),
            ffmpeg_options=extra,
            keyframe_interval_s=interval,
            pixel_format=pixel_format,
        )
    if isinstance(e, api.FfmpegVp8Encoder):
        return pout.VideoEncoderOptions(codec="vp8", bitrate=_bitrate(e.bitrate),
                                        ffmpeg_options=extra,
                                        keyframe_interval_s=interval)
    if isinstance(e, api.FfmpegVp9Encoder):
        return pout.VideoEncoderOptions(codec="vp9", bitrate=_bitrate(e.bitrate),
                                        ffmpeg_options=extra,
                                        keyframe_interval_s=interval,
                                        pixel_format=pixel_format)
    if isinstance(e, api.FfmpegAv1Encoder):
        return pout.VideoEncoderOptions(codec="av1", bitrate=_bitrate(e.bitrate),
                                        ffmpeg_options=extra,
                                        keyframe_interval_s=interval,
                                        pixel_format=pixel_format)
    raise ConversionError(f"unsupported video encoder {e}")


def audio_encoder(e: api.AudioEncoderOptions) -> pout.AudioEncoderOptions:
    if isinstance(e, api.AacEncoder):
        return pout.AudioEncoderOptions(
            codec="aac", sample_rate=e.sample_rate or 44100
        )
    if isinstance(e, api.OpusEncoder):
        # libopus private options (reference OpusEncoderOptions:
        # forward_error_correction / expected_packet_loss / preset)
        parts = []
        if e.forward_error_correction:
            parts.append("fec=1")
        if e.expected_packet_loss is not None:
            parts.append(f"packet_loss={int(e.expected_packet_loss)}")
        if e.preset:
            app = {"quality": "audio", "voip": "voip",
                   "lowest_latency": "lowdelay"}.get(e.preset)
            if app:
                parts.append(f"application={app}")
        return pout.AudioEncoderOptions(
            codec="opus", sample_rate=e.sample_rate or 48000,
            ffmpeg_options=",".join(parts),
        )
    raise ConversionError(f"unsupported audio encoder {e}")


def _resolve_whip_video_encoder(v) -> "api.VideoEncoderOptions":
    """Reference OutputWhipVideoOptions.encoder_preferences → one encoder:
    first supported preference wins; vulkan_h264 resolves to the software
    h264 encoder (no video ASIC on TPU hosts); `any` → h264 defaults. A
    direct `encoder` (this build's extension) takes precedence."""
    if getattr(v, "encoder", None) is not None:
        return v.encoder
    for pref in getattr(v, "encoder_preferences", None) or []:
        if isinstance(pref, (api.FfmpegH264Encoder, api.FfmpegVp8Encoder,
                             api.FfmpegVp9Encoder, api.FfmpegAv1Encoder)):
            return pref
        if isinstance(pref, api.VulkanH264Encoder):
            return api.FfmpegH264Encoder(
                type="ffmpeg_h264", bitrate=pref.bitrate,
                keyframe_interval_ms=pref.keyframe_interval_ms,
            )
        if isinstance(pref, api.AnyVideoEncoder):
            return api.FfmpegH264Encoder(type="ffmpeg_h264")
    raise ConversionError(
        "video options need `encoder` or a supported `encoder_preferences` entry"
    )


def _resolve_whip_audio_encoder(a) -> "api.AudioEncoderOptions":
    if getattr(a, "encoder", None) is not None:
        return a.encoder
    for pref in getattr(a, "encoder_preferences", None) or []:
        if isinstance(pref, api.OpusEncoder):
            return pref
        if isinstance(pref, api.AnyAudioEncoder):
            return api.OpusEncoder(type="opus")
    raise ConversionError(
        "audio options need `encoder` or a supported `encoder_preferences` entry"
    )


def whip_output_video_options(v, container: str) -> pout.OutputVideoOptions:
    return pout.OutputVideoOptions(
        resolution=Resolution(v.resolution.width, v.resolution.height),
        encoder=video_encoder(_resolve_whip_video_encoder(v), container),
        initial_root=video_scene(v.initial),
        end_condition=end_condition(v.send_eos_when),
    )


def whip_output_audio_options(a) -> pout.OutputAudioOptions:
    return pout.OutputAudioOptions(
        encoder=audio_encoder(_resolve_whip_audio_encoder(a)),
        initial_mixer_config=audio_config(a.initial, a.mixing_strategy, a.channels),
        end_condition=end_condition(a.send_eos_when),
    )


def output_video_options(
    v: api.OutputVideoOptions, container: str
) -> pout.OutputVideoOptions:
    return pout.OutputVideoOptions(
        resolution=Resolution(v.resolution.width, v.resolution.height),
        encoder=video_encoder(v.encoder, container),
        initial_root=video_scene(v.initial),
        end_condition=end_condition(v.send_eos_when),
    )


def output_audio_options(a: api.OutputAudioOptions) -> pout.OutputAudioOptions:
    return pout.OutputAudioOptions(
        encoder=audio_encoder(a.encoder),
        initial_mixer_config=audio_config(a.initial, a.mixing_strategy, a.channels),
        end_condition=end_condition(a.send_eos_when),
    )


def mp4_input(m: api.Mp4Input, side_channel_dir: Optional[str] = None):
    if bool(m.url) == bool(m.path):
        raise ConversionError(
            "Exactly one of \"url\" or \"path\" has to be specified in a register request for an mp4 input."
        )
    source = Mp4Input(Mp4InputOptions(
        path=m.path or m.url, loop=bool(m.loop_),
        initial_seek_s=(m.seek_ms / 1000.0) if m.seek_ms is not None else None,
    ))
    sc = m.side_channel or {}
    opts = RegisterInputOptions(
        required=bool(m.required),
        offset=(m.offset_ms / 1000.0) if m.offset_ms is not None else None,
        side_channel_video=bool(sc.get("video")),
        side_channel_audio=bool(sc.get("audio")),
        side_channel_dir=side_channel_dir,
        side_channel_delay=float(sc.get("delay_ms") or 0.0) / 1000.0,
    )
    return source, opts
