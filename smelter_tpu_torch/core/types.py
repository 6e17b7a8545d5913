"""Core frame/media types.

TPU-native analogues of the reference render types
(`smelter-render/src/types.rs:21-82`): a `Frame` is an HBM-resident JAX array
(or host numpy array pre-upload) in one of the supported pixel formats, plus a
PTS. A `FrameSet` is the per-tick batch of frames keyed by input id.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, ClassVar, Dict, Tuple


@dataclass(frozen=True, order=True)
class Resolution:
    width: int
    height: int

    def ensure_even(self) -> "Resolution":
        return Resolution(self.width - self.width % 2, self.height - self.height % 2)

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)


#: Maximum node resolution, mirrors reference `MAX_NODE_RESOLUTION` (7682x4320).
MAX_NODE_RESOLUTION = Resolution(7682, 4320)


@dataclass(frozen=True)
class Framerate:
    """Output framerate as an exact rational (num/den)."""

    num: int
    den: int = 1

    def as_fraction(self) -> Fraction:
        return Fraction(self.num, self.den)

    def frame_duration_s(self) -> float:
        return self.den / self.num

    def get_interval_duration_s(self, count: int = 1) -> float:
        return count * self.den / self.num


class PixelFormat(enum.Enum):
    """Pixel formats accepted on input upload.

    Mirrors the reference `FrameData` variants
    (`smelter-render/src/types.rs`): planar YUV 4:2:0/4:2:2/4:4:4 in limited
    (BT.709) or full (J) range, NV12, interleaved YUYV/UYVY 4:2:2, and byte
    RGBA/BGRA/ARGB.
    """

    PLANAR_YUV420 = "planar_yuv420"
    PLANAR_YUV422 = "planar_yuv422"
    PLANAR_YUV444 = "planar_yuv444"
    PLANAR_YUVJ420 = "planar_yuvj420"  # full range
    PLANAR_YUVJ422 = "planar_yuvj422"
    PLANAR_YUVJ444 = "planar_yuvj444"
    NV12 = "nv12"
    INTERLEAVED_YUYV422 = "interleaved_yuyv422"
    INTERLEAVED_UYVY422 = "interleaved_uyvy422"
    RGBA = "rgba"
    BGRA = "bgra"
    ARGB = "argb"

    @property
    def is_full_range(self) -> bool:
        return self in (
            PixelFormat.PLANAR_YUVJ420,
            PixelFormat.PLANAR_YUVJ422,
            PixelFormat.PLANAR_YUVJ444,
        )

    @property
    def is_planar_yuv(self) -> bool:
        return self in (
            PixelFormat.PLANAR_YUV420,
            PixelFormat.PLANAR_YUV422,
            PixelFormat.PLANAR_YUV444,
            PixelFormat.PLANAR_YUVJ420,
            PixelFormat.PLANAR_YUVJ422,
            PixelFormat.PLANAR_YUVJ444,
        )

    @property
    def chroma_subsampling(self) -> Tuple[int, int]:
        """(horizontal, vertical) chroma subsampling factors."""
        if self in (
            PixelFormat.PLANAR_YUV420,
            PixelFormat.PLANAR_YUVJ420,
            PixelFormat.NV12,
        ):
            return (2, 2)
        if self in (
            PixelFormat.PLANAR_YUV422,
            PixelFormat.PLANAR_YUVJ422,
            PixelFormat.INTERLEAVED_YUYV422,
            PixelFormat.INTERLEAVED_UYVY422,
        ):
            return (2, 1)
        return (1, 1)


@dataclass
class Frame:
    """One video frame.

    ``data`` layout per format:
      - planar YUV: tuple of (y, u, v) uint8 arrays, shapes (H,W), (H/sx,W/sy)...
      - NV12: tuple of (y, uv) with uv shape (H/2, W/2, 2)
      - interleaved 422: (H, W/2, 4) uint8
      - RGBA/BGRA/ARGB: (H, W, 4) uint8
    Arrays may be numpy (host) or jax (device).
    """

    data: Any
    format: PixelFormat
    resolution: Resolution
    pts: float  # seconds

    @staticmethod
    def rgba(array: Any, pts: float = 0.0) -> "Frame":
        h, w = array.shape[:2]
        return Frame(array, PixelFormat.RGBA, Resolution(w, h), pts)


@dataclass
class FrameSet:
    """Batch of frames for one output tick, keyed by id (input or output)."""

    pts: float
    frames: Dict[str, Frame] = field(default_factory=dict)


@dataclass
class AudioSamples:
    """A chunk of interleaved f32 stereo (or mono) samples with start PTS."""

    samples: Any  # numpy (n, channels) float32
    start_pts: float


@dataclass
class AudioSamplesBatch:
    """Per-tick audio batch: samples per input id + chunk PTS range."""

    start_pts: float
    end_pts: float
    samples: Dict[str, AudioSamples] = field(default_factory=dict)


@dataclass(frozen=True)
class RGBAColor:
    """8-bit RGBA color (non-premultiplied)."""

    r: int
    g: int
    b: int
    a: int = 255

    TRANSPARENT: ClassVar["RGBAColor"]
    BLACK: ClassVar["RGBAColor"]

    def to_float(self) -> Tuple[float, float, float, float]:
        return (self.r / 255.0, self.g / 255.0, self.b / 255.0, self.a / 255.0)

    @staticmethod
    def parse(value: str) -> "RGBAColor":
        """Parse '#rrggbb', '#rrggbbaa', '#rgb', '#rgba' or named colors."""
        v = value.strip()
        if v.startswith("#"):
            hexpart = v[1:]
            if len(hexpart) in (3, 4):
                hexpart = "".join(c * 2 for c in hexpart)
            if len(hexpart) == 6:
                hexpart += "ff"
            if len(hexpart) != 8:
                raise ValueError(f"invalid color: {value!r}")
            r, g, b, a = (int(hexpart[i : i + 2], 16) for i in (0, 2, 4, 6))
            return RGBAColor(r, g, b, a)
        named = _NAMED_COLORS.get(v.lower())
        if named is None:
            raise ValueError(f"invalid color: {value!r}")
        return named


_NAMED_COLORS = {
    "transparent": RGBAColor(0, 0, 0, 0),
    "black": RGBAColor(0, 0, 0),
    "white": RGBAColor(255, 255, 255),
    "red": RGBAColor(255, 0, 0),
    "green": RGBAColor(0, 128, 0),
    "lime": RGBAColor(0, 255, 0),
    "blue": RGBAColor(0, 0, 255),
    "yellow": RGBAColor(255, 255, 0),
    "cyan": RGBAColor(0, 255, 255),
    "aqua": RGBAColor(0, 255, 255),
    "magenta": RGBAColor(255, 0, 255),
    "fuchsia": RGBAColor(255, 0, 255),
    "gray": RGBAColor(128, 128, 128),
    "grey": RGBAColor(128, 128, 128),
    "silver": RGBAColor(192, 192, 192),
    "maroon": RGBAColor(128, 0, 0),
    "olive": RGBAColor(128, 128, 0),
    "navy": RGBAColor(0, 0, 128),
    "purple": RGBAColor(128, 0, 128),
    "teal": RGBAColor(0, 128, 128),
    "orange": RGBAColor(255, 165, 0),
    "pink": RGBAColor(255, 192, 203),
    "brown": RGBAColor(165, 42, 42),
}

# populate class-level constants
setattr(RGBAColor, "TRANSPARENT", RGBAColor(0, 0, 0, 0))
setattr(RGBAColor, "BLACK", RGBAColor(0, 0, 0, 255))


class EventKind(enum.Enum):
    """Pipeline events surfaced on the WS event stream.

    Mirrors reference `smelter-core/src/event.rs:14-29`.
    """

    INPUT_DELIVERED = "VIDEO_INPUT_DELIVERED"
    INPUT_PLAYING = "VIDEO_INPUT_PLAYING"
    INPUT_EOS = "VIDEO_INPUT_EOS"
    AUDIO_INPUT_DELIVERED = "AUDIO_INPUT_DELIVERED"
    AUDIO_INPUT_PLAYING = "AUDIO_INPUT_PLAYING"
    AUDIO_INPUT_EOS = "AUDIO_INPUT_EOS"
    OUTPUT_DONE = "OUTPUT_DONE"


@dataclass(frozen=True)
class InputId:
    id: str


@dataclass(frozen=True)
class OutputId:
    id: str


@dataclass(frozen=True)
class RendererId:
    id: str
