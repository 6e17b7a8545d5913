"""User-facing scene component tree.

Mirrors the reference component model (`smelter-render/src/scene/components.rs`):
View / Tiles / Rescaler layout components, InputStream / Text / Image / Shader /
WebView leaf-ish components, absolute positioning, and animated transitions.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import ClassVar, List, Optional, Tuple, Union

from smelter_tpu_torch.core.types import RGBAColor
from smelter_tpu_torch.scene.layout_types import BorderRadius, BoxShadow


class HorizontalAlign(str, enum.Enum):
    LEFT = "left"
    RIGHT = "right"
    JUSTIFIED = "justified"
    CENTER = "center"


class VerticalAlign(str, enum.Enum):
    TOP = "top"
    CENTER = "center"
    BOTTOM = "bottom"
    JUSTIFIED = "justified"


class Overflow(str, enum.Enum):
    VISIBLE = "visible"
    HIDDEN = "hidden"
    FIT = "fit"


class ViewDirection(str, enum.Enum):
    ROW = "row"
    COLUMN = "column"


class RescaleMode(str, enum.Enum):
    FIT = "fit"
    FILL = "fill"


@dataclass(frozen=True)
class Padding:
    top: float = 0.0
    right: float = 0.0
    bottom: float = 0.0
    left: float = 0.0

    @property
    def horizontal(self) -> float:
        return self.left + self.right

    @property
    def vertical(self) -> float:
        return self.top + self.bottom


# --- positioning -------------------------------------------------------------


@dataclass(frozen=True)
class StaticPosition:
    width: Optional[float] = None
    height: Optional[float] = None


@dataclass(frozen=True)
class AbsolutePosition:
    width: Optional[float] = None
    height: Optional[float] = None
    # offsets: exactly one of top/bottom, one of left/right should be set;
    # when both are None, offset 0 from top/left.
    top: Optional[float] = None
    bottom: Optional[float] = None
    left: Optional[float] = None
    right: Optional[float] = None
    rotation_degrees: float = 0.0


Position = Union[StaticPosition, AbsolutePosition]


def position_with_outer(
    position: Position, border_width: float, padding: Padding
) -> Position:
    """Grow declared width/height by border and padding
    (reference `components/position.rs` with_border + with_padding)."""
    dw = 2.0 * border_width + padding.horizontal
    dh = 2.0 * border_width + padding.vertical
    if isinstance(position, StaticPosition):
        return StaticPosition(
            width=None if position.width is None else position.width + dw,
            height=None if position.height is None else position.height + dh,
        )
    return AbsolutePosition(
        width=None if position.width is None else position.width + dw,
        height=None if position.height is None else position.height + dh,
        top=position.top,
        bottom=position.bottom,
        left=position.left,
        right=position.right,
        rotation_degrees=position.rotation_degrees,
    )


# --- transitions --------------------------------------------------------------


@dataclass(frozen=True)
class Easing:
    """Interpolation kind. ``kind`` in {linear, bounce, cubic_bezier};
    the CSS-style presets map to cubic beziers like the reference API."""

    kind: str = "linear"
    points: Tuple[float, float, float, float] = (0.0, 0.0, 1.0, 1.0)

    LINEAR: ClassVar["Easing"]
    BOUNCE: ClassVar["Easing"]

    @staticmethod
    def cubic_bezier(x1: float, y1: float, x2: float, y2: float) -> "Easing":
        return Easing("cubic_bezier", (x1, y1, x2, y2))

    @staticmethod
    def preset(name: str) -> "Easing":
        presets = {
            "linear": Easing.LINEAR,
            "bounce": Easing.BOUNCE,
            "ease": Easing.cubic_bezier(0.25, 0.1, 0.25, 1.0),
            "ease_in": Easing.cubic_bezier(0.42, 0.0, 1.0, 1.0),
            "ease_out": Easing.cubic_bezier(0.0, 0.0, 0.58, 1.0),
            "ease_in_out": Easing.cubic_bezier(0.42, 0.0, 0.58, 1.0),
            "ease_in_quint": Easing.cubic_bezier(0.64, 0.0, 0.78, 0.0),
            "ease_out_quint": Easing.cubic_bezier(0.22, 1.0, 0.36, 1.0),
            "ease_in_out_quint": Easing.cubic_bezier(0.83, 0.0, 0.17, 1.0),
            "ease_in_expo": Easing.cubic_bezier(0.7, 0.0, 0.84, 0.0),
            "ease_out_expo": Easing.cubic_bezier(0.16, 1.0, 0.3, 1.0),
            "ease_in_out_expo": Easing.cubic_bezier(0.87, 0.0, 0.13, 1.0),
        }
        if name not in presets:
            raise ValueError(f"unknown easing preset {name!r}")
        return presets[name]


setattr(Easing, "LINEAR", Easing("linear"))
setattr(Easing, "BOUNCE", Easing("bounce"))


@dataclass(frozen=True)
class Transition:
    duration: float  # seconds
    easing: Easing = Easing.LINEAR
    should_interrupt: bool = False


# --- components ---------------------------------------------------------------


@dataclass
class InputStream:
    input_id: str
    id: Optional[str] = None


@dataclass
class View:
    id: Optional[str] = None
    children: List["Component"] = field(default_factory=list)
    direction: ViewDirection = ViewDirection.ROW
    position: Position = field(default_factory=StaticPosition)
    transition: Optional[Transition] = None
    overflow: Overflow = Overflow.HIDDEN
    background_color: RGBAColor = RGBAColor(0, 0, 0, 0)
    border_radius: BorderRadius = BorderRadius.ZERO
    border_width: float = 0.0
    border_color: RGBAColor = RGBAColor(0, 0, 0, 0)
    box_shadow: List[BoxShadow] = field(default_factory=list)
    padding: Padding = Padding()


@dataclass
class Tiles:
    id: Optional[str] = None
    children: List["Component"] = field(default_factory=list)
    width: Optional[float] = None
    height: Optional[float] = None
    background_color: RGBAColor = RGBAColor(0, 0, 0, 0)
    tile_aspect_ratio: Tuple[int, int] = (16, 9)
    margin: float = 0.0
    padding: float = 0.0
    horizontal_align: HorizontalAlign = HorizontalAlign.CENTER
    vertical_align: VerticalAlign = VerticalAlign.CENTER
    transition: Optional[Transition] = None


@dataclass
class Rescaler:
    child: "Component"
    id: Optional[str] = None
    position: Position = field(default_factory=StaticPosition)
    transition: Optional[Transition] = None
    mode: RescaleMode = RescaleMode.FIT
    horizontal_align: HorizontalAlign = HorizontalAlign.CENTER
    vertical_align: VerticalAlign = VerticalAlign.CENTER
    border_radius: BorderRadius = BorderRadius.ZERO
    border_width: float = 0.0
    border_color: RGBAColor = RGBAColor(0, 0, 0, 0)
    box_shadow: List[BoxShadow] = field(default_factory=list)


class TextStyle(str, enum.Enum):
    NORMAL = "normal"
    ITALIC = "italic"
    OBLIQUE = "oblique"


class TextWrap(str, enum.Enum):
    NONE = "none"
    GLYPH = "glyph"
    WORD = "word"


class TextWeight(str, enum.Enum):
    THIN = "thin"
    EXTRA_LIGHT = "extra_light"
    LIGHT = "light"
    NORMAL = "normal"
    MEDIUM = "medium"
    SEMI_BOLD = "semi_bold"
    BOLD = "bold"
    EXTRA_BOLD = "extra_bold"
    BLACK = "black"


@dataclass(frozen=True)
class TextDimensions:
    """mode: 'fitted' (trim to content, bounded by max), 'fitted_column'
    (fixed width, fitted height), or 'fixed'."""

    mode: str = "fitted"
    width: Optional[float] = None
    height: Optional[float] = None
    max_width: float = 7682.0
    max_height: float = 4320.0


@dataclass
class Text:
    text: str
    id: Optional[str] = None
    font_size: float = 16.0
    line_height: Optional[float] = None  # default: font_size
    color: RGBAColor = RGBAColor(255, 255, 255, 255)
    font_family: str = "Verdana"
    style: TextStyle = TextStyle.NORMAL
    align: HorizontalAlign = HorizontalAlign.LEFT
    weight: TextWeight = TextWeight.NORMAL
    wrap: TextWrap = TextWrap.NONE
    background_color: RGBAColor = RGBAColor(0, 0, 0, 0)
    dimensions: TextDimensions = TextDimensions()


@dataclass
class Image:
    image_id: str
    id: Optional[str] = None
    width: Optional[float] = None
    height: Optional[float] = None


@dataclass
class Shader:
    shader_id: str
    id: Optional[str] = None
    children: List["Component"] = field(default_factory=list)
    shader_param: Optional[object] = None
    width: float = 0.0
    height: float = 0.0


@dataclass
class WebView:
    instance_id: str
    id: Optional[str] = None
    children: List["Component"] = field(default_factory=list)


Component = Union[InputStream, View, Tiles, Rescaler, Text, Image, Shader, WebView]

LAYOUT_COMPONENTS = (View, Tiles, Rescaler)
