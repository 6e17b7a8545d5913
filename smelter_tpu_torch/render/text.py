"""Host-side text rasterizer (FreeType + HarfBuzz shaping via libraqm), a
copy of `smelter_tpu/render/text.py`: the same PIL calls in the same order,
so that both packages raster byte-identical RGBA textures. PIL is imported
only when a Text is measured or rendered.

Shapes and rasters a Text component once (cached by params), producing an
RGBA texture that enters the frame program as an aux texture. Sizing modes:
Fitted (trim to content within max bounds), FittedColumn (fixed width,
fitted height), Fixed.

Shaping: every font loads with PIL's RAQM layout engine (libraqm =
HarfBuzz + FriBidi), giving real kerning, ligatures, complex-script
shaping (Arabic joining, Indic conjuncts) and bidi reordering — the same
capability class as the reference's cosmic-text shaping. Line wrapping
measures shaped runs, so wrap decisions match what is drawn.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from smelter_tpu_torch.scene import components as comp

_FONT_DIR = "/usr/share/fonts/truetype/dejavu"

_BOLD_WEIGHTS = {
    comp.TextWeight.SEMI_BOLD,
    comp.TextWeight.BOLD,
    comp.TextWeight.EXTRA_BOLD,
    comp.TextWeight.BLACK,
}


# fonts registered at runtime via POST /api/font/register
# (reference `register_request::handle_font`): family name → ttf/otf path
_REGISTERED_FONTS: dict = {}


def register_font(path_or_url: str) -> None:
    """Registers a font file; the family name is read from the font itself."""
    if not path_or_url:
        raise ValueError("font register requires a path or url")
    path = path_or_url
    if path.startswith(("http://", "https://")):
        import tempfile
        import urllib.request

        tmp = tempfile.NamedTemporaryFile(suffix=".ttf", delete=False)
        with urllib.request.urlopen(path) as resp:
            tmp.write(resp.read())
        tmp.close()
        path = tmp.name
    from PIL import ImageFont

    font = ImageFont.truetype(path, size=16)
    family = (font.getname()[0] or "").lower()
    if not family:
        raise ValueError(f"cannot determine family name of {path_or_url!r}")
    _REGISTERED_FONTS[family] = path


def _font_file(family: str, weight: comp.TextWeight, style: comp.TextStyle) -> str:
    fam = family.lower()
    bold = weight in _BOLD_WEIGHTS
    if fam in _REGISTERED_FONTS:
        return _REGISTERED_FONTS[fam]
    if "mono" in fam or "courier" in fam:
        return os.path.join(
            _FONT_DIR, "DejaVuSansMono-Bold.ttf" if bold else "DejaVuSansMono.ttf"
        )
    if "serif" in fam or "times" in fam or "georgia" in fam:
        return os.path.join(
            _FONT_DIR, "DejaVuSerif-Bold.ttf" if bold else "DejaVuSerif.ttf"
        )
    return os.path.join(_FONT_DIR, "DejaVuSans-Bold.ttf" if bold else "DejaVuSans.ttf")


@functools.lru_cache(maxsize=256)
def _load_font(path: str, size: int) -> "ImageFont.FreeTypeFont":
    from PIL import ImageFont

    try:
        return ImageFont.truetype(path, size=size,
                                  layout_engine=ImageFont.Layout.RAQM)
    except Exception:  # raqm missing in a stripped image: basic layout
        return ImageFont.truetype(path, size=size)


def shaping_active() -> bool:
    """True when libraqm (HarfBuzz shaping + bidi) is available."""
    from PIL import features

    return bool(features.check("raqm"))


def _wrap_lines(
    text: str,
    font: ImageFont.FreeTypeFont,
    max_width: float,
    wrap: comp.TextWrap,
) -> List[str]:
    if wrap == comp.TextWrap.NONE:
        return text.split("\n")
    out: List[str] = []
    for raw_line in text.split("\n"):
        if wrap == comp.TextWrap.WORD:
            words = raw_line.split(" ")
            line = ""
            for word in words:
                cand = word if not line else line + " " + word
                if font.getlength(cand) <= max_width or not line:
                    line = cand
                else:
                    out.append(line)
                    line = word
            out.append(line)
        else:  # GLYPH
            line = ""
            for ch in raw_line:
                cand = line + ch
                if font.getlength(cand) <= max_width or not line:
                    line = cand
                else:
                    out.append(line)
                    line = ch
            out.append(line)
    return out


@dataclass(frozen=True)
class RenderedText:
    rgba: np.ndarray  # (H, W, 4) uint8, straight alpha
    width: float
    height: float


class TextRenderer:
    """Caches rendered text by component params."""

    def __init__(self) -> None:
        self._cache: Dict[tuple, RenderedText] = {}

    def _key(self, c: comp.Text) -> tuple:
        return (
            c.text,
            c.font_size,
            c.line_height,
            c.color,
            c.font_family,
            c.style,
            c.align,
            c.weight,
            c.wrap,
            c.background_color,
            c.dimensions,
        )

    def measure(self, c: comp.Text) -> Tuple[float, float]:
        return (self.render(c).width, self.render(c).height)

    def render(self, c: comp.Text) -> RenderedText:
        key = self._key(c)
        cached = self._cache.get(key)
        if cached is not None:
            return cached
        result = _render_text(c)
        self._cache[key] = result
        return result


def _render_text(c: comp.Text) -> RenderedText:
    from PIL import Image as PILImage
    from PIL import ImageDraw

    font = _load_font(
        _font_file(c.font_family, c.weight, c.style), max(int(round(c.font_size)), 1)
    )
    line_height = c.line_height if c.line_height is not None else c.font_size
    dims = c.dimensions
    if dims.mode == "fixed":
        box_w = dims.width or 0.0
        box_h = dims.height or 0.0
        wrap_width = box_w
    elif dims.mode == "fitted_column":
        box_w = dims.width or 0.0
        wrap_width = box_w
        box_h = None  # computed from content
    else:  # fitted
        wrap_width = dims.max_width
        box_w = None
        box_h = None

    lines = _wrap_lines(c.text, font, wrap_width, c.wrap)
    line_widths = [font.getlength(line) for line in lines]
    content_w = max(line_widths) if line_widths else 0.0
    content_h = line_height * len(lines)

    if box_w is None:
        box_w = min(content_w, dims.max_width)
    if box_h is None:
        box_h = min(content_h, dims.max_height)

    w = max(int(round(box_w)), 1)
    h = max(int(round(box_h)), 1)
    bg = tuple(c.background_color.to_float()[i] for i in range(4))
    img = PILImage.new(
        "RGBA",
        (w, h),
        (
            c.background_color.r,
            c.background_color.g,
            c.background_color.b,
            c.background_color.a,
        ),
    )
    draw = ImageDraw.Draw(img)
    ascent, descent = font.getmetrics()
    text_block_h = ascent + descent
    fill = (c.color.r, c.color.g, c.color.b, c.color.a)
    italic_like = c.style in (comp.TextStyle.ITALIC, comp.TextStyle.OBLIQUE)
    y = 0.0
    for line, lw in zip(lines, line_widths):
        if c.align == comp.HorizontalAlign.LEFT or c.align == comp.HorizontalAlign.JUSTIFIED:
            x = 0.0
        elif c.align == comp.HorizontalAlign.RIGHT:
            x = box_w - lw
        else:
            x = (box_w - lw) / 2.0
        # vertical centering of the glyph block within the line box
        dy = (line_height - text_block_h) / 2.0
        draw.text((x, y + dy), line, font=font, fill=fill)
        y += line_height
    rgba = np.asarray(img, dtype=np.uint8)
    if italic_like:
        rgba = _shear(rgba)
    return RenderedText(rgba=rgba, width=float(w), height=float(h))


def _shear(rgba: np.ndarray) -> np.ndarray:
    """Cheap oblique emulation: shear rows right by ~0.2 * distance-from-baseline."""
    h, w = rgba.shape[:2]
    out = np.zeros_like(rgba)
    for row in range(h):
        shift = int(round((h - row) * 0.2))
        if shift >= w:
            continue
        if shift == 0:
            out[row] = rgba[row]
        else:
            out[row, shift:] = rgba[row, : w - shift]
    return out
