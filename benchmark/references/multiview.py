"""The plain reference of the styled multiview (`scenes/multiview.py`),
written from what its components mean and not from the program's code.
Each rule, and where it comes from, is stated in the configuration
(`configs/multiview16_4k.json`, `math`):

  - the Tiles rects, unrounded, by upstream's Tiles rules;
  - in each tile a Rescaler: its box is the tile, its picture the input
    fitted inside the box less its border and centred; the picture's
    pixels fill its rect rounded to whole pixels, each plane resized there
    by Lanczos-3 (the chroma's bilinear upsampling composed into its
    weights) in the configuration's precision, then BT.709 to RGB;
  - the picture clipped by its own rect and by the box's rounded inner
    edge, the box's border a rounded ring, the box shadow a blurred
    rounded rect beneath the tile, each coverage anti-aliased over a pixel;
  - every layer painted over the whole frame in the stated order by
    premultiplied OVER in f32, then BT.709 limited range, 4:2:0, u8.

Every layer is evaluated at every pixel of the frame. It imports nothing of
the program. `render` runs in plain PyTorch on the device it is given,
with TF32 off."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

Rect = Tuple[float, float, float, float]  # top, left, height, width


def _tiles_reference():
    """The Tiles reference beside this file, for its Lanczos-3 matrix."""
    spec = importlib.util.spec_from_file_location(
        "multiview_reference_tiles", Path(__file__).with_name("tiles.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


lanczos3_matrix = _tiles_reference().lanczos3_matrix


def tile_rects(n: int, width: float, height: float, aspect: Tuple[int, int],
               margin: float, padding: float) -> List[Rect]:
    """The unrounded rects of `n` tiles in a `width` x `height` layout: the
    rows (and so columns) that give the widest tile at the aspect ratio,
    the fewer rows on a tie; rows filled left to right, the last holding the
    rest; rows and tiles centred."""
    aw, ah = aspect

    def tile(rows: int, cols: int) -> Tuple[float, float]:
        free_w = max(width - cols * 2 * padding - (cols + 1) * margin, 0.0)
        free_h = max(height - rows * 2 * padding - (rows + 1) * margin, 0.0)
        scale = min(free_w / cols / aw, free_h / rows / ah)
        return aw * scale, ah * scale

    rows = max(range(1, n + 1), key=lambda r: (tile(r, -(-n // r))[0], -r))
    cols = -(-n // rows)
    tw, th = tile(rows, cols)
    rects: List[Rect] = []
    top = (height - rows * (th + 2 * padding) - (rows + 1) * margin) / 2 + margin + padding
    for row in range(rows):
        in_row = cols if row < rows - 1 else n - (rows - 1) * cols
        left = (width - in_row * (tw + 2 * padding) - (in_row + 1) * margin) / 2 + margin + padding
        for _ in range(in_row):
            rects.append((top, left, th, tw))
            left += tw + 2 * padding + margin
        top += th + 2 * padding + margin
    return rects


def picture_rect(box: Rect, border: float, in_w: int, in_h: int) -> Rect:
    """The picture of a Rescaler (fit, centred) whose box is `box`: the
    input scaled to fit the box less its border on each side."""
    top, left, h, w = box
    ch, cw = max(h - 2 * border, 0.0), max(w - 2 * border, 0.0)
    s = min(cw / in_w, ch / in_h)
    return (top + ((ch - in_h * s) / 2 + border), left + ((cw - in_w * s) / 2 + border),
            in_h * s, in_w * s)


def chroma_upsample_matrix(n_full: int, n_sub: int) -> np.ndarray:
    """(n_full, n_sub) weights of a bilinear upsampling of one axis: each
    full-size sample at its texel centre in the subsampled plane, between
    the texel at or before it and the next one, as the JAX package's
    `upsample_chroma_bilinear` reads them: the first index clamped to the
    plane, then its neighbour. So the first full-size sample, a quarter of
    a texel before the first centre, is 1/4 of texel 0 and 3/4 of texel 1,
    where a clamp-to-edge sampler would read texel 0 alone (a departure of
    the port and the JAX package alike)."""
    pos = (np.arange(n_full) + 0.5) * (n_sub / n_full) - 0.5
    first = np.clip(np.floor(pos), 0, n_sub - 1)
    frac = pos - np.floor(pos)
    m = np.zeros((n_full, n_sub))
    rows = np.arange(n_full)
    np.add.at(m, (rows, first.astype(np.int64)), 1.0 - frac)
    np.add.at(m, (rows, np.minimum(first + 1, n_sub - 1).astype(np.int64)), frac)
    return m


def resized_planes(data, h: int, w: int, dtype) -> Tuple:
    """The Y, U and V planes of a 4:2:0 frame (torch u8) resized to `h` x
    `w` on the u8 scale, f32: Lanczos-3 along each axis, the chroma's 2x
    bilinear upsampling composed into its weights; weights rounded to
    `dtype`, the rows' f32 sums rounded to `dtype`, the columns' kept."""
    import torch

    dev = data[0].device
    in_h, in_w = data[0].shape

    def rounded(x):
        return x.to(dtype).to(torch.float32)

    def weights(m):
        return rounded(torch.tensor(np.asarray(m, np.float32), device=dev))

    lh, lw = lanczos3_matrix(in_h, h), lanczos3_matrix(in_w, w)
    out = []
    for p, plane in enumerate(data):
        wh, ww = lh, lw
        if p:
            wh = lh @ chroma_upsample_matrix(in_h, plane.shape[0])
            ww = lw @ chroma_upsample_matrix(in_w, plane.shape[1])
        x = rounded(weights(wh) @ rounded(plane.to(torch.float32)))
        out.append(x @ weights(ww).t())
    return tuple(out)


def yuv_to_rgb(y, u, v):
    """BT.709 limited range, u8 scale -> RGB in [0, 1] units, unclamped."""
    y = (y / 255.0 - 16.0 / 255.0) * (255.0 / 219.0)
    u = (u / 255.0 - 16.0 / 255.0) * (255.0 / 224.0) - 0.5
    v = (v / 255.0 - 16.0 / 255.0) * (255.0 / 224.0) - 0.5
    return y + 1.5748 * v, y - 0.1873 * u - 0.4681 * v, y + 1.8556 * u


def rgb_to_yuv420(rgb) -> Tuple:
    """(3, H, W) RGB in [0, 1] -> u8 Y, U, V: BT.709 limited range, each
    sample clamped to [0, 1], chroma the mean of each 2 x 2 block, u8 by
    rounding half to even."""
    import torch

    r, g, b = rgb
    y = (0.2126 * r + 0.7152 * g + 0.0722 * b) * (219.0 / 255.0) + 16.0 / 255.0
    u = (-0.1146 * r - 0.3854 * g + 0.5 * b) * (224.0 / 255.0) + 128.0 / 255.0
    v = (0.5 * r - 0.4542 * g - 0.0458 * b) * (224.0 / 255.0) + 128.0 / 255.0

    def u8(x):
        return torch.clamp(torch.round(x * 255.0), 0, 255).to(torch.uint8)

    def half(x):
        return (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]) * 0.25

    y, u, v = (torch.clamp(c, 0.0, 1.0) for c in (y, u, v))
    return u8(y), u8(half(u)), u8(half(v))


def signed_distance(px, py, rect: Rect, radius: float):
    """Signed distance from pixel centres (px, py) to a rect with rounded
    corners of `radius`: negative inside."""
    import torch

    top, left, h, w = (float(np.float32(v)) for v in rect)
    qx = torch.abs(px - (left + w * 0.5)) - w * 0.5 + radius
    qy = torch.abs(py - (top + h * 0.5)) - h * 0.5 + radius
    outside = torch.sqrt(torch.clamp(qx, min=0.0) ** 2 + torch.clamp(qy, min=0.0) ** 2)
    return torch.clamp(torch.maximum(qx, qy), max=0.0) + outside - radius


def smoothstep(e0: float, e1: float, x):
    import torch

    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def coverage(px, py, rect: Rect, radius: float):
    """The share of a pixel inside a rounded rect: its distance ramped
    over one pixel about the edge."""
    return smoothstep(-0.5, 0.5, -signed_distance(px, py, rect, radius))


def border_ring(px, py, box: Rect, radius: float, width: float):
    """The alpha of a box's border of `width` along its inside edge: the
    box's own anti-aliased edge outside the ring's middle, and within, a
    ramp from the border to the box's transparent fill between `width`
    and `width` + 1 pixels inside."""
    import torch

    inside = -signed_distance(px, py, box, radius)
    return torch.where(inside > width * 0.5, 1.0 - smoothstep(width, width + 1.0, inside),
                       smoothstep(-0.5, 0.5, inside))


def shadow_alpha(px, py, box: Rect, radius: float, shadow: dict):
    """The alpha of a box shadow: the box moved by the offset, its corners
    rounded by `blur_radius` / 2 more, its edge ramped over `blur_radius`
    (at least 1) pixels centred on it."""
    top, left, h, w = box
    blur = max(float(shadow["blur_radius"]), 1.0)
    moved = (top + shadow["offset_y"], left + shadow["offset_x"], h, w)
    inside = -signed_distance(px, py, moved, radius + shadow["blur_radius"] / 2)
    return smoothstep(-blur / 2, blur / 2, inside)


def _over(canvas, layer) -> None:
    """Premultiplied OVER of a (4, H, W) layer onto the canvas, in place."""
    canvas.mul_(1.0 - layer[3:4]).add_(layer)


def _paint(canvas, rgba, alpha) -> None:
    """OVER of a straight-alpha colour (0-255 values) at `alpha`."""
    import torch

    c = torch.tensor([v / 255.0 for v in rgba], device=canvas.device)
    premultiplied = torch.cat([c[:3] * c[3], c[3:]])
    _over(canvas, premultiplied[:, None, None] * alpha[None])


def render(cfg: dict, inputs: List[str], planes: Dict[str, tuple], device, dtype
           ) -> Tuple[np.ndarray, ...]:
    """One output frame: the styled multiview of `inputs` (ids, in tile
    order) over `planes` ({input id: (format, (y, u, v))}), as host u8
    planes."""
    import torch

    if cfg["output_format"] != "PLANAR_YUV420":
        raise ValueError(f"no reference for a {cfg['output_format']} output")
    H, W = cfg["output_height"], cfg["output_width"]
    py = (torch.arange(H, dtype=torch.float32, device=device) + 0.5)[:, None].expand(H, W)
    px = (torch.arange(W, dtype=torch.float32, device=device) + 0.5)[None, :].expand(H, W)
    canvas = torch.zeros((4, H, W), dtype=torch.float32, device=device)
    _paint(canvas, cfg["background_color"], coverage(px, py, (0.0, 0.0, H, W), 0.0))
    boxes = tile_rects(len(inputs), W, H, tuple(cfg["tile_aspect_ratio"]), cfg["margin"],
                       cfg["padding"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i, (iid, box) in enumerate(zip(inputs, boxes)):
            fmt, data = planes[iid]
            if fmt != "PLANAR_YUV420":
                raise ValueError(f"no reference for a {fmt} input")
            style = cfg["style"]["even" if i % 2 == 0 else "odd"]
            radius = min(float(style["border_radius"]), box[2] / 2, box[3] / 2)
            border = float(style.get("border_width", 0.0))
            for shadow in style.get("box_shadow", []):
                _paint(canvas, shadow["color"], shadow_alpha(px, py, box, radius, shadow))
            if border > 0:
                _paint(canvas, style["border_color"], border_ring(px, py, box, radius, border))
            in_h, in_w = data[0].shape
            pic = picture_rect(box, border, in_w, in_h)
            top, left, h, w = (round(v) for v in pic)
            rgb = yuv_to_rgb(*resized_planes(tuple(p.to(device) for p in data), h, w, dtype))
            layer = torch.zeros((4, H, W), dtype=torch.float32, device=device)
            y0, x0 = max(top, 0), max(left, 0)
            y1, x1 = min(top + h, H), min(left + w, W)
            for c, plane in enumerate(rgb):
                layer[c, y0:y1, x0:x1] = plane[y0 - top:y1 - top, x0 - left:x1 - left]
            layer[3, y0:y1, x0:x1] = 1.0
            clip = (box[0] + border, box[1] + border, box[2] - 2 * border, box[3] - 2 * border)
            alpha = coverage(px, py, pic, 0.0) * coverage(px, py, clip, max(radius - border, 0.0))
            _over(canvas, layer * alpha[None])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return tuple(p.cpu().numpy() for p in rgb_to_yuv420(canvas[:3]))
