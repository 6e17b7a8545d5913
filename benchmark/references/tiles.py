"""The plain reference of the Tiles scene (`scenes/tiles.py`), written from
what the scene means and not from the program's code:

  - the tiles' rects by upstream's Tiles rules: the number of rows (and so
    columns) that gives the widest tile at the tile aspect ratio, after the
    margins and paddings; rows filled left to right, the last row holding
    the rest; rows and tiles centred;
  - each tile an input frame of the tile's aspect ratio filling its rect,
    its Y plane resized to the rect and its U and V planes to half of it
    (the YUV 4:2:0 grid composed in the YUV domain), by the resize that the configuration states
    (`resize`, `precision`): a separable Lanczos-3 filter, rows then
    columns, each pass an f32 sum rounded to `precision`, then u8 by round
    half up;
  - the background, where no tile lies, in BT.709 limited range.

It imports nothing of the program. `render` runs in plain PyTorch on the
device it is given, with TF32 off."""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import numpy as np

Rect = Tuple[int, int, int, int]  # top, left, height, width


def tile_rects(n: int, width: float, height: float, aspect: Tuple[int, int],
               margin: float, padding: float) -> List[Rect]:
    """The rects of `n` tiles in a `width` x `height` layout."""
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
            rects.append((round(top), round(left), round(th), round(tw)))
            left += tw + 2 * padding + margin
        top += th + 2 * padding + margin
    return rects


@functools.lru_cache(maxsize=64)
def lanczos3_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f32 weights of a Lanczos-3 resize of one axis: each
    output sample at its texel centre, the filter widened by the downscale
    ratio, taps beyond the edges clamped to them, each row summing to 1
    (read-only: cached by size)."""
    scale = n_in / n_out
    widen = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale - 0.5
    taps = np.floor(centre - 3 * widen)[:, None] + np.arange(int(math.ceil(6 * widen)) + 2)
    x = (taps - centre[:, None]) / widen
    w = np.where(np.abs(x) < 3, np.sinc(x) * np.sinc(x / 3), 0.0)
    m = np.zeros((n_out, n_in))
    rows = np.broadcast_to(np.arange(n_out)[:, None], taps.shape)
    np.add.at(m, (rows, np.clip(taps, 0, n_in - 1).astype(np.int64)), w)
    m = (m / m.sum(axis=1, keepdims=True)).astype(np.float32)
    m.setflags(write=False)
    return m


def bt709_limited(rgb) -> Tuple[int, int, int]:
    """Y, U, V (u8, limited range) of an RGB colour by BT.709."""
    r, g, b = (c / 255.0 for c in rgb[:3])
    y = 0.2126 * r + 0.7152 * g + 0.0722 * b
    return (round(16 + 219 * y), round(128 + 224 * (b - y) / 1.8556),
            round(128 + 224 * (r - y) / 1.5748))


def resize(plane, h: int, w: int, dtype):
    """A u8 plane (torch) resized to `h` x `w`, each pass rounded to `dtype`."""
    import torch

    def rounded(x):
        return x.to(dtype).to(torch.float32)

    dev = plane.device
    wh = rounded(torch.tensor(lanczos3_matrix(plane.shape[0], h), device=dev))
    ww = rounded(torch.tensor(lanczos3_matrix(plane.shape[1], w), device=dev))
    x = rounded(wh @ rounded(plane.to(torch.float32)))
    x = rounded(x @ ww.t())
    return torch.clamp(torch.floor(x + 0.5), 0, 255).to(torch.uint8)


def render(cfg: dict, inputs: List[str], planes: Dict[str, tuple], device, dtype
           ) -> Tuple[np.ndarray, ...]:
    """One output frame: the Tiles of `inputs` (ids, in tile order) over
    `planes` ({input id: (format, (y, u, v))}), as host u8 planes."""
    import torch

    if cfg["output_format"] != "PLANAR_YUV420":
        raise ValueError(f"no reference for a {cfg['output_format']} output")
    H, W = cfg["output_height"], cfg["output_width"]
    bg = bt709_limited(cfg["background_color"])
    out = [torch.full((H, W), bg[0], dtype=torch.uint8, device=device),
           torch.full((H // 2, W // 2), bg[1], dtype=torch.uint8, device=device),
           torch.full((H // 2, W // 2), bg[2], dtype=torch.uint8, device=device)]
    rects = tile_rects(len(inputs), W, H, tuple(cfg["tile_aspect_ratio"]),
                       cfg["margin"], cfg["padding"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for iid, (top, left, h, w) in zip(inputs, rects):
            fmt, data = planes[iid]
            if fmt != "PLANAR_YUV420":
                raise ValueError(f"no reference for a {fmt} input")
            if (top | left | h | w) % 2:
                raise ValueError(f"tile {iid} at {(top, left, h, w)}: not on the chroma grid")
            in_h, in_w = data[0].shape
            if abs(h * in_w - w * in_h) > max(in_w, in_h):
                raise ValueError(f"tile {iid} of {w}x{h}: not the input's aspect ratio")
            for p, (src, s) in enumerate(zip(data, (1, 2, 2))):
                t, l = top // s, left // s
                out[p][t:t + h // s, l:l + w // s] = resize(src.to(device), h // s, w // s, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return tuple(p.cpu().numpy() for p in out)
