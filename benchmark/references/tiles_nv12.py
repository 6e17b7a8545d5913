"""The plain reference of the Tiles scene (`scenes/tiles.py`) over NV12
inputs, written from the configuration's rules (`configs/
tiles16_4k_nv12.json`, `math`) and not from the program's code:

  - the tiles' rects by upstream's Tiles rules, rounded to whole pixels
    (`tile_rects` of `references/tiles.py`);
  - each input converted at full resolution: its interleaved chroma
    upsampled 2x bilinear (`chroma_upsample_matrix` of
    `references/multiview.py`), BT.709 limited range expanded and clamped,
    RGB clamped to [0, 1], alpha 1;
  - the four RGBA channels resized to the tile's rect by separable
    Lanczos-3 (`lanczos3_matrix` of `references/tiles.py`), operands and
    weights rounded to the configuration's precision, rows then columns,
    each pass an f32 sum rounded to that precision;
  - each tile blended by premultiplied OVER onto the background, then
    BT.709 limited range, 4:2:0, u8 (`rgb_to_yuv420` of
    `references/multiview.py`).

It imports nothing of the program. `render` runs in plain PyTorch on the
device it is given, with TF32 off, one input at a time."""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np


def _beside(name: str):
    """The reference `name`.py beside this file."""
    spec = importlib.util.spec_from_file_location(
        f"tiles_nv12_reference_{name}", Path(__file__).with_name(f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_tiles, _multiview = _beside("tiles"), _beside("multiview")
tile_rects, lanczos3_matrix = _tiles.tile_rects, _tiles.lanczos3_matrix
# the 2x bilinear chroma upsampling and the YUV 4:2:0 output are the
# multiview's rules (the configuration's `chroma_upsampling`, `rgb_to_yuv`)
chroma_upsample_matrix = _multiview.chroma_upsample_matrix
rgb_to_yuv420 = _multiview.rgb_to_yuv420


def nv12_rgba(y, uv):
    """An NV12 frame (torch u8: y (H, W), uv (H/2, W/2, 2)) -> (4, H, W)
    f32 RGBA: chroma upsampled, BT.709 limited range with Y', U' and V'
    clamped, RGB clamped to [0, 1], alpha 1."""
    import torch

    dev = y.device
    h, w = y.shape
    uh = torch.tensor(chroma_upsample_matrix(h, uv.shape[0]), dtype=torch.float32, device=dev)
    uw = torch.tensor(chroma_upsample_matrix(w, uv.shape[1]), dtype=torch.float32, device=dev)

    def full(plane):
        return (uh @ plane.to(torch.float32)) @ uw.t()

    luma = torch.clamp((y.to(torch.float32) - 16.0) / 219.0, 0.0, 1.0)
    u = torch.clamp((full(uv[..., 0]) - 16.0) / 224.0, 0.0, 1.0) - 0.5
    v = torch.clamp((full(uv[..., 1]) - 16.0) / 224.0, 0.0, 1.0) - 0.5
    rgb = torch.stack([luma + 1.5748 * v, luma - 0.1873 * u - 0.4681 * v, luma + 1.8556 * u])
    return torch.cat([torch.clamp(rgb, 0.0, 1.0), torch.ones_like(luma)[None]])


def resize(img, h: int, w: int, dtype):
    """(C, H, W) f32 resized to (C, h, w) by Lanczos-3 along each axis:
    operands and weights rounded to `dtype`, rows first, each pass an f32
    sum rounded to `dtype`."""
    import torch

    def rounded(x):
        return x.to(dtype).to(torch.float32)

    dev = img.device
    wh = rounded(torch.tensor(lanczos3_matrix(img.shape[1], h), device=dev))
    ww = rounded(torch.tensor(lanczos3_matrix(img.shape[2], w), device=dev))
    x = rounded(wh @ rounded(img))
    return rounded(x @ ww.t())


def render(cfg: dict, inputs: List[str], planes: Dict[str, tuple], device, dtype
           ) -> Tuple[np.ndarray, ...]:
    """One output frame: the Tiles of `inputs` (ids, in tile order) over
    `planes` ({input id: ("NV12", (y, uv))}), as host u8 planes."""
    import torch

    if cfg["output_format"] != "PLANAR_YUV420":
        raise ValueError(f"no reference for a {cfg['output_format']} output")
    H, W = cfg["output_height"], cfg["output_width"]
    r, g, b, a = (c / 255.0 for c in cfg["background_color"])
    bg = torch.tensor([r * a, g * a, b * a, a], dtype=torch.float32, device=device)
    canvas = bg[:, None, None].expand(4, H, W).clone()
    rects = tile_rects(len(inputs), W, H, tuple(cfg["tile_aspect_ratio"]),
                       cfg["margin"], cfg["padding"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for iid, (top, left, h, w) in zip(inputs, rects):
            fmt, data = planes[iid]
            if fmt != "NV12":
                raise ValueError(f"no reference for a {fmt} input")
            in_h, in_w = data[0].shape
            if abs(h * in_w - w * in_h) > max(in_w, in_h):
                raise ValueError(f"tile {iid} of {w}x{h}: not the input's aspect ratio")
            tile = resize(nv12_rgba(*(p.to(device) for p in data)), h, w, dtype)
            y0, x0, y1, x1 = max(top, 0), max(left, 0), min(top + h, H), min(left + w, W)
            tile = tile[:, y0 - top:y1 - top, x0 - left:x1 - left]
            under = canvas[:, y0:y1, x0:x1]
            canvas[:, y0:y1, x0:x1] = tile + under * (1.0 - tile[3:4])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return tuple(p.cpu().numpy() for p in rgb_to_yuv420(canvas[:3]))
