"""The measurement tools' input frames, the port's own copies of those the
reference's tools use:

  - `make_test_input`: the reference's test harness input
    (`tests/harness.make_test_input`), which its `bench_animations.py` feeds;
  - `seeded_frame_sets`: `bench_scenes.py`'s two sets of seeded random
    frames;
  - `parse_resolution`: a "WxH" argument.

Both are host frames of planar YUV420 u8 numpy planes, converted with the
reference's operations in the reference's order (BT.709, limited range).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from smelter_tpu_torch.core.types import Frame, PixelFormat, Resolution
from smelter_tpu_torch.ops import color_convert as cc

_HUES = [(0.9, 0.2, 0.2), (0.2, 0.9, 0.2), (0.2, 0.2, 0.9), (0.9, 0.9, 0.2),
         (0.9, 0.2, 0.9), (0.2, 0.9, 0.9), (0.7, 0.5, 0.3), (0.3, 0.5, 0.7)]


def _yuv420_frame(rgb: torch.Tensor, pts: float) -> Frame:
    """(3, H, W) f32 RGB in [0, 1] -> a host planar YUV420 Frame: the
    reference's `rgba_to_planar_yuv420` (`rgb_to_yuv`, then each chroma
    plane 2x2-pooled, then u8)."""
    y, u, v = cc.rgb_planes_to_yuv(rgb[0], rgb[1], rgb[2])
    planes = (cc.f32_to_u8(y), cc.f32_to_u8(cc.downsample_chroma_2x2(u)),
              cc.f32_to_u8(cc.downsample_chroma_2x2(v)))
    h, w = rgb.shape[1:]
    return Frame(data=tuple(p.numpy() for p in planes), format=PixelFormat.PLANAR_YUV420,
                 resolution=Resolution(w, h), pts=pts)


def parse_resolution(text: str) -> Resolution:
    """"WxH" (a tool's argument) -> Resolution."""
    w, h = (int(x) for x in text.split("x"))
    return Resolution(w, h)


def make_test_input(index: int, resolution: Resolution, pts: float = 0.0) -> Frame:
    """A solid hue per index with a white square at the top left and a black
    bar at the bottom, as planar YUV420 (`tests/harness.make_test_input`)."""
    h, w = resolution.height, resolution.width
    rgb = torch.empty((3, h, w), dtype=torch.float32)
    rgb[:] = torch.tensor(_HUES[index % len(_HUES)]).view(3, 1, 1)
    rgb[:, : h // 8, : w // 8] = 1.0
    rgb[:, -h // 16:, :] = 0.0  # the harness's slice: the last ceil(h / 16) rows
    return _yuv420_frame(rgb, pts)


def seeded_frame_sets(n_inputs: int, in_res: Resolution
                      ) -> Tuple[Dict[str, Frame], Dict[str, Frame]]:
    """`bench_scenes.py`'s two input sets of `cam_0 .. cam_{n-1}`: opaque
    random RGBA frames from one `np.random.RandomState(7)`, the first set
    drawn first, at pts 0."""
    rng = np.random.RandomState(7)
    w, h = in_res.width, in_res.height

    def frame() -> Frame:
        rgba = rng.randint(0, 255, (h, w, 4), np.uint8)
        rgba[..., 3] = 255
        rgb = torch.from_numpy(rgba.astype(np.float32) / 255.0)[..., :3]
        return _yuv420_frame(rgb.permute(2, 0, 1), 0.0)

    first = {f"cam_{i}": frame() for i in range(n_inputs)}
    second = {f"cam_{i}": frame() for i in range(n_inputs)}
    return first, second
