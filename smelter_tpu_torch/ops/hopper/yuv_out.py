"""K2: channel-major RGBA canvas -> BT.709 YUV420 u8 planes in one pass.

Replaces the Pallas TPU kernel `smelter_tpu/ops/pallas/yuv_out.py`
(`_kernel_body`, launched at :125). The CUDA kernel is
`smelter_tpu_torch/csrc/yuv_out.cu`: one thread per 2x2 quad, bound by
memory bandwidth (it reads 3 of the 4 f32 planes and writes 1.5 bytes a
pixel), for any H and W, with the VALID odd-edge semantics of the reference
chain.

`rgba_cm_to_yuv420` launches the kernel for a CUDA tensor and takes the plain
version, `rgba_cm_to_yuv420_plain`, only for a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from smelter_tpu_torch.ops.hopper import build
from smelter_tpu_torch.ops.color_convert import (
    downsample_chroma_2x2,
    f32_to_u8,
    rgb_planes_to_yuv,
)

# kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0


def rgba_cm_to_yuv420_plain(
    rgba_cm: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unfused chain: colour matrix and per-pixel clip at full
    resolution, 2x2 chroma mean, u8 rounding."""
    y, u, v = rgb_planes_to_yuv(rgba_cm[0], rgba_cm[1], rgba_cm[2], full_range)
    return (
        f32_to_u8(y),
        f32_to_u8(downsample_chroma_2x2(u)),
        f32_to_u8(downsample_chroma_2x2(v)),
    )


def _launch(rgba_cm: torch.Tensor, full_range: bool):
    global LAUNCHES
    if rgba_cm.dtype != torch.float32 or rgba_cm.dim() != 3 or rgba_cm.shape[0] != 4:
        raise ValueError(
            f"K2 takes a (4, H, W) f32 canvas, got {tuple(rgba_cm.shape)} "
            f"{rgba_cm.dtype}"
        )
    if not rgba_cm.is_contiguous():
        raise ValueError("K2 takes a contiguous canvas")
    _, h, w = rgba_cm.shape
    if h == 0 or w == 0:
        raise ValueError(f"K2 takes a non-empty canvas, got {h}x{w}")
    dev = rgba_cm.device
    y = torch.empty((h, w), dtype=torch.uint8, device=dev)
    u = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
    v = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = build.library().smelter_yuv420_out(
            rgba_cm.data_ptr(), y.data_ptr(), u.data_ptr(), v.data_ptr(),
            h, w, int(bool(full_range)), stream,
        )
    build.check(err, "yuv420_out launch")
    LAUNCHES += 1
    return y, u, v


def rgba_cm_to_yuv420(
    rgba_cm: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(4, H, W) f32 canvas -> u8 (y (H, W), u, v (H//2, W//2)) planes.
    Runs K2 on a CUDA tensor (raising if it cannot) and the plain version on
    a CPU tensor. Alpha is never read."""
    if rgba_cm.device.type == "cpu":
        return rgba_cm_to_yuv420_plain(rgba_cm, full_range)
    if rgba_cm.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {rgba_cm.device}")
    return _launch(rgba_cm, full_range)
