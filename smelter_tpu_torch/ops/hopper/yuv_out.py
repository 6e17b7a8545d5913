"""K2: channel-major RGBA canvas -> BT.709 YUV420 u8 planes in one pass.

Replaces the Pallas TPU kernel `smelter_tpu/ops/pallas/yuv_out.py`
(`_kernel_body`, launched at :125). The CUDA kernel is
`smelter_tpu_torch/csrc/yuv_out.cu`: one thread per 2x2 quad, bound by
memory bandwidth (it reads 3 of the 4 canvas planes and writes 1.5 bytes a
pixel), for any H and W, with the VALID odd-edge semantics of the reference
chain. The canvas is f32 or 16-bit storage (u16 fixed point, f16, bf16;
`color_convert.canvas_decode`), decoded in registers; a 16-bit canvas with
W % 4 == 0 on an 8-byte boundary is read 8 bytes at a time.

`rgba_cm_to_yuv420` launches the kernel for a CUDA tensor and takes the plain
version, `rgba_cm_to_yuv420_plain`, only for a CPU tensor.
"""

from __future__ import annotations

from typing import Tuple

import torch

from smelter_tpu_torch.ops.hopper import build
from smelter_tpu_torch.render.capture import each_run
from smelter_tpu_torch.ops.color_convert import (
    canvas_decode,
    downsample_chroma_2x2,
    f32_to_u8,
    rgb_planes_to_yuv,
)

# canvas storage dtypes the kernel reads, by the code its entry takes
IN_DTYPES = {torch.float32: 0, torch.uint16: 1, torch.float16: 2, torch.bfloat16: 3}

# kernel launches since the last reset (the main path's proof of use); a
# CUDA graph's replays count the launches captured in it
LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


def rgba_cm_to_yuv420_plain(
    rgba_cm: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unfused chain on the decoded colour planes: colour matrix and
    per-pixel clip at full resolution, 2x2 chroma mean, u8 rounding."""
    rgb = canvas_decode(rgba_cm[:3])
    y, u, v = rgb_planes_to_yuv(rgb[0], rgb[1], rgb[2], full_range)
    return (
        f32_to_u8(y),
        f32_to_u8(downsample_chroma_2x2(u)),
        f32_to_u8(downsample_chroma_2x2(v)),
    )


def _launch(rgba_cm: torch.Tensor, full_range: bool):
    if rgba_cm.dtype not in IN_DTYPES or rgba_cm.dim() != 3 or rgba_cm.shape[0] != 4:
        raise ValueError(
            f"K2 takes a (4, H, W) f32, uint16, float16 or bfloat16 canvas, got "
            f"{tuple(rgba_cm.shape)} {rgba_cm.dtype}"
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
            h, w, int(bool(full_range)), IN_DTYPES[rgba_cm.dtype], stream,
        )
    build.check(err, "yuv420_out launch")
    each_run(_count)
    return y, u, v


def rgba_cm_to_yuv420(
    rgba_cm: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(4, H, W) canvas (f32, or 16-bit storage) -> u8 (y (H, W), u, v
    (H//2, W//2)) planes. Runs K2 on a CUDA tensor (raising if it cannot)
    and the plain version on a CPU tensor. Alpha is never read."""
    if rgba_cm.device.type == "cpu":
        return rgba_cm_to_yuv420_plain(rgba_cm, full_range)
    if rgba_cm.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA or CPU tensors, not {rgba_cm.device}")
    return _launch(rgba_cm, full_range)
