"""K5: one static shear of the three-shear rotation, in one pass.

Stands for the barrel shear of `smelter_tpu/ops/rotate.py` (`_shear_w`,
`_shear_h`), which the JAX package leaves to XLA as a fusion of pads and
selects: no Pallas kernel, a TPU device built because the TPU gathers
badly. The card gathers well, so the CUDA kernel
(`smelter_tpu_torch/csrc/row_shear.cu`) reads each output pixel's two
source taps directly: one thread per output pixel, bound by one read of
the source and one write of the result.

`shear(img, k, axis)` is the width shear `rotate._shear_w(img, k)` for axis
-1 and the height shear `rotate._shear_h(img, k)` for axis -2, on an
(..., H, W) f32 tensor at any strides. It launches the kernel for a CUDA
tensor (into a new contiguous tensor) and runs the plain version, the
barrel shifter, for a CPU tensor. A shear too small to matter (|k| <
1e-12) returns its input and one that moves every row out returns zeros,
on both, without a launch.
"""

from __future__ import annotations

import torch

from smelter_tpu_torch.ops import rotate
from smelter_tpu_torch.ops.hopper import build
from smelter_tpu_torch.render.capture import each_run

# kernel launches since the last reset (the main path's proof of use); a
# CUDA graph's replays count the launches captured in it
LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


def shear_plain(img: torch.Tensor, k: float, axis: int) -> torch.Tensor:
    """The plain version: the barrel shifter of `ops/rotate.py`."""
    return rotate._shear_w(img, k) if axis == -1 else rotate._shear_h(img, k)


def _launch(img: torch.Tensor, k: float, axis: int) -> torch.Tensor:
    if img.dtype != torch.float32 or img.dim() < 2:
        raise ValueError(f"K5 takes an (..., H, W) f32 tensor, got {tuple(img.shape)} "
                         f"{img.dtype}")
    H, W = img.shape[-2], img.shape[-1]
    src = img.reshape(-1, H, W)
    c = src.shape[0]
    out = torch.empty((c, H, W), dtype=torch.float32, device=img.device)
    if c == 0 or W == 0:
        return out.reshape(img.shape)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = build.library().smelter_row_shear(
            src.data_ptr(), out.data_ptr(), c, H, W, *src.stride(), float(k),
            int(axis == -1), stream,
        )
    build.check(err, "row_shear launch")
    each_run(_count)
    return out.reshape(img.shape)


def shear(img: torch.Tensor, k: float, axis: int) -> torch.Tensor:
    """`rotate._shear_w(img, k)` (axis -1) or `rotate._shear_h(img, k)` (axis
    -2): K5 for a CUDA tensor (raising if it cannot launch), the plain
    version for a CPU tensor."""
    if axis not in (-1, -2):
        raise ValueError(f"K5 shears along axis -1 or -2, not {axis}")
    if img.device.type == "cpu":
        return shear_plain(img, k, axis)
    if img.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or CPU tensors, not {img.device}")
    rows, cols = (img.shape[-2], img.shape[-1]) if axis == -1 else (img.shape[-1], img.shape[-2])
    if rows == 0 or abs(k) < 1e-12:
        return img
    if rotate.shear_moves_all_out(k, rows, cols):
        return torch.zeros_like(img)
    return _launch(img, k, axis)
