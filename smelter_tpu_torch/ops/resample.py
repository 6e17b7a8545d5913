"""Separable Lanczos3 / bilinear resizing as dense per-axis GEMMs.

Port of `smelter_tpu/ops/resample.py` (weights, `resize_matmul`,
`box_downsample_2x` and `build_mips`). The
weight matrices are numpy, copied from the reference line for line so both
packages build identical matrices; the resize is two `torch.matmul` calls.

GEMM precision (the reference contract: bf16 operands, f32 accumulation, an
f32 product, then a bf16 rounding of each axis's result): the operands are
rounded to bf16 and the product is computed by an f32 GEMM. A bf16 x bf16
product is exact in f32, so this is the reference contract exactly, on any
device. `allow_tf32 = False` keeps the f32 GEMM in full f32 on the card, and
`allow_bf16_reduced_precision_reduction = False` keeps any bf16 GEMM from
reducing in bf16.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _axis_positions(out_size: int, in_size: int) -> np.ndarray:
    """Texel-center aligned source positions for each output index."""
    return (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5


def _lanczos3(x: np.ndarray) -> np.ndarray:
    """lanczos3(x) = sinc(x) * sinc(x/3) on |x| < 3."""
    x = np.abs(x)
    out = np.where(
        x < 1e-5,
        1.0,
        np.where(
            x < 3.0,
            3.0
            * np.sin(np.pi * x)
            * np.sin(np.pi * x / 3.0)
            / (np.pi * np.pi * x * x + 1e-30),
            0.0,
        ),
    )
    return out


def lanczos_axis_weights(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Static (indices, weights) for 1-D Lanczos3 resampling.

    Kernel is widened by the downscale ratio (``scale = in/out``) exactly like
    the reference shader: support = 3 * max(scale, 1), sample step 1/kernel.

    Returns indices (out_size, taps) int32 and weights (out_size, taps) f32,
    weights normalized to sum 1 per output sample.
    """
    scale = in_size / out_size
    kernel_scale = max(scale, 1.0)
    support = 3.0 * kernel_scale
    centers = _axis_positions(out_size, in_size)
    first = np.ceil(centers - support)
    taps = int(math.ceil(2.0 * support)) + 1
    offsets = np.arange(taps)
    idx = first[:, None] + offsets[None, :]
    x = (idx - centers[:, None]) / kernel_scale
    w = _lanczos3(x)
    w = w / w.sum(axis=1, keepdims=True)
    idx = np.clip(idx, 0, in_size - 1).astype(np.int32)
    return idx, w.astype(np.float32)


def _dense_axis_weights(in_size: int, out_size: int, kind: str) -> np.ndarray:
    """Dense (out, in) resampling matrix for one axis (a separable resize is
    two small dense GEMMs; the band structure wastes zeros but the matrices
    are tiny next to the pixel data)."""
    W = np.zeros((out_size, in_size), np.float32)
    if kind == "lanczos3":
        idx, wts = lanczos_axis_weights(in_size, out_size)
        for o in range(out_size):
            np.add.at(W[o], idx[o], wts[o])
    elif kind == "bilinear":
        pos = np.clip(_axis_positions(out_size, in_size), 0.0, in_size - 1.0)
        lo = np.floor(pos).astype(np.int32)
        hi = np.minimum(lo + 1, in_size - 1)
        f = (pos - lo).astype(np.float32)
        for o in range(out_size):
            W[o, lo[o]] += 1.0 - f[o]
            W[o, hi[o]] += f[o]
    else:
        raise ValueError(f"unknown resize kind {kind!r}")
    return W


def to_bf16_values(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bf16 (ties to even) and hold the result in f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def device_weights(w: np.ndarray, device) -> torch.Tensor:
    """A host weight matrix as a bf16-rounded f32 tensor on `device`."""
    return to_bf16_values(torch.from_numpy(np.ascontiguousarray(w))).to(device)


@functools.lru_cache(maxsize=256)
def axis_weights(in_size: int, out_size: int, kind: str,
                 device: torch.device) -> torch.Tensor:
    """`_dense_axis_weights` as a bf16-rounded f32 tensor on `device`, built
    once per (sizes, kind, device): eager frames must not rerun the Python
    row loop."""
    return device_weights(_dense_axis_weights(in_size, out_size, kind), device)


def resize_matmul(
    img: torch.Tensor, out_h: int, out_w: int, kind: str = "lanczos3"
) -> torch.Tensor:
    """Separable resize as two GEMMs. ``img``: (..., H, W) — leading batch
    dims allowed; resizes the last two axes. u8 inputs are exact in bf16;
    accumulation is f32, and each axis's result rounds to bf16 (the
    intermediate between the axes included). Returns bf16-valued f32."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    x = to_bf16_values(img.to(torch.float32))
    if in_h != out_h:
        wh = axis_weights(in_h, out_h, kind, img.device)
        # (out_h, H) x (..., H, W) -> (..., out_h, W)
        x = to_bf16_values(torch.matmul(wh, x))
    if in_w != out_w:
        ww = axis_weights(in_w, out_w, kind, img.device)
        # (..., h, W) x (W, out_w) -> (..., h, out_w)
        x = to_bf16_values(torch.matmul(x, ww.t()))
    return x


def box_downsample_2x(img: torch.Tensor) -> torch.Tensor:
    """Mean-pool by 2 along H and W (first two axes). Odd sizes drop the last
    row/col, like a power-of-2 box reduce."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    img = img[:h, :w]
    return img.reshape(h // 2, 2, w // 2, 2, *img.shape[2:]).mean(dim=(1, 3))


def build_mips(img: torch.Tensor, levels: int) -> list:
    """Mip pyramid [img, 1/2, 1/4, ...] via repeated 2x box reduce. (The
    region-local paths read level 0 only; the sampled texture paths that
    read the others are not ported yet.)"""
    mips = [img]
    for _ in range(levels - 1):
        if min(mips[-1].shape[0], mips[-1].shape[1]) < 2:
            break
        mips.append(box_downsample_2x(mips[-1]))
    return mips
