"""BT.709 colour conversion for the compose path.

Port of the pieces of `smelter_tpu/ops/color_convert.py` that the flagship
slice runs: u8 <-> f32, RGB planes -> YUV, the 2x2 chroma mean, the
deferred-YUV tile convert (`yuv_tile_rgba_cm`) and the channel-major
canvas -> YUV420 output, which runs kernel K2 (`ops/hopper/yuv_out.py`).

Everything is f32 in [0, 1]; constants and operation order follow the
reference so that the two packages agree to the u8 LSB.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from smelter_tpu_torch.ops.resample import _dense_axis_weights, device_weights, to_bf16_values

# Limited-range footroom/scale: Y in [16, 235], UV in [16, 240] (8-bit).
_Y_SCALE = 219.0 / 255.0
_UV_SCALE = 224.0 / 255.0
_FOOTROOM = 16.0 / 255.0


def u8_to_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * (1.0 / 255.0)


def f32_to_u8(x: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def rgb_planes_to_yuv(r, g, b, full_range: bool = False):
    """BT.709 from separate R/G/B planes (the channel-major compose canvas
    feeds these directly)."""
    y = 0.2126 * r + 0.7152 * g + 0.0722 * b
    u = -0.1146 * r - 0.3854 * g + 0.5 * b + 0.5
    v = 0.5 * r - 0.4542 * g - 0.0458 * b + 0.5
    if not full_range:
        y = y * _Y_SCALE + _FOOTROOM
        u = (u - 0.5) * _UV_SCALE + 0.5 * _UV_SCALE + _FOOTROOM
        v = (v - 0.5) * _UV_SCALE + 0.5 * _UV_SCALE + _FOOTROOM
    return (
        torch.clamp(y, 0.0, 1.0),
        torch.clamp(u, 0.0, 1.0),
        torch.clamp(v, 0.0, 1.0),
    )


def downsample_chroma_2x2(plane: torch.Tensor) -> torch.Tensor:
    """Mean of 2x2 blocks with VALID semantics (an odd last row or column is
    dropped). Summed in window order, ((a00 + a01) + a10) + a11, as the
    reference's reduce_window sums, then scaled by 0.25."""
    h2, w2 = plane.shape[-2] // 2, plane.shape[-1] // 2
    p = plane[..., : 2 * h2, : 2 * w2]
    s = p[..., 0::2, 0::2] + p[..., 0::2, 1::2]
    s = s + p[..., 1::2, 0::2]
    s = s + p[..., 1::2, 1::2]
    return s * 0.25


def _chroma_upsample_matrix(n_full: int, n_sub: int) -> np.ndarray:
    """(n_full, n_sub) matrix form of texel-center aligned linear chroma
    upsampling along one axis; identity when not subsampled."""
    if n_full == n_sub:
        return np.eye(n_sub, dtype=np.float32)
    U = np.zeros((n_full, n_sub), np.float32)
    pos = (np.arange(n_full) + 0.5) * (n_sub / n_full) - 0.5
    i0 = np.clip(np.floor(pos).astype(np.int64), 0, n_sub - 1)
    i1 = np.clip(i0 + 1, 0, n_sub - 1)
    frac = np.clip(pos - np.floor(pos), 0.0, 1.0).astype(np.float32)
    rows = np.arange(n_full)
    np.add.at(U, (rows, i0), 1.0 - frac)
    np.add.at(U, (rows, i1), frac)
    return U


@functools.lru_cache(maxsize=256)
def tile_weights(
    luma_hw: Tuple[int, int],
    chroma_hw: Tuple[int, int],
    crop: Tuple[int, int, int, int],
    out_h: int,
    out_w: int,
    kind: str,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Wh, Ww, Wch, Wcw) for `yuv_tile_rgba_cm`: the luma resize matrices and
    the chroma ones composed with the bilinear upsample, rows sliced by the
    luma crop. Built once per (shapes, crop, size, device) as bf16-rounded
    f32 device tensors; the Python row loops never run per frame."""
    ct, cl, chh, cww = crop
    Wh = _dense_axis_weights(chh, out_h, kind)
    Ww = _dense_axis_weights(cww, out_w, kind)
    Uh = _chroma_upsample_matrix(luma_hw[0], chroma_hw[0])
    Uw = _chroma_upsample_matrix(luma_hw[1], chroma_hw[1])
    Wch = Wh @ Uh[ct : ct + chh]
    Wcw = Ww @ Uw[cl : cl + cww]
    return tuple(device_weights(m, device) for m in (Wh, Ww, Wch, Wcw))


def _rs(img: torch.Tensor, wr: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    # rows, rounded to bf16 between the axes; columns, kept f32 (the
    # reference casts the first product only)
    x = to_bf16_values(torch.matmul(wr, img.to(torch.float32)))
    return torch.matmul(x, wc.t())


def yuv_tile_rgba_cm(
    y: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    crop: Tuple[int, int, int, int],  # (top, left, h, w) in luma pixels
    out_h: int,
    out_w: int,
    full_range: bool = False,
    kind: str = "lanczos3",
) -> torch.Tensor:
    """Crop + resize + BT.709-convert planar YUV u8 planes straight to a
    channel-major (4, out_h, out_w) f32 RGBA tile (alpha = 1), never
    materializing full-resolution RGBA.

    Resizing commutes with the affine colour matrix (the resize weights sum
    to 1), so the subsampled planes resize first. As in the reference, the
    limited-range expansion and the RGB clamps are NOT applied per pixel at
    full resolution first: out-of-range YUV blends linearly, and only the
    end-of-pipe u8 clamp bounds the output."""
    ct, cl, chh, cww = crop
    Wh, Ww, Wch, Wcw = tile_weights(
        tuple(y.shape), tuple(u.shape), tuple(crop), out_h, out_w, kind, y.device
    )
    yt = _rs(y[ct : ct + chh, cl : cl + cww], Wh, Ww) * (1.0 / 255.0)
    ut = _rs(u, Wch, Wcw) * (1.0 / 255.0)
    vt = _rs(v, Wch, Wcw) * (1.0 / 255.0)
    if not full_range:
        yt = (yt - _FOOTROOM) * (1.0 / _Y_SCALE)
        ut = (ut - _FOOTROOM) * (1.0 / _UV_SCALE)
        vt = (vt - _FOOTROOM) * (1.0 / _UV_SCALE)
    ut = ut - 0.5
    vt = vt - 0.5
    r = yt + 1.5748 * vt
    g = yt - 0.1873 * ut - 0.4681 * vt
    b = yt + 1.8556 * ut
    return torch.stack([r, g, b, torch.ones_like(r)], dim=0)


class DeferredYuvSource:
    """Planar-YUV input whose RGBA conversion is deferred: static texture
    layouts crop+resize the subsampled planes directly (`tile_cm`)."""

    def __init__(self, y, u, v, full_range: bool = False):
        self.planes = (y, u, v)
        self.full_range = full_range

    def tile_cm(self, crop, out_h: int, out_w: int) -> torch.Tensor:
        y, u, v = self.planes
        return yuv_tile_rgba_cm(
            y, u, v, crop, out_h, out_w, full_range=self.full_range
        )


def planar_rgba_to_yuv420(
    rgba_cm: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(4, H, W) RGBA f32 [0, 1] -> (y, u, v) u8 planes, 4:2:0, through
    kernel K2 (its plain version for a CPU tensor)."""
    from smelter_tpu_torch.ops.hopper import yuv_out

    return yuv_out.rgba_cm_to_yuv420(rgba_cm, full_range)
