"""Gather-free static rotation of channel-major tiles (Paeth 3-shear).

Port of the static-angle path of `smelter_tpu/ops/rotate.py`:

    R(psi) = ShearX(-tan(psi/2)) . ShearY(sin psi) . ShearX(-tan(psi/2))

Each shear shifts rows (or columns) by an amount linear in the row index,
applied as a barrel shifter: log2(max_shift) whole-tile shifts, each gated
per row by one bit of that row's integer shift, then one per-row fractional
blend with the neighbour. Quarter turns are `torch.rot90`. The per-row masks
and fractions are numpy constants of (shear, shape), built once per device
(`_shear_plan`) so that eager frames rebuild nothing. Plain PyTorch: pads,
slices and `torch.where`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# The barrel shifter's op count scales with log2 of the shift range, so the
# band count bounds nothing but absurd degenerate geometry.
MAX_SHEAR_BANDS = 1 << 20


def rotation_band_count(theta_deg: float, h: int, w: int) -> int:
    """Estimated total shear bands for rotating an (h, w) tile."""
    psi = math.radians(_normalize(theta_deg)[1])
    a, b = abs(math.tan(psi / 2.0)), abs(math.sin(psi))
    oh, ow = rotated_bbox(theta_deg, h, w)
    return int(a * (oh + 4) + 1) * 2 + int(b * (ow + 4) + 1)


def rotated_bbox(theta_deg: float, h: int, w: int) -> Tuple[int, int]:
    """Axis-aligned bbox (H, W) of an (h, w) rect rotated by theta."""
    t = math.radians(theta_deg)
    bw = abs(math.cos(t)) * w + abs(math.sin(t)) * h
    bh = abs(math.sin(t)) * w + abs(math.cos(t)) * h
    return int(math.ceil(bh)), int(math.ceil(bw))


def _normalize(theta_deg: float) -> Tuple[int, float]:
    """theta -> (quarter_turns, psi) with psi in [-45, 45]."""
    t = theta_deg % 360.0
    q = int(round(t / 90.0)) % 4
    psi = t - 90.0 * (round(t / 90.0))
    return q, psi


@functools.lru_cache(maxsize=64)
def _shear_plan(k: float, H: int, W: int, device: torch.device) -> Optional[tuple]:
    """Constants of one width shear of an (H, W) image: pads, the per-bit
    row masks (bits, H, 1) and the per-row fractions (H, 1). None when the
    shear moves every row out of the image (the result is all zero)."""
    delta = k * (np.arange(H, dtype=np.float64) + 0.5 - H / 2.0)
    i = np.floor(delta).astype(np.int64)
    f = (delta - i).astype(np.float32)
    imin, imax = int(i.min()), int(i.max())
    if max(abs(imin), abs(imax)) + 1 >= W:
        return None
    bias = -imin if imin < 0 else 0
    shifts = i + bias  # nonnegative right-shifts
    left = imax + 1 if imax > 0 else 1
    right = bias + 1
    bits = int(shifts.max()).bit_length()
    masks = np.stack(
        [((shifts >> b) & 1).astype(bool).reshape(H, 1) for b in range(bits)]
    ) if bits else np.zeros((0, H, 1), bool)
    return (
        left, right, bias,
        torch.from_numpy(masks).to(device),
        torch.from_numpy(f.reshape(H, 1)).to(device),
    )


def _shear_w(img: torch.Tensor, k: float) -> torch.Tensor:
    """out[..., r, c] = bilinear img[..., r, c - k*(r - H/2)]; zero fill.
    Operates on (..., H, W): the shifts run along the last axis."""
    H, W = img.shape[-2], img.shape[-1]
    if H == 0 or abs(k) < 1e-12:
        return img
    plan = _shear_plan(k, H, W, img.device)
    if plan is None:
        return torch.zeros_like(img)
    left, right, bias, masks, frac = plan
    work = F.pad(img, (left, right))
    padded_w = W + left + right
    for bit in range(masks.shape[0]):
        step = 1 << bit
        shifted = F.pad(work[..., : padded_w - step], (step, 0))
        work = torch.where(masks[bit], shifted, work)
    neighbor = F.pad(work[..., : padded_w - 1], (1, 0))
    blended = work * (1.0 - frac) + neighbor * frac
    return blended[..., left + bias : left + bias + W]


def _shear_h(img: torch.Tensor, k: float) -> torch.Tensor:
    return _shear_w(img.transpose(-2, -1), k).transpose(-2, -1)


def rotate_static_cm(
    tile: torch.Tensor, theta_deg: float, out_h: int, out_w: int
) -> torch.Tensor:
    """Rotate (..., h, w) f32 premultiplied content by `theta_deg`
    (clockwise, y-down — the layout shader's frame) about the tile center;
    returns the (..., out_h, out_w) crop centered on the same point,
    transparent-filled. The angle is static."""
    q, psi = _normalize(theta_deg)
    if q:
        # rot90 with k>0 turns counter-clockwise in array display; clockwise
        # (y-down, positive theta) quarter turns need k=-q
        tile = torch.rot90(tile, k=-q, dims=(-2, -1))
    h, w = tile.shape[-2], tile.shape[-1]
    # centered embed with matching parity so the content center stays exact
    py = max((out_h - h + 1) // 2, 0) + 2
    px = max((out_w - w + 1) // 2, 0) + 2
    work = F.pad(tile, (px, px, py, py))
    if abs(psi) > 1e-9:
        rad = math.radians(psi)
        a = -math.tan(rad / 2.0)
        b = math.sin(rad)
        work = _shear_w(work, a)
        work = _shear_h(work, b)
        work = _shear_w(work, a)
    WH, WW = work.shape[-2], work.shape[-1]
    t0 = (WH - out_h) // 2
    l0 = (WW - out_w) // 2
    return work[..., t0 : t0 + out_h, l0 : l0 + out_w]
