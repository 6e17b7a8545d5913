"""Gather-free rotation of channel-major tiles (Paeth 3-shear).

Port of `smelter_tpu/ops/rotate.py` (the channel-major entry points):

    R(psi) = ShearX(-tan(psi/2)) . ShearY(sin psi) . ShearX(-tan(psi/2))

Each shear shifts rows (or columns) by an amount linear in the row index,
applied as a barrel shifter: log2(max_shift) whole-tile shifts, each gated
per row by one bit of that row's integer shift, then one per-row fractional
blend with the neighbour. Quarter turns are `torch.rot90`.

A static angle (`rotate_static_cm`) makes the per-row masks and fractions
numpy constants of (shear, shape), built once per device (`_shear_plan`);
on a CUDA tensor each of its shears is one pass of kernel K5
(`ops/hopper/row_shear.py`), which gathers each pixel's two taps directly.
An animated angle (`rotate_traced_cm`) is a 0-d tensor on the tile's device:
the per-row bits are computed there, and only their count comes from a
static bound on the shear, so nothing waits for the host. Plain PyTorch:
pads, slices and `torch.where`.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from smelter_tpu_torch.render.capture import count_each_run, device_constant

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


@functools.lru_cache(maxsize=256)
def _shear_rows(k: float, H: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row integer shift i (int64) and fraction f (f32) of a width shear
    by k of H rows: delta = k * (r + 0.5 - H / 2) in f64, i = floor(delta),
    f = delta - i. Host-side and read-only; kernel K5 recomputes them by the
    same f64 operations."""
    delta = k * (np.arange(H, dtype=np.float64) + 0.5 - H / 2.0)
    i = np.floor(delta).astype(np.int64)
    f = (delta - i).astype(np.float32)
    return i, f


def shear_moves_all_out(k: float, H: int, W: int) -> bool:
    """Whether a width shear by k of an (H, W) image moves every row out of
    it (its result is all zero)."""
    i, _ = _shear_rows(k, H)
    return max(abs(int(i.min())), abs(int(i.max()))) + 1 >= W


@device_constant(maxsize=64)
def _shear_plan(k: float, H: int, W: int, device: torch.device) -> Optional[tuple]:
    """Constants of one width shear of an (H, W) image: pads, the per-bit
    row masks (bits, H, 1) and the per-row fractions (H, 1). None when the
    shear moves every row out of the image (the result is all zero)."""
    if shear_moves_all_out(k, H, W):
        return None
    i, f = _shear_rows(k, H)
    imin, imax = int(i.min()), int(i.max())
    bias = -imin if imin < 0 else 0
    shifts = i + bias  # nonnegative right-shifts
    left = imax + 1 if imax > 0 else 1
    right = bias + 1
    bits = int(shifts.max()).bit_length()
    masks = np.stack(
        [((shifts >> b) & 1).astype(bool).reshape(H, 1) for b in range(bits)]
    ) if bits else np.zeros((0, H, 1), bool)
    from smelter_tpu_torch.interop import upload

    return (
        left, right, bias,
        upload(torch.from_numpy(masks), device),
        upload(torch.from_numpy(f.reshape(H, 1)), device),
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


def _shear_w_traced(x: torch.Tensor, k: torch.Tensor, cy: float,
                    kmax: float) -> torch.Tensor:
    """Shift row r (axis -2) along the last axis by k*(r + 0.5 - cy), k a
    0-d tensor, by the barrel shifter of `_shear_w` with the per-row shift
    bits computed on the device: (floor(delta) >> bit) & 1 per row. The
    step count and the padding come from the static bound ``kmax`` on |k|
    (the quarter-turn buckets keep psi in [-45, 45], so |tan(psi/2)| <= 0.415
    and |sin(psi)| <= 0.708)."""
    h, w = x.shape[-2], x.shape[-1]
    delta = k * (torch.arange(h, dtype=torch.float32, device=x.device) + 0.5 - cy)
    i = torch.floor(delta).to(torch.int32)
    f = delta - i.to(torch.float32)
    bound = int(math.ceil(kmax * max(cy, h - cy))) + 1
    shifts = i + bound  # in [0, 2*bound]
    left = right = bound + 1
    work = F.pad(x, (left, right))
    padded_w = w + left + right
    for bit in range((2 * bound).bit_length()):
        step = 1 << bit
        mask = ((shifts >> bit) & 1).to(torch.bool).reshape(h, 1)
        shifted = F.pad(work[..., : padded_w - step], (step, 0))
        work = torch.where(mask, shifted, work)
    frac = f.reshape(h, 1)
    neighbor = F.pad(work[..., : padded_w - 1], (1, 0))
    work = work * (1.0 - frac) + neighbor * frac
    return work[..., left + bound : left + bound + w]


def _shear_h_traced(x: torch.Tensor, k: torch.Tensor, cx: float,
                    kmax: float) -> torch.Tensor:
    return _shear_w_traced(x.transpose(-2, -1), k, cx, kmax).transpose(-2, -1)


# static |k| bounds of the traced shears with psi in [-45, 45]
_A_MAX = 0.4143  # |tan(psi/2)|
_B_MAX = 0.7072  # |sin(psi)|


def traced_work_size(h: int, w: int) -> int:
    """Side of the working square of `rotate_traced_cm`: it holds the tile
    at every angle (its bounding circle), rounded up to a multiple of 16."""
    s = int(math.ceil(math.hypot(h, w))) + 4
    return (s + 15) // 16 * 16


def rotate_traced_cm(tile: torch.Tensor, theta_deg: torch.Tensor,
                     quarter_turns: int) -> torch.Tensor:
    """Rotate (..., h, w) f32 premultiplied content by an animated angle
    (a 0-d tensor, degrees, clockwise y-down) about the tile center; returns
    an (..., S, S) square (S = traced_work_size) centered on the same point,
    clipped to [0, 1]. ``quarter_turns`` is the planner's static
    round(theta/90) bucket, so that the residual psi stays in [-45, 45]
    where the 3-shear decomposition is stable."""
    q = quarter_turns % 4
    if q:
        tile = torch.rot90(tile, k=-q, dims=(-2, -1))
    h, w = tile.shape[-2], tile.shape[-1]
    S = traced_work_size(h, w)
    py = (S - h) // 2
    px = (S - w) // 2
    work = F.pad(tile, (px, px + (S - w) % 2, py, py + (S - h) % 2))
    cy = py + h / 2.0
    cx = px + w / 2.0
    psi = torch.remainder(theta_deg, 360.0) - 90.0 * quarter_turns
    rad = psi * (math.pi / 180.0)
    a = -torch.tan(rad / 2.0)
    b = torch.sin(rad)
    work = _shear_w_traced(work, a, cy, _A_MAX)
    work = _shear_h_traced(work, b, cx, _B_MAX)
    work = _shear_w_traced(work, a, cy, _A_MAX)
    return torch.clamp(work, 0.0, 1.0)


def rotate_static_cm(
    tile: torch.Tensor, theta_deg: float, out_h: int, out_w: int
) -> torch.Tensor:
    """Rotate (..., h, w) f32 premultiplied content by `theta_deg`
    (clockwise, y-down — the layout shader's frame) about the tile center;
    returns the (..., out_h, out_w) crop centered on the same point,
    transparent-filled. The angle is static. Each of the three shears is
    one launch of kernel K5 on a CUDA tensor (`ops/hopper/row_shear.py`)
    and the barrel shifter (`_shear_w`, `_shear_h`) on a CPU tensor."""
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
        from smelter_tpu_torch.ops.hopper.row_shear import shear

        count_each_run("program.general.shears", 3)
        rad = math.radians(psi)
        a = -math.tan(rad / 2.0)
        b = math.sin(rad)
        work = shear(work, a, -1)
        work = shear(work, b, -2)
        work = shear(work, a, -1)
    WH, WW = work.shape[-2], work.shape[-1]
    t0 = (WH - out_h) // 2
    l0 = (WW - out_w) // 2
    return work[..., t0 : t0 + out_h, l0 : l0 + out_w]
