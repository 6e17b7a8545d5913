"""Separable resizing as dense per-axis GEMMs, and bilinear sampling at
coordinates that live on the device.

Port of `smelter_tpu/ops/resample.py` but `resize_lanczos3`,
`resize_matmul_u8` and `resize_bilinear`: the static weights and
`resize_matmul`, the traced-size `resize_matmul_traced` (weights built on
the device from the size and crop of the frame), `box_downsample_2x`,
`build_mips`, `sample_bilinear` and `sample_bilinear_mip`. The static
weight matrices are numpy, copied from the reference line for line so both
packages build identical matrices; a resize is two `torch.matmul` calls.

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
    """A host weight matrix as a bf16-rounded f32 tensor on `device`,
    uploaded without waiting (`interop.upload`)."""
    from smelter_tpu_torch.interop import upload

    return upload(to_bf16_values(torch.from_numpy(np.ascontiguousarray(w))), device)


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


def _traced_axis_weights(in_size: int, buf: int, out_sz: torch.Tensor, c0, c_len,
                         centered: bool) -> torch.Tensor:
    """(buf, in_size) triangle-kernel weights of one axis, from the size and
    crop of this frame (0-d f32 tensors, or Python numbers for the crop),
    on the device; bf16-rounded f32."""
    dev = out_sz.device
    out_sz = torch.clamp(out_sz.to(torch.float32), min=1.0)
    o = (torch.arange(buf, dtype=torch.float32, device=dev) + 0.5)[:, None]
    i = torch.arange(in_size, dtype=torch.float32, device=dev)[None, :]
    scale = c_len / out_sz
    off = (buf - out_sz) * 0.5 if centered else 0.0
    pos = c0 + (o - off) * scale - 0.5
    width = torch.clamp(scale, min=1.0)
    wgt = torch.clamp(1.0 - torch.abs(pos - i) / width, min=0.0)
    wgt = wgt * ((o - 0.5 >= off) & (o - 0.5 < off + out_sz))
    norm = torch.clamp(wgt.sum(dim=1, keepdim=True), min=1e-6)
    return to_bf16_values(wgt / norm)


def resize_matmul_traced(
    img: torch.Tensor,
    buf_h: int,
    buf_w: int,
    out_h: torch.Tensor,
    out_w: torch.Tensor,
    crop=None,
    centered: bool = False,
) -> torch.Tensor:
    """Separable resize of (..., H, W) to a size that changes per frame
    (`out_h`, `out_w`: 0-d tensors on the image's device) inside a static
    (buf_h, buf_w) buffer. The dense per-axis weights are built on the
    device from that size (an anti-aliased triangle kernel of width
    max(1, in/out), so downscales average), then applied as two GEMMs, so
    nothing waits for the host. Rows and columns at or beyond the size come
    out zero.

    ``crop``: optional (top, left, width, height) source window, folded
    into the weights. ``centered=True`` writes the content centered in the
    buffer instead of top-left (a rotation about the buffer center
    follows). Rounding as the reference: bf16 weights and input, the first
    product rounded to bf16, the second kept f32."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    if crop is None:
        ct, cl, cw, chh = 0.0, 0.0, float(in_w), float(in_h)
    else:
        ct, cl, cw, chh = crop
    wh = _traced_axis_weights(in_h, buf_h, out_h, ct, chh, centered)
    ww = _traced_axis_weights(in_w, buf_w, out_w, cl, cw, centered)
    x = to_bf16_values(img.to(torch.float32))
    x = to_bf16_values(torch.matmul(wh, x))
    return torch.matmul(x, ww.t())


def box_downsample_2x(img: torch.Tensor) -> torch.Tensor:
    """Mean-pool by 2 along H and W (first two axes). Odd sizes drop the last
    row/col, like a power-of-2 box reduce."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    img = img[:h, :w]
    return img.reshape(h // 2, 2, w // 2, 2, *img.shape[2:]).mean(dim=(1, 3))


def build_mips(img: torch.Tensor, levels: int) -> list:
    """Mip pyramid [img, 1/2, 1/4, ...] via repeated 2x box reduce: the
    prefilter of the sampled texture pass (`sample_bilinear_mip`)."""
    mips = [img]
    for _ in range(levels - 1):
        if min(mips[-1].shape[0], mips[-1].shape[1]) < 2:
            break
        mips.append(box_downsample_2x(mips[-1]))
    return mips


# ---------------------------------------------------------------------------
# Sampling at coordinates computed on the device (the sampled texture pass,
# whose layout rects animate)
# ---------------------------------------------------------------------------


def _channel_major_flat(imgs) -> torch.Tensor:
    """(H, W, C) images as one channel-major (C, sum of H*W) tensor, texels
    in row-major order, image after image. Sampling gathers along its last
    axis: C gathers of floats, which on an H100 run far faster than one
    gather of (N, C) rows of 4 floats (PERF.md, section 6)."""
    return torch.cat([m.permute(2, 0, 1).reshape(m.shape[2], -1) for m in imgs], dim=1)


def _sample_flat(flat: torch.Tensor, base, in_h, in_w, ys: torch.Tensor,
                 xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the (in_h, in_w, C) image stored channel-major as
    flat[:, base : base + in_h * in_w] at (ys, xs), clamped to the edges;
    returns S + (C,) (S the shape of ys), a view of channel-major memory.
    The image's place and size are Python ints or 0-d int64 tensors on the
    device, so that a level picked on the device needs no host value."""
    def at_most(x, hi):
        return torch.minimum(x, hi) if torch.is_tensor(hi) else torch.clamp(x, max=hi)

    def as_f32(n):
        return n.to(torch.float32) if torch.is_tensor(n) else float(n)

    # CLAMP_TO_EDGE: clamp the sample position before computing the mix
    ys = at_most(torch.clamp(ys, min=0.0), as_f32(in_h - 1))
    xs = at_most(torch.clamp(xs, min=0.0), as_f32(in_w - 1))
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    fy = (ys - y0f)[None]
    fx = (xs - x0f)[None]
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    y1 = at_most(y0 + 1, in_h - 1)
    x1 = at_most(x0 + 1, in_w - 1)
    r0, r1 = base + y0 * in_w, base + y1 * in_w
    c = flat.shape[0]

    def texel(idx):
        return flat.index_select(1, idx.reshape(-1)).reshape((c,) + idx.shape)

    top = texel(r0 + x0) * (1 - fx) + texel(r0 + x1) * fx
    bot = texel(r1 + x0) * (1 - fx) + texel(r1 + x1) * fx
    return (top * (1 - fy) + bot * fy).movedim(0, -1)


def sample_bilinear(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (H, W, C) at fractional coords ys, xs (any one
    shape S, pixel units, texel centers at integers: pass ``coord - 0.5``
    yourself). Returns S + (C,). Coordinates clamp to the edges
    (CLAMP_TO_EDGE)."""
    return _sample_flat(_channel_major_flat([img]), 0, img.shape[0], img.shape[1], ys, xs)


@functools.lru_cache(maxsize=64)
def _mip_table(shapes: Tuple[Tuple[int, ...], ...], device: torch.device) -> torch.Tensor:
    """(levels, 4) int64 rows [texel offset, height, width, 2**level] of a
    mip pyramid stored as one `_channel_major_flat` tensor, on `device`;
    uploaded once per pyramid shape, without waiting."""
    from smelter_tpu_torch.interop import upload

    rows, off = [], 0
    for level, s in enumerate(shapes):
        rows.append([off, s[0], s[1], 1 << level])
        off += s[0] * s[1]
    return upload(torch.tensor(rows, dtype=torch.int64), device)


def sample_bilinear_mip(mips: list, ys: torch.Tensor, xs: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Trilinear-ish sampling: pick the mip level for ``scale`` (source
    pixels per output pixel, >= 1 means downscaling; a 0-d tensor) and
    blend the bilinear samples of the two nearest levels, lo * (1 - frac) +
    hi * frac (hi == lo at the last level). ys, xs are level-0 pixel
    coordinates.

    The reference switches on the traced level; here the level stays on the
    device too: the pyramid is concatenated into one channel-major tensor
    and each level's place and size are read from a small device table at
    the level's index, so choosing costs no host synchronisation."""
    n = len(mips)
    if n == 1:
        return sample_bilinear(mips[0], ys, xs)
    lod = torch.clamp(torch.log2(torch.clamp(scale, min=1.0)), 0.0, float(n - 1))
    lo = torch.clamp(torch.floor(lod).to(torch.int64), 0, n - 1)
    frac = lod - torch.floor(lod)
    table = _mip_table(tuple(tuple(m.shape) for m in mips), ys.device)
    flat = _channel_major_flat(mips)

    def level_sample(level):
        off, h, w, f = table.index_select(0, level.reshape(1))[0].unbind()
        f = f.to(torch.float32)
        return _sample_flat(flat, off, h, w, (ys + 0.5) / f - 0.5, (xs + 0.5) / f - 0.5)

    lo_samples = level_sample(lo)
    hi_samples = level_sample(torch.clamp(lo + 1, 0, n - 1))
    return lo_samples * (1.0 - frac) + hi_samples * frac
