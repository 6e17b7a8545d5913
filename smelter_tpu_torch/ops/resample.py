"""Separable resizing as dense per-axis GEMMs, and bilinear sampling at
coordinates that live on the device.

Port of `smelter_tpu/ops/resample.py` but `resize_lanczos3` and
`resize_matmul_u8`: the static weights and `resize_matmul`, the traced-size
`resize_matmul_traced` (weights built on the device from the size and crop
of the frame), `box_downsample_2x`, `build_mips`, `resize_bilinear`,
`sample_bilinear` and `sample_bilinear_mip`. The static
weight matrices are numpy, copied from the reference line for line so both
packages build identical matrices; a resize is two GEMMs (`gemm`).

GEMM precision is the reference's: bf16 operands, f32 accumulation, and
each product either rounded to bf16 (where the reference casts it) or kept
in f32. The weight matrices are stored as bf16 tensors. The tensor's
device picks one of two routes, and nothing else does:
  - the card (a CUDA tensor): the operands are bf16 tensors (u8 planes
    convert exactly, f32 textures round to nearest even) and each product
    is one cuBLAS GEMM on the tensor cores, accumulating in f32, written as
    bf16 (one round to nearest even of the f32 sum) or, through
    `aten::mm.dtype`, as f32. `allow_bf16_reduced_precision_reduction =
    False` keeps split-K partial sums in f32 too. A CUDA tensor takes this
    route or raises; each GEMM counts one in `LAUNCHES`;
  - plain (a CPU tensor): the same bf16 values held in f32, each product an
    f32 GEMM, rounded to bf16 values where the reference casts it.
    `allow_tf32 = False` keeps an f32 GEMM in full f32 on the card, where
    `chip_smoke.py` times this route beside the card's.
A bf16 x bf16 product is exact in f32, so the two routes differ only in
the order of the f32 sums.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from smelter_tpu_torch.render.capture import device_constant, each_run

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

# GEMMs the card route launched since the last reset (the main path's proof
# that its resizes ran in bf16); a CUDA graph's replays count the GEMMs
# captured in it
LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


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


@functools.lru_cache(maxsize=256)
def _dense_axis_weights(in_size: int, out_size: int, kind: str) -> np.ndarray:
    """Dense (out, in) resampling matrix for one axis (a separable resize is
    two small dense GEMMs; the band structure wastes zeros but the matrices
    are tiny next to the pixel data). Cached on the host, read-only: every
    program captured for a new structure makes its device copy anew
    (`device_constant`), and the Python row loop takes milliseconds at 4K."""
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
    """A host weight matrix as a bf16 tensor (rounded to nearest even) on
    `device`, uploaded without waiting (`interop.upload`)."""
    from smelter_tpu_torch.interop import upload

    return upload(torch.from_numpy(np.ascontiguousarray(w)).to(torch.bfloat16), device)


@device_constant(maxsize=256)
def axis_weights(in_size: int, out_size: int, kind: str,
                 device: torch.device) -> torch.Tensor:
    """`_dense_axis_weights` as a bf16 tensor on `device`, built once per
    (sizes, kind, device): eager frames must not rerun the Python row
    loop."""
    return device_weights(_dense_axis_weights(in_size, out_size, kind), device)


def operand(x: torch.Tensor, card: bool) -> torch.Tensor:
    """`x` as a GEMM operand of one route: on the card a contiguous bf16
    tensor (u8 exact, f32 rounded to nearest even), on the plain route the
    same values held in f32."""
    if card:
        return x.to(torch.bfloat16, memory_format=torch.contiguous_format)
    return to_bf16_values(x.to(torch.float32))


def gemm(w: torch.Tensor, x: torch.Tensor, dim: int, out_dtype: torch.dtype,
         card: bool) -> torch.Tensor:
    """One axis of a separable resize: the (out, in) weights `w` applied
    along dim -2 of `x` (the rows: (..., in, W) -> (..., out, W)) or dim -1
    (the columns: (..., h, in) -> (..., h, out)), both from `operand` of the
    same route. `out_dtype` is bf16 where the reference casts the product
    and f32 where it keeps it (only a column product, as the reference
    keeps only its second). The card writes `out_dtype`; the plain route
    writes f32, rounded to bf16 values for a bf16 product. A batch is one
    GEMM: the rows' weights broadcast over it (a batched GEMM), the columns
    fold it into their rows."""
    if not card:
        y = torch.matmul(w, x) if dim == -2 else torch.matmul(x, w.t())
        return to_bf16_values(y) if out_dtype == torch.bfloat16 else y
    if w.dtype != torch.bfloat16 or x.dtype != torch.bfloat16:
        raise TypeError(f"the card's resize GEMM takes bf16 operands, got {w.dtype} "
                        f"and {x.dtype}")
    if out_dtype != torch.bfloat16 and (dim != -1 or out_dtype != torch.float32):
        raise ValueError(f"a {out_dtype} product along dim {dim}: only a column "
                         f"product is kept in f32")
    each_run(_count)
    if out_dtype == torch.bfloat16:
        return torch.matmul(w, x) if dim == -2 else torch.matmul(x, w.t())
    y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
    return y.reshape(*x.shape[:-1], w.shape[0])


def resize_matmul(
    img: torch.Tensor, out_h: int, out_w: int, kind: str = "lanczos3"
) -> torch.Tensor:
    """Separable resize as two GEMMs. ``img``: (..., H, W) — leading batch
    dims allowed; resizes the last two axes. u8 inputs are exact in bf16;
    accumulation is f32, and each axis's result rounds to bf16 (the
    intermediate between the axes included). Returns bf16 on the card and
    bf16-valued f32 on the CPU."""
    return _resize_matmul(img, out_h, out_w, kind, img.is_cuda)


def resize_crop_cm(img: torch.Tensor, crop, out_h: int, out_w: int) -> torch.Tensor:
    """The `crop` (top, left, height, width) of an (H, W, C) image resized
    to a channel-major (C, out_h, out_w) f32 tile by `resize_matmul`."""
    ct, cl, chh, cww = crop
    patch = img[ct : ct + chh, cl : cl + cww]
    return resize_matmul(patch.permute(2, 0, 1), out_h, out_w).to(torch.float32)


def _resize_matmul(img, out_h: int, out_w: int, kind: str, card: bool) -> torch.Tensor:
    in_h, in_w = img.shape[-2], img.shape[-1]
    x = operand(img, card)
    if in_h != out_h:
        wh = operand(axis_weights(in_h, out_h, kind, img.device), card)
        # (out_h, H) x (..., H, W) -> (..., out_h, W)
        x = gemm(wh, x, -2, torch.bfloat16, card)
    if in_w != out_w:
        ww = operand(axis_weights(in_w, out_w, kind, img.device), card)
        # (..., h, W) x (W, out_w) -> (..., h, out_w)
        x = gemm(ww, x, -1, torch.bfloat16, card)
    return x


def _traced_axis_weights(in_size: int, buf: int, out_sz: torch.Tensor, c0, c_len,
                         centered: bool) -> torch.Tensor:
    """(buf, in_size) triangle-kernel weights of one axis, from the size and
    crop of this frame (0-d f32 tensors, or Python numbers for the crop),
    built in f32 on the device and rounded to bf16."""
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
    return (wgt / norm).to(torch.bfloat16)


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
    product rounded to bf16, the second kept f32 (an f32 result on both
    routes)."""
    return _resize_matmul_traced(img, buf_h, buf_w, out_h, out_w, crop, centered,
                                 img.is_cuda)


def _resize_matmul_traced(img, buf_h: int, buf_w: int, out_h, out_w, crop, centered: bool,
                          card: bool) -> torch.Tensor:
    in_h, in_w = img.shape[-2], img.shape[-1]
    if crop is None:
        ct, cl, cw, chh = 0.0, 0.0, float(in_w), float(in_h)
    else:
        ct, cl, cw, chh = crop
    wh = operand(_traced_axis_weights(in_h, buf_h, out_h, ct, chh, centered), card)
    ww = operand(_traced_axis_weights(in_w, buf_w, out_w, cl, cw, centered), card)
    x = gemm(wh, operand(img, card), -2, torch.bfloat16, card)
    return gemm(ww, x, -1, torch.float32, card)


@device_constant(maxsize=64)
def _bilinear_taps(out_size: int, in_size: int, device: torch.device):
    """(lo, hi, frac) of `resize_bilinear` along one axis, on `device`: the
    texel-centre positions in f32, clamped to the edges (CLAMP_TO_EDGE),
    their floor, the next texel and the fraction, as the reference computes
    them. Uploaded once per size, without waiting."""
    from smelter_tpu_torch.interop import upload

    pos = np.clip(_axis_positions(out_size, in_size).astype(np.float32),
                  np.float32(0.0), np.float32(in_size - 1.0))
    lo = np.floor(pos)
    frac = (pos - lo).astype(np.float32)
    lo_i = lo.astype(np.int64)
    hi_i = np.clip(lo_i + 1, 0, in_size - 1)
    return tuple(upload(torch.from_numpy(a), device) for a in (lo_i, hi_i, frac))


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C): the GPU sampler's bilinear resize,
    texel-centre aligned and clamped to the edges, as plain index and lerp
    operations in the reference's order (not `F.interpolate`, whose sample
    positions differ)."""
    y0, y1, fy = _bilinear_taps(out_h, img.shape[0], img.device)
    x0, x1, fx = _bilinear_taps(out_w, img.shape[1], img.device)
    r0, r1 = img.index_select(0, y0), img.index_select(0, y1)
    fx, gx = fx[None, :, None], (1 - fx)[None, :, None]
    top = r0.index_select(1, x0) * gx + r0.index_select(1, x1) * fx
    bot = r1.index_select(1, x0) * gx + r1.index_select(1, x1) * fx
    return top * (1 - fy)[:, None, None] + bot * fy[:, None, None]


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


@device_constant(maxsize=64)
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
