"""BT.709 colour conversion for the compose path.

Port of `smelter_tpu/ops/color_convert.py` but its 4:2:2 output
converters: u8 <-> f32, YUV <-> RGB, the chroma up- and down-sampling, the
deferred-YUV tile convert (`yuv_tile_rgba_cm`, whose resizes are the banded
pass of `ops/hopper/tile_resize.py` on the card), the full-resolution RGBA
conversion of every input format (`convert_to_rgba_f32`,
`DeferredYuvSource.mips`, `DeferredNv12Source.mips`), an NV12 input's
static tiles in one fused convert-and-resize pass (`DeferredNv12Source`,
`ops/hopper/nv12_resize.py`), and the canvas -> YUV420, NV12 and YUV444
outputs. The YUV420 output (and so NV12, its interleaved form) runs kernel
K2 (`ops/hopper/yuv_out.py`); YUV444 is elementwise, with no kernel. The
canvas outputs also take the 16-bit storage of the root canvas
(`canvas_decode`).

Everything is f32 in [0, 1]; constants and operation order follow the
reference so that the two packages agree to the u8 LSB. Internal RGBA
textures are not premultiplied here (they are opaque or straight alpha).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from smelter_tpu_torch.config import check_finite
from smelter_tpu_torch.core.types import PixelFormat
from smelter_tpu_torch.render.capture import count_each_run, device_constant
from smelter_tpu_torch.ops.resample import (
    _dense_axis_weights,
    build_mips,
    device_weights,
    gemm,
    operand,
)

# Limited-range footroom/scale: Y in [16, 235], UV in [16, 240] (8-bit).
_Y_SCALE = 219.0 / 255.0
_UV_SCALE = 224.0 / 255.0
_FOOTROOM = 16.0 / 255.0


def rgb_to_yuv_limited_u8(r: int, g: int, b: int) -> Tuple[int, int, int]:
    """BT.709 limited-range u8 YUV of a constant u8 RGB colour (an opaque
    grid's background), in Python floats, rounded half to even."""
    rf, gf, bf = r / 255.0, g / 255.0, b / 255.0
    y = 0.2126 * rf + 0.7152 * gf + 0.0722 * bf
    u = (bf - y) / 1.8556
    v = (rf - y) / 1.5748
    return (
        int(round(16.0 + 219.0 * y)),
        int(round(128.0 + 224.0 * u)),
        int(round(128.0 + 224.0 * v)),
    )


def u8_to_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) * (1.0 / 255.0)


def f32_to_u8(x: torch.Tensor) -> torch.Tensor:
    # torch.round rounds half to even, as jnp.round does
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


def _expand_range(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Limited -> full range (inverse footroom), clamped like the reference."""
    y = torch.clamp((y - _FOOTROOM) / _Y_SCALE, 0.0, 1.0)
    u = torch.clamp((u - _FOOTROOM) / _UV_SCALE, 0.0, 1.0)
    v = torch.clamp((v - _FOOTROOM) / _UV_SCALE, 0.0, 1.0)
    return y, u, v


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               full_range: bool = False) -> torch.Tensor:
    """BT.709 YUV (all planes the same shape, [0, 1]) -> RGB (H, W, 3) in
    [0, 1]."""
    if not full_range:
        y, u, v = _expand_range(y, u, v)
    u = u - 0.5
    v = v - 0.5
    r = y + 1.5748 * v
    g = y - 0.1873 * u - 0.4681 * v
    b = y + 1.8556 * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 1.0)


def _upsample_axis(plane: torch.Tensor, dim: int) -> torch.Tensor:
    """Double `plane` along `dim` (0 or 1): output index i samples the
    source at (i + 0.5) / 2 - 0.5, blending the two texels around it."""
    n = plane.shape[dim]
    pos = (torch.arange(2 * n, device=plane.device) + 0.5) / 2.0 - 0.5
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    frac = torch.clamp(pos - torch.floor(pos), 0.0, 1.0)
    if dim == 0:
        frac = frac[:, None]
    return (plane.index_select(dim, i0) * (1.0 - frac)
            + plane.index_select(dim, i1) * frac)


def upsample_chroma_bilinear(plane: torch.Tensor, sx: int, sy: int) -> torch.Tensor:
    """Upsample a chroma plane by (sy vertical, sx horizontal) as a GPU
    linear sampler reading the small texture at full-resolution normalized
    coordinates (texel-center aligned bilinear). The reference's gather
    form, rows first, so that the rounding matches."""
    out = plane
    if sy == 2:
        out = _upsample_axis(out, 0)
    if sx == 2:
        out = _upsample_axis(out, 1)
    return out


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
def tile_matrices(
    luma_hw: Tuple[int, int],
    chroma_hw: Tuple[int, int],
    crop: Tuple[int, int, int, int],
    out_h: int,
    out_w: int,
    kind: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(Wh, Ww, Wch, Wcw) of `tile_weights` on the host, in f32 before their
    rounding to bf16: the luma resize matrices, and the chroma ones composed
    with the bilinear upsample in f32, rows sliced by the luma crop.
    Read-only arrays, cached."""
    ct, cl, chh, cww = crop
    Wh = _dense_axis_weights(chh, out_h, kind)
    Ww = _dense_axis_weights(cww, out_w, kind)
    Uh = _chroma_upsample_matrix(luma_hw[0], chroma_hw[0])
    Uw = _chroma_upsample_matrix(luma_hw[1], chroma_hw[1])
    Wch = Wh @ Uh[ct : ct + chh]
    Wcw = Ww @ Uw[cl : cl + cww]
    Wch.setflags(write=False)
    Wcw.setflags(write=False)
    return Wh, Ww, Wch, Wcw


@device_constant(maxsize=256)
def tile_weights(
    luma_hw: Tuple[int, int],
    chroma_hw: Tuple[int, int],
    crop: Tuple[int, int, int, int],
    out_h: int,
    out_w: int,
    kind: str,
    device: torch.device,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Wh, Ww, Wch, Wcw) for `yuv_tile_rgba_cm` (`tile_matrices`) as bf16
    device tensors, built once per (shapes, crop, size, device); the Python
    row loops never run per frame."""
    return tuple(device_weights(m, device)
                 for m in tile_matrices(luma_hw, chroma_hw, crop, out_h, out_w, kind))


def _rs(img: torch.Tensor, wr: torch.Tensor, wc: torch.Tensor, card: bool) -> torch.Tensor:
    # rows, rounded to bf16 between the axes; columns, kept f32 (the
    # reference casts the first product only); `card`: the GEMM route
    # (`resample.gemm`), an f32 result on both
    x = gemm(operand(wr, card), operand(img, card), -2, torch.bfloat16, card)
    return gemm(operand(wc, card), x, -1, torch.float32, card)


def yuv_tile_products(
    y: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    crop: Tuple[int, int, int, int],  # (top, left, h, w) in luma pixels
    out_h: int,
    out_w: int,
    kind: str = "lanczos3",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three (out_h, out_w) f32 products of `yuv_tile_rgba_cm`: the luma
    crop and the two chroma planes resized (the chroma upsample composed
    into their weights), still on the u8 scale, before its colour tail
    (`yuv_products_rgba_cm`). Each plane's rows are summed over bf16
    weights and u8 samples in f32 and rounded to bf16, its columns summed
    over those in f32 and kept. On the card this tile alone is one launch of
    the banded pass (`ops/hopper/tile_resize.py`, which resizes a run's
    tiles together); elsewhere the plain version: each plane's two GEMMs
    (`_rs`, the plain route), which `tile_resize` counts."""
    if y.is_cuda:
        from smelter_tpu_torch.ops.hopper import tile_resize

        return tile_resize.resize_tiles([((y, u, v), crop, out_h, out_w)], kind)[0]
    from smelter_tpu_torch.ops.hopper.tile_resize import count_planes

    ct, cl, chh, cww = crop
    Wh, Ww, Wch, Wcw = tile_weights(
        tuple(y.shape), tuple(u.shape), tuple(crop), out_h, out_w, kind, y.device
    )
    count_planes(3)
    return (_rs(y[ct : ct + chh, cl : cl + cww], Wh, Ww, False),
            _rs(u, Wch, Wcw, False), _rs(v, Wch, Wcw, False))


def yuv_products_rgba_cm(yt: torch.Tensor, ut: torch.Tensor, vt: torch.Tensor,
                         full_range: bool = False) -> torch.Tensor:
    """The colour tail of `yuv_tile_rgba_cm` on its resized planes
    (`yuv_tile_products`): u8 scale, range expansion, BT.709 matrix, and an
    opaque alpha plane; channel-major (4, h, w) f32."""
    yt = yt * (1.0 / 255.0)
    ut = ut * (1.0 / 255.0)
    vt = vt * (1.0 / 255.0)
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
    return yuv_products_rgba_cm(*yuv_tile_products(y, u, v, crop, out_h, out_w, kind),
                                full_range)


class DeferredYuvSource:
    """Planar-YUV input whose RGBA conversion is deferred: static texture
    layouts crop+resize the subsampled planes directly (`tile_cm`, or its
    resized planes, `tile_products`, for the group blend); the
    layouts that need full-resolution RGBA mips (the sampled pass, traced
    sizes) call `mips`, which converts once per frame."""

    def __init__(self, y, u, v, full_range: bool = False, mip_levels: int = 1):
        self.planes = (y, u, v)
        self.full_range = full_range
        self._levels = mip_levels
        self._mips = None

    def tile_cm(self, crop, out_h: int, out_w: int) -> torch.Tensor:
        y, u, v = self.planes
        return yuv_tile_rgba_cm(
            y, u, v, crop, out_h, out_w, full_range=self.full_range
        )

    def tile_products(self, crop, out_h: int, out_w: int):
        """`tile_cm`'s three resized planes, before its colour tail
        (`yuv_tile_products`): what kernel K4 reads for a static tile."""
        return yuv_tile_products(*self.planes, crop, out_h, out_w)

    def mips(self) -> list:
        if self._mips is None:
            rgba = planar_yuv_to_rgba(*self.planes, full_range=self.full_range)
            self._mips = build_mips(rgba, self._levels)
        return self._mips


class DeferredNv12Source:
    """NV12 input (y (H, W) and the interleaved uv (H/2, W/2, 2) u8, the
    layout GPU decoders write) whose RGBA conversion is deferred: a static
    layout's tile (`tile_cm`) is made from the u8 planes by the fused
    convert-and-resize pass (`ops/hopper/nv12_resize.py`, which `compose`
    hands a run's tiles at once); the layouts that need the full-resolution
    RGBA mips (the sampled pass, traced sizes) call `mips`, which converts
    once per frame and counts the conversion and its levels beyond level 0
    (`program.general.rgba_converts`, `.mip_levels`)."""

    def __init__(self, y, uv, mip_levels: int = 1):
        self.planes = (y, uv)
        self._levels = mip_levels
        self._mips = None

    def tile_cm(self, crop, out_h: int, out_w: int) -> torch.Tensor:
        from smelter_tpu_torch.ops.hopper import nv12_resize

        return nv12_resize.resize_tiles([(self.planes, tuple(crop), out_h, out_w)])[0]

    def mips(self) -> list:
        if self._mips is None:
            self._mips = build_mips(nv12_to_rgba(*self.planes), self._levels)
            count_each_run("program.general.rgba_converts")
            count_each_run("program.general.mip_levels", len(self._mips) - 1)
        return self._mips


# ---------------------------------------------------------------------------
# Input frames -> full-resolution (H, W, 4) f32 RGBA (alpha 1 for YUV)
# ---------------------------------------------------------------------------


def planar_yuv_to_rgba(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       full_range: bool = False) -> torch.Tensor:
    """Planar YUV u8 (any subsampling; the u/v shape gives it) -> (H, W, 4)
    f32. Unlike `yuv_tile_rgba_cm`, the range expansion and the RGB clamp
    apply per pixel at full resolution, as in the reference."""
    sy = y.shape[0] // u.shape[0]
    sx = y.shape[1] // u.shape[1]
    uf = upsample_chroma_bilinear(u8_to_f32(u), sx, sy)
    vf = upsample_chroma_bilinear(u8_to_f32(v), sx, sy)
    rgb = yuv_to_rgb(u8_to_f32(y), uf, vf, full_range)
    alpha = torch.ones(rgb.shape[:2] + (1,), dtype=rgb.dtype, device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def nv12_to_rgba(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """NV12: y (H, W) u8, uv (H/2, W/2, 2) u8 -> (H, W, 4) f32 (limited range)."""
    return planar_yuv_to_rgba(y, uv[..., 0], uv[..., 1], full_range=False)


def _interleaved_422_to_rgba(data: torch.Tensor, y0: int, u: int, y1: int,
                             v: int) -> torch.Tensor:
    """(H, W/2, 4) u8 4:2:2 pairs with the channels of Y0, U, Y1, V at the
    given positions -> (H, W, 4) f32."""
    y = torch.stack([data[..., y0], data[..., y1]], dim=-1).reshape(
        data.shape[0], data.shape[1] * 2)
    return planar_yuv_to_rgba(y, data[..., u], data[..., v], full_range=False)


def interleaved_yuyv_to_rgba(data: torch.Tensor) -> torch.Tensor:
    """YUYV 4:2:2: data (H, W/2, 4) u8 = [Y0, U, Y1, V] -> (H, W, 4) f32."""
    return _interleaved_422_to_rgba(data, 0, 1, 2, 3)


def interleaved_uyvy_to_rgba(data: torch.Tensor) -> torch.Tensor:
    """UYVY 4:2:2: data (H, W/2, 4) u8 = [U, Y0, V, Y1] -> (H, W, 4) f32."""
    return _interleaved_422_to_rgba(data, 1, 0, 3, 2)


def _channels(data: torch.Tensor, order) -> torch.Tensor:
    """data[..., order] from slices: a list index would copy the index list
    to the device and wait for it."""
    return torch.stack([data[..., c] for c in order], dim=-1)


def bgra_to_rgba(data: torch.Tensor) -> torch.Tensor:
    return u8_to_f32(_channels(data, (2, 1, 0, 3)))


def argb_to_rgba(data: torch.Tensor) -> torch.Tensor:
    return u8_to_f32(_channels(data, (1, 2, 3, 0)))


def rgba_u8_to_f32(data: torch.Tensor) -> torch.Tensor:
    return u8_to_f32(data)


def convert_to_rgba_f32(format_name: str, planes) -> torch.Tensor:
    """Dispatch by pixel format name -> (H, W, 4) f32 RGBA in [0, 1]."""
    fmt = PixelFormat(format_name)
    if fmt.is_planar_yuv:
        y, u, v = planes
        return planar_yuv_to_rgba(y, u, v, full_range=fmt.is_full_range)
    if fmt == PixelFormat.NV12:
        y, uv = planes
        return nv12_to_rgba(y, uv)
    if fmt == PixelFormat.INTERLEAVED_YUYV422:
        return interleaved_yuyv_to_rgba(planes)
    if fmt == PixelFormat.INTERLEAVED_UYVY422:
        return interleaved_uyvy_to_rgba(planes)
    if fmt == PixelFormat.RGBA:
        return rgba_u8_to_f32(planes)
    if fmt == PixelFormat.BGRA:
        return bgra_to_rgba(planes)
    if fmt == PixelFormat.ARGB:
        return argb_to_rgba(planes)
    raise ValueError(f"unsupported pixel format {format_name}")


# ---------------------------------------------------------------------------
# The root planar canvas may be stored in 16 bits (`compose._canvas_dtype`,
# SMELTER_CANVAS_DTYPE); every reader decodes it to f32 first.
# ---------------------------------------------------------------------------

CANVAS_FIXED_SCALE = 8192.0
CANVAS_FIXED_OFFSET = 16384.0


def canvas_decode(x: torch.Tensor) -> torch.Tensor:
    """Canvas storage -> f32 premultiplied values (the reference's
    `canvas_decode`). A uint16 canvas is fixed point with headroom,
    value * 8192 + 16384, so it holds [-2, 6) at a step of 1/8192: resize
    ringing past [0, 1] survives until the final YUV clip, as in f32. The
    decode is exact in f32. Float canvases pass through (f16 and bf16
    widen exactly; an f32 canvas is returned as it is, with no copy)."""
    if x.dtype == torch.uint16:
        return (x.to(torch.float32) - CANVAS_FIXED_OFFSET) * (1.0 / CANVAS_FIXED_SCALE)
    return x.to(torch.float32)


def planar_rgba_to_yuv420(
    rgba_cm: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(4, H, W) RGBA canvas (f32 [0, 1], or 16-bit storage: `canvas_decode`)
    -> (y, u, v) u8 planes, 4:2:0, through kernel K2 (its plain version for
    a CPU tensor), which decodes a 16-bit canvas itself. In the debug mode,
    outside a frame program, NaN or Inf in the colour planes of a float
    canvas raises FloatingPointError, as the reference's chain of operations
    raises at its first (`config.check_finite`); alpha is never read."""
    from smelter_tpu_torch.ops.hopper import yuv_out

    check_finite(rgba_cm[:3], "planar_rgba_to_yuv420")
    return yuv_out.rgba_cm_to_yuv420(rgba_cm, full_range)


def rgba_to_planar_yuv420(
    rgba: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W, 4) RGBA f32 [0, 1] -> (y, u, v) u8 planes, 4:2:0: the same
    function as `planar_rgba_to_yuv420` on the channel-major copy (the
    reference's interleaved converter runs the same operations)."""
    return planar_rgba_to_yuv420(rgba.permute(2, 0, 1).contiguous(), full_range)


def planar_rgba_to_yuv444(
    rgba_cm: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(4, H, W) RGBA canvas (f32 [0, 1], or 16-bit storage) -> (y, u, v)
    u8 planes, 4:4:4."""
    rgba_cm = canvas_decode(rgba_cm)
    y, u, v = rgb_planes_to_yuv(rgba_cm[0], rgba_cm[1], rgba_cm[2], full_range)
    return f32_to_u8(y), f32_to_u8(u), f32_to_u8(v)


def rgba_to_planar_yuv444(
    rgba: torch.Tensor, full_range: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H, W, 4) RGBA f32 [0, 1] -> (y, u, v) u8 planes, 4:4:4."""
    y, u, v = rgb_planes_to_yuv(rgba[..., 0], rgba[..., 1], rgba[..., 2], full_range)
    return f32_to_u8(y), f32_to_u8(u), f32_to_u8(v)


def planar_rgba_to_nv12(rgba_cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(4, H, W) RGBA canvas (f32 [0, 1], or 16-bit storage) -> NV12: y (H,
    W) u8 and the interleaved uv (H/2, W/2, 2) u8, through
    `planar_rgba_to_yuv420` (K2 on the card)."""
    y, u, v = planar_rgba_to_yuv420(rgba_cm)
    return y, torch.stack([u, v], dim=-1)


def rgba_to_nv12(rgba: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W, 4) RGBA f32 [0, 1] -> NV12 (y, uv), as `planar_rgba_to_nv12`."""
    y, u, v = rgba_to_planar_yuv420(rgba)
    return y, torch.stack([u, v], dim=-1)
