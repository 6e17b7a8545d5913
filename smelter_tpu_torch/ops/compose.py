"""Layout compositing, ported from `smelter_tpu/ops/compose.py`.

The working canvas is channel-major (4, H, W) premultiplied f32. Layouts
blend in paint order with premultiplied OVER. Each layout whose rect is
planner-stable (`static_rect` set) renders region-locally:
  - colour and box-shadow layers as an analytic rounded-rect SDF over their
    footprint (rotation is a coordinate rotation);
  - texture layers as a GEMM resize of the source crop placed at an integer
    origin, with SDF edges, borders and parent masks; a stable rotation
    goes through the barrel-shear `rotate_static_cm`.
A run of such layouts that opens the canvas paints its colour and shadow
members in one pass of kernel K1 (`ops/hopper/scene_assembly.py`), which
creates the canvas; the textures then blend in coalesced union groups.

Textures whose geometry animates take the traced routes, which read the
animated numbers on the device and never wait for the host:
  - moving (position animates): a static-size tile placed at the rounded
    position (`_place_tile_traced`, index tensors on the device);
  - scaling (size or crop animates): `resize_matmul_traced` into a 64-px
    bucketed buffer, then the same placement;
  - traced rotation (angle animates, rect stable): `rotate_traced_cm`;
  - roto-zoom (size and angle animate): both.
Colour and box-shadow layouts without a static rect render over the full
canvas: a run of unmasked ones in one pass of kernel K3
(`ops/hopper/sdf_layers.py`); any other layout (masked, or a texture off
every route above) through the sampled full-canvas pass
(`render_single_layout`, bilinear mip sampling for textures).

Scalar parameters are 0-d f32 tensors, as the reference's traced scalars
are f32, so that every intermediate rounds as it does there.

Corner-radius order is [top_left, top_right, bottom_right, bottom_left].
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from smelter_tpu_torch.ops.resample import (
    resize_matmul,
    resize_matmul_traced,
    sample_bilinear,
    sample_bilinear_mip,
)
from smelter_tpu_torch.ops.rotate import (
    rotate_static_cm,
    rotate_traced_cm,
    rotated_bbox,
    traced_work_size,
)

MAX_MASKS_COUNT = 20


@dataclass(frozen=True)
class LayoutStatic:
    """Static (structure) part of one render layout; the fields are those of
    the reference's LayoutStatic, so the two convert field for field."""

    content: str  # "texture" | "color" | "box_shadow"
    source_index: int = -1  # node texture index for content == "texture"
    n_masks: int = 0
    # per-mask flag: the mask rotates with the rotated ancestor that owns it
    rotated_masks: Tuple[bool, ...] = ()
    has_rotation: bool = False
    has_border: bool = False  # border_width can be > 0
    # planner-stable integer placement rect + source crop: region-local path
    static_rect: Optional[Tuple[int, int, int, int]] = None  # top, left, h, w
    static_crop: Optional[Tuple[int, int, int, int]] = None  # top, left, h, w
    static_blur: float = 0.0  # box-shadow blur (needs static render region)
    no_radius: bool = False  # every corner radius is 0 at plan time
    static_color: Optional[Tuple[int, int, int, int]] = None
    # planner-stable rotation (degrees): barrel-shear path for textures
    static_rotation: Optional[float] = None
    traced_rotation_q: Optional[int] = None
    traced_position: bool = False
    traced_size_buf: Optional[Tuple[int, int]] = None


@dataclass
class LayoutParams:
    """Numeric parameters of one render layout: 0-d or small f32 tensors,
    all on the compose device."""

    top: torch.Tensor
    left: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    rotation_degrees: torch.Tensor
    border_radius: torch.Tensor  # (4,) [tl, tr, br, bl]
    border_width: torch.Tensor
    border_color: torch.Tensor  # (4,) straight alpha [0,1]
    color: torch.Tensor  # (4,) straight alpha (color / shadow content)
    crop: torch.Tensor  # (4,) [top, left, width, height] in source pixels
    blur_radius: torch.Tensor
    # (n_masks, 9): [radius_tl, tr, br, bl, top, left, width, height,
    # rotation_rad]; the rotation applies only to masks flagged rotated
    masks: torch.Tensor


def smoothstep(e0, e1, x):
    span = e1 - e0
    span = torch.clamp(span, min=1e-6) if torch.is_tensor(span) else max(span, 1e-6)
    t = torch.clamp((x - e0) / span, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def rounded_rect_sdf(dx, dy, half_w, half_h, radius):
    """Signed distance to a rounded rect centered at origin.

    dx, dy: offsets from the rect center, x right / y down, pixels.
    radius: (4,) corner radii [tl, tr, br, bl].
    Negative inside, positive outside.
    """
    r_top = torch.where(dx < 0.0, radius[0], radius[1])
    r_bottom = torch.where(dx < 0.0, radius[3], radius[2])
    r = torch.where(dy < 0.0, r_top, r_bottom)
    qx = torch.abs(dx) - half_w + r
    qy = torch.abs(dy) - half_h + r
    qx_pos = torch.clamp(qx, min=0.0)
    qy_pos = torch.clamp(qy, min=0.0)
    return (
        torch.clamp(torch.maximum(qx, qy), max=0.0)
        + torch.sqrt(qx_pos * qx_pos + qy_pos * qy_pos)
        - r
    )


def _premultiply(color: torch.Tensor) -> torch.Tensor:
    """(4,) straight-alpha -> (4, 1, 1) premultiplied."""
    return torch.cat([color[:3] * color[3], color[3:4]])[:, None, None]


def _mask_alpha(px, py, params: LayoutParams, n_masks: int,
                rotated: Tuple[bool, ...] = ()) -> torch.Tensor:
    alpha = torch.ones(px.shape, dtype=torch.float32, device=px.device)
    for i in range(n_masks):
        m = params.masks[i]
        radius, top, left, w, h = m[0:4], m[4], m[5], m[6], m[7]
        cx = left + w * 0.5
        cy = top + h * 0.5
        dx, dy = px - cx, py - cy
        if i < len(rotated) and rotated[i]:
            # rotate the offset into the local frame of the mask, which
            # rotates with the parent that introduced it
            ang = m[8]
            ca, sa = torch.cos(ang), torch.sin(ang)
            dx, dy = ca * dx + sa * dy, -sa * dx + ca * dy
        d = rounded_rect_sdf(dx, dy, w * 0.5, h * 0.5, radius)
        alpha = alpha * smoothstep(-0.5, 0.5, -d)
    return alpha


def _over(layer: torch.Tensor, under: torch.Tensor) -> torch.Tensor:
    """Premultiplied OVER for channel-major (4, h, w) layers."""
    return layer + under * (1.0 - layer[3:4])


def _src_mips(src) -> Sequence:
    """Full-resolution RGBA mip list of a source (a deferred planar-YUV
    source converts on first use within the frame)."""
    if hasattr(src, "mips"):
        return src.mips()
    return src if isinstance(src, (list, tuple)) else [src]


def _src_tile_cm(src, crop, out_h: int, out_w: int) -> torch.Tensor:
    """Channel-major (4, out_h, out_w) f32 tile: the source's `crop` window
    resized by GEMMs. Deferred planar-YUV sources crop and resize their
    subsampled planes directly (color_convert.yuv_tile_rgba_cm); an (H, W, 4)
    RGBA source (or a mip list, level 0 used) resizes its crop."""
    if hasattr(src, "tile_cm"):
        return src.tile_cm(crop, out_h, out_w)
    img = src[0] if isinstance(src, (list, tuple)) else src
    ct, cl, chh, cww = crop
    patch = img[ct : ct + chh, cl : cl + cww]
    return resize_matmul(patch.permute(2, 0, 1), out_h, out_w)


def render_single_layout(
    static: LayoutStatic,
    params: LayoutParams,
    sources: Sequence,
    px: torch.Tensor,  # (H, W) output pixel-center x coords
    py: torch.Tensor,  # (H, W) output pixel-center y coords
) -> torch.Tensor:
    """The layout's premultiplied RGBA contribution (4, H, W); a texture is
    sampled bilinearly from its source's mips at the pixels' positions in
    its crop."""
    w = params.width
    h = params.height
    cx = params.left + w * 0.5
    cy = params.top + h * 0.5
    dx = px - cx
    dy = py - cy
    if static.has_rotation:
        ang = params.rotation_degrees * (math.pi / 180.0)
        cos_a = torch.cos(ang)
        sin_a = torch.sin(ang)
        # rotate the offset into the rect's local (unrotated) frame
        rdx = cos_a * dx + sin_a * dy
        rdy = -sin_a * dx + cos_a * dy
        dx, dy = rdx, rdy

    mask_alpha = _mask_alpha(px, py, params, static.n_masks, static.rotated_masks)
    edge = -rounded_rect_sdf(dx, dy, w * 0.5, h * 0.5, params.border_radius)

    if static.content == "box_shadow":
        blur = torch.clamp(params.blur_radius, min=1.0)
        a = smoothstep(-blur * 0.5, blur * 0.5, edge) * mask_alpha
        return _premultiply(params.color) * a[None]

    if static.content == "color":
        content = _premultiply(params.color).expand((4,) + tuple(px.shape))
    else:  # texture
        mips = _src_mips(sources[static.source_index])
        crop_top, crop_left = params.crop[0], params.crop[1]
        crop_w, crop_h = params.crop[2], params.crop[3]
        # local rect coords in [0, w) x [0, h) -> source pixels inside crop
        u = (dx + w * 0.5) / torch.clamp(w, min=1e-6)
        v = (dy + h * 0.5) / torch.clamp(h, min=1e-6)
        sx = crop_left + u * crop_w - 0.5
        sy = crop_top + v * crop_h - 0.5
        if len(mips) > 1:
            scale = torch.maximum(crop_w / torch.clamp(w, min=1e-6),
                                  crop_h / torch.clamp(h, min=1e-6))
            content = sample_bilinear_mip(list(mips), sy, sx, scale)
        else:
            content = sample_bilinear(mips[0], sy, sx)
        # the sampled texels are (H, W, 4): made channel-major in memory, or
        # the layer's strides would pass to the canvas blended under it
        content = content.permute(2, 0, 1).contiguous()

    if not static.has_border:
        a = smoothstep(-0.5, 0.5, edge) * mask_alpha
        return content * a[None]

    bw = params.border_width
    border_color = _premultiply(params.border_color)
    if static.content == "color":
        border_alpha = smoothstep(bw, bw + 1.0, edge)
    else:
        border_alpha = smoothstep(bw - 0.5, bw + 0.5, edge)
    inner = border_color + (content - border_color) * border_alpha[None]
    content_alpha = smoothstep(-0.5, 0.5, edge)
    outer = border_color * content_alpha[None]
    out = torch.where((edge > bw * 0.5)[None], inner, outer)
    return out * mask_alpha[None]


def _layer_region(static: LayoutStatic) -> Tuple[int, int, int, int]:
    """Unclipped canvas region (top, left, h, w) a region-local layout can
    touch: its static rect, expanded to the rotated bbox for stable-rotation
    layers and by the blur pad for box shadows."""
    top, left, h, w = static.static_rect  # type: ignore[misc]
    if static.static_rotation is not None and abs(static.static_rotation) > 1e-9:
        if static.content == "texture":
            bh, bw_ = rotated_bbox(float(static.static_rotation), h, w)
        else:
            th = math.radians(float(static.static_rotation))
            bh = int(math.ceil(h * abs(math.cos(th)) + w * abs(math.sin(th)))) + 2
            bw_ = int(math.ceil(h * abs(math.sin(th)) + w * abs(math.cos(th)))) + 2
        top, left = top + (h - bh) // 2, left + (w - bw_) // 2
        h, w = bh, bw_
    if static.content == "box_shadow":
        pad = int(math.ceil(static.static_blur)) + 1
        top, left, h, w = top - pad, left - pad, h + 2 * pad, w + 2 * pad
    return top, left, h, w


def _pad_into(
    layer: torch.Tensor, otop: int, oleft: int, Y0: int, X0: int, vh: int, vw: int
) -> torch.Tensor:
    """Place a (4, h, w) layer whose absolute origin is (otop, oleft) inside
    a (4, vh, vw) zero region whose absolute origin is (Y0, X0), clipped."""
    h, w = layer.shape[1], layer.shape[2]
    y0, y1 = max(otop, Y0), min(otop + h, Y0 + vh)
    x0, x1 = max(oleft, X0), min(oleft + w, X0 + vw)
    if y0 >= y1 or x0 >= x1:
        return torch.zeros((4, vh, vw), dtype=torch.float32, device=layer.device)
    vis = layer[:, y0 - otop : y1 - otop, x0 - oleft : x1 - oleft]
    return F.pad(vis, (x0 - X0, X0 + vw - x1, y0 - Y0, Y0 + vh - y1))


def _pixel_centers(Y0: int, X0: int, vh: int, vw: int, device):
    """(px, py): absolute pixel-center coordinates of a (vh, vw) region."""
    py = (torch.arange(Y0, Y0 + vh, dtype=torch.float32, device=device) + 0.5)[:, None]
    px = (torch.arange(X0, X0 + vw, dtype=torch.float32, device=device) + 0.5)[None, :]
    return px.expand(vh, vw), py.expand(vh, vw)


def _region_layer(
    static: LayoutStatic,
    params: LayoutParams,
    sources: Sequence,
    Y0: int,
    X0: int,
    vh: int,
    vw: int,
) -> torch.Tensor:
    """Premultiplied (4, vh, vw) contribution of one region-local layout over
    the absolute canvas region [Y0, Y0+vh) x [X0, X0+vw) — a superset of the
    layout's own `_layer_region`. Outside the layout's footprint the
    contribution is exactly zero, so blending over a larger region is
    identical to blending over its own."""
    top, left, h, w = static.static_rect  # type: ignore[misc]

    if static.content == "texture" and static.static_rotation is not None:
        # stable-rotation texture: upright tile + barrel-shear rotation
        theta = float(static.static_rotation)
        tile = _prepare_rect_tile(static, params, sources)
        bh, bw_ = rotated_bbox(theta, h, w)
        rotated = rotate_static_cm(tile, theta, bh, bw_)
        oy = top + (h - bh) // 2
        ox = left + (w - bw_) // 2
        rotated = _apply_masks_region(rotated, static, params, oy, ox)
        return _pad_into(rotated, oy, ox, Y0, X0, vh, vw)

    px, py = _pixel_centers(Y0, X0, vh, vw, params.top.device)

    if static.content in ("color", "box_shadow"):
        return render_single_layout(static, params, sources, px, py)

    # non-rotated texture: region-local GEMM resize of the source crop
    rw, rh = params.width, params.height
    cx = params.left + rw * 0.5
    cy = params.top + rh * 0.5
    dx = px - cx
    dy = py - cy
    mask_alpha = _mask_alpha(px, py, params, static.n_masks, static.rotated_masks)
    edge = -rounded_rect_sdf(dx, dy, rw * 0.5, rh * 0.5, params.border_radius)

    tile = _src_tile_cm(sources[static.source_index], static.static_crop, h, w)
    content = _pad_into(tile, top, left, Y0, X0, vh, vw)

    if static.has_border:
        bw = params.border_width
        border_color = _premultiply(params.border_color)
        border_alpha = smoothstep(bw - 0.5, bw + 0.5, edge)
        inner = border_color + (content - border_color) * border_alpha[None]
        content_alpha = smoothstep(-0.5, 0.5, edge)
        outer = border_color * content_alpha[None]
        layer = torch.where((edge > bw * 0.5)[None], inner, outer)
        return layer * mask_alpha[None]
    a = smoothstep(-0.5, 0.5, edge) * mask_alpha
    return content * a[None]


def _prepare_rect_tile(
    static: LayoutStatic, params: LayoutParams, sources: Sequence
) -> torch.Tensor:
    """Resize the source crop upright and apply the edge/border SDF alpha in
    the rect's local axis-aligned frame. Returns channel-major (4, h, w)."""
    top, left, h, w = static.static_rect  # type: ignore[misc]
    tile = _src_tile_cm(sources[static.source_index], static.static_crop, h, w)
    dev = tile.device
    ly = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None] - h * 0.5
    lx = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :] - w * 0.5
    return _local_edge(tile, static, params, ly.expand(h, w), lx.expand(h, w))


def _apply_masks_region(tile, static: LayoutStatic, params: LayoutParams,
                        origin_y: int, origin_x: int):
    """Apply parent masks to a region-local (4, h, w) tile at a static
    integer origin (the masks are canvas-space rounded rects)."""
    if not static.n_masks:
        return tile
    h, w = tile.shape[1], tile.shape[2]
    px, py = _pixel_centers(origin_y, origin_x, h, w, tile.device)
    return tile * _mask_alpha(px, py, params, static.n_masks, static.rotated_masks)[None]


def _apply_masks_local(tile, static: LayoutStatic, params: LayoutParams):
    """Apply parent masks to a (4, h, w) tile whose canvas origin is the
    layout's animated (top, left), so the masks may animate too (the clip
    rect of a fill-mode Rescaler while it zooms)."""
    if not static.n_masks:
        return tile
    h, w = tile.shape[1], tile.shape[2]
    dev = tile.device
    py = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5)[:, None] + params.top
    px = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5)[None, :] + params.left
    px, py = px.expand(h, w), py.expand(h, w)
    return tile * _mask_alpha(px, py, params, static.n_masks, static.rotated_masks)[None]


def _blend_region(canvas, layer, otop: int, oleft: int) -> torch.Tensor:
    """OVER-blend a premultiplied (4, h, w) layer at a static integer
    origin, clipped, in place."""
    H, W = canvas.shape[1], canvas.shape[2]
    bh, bw_ = layer.shape[1], layer.shape[2]
    y0, y1 = max(otop, 0), min(otop + bh, H)
    x0, x1 = max(oleft, 0), min(oleft + bw_, W)
    if y0 >= y1 or x0 >= x1:
        return canvas
    vis = layer[:, y0 - otop : y1 - otop, x0 - oleft : x1 - oleft]
    canvas[:, y0:y1, x0:x1] = _over(vis, canvas[:, y0:y1, x0:x1])
    return canvas


def _traced_window(start: torch.Tensor, n: int, N: int):
    """One axis of `_place_tile_traced`: a tile of n pixels whose first
    pixel lands at `start` (int64, 0-d, on the device) on an axis of N.
    Returns (canvas indices, tile indices, valid): the canvas window of
    min(n, N) pixels that holds what of the tile lands on the canvas, the
    tile pixel over each (clamped into the tile) and whether it is one."""
    wn = min(n, N)
    s = torch.clamp(start, 0, N - wn)
    idx = s + torch.arange(wn, device=start.device)
    src = idx - start
    valid = (src >= 0) & (src < n)
    return idx, torch.clamp(src, 0, n - 1), valid


def _place_tile_traced(canvas, tile, top, left) -> torch.Tensor:
    """OVER-blend a premultiplied (4, h, w) tile at an animated position
    (0-d tensors, rounded to the pixel), clipped, in place.

    The reference takes a canvas window of the tile's size at the start
    clamped into the canvas and shifts the tile inside it (a tile larger
    than the canvas blends over the whole canvas). Here the window and the
    shift are index tensors computed on the device, the tile and the window
    are gathered with them and the window written back, so placing waits
    for no host value; the clamp keeps the indices in bounds and unique.
    Window pixels the tile misses blend a zero layer, which leaves them as
    they were."""
    H, W = canvas.shape[1], canvas.shape[2]
    h, w = tile.shape[1], tile.shape[2]
    ty = torch.clamp(torch.round(top).to(torch.int64), -h, H)
    tx = torch.clamp(torch.round(left).to(torch.int64), -w, W)
    rows, src_r, valid_r = _traced_window(ty, h, H)
    cols, src_c, valid_c = _traced_window(tx, w, W)
    shifted = tile[:, src_r[:, None], src_c[None, :]]
    shifted = torch.where(valid_r[:, None] & valid_c[None, :], shifted, 0.0)
    window = (slice(None), rows[:, None], cols[None, :])
    canvas[window] = _over(shifted, canvas[window])
    return canvas


def _local_edge(tile, static: LayoutStatic, params: LayoutParams,
                dy, dx) -> torch.Tensor:
    """Edge alpha and border of a texture tile in the rect's local frame
    (dy, dx: offsets of the tile's pixels from the rect center)."""
    rw, rh = params.width, params.height
    edge = -rounded_rect_sdf(dx, dy, rw * 0.5, rh * 0.5, params.border_radius)
    if static.has_border:
        bw = params.border_width
        border_color = _premultiply(params.border_color)
        border_alpha = smoothstep(bw - 0.5, bw + 0.5, edge)
        inner = border_color + (tile - border_color) * border_alpha[None]
        content_alpha = smoothstep(-0.5, 0.5, edge)
        outer = border_color * content_alpha[None]
        return torch.where((edge > bw * 0.5)[None], inner, outer)
    return tile * smoothstep(-0.5, 0.5, edge)[None]


def _render_rotated_rect_layout_traced(static: LayoutStatic, params: LayoutParams,
                                       sources: Sequence, canvas) -> torch.Tensor:
    """Animated angle, stable rect and crop: the upright tile turned by
    `rotate_traced_cm` inside its bounding-circle square, masked, and
    blended at the square's static origin. The static quarter-turn bucket
    keeps the animated residual in [-45, 45]."""
    top, left, h, w = static.static_rect  # type: ignore[misc]
    tile = _prepare_rect_tile(static, params, sources)
    rotated = rotate_traced_cm(tile, params.rotation_degrees,
                               static.traced_rotation_q)  # type: ignore[arg-type]
    S = traced_work_size(h, w)
    oy = top + (h - S) // 2
    ox = left + (w - S) // 2
    rotated = _apply_masks_region(rotated, static, params, oy, ox)
    return _blend_region(canvas, rotated, oy, ox)


def _render_moving_rect_layout(static: LayoutStatic, params: LayoutParams,
                               sources: Sequence, canvas) -> torch.Tensor:
    """Animated position, stable size and crop (slide transitions): the
    tile is prepared at its static size and placed at the rounded animated
    position (`_place_tile_traced`); sub-pixel motion rounds to the pixel
    while it animates."""
    tile = _prepare_rect_tile(static, params, sources)
    tile = _apply_masks_local(tile, static, params)
    return _place_tile_traced(canvas, tile, params.top, params.left)


def _render_scaling_rect_layout(static: LayoutStatic, params: LayoutParams,
                                sources: Sequence, canvas) -> torch.Tensor:
    """Animated size or crop (zoom transitions): the source's level 0
    resized to the animated size inside the 64-px bucketed buffer
    (`resize_matmul_traced`, weights built on the device from the size and
    crop), edges and border in the local frame with the animated extents
    (which also clear the buffer outside the rect), then masks and the
    animated placement."""
    bh, bw_ = static.traced_size_buf  # type: ignore[misc]
    img = _src_mips(sources[static.source_index])[0]
    tile = resize_matmul_traced(
        img.permute(2, 0, 1), bh, bw_, params.height, params.width,
        crop=(params.crop[0], params.crop[1], params.crop[2], params.crop[3]),
    )
    dev = tile.device
    dy = (torch.arange(bh, dtype=torch.float32, device=dev) + 0.5)[:, None] - params.height * 0.5
    dx = (torch.arange(bw_, dtype=torch.float32, device=dev) + 0.5)[None, :] - params.width * 0.5
    tile = _local_edge(tile, static, params, dy.expand(bh, bw_), dx.expand(bh, bw_))
    tile = _apply_masks_local(tile, static, params)
    return _place_tile_traced(canvas, tile, params.top, params.left)


def _render_rotozoom_layout(static: LayoutStatic, params: LayoutParams,
                            sources: Sequence, canvas) -> torch.Tensor:
    """Size and angle (and maybe position and crop) animating together: the
    animated resize centered in the bucketed buffer, edges in the local
    frame, `rotate_traced_cm` about the buffer center, then the
    canvas-aligned masks and the animated placement of the square."""
    bh, bw_ = static.traced_size_buf  # type: ignore[misc]
    img = _src_mips(sources[static.source_index])[0]
    tile = resize_matmul_traced(
        img.permute(2, 0, 1), bh, bw_, params.height, params.width,
        crop=(params.crop[0], params.crop[1], params.crop[2], params.crop[3]),
        centered=True,
    )
    dev = tile.device
    dy = (torch.arange(bh, dtype=torch.float32, device=dev) + 0.5)[:, None] - bh * 0.5
    dx = (torch.arange(bw_, dtype=torch.float32, device=dev) + 0.5)[None, :] - bw_ * 0.5
    tile = _local_edge(tile, static, params, dy.expand(bh, bw_), dx.expand(bh, bw_))
    rotated = rotate_traced_cm(tile, params.rotation_degrees,
                               static.traced_rotation_q)  # type: ignore[arg-type]
    S = traced_work_size(bh, bw_)
    cy = params.top + params.height * 0.5
    cx = params.left + params.width * 0.5
    if static.n_masks:
        # the masks are canvas-axis-aligned: they apply after the rotation
        my = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5)[:, None] - S * 0.5 + cy
        mx = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5)[None, :] - S * 0.5 + cx
        rotated = rotated * _mask_alpha(mx.expand(S, S), my.expand(S, S), params,
                                        static.n_masks, static.rotated_masks)[None]
    return _place_tile_traced(canvas, rotated, cy - S * 0.5, cx - S * 0.5)


def _blend_group(canvas, members, union, sources, h: int, w: int):
    """OVER-blend one coalesced group: one canvas region read, one blend
    chain, one region write. The write is an in-place slice assignment into
    the canvas, which this frame owns (the reference returns an updated
    copy, which XLA turns into the same in-place update)."""
    uy, ux, uh, uw = union
    acc = canvas[:, uy : uy + uh, ux : ux + uw]
    for st, p in members:
        acc = _over(_region_layer(st, p, sources, uy, ux, uh, uw), acc)
    if (uh, uw) == (h, w):
        return acc
    canvas[:, uy : uy + uh, ux : ux + uw] = acc
    return canvas


def _align_union(reg, h: int, w: int, sublane: int = 8):
    """Expand a group's union to (sublane, 128) boundaries. Exact: member
    contributions are evaluated over the whole union and are zero outside
    their footprint, and OVER with a zero layer is the identity. (Kept from
    the TPU tiling; whether it pays on the H100 is open, see PERF.md.)"""
    uy, ux, uh, uw = reg
    y0 = (uy // sublane) * sublane
    x0 = (ux // 128) * 128
    y1 = min(h, -(-(uy + uh) // sublane) * sublane)
    x1 = min(w, -(-(ux + uw) // 128) * 128)
    return y0, x0, y1 - y0, x1 - x0


def canvas_clipper(h: int, w: int):
    """reg (top, left, h, w) -> the part inside an (h, w) canvas, or None."""

    def clip(reg):
        top, left, hh, ww = reg
        y0, y1 = max(top, 0), min(top + hh, h)
        x0, x1 = max(left, 0), min(left + ww, w)
        if y0 >= y1 or x0 >= x1:
            return None
        return y0, x0, y1 - y0, x1 - x0

    return clip


def _assembly_members(items, i: int, j: int, clip):
    """Split the run items[i:j] into kernel K1's members and the group path's
    items: returns (specs, member_params, group_items).

    The split pulls SDF members forward past earlier group-routed members,
    which is exact only when their footprints are disjoint (premultiplied
    OVER commutes for disjoint supports, and a zero layer is the blend
    identity): an SDF member joins the kernel only if its clipped footprint
    intersects no earlier group-routed member's footprint; otherwise it stays
    in the group run at its original position."""
    from smelter_tpu_torch.ops.hopper import scene_assembly as sa

    specs, plist, group_items = [], [], []
    group_regions: list = []  # clipped footprints routed to the group path

    def _intersects(a, b):
        return (a[0] < b[0] + b[2] and b[0] < a[0] + a[2]
                and a[1] < b[1] + b[3] and b[1] < a[1] + a[3])

    for k in range(i, j):
        st, p = items[k]
        reg = clip(_layer_region(st))
        if reg is None:  # fully off-canvas: contributes nothing
            continue
        if st.content in ("color", "box_shadow") and not any(
            _intersects(reg, gr) for gr in group_regions
        ):
            y0, x0, rh, rw = reg
            specs.append(sa.MemberSpec(
                st.content, st.has_border, st.has_rotation, st.n_masks,
                st.rotated_masks, (y0, x0, y0 + rh, x0 + rw),
            ))
            plist.append(p)
        else:
            group_items.append((st, p))
            group_regions.append(reg)
    return specs, plist, group_items


def _try_scene_assembly(items, i: int, j: int, sources, h: int, w: int, clip,
                        cache: Optional[dict] = None):
    """Paint the colour/box-shadow members of a canvas-opening run of
    region-local layouts (`_assembly_members`) in one pass of kernel K1,
    which creates the canvas; return (canvas, group_items), the rest being
    left for the group path, or None when no member routes to the kernel.

    `cache`, when given, keeps the member spec table on the device between
    calls: the statics fix it. The parameters are packed anew on every
    call, since a frame program's statics do not fix them (a border or
    shadow colour may animate while the rect stays put)."""
    from smelter_tpu_torch.ops.hopper import scene_assembly as sa

    specs, plist, group_items = _assembly_members(items, i, j, clip)
    if not specs:
        return None
    params = sa.pack_member_params(plist, max(s.n_masks for s in specs))
    key = ("scene_assembly", i, j, h, w)
    spec_rows = cache.get(key) if cache is not None else None
    if spec_rows is None:
        spec_rows = sa.spec_table(specs, params.device)
        if cache is not None:
            cache[key] = spec_rows
    canvas = sa.assemble_scene_planar((w, h), specs, params, spec_rows)
    return canvas, group_items


def _assemble_local_run(canvas, run_items, sources, h: int, w: int, clip):
    """Blend a run of region-local layouts onto the canvas: coalesce into
    union groups by the traffic model ((k+3)*|union| <= 3*sum(|r_i|) — the
    union read+write plus extra per-member shading area must beat the
    per-layout region reads+writes), align the unions, and assemble one
    region update per group."""
    groups = []  # (members, union, paint_idx)
    cur = None  # (members, (uy,ux,uh,uw), area_sum, idx)
    for k, (st2, p2) in enumerate(run_items):
        r2 = clip(_layer_region(st2))
        if r2 is None:  # fully off-canvas: contributes nothing
            continue
        if cur is not None:
            members, (uy, ux, uh, uw), area_sum, idx = cur
            ny0 = min(uy, r2[0])
            nx0 = min(ux, r2[1])
            ny1 = max(uy + uh, r2[0] + r2[2])
            nx1 = max(ux + uw, r2[1] + r2[3])
            n_area = (ny1 - ny0) * (nx1 - nx0)
            if (len(members) + 3) * n_area <= 3 * (area_sum + r2[2] * r2[3]):
                members.append((st2, p2))
                cur = (
                    members,
                    (ny0, nx0, ny1 - ny0, nx1 - nx0),
                    area_sum + r2[2] * r2[3],
                    idx,
                )
                continue
            groups.append((members, (uy, ux, uh, uw), idx))
        cur = ([(st2, p2)], r2, r2[2] * r2[3], k)
    if cur is not None:
        groups.append((cur[0], cur[1], cur[3]))
    groups = [
        (members, _align_union(union, h, w), idx)
        for members, union, idx in groups
    ]
    return _assemble_groups(canvas, groups, sources, h, w)


def _assemble_groups(canvas, groups, sources, h: int, w: int):
    """Assemble a run of coalesced groups onto the canvas in paint order."""
    for members, union, _ in groups:
        canvas = _blend_group(canvas, members, union, sources, h, w)
    return canvas


def compose_layouts(
    resolution: Tuple[int, int],  # (width, height)
    statics: Sequence[LayoutStatic],
    params: Sequence[LayoutParams],
    sources: Sequence,
    background: Optional[torch.Tensor] = None,  # (H, W, 4) premultiplied f32
    planar: bool = False,
    cache: Optional[dict] = None,
    device=None,
) -> torch.Tensor:
    """Blend all layouts over a transparent canvas; returns premultiplied f32
    — channel-major (4, H, W) when `planar=True`, (H, W, 4) otherwise.
    Layout order = paint order (later on top). (The reference's
    `_compose_layouts_impl` is this function's body.)

    Consecutive region-local layouts whose footprints overlap (a tile's
    shadow + backdrop + content) coalesce into one union-region blend chain:
    one canvas region read and one write per group instead of one per
    layout — premultiplied OVER is associative, so grouping is exact.
    Routes, tried in the reference's order for each layout: moving, roto-zoom,
    scaling, the region-local run (K1 opening the canvas), traced rotation,
    a run of unmasked colour/box-shadow layouts without a static rect (one
    pass of kernel K3), and the sampled full-canvas pass for the rest.

    `cache`: a dict the caller owns that keeps on the device what the
    statics fix (K1's member spec table, K3's kinds table); pass the same
    dict only with the same statics. Parameters are never cached.
    `device`: where the canvas lives; the caller names it, or it is the
    device of the layouts' params (with no layouts and no device, raises)."""
    from smelter_tpu_torch.ops.hopper import sdf_layers

    w, h = resolution
    if device is None:
        if not params:
            raise ValueError("compose_layouts: no layouts and no device given")
        device = params[0].top.device
    canvas = None  # created by K1, from the background, or transparent
    if background is not None:
        canvas = background.permute(2, 0, 1).clone(memory_format=torch.contiguous_format)
    items = list(zip(statics, params))
    px = py = None

    def _local(st: LayoutStatic) -> bool:
        if st.traced_position or st.traced_size_buf is not None:
            return False
        if st.static_rect is None:
            return False
        if st.has_rotation:
            return st.static_rotation is not None
        return True

    def _opened(canvas):
        """The canvas, or a transparent one where nothing opened it yet."""
        if canvas is None:
            return torch.zeros((4, h, w), dtype=torch.float32, device=device)
        return canvas

    _clip = canvas_clipper(h, w)
    i = 0
    while i < len(items):
        st, p = items[i]
        texture = st.content == "texture"
        if (st.traced_position and st.static_rect is not None
                and st.static_rect[2] <= h and st.static_rect[3] <= w):
            canvas = _render_moving_rect_layout(st, p, sources, _opened(canvas))
            i += 1
            continue
        if texture and st.traced_size_buf is not None:
            route = (_render_rotozoom_layout if st.traced_rotation_q is not None
                     else _render_scaling_rect_layout)
            canvas = route(st, p, sources, _opened(canvas))
            i += 1
            continue
        if _local(st):
            run_end = i
            while run_end < len(items) and _local(items[run_end][0]):
                run_end += 1
            run_items = items[i:run_end]
            if i == 0 and background is None:
                # canvas-opening run: K1 paints the SDF members (background,
                # colour backdrops, shadows) and creates the canvas; the
                # textures then blend through the group path
                assembled = _try_scene_assembly(items, i, run_end, sources, h, w,
                                                _clip, cache)
                if assembled is not None:
                    canvas, run_items = assembled
            canvas = _assemble_local_run(_opened(canvas), run_items, sources, h, w, _clip)
            i = run_end
            continue
        canvas = _opened(canvas)
        if texture and st.static_rect is not None and st.traced_rotation_q is not None:
            canvas = _render_rotated_rect_layout_traced(st, p, sources, canvas)
            i += 1
            continue
        # a run of full-canvas unmasked colour/box-shadow layers: one K3 pass
        # (one canvas read and write for the whole run)
        j = i
        while (j < len(items) and items[j][0].static_rect is None
               and items[j][0].content in ("color", "box_shadow")
               and items[j][0].n_masks == 0):
            j += 1
        if j > i:
            kinds = tuple((s_.content, s_.has_border, s_.has_rotation)
                          for s_, _ in items[i:j])
            key = ("sdf_layers", i, j)
            table = cache.get(key) if cache is not None else None
            if table is None and canvas.device.type == "cuda":
                table = sdf_layers.kinds_table(kinds, canvas.device)
                if cache is not None:
                    cache[key] = table
            rows = sdf_layers.pack_layer_params([p_ for _, p_ in items[i:j]])
            # K3 updates a CUDA canvas in place: nothing else holds it here
            canvas = sdf_layers.compose_sdf_layers_planar(
                canvas.contiguous(), rows, kinds, table)
            i = j
            continue
        # anything else (a masked colour/box-shadow layer, a texture off the
        # routes above): the sampled full-canvas pass
        if px is None:
            px, py = _pixel_centers(0, 0, h, w, device)
        canvas = _over(render_single_layout(st, p, sources, px, py), canvas)
        i += 1
    canvas = _opened(canvas)
    return canvas if planar else canvas.permute(1, 2, 0)
