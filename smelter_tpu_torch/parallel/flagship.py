"""Flagship compose: N x 1080p YUV420 inputs -> one 4K YUV420 frame.

Port of the single-device builders of `smelter_tpu/parallel/flagship.py`,
the driver's north-star shape, in its two scenes:

  - `make_flagship_compose`: the Tiles grid. The scene is an opaque
    axis-aligned grid, so the compose stays in YUV: each tile is a
    separable Lanczos3 resize (two GEMMs per plane, batched over the inputs
    when the tiles are uniform), rounded to u8 and assembled by
    concatenation when the tiles partition the canvas.
  - `make_flagship_general_compose` (`general_4k`): rounded, half-bordered
    tiles with box shadows on every third and two static rotations, through
    the general compose (`ops/compose.py`: kernel K1 paints the colour and
    shadow members, the textures blend in groups) and the YUV420 output
    (kernel K2).

Every builder takes the `device` its tensors live on (the CUDA card unless
another is named; `interop.resolve_device` raises when there is no card)
and returns (fn, example_args). A builder runs its function once on the example
arguments, so that every host-built constant (resize and chroma weight
matrices, shear masks, the K1 member table) is on the device before the
first real frame. The multi-device builders are not ported yet (ROADMAP
Queue 1 item 9).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from smelter_tpu_torch.core.types import Resolution, RGBAColor
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.ops import color_convert as cc
from smelter_tpu_torch.ops.compose import compose_layouts
from smelter_tpu_torch.ops.resample import resize_matmul
from smelter_tpu_torch.render.program import split_layout
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.layout_types import RenderChildNode, RenderColor
from smelter_tpu_torch.scene.scene_state import BuildCtx, LayoutNode, build_stateful


def _tiles_layouts(n_inputs: int, in_res: Resolution, out_res: Resolution):
    """Flattened RenderLayouts for a Tiles grid of n inputs (the benchmark
    scene from the reference benchmark bin)."""
    scene = comp.Tiles(
        children=[comp.InputStream(input_id=f"in_{i}") for i in range(n_inputs)],
        background_color=RGBAColor(8, 8, 8),
    )
    return _scene_layouts(scene, n_inputs, in_res, out_res)


def _scene_layouts(scene, n_inputs: int, in_res: Resolution, out_res: Resolution):
    """Flattened RenderLayouts for an arbitrary scene over n input streams."""
    ctx = BuildCtx(
        prev_state={},
        last_render_pts=0.0,
        input_resolutions={f"in_{i}": in_res for i in range(n_inputs)},
        text_measurer=lambda t: (0.0, 0.0),
        image_store=lambda i: (0.0, 0.0),
    )
    stateful = build_stateful(scene, ctx)
    node = LayoutNode(root=stateful, size=(float(out_res.width), float(out_res.height)))
    nested = node.layouts(0.0, [in_res] * n_inputs)
    return nested.flatten([in_res] * n_inputs, out_res)


def _rgb_to_yuv_limited(color: RGBAColor) -> Tuple[int, int, int]:
    """BT.709 RGB -> limited-range YUV for a constant color."""
    r, g, b = color.r / 255.0, color.g / 255.0, color.b / 255.0
    y = 0.2126 * r + 0.7152 * g + 0.0722 * b
    u = (b - y) / 1.8556
    v = (r - y) / 1.5748
    return (
        int(round(16.0 + 219.0 * y)),
        int(round(128.0 + 224.0 * u)),
        int(round(128.0 + 224.0 * v)),
    )


def _analyze_opaque_grid(flat, out_res: Resolution):
    """If the flattened layout list is background + opaque axis-aligned child
    rects (the Tiles case), return (bg_yuv, [(index, top, left, h, w)]);
    else None."""
    bg = (0, 128, 128)
    tiles = []
    for l in flat:
        c = l.content
        if abs(l.rotation_degrees) > 1e-9 or l.masks:
            return None
        if any(r > 1e-6 for r in l.border_radius.as_tuple()):
            return None
        if isinstance(c, RenderColor):
            if c.border_width > 0:
                return None
            full_canvas = (
                l.top <= 0.5 and l.left <= 0.5
                and l.width >= out_res.width - 1 and l.height >= out_res.height - 1
            )
            if not full_canvas or tiles:
                return None  # colored rect above tiles -> general path
            if c.color.a < 255:
                return None
            bg = _rgb_to_yuv_limited(c.color)
        elif isinstance(c, RenderChildNode):
            if c.border_width > 0:
                return None
            # crop must be the full source (flatten emits full-source crop)
            top = int(round(l.top / 2.0)) * 2
            left = int(round(l.left / 2.0)) * 2
            h = int(round(l.height / 2.0)) * 2
            w = int(round(l.width / 2.0)) * 2
            if h <= 0 or w <= 0:
                return None
            if top < 0 or left < 0 or top + h > out_res.height or left + w > out_res.width:
                return None
            tiles.append((c.index, top, left, h, w))
        else:
            return None  # shadows etc. -> general path
    return bg, tiles


def make_flagship_compose(
    n_inputs: int = 16,
    in_res: Resolution = Resolution(1920, 1080),
    out_res: Resolution = Resolution(3840, 2160),
    device=None,
):
    """Returns (fn, example_args): fn(y, u, v) with stacked u8 plane batches
    (N, H, W) / (N, H/2, W/2) on `device` -> the 4K YUV420 u8 planes."""
    device = resolve_device(device)
    flat = _tiles_layouts(n_inputs, in_res, out_res)
    grid = _analyze_opaque_grid(flat, out_res)
    if grid is None:
        raise NotImplementedError(
            "a Tiles scene that is not an opaque grid needs the general RGBA "
            "compose of the frame program, not ported yet: ROADMAP Queue 1 "
            "item 5"
        )
    return _make_yuv_grid_compose(grid, n_inputs, in_res, out_res, device)


def _general_layouts(n_inputs: int, in_res: Resolution, out_res: Resolution):
    """Flattened RenderLayouts of the `general_4k` scene: N inputs in a grid
    of rounded (radius 24), half-bordered tiles, box shadows on every third,
    two statically rotated (30 deg / -15 deg)."""
    from smelter_tpu_torch.scene.components import (
        AbsolutePosition,
        BorderRadius as CompRadius,
        BoxShadow,
    )

    cols = max(int(np.ceil(np.sqrt(n_inputs))), 1)
    rows = int(np.ceil(n_inputs / cols))
    tile_w = out_res.width // cols
    tile_h = out_res.height // rows
    margin = 30
    children = []
    for i in range(n_inputs):
        r, c = divmod(i, cols)
        rot = 30.0 if i == 5 % n_inputs else (-15.0 if i == 10 % n_inputs else 0.0)
        shadow = (
            [BoxShadow(offset_x=10.0, offset_y=10.0, blur_radius=24.0,
                       color=RGBAColor(0, 0, 0, 160))]
            if i % 3 == 0 else []
        )
        children.append(comp.Rescaler(
            child=comp.InputStream(input_id=f"in_{i}"),
            border_radius=CompRadius(24.0, 24.0, 24.0, 24.0),
            border_width=4.0 if i % 2 else 0.0,
            border_color=RGBAColor(255, 255, 255, 220),
            box_shadow=shadow,
            position=AbsolutePosition(
                width=float(tile_w - 2 * margin),
                height=float(tile_h - 2 * margin),
                top=float(r * tile_h + margin),
                left=float(c * tile_w + margin),
                rotation_degrees=rot,
            ),
        ))
    scene = comp.View(children=children, background_color=RGBAColor(8, 8, 8))
    return _scene_layouts(scene, n_inputs, in_res, out_res)


def make_flagship_general_compose(
    n_inputs: int = 16,
    in_res: Resolution = Resolution(1920, 1080),
    out_res: Resolution = Resolution(3840, 2160),
    device=None,
):
    """The flagship shape through the general compose (not the opaque YUV
    grid), the `general_4k` scene (`_general_layouts`). All geometry is
    planner-stable, so every layout takes the region-local paths; the
    channel-major canvas flows straight into the YUV420 output."""
    device = resolve_device(device)
    flat = _general_layouts(n_inputs, in_res, out_res)
    statics, params = zip(*(split_layout(l, fast=True, device=device) for l in flat))
    cache: dict = {}  # this scene's K1 member table, kept on the device

    def general4k(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        # deferred sources: the texture layouts crop+resize the subsampled
        # YUV planes directly; full-resolution RGBA never exists
        sources = [
            cc.DeferredYuvSource(y[i], u[i], v[i]) for i in range(n_inputs)
        ]
        canvas = compose_layouts(
            (out_res.width, out_res.height), statics, params, sources,
            planar=True, cache=cache, device=device,
        )
        return cc.planar_rgba_to_yuv420(canvas)

    example_args = _example_args(n_inputs, in_res, device)
    general4k(*example_args)
    return general4k, example_args


def plan_grid_partition(rects, H: int, W: int):
    """If `rects` [(key, top, left, h, w)] exactly partition an HxW canvas
    (no gaps, no overlap), return them as rows (top→bottom, each row
    left→right); else None. A partition lets the canvas be assembled with
    row/column concatenation — one write — instead of one region write per
    tile."""
    rows: dict = {}
    for r in rects:
        rows.setdefault((r[1], r[3]), []).append(r)
    y = 0
    ordered = []
    for (top, h), row in sorted(rows.items()):
        if top != y or h <= 0:
            return None
        row = sorted(row, key=lambda r: r[2])
        x = 0
        for r in row:
            if r[2] != x or r[4] <= 0:
                return None
            x += r[4]
        if x != W:
            return None
        ordered.append(row)
        y += h
    if y != H:
        return None
    return ordered


def _make_yuv_grid_compose(grid, n_inputs, in_res: Resolution, out_res: Resolution,
                           device=None):
    device = resolve_device(device)
    bg, tiles = grid
    H, W = out_res.height, out_res.width
    ch, cw = H // 2, W // 2
    sizes = {(h, w) for _, _, _, h, w in tiles}
    uniform = len(sizes) == 1 and len(tiles) == n_inputs
    partition = plan_grid_partition(tiles, H, W)

    def fn(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        if uniform:
            _, _, _, th, tw = tiles[0]
            bty = _round_u8(resize_matmul(y, th, tw))          # (N, th, tw)
            btu = _round_u8(resize_matmul(u, th // 2, tw // 2))
            btv = _round_u8(resize_matmul(v, th // 2, tw // 2))
            tile_of = lambda idx, h, w: (bty[idx], btu[idx], btv[idx])
        else:
            def tile_of(idx, h, w):
                return (
                    _round_u8(resize_matmul(y[idx], h, w)),
                    _round_u8(resize_matmul(u[idx], h // 2, w // 2)),
                    _round_u8(resize_matmul(v[idx], h // 2, w // 2)),
                )
        if partition is not None:
            # tiles cover the canvas: assemble with concatenation
            rows_y, rows_u, rows_v = [], [], []
            for row in partition:
                ry, ru, rv = zip(*(tile_of(idx, h, w) for idx, _, _, h, w in row))
                rows_y.append(torch.cat(ry, dim=1))
                rows_u.append(torch.cat(ru, dim=1))
                rows_v.append(torch.cat(rv, dim=1))
            return torch.cat(rows_y), torch.cat(rows_u), torch.cat(rows_v)
        canvas_y = torch.full((H, W), bg[0], dtype=torch.uint8, device=y.device)
        canvas_u = torch.full((ch, cw), bg[1], dtype=torch.uint8, device=y.device)
        canvas_v = torch.full((ch, cw), bg[2], dtype=torch.uint8, device=y.device)
        for idx, top, left, h, w in tiles:
            ty, tu, tv = tile_of(idx, h, w)
            canvas_y[top : top + h, left : left + w] = ty
            canvas_u[top // 2 : (top + h) // 2, left // 2 : (left + w) // 2] = tu
            canvas_v[top // 2 : (top + h) // 2, left // 2 : (left + w) // 2] = tv
        return canvas_y, canvas_u, canvas_v

    example_args = _example_args(n_inputs, in_res, device)
    fn(*example_args)
    return fn, example_args


def _round_u8(x: torch.Tensor) -> torch.Tensor:
    # +0.5 then truncate (the reference's rounding here, not half-to-even)
    return torch.clamp(x.to(torch.float32) + 0.5, 0.0, 255.0).to(torch.uint8)


def _example_args(n_inputs: int, in_res: Resolution, device=None):
    device = resolve_device(device)
    h, w = in_res.height, in_res.width
    return (
        torch.zeros((n_inputs, h, w), dtype=torch.uint8, device=device),
        torch.full((n_inputs, h // 2, w // 2), 128, dtype=torch.uint8, device=device),
        torch.full((n_inputs, h // 2, w // 2), 128, dtype=torch.uint8, device=device),
    )
