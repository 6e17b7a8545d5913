"""RenderLayout -> (LayoutStatic, LayoutParams): the planner's split, ported
from `smelter_tpu/render/program.py` (`split_layout`, `_mip_levels`).

Only the plain (`fast=False`) and planner-stable (`fast=True`) splits are
ported; the traced-geometry splits (`rot_traced`, `moving`, `scaling`) come
with the animated-geometry paths (ROADMAP Queue 1 item 6), and the frame
program and planner with the renderer (item 5). The host logic is numpy,
copied from the reference; the parameters land on `device` as tensors.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from smelter_tpu.core.types import Resolution
from smelter_tpu.scene.layout_types import (
    RenderBoxShadow,
    RenderChildNode,
    RenderColor,
    RenderLayout,
)
from smelter_tpu_torch.interop import layout_params
from smelter_tpu_torch.ops.compose import MAX_MASKS_COUNT, LayoutParams, LayoutStatic
from smelter_tpu_torch.ops.rotate import MAX_SHEAR_BANDS, rotation_band_count


def _mip_levels(res: Resolution) -> int:
    """Enough mips that the smallest level is ~32px on the short side."""
    short = max(min(res.width, res.height), 1)
    return max(1, min(5, int(math.floor(math.log2(short / 32.0))) + 1 if short >= 64 else 1))


def _rect(layout: RenderLayout) -> Tuple[int, int, int, int]:
    return (
        int(round(layout.top)),
        int(round(layout.left)),
        int(round(layout.height)),
        int(round(layout.width)),
    )


def _crop(c: RenderChildNode) -> Tuple[int, int, int, int]:
    return (
        int(round(c.crop.top)),
        int(round(c.crop.left)),
        max(int(round(c.crop.height)), 1),
        max(int(round(c.crop.width)), 1),
    )


def split_layout(
    layout: RenderLayout, fast: bool = False, device="cpu"
) -> Tuple[LayoutStatic, LayoutParams]:
    """``fast=True`` bakes the (non-animating) rect/crop into the static part
    so the compose op can use the region-local GEMM path instead of
    full-canvas sampling."""
    c = layout.content
    n_masks = len(layout.masks)
    static_rect = None
    static_crop = None
    static_blur = 0.0
    no_radius = all(r <= 1e-6 for r in layout.border_radius.as_tuple())
    static_color = None
    static_rotation = None
    rotated = abs(layout.rotation_degrees) > 1e-9
    if fast and isinstance(c, RenderColor):
        col = c.color
        static_color = (col.r, col.g, col.b, col.a)
    if fast and rotated and isinstance(c, RenderChildNode):
        # stable rotation of a texture: gather-free 3-shear path
        rect = _rect(layout)
        if (
            rect[2] > 0
            and rect[3] > 0
            and rotation_band_count(layout.rotation_degrees, rect[2], rect[3])
            <= MAX_SHEAR_BANDS
        ):
            static_rect = rect
            static_rotation = round(layout.rotation_degrees, 3)
            static_crop = _crop(c)
    if fast and rotated and isinstance(c, (RenderColor, RenderBoxShadow)):
        # stable rotation of a colour/shadow layer: the rounded-rect SDF is
        # analytic, so rotation is a coordinate rotation over the rotated bbox
        rect = _rect(layout)
        if rect[2] > 0 and rect[3] > 0:
            static_rect = rect
            static_rotation = round(layout.rotation_degrees, 3)
            if isinstance(c, RenderBoxShadow):
                static_blur = float(c.blur_radius)
    if fast and not rotated:
        rect = _rect(layout)
        if rect[2] > 0 and rect[3] > 0:
            static_rect = rect
            if isinstance(c, RenderChildNode):
                static_crop = _crop(c)
            if isinstance(c, RenderBoxShadow):
                static_blur = float(c.blur_radius)
    masks = np.zeros((max(n_masks, 1), 9), np.float32)
    for i, m in enumerate(layout.masks[:MAX_MASKS_COUNT]):
        masks[i] = [*m.radius.as_tuple(), m.top, m.left, m.width, m.height,
                    math.radians(m.rotation_degrees)]
    rotated_masks = tuple(
        abs(m.rotation_degrees) > 1e-9
        for m in layout.masks[:MAX_MASKS_COUNT]
    )

    def color_vec(col) -> np.ndarray:
        return np.asarray(col.to_float(), np.float32)

    common = dict(
        top=np.float32(layout.top),
        left=np.float32(layout.left),
        width=np.float32(layout.width),
        height=np.float32(layout.height),
        rotation_degrees=np.float32(layout.rotation_degrees),
        border_radius=np.asarray(layout.border_radius.as_tuple(), np.float32),
        masks=masks,
    )
    shared = dict(
        n_masks=min(n_masks, MAX_MASKS_COUNT),
        rotated_masks=rotated_masks,
        has_rotation=rotated,
        static_rect=static_rect,
        no_radius=no_radius,
        static_rotation=static_rotation,
    )
    if isinstance(c, RenderChildNode):
        static = LayoutStatic(
            content="texture",
            source_index=c.index,
            has_border=c.border_width > 0.0,
            static_crop=static_crop,
            **shared,
        )
        fields = dict(
            **common,
            border_width=np.float32(c.border_width),
            border_color=color_vec(c.border_color),
            color=np.zeros(4, np.float32),
            crop=np.asarray(
                [c.crop.top, c.crop.left, c.crop.width, c.crop.height], np.float32
            ),
            blur_radius=np.float32(0.0),
        )
    elif isinstance(c, RenderColor):
        static = LayoutStatic(
            content="color",
            has_border=c.border_width > 0.0,
            static_color=static_color,
            **shared,
        )
        fields = dict(
            **common,
            border_width=np.float32(c.border_width),
            border_color=color_vec(c.border_color),
            color=color_vec(c.color),
            crop=np.zeros(4, np.float32),
            blur_radius=np.float32(0.0),
        )
    elif isinstance(c, RenderBoxShadow):
        static = LayoutStatic(
            content="box_shadow",
            static_blur=static_blur,
            **shared,
        )
        fields = dict(
            **common,
            border_width=np.float32(0.0),
            border_color=np.zeros(4, np.float32),
            color=color_vec(c.color),
            crop=np.zeros(4, np.float32),
            blur_radius=np.float32(c.blur_radius),
        )
    else:
        raise ValueError(f"unknown content {type(c)}")
    return static, layout_params(fields, device)
