"""K1: single-pass SDF scene assembly.

Replaces the Pallas TPU kernel `smelter_tpu/ops/pallas/scene_assembly.py`
(`_kernel_body`, launched at :261). One pass creates the channel-major
premultiplied (4, H, W) canvas of a canvas-opening run of colour and
box-shadow members: each pixel starts transparent and OVER-blends every
member whose clipped footprint holds it, in paint order, in f32. The one
store writes the canvas's storage dtype (`OUT_DTYPES`): f32, or 16 bits
(u16 fixed point, f16, bf16: `compose._canvas_encode`), which halves the
write. The CUDA kernel is
`smelter_tpu_torch/csrc/scene_assembly.cu` (layer math and tile classes in
`csrc/sdf_common.cuh`); it is bound by the one canvas write. Per 32 x 32
tile it drops members that are exactly 0 there, blends flat values where a
member's alpha is exactly 1, and starts a tile over under an opaque one
(`tile_class.py` is the plain mirror of that classifier).

Member kinds: "color" (rounded-rect SDF fill, optional border, optional
analytic rotation) and "box_shadow" (smoothstep blur of the SDF); each takes
up to N parent rounded-rect masks, which may rotate.

`assemble_scene_planar` launches the kernel for CUDA tensors and takes the
plain version, `assemble_scene_planar_plain`, only for CPU tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from smelter_tpu_torch.config import check_finite
from smelter_tpu_torch.interop import upload
from smelter_tpu_torch.ops.compose import _canvas_encode, rounded_rect_sdf, smoothstep
from smelter_tpu_torch.ops.hopper import build
from smelter_tpu_torch.render.capture import each_run

PARAMS_BASE = 19  # 0:top 1:left 2:w 3:h 4:rot 5..8:radius 9..12:color
#                  13:border_width 14..17:border_color 18:blur
MASK_W = 9  # radius[4], top, left, w, h, rotation_rad
SPEC_W = 9  # columns of the int32 spec table (csrc/scene_assembly.cu)
_KINDS = {"color": 0, "box_shadow": 1}
# canvas storage dtypes the kernel stores, by the code its entry takes
OUT_DTYPES = {torch.float32: 0, torch.uint16: 1, torch.float16: 2, torch.bfloat16: 3}

# kernel launches since the last reset (the main path's proof of use); a
# CUDA graph's replays count the launches captured in it
LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


@dataclass(frozen=True)
class MemberSpec:
    """Static description of one SDF member. `region`: its clipped pixel
    footprint (y0, x0, y1, x1), half-open, from the statics; the member is
    evaluated only there."""

    kind: str
    has_border: bool
    has_rotation: bool
    n_masks: int
    rotated_masks: Tuple[bool, ...]
    region: Tuple[int, int, int, int]


def spec_table(specs: Sequence[MemberSpec], device) -> torch.Tensor:
    """The (L, SPEC_W) int32 table the kernel reads its static flags from."""
    rows = []
    for s in specs:
        bits = sum(1 << i for i, r in enumerate(s.rotated_masks[: s.n_masks]) if r)
        rows.append([_KINDS[s.kind], int(s.has_border), int(s.has_rotation),
                     s.n_masks, bits, *s.region])
    return upload(torch.tensor(rows, dtype=torch.int32).reshape(-1, SPEC_W), device)


def pack_member_params(params_list, max_masks: int) -> torch.Tensor:
    """LayoutParams -> (L, PARAMS_BASE + MASK_W * max_masks) f32 rows, on the
    params' device. Mask rows beyond `max_masks` are dropped (no member reads
    them); narrower legacy 8-wide mask rows gain a zero rotation column."""
    width = PARAMS_BASE + MASK_W * max_masks
    rows = []
    for p in params_list:
        dev = p.top.device
        base = torch.cat([
            torch.stack([p.top, p.left, p.width, p.height, p.rotation_degrees]),
            p.border_radius.reshape(4),
            p.color.reshape(4),
            p.border_width.reshape(1),
            p.border_color.reshape(4),
            p.blur_radius.reshape(1),
        ]).to(torch.float32)
        masks = p.masks.to(torch.float32)
        if masks.dim() == 2 and masks.shape[0] > 0 and max_masks > 0:
            masks = masks[:max_masks]
            if masks.shape[1] < MASK_W:
                masks = torch.nn.functional.pad(masks, (0, MASK_W - masks.shape[1]))
            flat = masks[:, :MASK_W].reshape(-1)
        else:
            flat = torch.zeros((0,), dtype=torch.float32, device=dev)
        pad = torch.zeros((width - PARAMS_BASE - flat.shape[0],),
                          dtype=torch.float32, device=dev)
        rows.append(torch.cat([base, flat, pad]))
    return torch.stack(rows).contiguous()


def _member_layer(spec: MemberSpec, p: torch.Tensor, px, py) -> torch.Tensor:
    """Premultiplied (4, h, w) layer of one member over pixel centers
    (px, py); formula order as the reference kernel's `_blend_member`."""
    top, left, w, h = p[0], p[1], p[2], p[3]
    cx = left + w * 0.5
    cy = top + h * 0.5
    dx = px - cx
    dy = py - cy
    if spec.has_rotation:
        ang = p[4] * (math.pi / 180.0)
        cos_a = torch.cos(ang)
        sin_a = torch.sin(ang)
        dx, dy = cos_a * dx + sin_a * dy, -sin_a * dx + cos_a * dy

    mask_alpha = None
    for mi in range(spec.n_masks):
        o = PARAMS_BASE + mi * MASK_W
        mw, mh = p[o + 6], p[o + 7]
        mdx = px - (p[o + 5] + mw * 0.5)
        mdy = py - (p[o + 4] + mh * 0.5)
        if mi < len(spec.rotated_masks) and spec.rotated_masks[mi]:
            ca, sa = torch.cos(p[o + 8]), torch.sin(p[o + 8])
            mdx, mdy = ca * mdx + sa * mdy, -sa * mdx + ca * mdy
        d = rounded_rect_sdf(mdx, mdy, mw * 0.5, mh * 0.5, p[o : o + 4])
        a = smoothstep(-0.5, 0.5, -d)
        mask_alpha = a if mask_alpha is None else mask_alpha * a

    edge = -rounded_rect_sdf(dx, dy, w * 0.5, h * 0.5, p[5:9])
    col = torch.stack([p[9] * p[12], p[10] * p[12], p[11] * p[12], p[12]])[:, None, None]

    if spec.kind == "box_shadow":
        blur = torch.clamp(p[18], min=1.0)
        a = smoothstep(-blur * 0.5, blur * 0.5, edge)
        if mask_alpha is not None:
            a = a * mask_alpha
        return col * a[None]
    if spec.has_border:
        bwd = p[13]
        bcol = torch.stack([p[14] * p[17], p[15] * p[17], p[16] * p[17], p[17]])[:, None, None]
        border_alpha = smoothstep(bwd, bwd + 1.0, edge)
        content_alpha = smoothstep(-0.5, 0.5, edge)
        inner = bcol + (col - bcol) * border_alpha[None]
        outer = bcol * content_alpha[None]
        layer = torch.where((edge > bwd * 0.5)[None], inner, outer)
    else:
        layer = col * smoothstep(-0.5, 0.5, edge)[None]
    if mask_alpha is not None:
        layer = layer * mask_alpha[None]
    return layer


def assemble_scene_planar_plain(
    resolution: Tuple[int, int], specs: Sequence[MemberSpec], params: torch.Tensor,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of K1: each member evaluated over its clipped
    footprint and OVER-blended into a transparent f32 canvas, in paint
    order, then stored as `out_dtype` (`compose._canvas_encode`). (The
    kernel's tile classes give the same values, so this version evaluates
    everything.)"""
    w, h = resolution
    dev = params.device
    acc = torch.zeros((4, h, w), dtype=torch.float32, device=dev)
    for li, spec in enumerate(specs):
        y0, x0, y1, x1 = spec.region
        py = (torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5)[:, None]
        px = (torch.arange(x0, x1, dtype=torch.float32, device=dev) + 0.5)[None, :]
        px, py = px.expand(y1 - y0, x1 - x0), py.expand(y1 - y0, x1 - x0)
        layer = _member_layer(spec, params[li], px, py)
        under = acc[:, y0:y1, x0:x1]
        acc[:, y0:y1, x0:x1] = layer + under * (1.0 - layer[3:4])
    return _canvas_encode(acc, out_dtype)


def _launch(resolution, specs, params, spec_rows, out_dtype=torch.float32):
    w, h = resolution
    n = len(specs)
    need = PARAMS_BASE + MASK_W * max((s.n_masks for s in specs), default=0)
    if params.dtype != torch.float32 or params.dim() != 2 or params.shape[0] != n:
        raise ValueError(f"K1 takes ({n}, P) f32 params, got {tuple(params.shape)} {params.dtype}")
    if params.shape[1] < need:
        raise ValueError(f"K1 params rows are {params.shape[1]} wide, the masks need {need}")
    if spec_rows.dtype != torch.int32 or tuple(spec_rows.shape) != (n, SPEC_W):
        raise ValueError(f"K1 takes a ({n}, {SPEC_W}) int32 spec table, got "
                         f"{tuple(spec_rows.shape)} {spec_rows.dtype}")
    if spec_rows.device != params.device:
        raise ValueError("K1 spec table and params must share a device")
    if not (params.is_contiguous() and spec_rows.is_contiguous()):
        raise ValueError("K1 takes contiguous tables")
    if h <= 0 or w <= 0:
        raise ValueError(f"K1 takes a non-empty canvas, got {w}x{h}")
    out = torch.empty((4, h, w), dtype=out_dtype, device=params.device)
    with torch.cuda.device(params.device):
        stream = torch.cuda.current_stream(params.device).cuda_stream
        err = build.library().smelter_scene_assembly(
            spec_rows.data_ptr(), params.data_ptr(), out.data_ptr(),
            n, SPEC_W, params.shape[1], h, w, OUT_DTYPES[out_dtype], stream,
        )
    build.check(err, "scene_assembly launch")
    each_run(_count)
    return out


def assemble_scene_planar(
    resolution: Tuple[int, int],  # (width, height)
    specs: Sequence[MemberSpec],
    params: torch.Tensor,  # (L, PARAMS_BASE + MASK_W * max_masks) f32
    spec_rows: Optional[torch.Tensor] = None,  # spec_table(specs), if built
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Create the (4, H, W) premultiplied canvas of one run of SDF members,
    stored as `out_dtype` (`OUT_DTYPES`; the blends are f32 either way).
    Runs K1 for CUDA params (raising if it cannot) and the plain version for
    CPU params. In the debug mode, outside a frame program, a float canvas
    holding NaN or Inf raises FloatingPointError (`check_finite`)."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"K1 stores {sorted(map(str, OUT_DTYPES))}, not {out_dtype}")
    if params.device.type == "cpu":
        out = assemble_scene_planar_plain(resolution, specs, params, out_dtype)
    elif params.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA or CPU tensors, not {params.device}")
    else:
        if spec_rows is None:
            spec_rows = spec_table(specs, params.device)
        out = _launch(resolution, specs, params, spec_rows, out_dtype)
    return check_finite(out, "scene_assembly")
