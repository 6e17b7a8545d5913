"""Frame program: the per-output render of one scene structure, ported from
`smelter_tpu/render/program.py`.

Each frame, `OutputProgram.plan` walks the node tree on the host: it
evaluates the scene's layouts at `pts`, decides per layout whether its
geometry is stable since the previous frame (the planner), splits each
layout into its static part (`LayoutStatic`, part of the structure key) and
its numbers, and packs every number into one f32 vector and every host
input plane into one u8 buffer. `render` uploads the two buffers (pinned
memory, non-blocking, one copy each) and runs the program built for the
structure key: the layouts' parameters are views into the uploaded vector,
the inputs views into the uploaded buffer, and the compose runs eagerly
(`ops/compose.py`, kernels K1, K2 and K3 on a CUDA device).

A "build" compiles nothing: it is a closure over the structure's statics
plus a per-structure device cache of what the statics fix (K1's member spec
table, K3's kinds table; never parameters). Scene transitions change only
numbers, and the structure only where the planner moves a layout between
the stable (region-local) and animating (traced or full-canvas) routes.

Ported: InputStream nodes in every input format (planar YUV as deferred
YUV sources, the others converted to a full-resolution RGBA mip pyramid),
also as the scene's root; layout nodes (View, Tiles, Rescaler) with every
animated-geometry route; the YUV grid program; RGBA and PLANAR_YUV420
outputs. Shader, text, image and web nodes (ROADMAP Queue 1 item 7) and
other output formats (item 1) raise NotImplementedError.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from smelter_tpu_torch.core.types import Frame, PixelFormat, Resolution
from smelter_tpu_torch.interop import layout_params, resolve_device, upload
from smelter_tpu_torch.ops import color_convert as cc
from smelter_tpu_torch.ops.compose import (
    MAX_MASKS_COUNT,
    LayoutParams,
    LayoutStatic,
    compose_layouts,
)
from smelter_tpu_torch.ops.resample import build_mips, resize_matmul
from smelter_tpu_torch.ops.rotate import MAX_SHEAR_BANDS, rotation_band_count
from smelter_tpu_torch.scene.layout_types import (
    Mask,
    RenderBoxShadow,
    RenderChildNode,
    RenderColor,
    RenderLayout,
)
from smelter_tpu_torch.scene.scene_state import InputStreamNode, LayoutNode, Node
from smelter_tpu_torch.utils import tracing

UNPORTED_NODES = (
    "shader, text, image and web nodes are not ported yet: ROADMAP Queue 1 item 7"
)
SUPPORTED_OUTPUTS = (PixelFormat.RGBA, PixelFormat.PLANAR_YUV420)


def _mip_levels(res: Resolution) -> int:
    """Enough mips that the smallest level is ~32px on the short side."""
    short = max(min(res.width, res.height), 1)
    return max(1, min(5, int(math.floor(math.log2(short / 32.0))) + 1 if short >= 64 else 1))


# ---------------------------------------------------------------------------
# RenderLayout -> (static, params)
# ---------------------------------------------------------------------------


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


def split_layout_host(
    layout: RenderLayout, fast: bool = False, rot_traced: bool = False,
    moving: bool = False, scaling: bool = False,
) -> Tuple[LayoutStatic, LayoutParams]:
    """The planner's split: (static, params) with the params' fields numpy
    values, as the reference's `split_layout` returns them.

    ``fast=True`` bakes the (non-animating) rect/crop into the static part
    so the compose can use the region-local paths instead of full-canvas
    passes. ``rot_traced``, ``moving`` and ``scaling`` mark a texture whose
    angle, position, or size animates; they set the traced-geometry fields
    (`traced_rotation_q`, `traced_position`, `traced_size_buf`) that route
    it to the animated texture paths (not ported yet)."""
    c = layout.content
    n_masks = len(layout.masks)
    static_rect = None
    static_crop = None
    static_blur = 0.0
    no_radius = all(r <= 1e-6 for r in layout.border_radius.as_tuple())
    static_color = None
    static_rotation = None
    traced_q = None
    traced_position = False
    traced_size_buf = None
    rotated = abs(layout.rotation_degrees) > 1e-9
    if scaling and not fast and isinstance(c, RenderChildNode):
        # size/crop (and possibly position/rotation) animating: a 64px-bucketed
        # traced-size buffer, plus the traced rotation's quarter turn
        bh = max(64, int(math.ceil(max(layout.height, 1.0) / 64.0)) * 64)
        bw = max(64, int(math.ceil(max(layout.width, 1.0) / 64.0)) * 64)
        traced_size_buf = (bh, bw)
        if rotated:
            traced_q = int(round((layout.rotation_degrees % 360.0) / 90.0))
    if moving and not fast and not rotated and isinstance(c, RenderChildNode):
        # position animating, size/crop stable: static-size tile, traced place
        h_i, w_i = int(round(layout.height)), int(round(layout.width))
        if h_i > 0 and w_i > 0:
            static_rect = (0, 0, h_i, w_i)
            traced_position = True
            static_crop = _crop(c)
    if rot_traced and not fast and isinstance(c, RenderChildNode):
        # rect/crop stable, the angle animates: quarter-turn bucket + residual
        rect = _rect(layout)
        if rect[2] > 0 and rect[3] > 0:
            static_rect = rect
            traced_q = int(round((layout.rotation_degrees % 360.0) / 90.0))
            static_crop = _crop(c)
    if fast and isinstance(c, RenderColor):
        col = c.color
        static_color = (col.r, col.g, col.b, col.a)
    if fast and rotated and isinstance(c, RenderChildNode):
        # stable rotation of a texture: the barrel-shear path, as long as the
        # banded shear stays reasonably sized
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
            traced_rotation_q=traced_q,
            traced_position=traced_position,
            traced_size_buf=traced_size_buf,
            **shared,
        )
        params = LayoutParams(
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
        params = LayoutParams(
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
        params = LayoutParams(
            **common,
            border_width=np.float32(0.0),
            border_color=np.zeros(4, np.float32),
            color=color_vec(c.color),
            crop=np.zeros(4, np.float32),
            blur_radius=np.float32(c.blur_radius),
        )
    else:
        raise ValueError(f"unknown content {type(c)}")
    return static, params


def split_layout(
    layout: RenderLayout, fast: bool = False, rot_traced: bool = False,
    moving: bool = False, scaling: bool = False, device=None,
) -> Tuple[LayoutStatic, LayoutParams]:
    """`split_layout_host` with the params as f32 tensors on `device` (the
    CUDA card unless another is named: `interop.resolve_device`)."""
    static, params = split_layout_host(layout, fast, rot_traced, moving, scaling)
    return static, layout_params(params, resolve_device(device))


# ---------------------------------------------------------------------------
# layout-tree collapse (plan time)
# ---------------------------------------------------------------------------
#
# A layout entry that places a child LayoutNode's canvas as a pure translation
# (1:1 scale, no rotation/radius/border/crop) is replaced by the child's own
# flattened layouts, offset into the parent frame. Premultiplied OVER is
# associative, so interleaving is exact; the child canvas is never made.
# (Nested View/Tiles/Rescaler components already share one layout node; a
# child layout node appears under a shader or web node.)

_COLLAPSE_EPS = 0.51


def _entry_within_bounds(e: RenderLayout, res: Resolution) -> bool:
    """True if the entry's painted footprint stays inside the child canvas,
    so skipping the canvas clip is invisible."""
    margin = 0.5
    if isinstance(e.content, RenderBoxShadow):
        margin += float(e.content.blur_radius)
    t, l, h, w = e.top, e.left, e.height, e.width
    if abs(e.rotation_degrees) > 1e-9:
        ang = math.radians(e.rotation_degrees)
        cx, cy = l + w * 0.5, t + h * 0.5
        bw = abs(math.cos(ang)) * w + abs(math.sin(ang)) * h
        bh = abs(math.sin(ang)) * w + abs(math.cos(ang)) * h
        t, l, h, w = cy - bh * 0.5, cx - bw * 0.5, bh, bw
    return (
        t >= -margin - _COLLAPSE_EPS
        and l >= -margin - _COLLAPSE_EPS
        and t + h <= res.height + margin + _COLLAPSE_EPS
        and l + w <= res.width + margin + _COLLAPSE_EPS
    )


def _collapsible(
    layout: RenderLayout,
    child_res: Optional[Resolution],
    inner: List[Tuple[RenderLayout, Optional[int]]],
) -> bool:
    c = layout.content
    if child_res is None or not isinstance(c, RenderChildNode):
        return False
    if abs(layout.rotation_degrees) > 1e-9 or c.border_width > 0.0:
        return False
    if any(r > 1e-6 for r in layout.border_radius.as_tuple()):
        return False
    if (
        abs(layout.width - child_res.width) > _COLLAPSE_EPS
        or abs(layout.height - child_res.height) > _COLLAPSE_EPS
    ):
        return False
    cr = c.crop
    if (
        abs(cr.top) > _COLLAPSE_EPS
        or abs(cr.left) > _COLLAPSE_EPS
        or abs(cr.width - child_res.width) > _COLLAPSE_EPS
        or abs(cr.height - child_res.height) > _COLLAPSE_EPS
    ):
        return False
    for e, _src in inner:
        if len(e.masks) + len(layout.masks) > MAX_MASKS_COUNT:
            return False
        if not _entry_within_bounds(e, child_res):
            return False
    return True


def _offset_entries(
    inner: List[Tuple[RenderLayout, Optional[int]]], layout: RenderLayout
) -> List[Tuple[RenderLayout, Optional[int]]]:
    dt, dl = layout.top, layout.left
    out = []
    for e, src in inner:
        masks = tuple(
            Mask(m.radius, m.top + dt, m.left + dl, m.width, m.height,
                 m.rotation_degrees)
            for m in e.masks
        ) + tuple(layout.masks)
        out.append((replace(e, top=e.top + dt, left=e.left + dl, masks=masks), src))
    return out


# ---------------------------------------------------------------------------
# per-frame packing
# ---------------------------------------------------------------------------


@dataclass
class FramePlan:
    """Per-frame host values of one output render. Everything numeric
    crosses to the device in two buffers: one u8 buffer of every host input
    plane and one f32 vector of every layout parameter plus the time, so a
    frame costs one copy each instead of one per plane or scalar."""

    # every packable input plane, ravelled + concatenated (sorted by input
    # id); in pinned memory when the program's device is a CUDA card
    frame_buf: torch.Tensor
    # inputs that arrived as tensors (or non-u8) pass through untouched
    raw_planes: Dict[str, object]
    # every LayoutParams field flattened (sorted by node id) + [time] tail
    packed_params: np.ndarray


def _is_packable(data) -> bool:
    planes = data if isinstance(data, (tuple, list)) else (data,)
    return all(
        isinstance(p, np.ndarray) and p.dtype == np.uint8 for p in planes
    )


class _InputAccess:
    """Static unpacking plan mapping input ids to slices of the frame
    buffer (shapes captured from the example frames; the structure key pins
    format+resolution, so shapes are stable per program)."""

    def __init__(self, used_frames: Dict[str, Frame]) -> None:
        self.specs: Dict[str, tuple] = {}
        off = 0
        for iid in sorted(used_frames):
            data = used_frames[iid].data
            if _is_packable(data):
                is_tuple = isinstance(data, (tuple, list))
                planes = data if is_tuple else (data,)
                shapes = [tuple(p.shape) for p in planes]
                self.specs[iid] = ("buf", off, shapes, is_tuple)
                off += sum(int(np.prod(s)) for s in shapes)
            else:
                self.specs[iid] = ("raw",)
        self.total = off

    def get(self, iid: str, frame_buf, raw_planes):
        spec = self.specs[iid]
        if spec[0] == "raw":
            return raw_planes[iid]
        _, off, shapes, is_tuple = spec
        planes = []
        for s in shapes:
            n = int(np.prod(s))
            planes.append(frame_buf[off : off + n].reshape(s))
            off += n
        return tuple(planes) if is_tuple else planes[0]


def _pack_frame_buf(used_frames: Dict[str, Frame], pin: bool = False
                    ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """Concatenate the packable planes straight into one u8 tensor (pinned
    host memory with `pin`, so the upload is one non-blocking copy)."""
    parts: List[np.ndarray] = []
    raw: Dict[str, object] = {}
    for iid in sorted(used_frames):
        data = used_frames[iid].data
        if _is_packable(data):
            planes = data if isinstance(data, (tuple, list)) else (data,)
            parts.extend(p.reshape(-1) for p in planes)
        else:
            raw[iid] = data
    n = sum(p.size for p in parts)
    buf = torch.empty((max(n, 1),), dtype=torch.uint8, pin_memory=pin)
    if parts:
        np.concatenate(parts, out=buf.numpy())
    else:
        buf.zero_()
    return buf, raw


_P_FIXED = 23  # [top,left,w,h,rot, radius*4, bw, bcolor*4, color*4, crop*4, blur]


def _pack_layout_params(
    layout_params: Dict[int, List[LayoutParams]], time: float
) -> np.ndarray:
    chunks: List[np.ndarray] = []
    for nid in sorted(layout_params):
        for p in layout_params[nid]:
            chunks.append(
                np.asarray(
                    [p.top, p.left, p.width, p.height, p.rotation_degrees],
                    np.float32,
                )
            )
            chunks.append(np.asarray(p.border_radius, np.float32))
            chunks.append(np.asarray([p.border_width], np.float32))
            chunks.append(np.asarray(p.border_color, np.float32))
            chunks.append(np.asarray(p.color, np.float32))
            chunks.append(np.asarray(p.crop, np.float32))
            chunks.append(np.asarray([p.blur_radius], np.float32))
            chunks.append(np.asarray(p.masks, np.float32).reshape(-1))
    chunks.append(np.asarray([time], np.float32))
    return np.concatenate(chunks)


def _unpack_layout_params(
    vec: torch.Tensor, static_statics: Dict[int, Tuple[LayoutStatic, ...]]
) -> Dict[int, List[LayoutParams]]:
    """LayoutParams whose fields are views into the packed vector (no device
    work: slicing a tensor makes views)."""
    out: Dict[int, List[LayoutParams]] = {}
    off = 0
    for nid in sorted(static_statics):
        lst = []
        for st in static_statics[nid]:
            rows = max(st.n_masks, 1)
            f = vec[off : off + _P_FIXED]
            off += _P_FIXED
            masks = vec[off : off + rows * 9].view(rows, 9)
            off += rows * 9
            lst.append(
                LayoutParams(
                    top=f[0], left=f[1], width=f[2], height=f[3],
                    rotation_degrees=f[4], border_radius=f[5:9],
                    border_width=f[9], border_color=f[10:14], color=f[14:18],
                    crop=f[18:22], blur_radius=f[22], masks=masks,
                )
            )
        out[nid] = lst
    return out


def _to_device(planes, device: torch.device):
    """A raw input (a tensor, or a tuple of planes) on `device`."""
    if isinstance(planes, (tuple, list)):
        return tuple(_to_device(p, device) for p in planes)
    return torch.as_tensor(planes).to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# the program of one output
# ---------------------------------------------------------------------------


class OutputProgram:
    """Plans one output's node tree each frame and keeps the programs built
    for its structures, on one device (the CUDA card unless another is
    named: `interop.resolve_device`)."""

    # long-running servers see many distinct stable geometries; bound the
    # program cache (evict oldest) so memory stays flat
    MAX_CACHED_PROGRAMS = 32

    def __init__(self, root: Node, resolution: Resolution,
                 out_format: PixelFormat, device=None) -> None:
        self.root = root
        self.resolution = resolution
        self.out_format = out_format
        self.device = resolve_device(device)
        self._node_ids: Dict[int, int] = {}
        self._nodes: Dict[int, Node] = {}
        self._next_id = 0
        self._assign_ids(root)
        self._build_cache: Dict[tuple, Callable] = {}
        # (node_id, layout_index) -> last rect signature; used to detect
        # animating layouts (transitions) and route them to the general path
        self._rect_history: Dict[tuple, tuple] = {}

    def _assign_ids(self, node: Node) -> None:
        self._node_ids[id(node)] = self._next_id
        self._nodes[self._next_id] = node
        self._next_id += 1
        for child in node.children:
            self._assign_ids(child)

    def node_id(self, node: Node) -> int:
        return self._node_ids[id(node)]

    # -- per-frame host planning ----------------------------------------------

    def plan(self, pts: float, input_frames: Dict[str, Frame]
             ) -> Tuple[tuple, FramePlan]:
        """Walk the node tree at ``pts``: compute flattened layout params and
        build the static structure key."""
        layout_params: Dict[int, List[LayoutParams]] = {}
        # per layout nid: merged (RenderLayout, source nid) entries, in that
        # node's canvas coords — consumed by the node's parent for collapse
        collapsed_entries: Dict[int, List[Tuple[RenderLayout, Optional[int]]]] = {}
        used_frames: Dict[str, Frame] = {}
        key_parts: List[object] = [self.resolution, self.out_format]

        def visit(node: Node) -> Optional[Resolution]:
            nid = self.node_id(node)
            p = node.params
            if isinstance(p, InputStreamNode):
                frame = input_frames.get(p.input_id)
                if frame is None:
                    key_parts.append((nid, "input", None))
                    return None
                key_parts.append(
                    (nid, "input", p.input_id, frame.format, frame.resolution,
                     _is_packable(frame.data))
                )
                used_frames[p.input_id] = frame
                return frame.resolution
            if not isinstance(p, LayoutNode):
                raise NotImplementedError(f"{type(p).__name__}: {UNPORTED_NODES}")
            child_res = [visit(ch) for ch in node.children]
            nested = p.layouts(pts, child_res)
            res = p.resolution(pts)
            if self.node_id(self.root) == nid:
                res = self.resolution
            flat = nested.flatten(child_res, res)
            # collapse: splice trivially-placed child LayoutNodes inline
            merged: List[Tuple[RenderLayout, Optional[int]]] = []
            for layout in flat:
                c = layout.content
                if isinstance(c, RenderChildNode):
                    ch_nid = self.node_id(node.children[c.index])
                    inner = collapsed_entries.get(ch_nid)
                    if inner is not None and _collapsible(
                        layout, child_res[c.index], inner
                    ):
                        merged.extend(_offset_entries(inner, layout))
                        continue
                    merged.append((layout, ch_nid))
                else:
                    merged.append((layout, None))
            collapsed_entries[nid] = merged
            source_ids: List[int] = []
            statics = []
            params = []
            for i, (layout, src_nid) in enumerate(merged):
                sig_key = (nid, i)
                c = layout.content
                crop_sig = ()
                if hasattr(c, "crop"):
                    crop_sig = (
                        round(c.crop.top, 2), round(c.crop.left, 2),
                        round(c.crop.width, 2), round(c.crop.height, 2),
                    )
                color_sig = ()
                if isinstance(c, RenderColor):
                    col = c.color
                    color_sig = (col.r, col.g, col.b, col.a)
                sig = (
                    round(layout.top, 2), round(layout.left, 2),
                    round(layout.width, 2), round(layout.height, 2),
                    round(layout.rotation_degrees, 3), crop_sig, color_sig,
                    tuple(round(r, 2) for r in layout.border_radius.as_tuple()),
                )
                prev = self._rect_history.get(sig_key)
                # fast on first sight or when stable; general while moving;
                # rect-stable + angle-moving → traced-rotation fast path
                fast = prev is None or prev == sig
                rot_traced = (
                    not fast
                    and prev is not None
                    and prev[:4] == sig[:4]
                    and prev[5:] == sig[5:]
                )
                # position moving, everything else (incl. size) stable
                moving = (
                    not fast
                    and not rot_traced
                    and prev is not None
                    and prev[2:4] == sig[2:4]
                    and prev[4:] == sig[4:]
                )
                # size/crop/position/rotation animating in any mix;
                # color/radius stable (zoom + roto-zoom transitions)
                scaling = (
                    not fast
                    and not rot_traced
                    and not moving
                    and prev is not None
                    and prev[6:] == sig[6:]
                )
                self._rect_history[sig_key] = sig
                st, pp = split_layout_host(
                    layout, fast=fast, rot_traced=rot_traced, moving=moving,
                    scaling=scaling,
                )
                if isinstance(c, RenderChildNode):
                    if src_nid not in source_ids:
                        source_ids.append(src_nid)  # type: ignore[arg-type]
                    st = replace(st, source_index=source_ids.index(src_nid))
                statics.append(st)
                params.append(pp)
            layout_params[nid] = params
            key_parts.append(
                (nid, "layout", tuple(statics), res, tuple(child_res),
                 tuple(source_ids))
            )
            return res

        visit(self.root)
        frame_buf, raw_planes = _pack_frame_buf(
            used_frames, pin=self.device.type == "cuda")
        plan = FramePlan(
            frame_buf=frame_buf,
            raw_planes=raw_planes,
            packed_params=_pack_layout_params(layout_params, pts),
        )
        return tuple(key_parts), plan

    # -- build + run ------------------------------------------------------------

    def render(self, pts: float, input_frames: Dict[str, Frame]):
        """Render one frame: plan, upload the two buffers, run the program of
        the frame's structure (built on first sight, on the host). Returns
        the output planes on the device, without waiting for it."""
        with tracing.span("render.plan"):
            key, plan = self.plan(pts, input_frames)
        fn = self._build_cache.get(key)
        if fn is None:
            fn = self._build(key, input_frames)
            self._store_program(key, fn)
        dev = self.device
        packed = torch.from_numpy(plan.packed_params)
        return fn(
            upload(plan.frame_buf, dev),
            {iid: _to_device(p, dev) for iid, p in plan.raw_planes.items()},
            upload(packed, dev),
        )

    def _store_program(self, key: tuple, fn) -> None:
        if len(self._build_cache) >= self.MAX_CACHED_PROGRAMS:
            oldest = next(iter(self._build_cache))
            del self._build_cache[oldest]
        self._build_cache[key] = fn

    def _build(self, key: tuple, input_frames) -> Callable:
        """Build the render function of the current structure."""
        with tracing.span("render.build_program"):
            return self._build_inner(key, input_frames)

    def _build_inner(self, key: tuple, input_frames) -> Callable:
        root = self.root
        out_format = self.out_format
        resolution = self.resolution
        device = self.device
        node_id = self.node_id
        if out_format not in SUPPORTED_OUTPUTS:
            raise NotImplementedError(
                f"output format {out_format.value} is not ported yet: "
                "ROADMAP Queue 1 item 1")
        input_formats = {
            iid: (f.format, f.resolution) for iid, f in input_frames.items()
        }
        used = {}
        for part in key:
            if (
                isinstance(part, tuple)
                and len(part) >= 3
                and part[1] == "input"
                and part[2] is not None
                and part[2] in input_frames
            ):
                used[part[2]] = input_frames[part[2]]
        access = _InputAccess(used)
        static_statics: Dict[int, Tuple[LayoutStatic, ...]] = {}
        layout_sources: Dict[int, Tuple[int, ...]] = {}
        # statics are re-derived from the structure key captured at plan time
        for part in key:
            if isinstance(part, tuple) and len(part) >= 3 and part[1] == "layout":
                static_statics[part[0]] = part[2]
                layout_sources[part[0]] = part[5] if len(part) > 5 else ()

        root_nid = node_id(root)
        nodes = self._nodes

        # an opaque axis-aligned grid of YUV inputs → the YUV-domain program
        # (no RGBA round trip; the flagship grid's method), reached through
        # Rescaler wrappers thanks to the layout collapse
        grid = _try_yuv_grid_program(
            static_statics.get(root_nid, ()),
            [nodes[s] for s in layout_sources.get(root_nid, ())],
            resolution, out_format, input_formats, access,
        )
        if grid is not None:
            return grid

        # what the statics fix, on the device, per layout node
        caches: Dict[int, dict] = {nid: {} for nid in static_statics}
        dummy = torch.zeros((2, 2, 4), dtype=torch.float32, device=device)
        # a YUV-bound root layout canvas stays channel-major end to end
        root_planar = (isinstance(root.params, LayoutNode)
                       and out_format != PixelFormat.RGBA)

        def run(frame_buf, raw_planes, packed_params):
            layout_params = _unpack_layout_params(packed_params, static_statics)
            node_memo: Dict[int, object] = {}
            input_memo: Dict[str, object] = {}

            def eval_node(node: Node):
                nid = node_id(node)
                if nid not in node_memo:
                    node_memo[nid] = _eval(node, nid)
                return node_memo[nid]

            def _eval(node: Node, nid: int):
                """A DeferredYuvSource, a mip list, or the root's [canvas]."""
                p = node.params
                is_root = nid == root_nid
                if isinstance(p, InputStreamNode):
                    if p.input_id not in access.specs:
                        return None
                    if p.input_id not in input_memo:
                        fmt, res = input_formats[p.input_id]
                        planes = access.get(p.input_id, frame_buf, raw_planes)
                        if fmt.is_planar_yuv:
                            # static layouts crop+resize the subsampled planes;
                            # the traced and sampled routes call .mips()
                            input_memo[p.input_id] = cc.DeferredYuvSource(
                                *planes, full_range=fmt.is_full_range,
                                mip_levels=_mip_levels(res))
                        else:
                            rgba = cc.convert_to_rgba_f32(fmt.value, planes)
                            input_memo[p.input_id] = build_mips(rgba, _mip_levels(res))
                    return input_memo[p.input_id]
                # a layout node: sources are looked up by node id (collapse
                # may reference grandchildren); only referenced nodes are
                # evaluated, so collapsed canvases never materialize
                sources = []
                for sid in layout_sources[nid]:
                    r = eval_node(nodes[sid])
                    sources.append(r if r is not None else [dummy])
                res = resolution if is_root else _layout_res_from_key(key, nid)
                canvas = compose_layouts(
                    (res.width, res.height), static_statics[nid],
                    layout_params[nid], sources,
                    planar=is_root and root_planar, cache=caches[nid],
                    device=device,
                )
                if is_root:
                    return [canvas]
                return build_mips(canvas, _mip_levels(res))

            out = eval_node(root)
            if out is None:  # a bare InputStream root with no frame
                rgba = torch.zeros((resolution.height, resolution.width, 4),
                                   dtype=torch.float32, device=device)
            else:
                rgba = _full_rgba(out)
            # un-premultiply is NOT done: outputs are opaque video frames
            if out_format == PixelFormat.PLANAR_YUV420:
                if root_planar:
                    return cc.planar_rgba_to_yuv420(rgba)
                return cc.rgba_to_planar_yuv420(rgba)
            return cc.f32_to_u8(rgba).contiguous()

        return run


def _full_rgba(src):
    """Full-resolution (H, W, 4) f32 RGBA of an eval_node result (a mip
    list, or a DeferredYuvSource converted on first use); a root layout's
    [canvas] gives its canvas."""
    if hasattr(src, "mips"):
        return src.mips()[0]
    return src[0] if isinstance(src, list) else src


def _layout_res_from_key(key: tuple, nid: int) -> Resolution:
    for part in key:
        if isinstance(part, tuple) and part and part[0] == nid and part[1] == "layout":
            return part[3]
    raise KeyError(nid)


def _rgb_to_yuv_limited_u8(r: int, g: int, b: int) -> Tuple[int, int, int]:
    """BT.709 limited-range YUV for a constant color (matches
    ops/color_convert.py matrices)."""
    rf, gf, bf = r / 255.0, g / 255.0, b / 255.0
    y = 0.2126 * rf + 0.7152 * gf + 0.0722 * bf
    u = (bf - y) / 1.8556
    v = (rf - y) / 1.5748
    return (
        int(round(16.0 + 219.0 * y)),
        int(round(128.0 + 224.0 * u)),
        int(round(128.0 + 224.0 * v)),
    )


def _try_yuv_grid_program(
    statics: Tuple[LayoutStatic, ...],
    source_nodes: List[Node],
    resolution: Resolution,
    out_format: PixelFormat,
    input_formats: Dict[str, tuple],
    access: _InputAccess,
) -> Optional[Callable]:
    """If this structure is an opaque axis-aligned grid of planar-YUV420
    inputs over an opaque background, build the YUV-domain program: per-tile
    separable resizes (GEMMs) + static slice placements, chroma at half
    resolution, no RGBA round trip. Returns None when conditions don't hold.

    Texture sources must resolve (possibly through collapsed wrappers) to
    InputStreamNodes with planar-YUV420 frames."""
    from smelter_tpu_torch.parallel.flagship import _round_u8, plan_grid_partition

    if out_format != PixelFormat.PLANAR_YUV420 or not statics:
        return None
    child_inputs: List[Optional[str]] = [
        src.params.input_id if isinstance(src.params, InputStreamNode) else None
        for src in source_nodes
    ]

    H, W = resolution.height, resolution.width
    bg = (16, 128, 128)
    tiles = []  # (input_id, top, left, h, w, crop)
    for st in statics:
        if (
            st.has_rotation
            or st.has_border
            or st.n_masks
            or not st.no_radius
            or st.static_rect is None
            or st.traced_position
        ):
            return None
        if st.content == "color":
            if tiles:
                return None  # color over tiles → needs blending
            t, l, h, w = st.static_rect
            if st.static_color is None or st.static_color[3] != 255:
                return None
            if t > 0 or l > 0 or t + h < H or l + w < W:
                return None  # not a full-canvas background
            bg = _rgb_to_yuv_limited_u8(*st.static_color[:3])
        elif st.content == "texture":
            if st.source_index >= len(child_inputs) or st.static_crop is None:
                return None
            fmt = input_formats.get(child_inputs[st.source_index])
            if fmt is None or fmt[0] != PixelFormat.PLANAR_YUV420:
                return None
            t, l, h, w = st.static_rect
            t, l = t // 2 * 2, l // 2 * 2
            h, w = h // 2 * 2, w // 2 * 2
            if h <= 0 or w <= 0 or t < 0 or l < 0 or t + h > H or l + w > W:
                return None
            ct, cl, chh, cww = st.static_crop
            crop = (ct // 2 * 2, cl // 2 * 2, max(chh // 2 * 2, 2), max(cww // 2 * 2, 2))
            tiles.append((child_inputs[st.source_index], t, l, h, w, crop))
        else:
            return None  # shadows need blending

    ch_, cw_ = H // 2, W // 2
    # concatenation when the tiles exactly partition the canvas (one write
    # instead of one region write per tile)
    partition = plan_grid_partition(
        [(tile, tile[1], tile[2], tile[3], tile[4]) for tile in tiles], H, W
    )

    def run(frame_buf, raw_planes, packed_params):
        # the parameters are unused: the grid's geometry is all static
        def tile_planes(tile):
            iid, t, l, h, w, (ct, cl, chh, cww) = tile
            y, u, v = access.get(iid, frame_buf, raw_planes)
            ys = y[ct : ct + chh, cl : cl + cww]
            us = u[ct // 2 : (ct + chh) // 2, cl // 2 : (cl + cww) // 2]
            vs = v[ct // 2 : (ct + chh) // 2, cl // 2 : (cl + cww) // 2]
            return (
                _round_u8(resize_matmul(ys, h, w)),
                _round_u8(resize_matmul(us, h // 2, w // 2)),
                _round_u8(resize_matmul(vs, h // 2, w // 2)),
            )

        if partition is not None:
            rows_y, rows_u, rows_v = [], [], []
            for row in partition:
                ry, ru, rv = zip(*(tile_planes(entry[0]) for entry in row))
                rows_y.append(torch.cat(ry, dim=1))
                rows_u.append(torch.cat(ru, dim=1))
                rows_v.append(torch.cat(rv, dim=1))
            return torch.cat(rows_y), torch.cat(rows_u), torch.cat(rows_v)

        dev = frame_buf.device
        canvas_y = torch.full((H, W), bg[0], dtype=torch.uint8, device=dev)
        canvas_u = torch.full((ch_, cw_), bg[1], dtype=torch.uint8, device=dev)
        canvas_v = torch.full((ch_, cw_), bg[2], dtype=torch.uint8, device=dev)
        for tile in tiles:
            _, t, l, h, w, _ = tile
            ty, tu, tv = tile_planes(tile)
            canvas_y[t : t + h, l : l + w] = ty
            canvas_u[t // 2 : (t + h) // 2, l // 2 : (l + w) // 2] = tu
            canvas_v[t // 2 : (t + h) // 2, l // 2 : (l + w) // 2] = tv
        return canvas_y, canvas_u, canvas_v

    return run
