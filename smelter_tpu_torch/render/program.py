"""Frame program: the per-output render of one scene structure, ported from
`smelter_tpu/render/program.py`.

Each frame, `OutputProgram.plan` walks the node tree on the host: it
evaluates the scene's layouts at `pts`, decides per layout whether its
geometry is stable since the previous frame (the planner), splits each
layout into its static part (`LayoutStatic`, part of the structure key) and
its numbers, and packs every number into one f32 vector and every host
input plane into one u8 buffer. `render` runs the program of the structure
key on the two buffers: the layouts' parameters are views into the vector,
the inputs views into the buffer (`ops/compose.py`, kernels K1, K2 and K3 on
a CUDA device).

A build is a closure over the structure's statics plus a per-structure
device cache of what the statics fix (K1's member spec table, K3's kinds
table; never parameters). It is captured once per structure, as the
reference jits it (`render/capture.py`): on a CUDA device into a CUDA graph
that later frames of the structure replay, after their two buffers are
copied in without waiting. With ``allow_async_compile`` a structure not seen
before is captured on a background thread, and the frame returns None (the
renderer shows the output's last frame meanwhile). Scene transitions change
only numbers, and the structure only where the planner moves a layout
between the stable (region-local) and animating (traced or full-canvas)
routes.

Every node of the reference: InputStream nodes in every input format
(planar YUV as deferred YUV sources, the others converted to a
full-resolution RGBA mip pyramid); layout nodes (View, Tiles, Rescaler) with
every animated-geometry route; text, image and web nodes, whose host RGBA
textures (aux textures) upload only when they change (`_dev_aux`) and are
premultiplied and mipped on the device; shader nodes, user programs in the
JAX syntax run on the device through the torch-backed `jnp`
(`render/shader_ns.py`), with the frame time on the device. Any node can be
the root. The YUV grid program, and the RGBA, PLANAR_YUV420, PLANAR_YUV444
and NV12 outputs.
"""

from __future__ import annotations

import atexit
import logging
import math
import threading
import time
import weakref
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from smelter_tpu_torch.core.types import Frame, PixelFormat, Resolution
from smelter_tpu_torch.interop import layout_params, resolve_device, upload
from smelter_tpu_torch.ops import color_convert as cc
from smelter_tpu_torch.ops.color_convert import rgb_to_yuv_limited_u8 as _rgb_to_yuv_limited_u8
from smelter_tpu_torch.ops.compose import (
    MAX_MASKS_COUNT,
    LayoutParams,
    LayoutStatic,
    _assembly_mode,
    _canvas_dtype,
    compose_layouts,
)
from smelter_tpu_torch.ops.hopper.grid_resize import GridResize
from smelter_tpu_torch.ops.resample import build_mips, resize_bilinear
from smelter_tpu_torch.ops.rotate import MAX_SHEAR_BANDS, rotation_band_count
from smelter_tpu_torch.render import shader_validation as sv
from smelter_tpu_torch.render.capture import CapturedProgram, capture, count_each_run, route
from smelter_tpu_torch.render.shader_ns import ShaderArray, ShaderNamespace
from smelter_tpu_torch.scene.layout_types import (
    Mask,
    RenderBoxShadow,
    RenderChildNode,
    RenderColor,
    RenderLayout,
)
from smelter_tpu_torch.scene.scene_state import (
    ImageNode,
    InputStreamNode,
    LayoutNode,
    Node,
    ShaderNode,
    TextNode,
    WebNode,
)
from smelter_tpu_torch.utils import tracing

SUPPORTED_OUTPUTS = (PixelFormat.RGBA, PixelFormat.PLANAR_YUV420,
                     PixelFormat.PLANAR_YUV444, PixelFormat.NV12)


# live background captures: a short-lived script drains them before the
# interpreter finalises (`_drain_background_compiles`)
_CAPTURE_THREADS: "weakref.WeakSet[threading.Thread]" = weakref.WeakSet()


def _drain_background_compiles(timeout_s: float = 300.0) -> None:
    """Wait for the programs being captured in the background."""
    deadline = time.monotonic() + timeout_s
    for t in list(_CAPTURE_THREADS):
        t.join(timeout=max(deadline - time.monotonic(), 0.0))


atexit.register(_drain_background_compiles)


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
    # text, image and web textures by node id: (H, W, 4) u8 straight alpha
    # on the device (`OutputProgram._dev_aux`)
    aux_textures: Dict[int, torch.Tensor]
    shader_params: Dict[int, object]


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


class ShaderRegistry:
    """User shader components: a restricted Python source in the JAX syntax
    registered by id, exposing `main(inputs, params, resolution, time) ->
    (H, W, 4)` float.

    Sources are AST-allowlisted, executed against a closed builtins set, and
    traced on "meta" tensors at registration (`render/shader_validation.py`);
    their ``jnp`` and ``lax`` are this registry's torch-backed namespace on
    its device (`render/shader_ns.py`). The texture cap mirrors the
    reference's `shader.rs:15` SHADER_INPUT_TEXTURES_AMOUNT and is enforced
    at scene plan time. A registered shader is a function of torch tensors:
    the (H, W, 4) f32 input textures, the params, (width, height) and the
    0-d f32 time, returning a tensor."""

    MAX_TEXTURES = 16

    def __init__(self, device=None) -> None:
        self.namespace = ShaderNamespace(resolve_device(device))
        self._shaders: Dict[str, Callable] = {}

    def register(self, shader_id: str, source: str) -> None:
        if shader_id in self._shaders:
            raise ValueError(f"shader {shader_id!r} already registered")
        traced = sv.compile_sandboxed(shader_id, source, ShaderNamespace("meta"))
        sv.validate_traced(shader_id, traced, self.MAX_TEXTURES)
        self._shaders[shader_id] = _run_sandboxed(
            sv.compile_sandboxed(shader_id, source, self.namespace))

    def register_fn(self, shader_id: str, fn: Callable) -> None:
        """A trusted Python function of torch tensors (not sandboxed)."""
        if shader_id in self._shaders:
            raise ValueError(f"shader {shader_id!r} already registered")
        self._shaders[shader_id] = fn

    def unregister(self, shader_id: str) -> None:
        del self._shaders[shader_id]

    def get(self, shader_id: str) -> Callable:
        if shader_id not in self._shaders:
            raise ValueError(f"shader {shader_id!r} not registered")
        return self._shaders[shader_id]

    def has(self, shader_id: str) -> bool:
        return shader_id in self._shaders


def _run_sandboxed(main: Callable) -> Callable:
    """A sandboxed `main` as a function of torch tensors: the textures and
    the time go in as `ShaderArray`s, the output comes out as a tensor."""
    def fn(inputs, params, resolution, time):
        out = main([ShaderArray(t) for t in inputs], params, resolution,
                   ShaderArray(time))
        return out.t if isinstance(out, ShaderArray) else torch.as_tensor(out)

    return fn


def _frame_rgba_np(frame) -> np.ndarray:
    """Host-side RGBA of an input frame (any upload format), for the
    web-renderer uplink; numpy only, never the device."""
    from smelter_tpu_torch.pipeline.side_channel import _frame_to_rgba_bytes

    h, w = frame.resolution.height, frame.resolution.width
    return np.frombuffer(_frame_to_rgba_bytes(frame), np.uint8).reshape(h, w, 4)


def _premultiplied(tex: torch.Tensor) -> torch.Tensor:
    """A straight-alpha (H, W, 4) u8 texture as premultiplied f32."""
    rgba = cc.u8_to_f32(tex)
    return torch.cat([rgba[..., :3] * rgba[..., 3:4], rgba[..., 3:4]], dim=-1)


class OutputProgram:
    """Plans one output's node tree each frame and keeps the programs built
    for its structures, on one device (the CUDA card unless another is
    named: `interop.resolve_device`). `shaders`, `web`, `image_store` and
    `text_renderer` are the renderer's registries (a bare program of
    InputStream and layout nodes needs none)."""

    # long-running servers see many distinct stable geometries; bound the
    # program cache (evict oldest) so memory stays flat
    MAX_CACHED_PROGRAMS = 32

    def __init__(self, root: Node, resolution: Resolution,
                 out_format: PixelFormat, device=None,
                 shaders: Optional[ShaderRegistry] = None, web=None,
                 image_store=None, text_renderer=None) -> None:
        self.root = root
        self.resolution = resolution
        self.out_format = out_format
        self.device = resolve_device(device)
        self.shaders = shaders
        self.web = web  # WebRendererRegistry
        self.image_store = image_store
        self.text_renderer = text_renderer
        self._node_ids: Dict[int, int] = {}
        self._nodes: Dict[int, Node] = {}
        self._next_id = 0
        self._assign_ids(root)
        # structure key -> its captured program, oldest first
        self._build_cache: Dict[tuple, CapturedProgram] = {}
        self._compile_lock = threading.Lock()
        self._compiling: set = set()  # keys being captured in the background
        # on a CUDA device: one capture stream and one graph memory pool for
        # all the structures of this output (their graphs never replay at
        # once, and each call copies its outputs out of the pool)
        self._capture_stream = self._graph_pool = None
        if self.device.type == "cuda":
            self._capture_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        # (node_id, layout_index) -> last rect signature; used to detect
        # animating layouts (transitions) and route them to the general path
        self._rect_history: Dict[tuple, tuple] = {}
        # the live scene keeps rendering its images and shaders even if they
        # are unregistered afterwards (the registries only gate future scene
        # updates, reference integration-tests unregistering.rs): resolve
        # them now, while the scene update's validation still holds
        self._pinned_images: Dict[str, object] = {}
        self._pinned_shaders: Dict[str, Callable] = {}
        for node in self._nodes.values():
            p = node.params
            if isinstance(p, ImageNode) and image_store is not None:
                self._pinned_images[p.image_id] = image_store.get(p.image_id)
            if isinstance(p, ShaderNode) and shaders is not None and shaders.has(p.shader_id):
                self._pinned_shaders[p.shader_id] = shaders.get(p.shader_id)
        # node id -> (host texture, its device copy)
        self._aux_dev: Dict[int, tuple] = {}
        self._used_frames: Dict[str, Frame] = {}
        # chromium_embedding of non-input subtrees: per-child sub-programs
        self._embed_programs: Dict[int, "OutputProgram"] = {}

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
        """Walk the node tree at ``pts``: compute flattened layout params,
        gather aux textures, and build the static structure key."""
        layout_params: Dict[int, List[LayoutParams]] = {}
        # per layout nid: merged (RenderLayout, source nid) entries, in that
        # node's canvas coords — consumed by the node's parent for collapse
        collapsed_entries: Dict[int, List[Tuple[RenderLayout, Optional[int]]]] = {}
        aux: Dict[int, np.ndarray] = {}
        used_frames: Dict[str, Frame] = {}
        shader_params: Dict[int, object] = {}
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
            if isinstance(p, TextNode):
                rendered = self.text_renderer.render(p.component)
                aux[nid] = rendered.rgba
                res = Resolution(rendered.rgba.shape[1], rendered.rgba.shape[0])
                key_parts.append((nid, "text", res))
                return res
            if isinstance(p, ImageNode):
                asset = self._pinned_images.get(p.image_id)
                if asset is None:
                    asset = self.image_store.get(p.image_id)
                    self._pinned_images[p.image_id] = asset
                frame = asset.frame_at(pts)
                aux[nid] = frame
                res = Resolution(frame.shape[1], frame.shape[0])
                key_parts.append((nid, "image", res))
                return res
            if isinstance(p, ShaderNode):
                if len(node.children) > ShaderRegistry.MAX_TEXTURES:
                    # reference shader.rs:15 SHADER_INPUT_TEXTURES_AMOUNT
                    raise ValueError(
                        f"shader {p.shader_id!r} has {len(node.children)} "
                        "input textures; the limit is "
                        f"{ShaderRegistry.MAX_TEXTURES}"
                    )
                child_res = [visit(ch) for ch in node.children]
                shader_params[nid] = p.shader_param
                res = Resolution(int(p.size[0]), int(p.size[1]))
                key_parts.append((nid, "shader", p.shader_id, res, tuple(child_res)))
                return res
            if isinstance(p, WebNode):
                return visit_web(node, nid, p)
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

        def visit_web(node: Node, nid: int, p: WebNode) -> Optional[Resolution]:
            # the web renderer runs as a host sidecar (render/web.py): its
            # latest page frame enters like an image texture; without a
            # sidecar the node renders transparent (reference
            # web_renderer_fallback.rs)
            child_res = [visit(ch) for ch in node.children]
            inst = self.web.get(p.instance_id) if self.web else None
            method = inst.spec.embedding_method if inst is not None else "chromium_embedding"
            if inst is not None and inst.active and method == "chromium_embedding":
                # uplink: push child frames INTO the page (embedder.rs:83
                # embed_sources). InputStream children convert their host
                # frame directly; any other subtree renders through a cached
                # sub-program to RGBA and is read back, only when its
                # content signature changes
                embeds = []
                for ch, cres in zip(node.children, child_res):
                    cp = ch.params
                    entry = None
                    if isinstance(cp, InputStreamNode):
                        f = input_frames.get(cp.input_id)
                        if f is not None:
                            # a thunk: embed_sources dedups by pts before
                            # converting, so a paused input costs nothing
                            entry = (f.pts, lambda f=f: _frame_rgba_np(f))
                    elif cres is not None:
                        entry = self._plan_subtree_embed(ch, cres, pts, input_frames)
                    embeds.append(entry)
                if any(e is not None for e in embeds):
                    inst.embed_sources(embeds)
            frame = inst.frame() if inst is not None else None
            if frame is None:
                key_parts.append((nid, "web", None, method))
                return None
            aux[nid] = frame
            res = Resolution(frame.shape[1], frame.shape[0])
            key_parts.append((nid, "web", res, method))
            return res

        with tracing.span("render.plan.walk"):
            visit(self.root)
            key = tuple(key_parts)
        with tracing.span("render.plan.pack"):
            frame_buf, raw_planes = _pack_frame_buf(
                used_frames, pin=self.device.type == "cuda")
            packed_params = _pack_layout_params(layout_params, pts)
        aux_textures: Dict[int, torch.Tensor] = {}
        if aux:
            with tracing.span("render.plan.aux"):
                aux_textures = {nid: self._dev_aux(nid, a) for nid, a in aux.items()}
        plan = FramePlan(
            frame_buf=frame_buf,
            raw_planes=raw_planes,
            packed_params=packed_params,
            aux_textures=aux_textures,
            shader_params=shader_params,
        )
        self._used_frames = used_frames
        return key, plan

    def _plan_subtree_embed(self, child: Node, res: Resolution, pts: float,
                            input_frames):
        """Embed entry for a non-InputStream child of a chromium_embedding
        WebView: the child subtree renders to RGBA through a cached
        sub-program and is read back (the CDP analogue of the reference
        copying every child's texture into CEF shared memory). Returns
        (signature, thunk): embed_sources dedups on the signature before the
        thunk runs, so a static subtree renders and reads back once."""
        nid = self.node_id(child)
        sub = self._embed_programs.get(nid)
        if sub is None or sub.resolution != res:
            sub = OutputProgram(
                child, res, PixelFormat.RGBA, self.device, self.shaders,
                web=self.web, image_store=self.image_store,
                text_renderer=self.text_renderer,
            )
            self._embed_programs[nid] = sub
        try:
            skey, splan = sub.plan(pts, input_frames)
        except Exception:
            logging.getLogger("smelter.render").exception(
                "web-embed subtree plan failed (node %d)", nid
            )
            return None
        # the packed params' last element is the frame time: it joins the
        # signature only when the subtree holds a shader, the one
        # time-driven node
        has_shader = any(isinstance(n.params, ShaderNode) for n in sub._nodes.values())
        params = splan.packed_params
        param_bytes = params.tobytes() if has_shader else params[:-1].tobytes()
        sig = hash((
            skey,
            param_bytes,
            tuple(sorted((iid, f.pts) for iid, f in sub._used_frames.items())),
            tuple(sorted((anid, id(a)) for anid, a in splan.aux_textures.items())),
        ))

        def thunk(sub=sub):
            out = sub.render(pts, input_frames)
            arr = out.cpu().numpy()  # (H, W, 4) u8, premultiplied
            # the page's putImageData expects straight alpha
            a = arr[..., 3:4].astype(np.float32)
            scale = np.where(a > 0.0, 255.0 / np.maximum(a, 1.0), 0.0)
            rgb = np.clip(arr[..., :3].astype(np.float32) * scale, 0.0, 255.0
                          ).astype(np.uint8)
            return np.concatenate([rgb, arr[..., 3:]], axis=-1)

        return (sig, thunk)

    def _dev_aux(self, nid: int, arr: np.ndarray) -> torch.Tensor:
        """The device copy of an aux (text/image/web) texture, uploaded only
        when its host array changes (identity-keyed: an animated image
        uploads on the frames it changes), through pinned memory without
        waiting (`interop.upload`)."""
        ent = self._aux_dev.get(nid)
        if ent is not None and ent[0] is arr:
            return ent[1]
        host = np.ascontiguousarray(arr) if arr.flags.writeable else arr.copy()
        dev = upload(torch.from_numpy(host), self.device)
        self._aux_dev[nid] = (arr, dev)
        return dev

    # -- build, capture + run -----------------------------------------------------

    def render(self, pts: float, input_frames: Dict[str, Frame],
               allow_async_compile: bool = False):
        """Render one frame: plan, then run the program of the frame's
        structure on the two buffers; returns the output planes on the
        device, without waiting for it. A structure seen for the first time
        is built and captured first, within this call, unless
        ``allow_async_compile``: then its capture starts on a background
        thread and this call returns None (the caller shows its previous
        frame until the program is ready)."""
        with tracing.span("render.plan"):
            key, plan = self.plan(pts, input_frames)
        with tracing.span("render.lookup"):
            # hashes the whole structure key, and compares it on a hit
            program = self._build_cache.get(key)
            tracing.count_each((("program.lookups", 1),
                                ("program.hits", int(program is not None))))
        if program is not None:
            with tracing.span("render.args"):
                args = self._args(plan)
            return program(*args)
        if allow_async_compile:
            self._compile_async(key, plan, input_frames)
            return None
        program, out = self._compile(key, plan, input_frames)
        self._store_program(key, program)
        return out

    def _args(self, plan: FramePlan) -> tuple:
        """The program's arguments of one frame: the planes and the packed
        numbers as host buffers (pinned on a CUDA device, so that copying
        them in does not wait), the inputs that arrived as tensors on the
        device."""
        dev = self.device
        packed = torch.from_numpy(plan.packed_params)
        if dev.type == "cuda":
            packed = packed.pin_memory()
        return (plan.frame_buf,
                {iid: _to_device(p, dev) for iid, p in plan.raw_planes.items()},
                packed, plan.aux_textures, plan.shader_params)

    def _compile(self, key: tuple, plan: FramePlan, input_frames):
        """Build and capture the program of `key` on this frame's arguments:
        (the program, this frame's output)."""
        fn = self._build(key, input_frames)
        with tracing.span("render.capture"):
            captured = capture(fn, self._args(plan), self.device, pool=self._graph_pool,
                               stream=self._capture_stream)
        tracing.count("program.captures")
        return captured

    def _store_program(self, key: tuple, program: CapturedProgram) -> None:
        with self._compile_lock:
            if len(self._build_cache) >= self.MAX_CACHED_PROGRAMS:
                oldest = next(iter(self._build_cache))
                del self._build_cache[oldest]
                tracing.count("program.evictions")
            self._build_cache[key] = program

    def _compile_async(self, key: tuple, plan: FramePlan, input_frames) -> None:
        """Capture the program of `key` on a daemon thread, from the plan of
        the frame that asked for it; three attempts, each failure logged.
        The thread takes no lock of the renderer."""
        with self._compile_lock:
            if key in self._compiling:
                return
            self._compiling.add(key)

        def work() -> None:
            for attempt in range(3):
                try:
                    program, _ = self._compile(key, plan, input_frames)
                    self._store_program(key, program)
                    break
                except Exception:
                    logging.getLogger("smelter.render").exception(
                        "background capture failed (attempt %d/3)", attempt + 1)
            with self._compile_lock:
                self._compiling.discard(key)

        t = threading.Thread(target=work, name="program-capture", daemon=True)
        _CAPTURE_THREADS.add(t)
        t.start()

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
        shaders = self.shaders
        pinned_shaders = self._pinned_shaders
        if out_format not in SUPPORTED_OUTPUTS:
            raise ValueError(f"unsupported output format {out_format}")
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
        web_methods: Dict[int, str] = {}
        # statics are re-derived from the structure key captured at plan time
        for part in key:
            if isinstance(part, tuple) and len(part) >= 3 and part[1] == "layout":
                static_statics[part[0]] = part[2]
                layout_sources[part[0]] = part[5] if len(part) > 5 else ()
            elif isinstance(part, tuple) and len(part) >= 4 and part[1] == "web":
                web_methods[part[0]] = part[3]

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
        # a YUV-bound root layout canvas stays channel-major end to end, in
        # the storage SMELTER_CANVAS_DTYPE names when the program is built
        # (f32 or 16 bits; only the converters below read it)
        root_planar = (isinstance(root.params, LayoutNode)
                       and out_format != PixelFormat.RGBA)
        canvas_dtype = _canvas_dtype(root_planar)
        assembly = _assembly_mode()

        @route("general")
        def run(frame_buf, raw_planes, packed_params, aux_textures, shader_params):
            layout_params = _unpack_layout_params(packed_params, static_statics)
            time = packed_params[-1]  # a 0-d view on the device
            node_memo: Dict[int, object] = {}
            input_memo: Dict[str, object] = {}

            def eval_node(node: Node):
                nid = node_id(node)
                if nid not in node_memo:
                    node_memo[nid] = _eval(node, nid)
                return node_memo[nid]

            def _eval(node: Node, nid: int):
                """A DeferredYuvSource or DeferredNv12Source, a mip list,
                the root's [canvas], or None (an absent input, a web node
                without a page)."""
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
                        elif fmt == PixelFormat.NV12:
                            # static layouts convert and resize the u8 planes in
                            # one pass; .mips() converts the whole picture and
                            # counts it in the two counters registered here
                            input_memo[p.input_id] = cc.DeferredNv12Source(
                                *planes, mip_levels=_mip_levels(res))
                            count_each_run("program.general.rgba_converts", 0)
                            count_each_run("program.general.mip_levels", 0)
                        else:
                            # the RGBA input route: every other format converts
                            # at full resolution and is mipped
                            rgba = cc.convert_to_rgba_f32(fmt.value, planes)
                            mips = build_mips(rgba, _mip_levels(res))
                            count_each_run("program.general.rgba_converts")
                            count_each_run("program.general.mip_levels", len(mips) - 1)
                            input_memo[p.input_id] = mips
                    return input_memo[p.input_id]
                if isinstance(p, (TextNode, ImageNode)):
                    tex = aux_textures[nid]
                    res = Resolution(tex.shape[1], tex.shape[0])
                    return build_mips(_premultiplied(tex), _mip_levels(res))
                if isinstance(p, ShaderNode):
                    children = [eval_node(ch) for ch in node.children]
                    inputs = [_full_rgba(c) for c in children if c is not None]
                    fn = pinned_shaders.get(p.shader_id)
                    if fn is None:
                        fn = shaders.get(p.shader_id)
                    res = (int(p.size[0]), int(p.size[1]))
                    out = fn(inputs, shader_params.get(nid), res, time)
                    out = out.to(torch.float32)
                    if is_root:
                        return [out]
                    return build_mips(out, _mip_levels(Resolution(*res)))
                if isinstance(p, WebNode):
                    return eval_web(node, nid)
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
                    device=device, canvas_dtype=canvas_dtype, assembly=assembly,
                )
                if is_root:
                    return [canvas]
                return build_mips(canvas, _mip_levels(res))

            def eval_web(node: Node, nid: int):
                method = web_methods.get(nid, "chromium_embedding")
                child_outs = [eval_node(ch) for ch in node.children]
                page = _premultiplied(aux_textures[nid]) if nid in aux_textures else None
                if method == "chromium_embedding":
                    # the children were pushed into the page itself
                    if page is None:
                        return None
                    return build_mips(page, _mip_levels(
                        Resolution(page.shape[1], page.shape[0])))
                # native embedding: the children composite above or below
                # the page (web_renderer.rs NativeEmbedding*Content)
                children = [_full_rgba(c) for c in child_outs if c is not None]
                if page is None and not children:
                    return None
                if page is None:
                    canvas, layers = torch.zeros_like(children[0]), children
                elif method == "native_embedding_under_content":
                    canvas, layers = torch.zeros_like(page), children + [page]
                else:  # native_embedding_over_content
                    canvas, layers = torch.zeros_like(page), [page] + children
                for layer in layers:
                    if layer.shape[:2] != canvas.shape[:2]:
                        layer = resize_bilinear(layer, canvas.shape[0], canvas.shape[1])
                    canvas = layer + canvas * (1.0 - layer[..., 3:4])
                return build_mips(canvas, _mip_levels(
                    Resolution(canvas.shape[1], canvas.shape[0])))

            out = eval_node(root)
            if out is None:  # a root with nothing to show
                rgba = torch.zeros((resolution.height, resolution.width, 4),
                                   dtype=torch.float32, device=device)
            else:
                rgba = _full_rgba(out)
            # un-premultiply is NOT done: outputs are opaque video frames
            if root_planar:
                if out_format == PixelFormat.PLANAR_YUV420:
                    return cc.planar_rgba_to_yuv420(rgba)
                if out_format == PixelFormat.PLANAR_YUV444:
                    return cc.planar_rgba_to_yuv444(rgba)
                return cc.planar_rgba_to_nv12(rgba)
            if out_format == PixelFormat.RGBA:
                return cc.f32_to_u8(rgba).contiguous()
            if out_format == PixelFormat.PLANAR_YUV420:
                return cc.rgba_to_planar_yuv420(rgba)
            if out_format == PixelFormat.PLANAR_YUV444:
                return cc.rgba_to_planar_yuv444(rgba)
            return cc.rgba_to_nv12(rgba)

        return run


def _full_rgba(src):
    """Full-resolution (H, W, 4) f32 RGBA of an eval_node result (a mip
    list, or a deferred source converted on first use); a root's [canvas]
    or [shader output] gives that."""
    if hasattr(src, "mips"):
        return src.mips()[0]
    return src[0] if isinstance(src, list) else src


def _layout_res_from_key(key: tuple, nid: int) -> Resolution:
    for part in key:
        if isinstance(part, tuple) and part and part[0] == nid and part[1] == "layout":
            return part[3]
    raise KeyError(nid)


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
    separable resizes and static placements, chroma at half resolution, no
    RGBA round trip (`ops/hopper/grid_resize.GridResize`: one banded pass on
    the card, the resize GEMMs on the CPU). Returns None when conditions
    don't hold. Each run counts its tile planes in
    `program.grid.tile_planes`.

    Texture sources must resolve (possibly through collapsed wrappers) to
    InputStreamNodes with planar-YUV420 frames."""
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

    grid = GridResize([tile[1:] for tile in tiles], H, W, bg)

    @route("grid")
    def run(frame_buf, raw_planes, packed_params, aux_textures, shader_params):
        # the parameters are unused: the grid's geometry is all static
        count_each_run("program.grid.tile_planes", 3 * len(tiles))
        return grid([access.get(tile[0], frame_buf, raw_planes) for tile in tiles],
                    frame_buf.device)

    return run
