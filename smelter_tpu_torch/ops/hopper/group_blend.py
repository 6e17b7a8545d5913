"""K4: one coalesced group of region-local layouts, blended in one pass.

Stands for the XLA fusion of one group of `smelter_tpu/ops/compose.py`
(`_blend_group`, :636): one canvas region read, one fused elementwise
chain, one slice write. The JAX package has no Pallas kernel for it; its
jitted frame program lets XLA fuse the chain. The CUDA kernel is
`smelter_tpu_torch/csrc/group_blend.cu`: one thread per pixel of the
group's union decodes the canvas value, OVER-blends every member in paint
order in f32 and stores once, in place, in the canvas's storage (f32, or
u16 fixed point, f16, bf16: `compose._canvas_encode`). It is bound by
bytes: the union read and written once and each member's inputs read once.

A member (`GroupMember`) is one layout with its torch-made inputs, if it
has any, already computed by `compose._group_member`:
  - "yuv": a static YUV tile's three f32 resized planes
    (`DeferredYuvSource.tile_products`); the kernel applies the colour tail
    (`color_convert.yuv_products_rgba_cm`), then the texture edge, border
    and masks of the layout's rect;
  - "rgba": the same with a (4, h, w) f32 RGBA tile (`compose._src_tile_cm`);
  - "placed": a premultiplied (4, h, w) layer at a static origin (a stably
    rotated tile after `rotate_static_cm`), times the layout's masks;
  - "sdf": a colour or box-shadow layout, with no planes: the kernel
    evaluates its layer at each union pixel from its parameter row, as
    kernel K1 evaluates its members (`csrc/sdf_common.cuh`'s `load_member`
    and `member_layer`: SDF, rotation, border, blur and masks), and its
    plain version is K1's plain member layer (`scene_assembly._member_layer`)
    over the union's pixel centres.
The plain version (`blend_group_plain`) is the port's former torch chain,
moved: the kernel repeats its operations in its order.

The members' descriptors (pointers, strides, static origins and sizes,
flags) go by value in each launch's arguments, so that a CUDA graph records
this frame's pointers; their dynamic numbers (rect, radii, border, masks)
are packed on the device each call by `scene_assembly.pack_member_params`.
A launch takes at most `MAX_MEMBERS` members: a larger group is split
across launches on an f32 canvas (exact: an f32 store and load change no
value) and refused on a 16-bit one, where an intermediate store would
quantize.

`blend_group` launches the kernel for a CUDA canvas, which it updates IN
PLACE and returns; for a CPU canvas it runs the plain version, which
returns a new tensor when the union is the whole canvas. Either way the
caller must use the returned tensor.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

from smelter_tpu_torch.ops.color_convert import canvas_decode, yuv_products_rgba_cm
from smelter_tpu_torch.ops.compose import (
    LayoutParams,
    LayoutStatic,
    _apply_masks_region,
    _canvas_encode,
    _mask_alpha,
    _over,
    _pad_into,
    _pixel_centers,
    _premultiply,
    rounded_rect_sdf,
    smoothstep,
)
from smelter_tpu_torch.ops.hopper import build
from smelter_tpu_torch.ops.hopper.scene_assembly import (
    _KINDS as SDF_KINDS,
    MemberSpec,
    _member_layer,
    pack_member_params,
)
from smelter_tpu_torch.render.capture import each_run

MAX_MEMBERS = 32  # members a launch takes (csrc/group_blend.cu kMaxMembers)
KINDS = {"yuv": 0, "rgba": 1, "placed": 2, "sdf": 3}
# canvas storage dtypes the kernel loads and stores, by the code its entry takes
CANVAS_DTYPES = {torch.float32: 0, torch.uint16: 1, torch.float16: 2, torch.bfloat16: 3}

# kernel launches since the last reset (the main path's proof of use); a
# CUDA graph's replays count the launches captured in it
LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


@dataclass(frozen=True)
class GroupMember:
    """One member of a group with its inputs computed (see the module).
    `planes`: (Y, U, V) products of one (h, w) shape for "yuv", none for
    "sdf", one (4, h, w) tensor otherwise; `origin`: the static canvas
    (top, left) of their pixel (0, 0), the static rect's for "sdf". K4
    applies the layout's masks to every kind."""

    kind: str
    static: LayoutStatic
    params: LayoutParams
    planes: Tuple[torch.Tensor, ...]
    origin: Tuple[int, int]
    full_range: bool = False

    @property
    def size(self) -> Tuple[int, int]:
        """(h, w) of the planes; of the static rect for "sdf"."""
        if not self.planes:
            return tuple(self.static.static_rect[2:])  # type: ignore[index,return-value]
        return tuple(self.planes[0].shape[-2:])  # type: ignore[return-value]

    @property
    def n_masks(self) -> int:
        return self.static.n_masks


def member_layer_plain(m: GroupMember, Y0: int, X0: int, vh: int, vw: int) -> torch.Tensor:
    """Premultiplied (4, vh, vw) contribution of one member over the
    absolute canvas region [Y0, Y0+vh) x [X0, X0+vw); exactly zero outside
    its footprint."""
    st, params = m.static, m.params
    top, left = m.origin
    if m.kind == "sdf":
        spec = MemberSpec(st.content, st.has_border, st.has_rotation, m.n_masks,
                          st.rotated_masks, (Y0, X0, Y0 + vh, X0 + vw))
        px, py = _pixel_centers(Y0, X0, vh, vw, params.top.device)
        return _member_layer(spec, pack_member_params([params], m.n_masks)[0], px, py)
    if m.kind == "placed":
        layer = _apply_masks_region(m.planes[0], st, params, top, left)
        return _pad_into(layer, top, left, Y0, X0, vh, vw)

    # non-rotated texture: the tile at its static rect, SDF edge, border, masks
    px, py = _pixel_centers(Y0, X0, vh, vw, params.top.device)
    rw, rh = params.width, params.height
    cx = params.left + rw * 0.5
    cy = params.top + rh * 0.5
    dx = px - cx
    dy = py - cy
    mask_alpha = _mask_alpha(px, py, params, st.n_masks, st.rotated_masks)
    edge = -rounded_rect_sdf(dx, dy, rw * 0.5, rh * 0.5, params.border_radius)

    if m.kind == "yuv":
        tile = yuv_products_rgba_cm(*m.planes, full_range=m.full_range)
    else:
        tile = m.planes[0]
    content = _pad_into(tile, top, left, Y0, X0, vh, vw)

    if st.has_border:
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


def blend_group_plain(canvas: torch.Tensor, members: Sequence[GroupMember],
                      union: Tuple[int, int, int, int], h: int, w: int) -> torch.Tensor:
    """The plain version: the region decodes to f32, each member's layer
    blends in paint order, and only the stored value quantizes to a 16-bit
    canvas's storage. The write is an in-place slice assignment into the
    canvas, which this frame owns (the reference returns an updated copy,
    which XLA turns into the same in-place update); a union that is the
    whole canvas returns the blended tensor instead."""
    uy, ux, uh, uw = union
    acc = canvas_decode(canvas[:, uy : uy + uh, ux : ux + uw])
    for m in members:
        acc = _over(member_layer_plain(m, uy, ux, uh, uw), acc)
    acc = _canvas_encode(acc, canvas.dtype)
    if (uh, uw) == (h, w):
        return acc
    canvas[:, uy : uy + uh, ux : ux + uw] = acc
    return canvas


class _Member(ctypes.Structure):
    """csrc/group_blend.cu's GroupMember (104 bytes; its entry checks the
    size)."""

    _fields_ = [
        ("plane", ctypes.c_void_p * 4),
        ("row_stride", ctypes.c_int * 4),
        ("params", ctypes.c_void_p),
        ("kind", ctypes.c_int),
        ("has_border", ctypes.c_int),
        ("full_range", ctypes.c_int),
        ("n_masks", ctypes.c_int),
        ("rotated_bits", ctypes.c_int),
        ("top", ctypes.c_int),
        ("left", ctypes.c_int),
        ("h", ctypes.c_int),
        ("w", ctypes.c_int),
        ("sdf_kind", ctypes.c_int),
        ("has_rotation", ctypes.c_int),
    ]


def _plane_pointers(m: GroupMember):
    """(pointers, row strides) of a member's four planes (a YUV tile's
    fourth is unused, an sdf member has none)."""
    if m.kind == "sdf":
        if m.planes:
            raise ValueError(f"K4: an sdf member takes no planes, got {len(m.planes)}")
        return [0] * 4, [0] * 4
    if m.kind == "yuv":
        if len(m.planes) != 3 or any(t.dim() != 2 or tuple(t.shape) != m.size
                                     for t in m.planes):
            raise ValueError(f"K4: a yuv member takes three (h, w) products, got "
                             f"{[tuple(t.shape) for t in m.planes]}")
        ptrs = [t.data_ptr() for t in m.planes] + [0]
        strides = [t.stride(0) for t in m.planes] + [0]
        return ptrs, strides
    t = m.planes[0]
    if len(m.planes) != 1 or t.dim() != 3 or t.shape[0] != 4:
        raise ValueError(f"K4: a {m.kind} member takes one (4, h, w) tensor, got "
                         f"{[tuple(p.shape) for p in m.planes]}")
    ptrs = [t.data_ptr() + c * t.stride(0) * t.element_size() for c in range(4)]
    return ptrs, [t.stride(1)] * 4


def describe(members: Sequence[GroupMember], rows: torch.Tensor, device) -> ctypes.Array:
    """The host array of kernel descriptors of one launch: each member's
    plane pointers and row strides, its row of `rows` (the packed
    parameters) and its static flags, origin and size. Refuses more than
    `MAX_MEMBERS` members, tensors off `device`, other dtypes than f32 and
    planes whose pixels are not adjacent along a row."""
    n = len(members)
    if n > MAX_MEMBERS:
        raise ValueError(f"K4 takes at most {MAX_MEMBERS} members a launch, got {n}")
    if rows.device != device or rows.dtype != torch.float32 or not rows.is_contiguous():
        raise ValueError(f"K4: packed parameters must be contiguous f32 on {device}, got "
                         f"{rows.dtype} on {rows.device}")
    arr = (_Member * max(n, 1))()
    for k, m in enumerate(members):
        if m.kind not in KINDS:
            raise ValueError(f"K4: unknown member kind {m.kind!r}")
        for t in m.planes:
            if t.device != device:
                raise ValueError(f"K4: a {m.kind} member's tensor is on {t.device}, the "
                                 f"canvas on {device}")
            if t.dtype != torch.float32:
                raise ValueError(f"K4 takes f32 member tensors, got {t.dtype}")
            if t.shape[-1] > 1 and t.stride(-1) != 1:
                raise ValueError(f"K4 takes member rows of adjacent pixels, got strides "
                                 f"{t.stride()}")
        ptrs, strides = _plane_pointers(m)
        bits = sum(1 << i for i, r in enumerate(m.static.rotated_masks[: m.n_masks]) if r)
        d = arr[k]
        d.plane[:] = ptrs
        d.row_stride[:] = strides
        d.params = rows.data_ptr() + k * rows.stride(0) * rows.element_size()
        d.kind = KINDS[m.kind]
        d.has_border = int(m.kind != "placed" and m.static.has_border)
        if m.kind == "sdf":
            d.sdf_kind = SDF_KINDS[m.static.content]
            d.has_rotation = int(m.static.has_rotation)
        d.full_range = int(m.full_range)
        d.n_masks = m.n_masks
        d.rotated_bits = bits
        d.top, d.left = m.origin
        d.h, d.w = m.size
    return arr


def _launch(canvas: torch.Tensor, members: Sequence[GroupMember],
            union: Tuple[int, int, int, int]) -> torch.Tensor:
    if canvas.dtype not in CANVAS_DTYPES or canvas.dim() != 3 or canvas.shape[0] != 4:
        raise ValueError(f"K4 takes a (4, H, W) canvas of {sorted(map(str, CANVAS_DTYPES))}, "
                         f"got {tuple(canvas.shape)} {canvas.dtype}")
    if not canvas.is_contiguous():
        raise ValueError("K4 takes a contiguous canvas")
    _, h, w = canvas.shape
    uy, ux, uh, uw = union
    if not (0 <= uy and 0 <= ux and uh > 0 and uw > 0 and uy + uh <= h and ux + uw <= w):
        raise ValueError(f"K4: union {union} is not inside the {w}x{h} canvas")
    n = len(members)
    if n > MAX_MEMBERS and canvas.dtype != torch.float32:
        raise ValueError(f"K4 takes at most {MAX_MEMBERS} members a launch; a group of {n} "
                         f"on a {canvas.dtype} canvas cannot be split (an intermediate "
                         f"store would quantize)")
    lib = build.library()
    for k0 in range(0, n, MAX_MEMBERS):
        chunk = members[k0 : k0 + MAX_MEMBERS]
        rows = pack_member_params([m.params for m in chunk], max(m.n_masks for m in chunk))
        arr = describe(chunk, rows, canvas.device)
        with torch.cuda.device(canvas.device):
            stream = torch.cuda.current_stream(canvas.device).cuda_stream
            err = lib.smelter_group_blend(
                canvas.data_ptr(), CANVAS_DTYPES[canvas.dtype], h, w, uy, ux, uh, uw,
                ctypes.addressof(arr), len(chunk), ctypes.sizeof(_Member), stream,
            )
        build.check(err, "group_blend launch")
        each_run(_count)
    return canvas


def blend_group(canvas: torch.Tensor, members: Sequence[GroupMember],
                union: Tuple[int, int, int, int], h: int, w: int) -> torch.Tensor:
    """OVER-blend one group's members over the canvas region `union` (top,
    left, height, width): K4 for a CUDA canvas, in place (raising if it
    cannot launch), the plain version for a CPU canvas. No members leaves
    the canvas as it is."""
    if canvas.device.type == "cpu":
        return blend_group_plain(canvas, members, union, h, w)
    if canvas.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA or CPU tensors, not {canvas.device}")
    if not members:
        return canvas
    return _launch(canvas, members, union)
