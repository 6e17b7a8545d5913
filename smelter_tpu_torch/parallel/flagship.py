"""Flagship compose: N x 1080p YUV420 inputs -> one 4K YUV420 frame.

Port of the single-device builders of `smelter_tpu/parallel/flagship.py`,
the driver's north-star shape, in its two scenes:

  - `make_flagship_compose`: the Tiles grid. When the scene is an opaque
    axis-aligned grid, the compose stays in YUV: every tile plane is resized
    (separable Lanczos3), rounded to u8 and placed by one `GridResize`
    (`ops/hopper/grid_resize.py`, one `grid_resize` launch on the card).
    Otherwise it falls back, as the reference does, to the general RGBA
    compose (`_general_stages`).
  - `make_flagship_general_compose` (`general_4k`): rounded, half-bordered
    tiles with box shadows on every third and two static rotations, through
    the general compose (`ops/compose.py`: kernel K1 paints the colour and
    shadow members, the textures blend in groups) and the YUV420 output
    (kernel K2).
  - `make_flagship_batched_compose`: the Tiles grid over a batch of frames
    in one call, the counterpart of the reference bench's `jax.vmap`: the
    grid's function frame by frame.

Every builder takes the `device` its tensors live on (the CUDA card unless
another is named; `interop.resolve_device` raises when there is no card)
and returns (fn, example_args). A builder runs its function once on the example
arguments, so that every host-built constant (resize and chroma weight
matrices, shear masks, the K1 member table) is on the device before the
first real frame.

For the multi-device steps, the grid and the general compose are each built
in stages (`Stages`): a per-stream stage on the stacked inputs, an assembly
of the whole frame and its conversion to YUV420 rows. One device runs the
general compose's stages in a row. The multi-device steps run them over a
`DeviceMesh`
(`parallel/mesh.py`), one process per device:

  - `make_multichip_step` (the Tiles grid) and `make_multichip_general_step`
    (rotated, bordered, rounded Views): mesh ("streams", "space"); each rank
    runs the per-stream stage on its block of inputs, the results are
    all-gathered over "streams", and each rank assembles the whole frame
    and converts its band of rows ("space");
  - `make_multioutput_step`: mesh ("outputs",); the inputs are broadcast
    from the first rank, and each rank composes its block of outputs, each
    the Tiles grid of its own order of the inputs.

A step takes the host planes (numpy arrays or tensors, the same on every
rank), returns this rank's shard, and has the reference's names, defaults
and (step, example_args); `mesh.gather_planes` gathers the global planes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from smelter_tpu_torch.core.types import Resolution, RGBAColor
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.ops import color_convert as cc
from smelter_tpu_torch.ops.compose import _assembly_mode, _canvas_dtype, compose_layouts
from smelter_tpu_torch.ops.hopper.grid_resize import GridResize
from smelter_tpu_torch.ops.resample import build_mips
from smelter_tpu_torch.parallel import mesh as meshes
from smelter_tpu_torch.render.capture import route
from smelter_tpu_torch.render.program import split_layout
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.layout_types import BorderRadius, RenderChildNode, RenderColor
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
            bg = cc.rgb_to_yuv_limited_u8(c.color.r, c.color.g, c.color.b)
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


def _identity(fields):
    return fields


@dataclasses.dataclass(frozen=True)
class Stages:
    """A flagship function in the stages a mesh splits it into.

    `per_stream(y, u, v)` maps the stacked planes of a block of inputs to
    its fields; `assemble(fields)` maps the fields of all N inputs to the
    frame; `rows(frame, r0, r1)` gives the u8 YUV420 planes of the frame's
    luma rows [r0, r1) (r0, r1 even). One device runs the general compose
    as rows(assemble(per_stream(y, u, v)), 0, height); the grid's function
    on one device is its own (`_grid_stages`). A mesh gathers the
    fields as `pack` gives them, tensors stacked over the block's inputs
    (row i belongs to input i), and `unpack` turns the gathered tensors back
    into fields for `assemble`."""

    per_stream: Callable
    assemble: Callable
    rows: Callable
    height: int
    pack: Callable = _identity
    unpack: Callable = _identity

    def __call__(self, y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        return self.rows(self.assemble(self.per_stream(y, u, v)), 0, self.height)


def _flagship_stages(n_inputs: int, in_res: Resolution, out_res: Resolution, device,
                     canvas_dtype: torch.dtype = torch.float32):
    """(stages, grid) of the Tiles scene: when it is an opaque grid, its
    stages (`_grid_stages`) and `grid`, its function on one device; else
    the general RGBA compose's stages, with its canvas stored as
    `canvas_dtype`, and `grid` None."""
    flat = _tiles_layouts(n_inputs, in_res, out_res)
    grid = _analyze_opaque_grid(flat, out_res)
    if grid is not None:
        return _grid_stages(grid, n_inputs, in_res, out_res)
    return _general_stages(flat, n_inputs, out_res, device, canvas_dtype), None


def make_flagship_compose(
    n_inputs: int = 16,
    in_res: Resolution = Resolution(1920, 1080),
    out_res: Resolution = Resolution(3840, 2160),
    device=None,
):
    """Returns (fn, example_args): fn(y, u, v) with stacked u8 plane batches
    (N, H, W) / (N, H/2, W/2) on `device` -> the 4K YUV420 u8 planes. The
    general fallback reads SMELTER_CANVAS_DTYPE and SMELTER_SCENE_ASSEMBLY
    here, when it is built."""
    return _flagship_fn(n_inputs, in_res, out_res, resolve_device(device), _canvas_dtype(True))


def _flagship_fn(n_inputs: int, in_res: Resolution, out_res: Resolution, device,
                 canvas_dtype: torch.dtype):
    """`make_flagship_compose` with its general fallback's canvas stored as
    `canvas_dtype`."""
    stages, grid = _flagship_stages(n_inputs, in_res, out_res, device, canvas_dtype)
    if grid is None:
        return _make_general_compose(stages, n_inputs, in_res, device)

    @route("flagship_compose")
    def fn(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        return grid(y, u, v)

    return _warmed(fn, n_inputs, in_res, device)


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
    channel-major canvas flows straight into the YUV420 output. The canvas
    storage (SMELTER_CANVAS_DTYPE) and the route of its opening run
    (SMELTER_SCENE_ASSEMBLY) are read here, when the builder is built."""
    device = resolve_device(device)
    flat = _general_layouts(n_inputs, in_res, out_res)
    statics, params = zip(*(split_layout(l, fast=True, device=device) for l in flat))
    cache: dict = {}  # this scene's K1 member table, kept on the device
    canvas_dtype, assembly = _canvas_dtype(True), _assembly_mode()

    @route("flagship_general_compose")
    def general4k(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        # deferred sources: the texture layouts crop+resize the subsampled
        # YUV planes directly; full-resolution RGBA never exists
        sources = [
            cc.DeferredYuvSource(y[i], u[i], v[i]) for i in range(n_inputs)
        ]
        canvas = compose_layouts(
            (out_res.width, out_res.height), statics, params, sources,
            planar=True, cache=cache, device=device,
            canvas_dtype=canvas_dtype, assembly=assembly,
        )
        return cc.planar_rgba_to_yuv420(canvas)

    example_args = _example_args(n_inputs, in_res, device)
    general4k(*example_args)
    return general4k, example_args


def _grid_stages(grid, n_inputs, in_res: Resolution, out_res: Resolution):
    """The opaque grid: (stages, compose). `compose(y, u, v)`, its function
    on one device, passes each tile's input planes to one `GridResize` of
    the analysis's tiles, each showing its whole input. In the stages, with
    uniform tiles (every Tiles scene) the per-stream stage resizes the
    block's tiles through a `GridResize` of them stacked in a column (one a
    block size), and the assembly places the gathered tiles as `compose`'s
    `GridResize` places its own; with tiles of several sizes the per-stream
    stage passes the inputs through and the assembly is `compose`."""
    bg, tiles = grid
    H, W = out_res.height, out_res.width
    whole = (0, 0, in_res.height, in_res.width)
    resize = GridResize([(t, l, h, w, whole) for _, t, l, h, w in tiles], H, W, bg)
    index = [idx for idx, *_ in tiles]

    def compose(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        return resize([(y[i], u[i], v[i]) for i in index], y.device)

    def rows(planes, r0: int, r1: int):
        y, u, v = planes
        return y[r0:r1], u[r0 // 2 : r1 // 2], v[r0 // 2 : r1 // 2]

    if len({(h, w) for *_, h, w in tiles}) > 1 or len(tiles) != n_inputs:
        return Stages(lambda y, u, v: (y, u, v), lambda planes: compose(*planes), rows, H), compose

    th, tw = tiles[0][3:]
    blocks: dict = {}

    def per_stream(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        k = y.shape[0]
        if k not in blocks:
            blocks[k] = GridResize([(i * th, 0, th, tw, whole) for i in range(k)],
                                   k * th, tw, bg)
        ty, tu, tv = blocks[k]([(y[i], u[i], v[i]) for i in range(k)], y.device)
        return ty.view(k, th, tw), tu.view(k, th // 2, tw // 2), tv.view(k, th // 2, tw // 2)

    def assemble(fields):
        return resize.place(lambda t: tuple(f[index[t]] for f in fields), fields[0].device)

    return Stages(per_stream, assemble, rows, H), compose


def make_flagship_batched_compose(
    n_inputs: int = 16,
    in_res: Resolution = Resolution(1920, 1080),
    out_res: Resolution = Resolution(3840, 2160),
    batch: int = 4,
    device=None,
):
    """The counterpart of `jax.vmap` over `make_flagship_compose`'s function:
    returns (fn, example_args), fn(y, u, v) taking `batch` frames of stacked
    planes, (B, N, H, W) / (B, N, H/2, W/2) u8, and returning their
    (B, OH, OW) / (B, OH/2, OW/2) planes in one call: the grid's function
    run on each frame, frame b bit-equal to the single compose of frame b.
    Only the opaque grid batches, as the reference's bench batches only
    it: a Tiles scene that is not one raises ValueError naming the shape."""
    device = resolve_device(device)
    _, grid = _flagship_stages(n_inputs, in_res, out_res, device)
    if grid is None:
        raise ValueError(
            f"the Tiles scene of {n_inputs} x {in_res.width}x{in_res.height} -> "
            f"{out_res.width}x{out_res.height} is not an opaque grid; only the grid's "
            f"compose batches")

    @route("flagship_batched_compose")
    def fn(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        frames = [grid(y[b], u[b], v[b]) for b in range(y.shape[0])]
        return tuple(torch.stack(plane) for plane in zip(*frames))

    example_args = tuple(p.expand(batch, *p.shape).contiguous()
                         for p in _example_args(n_inputs, in_res, device))
    fn(*example_args)
    return fn, example_args


def _general_stages(flat, n_inputs, out_res: Resolution, device,
                    canvas_dtype: torch.dtype = torch.float32) -> Stages:
    """The general RGBA compose in stages: the per-stream stage converts each
    input of the block to a 2-level RGBA mip pyramid (a field per input, its
    levels (h, w, 4) f32), the assembly composes the canvas, stored as
    `canvas_dtype`, and `rows` converts rows of it to YUV420 (K2). A mesh
    gathers one tensor per level, (k, h, w, 4): only a mesh stacks the
    pyramids. SMELTER_SCENE_ASSEMBLY is read here, when it is built."""
    statics, params = zip(*(split_layout(l, device=device) for l in flat))
    levels = 2
    cache: dict = {}
    assembly = _assembly_mode()

    def per_stream(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        return [build_mips(cc.planar_yuv_to_rgba(y[i], u[i], v[i]), levels)
                for i in range(y.shape[0])]

    def assemble(pyramids):
        return compose_layouts(
            (out_res.width, out_res.height), statics, params, pyramids,
            planar=True, cache=cache, device=device,
            canvas_dtype=canvas_dtype, assembly=assembly,
        )

    def rows(canvas: torch.Tensor, r0: int, r1: int):
        return cc.planar_rgba_to_yuv420(canvas[:, r0:r1].contiguous())

    def pack(pyramids):
        return tuple(torch.stack(level) for level in zip(*pyramids))

    def unpack(stacked):
        return [[level[i] for level in stacked] for i in range(stacked[0].shape[0])]

    return Stages(per_stream, assemble, rows, out_res.height, pack, unpack)


def _make_general_compose(stages: Stages, n_inputs, in_res: Resolution, device):
    """The Tiles scene that is not an opaque grid (`_analyze_opaque_grid`
    refuses it), through the general RGBA compose, as the reference's: each
    input converted to a 2-level RGBA mip pyramid, the layouts split as not
    planner-stable and composed channel-major (the colour layers through K3
    on the card, the tiles through the sampled pass), and the canvas
    converted to YUV420 (K2)."""
    @route("flagship_compose")
    def fn(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
        return stages(y, u, v)

    return _warmed(fn, n_inputs, in_res, device)


def _warmed(fn, n_inputs: int, in_res: Resolution, device):
    """(fn, example_args), fn run once on the example arguments."""
    example_args = _example_args(n_inputs, in_res, device)
    fn(*example_args)
    return fn, example_args


def _example_args(n_inputs: int, in_res: Resolution, device=None):
    device = resolve_device(device)
    h, w = in_res.height, in_res.width
    return (
        torch.zeros((n_inputs, h, w), dtype=torch.uint8, device=device),
        torch.full((n_inputs, h // 2, w // 2), 128, dtype=torch.uint8, device=device),
        torch.full((n_inputs, h // 2, w // 2), 128, dtype=torch.uint8, device=device),
    )


def _host_block(planes, lo: int, hi: int, device) -> list:
    """Inputs [lo, hi) of stacked host planes (numpy arrays or tensors) on
    `device`."""
    return [torch.as_tensor(p)[lo:hi].to(device) for p in planes]


class StreamsStep:
    """A flagship function (`Stages`) over a ("streams", "space") mesh: this
    rank runs the per-stream stage on its block of inputs and packs its
    fields (`local`), the packed tensors are all-gathered over "streams" in
    one collective each (`gather`), and the rank assembles the whole frame
    and converts its band of rows (`finish`). Calling it runs the three on host planes and returns
    this rank's (y, u, v) band, replicated over "streams"."""

    def __init__(self, mesh, stages: Stages, n_inputs: int, device):
        self.device = meshes.rank_device(mesh, device)
        self.stages = stages
        self.inputs = meshes.shard_range(n_inputs, mesh, "streams")
        self.band = meshes.row_band(stages.height, mesh, "space")
        self.group = mesh.get_group("streams")

    def local(self, y, u, v) -> tuple:
        block = _host_block((y, u, v), *self.inputs, self.device)
        return self.stages.pack(self.stages.per_stream(*block))

    def gather(self, packed):
        return self.stages.unpack(
            tuple(meshes.all_gather_stacked(f, self.group) for f in packed))

    def finish(self, fields):
        return self.stages.rows(self.stages.assemble(fields), *self.band)

    def __call__(self, y, u, v):
        return self.finish(self.gather(self.local(y, u, v)))


def make_multichip_step(
    mesh,
    n_inputs: int = 16,
    in_res: Resolution = Resolution(192, 108),
    out_res: Resolution = Resolution(384, 216),
    device=None,
):
    """The flagship compose (`make_flagship_compose`'s stages: the Tiles grid,
    or its general fallback) over a ("streams", "space") mesh, as the
    reference's sharding: inputs P("streams", None, None), outputs
    P("space", None). Rank (s, p) resizes inputs [s k, (s + 1) k) (k =
    N / streams), the tiles are all-gathered over "streams", and the rank
    returns row band p of Y, U and V. `device`: this rank's (the mesh's
    type; its current card or the CPU if None). The canvas stays f32 under
    any SMELTER_CANVAS_DTYPE, as the reference's sharded traces keep it, so
    that a step equals one device's f32 compose. Returns (step,
    example_args), the example planes on the host."""
    device = meshes.rank_device(mesh, device)
    stages, _ = _flagship_stages(n_inputs, in_res, out_res, device, torch.float32)
    return StreamsStep(mesh, stages, n_inputs, device), _example_args(n_inputs, in_res, "cpu")


def _multichip_general_scene(n_inputs: int, out_res: Resolution):
    """The reference's non-grid scene for the general step: absolute Views,
    each rotated (7 + 11 i degrees), bordered and rounded, over a blue
    background."""
    w, h = out_res.width, out_res.height
    children = []
    for i in range(n_inputs):
        children.append(
            comp.View(
                position=comp.AbsolutePosition(
                    width=w * 0.30,
                    height=h * 0.30,
                    top=(h * 0.55) * ((i // 4) / 1.0 if n_inputs > 4 else 0.0)
                    + h * 0.05,
                    left=(w * 0.22) * (i % 4) + w * 0.04,
                    rotation_degrees=7.0 + 11.0 * i,
                ),
                border_width=3.0,
                border_color=RGBAColor(220, 60, 60, 255),
                border_radius=BorderRadius(6.0, 6.0, 6.0, 6.0),
                background_color=RGBAColor(0, 0, 0, 255),
                children=[comp.InputStream(input_id=f"in_{i}")],
            )
        )
    return comp.View(background_color=RGBAColor(12, 24, 48, 255), children=children)


def make_multichip_general_step(
    mesh,
    n_inputs: int = 8,
    in_res: Resolution = Resolution(128, 72),
    out_res: Resolution = Resolution(256, 144),
    device=None,
):
    """A non-grid scene (`_multichip_general_scene`) through the general RGBA
    compose (`_general_stages`) over the same ("streams", "space") mesh: each
    rank converts its block of inputs to mip pyramids, the pyramids are
    all-gathered over "streams" (one collective per level), and each rank
    composes the whole canvas (K3 paints the colour layers on a card) and
    converts its band of rows to YUV420 (K2). The reference's general step
    turns its Pallas kernels off, since GSPMD cannot split them; here each
    rank runs the port's kernels on its own work. Its canvas stays f32, as
    the reference's sharded traces keep it. Returns (step,
    example_args)."""
    device = meshes.rank_device(mesh, device)
    flat = _scene_layouts(_multichip_general_scene(n_inputs, out_res), n_inputs, in_res, out_res)
    stages = _general_stages(flat, n_inputs, out_res, device, torch.float32)
    return StreamsStep(mesh, stages, n_inputs, device), _example_args(n_inputs, in_res, "cpu")


def make_multioutput_step(
    mesh,
    n_outputs: int = 8,
    n_inputs: int = 16,
    in_res: Resolution = Resolution(192, 108),
    out_res: Resolution = Resolution(384, 216),
    device=None,
):
    """M outputs over a ("outputs",) mesh, each the Tiles grid of its own
    order of the same N inputs: the inputs P() (the first rank's planes are
    broadcast to every rank on each call), the (M, N) int32 order table
    P("outputs", None), the (M, OH, OW) outputs P("outputs", None, None).
    Each output is `make_flagship_compose`'s function on
    `index_select(inputs, order)`, so it equals the single-device compose of
    that order pixel for pixel (a general fallback's canvas stays f32, as
    in the reference's sharded traces). The table is the reference's
    (`np.random.RandomState(0)`, one permutation per output). Returns
    (step, example_args); step(y, u, v, perms) returns this rank's
    (m, OH, OW) y, u and v (m = M / outputs)."""
    device = meshes.rank_device(mesh, device)
    lo, hi = meshes.shard_range(n_outputs, mesh, "outputs")
    group = mesh.get_group("outputs")
    fn, example = _flagship_fn(n_inputs, in_res, out_res, device, torch.float32)

    def step(y, u, v, perms):
        if mesh.get_local_rank("outputs") == 0:
            planes = _host_block((y, u, v), 0, n_inputs, device)
        else:
            planes = [torch.empty_like(p) for p in example]
        planes = [meshes.broadcast_from_first(p, group) for p in planes]
        orders = torch.as_tensor(perms)[lo:hi].to(device=device, dtype=torch.int64)
        outs = [fn(*(torch.index_select(p, 0, order) for p in planes)) for order in orders]
        return tuple(torch.stack(plane) for plane in zip(*outs))

    rng = np.random.RandomState(0)
    perms = np.stack([rng.permutation(n_inputs) for _ in range(n_outputs)]).astype(np.int32)
    return step, (*_example_args(n_inputs, in_res, "cpu"), torch.from_numpy(perms))
