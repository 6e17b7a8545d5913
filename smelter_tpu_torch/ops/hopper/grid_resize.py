"""The resize and placement of every tile plane of an opaque YUV420 grid, in
one banded Lanczos-3 pass.

Stands for the XLA fusion of the JAX package's YUV grid route
(`smelter_tpu/render/program.py`, `_try_yuv_grid_program`: each tile
plane's `resize_matmul`, `_round_u8` and the concatenation of the tiles).
The JAX package has no Pallas kernel for it; its jitted frame program lets
XLA fuse the chain. The CUDA kernel is `smelter_tpu_torch/csrc/
grid_resize.cu`: u8 planes in, and every tile plane's u8 samples written in
place in the output Y, U and V planes, with the reference's arithmetic (a
height pass and a width pass, each an f32 sum of bf16 products rounded to
bf16, an axis of unchanged size skipped, then u8 by round half up). It is
bound by bytes: each input sample read once, each output sample written
once.

The weights are the GEMM route's bf16 matrices (`resample.
_dense_axis_weights` rounded to bf16), each row cut to its band of nonzero
columns (`axis_band`, `matrix_band`). `plan` lays them out for the kernel's
strips of output rows and columns: per m-tile of 16 rows and per n-tile of
8 columns, a dense bf16 block over only the k-tiles of 16 source samples
its bands reach (`_blocks`). The kernel thus sums every product the GEMM
sums but those by an exact zero, on the tensor cores as cuBLAS sums them.
The strips, the table and the bands of any bf16 matrix (`plan_planes`)
serve the tile converts' banded pass too (`tile_resize.py`), whose kernel
shares this one's body (`csrc/banded_resize.cuh`).

`GridResize` is the port's one resize, rounding and placement of an opaque
YUV420 grid: the renderer's grid program, `make_flagship_compose`'s grid
and the multi-device grid step's per-stream stage each build one from their
tiles' static geometry. Called with each tile's (Y, U, V) source planes, it
launches the kernel for CUDA planes (raising if it cannot) and runs the
plain version, the torch chain (`resize_tiles_plain`), for CPU planes.
Tiles that are pairwise disjoint take one launch (up to `MAX_PLANES` tile
planes a launch); tiles that overlap take one launch each, in paint order,
so later tiles overwrite earlier ones. The output planes come from `torch.empty`
where the tiles cover the canvas and from `torch.full` with the background
where they leave gaps. The strips' descriptors and the weights of a program
are one int32 table on the device (`_device_table`), made in the program's
warm-up as the GEMM weights are.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from smelter_tpu_torch.ops import resample
from smelter_tpu_torch.ops.hopper import build
from smelter_tpu_torch.render.capture import device_constant, each_run

MAX_PLANES = 128  # tile planes a launch takes (csrc/grid_resize.cu kMaxPlanes)
STRIP_INTS = 16  # ints of a strip's row of the table (csrc/grid_resize.cu kStripInts)
# a strip of output rows x columns of one tile plane, in order of preference:
# the first whose block's shared memory lets three blocks share an SM, else
# two, else the first that fits the 227 KB a block can have (a large
# downscale's wide bands); at most 32 rows (csrc/grid_resize.cu kMaxMTiles)
BLOCK_SHAPES = ((32, 128), (32, 64), (32, 56), (32, 48), (16, 64), (16, 32), (16, 16), (16, 8),
                (8, 8), (4, 8), (2, 8), (1, 8), (1, 4), (1, 2), (1, 1))
SMEM_MAX = 227 * 1024  # a block's shared memory, at most
SMEM_SM, SMEM_RESERVED = 228 * 1024, 1024  # an SM's, and what each block's costs besides

Rect = Tuple[int, int, int, int]  # top, left, height, width
# the bands of an axis as a hashable description: a function that returns
# (first, weights) as `matrix_band` does, and its arguments; e.g.
# (axis_band, in_size, out_size)
Band = Tuple

# kernel launches since the last reset (the main path's proof of use); a
# CUDA graph's replays count the launches captured in it
LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


def round_u8(x: torch.Tensor) -> torch.Tensor:
    """A resized plane's u8 samples: +0.5 then truncation (the reference's
    rounding here, not half to even), clamped to [0, 255]."""
    return torch.clamp(x.to(torch.float32) + 0.5, 0.0, 255.0).to(torch.uint8)


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


def matrix_band(w: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """An (out, in) matrix of bf16 values (held in f32) as bands: (first,
    weights), `first` the (out,) int32 first source index of each output
    sample and `weights` the (out, taps) f32 weights from there: the
    nonzero columns of each row, padded with exact zeros to the widest row
    (`first` is moved left where a band would pass the last source index).
    The bands rebuild the matrix exactly. Read-only arrays."""
    n_in = w.shape[1]
    nonzero = w != 0
    some = nonzero.any(axis=1)
    lo = np.where(some, nonzero.argmax(axis=1), 0)
    hi = np.where(some, n_in - 1 - nonzero[:, ::-1].argmax(axis=1), 0)
    taps = int((hi - lo).max()) + 1
    first = np.minimum(lo, n_in - taps).astype(np.int32)
    weights = np.take_along_axis(w, first[:, None] + np.arange(taps), axis=1)
    first.setflags(write=False)
    weights.setflags(write=False)
    return first, weights


@functools.lru_cache(maxsize=64)
def axis_band(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The Lanczos-3 resize of one axis as bands (`matrix_band` of the GEMM
    route's bf16 matrix). An axis of unchanged size is one tap of weight 1,
    as `resize_matmul` skips it. Cached by size."""
    if in_size <= 0 or out_size <= 0:
        raise ValueError(f"no band of a {in_size} -> {out_size} resize")
    if in_size != out_size:
        dense = resample._dense_axis_weights(in_size, out_size, "lanczos3")
        return matrix_band(resample.to_bf16_values(torch.from_numpy(dense)).numpy())
    first = np.arange(out_size, dtype=np.int32)
    weights = np.ones((out_size, 1), np.float32)
    first.setflags(write=False)
    weights.setflags(write=False)
    return first, weights


H_HEAD, W_HEAD = 4, 32  # ints before a row or column block's weight tiles (kHHead, kWHead)


def _up16(x):
    return (x + 15) // 16 * 16


def smem_bytes(hpad: int, wpad: int, mrows: int, h_ints: int, w_ints: int) -> int:
    """A block's shared memory (csrc/grid_resize.cu) for strips of at most
    `hpad` window rows, `wpad` window columns and `mrows` rows (each padded
    to 16), and row and column blocks of at most `h_ints` and `w_ints` ints
    of weights: two sets of a u8 window (or the bf16 height pass that takes
    its place, rows of `wpad` + 8) and its weights, the bf16 window and
    three strip rows."""
    window = max(hpad * wpad, _up16(2 * mrows * (wpad + 8)))
    return 2 * (window + 4 * (h_ints + w_ints)) + 2 * hpad * (wpad + 8) + 3 * 4 * STRIP_INTS


@dataclass(frozen=True)
class _Blocks:
    """The blocks of `n` output samples along one axis of a plane, with their
    source windows (first index, samples, padded samples) and weights: each
    tile (16 output rows, or 8 output columns) as a dense bf16 block over the
    k-tiles of 16 window samples its bands reach, from k-tile `kt0`, in rows
    of 16 * span + 8 bf16 (`span` the most k-tiles a tile reaches, zeros past
    a tile's own). `entries` holds each block's header (`head` ints: each
    tile's kt0, then from `head // 2` each tile's k-tiles) and tiles, as
    int32."""
    start: np.ndarray
    size: np.ndarray
    w0: np.ndarray
    win: np.ndarray
    pad: np.ndarray
    span: int
    entries: Tuple[np.ndarray, ...]


@functools.lru_cache(maxsize=256)
def _blocks(band: Band, n: int, tile: int, head: int, align: int) -> _Blocks:
    """The `_Blocks` of the axis whose bands `band` gives, in blocks of `n`
    outputs, tiles of `tile` outputs, headers of `head` ints and windows
    starting at a multiple of `align`. Cached by its arguments."""
    first, weights = band[0](*band[1:])
    n_out, taps = weights.shape
    start = np.arange(0, n_out, n)
    size = np.minimum(n, n_out - start)
    w0 = first[start] // align * align
    win = first[start + size - 1] + taps - w0
    tiles = np.arange(-(-min(n, n_out) // tile))
    lo = start[:, None] + tile * tiles[None, :]  # first output of each tile
    valid = tile * tiles[None, :] < size[:, None]
    hi = np.minimum(lo + tile, (start + size)[:, None]) - 1
    klo = first[np.minimum(lo, n_out - 1)] - w0[:, None]
    khi = first[np.minimum(hi, n_out - 1)] + taps - w0[:, None]
    kt0 = klo // 16
    span = int((-(-khi // 16) - kt0)[valid].max())
    pad = np.maximum(_up16(win), 16 * span)
    kt0 = np.where(valid, np.minimum(kt0, pad[:, None] // 16 - span), 0)
    spans = np.where(valid, -(-khi // 16) - kt0, 0)
    pitch = 16 * span + 8
    data = np.zeros(lo.shape + (tile, pitch), np.uint16)
    rows = lo[:, :, None] + np.arange(tile)
    ok = rows < (start + size)[:, None, None]
    b, t, i = np.nonzero(ok)
    o = rows[b, t, i]
    col = first[o] - w0[b] - 16 * kt0[b, t]
    bits = (weights.view(np.uint32) >> 16).astype(np.uint16)
    for u in range(taps):
        data[b, t, i, col + u] = bits[o, u]
    entries = []
    for k in range(len(start)):
        nt = -(-int(size[k]) // tile)
        hd = np.zeros(head, np.int32)
        hd[:nt] = kt0[k, :nt]
        hd[head // 2 : head // 2 + nt] = spans[k, :nt]
        entries.append(np.concatenate([hd, data[k, :nt].reshape(-1).view(np.int32)]))
    return _Blocks(start, size, w0, win, pad, span, tuple(entries))


@dataclass(frozen=True)
class Plan:
    """The launch geometry of a program's tile planes: the int32 `table`
    (the weights of each distinct row and column blocking, then one
    `STRIP_INTS` row per strip, plane after plane, from row `strip_base`),
    the strips of each plane and each plane's largest strip dims (hpad,
    wpad, mrows, h_ints, w_ints)."""
    table: np.ndarray
    strip_base: int
    strips: Tuple[int, ...]
    dims: Tuple[Tuple[int, ...], ...]
    smem: Callable[..., int] = smem_bytes  # a block's shared memory of the largest dims

    def launch(self, k0: int, k1: int) -> Tuple[int, int, Tuple[int, ...], int]:
        """(first strip row, strips, largest dims, shared memory bytes) of a
        launch of tile planes k0 .. k1."""
        dims = tuple(max(d[i] for d in self.dims[k0:k1]) for i in range(5))
        return (self.strip_base + sum(self.strips[:k0]), sum(self.strips[k0:k1]), dims,
                self.smem(*dims))


def _dims(hb: _Blocks, wb: _Blocks) -> Tuple[int, ...]:
    return (int(hb.pad.max()), int(wb.pad.max()), int(_up16(hb.size.max())),
            max(e.size for e in hb.entries), max(e.size for e in wb.entries))


@functools.lru_cache(maxsize=64)
def plan(shapes: Tuple[Tuple[int, ...], ...]) -> Plan:
    """The `Plan` of grid tile planes given as (in_h, in_w, out_h, out_w,
    plane, top, left) each, `plane` 0, 1 or 2 for the output Y, U or V: the
    Lanczos-3 bands of their axes (`axis_band`), as `plan_planes` lays
    them out."""
    return plan_planes(tuple(((axis_band, in_h, out_h), (axis_band, in_w, out_w), p, top, left)
                             for in_h, in_w, out_h, out_w, p, top, left in shapes))


def strip_shape(h_band: Band, w_band: Band, smem: Callable[..., int] = smem_bytes,
                shares: Tuple[int, ...] = (3, 2, 1)
                ) -> Optional[Tuple[int, int, _Blocks, _Blocks]]:
    """The strip of a tile plane whose rows and columns have the bands
    `h_band` and `w_band`: (rows, columns, row blocks, column blocks) of
    the first of `BLOCK_SHAPES` whose block's shared memory (`smem` of its
    dims) lets `shares[0]` blocks share an SM; where none does, the first
    that lets `shares[1]`, and so on; None where none fits a block."""
    options, sizes = [], []
    for r, c in BLOCK_SHAPES:
        hb, wb = _blocks(h_band, r, 16, H_HEAD, 1), _blocks(w_band, c, 8, W_HEAD, 16)
        options.append((r, c, hb, wb))
        sizes.append(smem(*_dims(hb, wb)))
        if sizes[-1] <= min(SMEM_MAX, SMEM_SM // shares[0] - SMEM_RESERVED):
            break
    for share in shares:  # blocks an SM holds
        fits = [i for i, n in enumerate(sizes)
                if n <= min(SMEM_MAX, SMEM_SM // share - SMEM_RESERVED)]
        if fits:
            return options[fits[0]]
    return None


@functools.lru_cache(maxsize=64)
def plan_planes(planes: Tuple[Tuple, ...], smem: Callable[..., int] = smem_bytes,
                shares: Tuple[int, ...] = (3, 2, 1)) -> Plan:
    """The `Plan` of tile planes given as (rows, columns, plane, top, left)
    each: the `Band`s of their height and width passes, the output plane
    (the strip rows' `kDst`) and their place in it. Each plane takes its
    `strip_shape` (three blocks an SM, else two, else one, by this file's
    shared memory layout unless `smem` gives another kernel's), raising if
    none fits. Planes whose rows or columns have the same bands share their
    weights in the table."""
    offsets: dict = {}
    chunks: List[np.ndarray] = []
    size = 0

    def place(key, blocks: _Blocks) -> np.ndarray:
        nonlocal size
        if key not in offsets:
            at = []
            for e in blocks.entries:
                at.append(size)
                chunks.append(e)
                size += e.size
            offsets[key] = np.asarray(at)
        return offsets[key]

    rows, counts, dims = [], [], []
    for k, (h_band, w_band, p, top, left) in enumerate(planes):
        shape = strip_shape(h_band, w_band, smem, shares)
        if shape is None:
            raise ValueError(f"banded resize: tile plane {k} (rows {h_band[1:]}, columns "
                             f"{w_band[1:]}) needs more shared memory than a block has")
        r, c, hb, wb = shape
        h_at = place((h_band, r, "h"), hb)
        w_at = place((w_band, c, "w"), wb)
        ci, ri = np.meshgrid(np.arange(len(wb.start)), np.arange(len(hb.start)), indexing="ij")
        ri, ci = ri.reshape(-1), ci.reshape(-1)
        n = len(ri)
        rows.append(np.stack([
            np.full(n, k), np.full(n, p), top + hb.start[ri], left + wb.start[ci],
            hb.size[ri], wb.size[ci], hb.w0[ri], hb.win[ri], wb.w0[ci], wb.win[ci],
            hb.pad[ri], wb.pad[ci], np.full(n, hb.span), np.full(n, wb.span),
            h_at[ri], w_at[ci]], axis=1))
        counts.append(n)
        dims.append(_dims(hb, wb))
    pad = -size % STRIP_INTS
    table = np.concatenate(chunks + [np.zeros(pad, np.int32)]
                           + [r.astype(np.int32).reshape(-1) for r in rows])
    table.setflags(write=False)
    return Plan(table, (size + pad) // STRIP_INTS, tuple(counts), tuple(dims), smem)


@functools.lru_cache(maxsize=64)
def blocks_per_sm(device: torch.device, smem: int, kernel: str = "grid_resize") -> int:
    """The blocks of `kernel` (grid_resize, tile_resize or
    nv12_convert_resize) an SM of `device` holds at `smem` bytes of shared
    memory (asked once a card and size, in a program's warm-up: the call
    also raises the kernel's shared memory limit, which a capture may
    not)."""
    with torch.cuda.device(device):
        n = getattr(build.library(), f"smelter_{kernel}_blocks_per_sm")(smem)
    if n <= 0:
        raise RuntimeError(f"{kernel}: no block of {smem} B of shared memory fits an SM "
                           f"of {device} ({n})")
    return n


@device_constant(maxsize=64)
def _device_table(shapes: Tuple[Tuple[int, ...], ...], device: torch.device) -> torch.Tensor:
    """`plan(shapes).table` on `device`, uploaded once per program
    (`interop.upload`, never inside a capture)."""
    from smelter_tpu_torch.interop import upload

    return upload(torch.from_numpy(plan(shapes).table.copy()), device)


def _crop_views(y, u, v, crop: Rect):
    """The source windows of a tile's crop (top, left, height, width; top and
    left even) in its Y, U and V planes, clipped as slices clip. An odd
    height or width takes the chroma rows or columns below it, as an
    odd-sized YUV420 frame stores h // 2 x w // 2 chroma samples."""
    ct, cl, ch, cw = crop
    return (y[ct : ct + ch, cl : cl + cw],
            u[ct // 2 : (ct + ch) // 2, cl // 2 : (cl + cw) // 2],
            v[ct // 2 : (ct + ch) // 2, cl // 2 : (cl + cw) // 2])


class GridResize:
    """The tiles of an opaque YUV420 grid resized and placed into an
    `height` x `width` canvas over `background` (Y, U, V). `tiles`: (top,
    left, height, width, crop) each, in paint order, the rect even and
    inside the canvas, the crop's top and left even (`_crop_views`); tile i
    shows `sources[i]` of a call."""

    def __init__(self, tiles: Sequence[Tuple[int, int, int, int, Rect]], height: int,
                 width: int, background: Tuple[int, int, int]) -> None:
        for t, l, h, w, crop in tiles:
            if min(t, l) < 0 or h <= 0 or w <= 0 or t + h > height or l + w > width:
                raise ValueError(f"grid_resize: tile {(t, l, h, w)} is not inside the "
                                 f"{width}x{height} canvas")
            if any(x % 2 for x in (t, l, h, w, *crop[:2])):
                raise ValueError(f"grid_resize: tile {(t, l, h, w)} crop {crop} is not on "
                                 f"the chroma grid")
        self.tiles = tuple(tiles)
        self.height, self.width = height, width
        self.background = tuple(background)
        self.partition = plan_grid_partition(
            [(i, t, l, h, w) for i, (t, l, h, w, _) in enumerate(self.tiles)], height, width)
        disjoint = all(_disjoint(a[:4], b[:4]) for k, a in enumerate(self.tiles)
                       for b in self.tiles[k + 1 :])
        covered = disjoint and sum(h * w for _, _, h, w, _ in self.tiles) == height * width
        # the canvas needs the background where tiles leave gaps
        self.fill = not covered
        # each launch as a range of tile planes (3 a tile, Y U V, in paint order)
        n = 3 * len(self.tiles)
        step = MAX_PLANES if disjoint else 3
        self.launches = tuple((k, min(k + step, n)) for k in range(0, n, step))

    def __call__(self, sources: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                 device: torch.device):
        """The output (Y, U, V) u8 planes on `device`, where every source
        plane lies: the kernel on a CUDA device, the plain version on the
        CPU."""
        if len(sources) != len(self.tiles):
            raise ValueError(f"grid_resize: {len(self.tiles)} tiles, {len(sources)} sources")
        for planes in sources:
            for t in planes:
                if t.dtype != torch.uint8 or t.dim() != 2:
                    raise ValueError(f"grid_resize takes 2-d u8 planes, got "
                                     f"{tuple(t.shape)} {t.dtype}")
                if t.device != device:
                    raise ValueError(f"grid_resize: a plane on {t.device}, the output on {device}")
        if device.type == "cpu":
            return self.resize_tiles_plain(sources, device)
        if device.type != "cuda":
            raise ValueError(f"grid_resize runs on CUDA or CPU tensors, not {device}")
        return self._launch(sources, device)

    def resize_tiles_plain(self, sources, device: torch.device):
        """The plain version, the torch chain: each tile plane's
        `round_u8(resize_matmul(...))`, placed (`place`)."""
        def tile_planes(i):
            _, _, h, w, crop = self.tiles[i]
            ys, us, vs = _crop_views(*sources[i], crop)
            return (round_u8(resample.resize_matmul(ys, h, w)),
                    round_u8(resample.resize_matmul(us, h // 2, w // 2)),
                    round_u8(resample.resize_matmul(vs, h // 2, w // 2)))

        return self.place(tile_planes, device)

    def place(self, tile_planes, device: torch.device):
        """The output planes on `device` of tiles already resized, tile i's
        u8 (Y, U, V) planes `tile_planes(i)`: placed by concatenation where
        the tiles partition the canvas and by slice writes over the
        background, in paint order, otherwise."""
        if self.partition is not None:
            rows_y, rows_u, rows_v = [], [], []
            for row in self.partition:
                ry, ru, rv = zip(*(tile_planes(entry[0]) for entry in row))
                rows_y.append(torch.cat(ry, dim=1))
                rows_u.append(torch.cat(ru, dim=1))
                rows_v.append(torch.cat(rv, dim=1))
            return torch.cat(rows_y), torch.cat(rows_u), torch.cat(rows_v)

        canvas = self._canvas(device, True)
        for i, (t, l, h, w, _) in enumerate(self.tiles):
            ty, tu, tv = tile_planes(i)
            canvas[0][t : t + h, l : l + w] = ty
            canvas[1][t // 2 : (t + h) // 2, l // 2 : (l + w) // 2] = tu
            canvas[2][t // 2 : (t + h) // 2, l // 2 : (l + w) // 2] = tv
        return canvas

    def _canvas(self, device, fill: bool):
        sizes = ((self.height, self.width), (self.height // 2, self.width // 2),
                 (self.height // 2, self.width // 2))
        if fill:
            return tuple(torch.full(s, c, dtype=torch.uint8, device=device)
                         for s, c in zip(sizes, self.background))
        return tuple(torch.empty(s, dtype=torch.uint8, device=device) for s in sizes)

    def plane_views(self, sources) -> Tuple[List[torch.Tensor], Tuple[Tuple[int, ...], ...]]:
        """Each tile plane's source window (`_crop_views`) and the shapes
        `plan` takes, in launch order."""
        views, shapes = [], []
        for (t, l, h, w, crop), planes in zip(self.tiles, sources):
            for p, view in enumerate(_crop_views(*planes, crop)):
                s = 1 if p == 0 else 2
                if view.numel() == 0:
                    raise ValueError(f"grid_resize: crop {crop} leaves nothing of a "
                                     f"{tuple(planes[p].shape)} plane")
                views.append(view)
                shapes.append((view.shape[0], view.shape[1], h // s, w // s, p, t // s, l // s))
        return views, tuple(shapes)

    def _launch(self, sources, device: torch.device):
        views, shapes = self.plane_views(sources)
        for view in views:
            if view.shape[1] > 1 and view.stride(1) != 1:
                raise ValueError(f"grid_resize takes planes whose rows are adjacent bytes, "
                                 f"got strides {view.stride()}")
        geometry = plan(shapes)
        table = _device_table(shapes, device)
        out = self._canvas(device, self.fill)
        lib = build.library()
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        dst_stride = (ctypes.c_int * 3)(*(t.stride(0) for t in out))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            for k0, k1 in self.launches:
                n = k1 - k0
                src = (ctypes.c_void_p * n)(*(v.data_ptr() for v in views[k0:k1]))
                stride = (ctypes.c_int * n)(*(v.stride(0) for v in views[k0:k1]))
                first_strip, n_strips, dims, smem = geometry.launch(k0, k1)
                blocks = min(n_strips, blocks_per_sm(device, smem) * sms)
                err = lib.smelter_grid_resize(
                    ctypes.addressof(src), ctypes.addressof(stride), n,
                    out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                    ctypes.addressof(dst_stride), table.data_ptr(), k0, first_strip, n_strips,
                    *dims, smem, blocks, stream)
                build.check(err, "grid_resize launch")
                each_run(_count)
        return out


def _disjoint(a: Rect, b: Rect) -> bool:
    return (a[0] + a[2] <= b[0] or b[0] + b[2] <= a[0]
            or a[1] + a[3] <= b[1] or b[1] + b[3] <= a[1])
