"""The tile converts' resizes: YUV420 tiles resized into the three f32
planes kernel K4 reads, every tile of a call in one banded Lanczos-3 pass.

Stands for the resizes in the XLA fusion of the JAX package's general
route (`smelter_tpu/ops/color_convert.py`, `yuv_tile_rgba_cm`: the luma
crop and the whole chroma planes, each by two matmuls, the chroma weights
composed with the 2x bilinear upsample). The JAX package has no Pallas
kernel for it. The CUDA kernel is `smelter_tpu_torch/csrc/tile_resize.cu`,
the body of `grid_resize` (`csrc/banded_resize.cuh`) with another store: u8
planes in, and each tile plane's products written as f32, with the
arithmetic of `color_convert.yuv_tile_products` (rows: an f32 sum of bf16
products rounded to bf16; columns: an f32 sum kept in f32; both passes on
every axis). It is bound by bytes: each input sample read once, each f32
product written once.

The weights are `color_convert.tile_weights`' four bf16 matrices (Wh, Ww
for Y; Wch, Wcw for U and V, the crop folded into them), each row cut to
its band of nonzero columns (`tile_band`), laid out for the kernel's strips
by `grid_resize.plan_planes` into one int32 table on the device, made in a
program's warm-up. Tiles of one picture size and crop share their weights.

`resize_tiles` launches the kernel for CUDA planes (raising if it cannot),
one launch a `MAX_PLANES` tile planes, and runs the plain version,
`color_convert.yuv_tile_products` one tile at a time (the GEMM chain
`_rs`), for CPU planes. `compose` hands it every static, unrotated YUV tile
of a run of the general route at once; every other tile convert on the
card is a call of one tile (`color_convert.yuv_tile_products`). Each tile
plane resized, by the kernel or by the plain version, counts one in
`program.general.tile_resize_planes` on each run (`capture.count_each_run`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from smelter_tpu_torch.ops import color_convert, resample
from smelter_tpu_torch.ops.hopper import build, grid_resize
from smelter_tpu_torch.render.capture import count_each_run, device_constant, each_run

MAX_PLANES = grid_resize.MAX_PLANES  # tile planes a launch takes (csrc/banded_resize.cuh)
PITCH = 8  # an output row's floats are a multiple of this (32 bytes)

# (y, u, v) u8 planes, the luma crop (top, left, height, width), out_h, out_w
Tile = Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[int, int, int, int], int, int]

# kernel launches since the last reset (the main path's proof of use); a
# CUDA graph's replays count the launches captured in it
LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


def count_planes(n: int) -> None:
    """Count `n` tile planes resized, on each run of the calling code."""
    count_each_run("program.general.tile_resize_planes", n)


@functools.lru_cache(maxsize=256)
def tile_band(luma_hw: Tuple[int, int], chroma_hw: Tuple[int, int],
              crop: Tuple[int, int, int, int], out_h: int, out_w: int, kind: str,
              i: int) -> Tuple[np.ndarray, np.ndarray]:
    """The bands (`grid_resize.matrix_band`) of matrix `i` of
    `color_convert.tile_weights` (0 Wh, 1 Ww, 2 Wch, 3 Wcw): its bf16
    values, the weights the GEMM route multiplies. Cached."""
    m = color_convert.tile_matrices(luma_hw, chroma_hw, crop, out_h, out_w, kind)[i]
    return grid_resize.matrix_band(resample.to_bf16_values(torch.from_numpy(m)).numpy())


def plane_views(tiles: Sequence[Tile], kind: str) -> Tuple[List[torch.Tensor], Tuple]:
    """Each tile plane's source (the luma crop, the whole U and V planes) and
    the planes `grid_resize.plan_planes` takes, in launch order: Y, U, V of
    each tile, the bands of its matrices, the output plane its own index."""
    views, planes = [], []
    for k, ((y, u, v), crop, h, w) in enumerate(tiles):
        ct, cl, ch, cw = (int(c) for c in crop)
        key = (tuple(y.shape), tuple(u.shape), (ct, cl, ch, cw), int(h), int(w), kind)
        ys = y[ct : ct + ch, cl : cl + cw]
        if min(ct, cl) < 0 or tuple(ys.shape) != (ch, cw) or ch <= 0 or cw <= 0:
            raise ValueError(f"tile_resize: crop {crop} is not inside a {tuple(y.shape)} plane")
        if u.shape != v.shape:
            raise ValueError(f"tile_resize: U {tuple(u.shape)} and V {tuple(v.shape)} differ")
        for p, (view, rows) in enumerate(((ys, 0), (u, 2), (v, 2))):
            views.append(view)
            planes.append(((tile_band, *key, rows), (tile_band, *key, rows + 1), 3 * k + p, 0, 0))
    return views, tuple(planes)


@device_constant(maxsize=64)
def _device_table(planes: Tuple, device: torch.device) -> torch.Tensor:
    """`grid_resize.plan_planes(planes).table` on `device`, uploaded once per
    program (`interop.upload`, never inside a capture)."""
    from smelter_tpu_torch.interop import upload

    return upload(torch.from_numpy(grid_resize.plan_planes(planes).table.copy()), device)


def resize_tiles(tiles: Sequence[Tile], kind: str = "lanczos3"
                 ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Each tile's three (out_h, out_w) f32 products (`color_convert.
    yuv_tile_products`), from u8 (Y, U, V) planes that lie on one device:
    the kernel on a CUDA device, the plain version on the CPU."""
    if not tiles:
        return []
    device = tiles[0][0][0].device
    for planes, _, h, w in tiles:
        if h <= 0 or w <= 0:
            raise ValueError(f"tile_resize: no tile of {w}x{h}")
        for t in planes:
            if t.dtype != torch.uint8 or t.dim() != 2:
                raise ValueError(f"tile_resize takes 2-d u8 planes, got {tuple(t.shape)} "
                                 f"{t.dtype}")
            if t.device != device:
                raise ValueError(f"tile_resize: planes on {t.device} and on {device}")
    if device.type == "cpu":
        return resize_tiles_plain(tiles, kind)
    if device.type != "cuda":
        raise ValueError(f"tile_resize runs on CUDA or CPU tensors, not {device}")
    return _launch(tiles, kind, device)


def resize_tiles_plain(tiles: Sequence[Tile], kind: str = "lanczos3"):
    """The plain version: `color_convert.yuv_tile_products` of each CPU
    tile, the GEMM chain on the plain route."""
    return [color_convert.yuv_tile_products(*planes, crop, h, w, kind)
            for planes, crop, h, w in tiles]


def _launch(tiles: Sequence[Tile], kind: str, device: torch.device):
    views, planes = plane_views(tiles, kind)
    for view in views:
        if view.shape[1] > 1 and view.stride(1) != 1:
            raise ValueError(f"tile_resize takes planes whose rows are adjacent bytes, got "
                             f"strides {view.stride()}")
    geometry = grid_resize.plan_planes(planes)
    table = _device_table(planes, device)
    # every tile plane's products in one buffer, rows of a multiple of PITCH
    # floats, so that each row starts 32-byte aligned
    sizes = [(h, w, -(-w // PITCH) * PITCH) for _, _, h, w in tiles for _ in range(3)]
    ends = np.cumsum([h * pitch for h, _, pitch in sizes]).tolist()
    buf = torch.empty(ends[-1], dtype=torch.float32, device=device)
    outs = [buf[e - h * pitch : e].view(h, pitch)[:, :w] for e, (h, w, pitch) in zip(ends, sizes)]
    lib = build.library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for k0 in range(0, len(views), MAX_PLANES):
            k1 = min(k0 + MAX_PLANES, len(views))
            n = k1 - k0
            src = (ctypes.c_void_p * n)(*(v.data_ptr() for v in views[k0:k1]))
            src_stride = (ctypes.c_int * n)(*(v.stride(0) for v in views[k0:k1]))
            dst = (ctypes.c_void_p * n)(*(o.data_ptr() for o in outs[k0:k1]))
            dst_stride = (ctypes.c_int * n)(*(o.stride(0) for o in outs[k0:k1]))
            first_strip, n_strips, dims, smem = geometry.launch(k0, k1)
            blocks = min(n_strips, grid_resize.blocks_per_sm(device, smem, "tile_resize") * sms)
            err = lib.smelter_tile_resize(
                ctypes.addressof(src), ctypes.addressof(src_stride), ctypes.addressof(dst),
                ctypes.addressof(dst_stride), n, table.data_ptr(), k0, first_strip, n_strips,
                *dims, smem, blocks, stream)
            build.check(err, "tile_resize launch")
            each_run(_count)
            count_planes(n)
    return [tuple(outs[3 * k : 3 * k + 3]) for k in range(len(tiles))]
