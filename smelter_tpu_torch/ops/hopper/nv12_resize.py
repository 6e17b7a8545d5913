"""NV12 tiles converted and resized in one pass: the decoder's u8 planes in,
each tile's channel-major (4, out_h, out_w) f32 RGBA out, the tile kernel
K4 reads as an "rgba" member.

Stands for the fusion of the JAX package's `smelter_tpu/ops/
color_convert.py` `nv12_to_rgba` (the whole picture converted to f32 RGBA:
the chroma upsampled, the limited range expanded and clamped, BT.709, RGB
clamped) with `smelter_tpu/ops/resample.py`'s resize of the tile's crop
(`resize_matmul`, two matmuls), which XLA fuses into the frame program; the
JAX package has no Pallas kernel for it. The CUDA kernel is
`smelter_tpu_torch/csrc/nv12_convert_resize.cu`, on the strips, the table
and the tensor-core passes of `csrc/banded_resize.cuh`: it converts each
full-resolution pixel of a strip's window in shared memory, in the eager
chain's order of operations and with its constants (`constants`), rounds
it to bf16, and resizes the four channels with the bf16 weights of
`resize_matmul`, each pass's f32 sum rounded to bf16. It is bound by bytes:
each input sample read once (the windows' halos come from L2), each f32
product written once. The full-resolution picture never reaches HBM.

The weights are `grid_resize.axis_band`'s bands of the crop's Lanczos-3
axes (one tap of 1 for an axis of unchanged size, which `resize_matmul`
skips), laid out by `grid_resize.plan_planes` with this kernel's shared
memory (`smem_bytes`: a tile's four channels a strip, so the strips are
smaller than `tile_resize`'s) into one int32 table on the device, made in a
program's warm-up. A strip's window is whole in shared memory, so a
downscale whose window outgrows a block's (about 21x on both axes of a
1080p crop) has no strip: `plan_planes` raises for it, as it does for
`tile_resize`.

`resize_tiles` launches the kernel for CUDA planes (raising if it cannot),
one launch a `MAX_TILES` tiles, and runs the plain version, the eager chain
(`color_convert.nv12_to_rgba`, then `resample.resize_matmul` of the crop),
for CPU planes. `compose` hands it every static, unrotated NV12 tile of a
run of the general route at once; any other NV12 tile on the card is a call
of one tile. Each tile made, by the kernel or by the plain version, counts
one in `program.general.nv12_tiles` on each run (`capture.count_each_run`).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from smelter_tpu_torch.ops import color_convert, resample
from smelter_tpu_torch.ops.hopper import build, grid_resize
from smelter_tpu_torch.render.capture import count_each_run, device_constant, each_run

MAX_TILES = grid_resize.MAX_PLANES // 4  # tiles a launch takes (csrc/nv12_convert_resize.cu)
PITCH = 8  # an output row's floats are a multiple of this (32 bytes)
# blocks an SM should hold, in order of preference (`grid_resize.strip_shape`)
SHARES = (2, 1)

# ((y (H, W), uv (H/2, W/2, 2)) u8 planes, the luma crop (top, left, height,
# width), out_h, out_w)
Tile = Tuple[Tuple[torch.Tensor, torch.Tensor], Tuple[int, int, int, int], int, int]

# kernel launches since the last reset (the main path's proof of use); a
# CUDA graph's replays count the launches captured in it
LAUNCHES = 0


def _count() -> None:
    global LAUNCHES
    LAUNCHES += 1


def count_tiles(n: int) -> None:
    """Count `n` NV12 tiles made, on each run of the calling code."""
    count_each_run("program.general.nv12_tiles", n)


def constants() -> np.ndarray:
    """The conversion's f32 constants as the eager chain uses them on the
    card: 1/255 and 16/255 as f32; the reciprocals of the f32 luma and
    chroma scales, as PyTorch divides a CUDA tensor by a scalar (a product
    by the f32 reciprocal); the BT.709 coefficients of R by V, G by U and V,
    and B by U (`color_convert.yuv_to_rgb`)."""
    f32 = np.float32
    return np.array([1.0 / 255.0, color_convert._FOOTROOM,
                     f32(1.0) / f32(color_convert._Y_SCALE),
                     f32(1.0) / f32(color_convert._UV_SCALE),
                     1.5748, 0.1873, 0.4681, 1.8556], np.float32)


def smem_bytes(hpad: int, wpad: int, mrows: int, h_ints: int, w_ints: int) -> int:
    """A block's shared memory (csrc/nv12_convert_resize.cu) for strips of
    at most `hpad` window rows, `wpad` window columns and `mrows` rows, and
    row and column blocks of at most `h_ints` and `w_ints` ints: two sets
    of a luma window, its chroma window (hpad / 2 + 2 rows of wpad + 32
    bytes) and their weights; three bf16 channel windows; four channels'
    bf16 height passes; three strip rows."""
    window = hpad * wpad + (hpad // 2 + 2) * (wpad + 32) + 4 * (h_ints + w_ints)
    return (2 * window + 3 * 2 * hpad * (wpad + 8) + 4 * 2 * mrows * (wpad + 8)
            + 3 * 4 * grid_resize.STRIP_INTS)


def _bands(crop: Tuple[int, int, int, int], out_h: int, out_w: int):
    _, _, ch, cw = (int(c) for c in crop)
    return (grid_resize.axis_band, ch, int(out_h)), (grid_resize.axis_band, cw, int(out_w))


def plan(tiles: Sequence[Tile]) -> Tuple:
    """The planes `grid_resize.plan_planes` takes for `tiles`: each tile's
    row and column bands, its index as its output, at its origin."""
    return tuple((*_bands(crop, h, w), k, 0, 0) for k, (_, crop, h, w) in enumerate(tiles))


@device_constant(maxsize=64)
def _device_table(planes: Tuple, device: torch.device) -> torch.Tensor:
    """The table of `planes` on `device`, uploaded once per program
    (`interop.upload`, never inside a capture)."""
    from smelter_tpu_torch.interop import upload

    table = grid_resize.plan_planes(planes, smem_bytes, SHARES).table
    return upload(torch.from_numpy(table.copy()), device)


def resize_tiles(tiles: Sequence[Tile]) -> List[torch.Tensor]:
    """Each tile's (4, out_h, out_w) f32 RGBA, from u8 NV12 planes that lie
    on one device: the kernel on a CUDA device, the plain version on the
    CPU."""
    if not tiles:
        return []
    device = tiles[0][0][0].device
    for (y, uv), crop, h, w in tiles:
        if h <= 0 or w <= 0:
            raise ValueError(f"nv12_resize: no tile of {w}x{h}")
        for t in (y, uv):
            if t.dtype != torch.uint8 or t.device != device:
                raise ValueError(f"nv12_resize takes u8 planes on {device}, got {t.dtype} on "
                                 f"{t.device}")
        if y.dim() != 2 or tuple(uv.shape) != (y.shape[0] // 2, y.shape[1] // 2, 2) or (
                y.shape[0] % 2 or y.shape[1] % 2):
            raise ValueError(f"nv12_resize takes an even (H, W) luma plane and an (H/2, W/2, "
                             f"2) chroma plane, got {tuple(y.shape)} and {tuple(uv.shape)}")
        ct, cl, ch, cw = crop
        if min(ct, cl) < 0 or ch <= 0 or cw <= 0 or ct + ch > y.shape[0] or cl + cw > y.shape[1]:
            raise ValueError(f"nv12_resize: crop {crop} is not inside a {tuple(y.shape)} plane")
    if device.type == "cpu":
        return resize_tiles_plain(tiles)
    if device.type != "cuda":
        raise ValueError(f"nv12_resize runs on CUDA or CPU tensors, not {device}")
    return _launch(tiles, device)


def resize_tiles_plain(tiles: Sequence[Tile]) -> List[torch.Tensor]:
    """The plain version, the eager chain: each tile's whole picture
    converted (`color_convert.nv12_to_rgba`), its crop resized by
    `resample.resize_matmul` (the plain route on the CPU), as f32."""
    out = []
    for (y, uv), (ct, cl, ch, cw), h, w in tiles:
        patch = color_convert.nv12_to_rgba(y, uv)[ct : ct + ch, cl : cl + cw]
        out.append(resample.resize_matmul(patch.permute(2, 0, 1), h, w).to(torch.float32))
    count_tiles(len(tiles))
    return out


def _bf16_step(v: torch.Tensor) -> torch.Tensor:
    """The bf16 step (2^-7 of the binade) at each |v| of an f64 tensor."""
    return torch.exp2(torch.floor(torch.log2(torch.clamp(v.abs(), min=2.0 ** -126))) - 7)


def _bf16_round(v: torch.Tensor) -> torch.Tensor:
    """An f64 tensor rounded to bf16 values, to nearest even, in f64."""
    step = _bf16_step(v)
    return torch.round(v / step) * step


def _exact_axis(n_in: int, n_out: int, device) -> Tuple[torch.Tensor, float]:
    """One axis's bf16 weights (the identity at an unchanged size) in f64,
    and the f32 error bound of a sum of its products, as a share of their
    absolute sum: n 2^-23 for n taps, taken twice (2^-22 n)."""
    if n_in == n_out:
        return torch.eye(n_in, dtype=torch.float64, device=device), 2.0 ** -22
    w = resample.to_bf16_values(torch.from_numpy(
        resample._dense_axis_weights(n_in, n_out, "lanczos3")))
    return w.to(device, torch.float64), 2.0 ** -22 * int((w != 0).sum(dim=1).max())


def gemm_route_bound(planes: Tuple[torch.Tensor, torch.Tensor], crop: Tuple[int, int, int, int],
                     out_h: int, out_w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """How far a tile's R, G and B from the pass may lie from the GEMM
    route's (`resample.resize_crop_cm` of `color_convert.nv12_to_rgba` on
    the planes' device), two routes that sum the same exact bf16 products
    in f32 in other orders: (`bound`, `tied`), (3, out_h, out_w) f64.

    Each route's f32 sum of n products lies within n 2^-23 of their
    absolute sum from their exact sum (taken twice here). Where that
    interval around a height pass's exact sum holds a bf16 rounding
    boundary (a tie), the routes may round it to neighbours one bf16 step
    apart, and the width pass carries that step times its weight into each
    output it reaches: `tied`, 0 where no tie reaches. `bound` adds the
    width pass's own f32 error on both routes and one bf16 step of the
    output (each route's last rounding): where `tied` is 0 it is the
    one-step limit. Exact sums in f64 (products of 16 significant bits)."""
    y, uv = planes
    ct, cl, ch, cw = crop
    dev = y.device
    x = color_convert.nv12_to_rgba(y, uv)[ct : ct + ch, cl : cl + cw, :3].permute(2, 0, 1)
    x = resample.to_bf16_values(x).to(torch.float64)
    wh, gh = _exact_axis(ch, out_h, dev)
    ww, gw = _exact_axis(cw, out_w, dev)
    exact = wh @ x
    err = gh * (wh.abs() @ x.abs())
    tie_step = torch.where(_bf16_round(exact - err) != _bf16_round(exact + err),
                           _bf16_step(exact.abs() + err), torch.zeros((), dtype=torch.float64,
                                                                       device=dev))
    height = _bf16_round(exact)
    tied = tie_step @ ww.abs().t()
    slack = 2.0 * gw * ((height.abs() + tie_step) @ ww.abs().t())
    return tied + slack + _bf16_step((height @ ww.t()).abs() + tied + slack), tied


def _launch(tiles: Sequence[Tile], device: torch.device) -> List[torch.Tensor]:
    for (y, uv), _, _, _ in tiles:
        if y.stride(1) != 1 or uv.stride(2) != 1 or uv.stride(1) != 2:
            raise ValueError(f"nv12_resize takes planes whose rows are adjacent bytes, got "
                             f"strides {y.stride()} and {uv.stride()}")
    planes = plan(tiles)
    geometry = grid_resize.plan_planes(planes, smem_bytes, SHARES)
    table = _device_table(planes, device)
    # every tile's four channel planes in one buffer, rows of a multiple of
    # PITCH floats, so that each row starts 32-byte aligned
    sizes = [(h, w, -(-w // PITCH) * PITCH) for _, _, h, w in tiles]
    ends = np.cumsum([4 * h * pitch for h, _, pitch in sizes]).tolist()
    buf = torch.empty(ends[-1], dtype=torch.float32, device=device)
    outs = [buf[e - 4 * h * pitch : e].view(4, h, pitch)[:, :, :w]
            for e, (h, w, pitch) in zip(ends, sizes)]
    conv = constants()
    lib = build.library()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for k0 in range(0, len(tiles), MAX_TILES):
            k1 = min(k0 + MAX_TILES, len(tiles))
            n = k1 - k0
            ptrs, ints = [], []
            for ((y, uv), (ct, cl, _, _), _, _), out in zip(tiles[k0:k1], outs[k0:k1]):
                ptrs += [y.data_ptr(), uv.data_ptr(), out.data_ptr()]
                ints += [y.stride(0), uv.stride(0), ct, cl, uv.shape[0], uv.shape[1],
                         out.stride(1), out.stride(0)]
            ptr_arr = (ctypes.c_void_p * (3 * n))(*ptrs)
            int_arr = (ctypes.c_int * (8 * n))(*ints)
            first_strip, n_strips, dims, smem = geometry.launch(k0, k1)
            blocks = min(n_strips,
                         grid_resize.blocks_per_sm(device, smem, "nv12_convert_resize") * sms)
            err = lib.smelter_nv12_convert_resize(
                ctypes.addressof(ptr_arr), ctypes.addressof(int_arr), n, conv.ctypes.data,
                table.data_ptr(), k0, first_strip, n_strips, *dims, smem, blocks, stream)
            build.check(err, "nv12_convert_resize launch")
            each_run(_count)
            count_tiles(n)
    return outs
