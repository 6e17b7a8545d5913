"""The fused NV12 convert-and-resize pass (`smelter_tpu_torch/ops/hopper/
nv12_resize.py`) on the CPU: the kernel itself runs only on the card
(`tests/test_torch_cuda.py`, `-k nv12`), so these tests hold what the CPU
can reach of it.

  - a deferred NV12 source's tile (`DeferredNv12Source.tile_cm`) on the
    CPU is the eager chain bit for bit (the whole picture converted, its
    crop resized by `resize_matmul`), at the cell's small size, at an odd
    crop, and past the strips' reach, which the card's pass refuses;
  - the kernel's strips, mirrored in numpy from the table it reads: each
    strip's weight tiles held to `resize_matmul`'s bf16 matrices over its
    window, its chroma window (the halo the kernel copies) inside the
    plane and its shared memory, its window's conversion, in the kernel's
    order of operations and from the kernel's window copies, equal bit for
    bit to the eager chain's picture computed as the card computes it, and
    the resized products within a bf16 step of the plain version;
  - a run's NV12 tiles gathered into one call (`compose._run_tile_products`);
  - one input feeding a static tile and a sampled layout converts its
    picture once (`program.general.rgba_converts` 1), and the frame equals
    the parent's route, the source as a mip list, bit for bit;
  - the wrapper's checks.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smelter_tpu_torch import interop
from smelter_tpu_torch.core.types import PixelFormat
from smelter_tpu_torch.ops import color_convert as cc
from smelter_tpu_torch.ops import compose, resample
from smelter_tpu_torch.ops.hopper import grid_resize as gr
from smelter_tpu_torch.ops.hopper import nv12_resize as nr
from smelter_tpu_torch.utils import tracing

torch.set_num_threads(2)

# (luma (h, w), crop, out_h, out_w)
CASES = {
    # the cell's small size: 192x108 inputs into tiles of 96x54
    "cell_small": ((108, 192), (0, 0, 108, 192), 54, 96),
    "odd_crop": ((120, 214), (3, 5, 101, 177), 37, 61),
    "edge_crop": ((108, 192), (3, 7, 105, 185), 40, 70),
    "upscale": ((36, 64), (0, 0, 36, 64), 90, 160),
    "unchanged": ((36, 64), (0, 0, 36, 64), 36, 64),
    "rows_only": ((48, 80), (2, 0, 44, 80), 30, 80),
}


def _nv12(hw, seed: int):
    gen = torch.Generator().manual_seed(seed)
    h, w = hw
    return (torch.randint(0, 256, (h, w), dtype=torch.uint8, generator=gen),
            torch.randint(0, 256, (h // 2, w // 2, 2), dtype=torch.uint8, generator=gen))


def _tiles(names, seed: int):
    return [(_nv12(CASES[c][0], seed + k), *CASES[c][1:]) for k, c in enumerate(names)]


def _chain(planes, crop, h, w):
    """The parent's route: the whole picture converted, the crop resized."""
    return resample.resize_crop_cm(cc.convert_to_rgba_f32(PixelFormat.NV12.value, planes), crop,
                                   h, w)


def _counters(fn):
    tracing.reset()
    try:
        out = fn()
        return out, tracing.counters()
    finally:
        tracing.reset()


@pytest.mark.parametrize("case", ["cell_small", "odd_crop", "past_the_strips"])
def test_tile_cm_on_the_cpu_is_the_eager_chain(case):
    """Bit for bit, and counted: a tile counts one `nv12_tiles` and
    converts no full-resolution picture, also past the strips' reach (a
    27x downscale, which the card's pass refuses: its plan has no strip)."""
    if case == "past_the_strips":
        hw, crop, h, w = (432, 768), (0, 0, 432, 768), 16, 28
        with pytest.raises(ValueError, match="shared memory"):
            gr.plan_planes(nr.plan([(None, crop, h, w)]), nr.smem_bytes, nr.SHARES)
    else:
        hw, crop, h, w = CASES[case]
        gr.plan_planes(nr.plan([(None, crop, h, w)]), nr.smem_bytes, nr.SHARES)
    planes = _nv12(hw, seed=len(case))
    src = cc.DeferredNv12Source(*planes, mip_levels=3)
    got, c = _counters(lambda: src.tile_cm(crop, h, w))
    want = _chain(planes, crop, h, w)
    assert got.dtype == torch.float32 and got.shape == (4, h, w)
    assert torch.equal(got, want)
    assert c == {"program.general.nv12_tiles": 1}
    # no conversion happened: mips() would build it now, and count it
    _, c = _counters(src.mips)
    assert c["program.general.rgba_converts"] == 1


# -- the kernel's strips, mirrored ---------------------------------------------


def _bf16(x) -> np.ndarray:
    return resample.to_bf16_values(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _dense_tiles(table, at, n_tiles, tile, head, span, pad):
    """A block's weight tiles from the table as one dense (n_tiles * tile,
    pad) matrix over its window (as `test_torch_tile_resize.py` reads
    them)."""
    pitch = 16 * span + 8
    kt0, spans = table[at : at + n_tiles], table[at + head // 2 : at + head // 2 + n_tiles]
    data = table[at + head : at + head + n_tiles * tile * pitch // 2].view(np.uint16)
    data = data.reshape(n_tiles, tile, pitch)
    dense = np.zeros((n_tiles * tile, pad), np.float32)
    for t, (k, n) in enumerate(zip(kt0, spans)):
        assert 0 <= k and 0 < n <= span and 16 * (k + n) <= pad
        assert not data[t, :, 16 * n :].any()
        w = (data[t, :, : 16 * n].astype(np.uint32) << 16).view(np.float32)
        dense[t * tile : (t + 1) * tile, 16 * k : 16 * (k + n)] = w
    return dense


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """`resize_matmul`'s bf16 weights of an axis; the identity where it
    skips the axis."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    return _bf16(resample._dense_axis_weights(n_in, n_out, "lanczos3"))


def _window(r0, x0, hwin, wwin, c_rows, c_cols):
    """The kernel's chroma window (`Window` in csrc/nv12_convert_resize.cu):
    first chroma row, rows, first byte (a multiple of 16), bytes."""
    c0 = max((r0 - 1) >> 1, 0)
    c_n = min(max((r0 + hwin - 2) >> 1, 0) + 1, c_rows - 1) - c0 + 1
    b0 = (2 * max((x0 - 1) >> 1, 0)) & ~15
    b_n = 2 * min(max((x0 + wwin - 2) >> 1, 0) + 1, c_cols - 1) + 2 - b0
    return c0, c_n, b0, b_n


def _convert(ywin, uvwin, r0, x0, c0, b0, c_rows, c_cols, k):
    """The kernel's `convert_window` in numpy f32 (each operation rounded
    on its own): (3, rows, columns) R, G, B of the window's pixels, from
    its luma window and its chroma window's bytes."""
    f32 = np.float32
    inv255, foot, inv_y, inv_uv, r_v, g_u, g_v, b_u = (f32(x) for x in k)
    j = r0 + np.arange(ywin.shape[0])[:, None]
    col = x0 + np.arange(ywin.shape[1])[None, :]
    i0 = np.maximum((j - 1) >> 1, 0)
    i1 = np.minimum(i0 + 1, c_rows - 1)
    f1 = np.where(j & 1, f32(0.25), f32(0.75)).astype(f32)
    f0 = f32(1.0) - f1
    k0 = np.maximum((col - 1) >> 1, 0)
    k1 = np.minimum(k0 + 1, c_cols - 1)
    g1 = np.where(col & 1, f32(0.25), f32(0.75)).astype(f32)
    g0 = f32(1.0) - g1
    c = uvwin.astype(f32) * inv255

    def up(p):
        o0, o1 = 2 * k0 - b0 + p, 2 * k1 - b0 + p
        a = c[i0 - c0, o0] * f0 + c[i1 - c0, o0] * f1
        b = c[i0 - c0, o1] * f0 + c[i1 - c0, o1] * f1
        return a * g0 + b * g1

    yf = ywin.astype(f32) * inv255
    yl = np.clip((yf - foot) * inv_y, f32(0), f32(1))
    u = np.clip((up(0) - foot) * inv_uv, f32(0), f32(1)) - f32(0.5)
    v = np.clip((up(1) - foot) * inv_uv, f32(0), f32(1)) - f32(0.5)
    rgb = [yl + r_v * v, yl - g_u * u - g_v * v, yl + b_u * u]
    return np.stack([np.clip(x, f32(0), f32(1)) for x in rgb])


def _card_picture(planes, k) -> np.ndarray:
    """The eager chain's (H, W, 4) picture as the card computes it: PyTorch
    divides a CUDA tensor by a scalar as a product by the f32 reciprocal
    (`nv12_resize.constants`), which `_expand_range` does here too."""
    inv_y, inv_uv = float(k[2]), float(k[3])

    def expand(y, u, v):
        return (torch.clamp((y - cc._FOOTROOM) * inv_y, 0.0, 1.0),
                torch.clamp((u - cc._FOOTROOM) * inv_uv, 0.0, 1.0),
                torch.clamp((v - cc._FOOTROOM) * inv_uv, 0.0, 1.0))

    orig = cc._expand_range
    cc._expand_range = expand
    try:
        return cc.nv12_to_rgba(*planes).numpy()
    finally:
        cc._expand_range = orig


def _mirror(tiles):
    """Each tile's (4, h, w) products as the kernel's blocks write them, from
    the strip rows and weight tiles of the table it reads, asserting on the
    way what the kernel relies on (see the module's docstring). Asserts
    that every product is written once."""
    planes = nr.plan(tiles)
    p = gr.plan_planes(planes, nr.smem_bytes, nr.SHARES)
    table, k = p.table, nr.constants()
    pictures = [_card_picture(t[0], k) for t in tiles]
    outs = [np.full((4, h, w), np.nan, np.float32) for _, _, h, w in tiles]
    for k0 in range(0, len(tiles), nr.MAX_TILES):
        k1 = min(k0 + nr.MAX_TILES, len(tiles))
        start, n_strips, dims, smem = p.launch(k0, k1)
        assert smem == nr.smem_bytes(*dims) <= gr.SMEM_MAX
        for row in table[start * gr.STRIP_INTS : (start + n_strips) * gr.STRIP_INTS].reshape(
                n_strips, gr.STRIP_INTS):
            t, dst, y0, x0, rn, cn, sr0, hwin, xw0, wwin, hpad, wpad, kh, kw, h_at, w_at = row
            assert k0 <= t < k1 and dst == t and xw0 % 16 == 0
            assert hwin <= hpad <= dims[0] and wwin <= wpad <= dims[1]
            mt, nt = -(-rn // 16), -(-cn // 8)
            assert gr.H_HEAD + mt * 8 * (16 * kh + 8) <= dims[3]
            assert gr.W_HEAD + nt * 4 * (16 * kw + 8) <= dims[4]
            (y, uv), (ct, cl, ch, cw), th, tw = tiles[t]
            a = _dense_tiles(table, h_at, mt, 16, gr.H_HEAD, kh, hpad)
            bw = _dense_tiles(table, w_at, nt, 8, gr.W_HEAD, kw, wpad)
            for dense, want, o0, m, w0, win in ((a, _resize_matrix(ch, th), y0, rn, sr0, hwin),
                                                (bw, _resize_matrix(cw, tw), x0, cn, xw0, wwin)):
                assert not want[o0 : o0 + m, :w0].any() and not want[o0 : o0 + m, w0 + win :].any()
                np.testing.assert_array_equal(dense[:m, :win], want[o0 : o0 + m, w0 : w0 + win])
                assert not dense[:m, win:].any() and not dense[m:].any()
            # the windows the kernel copies: inside the planes, and inside
            # the shared memory the launch has for them
            r0, xa = ct + sr0, cl + xw0
            assert r0 + hwin <= ct + ch and xa + wwin <= cl + cw
            c_rows, c_cols = uv.shape[:2]
            c0, c_n, b0, b_n = _window(r0, xa, hwin, wwin, c_rows, c_cols)
            assert c_n <= hpad // 2 + 2 and -(-b_n // 16) * 16 <= wpad + 32
            assert c0 + c_n <= c_rows and b0 + b_n <= 2 * c_cols
            ywin = y.numpy()[r0 : r0 + hwin, xa : xa + wwin]
            uvwin = uv.numpy().reshape(c_rows, 2 * c_cols)[c0 : c0 + c_n, b0 : b0 + b_n]
            rgb = _convert(ywin, uvwin, r0, xa, c0, b0, c_rows, c_cols, k)
            np.testing.assert_array_equal(
                rgb, pictures[t][r0 : r0 + hwin, xa : xa + wwin, :3].transpose(2, 0, 1))
            s = np.zeros((4, hpad, wpad), np.float64)
            s[:3, :hwin, :wwin] = _bf16(rgb)
            s[3] = 1.0  # alpha: a window of ones
            tt = _bf16((a.astype(np.float64) @ s).astype(np.float32)).astype(np.float64)
            o = _bf16((tt @ bw.astype(np.float64).T).astype(np.float32))[:, :rn, :cn]
            assert np.isnan(outs[t][:, y0 : y0 + rn, x0 : x0 + cn]).all()
            outs[t][:, y0 : y0 + rn, x0 : x0 + cn] = o
    assert not any(np.isnan(o).any() for o in outs)
    return outs


# tile lists of one call: the cell's 16 tiles at its small size, odd shapes,
# an identity and an upscale, and more tiles than a launch takes
CALLS = {
    "cell_small": ["cell_small"] * 16,
    "odd_and_edges": ["odd_crop", "edge_crop", "rows_only"],
    "upscale_unchanged": ["upscale", "unchanged"],
    "two_launches": ["unchanged"] * (nr.MAX_TILES + 1),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_kernel_strips_mirror_the_plain_version(call):
    tiles = _tiles(CALLS[call], seed=len(call))
    got = _mirror(tiles)
    want = [t.numpy() for t in nr.resize_tiles_plain(tiles)]
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        # alpha: the weights' sums, rounded as the GEMMs round them
        np.testing.assert_array_equal(a[3], b[3])
        # the colour: the same bf16 operands but where the card's product by
        # the reciprocal and the CPU's division round an f32 apart across a
        # bf16 tie, and sums of other orders rounded to bf16: a bf16 step at
        # most, or a few f32 steps of 1 where the BT.709 matrix cancels to
        # nearly 0
        d = np.abs(a - b)
        step = np.maximum(2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 2.0 ** -40))) - 7),
                          2.0 ** -20)
        assert (d <= step).all(), (call, k, float((d / step).max()))
        assert (d > 0).mean() < 0.01, (call, k, float((d > 0).mean()))


# -- the bound the card's pass is held to against the GEMM route -----------------


def _rz(v: torch.Tensor) -> torch.Tensor:
    """f32 values cut to bf16 toward zero (a faulty rounding)."""
    return (v.view(torch.int32) & ~0xFFFF).view(torch.float32)


def _axis64(n_in: int, n_out: int) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(n_in, n_out)).to(torch.float64)


def _route(planes, crop, h, w, kind):
    """R, G and B of a tile by another route than `resize_matmul`: "serial"
    sums each pass's products one by one in f32, last tap first, each pass
    rounded to bf16; "flipped" sums exactly and rounds each height-pass sum
    that lies within its f32 error (2^-22 n of the absolute sum) of a bf16
    rounding boundary to the neighbour across it, as another order of f32
    sums may; "truncated" is "serial" with the height pass cut toward zero,
    a faulty kernel's rounding."""
    ct, cl, ch, cw = crop
    x = resample.to_bf16_values(cc.nv12_to_rgba(*planes)[ct : ct + ch, cl : cl + cw, :3]
                                .permute(2, 0, 1))
    wh, ww = _axis64(ch, h), _axis64(cw, w)
    if kind == "flipped":
        x = x.to(torch.float64)
        exact = wh @ x
        err = 2.0 ** -22 * int((wh != 0).sum(1).max()) * (wh.abs() @ x)
        lo, mid, hi = (nr._bf16_round(v) for v in (exact - err, exact, exact + err))
        height = torch.where(lo == hi, mid, torch.where(mid == lo, hi, lo))
        return nr._bf16_round(height @ ww.t())
    cut = _rz if kind == "truncated" else resample.to_bf16_values
    wh, ww = wh.to(torch.float32), ww.to(torch.float32)
    height = torch.zeros(3, h, cw)
    for k in reversed(range(ch)):
        height = height + wh[:, k][None, :, None] * x[:, k][:, None, :]
    height = cut(height)
    out = torch.zeros(3, h, w)
    for k in reversed(range(cw)):
        out = out + height[:, :, k][:, :, None] * ww[:, k][None, None, :]
    return resample.to_bf16_values(out)


@pytest.mark.parametrize("case", ["cell_small", "odd_crop", "edge_crop", "upscale"])
def test_the_gemm_route_bound_holds_for_sound_routes_and_not_a_faulty_one(case):
    """`gemm_route_bound`, which the card's pass is held to: another order
    of f32 sums, and the worst it may do, the height pass's ties all
    rounded the other way, stay inside it, and beyond the one-step limit
    only where a tie reaches; a height pass cut toward zero leaves it."""
    for seed in range(2):
        (planes, crop, h, w), = _tiles([case], seed=seed)
        want = resample.resize_crop_cm(cc.nv12_to_rgba(*planes), crop, h, w)[:3].double()
        bound, tied = nr.gemm_route_bound(planes, crop, h, w)
        assert bound.shape == tied.shape == (3, h, w) and bool((tied >= 0).all())
        for kind in ("serial", "flipped"):
            d = (_route(planes, crop, h, w, kind).double() - want).abs()
            assert bool((d <= bound).all()), (kind, float((d / bound).max()))
            assert bool((tied[d > bound - tied] > 0).all())
        d = (_route(planes, crop, h, w, "truncated").double() - want).abs()
        assert int((d > bound).sum()) > 0


def test_the_plan_follows_the_strip_shapes_shared_memory():
    """The cell's geometry (1080p into 540x960) takes strips of 16 x 64 at
    two blocks an SM: each strip's shared memory, by the kernel's layout,
    within half an SM's; a 27x downscale has no strip; an unchanged size
    has the widest."""
    crop = (0, 0, 1080, 1920)
    r, c, hb, wb = gr.strip_shape(*nr._bands(crop, 540, 960), nr.smem_bytes, nr.SHARES)
    assert (r, c) == (16, 64)
    assert nr.smem_bytes(*gr._dims(hb, wb)) <= gr.SMEM_SM // 2 - gr.SMEM_RESERVED
    with pytest.raises(ValueError, match="shared memory"):
        gr.plan_planes(nr.plan([(None, (0, 0, 432, 768), 16, 28)]), nr.smem_bytes, nr.SHARES)
    assert gr.strip_shape(*nr._bands(crop, 1080, 1920), nr.smem_bytes, nr.SHARES)[:2] == (32, 128)
    # the grid's and the tile converts' plans are unchanged by the options
    planes = ((( gr.axis_band, 1080, 540), (gr.axis_band, 1920, 960), 0, 0, 0),)
    assert np.array_equal(gr.plan_planes(planes).table,
                          gr.plan_planes(planes, gr.smem_bytes, (3, 2, 1)).table)


# -- the run's gathering, the program's counters -------------------------------


def _layout(content, k, rect, crop=None, rotation=None):
    st = compose.LayoutStatic(content=content, source_index=k if content == "texture" else -1,
                              static_rect=rect, static_crop=crop, static_rotation=rotation,
                              has_rotation=rotation is not None)
    top, left, h, w = rect or (0, 0, 0, 0)
    p = interop.layout_params(dict(
        top=top, left=left, width=w, height=h, rotation_degrees=rotation or 0.0,
        border_radius=(0, 0, 0, 0), border_width=0, border_color=(0, 0, 0, 0),
        color=(0.2, 0.3, 0.4, 1.0), crop=(0, 0, 0, 0), blur_radius=0,
        masks=np.zeros((0, 9))), "cpu")
    return st, p


def test_a_runs_nv12_tiles_take_one_call(monkeypatch):
    sources = [cc.DeferredNv12Source(*_nv12((108, 192), seed=k)) for k in range(3)]
    groups = [
        ([_layout("color", 0, (0, 0, 40, 60)), _layout("texture", 0, (4, 6, 30, 50),
                                                       (0, 0, 108, 192))], None, 0),
        ([_layout("texture", 1, (50, 40, 30, 44), (3, 5, 100, 180)),
          _layout("texture", 2, (90, 0, 40, 64), (0, 0, 108, 192), rotation=20.0),
          _layout("texture", 2, (90, 80, 28, 48), (2, 4, 90, 150))], None, 2),
    ]
    calls = []
    orig = nr.resize_tiles
    monkeypatch.setattr(nr, "resize_tiles", lambda tiles: calls.append(len(tiles)) or orig(tiles))
    got = compose._run_tile_products(groups, sources)
    # both groups' upright NV12 tiles in one call; not the rotated tile
    assert calls == [3]
    assert [sorted(g) for g in got] == [[1], [0, 2]]
    for (members, _, _), products in zip(groups, got):
        for m, (rgba,) in products.items():
            st = members[m][0]
            alone = sources[st.source_index].tile_cm(st.static_crop, *st.static_rect[2:])
            assert torch.equal(rgba, alone)


def test_a_static_tile_and_a_sampled_layout_of_one_input_convert_it_once():
    """One NV12 input shown as a static tile (the fused pass) and as a
    layout with no static rect (the sampled pass, which reads the mips):
    the picture is converted once, with its mip levels, and the canvas
    equals the parent's route (the input as a mip list) bit for bit."""
    planes = _nv12((108, 192), seed=9)
    statics, params = zip(_layout("texture", 0, (10, 20, 54, 96), (0, 0, 108, 192)),
                          _layout("texture", 0, (60, 100, 40, 70), (0, 0, 108, 192)))
    statics = (statics[0], compose.LayoutStatic(
        content="texture", source_index=0, static_rect=None, static_crop=None))

    def canvas(src):
        return compose.compose_layouts((192, 128), statics, params, [src], planar=True,
                                       device="cpu")

    got, c = _counters(lambda: canvas(cc.DeferredNv12Source(*planes, mip_levels=3)))
    assert c["program.general.nv12_tiles"] == 1
    assert c["program.general.rgba_converts"] == 1 and c["program.general.mip_levels"] == 2
    want = canvas(resample.build_mips(cc.convert_to_rgba_f32(PixelFormat.NV12.value, planes), 3))
    assert torch.equal(got, want)


# -- the wrapper -------------------------------------------------------------------


def test_a_cpu_call_launches_nothing_and_counts_its_tiles():
    tiles = _tiles(["odd_crop", "upscale"], seed=5)
    before = nr.LAUNCHES
    got, c = _counters(lambda: nr.resize_tiles(tiles))
    assert nr.LAUNCHES == before and c == {"program.general.nv12_tiles": 2}
    for (planes, crop, h, w), rgba in zip(tiles, got):
        assert torch.equal(rgba, _chain(planes, crop, h, w))
    assert nr.resize_tiles([]) == []


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    (y, uv), crop, h, w = _tiles(["cell_small"], seed=1)[0]
    with pytest.raises(ValueError, match="u8 planes"):
        nr.resize_tiles([((y.to(torch.float32), uv), crop, h, w)])
    with pytest.raises(ValueError, match="u8 planes"):
        nr.resize_tiles([((y, uv.to("meta")), crop, h, w)])
    with pytest.raises(ValueError, match="no tile"):
        nr.resize_tiles([((y, uv), crop, 0, w)])
    with pytest.raises(ValueError, match="chroma plane"):
        nr.resize_tiles([((y, uv[:-1]), crop, h, w)])
    with pytest.raises(ValueError, match="chroma plane"):
        nr.resize_tiles([((y[:-1], uv), crop, h, w)])
    with pytest.raises(ValueError, match="not inside"):
        nr.resize_tiles([((y, uv), (4, 0, 108, 192), h, w)])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        nr.resize_tiles([((y.to("meta"), uv.to("meta")), crop, h, w)])
