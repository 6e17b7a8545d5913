"""The tile converts' banded resize (`smelter_tpu_torch/ops/hopper/
tile_resize.py`) on the CPU: the kernel itself runs only on the card
(`tests/test_torch_cuda.py`, `-k tile_resize`), so these tests hold what
the CPU can reach of it.

  - bands: each of `color_convert.tile_weights`' four bf16 matrices is
    rebuilt exactly by its bands (an even crop, an odd and cropped window, a
    2x downscale, an upscale, an unchanged size, the multiview's two
    picture sizes at a tenth);
  - the kernel's blocks, mirrored in numpy from the table it reads
    (windows, k-tile ranges, shared memory, the bf16 rounding between the
    passes and none after them), against the plain version;
  - a run's YUV tiles gathered into one call (`compose._run_tile_products`)
    give the products each member gets alone, and the general program
    counts `program.general.tile_resize_planes`, 3 a YUV member each run;
  - the wrapper's checks.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smelter_tpu_torch import interop
from smelter_tpu_torch.core import types as tt
from smelter_tpu_torch.ops import color_convert as cc
from smelter_tpu_torch.ops import compose, resample
from smelter_tpu_torch.ops.hopper import grid_resize as gr
from smelter_tpu_torch.ops.hopper import tile_resize as tr
from smelter_tpu_torch.render.renderer import Renderer
from smelter_tpu_torch.scene import components
from smelter_tpu_torch.utils import tracing

torch.set_num_threads(2)

CPU = torch.device("cpu")
BENCH = Path(__file__).resolve().parents[1] / "benchmark"

# (luma (h, w), chroma (h, w), crop, out_h, out_w)
CASES = {
    "even": ((108, 192), (54, 96), (0, 0, 108, 192), 54, 96),
    "odd_cropped": ((270, 510), (135, 255), (3, 5, 250, 480), 156, 277),
    "downscale_2x": ((216, 384), (108, 192), (0, 0, 216, 384), 106, 188),
    "upscale": ((36, 64), (18, 32), (0, 0, 36, 64), 90, 160),
    "unchanged": ((36, 64), (18, 32), (0, 0, 36, 64), 36, 64),
    # the multiview's two picture sizes (bordered, shadowed) at a tenth
    "multiview_bordered": ((108, 192), (54, 96), (0, 0, 108, 192), 88, 156),
    "multiview_shadowed": ((108, 192), (54, 96), (0, 0, 108, 192), 95, 170),
}


def _dense_of_band(first: np.ndarray, weights: np.ndarray, n_in: int) -> np.ndarray:
    m = np.zeros((len(first), n_in), np.float32)
    for o, (f, w) in enumerate(zip(first, weights)):
        m[o, f : f + len(w)] = w
    return m


def _bf16_weights(case):
    return [w.to(torch.float32).numpy() for w in cc.tile_weights(*case, "lanczos3", CPU)]


@pytest.mark.parametrize("i", range(4), ids=["Wh", "Ww", "Wch", "Wcw"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bands_rebuild_each_tile_matrix(case, i):
    want = _bf16_weights(CASES[case])[i]
    first, weights = tr.tile_band(*CASES[case], "lanczos3", i)
    n_in = want.shape[1]
    assert first.dtype == np.int32 and weights.dtype == np.float32
    assert first.min() >= 0 and first.max() + weights.shape[1] <= n_in
    # no nonzero outside a band, and every weight of a band that is not the
    # matrix's is an exact zero
    np.testing.assert_array_equal(_dense_of_band(first, weights, n_in), want)
    spans = [np.flatnonzero(row)[[0, -1]] for row in want]
    assert weights.shape[1] == max(hi - lo + 1 for lo, hi in spans)


# -- the kernel's blocks, mirrored ---------------------------------------------


def _bf16(x: np.ndarray) -> np.ndarray:
    return resample.to_bf16_values(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _dense_tiles(table, at, n_tiles, tile, head, span, pad):
    """A block's weight tiles from the table as one dense (n_tiles * tile,
    pad) matrix over its window (as `test_torch_grid_resize.py` reads
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


def _mirror(tiles):
    """Each tile's products as the kernel's blocks write them, from the
    strip rows and weight tiles of the table it reads: each strip's window
    (rows from the band of its first row, columns from its first column's
    rounded down to 16, padded with zeros), its tiles' weights held to
    `tile_weights`' bf16 matrices over the window, its shared memory
    (within the launch's), f32 sums of exact products, rounded to bf16
    after the height pass and kept after the width pass. Asserts that every
    product is written once."""
    views, planes = tr.plane_views(tiles, "lanczos3")
    p = gr.plan_planes(planes)
    table = p.table
    outs = [np.full((h, w), np.nan, np.float32) for _, _, h, w in tiles for _ in range(3)]
    n = len(planes)
    for k0 in range(0, n, tr.MAX_PLANES):
        k1 = min(k0 + tr.MAX_PLANES, n)
        start, n_strips, dims, smem = p.launch(k0, k1)
        assert smem <= gr.SMEM_MAX
        for row in table[start * gr.STRIP_INTS : (start + n_strips) * gr.STRIP_INTS].reshape(
                n_strips, gr.STRIP_INTS):
            k, dst, y0, x0, rn, cn, sr0, hwin, xw0, wwin, hpad, wpad, kh, kw, h_at, w_at = row
            assert k0 <= k < k1 and dst == k and xw0 % 16 == 0
            assert hwin <= hpad <= dims[0] and wwin <= wpad <= dims[1]
            assert -(-rn // 16) * 16 <= dims[2]
            mt, nt = -(-rn // 16), -(-cn // 8)
            assert gr.H_HEAD + mt * 8 * (16 * kh + 8) <= dims[3]
            assert gr.W_HEAD + nt * 4 * (16 * kw + 8) <= dims[4]
            a = _dense_tiles(table, h_at, mt, 16, gr.H_HEAD, kh, hpad)
            bw = _dense_tiles(table, w_at, nt, 8, gr.W_HEAD, kw, wpad)
            (_, crop, th, tw) = tiles[k // 3]
            luma, chroma = tuple(tiles[k // 3][0][0].shape), tuple(tiles[k // 3][0][1].shape)
            mats = _bf16_weights((luma, chroma, crop, th, tw))
            wr, wc = mats[0:2] if k % 3 == 0 else mats[2:4]
            for dense, want, o0, m, w0, win in ((a, wr, y0, rn, sr0, hwin),
                                                (bw, wc, x0, cn, xw0, wwin)):
                assert not want[o0 : o0 + m, :w0].any() and not want[o0 : o0 + m, w0 + win :].any()
                np.testing.assert_array_equal(dense[:m, :win], want[o0 : o0 + m, w0 : w0 + win])
                assert not dense[:m, win:].any() and not dense[m:].any()
            src = views[k].numpy()
            assert sr0 + hwin <= src.shape[0] and xw0 + wwin <= src.shape[1]
            s = np.zeros((hpad, wpad), np.float64)
            s[:hwin, :wwin] = src[sr0 : sr0 + hwin, xw0 : xw0 + wwin]
            t = _bf16((a.astype(np.float64) @ s).astype(np.float32)).astype(np.float64)
            o = (t @ bw.astype(np.float64).T).astype(np.float32)[:rn, :cn]
            assert np.isnan(outs[k][y0 : y0 + rn, x0 : x0 + cn]).all()
            outs[k][y0 : y0 + rn, x0 : x0 + cn] = o
    assert not any(np.isnan(o).any() for o in outs)
    return outs


def _planes(luma_hw, chroma_hw, seed: int):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randint(0, 256, s, dtype=torch.uint8, generator=gen)
                 for s in (luma_hw, chroma_hw, chroma_hw))


def _tiles(names, seed: int):
    return [(_planes(CASES[c][0], CASES[c][1], seed + k), *CASES[c][2:])
            for k, c in enumerate(names)]


# tile lists of one call: the multiview at a tenth, odd shapes, and more tile
# planes than a launch takes
CALLS = {
    "multiview": ["multiview_bordered", "multiview_shadowed"] * 8,
    "odd_cropped": ["odd_cropped"],
    "upscale_unchanged": ["upscale", "unchanged", "even"],
    "two_launches": ["unchanged"] * 44,
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_kernel_blocks_mirror_the_plain_version(call):
    tiles = _tiles(CALLS[call], seed=len(call))
    got = _mirror(tiles)
    want = [p.numpy() for t in tr.resize_tiles_plain(tiles) for p in t]
    assert len(got) == len(want) == 3 * len(tiles)
    for k, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        d = np.abs(a - b)
        # both sum exact products in f32, in other orders: the products
        # agree to f32 rounding, but where the height pass's sum lies at a
        # bf16 tie the two may round it to neighbours (256 apart at most a
        # step of 1 at the top of the u8 range), which moves the width
        # pass's sums by less than a step, on a few samples of 10,000
        near = d <= 1e-4 * np.maximum(np.abs(b), 1.0)
        assert d.max() < 1.0 and (~near).sum() <= max(1, d.size // 10000), (
            call, k, float(d.max()), int((~near).sum()))


# -- the run's gathering and the program's counter -------------------------------


def _layout(content, k, rect, crop=None, rotation=None):
    st = compose.LayoutStatic(content=content, source_index=k if content == "texture" else -1,
                              static_rect=rect, static_crop=crop, static_rotation=rotation,
                              has_rotation=rotation is not None)
    top, left, h, w = rect
    p = interop.layout_params(dict(
        top=top, left=left, width=w, height=h, rotation_degrees=rotation or 0.0,
        border_radius=(0, 0, 0, 0), border_width=0, border_color=(0, 0, 0, 0),
        color=(0.2, 0.3, 0.4, 1.0), crop=(0, 0, 0, 0), blur_radius=0,
        masks=np.zeros((0, 9))), "cpu")
    return st, p


def test_a_runs_tiles_take_one_call_and_the_products_each_member_gets_alone(monkeypatch):
    sources = [cc.DeferredYuvSource(*_planes((108, 192), (54, 96), seed=k)) for k in range(3)]
    rgba = torch.rand((54, 96, 4))
    sources.append(rgba)
    groups = [
        ([_layout("color", 0, (0, 0, 40, 60)), _layout("texture", 0, (4, 6, 30, 50),
                                                       (0, 0, 108, 192))], None, 0),
        ([_layout("texture", 3, (50, 0, 20, 30), (0, 0, 54, 96)),
          _layout("texture", 1, (50, 40, 30, 44), (3, 5, 100, 180)),
          _layout("texture", 2, (90, 0, 40, 64), (0, 0, 108, 192), rotation=20.0),
          _layout("texture", 2, (90, 80, 28, 48), (2, 4, 90, 150))], None, 2),
    ]
    calls = []
    orig = tr.resize_tiles
    monkeypatch.setattr(tr, "resize_tiles", lambda tiles: calls.append(len(tiles)) or orig(tiles))
    got = compose._run_tile_products(groups, sources)
    # the YUV tiles of both groups in one call; not the RGBA nor the rotated tile
    assert calls == [3]
    assert [sorted(g) for g in got] == [[1], [1, 3]]
    for (members, _, _), products in zip(groups, got):
        for m, planes in products.items():
            st = members[m][0]
            alone = sources[st.source_index].tile_products(st.static_crop, *st.static_rect[2:])
            for a, b in zip(planes, alone):
                assert a.dtype == torch.float32 and torch.equal(a, b)


def _multiview_renderer(n: int):
    spec = importlib.util.spec_from_file_location("test_tile_resize_scene",
                                                  BENCH / "scenes" / "multiview.py")
    scene = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(scene)
    cfg = {**json.loads((BENCH / "configs" / "multiview16_4k.json").read_text()),
           "inputs": n, "input_width": 192, "input_height": 108,
           "output_width": 768, "output_height": 432}
    r = Renderer(device="cpu")
    ids = [f"input_{i}" for i in range(n)]
    for iid in ids:
        r.register_input(iid)
    r.update_scene("out", scene.build(SimpleNamespace(comp=components, types=tt), cfg, 0, "out"),
                   tt.Resolution(768, 432), tt.PixelFormat.PLANAR_YUV420)
    frames = {iid: tt.Frame(data=_planes((108, 192), (54, 96), seed=k),
                            format=tt.PixelFormat.PLANAR_YUV420,
                            resolution=tt.Resolution(192, 108), pts=0.0)
              for k, iid in enumerate(ids)}
    return r, frames


@pytest.mark.parametrize("n", [16, 5])
def test_the_general_program_counts_three_planes_a_yuv_member_each_run(n):
    r, frames = _multiview_renderer(n)
    r.render(tt.FrameSet(pts=0.0, frames=frames))  # the capture
    tracing.reset()
    try:
        for k in range(1, 4):
            r.render(tt.FrameSet(pts=k / 32, frames=frames))
        c = tracing.counters()
    finally:
        tracing.reset()
    assert c["program.calls.general"] == 3
    assert c["program.general.tile_converts"] == 3 * n
    assert c["program.general.tile_resize_planes"] == 3 * 3 * n


# -- the wrapper ------------------------------------------------------------------


def test_a_cpu_call_runs_the_plain_version_and_launches_nothing():
    tiles = _tiles(["odd_cropped", "upscale"], seed=5)
    before = tr.LAUNCHES
    got = tr.resize_tiles(tiles)
    assert tr.LAUNCHES == before
    for (planes, crop, h, w), products in zip(tiles, got):
        alone = cc.yuv_tile_products(*planes, crop, h, w)
        assert all(torch.equal(a, b) and a.shape == (h, w) for a, b in zip(products, alone))
    assert tr.resize_tiles([]) == []


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    (y, u, v), crop, h, w = _tiles(["even"], seed=1)[0]
    with pytest.raises(ValueError, match="u8"):
        tr.resize_tiles([((y.to(torch.float32), u, v), crop, h, w)])
    with pytest.raises(ValueError, match="planes on"):
        tr.resize_tiles([((y, u.to("meta"), v), crop, h, w)])
    with pytest.raises(ValueError, match="no tile"):
        tr.resize_tiles([((y, u, v), crop, 0, w)])
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tr.resize_tiles([((y.to("meta"), u.to("meta"), v.to("meta")), crop, h, w)])
    with pytest.raises(ValueError, match="not inside"):
        tr.plane_views([((y, u, v), (4, 0, 108, 192), h, w)], "lanczos3")
    with pytest.raises(ValueError, match="differ"):
        tr.plane_views([((y, u, v[:-1]), crop, h, w)], "lanczos3")
