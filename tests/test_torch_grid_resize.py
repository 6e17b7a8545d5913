"""The banded resize of the YUV grid program (`smelter_tpu_torch/ops/hopper/
grid_resize.py`) on the CPU: the kernel itself runs only on the card
(`tests/test_torch_cuda.py`, `-k grid_resize`), so these tests hold what
the CPU can reach of it.

  - bands: every nonzero of the GEMM route's bf16 matrix lies in its row's
    band and the padding is exact zeros; an unchanged axis is one tap of 1;
    a banded product equals the dense one bit for bit when the f32 sums are
    taken in the same order (clipped edges, an upscale, a 1:1 axis);
  - the launch plan: tiles that partition the canvas or are disjoint take
    one launch, overlapping tiles one launch each in paint order;
  - the kernel's blocks, mirrored in numpy from the table the kernel reads
    (windows, k-tile ranges, shared memory, rounding), against the plain
    version at small sizes of the cells' geometries, a cropped, an
    upscaled, an odd-width, an odd-sized source's and an overlapping
    layout;
  - the wrapper's checks, and the grid program's `program.grid.tile_planes`;
  - no module under `smelter_tpu_torch/ops/` imports `smelter_tpu_torch.
    parallel`: the grid's helpers live here, below `parallel/flagship.py`.
"""

from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from smelter_tpu_torch.core import types as tt
from smelter_tpu_torch.ops import resample
from smelter_tpu_torch.ops.hopper import grid_resize as gr
from smelter_tpu_torch.render.renderer import Renderer, RendererOptions
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.utils import tracing

torch.set_num_threads(2)

CPU = torch.device("cpu")
AXES = [(1080, 540), (1920, 960), (540, 270), (960, 480), (1920, 854), (960, 427),
        (36, 90), (100, 250), (7, 3), (270, 135), (511, 255), (2, 6)]


def _bf16_matrix(n_in: int, n_out: int) -> np.ndarray:
    dense = resample._dense_axis_weights(n_in, n_out, "lanczos3")
    return resample.to_bf16_values(torch.from_numpy(dense)).numpy()


def _dense_of_band(first: np.ndarray, weights: np.ndarray, n_in: int) -> np.ndarray:
    m = np.zeros((len(first), n_in), np.float32)
    for o, (f, w) in enumerate(zip(first, weights)):
        m[o, f : f + len(w)] = w
    return m


@pytest.mark.parametrize("n_in,n_out", AXES)
def test_band_holds_every_nonzero_of_the_bf16_matrix(n_in, n_out):
    first, weights = gr.axis_band(n_in, n_out)
    dense = _bf16_matrix(n_in, n_out)
    taps = weights.shape[1]
    assert first.dtype == np.int32 and weights.dtype == np.float32
    assert first.min() >= 0 and first.max() + taps <= n_in
    assert np.all(np.diff(first) >= 0)
    # the band rebuilds the matrix exactly: no nonzero outside it, and every
    # weight of the band that is not the matrix's is an exact zero
    np.testing.assert_array_equal(_dense_of_band(first, weights, n_in), dense)
    spans = [np.flatnonzero(row)[[0, -1]] for row in dense]
    assert taps == max(hi - lo + 1 for lo, hi in spans)
    if n_in == 2 * n_out and n_in >= 24:
        assert taps == 12  # a 2x downscale reads 12 samples a row
    if n_out >= 2 * n_in and n_in >= 6:
        assert taps == 6  # an upscale 6


def test_unchanged_axis_is_one_tap_of_one():
    first, weights = gr.axis_band(64, 64)
    np.testing.assert_array_equal(first, np.arange(64))
    np.testing.assert_array_equal(weights, np.ones((64, 1), np.float32))


def _sequential(m: np.ndarray, cols: np.ndarray, x: np.ndarray) -> np.ndarray:
    """sum_k m[:, k] * x[cols[:, k]] in f32, one product and one sum at a time
    in the order of k."""
    acc = np.zeros((m.shape[0], x.shape[1]), np.float32)
    for k in range(m.shape[1]):
        acc = (acc + m[:, k : k + 1] * x[cols[:, k]]).astype(np.float32)
    return acc


@pytest.mark.parametrize("n_in,n_out", [(1080, 540), (100, 250), (7, 3), (511, 255), (2, 6)])
def test_banded_product_equals_dense_in_the_same_order(n_in, n_out):
    rng = np.random.default_rng(n_in * 1000 + n_out)
    x = rng.integers(0, 256, (n_in, 5)).astype(np.float32)
    first, weights = gr.axis_band(n_in, n_out)
    dense = _bf16_matrix(n_in, n_out)
    every = np.broadcast_to(np.arange(n_in), dense.shape)
    band = first[:, None] + np.arange(weights.shape[1])
    got, want = _sequential(weights, band, x), _sequential(dense, every, x)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_banded_product_of_an_unchanged_axis_is_the_input():
    x = np.random.default_rng(3).integers(0, 256, (40, 6)).astype(np.float32)
    first, weights = gr.axis_band(40, 40)
    band = first[:, None] + np.arange(weights.shape[1])
    np.testing.assert_array_equal(_sequential(weights, band, x), x)


# -- the launch plan ---------------------------------------------------------


def _tile(t, l, h, w, crop=(0, 0, 36, 64)):
    return (t, l, h, w, crop)


def test_a_partition_takes_one_launch_into_empty_planes():
    tiles = [_tile(t, l, 18, 32) for t in (0, 18) for l in (0, 32)]
    g = gr.GridResize(tiles, 36, 64, (16, 128, 128))
    assert g.partition is not None and not g.fill
    assert g.launches == ((0, 12),)


def test_disjoint_tiles_with_gaps_take_one_launch_over_the_background():
    tiles = [_tile(2, 4, 10, 20), _tile(20, 30, 12, 22), _tile(0, 40, 8, 8)]
    g = gr.GridResize(tiles, 36, 64, (16, 128, 128))
    assert g.partition is None and g.fill
    assert g.launches == ((0, 9),)


def test_a_brick_layout_covering_the_canvas_needs_no_background():
    # disjoint and covering, though not rows of equal tops (no partition)
    tiles = [_tile(0, 0, 20, 40), _tile(0, 40, 36, 24), _tile(20, 0, 16, 40)]
    g = gr.GridResize(tiles, 36, 64, (16, 128, 128))
    assert g.partition is None and not g.fill
    assert g.launches == ((0, 9),)


def test_overlapping_tiles_take_one_launch_each_in_paint_order():
    tiles = [_tile(0, 0, 20, 40), _tile(10, 20, 20, 40), _tile(30, 0, 6, 8)]
    g = gr.GridResize(tiles, 36, 64, (16, 128, 128))
    assert g.fill
    assert g.launches == ((0, 3), (3, 6), (6, 9))


def test_many_disjoint_tiles_are_split_across_launches():
    tiles = [_tile(2 * (k // 50), 2 * (k % 50), 2, 2) for k in range(50)]
    g = gr.GridResize(tiles, 4, 100, (16, 128, 128))
    assert g.launches == ((0, gr.MAX_PLANES), (gr.MAX_PLANES, 150))


def _strip_rows(p: gr.Plan) -> np.ndarray:
    return p.table[p.strip_base * gr.STRIP_INTS :].reshape(-1, gr.STRIP_INTS)


def test_each_plane_takes_the_first_block_shape_that_fits():
    shapes = ((1080, 1920, 540, 960, 0, 0, 0), (540, 960, 270, 480, 1, 0, 0),
              (1080, 1920, 54, 96, 0, 0, 0), (1080, 1920, 1080, 1920, 0, 0, 0),
              (1080, 1920, 540, 960, 0, 540, 960))
    p = gr.plan(shapes)
    rows = _strip_rows(p)
    assert len(rows) == sum(p.strips)
    firsts = np.cumsum((0,) + p.strips[:-1])
    # strips of 32 x 64 at 2x; a 20x downscale's 120-tap bands take narrow strips
    assert [tuple(rows[f, 4:6]) for f in firsts] == [(32, 64), (32, 64), (1, 2), (32, 128),
                                                      (32, 64)]
    assert p.strips[:2] == (17 * 15, 9 * 8)
    # k-tiles of 16 an m-tile's and an n-tile's weights span
    assert [tuple(rows[f, 12:14]) for f in firsts] == [(4, 3), (4, 3), (8, 10), (1, 1), (4, 3)]
    assert list(rows[firsts, 0]) == [0, 1, 2, 3, 4] and list(rows[firsts, 1]) == [0, 1, 0, 0, 0]
    # two blocks share an SM
    assert all(0 < gr.smem_bytes(*d) <= gr.SMEM_MAX // 2 for d in p.dims)
    # planes of the same sizes share their weights; the last is placed at (540, 960)
    np.testing.assert_array_equal(rows[firsts[4]:, 14:], rows[: p.strips[4], 14:])
    assert tuple(rows[firsts[4], 2:4]) == (540, 960)
    start, n, dims, smem = p.launch(0, 5)
    assert (start, n) == (p.strip_base, len(rows)) and smem == gr.smem_bytes(*dims)
    assert p.launch(3, 5)[:2] == (p.strip_base + sum(p.strips[:3]), sum(p.strips[3:]))


def test_a_resize_wider_than_a_block_is_refused():
    with pytest.raises(ValueError, match="shared memory"):
        gr.plan(((16, 8000, 16, 10, 0, 0, 0),))


# -- the kernel's blocks, mirrored ---------------------------------------------


def _bf16(x: np.ndarray) -> np.ndarray:
    return resample.to_bf16_values(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _round_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(_bf16(x) + np.float32(0.5), 0, 255).astype(np.uint8)


def _up16(x: int) -> int:
    return (x + 15) // 16 * 16


def _dense_tiles(table, at, n_tiles, tile, head, span, pad):
    """A block's weight tiles from the table as one dense (n_tiles * tile,
    pad) matrix over its window, each tile over the k-tiles the kernel
    multiplies (from its kt0, as many as its header says: all that is past
    them, and the padding of its rows, is zeros)."""
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


def _mirror(g: gr.GridResize, sources):
    """The output planes as the kernel's blocks write them, from the strip
    rows and weight tiles of the table it reads: each strip's window (rows
    from the band of its first row, columns from its first column's rounded
    down to 16, padded with zeros), its tiles' weights held to the GEMM
    route's bf16 matrices over the window (so no weight lies outside the
    k-tiles the kernel multiplies), its shared memory (within the
    launch's), f32 sums of exact products rounded to bf16 after each pass,
    and u8 by round half up. Returns the planes and a mask of the samples
    written."""
    views, shapes = g.plane_views(sources)
    p = gr.plan(shapes)
    table = p.table
    sizes = ((g.height, g.width), (g.height // 2, g.width // 2), (g.height // 2, g.width // 2))
    out = [np.full(s, c, np.uint8) if g.fill else np.zeros(s, np.uint8)
           for s, c in zip(sizes, g.background)]
    written = [np.zeros(s, bool) for s in sizes]
    for k0, k1 in g.launches:
        start, n, dims, smem = p.launch(k0, k1)
        assert smem <= gr.SMEM_MAX
        for row in table[start * gr.STRIP_INTS : (start + n) * gr.STRIP_INTS].reshape(
                n, gr.STRIP_INTS):
            k, plane, y0, x0, rn, cn, sr0, hwin, xw0, wwin, hpad, wpad, kh, kw, h_at, w_at = row
            in_h, in_w, out_h, out_w, _, top, left = shapes[k]
            r0, c0 = y0 - top, x0 - left
            assert k0 <= k < k1 and xw0 % 16 == 0 and hpad % 16 == 0 and wpad % 16 == 0
            assert hwin <= hpad <= dims[0] and wwin <= wpad <= dims[1] and _up16(rn) <= dims[2]
            mt, nt = -(-rn // 16), -(-cn // 8)
            assert gr.H_HEAD + mt * 8 * (16 * kh + 8) <= dims[3]
            assert gr.W_HEAD + nt * 4 * (16 * kw + 8) <= dims[4]
            a = _dense_tiles(table, h_at, mt, 16, gr.H_HEAD, kh, hpad)
            bw = _dense_tiles(table, w_at, nt, 8, gr.W_HEAD, kw, wpad)
            # the tiles hold the bf16 matrices' rows over the window, zeros elsewhere
            for dense, (n_in, n_out, o0, m, w0, win) in (
                    (a, (in_h, out_h, r0, rn, sr0, hwin)), (bw, (in_w, out_w, c0, cn, xw0, wwin))):
                want = _bf16_matrix(n_in, n_out) if n_in != n_out else np.eye(n_in, dtype=np.float32)
                assert not want[o0 : o0 + m, : w0].any() and not want[o0 : o0 + m, w0 + win :].any()
                np.testing.assert_array_equal(dense[:m, :win], want[o0 : o0 + m, w0 : w0 + win])
                assert not dense[:m, win:].any() and not dense[m:].any()
            src = views[k].numpy()
            assert sr0 + hwin <= src.shape[0] and xw0 + wwin <= src.shape[1]
            s = np.zeros((hpad, wpad), np.float64)
            s[:hwin, :wwin] = src[sr0 : sr0 + hwin, xw0 : xw0 + wwin]
            t = _bf16((a.astype(np.float64) @ s).astype(np.float32)).astype(np.float64)
            o = _round_u8((t @ bw.astype(np.float64).T).astype(np.float32))[:rn, :cn]
            ys, xs = slice(y0, y0 + rn), slice(x0, x0 + cn)
            out[plane][ys, xs] = o
            written[plane][ys, xs] = True
    return out, written


def _sources(n: int, res, seed: int):
    gen = torch.Generator().manual_seed(seed)
    w, h = res
    return [tuple(torch.randint(0, 256, s, dtype=torch.uint8, generator=gen)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))) for _ in range(n)]


def _grid_of(n_side: int, canvas, src_res):
    w, h = canvas[0] // n_side // 2 * 2, canvas[1] // n_side // 2 * 2
    return [(r * h, c * w, h, w, (0, 0, src_res[1], src_res[0]))
            for r in range(n_side) for c in range(n_side)]


# (tiles, canvas (w, h), source (w, h)); the cells' geometries at a tenth
LAYOUTS = {
    "tiles16_4k": (_grid_of(4, (384, 216), (192, 108)), (384, 216), (192, 108)),
    "tiles4to1_1080p": (_grid_of(2, (192, 108), (192, 108)), (192, 108), (192, 108)),
    "cropped": ([(4, 6, 60, 100, (10, 20, 80, 120))], (128, 72), (192, 108)),
    "upscaled": ([(0, 0, 90, 160, (0, 0, 36, 64)), (90, 0, 18, 32, (0, 0, 36, 64))],
                 (160, 108), (64, 36)),
    "odd_width": ([(0, 0, 72, 214, (0, 0, 108, 192)), (72, 214, 36, 106, (0, 0, 108, 192))],
                  (320, 108), (192, 108)),
    # a source of odd width and height, shown whole (the flagship grid's crop)
    "odd_source": ([(0, 0, 36, 64, (0, 0, 37, 65)), (36, 66, 38, 64, (0, 0, 37, 65))],
                   (130, 74), (65, 37)),
    "overlapping": ([(0, 0, 80, 140, (0, 0, 108, 192)), (40, 60, 68, 120, (0, 0, 108, 192)),
                     (10, 100, 30, 54, (4, 8, 100, 176))], (192, 108), (192, 108)),
    "unchanged": ([(0, 0, 108, 192, (0, 0, 108, 192))], (192, 108), (192, 108)),
    "many_small": (_grid_of(4, (96, 54), (192, 108)), (96, 54), (192, 108)),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kernel_blocks_mirror_the_plain_version(layout):
    tiles, (w, h), src_res = LAYOUTS[layout]
    g = gr.GridResize(tiles, h, w, (16, 128, 128))
    sources = _sources(len(tiles), src_res, seed=len(layout))
    got, written = _mirror(g, sources)
    want = g.resize_tiles_plain(sources, CPU)
    for p, (a, b, mask) in enumerate(zip(got, want, written)):
        if not g.fill:
            assert mask.all(), (layout, p)
        d = np.abs(a.astype(np.int32) - b.numpy().astype(np.int32))
        # the plain version's f32 GEMMs sum in another order than these
        # exact sums: a rounding may flip by one step, on one sample in
        # 10,000 at most (or one sample of a smaller plane)
        assert d.max() <= 1 and (d > 0).sum() <= max(1, d.size // 10000), (
            layout, p, int((d > 0).sum()))


# -- the wrapper's checks and the program's counter ------------------------------


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    tiles = [_tile(0, 0, 18, 32)]
    g = gr.GridResize(tiles, 36, 64, (16, 128, 128))
    (y, u, v), = _sources(1, (64, 36), seed=1)
    with pytest.raises(ValueError, match="u8"):
        g([(y.to(torch.float32), u, v)], CPU)
    with pytest.raises(ValueError, match="meta"):
        g([(y, u.to("meta"), v)], CPU)
    with pytest.raises(ValueError, match="tiles"):
        g([], CPU)
    with pytest.raises(ValueError, match="inside"):
        gr.GridResize([_tile(20, 40, 18, 32)], 36, 64, (16, 128, 128))
    with pytest.raises(ValueError, match="chroma grid"):
        gr.GridResize([_tile(1, 0, 18, 32)], 36, 64, (16, 128, 128))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        g([(y.to("meta"), u.to("meta"), v.to("meta"))], torch.device("meta"))


def test_a_cpu_call_runs_the_plain_version_and_launches_nothing():
    tiles = _grid_of(2, (128, 72), (64, 36))
    g = gr.GridResize(tiles, 72, 128, (16, 128, 128))
    sources = _sources(4, (64, 36), seed=2)
    before = gr.LAUNCHES
    got = g(sources, CPU)
    assert gr.LAUNCHES == before
    for a, b in zip(got, g.resize_tiles_plain(sources, CPU)):
        assert a.dtype == torch.uint8 and torch.equal(a, b)


@pytest.mark.parametrize("n", [16, 4])
def test_the_grid_program_counts_its_tile_planes_each_run(n):
    r = Renderer(RendererOptions(async_compile=False), device="cpu")
    for i in range(n):
        r.register_input(f"input_{i}")
    r.update_scene("out", comp.Tiles(background_color=tt.RGBAColor(0, 0, 0, 255),
                                     children=[comp.InputStream(input_id=f"input_{i}")
                                               for i in range(n)]),
                   tt.Resolution(192, 108), tt.PixelFormat.PLANAR_YUV420)
    gen = torch.Generator().manual_seed(n)
    frames = {f"input_{i}": tt.Frame(
        data=tuple(torch.randint(0, 256, s, dtype=torch.uint8, generator=gen)
                   for s in ((36, 64), (18, 32), (18, 32))),
        format=tt.PixelFormat.PLANAR_YUV420, resolution=tt.Resolution(64, 36), pts=0.0)
        for i in range(n)}
    r.render(tt.FrameSet(pts=0.0, frames=frames))
    tracing.reset()
    try:
        for k in range(1, 4):
            r.render(tt.FrameSet(pts=k / 32, frames=frames))
        assert tracing.counters()["program.grid.tile_planes"] == 3 * 3 * n
        assert tracing.counters()["program.calls.grid"] == 3
    finally:
        tracing.reset()


def test_no_module_under_ops_imports_the_parallel_package():
    import smelter_tpu_torch.ops

    ops = Path(smelter_tpu_torch.ops.__file__).parent
    found = []
    for path in sorted(ops.rglob("*.py")):
        package = ["smelter_tpu_torch", "ops", *path.relative_to(ops).parent.parts]
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                # a relative import resolved against the module's package
                base = ".".join(package[: len(package) + 1 - node.level] if node.level else [])
                module = ".".join(p for p in (base, node.module) if p)
                names = [module] + [f"{module}.{a.name}" for a in node.names]
            else:
                continue
            found += [f"{path.relative_to(ops)}:{node.lineno} {n}" for n in names
                      if n == "smelter_tpu_torch.parallel"
                      or n.startswith("smelter_tpu_torch.parallel.")]
    assert len(list(ops.rglob("*.py"))) > 10 and found == []
