"""The animated-texture paths and the input converters of the PyTorch port
against the JAX package on the CPU: the same numpy-seeded inputs through
each JAX function and its port, then the port's `Renderer` against the JAX
`Renderer` frame by frame through transitions that move, resize and turn
video tiles.

Tolerances, per function:
  - `resize_matmul_traced`: the first product rounds to bf16, so a sum that
    lands on a bf16 tie in one package and beside it in the other moves one
    bf16 step (2**-8 of the value); the outputs agree to 2**-7 of the
    input's range, and within 1e-5 on all but a few per cent of the values
    (the counts are printed and held per case);
  - `rotate_traced_cm`: torch's and XLA's tan/sin may differ in the last
    bit, which moves a shear's fraction by ~1e-7 and may flip the integer
    shift of a row whose shift is within that of an integer: max abs err
    1e-5, and a few pixels (printed, held) where a shift flipped;
  - `sample_bilinear`, `sample_bilinear_mip`, `_place_tile_traced`, the
    converters and `DeferredYuvSource.mips`: the same f32 operations in
    the same order, max abs err 1e-6 (equal in practice);
  - the renderer: <= 1 u8 LSB per pixel on every plane of every frame,
    except where a case states its measured maximum and pixel count.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import make_test_input
from smelter_tpu.core.types import Frame, FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.ops import compose as jcomp
from smelter_tpu.ops import resample as jrs
from smelter_tpu.ops import rotate as jrot
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.scene import components as comp
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.ops import color_convert as tcc
from smelter_tpu_torch.ops import compose as tcomp
from smelter_tpu_torch.ops import resample as trs
from smelter_tpu_torch.ops import rotate as trot
from smelter_tpu_torch.render import program as tprog
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer

torch.set_num_threads(2)


def _np(x) -> np.ndarray:
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


# ----------------------------------------------------- resize_matmul_traced


RESIZE_CASES = {
    # name: (in (h, w), buf (h, w), out (h, w), crop (top, left, width, height) or None)
    "down": ((90, 160), (64, 128), (47.3, 101.6), None),
    "up": ((45, 80), (192, 256), (150.2, 230.9), None),
    "down_crop": ((90, 160), (64, 128), (60.0, 77.5), (10.5, 20.25, 120.0, 70.5)),
    "up_crop": ((45, 80), (128, 192), (101.0, 170.4), (3.0, 5.5, 60.0, 30.0)),
    "mixed": ((90, 160), (128, 128), (120.7, 60.2), None),
}


@pytest.mark.parametrize("centered", [False, True], ids=["topleft", "centered"])
@pytest.mark.parametrize("case", sorted(RESIZE_CASES))
def test_resize_matmul_traced_matches_jax(case, centered):
    (ih, iw), (bh, bw), (oh, ow), crop = RESIZE_CASES[case]
    rng = np.random.RandomState(len(case))
    img = rng.randint(0, 256, (4, ih, iw)).astype(np.float32) / 255.0
    ref = np.asarray(jrs.resize_matmul_traced(
        jnp.asarray(img), bh, bw, jnp.float32(oh), jnp.float32(ow),
        crop=None if crop is None else tuple(jnp.float32(c) for c in crop),
        centered=centered))
    got = trs.resize_matmul_traced(
        torch.from_numpy(img), bh, bw, torch.tensor(oh), torch.tensor(ow),
        crop=None if crop is None else tuple(torch.tensor(c) for c in crop),
        centered=centered).numpy()
    assert got.shape == ref.shape == (4, bh, bw)
    d = np.abs(got - ref)
    n_off = int((d > 1e-5).sum())
    print(f"resize {case} centered={centered}: max {d.max():.3g}, "
          f"{n_off} of {d.size} values off by more than 1e-5")
    assert d.max() <= 2.0 ** -7
    assert n_off * 20 <= d.size
    # outside the animated size the buffer is zero in both
    assert np.array_equal(got == 0.0, ref == 0.0)


# --------------------------------------------------------- rotate_traced_cm


# angles in every quarter-turn bucket, residuals of +-45 included
ANGLES = [10.0, -30.0, 45.0, 80.0, 135.0, 200.0, 290.0, 350.0, -100.0, 315.0]


@pytest.mark.parametrize("theta", ANGLES)
def test_rotate_traced_matches_jax(theta):
    rng = np.random.RandomState(7)
    tile = rng.rand(4, 37, 58).astype(np.float32)
    q = int(round((theta % 360.0) / 90.0))
    ref = np.asarray(jrot.rotate_traced_cm(jnp.asarray(tile), jnp.float32(theta), q))
    got = trot.rotate_traced_cm(torch.from_numpy(tile), torch.tensor(theta), q).numpy()
    S = trot.traced_work_size(37, 58)
    assert S == jrot.traced_work_size(37, 58)
    assert got.shape == ref.shape == (4, S, S)
    d = np.abs(got - ref)
    n_off = int((d.max(axis=0) > 1e-5).sum())
    print(f"rotate {theta}: max {d.max():.3g}, {n_off} of {S * S} pixels off by more than 1e-5")
    assert n_off <= 2 * S  # at most two rows' or columns' worth of a flipped shift
    assert np.median(d) <= 1e-6


def test_rotate_traced_bounds_match_jax():
    assert (trot._A_MAX, trot._B_MAX) == (jrot._A_MAX, jrot._B_MAX)
    for h, w in ((1, 1), (37, 58), (540, 960), (1080, 1920)):
        assert trot.traced_work_size(h, w) == jrot.traced_work_size(h, w)


# ------------------------------------------- sample_bilinear, its mip form


def _coords(rng, shape, h, w, scale=1.0):
    """Sample positions over (and 8 px past) an h x w level-0 image."""
    ys = (rng.rand(*shape).astype(np.float32) * (h + 16) - 8) * np.float32(scale)
    xs = (rng.rand(*shape).astype(np.float32) * (w + 16) - 8) * np.float32(scale)
    return ys, xs


def test_sample_bilinear_matches_jax():
    rng = np.random.RandomState(3)
    img = rng.rand(31, 47, 4).astype(np.float32)
    ys, xs = _coords(rng, (23, 29), 31, 47)
    ref = np.asarray(jrs.sample_bilinear(jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))
    got = trs.sample_bilinear(torch.from_numpy(img), torch.from_numpy(ys),
                              torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


# below 1 (upscale, level 0), at and between levels, past the last level
@pytest.mark.parametrize("scale", [0.4, 1.0, 1.5, 2.0, 3.3, 7.9, 100.0])
def test_sample_bilinear_mip_matches_jax(scale):
    rng = np.random.RandomState(5)
    img = rng.rand(96, 160, 4).astype(np.float32)
    jm = jrs.build_mips(jnp.asarray(img), 4)
    tm = trs.build_mips(torch.from_numpy(img), 4)
    assert [tuple(m.shape) for m in tm] == [tuple(m.shape) for m in jm]
    ys, xs = _coords(rng, (24, 40), 96, 160)
    ref = np.asarray(jrs.sample_bilinear_mip(jm, jnp.asarray(ys), jnp.asarray(xs),
                                             jnp.float32(scale)))
    got = trs.sample_bilinear_mip(tm, torch.from_numpy(ys), torch.from_numpy(xs),
                                  torch.tensor(scale)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


# --------------------------------------------------------- _place_tile_traced


PLACEMENTS = {
    # name: (canvas (h, w), tile (h, w), (top, left))
    "inside": ((40, 64), (12, 20), (9.4, 17.5)),
    "half_ties": ((40, 64), (12, 20), (10.5, 16.5)),
    "off_top": ((40, 64), (12, 20), (-5.2, 10.0)),
    "off_left": ((40, 64), (12, 20), (8.0, -13.7)),
    "off_bottom": ((40, 64), (12, 20), (33.0, 30.0)),
    "off_right": ((40, 64), (12, 20), (14.0, 55.6)),
    "off_corner": ((40, 64), (12, 20), (-7.0, 58.0)),
    "fully_off": ((40, 64), (12, 20), (-40.0, 90.0)),
    "taller_than_canvas": ((40, 64), (52, 20), (-6.0, 30.0)),
    "wider_than_canvas": ((40, 64), (12, 80), (3.0, -9.0)),
    "larger_than_canvas": ((40, 64), (56, 90), (-11.4, -20.6)),
    "larger_fully_off": ((40, 64), (56, 90), (70.0, -200.0)),
}


@pytest.mark.parametrize("case", sorted(PLACEMENTS))
def test_place_tile_traced_matches_jax(case):
    (H, W), (h, w), (top, left) = PLACEMENTS[case]
    rng = np.random.RandomState(11)
    canvas = rng.rand(4, H, W).astype(np.float32)
    tile = rng.rand(4, h, w).astype(np.float32) * 0.8
    ref = np.asarray(jcomp._place_tile_traced(
        jnp.asarray(canvas), jnp.asarray(tile), jnp.float32(top), jnp.float32(left)))
    got = tcomp._place_tile_traced(torch.from_numpy(canvas.copy()), torch.from_numpy(tile),
                                   torch.tensor(top), torch.tensor(left)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


ROUTE_STATICS = {
    "moving": dict(static_rect=(0, 0, 20, 32), static_crop=(0, 0, 24, 40),
                   traced_position=True),
    "scaling": dict(traced_size_buf=(64, 64)),
    "rotozoom": dict(traced_size_buf=(64, 64), has_rotation=True, traced_rotation_q=0),
    "traced_rotation": dict(static_rect=(9, 12, 20, 32), static_crop=(0, 0, 24, 40),
                            has_rotation=True, traced_rotation_q=0),
    "sampled": dict(has_rotation=True),
}


@pytest.mark.parametrize("route", sorted(ROUTE_STATICS))
def test_compose_route_matches_jax_and_keeps_canvas_contiguous(route):
    """Each texture route over a background, against the JAX compose; the
    planar canvas it leaves stays contiguous (K2 takes only a contiguous
    canvas on the card)."""
    from smelter_tpu_torch import interop

    rng = np.random.RandomState(19)
    src = rng.rand(24, 40, 4).astype(np.float32)
    res = (64, 48)

    def params(**kw):
        base = dict(top=0.0, left=0.0, width=0.0, height=0.0, rotation_degrees=0.0,
                    border_radius=(0.0,) * 4, border_width=0.0, border_color=(0.0,) * 4,
                    color=(0.0,) * 4, crop=(0.0,) * 4, blur_radius=0.0,
                    masks=np.zeros((1, 9), np.float32))
        base.update(kw)
        return jcomp.LayoutParams(**{k: jnp.asarray(v, jnp.float32) for k, v in base.items()})

    statics = [jcomp.LayoutStatic(content="color", static_rect=(0, 0, 48, 64)),
               jcomp.LayoutStatic(content="texture", source_index=0,
                                  **ROUTE_STATICS[route])]
    plist = [params(width=64.0, height=48.0, color=(0.1, 0.2, 0.3, 1.0)),
             params(top=9.4, left=12.6, width=32.0, height=20.0, rotation_degrees=17.0,
                    border_radius=(3.0,) * 4, border_width=1.5,
                    border_color=(1.0, 1.0, 1.0, 0.8), crop=(1.0, 2.0, 36.0, 21.0))]
    statics[1] = jcomp.LayoutStatic(**{**statics[1].__dict__, "has_border": True})
    ref = np.asarray(jcomp.compose_layouts(res, statics, plist, [[jnp.asarray(src)]],
                                           planar=True))
    st, pr = interop.layouts(statics, plist, "cpu")
    got = tcomp.compose_layouts(res, st, pr, [[torch.from_numpy(src)]], planar=True)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# -------------------------------------------------------- input converters


def _random_planes(fmt: PixelFormat, h: int, w: int, rng):
    """u8 planes of an h x w frame in `fmt`, the whole u8 range (out-of-range
    YUV included)."""
    def u8(*shape):
        return rng.randint(0, 256, shape).astype(np.uint8)

    sub = {"420": (h // 2, w // 2), "422": (h, w // 2), "444": (h, w)}
    if fmt.is_planar_yuv:
        ch = sub[fmt.value[-3:]]
        return (u8(h, w), u8(*ch), u8(*ch))
    if fmt == PixelFormat.NV12:
        return (u8(h, w), u8(h // 2, w // 2, 2))
    if fmt in (PixelFormat.INTERLEAVED_YUYV422, PixelFormat.INTERLEAVED_UYVY422):
        return u8(h, w // 2, 4)
    return u8(h, w, 4)


@pytest.mark.parametrize("fmt", list(PixelFormat), ids=lambda f: f.value)
def test_convert_to_rgba_f32_matches_jax(fmt):
    planes = _random_planes(fmt, 18, 26, np.random.RandomState(13))
    if isinstance(planes, tuple):
        ref = jcc.convert_to_rgba_f32(fmt.value, tuple(jnp.asarray(p) for p in planes))
        got = tcc.convert_to_rgba_f32(fmt.value, tuple(torch.from_numpy(p) for p in planes))
    else:
        ref = jcc.convert_to_rgba_f32(fmt.value, jnp.asarray(planes))
        got = tcc.convert_to_rgba_f32(fmt.value, torch.from_numpy(planes))
    assert got.dtype == torch.float32 and tuple(got.shape) == (18, 26, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (2, 3), (9, 14), (45, 80)])
@pytest.mark.parametrize("sx,sy", [(2, 2), (2, 1), (1, 1)])
def test_upsample_chroma_bilinear_equals_jax(shape, sx, sy):
    """The chroma upsample is the reference's gather: bit-equal, edges and
    one-texel planes included."""
    plane = np.random.RandomState(23).randint(0, 256, shape).astype(np.float32) / 255.0
    ref = np.asarray(jcc.upsample_chroma_bilinear(jnp.asarray(plane), sx, sy))
    got = tcc.upsample_chroma_bilinear(torch.from_numpy(plane), sx, sy).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("full_range", [False, True])
def test_deferred_yuv_mips_match_jax(full_range):
    y, u, v = _random_planes(PixelFormat.PLANAR_YUV420, 72, 128, np.random.RandomState(17))
    levels = tprog._mip_levels(from_reference(Resolution(128, 72)))
    assert levels == 2
    ref = jcc.DeferredYuvSource(*map(jnp.asarray, (y, u, v)), full_range=full_range,
                                mip_levels=levels).mips()
    got = tcc.DeferredYuvSource(*map(torch.from_numpy, (y, u, v)), full_range=full_range,
                                mip_levels=levels).mips()
    assert len(got) == len(ref) == 2
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


# ---------------------------------------------------------------- renderer


OUT = Resolution(640, 360)
IN = Resolution(320, 180)
BG = RGBAColor(20, 20, 40)


def _yuv_frame(seed: int) -> Frame:
    """The gradient input of `tests/test_render_fastpaths.py`."""
    w, h = IN.width, IN.height
    rgba = np.zeros((h, w, 4), np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    rgba[..., 0] = ((xx + seed * 37) * 255 // w).astype(np.uint8)
    rgba[..., 1] = ((yy + seed * 19) * 255 // h).astype(np.uint8)
    rgba[..., 2] = 50 + seed * 60
    rgba[..., 3] = 255
    planes = jcc.rgba_to_planar_yuv420(rgba.astype(np.float32) / 255.0)
    return Frame(data=tuple(np.asarray(p) for p in planes),
                 format=PixelFormat.PLANAR_YUV420, resolution=IN, pts=0.0)


def _rescaler(id_, w, h, top, left, theta=0.0, trans=None):
    return comp.Rescaler(
        id=id_, child=comp.InputStream(input_id="cam_0"),
        position=comp.AbsolutePosition(width=w, height=h, top=top, left=left,
                                       rotation_degrees=theta),
        transition=trans)


def _spin(theta, trans=None):
    return comp.View(background_color=BG, children=[
        _rescaler("spin", 300.0, 170.0, 60.0, 120.0, theta, trans)])


def _slide(left, trans=None):
    return comp.View(background_color=BG, children=[
        _rescaler("mv", 300.0, 170.0, 60.0, left, 0.0, trans)])


def _zoom(w, h, trans=None):
    return comp.View(background_color=BG, children=[
        _rescaler("z", w, h, 40.0, 60.0, 0.0, trans)])


def _rotozoom(left, w, h, theta, trans=None):
    return comp.View(background_color=BG, children=[
        _rescaler("rz", w, h, 60.0, left, theta, trans)])


def _masked_spin(theta, trans=None):
    """A rotating view with an opaque background clips its child with a
    parent mask."""
    return comp.View(background_color=RGBAColor(10, 10, 30, 255), children=[comp.View(
        id="box", position=comp.AbsolutePosition(width=300.0, height=160.0, top=80.0,
                                                 left=150.0, rotation_degrees=theta),
        background_color=RGBAColor(0, 0, 0, 255), transition=trans,
        children=[comp.InputStream(input_id="cam_0")])])


def _trans():
    return comp.Transition(duration=2.0)


def _tiles(order, trans=None):
    """Id-tracked tiles of the inputs in `order` (a reorder slides them)."""
    return comp.Tiles(id="t", background_color=BG, transition=trans, children=[
        comp.InputStream(id=f"tile_{i}", input_id=f"cam_{i}") for i in order])


def _grid(n):
    """A Tiles grid of the first n inputs that re-lays out over two seconds
    when one is added (at this size the tiles keep their size and slide)."""
    return comp.Tiles(id="grid", background_color=BG, transition=_trans(), children=[
        comp.InputStream(input_id=f"cam_{i}") for i in range(n)])


# name: (first scene, scene with the transition, pts of the frames after it,
#        the route each animating frame must take)
SEQUENCES = {
    "spin": (_spin(0.0), _spin(170.0, _trans()), [i * 0.25 for i in range(1, 9)],
             "_render_rotated_rect_layout_traced"),
    "slide": (_slide(300.0), _slide(-251.0, _trans()), [i * 0.23 for i in range(1, 8)],
              "_render_moving_rect_layout"),
    "zoom": (_zoom(160.0, 90.0), _zoom(480.0, 270.0, _trans()),
             [i * 0.22 for i in range(1, 8)], "_render_scaling_rect_layout"),
    "rotozoom": (_rotozoom(80.0, 160.0, 90.0, 0.0),
                 _rotozoom(260.0, 380.0, 214.0, 65.0, _trans()),
                 [i * 0.22 for i in range(1, 9)], "_render_rotozoom_layout"),
    "masked_spin": (_masked_spin(0.0), _masked_spin(40.0, comp.Transition(duration=4.0)),
                    [0.2, 0.4, 1.0, 2.0], "_render_rotated_rect_layout_traced"),
    "tiles_reorder": (_tiles([0, 1, 2]), _tiles([2, 0, 1], _trans()),
                      [i * 0.25 for i in range(1, 8)], "_render_moving_rect_layout"),
    "tiles_add_child": (_grid(2), _grid(3), [i * 0.25 for i in range(1, 8)],
                        "_render_moving_rect_layout"),
}
ROUTES = ("_render_moving_rect_layout", "_render_scaling_rect_layout",
          "_render_rotozoom_layout", "_render_rotated_rect_layout_traced",
          "render_single_layout")


@pytest.fixture
def routes(monkeypatch):
    """The route functions of the port's compose, each call counted per
    rendered frame: routes.frames[k] is the list of routes frame k took."""
    class Spy:
        frames: list = []
        current: list = []

    spy = Spy()
    spy.frames = []
    for name in ROUTES:
        orig = getattr(tcomp, name)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            spy.current.append(_name)
            return _orig(*args, **kw)

        monkeypatch.setattr(tcomp, name, wrapped)
    return spy


def _planes(data):
    planes = data if isinstance(data, tuple) else (data,)
    return tuple(_np(p) for p in planes)


def _run(renderer_cls, scene0, scene1, pts_list, fmt, spy=None, frames=None):
    port = renderer_cls is TorchRenderer
    conv = from_reference if port else (lambda x: x)
    r = renderer_cls(device="cpu") if port else renderer_cls()
    frames = frames or {f"cam_{i}": _yuv_frame(i) for i in range(3)}
    for iid in frames:
        r.register_input(iid)
    r.update_scene("out", *conv((scene0, OUT, fmt)))
    outs = [_planes(r.render(conv(FrameSet(pts=0.0, frames=frames))).frames["out"].data)]
    r.update_scene("out", *conv((scene1, OUT, fmt)))
    for pts in pts_list:
        if spy is not None:
            spy.current = []
        outs.append(_planes(r.render(conv(FrameSet(pts=pts, frames=frames))).frames["out"].data))
        if spy is not None:
            spy.frames.append(spy.current)
    return outs


def _compare(ref, got, label):
    """Max LSB and differing pixels per frame and plane (printed)."""
    worst = 0
    for k, (fr, fg) in enumerate(zip(ref, got)):
        for pi, (a, b) in enumerate(zip(fr, fg)):
            assert a.shape == b.shape and b.dtype == np.uint8, (label, k, pi)
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            print(f"{label} frame {k} plane {pi}: max {int(d.max())} LSB, "
                  f"{int((d > 0).sum())} of {d.size} pixels differ, "
                  f"{int((d > 1).sum())} by 2+")
            worst = max(worst, int(d.max()))
    return worst


@pytest.mark.parametrize("fmt", [PixelFormat.RGBA, PixelFormat.PLANAR_YUV420],
                         ids=lambda f: f.value)
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_renderer_transition_matches_jax(name, fmt, routes):
    scene0, scene1, pts_list, route = SEQUENCES[name]
    ref = _run(JaxRenderer, scene0, scene1, pts_list, fmt)
    got = _run(TorchRenderer, *from_reference((scene0, scene1)), pts_list, fmt, routes)
    # the first frame after the update is planned stable; from the second on
    # the layout animates and takes its traced route
    taken = [route in f for f in routes.frames]
    assert sum(taken[1:]) >= (3 if name == "slide" else len(taken) - 3), routes.frames
    worst = _compare(ref, got, f"{name} {fmt.value}")
    assert worst <= 1, f"{name} {fmt.value}: {worst} LSB"


def test_renderer_sampled_texture_pass_matches_jax(routes):
    """A texture that slides while held at a stable angle leaves the moving
    route (it is rotated) and the traced rotation (its rect moves): the
    sampled full-canvas pass with mip sampling draws it."""
    scene0 = _spin(15.0)
    scene1 = comp.View(background_color=BG, children=[
        _rescaler("spin", 300.0, 170.0, 120.0, 300.0, 15.0, _trans())])
    pts = [0.3, 0.6, 0.9]
    for fmt in (PixelFormat.RGBA, PixelFormat.PLANAR_YUV420):
        routes.frames = []
        ref = _run(JaxRenderer, scene0, scene1, pts, fmt)
        got = _run(TorchRenderer, *from_reference((scene0, scene1)), pts, fmt, routes)
        assert ["render_single_layout" in f for f in routes.frames] == [False, True, True]
        worst = _compare(ref, got, f"sampled pass {fmt.value}")
        assert worst <= 1, f"sampled pass {fmt.value}: {worst} LSB"


@pytest.mark.parametrize("fmt", [PixelFormat.RGBA, PixelFormat.PLANAR_YUV420],
                         ids=lambda f: f.value)
def test_renderer_bare_input_root_matches_jax(fmt):
    """A scene whose root is the InputStream itself: the input's full RGBA
    conversion is the frame."""
    scene = comp.InputStream(input_id="cam_0")
    frames = {"cam_0": make_test_input(2, IN)}
    ref = _run(JaxRenderer, scene, scene, [0.1], fmt, frames=frames)
    got = _run(TorchRenderer, *from_reference((scene, scene)), [0.1], fmt,
               frames=from_reference(frames))
    assert _compare(ref, got, f"bare input {fmt.value}") <= 1
