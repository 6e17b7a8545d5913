"""The PyTorch port's `Renderer` and frame program against the JAX package's,
on the CPU, frame by frame on the same component trees and the same
`make_test_input` frames. Each scene is built once with the reference's
components; the port gets it through `interop.from_reference`, and runs with
`device="cpu"`.

Tolerance: <= 1 u8 LSB per pixel on the RGBA output and on every YUV420
plane; the count of pixels that differ is printed per frame (`pytest -s`).

Scenes:
  (a) the width transition of `tests/test_renderer.py`: an animating colour
      layout, kernel K3's route;
  (b) a 4-input Tiles grid with a bordered, shadowed banner sliding over it:
      K1 for the stable layouts, the texture groups, K3 for the banner;
  (c) the same banner crossing its parent's bound: it gains a mask and takes
      the sampled full-canvas pass;
  (d) a Tiles-only YUV420 scene: the YUV grid program;
  (e) a card whose border and shadow colours change while every rect stays
      put: K1 paints each frame with that frame's colours, and the compose
      cache of a structure holds no parameters.
"""

from __future__ import annotations

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import make_test_input
from smelter_tpu.core.types import FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu.render import program as jprog
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.scene import components as comp
from smelter_tpu.scene.layout_types import (
    BorderRadius,
    BoxShadow,
    Crop,
    Mask,
    RenderBoxShadow,
    RenderChildNode,
    RenderColor,
    RenderLayout,
)
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers
from smelter_tpu_torch.render import program as tprog
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer

torch.set_num_threads(2)

OUT = Resolution(384, 216)
IN = Resolution(96, 54)
WHITE = RGBAColor(255, 255, 255, 255)


def _frames(n: int, pts: float) -> FrameSet:
    return FrameSet(pts=pts, frames={
        f"input_{i}": make_test_input(i, IN, pts) for i in range(n)})


def _planes(data) -> tuple:
    """A frame's data as a tuple of numpy planes (JAX arrays or tensors)."""
    planes = data if isinstance(data, tuple) else (data,)
    return tuple(p.numpy() if torch.is_tensor(p) else np.asarray(p) for p in planes)


def _render_seq(renderer_cls, steps, fmt, n_inputs, res=OUT):
    """steps: (scene or None, pts) pairs; a scene is set with update_scene
    before its frame. Returns each frame's planes and the renderer. The
    port's renderer runs on the CPU and gets the reference's objects
    through `from_reference`."""
    port = renderer_cls is TorchRenderer
    r = renderer_cls(device="cpu") if port else renderer_cls()
    conv = from_reference if port else (lambda x: x)
    for i in range(n_inputs):
        r.register_input(f"input_{i}")
    outs = []
    for scene, pts in steps:
        if scene is not None:
            r.update_scene("out", *conv((scene, res, fmt)))
        outs.append(_planes(r.render(conv(_frames(n_inputs, pts))).frames["out"].data))
    return outs, r


def _assert_frames_match(ref_frames, got_frames, label):
    assert len(ref_frames) == len(got_frames)
    for k, (ref, got) in enumerate(zip(ref_frames, got_frames)):
        for pi, (a, b) in enumerate(zip(ref, got)):
            assert a.shape == b.shape and b.dtype == np.uint8, (label, k, pi)
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            print(f"{label} frame {k} plane {pi}: max {int(d.max())} LSB, "
                  f"{int((d > 0).sum())} of {d.size} pixels differ")
            assert int(d.max()) <= 1, f"{label} frame {k} plane {pi}: {int(d.max())} LSB"


@pytest.fixture
def k3_calls(monkeypatch):
    """The kinds of every K3 call the port makes, in order."""
    calls = []
    orig = sdf_layers.compose_sdf_layers_planar

    def spy(canvas, params, kinds, table=None):
        calls.append(tuple(kinds))
        return orig(canvas, params, kinds, table)

    monkeypatch.setattr(sdf_layers, "compose_sdf_layers_planar", spy)
    return calls


@pytest.fixture
def k1_calls(monkeypatch):
    """The parameter rows of every K1 call the port makes, in order."""
    calls = []
    orig = scene_assembly.assemble_scene_planar

    def spy(resolution, specs, params, spec_rows=None):
        calls.append(params.clone())
        return orig(resolution, specs, params, spec_rows)

    monkeypatch.setattr(scene_assembly, "assemble_scene_planar", spy)
    return calls


# ---------------------------------------------------------------- scenes


def _width_scene(width):
    """tests/test_renderer.py: a white box whose width animates."""
    return comp.View(background_color=RGBAColor(0, 0, 0), children=[comp.View(
        id="box", position=comp.StaticPosition(width=width, height=180.0),
        background_color=WHITE, transition=comp.Transition(duration=1.0))])


def _banner_scene(left, n_inputs=4, border_color=WHITE,
                  shadow_color=RGBAColor(0, 0, 0, 160)):
    """A Tiles grid of inputs under a bordered, rounded, shadowed banner."""
    return comp.View(background_color=RGBAColor(20, 20, 20), children=[
        comp.Tiles(children=[comp.Rescaler(child=comp.InputStream(input_id=f"input_{i}"))
                             for i in range(n_inputs)],
                   background_color=RGBAColor(16, 16, 16), margin=4.0),
        comp.View(id="banner", position=comp.AbsolutePosition(
                      width=240.0, height=40.0, top=150.0, left=left),
                  background_color=RGBAColor(200, 30, 30, 230),
                  border_radius=BorderRadius(12, 12, 12, 12),
                  border_width=3.0, border_color=border_color,
                  box_shadow=[BoxShadow(offset_x=4, offset_y=4, blur_radius=10,
                                        color=shadow_color)],
                  transition=comp.Transition(duration=1.0)),
    ])


FORMATS = [PixelFormat.RGBA, PixelFormat.PLANAR_YUV420]
TRANSITION_PTS = (0.25, 0.5, 0.75, 1.0, 1.1)


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.value)
def test_a_width_transition(fmt, k3_calls):
    steps = [(_width_scene(40.0), 0.0), (_width_scene(240.0), 0.25),
             (None, 0.5), (None, 1.0), (None, 1.1)]
    ref, _ = _render_seq(JaxRenderer, steps, fmt, 0, Resolution(320, 180))
    got, _ = _render_seq(TorchRenderer, steps, fmt, 0, Resolution(320, 180))
    _assert_frames_match(ref, got, f"width {fmt.value}")
    # the first frame of a scene is planned stable; the two frames on which
    # the box moves since the one before run K3, the settled one does not
    assert k3_calls == [(("color", False, False),)] * 2


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.value)
def test_b_banner_slides_over_tiles(fmt, k3_calls):
    steps = [(_banner_scene(20.0), 0.0), (_banner_scene(120.0), TRANSITION_PTS[0])]
    steps += [(None, pts) for pts in TRANSITION_PTS[1:]]
    ref, _ = _render_seq(JaxRenderer, steps, fmt, 4)
    got, _ = _render_seq(TorchRenderer, steps, fmt, 4)
    _assert_frames_match(ref, got, f"banner {fmt.value}")
    banner = (("box_shadow", False, False), ("color", True, False))
    assert k3_calls[:3] == [banner] * 3  # pts 0.5, 0.75 and 1.0 animate


def test_c_banner_crosses_the_bound(k3_calls):
    fmt = PixelFormat.PLANAR_YUV420
    steps = [(_banner_scene(150.0), 0.0), (_banner_scene(250.0), TRANSITION_PTS[0])]
    steps += [(None, pts) for pts in TRANSITION_PTS[1:]]
    ref, _ = _render_seq(JaxRenderer, steps, fmt, 4)
    got, r = _render_seq(TorchRenderer, steps, fmt, 4)
    _assert_frames_match(ref, got, "banner crossing")
    # past the parent's right edge the banner carries its parent's mask, so
    # it takes the sampled full-canvas pass and never K3
    assert k3_calls == []
    key, _ = r._programs["out"].plan(0.6, from_reference(_frames(4, 0.6).frames))
    banner = [st for part in key if isinstance(part, tuple) and part[1] == "layout"
              for st in part[2] if st.content != "texture"][-2:]
    assert [(st.content, st.static_rect, st.n_masks) for st in banner] == [
        ("box_shadow", None, 1), ("color", None, 1)]


def test_d_tiles_grid_program():
    fmt = PixelFormat.PLANAR_YUV420
    scene = comp.Tiles(children=[comp.Rescaler(child=comp.InputStream(input_id=f"input_{i}"))
                                 for i in range(4)],
                       background_color=RGBAColor(16, 16, 16), margin=4.0)
    steps = [(scene, 0.0), (None, 0.5)]
    ref, _ = _render_seq(JaxRenderer, steps, fmt, 4)
    got, r = _render_seq(TorchRenderer, steps, fmt, 4)
    _assert_frames_match(ref, got, "tiles grid")
    programs = list(r._programs["out"]._build_cache.values())
    assert len(programs) == 1
    assert "_try_yuv_grid_program" in programs[0].__qualname__


def _card_scene(border_color=WHITE, shadow_color=RGBAColor(0, 0, 0, 160)):
    """A bordered, rounded, shadowed card on an opaque background: every
    layout is a member of kernel K1."""
    return comp.View(background_color=RGBAColor(20, 20, 20), children=[
        comp.View(id="card", position=comp.AbsolutePosition(
                      width=200.0, height=110.0, top=40.0, left=90.0),
                  background_color=RGBAColor(200, 30, 30, 230),
                  border_radius=BorderRadius(16, 16, 16, 16),
                  border_width=6.0, border_color=border_color,
                  box_shadow=[BoxShadow(offset_x=6, offset_y=6, blur_radius=14,
                                        color=shadow_color)])])


def test_e_only_border_and_shadow_colours_change(k1_calls):
    fmt = PixelFormat.RGBA
    steps = [(_card_scene(), 0.0), (None, 0.2),
             (_card_scene(RGBAColor(40, 220, 40, 255), RGBAColor(0, 0, 200, 200)), 0.4),
             (None, 0.6)]
    ref, _ = _render_seq(JaxRenderer, steps, fmt, 0)
    got, r = _render_seq(TorchRenderer, steps, fmt, 0)
    _assert_frames_match(ref, got, "new colours")
    assert not np.array_equal(got[1][0], got[2][0])
    # every frame paints all three layouts in K1, with its own colours
    assert [tuple(rows.shape) for rows in k1_calls] == [(3, 19)] * 4
    assert torch.equal(k1_calls[0], k1_calls[1])
    assert not torch.equal(k1_calls[1], k1_calls[2])
    assert torch.equal(k1_calls[2], k1_calls[3])


def test_e_compose_cache_holds_no_parameters(k1_calls):
    """One structure, one cache, two sets of parameters: the second call
    paints its own border and shadow colours, as a call with a fresh cache
    does (a cache of K1 parameter rows would repaint the first set)."""
    from smelter_tpu_torch.ops.compose import compose_layouts

    def layouts(border, shadow):
        radius = BorderRadius(16.0, 16.0, 16.0, 16.0)
        return [
            RenderLayout(0.0, 0.0, 384.0, 216.0, 0.0, BorderRadius(), (),
                         RenderColor(RGBAColor(20, 20, 20), WHITE, 0.0)),
            RenderLayout(46.0, 96.0, 200.0, 110.0, 0.0, radius, (),
                         RenderBoxShadow(shadow, 14.0)),
            RenderLayout(40.0, 90.0, 200.0, 110.0, 0.0, radius, (),
                         RenderColor(RGBAColor(200, 30, 30, 230), border, 6.0)),
        ]

    first = [tprog.split_layout(lay, fast=True, device="cpu") for lay in
             from_reference(layouts(WHITE, RGBAColor(0, 0, 0, 160)))]
    second = [tprog.split_layout(lay, fast=True, device="cpu") for lay in
              from_reference(layouts(RGBAColor(40, 220, 40), RGBAColor(0, 0, 200, 200)))]
    statics = [st for st, _ in first]
    assert statics == [st for st, _ in second]
    cache: dict = {}
    res = (OUT.width, OUT.height)
    a = compose_layouts(res, statics, [p for _, p in first], [], cache=cache)
    b = compose_layouts(res, statics, [p for _, p in second], [], cache=cache)
    fresh = compose_layouts(res, statics, [p for _, p in second], [])
    assert len(k1_calls) == 3
    assert torch.equal(b, fresh) and not torch.equal(a, b)
    assert cache and all(t.dtype == torch.int32 for t in cache.values())


# ------------------------------------------------- from_reference


def _assert_same_fields(ref, got, path="scene"):
    """`got` is `ref` carried across: the port's class of the same module
    path and name, every field the same, numpy leaves passed through."""
    cls = type(ref)
    if cls.__module__.split(".")[0] == "smelter_tpu":
        assert type(got).__module__ == "smelter_tpu_torch" + cls.__module__[len("smelter_tpu"):], path
        assert type(got).__qualname__ == cls.__qualname__, path
        if isinstance(ref, enum.Enum):
            assert got.name == ref.name and got.value == ref.value, path
            return
        for f in dataclasses.fields(ref):
            _assert_same_fields(getattr(ref, f.name), getattr(got, f.name), f"{path}.{f.name}")
    elif isinstance(ref, (tuple, list)):
        assert type(got) is cls and len(got) == len(ref), path
        for i, (a, b) in enumerate(zip(ref, got)):
            _assert_same_fields(a, b, f"{path}[{i}]")
    elif isinstance(ref, dict):
        assert type(got) is dict and list(got) == list(ref), path
        for k in ref:
            _assert_same_fields(ref[k], got[k], f"{path}[{k!r}]")
    elif isinstance(ref, np.ndarray):
        assert got is ref, path
    else:
        assert type(got) is cls and got == ref, path


ROUND_TRIP = {
    "width": lambda: _width_scene(40.0),
    "banner": lambda: _banner_scene(120.0, border_color=RGBAColor(40, 220, 40, 255)),
    "card": _card_scene,
    "layouts": lambda: list(_render_layouts().values()),
    "frames": lambda: _frames(4, 0.5),
    "output": lambda: (OUT, PixelFormat.PLANAR_YUV420, FORMATS),
}


@pytest.mark.parametrize("name", sorted(ROUND_TRIP))
def test_from_reference_carries_scenes_field_for_field(name):
    ref = ROUND_TRIP[name]()
    got = from_reference(ref)
    _assert_same_fields(ref, got)
    assert from_reference(got) is got or from_reference(got) == got  # port objects pass


def test_from_reference_refuses_what_it_cannot_carry():
    from smelter_tpu.utils.tracing import _Aggregate

    with pytest.raises(TypeError, match="no port counterpart"):
        from_reference([_Aggregate()])


# ------------------------------------------------- program cache, planner


def test_no_rebuild_during_transition():
    """Port of `test_no_recompile_during_transition`: the animating frames
    share one structure, the settled end geometry adds one, and further
    frames reuse it."""
    r = TorchRenderer(device="cpu")
    out = from_reference((Resolution(320, 180), PixelFormat.RGBA))
    r.update_scene("out", from_reference(_width_scene(40.0)), *out)
    r.render(from_reference(FrameSet(pts=0.0)))
    r.update_scene("out", from_reference(_width_scene(240.0)), *out)
    program = r._programs["out"]
    for i in range(1, 20):
        r.render(from_reference(FrameSet(pts=i / 25.0)))
    assert len(program._build_cache) <= 2
    n_during = len(program._build_cache)
    for i in range(30, 40):
        r.render(from_reference(FrameSet(pts=i / 25.0)))
    assert len(program._build_cache) <= n_during + 1
    final = len(program._build_cache)
    for i in range(40, 50):
        r.render(from_reference(FrameSet(pts=i / 25.0)))
    assert len(program._build_cache) == final


def _render_layouts():
    radius = BorderRadius(6.0, 8.0, 10.0, 12.0)
    mask = Mask(BorderRadius(4.0, 4.0, 4.0, 4.0), 10.0, 12.0, 300.0, 200.0, 15.0)
    child = RenderChildNode(index=1, border_color=RGBAColor(10, 20, 30, 200),
                            border_width=2.0, crop=Crop(3.2, 4.7, 90.4, 50.6))
    return {
        "texture": RenderLayout(20.3, 30.6, 130.4, 70.2, 0.0, radius, (), child),
        "texture_rotated": RenderLayout(20.3, 30.6, 130.4, 70.2, 33.0, radius,
                                        (mask,), child),
        "color": RenderLayout(5.5, 6.4, 100.0, 50.0, 0.0, BorderRadius(),
                              (mask, mask), RenderColor(RGBAColor(1, 2, 3, 4),
                                                        RGBAColor(5, 6, 7, 8), 3.0)),
        "shadow_rotated": RenderLayout(5.5, 6.4, 100.0, 50.0, 12.5, radius, (),
                                       RenderBoxShadow(RGBAColor(0, 0, 0, 160), 9.0)),
    }


FLAGS = {
    "general": {},
    "fast": dict(fast=True),
    "rot_traced": dict(rot_traced=True),
    "moving": dict(moving=True),
    "scaling": dict(scaling=True),
}


@pytest.mark.parametrize("flags", sorted(FLAGS))
@pytest.mark.parametrize("layout", sorted(_render_layouts()))
def test_split_layout_matches_reference(layout, flags):
    lay = _render_layouts()[layout]
    ref_st, ref_p = jprog.split_layout(lay, **FLAGS[flags])
    got_st, got_p = tprog.split_layout(from_reference(lay), **FLAGS[flags], device="cpu")
    assert dataclasses.asdict(got_st) == dataclasses.asdict(ref_st)
    for f in dataclasses.fields(ref_p):
        want = np.asarray(getattr(ref_p, f.name), np.float32)
        np.testing.assert_array_equal(getattr(got_p, f.name).numpy(), want, err_msg=f.name)


def test_pack_and_unpack_layout_params_match_reference():
    layouts = _render_layouts()
    split = {0: [jprog.split_layout(layouts["texture"], fast=True),
                 jprog.split_layout(layouts["color"])],
             3: [jprog.split_layout(layouts["shadow_rotated"], fast=True),
                 jprog.split_layout(layouts["texture_rotated"], rot_traced=True)]}
    params = {nid: [p for _, p in v] for nid, v in split.items()}
    statics = {nid: tuple(s for s, _ in v) for nid, v in split.items()}
    ref_vec = jprog._pack_layout_params(params, 0.75)
    got_vec = tprog._pack_layout_params(params, 0.75)
    np.testing.assert_array_equal(got_vec, ref_vec)
    ref = jprog._unpack_layout_params(jnp.asarray(ref_vec), statics)
    got = tprog._unpack_layout_params(torch.from_numpy(got_vec), statics)
    assert sorted(got) == sorted(ref)
    for nid in ref:
        for rp, gp in zip(ref[nid], got[nid]):
            for f in dataclasses.fields(rp):
                np.testing.assert_array_equal(getattr(gp, f.name).numpy(),
                                              np.asarray(getattr(rp, f.name)))


def test_unpacked_params_are_views_of_the_vector():
    split = [tprog.split_layout_host(lay)
             for lay in from_reference(list(_render_layouts().values()))]
    vec = torch.from_numpy(tprog._pack_layout_params({0: [p for _, p in split]}, 0.0))
    out = tprog._unpack_layout_params(vec, {0: tuple(s for s, _ in split)})
    for p in out[0]:
        for f in dataclasses.fields(p):
            assert getattr(p, f.name)._base is vec


def test_layout_collapse_matches_reference():
    """`_entry_within_bounds`, `_collapsible` and `_offset_entries` (the
    collapse of a child layout node placed as a pure translation) give the
    reference's answers."""
    res = Resolution(320, 180)
    inner = [(lay, None) for lay in _render_layouts().values()]
    child = RenderChildNode(index=0, border_color=WHITE, border_width=0.0,
                            crop=Crop(0.0, 0.0, 320.0, 180.0))
    mask = Mask(BorderRadius(), 0.0, 0.0, 400.0, 300.0)
    placements = [
        RenderLayout(10.0, 20.0, 320.0, 180.0, 0.0, BorderRadius(), (mask,), child),
        RenderLayout(10.0, 20.0, 160.0, 90.0, 0.0, BorderRadius(), (), child),
        RenderLayout(10.0, 20.0, 320.0, 180.0, 5.0, BorderRadius(), (), child),
    ]
    t_res, t_inner = from_reference((res, inner))
    for (e, _), (t_e, _) in zip(inner, t_inner):
        assert tprog._entry_within_bounds(t_e, t_res) == jprog._entry_within_bounds(e, res)
    for lay in placements:
        t_lay = from_reference(lay)
        for entries, t_entries in ((inner, t_inner), (inner[:1], t_inner[:1])):
            assert (tprog._collapsible(t_lay, t_res, t_entries)
                    == jprog._collapsible(lay, res, entries))
        assert tprog._offset_entries(t_inner, t_lay) == from_reference(
            jprog._offset_entries(inner, lay))


def test_unported_scenes_raise_at_update_scene():
    r = TorchRenderer(device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        r.update_scene("out", *from_reference((
            comp.View(children=[comp.Text(text="x")]), OUT, PixelFormat.RGBA)))
    with pytest.raises(NotImplementedError, match="item 1"):
        r.update_scene("out", *from_reference((comp.View(), OUT, PixelFormat.NV12)))
    assert "out" not in r._programs
