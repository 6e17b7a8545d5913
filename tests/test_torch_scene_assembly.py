"""Parity of kernel K1's plain version (`smelter_tpu_torch/ops/hopper/
scene_assembly.py`) and of the port's `compose_layouts` with the JAX package
on the CPU, on the hand-built cases of `tests/test_scene_assembly.py`.

The JAX side runs as its own tests run it: the scene-assembly route forced
on (the Pallas kernel in interpret mode) or off (the XLA group path).

Tolerance: atol 2e-5 on the f32 canvas and <= 1 LSB after u8 quantisation,
the reference's own gate between its kernel and its group path (the SDF
chains round in a different order or with contracted multiply-adds).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.ops import compose as jcomp
from smelter_tpu_torch import interop
from smelter_tpu_torch.ops import compose as tcomp
from smelter_tpu_torch.ops.hopper import scene_assembly as sa

torch.set_num_threads(2)


def _params(top=0.0, left=0.0, width=0.0, height=0.0, rotation=0.0,
            radius=(0.0, 0.0, 0.0, 0.0), border_width=0.0,
            border_color=(0, 0, 0, 0), color=(0, 0, 0, 0),
            crop=(0, 0, 0, 0), blur=0.0, masks=None):
    return jcomp.LayoutParams(
        top=jnp.float32(top), left=jnp.float32(left),
        width=jnp.float32(width), height=jnp.float32(height),
        rotation_degrees=jnp.float32(rotation),
        border_radius=jnp.asarray(radius, jnp.float32),
        border_width=jnp.float32(border_width),
        border_color=jnp.asarray(border_color, jnp.float32),
        color=jnp.asarray(color, jnp.float32),
        crop=jnp.asarray(crop, jnp.float32),
        blur_radius=jnp.float32(blur),
        masks=(jnp.zeros((0, 9), jnp.float32) if masks is None
               else jnp.asarray(masks, jnp.float32)),
    )


def _mixed_case():
    """Rotated bordered color, box shadow, texture with a rotated parent
    mask, plain texture; partial tiles at the canvas edge."""
    h, w = 200, 520
    rng = np.random.RandomState(1)
    src = rng.rand(120, 160, 4).astype(np.float32)
    St = jcomp.LayoutStatic
    statics = [
        St(content="color", static_rect=(0, 0, h, w), static_color=(20, 20, 30, 255)),
        St(content="box_shadow", static_rect=(30, 40, 100, 150), static_blur=18.0),
        St(content="color", static_rect=(25, 35, 110, 160), has_border=True,
           has_rotation=True, static_rotation=20.0),
        St(content="texture", source_index=0, n_masks=1, rotated_masks=(True,),
           static_rect=(40, 260, 120, 180), static_crop=(0, 0, 120, 160)),
        St(content="texture", source_index=0, static_rect=(100, 60, 80, 120),
           static_crop=(10, 20, 100, 120)),
    ]
    params = [
        _params(top=0, left=0, width=w, height=h, color=(0.1, 0.1, 0.15, 1.0)),
        _params(top=30, left=40, width=150, height=100, blur=18.0,
                radius=(12, 12, 12, 12), color=(0, 0, 0, 0.6)),
        _params(top=25, left=35, width=160, height=110, rotation=20.0,
                radius=(8, 8, 8, 8), border_width=5.0,
                border_color=(1, 1, 1, 0.9), color=(0.8, 0.2, 0.2, 0.9)),
        _params(top=40, left=260, width=180, height=120, radius=(10, 10, 10, 10),
                masks=[[14, 14, 14, 14, 45, 265, 170, 110, 0.3]]),
        _params(top=100, left=60, width=120, height=80, radius=(6, 6, 6, 6)),
    ]
    return (w, h), statics, params, src


def _interleaved_case():
    h, w = 96, 256
    St = jcomp.LayoutStatic
    statics = [St(content="color", static_rect=(0, 0, h, w)),
               St(content="color", static_rect=(10, 20, 40, 60))]
    params = [
        _params(top=0, left=0, width=w, height=h, color=(0.2, 0.3, 0.4, 1.0)),
        _params(top=10, left=20, width=60, height=40, radius=(5, 5, 5, 5),
                color=(0.9, 0.8, 0.1, 0.8)),
    ]
    return (w, h), statics, params, None


def _two_masks_case():
    h, w = 160, 384
    St = jcomp.LayoutStatic
    statics = [St(content="color", static_rect=(0, 0, h, w)),
               St(content="color", static_rect=(20, 40, 100, 200), n_masks=2,
                  rotated_masks=(False, True))]
    params = [
        _params(top=0, left=0, width=w, height=h, color=(0.3, 0.3, 0.3, 1.0)),
        _params(top=20, left=40, width=200, height=100, radius=(10, 10, 10, 10),
                color=(0.9, 0.4, 0.1, 0.95),
                masks=[[8, 8, 8, 8, 25, 45, 180, 80, 0.0],
                       [12, 12, 12, 12, 30, 60, 150, 70, 0.4]]),
    ]
    return (w, h), statics, params, None


def _off_canvas_case():
    h, w = 64, 128
    St = jcomp.LayoutStatic
    statics = [St(content="color", static_rect=(0, 0, h, w)),
               St(content="color", static_rect=(500, 500, 40, 40))]
    params = [
        _params(top=0, left=0, width=w, height=h, color=(0.5, 0.5, 0.5, 1.0)),
        _params(top=500, left=500, width=40, height=40, color=(1, 0, 0, 1)),
    ]
    return (w, h), statics, params, None


CASES = {"mixed": _mixed_case, "interleaved": _interleaved_case,
         "two_masks": _two_masks_case, "off_canvas": _off_canvas_case}


def _jax_compose(monkeypatch, mode, res, statics, params, src, planar):
    sources = [] if src is None else [[jnp.asarray(src)]]
    monkeypatch.setenv("SMELTER_SCENE_ASSEMBLY", mode)
    return np.asarray(jax.jit(lambda: jcomp.compose_layouts(
        res, statics, params, sources, planar=planar))())


def _port(statics, params, src):
    st, pr = interop.layouts(statics, params, "cpu")
    sources = [] if src is None else [[torch.from_numpy(src)]]
    return st, pr, sources


def _assert_canvas_close(got, ref):
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=0)
    qa = np.clip(np.round(got * 255.0), 0, 255).astype(np.int32)
    qb = np.clip(np.round(ref * 255.0), 0, 255).astype(np.int32)
    assert np.abs(qa - qb).max() <= 1


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mode", ["on", "off"])
def test_compose_matches_jax(monkeypatch, case, mode):
    res, statics, params, src = CASES[case]()
    planar = case != "interleaved"
    ref = _jax_compose(monkeypatch, mode, res, statics, params, src, planar)
    st, pr, sources = _port(statics, params, src)
    got = tcomp.compose_layouts(res, st, pr, sources, planar=planar).numpy()
    assert got.shape == ref.shape
    _assert_canvas_close(got, ref)


@pytest.mark.parametrize("case", ["mixed", "two_masks", "off_canvas"])
def test_kernel_plain_matches_pallas_interpret(monkeypatch, case):
    """K1 alone: the canvas the assembly pass creates, before any texture."""
    (w, h), statics, params, src = CASES[case]()
    monkeypatch.setenv("SMELTER_SCENE_ASSEMBLY", "on")
    clip = tcomp.canvas_clipper(h, w)
    items = list(zip(statics, params))
    ref_canvas, ref_group = jcomp._try_scene_assembly(items, 0, len(items), [], h, w, clip)
    st, pr, _ = _port(statics, params, src)
    got_canvas, got_group = tcomp._try_scene_assembly(
        list(zip(st, pr)), 0, len(st), [], h, w, clip)
    assert [s.content for s, _ in got_group] == [s.content for s, _ in ref_group]
    _assert_canvas_close(got_canvas.numpy(), np.asarray(ref_canvas))


def test_three_hundred_members_take_the_kernel():
    """No member-table bound: 300 members all route to K1 (the reference's
    TPU scalar-memory bound sends them to its group path), and the result
    equals the group path's."""
    h, w = 256, 512
    items = []
    for i in range(300):
        st = tcomp.LayoutStatic(content="color",
                                static_rect=(8 * (i % 20), 16 * (i % 30), 16, 24))
        p = interop.layout_params(dict(
            top=8 * (i % 20), left=16 * (i % 30), width=24, height=16,
            rotation_degrees=0, border_radius=(2, 2, 2, 2), border_width=0,
            border_color=(0, 0, 0, 0), color=(0.5, 0.1 * (i % 10), 0.5, 0.5),
            crop=(0, 0, 0, 0), blur_radius=0, masks=np.zeros((1, 9))), "cpu")
        items.append((st, p))
    clip = tcomp.canvas_clipper(h, w)
    specs, _, group = tcomp._assembly_members(items, 0, len(items), clip)
    assert len(specs) == 300 and not group
    canvas, group = tcomp._try_scene_assembly(items, 0, len(items), [], h, w, clip)
    assert not group
    ref = tcomp._assemble_local_run(torch.zeros((4, h, w)), items, [], h, w, clip)
    np.testing.assert_allclose(canvas.numpy(), ref.numpy(), atol=2e-5, rtol=0)


def test_member_table_is_cached_per_layouts():
    res, statics, params, _ = _two_masks_case()
    st, pr, _ = _port(statics, params, None)
    cache: dict = {}
    a = tcomp.compose_layouts(res, st, pr, [], planar=True, cache=cache)
    # the cache keeps the spec table only: the parameters are packed anew
    (spec_rows,) = cache.values()
    assert spec_rows.dtype == torch.int32 and spec_rows.shape == (2, sa.SPEC_W)
    b = tcomp.compose_layouts(res, st, pr, [], planar=True, cache=cache)
    assert torch.equal(a, b) and len(cache) == 1


def test_no_layouts_give_a_transparent_canvas():
    got = tcomp.compose_layouts((8, 4), [], [], [], planar=True, device="cpu")
    assert got.shape == (4, 4, 8) and not got.any() and got.device.type == "cpu"
    with pytest.raises(ValueError, match="no device"):
        tcomp.compose_layouts((8, 4), [], [], [], planar=True)


@pytest.mark.parametrize("static", [
    jcomp.LayoutStatic(content="texture", source_index=0, static_rect=(0, 0, 8, 8),
                       static_crop=(0, 0, 8, 8), traced_position=True),
    jcomp.LayoutStatic(content="texture", source_index=0, traced_size_buf=(64, 64)),
    jcomp.LayoutStatic(content="texture", source_index=0),
    jcomp.LayoutStatic(content="texture", source_index=0, static_rect=(3, 4, 8, 8),
                       static_crop=(0, 0, 8, 8), has_rotation=True, traced_rotation_q=0),
])
def test_unported_paths_raise(static):
    """The texture routes that raised NotImplementedError until the
    animated-geometry slice (moving, scaling, the sampled pass, traced
    rotation) now render a texture over a background as the reference
    does."""
    res = (16, 16)
    src = np.random.RandomState(2).rand(8, 8, 4).astype(np.float32)
    bg = jcomp.LayoutStatic(content="color", static_rect=(0, 0, 16, 16))
    statics = [bg, static]
    params = [_params(width=16, height=16, color=(0.1, 0.2, 0.3, 1.0)),
              _params(top=3.4, left=4.6, width=8, height=8, rotation=20.0,
                      radius=(2, 2, 2, 2), crop=(0, 0, 8, 8))]
    ref = np.asarray(jcomp.compose_layouts(res, statics, params, [[jnp.asarray(src)]],
                                           planar=True))
    st, pr, sources = _port(statics, params, src)
    got = tcomp.compose_layouts(res, st, pr, sources, planar=True).numpy()
    _assert_canvas_close(got, ref)
