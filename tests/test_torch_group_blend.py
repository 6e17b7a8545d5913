"""Kernel K4's plain version (`smelter_tpu_torch/ops/hopper/group_blend.py`,
reached through `compose._blend_group`) and kernel K5's plain version
(`ops/hopper/row_shear.py`, the barrel shear of `ops/rotate.py`) against the
JAX package on the CPU, and the host side of both kernels' launches.

K4: one coalesced group blended over its union, each member kind (a YUV
tile with and without a border, an RGBA tile, a stably rotated tile, and
"sdf" members: colour layers upright and rotated, bordered and not, and
box-shadow layers), 0, 1 and 2 masks, rotated and not, unions clipped at
the canvas edge, a tile partly off its union and a group of several
members, on f32, u16, f16 and bf16 canvases, against the reference's
`_blend_group`. Tolerance: <= 1 u8 LSB on every plane after the YUV420
output (K2's plain version on both decoded canvases): the reference's
resize GEMMs and SDF chains round in another order (bf16 dots, contracted
multiply-adds) than the port's f32 GEMMs on bf16 values.

K5: the width and height shears against the reference's `_shear_w` and
`_shear_h` within 1 f32 ulp (each is selects and one two-tap blend per
pixel, which the reference's XLA on the CPU contracts into a multiply-add
and the port rounds twice, as `tests/test_torch_rotate.py` states); the
kernel's gather formula, written in numpy, against the barrel shifter, bit
for bit; `rotate_static_cm` at 30, -15, 45 and 120 degrees at atol 1e-5.
"""

from __future__ import annotations

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.ops import compose as jcomp
from smelter_tpu.ops import rotate as jrot
from smelter_tpu_torch import interop
from smelter_tpu_torch.ops import color_convert as tcc
from smelter_tpu_torch.ops import compose as tcomp
from smelter_tpu_torch.ops import rotate as trot
from smelter_tpu_torch.ops.hopper import group_blend, row_shear, yuv_out

torch.set_num_threads(2)

H, W = 96, 256
DTYPES = {"f32": (torch.float32, jnp.float32), "u16": (torch.uint16, jnp.uint16),
          "f16": (torch.float16, jnp.float16), "bf16": (torch.bfloat16, jnp.bfloat16)}


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


MASK_1 = [[6, 6, 6, 6, 12, 24, 60, 36, 0.0]]
MASK_2 = [[6, 6, 6, 6, 12, 24, 200, 70, 0.0],
          [10, 10, 10, 10, 20, 110, 120, 60, 0.35]]


def _member(name, masks=None):
    """(reference static, reference params) of one named member; `masks`
    adds parent masks (the second one rotated)."""
    St = jcomp.LayoutStatic
    n = 0 if masks is None else len(masks)
    mk = dict(n_masks=n, rotated_masks=tuple(i == 1 for i in range(n)))
    if name in ("yuv", "yuv_border", "yuv_edge"):
        rect = {"yuv": (10, 20, 40, 70), "yuv_border": (10, 20, 40, 70),
                "yuv_edge": (70, 200, 40, 90)}[name]
        border = name == "yuv_border"
        st = St(content="texture", source_index=0, static_rect=rect,
                static_crop=(4, 6, 56, 84), has_border=border, **mk)
        p = _params(top=rect[0], left=rect[1], height=rect[2], width=rect[3],
                    radius=(6, 8, 10, 4), border_width=3.0 if border else 0.0,
                    border_color=(1.0, 0.9, 0.8, 0.85), masks=masks)
        return st, p
    if name == "rgba":
        st = St(content="texture", source_index=1, static_rect=(30, 120, 50, 90),
                static_crop=(0, 0, 48, 80), **mk)
        return st, _params(top=30, left=120, height=50, width=90, radius=(12, 12, 12, 12),
                           masks=masks)
    if name == "rotated":
        st = St(content="texture", source_index=0, static_rect=(24, 150, 40, 64),
                static_crop=(0, 0, 64, 96), has_rotation=True, static_rotation=30.0,
                has_border=True, **mk)
        return st, _params(top=24, left=150, height=40, width=64, rotation=30.0,
                           radius=(8, 8, 8, 8), border_width=2.0,
                           border_color=(0.2, 0.4, 1.0, 1.0), masks=masks)
    if name == "colour":
        st = St(content="color", static_rect=(8, 12, 30, 50), has_border=True,
                has_rotation=True, static_rotation=15.0, **mk)
        return st, _params(top=8, left=12, height=30, width=50, rotation=15.0,
                           radius=(5, 5, 5, 5), border_width=2.5,
                           border_color=(1, 1, 1, 0.9), color=(0.8, 0.2, 0.3, 0.9),
                           masks=masks)
    if name == "ring":  # the multiview's bordered card: upright, transparent fill
        st = St(content="color", static_rect=(20, 60, 50, 90), has_border=True, **mk)
        return st, _params(top=20, left=60, height=50, width=90, radius=(12, 12, 12, 12),
                           border_width=4.0, border_color=(1, 1, 1, 1), masks=masks)
    if name == "colour_rotated":
        st = St(content="color", static_rect=(30, 40, 36, 64), has_rotation=True,
                static_rotation=-40.0, **mk)
        return st, _params(top=30, left=40, height=36, width=64, rotation=-40.0,
                           radius=(9, 3, 9, 3), color=(0.1, 0.7, 0.4, 0.8), masks=masks)
    if name in ("shadow", "shadow_masked"):
        st = St(content="box_shadow", static_rect=(40, 30, 30, 60), static_blur=10.0, **mk)
        return st, _params(top=40, left=30, height=30, width=60, blur=10.0,
                           radius=(8, 8, 8, 8), color=(0.0, 0.0, 0.0, 0.6), masks=masks)
    raise KeyError(name)


# name -> (members, masks of the masked members, union)
CASES = {
    "yuv": (["yuv"], None, (8, 0, 56, 128)),
    "yuv_border": (["yuv_border"], None, (8, 0, 56, 128)),
    "rgba": (["rgba"], None, (24, 0, 64, 256)),
    "rotated": (["rotated"], None, (0, 128, 96, 128)),
    "colour_and_shadow": (["shadow", "colour"], None, (0, 0, 80, 128)),
    "yuv_one_mask": (["yuv_border"], MASK_1, (8, 0, 56, 128)),
    "rgba_two_masks": (["rgba"], MASK_2, (24, 0, 64, 256)),
    "rotated_two_masks": (["rotated"], MASK_2, (0, 128, 96, 128)),
    "colour_two_masks": (["colour", "shadow"], MASK_2, (0, 0, 80, 128)),
    "clipped_at_the_canvas_edge": (["yuv_edge"], None, (64, 128, 32, 128)),
    "tile_partly_off_its_union": (["yuv_border"], None, (16, 0, 16, 128)),
    "several": (["shadow", "yuv_border", "rgba", "colour", "rotated"], MASK_1, (0, 0, H, W)),
    "ring_and_rotated_colour": (["ring", "colour_rotated"], None, (0, 0, 96, 256)),
    "ring_one_mask": (["ring"], MASK_1, (16, 0, 64, 256)),
    "rotated_colour_two_masks": (["colour_rotated", "yuv"], MASK_2, (0, 0, 80, 128)),
    "shadow_rotated_mask": (["shadow_masked", "yuv"], MASK_2, (0, 0, 80, 128)),
}
MASKED = {"yuv_border", "rgba", "rotated", "colour", "ring", "colour_rotated", "shadow_masked"}


def _sources():
    rng = np.random.RandomState(7)
    y = rng.randint(0, 256, (64, 96)).astype(np.uint8)
    u = rng.randint(0, 256, (32, 48)).astype(np.uint8)
    v = rng.randint(0, 256, (32, 48)).astype(np.uint8)
    rgba = rng.rand(48, 80, 4).astype(np.float32)
    ref = [jcc.DeferredYuvSource(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)),
           [jnp.asarray(rgba)]]
    port = [tcc.DeferredYuvSource(torch.from_numpy(y), torch.from_numpy(u),
                                  torch.from_numpy(v)),
            [torch.from_numpy(rgba)]]
    return ref, port


def _canvas():
    rng = np.random.RandomState(3)
    c = rng.rand(4, H, W).astype(np.float32)
    c[:3] *= c[3:4]  # premultiplied
    return c


def _yuv420(canvas_f32: np.ndarray):
    return [p.numpy().astype(np.int32)
            for p in yuv_out.rgba_cm_to_yuv420_plain(torch.from_numpy(canvas_f32))]


def _run_case(case, dtype_name):
    names, masks, union = CASES[case]
    members = [_member(n, masks if n in MASKED else None) for n in names]
    tdt, jdt = DTYPES[dtype_name]
    base = _canvas()
    ref_sources, port_sources = _sources()

    ref_canvas = jcomp._canvas_encode(jnp.asarray(base), jdt)
    ref = jax.jit(lambda c: jcomp._blend_group(c, members, union, ref_sources, H, W))(
        ref_canvas)
    ref = np.array(jcc.canvas_decode(ref))

    st, pr = interop.layouts([s for s, _ in members], [p for _, p in members], "cpu")
    port_canvas = tcomp._canvas_encode(torch.from_numpy(base.copy()), tdt)
    got = tcomp._blend_group(port_canvas, list(zip(st, pr)), union, port_sources, H, W)
    assert got.dtype == tdt and tuple(got.shape) == (4, H, W)
    return tcc.canvas_decode(got).numpy(), ref


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype_name", ["f32", "u16"])
def test_group_blend_plain_matches_the_reference(case, dtype_name):
    got, ref = _run_case(case, dtype_name)
    for a, b in zip(_yuv420(got), _yuv420(ref)):
        assert np.abs(a - b).max() <= 1


@pytest.mark.parametrize("dtype_name", ["f16", "bf16"])
@pytest.mark.parametrize("case", ["several", "rgba_two_masks"])
def test_group_blend_plain_matches_the_reference_on_16_bit_floats(case, dtype_name):
    got, ref = _run_case(case, dtype_name)
    for a, b in zip(_yuv420(got), _yuv420(ref)):
        assert np.abs(a - b).max() <= 1


def test_group_members_take_the_kind_of_their_inputs(monkeypatch):
    """`_blend_group` hands K4 a YUV tile's three GEMM products, an RGBA
    tile, a rotated tile at its bbox's origin with its masks still to apply
    ("placed"), and colour and shadow layouts with no planes at their static
    rects, for K4 to evaluate with their masks ("sdf")."""
    seen = []
    monkeypatch.setattr(group_blend, "blend_group",
                        lambda canvas, members, union, h, w: seen.extend(members) or canvas)
    names = ["shadow", "yuv", "rgba", "colour", "rotated"]
    members = [_member(n, MASK_1) for n in names]
    st, pr = interop.layouts([s for s, _ in members], [p for _, p in members], "cpu")
    _, sources = _sources()
    tcomp._blend_group(torch.zeros((4, H, W)), list(zip(st, pr)), (0, 0, H, W), sources, H, W)
    assert [m.kind for m in seen] == ["sdf", "yuv", "rgba", "sdf", "placed"]
    assert [m.n_masks for m in seen] == [1, 1, 1, 1, 1]
    yuv = seen[1]
    assert [tuple(p.shape) for p in yuv.planes] == [(40, 70)] * 3
    assert all(p.dtype == torch.float32 for p in yuv.planes)
    assert yuv.origin == (10, 20) and yuv.full_range is False
    bh, bw = trot.rotated_bbox(30.0, 40, 64)
    assert seen[4].size == (bh, bw)
    assert seen[4].origin == (24 + (40 - bh) // 2, 150 + (64 - bw) // 2)
    for m, rect in ((seen[0], (40, 30, 30, 60)), (seen[3], (8, 12, 30, 50))):
        assert m.planes == () and m.origin == rect[:2] and m.size == rect[2:]
    # the products' colour tail is the tile `tile_cm` gives
    tile = sources[0].tile_cm((4, 6, 56, 84), 40, 70)
    assert torch.equal(tcc.yuv_products_rgba_cm(*yuv.planes), tile)


def _yuv_member(k=0):
    st = tcomp.LayoutStatic(content="texture", source_index=0, static_rect=(k, 0, 4, 8),
                            static_crop=(0, 0, 4, 8), n_masks=2, rotated_masks=(False, True))
    p = interop.layout_params(dict(
        top=k, left=0, width=8, height=4, rotation_degrees=0,
        border_radius=(0, 0, 0, 0), border_width=0, border_color=(0, 0, 0, 0),
        color=(0, 0, 0, 0), crop=(0, 0, 4, 8), blur_radius=0,
        masks=np.zeros((2, 9))), "cpu")
    planes = tuple(torch.full((4, 8), float(c)) for c in range(3))
    return group_blend.GroupMember("yuv", st, p, planes, (k, 0))


def test_descriptors_hold_each_member():
    members = [_yuv_member(k) for k in range(3)]
    layer = torch.zeros((4, 6, 10))[:, 1:, 2:]  # a view: rows of adjacent pixels
    members.append(group_blend.GroupMember("placed", members[0].static, members[0].params,
                                           (layer,), (5, -3)))
    shadow = tcomp.LayoutStatic(content="box_shadow", static_rect=(7, 9, 20, 30), n_masks=2,
                                rotated_masks=(True, False), has_rotation=True,
                                has_border=True, static_rotation=12.0)
    members.append(group_blend.GroupMember("sdf", shadow, members[0].params, (), (7, 9)))
    rows = group_blend.pack_member_params([m.params for m in members], 2)
    arr = group_blend.describe(members, rows, torch.device("cpu"))
    assert ctypes.sizeof(group_blend._Member) == 104
    for k, m in enumerate(members[:3]):
        d = arr[k]
        assert list(d.plane)[:3] == [t.data_ptr() for t in m.planes] and d.plane[3] is None
        assert list(d.row_stride) == [8, 8, 8, 0]
        assert d.params == rows.data_ptr() + k * rows.shape[1] * 4
        assert (d.kind, d.n_masks, d.rotated_bits, d.top, d.left, d.h, d.w) == (
            0, 2, 2, k, 0, 4, 8)
    d = arr[3]
    assert list(d.plane) == [layer.data_ptr() + c * 60 * 4 for c in range(4)]
    assert list(d.row_stride) == [10] * 4
    assert (d.kind, d.n_masks, d.top, d.left, d.h, d.w) == (2, 2, 5, -3, 5, 8)
    assert (d.sdf_kind, d.has_rotation) == (0, 0)
    # an sdf member: no planes, its row, the shadow kind, rotated, its masks
    d = arr[4]
    assert list(d.plane) == [None] * 4 and list(d.row_stride) == [0] * 4
    assert d.params == rows.data_ptr() + 4 * rows.shape[1] * 4
    assert (d.kind, d.sdf_kind, d.has_rotation, d.has_border, d.n_masks, d.rotated_bits) == (
        3, 1, 1, 1, 2, 1)
    assert (d.top, d.left, d.h, d.w) == (7, 9, 20, 30)


def test_the_member_cap_raises_with_the_count():
    members = [_yuv_member() for _ in range(group_blend.MAX_MEMBERS + 1)]
    rows = group_blend.pack_member_params([m.params for m in members], 2)
    with pytest.raises(ValueError, match=f"at most {group_blend.MAX_MEMBERS} members a "
                                         f"launch, got {group_blend.MAX_MEMBERS + 1}"):
        group_blend.describe(members, rows, torch.device("cpu"))
    # a 16-bit canvas cannot split a group across launches
    canvas = torch.zeros((4, 16, 16), dtype=torch.uint16)
    with pytest.raises(ValueError, match=f"a group of {group_blend.MAX_MEMBERS + 1} on a "
                                         f"torch.uint16 canvas cannot be split"):
        group_blend._launch(canvas, members, (0, 0, 16, 16))


def test_mixed_devices_are_refused():
    m = _yuv_member()
    rows = group_blend.pack_member_params([m.params], 2)
    meta = group_blend.GroupMember("yuv", m.static, m.params,
                                   tuple(t.to("meta") for t in m.planes), m.origin)
    with pytest.raises(ValueError, match="tensor is on meta, the canvas on cpu"):
        group_blend.describe([meta], rows, torch.device("cpu"))
    with pytest.raises(ValueError, match="packed parameters"):
        group_blend.describe([m], rows, torch.device("meta"))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        group_blend.blend_group(torch.zeros((4, 8, 8), device="meta"), [m], (0, 0, 4, 8), 8, 8)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        row_shear.shear(torch.zeros((4, 8, 8), device="meta"), 0.3, -1)


def test_descriptors_refuse_strided_rows_and_other_dtypes():
    m = _yuv_member()
    rows = group_blend.pack_member_params([m.params], 2)
    strided = group_blend.GroupMember(
        "yuv", m.static, m.params, tuple(torch.zeros((4, 16))[:, ::2] for _ in range(3)),
        m.origin)
    with pytest.raises(ValueError, match="adjacent pixels"):
        group_blend.describe([strided], rows, torch.device("cpu"))
    half = group_blend.GroupMember("yuv", m.static, m.params,
                                   tuple(t.half() for t in m.planes), m.origin)
    with pytest.raises(ValueError, match="f32 member tensors"):
        group_blend.describe([half], rows, torch.device("cpu"))


# --- K5 ----------------------------------------------------------------------


def _image(shape, seed=2):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("k", [-0.27, 0.27, 0.5, -0.7, 0.001, 1e-13, 0.9])
@pytest.mark.parametrize("axis", [-1, -2])
def test_shear_plain_equals_the_reference(k, axis):
    img = _image((4, 40, 30))
    jfn = jrot._shear_w if axis == -1 else jrot._shear_h
    ref = np.asarray(jax.jit(lambda t: jfn(t, k))(img))
    got = np.ascontiguousarray(row_shear.shear(torch.from_numpy(img), k, axis).numpy())
    assert got.shape == ref.shape
    ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def _gather_shear(img: np.ndarray, k: float) -> np.ndarray:
    """csrc/row_shear.cu's formula for a width shear, in numpy f32."""
    c, h, w = img.shape
    out = np.zeros_like(img)
    for r in range(h):
        d = k * ((float(r) + 0.5) - h / 2.0)
        fl = np.floor(d)
        i, f = int(fl), np.float32(d - fl)
        for x in range(w):
            p0, p1 = x - i, x - i - 1
            a = img[:, r, p0] if 0 <= p0 < w else np.zeros(c, np.float32)
            b = img[:, r, p1] if 0 <= p1 < w else np.zeros(c, np.float32)
            out[:, r, x] = a * (np.float32(1.0) - f) + b * f
    return out


@pytest.mark.parametrize("k", [-0.41, 0.41, 0.7, 0.003])
def test_the_kernels_gather_equals_the_barrel(k):
    """K5 reads each output pixel's two taps directly; in numpy that gather
    is bit-equal to the barrel shifter it stands for, along both axes."""
    img = _image((2, 24, 31), seed=5)
    np.testing.assert_array_equal(_gather_shear(img, k),
                                  row_shear.shear_plain(torch.from_numpy(img), k, -1).numpy())
    t = np.ascontiguousarray(img.transpose(0, 2, 1))
    np.testing.assert_array_equal(_gather_shear(t, k).transpose(0, 2, 1),
                                  row_shear.shear_plain(torch.from_numpy(img), k, -2).numpy())


def test_shear_edge_cases():
    img = torch.from_numpy(_image((4, 40, 6)))
    # too small to matter: the input itself
    assert row_shear.shear(img, 1e-13, -1) is img
    # every row moved out of the image: zeros, as the barrel's plan says
    assert trot.shear_moves_all_out(0.9, 40, 6) and trot._shear_plan(0.9, 40, 6, "cpu") is None
    assert not row_shear.shear(img, 0.9, -1).any()
    assert not row_shear.shear(img.transpose(-2, -1), 0.9, -2).any()
    with pytest.raises(ValueError, match="axis"):
        row_shear.shear(img, 0.3, 0)


@pytest.mark.parametrize("theta", [30.0, -15.0, 45.0, 120.0])
def test_rotate_static_cm_through_the_shear_wrapper(theta):
    tile = _image((4, 48, 80), seed=9)
    out_h, out_w = jrot.rotated_bbox(theta, 48, 80)
    ref = np.asarray(jax.jit(lambda t: jrot.rotate_static_cm(t, theta, out_h, out_w))(tile))
    got = trot.rotate_static_cm(torch.from_numpy(tile), theta, out_h, out_w)
    assert tuple(got.shape) == ref.shape == (4, out_h, out_w)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
