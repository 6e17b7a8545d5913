"""The hand-written CUDA kernels against their plain PyTorch versions, on the
card. These need a CUDA device and nvcc, so they skip elsewhere; on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(This file imports no JAX: the machine with the card need not have it.)

Tolerances: K2 <= 1 u8 LSB per plane; K1 and K3 max abs err 0 on the f32
canvas: the kernels are built without FMA contraction, repeat their plain
versions' operations, and skip only what is exactly the identity (their
tile classes, `ops/hopper/tile_class.py`).
"""

from __future__ import annotations

import pytest
import torch

from smelter_tpu_torch import interop
from smelter_tpu_torch.ops import compose
from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(4, 200, 520), (4, 201, 519), (4, 1, 1), (4, 1080, 1920)])
@pytest.mark.parametrize("full_range", [False, True])
def test_yuv_out_kernel_matches_plain(cuda, shape, full_range):
    gen = torch.Generator(device=cuda).manual_seed(1)
    canvas = torch.rand(shape, generator=gen, device=cuda) * 1.3 - 0.1
    before = yuv_out.LAUNCHES
    got = yuv_out.rgba_cm_to_yuv420(canvas, full_range)
    torch.cuda.synchronize()
    assert yuv_out.LAUNCHES == before + 1
    ref = yuv_out.rgba_cm_to_yuv420_plain(canvas, full_range)
    for a, b in zip(ref, got):
        assert a.shape == b.shape and b.dtype == torch.uint8
        if a.numel():  # a 1x1 canvas has empty chroma planes
            assert int((a.to(torch.int32) - b.to(torch.int32)).abs().max()) <= 1


def test_yuv_out_kernel_refuses_a_strided_canvas(cuda):
    canvas = torch.zeros((4, 64, 64), device=cuda)[:, :, ::2]
    with pytest.raises(ValueError):
        yuv_out.rgba_cm_to_yuv420(canvas)


def _member(dev, kind, rect, **kw):
    fields = dict(top=rect[0], left=rect[1], height=rect[2], width=rect[3],
                  rotation_degrees=0, border_radius=(0, 0, 0, 0), border_width=0,
                  border_color=(0, 0, 0, 0), color=(0, 0, 0, 0), crop=(0, 0, 0, 0),
                  blur_radius=0, masks=[[0.0] * 9])
    fields.update(kw)
    static = dict(content=kind, static_rect=rect)
    return static, interop.layout_params(fields, dev)


def test_scene_assembly_kernel_matches_plain(cuda):
    h, w = 200, 520  # partial tiles on both axes
    members = [
        _member(cuda, "color", (0, 0, h, w), color=(0.1, 0.1, 0.15, 1.0)),
        _member(cuda, "box_shadow", (30, 40, 100, 150), blur_radius=18.0,
                border_radius=(12, 12, 12, 12), color=(0, 0, 0, 0.6)),
        _member(cuda, "color", (25, 35, 110, 160), rotation_degrees=20.0,
                border_radius=(8, 8, 8, 8), border_width=5.0,
                border_color=(1, 1, 1, 0.9), color=(0.8, 0.2, 0.2, 0.9)),
        _member(cuda, "color", (20, 300, 100, 200), border_radius=(10, 10, 10, 10),
                color=(0.9, 0.4, 0.1, 0.95),
                masks=[[8, 8, 8, 8, 25, 305, 180, 80, 0.0],
                       [12, 12, 12, 12, 30, 320, 150, 70, 0.4]]),
    ]
    statics = [
        compose.LayoutStatic(**members[0][0], no_radius=True),
        compose.LayoutStatic(**members[1][0], static_blur=18.0),
        compose.LayoutStatic(**members[2][0], has_border=True, has_rotation=True,
                             static_rotation=20.0),
        compose.LayoutStatic(**members[3][0], n_masks=2, rotated_masks=(False, True)),
    ]
    items = list(zip(statics, [p for _, p in members]))
    specs, plist, group = compose._assembly_members(items, 0, len(items),
                                                    compose.canvas_clipper(h, w))
    assert len(specs) == 4 and not group
    params = scene_assembly.pack_member_params(plist, 2)
    before = scene_assembly.LAUNCHES
    got = scene_assembly.assemble_scene_planar((w, h), specs, params)
    torch.cuda.synchronize()
    assert scene_assembly.LAUNCHES == before + 1
    ref = scene_assembly.assemble_scene_planar_plain((w, h), specs, params)
    assert float((got - ref).abs().max()) == 0.0


def _layer_rows(dev, n, h, w, seed):
    """(n, 19) K3 rows and kinds: colour, bordered and shadow layers, every
    third one rotated, scattered over (and past the edges of) an h x w canvas."""
    gen = torch.Generator().manual_seed(seed)
    rows, kinds = [], []
    for i in range(n):
        u = torch.rand(19, generator=gen)
        content = ("color", "color", "box_shadow")[i % 3]
        has_border = content == "color" and i % 2 == 1
        kinds.append((content, has_border, i % 3 == 1))
        lw, lh = 30 + u[2] * w * 0.6, 20 + u[3] * h * 0.6
        rows.append([
            u[0] * h - 10, u[1] * w - 10, lw, lh, u[4] * 360 - 180,
            *(u[5:9] * min(lw, lh) * 0.4), *u[9:12], 0.3 + 0.7 * u[12],
            1 + u[13] * 8, *u[14:18], u[18] * 30,
        ])
    return torch.tensor(rows, dtype=torch.float32, device=dev), tuple(kinds)


@pytest.mark.parametrize("n,h,w", [(1, 1, 1), (4, 257, 511), (16, 200, 520)])
def test_sdf_layers_kernel_matches_plain(cuda, n, h, w):
    params, kinds = _layer_rows(cuda, n, h, w, seed=n)
    gen = torch.Generator(device=cuda).manual_seed(2)
    canvas = torch.rand((4, h, w), generator=gen, device=cuda)
    ref = sdf_layers.compose_sdf_layers_planar_plain(canvas, params, kinds)
    before = sdf_layers.LAUNCHES
    got = sdf_layers.compose_sdf_layers_planar(canvas, params, kinds)
    torch.cuda.synchronize()
    assert sdf_layers.LAUNCHES == before + 1
    assert got.data_ptr() == canvas.data_ptr()  # in place
    assert float((got - ref).abs().max()) == 0.0


def test_sdf_layers_kernel_leaves_tiles_no_layer_reaches(cuda):
    params, kinds = _layer_rows(cuda, 6, 256, 512, seed=7)
    params[:, 1] += 2000.0  # every layer right of the canvas
    gen = torch.Generator(device=cuda).manual_seed(3)
    canvas = torch.rand((4, 256, 512), generator=gen, device=cuda)
    canvas[0, 0, 0] = -0.0  # a plain OVER with a zero layer would make it +0
    before = canvas.clone()
    got = sdf_layers.compose_sdf_layers_planar(canvas, params, kinds)
    torch.cuda.synchronize()
    assert torch.equal(got, before) and got[0, 0, 0].signbit()


def test_sdf_layers_kernel_refuses_bad_tables(cuda):
    params, kinds = _layer_rows(cuda, 2, 64, 64, seed=0)
    canvas = torch.zeros((4, 64, 64), device=cuda)
    with pytest.raises(ValueError):
        sdf_layers.compose_sdf_layers_planar(canvas, params[:, :18].contiguous(), kinds)
    with pytest.raises(ValueError):
        sdf_layers.compose_sdf_layers_planar(canvas[:, :, ::2], params, kinds)
    with pytest.raises(ValueError):
        sdf_layers.compose_sdf_layers_planar(canvas, params.cpu(), kinds)
