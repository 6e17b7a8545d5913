"""Parity of kernel K3's plain version (`smelter_tpu_torch/ops/hopper/
sdf_layers.py`) with the JAX package's `compose_sdf_layers_planar`, which
off the TPU runs the Pallas kernel in interpret mode, on the layers of
`tests/test_pallas_sdf.py`.

Tolerance: atol 2e-5 on the f32 canvas and <= 1 LSB after u8 quantisation
(the two sides may round `cos`/`sin` and the SDF chain one ulp apart).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.ops.compose import LayoutParams as JParams
from smelter_tpu.ops.pallas import sdf_layers as jsl
from smelter_tpu_torch import interop
from smelter_tpu_torch.ops.hopper import sdf_layers as tsl

torch.set_num_threads(2)


def _params(top, left, w, h, color, radius=0.0, rot=0.0, border_w=0.0,
            border_color=(1, 1, 1, 1), blur=0.0):
    return JParams(
        top=np.float32(top), left=np.float32(left),
        width=np.float32(w), height=np.float32(h),
        rotation_degrees=np.float32(rot),
        border_radius=np.full(4, radius, np.float32),
        border_width=np.float32(border_w),
        border_color=np.asarray(border_color, np.float32),
        color=np.asarray(color, np.float32),
        crop=np.zeros(4, np.float32),
        blur_radius=np.float32(blur),
        masks=np.zeros((1, 9), np.float32),
    )


# the layers of tests/test_pallas_sdf.py: (content, has_border, has_rotation)
LAYERS = [
    (("box_shadow", False, False),
     _params(40, 50, 120, 80, (0, 0, 0, 0.7), radius=12.0, blur=15.0)),
    (("color", False, False),
     _params(30, 40, 120, 80, (0.8, 0.2, 0.2, 1.0), radius=12.0)),
    (("color", True, False),
     _params(90, 160, 100, 60, (0.1, 0.5, 0.9, 0.9), radius=8.0,
             border_w=4.0, border_color=(1, 1, 0, 1))),
    (("color", False, True),
     _params(20, 180, 90, 50, (0.2, 0.9, 0.3, 0.8), rot=25.0)),
]


def _quantized(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x * 255.0), 0, 255).astype(np.int32)


@pytest.mark.parametrize("canvas_kind", ["zeros", "random"])
@pytest.mark.parametrize("size", [(180, 320), (257, 511)])
def test_plain_matches_jax_kernel(size, canvas_kind):
    h, w = size
    if canvas_kind == "zeros":
        canvas = np.zeros((4, h, w), np.float32)
    else:
        canvas = np.random.RandomState(3).rand(4, h, w).astype(np.float32)
    kinds = tuple(k for k, _ in LAYERS)
    plist = [p for _, p in LAYERS]
    ref = np.asarray(jsl.compose_sdf_layers_planar(
        jnp.asarray(canvas), jsl.pack_layer_params_traced(plist), kinds))
    rows = tsl.pack_layer_params([interop.layout_params(p, "cpu") for p in plist])
    got = tsl.compose_sdf_layers_planar(torch.from_numpy(canvas.copy()), rows, kinds)
    got = got.numpy()
    assert got.shape == ref.shape == (4, h, w)
    assert np.abs(got - ref).max() <= 2e-5
    assert np.abs(_quantized(got) - _quantized(ref)).max() <= 1


def test_pack_layer_params_matches_traced_packing():
    plist = [p for _, p in LAYERS]
    ref = np.asarray(jsl.pack_layer_params_traced(plist))
    got = tsl.pack_layer_params([interop.layout_params(p, "cpu") for p in plist])
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(plist), tsl.PARAMS_WIDTH)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wrapper_routes_by_device():
    canvas = torch.rand((4, 8, 8))
    # no layers: the canvas passes through untouched
    assert tsl.compose_sdf_layers_planar(canvas, torch.zeros((0, 19)), ()) is canvas
    before = tsl.LAUNCHES
    rows = tsl.pack_layer_params([interop.layout_params(LAYERS[1][1], "cpu")])
    out = tsl.compose_sdf_layers_planar(canvas, rows, (LAYERS[1][0],))
    assert out is not canvas and tsl.LAUNCHES == before  # the plain version
    with pytest.raises(ValueError):
        tsl.compose_sdf_layers_planar(canvas.to("meta"), rows.to("meta"),
                                      (LAYERS[1][0],))


def test_kinds_table_encoding():
    table = tsl.kinds_table(tuple(k for k, _ in LAYERS), "cpu")
    assert table.dtype == torch.int32
    assert table.tolist() == [[1, 0, 0], [0, 0, 0], [0, 1, 0], [0, 0, 1]]
