"""Parity of the port's resampling and colour conversion
(`smelter_tpu_torch/ops/resample.py`, `ops/color_convert.py`) with the JAX
package on the CPU, at small sizes.

Tolerances:
  - weight matrices: identical (the numpy code is a copy);
  - `resize_matmul`: 1 bf16 ulp. Both sides form exact bf16 x bf16
    products and sum them in f32, in another order; an order difference
    can move a sum across a bf16 rounding boundary;
  - `yuv_tile_rgba_cm`: atol 1e-5 on the f32 tile (f32 summation order);
  - `rgb_planes_to_yuv` + `f32_to_u8`: <= 1 u8 LSB (XLA may contract
    multiply-adds that PyTorch rounds one at a time).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.ops import resample as jrs
from smelter_tpu_torch.ops import color_convert as tcc
from smelter_tpu_torch.ops import resample as trs

torch.set_num_threads(2)


@pytest.mark.parametrize("in_size,out_size,kind", [
    (1080, 540, "lanczos3"), (1920, 853, "lanczos3"), (144, 432, "lanczos3"),
    (108, 216, "lanczos3"), (100, 37, "bilinear"), (37, 100, "bilinear"),
])
def test_axis_weights_identical(in_size, out_size, kind):
    np.testing.assert_array_equal(
        trs._dense_axis_weights(in_size, out_size, kind),
        jrs._dense_axis_weights(in_size, out_size, kind),
    )
    if kind == "lanczos3":
        for a, b in zip(trs.lanczos_axis_weights(in_size, out_size),
                        jrs.lanczos_axis_weights(in_size, out_size)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_full,n_sub", [(144, 72), (1080, 540), (90, 90)])
def test_chroma_upsample_matrix_identical(n_full, n_sub):
    np.testing.assert_array_equal(
        tcc._chroma_upsample_matrix(n_full, n_sub),
        jcc._chroma_upsample_matrix(n_full, n_sub),
    )


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("shape,out_hw", [
    ((3, 108, 192), (216, 384)),   # upscale, batched
    ((2, 144, 256), (61, 100)),    # downscale
    ((72, 128), (72, 300)),        # one axis only
])
def test_resize_matmul_within_one_bf16_ulp(shape, out_hw):
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, shape).astype(np.uint8)
    ref = np.asarray(jax.jit(lambda x: jrs.resize_matmul(x, *out_hw))(img)
                     .astype(jnp.float32))
    got = trs.resize_matmul(torch.from_numpy(img), *out_hw).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    # the port holds bf16 values in f32
    np.testing.assert_array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
    tol = _bf16_ulp(np.maximum(np.abs(ref), np.abs(got)))
    assert (np.abs(got - ref) <= tol).all()


@pytest.mark.parametrize("crop,out_hw", [
    ((0, 0, 144, 256), (200, 300)),
    ((10, 20, 100, 200), (77, 150)),
    ((0, 0, 144, 256), (48, 85)),
])
@pytest.mark.parametrize("full_range", [False, True])
def test_yuv_tile_rgba_cm_matches(crop, out_hw, full_range):
    rng = np.random.RandomState(5)
    # 0..255 on purpose: out-of-range YUV must blend linearly, unclamped
    y = rng.randint(0, 256, (144, 256)).astype(np.uint8)
    u = rng.randint(0, 256, (72, 128)).astype(np.uint8)
    v = rng.randint(0, 256, (72, 128)).astype(np.uint8)
    ref = np.asarray(jax.jit(lambda a, b, c: jcc.yuv_tile_rgba_cm(
        a, b, c, crop, *out_hw, full_range=full_range))(y, u, v))
    src = tcc.DeferredYuvSource(*(torch.from_numpy(p) for p in (y, u, v)),
                                full_range=full_range)
    got = src.tile_cm(crop, *out_hw).numpy()
    assert got.shape == ref.shape == (4, *out_hw)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("full_range", [False, True])
def test_rgb_planes_to_yuv_u8_within_one_lsb(full_range):
    rng = np.random.RandomState(9)
    rgb = (rng.rand(3, 96, 160) * 1.3 - 0.1).astype(np.float32)
    ref = jax.jit(lambda c: [jcc.f32_to_u8(p) for p in
                             jcc.rgb_planes_to_yuv(c[0], c[1], c[2], full_range)])(rgb)
    t = torch.from_numpy(rgb)
    got = [tcc.f32_to_u8(p) for p in tcc.rgb_planes_to_yuv(t[0], t[1], t[2], full_range)]
    for a, b in zip(ref, got):
        assert b.dtype == torch.uint8
        assert np.abs(np.asarray(a).astype(int) - b.numpy().astype(int)).max() <= 1


def test_f32_to_u8_rounds_half_to_even():
    x = np.array([0.5, 1.5, 2.5, 254.5, -3.0, 300.0], np.float32) / 255.0
    ref = np.asarray(jcc.f32_to_u8(jnp.asarray(x)))
    got = tcc.f32_to_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(6, 8), (7, 9)])
def test_downsample_chroma_2x2_valid(shape):
    rng = np.random.RandomState(2)
    plane = rng.rand(*shape).astype(np.float32)
    ref = np.asarray(jcc.downsample_chroma_2x2(jnp.asarray(plane)))
    got = tcc.downsample_chroma_2x2(torch.from_numpy(plane)).numpy()
    assert got.shape == (shape[0] // 2, shape[1] // 2)
    np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)


@pytest.mark.parametrize("shape,levels", [((64, 96, 4), 4), ((37, 50, 4), 3), ((9, 9, 4), 5)])
def test_build_mips_matches_jax(shape, levels):
    """`build_mips` (and its `box_downsample_2x`) against the JAX package's:
    the same levels, odd sizes dropping the last row and column, atol 1e-6
    (mean of four f32 values in another summation order)."""
    img = np.random.RandomState(5).rand(*shape).astype(np.float32)
    ref = jrs.build_mips(jnp.asarray(img), levels)
    got = trs.build_mips(torch.from_numpy(img), levels)
    assert [tuple(m.shape) for m in got] == [tuple(m.shape) for m in ref]
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6)
