"""Parity of kernel K2's plain version (`smelter_tpu_torch/ops/hopper/
yuv_out.py`) with the JAX package on the CPU: against the Pallas kernel in
interpret mode on the shapes it takes, and against the XLA chain on those,
on 1080p (which the TPU kernel refuses) and on an odd size.

Tolerance: <= 1 u8 LSB per plane (the reference's own gate between its
kernel and its chain): sums of another order, or a multiply-add contracted
on one side only, can move a value across a rounding boundary.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.ops.pallas import yuv_out as jyuv
from smelter_tpu_torch.ops import color_convert as tcc
from smelter_tpu_torch.ops.hopper import yuv_out

torch.set_num_threads(2)


def _xla_chain(canvas, full_range):
    y, u, v = jcc.rgb_planes_to_yuv(canvas[0], canvas[1], canvas[2], full_range)
    return (
        jcc.f32_to_u8(y),
        jcc.f32_to_u8(jcc.downsample_chroma_2x2(u)),
        jcc.f32_to_u8(jcc.downsample_chroma_2x2(v)),
    )


def _canvas(shape, seed=7):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 1.3 - 0.1).astype(np.float32)


def _assert_within_one_lsb(ref, got):
    for name, a, b in zip("yuv", ref, got):
        a = np.asarray(a)
        assert b.dtype == torch.uint8, name
        assert b.shape == a.shape, name
        assert np.abs(a.astype(int) - b.numpy().astype(int)).max() <= 1, name


@pytest.mark.parametrize("shape", [(4, 256, 256), (4, 272, 512), (4, 512, 768)])
@pytest.mark.parametrize("full_range", [False, True])
def test_plain_matches_pallas_interpret(shape, full_range):
    canvas = _canvas(shape)
    assert jyuv.eligible(canvas)
    ref = jyuv.rgba_cm_to_yuv420_fused(canvas, full_range)
    got = yuv_out.rgba_cm_to_yuv420_plain(torch.from_numpy(canvas), full_range)
    _assert_within_one_lsb(ref, got)


@pytest.mark.parametrize("shape", [(4, 256, 256), (4, 272, 512), (4, 512, 768),
                                   (4, 1080, 1920), (4, 201, 519)])
@pytest.mark.parametrize("full_range", [False, True])
def test_plain_matches_xla_chain(shape, full_range):
    canvas = _canvas(shape)
    ref = jax.jit(lambda c: _xla_chain(c, full_range))(canvas)
    got = yuv_out.rgba_cm_to_yuv420(torch.from_numpy(canvas), full_range)
    assert got[0].shape == (shape[1], shape[2])
    assert got[1].shape == (shape[1] // 2, shape[2] // 2)
    _assert_within_one_lsb(ref, got)


def test_saturated_and_flat_values_exact():
    h, w = 272, 512
    canvas = np.zeros((4, h, w), np.float32)
    canvas[0] = 1.2   # clipped red
    canvas[1] = -0.1  # clipped green
    canvas[2] = 0.5
    canvas[3] = 1.0
    ref = jax.jit(lambda c: _xla_chain(c, False))(canvas)
    got = yuv_out.rgba_cm_to_yuv420(torch.from_numpy(canvas))
    for name, a, b in zip("yuv", ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def test_cpu_tensor_takes_the_plain_version():
    canvas = torch.from_numpy(_canvas((4, 64, 96)))
    before = yuv_out.LAUNCHES
    got = tcc.planar_rgba_to_yuv420(canvas)
    ref = yuv_out.rgba_cm_to_yuv420_plain(canvas)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert yuv_out.LAUNCHES == before  # no kernel launch on the CPU


def test_other_devices_are_refused():
    with pytest.raises(ValueError):
        yuv_out.rgba_cm_to_yuv420(torch.empty((4, 8, 8), device="meta"))
