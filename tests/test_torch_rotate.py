"""Parity of the port's static barrel-shear rotation
(`smelter_tpu_torch/ops/rotate.py`) with the JAX package on the CPU.

Tolerance: atol 1e-5 on the f32 tile. The shifts are exact selects; only
the per-row fractional blends round, and the two frameworks may contract
`work * (1 - f) + neighbor * f` differently.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from smelter_tpu.ops import rotate as jrot
from smelter_tpu_torch.ops import rotate as trot

torch.set_num_threads(2)


@pytest.mark.parametrize("theta", [30.0, -15.0, 100.0, 0.0])
@pytest.mark.parametrize("hw", [(60, 90), (75, 48)])
def test_rotate_static_cm_matches(theta, hw):
    rng = np.random.RandomState(4)
    tile = rng.rand(4, *hw).astype(np.float32)
    out_h, out_w = jrot.rotated_bbox(theta, *hw)
    ref = np.asarray(jax.jit(
        lambda t: jrot.rotate_static_cm(t, theta, out_h, out_w))(tile))
    got = trot.rotate_static_cm(torch.from_numpy(tile), theta, out_h, out_w)
    assert tuple(got.shape) == ref.shape == (4, out_h, out_w)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("theta,h,w", [(30.0, 480, 853), (-15.0, 100, 37),
                                       (100.0, 64, 64), (225.0, 31, 77)])
def test_geometry_helpers_match(theta, h, w):
    assert trot.rotated_bbox(theta, h, w) == jrot.rotated_bbox(theta, h, w)
    assert trot._normalize(theta) == jrot._normalize(theta)
    assert trot.rotation_band_count(theta, h, w) == jrot.rotation_band_count(theta, h, w)


def test_shear_past_the_edge_is_transparent():
    img = torch.ones((4, 40, 6))
    ref = np.asarray(jrot._shear_w(jax.numpy.ones((4, 40, 6)), 0.9))
    got = trot._shear_w(img, 0.9)
    assert not got.any()
    np.testing.assert_array_equal(got.numpy(), ref)
