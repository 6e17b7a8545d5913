"""The port's flagship slice (`smelter_tpu_torch/parallel/flagship.py`) against
the JAX package on the CPU, at small size: the Tiles grid at
16 x 192x108 -> 384x216 and general_4k at 4 x 256x144 -> 768x432, u8 YUV420
planes from seeded inputs. Also the planner split (`split_layout`) field for
field, on the full-size general_4k and Tiles layouts.

The reference's objects (resolutions, layouts) reach the port through
`interop.from_reference`; the port runs with `device="cpu"`.

Tolerance: <= 1 u8 LSB per plane. A pixel may be 2 LSB off only through a
bf16 tie between the resize axes (the intermediate rounds to bf16,
resample.py:160 in the reference): f32 sums of another order can land on
the other side of a bf16 rounding boundary, and the second axis scales that
one-ulp step. Such pixels must stay under 0.01% of each plane.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from smelter_tpu.core.types import Resolution
from smelter_tpu.parallel import flagship as jflag
from smelter_tpu.render import program as jprog
from smelter_tpu_torch import interop
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.parallel import flagship as tflag
from smelter_tpu_torch.render import program as tprog

torch.set_num_threads(2)

SCENES = {
    "grid": (jflag.make_flagship_compose, tflag.make_flagship_compose,
             16, Resolution(192, 108), Resolution(384, 216)),
    # 7 tiles leave gaps: background fill + region writes, not concatenation
    "grid_7": (jflag.make_flagship_compose, tflag.make_flagship_compose,
               7, Resolution(192, 108), Resolution(384, 216)),
    "general_4k": (jflag.make_flagship_general_compose,
                   tflag.make_flagship_general_compose,
                   4, Resolution(256, 144), Resolution(768, 432)),
}


def _frames(n, res):
    rng = np.random.RandomState(0)
    y = rng.randint(16, 235, (n, res.height, res.width), np.uint8)
    u = rng.randint(16, 240, (n, res.height // 2, res.width // 2), np.uint8)
    v = rng.randint(16, 240, (n, res.height // 2, res.width // 2), np.uint8)
    return y, u, v


@pytest.fixture(scope="module")
def jax_outputs():
    out = {}
    for name, (jbuild, _, n, in_res, out_res) in SCENES.items():
        fn, _ = jbuild(n_inputs=n, in_res=in_res, out_res=out_res)
        out[name] = [np.asarray(p) for p in jax.jit(fn)(*_frames(n, in_res))]
    return out


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_scene_matches_jax(jax_outputs, scene):
    _, tbuild, n, in_res, out_res = SCENES[scene]
    fn, example = tbuild(n_inputs=n, in_res=from_reference(in_res),
                         out_res=from_reference(out_res), device="cpu")
    assert [tuple(a.shape) for a in example] == [
        (n, in_res.height, in_res.width),
        (n, in_res.height // 2, in_res.width // 2),
        (n, in_res.height // 2, in_res.width // 2)]
    got = interop.planes_to_host(fn(*interop.planes_to_device(_frames(n, in_res), "cpu")))
    for name, ref, mine in zip("yuv", jax_outputs[scene], got):
        assert mine.dtype == np.uint8 and mine.shape == ref.shape, name
        d = np.abs(ref.astype(np.int32) - mine.astype(np.int32))
        assert d.max() <= 2, name
        assert (d > 1).sum() * 10000 < d.size, name


def _assert_split_equal(flat, port_flat):
    assert port_flat == from_reference(flat)
    for fast in (False, True):
        for layout, port_layout in zip(flat, port_flat):
            js, jp = jprog.split_layout(layout, fast=fast)
            ts, tp = tprog.split_layout(port_layout, fast=fast, device="cpu")
            assert dataclasses.asdict(ts) == dataclasses.asdict(js)
            assert ts == interop.layout_static(js)
            for f in dataclasses.fields(jp):
                np.testing.assert_array_equal(
                    getattr(tp, f.name).numpy(),
                    np.asarray(getattr(jp, f.name), np.float32), err_msg=f.name)


class _Captured(Exception):
    pass


def _reference_general_layouts(monkeypatch, n, in_res, out_res):
    """The flattened layouts the reference's general_4k builder makes (it is
    stopped before it compiles anything)."""
    captured = []

    def capture(*args):
        captured.append(orig(*args))
        raise _Captured

    orig = jflag._scene_layouts
    monkeypatch.setattr(jflag, "_scene_layouts", capture)
    with pytest.raises(_Captured):
        jflag.make_flagship_general_compose(n, in_res, out_res)
    return captured[0]


def test_split_layout_matches_general_4k_layouts(monkeypatch):
    in_res, out_res = Resolution(1920, 1080), Resolution(3840, 2160)
    flat = _reference_general_layouts(monkeypatch, 16, in_res, out_res)
    port_flat = tflag._general_layouts(16, *from_reference((in_res, out_res)))
    # 1 background + 6 box shadows + 16 colour backdrops + 16 textures
    assert len(port_flat) == 39
    _assert_split_equal(flat, port_flat)


def test_split_layout_matches_tiles_layouts():
    in_res, out_res = Resolution(1920, 1080), Resolution(3840, 2160)
    flat = jflag._tiles_layouts(16, in_res, out_res)
    port_flat = tflag._tiles_layouts(16, *from_reference((in_res, out_res)))
    assert tflag._analyze_opaque_grid(port_flat, from_reference(out_res)) == \
        jflag._analyze_opaque_grid(flat, out_res)
    _assert_split_equal(flat, port_flat)


def test_grid_plan_matches():
    for n in (16, 4, 7):
        out_res = Resolution(3840, 2160)
        flat = jflag._tiles_layouts(n, Resolution(1920, 1080), out_res)
        grid = jflag._analyze_opaque_grid(flat, out_res)
        assert tflag._analyze_opaque_grid(*from_reference((flat, out_res))) == grid
        assert tflag.plan_grid_partition(grid[1], 2160, 3840) == \
            jflag.plan_grid_partition(grid[1], 2160, 3840)


def test_mip_levels_match():
    for w, h in ((1920, 1080), (64, 64), (63, 200), (3840, 2160), (1, 1)):
        res = Resolution(w, h)
        assert tprog._mip_levels(from_reference(res)) == jprog._mip_levels(res)
