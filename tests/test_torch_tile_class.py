"""The premises of the SDF kernels' tile classes (`smelter_tpu_torch/ops/
hopper/tile_class.py`, the plain mirror of `classify` in `csrc/
sdf_common.cuh`), held against the plain layer math on the CPU.

Seeded numpy sweeps of several hundred members (colour, bordered, shadow,
rotated, masked, and degenerate: radius past half the size, blur 0, width
0, off canvas, edges on tile boundaries +-1 px) over the 32 x 32 tiles of a
small canvas: at every pixel of a tile classed OUTSIDE the plain
`_member_layer` is exactly 0, and at every pixel of a tile classed INTERIOR
it is exactly `member_flat` (torch.equal; no tolerance). A member whose
parameters break a premise is EDGE on every tile. Beyond the box the
kernels clip a member's region to (`reach_box`), its layer is exactly 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from smelter_tpu_torch.ops.compose import _pixel_centers
from smelter_tpu_torch.ops.hopper import tile_class as tc
from smelter_tpu_torch.ops.hopper.scene_assembly import (
    MASK_W,
    PARAMS_BASE,
    MemberSpec,
    _member_layer,
)

torch.set_num_threads(2)

H, W, TILE = 128, 224, 32
N_MEMBERS = 300


def _coord(rng, extent):
    """A coordinate on a tile boundary +-1 px, or anywhere on (or past) the
    canvas."""
    if rng.rand() < 0.4:
        return float(TILE * rng.randint(-1, extent // TILE + 2) + rng.randint(-1, 2))
    return float(rng.uniform(-80, extent + 40))


def _member(rng, kind, degenerate=False):
    """(spec, (P,) f32 params) of one random member of `kind`."""
    n_masks = int(rng.randint(0, 3)) if kind == "masked" else 0
    content = "box_shadow" if kind == "shadow" else "color"
    has_border = kind == "bordered" or (kind == "masked" and rng.rand() < 0.5)
    has_rotation = kind == "rotated"
    w, h = rng.uniform(0, 320), rng.uniform(0, 200)
    if rng.rand() < 0.1:
        w = 0.0
    top, left = _coord(rng, H) - h * 0.3, _coord(rng, W) - w * 0.3
    if rng.rand() < 0.3:  # right or bottom edge on a tile boundary
        w = max(_coord(rng, W) - left, 0.0)
    lim = min(w, h) * 0.5
    radius = rng.uniform(0, lim, 4) if rng.rand() < 0.7 else np.zeros(4)
    if degenerate:
        radius = np.full(4, lim + 1.0 + rng.uniform(0, 20))  # past half the size
    angle = float(rng.choice([45.0, 90.0, -30.0, rng.uniform(-180, 180)]))
    blur = float(rng.choice([0.0, 1.0, rng.uniform(0, 30)]))
    row = [top, left, w, h, angle, *radius, *rng.uniform(0, 1, 4),
           float(rng.choice([0.0, rng.uniform(0, 10)])), *rng.uniform(0, 1, 4), blur]
    masks, rotated = [], []
    for _ in range(n_masks):
        mw, mh = rng.uniform(10, 250), rng.uniform(10, 150)
        masks += [*rng.uniform(0, min(mw, mh) * 0.5, 4), _coord(rng, H), _coord(rng, W),
                  mw, mh, float(rng.uniform(-1, 1))]
        rotated.append(bool(rng.rand() < 0.5))
    spec = MemberSpec(content, has_border, has_rotation, n_masks, tuple(rotated),
                      (0, 0, H, W))
    p = np.asarray(row + masks + [0.0] * (MASK_W * (2 - n_masks)), np.float32)
    return spec, torch.from_numpy(p)


def _members(seed):
    rng = np.random.RandomState(seed)
    kinds = ["color", "bordered", "shadow", "rotated", "masked"]
    out = [_member(rng, kinds[i % len(kinds)]) for i in range(N_MEMBERS)]
    out += [_member(rng, kinds[i % len(kinds)], degenerate=True) for i in range(20)]
    return out


def _tiles():
    for ty in range(0, H, TILE):
        for tx in range(0, W, TILE):
            yield ty // TILE, tx // TILE, slice(ty, ty + TILE), slice(tx, tx + TILE)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_classes_hold_against_the_plain_layer(seed):
    px, py = _pixel_centers(0, 0, H, W, "cpu")
    counts = {tc.OUTSIDE: 0, tc.EDGE: 0, tc.INTERIOR: 0}
    for spec, p in _members(seed):
        layer = _member_layer(spec, p, px, py)
        classes = tc.tile_classes(spec, p, H, W, TILE)
        flat = tc.member_flat(spec, p)[:, None, None]
        for iy, ix, ys, xs in _tiles():
            c = int(classes[iy, ix])
            counts[c] += 1
            got = layer[:, ys, xs]
            if c == tc.OUTSIDE:
                assert torch.equal(got, torch.zeros_like(got)), (spec, p, iy, ix)
            elif c == tc.INTERIOR:
                assert torch.equal(got, flat.expand_as(got)), (spec, p, iy, ix)
    # the sweep reaches every class, so the checks above are not vacuous
    assert min(counts.values()) > 100, counts


@pytest.mark.parametrize("seed", [3])
def test_layers_are_zero_beyond_the_reach_box(seed):
    px, py = _pixel_centers(0, 0, H, W, "cpu")
    boxed = 0
    for spec, p in _members(seed):
        box = tc.reach_box(spec, p)
        if box is None:
            continue
        boxed += 1
        y0, x0, y1, x1 = box
        inside = torch.zeros((H, W), dtype=torch.bool)
        inside[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
        layer = _member_layer(spec, p, px, py)
        assert torch.equal(layer[:, ~inside], torch.zeros_like(layer[:, ~inside])), (spec, p)
    assert boxed > 200


def test_a_broken_premise_is_edge_everywhere():
    rng = np.random.RandomState(5)
    spec, p = _member(rng, "color")
    p[0], p[1], p[2], p[3] = 40.0, 40.0, 100.0, 60.0
    p[5:9] = 0.0
    assert (tc.tile_classes(spec, p, H, W, TILE) == tc.INTERIOR).any()
    breaks = {"radius past half the size": (5, 31.0), "negative radius": (6, -1.0),
              "negative width": (2, -100.0), "negative border": (13, -1.0),
              "colour past 1": (10, 1.5), "NaN": (0, float("nan")),
              "infinite": (18, float("inf")), "too large": (1, 1e6)}
    for what, (i, v) in breaks.items():
        q = p.clone()
        q[i] = v
        assert not bool(tc.member_premise(spec, q)), what
        assert bool((tc.tile_classes(spec, q, H, W, TILE) == tc.EDGE).all()), what
    bad_mask = MemberSpec("color", False, False, 1, (False,), (0, 0, H, W))
    q = p.clone()
    q[PARAMS_BASE: PARAMS_BASE + MASK_W] = torch.tensor([-2.0, 0, 0, 0, 0, 0, 50, 50, 0])
    assert not bool(tc.member_premise(bad_mask, q))


def test_region_clips_the_classes():
    spec = MemberSpec("color", False, False, 0, (), (40, 70, 90, 150))
    p = torch.zeros(PARAMS_BASE)
    p[2], p[3], p[12] = 400.0, 300.0, 1.0  # covers the canvas
    classes = tc.tile_classes(spec, p, H, W, TILE)
    reached = torch.zeros_like(classes, dtype=torch.bool)
    reached[1:3, 2:5] = True  # tiles that meet rows 40..89, columns 70..149
    assert torch.equal(classes != tc.OUTSIDE, reached)
    assert tc.reach([spec, spec], torch.stack([p, p]), H, W) == (50 * 80, 2 * 50 * 80)
