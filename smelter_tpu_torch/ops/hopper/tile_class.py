"""Tile classes of the SDF kernels K1 and K3, in plain PyTorch.

The mirror of `classify` in `csrc/sdf_common.cuh`: the same f32 operations
on the same inputs, vectorised over tiles. For the pixel centres of a tile
(a half-open pixel rect), a member is

  - OUTSIDE: its layer is exactly 0 at every one (OVER with it is the
    identity, so the kernels skip it);
  - INTERIOR: its alpha is exactly 1 at every one, so its layer is the flat
    value `member_flat` (the kernels blend that without the SDF);
  - EDGE: anything else.

The proof and the premises (a member that breaks one is EDGE everywhere)
are written out in `sdf_common.cuh`. The kernels decide the classes on the
device from each frame's parameters; this module serves the tests, which
hold the classes against the plain layer math (`scene_assembly.
_member_layer`), and `chip_smoke.py`, which counts with it (`reach`) the
pixels a run of layers reaches. It is not on the compose path.
"""

from __future__ import annotations

import torch

from smelter_tpu_torch.ops.hopper.scene_assembly import MASK_W, PARAMS_BASE, MemberSpec

OUTSIDE, EDGE, INTERIOR = 0, 1, 2
MAX_MAGNITUDE = 65536.0


def _within(v, lo, hi):
    return (v >= lo) & (v <= hi)  # False for NaN


def _rect_premise(w, h, radius):
    lim = torch.minimum(w * 0.5, h * 0.5)
    return (w >= 0.0) & (h >= 0.0) & _within(radius, 0.0, lim).all()


def member_premise(spec: MemberSpec, p: torch.Tensor) -> torch.Tensor:
    """The premises of the tile classes (a 0-d bool tensor): every number
    finite and within MAX_MAGNITUDE, sizes >= 0, radii in [0, min(hw, hh)]
    (the member's and its masks'), border width >= 0, colour channels in
    [0, 1]."""
    ok = _within(p[:PARAMS_BASE], -MAX_MAGNITUDE, MAX_MAGNITUDE).all()
    ok = ok & _within(torch.cat([p[9:13], p[14:18]]), 0.0, 1.0).all()
    ok = ok & (p[13] >= 0.0) & _rect_premise(p[2], p[3], p[5:9])
    for mi in range(spec.n_masks):
        m = p[PARAMS_BASE + mi * MASK_W : PARAMS_BASE + (mi + 1) * MASK_W]
        ok = ok & _within(m, -MAX_MAGNITUDE, MAX_MAGNITUDE).all()
        ok = ok & _rect_premise(m[6], m[7], m[0:4])
    return ok


def member_flat(spec: MemberSpec, p: torch.Tensor) -> torch.Tensor:
    """The (4,) layer of a member where its alpha is exactly 1: the layer
    math's own operations with alpha 1.0."""
    col = torch.stack([p[9] * p[12], p[10] * p[12], p[11] * p[12], p[12]])
    if spec.kind == "box_shadow" or not spec.has_border:
        return col
    bcol = torch.stack([p[14] * p[17], p[15] * p[17], p[16] * p[17], p[17]])
    return bcol + (col - bcol) * 1.0


def _span(a0, a1, c):
    """Nearest and farthest |offset| from `c` of the pixel centres
    a0 + 0.5 .. a1 - 0.5, rounded as the per-pixel path rounds px - c."""
    lo = (a0.to(torch.float32) + 0.5) - c
    hi = ((a1 - 1).to(torch.float32) + 0.5) - c
    zero = torch.zeros_like(lo)
    near = torch.where(lo > 0.0, lo, torch.where(hi < 0.0, -hi, zero))
    return near, torch.maximum(lo.abs(), hi.abs())


def _tile_outside(near_x, near_y, hw, hh, rotated: bool, margin):
    if rotated:
        dist = torch.sqrt(near_x * near_x + near_y * near_y)
        return dist >= torch.sqrt(hw * hw + hh * hh) + (2.0 * margin + 2.0)
    return torch.maximum(near_x - hw, near_y - hh) >= margin + 1.0


def member_tile_class(spec: MemberSpec, p: torch.Tensor, y0, x0, y1, x1) -> torch.Tensor:
    """The class of one member (its parameter row `p`) over each pixel rect
    [y0, y1) x [x0, x1) (int tensors of one shape; every rect non-empty):
    an int tensor of OUTSIDE, EDGE and INTERIOR."""
    cx, cy = p[1] + p[2] * 0.5, p[0] + p[3] * 0.5
    hw, hh = p[2] * 0.5, p[3] * 0.5
    shadow = spec.kind == "box_shadow"
    blur = torch.clamp(p[18], min=1.0)
    m_out = blur * 0.5 if shadow else 0.5
    near_x, far_x = _span(x0, x1, cx)
    near_y, far_y = _span(y0, y1, cy)
    outside = _tile_outside(near_x, near_y, hw, hh, spec.has_rotation, m_out)
    for mi in range(spec.n_masks):
        k = p[PARAMS_BASE + mi * MASK_W : PARAMS_BASE + (mi + 1) * MASK_W]
        w, h = k[6], k[7]
        mnx, _ = _span(x0, x1, k[5] + w * 0.5)
        mny, _ = _span(y0, y1, k[4] + h * 0.5)
        rotated = mi < len(spec.rotated_masks) and spec.rotated_masks[mi]
        outside = outside | _tile_outside(mnx, mny, w * 0.5, h * 0.5, rotated, 0.5)
    if spec.has_rotation or spec.n_masks:
        interior = torch.zeros_like(outside)
    else:
        r_max = torch.maximum(torch.maximum(p[5], p[6]), torch.maximum(p[7], p[8]))
        m_in = blur * 0.5 if shadow else (p[13] + 1.0 if spec.has_border else 0.5)
        inset = r_max + m_in + 1.0
        interior = (far_x <= hw - inset) & (far_y <= hh - inset)
    cls = torch.where(outside, OUTSIDE, torch.where(interior, INTERIOR, EDGE))
    return torch.where(member_premise(spec, p), cls, EDGE)


def reach_box(spec: MemberSpec, p: torch.Tensor):
    """(y0, x0, y1, x1), half-open: the pixels a member can reach, as the
    kernels clip its region (`set_region` in `sdf_common.cuh`); its layer is
    exactly 0 beyond them. None for a member that breaks a premise (the
    kernels keep its whole region)."""
    if not bool(member_premise(spec, p)):
        return None
    cx, cy = p[1] + p[2] * 0.5, p[0] + p[3] * 0.5
    hw, hh = p[2] * 0.5, p[3] * 0.5
    m_out = torch.clamp(p[18], min=1.0) * 0.5 if spec.kind == "box_shadow" else 0.5
    if spec.has_rotation:
        ex = ey = torch.sqrt(hw * hw + hh * hh) + 2.0 * m_out + 3.0
    else:
        ex, ey = hw + m_out + 2.0, hh + m_out + 2.0
    return (int(torch.floor(cy - ey - 0.5)), int(torch.floor(cx - ex - 0.5)),
            int(torch.ceil(cy + ey - 0.5)) + 1, int(torch.ceil(cx + ex - 0.5)) + 1)


def tile_classes(spec: MemberSpec, p: torch.Tensor, h: int, w: int, tile: int = 32
                 ) -> torch.Tensor:
    """The member's class on every tile x tile tile of an h x w canvas, over
    the part of the tile inside its region (OUTSIDE where none is), as the
    kernels classify it: a (ceil(h / tile), ceil(w / tile)) int tensor."""
    dev = p.device
    ty = torch.arange(0, h, tile, device=dev)[:, None]
    tx = torch.arange(0, w, tile, device=dev)[None, :]
    ry0, rx0, ry1, rx1 = spec.region
    y0, y1 = ty.clamp(min=ry0), (ty + tile).clamp(max=min(h, ry1))
    x0, x1 = tx.clamp(min=rx0), (tx + tile).clamp(max=min(w, rx1))
    y0, y1, x0, x1 = torch.broadcast_tensors(y0, y1, x0, x1)
    empty = (y0 >= y1) | (x0 >= x1)
    cls = member_tile_class(spec, p, y0, x0, torch.maximum(y1, y0 + 1),
                            torch.maximum(x1, x0 + 1))
    return torch.where(empty, OUTSIDE, cls)


def reach(specs, params: torch.Tensor, h: int, w: int) -> tuple:
    """(pixels, member-pixels): the pixels of an h x w canvas at which some
    member of the run is not classed OUTSIDE (classes of 1 x 1 tiles), which
    the run has to read and write at least, and the sum over the members of
    the pixels each one reaches, which it has to blend at least."""
    reached = torch.zeros((h, w), dtype=torch.bool, device=params.device)
    pairs = 0
    for spec, p in zip(specs, params):
        mine = tile_classes(spec, p, h, w, tile=1) != OUTSIDE
        reached |= mine
        pairs += int(mine.sum())
    return int(reached.sum()), pairs
