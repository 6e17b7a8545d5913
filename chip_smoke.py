#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`smelter_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc
(found on PATH or under /usr/local/cuda/bin). It:
  1. exits 1 at once when torch sees no CUDA device (there is no CPU
     fallback: the point is the card);
  2. prints the card's name and power limit, builds every kernel of
     `smelter_tpu_torch/csrc/` (into `smelter_tpu_torch/_build/`) and prints
     the build time and the compiler's register report;
  3. holds kernel K2 (YUV420 output) against its plain PyTorch version on
     the card: <= 1 u8 LSB on every plane;
  4. holds kernel K1 (scene assembly) against its plain version on the card,
     on the general_4k and renderer member tables at 4K, a mixed-member case
     with partial tiles, rotation, border, shadow and masks, and the
     tile-class edge cases (edges on tile boundaries +-1 px, a radius past
     half the size, blur 0, rotations of 45 and 90 degrees, width 0, an
     opaque interior member over others) at 256 x 512 and 257 x 511; and
     kernel K3 (SDF layers) on the renderer scene's four overlay layers over
     the general_4k canvas at 4K, a 16-layer table with rotation, borders and
     shadows at 4K, a 4-layer table at 257 x 511, the same edge cases, and
     layers all off the canvas (which must stay bit-identical): max abs err
     0 on the f32 canvas (both kernels repeat their plain version's
     operations);
  5. drives the flagship builders, 16 x 1080p YUV420 -> one 4K YUV420 frame
     (the Tiles grid, then general_4k), host frames going through pinned
     memory to the card and the planes coming back; checks shapes and
     dtypes, that general_4k launched K1 and K2, and that the card's frames
     match the port run on the CPU;
  6. drives the renderer (`smelter_tpu_torch.render.renderer.Renderer`), the
     entry point a pipeline calls, on 16 host YUV420 inputs at 1080p into a
     4K YUV420 output: a Tiles grid under a highlight frame and a lower-third
     banner that move in a one-second transition, 41 frames at 30 fps;
     checks the planes, that K1 and K2 ran, that K3 ran on every animating
     frame and on no settled one, and that the same sequence at 4 x 256x144
     -> 768x432 matches the port run on the CPU;
  7. drives the renderer through animated textures (`animated_scene`), 16
     host inputs at 1080p (one NV12, one RGBA, the rest YUV420) into a 4K
     YUV420 output, 41 frames at 30 fps of a one-second transition in
     which a Tiles grid gains its 16th input and a margin (every tile
     resizes and moves), a picture-in-picture slides, a card spins, a card
     grows while it spins and a tilted card slides; checks the planes of
     every frame, that the scaling, moving, traced-rotation, roto-zoom and
     sampled-pass routes each drew a texture on exactly the animating
     frames 2-30, that K1 and K2 ran on every frame, that no animating
     frame made a synchronising call (`set_sync_debug_mode`; the count of
     every frame is printed), and that the same sequence at 4 x 256x144 ->
     768x432 matches the port run on the CPU;
  8. times the kernels (CUDA events around 50 launches queued back to
     back, one synchronised call, and the device time torch.profiler
     reads for the kernel alone) against their plain versions and
     their bounds (bytes and operations at the H100 SXM's peaks), the whole
     frames, the host time of the renderer's per-frame planning, and the
     animated-texture frames (animating and stable, plan(), and a
     torch.profiler breakdown of one animating frame);
and prints a JSON line of the animated-texture numbers, a JSON line of the
kernels, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failed phase ends the run with a
non-zero exit and no "ok" line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ITERS = 20
WARMUP = 3
N_INPUTS = 16
IN_W, IN_H = 1920, 1080
OUT_W, OUT_H = 3840, 2160
FPS = 30
N_RENDER_FRAMES = 40  # pts k / FPS for k = 1..40 after the scene update
B2B_LAUNCHES = 50  # kernel calls queued back to back per timing
# H100 SXM peaks (NVIDIA's data sheet, at a 700 W power limit): HBM3 rate
# and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BLEND_OPS = 9  # f32 operations of one premultiplied OVER of one pixel


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median wall time on the card of one call, in ms: CUDA events around
    each call, synchronised after each (host gaps inside a call count). The
    "call" time of a kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, n: int = B2B_LAUNCHES, reps: int = 5, warmup: int = WARMUP) -> float:
    """A kernel's time on the card, in ms: CUDA events around `n` calls
    queued back to back, divided by `n` (median of `reps` runs). The host
    enqueues the next call while the card runs the last, so the wrapper's
    host work stays out of the time as long as it is shorter than the
    kernel."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def device_ms(fn, kernel: str, n: int = B2B_LAUNCHES):
    """Mean device time in ms of the CUDA kernel whose name holds `kernel`,
    over `n` calls of `fn`, from torch.profiler's CUDA trace (no host work
    counts); None when the trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if kernel in e.key and e.count]
    if not rows:
        return None
    return sum(e.device_time_total for e in rows) / sum(e.count for e in rows) / 1e3


def bound_ms(n_bytes: float, n_ops: float = 0.0):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move `n_bytes` through device memory and do `n_ops` f32 operations
    outside the tensor cores, at the H100 SXM's published peaks."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lsb_stats(ref_planes, got_planes):
    """(max |diff|, pixels differing, pixels off by more than 1, pixels) over
    the planes of two frames."""
    import numpy as np

    mx, n_diff, n_gt1, n = 0, 0, 0, 0
    for a, b in zip(ref_planes, got_planes):
        check(a.shape == b.shape, f"plane shapes differ: {a.shape} vs {b.shape}")
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        mx = max(mx, int(d.max()))
        n_diff += int((d > 0).sum())
        n_gt1 += int((d > 1).sum())
        n += d.size
    return mx, n_diff, n_gt1, n


def check_planes(label, planes, out_w, out_h):
    """u8 Y, U, V planes of an out_w x out_h frame, none of them flat."""
    shapes = [tuple(p.shape) for p in planes]
    print(f"{label} output planes: {shapes} {planes[0].dtype}")
    check(shapes == [(out_h, out_w), (out_h // 2, out_w // 2), (out_h // 2, out_w // 2)]
          and all(str(p.dtype) == "uint8" for p in planes),
          f"{label}: wrong output planes {shapes}")
    check(all(int(p.max()) > int(p.min()) for p in planes), f"{label}: a flat output plane")


def quantized(canvas):
    import torch

    return torch.clamp(torch.round(canvas * 255.0), 0.0, 255.0).to(torch.int32)


def k2_checks(yuv_out, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0
    for shape in ((4, 2160, 3840), (4, 1080, 1920), (4, 200, 520)):
        canvas = torch.rand(shape, generator=gen, device=dev) * 1.3 - 0.1
        for full_range in (False, True):
            got = yuv_out.rgba_cm_to_yuv420(canvas, full_range)
            torch.cuda.synchronize()
            ref = yuv_out.rgba_cm_to_yuv420_plain(canvas, full_range)
            for name, a, b in zip("yuv", ref, got):
                check(a.shape == b.shape and b.dtype == torch.uint8,
                      f"K2 {shape} plane {name}: {tuple(b.shape)} {b.dtype}")
                d = (a.to(torch.int32) - b.to(torch.int32)).abs()
                mx, nd = int(d.max()), int((d > 0).sum())
                print(f"K2 vs plain {shape} full_range={full_range} plane {name}: "
                      f"max diff {mx} LSB, {nd} of {d.numel()} pixels differ")
                check(mx <= 1, f"K2 plane {name} off by {mx} LSB at {shape}")
                worst = max(worst, mx)
    return worst


def _params(dev, top=0.0, left=0.0, width=0.0, height=0.0, rotation=0.0,
            radius=(0, 0, 0, 0), border_width=0.0, border_color=(0, 0, 0, 0),
            color=(0, 0, 0, 0), blur=0.0, masks=None):
    from smelter_tpu_torch.interop import layout_params

    return layout_params(dict(
        top=top, left=left, width=width, height=height,
        rotation_degrees=rotation, border_radius=radius,
        border_width=border_width, border_color=border_color, color=color,
        crop=(0, 0, 0, 0), blur_radius=blur,
        masks=[[0.0] * 9] if masks is None else masks,
    ), dev)


def k1_tables(dev):
    """(name, (w, h), specs, params) K1 cases: the general_4k member table at
    4K as compose routes it, and a 200 x 520 mixed-member case."""
    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.ops.compose import LayoutStatic, _assembly_members, canvas_clipper
    from smelter_tpu_torch.ops.hopper import scene_assembly as sa
    from smelter_tpu_torch.parallel.flagship import _general_layouts
    from smelter_tpu_torch.render.program import split_layout

    cases = []
    flat = _general_layouts(N_INPUTS, Resolution(IN_W, IN_H), Resolution(OUT_W, OUT_H))
    items = [split_layout(l, fast=True, device=dev) for l in flat]
    specs, plist, _ = _assembly_members(items, 0, len(items), canvas_clipper(OUT_H, OUT_W))
    cases.append(("general_4k", (OUT_W, OUT_H), specs,
                  sa.pack_member_params(plist, max(s.n_masks for s in specs))))

    h, w = 200, 520  # not a multiple of the 32 x 32 tile: partial tiles
    statics = [
        LayoutStatic(content="color", static_rect=(0, 0, h, w), no_radius=True),
        LayoutStatic(content="box_shadow", static_rect=(30, 40, 100, 150),
                     static_blur=18.0),
        LayoutStatic(content="color", static_rect=(25, 35, 110, 160),
                     has_border=True, has_rotation=True, static_rotation=20.0),
        LayoutStatic(content="color", static_rect=(20, 300, 100, 200),
                     n_masks=2, rotated_masks=(False, True)),
        LayoutStatic(content="box_shadow", static_rect=(120, 260, 70, 240),
                     static_blur=10.0, n_masks=1, rotated_masks=(True,)),
    ]
    params = [
        _params(dev, width=w, height=h, color=(0.1, 0.1, 0.15, 1.0)),
        _params(dev, top=30, left=40, width=150, height=100, blur=18.0,
                radius=(12, 12, 12, 12), color=(0, 0, 0, 0.6)),
        _params(dev, top=25, left=35, width=160, height=110, rotation=20.0,
                radius=(8, 8, 8, 8), border_width=5.0,
                border_color=(1, 1, 1, 0.9), color=(0.8, 0.2, 0.2, 0.9)),
        _params(dev, top=20, left=300, width=200, height=100,
                radius=(10, 10, 10, 10), color=(0.9, 0.4, 0.1, 0.95),
                masks=[[8, 8, 8, 8, 25, 305, 180, 80, 0.0],
                       [12, 12, 12, 12, 30, 320, 150, 70, 0.4]]),
        _params(dev, top=120, left=260, width=240, height=70, blur=10.0,
                radius=(6, 6, 6, 6), color=(0.2, 0.0, 0.4, 0.7),
                masks=[[14, 14, 14, 14, 110, 270, 200, 80, 0.3]]),
    ]
    specs, plist, group = _assembly_members(list(zip(statics, params)), 0,
                                            len(statics), canvas_clipper(h, w))
    check(len(specs) == len(statics) and not group,
          "every mixed-case member must route to K1")
    cases.append(("mixed_200x520", (w, h), specs,
                  sa.pack_member_params(plist, max(s.n_masks for s in specs))))
    return cases


def edge_rows(h, w):
    """(rows, kinds) of layers at the edges of the tile classes: rect edges on
    32-px tile boundaries and 1 px to either side, a radius past half the
    height (a broken premise: edge everywhere), blur 0, rotations of 45 and
    90 degrees, and a width of 0; sized for a canvas of about 256 x 512."""
    t = 32
    rows, kinds = [], []

    def add(kind, top, left, width, height, rot=0.0, radius=0.0,
            color=(0.8, 0.3, 0.2, 0.9), border=0.0, blur=0.0):
        rows.append([top, left, width, height, rot, *[radius] * 4, *color, border,
                     1.0, 1.0, 1.0, 0.95, blur])
        kinds.append(kind)

    for d in (-1, 0, 1):
        add(("color", False, False), t + d, 2 * t + d, 3 * t - d, 2 * t + d, radius=4.0)
        add(("color", True, False), 2 * t - d, t + d, 2 * t, 3 * t, radius=6.0, border=3.0)
        add(("box_shadow", False, False), t + d, 9 * t + d, 3 * t, 2 * t + d,
            radius=8.0, color=(0.0, 0.0, 0.0, 0.5))
    add(("color", False, False), 10.0, 10.0, 100.0, 60.0, radius=45.0)
    add(("box_shadow", False, False), 40.0, 200.0, 120.0, 80.0, radius=10.0,
        color=(0.1, 0.0, 0.2, 0.7))
    add(("color", False, True), 50.0, 100.0, 160.0, 90.0, rot=45.0, radius=12.0)
    add(("color", True, True), 120.0, 300.0, 120.0, 60.0, rot=90.0, radius=6.0,
        border=4.0)
    add(("box_shadow", False, True), 60.0, 380.0, 90.0, 90.0, rot=45.0, blur=12.0,
        color=(0.0, 0.0, 0.0, 0.6))
    add(("color", False, False), 70.0, 20.0, 0.0, 50.0)
    return rows, tuple(kinds)


def k1_edge_cases(dev):
    """K1 cases of the tile classes: a background, then the edge rows, at
    256 x 512 (float4 stores) and 257 x 511 (the scalar path); and an
    opaque interior member (alpha 1, covering whole tiles) over translucent
    ones, with members above it."""
    import torch

    from smelter_tpu_torch.ops.hopper.scene_assembly import MemberSpec

    cases = []
    for h, w in ((256, 512), (257, 511)):
        rows, kinds = edge_rows(h, w)
        rows = [[0.0, 0.0, w, h, 0.0, 0, 0, 0, 0, 0.1, 0.1, 0.15, 1.0, 0, 0, 0, 0, 0, 0]] + rows
        kinds = (("color", False, False),) + kinds
        specs = [MemberSpec(c, b, r, 0, (), (0, 0, h, w)) for c, b, r in kinds]
        cases.append((f"edge cases {w}x{h}", (w, h), specs,
                      torch.tensor(rows, dtype=torch.float32, device=dev)))
    h, w = 256, 512
    # the edge rows but the one that breaks a premise (a member that does
    # keeps every member above it from starting a tile over)
    rows, kinds = zip(*[(r, k) for r, k in zip(*edge_rows(h, w))
                        if r[5] <= min(r[2], r[3]) * 0.5])
    rows, kinds = list(rows), tuple(kinds)
    occluder = [[20.0, 40.0, 400.0, 200.0, 0.0, *[10.0] * 4, 0.3, 0.6, 0.9, 1.0,
                 0.0, 0, 0, 0, 0, 0.0]]
    on_top = [[100.0, 150.0, 200.0, 60.0, 0.0, *[8.0] * 4, 0.9, 0.9, 0.1, 0.5,
               0.0, 0, 0, 0, 0, 0.0]]
    rows = rows + occluder + on_top
    kinds = kinds + (("color", False, False),) * 2
    specs = [MemberSpec(c, b, r, 0, (), (0, 0, h, w)) for c, b, r in kinds]
    cases.append(("opaque interior member over others 512x256", (w, h), specs,
                  torch.tensor(rows, dtype=torch.float32, device=dev)))
    return cases


def k1_checks(sa, cases):
    import torch

    worst = 0.0
    for name, res, specs, params in cases:
        got = sa.assemble_scene_planar(res, specs, params)
        torch.cuda.synchronize()
        ref = sa.assemble_scene_planar_plain(res, specs, params)
        check(bool(torch.isfinite(got).all()), f"K1 {name}: non-finite canvas")
        err = float((got - ref).abs().max())
        lsb = int((quantized(got) - quantized(ref)).abs().max())
        print(f"K1 vs plain {name} ({len(specs)} members, {res[0]}x{res[1]}): "
              f"max abs err {err:.3g}, max u8 diff {lsb} LSB")
        check(err == 0.0, f"K1 {name}: f32 canvas off by {err}")
        worst = max(worst, err)
    return worst


def host_frames(n, in_w, in_h, seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    y = rng.randint(16, 235, (n, in_h, in_w), dtype=np.uint8)
    u = rng.randint(16, 240, (n, in_h // 2, in_w // 2), dtype=np.uint8)
    v = rng.randint(16, 240, (n, in_h // 2, in_w // 2), dtype=np.uint8)
    return y, u, v


def parity_vs_cpu(builder, n, in_w, in_h, out_w, out_h, dev, label):
    """The card's frame against the port's plain run on the CPU. Tolerance of
    the slice: <= 1 LSB, and < 0.01% of pixels at 2 LSB (bf16 ties in the
    rounding between the resize axes, where GEMM sums of another order land
    on the other side of a tie)."""
    import torch

    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch import interop

    frames = host_frames(n, in_w, in_h, seed=1)
    in_res, out_res = Resolution(in_w, in_h), Resolution(out_w, out_h)
    fn_cpu, _ = builder(n, in_res, out_res, device="cpu")
    ref = interop.planes_to_host(fn_cpu(*interop.planes_to_device(frames, "cpu")))
    fn_gpu, _ = builder(n, in_res, out_res, device=dev)
    got = interop.planes_to_host(fn_gpu(*interop.planes_to_device(frames, dev)))
    mx, n_diff, n_gt1, total = lsb_stats(ref, got)
    print(f"parity card vs CPU {label} {n}x{in_w}x{in_h} -> {out_w}x{out_h}: max "
          f"{mx} LSB, {n_diff} of {total} pixels differ, {n_gt1} by 2+")
    check(mx <= 2 and n_gt1 * 10000 < total, f"{label}: card vs CPU off ({mx} LSB)")


def layer_table(dev, n, h, w, seed):
    """(n, 19) K3 parameter rows and kinds: colour, bordered-colour and
    box-shadow layers, every third one rotated, scattered over (and past the
    edges of) an h x w canvas."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    rows, kinds = [], []
    for i in range(n):
        u = torch.rand(19, generator=gen).tolist()
        content = ("color", "color", "box_shadow")[i % 3]
        kinds.append((content, content == "color" and i % 2 == 1, i % 3 == 1))
        lw, lh = 30 + u[2] * w * 0.6, 20 + u[3] * h * 0.6
        r = min(lw, lh) * 0.4
        rows.append([u[0] * h - 10, u[1] * w - 10, lw, lh, u[4] * 360 - 180,
                     *(x * r for x in u[5:9]), *u[9:12], 0.3 + 0.7 * u[12],
                     1 + u[13] * 8, *u[14:18], u[18] * 30])
    return torch.tensor(rows, dtype=torch.float32, device=dev), tuple(kinds)


def renderer_scene(out_w, out_h, n_inputs, stage):
    """The renderer's scene: an opaque root View holding a Tiles grid of the
    inputs, a highlight frame around one tile and a lower-third banner. The
    two overlays carry ids and a one-second transition; `stage` 0 puts the
    highlight on the first tile and the banner on the left, stage 1 moves
    the highlight to the last tile and slides the banner right. Sizes are
    those of a 3840-wide output, scaled to `out_w`; both overlays (and their
    shadows) stay inside the canvas, so they carry no masks."""
    from smelter_tpu_torch.core.types import RGBAColor
    from smelter_tpu_torch.scene import components as comp
    from smelter_tpu_torch.scene.layout_types import BorderRadius, BoxShadow

    s = out_w / 3840.0
    cols = int(round(n_inputs ** 0.5))
    rows = -(-n_inputs // cols)
    tw, th = out_w / cols, out_h / rows
    r, c = (0, 0) if stage == 0 else (rows - 1, cols - 1)
    pad = 24 * s
    highlight = comp.View(
        id="highlight",
        position=comp.AbsolutePosition(width=tw - 2 * pad, height=th - 2 * pad,
                                       top=r * th + pad, left=c * tw + pad),
        background_color=RGBAColor(255, 255, 255, 40),
        border_radius=BorderRadius(16 * s, 16 * s, 16 * s, 16 * s),
        border_width=8 * s, border_color=RGBAColor(255, 200, 0, 255),
        box_shadow=[BoxShadow(blur_radius=24 * s, color=RGBAColor(0, 0, 0, 180))],
        transition=comp.Transition(duration=1.0))
    bw, bh = 2400 * s, 240 * s
    banner = comp.View(
        id="banner",
        position=comp.AbsolutePosition(width=bw, height=bh, top=out_h - bh - 120 * s,
                                       left=(160 if stage == 0 else 1200) * s),
        background_color=RGBAColor(200, 30, 30, 230),
        border_radius=BorderRadius(24 * s, 24 * s, 24 * s, 24 * s),
        border_width=4 * s, border_color=RGBAColor(255, 255, 255, 255),
        box_shadow=[BoxShadow(offset_x=8 * s, offset_y=8 * s, blur_radius=30 * s,
                              color=RGBAColor(0, 0, 0, 160))],
        transition=comp.Transition(duration=1.0))
    tiles = comp.Tiles(
        children=[comp.Rescaler(child=comp.InputStream(input_id=f"input_{i}"))
                  for i in range(n_inputs)],
        background_color=RGBAColor(16, 16, 16), margin=8.0 * s)
    return comp.View(background_color=RGBAColor(0, 0, 0),
                     children=[tiles, highlight, banner])


def renderer_inputs(n, in_w, in_h, seed):
    """n host planar YUV420 input frames (u8 numpy planes)."""
    from smelter_tpu_torch.core.types import Frame, PixelFormat, Resolution

    y, u, v = host_frames(n, in_w, in_h, seed)
    return {f"input_{i}": Frame(data=(y[i], u[i], v[i]),
                                format=PixelFormat.PLANAR_YUV420,
                                resolution=Resolution(in_w, in_h), pts=0.0)
            for i in range(n)}


def animated_scene(out_w, out_h, n_inputs, stage):
    """The animated-texture scene: an opaque root View over
      (a) a Tiles grid of id-tracked inputs that goes from n_inputs - 1 to
          n_inputs tiles and gains a 24-px margin, so every tile resizes and
          moves (the scaling route);
      (b) a 1280x720 picture-in-picture of input 3 that slides from the
          bottom right to the bottom left (moving);
      (c) a 960x540 card of input 1 that spins from 0 to 60 degrees with
          its rect held (traced rotation);
      (d) a card of input 2 that grows from 480x270 to 960x540 about its
          center while it spins from 0 to 45 degrees (roto-zoom);
      (e) a 640x360 card of input 4 (input 0 when there are 4 inputs) held
          at 15 degrees that slides (the sampled mip pass);
    each with a one-second transition. Sizes are those of a 3840-wide
    output, scaled to `out_w`; every card stays inside the canvas at every
    angle, so none gains a mask."""
    from smelter_tpu_torch.core.types import RGBAColor
    from smelter_tpu_torch.scene import components as comp

    s = out_w / 3840.0
    one_second = comp.Transition(duration=1.0)
    n_tiles = n_inputs - 1 if stage == 0 else n_inputs
    tiles = comp.Tiles(
        id="grid", background_color=RGBAColor(16, 16, 16),
        margin=0.0 if stage == 0 else 24.0 * s, transition=one_second,
        children=[comp.InputStream(id=f"tile_{i}", input_id=f"input_{i}")
                  for i in range(n_tiles)])

    def card(id_, input_index, w, h, top, left, theta=0.0):
        return comp.Rescaler(
            id=id_, child=comp.InputStream(input_id=f"input_{input_index % n_inputs}"),
            position=comp.AbsolutePosition(width=w * s, height=h * s, top=top * s,
                                           left=left * s, rotation_degrees=theta),
            transition=one_second)

    cards = [
        card("pip", 3, 1280, 720, 1340, (2460, 100)[stage]),
        card("spin", 1, 960, 540, 400, 300, (0.0, 60.0)[stage]),
        card("rotozoom", 2, (480, 960)[stage], (270, 540)[stage],
             (465, 330)[stage], (1760, 1520)[stage], (0.0, 45.0)[stage]),
        card("tilted", 4, 640, 360, (1700, 1650)[stage], (2900, 3000)[stage], 15.0),
    ]
    return comp.View(background_color=RGBAColor(0, 0, 0), children=[tiles] + cards)


def animated_inputs(n, in_w, in_h, seed):
    """n host input frames (u8 numpy planes): planar YUV420 but input 1,
    which arrives as NV12, and input 2, as RGBA."""
    import numpy as np

    from smelter_tpu_torch.core.types import Frame, PixelFormat

    frames = renderer_inputs(n, in_w, in_h, seed)
    y, u, v = frames["input_1"].data
    frames["input_1"] = Frame(data=(y, np.stack([u, v], axis=-1)), format=PixelFormat.NV12,
                              resolution=frames["input_1"].resolution, pts=0.0)
    rgba = np.random.RandomState(seed + 100).randint(0, 256, (in_h, in_w, 4), dtype=np.uint8)
    rgba[..., 3] = 255
    frames["input_2"] = Frame(data=rgba, format=PixelFormat.RGBA,
                              resolution=frames["input_2"].resolution, pts=0.0)
    return frames


# the compose route functions of the animated-texture phase, by route
ANIM_ROUTES = {
    "scaling": "_render_scaling_rect_layout",
    "moving": "_render_moving_rect_layout",
    "traced rotation": "_render_rotated_rect_layout_traced",
    "roto-zoom": "_render_rotozoom_layout",
    "sampled pass": "render_single_layout",
}


class RouteCounter:
    """Counts the texture layouts each compose route function draws while
    installed (a `with` block), as the K1 capture of `renderer_kernel_runs`
    wraps K1 (`render_single_layout` also draws the colour layers of the
    region-local groups: those are not counted)."""

    def __init__(self):
        self.calls = {route: 0 for route in ANIM_ROUTES}

    def __enter__(self):
        from smelter_tpu_torch.ops import compose

        self._saved = {}
        for route, name in ANIM_ROUTES.items():
            orig = self._saved[name] = getattr(compose, name)

            def counted(static, *args, _orig=orig, _route=route, **kw):
                self.calls[_route] += static.content == "texture"
                return _orig(static, *args, **kw)

            setattr(compose, name, counted)
        return self

    def __exit__(self, *exc):
        from smelter_tpu_torch.ops import compose

        for name, orig in self._saved.items():
            setattr(compose, name, orig)
        return False


def start_transition(dev, n, in_w, in_h, out_w, out_h, frames, scene=renderer_scene):
    """A renderer on `dev` that has rendered pts 0 of `scene` at stage 0
    and then been given stage 1: the transition starts at pts 0."""
    from smelter_tpu_torch.core.types import FrameSet, PixelFormat, Resolution
    from smelter_tpu_torch.render.renderer import Renderer

    r = Renderer(device=dev)
    for iid in frames:
        r.register_input(iid)
    out = (Resolution(out_w, out_h), PixelFormat.PLANAR_YUV420)
    r.update_scene("out", scene(out_w, out_h, n, 0), *out)
    first = r.render(FrameSet(pts=0.0, frames=frames)).frames["out"].data
    r.update_scene("out", scene(out_w, out_h, n, 1), *out)
    return r, first


def render_transition(dev, n, in_w, in_h, out_w, out_h, frames, on_frame=None,
                      scene=renderer_scene):
    """Render pts 0 (stage 0), update the scene to stage 1, render pts k/FPS
    for k = 1..N_RENDER_FRAMES. Returns the frames' planes, on `dev`;
    `on_frame(k, planes)` is called after each frame."""
    from smelter_tpu_torch.core.types import FrameSet

    r, first = start_transition(dev, n, in_w, in_h, out_w, out_h, frames, scene)
    outs = [first]
    if on_frame is not None:
        on_frame(0, first)
    for k in range(1, N_RENDER_FRAMES + 1):
        outs.append(r.render(FrameSet(pts=k / FPS, frames=frames)).frames["out"].data)
        if on_frame is not None:
            on_frame(k, outs[-1])
    return outs


def renderer_kernel_runs(dev, frames):
    """The kernel runs of the renderer scene at 4K, as the frame program
    hands them to the kernels: K1's on the frame at pts 1/FPS, as a K1 case
    (name, (w, h), specs, params), and K3's on the first animating frame
    (pts 2/FPS), as (rows, kinds)."""
    import torch

    from smelter_tpu_torch.core.types import FrameSet
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers
    from smelter_tpu_torch.render.program import _unpack_layout_params

    r, _ = start_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, frames)
    k1_runs = []
    launch = scene_assembly.assemble_scene_planar

    def capture(resolution, specs, params, spec_rows=None):
        k1_runs.append(("renderer frame table", resolution, specs, params.clone()))
        return launch(resolution, specs, params, spec_rows)

    scene_assembly.assemble_scene_planar = capture
    try:
        r.render(FrameSet(pts=1 / FPS, frames=frames))
    finally:
        scene_assembly.assemble_scene_planar = launch
    check(len(k1_runs) == 1, f"a renderer frame ran K1 {len(k1_runs)} times, not once")
    prog = r._programs["out"]
    key, plan = prog.plan(2 / FPS, frames)
    nid = prog.node_id(prog.root)
    statics = next(part[2] for part in key
                   if isinstance(part, tuple) and part[0] == nid and part[1] == "layout")
    vec = torch.from_numpy(plan.packed_params).to(dev)
    params = _unpack_layout_params(vec, {nid: statics})[nid]
    run = [(st, p) for st, p in zip(statics, params) if st.static_rect is None]
    check(len(run) == 4 and all(st.content in ("color", "box_shadow") and st.n_masks == 0
                                for st, _ in run),
          f"the animating renderer frame has no 4-layer K3 run: {[st for st, _ in run]}")
    kinds = tuple((st.content, st.has_border, st.has_rotation) for st, _ in run)
    return k1_runs[0], sdf_layers.pack_layer_params([p for _, p in run]), kinds


def k3_checks(sl, cases):
    """K3 against its plain version on each (name, canvas, rows, kinds);
    the kernel works in place, so it gets a copy of the canvas. Layers that
    all miss the canvas must leave it bit-identical."""
    import torch

    worst = 0.0
    for name, canvas, rows, kinds in cases:
        ref = sl.compose_sdf_layers_planar_plain(canvas, rows, kinds)
        got = sl.compose_sdf_layers_planar(canvas.clone(), rows, kinds)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"K3 {name}: non-finite canvas")
        err = float((got - ref).abs().max())
        lsb = int((quantized(got) - quantized(ref)).abs().max())
        print(f"K3 vs plain {name} ({len(kinds)} layers, {canvas.shape[2]}x"
              f"{canvas.shape[1]}): max abs err {err:.3g}, max u8 diff {lsb} LSB")
        check(err == 0.0, f"K3 {name}: f32 canvas off by {err}")
        if "off the canvas" in name:
            check(torch.equal(got, canvas), f"K3 {name}: the canvas changed")
        worst = max(worst, err)
    return worst


def renderer_parity_vs_cpu(dev, n, in_w, in_h, out_w, out_h, scene=renderer_scene,
                           inputs=renderer_inputs, label="renderer"):
    """Every frame of a renderer transition sequence on the card against
    the port run on the CPU, at parity_vs_cpu's tolerance."""
    from smelter_tpu_torch import interop

    frames = inputs(n, in_w, in_h, seed=2)
    ref = render_transition("cpu", n, in_w, in_h, out_w, out_h, frames, scene=scene)
    got = render_transition(dev, n, in_w, in_h, out_w, out_h, frames, scene=scene)
    mx, n_diff, n_gt1, total = 0, 0, 0, 0
    for a, b in zip(ref, got):
        m, d, g, t = lsb_stats(interop.planes_to_host(a), interop.planes_to_host(b))
        mx, n_diff, n_gt1, total = max(mx, m), n_diff + d, n_gt1 + g, total + t
    print(f"parity card vs CPU {label} {n}x{in_w}x{in_h} -> {out_w}x{out_h}, "
          f"{len(ref)} frames: max {mx} LSB, {n_diff} of {total} pixels differ, "
          f"{n_gt1} by 2+")
    check(mx <= 2 and n_gt1 * 10000 < total, f"{label}: card vs CPU off ({mx} LSB)")


def animated_phase(dev, frames):
    """Phase 7: the animated-texture scene at 16 x 1080p -> 4K through its
    transition. Checks the planes of every frame, each route on the frames
    it is expected on (2..FPS: the first frame after the update is planned
    stable, the frames after the transition's end settle), K1 and K2 on
    every frame, and counts the synchronising calls per frame. Then the same
    sequence at 4 x 256x144 -> 768x432 on the card against the CPU."""
    import torch

    from smelter_tpu_torch import interop
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out

    per_frame = []  # (k, route calls, K1, K2, syncs) after frame k
    counter = RouteCounter()

    def record(k, _planes):
        per_frame.append((k, dict(counter.calls), scene_assembly.LAUNCHES,
                          yuv_out.LAUNCHES, len(syncs)))

    scene_assembly.LAUNCHES = 0
    yuv_out.LAUNCHES = 0
    sdf_layers.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs, counter:
        warnings.simplefilter("always")
        outs = render_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, frames,
                                 on_frame=record, scene=animated_scene)
    torch.cuda.set_sync_debug_mode("default")
    launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                "sdf_layers": sdf_layers.LAUNCHES}
    route_frames = {route: [] for route in ANIM_ROUTES}
    k1_frames, k2_frames, sync_by_frame = [], [], {}
    prev = (dict.fromkeys(ANIM_ROUTES, 0), 0, 0, 0)
    for k, calls, k1, k2, n_sync in per_frame:
        for route in ANIM_ROUTES:
            if calls[route] > prev[0][route]:
                route_frames[route].append(k)
        k1_frames += [k] if k1 > prev[1] else []
        k2_frames += [k] if k2 > prev[2] else []
        sync_by_frame[k] = n_sync - prev[3]
        prev = (calls, k1, k2, n_sync)
    print(f"animated textures: launches over {len(outs)} frames: {launches}; "
          f"route calls: {counter.calls}")
    expected = list(range(2, FPS + 1))
    for route, ks in route_frames.items():
        print(f"animated textures: route {route} taken on frames {ks}")
        check(ks == expected, f"animated textures: route {route} on frames {ks}, "
                              f"not {expected[0]}..{expected[-1]}")
    every = list(range(len(outs)))
    check(k1_frames == every, f"animated textures: K1 ran on frames {k1_frames}, not all")
    check(k2_frames == every, f"animated textures: K2 ran on frames {k2_frames}, not all")
    stable = [sync_by_frame[k] for k in every if k not in expected]
    animating = [sync_by_frame[k] for k in expected]
    print(f"animated textures: synchronising calls flagged per frame: stable frames "
          f"{stable}, animating frames {animating}")
    check(max(animating) == 0, "animated textures: an animating frame synchronised")
    for k, planes in enumerate(outs):
        check_planes(f"animated textures frame {k}", interop.planes_to_host(planes),
                     OUT_W, OUT_H)
    del outs
    renderer_parity_vs_cpu(dev, 4, 256, 144, 768, 432, scene=animated_scene,
                           inputs=animated_inputs, label="animated textures")
    return launches


def animated_timings(dev, frames, stamp):
    """Frame times of the animated-texture scene (CUDA events around
    render(), planning and uploads included), plan()'s host time on
    animating frames, and a torch.profiler breakdown of one animating frame
    (frame 15)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smelter_tpu_torch.core.types import FrameSet

    r, _ = start_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, frames, animated_scene)
    frame_ms, prof, prof_wall = {}, None, None
    for k in range(1, 2 * FPS + 1):
        fs = FrameSet(pts=k / FPS, frames=frames)
        if k == 15:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                r.render(fs)
                torch.cuda.synchronize()
                prof_wall = (time.perf_counter() - t0) * 1e3
            continue
        frame_ms[k] = cuda_ms(lambda: r.render(fs), iters=1, warmup=0)
    anim = [frame_ms[k] for k in range(3, FPS + 1) if k in frame_ms]
    stable = [frame_ms[k] for k in range(FPS + 3, 2 * FPS + 1)]
    t_anim, t_stable = statistics.median(anim), statistics.median(stable)
    print(f"time animated textures frame 16x1080p->4K, animating ({len(anim)} frames): "
          f"median {t_anim:.4f} ms, max {max(anim):.4f} ms {stamp}")
    print(f"time animated textures frame 16x1080p->4K, stable ({len(stable)} frames): "
          f"median {t_stable:.4f} ms, max {max(stable):.4f} ms {stamp}")
    # the device's own events (kernels, copies, fills): the rows of the
    # aten ops that launched them carry the same time again
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    frame_device_ms = sum(e.device_time_total for e in rows) / 1e3
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    print(f"profile animated textures frame 15 (16x1080p->4K): device {frame_device_ms:.4f} ms in "
          f"{sum(e.count for e in rows)} device ops ({n_launch} kernel launches), wall "
          f"{prof_wall:.4f} ms under the profiler, device busy "
          f"{frame_device_ms / prof_wall:.0%} {stamp}")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:12]:
        print(f"  device {e.device_time_total / 1e3:.4f} ms x{e.count}: {e.key[:100]}")
    r, _ = start_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, frames, animated_scene)
    prog = r._programs["out"]
    plan_ms = []
    for k in range(1, FPS + 1):
        t0 = time.perf_counter()
        prog.plan(k / FPS, frames)
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    t_plan = statistics.median(plan_ms[2:])
    print(f"time animated textures plan() on the host, animating frames: median "
          f"{t_plan:.4f} ms {stamp}")
    return dict(anim_ms=t_anim, stable_ms=t_stable, plan_ms=t_plan, device_ms=frame_device_ms,
                launches=n_launch)


def host_ms(fn, iters: int = ITERS, warmup: int = WARMUP) -> float:
    """Median host wall time of one call, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this test runs only on "
              "the card", file=sys.stderr)
        return 1

    from smelter_tpu_torch.core.types import FrameSet, Resolution
    from smelter_tpu_torch import interop
    from smelter_tpu_torch.ops.hopper import build, scene_assembly, sdf_layers, tile_class, yuv_out
    from smelter_tpu_torch.ops.hopper.scene_assembly import MemberSpec
    from smelter_tpu_torch.parallel.flagship import (
        make_flagship_compose,
        make_flagship_general_compose,
    )
    from smelter_tpu_torch.render.program import _pack_frame_buf

    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)})")
    stamp = f"[{card}]"

    # phase 2: build every kernel of csrc/
    t0 = time.perf_counter()
    lib = build.library_path()
    build.library()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {lib}")
    log = lib.parent / lib.name.replace("libsmelter_kernels-", "build-").replace(".so", ".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas: {line.strip()}")

    # phase 3 and 4: each kernel against its plain version on the card
    k2_err = k2_checks(yuv_out, dev)
    render_frames = renderer_inputs(N_INPUTS, IN_W, IN_H, seed=0)
    renderer_k1, overlay_rows, overlay_kinds = renderer_kernel_runs(dev, render_frames)
    cases = k1_tables(dev)
    k1_err = k1_checks(scene_assembly, cases + [renderer_k1] + k1_edge_cases(dev))
    _, res, specs, params = cases[0]
    general_canvas = scene_assembly.assemble_scene_planar(res, specs, params)
    table16 = layer_table(dev, 16, OUT_H, OUT_W, seed=16)
    gen = torch.Generator(device=dev).manual_seed(3)
    odd_canvas = torch.rand((4, 257, 511), generator=gen, device=dev)
    even_canvas = torch.rand((4, 256, 512), generator=gen, device=dev)
    off_rows = overlay_rows.clone()
    off_rows[:, 0] += OUT_H + 200.0  # every layer below the canvas
    k3_cases = [
        ("renderer overlays over general_4k", general_canvas, overlay_rows, overlay_kinds),
        ("16-layer table over general_4k", general_canvas, *table16),
        ("4-layer table at 257x511", odd_canvas, *layer_table(dev, 4, 257, 511, seed=4)),
        ("edge cases at 512x256", even_canvas,
         torch.tensor(edge_rows(256, 512)[0], device=dev), edge_rows(256, 512)[1]),
        ("edge cases at 511x257", odd_canvas,
         torch.tensor(edge_rows(257, 511)[0], device=dev), edge_rows(257, 511)[1]),
        ("renderer overlays all off the canvas", general_canvas, off_rows, overlay_kinds),
    ]
    k3_err = k3_checks(sdf_layers, k3_cases)

    # phase 5: the flagship builders, 16 x 1080p -> 4K
    in_res, out_res = Resolution(IN_W, IN_H), Resolution(OUT_W, OUT_H)
    t0 = time.perf_counter()
    grid_fn, _ = make_flagship_compose(N_INPUTS, in_res, out_res, device=dev)
    gen_fn, _ = make_flagship_general_compose(N_INPUTS, in_res, out_res, device=dev)
    torch.cuda.synchronize()
    print(f"builders ready in {time.perf_counter() - t0:.1f} s")
    frames = host_frames(N_INPUTS, IN_W, IN_H)

    scene_assembly.LAUNCHES = 0
    yuv_out.LAUNCHES = 0
    sdf_layers.LAUNCHES = 0
    dev_frames = interop.planes_to_device(frames, dev)
    grid_out = interop.planes_to_host(grid_fn(*dev_frames))
    check(scene_assembly.LAUNCHES == 0 and yuv_out.LAUNCHES == 0,
          "the grid scene runs no kernel")
    gen_out = interop.planes_to_host(gen_fn(*dev_frames))
    launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                "sdf_layers": sdf_layers.LAUNCHES}
    print(f"flagship path launches during general_4k: {launches}")
    check(launches["scene_assembly"] > 0, "general_4k did not launch K1")
    check(launches["yuv_out"] > 0, "general_4k did not launch K2")
    for label, planes in (("grid", grid_out), ("general_4k", gen_out)):
        check_planes(label, planes, OUT_W, OUT_H)
    parity_vs_cpu(make_flagship_compose, 4, 256, 144, 768, 432, dev, "grid")
    parity_vs_cpu(make_flagship_general_compose, 4, 256, 144, 768, 432, dev, "general_4k")
    parity_vs_cpu(make_flagship_compose, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, dev, "grid")

    # phase 6: the renderer, 16 x 1080p -> 4K, a transition of 41 frames
    k3_frames = []

    def count_k3(k, _planes):
        k3_frames.append((k, sdf_layers.LAUNCHES, len(syncs)))

    scene_assembly.LAUNCHES = 0
    yuv_out.LAUNCHES = 0
    sdf_layers.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        outs = render_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H,
                                 render_frames, on_frame=count_k3)
    torch.cuda.set_sync_debug_mode("default")
    render_launches = {"scene_assembly": scene_assembly.LAUNCHES,
                       "yuv_out": yuv_out.LAUNCHES, "sdf_layers": sdf_layers.LAUNCHES}
    per_frame, sync_frames = [], {}
    prev_n, prev_s = 0, 0
    for k, n, n_sync in k3_frames:
        per_frame.append((k, n - prev_n))
        if n_sync > prev_s:
            sync_frames[k] = n_sync - prev_s
        prev_n, prev_s = n, n_sync
    print(f"renderer path launches over {len(outs)} frames: {render_launches}; "
          f"host-device synchronisations flagged by frame: {sync_frames}")
    animating = [k for k, d in per_frame if d > 0]
    print(f"K3 launched on frames {animating}")
    check(render_launches["scene_assembly"] > 0, "the renderer did not launch K1")
    check(render_launches["yuv_out"] == len(outs), "the renderer did not launch K2 per frame")
    check(len(animating) >= 20, f"K3 ran on {len(animating)} animating frames, not 20+")
    settled = [k for k, _ in per_frame if k > FPS + 1]
    check(settled and not set(settled) & set(animating),
          "K3 ran on a settled frame (after the transition)")
    for k, planes in enumerate(outs):
        check_planes(f"renderer frame {k}", interop.planes_to_host(planes), OUT_W, OUT_H)
    del outs
    renderer_parity_vs_cpu(dev, 4, 256, 144, 768, 432)

    # phase 7: animated textures, 16 x 1080p (one NV12, one RGBA) -> 4K
    anim_frames = animated_inputs(N_INPUTS, IN_W, IN_H, seed=5)
    anim_launches = animated_phase(dev, anim_frames)

    # phase 8: timings (medians of ITERS runs after WARMUP)
    # kernels: "kernel" = back-to-back launches (kernel_ms), "call" = one
    # synchronised call (cuda_ms), "plain" = the plain version, one call;
    # "bound" from this run's inputs: the bytes each must move and the
    # blends each must do (the pixels its members reach, tile_class.reach)
    canvas_bytes = 4 * OUT_H * OUT_W * 4
    k1_timed = [
        ("empty table (canvas write only)", res, [], params[:0]),
        ("background member alone", res, specs[:1], params[:1]),
        ("general_4k table", res, specs, params),
        renderer_k1,
    ]
    k1 = {}
    for name, (w, h), sp, pr in k1_timed:
        rows = scene_assembly.spec_table(sp, dev)
        fn = lambda r=(w, h), sp=sp, pr=pr, rows=rows: scene_assembly.assemble_scene_planar(  # noqa: E731
            r, sp, pr, rows)
        t, t_call = kernel_ms(fn), cuda_ms(fn)
        t_dev = device_ms(fn, "scene_assembly_kernel")
        _, pairs = tile_class.reach(sp, pr, h, w)
        n_bytes = 4 * h * w * 4 + pr.numel() * 4 + rows.numel() * 4
        bound, by = bound_ms(n_bytes, BLEND_OPS * pairs)
        k1[name] = dict(ms=t, call_ms=t_call, device_ms=t_dev, bound_ms=bound, bound_by=by,
                        bytes=n_bytes)
        print(f"time K1 scene_assembly {w}x{h} {name} ({len(sp)} members): kernel {t:.4f} ms, "
              f"call {t_call:.4f} ms, device {t_dev} ms, bound {bound:.4f} ms by {by} "
              f"({n_bytes} B, {pairs} member-pixels), {bound / t:.0%} of bound {stamp}")
    scratch = torch.empty((4, OUT_H, OUT_W), dtype=torch.float32, device=dev)
    t_fill = kernel_ms(lambda: scratch.fill_(0.0))
    del scratch
    print(f"time torch fill_ of a 4K canvas (the card's write rate, a yardstick for "
          f"K1's store path): {t_fill:.4f} ms, {bound_ms(canvas_bytes)[0] / t_fill:.0%} of "
          f"the write bound {stamp}")
    k1_main = k1["general_4k table"]
    k1_main["plain_ms"] = cuda_ms(
        lambda: scene_assembly.assemble_scene_planar_plain(res, specs, params))
    print(f"time K1 scene_assembly 4K general_4k table: plain {k1_main['plain_ms']:.4f} ms "
          f"{stamp}")
    k2_bytes = 3 * OUT_H * OUT_W * 4 + OUT_H * OUT_W * 3 // 2
    k2_bound, k2_by = bound_ms(k2_bytes)
    t_k2 = kernel_ms(lambda: yuv_out.rgba_cm_to_yuv420(general_canvas))
    t_k2_call = cuda_ms(lambda: yuv_out.rgba_cm_to_yuv420(general_canvas))
    t_k2_plain = cuda_ms(lambda: yuv_out.rgba_cm_to_yuv420_plain(general_canvas))
    t_k2_dev = device_ms(lambda: yuv_out.rgba_cm_to_yuv420(general_canvas), "yuv420_out_kernel")
    print(f"time K2 yuv_out 4K: kernel {t_k2:.4f} ms, call {t_k2_call:.4f} ms, device "
          f"{t_k2_dev} ms, plain {t_k2_plain:.4f} ms, bound {k2_bound:.4f} ms by {k2_by} "
          f"({k2_bytes} B), {k2_bound / t_k2:.0%} of bound {stamp}")
    # K3 updates its canvas in place: the timed calls cycle over three
    # copies, so that no launch finds the canvas of the last one in L2
    k3_timed = [("no layers (canvas read and write only)", general_canvas,
                 params.new_zeros((0, sdf_layers.PARAMS_WIDTH)), ())] + k3_cases[:2]
    k3 = {}
    for name, canvas, rows, kinds in k3_timed:
        works = [canvas.clone() for _ in range(3)]
        table = sdf_layers.kinds_table(kinds, dev)
        turn = [0]

        def k3_call(rows=rows, kinds=kinds, table=table, works=works, turn=turn):
            turn[0] = (turn[0] + 1) % len(works)
            return sdf_layers._launch(works[turn[0]], rows, kinds, table)

        t, t_call = kernel_ms(k3_call), cuda_ms(k3_call)
        t_dev = device_ms(k3_call, "sdf_layers_kernel")
        t_plain = cuda_ms(lambda: sdf_layers.compose_sdf_layers_planar_plain(canvas, rows, kinds))
        del works
        k3_specs = [MemberSpec(c, b, r, 0, (), (0, 0, OUT_H, OUT_W)) for c, b, r in kinds]
        px, pairs = tile_class.reach(k3_specs, rows, OUT_H, OUT_W) if kinds else (0, 0)
        n_bytes = 2 * 16 * px + rows.numel() * 4 + table.numel() * 4
        bound, by = bound_ms(n_bytes, BLEND_OPS * pairs)
        k3[name] = dict(ms=t, call_ms=t_call, device_ms=t_dev, plain_ms=t_plain,
                        bound_ms=bound, bound_by=by, bytes=n_bytes, footprint_px=px)
        print(f"time K3 sdf_layers 4K {name} ({len(kinds)} layers): kernel {t:.4f} ms, "
              f"call {t_call:.4f} ms, device {t_dev} ms, plain {t_plain:.4f} ms, "
              f"bound {bound:.4f} ms by {by} "
              f"({px} footprint px of {OUT_H * OUT_W}, {n_bytes} B, {pairs} layer-pixels), "
              f"{bound / t:.0%} of bound; full-canvas bound "
              f"{bound_ms(2 * canvas_bytes)[0]:.4f} ms {stamp}")
    k3_main = k3["renderer overlays over general_4k"]
    t_grid = cuda_ms(lambda: grid_fn(*dev_frames))
    t_gen = cuda_ms(lambda: gen_fn(*dev_frames))
    print(f"time frame compute only, grid 16x1080p->4K: {t_grid:.4f} ms {stamp}")
    print(f"time frame compute only, general_4k 16x1080p->4K: {t_gen:.4f} ms {stamp}")
    t_grid_io = cuda_ms(lambda: interop.planes_to_host(
        grid_fn(*interop.planes_to_device(frames, dev))))
    t_gen_io = cuda_ms(lambda: interop.planes_to_host(
        gen_fn(*interop.planes_to_device(frames, dev))))
    print(f"time frame with H2D+D2H copies, grid 16x1080p->4K: {t_grid_io:.4f} ms {stamp}")
    print(f"time frame with H2D+D2H copies, general_4k 16x1080p->4K: "
          f"{t_gen_io:.4f} ms {stamp}")

    # the renderer: each frame of a second run of the sequence, CUDA events
    # around render() (host planning and the uploads included), then the
    # host time of plan() alone on stable and animating frames
    r, _ = start_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, render_frames)
    frame_ms = {}
    for k in range(1, 3 * FPS + 1):
        fs = FrameSet(pts=k / FPS, frames=render_frames)
        frame_ms[k] = cuda_ms(lambda: r.render(fs), iters=1, warmup=0)
    anim = [frame_ms[k] for k in range(3, FPS + 1)]
    stable = [frame_ms[k] for k in range(FPS + 3, 3 * FPS + 1)]
    t_anim, t_stable = statistics.median(anim), statistics.median(stable)
    print(f"time renderer frame 16x1080p->4K, animating (K1+K3+K2, {len(anim)} frames): "
          f"median {t_anim:.4f} ms, max {max(anim):.4f} ms {stamp}")
    print(f"time renderer frame 16x1080p->4K, stable (K1+K2, {len(stable)} frames): "
          f"median {t_stable:.4f} ms, max {max(stable):.4f} ms {stamp}")
    print(f"time renderer frames with a new structure (first sight, build): "
          f"{[round(frame_ms[k], 4) for k in (1, 2, FPS + 1)]} ms {stamp}")
    prog = r._programs["out"]
    t_plan_stable = host_ms(lambda: prog.plan(3.0, render_frames))
    r, _ = start_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, render_frames)
    prog = r._programs["out"]
    plan_ms = []
    for k in range(1, FPS + 1):
        t0 = time.perf_counter()
        prog.plan(k / FPS, render_frames)
        plan_ms.append((time.perf_counter() - t0) * 1e3)
    t_plan_anim = statistics.median(plan_ms[2:])
    t_pack = host_ms(lambda: _pack_frame_buf(render_frames, pin=True))
    print(f"time renderer plan() on the host, 16 inputs + 2 overlays: stable "
          f"{t_plan_stable:.4f} ms, animating {t_plan_anim:.4f} ms (median); of "
          f"which packing the input planes into pinned memory {t_pack:.4f} ms")
    anim_times = animated_timings(dev, anim_frames, stamp)
    print(json.dumps({"animated_textures": {"kernel_launches": anim_launches, **anim_times,
                                            "card": card}}))

    check("jax" not in sys.modules, "the port imported jax")
    # no single PyTorch call computes any of the three functions:
    # library_ms is null
    kernels = [
        {"name": "scene_assembly", "route": "cuda",
         "source": "smelter_tpu_torch/csrc/scene_assembly.cu",
         "replaces": "smelter_tpu/ops/pallas/scene_assembly.py:194",
         "launches": render_launches["scene_assembly"], "max_abs_err": k1_err,
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": None, "call_ms": k1_main["call_ms"],
         "device_ms": k1_main["device_ms"], "bytes": k1_main["bytes"]},
        {"name": "yuv_out", "route": "cuda",
         "source": "smelter_tpu_torch/csrc/yuv_out.cu",
         "replaces": "smelter_tpu/ops/pallas/yuv_out.py:82",
         "launches": render_launches["yuv_out"], "max_abs_err": k2_err,
         "ms": t_k2, "plain_ms": t_k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "call_ms": t_k2_call, "device_ms": t_k2_dev,
         "bytes": k2_bytes},
        {"name": "sdf_layers", "route": "cuda",
         "source": "smelter_tpu_torch/csrc/sdf_layers.cu",
         "replaces": "smelter_tpu/ops/pallas/sdf_layers.py:66",
         "launches": render_launches["sdf_layers"], "max_abs_err": k3_err,
         "ms": k3_main["ms"], "plain_ms": k3_main["plain_ms"],
         "bound_ms": k3_main["bound_ms"], "bound_by": k3_main["bound_by"],
         "library_ms": None, "call_ms": k3_main["call_ms"],
         "device_ms": k3_main["device_ms"], "bytes": k3_main["bytes"],
         "footprint_px": k3_main["footprint_px"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
