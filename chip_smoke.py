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
     on the general_4k member table at 4K and on a mixed-member case with
     partial tiles, rotation, border, shadow and masks: atol 2e-5 on the f32
     canvas and <= 1 LSB after u8 quantisation;
  5. drives the main path, 16 x 1080p YUV420 -> one 4K YUV420 frame, through
     the flagship builders (the Tiles grid, then general_4k), host frames
     going through pinned memory to the card and the planes coming back;
     checks shapes and dtypes, that general_4k launched K1 and K2, and that
     the card's frames match the port run on the CPU;
  6. times K1 and K2 against their plain versions and the whole frames,
     with CUDA events (median of 20 runs after warm-up);
and prints a JSON line of the kernels, the nvidia-smi line, and last
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

ITERS = 20
WARMUP = 3
N_INPUTS = 16
IN_W, IN_H = 1920, 1080
OUT_W, OUT_H = 3840, 2160


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
    each call, synchronised after each (host gaps inside a call count)."""
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
    from smelter_tpu.core.types import Resolution
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
        check(err <= 2e-5, f"K1 {name}: f32 canvas off by {err}")
        check(lsb <= 1, f"K1 {name}: u8 canvas off by {lsb} LSB")
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

    from smelter_tpu.core.types import Resolution
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this test runs only on "
              "the card", file=sys.stderr)
        return 1

    from smelter_tpu.core.types import Resolution
    from smelter_tpu_torch import interop
    from smelter_tpu_torch.ops.hopper import build, scene_assembly, yuv_out
    from smelter_tpu_torch.parallel.flagship import (
        make_flagship_compose,
        make_flagship_general_compose,
    )

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
    cases = k1_tables(dev)
    k1_err = k1_checks(scene_assembly, cases)

    # phase 5: the main path, 16 x 1080p -> 4K
    in_res, out_res = Resolution(IN_W, IN_H), Resolution(OUT_W, OUT_H)
    t0 = time.perf_counter()
    grid_fn, _ = make_flagship_compose(N_INPUTS, in_res, out_res, device=dev)
    gen_fn, _ = make_flagship_general_compose(N_INPUTS, in_res, out_res, device=dev)
    torch.cuda.synchronize()
    print(f"builders ready in {time.perf_counter() - t0:.1f} s")
    frames = host_frames(N_INPUTS, IN_W, IN_H)

    scene_assembly.LAUNCHES = 0
    yuv_out.LAUNCHES = 0
    dev_frames = interop.planes_to_device(frames, dev)
    grid_out = interop.planes_to_host(grid_fn(*dev_frames))
    check(scene_assembly.LAUNCHES == 0 and yuv_out.LAUNCHES == 0,
          "the grid scene runs no kernel")
    gen_out = interop.planes_to_host(gen_fn(*dev_frames))
    launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES}
    print(f"main path launches during general_4k: {launches}")
    check(launches["scene_assembly"] > 0, "general_4k did not launch K1")
    check(launches["yuv_out"] > 0, "general_4k did not launch K2")
    for label, planes in (("grid", grid_out), ("general_4k", gen_out)):
        shapes = [p.shape for p in planes]
        print(f"{label} output planes: {shapes} {planes[0].dtype}")
        check(shapes == [(OUT_H, OUT_W), (OUT_H // 2, OUT_W // 2), (OUT_H // 2, OUT_W // 2)]
              and all(str(p.dtype) == "uint8" for p in planes),
              f"{label}: wrong output planes {shapes}")
        check(all(int(p.max()) > int(p.min()) for p in planes),
              f"{label}: a flat output plane")
    parity_vs_cpu(make_flagship_compose, 4, 256, 144, 768, 432, dev, "grid")
    parity_vs_cpu(make_flagship_general_compose, 4, 256, 144, 768, 432, dev, "general_4k")
    parity_vs_cpu(make_flagship_compose, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, dev, "grid")

    # phase 6: timings (medians of ITERS runs after WARMUP)
    general_case = cases[0]
    _, res, specs, params = general_case
    spec_rows = scene_assembly.spec_table(specs, dev)
    t_k1 = cuda_ms(lambda: scene_assembly.assemble_scene_planar(res, specs, params, spec_rows))
    t_k1_plain = cuda_ms(lambda: scene_assembly.assemble_scene_planar_plain(res, specs, params))
    canvas = scene_assembly.assemble_scene_planar(res, specs, params, spec_rows)
    t_k2 = cuda_ms(lambda: yuv_out.rgba_cm_to_yuv420(canvas))
    t_k2_plain = cuda_ms(lambda: yuv_out.rgba_cm_to_yuv420_plain(canvas))
    print(f"time K1 scene_assembly 4K general_4k table: kernel {t_k1:.4f} ms, "
          f"plain {t_k1_plain:.4f} ms {stamp}")
    print(f"time K2 yuv_out 4K: kernel {t_k2:.4f} ms, plain {t_k2_plain:.4f} ms {stamp}")
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

    check("jax" not in sys.modules, "the port imported jax")
    kernels = [
        {"name": "scene_assembly", "route": "cuda",
         "source": "smelter_tpu_torch/csrc/scene_assembly.cu",
         "replaces": "smelter_tpu/ops/pallas/scene_assembly.py:194",
         "launches": launches["scene_assembly"], "max_abs_err": k1_err,
         "ms": t_k1, "plain_ms": t_k1_plain},
        {"name": "yuv_out", "route": "cuda",
         "source": "smelter_tpu_torch/csrc/yuv_out.cu",
         "replaces": "smelter_tpu/ops/pallas/yuv_out.py:82",
         "launches": launches["yuv_out"], "max_abs_err": k2_err,
         "ms": t_k2, "plain_ms": t_k2_plain},
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
