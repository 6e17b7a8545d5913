#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`smelter_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --moq-capacity 1 2 4 8   # phase 13a alone, ungated

Run from the root of a checkout, on a machine with a CUDA card and nvcc
(found on PATH or under /usr/local/cuda/bin). It:
  1. exits 1 at once when torch sees no CUDA device (there is no CPU
     fallback: the point is the card);
  2. prints the card's name and power limit, builds every kernel of
     `smelter_tpu_torch/csrc/` (into `smelter_tpu_torch/_build/`) and prints
     the build time and the compiler's register report;
  3. holds kernel K2 (YUV420 output) against its plain PyTorch version on
     the card: <= 1 u8 LSB on every plane, and bit-equal, on the card and
     against the plain version on the CPU, on a canvas with NaN, +Inf and
     -Inf pixels; and the grid's u8 rounding of such values, card vs CPU;
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
     (the Tiles grid, then general_4k), each captured into a CUDA graph
     (`render.capture.capture`, as the reference jits them) and replayed;
     checks shapes and dtypes, that a general_4k replay launched K1 and K2
     once each, that each replay equals the eager function bit for bit, and
     that the card's frames match the port run on the CPU; times both
     eager and replayed;
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
  8. drives the pipeline (`smelter_tpu_torch.pipeline.Pipeline`), the
     entry point the server builds, through raw in-process inputs and a
     raw output sink: (a) offline (ahead-of-time, never-drop), 16 inputs
     of 2 s at 1080p 30 fps (input 0 with a stereo tone) into a 4K raw
     video and audio output, the renderer scene's overlays moving from
     0.1 s, `animated_scene` from 0.5 s and animating from 1.0 s (scheduled
     updates), the last input unregistered at 1.5 s; checks 60 +- 1 frames
     of host u8 planes, OUTPUT_DONE and no OUTPUT_ERROR, K1 and K2 on every
     frame and K3 on some, every frame equal (max abs err 0) to the port's
     renderer on the card driven directly with the pipeline's own calls
     (compared after the run), no synchronising call on the renderer
     thread in a frame that built no new structure, and the same run at
     4 x 256x144 -> 768x432 against the port's Pipeline on the CPU; (b) in
     real time, inputs fed at 30 fps for 5 s by one thread each, at
     16 x 1080p -> 4K and 4 x 1080p -> 1080p: the delivered frame rate, the
     dropped frames, the latency from a frame's send to its delivery (p50,
     p95), the render, fetch-host and plan spans, the host enqueue time of
     render() and the card's busy share over the window's last second
     (recorded, not gated);
  10. drives the renderer through Shader, Image and WebView nodes
     (`nodes_scene`): 16 host 1080p inputs into 4K PLANAR_YUV420, NV12 and
     PLANAR_YUV444 outputs at once, a Tiles grid under the docs' `pulse`
     shader of input 0, a `gradient` shader of no input, a 4-input
     `circle_layout` shader (JAX-syntax sources run by the port's torch
     `jnp`), a 3-frame animated image built in numpy, a WebView with no
     browser behind it and a banner that slides for one second, 41 frames
     at 30 fps; checks K1 on every frame of every output, K2 on every
     YUV420 and NV12 frame and never for YUV444, K3 on exactly the banner's
     moving frames 2-30, no synchronising call on frames 2-40, NV12 equal
     to the YUV420 output interleaved, and the card within 1 LSB of the CPU
     at 4 x 256x144 -> 768x432; times the frames (three outputs together
     and each alone), one animating frame under torch.profiler and each
     shader;
  9. times the kernels (CUDA events around 50 launches queued back to
     back, one synchronised call, and the device time torch.profiler
     reads for the kernel alone) against their plain versions and
     their bounds (bytes and operations at the H100 SXM's peaks), the whole
     frames, the host time of the renderer's per-frame planning, and the
     animated-texture frames (animating and stable, plan(), and a
     torch.profiler breakdown of one animating frame);
  11. drives the live pipeline (so the renderer's background capture),
     16 x 1080p -> 4K, `renderer_scene` replaced mid-stream by a scene of
     another structure (`marked_scene`, a green bar over the grid): checks
     that every frame keeps the output's resolution and format, that the
     renders after the update re-emit the last frame (bit-equal at the
     sink) until the new graph lands and that every render after it shows
     the new scene; prints the frozen frames and the time from the update to
     the first new frame's delivery.
  12. drives the port's HTTP server (`smelter_tpu_torch.server.app`, on the
     card, in real time, in this process) through the protocol edges: a
     child process sends 16 1080p H.264 inputs at 30 fps for 6 s (13 RTP
     over UDP with RTCP sender reports, one RTP over TCP, one RTMP through
     the port's RtmpClientOutput, one WHIP through its WhipClientOutput),
     all registered over HTTP, into `renderer_scene` as wire JSON, updated
     at 3 s (the overlays move); the 4K H.264 output comes back over RTP to
     the child, which depayloads and decodes it. Checks the answers, the
     events, >= 90 frames of 3840x2160, each input's colour in its tile,
     K1/K2 per rendered frame and K3 on the update only, no synchronising
     call on a replay, and an empty /status after the unregisters; records
     the received frame rate, the send -> arrival latency of input 0's
     frames, each decoder's delay and end-of-stream losses, the spans and
     the card's busy share (`edges_phase`). Where the codec service cannot
     load (no FFmpeg), one probe says so and the phase prints
     `{"edges": {"skipped": ...}}` and runs nothing else.
  13. MoQ (`moq_phase`). (a) The transport, no codec (`moq_transport_phase`):
     the port's MoqServer in this process, its inputs plain subscribers; a
     child process publishes over the port's QuicClient, MoqSession and
     BroadcastPublisher, one broadcast and one video track a connection, 30
     objects/s for 5 s (a 100 kB keyframe object opening each one-second
     group, 20 kB deltas: 5 Mbit/s), payloads from a seed. A gated run at 1
     publisher (a wrong token refused; every object byte-equal, keyframe
     flag, group and order, by 30 s after the last write; every session,
     endpoint and thread closed on both sides) and capacity runs at 2 and
     16 (the delivered share recorded, not gated); each records objects/s,
     MB/s, write -> read latency, handshake ms and both processes' CPU
     seconds; the part is timed against a 60 s budget (recorded) and fails
     past 120 s. (b) The media path (`moq_media_phase`), where the codec
     service loads: the port's server on the card in real time, 4 x 1080p
     H.264 `moq_server` inputs (2 CMAF, 2 legacy) registered over HTTP on
     its one MoQ listener, `renderer_scene` as wire JSON updated at 4 s, 4K
     H.264 out through a `moq_client` output to a MoqServer + MoqServerInput
     in the child; gated as phase 12. Where the codec service cannot load,
     (b) prints `{"skipped": ...}` after phase 12's probe. Prints
     `{"moq": {"transport": ..., "media": ...}}`.
  14. renders the reference's three 4K goldens (`tests/snapshots/res4k_*`:
     the 16-tile grid and the two rotated, bordered, shadowed layouts) with
     the port's renderer on the card and holds each to its PNG at a mean
     abs error of 1.0 per channel (`goldens_4k_phase`); prints
     `{"goldens_4k": ...}`.
  15. the multi-device steps (`multichip_phase`, after the live phases have
     closed their pipelines): (a) `graft_entry.dryrun_multichip(8,
     device="cpu")`, 8 gloo ranks on a 2 x 4 ("streams", "space") mesh on
     the card's host, gated on its own parity; (b) on the card over NCCL,
     this process as the one rank of a 1 x 1 mesh: the grid step at
     16 x 1080p -> 4K and the general step at 8 x 1080p -> 4K, each held to
     its single-device builder on the card (<= 1 LSB, bit-equality
     printed), the general step also to the port on the CPU at
     8 x 480x270 -> 960x540, and the outputs-sharded step with 2 outputs at
     4K, each equal to the compose of its order; prints each step's ms
     beside one device's, each collective's ms and bytes, and
     `{"multichip": ...}`; K2 and K3 must launch (the general step).
  16. the benchmark (`bench_phase`, after phase 5): `smelter_tpu_torch.
     bench.main()` at its own sizes (16 x 1080p -> 4K, 60 iterations),
     which prints the reference bench's JSON line with the card's numbers;
     K1 and K2 launched once per run of its general program and K3 never;
     a grid and a general replay bit-equal to their eager functions, each
     frame of a batched replay (4 frames) bit-equal to its single compose;
     fails past 90 s; prints `{"bench_phase": ...}`.
  17. the measurement tools (`tools_phase`, after phase 16): each of
     `smelter_tpu_torch.tools`' `main()` at the reference's default sizes
     (`bench_scenes --ops`, `bench_animations`, `bench_latency`,
     `bench_flagship_ops` and `--general`, `bench_overlap --no-codec`),
     each printing its JSON lines, with every kernel count set to 0 just
     before each tool and read just after; gates: every line parses, none
     has "error" and each names the card; `frames` as asked;
     `bench_scenes` adds no structure key in its timed window, and one
     replayed frame of each of its scenes is bit-equal to its program run
     eagerly (`EagerCheck`); `bench_latency` has samples; the grid's
     `device_p50_ms` of `bench_flagship_ops` is within 10% of phase 16's
     (the same program, another reader); the reader's busy time, span and
     kernel sum for general_4k beside CUDA events, and every replay of one
     program but a trace's first (which may hold fewer) given the same
     count of device activities in 12 traces of the grid
     (`profile_reader_check`). Prints the structure keys each animation added in its burst and what
     changed in them. The codec
     tools (`bench_offline`, `bench_streams`, `bench_overlap`'s codec
     stages) print `{"tool": ..., "skipped": ...}` after one probe of the
     codec service where it cannot load. 150 s budget, recorded; fails
     past 300 s; prints `{"tools_phase": ...}`.
  18. the 16-bit compose canvas (`canvas_storage_phase`, after phase 17):
     (a) K1 with u16, f16 and bf16 stores on the phase 3/4 member tables,
     tile-class edge cases and NaN/Inf colours, and K2 on u16, f16 and bf16 canvases (the
     general_4k canvas, random ones at 1080p, odd and W % 4 != 0 widths,
     planes 1 and 4 elements off their allocation, NaN/Inf in f16 and
     bf16), each bit-equal to its plain version; (b) the general_4k builder
     under each SMELTER_CANVAS_DTYPE: the stored dtype, K1 and K2 once per
     replay, each replay bit-equal to its function run eagerly, u16 within
     1 LSB of f32 (gated), f16 and bf16 recorded, each replay timed; (c)
     phase 6's renderer transition, 10 frames, under f32 and u16 (K3 on the
     decoded root): every u16 frame within 1 LSB of f32, every render held
     to its program run eagerly; (d) `bench_canvas_ab --variants
     u16,f16,bf16,f32 --gate u16`, `bench_assembly_ab` and `bench_align_ab`
     at the reference's defaults: every line parses, none has "error", each
     names the card. 90 s budget, recorded; fails past 200 s; prints
     `{"canvas_storage": ...}`; phase 9 times K1's 16-bit stores and K2's
     16-bit loads beside their bounds.
  19. the tools on the card (`soak_tools_phase`, after phase 15): (a)
     `smelter_tpu_torch.tools.soak_live.run_round`, 2 rounds of 8 s at
     1280x720 from 2 x 640x360, and (b) 1 round of 12 s at 3840x2160 from
     2 x 1920x1080: a scene structure change every 3 s, each captured in a
     background thread while the loop renders at full speed, no profiler
     active; gates per round: every update's scene reaches the output
     within its burst, each update captured a program, its first replay is
     bit-equal to its program run eagerly (`EagerCheck`), the last frame is
     within 1 LSB of the port on the CPU; K1 and K2 launched (K3 printed);
     (c) `python -m smelter_tpu_torch.tools.dependency_check --json` in a
     child: torch, the card, nvcc and the kernels' build pass, the FFmpeg
     check agrees with phase 12's probe, exit 1 exactly when a required
     check fails (no FFmpeg); (d) an offline pipeline (1 raw input, 10
     frames at 1280x720) with only SMELTER_JAX_PROFILER_DIR set writes
     `trace.json` there, holding K2. 60 s budget, recorded; fails past
     150 s; prints `{"soak_tools": ...}`.
The renderer phases (6, 7, 8's offline run and 10) run through captured
programs: every render is also held bit for bit to the closure of its
structure run eagerly on the same frame (`EagerCheck`, outside every count),
no frame that replays a graph may synchronise, the kernel and route counts
are those of the graphs' records, and each phase prints its captures,
structure keys, capture times and graph memory.
(phase 13a runs right after the build, while the process holds nothing
else; phase 10 runs between 8 and 9, phase 11 after 8, phases 12, 13b, 14,
15 and 19 after 10) and prints a JSON line of the edges phase (`{"edges": ...}`), one
of the MoQ phase (`{"moq": ...}`), a JSON line of the
animated-texture numbers, a JSON line of the pipeline's numbers
(`{"pipeline": {"offline": ..., "live": [...]}}`), a JSON line of the nodes
phase (`{"nodes": ...}`), a JSON line of the captured programs of every
phase (`{"captured_programs": ...}`), the 4K goldens' errors
(`{"goldens_4k": ...}`), the multichip phase's (`{"multichip": ...}`), a
JSON line of the kernels (`launches` from the pipeline's offline 4K run,
each path's counts under `launches_by_path`, the nodes, multichip,
bench, tools and soak phases' included, the tools' and the A/B tools' per tool;
K1's and K2's 16-bit times, bounds and launches per replay under
`storage_16bit`), the nvidia-smi line, and
last `{"ok": true, "device": {...}}`. Any failed phase ends the run with a
non-zero exit and no "ok" line.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import threading
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
# seconds before a hung run dumps its threads' stacks and exits: inside the
# 900 s of `chiprun --timeout 900` (and the 1200 s the script is given)
WATCHDOG_S = 840
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
    # NaN, +Inf and -Inf pixels (a shader can yield them; 5% of the pixels,
    # so that many 2x2 chroma quads mix them with finite ones): bit-equal to
    # the plain version on the card and on the CPU, which the tests hold to
    # the reference
    canvas = torch.rand((4, 200, 520), generator=gen, device=dev)
    bad = torch.tensor([float("nan"), float("inf"), -float("inf")], device=dev)
    which = torch.randint(0, 3, canvas.shape, generator=gen, device=dev)
    hit = torch.rand(canvas.shape, generator=gen, device=dev) < 0.05
    canvas = torch.where(hit, bad[which], canvas)
    for full_range in (False, True):
        got = yuv_out.rgba_cm_to_yuv420(canvas, full_range)
        for where, ref in (("card", yuv_out.rgba_cm_to_yuv420_plain(canvas, full_range)),
                           ("CPU", yuv_out.rgba_cm_to_yuv420_plain(canvas.cpu(), full_range))):
            for name, a, b in zip("yuv", ref, got):
                d = (a.to(torch.int32).cpu() - b.to(torch.int32).cpu()).abs()
                mx, nd = int(d.max()), int((d > 0).sum())
                print(f"K2 vs plain on the {where}, NaN/Inf canvas full_range={full_range} "
                      f"plane {name}: max diff {mx} LSB, {nd} of {d.numel()} pixels differ")
                check(mx == 0, f"K2 on NaN/Inf pixels: plane {name} off by {mx} LSB from "
                               f"the plain version on the {where}")
    return worst


def round_u8_check(dev):
    """The grid's u8 rounding (`flagship._round_u8`) of NaN, +-Inf and
    out-of-range values: the card equal to the CPU."""
    import torch
    from smelter_tpu_torch.parallel.flagship import _round_u8

    vals = torch.tensor([float("nan"), float("inf"), -float("inf"), 300.0, -5.0, 127.5,
                         254.5, 0.49, 1e30, -1e30])
    x = vals.repeat(4096)[torch.randperm(4096 * len(vals), generator=torch.Generator().manual_seed(1))]
    card, cpu = _round_u8(x.to(dev)).cpu(), _round_u8(x)
    n = int((card != cpu).sum())
    print(f"grid u8 rounding of NaN/Inf/out-of-range values, card vs CPU: {n} of {x.numel()} differ")
    check(n == 0, f"_round_u8: {n} values differ between the card and the CPU")


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
    region-local groups: those are not counted). A call made while a graph
    is captured counts on each replay of that graph (`capture.each_run`);
    none counts while `EagerCheck` runs its eager comparison."""

    def __init__(self):
        self.calls = {route: 0 for route in ANIM_ROUTES}

    def __enter__(self):
        from smelter_tpu_torch.ops import compose
        from smelter_tpu_torch.render.capture import each_run

        self._saved = {}
        for route, name in ANIM_ROUTES.items():
            orig = self._saved[name] = getattr(compose, name)

            def counted(static, *args, _orig=orig, _route=route, **kw):
                if static.content == "texture" and not EagerCheck.running:
                    each_run(lambda: self.calls.__setitem__(_route, self.calls[_route] + 1))
                return _orig(static, *args, **kw)

            setattr(compose, name, counted)
        return self

    def __exit__(self, *exc):
        from smelter_tpu_torch.ops import compose

        for name, orig in self._saved.items():
            setattr(compose, name, orig)
        return False


class EagerCheck:
    """While installed (a `with` block), every render of an `OutputProgram`
    is held bit for bit to the closure of its frame's structure run eagerly
    on the same frame's arguments, on the card (`prog._build(key,
    frames)` on `prog._args(plan)`). The eager run is out of every count: the kernels' launch
    counters are restored after it and their per-thread tally skips it
    (`tally_launches_by_thread`), `RouteCounter` pauses, and the sync
    debug mode is off during it. Records per render whether it replayed a
    captured graph, and every program captured (its structure key, capture
    ms and graph memory). With `first_replay_only`, only the first replay of
    each output program is compared (a soak's hot loop stays hot)."""

    running = False

    def __init__(self, label, first_replay_only=False):
        self.label = label
        self.first_replay_only = first_replay_only
        self.renders = []  # (program id, key, "replay" / "capture" / "frozen")
        self.programs = {}  # id(CapturedProgram) -> (capture ms, graph bytes)
        self.mismatches = []
        self.compared = 0

    def __enter__(self):
        import gc

        import torch

        from smelter_tpu_torch.render.program import OutputProgram

        # the programs of earlier phases live in reference cycles: free them
        # and their graph pools, so that the phase reports its own memory
        gc.collect()
        torch.cuda.empty_cache()
        self._render = render = OutputProgram.render
        self._plan = plan = OutputProgram.plan

        def planned(prog, *args, **kw):
            key_plan = plan(prog, *args, **kw)
            # render looks the key up right after planning
            prog._smoke_plan = (key_plan, key_plan[0] in prog._build_cache)
            return key_plan

        def checked(prog, pts, input_frames, *args, **kw):
            out = render(prog, pts, input_frames, *args, **kw)
            (key, frame_plan), hit = prog._smoke_plan
            kind = "frozen" if out is None else "replay" if hit else "capture"
            self.renders.append((id(prog), key, kind))
            program = prog._build_cache.get(key)
            if program is not None:
                self.programs.setdefault(id(program), (program.capture_ms, program.graph_bytes))
            if out is not None and not (self.first_replay_only and (
                    kind != "replay" or getattr(prog, "_smoke_compared", False))):
                prog._smoke_compared = True
                self.compared += 1
                self._compare(prog, pts, input_frames, key, frame_plan, out)
            return out

        OutputProgram.plan, OutputProgram.render = planned, checked
        return self

    def _compare(self, prog, pts, input_frames, key, frame_plan, out):
        import torch

        from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
        from smelter_tpu_torch.render.capture import _map_tensors

        mods = (scene_assembly, sdf_layers, yuv_out)
        counts = [m.LAUNCHES for m in mods]
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        EagerCheck.running = True
        _untallied.on = True
        try:
            args = _map_tensors(prog._args(frame_plan), lambda t: t.to(prog.device))
            want = prog._build(key, input_frames)(*args)
            got, want = (out, want) if isinstance(out, tuple) else ((out,), (want,))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                self.mismatches.append((prog.out_format.name, pts))
        finally:
            # the mode is restored before `running` drops: a context that
            # turns the mode off waits for `running` (RenderLog.capture_syncs)
            torch.cuda.set_sync_debug_mode(mode)
            EagerCheck.running = False
            _untallied.on = False
            for m, c in zip(mods, counts):
                m.LAUNCHES = c

    def __exit__(self, *exc):
        from smelter_tpu_torch.render.program import OutputProgram

        OutputProgram.plan, OutputProgram.render = self._plan, self._render
        return False

    def report(self):
        """Checks every render against its eager run and returns (and
        prints) the phase's captures, distinct structure keys, capture ms
        and graph memory."""
        import torch

        kinds = [k for _, _, k in self.renders]
        ms = [t for t, _ in self.programs.values()]
        graph_mb = [b / 2**20 for _, b in self.programs.values()]
        out = dict(renders=len(kinds), replays=kinds.count("replay"),
                   captures=kinds.count("capture"), frozen=kinds.count("frozen"),
                   structure_keys=len({(pid, key) for pid, key, _ in self.renders}),
                   capture_ms_median=statistics.median(ms) if ms else None,
                   capture_ms_max=max(ms) if ms else None,
                   graph_mb_total=sum(graph_mb), graph_mb_max=max(graph_mb) if graph_mb else None,
                   reserved_mb=torch.cuda.memory_reserved() / 2**20,
                   eager_compared=self.compared, eager_mismatches=len(self.mismatches))
        print(f"captured programs, {self.label}: {json.dumps(out)}")
        check(not self.mismatches, f"{self.label}: replay differs from the eager closure on "
                                   f"(output, pts) {self.mismatches[:8]}")
        return out


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
                      scene=renderer_scene, n_frames=N_RENDER_FRAMES):
    """Render pts 0 (stage 0), update the scene to stage 1, render pts k/FPS
    for k = 1..n_frames. Returns the frames' planes, on `dev`;
    `on_frame(k, planes)` is called after each frame."""
    from smelter_tpu_torch.core.types import FrameSet

    r, first = start_transition(dev, n, in_w, in_h, out_w, out_h, frames, scene)
    outs = [first]
    if on_frame is not None:
        on_frame(0, first)
    for k in range(1, n_frames + 1):
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

    def capture(resolution, specs, params, spec_rows=None, out_dtype=torch.float32):
        # the run of the frame, not the capture of its graph (which runs
        # nothing on the card)
        if not torch.cuda.is_current_stream_capturing():
            k1_runs.append(("renderer frame table", resolution, specs, params.clone()))
        return launch(resolution, specs, params, spec_rows, out_dtype)

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
    with warnings.catch_warnings(record=True) as syncs, counter, \
            EagerCheck("animated textures") as eager:
        warnings.simplefilter("always")
        outs = render_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, frames,
                                 on_frame=record, scene=animated_scene)
    torch.cuda.set_sync_debug_mode("default")
    stats = eager.report()
    kinds = [kind for _, _, kind in eager.renders]
    print(f"animated textures: frames captured "
          f"{[k for k, c in enumerate(kinds) if c == 'capture']}, the rest replayed")
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
    check(not [k for k in every if kinds[k] == "replay" and sync_by_frame[k]],
          "animated textures: a replay frame synchronised")
    for k, planes in enumerate(outs):
        check_planes(f"animated textures frame {k}", interop.planes_to_host(planes),
                     OUT_W, OUT_H)
    del outs
    renderer_parity_vs_cpu(dev, 4, 256, 144, 768, 432, scene=animated_scene,
                           inputs=animated_inputs, label="animated textures")
    return launches, stats


def animated_timings(dev, frames, stamp):
    """Frame times of the animated-texture scene (CUDA events around
    render(), planning and uploads included), plan()'s host time on
    animating frames, and a torch.profiler breakdown of one animating frame
    (frame 15)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smelter_tpu_torch.core.types import FrameSet

    r, _ = start_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, frames, animated_scene)
    prog = r._programs["out"]
    frame_ms, captured, prof, prof_wall, prof_k = {}, set(), None, None, None
    for k in range(1, 2 * FPS + 1):
        fs = FrameSet(pts=k / FPS, frames=frames)
        n_programs = len(prog._build_cache)
        if k >= 15 and prof_k is None:
            # the first replay frame from 15 on, under the profiler
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                r.render(fs)
                torch.cuda.synchronize()
                prof_wall = (time.perf_counter() - t0) * 1e3
            if len(prog._build_cache) == n_programs:
                prof_k = k
            else:
                captured.add(k)
            continue
        frame_ms[k] = cuda_ms(lambda: r.render(fs), iters=1, warmup=0)
        if len(prog._build_cache) != n_programs:
            captured.add(k)
    anim = [frame_ms[k] for k in range(3, FPS + 1) if k in frame_ms and k not in captured]
    stable = [frame_ms[k] for k in range(FPS + 3, 2 * FPS + 1) if k not in captured]
    capture_frames = [frame_ms[k] for k in sorted(captured) if k in frame_ms]
    t_anim, t_stable = statistics.median(anim), statistics.median(stable)
    print(f"time animated textures frame 16x1080p->4K, animating replays ({len(anim)} frames): "
          f"median {t_anim:.4f} ms, max {max(anim):.4f} ms {stamp}")
    print(f"time animated textures frame 16x1080p->4K, stable replays ({len(stable)} frames): "
          f"median {t_stable:.4f} ms, max {max(stable):.4f} ms {stamp}")
    print(f"time animated textures frames that captured a structure "
          f"{sorted(captured)}: {[round(t, 4) for t in capture_frames]} ms {stamp}")
    # the device's own events (kernels, copies, fills): the rows of the
    # aten ops that launched them carry the same time again
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    frame_device_ms = sum(e.device_time_total for e in rows) / 1e3
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    print(f"profile animated textures frame {prof_k} (16x1080p->4K, a replay): device "
          f"{frame_device_ms:.4f} ms in "
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
                launches=n_launch, profiled_frame=prof_k, busy=frame_device_ms / prof_wall,
                capture_frames=sorted(captured), capture_frame_ms=capture_frames)


class Delivered:
    """Counts the frames a sink has delivered. `barrier(n)` is a queue event
    that waits for the n-th: scheduled at the pts of a scene update or an
    unregister, just before it, it holds the queue until the renderer thread
    has caught up, so that the update lands between the same two renders in
    every run (the renderer thread may otherwise be up to two frames behind
    the queue when the queue runs the event)."""

    def __init__(self):
        self.count = 0
        self.times = []  # (perf_counter at delivery, frame pts)
        self.cond = threading.Condition()

    def add(self, pts):
        with self.cond:
            self.count += 1
            self.times.append((time.perf_counter(), pts))
            self.cond.notify_all()

    def barrier(self, n):
        def wait():
            with self.cond:
                self.cond.wait_for(lambda: self.count >= n, timeout=120)

        return wait


# (kernel module, thread ident) -> the launches counted on that thread
_THREAD_LAUNCHES = {}
_untallied = threading.local()  # .on: this thread's launches are not tallied


def tally_launches_by_thread():
    """Wraps the count function of the K1, K2 and K3 wrappers (once), so that
    every launch a wrapper counts in its `LAUNCHES` is also tallied for the
    thread that counts it: a replay on the thread that replays the graph, a
    capture's warm-up on the thread that captures. A render's own launches
    are then told apart from those of a structure captured on a background
    thread while it runs."""
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out

    for mod in (scene_assembly, yuv_out, sdf_layers):
        if getattr(mod._count, "tallied", False):
            continue

        def count(_orig=mod._count, _name=mod.__name__):
            _orig()
            if not getattr(_untallied, "on", False):
                key = (_name, threading.get_ident())
                _THREAD_LAUNCHES[key] = _THREAD_LAUNCHES.get(key, 0) + 1

        count.tallied = True
        mod._count = count


def thread_launches():
    """(K1, K2, K3) launches tallied on the calling thread so far."""
    me = threading.get_ident()
    return tuple(_THREAD_LAUNCHES.get((f"smelter_tpu_torch.ops.hopper.{m}", me), 0)
                 for m in ("scene_assembly", "yuv_out", "sdf_layers"))


class RenderLog:
    """Wraps the renderer of a pipeline before anything is registered: logs
    every call the pipeline makes on it (to replay them on a fresh renderer
    afterwards) and, per render, the kernel launches made on the renderer's
    thread (`thread_launches`: not the warm-ups of structures captured on
    background threads meanwhile), whether the frame built a new structure,
    how many outputs it rendered, and the synchronising calls that
    `torch.cuda.set_sync_debug_mode("warn")` flags on the renderer thread
    while `capture_syncs()` is on. With `keep_calls` off (a long live run)
    it keeps no call for `replay`."""

    def __init__(self, renderer, keep_calls=True):
        self.calls, self.frames, self.syncs = [], [], []
        self.keep_calls = keep_calls
        self._frame = None
        self.threads = set()  # the idents of the threads that rendered
        tally_launches_by_thread()
        for name in ("register_input", "unregister_input", "update_scene"):
            def logged(*args, _orig=getattr(renderer, name), _name=name):
                if self.keep_calls:
                    self.calls.append((_name, args))
                return _orig(*args)

            setattr(renderer, name, logged)
        render = renderer.render

        def logged_render(frame_set):
            if self.keep_calls:
                self.calls.append(("render", (frame_set,)))
            self._frame = len(self.frames)
            t = time.perf_counter()
            progs = list(renderer._programs.values())
            before = [len(p._build_cache) for p in progs]
            last = dict(renderer._last_outputs)
            self.threads.add(threading.get_ident())
            counts = thread_launches()
            out = render(frame_set)
            after = thread_launches()
            self.frames.append(dict(
                pts=frame_set.pts, built=any(len(p._build_cache) > b for p, b in zip(progs, before)),
                k1=after[0] - counts[0], k2=after[1] - counts[1], k3=after[2] - counts[2],
                outputs=len(out.frames), t=t,
                # an output whose structure is captured in the background
                # re-emits its last frame (async_compile)
                frozen=any(o in last and f.data is last[o].data for o, f in out.frames.items())))
            return out

        renderer.render = logged_render

    def _showwarning(self, message, *_args, **_kw):
        if "synchroniz" in str(message):
            self.syncs.append((threading.current_thread().name, self._frame))

    @contextlib.contextmanager
    def capture_syncs(self):
        """A context in which synchronising calls are recorded, by thread and
        by the index of the frame the renderer was rendering."""
        import torch

        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = self._showwarning
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
                # an eager check still running on the renderer thread
                # restores the mode it found ("warn") when it ends: wait for
                # it, so that the mode stays off after the context (left on,
                # a later phase's threads warn from inside CUDA calls)
                while EagerCheck.running:
                    time.sleep(0.001)
                torch.cuda.set_sync_debug_mode("default")

    def replay(self, dev):
        """The logged calls on a fresh renderer on `dev`: each rendered
        output frame's planes, on the host."""
        from smelter_tpu_torch import interop
        from smelter_tpu_torch.render.renderer import Renderer, RendererOptions

        r = Renderer(RendererOptions(stream_fallback_timeout=0.5), device=dev)
        outs = []
        for name, args in self.calls:
            result = getattr(r, name)(*args)
            if name == "render":
                outs.append(interop.planes_to_host(result.frames["out"].data))
        return outs


def _feed_video(src, frames, n_frames, pace=None):
    """Push `n_frames` of one input (cycling over `frames`, its (y, u, v)
    pools) at pts k / FPS (less a microsecond), then close the channel; with `pace` (a start
    time on perf_counter), frame k is sent at start + k / FPS. Returns
    {id of a frame's plane tuple: (its send time, the tuple)}: the tuples
    are kept so that no id is reused."""
    from smelter_tpu_torch.core.types import Frame, PixelFormat, Resolution
    from smelter_tpu_torch.utils.channels import Closed

    y, u, v = frames
    sent = {}
    res = Resolution(y.shape[2], y.shape[1])
    # a microsecond before k / FPS: the queue maps an output pts to input
    # time as (pts + start) - start, which rounds below k / FPS for some
    # start times and would then take frame k - 1; this frame is taken
    # either way
    pts = [max(k / FPS - 1e-6, 0.0) for k in range(n_frames)]
    try:
        for k in range(n_frames):
            if pace is not None:
                time.sleep(max(0.0, pace + k / FPS - time.perf_counter()))
            data = (y[k % len(y)], u[k % len(u)], v[k % len(v)])
            sent[id(data)] = (time.perf_counter(), data)
            src.video.send(Frame(data=data, format=PixelFormat.PLANAR_YUV420,
                                 resolution=res, pts=pts[k]))
    except Closed:  # the input was unregistered
        return sent
    src.video.close()
    return sent


def _feed_tone(src, seconds, hz=440.0):
    """A stereo 48 kHz tone in 20 ms chunks, then close the channel (or stop
    where it was closed: the queue may leave the last chunks unread)."""
    import numpy as np

    from smelter_tpu_torch.core.types import AudioSamples
    from smelter_tpu_torch.utils.channels import Closed

    try:
        for chunk in range(int(seconds * 50)):
            n = np.arange(chunk * 960, (chunk + 1) * 960)
            tone = 0.3 * np.sin(2 * np.pi * hz * n / 48000.0)
            src.audio.send(AudioSamples(np.stack([tone, tone], 1), chunk * 960 / 48000))
    except Closed:
        return
    src.audio.close()


def _drain(channel, into, on_item=None):
    from smelter_tpu_torch.utils.channels import Closed

    while True:
        try:
            item = channel.recv(timeout=120)
        except (Closed, TimeoutError):
            return
        into.append(item)
        if on_item is not None:
            on_item(item)


def _threads(targets):
    ts = [threading.Thread(target=fn, args=args, daemon=True) for fn, args in targets]
    for t in ts:
        t.start()
    return ts


def pipeline_offline(dev, n, in_w, in_h, out_w, out_h, seed=7, capture_syncs=False):
    """Phase 8a: the port's Pipeline offline (ahead-of-time, never-drop) on
    `dev`: n raw YUV420 inputs of 2 s at 30 fps (input 0 with a stereo
    tone), raw video and audio out at out_w x out_h into a
    RawDataOutputSink; the video ends with all inputs, the audio with input
    0's. The scene:
    `renderer_scene` stage 0, updated (scheduled) to stage 1 at 0.1 s
    (the overlays move: K3), to `animated_scene` stage 0 at 0.5 s and
    stage 1 at 1.0 s (the texture routes animate), and the last input
    unregistered at 1.5 s. Returns the delivered frames, audio and events
    and the renderer's log (with the synchronising calls flagged during the
    run when `capture_syncs`)."""
    from smelter_tpu_torch.audio.mixer import AudioMixerConfig, AudioMixerInputConfig
    from smelter_tpu_torch.core.types import Framerate, Resolution
    from smelter_tpu_torch.pipeline import (
        AudioEncoderOptions, EndCondition, OutputAudioOptions, OutputVideoOptions, Pipeline,
        PipelineOptions, RawDataOutputSink, RegisterInputOptions, VideoEncoderOptions)
    from smelter_tpu_torch.pipeline.input import RawDataInput

    p = Pipeline(PipelineOptions(output_framerate=Framerate(FPS), ahead_of_time_processing=True,
                                 never_drop_output_frames=True), device=dev)
    log = RenderLog(p.renderer)
    sources = {}
    for i in range(n):
        sources[f"input_{i}"] = RawDataInput(has_video=True, has_audio=i == 0)
        p.register_input(f"input_{i}", sources[f"input_{i}"],
                         RegisterInputOptions(required=True, offset=0.0))
    sink = RawDataOutputSink()
    p.register_output(
        "out", sink,
        video=OutputVideoOptions(resolution=Resolution(out_w, out_h),
                                 encoder=VideoEncoderOptions(codec="raw"),
                                 initial_root=renderer_scene(out_w, out_h, n, 0),
                                 end_condition=EndCondition(all_inputs=True)),
        audio=OutputAudioOptions(encoder=AudioEncoderOptions(codec="raw"),
                                 initial_mixer_config=AudioMixerConfig(
                                     inputs=[AudioMixerInputConfig("input_0")]),
                                 # the inputs without audio never end an
                                 # audio track
                                 end_condition=EndCondition(any_of=("input_0",))))
    delivered = Delivered()
    for at, root in ((0.1, renderer_scene(out_w, out_h, n, 1)),
                     (0.5, animated_scene(out_w, out_h, n, 0)),
                     (1.0, animated_scene(out_w, out_h, n, 1))):
        p.queue.schedule_event(at, delivered.barrier(round(at * FPS) + 1))
        p.update_output("out", root=root, schedule_time=at)
    p.queue.schedule_event(1.5, delivered.barrier(round(1.5 * FPS) + 1))
    p.unregister_input(f"input_{n - 1}", schedule_time=1.5)
    y, u, v = host_frames(2 * n, in_w, in_h, seed)
    video, audio = [], []
    with log.capture_syncs() if capture_syncs else contextlib.nullcontext():
        p.start()
        feeders = _threads([(_feed_video, (src, (y[2 * i:2 * i + 2], u[2 * i:2 * i + 2],
                                                 v[2 * i:2 * i + 2]), 2 * FPS))
                            for i, src in enumerate(sources.values())]
                           + [(_feed_tone, (sources["input_0"], 2.0))])
        drains = _threads([(_drain, (sink.audio, audio))])
        _drain(sink.video, video, lambda f: delivered.add(f.pts))
        for t in drains:
            t.join(timeout=60)
        p.wait_for_outputs_done(timeout=60)
    # the unregistered input's feeder, and input 0's tone past the last
    # frame, wait on channels nobody reads any more
    for src in sources.values():
        src.video.close()
        if src.audio is not None:
            src.audio.close()
    for t in feeders:
        t.join(timeout=10)
    p.close()
    check(not any(t.is_alive() for t in feeders + drains), "pipeline: a feeder or drain hung")
    return dict(frames=video, audio=audio, log=log,
                events=[(e.kind, e.entity_id) for e in p.events.history()])


def pipeline_phase(dev):
    """Phase 8a's checks: at 16 x 1080p -> 4K on the card, 60 +- 1 frames of
    host u8 planes, OUTPUT_DONE and no OUTPUT_ERROR, K1 and K2 on every
    frame (K3 on the frames whose overlays animate), every frame equal (max
    abs err 0) to the port's Renderer on the card driven directly with the
    same calls (compared after the run), no synchronising call flagged on
    the renderer thread on a frame that built no new structure; then the
    same run at 4 x 256x144 -> 768x432 on the card against the port's
    Pipeline on the CPU at parity_vs_cpu's tolerance. Returns the kernel
    launches of the 4K run and its numbers."""
    import numpy as np

    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out

    scene_assembly.LAUNCHES = yuv_out.LAUNCHES = sdf_layers.LAUNCHES = 0
    t0 = time.perf_counter()
    with EagerCheck("pipeline offline") as eager:
        run = pipeline_offline(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, capture_syncs=True)
    wall = time.perf_counter() - t0
    stats = eager.report()
    launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                "sdf_layers": sdf_layers.LAUNCHES}
    frames, log = run["frames"], run["log"]
    errors = [e for e in run["events"] if e[0] == "OUTPUT_ERROR"]
    print(f"pipeline offline 16x1080p->4K: {len(frames)} frames, {len(run['audio'])} audio "
          f"chunks in {wall:.1f} s; launches {launches}; events {run['events']}")
    check(not errors, f"pipeline: {errors}")
    check(("OUTPUT_DONE", "out") in run["events"], "pipeline: no OUTPUT_DONE")
    check(abs(len(frames) - 2 * FPS) <= 1, f"pipeline: {len(frames)} frames, not 60 +- 1")
    for k, f in enumerate(frames):
        check(all(isinstance(p, np.ndarray) for p in f.data), f"pipeline frame {k}: not host")
        check_planes(f"pipeline frame {k}", f.data, OUT_W, OUT_H)
    check(all(np.isfinite(np.asarray(s)).all() and np.abs(np.asarray(s)).max() > 0
              for s, _ in run["audio"][10:50]), "pipeline: no mixed tone")
    per = log.frames
    check(all(f["k1"] == 1 and f["k2"] == 1 for f in per),
          f"pipeline: K1/K2 not once per frame: {[(f['k1'], f['k2']) for f in per]}")
    k3_frames = [k for k, f in enumerate(per) if f["k3"]]
    print(f"pipeline: K3 on frames {k3_frames}; new structures on frames "
          f"{[k for k, f in enumerate(per) if f['built']]}")
    check(k3_frames, "pipeline: K3 never ran (the overlays' transition)")
    on_renderer = [k for name, k in log.syncs if name == "renderer"]
    stable = [k for k in on_renderer if k is not None and not per[k]["built"]]
    print(f"pipeline: synchronising calls flagged: {len(log.syncs)}, on the renderer thread "
          f"by frame {on_renderer}, on frames that built no structure {len(stable)}")
    check(not stable, f"pipeline: the renderer thread synchronised on stable frames {stable}")
    # the renderer may render a frame past the output's end, which the
    # output drops: frames are matched by pts
    t0 = time.perf_counter()
    replayed = dict(zip((f["pts"] for f in per), log.replay(dev)))
    check(all(f.pts in replayed for f in frames), "pipeline: a delivered frame was not rendered")
    mx = max(lsb_stats(replayed[f.pts], f.data)[0] for f in frames)
    print(f"pipeline vs the renderer driven directly on the card, {len(frames)} frames of "
          f"{len(replayed)} renders: max abs err {mx} ({time.perf_counter() - t0:.1f} s)")
    check(mx == 0, f"pipeline vs renderer: max abs err {mx}")
    del replayed

    # the same run at a CPU size, on the CPU and on the card
    small = (4, 256, 144, 768, 432)
    t0 = time.perf_counter()
    ref = pipeline_offline("cpu", *small)
    t1 = time.perf_counter()
    got = pipeline_offline(dev, *small)
    print(f"pipeline at 4x256x144 -> 768x432: {t1 - t0:.1f} s on the CPU, "
          f"{time.perf_counter() - t1:.1f} s on the card")
    check(len(ref["frames"]) == len(got["frames"]), "pipeline card vs CPU: frame counts")
    check([f.pts - ref["frames"][0].pts for f in ref["frames"]]
          == [f.pts - got["frames"][0].pts for f in got["frames"]], "pipeline card vs CPU: pts")
    mx, n_diff, n_gt1, total, off = 0, 0, 0, 0, []
    for k, (a, b) in enumerate(zip(ref["frames"], got["frames"])):
        m, d, g, t = lsb_stats(a.data, b.data)
        mx, n_diff, n_gt1, total = max(mx, m), n_diff + d, n_gt1 + g, total + t
        off += [(k, m)] if m > 1 else []
    print(f"parity card vs CPU pipeline 4x256x144 -> 768x432, {len(ref['frames'])} frames: "
          f"max {mx} LSB, {n_diff} of {total} pixels differ, {n_gt1} by 2+")
    check(mx <= 2 and n_gt1 * 10000 < total,
          f"pipeline: card vs CPU off ({mx} LSB; (frame, LSB) over 1: {off})")
    return launches, dict(offline_frames=len(frames), offline_wall_s=wall,
                          k3_frames=len(k3_frames), renderer_thread_syncs=len(on_renderer),
                          stable_frame_syncs=len(stable), captured_programs=stats)


def pipeline_live(dev, n, out_w, out_h, stamp, seconds=5.0):
    """Phase 8b: the port's Pipeline in real time (no ahead-of-time
    processing, frames may drop) on `dev`: n raw 1080p inputs fed by one
    thread each at 30 fps for `seconds`, `renderer_scene` stage 0 at
    out_w x out_h into a RawDataOutputSink. Returns the delivered frame
    rate, the dropped frames, the latency from a frame's send to its
    delivery (input 0's frame in each output frame), the render, fetch-host
    and plan spans, the host enqueue time of render() (`compose_latency`,
    /stats), the card's busy share over the window's last second
    (torch.profiler device time over wall time), and the seconds of set-up,
    trace processing and teardown around the window."""
    import concurrent.futures

    import torch
    from torch.profiler import ProfilerActivity, profile

    from smelter_tpu_torch.core.types import Framerate, Resolution
    from smelter_tpu_torch.pipeline import (
        EndCondition, OutputVideoOptions, Pipeline, PipelineOptions, RawDataOutputSink,
        RegisterInputOptions, VideoEncoderOptions)
    from smelter_tpu_torch.pipeline.input import RawDataInput
    from smelter_tpu_torch.utils import tracing

    t_run = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        # the process's first profiler start initialises CUPTI for seconds,
        # holding the interpreter: pay it before the window opens
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    p = Pipeline(PipelineOptions(output_framerate=Framerate(FPS)), device=dev)
    sources = {}
    for i in range(n):
        sources[f"input_{i}"] = RawDataInput(has_video=True, has_audio=False)
        p.register_input(f"input_{i}", sources[f"input_{i}"], RegisterInputOptions())
    sink = RawDataOutputSink(video_capacity=10 * FPS)
    p.register_output("out", sink, video=OutputVideoOptions(
        resolution=Resolution(out_w, out_h), encoder=VideoEncoderOptions(codec="raw"),
        initial_root=renderer_scene(out_w, out_h, n, 0),
        end_condition=EndCondition(all_inputs=True)))
    used = {}  # output pts -> id of input 0's plane tuple in that frame
    render = p.renderer.render

    def logged_render(frame_set):
        f0 = frame_set.frames.get("input_0")
        if f0 is not None:
            used[frame_set.pts] = id(f0.data)
        return render(frame_set)

    p.renderer.render = logged_render
    y, u, v = host_frames(2 * n, IN_W, IN_H, seed=9)
    delivered, video = Delivered(), []
    p.start()
    drains = _threads([(_drain, (sink.video, video, lambda f: delivered.add(f.pts)))])
    sent = {}
    t_setup = time.perf_counter() - t_run
    # the window opens when the feeders start: the queue has ticked without
    # inputs since start()
    tracing.reset()
    dropped0 = p.stats.video_frames_dropped
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(n) as pool:
        futs = [pool.submit(_feed_video, src, (y[2 * i:2 * i + 2], u[2 * i:2 * i + 2],
                                               v[2 * i:2 * i + 2]), int(seconds * FPS), t0)
                for i, src in enumerate(sources.values())]
        # the card's busy share over the window's last second: a trace of
        # the whole window took longer to process than the window itself
        time.sleep(max(0.0, t0 + seconds - 1.0 - time.perf_counter()))
        prof = profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
        prof.start()
        t_prof = time.perf_counter()
        for fut in futs:
            sent.update(fut.result())
    if on_card:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    window, prof_span = t_end - t0, t_end - t_prof
    p.wait_for_outputs_done(timeout=60)
    for t in drains:
        t.join(timeout=60)
    dropped = p.stats.video_frames_dropped - dropped0
    compose = p.stats.render_latency.percentiles()
    spans = tracing.report()
    events = [(e.kind, e.entity_id) for e in p.events.history()]
    p.close()
    t_teardown = time.perf_counter() - t_end
    # the profiler stops once no thread of the pipeline launches anything
    # (`profile_busy`)
    prof.stop()
    busy = profile_busy(prof, prof_span) if on_card else None
    t_trace = time.perf_counter() - t_end - t_teardown
    check(not [e for e in events if e[0] == "OUTPUT_ERROR"], f"pipeline live: {events}")
    lat = sorted((t - sent[used[pts]][0]) * 1e3 for t, pts in delivered.times
                 if pts in used and used[pts] in sent)
    in_window = [t for t, _ in delivered.times if 0 <= t - t0 <= window]
    fps = (len(in_window) - 1) / (in_window[-1] - in_window[0]) if len(in_window) > 1 else 0.0

    def span(name):
        s = spans.get(name, {})
        return {k: s.get(k) for k in ("count", "p50_ms", "p95_ms", "avg_ms")}

    # video_frames_dropped counts, as the reference's does, every queue
    # batch sent past its deadline, the audio mixer's included; the video
    # frames the window should have had and the sink did not get:
    missed = round(window * FPS) - len(in_window)
    out = dict(inputs=n, out=f"{out_w}x{out_h}", window_s=window,
               frames_delivered=len(in_window), video_frames_missed=missed,
               fps_delivered=fps, video_frames_dropped=dropped,
               latency_p50_ms=statistics.median(lat) if lat else None,
               latency_p95_ms=lat[int(0.95 * (len(lat) - 1))] if lat else None,
               render=span("render.frame"), fetch_host=span("render.fetch_host"),
               plan=span("render.plan"), compose_latency=compose, device_busy=busy,
               busy_window_s=prof_span, run_s=time.perf_counter() - t_run,
               setup_s=t_setup, trace_s=t_trace, teardown_s=t_teardown, card=stamp)
    print(f"pipeline live {n}x1080p->{out_w}x{out_h} at {FPS} fps for {seconds} s: "
          f"{json.dumps(out)}")
    check(len(video) > 0, "pipeline live: no frame delivered")
    return out


GREEN_Y = 173  # BT.709 limited-range luma of RGB (0, 255, 0)


def marked_scene(out_w, out_h, n_inputs):
    """A scene of its own structure, with no component id in common with
    `renderer_scene` (no transition): the Tiles grid of the inputs under an
    opaque green bar across the top 64 rows (of a 3840-wide output, scaled).
    A frame shows this scene when the bar's luma is green's."""
    from smelter_tpu_torch.core.types import RGBAColor
    from smelter_tpu_torch.scene import components as comp

    s = out_w / 3840.0
    tiles = comp.Tiles(
        children=[comp.Rescaler(child=comp.InputStream(input_id=f"input_{i}"))
                  for i in range(n_inputs)],
        background_color=RGBAColor(16, 16, 16), margin=8.0 * s)
    bar = comp.View(position=comp.AbsolutePosition(width=float(out_w), height=64 * s, top=0.0,
                                                   left=0.0),
                    background_color=RGBAColor(0, 255, 0))
    return comp.View(background_color=RGBAColor(0, 0, 0), children=[tiles, bar])


def pipeline_async(dev, n, out_w, out_h, stamp, seconds=4.0, update_at=1.5):
    """Phase 11: the live pipeline's background capture. The port's
    Pipeline in real time (so `RendererOptions.async_compile`), n raw 1080p
    inputs fed at 30 fps for `seconds`, `renderer_scene` stage 0 at
    out_w x out_h; at `update_at` s the scene is replaced, at once, by
    `marked_scene`. Checks: no OUTPUT_ERROR; every delivered frame has the
    output's YUV420 planes; the renders after the update freeze (the
    renderer hands back the last frame's own planes, with the new pts) until
    the new structure's graph lands, and every later render shows the new
    scene; at the sink each frozen frame equals the last frame rendered
    before the update, bit for bit, and the first new one shows the green
    bar. Returns the frozen frames, the time from the update to the first
    new frame's delivery, and the capture's numbers."""
    import numpy as np

    from smelter_tpu_torch.core.types import Framerate, Resolution
    from smelter_tpu_torch.pipeline import (
        EndCondition, OutputVideoOptions, Pipeline, PipelineOptions, RawDataOutputSink,
        RegisterInputOptions, VideoEncoderOptions)
    from smelter_tpu_torch.pipeline.input import RawDataInput

    t_run = time.perf_counter()
    p = Pipeline(PipelineOptions(output_framerate=Framerate(FPS)), device=dev)
    check(p.renderer.options.async_compile, "a live pipeline must capture in the background")
    sources = {}
    for i in range(n):
        sources[f"input_{i}"] = RawDataInput(has_video=True, has_audio=False)
        p.register_input(f"input_{i}", sources[f"input_{i}"], RegisterInputOptions())
    sink = RawDataOutputSink(video_capacity=10 * FPS)
    p.register_output("out", sink, video=OutputVideoOptions(
        resolution=Resolution(out_w, out_h), encoder=VideoEncoderOptions(codec="raw"),
        initial_root=renderer_scene(out_w, out_h, n, 0),
        end_condition=EndCondition(all_inputs=True)))
    renders = []  # (pts, frozen, perf_counter when the render began)
    update = {}
    render = p.renderer.render

    def logged_render(frame_set):
        t = time.perf_counter()
        prev = p.renderer._last_outputs.get("out")
        out = render(frame_set)
        frame = out.frames.get("out")
        if frame is not None:
            renders.append((frame.pts, prev is not None and frame.data is prev.data, t))
        return out

    p.renderer.render = logged_render
    y, u, v = host_frames(2 * n, IN_W, IN_H, seed=10)
    delivered, video = Delivered(), []
    p.start()
    drains = _threads([(_drain, (sink.video, video, lambda f: delivered.add(f.pts)))])
    t0 = time.perf_counter()
    feeders = _threads([(_feed_video, (src, (y[2 * i:2 * i + 2], u[2 * i:2 * i + 2],
                                             v[2 * i:2 * i + 2]), int(seconds * FPS), t0))
                        for i, src in enumerate(sources.values())])
    time.sleep(max(0.0, t0 + update_at - time.perf_counter()))
    update["t"] = time.perf_counter()
    p.update_output("out", root=marked_scene(out_w, out_h, n))
    # the renderer's lock: a render that began before this renders the old scene
    update["done"] = time.perf_counter()
    for t in feeders:
        t.join(timeout=60)
    p.wait_for_outputs_done(timeout=60)
    for t in drains:
        t.join(timeout=60)
    prog = p.renderer._programs.get("out")
    programs = list(prog._build_cache.values()) if prog is not None else []
    events = [(e.kind, e.entity_id) for e in p.events.history()]
    p.close()
    check(not [e for e in events if e[0] == "OUTPUT_ERROR"], f"pipeline async: {events}")
    shapes = [(out_h, out_w), (out_h // 2, out_w // 2), (out_h // 2, out_w // 2)]
    check(video and all([tuple(pl.shape) for pl in f.data] == shapes
                        and all(pl.dtype == np.uint8 for pl in f.data) for f in video),
          "pipeline async: a frame of another resolution or format")
    after = [(pts, frozen) for pts, frozen, t in renders if t > update["done"]]
    frozen_pts = [pts for pts, frozen in after if frozen]
    new_pts = [pts for pts, frozen in after if not frozen]
    print(f"pipeline async {n}x1080p->{out_w}x{out_h}: {len(renders)} renders, "
          f"{len(after)} after the update: frozen pts {frozen_pts[:3]}..{frozen_pts[-3:]} "
          f"({len(frozen_pts)}), then {len(new_pts)} new")
    check(frozen_pts and new_pts, "pipeline async: the update neither froze nor landed")
    check(max(frozen_pts) < min(new_pts),
          "pipeline async: a frame froze after the new structure had landed")
    by_pts = {f.pts: f for f in video}
    before = [pts for pts, frozen, t in renders if t < update["t"] and not frozen]
    bar = int(64 * out_w / 3840.0) - 1  # rows inside the bar, its soft edge left out

    def shows_bar(f):
        return int(np.abs(f.data[0][:bar].astype(np.int32) - GREEN_Y).max()) <= 1

    last_old = by_pts.get(before[-1]) if before else None
    frozen_seen = [by_pts[pts] for pts in frozen_pts if pts in by_pts]
    check(last_old is not None and frozen_seen, "pipeline async: frozen frames not delivered")
    check(all(all(np.array_equal(a, b) for a, b in zip(f.data, last_old.data))
              for f in frozen_seen),
          "pipeline async: a frozen frame is not the last frame before the update")
    new_seen = [by_pts[pts] for pts in new_pts if pts in by_pts]
    check(new_seen and all(shows_bar(f) for f in new_seen) and not shows_bar(last_old),
          "pipeline async: the new scene does not show")
    t_first = min(t for t, pts in delivered.times if pts == new_seen[0].pts)
    out = dict(inputs=n, out=f"{out_w}x{out_h}", frozen_renders=len(frozen_pts),
               frozen_delivered=len(frozen_seen), new_delivered=len(new_seen),
               update_to_first_new_frame_ms=(t_first - update["t"]) * 1e3,
               captures_of_the_new_scene=len(programs),
               capture_ms=[pr.capture_ms for pr in programs],
               graph_mb=[pr.graph_bytes / 2**20 for pr in programs],
               run_s=time.perf_counter() - t_run, card=stamp)
    print(f"pipeline async: {json.dumps(out)}")
    return out


# the nodes phase (10): shaders in the JAX syntax of the wire contract, run
# by the port's torch-backed jnp: the docs' `pulse`, the `gradient` of
# tests/test_snapshots.py and the `circle_layout` of
# tests/test_snapshots_round5b.py
PULSE = (
    "def main(inputs, params, resolution, time):\n"
    "    # grayscale with a slow pulse back to color\n"
    "    tex = inputs[0]\n"
    "    rgb = tex[..., :3]\n"
    "    luma = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]\n"
    "            + 0.0722 * rgb[..., 2])[..., None]\n"
    "    mix = 0.5 + 0.5 * jnp.sin(time * 2.0)\n"
    "    out = rgb * mix + luma * (1.0 - mix)\n"
    "    return jnp.concatenate([out, tex[..., 3:4]], axis=-1)\n")
GRADIENT = (
    "def main(inputs, params, resolution, time):\n"
    "    w, h = resolution[0], resolution[1]\n"
    "    gain = params['gain'] if params else 1.0\n"
    "    x = jnp.linspace(0.0, gain, w)\n"
    "    y = jnp.linspace(0.0, 1.0, h)\n"
    "    g = jnp.outer(y, x)\n"
    "    rgba = jnp.stack([g, g * 0.5, 1.0 - g, jnp.ones_like(g)], axis=-1)\n"
    "    return rgba.astype(jnp.float32)\n")
CIRCLE = (
    "def main(inputs, params, resolution, time):\n"
    "    w, h = resolution[0], resolution[1]\n"
    "    canvas = jnp.zeros((h, w, 4), jnp.float32)\n"
    "    cx, cy = params['center']['x'], params['center']['y']\n"
    "    radius = params['radius']\n"
    "    for i, ang in enumerate(params['angles_deg']):\n"
    "        tile = inputs[i][::2, ::2]\n"
    "        th, tw = tile.shape[0], tile.shape[1]\n"
    "        a = ang * math.pi / 180.0\n"
    "        x = jnp.round(cx + radius * jnp.cos(a) - tw / 2)\n"
    "        y = jnp.round(cy + radius * jnp.sin(a) - th / 2)\n"
    "        canvas = lax.dynamic_update_slice(\n"
    "            canvas, tile,\n"
    "            (y.astype(jnp.int32), x.astype(jnp.int32),\n"
    "             jnp.zeros((), jnp.int32)))\n"
    "    return canvas\n")
NODE_OUTPUTS = ("PLANAR_YUV420", "NV12", "PLANAR_YUV444")


def nodes_scene(out_w, out_h, n_inputs, stage):
    """The nodes phase's scene: an opaque root View over a Tiles grid of the
    inputs, and on top of it a 1280x720 `pulse` shader of input 0, a
    1280x720 `gradient` shader of no input, a 1280x720 `circle_layout`
    shader of inputs 1-4, the 3-frame animated image "logo" at its natural
    size, a 960x540 WebView of input 5 with no browser behind it
    (transparent), and a bordered, shadowed lower-third banner that slides
    right in a one-second transition (stage 0 -> 1; K3). Sizes are those of
    a 3840-wide output, scaled to `out_w`; the banner stays inside the
    canvas, so it carries no mask."""
    from smelter_tpu_torch.core.types import RGBAColor
    from smelter_tpu_torch.scene import components as comp
    from smelter_tpu_torch.scene.layout_types import BorderRadius, BoxShadow

    s = out_w / 3840.0

    def at(top, left, w, h, child):
        return comp.View(position=comp.AbsolutePosition(
            width=w * s, height=h * s, top=top * s, left=left * s), children=[child])

    def shader(shader_id, inputs, param=None):
        return comp.Shader(
            shader_id=shader_id, shader_param=param, width=float(round(1280 * s)),
            height=float(round(720 * s)),
            children=[comp.InputStream(input_id=f"input_{i % n_inputs}") for i in inputs])

    circle = {"center": {"x": 640.0 * s, "y": 360.0 * s}, "radius": 200.0 * s,
              "angles_deg": [0.0, 90.0, 180.0, 270.0]}
    bw, bh = 2400 * s, 240 * s
    banner = comp.View(
        id="banner",
        position=comp.AbsolutePosition(width=bw, height=bh, top=out_h - bh - 120 * s,
                                       left=(160 if stage == 0 else 1200) * s),
        background_color=RGBAColor(20, 90, 200, 230),
        border_radius=BorderRadius(24 * s, 24 * s, 24 * s, 24 * s),
        border_width=4 * s, border_color=RGBAColor(255, 255, 255, 255),
        box_shadow=[BoxShadow(offset_x=8 * s, offset_y=8 * s, blur_radius=30 * s,
                              color=RGBAColor(0, 0, 0, 160))],
        transition=comp.Transition(duration=1.0))
    tiles = comp.Tiles(
        children=[comp.Rescaler(child=comp.InputStream(input_id=f"input_{i}"))
                  for i in range(n_inputs)],
        background_color=RGBAColor(16, 16, 16), margin=8.0 * s)
    return comp.View(background_color=RGBAColor(0, 0, 0), children=[
        tiles,
        at(80, 80, 1280, 720, shader("pulse", [0])),
        at(80, 2480, 1280, 720, shader("gradient", [], {"gain": 1.0})),
        at(880, 80, 1280, 720, shader("circle_layout", [1, 2, 3, 4], circle)),
        at(880, 2480, 320, 320, comp.Image(image_id="logo")),
        at(880, 1440, 960, 540, comp.WebView(
            instance_id="page", children=[comp.InputStream(input_id=f"input_{5 % n_inputs}")])),
        banner,
    ])


def logo_asset(side, seed=11):
    """A 3-frame animated `ImageAsset` of side x side straight-alpha RGBA
    frames made in numpy (no decoding), 0.1 s a frame."""
    import numpy as np

    from smelter_tpu_torch.render.image import ImageAsset

    rng = np.random.RandomState(seed)
    frames = []
    for i in range(3):
        f = rng.randint(0, 256, (side, side, 4), dtype=np.uint8)
        f[..., 3] = np.where(np.add.outer(np.arange(side), np.arange(side)) % 7 == i, 0, 220)
        frames.append(f)
    return ImageAsset("animated", frames, [0.1, 0.1, 0.1], side, side)


def nodes_renderer(dev, out_w, out_h, n, frames, formats=NODE_OUTPUTS):
    """A renderer on `dev` with the three shaders, the logo and the web
    instance registered, one output per format of `formats` (named by the
    format) showing `nodes_scene` stage 0 rendered at pts 0, then stage 1."""
    from smelter_tpu_torch.core.types import FrameSet, PixelFormat, Resolution
    from smelter_tpu_torch.render.renderer import Renderer
    from smelter_tpu_torch.render.web import WebRendererSpec

    os.environ["SMELTER_WEB_RENDERER_BROWSER"] = "/nonexistent/browser"  # no sidecar
    os.environ.pop("SMELTER_WEB_RENDERER_CDP_URL", None)
    r = Renderer(device=dev)
    for iid in frames:
        r.register_input(iid)
    for shader_id, src in (("pulse", PULSE), ("gradient", GRADIENT), ("circle_layout", CIRCLE)):
        r.register_shader(shader_id, src)
    r.images.put("logo", logo_asset(max(int(round(320 * out_w / 3840.0)), 8)))
    s = out_w / 3840.0
    inst = r.web.register(WebRendererSpec(
        instance_id="page", url="about:blank",
        resolution=(int(round(960 * s)), int(round(540 * s)))))
    check(not inst.active, "nodes: a web renderer sidecar started")
    res = Resolution(out_w, out_h)
    for fmt in formats:
        r.update_scene(fmt, nodes_scene(out_w, out_h, n, 0), res, PixelFormat[fmt])
    first = r.render(FrameSet(pts=0.0, frames=frames)).frames
    for fmt in formats:
        r.update_scene(fmt, nodes_scene(out_w, out_h, n, 1), res, PixelFormat[fmt])
    return r, first


class ProgramLaunches:
    """Per output format, per render of an `OutputProgram` while installed
    (a `with` block): the K1, K2 and K3 launches it made."""

    def __init__(self):
        self.runs = {}

    def __enter__(self):
        from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
        from smelter_tpu_torch.render.program import OutputProgram

        self._orig = orig = OutputProgram.render

        def counted(prog, *args, **kw):
            before = (scene_assembly.LAUNCHES, yuv_out.LAUNCHES, sdf_layers.LAUNCHES)
            out = orig(prog, *args, **kw)
            after = (scene_assembly.LAUNCHES, yuv_out.LAUNCHES, sdf_layers.LAUNCHES)
            self.runs.setdefault(prog.out_format.name, []).append(
                tuple(a - b for a, b in zip(after, before)))
            return out

        OutputProgram.render = counted
        return self

    def __exit__(self, *exc):
        from smelter_tpu_torch.render.program import OutputProgram

        OutputProgram.render = self._orig
        return False


def render_nodes(dev, n, out_w, out_h, frames, ks, on_frame=None, formats=NODE_OUTPUTS):
    """`nodes_renderer`, then the frames at pts k / FPS for k in `ks` (after
    frame 0). Returns each frame's output frames by format, on `dev`;
    `on_frame(k, render)` renders frame k (`render()` returns its frames)."""
    from smelter_tpu_torch.core.types import FrameSet

    r, first = nodes_renderer(dev, out_w, out_h, n, frames, formats)
    outs = [first]
    for k in ks:
        def render(k=k):
            return r.render(FrameSet(pts=k / FPS, frames=frames)).frames

        outs.append(render() if on_frame is None else on_frame(k, render))
    r.close()
    return outs


def nodes_phase(dev, frames, stamp):
    """Phase 10: `nodes_scene` at 16 x 1080p -> 4K to PLANAR_YUV420, NV12
    and PLANAR_YUV444 outputs, 41 frames. Checks K1 on every frame of every
    output, K2 on every YUV420 and NV12 frame and never for YUV444, K3 on
    exactly the banner's moving frames 2-30, no synchronising call on frames
    2-40, NV12's UV plane equal to the YUV420 output's U and V interleaved on
    every frame, the planes of frames 0-2, 15, 30, 31 and 40, and the card
    within 1 LSB of the port on the CPU at 4 x 256x144 -> 768x432 on frames
    0-2, 15 and 31. Times the frames of each output alone (`cuda_ms`,
    animating frames 3-10, settled 33-35) and of the three together
    (animating 3-16, settled 33-35), frame 15 of the three under
    torch.profiler, and each shader alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smelter_tpu_torch import interop
    from smelter_tpu_torch.core.types import FrameSet
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out

    t_phase = time.perf_counter()
    ks = list(range(1, N_RENDER_FRAMES + 1))
    sync_after = []

    def counted_syncs(k, render):
        sync_after.append(len(syncs))  # after frame k - 1
        return render()

    scene_assembly.LAUNCHES = yuv_out.LAUNCHES = sdf_layers.LAUNCHES = 0
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs, ProgramLaunches() as counted, \
            EagerCheck("nodes") as eager:
        warnings.simplefilter("always")
        outs = render_nodes(dev, N_INPUTS, OUT_W, OUT_H, frames, ks, on_frame=counted_syncs)
        sync_after.append(len(syncs))
    torch.cuda.set_sync_debug_mode("default")
    launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                "sdf_layers": sdf_layers.LAUNCHES}
    per_frame_syncs = [sync_after[0]] + [b - a for a, b in zip(sync_after, sync_after[1:])]
    print(f"nodes: launches over {len(outs)} frames x {len(NODE_OUTPUTS)} outputs: {launches}; "
          f"synchronising calls flagged per frame: {per_frame_syncs}")
    check(len(per_frame_syncs) == len(outs) and max(per_frame_syncs[2:]) == 0,
          "nodes: a frame of 2-40 synchronised")
    stats = eager.report()
    kinds = [kind for _, _, kind in eager.renders]
    n_out = len(NODE_OUTPUTS)
    check(len(kinds) == n_out * len(outs), f"nodes: {len(kinds)} renders")
    replayed = [k for k in range(len(outs)) if set(kinds[k * n_out:(k + 1) * n_out]) == {"replay"}]
    print(f"nodes: frames whose three outputs all replayed: {replayed}")
    check(not [k for k in replayed if per_frame_syncs[k]], "nodes: a replay frame synchronised")
    moving = list(range(2, FPS + 1))
    for fmt in NODE_OUTPUTS:
        runs = counted.runs[fmt]
        check(len(runs) == len(outs), f"nodes {fmt}: {len(runs)} renders, not {len(outs)}")
        k1 = [k for k, r in enumerate(runs) if r[0]]
        k2 = [r[1] for r in runs]
        k3 = [k for k, r in enumerate(runs) if r[2]]
        print(f"nodes {fmt}: K1 on {len(k1)} of {len(runs)} frames, K2 per frame {set(k2)}, "
              f"K3 on frames {k3}")
        check(len(k1) == len(runs), f"nodes {fmt}: K1 did not run on every frame")
        want_k2 = 0 if fmt == "PLANAR_YUV444" else 1
        check(set(k2) == {want_k2}, f"nodes {fmt}: K2 launches per frame {set(k2)}")
        check(k3 == moving, f"nodes {fmt}: K3 on frames {k3}, not 2..{FPS}")
    for k, out in enumerate(outs):
        y, u, v = out["PLANAR_YUV420"].data
        ny, uv = out["NV12"].data
        check(torch.equal(ny, y) and torch.equal(uv, torch.stack([u, v], dim=-1)),
              f"nodes frame {k}: NV12 is not the YUV420 output interleaved")
        p444 = out["PLANAR_YUV444"].data
        check([tuple(p.shape) for p in p444] == [(OUT_H, OUT_W)] * 3
              and all(p.dtype == torch.uint8 for p in p444), f"nodes frame {k}: YUV444 planes")
        if k in (0, 1, 2, 15, FPS, FPS + 1, N_RENDER_FRAMES):
            check_planes(f"nodes frame {k} YUV420", interop.planes_to_host((y, u, v)),
                         OUT_W, OUT_H)
    print(f"nodes: NV12 = YUV420 interleaved and YUV444 plane shapes on all {len(outs)} frames")
    del outs
    t_check = time.perf_counter() - t_phase

    # the card against the port on the CPU, at a CPU size
    sub = [1, 2, 15, FPS + 1]
    small_frames = renderer_inputs(4, 256, 144, seed=12)
    ref = render_nodes("cpu", 4, 768, 432, small_frames, sub)
    got = render_nodes(dev, 4, 768, 432, small_frames, sub)
    for fmt in NODE_OUTPUTS:
        mx, n_diff, n_gt1, total = 0, 0, 0, 0
        for a, b in zip(ref, got):
            m, d, g, t = lsb_stats(interop.planes_to_host(a[fmt].data),
                                   interop.planes_to_host(b[fmt].data))
            mx, n_diff, n_gt1, total = max(mx, m), n_diff + d, n_gt1 + g, total + t
        print(f"parity card vs CPU nodes {fmt} 4x256x144 -> 768x432, frames {[0] + sub}: "
              f"max {mx} LSB, {n_diff} of {total} pixels differ")
        check(mx <= 1, f"nodes {fmt}: card vs CPU off by {mx} LSB")
    del ref, got
    t_parity = time.perf_counter() - t_phase - t_check

    def frame_times(formats, last, profile_at=None):
        """Frames 1-`last` of the transition and, after a jump, 32-35 timed
        one by one (`cuda_ms`), frame `profile_at` under torch.profiler
        instead; medians over animating frames 3-`last` and settled frames
        33-35 (32 moves the banner from its place at `last`). Returns the
        renderer, (profile, its wall ms) and the medians."""
        r, _ = nodes_renderer(dev, OUT_W, OUT_H, N_INPUTS, frames, formats)
        ms, prof, wall = {}, None, None
        for k in list(range(1, last + 1)) + list(range(FPS + 2, FPS + 6)):
            fs = FrameSet(pts=k / FPS, frames=frames)
            if k == profile_at:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    r.render(fs)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                continue
            ms[k] = cuda_ms(lambda: r.render(fs), iters=1, warmup=0)
        return r, (prof, wall), dict(
            animating_ms=statistics.median(ms[k] for k in range(3, last + 1) if k in ms),
            stable_ms=statistics.median(ms[k] for k in range(FPS + 3, FPS + 6)))

    times = {}
    for fmt in NODE_OUTPUTS:
        r, _, times[fmt] = frame_times((fmt,), 10)
        r.close()
    # the three outputs together, their frame 15 under the profiler
    r, (prof, wall), times["all three"] = frame_times(NODE_OUTPUTS, 16, profile_at=15)
    for name, t in times.items():
        print(f"time nodes frame 16x1080p->4K, {name}: animating median "
              f"{t['animating_ms']:.4f} ms, stable median {t['stable_ms']:.4f} ms {stamp}")
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    dev_ms = sum(e.device_time_total for e in rows) / 1e3
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    print(f"profile nodes frame 15 (16x1080p->4K, three outputs): device {dev_ms:.4f} ms in "
          f"{sum(e.count for e in rows)} device ops ({n_launch} kernel launches), wall "
          f"{wall:.4f} ms under the profiler, device busy {dev_ms / wall:.0%} {stamp}")
    for e in sorted(rows, key=lambda e: -e.device_time_total)[:8]:
        print(f"  device {e.device_time_total / 1e3:.4f} ms x{e.count}: {e.key[:100]}")

    # each shader alone at 1280x720, on random 1080p textures
    shader_ms = {}
    tex = [torch.rand((IN_H, IN_W, 4), device=dev) for _ in range(4)]
    t15 = torch.full((), 15 / FPS, device=dev)
    args = {"pulse": (tex[:1], None), "gradient": ([], {"gain": 1.0}),
            "circle_layout": (tex, {"center": {"x": 640.0, "y": 360.0}, "radius": 200.0,
                                    "angles_deg": [0.0, 90.0, 180.0, 270.0]})}
    for shader_id, (inputs, param) in args.items():
        fn = r.shaders.get(shader_id)
        call = lambda fn=fn, inputs=inputs, param=param: fn(inputs, param, (1280, 720), t15)  # noqa: E731
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as sp:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        d = sum(e.device_time_total for e in sp.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 10
        shader_ms[shader_id] = dict(device_ms=d, call_ms=cuda_ms(call))
        print(f"time shader {shader_id} 1280x720: device {d:.4f} ms, call "
              f"{shader_ms[shader_id]['call_ms']:.4f} ms {stamp}")
    r.close()
    took = time.perf_counter() - t_phase
    print(f"nodes phase: {took:.1f} s (checked run {t_check:.1f} s, parity {t_parity:.1f} s)")
    return launches, dict(frame_ms=times, profile_frame15=dict(
        device_ms=dev_ms, wall_ms=wall, busy=dev_ms / wall, launches=n_launch),
        shaders=shader_ms, phase_s=took, captured_programs=stats, card=stamp)


# the live network edges phase (12): the server composes RTP, RTMP and WHIP
# inputs sent by a child process and sends its output back over RTP

EDGE_SECONDS = 6.0
EDGE_UPDATE_AT = 3.0
EDGE_BITRATE = 4_000_000  # bit/s of each input clip
EDGE_TAIL_S = 1.5  # the receiver's wait for the output's last packets
EDGE_STRIPES = 10  # input 0's frame code: a white and a black reference, 8 bits


def edge_protocols(n):
    """Input i's protocol: inputs 1, 2 and 3 (the first row of the grid, out
    of the highlight's path at 16 inputs) are the RTP-over-TCP, RTMP and
    WHIP inputs, the others (input 0 among them) RTP over UDP; n >= 4."""
    return ["rtp_udp", "rtp_tcp", "rtmp", "whip"] + ["rtp_udp"] * (n - 4)


def edge_colour(i):
    """Input i's flat colour, BT.709 limited-range (Y, U, V) of an RGB
    colour inside the gamut (its round trip through RGB is exact to 1 LSB),
    none of them grey."""
    levels = (60, 140, 220)
    rgb = [(r, g, b) for r in levels for g in levels for b in levels
           if not r == g == b][(i * 7) % 24]
    r, g, b = rgb
    y = 16 + (0.2126 * r + 0.7152 * g + 0.0722 * b) * 219 / 255
    u = 128 + (-0.1146 * r - 0.3854 * g + 0.5 * b) * 224 / 255
    v = 128 + (0.5 * r - 0.4542 * g - 0.0458 * b) * 224 / 255
    return int(round(y)), int(round(u)), int(round(v))


def edge_frame(i, k, w, h):
    """Frame k of input i (u8 Y, U, V planes): its flat colour, a white bar
    that moves along the top twelfth, and on input 0 the frame index as
    stripes along the bottom eighth (white, black, then 8 bits, MSB first)."""
    import numpy as np

    yc, uc, vc = edge_colour(i)
    y = np.full((h, w), yc, np.uint8)
    u = np.full((h // 2, w // 2), uc, np.uint8)
    v = np.full((h // 2, w // 2), vc, np.uint8)
    bw, bx = w // 8 & ~1, (k * w // 45) % w & ~1
    y[:h // 12 & ~1, bx:bx + bw] = 235
    u[:h // 24, bx // 2:(bx + bw) // 2] = 128
    v[:h // 24, bx // 2:(bx + bw) // 2] = 128
    if i == 0:
        top = (h - h // 8) & ~1
        bits = [1, 0] + [(k >> (7 - b)) & 1 for b in range(8)]
        for j, bit in enumerate(bits):
            x0, x1 = (j * w // EDGE_STRIPES) & ~1, ((j + 1) * w // EDGE_STRIPES) & ~1
            y[top:, x0:x1] = 235 if bit else 16
            u[top // 2:, x0 // 2:x1 // 2] = 128
            v[top // 2:, x0 // 2:x1 // 2] = 128
    return y, u, v


def edge_probes(n, out_w, out_h):
    """Per tile of the scene's grid (4 x 4 at 16 inputs), its probe patch:
    (top, left, size), centred horizontally and at 15% of the cell's height
    (below the inputs' moving bar, above the banner), with whether an
    overlay (the highlight's path from the first to the last cell, the
    banner's slide, both with their shadows and a margin) can cover it."""
    s = out_w / 3840.0
    cols = int(round(n ** 0.5))
    rows = -(-n // cols)
    tw, th = out_w / cols, out_h / rows
    size = max(4, int(round(16 * s))) & ~1
    pad, margin = 24 * s, 64 * s
    hw, hh = tw - 2 * pad, th - 2 * pad
    bw, bh = 2400 * s, 240 * s
    banner = (out_h - bh - 120 * s - margin, 160 * s - margin,
              out_h - 120 * s + 38 * s + margin, 1200 * s + bw + 38 * s + margin)
    probes = []
    for i in range(n):
        r, c = divmod(i, cols)
        top = int(r * th + 0.15 * th) & ~1
        left = int((c + 0.5) * tw - size / 2) & ~1
        rect = (top, left, top + size, left + size)

        def hits(box):
            return not (rect[2] <= box[0] or box[2] <= rect[0]
                        or rect[3] <= box[1] or box[3] <= rect[1])

        path = [(p * (rows - 1) * th + pad - margin, p * (cols - 1) * tw + pad - margin,
                 p * (rows - 1) * th + pad + hh + margin, p * (cols - 1) * tw + pad + hw + margin)
                for p in [q / 200 for q in range(201)]]
        probes.append((top, left, size, hits(banner) or any(hits(b) for b in path)))
    return probes


def edge_scene_wire(out_w, out_h, n, stage):
    """`renderer_scene(out_w, out_h, n, stage)` as the wire's JSON."""
    s = out_w / 3840.0
    cols = int(round(n ** 0.5))
    rows = -(-n // cols)
    tw, th = out_w / cols, out_h / rows
    r, c = (0, 0) if stage == 0 else (rows - 1, cols - 1)
    pad, bw, bh = 24 * s, 2400 * s, 240 * s
    highlight = {
        "type": "view", "id": "highlight", "width": tw - 2 * pad, "height": th - 2 * pad,
        "top": r * th + pad, "left": c * tw + pad, "background_color": "#FFFFFF28",
        "border_radius": 16 * s, "border_width": 8 * s, "border_color": "#FFC800FF",
        "box_shadow": [{"blur_radius": 24 * s, "color": "#000000B4"}],
        "transition": {"duration_ms": 1000}}
    banner = {
        "type": "view", "id": "banner", "width": bw, "height": bh,
        "top": out_h - bh - 120 * s, "left": (160 if stage == 0 else 1200) * s,
        "background_color": "#C81E1EE6", "border_radius": 24 * s, "border_width": 4 * s,
        "border_color": "#FFFFFFFF",
        "box_shadow": [{"offset_x": 8 * s, "offset_y": 8 * s, "blur_radius": 30 * s,
                        "color": "#000000A0"}],
        "transition": {"duration_ms": 1000}}
    tiles = {"type": "tiles", "background_color": "#101010FF", "margin": 8.0 * s,
             "children": [{"type": "rescaler", "child": {"type": "input_stream",
                                                        "input_id": f"input_{i}"}}
                          for i in range(n)]}
    return {"type": "view", "background_color": "#000000FF",
            "children": [tiles, highlight, banner]}


class _ApiServer:
    """The port's HTTP server (`smelter_tpu_torch.server.app`) on an
    ephemeral port of 127.0.0.1, its aiohttp loop on a thread of this
    process."""

    def __init__(self, state):
        self.state, self.port, self._loop = state, None, None
        started = threading.Event()

        def run():
            import asyncio

            from aiohttp import web

            from smelter_tpu_torch.server.app import build_app

            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)
            runner = web.AppRunner(build_app(state))
            self._loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, "127.0.0.1", 0)
            self._loop.run_until_complete(site.start())
            self.port = runner.addresses[0][1]
            started.set()
            self._loop.run_forever()
            self._loop.run_until_complete(runner.cleanup())

        self._thread = threading.Thread(target=run, name="api", daemon=True)
        self._thread.start()
        check(started.wait(timeout=30), "edges: the server did not start")
        self.base = f"http://127.0.0.1:{self.port}"

    def call(self, method, path, body=None):
        """(status, JSON body) of an API request."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(
            self.base + path, method=method,
            data=None if body is None else json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as exc:
            return exc.code, json.loads(exc.read() or b"{}")

    def stop(self):
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=30)


def _edge_clips(n, w, h, seconds):
    """Each input's clip, encoded once with the port's codec service (H.264,
    parameter sets inline, EDGE_BITRATE): its packets, in decode order."""
    import concurrent.futures

    from smelter_tpu_torch.io.codec import Codec, VideoEncoder

    n_frames = int(seconds * FPS)

    def encode(i):
        enc = VideoEncoder(Codec.H264, w, h, FPS, bitrate=EDGE_BITRATE, opts="global_header=0")
        pkts = []

        def drain():
            while True:
                p = enc.receive()
                if p is None or p == "eof":
                    return
                pkts.append(p)

        for k in range(n_frames):
            enc.send(*edge_frame(i, k, w, h), k / FPS)
            drain()
        enc.send_eof()
        drain()
        enc.close()
        return pkts

    with concurrent.futures.ThreadPoolExecutor(min(n, os.cpu_count() or 4)) as pool:
        return list(pool.map(encode, range(n)))


def _edge_sender(kind, target, pkts, t0, sent, idx):
    """Sends one input's packets at 30 fps from t0 (frame k at t0 + k / FPS)
    over its protocol, through the port's payloaders and sinks; records the
    send times of its frames in `sent[idx]`."""
    import socket

    from smelter_tpu_torch.io import rtcp
    from smelter_tpu_torch.io.rtp import H264Payloader

    times, n_rtp = [], 0
    if kind in ("rtp_udp", "rtp_tcp"):
        pay = H264Payloader(ssrc=0x1000 + idx, mtu=1200)
        if kind == "rtp_udp":
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            dest = ("127.0.0.1", target["port"])
            send = lambda data: sock.sendto(data, dest)  # noqa: E731
        else:
            sock = socket.create_connection(("127.0.0.1", target["port"]), timeout=10)
            send = lambda data: sock.sendall(len(data).to_bytes(2, "big") + data)  # noqa: E731
        last_sr = None
        for k, p in enumerate(pkts):
            time.sleep(max(0.0, t0 + k / FPS - time.perf_counter()))
            times.append(time.perf_counter())
            if kind == "rtp_udp" and (last_sr is None or times[-1] - last_sr >= 1.0):
                sec, frac = rtcp.ntp_now()
                send(rtcp.build_sender_report(rtcp.SenderReport(
                    pay.ssrc, sec, frac, int(round(k / FPS * 90000)), n_rtp, 0)))
                last_sr = times[-1]
            for rp in pay.payload(p.data, p.pts_s or 0.0):
                send(rp.serialize())
                n_rtp += 1
        if kind == "rtp_udp":
            send(rtcp.build_bye([pay.ssrc]))  # the input's end of stream
        sock.close()
    else:
        if kind == "rtmp":
            from smelter_tpu_torch.io.rtmp import RtmpClientOutput

            sink = RtmpClientOutput(target["url"])
        else:
            from smelter_tpu_torch.io.webrtc import WhipClientOutput

            sink = WhipClientOutput(target["url"], bearer_token=target["token"])
        sink.setup_video(None, b"", FPS, 1)
        for k, p in enumerate(pkts):
            time.sleep(max(0.0, t0 + k / FPS - time.perf_counter()))
            times.append(time.perf_counter())
            sink.write_video_packet(p)
        sink.on_done()
    sent[idx] = times


def edge_frame_stats(y, u, v, n, out_w, out_h, probes):
    """A received output frame of the edges scene: its planes' shapes, each
    tile probe's mean (Y, U, V) and input 0's frame index read from its
    stripes (or None)."""
    cols = int(round(n ** 0.5))
    tw, th = out_w / cols, out_h / (-(-n // cols))
    tiles = []
    for top, left, size, _covered in probes:
        rows, cs = slice(top // 2, (top + size) // 2), slice(left // 2, (left + size) // 2)
        tiles.append([float(y[top:top + size, left:left + size].mean()),
                      float(u[rows, cs].mean()), float(v[rows, cs].mean())])
    # input 0's stripes: the bottom eighth of tile 0, inside its margins
    row = int(th * 0.93)
    means = [float(y[row - 2:row + 2, int(tw * (j + 0.5) / EDGE_STRIPES) - 2:
                   int(tw * (j + 0.5) / EDGE_STRIPES) + 2].mean())
             for j in range(EDGE_STRIPES)]
    white, black = means[0], means[1]
    index = None
    if white - black > 20:
        mid = (white + black) / 2
        index = sum(int(m > mid) << (7 - b) for b, m in enumerate(means[2:]))
    return dict(shape=[list(y.shape), list(u.shape)], tiles=tiles, index=index)


def _edge_analyse(packets, n, out_w, out_h):
    """Depayloads the output's RTP packets (arrival time, bytes) with the
    port's H264Depayloader, decodes them with the codec service and returns
    per frame: its arrival (its last packet), shape, each tile probe's mean
    (Y, U, V) and input 0's frame index read from its stripes (or None)."""
    import numpy as np

    from smelter_tpu_torch.io.codec import Codec, VideoDecoder
    from smelter_tpu_torch.io.rtp import H264Depayloader, RtpPacket

    probes = edge_probes(n, out_w, out_h)
    dep, dec = H264Depayloader(), VideoDecoder(Codec.H264)
    arrivals, frames = {}, []

    def take(f):
        y, u, v, pts, _ = f
        frames.append(dict(pts=pts, arrival=arrivals.get(round(pts or 0.0, 4)),
                           **edge_frame_stats(y, u, v, n, out_w, out_h, probes)))

    for t, data in packets:
        pkt = RtpPacket.parse(data)
        if pkt is None or pkt.payload_type != 96:
            continue
        for au in dep.push(pkt):
            arrivals[round(au.pts_s, 4)] = t  # the packet that completed the access unit
            dec.send(au.data, au.pts_s)
            while True:
                f = dec.receive()
                if f is None or f == "eof":
                    break
                take(f)
    dec.send_eof()
    while True:
        f = dec.receive()
        if f is None or f == "eof":
            break
        take(f)
    dec.close()
    return frames


def _edge_peer(conn, n, in_w, in_h, out_w, out_h, seconds):
    """The senders and the receiver, in a child process: encodes the clips,
    binds the receiver, reports its port, sends every input at 30 fps from
    the parent's "go", receives the output until "stop", and returns the
    analysis of what it received."""
    import socket
    import traceback

    try:
        clips = _edge_clips(n, in_w, in_h, seconds)
        rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 16 << 20)
        rx.bind(("127.0.0.1", 0))
        rx.settimeout(0.2)
        conn.send(("ready", rx.getsockname()[1]))
        _, targets = conn.recv()
        packets, stop = [], threading.Event()

        def receive():
            while not stop.is_set():
                try:
                    data = rx.recv(65536)
                except socket.timeout:
                    continue
                packets.append((time.perf_counter(), data))

        receiver = threading.Thread(target=receive, daemon=True)
        receiver.start()
        sent = {}
        t0 = time.perf_counter() + 0.2
        senders = _threads([(_edge_sender, (targets[i]["kind"], targets[i], clips[i], t0, sent, i))
                            for i in range(n)])
        for t in senders:
            t.join(timeout=seconds + 60)
        conn.send(("sent", dict(t0=t0, t_end=time.perf_counter(),
                                senders_alive=sum(t.is_alive() for t in senders),
                                frames_sent={i: len(sent[i]) for i in sent})))
        conn.recv()  # "stop": the parent has unregistered the output
        stop.set()
        receiver.join(timeout=10)
        rx.close()
        frames = _edge_analyse(packets, n, out_w, out_h)
        conn.send(("result", dict(frames=frames, send0=sent.get(0, []),
                                  t_end=time.perf_counter(), n_packets=len(packets))))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        conn.send(("error", traceback.format_exc()))
        raise


def _peer_message(conn, peer, timeout, what, label="edges"):
    """The next message of a phase's peer process, failing the phase if the
    peer dies or stays silent for `timeout` s, or reports an error."""
    deadline = time.perf_counter() + timeout
    while not conn.poll(0.5):
        check(peer.is_alive(), f"{label}: the peer exited ({peer.exitcode}) before {what}")
        check(time.perf_counter() < deadline, f"{label}: no {what} in {timeout} s")
    msg = conn.recv()
    check(msg[0] != "error", f"{label}: the peer failed before {what}: {msg[-1]}")
    return msg


class _ReceiveLog:
    """While installed (a `with` block), counts what the server's receive
    loops take in, by the protocol of the input whose thread takes it
    (`kinds`, by input index): the RTP packets that the RTP inputs' and the
    WHIP sessions' loops parse (`RtpPacket.parse`), and the video messages
    that the RTMP input parses (`parse_video_tag`)."""

    def __init__(self, kinds):
        self.kinds, self.counts = kinds, {}

    def _tally(self, unit):
        name = threading.current_thread().name
        if name.startswith(("rtp-recv:input_", "rtmp-in:input_")):
            kind = self.kinds[int(name.rsplit("_", 1)[1])]
        elif name.startswith("webrtc-"):
            kind = "whip"
        else:
            return
        self.counts[(kind, unit)] = self.counts.get((kind, unit), 0) + 1

    def __enter__(self):
        from smelter_tpu_torch.io.rtmp import session
        from smelter_tpu_torch.io.rtp import RtpPacket

        self._orig = (RtpPacket.__dict__["parse"], session.parse_video_tag)
        parse, parse_tag = RtpPacket.parse, session.parse_video_tag
        log = self

        def logged_parse(data):
            pkt = parse(data)
            if pkt is not None:
                log._tally("rtp_packets")
            return pkt

        def logged_parse_tag(payload):
            tag = parse_tag(payload)
            if tag is not None:
                log._tally("video_messages")
            return tag

        RtpPacket.parse, session.parse_video_tag = staticmethod(logged_parse), logged_parse_tag
        return self

    def __exit__(self, *exc):
        from smelter_tpu_torch.io.rtmp import session
        from smelter_tpu_torch.io.rtp import RtpPacket

        RtpPacket.parse, session.parse_video_tag = self._orig
        return False

    def per_second(self, seconds):
        """{protocol: {unit: count / seconds}}."""
        out = {}
        for (kind, unit), n in sorted(self.counts.items()):
            out.setdefault(kind, {})[f"{unit}_per_s"] = n / seconds
        return out


class _DecoderLog:
    """While installed (a `with` block), every `VideoDecoder` of the port's
    codec service records the pts it is sent and the sends made before each
    frame it returns: a decoder's delay in frames, and the frames it held
    back at the end of its stream (sent, never returned)."""

    def __enter__(self):
        from smelter_tpu_torch.io import codec

        self.decoders, cls = [], codec.VideoDecoder
        self._orig = (cls.__init__, cls.send, cls.receive)
        init, send, receive = self._orig
        log = self

        def logged_init(dec, *args, **kw):
            init(dec, *args, **kw)
            dec._edge_log = dict(thread=threading.current_thread().name, sent=0, out=0,
                                 delays=[])
            log.decoders.append(dec._edge_log)

        def logged_send(dec, data, pts_s, *args, **kw):
            out = send(dec, data, pts_s, *args, **kw)
            dec._edge_log["sent"] += 1
            return out

        def logged_receive(dec, *args, **kw):
            f = receive(dec, *args, **kw)
            if f is not None and f != "eof":
                entry = dec._edge_log
                entry["out"] += 1
                entry["delays"].append(entry["sent"] - entry["out"])
            return f

        cls.__init__, cls.send, cls.receive = logged_init, logged_send, logged_receive
        return self

    def __exit__(self, *exc):
        from smelter_tpu_torch.io import codec

        codec.VideoDecoder.__init__, codec.VideoDecoder.send, codec.VideoDecoder.receive = (
            self._orig)
        return False


def edges_unavailable():
    """Why the edges phase cannot run here, or None: the codec service must
    load (FFmpeg's shared libraries) and encode and decode H.264. One
    explicit probe; nothing inside the phase is caught."""
    from smelter_tpu_torch.io import codec

    try:
        caps = codec.caps()
    except RuntimeError as exc:
        return str(exc)
    if not (caps["h264_decode"] and caps["h264_encode"]):
        return f"the codec service has no H.264 encoder and decoder: {caps}"
    return None


def edges_phase(dev, stamp, n=N_INPUTS, in_w=IN_W, in_h=IN_H, out_w=OUT_W, out_h=OUT_H,
                seconds=EDGE_SECONDS, update_at=EDGE_UPDATE_AT):
    """Phase 12: the port's server (`smelter_tpu_torch.server.app`) in this
    process, in real time (the renderer captures new structures in the
    background), composing n 1080p H.264 inputs that a child process sends
    over the network: n - 3 RTP over UDP (with RTCP sender reports), one RTP
    over TCP, one RTMP (the port's RtmpClientOutput) and one WHIP (the
    port's WhipClientOutput), each registered over HTTP, 30 fps for
    `seconds`; `renderer_scene` as wire JSON, 4K H.264 out over RTP/UDP to
    the child, which depayloads and decodes it; at `update_at` s the
    overlays move (stage 1, a one-second transition). The device is the
    server's default (the card; SMELTER_DEVICE=cpu for a rehearsal).

    Gated: every registration, the update and the unregisters answer 200
    with the reference's body; no input ends and no OUTPUT_ERROR fires
    before the senders finish; the output decodes to out_w x out_h frames,
    at least 15 a second; from the first frame in which every tile probe
    no overlay can reach shows its input's colour (mean Y, U, V within 6),
    every frame received before the senders finished shows them, and every
    tile shows its input's colour in some frame; on the card, K1 and K2
    once in every render that was not frozen (its own launches, on the
    renderer thread: a background capture's warm-up counts on its thread),
    K3 in a render after the update and in none before, and no
    synchronising call on the renderer thread in a render that replayed a
    graph; /status lists nothing after the unregisters. Recorded: what the
    server's receive loops take in per second, by protocol (RTP packets of
    the RTP and WHIP inputs, video messages of the RTMP input), the
    launches that background captures made, frames/s received, the latency
    from an input 0 frame's send to the arrival of the first output frame
    that shows its index, each server decoder's delay in frames and the
    frames it held back at the end of its stream, the render, fetch-host
    and encode spans, the card's busy share over the window's last second
    and the frames frozen by the update. Returns (the kernel launches of
    the run or None when skipped, the recorded numbers)."""
    import multiprocessing

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out

    why = edges_unavailable()
    if why is not None:
        out = {"skipped": why}
        print(json.dumps({"edges": out}))
        return None, out
    kinds = edge_protocols(n)

    from smelter_tpu_torch.config import Config, LoggerConfig
    from smelter_tpu_torch.core.types import Framerate
    from smelter_tpu_torch.server.app import ApiState
    from smelter_tpu_torch.utils import tracing

    t_run = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    peer = ctx.Process(target=_edge_peer, name="edge-peer", daemon=True,
                       args=(child_conn, n, in_w, in_h, out_w, out_h, seconds))
    peer.start()
    if on_card:
        # the process's first profiler start initialises CUPTI for seconds
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    state = ApiState(Config(output_framerate=Framerate(FPS), ahead_of_time_processing=False,
                            never_drop_output_frames=False,
                            logger=LoggerConfig(level="warning")))
    check(state.pipeline.renderer.options.async_compile,
          "edges: a live server must capture in the background")
    log = RenderLog(state.pipeline.renderer, keep_calls=False)
    server = _ApiServer(state)
    targets = []
    decoder_log = _DecoderLog().__enter__()
    receive_log = _ReceiveLog(kinds).__enter__()
    try:
        for i, kind in enumerate(kinds):
            body = {"rtp_udp": {"type": "rtp_stream", "port": 0, "transport_protocol": "udp",
                                "video": {"decoder": "ffmpeg_h264"}},
                    "rtp_tcp": {"type": "rtp_stream", "port": 0,
                                "transport_protocol": "tcp_server",
                                "video": {"decoder": "ffmpeg_h264"}},
                    "rtmp": {"type": "rtmp_server", "app": "live", "stream_key": "key"},
                    "whip": {"type": "whip_server"}}[kind]
            status, reply = server.call("POST", f"/api/input/input_{i}/register", body)
            check(status == 200, f"edges: input_{i} ({kind}): {status} {reply}")
            if kind.startswith("rtp"):
                check(sorted(reply) == ["port"], f"edges: input_{i}: {reply}")
                targets.append({"kind": kind, "port": reply["port"]})
            elif kind == "rtmp":
                check(sorted(reply) == ["port"], f"edges: input_{i}: {reply}")
                targets.append({"kind": kind,
                                "url": f"rtmp://127.0.0.1:{reply['port']}/live/key"})
            else:
                check(sorted(reply) == ["bearer_token", "endpoint_route"]
                      and reply["endpoint_route"] == f"/whip/input_{i}", f"edges: {reply}")
                targets.append({"kind": kind, "url": server.base + reply["endpoint_route"],
                                "token": reply["bearer_token"]})
        rx_port = _peer_message(conn, peer, 300, "the senders' start")[1]
        status, reply = server.call("POST", "/api/output/out/register", {
            "type": "rtp_stream", "ip": "127.0.0.1", "port": rx_port,
            "transport_protocol": "udp",
            "video": {"resolution": {"width": out_w, "height": out_h},
                      "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
                      "initial": {"root": edge_scene_wire(out_w, out_h, n, 0)}}})
        check((status, reply) == (200, {}), f"edges: output: {status} {reply}")
        scene_assembly.LAUNCHES = yuv_out.LAUNCHES = sdf_layers.LAUNCHES = 0
        tally0 = dict(_THREAD_LAUNCHES)
        tracing.reset()
        status, reply = server.call("POST", "/api/start", {})
        check((status, reply) == (200, {}), f"edges: start: {status} {reply}")
        with log.capture_syncs() if on_card else contextlib.nullcontext():
            conn.send(("go", targets))
            t_go = time.perf_counter()
            time.sleep(max(0.0, t_go + update_at - time.perf_counter()))
            t_update = time.perf_counter()
            status, reply = server.call("POST", "/api/output/out/update",
                                        {"video": {"root": edge_scene_wire(out_w, out_h, n, 1)}})
            check((status, reply) == (200, {}), f"edges: update: {status} {reply}")
            t_updated = time.perf_counter()
            time.sleep(max(0.0, t_go + seconds - 1.0 - time.perf_counter()))
            # no sender has finished yet: each sends its last frame at
            # t_go + 0.2 + (seconds * FPS - 1) / FPS, in the child
            events_live = [(e.kind, e.entity_id) for e in state.pipeline.events.history()]
            prof = profile(activities=[ProfilerActivity.CUDA if on_card
                                       else ProfilerActivity.CPU])
            prof.start()
            t_prof = time.perf_counter()
            time.sleep(max(0.0, t_go + seconds - time.perf_counter()))
            if on_card:
                torch.cuda.synchronize()
            prof_span = time.perf_counter() - t_prof
            sent = _peer_message(conn, peer, 120, "the senders' end")[1]
            time.sleep(EDGE_TAIL_S)
        launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                    "sdf_layers": sdf_layers.LAUNCHES}
        # the warm-ups of the structures captured on background threads
        capture_launches = sum(v - tally0.get(k, 0) for k, v in _THREAD_LAUNCHES.items()
                               if k[1] not in log.threads)
        spans = tracing.report()
        status, reply = server.call("POST", "/api/output/out/unregister", {})
        check((status, reply) == (200, {}), f"edges: output unregister: {status} {reply}")
        for i in range(n):
            status, reply = server.call("POST", f"/api/input/input_{i}/unregister", {})
            check((status, reply) == (200, {}), f"edges: input_{i} unregister: {status} {reply}")
        status, st = server.call("GET", "/status")
        check(status == 200 and st["inputs"] == [] and st["outputs"] == [],
              f"edges: /status after the unregisters: {st}")
        conn.send(("stop",))
        result = _peer_message(conn, peer, 300, "the receiver's report")[1]
    finally:
        receive_log.__exit__(None, None, None)
        decoder_log.__exit__(None, None, None)
        state.pipeline.close()
        server.stop()
        peer.join(timeout=30)
        if peer.is_alive():
            peer.kill()
            peer.join(timeout=10)
    # the profiler stops once the server's threads are gone (`profile_busy`)
    prof.stop()
    check(peer.exitcode == 0, f"edges: the peer exited with {peer.exitcode}")
    check(sent["senders_alive"] == 0, "edges: a sender hung")

    bad = [e for e in events_live if e[0] == "OUTPUT_ERROR" or e[0].endswith("_EOS")]
    check(not bad, f"edges: events before the senders finished: {bad}")
    frames = result["frames"]
    t0, t_end = sent["t0"], sent["t_end"]
    received = live_frame_checks("edges", frames, n, out_w, out_h, seconds, t0, t_end,
                                 result["send0"])
    renders = live_render_checks("edges", log, t_update, t_updated, on_card)
    busy = profile_busy(prof, prof_span) if on_card else None
    out = dict(inputs=n, protocols={k: kinds.count(k) for k in sorted(set(kinds))},
               out=f"{out_w}x{out_h}", seconds=seconds,
               received_per_s=receive_log.per_second(max(t_end - t0, 1e-9)),
               capture_launches=capture_launches, **received, **renders,
               **live_spans(spans), device_busy=busy, busy_window_s=prof_span,
               decoders=decoder_stats(decoder_log), frames_sent=sent["frames_sent"],
               run_s=time.perf_counter() - t_run, card=stamp)
    print(f"edges {n}x{in_w}x{in_h}->{out_w}x{out_h}: launches {launches}")
    print(json.dumps({"edges": out}))
    return launches, out


# the MoQ phase (13): (a) the transport, 16 publishers over the port's QUIC
# stack into the port's MoqServer; (b) the media path, MoQ inputs composed by
# the port's server into a MoQ output

# the publishers of the gated run: a load the port's QUIC stack carries on
# the H100 machine's host in every run so far (PERF.md: 2 kept up in some
# runs and fell 18 s behind in others, 8 and more collapse); the capacity
# runs record 2 and 16 (phase 12's show), ungated; `--moq-capacity`
# measures other counts
MOQ_INPUTS = 1
MOQ_CAPACITY_INPUTS = (2, 16)
MOQ_CAPACITY_WAIT_S = 5.0  # the capacity runs' wait after the last write
MOQ_TRANSPORT_CEILING_S = 120.0
MOQ_SECONDS = 5.0
MOQ_KEYFRAME_BYTES = 100_000  # the first object of each one-second group
MOQ_DELTA_BYTES = 20_000  # the other 29: 5.0 Mbit/s an input at 30 objects/s
MOQ_DEADLINE_S = 30.0  # after the last write, for the last object to arrive
MOQ_MEDIA_INPUTS = 4
MOQ_MEDIA_SECONDS = 8.0
MOQ_MEDIA_UPDATE_AT = 4.0
MOQ_THREADS = ("quic-endpoint", "moq-session", "moq-subscriber")


def moq_object(seed, i, k):
    """Object k of MoQ publisher i: (timestamp us, keyframe, payload). Object
    k is frame k of a 30 fps track whose groups are one second long, the
    first object of each a keyframe of MOQ_KEYFRAME_BYTES, the others
    MOQ_DELTA_BYTES; the payload is drawn from (seed, i, k)."""
    import numpy as np

    key = k % FPS == 0
    size = MOQ_KEYFRAME_BYTES if key else MOQ_DELTA_BYTES
    return int(round(k * 1e6 / FPS)), key, np.random.default_rng([seed, i, k]).bytes(size)


def _socket_buffers():
    """The host's default and largest UDP receive buffer, bytes (the QUIC
    endpoints keep the default), or None where /proc does not say."""
    out = {}
    for name in ("rmem_default", "rmem_max"):
        try:
            with open(f"/proc/sys/net/core/{name}") as f:
                out[name] = int(f.read())
        except (OSError, ValueError):
            out[name] = None
    return out


def _moq_threads():
    return {t for t in threading.enumerate() if t.name.startswith(MOQ_THREADS)}


def _moq_threads_end(before, timeout=10.0):
    """The names of the MoQ and QUIC threads started since `before` that are
    still alive after `timeout` s."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and _moq_threads() - before:
        time.sleep(0.05)
    return sorted(t.name for t in _moq_threads() - before)


class _MoqSubscriber:
    """An input of the MoQ server's state that only subscribes: it takes the
    announced broadcast's catalog and video track and keeps every object it
    reads, with its arrival time (`time.monotonic`)."""

    def __init__(self, token):
        self.options = type("Options", (), {"auth_token": token})()
        self.session, self.catalog, self.objects, self.error = None, None, [], None
        self._thread = None

    def attach_session(self, session):
        if self.session is not None:
            return False
        self.session = session
        self._thread = threading.Thread(target=self._run, name="moq-subscriber", daemon=True)
        self._thread.start()
        return True

    def _run(self):
        import traceback

        from smelter_tpu_torch.io.moq import catalog
        from smelter_tpu_torch.io.moq.input import session_dead

        s = self.session
        try:
            check(s.next_announce(timeout=15.0) is not None, "moq: no announce")
            first = s.subscribe_track(catalog.CATALOG_TRACK).read(timeout=10.0)
            check(first is not None, "moq: the catalog track produced no object")
            self.catalog = catalog.Catalog.from_bytes(first.payload)
            video = s.subscribe_track(catalog.VIDEO_TRACK)
            while not s.closed.is_set():
                tf = video.read(timeout=0.5)
                if tf is None:
                    if session_dead(video):
                        break
                    continue
                self.objects.append((time.monotonic(), tf))
        except Exception:  # noqa: BLE001 - reported by the phase's gates
            self.error = traceback.format_exc()

    def join(self, timeout):
        if self._thread is not None:
            self._thread.join(timeout=timeout)


def _moq_publisher_peer(conn, port, n, seconds, seed, wrong_token):
    """The publishers of phase 13a, in a child process: with `wrong_token`, a
    connection with a wrong token first (it must be refused), then n QUIC
    connections to the
    MoQ server at `port` (handshakes timed), one broadcast each with a
    catalog and one video track; on "go", each writes its objects at 30 fps
    (`moq_object`); on "close", closes every session and client and reports
    the threads left alive."""
    import traceback

    try:
        from smelter_tpu_torch.io.moq import catalog, wire
        from smelter_tpu_torch.io.moq.output import BroadcastPublisher
        from smelter_tpu_torch.io.moq.session import MoqSession
        from smelter_tpu_torch.io.quic import QuicClient

        before = _moq_threads()
        refused = None
        if wrong_token:
            bad = QuicClient("127.0.0.1", port, [wire.ALPN])
            session = None
            try:
                session = MoqSession(bad.connect(timeout=15.0), is_quic_client=True)
                session.start_client("moq_0", "a-wrong-token")
                session.wait_setup(timeout=5.0)
            except (ConnectionError, TimeoutError) as exc:
                refused = f"{type(exc).__name__}: {exc}"
            finally:
                if session is not None:
                    session.close()
                bad.close()
        n_objects = int(seconds * FPS)
        objects = [[moq_object(seed, i, k) for k in range(n_objects)] for i in range(n)]
        clients, sessions, producers, handshake_ms = [None] * n, [None] * n, [None] * n, [0.0] * n
        failures = []

        def open_broadcast(i):
            try:
                clients[i] = QuicClient("127.0.0.1", port, [wire.ALPN])
                t0 = time.monotonic()
                handle = clients[i].connect(timeout=30.0)
                handshake_ms[i] = (time.monotonic() - t0) * 1e3
                sessions[i] = MoqSession(handle, is_quic_client=True)
                publisher = BroadcastPublisher(sessions[i], f"broadcast_{i}")
                sessions[i].start_client(f"moq_{i}", f"token-{i}")
                sessions[i].wait_setup(timeout=15.0)
                cat = catalog.Catalog()
                cat.video[catalog.VIDEO_TRACK] = catalog.TrackEntry(
                    name=catalog.VIDEO_TRACK, codec="h264", container="loc", width=1920,
                    height=1080)
                publisher.set_catalog(cat)
                deadline = time.monotonic() + 15.0
                while publisher.producer(catalog.VIDEO_TRACK) is None:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"broadcast {i}: the video track was never subscribed")
                    time.sleep(0.01)
                producers[i] = publisher.producer(catalog.VIDEO_TRACK)
            except Exception:  # noqa: BLE001 - reported to the parent
                failures.append(traceback.format_exc())

        for t in _threads([(open_broadcast, (i,)) for i in range(n)]):
            t.join(timeout=60)
        if failures or None in producers:
            raise ConnectionError(f"publishers not ready: {failures[:1]}")
        conn.send(("ready", dict(handshake_ms=handshake_ms, wrong_token=refused)))
        conn.recv()  # "go"
        writes = {}
        cpu0 = time.process_time()
        t0 = time.monotonic() + 0.2

        def write(i):
            times = []
            for k, (ts, key, payload) in enumerate(objects[i]):
                time.sleep(max(0.0, t0 + k / FPS - time.monotonic()))
                times.append(time.monotonic())
                producers[i].write(ts, key, payload, new_group=key)
            producers[i].finish_group()
            writes[i] = times

        writers = _threads([(write, (i,)) for i in range(n)])
        for t in writers:
            t.join(timeout=seconds + 60)
        conn.send(("written", dict(t0=t0, writes=writes, cpu_s=time.process_time() - cpu0,
                                   writers_alive=sum(t.is_alive() for t in writers))))
        conn.recv()  # "close"
        for s in sessions:
            s.close()
        for c in clients:
            c.close()
        conn.send(("closed", dict(threads_alive=_moq_threads_end(before, 10.0 if wrong_token
                                                                 else 2.0))))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        conn.send(("error", traceback.format_exc()))
        raise


def moq_transport_phase(stamp, n=MOQ_INPUTS, seconds=MOQ_SECONDS, seed=13,
                        deadline_s=MOQ_DEADLINE_S, gated=True):
    """Phase 13a: the port's MoQ transport, no codec. The port's `MoqServer`
    runs in this process, its registered inputs plain subscribers
    (`_MoqSubscriber`); a child process (`_moq_publisher_peer`) opens n QUIC
    connections through the port's `QuicClient`, `MoqSession` and
    `BroadcastPublisher`, one broadcast each (a catalog and a video track),
    and writes 30 objects/s for `seconds`: a one-second group per keyframe
    object of 100 kB, then 29 delta objects of 20 kB (5 Mbit/s, a 1080p30
    H.264 stream's rate), payloads drawn from a seed.

    Always gated: every object that arrives is byte-equal, with its keyframe
    flag, in its group, in order within its group and never twice. With
    `gated`, also: a wrong token is refused, every object arrives by
    `deadline_s` after the last write, and every session and both endpoints
    close with none of their threads left alive on either side (without it,
    no wrong token is tried, and the objects that arrived and the threads
    left are recorded). Recorded:
    the share of the objects delivered, objects/s and MB/s delivered from
    the first write to the last arrival, the write -> read latency of the
    objects (p50, p95, on the machine's monotonic clock, which both
    processes read), the handshakes' ms (p50, max), and the CPU seconds of
    each process from the first write to the end of the wait. Returns the
    recorded numbers."""
    import multiprocessing

    from smelter_tpu_torch.io.moq.server import MoqServer, MoqServerState
    from smelter_tpu_torch.io.quic.tls import generate_self_signed

    t_run = time.perf_counter()
    before = _moq_threads()
    threads_at_start = threading.active_count()
    state = MoqServerState()
    subs = [_MoqSubscriber(f"token-{i}") for i in range(n)]
    for i, sub in enumerate(subs):
        state.register(f"moq_{i}", sub)
    cert, key = generate_self_signed()
    server = MoqServer(0, state, cert_der=cert, key_pem=key)
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    peer = ctx.Process(target=_moq_publisher_peer, name="moq-peer", daemon=True,
                       args=(child_conn, server.port, n, seconds, seed, gated))
    n_objects = int(seconds * FPS)
    try:
        peer.start()
        ready = _peer_message(conn, peer, 180, "the publishers' handshakes", "moq")[1]
        cpu0 = time.process_time()
        conn.send(("go",))
        written = _peer_message(conn, peer, seconds + 120, "the publishers' last write", "moq")[1]
        t_last = max(max(w) for w in written["writes"].values())
        while (sum(len(s.objects) for s in subs) < n * n_objects
               and time.monotonic() < t_last + deadline_s):
            time.sleep(0.05)
        cpu_s = time.process_time() - cpu0
        conn.send(("close",))
        closed = _peer_message(conn, peer, 60, "the publishers' close", "moq")[1]
    finally:
        for sub in subs:
            if sub.session is not None:
                sub.session.close()
        server.close()
        peer.join(timeout=30)
        if peer.is_alive():
            peer.kill()
            peer.join(timeout=10)
    for sub in subs:
        sub.join(timeout=10)
    check(peer.exitcode == 0, f"moq: the publishers' process exited with {peer.exitcode}")
    check(not gated or ready["wrong_token"] is not None, "moq: a wrong token was accepted")
    check(written["writers_alive"] == 0, "moq: a publisher hung")
    errors = [s.error for s in subs if s.error]
    check(not errors, f"moq: a subscriber failed: {errors[:1]}")
    latency, bad, missing = [], [], {}
    for i, sub in enumerate(subs):
        seen, last_in_group = set(), {}
        for t, tf in sub.objects:
            k = round(tf.timestamp_us * FPS / 1e6)
            ts, key, payload = moq_object(seed, i, k) if 0 <= k < n_objects else (None,) * 3
            if (ts != tf.timestamp_us or key != tf.keyframe or payload != tf.payload
                    or tf.group_seq != k // FPS or k in seen
                    or last_in_group.get(tf.group_seq, -1) >= k):
                bad.append((i, k, tf.group_seq, tf.keyframe, len(tf.payload)))
            seen.add(k)
            last_in_group[tf.group_seq] = k
            if k in range(len(written["writes"][i])):
                latency.append((t - written["writes"][i][k]) * 1e3)
        if n_objects - len(seen):
            missing[i] = n_objects - len(seen)
        if sub.objects:
            check(sub.catalog is not None and sub.catalog.first_video().codec == "h264",
                  f"moq: input {i}: no catalog")
    check(not bad, f"moq: objects wrong, repeated or out of order in their group "
                   f"(input, object, group, keyframe, bytes): {bad[:8]}")
    left = _moq_threads_end(before, 10.0 if gated else 2.0)
    if gated:
        check(not missing, f"moq: objects that never arrived within {deadline_s} s of the last "
                           f"write, by input: {missing}")
        check(not closed["threads_alive"],
              f"moq: publisher threads left alive: {closed['threads_alive']}")
        check(not left, f"moq: server threads left alive: {left}")
    arrivals = [t for s in subs for t, _ in s.objects]
    t0 = written["t0"]
    span = max(arrivals, default=t0) - t0
    n_bytes = sum(len(tf.payload) for s in subs for _, tf in s.objects)
    latency.sort()
    hs = sorted(ready["handshake_ms"])
    out = dict(inputs=n, seconds=seconds, gated=gated, deadline_s=deadline_s,
               socket_buffers=_socket_buffers(),
               objects=n * n_objects, delivered=len(arrivals) / (n * n_objects),
               bytes=n_bytes, offered_mb_per_s=n * sum(
                   len(moq_object(seed, 0, k)[2]) for k in range(FPS)) / 1e6,
               objects_per_s=len(arrivals) / span if span > 0 else 0.0,
               mb_per_s=n_bytes / span / 1e6 if span > 0 else 0.0,
               latency_p50_ms=statistics.median(latency) if latency else None,
               latency_p95_ms=latency[int(0.95 * (len(latency) - 1))] if latency else None,
               latency_max_ms=latency[-1] if latency else None,
               last_arrival_after_last_write_s=(max(arrivals) - t_last) if arrivals else None,
               handshake_p50_ms=statistics.median(hs), handshake_max_ms=hs[-1],
               receiver_cpu_s=cpu_s, publisher_cpu_s=written["cpu_s"],
               wrong_token=ready["wrong_token"], threads_left=closed["threads_alive"] + left,
               threads_at_start=threads_at_start,
               run_s=time.perf_counter() - t_run, card=stamp)
    print(f"moq transport {n} x {seconds} s: delivered {out['delivered']:.1%}, "
          f"{out['objects_per_s']:.1f} objects/s, {out['mb_per_s']:.2f} MB/s of "
          f"{out['offered_mb_per_s']:.2f} offered, latency p50 {out['latency_p50_ms']} ms, "
          f"CPU receiver {cpu_s:.1f} s, publishers {written['cpu_s']:.1f} s {stamp}")
    return out


def _moq_media_peer(conn, n, in_w, in_h, out_w, out_h, seconds):
    """The publishers and the receiver of phase 13b, in a child process:
    encodes the inputs' clips (`_edge_clips`), starts a `MoqServer` with a
    `MoqServerInput` (token "out-token") that decodes what the server's
    `moq_client` output publishes, reports its port, publishes every input
    at 30 fps from the parent's "go" through the port's `MoqClientOutput`
    (inputs 0 and 1 in the CMAF container, the others legacy), and on
    "stop" returns each received frame's `edge_frame_stats` and arrival.
    Each publisher connects and waits for the server to subscribe to its
    track before the first write: it drops what it writes before."""
    import traceback
    from types import SimpleNamespace

    try:
        from smelter_tpu_torch.io.moq import catalog
        from smelter_tpu_torch.io.moq.input import MoqServerInput, MoqServerInputOptions
        from smelter_tpu_torch.io.moq.output import MoqClientOutput
        from smelter_tpu_torch.io.moq.server import MoqServer, MoqServerState
        from smelter_tpu_torch.io.quic.tls import generate_self_signed
        from smelter_tpu_torch.io.rtmp.h264_utils import extract_parameter_sets
        from smelter_tpu_torch.pipeline.input import InputCtx
        from smelter_tpu_torch.utils.channels import Channel, Closed

        clips = _edge_clips(n, in_w, in_h, seconds)
        state = MoqServerState()
        source = MoqServerInput(MoqServerInputOptions(auth_token="out-token"))
        channel = Channel(64)
        source.start(InputCtx(input_id="out", video_channel=channel, audio_channel=None))
        state.register("out", source)
        cert, key = generate_self_signed()
        server = MoqServer(0, state, cert_der=cert, key_pem=key)
        probes = edge_probes(n, out_w, out_h)
        frames = []

        def receive():
            while True:
                try:
                    f = channel.recv(timeout=0.5)
                except TimeoutError:
                    continue
                except Closed:
                    return
                t = time.monotonic()
                y, u, v = f.data
                frames.append(dict(pts=f.pts, arrival=t,
                                   **edge_frame_stats(y, u, v, n, out_w, out_h, probes)))

        receiver = threading.Thread(target=receive, name="moq-receiver", daemon=True)
        receiver.start()
        conn.send(("ready", server.port))
        _, targets = conn.recv()
        sent, sinks = {}, [None] * n

        def open_sink(i):
            sps, pps = extract_parameter_sets(clips[i][0].data)
            sink = MoqClientOutput(targets[i]["url"], f"input_{i}",
                                   container=targets[i]["container"], has_audio=False)
            opts = SimpleNamespace(encoder=SimpleNamespace(codec="h264"),
                                   resolution=SimpleNamespace(width=in_w, height=in_h))
            sink.setup_video(opts, b"\x00\x00\x00\x01" + sps + b"\x00\x00\x00\x01" + pps, FPS, 1)
            # a publisher drops what it writes before the track's subscription
            deadline = time.monotonic() + 15.0
            while sink.publisher.producer(catalog.VIDEO_TRACK) is None:
                check(time.monotonic() < deadline, f"moq: input_{i} never subscribed")
                time.sleep(0.01)
            sinks[i] = sink

        for t in _threads([(open_sink, (i,)) for i in range(n)]):
            t.join(timeout=60)
        check(None not in sinks, "moq: a publisher did not connect")

        def publish(i):
            times = []
            for k, p in enumerate(clips[i]):
                time.sleep(max(0.0, t0 + k / FPS - time.monotonic()))
                times.append(time.monotonic())
                sinks[i].write_video_packet(p)
            sinks[i].on_done()
            sent[i] = times

        t0 = time.monotonic() + 0.5
        publishers = _threads([(publish, (i,)) for i in range(n)])
        for t in publishers:
            t.join(timeout=seconds + 60)
        conn.send(("sent", dict(t0=t0, t_end=time.monotonic(),
                                senders_alive=sum(t.is_alive() for t in publishers),
                                frames_sent={i: len(sent[i]) for i in sent})))
        conn.recv()  # "stop": the parent has unregistered the output
        source.stop()
        source.join(timeout=10)
        receiver.join(timeout=10)
        server.close()
        conn.send(("result", dict(frames=frames, send0=sent.get(0, []))))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the phase
        conn.send(("error", traceback.format_exc()))
        raise


def moq_media_phase(dev, stamp, n=MOQ_MEDIA_INPUTS, in_w=IN_W, in_h=IN_H, out_w=OUT_W,
                    out_h=OUT_H, seconds=MOQ_MEDIA_SECONDS, update_at=MOQ_MEDIA_UPDATE_AT):
    """Phase 13b: the port's server (`smelter_tpu_torch.server.app`) in this
    process, in real time, composing n 1080p H.264 `moq_server` inputs, all
    registered over HTTP on the server's one shared MoQ listener, that a
    child process (`_moq_media_peer`) publishes at 30 fps for `seconds`
    through the port's `MoqClientOutput` (inputs 0 and 1 in the CMAF
    container, the others legacy; the frames of `edge_frame`, input 0's
    carrying its index); `renderer_scene` as wire JSON, updated at
    `update_at` s; the 4K H.264 output published through a `moq_client`
    output, registered over HTTP, to a `MoqServer` + `MoqServerInput` in the
    child, which decodes it. The caller has checked that the codec service
    loads (`edges_unavailable`).

    Gated: every registration (`{"port": P}`, one P for every input), the
    update and the unregisters answer as in phase 12; no OUTPUT_ERROR and no
    input's video ends while the publishers send; `live_frame_checks` (>= 15 frames/s
    of out_w x out_h, each tile its input's colour); `live_render_checks`
    (K1 = K2 = 1 per render not frozen, K3 only after the update, no
    synchronising call on a replay); /status empty at the end. Recorded:
    frames/s received, the send -> arrival latency of input 0's frames,
    each server decoder's delay in frames and the spans. Returns (the
    kernel launches of the run, the recorded numbers)."""
    import multiprocessing
    import shutil
    import tempfile

    import torch

    from smelter_tpu_torch.config import Config, LoggerConfig
    from smelter_tpu_torch.core.types import Framerate
    from smelter_tpu_torch.io.quic.tls import generate_self_signed
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
    from smelter_tpu_torch.server.app import ApiState
    from smelter_tpu_torch.utils import tracing

    t_run = time.perf_counter()
    on_card = torch.device(dev).type == "cuda"
    tls_dir = tempfile.mkdtemp(prefix="moq-tls-")
    cert, key = generate_self_signed()
    cert_file, key_file = os.path.join(tls_dir, "cert.der"), os.path.join(tls_dir, "key.pem")
    for path, data in ((cert_file, cert), (key_file, key)):
        with open(path, "wb") as f:
            f.write(data)
    ctx = multiprocessing.get_context("spawn")
    conn, child_conn = ctx.Pipe()
    peer = ctx.Process(target=_moq_media_peer, name="moq-media-peer", daemon=True,
                       args=(child_conn, n, in_w, in_h, out_w, out_h, seconds))
    peer.start()
    state = ApiState(Config(output_framerate=Framerate(FPS), ahead_of_time_processing=False,
                            never_drop_output_frames=False, moq_disable_tls_verification=True,
                            moq_tls_cert_file=cert_file, moq_tls_key_file=key_file,
                            logger=LoggerConfig(level="warning")))
    check(state.pipeline.renderer.options.async_compile,
          "moq: a live server must capture in the background")
    log = RenderLog(state.pipeline.renderer, keep_calls=False)
    server = _ApiServer(state)
    decoder_log = _DecoderLog().__enter__()
    try:
        ports = []
        for i in range(n):
            status, reply = server.call("POST", f"/api/input/input_{i}/register",
                                        {"type": "moq_server", "auth_token": f"token-{i}"})
            check(status == 200 and sorted(reply) == ["port"], f"moq: input_{i}: {status} {reply}")
            ports.append(reply["port"])
        check(len(set(ports)) == 1 and ports[0] == state.moq_server.port,
              f"moq: the inputs do not share the server's listener: {ports}")
        targets = [{"url": f"moql://127.0.0.1:{ports[0]}/input_{i}?token=token-{i}",
                    "container": "cmaf" if i < 2 else "legacy"} for i in range(n)]
        rx_port = _peer_message(conn, peer, 300, "the receiver's start", "moq")[1]
        status, reply = server.call("POST", "/api/output/out/register", {
            "type": "moq_client", "endpoint_url": f"moql://127.0.0.1:{rx_port}/out?token=out-token",
            "broadcast_path": "composed", "container": "cmaf",
            "video": {"resolution": {"width": out_w, "height": out_h},
                      "encoder": {"type": "ffmpeg_h264", "preset": "ultrafast"},
                      "initial": {"root": edge_scene_wire(out_w, out_h, n, 0)}}})
        check((status, reply) == (200, {}), f"moq: output: {status} {reply}")
        scene_assembly.LAUNCHES = yuv_out.LAUNCHES = sdf_layers.LAUNCHES = 0
        tracing.reset()
        status, reply = server.call("POST", "/api/start", {})
        check((status, reply) == (200, {}), f"moq: start: {status} {reply}")
        with log.capture_syncs() if on_card else contextlib.nullcontext():
            conn.send(("go", targets))
            t_go = time.perf_counter()
            time.sleep(max(0.0, t_go + update_at - time.perf_counter()))
            t_update = time.perf_counter()
            status, reply = server.call("POST", "/api/output/out/update",
                                        {"video": {"root": edge_scene_wire(out_w, out_h, n, 1)}})
            check((status, reply) == (200, {}), f"moq: update: {status} {reply}")
            t_updated = time.perf_counter()
            time.sleep(max(0.0, t_go + seconds - 1.0 - time.perf_counter()))
            events_live = [(e.kind, e.entity_id) for e in state.pipeline.events.history()]
            sent = _peer_message(conn, peer, 120, "the publishers' end", "moq")[1]
            time.sleep(EDGE_TAIL_S)
        launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                    "sdf_layers": sdf_layers.LAUNCHES}
        spans = tracing.report()
        status, reply = server.call("POST", "/api/output/out/unregister", {})
        check((status, reply) == (200, {}), f"moq: output unregister: {status} {reply}")
        for i in range(n):
            status, reply = server.call("POST", f"/api/input/input_{i}/unregister", {})
            check((status, reply) == (200, {}), f"moq: input_{i} unregister: {status} {reply}")
        status, st = server.call("GET", "/status")
        check(status == 200 and st["inputs"] == [] and st["outputs"] == [],
              f"moq: /status after the unregisters: {st}")
        check(state.moq_state.find("input_0") is None, "moq: an unregistered input kept its name")
        conn.send(("stop",))
        result = _peer_message(conn, peer, 300, "the receiver's report", "moq")[1]
    finally:
        decoder_log.__exit__(None, None, None)
        state.pipeline.close()
        if state.moq_server is not None:
            state.moq_server.close()
        server.stop()
        shutil.rmtree(tls_dir, ignore_errors=True)
        peer.join(timeout=30)
        if peer.is_alive():
            peer.kill()
            peer.join(timeout=10)
    check(peer.exitcode == 0, f"moq: the peer exited with {peer.exitcode}")
    check(sent["senders_alive"] == 0, "moq: a publisher hung")
    # the broadcasts carry no audio track: each input's audio ends at once
    bad = [e for e in events_live if e[0] in ("OUTPUT_ERROR", "VIDEO_INPUT_EOS")]
    check(not bad, f"moq: events before the publishers finished: {bad}")
    received = live_frame_checks("moq", result["frames"], n, out_w, out_h, seconds,
                                 sent["t0"], sent["t_end"], result["send0"])
    renders = live_render_checks("moq", log, t_update, t_updated, on_card)
    out = dict(inputs=n, containers={c: [t["container"] for t in targets].count(c)
                                     for c in ("cmaf", "legacy")},
               out=f"{out_w}x{out_h}", seconds=seconds, **received, **renders,
               **live_spans(spans), decoders=decoder_stats(decoder_log),
               frames_sent=sent["frames_sent"], run_s=time.perf_counter() - t_run, card=stamp)
    print(f"moq media {n}x{in_w}x{in_h}->{out_w}x{out_h}: launches {launches}")
    return launches, out


def moq_transport(stamp):
    """Phase 13a: the gated run and the capacity runs of
    `moq_transport_phase`, timed against the part's 60 s budget (recorded;
    the run fails past MOQ_TRANSPORT_CEILING_S, which keeps the script well
    inside its watchdog whatever the host's speed)."""
    t_phase = time.perf_counter()
    transport = {"gated": moq_transport_phase(stamp)}
    for n in MOQ_CAPACITY_INPUTS:
        transport[f"capacity_{n}"] = moq_transport_phase(
            stamp, n=n, deadline_s=MOQ_CAPACITY_WAIT_S, gated=False)
    transport.update(phase_s=time.perf_counter() - t_phase, budget_s=60.0)
    check(transport["phase_s"] < MOQ_TRANSPORT_CEILING_S,
          f"moq: the transport took {transport['phase_s']:.1f} s")
    return transport


def moq_phase(dev, stamp, transport):
    """Phase 13: with 13a's numbers (`moq_transport`), the media path (13b)
    where the codec service loads (`edges_unavailable`, one probe); prints
    `{"moq": {"transport": ..., "media": ...}}`. Returns (the media path's
    kernel launches or None when it is skipped, the printed numbers)."""
    why = edges_unavailable()
    launches = None
    if why is None:
        t_media = time.perf_counter()
        launches, media = moq_media_phase(dev, stamp)
        check(time.perf_counter() - t_media < 120, "moq: the media path took more than 120 s")
    else:
        media = {"skipped": why}
    out = {"transport": transport, "media": media}
    print(json.dumps({"moq": out}))
    return launches, out


def live_frame_checks(label, frames, n, out_w, out_h, seconds, t0, t_end, send0):
    """The gates of a live phase on the output frames its peer received
    (`edge_frame_stats` with an `arrival` time each): every frame out_w x
    out_h, at least 15 a second; from the first frame in which every tile
    probe that no overlay can reach shows its input's colour (mean Y, U, V
    within 6), every frame received before the senders finished shows them,
    and every tile shows its input's colour in some frame. Returns the
    numbers: frames/s received over [t0, t_end] and the latency from an
    input 0 frame's send (`send0[k]`) to the arrival of the first output
    frame that shows its index k."""
    check(all(f["shape"] == [[out_h, out_w], [out_h // 2, out_w // 2]] for f in frames),
          f"{label}: a received frame of another size")
    check(len(frames) >= 15 * seconds,
          f"{label}: {len(frames)} frames received in {seconds} s, fewer than 15 a second")
    probes = edge_probes(n, out_w, out_h)
    colours = [edge_colour(i) for i in range(n)]

    def shows(f, i):
        return all(abs(a - b) <= 6 for a, b in zip(f["tiles"][i], colours[i]))

    free = [i for i, p in enumerate(probes) if not p[3]]
    check(free, f"{label}: every tile probe lies under an overlay's path")
    live = [f for f in frames if f["arrival"] is not None and f["arrival"] < t_end]
    first = next((k for k, f in enumerate(live) if all(shows(f, i) for i in free)), None)
    check(first is not None, f"{label}: no frame shows every uncovered tile's input")
    off = [(k, i, [round(x, 1) for x in live[k]["tiles"][i]]) for k in range(first, len(live))
           for i in free if not shows(live[k], i)]
    check(not off, f"{label}: tiles off their input's colour (frame, tile, YUV): {off[:8]}")
    never = [i for i in range(n) if not any(shows(f, i) for f in frames)]
    check(not never, f"{label}: tiles that never show their input's colour: {never}")
    arrivals = sorted(f["arrival"] for f in frames if f["arrival"] is not None)
    in_window = [t for t in arrivals if t0 <= t <= t_end]
    fps = ((len(in_window) - 1) / (in_window[-1] - in_window[0])
           if len(in_window) > 1 else 0.0)
    first_show = {}
    for f in frames:
        if f["index"] is not None and f["arrival"] is not None:
            first_show.setdefault(f["index"], f["arrival"])
    lat = sorted((t - send0[k]) * 1e3 for k, t in first_show.items() if k < len(send0))
    return dict(frames_received=len(frames), fps_received=fps,
                latency_p50_ms=statistics.median(lat) if lat else None,
                latency_p95_ms=lat[int(0.95 * (len(lat) - 1))] if lat else None,
                latency_frames=len(lat), first_all_tiles_frame=first)


def live_render_checks(label, log, t_update, t_updated, on_card):
    """The gates of a live phase on its renders (`RenderLog`): on the card,
    K1 and K2 once in every render that was not frozen (its own launches, on
    the renderer thread: a background capture's warm-up counts on its
    thread), K3 in a render after the update and in none before, and no
    synchronising call on the renderer thread in a render that replayed a
    graph. Returns the counts of renders."""
    per = log.frames
    rendered = [f for f in per if f["outputs"] and not f["frozen"]]
    frozen_after = [f for f in per if f["frozen"] and f["t"] > t_updated]
    k3_before = [f["pts"] for f in per if f["k3"] and f["t"] < t_update]
    if on_card:
        check(rendered and all(f["k1"] == 1 and f["k2"] == 1 for f in rendered),
              f"{label}: K1/K2 not once per render: {[(f['k1'], f['k2']) for f in rendered]}")
        check(any(f["k3"] for f in rendered if f["t"] > t_updated),
              f"{label}: K3 never ran on the update's animating frames")
        check(not k3_before, f"{label}: K3 ran before the update, pts {k3_before}")
        replays = {k for k, f in enumerate(per) if not f["built"] and not f["frozen"]}
        synced = sorted({k for name, k in log.syncs if name == "renderer" and k in replays})
        check(not synced, f"{label}: the renderer thread synchronised on replays {synced}")
    return dict(frozen_by_update=len(frozen_after), renders=len(per), rendered=len(rendered))


def live_spans(spans):
    """The render, fetch-host and encode spans of a live run's
    `tracing.report()`."""
    def span(name):
        s = spans.get(name, {})
        return {k: s.get(k) for k in ("count", "p50_ms", "p95_ms", "avg_ms")}

    return dict(render=span("render.frame"), fetch_host=span("render.fetch_host"),
                encode=span("codec.video_encode"))


def decoder_stats(decoder_log):
    """Each logged decoder's sends, frames, frames held back at the end and
    delay in frames (`_DecoderLog`)."""
    return [dict(thread=d["thread"], sent=d["sent"], decoded=d["out"],
                 held_at_end=d["sent"] - d["out"],
                 delay_frames_max=max(d["delays"], default=None),
                 delay_frames_p50=(statistics.median(d["delays"]) if d["delays"] else None))
            for d in decoder_log.decoders]


# the reference's three 4K goldens (tests/snapshots/res4k_*.png), too slow
# to render on the CPU in the test suite: rendered here on the card

GOLDEN_IN_W, GOLDEN_IN_H = 160, 90
GOLDEN_ALLOWED_ERROR = 1.0  # mean abs u8 error per channel (tests/harness.ALLOWED_ERROR)


def golden_input(index, w=GOLDEN_IN_W, h=GOLDEN_IN_H):
    """`tests/harness.make_test_input(index, (w, h))`, the port's copy
    (`smelter_tpu_torch.tools._inputs`): a solid hue per index, a white
    square at the top left and a black bar at the bottom, as planar YUV420
    (a host Frame of u8 planes)."""
    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.tools._inputs import make_test_input

    return make_test_input(index, Resolution(w, h))


def golden_scene(name):
    """(number of inputs, root component) of a 4K golden, built with the
    port's components as `tests/test_snapshots_extended.py` (res4k_tiles_16,
    res4k_general_rotated) and `tests/test_snapshots_round5.py`
    (res4k_general_bench16) build them."""
    from smelter_tpu_torch.core.types import RGBAColor
    from smelter_tpu_torch.scene import components as comp
    from smelter_tpu_torch.scene.layout_types import BorderRadius, BoxShadow

    inputs = [comp.InputStream(input_id=f"input_{i}") for i in range(16)]
    if name == "res4k_tiles_16":
        return 16, comp.Tiles(background_color=RGBAColor(16, 16, 16, 255), children=inputs)
    n, h, rotated = {"res4k_general_rotated": (8, 1020.0, {2: 30.0, 5: -15.0}),
                     "res4k_general_bench16": (16, 480.0, {5: 30.0, 10: -15.0})}[name]
    children = []
    for i in range(n):
        row, col = divmod(i, 4)
        shadow = ([BoxShadow(offset_x=10.0, offset_y=10.0, blur_radius=24.0,
                             color=RGBAColor(0, 0, 0, 160))] if i % 3 == 0 else [])
        children.append(comp.Rescaler(
            child=inputs[i], border_radius=BorderRadius(24.0, 24.0, 24.0, 24.0),
            border_width=4.0 if i % 2 else 0.0, border_color=RGBAColor(255, 255, 255, 220),
            box_shadow=shadow,
            position=comp.AbsolutePosition(width=900.0, height=h, top=float(row * (h + 60.0) + 30),
                                           left=float(col * 960 + 30),
                                           rotation_degrees=rotated.get(i, 0.0))))
    return n, comp.View(background_color=RGBAColor(8, 8, 8), children=children)


def goldens_4k_phase(dev, stamp):
    """Renders each 4K golden's scene (`golden_scene`, `golden_input`
    frames) with the port's renderer on the card into RGBA and holds it to
    the committed PNG: mean abs error per channel <= GOLDEN_ALLOWED_ERROR.
    Returns {golden: mean abs error}."""
    import numpy as np
    from PIL import Image

    from smelter_tpu_torch.core.types import FrameSet, PixelFormat, Resolution
    from smelter_tpu_torch.render.renderer import Renderer

    root = os.path.dirname(os.path.abspath(__file__))
    errors = {}
    for name in ("res4k_tiles_16", "res4k_general_rotated", "res4k_general_bench16"):
        n, scene = golden_scene(name)
        r = Renderer(device=dev)
        try:
            for i in range(n):
                r.register_input(f"input_{i}")
            r.update_scene("out", scene, Resolution(OUT_W, OUT_H), PixelFormat.RGBA)
            frames = {f"input_{i}": golden_input(i) for i in range(n)}
            out = r.render(FrameSet(pts=0.0, frames=frames)).frames["out"]
            rgb = out.data[..., :3].cpu().numpy().astype(np.float32)
        finally:
            r.close()
        with Image.open(os.path.join(root, "tests", "snapshots", f"{name}.png")) as png:
            golden = np.asarray(png.convert("RGB"), np.float32)
        check(golden.shape == rgb.shape, f"{name}: shape {rgb.shape} != {golden.shape}")
        errors[name] = float(np.abs(golden - rgb).mean())
        print(f"golden {name}: mean abs error {errors[name]:.4f} {stamp}")
    off = {k: v for k, v in errors.items() if v > GOLDEN_ALLOWED_ERROR}
    check(not off, f"4K goldens past a mean abs error of {GOLDEN_ALLOWED_ERROR}: {off}")
    return errors


# the multichip phase (15): the multi-device steps (`parallel/flagship.py`
# over `parallel/mesh.py`). (a) `dryrun_multichip` on 8 gloo ranks on the
# card's host: the exchange between ranks, which one card cannot show
# (NCCL refuses two ranks of a communicator on one card); (b) the steps at
# full width on the card, over NCCL, this process as rank 0 of a world of
# one (every card torch sees: one on the machine the records name)
MULTICHIP_BUDGET_S = 60.0  # the run fails past it
MULTICHIP_GENERAL_INPUTS = 8  # the reference's general step
MULTICHIP_OUTPUTS = 2


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def multichip_phase(dev, stamp):
    """Phase 15. (a) `dryrun_multichip(8, device="cpu")`: 8 gloo ranks on a
    2 x 4 mesh, gated on its own parity. (b) On the card (NCCL, world size
    `torch.cuda.device_count()`: this process alone on one card; with more,
    `dryrun_multichip` over NCCL runs too): the grid step at 16 x 1080p ->
    4K held <= 1 LSB to `make_flagship_compose` on the card (bit-equality
    reported), the general step at 8 x 1080p -> 4K held <= 1 LSB to
    `_make_general_compose` of its scene on the card and, at 8 x 480x270 ->
    960x540, to the port on the CPU, and the outputs-sharded step with 2
    outputs at 4K, each output equal to `make_flagship_compose` of its
    order of the inputs. The steps take the host planes, as a caller's;
    their kernel launches are counted over (b)'s three calls and nothing
    else. Prints each step's ms (CUDA events, median of ITERS after WARMUP,
    on planes already on the card) beside the single-device builder's, and
    each collective's ms and bytes. Returns (launches, numbers)."""
    import torch

    from smelter_tpu_torch import interop
    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.graft_entry import dryrun_multichip
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
    from smelter_tpu_torch.parallel import flagship, mesh as meshes
    from torch.distributed.device_mesh import init_device_mesh

    t_phase = time.perf_counter()
    numbers = {"dryrun_cpu": dryrun_multichip(8, device="cpu")}
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        numbers["dryrun_cuda"] = dryrun_multichip(n_cards)["seconds"]
    in_res, out_res = Resolution(IN_W, IN_H), Resolution(OUT_W, OUT_H)
    n_gen = MULTICHIP_GENERAL_INPUTS
    frames = host_frames(N_INPUTS, IN_W, IN_H, seed=15)
    gen_frames = tuple(p[:n_gen] for p in frames)
    dev_frames = interop.planes_to_device(frames, dev)
    dev_gen = tuple(p[:n_gen] for p in dev_frames)
    with meshes.process_group("cuda"):
        grid_mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("streams", "space"))
        out_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("outputs",))
        grid_step, _ = flagship.make_multichip_step(grid_mesh, N_INPUTS, in_res, out_res,
                                                    device=dev)
        gen_step, _ = flagship.make_multichip_general_step(grid_mesh, n_gen, in_res, out_res,
                                                           device=dev)
        out_step, out_args = flagship.make_multioutput_step(
            out_mesh, MULTICHIP_OUTPUTS, N_INPUTS, in_res, out_res, device=dev)
        perms = out_args[3]
        torch.cuda.synchronize()
        scene_assembly.LAUNCHES = yuv_out.LAUNCHES = sdf_layers.LAUNCHES = 0
        grid_out = interop.planes_to_host(grid_step(*frames))
        gen_out = interop.planes_to_host(gen_step(*gen_frames))
        outs = out_step(*frames, perms)
        torch.cuda.synchronize()
        launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                    "sdf_layers": sdf_layers.LAUNCHES}
        print(f"multichip path launches (grid, general and outputs-sharded steps): {launches}")
        check(launches["yuv_out"] > 0 and launches["sdf_layers"] > 0,
              f"multichip: the general step did not launch K2 and K3: {launches}")

        single_grid, _ = flagship.make_flagship_compose(N_INPUTS, in_res, out_res, device=dev)
        flat = flagship._scene_layouts(flagship._multichip_general_scene(n_gen, out_res),
                                       n_gen, in_res, out_res)
        single_gen, _ = flagship._make_general_compose(
            flagship._general_stages(flat, n_gen, out_res, dev), n_gen, in_res, dev)
        check_planes("multichip grid", grid_out, OUT_W, OUT_H)
        check_planes("multichip general", gen_out, OUT_W, OUT_H)
        for label, got, ref in (
                ("grid", grid_out, interop.planes_to_host(single_grid(*dev_frames))),
                ("general", gen_out, interop.planes_to_host(single_gen(*dev_gen)))):
            mx, n_diff, _, total = lsb_stats(ref, got)
            numbers[f"{label}_vs_one_device"] = dict(max_lsb=mx, pixels_differing=n_diff,
                                                     pixels=total)
            print(f"multichip {label} step (1x1 mesh) vs the single-device builder on the "
                  f"card: max {mx} LSB, {n_diff} of {total} pixels differ "
                  f"(bit-equal: {n_diff == 0})")
            check(mx <= 1, f"multichip {label}: {mx} LSB from one device")
        check(tuple(outs[0].shape) == (MULTICHIP_OUTPUTS, OUT_H, OUT_W),
              f"multichip outputs-sharded step: {tuple(outs[0].shape)}")
        for m, order in enumerate(perms.tolist()):
            idx = torch.tensor(order, device=dev)
            ref = single_grid(*(torch.index_select(p, 0, idx) for p in dev_frames))
            check(all(torch.equal(a, b[m]) for a, b in zip(ref, outs)),
                  f"multichip outputs-sharded step: output {m} differs from its compose")

        # the general step against the port on the CPU, at a quarter of the width
        small_in, small_out = Resolution(480, 270), Resolution(960, 540)
        small = host_frames(n_gen, 480, 270, seed=16)
        small_step, _ = flagship.make_multichip_general_step(grid_mesh, n_gen, small_in,
                                                             small_out, device=dev)
        flat = flagship._scene_layouts(flagship._multichip_general_scene(n_gen, small_out),
                                       n_gen, small_in, small_out)
        cpu_fn, _ = flagship._make_general_compose(
            flagship._general_stages(flat, n_gen, small_out, "cpu"), n_gen, small_in, "cpu")
        cpu = interop.planes_to_host(cpu_fn(*interop.planes_to_device(small, "cpu")))
        mx, n_diff, _, total = lsb_stats(cpu, interop.planes_to_host(small_step(*small)))
        numbers["general_vs_cpu_960x540"] = dict(max_lsb=mx, pixels_differing=n_diff,
                                                 pixels=total)
        print(f"multichip general step on the card vs the port on the CPU, "
              f"{n_gen}x480x270 -> 960x540: max {mx} LSB, {n_diff} of {total} pixels differ")
        check(mx <= 1, f"multichip general: card vs CPU off by {mx} LSB")

        # times: the steps beside one device, and each step's collective
        timed = {}
        grid_fields = grid_step.local(*dev_frames)
        gen_fields = gen_step.local(*dev_gen)
        bcast = [p.clone() for p in dev_frames]
        group = out_mesh.get_group("outputs")
        for label, step_fn, single_fn, collective, moved in (
                ("grid", lambda: grid_step(*dev_frames), lambda: single_grid(*dev_frames),
                 lambda: grid_step.gather(grid_fields), _nbytes(grid_fields)),
                ("general", lambda: gen_step(*dev_gen), lambda: single_gen(*dev_gen),
                 lambda: gen_step.gather(gen_fields), _nbytes(gen_fields)),
                ("outputs", lambda: out_step(*dev_frames, perms),
                 lambda: [single_grid(*dev_frames) for _ in range(MULTICHIP_OUTPUTS)],
                 lambda: [meshes.broadcast_from_first(p, group) for p in bcast],
                 _nbytes(bcast))):
            t_step, t_single, t_coll = cuda_ms(step_fn), cuda_ms(single_fn), cuda_ms(collective)
            timed[label] = dict(step_ms=t_step, one_device_ms=t_single, collective_ms=t_coll,
                                collective_bytes=moved)
            print(f"time multichip {label} step, 1x1 NCCL mesh: {t_step:.4f} ms, one device "
                  f"{t_single:.4f} ms; its collective {t_coll:.4f} ms for {moved} B a frame "
                  f"{stamp}")
        numbers["times"] = timed
        del grid_fields, gen_fields, bcast
    numbers["world_size"] = 1
    numbers["phase_s"] = time.perf_counter() - t_phase
    numbers["budget_s"] = MULTICHIP_BUDGET_S
    print(f"multichip phase: {numbers['phase_s']:.1f} s (budget {MULTICHIP_BUDGET_S:.0f} s)")
    check(numbers["phase_s"] < MULTICHIP_BUDGET_S,
          f"multichip phase took {numbers['phase_s']:.0f} s, past {MULTICHIP_BUDGET_S:.0f} s")
    return launches, numbers


# the benchmark phase (16): `python -m smelter_tpu_torch.bench` at the
# reference's sizes, then the gates the benchmark does not hold itself
BENCH_BUDGET_S = 90.0


def bench_phase(dev, stamp, n=N_INPUTS, in_w=IN_W, in_h=IN_H, out_w=OUT_W, out_h=OUT_H,
                iters=60):
    """`bench.main()` on the card (by default at its own sizes: 16 x 1080p ->
    4K, 60 iterations; it prints its JSON line), with every kernel count set to 0 just before it
    and read just after: K1 and K2 once per run of the general program (its
    replays, and the builder's and the capture's eager warm-ups), K3 never.
    Then, on programs built and captured as the benchmark builds them: a
    grid replay and a general replay bit-equal to their functions run
    eagerly (a general replay launching K1 and K2 once each), and each
    frame of a batched replay (B = 4 distinct frames) bit-equal to the
    grid's single compose of that frame. Fails past BENCH_BUDGET_S.
    Returns (the benchmark's launches, the phase's numbers)."""
    import numpy as np
    import torch
    from smelter_tpu_torch import bench, interop
    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
    from smelter_tpu_torch.parallel.flagship import (
        make_flagship_batched_compose,
        make_flagship_compose,
        make_flagship_general_compose,
    )
    from smelter_tpu_torch.render.capture import capture

    kernels = {"scene_assembly": scene_assembly, "yuv_out": yuv_out, "sdf_layers": sdf_layers}

    def counts():
        return {name: mod.LAUNCHES for name, mod in kernels.items()}

    def reset():
        for mod in kernels.values():
            mod.LAUNCHES = 0

    t_phase = time.perf_counter()
    reset()
    in_res, out_res = Resolution(in_w, in_h), Resolution(out_w, out_h)
    result = bench.main(device=dev, n_inputs=n, in_res=in_res, out_res=out_res, iters=iters)
    launches = counts()
    t_bench = time.perf_counter() - t_phase
    # the general program's runs: its replays, and the eager warm-ups of
    # its builder and of its capture
    general_runs = result["general_4k"]["replays"] + 2
    print(f"bench: {t_bench:.1f} s, launches {launches} ({general_runs} runs of the general "
          f"program) {stamp}")
    check(launches["scene_assembly"] == launches["yuv_out"] == general_runs,
          f"bench: K1/K2 launched {launches}, not once per run of the general program "
          f"({general_runs})")
    check(launches["sdf_layers"] == 0, f"bench: K3 launched {launches['sdf_layers']} times")
    check(result["card"] == nvidia_smi(), f"bench: card {result['card']!r}")

    frames = bench.host_frames(n, in_res)
    dev_frames = [interop.planes_to_device(f, dev) for f in frames]
    gates = {}
    for label, build in (("grid", make_flagship_compose),
                         ("general_4k", make_flagship_general_compose)):
        fn, _ = build(n, in_res, out_res, device=dev)
        prog, _ = capture(fn, dev_frames[0], dev)
        reset()
        replayed = interop.planes_to_host(prog(*dev_frames[1]))
        replay_launches = counts()
        eager = interop.planes_to_host(fn(*dev_frames[1]))
        gates[f"{label}_replay_vs_eager_lsb"] = mx = lsb_stats(eager, replayed)[0]
        print(f"bench {label}: replay vs eager max abs err {mx}, one replay launched "
              f"{replay_launches}")
        check(mx == 0, f"bench {label}: the replay differs from the eager function by {mx}")
        expected = (1, 1, 0) if label == "general_4k" else (0, 0, 0)
        check(tuple(replay_launches.values()) == expected,
              f"bench {label}: one replay launched {replay_launches}")
        if label == "grid":
            grid_fn = fn
        del prog
    bfn, _ = make_flagship_batched_compose(n, in_res, out_res, bench.BATCH, device=dev)
    order = (0, 1, 1, 0)[:bench.BATCH]
    shifted = [tuple(torch.roll(p, b, dims=0) for p in dev_frames[k])
               for b, k in enumerate(order)]  # each frame its own order of the inputs
    batch = tuple(torch.stack(planes) for planes in zip(*shifted))
    bprog, _ = capture(bfn, batch, dev)
    batched = interop.planes_to_host(bprog(*batch))
    worst = 0
    for b, single_args in enumerate(shifted):
        single = interop.planes_to_host(grid_fn(*single_args))
        worst = max(worst, lsb_stats(single, [p[b] for p in batched])[0])
    gates["batched_vs_single_lsb"] = worst
    print(f"bench batched ({bench.BATCH} frames in one replay) vs single frames: max abs err "
          f"{worst}")
    check(worst == 0, f"bench: a batched frame differs from its single compose by {worst}")
    check(all(np.isfinite(v) for k, v in result.items() if isinstance(v, float)),
          "bench: a non-finite number")
    del bprog, batch, shifted, dev_frames
    phase_s = time.perf_counter() - t_phase
    print(f"bench phase: {phase_s:.1f} s (budget {BENCH_BUDGET_S:.0f} s)")
    check(phase_s < BENCH_BUDGET_S,
          f"bench phase took {phase_s:.0f} s, past {BENCH_BUDGET_S:.0f} s")
    return launches, {"bench_s": t_bench, "phase_s": phase_s, "gates": gates,
                      "general_runs": general_runs,
                      "grid_device_p50_ms": result["device_p50_ms"]}


# the tools phase (17): each of `smelter_tpu_torch.tools`' measurement tools
# at the reference's default sizes, then the gates the tools do not hold
TOOLS_BUDGET_S = 150.0  # recorded
TOOLS_CEILING_S = 300.0  # the run fails past it
# the reference's defaults that a tool's main() runs by itself
TOOL_FRAMES = {"bench_scenes": 40, "tiles_relayout_8to9": 20, "animation": 30,
               "bench_flagship_ops": 40}


class StructureLog:
    """While installed (a `with` block), records every render of an
    `OutputProgram`: (the program's serial number, the structure keys the
    render added to its cache). Host bookkeeping only: no device work, no
    count. (A serial, not `id()`: a freed program's id is reused.)"""

    def __enter__(self):
        import itertools

        from smelter_tpu_torch.render.program import OutputProgram

        self._render = render = OutputProgram.render
        self.renders = []
        serials = itertools.count()

        def logged(prog, *args, **kw):
            before = set(prog._build_cache)
            out = render(prog, *args, **kw)
            serial = prog.__dict__.setdefault("_smoke_serial", next(serials))
            self.renders.append((serial, tuple(k for k in prog._build_cache
                                               if k not in before)))
            return out

        OutputProgram.render = logged
        return self

    def __exit__(self, *exc):
        from smelter_tpu_torch.render.program import OutputProgram

        OutputProgram.render = self._render
        return False

    def by_program(self):
        """[[the keys each render added] for each program, in first-render order]."""
        progs = {}
        for pid, added in self.renders:
            progs.setdefault(pid, []).append(added)
        return list(progs.values())


def key_changes(old, new, path="key", limit=6):
    """The leaves in which two structure keys differ, as "path: old -> new"
    (tuples by index, dataclasses by field)."""
    import dataclasses

    if old == new:
        return []
    if isinstance(old, tuple) and isinstance(new, tuple) and len(old) == len(new):
        out = []
        for i, (a, b) in enumerate(zip(old, new)):
            out += key_changes(a, b, f"{path}[{i}]", limit - len(out))
            if len(out) >= limit:
                break
        return out
    if dataclasses.is_dataclass(old) and type(old) is type(new):
        out = []
        for f in dataclasses.fields(old):
            out += key_changes(getattr(old, f.name), getattr(new, f.name),
                               f"{path}.{f.name}", limit - len(out))
            if len(out) >= limit:
                break
        return out
    return [f"{path}: {old!r} -> {new!r}"]


class _Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()

    def lines(self):
        return [json.loads(line) for line in "".join(self.text).splitlines() if line.strip()]


def tools_phase(dev, stamp, grid_device_p50_ms):
    """Phase 17: runs each measurement tool's `main()` on the card at the
    reference's default sizes (they print their JSON lines), with every
    kernel count set to 0 just before each tool and read just after. Gates:
    every line parses and none has an "error" key; `frames` is the number
    asked for; `bench_scenes` adds no structure key in its timed window;
    one frame of each of its scenes, replayed, is bit-equal to its program
    run eagerly; `bench_latency` has samples; `bench_flagship_ops`' grid
    `device_p50_ms` is within 10% of phase 16's grid replay (the same
    program: it cross-checks the profiler reader, whose measures of
    general_4k `profile_reader_check` then prints, and which must give
    every replay of one program but a trace's first the same count of
    device activities);
    `bench_overlap
    --no-codec` runs. The codec tools (`bench_offline`, `bench_streams`,
    `bench_overlap`'s codec stages) print {"skipped": ...} after one probe
    of the codec service where it cannot load. Returns (launches per tool,
    the phase's numbers)."""
    from smelter_tpu_torch.core.types import FrameSet, Resolution
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
    from smelter_tpu_torch.tools import (
        bench_animations,
        bench_flagship_ops,
        bench_latency,
        bench_offline,
        bench_overlap,
        bench_scenes,
        bench_streams,
    )
    from smelter_tpu_torch.tools._inputs import seeded_frame_sets
    from smelter_tpu_torch.tools._profile import card

    kernels = {"scene_assembly": scene_assembly, "yuv_out": yuv_out, "sdf_layers": sdf_layers}
    launches, lines, seconds = {}, {}, {}
    card_line = card(dev)
    t_phase = time.perf_counter()

    def run(label, main, argv):
        for mod in kernels.values():
            mod.LAUNCHES = 0
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            main(argv)
        seconds[label] = time.perf_counter() - t0
        launches[label] = {name: mod.LAUNCHES for name, mod in kernels.items()}
        lines[label] = tee.lines()
        check(lines[label], f"tools: {label} printed no line")
        for line in lines[label]:
            check("error" not in line, f"tools: {label} printed an error: {line}")
            check(line.get("card") == card_line, f"tools: {label} card {line.get('card')!r}")
        print(f"tools: {label} {seconds[label]:.1f} s, launches {launches[label]} {stamp}")
        return lines[label]

    with StructureLog() as scene_log:
        scenes = run("bench_scenes", bench_scenes.main, ["--ops"])
    check([line["scene"] for line in scenes] == list(bench_scenes.scene_defs()),
          "tools: bench_scenes did not print every scene")
    check(all(line["frames"] == TOOL_FRAMES["bench_scenes"] for line in scenes),
          f"tools: bench_scenes frames {[line['frames'] for line in scenes]}")
    late = [[k for k, added in enumerate(renders) if added and k >= bench_scenes.SETTLE_FRAMES]
            for renders in scene_log.by_program()]
    check(len(late) == len(scenes) and not any(late),
          f"tools: bench_scenes added structure keys in its timed window at renders {late}")
    # one replayed frame of each scene, held to its program run eagerly
    eager_checked = {}
    for name, (make, n) in bench_scenes.scene_defs().items():
        frames0, _ = seeded_frame_sets(n, Resolution(960, 540))
        r = bench_scenes.scene_renderer(make, n, Resolution(1920, 1080), dev)
        with EagerCheck(f"bench_scenes {name}") as eager:
            for k in range(2):
                r.render(FrameSet(pts=k / 60.0, frames=frames0))
        r.close()
        kinds = [kind for _, _, kind in eager.renders]
        check(kinds == ["capture", "replay"], f"tools: bench_scenes {name} renders {kinds}")
        eager_checked[name] = eager.report()["eager_mismatches"]

    with StructureLog() as anim_log:
        anims = run("bench_animations", bench_animations.main, [])
    check([line["frames"] for line in anims]
          == [TOOL_FRAMES["tiles_relayout_8to9"]] + [TOOL_FRAMES["animation"]] * 4,
          f"tools: bench_animations frames {[line['frames'] for line in anims]}")
    # each animation renders through two programs (its first scene's and
    # the transition's); the transition's renders: pts 0.2, then the burst
    programs = anim_log.by_program()
    check(len(programs) == 2 * len(anims), f"tools: bench_animations used {len(programs)} "
                                           f"programs for {len(anims)} animations")
    key_diffs = {}
    for line, renders in zip(anims, programs[1::2]):
        keys = [k for added in renders for k in added]
        burst = [(k, added) for k, added in enumerate(renders) if k >= 1 and added]
        diffs = []
        for k, added in burst:
            for key in added:
                prev = keys[keys.index(key) - 1]
                diffs.append({"render": k, "changes": key_changes(prev, key)})
        key_diffs[line["animation"]] = diffs
        if "retraces_during_animation" in line:  # the box animations
            check(len(diffs) == line["retraces_during_animation"],
                  f"tools: {line['animation']} retraces {line['retraces_during_animation']} "
                  f"against the keys logged in its burst: {diffs}")
    print(f"tools: bench_animations structure keys added in the burst: {json.dumps(key_diffs)}")

    (latency,) = run("bench_latency", bench_latency.main, [])
    check(latency["samples"] > 0, f"tools: bench_latency has no samples: {latency}")

    (grid,) = run("bench_flagship_ops", bench_flagship_ops.main, [])
    (general,) = run("bench_flagship_ops --general", bench_flagship_ops.main, ["--general"])
    for line in (grid, general):
        check(line["frames"] == TOOL_FRAMES["bench_flagship_ops"],
              f"tools: bench_flagship_ops frames {line['frames']}")
    ratio = grid["device_p50_ms"] / grid_device_p50_ms
    print(f"tools: bench_flagship_ops grid device_p50_ms {grid['device_p50_ms']} against phase "
          f"16's {grid_device_p50_ms} (x{ratio:.4f}) {stamp}")
    check(abs(ratio - 1.0) <= 0.10, f"tools: bench_flagship_ops grid {grid['device_p50_ms']} ms "
                                    f"is not within 10% of phase 16's {grid_device_p50_ms} ms")
    reader = profile_reader_check(dev, stamp)

    run("bench_overlap --no-codec", bench_overlap.main, ["--no-codec"])
    why = edges_unavailable()  # the one probe of the codec service
    skipped = {}
    for label, main, argv in (("bench_overlap", bench_overlap.main, []),
                              ("bench_offline", bench_offline.main, []),
                              ("bench_streams", bench_streams.main, ["--max", "2"])):
        if why is not None:
            skipped[label] = why
            print(json.dumps({"tool": label, "skipped": why}), flush=True)
        else:
            run(label, main, argv)
    phase_s = time.perf_counter() - t_phase
    print(f"tools phase: {phase_s:.1f} s (budget {TOOLS_BUDGET_S:.0f} s, recorded; fails past "
          f"{TOOLS_CEILING_S:.0f} s)")
    check(phase_s < TOOLS_CEILING_S, f"tools phase took {phase_s:.0f} s, past "
                                     f"{TOOLS_CEILING_S:.0f} s")
    return launches, {"phase_s": phase_s, "seconds": seconds, "lines": lines,
                      "skipped": skipped, "eager_mismatches": eager_checked,
                      "animation_key_changes": key_diffs,
                      "flagship_grid_vs_bench": ratio, "profile_reader": reader}


# phase 18: the 16-bit compose canvas (SMELTER_CANVAS_DTYPE) and the route
# switch of the canvas-opening run (SMELTER_SCENE_ASSEMBLY)
CANVAS_BUDGET_S = 90.0  # recorded
CANVAS_CEILING_S = 200.0  # the run fails past it
CANVAS_STORAGE = ("uint16", "float16", "bfloat16")
CANVAS_RENDER_FRAMES = 10


def _storage_dtype(name):
    """The torch dtype a SMELTER_CANVAS_DTYPE value names."""
    import torch

    from smelter_tpu_torch.ops.compose import _CANVAS_DTYPES

    return _CANVAS_DTYPES.get(name, torch.float32)


def _bits_differ(a, b):
    """Elements whose stored bits differ (16-bit storage compared as int16),
    a NaN of a float storage matching any NaN (torch and the card's
    intrinsics give NaN other payload bits)."""
    import torch

    view = torch.int16 if a.element_size() == 2 else torch.int32
    differ = a.view(view) != b.view(view)
    if a.is_floating_point():
        differ &= ~(torch.isnan(a) & torch.isnan(b))
    return int(differ.sum())


def k1_nan_case(dev):
    """A K1 case of NaN and +-Inf colours over an opaque background, which
    pins the 16-bit stores of NaN (u16 code 0) and +-Inf against the plain
    version. Each such member's region lies 20 px inside its rect, where its
    alpha is exactly 1, and the two are disjoint: a NaN colour times the
    zero alpha outside a rect is NaN, which the plain version paints over
    its whole region and the kernel's tile classes drop, so only there do
    the two agree by design."""
    import torch

    from smelter_tpu_torch.ops.hopper.scene_assembly import MemberSpec

    h, w = 200, 520
    nan, inf = float("nan"), float("inf")
    rows = [[0.0, 0.0, w, h, 0.0, 0, 0, 0, 0, 0.1, 0.1, 0.15, 1.0, 0, 0, 0, 0, 0, 0],
            [20.0, 30.0, 200.0, 100.0, 0.0, *[8.0] * 4, nan, 0.5, inf, 0.8, 0, 0, 0, 0, 0, 0],
            [60.0, 280.0, 200.0, 120.0, 0.0, *[6.0] * 4, 0.2, -inf, 0.4, 0.9, 0, 0, 0, 0, 0, 0]]
    specs = [MemberSpec("color", False, False, 0, (), region)
             for region in ((0, 0, h, w), (40, 50, 100, 210), (80, 300, 160, 460))]
    return ("NaN/Inf colours 520x200", (w, h), specs,
            torch.tensor(rows, dtype=torch.float32, device=dev))


def k2_canvases_16bit(dev, general_canvas, dtype):
    """(name, canvas) K2 cases in 16-bit storage `dtype`: the general_4k
    canvas and random canvases with headroom past [0, 1] at 1080p and 200 x
    520 (the 8-byte path), at 201 x 519 and 202 x 518 (W % 4 != 0: the quad
    path), inside a buffer 1 element off (2-byte aligned: the quad path) and
    4 elements off (8-byte aligned but not 16: the 8-byte path); for f16 and
    bf16 also a canvas with 5% NaN, +Inf and -Inf pixels."""
    import torch

    from smelter_tpu_torch.ops.compose import _canvas_encode

    gen = torch.Generator(device=dev).manual_seed(18)

    def rand(h, w):
        return _canvas_encode(torch.rand((4, h, w), generator=gen, device=dev) * 1.3 - 0.1,
                              dtype)

    def offset(h, w, k):
        buf = torch.empty(4 * h * w + k, dtype=dtype, device=dev)
        view = buf[k:].view(4, h, w)
        view.copy_(rand(h, w))
        return view

    cases = [("general_4k canvas", _canvas_encode(general_canvas, dtype)),
             ("random 1920x1080", rand(1080, 1920)), ("random 520x200", rand(200, 520)),
             ("random 519x201", rand(201, 519)), ("random 518x202", rand(202, 518)),
             ("520x200 at +1 element", offset(200, 520, 1)),
             ("520x200 at +4 elements", offset(200, 520, 4))]
    if dtype != torch.uint16:
        canvas = torch.rand((4, 200, 520), generator=gen, device=dev)
        bad = torch.tensor([float("nan"), float("inf"), -float("inf")], device=dev)
        which = torch.randint(0, 3, canvas.shape, generator=gen, device=dev)
        hit = torch.rand(canvas.shape, generator=gen, device=dev) < 0.05
        cases.append(("NaN/Inf 520x200", torch.where(hit, bad[which], canvas).to(dtype)))
    return cases


def canvas_kernel_checks(dev, k1_cases, general_canvas):
    """Phase 18a: K1 with each 16-bit store on `k1_cases` (the general_4k and
    renderer tables, the mixed case, the tile-class edge cases) and K2 on
    each 16-bit canvas of `k2_canvases_16bit`, both full ranges, each
    bit-equal to its plain version on the card."""
    import torch

    from smelter_tpu_torch.ops.hopper import scene_assembly as sa
    from smelter_tpu_torch.ops.hopper import yuv_out

    k1_cases = list(k1_cases) + [k1_nan_case(dev)]
    for name in CANVAS_STORAGE:
        dt = _storage_dtype(name)
        for case, res, specs, params in k1_cases:
            got = sa.assemble_scene_planar(res, specs, params, out_dtype=dt)
            torch.cuda.synchronize()
            ref = sa.assemble_scene_planar_plain(res, specs, params, dt)
            n = _bits_differ(got, ref)
            print(f"K1 {name} store vs plain {case} ({len(specs)} members, {res[0]}x{res[1]}): "
                  f"{n} of {got.numel()} values differ")
            check(got.dtype == dt and n == 0, f"K1 {name} store {case}: {n} values differ")
        for case, canvas in k2_canvases_16bit(dev, general_canvas, dt):
            for full_range in (False, True):
                got = yuv_out.rgba_cm_to_yuv420(canvas, full_range)
                torch.cuda.synchronize()
                ref = yuv_out.rgba_cm_to_yuv420_plain(canvas, full_range)
                n = sum(int((a != b).sum()) for a, b in zip(got, ref))
                print(f"K2 {name} load vs plain {case} full_range={full_range}: {n} pixels "
                      f"differ")
                check(n == 0, f"K2 {name} load {case} full_range={full_range}: {n} pixels "
                              f"differ")


def canvas_builders_phase(dev, stamp):
    """Phase 18b: the general_4k builder at 16 x 1080p -> 4K under each
    SMELTER_CANVAS_DTYPE (set while it is built and captured): the stored
    dtype (the canvas handed to the YUV420 output), K1 and K2 launched once
    per replay, each replay bit-equal to its function run eagerly; u16
    within 1 LSB of f32 (gated), f16 and bf16 recorded; each replay timed."""
    import torch

    from smelter_tpu_torch import interop
    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.ops import color_convert as cc
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
    from smelter_tpu_torch.parallel.flagship import make_flagship_general_compose
    from smelter_tpu_torch.render.capture import capture
    from smelter_tpu_torch.tools._ab import env

    dev_frames = interop.planes_to_device(host_frames(N_INPUTS, IN_W, IN_H), dev)
    outs, numbers = {}, {}
    convert = cc.planar_rgba_to_yuv420
    for name in ("float32",) + CANVAS_STORAGE:
        with env({"SMELTER_CANVAS_DTYPE": name}):
            fn, _ = make_flagship_general_compose(N_INPUTS, Resolution(IN_W, IN_H),
                                                  Resolution(OUT_W, OUT_H), device=dev)
            prog, _ = capture(fn, dev_frames, dev)
        stored = []
        cc.planar_rgba_to_yuv420 = lambda c, fr=False: (stored.append(c.dtype), convert(c, fr))[1]
        try:
            eager = interop.planes_to_host(fn(*dev_frames))
        finally:
            cc.planar_rgba_to_yuv420 = convert
        for mod in (scene_assembly, yuv_out, sdf_layers):
            mod.LAUNCHES = 0
        replay = interop.planes_to_host(prog(*dev_frames))
        launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                    "sdf_layers": sdf_layers.LAUNCHES}
        mx = lsb_stats(eager, replay)[0]
        t_replay = cuda_ms(lambda: prog(*dev_frames))
        print(f"canvas {name}: stored {stored}, launches per replay {launches}, replay vs "
              f"eager max {mx}, replay {t_replay:.4f} ms {stamp}")
        check(stored == [_storage_dtype(name)], f"canvas {name}: the canvas was {stored}")
        check(launches == {"scene_assembly": 1, "yuv_out": 1, "sdf_layers": 0},
              f"canvas {name}: launches per replay {launches}")
        check(mx == 0, f"canvas {name}: the replay differs from the eager function by {mx}")
        check_planes(f"canvas {name}", replay, OUT_W, OUT_H)
        outs[name] = replay
        numbers[name] = {"replay_ms": t_replay, "launches": launches}
        del prog
    for name in CANVAS_STORAGE:
        mx, n_diff, n_gt1, total = lsb_stats(outs["float32"], outs[name])
        numbers[name].update(max_lsb_vs_f32=mx, share_gt1=n_gt1 / total,
                             share_differ=n_diff / total)
        print(f"canvas {name} vs float32, general_4k 16x1080p->4K: max {mx} LSB, {n_diff} "
              f"of {total} pixels differ, {n_gt1} by 2+ "
              f"({'gated' if name == 'uint16' else 'recorded'})")
    check(numbers["uint16"]["max_lsb_vs_f32"] <= 1,
          f"canvas uint16 is {numbers['uint16']['max_lsb_vs_f32']} LSB off f32")
    return numbers


def canvas_renderer_phase(dev, frames):
    """Phase 18c: phase 6's renderer transition, CANVAS_RENDER_FRAMES frames
    after the update, under f32 and under u16 (set for the whole run, so
    every program is built under it): K3 runs on the decoded root; every
    frame within 1 LSB of the f32 run; every render held to its program run
    eagerly (`EagerCheck`)."""
    from smelter_tpu_torch import interop
    from smelter_tpu_torch.ops.hopper import sdf_layers
    from smelter_tpu_torch.tools._ab import env

    seqs, k3 = {}, {}
    for name in ("float32", "uint16"):
        sdf_layers.LAUNCHES = 0
        with env({"SMELTER_CANVAS_DTYPE": name}), EagerCheck(f"canvas {name} renderer") as eager:
            outs = render_transition(dev, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, frames,
                                     n_frames=CANVAS_RENDER_FRAMES)
        k3[name] = sdf_layers.LAUNCHES
        eager.report()
        seqs[name] = [interop.planes_to_host(p) for p in outs]
    worst = [lsb_stats(a, b)[:3] for a, b in zip(seqs["float32"], seqs["uint16"])]
    print(f"canvas uint16 renderer transition vs float32, per frame (max LSB, pixels differ, "
          f"by 2+): {worst}; K3 launches {k3}")
    check(k3["uint16"] > 0 and k3["uint16"] == k3["float32"],
          f"canvas renderer: K3 launches {k3}")
    check(max(w[0] for w in worst) <= 1, f"canvas renderer: u16 off f32 by {worst}")
    return {"frames": len(worst), "max_lsb_vs_f32": max(w[0] for w in worst),
            "k3_launches": k3}


def canvas_tools_phase(dev, stamp):
    """Phase 18d: `bench_canvas_ab` (u16, f16, bf16 and f32, u16 gated),
    `bench_assembly_ab` and `bench_align_ab` at the reference's defaults,
    each kernel count set to 0 just before each and read just after. Every
    line parses, none has "error", each names the card in "device", and
    each variant has rounds x iters frames."""
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
    from smelter_tpu_torch.tools import _ab, bench_align_ab, bench_assembly_ab, bench_canvas_ab
    from smelter_tpu_torch.tools._profile import card

    kernels = {"scene_assembly": scene_assembly, "yuv_out": yuv_out, "sdf_layers": sdf_layers}
    card_line = card(dev)
    launches, lines = {}, {}
    for label, main, argv in (
            ("bench_canvas_ab", bench_canvas_ab.main,
             ["--variants", "u16,f16,bf16,f32", "--gate", "u16"]),
            ("bench_assembly_ab", bench_assembly_ab.main, []),
            ("bench_align_ab", bench_align_ab.main, [])):
        for mod in kernels.values():
            mod.LAUNCHES = 0
        tee = _Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            main(argv)
        launches[label] = {name: mod.LAUNCHES for name, mod in kernels.items()}
        (line,) = tee.lines()
        lines[label] = line
        check("error" not in line, f"canvas tools: {label} printed an error: {line}")
        check(line["device"] == card_line, f"canvas tools: {label} device {line['device']!r}")
        frames = {tag: v["frames"] for tag, v in line["variants"].items()}
        check(set(frames.values()) == {_ab.ROUNDS * _ab.ITERS},
              f"canvas tools: {label} frames {frames}")
        print(f"canvas tools: {label} {time.perf_counter() - t0:.1f} s, launches "
              f"{launches[label]} {stamp}")
    return launches, lines


def canvas_storage_phase(dev, stamp, k1_cases, general_canvas, frames):
    """Phase 18: (a) `canvas_kernel_checks`, (b) `canvas_builders_phase`,
    (c) `canvas_renderer_phase`, (d) `canvas_tools_phase`; timed against
    CANVAS_BUDGET_S (recorded), failing past CANVAS_CEILING_S. Prints
    `{"canvas_storage": ...}`; returns (the tools' launches, the numbers)."""
    t_phase = time.perf_counter()
    canvas_kernel_checks(dev, k1_cases, general_canvas)
    builders = canvas_builders_phase(dev, stamp)
    renderer = canvas_renderer_phase(dev, frames)
    tool_launches, tool_lines = canvas_tools_phase(dev, stamp)
    phase_s = time.perf_counter() - t_phase
    print(f"canvas storage phase: {phase_s:.1f} s (budget {CANVAS_BUDGET_S:.0f} s, recorded; "
          f"fails past {CANVAS_CEILING_S:.0f} s)")
    check(phase_s < CANVAS_CEILING_S, f"canvas storage phase took {phase_s:.0f} s, past "
                                      f"{CANVAS_CEILING_S:.0f} s")
    numbers = {"phase_s": phase_s, "builders": builders, "renderer": renderer,
               "tools": tool_lines, "tool_launches": tool_launches}
    print(json.dumps({"canvas_storage": {**numbers, "card": nvidia_smi()}}), flush=True)
    return tool_launches, numbers


SOAK_BUDGET_S = 60.0  # recorded
SOAK_CEILING_S = 150.0  # the run fails past it
# (label, rounds, seconds a round, output, inputs): the reference tool's size,
# then 16:9 4K
SOAK_RUNS = (("720p", 2, 8.0, (1280, 720), (640, 360)),
             ("4K", 1, 12.0, (3840, 2160), (1920, 1080)))
CARD_CHECKS = ("torch", "CUDA card", "nvcc (sm_90a)", "kernels build")
FFMPEG_CHECK = "native smelter_io (FFmpeg)"
PROFILED_FRAMES = 10


def soak_cpu_frame(info, out):
    """The last frame a soak round showed (`soak_live.run_round`'s
    "last"), rendered by the port on the CPU: its scene, the round's
    inputs, its pts."""
    from smelter_tpu_torch.core.types import FrameSet, PixelFormat
    from smelter_tpu_torch.render.renderer import Renderer
    from smelter_tpu_torch.tools import soak_live

    last = info["last"]
    r = Renderer(device="cpu")
    try:
        for iid in info["inputs"]:
            r.register_input(iid)
        r.update_scene("out", soak_live.scene(last["angle"], last["wpx"], out), out,
                       PixelFormat.PLANAR_YUV420)
        planes = r.render(FrameSet(pts=last["pts"], frames=info["inputs"])).frames["out"].data
    finally:
        r.close()
    return tuple(p.numpy() for p in planes)


def soak_run(dev, stamp, label, rounds, seconds, out, in_res):
    """Phase 19a/b: `soak_live.run_round` on the card, `rounds` rounds of
    `seconds`, with the kernel counts set to 0 just before each round and
    read just after. Gates per round: no profiler active before or after;
    at least one update; every update's scene reached the output within its
    burst (not every frame of it frozen); every update captured at least
    one program in the background; the first replay of each update's
    program bit-equal to that program run eagerly (`EagerCheck`); the last
    frame shown within 1 LSB of the port on the CPU (`soak_cpu_frame`).
    Gates over the rounds: K1 and K2 launched. Returns (launches,
    numbers)."""
    import torch

    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
    from smelter_tpu_torch.tools import soak_live

    out, in_res = Resolution(*out), Resolution(*in_res)
    mods = {"scene_assembly": scene_assembly, "yuv_out": yuv_out, "sdf_layers": sdf_layers}
    launches = dict.fromkeys(mods, 0)
    rounds_out = []
    for i in range(rounds):
        name = f"soak {label} round {i + 1}/{rounds}"
        check(not torch.autograd._profiler_enabled(), f"{name}: a profiler is active")
        for m in mods.values():
            m.LAUNCHES = 0
        with EagerCheck(name, first_replay_only=True) as eager:
            info = soak_live.run_round(i, seconds, dev, out, in_res)
        counts = {k: m.LAUNCHES for k, m in mods.items()}
        check(not torch.autograd._profiler_enabled(), f"{name}: a profiler is active")
        for k, n in counts.items():
            launches[k] += n
        programs = eager.report()
        cpu = soak_cpu_frame(info, out)
        mx, n_diff, n_gt1, n_px = lsb_stats(cpu, info["last"]["planes"])
        ms = sorted(c["capture_ms"] for cs in info["captures"] for c in cs)
        graph_mb = [c["graph_bytes"] / 2**20 for cs in info["captures"] for c in cs]
        row = dict(frames=info["frames"], updates=info["updates"],
                   seconds=info["elapsed_s"], frames_per_s=info["frames"] / info["elapsed_s"],
                   replayed_per_s=(info["frames"] - sum(info["frozen_by_update"]))
                   / info["elapsed_s"],
                   frames_by_update=info["frames_by_update"],
                   frozen_by_update=info["frozen_by_update"],
                   captures_by_update=[len(cs) for cs in info["captures"]],
                   capture_ms_p50=statistics.median(ms) if ms else None,
                   capture_ms_max=max(ms) if ms else None, capture_ms=ms,
                   graph_mb_max=max(graph_mb) if graph_mb else None,
                   eager_compared=programs["eager_compared"], launches=counts,
                   last_vs_cpu=dict(max_abs=mx, pixels_differing=n_diff, pixels=n_px,
                                    pts=info["last"]["pts"], angle=info["last"]["angle"],
                                    wpx=info["last"]["wpx"]))
        print(f"{name} {out.width}x{out.height} from 2 x {in_res.width}x{in_res.height}: "
              f"{json.dumps(row)} {stamp}")
        rounds_out.append(row)
        check(info["updates"] >= 1, f"{name}: no structure update")
        never = [k for k, (n, fz) in enumerate(zip(info["frames_by_update"],
                                                   info["frozen_by_update"])) if fz >= n]
        check(not never, f"{name}: updates {never} never reached the output within their burst")
        uncaptured = [k for k, cs in enumerate(info["captures"]) if not cs]
        check(not uncaptured, f"{name}: updates {uncaptured} captured no program")
        check(programs["eager_compared"] == info["updates"],
              f"{name}: {programs['eager_compared']} first replays held to eager, "
              f"not one per update ({info['updates']})")
        check(mx <= 1, f"{name}: the last frame differs from the CPU by {mx} LSB")
    check(launches["scene_assembly"] > 0 and launches["yuv_out"] > 0,
          f"soak {label}: K1 or K2 never launched: {launches}")
    return launches, dict(rounds=rounds_out, seconds_a_round=seconds,
                          out=f"{out.width}x{out.height}", inputs=f"2 x {in_res.width}x{in_res.height}")


def profiled_offline_run(dev, out_w, out_h, n_frames=PROFILED_FRAMES):
    """An offline pipeline (ahead-of-time, never-drop) on `dev`: one raw
    YUV420 input of `n_frames` at 30 fps and out_w x out_h, in a tilted box
    over a background (the general route: K1, K2) of a raw YUV420 output,
    no codecs; run under whatever profiler setting the environment holds.
    Returns the frames delivered."""
    from smelter_tpu_torch.core.types import Framerate, Resolution, RGBAColor
    from smelter_tpu_torch.pipeline import (
        EndCondition, OutputVideoOptions, Pipeline, PipelineOptions, RawDataOutputSink,
        RegisterInputOptions, VideoEncoderOptions)
    from smelter_tpu_torch.pipeline.input import RawDataInput
    from smelter_tpu_torch.scene import components as comp

    p = Pipeline(PipelineOptions(output_framerate=Framerate(FPS), ahead_of_time_processing=True,
                                 never_drop_output_frames=True), device=dev)
    src = RawDataInput(has_video=True, has_audio=False)
    p.register_input("input_0", src, RegisterInputOptions(required=True, offset=0.0))
    sink = RawDataOutputSink()
    root = comp.View(background_color=RGBAColor(20, 20, 40), children=[comp.Rescaler(
        child=comp.InputStream(input_id="input_0"), position=comp.AbsolutePosition(
            width=out_w / 2, height=out_h / 2, top=out_h / 8, left=out_w / 8,
            rotation_degrees=10.0))])
    p.register_output("out", sink, video=OutputVideoOptions(
        resolution=Resolution(out_w, out_h), encoder=VideoEncoderOptions(codec="raw"),
        initial_root=root, end_condition=EndCondition(all_inputs=True)))
    video = []
    try:
        p.start()
        feeder = _threads([(_feed_video, (src, host_frames(2, out_w, out_h), n_frames))])
        _drain(sink.video, video)
        p.wait_for_outputs_done(timeout=60)
        for t in feeder:
            t.join(timeout=10)
    finally:
        p.close()
    return len(video)


def profiler_setting_check(dev, stamp):
    """Phase 19d: `profiled_offline_run` at 1280x720 with only the
    reference's SMELTER_JAX_PROFILER_DIR set: after `close()` its directory
    holds the torch.profiler `trace.json`, with K2's kernel in it."""
    import tempfile

    names = ("SMELTER_TORCH_PROFILER_DIR", "SMELTER_JAX_PROFILER_DIR")
    saved = {k: os.environ.pop(k, None) for k in names}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["SMELTER_JAX_PROFILER_DIR"] = tmp
            frames = profiled_offline_run(dev, 1280, 720)
            path = os.path.join(tmp, "trace.json")
            text = open(path).read() if os.path.exists(path) else None
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    check(text is not None, "profiler setting: no trace.json under SMELTER_JAX_PROFILER_DIR")
    out = dict(frames=frames, trace_bytes=len(text), k2_events=text.count("yuv420_out"),
               k1_events=text.count("scene_assembly"))
    print(f"profiler setting (SMELTER_JAX_PROFILER_DIR alone): {json.dumps(out)} {stamp}")
    check(frames >= 1, "profiler setting: the pipeline delivered no frame")
    check(out["k2_events"] > 0, "profiler setting: K2 is not in the trace")
    return out


def dependency_check_gates(rc, stdout, stderr, stamp):
    """Phase 19c: `python -m smelter_tpu_torch.tools.dependency_check --json`
    ran in a child. Gates: the torch, CUDA card, nvcc and kernels-build
    checks pass and are required; the FFmpeg check agrees with this
    process's probe (`edges_unavailable`), failing with the loader's own
    message where the codec service cannot load; the exit code is 1 exactly
    when a required check failed."""
    check(stdout.strip().startswith("{"), f"dependency_check printed no JSON: {stderr[-2000:]}")
    report = json.loads(stdout)
    by_name = {c["name"]: c for c in report["checks"]}
    print(f"dependency_check (exit {rc}): " + json.dumps(
        {c["name"]: ("ok" if c["ok"] else "FAIL" if c["required"] else "skip", c["detail"][:160])
         for c in report["checks"]}) + f" {stamp}")
    for name in CARD_CHECKS:
        check(by_name[name]["ok"] and by_name[name]["required"],
              f"dependency_check: {name}: {by_name[name]['detail']}")
    probe = edges_unavailable()
    ffmpeg = by_name[FFMPEG_CHECK]
    loader = probe.split("; building")[0] if probe else None
    check(ffmpeg["ok"] == (probe is None) and (probe is None or loader in ffmpeg["detail"]),
          f"dependency_check: FFmpeg check {ffmpeg} against this process's probe {probe!r}")
    hard = [c["name"] for c in report["checks"] if c["required"] and not c["ok"]]
    check(rc == (1 if hard else 0) and report["ok"] == (not hard),
          f"dependency_check: exit {rc}, ok {report['ok']}, required checks failing {hard}")
    return dict(exit=rc, ok=report["ok"], failing_required=hard,
                ffmpeg=ffmpeg["ok"], card=by_name["CUDA card"]["detail"])


def soak_tools_phase(dev, stamp):
    """Phase 19, the tools on the card: (a) `soak_live` at the reference's
    size, (b) at 4K (`soak_run`), (c) `dependency_check --json` in a child,
    which runs while (d), the reference's profiler setting
    (`profiler_setting_check`), runs here. 60 s budget, recorded; fails
    past SOAK_CEILING_S. Returns (the soak's launches over (a) and (b),
    the phase's numbers)."""
    t_phase = time.perf_counter()
    numbers, launches = {}, {}
    for label, rounds, seconds, out, in_res in SOAK_RUNS:
        counts, numbers[f"soak_{label}"] = soak_run(dev, stamp, label, rounds, seconds, out,
                                                    in_res)
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    t_dep = time.perf_counter()
    child = subprocess.Popen(
        [sys.executable, "-m", "smelter_tpu_torch.tools.dependency_check", "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        numbers["profiler_setting"] = profiler_setting_check(dev, stamp)
        stdout, stderr = child.communicate(timeout=300)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    numbers["dependency_check"] = dependency_check_gates(child.returncode, stdout, stderr, stamp)
    numbers["dependency_and_profiler_s"] = time.perf_counter() - t_dep
    numbers["seconds"] = time.perf_counter() - t_phase
    numbers["budget_s"] = SOAK_BUDGET_S
    numbers["launches"] = launches
    print(f"tools on the card phase: {numbers['seconds']:.1f} s (budget {SOAK_BUDGET_S:.0f} s, "
          f"{'within' if numbers['seconds'] <= SOAK_BUDGET_S else 'OVER'}); soak launches "
          f"{launches} {stamp}")
    check(numbers["seconds"] <= SOAK_CEILING_S,
          f"phase 19 took {numbers['seconds']:.1f} s, past {SOAK_CEILING_S:.0f} s")
    return launches, numbers


def profile_reader_check(dev, stamp, n=N_INPUTS, iters=20, repeats=12):
    """The profiler reader's three measures of one program side by side:
    `iters` general_4k replays (the captured program called as
    `bench_flagship_ops` calls it) under `tools._profile.FrameProfile`, its
    busy time (the tools' device time), its span (idle gaps included) and
    its summed kernel time, beside CUDA events around the same calls
    without the profiler. Medians in ms. Then `repeats` traces of `iters`
    grid replays: every replay of one program runs the same device
    activities, so the reader must give every frame but the first of every
    trace the same count, and the first no more (a frame's activities
    placed in another frame, or lost at the trace's end, fail it). The
    first may hold fewer: the profiler can leave out a trace's first
    records (seen on an H100: the first replay's first two
    device-to-device copies, absent from the trace)."""
    import torch

    from smelter_tpu_torch import bench, interop
    from smelter_tpu_torch.core.types import Resolution
    from smelter_tpu_torch.parallel.flagship import (
        make_flagship_compose,
        make_flagship_general_compose,
    )
    from smelter_tpu_torch.render.capture import capture
    from smelter_tpu_torch.tools._profile import FrameProfile

    in_res, out_res = Resolution(IN_W, IN_H), Resolution(OUT_W, OUT_H)
    frames = [interop.planes_to_device(f, dev) for f in bench.host_frames(n, in_res)]
    counts = {}
    for name, make, traces in (("general_4k", make_flagship_general_compose, 1),
                               ("grid", make_flagship_compose, repeats)):
        fn, _ = make(n_inputs=n, in_res=in_res, out_res=out_res, device=dev)
        prog, _ = capture(fn, frames[0], dev)
        prog(*frames[0])
        counts[name] = []
        for _ in range(traces):
            with FrameProfile(dev) as fp:
                for i in range(iters):
                    with fp.frame():
                        prog(*frames[i % 2])
            counts[name].append(fp.activity_counts())
        if name == "general_4k":
            events = []
            for i in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                prog(*frames[i % 2])
                end.record()
                events.append((start, end))
            torch.cuda.synchronize()
            out = {"busy_ms": statistics.median(fp.busy_ms()),
                   "span_ms": statistics.median(fp.spans_ms()),
                   "kernel_ms": statistics.median(fp.kernel_ms()),
                   "cuda_events_ms": statistics.median(s.elapsed_time(e) for s, e in events)}
        del prog
    print(f"tools: profiler reader on general_4k ({iters} calls), medians: {json.dumps(out)} "
          f"{stamp}")
    # per program: the counts of the first frames, and of the others
    seen = {name: [sorted({t[0] for t in per}), sorted({c for t in per for c in t[1:]})]
            for name, per in counts.items()}
    out["activities_per_frame"] = seen
    print(f"tools: profiler reader, device activities of the first / the other frames in 1 "
          f"general_4k trace and {repeats} grid traces of {iters} replays each: "
          f"{json.dumps(seen)} {stamp}")
    check(all(len(rest) == 1 and max(first) <= rest[0] for first, rest in seen.values()),
          f"tools: the profiler reader gave replays of one program different activity counts: "
          f"{json.dumps(counts)}")
    return out


def profile_busy(prof, span_s):
    """The card's busy share over the first `span_s` seconds of a stopped
    torch.profiler trace: the device time of its kernels and copies, each
    clipped to that span, over the span. The trace may run past the span:
    stopping a profiler while another thread launches work on the card
    (a CUDA graph replayed by a renderer thread) can deadlock the two (seen
    on an H100: the stopping thread in `profiler.stop`, the renderer in
    `CUDAGraph.replay`), so a live run stops it once its threads are gone."""
    import torch

    end_us = span_s * 1e6
    busy_us = sum(max(0.0, min(e.time_range.end, end_us) - max(e.time_range.start, 0.0))
                  for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0)
    return busy_us / end_us


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
    from smelter_tpu_torch.render.capture import capture
    from smelter_tpu_torch.render.program import _pack_frame_buf

    # a hang ends the run with every thread's stack on stderr, inside the
    # time limit it runs under
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
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

    # phase 13a: MoQ's transport, first, while this process holds nothing else
    # (its receiving side shares the interpreter with whatever runs)
    t_phase = time.perf_counter()
    moq_transport_numbers = moq_transport(stamp)
    print(f"moq transport: {time.perf_counter() - t_phase:.1f} s")

    # phase 3 and 4: each kernel against its plain version on the card
    k2_err = k2_checks(yuv_out, dev)
    round_u8_check(dev)
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

    dev_frames = interop.planes_to_device(frames, dev)
    # each builder's function captured as the reference jits it, then
    # replayed: bit-equal to the eager function on the same frame
    builder_stats = {}
    t_phase = time.perf_counter()
    mem0 = torch.cuda.memory_reserved()
    grid_prog, _ = capture(grid_fn, dev_frames, dev)
    gen_prog, _ = capture(gen_fn, dev_frames, dev)
    torch.cuda.synchronize()
    scene_assembly.LAUNCHES = 0
    yuv_out.LAUNCHES = 0
    sdf_layers.LAUNCHES = 0
    grid_out = interop.planes_to_host(grid_prog(*dev_frames))
    check(scene_assembly.LAUNCHES == 0 and yuv_out.LAUNCHES == 0,
          "the grid scene runs no kernel")
    gen_out = interop.planes_to_host(gen_prog(*dev_frames))
    launches = {"scene_assembly": scene_assembly.LAUNCHES, "yuv_out": yuv_out.LAUNCHES,
                "sdf_layers": sdf_layers.LAUNCHES}
    print(f"flagship path launches during one general_4k replay: {launches}")
    check(launches["scene_assembly"] == 1, "a general_4k replay did not launch K1 once")
    check(launches["yuv_out"] == 1, "a general_4k replay did not launch K2 once")
    for label, planes in (("grid", grid_out), ("general_4k", gen_out)):
        check_planes(label, planes, OUT_W, OUT_H)
    for label, fn, prog, replayed in (("grid", grid_fn, grid_prog, grid_out),
                                      ("general_4k", gen_fn, gen_prog, gen_out)):
        eager = interop.planes_to_host(fn(*dev_frames))
        mx = lsb_stats(eager, replayed)[0]
        t_eager, t_replay = cuda_ms(lambda: fn(*dev_frames)), cuda_ms(lambda: prog(*dev_frames))
        builder_stats[label] = dict(eager_ms=t_eager, replay_ms=t_replay,
                                    capture_ms=prog.capture_ms,
                                    graph_mb=prog.graph_bytes / 2**20)
        print(f"time {label} 16x1080p->4K, compute only: eager {t_eager:.4f} ms, replayed "
              f"{t_replay:.4f} ms (capture {prog.capture_ms:.1f} ms, graph "
              f"{prog.graph_bytes / 2**20:.1f} MiB); replay vs eager max abs err {mx} {stamp}")
        check(mx == 0, f"{label}: the replay differs from the eager function by {mx}")
    builder_stats["reserved_mb_growth"] = (torch.cuda.memory_reserved() - mem0) / 2**20
    del grid_prog, gen_prog
    print(f"builders captured and timed in {time.perf_counter() - t_phase:.1f} s")
    parity_vs_cpu(make_flagship_compose, 4, 256, 144, 768, 432, dev, "grid")
    parity_vs_cpu(make_flagship_general_compose, 4, 256, 144, 768, 432, dev, "general_4k")
    parity_vs_cpu(make_flagship_compose, N_INPUTS, IN_W, IN_H, OUT_W, OUT_H, dev, "grid")

    # phase 16: the benchmark entry point, `python -m smelter_tpu_torch.bench`
    bench_launches, bench_numbers = bench_phase(dev, stamp)

    # phase 17: the measurement tools, `python -m smelter_tpu_torch.tools.<name>`
    tool_launches, tool_numbers = tools_phase(dev, stamp, bench_numbers["grid_device_p50_ms"])

    # phase 18: the 16-bit compose canvas, its kernels, builders, renderer and A/B tools
    canvas_launches, canvas_numbers = canvas_storage_phase(
        dev, stamp, cases + [renderer_k1] + k1_edge_cases(dev), general_canvas, render_frames)

    # phase 6: the renderer, 16 x 1080p -> 4K, a transition of 41 frames
    k3_frames = []

    def count_k3(k, _planes):
        k3_frames.append((k, sdf_layers.LAUNCHES, len(syncs)))

    scene_assembly.LAUNCHES = 0
    yuv_out.LAUNCHES = 0
    sdf_layers.LAUNCHES = 0
    t_phase = time.perf_counter()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs, EagerCheck("renderer transition") as eager:
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
    capture_stats = {"renderer transition": eager.report()}
    kinds = [kind for _, _, kind in eager.renders]
    print(f"renderer transition: frames captured {[k for k, c in enumerate(kinds) if c == 'capture']}"
          f", the rest replayed")
    replay_syncs = {k: n for k, n in sync_frames.items() if kinds[k] == "replay"}
    check(len(kinds) == len(outs) and not replay_syncs,
          f"renderer transition: replay frames synchronised: {replay_syncs}")
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
    print(f"renderer phase: {time.perf_counter() - t_phase:.1f} s")

    # phase 7: animated textures, 16 x 1080p (one NV12, one RGBA) -> 4K
    anim_frames = animated_inputs(N_INPUTS, IN_W, IN_H, seed=5)
    t_phase = time.perf_counter()
    anim_launches, capture_stats["animated textures"] = animated_phase(dev, anim_frames)
    print(f"animated textures phase: {time.perf_counter() - t_phase:.1f} s")

    # phase 8: the pipeline, offline (checked) and in real time (measured)
    t_phase = time.perf_counter()
    pipe_launches, pipe_offline = pipeline_phase(dev)
    check(all(pipe_launches.values()), f"pipeline: a kernel never launched: {pipe_launches}")
    pipe_live = [pipeline_live(dev, N_INPUTS, OUT_W, OUT_H, stamp),
                 pipeline_live(dev, 4, IN_W, IN_H, stamp)]
    print(f"pipeline phase: {time.perf_counter() - t_phase:.1f} s")
    capture_stats["pipeline offline"] = pipe_offline["captured_programs"]

    # phase 11: a scene update in the live pipeline, captured in the background
    t_phase = time.perf_counter()
    pipe_async = pipeline_async(dev, N_INPUTS, OUT_W, OUT_H, stamp)
    print(f"pipeline async phase: {time.perf_counter() - t_phase:.1f} s")

    # phase 10: Shader, Image and WebView nodes, three output formats, 4K
    node_launches, nodes = nodes_phase(dev, render_frames, stamp)
    capture_stats["nodes"] = nodes["captured_programs"]

    # phase 12: live network edges (RTP, RTMP, WHIP in; RTP out) through the server
    t_phase = time.perf_counter()
    edge_launches, edges = edges_phase(dev, stamp)
    if edge_launches is not None:
        check(all(edge_launches.values()), f"edges: a kernel never launched: {edge_launches}")
    print(f"edges phase: {time.perf_counter() - t_phase:.1f} s")

    # phase 13b: MoQ's media path through the server
    t_phase = time.perf_counter()
    moq_launches, moq = moq_phase(dev, stamp, moq_transport_numbers)
    if moq_launches is not None:
        check(all(moq_launches.values()), f"moq: a kernel never launched: {moq_launches}")
    print(f"moq phase: {time.perf_counter() - t_phase:.1f} s")

    # the reference's 4K goldens, rendered on the card
    t_phase = time.perf_counter()
    golden_errors = goldens_4k_phase(dev, stamp)
    print(f"4K goldens: {time.perf_counter() - t_phase:.1f} s")

    # phase 15: the multi-device steps, once the live phases' pipelines are closed
    multichip_launches, multichip = multichip_phase(dev, stamp)

    # phase 19: the tools on the card: soak_live, dependency_check, the
    # reference's profiler setting
    soak_launches, soak_numbers = soak_tools_phase(dev, stamp)

    # phase 9: timings (medians of ITERS runs after WARMUP)
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
    # the 16-bit canvas (phase 18): K1's store and K2's load in each storage
    # on the general_4k table and canvas; bounds from this run's bytes
    from smelter_tpu_torch.ops.compose import _canvas_encode

    storage = {"scene_assembly": {}, "yuv_out": {}}
    rows = scene_assembly.spec_table(specs, dev)
    _, pairs = tile_class.reach(specs, params, OUT_H, OUT_W)
    for name in CANVAS_STORAGE:
        dt = _storage_dtype(name)
        fn = lambda dt=dt: scene_assembly.assemble_scene_planar(  # noqa: E731
            res, specs, params, rows, out_dtype=dt)
        n_bytes = 4 * OUT_H * OUT_W * 2 + params.numel() * 4 + rows.numel() * 4
        bound, by = bound_ms(n_bytes, BLEND_OPS * pairs)
        t, t_dev = kernel_ms(fn), device_ms(fn, "scene_assembly_kernel")
        t_plain = cuda_ms(lambda dt=dt: scene_assembly.assemble_scene_planar_plain(
            res, specs, params, dt))
        storage["scene_assembly"][name] = dict(
            ms=t, device_ms=t_dev, plain_ms=t_plain, bound_ms=bound, bound_by=by, bytes=n_bytes,
            launches_per_replay=canvas_numbers["builders"][name]["launches"]["scene_assembly"])
        print(f"time K1 scene_assembly 4K general_4k table, {name} store: kernel {t:.4f} ms, "
              f"device {t_dev} ms, plain {t_plain:.4f} ms, bound {bound:.4f} ms by {by} "
              f"({n_bytes} B), {bound / t:.0%} of bound {stamp}")
        canvas16 = _canvas_encode(general_canvas, dt)
        fn = lambda c=canvas16: yuv_out.rgba_cm_to_yuv420(c)  # noqa: E731
        n_bytes = 3 * OUT_H * OUT_W * 2 + OUT_H * OUT_W * 3 // 2
        bound, by = bound_ms(n_bytes)
        t, t_dev = kernel_ms(fn), device_ms(fn, "yuv420_out")
        t_plain = cuda_ms(lambda c=canvas16: yuv_out.rgba_cm_to_yuv420_plain(c))
        storage["yuv_out"][name] = dict(
            ms=t, device_ms=t_dev, plain_ms=t_plain, bound_ms=bound, bound_by=by, bytes=n_bytes,
            launches_per_replay=canvas_numbers["builders"][name]["launches"]["yuv_out"])
        print(f"time K2 yuv_out 4K, {name} canvas: kernel {t:.4f} ms, device {t_dev} ms, "
              f"plain {t_plain:.4f} ms, bound {bound:.4f} ms by {by} ({n_bytes} B), "
              f"{bound / t:.0%} of bound {stamp}")
        del canvas16
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
    print(f"time renderer frames that captured a new structure: "
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

    print(json.dumps({"pipeline": {"offline": {**pipe_offline, "kernel_launches": pipe_launches},
                                   "live": pipe_live, "card": card}}))
    print(json.dumps({"nodes": {"kernel_launches": node_launches, **nodes}}))
    print(json.dumps({"captured_programs": {"builders": builder_stats, **capture_stats,
                                            "pipeline async": pipe_async, "card": card}}))
    print(json.dumps({"goldens_4k": {"mean_abs_error": golden_errors,
                                     "allowed": GOLDEN_ALLOWED_ERROR, "card": card}}))
    print(json.dumps({"multichip": {"kernel_launches": multichip_launches, **multichip,
                                    "card": card}}))
    print(json.dumps({"bench_phase": {"kernel_launches": bench_launches, **bench_numbers,
                                      "card": card}}))
    print(json.dumps({"tools_phase": {"kernel_launches": tool_launches, **tool_numbers,
                                      "card": card}}))
    print(json.dumps({"soak_tools": {**soak_numbers, "card": card}}))
    check("jax" not in sys.modules, "the port imported jax")
    # "launches": the pipeline's offline run at 16 x 1080p -> 4K, this
    # slice's main path; no single PyTorch call computes any of the three functions:
    # library_ms is null
    kernels = [
        {"name": "scene_assembly", "route": "cuda",
         "source": "smelter_tpu_torch/csrc/scene_assembly.cu",
         "replaces": "smelter_tpu/ops/pallas/scene_assembly.py:194",
         "launches": pipe_launches["scene_assembly"],
         "launches_by_path": {"renderer": render_launches["scene_assembly"],
                              "animated": anim_launches["scene_assembly"],
                              "pipeline": pipe_launches["scene_assembly"],
                              "nodes": node_launches["scene_assembly"],
                              "edges": edge_launches and edge_launches["scene_assembly"],
                              "moq": moq_launches and moq_launches["scene_assembly"],
                              "multichip": multichip_launches["scene_assembly"],
                              "bench": bench_launches["scene_assembly"],
                              "tools": {tool: n["scene_assembly"] for tool, n in tool_launches.items()},
                              "canvas_tools": {tool: n["scene_assembly"]
                                               for tool, n in canvas_launches.items()},
                              "soak": soak_launches["scene_assembly"]},
         "max_abs_err": k1_err, "storage_16bit": storage["scene_assembly"],
         "ms": k1_main["ms"], "plain_ms": k1_main["plain_ms"],
         "bound_ms": k1_main["bound_ms"], "bound_by": k1_main["bound_by"],
         "library_ms": None, "call_ms": k1_main["call_ms"],
         "device_ms": k1_main["device_ms"], "bytes": k1_main["bytes"]},
        {"name": "yuv_out", "route": "cuda",
         "source": "smelter_tpu_torch/csrc/yuv_out.cu",
         "replaces": "smelter_tpu/ops/pallas/yuv_out.py:82",
         "launches": pipe_launches["yuv_out"],
         "launches_by_path": {"renderer": render_launches["yuv_out"],
                              "animated": anim_launches["yuv_out"],
                              "pipeline": pipe_launches["yuv_out"],
                              "nodes": node_launches["yuv_out"],
                              "edges": edge_launches and edge_launches["yuv_out"],
                              "moq": moq_launches and moq_launches["yuv_out"],
                              "multichip": multichip_launches["yuv_out"],
                              "bench": bench_launches["yuv_out"],
                              "tools": {tool: n["yuv_out"] for tool, n in tool_launches.items()},
                              "canvas_tools": {tool: n["yuv_out"]
                                               for tool, n in canvas_launches.items()},
                              "soak": soak_launches["yuv_out"]},
         "max_abs_err": k2_err, "storage_16bit": storage["yuv_out"],
         "ms": t_k2, "plain_ms": t_k2_plain, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "call_ms": t_k2_call, "device_ms": t_k2_dev,
         "bytes": k2_bytes},
        {"name": "sdf_layers", "route": "cuda",
         "source": "smelter_tpu_torch/csrc/sdf_layers.cu",
         "replaces": "smelter_tpu/ops/pallas/sdf_layers.py:66",
         "launches": pipe_launches["sdf_layers"],
         "launches_by_path": {"renderer": render_launches["sdf_layers"],
                              "animated": anim_launches["sdf_layers"],
                              "pipeline": pipe_launches["sdf_layers"],
                              "nodes": node_launches["sdf_layers"],
                              "edges": edge_launches and edge_launches["sdf_layers"],
                              "moq": moq_launches and moq_launches["sdf_layers"],
                              "multichip": multichip_launches["sdf_layers"],
                              "bench": bench_launches["sdf_layers"],
                              "tools": {tool: n["sdf_layers"] for tool, n in tool_launches.items()},
                              "canvas_tools": {tool: n["sdf_layers"]
                                               for tool, n in canvas_launches.items()},
                              "soak": soak_launches["sdf_layers"]},
         "max_abs_err": k3_err,
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


def moq_capacity(counts, wait_s=20.0):
    """`python3 chip_smoke.py --moq-capacity N ...`: phase 13a's transport
    alone, ungated, at each publisher count N (`wait_s` after the last
    write), one JSON line each; the card is not used (its `nvidia-smi`
    line labels the numbers)."""
    stamp = f"[{nvidia_smi()}]"
    for n in counts:
        out = moq_transport_phase(stamp, n=n, deadline_s=wait_s, gated=False)
        print(json.dumps({"moq_capacity": out}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--moq-capacity"]:
            sys.exit(moq_capacity([int(n) for n in sys.argv[2:]]))
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
