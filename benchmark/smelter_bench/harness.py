"""One run of a cell: set-up, the measured window, with `--trace 1` a traced
stretch after it, the comparison with the plain reference, and the
result's line."""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from smelter_bench.cell import (
    Cell, frames_of, input_ids, least_bytes, load_cell, make_inputs, program_api, shown_inputs,
)
from smelter_bench.loop import RenderLoop, Reservoir
from smelter_bench.reference import CHECKED, check
from smelter_bench.trace import Digest, Trace, card_line

# top-level module names that no process of the benchmark may hold: JAX and
# the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "smelter_tpu")
FETCH_TIMEOUT_S = 60.0
# planes of an output frame, each copied to the host on its own
PLANES = {"PLANAR_YUV420": 3, "PLANAR_YUV444": 3}


@dataclass
class RunContext:
    """What the per-layer metric readers read (`metrics/<name>.py`)."""
    cell: Cell
    spans: Dict[str, dict]      # `tracing.report()` over the window
    digest: Digest              # the traced window
    least_bytes: int = 0        # summed over the window's ticks


def forbidden_modules() -> List[str]:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def _percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        device: Optional[str] = None, cfg_overrides: Optional[dict] = None,
        traffic_overrides: Optional[dict] = None,
        log=sys.stderr) -> Tuple[dict, Dict[int, Dict[str, object]]]:
    """One run of `workload`. Returns the result's line and the sampled
    ticks that were held to the reference ({tick: {output: host Frame}}).
    `device`, `cfg_overrides` and `traffic_overrides` serve the CPU
    tests."""
    cell = load_cell(workload, cfg_overrides=cfg_overrides, traffic_overrides=traffic_overrides)
    return _run(cell, seed, seconds, trace, t_process, device, log)


def _run(cell: Cell, seed: int, seconds: float, trace: bool, t_process: float,
         device: Optional[str], log) -> Tuple[dict, Dict[int, Dict[str, object]]]:
    import torch
    from torch.profiler import record_function

    from smelter_tpu_torch.core.types import FrameSet
    from smelter_tpu_torch.pipeline.output import to_host_async
    from smelter_tpu_torch.render.renderer import Renderer, RendererOptions
    from smelter_tpu_torch.utils import tracing

    cfg, traffic, sched = cell.cfg, cell.traffic, cell.schedule
    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    phases = {"imports": time.perf_counter() - t_process}
    if cuda:
        from smelter_tpu_torch.ops.hopper import build

        build.library()  # from the build cache inside the checkout, or built now
        torch.cuda.init()
    phases["kernels and card"] = time.perf_counter() - t_process - sum(phases.values())
    tracing.enable_profiler_annotations(False)
    api = program_api()
    outputs = cell.outputs
    planes_ring = make_inputs(cfg, int(traffic["ring"]), seed, dev)
    frame_sets = [frames_of(api, cfg, p) for p in planes_ring]
    t = api.types
    out_res = t.Resolution(cfg["output_width"], cfg["output_height"])
    out_fmt = t.PixelFormat[cfg["output_format"]]
    renderer = Renderer(RendererOptions(async_compile=False), device=dev)
    for iid in input_ids(cfg):
        renderer.register_input(iid)
    stages = sorted({s for s, _ in sched.opening + sched.cycle})
    shown = {s: set().union(*(shown_inputs(cell.scene.build(api, cfg, s, o)) for o in outputs))
             for s in stages}

    def update(stage: int) -> None:
        for o in outputs:
            renderer.update_scene(o, cell.scene.build(api, cfg, stage, o), out_res, out_fmt)

    def render(pts: float, frames: dict):
        return renderer.render(FrameSet(pts=pts, frames=frames)).frames

    annotate = [False]  # the loop's own spans, in the host-traced stretch

    def mark(name: str):
        return record_function(name) if annotate[0] else contextlib.nullcontext()

    if cuda:
        torch.cuda.synchronize(dev)
    phases["inputs and renderer"] = time.perf_counter() - t_process - sum(phases.values())
    sample = Reservoir(int(traffic["check_frames"]), seed)
    loop = RenderLoop(render, to_host_async, frame_sets, sched, update,
                      int(traffic["in_flight"]), sample, mark)

    # set-up: the opening and whole cycles, so that every structure key of
    # the traffic is captured before the window
    k, first = 0, sched.cycle_start(int(traffic["warm_cycles"]))
    while k < first:
        loop.tick(k, False)
        k += 1
    if not loop.drain(FETCH_TIMEOUT_S) or loop.failed:
        raise RuntimeError(f"set-up failed: {next(iter(loop.failed.values()), 'a frame never arrived')}")
    if cuda:
        torch.cuda.synchronize(dev)
    captures = tracing.report().get("render.capture", {})
    tracing.reset()
    phases["opening and warm cycles"] = time.perf_counter() - t_process - sum(phases.values())
    # the window is traced whole, the card's activity alone; the profiler's
    # start is the benchmark's, not the program's set-up
    t_profiler = time.perf_counter()
    tr = Trace(dev, host=False)
    tr.start()
    t_window = time.perf_counter()
    phases["profiler"] = t_window - t_profiler
    setup_s = t_profiler - t_process

    # the window: closed loop, from a cycle boundary, for `seconds`
    window_first, traced_bytes = k, 0
    while time.perf_counter() - t_window < seconds:
        traced_bytes += least_bytes(cfg, shown[sched.stage(k)], len(outputs))
        loop.tick(k, True)
        k += 1
    window = range(window_first, k)
    loop.drain(FETCH_TIMEOUT_S)
    digest = tr.stop(len(window) * len(outputs))
    spans = tracing.report()
    if trace:
        # a few ticks after the window, their host spans traced too: what
        # the host did while the card idled
        tracing.enable_profiler_annotations(True)
        annotate[0] = True
        tr = Trace(dev, host=True)
        tr.start()
        n = int(traffic["host_trace_ticks"])
        for _ in range(n):
            loop.tick(k, False)
            k += 1
        loop.drain(FETCH_TIMEOUT_S)
        host_digest = tr.stop(n * len(outputs))
        tracing.enable_profiler_annotations(False)
        annotate[0] = False
    arrived = [j for j in window if j in loop.fetched]
    t_end = max((loop.fetched[j] for j in arrived), default=time.perf_counter())
    frames = [(*loop.issued[j], loop.fetched[j]) for j in arrived]
    loop.close()
    failed_render = {j: loop.failed[j] for j in window if j in loop.failed}
    missing = {j for j in window if j not in loop.fetched and j not in loop.failed}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    del loop, renderer, frame_sets, render, update
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    ctx = RunContext(cell=cell, spans=spans, digest=digest, least_bytes=traced_bytes)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # output frames counted by their planes' copies to the host in the
        # trace itself, over the card's busy time in it but those copies:
        # their speed is the host memory's (from machine to machine 0.235 to
        # 0.249 ms a 4K frame where the kernels kept to 0.2%)
        busy = digest.busy_s(to_host=False)
        traced_frames = digest.copies_to_host() / PLANES[cfg["output_format"]]
        e2e = {"chip_frames_per_s": traced_frames / busy if busy > 0 else None,
               "setup_s": setup_s}
        for m in cell.end_to_end:
            if e2e.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    window_s = t_end - t_window
    latencies = [(t2 - t0) * 1e3 for t0, _, t2 in frames]
    host_paced = {
        "frames_per_s": len(frames) * len(outputs) / window_s if window_s > 0 else None,
        "latency_p50_ms": _percentile(latencies, 50) if latencies else None,
        "latency_p95_ms": _percentile(latencies, 95) if latencies else None,
        **{f"{name}_ms": s["total_ms"] / s["count"] for name, s in spans.items() if s["count"]},
    }

    checked = check(cell, sample.kept, planes_ring, dev)
    failed = (len(failed_render) + len(missing)) * len(outputs) + len(checked["rejected"])
    correct = failed == 0 and len(window) > 0 and checked["frames"] > 0
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": len(window) * len(outputs), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = digest.busy_s()
        device_info["window_s"] = digest.window_s
        result["breakdown"] = {"device_ops": digest.device_ops(),
                               "idle_gaps": host_digest.idle_gaps()}
    card = card_line() if cuda else None
    result["card"] = card
    result["checked"] = {c: {"value": checked[c], "limit": cell.limits[c]} for c in CHECKED}
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items())
          + f"; {captures.get('count', 0)} captures, {captures.get('total_ms', 0.0):.1f} ms",
          file=log)
    per_s = [0] * max(1, math.ceil(seconds))
    for _, _, t2 in frames:
        per_s[min(max(int(t2 - t_window), 0), len(per_s) - 1)] += len(outputs)
    print(f"frames on the host in each second of the window: {per_s}", file=log)
    print(f"host-paced, under the profiler: {host_paced}", file=log)
    print(f"card: {digest.busy_s():.6f} s busy ({digest.busy_s(to_host=False):.6f} s but the "
          f"copies to the host) of {digest.window_s:.6f} s traced, {len(digest.device)} device "
          f"activities, {digest.copies_to_host()} copies to the host for {digest.frames} output "
          f"frames; s by kind: " + ", ".join(f"{k} {digest.kind_s(k):.6f}"
                                            for k in ("gemm", "torch", "copy", "memset")),
          file=log)
    print(f"window: {len(window)} ticks of {len(outputs)} output frames, {len(arrived)} on the host, "
          f"{len(failed_render)} raised, {len(missing)} missing; set-up {setup_s:.3f} s; "
          f"card {card}", file=log)
    for j in sorted(failed_render)[:3]:
        print(f"tick {j} raised:\n{failed_render[j]}", file=log)
    print(f"reference: {checked['frames']} frames (ticks {checked['ticks']}) in "
          f"{checked['seconds']:.3f} s, {checked['diff_ppm']} ppm differ, largest difference "
          f"{checked['max_lsb']} u8 steps, rejected {checked['rejected']}", file=log)
    return result, sample.kept
