"""End-to-end latency of the live pipeline, without codecs (the port of the
reference's `tools/bench_latency.py`).

    python -m smelter_tpu_torch.tools.bench_latency [--width 1280] [--height 720]
        [--fps 30] [--seconds 8] [--buffer-ms 100] [--device cpu]

A live pipeline (wall-clock queue ticks, not ahead of time): a RawDataInput
receives frames that carry a marker (a 32x32 block of one grey level) at
their scheduled rate; a RawDataOutputSink receives the composed frames. The
latency of an output frame is its receive time minus the push time of the
input frame whose marker it shows: input buffering, the queue's ticks, the
compose and the copy to the host, and the threads' handoffs. The first two
seconds are a warm-up and are not counted.

Unlike the reference, which composes on the CPU unless told otherwise
(`SMELTER_BENCH_DEVICE`), this tool composes on the card unless given
`--device cpu`; without a card it raises.

Prints one JSON line with p50/p95/p99 latency and "card".
"""

from __future__ import annotations

import argparse
import json
import statistics
import threading
import time
from typing import List, Optional

import numpy as np

from smelter_tpu_torch.core.types import Frame, Framerate, PixelFormat, Resolution, RGBAColor
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.pipeline import Pipeline, PipelineOptions, RegisterInputOptions
from smelter_tpu_torch.pipeline.input import RawDataInput
from smelter_tpu_torch.pipeline.output import (
    EndCondition,
    OutputVideoOptions,
    RawDataOutputSink,
    VideoEncoderOptions,
)
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.tools._profile import card
from smelter_tpu_torch.utils.channels import Closed

WARMUP_S = 2.0


def _marker_of(counter: int) -> int:
    return 20 + (counter % 200)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the pipeline, print its JSON line and return it."""
    ap = argparse.ArgumentParser(description="Latency of the live pipeline, no codecs.")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--buffer-ms", type=float, default=100.0,
                    help="queue input buffer (reference default 100 ms)")
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU; the CUDA card if omitted')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    W, H, FPS = args.width, args.height, args.fps

    pipe = Pipeline(PipelineOptions(output_framerate=Framerate(FPS)), device=device)
    stop = threading.Event()
    prod = None
    latencies = []
    try:
        src = RawDataInput(has_video=True, has_audio=False)
        pipe.register_input(
            "cam", src,
            RegisterInputOptions(required=False, offset=None,
                                 buffer_duration=args.buffer_ms / 1000.0),
        )
        sink = RawDataOutputSink()
        pipe.register_output(
            "out", sink,
            video=OutputVideoOptions(
                resolution=Resolution(W, H),
                encoder=VideoEncoderOptions(codec="raw"),
                initial_root=comp.View(
                    background_color=RGBAColor(16, 16, 16, 255),
                    children=[comp.Rescaler(child=comp.InputStream(input_id="cam"))],
                ),
                end_condition=EndCondition(),
            ),
        )
        pipe.start()

        push_times = {}
        push_lock = threading.Lock()
        base_y = np.full((H, W), 100, np.uint8)
        base_u = np.full((H // 2, W // 2), 128, np.uint8)
        base_v = np.full((H // 2, W // 2), 128, np.uint8)

        def producer() -> None:
            counter = 0
            t0 = time.monotonic()
            while not stop.is_set():
                delay = t0 + counter / FPS - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                y = base_y.copy()
                y[:32, :32] = _marker_of(counter)  # identifying block
                with push_lock:
                    push_times[_marker_of(counter)] = time.monotonic()
                try:
                    src.video.send(Frame(
                        data=(y, base_u, base_v),
                        format=PixelFormat.PLANAR_YUV420,
                        resolution=Resolution(W, H), pts=counter / FPS,
                    ))
                except Closed:
                    return
                counter += 1

        prod = threading.Thread(target=producer, name="latency-producer", daemon=True)
        prod.start()

        deadline = time.monotonic() + args.seconds + WARMUP_S
        warmup_until = time.monotonic() + WARMUP_S
        while time.monotonic() < deadline:
            try:
                frame = sink.video.recv(timeout=1.0)
            except (Closed, TimeoutError):
                continue
            now = time.monotonic()
            y = np.asarray(frame.data[0] if isinstance(frame.data, tuple)
                           else frame.data[..., 0])
            # the Rescaler maps the 32x32 marker into the output's top left;
            # the YUV -> RGBA -> YUV round trip can shift grey levels by 1-2
            med = int(round(float(np.median(y[:16, :16]))))
            with push_lock:
                t_push = None
                for cand in (med, med - 1, med + 1, med - 2, med + 2):
                    t_push = push_times.get(cand)
                    if t_push is not None:
                        break
            if t_push is None or now < warmup_until:
                continue
            latencies.append(now - t_push)
    finally:
        stop.set()
        pipe.close()
        if prod is not None:
            prod.join(timeout=5.0)

    if not latencies:
        res = {"metric": "pipeline_latency_ms", "error": "no samples", "card": card(device)}
        print(json.dumps(res), flush=True)
        return res
    lat_ms = sorted(x * 1000.0 for x in latencies)
    res = {
        "metric": "pipeline_latency_ms",
        "value": round(statistics.median(lat_ms), 1),
        "unit": "ms (p50)",
        "p50_ms": round(statistics.median(lat_ms), 1),
        "p95_ms": round(lat_ms[int(len(lat_ms) * 0.95) - 1], 1),
        "p99_ms": round(lat_ms[int(len(lat_ms) * 0.99) - 1], 1),
        "samples": len(lat_ms),
        "fps": FPS,
        "resolution": f"{W}x{H}",
        "buffer_ms": args.buffer_ms,
        "card": card(device),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
