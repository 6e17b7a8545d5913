"""Most simultaneous real-time streams (the port of the reference's
`tools/bench_streams.py`, itself after the upstream project's
`integration-tests/src/bin/benchmark/`).

    python -m smelter_tpu_torch.tools.bench_streams --resolution 480p --framerate 24 --ratio 4
    python -m smelter_tpu_torch.tools.bench_streams --resolution 1080p --framerate 30 \\
        --ratio 1 --preset ultrafast --duration 10
    python -m smelter_tpu_torch.tools.bench_streams --pinned --inputs 4 --frames 240

Searches for the most input streams the machine sustains in real time for a
decode -> Tiles compose -> x264 encode pipeline. One trial with N inputs and
ceil(N / ratio) outputs runs for `--duration` seconds of wall clock; it
succeeds when every output produced at least SUCCESS_RATIO of the expected
frames. The search doubles until a trial fails, then bisects. `--pinned`
instead runs a fixed number of inputs ahead of time, never dropping a
frame, and reports the process's CPU time per output frame.

Unlike the reference, which composes on the CPU unless told otherwise
(`SMELTER_BENCH_DEVICE`), this tool composes on the card unless given
`--device cpu`; without a card it raises. The codecs run on the host
through the codec service, which needs FFmpeg's shared libraries: where it
cannot load, the tool raises with the loader's message.

Prints one JSON line with the reference's keys and "card".
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional

import numpy as np

from smelter_tpu_torch.core.types import Framerate, Resolution, RGBAColor
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.pipeline import (
    Mp4Input,
    Mp4InputOptions,
    OutputVideoOptions,
    Pipeline,
    PipelineOptions,
    RegisterInputOptions,
    VideoEncoderOptions,
)
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.tools._profile import card

RESOLUTIONS = {
    "480p": (854, 480),
    "720p": (1280, 720),
    "1080p": (1920, 1080),
    "2160p": (3840, 2160),
}

SUCCESS_RATIO = 0.93


class CountingSink:
    """Output sink that counts the encoded packets."""

    def __init__(self) -> None:
        self.video_packets = 0
        self.audio_packets = 0

    def setup_video(self, opts, extradata, fps_num, fps_den) -> None:
        pass

    def setup_audio(self, opts, extradata) -> None:
        pass

    def write_video_packet(self, pkt) -> None:
        self.video_packets += 1

    def write_audio_packet(self, pkt) -> None:
        self.audio_packets += 1

    def on_done(self) -> None:
        pass


def make_source(path: str, w: int, h: int, fps: int, seconds: float = 4.0,
                preset: str = "ultrafast") -> None:
    """A moving-gradient H.264 clip: a real encode and decode cost, and it
    loops cleanly."""
    from smelter_tpu_torch.io.codec import Codec, Muxer, VideoEncoder

    enc = VideoEncoder(Codec.H264, w, h, fps, preset=preset)
    xs = np.arange(w, dtype=np.uint16)
    ys = np.arange(h, dtype=np.uint16)[:, None]
    u_grad = ((xs[None, : w // 2] * 255) // max(w // 2, 1)).astype(np.uint8)
    u_plane = np.broadcast_to(u_grad, (h // 2, w // 2)).copy()
    v_plane = np.full((h // 2, w // 2), 128, np.uint8)
    pkts = []

    def drain() -> None:
        while True:
            p = enc.receive()
            if p is None or p == "eof":
                return
            pkts.append(p)

    for i in range(int(seconds * fps)):
        y = ((xs[None, :] + ys + i * 7) % 256).astype(np.uint8)
        enc.send(y, u_plane, v_plane, i / fps)
        drain()
    enc.send_eof()
    drain()
    mux = Muxer(path)
    vs = mux.add_video(Codec.H264, w, h, fps, 1, enc.extradata())
    mux.write_header()
    for p in pkts:
        mux.write(vs, p.data, p.pts_s, p.dts_s, p.is_keyframe)
    mux.close()
    enc.close()


def _pipeline(src: str, n_inputs: int, ratio: int, w: int, h: int, fps: int, preset: str,
              device, pinned: bool):
    """(a started pipeline of `n_inputs` looping copies of `src` into
    ceil(n / ratio) Tiles outputs, their counting sinks)."""
    n_outputs = max(1, math.ceil(n_inputs / ratio))
    if pinned:
        options = PipelineOptions(output_framerate=Framerate(fps),
                                  ahead_of_time_processing=True,
                                  never_drop_output_frames=True)
    else:
        options = PipelineOptions(output_framerate=Framerate(fps))
    pipeline = Pipeline(options, device=device)
    try:
        for i in range(n_inputs):
            pipeline.register_input(
                f"in_{i}",
                Mp4Input(Mp4InputOptions(path=src, loop=True)),
                RegisterInputOptions(required=pinned),
            )
        sinks = []
        for o in range(n_outputs):
            members = [f"in_{i}" for i in range(n_inputs) if i % n_outputs == o]
            scene = comp.Tiles(
                children=[comp.InputStream(input_id=m) for m in members],
                background_color=RGBAColor(8, 8, 8),
            )
            sink = CountingSink()
            sinks.append(sink)
            pipeline.register_output(
                f"out_{o}",
                sink,
                video=OutputVideoOptions(
                    resolution=Resolution(w, h),
                    encoder=VideoEncoderOptions(codec="h264", preset=preset),
                    initial_root=scene,
                ),
            )
        pipeline.start()
    except BaseException:
        pipeline.close()
        raise
    return pipeline, sinks


def run_trial(src: str, n_inputs: int, ratio: int, w: int, h: int, fps: int,
              preset: str, duration: float, device=None) -> dict:
    """{'success': bool, 'outputs': [frames of each output], 'expected': int}."""
    pipeline, sinks = _pipeline(src, n_inputs, ratio, w, h, fps, preset, device, pinned=False)
    try:
        # warm-up: until every output produced a frame (the first frames
        # build and capture the programs)
        warmup_deadline = time.time() + 300.0
        while time.time() < warmup_deadline:
            if all(s.video_packets > 0 for s in sinks):
                break
            time.sleep(0.1)
        time.sleep(2.0)  # let the queue recover from the capture's stall
        baseline = [s.video_packets for s in sinks]
        time.sleep(duration)
        counts = [s.video_packets - b for s, b in zip(sinks, baseline)]
    finally:
        pipeline.close()
    expected = int(duration * fps)
    return {
        "success": all(c >= SUCCESS_RATIO * expected for c in counts),
        "outputs": counts,
        "expected": expected,
    }


def run_pinned(src: str, n_inputs: int, ratio: int, w: int, h: int, fps: int,
               preset: str, frames_target: int, device=None) -> dict:
    """Pinned-cost mode: the pipeline runs ahead of time with never-drop
    semantics (every output frame decoded, composed and encoded once), and
    the metric is the process's CPU time per output frame
    (`time.process_time()`, all threads, the codecs included), which the
    host's load barely touches."""
    pipeline, sinks = _pipeline(src, n_inputs, ratio, w, h, fps, preset, device, pinned=True)
    try:
        # warm-up past the captures, the encoders' priming and the source's
        # first loop
        deadline = time.time() + 600.0
        while time.time() < deadline:
            if all(s.video_packets >= 3 * fps for s in sinks):
                break
            time.sleep(0.05)
        f0 = sum(s.video_packets for s in sinks)
        c0 = time.process_time()
        t0 = time.monotonic()
        while time.time() < deadline:
            if sum(s.video_packets for s in sinks) - f0 >= frames_target:
                break
            time.sleep(0.05)
        cpu_s = time.process_time() - c0
        wall_s = time.monotonic() - t0
        produced = sum(s.video_packets for s in sinks) - f0
    finally:
        pipeline.close()
    return {
        "frames": produced,
        "cpu_s": round(cpu_s, 3),
        "wall_s": round(wall_s, 3),
        "cpu_ms_per_frame": round(cpu_s * 1000.0 / max(produced, 1), 3),
        "frames_per_cpu_s": round(produced / max(cpu_s, 1e-9), 2),
    }


class MaximizeSearch:
    """Doubling, then bisection (the upstream project's `MaximizeU64`)."""

    def __init__(self, start: int) -> None:
        self.value = start
        self.lower = 0
        self.upper: Optional[int] = None
        self.first = True

    def next(self, prev_success: bool) -> Optional[int]:
        if self.first:
            self.first = False
            return self.value
        if prev_success:
            self.lower = max(self.lower, self.value)
        else:
            self.upper = self.value if self.upper is None else min(self.upper, self.value)
        if self.upper is None:
            self.value *= 2
            return self.value
        if self.upper - self.lower <= 1:
            return None
        self.value = (self.lower + self.upper) // 2
        return self.value


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the search (or the pinned mode), print the JSON line and return it."""
    ap = argparse.ArgumentParser(description="Most simultaneous real-time streams.")
    ap.add_argument("--resolution", default="480p", choices=sorted(RESOLUTIONS))
    ap.add_argument("--framerate", type=int, default=24)
    ap.add_argument("--ratio", type=int, default=1,
                    help="inputs per output (1, 2 or 4 like the reference)")
    ap.add_argument("--preset", default="ultrafast")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--start", type=int, default=1)
    ap.add_argument("--max", type=int, default=256)
    ap.add_argument("--pinned", action="store_true",
                    help="pinned-cost mode: fixed inputs, AOT + never-drop, "
                         "report CPU ms per output frame (load-independent)")
    ap.add_argument("--inputs", type=int, default=4,
                    help="(--pinned) fixed input count")
    ap.add_argument("--frames", type=int, default=240,
                    help="(--pinned) output frames to measure over")
    ap.add_argument("--device", default=None,
                    help='"cpu" to compose on the CPU; the CUDA card if omitted')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    w, h = RESOLUTIONS[args.resolution]
    tmp = tempfile.mkdtemp(prefix="smelter_bench_")
    try:
        src = os.path.join(tmp, "src.mp4")
        print(f"generating {args.resolution}@{args.framerate} source...", file=sys.stderr)
        make_source(src, w, h, args.framerate, preset=args.preset)

        if args.pinned:
            r = run_pinned(src, args.inputs, args.ratio, w, h, args.framerate,
                           args.preset, args.frames, device)
            res = {
                "metric": f"pinned_cpu_ms_per_frame_{args.resolution}p"
                          f"{args.framerate}_in{args.inputs}_ratio{args.ratio}"
                          f"_{args.preset}",
                "value": r["cpu_ms_per_frame"],
                "unit": "cpu_ms/frame",
                **r,
                "card": card(device),
            }
            print(json.dumps(res), flush=True)
            return res

        search = MaximizeSearch(args.start)
        n = search.next(False)
        best = 0
        results = []
        while n is not None and n <= args.max:
            print(f"trial: {n} inputs / {max(1, math.ceil(n / args.ratio))} outputs...",
                  file=sys.stderr, end=" ", flush=True)
            trial = run_trial(src, n, args.ratio, w, h, args.framerate,
                              args.preset, args.duration, device)
            print("OK" if trial["success"] else f"FAIL {trial['outputs']}", file=sys.stderr)
            results.append({"n_inputs": n, **trial})
            if trial["success"]:
                best = max(best, n)
            n = search.next(trial["success"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    res = {
        "metric": f"max_realtime_streams_{args.resolution}p{args.framerate}"
                  f"_ratio{args.ratio}_{args.preset}",
        "value": best,
        "unit": "inputs",
        "outputs": max(1, math.ceil(best / args.ratio)) if best else 0,
        "trials": results,
        "card": card(device),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
