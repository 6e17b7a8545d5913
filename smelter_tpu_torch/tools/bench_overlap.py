"""Overlap of host transfers, compose and host codecs (the port of the
reference's `tools/bench_overlap.py`), on the steady-state hot loop:

  decode (host) -> upload (host -> card) -> compose -> download (card ->
  host) -> encode (host, x264)

    python -m smelter_tpu_torch.tools.bench_overlap [--width 1920] [--height 1080]
        [--inputs 4] [--frames 120] [--depth 3] [--no-codec] [--device cpu]

Two modes over identical work:
  serial:    wait after every stage (upload, compose, download): no overlap;
  pipelined: up to DEPTH frames in flight. The uploads run from pinned host
             memory on a copy stream into a ring of DEPTH device input sets,
             the compose (`make_compose`, captured into a CUDA graph) on the
             compute stream, and each frame's download is a non-blocking
             copy into pinned memory with an event (`pipeline/output.py`'s
             `to_host_async`), waited on DEPTH frames later, so that frame
             N's download overlaps frame N+1's upload and compose and the
             host encodes while the card works.

The compose: N planar YUV420 inputs -> RGBA -> a bilinear resize of each
into a grid -> YUV420 (kernel K2 on the card). Without --no-codec the
encoder is the codec service's H.264 (FFmpeg); where it cannot load, the
tool raises with the loader's message. Runs on the card unless given
`--device cpu`; without a card it raises.

Prints one JSON line with both frame rates, the overlap speedup and "card".
"""

from __future__ import annotations

import argparse
import json
import math
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from smelter_tpu_torch.core.types import Frame, PixelFormat, Resolution
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.ops import color_convert as cc
from smelter_tpu_torch.ops.resample import resize_bilinear
from smelter_tpu_torch.pipeline.output import to_host_async
from smelter_tpu_torch.render.capture import capture
from smelter_tpu_torch.tools._profile import card


def make_compose(n: int, w: int, h: int, device):
    """The compose of `n` inputs into a `w` x `h` YUV420 frame: each input's
    (Y, U, V) planes (stacked, u8) -> RGBA -> resized bilinearly into its
    tile of a ceil(sqrt(n))-column grid -> YUV420 u8 planes."""
    device = torch.device(device)
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    tw, th = w // cols, h // rows

    def compose(ys, us, vs):
        grid = torch.zeros((h, w, 4), dtype=torch.float32, device=device)
        for i in range(n):
            rgba = cc.planar_yuv_to_rgba(ys[i], us[i], vs[i])
            r, c = divmod(i, cols)
            grid[r * th:(r + 1) * th, c * tw:(c + 1) * tw] = resize_bilinear(rgba, th, tw)
        return cc.rgba_to_planar_yuv420(grid)

    return compose


def main(argv: Optional[List[str]] = None) -> dict:
    """Run both modes, print the JSON line and return it."""
    ap = argparse.ArgumentParser(description="Transfer, compose and codec overlap.")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--inputs", type=int, default=4)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--depth", type=int, default=3,
                    help="in-flight frames in pipelined mode")
    ap.add_argument("--no-codec", action="store_true",
                    help="skip decode/encode (pure transfer+compute overlap)")
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU; the CUDA card if omitted')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    W, H, N = args.width, args.height, args.inputs

    rng = np.random.default_rng(0)
    host_y = [rng.integers(16, 235, (H, W), np.uint8) for _ in range(N)]
    host_u = [rng.integers(16, 240, (H // 2, W // 2), np.uint8) for _ in range(N)]
    host_v = [rng.integers(16, 240, (H // 2, W // 2), np.uint8) for _ in range(N)]
    # the decoded frames, stacked once into (pinned) host memory
    host = tuple(torch.from_numpy(np.stack(p)) for p in (host_y, host_u, host_v))
    if cuda:
        host = tuple(p.pin_memory() for p in host)

    enc = None
    if not args.no_codec:
        from smelter_tpu_torch.io.codec import Codec, VideoEncoder

        enc = VideoEncoder(Codec.H264, W, H, 30)

    def encode(y, u, v, i):
        if enc is not None:
            enc.send(np.asarray(y), np.asarray(u), np.asarray(v), i / 30.0)
            while True:
                p = enc.receive()
                if p is None or p == "eof":
                    break

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    try:
        # build and capture the compose, warm the transfer paths
        prog, out = capture(make_compose(N, W, H, device),
                            tuple(p.to(device) for p in host), device)
        sync()

        # --- serial: every stage completes before the next starts
        t0 = time.monotonic()
        for i in range(args.frames):
            planes = tuple(p.to(device, non_blocking=True) for p in host)
            sync()
            out = prog(*planes)
            sync()
            oy, ou, ov = (p.cpu().numpy() for p in out)
            encode(oy, ou, ov, i)
        serial_s = time.monotonic() - t0

        # --- pipelined: a depth-N in-flight window
        depth = args.depth
        ring = [tuple(torch.empty(p.shape, dtype=p.dtype, device=device) for p in host)
                for _ in range(depth)]
        copies = torch.cuda.Stream(device) if cuda else None
        released = [None] * depth  # per set: the event of the last compose that read it
        inflight: deque = deque()
        done = 0
        t0 = time.monotonic()
        for i in range(args.frames):
            k = i % depth
            if cuda:
                with torch.cuda.stream(copies):
                    if released[k] is not None:
                        copies.wait_event(released[k])
                    for d, h in zip(ring[k], host):
                        d.copy_(h, non_blocking=True)
                    uploaded = torch.cuda.Event()
                    uploaded.record(copies)
                torch.cuda.current_stream(device).wait_event(uploaded)
            else:
                for d, h in zip(ring[k], host):
                    d.copy_(h)
            out = prog(*ring[k])
            if cuda:
                released[k] = torch.cuda.Event()
                released[k].record()
            inflight.append(to_host_async(Frame(
                data=out, format=PixelFormat.PLANAR_YUV420, resolution=Resolution(W, H),
                pts=i / 30.0)))
            if len(inflight) >= depth:
                oy, ou, ov = inflight.popleft().wait().data  # the OLDEST frame
                encode(oy, ou, ov, done)
                done += 1
        while inflight:
            oy, ou, ov = inflight.popleft().wait().data
            encode(oy, ou, ov, done)
            done += 1
        pipe_s = time.monotonic() - t0
    finally:
        if enc is not None:
            enc.close()

    serial_fps = args.frames / serial_s
    pipe_fps = args.frames / pipe_s
    res = {
        "metric": "overlap_speedup",
        "value": round(pipe_fps / serial_fps, 3),
        "unit": "x",
        "serial_fps": round(serial_fps, 2),
        "pipelined_fps": round(pipe_fps, 2),
        "inputs": N,
        "resolution": f"{W}x{H}",
        "depth": args.depth,
        "codec_stages": not args.no_codec,
        "device": device.type,
        "card": card(device),
    }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
