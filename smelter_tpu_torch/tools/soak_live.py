"""Live-render soak on the port (the counterpart of the reference's
`tools/soak_live.py`): scene-structure churn while a hot loop renders.

    python -m smelter_tpu_torch.tools.soak_live [--rounds 20] [--seconds 12]
        [--out 1280x720] [--inres 640x360] [--device cpu]

Each round builds one `Renderer(RendererOptions(async_compile=True))` and
renders two host YUV420 inputs into a YUV420 output. Every 3 s it changes
the scene's structure (a new static rotation angle and tile width), and the
loop below keeps rendering at full speed: on the card each new structure is
captured into a CUDA graph on a background thread (`render/capture.py`)
while the renderer thread replays and re-emits the output's last frame
(the freeze-frame). The reference soaked its JAX tracing this way; the port
soaks its background captures. Runs on the card unless given `--device
cpu`; without a card it raises.

The scene's positions are the reference's, given for a 1280x720 output;
under `--out` they scale with the output's size. Prints one "round i/N:
CLEAN ..." line per round and the result; exits 0 when every round is
clean, 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from smelter_tpu_torch.bench import _sync
from smelter_tpu_torch.core.types import (
    Frame,
    FrameSet,
    PixelFormat,
    Resolution,
    RGBAColor,
)
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.ops.color_convert import rgba_to_planar_yuv420
from smelter_tpu_torch.render.renderer import Renderer, RendererOptions
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.tools._inputs import parse_resolution

REFERENCE_OUT = Resolution(1280, 720)  # the output the positions are given for
BURST_S = 3.0


def round_inputs(idx: int, in_res: Resolution, device) -> Dict[str, Frame]:
    """The round's two inputs, cam_0 and cam_1: opaque random RGBA frames
    from `np.random.RandomState(idx)`, converted to planar YUV420 on
    `device` and copied to the host."""
    rng = np.random.RandomState(idx)

    def yuv_frame() -> Frame:
        w, h = in_res.width, in_res.height
        rgba = rng.randint(0, 255, (h, w, 4), np.uint8)
        rgba[..., 3] = 255
        rgba = torch.from_numpy(rgba.astype(np.float32) / 255.0).to(device)
        planes = tuple(p.cpu().numpy() for p in rgba_to_planar_yuv420(rgba))
        return Frame(data=planes, format=PixelFormat.PLANAR_YUV420,
                     resolution=Resolution(w, h), pts=0.0)

    return {"cam_0": yuv_frame(), "cam_1": yuv_frame()}


def scene(angle: float, wpx: float, out: Resolution = REFERENCE_OUT) -> comp.View:
    """The soak's scene: input 0 in a rotated box over input 1 filling the
    output. The box's width `wpx`, its top and left are given for a
    1280x720 output and scale with `out` (its height is 9/16 of its
    width)."""
    sx, sy = out.width / REFERENCE_OUT.width, out.height / REFERENCE_OUT.height
    return comp.View(
        background_color=RGBAColor(20, 20, 40),
        children=[
            comp.Rescaler(
                child=comp.InputStream(input_id="cam_0"),
                position=comp.AbsolutePosition(
                    width=wpx * sx, height=wpx * 9 / 16 * sy, top=80.0 * sy,
                    left=120.0 * sx, rotation_degrees=angle,
                ),
            ),
            comp.Rescaler(child=comp.InputStream(input_id="cam_1")),
        ],
    )


def run_round(idx: int, seconds: float, device=None, out: Resolution = REFERENCE_OUT,
              in_res: Resolution = Resolution(640, 360)) -> dict:
    """One round of `seconds` of churn on `device` (the card if None).
    Returns the counts of the round: frames rendered, structure updates,
    the frames and the frozen frames of each update's burst
    (`frames_by_update`, `frozen_by_update`: an update whose scene never
    reached the output has every frame of its burst frozen), the
    background captures of each update with their ms and graph bytes, the
    round's seconds (`elapsed_s`, the device synchronised at its end) and
    `last`: the last frame of the newest scene shown, with its pts, angle,
    width and host planes, and the round's inputs (`inputs`)."""
    device = resolve_device(device)
    r = Renderer(RendererOptions(async_compile=True), device=device)
    r.register_input("cam_0")
    r.register_input("cam_1")
    frames = round_inputs(idx, in_res, device)

    t_start = time.perf_counter()
    # first structure captures synchronously so the async path has a last
    # frame to freeze
    r.update_scene("out", scene(10.0, 500.0, out), out, PixelFormat.PLANAR_YUV420)
    first = r.render(FrameSet(pts=0.0, frames=frames)).frames["out"].data
    _sync(device)

    n_frames = 0
    n_updates = 0
    frames_by_update: List[int] = []
    frozen_by_update: List[int] = []
    captures: List[List[dict]] = []
    shown = (0.0, 10.0, 500.0, first)
    deadline = time.monotonic() + seconds
    pts = 0.0
    angle = 10.0
    wpx = 500.0
    try:
        while time.monotonic() < deadline:
            # structure churn: a NEW rotation angle + tile size -> a fresh
            # program captured in the background while the loop below keeps
            # rendering (freeze-frame fallback)
            angle = (angle + 7.0) % 80.0 + 3.0
            wpx = 420.0 + (n_updates % 5) * 40.0
            r.update_scene("out", scene(angle, wpx, out), out, PixelFormat.PLANAR_YUV420)
            n_updates += 1
            program = r._programs["out"]
            n_burst = frozen = 0
            last = shown[3]
            burst_end = time.monotonic() + BURST_S
            while time.monotonic() < burst_end:
                pts += 1 / 60.0
                data = r.render(FrameSet(pts=pts, frames=frames)).frames["out"].data
                n_frames += 1
                n_burst += 1
                if data is last:  # the freeze-frame re-emits the last frame's planes
                    frozen += 1
                else:
                    shown = (pts, angle, wpx, data)
                last = data
            frames_by_update.append(n_burst)
            frozen_by_update.append(frozen)
            # the update's captures, read before the next update drops its program
            captures.append([{"capture_ms": p.capture_ms, "graph_bytes": p.graph_bytes}
                             for p in dict(program._build_cache).values()])
        _sync(device)
        elapsed = time.perf_counter() - t_start
    finally:
        # drain captures before closing
        r.close()
    pts_shown, angle_shown, wpx_shown, planes = shown
    return {"round": idx, "frames": n_frames, "updates": n_updates,
            "frames_by_update": frames_by_update, "frozen_by_update": frozen_by_update,
            "captures": captures,
            "elapsed_s": elapsed,
            "last": {"pts": pts_shown, "angle": angle_shown, "wpx": wpx_shown,
                     "planes": tuple(p.cpu().numpy() for p in planes)},
            "inputs": frames}


def main(argv: Optional[List[str]] = None) -> int:
    """Run the rounds, print a line per round and the result; returns the
    exit code (1 when a round failed)."""
    ap = argparse.ArgumentParser(description="Live-render soak: structure churn under a hot "
                                             "render loop.")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--out", default="1280x720")
    ap.add_argument("--inres", default="640x360")
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU; the CUDA card if omitted')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out, in_res = parse_resolution(args.out), parse_resolution(args.inres)

    failures = 0
    for i in range(args.rounds):
        t0 = time.monotonic()
        try:
            info = run_round(i, args.seconds, device, out, in_res)
            print(
                f"round {i + 1}/{args.rounds}: CLEAN "
                f"({info['frames']} frames, {info['updates']} structure "
                f"updates, {time.monotonic() - t0:.1f}s)",
                flush=True,
            )
        except Exception as e:  # noqa: BLE001 - report and count
            failures += 1
            print(f"round {i + 1}/{args.rounds}: FAILED: {e!r}", flush=True)
    print(f"soak result: {args.rounds - failures}/{args.rounds} clean")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
