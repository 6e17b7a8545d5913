"""Device time of animated geometry through the port's `Renderer` (the port
of the reference's `tools/bench_animations.py`): a Tiles grid that gains a
tile (8 -> 9, every tile moves and resizes), then four animations of one
box: slide, spin, zoom and roto-zoom.

    python -m smelter_tpu_torch.tools.bench_animations [--out 1920x1080]
        [--inres 960x540] [--frames 30] [--device cpu]

For each: render the scene, start a 4 s transition, render its first
frames (which capture the programs the transition needs), then render a
burst of frames at increasing pts under torch.profiler and read each
frame's device time off the trace (`tools/_profile.py`). Runs on the card
unless given `--device cpu`; without a card it raises.

`retraces_during_animation` counts the structure keys that the output's
program adds to its cache (`OutputProgram._build_cache`, the counterpart
of the reference's `_jit_cache`) during the burst: each is a program built
and captured in the middle of the animation. The reference's count is 0 by
construction; the port's may not be (a growing box can change the size
bucket of its buffers), and is reported as it is.

The box positions are the reference's, given for a 1920x1080 output; under
`--out` they scale with the output's size. Prints one JSON line per
animation, with the reference's keys and "card".
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional

from smelter_tpu_torch.core.types import FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.render.renderer import Renderer
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.components import AbsolutePosition, Transition
from smelter_tpu_torch.tools._inputs import make_test_input, parse_resolution
from smelter_tpu_torch.tools._profile import FrameProfile, card

REFERENCE_OUT = Resolution(1920, 1080)  # the output the positions are given for
TRANSITION_S = 4.0
TILES_FRAMES = 20

ANIMATIONS = {
    "slide_position": (
        AbsolutePosition(width=900.0, height=500.0, top=100.0, left=0.0),
        AbsolutePosition(width=900.0, height=500.0, top=100.0, left=1000.0),
    ),
    "spin_rotation": (
        AbsolutePosition(width=900.0, height=500.0, top=200.0, left=400.0,
                         rotation_degrees=0.0),
        AbsolutePosition(width=900.0, height=500.0, top=200.0, left=400.0,
                         rotation_degrees=80.0),
    ),
    "zoom_size": (
        AbsolutePosition(width=400.0, height=225.0, top=300.0, left=600.0),
        AbsolutePosition(width=1600.0, height=900.0, top=90.0, left=160.0),
    ),
    "rotozoom_combo": (
        AbsolutePosition(width=400.0, height=225.0, top=300.0, left=600.0,
                         rotation_degrees=0.0),
        AbsolutePosition(width=1400.0, height=800.0, top=140.0, left=260.0,
                         rotation_degrees=60.0),
    ),
}


def scaled(pos, out: Resolution):
    """`pos` (a position given for a 1920x1080 output) on an `out` canvas:
    its width and left scaled by the widths' ratio, its height and top by
    the heights'."""
    sx, sy = out.width / REFERENCE_OUT.width, out.height / REFERENCE_OUT.height
    if (sx, sy) == (1.0, 1.0):
        return pos
    return dataclasses.replace(pos, width=pos.width * sx, height=pos.height * sy,
                               top=pos.top * sy, left=pos.left * sx)


def tiles_scene(n: int, transition: Optional[Transition] = None) -> comp.Tiles:
    return comp.Tiles(
        id="grid", background_color=RGBAColor(12, 12, 12, 255),
        transition=transition,
        children=[comp.InputStream(input_id=f"in_{i}") for i in range(n)],
    )


def box_scene(pos, transition: Optional[Transition] = None) -> comp.View:
    box = comp.View(
        id="box", position=pos,
        background_color=RGBAColor(0, 0, 0, 255),
        transition=transition,
        children=[comp.InputStream(input_id="cam")],
    )
    return comp.View(background_color=RGBAColor(10, 10, 30, 255), children=[box])


def _p50(durs):
    return round(durs[len(durs) // 2], 3)


def bench_tiles_relayout(out: Resolution, in_res: Resolution, device) -> dict:
    """Tiles grid re-layout: adding a child animates every tile at once."""
    n0, n1 = 8, 9
    r = Renderer(device=device)
    try:
        for i in range(n1):
            r.register_input(f"in_{i}")

        def frames(n, pts=0.0):
            return {f"in_{i}": make_test_input(i, in_res, pts) for i in range(n)}

        r.update_scene("out", tiles_scene(n0), out, PixelFormat.RGBA)
        r.render(FrameSet(pts=0.0, frames=frames(n0)))
        r.update_scene("out", tiles_scene(n1, Transition(duration=TRANSITION_S)), out,
                       PixelFormat.RGBA)
        for pts in (0.2, 0.4):
            r.render(FrameSet(pts=pts, frames=frames(n1, pts)))
        with FrameProfile(device) as fp:
            for i in range(TILES_FRAMES):
                pts = 0.5 + i * 0.15
                frame_set = FrameSet(pts=pts, frames=frames(n1, pts))
                with fp.frame():
                    r.render(frame_set)
    finally:
        r.close()
    durs = sorted(fp.busy_ms())
    return {"animation": f"tiles_relayout_{n0}to{n1}", "device_p50_ms": _p50(durs),
            "frames": len(durs), "card": card(device)}


def bench_animation(name: str, out: Resolution, in_res: Resolution, frames: int,
                    device) -> dict:
    """One box animation: `frames` frames at pts 0.3 + 0.1 i, inside its
    4 s transition."""
    pos0, pos1 = (scaled(p, out) for p in ANIMATIONS[name])
    r = Renderer(device=device)
    try:
        r.register_input("cam")
        r.update_scene("out", box_scene(pos0), out, PixelFormat.RGBA)
        r.render(FrameSet(pts=0.0, frames={"cam": make_test_input(0, in_res)}))
        r.update_scene("out", box_scene(pos1, Transition(duration=TRANSITION_S)), out,
                       PixelFormat.RGBA)
        # the first frame of the transition builds its program
        r.render(FrameSet(pts=0.2, frames={"cam": make_test_input(0, in_res, 0.2)}))
        prog = r._programs["out"]
        before = set(prog._build_cache)
        added = set()
        with FrameProfile(device) as fp:
            for i in range(frames):
                pts = 0.3 + i * 0.1  # inside the 4 s transition
                frame_set = FrameSet(pts=pts, frames={"cam": make_test_input(0, in_res, pts)})
                with fp.frame():
                    r.render(frame_set)
                # each frame: the cache evicts its oldest keys past its bound
                added |= set(prog._build_cache) - before
    finally:
        r.close()
    durs = sorted(fp.busy_ms())
    return {
        "animation": name,
        "device_p50_ms": _p50(durs),
        "device_p95_ms": round(durs[max(0, int(len(durs) * 0.95) - 1)], 3),
        "frames": len(durs),
        "retraces_during_animation": len(added),
        "card": card(device),
    }


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run every animation, print one JSON line each and return them."""
    ap = argparse.ArgumentParser(description="Device time per frame of animated geometry.")
    ap.add_argument("--out", default="1920x1080")
    ap.add_argument("--inres", default="960x540")
    ap.add_argument("--frames", type=int, default=30,
                    help="frames timed per box animation")
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU; the CUDA card if omitted')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out, in_res = parse_resolution(args.out), parse_resolution(args.inres)

    results = [bench_tiles_relayout(out, in_res, device)]
    print(json.dumps(results[-1]), flush=True)
    for name in ANIMATIONS:
        results.append(bench_animation(name, out, in_res, args.frames, device))
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
