"""General-scene compose benchmark: device time per frame of canonical
non-grid scenes through the port's `Renderer` (the port of the reference's
`tools/bench_scenes.py`).

    python -m smelter_tpu_torch.tools.bench_scenes [--scene NAME] [--ops] [--iters N]
        [--out 1920x1080] [--inres 960x540] [--device cpu]

For each scene: build a Renderer on the card (or the CPU under `--device
cpu`; without a card it raises), capture the frame program on the first
frame and settle for three frames, then render ITERS frames, alternating
between two seeded input sets, under torch.profiler, and read each frame's
device time off the trace (`tools/_profile.py`: the time the card is busy
with it, planning and host copies left out). With --ops, also the top
kernels per frame by name. The renderer keeps synchronous captures, so no
frame of the timed window captures a new structure.

Prints one JSON line per scene: scene, device_p50_ms, device_p95_ms, frames,
top_ops_ms_per_frame (with --ops) and card.
"""

from __future__ import annotations

import argparse
import json
import statistics
from typing import List, Optional

from smelter_tpu_torch.core.types import FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.render.renderer import Renderer
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.layout_types import BorderRadius, BoxShadow
from smelter_tpu_torch.tools._inputs import parse_resolution, seeded_frame_sets
from smelter_tpu_torch.tools._profile import FrameProfile, card

SETTLE_FRAMES = 3


def scene_renderer(make_scene, n_inputs: int, out_res: Resolution, device) -> Renderer:
    """A renderer with inputs `cam_0 .. cam_{n-1}` registered and the scene
    set on output "out" (PLANAR_YUV420)."""
    r = Renderer(device=device)
    for i in range(n_inputs):
        r.register_input(f"cam_{i}")
    r.update_scene("out", make_scene(), out_res, PixelFormat.PLANAR_YUV420)
    return r


def bench_scene(name: str, make_scene, n_inputs: int, out_res: Resolution,
                in_res: Resolution, iters: int, want_ops: bool, device) -> dict:
    frames0, frames1 = seeded_frame_sets(n_inputs, in_res)
    r = scene_renderer(make_scene, n_inputs, out_res, device)
    try:
        # capture (synchronous first frame) + settle
        for k in range(SETTLE_FRAMES):
            r.render(FrameSet(pts=k / 60.0, frames=frames0))
        with FrameProfile(device) as fp:
            for k in range(iters):
                with fp.frame():
                    r.render(FrameSet(pts=(k + SETTLE_FRAMES) / 60.0,
                                      frames=(frames0, frames1)[k % 2]))
    finally:
        r.close()
    durs = sorted(fp.busy_ms())
    res = {
        "scene": name,
        "device_p50_ms": round(statistics.median(durs), 3),
        "device_p95_ms": round(durs[max(0, int(len(durs) * 0.95) - 1)], 3),
        "frames": len(durs),
    }
    if want_ops:
        ops = sorted(fp.op_totals_ms().items(), key=lambda kv: -kv[1])[:12]
        res["top_ops_ms_per_frame"] = [(n[:70], round(t / len(durs), 3)) for n, t in ops]
    res["card"] = card(device)
    return res


def scene_defs():
    """name -> (scene builder, number of inputs), as the reference's."""

    def two_tiles():
        return comp.View(
            background_color=RGBAColor(10, 10, 10),
            children=[
                comp.Rescaler(child=comp.InputStream(input_id="cam_0")),
                comp.Rescaler(child=comp.InputStream(input_id="cam_1")),
            ],
        )

    def rounded():
        return comp.View(
            background_color=RGBAColor(20, 20, 40),
            children=[
                comp.Rescaler(
                    child=comp.InputStream(input_id=f"cam_{i}"),
                    border_radius=BorderRadius(24, 24, 24, 24),
                )
                for i in range(4)
            ],
        )

    def shadow():
        return comp.View(
            background_color=RGBAColor(20, 20, 40),
            children=[
                comp.Rescaler(
                    child=comp.InputStream(input_id=f"cam_{i}"),
                    border_radius=BorderRadius(24, 24, 24, 24),
                    box_shadow=[
                        BoxShadow(offset_x=8, offset_y=8, blur_radius=16,
                                  color=RGBAColor(0, 0, 0, 200))
                    ],
                )
                for i in range(4)
            ],
        )

    def rotation30():
        return comp.View(
            background_color=RGBAColor(20, 20, 40),
            children=[
                comp.Rescaler(
                    child=comp.InputStream(input_id="cam_0"),
                    position=comp.AbsolutePosition(
                        width=700.0, height=400.0, top=300.0, left=500.0,
                        rotation_degrees=30.0,
                    ),
                ),
            ],
        )

    def rotation30_masked():
        # a rotated view with an opaque background: the child is clipped by
        # its parent's mask (the masked-rotation path)
        return comp.View(
            background_color=RGBAColor(20, 20, 40),
            children=[
                comp.View(
                    position=comp.AbsolutePosition(
                        width=700.0, height=400.0, top=300.0, left=500.0,
                        rotation_degrees=30.0,
                    ),
                    background_color=RGBAColor(0, 0, 0, 255),
                    children=[comp.InputStream(input_id="cam_0")],
                ),
            ],
        )

    def mixed4():
        return comp.View(
            background_color=RGBAColor(20, 20, 40),
            children=[
                comp.Rescaler(
                    child=comp.InputStream(input_id="cam_0"),
                    position=comp.AbsolutePosition(
                        width=900.0, height=510.0, top=60.0, left=60.0
                    ),
                ),
                comp.Rescaler(
                    child=comp.InputStream(input_id="cam_1"),
                    position=comp.AbsolutePosition(
                        width=600.0, height=339.0, top=120.0, left=1080.0
                    ),
                    border_radius=BorderRadius(18, 18, 18, 18),
                    box_shadow=[
                        BoxShadow(offset_x=6, offset_y=6, blur_radius=12,
                                  color=RGBAColor(0, 0, 0, 200))
                    ],
                ),
                comp.Rescaler(
                    child=comp.InputStream(input_id="cam_2"),
                    position=comp.AbsolutePosition(
                        width=720.0, height=405.0, top=600.0, left=180.0
                    ),
                    border_width=4.0, border_color=RGBAColor(255, 255, 255),
                ),
                comp.Rescaler(
                    child=comp.InputStream(input_id="cam_3"),
                    position=comp.AbsolutePosition(
                        width=640.0, height=360.0, top=640.0, left=1040.0,
                        rotation_degrees=12.0,
                    ),
                ),
            ],
        )

    return {
        "two_tiles": (two_tiles, 2),
        "rounded": (rounded, 4),
        "shadow": (shadow, 4),
        "rotation30": (rotation30, 1),
        "rotation30_masked": (rotation30_masked, 1),
        "mixed4": (mixed4, 4),
    }


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Run the benchmark, print one JSON line per scene and return them."""
    ap = argparse.ArgumentParser(description="Device time per frame of general scenes.")
    ap.add_argument("--scene", default=None, help="one scene (default: all)")
    ap.add_argument("--ops", action="store_true", help="top kernels per scene")
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--out", default="1920x1080")
    ap.add_argument("--inres", default="960x540")
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU; the CUDA card if omitted')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    defs = scene_defs()
    results = []
    for name in [args.scene] if args.scene else list(defs):
        make, n_inputs = defs[name]
        res = bench_scene(name, make, n_inputs, parse_resolution(args.out),
                          parse_resolution(args.inres), args.iters, args.ops, device)
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    main()
