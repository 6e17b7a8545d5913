"""Generate the documentation media set through the port's wire API (the
counterpart of the reference's `tools/docs_examples.py`, with its catalog,
requests and `.requests.json`).

Every guide and component page gets a clip rendered by the port's server
(`server.app.ApiState` / `build_app`, in process) through the same JSON
requests the docs would show. Outputs land in
`<out>/{inputs,guides,components}/` as MP4, plus a `.requests.json` per
clip recording the exact wire traffic that produced it. The default `<out>`
is the git-ignored `generated/docs/`; the committed `docs/generated/` is
the reference's and is never written here unless asked for.

Usage:
    python -m smelter_tpu_torch.tools.docs_examples                  # render everything
    python -m smelter_tpu_torch.tools.docs_examples --list           # show the catalog
    python -m smelter_tpu_torch.tools.docs_examples --only tiles     # one example
    python -m smelter_tpu_torch.tools.docs_examples --duration 4     # shorter clips (CI)

Runs fully offline (AOT pipeline). Composes on the CUDA card unless
SMELTER_DEVICE=cpu; without a card it raises. It reads and writes MP4, so
it needs FFmpeg: where the codec service cannot load, it stops after one
probe with the loader's message.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO / "generated" / "docs"  # git-ignored

W, H = 1280, 720
FPS = 30

# the reference's six labeled input colors (generate_docs_example_inputs.rs)
INPUT_COLORS = [
    ("Input 1", "#624BAAFF"),
    ("Input 2", "#BF374EFF"),
    ("Input 3", "#3DA362FF"),
    ("Input 4", "#A6A653FF"),
    ("Input 5", "#53A6A6FF"),
    ("Input 6", "#A653A6FF"),
]


# --------------------------------------------------------------------- studio


class Studio:
    """One in-process server; each clip gets a fresh pipeline via /api/reset."""

    def __init__(self) -> None:
        import httpx

        from smelter_tpu_torch.config import Config, LoggerConfig
        from smelter_tpu_torch.core.types import Framerate
        from smelter_tpu_torch.server.app import ApiState, build_app

        self.state = ApiState(Config(
            output_framerate=Framerate(FPS),
            ahead_of_time_processing=True,
            never_drop_output_frames=True,
            logger=LoggerConfig(level="warning"),
        ))
        self._port = None
        self._loop = None
        self._up = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, args=(build_app,), daemon=True
        )
        self._thread.start()
        if not self._up.wait(timeout=30):
            raise RuntimeError("studio server did not start")
        self.http = httpx.Client(
            base_url=f"http://127.0.0.1:{self._port}", timeout=600
        )

    def _serve(self, build_app) -> None:
        from aiohttp import web

        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)

        async def up():
            runner = web.AppRunner(build_app(self.state))
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            self._port = runner.addresses[0][1]
            self._up.set()

        self._loop.run_until_complete(up())
        self._loop.run_forever()

    def close(self) -> None:
        try:
            self.http.close()
            self.state.pipeline.close()
        finally:
            if self._loop:
                self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout=5)

    # -- clip rendering -------------------------------------------------------

    def render_clip(self, out_mp4: Path, requests: list, *,
                    record: bool = True) -> None:
        """Replay `requests` ([(route, body), ...]) on a fresh pipeline, start,
        and block until every registered output reports OUTPUT_DONE."""
        out_mp4.parent.mkdir(parents=True, exist_ok=True)
        if out_mp4.exists():
            out_mp4.unlink()
        r = self.http.post("/api/reset", json={})
        r.raise_for_status()
        outputs = set()
        for route, body in requests:
            resp = self.http.post(route, json=body)
            if resp.status_code != 200:
                raise RuntimeError(f"{route}: {resp.status_code} {resp.text}")
            parts = route.strip("/").split("/")
            if parts[:2] == ["api", "output"] and parts[-1] == "register":
                outputs.add(parts[2])
        self.http.post("/api/start", json={}).raise_for_status()
        deadline = time.time() + 600
        while time.time() < deadline:
            done = {
                e.entity_id
                for e in self.state.pipeline.events.history()
                if e.kind == "OUTPUT_DONE"
            }
            if outputs <= done:
                break
            time.sleep(0.25)
        else:
            raise RuntimeError(f"timed out waiting for outputs {outputs}")
        if record:
            doc = [{"route": r_, "body": b} for r_, b in requests]
            out_mp4.with_suffix(".requests.json").write_text(
                json.dumps(doc, indent=2) + "\n"
            )


# ------------------------------------------------------------ request helpers


def mp4_output(path: Path, scene: dict, *, dur: float,
               size=(W, H)) -> list:
    """Register an MP4 output with `scene` and schedule its end at `dur`."""
    return [
        (f"/api/output/output_1/register", {
            "type": "mp4",
            "path": str(path),
            "video": {
                "resolution": {"width": size[0], "height": size[1]},
                "encoder": {"type": "ffmpeg_h264", "preset": "fast"},
                "initial": {"root": scene},
            },
        }),
        (f"/api/output/output_1/unregister",
         {"schedule_time_ms": dur * 1000.0}),
    ]


def scene_updates(scenes: list, step: float) -> list:
    """Schedule each (time-offset multiplier irrelevant) scene at step*k."""
    return [
        ("/api/output/output_1/update",
         {"video": {"root": scene}, "schedule_time_ms": step * k * 1000.0})
        for k, scene in enumerate(scenes[1:], start=1)
    ]


def register_inputs(ctx: dict, names: list) -> list:
    return [
        (f"/api/input/{n}/register",
         {"type": "mp4", "path": str(ctx["inputs"][n]),
          "required": True, "offset_ms": 0})
        for n in names
    ]


def stream(input_id: str) -> dict:
    return {"type": "input_stream", "input_id": input_id}


# -------------------------------------------------------------- input clips


def labeled_input_requests(path: Path, label: str, color: str,
                           dur: float) -> list:
    """A solid-color clip with a big centered label and a live seconds timer
    in the corner (the docs input look from generate_docs_example_inputs.rs,
    rebuilt as per-second scheduled updates instead of per-frame ones)."""

    def scene(t: float) -> dict:
        return {
            "type": "view",
            "background_color": color,
            "direction": "column",
            "children": [
                {"type": "view"},
                {"type": "text", "text": label, "font_size": 130.0,
                 "width": float(W), "align": "center",
                 "font_family": "DejaVu Sans"},
                {"type": "view"},
                {"type": "view", "bottom": 40.0, "right": 40.0,
                 "width": 240.0, "height": 70.0,
                 "children": [
                     {"type": "text", "id": "timer",
                      "text": f"{t:.0f}s", "font_size": 60.0,
                      "width": 240.0, "align": "right",
                      "font_family": "DejaVu Sans"},
                 ]},
            ],
        }

    reqs = mp4_output(path, scene(0.0), dur=dur)
    for k in range(1, int(dur)):
        reqs.insert(-1, ("/api/output/output_1/update", {
            "video": {"root": scene(float(k))},
            "schedule_time_ms": k * 1000.0,
        }))
    return reqs


# ------------------------------------------------------------------- catalog
# Each entry: name -> (category, needs_inputs, builder(ctx) -> requests).
# `ctx` carries input paths, the assets dir, and the clip duration.


def ex_quick_start(ctx):
    return register_inputs(ctx, ["input_1", "input_2"]) + mp4_output(
        ctx["out"], {
            "type": "tiles", "background_color": "#52505BFF",
            "children": [stream("input_1"), stream("input_2")],
        }, dur=ctx["dur"])


def ex_basic_layouts(ctx):
    """Three stages: single full-screen input, side-by-side, then an overlay
    pinned to a corner — the flow of the basic-layouts guide."""
    full = {"type": "view", "background_color": "#52505BFF",
            "children": [{"type": "rescaler", "child": stream("input_1")}]}
    side = {"type": "view", "background_color": "#52505BFF", "direction": "row",
            "children": [{"type": "rescaler", "child": stream("input_1")},
                          {"type": "rescaler", "child": stream("input_2")}]}
    overlay = {"type": "view", "background_color": "#52505BFF",
               "children": [
                   {"type": "rescaler", "child": stream("input_1")},
                   {"type": "rescaler", "child": stream("input_2"),
                    "width": 320.0, "height": 180.0,
                    "top": 20.0, "right": 20.0},
               ]}
    step = ctx["dur"] / 3.0
    return (register_inputs(ctx, ["input_1", "input_2"])
            + mp4_output(ctx["out"], full, dur=ctx["dur"])
            + scene_updates([full, side, overlay], step))


def ex_view_transitions(ctx):
    """Animating a View's width with a transition, then snapping back."""
    def scene(width):
        return {"type": "view", "background_color": "#52505BFF",
                "children": [{
                    "type": "rescaler", "id": "box", "child": stream("input_1"),
                    "width": width, "height": float(width * 9 / 16),
                    "top": float((H - width * 9 / 16) / 2),
                    "left": 40.0,
                    "transition": {"duration_ms": 1500.0},
                }]}
    step = ctx["dur"] / 3.0
    return (register_inputs(ctx, ["input_1"])
            + mp4_output(ctx["out"], scene(360.0), dur=ctx["dur"])
            + scene_updates([scene(360.0), scene(1000.0), scene(360.0)], step))


def ex_view(ctx):
    return register_inputs(ctx, ["input_1", "input_2"]) + mp4_output(
        ctx["out"], {
            "type": "view", "background_color": "#52505BFF",
            "direction": "row", "padding": 20.0,
            "children": [
                {"type": "rescaler", "child": stream("input_1"),
                 "border_radius": 24.0, "border_width": 4.0,
                 "border_color": "#FFFFFFFF"},
                {"type": "view", "width": 20.0},
                {"type": "rescaler", "child": stream("input_2"),
                 "border_radius": 24.0,
                 "box_shadow": [{"offset_x": 8.0, "offset_y": 8.0,
                                  "blur_radius": 24.0,
                                  "color": "#000000B0"}]},
            ],
        }, dur=ctx["dur"])


def ex_tiles(ctx):
    """Tiles re-layout as inputs join over time (the show-component flow)."""
    def tiles(n):
        return {"type": "tiles", "id": "grid",
                "background_color": "#52505BFF", "margin": 10.0,
                "transition": {"duration_ms": 700.0},
                "children": [stream(f"input_{i+1}") for i in range(n)]}
    step = ctx["dur"] / 4.0
    return (register_inputs(ctx, ["input_1", "input_2", "input_3", "input_4"])
            + mp4_output(ctx["out"], tiles(1), dur=ctx["dur"])
            + scene_updates([tiles(1), tiles(2), tiles(3), tiles(4)], step))


def ex_rescaler(ctx):
    return register_inputs(ctx, ["input_1", "input_2"]) + mp4_output(
        ctx["out"], {
            "type": "view", "background_color": "#52505BFF",
            "direction": "row",
            "children": [
                {"type": "rescaler", "mode": "fit",
                 "child": stream("input_1")},
                {"type": "rescaler", "mode": "fill",
                 "child": stream("input_2")},
            ],
        }, dur=ctx["dur"])


def ex_text(ctx):
    return mp4_output(
        ctx["out"], {
            "type": "view", "background_color": "#52505BFF",
            "direction": "column",
            "children": [
                {"type": "view"},
                {"type": "text", "text": "Smelter on TPU",
                 "font_size": 100.0, "width": float(W), "align": "center",
                 "color": "#FFFFFFFF", "font_family": "DejaVu Sans",
                 "weight": "bold"},
                {"type": "text",
                 "text": "Every docs clip is rendered by the framework itself.",
                 "font_size": 40.0, "width": float(W), "align": "center",
                 "color": "#FFFFFFCC", "font_family": "DejaVu Sans"},
                {"type": "view"},
            ],
        }, dur=ctx["dur"])


def ex_image(ctx):
    svg = ctx["assets"] / "logo.svg"
    return [
        ("/api/image/logo/register",
         {"path": str(svg), "asset_type": "svg",
          "resolution": {"width": 240, "height": 240}}),
    ] + register_inputs(ctx, ["input_1"]) + mp4_output(
        ctx["out"], {
            "type": "view", "background_color": "#52505BFF",
            "children": [
                {"type": "rescaler", "child": stream("input_1")},
                {"type": "image", "image_id": "logo",
                 "width": 180.0, "height": 180.0},
            ],
        }, dur=ctx["dur"])


SHADER_SOURCE = """\
def main(inputs, params, resolution, time):
    # grayscale with a slow pulse back to color
    tex = inputs[0]
    rgb = tex[..., :3]
    luma = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]
            + 0.0722 * rgb[..., 2])[..., None]
    mix = 0.5 + 0.5 * jnp.sin(time * 2.0)
    out = rgb * mix + luma * (1.0 - mix)
    return jnp.concatenate([out, tex[..., 3:4]], axis=-1)
"""


def ex_shader(ctx):
    return [
        ("/api/shader/pulse/register", {"source": SHADER_SOURCE}),
    ] + register_inputs(ctx, ["input_1"]) + mp4_output(
        ctx["out"], {
            "type": "shader", "shader_id": "pulse",
            "resolution": {"width": W, "height": H},
            "children": [stream("input_1")],
        }, dur=ctx["dur"])


def ex_input_stream(ctx):
    return register_inputs(ctx, ["input_1"]) + mp4_output(
        ctx["out"], {
            "type": "view", "background_color": "#52505BFF",
            "children": [{"type": "rescaler", "child": stream("input_1")}],
        }, dur=ctx["dur"])


def ex_mp4(ctx):
    """MP4 inputs with loop + offset — the mp4-component page."""
    reqs = [
        ("/api/input/clip/register",
         {"type": "mp4", "path": str(ctx["inputs"]["input_1"]),
          "loop": True, "offset_ms": 0}),
    ]
    return reqs + mp4_output(
        ctx["out"], {
            "type": "view", "background_color": "#52505BFF",
            "children": [{"type": "rescaler", "child": stream("clip")}],
        }, dur=ctx["dur"])


def ex_slide_show(ctx):
    """Title card, then two clips in sequence — the slide-show flow."""
    title = {"type": "view", "background_color": "#302D3AFF",
             "direction": "column",
             "children": [
                 {"type": "view"},
                 {"type": "text", "text": "Slide show", "font_size": 110.0,
                  "width": float(W), "align": "center",
                  "font_family": "DejaVu Sans"},
                 {"type": "view"},
             ]}
    slide1 = {"type": "view", "background_color": "#52505BFF",
              "children": [{"type": "rescaler", "child": stream("input_1")}]}
    slide2 = {"type": "view", "background_color": "#52505BFF",
              "children": [{"type": "rescaler", "child": stream("input_2")}]}
    step = ctx["dur"] / 3.0
    return (register_inputs(ctx, ["input_1", "input_2"])
            + mp4_output(ctx["out"], title, dur=ctx["dur"])
            + scene_updates([title, slide1, slide2], step))


CATALOG = {
    # guides
    "quick_start": ("guides", 2, ex_quick_start),
    "basic_layouts": ("guides", 2, ex_basic_layouts),
    "view_transitions": ("guides", 1, ex_view_transitions),
    # components
    "view": ("components", 2, ex_view),
    "tiles": ("components", 4, ex_tiles),
    "rescaler": ("components", 2, ex_rescaler),
    "text": ("components", 0, ex_text),
    "image": ("components", 1, ex_image),
    "shader": ("components", 1, ex_shader),
    "input_stream": ("components", 1, ex_input_stream),
    "mp4": ("components", 1, ex_mp4),
    "slide_show": ("components", 2, ex_slide_show),
}

LOGO_SVG = """\
<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 120 120">
  <circle cx="60" cy="60" r="54" fill="#624BAA"/>
  <circle cx="60" cy="60" r="40" fill="none" stroke="#FFFFFF"
          stroke-width="8"/>
  <path d="M 40 72 L 60 40 L 80 72 Z" fill="#FFFFFF"/>
</svg>
"""


# ----------------------------------------------------------------------- main


def main(argv=None) -> int:
    """Render the catalog (or list it); returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--only", help="render a single catalog entry")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--duration", type=float, default=6.0,
                    help="clip length in seconds (default 6)")
    ap.add_argument("--input-duration", type=float, default=None,
                    help="labeled-input clip length (default: --duration)")
    args = ap.parse_args(argv)

    if args.list:
        for name, (cat, n_inputs, _) in CATALOG.items():
            print(f"{cat}/{name}  (inputs: {n_inputs})")
        return 0

    names = [args.only] if args.only else list(CATALOG)
    for n in names:
        if n not in CATALOG:
            ap.error(f"unknown example {n!r} (see --list)")

    from smelter_tpu_torch.io import codec

    try:
        codec.caps()
    except RuntimeError as exc:  # no FFmpeg: the clips cannot be read or written
        print(f"docs_examples: the codec service cannot load: {exc}", file=sys.stderr)
        return 1

    out_root = Path(args.out)
    inputs_dir = out_root / "inputs"
    assets_dir = out_root / "assets"
    assets_dir.mkdir(parents=True, exist_ok=True)
    (assets_dir / "logo.svg").write_text(LOGO_SVG)

    n_inputs = max(CATALOG[n][1] for n in names)
    in_dur = args.input_duration or args.duration

    studio = Studio()
    try:
        inputs = {}
        for label, color in INPUT_COLORS[:n_inputs]:
            name = label.lower().replace(" ", "_")
            path = inputs_dir / f"{name}.mp4"
            inputs[name] = path
            if not path.exists():
                t0 = time.time()
                studio.render_clip(
                    path, labeled_input_requests(path, label, color, in_dur),
                    record=False)
                print(f"input {name}: {time.time() - t0:.1f}s")
        for name in names:
            cat, _, builder = CATALOG[name]
            out = out_root / cat / f"{name}.mp4"
            ctx = {"inputs": inputs, "assets": assets_dir,
                   "out": out, "dur": args.duration}
            t0 = time.time()
            studio.render_clip(out, builder(ctx))
            print(f"{cat}/{name}: {time.time() - t0:.1f}s -> {out}")
    finally:
        studio.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
