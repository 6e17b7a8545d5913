"""Renderer facade, ported from `smelter_tpu/render/renderer.py`.

Owns the scene state and one frame program per output, on one device. The
hot call is ``render(FrameSet) -> FrameSet``; `update_scene` swaps scenes
with transition support. Output frame data are tensors on the device: u8
(y, u, v) planes for PLANAR_YUV420, an (H, W, 4) u8 tensor for RGBA.

Ported: scenes of View, Tiles, Rescaler and InputStream components (any
of them the root), every animated transition of their geometry, inputs in
every pixel format, RGBA and PLANAR_YUV420 outputs. `update_scene` raises
NotImplementedError for what is not ported yet (Text, Image, Shader and
WebView components: ROADMAP Queue 1 item 7; other output formats: item 1).
The scene state's text, image and web hooks raise NotImplementedError too:
no supported scene reaches them.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List

from smelter_tpu_torch.core.types import Frame, FrameSet, Framerate, PixelFormat, Resolution
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.render.program import (
    SUPPORTED_OUTPUTS,
    UNPORTED_NODES,
    OutputProgram,
)
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.scene_state import OutputScene, SceneState
from smelter_tpu_torch.utils import tracing


@dataclass
class RendererOptions:
    framerate: Framerate = Framerate(30)
    stream_fallback_timeout: float = 0.5  # seconds
    # Accepted for the reference's API. A build here is host-only (no
    # compile), so a new scene structure builds synchronously within its
    # first frame, and the reference's freeze-frame (showing the last frame
    # while a compile runs in the background) never has a frame to hold.
    async_compile: bool = False


class Renderer:
    """Thread-safe renderer entry point; every tensor lives on `device`
    (the CUDA card unless the caller passes another, such as "cpu"; raises
    RuntimeError when the card is asked for and there is none)."""

    def __init__(self, options: RendererOptions = RendererOptions(),
                 device=None) -> None:
        self._lock = threading.Lock()
        self.options = options
        self.device = resolve_device(device)
        self.scene = SceneState()
        self._inputs: Dict[str, float] = {}  # input_id -> last frame pts
        self._last_frames: Dict[str, Frame] = {}
        self._programs: Dict[str, OutputProgram] = {}
        self._output_formats: Dict[str, PixelFormat] = {}

    # -- registration ----------------------------------------------------------

    def register_input(self, input_id: str) -> None:
        with self._lock:
            self._inputs[input_id] = -1.0

    def unregister_input(self, input_id: str) -> None:
        with self._lock:
            self._inputs.pop(input_id, None)
            self._last_frames.pop(input_id, None)

    # -- scene -----------------------------------------------------------------

    def update_scene(
        self,
        output_id: str,
        root: comp.Component,
        resolution: Resolution,
        output_format: PixelFormat = PixelFormat.PLANAR_YUV420,
    ) -> None:
        with self._lock:
            self._validate_components(root, output_format)
            node = self.scene.update_scene(
                OutputScene(output_id, root, resolution),
                text_measurer=_unported("text measurement"),
                image_store=_unported("the image store"),
                web_size=_unported("the web renderer"),
            )
            self._programs[output_id] = OutputProgram(
                node.node, resolution, output_format, self.device,
            )
            self._output_formats[output_id] = output_format

    def unregister_output(self, output_id: str) -> None:
        with self._lock:
            self.scene.unregister_output(output_id)
            self._programs.pop(output_id, None)
            self._output_formats.pop(output_id, None)

    def _validate_components(self, root: comp.Component,
                             output_format: PixelFormat) -> None:
        if output_format not in SUPPORTED_OUTPUTS:
            raise NotImplementedError(
                f"output format {output_format.value} is not ported yet: "
                "ROADMAP Queue 1 item 1")

        def visit(c: comp.Component):
            if isinstance(c, (comp.Text, comp.Image, comp.Shader, comp.WebView)):
                raise NotImplementedError(f"{type(c).__name__}: {UNPORTED_NODES}")
            if isinstance(c, comp.InputStream) and c.input_id not in self._inputs:
                raise ValueError(f"input {c.input_id!r} not registered")
            for ch in _children(c):
                visit(ch)

        visit(root)

    def close(self) -> None:
        """Nothing to release: no web renderer sidecar is ever started."""

    # -- hot path ----------------------------------------------------------------

    def render(self, frame_set: FrameSet) -> FrameSet:
        """Compose all outputs for this tick. Missing inputs fall back to
        their last frame until `stream_fallback_timeout`, then render absent
        (reference render_loop.rs:29-32). Returns without waiting for the
        device."""
        with tracing.span("render.frame"), self._lock:
            pts = frame_set.pts
            # refresh the last-frame cache; skip inputs unregistered while
            # this frameset was in flight, so that a removed input does not
            # re-enter the cache
            for iid, frame in frame_set.frames.items():
                if iid not in self._inputs:
                    continue
                self._last_frames[iid] = frame
                self._inputs[iid] = pts
            frames: Dict[str, Frame] = {}
            for iid, last in list(self._last_frames.items()):
                last_seen = self._inputs.get(iid, -1.0)
                if pts - last_seen <= self.options.stream_fallback_timeout:
                    frames[iid] = last
                else:
                    del self._last_frames[iid]

            input_resolutions = {
                iid: f.resolution for iid, f in frames.items()
            }
            self.scene.register_render_event(pts, input_resolutions)

            out = FrameSet(pts=pts)
            for output_id, program in self._programs.items():
                frame = Frame(
                    data=program.render(pts, frames),
                    format=self._output_formats[output_id],
                    resolution=program.resolution,
                    pts=pts,
                )
                out.frames[output_id] = frame
            return out


def _unported(what: str):
    """A scene-state hook for Text, Image or WebView components, which
    `_validate_components` refuses before the scene state could call it."""

    def hook(*_args):
        raise NotImplementedError(f"{what}: {UNPORTED_NODES}")

    return hook


def _children(c: comp.Component) -> List[comp.Component]:
    if isinstance(c, (comp.View, comp.Tiles, comp.Shader, comp.WebView)):
        return c.children
    if isinstance(c, comp.Rescaler):
        return [c.child]
    return []
