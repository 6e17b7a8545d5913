"""Renderer facade, ported from `smelter_tpu/render/renderer.py`.

Owns the scene state, one frame program per output, and the shader, image,
text and web-renderer registries, on one device. With
`RendererOptions.async_compile`, an output whose new scene structure is
being captured in the background shows its last frame again, with the new
pts (the reference's freeze-frame). The hot call is
``render(FrameSet) -> FrameSet``; `update_scene` swaps scenes with
transition support; registering inputs, shaders and images mirrors the
reference API. Every component kind renders (View, Tiles, Rescaler,
InputStream, Text, Image, Shader, WebView; any of them the root), to RGBA,
PLANAR_YUV420, PLANAR_YUV444 or NV12. Output frame data are tensors on the
device: u8 (y, u, v) planes for the planar formats, (y, uv) for NV12, an
(H, W, 4) u8 tensor for RGBA.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, List

from smelter_tpu_torch.core.types import Frame, FrameSet, Framerate, PixelFormat, Resolution
from smelter_tpu_torch.interop import resolve_device
from smelter_tpu_torch.render.image import ImageStore
from smelter_tpu_torch.render.program import (
    SUPPORTED_OUTPUTS,
    OutputProgram,
    ShaderRegistry,
    _drain_background_compiles,
)
from smelter_tpu_torch.render.text import TextRenderer
from smelter_tpu_torch.render.web import WebRendererRegistry
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.scene_state import OutputScene, SceneState
from smelter_tpu_torch.utils import tracing


@dataclass
class RendererOptions:
    framerate: Framerate = Framerate(30)
    stream_fallback_timeout: float = 0.5  # seconds
    # live mode: capture the program of a new scene structure on a
    # background thread and freeze the output's last frame meanwhile, so that
    # a scene update never stalls the render loop (offline and deterministic
    # runs keep synchronous captures)
    async_compile: bool = False


class Renderer:
    """Thread-safe renderer entry point; every tensor lives on `device`
    (the CUDA card unless the caller passes another, such as "cpu"; raises
    RuntimeError when the card is asked for and there is none)."""

    def __init__(self, options: RendererOptions = RendererOptions(),
                 device=None) -> None:
        self._last_outputs: Dict[str, Frame] = {}
        self._lock = threading.Lock()
        self.options = options
        self.device = resolve_device(device)
        self.scene = SceneState()
        # the shaders' jnp allocates on this renderer's device
        self.shaders = ShaderRegistry(self.device)
        self.images = ImageStore()
        self.text = TextRenderer()
        self.web = WebRendererRegistry()
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

    def register_shader(self, shader_id: str, source: str) -> None:
        with self._lock:
            self.shaders.register(shader_id, source)

    def register_shader_fn(self, shader_id: str, fn: Callable) -> None:
        with self._lock:
            self.shaders.register_fn(shader_id, fn)

    def unregister_shader(self, shader_id: str) -> None:
        with self._lock:
            self.shaders.unregister(shader_id)

    def register_image(self, image_id: str, **kwargs) -> None:
        with self._lock:
            self.images.register(image_id, **kwargs)

    def unregister_image(self, image_id: str) -> None:
        with self._lock:
            self.images.unregister(image_id)

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
                text_measurer=lambda t: self.text.measure(t),
                image_store=lambda i: self.images.natural_size(i),
                web_size=self._web_size,
            )
            prev = self._programs.get(output_id)
            if prev is not None and (
                prev.resolution != resolution
                or self._output_formats.get(output_id) != output_format
            ):
                # the freeze-frame must never send a frame of the old
                # resolution or format to the encoder
                self._last_outputs.pop(output_id, None)
            self._programs[output_id] = OutputProgram(
                node.node, resolution, output_format, self.device,
                self.shaders, web=self.web, image_store=self.images,
                text_renderer=self.text,
            )
            self._output_formats[output_id] = output_format

    def unregister_output(self, output_id: str) -> None:
        with self._lock:
            self.scene.unregister_output(output_id)
            self._programs.pop(output_id, None)
            self._output_formats.pop(output_id, None)
            # an output registered again under this id must not freeze the
            # old output's frame while its first program is captured
            self._last_outputs.pop(output_id, None)

    def _validate_components(self, root: comp.Component,
                             output_format: PixelFormat) -> None:
        if output_format not in SUPPORTED_OUTPUTS:
            raise ValueError(f"unsupported output format {output_format}")

        def visit(c: comp.Component):
            if isinstance(c, comp.Shader):
                if not self.shaders.has(c.shader_id):
                    raise ValueError(f"shader {c.shader_id!r} not registered")
                if len(c.children) > self.shaders.MAX_TEXTURES:
                    # reference shader.rs:15 SHADER_INPUT_TEXTURES_AMOUNT
                    raise ValueError(
                        f"shader {c.shader_id!r} has {len(c.children)} input "
                        f"textures; the limit is {self.shaders.MAX_TEXTURES}"
                    )
            if isinstance(c, comp.Image) and not self.images.has(c.image_id):
                raise ValueError(f"image {c.image_id!r} not registered")
            if isinstance(c, comp.InputStream) and c.input_id not in self._inputs:
                raise ValueError(f"input {c.input_id!r} not registered")
            for ch in _children(c):
                visit(ch)

        visit(root)

    def close(self) -> None:
        """Wait for the programs being captured in the background, then
        release the web renderer sidecars."""
        _drain_background_compiles()
        self.web.close_all()

    def _web_size(self, instance_id: str) -> tuple:
        inst = self.web.get(instance_id)
        if inst is None:
            return (0.0, 0.0)
        w, h = inst.spec.resolution
        return (float(w), float(h))

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
                has_last = output_id in self._last_outputs
                planes = program.render(
                    pts, frames,
                    allow_async_compile=self.options.async_compile and has_last)
                if planes is None:
                    # the structure is being captured in the background:
                    # freeze the output's last frame instead of stalling
                    last = self._last_outputs[output_id]
                    out.frames[output_id] = Frame(
                        data=last.data, format=last.format,
                        resolution=last.resolution, pts=pts)
                    continue
                frame = Frame(
                    data=planes,
                    format=self._output_formats[output_id],
                    resolution=program.resolution,
                    pts=pts,
                )
                self._last_outputs[output_id] = frame
                out.frames[output_id] = frame
            return out


def _children(c: comp.Component) -> List[comp.Component]:
    if isinstance(c, (comp.View, comp.Tiles, comp.Shader, comp.WebView)):
        return c.children
    if isinstance(c, comp.Rescaler):
        return [c.child]
    return []
