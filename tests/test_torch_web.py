"""WebView nodes on the port, against the JAX package, on the CPU.

  - The five flows of `tests/test_web_renderer.py` (a page through CDP, the
    transparent fallback, chromium embedding of an input and of a rendered
    subtree, native embedding over the content), each run as that file runs
    it, against the same mock DevTools endpoint, with its `Renderer`
    swapped for the port's on the CPU (`PortRenderer`: the reference's
    objects carried across with `from_reference`).
  - The frames of the native-embedding modes, where the children are
    resized to the page with `resize_bilinear` and composited over or under
    it, against the JAX renderer at <= 1 u8 LSB.
  - `ops/resample.resize_bilinear` against the reference's (texel-centre
    aligned, clamped to the edges): equal to 1e-6.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_web_renderer as twr
from smelter_tpu.core.types import FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu.ops.resample import resize_bilinear as jax_resize_bilinear
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.render.web import WebRendererSpec
from smelter_tpu.scene import components as comp
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.ops.resample import resize_bilinear
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer
from smelter_tpu_torch.render.renderer import RendererOptions as TorchRendererOptions

torch.set_num_threads(2)


class _PortWeb:
    """The port renderer's web registry, taking the reference's specs."""

    def __init__(self, registry):
        self._registry = registry

    def register(self, spec):
        return self._registry.register(from_reference(spec))

    def __getattr__(self, name):
        return getattr(self._registry, name)


def _to_reference(frame_set):
    """A FrameSet of the port as the reference's, its planes numpy."""
    from smelter_tpu.core import types as ref

    frames = {}
    for oid, f in frame_set.frames.items():
        data = (tuple(p.numpy() for p in f.data) if isinstance(f.data, tuple)
                else f.data.numpy())
        frames[oid] = ref.Frame(data=data, format=ref.PixelFormat[f.format.name],
                                resolution=ref.Resolution(f.resolution.width,
                                                          f.resolution.height),
                                pts=f.pts)
    return ref.FrameSet(pts=frame_set.pts, frames=frames)


class PortRenderer:
    """The reference's `Renderer` calls on the port's renderer on the CPU:
    the reference's `RendererOptions` and arguments carried across with
    `from_reference`, rendered frames returned as the reference's, with numpy
    planes (as the reference's tests read them).

    A render returns once every page's DevTools endpoint has taken what the
    port pushed into the page during it (`_flush_web`), so that a test may
    count the endpoint's messages right after `render()`."""

    def __init__(self, options=None, **kwargs):
        opts = TorchRendererOptions() if options is None else from_reference(options)
        self._r = TorchRenderer(opts, device="cpu")
        self.shaders = self._r.shaders
        self.web = _PortWeb(self._r.web)

    def _flush_web(self):
        """One round trip on each page's DevTools connection: the endpoint
        answers it after every message sent before it (waits at most 10 s)."""
        for inst in list(self._r.web._instances.values()):
            if inst.active and inst._cdp is not None:
                inst._cdp.call("Runtime.enable", session_id=inst._session_id, timeout=10)

    def __getattr__(self, name):
        fn = getattr(self._r, name)

        def call(*args, **kwargs):
            out = fn(*from_reference(args), **from_reference(kwargs))
            if name != "render":
                return out
            self._flush_web()
            return _to_reference(out)

        return call


FLOWS = [
    "test_webview_renders_page_via_cdp",
    "test_webview_transparent_fallback",
    "test_webview_chromium_embedding_pushes_child_frames",
    "test_webview_chromium_embedding_renders_non_input_subtree",
    "test_webview_native_embedding_over_content",
]


@pytest.mark.parametrize("flow", FLOWS)
def test_web_flow_on_the_port(flow, monkeypatch):
    monkeypatch.setattr(twr, "Renderer", PortRenderer)
    getattr(twr, flow)(monkeypatch)


@pytest.mark.parametrize("method", ["native_embedding_over_content",
                                    "native_embedding_under_content"])
def test_native_embedding_frames_match_the_reference(method, monkeypatch):
    """A 32x24 child resized to the 64x48 page and composited over or under
    it, on a frame of two half-transparent children."""
    mock = twr.MockCdpServer()
    monkeypatch.setenv("SMELTER_WEB_RENDERER_CDP_URL", mock.url)
    try:
        outs = []
        for cls in (JaxRenderer, TorchRenderer):
            port = cls is TorchRenderer
            r = cls(device="cpu") if port else cls()
            conv = from_reference if port else (lambda x: x)
            r.register_input("cam")
            inst = r.web.register(conv(WebRendererSpec(
                instance_id="page", url="https://example.com/", resolution=(64, 48),
                embedding_method=method)))
            assert inst.active and inst.wait_for_frame(10)
            r.update_scene("out", *conv((comp.View(
                background_color=RGBAColor(0, 0, 0, 255), children=[comp.WebView(
                    instance_id="page", children=[
                        comp.InputStream(input_id="cam"),
                        comp.View(position=comp.StaticPosition(width=20.0, height=30.0),
                                  background_color=RGBAColor(0, 0, 200, 120))])]),
                Resolution(64, 48), PixelFormat.RGBA)))
            frame = twr._red_input_frame()
            frame.data[..., 3] = 160
            data = r.render(conv(FrameSet(pts=0.0, frames={"cam": frame}))).frames["out"].data
            outs.append(data.numpy() if torch.is_tensor(data) else np.asarray(data))
            r.web.unregister("page")
            r.close()
        d = np.abs(outs[0].astype(np.int32) - outs[1].astype(np.int32))
        assert int(d.max()) <= 1, int(d.max())
        assert not mock.evaluations  # no uplink in the native modes
    finally:
        mock.close()


@pytest.mark.parametrize("shape", [(20, 30, 45, 17), (48, 64, 48, 64), (7, 5, 50, 3),
                                   (24, 32, 48, 64), (90, 160, 31, 200)])
def test_resize_bilinear_matches_the_reference(shape):
    h, w, oh, ow = shape
    x = np.random.default_rng(h * w).random((h, w, 4), dtype=np.float32)
    ref = np.asarray(jax_resize_bilinear(jnp.asarray(x), oh, ow))
    got = resize_bilinear(torch.from_numpy(x), oh, ow).numpy()
    assert got.shape == ref.shape == (oh, ow, 4)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
