"""Host-side image asset store, a copy of `smelter_tpu/render/image.py`.

PNG/JPEG assets load once into RGBA textures; animated GIFs keep per-frame
textures and resolve by PTS; SVG rasterizes through librsvg + cairo (or
cairosvg). Assets register by id from url/path/bytes like the reference
ImageSpec, or as a ready `ImageAsset` of u8 RGBA frames (`put`). PIL is
imported only when an encoded image is decoded, so that a renderer that
never decodes one never loads it.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class ImageAsset:
    kind: str  # "bitmap" | "animated"
    frames: List[np.ndarray]  # (H, W, 4) uint8 straight-alpha frames
    durations: List[float]  # per-frame durations in seconds (animated)
    width: int
    height: int

    def frame_at(self, pts: float) -> np.ndarray:
        if self.kind == "bitmap" or len(self.frames) == 1:
            return self.frames[0]
        total = sum(self.durations)
        if total <= 0:
            return self.frames[0]
        t = pts % total
        acc = 0.0
        for frame, dur in zip(self.frames, self.durations):
            acc += dur
            if t < acc:
                return frame
        return self.frames[-1]


class ImageError(Exception):
    pass


class ImageStore:
    """Registry for image renderers, keyed by image id
    (reference `RegistryType::Image`)."""

    def __init__(self) -> None:
        self._assets: Dict[str, ImageAsset] = {}

    def register(
        self,
        image_id: str,
        *,
        path: Optional[str] = None,
        url: Optional[str] = None,
        data: Optional[bytes] = None,
        kind: Optional[str] = None,
        resolution=None,   # (w, h) — SVG raster size (vector-scaled)
    ) -> ImageAsset:
        if image_id in self._assets:
            raise ImageError(f"image {image_id!r} already registered")
        if data is None:
            if path is not None:
                with open(path, "rb") as f:
                    data = f.read()
            elif url is not None:
                import requests

                resp = requests.get(url, timeout=30)
                resp.raise_for_status()
                data = resp.content
            else:
                raise ImageError("one of path/url/data required")
        asset = _decode(data, kind, resolution)
        self._assets[image_id] = asset
        return asset

    def put(self, image_id: str, asset: ImageAsset) -> ImageAsset:
        """Register an asset built on the host (u8 straight-alpha RGBA
        frames), with no decoding."""
        if image_id in self._assets:
            raise ImageError(f"image {image_id!r} already registered")
        self._assets[image_id] = asset
        return asset

    def unregister(self, image_id: str) -> None:
        if image_id not in self._assets:
            raise ImageError(f"image {image_id!r} not registered")
        del self._assets[image_id]

    def get(self, image_id: str) -> ImageAsset:
        asset = self._assets.get(image_id)
        if asset is None:
            raise ImageError(f"image {image_id!r} not registered")
        return asset

    def natural_size(self, image_id: str) -> Tuple[float, float]:
        a = self.get(image_id)
        return (float(a.width), float(a.height))

    def has(self, image_id: str) -> bool:
        return image_id in self._assets


def _decode(data: bytes, kind: Optional[str],
            resolution=None) -> ImageAsset:
    if kind == "svg" or (kind is None and data.lstrip()[:5] in (b"<svg ", b"<?xml")):
        return _decode_svg(data, resolution)
    from PIL import Image as PILImage

    img = PILImage.open(io.BytesIO(data))
    if getattr(img, "is_animated", False):
        frames: List[np.ndarray] = []
        durations: List[float] = []
        for i in range(img.n_frames):
            img.seek(i)
            frames.append(np.asarray(img.convert("RGBA"), dtype=np.uint8))
            durations.append(max(img.info.get("duration", 100), 10) / 1000.0)
        return ImageAsset(
            "animated", frames, durations, frames[0].shape[1], frames[0].shape[0]
        )
    rgba = np.asarray(img.convert("RGBA"), dtype=np.uint8)
    return ImageAsset("bitmap", [rgba], [0.0], rgba.shape[1], rgba.shape[0])


def _decode_svg(data: bytes, resolution=None) -> ImageAsset:
    """SVG rasterization via librsvg + cairo through ctypes — the same
    renderer class as the reference's resvg (`transformations/svg_image.rs`).
    Falls back to cairosvg if installed; rejects SVG only when neither
    backend exists."""
    try:
        rgba = _rsvg_render(data, resolution)
        return ImageAsset("svg", [rgba], [0.0], rgba.shape[1], rgba.shape[0])
    except (OSError, AttributeError, ImageError) as first_exc:
        try:
            import cairosvg  # type: ignore

            png = cairosvg.svg2png(bytestring=data)
            return _decode(png, None)
        except ImportError:
            raise ImageError(
                f"SVG rasterization failed ({first_exc}) and no cairosvg "
                "fallback is available"
            ) from first_exc


_rsvg_libs = None


def _rsvg_render(data: bytes, resolution=None) -> np.ndarray:
    """Render an SVG document to straight-alpha RGBA — at its natural size,
    or vector-scaled to `resolution` (reference ImageSpec::Svg.resolution:
    cairo scale before render, not a raster resize)."""
    import ctypes

    global _rsvg_libs
    if _rsvg_libs is None:
        rsvg = ctypes.CDLL("librsvg-2.so.2")
        cairo = ctypes.CDLL("libcairo.so.2")
        gobject = ctypes.CDLL("libgobject-2.0.so.0")
        rsvg.rsvg_handle_new_from_data.restype = ctypes.c_void_p
        rsvg.rsvg_handle_new_from_data.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
        rsvg.rsvg_handle_get_dimensions.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p]
        rsvg.rsvg_handle_render_cairo.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p]
        rsvg.rsvg_handle_render_cairo.restype = ctypes.c_int
        cairo.cairo_image_surface_create.restype = ctypes.c_void_p
        cairo.cairo_image_surface_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        cairo.cairo_create.restype = ctypes.c_void_p
        cairo.cairo_create.argtypes = [ctypes.c_void_p]
        cairo.cairo_image_surface_get_data.restype = ctypes.POINTER(ctypes.c_ubyte)
        cairo.cairo_image_surface_get_data.argtypes = [ctypes.c_void_p]
        cairo.cairo_image_surface_get_stride.argtypes = [ctypes.c_void_p]
        cairo.cairo_surface_flush.argtypes = [ctypes.c_void_p]
        cairo.cairo_destroy.argtypes = [ctypes.c_void_p]
        cairo.cairo_scale.argtypes = [
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double]
        cairo.cairo_surface_destroy.argtypes = [ctypes.c_void_p]
        gobject.g_object_unref.argtypes = [ctypes.c_void_p]
        _rsvg_libs = (rsvg, cairo, gobject)
    rsvg, cairo, gobject = _rsvg_libs

    class _Dim(ctypes.Structure):
        _fields_ = [("width", ctypes.c_int), ("height", ctypes.c_int),
                    ("em", ctypes.c_double), ("ex", ctypes.c_double)]

    err = ctypes.c_void_p(0)
    handle = rsvg.rsvg_handle_new_from_data(
        data, len(data), ctypes.byref(err))
    if not handle:
        raise ImageError("librsvg could not parse the SVG document")
    try:
        dim = _Dim()
        rsvg.rsvg_handle_get_dimensions(ctypes.c_void_p(handle),
                                        ctypes.byref(dim))
        nat_w = max(int(dim.width), 1)
        nat_h = max(int(dim.height), 1)
        if resolution is not None:
            w, h = int(resolution[0]), int(resolution[1])
        else:
            w, h = nat_w, nat_h
        surface = cairo.cairo_image_surface_create(0, w, h)  # ARGB32
        cr = cairo.cairo_create(surface)
        if (w, h) != (nat_w, nat_h):
            cairo.cairo_scale(cr, w / nat_w, h / nat_h)
        ok = rsvg.rsvg_handle_render_cairo(ctypes.c_void_p(handle), cr)
        cairo.cairo_surface_flush(surface)
        if not ok:
            cairo.cairo_destroy(cr)
            cairo.cairo_surface_destroy(surface)
            raise ImageError("librsvg failed to render the SVG document")
        stride = cairo.cairo_image_surface_get_stride(surface)
        buf = cairo.cairo_image_surface_get_data(surface)
        raw = np.ctypeslib.as_array(buf, shape=(h, stride)).copy()
        cairo.cairo_destroy(cr)
        cairo.cairo_surface_destroy(surface)
    finally:
        gobject.g_object_unref(ctypes.c_void_p(handle))
    px = raw[:, : w * 4].reshape(h, w, 4)
    # cairo ARGB32 is premultiplied BGRA in native (little-endian) order
    b, g, r, a = (px[..., 0].astype(np.float32), px[..., 1].astype(np.float32),
                  px[..., 2].astype(np.float32), px[..., 3].astype(np.float32))
    nz = np.maximum(a, 1.0)
    rgba = np.stack([
        np.clip(r * 255.0 / nz, 0, 255),
        np.clip(g * 255.0 / nz, 0, 255),
        np.clip(b * 255.0 / nz, 0, 255),
        a,
    ], axis=-1).astype(np.uint8)
    return rgba
