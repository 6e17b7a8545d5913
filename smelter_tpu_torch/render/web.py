"""Web renderer: CDP-driven headless-browser sidecar, a copy of
`smelter_tpu/render/web.py` (`websockets` and PIL are imported only when a
sidecar connects or a page frame decodes).

Equivalent of the reference's CEF web renderer
(`smelter-render/src/transformations/web_renderer.rs:36-40` +
`chromium_context.rs`/`embedder.rs`/`shared_memory.rs`): a helper browser
process renders the page; frames cross the process boundary (CEF uses
shared memory; here the Chrome DevTools Protocol screencast carries PNG
frames over the DevTools websocket) and are uploaded as an aux texture.

When no browser binary exists the registered instance renders transparent
— the same graceful fallback the reference ships when built without CEF
(`web_renderer_fallback.rs`). `SMELTER_WEB_RENDERER_BROWSER` overrides
binary discovery; `SMELTER_WEB_RENDERER_CDP_URL` attaches to an already-
running DevTools endpoint instead of spawning one (also how tests drive
the full CDP path against a mock browser).
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import re
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger("smelter.web")

_BROWSER_CANDIDATES = (
    "chromium", "chromium-browser", "google-chrome", "google-chrome-stable",
    "chrome", "headless_shell", "thorium",
)


def find_browser() -> Optional[str]:
    override = os.environ.get("SMELTER_WEB_RENDERER_BROWSER")
    if override:
        return override if os.path.exists(override) else shutil.which(override)
    for name in _BROWSER_CANDIDATES:
        path = shutil.which(name)
        if path:
            return path
    return None


class CdpConnection:
    """Minimal Chrome-DevTools-Protocol client over a sync websocket."""

    def __init__(self, ws_url: str, timeout: float = 10.0) -> None:
        import websockets.sync.client as ws_client

        self._ws = ws_client.connect(ws_url, open_timeout=timeout,
                                     max_size=64 * 1024 * 1024)
        self._next_id = 1
        self._lock = threading.Lock()
        self._pending: Dict[int, threading.Event] = {}
        self._results: Dict[int, dict] = {}
        self.on_event: Optional[Callable[[str, dict], None]] = None
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._recv_loop,
                                        name="cdp-recv", daemon=True)
        self._thread.start()

    def notify(self, method: str, params: Optional[dict] = None,
               session_id: Optional[str] = None) -> None:
        """Fire-and-forget command (no response wait). REQUIRED when
        sending from the recv thread (an event handler): a blocking call
        there would deadlock against its own response."""
        with self._lock:
            mid = self._next_id
            self._next_id += 1
        msg: dict = {"id": mid, "method": method, "params": params or {}}
        if session_id:
            msg["sessionId"] = session_id
        self._ws.send(json.dumps(msg))

    def call(self, method: str, params: Optional[dict] = None,
             session_id: Optional[str] = None, timeout: float = 10.0) -> dict:
        with self._lock:
            mid = self._next_id
            self._next_id += 1
            done = threading.Event()
            self._pending[mid] = done
        msg: dict = {"id": mid, "method": method, "params": params or {}}
        if session_id:
            msg["sessionId"] = session_id
        self._ws.send(json.dumps(msg))
        if not done.wait(timeout=timeout):
            raise TimeoutError(f"CDP {method} timed out")
        result = self._results.pop(mid)
        if "error" in result:
            raise RuntimeError(f"CDP {method}: {result['error']}")
        return result.get("result", {})

    def _recv_loop(self) -> None:
        try:
            while not self._closed.is_set():
                raw = self._ws.recv()
                msg = json.loads(raw)
                mid = msg.get("id")
                if mid is not None:
                    done = self._pending.pop(mid, None)
                    if done is not None:
                        self._results[mid] = msg
                        done.set()
                elif self.on_event is not None:
                    try:
                        self.on_event(msg.get("method", ""), msg.get("params", {}))
                    except Exception:
                        logger.exception("CDP event handler failed")
        except Exception:
            self._closed.set()

    def close(self) -> None:
        self._closed.set()
        try:
            self._ws.close()
        except Exception:
            pass


class SharedFrame:
    """Latest-frame buffer between the CDP thread and the render thread
    (plays the role of the reference's shared_memory.rs: the browser is
    the other process; the decoded RGBA lands here)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._frame: Optional[np.ndarray] = None
        self.frame_count = 0
        # condition (not polling) synchronization for "first frame arrived" —
        # consumers on a loaded 1-vCPU box must block on this, not sleep-poll
        self.ready = threading.Event()

    def put(self, rgba: np.ndarray) -> None:
        with self._lock:
            self._frame = rgba
            self.frame_count += 1
        self.ready.set()

    def get(self) -> Optional[np.ndarray]:
        with self._lock:
            return self._frame


@dataclass
class WebRendererSpec:
    """Reference WebRendererSpec (web_renderer.rs:36-40)."""

    instance_id: str
    url: str
    resolution: Tuple[int, int]  # (width, height)
    # reference WebEmbeddingMethod (resource/web_renderer.rs:23-35):
    #   chromium_embedding — child frames are pushed INTO the page and the
    #     page composites them (canvas per source, embedder.rs embed_sources)
    #   native_embedding_over_content / native_embedding_under_content —
    #     the renderer composites children natively above/below the page
    embedding_method: str = "chromium_embedding"


class WebRendererInstance:
    """One registered web renderer: a page in the sidecar browser, or the
    transparent fallback when no browser/CDP endpoint is available."""

    def __init__(self, spec: WebRendererSpec) -> None:
        self.spec = spec
        self.shared = SharedFrame()
        self._cdp: Optional[CdpConnection] = None
        self._proc: Optional[subprocess.Popen] = None
        self._session_id: Optional[str] = None
        self.active = False
        cdp_url = os.environ.get("SMELTER_WEB_RENDERER_CDP_URL")
        browser = find_browser()
        if not cdp_url and browser is None:
            logger.info(
                "web renderer %r: no browser binary, rendering transparent "
                "(reference web_renderer_fallback.rs)", spec.instance_id,
            )
            return
        try:
            if not cdp_url:
                cdp_url = self._spawn_browser(browser)
            self._attach(cdp_url)
            self.active = True
        except Exception:
            logger.exception(
                "web renderer %r: sidecar failed, falling back to transparent",
                spec.instance_id,
            )
            self.close()

    # -- sidecar ----------------------------------------------------------------

    def _spawn_browser(self, browser: str) -> str:
        self._proc = subprocess.Popen(
            [browser, "--headless=new", "--no-sandbox", "--disable-gpu",
             "--remote-debugging-port=0", "--remote-allow-origins=*",
             "about:blank"],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        )
        deadline = time.time() + 20
        ws_url = None
        assert self._proc.stderr is not None
        while time.time() < deadline:
            line = self._proc.stderr.readline().decode(errors="replace")
            m = re.search(r"DevTools listening on (ws://\S+)", line)
            if m:
                ws_url = m.group(1)
                break
        if ws_url is None:
            raise RuntimeError("browser did not report a DevTools endpoint")
        return ws_url

    def _attach(self, cdp_url: str) -> None:
        w, h = self.spec.resolution
        cdp = CdpConnection(cdp_url)
        cdp.on_event = self._on_event
        target = cdp.call("Target.createTarget", {"url": "about:blank"})
        attach = cdp.call("Target.attachToTarget", {
            "targetId": target["targetId"], "flatten": True,
        })
        sid = attach["sessionId"]
        cdp.call("Page.enable", {}, session_id=sid)
        cdp.call("Emulation.setDeviceMetricsOverride", {
            "width": w, "height": h, "deviceScaleFactor": 1, "mobile": False,
        }, session_id=sid)
        cdp.call("Emulation.setDefaultBackgroundColorOverride", {
            "color": {"r": 0, "g": 0, "b": 0, "a": 0},
        }, session_id=sid)
        cdp.call("Page.navigate", {"url": self.spec.url}, session_id=sid)
        # publish the connection BEFORE screencast starts: the first frame
        # event can arrive while startScreencast's own response is in flight
        self._cdp = cdp
        self._session_id = sid
        cdp.call("Page.startScreencast", {
            "format": "png", "maxWidth": w, "maxHeight": h,
            "everyNthFrame": 1,
        }, session_id=sid)

    def _on_event(self, method: str, params: dict) -> None:
        if method != "Page.screencastFrame":
            return
        try:
            from PIL import Image as PILImage

            png = base64.b64decode(params["data"])
            img = PILImage.open(io.BytesIO(png)).convert("RGBA")
            self.shared.put(np.asarray(img, dtype=np.uint8))
        finally:
            try:
                # fire-and-forget: this runs on the CDP recv thread, so a
                # blocking call would deadlock against its own response
                self._cdp.notify("Page.screencastFrameAck", {
                    "sessionId": params["sessionId"],
                }, session_id=self._session_id)
            except Exception:
                logger.debug("screencast ack failed", exc_info=True)

    # -- frame access (render thread) --------------------------------------------

    def frame(self) -> Optional[np.ndarray]:
        """Latest page frame as straight-alpha RGBA, or None (transparent
        fallback / nothing rendered yet)."""
        return self.shared.get()

    def wait_for_frame(self, timeout: float) -> bool:
        """Block until the first screencast frame lands (condition-based —
        never sleep-poll `frame()`; see CLAUDE.md timing notes). Returns
        False on timeout or for the transparent fallback."""
        if not self.active:
            return False
        return self.shared.ready.wait(timeout)

    # -- uplink: child frames INTO the page (embedder.rs:83 embed_sources) --------

    _EMBED_JS = """
(function (id, w, h, b64) {
  let c = document.getElementById(id);
  if (!c) {
    c = document.createElement('canvas');
    c.id = id;
    c.className = 'smelter-source';
    document.body.appendChild(c);
  }
  if (c.width !== w) c.width = w;
  if (c.height !== h) c.height = h;
  const bin = atob(b64);
  const arr = new Uint8ClampedArray(bin.length);
  for (let i = 0; i < bin.length; i++) arr[i] = bin.charCodeAt(i);
  c.getContext('2d').putImageData(new ImageData(arr, w, h), 0, 0);
  return true;
})(%r, %d, %d, %r)
"""

    def embed_sources(self, frames) -> None:
        """Push child frames into the page (chromium_embedding): each source
        lands on a `<canvas id="smelter_source_{i}">` the page can style and
        composite — the CDP analogue of the reference's shared-memory +
        onRegisterEmbedder JS API (embedder.rs chromium_embedding).

        ``frames``: list of (pts, rgba) per child where ``rgba`` is a u8
        array or a zero-arg callable producing one (lazy conversion), None
        entries skipped. Sends are fire-and-forget on the CDP channel and
        deduped by pts BEFORE the array is materialized, so a static scene
        costs nothing — not even the RGBA convert."""
        if not self.active or self._cdp is None:
            return
        if not hasattr(self, "_embedded_pts"):
            self._embedded_pts = {}
        for index, entry in enumerate(frames):
            if entry is None:
                continue
            pts, rgba = entry
            if self._embedded_pts.get(index) == pts:
                continue
            self._embedded_pts[index] = pts
            if callable(rgba):
                rgba = rgba()
            h, w = rgba.shape[:2]
            b64 = base64.b64encode(
                np.ascontiguousarray(rgba).tobytes()
            ).decode("ascii")
            script = self._EMBED_JS % (f"smelter_source_{index}", w, h, b64)
            try:
                self._cdp.notify(
                    "Runtime.evaluate",
                    {"expression": script, "returnByValue": False},
                    session_id=self._session_id,
                )
            except Exception:
                logger.debug("embed_sources send failed", exc_info=True)

    def close(self) -> None:
        if self._cdp is not None:
            self._cdp.close()
            self._cdp = None
        if self._proc is not None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
            self._proc = None
        self.active = False


class WebRendererRegistry:
    """Keyed store of web renderer instances (reference Renderers store)."""

    def __init__(self) -> None:
        self._instances: Dict[str, WebRendererInstance] = {}
        self._lock = threading.Lock()

    def register(self, spec: WebRendererSpec) -> WebRendererInstance:
        with self._lock:
            if spec.instance_id in self._instances:
                raise ValueError(
                    f"web renderer {spec.instance_id!r} already registered"
                )
            inst = WebRendererInstance(spec)
            self._instances[spec.instance_id] = inst
            return inst

    def unregister(self, instance_id: str) -> None:
        with self._lock:
            inst = self._instances.pop(instance_id, None)
        if inst is not None:
            inst.close()
        else:
            raise KeyError(instance_id)

    def get(self, instance_id: str) -> Optional[WebRendererInstance]:
        with self._lock:
            return self._instances.get(instance_id)

    def close_all(self) -> None:
        with self._lock:
            instances = list(self._instances.values())
            self._instances.clear()
        for inst in instances:
            inst.close()
