"""The closed render loop: the calling thread plays the Pipeline's renderer
thread (`Renderer.render`, then `to_host_async` on each output frame) and
a fetch thread plays its output threads (`HostCopy.wait`, in order). At
most `depth` ticks are in flight: the render loop takes a slot before it
renders, and the fetch thread gives it back once every output frame of
the tick has reached the host. There is no fixed rate, so no frame is
ever late."""

from __future__ import annotations

import contextlib
import queue
import random
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Tuple


class Reservoir:
    """A uniform sample of `size` frames, drawn from `seed`, of all the
    frames offered to it (reservoir sampling)."""

    def __init__(self, size: int, seed: int) -> None:
        self.size = size
        self._rng = random.Random(seed)
        self._seen = 0
        self.kept: Dict[int, object] = {}
        self._slots: List[int] = []

    def offer(self, k: int, frame) -> None:
        self._seen += 1
        if len(self._slots) < self.size:
            self._slots.append(k)
            self.kept[k] = frame
            return
        j = self._rng.randrange(self._seen)
        if j < self.size:
            del self.kept[self._slots[j]]
            self._slots[j] = k
            self.kept[k] = frame


class RenderLoop:
    def __init__(self, render: Callable, to_host: Callable, frame_sets: list, schedule,
                 update: Callable[[int], None], depth: int, sample: Reservoir,
                 mark: Callable[[str], contextlib.AbstractContextManager]) -> None:
        self._render = render          # (pts, frames) -> {output: frame on the device}
        self._to_host = to_host        # output frame -> HostCopy
        self._frame_sets = frame_sets
        self._schedule = schedule
        self._update = update          # stage -> None (a scene update)
        self._depth = depth
        self._sample = sample
        self._mark = mark
        self._slots = threading.Semaphore(depth)
        self._queue: "queue.SimpleQueue" = queue.SimpleQueue()
        self.stage: Optional[int] = None
        self.issued: Dict[int, Tuple[float, float]] = {}  # k -> (render called, copy enqueued)
        self.fetched: Dict[int, float] = {}               # k -> every output on the host
        self.failed: Dict[int, str] = {}                  # k -> what raised
        self._thread = threading.Thread(target=self._fetch, name="bench-fetch", daemon=True)
        self._thread.start()

    def tick(self, k: int, in_window: bool) -> None:
        stage = self._schedule.stage(k)
        if stage != self.stage:
            self._update(stage)
            self.stage = stage
        frames = self._frame_sets[k % len(self._frame_sets)]
        with self._mark("bench.slot_wait"):
            self._slots.acquire()
        t0 = time.perf_counter()
        try:
            out = self._render(self._schedule.pts(k), frames)
            with self._mark("bench.to_host"):
                copies = {o: self._to_host(frame) for o, frame in out.items()}
        except Exception:
            self.failed[k] = traceback.format_exc()
            self._slots.release()
            return
        self.issued[k] = (t0, time.perf_counter())
        self._queue.put((k, copies, in_window))

    def _fetch(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            k, copies, in_window = item
            try:
                frames = {o: copy.wait() for o, copy in copies.items()}
                self.fetched[k] = time.perf_counter()
                if in_window:
                    self._sample.offer(k, frames)
            except Exception:
                self.failed[k] = traceback.format_exc()
            finally:
                self._slots.release()

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Wait until no tick is in flight (at most `timeout_s`)."""
        deadline = time.monotonic() + timeout_s
        taken = 0
        for _ in range(self._depth):
            if not self._slots.acquire(timeout=max(0.0, deadline - time.monotonic())):
                break
            taken += 1
        for _ in range(taken):
            self._slots.release()
        return taken == self._depth

    def close(self) -> None:
        self._queue.put(None)
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            raise RuntimeError("the fetch thread did not end")
