"""Per-subsystem span tracing (SURVEY §5 tracing/profiling row).

The reference instruments its pipeline with `tracing` crate spans that feed
console/Chrome-trace subscribers. The TPU-native analogue has two sinks:

1. **Aggregates, always on**: every span records into a lock-guarded
   per-name aggregate (count / total / max + a bounded reservoir for p50 and
   p95). `report()` serves them under `/stats` -> "spans", so production
   observability needs no restart or sidecar.
2. **Profiler timeline, opt-in**: when ``SMELTER_TRACE_ANNOTATIONS=1``
   (or :func:`enable_profiler_annotations` is called), spans also open
   `torch.profiler.record_function` ranges, so host-side stages (queue tick,
   decode, upload, encode) appear on the SAME timeline as the CUDA kernels
   in a `torch.profiler.profile` capture — stage/device overlap is visible in
   one Perfetto view.

Usage::

    from smelter_tpu_torch.utils import tracing

    with tracing.span("queue.tick"):
        ...
    # or as a decorator
    @tracing.traced("render.frame")
    def render(...): ...
"""

from __future__ import annotations

import contextlib
import functools
import os
import random
import threading
import time
from typing import Callable, Dict, Iterator, Optional

_RESERVOIR_SIZE = 256


class _Aggregate:
    __slots__ = ("count", "total_s", "max_s", "reservoir")

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.reservoir: list = []

    def add(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds
        if len(self.reservoir) < _RESERVOIR_SIZE:
            self.reservoir.append(seconds)
        else:
            # classic reservoir sampling keeps percentiles unbiased over the
            # whole history without unbounded memory
            slot = random.randint(0, self.count - 1)
            if slot < _RESERVOIR_SIZE:
                self.reservoir[slot] = seconds

    def percentile(self, q: float) -> float:
        if not self.reservoir:
            return 0.0
        ordered = sorted(self.reservoir)
        index = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[index]


_lock = threading.Lock()
_aggregates: Dict[str, _Aggregate] = {}
_annotations_enabled = os.environ.get("SMELTER_TRACE_ANNOTATIONS", "") in (
    "1", "true", "yes", "on",
)


def enable_profiler_annotations(enabled: bool = True) -> None:
    """Also emit spans as torch.profiler record_function ranges (timeline
    sink)."""
    global _annotations_enabled
    _annotations_enabled = enabled


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Record a named span; ~1 us overhead when annotations are off."""
    annotation = None
    if _annotations_enabled:
        try:
            import torch.profiler

            annotation = torch.profiler.record_function(name)
            annotation.__enter__()
        except Exception:
            annotation = None
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        if annotation is not None:
            annotation.__exit__(None, None, None)
        with _lock:
            agg = _aggregates.get(name)
            if agg is None:
                agg = _aggregates[name] = _Aggregate()
            agg.add(elapsed)


def traced(name: str) -> Callable:
    """Decorator form of :func:`span`."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco


def report() -> Dict[str, dict]:
    """Aggregate snapshot for /stats: {name: {count, total_ms, avg_ms,
    max_ms, p50_ms, p95_ms}}."""
    with _lock:
        items = list(_aggregates.items())
    out: Dict[str, dict] = {}
    for name, agg in items:
        out[name] = {
            "count": agg.count,
            "total_ms": round(agg.total_s * 1000.0, 3),
            "avg_ms": round(agg.total_s / agg.count * 1000.0, 3)
            if agg.count
            else 0.0,
            "max_ms": round(agg.max_s * 1000.0, 3),
            "p50_ms": round(agg.percentile(0.50) * 1000.0, 3),
            "p95_ms": round(agg.percentile(0.95) * 1000.0, 3),
        }
    return out


def reset() -> None:
    """Drop all aggregates (tests, /api/reset)."""
    with _lock:
        _aggregates.clear()


def get(name: str) -> Optional[dict]:
    return report().get(name)
