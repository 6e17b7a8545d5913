"""Per-subsystem spans and counters (SURVEY §5 tracing/profiling row).

The reference instruments its pipeline with `tracing` crate spans that feed
console/Chrome-trace subscribers. Here there are three records:

1. **Span aggregates, always on**: every span records into a lock-guarded
   per-name aggregate: count, total, max, self time (the total less the
   time its child spans on the same thread cover), the name of the span
   that enclosed it last (`parent`), and a bounded reservoir for p50 and
   p95. Each thread keeps its own stack of open spans, so a span's parent
   is the innermost span open on its thread. `report()` serves them under
   `/stats` -> "spans", so production observability needs no restart or
   sidecar.
2. **Counters, always on**: `count(name, n)` adds `n` to a named total
   (bytes copied, calls, cache hits); `counters()` serves them under
   `/stats` -> "counters". Counting where the work happens lets a reader
   divide one counter by another over the same interval.
3. **Profiler timeline, opt-in**: when ``SMELTER_TRACE_ANNOTATIONS=1``
   (or :func:`enable_profiler_annotations` is called), spans also open
   user-scope record-function ranges, the ranges of
   `torch.profiler.record_function`, so host-side stages (queue tick, plan,
   argument copies, replay) appear on the SAME timeline as the CUDA kernels
   in a `torch.profiler.profile` capture, and the profiler places each
   range on the card's clock too. They are opened through
   `torch.autograd._record_function_with_args_enter`/`_exit`, which keep the
   GIL: `record_function` calls an operator that releases it on entry and
   on exit, and each release let a waiting Python thread in at the span's
   edge, which put the render thread's wait for the GIL in the enclosing
   span (`tests/test_torch_tracing.py`).

With annotations off, a span costs about 1.7 us of host time and a counter
site about 0.4 us (a site of five counters 0.9 us) on the host of an H100
machine; with annotations on, a span costs about 5-8 us (PERF.md §3).

Usage::

    from smelter_tpu_torch.utils import tracing

    with tracing.span("queue.tick"):
        ...
    tracing.count("program.hits")
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Dict, Iterable, Optional, Tuple

_RESERVOIR_SIZE = 256


class _Aggregate:
    __slots__ = ("count", "total_s", "self_s", "max_s", "parent", "reservoir")

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.self_s = 0.0
        self.max_s = 0.0
        self.parent: Optional[str] = None
        self.reservoir: list = []

    def add(self, seconds: float, self_seconds: float, parent: Optional[str]) -> None:
        self.count += 1
        self.total_s += seconds
        self.self_s += self_seconds
        self.parent = parent
        if seconds > self.max_s:
            self.max_s = seconds
        if len(self.reservoir) < _RESERVOIR_SIZE:
            self.reservoir.append(seconds)
        else:
            # classic reservoir sampling keeps percentiles unbiased over the
            # whole history without unbounded memory
            slot = int(_rng.random() * self.count)
            if slot < _RESERVOIR_SIZE:
                self.reservoir[slot] = seconds

    def percentile(self, q: float) -> float:
        if not self.reservoir:
            return 0.0
        ordered = sorted(self.reservoir)
        index = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[index]


class _Stack(threading.local):
    def __init__(self) -> None:
        self.open: list = []  # this thread's open spans, innermost last


_lock = threading.Lock()
# the reservoirs' own generator (used under `_lock`): a span leaves the
# process's `random` alone
_rng = random.Random(0)
_aggregates: Dict[str, _Aggregate] = {}
_counters: Dict[str, int] = {}
_stack = _Stack()
_clock = time.perf_counter
# (enter, exit) of a user-scope record-function range, looked up on first use
_ranges: Optional[tuple] = None
_annotations_enabled = os.environ.get("SMELTER_TRACE_ANNOTATIONS", "") in (
    "1", "true", "yes", "on",
)


def _range_functions() -> tuple:
    global _ranges
    if _ranges is None:
        from torch.autograd import (
            _record_function_with_args_enter,
            _record_function_with_args_exit,
        )

        _ranges = (_record_function_with_args_enter, _record_function_with_args_exit)
    return _ranges


def enable_profiler_annotations(enabled: bool = True) -> None:
    """Also emit spans as user-scope record-function ranges on the
    profiler's timeline (timeline sink)."""
    global _annotations_enabled
    _annotations_enabled = enabled


class span:
    """Record a named span: ``with tracing.span("render.plan"): ...``."""

    __slots__ = ("name", "start", "child_s", "annotation")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "span":
        self.annotation = None
        if _annotations_enabled:
            try:
                self.annotation = _range_functions()[0](self.name)
            except Exception:
                self.annotation = None
        _stack.open.append(self)
        self.child_s = 0.0
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> None:
        elapsed = _clock() - self.start
        stack = _stack.open
        stack.remove(self)
        parent = stack[-1] if stack else None
        if parent is not None:
            parent.child_s += elapsed
        with _lock:
            agg = _aggregates.get(self.name)
            if agg is None:
                agg = _aggregates[self.name] = _Aggregate()
            agg.add(elapsed, elapsed - self.child_s,
                    parent.name if parent is not None else None)
        # the range ends last, so that it covers the bookkeeping and leaves
        # the least time between two sibling ranges to the enclosing span
        if self.annotation is not None:
            _ranges[1](self.annotation)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def count_each(counts: Iterable[Tuple[str, int]]) -> None:
    """Add each (name, n) of `counts` to its counter, under one lock."""
    with _lock:
        for name, n in counts:
            _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    """Counter snapshot for /stats: {name: total}."""
    with _lock:
        return dict(_counters)


def report() -> Dict[str, dict]:
    """Span snapshot for /stats: {name: {count, total_ms, avg_ms, max_ms,
    p50_ms, p95_ms, self_ms, parent}}; `self_ms` is the total less what its
    child spans cover, `parent` the enclosing span's name when it last
    ended (None at the top of its thread)."""
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
            "self_ms": round(agg.self_s * 1000.0, 3),
            "parent": agg.parent,
        }
    return out


def reset() -> None:
    """Drop all span aggregates and counters (tests, /api/reset)."""
    with _lock:
        _aggregates.clear()
        _counters.clear()
