"""Captured programs: the port's counterpart of `jax.jit` for a frame program.

The reference compiles the program of each scene structure once with
`jax.jit` (`smelter_tpu/render/program.py`, `OutputProgram._build_inner`) and
runs the compiled program on every later frame of that structure. Here the
program of a structure is the closure `OutputProgram._build_inner` returns
(or a flagship builder's function), captured once into a CUDA graph by
`capture` and replayed on every later frame:

  - The arguments are copied into static device buffers before each replay
    (from pinned host buffers, without waiting). A non-tensor argument (a
    shader's params) is a constant of the structure, fixed at capture.
  - One warm-up call on the capture stream runs first. It is the frame's own
    render, and it makes on the device what the structure fixes: K1's spec
    table, K3's kinds table, resize weights, shader constants. Those go
    through `interop.upload`, which refuses to run inside a capture, so a
    graph never holds a host-to-device copy.
  - The capture runs in "thread_local" mode on the program's own capture
    stream, so that another thread (the renderer's) can replay other graphs
    and enqueue copies meanwhile. Captures, warm-ups included, are
    serialised in the process, as the reference serialises its traces.
  - Every device tensor uploaded while a program is built belongs to it
    (`hold`), and the device constants that eager code caches across calls
    (`device_constant`) are the program's own while it is built: no cache
    eviction can free a tensor that a graph reads.
  - Each call returns copies of the graph's outputs, which no later replay
    writes.
  - Work counted per run (`each_run`: the kernels' launch counters;
    `count_each_run`: the routes' tracing counters) is recorded while the
    graph is captured and counted again on every replay, so the counters
    say what ran on the card.
  - Each call is traced in three spans (`render.load`, `render.replay`,
    `render.outputs`) and counted: `program.calls` and
    `program.calls.<route>` (the route its builder named, `route`), the
    bytes copied into the static buffers from the program's device
    (`program.load_d2d_bytes`) and from elsewhere, the host
    (`program.load_h2d_bytes`), and the bytes of the outputs copied out
    (`program.out_bytes`). The sizes are fixed when the program is
    captured, from its static buffers and the arguments of the capture.

On the CPU (the tests) the same static buffers are filled and copied out,
and the closure runs eagerly on them, with no graph.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import threading
import time
import traceback
from typing import Callable, List, Optional, Tuple

import torch

from smelter_tpu_torch.utils import tracing

# CUDA graphs allow one capture at a time in a process; the lock covers the
# warm-up on the capture stream as well
_CAPTURE_LOCK = threading.Lock()
_local = threading.local()


class CaptureError(RuntimeError):
    """A frame program could not be captured into a CUDA graph."""


class _Scope:
    """What one program build owns: the device tensors uploaded for it, its
    cached device constants, and, while its graph is captured, the per-run
    counters the graph replays."""

    def __init__(self) -> None:
        self.held: List[torch.Tensor] = []
        self.constants: dict = {}
        self.capturing = False
        self.on_replay: List[Callable[[], None]] = []


def _scope() -> Optional[_Scope]:
    return getattr(_local, "scope", None)


@contextlib.contextmanager
def _building():
    if _scope() is not None:
        raise RuntimeError("a program is already being built on this thread")
    _local.scope = scope = _Scope()
    try:
        yield scope
    finally:
        _local.scope = None


@contextlib.contextmanager
def _running():
    outer = getattr(_local, "running", False)
    _local.running = True
    try:
        yield
    finally:
        _local.running = outer


def in_program() -> bool:
    """Whether the calling code runs inside a frame program on this thread:
    while the program is built (its warm-up and capture) or run without a
    graph on the CPU. That code is what the reference traces inside a
    `jax.jit`, whose intermediate values its debug checks never see
    (`config.check_finite`)."""
    return _scope() is not None or getattr(_local, "running", False)


def hold(t: torch.Tensor) -> torch.Tensor:
    """Keep a device tensor alive for as long as the program being built on
    this thread, if any (a graph reads it by address). Returns `t`."""
    scope = _scope()
    if scope is not None:
        scope.held.append(t)
    return t


def each_run(count: Callable[[], None]) -> None:
    """Count one run of the calling code: now, or, while a graph is being
    captured on this thread, on each replay of that graph (the capture
    itself runs nothing on the card)."""
    scope = _scope()
    if scope is not None and scope.capturing:
        scope.on_replay.append(count)
    else:
        count()


def count_each_run(name: str, n: int = 1) -> None:
    """`tracing.count(name, n)` on each run of the calling code
    (`each_run`)."""
    each_run(functools.partial(tracing.count, name, n))


def device_constant(maxsize: int):
    """`functools.lru_cache` for functions that make device tensors from
    their (hashable) arguments. Outside a program build the results are
    shared process-wide, as an LRU cache of `maxsize`; while a program is
    built on this thread they are that program's own, made once in its
    warm-up and found again by its capture."""

    def wrap(fn):
        shared = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            scope = _scope()
            if scope is None:
                return shared(*args)
            key = (fn, args)
            if key not in scope.constants:
                scope.constants[key] = fn(*args)
            return scope.constants[key]

        get.cache_clear = shared.cache_clear
        return get

    return wrap


def route(name: str) -> Callable[[Callable], Callable]:
    """Name the route of a program function (a decorator): its captured
    program counts its calls under `program.calls.<name>`."""

    def name_it(fn: Callable) -> Callable:
        fn.route = name
        return fn

    return name_it


def _map_tensors(x, fn):
    """`x` (tensors in tuples, lists and dicts) with `fn` applied to each
    tensor; anything else is kept as it is."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    return x


def _tensors(x) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _map_tensors(x, out.append)
    return out


def _copy_into(static, args) -> None:
    """Copy each tensor of `args` into its static buffer, without waiting."""
    dst, src = _tensors(static), _tensors(args)
    if len(dst) != len(src):
        raise ValueError(f"a captured program takes {len(dst)} tensors, got {len(src)}")
    for d, s in zip(dst, src):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"a captured program takes a {tuple(d.shape)} {d.dtype} tensor "
                             f"here, got {tuple(s.shape)} {s.dtype}")
        d.copy_(s, non_blocking=True)


@contextlib.contextmanager
def _no_cyclic_gc():
    """No cyclic garbage collection inside a capture: an output program and
    its graphs live in reference cycles, and a graph destroyed on the
    capturing thread invalidates the capture."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _where(exc: BaseException) -> str:
    """The innermost line of the port that was running when `exc` was
    raised: the operation that could not be captured."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "smelter_tpu_torch" in f.filename and not f.filename.endswith("capture.py")]
    if not frames:
        return "an unknown operation"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} `{f.line}`"


def _call_counts(fn: Callable, static, args, outputs) -> Tuple[Tuple[str, int], ...]:
    """What one call of a program counts: its call, under its route too,
    the bytes loaded into `static` from `args` by where each argument lives,
    and the bytes of `outputs` copied out."""
    d2d = h2d = 0
    for dst, src in zip(_tensors(static), _tensors(args)):
        if src.device == dst.device:
            d2d += dst.nbytes
        else:
            h2d += dst.nbytes
    return (("program.calls", 1), (f"program.calls.{getattr(fn, 'route', 'unnamed')}", 1),
            ("program.load_d2d_bytes", d2d), ("program.load_h2d_bytes", h2d),
            ("program.out_bytes", sum(t.nbytes for t in _tensors(outputs))))


class CapturedProgram:
    """A program of one structure: static argument buffers and, on a CUDA
    device, the graph captured over them. Call it with arguments of the
    shapes it was captured with; it returns outputs that it never writes
    again. `capture_ms` is the host time of the warm-up and the capture,
    `graph_bytes` the device memory the capture reserved (0 on the CPU),
    `counts` what each call adds to the tracing counters (`_call_counts`)."""

    def __init__(self, fn: Callable, static, graph, outputs, scope: _Scope,
                 counts: Tuple[Tuple[str, int], ...], capture_ms: float = 0.0,
                 graph_bytes: int = 0) -> None:
        self.fn = fn
        self._static = static
        self._graph = graph
        self._outputs = outputs
        self._scope = scope  # the device tensors and constants the graph reads
        self.counts = counts
        self.capture_ms = capture_ms
        self.graph_bytes = graph_bytes

    def load(self, *args) -> None:
        """Copy `args` into the static argument buffers, without waiting."""
        _copy_into(self._static, args)

    def run(self):
        """Run the program on what its static buffers hold: one graph replay
        on a card. Returns the program's own outputs, which the next run
        writes again."""
        if self._graph is None:
            with _running():
                return self.fn(*self._static)
        self._graph.replay()
        for count in self._scope.on_replay:
            count()
        return self._outputs

    def __call__(self, *args):
        with tracing.span("render.load"):
            self.load(*args)
        with tracing.span("render.replay"):
            out = self.run()
        with tracing.span("render.outputs"):
            out = _map_tensors(out, torch.clone)
        tracing.count_each(self.counts)
        return out


def capture(fn: Callable, args: tuple, device, pool=None,
            stream: Optional[torch.cuda.Stream] = None) -> Tuple[CapturedProgram, object]:
    """Build the program of `fn` for arguments shaped as `args` (tensors in
    tuples, lists and dicts; the rest fixed) on `device`, and run it once on
    `args`. Returns (the program, the outputs of that run).

    On a CUDA device the run is the warm-up, on `stream` (a new stream if
    None), followed by the capture on the same stream into a graph that
    allocates from `pool` (a private pool if None). Raises CaptureError,
    naming the line of the port that could not be captured, when the
    capture fails. On the CPU, the run is the closure on the static
    buffers."""
    device = torch.device(device)
    with _building() as scope:
        static = _map_tensors(args, lambda t: torch.empty(t.shape, dtype=t.dtype, device=device))
        _copy_into(static, args)
        if device.type != "cuda":
            out = fn(*static)
            return (CapturedProgram(fn, static, None, None, scope,
                                    _call_counts(fn, static, args, out)), out)
        t0 = time.perf_counter()
        replay_stream = torch.cuda.current_stream(device)
        stream = stream if stream is not None else torch.cuda.Stream(device)
        graph = torch.cuda.CUDAGraph()
        # the warm-up too: work another thread enqueued on a capture stream
        # would join (and break) the capture running on it
        with _CAPTURE_LOCK, torch.cuda.stream(stream):
            stream.wait_stream(replay_stream)
            out = fn(*static)
            with _no_cyclic_gc():
                reserved = torch.cuda.memory_reserved(device)
                # torch.cuda.graph would also synchronise the device and
                # empty the caching allocators on entry, which from a
                # background capture would stall the renderer's thread
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                scope.capturing = True
                try:
                    outputs = fn(*static)
                except Exception as exc:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise CaptureError(f"capturing the frame program failed at "
                                       f"{_where(exc)}: {exc}") from exc
                finally:
                    scope.capturing = False
                graph.capture_end()
                graph_bytes = torch.cuda.memory_reserved(device) - reserved
            replay_stream.wait_stream(stream)
        # made on the capture stream, used on the replaying one: freeing them
        # must wait for that stream's work
        for t in scope.held + _tensors(out):
            t.record_stream(replay_stream)
        program = CapturedProgram(fn, static, graph, outputs, scope,
                                  _call_counts(fn, static, args, outputs),
                                  (time.perf_counter() - t0) * 1e3, graph_bytes)
    return program, out
