"""Per-frame device time from a torch.profiler trace: the port's counterpart
of the readers of jax.profiler's "XLA Modules" and "XLA Ops" tracks in the
reference's `tools/bench_scenes.py`, `bench_animations.py` and
`bench_flagship_ops.py`.

The reference reads one frame's device time as the duration of its `jit_*`
module on the device. The port runs a frame as a CUDA graph replay and a
few copies, so a frame's device time here is the time the card is busy
with the frame's call: the union of the intervals of its kernels, memsets
and copies on the card, leaving out the copies from and to host memory
(the reference's module leaves its transfers out too). Beside it: the
summed kernel time of each frame, each kernel's time by name, and the span
from the frame's first device activity to its last.

Busy time, not the span, because CUPTI's tracing stretches the gaps
between the kernels of a graph replay: under the profiler a replay's span
grows with its number of kernels, while its busy time stays that of the
replay timed between CUDA events without the profiler (`chip_smoke.py`
phase 17 prints the three side by side for general_4k). Host time
(planning, packing the inputs) is never in the busy time, even where the
card waits for it in the middle of a frame.

Each frame is marked on the host with `record_function`, and the card is
synchronised at the end of its call, so that two frames' work never
overlaps on the card. The profiler puts each marker's range on the card's
timeline too, from the work launched under it (the kernels of a graph
replay included). A device activity belongs to the frame whose range on
the card holds it: the card's timestamps, put on the host's clock, can be
off by milliseconds against the host's (seen on an H100: in one trace,
the activities of the last frame all fell before its host marker
began), so they are never compared with the host's markers. For the same
reason the trace stays open and idle for `QUIET_S` before the first frame
and after the last: the profiler keeps only the device records that fall
inside its window on the host's clock, and an H100 run without that
margin lost the device records of the last frame. The profiler may still
leave out a few records at a trace's start (seen on an H100: the first
two device-to-device copies of the first frame, absent from the trace
with or without the margin).

On the CPU (`device="cpu"`) the device is the CPU: a frame's activity is
the top-level operators its call ran, and their names stand for kernels.
A trace that holds no device activity for a frame raises: there is no
switch to wall time. On a CUDA device it first prints to stderr the
trace's records around that frame (`records_around`): the markers of the
frames beside it, on the host and on the card, and the card's records
between them, so that a run where it happens leaves the evidence.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

FRAME = "smelter.tools.frame"
# on a CUDA device: seconds the trace stays open, idle, before the first
# frame and after the last (see the module's docstring)
QUIET_S = 0.1
# device events that are transfers to or from host memory, not compute
_HOST_COPIES = ("Memcpy HtoD", "Memcpy DtoH")
_NOT_KERNELS = ("Memcpy", "Memset")


def card(device) -> Optional[str]:
    """The card's name and power limit as `nvidia-smi` gives them; None on
    the CPU."""
    from smelter_tpu_torch.bench import card_name

    return card_name() if torch.device(device).type == "cuda" else None


class FrameProfile:
    """A torch.profiler trace of frames, read per frame:

        with FrameProfile(device) as fp:
            for ...:
                with fp.frame():
                    render(...)
        fp.busy_ms()   # each frame's device time, in ms, in frame order

    Only the frames run inside `frame()` are read; the trace must stop
    while no other thread launches work on the card (stopping torch's
    profiler against a CUDA graph replayed on another thread can deadlock)."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._prof = None
        # per frame: [(name, start us, end us)] of its device activities
        self._frames: List[List[tuple]] = []

    def __enter__(self) -> "FrameProfile":
        activities = [ProfilerActivity.CPU]
        if self._cuda:
            torch.cuda.synchronize(self.device)
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        if self._cuda:
            time.sleep(QUIET_S)
        return self

    @contextlib.contextmanager
    def frame(self):
        """Mark one frame: the work launched inside belongs to it."""
        with record_function(FRAME):
            yield
            if self._cuda:
                torch.cuda.synchronize(self.device)

    def __exit__(self, *exc) -> bool:
        if self._cuda and exc[0] is None:
            torch.cuda.synchronize(self.device)
            time.sleep(QUIET_S)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            raw = self._prof.profiler.kineto_results.events() if self._cuda else None
            if self._cuda:
                self._frames = device_activity_by_frame(raw)
            else:
                self._frames = self._read_cpu(self._prof.events())
            for k, acts in enumerate(self._frames):
                if not acts:
                    if self._cuda:
                        print(records_around(raw, k), file=sys.stderr)
                    raise RuntimeError(f"the profiler trace holds no activity on {self.device} "
                                       f"for frame {k} of {len(self._frames)}")
        return False

    @staticmethod
    def _read_cpu(events) -> List[List[tuple]]:
        """Per frame: the top-level operators run under its marker."""
        cpu = torch.autograd.DeviceType.CPU
        markers = sorted((e for e in events if e.name == FRAME and e.device_type == cpu),
                         key=lambda e: e.time_range.start)
        index = {id(m): k for k, m in enumerate(markers)}
        frames: List[List[tuple]] = [[] for _ in markers]
        for e in events:
            k = index.get(id(e.cpu_parent)) if e.cpu_parent is not None else None
            if k is not None and e.device_type == cpu:
                frames[k].append((e.name, e.time_range.start, e.time_range.end))
        return frames

    def _is_kernel(self, name: str) -> bool:
        return not (self._cuda and name.startswith(_NOT_KERNELS))

    def busy_ms(self) -> List[float]:
        """Per frame: ms during which at least one of its device activities
        runs (the union of their intervals)."""
        out = []
        for acts in self._frames:
            busy, end = 0.0, float("-inf")
            for s, e in sorted((s, e) for _, s, e in acts):
                if e > end:
                    busy += e - max(s, end)
                    end = e
            out.append(busy / 1e3)
        return out

    def activity_counts(self) -> List[int]:
        """Per frame: the number of its device activities."""
        return [len(acts) for acts in self._frames]

    def spans_ms(self) -> List[float]:
        """Per frame: ms from its first device activity's start to its last's
        end (idle gaps included)."""
        return [(max(e for _, _, e in acts) - min(s for _, s, _ in acts)) / 1e3
                for acts in self._frames]

    def kernel_ms(self) -> List[float]:
        """Per frame: the summed ms of its kernels (on the CPU, of its
        top-level operators)."""
        return [sum(e - s for n, s, e in acts if self._is_kernel(n)) / 1e3
                for acts in self._frames]

    def op_totals_ms(self) -> Dict[str, float]:
        """ms by device activity name, summed over every frame (memsets and
        device-to-device copies included, as the reference's op track
        holds every op)."""
        totals: Dict[str, float] = defaultdict(float)
        for acts in self._frames:
            for name, s, e in acts:
                totals[name] += (e - s) / 1e3
        return dict(totals)


def device_activity_by_frame(raw) -> List[List[tuple]]:
    """Per frame marker of a CUDA trace's raw events (in the order of the
    markers): [(name, start us, end us)] of the device activities inside
    the marker's range on the card, the range the profiler puts on the
    card's timeline from the work launched under the marker (graph replays
    included). Host copies and the ranges themselves are left out."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    markers = sorted((r for r in raw if r.name() == FRAME and r.device_type() == cpu),
                     key=lambda r: r.start_ns())
    index = {m.correlation_id(): k for k, m in enumerate(markers)}
    # each frame's range on the card: one per stream it used, merged
    ranges: Dict[int, tuple] = {}
    for r in raw:
        k = index.get(r.correlation_id())
        if r.name() == FRAME and r.device_type() == cuda and k is not None:
            s, e = ranges.get(k, (r.start_ns(), r.end_ns()))
            ranges[k] = (min(s, r.start_ns()), max(e, r.end_ns()))
    order = sorted((s, e, k) for k, (s, e) in ranges.items())
    starts = [s for s, _, _ in order]
    frames: List[List[tuple]] = [[] for _ in markers]
    for r in raw:
        if r.device_type() != cuda or r.name() == FRAME or r.name().startswith(_HOST_COPIES):
            continue
        i = bisect.bisect_right(starts, r.start_ns()) - 1
        if i >= 0 and r.end_ns() <= order[i][1]:
            frames[order[i][2]].append((r.name(), r.start_ns() / 1e3, r.end_ns() / 1e3))
    return frames


def records_around(raw, k: int, limit: int = 80) -> str:
    """The records of a CUDA trace's raw events around frame `k` (in the
    order of the frame markers), as text: the host marker and the card's
    ranges of frames k - 1 to k + 1, then every record on the card (host
    copies and markers' ranges included) that starts between the first of
    those times and the last, at most `limit` (the first and last halves).
    Times are ns from the host marker of frame k."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    markers = sorted((r for r in raw if r.name() == FRAME and r.device_type() == cpu),
                     key=lambda r: r.start_ns())
    near = {m.correlation_id(): j for j, m in enumerate(markers) if abs(j - k) <= 1}
    t0 = markers[k].start_ns()
    lines = [f"profiler trace around frame {k} of {len(markers)} (ns from its host marker):"]
    times = []
    for j in sorted(set(near.values())):
        m = markers[j]
        card = sorted((r.start_ns(), r.end_ns()) for r in raw
                      if r.name() == FRAME and r.device_type() == cuda
                      and r.correlation_id() == m.correlation_id())
        times += [m.start_ns(), m.end_ns()] + [t for se in card for t in se]
        lines.append(f"  frame {j}: host {m.start_ns() - t0}..{m.end_ns() - t0}, card "
                     + (", ".join(f"{s - t0}..{e - t0}" for s, e in card) or "none"))
    lo, hi = min(times), max(times)
    recs = sorted((r for r in raw if r.device_type() == cuda and lo <= r.start_ns() <= hi),
                  key=lambda r: r.start_ns())
    lines.append(f"  {len(recs)} records on the card from {lo - t0} to {hi - t0}:")
    shown = recs if len(recs) <= limit else recs[:limit // 2] + [None] + recs[-(limit // 2):]
    for r in shown:
        if r is None:
            lines.append(f"    ... {len(recs) - 2 * (limit // 2)} more")
            continue
        frame = near.get(r.correlation_id())
        lines.append(f"    {r.start_ns() - t0}..{r.end_ns() - t0} {r.name()} "
                     f"(correlation {r.correlation_id()}"
                     + (f", marker of frame {frame})" if frame is not None else ")"))
    return "\n".join(lines)
