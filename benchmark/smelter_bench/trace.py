"""What a torch.profiler trace of a window of frames says: the card's busy
time (the union of its kernels, memsets and copies), each kernel class's
time, the device ops that took most time, and the card's idle gaps by the
host span that was open meanwhile.

The busy union is copied from the port's `tools/_profile.py` (`busy_ms`):
busy time and not the span, because CUPTI stretches the gaps between the
kernels of a graph replay. Here two frames are in flight, so no activity
is placed in a frame: the window is traced alone (the trace opens idle,
before its first frame, and closes once its last frame has reached the
host, `QUIET_S` later, since the profiler keeps only the device records
that fall inside its window on the host's clock), and every device
activity of the trace belongs to its frames."""

from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

QUIET_S = 0.1
# cuBLAS's GEMM mainloops and split-K reductions by kernel name (the
# mainloop pattern is `chip_smoke.py`'s GEMM_RE)
GEMM_RE = re.compile(r"gemm|nvjet|splitkreduce", re.IGNORECASE)
# the hand-written kernels K1-K5 (`smelter_tpu_torch/csrc/*.cu`)
HOPPER_RE = re.compile(r"scene_assembly_kernel|sdf_layers_kernel|yuv420_out|"
                       r"group_blend_kernel|row_shear_kernel")
NAME_CHARS = 100  # device op names in the breakdown are cut to this length
TO_HOST = "Memcpy DtoH"  # a copy from the card into host memory


def kind(name: str) -> str:
    """"copy", "memset", "gemm", "hopper" or "torch" (any other kernel)."""
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "memset"
    if GEMM_RE.search(name):
        return "gemm"
    if HOPPER_RE.search(name):
        return "hopper"
    return "torch"


def merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of intervals, as disjoint intervals in order."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class Digest:
    """A traced window of `frames` output frames over `window_s` seconds of
    the host's clock. Times in seconds; `device` holds (name, start, end) of
    each device activity, `host` (name, start, end) of each span."""
    frames: int
    window_s: float
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)

    def busy_s(self, to_host: bool = True) -> float:
        """The card's busy seconds; without `to_host`, leaving out the
        copies into host memory, whose speed the host's memory sets."""
        return sum(e - s for s, e in merged(
            [(s, e) for n, s, e in self.device if to_host or not n.startswith(TO_HOST)]))

    def kind_s(self, k: str) -> float:
        return sum(e - s for n, s, e in self.device if kind(n) == k)

    def copies_to_host(self) -> int:
        return sum(1 for n, _, _ in self.device if n.startswith(TO_HOST))

    def device_ops(self, top: int = 10) -> List[list]:
        totals: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device:
            totals[n[:NAME_CHARS]] += e - s
        return [[n, t] for n, t in sorted(totals.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The card's idle gaps between its first and its last activity,
        summed by the innermost host span open at each gap's middle."""
        busy = merged([(s, e) for _, s, e in self.device])
        totals: Dict[str, float] = defaultdict(float)
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) / 2
            open_ = [(e - s, n) for n, s, e in self.host if s <= mid < e]
            totals[min(open_)[1] if open_ else "no span"] += b - a
        return [[n, t] for n, t in sorted(totals.items(), key=lambda x: -x[1])[:top]]


class Trace:
    """torch.profiler over one window of frames on `device`: the card's
    activity, and with `host` the host's spans too (nothing at all on a
    CPU device without `host`):

        tr = Trace(device, host); tr.start(); ...frames...; digest = tr.stop(n)

    stop() is called once no other thread launches work on the card (the
    fetch thread only waits on events)."""

    def __init__(self, device, host: bool) -> None:
        import torch

        self._torch = torch
        self._cuda = torch.device(device).type == "cuda"
        self._host = host
        self._prof = None
        self._t0 = 0.0

    def _sync(self) -> None:
        if self._cuda:
            self._torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] if self._host else []
        if self._cuda:
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        if activities:
            self._prof = profile(activities=activities)
            self._prof.__enter__()
            time.sleep(QUIET_S)
        self._t0 = time.perf_counter()

    def stop(self, frames: int) -> Digest:
        self._sync()
        window = time.perf_counter() - self._t0
        digest = Digest(frames=frames, window_s=window)
        if self._prof is None:
            return digest
        time.sleep(QUIET_S)
        self._prof.__exit__(None, None, None)
        dev_type = self._torch.autograd.DeviceType.CUDA
        events = self._prof.profiler.kineto_results.events()
        device, host = [], []
        for e in events:
            if e.device_type() == dev_type:
                device.append(e)
            elif self._host and e.is_user_annotation():
                host.append((e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9))
        # a span's range on the card carries the span's name: not an activity
        spans = {n for n, _, _ in host}
        for e in device:
            if not e.is_user_annotation() and e.name() not in spans:
                digest.device.append((e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9))
        digest.host = host
        self._prof = None
        return digest


def card_line() -> Optional[str]:
    """`nvidia-smi`'s name and power limit of the card, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None
