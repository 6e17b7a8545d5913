"""`tools._profile`'s reader of a CUDA trace, on stand-in raw profiler
events: a device activity belongs to the frame whose range on the card
holds it, wherever the card's clock puts it against the host's markers."""

from __future__ import annotations

from dataclasses import dataclass

import pytest
import torch

from smelter_tpu_torch.tools import _profile
from smelter_tpu_torch.tools._profile import FRAME, FrameProfile, device_activity_by_frame

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@dataclass
class Raw:
    """The methods of a raw profiler event that the reader calls."""
    _name: str
    _device: object
    _start: int
    _end: int
    _corr: int
    _linked: int = 0
    _thread: int = 1

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def start_thread_id(self):
        return self._thread


def trace(shift_ns=0):
    """Three frames of 10 us on the host, each launching a host copy and one
    kernel, on the card's clock moved by `shift_ns` against the host's; the
    card's range of frame 1 comes in two pieces (two streams). Also a kernel
    that runs between frames 0 and 1 on the card."""
    raw = []
    for k in range(3):
        t0 = 100_000 + k * 10_000
        d0 = t0 + shift_ns
        raw += [Raw(FRAME, CPU, t0, t0 + 9_000, 10 + k),
                Raw("aten::op", CPU, t0 + 1_000, t0 + 2_000, 20 + k),
                # a runtime call whose own id is another marker's
                Raw("cudaLaunchKernel", CPU, t0 + 1_100, t0 + 1_200, 10 + (k + 1) % 3, 20 + k),
                Raw("Memcpy HtoD (Pinned -> Device)", CUDA, d0 + 2_000, d0 + 2_800, 950 + k,
                    20 + k),
                Raw(f"kernel_{k}", CUDA, d0 + 3_000, d0 + 5_000, 900 + k, 0)]
        if k == 1:
            raw += [Raw(FRAME, CUDA, d0 + 2_000, d0 + 2_800, 10 + k, 0),
                    Raw(FRAME, CUDA, d0 + 3_000, d0 + 5_000, 10 + k, 0)]
        else:
            raw.append(Raw(FRAME, CUDA, d0 + 2_000, d0 + 5_000, 10 + k, 0))
    raw.append(Raw("kernel_between", CUDA, 106_000 + shift_ns, 107_000 + shift_ns, 990, 0))
    return raw


@pytest.mark.parametrize("shift_ns", [0, -7_800, 9_000])
def test_device_activity_goes_to_the_frame_whose_card_range_holds_it(shift_ns):
    frames = device_activity_by_frame(trace(shift_ns))
    assert [[a[0] for a in acts] for acts in frames] == [["kernel_0"], ["kernel_1"], ["kernel_2"]]
    d0 = 100_000 + 2 * 10_000 + shift_ns
    assert frames[2][0][1:] == ((d0 + 3_000) / 1e3, (d0 + 5_000) / 1e3)


def test_a_frame_with_no_device_activity_raises(monkeypatch):
    raw = [r for r in trace() if r.name() != "kernel_2"]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return raw

        @staticmethod
        def __exit__(*exc):
            return False

    waits = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device: waits.append("sync"))
    monkeypatch.setattr(_profile.time, "sleep", lambda s: waits.append(s))
    fp = FrameProfile("cpu")
    fp._cuda, fp._prof = True, Prof()
    with pytest.raises(RuntimeError, match="no activity on cpu for frame 2 of 3"):
        fp.__exit__(None, None, None)
    # the card is idle for QUIET_S before the trace stops
    assert waits == ["sync", _profile.QUIET_S]


def test_an_empty_frame_prints_the_records_around_it(monkeypatch, capsys):
    """Before it raises, the reader prints the markers of frames 0-2 on the
    host and the card and the card's records between them: the kernels the
    other frames hold, the one between two frames and the host copy of the
    empty frame."""
    raw = [r for r in trace() if r.name() != "kernel_1"]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return raw

        @staticmethod
        def __exit__(*exc):
            return False

    monkeypatch.setattr(torch.cuda, "synchronize", lambda device: None)
    monkeypatch.setattr(_profile.time, "sleep", lambda s: None)
    fp = FrameProfile("cpu")
    fp._cuda, fp._prof = True, Prof()
    with pytest.raises(RuntimeError, match="no activity on cpu for frame 1 of 3"):
        fp.__exit__(None, None, None)
    err = capsys.readouterr().err
    assert "profiler trace around frame 1 of 3" in err
    assert "frame 0: host -10000..-1000, card -8000..-5000" in err
    assert "frame 1: host 0..9000, card 2000..2800, 3000..5000" in err
    for name in ("kernel_0", "kernel_between", "kernel_2", "Memcpy HtoD"):
        assert name in err
    assert "(correlation 11, marker of frame 1)" in err


def test_records_around_keeps_the_first_and_last_records():
    text = _profile.records_around(trace(), 1, limit=4)
    lines = text.splitlines()
    assert "    ... 7 more" in lines
    assert lines[1] == "  frame 0: host -10000..-1000, card -8000..-5000"
    assert lines[-1] == "    13000..15000 kernel_2 (correlation 902)"
