"""The per-layer metric `group_sdf_members` (`metrics/group_sdf_members.py`)
of the cell `multiview16_4k.steady`: the colour and shadow members K4
evaluates a call of the general program, read from the program's counters
on a synthetic counter set and from a traced run at the cell's small CPU
size (16 inputs of 192x108 into 768x432: 7 rings and 8 shadows behind a
picture), and silent where the program counts no general call, no such
member (the parent's), or nothing at all."""

import time

import _paths  # noqa: F401  (sys.path)
import pytest

from smelter_bench import cell as cellmod
from smelter_bench.harness import RunContext, run
from smelter_bench.trace import Digest

WORKLOAD = "multiview16_4k.steady"
SMALL = {"input_width": 192, "input_height": 108, "output_width": 768, "output_height": 432}
NAME = "group_sdf_members"


def _ctx():
    return RunContext(cell=cellmod.load_cell(WORKLOAD), spans={},
                      digest=Digest(frames=2, window_s=1.0))


def test_the_cell_lists_the_metric_last():
    cell = cellmod.load_cell(WORKLOAD)
    (m,) = [m for m in cell.per_layer if m["name"] == NAME]
    assert cell.per_layer[-1] is m and m["unit"] == "members" and m["better"] == "higher"
    assert m["moves"] == "chip_frames_per_s" and m["workloads"] == [WORKLOAD]
    for other in ("tiles4to1_1080p.steady", "tiles16_4k.steady"):
        assert NAME not in [m["name"] for m in cellmod.load_cell(other).per_layer]


def test_reads_the_counter_ratio():
    from smelter_tpu_torch.utils import tracing

    reader = cellmod.load_cell(WORKLOAD).metric_reader(NAME)
    tracing.reset()
    try:
        tracing.count_each((("program.calls.general", 4), ("program.general.sdf_members", 60)))
        assert reader.read(_ctx()) == 15.0
    finally:
        tracing.reset()


def test_silent_without_general_calls_or_members(monkeypatch):
    from smelter_tpu_torch.utils import tracing

    reader = cellmod.load_cell(WORKLOAD).metric_reader(NAME)
    tracing.reset()
    try:
        # members counted, no general call
        tracing.count("program.general.sdf_members", 15)
        assert reader.read(_ctx()) is None
        # general calls counted, no member counter (a program before it)
        tracing.reset()
        tracing.count("program.calls.general", 3)
        assert reader.read(_ctx()) is None
        # a program without counters at all
        monkeypatch.delattr(tracing, "counters")
        assert reader.read(_ctx()) is None
    finally:
        tracing.reset()


def test_a_traced_run_reads_fifteen_members():
    result, _ = run(WORKLOAD, 2**31 + 2424, 1.0, True, time.perf_counter(), device="cpu",
                    cfg_overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0
    assert result["metrics"][NAME] == {"value": pytest.approx(15.0), "unit": "members"}
