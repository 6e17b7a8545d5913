"""The per-layer metrics that read the program's counters
(`metrics/static_load_mb.py`, `metrics/output_clone_mb.py`), from a traced
run of each cell at its small CPU size: the MB a call loads into its
captured program are the input planes its output shows plus the packed
parameters, under 256 bytes a tile, the MB it copies out are its output planes. And with a
program that counts nothing, each reader returns nothing."""

import time

import _paths
import pytest

from smelter_bench import cell as cellmod
from smelter_bench.harness import RunContext, run
from smelter_bench.trace import Digest

WORKLOADS = ["tiles4to1_1080p.steady", "tiles16_4k.steady"]
METRICS = ("static_load_mb", "output_clone_mb")


def _yuv420_bytes(w: int, h: int) -> int:
    return w * h + 2 * (w // 2) * (h // 2)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_counter_metrics_read_the_small_shapes(workload):
    small = _paths.small(workload)
    result, _ = run(workload, 2**31 + 4242, 1.0, True, time.perf_counter(), device="cpu",
                    cfg_overrides=small)
    assert result["correct"] is True
    c = cellmod.load_cell(workload, cfg_overrides=small)
    tiles = c.cfg["inputs_per_output"]
    inputs = tiles * _yuv420_bytes(small["input_width"], small["input_height"])
    out = _yuv420_bytes(small["output_width"], small["output_height"])
    m = result["metrics"]
    assert m["static_load_mb"]["unit"] == "MB" and m["output_clone_mb"]["unit"] == "MB"
    assert inputs / 1e6 < m["static_load_mb"]["value"] < (inputs + 256 * tiles) / 1e6
    assert m["output_clone_mb"]["value"] == pytest.approx(out / 1e6, rel=1e-12)


def test_counter_metrics_are_silent_without_calls(monkeypatch):
    from smelter_tpu_torch.utils import tracing

    c = cellmod.load_cell(WORKLOADS[0])
    ctx = RunContext(cell=c, spans={}, digest=Digest(frames=4, window_s=1.0))
    tracing.reset()
    assert [c.metric_reader(n).read(ctx) for n in METRICS] == [None, None]
    # a program without counters (before they were added) reads nothing too
    monkeypatch.delattr(tracing, "counters")
    assert [c.metric_reader(n).read(ctx) for n in METRICS] == [None, None]
