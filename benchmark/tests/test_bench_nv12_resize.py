"""The per-layer metrics of the fused NV12 convert-and-resize pass in the
cell `tiles16_4k_nv12.steady`: `nv12_tiles` (`metrics/nv12_tiles.py`, the
NV12 tiles a call of the general program makes) on synthetic counters and
from a traced run at the cell's small CPU size (16 NV12 inputs of 192x108
into 384x216: 16 tiles a call), and `nv12_resize_ms`
(`metrics/nv12_resize_ms.py`, device ms an output frame of the kernels
named `nv12_convert_resize`) on a synthetic trace; both silent where the
program has no such counter or kernel (the parent's)."""

import time

import _paths  # noqa: F401  (sys.path)
import pytest

from smelter_bench import cell as cellmod
from smelter_bench.harness import RunContext, run
from smelter_bench.trace import Digest

WORKLOAD = "tiles16_4k_nv12.steady"
SMALL = {"input_width": 192, "input_height": 108, "output_width": 384, "output_height": 216}
LAYER = "general route, RGBA input route (render/program.py, ops/color_convert.py)"
KERNEL = "(anonymous namespace)::nv12_convert_resize_kernel((anonymous namespace)::Nv12Args)"


def _ctx(device=()):
    return RunContext(cell=cellmod.load_cell(WORKLOAD), spans={},
                      digest=Digest(frames=2, window_s=1.0, device=list(device)))


@pytest.mark.parametrize("name,unit,better,source", [
    ("nv12_tiles", "tiles", "higher", "program_counter"),
    ("nv12_resize_ms", "ms", "lower", "device_trace")])
def test_the_cell_lists_the_metric_for_the_nv12_tiles_alone(name, unit, better, source):
    (m,) = [m for m in cellmod.load_cell(WORKLOAD).per_layer if m["name"] == name]
    assert (m["unit"], m["better"], m["source"]) == (unit, better, source)
    assert m["workloads"] == [WORKLOAD] and m["moves"] == "chip_frames_per_s"
    assert m["layer"] == LAYER
    for other in ("tiles4to1_1080p.steady", "tiles16_4k.steady", "multiview16_4k.steady"):
        assert name not in [m["name"] for m in cellmod.load_cell(other).per_layer]


def test_nv12_resize_ms_sums_the_kernel_a_frame():
    reader = cellmod.load_cell(WORKLOAD).metric_reader("nv12_resize_ms")
    device = [(KERNEL, 0.0, 0.0003), ("void cutlass::Kernel2<s16816gemm_bf16>", 0.0003, 0.0010),
              ("(anonymous namespace)::tile_resize_kernel((anonymous namespace)::TileArgs)",
               0.0010, 0.0011), (KERNEL, 0.0011, 0.0014)]
    assert reader.read(_ctx(device)) == pytest.approx(0.3)  # 0.6 ms over 2 frames


def test_nv12_resize_ms_is_silent_without_the_kernel():
    reader = cellmod.load_cell(WORKLOAD).metric_reader("nv12_resize_ms")
    assert reader.read(_ctx()) is None
    assert reader.read(_ctx([("nvjet_tst_64x136_64x8_2x4_h_bz_NNT", 0.0, 0.001)])) is None


def test_nv12_tiles_reads_the_counter_ratio(monkeypatch):
    from smelter_tpu_torch.utils import tracing

    reader = cellmod.load_cell(WORKLOAD).metric_reader("nv12_tiles")
    tracing.reset()
    try:
        tracing.count_each((("program.calls.general", 4), ("program.general.nv12_tiles", 64)))
        assert reader.read(_ctx()) == 16.0
        # the counter without a general call, and a general call without the
        # counter (the parent's program): nothing to read
        tracing.reset()
        tracing.count("program.general.nv12_tiles", 16)
        assert reader.read(_ctx()) is None
        tracing.reset()
        tracing.count("program.calls.general", 3)
        assert reader.read(_ctx()) is None
        monkeypatch.delattr(tracing, "counters")
        assert reader.read(_ctx()) is None
    finally:
        tracing.reset()


def test_a_traced_run_reads_16_tiles_and_no_conversion():
    result, _ = run(WORKLOAD, 2**31 + 2929, 1.0, True, time.perf_counter(), device="cpu",
                    cfg_overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0
    m = result["metrics"]
    assert m["nv12_tiles"] == {"value": pytest.approx(16.0), "unit": "tiles"}
    # the picture is never converted whole: both counters read 0, not nothing
    assert m["rgba_converts"]["value"] == m["rgba_mip_levels"]["value"] == 0.0
    # the CPU's trace holds no device activity
    assert "nv12_resize_ms" not in m
