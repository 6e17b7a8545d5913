"""The per-layer metrics of the tile converts' banded resize in the cell
`multiview16_4k.steady`: `tile_resize_ms` (`metrics/tile_resize_ms.py`,
device ms an output frame of the kernels named `tile_resize`) on a
synthetic trace, and `tile_resize_planes` (`metrics/tile_resize_planes.py`,
the tile planes a call of the general program resizes) on a synthetic
counter set and from a traced run at the cell's small CPU size (16 inputs
of 192x108 into 768x432: 3 planes of each of 16 tiles); both silent where
the program has no such kernel or counter (the parent's)."""

import time

import _paths  # noqa: F401  (sys.path)
import pytest

from smelter_bench import cell as cellmod
from smelter_bench.harness import RunContext, run
from smelter_bench.trace import Digest

WORKLOAD = "multiview16_4k.steady"
SMALL = {"input_width": 192, "input_height": 108, "output_width": 768, "output_height": 432}
NAMES = ("tile_resize_ms", "tile_resize_planes")
KERNEL = "(anonymous namespace)::tile_resize_kernel((anonymous namespace)::TileArgs)"


def _ctx(device=()):
    return RunContext(cell=cellmod.load_cell(WORKLOAD), spans={},
                      digest=Digest(frames=2, window_s=1.0, device=list(device)))


@pytest.mark.parametrize("name,unit,better", [("tile_resize_ms", "ms", "lower"),
                                              ("tile_resize_planes", "planes", "higher")])
def test_the_cell_lists_the_metric_for_the_multiview_alone(name, unit, better):
    (m,) = [m for m in cellmod.load_cell(WORKLOAD).per_layer if m["name"] == name]
    assert m["unit"] == unit and m["better"] == better and m["workloads"] == [WORKLOAD]
    assert m["moves"] == "chip_frames_per_s"
    assert m["layer"] == "tile converts, banded resize (ops/hopper/, csrc/)"
    for other in ("tiles4to1_1080p.steady", "tiles16_4k.steady"):
        assert name not in [m["name"] for m in cellmod.load_cell(other).per_layer]


def test_tile_resize_ms_sums_the_kernel_a_frame():
    reader = cellmod.load_cell(WORKLOAD).metric_reader("tile_resize_ms")
    device = [(KERNEL, 0.0, 0.0002), ("void cutlass::Kernel2<s16816gemm_bf16>", 0.0002, 0.0010),
              ("(anonymous namespace)::grid_resize_kernel(GridArgs)", 0.0010, 0.0011),
              (KERNEL, 0.0011, 0.0013)]
    assert reader.read(_ctx(device)) == pytest.approx(0.2)  # 0.4 ms over 2 frames


def test_tile_resize_ms_is_silent_without_the_kernel():
    reader = cellmod.load_cell(WORKLOAD).metric_reader("tile_resize_ms")
    assert reader.read(_ctx()) is None
    assert reader.read(_ctx([("nvjet_tst_64x136_64x8_2x4_h_bz_NNT", 0.0, 0.001)])) is None


def test_tile_resize_planes_reads_the_counter_ratio():
    from smelter_tpu_torch.utils import tracing

    reader = cellmod.load_cell(WORKLOAD).metric_reader("tile_resize_planes")
    tracing.reset()
    try:
        tracing.count_each((("program.calls.general", 4),
                            ("program.general.tile_resize_planes", 192)))
        assert reader.read(_ctx()) == 48.0
    finally:
        tracing.reset()


def test_tile_resize_planes_is_silent_without_general_calls_or_planes(monkeypatch):
    from smelter_tpu_torch.utils import tracing

    reader = cellmod.load_cell(WORKLOAD).metric_reader("tile_resize_planes")
    tracing.reset()
    try:
        tracing.count("program.general.tile_resize_planes", 48)
        assert reader.read(_ctx()) is None
        tracing.reset()
        tracing.count("program.calls.general", 3)
        assert reader.read(_ctx()) is None
        monkeypatch.delattr(tracing, "counters")
        assert reader.read(_ctx()) is None
    finally:
        tracing.reset()


def test_a_traced_run_reads_48_planes():
    result, _ = run(WORKLOAD, 2**31 + 2626, 1.0, True, time.perf_counter(), device="cpu",
                    cfg_overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0
    assert result["metrics"]["tile_resize_planes"] == {"value": pytest.approx(48.0),
                                                       "unit": "planes"}
    # the CPU's trace holds no device activity
    assert "tile_resize_ms" not in result["metrics"]
