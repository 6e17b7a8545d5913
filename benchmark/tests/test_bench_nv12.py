"""The cell `tiles16_4k_nv12.steady` on the CPU, at a small size defined
here (16 NV12 inputs of 192x108 into 384x216): a whole run, correct,
untraced and traced; the least bytes of a 4K tick by hand; its two
per-layer readers (`rgba_converts`, `rgba_mip_levels`) on synthetic
counters, and silent without them (the parent's program); the float8
control failing; four faults under the timed path not correct; the
structure keys of its traffic fitting the program cache; and the
configuration naming its sources."""

import json
import time

import _paths
import pytest

from smelter_bench import cell as cellmod
from smelter_bench.harness import RunContext, run
from smelter_bench.trace import Digest

WORKLOAD = "tiles16_4k_nv12.steady"
SMALL = {"input_width": 192, "input_height": 108, "output_width": 384, "output_height": 216}
SEED = 2**31 + 2828
NAMES = ("rgba_converts", "rgba_mip_levels")
LAYER = "general route, RGBA input route (render/program.py, ops/color_convert.py)"
# per call of the general program at the small size: 16 inputs converted,
# one mip level each beyond level 0 (2 levels at 108 rows)
PER_CALL_SMALL = {"rgba_converts": 16.0, "rgba_mip_levels": 16.0}


def _ctx():
    return RunContext(cell=cellmod.load_cell(WORKLOAD), spans={},
                      digest=Digest(frames=2, window_s=1.0))


@pytest.mark.parametrize("trace", [False, True])
def test_whole_run_on_the_cpu(trace):
    result, sampled = run(WORKLOAD, SEED, 1.0, trace, time.perf_counter(), device="cpu",
                          cfg_overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    checked = {k: v["value"] for k, v in result["checked"].items()}
    assert checked["max_lsb"] <= 1 and checked["diff_ppm"] < 200, checked
    # a loaded CPU may render fewer ticks in the window than a run samples
    assert 1 <= len(sampled) <= 6
    m = result["metrics"]
    if trace:
        # on the CPU no device activity is traced: the counter readers speak
        assert set(m) == {"captures_in_window", "static_load_mb", "output_clone_mb", *NAMES}
        assert m["captures_in_window"]["value"] == 0.0
        assert m["rgba_converts"] == {"value": 16.0, "unit": "inputs"}
        assert m["rgba_mip_levels"] == {"value": 16.0, "unit": "levels"}
    else:
        assert set(m) == {"setup_s"}


def test_least_bytes_of_a_4k_tick():
    cell = cellmod.load_cell(WORKLOAD)
    api = cellmod.program_api()
    shown = cellmod.shown_inputs(cell.scene.build(api, cell.cfg, 0, "out_0"))
    assert shown == set(cellmod.input_ids(cell.cfg))
    # 16 NV12 inputs of 1920 x 1080 (luma, then interleaved chroma at half
    # size) read once, one 3840 x 2160 YUV420 frame written
    assert cellmod.input_bytes(cell.cfg, "input_0") == 1920 * 1080 + 960 * 540 * 2
    assert cellmod.least_bytes(cell.cfg, shown, 1) == 16 * 3_110_400 + 12_441_600 == 62_208_000


@pytest.mark.parametrize("name,unit", [("rgba_converts", "inputs"),
                                       ("rgba_mip_levels", "levels")])
def test_the_cell_lists_the_metric_alone(name, unit):
    cell = cellmod.load_cell(WORKLOAD)
    assert [m["name"] for m in cell.per_layer][-2:] == list(NAMES)
    (m,) = [m for m in cell.per_layer if m["name"] == name]
    assert m["unit"] == unit and m["better"] == "lower" and m["workloads"] == [WORKLOAD]
    assert m["moves"] == "chip_frames_per_s" and m["layer"] == LAYER
    assert m["source"] == "program_counter"
    for other in ("tiles4to1_1080p.steady", "tiles16_4k.steady", "multiview16_4k.steady"):
        assert name not in [m["name"] for m in cellmod.load_cell(other).per_layer]


@pytest.mark.parametrize("name,counter", [("rgba_converts", "program.general.rgba_converts"),
                                          ("rgba_mip_levels", "program.general.mip_levels")])
def test_readers_on_synthetic_counters(name, counter, monkeypatch):
    from smelter_tpu_torch.utils import tracing

    reader = cellmod.load_cell(WORKLOAD).metric_reader(name)
    tracing.reset()
    try:
        tracing.count_each((("program.calls.general", 4), (counter, 256)))
        assert reader.read(_ctx()) == 64.0
        # the counter without a general call, and a general call without the
        # counter (the parent's program): nothing to read
        tracing.reset()
        tracing.count(counter, 16)
        assert reader.read(_ctx()) is None
        tracing.reset()
        tracing.count("program.calls.general", 3)
        assert reader.read(_ctx()) is None
        monkeypatch.delattr(tracing, "counters")
        assert reader.read(_ctx()) is None
    finally:
        tracing.reset()


def test_control_fails_on_the_cpu():
    import control

    limits = cellmod.load_cell(WORKLOAD).limits
    for seed in (SEED, SEED + 1, SEED + 2):
        reading = control.control_reading(WORKLOAD, seed, device="cpu", cfg_overrides=SMALL)
        assert not reading["correct"], reading
        assert reading["diff_ppm"] > limits["diff_ppm"] and reading["max_lsb"] > limits["max_lsb"]


@pytest.mark.parametrize("fault", ["_stale", "_half", "_altered", "_spot"])
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    """The faults of `test_bench_control.py` under the timed path of this
    cell, at its small size: each run is not correct."""
    import test_bench_control

    from smelter_tpu_torch.render.renderer import Renderer

    monkeypatch.setattr(Renderer, "render", getattr(test_bench_control, fault)(Renderer.render))
    result = run(WORKLOAD, SEED, 1.0, False, time.perf_counter(), device="cpu",
                 cfg_overrides=SMALL)[0]
    assert not result["correct"] and result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checked"].values())


def test_structure_keys_fit_the_program_cache():
    """Through `OutputProgram.plan` at the cell's own size (host work only,
    on CPU tensors): two cycles of the traffic make one structure key,
    which set-up captures before the window."""
    from smelter_tpu_torch.core.types import PixelFormat, Resolution
    from smelter_tpu_torch.render.program import OutputProgram
    from smelter_tpu_torch.render.renderer import Renderer

    cell = cellmod.load_cell(WORKLOAD)
    cfg, sched = cell.cfg, cell.schedule
    api = cellmod.program_api()
    frames = cellmod.frames_of(api, cfg, cellmod.make_inputs(cfg, 1, 0, "cpu")[0])
    assert {f.format for f in frames.values()} == {PixelFormat.NV12}
    r = Renderer(device="cpu")
    for iid in frames:
        r.register_input(iid)
    r.update_scene("out_0", cell.scene.build(api, cfg, 0, "out_0"),
                   Resolution(cfg["output_width"], cfg["output_height"]),
                   PixelFormat[cfg["output_format"]])
    res = {iid: f.resolution for iid, f in frames.items()}
    keys = set()
    for k in range(sched.cycle_start(2)):
        r.scene.register_render_event(sched.pts(k), res)
        keys.add(r._programs["out_0"].plan(sched.pts(k), frames)[0])
    assert len(keys) == 1 <= OutputProgram.MAX_CACHED_PROGRAMS


def test_the_configuration_names_its_sources():
    spec = json.loads((_paths.ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}["tiles16_4k_nv12"]
    cfg = json.loads((_paths.ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert len(entry["source"]) <= 200 and cfg["input_format"] == "NV12"
    assert {"tiles", "chroma_upsampling", "conversion", "resize", "blend",
            "rgb_to_yuv"} <= set(cfg["math"])
    # the I420 Tiles' keys and widths, the input format apart
    i420 = json.loads((_paths.ROOT / "benchmark" / "configs" / "tiles16_4k.json").read_text())
    for key in ("scene", "inputs", "input_width", "input_height", "outputs",
                "inputs_per_output", "output_width", "output_height", "output_format",
                "tile_aspect_ratio", "margin", "padding", "background_color", "precision"):
        assert cfg[key] == i420[key], key
    assert i420["input_format"] == "PLANAR_YUV420"
