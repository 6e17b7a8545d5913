"""The cell `multiview16_4k.steady` on the CPU, at a small size defined
here (16 inputs of 192x108 into 768x432, the style values as the
configuration gives them): a whole run, correct; the least bytes of a 4K
tick by hand; its two per-layer readers on a synthetic trace and counters,
and silent without them; the control failing; and the structure keys of
its traffic at the cell's own size fitting the program cache."""

import json
import time

import _paths
import pytest

from smelter_bench import cell as cellmod
from smelter_bench.harness import RunContext, run
from smelter_bench.trace import Digest

WORKLOAD = "multiview16_4k.steady"
SMALL = {"input_width": 192, "input_height": 108, "output_width": 768, "output_height": 432}
SEED = 2**31 + 2323
# tiles, groups a call of the general program blends at the small size
TILES, GROUPS_SMALL = 16, 16


@pytest.mark.parametrize("trace", [False, True])
def test_whole_run_on_the_cpu(trace):
    result, sampled = run(WORKLOAD, SEED, 1.0, trace, time.perf_counter(), device="cpu",
                          cfg_overrides=SMALL)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    checked = {k: v["value"] for k, v in result["checked"].items()}
    assert checked["max_lsb"] <= 1 and checked["diff_ppm"] < 100, checked
    # a loaded CPU may render fewer ticks in the window than a run samples
    assert 1 <= len(sampled) <= 6
    m = result["metrics"]
    if trace:
        # on the CPU no device activity is traced: the counter readers speak
        assert set(m) == {"captures_in_window", "static_load_mb", "output_clone_mb",
                          "blend_groups"}
        assert m["captures_in_window"]["value"] == 0.0
        assert m["blend_groups"] == {"value": float(GROUPS_SMALL), "unit": "groups"}
    else:
        assert set(m) == {"setup_s"}


def test_least_bytes_of_a_4k_tick():
    cell = cellmod.load_cell(WORKLOAD)
    api = cellmod.program_api()
    shown = cellmod.shown_inputs(cell.scene.build(api, cell.cfg, 0, "out_0"))
    assert shown == set(cellmod.input_ids(cell.cfg))
    # 16 inputs of 1920 x 1080 x 1.5 read once, one 3840 x 2160 x 1.5 frame written
    assert cellmod.least_bytes(cell.cfg, shown, 1) == 16 * 3_110_400 + 12_441_600 == 62_208_000


def test_readers_on_a_synthetic_trace_and_counters():
    from smelter_tpu_torch.utils import tracing

    cell = cellmod.load_cell(WORKLOAD)
    assert [m["name"] for m in cell.per_layer][-2:] == ["hopper_ms", "blend_groups"]
    d = Digest(frames=2, window_s=1.0, device=[
        ("void (anonymous namespace)::group_blend_kernel<0>(void*)", 0.000, 0.003),
        ("scene_assembly_kernel", 0.003, 0.004),
        ("yuv420_out_vec4_kernel", 0.004, 0.005),
        ("nvjet_tst_64x120_NNT", 0.005, 0.007),
    ])
    ctx = RunContext(cell=cell, spans={}, digest=d)
    tracing.reset()
    tracing.count_each((("program.calls.general", 4), ("program.general.groups", 64)))
    assert cell.metric_reader("hopper_ms").read(ctx) == pytest.approx(2.5)
    assert cell.metric_reader("blend_groups").read(ctx) == 16.0
    # no general call counted, no device activity: nothing to read
    tracing.reset()
    empty = RunContext(cell=cell, spans={}, digest=Digest(frames=2, window_s=1.0))
    assert cell.metric_reader("hopper_ms").read(empty) is None
    assert cell.metric_reader("blend_groups").read(empty) is None


def test_blend_groups_is_silent_before_the_counter(monkeypatch):
    """A program that counts its general calls but not its groups (the
    parent's), and one that counts nothing at all, read nothing."""
    from smelter_tpu_torch.utils import tracing

    cell = cellmod.load_cell(WORKLOAD)
    ctx = RunContext(cell=cell, spans={}, digest=Digest(frames=2, window_s=1.0))
    tracing.reset()
    tracing.count("program.calls.general", 3)
    assert cell.metric_reader("blend_groups").read(ctx) is None
    monkeypatch.delattr(tracing, "counters")
    assert cell.metric_reader("blend_groups").read(ctx) is None


def test_control_fails_on_the_cpu():
    import control

    for seed in (SEED, SEED + 1, SEED + 2):
        reading = control.control_reading(WORKLOAD, seed, device="cpu", cfg_overrides=SMALL)
        assert not reading["correct"], reading
        limits = cellmod.load_cell(WORKLOAD).limits
        assert reading["diff_ppm"] > limits["diff_ppm"] and reading["max_lsb"] > limits["max_lsb"]


def test_structure_keys_fit_the_program_cache():
    """Through `OutputProgram.plan` at the cell's own size (host work only,
    on CPU tensors): the opening and two cycles of the traffic make one
    structure key, which set-up captures before the window."""
    from smelter_tpu_torch.core.types import PixelFormat, Resolution
    from smelter_tpu_torch.render.program import OutputProgram
    from smelter_tpu_torch.render.renderer import Renderer

    cell = cellmod.load_cell(WORKLOAD)
    cfg, sched = cell.cfg, cell.schedule
    api = cellmod.program_api()
    frames = cellmod.frames_of(api, cfg, cellmod.make_inputs(cfg, 1, 0, "cpu")[0])
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
    entry = {c["name"]: c for c in spec["configs"]}["multiview16_4k"]
    cfg = json.loads((_paths.ROOT / entry["file"]).read_text())
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"] == []
    assert cfg["architecture"] is None and cfg["precision"] == "bfloat16"
    assert len(entry["source"]) <= 200 and len(cfg["style"]) == 2
    assert {"tiles", "rescaler", "rounding", "resize", "coverage", "border", "shadow",
            "paint_order", "blend", "rgb_to_yuv"} <= set(cfg["math"])


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
