"""The harness on the CPU: cells, traffic and metrics found by name, the
result's line, the trace arithmetic, the least bytes, the tick schedule,
and the modules a run loads."""

import json
import subprocess
import sys
import time

import _paths
import pytest

from smelter_bench import cell as cellmod
from smelter_bench.trace import Digest, kind, merged

SPEC = json.loads((_paths.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cells_are_found_by_name(workload):
    c = cellmod.load_cell(workload)
    assert c.chips == 1
    assert c.scene.STAGES >= 1 and callable(c.scene.build) and callable(c.reference.render)
    assert {"pts_step", "in_flight", "ring", "opening", "cycle", "warm_cycles",
            "host_trace_ticks", "check_frames"} <= set(c.traffic)
    assert set(c.limits) == {"diff_ppm", "max_lsb"}
    assert len(c.outputs) == c.cfg["outputs"]
    # the outputs show every input once between them
    shown = [iid for o in c.outputs for iid in c.scene.output_inputs(c.cfg, o)]
    assert sorted(shown) == sorted(cellmod.input_ids(c.cfg))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "chip_frames_per_s"}
    for m in c.per_layer:
        assert callable(c.metric_reader(m["name"]).read)


def test_every_file_the_spec_names_is_under_paths():
    for entry in SPEC["configs"]:
        path = _paths.ROOT / entry["file"]
        assert path.is_file() and entry["file"].startswith(tuple(SPEC["paths"]))
        cfg = json.loads(path.read_text())
        assert (_paths.BENCH_DIR / "scenes" / f"{cfg['scene']}.py").is_file()
        assert (_paths.BENCH_DIR / "references" / f"{cfg['reference']}.py").is_file()
    for m in SPEC["per_layer"]:
        assert (_paths.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()


def test_unknown_workload_is_refused():
    with pytest.raises(ValueError, match="no workload"):
        cellmod.load_cell("no_such.cell")


def _run(workload, trace, **kw):
    from smelter_bench.harness import run

    return run(workload, 2**31 + 12345, 1.0, trace, time.perf_counter(), device="cpu",
               cfg_overrides=_paths.small(workload), **kw)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line(workload, trace):
    result, sampled = _run(workload, trace)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checked"
    c = cellmod.load_cell(workload)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0 and result["attempted"] % len(c.outputs) == 0
    # on the CPU the port's GEMMs sum in the reference's order
    assert {k: v["value"] for k, v in result["checked"].items()} == {"diff_ppm": 0.0,
                                                                     "max_lsb": 0}
    declared = {m["name"]: m["unit"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(result["metrics"]) <= set(declared)
    for name, m in result["metrics"].items():
        assert m["unit"] == declared[name] and isinstance(m["value"], float)
    if trace:
        assert "breakdown" in result and "window_s" in result["device"]
        # on the CPU no device activity is traced: the device readers stay silent
        assert set(result["metrics"]) == {"captures_in_window"}
        assert result["metrics"]["captures_in_window"]["value"] == 0.0
    else:
        # the card's rate comes from the trace of a card: setup_s alone here
        assert set(result["metrics"]) == {"setup_s"}
    json.dumps(result)
    assert len(sampled) == c.traffic["check_frames"]
    assert all(sorted(frames) == sorted(c.outputs) for frames in sampled.values())


def test_busy_idle_and_kernel_classes():
    d = Digest(frames=2, window_s=1.0, device=[
        ("void cutlass::Kernel2<cutlass_75_tensorop_s1688gemm_bf16_128x128_tn_align1>", 0.10, 0.20),
        ("void cublasLt::splitKreduce_kernel<32, 16>", 0.15, 0.25),
        ("void (anonymous namespace)::group_blend_kernel<0>(void*)", 0.40, 0.45),
        ("yuv420_out_vec4_kernel", 0.45, 0.50),
        ("void at::native::elementwise_kernel<128, 2>", 0.60, 0.70),
        ("Memcpy DtoH (Device -> Pinned)", 0.70, 0.80),
        ("Memset (Device)", 0.90, 0.95),
    ], host=[("render.frame", 0.0, 0.6), ("render.plan", 0.26, 0.39),
             ("bench.slot_wait", 0.8, 0.9)])
    assert merged([(3, 4), (0, 1), (0.5, 2), (4, 5)]) == [(0, 2), (3, 5)]
    assert d.busy_s() == pytest.approx(0.15 + 0.10 + 0.20 + 0.05)
    # the card's time but its copies into host memory
    assert d.busy_s(to_host=False) == pytest.approx(0.15 + 0.10 + 0.10 + 0.05)
    assert d.copies_to_host() == 1
    assert d.kind_s("gemm") == pytest.approx(0.20)
    assert d.kind_s("hopper") == pytest.approx(0.10)
    assert d.kind_s("torch") == pytest.approx(0.10)
    assert [kind(n) for n, _, _ in d.device[-2:]] == ["copy", "memset"]
    gaps = dict(d.idle_gaps())
    # 0.25-0.40 lies in render.plan (innermost), 0.50-0.60 in render.frame,
    # 0.80-0.90 in bench.slot_wait
    assert gaps == pytest.approx({"render.plan": 0.15, "render.frame": 0.10,
                                  "bench.slot_wait": 0.10})
    ops = d.device_ops()
    assert ops[0][1] == pytest.approx(0.10) and len(ops) == 7


def test_metric_readers_on_a_synthetic_trace():
    """Each per-layer reader on a hand-made window of 4 output frames, and a
    reader with nothing to read returns nothing (never 0 for a share)."""
    from smelter_bench.harness import RunContext

    d = Digest(frames=4, window_s=1.0, device=[
        ("nvjet_tst_128x272_coopA_NNT", 0.00, 0.02),
        ("void at::native::elementwise_kernel<128, 2>", 0.02, 0.03),
        ("Memcpy DtoH (Device -> Pinned)", 0.03, 0.05),
        ("Memset (Device)", 0.05, 0.06),
    ])
    c = cellmod.load_cell(WORKLOADS[0])
    ctx = RunContext(cell=c, spans={"render.capture": {"count": 2, "total_ms": 9.0}},
                     digest=d, least_bytes=335_000_000)
    read = {m["name"]: c.metric_reader(m["name"]).read(ctx) for m in c.per_layer}
    assert read["gemm_ms"] == pytest.approx(5.0)
    assert read["torch_ops_ms"] == pytest.approx(2.5)
    assert read["copy_ms"] == pytest.approx(7.5)
    # 335 MB at 3.35 TB/s = 0.1 ms of the 60 ms busy
    assert read["frame_roofline_share"] == pytest.approx(100 * 0.1 / 60)
    assert read["captures_in_window"] == 2.0
    empty = RunContext(cell=c, spans={}, digest=Digest(frames=4, window_s=1.0),
                       least_bytes=335_000_000)
    silent = {m["name"]: c.metric_reader(m["name"]).read(empty) for m in c.per_layer}
    assert silent == {"gemm_ms": None, "torch_ops_ms": None, "copy_ms": None,
                      "frame_roofline_share": None, "captures_in_window": 0.0}


def test_least_bytes_against_hand_counts():
    yuv1080, out4k = 1920 * 1080 * 3 // 2, 3840 * 2160 * 3 // 2
    assert (yuv1080, out4k) == (3_110_400, 12_441_600)
    api = cellmod.program_api()
    for config, n_out in (("tiles16_4k", 1), ("tiles4to1_1080p", 4)):
        cfg = json.loads((_paths.BENCH_DIR / "configs" / f"{config}.json").read_text())
        scene = cellmod.load_module(_paths.BENCH_DIR / "scenes" / f"{cfg['scene']}.py", "t_scene")
        shown = set().union(*(cellmod.shown_inputs(scene.build(api, cfg, 0, o))
                              for o in scene.output_ids(cfg)))
        assert shown == set(cellmod.input_ids(cfg)) and len(scene.output_ids(cfg)) == n_out
        # 16 inputs read once; one 4K frame written, or four 1080p frames
        assert cellmod.least_bytes(cfg, shown, n_out) == 16 * yuv1080 + out4k == 62_208_000
    rgba = {**cfg, "input_formats": {"input_2": "RGBA", "input_1": "NV12"}}
    assert cellmod.least_bytes(rgba, shown, 4) == 15 * yuv1080 + 1920 * 1080 * 4 + out4k


def test_schedule():
    s = cellmod.Schedule({"pts_step": 0.03125, "opening": [{"stage": 0, "ticks": 8}],
                          "cycle": [{"stage": 1, "ticks": 32}, {"stage": 0, "ticks": 32}]})
    assert [s.stage(k) for k in (0, 7, 8, 39, 40, 71, 72)] == [0, 0, 1, 1, 0, 0, 1]
    assert s.cycle_start(2) == 136
    assert s.pts(40) == 1.25


def test_inputs_are_the_seeds():
    import torch

    cfg = {**json.loads((_paths.BENCH_DIR / "configs" / "tiles16_4k.json").read_text()),
           "input_width": 96, "input_height": 54,
           "input_formats": {"input_1": "NV12", "input_2": "RGBA"}}
    a = cellmod.make_inputs(cfg, 2, 2**31 + 7, "cpu")
    b = cellmod.make_inputs(cfg, 2, 2**31 + 7, "cpu")
    c = cellmod.make_inputs(cfg, 2, 2**31 + 8, "cpu")
    # seeds that differ only above 32 bits draw other inputs too
    d = cellmod.make_inputs(cfg, 2, 2**31 + 7 + 2**32, "cpu")
    fmt, rgba = a[0]["input_2"]
    assert fmt == "RGBA" and rgba.shape == (54, 96, 4) and bool((rgba[..., 3] == 255).all())
    assert a[1]["input_1"][0] == "NV12" and a[1]["input_1"][1][1].shape == (27, 48, 2)
    assert a[1]["input_5"][0] == "PLANAR_YUV420" and a[1]["input_5"][1][2].shape == (27, 48)
    assert torch.equal(a[1]["input_5"][1][0], b[1]["input_5"][1][0])
    assert not torch.equal(a[1]["input_5"][1][0], c[1]["input_5"][1][0])
    assert not torch.equal(a[1]["input_5"][1][0], d[1]["input_5"][1][0])


def test_no_forbidden_module_is_loaded():
    """After the harness, the port's modules that a run loads, every cell
    and its plain reference are imported, no top-level module is JAX or the
    JAX package (compared by whole top-level name: the port's name begins
    with it)."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import smelter_bench.harness, smelter_bench.reference, smelter_bench.trace\n"
        "import smelter_tpu_torch.render.renderer, smelter_tpu_torch.pipeline.output\n"
        "import smelter_tpu_torch.ops.hopper.group_blend, smelter_tpu_torch.ops.hopper.row_shear\n"
        "import smelter_tpu_torch.ops.hopper.yuv_out, smelter_tpu_torch.ops.hopper.sdf_layers\n"
        "from smelter_bench.cell import load_cell\n"
        "cells = [load_cell(w) for w in %r]\n"
        "from smelter_bench.harness import forbidden_modules\n"
        "print(forbidden_modules(), 'smelter_tpu_torch' in sys.modules)\n"
        % (str(_paths.BENCH_DIR), str(_paths.ROOT), WORKLOADS))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


def test_the_reference_imports_nothing_of_the_program():
    """The plain references and the comparison run with neither the port
    nor JAX loaded."""
    code = (
        "import sys; sys.path[:0] = [%r]\n"
        "import importlib.util, pathlib\n"
        "for p in sorted(pathlib.Path(%r).glob('*.py')):\n"
        "    spec = importlib.util.spec_from_file_location('r_' + p.stem, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import smelter_bench.reference\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('smelter_tpu')"
        " or m.split('.')[0] in ('jax', 'jaxlib')))\n"
        % (str(_paths.BENCH_DIR), str(_paths.BENCH_DIR / "references")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]"]
