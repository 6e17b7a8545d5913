"""The port's A/B tools (`smelter_tpu_torch/tools/bench_canvas_ab.py`,
`bench_assembly_ab.py`, `bench_align_ab.py`, run by `tools/_ab.py`), the
counterparts of the reference's `tools/bench_*_ab.py`, on the CPU at the
size of `tests/test_canvas_u16.py` (2 x 128x96 -> 512x160):

  - each tool's JSON line holds the reference line's keys, "device" naming
    the device, and each variant its frames;
  - each parity gate passes for its gated variant (<= 1 u8 LSB against the
    baseline, the reference's gate);
  - a variant whose output is moved by 2 LSB makes the tool print
    `{"error": "parity FAILED", ...}` and exit 1, before any timing;
  - without a card each tool raises unless given `--device cpu`
    (`tests/test_torch_import.py` imports them without JAX).
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from smelter_tpu_torch.ops import compose
from smelter_tpu_torch.tools import _ab, bench_align_ab, bench_assembly_ab, bench_canvas_ab

torch.set_num_threads(2)

SMALL = ["--device", "cpu", "--inputs", "2", "--inres", "128x96", "--out", "512x160",
         "--rounds", "1", "--iters", "2"]
TOOLS = {"bench_canvas_ab": bench_canvas_ab, "bench_assembly_ab": bench_assembly_ab,
         "bench_align_ab": bench_align_ab}
# the reference lines' keys (tools/bench_canvas_ab.py:149-163,
# bench_assembly_ab.py:123-137, bench_align_ab.py:101-114)
TOP_KEYS = {"metric", "device", "rounds", "iters_per_round", "parity", "variants"}
# the reference's align line has no gate and so no "parity"; the port's has
ALIGN_TOP_KEYS = {"metric", "device", "rounds", "iters_per_round", "variants"} | {"parity"}
VARIANT_KEYS = {"device_p50_ms", "device_p95_ms", "frames"}


def _run(main, argv, capsys):
    res = main(argv)
    assert json.loads(capsys.readouterr().out) == res
    return res


def test_bench_canvas_ab_line_has_the_reference_keys(capsys):
    res = _run(bench_canvas_ab.main, SMALL + ["--variants", "u16,f16,bf16,f32", "--gate", "u16"],
               capsys)
    assert set(res) == TOP_KEYS and res["metric"] == "general_4k_canvas_dtype_ab"
    assert res["device"] == "cpu" and res["rounds"] == 1 and res["iters_per_round"] == 2
    assert list(res["variants"]) == ["u16", "f16", "bf16", "f32"]
    for tag, v in res["variants"].items():
        assert set(v) == VARIANT_KEYS | {"env"} and v["frames"] == 2
        assert v["env"] == bench_canvas_ab.ALL_CONFIGS[tag] and v["device_p50_ms"] > 0
    assert set(res["parity"]) == {"u16", "f16", "bf16"}
    assert all(p["max"] <= 1 for p in res["parity"]["u16"].values())


def test_bench_assembly_ab_line_has_the_reference_keys(capsys):
    res = _run(bench_assembly_ab.main, SMALL, capsys)
    assert set(res) == TOP_KEYS and res["metric"] == "general_4k_assembly_ab"
    assert list(res["variants"]) == ["kernel", "groups"]
    assert res["variants"]["kernel"]["env"] == {"SMELTER_SCENE_ASSEMBLY": "on"}
    assert all(set(v) == VARIANT_KEYS | {"env"} and v["frames"] == 2
               for v in res["variants"].values())
    assert all(p["max"] <= 1 for p in res["parity"]["kernel"].values())


def test_bench_align_ab_line_has_the_reference_keys(capsys):
    orig = compose._align_union
    res = _run(bench_align_ab.main, SMALL, capsys)
    assert compose._align_union is orig
    assert set(res) == ALIGN_TOP_KEYS and res["metric"] == "general_4k_align_ab"
    assert [(t, v["aligned"]) for t, v in res["variants"].items()] == [
        ("aligned", True), ("unaligned", False)]
    assert all(set(v) == VARIANT_KEYS | {"aligned"} and v["frames"] == 2
               for v in res["variants"].values())
    # alignment is exact: the two variants agree pixel for pixel
    assert all(p["max"] == 0 for p in res["parity"]["unaligned"].values())


def test_unaligned_unions_are_exact_regions():
    """The unaligned variant's identity keeps each union as it is, with or
    without a sublane."""
    with bench_align_ab.unions(False):
        assert compose._align_union((3, 5, 7, 9), 100, 200) == (3, 5, 7, 9)
        assert compose._align_union((3, 5, 7, 9), 100, 200, 16) == (3, 5, 7, 9)
    assert compose._align_union((3, 5, 7, 9), 100, 200) == (0, 0, 16, 128)


# which variant is moved off by 2 LSB: the one built under this condition
OFF_BY_TWO = {
    "bench_canvas_ab": lambda: os.environ.get("SMELTER_CANVAS_DTYPE") == "uint16",
    "bench_assembly_ab": lambda: os.environ.get("SMELTER_SCENE_ASSEMBLY") == "on",
    "bench_align_ab": lambda: compose._align_union((3, 5, 7, 9), 100, 200) == (3, 5, 7, 9),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_a_variant_off_by_two_lsb_fails_the_gate(monkeypatch, capsys, tool):
    build = _ab.make_flagship_general_compose
    timed = []

    def builder(*args, **kw):
        fn, example = build(*args, **kw)
        if not OFF_BY_TWO[tool]():
            return fn, example

        def off(y, u, v):
            yy, uu, vv = fn(y, u, v)
            return torch.where(yy < 128, yy + 2, yy - 2), uu, vv

        return off, example

    monkeypatch.setattr(_ab, "make_flagship_general_compose", builder)
    monkeypatch.setattr(_ab, "FrameProfile", lambda device: timed.append(device))
    with pytest.raises(SystemExit) as exc:
        TOOLS[tool].main(SMALL)
    assert exc.value.code == 1 and not timed  # nothing was timed
    line = json.loads(capsys.readouterr().out)
    assert line["error"] == "parity FAILED"
    (tag,) = line["parity"]
    # the variant's own <= 1 LSB plus the 2 LSB it was moved by
    assert line["parity"][tag]["y"]["max"] in (2, 3)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_needs_a_card_unless_given_the_cpu(tool):
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here: the tool would run on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TOOLS[tool].main([])


def test_canvas_ab_needs_its_baseline():
    with pytest.raises(ValueError, match="baseline"):
        bench_canvas_ab.main(SMALL + ["--variants", "u16,f16"])


def test_env_restores_the_environment(monkeypatch):
    monkeypatch.setenv("SMELTER_CANVAS_DTYPE", "float16")
    monkeypatch.delenv("SMELTER_SCENE_ASSEMBLY", raising=False)
    with _ab.env({"SMELTER_CANVAS_DTYPE": "uint16", "SMELTER_SCENE_ASSEMBLY": "off"}):
        assert compose._canvas_dtype(True) == torch.uint16 and compose._assembly_mode() == "off"
    assert os.environ["SMELTER_CANVAS_DTYPE"] == "float16"
    assert "SMELTER_SCENE_ASSEMBLY" not in os.environ

