"""The port's codec tools (`smelter_tpu_torch/tools/bench_offline.py`,
`bench_streams.py`, and `bench_overlap.py`'s codec stages), which need the
codec service (FFmpeg), on the CPU at small sizes against the reference's
`tools/` scripts (loaded by path):

  - each tool's source clip is byte-equal to the reference script's on the
    same arguments (the same frames through the same encoder and muxer);
  - `bench_streams`' constants and its doubling-then-bisecting search are
    the reference's;
  - an offline run (2 inputs of 1 s at 96x54 -> 192x108), one real-time
    trial (`--max 1`) and a pinned run complete, and each JSON line holds
    every key of the reference's line, plus "card" (null on the CPU).
"""

from __future__ import annotations

import json

import pytest
import torch

from smelter_tpu_torch.tools import bench_offline, bench_overlap, bench_streams
from tests.test_torch_tools import load_reference

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def reference():
    with pytest.MonkeyPatch.context() as mp:
        return {name: load_reference(name, mp) for name in ("bench_offline", "bench_streams")}


def test_offline_source_equals_the_reference(reference, tmp_path):
    reference["bench_offline"].make_source(str(tmp_path / "ref.mp4"), 96, 54, 30, 1.0, 1)
    bench_offline.make_source(str(tmp_path / "port.mp4"), 96, 54, 30, 1.0, 1)
    assert (tmp_path / "port.mp4").read_bytes() == (tmp_path / "ref.mp4").read_bytes()


def test_streams_source_equals_the_reference(reference, tmp_path):
    reference["bench_streams"].make_source(str(tmp_path / "ref.mp4"), 96, 54, 24, 1.0)
    bench_streams.make_source(str(tmp_path / "port.mp4"), 96, 54, 24, 1.0)
    assert (tmp_path / "port.mp4").read_bytes() == (tmp_path / "ref.mp4").read_bytes()


@pytest.mark.parametrize("outcomes", [
    [True, True, False, True, False],
    [False],
    [True, False, True, True, True, False],
])
def test_streams_search_is_the_reference_search(reference, outcomes):
    ref = reference["bench_streams"]
    assert bench_streams.SUCCESS_RATIO == ref.SUCCESS_RATIO == 0.93
    assert bench_streams.RESOLUTIONS == ref.RESOLUTIONS
    mine, theirs = bench_streams.MaximizeSearch(3), ref.MaximizeSearch(3)
    seq = [(mine.next(False), theirs.next(False))]
    for ok in outcomes:
        seq.append((mine.next(ok), theirs.next(ok)))
    assert all(a == b for a, b in seq), seq


def test_bench_offline_completes_with_the_reference_keys(capsys):
    res = bench_offline.main(["--device", "cpu", "--inputs", "2", "--seconds", "1",
                              "--in", "96x54", "--out", "192x108"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    # bench_offline.py:170-190
    assert set(res) == {"metric", "value", "unit", "media_s", "wall_s", "inputs", "in_res",
                        "out_res", "fps", "out_bytes", "source_gen_s", "spans", "card"}
    assert res["metric"] == "offline_x_realtime" and res["card"] is None
    assert res["value"] > 0 and res["out_bytes"] > 0 and res["inputs"] == 2
    assert res["spans"] and all(k.startswith(("codec.", "queue.", "render.", "audio."))
                                for k in res["spans"])


def test_bench_streams_trial_completes_with_the_reference_keys(capsys):
    res = bench_streams.main(["--device", "cpu", "--max", "1", "--duration", "1"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    # bench_streams.py:341-347
    assert set(res) == {"metric", "value", "unit", "outputs", "trials", "card"}
    assert res["metric"] == "max_realtime_streams_480pp24_ratio1_ultrafast"
    (trial,) = res["trials"]
    assert set(trial) == {"n_inputs", "success", "outputs", "expected"}
    assert trial["n_inputs"] == 1 and trial["expected"] == 24 and len(trial["outputs"]) == 1
    assert res["value"] == (1 if trial["success"] else 0) and res["card"] is None


def test_bench_streams_pinned_completes_with_the_reference_keys(capsys):
    res = bench_streams.main(["--device", "cpu", "--pinned", "--inputs", "1", "--frames", "10"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    # bench_streams.py:315-322 and 252-258
    assert set(res) == {"metric", "value", "unit", "frames", "cpu_s", "wall_s",
                        "cpu_ms_per_frame", "frames_per_cpu_s", "card"}
    assert res["metric"] == "pinned_cpu_ms_per_frame_480pp24_in1_ratio1_ultrafast"
    assert res["frames"] >= 10 and res["value"] == res["cpu_ms_per_frame"] > 0


def test_bench_overlap_with_codec_stages(capsys):
    res = bench_overlap.main(["--device", "cpu", "--width", "192", "--height", "108",
                              "--frames", "6"])
    assert json.loads(capsys.readouterr().out) == res
    assert res["codec_stages"] is True and res["serial_fps"] > 0 and res["pipelined_fps"] > 0
