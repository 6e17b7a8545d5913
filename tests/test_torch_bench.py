"""The port's benchmark entry point (`smelter_tpu_torch/bench.py`) and its
batched compose (`parallel/flagship.make_flagship_batched_compose`), on the
CPU at small sizes.

  - `bench.main` prints exactly one JSON line whose keys are those of the
    reference's `bench.py` result, without its `backend_fallback` (the port
    has no fallback) and with `card`; without a card and without
    `device="cpu"` it raises.
  - The batched compose, frame by frame, is bit-equal to the port's single
    compose and to the reference's `jax.vmap` of its grid function at the
    same size (0 u8 LSB: the grid's GEMMs see the same operands either way).
  - A Tiles scene that is not an opaque grid refuses to batch, naming its
    shape.
"""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from smelter_tpu.core.types import Resolution as JaxResolution
from smelter_tpu.parallel import flagship as jflag
from smelter_tpu_torch import bench
from smelter_tpu_torch.core.types import Resolution
from smelter_tpu_torch.parallel import flagship as tflag

torch.set_num_threads(2)

N, IN, OUT, B = 4, (192, 108), (384, 216), 3

# bench.py:282-322 of the reference, minus "backend_fallback", plus "card"
BENCH_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline", "device_latency_budget_ms",
    "dispatch_p50_ms", "dispatch_p95_ms", "amortized_ms_per_frame", "throughput_fps",
    "batched4_ms_per_frame", "batched4_throughput_fps", "ingest_ms_per_frame", "ingest_fps",
    "ingest_dispatch_p50_ms", "ingest_dispatch_p95_ms", "ingest_frame_mb", "host_link_MBps",
    "n_inputs", "device", "device_p50_ms", "device_p95_ms", "device_frames_profiled",
    "general_4k", "card",
}
GENERAL_KEYS = {"scene", "amortized_ms_per_frame", "device_p50_ms", "device_p95_ms", "replays"}


def _batch(n, w, h, batch, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(16, 235, (batch, n, h, w), np.uint8),
            rng.randint(16, 240, (batch, n, h // 2, w // 2), np.uint8),
            rng.randint(16, 240, (batch, n, h // 2, w // 2), np.uint8))


def test_main_prints_one_line_with_the_reference_keys(capsys):
    result = bench.main(device="cpu", n_inputs=N, in_res=Resolution(*IN),
                        out_res=Resolution(*OUT), iters=3, warmup=1)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == result
    assert set(printed) == BENCH_KEYS
    assert set(printed["general_4k"]) == GENERAL_KEYS
    assert printed["metric"] == "compose_fps_16x1080p_to_4k_1chip"
    assert printed["device"] == "cpu" and printed["card"] is None
    assert printed["n_inputs"] == N and printed["device_frames_profiled"] == 3
    assert printed["general_4k"]["replays"] == 7
    assert printed["ingest_frame_mb"] == round(N * IN[0] * IN[1] * 1.5 / 1e6, 1)
    assert printed["value"] == max(printed["throughput_fps"], printed["batched4_throughput_fps"])
    for key in BENCH_KEYS - {"metric", "unit", "baseline", "device", "card", "general_4k"}:
        assert np.isfinite(printed[key]) and printed[key] > 0, key


def test_main_needs_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here: the benchmark would run on it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench.main(n_inputs=1, in_res=Resolution(64, 32), out_res=Resolution(64, 32))


def test_batched_compose_equals_single_frames_and_the_reference_vmap():
    fn, _ = tflag.make_flagship_compose(N, Resolution(*IN), Resolution(*OUT), device="cpu")
    bfn, example = tflag.make_flagship_batched_compose(
        N, Resolution(*IN), Resolution(*OUT), batch=B, device="cpu")
    assert [tuple(p.shape) for p in example] == [
        (B, N, IN[1], IN[0]), (B, N, IN[1] // 2, IN[0] // 2), (B, N, IN[1] // 2, IN[0] // 2)]
    planes = _batch(N, *IN, B)
    got = [p.numpy() for p in bfn(*(torch.from_numpy(p) for p in planes))]
    assert [p.shape for p in got] == [(B, OUT[1], OUT[0]), (B, OUT[1] // 2, OUT[0] // 2),
                                      (B, OUT[1] // 2, OUT[0] // 2)]
    assert all(p.dtype == np.uint8 for p in got)
    for b in range(B):
        single = fn(*(torch.from_numpy(p[b]) for p in planes))
        for name, mine, one in zip("yuv", got, single):
            np.testing.assert_array_equal(mine[b], one.numpy(), err_msg=f"frame {b} {name}")
    jfn, _ = jflag.make_flagship_compose(N, JaxResolution(*IN), JaxResolution(*OUT))
    ref = [np.asarray(p) for p in jax.jit(jax.vmap(jfn))(*planes)]
    for name, r, mine in zip("yuv", ref, got):
        d = np.abs(r.astype(np.int32) - mine.astype(np.int32))
        assert int(d.max()) == 0, f"plane {name}: {int(d.max())} LSB, {(d > 0).sum()} pixels"


def test_batched_compose_refuses_the_general_fallback():
    with pytest.raises(ValueError, match="2 x 64x36 -> 198x108 is not an opaque grid"):
        tflag.make_flagship_batched_compose(2, Resolution(64, 36), Resolution(198, 108),
                                            device="cpu")
