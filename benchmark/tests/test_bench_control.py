"""The comparison that decides `correct` has to fail: the control (the
plain reference computed in the precision below the one the configuration
states) and runs with the timed path broken underneath."""

import json
import time

import _paths
import pytest

from smelter_bench.harness import run

WORKLOADS = [w["name"] for w in json.loads((_paths.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 4242


def _small_run(workload):
    return run(workload, SEED, 1.0, False, time.perf_counter(), device="cpu",
               cfg_overrides=_paths.small(workload))[0]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_cpu(workload):
    import control

    for seed in (SEED, SEED + 1, SEED + 2):
        reading = control.control_reading(workload, seed, device="cpu",
                                          cfg_overrides=_paths.small(workload))
        assert not reading["correct"], reading


def _stale(orig):
    """A step that returns its state unchanged: each call answers with the
    frames of the call before it."""
    outputs = []

    def render(self, frame_set):
        outputs.append(orig(self, frame_set))
        return outputs.pop(0) if len(outputs) > 1 else outputs[0]

    return render


def _half(orig):
    """Half of the batch left out: every other input's frame never reaches
    the renderer (the renderer shows its last frame while it may)."""
    def render(self, frame_set):
        keep = sorted(frame_set.frames)[::2]
        frame_set.frames = {k: frame_set.frames[k] for k in keep}
        return orig(self, frame_set)

    return render


def _altered(orig):
    """An answer altered where it is produced: a sixteenth of each output's
    luma flipped in its lowest bit."""
    def render(self, frame_set):
        out = orig(self, frame_set)
        for frame in out.frames.values():
            y = frame.data[0]
            y[: y.shape[0] // 4, : y.shape[1] // 4] ^= 1
        return out

    return render


def _spot(orig):
    """A small region rendered wrong: a 4 x 4 block of one output's luma
    inverted, a few ppm of the samples."""
    def render(self, frame_set):
        out = orig(self, frame_set)
        y = next(iter(out.frames.values())).data[0]
        y[8:12, 8:12] = 255 - y[8:12, 8:12]
        return out

    return render


@pytest.mark.parametrize("fault", [_stale, _half, _altered, _spot])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    from smelter_tpu_torch.render.renderer import Renderer

    monkeypatch.setattr(Renderer, "render", fault(Renderer.render))
    result = _small_run(workload)
    assert not result["correct"] and result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checked"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_on_the_card(workload):
    """At the cell's own size, on three seeds a side (about a minute on an
    H100): the program reads within the limits, the control above one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("reads the card; torch sees none")
    import control

    for seed, result in control.program_readings(workload, [SEED + i for i in range(3)], 1.0):
        assert result["correct"], (seed, result["checked"])
        assert all(c["value"] <= c["limit"] for c in result["checked"].values())
    for seed in (SEED + 10, SEED + 11, SEED + 12):
        assert not control.control_reading(workload, seed)["correct"], seed
