"""The plain reference (`references/tiles.py`) on its own, against hand
counts, and against the port on the CPU at a small size; and the structure
keys of each cell's traffic at the cell's own size."""

import json

import _paths
import numpy as np
import pytest
import torch

from smelter_bench import cell as cellmod
from smelter_bench.reference import compare, judge, reference_frames

WORKLOADS = [w["name"] for w in json.loads((_paths.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def tiles():
    return cellmod.load_module(_paths.BENCH_DIR / "references" / "tiles.py", "test_ref_tiles")


@pytest.mark.parametrize("n,size,rects", [
    (4, (1920, 1080), [(0, 0, 540, 960), (0, 960, 540, 960), (540, 0, 540, 960),
                       (540, 960, 540, 960)]),
    (1, (1920, 1080), [(0, 0, 1080, 1920)]),
    # 2 rows of 3 and 3 rows of 2 give 640-wide tiles alike: the fewer rows
    # win; the short last row is centred
    (5, (1920, 1080), [(180, 0, 360, 640), (180, 640, 360, 640), (180, 1280, 360, 640),
                       (540, 320, 360, 640), (540, 960, 360, 640)]),
])
def test_tile_rects_by_hand(n, size, rects):
    assert tiles().tile_rects(n, *size, (16, 9), 0.0, 0.0) == rects


def test_tile_rects_of_16_with_margin():
    got = tiles().tile_rects(16, 3840, 2160, (16, 9), 24.0, 0.0)
    # 4 x 4; the height is the narrower side: (2160 - 5 x 24) / 4 = 510, so
    # the width is 906.67, centred in the 3840 - 5 x 24 left
    assert len(got) == 16 and {(h, w) for _, _, h, w in got} == {(510, 907)}
    assert got[0][:2] == (24, 71) and got[1][:2] == (24, 1001) and got[4][:2] == (558, 71)


def test_lanczos_matrix():
    ref = tiles()
    m = ref.lanczos3_matrix(1080, 540)
    assert m.shape == (540, 1080) and np.allclose(m.sum(axis=1), 1.0, atol=1e-6)
    # 2:1: an interior row is the filter widened to 12 taps, symmetric
    # about the output's texel centre (input 2o + 0.5)
    row = m[100]
    nz = np.flatnonzero(row)
    assert list(nz) == list(range(195, 207))
    assert np.allclose(row[195:201], row[206:200:-1])
    # one to one: the identity (sinc vanishes at every other integer)
    assert np.allclose(ref.lanczos3_matrix(54, 54), np.eye(54), atol=1e-7)
    # taps beyond the edge are clamped onto it
    assert m[0, 0] > m[0, 1]


def test_bt709_black_and_white():
    ref = tiles()
    assert ref.bt709_limited((0, 0, 0, 255)) == (16, 128, 128)
    assert ref.bt709_limited((255, 255, 255, 255)) == (235, 128, 128)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_matches_the_port(workload):
    """The port's frames and the reference's, at a small size on the CPU,
    are equal sample for sample: the CPU's GEMMs sum in the order of the
    reference's."""
    from smelter_tpu_torch.core.types import FrameSet, PixelFormat, Resolution
    from smelter_tpu_torch.render.renderer import Renderer

    cell = cellmod.load_cell(workload, cfg_overrides=_paths.small(workload))
    cfg = cell.cfg
    ring = cellmod.make_inputs(cfg, 2, 2**31 + 99, "cpu")
    api = cellmod.program_api()
    r = Renderer(device="cpu")
    for iid in cellmod.input_ids(cfg):
        r.register_input(iid)
    for o in cell.outputs:
        r.update_scene(o, cell.scene.build(api, cfg, 0, o),
                       Resolution(cfg["output_width"], cfg["output_height"]),
                       PixelFormat[cfg["output_format"]])
    got = {}
    for k in range(2):
        frames = r.render(FrameSet(pts=k / 32, frames=cellmod.frames_of(api, cfg, ring[k])))
        for o in cell.outputs:
            got[(k, o)] = tuple(p.numpy() for p in frames.frames[o].data)
    ref = reference_frames(cell, ring, range(2), "cpu", cfg["precision"])
    assert sorted(ref) == sorted(got)
    for key in got:
        assert compare(got[key], ref[key])[::2] == (0, 0), key
    # the frames follow the inputs: another tick is another frame
    o = cell.outputs[0]
    assert compare(got[(0, o)], ref[(1, o)])[0] > 0


def test_compare_counts_samples():
    a = (torch.zeros(4, 4, dtype=torch.uint8).numpy(), torch.zeros(2, 2, dtype=torch.uint8).numpy())
    b = (a[0].copy(), a[1].copy())
    b[0][1, 1], b[1][0, 0] = 3, 255
    assert compare(a, b) == (2, 20, 255)
    with pytest.raises(ValueError):
        compare(a, (a[1], a[0]))


def test_judge_holds_each_number_to_its_limit():
    z = np.zeros((100, 100), np.uint8)
    few = z.copy()
    few[0, :3] = 9          # 300 ppm, 9 steps: a small region gone wrong
    many = z.copy()
    many[:, :] = 1          # every sample, 1 step
    limits = {"diff_ppm": 1000, "max_lsb": 2}
    got = {(0, "a"): (z,), (0, "b"): (few,), (1, "a"): (many,)}
    ref = {key: (z,) for key in got}
    v = judge(got, ref, limits)
    assert v["rejected"] == [(0, "b"), (1, "a")]
    assert (v["diff_ppm"], v["max_lsb"]) == (1e6, 9)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_structure_keys_fit_the_program_cache(workload):
    """Through `OutputProgram.plan` at the cell's own size (host work only,
    on CPU tensors): the keys of the opening and two cycles, which set-up
    captures before the window, are no more than the program cache holds."""
    from smelter_tpu_torch.core.types import PixelFormat, Resolution
    from smelter_tpu_torch.render.program import OutputProgram
    from smelter_tpu_torch.render.renderer import Renderer

    cell = cellmod.load_cell(workload)
    cfg, sched = cell.cfg, cell.schedule
    api = cellmod.program_api()
    frames = cellmod.frames_of(api, cfg, cellmod.make_inputs(cfg, 1, 0, "cpu")[0])
    r = Renderer(device="cpu")
    for iid in frames:
        r.register_input(iid)
    res = {iid: f.resolution for iid, f in frames.items()}
    keys = {o: set() for o in cell.outputs}
    stage = None
    for k in range(sched.cycle_start(2)):
        if sched.stage(k) != stage:
            stage = sched.stage(k)
            for o in cell.outputs:
                r.update_scene(o, cell.scene.build(api, cfg, stage, o),
                               Resolution(cfg["output_width"], cfg["output_height"]),
                               PixelFormat[cfg["output_format"]])
        r.scene.register_render_event(sched.pts(k), res)
        for o in cell.outputs:
            keys[o].add(r._programs[o].plan(sched.pts(k), frames)[0])
    assert all(1 <= len(v) <= OutputProgram.MAX_CACHED_PROGRAMS for v in keys.values())
