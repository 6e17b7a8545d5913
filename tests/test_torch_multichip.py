"""The port's multi-device steps (`smelter_tpu_torch/parallel/flagship.py`,
`parallel/mesh.py`, `graft_entry.py`) on the CPU: 8 gloo ranks, spawned
once for the module (`graft_entry.run_cases`), run every case and write
their global planes under `tmp_path`; this process holds them to the
reference's steps on JAX's 8 virtual CPU devices (the root `conftest.py`)
and to the port on one device, at the reference's test sizes.

Tolerances: <= 1 u8 LSB against the port on one device (and against a 1 x 1
port mesh). Against the reference, the flagship test's allowance: <= 1 LSB,
except pixels 2 LSB off through a bf16 tie between the resize axes
(`tests/test_torch_flagship.py`), under 0.01% of each plane.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from smelter_tpu.core.types import Resolution
from smelter_tpu.parallel import flagship as jflag
from smelter_tpu_torch import graft_entry, interop
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.parallel import flagship as tflag
from smelter_tpu_torch.parallel import mesh as meshes

torch.set_num_threads(2)

GRID_RES = (Resolution(192, 108), Resolution(384, 216))
GENERAL_RES = (Resolution(128, 72), Resolution(256, 144))
N_OUTPUTS = 16


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The global planes of every case, by case: 8 ranks on a 2 x 4 mesh
    (and on an 8-rank "outputs" mesh), and the general step on a 1 x 1
    mesh; with each rank's report."""
    tmp = tmp_path_factory.mktemp("multichip")
    ranks = meshes.launch(graft_entry.run_cases, 8,
                          ("cpu", 2, (16, 8), N_OUTPUTS, tmp / "mesh"))
    meshes.launch(graft_entry.run_cases, 1, ("cpu", 1, (), 0, tmp / "single"))
    planes = {p.stem: dict(np.load(p)) for p in (tmp / "mesh").glob("*.npz")}
    planes["general_1x1"] = dict(np.load(tmp / "single" / "general.npz"))
    return planes, ranks


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    assert len(devs) >= 8, "the root conftest.py gives JAX 8 virtual CPU devices"
    return devs[:8]


def _yuv(d):
    return [d["y"], d["u"], d["v"]]


def _within_1(ref, got, what):
    for name, a, b in zip("yuv", ref, got):
        assert a.shape == b.shape and b.dtype == np.uint8, (what, name)
        assert int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max()) <= 1, (what, name)


def _within_tie_allowance(ref, got, what):
    for name, a, b in zip("yuv", ref, got):
        assert a.shape == b.shape and b.dtype == np.uint8, (what, name)
        d = np.abs(a.astype(np.int32) - b.astype(np.int32))
        assert d.max() <= 2, (what, name)
        assert (d > 1).sum() * 10000 < d.size, (what, name)


def _jax_mesh(devices, shape, names):
    return jax.sharding.Mesh(np.asarray(devices).reshape(shape), names)


@pytest.mark.parametrize("n", [16, 8])
def test_grid_step_matches_reference_and_one_device(port, devices, n):
    """N=16 tiles partition the canvas (concatenation); N=8 leaves gaps
    (background fill and region writes)."""
    planes, ranks = port
    got = _yuv(planes[f"grid_{n}"])
    assert got[0].shape == (216, 384) and float(got[0].std()) > 10.0
    inputs = graft_entry.case_inputs(n, from_reference(GRID_RES[0]), graft_entry.SEEDS["grid"])
    step, _ = jflag.make_multichip_step(_jax_mesh(devices, (2, 4), ("streams", "space")),
                                        n_inputs=n, in_res=GRID_RES[0], out_res=GRID_RES[1])
    _within_tie_allowance([np.asarray(p) for p in step(*inputs)], got, "reference")
    fn, _ = tflag.make_flagship_compose(n, *from_reference(GRID_RES), device="cpu")
    single = interop.planes_to_host(fn(*interop.planes_to_device(inputs, "cpu")))
    _within_1(single, got, "one device")
    assert ranks[0]["errors"][f"grid_{n}"] <= 1
    # rank (s, p) holds row band p: 216 / 4 luma rows
    assert all(r["shards"][f"grid_{n}"] == [(54, 384), (27, 192), (27, 192)] for r in ranks)


def test_general_step_matches_reference_and_a_1x1_mesh(port, devices):
    planes, ranks = port
    got = _yuv(planes["general"])
    assert got[0].shape == (144, 256) and float(got[0].std()) > 10.0
    _within_1(_yuv(planes["general_1x1"]), got, "1x1 mesh")
    inputs = graft_entry.case_inputs(8, from_reference(GENERAL_RES[0]),
                                     graft_entry.SEEDS["general"])
    step, _ = jflag.make_multichip_general_step(
        _jax_mesh(devices, (2, 4), ("streams", "space")), n_inputs=8,
        in_res=GENERAL_RES[0], out_res=GENERAL_RES[1])
    _within_1([np.asarray(p) for p in step(*inputs)], got, "reference")
    assert all(r["shards"]["general"] == [(36, 256), (18, 128), (18, 128)] for r in ranks)


def test_multioutput_step(port, devices):
    planes, ranks = port
    out = planes["multioutput"]
    assert out["y"].shape == (N_OUTPUTS, 216, 384)
    assert out["u"].shape == (N_OUTPUTS, 108, 192)
    assert all(r["shards"]["multioutput"] == [(2, 216, 384), (2, 108, 192), (2, 108, 192)]
               for r in ranks)
    _, (_, _, _, ref_perms) = jflag.make_multioutput_step(
        _jax_mesh(devices, (8,), ("outputs",)), n_outputs=N_OUTPUTS, n_inputs=16,
        in_res=GRID_RES[0], out_res=GRID_RES[1])
    perms = out["perms"]
    assert np.array_equal(perms, np.asarray(ref_perms))
    y, u, v = graft_entry.case_inputs(16, from_reference(GRID_RES[0]),
                                      graft_entry.SEEDS["multioutput"])
    fn, _ = tflag.make_flagship_compose(16, *from_reference(GRID_RES), device="cpu")
    single = fn(*(torch.from_numpy(p[perms[3]]) for p in (y, u, v)))
    for name, plane in zip("yuv", single):
        assert torch.equal(plane, torch.from_numpy(out[name][3])), name
    a, b = next((a, b) for a in range(N_OUTPUTS) for b in range(a + 1, N_OUTPUTS)
                if not np.array_equal(perms[a], perms[b]))
    assert not np.array_equal(out["y"][a], out["y"][b])


@pytest.mark.parametrize("bands", [1, 2, 4, 6])
def test_a_band_of_rows_converts_as_the_whole_canvas(bands):
    """`rows` of the general compose converts a band's rows as the whole
    canvas's conversion does, bit for bit (even bands: 2x2 chroma blocks
    never straddle two ranks)."""
    out_res = from_reference(GENERAL_RES[1])
    flat = tflag._scene_layouts(tflag._multichip_general_scene(8, out_res), 8,
                                from_reference(GENERAL_RES[0]), out_res)
    stages = tflag._general_stages(flat, 8, out_res, "cpu")
    canvas = torch.rand((4, out_res.height, out_res.width),
                        generator=torch.Generator().manual_seed(bands)) * 1.2 - 0.1
    whole = stages.rows(canvas, 0, out_res.height)
    step = out_res.height // bands
    for r0 in range(0, out_res.height, step):
        band = stages.rows(canvas, r0, r0 + step)
        for name, a, b in zip("yuv", band, (whole[0][r0:r0 + step],
                                            whole[1][r0 // 2:(r0 + step) // 2],
                                            whole[2][r0 // 2:(r0 + step) // 2])):
            assert torch.equal(a, b), (name, r0)


def test_ranks_load_no_jax(port):
    _, ranks = port
    assert [r["foreign_modules"] for r in ranks] == [[]] * 8


def test_dryrun_multichip_prints_ok(capsys):
    summary = graft_entry.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip OK: mesh=(2x4) streams x space, 16 inputs")
    assert summary["grid_lsb"] <= 1 and summary["general_lsb"] <= 1
    assert summary["multioutput_shape"] == (16, 216, 384)
    assert summary["backend"] == "gloo" and summary["foreign_modules"] == []


def test_dryrun_mesh_shape_is_the_references():
    # the largest divisor up to the square root as "streams"
    assert [graft_entry.mesh_shape(n) for n in (1, 2, 4, 6, 8, 9, 12)] == [
        (1, 1), (1, 2), (2, 2), (2, 3), (2, 4), (3, 3), (3, 4)]


class _Mesh:
    """The parts of a DeviceMesh the steps read before their first
    collective: its shape, axis names, device type and this rank's
    coordinates."""

    def __init__(self, shape, names, coords=None):
        self.shape, self.mesh_dim_names, self.device_type = shape, names, "cpu"
        self._coords = coords or (0,) * len(shape)

    def get_local_rank(self, axis):
        return self._coords[self.mesh_dim_names.index(axis)]

    def get_group(self, axis):
        return None


@pytest.mark.parametrize("n,stage", [(16, "compose"), (7, "compose"), (16, "per_stream")])
def test_every_grid_tile_resize_runs_inside_grid_resize(monkeypatch, n, stage):
    """The flagship grid on one device (16 tiles that partition the canvas, 7
    that leave gaps) and the grid step's per-stream stage (rank 1 of 2 over
    "streams") resize every tile plane inside one `GridResize` call: each
    body of a static resize (`resample._resize_matmul`, which
    `resize_matmul` calls however it was imported) runs inside
    `GridResize.__call__`, three a tile."""
    from smelter_tpu_torch.ops import resample
    from smelter_tpu_torch.ops.hopper.grid_resize import GridResize

    inside, calls, resizes = [False], [], []
    call, body = GridResize.__call__, resample._resize_matmul

    def spy_call(self, sources, device):
        inside[0] = True
        calls.append(len(sources))
        try:
            return call(self, sources, device)
        finally:
            inside[0] = False

    def spy_body(*args):
        resizes.append(inside[0])
        return body(*args)

    monkeypatch.setattr(GridResize, "__call__", spy_call)
    monkeypatch.setattr(resample, "_resize_matmul", spy_body)
    in_res, out_res = from_reference(GRID_RES)
    y, u, v = graft_entry.case_inputs(n, in_res, graft_entry.SEEDS["grid"])
    if stage == "compose":
        fn, _ = tflag.make_flagship_compose(n, in_res, out_res, device="cpu")
        calls.clear()  # make_flagship_compose's warm-up call
        resizes.clear()
        out = fn(*(torch.from_numpy(p) for p in (y, u, v)))
        tiles = n
    else:
        step, _ = tflag.make_multichip_step(_Mesh((2, 1), ("streams", "space"), coords=(1, 0)),
                                            n_inputs=n, in_res=in_res, out_res=out_res,
                                            device="cpu")
        out = step.local(y, u, v)
        tiles = n // 2
        assert [tuple(t.shape) for t in out] == [(tiles, 54, 96), (tiles, 27, 48),
                                                 (tiles, 27, 48)]
    assert calls == [tiles]
    assert len(resizes) == 3 * tiles and all(resizes)


def test_indivisible_shapes_raise():
    two_d = _Mesh((3, 2), ("streams", "space"))
    with pytest.raises(ValueError, match="'streams' of size 3"):
        tflag.make_multichip_step(two_d, n_inputs=16, device="cpu")
    with pytest.raises(ValueError, match="'streams' of size 3"):
        tflag.make_multichip_general_step(two_d, n_inputs=8, device="cpu")
    with pytest.raises(ValueError, match="'outputs' of size 3"):
        tflag.make_multioutput_step(_Mesh((3,), ("outputs",)), n_outputs=8, device="cpu")
    # 212 luma rows in 4 bands of 53: a band of odd height would start its
    # chroma mid-row
    with pytest.raises(ValueError, match="'space' of size 4"):
        tflag.make_multichip_step(_Mesh((2, 4), ("streams", "space")), n_inputs=16,
                                  out_res=from_reference(Resolution(384, 212)), device="cpu")
    with pytest.raises(ValueError, match="cpu mesh cannot hold"):
        tflag.make_multichip_step(two_d, n_inputs=12, device="meta")
    mesh = _Mesh((2, 4), ("streams", "space"), coords=(1, 3))
    assert meshes.shard_range(16, mesh, "streams") == (8, 16)
    assert meshes.row_band(216, mesh, "space") == (162, 216)


def test_a_failing_rank_fails_the_launch_within_its_deadline(tmp_path):
    """Rank 0 cannot write its planes (the output directory is a file) while
    rank 1 goes on into the general step's collectives and waits for it:
    the launcher raises with rank 0's traceback and leaves no rank behind."""
    blocked = tmp_path / "a_file"
    blocked.write_text("")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed") as err:
        meshes.launch(graft_entry.run_cases, 2, ("cpu", 2, (16,), 0, blocked), deadline_s=60)
    assert "FileExistsError" in str(err.value)
    assert time.monotonic() - t0 < 45  # well inside the group's 60 s timeout


def test_a_launch_past_its_deadline_raises(tmp_path):
    with pytest.raises(TimeoutError, match="did not finish within 0.5 s"):
        meshes.launch(graft_entry.run_cases, 2, ("cpu", 2, (16,), 0, tmp_path), deadline_s=0.5)


@pytest.mark.parametrize("run", [
    lambda: graft_entry.dryrun_multichip(2),
    # the command line, too, asks for the cards unless given --device cpu
    lambda: graft_entry.main(["-n", "2"]),
], ids=["dryrun_multichip", "command_line"])
def test_cuda_dryrun_needs_the_cards(run):
    if torch.cuda.device_count() >= 2:
        pytest.skip("torch sees two CUDA cards here: the dryrun would run on them")
    with pytest.raises(RuntimeError, match="2 CUDA ranks need 2 cards"):
        run()
