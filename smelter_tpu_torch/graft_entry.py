"""Entry points of the port, the counterparts of the repository root's
`__graft_entry__.py`:

  - `entry()`: (fn, example_args) of the flagship grid, 16 x 1080p YUV420
    -> one 4K YUV420 frame, on the card unless told otherwise;
  - `dryrun_multichip(n)`: spawns n ranks (one process per device, over
    `torch.distributed`), builds the reference's ("streams", "space") mesh
    and runs the multi-device steps at small sizes, each held to one
    device: the grid step to the single-device grid, the general step to a
    1 x 1 mesh of itself, and the outputs-sharded step.

    python -m smelter_tpu_torch.graft_entry [-n N]  # N cards over NCCL (8)
    python -m smelter_tpu_torch.graft_entry --device cpu  # 8 gloo processes

The ranks' work (`run_cases`) lives here, not in a test, because a spawned
process imports the module of its target.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
import tempfile
import time

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from smelter_tpu_torch.core.types import Resolution
from smelter_tpu_torch.parallel import mesh as meshes
from smelter_tpu_torch.parallel.flagship import (
    make_flagship_compose,
    make_multichip_general_step,
    make_multichip_step,
    make_multioutput_step,
)

# the reference dryrun's sizes: the grid (and the outputs-sharded step) and
# the general step, with the general step's 8 inputs
GRID_RES = (Resolution(192, 108), Resolution(384, 216))
GENERAL_RES = (Resolution(128, 72), Resolution(256, 144))
GENERAL_INPUTS = 8
SEEDS = {"grid": 0, "general": 7, "multioutput": 3}


def entry(device=None):
    """(fn, example_args) of the flagship grid, 16 x 1920x1080 -> 3840x2160,
    on `device` (the card if None)."""
    return make_flagship_compose(
        n_inputs=16, in_res=Resolution(1920, 1080), out_res=Resolution(3840, 2160),
        device=device)


def mesh_shape(n_devices: int):
    """(streams, space) of n devices, as the reference's dryrun: the largest
    divisor of n up to its square root as "streams"."""
    streams = next(d for d in range(int(math.sqrt(n_devices)), 0, -1) if n_devices % d == 0)
    return streams, n_devices // streams


def case_inputs(n: int, res: Resolution, seed: int):
    """Seeded u8 YUV420 planes of n inputs: (n, H, W), (n, H/2, W/2) x 2."""
    rng = np.random.RandomState(seed)
    return (rng.randint(16, 235, (n, res.height, res.width), np.uint8),
            rng.randint(16, 240, (n, res.height // 2, res.width // 2), np.uint8),
            rng.randint(16, 240, (n, res.height // 2, res.width // 2), np.uint8))


def _max_lsb(a, b) -> int:
    return max(int(np.abs(x.astype(np.int32) - y.astype(np.int32)).max()) for x, y in zip(a, b))


def _host(planes):
    return [p.cpu().numpy() for p in planes]


def run_cases(rank: int, world_size: int, device_type: str, streams: int,
              grid_inputs, n_outputs: int, out_dir) -> dict:
    """One rank of a dryrun (`meshes.launch` target): on a (streams,
    world_size / streams) ("streams", "space") mesh, the grid step for each
    count of `grid_inputs` and the general step, then, if `n_outputs`, the
    outputs-sharded step with `n_outputs` outputs of 16 inputs on a
    ("outputs",) mesh of every rank. Rank 0 writes each case's global planes
    to `out_dir`/<case>.npz and holds each grid step to the single-device
    grid. Returns what the rank saw: its shards' shapes, the grid's errors
    on rank 0, and any module of JAX or of the reference it loaded."""
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    grid = init_device_mesh(device_type, (streams, world_size // streams),
                            mesh_dim_names=("streams", "space"))
    seen: dict = {"shards": {}, "errors": {}}
    out_dir = pathlib.Path(out_dir)

    def keep(case, step_planes, axis, mesh, **extra):
        seen["shards"][case] = [tuple(p.shape) for p in step_planes]
        planes = _host(meshes.gather_planes(step_planes, mesh, axis))
        if rank == 0:
            out_dir.mkdir(parents=True, exist_ok=True)
            np.savez(out_dir / f"{case}.npz", y=planes[0], u=planes[1], v=planes[2], **extra)
        return planes

    for n in grid_inputs:
        step, _ = make_multichip_step(grid, n, *GRID_RES, device=device)
        inputs = case_inputs(n, GRID_RES[0], SEEDS["grid"])
        planes = keep(f"grid_{n}", step(*inputs), "space", grid)
        if rank == 0:
            fn, _ = make_flagship_compose(n, *GRID_RES, device=device)
            single = _host(fn(*(torch.from_numpy(p).to(device) for p in inputs)))
            seen["errors"][f"grid_{n}"] = _max_lsb(planes, single)
    step, _ = make_multichip_general_step(grid, GENERAL_INPUTS, *GENERAL_RES, device=device)
    keep("general", step(*case_inputs(GENERAL_INPUTS, GENERAL_RES[0], SEEDS["general"])),
         "space", grid)
    if n_outputs:
        outputs = init_device_mesh(device_type, (world_size,), mesh_dim_names=("outputs",))
        step, example = make_multioutput_step(outputs, n_outputs, 16, *GRID_RES, device=device)
        inputs = case_inputs(16, GRID_RES[0], SEEDS["multioutput"])
        keep("multioutput", step(*inputs, example[3]), "outputs", outputs,
             perms=example[3].numpy())
    seen["foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "smelter_tpu"))
    return seen


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Runs the multi-device steps on n ranks: on CUDA cards over NCCL when
    `device` is None (RuntimeError with fewer than n cards; there is no CPU
    fallback), in CPU processes over gloo when it is "cpu". The mesh is the
    reference's (`mesh_shape`); the grid step at max(16, streams) inputs is
    held to the single-device grid, the general step to a 1 x 1 mesh of
    itself (<= 1 u8 LSB each), and the outputs-sharded step with 2 n outputs
    must give (2 n, 216, 384) planes. Prints one "dryrun_multichip OK" line
    and returns the numbers it checked. The steps shard only what divides,
    as the reference's do: an n whose "streams" size divides neither 16 nor
    8 (9, 12, 15) is refused by both, the reference with a ValueError of its
    own, this launcher with a RuntimeError carrying the ranks' ValueError."""
    device_type = "cuda" if device is None else torch.device(device).type
    streams, space = mesh_shape(n_devices)
    n_inputs = max(16, streams)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smelter_dryrun_") as tmp:
        sharded, single = pathlib.Path(tmp, "sharded"), pathlib.Path(tmp, "single")
        ranks = meshes.launch(run_cases, n_devices,
                              (device_type, streams, (n_inputs,), 2 * n_devices, sharded),
                              device_type=device_type)
        ranks += meshes.launch(run_cases, 1, (device_type, 1, (), 0, single),
                               device_type=device_type)
        general = [np.load(d / "general.npz") for d in (sharded, single)]
        general_lsb = _max_lsb(*([g[p] for p in "yuv"] for g in general))
        multioutput = np.load(sharded / "multioutput.npz")["y"].shape
    grid_lsb = ranks[0]["errors"][f"grid_{n_inputs}"]
    foreign = sorted({m for r in ranks for m in r["foreign_modules"]})
    if grid_lsb > 1 or general_lsb > 1:
        raise AssertionError(f"multichip mismatch: grid {grid_lsb} LSB, general "
                             f"{general_lsb} LSB (1 allowed)")
    if multioutput != (2 * n_devices, GRID_RES[1].height, GRID_RES[1].width):
        raise AssertionError(f"outputs-sharded step gave {multioutput}")
    if foreign:
        raise AssertionError(f"a rank loaded {foreign}")
    seconds = time.perf_counter() - t0
    backend = meshes.backend_for(device_type)
    print(f"dryrun_multichip OK: mesh=({streams}x{space}) streams x space, {n_inputs} inputs "
          f"-> {(GRID_RES[1].height, GRID_RES[1].width)} Y plane (grid {grid_lsb} LSB from "
          f"one device, general {general_lsb} LSB from a 1x1 mesh); outputs-sharded step: "
          f"{2 * n_devices} outputs over {n_devices} ranks ({backend}); {seconds:.1f} s")
    return {"mesh": (streams, space), "backend": backend, "grid_lsb": grid_lsb,
            "general_lsb": general_lsb, "multioutput_shape": multioutput,
            "foreign_modules": foreign, "seconds": seconds}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Run the multi-device steps on n ranks.")
    parser.add_argument("-n", "--devices", type=int, default=8,
                        help="ranks, one per device (default 8)")
    parser.add_argument("--device", default=None,
                        help='"cpu" for gloo processes; the CUDA cards over NCCL if omitted')
    args = parser.parse_args(argv)
    dryrun_multichip(args.devices, device=args.device)


if __name__ == "__main__":
    main()
