"""Meshes of devices for the flagship's multi-device steps, over
`torch.distributed`: one process per device (a rank), a `DeviceMesh` whose
axes carry the reference's names, and explicit collectives on plain tensors.

The reference runs one controller over a `jax.sharding.Mesh` and lets GSPMD
insert the collectives. Here every rank runs the same step on its own shard
of a mesh that `torch.distributed.device_mesh.init_device_mesh` makes (its
ranks in row-major order, so that a group's rank order is its coordinate
order):

  - `process_group`: joins this process to a group (gloo for CPU tensors,
    NCCL for CUDA tensors; never gloo for CUDA), with a 60 s timeout, and
    destroys it on the way out;
  - `launch`: spawns one rank per device, runs a target in each and returns
    their results; it fails fast when a rank fails and never waits past its
    deadline;
  - `shard_range`, `row_band`: which inputs, outputs or rows a rank owns
    along a mesh axis (ValueError, naming the axis, when they do not
    divide);
  - `all_gather_stacked`, `broadcast_from_first`, `gather_planes`: the
    collectives the steps make.
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import multiprocessing.connection
import pathlib
import tempfile
import time
import traceback
import warnings
from typing import Callable, Sequence, Tuple

import torch
import torch.distributed as dist

TIMEOUT_S = 60  # of the process group's rendezvous and of each collective


def backend_for(device_type: str) -> str:
    """The collective backend for tensors of `device_type`."""
    return "nccl" if device_type == "cuda" else "gloo"


def rank_device(mesh, device=None) -> torch.device:
    """The device of this rank's tensors on `mesh`: `device` if given (it must
    be of the mesh's type), else the CPU or this process's current card."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    device = torch.device(device)
    if device.type != mesh.device_type:
        raise ValueError(f"a {mesh.device_type} mesh cannot hold {device} tensors")
    return device


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def shard_range(n: int, mesh, axis: str) -> Tuple[int, int]:
    """[lo, hi): the items of n that this rank owns along `axis`, in equal
    blocks by the rank's coordinate on it."""
    parts = axis_size(mesh, axis)
    if n % parts:
        raise ValueError(f"{n} does not divide over mesh axis {axis!r} of size {parts}")
    k = n // parts
    i = mesh.get_local_rank(axis)
    return i * k, (i + 1) * k


def row_band(height: int, mesh, axis: str) -> Tuple[int, int]:
    """[r0, r1): the luma rows of a YUV420 frame of `height` rows that this
    rank converts along `axis`. A band has an even row count, so that its
    chroma rows are [r0 / 2, r1 / 2)."""
    parts = axis_size(mesh, axis)
    if height % (2 * parts):
        raise ValueError(f"{height} luma rows ({height // 2} chroma rows) do not divide "
                         f"over mesh axis {axis!r} of size {parts}")
    return shard_range(height, mesh, axis)


def _all_gather(out: torch.Tensor, t: torch.Tensor, group) -> None:
    with warnings.catch_warnings():
        # newer releases rename it (all_gather_single); the name kept here
        # exists in every release the port runs on
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)


def all_gather_stacked(t: torch.Tensor, group) -> torch.Tensor:
    """The (k, ...) tensors of the group's ranks, stacked in rank order along
    dim 0: (size * k, ...). Every rank of the group receives them."""
    size = dist.get_world_size(group)
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _all_gather(out, t, group)
    return out


def broadcast_from_first(t: torch.Tensor, group) -> torch.Tensor:
    """`t` of the group's first rank, on every rank of the group (in place)."""
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return t


def gather_planes(planes: Sequence[torch.Tensor], mesh, axis: str) -> Tuple[torch.Tensor, ...]:
    """The global planes of a step whose outputs are sharded along `axis`
    (row bands, or blocks of outputs, on dim 0): what `np.asarray` gives of
    a sharded `jax.Array`. Every rank of the axis receives them; rank 0's
    are the ones to read."""
    group = mesh.get_group(axis)
    return tuple(all_gather_stacked(p, group) for p in planes)


@contextlib.contextmanager
def process_group(device_type: str, rank: int = 0, world_size: int = 1,
                  init_method: str | None = None):
    """This process as `rank` of a process group of `world_size` ranks, for
    tensors of `device_type`; with no `init_method`, a group of this process
    alone. A CUDA rank works on card `rank` (one host). Every rank destroys
    the group on the way out."""
    with contextlib.ExitStack() as stack:
        if init_method is None:
            if world_size != 1:
                raise ValueError("a group of several ranks needs their init_method")
            tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="smelter_mesh_"))
            init_method = (pathlib.Path(tmp) / "rendezvous").as_uri()
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend_for(device_type), init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_main(target: Callable, rank: int, world_size: int, device_type: str,
               init_method: str, args: tuple, conn) -> None:
    """A spawned rank: runs target(rank, world_size, *args) in the group and
    sends (ok, result or traceback) to the launcher, before the group is
    destroyed, so that a failure is reported before its peers see it."""
    torch.set_num_threads(1)
    reported = False
    with conn:
        try:
            with process_group(device_type, rank, world_size, init_method):
                try:
                    value = target(rank, world_size, *args)
                except BaseException:
                    reported = True
                    conn.send((False, traceback.format_exc()))
                    raise
                reported = True
                conn.send((True, value))
        except BaseException:  # noqa: BLE001 - reported to the launcher, which raises it
            if not reported:
                conn.send((False, traceback.format_exc()))


def launch(target: Callable, world_size: int, args: tuple = (), device_type: str = "cpu",
           deadline_s: float = 300.0) -> list:
    """Runs target(rank, world_size, *args) in `world_size` spawned processes,
    each a rank of one process group for `device_type` tensors, and returns
    their results in rank order. `target` must be importable by name (a
    function of this package: a spawned process imports its module).

    Raises RuntimeError with the failing ranks' tracebacks as soon as a rank
    fails (its peers, which may be waiting in a collective, are terminated),
    and TimeoutError when the ranks have not all finished after
    `deadline_s`. No rank outlives the call."""
    if device_type == "cuda":
        if torch.cuda.device_count() < world_size:
            raise RuntimeError(f"{world_size} CUDA ranks need {world_size} cards; torch "
                               f"sees {torch.cuda.device_count()}")
        from smelter_tpu_torch.ops.hopper import build

        build.library()  # once here, not once per rank
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="smelter_mesh_") as tmp:
        init_method = (pathlib.Path(tmp) / "rendezvous").as_uri()
        procs, conns = [], []
        try:
            for rank in range(world_size):
                receive, send = ctx.Pipe(duplex=False)
                proc = ctx.Process(
                    target=_rank_main, daemon=True, name=f"mesh-rank-{rank}",
                    args=(target, rank, world_size, device_type, init_method, args, send))
                proc.start()
                send.close()
                procs.append(proc)
                conns.append(receive)
            return _results(procs, conns, deadline_s)
        finally:
            for proc in procs:
                if proc.is_alive():
                    proc.terminate()
            for proc in procs:
                proc.join(10)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            for conn in conns:
                conn.close()


def _results(procs, conns, deadline_s: float) -> list:
    deadline = time.monotonic() + deadline_s
    results: dict = {}
    waiting = dict(enumerate(conns))
    while waiting:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"ranks {sorted(waiting)} of {len(procs)} did not finish "
                               f"within {deadline_s} s")
        ready = multiprocessing.connection.wait(list(waiting.values()), timeout=min(left, 1.0))
        failed = []
        for rank in sorted(r for r, c in waiting.items() if c in ready):
            try:
                ok, value = waiting.pop(rank).recv()
            except EOFError:
                ok, value = False, f"rank {rank} exited with code {procs[rank].exitcode} " \
                                   "before it sent a result"
            if ok:
                results[rank] = value
            else:
                failed.append(f"rank {rank} of {len(procs)} failed:\n{value}")
        if failed:
            raise RuntimeError("\n".join(failed))
    return [results[r] for r in range(len(procs))]
