"""The comparison that decides `correct`: each sampled output frame of the
window, as the timed path fetched it to the host, against the plain
reference of the cell's configuration (`references/<name>.py`), which
imports nothing of the program and works the frame out again from the
same input planes.

Two numbers are compared, each against its limit in
`limits/<workload>.json`, over the worst sampled frame:
  - `diff_ppm`: the Y, U and V samples that differ, per million;
  - `max_lsb`: the largest difference of one sample, in u8 steps, so that
    a small region rendered wrong fails even where it touches few samples.

The control runs the reference itself in the precision below the one the
configuration states (`CONTROL_PRECISION`) in the program's place."""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np

from smelter_bench.cell import Cell

CHECKED = ("diff_ppm", "max_lsb")
# the precision a configuration states -> the one below it (the control's)
CONTROL_PRECISION = {"bfloat16": "float8_e4m3fn", "float16": "float8_e4m3fn"}


def torch_dtype(name: str):
    import torch

    return getattr(torch, name)


def reference_frames(cell: Cell, planes_ring: list, ticks, device, precision: str
                     ) -> Dict[Tuple[int, str], Tuple[np.ndarray, ...]]:
    """The reference's output planes (host numpy) of every output at each of
    `ticks`, in `precision`: {(tick, output): planes}."""
    dtype = torch_dtype(precision)
    out = {}
    for k in sorted(ticks):
        planes = planes_ring[k % len(planes_ring)]
        for o in cell.outputs:
            out[(k, o)] = cell.reference.render(
                cell.cfg, cell.scene.output_inputs(cell.cfg, o), planes, device, dtype)
    return out


def compare(got: Tuple[np.ndarray, ...], ref: Tuple[np.ndarray, ...]) -> Tuple[int, int, int]:
    """(samples that differ, samples, largest difference in u8 steps) over
    the planes of two frames."""
    n_diff = n = worst = 0
    if len(got) != len(ref):
        raise ValueError(f"{len(got)} planes against {len(ref)}")
    for a, b in zip(got, ref):
        if a.shape != b.shape:
            raise ValueError(f"plane shapes differ: {a.shape} against {b.shape}")
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        n_diff += int(np.count_nonzero(d))
        n += d.size
        worst = max(worst, int(d.max()))
    return n_diff, n, worst


def judge(got: Dict[Tuple[int, str], Tuple[np.ndarray, ...]],
          ref: Dict[Tuple[int, str], Tuple[np.ndarray, ...]], limits: Dict[str, float]) -> dict:
    """Each frame of `got` held to `ref`: {"rejected": [(tick, output)],
    "diff_ppm": the worst frame's, "max_lsb": the worst frame's}."""
    rejected, worst = [], {"diff_ppm": 0.0, "max_lsb": 0}
    for key in sorted(got):
        n_diff, n, lsb = compare(got[key], ref[key])
        reading = {"diff_ppm": 1e6 * n_diff / n, "max_lsb": lsb}
        worst = {c: max(worst[c], reading[c]) for c in CHECKED}
        if any(reading[c] > limits[c] for c in CHECKED):
            rejected.append(key)
    return {"rejected": rejected, **worst}


def check(cell: Cell, sampled: Dict[int, Dict[str, object]], planes_ring: list, device) -> dict:
    """Hold each sampled tick's output frames (host Frames of the timed
    path, {tick: {output: frame}}) to the reference in the configuration's
    precision: `judge`'s readings, with "frames": n and "seconds": the
    reference's time."""
    t0 = time.perf_counter()
    ref = reference_frames(cell, planes_ring, sampled, device, cell.cfg["precision"])
    got = {}
    for k, outputs in sampled.items():
        for o in cell.outputs:
            if o in outputs:
                got[(k, o)] = tuple(outputs[o].data)
    verdict = judge(got, ref, cell.limits)
    missing = [(k, o) for k in sampled for o in cell.outputs if (k, o) not in got]
    verdict["rejected"] += missing
    return {**verdict, "frames": len(got), "ticks": sorted(sampled),
            "seconds": time.perf_counter() - t0}
