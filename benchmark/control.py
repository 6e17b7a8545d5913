"""Readings that set the limits of the output comparison of a cell
(`limits/<workload>.json`):

    python3 benchmark/control.py --workload <name> --seconds 2 \
        --seeds <n>... --control-seeds <n>...

For each of `--seeds` the program runs as its configuration states: a
whole run of the cell (set-up, a closed-loop window of `--seconds`, the
sampled frames held to the plain reference), all in this one process. For
each of `--control-seeds` the control takes the program's place: the
plain reference itself, computed in the precision below the one the
configuration states (`reference.CONTROL_PRECISION`), over as many ticks
as a run samples, every output of each, at the cell's own size, held to
the reference in the stated precision. Prints one JSON line a reading
and, last, the lower reading of each number (the most the program reads),
the upper one (the least the control reads) and the limit in force."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def program_readings(workload, seeds, seconds, device=None, cfg_overrides=None,
                     log=sys.stderr):
    """[(seed, result line)] of one run of `workload` per seed."""
    from smelter_bench.harness import run

    return [(seed, run(workload, seed, seconds, False, time.perf_counter(), device=device,
                       cfg_overrides=cfg_overrides, log=log)[0])
            for seed in seeds]


def control_reading(workload, seed, device="cuda", cfg_overrides=None) -> dict:
    """The control's readings on the inputs of `seed`: `reference.judge`'s
    verdict of the reference in the precision below the stated one, held to
    the reference in the stated one, and whether it is correct."""
    from smelter_bench.cell import load_cell, make_inputs
    from smelter_bench.reference import CONTROL_PRECISION, judge, reference_frames

    cell = load_cell(workload, cfg_overrides=cfg_overrides)
    stated = cell.cfg["precision"]
    ring = make_inputs(cell.cfg, int(cell.traffic["ring"]), seed, device)
    ticks = range(int(cell.traffic["check_frames"]))
    ref = reference_frames(cell, ring, ticks, device, stated)
    lower = reference_frames(cell, ring, ticks, device, CONTROL_PRECISION[stated])
    verdict = judge(lower, ref, cell.limits)
    return {"precision": CONTROL_PRECISION[stated], "frames": len(lower),
            "diff_ppm": verdict["diff_ppm"], "max_lsb": verdict["max_lsb"],
            "correct": not verdict["rejected"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control.py reads the card; torch sees none", file=sys.stderr)
        return 2
    from smelter_bench.cell import load_cell
    from smelter_bench.reference import CHECKED

    program, control = [], []
    for seed, result in program_readings(args.workload, args.seeds, args.seconds):
        reading = {c: result["checked"][c]["value"] for c in CHECKED}
        program.append(reading)
        print(json.dumps({"side": "program", "seed": seed, **reading,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "card": result["card"]}), flush=True)
    for seed in args.control_seeds:
        reading = control_reading(args.workload, seed)
        control.append(reading)
        print(json.dumps({"side": "control", "seed": seed, **reading}), flush=True)
    limits = load_cell(args.workload).limits
    print(json.dumps({
        "workload": args.workload,
        **{c: {"lower": max((r[c] for r in program), default=None),
               "upper": min((r[c] for r in control), default=None),
               "limit": limits[c]} for c in CHECKED},
        "seconds": time.perf_counter() - T_START}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
