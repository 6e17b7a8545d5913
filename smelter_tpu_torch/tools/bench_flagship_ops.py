"""Per-kernel device breakdown of the flagship compose (the port of the
reference's `tools/bench_flagship_ops.py`): the Tiles grid, or general_4k
under --general, at N x 1080p -> 4K.

    python -m smelter_tpu_torch.tools.bench_flagship_ops [N] [--general] [--device cpu]

The program is captured into a CUDA graph as `smelter_tpu_torch/bench.py`
captures it (`render.capture.capture`), run once, then called 40 times
under torch.profiler, alternating between two seeded input sets already on
the card. Each call's device time is read off the trace
(`tools/_profile.py`), and the kernels' times are summed by name. Runs on
the card unless given `--device cpu`; without a card it raises.

Prints one JSON line: program, device_p50_ms, frames, top_ops_ms_per_frame
(the 32 kernels that take the most device time per frame; their names are
the CUDA kernels') and card.
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

from smelter_tpu_torch.bench import host_frames
from smelter_tpu_torch.core.types import Resolution
from smelter_tpu_torch.interop import planes_to_device, resolve_device
from smelter_tpu_torch.parallel.flagship import (
    make_flagship_compose,
    make_flagship_general_compose,
)
from smelter_tpu_torch.render.capture import capture
from smelter_tpu_torch.tools._profile import FrameProfile, card

ITERS = 40


def run(n: int, general: bool, device, in_res: Resolution = Resolution(1920, 1080),
        out_res: Resolution = Resolution(3840, 2160), iters: int = ITERS) -> dict:
    """Profile `iters` calls of the captured program; returns the JSON line."""
    make = make_flagship_general_compose if general else make_flagship_compose
    fn, _ = make(n_inputs=n, in_res=in_res, out_res=out_res, device=device)
    frames = [planes_to_device(f, device) for f in host_frames(n, in_res)]
    prog, _ = capture(fn, frames[0], device)
    prog(*frames[0])  # the first replay, out of the window
    with FrameProfile(device) as fp:
        for i in range(iters):
            with fp.frame():
                prog(*frames[i % 2])
    durs = sorted(fp.busy_ms())
    totals = sorted(fp.op_totals_ms().items(), key=lambda kv: -kv[1])[:32]
    return {
        "program": "general_4k" if general else "flagship_grid",
        "device_p50_ms": round(durs[len(durs) // 2], 3),
        "frames": len(durs),
        "top_ops_ms_per_frame": [[name, round(total / len(durs), 4)] for name, total in totals],
        "card": card(device),
    }


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the breakdown, print its JSON line and return it."""
    ap = argparse.ArgumentParser(description="Per-kernel breakdown of the flagship compose.")
    ap.add_argument("n", nargs="?", type=int, default=16, help="1080p inputs")
    ap.add_argument("--general", action="store_true", help="general_4k, not the grid")
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU; the CUDA card if omitted')
    args = ap.parse_args(argv)
    res = run(args.n, args.general, resolve_device(args.device))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
