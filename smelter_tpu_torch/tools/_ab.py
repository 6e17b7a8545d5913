"""The A/B runner of the port's `bench_canvas_ab`, `bench_assembly_ab` and
`bench_align_ab` (the reference's `tools/bench_*_ab.py`): the general_4k
builder (`parallel.flagship.make_flagship_general_compose`) built once per
variant, each variant's setting in force while its builder is built and its
program captured, then

  1. a parity gate before any timing: per variant, max |diff| (and the share
     of pixels off by more than 1) of the u8 Y, U and V planes against the
     baseline variant's on the same inputs; a gated variant past 1 LSB
     prints `{"error": "parity FAILED", "parity": ...}` and exits 1;
  2. `rounds` interleaved rounds of `iters` replays per variant, alternating
     between two seeded input sets already on the device, each replay's
     device time read off a torch.profiler trace (`tools/_profile.py`: the
     time the card is busy with it).

The inputs are the reference tools' (`np.random.default_rng(7)`, two sets).
Runs on the card unless given `--device cpu`; raises without a card. Each
variant's program is its own (its own builder, compose cache and CUDA
graph): a captured graph fixes the canvas dtype and route it was captured
with.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from smelter_tpu_torch.core.types import Resolution
from smelter_tpu_torch.interop import planes_to_device, planes_to_host, resolve_device
from smelter_tpu_torch.parallel.flagship import make_flagship_general_compose
from smelter_tpu_torch.render.capture import capture
from smelter_tpu_torch.tools._inputs import parse_resolution
from smelter_tpu_torch.tools._profile import FrameProfile, card

N_INPUTS = 16
IN_RES = Resolution(1920, 1080)
OUT_RES = Resolution(3840, 2160)
ROUNDS = 3
ITERS = 20


@contextlib.contextmanager
def env(overrides: Dict[str, str]):
    """The environment variables `overrides` set inside the block, restored
    (or removed) after it."""
    saved = {k: os.environ.get(k) for k in overrides}
    os.environ.update(overrides)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def host_inputs(n_inputs: int, in_res: Resolution):
    """The reference tools' two input sets: stacked u8 Y, U, V planes from
    `np.random.default_rng(7)`."""
    rng = np.random.default_rng(7)
    h, w = in_res.height, in_res.width
    sets = []
    for _ in range(2):
        y = rng.integers(16, 235, (n_inputs, h, w), dtype=np.uint8)
        u = rng.integers(16, 240, (n_inputs, h // 2, w // 2), dtype=np.uint8)
        v = rng.integers(16, 240, (n_inputs, h // 2, w // 2), dtype=np.uint8)
        sets.append((y, u, v))
    return sets


def parse(description: str, extra: Optional[Callable] = None,
          argv: Optional[List[str]] = None) -> argparse.Namespace:
    """The command line of an A/B tool: its own options (`extra(ap)`), then
    those every A/B tool takes."""
    ap = argparse.ArgumentParser(description=description)
    if extra is not None:
        extra(ap)
    ap.add_argument("--device", default=None,
                    help='"cpu" to run on the CPU; the CUDA card if omitted')
    ap.add_argument("--inputs", type=int, default=N_INPUTS, help="inputs composed")
    ap.add_argument("--inres", type=parse_resolution, default=IN_RES, help="WxH of each input")
    ap.add_argument("--out", type=parse_resolution, default=OUT_RES, help="WxH of the output")
    ap.add_argument("--rounds", type=int, default=ROUNDS, help="interleaved rounds")
    ap.add_argument("--iters", type=int, default=ITERS, help="replays per variant and round")
    return ap.parse_args(argv)


def _parity(outs: Dict[str, tuple], baseline: str) -> Dict[str, dict]:
    parity = {}
    for tag, planes in outs.items():
        if tag == baseline:
            continue
        parity[tag] = {}
        for name, a, b in zip("yuv", planes, outs[baseline]):
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            parity[tag][name] = {"max": int(d.max()), "pct_gt1": float((d > 1).mean())}
    return parity


def run(metric: str, variants: Sequence[Tuple[str, Callable, dict]], baseline: str,
        gated: Sequence[str], args: argparse.Namespace) -> dict:
    """Build, gate and time the variants; print and return the JSON line.

    `variants`: (tag, setting, fields) per variant, where `setting()` is a
    context manager in force while the variant's builder is built and its
    program captured, and `fields` go into its entry of "variants". Exits 1
    after printing the error line when a gated variant fails parity."""
    device = resolve_device(args.device)
    frames = [planes_to_device(f, device) for f in host_inputs(args.inputs, args.inres)]
    progs = {}
    for tag, setting, _ in variants:
        t0 = time.perf_counter()
        with setting():
            fn, _ = make_flagship_general_compose(args.inputs, args.inres, args.out, device=device)
            progs[tag], _ = capture(fn, frames[0], device)
        print(json.dumps({"variant": tag, "compile_s": round(time.perf_counter() - t0, 1)}),
              file=sys.stderr, flush=True)

    parity = _parity({tag: planes_to_host(prog(*frames[0])) for tag, prog in progs.items()},
                     baseline)
    print(json.dumps({"parity": parity}), file=sys.stderr, flush=True)
    if any(p["max"] > 1 for tag in gated for p in parity[tag].values()):
        print(json.dumps({"error": "parity FAILED", "parity": parity}), flush=True)
        sys.exit(1)

    durs: Dict[str, List[float]] = {tag: [] for tag, _, _ in variants}
    for _ in range(args.rounds):
        for tag, _, _ in variants:
            prog = progs[tag]
            with FrameProfile(device) as fp:
                for i in range(args.iters):
                    with fp.frame():
                        prog(*frames[i % 2])
            durs[tag].extend(fp.busy_ms())

    out = {"metric": metric, "device": card(device) or str(device),
           "rounds": args.rounds, "iters_per_round": args.iters,
           "parity": parity, "variants": {}}
    for tag, _, fields in variants:
        d = sorted(durs[tag])
        out["variants"][tag] = {
            **fields,
            "device_p50_ms": round(statistics.median(d), 3),
            "device_p95_ms": round(d[max(0, int(len(d) * 0.95) - 1)], 3),
            "frames": len(d),
        }
    print(json.dumps(out), flush=True)
    return out


def env_variants(configs: Sequence[Tuple[str, Dict[str, str]]]) -> List[tuple]:
    """(tag, setting, fields) for variants that differ by environment
    switches read when a builder is built; "env" is reported as in the
    reference."""
    return [(tag, lambda e=e: env(e), {"env": e}) for tag, e in configs]

