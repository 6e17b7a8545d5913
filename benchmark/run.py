"""The benchmark of smelter_tpu_torch, one run of one cell:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of its
standard output (one JSON object) and, as the last lines of its standard
error, each number compared with the plain reference beside its limit.
Exits 2 without a result where torch sees no CUDA card, or fewer than the
cell asks for, and 3 where a forbidden module was loaded (JAX, or the JAX
package the port was made from)."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# every cache stays at a fixed place inside the checkout
os.environ["CUDA_CACHE_PATH"] = str(BENCH_DIR / ".cache" / "nv")
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from smelter_bench.cell import load_cell
    from smelter_bench.harness import forbidden_modules, run

    chips = load_cell(args.workload).chips
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, _ = run(args.workload, args.seed, args.seconds, bool(args.trace), T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checked"].items():
        print(f"checked {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
