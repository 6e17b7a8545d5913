"""Soak the port's web-renderer test module, `tests/test_torch_web.py` (the
counterpart of the reference's `tools/soak_web.py`, which soaks
`tests/test_web_renderer.py`): N consecutive clean runs show that the
screencast/embedding synchronization does not flake on a loaded box.

Usage: python -m smelter_tpu_torch.tools.soak_web [--rounds 20]   (from the repo's root)
"""

import argparse
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    for i in range(1, args.rounds + 1):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/test_torch_web.py",
             "-q", "-p", "no:cacheprovider"],
            capture_output=True, text=True,
        )
        dt = time.time() - t0
        status = "ok" if proc.returncode == 0 else "FAIL"
        print(f"round {i}/{args.rounds}: {status} ({dt:.1f}s)", flush=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:])
            print(proc.stderr[-2000:])
            return 1
    print(f"soak clean: {args.rounds}/{args.rounds}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
