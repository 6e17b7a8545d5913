"""Put the benchmark's directory and the repository's root on sys.path, as
`benchmark/run.py` does, and give the tests their small CPU size.

Run the tests from the repository's root with

    python -m pytest --noconftest -q benchmark/tests

(`--noconftest`: the root's conftest.py imports JAX, which no process of
the benchmark may hold)."""

import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a size the CPU renders in milliseconds a frame, with the cells' 2:1 resizes
SMALL_BY_CONFIG = {
    "tiles4to1_1080p": {"input_width": 192, "input_height": 108,
                        "output_width": 192, "output_height": 108},
    "tiles16_4k": {"input_width": 192, "input_height": 108,
                   "output_width": 384, "output_height": 216},
}


def small(workload: str) -> dict:
    """The small size of a cell's configuration."""
    return SMALL_BY_CONFIG[workload.split(".")[0]]
