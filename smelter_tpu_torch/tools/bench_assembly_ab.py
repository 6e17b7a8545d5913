"""A/B device measurement of kernel K1 (single-pass scene assembly,
`ops/hopper/scene_assembly.py`) against the group path for the canvas-opening
run (SMELTER_SCENE_ASSEMBLY, `ops/compose.py:_assembly_mode`) on general_4k,
16 x 1080p -> 4K: the port of the reference's `tools/bench_assembly_ab.py`.

    python -m smelter_tpu_torch.tools.bench_assembly_ab [--device cpu]
        [--inputs N] [--inres WxH] [--out WxH] [--rounds R] [--iters I]

  kernel — SMELTER_SCENE_ASSEMBLY=on  (K1 creates the canvas)
  groups — SMELTER_SCENE_ASSEMBLY=off (every member through the group path)

The reference's third variant also turned its fused YUV output off
(SMELTER_FUSED_YUV); the port has no such switch and always converts with
kernel K2, so its two variants are these. Each variant is gated at <= 1 u8
LSB against "groups" before any timing (`tools/_ab.py`). Prints one JSON
line: metric, device, rounds, iters_per_round, parity, and per variant env,
device_p50_ms, device_p95_ms, frames.
"""

from __future__ import annotations

from typing import List, Optional

from smelter_tpu_torch.tools import _ab

CONFIGS = [
    ("kernel", {"SMELTER_SCENE_ASSEMBLY": "on"}),
    ("groups", {"SMELTER_SCENE_ASSEMBLY": "off"}),
]
BASELINE_TAG = "groups"


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the A/B, print its JSON line and return it."""
    args = _ab.parse("K1 against group assembly on general_4k.", argv=argv)
    gated = tuple(t for t, _ in CONFIGS if t != BASELINE_TAG)
    return _ab.run("general_4k_assembly_ab", _ab.env_variants(CONFIGS), BASELINE_TAG,
                   gated, args)


if __name__ == "__main__":
    main()
