"""A/B device measurement of 16-bit root planar canvases against f32
(SMELTER_CANVAS_DTYPE, `ops/compose.py:_canvas_dtype`) on general_4k, 16 x
1080p -> 4K: the port of the reference's `tools/bench_canvas_ab.py`.

    python -m smelter_tpu_torch.tools.bench_canvas_ab [--variants u16,f16,bf16,f32]
        [--gate u16] [--device cpu] [--inputs N] [--inres WxH] [--out WxH]
        [--rounds R] [--iters I]

A 16-bit canvas halves the canvas traffic: K1's write, the texture group
chains' region reads and writes, and K2's read of three planes. Every blend
stays f32; only the stored value quantizes. In the port the group chains
decode and encode in torch ops of their own, so a 16-bit canvas may move
more bytes there, not fewer; this tool measures the whole frame.

  u16  — SMELTER_CANVAS_DTYPE=uint16   (fixed point, value * 8192 + 16384)
  f16  — SMELTER_CANVAS_DTYPE=float16
  bf16 — SMELTER_CANVAS_DTYPE=bfloat16
  f32  — SMELTER_CANVAS_DTYPE=float32  (the baseline; what `auto` is)

By default u16 against f32, u16 gated at <= 1 u8 LSB against f32 before any
timing; --variants and --gate pick others (`tools/_ab.py` runs them).
Prints one JSON line: metric, device, rounds, iters_per_round, parity, and
per variant env, device_p50_ms, device_p95_ms, frames.
"""

from __future__ import annotations

from typing import List, Optional

from smelter_tpu_torch.tools import _ab

ALL_CONFIGS = {
    "u16": {"SMELTER_CANVAS_DTYPE": "uint16"},
    "f16": {"SMELTER_CANVAS_DTYPE": "float16"},
    "bf16": {"SMELTER_CANVAS_DTYPE": "bfloat16"},
    "f32": {"SMELTER_CANVAS_DTYPE": "float32"},
}
VARIANTS = ("u16", "f32")
BASELINE_TAG = "f32"
GATED_TAGS = ("u16",)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the A/B, print its JSON line and return it."""
    def extra(ap):
        ap.add_argument("--variants", default=",".join(VARIANTS),
                        help="comma list from: " + ",".join(ALL_CONFIGS))
        ap.add_argument("--gate", default=",".join(GATED_TAGS),
                        help="comma list of variants that must pass <= 1 LSB")

    args = _ab.parse("16-bit against f32 compose canvases on general_4k.", extra, argv)
    tags = args.variants.split(",")
    if BASELINE_TAG not in tags:
        raise ValueError(f"--variants must hold the baseline {BASELINE_TAG!r}")
    gated = tuple(t for t in args.gate.split(",") if t)
    configs = [(t, ALL_CONFIGS[t]) for t in tags]
    return _ab.run("general_4k_canvas_dtype_ab", _ab.env_variants(configs), BASELINE_TAG,
                   gated, args)


if __name__ == "__main__":
    main()
