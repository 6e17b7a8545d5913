"""A/B device measurement of the aligned group unions
(`ops/compose.py:_align_union`: each texture group's union widened to
(8, 128) boundaries, (16, 128) on a 16-bit canvas) against exact unions on
general_4k, 16 x 1080p -> 4K: the port of the reference's
`tools/bench_align_ab.py`.

    python -m smelter_tpu_torch.tools.bench_align_ab [--device cpu]
        [--inputs N] [--inres WxH] [--out WxH] [--rounds R] [--iters I]

  aligned   — `_align_union` as it is
  unaligned — `_align_union` replaced by the identity while the variant's
              builder is built and its program captured (the reference
              monkeypatches it the same way)

Alignment is exact by construction (members are zero outside their
footprint), so "unaligned" is gated at <= 1 u8 LSB against "aligned" before
any timing (`tools/_ab.py`). Prints one JSON line: metric, device, rounds,
iters_per_round, parity, and per variant aligned, device_p50_ms,
device_p95_ms, frames.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

from smelter_tpu_torch.ops import compose
from smelter_tpu_torch.tools import _ab

CONFIGS = [("aligned", True), ("unaligned", False)]
BASELINE_TAG = "aligned"


@contextlib.contextmanager
def unions(aligned: bool):
    """`compose._align_union` as it is, or the identity, inside the block."""
    orig = compose._align_union
    if not aligned:
        compose._align_union = lambda reg, h, w, sublane=8: reg
    try:
        yield
    finally:
        compose._align_union = orig


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the A/B, print its JSON line and return it."""
    args = _ab.parse("Aligned against exact group unions on general_4k.", argv=argv)
    variants = [(tag, lambda a=aligned: unions(a), {"aligned": aligned})
                for tag, aligned in CONFIGS]
    return _ab.run("general_4k_align_ab", variants, BASELINE_TAG, ("unaligned",), args)


if __name__ == "__main__":
    main()
