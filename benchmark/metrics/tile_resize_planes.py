"""Tile planes a call of the general program resizes by the banded pass
(`ops/hopper/tile_resize.py`, three a YUV tile):
`program.general.tile_resize_planes` over `program.calls.general`, from the
program's counters since the window began. None where the program counts
neither."""

from smelter_tpu_torch.utils import tracing


def read(ctx):
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls = c.get("program.calls.general", 0)
    if not calls or "program.general.tile_resize_planes" not in c:
        return None
    return c["program.general.tile_resize_planes"] / calls
