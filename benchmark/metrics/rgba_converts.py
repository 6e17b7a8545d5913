"""Inputs a call of the general program converts to full-resolution RGBA
(the RGBA input route: every input format but planar YUV):
`program.general.rgba_converts` over `program.calls.general`, from the
program's counters since the window began. None where the program counts
neither."""

from smelter_tpu_torch.utils import tracing


def read(ctx):
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls = c.get("program.calls.general", 0)
    if not calls or "program.general.rgba_converts" not in c:
        return None
    return c["program.general.rgba_converts"] / calls
