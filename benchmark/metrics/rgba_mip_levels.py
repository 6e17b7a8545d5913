"""Mip levels a call of the general program builds beyond level 0 for the
inputs of the RGBA input route: `program.general.mip_levels` over
`program.calls.general`, from the program's counters since the window
began. None where the program counts neither."""

from smelter_tpu_torch.utils import tracing


def read(ctx):
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls = c.get("program.calls.general", 0)
    if not calls or "program.general.mip_levels" not in c:
        return None
    return c["program.general.mip_levels"] / calls
