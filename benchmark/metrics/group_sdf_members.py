"""Colour and shadow members a call of the general program has K4 evaluate
from their parameters (no torch layer rendered for them):
`program.general.sdf_members` over `program.calls.general`, from the
program's counters since the window began. None where the program counts
neither."""

from smelter_tpu_torch.utils import tracing


def read(ctx):
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls = c.get("program.calls.general", 0)
    if not calls or "program.general.sdf_members" not in c:
        return None
    return c["program.general.sdf_members"] / calls
