"""NV12 tiles a call of the general program makes by the fused
convert-and-resize pass (`ops/hopper/nv12_resize.py`, one a static upright
NV12 tile): `program.general.nv12_tiles` over `program.calls.general`, from
the program's counters since the window began. None where the program
counts neither."""

from smelter_tpu_torch.utils import tracing


def read(ctx):
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls = c.get("program.calls.general", 0)
    if not calls or "program.general.nv12_tiles" not in c:
        return None
    return c["program.general.nv12_tiles"] / calls
