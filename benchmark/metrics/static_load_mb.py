"""MB an output frame copied into a captured program's static buffers: the
bytes that `CapturedProgram.__call__` loads from the card's own memory
(`program.load_d2d_bytes`, the device-resident inputs) and from the host
(`program.load_h2d_bytes`, the packed parameters), over the program's
calls (`program.calls`), from the program's counters since the window
began. None where the program counts none of them."""

from smelter_tpu_torch.utils import tracing


def read(ctx):
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls = c.get("program.calls", 0)
    if not calls:
        return None
    return (c.get("program.load_d2d_bytes", 0) + c.get("program.load_h2d_bytes", 0)) / calls / 1e6
