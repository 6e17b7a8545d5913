"""MB an output frame cloned out of a captured program's graph pool: the
bytes of the outputs that `CapturedProgram.__call__` copies out
(`program.out_bytes`), over the program's calls (`program.calls`), from
the program's counters since the window began. None where the program
counts none of them."""

from smelter_tpu_torch.utils import tracing


def read(ctx):
    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    calls = c.get("program.calls", 0)
    if not calls:
        return None
    return c.get("program.out_bytes", 0) / calls / 1e6
