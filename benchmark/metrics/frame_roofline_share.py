"""% of the card's busy time that the least bytes of the window's ticks
would take at the HBM peak: each input plane the scene shows read once and
each plane of each output frame written once (`cell.least_bytes`), at 3.35
TB/s (H100 SXM, NVIDIA's data sheet, at a 700 W power limit; the run
prints the card's limit)."""

from smelter_bench.cell import HBM_BYTES_PER_S


def read(ctx):
    d = ctx.digest
    if not d.device or ctx.least_bytes <= 0:
        return None
    busy = d.busy_s()
    return 100.0 * ctx.least_bytes / HBM_BYTES_PER_S / busy if busy > 0 else None
