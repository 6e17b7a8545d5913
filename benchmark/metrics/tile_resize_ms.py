"""Device ms an output frame of the tile converts' banded resize: the
kernels whose name holds `tile_resize` (`smelter_tpu_torch/csrc/
tile_resize.cu`), over the traced window. None where the trace holds no
such kernel (a program whose tile converts resize otherwise)."""


def read(ctx):
    d = ctx.digest
    if not d.device or not d.frames:
        return None
    times = [e - s for n, s, e in d.device if "tile_resize" in n]
    if not times:
        return None
    return sum(times) * 1e3 / d.frames
