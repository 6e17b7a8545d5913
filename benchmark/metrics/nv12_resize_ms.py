"""Device ms an output frame of the fused NV12 convert-and-resize pass: the
kernels whose name holds `nv12_convert_resize` (`smelter_tpu_torch/csrc/
nv12_convert_resize.cu`), over the traced window. None where the trace
holds no such kernel (a program whose NV12 tiles are made otherwise)."""


def read(ctx):
    d = ctx.digest
    if not d.device or not d.frames:
        return None
    times = [e - s for n, s, e in d.device if "nv12_convert_resize" in n]
    if not times:
        return None
    return sum(times) * 1e3 / d.frames
