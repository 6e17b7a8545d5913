"""Device ms an output frame of the resize GEMMs: cuBLAS's mainloops and
split-K reductions, by kernel name, over the traced window."""


def read(ctx):
    d = ctx.digest
    if not d.device or not d.frames:
        return None
    return d.kind_s("gemm") * 1e3 / d.frames
