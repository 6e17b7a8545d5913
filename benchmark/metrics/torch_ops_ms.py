"""Device ms an output frame of every kernel that is neither a GEMM nor one
of the hand-written K1-K5: the PyTorch operations of the compose routes
(casts, rounding, placement), over the traced window."""


def read(ctx):
    d = ctx.digest
    if not d.device or not d.frames:
        return None
    return d.kind_s("torch") * 1e3 / d.frames
