"""Device ms an output frame of the hand-written kernels K1-K5
(`smelter_tpu_torch/csrc/`, `trace.HOPPER_RE`): scene assembly, SDF
layers, the YUV420 output, the group blends and the row shears, over the
traced window."""


def read(ctx):
    d = ctx.digest
    if not d.device or not d.frames:
        return None
    return d.kind_s("hopper") * 1e3 / d.frames
