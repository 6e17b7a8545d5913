"""Device ms an output frame of the card's copies and memsets: the output
planes' copies to pinned host memory and whatever else the window copies
or clears on the card, over the traced window."""


def read(ctx):
    d = ctx.digest
    if not d.device or not d.frames:
        return None
    return (d.kind_s("copy") + d.kind_s("memset")) * 1e3 / d.frames
