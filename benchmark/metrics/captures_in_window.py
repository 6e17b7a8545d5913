"""Programs captured inside the window (`render.capture` spans): a new
structure key met there, captured while frames wait."""


def read(ctx):
    s = ctx.spans.get("render.capture")
    return float(s["count"]) if s else 0.0
