"""Upstream's benchmark scene: each output is one Tiles of its own inputs,
with the props the configuration gives (tile aspect ratio, margin,
padding, background), every tile an InputStream.

`build(api, cfg, stage, output)` takes the component classes of the
program (`api.comp`: a `scene.components` module; `api.types`: a
`core.types` module). The scene is static: `stage` is not read."""

STAGES = 1


def output_ids(cfg):
    return [f"out_{o}" for o in range(cfg["outputs"])]


def output_inputs(cfg, output):
    """The input ids that `output` shows, in tile order."""
    o, per = output_ids(cfg).index(output), cfg["inputs_per_output"]
    return [f"input_{i}" for i in range(o * per, (o + 1) * per)]


def build(api, cfg, stage, output):
    comp, types = api.comp, api.types
    return comp.Tiles(
        background_color=types.RGBAColor(*cfg["background_color"]),
        tile_aspect_ratio=tuple(cfg["tile_aspect_ratio"]),
        margin=float(cfg["margin"]), padding=float(cfg["padding"]),
        children=[comp.InputStream(input_id=iid) for iid in output_inputs(cfg, output)])
