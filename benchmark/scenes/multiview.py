"""The styled multiview: one Tiles of every input (the Tiles docs page's
props: margin, background), each tile a Rescaler around its InputStream,
styled as the two Rescalers of the View docs page: even tiles with a
rounded white border, odd tiles rounded with a box shadow.

`build(api, cfg, stage, output)` takes the component classes of the
program (`api.comp`: a `scene.components` module; `api.types`: a
`core.types` module). The scene is static: `stage` is not read."""

STAGES = 1


def output_ids(cfg):
    return ["out_0"]


def output_inputs(cfg, output):
    """The input ids that `output` shows, in tile order."""
    return [f"input_{i}" for i in range(cfg["inputs"])]


def tile_style(cfg, index):
    """The style of tile `index`: the configuration's `even` or `odd`."""
    return cfg["style"]["even" if index % 2 == 0 else "odd"]


def build(api, cfg, stage, output):
    comp, types = api.comp, api.types
    tiles = []
    for i, iid in enumerate(output_inputs(cfg, output)):
        s = tile_style(cfg, i)
        tiles.append(comp.Rescaler(
            child=comp.InputStream(input_id=iid),
            border_radius=comp.BorderRadius(*[float(s["border_radius"])] * 4),
            border_width=float(s.get("border_width", 0.0)),
            border_color=types.RGBAColor(*s.get("border_color", (0, 0, 0, 0))),
            box_shadow=[comp.BoxShadow(float(b["offset_x"]), float(b["offset_y"]),
                                       float(b["blur_radius"]), types.RGBAColor(*b["color"]))
                        for b in s.get("box_shadow", [])]))
    return comp.Tiles(
        background_color=types.RGBAColor(*cfg["background_color"]),
        tile_aspect_ratio=tuple(cfg["tile_aspect_ratio"]),
        margin=float(cfg["margin"]), padding=float(cfg["padding"]), children=tiles)
