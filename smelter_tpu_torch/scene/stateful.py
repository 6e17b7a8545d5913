"""Stateful scene tree: Component -> StatefulComponent (diffed by component id,
carrying transition state) -> NestedLayout per frame.

Python re-implementation of the reference scene machinery:
  - stateful diff + transitions: `smelter-render/src/scene/{view,tiles,rescaler}_component.rs`
  - View layout: `scene/view_component/layout.rs`
  - Tiles layout: `scene/tiles_component/{tiles,layout}.rs` (+ id-tracked tile
    interpolation from `tiles_component/interpolation.rs`)
  - Rescaler layout: `scene/rescaler_component/layout.rs`
  - absolute positioning / content plumbing: `scene/layout.rs`
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from smelter_tpu_torch.core.types import RGBAColor, Resolution
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.components import (
    AbsolutePosition,
    HorizontalAlign,
    Overflow,
    Padding,
    Position,
    RescaleMode,
    StaticPosition,
    VerticalAlign,
    ViewDirection,
    position_with_outer,
)
from smelter_tpu_torch.scene.layout_types import (
    BorderRadius,
    BoxShadow,
    ChildNodeContent,
    ColorContent,
    Crop,
    Mask,
    NestedLayout,
    NoneContent,
)
from smelter_tpu_torch.scene.transition import (
    TransitionState,
    interpolate,
    interpolate_opt,
)


class SceneError(Exception):
    pass


# ---------------------------------------------------------------------------
# interpolation helpers
# ---------------------------------------------------------------------------


def _interp_position(start: Position, end: Position, s: float) -> Position:
    if isinstance(start, StaticPosition) and isinstance(end, StaticPosition):
        return StaticPosition(
            width=interpolate_opt(start.width, end.width, s),
            height=interpolate_opt(start.height, end.height, s),
        )
    if isinstance(start, AbsolutePosition) and isinstance(end, AbsolutePosition):
        def offs(a, b):
            if a is None or b is None:
                return b
            return interpolate(a, b, s)

        # matching offset kinds interpolate; mismatched jump to end
        top = offs(start.top, end.top) if (start.top is None) == (end.top is None) else end.top
        bottom = (
            offs(start.bottom, end.bottom)
            if (start.bottom is None) == (end.bottom is None)
            else end.bottom
        )
        left = (
            offs(start.left, end.left)
            if (start.left is None) == (end.left is None)
            else end.left
        )
        right = (
            offs(start.right, end.right)
            if (start.right is None) == (end.right is None)
            else end.right
        )
        return AbsolutePosition(
            width=interpolate_opt(start.width, end.width, s),
            height=interpolate_opt(start.height, end.height, s),
            top=top,
            bottom=bottom,
            left=left,
            right=right,
            rotation_degrees=interpolate(start.rotation_degrees, end.rotation_degrees, s),
        )
    return end


def _interp_radius(start: BorderRadius, end: BorderRadius, s: float) -> BorderRadius:
    return BorderRadius(
        interpolate(start.top_left, end.top_left, s),
        interpolate(start.top_right, end.top_right, s),
        interpolate(start.bottom_right, end.bottom_right, s),
        interpolate(start.bottom_left, end.bottom_left, s),
    )


def _interp_shadows(
    start: List[BoxShadow], end: List[BoxShadow], s: float
) -> List[BoxShadow]:
    out = []
    for i, e in enumerate(end):
        if i < len(start):
            st = start[i]
            out.append(
                BoxShadow(
                    offset_x=interpolate(st.offset_x, e.offset_x, s),
                    offset_y=interpolate(st.offset_y, e.offset_y, s),
                    blur_radius=interpolate(st.blur_radius, e.blur_radius, s),
                    color=e.color,
                )
            )
        else:
            out.append(e)
    return out


def _interp_padding(start: Padding, end: Padding, s: float) -> Padding:
    return Padding(
        interpolate(start.top, end.top, s),
        interpolate(start.right, end.right, s),
        interpolate(start.bottom, end.bottom, s),
        interpolate(start.left, end.left, s),
    )


# ---------------------------------------------------------------------------
# stateful leaf components
# ---------------------------------------------------------------------------


@dataclass
class StatefulInputStream:
    component: comp.InputStream
    size: Tuple[float, float] = (0.0, 0.0)

    def component_id(self):
        return self.component.id

    def width(self, pts):
        return self.size[0]

    def height(self, pts):
        return self.size[1]


@dataclass
class StatefulText:
    component: comp.Text
    size: Tuple[float, float]  # measured at build time

    def component_id(self):
        return self.component.id

    def width(self, pts):
        return self.size[0]

    def height(self, pts):
        return self.size[1]


@dataclass
class StatefulImage:
    component: comp.Image
    natural_size: Tuple[float, float]

    def component_id(self):
        return self.component.id

    def size(self) -> Tuple[float, float]:
        w, h = self.component.width, self.component.height
        nw, nh = self.natural_size
        if w is not None and h is not None:
            return (w, h)
        if w is not None:
            return (w, w * nh / nw if nw else 0.0)
        if h is not None:
            return (h * nw / nh if nh else 0.0, h)
        return (nw, nh)

    def width(self, pts):
        return self.size()[0]

    def height(self, pts):
        return self.size()[1]


@dataclass
class StatefulShader:
    component: comp.Shader
    children: List["StatefulComponent"]

    def component_id(self):
        return self.component.id

    def width(self, pts):
        return self.component.width

    def height(self, pts):
        return self.component.height


@dataclass
class StatefulWebView:
    component: comp.WebView
    children: List["StatefulComponent"]
    size: Tuple[float, float] = (0.0, 0.0)

    def component_id(self):
        return self.component.id

    def width(self, pts):
        return self.size[0]

    def height(self, pts):
        return self.size[1]


# ---------------------------------------------------------------------------
# stateful layout components
# ---------------------------------------------------------------------------


@dataclass
class ViewParams:
    id: Optional[str]
    direction: ViewDirection
    position: Position
    overflow: Overflow
    background_color: RGBAColor
    border_radius: BorderRadius
    border_width: float
    border_color: RGBAColor
    box_shadow: List[BoxShadow]
    padding: Padding

    def interpolate(self, end: "ViewParams", s: float) -> "ViewParams":
        return ViewParams(
            id=end.id,
            direction=end.direction,
            position=_interp_position(self.position, end.position, s),
            overflow=end.overflow,
            background_color=end.background_color,
            border_radius=_interp_radius(self.border_radius, end.border_radius, s),
            border_width=interpolate(self.border_width, end.border_width, s),
            border_color=end.border_color,
            box_shadow=_interp_shadows(self.box_shadow, end.box_shadow, s),
            padding=_interp_padding(self.padding, end.padding, s),
        )

    def __eq__(self, other):
        if not isinstance(other, ViewParams):
            return NotImplemented
        return (
            self.id == other.id
            and self.direction == other.direction
            and self.position == other.position
            and self.overflow == other.overflow
            and self.background_color == other.background_color
            and self.border_radius == other.border_radius
            and self.border_width == other.border_width
            and self.border_color == other.border_color
            and self.box_shadow == other.box_shadow
            and self.padding == other.padding
        )


@dataclass
class StatefulView:
    start: Optional[ViewParams]
    end: ViewParams
    transition: Optional[TransitionState]
    children: List["StatefulComponent"]

    def component_id(self):
        return self.end.id

    def params(self, pts: float) -> ViewParams:
        if self.transition is None or self.start is None:
            return self.end
        return self.start.interpolate(self.end, self.transition.state(pts))

    def position(self, pts: float) -> Position:
        p = self.params(pts)
        return position_with_outer(p.position, p.border_width, p.padding)

    def width(self, pts):
        return _position_width(self.position(pts))

    def height(self, pts):
        return _position_height(self.position(pts))

    def layout(self, size: Tuple[float, float], pts: float) -> NestedLayout:
        return _view_layout(self.params(pts), size, self.children, pts)


@dataclass
class TilesParams:
    id: Optional[str]
    width: Optional[float]
    height: Optional[float]
    background_color: RGBAColor
    tile_aspect_ratio: Tuple[int, int]
    margin: float
    padding: float
    horizontal_align: HorizontalAlign
    vertical_align: VerticalAlign


@dataclass
class Tile:
    id: Union[str, int]  # component id or synthetic index
    top: float
    left: float
    width: float
    height: float


@dataclass
class StatefulTiles:
    start: Optional[Tuple[List[Optional[Tile]], Tuple[float, float]]]
    last_layout: Optional[Tuple[List[Optional[Tile]], Tuple[float, float]]]
    transition: Optional[TransitionState]
    params: TilesParams
    children: List["StatefulComponent"]

    def component_id(self):
        return self.params.id

    def position(self, pts: float) -> Position:
        return StaticPosition(self.params.width, self.params.height)

    def width(self, pts):
        return self.params.width

    def height(self, pts):
        return self.params.height

    def tiles(self, size: Tuple[float, float], pts: float) -> List[Optional[Tile]]:
        end = _compute_tiles(self.params, size, self.children)
        if self.start is None or self.transition is None:
            return end
        start_tiles, start_size = self.start
        start_tiles = _resize_tiles(start_tiles, start_size, size)
        return _interp_tiles(start_tiles, end, self.transition.state(pts))

    def layout(self, size: Tuple[float, float], pts: float) -> NestedLayout:
        tiles = self.tiles(size, pts)
        layout = _layout_tiles(
            tiles, size, self.children, pts, self.params.background_color
        )
        self.last_layout = (tiles, size)
        return layout


@dataclass
class RescalerParams:
    id: Optional[str]
    position: Position
    mode: RescaleMode
    horizontal_align: HorizontalAlign
    vertical_align: VerticalAlign
    border_radius: BorderRadius
    border_width: float
    border_color: RGBAColor
    box_shadow: List[BoxShadow]

    def interpolate(self, end: "RescalerParams", s: float) -> "RescalerParams":
        return RescalerParams(
            id=end.id,
            position=_interp_position(self.position, end.position, s),
            mode=end.mode,
            horizontal_align=end.horizontal_align,
            vertical_align=end.vertical_align,
            border_radius=_interp_radius(self.border_radius, end.border_radius, s),
            border_width=interpolate(self.border_width, end.border_width, s),
            border_color=end.border_color,
            box_shadow=_interp_shadows(self.box_shadow, end.box_shadow, s),
        )


@dataclass
class StatefulRescaler:
    start: Optional[RescalerParams]
    end: RescalerParams
    transition: Optional[TransitionState]
    child: "StatefulComponent"

    def component_id(self):
        return self.end.id

    def params(self, pts: float) -> RescalerParams:
        if self.transition is None or self.start is None:
            return self.end
        return self.start.interpolate(self.end, self.transition.state(pts))

    def position(self, pts: float) -> Position:
        p = self.params(pts)
        return position_with_outer(p.position, p.border_width, Padding())

    def width(self, pts):
        return _position_width(self.position(pts))

    def height(self, pts):
        return _position_height(self.position(pts))

    @property
    def children(self) -> List["StatefulComponent"]:
        return [self.child]

    def layout(self, size: Tuple[float, float], pts: float) -> NestedLayout:
        return _rescaler_layout(self.params(pts), size, self.child, pts)


StatefulLayoutComponent = Union[StatefulView, StatefulTiles, StatefulRescaler]
StatefulComponent = Union[
    StatefulInputStream,
    StatefulText,
    StatefulImage,
    StatefulShader,
    StatefulWebView,
    StatefulView,
    StatefulTiles,
    StatefulRescaler,
]

LAYOUT_TYPES = (StatefulView, StatefulTiles, StatefulRescaler)


def _position_width(p: Position) -> Optional[float]:
    return p.width


def _position_height(p: Position) -> Optional[float]:
    return p.height


def is_layout(c: StatefulComponent) -> bool:
    return isinstance(c, LAYOUT_TYPES)


def component_width(c: StatefulComponent, pts: float) -> Optional[float]:
    return c.width(pts)


def component_height(c: StatefulComponent, pts: float) -> Optional[float]:
    return c.height(pts)


def component_children(c: StatefulComponent) -> List[StatefulComponent]:
    if isinstance(c, (StatefulShader, StatefulWebView)):
        return c.children
    if isinstance(c, StatefulView):
        return c.children
    if isinstance(c, StatefulTiles):
        return c.children
    if isinstance(c, StatefulRescaler):
        return [c.child]
    return []


def node_children(c: StatefulComponent) -> List[StatefulComponent]:
    """Non-layout descendants reachable through layout components only
    (reference `StatefulLayoutComponent::node_children`)."""
    out = []
    for child in component_children(c):
        if is_layout(child):
            out.extend(node_children(child))
        else:
            out.append(child)
    return out


def layout_content(c: StatefulComponent, index: int):
    """LayoutContent for a non-layout child (reference layout.rs:layout_content)."""
    if is_layout(c):
        return NoneContent()
    if isinstance(c, StatefulInputStream):
        return ChildNodeContent(index, c.size[0], c.size[1])
    if isinstance(c, StatefulShader):
        return ChildNodeContent(index, c.component.width, c.component.height)
    if isinstance(c, StatefulWebView):
        return ChildNodeContent(index, c.size[0], c.size[1])
    if isinstance(c, StatefulImage):
        w, h = c.size()
        return ChildNodeContent(index, w, h)
    if isinstance(c, StatefulText):
        return ChildNodeContent(index, c.size[0], c.size[1])
    raise SceneError(f"unexpected component {type(c)}")


def update_state(
    c: StatefulComponent, input_resolutions: Sequence[Optional[Resolution]]
) -> None:
    """Propagate input stream resolutions into the tree
    (reference layout.rs `update_state`)."""
    offset = 0
    for child in component_children(c):
        if isinstance(child, StatefulInputStream):
            res = input_resolutions[offset] if offset < len(input_resolutions) else None
            child.size = (float(res.width), float(res.height)) if res else (0.0, 0.0)
            offset += 1
        elif is_layout(child):
            count = len(node_children(child))
            update_state(child, input_resolutions[offset : offset + count])
            offset += count
        else:
            offset += 1


# ---------------------------------------------------------------------------
# View layout (scene/view_component/layout.rs)
# ---------------------------------------------------------------------------


def _view_layout(
    params: ViewParams,
    size: Tuple[float, float],
    children: List[StatefulComponent],
    pts: float,
) -> NestedLayout:
    width, height = size
    content_w = max(width - 2.0 * params.border_width, 0.0)
    content_h = max(height - 2.0 * params.border_width, 0.0)
    border_radius = params.border_radius.clip_to_size(width, height)
    static_child_size = _static_child_size(params, (content_w, content_h), children, pts)

    if params.overflow == Overflow.VISIBLE:
        scale, mask = 1.0, None
    elif params.overflow == Overflow.HIDDEN:
        scale = 1.0
        mask = Mask(
            radius=border_radius.minus(params.border_width),
            top=params.border_width,
            left=params.border_width,
            width=content_w,
            height=content_h,
        )
    else:  # FIT
        scale = _fit_scale(params, (content_w, content_h), children, pts)
        mask = Mask(
            radius=border_radius.minus(params.border_width),
            top=params.border_width,
            left=params.border_width,
            width=content_w,
            height=content_h,
        )

    static_offset = params.border_width / scale if scale else 0.0
    out_children: List[NestedLayout] = []
    for child in children:
        position = (
            child.position(pts)
            if is_layout(child)
            else StaticPosition(child.width(pts), child.height(pts))
        )
        if isinstance(position, StaticPosition):
            layout, static_offset = _layout_static_child(
                params,
                child,
                position.width,
                position.height,
                static_offset,
                static_child_size,
                (content_w, content_h),
                params.border_width / scale if scale else 0.0,
                pts,
            )
            out_children.append(layout)
        else:
            out_children.append(
                layout_absolute_position_child(child, position, size, pts)
            )
    return NestedLayout(
        top=0.0,
        left=0.0,
        width=width,
        height=height,
        rotation_degrees=0.0,
        scale_x=scale,
        scale_y=scale,
        crop=None,
        mask=mask,
        content=ColorContent(params.background_color),
        child_nodes_count=sum(c.child_nodes_count for c in out_children),
        children=out_children,
        border_width=params.border_width,
        border_color=params.border_color,
        border_radius=border_radius,
        box_shadow=list(params.box_shadow),
    )


def _static_children(
    children: List[StatefulComponent], pts: float
) -> List[StatefulComponent]:
    out = []
    for child in children:
        if is_layout(child) and isinstance(child.position(pts), AbsolutePosition):
            continue
        out.append(child)
    return out


def _static_child_size(params, content_size, children, pts) -> float:
    content_w, content_h = content_size
    if params.direction == ViewDirection.ROW:
        max_size = content_w - params.padding.horizontal
    else:
        max_size = content_h - params.padding.vertical
    statics = _static_children(children, pts)
    unknown = 0
    total = 0.0
    for child in statics:
        v = child.width(pts) if params.direction == ViewDirection.ROW else child.height(pts)
        if v is None:
            unknown += 1
        else:
            total += v
    if unknown == 0:
        return 0.0
    return max(0.0, (max_size - total) / unknown)


def _fit_scale(params, content_size, children, pts) -> float:
    content_w, content_h = content_size
    statics = _static_children(children, pts)
    sum_size = 0.0
    max_alt_child = 1e-9
    for child in statics:
        if params.direction == ViewDirection.ROW:
            sum_size += child.width(pts) or 0.0
            max_alt_child = max(max_alt_child, child.height(pts) or 0.0)
        else:
            sum_size += child.height(pts) or 0.0
            max_alt_child = max(max_alt_child, child.width(pts) or 0.0)
    sum_size = max(sum_size, 1e-9)
    if params.direction == ViewDirection.ROW:
        max_size, max_alt = content_w, content_h
    else:
        max_size, max_alt = content_h, content_w
    return min(1.0, min(max_size / sum_size, max_alt / max_alt_child))


def _layout_static_child(
    params,
    child,
    decl_width,
    decl_height,
    static_offset,
    static_child_size,
    parent_size,
    parent_border_width,
    pts,
):
    parent_w, parent_h = parent_size
    if params.direction == ViewDirection.ROW:
        width = decl_width if decl_width is not None else static_child_size
        height = (
            decl_height
            if decl_height is not None
            else parent_h - params.padding.vertical
        )
        top = parent_border_width + params.padding.top
        left = static_offset + params.padding.left
        static_offset += width
    else:
        height = decl_height if decl_height is not None else static_child_size
        width = (
            decl_width
            if decl_width is not None
            else parent_w - params.padding.horizontal
        )
        top = static_offset + params.padding.top
        left = parent_border_width + params.padding.left
        static_offset += height

    if is_layout(child):
        inner = child.layout((width, height), pts)
        layout = NestedLayout(
            top=top,
            left=left,
            width=width,
            height=height,
            content=NoneContent(),
            child_nodes_count=inner.child_nodes_count,
            children=[inner],
        )
    else:
        layout = NestedLayout(
            top=top,
            left=left,
            width=width,
            height=height,
            content=layout_content(child, 0),
            child_nodes_count=1,
        )
    return layout, static_offset


def layout_absolute_position_child(
    child: StatefulComponent,
    position: AbsolutePosition,
    parent_size: Tuple[float, float],
    pts: float,
) -> NestedLayout:
    parent_w, parent_h = parent_size
    width = position.width if position.width is not None else parent_w
    height = position.height if position.height is not None else parent_h
    if position.bottom is not None:
        top = parent_h - position.bottom - height
    else:
        top = position.top if position.top is not None else 0.0
    if position.right is not None:
        left = parent_w - position.right - width
    else:
        left = position.left if position.left is not None else 0.0

    content = layout_content(child, 0)
    if is_layout(child):
        inner = child.layout((width, height), pts)
        count = inner.child_nodes_count + (
            1 if isinstance(content, ChildNodeContent) else 0
        )
        return NestedLayout(
            top=top,
            left=left,
            width=width,
            height=height,
            rotation_degrees=position.rotation_degrees,
            content=content,
            child_nodes_count=count,
            children=[inner],
        )
    return NestedLayout(
        top=top,
        left=left,
        width=width,
        height=height,
        rotation_degrees=position.rotation_degrees,
        content=content,
        child_nodes_count=1 if isinstance(content, ChildNodeContent) else 0,
    )


# ---------------------------------------------------------------------------
# Tiles layout (scene/tiles_component/{tiles,layout}.rs)
# ---------------------------------------------------------------------------


def _tile_size(params: TilesParams, rows: int, cols: int, size) -> Tuple[float, float]:
    layout_w, layout_h = size
    x_padding = cols * 2.0 * params.padding
    y_padding = rows * 2.0 * params.padding
    x_margin = (cols + 1.0) * params.margin
    y_margin = (rows + 1.0) * params.margin
    ar_w, ar_h = params.tile_aspect_ratio
    x_scale = max(layout_w - x_padding - x_margin, 0.0) / cols / ar_w
    y_scale = max(layout_h - y_padding - y_margin, 0.0) / rows / ar_h
    scale = min(x_scale, y_scale)
    return (ar_w * scale, ar_h * scale)


def _optimal_rows_cols(params: TilesParams, n: int, size) -> Tuple[int, int]:
    best = (1, n)
    best_w = 0.0
    for rows in range(1, n + 1):
        cols = -(-n // rows)
        w, _ = _tile_size(params, rows, cols, size)
        if w > best_w:
            best = (rows, cols)
            best_w = w
    return best


def _tiles_positions(params: TilesParams, n: int, rows: int, cols: int, tile, size):
    tile_w, tile_h = tile
    layout_w, layout_h = size
    out = []
    add_y = (
        layout_h
        - (tile_h + 2.0 * params.padding) * rows
        - params.margin * (rows + 1.0)
    )
    if params.vertical_align == VerticalAlign.TOP:
        top_pad, just_y = 0.0, 0.0
    elif params.vertical_align == VerticalAlign.CENTER:
        top_pad, just_y = add_y / 2.0, 0.0
    elif params.vertical_align == VerticalAlign.BOTTOM:
        top_pad, just_y = add_y, 0.0
    else:
        top_pad, just_y = 0.0, add_y / (rows + 1.0)

    top = top_pad + just_y + params.padding + params.margin
    for row in range(rows):
        in_row = cols if row < rows - 1 else n - (rows - 1) * cols
        add_x = (
            layout_w
            - (tile_w + 2.0 * params.padding) * in_row
            - params.margin * (in_row + 1.0)
        )
        if params.horizontal_align == HorizontalAlign.LEFT:
            left_pad, just_x = 0.0, 0.0
        elif params.horizontal_align == HorizontalAlign.RIGHT:
            left_pad, just_x = add_x, 0.0
        elif params.horizontal_align == HorizontalAlign.JUSTIFIED:
            left_pad, just_x = 0.0, add_x / (in_row + 1.0)
        else:
            left_pad, just_x = add_x / 2.0, 0.0
        left = left_pad + just_x + params.margin + params.padding
        for _ in range(in_row):
            out.append((top, left, tile_w, tile_h))
            left += tile_w + params.margin + params.padding * 2.0 + just_x
        top += tile_h + params.margin + params.padding * 2.0 + just_y
    return out


def _compute_tiles(
    params: TilesParams, size, children: List[StatefulComponent]
) -> List[Optional[Tile]]:
    n = len(children)
    if n == 0:
        return []
    rows, cols = _optimal_rows_cols(params, n, size)
    tile_size = _tile_size(params, rows, cols, size)
    positions = _tiles_positions(params, n, rows, cols, tile_size, size)
    out: List[Optional[Tile]] = []
    index = 0
    for pos, child in zip(positions, children):
        cid = child.component_id()
        if cid is None:
            tid: Union[str, int] = index
            index += 1
        else:
            tid = f"#{cid}"
        out.append(Tile(id=tid, top=pos[0], left=pos[1], width=pos[2], height=pos[3]))
    return out


def _resize_tiles(tiles, original_size, desired_size):
    ow, oh = original_size
    dw, dh = desired_size
    scale = min(dw / ow if ow else 1.0, dh / oh if oh else 1.0)
    return [
        None
        if t is None
        else Tile(t.id, t.top * scale, t.left * scale, t.width * scale, t.height * scale)
        for t in tiles
    ]


def _interp_tiles(
    start: List[Optional[Tile]], end: List[Optional[Tile]], s: float
) -> List[Optional[Tile]]:
    if s >= 1.0:
        return end
    start_by_id = {t.id: t for t in start if t is not None}
    end_ids = {t.id for t in end if t is not None}
    out: List[Optional[Tile]] = []
    for tile in end:
        if tile is None:
            out.append(None)
            continue
        old = start_by_id.get(tile.id)
        if old is not None:
            out.append(
                Tile(
                    tile.id,
                    interpolate(old.top, tile.top, s),
                    interpolate(old.left, tile.left, s),
                    interpolate(old.width, tile.width, s),
                    interpolate(old.height, tile.height, s),
                )
            )
            continue
        # new tile: hide it until transition end if some surviving old tile
        # occupied the same position
        occupier = next(
            (
                t
                for t in start
                if t is not None
                and abs(t.top - tile.top) <= 1e-3
                and abs(t.left - tile.left) <= 1e-3
                and abs(t.width - tile.width) <= 1e-3
                and abs(t.height - tile.height) <= 1e-3
            ),
            None,
        )
        if occupier is not None and occupier.id in end_ids:
            out.append(None)
        else:
            out.append(tile)
    return out


def _fit_into_tile(tile: Tile, child: StatefulComponent, pts: float) -> Tile:
    w = child.width(pts)
    h = child.height(pts)
    if w is None or h is None or w <= 0 or h <= 0:
        return tile
    scale = min(tile.width / w, tile.height / h)
    return Tile(
        id=tile.id,
        top=tile.top + (tile.height - scale * h) / 2.0,
        left=tile.left + (tile.width - scale * w) / 2.0,
        width=scale * w,
        height=scale * h,
    )


def _layout_tiles(tiles, size, children, pts, background_color) -> NestedLayout:
    out_children = []
    for child, tile in zip(children, tiles):
        if tile is None:
            count = (
                len(node_children(child)) if is_layout(child) else 1
            )
            out_children.append(NestedLayout.child_nodes_placeholder(count))
            continue
        if is_layout(child):
            inner = child.layout((tile.width, tile.height), pts)
            out_children.append(
                NestedLayout(
                    top=tile.top,
                    left=tile.left,
                    width=tile.width,
                    height=tile.height,
                    content=NoneContent(),
                    child_nodes_count=inner.child_nodes_count,
                    children=[inner],
                )
            )
        else:
            fitted = _fit_into_tile(tile, child, pts)
            out_children.append(
                NestedLayout(
                    top=fitted.top,
                    left=fitted.left,
                    width=fitted.width,
                    height=fitted.height,
                    content=layout_content(child, 0),
                    child_nodes_count=1,
                )
            )
    width, height = size
    return NestedLayout(
        top=0.0,
        left=0.0,
        width=width,
        height=height,
        content=ColorContent(background_color),
        child_nodes_count=sum(c.child_nodes_count for c in out_children),
        children=out_children,
    )


# ---------------------------------------------------------------------------
# Rescaler layout (scene/rescaler_component/layout.rs)
# ---------------------------------------------------------------------------


def _rescaler_layout(
    params: RescalerParams,
    size: Tuple[float, float],
    child: StatefulComponent,
    pts: float,
) -> NestedLayout:
    width, height = size
    content_w = max(width - 2.0 * params.border_width, 0.0)
    content_h = max(height - 2.0 * params.border_width, 0.0)
    border_radius = params.border_radius.clip_to_size(width, height)
    child_w = child.width(pts)
    child_h = child.height(pts)
    if child_w is None and child_h is None:
        scale = 1.0
    elif child_w is None:
        scale = content_h / child_h if child_h else 1.0
    elif child_h is None:
        scale = content_w / child_w if child_w else 1.0
    else:
        if params.mode == RescaleMode.FIT:
            scale = min(
                content_w / child_w if child_w else 1.0,
                content_h / child_h if child_h else 1.0,
            )
        else:
            scale = max(
                content_w / child_w if child_w else 1.0,
                content_h / child_h if child_h else 1.0,
            )

    if is_layout(child):
        inner = child.layout(
            (
                child_w if child_w is not None else (content_w / scale if scale else 0.0),
                child_h if child_h is not None else (content_h / scale if scale else 0.0),
            ),
            pts,
        )
        content = NoneContent()
        inner_children = [inner]
        child_nodes_count = inner.child_nodes_count
    else:
        content = layout_content(child, 0)
        inner_children = []
        child_nodes_count = 1

    if params.vertical_align == VerticalAlign.TOP:
        top = 0.0
    elif params.vertical_align == VerticalAlign.BOTTOM:
        top = content_h - child_h * scale if child_h is not None else 0.0
    else:
        top = (content_h - child_h * scale) / 2.0 if child_h is not None else 0.0
    if params.horizontal_align == HorizontalAlign.LEFT:
        left = 0.0
    elif params.horizontal_align == HorizontalAlign.RIGHT:
        left = content_w - child_w * scale if child_w is not None else 0.0
    else:
        left = (content_w - child_w * scale) / 2.0 if child_w is not None else 0.0

    inner_w = child_w * scale if child_w is not None else content_w
    inner_h = child_h * scale if child_h is not None else content_h

    return NestedLayout(
        top=0.0,
        left=0.0,
        width=content_w + params.border_width * 2.0,
        height=content_h + params.border_width * 2.0,
        mask=Mask(
            radius=border_radius.minus(params.border_width),
            top=params.border_width,
            left=params.border_width,
            width=content_w,
            height=content_h,
        ),
        content=NoneContent(),
        children=[
            NestedLayout(
                top=top + params.border_width,
                left=left + params.border_width,
                width=inner_w,
                height=inner_h,
                scale_x=scale,
                scale_y=scale,
                content=content,
                child_nodes_count=child_nodes_count,
                children=inner_children,
            )
        ],
        child_nodes_count=child_nodes_count,
        border_width=params.border_width,
        border_color=params.border_color,
        border_radius=border_radius,
        box_shadow=list(params.box_shadow),
    )
