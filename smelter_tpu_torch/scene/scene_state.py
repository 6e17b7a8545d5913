"""SceneState: Component tree -> StatefulComponent tree (diffed by id) ->
Node tree per output.

Python re-implementation of `smelter-render/src/scene/scene_state.rs`:
`update_scene` recalculates all outputs' layouts at the last render PTS (so
Tiles can snapshot `last_layout`), gathers previous components by id, builds
the new stateful tree (picking up transition state), and emits the Node tree
that the render graph compiles from.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

from smelter_tpu_torch.core.types import Resolution
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.scene.stateful import (
    RescalerParams,
    SceneError,
    StatefulComponent,
    StatefulImage,
    StatefulInputStream,
    StatefulRescaler,
    StatefulShader,
    StatefulText,
    StatefulTiles,
    StatefulView,
    StatefulWebView,
    TilesParams,
    ViewParams,
    component_children,
    is_layout,
)
from smelter_tpu_torch.scene.transition import TransitionState


@dataclass
class BuildCtx:
    prev_state: Dict[str, StatefulComponent]
    last_render_pts: float
    input_resolutions: Dict[str, Resolution]
    # host-side services injected by the renderer:
    text_measurer: Callable[[comp.Text], Tuple[float, float]]
    image_store: Callable[[str], Tuple[float, float]]  # image_id -> natural size
    # web renderer instance_id -> declared resolution (0,0 when unregistered:
    # the node then renders transparent — web_renderer_fallback.rs)
    web_size: Callable[[str], Tuple[float, float]] = lambda _id: (0.0, 0.0)


# --- node tree ----------------------------------------------------------------


@dataclass
class Node:
    params: object  # one of the *NodeParams below
    children: List["Node"] = field(default_factory=list)


@dataclass
class InputStreamNode:
    input_id: str


@dataclass
class ShaderNode:
    shader_id: str
    shader_param: Optional[object]
    size: Tuple[float, float]


@dataclass
class WebNode:
    instance_id: str
    children_ids: List[str]


@dataclass
class ImageNode:
    image_id: str
    width: Optional[float]
    height: Optional[float]


@dataclass
class TextNode:
    component: comp.Text
    size: Tuple[float, float]


@dataclass
class LayoutNode:
    """Layout provider: stateful layout root + forced size."""

    root: StatefulComponent  # one of the layout stateful types
    size: Tuple[float, float]

    def layouts(self, pts: float, input_resolutions):
        from smelter_tpu_torch.scene.stateful import update_state

        update_state(self.root, input_resolutions)
        return self.root.layout(self.size, pts)

    def resolution(self, pts: float) -> Resolution:
        pos = self.root.position(pts)
        w = pos.width if pos.width is not None else self.size[0]
        h = pos.height if pos.height is not None else self.size[1]
        return Resolution(int(round(w)), int(round(h)))


@dataclass
class OutputScene:
    output_id: str
    root: comp.Component
    resolution: Resolution


@dataclass
class OutputNode:
    output_id: str
    node: Node
    resolution: Resolution


# --- scene state ---------------------------------------------------------------


class SceneState:
    def __init__(self) -> None:
        self._output_scenes: Dict[str, OutputScene] = {}
        self._output_roots: Dict[str, Tuple[StatefulComponent, Resolution]] = {}
        self.last_pts: float = 0.0
        self._input_resolutions: Dict[str, Resolution] = {}

    def register_render_event(
        self, pts: float, input_resolutions: Dict[str, Resolution]
    ) -> None:
        self.last_pts = pts
        self._input_resolutions = dict(input_resolutions)

    def unregister_output(self, output_id: str) -> None:
        self._output_scenes.pop(output_id, None)
        self._output_roots.pop(output_id, None)

    def update_scene(
        self,
        scene: OutputScene,
        text_measurer: Callable[[comp.Text], Tuple[float, float]],
        image_store: Callable[[str], Tuple[float, float]],
        web_size: Callable[[str], Tuple[float, float]] = lambda _id: (0.0, 0.0),
    ) -> OutputNode:
        validate_scene(scene, self._output_scenes)
        # refresh layouts at last pts so Tiles snapshots last_layout
        for root, resolution in self._output_roots.values():
            _recalculate_layout(
                root,
                (float(resolution.width), float(resolution.height)),
                self.last_pts,
                False,
            )
        prev: Dict[str, StatefulComponent] = {}
        existing = self._output_roots.get(scene.output_id)
        if existing is not None:
            _gather_components_with_id(existing[0], prev)
        ctx = BuildCtx(
            prev_state=prev,
            last_render_pts=self.last_pts,
            input_resolutions=self._input_resolutions,
            text_measurer=text_measurer,
            image_store=image_store,
            web_size=web_size,
        )
        root = build_stateful(scene.root, ctx)
        node = _intermediate_to_node(
            _intermediate_node(root),
            (float(scene.resolution.width), float(scene.resolution.height)),
            self.last_pts,
        )
        self._output_scenes[scene.output_id] = scene
        self._output_roots[scene.output_id] = (root, scene.resolution)
        return OutputNode(scene.output_id, node, scene.resolution)


def validate_scene(scene: OutputScene, _others: Dict[str, OutputScene]) -> None:
    """Reject duplicate component ids inside one scene
    (reference scene.rs:224-227 + scene/validation.rs)."""
    seen: set = set()

    def visit(c: comp.Component):
        cid = getattr(c, "id", None)
        if cid is not None:
            if cid in seen:
                raise SceneError(f"duplicate component id {cid!r}")
            seen.add(cid)
        for child in _component_children(c):
            visit(child)

    visit(scene.root)


def _component_children(c: comp.Component) -> List[comp.Component]:
    if isinstance(c, (comp.View, comp.Tiles, comp.Shader, comp.WebView)):
        return c.children
    if isinstance(c, comp.Rescaler):
        return [c.child]
    return []


# --- building the stateful tree --------------------------------------------------


def build_stateful(c: comp.Component, ctx: BuildCtx) -> StatefulComponent:
    if isinstance(c, comp.InputStream):
        res = ctx.input_resolutions.get(c.input_id)
        size = (float(res.width), float(res.height)) if res else (0.0, 0.0)
        return StatefulInputStream(component=c, size=size)
    if isinstance(c, comp.Text):
        return StatefulText(component=c, size=ctx.text_measurer(c))
    if isinstance(c, comp.Image):
        return StatefulImage(component=c, natural_size=ctx.image_store(c.image_id))
    if isinstance(c, comp.Shader):
        return StatefulShader(
            component=c, children=[build_stateful(ch, ctx) for ch in c.children]
        )
    if isinstance(c, comp.WebView):
        return StatefulWebView(
            component=c,
            children=[build_stateful(ch, ctx) for ch in c.children],
            size=ctx.web_size(c.instance_id),
        )
    if isinstance(c, comp.View):
        return _build_view(c, ctx)
    if isinstance(c, comp.Tiles):
        return _build_tiles(c, ctx)
    if isinstance(c, comp.Rescaler):
        return _build_rescaler(c, ctx)
    raise SceneError(f"unknown component {type(c)}")


def _prev_of_type(ctx: BuildCtx, cid: Optional[str], typ):
    if cid is None:
        return None
    prev = ctx.prev_state.get(cid)
    return prev if isinstance(prev, typ) else None


def _make_transition(
    spec: Optional[comp.Transition],
    previous: Optional[TransitionState],
    props_changed: bool,
    last_pts: float,
) -> Optional[TransitionState]:
    interrupt = spec.should_interrupt if spec is not None else False
    return TransitionState.create(spec, previous, props_changed, interrupt, last_pts)


def _build_view(c: comp.View, ctx: BuildCtx) -> StatefulView:
    previous = _prev_of_type(ctx, c.id, StatefulView)
    start = previous.params(ctx.last_render_pts) if previous else None
    end = ViewParams(
        id=c.id,
        direction=c.direction,
        position=c.position,
        overflow=c.overflow,
        background_color=c.background_color,
        border_radius=c.border_radius,
        border_width=c.border_width,
        border_color=c.border_color,
        box_shadow=list(c.box_shadow),
        padding=c.padding,
    )
    props_changed = previous is not None and previous.end != end
    transition = _make_transition(
        c.transition,
        previous.transition if previous else None,
        props_changed,
        ctx.last_render_pts,
    )
    return StatefulView(
        start=start,
        end=end,
        transition=transition,
        children=[build_stateful(ch, ctx) for ch in c.children],
    )


def _build_tiles(c: comp.Tiles, ctx: BuildCtx) -> StatefulTiles:
    previous = _prev_of_type(ctx, c.id, StatefulTiles)
    params = TilesParams(
        id=c.id,
        width=c.width,
        height=c.height,
        background_color=c.background_color,
        tile_aspect_ratio=c.tile_aspect_ratio,
        margin=c.margin,
        padding=c.padding,
        horizontal_align=c.horizontal_align,
        vertical_align=c.vertical_align,
    )
    children = [build_stateful(ch, ctx) for ch in c.children]
    props_changed = False
    if previous is not None:
        order_changed = len(previous.children) != len(children) or any(
            p.component_id() != n.component_id()
            for p, n in zip(previous.children, children)
        )
        props_changed = previous.params != params or order_changed
    transition = _make_transition(
        c.transition,
        previous.transition if previous else None,
        props_changed,
        ctx.last_render_pts,
    )
    return StatefulTiles(
        start=previous.last_layout if previous else None,
        last_layout=previous.last_layout if previous else None,
        transition=transition,
        params=params,
        children=children,
    )


def _build_rescaler(c: comp.Rescaler, ctx: BuildCtx) -> StatefulRescaler:
    previous = _prev_of_type(ctx, c.id, StatefulRescaler)
    start = previous.params(ctx.last_render_pts) if previous else None
    end = RescalerParams(
        id=c.id,
        position=c.position,
        mode=c.mode,
        horizontal_align=c.horizontal_align,
        vertical_align=c.vertical_align,
        border_radius=c.border_radius,
        border_width=c.border_width,
        border_color=c.border_color,
        box_shadow=list(c.box_shadow),
    )
    props_changed = previous is not None and previous.end != end
    transition = _make_transition(
        c.transition,
        previous.transition if previous else None,
        props_changed,
        ctx.last_render_pts,
    )
    return StatefulRescaler(
        start=start,
        end=end,
        transition=transition,
        child=build_stateful(c.child, ctx),
    )


# --- intermediate node / node tree -----------------------------------------------


@dataclass
class _Intermediate:
    kind: str  # input_stream | shader | web | image | text | layout
    component: StatefulComponent
    children: List["_Intermediate"] = field(default_factory=list)


def _intermediate_node(c: StatefulComponent) -> _Intermediate:
    if isinstance(c, StatefulInputStream):
        return _Intermediate("input_stream", c)
    if isinstance(c, StatefulText):
        return _Intermediate("text", c)
    if isinstance(c, StatefulImage):
        return _Intermediate("image", c)
    if isinstance(c, StatefulShader):
        return _Intermediate(
            "shader", c, [_intermediate_node(ch) for ch in c.children]
        )
    if isinstance(c, StatefulWebView):
        return _Intermediate("web", c, [_intermediate_node(ch) for ch in c.children])
    # layout: collapse nested layouts into one layout node whose children are
    # the non-layout descendants (reference intermediate_node flat_map)
    children: List[_Intermediate] = []
    for child in component_children(c):
        node = _intermediate_node(child)
        if node.kind == "layout":
            children.extend(node.children)
        else:
            children.append(node)
    return _Intermediate("layout", c, children)


def _intermediate_to_node(
    node: _Intermediate, forced_size: Optional[Tuple[float, float]], pts: float
) -> Node:
    size = forced_size if forced_size is not None else _node_size(node, pts)
    c = node.component
    if node.kind == "input_stream":
        return Node(InputStreamNode(c.component.input_id))
    if node.kind == "text":
        return Node(TextNode(c.component, c.size))
    if node.kind == "image":
        return Node(
            ImageNode(c.component.image_id, c.component.width, c.component.height)
        )
    if node.kind == "shader":
        return Node(
            ShaderNode(
                c.component.shader_id,
                c.component.shader_param,
                (c.component.width, c.component.height),
            ),
            [_intermediate_to_node(ch, None, pts) for ch in node.children],
        )
    if node.kind == "web":
        ids = [ch.component.component_id() or "" for ch in node.children]
        return Node(
            WebNode(c.component.instance_id, ids),
            [_intermediate_to_node(ch, None, pts) for ch in node.children],
        )
    # layout
    return Node(
        LayoutNode(root=c, size=size),
        [_intermediate_to_node(ch, None, pts) for ch in node.children],
    )


def _node_size(node: _Intermediate, pts: float) -> Tuple[float, float]:
    c = node.component
    if node.kind == "layout":
        pos = c.position(pts)
        if pos.width is None or pos.height is None:
            raise SceneError(
                "Layout node root needs explicit width and height "
                f"(component {c.component_id()!r})"
            )
        return (pos.width, pos.height)
    w = c.width(pts)
    h = c.height(pts)
    return (w or 0.0, h or 0.0)


def _recalculate_layout(
    c: StatefulComponent,
    size: Optional[Tuple[float, float]],
    pts: float,
    parent_is_layout: bool,
) -> None:
    if is_layout(c):
        if not parent_is_layout:
            if size is None:
                w, h = c.width(pts), c.height(pts)
                size = (w, h) if w is not None and h is not None else None
            if size is not None:
                c.layout(size, pts)
        for child in component_children(c):
            _recalculate_layout(child, None, pts, True)
    else:
        for child in component_children(c):
            _recalculate_layout(child, None, pts, False)


def _gather_components_with_id(
    c: StatefulComponent, out: Dict[str, StatefulComponent]
) -> None:
    cid = c.component_id()
    if cid is not None:
        out[cid] = c
    for child in component_children(c):
        _gather_components_with_id(child, out)
