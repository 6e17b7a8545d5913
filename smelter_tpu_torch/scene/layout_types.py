"""Layout tree types: NestedLayout -> flat RenderLayout list.

Pure-Python port-level semantics of the reference layout flattening
(`smelter-render/src/transformations/layout.rs:98-154` and
`layout/flatten.rs`), kept as plain floats - this runs on the host per frame
(cheap), and its numeric output feeds the traced compose program.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import ClassVar, List, Optional, Sequence, Tuple, Union

from smelter_tpu_torch.core.types import RGBAColor, Resolution


@dataclass(frozen=True)
class BorderRadius:
    top_left: float = 0.0
    top_right: float = 0.0
    bottom_right: float = 0.0
    bottom_left: float = 0.0

    ZERO: ClassVar["BorderRadius"]

    def scaled(self, factor: float) -> "BorderRadius":
        return BorderRadius(
            self.top_left * factor,
            self.top_right * factor,
            self.bottom_right * factor,
            self.bottom_left * factor,
        )

    def plus(self, offset: float) -> "BorderRadius":
        """Add offset to every corner, clamped at 0
        (reference `scene/types.rs:141-152` Add<f32> for BorderRadius)."""
        return BorderRadius(
            max(self.top_left + offset, 0.0),
            max(self.top_right + offset, 0.0),
            max(self.bottom_right + offset, 0.0),
            max(self.bottom_left + offset, 0.0),
        )

    def minus(self, offset: float) -> "BorderRadius":
        return self.plus(-offset)

    def clip_to_size(self, width: float, height: float) -> "BorderRadius":
        """Clamp radii so no corner exceeds half the rect size
        (reference `BorderRadius::clip_to_size`)."""
        m = max(min(width, height) / 2.0, 0.0)
        return BorderRadius(
            min(self.top_left, m),
            min(self.top_right, m),
            min(self.bottom_right, m),
            min(self.bottom_left, m),
        )

    def as_tuple(self) -> Tuple[float, float, float, float]:
        return (self.top_left, self.top_right, self.bottom_right, self.bottom_left)


setattr(BorderRadius, "ZERO", BorderRadius())


@dataclass(frozen=True)
class BoxShadow:
    offset_x: float = 0.0
    offset_y: float = 0.0
    blur_radius: float = 0.0
    color: RGBAColor = RGBAColor(0, 0, 0, 255)


@dataclass(frozen=True)
class Crop:
    top: float
    left: float
    width: float
    height: float


@dataclass(frozen=True)
class Mask:
    radius: BorderRadius
    top: float
    left: float
    width: float
    height: float
    # accumulated ancestor rotation: a clip mask introduced by a rotated
    # parent rotates WITH that parent (the reference renders children into
    # the parent's texture, so parent clips are inherently in the rotated
    # frame). Composed the same way layout rotations are — angles add on
    # hoist, the rect rotates about its own centre at render time.
    rotation_degrees: float = 0.0


# --- layout content ---------------------------------------------------------


@dataclass(frozen=True)
class ColorContent:
    color: RGBAColor


@dataclass(frozen=True)
class ChildNodeContent:
    index: int
    width: float = 0.0
    height: float = 0.0


@dataclass(frozen=True)
class NoneContent:
    pass


LayoutContent = Union[ColorContent, ChildNodeContent, NoneContent]


# --- render layout (flat) ----------------------------------------------------


@dataclass(frozen=True)
class RenderColor:
    color: RGBAColor
    border_color: RGBAColor
    border_width: float


@dataclass(frozen=True)
class RenderChildNode:
    index: int
    border_color: RGBAColor
    border_width: float
    crop: Crop


@dataclass(frozen=True)
class RenderBoxShadow:
    color: RGBAColor
    blur_radius: float


RenderContent = Union[RenderColor, RenderChildNode, RenderBoxShadow]


@dataclass(frozen=True)
class RenderLayout:
    top: float
    left: float
    width: float
    height: float
    rotation_degrees: float
    border_radius: BorderRadius
    masks: Tuple[Mask, ...]
    content: RenderContent


# --- nested layout -----------------------------------------------------------


@dataclass
class NestedLayout:
    top: float = 0.0
    left: float = 0.0
    width: float = 0.0
    height: float = 0.0
    rotation_degrees: float = 0.0
    scale_x: float = 1.0
    scale_y: float = 1.0
    crop: Optional[Crop] = None
    mask: Optional[Mask] = None
    content: LayoutContent = field(default_factory=NoneContent)
    border_width: float = 0.0
    border_color: RGBAColor = RGBAColor(0, 0, 0, 0)
    border_radius: BorderRadius = BorderRadius.ZERO
    box_shadow: List[BoxShadow] = field(default_factory=list)
    children: List["NestedLayout"] = field(default_factory=list)
    child_nodes_count: int = 0

    @staticmethod
    def child_nodes_placeholder(count: int) -> "NestedLayout":
        return NestedLayout(child_nodes_count=count)

    # -- flattening -----------------------------------------------------------

    def flatten(
        self,
        input_resolutions: Sequence[Optional[Resolution]],
        resolution: Resolution,
    ) -> List[RenderLayout]:
        shadows, layouts = self._inner_flatten(0, ())
        out = []
        for layout in list(shadows) + list(layouts):
            if not _should_render(layout, input_resolutions, resolution):
                continue
            out.append(_fix_final(layout))
        return out

    def _inner_flatten(
        self, child_index_offset: int, parent_masks: Tuple[Mask, ...]
    ) -> Tuple[List[RenderLayout], List[RenderLayout]]:
        offset = child_index_offset
        if isinstance(self.content, ChildNodeContent):
            self.content = replace(self.content, index=self.content.index + offset)
            offset += 1
        layout = self._render_layout(parent_masks)
        shadow_layouts = [
            self._box_shadow_layout(s, parent_masks) for s in self.box_shadow
        ]
        if self.mask is not None:
            # the own mask belongs to (and rotates with) this layout: stamp
            # this layout's rotation so the descent(-R)/hoist(+R) round trip
            # through the frame transforms nets to +R in the canvas frame,
            # while ancestor masks net to their own original rotation
            parent_masks = parent_masks + (replace(
                self.mask,
                rotation_degrees=self.mask.rotation_degrees
                + self.rotation_degrees,
            ),)
        parent_masks = self._child_parent_masks(parent_masks)

        children_shadows: List[RenderLayout] = []
        children_layouts: List[RenderLayout] = []
        for child in self.children:
            count = child.child_nodes_count
            sh, ls = child._inner_flatten(offset, parent_masks)
            offset += count
            children_shadows.extend(sh)
            children_layouts.extend(ls)
        children_shadows = [self._flatten_child(l) for l in children_shadows]
        children_layouts = [self._flatten_child(l) for l in children_layouts]
        return (shadow_layouts, [layout] + children_shadows + children_layouts)

    def _render_layout(self, parent_masks: Tuple[Mask, ...]) -> RenderLayout:
        if isinstance(self.content, ColorContent):
            content: RenderContent = RenderColor(
                self.content.color, self.border_color, self.border_width
            )
        elif isinstance(self.content, ChildNodeContent):
            content = RenderChildNode(
                index=self.content.index,
                border_color=self.border_color,
                border_width=self.border_width,
                crop=Crop(0.0, 0.0, self.content.width, self.content.height),
            )
        else:
            content = RenderColor(
                RGBAColor(0, 0, 0, 0), self.border_color, self.border_width
            )
        return RenderLayout(
            top=self.top,
            left=self.left,
            width=self.width,
            height=self.height,
            rotation_degrees=self.rotation_degrees,
            border_radius=self.border_radius,
            masks=tuple(parent_masks),
            content=content,
        )

    def _box_shadow_layout(
        self, shadow: BoxShadow, parent_masks: Tuple[Mask, ...]
    ) -> RenderLayout:
        return RenderLayout(
            top=self.top + shadow.offset_y,
            left=self.left + shadow.offset_x,
            width=self.width,
            height=self.height,
            rotation_degrees=self.rotation_degrees,
            border_radius=self.border_radius.plus(shadow.blur_radius / 2.0),
            masks=tuple(parent_masks),
            content=RenderBoxShadow(shadow.color, shadow.blur_radius),
        )

    def _flatten_child(self, child: RenderLayout) -> RenderLayout:
        unified_scale = min(self.scale_x, self.scale_y)
        if self.crop is None:
            content = child.content
            if isinstance(content, RenderColor):
                content = replace(
                    content, border_width=content.border_width * unified_scale
                )
            elif isinstance(content, RenderChildNode):
                content = replace(
                    content, border_width=content.border_width * unified_scale
                )
            elif isinstance(content, RenderBoxShadow):
                content = replace(
                    content, blur_radius=content.blur_radius * unified_scale
                )
            return RenderLayout(
                top=self.top + child.top * self.scale_y,
                left=self.left + child.left * self.scale_x,
                width=child.width * self.scale_x,
                height=child.height * self.scale_y,
                rotation_degrees=child.rotation_degrees + self.rotation_degrees,
                border_radius=child.border_radius.scaled(unified_scale),
                masks=self._parent_parent_masks(child.masks),
                content=content,
            )
        crop = self.crop
        cropped_top = max(child.top - crop.top, 0.0)
        cropped_left = max(child.left - crop.left, 0.0)
        cropped_bottom = min(child.top + child.height - crop.top, crop.height)
        cropped_right = min(child.left + child.width - crop.left, crop.width)
        cropped_width = cropped_right - cropped_left
        cropped_height = cropped_bottom - cropped_top
        content = child.content
        if isinstance(content, RenderChildNode):
            top_diff = max(crop.top - child.top, 0.0)
            left_diff = max(crop.left - child.left, 0.0)
            h_scale = content.crop.width / child.width if child.width else 0.0
            v_scale = content.crop.height / child.height if child.height else 0.0
            content = replace(
                content,
                crop=Crop(
                    top=content.crop.top + top_diff * v_scale,
                    left=content.crop.left + left_diff * h_scale,
                    width=cropped_width * h_scale,
                    height=cropped_height * v_scale,
                ),
            )
        elif isinstance(content, RenderColor):
            content = replace(
                content, border_width=content.border_width * unified_scale
            )
        elif isinstance(content, RenderBoxShadow):
            content = replace(
                content, blur_radius=content.blur_radius * unified_scale
            )
        return RenderLayout(
            top=self.top + cropped_top * self.scale_y,
            left=self.left + cropped_left * self.scale_x,
            width=cropped_width * self.scale_x,
            height=cropped_height * self.scale_y,
            rotation_degrees=child.rotation_degrees + self.rotation_degrees,
            border_radius=child.border_radius.scaled(unified_scale),
            masks=self._parent_parent_masks(child.masks),
            content=content,
        )

    def _child_parent_masks(self, masks: Tuple[Mask, ...]) -> Tuple[Mask, ...]:
        """Translate masks into a child's coordinate system."""
        s = min(self.scale_x, self.scale_y)
        return tuple(
            Mask(
                radius=m.radius.scaled(1.0 / s) if s else m.radius,
                top=(m.top - self.top) / self.scale_y,
                left=(m.left - self.left) / self.scale_x,
                width=m.width / self.scale_x,
                height=m.height / self.scale_y,
                rotation_degrees=m.rotation_degrees - self.rotation_degrees,
            )
            for m in masks
        )

    def _parent_parent_masks(self, masks: Tuple[Mask, ...]) -> Tuple[Mask, ...]:
        """Reverse of _child_parent_masks."""
        s = min(self.scale_x, self.scale_y)
        return tuple(
            Mask(
                radius=m.radius.scaled(s),
                top=m.top * self.scale_y + self.top,
                left=m.left * self.scale_x + self.left,
                width=m.width * self.scale_x,
                height=m.height * self.scale_y,
                rotation_degrees=m.rotation_degrees + self.rotation_degrees,
            )
            for m in masks
        )


def _should_render(
    layout: RenderLayout,
    input_resolutions: Sequence[Optional[Resolution]],
    resolution: Resolution,
) -> bool:
    if (
        layout.width <= 0.0
        or layout.height <= 0.0
        or layout.top > resolution.height
        or layout.left > resolution.width
    ):
        return False
    c = layout.content
    if isinstance(c, RenderColor):
        if c.color.a == 0:
            return c.border_color.a != 0 or c.border_width > 0.0
        return True
    if isinstance(c, RenderChildNode):
        size = (
            input_resolutions[c.index]
            if c.index < len(input_resolutions)
            else None
        )
        if size is not None and (
            c.crop.left > size.width or c.crop.top > size.height
        ):
            return False
        if c.crop.top + c.crop.height < 0.0 or c.crop.left + c.crop.width < 0.0:
            return False
        return True
    if isinstance(c, RenderBoxShadow):
        return c.color.a != 0
    return True


def _fix_final(layout: RenderLayout) -> RenderLayout:
    c = layout.content
    if isinstance(c, (RenderColor, RenderChildNode)) and c.border_width < 1.0:
        c = replace(c, border_width=0.0)

    def keep_mask(m: Mask) -> bool:
        max_top = max(m.radius.top_left, m.radius.top_right)
        max_bottom = max(m.radius.bottom_left, m.radius.bottom_right)
        max_left = max(m.radius.top_left, m.radius.bottom_left)
        max_right = max(m.radius.top_right, m.radius.bottom_right)
        skip = (
            m.top + max_top <= layout.top
            and m.left + max_left <= layout.left
            and m.left + m.width - max_right >= layout.left + layout.width
            and m.top + m.height - max_bottom >= layout.top + layout.height
        )
        return not skip

    masks = tuple(m for m in layout.masks if keep_mask(m))
    return replace(layout, content=c, masks=masks)
