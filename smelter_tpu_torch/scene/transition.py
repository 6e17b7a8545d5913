"""Transition/easing machinery.

Same semantics as the reference (`smelter-render/src/scene/transition.rs`):
a TransitionState tracks a running animation between a component's previous
(`start`) and current (`end`) params; non-interrupting updates mid-transition
continue from the current interpolated point for the remaining duration.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from smelter_tpu_torch.scene.components import Easing, Transition

_EPS = 1e-7


def bounce_easing(t: float) -> float:
    n1 = 7.5625
    d1 = 2.75
    if t < 1.0 / d1:
        return n1 * t * t
    if t < 2.0 / d1:
        return n1 * (t - 1.5 / d1) ** 2 + 0.75
    if t < 2.5 / d1:
        return n1 * (t - 2.25 / d1) ** 2 + 0.9375
    return n1 * (t - 2.625 / d1) ** 2 + 0.984375


def _clamp_root(r: float) -> float:
    if math.isnan(r):
        return float("nan")
    if -_EPS <= r <= 1.0 + _EPS:
        return min(max(r, 0.0), 1.0)
    return float("nan")


def _find_first_cubic_root(p0: float, p1: float, p2: float, p3: float) -> float:
    """First root in [0,1] of the cubic bezier component polynomial
    (same construction as the reference / AndroidX Bezier.kt)."""
    a = 3.0 * (p0 - 2.0 * p1 + p2)
    b = 3.0 * (p1 - p0)
    c = p0
    d = -p0 + 3.0 * (p1 - p2) + p3
    if abs(d) < _EPS:
        if abs(a) < _EPS:
            if abs(b) < _EPS:
                return float("nan")
            return _clamp_root(-c / b)
        disc = b * b - 4.0 * a * c
        if disc < 0:
            return float("nan")
        q = math.sqrt(disc)
        a2 = 2.0 * a
        root = _clamp_root((q - b) / a2)
        if not math.isnan(root):
            return root
        return _clamp_root((-b - q) / a2)
    a, b, c = a / d, b / d, c / d
    o3 = (3.0 * b - a * a) / 9.0
    q2 = (2.0 * a**3 - 9.0 * a * b + 27.0 * c) / 54.0
    a3 = a / 3.0
    disc = q2 * q2 + o3**3
    if disc < 0.0:
        mp33 = -(o3**3)
        r = math.sqrt(mp33)
        cos_phi = min(max(-q2 / r, -1.0), 1.0)
        phi = math.acos(cos_phi)
        t1 = 2.0 * (r ** (1.0 / 3.0))
        for k in (0.0, 2.0, 4.0):
            root = _clamp_root(t1 * math.cos((phi + k * math.pi) / 3.0) - a3)
            if not math.isnan(root):
                return root
        return float("nan")
    if abs(disc) < _EPS:
        disc = 0.0
    sd = math.sqrt(disc)
    t1 = math.copysign(abs(-q2 + sd) ** (1.0 / 3.0), -q2 + sd) + math.copysign(
        abs(-q2 - sd) ** (1.0 / 3.0), -q2 - sd
    )
    return _clamp_root(t1 - a3)


def cubic_bezier_easing(progress: float, x1: float, y1: float, x2: float, y2: float) -> float:
    if abs(progress) < _EPS:
        return 0.0
    if abs(progress - 1.0) < _EPS:
        return 1.0
    t = _find_first_cubic_root(
        -progress, x1 - progress, x2 - progress, 1.0 - progress
    )
    if math.isnan(t):
        return 1.0
    a = 1.0 / 3.0 + (y1 - y2)
    b = y2 - 2.0 * y1
    c = y1
    val = 3.0 * ((a * t + b) * t + c) * t
    return min(max(val, 0.0), 1.0)


def easing_state(easing: Easing, t: float) -> float:
    if easing.kind == "linear":
        return t
    if easing.kind == "bounce":
        return bounce_easing(t)
    if easing.kind == "cubic_bezier":
        x1, y1, x2, y2 = easing.points
        return cubic_bezier_easing(t, x1, y1, x2, y2)
    raise ValueError(f"unknown easing {easing.kind!r}")


@dataclass
class TransitionState:
    start_pts: float
    duration: float
    easing: Easing
    # progress/state pair at the moment this transition (re)started, non-zero
    # when continuing an interrupted transition mid-curve
    offset_progress: float = 0.0
    offset_state: float = 0.0

    @staticmethod
    def create(
        current: Optional[Transition],
        previous: Optional["TransitionState"],
        props_changed: bool,
        interrupt_previous: bool,
        last_pts: float,
    ) -> Optional["TransitionState"]:
        if previous is not None and not previous.is_finished(last_pts):
            if props_changed and interrupt_previous:
                if current is None:
                    return None
                return TransitionState(last_pts, current.duration, current.easing)
            remaining = max(previous.start_pts + previous.duration - last_pts, 0.0)
            progress_offset = 1.0 - (
                remaining / previous.duration if previous.duration else 1.0
            )
            state_offset = easing_state(previous.easing, progress_offset)
            return TransitionState(
                start_pts=last_pts,
                duration=remaining,
                easing=current.easing if current is not None else previous.easing,
                offset_progress=progress_offset,
                offset_state=state_offset,
            )
        if props_changed and current is not None:
            return TransitionState(last_pts, current.duration, current.easing)
        return None

    def state(self, pts: float) -> float:
        """Interpolation state in [0, 1] at ``pts``."""
        if self.duration <= 0.0:
            return 1.0
        progress = (pts - self.start_pts) / self.duration
        progress = self.offset_progress + progress * (1.0 - self.offset_progress)
        progress = min(max(progress, 0.0), 1.0)
        state = easing_state(self.easing, progress)
        denom = 1.0 - self.offset_state
        if abs(denom) < 1e-9:
            return 1.0
        return (state - self.offset_state) / denom

    def is_finished(self, pts: float) -> bool:
        return self.start_pts + self.duration <= pts


def interpolate(start: float, end: float, state: float) -> float:
    return start + (end - start) * state


def interpolate_opt(start: Optional[float], end: Optional[float], state: float):
    if start is None or end is None:
        return end
    return interpolate(start, end, state)
