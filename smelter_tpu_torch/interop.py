"""The state that crosses between the two packages, and the device the
port's entry points run on.

  - `from_reference` carries a scene description across: a tree of the
    reference's scene and core objects becomes the port's objects of the
    same module path and class name, field by field (this module never
    imports the reference package).
  - The reference's `LayoutStatic` / `LayoutParams` are taken as plain
    objects (duck-typed) whose leaves are Python or numpy values, and
    become the port's dataclasses, their numbers tensors on a given device.
  - Frames are u8 numpy planes (`planes_to_device`, `planes_to_host`).
  - `resolve_device`: the CUDA card unless the caller names another device.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
from collections.abc import Mapping
from typing import Sequence, Tuple

import numpy as np
import torch

from smelter_tpu_torch.ops.compose import LayoutParams, LayoutStatic
from smelter_tpu_torch.render.capture import hold

_STATIC_FIELDS = tuple(f.name for f in dataclasses.fields(LayoutStatic))
_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(LayoutParams))
_REFERENCE, _PORT = "smelter_tpu", "smelter_tpu_torch"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card when `device` is
    None. Raises RuntimeError when a CUDA device is asked for and torch sees
    none; it never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for, but torch sees no CUDA card; pass "
            'device="cpu" to run on the CPU')
    return dev


def _port_class(cls: type) -> type:
    """The port's class of the same module path and qualified name."""
    module = _PORT + cls.__module__[len(_REFERENCE):]
    target = importlib.import_module(module)
    for name in cls.__qualname__.split("."):
        target = getattr(target, name)
    return target


def from_reference(obj):
    """A tree of the reference's scene and core objects (dataclasses and
    enums, in tuples, lists and dicts) as the port's objects, field by field.
    Objects of other packages (numpy frame planes, numbers, strings) pass
    through as they are; so do the port's own objects."""
    cls = type(obj)
    is_reference = cls.__module__.split(".")[0] == _REFERENCE
    if is_reference and isinstance(obj, enum.Enum):
        return _port_class(cls)[obj.name]
    if is_reference and dataclasses.is_dataclass(obj):
        fields = dataclasses.fields(obj)
        new = _port_class(cls)(**{f.name: from_reference(getattr(obj, f.name))
                                  for f in fields if f.init})
        for f in fields:
            if not f.init:
                object.__setattr__(new, f.name, from_reference(getattr(obj, f.name)))
        return new
    if is_reference:
        raise TypeError(f"no port counterpart for {cls.__module__}.{cls.__qualname__}")
    if cls in (tuple, list):
        return cls(from_reference(x) for x in obj)
    if cls is dict:
        return {from_reference(k): from_reference(v) for k, v in obj.items()}
    return obj


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def layout_static(obj) -> LayoutStatic:
    """A reference LayoutStatic (or any object with its fields)."""
    return LayoutStatic(**{f: _get(obj, f) for f in _STATIC_FIELDS})


def layout_params(obj, device) -> LayoutParams:
    """A reference LayoutParams, or a mapping of its fields, whose leaves are
    numpy arrays or scalars -> LayoutParams of f32 tensors on `device`."""
    return LayoutParams(**{
        f: torch.tensor(np.asarray(_get(obj, f), np.float32), device=device)
        for f in _PARAM_FIELDS
    })


def layouts(statics: Sequence, params: Sequence, device
            ) -> Tuple[list, list]:
    """Convert parallel lists of reference statics and params."""
    return ([layout_static(s) for s in statics],
            [layout_params(p, device) for p in params])


def upload(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on `device`. To a CUDA device it goes through pinned
    host memory and a non-blocking copy on the current stream, so the host
    does not wait (PyTorch keeps the pinned buffer alive until its copy is
    done). The device copy belongs to the program being built on this
    thread, if any (`render.capture.hold`). Raises inside a CUDA graph
    capture: a graph must not hold a copy from host memory."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "an upload inside a CUDA graph capture: the device constant should "
            "have been made by the warm-up run (render/capture.py)")
    if not t.is_pinned():
        t = t.pin_memory()
    return hold(t.to(device, non_blocking=True))


def planes_to_device(planes: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, ...]:
    """u8 numpy planes -> tensors on `device` (`upload`)."""
    return tuple(upload(torch.from_numpy(np.ascontiguousarray(p)), device)
                 for p in planes)


def planes_to_host(planes: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """Tensors -> numpy planes on the host (waits for the device)."""
    return tuple(p.cpu().numpy() for p in planes)
