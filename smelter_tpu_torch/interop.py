"""Numpy <-> port conversion of the state that crosses between the two
packages: layouts (static structure and numeric parameters) and frames.

The reference's `LayoutStatic` / `LayoutParams` are taken as plain objects
(duck-typed; this module never imports JAX) whose leaves are Python or
numpy values, and become the port's dataclasses, their numbers tensors on a
given device. Frames are u8 numpy planes.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Sequence, Tuple

import numpy as np
import torch

from smelter_tpu_torch.ops.compose import LayoutParams, LayoutStatic

_STATIC_FIELDS = tuple(f.name for f in dataclasses.fields(LayoutStatic))
_PARAM_FIELDS = tuple(f.name for f in dataclasses.fields(LayoutParams))


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
    done)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def planes_to_device(planes: Sequence[np.ndarray], device) -> Tuple[torch.Tensor, ...]:
    """u8 numpy planes -> tensors on `device` (`upload`)."""
    return tuple(upload(torch.from_numpy(np.ascontiguousarray(p)), device)
                 for p in planes)


def planes_to_host(planes: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
    """Tensors -> numpy planes on the host (waits for the device)."""
    return tuple(p.cpu().numpy() for p in planes)
