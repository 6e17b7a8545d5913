"""The `jnp` and `lax` names a user shader sees, backed by torch.

Shader sources keep the JAX syntax of the wire contract (`docs/MIGRATING.md`):
``main(inputs, params, resolution, time)`` written against ``jnp``, ``lax``
and ``math``. The sandbox (`render/shader_validation.py`) binds ``jnp`` and
``lax`` to a `ShaderNamespace` of one device (the renderer's, or "meta" for
the registration trace), whose functions run torch operations on that device
and return `ShaderArray`s, which keep the JAX semantics a shader relies on:

  - arrays are immutable: ``x[i] = v`` raises TypeError (as JAX does), and
    ``x.at[i].set(v)`` / ``.add(v)`` return a new array; so a shader can
    never write into an input texture that another node also reads;
  - default types are JAX's: Python ints become int32 and Python floats
    float32;
  - ``lax.dynamic_update_slice`` clamps its start indices so that the update
    fits, with starts on the host or on the device;
  - an array made from Python values alone (``jnp.cos(a)`` of a param, a
    0-d ``jnp.zeros(())``) is 0-d and stays on the host, so index maths on
    params needs no device round trip; anything derived from ``time`` or a
    texture stays on the device, and arrays of one or more dimensions are
    made on the device. Nothing here waits for the device.

Covered names (any other ``jnp``/``lax`` attribute raises AttributeError,
which fails the registration trace):

  jnp: array asarray zeros zeros_like ones ones_like full broadcast_to
       linspace arange outer concatenate stack where clip round floor ceil
       sin cos sqrt exp abs maximum minimum sum mean pi float32 int32 uint8
       bool_ floating integer issubdtype
  lax: dynamic_update_slice
  arrays: .shape .ndim .dtype .size .astype .reshape .sum .mean .min .max
       .T, indexing and slicing (negative steps included), arithmetic and
       comparison operators, ``.at[...].set`` and ``.at[...].add``
"""

from __future__ import annotations

import math
import numbers
from typing import Sequence

import numpy as np
import torch

from smelter_tpu_torch.render.capture import device_constant


class DType:
    """A JAX-named dtype (``jnp.float32``): callable like JAX's, which makes
    a scalar array of that type."""

    def __init__(self, name: str, torch_dtype: torch.dtype, ns=None) -> None:
        self.name = name
        self.torch = torch_dtype
        self._ns = ns

    def __call__(self, x):
        return self._ns.asarray(x, self)

    def __eq__(self, other):
        if isinstance(other, DType):
            return self.torch == other.torch
        return self.torch == other

    def __hash__(self):
        return hash(self.torch)

    def __repr__(self) -> str:
        return f"dtype('{self.name}')"

    def __str__(self) -> str:
        return self.name


_DTYPES = {
    torch.float32: "float32", torch.int32: "int32", torch.uint8: "uint8",
    torch.bool: "bool", torch.float64: "float64", torch.int64: "int64",
    torch.float16: "float16", torch.bfloat16: "bfloat16", torch.int16: "int16",
    torch.int8: "int8",
}


def _torch_dtype(dtype):
    if dtype is None:
        return None
    if isinstance(dtype, DType):
        return dtype.torch
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype is float:
        return torch.float32
    if dtype is int:
        return torch.int32
    if dtype is bool:
        return torch.bool
    raise TypeError(f"unsupported dtype {dtype!r}")


def _t(x):
    """The tensor of a ShaderArray, or x itself."""
    return x.t if isinstance(x, ShaderArray) else x


def _value(x):
    """An update value: a host 0-d tensor as its Python number (writing a
    host tensor into a device tensor would copy it and wait)."""
    t = _t(x)
    if isinstance(t, torch.Tensor) and t.dim() == 0 and t.device.type == "cpu":
        return t.item()
    return t


class _IndexUpdate:
    def __init__(self, arr: "ShaderArray", idx) -> None:
        self._arr, self._idx = arr, idx

    def set(self, value):
        out = self._arr.t.clone()
        out[_index(self._idx)] = _value(value)
        return ShaderArray(out)

    def add(self, value):
        out = self._arr.t.clone()
        idx = _index(self._idx)
        out[idx] = out[idx] + _value(value)
        return ShaderArray(out)


class _At:
    def __init__(self, arr: "ShaderArray") -> None:
        self._arr = arr

    def __getitem__(self, idx):
        return _IndexUpdate(self._arr, idx)


def _index(idx):
    """An index with its ShaderArrays as tensors."""
    if isinstance(idx, tuple):
        return tuple(_t(i) for i in idx)
    return _t(idx)


def _getitem(t: torch.Tensor, idx):
    """``t[idx]`` with numpy semantics for negative slice steps, which torch
    slicing lacks: each such slice becomes its positive-step mirror, and its
    output dimension is flipped afterwards."""
    items = list(idx) if isinstance(idx, tuple) else [idx]
    if not any(isinstance(i, slice) and i.step is not None and i.step < 0 for i in items):
        return t[_index(idx)]
    n_used = sum(1 for i in items if i is not Ellipsis and i is not None)
    out, flips, in_dim, out_dim = [], [], 0, 0
    for item in items:
        if item is Ellipsis:
            span = t.dim() - n_used
            out.append(item)
            in_dim += span
            out_dim += span
        elif item is None:
            out.append(item)
            out_dim += 1
        elif isinstance(item, slice):
            if item.step is not None and item.step < 0:
                positions = range(*item.indices(t.shape[in_dim]))
                if len(positions):
                    item = slice(positions[-1], positions[0] + 1, -item.step)
                    flips.append(out_dim)
                else:
                    item = slice(0, 0)
            out.append(item)
            in_dim += 1
            out_dim += 1
        else:  # an integer index drops its dimension
            out.append(_t(item))
            in_dim += 1
    res = t[tuple(out)]
    return res.flip(flips) if flips else res


def _binary(op):
    def fn(self, other):
        if isinstance(other, np.ndarray):
            other = torch.from_numpy(other)
        return ShaderArray(op(self.t, _t(other)))

    return fn


class ShaderArray:
    """An immutable array of a shader: a torch tensor with the JAX array
    operations shaders use (see the module docstring)."""

    __slots__ = ("t",)
    __array_priority__ = 1000  # numpy scalars defer to the reflected ops
    __hash__ = None

    def __init__(self, t: torch.Tensor) -> None:
        self.t = t

    # -- properties ----------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.t.shape)

    @property
    def ndim(self) -> int:
        return self.t.dim()

    @property
    def size(self) -> int:
        return self.t.numel()

    @property
    def dtype(self) -> DType:
        return DType(_DTYPES.get(self.t.dtype, str(self.t.dtype)), self.t.dtype)

    @property
    def at(self):
        return _At(self)

    @property
    def T(self):
        return ShaderArray(self.t.permute(*reversed(range(self.t.dim()))))

    # -- methods -------------------------------------------------------------
    def astype(self, dtype):
        return ShaderArray(self.t.to(_torch_dtype(dtype)))

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return ShaderArray(self.t.reshape(shape))

    def sum(self, axis=None, keepdims=False):
        return ShaderArray(_reduce(torch.sum, self.t, axis, keepdims))

    def mean(self, axis=None, keepdims=False):
        return ShaderArray(_reduce(torch.mean, self.t, axis, keepdims))

    def max(self, axis=None, keepdims=False):
        return ShaderArray(_reduce(torch.amax, self.t, axis, keepdims))

    def min(self, axis=None, keepdims=False):
        return ShaderArray(_reduce(torch.amin, self.t, axis, keepdims))

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, idx):
        return ShaderArray(_getitem(self.t, idx))

    def __setitem__(self, idx, value):
        raise TypeError(
            "shader arrays are immutable, as JAX arrays are: instead of "
            "``x[idx] = y``, use ``x = x.at[idx].set(y)``")

    def __len__(self) -> int:
        if self.t.dim() == 0:
            raise TypeError("len() of unsized object")
        return self.t.shape[0]

    def __iter__(self):
        if self.t.dim() == 0:
            raise TypeError("iteration over a 0-d array")
        return (ShaderArray(row) for row in self.t.unbind(0))

    # -- conversions (host values only: a device value would synchronise,
    # and a value of the registration trace has none) -------------------------
    def __bool__(self) -> bool:
        return bool(self.t)

    def __float__(self) -> float:
        return float(self.t)

    def __int__(self) -> int:
        return int(self.t)

    def __index__(self) -> int:
        return int(self.t)

    def __repr__(self) -> str:
        return f"ShaderArray({self.t!r})"

    # -- operators -----------------------------------------------------------
    __add__ = _binary(lambda a, b: a + b)
    __radd__ = _binary(lambda a, b: b + a)
    __sub__ = _binary(lambda a, b: a - b)
    __rsub__ = _binary(lambda a, b: b - a)
    __mul__ = _binary(lambda a, b: a * b)
    __rmul__ = _binary(lambda a, b: b * a)
    __truediv__ = _binary(lambda a, b: a / b)
    __rtruediv__ = _binary(lambda a, b: b / a)
    __floordiv__ = _binary(lambda a, b: a // b)
    __rfloordiv__ = _binary(lambda a, b: b // a)
    __mod__ = _binary(lambda a, b: a % b)
    __rmod__ = _binary(lambda a, b: b % a)
    __pow__ = _binary(lambda a, b: a ** b)
    __rpow__ = _binary(lambda a, b: b ** a)
    __matmul__ = _binary(lambda a, b: a @ b)
    __rmatmul__ = _binary(lambda a, b: b @ a)
    __and__ = _binary(lambda a, b: a & b)
    __rand__ = _binary(lambda a, b: b & a)
    __or__ = _binary(lambda a, b: a | b)
    __ror__ = _binary(lambda a, b: b | a)
    __xor__ = _binary(lambda a, b: a ^ b)
    __rxor__ = _binary(lambda a, b: b ^ a)
    __lt__ = _binary(lambda a, b: a < b)
    __le__ = _binary(lambda a, b: a <= b)
    __gt__ = _binary(lambda a, b: a > b)
    __ge__ = _binary(lambda a, b: a >= b)
    __eq__ = _binary(lambda a, b: a == b)
    __ne__ = _binary(lambda a, b: a != b)

    def __neg__(self):
        return ShaderArray(-self.t)

    def __pos__(self):
        return self

    def __abs__(self):
        return ShaderArray(self.t.abs())

    def __invert__(self):
        return ShaderArray(~self.t)


def _reduce(fn, t, axis, keepdims):
    if axis is None:
        return fn(t) if not keepdims else fn(t, dim=tuple(range(t.dim())), keepdim=True)
    return fn(t, dim=axis, keepdim=keepdims)


class _Floating:
    """``jnp.floating``: the abstract type `issubdtype` tests against."""


class _Integer:
    """``jnp.integer``."""


class _Lax:
    """``lax``: the one `jax.lax` function the shaders use."""

    def __init__(self, ns: "ShaderNamespace") -> None:
        self._ns = ns

    def dynamic_update_slice(self, operand, update, start_indices):
        return self._ns.dynamic_update_slice(operand, update, start_indices)

    def __getattr__(self, name):
        raise AttributeError(
            f"lax.{name} is not covered by the shader namespace of "
            "smelter_tpu_torch (covered: dynamic_update_slice)")


class ShaderNamespace:
    """``jnp`` for the shaders of one device. Arrays of one or more
    dimensions made from Python values are made on `device`; 0-d ones stay on
    the host (see the module docstring)."""

    pi = math.pi
    floating = _Floating
    integer = _Integer

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self.float32 = DType("float32", torch.float32, self)
        self.int32 = DType("int32", torch.int32, self)
        self.uint8 = DType("uint8", torch.uint8, self)
        self.bool_ = DType("bool", torch.bool, self)
        self.lax = _Lax(self)

    def __getattr__(self, name):
        raise AttributeError(
            f"jnp.{name} is not covered by the shader namespace of "
            "smelter_tpu_torch (see smelter_tpu_torch/render/shader_ns.py)")

    # -- placement -------------------------------------------------------------
    def _from_host(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """A host numpy value as a tensor with JAX's default types: 0-d on
        the host, otherwise a device constant (`_device_copy`)."""
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        t = torch.from_numpy(np.asarray(a, order="C"))
        if dtype is not None:
            t = t.to(_torch_dtype(dtype))
        if t.dim() == 0:
            return t
        if self.device.type == "meta":
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        data = t.contiguous().view(torch.uint8).numpy().tobytes() if t.numel() else b""
        return _device_copy(data, t.dtype, tuple(t.shape), self.device)

    def _tensor(self, x, dtype=None) -> torch.Tensor:
        if isinstance(x, ShaderArray):
            t = x.t
            return t if dtype is None else t.to(_torch_dtype(dtype))
        if isinstance(x, torch.Tensor):
            return x if dtype is None else x.to(_torch_dtype(dtype))
        if isinstance(x, (list, tuple)) and any(_has_tensor(e) for e in x):
            parts = [self._tensor(e) for e in x]
            t = torch.stack(_same_device(parts, self.device))
            return t if dtype is None else t.to(_torch_dtype(dtype))
        return self._from_host(np.asarray(x), dtype)

    def _device_of(self, *ts) -> torch.device:
        for t in ts:
            if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                return t.device
        return self.device

    # -- creation ---------------------------------------------------------------
    def asarray(self, x, dtype=None):
        return ShaderArray(self._tensor(x, dtype))

    array = asarray

    def _full(self, shape, value, dtype):
        shape = (shape,) if isinstance(shape, numbers.Integral) else tuple(shape)
        dt = _torch_dtype(dtype) or torch.float32
        if not shape:
            return ShaderArray(torch.full((), value, dtype=dt))
        return ShaderArray(torch.full(shape, value, dtype=dt, device=self.device))

    def zeros(self, shape, dtype=None):
        return self._full(shape, 0, dtype)

    def ones(self, shape, dtype=None):
        return self._full(shape, 1, dtype)

    def full(self, shape, fill_value, dtype=None):
        if dtype is None:
            dtype = torch.int32 if isinstance(fill_value, numbers.Integral) else torch.float32
        return self._full(shape, fill_value, dtype)

    def zeros_like(self, a, dtype=None):
        t = self._tensor(a)
        return ShaderArray(torch.zeros_like(t, dtype=_torch_dtype(dtype)))

    def ones_like(self, a, dtype=None):
        t = self._tensor(a)
        return ShaderArray(torch.ones_like(t, dtype=_torch_dtype(dtype)))

    def broadcast_to(self, a, shape):
        t = self._tensor(a)
        if tuple(shape):
            t = _same_device([t], self.device)[0]
        return ShaderArray(torch.broadcast_to(t, tuple(shape)))

    def linspace(self, start, stop, num=50, endpoint=True, dtype=None):
        """JAX's formula: start * (1 - s) + stop * s with s = i / div in f32,
        the end point appended exactly."""
        s, e = self._tensor(start, torch.float32), self._tensor(stop, torch.float32)
        dev = self._device_of(s, e)
        div = (num - 1) if endpoint else num
        if num > 1:
            step = torch.arange(div, dtype=torch.float32, device=dev) / float(div)
            out = s * (1 - step) + e * step
            if endpoint:
                out = torch.cat([out, _same_device([e], dev)[0].reshape(1)])
        elif num == 1:
            out = _same_device([s], dev)[0].reshape(1)
        else:
            out = torch.empty((0,), dtype=torch.float32, device=dev)
        dt = _torch_dtype(dtype)
        if dt is not None and not dt.is_floating_point:
            out = torch.floor(out)
        return ShaderArray(out if dt is None else out.to(dt))

    def arange(self, start, stop=None, step=1, dtype=None):
        if stop is None:
            start, stop = 0, start
        ints = all(isinstance(v, numbers.Integral) for v in (start, stop, step))
        dt = _torch_dtype(dtype) or (torch.int32 if ints else torch.float32)
        return ShaderArray(torch.arange(start, stop, step, dtype=dt, device=self.device))

    # -- combination ------------------------------------------------------------
    def concatenate(self, arrays: Sequence, axis: int = 0):
        parts = _same_device([self._tensor(a) for a in arrays], self.device)
        return ShaderArray(torch.cat(parts, dim=axis))

    def stack(self, arrays: Sequence, axis: int = 0):
        parts = _same_device([self._tensor(a) for a in arrays], self.device)
        return ShaderArray(torch.stack(parts, dim=axis))

    def outer(self, a, b):
        ta, tb = _same_device([self._tensor(a), self._tensor(b)], self.device)
        return ShaderArray(torch.outer(ta.reshape(-1), tb.reshape(-1)))

    def where(self, condition, x, y):
        # torch.where copies a host operand to the device, and waits: a
        # host 0-d value becomes a fill there first
        c, a, b = _same_device([self._tensor(v) for v in (condition, x, y)], self.device)
        return ShaderArray(torch.where(c, a, b))

    # a host 0-d operand is a scalar to torch's binary operations
    def maximum(self, a, b):
        return ShaderArray(torch.maximum(self._tensor(a), self._tensor(b)))

    def minimum(self, a, b):
        return ShaderArray(torch.minimum(self._tensor(a), self._tensor(b)))

    def clip(self, a, min=None, max=None, a_min=None, a_max=None):
        lo = min if min is not None else a_min
        hi = max if max is not None else a_max
        t = self._tensor(a)
        if lo is not None:
            t = torch.maximum(t, self._tensor(lo))
        if hi is not None:
            t = torch.minimum(t, self._tensor(hi))
        return ShaderArray(t)

    # -- elementwise --------------------------------------------------------------
    def _unary(self, fn, a):
        t = self._tensor(a)
        if not t.is_floating_point():
            t = t.to(torch.float32)
        return ShaderArray(fn(t))

    def sin(self, a):
        return self._unary(torch.sin, a)

    def cos(self, a):
        return self._unary(torch.cos, a)

    def sqrt(self, a):
        return self._unary(torch.sqrt, a)

    def exp(self, a):
        return self._unary(torch.exp, a)

    def round(self, a, decimals=0):
        t = self._tensor(a)
        if not t.is_floating_point():
            return ShaderArray(t)
        # torch.round rounds half to even, as jnp.round does
        return ShaderArray(torch.round(t, decimals=decimals) if decimals else torch.round(t))

    def floor(self, a):
        return self._unary(torch.floor, a)

    def ceil(self, a):
        return self._unary(torch.ceil, a)

    def abs(self, a):
        return ShaderArray(torch.abs(self._tensor(a)))

    def sum(self, a, axis=None, keepdims=False):
        return ShaderArray(_reduce(torch.sum, self._tensor(a), axis, keepdims))

    def mean(self, a, axis=None, keepdims=False):
        return ShaderArray(_reduce(torch.mean, self._tensor(a), axis, keepdims))

    # -- types ------------------------------------------------------------------
    def issubdtype(self, dtype, kind) -> bool:
        dt = _torch_dtype(dtype)
        if kind is _Floating:
            return dt.is_floating_point
        if kind is _Integer:
            return not dt.is_floating_point and not dt.is_complex and dt != torch.bool
        return dt == _torch_dtype(kind)

    # -- lax ----------------------------------------------------------------------
    def dynamic_update_slice(self, operand, update, start_indices):
        """`lax.dynamic_update_slice`: `update` written into a copy of
        `operand` at `start_indices`; a negative start counts from the end
        (+ operand dim), then each start is clamped to [0, operand dim -
        update dim], as JAX does. Starts on the host slice; a start on the
        device scatters at indices computed on the device (no host round
        trip)."""
        op = self._tensor(operand)
        up = self._tensor(update).to(op.dtype)
        if up.dim() != op.dim() or len(start_indices) != op.dim():
            raise TypeError(
                f"dynamic_update_slice: operand of rank {op.dim()}, update of rank "
                f"{up.dim()} and {len(start_indices)} start indices must agree")
        starts = [_t(s) for s in start_indices]
        out = op.clone()
        on_device = [_is_device_value(s) for s in starts]
        if not any(on_device):
            sl = []
            for s, n, u in zip(starts, op.shape, up.shape):
                s = _clamp_start(int(s), n, u)
                sl.append(slice(s, s + u))
            out[tuple(sl)] = up
            return ShaderArray(out)
        index = []
        for d, (s, n, u, dev_s) in enumerate(zip(starts, op.shape, up.shape, on_device)):
            if dev_s:
                s = s.to(torch.int64)
                s = torch.clamp(torch.where(s < 0, s + n, s), 0, n - u)
                rows = s + torch.arange(u, device=op.device)
            else:
                s = _clamp_start(int(s), n, u)
                rows = torch.arange(s, s + u, device=op.device)
            shape = [1] * op.dim()
            shape[d] = u
            index.append(rows.reshape(shape))
        out.index_put_(tuple(index), up)
        return ShaderArray(out)


def _is_device_value(s) -> bool:
    """A start index that lives on the device (not a Python int or a host
    0-d tensor)."""
    return isinstance(s, torch.Tensor) and s.device.type != "cpu"


def _clamp_start(s: int, n: int, u: int) -> int:
    """A dynamic_update_slice start: negative counts from the end, then
    clamped so that the update of size u fits in n."""
    return min(max(s + n if s < 0 else s, 0), n - u)


@device_constant(maxsize=256)
def _device_copy(data: bytes, dtype: torch.dtype, shape: tuple, device) -> torch.Tensor:
    """A shader's constant array on the device, through pinned memory without
    waiting (`interop.upload`); made once per value, so that a captured
    shader reads it and never uploads it (`render/capture.py`)."""
    from smelter_tpu_torch.interop import upload

    t = (torch.frombuffer(bytearray(data), dtype=dtype).reshape(shape) if data
         else torch.empty(shape, dtype=dtype))
    return upload(t, device)


def _has_tensor(x) -> bool:
    if isinstance(x, (ShaderArray, torch.Tensor)):
        return True
    if isinstance(x, (list, tuple)):
        return any(_has_tensor(e) for e in x)
    return False


def _same_device(ts, device):
    """Tensors on one device: the first one's that is not the host, else
    `device`. A host value (0-d: `ShaderNamespace._from_host` puts every
    other one on the device) becomes a fill on that device, never a copy that
    would wait."""
    target = next((t.device for t in ts if t.device.type != "cpu"), torch.device(device))
    out = []
    for t in ts:
        if t.device != target:
            if t.dim() != 0 or t.device.type != "cpu":
                raise ValueError(f"a shader mixes a {t.dim()}-d {t.device} array with "
                                 f"arrays on {target}")
            t = torch.full((), t.item(), dtype=t.dtype, device=target)
        out.append(t)
    return out
