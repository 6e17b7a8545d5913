"""User shaders on the port: the torch-backed `jnp`/`lax` of
`smelter_tpu_torch/render/shader_ns.py` against JAX, registration against
the reference's (`tests/test_shader_validation.py`), and shader frames
against the JAX renderer.

  - Every covered `jnp`/`lax` name and array operation, on the same
    numpy-seeded inputs, against `jax.numpy` / `jax.lax`: values within
    1e-6 (relative) or exactly for integers and indexing, the same shapes,
    the JAX default types (int32, float32); `dynamic_update_slice` clamping
    its start indices, on the host and on the device; `x[i] = v` raising
    TypeError as JAX does.
  - Every case of `tests/test_shader_validation.py`: accepted or rejected
    the same way by both registries, with the same `ShaderValidationError`
    text.
  - The shader frames of `tests/test_renderer.py` (the invert shader, the
    base-params contract) and the docs' `pulse` shader through a time
    sweep, frame by frame, at <= 1 u8 LSB.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_shader_validation as tsv
from harness import make_test_input
from smelter_tpu.core.types import FrameSet, PixelFormat, Resolution
from smelter_tpu.render import shader_validation as jsv
from smelter_tpu.render.program import ShaderRegistry as JaxShaderRegistry
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.scene import components as comp
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.render import shader_validation as tsv_port
from smelter_tpu_torch.render.program import ShaderRegistry
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer
from smelter_tpu_torch.render.shader_ns import ShaderArray, ShaderNamespace
from test_torch_web import PortRenderer

torch.set_num_threads(2)

NS = ShaderNamespace("cpu")
LAX = NS.lax
RNG = np.random.default_rng(7)
A = RNG.random((6, 5, 4), dtype=np.float32)
B = RNG.random((6, 5, 4), dtype=np.float32)
V = RNG.random(5, dtype=np.float32)
W = RNG.random(6, dtype=np.float32)


def _np(x):
    if isinstance(x, ShaderArray):
        return x.t.numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same(ref, got):
    r, g = np.asarray(ref), _np(got)
    assert r.shape == g.shape, (r.shape, g.shape)
    assert str(r.dtype) == str(g.dtype), (r.dtype, g.dtype)
    if np.issubdtype(r.dtype, np.floating):
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(g, r)


# name -> fn(np_mod, lax_mod, wrap) with np_mod jnp or the port's namespace;
# `wrap` turns a numpy array into that package's array
CASES = {
    "array_of_floats": lambda m, lax, w: m.array([1.5, 2.0, 3.25]),
    "array_of_ints": lambda m, lax, w: m.array([1, 2, 3]),
    "array_mixed_with_arrays": lambda m, lax, w: m.array(
        [2 / 8.0, w(np.float32(0.5)) / 4.0, 512 / 1024.0, 1.0], m.float32),
    "asarray": lambda m, lax, w: m.asarray(A) * 2.0,
    "zeros": lambda m, lax, w: m.zeros((3, 4, 4), m.float32),
    "zeros_int32": lambda m, lax, w: m.zeros((), m.int32),
    "zeros_like": lambda m, lax, w: m.zeros_like(w(A)),
    "ones_like": lambda m, lax, w: m.ones_like(w(A)),
    "ones": lambda m, lax, w: m.ones((2, 3)),
    "full": lambda m, lax, w: m.full((2, 3), 7),
    "broadcast_to": lambda m, lax, w: m.broadcast_to(
        m.array([0.25, 0.5, 0.75, 1.0], m.float32), (3, 5, 4)),
    "linspace": lambda m, lax, w: m.linspace(0.0, 1.0, 7),
    "linspace_gain": lambda m, lax, w: m.linspace(0.0, 0.7, 321),
    "linspace_no_endpoint": lambda m, lax, w: m.linspace(0.0, 6.28, 90, endpoint=False),
    "arange": lambda m, lax, w: m.arange(5),
    "outer": lambda m, lax, w: m.outer(w(W), w(V)),
    "concatenate": lambda m, lax, w: m.concatenate([w(A)[..., :3], w(B)[..., 3:4]], axis=-1),
    "stack": lambda m, lax, w: m.stack([w(V), w(V) * 0.5, 1.0 - w(V), m.ones_like(w(V))],
                                       axis=-1),
    "where": lambda m, lax, w: m.where(w(A) > 0.5, w(A), w(B)),
    "clip": lambda m, lax, w: m.clip(w(A) * 1.5 - 0.2, 0.0, 1.0),
    "round": lambda m, lax, w: m.round(w(A) * 10.0),
    "round_half_even": lambda m, lax, w: m.round(m.array([0.5, 1.5, 2.5, -0.5])),
    "floor": lambda m, lax, w: m.floor(w(A) * 10.0),
    "ceil": lambda m, lax, w: m.ceil(w(A) * 10.0),
    "sin": lambda m, lax, w: m.sin(w(A) * 6.0 + 0.1),
    "cos": lambda m, lax, w: m.cos(w(A) * 6.0 + 0.1),
    "sin_of_python_float": lambda m, lax, w: m.sin(1.25),
    "cos_of_python_float": lambda m, lax, w: m.cos(90.0 * math.pi / 180.0),
    "sqrt": lambda m, lax, w: m.sqrt(w(A)),
    "exp": lambda m, lax, w: m.exp(w(A)),
    "abs": lambda m, lax, w: m.abs(w(A) - 0.5),
    "maximum": lambda m, lax, w: m.maximum(w(A), w(B)),
    "minimum": lambda m, lax, w: m.minimum(w(A), 0.3),
    "sum": lambda m, lax, w: m.sum(w(A), axis=-1),
    "mean": lambda m, lax, w: m.mean(w(A), axis=(0, 1)),
    "pi": lambda m, lax, w: m.array(m.pi) * w(V),
    "float32_scalar": lambda m, lax, w: m.float32(0.5) * w(V),
    "astype_int32": lambda m, lax, w: (w(A) * 100.0).astype(m.int32),
    "astype_uint8": lambda m, lax, w: (w(A) * 255.0).astype(m.uint8),
    "astype_float32": lambda m, lax, w: m.array([1, 2, 3]).astype(m.float32),
    "int_divide": lambda m, lax, w: m.array([7, 8, 9]) / m.array([2, 2, 2]),
    "int_times_float": lambda m, lax, w: m.array([1, 2, 3]) * 2.5,
    "slice_channels": lambda m, lax, w: w(A)[..., :3],
    "slice_channel_index": lambda m, lax, w: w(A)[..., 0],
    "slice_newaxis": lambda m, lax, w: (w(A)[..., 0] * 0.5)[..., None],
    "slice_step": lambda m, lax, w: w(A)[::2, ::2],
    "slice_reverse": lambda m, lax, w: w(A)[..., :3][..., ::-1],
    "slice_reverse_rows": lambda m, lax, w: w(A)[::-2, 1:4],
    "at_set": lambda m, lax, w: w(A).at[1:3, 2].set(0.0),
    "at_add": lambda m, lax, w: w(A).at[..., 3].add(1.0),
    "reshape": lambda m, lax, w: w(A).reshape(30, 4),
    "transpose": lambda m, lax, w: w(A)[..., 0].T,
    "method_sum": lambda m, lax, w: w(A).sum(axis=0),
    "method_max": lambda m, lax, w: w(A).max(),
    "operators": lambda m, lax, w: ((w(A) + 1.0) * 2.0 - w(B) / 3.0) ** 2 % 1.5,
    "comparisons": lambda m, lax, w: (w(A) >= w(B)) & (w(A) < 0.9),
    "dynamic_update_slice": lambda m, lax, w: lax.dynamic_update_slice(
        w(A), w(B)[:2, :3], (1, 1, 0)),
    "dynamic_update_slice_clamps": lambda m, lax, w: lax.dynamic_update_slice(
        w(A), w(B)[:4, :4] * 2.0, (5, -3, 2)),
    "dynamic_update_slice_scalar_starts": lambda m, lax, w: lax.dynamic_update_slice(
        w(A), w(B)[:3, :2],
        (m.round(2.6).astype(m.int32), m.round(9.0 * m.cos(0.0)).astype(m.int32),
         m.zeros((), m.int32))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_namespace_matches_jax(name):
    fn = CASES[name]
    ref = fn(jnp, jax.lax, jnp.asarray)
    got = fn(NS, LAX, lambda x: NS.asarray(np.asarray(x)))
    _same(ref, got)


def test_scalars_of_python_values_stay_on_the_host():
    """Index maths on params needs no device round trip: 0-d values made of
    Python numbers live on the host, whatever the namespace's device."""
    meta = ShaderNamespace("meta")
    x = meta.round(160.0 + 55.0 * meta.cos(math.pi / 2) - 48 / 2).astype(meta.int32)
    assert x.t.device.type == "cpu" and x.t.dtype == torch.int32 and int(x) == 136
    assert meta.zeros((), meta.int32).t.device.type == "cpu"
    assert meta.zeros((4, 4)).t.device.type == "meta"
    assert meta.linspace(0.0, 1.0, 5).t.device.type == "meta"


@pytest.mark.parametrize("starts", [(9, -2, 1), (-1, 4, 0), (2, 1, 0), (-9, -9, -9)])
def test_dynamic_update_slice_with_starts_on_the_device(starts, monkeypatch):
    """Starts computed from a device value (`time` on the card) wrap and
    clamp on the device, as JAX's do: the scatter needs no host value. On
    the CPU every tensor start is made to take that route."""
    from smelter_tpu_torch.render import shader_ns

    monkeypatch.setattr(shader_ns, "_is_device_value", lambda s: isinstance(s, torch.Tensor))
    ref = jax.lax.dynamic_update_slice(jnp.asarray(A), jnp.asarray(B[:2, :3]), starts)
    got = NS.dynamic_update_slice(
        NS.asarray(A), NS.asarray(B[:2, :3]),
        tuple(ShaderArray(torch.tensor(s, dtype=torch.int32)) for s in starts))
    _same(ref, got)


def test_dynamic_update_slice_traces_on_meta():
    meta = ShaderNamespace("meta")
    t = ShaderArray(torch.empty((), dtype=torch.float32, device="meta"))
    out = meta.dynamic_update_slice(meta.zeros((6, 5, 4)), meta.ones((2, 3, 4)),
                                    ((t * 2.0).astype(meta.int32), 0, 0))
    assert out.shape == (6, 5, 4) and out.t.device.type == "meta"


def test_item_assignment_raises_type_error_as_jax_does():
    with pytest.raises(TypeError):
        jnp.asarray(A)[0] = 1.0
    tex = torch.from_numpy(A.copy())
    arr = ShaderArray(tex)
    with pytest.raises(TypeError, match="immutable"):
        arr[0] = 1.0
    assert torch.equal(tex, torch.from_numpy(A))  # the input texture is untouched
    updated = arr.at[0].set(1.0)
    assert torch.equal(tex, torch.from_numpy(A)) and float(updated.t[0].min()) == 1.0


def test_unknown_names_fail_registration():
    for src in ("    return jnp.fft.fft2(inputs[0])\n",
                "    return lax.conv(inputs[0], inputs[0], (1, 1), 'SAME')\n"):
        with pytest.raises(tsv_port.ShaderValidationError, match="failed abstract tracing"):
            ShaderRegistry("cpu").register(
                "unknown", "def main(inputs, params, resolution, time):\n" + src)


def test_issubdtype_and_dtypes():
    assert NS.issubdtype(NS.float32, NS.floating)
    assert not NS.issubdtype(NS.int32, NS.floating)
    assert NS.issubdtype(NS.uint8, NS.integer)
    assert NS.asarray(A).dtype == NS.float32 and str(NS.asarray(A).dtype) == "float32"


# ------------------------------------------------- registration, as the reference


def _sources():
    """The shader sources of tests/test_shader_validation.py, by case."""
    return {
        "import": "import os\ndef main(i, p, r, t): return i[0]",
        "dunder_import": ("def main(inputs, params, resolution, time):\n"
                          "    __import__('os').system('touch /tmp/pwned')\n"
                          "    return inputs[0]\n"),
        "dunder_attribute": ("def main(inputs, params, resolution, time):\n"
                             "    cls = ().__class__.__bases__[0].__subclasses__()\n"
                             "    return inputs[0]\n"),
        "open": "def main(i, p, r, t):\n    x = open('/etc/passwd')\n    return i[0]\n",
        "getattr": "def main(i, p, r, t):\n    x = getattr(jnp, 'load')\n    return i[0]\n",
        "numpy_io": "def main(i, p, r, t):\n    jnp.load('/tmp/x.npy')\n    return i[0]\n",
        "rce": "def main(i, p, r, t):\n    return __import__('os').system('true')\n",
        "bad_shape": ("def main(inputs, params, resolution, time):\n"
                      "    return jnp.zeros((10, 10, 4), jnp.float32)\n"),
        "bad_signature": "def main(inputs):\n    return inputs[0]\n",
        "missing_main": "def helper(x):\n    return x\n",
        "non_float": ("def main(inputs, params, resolution, time):\n"
                      "    h, w = resolution[1], resolution[0]\n"
                      "    return jnp.zeros((h, w, 4), jnp.uint8)\n"),
        "two_outputs": ("def main(inputs, params, resolution, time):\n"
                        "    return inputs[0], inputs[0]\n"),
        "branch_on_time": ("def main(inputs, params, resolution, time):\n"
                           "    if time > 1.0:\n"
                           "        return inputs[0]\n"
                           "    return inputs[1]\n"),
        "probe": "def main(inputs, params, resolution, time):\n    return inputs[0]\n",
        "gain": ("def main(inputs, params, resolution, time):\n"
                 "    g = params['gain'] if params else 1.0\n"
                 "    tex = inputs[0]\n"
                 "    rgb = jnp.clip(tex[..., :3] * g, 0.0, 1.0)\n"
                 "    return jnp.concatenate([rgb, tex[..., 3:4]], axis=-1)\n"),
        "many": ("def main(inputs, params, resolution, time):\n"
                 "    h, w = resolution[1], resolution[0]\n"
                 "    return jnp.zeros((h, w, 4), jnp.float32)\n"),
        "invert": ("def main(inputs, params, resolution, time):\n"
                   "    tex = inputs[0]\n"
                   "    return jnp.concatenate([1.0 - tex[..., :3], tex[..., 3:4]],"
                   " axis=-1)\n"),
    }


def _register(registry, source):
    try:
        registry.register("s", source)
    except Exception as exc:  # noqa: BLE001
        return type(exc).__name__, str(exc)
    return "ok", ""


@pytest.mark.parametrize("case", sorted(_sources()))
def test_registration_matches_the_reference(case):
    src = _sources()[case]
    ref = _register(JaxShaderRegistry(), src)
    got = _register(ShaderRegistry("cpu"), src)
    if case == "branch_on_time":
        # both refuse a branch on a traced value; the exception named in
        # the message is each package's own (a JAX tracer error, a "meta"
        # tensor error)
        assert ref[0] == got[0] == "ShaderValidationError"
        prefix = "shader 's' failed abstract tracing with 2 input textures at 64x48: "
        assert ref[1].startswith(prefix) and got[1].startswith(prefix)
    else:
        assert got == ref


def test_validate_source_matches_the_reference():
    """`validate_source` (the AST allowlist) is a verbatim copy: every case
    parses to the same verdict and message."""
    for src in _sources().values():
        answers = []
        for mod in (jsv, tsv_port):
            try:
                mod.validate_source("s", src)
                answers.append(("ok", ""))
            except mod.ShaderValidationError as exc:
                answers.append(("error", str(exc)))
        assert answers[1] == answers[0]
    assert tsv_port.SAFE_BUILTINS.keys() == jsv.SAFE_BUILTINS.keys()
    assert tsv_port._DENIED_NAMES == jsv._DENIED_NAMES
    assert tsv_port._ALLOWED_NODES == jsv._ALLOWED_NODES


def test_exec_namespace_has_no_real_builtins():
    fn = tsv_port.compile_sandboxed("probe", _sources()["probe"])
    globalns = fn.__globals__
    assert isinstance(globalns["__builtins__"], dict)
    assert "__import__" not in globalns["__builtins__"]
    assert isinstance(globalns["jnp"], ShaderNamespace) and globalns["lax"] is globalns["jnp"].lax


# the renderer-level cases of tests/test_shader_validation.py, run on the
# port's renderer through the test module's own functions (their Renderer
# swapped for the port's on the CPU, `test_torch_web.PortRenderer`)
RENDERER_CASES = [
    "test_registry_rejects_rce_source",
    "test_wrong_output_shape_rejected_at_register",
    "test_wrong_signature_rejected_at_register",
    "test_missing_main_rejected",
    "test_non_float_output_rejected",
    "test_params_using_shader_registers_and_renders",
    "test_max_textures_enforced_at_plan_time",
    "test_shader_unregister_before_first_frame",
]


@pytest.mark.parametrize("case", RENDERER_CASES)
def test_renderer_case_on_the_port(case, monkeypatch):
    monkeypatch.setattr(tsv, "Renderer", PortRenderer)
    getattr(tsv, case)()


# ------------------------------------------------------------ shader frames

PULSE = (
    "def main(inputs, params, resolution, time):\n"
    "    # grayscale with a slow pulse back to color\n"
    "    tex = inputs[0]\n"
    "    rgb = tex[..., :3]\n"
    "    luma = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1]\n"
    "            + 0.0722 * rgb[..., 2])[..., None]\n"
    "    mix = 0.5 + 0.5 * jnp.sin(time * 2.0)\n"
    "    out = rgb * mix + luma * (1.0 - mix)\n"
    "    return jnp.concatenate([out, tex[..., 3:4]], axis=-1)\n")
CONTRACT = (
    "def main(inputs, params, resolution, time):\n"
    "    h, w = resolution[1], resolution[0]\n"
    "    n = len(inputs)\n"
    "    col = jnp.array([n / 8.0, time / 4.0, w / 1024.0, 1.0], jnp.float32)\n"
    "    return jnp.broadcast_to(col, (h, w, 4))\n")
INVERT = _sources()["invert"]

# name -> (shader id, source, n inputs, (w, h), pts sequence); the invert and
# contract shaders of tests/test_renderer.py:198 and :475, the docs' pulse
FRAME_CASES = {
    "invert": ("invert", INVERT, 1, (160, 90), (0.0, 0.5)),
    "contract": ("contract", CONTRACT, 2, (512, 288), (0.0, 1.0, 2.0)),
    "pulse": ("pulse", PULSE, 1, (320, 180), (0.0, 0.3, 0.6, 0.9, 1.2)),
}


@pytest.mark.parametrize("fmt", [PixelFormat.RGBA, PixelFormat.PLANAR_YUV420],
                         ids=lambda f: f.value)
@pytest.mark.parametrize("name", sorted(FRAME_CASES))
def test_shader_frames_match_the_reference(name, fmt):
    shader_id, src, n, (w, h), pts_seq = FRAME_CASES[name]
    outs = []
    for cls in (JaxRenderer, TorchRenderer):
        port = cls is TorchRenderer
        r = cls(device="cpu") if port else cls()
        conv = from_reference if port else (lambda x: x)
        for i in range(n):
            r.register_input(f"input_{i}")
        r.register_shader(shader_id, src)
        scene = comp.Shader(shader_id=shader_id, width=float(w), height=float(h),
                            children=[comp.InputStream(input_id=f"input_{i}") for i in range(n)])
        r.update_scene("out", *conv((scene, Resolution(w, h), fmt)))
        frames = []
        for pts in pts_seq:
            fs = FrameSet(pts=pts, frames={f"input_{i}": make_test_input(i, Resolution(w, h), pts)
                                           for i in range(n)})
            data = r.render(conv(fs)).frames["out"].data
            data = data if isinstance(data, tuple) else (data,)
            frames.append([p.numpy() if torch.is_tensor(p) else np.asarray(p) for p in data])
        r.close()
        outs.append(frames)
    for k, (ref, got) in enumerate(zip(*outs)):
        for a, b in zip(ref, got):
            assert a.shape == b.shape and b.dtype == np.uint8
            d = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert int(d.max()) <= 1, f"{name} {fmt.value} frame {k}: {int(d.max())} LSB"


def test_contract_shader_reads_time_on_the_device():
    """The base-params contract: the time enters as a 0-d f32 tensor on the
    renderer's device (here the CPU), and the shader's color is built from it
    without a host value."""
    reg = ShaderRegistry("cpu")
    reg.register("contract", CONTRACT)
    fn = reg.get("contract")
    t = torch.tensor(2.0)
    out = fn([torch.zeros((48, 64, 4))] * 2, None, (64, 48), t)
    assert tuple(out.shape) == (48, 64, 4) and out.dtype == torch.float32
    np.testing.assert_allclose(out[0, 0].numpy(), [0.25, 0.5, 64 / 1024.0, 1.0])

