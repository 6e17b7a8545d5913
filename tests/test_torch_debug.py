"""The debug mode (`SMELTER_XLA_DEBUG`) in both packages, flag on and off.

The reference's `config.apply_xla_debug` arms jax's NaN/Inf checks, and
what they do there is pinned here first, on the reference alone:
  - a float result that holds NaN or Inf, computed at the top level (a
    `jax.jit` called from Python, or the eager chain of
    `color_convert.planar_rgba_to_yuv420`), raises FloatingPointError;
  - a frame program returns u8 planes, which no check sees: a shader that
    yields NaN and Inf renders a frame to RGBA and to YUV420.
The port's `config.apply_xla_debug` must do the same to the port's
counterparts (`config.check_finite`): the same YUV420 output entry raises
on the same canvas; the kernels K1 and K3, whose reference counterparts are
jitted with f32 results, raise at the top level and never inside a frame
program; and the NaN shader's frames equal the reference's within 1 u8
LSB, NaN and Inf pixels included, flag on and off. Both servers' `run`
arm the mode from `Config.xla_debug`.

Every test resets the process-wide flags of both packages after it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import make_test_input
from smelter_tpu import config as jconfig
from smelter_tpu.core.types import FrameSet, PixelFormat, Resolution
from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.scene import components as comp
from smelter_tpu_torch import config as tconfig
from smelter_tpu_torch.interop import from_reference, layout_params
from smelter_tpu_torch.ops import color_convert as tcc
from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers
from smelter_tpu_torch.render.capture import capture, in_program
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer

torch.set_num_threads(2)

# in the left half, bands of NaN, +Inf and -Inf rows over the input (their
# edges at odd rows and columns, so that some 2x2 chroma quads mix bad and
# finite pixels); `jnp.log` is outside the port's shader namespace, `sqrt`
# of a negative number gives the same NaN
NAN_SHADER = (
    "def main(inputs, params, resolution, time):\n"
    "    h, w = resolution[1], resolution[0]\n"
    "    tex = inputs[0]\n"
    "    rgb = tex[..., :3]\n"
    "    row = jnp.arange(h)[:, None, None] + 0.0 * rgb\n"
    "    col = jnp.arange(w)[None, :, None] + 0.0 * rgb\n"
    "    nan = jnp.sqrt(rgb - 2.0)\n"
    "    inf = 1.0 / (rgb * 0.0)\n"
    "    bad = jnp.where(row < 23, nan, jnp.where(row < 45, inf, -inf))\n"
    "    out = jnp.where((col < 79) & (row < 67), bad, rgb)\n"
    "    return jnp.concatenate([out, tex[..., 3:4]], axis=-1)\n")


@pytest.fixture(autouse=True)
def _reset_debug_flags(monkeypatch):
    monkeypatch.setattr(tconfig, "_debug_nans_infs", False)
    yield
    jax.config.update("jax_debug_nans", False)
    jax.config.update("jax_debug_infs", False)


def _arm(on: bool) -> None:
    jconfig.apply_xla_debug(on)
    tconfig.apply_xla_debug(on)


def _canvas(bad: float, channel: int = 1) -> np.ndarray:
    c = np.random.RandomState(0).rand(4, 18, 34).astype(np.float32)
    c[channel, 5, 7] = bad
    return c


def _outcome(call):
    try:
        out = call()
        jax.block_until_ready(out) if not isinstance(out[0], torch.Tensor) else None
    except FloatingPointError as exc:
        return "FloatingPointError", str(exc).split(" encountered")[0]
    return "ok", None


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_reference_jit_with_a_float_result_raises(on):
    """The reference's own behaviour: a jit's float output with NaN raises,
    a jit's u8 output computed from NaN does not."""
    _arm(on)
    x = jnp.asarray([-1.0, 4.0])
    expect = ("FloatingPointError", "invalid value (nan)") if on else ("ok", None)
    assert _outcome(lambda: (jax.jit(jnp.sqrt)(x),)) == expect
    u8 = jax.jit(lambda v: (jnp.sqrt(v) * 0 + 1).astype(jnp.uint8))
    assert _outcome(lambda: (u8(x),)) == ("ok", None)


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("bad,channel", [(np.nan, 0), (np.inf, 1), (-np.inf, 2), (np.nan, 3)],
                         ids=["nan_r", "inf_g", "neg_inf_b", "nan_alpha"])
def test_yuv420_output_of_a_bad_canvas_in_both(on, bad, channel):
    """`planar_rgba_to_yuv420` at the top level: both raise on NaN or Inf
    in a colour plane with the flag on (the reference at its first
    operation, the port before K2), neither for alpha, which is never read,
    nor with the flag off; the planes agree when nothing raises."""
    _arm(on)
    c = _canvas(bad, channel)
    ref = _outcome(lambda: jcc.planar_rgba_to_yuv420(jnp.asarray(c)))
    got = _outcome(lambda: tcc.planar_rgba_to_yuv420(torch.from_numpy(c)))
    kind = "inf" if np.isinf(bad) else "nan"
    raises = on and channel < 3
    assert ref == got == (("FloatingPointError", f"invalid value ({kind})") if raises
                          else ("ok", None))
    if not raises:
        for a, b in zip(jcc.planar_rgba_to_yuv420(jnp.asarray(c)),
                        tcc.planar_rgba_to_yuv420(torch.from_numpy(c))):
            d = np.abs(np.asarray(a).astype(np.int32) - b.numpy().astype(np.int32))
            assert int(d.max()) <= 1


def _k1_nan():
    spec = scene_assembly.MemberSpec("color", False, False, 0, (), (0, 0, 18, 34))
    p = layout_params(dict(top=float("nan"), left=2.0, width=8.0, height=8.0,
                           rotation_degrees=0.0, border_radius=(0.0,) * 4,
                           color=(1.0, 0.0, 0.0, 1.0), border_width=0.0,
                           border_color=(0.0,) * 4, crop=(0, 0, 0, 0), blur_radius=0.0,
                           masks=[[0.0] * 9]), "cpu")
    params = scene_assembly.pack_member_params([p], 0)
    return lambda: (scene_assembly.assemble_scene_planar((34, 18), [spec], params),)


def _k3_nan():
    canvas = torch.from_numpy(_canvas(np.nan))
    rows = torch.zeros((1, sdf_layers.PARAMS_WIDTH))
    rows[0, :4] = torch.tensor([2.0, 2.0, 8.0, 8.0])
    return lambda: (sdf_layers.compose_sdf_layers_planar(canvas.clone(), rows,
                                                         [("color", False, False)]),)


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("kernel", ["scene_assembly", "sdf_layers"])
def test_port_kernels_check_their_float_results_only_at_the_top_level(on, kernel):
    """K1 and K3 return f32 canvases (the reference jits both,
    `_assemble_call` and `_compose_call`): with the flag on a NaN result
    raises at the top level; inside a frame program (here a captured
    program on the CPU, built and run) it never does."""
    tconfig.apply_xla_debug(on)
    call = {"scene_assembly": _k1_nan, "sdf_layers": _k3_nan}[kernel]()
    assert not in_program()
    expect = ("FloatingPointError", "invalid value (nan)") if on else ("ok", None)
    assert _outcome(call) == expect
    x = torch.zeros(1)
    prog, out = capture(lambda t: call()[0] + t, (x,), "cpu")
    assert bool(torch.isnan(out).any()) and bool(torch.isnan(prog(x)).any())
    assert not in_program()


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("fmt", [PixelFormat.RGBA, PixelFormat.PLANAR_YUV420],
                         ids=lambda f: f.value)
def test_nan_shader_renders_in_both(on, fmt):
    """A shader yielding NaN, +Inf and -Inf renders a frame in both packages
    (u8 planes: no check sees them), and the frames agree within 1 LSB."""
    _arm(on)
    w, h = 160, 90
    outs = []
    for port in (False, True):
        r = TorchRenderer(device="cpu") if port else JaxRenderer()
        conv = from_reference if port else (lambda x: x)
        r.register_input("input_0")
        r.register_shader("bad", NAN_SHADER)
        scene = comp.Shader(shader_id="bad", width=float(w), height=float(h),
                            children=[comp.InputStream(input_id="input_0")])
        r.update_scene("out", *conv((scene, Resolution(w, h), fmt)))
        fs = FrameSet(pts=0.0, frames={"input_0": make_test_input(0, Resolution(w, h), 0.0)})
        data = r.render(conv(fs)).frames["out"].data
        r.close()
        data = data if isinstance(data, tuple) else (data,)
        outs.append([p.numpy() if torch.is_tensor(p) else np.asarray(p) for p in data])
    for ref, got in zip(*outs):
        assert ref.shape == got.shape and got.dtype == np.uint8
        d = np.abs(ref.astype(np.int32) - got.astype(np.int32))
        assert int(d.max()) <= 1
    # the frame holds finite pixels beside the bad ones
    assert len(np.unique(outs[0][0])) > 2


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("package", ["reference", "port"])
def test_server_run_arms_the_mode_from_the_config(monkeypatch, on, package):
    if package == "reference":
        from smelter_tpu.server import app
        cfg_mod, flag = jconfig, lambda: bool(jax.config.jax_debug_nans)
    else:
        from smelter_tpu_torch.server import app
        cfg_mod, flag = tconfig, lambda: tconfig._debug_nans_infs
    monkeypatch.delenv("SMELTER_DEVICE", raising=False)
    monkeypatch.setattr(cfg_mod, "init_logger", lambda _cfg: None)
    monkeypatch.setattr(app, "ApiState", lambda _cfg: None)
    monkeypatch.setattr(app, "build_app", lambda _state: {})
    served = []
    monkeypatch.setattr(app.web, "run_app", lambda *a, **k: served.append(k["port"]))
    app.run(cfg_mod.Config(xla_debug=on, api_port=1))
    assert served == [1] and flag() is on
