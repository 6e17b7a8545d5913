"""The port's 16-bit root planar canvas (`SMELTER_CANVAS_DTYPE`,
`smelter_tpu_torch/ops/compose.py:_canvas_dtype`) and its canvas-opening
route switch (`SMELTER_SCENE_ASSEMBLY`, `_assembly_mode`) against the JAX
package on the CPU, with numpy inputs from a seed through both packages.

The JAX side runs as its own tests run it (`tests/test_canvas_u16.py`,
`tests/test_scene_assembly.py`): its Pallas kernels in interpret mode, the
scene-assembly route and the fused YUV output forced on where a test says
so. Tolerances, each with its reason:

  - encode and decode: bit-equal, a NaN of a float storage as a NaN (torch
    and XLA give a bf16 NaN other payload bits). Both round half to even,
    clip and cast the same f32 values, and the u16 decode is exact in f32.
  - K1's plain version with a 16-bit store against the reference's kernel:
    the existing K1 tolerance on the decoded canvas (atol 2e-5: the SDF
    chains round in another order) plus one quantization step of the
    storage (u16 2^-13; f16 2^-11 and bf16 2^-8, their spacing below 1.0,
    premultiplied values being in [0, 1]), since two values 2e-5 apart can
    round to neighbouring codes.
  - K2's plain version on a 16-bit canvas against the reference's fused
    kernel on the same stored bits: <= 1 u8 LSB, the K2 tolerance (sums of
    another order can cross a rounding boundary).
  - the flagship general scene and the renderer, port against reference
    under the same switch, and the port's u16 against its own f32:
    <= 1 u8 LSB per pixel on every YUV plane, the port's correctness gate
    (the reference's own u16 test holds its u16 to its f32 at that bound).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from harness import make_test_input
from smelter_tpu.core.types import FrameSet, PixelFormat, Resolution, RGBAColor
from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.ops import compose as jcomp
from smelter_tpu.ops.pallas import yuv_out as jyuv
from smelter_tpu.render.renderer import Renderer as JaxRenderer
from smelter_tpu.scene import components as comp
from smelter_tpu.scene.layout_types import BorderRadius, BoxShadow
from smelter_tpu_torch import interop
from smelter_tpu_torch.interop import from_reference
from smelter_tpu_torch.ops import color_convert as tcc
from smelter_tpu_torch.ops import compose as tcomp
from smelter_tpu_torch.ops.hopper import scene_assembly, sdf_layers, yuv_out
from smelter_tpu_torch.parallel import flagship as tflag
from smelter_tpu_torch.render.renderer import Renderer as TorchRenderer
from test_canvas_u16 import _flagship_yuv
from test_torch_scene_assembly import CASES, _port

torch.set_num_threads(2)

STORAGE = {  # name -> (port dtype, reference dtype, quantization step below 1.0)
    "uint16": (torch.uint16, jnp.uint16, 2.0 ** -13),
    "float16": (torch.float16, jnp.float16, 2.0 ** -11),
    "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8),
}
K1_ATOL = 2e-5  # tests/test_torch_scene_assembly.py


def _bits(a) -> np.ndarray:
    """The stored bits of a 16-bit array or tensor (uint16) or of an f32 one
    (uint32), so that NaN compares by its pattern."""
    if torch.is_tensor(a):
        a = a.view(torch.uint16) if a.element_size() == 2 else a
        return a.numpy().view(np.uint16 if a.element_size() == 2 else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _assert_same_storage(got, ref):
    """Bit-equal, a NaN of a float storage matching any NaN."""
    g, r = _bits(got), _bits(ref)
    if torch.is_tensor(got) and got.is_floating_point():
        nan = torch.isnan(got.float()).numpy()
        np.testing.assert_array_equal(nan, np.isnan(np.asarray(ref, np.float32)))
        g, r = g[~nan], r[~nan]
    np.testing.assert_array_equal(g, r)


def _to_torch(a) -> torch.Tensor:
    """A reference array in its storage dtype as a tensor of the same bits
    (numpy has no bfloat16: the bits travel as uint16)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _encode_inputs() -> np.ndarray:
    special = [0.0, 1.0, -0.0, -2.0, 5.99, 6.0, -3.0, 7.0, 1e30, -1e30,
               np.inf, -np.inf, np.nan, 0.5 / 8192, 1.5 / 8192, 2.5 / 8192]
    return np.concatenate([np.linspace(-1.9, 5.9, 4096, dtype=np.float32),
                           np.asarray(special, np.float32)])


def _max_lsb(ref, got) -> int:
    return max(int(np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32)).max())
               for a, b in zip(ref, got))


# -- encode and decode ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(STORAGE))
def test_encode_and_decode_are_bit_equal_to_the_reference(name):
    tdt, jdt, _ = STORAGE[name]
    x = _encode_inputs()
    ref = jcomp._canvas_encode(jnp.asarray(x), jdt)
    got = tcomp._canvas_encode(torch.from_numpy(x), tdt)
    assert got.dtype == tdt
    _assert_same_storage(got, ref)
    _assert_same_storage(tcc.canvas_decode(got), jcc.canvas_decode(ref))


def test_nan_encodes_to_code_zero():
    """The reference's clip keeps NaN and its cast gives 0; the port pins
    that code rather than leaving it to a cast: NaN is stored as 0 and
    decodes to -2.0, in `_canvas_encode` and in K1's plain store."""
    nan = torch.tensor([float("nan")])
    code = tcomp._canvas_encode(nan, torch.uint16)
    assert int(code[0]) == 0 == int(np.asarray(jcomp._canvas_encode(jnp.asarray([np.nan]),
                                                                     jnp.uint16))[0])
    assert float(tcc.canvas_decode(code)[0]) == -2.0
    spec = scene_assembly.MemberSpec("color", False, False, 0, (), (0, 0, 4, 8))
    params = torch.zeros((1, scene_assembly.PARAMS_BASE))
    params[0, 2:4] = torch.tensor([8.0, 4.0])
    params[0, 9:13] = torch.tensor([float("nan"), 0.5, 0.5, 1.0])
    canvas = scene_assembly.assemble_scene_planar((8, 4), [spec], params,
                                                  out_dtype=torch.uint16)
    codes = canvas.to(torch.int32)
    assert canvas.dtype == torch.uint16 and int(codes[0].max()) == 0
    assert int(codes[3].min()) == 16384 + 8192  # alpha 1.0 is exact


def test_transparent_and_background_canvases():
    """A transparent u16 canvas is the fixed-point zero level; a background
    is encoded; an RGBA (non-planar) canvas never quantizes."""
    got = tcomp.compose_layouts((8, 4), [], [], [], planar=True, device="cpu",
                                canvas_dtype=torch.uint16)
    assert got.dtype == torch.uint16 and bool((got == 16384).all())
    bg = torch.rand((4, 8, 4), generator=torch.Generator().manual_seed(0))
    got = tcomp.compose_layouts((8, 4), [], [], [], background=bg, planar=True,
                                device="cpu", canvas_dtype=torch.uint16)
    assert torch.equal(got, tcomp._canvas_encode(bg.permute(2, 0, 1), torch.uint16))
    got = tcomp.compose_layouts((8, 4), [], [], [], background=bg, planar=False,
                                device="cpu", canvas_dtype=torch.uint16)
    assert got.dtype == torch.float32 and torch.equal(got, bg)


# -- the switches -----------------------------------------------------------------


def test_canvas_dtype_routing(monkeypatch):
    """`tests/test_canvas_u16.py:test_canvas_dtype_routing` on the port:
    auto = f32 (on the card as on the CPU), the reference's names and
    aliases, RGBA canvases never quantize."""
    monkeypatch.delenv("SMELTER_CANVAS_DTYPE", raising=False)
    assert tcomp._canvas_dtype(planar=False) == torch.float32
    assert tcomp._canvas_dtype(planar=True) == torch.float32
    for mode, want in (("uint16", torch.uint16), ("u16", torch.uint16),
                       ("float16", torch.float16), ("f16", torch.float16),
                       ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
                       ("float32", torch.float32), ("auto", torch.float32)):
        monkeypatch.setenv("SMELTER_CANVAS_DTYPE", mode)
        assert tcomp._canvas_dtype(planar=True) == want, mode
        assert tcomp._canvas_dtype(planar=False) == torch.float32, mode
    monkeypatch.setenv("SMELTER_SCENE_ASSEMBLY", "off")
    assert tcomp._assembly_mode() == "off"
    monkeypatch.delenv("SMELTER_SCENE_ASSEMBLY")
    assert tcomp._assembly_mode() == "auto"


def test_builders_read_the_switches_when_built(monkeypatch):
    """The single-device general builder stores the canvas as the switch
    said while it was built, whatever the environment says later; the
    multi-device general step keeps f32 (the reference's sharded traces
    force f32)."""
    from torch.distributed.device_mesh import init_device_mesh

    from smelter_tpu_torch.core.types import Resolution as TRes
    from smelter_tpu_torch.parallel import mesh as meshes

    dtypes = []
    compose = tflag.compose_layouts

    def spy(*args, **kw):
        out = compose(*args, **kw)
        dtypes.append(out.dtype)
        return out

    monkeypatch.setattr(tflag, "compose_layouts", spy)
    monkeypatch.setenv("SMELTER_CANVAS_DTYPE", "uint16")
    fn, args = tflag.make_flagship_general_compose(2, TRes(128, 96), TRes(512, 160),
                                                   device="cpu")
    monkeypatch.delenv("SMELTER_CANVAS_DTYPE")
    fn(*args)
    assert dtypes == [torch.uint16, torch.uint16]  # the warm-up run, then this one
    dtypes.clear()
    monkeypatch.setenv("SMELTER_CANVAS_DTYPE", "uint16")
    with meshes.process_group("cpu"):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("streams", "space"))
        step, args = tflag.make_multichip_general_step(mesh, 2, TRes(64, 36), TRes(128, 72),
                                                       device="cpu")
        step(*args)
    assert dtypes == [torch.float32]


@pytest.mark.parametrize("name", sorted(STORAGE))
@pytest.mark.parametrize("mode", ["on", "off"])
def test_compose_layouts_returns_the_requested_dtype(monkeypatch, name, mode):
    """`tests/test_canvas_u16.py:test_u16_canvas_dtype_propagates` on the
    port, for each 16-bit storage and each route of the opening run: the
    stored canvas has the requested dtype and equals the reference's bit
    for bit (the solid rect is exact in every storage)."""
    tdt, jdt, _ = STORAGE[name]
    statics = [jcomp.LayoutStatic(content="color", static_rect=(2, 2, 6, 8))]
    params = [jcomp.LayoutParams(
        top=jnp.float32(2.0), left=jnp.float32(2.0),
        width=jnp.float32(8.0), height=jnp.float32(6.0),
        rotation_degrees=jnp.float32(0.0),
        border_radius=jnp.zeros(4, jnp.float32),
        border_width=jnp.float32(0.0),
        border_color=jnp.zeros(4, jnp.float32),
        color=jnp.asarray([1.0, 0.0, 0.0, 1.0], jnp.float32),
        crop=jnp.zeros(4, jnp.float32),
        blur_radius=jnp.float32(0.0),
        masks=jnp.zeros((0, 9), jnp.float32),
    )]
    monkeypatch.setenv("SMELTER_CANVAS_DTYPE", name)
    monkeypatch.setenv("SMELTER_SCENE_ASSEMBLY", mode)
    ref = jcomp.compose_layouts((16, 8), statics, params, [], planar=True)
    st, pr, _ = _port(statics, params, None)
    got = tcomp.compose_layouts((16, 8), st, pr, [], planar=True)
    assert ref.dtype == jdt and got.dtype == tdt
    _assert_same_storage(got, ref)
    dec = tcc.canvas_decode(got).numpy()
    assert np.allclose(dec[:, 4, 4], [1, 0, 0, 1], atol=1e-6)
    assert np.allclose(dec[:, 0, 0], 0, atol=1e-6)


# -- the kernels' plain versions ----------------------------------------------------


@pytest.mark.parametrize("name", sorted(STORAGE))
@pytest.mark.parametrize("case", ["mixed", "two_masks", "fractional"])
def test_k1_plain_store_matches_pallas_interpret(monkeypatch, name, case):
    """K1 alone with a 16-bit store: the reference's kernel in interpret
    mode with the same `out_dtype`, compared decoded."""
    tdt, jdt, step = STORAGE[name]
    (w, h), statics, params, src = CASES[case]()
    monkeypatch.setenv("SMELTER_SCENE_ASSEMBLY", "on")
    clip = tcomp.canvas_clipper(h, w)
    items = list(zip(statics, params))
    ref, ref_group = jcomp._try_scene_assembly(items, 0, len(items), [], h, w, clip,
                                               out_dtype=jdt)
    st, pr, _ = _port(statics, params, src)
    got, got_group = tcomp._try_scene_assembly(list(zip(st, pr)), 0, len(st), [], h, w,
                                               clip, None, tdt)
    assert [s.content for s, _ in got_group] == [s.content for s, _ in ref_group]
    assert ref.dtype == jdt and got.dtype == tdt
    d = np.abs(tcc.canvas_decode(got).numpy() - np.asarray(jcc.canvas_decode(ref)))
    assert d.max() <= K1_ATOL + step, (name, case, float(d.max()))


@pytest.mark.parametrize("name", sorted(STORAGE))
@pytest.mark.parametrize("full_range", [False, True])
def test_k2_plain_reads_16_bit_canvases_as_the_fused_kernel(name, full_range):
    tdt, jdt, _ = STORAGE[name]
    rng = np.random.RandomState(11)
    canvas = (rng.rand(4, 272, 512) * 1.3 - 0.1).astype(np.float32)
    stored = jcomp._canvas_encode(jnp.asarray(canvas), jdt)
    ref = jyuv.rgba_cm_to_yuv420_fused(stored, full_range)
    got = yuv_out.rgba_cm_to_yuv420(_to_torch(stored), full_range)
    assert all(p.dtype == torch.uint8 for p in got)
    assert _max_lsb(ref, got) <= 1
    # the converters decode the same stored bits as the reference's chain
    want = jcc.planar_rgba_to_yuv444(stored, full_range)
    assert _max_lsb(want, tcc.planar_rgba_to_yuv444(_to_torch(stored), full_range)) <= 1


def test_k2_raises_on_other_dtypes():
    with pytest.raises(ValueError, match="K2 takes"):
        yuv_out._launch(torch.zeros((4, 8, 8), dtype=torch.int32), False)


def test_k1_raises_on_other_dtypes():
    spec = scene_assembly.MemberSpec("color", False, False, 0, (), (0, 0, 4, 8))
    with pytest.raises(ValueError, match="K1 stores"):
        scene_assembly.assemble_scene_planar((8, 4), [spec], torch.zeros((1, 19)),
                                             out_dtype=torch.int16)


# -- the flagship general scene ---------------------------------------------------


def _port_flagship(monkeypatch, dtype: str, assembly: str):
    """The port's general builder at the reference test's size and seed
    (`tests/test_canvas_u16.py:_flagship_yuv`), the switches set while it is
    built; returns the u8 planes and the dtype of the canvas it composed."""
    from smelter_tpu_torch.core.types import Resolution as TRes

    n, in_res = 2, Resolution(128, 96)
    rng = np.random.RandomState(7)
    y = rng.randint(16, 235, (n, in_res.height, in_res.width), np.uint8)
    u = rng.randint(16, 240, (n, in_res.height // 2, in_res.width // 2), np.uint8)
    v = rng.randint(16, 240, (n, in_res.height // 2, in_res.width // 2), np.uint8)
    dtypes = []
    convert = tcc.planar_rgba_to_yuv420

    def spy(canvas, full_range=False):
        dtypes.append(canvas.dtype)
        return convert(canvas, full_range)

    monkeypatch.setattr(tcc, "planar_rgba_to_yuv420", spy)
    monkeypatch.setenv("SMELTER_CANVAS_DTYPE", dtype)
    monkeypatch.setenv("SMELTER_SCENE_ASSEMBLY", assembly)
    fn, _ = tflag.make_flagship_general_compose(n, TRes(128, 96), TRes(512, 160),
                                                device="cpu")
    monkeypatch.delenv("SMELTER_CANVAS_DTYPE")
    monkeypatch.delenv("SMELTER_SCENE_ASSEMBLY")
    planes = interop.planes_to_host(fn(*interop.planes_to_device((y, u, v), "cpu")))
    return planes, dtypes[-1]


@pytest.fixture(scope="module")
def reference_flagship():
    """The reference's u8 planes of the scene under each storage (its test's
    own function: scene assembly and fused YUV on, interpret mode)."""
    return {name: _flagship_yuv(name) for name in ("float32", *sorted(STORAGE))}


@pytest.mark.parametrize("name", sorted(STORAGE))
@pytest.mark.parametrize("assembly", ["on", "off"])
def test_flagship_general_matches_the_reference(monkeypatch, reference_flagship, name,
                                                assembly):
    got, dtype = _port_flagship(monkeypatch, name, assembly)
    assert dtype == STORAGE[name][0]
    ref = reference_flagship[name]
    for plane, a, b in zip("yuv", ref, got):
        assert a.shape == b.shape and b.dtype == np.uint8, plane
    assert _max_lsb(ref, got) <= 1, (name, assembly)
    if name == "uint16":
        f32, dtype = _port_flagship(monkeypatch, "float32", assembly)
        assert dtype == torch.float32
        assert _max_lsb(f32, got) <= 1


# -- the renderer: K3 and the sampled pass on a 16-bit root ------------------------


def _banner_scene(left):
    """A Tiles grid under a bordered, shadowed banner that slides: K1 opens
    the canvas, the tiles blend in groups and the moving banner takes K3."""
    return comp.View(background_color=RGBAColor(20, 20, 20), children=[
        comp.Tiles(children=[comp.Rescaler(child=comp.InputStream(input_id=f"input_{i}"))
                             for i in range(4)],
                   background_color=RGBAColor(16, 16, 16), margin=4.0),
        comp.View(id="banner", position=comp.AbsolutePosition(
                      width=240.0, height=40.0, top=150.0, left=left),
                  background_color=RGBAColor(200, 30, 30, 230),
                  border_radius=BorderRadius(12, 12, 12, 12),
                  border_width=3.0, border_color=RGBAColor(255, 255, 255, 255),
                  box_shadow=[BoxShadow(offset_x=4, offset_y=4, blur_radius=10,
                                        color=RGBAColor(0, 0, 0, 160))],
                  transition=comp.Transition(duration=1.0)),
    ])


def _render(renderer_cls, dtype: str, monkeypatch):
    out, in_res = Resolution(384, 216), Resolution(96, 54)
    monkeypatch.setenv("SMELTER_CANVAS_DTYPE", dtype)
    port = renderer_cls is TorchRenderer
    r = renderer_cls(device="cpu") if port else renderer_cls()
    conv = from_reference if port else (lambda x: x)
    for i in range(4):
        r.register_input(f"input_{i}")
    frames = []
    for scene, pts in ((_banner_scene(20.0), 0.0), (_banner_scene(120.0), 0.25),
                       (None, 0.5), (None, 0.75)):
        if scene is not None:
            r.update_scene("out", *conv((scene, out, PixelFormat.PLANAR_YUV420)))
        fs = FrameSet(pts=pts, frames={f"input_{i}": make_test_input(i, in_res, pts)
                                       for i in range(4)})
        data = r.render(conv(fs)).frames["out"].data
        frames.append(tuple(p.numpy() if torch.is_tensor(p) else np.asarray(p) for p in data))
    return frames


def test_renderer_on_a_u16_root_matches_the_reference(monkeypatch):
    """The banner's moving frames run K3 on the decoded root canvas; every
    frame within 1 LSB of the reference's renderer under the same switch,
    and of the port's own f32 run."""
    calls = []
    k3 = sdf_layers.compose_sdf_layers_planar

    def spy(canvas, params, kinds, table=None):
        calls.append(canvas.dtype)
        return k3(canvas, params, kinds, table)

    monkeypatch.setattr(sdf_layers, "compose_sdf_layers_planar", spy)
    ref = _render(JaxRenderer, "uint16", monkeypatch)
    got = _render(TorchRenderer, "uint16", monkeypatch)
    assert calls and set(calls) == {torch.float32}
    f32 = _render(TorchRenderer, "float32", monkeypatch)
    for k, (a, b, c) in enumerate(zip(ref, got, f32)):
        assert _max_lsb(a, b) <= 1, k
        assert _max_lsb(c, b) <= 1, k
