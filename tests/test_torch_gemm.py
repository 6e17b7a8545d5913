"""The two GEMM routes of the port's resizes (`smelter_tpu_torch/ops/
resample.py`: `operand`, `gemm`) on the CPU: the card's route (bf16
operands on the tensor cores) runs only on the card, so these tests hold
what the CPU can reach of it.

  - operands: the card route's bf16 operands equal, bit for bit, the plain
    route's bf16-rounded f32 operands, and both equal the JAX package's
    bf16 casts: the static weights, the tile weights (chroma composed with
    the upsample) and the traced weights, over seeded sizes and crops, and
    u8 and f32 inputs (ties to even included);
  - routes: a CPU call takes the plain route, returns f32 and counts no
    GEMM; the card route refuses operands that are not bf16 and an f32
    product along the rows, before it launches anything.

The outputs of both routes against the JAX package stay in
`tests/test_torch_resample_color.py` and `tests/test_torch_animated.py`;
the card route against the plain one is in `tests/test_torch_cuda.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smelter_tpu.ops import color_convert as jcc
from smelter_tpu.ops import resample as jrs
from smelter_tpu_torch.ops import color_convert as tcc
from smelter_tpu_torch.ops import resample as trs

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    """The bit patterns of a bf16 tensor (as int16) or an f32 one (int32)."""
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _jax_bf16(a) -> torch.Tensor:
    """The JAX package's bf16 cast of `a`, as a torch bf16 tensor."""
    f32 = np.array(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))
    return torch.from_numpy(f32).to(torch.bfloat16)  # exact: the values are bf16


def _both_routes_agree(w: torch.Tensor) -> None:
    card, plain = trs.operand(w, True), trs.operand(w, False)
    assert card.dtype == torch.bfloat16 and plain.dtype == torch.float32
    assert card.is_contiguous()
    np.testing.assert_array_equal(_bits(card.to(torch.float32)), _bits(plain))


@pytest.mark.parametrize("in_size,out_size,kind", [
    (1080, 540, "lanczos3"), (540, 270, "lanczos3"), (1920, 853, "lanczos3"),
    (144, 432, "lanczos3"), (511, 257, "lanczos3"), (100, 37, "bilinear"),
    (37, 100, "bilinear"),
])
def test_static_weights_are_the_references_bf16(in_size, out_size, kind):
    w = trs.axis_weights(in_size, out_size, kind, CPU)
    assert w.dtype == torch.bfloat16 and w.shape == (out_size, in_size)
    np.testing.assert_array_equal(_bits(w), _bits(_jax_bf16(jrs._dense_axis_weights(
        in_size, out_size, kind))))
    _both_routes_agree(w)
    # the plain route's operand is what it was before the card had a route
    old = trs.to_bf16_values(torch.from_numpy(trs._dense_axis_weights(in_size, out_size, kind)))
    np.testing.assert_array_equal(_bits(trs.operand(w, False)), _bits(old))


def _tile_cases():
    rng = np.random.RandomState(17)
    cases = [((144, 256), (72, 128), (0, 0, 144, 256), 156, 277),
             ((1080, 1920), (540, 960), (0, 0, 1080, 1920), 540, 960)]
    for _ in range(4):
        h, w = 2 * rng.randint(40, 120), 2 * rng.randint(40, 160)
        ct, cl = rng.randint(0, h // 4), rng.randint(0, w // 4)
        chh, cww = rng.randint(h // 2, h - ct + 1), rng.randint(w // 2, w - cl + 1)
        cases.append(((h, w), (h // 2, w // 2), (ct, cl, chh, cww),
                      int(rng.randint(16, 200)), int(rng.randint(16, 300))))
    return cases


@pytest.mark.parametrize("luma,chroma,crop,out_h,out_w", _tile_cases())
def test_tile_weights_are_the_references_bf16(luma, chroma, crop, out_h, out_w):
    """`tile_weights` against the weights the reference's
    `yuv_tiles_rgba_cm_batched` builds: the luma resize and the chroma ones
    composed with the upsample, rows cut by the luma crop, cast to bf16."""
    ct, cl, chh, cww = crop
    wh = jrs._dense_axis_weights(chh, out_h, "lanczos3")
    ww = jrs._dense_axis_weights(cww, out_w, "lanczos3")
    uh = jcc._chroma_upsample_matrix(luma[0], chroma[0])
    uw = jcc._chroma_upsample_matrix(luma[1], chroma[1])
    ref = (wh, ww, wh @ uh[ct:ct + chh], ww @ uw[cl:cl + cww])
    got = tcc.tile_weights(luma, chroma, crop, out_h, out_w, "lanczos3", CPU)
    for name, g, r in zip(("Wh", "Ww", "Wch", "Wcw"), got, ref):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == r.shape, name
        np.testing.assert_array_equal(_bits(g), _bits(_jax_bf16(r)), err_msg=name)
        _both_routes_agree(g)


TRACED = [
    # n (source rows), buf, out size, (top, height) of the crop or None
    (90, 64, 47.3, None),
    (45, 192, 150.2, None),
    (90, 64, 60.0, (10.5, 70.5)),
    (45, 128, 101.0, (3.0, 30.0)),
    (37, 64, 64.0, (0.25, 36.5)),
]


@pytest.mark.parametrize("centered", [False, True], ids=["topleft", "centered"])
@pytest.mark.parametrize("n,buf,out,crop", TRACED)
def test_traced_weights_are_the_references_bf16(n, buf, out, crop, centered):
    """The traced weights of the rows, as the reference builds them: its
    `resize_matmul_traced` of an n x n identity, with the columns kept at
    their size (an identity too), returns them exactly."""
    ct, chh = (0.0, float(n)) if crop is None else crop
    jcrop = tuple(jnp.float32(c) for c in (ct, 0.0, n, chh))
    ref = np.asarray(jrs.resize_matmul_traced(
        jnp.eye(n, dtype=jnp.float32), buf, n, jnp.float32(out), jnp.float32(n),
        crop=jcrop, centered=centered))
    got = trs._traced_axis_weights(n, buf, torch.tensor(out), torch.tensor(ct),
                                   torch.tensor(chh), centered)
    assert got.dtype == torch.bfloat16 and got.shape == (buf, n)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_bf16(ref)))
    _both_routes_agree(got)


def test_inputs_convert_to_bf16_alike():
    """u8 planes are exact in bf16; f32 values round to nearest, ties to
    even (values halfway between two bf16 numbers, both ways), as JAX's
    cast does, on both routes."""
    rng = np.random.RandomState(23)
    u8 = rng.randint(0, 256, (3, 37, 61)).astype(np.uint8)
    u8.flat[:2] = (0, 255)
    card, plain = trs.operand(torch.from_numpy(u8), True), trs.operand(torch.from_numpy(u8), False)
    assert card.dtype == torch.bfloat16
    np.testing.assert_array_equal(card.to(torch.float32).numpy(), u8.astype(np.float32))
    np.testing.assert_array_equal(plain.numpy(), u8.astype(np.float32))

    f32 = (rng.rand(4, 29, 53) * 1.4 - 0.2).astype(np.float32)
    bits = f32.view(np.int32).reshape(-1)
    bits[:64] = (bits[:64] & ~0xFFFF) | 0x8000            # ties
    bits[64:128] = (bits[64:128] & ~0xFFFF) | 0x7FFF       # just below a tie
    bits[128:192] = (bits[128:192] & ~0xFFFF) | 0x8001     # just above a tie
    x = torch.from_numpy(f32).permute(1, 2, 0)  # strided, as a texture patch
    card, plain = trs.operand(x, True), trs.operand(x, False)
    assert card.is_contiguous()
    np.testing.assert_array_equal(_bits(card.to(torch.float32)), _bits(plain))
    np.testing.assert_array_equal(_bits(card), _bits(_jax_bf16(f32.transpose(1, 2, 0))))


def test_a_cpu_call_takes_the_plain_route():
    """A CPU tensor's resizes run no GEMM of the card's route (the counter
    stays), and return f32: bf16 values where the reference casts."""
    rng = np.random.RandomState(29)
    y = torch.from_numpy(rng.randint(0, 256, (2, 72, 128)).astype(np.uint8))
    before = trs.LAUNCHES
    out = trs.resize_matmul(y, 40, 70)
    assert out.dtype == torch.float32
    assert torch.equal(out, trs.to_bf16_values(out))
    img = torch.from_numpy(rng.rand(4, 45, 80).astype(np.float32))
    out = trs.resize_matmul_traced(img, 64, 96, torch.tensor(40.5), torch.tensor(70.2))
    assert out.dtype == torch.float32 and out.shape == (4, 64, 96)
    planes = [torch.from_numpy(rng.randint(0, 256, s).astype(np.uint8))
              for s in ((72, 128), (36, 64), (36, 64))]
    out = tcc.yuv_tile_rgba_cm(*planes, (4, 6, 60, 100), 33, 51)
    assert out.dtype == torch.float32 and out.shape == (4, 33, 51)
    assert trs.LAUNCHES == before


def test_the_card_route_takes_only_bf16_and_keeps_only_columns_in_f32():
    w = torch.ones((3, 5))
    x = torch.ones((5, 4))
    before = trs.LAUNCHES
    with pytest.raises(TypeError, match="bf16 operands"):
        trs.gemm(w, x, -2, torch.bfloat16, True)
    with pytest.raises(ValueError, match="only a column product"):
        trs.gemm(w.bfloat16(), x.bfloat16(), -2, torch.float32, True)
    assert trs.LAUNCHES == before


@pytest.mark.parametrize("dim,out_dtype", [(-2, torch.bfloat16), (-1, torch.bfloat16),
                                           (-1, torch.float32)])
def test_the_plain_route_is_an_f32_gemm_on_bf16_values(dim, out_dtype):
    """The plain route's product is the f32 GEMM of the bf16 values,
    rounded to bf16 values where the card writes bf16; a batch broadcasts
    the weights."""
    rng = np.random.RandomState(31)
    w = trs.operand(torch.from_numpy(rng.rand(7, 11).astype(np.float32)), False)
    shape = (3, 11, 5) if dim == -2 else (3, 5, 11)
    x = trs.operand(torch.from_numpy(rng.rand(*shape).astype(np.float32) * 255), False)
    got = trs.gemm(w, x, dim, out_dtype, False)
    want = torch.stack([w @ x[i] if dim == -2 else x[i] @ w.t() for i in range(3)])
    if out_dtype == torch.bfloat16:
        want = trs.to_bf16_values(want)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)
