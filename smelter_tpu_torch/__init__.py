"""smelter_tpu_torch: the PyTorch + CUDA port of smelter_tpu for NVIDIA Hopper.

The JAX package (`smelter_tpu`) is the reference; each module here mirrors
the module of the same path there and is held against it by the
`tests/test_torch_*.py` parity tests. Plain tensor code is PyTorch; every
Pallas kernel of the reference becomes a hand-written CUDA kernel under
`csrc/`, built with nvcc on first use (`ops/hopper/build.py`).

This package never imports JAX. Of the reference it reuses, by import, only
the host modules that are JAX-free: `smelter_tpu.core.types` and
`smelter_tpu.scene`.

The slice ported so far is the flagship compose (`parallel/flagship.py`):
16 x 1080p YUV420 inputs composed into one 4K YUV420 frame, as an opaque
Tiles grid and as the `general_4k` scene of rounded, bordered, shadowed and
rotated tiles.
"""

__version__ = "0.1.0"
