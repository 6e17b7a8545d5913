"""smelter_tpu_torch: the PyTorch + CUDA port of smelter_tpu for NVIDIA Hopper.

The JAX package (`smelter_tpu`) is the reference; each module here mirrors
the module of the same path there and is held against it by the
`tests/test_torch_*.py` parity tests. Plain tensor code is PyTorch; every
Pallas kernel of the reference becomes a hand-written CUDA kernel under
`csrc/`, built with nvcc on first use (`ops/hopper/build.py`).

This package never imports JAX, and imports nothing of the reference
package: the host modules it needs (`core/types.py`, `scene/`,
`utils/tracing.py`) are its own copies, verbatim apart from their imports.
`interop.from_reference` carries a scene built with the reference's classes
across to these.

Ported so far: the flagship compose (`parallel/flagship.py`), 16 x 1080p
YUV420 inputs composed into one 4K YUV420 frame as an opaque Tiles grid and
as the `general_4k` scene, and the renderer with its frame program
(`render/`). Every entry point runs on the CUDA card unless it is given
`device="cpu"`.
"""

__version__ = "0.1.0"
