"""Hand-written Hopper (sm_90a) kernels: one module per kernel, each with its
wrapper, its plain PyTorch version and a launch counter. The CUDA sources
live in `smelter_tpu_torch/csrc/`; `build.py` compiles them on first use."""
