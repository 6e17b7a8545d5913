"""Runnable examples of the port, the counterparts of the JAX package's
`examples/`: `python -m smelter_tpu_torch.examples.<name> ...`. Each composes
on the CUDA card unless `SMELTER_DEVICE=cpu` is set."""

import os


def device_from_env():
    """The device the examples compose on: the CPU under `SMELTER_DEVICE=cpu`,
    else the CUDA card (None: the pipeline raises without one)."""
    return "cpu" if os.environ.get("SMELTER_DEVICE", "").strip().lower() == "cpu" else None
