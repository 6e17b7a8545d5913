"""HTTP/WS API server (reference root crate `src/`)."""

from smelter_tpu_torch.server.app import ApiState, build_app, run

__all__ = ["ApiState", "build_app", "run"]
