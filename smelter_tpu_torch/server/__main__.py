"""`python -m smelter_tpu_torch.server` — start the standalone server
(reference `src/bin/main_process.rs`)."""

from smelter_tpu_torch.server.app import run

if __name__ == "__main__":
    run()
