"""The north-star live configuration: 16 x 1080p inputs -> one 4K60 output.

Usage: python -m smelter_tpu_torch.examples.flagship_live source_1080p.mp4 out.mp4 [seconds]

Every input loops the same file; the output is encoded to `out.mp4` for
`seconds` (10 by default) in real time. Composes on the CUDA card;
`SMELTER_DEVICE=cpu` composes on the CPU. The end-to-end rate is bounded
by the host's decode and encode cores (16 x 1080p decode + a 4K encode).
"""

import sys
import time

from smelter_tpu_torch.core.types import Framerate, Resolution, RGBAColor
from smelter_tpu_torch.examples import device_from_env
from smelter_tpu_torch.pipeline import (
    EndCondition,
    Mp4Input,
    Mp4InputOptions,
    Mp4OutputSink,
    OutputVideoOptions,
    Pipeline,
    PipelineOptions,
    RegisterInputOptions,
    VideoEncoderOptions,
)
from smelter_tpu_torch.scene import components as comp


def run(src, out_path, duration=10.0, n_inputs=16, resolution=Resolution(3840, 2160),
        framerate=60, device=None):
    """Compose `n_inputs` loops of `src` into a Tiles grid at `resolution`,
    live at `framerate`, for `duration` seconds. Returns the pipeline's
    stats."""
    pipeline = Pipeline(PipelineOptions(output_framerate=Framerate(framerate)), device=device)
    ids = [f"cam_{i}" for i in range(n_inputs)]
    try:
        for iid in ids:
            pipeline.register_input(
                iid, Mp4Input(Mp4InputOptions(path=src, loop=True)),
                RegisterInputOptions(),
            )
        pipeline.register_output(
            "out", Mp4OutputSink(out_path),
            video=OutputVideoOptions(
                resolution=resolution,
                encoder=VideoEncoderOptions(codec="h264", preset="ultrafast"),
                initial_root=comp.Tiles(
                    children=[comp.InputStream(input_id=i) for i in ids],
                    background_color=RGBAColor(8, 8, 8),
                ),
                end_condition=EndCondition(),
            ),
        )
        pipeline.start()
        time.sleep(duration)
        return pipeline.stats
    finally:
        pipeline.close()


def main() -> None:
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    duration = float(sys.argv[3]) if len(sys.argv) > 3 else 10.0
    stats = run(sys.argv[1], sys.argv[2], duration, device=device_from_env())
    print(f"rendered={stats.video_frames_rendered} "
          f"dropped={stats.video_frames_dropped} "
          f"compose latency={stats.render_latency.percentiles()}")


if __name__ == "__main__":
    main()
