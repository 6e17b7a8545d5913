"""Offline MP4 composition: N files -> one tiled output with audio mix.

Usage: python -m smelter_tpu_torch.examples.offline_compose out.mp4 in1.mp4 [in2.mp4 ...]

Composes on the CUDA card; `SMELTER_DEVICE=cpu` composes on the CPU. MP4
needs the codec service (FFmpeg's shared libraries).
"""

import sys
import time

from smelter_tpu_torch.audio.mixer import AudioMixerConfig, AudioMixerInputConfig
from smelter_tpu_torch.core.types import Framerate, Resolution, RGBAColor
from smelter_tpu_torch.examples import device_from_env
from smelter_tpu_torch.pipeline import (
    AudioEncoderOptions,
    EndCondition,
    Mp4Input,
    Mp4InputOptions,
    Mp4OutputSink,
    OutputAudioOptions,
    OutputVideoOptions,
    Pipeline,
    PipelineOptions,
    RegisterInputOptions,
    VideoEncoderOptions,
)
from smelter_tpu_torch.scene import components as comp


def run(out_path, inputs, resolution=Resolution(1920, 1080), device=None) -> None:
    """Compose the MP4 files `inputs` into a Tiles grid with their audio
    mixed, as fast as the pipeline goes, into `out_path`."""
    pipeline = Pipeline(PipelineOptions(
        output_framerate=Framerate(30),
        ahead_of_time_processing=True,   # offline: process as fast as possible
        never_drop_output_frames=True,
    ), device=device)
    ids = []
    for i, path in enumerate(inputs):
        iid = f"in_{i}"
        ids.append(iid)
        pipeline.register_input(
            iid, Mp4Input(Mp4InputOptions(path=path)),
            RegisterInputOptions(required=True, offset=0.0),
        )
    scene = comp.Tiles(
        children=[comp.InputStream(input_id=i) for i in ids],
        background_color=RGBAColor(16, 16, 24),
        margin=4.0,
    )
    pipeline.register_output(
        "out", Mp4OutputSink(out_path),
        video=OutputVideoOptions(
            resolution=resolution,
            encoder=VideoEncoderOptions(codec="h264", preset="veryfast"),
            initial_root=scene,
            end_condition=EndCondition(all_inputs=True),
        ),
        audio=OutputAudioOptions(
            encoder=AudioEncoderOptions(codec="aac"),
            initial_mixer_config=AudioMixerConfig(
                inputs=[AudioMixerInputConfig(i) for i in ids]
            ),
            end_condition=EndCondition(all_inputs=True),
        ),
    )
    try:
        pipeline.start()
        pipeline.wait_for_outputs_done()
    finally:
        pipeline.close()


def main() -> None:
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    out_path, *inputs = sys.argv[1:]
    t0 = time.time()
    run(out_path, inputs, device=device_from_env())
    print(f"wrote {out_path} in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()
