"""MoQ (Media over QUIC) round trip: publish an MP4 over MoQ into a MoQ
server input, re-compose, record to MP4.

Two pipelines in one process, connected by a real QUIC v1 connection (the
port's own stack in smelter_tpu_torch/io/quic):

  tx: MP4 file -> h264/aac encode -> MoqClientOutput == QUIC/MoQT ==>
  rx: MoQ server input -> decode -> compose -> MP4

Usage: python -m smelter_tpu_torch.examples.moq_relay in.mp4 out.mp4 [container]
       container: cmaf (default) | legacy | loc

Composes on the CUDA card; `SMELTER_DEVICE=cpu` composes on the CPU.
"""

import sys
import time

from smelter_tpu_torch.audio.mixer import AudioMixerConfig, AudioMixerInputConfig
from smelter_tpu_torch.core.types import Framerate, Resolution, RGBAColor
from smelter_tpu_torch.examples import device_from_env
from smelter_tpu_torch.io.moq.input import MoqServerInput, MoqServerInputOptions
from smelter_tpu_torch.io.moq.output import MoqClientOutput
from smelter_tpu_torch.io.moq.server import MoqServer, MoqServerState
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


def _outputs(root, input_id, resolution):
    video = OutputVideoOptions(
        resolution=resolution,
        encoder=VideoEncoderOptions(codec="h264", preset="veryfast"),
        initial_root=root,
        end_condition=EndCondition(all_inputs=True),
    )
    audio = OutputAudioOptions(
        encoder=AudioEncoderOptions(codec="aac"),
        initial_mixer_config=AudioMixerConfig(inputs=[AudioMixerInputConfig(input_id)]),
        end_condition=EndCondition(all_inputs=True),
    )
    return {"video": video, "audio": audio}


def run(src, dst, container="cmaf", resolution=Resolution(1280, 720),
        cert_dir="/tmp/smelter_moq", device=None) -> None:
    """Publish `src` over MoQ (`container`) to a MoQ server input on this
    host and record what it receives, recomposed at `resolution`, to `dst`.
    `cert_dir` holds the server's self-signed certificate."""
    opts = PipelineOptions(
        output_framerate=Framerate(30),
        ahead_of_time_processing=True,
        never_drop_output_frames=True,
    )
    rx = Pipeline(opts, device=device)
    state = MoqServerState()
    moq_in = MoqServerInput(MoqServerInputOptions(auth_token="demo"))
    rx.register_input("moq", moq_in, RegisterInputOptions(required=True, offset=0.0))
    state.register("moq", moq_in)
    server = MoqServer(0, state, cert_dir=cert_dir)
    tx = None
    try:
        rx.register_output("rec", Mp4OutputSink(dst), **_outputs(comp.View(
            background_color=RGBAColor(16, 16, 24, 255),
            children=[comp.Rescaler(child=comp.InputStream(input_id="moq"))],
        ), "moq", resolution))
        rx.start()

        tx = Pipeline(opts, device=device)
        tx.register_input("file", Mp4Input(Mp4InputOptions(path=src)),
                          RegisterInputOptions(required=True, offset=0.0))
        sink = MoqClientOutput(
            f"moql://127.0.0.1:{server.port}/moq?token=demo",
            "demo-broadcast", container=container,
        )
        tx.register_output("pub", sink, **_outputs(
            comp.Rescaler(child=comp.InputStream(input_id="file")), "file", resolution))
        # publish once the receiver has subscribed to both tracks: a
        # publisher drops what it writes before a track's subscription
        deadline = time.time() + 30
        while time.time() < deadline and None in (sink.publisher.producer("video0"),
                                                  sink.publisher.producer("audio0")):
            time.sleep(0.02)
        tx.start()
        tx.wait_for_outputs_done(timeout=3600)
        rx.wait_for_outputs_done(timeout=3600)
    finally:
        if tx is not None:
            tx.close()
        rx.close()
        server.close()


def main() -> None:
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    src, dst = sys.argv[1], sys.argv[2]
    container = sys.argv[3] if len(sys.argv) > 3 else "cmaf"
    t0 = time.time()
    run(src, dst, container, device=device_from_env())
    print(f"done in {time.time() - t0:.1f}s -> {dst}")


if __name__ == "__main__":
    main()
