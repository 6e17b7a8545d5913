"""Offline (ahead-of-time) MP4 -> MP4 speed: how much faster than real
time the port's whole pipeline runs when nothing is clocked (the port of
the reference's `tools/bench_offline.py`).

    python -m smelter_tpu_torch.tools.bench_offline [--inputs 4] [--seconds 10]
        [--fps 30] [--in 854x480] [--out 1280x720] [--device cpu]

N synthetic source MP4s (moving-gradient H.264 video and a sine tone in
AAC) -> Tiles compose and audio mix -> one H.264/AAC MP4, with
`ahead_of_time_processing` (the queue ticks as fast as the slowest stage).
Reports media seconds processed per wall second ("x realtime") and the
pipeline's per-stage spans. The compose runs on the card unless given
`--device cpu` (without a card it raises); the codecs run on the host
through the codec service, which needs FFmpeg's shared libraries: where it
cannot load, the tool raises with the loader's message.

Prints one JSON line with the reference's keys and "card".
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from typing import List, Optional

import numpy as np

from smelter_tpu_torch.audio.mixer import AudioMixerConfig, AudioMixerInputConfig
from smelter_tpu_torch.core.types import Framerate, RGBAColor
from smelter_tpu_torch.interop import resolve_device
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
from smelter_tpu_torch.tools._inputs import parse_resolution
from smelter_tpu_torch.tools._profile import card
from smelter_tpu_torch.utils import tracing


def _drain(enc, into) -> None:
    while True:
        p = enc.receive()
        if p in (None, "eof"):
            return
        into.append(p)


def make_source(path: str, w: int, h: int, fps: int, dur_s: float, seed: int) -> None:
    """An H.264 + AAC MP4 of `dur_s` seconds: a diagonal luma gradient that
    moves 4 codes a frame over chroma set by `seed`, and a stereo sine of
    220 (seed + 1) Hz."""
    from smelter_tpu_torch.io.codec import AudioEncoder, Codec, Muxer, VideoEncoder

    venc = VideoEncoder(Codec.H264, w, h, fps)
    aenc = AudioEncoder(Codec.AAC, 48000, 2)
    yy, xx = np.mgrid[0:h, 0:w]
    u = np.full((h // 2, w // 2), 96 + 24 * (seed % 3), np.uint8)
    v = np.full((h // 2, w // 2), 96 + 40 * (seed % 2), np.uint8)
    vpkts = []
    for i in range(int(dur_s * fps)):
        y = ((xx + yy + seed * 37 + i * 4) % 220 + 16).astype(np.uint8)
        venc.send(y, u, v, i / fps)
        _drain(venc, vpkts)
    venc.send_eof()
    _drain(venc, vpkts)
    t = np.arange(int(dur_s * 48000)) / 48000.0
    sine = (0.3 * np.sin(2 * np.pi * (220.0 * (seed + 1)) * t)).astype(np.float32)
    apkts = []
    aenc.send(np.stack([sine, sine], axis=1), 0.0)
    aenc.send_eof()
    _drain(aenc, apkts)
    mux = Muxer(path)
    vs = mux.add_video(Codec.H264, w, h, fps, 1, venc.extradata())
    as_ = mux.add_audio(Codec.AAC, 48000, 2, aenc.extradata())
    mux.write_header()
    for p in vpkts:
        mux.write(vs, p.data, p.pts_s, p.dts_s, p.is_keyframe)
    for p in apkts:
        mux.write(as_, p.data, p.pts_s, p.dts_s, p.is_keyframe)
    mux.close()
    venc.close()
    aenc.close()


def main(argv: Optional[List[str]] = None) -> dict:
    """Generate the sources, compose them, print the JSON line and return it."""
    ap = argparse.ArgumentParser(description="Offline MP4 -> MP4 speed.")
    ap.add_argument("--inputs", type=int, default=4)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fps", type=int, default=30)
    ap.add_argument("--in", dest="in_res", default="854x480")
    ap.add_argument("--out", dest="out_res", default="1280x720")
    ap.add_argument("--device", default=None,
                    help='"cpu" to compose on the CPU; the CUDA card if omitted')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    in_res, out_res = parse_resolution(args.in_res), parse_resolution(args.out_res)

    tmp = tempfile.mkdtemp(prefix="smelter_offline_bench_")
    try:
        srcs = []
        t0 = time.perf_counter()
        for i in range(args.inputs):
            p = os.path.join(tmp, f"src_{i}.mp4")
            make_source(p, in_res.width, in_res.height, args.fps, args.seconds, i)
            srcs.append(p)
        gen_s = time.perf_counter() - t0

        pipeline = Pipeline(PipelineOptions(
            output_framerate=Framerate(args.fps),
            ahead_of_time_processing=True,
            never_drop_output_frames=True,
        ), device=device)
        try:
            ids = [f"in_{i}" for i in range(args.inputs)]
            in_opts = RegisterInputOptions(required=True, offset=0.0)
            for iid, path in zip(ids, srcs):
                pipeline.register_input(iid, Mp4Input(Mp4InputOptions(path=path)), in_opts)
            scene = comp.Tiles(
                background_color=RGBAColor(16, 16, 16),
                children=[comp.InputStream(input_id=iid) for iid in ids],
            )
            out_path = os.path.join(tmp, "out.mp4")
            pipeline.register_output(
                "out",
                Mp4OutputSink(out_path),
                video=OutputVideoOptions(
                    resolution=out_res,
                    encoder=VideoEncoderOptions(codec="h264", preset="ultrafast"),
                    initial_root=scene,
                    end_condition=EndCondition(all_inputs=True),
                ),
                audio=OutputAudioOptions(
                    encoder=AudioEncoderOptions(codec="aac"),
                    initial_mixer_config=AudioMixerConfig(
                        inputs=[AudioMixerInputConfig(iid, volume=1.0) for iid in ids]
                    ),
                    end_condition=EndCondition(all_inputs=True),
                ),
            )
            tracing.reset()  # per-stage spans: decode / queue / render / fetch / encode
            t0 = time.perf_counter()
            pipeline.start()
            pipeline.wait_for_outputs_done(timeout=3600)
            wall_s = time.perf_counter() - t0
            spans = tracing.report()
        finally:
            pipeline.close()
        out_size = os.path.getsize(out_path) if os.path.exists(out_path) else 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    if not out_size:
        res = {"metric": "offline_x_realtime", "error": "no output", "card": card(device)}
    else:
        res = {
            "metric": "offline_x_realtime",
            "value": round(args.seconds / wall_s, 2),
            "unit": "x realtime",
            "media_s": args.seconds,
            "wall_s": round(wall_s, 2),
            "inputs": args.inputs,
            "in_res": args.in_res,
            "out_res": args.out_res,
            "fps": args.fps,
            "out_bytes": out_size,
            "source_gen_s": round(gen_s, 2),
            # wall time inside each span; the stages overlap across threads,
            # so their totals can exceed wall_s on a host of several cores
            "spans": {k: spans[k] for k in sorted(spans)
                      if k.startswith(("codec.", "queue.", "render.", "audio."))},
            "card": card(device),
        }
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
