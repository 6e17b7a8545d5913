"""Dump decoded frames from a media file to PNGs, through the port's codec
service (the counterpart of the reference's `tools/frame_inspector.py`).

Usage: python -m smelter_tpu_torch.tools.frame_inspector input.mp4 out_dir [--every N] [--max M]

Needs FFmpeg. As in the reference, the decoder is not drained at the end of
the file, so the frames FFmpeg's frame threads still hold are not written.
"""

import argparse
import os

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("out_dir")
    ap.add_argument("--every", type=int, default=1)
    ap.add_argument("--max", type=int, default=100)
    args = ap.parse_args(argv)

    from PIL import Image

    from smelter_tpu_torch.io.codec import Demuxer, VideoDecoder

    os.makedirs(args.out_dir, exist_ok=True)
    d = Demuxer(args.input)
    vinfo = next(s for s in d.streams() if s.media_type == "video")
    dec = VideoDecoder(vinfo.codec, vinfo.extradata)

    def to_rgb(y, u, v):
        yf = (y.astype(np.float32) - 16.0) / 219.0
        uf = (np.repeat(np.repeat(u, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
              .astype(np.float32) - 128.0) / 224.0
        vf = (np.repeat(np.repeat(v, 2, 0), 2, 1)[: y.shape[0], : y.shape[1]]
              .astype(np.float32) - 128.0) / 224.0
        r = yf + 1.5748 * vf
        g = yf - 0.1873 * uf - 0.4681 * vf
        b = yf + 1.8556 * uf
        return np.clip(np.stack([r, g, b], -1) * 255 + 0.5, 0, 255).astype(np.uint8)

    idx = saved = 0
    while saved < args.max:
        pkt = d.read()
        if pkt is None:
            break
        if pkt.stream_index != vinfo.index:
            continue
        dec.send(pkt.data, pkt.pts_s or 0.0)
        while True:
            f = dec.receive()
            if f in (None, "eof"):
                break
            y, u, v, pts, _ = f
            if idx % args.every == 0:
                path = os.path.join(
                    args.out_dir, f"frame_{idx:05d}_{(pts or 0):.3f}s.png"
                )
                Image.fromarray(to_rgb(y, u, v)).save(path)
                saved += 1
            idx += 1
    print(f"saved {saved} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
