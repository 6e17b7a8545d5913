"""Plot the audio waveform + spectrum of a media file, through the port's
codec service (the counterpart of the reference's
`tools/waveform_inspector.py`).

Usage: python -m smelter_tpu_torch.tools.waveform_inspector input.mp4 out.png

Needs FFmpeg and matplotlib. As in the reference, the decoder is not
drained at the end of the file.
"""

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from smelter_tpu_torch.io.codec import AudioDecoder, Demuxer

    d = Demuxer(args.input)
    ainfo = next(s for s in d.streams() if s.media_type == "audio")
    dec = AudioDecoder(ainfo.codec, 48000, 2, extradata=ainfo.extradata,
                       in_sample_rate=ainfo.sample_rate, in_channels=ainfo.channels)
    chunks = []
    while True:
        pkt = d.read()
        if pkt is None:
            break
        if pkt.stream_index != ainfo.index:
            continue
        dec.send(pkt.data, pkt.pts_s or 0.0)
        while True:
            s = dec.receive()
            if s in (None, "eof"):
                break
            chunks.append(s[0])
    pcm = np.concatenate(chunks) if chunks else np.zeros((1, 2))
    mono = pcm.mean(axis=1)
    t = np.arange(len(mono)) / 48000.0

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 6))
    ax1.plot(t, mono, linewidth=0.3)
    ax1.set_xlabel("time [s]")
    ax1.set_title("waveform (48 kHz mono mix)")
    spectrum = np.abs(np.fft.rfft(mono))
    freqs = np.fft.rfftfreq(len(mono), 1 / 48000)
    ax2.semilogy(freqs, spectrum + 1e-9, linewidth=0.5)
    ax2.set_xlim(0, 8000)
    ax2.set_xlabel("frequency [Hz]")
    ax2.set_title("spectrum")
    fig.tight_layout()
    fig.savefig(args.output, dpi=100)
    print(f"wrote {args.output} ({len(mono)} samples)")


if __name__ == "__main__":
    main()
