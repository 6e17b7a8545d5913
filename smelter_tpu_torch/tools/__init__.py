"""Measurement tools of the port, the counterparts of the JAX repo's
`tools/bench_*.py`: `python -m smelter_tpu_torch.tools.<name> [...]`.

Each runs on the CUDA card unless given `--device cpu`, and raises without a
card otherwise. Each prints the JSON lines of its reference, with the same
keys and meanings, plus "card" (the card's `nvidia-smi` name and power
limit; null on the CPU):

  bench_scenes       six general scenes through the Renderer: device time per frame
  bench_animations   animated geometry: device time per frame, structures added
  bench_latency      live pipeline latency, no codecs
  bench_flagship_ops per-kernel breakdown of the grid or general_4k
  bench_overlap      upload, compose and download, serial against pipelined
  bench_offline      offline MP4 -> MP4 speed as a multiple of real time (FFmpeg)
  bench_streams      most simultaneous real-time streams (FFmpeg)
"""
