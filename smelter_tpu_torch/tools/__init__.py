"""Tools of the port, the counterparts of the JAX repo's `tools/*.py`:
`python -m smelter_tpu_torch.tools.<name> [...]`.

Measurement tools: each runs on the CUDA card unless given `--device cpu`,
and raises without a card otherwise. Each prints the JSON lines of its
reference, with the same keys and meanings, plus "card" (the card's
`nvidia-smi` name and power limit; null on the CPU):

  bench_scenes       six general scenes through the Renderer: device time per frame
  bench_animations   animated geometry: device time per frame, structures added
  bench_latency      live pipeline latency, no codecs
  bench_flagship_ops per-kernel breakdown of the grid or general_4k
  bench_overlap      upload, compose and download, serial against pipelined
  bench_offline      offline MP4 -> MP4 speed as a multiple of real time (FFmpeg)
  bench_streams      most simultaneous real-time streams (FFmpeg)
  bench_canvas_ab, bench_assembly_ab, bench_align_ab
                     A/B of the canvas storage, the opening run's route and
                     the union alignment on general_4k

The rest keep their reference's arguments and output:

  soak_live          structure churn under a hot render loop: background
                     captures behind the freeze-frame (card unless --device cpu)
  soak_web           rounds of `tests/test_torch_web.py`
  dependency_check   the runtime dependencies: torch, the card, nvcc (sm_90a),
                     the kernels' build (optional with --device cpu), FFmpeg, ...
  generate_schemas   JSON schema and OpenAPI files of `api/schema.py`
  generate_ts_types  the TS SDK's wire types of `api/schema.py`
  docs_examples      the docs' clips through the port's server (card unless
                     SMELTER_DEVICE=cpu; FFmpeg)
  frame_inspector    a media file's frames as PNGs (FFmpeg)
  waveform_inspector a media file's waveform and spectrum as a PNG (FFmpeg)
  release            a source tarball of the port and its checksum

Their default outputs (`generated/`, `dist/`) are ignored by git.
"""
