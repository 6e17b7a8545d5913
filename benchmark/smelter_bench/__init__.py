"""The benchmark of `smelter_tpu_torch`: a closed render loop over the port's
`Renderer` and `pipeline.output.to_host_async`, driven by data.

A cell of `BENCHMARK.json` names a configuration (`configs/<name>.json`,
whose "scene" key names `scenes/<scene>.py` and whose "reference" key
names its plain reference, `references/<name>.py`) and a traffic mix
(`traffic/<name>.json`); each per-layer metric is read by
`metrics/<name>.py`; the limits of the output comparison are in
`limits/<workload>.json`. Modules:
  - `cell`: loading a cell by name, its tick schedule, its inputs, its
    least bytes a tick;
  - `loop`: the render loop and the fetch thread;
  - `trace`: what the torch.profiler trace of a run says;
  - `reference`: the plain reference over the sampled ticks, and the
    comparison that decides `correct`;
  - `harness`: one run, from set-up to the result's line.
"""
