"""The port's spans and counters (`smelter_tpu_torch/utils/tracing.py`) and
where the frame path records them.

On the CPU: aggregates, counters and `reset()`; self time and parent of
nested spans; a span leaves the process's `random` alone; a Tiles render at
the benchmark's small size records its stages as one tree, counts the
bytes its captured program loads and copies out, and counts captures, hits
and evictions of the program cache; `/stats` serves the counters.

On the card (`-m cuda`; this file imports no JAX):

    python -m pytest --noconftest -m cuda -s tests/test_torch_tracing.py

holds the card's side of each copying span to its host side: over 8 traced
ticks of the 4K Tiles scene, the profiler's range of `render.load`,
`render.outputs` and `render.to_host` on the card starts no earlier than
the same span on the host, once the profiler's two clocks are put on one
by an idle card's marker spans, and prints the least lead and the offset.
"""

from __future__ import annotations

import random
import threading
import time

import pytest
import torch

from smelter_tpu_torch.core import types as tt
from smelter_tpu_torch.pipeline.output import to_host_async
from smelter_tpu_torch.render import capture as cap
from smelter_tpu_torch.render import program as tprog
from smelter_tpu_torch.render.renderer import Renderer, RendererOptions
from smelter_tpu_torch.scene import components as comp
from smelter_tpu_torch.utils import tracing

REPORT_KEYS = ["count", "total_ms", "avg_ms", "max_ms", "p50_ms", "p95_ms", "self_ms", "parent"]
# the benchmark's small size of tiles4to1_1080p (benchmark/tests/_paths.py)
IN_RES = tt.Resolution(192, 108)
OUT_RES = tt.Resolution(192, 108)
YUV_BYTES = 192 * 108 * 3 // 2


@pytest.fixture(autouse=True)
def fresh_tracing():
    tracing.reset()
    yield
    tracing.enable_profiler_annotations(False)
    tracing.reset()


def test_aggregates_counters_and_reset():
    for _ in range(3):
        with tracing.span("t.op"):
            time.sleep(0.002)
    tracing.count("t.calls")
    tracing.count("t.calls")
    tracing.count("t.bytes", 300)
    tracing.count_each((("t.bytes", 12), ("t.frames", 1)))
    rep = tracing.report()["t.op"]
    assert list(rep) == REPORT_KEYS
    assert rep["count"] == 3 and rep["parent"] is None
    assert rep["total_ms"] >= 6.0 and rep["max_ms"] >= 2.0
    assert rep["avg_ms"] == pytest.approx(rep["total_ms"] / 3, abs=1e-3)
    assert rep["self_ms"] == rep["total_ms"]
    assert 2.0 <= rep["p50_ms"] <= rep["p95_ms"] <= rep["max_ms"]
    # no counter enters the span report
    assert set(tracing.report()) == {"t.op"}
    assert tracing.counters() == {"t.calls": 2, "t.bytes": 312, "t.frames": 1}
    tracing.reset()
    assert tracing.report() == {} and tracing.counters() == {}


def test_self_time_and_parent_of_nested_spans():
    with tracing.span("t.outer"):
        time.sleep(0.02)
        with tracing.span("t.inner"):
            time.sleep(0.03)
            with tracing.span("t.leaf"):
                pass
        with tracing.span("t.inner"):
            pass
    rep = tracing.report()
    outer, inner, leaf = rep["t.outer"], rep["t.inner"], rep["t.leaf"]
    assert (outer["parent"], inner["parent"], leaf["parent"]) == (None, "t.outer", "t.inner")
    assert inner["count"] == 2 and inner["total_ms"] >= 30.0
    # self = total less the children's time on the same thread
    assert outer["self_ms"] == pytest.approx(outer["total_ms"] - inner["total_ms"], abs=0.01)
    assert inner["self_ms"] == pytest.approx(inner["total_ms"] - leaf["total_ms"], abs=0.01)
    assert 20.0 <= outer["self_ms"] < outer["total_ms"] - 30.0


def test_a_span_on_another_thread_has_its_own_parent():
    """A span open on one thread is no parent of a span on another, and
    takes none of its time."""
    done = threading.Event()

    def other():
        with tracing.span("t.worker"):
            time.sleep(0.02)
        done.set()

    with tracing.span("t.main"):
        t = threading.Thread(target=other)
        t.start()
        assert done.wait(10)
        t.join(10)
    assert not t.is_alive()
    rep = tracing.report()
    assert rep["t.worker"]["parent"] is None
    assert rep["t.main"]["self_ms"] == rep["t.main"]["total_ms"] >= 20.0


def test_a_span_leaves_the_global_random_alone():
    random.seed(1234)
    state = random.getstate()
    # past the reservoir's 256 samples, where each span draws a slot
    for _ in range(600):
        with tracing.span("t.sampled"):
            pass
    assert random.getstate() == state
    assert tracing.report()["t.sampled"]["count"] == 600


def test_an_annotated_span_keeps_the_gil():
    """Under a profiler, with annotations on, opening and closing a span's
    range lets no other Python thread in: a thread that spins beside 400
    spans advances during at most the one or two spans that a switch
    interval (5 ms) forces, where a range that released the GIL on entry
    and exit let it in during 8 to 131 of 200."""
    from torch.profiler import ProfilerActivity, profile

    stop = threading.Event()
    spins = [0]

    def spin():
        while not stop.is_set():
            spins[0] += 1

    t = threading.Thread(target=spin)
    t.start()
    let_in = 0
    try:
        tracing.enable_profiler_annotations(True)
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(400):
                before = spins[0]
                with tracing.span("t.annotated"):
                    pass
                let_in += spins[0] != before
    finally:
        tracing.enable_profiler_annotations(False)
        stop.set()
        t.join(10)
    assert not t.is_alive()
    assert tracing.report()["t.annotated"]["count"] == 400
    assert let_in <= 2, let_in


# ---------------------------------------------------------------------------
# the frame path, on the CPU
# ---------------------------------------------------------------------------

def _tiles(n: int):
    return comp.Tiles(background_color=tt.RGBAColor(0, 0, 0, 255), tile_aspect_ratio=(16, 9),
                      children=[comp.InputStream(input_id=f"input_{i}") for i in range(n)])


def _yuv_frames(n: int, res: tt.Resolution, device, seed: int = 7):
    gen = torch.Generator(device=device).manual_seed(seed)
    w, h = res.width, res.height
    frames = {}
    for i in range(n):
        planes = tuple(torch.randint(0, 256, s, dtype=torch.uint8, generator=gen, device=device)
                       for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
        frames[f"input_{i}"] = tt.Frame(data=planes, format=tt.PixelFormat.PLANAR_YUV420,
                                        resolution=res, pts=0.0)
    return frames


def _tiles_renderer(n: int, out_res: tt.Resolution, device) -> Renderer:
    r = Renderer(RendererOptions(async_compile=False), device=device)
    for i in range(n):
        r.register_input(f"input_{i}")
    r.update_scene("out", _tiles(n), out_res, tt.PixelFormat.PLANAR_YUV420)
    return r


def _host_spans(prof):
    """(name, start ns, end ns) of each span on the host, in start order."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    return sorted(((e.name(), e.start_ns(), e.end_ns()) for e in events
                   if e.is_user_annotation() and e.device_type() != cuda), key=lambda s: s[1])


def test_a_tiles_tick_is_one_tree_of_stages():
    """One tick of a held Tiles scene on the CPU: render.frame holds
    render.plan (walk, then pack), the program cache's lookup, then the
    program's args, load, replay and outputs; render.to_host follows. No aux
    texture, so no render.plan.aux."""
    from torch.profiler import ProfilerActivity, profile

    r = _tiles_renderer(4, OUT_RES, "cpu")
    frames = _yuv_frames(4, IN_RES, "cpu")
    to_host_async(r.render(tt.FrameSet(pts=0.0, frames=frames)).frames["out"])  # captures
    tracing.reset()
    tracing.enable_profiler_annotations(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = r.render(tt.FrameSet(pts=0.03125, frames=frames)).frames["out"]
        to_host_async(out).wait()
    tracing.enable_profiler_annotations(False)
    spans = [s for s in _host_spans(prof) if s[0].startswith("render.")]
    assert [s[0] for s in spans] == [
        "render.frame", "render.plan", "render.plan.walk", "render.plan.pack", "render.lookup",
        "render.args", "render.load", "render.replay", "render.outputs", "render.to_host"]
    (_, _, f1), (_, p0, p1) = spans[0], spans[1]
    for name, s, e in spans[2:4]:
        assert p0 <= s <= e <= p1, name
    for name, s, e in spans[4:9]:
        assert p1 <= s <= e <= f1, name
    assert spans[9][1] >= f1
    rep = tracing.report()
    assert {n: rep[n]["parent"] for n, _, _ in spans} == {
        "render.frame": None, "render.plan": "render.frame",
        "render.plan.walk": "render.plan", "render.plan.pack": "render.plan",
        "render.lookup": "render.frame",
        "render.args": "render.frame", "render.load": "render.frame",
        "render.replay": "render.frame", "render.outputs": "render.frame",
        "render.to_host": None}
    assert all(rep[n]["count"] == 1 for n in rep)
    assert rep["render.frame"]["self_ms"] < rep["render.frame"]["total_ms"]


def test_program_copies_are_counted_in_bytes():
    """The bytes a call loads are the input planes, the packed parameters
    and the (empty) host frame buffer; the bytes it copies out are the
    output planes; all on the program's own device here (the CPU)."""
    r = _tiles_renderer(4, OUT_RES, "cpu")
    frames = _yuv_frames(4, IN_RES, "cpu")
    r.render(tt.FrameSet(pts=0.0, frames=frames))
    tracing.reset()
    ticks = 3
    for k in range(1, ticks + 1):
        out = r.render(tt.FrameSet(pts=k / 32, frames=frames)).frames["out"]
        to_host_async(out).wait()
    prog = r._programs["out"]
    _, plan = prog.plan(0.0, frames)
    params = plan.packed_params.nbytes
    assert 0 < params < 2048 and plan.frame_buf.nbytes == 1  # the inputs are tensors
    c = tracing.counters()
    assert c == {
        "program.lookups": ticks, "program.hits": ticks,
        "program.calls": ticks, "program.calls.grid": ticks,
        "program.grid.tile_planes": ticks * 12,
        "program.load_d2d_bytes": ticks * (4 * YUV_BYTES + params + 1),
        "program.load_h2d_bytes": 0,
        "program.out_bytes": ticks * YUV_BYTES,
        "output.to_host_frames": ticks, "output.to_host_bytes": ticks * YUV_BYTES,
    }
    (program,) = prog._build_cache.values()
    assert program.fn.route == "grid"


def test_load_bytes_split_by_where_each_argument_lives():
    """An argument on another device than the program's counts as a copy
    from the host; one on the program's device as a copy within it."""
    static = (torch.empty(10, dtype=torch.uint8), torch.empty(3, dtype=torch.float32))
    args = (torch.empty(10, dtype=torch.uint8), torch.empty(3, device="meta"))
    counts = dict(cap._call_counts(cap.route("r")(lambda *a: a), static, args,
                                   (torch.empty((2, 5), dtype=torch.int16),)))
    assert counts == {"program.calls": 1, "program.calls.r": 1, "program.load_d2d_bytes": 10,
                      "program.load_h2d_bytes": 12, "program.out_bytes": 20}
    assert dict(cap._call_counts(lambda x: x, static, args, ()))["program.calls.unnamed"] == 1


def _general_program(res: tt.Resolution = tt.Resolution(32, 18)) -> tprog.OutputProgram:
    from smelter_tpu_torch.scene.scene_state import OutputScene, SceneState

    root = comp.View(background_color=tt.RGBAColor(10, 10, 10, 255),
                     children=[comp.Rescaler(child=comp.InputStream(input_id="input_0"),
                                             border_radius=comp.BorderRadius(4, 4, 4, 4))])
    node = SceneState().update_scene(OutputScene("out", root, res),
                                     text_measurer=None, image_store=None).node
    return tprog.OutputProgram(node, res, tt.PixelFormat.RGBA, device="cpu")


def test_general_route_is_named():
    prog = _general_program()
    prog.render(0.0, _yuv_frames(1, IN_RES, "cpu"))
    prog.render(0.1, _yuv_frames(1, IN_RES, "cpu"))
    assert tracing.counters()["program.calls.general"] == 1


def test_cache_counters_across_an_update_and_past_the_cap(monkeypatch):
    """Captures, hits and evictions: a new structure is captured, a seen one
    hit; past MAX_CACHED_PROGRAMS each capture evicts the oldest; a scene
    update makes a new program, which captures again."""
    monkeypatch.setattr(tprog.OutputProgram, "MAX_CACHED_PROGRAMS", 3)
    r = _tiles_renderer(4, OUT_RES, "cpu")
    # an input resolution is part of the structure key: 5 sizes, 5 keys;
    # the frame after a resize holds its tiles still, a sixth key; then a hit
    sizes = [tt.Resolution(64 + 16 * i, 36 + 8 * i) for i in range(5)]
    ticks = [(0.0, res) for res in sizes] + [(0.1, sizes[-1]), (0.2, sizes[-1])]
    for pts, res in ticks:
        r.render(tt.FrameSet(pts=pts, frames=_yuv_frames(4, res, "cpu")))
    c = tracing.counters()
    assert (c["program.lookups"], c["program.hits"]) == (7, 1)
    assert (c["program.captures"], c["program.evictions"]) == (6, 3)
    assert len(r._programs["out"]._build_cache) == 3
    r.update_scene("out", _tiles(4), OUT_RES, tt.PixelFormat.PLANAR_YUV420)
    r.render(tt.FrameSet(pts=0.3, frames=_yuv_frames(4, sizes[-1], "cpu")))
    c = tracing.counters()
    assert (c["program.lookups"], c["program.hits"], c["program.captures"]) == (8, 1, 7)
    assert c["program.evictions"] == 3 and c["program.calls"] == 1
    assert tracing.report()["render.capture"]["count"] == 7


def test_stats_carry_counters():
    from smelter_tpu_torch.pipeline import Pipeline
    from smelter_tpu_torch.pipeline.stats import collect_stats

    with tracing.span("t.probe"):
        tracing.count("t.probe_count", 2)
    p = Pipeline(device="cpu")
    try:
        report = collect_stats(p)
        assert report["spans"]["t.probe"]["count"] == 1
        assert report["counters"] == {"t.probe_count": 2}
    finally:
        p.close()


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the profiler's device-side ranges)")
    return torch.device("cuda", 0)


def _annotation_starts(events, name: str, on_card: bool):
    """The sorted start times (ns) of the profiler's ranges of span `name`,
    on the card or on the host."""
    dev_type = torch.autograd.DeviceType.CUDA
    return sorted(e.start_ns() for e in events if e.is_user_annotation() and e.name() == name
                  and (e.device_type() == dev_type) == on_card)


def _clock_markers(device, n: int = 8) -> None:
    """`n` spans `clock.marker`, each around one small kernel launched on an
    idle card: the least lead of their card ranges over their host ranges is
    the offset of the profiler's card clock from its host clock, plus the
    least a launch can take."""
    x = torch.zeros(1, device=device)
    for _ in range(n):
        torch.cuda.synchronize()
        with tracing.span("clock.marker"):
            x.add_(1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_copying_spans_start_on_the_card_after_the_host(cuda):
    """Over 8 traced ticks of the 4K Tiles scene (16 x 1080p device-resident
    inputs), each copying span's range on the card starts no earlier than
    its range on the host. The profiler puts the card's timestamps on the
    host's clock only to within an offset (hundreds of us on an H100), so
    the leads are taken from an idle card's marker spans before and after
    the ticks (`_clock_markers`): a copying span's card range must trail its
    host range by no less than a lone launch on an idle card's does."""
    from torch.profiler import ProfilerActivity, profile

    r = _tiles_renderer(16, tt.Resolution(3840, 2160), cuda)
    frames = _yuv_frames(16, tt.Resolution(1920, 1080), cuda)
    for k in range(4):  # the capture, then replays
        to_host_async(r.render(tt.FrameSet(pts=k / 32, frames=frames)).frames["out"]).wait()
    torch.cuda.synchronize()
    tracing.enable_profiler_annotations(True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _clock_markers(cuda)
        for k in range(4, 12):
            to_host_async(r.render(tt.FrameSet(pts=k / 32, frames=frames)).frames["out"]).wait()
        torch.cuda.synchronize()
        _clock_markers(cuda)
    tracing.enable_profiler_annotations(False)
    events = prof.profiler.kineto_results.events()
    host = _annotation_starts(events, "clock.marker", on_card=False)
    card = _annotation_starts(events, "clock.marker", on_card=True)
    assert len(host) == 16 and len(card) == 16, (len(host), len(card))
    offset = min(c - h for h, c in zip(host, card)) / 1e3
    leads = {}
    for name in ("render.load", "render.outputs", "render.to_host"):
        host = _annotation_starts(events, name, on_card=False)
        card = _annotation_starts(events, name, on_card=True)
        assert len(host) == 8 and len(card) == 8, (name, len(host), len(card))
        leads[name] = min(c - h for h, c in zip(host, card)) / 1e3 - offset
    print(f"least lead of the card's range over the host's, past an idle card's marker "
          f"({offset:.1f} us), us: {leads}")
    assert all(lead >= 0 for lead in leads.values()), (offset, leads)
