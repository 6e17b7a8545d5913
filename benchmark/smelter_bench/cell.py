"""A cell of `BENCHMARK.json`, found by its name: its configuration, scene,
plain reference, traffic, metrics and limits, the schedule of its ticks,
its inputs, and the least bytes a tick of it must move."""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# H100 SXM peak HBM3 rate (NVIDIA's data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12


def load_module(path: Path, name: str) -> ModuleType:
    """The Python file at `path`, imported under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    workload: str
    chips: int
    cfg: dict
    traffic: dict
    scene: ModuleType
    reference: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]

    @property
    def schedule(self) -> "Schedule":
        return Schedule(self.traffic)

    @property
    def outputs(self) -> List[str]:
        return list(self.scene.output_ids(self.cfg))

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"bench_metric_{name}")


def load_cell(workload: str, spec_path: Path = ROOT / "BENCHMARK.json",
              cfg_overrides: Optional[dict] = None,
              traffic_overrides: Optional[dict] = None) -> Cell:
    """The cell named `workload` (overrides: a smaller size for CPU tests)."""
    spec = _read_json(spec_path)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r} in {spec_path.name}: {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    traffic = {**_read_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
               **(traffic_overrides or {})}
    cfg = {**_read_json(ROOT / entry["file"]), **(cfg_overrides or {})}
    return Cell(
        workload=workload, chips=int(w["chips"]), cfg=cfg, traffic=traffic,
        scene=load_module(BENCH_DIR / "scenes" / f"{cfg['scene']}.py",
                          f"bench_scene_{cfg['scene']}"),
        reference=load_module(BENCH_DIR / "references" / f"{cfg['reference']}.py",
                              f"bench_reference_{cfg['reference']}"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, workload)],
        limits=_read_json(BENCH_DIR / "limits" / f"{workload}.json"))


class Schedule:
    """The ticks of a traffic mix: tick k is shown at pts k * pts_step, in
    the stage that its segment names. The opening segments run once, then
    the cycle's segments repeat. The scene is updated before each tick
    whose stage differs from the tick before it."""

    def __init__(self, traffic: dict) -> None:
        self.step = float(traffic["pts_step"])
        self.opening = [(int(s["stage"]), int(s["ticks"])) for s in traffic["opening"]]
        self.cycle = [(int(s["stage"]), int(s["ticks"])) for s in traffic["cycle"]]
        self.n_opening = sum(n for _, n in self.opening)
        self.n_cycle = sum(n for _, n in self.cycle)
        if self.n_cycle <= 0:
            raise ValueError("a traffic mix needs a cycle of at least one tick")

    def pts(self, k: int) -> float:
        return k * self.step

    def stage(self, k: int) -> int:
        if k < self.n_opening:
            segments, r = self.opening, k
        else:
            segments, r = self.cycle, (k - self.n_opening) % self.n_cycle
        for stage, n in segments:
            if r < n:
                return stage
            r -= n
        raise AssertionError("unreachable")

    def cycle_start(self, c: int) -> int:
        return self.n_opening + c * self.n_cycle


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _plane_shapes(fmt: str, w: int, h: int) -> List[tuple]:
    if fmt == "PLANAR_YUV420":
        return [(h, w), (h // 2, w // 2), (h // 2, w // 2)]
    if fmt == "NV12":
        return [(h, w), (h // 2, w // 2, 2)]
    if fmt == "RGBA":
        return [(h, w, 4)]
    raise ValueError(f"no input of format {fmt} in the benchmark")


def input_format(cfg: dict, iid: str) -> str:
    return cfg["input_formats"].get(iid, cfg["input_format"])


def input_ids(cfg: dict) -> List[str]:
    return [f"input_{i}" for i in range(cfg["inputs"])]


def input_bytes(cfg: dict, iid: str) -> int:
    shapes = _plane_shapes(input_format(cfg, iid), cfg["input_width"], cfg["input_height"])
    return sum(math.prod(s) for s in shapes)


def make_inputs(cfg: dict, ring: int, seed: int, device) -> List[Dict[str, tuple]]:
    """`ring` sets of input frames, made on `device` from `seed` in one
    draw: per set, per input id, its u8 planes (an RGBA frame is one (H, W,
    4) tensor, its alpha 255)."""
    import torch

    ids = input_ids(cfg)
    per_set = sum(input_bytes(cfg, iid) for iid in ids)
    gen = torch.Generator(device=device)
    # every bit of the seed counts (a CPU generator keeps 32 bits of its own)
    gen.manual_seed(int.from_bytes(hashlib.sha256(str(seed).encode()).digest()[:4], "little"))
    pool = torch.randint(0, 256, (ring * per_set,), dtype=torch.uint8, generator=gen,
                         device=device)
    sets, off = [], 0
    w, h = cfg["input_width"], cfg["input_height"]
    for _ in range(ring):
        frames = {}
        for iid in ids:
            fmt = input_format(cfg, iid)
            planes = []
            for shape in _plane_shapes(fmt, w, h):
                n = math.prod(shape)
                planes.append(pool[off:off + n].view(shape))
                off += n
            if fmt == "RGBA":
                planes[0][..., 3] = 255
                frames[iid] = (fmt, planes[0])
            else:
                frames[iid] = (fmt, tuple(planes))
        sets.append(frames)
    return sets


def program_api() -> SimpleNamespace:
    """The program's component and type modules, which a scene builds its
    tree from."""
    from smelter_tpu_torch.core import types
    from smelter_tpu_torch.scene import components

    return SimpleNamespace(comp=components, types=types)


def frames_of(api: SimpleNamespace, cfg: dict, planes: Dict[str, tuple]) -> dict:
    """One set of input planes as the program's Frame objects."""
    t = api.types
    res = t.Resolution(cfg["input_width"], cfg["input_height"])
    return {iid: t.Frame(data=data, format=t.PixelFormat[fmt], resolution=res, pts=0.0)
            for iid, (fmt, data) in planes.items()}


def shown_inputs(root) -> set:
    """The input ids that a component tree shows."""
    found, stack = set(), [root]
    while stack:
        c = stack.pop()
        if hasattr(c, "input_id"):
            found.add(c.input_id)
        stack.extend(getattr(c, "children", None) or [])
        if getattr(c, "child", None) is not None:
            stack.append(c.child)
    return found


def output_bytes(cfg: dict) -> int:
    """The bytes of one output frame's planes."""
    if cfg["output_format"] != "PLANAR_YUV420":
        raise ValueError(f"no least bytes for a {cfg['output_format']} output")
    w, h = cfg["output_width"], cfg["output_height"]
    return w * h + 2 * (w // 2) * (h // 2)


def least_bytes(cfg: dict, shown: set, n_outputs: int) -> int:
    """The least bytes one tick must move through device memory: each
    plane of each input the scene shows read once, each plane of each of
    the `n_outputs` output frames written once, counted from the cell's
    shapes."""
    return sum(input_bytes(cfg, iid) for iid in shown) + n_outputs * output_bytes(cfg)
