"""Validate the port's runtime dependency set before launching it (the
counterpart of the reference's `tools/dependency_check.py`).

The reference checks JAX and its CPU backend; the port checks torch, the
CUDA card (its `nvidia-smi` name and power limit), nvcc for sm_90a and the
build of its kernels (`ops/hopper/build.library()`). Those card checks are
required unless `--device cpu` is given. The FFmpeg check loads the port's
codec service the way the port loads it (`io/codec.py` through
`io/native_lib.py`: the committed library, else one built into
`smelter_tpu_torch/_build/`). Every other check is the reference's. Prints
versions and exits non-zero (with a remediation hint) when a required one
is broken.

Usage:
    python -m smelter_tpu_torch.tools.dependency_check            # human-readable report
    python -m smelter_tpu_torch.tools.dependency_check --json     # machine-readable
    python -m smelter_tpu_torch.tools.dependency_check --strict   # optional deps fail too
    python -m smelter_tpu_torch.tools.dependency_check --device cpu  # the card optional
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import List, Optional

# `required` of a check that is required only when the port runs on the card
ON_CARD = "on card"

PROBES: list = []


def check(name: str, required):
    """Decorator registering a dependency probe. The probe returns a version/
    detail string on success and raises on failure. `required` is a bool,
    or ON_CARD: required unless the port runs on the CPU."""

    def wrap(fn):
        def run(card_required: bool) -> dict:
            req = card_required if required == ON_CARD else required
            try:
                detail = fn()
                entry = {"name": name, "ok": True, "required": req,
                         "detail": detail or ""}
            except Exception as exc:  # noqa: BLE001
                entry = {"name": name, "ok": False, "required": req,
                         "detail": f"{type(exc).__name__}: {exc}"}
            return entry

        PROBES.append(run)
        return run

    return wrap


@check("python", required=True)
def _python():
    v = sys.version_info
    if v < (3, 10):
        raise RuntimeError(f"python >= 3.10 required, found {sys.version}")
    return f"{v.major}.{v.minor}.{v.micro}"


@check("torch", required=True)
def _torch():
    import torch

    return f"{torch.__version__} (CUDA {torch.version.cuda})"


@check("CUDA card", required=ON_CARD)
def _card():
    import torch

    from smelter_tpu_torch.bench import card_name

    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA card (the port runs on the CPU only "
                           "with --device cpu / SMELTER_DEVICE=cpu)")
    return f"{card_name()} ({torch.cuda.device_count()} cards)"


@check("nvcc (sm_90a)", required=ON_CARD)
def _nvcc():
    from smelter_tpu_torch.ops.hopper.build import BUILD_DIR, find_nvcc

    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                             timeout=60, check=True).stdout.strip().splitlines()[-1]
    # an empty kernel compiled for sm_90a, as the kernels' build compiles
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        src = Path(tmp) / "probe.cu"
        src.write_text("__global__ void probe() {}\n")
        out = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-cubin",
                              "-o", str(Path(tmp) / "probe.cubin"), str(src)],
                             capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"{nvcc} ({version}) cannot compile for sm_90a: "
                           f"{out.stderr.strip()[-500:]}")
    return f"{nvcc}: {version}"


@check("kernels build", required=ON_CARD)
def _kernels():
    from smelter_tpu_torch.ops.hopper import build

    build.library()  # a failed build's error names its log
    return str(build.library_path())


@check("native smelter_io (FFmpeg)", required=True)
def _smelter_io():
    from smelter_tpu_torch.io import codec

    lib = codec._load()  # the committed library, else one built into _build/
    vers = []
    for av in ("avcodec", "avformat", "avutil", "swscale", "swresample"):
        fn = getattr(lib, f"sm_{av}_version", None)
        if fn is not None:
            fn.restype = ctypes.c_uint32
            v = fn()
            vers.append(f"{av} {v >> 16}.{(v >> 8) & 0xFF}.{v & 0xFF}")
    if not vers:
        # fall back to linking check only
        return "loaded (no version exports)"
    return ", ".join(vers)


@check("h264 encode/decode roundtrip", required=True)
def _codec_roundtrip():
    import numpy as np

    from smelter_tpu_torch.io.codec import Codec, VideoDecoder, VideoEncoder

    enc = VideoEncoder(Codec.H264, 64, 64, 30)
    y = np.full((64, 64), 128, np.uint8)
    u = v = np.full((32, 32), 128, np.uint8)
    pkts = []
    for i in range(3):
        enc.send(y, u, v, i / 30.0)
        while True:
            p = enc.receive()
            if p is None or p == "eof":
                break
            pkts.append(p)
    enc.send_eof()
    while True:
        p = enc.receive()
        if p is None or p == "eof":
            break
        pkts.append(p)
    extradata = enc.extradata()
    enc.close()
    dec = VideoDecoder(Codec.H264, extradata)
    n = 0
    for p in pkts:
        dec.send(p.data, p.pts_s)
        while True:
            f = dec.receive()
            if f is None or f == "eof":
                break
            n += 1
    dec.close()
    if not pkts:
        raise RuntimeError("x264 produced no packets")
    return f"{len(pkts)} pkts -> {n} frames"


@check("text shaping (raqm/freetype/harfbuzz)", required=True)
def _text():
    from PIL import features

    from smelter_tpu_torch.render.text import shaping_active

    raqm = features.check("raqm")
    active = shaping_active()
    if not features.check("freetype2"):
        raise RuntimeError("PIL built without freetype2")
    return f"freetype2 ok, raqm={'yes' if raqm else 'no'}, shaping={active}"


@check("SVG rasterizer (librsvg+cairo)", required=False)
def _svg():
    for libname in ("rsvg-2", "rsvg-2.40"):
        path = ctypes.util.find_library(libname)
        if path:
            break
    else:
        raise RuntimeError("librsvg not found (SVG images will be rejected)")
    if not ctypes.util.find_library("cairo"):
        raise RuntimeError("cairo not found")
    return path


@check("cryptography (QUIC/TLS, DTLS-SRTP)", required=True)
def _crypto():
    import cryptography
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    AESGCM(b"\0" * 16).encrypt(b"\0" * 12, b"x", None)
    return cryptography.__version__


@check("pillow (image decode)", required=True)
def _pil():
    import PIL
    from PIL import features

    codecs = [c for c in ("jpg", "zlib") if features.check(c)]
    return f"{PIL.__version__} ({', '.join(codecs)})"


@check("node (TS SDK builds)", required=False)
def _node():
    node = shutil.which("node")
    if node is None:
        raise RuntimeError("node not installed (TS SDK cannot be compiled "
                           "here; published packages are unaffected)")
    out = subprocess.run([node, "--version"], capture_output=True, text=True)
    return out.stdout.strip()


@check("chromium (web renderer sidecar)", required=False)
def _chromium():
    for name in ("chromium", "chromium-browser", "google-chrome", "chrome"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no browser binary (web_view renders transparent; "
                       "set SMELTER_WEB_RENDERER_CDP_URL to attach one)")


@check("DeckLink SDK", required=False)
def _decklink():
    lib = ctypes.util.find_library("DeckLinkAPI")
    if lib is None:
        raise RuntimeError("vendor SDK absent (decklink inputs are env-gated)")
    return lib


@check("V4L2 devices", required=False)
def _v4l2():
    devs = sorted(Path("/dev").glob("video*"))
    if not devs:
        raise RuntimeError("no /dev/video* capture devices")
    return ", ".join(str(d) for d in devs)


def main(argv: Optional[List[str]] = None) -> int:
    """Run every probe, print the report; returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--strict", action="store_true",
                    help="optional dependency failures also exit non-zero")
    ap.add_argument("--device", default=None,
                    help='"cpu": the card checks are optional; required if omitted')
    args = ap.parse_args(argv)

    results = [p(args.device != "cpu") for p in PROBES]

    hard_fail = any(not r["ok"] and r["required"] for r in results)
    soft_fail = any(not r["ok"] and not r["required"] for r in results)

    if args.json:
        print(json.dumps({"ok": not hard_fail, "checks": results}, indent=2))
    else:
        width = max(len(r["name"]) for r in results)
        for r in results:
            mark = "ok " if r["ok"] else ("FAIL" if r["required"] else "skip")
            print(f"[{mark:>4}] {r['name']:<{width}}  {r['detail']}")
        if hard_fail:
            print("\nrequired dependencies are broken — see FAIL lines above")
        elif soft_fail:
            print("\noptional capabilities missing (env-gated paths stay off)")

    return 1 if (hard_fail or (args.strict and soft_fail)) else 0


if __name__ == "__main__":
    sys.exit(main())
