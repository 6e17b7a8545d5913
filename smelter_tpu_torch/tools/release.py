"""Release packaging of the port (the counterpart of the reference's
`tools/release.py`): bundle the port's package (with its CUDA sources,
`csrc/`), `chip_smoke.py`, the native C++ sources and Makefile, the TS SDK
workspace and the README into a versioned tarball with its checksum.

Usage: python -m smelter_tpu_torch.tools.release [--version X.Y.Z] [--outdir dist/]
    [--skip-native-build]

The codec service is first compiled from source, so that a broken tree
cannot be packaged, through `io/native_lib.py` into the git-ignored
`smelter_tpu_torch/_build/` (never `make -C native`, which would rewrite the
committed libraries). The tarball ships sources: the target builds the
native libraries and the kernels' library (`ops/hopper/build.py`, nvcc) at
first use; no built library is shipped.
"""

from __future__ import annotations

import argparse
import hashlib
import io as _io
import json
import os
import sys
import tarfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

INCLUDE = [
    "smelter_tpu_torch",
    "chip_smoke.py",
    "native/smelter_io",
    "native/smelter_decklink",
    "native/smelter_dtls",
    "native/Makefile",
    "ts",
    "README.md",
]

EXCLUDE_DIRS = {"__pycache__", "node_modules", "dist", ".pytest_cache", "_build"}
DEFAULT_OUTDIR = os.path.join(REPO, "dist")  # git-ignored


def _filter(info: tarfile.TarInfo):
    parts = info.name.split("/")
    if any(p in EXCLUDE_DIRS or p.endswith(".pyc") for p in parts):
        return None
    return info


def main(argv=None) -> dict:
    """Build the tarball and its .sha256; prints and returns the summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--version", default="0.1.0")
    ap.add_argument("--outdir", default=DEFAULT_OUTDIR)
    ap.add_argument("--skip-native-build", action="store_true")
    args = ap.parse_args(argv)

    if not args.skip_native_build:
        from smelter_tpu_torch.io import codec, native_lib

        print("building native library...", flush=True)
        native_lib.build("smelter_io", codec._SOURCES, codec._LD_LIBS)

    os.makedirs(args.outdir, exist_ok=True)
    name = f"smelter-tpu-torch-{args.version}"
    tar_path = os.path.join(args.outdir, f"{name}.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tar:
        for rel in INCLUDE:
            src = os.path.join(REPO, rel)
            if not os.path.exists(src):
                print(f"warning: {rel} missing, skipped", file=sys.stderr)
                continue
            tar.add(src, arcname=f"{name}/{rel}", filter=_filter)
        manifest = json.dumps({
            "name": "smelter-tpu-torch",
            "version": args.version,
            "built_at": int(time.time()),
            "python": sys.version.split()[0],
        }, indent=2).encode()
        info = tarfile.TarInfo(f"{name}/RELEASE.json")
        info.size = len(manifest)
        tar.addfile(info, _io.BytesIO(manifest))

    with open(tar_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    with open(tar_path + ".sha256", "w") as f:
        f.write(f"{digest}  {os.path.basename(tar_path)}\n")
    size_mb = os.path.getsize(tar_path) / 1e6
    summary = {"tarball": tar_path, "sha256": digest, "size_mb": round(size_mb, 1)}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
