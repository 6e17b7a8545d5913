"""Loading the port's native host services (the codec service, the DTLS
helper, the DeckLink shim) without ever writing under ``native/``.

The committed library under ``native/`` is loaded unless it is missing, older
than its ``.cpp`` sources (the reference's rule), or refused by the loader
(one linked against another FFmpeg's sonames, say). Then the sources are
compiled with ``native/Makefile``'s flags into the git-ignored
``smelter_tpu_torch/_build/``, named by a hash of the sources and the
flags, and that library is loaded. When both fail, the error carries both
messages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Sequence

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
# native/Makefile's CXXFLAGS, for a shared library
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")


def build(name: str, sources: Sequence[str], ld_libs: Sequence[str] = ()) -> str:
    """Compile the ``.cpp`` files of `sources` (paths under native/; headers
    are hashed only) into _build/ and return the library's path; unchanged
    sources and flags reuse the library built before."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + tuple(ld_libs)).encode())
    for src in sources:
        with open(os.path.join(NATIVE_DIR, src), "rb") as f:
            h.update(f.read())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    cpp = [os.path.join(NATIVE_DIR, s) for s in sources if s.endswith(".cpp")]
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, os.path.basename(lib))
        cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, *cpp, *ld_libs]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({out.returncode}): {' '.join(cmd)}\n{out.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib


def load(name: str, sources: Sequence[str], ld_libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The committed ``native/lib<name>.so``, else one built into _build/
    from `sources` (see the module's docstring)."""
    committed = os.path.join(NATIVE_DIR, f"lib{name}.so")
    if not os.path.exists(committed):
        why = "is missing"
    elif any(os.path.getmtime(os.path.join(NATIVE_DIR, s)) > os.path.getmtime(committed)
             for s in sources if s.endswith(".cpp")):
        why = "is older than its source"
    else:
        try:
            return ctypes.CDLL(committed)
        except OSError as exc:
            why = f"cannot load: {exc}"
    try:
        return ctypes.CDLL(build(name, sources, ld_libs))
    except (OSError, RuntimeError) as exc:
        raise RuntimeError(
            f"{committed} {why}; building it into {BUILD_DIR} failed too: {exc}") from exc
