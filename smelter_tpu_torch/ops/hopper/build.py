"""Build the CUDA kernels of `smelter_tpu_torch/csrc/` on first use and load
them with ctypes.

Every `*.cu` file compiles in its own nvcc process, all started together,
and the objects link into one shared library with a plain C interface,
`smelter_tpu_torch/_build/libsmelter_kernels-<hash>.so`. The hash covers the
sources, the headers and the flags, so an edit rebuilds and an unchanged
tree reuses the library. No PyTorch headers are included: the build takes
seconds, not minutes.

Flags: sm_90a (Hopper, with wgmma available to later kernels), -O3, and no
fast math: the kernels' parity with their plain PyTorch versions rests on
IEEE `sqrtf` and division and the accurate `cosf`/`sinf`. `-fmad=false`
keeps nvcc from contracting a*b + c into one FMA, so each kernel rounds
after every operation, as the plain versions (one PyTorch op at a time) do.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc): "
            "the CUDA kernels of smelter_tpu_torch cannot be built"
        )
    return nvcc


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return srcs, h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    """Build the kernel library if no library of the current sources exists;
    return its path. nvcc's output (register and spill counts from
    `-Xptxas -v`) is kept beside it as `build-<hash>.log`, and a failed
    build's error names that log."""
    srcs, digest = _sources()
    lib = BUILD_DIR / f"libsmelter_kernels-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [pathlib.Path(tmpdir) / f"{s.stem}.o" for s in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o), str(s)]
                for s, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for c in cmds]
        outs = [pr.communicate()[0] for pr in procs]
        tmp = pathlib.Path(tmpdir) / lib.name
        cmds.append([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                     "-o", str(tmp), *(str(o) for o in objs)])
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        outs.append(link.stdout + link.stderr)
        codes = [pr.returncode for pr in procs] + [link.returncode]
        log = BUILD_DIR / f"build-{digest}.log"
        log.write_text("".join(outs))
        if any(codes):
            failed = next(i for i, c in enumerate(codes) if c)
            raise RuntimeError(
                f"nvcc failed ({codes[failed]}): {' '.join(cmds[failed])} (build log: {log})\n"
                f"{outs[failed]}"
            )
        os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set.
    Each entry returns the `cudaError_t` of its launch."""
    lib = ctypes.CDLL(str(library_path()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.smelter_yuv420_out.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.smelter_yuv420_out.restype = i
    lib.smelter_scene_assembly.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.smelter_scene_assembly.restype = i
    lib.smelter_sdf_layers.argtypes = [p, p, p, i, i, i, p]
    lib.smelter_sdf_layers.restype = i
    lib.smelter_cuda_error_string.argtypes = [i]
    lib.smelter_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err != 0:
        msg = library().smelter_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
