"""The port's `release` and `dependency_check` tools, on the CPU:

  - `release --skip-native-build` into a temporary directory: the tarball
    holds the port's CUDA sources (`smelter_tpu_torch/csrc/*.cu`) and no
    `_build/`, its `.sha256` verifies, the package imports from the
    extracted tree in a process where `jax` and `smelter_tpu` cannot be
    imported, and no tracked file of the repo changed; without the flag
    the codec service is compiled through `io/native_lib.build`, never by
    `make -C native`; the default output directories of `release`,
    `docs_examples` and the two generators are ignored by git;
  - `dependency_check --device cpu --json` exits 0 here with the reference
    tool's JSON shape and every required check passing (this box has
    FFmpeg), the reference's checks but JAX's and the card's four in their
    place; without `--device cpu` the card's checks are required, so it
    exits 1 and names the CUDA check.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import pathlib
import re
import subprocess
import sys
import tarfile

import pytest

from smelter_tpu_torch.io import native_lib
from smelter_tpu_torch.tools import (
    dependency_check,
    docs_examples,
    generate_schemas,
    generate_ts_types,
    release,
)
from tests.test_torch_tools import ROOT, load_reference


def _git(*args):
    return subprocess.run(["git", *args], cwd=ROOT, capture_output=True, text=True, check=True)


def _quiet(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    return res, out.getvalue()


_IMPORT_EXTRACTED = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # `import jax` raises ImportError
sys.modules["smelter_tpu"] = None
import smelter_tpu_torch
assert smelter_tpu_torch.__file__.startswith(sys.argv[1]), smelter_tpu_torch.__file__
names = [m.name for m in pkgutil.walk_packages(smelter_tpu_torch.__path__, "smelter_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(len(names))
"""


def test_release_bundles_the_port(tmp_path):
    tracked = _git("status", "--porcelain", "--untracked-files=no").stdout
    res, printed = _quiet(release.main, ["--skip-native-build", "--outdir", str(tmp_path),
                                         "--version", "9.8.7"])
    assert json.loads(printed.splitlines()[-1]) == res
    tar_path = tmp_path / "smelter-tpu-torch-9.8.7.tar.gz"
    assert res["tarball"] == str(tar_path)
    digest = hashlib.sha256(tar_path.read_bytes()).hexdigest()
    assert res["sha256"] == digest
    assert (tmp_path / (tar_path.name + ".sha256")).read_text() == f"{digest}  {tar_path.name}\n"

    with tarfile.open(tar_path) as tar:
        names = tar.getnames()
        tar.extractall(tmp_path / "x", filter="data")
    top = "smelter-tpu-torch-9.8.7"
    cu = sorted(n.split("/")[-1] for n in names if re.fullmatch(
        rf"{top}/smelter_tpu_torch/csrc/[^/]+\.cu", n))
    assert cu == sorted(p.name for p in (ROOT / "smelter_tpu_torch" / "csrc").glob("*.cu"))
    assert not [n for n in names if "/_build" in n or "__pycache__" in n or n.endswith(".so")]
    assert f"{top}/chip_smoke.py" in names and f"{top}/native/Makefile" in names
    assert f"{top}/native/smelter_io/smelter_io.cpp" in names and f"{top}/README.md" in names
    manifest = json.loads((tmp_path / "x" / top / "RELEASE.json").read_text())
    assert (manifest["name"], manifest["version"]) == ("smelter-tpu-torch", "9.8.7")

    tree = tmp_path / "x" / top
    out = subprocess.run([sys.executable, "-c", _IMPORT_EXTRACTED, str(tree)], cwd=tree,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(tree)},
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout) > 100
    assert _git("status", "--porcelain", "--untracked-files=no").stdout == tracked


def test_release_builds_the_codec_service_into_build(tmp_path, monkeypatch):
    built = []
    monkeypatch.setattr(native_lib, "build", lambda *a: built.append(a) or "lib.so")
    run = subprocess.run

    def no_make(cmd, *a, **k):
        assert "make" not in cmd[:1], cmd
        return run(cmd, *a, **k)

    monkeypatch.setattr(subprocess, "run", no_make)
    _quiet(release.main, ["--outdir", str(tmp_path)])
    from smelter_tpu_torch.io import codec

    assert built == [("smelter_io", codec._SOURCES, codec._LD_LIBS)]


def test_default_outputs_are_ignored_by_git():
    defaults = [release.DEFAULT_OUTDIR, str(docs_examples.DEFAULT_OUT),
                generate_schemas.DEFAULT_OUTDIR, generate_ts_types.DEFAULT_OUT]
    for path in defaults:
        rel = str(pathlib.Path(path).relative_to(ROOT))
        assert not rel.startswith(("docs/generated", "tools/", "ts/")), rel
        ignored = subprocess.run(["git", "check-ignore", "-q", f"{rel}/x"], cwd=ROOT)
        assert ignored.returncode == 0, f"{rel} is not ignored by git"


# -- dependency_check ------------------------------------------------------------


def _reference_shape(monkeypatch):
    """The reference tool's `--json` output with each probe replaced by one
    that passes (none of its real probes run), and its checks' names."""
    reference = load_reference("dependency_check", monkeypatch)
    for name, value in list(vars(reference).items()):
        if getattr(value, "probe", False):
            monkeypatch.setattr(reference, name, reference.check(name, required=True)(lambda: "x"))
    monkeypatch.setattr(sys, "argv", ["dependency_check", "--json"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as done:
        reference.main()
    assert done.value.code == 0
    source = (ROOT / "tools" / "dependency_check.py").read_text()
    return json.loads(out.getvalue()), re.findall(r'@check\("([^"]+)"', source)


def test_dependency_check_on_the_cpu(monkeypatch):
    ref, ref_names = _reference_shape(monkeypatch)
    code, printed = _quiet(dependency_check.main, ["--device", "cpu", "--json"])
    report = json.loads(printed)
    assert code == 0 and report["ok"] is True
    assert set(report) == set(ref)
    assert {frozenset(c) for c in report["checks"]} == {frozenset(c) for c in ref["checks"]}
    names = [c["name"] for c in report["checks"]]
    assert names == [n for n in ref_names if not n.startswith("jax")][:1] + [
        "torch", "CUDA card", "nvcc (sm_90a)", "kernels build"] + [
        n for n in ref_names if not n.startswith("jax")][1:]
    required = [c for c in report["checks"] if c["required"]]
    assert all(c["ok"] for c in required), [c for c in required if not c["ok"]]
    by_name = {c["name"]: c for c in report["checks"]}
    assert by_name["native smelter_io (FFmpeg)"]["detail"].startswith("avcodec ")
    card = {by_name[n]["required"] for n in ("CUDA card", "nvcc (sm_90a)", "kernels build")}
    assert card == {False}


def test_dependency_check_needs_the_card_unless_given_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("torch sees a CUDA card here")
    code, printed = _quiet(dependency_check.main, [])
    assert code == 1
    fail_lines = [line for line in printed.splitlines() if line.startswith("[FAIL]")]
    assert fail_lines and fail_lines[0].split("]", 1)[1].split()[:2] == ["CUDA", "card"]
    assert "required dependencies are broken" in printed
