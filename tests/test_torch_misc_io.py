"""The port's V4L2 and DeckLink inputs (`smelter_tpu_torch.io.v4l2`,
`.io.decklink`) against the reference's, on the CPU (`tests/test_misc_io.py`
and the DeckLink case of `tests/test_server.py::test_server_reset_and_decklink`).

No camera or SDI card exists here, so the capture device is the reference
tests' fake driver (`tests.test_misc_io._FakeV4l2Driver`, which patches the
process-wide `os.open`/`fcntl.ioctl` both packages call) and DeckLink is the
committed shim without the vendor SDK.

Tolerances: equal outcomes. Each case gives the same negotiated format and
size, byte-equal de-strided planes, the same exception type and message,
and, through the servers, the same status, `error_code` and message; the
YUYV capture format converts within 1 u8 LSB of the reference."""

from __future__ import annotations

import importlib

import httpx
import numpy as np
import pytest
import torch

from tests.test_misc_io import _FakeV4l2Driver
from tests.test_torch_rtp import BOTH, PORT, REF
from tests.test_torch_server import reference_server, server  # noqa: F401 (fixtures)

torch.set_num_threads(2)

NV12, YUYV = "nv12", "yuyv"


def _v4l2(name: str):
    return importlib.import_module(f"{name}.io.v4l2")


def _outcome(fn):
    try:
        return ("ok", fn())
    except OSError as exc:
        return (type(exc).__name__, str(exc))


def _capture_script(name: str, case: str) -> tuple:
    m = _v4l2(name)
    if case == "missing_device":
        return _outcome(lambda: m.V4l2Input(m.V4l2InputOptions(device_path="/dev/video99")))
    fmt = {"nv12": NV12, "downgrade": NV12, "mjpg": YUYV, "rgb24": "rgb24", "yuyv": YUYV}[case]
    inp = _outcome(lambda: m.V4l2Input(m.V4l2InputOptions(width=64, height=48, format=fmt)))
    if inp[0] != "ok":
        return inp
    inp = inp[1]
    stride = 64 + 64 if inp.format == NV12 else 64 * 2 + 64
    rng = np.random.RandomState(9)
    rows = 48 + 24 if inp.format == NV12 else 48
    data, pix = inp._frame_data(rng.randint(0, 256, stride * rows, dtype=np.uint8))
    planes = data if isinstance(data, tuple) else (data,)
    return (inp.format, inp.width, inp.height, pix.name,
            [(p.shape, p.tobytes()) for p in planes])


@pytest.mark.parametrize("case", ["nv12", "yuyv", "downgrade", "mjpg", "rgb24",
                                  "missing_device"])
def test_v4l2_capture_matches_the_reference(monkeypatch, case):
    """Format negotiation (granted, downgraded by the driver, refused),
    de-striding of padded NV12 and YUYV buffers, and a missing device."""
    if case != "missing_device":
        m = _v4l2(PORT)
        _FakeV4l2Driver(monkeypatch, negotiate_to={
            "downgrade": m.V4L2_PIX_FMT_YUYV, "mjpg": 0x47504A4D}.get(case))
    ref, port = _capture_script(REF, case), _capture_script(PORT, case)
    assert port == ref
    if case == "nv12":
        assert port[:4] == (NV12, 64, 48, "NV12")
        assert [shape for shape, _ in port[4]] == [(48, 64), (24, 32, 2)]
    elif case == "yuyv":
        assert port[3] == "INTERLEAVED_YUYV422" and port[4][0][0] == (48, 32, 4)
    elif case == "downgrade":
        assert port[0] == YUYV
    elif case == "mjpg":
        assert port[0] == "OSError" and "MJPG" in port[1]
    elif case == "rgb24":
        assert port[0] == "OSError" and "rgb24" in port[1]
    else:
        assert port[0] in ("OSError", "FileNotFoundError", "PermissionError")


def test_v4l2_device_list_matches_the_reference():
    ref = [vars(d) for d in _v4l2(REF).list_v4l2_devices()]
    assert [vars(d) for d in _v4l2(PORT).list_v4l2_devices()] == ref


def test_yuyv_capture_converts_as_the_reference():
    """A seeded YUYV frame (the V4L2 capture format) through both packages'
    converters."""
    from smelter_tpu.ops.color_convert import interleaved_yuyv_to_rgba as ref_convert
    from smelter_tpu_torch.ops.color_convert import interleaved_yuyv_to_rgba

    data = np.random.RandomState(10).randint(0, 256, (48, 32, 4), dtype=np.uint8)
    ref = np.asarray(ref_convert(data))
    port = interleaved_yuyv_to_rgba(torch.from_numpy(data)).numpy()
    assert port.shape == ref.shape == (48, 64, 4)
    assert np.abs(port.astype(np.float64) - ref.astype(np.float64)).max() <= 1 / 255 + 1e-6


def test_decklink_without_the_sdk_matches_the_reference():
    outcomes = []
    for name in BOTH:
        m = importlib.import_module(f"{name}.io.decklink")
        outcomes.append(([vars(d) for d in m.list_decklink_devices()],
                         _outcome(lambda: m.DeckLinkInput(subdevice_index=0))))
    assert outcomes[1] == outcomes[0]
    assert outcomes[1][0] == [] and "DeckLink" in outcomes[1][1][1]


@pytest.mark.parametrize("body", [
    {"type": "decklink"},
    {"type": "decklink", "display_name": "DeckLink Duo (1)"},
    {"type": "v4l2", "path": "/dev/video99"},
    {"type": "v4l2", "path": "/dev/video0", "format": "mjpg"},
], ids=["decklink", "decklink_by_name", "v4l2_missing", "v4l2_format"])
def test_capture_inputs_through_the_server_match_the_reference(server, reference_server,
                                                               body):
    """The port's server answers a DeckLink or V4L2 registration as the
    reference's does where no device exists: the same status, error code
    and message, and nothing registered."""
    answers = []
    for s in (reference_server, server):
        with httpx.Client(base_url=s.base, timeout=30) as c:
            r = c.post("/api/input/sdi/register", json=body)
            answers.append((r.status_code, r.json().get("error_code"), r.json().get("message")))
            assert c.get("/status").json()["inputs"] == []
    assert answers[1] == answers[0]
    assert answers[1][0] >= 400
