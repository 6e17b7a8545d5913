"""ctypes wrapper over the native DTLS-SRTP helper (native/smelter_dtls/).

The handshake state machine runs in OpenSSL via memory BIOs; Python owns the
(ICE-muxed) UDP socket and shuttles datagrams. On completion the RFC 5764
SRTP keying material is exported for `smelter_tpu_torch.io.webrtc.srtp`.

The port's copy differs from the reference's in its loader only: it never
runs ``make -C native``. It loads the committed ``native/libsmelter_dtls.so``,
or, where that is missing, stale or refused by the loader, builds
``native/smelter_dtls/`` into the git-ignored ``smelter_tpu_torch/_build/``
against OpenSSL 3's ``libssl.so.3`` and ``libcrypto.so.3``, as
``native/Makefile`` links it (`smelter_tpu_torch.io.native_lib`).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

from smelter_tpu_torch.io import native_lib

_lib = None
_lock = threading.Lock()
_BUF_CAP = 17000  # > max DTLS flight


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = native_lib.load("smelter_dtls", ("smelter_dtls/smelter_dtls.cpp",),
                              ("-l:libssl.so.3", "-l:libcrypto.so.3"))
        lib.sm_dtls_last_error.restype = ctypes.c_char_p
        lib.sm_dtls_do_handshake.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int,
        ]
        lib.sm_dtls_fingerprint.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.sm_dtls_export_srtp_keys.argtypes = [ctypes.c_int, ctypes.c_char_p]
        _lib = lib
        return lib


class DtlsError(RuntimeError):
    pass


class DtlsEndpoint:
    """One DTLS-SRTP endpoint (server = a=setup:passive side)."""

    def __init__(self, is_server: bool) -> None:
        self._lib = _load()
        self._h = self._lib.sm_dtls_new(1 if is_server else 0)
        if self._h < 0:
            raise DtlsError(self._lib.sm_dtls_last_error().decode())
        self.is_server = is_server
        self._buf = ctypes.create_string_buffer(_BUF_CAP)

    def fingerprint(self) -> str:
        n = self._lib.sm_dtls_fingerprint(self._h, self._buf, _BUF_CAP)
        if n < 0:
            raise DtlsError(self._lib.sm_dtls_last_error().decode())
        return self._buf.raw[:n].decode()

    def handshake(self, incoming: bytes = b"") -> bytes:
        """Feed an incoming datagram (or b'' to kick off the client flight);
        returns bytes to send to the peer (may be empty)."""
        n = self._lib.sm_dtls_do_handshake(
            self._h, incoming, len(incoming), self._buf, _BUF_CAP
        )
        if n < 0:
            raise DtlsError(self._lib.sm_dtls_last_error().decode())
        return self._buf.raw[:n]

    @property
    def established(self) -> bool:
        return self._lib.sm_dtls_is_established(self._h) == 1

    def export_srtp_keys(self) -> Tuple[bytes, bytes, bytes, bytes]:
        """(client_key, server_key, client_salt, server_salt) per RFC 5764."""
        buf = ctypes.create_string_buffer(60)
        n = self._lib.sm_dtls_export_srtp_keys(self._h, buf)
        if n != 60:
            raise DtlsError(self._lib.sm_dtls_last_error().decode())
        material = buf.raw
        return material[0:16], material[16:32], material[32:46], material[46:60]

    def close(self) -> None:
        if self._h >= 0:
            self._lib.sm_dtls_close(self._h)
            self._h = -1

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
