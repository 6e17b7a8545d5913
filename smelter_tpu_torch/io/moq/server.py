"""Shared MoQ server (reference `moq/server.rs` + `server/state.rs`):
one QUIC listener for every registered moq_server input. Publishers
connect with the input name as the URL path and a `token` query
parameter; the SETUP is validated against the registered input's
auth_token, then the announced broadcast feeds that input."""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from smelter_tpu_torch.io.moq import wire
from smelter_tpu_torch.io.moq.session import MoqSession
from smelter_tpu_torch.io.quic.endpoint import QuicConnectionHandle, QuicServer
from smelter_tpu_torch.io.quic.tls import load_or_create_self_signed

logger = logging.getLogger("smelter.moq")


class MoqServerState:
    """input name -> MoqServerInput (reference MoqServerState)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._inputs: Dict[str, object] = {}

    def register(self, name: str, source) -> None:
        with self._lock:
            self._inputs[name] = source

    def unregister(self, name: str) -> None:
        with self._lock:
            self._inputs.pop(name, None)

    def find(self, name: str):
        with self._lock:
            return self._inputs.get(name)


class MoqServer:
    """Accept loop owner. `cert_dir` persists the self-signed TLS pair
    (reference certificate.rs load_or_create_self_signed_tls)."""

    def __init__(self, port: int, state: MoqServerState,
                 cert_dir: str = "/tmp/smelter_moq",
                 cert_der: Optional[bytes] = None,
                 key_pem: Optional[bytes] = None,
                 require_retry: Optional[bool] = None) -> None:
        self.state = state
        if cert_der is None or key_pem is None:
            cert_der, key_pem = load_or_create_self_signed(cert_dir)
        if require_retry is None:
            # public-internet relays want QUIC address validation (Retry,
            # RFC 9000 §8.1) so spoofed-source Initials can't run up TLS
            # handshakes; off by default like quinn's use_retry
            require_retry = os.environ.get(
                "SMELTER_MOQ_REQUIRE_RETRY", "false"
            ).lower() in ("1", "true", "yes")
        self._server = QuicServer(
            port, cert_der, key_pem, [wire.ALPN],
            on_connection=self._on_connection,
            require_retry=require_retry,
        )
        self.port = self._server.port
        self._server.start()
        logger.info("MoQ server started on port %d", self.port)

    def close(self) -> None:
        self._server.close()

    def _on_connection(self, handle: QuicConnectionHandle) -> None:
        session = MoqSession(handle, is_quic_client=False)

        def on_setup(sess: MoqSession) -> bool:
            # path = input name (url-encoded), token must match
            # (reference server.rs handle_incoming_connection)
            import urllib.parse

            name = urllib.parse.unquote(sess.path.lstrip("/"))
            source = self.state.find(name)
            if source is None:
                logger.warning("MoQ connection for unknown input %r", name)
                return False
            expected = getattr(source, "options", None)
            token = getattr(expected, "auth_token", "") if expected else ""
            if token and sess.token != token:
                logger.warning("MoQ auth failed for input %r", name)
                return False
            return source.attach_session(sess)

        session.start_server(on_setup)
