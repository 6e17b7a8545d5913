"""The port's QUIC stack (`smelter_tpu_torch.io.quic`) against the
reference's (`smelter_tpu.io.quic`), on the CPU.

Tolerances:
  - the wire codecs are byte-equal on numpy-seeded inputs: varints, packet
    numbers, long headers, Retry packets, every frame encoder, transport
    parameters, HKDF, packet protection (seal byte-equal, each package opens
    the other's packets) and a client's first Initial datagram with the
    randomness of both packages drawn from one seed; the decoders return
    equal fields, or fail alike, on the same bytes, random ones included;
  - the RFC 9001 initial-key (A.1) and Retry (A.4) vectors hold on the port,
    as `tests/test_quic.py` checks them on the reference;
  - sessions across packages: the port's `QuicClient` against the
    reference's `QuicServer`, the reverse, and the port's own pair complete
    a handshake and carry 128 KiB each way on streams and a datagram;
  - on the port's own pair, `tests/test_quic.py`'s loss recovery (20%
    injected loss), key update, ALPN mismatch, hostile datagrams, Retry,
    peer verification and forged-Retry flows meet its bounds.

Every endpoint is closed in `finally`, and each test that starts one checks
that its receive threads end."""

from __future__ import annotations

import importlib
import random
import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

REF, PORT = "smelter_tpu", "smelter_tpu_torch"
BOTH = (REF, PORT)


def _quic(name: str) -> SimpleNamespace:
    mod = lambda path: importlib.import_module(f"{name}.io.quic.{path}")  # noqa: E731
    package = importlib.import_module(f"{name}.io.quic")
    return SimpleNamespace(
        name=name, pkt=mod("packet"), crypto=mod("crypto"), tls=mod("tls"),
        connection=mod("connection"), QuicClient=package.QuicClient,
        QuicServer=package.QuicServer)


def _fields(obj):
    return (type(obj).__name__, vars(obj))


def _outcome(fn, *args):
    """fn(*args), or the name of the exception it raised."""
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return ("raised", type(exc).__name__)


def _endpoint_threads():
    return {t for t in threading.enumerate() if t.name == "quic-endpoint"}


def _assert_threads_end(before, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and _endpoint_threads() - before:
        time.sleep(0.05)
    left = _endpoint_threads() - before
    assert not left, f"{len(left)} endpoint receive threads outlived their endpoints"


# --------------------------------------------------------------- wire codecs


def test_varints_and_packet_numbers_are_byte_equal():
    ref, port = _quic(REF).pkt, _quic(PORT).pkt
    rng = np.random.RandomState(0)
    values = [0, 1, 63, 64, 16383, 16384, 2**30 - 1, 2**30, 2**62 - 1]
    for bits in (6, 14, 30, 62):
        values += [int(v) for v in rng.randint(0, 2**min(bits, 63) - 1, 50, dtype=np.uint64)
                   if int(v) < 2**62]
    for v in values:
        enc = ref.encode_varint(v)
        assert port.encode_varint(v) == enc
        assert port.decode_varint(b"\xAA" + enc + b"\x00", 1) == ref.decode_varint(
            b"\xAA" + enc + b"\x00", 1) == (v, len(enc) + 1)
    assert _outcome(port.encode_varint, 2**62) == _outcome(ref.encode_varint, 2**62)
    assert _outcome(port.decode_varint, b"\xC0\x00", 0) == _outcome(
        ref.decode_varint, b"\xC0\x00", 0)
    # RFC 9000 A.2/A.3 and numpy-seeded (pn, largest acked) pairs
    assert port.decode_packet_number(0x9B32, 16, 0xA82F30EA) == 0xA82F9B32
    for _ in range(300):
        largest = int(rng.randint(0, 2**31))
        pn = largest + 1 + int(rng.randint(0, 2**16))
        assert port.encode_packet_number(pn, largest) == ref.encode_packet_number(pn, largest)
        nbits = int(rng.choice([8, 16, 24, 32]))
        trunc = int(rng.randint(0, 2**nbits))
        assert port.decode_packet_number(trunc, nbits, largest) == \
            ref.decode_packet_number(trunc, nbits, largest)


def _random_frames(pkg, rng: random.Random) -> bytes:
    """A numpy-free random mix of every encoder of `packet.py`, rebuilt
    identically from a `random.Random` of the same seed."""
    pkt = pkg.pkt
    out = b""
    for _ in range(rng.randrange(1, 12)):
        kind = rng.randrange(5)
        data = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 90)))
        if kind == 0:
            out += pkt.encode_crypto(rng.randrange(2**20), data)
        elif kind == 1:
            out += pkt.encode_stream(rng.randrange(2**12), rng.randrange(2**24), data,
                                     bool(rng.randrange(2)))
        elif kind == 2:
            out += pkt.encode_datagram(data)
        elif kind == 3:
            hi = rng.randrange(10, 5000)
            ranges, top = [], hi
            while top > 0 and len(ranges) < 5:
                lo = max(0, top - rng.randrange(0, 6))
                ranges.append((lo, top))
                top = lo - 2 - rng.randrange(0, 5)
            ack = pkt.AckFrame(hi, rng.randrange(0, 2**14) << 3, ranges)
            out += pkt.encode_ack(ack, 3)
        else:
            ftype = rng.choice([None, rng.randrange(0x40)])
            out += pkt.encode_connection_close(rng.randrange(2**16), ftype, data[:40])
    return out


def test_frames_are_byte_equal():
    ref, port = _quic(REF), _quic(PORT)
    for seed in range(60):
        wire = _random_frames(ref, random.Random(seed))
        assert _random_frames(port, random.Random(seed)) == wire
        got = [_fields(f) for f in port.pkt.decode_frames(wire)]
        assert got == [_fields(f) for f in ref.pkt.decode_frames(wire)]
    # tests/test_quic.py's five frames, and random bytes through both decoders
    frames = (port.pkt.encode_crypto(10, b"abc") + port.pkt.encode_stream(4, 100, b"payload", True)
              + port.pkt.encode_datagram(b"dg")
              + port.pkt.encode_ack(port.pkt.AckFrame(9, 80, [(7, 9), (1, 3)]), 3)
              + port.pkt.encode_connection_close(3, None, b"bye"))
    kinds = [type(f).__name__ for f in port.pkt.decode_frames(frames)]
    assert kinds == ["CryptoFrame", "StreamFrame", "DatagramFrame", "AckFrame",
                     "ConnectionCloseFrame"]
    rng = np.random.RandomState(5)
    for _ in range(400):
        data = rng.randint(0, 256, rng.randint(1, 48), dtype=np.uint8).tobytes()
        a, b = _outcome(ref.pkt.decode_frames, data), _outcome(port.pkt.decode_frames, data)
        if a[0] == "ok":
            a, b = (a[0], [_fields(f) for f in a[1]]), (b[0], [_fields(f) for f in b[1]])
        assert b == a, data.hex()


def test_headers_retry_and_transport_params_are_byte_equal():
    ref, port = _quic(REF), _quic(PORT)
    rng = np.random.RandomState(9)

    def rbytes(n):
        return rng.randint(0, 256, n, dtype=np.uint8).tobytes()

    for _ in range(100):
        kw = dict(packet_type=int(rng.randint(0, 4)), version=int(rng.randint(0, 2**32)),
                  dcid=rbytes(int(rng.randint(0, 21))), scid=rbytes(int(rng.randint(0, 21))),
                  token=rbytes(int(rng.randint(0, 60))))
        pn_len = int(rng.randint(1, 5))
        wire = ref.pkt.build_long_header_prefix(ref.pkt.LongHeader(**kw), pn_len)
        assert port.pkt.build_long_header_prefix(port.pkt.LongHeader(**kw), pn_len) == wire
        assert _fields(port.pkt.parse_long_header_prefix(wire)[0]) == _fields(
            ref.pkt.parse_long_header_prefix(wire)[0])
        retry = dict(version=1, dcid=kw["dcid"], scid=kw["scid"], token=kw["token"],
                     odcid=rbytes(8))
        wire = ref.pkt.build_retry(**retry)
        assert port.pkt.build_retry(**retry) == wire
        h1, t1, g1 = port.pkt.parse_retry(wire)
        h0, t0, g0 = ref.pkt.parse_retry(wire)
        assert (_fields(h1), t1, g1) == (_fields(h0), t0, g0)
        tp = dict(max_idle_timeout_ms=int(rng.randint(0, 2**20)),
                  initial_max_data=int(rng.randint(0, 2**40)),
                  initial_max_stream_data=int(rng.randint(0, 2**30)),
                  initial_max_streams_bidi=int(rng.randint(0, 2**16)),
                  initial_max_streams_uni=int(rng.randint(0, 2**16)),
                  ack_delay_exponent=int(rng.randint(0, 21)),
                  max_ack_delay_ms=int(rng.randint(0, 2**14)),
                  original_dcid=rbytes(8) if rng.randint(2) else None,
                  initial_scid=rbytes(8), retry_scid=rbytes(8) if rng.randint(2) else None,
                  max_datagram_frame_size=int(rng.randint(0, 65528)))
        wire = ref.pkt.encode_transport_params(ref.pkt.TransportParams(**tp))
        assert port.pkt.encode_transport_params(port.pkt.TransportParams(**tp)) == wire
        assert vars(port.pkt.decode_transport_params(wire)) == vars(
            ref.pkt.decode_transport_params(wire))


def test_initial_keys_and_retry_tag_match_rfc9001_on_the_port():
    """RFC 9001 A.1 (client initial secret and keys) and A.4 (Retry
    integrity tag), as `tests/test_quic.py` checks them on the reference."""
    port = _quic(PORT)
    dcid = bytes.fromhex("8394c8f03e515708")
    tx, rx = port.crypto.initial_secrets(dcid, is_client=True)
    assert tx.hex() == "c00cf151ca5be075ed0ebfb5c80323c42d6b7db67881289af4008f1f6c357aea"
    prot = port.crypto.PacketProtection(tx_secret=tx)
    assert prot.tx.key.hex() == "1f369613dd76d5467730efcbe3b1a22d"
    assert prot.tx.iv.hex() == "fa044b2f42a3fd3b46fb255c"
    assert prot.tx.hp.hex() == "9f50449e04a0e810283a1e9933adedd2"
    sample = bytes.fromhex(
        "ff000000010008f067a5502a4262b5746f6b656e04a265ba2eff4d829058fb3f0f2496ba")
    built = port.pkt.build_retry(port.pkt.QUIC_V1, dcid=b"",
                                 scid=bytes.fromhex("f067a5502a4262b5"), token=b"token",
                                 odcid=dcid)
    assert built[1:-16] == sample[1:-16]
    assert port.crypto.retry_integrity_tag(dcid, sample[:-16]) == sample[-16:]
    assert port.pkt.parse_retry(sample)[1:] == (b"token", sample[-16:])


def test_packet_protection_is_byte_equal_across_packages():
    """The same secrets seal the same packets byte for byte, in both
    directions of a key update, and each package opens the other's."""
    ref, port = _quic(REF).crypto, _quic(PORT).crypto
    rng = np.random.RandomState(13)
    for _ in range(40):
        secret = rng.randint(0, 256, 32, dtype=np.uint8).tobytes()
        label = rng.randint(0, 256, 12, dtype=np.uint8).tobytes().hex()
        assert port.hkdf_extract(secret[:16], secret) == ref.hkdf_extract(secret[:16], secret)
        assert port.hkdf_expand_label(secret, label, secret[:5], 48) == \
            ref.hkdf_expand_label(secret, label, secret[:5], 48)
        dcid = rng.randint(0, 256, 8, dtype=np.uint8).tobytes()
        for is_client in (True, False):
            assert port.initial_secrets(dcid, is_client) == ref.initial_secrets(dcid, is_client)
        seal = {name: mod.PacketProtection(tx_secret=secret)
                for name, mod in ((REF, ref), (PORT, port))}
        # the reader follows the writer's key update, so it has keys of its own
        open_ = {name: mod.PacketProtection(tx_secret=secret[::-1], rx_secret=secret)
                 for name, mod in ((REF, ref), (PORT, port))}
        short = bool(rng.randint(2))
        for generation in range(2):
            pn = int(rng.randint(0, 2**20))
            pn_bytes = pn.to_bytes(4, "big")[-int(rng.randint(1, 5)):]
            first = (0x40 | (seal[REF].key_phase << 2) if short else 0xC0) | (len(pn_bytes) - 1)
            prefix = bytes([first]) + rng.randint(0, 256, 8, dtype=np.uint8).tobytes()
            payload = rng.randint(0, 256, int(rng.randint(20, 300)), dtype=np.uint8).tobytes()
            wire = seal[REF].seal(prefix, pn, pn_bytes, payload)
            assert seal[PORT].seal(prefix, pn, pn_bytes, payload) == wire
            for reader in (REF, PORT):
                assert open_[reader].open(wire, len(prefix), pn - 1, short_header=short) == (
                    pn, payload)
            if short and generation == 0:
                for p in seal.values():
                    p.initiate_key_update()


def _seeded(monkeypatch, tls_module, seed):
    """Draws `os.urandom` and the X25519 key of `tls_module` from `seed`."""
    import os

    from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey

    rng = random.Random(seed)
    draw = lambda n: bytes(rng.randrange(256) for _ in range(n))  # noqa: E731
    monkeypatch.setattr(os, "urandom", draw)
    monkeypatch.setattr(tls_module, "X25519PrivateKey", SimpleNamespace(
        generate=lambda: X25519PrivateKey.from_private_bytes(draw(32))))


def test_client_initial_is_byte_equal(monkeypatch):
    """A client's first datagram (an Initial carrying the TLS ClientHello with
    ALPN, SNI and transport parameters, padded and protected), with the
    randomness of both packages drawn from one seed."""
    wires = []
    for name in BOTH:
        q = _quic(name)
        _seeded(monkeypatch, q.tls, 21)
        conn = q.connection.QuicConnection(is_client=True, alpn=["moql/1", "qt"],
                                           server_name="relay.example")
        wires.append(conn.datagrams_to_send(1000.0))
        monkeypatch.undo()
    assert wires[1] == wires[0]
    assert len(wires[0]) == 1 and len(wires[0][0]) >= 1200


def test_certificates_load_across_packages(tmp_path):
    """A pair persisted by one package's `load_or_create_self_signed` is what
    the other loads from the same directory."""
    ref, port = _quic(REF).tls, _quic(PORT).tls
    made = port.load_or_create_self_signed(str(tmp_path / "a"))
    assert ref.load_or_create_self_signed(str(tmp_path / "a")) == made
    made = ref.load_or_create_self_signed(str(tmp_path / "b"))
    assert port.load_or_create_self_signed(str(tmp_path / "b")) == made


def test_load_ca_bundle_skips_bad_roots_without_warnings():
    """`tests/test_quic.py::test_load_ca_bundle_skips_bad_roots_without_warnings`
    on the port."""
    import warnings

    from cryptography import x509 as cx509
    from cryptography.hazmat.primitives.serialization import Encoding

    tls = _quic(PORT).tls
    cert_der, _key = tls.generate_self_signed()
    good_pem = cx509.load_der_x509_certificate(cert_der).public_bytes(Encoding.PEM)
    garbage = b"-----BEGIN CERTIFICATE-----\nAAAAbm90IGEgY2VydA==\n-----END CERTIFICATE-----\n"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        roots = tls.load_ca_bundle(garbage + good_pem + garbage)
    assert len(roots) == 1 and roots[0].serial_number > 0
    assert caught == []


# ------------------------------------------------------------------ sessions


@pytest.fixture(scope="module")
def tls_pair():
    return _quic(PORT).tls.generate_self_signed()


def _pair(client_pkg, server_pkg, tls_pair, alpn=("qt",), **server_kw):
    cert, key = tls_pair
    accepted = []
    server = _quic(server_pkg).QuicServer(0, cert, key, list(alpn),
                                          on_connection=accepted.append, **server_kw)
    server.start()
    client = _quic(client_pkg).QuicClient("127.0.0.1", server.port, list(alpn))
    try:
        h = client.connect(timeout=20)
        deadline = time.time() + 10
        while not accepted and time.time() < deadline:
            time.sleep(0.02)
        assert accepted
        assert accepted[0].established.wait(10)
    except BaseException:
        client.close()
        server.close()
        raise
    return client, server, h, accepted[0]


def _collect(handle, timeout=30):
    buf, fin = b"", False
    deadline = time.time() + timeout
    while time.time() < deadline and not fin:
        ev = handle.recv_event(timeout=1)
        if ev is None or ev.stream_id == -1:
            continue
        buf += ev.data
        fin = fin or ev.fin
    return buf, fin


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, REF), (REF, PORT), (PORT, PORT)],
                         ids=["port_client-reference_server", "reference_client-port_server",
                              "port_pair"])
def test_handshake_streams_and_datagrams(client_pkg, server_pkg, tls_pair):
    """`tests/test_quic.py::test_quic_handshake_streams_datagrams` across
    the packages: 128 KiB on a client bidi stream, 128 KiB back on a server
    uni stream, one datagram."""
    before = _endpoint_threads()
    client, server, h, sh = _pair(client_pkg, server_pkg, tls_pair)
    try:
        assert h.alpn == "qt" and sh.alpn == "qt"
        payload = np.random.RandomState(2).randint(0, 256, 128 << 10, dtype=np.uint8).tobytes()
        sid = h.open_stream()
        h.send_stream(sid, payload, fin=True)
        assert _collect(sh) == (payload, True)
        sid2 = sh.open_stream(bidi=False)
        sh.send_stream(sid2, payload[::-1], fin=True)
        assert _collect(h) == (payload[::-1], True)
        h.send_datagram(b"dg-1")
        got, deadline = None, time.time() + 5
        while time.time() < deadline and got is None:
            ev = sh.recv_event(timeout=1)
            if ev is not None and ev.stream_id == -1:
                got = ev.data
        assert got == b"dg-1"
    finally:
        client.close()
        server.close()
    _assert_threads_end(before)


def test_alpn_mismatch_fails(tls_pair):
    port = _quic(PORT)
    before = _endpoint_threads()
    cert, key = tls_pair
    server = port.QuicServer(0, cert, key, ["srv-only"], on_connection=lambda h: None)
    server.start()
    client = port.QuicClient("127.0.0.1", server.port, ["cli-only"])
    try:
        with pytest.raises(ConnectionError):
            client.connect(timeout=6)
    finally:
        client.close()
        server.close()
    _assert_threads_end(before)


def test_loss_recovery(tls_pair):
    """20% of the client's datagrams dropped (seeded): PTO and packet-
    threshold retransmission still deliver the whole stream."""
    before = _endpoint_threads()
    client, server, h, sh = _pair(PORT, PORT, tls_pair)
    rng = random.Random(7)
    real_sendto = client._sendto

    def lossy_sendto(data, addr):
        if rng.random() >= 0.2:
            real_sendto(data, addr)

    client._sendto = lossy_sendto
    try:
        sid = h.open_stream()
        payload = b"loss-recovery " * 4096
        h.send_stream(sid, payload, fin=True)
        assert _collect(sh, timeout=60) == (payload, True)
    finally:
        client._sendto = real_sendto
        client.close()
        server.close()
    _assert_threads_end(before)


def test_key_update(tls_pair):
    """RFC 9001 §6: the client rotates its 1-RTT keys every ~12 packets;
    the data survives several generations, both ends converge on one phase
    and the connection still carries data both ways."""
    space_app = _quic(PORT).connection.SPACE_APP
    before = _endpoint_threads()
    client, server, h, sh = _pair(PORT, PORT, tls_pair)
    try:
        cprot = h._conn.spaces[space_app].protection
        sprot = sh._conn.spaces[space_app].protection
        cprot.KEY_UPDATE_AT = 12
        chunk = bytes(range(256)) * 16
        sid = h.open_stream()
        for _ in range(90):
            h.send_stream(sid, chunk)
        h.send_stream(sid, b"", fin=True)
        assert _collect(sh, timeout=60) == (chunk * 90, True)
        sid3 = h.open_stream()
        deadline = time.time() + 30
        while time.time() < deadline and (
                cprot.key_phase < 1 or sprot.key_phase != cprot.key_phase
                or sprot.rx_phase != cprot.key_phase):
            h.send_stream(sid3, b"tick")
            time.sleep(0.1)
        assert cprot.key_phase >= 1, "the client never initiated a key update"
        assert sprot.rx_phase == cprot.key_phase == sprot.key_phase
        sid2 = sh.open_stream(bidi=False)
        sh.send_stream(sid2, b"post-update", fin=True)
        assert _collect(h, timeout=30) == (b"post-update", True)
    finally:
        client.close()
        server.close()
    _assert_threads_end(before)


def test_hostile_datagrams_do_not_kill_endpoint(tls_pair):
    """Noise, truncated and AEAD-failing datagrams sprayed at both ends are
    dropped; data flows both ways afterwards."""
    before = _endpoint_threads()
    client, server, h, sh = _pair(PORT, PORT, tls_pair)
    rng = random.Random(99)
    try:
        sid = h.open_stream()
        h.send_stream(sid, b"before")
        server_scid, client_scid = sh._conn.scid, h._conn.scid
        atk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            for i in range(200):
                noise = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 80)))
                payload = [noise, bytes([0x40]) + server_scid + noise[:60] + bytes(4),
                           bytes([0x40]) + server_scid[: rng.randrange(0, 8)],
                           bytes([0xC0, 0xDE, 0xAD, 0xBE, 0xEF]) + bytes(20),
                           bytes([0xC0, 0, 0, 0, 1, 8]) + noise[:30]][i % 5]
                atk.sendto(payload, ("127.0.0.1", server.port))
            for _ in range(100):
                atk.sendto(bytes([0x40]) + client_scid + bytes(
                    rng.randrange(256) for _ in range(rng.randrange(4, 60))),
                    ("127.0.0.1", client.sock.getsockname()[1]))
        finally:
            atk.close()
        time.sleep(0.5)
        h.send_stream(sid, b"after", fin=True)
        assert _collect(sh) == (b"beforeafter", True)
        sid2 = sh.open_stream(bidi=False)
        sh.send_stream(sid2, b"still-alive", fin=True)
        assert _collect(h) == (b"still-alive", True)
    finally:
        client.close()
        server.close()
    _assert_threads_end(before)


@pytest.mark.parametrize("client_pkg", BOTH)
def test_handshake_through_retry(client_pkg, tls_pair):
    """A `require_retry` port server answers the first Initial with a
    Retry; the echoed token validates and the handshake completes (the
    reference's client as well as the port's)."""
    before = _endpoint_threads()
    client, server, h, sh = _pair(client_pkg, PORT, tls_pair, require_retry=True)
    try:
        assert client.conn._retry_source_cid is not None
        assert sh._conn.original_dcid == client.conn.original_dcid
        assert sh._conn._address_validated
        sid = h.open_stream()
        h.send_stream(sid, b"post-retry payload", fin=True)
        assert _collect(sh) == (b"post-retry payload", True)
    finally:
        client.close()
        server.close()
    _assert_threads_end(before)


def test_retry_token_is_address_bound_and_fresh(tls_pair):
    cert, key = tls_pair
    server = _quic(PORT).QuicServer(0, cert, key, ["qt"], on_connection=lambda h: None,
                                    require_retry=True)
    try:
        now = time.monotonic()
        tok = server._mint_token(("10.0.0.1", 4242), b"O" * 8, b"R" * 8, now)
        assert server._check_token(("10.0.0.1", 4242), tok, now) == (b"O" * 8, b"R" * 8)
        assert server._check_token(("10.0.0.2", 4242), tok, now) is None
        assert server._check_token(("10.0.0.1", 9), tok, now) is None
        assert server._check_token(("10.0.0.1", 4242), tok,
                                   now + server.TOKEN_LIFETIME + 1) is None
        bad = bytearray(tok)
        bad[3] ^= 1
        assert server._check_token(("10.0.0.1", 4242), bytes(bad), now) is None
    finally:
        server.close()


def test_forged_retry_is_ignored_by_client():
    port = _quic(PORT)
    pkt = port.pkt
    conn = port.connection.QuicConnection(is_client=True, alpn=["qt"])
    odcid = conn.original_dcid
    authentic = pkt.build_retry(pkt.QUIC_V1, dcid=conn.scid, scid=b"S" * 8, token=b"tok",
                                odcid=odcid)
    forged = bytearray(authentic)
    forged[-1] ^= 1
    conn.receive_datagram(bytes(forged), time.monotonic())
    assert conn._retry_source_cid is None and conn.dcid == odcid
    conn.receive_datagram(pkt.build_retry(pkt.QUIC_V1, dcid=conn.scid, scid=b"S" * 8,
                                          token=b"tok", odcid=b"X" * 8), time.monotonic())
    assert conn._retry_source_cid is None
    conn.receive_datagram(authentic, time.monotonic())
    assert conn._retry_source_cid == b"S" * 8
    assert conn.dcid == b"S" * 8 and conn._initial_token == b"tok"
    conn.receive_datagram(pkt.build_retry(pkt.QUIC_V1, dcid=conn.scid, scid=b"T" * 8,
                                          token=b"tok2", odcid=odcid), time.monotonic())
    assert conn._retry_source_cid == b"S" * 8


def test_verify_peer_rejects_self_signed(tls_pair):
    port = _quic(PORT)
    before = _endpoint_threads()
    cert, key = tls_pair
    server = port.QuicServer(0, cert, key, ["qt"], on_connection=lambda h: None)
    server.start()
    client = port.QuicClient("127.0.0.1", server.port, ["qt"], verify_peer=True)
    try:
        with pytest.raises(ConnectionError):
            client.connect(timeout=10)
    finally:
        client.close()
        server.close()
    _assert_threads_end(before)
