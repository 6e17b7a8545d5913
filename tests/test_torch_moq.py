"""The port's MoQ edge (`smelter_tpu_torch.io.moq`) against the reference's
(`smelter_tpu.io.moq`), on the CPU.

Tolerances:
  - the wire codecs are byte-equal on numpy-seeded inputs: control and
    object messages (`wire.py`), catalogs (`catalog.py`), init segments,
    fragments and the three containers (`container.py`); the parsers return
    equal fields on the same bytes, fed whole or in random pieces;
  - the timestamp aligner releases the same chunks at the same pts in both
    packages, on `tests/test_moq.py`'s scripts and on seeded ones, on a fake
    clock;
  - sessions across packages: the port's publisher (`QuicClient`,
    `MoqSession`, `BroadcastPublisher`) into the reference's `MoqServer` and
    the reverse, and the port's own pair, run
    `tests/test_moq.py::test_moq_session_publish_subscribe_loopback`
    (a wrong token refused; the catalog, and four objects with their
    keyframe flags); `test_moq_datagram_track_loopback` runs on the port's
    pair (>= 15 of 20 datagrams, as the reference's test asks);
  - the MoQ pipeline loopback (MP4 -> MoqClientOutput -> QUIC -> MoqServer ->
    MoqServerInput -> Pipeline -> MP4) runs through each package for the
    CMAF and the legacy container: every frame that both runs have, matched
    by the input frame it shows (`test_torch_rtp._mark_index`: a live
    receiver repeats or skips frames), is within a mean abs error of 1.0 u8
    per plane; each run meets the reference test's bounds (>= 40 frames,
    > 40000 audio samples, the 440 Hz tone within 15 Hz); the publisher
    starts once the receiver has subscribed to both tracks (ROADMAP Queue 3:
    what a publisher writes before is dropped);
  - `chip_smoke.moq_transport_phase` (phase 13a) runs here at 2 publishers
    for 1 s and passes its gates.

Every `MoqServer` gets a certificate directory of its own under the test's
`tmp_path`: the reference's default and test directories are fixed paths
that other workers write at the same time. Every endpoint is closed in
`finally`, and the session tests check that their threads end."""

from __future__ import annotations

import importlib
import random
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_pipeline import _decode_output
from tests.test_torch_rtp import _assert_frames_close, _make_marked_mp4, _mark_index

torch.set_num_threads(2)

REF, PORT = "smelter_tpu", "smelter_tpu_torch"
BOTH = (REF, PORT)
_THREADS = ("quic-endpoint", "moq-session", "moq-server-input", "moq-video:", "moq-audio:")


def _moq(name: str) -> SimpleNamespace:
    mod = lambda path: importlib.import_module(f"{name}.{path}")  # noqa: E731
    return SimpleNamespace(
        name=name, wire=mod("io.moq.wire"), catalog=mod("io.moq.catalog"),
        container=mod("io.moq.container"), aligner=mod("io.moq.aligner"),
        session=mod("io.moq.session"), server=mod("io.moq.server"),
        input=mod("io.moq.input"), output=mod("io.moq.output"), quic=mod("io.quic"))


def _threads():
    return {t for t in threading.enumerate() if t.name.startswith(_THREADS)}


def _assert_threads_end(before, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and _threads() - before:
        time.sleep(0.05)
    left = sorted(t.name for t in _threads() - before)
    assert not left, f"threads outlived their sessions and endpoints: {left}"


def _rbytes(rng, lo, hi):
    return rng.randint(0, 256, int(rng.randint(lo, hi)), dtype=np.uint8).tobytes()


def _rtext(rng, hi=24):
    return "".join(chr(int(c)) for c in rng.randint(32, 0x2FF, int(rng.randint(0, hi))))


# ----------------------------------------------------------------- wire.py


def _control_stream(wire, rng) -> bytes:
    out = b""
    for _ in range(int(rng.randint(1, 10))):
        kind = int(rng.randint(8))
        if kind == 0:
            out += wire.setup(_rtext(rng), _rtext(rng))
        elif kind == 1:
            out += wire.setup_ok()
        elif kind == 2:
            out += wire.setup_error(int(rng.randint(0, 2**16)), _rtext(rng))
        elif kind == 3:
            out += wire.announce(_rtext(rng))
        elif kind == 4:
            out += wire.unannounce(_rtext(rng))
        elif kind == 5:
            out += wire.subscribe(int(rng.randint(0, 2**20)), _rtext(rng))
        elif kind == 6:
            out += wire.subscribe_ok(int(rng.randint(0, 2**20)))
        else:
            out += wire.subscribe_error(int(rng.randint(0, 2**20)), int(rng.randint(0, 999)),
                                        _rtext(rng))
    return out


def _feed(parser, data, rng, first=0):
    """Every message a parser returns when `data` comes in random pieces, the
    first of them at least `first` bytes long."""
    out, pos = parser.feed(data[:first]) if first else [], first
    while pos < len(data):
        step = int(rng.randint(1, 40))
        out.extend(parser.feed(data[pos:pos + step]))
        pos += step
    return out


def test_control_messages_are_byte_equal():
    ref, port = _moq(REF).wire, _moq(PORT).wire
    assert port.ALPN == ref.ALPN
    for seed in range(40):
        data = _control_stream(ref, np.random.RandomState(seed))
        assert _control_stream(port, np.random.RandomState(seed)) == data
        pieces = random.Random(seed).randrange(2**31)
        got = [vars(m) for m in _feed(port.ControlParser(), data, np.random.RandomState(pieces))]
        want = [vars(m) for m in _feed(ref.ControlParser(), data, np.random.RandomState(pieces))]
        assert got == want and got


def test_group_and_object_messages_are_byte_equal():
    ref, port = _moq(REF).wire, _moq(PORT).wire
    rng = np.random.RandomState(3)
    for _ in range(30):
        sid, seq = int(rng.randint(0, 2**20)), int(rng.randint(0, 2**30))
        objects = [(int(rng.randint(0, 2**40)), bool(rng.randint(2)), _rbytes(rng, 0, 3000))
                   for _ in range(int(rng.randint(1, 8)))]
        data = ref.group_header(sid, seq) + b"".join(ref.frame(*o) for o in objects)
        assert port.group_header(sid, seq) + b"".join(port.frame(*o) for o in objects) == data
        # the header comes whole: both packages misparse a group whose
        # header is split between two reads (ROADMAP Queue 3)
        cut, header = int(rng.randint(2**31)), len(ref.group_header(sid, seq))
        parsers = [port.GroupParser(), ref.GroupParser()]
        got, want = (_feed(p, data, np.random.RandomState(cut), header) for p in parsers)
        assert [vars(f) for f in got] == [vars(f) for f in want]
        assert [(f.timestamp_us, f.keyframe, f.payload) for f in got] == objects
        assert (parsers[0].subscribe_id, parsers[0].group_seq) == (sid, seq)
        split = [_feed(p(), data, np.random.RandomState(cut)) for p in (port.GroupParser,
                                                                     ref.GroupParser)]
        assert [vars(f) for f in split[0]] == [vars(f) for f in split[1]]
        dgram = ref.object_datagram(sid, seq, *objects[0])
        assert port.object_datagram(sid, seq, *objects[0]) == dgram
        for blob in (dgram, dgram[:3], _rbytes(rng, 0, 20)):
            a, b = ref.parse_object_datagram(blob), port.parse_object_datagram(blob)
            assert (a is None) == (b is None)
            if a is not None:
                assert (a[0], a[1], vars(a[2])) == (b[0], b[1], vars(b[2]))


# -------------------------------------------------------------- catalog.py


def _entry(catalog, rng, name, video):
    return catalog.TrackEntry(
        name=name, codec=str(rng.choice(["h264", "av1", "vp9"] if video else ["opus", "aac"])),
        container=str(rng.choice(["legacy", "loc", "cmaf"])),
        description=_rbytes(rng, 0, 40) if rng.randint(2) else None,
        init_segment=_rbytes(rng, 0, 200) if rng.randint(2) else None,
        timescale=int(rng.choice([90000, 48000, 1000])),
        width=int(rng.randint(0, 4000)) if video else None,
        height=int(rng.randint(0, 3000)) if video else None,
        sample_rate=None if video else int(rng.choice([44100, 48000])),
        channels=None if video else int(rng.randint(1, 3)))


def _catalog(catalog, seed):
    rng = np.random.RandomState(seed)
    cat = catalog.Catalog()
    for k in range(int(rng.randint(0, 3))):
        cat.video[f"video{k}"] = _entry(catalog, rng, f"video{k}", True)
    for k in range(int(rng.randint(0, 3))):
        cat.audio[f"audio{k}"] = _entry(catalog, rng, f"audio{k}", False)
    return cat


def test_catalogs_are_byte_equal():
    ref, port = _moq(REF).catalog, _moq(PORT).catalog
    assert (port.CATALOG_TRACK, port.VIDEO_TRACK, port.AUDIO_TRACK, port.VIDEO_TIMESCALE) == (
        ref.CATALOG_TRACK, ref.VIDEO_TRACK, ref.AUDIO_TRACK, ref.VIDEO_TIMESCALE)
    for seed in range(40):
        data = _catalog(ref, seed).to_bytes()
        assert _catalog(port, seed).to_bytes() == data
        got, want = port.Catalog.from_bytes(data), ref.Catalog.from_bytes(data)
        for pick in ("first_video", "first_audio"):
            a, b = getattr(want, pick)(), getattr(got, pick)()
            assert (a is None and b is None) or vars(a) == vars(b)
        assert {k: vars(v) for k, v in got.video.items()} == {
            k: vars(v) for k, v in want.video.items()}


# ------------------------------------------------------------ container.py


INIT_CASES = [
    (True, "h264", b"\x01B\xe0\x1f\xff\xe1\x00\x02\x11\x22\x01\x00\x02\x33\x44"),
    (True, "av1", bytes([0x0A, 0x03, 0x01, 0x02, 0x03])),
    (True, "vp9", b""),
    (True, "vp8", b""),
    (False, "aac", b"\x11\x90"),
    (False, "opus", b"OpusHead\x01\x02\x38\x01\x80\xbb\x00\x00\x00\x00\x00"),
]


@pytest.mark.parametrize("is_video,codec,desc", INIT_CASES, ids=[c[1] for c in INIT_CASES])
def test_init_segments_are_byte_equal(is_video, codec, desc):
    ref, port = _moq(REF).container, _moq(PORT).container
    rng = np.random.RandomState(len(codec))
    for _ in range(5):
        if is_video:
            args = (True, codec, 90000, desc, int(rng.randint(16, 4000)), int(rng.randint(16, 3000)))
            kw = {}
        else:
            args = (False, codec, int(rng.choice([44100, 48000])), desc)
            kw = dict(sample_rate=args[2], channels=int(rng.randint(1, 3)))
        init = ref.build_init_segment(*args, **kw)
        assert port.build_init_segment(*args, **kw) == init
        assert port.parse_init_segment(init) == ref.parse_init_segment(init)


@pytest.mark.parametrize("kind", ["cmaf", "legacy", "loc"])
def test_containers_are_byte_equal(kind):
    ref, port = _moq(REF).container, _moq(PORT).container
    rng = np.random.RandomState(7)
    writers = [ref.ContainerWriter(kind, 90000), port.ContainerWriter(kind, 90000)]
    readers = [ref.ContainerReader(kind, 90000), port.ContainerReader(kind, 90000)]
    for _ in range(60):
        ts, key, payload = int(rng.randint(0, 2**36)), bool(rng.randint(2)), _rbytes(rng, 0, 5000)
        packed = writers[0].pack(ts, payload, key)
        assert writers[1].pack(ts, payload, key) == packed
        frame_ts = int(rng.randint(0, 2**36))
        assert readers[1].unpack(frame_ts, packed) == readers[0].unpack(frame_ts, packed)
        seq = int(rng.randint(0, 2**31))
        fragment = ref.build_fragment(seq, ts, payload, key)
        assert port.build_fragment(seq, ts, payload, key) == fragment
        assert port.parse_fragment(fragment) == ref.parse_fragment(fragment)
        junk = _rbytes(rng, 0, 64)
        assert port.parse_fragment(junk) == ref.parse_fragment(junk)


# -------------------------------------------------------------- aligner.py


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _aligner_script(pkg, script, seed):
    """The released (pts, data) and lock states of a script of
    `tests/test_moq.py` or of a numpy-seeded one, on a fake clock."""
    aligner = pkg.aligner
    clock = _Clock()
    shared = aligner.EpochShared(clock=clock)
    out = []

    def log(chunks):
        out.append([(round(c.pts, 9), c.data) for c in chunks])

    if script == "anchor":
        v, a = (aligner.TimestampAligner(shared, k, False) for k in ("video", "audio"))
        log(v.on_chunk(True, 1000.0, b"v0"))
        clock.t += 0.005
        log(a.on_chunk(True, 1000.02, b"a0"))
        clock.t += 1 / 30
        log(v.on_chunk(False, 1000.0 + 1 / 30, b"v1"))
    elif script == "live_edge":
        v, a = (aligner.TimestampAligner(shared, k, False) for k in ("video", "audio"))
        log(v.on_chunk(True, 50.0, b"v0"))
        clock.t += 0.001
        log(a.on_chunk(True, 5000.0, b"a0"))
        for i in range(1, 7):
            clock.t += 1 / 30
            log(v.on_chunk(False, 50.0 + i / 30.0, b"v%d" % i))
    elif script == "discontinuity":
        v = aligner.TimestampAligner(shared, "video", True)
        for raw in (10.0, 10.033, 110.0):
            log(v.on_chunk(raw == 10.0 or raw == 110.0, raw, b"%f" % raw))
            clock.t += 1 / 30
        log(v.flush())
    else:  # seeded: two tracks, jittered arrival, an epoch jump, a flush
        rng = np.random.RandomState(seed)
        tracks = [aligner.TimestampAligner(shared, k, False) for k in ("video", "audio")]
        base = [float(rng.uniform(0, 1e4)), float(rng.uniform(0, 1e4))]
        if rng.randint(2):
            base[1] = base[0] + float(rng.uniform(0, 1))
        for i in range(80):
            k = int(rng.randint(2))
            clock.t += float(rng.uniform(0, 0.05))
            raw = base[k] + i / 30.0 + (50.0 if i == 60 and k == 0 else 0.0)
            log(tracks[k].on_chunk(i % 10 == 0, raw, b"%d:%d" % (k, i)))
        log(tracks[0].flush() + tracks[1].flush())
        out.append(shared.mode())
    return out


@pytest.mark.parametrize("script,seed", [("anchor", 0), ("live_edge", 0), ("discontinuity", 0)]
                         + [("seeded", s) for s in range(8)])
def test_aligner_releases_what_the_reference_releases(script, seed):
    got = _aligner_script(_moq(PORT), script, seed)
    assert got == _aligner_script(_moq(REF), script, seed)
    if script == "anchor":
        assert [d for _, d in got[2]] == [b"v0", b"v1"]


# ---------------------------------------------------------------- sessions


class _FakeInput:
    """A registered input of a MoqServerState that only takes the session."""

    def __init__(self, token):
        self.options = SimpleNamespace(auth_token=token)
        self.session = None
        self.got = threading.Event()

    def attach_session(self, session):
        self.session = session
        self.got.set()
        return True


def _wait_producer(publisher, track):
    deadline = time.time() + 5
    while publisher.producer(track) is None and time.time() < deadline:
        time.sleep(0.05)
    assert publisher.producer(track) is not None
    return publisher.producer(track)


@pytest.mark.parametrize("client_pkg,server_pkg", [(PORT, REF), (REF, PORT), (PORT, PORT)],
                         ids=["port_publisher-reference_server",
                              "reference_publisher-port_server", "port_pair"])
def test_session_publish_subscribe_loopback(client_pkg, server_pkg, tmp_path):
    """`tests/test_moq.py::test_moq_session_publish_subscribe_loopback`
    across the packages."""
    cli, srv = _moq(client_pkg), _moq(server_pkg)
    before = _threads()
    state = srv.server.MoqServerState()
    sink = _FakeInput("tok")
    state.register("cam1", sink)
    server = srv.server.MoqServer(0, state, cert_dir=str(tmp_path / "certs"))
    clients = []
    try:
        c_bad = cli.quic.QuicClient("127.0.0.1", server.port, [cli.wire.ALPN])
        clients.append(c_bad)
        s_bad = cli.session.MoqSession(c_bad.connect(timeout=15), is_quic_client=True)
        s_bad.start_client("cam1", "wrong")
        with pytest.raises((ConnectionError, TimeoutError)):
            s_bad.wait_setup(timeout=8)
        s_bad.close()
        client = cli.quic.QuicClient("127.0.0.1", server.port, [cli.wire.ALPN])
        clients.append(client)
        session = cli.session.MoqSession(client.connect(timeout=15), is_quic_client=True)
        publisher = cli.output.BroadcastPublisher(session, "bcast")
        session.start_client("cam1", "tok")
        session.wait_setup(timeout=8)
        cat = cli.catalog.Catalog()
        cat.video["video0"] = cli.catalog.TrackEntry(name="video0", codec="h264",
                                                      container="loc", width=64, height=64)
        publisher.set_catalog(cat)
        assert sink.got.wait(10), "the server session never attached"
        srv_session = sink.session
        assert srv_session.next_announce(timeout=10) == "bcast"
        first = srv_session.subscribe_track(srv.catalog.CATALOG_TRACK).read(timeout=10)
        assert srv.catalog.Catalog.from_bytes(first.payload).first_video().codec == "h264"
        video = srv_session.subscribe_track("video0")
        prod = _wait_producer(publisher, "video0")
        for g in range(2):
            prod.write(g * 1000, True, b"kf%d" % g, new_group=True)
            prod.write(g * 1000 + 33, False, b"df%d" % g, new_group=False)
        prod.finish_group()
        got, deadline = [], time.time() + 10
        while len(got) < 4 and time.time() < deadline:
            tf = video.read(timeout=1)
            if tf is not None:
                got.append(tf)
        assert sorted((t.group_seq, t.timestamp_us, t.keyframe, t.payload) for t in got) == [
            (0, 0, True, b"kf0"), (0, 33, False, b"df0"), (1, 1000, True, b"kf1"),
            (1, 1033, False, b"df1")]
        session.close()
        srv_session.close()
    finally:
        for c in clients:
            c.close()
        server.close()
    _assert_threads_end(before)


def test_datagram_track_loopback(tmp_path):
    """`tests/test_moq.py::test_moq_datagram_track_loopback` on the port:
    an oversized object asks for the stream fallback, sub-MTU objects ride
    datagrams."""
    port = _moq(PORT)
    before = _threads()
    state = port.server.MoqServerState()
    sink = _FakeInput("")
    state.register("dgcam", sink)
    server = port.server.MoqServer(0, state, cert_dir=str(tmp_path / "certs"))
    client = port.quic.QuicClient("127.0.0.1", server.port, [port.wire.ALPN])
    try:
        session = port.session.MoqSession(client.connect(timeout=15), is_quic_client=True)
        publisher = port.output.BroadcastPublisher(session, "bcast")
        session.start_client("dgcam", "")
        session.wait_setup(timeout=8)
        cat = port.catalog.Catalog()
        cat.audio["audio0"] = port.catalog.TrackEntry(name="audio0", codec="opus",
                                                       container="loc")
        publisher.set_catalog(cat)
        assert sink.got.wait(10)
        srv_session = sink.session
        assert srv_session.next_announce(timeout=10) == "bcast"
        audio = srv_session.subscribe_track("audio0")
        prod = _wait_producer(publisher, "audio0")
        assert not prod.write_datagram(0, False, b"x" * 4000)
        sent = []
        for i in range(20):
            payload = b"opus-%03d" % i
            assert prod.write_datagram(i * 20000, i == 0, payload, new_group=(i % 10 == 0))
            sent.append(payload)
            time.sleep(0.005)
        got, deadline = [], time.time() + 10
        while len(got) < 20 and time.time() < deadline:
            tf = audio.read(timeout=1)
            if tf is not None:
                got.append(tf)
        assert len(got) >= 15, len(got)
        assert {t.payload for t in got} <= set(sent)
        first = min(got, key=lambda t: t.timestamp_us)
        assert first.keyframe or first.timestamp_us > 0
        session.close()
        srv_session.close()
    finally:
        client.close()
        server.close()
    _assert_threads_end(before)


def test_client_output_verify_tls_rejects_self_signed(tmp_path):
    """`tests/test_quic.py::test_moq_client_output_verify_tls_rejects_self_signed`
    on the port."""
    port = _moq(PORT)
    before = _threads()
    server = port.server.MoqServer(0, port.server.MoqServerState(),
                                   cert_dir=str(tmp_path / "certs"))
    try:
        with pytest.raises((ConnectionError, OSError)):
            port.output.MoqClientOutput(f"moql://127.0.0.1:{server.port}/in?token=t", "bcast",
                                        verify_tls=True)
    finally:
        server.close()
    _assert_threads_end(before)


def test_client_input_wires_tls_verification(monkeypatch):
    """`tests/test_quic.py::test_moq_client_input_wires_tls_verification` on
    the port: `MoqClientInput` hands `verify_tls` to its `QuicClient`."""
    import smelter_tpu_torch.io.quic as quic_mod
    from smelter_tpu_torch.io.moq.input import MoqClientInput, MoqClientInputOptions

    seen = {}

    class _Recorder:
        def __init__(self, host, port, alpn, server_name=None, verify_peer=False):
            seen["verify_peer"] = verify_peer
            raise ConnectionError("stop here")

    monkeypatch.setattr(quic_mod, "QuicClient", _Recorder)
    src = MoqClientInput(MoqClientInputOptions(endpoint_url="moql://127.0.0.1:9/x",
                                               broadcast_path="b", verify_tls=True))
    with pytest.raises(ConnectionError):
        src.start(None)
    assert seen["verify_peer"] is True


# ------------------------------------------------------ pipeline loopback


def _wait_done(pipe, output_id: str, timeout: float) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if ("OUTPUT_DONE", output_id) in {(e.kind, e.entity_id) for e in pipe.events.history()}:
            return True
        time.sleep(0.2)
    return False


def _moq_loopback(name: str, container: str, src: str, out_path: str, cert_dir: str):
    """`tests/test_moq.py::test_moq_pipeline_loopback` through one package
    (the port's pipelines on the CPU): the MP4 published by a
    MoqClientOutput into a MoqServerInput and recorded into an MP4, the
    publisher started once the receiver has subscribed to its tracks."""
    m = _moq(name)
    pl = importlib.import_module(f"{name}.pipeline")
    types = importlib.import_module(f"{name}.core.types")
    comp = importlib.import_module(f"{name}.scene.components")
    mixer = importlib.import_module(f"{name}.audio.mixer")
    out_mod = importlib.import_module(f"{name}.pipeline.output")
    kw = {"device": "cpu"} if name == PORT else {}

    def pipeline():
        return pl.Pipeline(pl.PipelineOptions(output_framerate=types.Framerate(30),
                                              ahead_of_time_processing=True,
                                              never_drop_output_frames=True), **kw)

    def outputs(input_id):
        return dict(
            video=pl.OutputVideoOptions(
                resolution=types.Resolution(320, 240),
                encoder=out_mod.VideoEncoderOptions(codec="h264", preset="ultrafast"),
                initial_root=comp.Rescaler(child=comp.InputStream(input_id=input_id)),
                end_condition=pl.EndCondition(all_inputs=True)),
            audio=pl.OutputAudioOptions(
                encoder=out_mod.AudioEncoderOptions(codec="aac"),
                initial_mixer_config=mixer.AudioMixerConfig(
                    inputs=[mixer.AudioMixerInputConfig(input_id)]),
                end_condition=pl.EndCondition(all_inputs=True)))

    rx = pipeline()
    state = m.server.MoqServerState()
    source = m.input.MoqServerInput(m.input.MoqServerInputOptions(auth_token="s3cret"))
    rx.register_input("in", source, pl.RegisterInputOptions(required=True, offset=0.0))
    state.register("in", source)
    server = m.server.MoqServer(0, state, cert_dir=cert_dir)
    tx = None
    try:
        rx.register_output("out", pl.Mp4OutputSink(out_path), **outputs("in"))
        rx.start()
        tx = pipeline()
        tx.register_input("a", pl.Mp4Input(pl.Mp4InputOptions(path=src)),
                          pl.RegisterInputOptions(required=True, offset=0.0))
        sink = m.output.MoqClientOutput(f"moql://127.0.0.1:{server.port}/in?token=s3cret",
                                        "bcast", container=container)
        tx.register_output("moq", sink, **outputs("a"))
        # the receiver subscribes to both tracks before the first packet:
        # a publisher drops what it writes before a track's subscription,
        # and the clip has one keyframe (ROADMAP Queue 3)
        deadline = time.time() + 30
        while time.time() < deadline and None in (sink.publisher.producer("video0"),
                                                  sink.publisher.producer("audio0")):
            time.sleep(0.02)
        tx.start()
        assert _wait_done(tx, "moq", 180), f"{name}: tx OUTPUT_DONE not observed"
        assert _wait_done(rx, "out", 180), f"{name}: rx OUTPUT_DONE not observed"
    finally:
        if tx is not None:
            tx.close()
        rx.close()
        server.close()
    return _decode_output(out_path)[:2]


@pytest.mark.parametrize("container", ["cmaf", "legacy"])
def test_moq_pipeline_loopback_matches_the_reference(tmp_path, container):
    src = str(tmp_path / "src.mp4")
    _make_marked_mp4(src, "red", 440.0)
    before = _threads()
    runs = {name: _moq_loopback(name, container, src, str(tmp_path / f"{name}.mp4"),
                                str(tmp_path / f"certs_{name}")) for name in BOTH}
    for name, (frames, audio) in runs.items():
        assert len(frames) >= 40, (name, len(frames))
        assert audio.shape[0] > 40000, name
        assert float(np.mean([float(f[2].mean()) for f in frames])) > 170, name
        mono = audio.mean(axis=1)
        mono = mono[24000:72000] if mono.shape[0] > 72000 else mono
        spec = np.abs(np.fft.rfft(mono * np.hanning(len(mono))))
        peak = np.fft.rfftfreq(len(mono), 1.0 / 48000)[int(np.argmax(spec))]
        assert abs(peak - 440.0) < 15.0, (name, peak)
    _assert_frames_close(runs[REF][0], runs[PORT][0], _mark_index, 30)
    _assert_threads_end(before, timeout=15.0)


# ----------------------------------------------------------- chip_smoke 13a


def test_chip_smoke_moq_transport_phase_at_a_small_size():
    """Phase 13a's logic at 2 publishers for 1 s (its gates pass: a wrong
    token refused, every object byte-equal and in order by its deadline,
    every thread ended), and an ungated capacity run at 3."""
    import chip_smoke

    out = chip_smoke.moq_transport_phase("[cpu]", n=2, seconds=1.0)
    assert out["delivered"] == 1.0 and out["objects"] == 60 and out["threads_left"] == []
    assert out["wrong_token"] and out["offered_mb_per_s"] == pytest.approx(1.36)
    assert out["latency_p50_ms"] > 0 and out["handshake_max_ms"] > 0
    out = chip_smoke.moq_transport_phase("[cpu]", n=3, seconds=1.0, deadline_s=5.0, gated=False)
    assert out["wrong_token"] is None and out["objects"] == 90 and 0.0 <= out["delivered"] <= 1.0
