"""The port's crypto sidecar (``bftkv_tpu_torch/cmd/verify_sidecar.py``) and
its tenant client (``crypto/remote_verify.py``), held against the
reference's (``bftkv_tpu/cmd/verify_sidecar.py``, ``crypto/remote_verify.py``).

- The encoders agree byte for byte, and the same request frames get
  byte-identical response frames from the port's ``SidecarService`` on the
  ``cpu`` (its plain kernels) and from the reference's.
- Each package's client works against the other's server.
- The reference's ``tests/test_sidecar.py`` and
  ``tests/test_sidecar_service.py`` cases, against the port: malformed
  frames, SHED, BAD_HANDLE and re-registration, REFUSED on plain TCP,
  HMAC, a dishonest service caught by the spot check and the self check,
  the breaker; the kill-mid-traffic case on the reference's loopback
  cluster, as ``tests/test_torch_dispatch.py`` runs it.
"""

from __future__ import annotations

import json
import os
import random
import shutil
import socket
import stat
import struct
import tempfile
import threading
import time
import urllib.request

import pytest

from bftkv_tpu.cmd import verify_sidecar as ref_vs
from bftkv_tpu.crypto import remote_verify as ref_rv
from bftkv_tpu.crypto import rsa as ref_rsa
from bftkv_tpu.metrics import registry as ref_metrics
from bftkv_tpu_torch.admission import AdmissionQueue
from bftkv_tpu_torch.cmd import verify_sidecar as vs
from bftkv_tpu_torch.crypto import ecdsa, rsa
from bftkv_tpu_torch.crypto.remote_verify import (
    RemoteModexpDomain,
    RemoteSignerDomain,
    RemoteVerifierDomain,
    SidecarChannel,
)
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import dispatch
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def keys():
    return [rsa.generate(1024, seed=s) for s in (41, 42)]


def _ref_key(k):
    return ref_rsa.PrivateKey(n=k.n, e=k.e, d=k.d, p=k.p, q=k.q)


@pytest.fixture
def sock_dir():
    """A short directory for Unix sockets (their paths are bounded)."""
    d = tempfile.mkdtemp(prefix="bsc")
    yield d
    shutil.rmtree(d, ignore_errors=True)


def _stop(srv):
    srv.service.stop()
    srv.shutdown()
    srv.server_close()


@pytest.fixture
def port_sidecar(sock_dir):
    addr = f"unix:{sock_dir}/port.sock"
    srv, _t = vs.serve(addr, device="cpu")
    yield addr, srv
    _stop(srv)


@pytest.fixture
def plain_kernels(monkeypatch):
    """Un-pins the CPU (a positive crossover): the port's sidecar then
    answers from its plain kernels, not from host ``pow``."""

    def apply(srv):
        monkeypatch.setenv("BFTKV_DISPATCH_CROSSOVER", "1")
        srv.service.recalibrate()

    yield apply
    monkeypatch.delenv("BFTKV_DISPATCH_CROSSOVER", raising=False)
    dispatch.calibration(force=True, device="cpu")


@pytest.fixture
def ref_sidecar(sock_dir):
    addr = f"unix:{sock_dir}/ref.sock"
    srv, _t = ref_vs.serve(addr)
    yield addr, srv
    _stop(srv)


def _verify_items(keys, n: int = 20, seed: int = 43):
    """Seeded verify items over both keys: some forged and, from 6 items
    on, one with s >= n, one with an even modulus, one with e = 3; plus
    the host verdicts."""
    rng = random.Random(seed)
    items = []
    for i in range(n):
        key = keys[i % 2]
        msg = b"sidecar-%d-%d" % (seed, i)
        sig = rsa.sign(msg, key)
        if rng.random() < 0.25:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        items.append((msg, sig, key.public))
    if n >= 6:
        m, _s, pub = items[3]
        items[3] = (m, (pub.n + 5).to_bytes(129, "big"), pub)
        m, s, pub = items[4]
        items[4] = (m, s, rsa.PublicKey(n=pub.n * 2))
        m, s, pub = items[5]
        items[5] = (m, s, rsa.PublicKey(n=pub.n, e=3))
    want = []
    for m, s, pub in items:
        try:
            want.append(rsa.verify_host(m, s, pub))
        except (ValueError, ZeroDivisionError):
            want.append(False)
    return items, want


def _as_ref(items):
    return [(m, s, ref_rsa.PublicKey(n=k.n, e=k.e)) for m, s, k in items]


def _modexp_items(seed: int = 44):
    rng = random.Random(seed)
    out = [(rng.getrandbits(300), rng.getrandbits(256), rng.getrandbits(256) | 1 | (1 << 255))
           for _ in range(16)]
    return out + [(5, 3, 1), (7, 2, 10), (0, 0, 13)]


def _frame(body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + body


def _recv(s: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        try:
            part = s.recv(n - len(buf))
        except ConnectionResetError:  # closed with our bytes unread
            return None
        if not part:
            return None
        buf += part
    return buf


def _exchange(addr: str, bodies: list) -> list:
    """Each request body as one frame on one connection; each response
    frame's raw bytes (length prefix included), None once the server
    dropped the connection."""
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(60)
    s.connect(addr[len("unix:"):])
    out = []
    try:
        for body in bodies:
            s.sendall(_frame(body))
            hdr = _recv(s, 4)
            if hdr is None:
                out.append(None)
                break
            (ln,) = struct.unpack(">I", hdr)
            out.append(hdr + _recv(s, ln))
    finally:
        s.close()
    return out


# -- codecs ------------------------------------------------------------------------


def test_encoders_agree_byte_for_byte_with_the_references(keys):
    items, _ = _verify_items(keys)
    assert vs.encode_request(items) == ref_vs.encode_request(_as_ref(items))
    pairs = [(1, b"a"), (2, b""), (7, b"x" * 300)]
    assert vs.encode_sign_request(pairs) == ref_vs.encode_sign_request(pairs)
    assert vs.encode_register_request(keys) == ref_vs.encode_register_request(
        [_ref_key(k) for k in keys])
    mx = _modexp_items()
    assert vs.encode_modexp_request(mx) == ref_vs.encode_modexp_request(mx)
    for op in (vs.OP_VERIFY, vs.OP_SIGN, vs.OP_REGISTER, vs.OP_MODEXP, vs.OP_STATS):
        assert vs.encode_op(op, b"p") == ref_vs.encode_op(op, b"p")
    secret, body = b"s" * 32, b"request body"
    assert vs.request_tag(secret, body) == ref_vs.request_tag(secret, body)
    assert vs.response_tag(secret, body, b"out") == ref_vs.response_tag(secret, body, b"out")
    # Decoders read the other package's frames.
    dec = vs.decode_request(ref_vs.encode_request(_as_ref(items)))
    assert [(m, s, k.n, k.e) for m, s, k in dec] == [(m, s, k.n, k.e) for m, s, k in items]
    assert vs.decode_sign_request(ref_vs.encode_sign_request(pairs)) == pairs
    assert vs.decode_modexp_request(ref_vs.encode_modexp_request(mx)) == mx
    reg = vs.decode_register_request(ref_vs.encode_register_request([_ref_key(keys[0])]))
    assert (reg[0].n, reg[0].d, reg[0].p) == (keys[0].n, keys[0].d, keys[0].p)


def test_keywrap_crosses_between_the_packages(keys):
    secret = b"w" * 32
    payload = vs.encode_register_request(keys)
    assert ref_vs.unwrap_keys(secret, vs.wrap_keys(secret, payload)) == payload
    assert vs.unwrap_keys(secret, ref_vs.wrap_keys(secret, payload)) == payload
    sealed = SidecarChannel("127.0.0.1:1", secret=secret).seal_keys(payload)
    for priv in (keys[0].d, keys[0].p, keys[0].q):
        blob = priv.to_bytes((priv.bit_length() + 7) // 8, "big")
        assert blob in payload and blob not in sealed
    with pytest.raises(Exception):
        vs.unwrap_keys(secret, sealed[:-1] + bytes([sealed[-1] ^ 1]))
    with pytest.raises(Exception):
        vs.unwrap_keys(b"x" * 32, sealed)
    assert SidecarChannel("unix:/tmp/x").seal_keys(payload) == payload


def test_codecs_roundtrip_and_refuse_hostile_bytes(keys):
    pairs = [(7, b"msg-a"), (9, b"")]
    assert vs.decode_sign_request(vs.encode_sign_request(pairs)) == pairs
    (k,) = vs.decode_register_request(vs.encode_register_request([keys[0]]))
    assert (k.n, k.d) == (keys[0].n, keys[0].d)
    mx = [(123, 456, 789), (0, 0, 5)]
    assert vs.decode_modexp_request(vs.encode_modexp_request(mx)) == mx
    for bad in (b"\xff\xff\xff\xff garbage", b"\x00\x00\x00\x01\x00\x00\x00\x00\x00\x00\x00\x09ab"):
        with pytest.raises(Exception):
            vs.decode_register_request(bad)
        with pytest.raises(Exception):
            vs.decode_request(bad)
    with pytest.raises(ValueError):
        vs.decode_modexp_request(vs.encode_modexp_request([(1, 1, 0)]))


# -- the same frames, the same answers --------------------------------------------


def _frames(keys):
    items, _ = _verify_items(keys)
    msgs = [b"share-%d" % i for i in range(16)]
    return [
        ref_vs.encode_request(_as_ref(items)),                               # v1 verify
        vs.encode_op(vs.OP_VERIFY, vs.encode_request(items)),                 # v2 verify
        vs.encode_op(vs.OP_REGISTER, vs.encode_register_request(keys)),       # handles 1, 2
        vs.encode_op(vs.OP_SIGN, vs.encode_sign_request(
            [(1 + i % 2, m) for i, m in enumerate(msgs)])),
        vs.encode_op(vs.OP_SIGN, vs.encode_sign_request([(9, b"unknown handle")])),
        vs.encode_op(vs.OP_MODEXP, vs.encode_modexp_request(_modexp_items())),
        vs.encode_op(vs.OP_SIGN, b"\xff\xff\xff\xff junk"),                  # malformed: ERR
        vs.encode_op(vs.OP_MODEXP, b"\x00"),
        vs.encode_op(vs.OP_REGISTER, b"\x00\x00\x00\x01\x00"),
        vs.encode_op(9, b""),                                                 # unknown op
        struct.pack(">I", 3) + b"\xff garbage",                               # malformed v1
        vs.MAGIC,                                                             # magic alone: v1
        b"",
    ]


def test_response_frames_are_byte_identical_to_the_references(
        keys, port_sidecar, ref_sidecar, plain_kernels):
    port_addr, port_srv = port_sidecar
    ref_addr, _ref_srv = ref_sidecar
    plain_kernels(port_srv)
    frames = _frames(keys)
    metrics.reset()
    mine = _exchange(port_addr, frames)
    theirs = _exchange(ref_addr, frames)
    assert mine == theirs
    _items, want = _verify_items(keys)
    assert mine[0][4:] == bytes(want)
    assert mine[1][4:] == bytes([vs.ST_OK]) + bytes(want)
    assert mine[4][4:] == bytes([vs.ST_BAD_HANDLE])
    assert [f[4] for f in mine[6:10]] == [vs.ST_ERR] * 4
    assert mine[10][4:] == b"\x00" * 3 and mine[11][4:] == b"\x00" * 4 and mine[12] == b"\x00" * 4
    # The port answered from its plain kernels, not from host pow.
    snap = metrics.snapshot()
    assert snap["verify.device"] == 2 * sum(
        1 for m, s, k in _items if k.e == 65537 and k.n % 2 and int.from_bytes(s, "big") < k.n)
    assert snap["sign.device"] == 16 and snap["modexp.device"] == 16


def test_an_oversized_frame_drops_the_connection_on_both(port_sidecar, ref_sidecar):
    for addr, srv in (port_sidecar, ref_sidecar):
        srv.max_frame = 64
        assert _exchange(addr, [b"\x00" * 65]) == [None]


# -- each package's client against the other's server ----------------------------


def test_reference_clients_against_the_ports_server(keys, port_sidecar, plain_kernels):
    addr, srv = port_sidecar
    plain_kernels(srv)
    items, want = _verify_items(keys)
    rd = ref_rv.RemoteVerifierDomain(addr, spot_rate=1.0)
    assert list(rd.verify_batch(_as_ref(items))) == want
    sd = ref_rv.RemoteSignerDomain(addr)
    msgs = [(b"ref-client-%d" % i, _ref_key(keys[i % 2])) for i in range(16)]
    assert sd.sign_batch(msgs) == [rsa.sign(m, keys[i % 2]) for i, (m, _k) in enumerate(msgs)]
    mx = _modexp_items()
    assert ref_rv.RemoteModexpDomain(addr, spot_rate=1.0).powmod_batch(mx) == [pow(*it) for it in mx]
    snap = ref_metrics.snapshot()
    assert not any(snap.get(k) for k in (
        "verify.remote_fallback", "sign.remote_fallback", "modexp.remote_fallback"))


def test_the_ports_clients_against_the_reference_server(keys, ref_sidecar):
    addr, _srv = ref_sidecar
    items, want = _verify_items(keys)
    metrics.reset()
    assert list(RemoteVerifierDomain(addr, spot_rate=1.0).verify_batch(items)) == want
    msgs = [(b"port-client-%d" % i, keys[i % 2]) for i in range(6)]
    assert RemoteSignerDomain(addr).sign_batch(msgs) == [rsa.sign(m, k) for m, k in msgs]
    mx = _modexp_items()
    assert RemoteModexpDomain(addr, spot_rate=1.0).powmod_batch(mx) == [pow(*it) for it in mx]
    snap = metrics.snapshot()
    assert snap["verify.remote"] == len(items) and snap["sign.remote"] == 6
    assert snap["modexp.remote"] == len(mx)
    assert not any(snap.get(k) for k in (
        "verify.remote_fallback", "sign.remote_fallback", "modexp.remote_fallback"))


# -- the reference's cases, against the port --------------------------------------


def test_unix_socket_is_private_and_ec_items_stay_in_the_tenant(keys, port_sidecar, sock_dir):
    addr, _srv = port_sidecar
    assert stat.S_IMODE(os.stat(f"{sock_dir}/port.sock").st_mode) == 0o600
    ek = ecdsa.generate(seed=45)
    items, want = _verify_items(keys, n=6)
    items.append((b"ec", ecdsa.sign(b"ec", ek), ek.public))
    items.append((b"ec", ecdsa.sign(b"other", ek), ek.public))
    metrics.reset()
    assert list(RemoteVerifierDomain(addr).verify_batch(items)) == want + [True, False]
    assert metrics.snapshot()["sidecar.items{op=verify}"] == 6  # the EC items never crossed


def test_malformed_v1_frame_fails_closed():
    srv, _t = vs.serve("127.0.0.1:0", device="cpu")
    try:
        host, port = srv.server_address
        s = socket.create_connection((host, port), timeout=10)
        body = struct.pack(">I", 3) + b"\xff garbage"
        s.sendall(_frame(body))
        (ln,) = struct.unpack(">I", _recv(s, 4))
        assert ln == 3 and _recv(s, 3) == b"\x00\x00\x00"
        s.close()
    finally:
        _stop(srv)


def test_internal_error_falls_back_locally(keys, port_sidecar):
    """A dispatcher failure is an ERR, never "all invalid": the tenant
    verifies locally and benches the service."""
    addr, srv = port_sidecar

    def boom(items):
        raise RuntimeError("device lost")

    srv.dispatcher.verify = boom
    items, want = _verify_items(keys, n=4)
    rd = RemoteVerifierDomain(addr)
    metrics.reset()
    assert list(rd.verify_batch(items)) == want
    assert metrics.snapshot()["verify.remote_fallback"] == 4 and rd.channel.tripped()
    # A v1 frame gets the zero-length reply.
    assert _exchange(addr, [ref_vs.encode_request(_as_ref(items))]) == [b"\x00" * 4]


def test_admission_sheds_past_bounds(keys, sock_dir):
    addr = f"unix:{sock_dir}/shed.sock"
    srv, _t = vs.serve(addr, device="cpu", admission=AdmissionQueue(
        max_inflight=1, max_queue=0, max_wait=0.05, metric="sidecar.shed"))
    release = threading.Event()
    orig = srv.dispatcher.verify

    def slow(items):
        release.wait(5)
        return orig(items)

    srv.dispatcher.verify = slow
    try:
        metrics.reset()
        items, want = _verify_items(keys, n=1)
        r1 = RemoteVerifierDomain(addr, spot_rate=0.0)
        r2 = RemoteVerifierDomain(addr, spot_rate=0.0)
        out1 = []
        t = threading.Thread(target=lambda: out1.append(list(r1.verify_batch(items))))
        t.start()
        time.sleep(0.3)  # batch 1 holds the only service slot
        assert list(r2.verify_batch(items)) == want  # shed → local
        release.set()
        t.join(10)
        assert not t.is_alive() and out1 == [want]
        snap = metrics.snapshot()
        assert snap["verify.remote_shed"] >= 1 and snap["sidecar.shed{op=verify}"] >= 1
        assert srv.service.admission.shed >= 1 and not r2.channel.tripped()
    finally:
        release.set()
        _stop(srv)


def test_bad_handle_and_a_restart_re_register(keys, sock_dir):
    addr = f"unix:{sock_dir}/rereg.sock"
    srv, _t = vs.serve(addr, device="cpu")
    chan = SidecarChannel(addr, breaker_seconds=0.0)
    sd = RemoteSignerDomain(channel=chan)
    try:
        metrics.reset()
        msgs = [(b"rr-%d" % i, keys[i % 2]) for i in range(4)]
        assert sd.sign_batch(msgs) == [rsa.sign(m, k) for m, k in msgs]
        assert metrics.snapshot()["sign.remote_register"] == 2
        # A handle the server does not know (BAD_HANDLE): drop, re-register, retry.
        sd._handles[keys[0].n] = 99
        assert sd.sign_batch(msgs[:1]) == [rsa.sign(*msgs[0])]
        snap = metrics.snapshot()
        assert snap["sign.remote_register"] == 3 and snap["sign.remote"] == 5
        # A restarted sidecar: the new connection's handle table is empty.
        _stop(srv)
        os.unlink(f"{sock_dir}/rereg.sock")
        chan.close()
        srv, _t = vs.serve(addr, device="cpu")
        assert sd.sign_batch(msgs) == [rsa.sign(m, k) for m, k in msgs]
        snap = metrics.snapshot()
        # keys[1], dropped with the BAD_HANDLE table, registers first (on the
        # new connection); keys[0]'s old handle then draws BAD_HANDLE, and
        # both register again.
        assert snap["sign.remote_register"] == 6 and snap["sign.remote"] == 9
        assert not snap.get("sign.remote_fallback")
    finally:
        chan.close()
        _stop(srv)


def test_sign_never_remotes_keys_over_plain_tcp(keys):
    srv, _t = vs.serve("127.0.0.1:0", device="cpu")
    try:
        addr = "%s:%d" % srv.server_address
        metrics.reset()
        sd = RemoteSignerDomain(addr)
        assert not sd.channel.carries_keys
        assert sd.sign_batch([(b"local-only", keys[0])]) == [rsa.sign(b"local-only", keys[0])]
        assert not metrics.snapshot().get("sign.remote")
        st, _ = SidecarChannel(addr).request(vs.OP_REGISTER, vs.encode_register_request([keys[0]]))
        assert st == vs.ST_REFUSED
    finally:
        _stop(srv)


def test_key_budget_exhaustion_is_terminal_not_a_breaker_flap(keys, port_sidecar):
    addr, srv = port_sidecar
    srv.service.max_keys = 1
    metrics.reset()
    chan = SidecarChannel(addr)
    sd = RemoteSignerDomain(channel=chan)
    msgs = [(b"one", keys[0]), (b"two", keys[1])]
    assert sd.sign_batch(msgs) == [rsa.sign(m, k) for m, k in msgs]
    snap = metrics.snapshot()
    assert snap["sign.remote_refused"] == 1 and not snap.get("verify.remote_breaker_open")
    assert not chan.tripped()
    vd = RemoteVerifierDomain(channel=chan, spot_rate=0)
    sig = rsa.sign(b"one", keys[0])
    assert list(vd.verify_batch([(b"one", sig, keys[0].public)])) == [True]
    assert metrics.snapshot()["verify.remote"] == 1
    sd.sign_batch([(b"three", keys[0])])
    assert metrics.snapshot()["sign.remote_refused"] == 1  # never asked again


def test_hmac_roundtrip_sign_and_fail_closed(keys):
    secret = b"s" * 32
    srv, _t = vs.serve("127.0.0.1:0", device="cpu", secret=secret)
    try:
        addr = "%s:%d" % srv.server_address
        items, want = _verify_items(keys, n=4)
        metrics.reset()
        assert list(RemoteVerifierDomain(addr, secret=secret).verify_batch(items)) == want
        sd = RemoteSignerDomain(addr, secret=secret)
        assert sd.channel.carries_keys
        assert sd.sign_batch([(b"hmac-sign", keys[0])]) == [rsa.sign(b"hmac-sign", keys[0])]
        snap = metrics.snapshot()
        assert snap["verify.remote"] == 4 and snap["sign.remote"] == 1
        # Without the secret the sidecar drops the connection: local verify.
        metrics.reset()
        assert list(RemoteVerifierDomain(addr).verify_batch(items)) == want
        assert metrics.snapshot()["verify.remote_fallback"] == 4
        # A plaintext REGISTER on the HMAC channel is refused as ERR.
        st, _ = SidecarChannel(addr, secret=secret).request(
            vs.OP_REGISTER, vs.encode_register_request([keys[0]]))
        assert st == vs.ST_ERR
    finally:
        _stop(srv)


def test_wrong_verdicts_trip_the_spot_check_and_the_breaker(keys, port_sidecar):
    addr, srv = port_sidecar
    orig = srv.dispatcher.verify
    srv.dispatcher.verify = lambda items: [not v for v in orig(items)]
    metrics.reset()
    chan = SidecarChannel(addr, breaker_seconds=0.3)
    rd = RemoteVerifierDomain(channel=chan, spot_rate=1.0)
    items, want = _verify_items(keys, n=4)
    assert list(rd.verify_batch(items)) == want
    snap = metrics.snapshot()
    assert snap["crypto.sidecar.dishonest"] == 1 and snap["verify.remote_fallback"] == 4
    assert chan.tripped()
    # While the breaker is open the service is skipped: no frame is sent.
    ops = snap["sidecar.ops{op=verify}"]
    assert list(rd.verify_batch(items)) == want
    assert metrics.snapshot()["sidecar.ops{op=verify}"] == ops
    # Once it lapses, an honest service is used again.
    srv.dispatcher.verify = orig
    time.sleep(0.35)
    assert not chan.tripped()
    assert list(rd.verify_batch(items)) == want
    assert metrics.snapshot()["verify.remote"] == 8  # the lying batch, then this one


def test_honest_verdicts_pass_the_spot_check(keys, port_sidecar):
    addr, _srv = port_sidecar
    metrics.reset()
    rd = RemoteVerifierDomain(addr, spot_rate=1.0)
    items, want = _verify_items(keys, n=5)
    assert list(rd.verify_batch(items)) == want
    snap = metrics.snapshot()
    assert snap["verify.spot_check"] == 1 and not snap.get("crypto.sidecar.dishonest")
    assert not rd.channel.tripped()


def test_forged_signatures_caught_by_the_self_check(keys, port_sidecar):
    addr, srv = port_sidecar
    srv.service.sign.submit = lambda items: [b"\x00" * 128 for _ in items]
    metrics.reset()
    sd = RemoteSignerDomain(addr)
    msgs = [(b"forge-%d" % i, keys[0]) for i in range(3)]
    assert sd.sign_batch(msgs) == [rsa.sign(m, k) for m, k in msgs]
    snap = metrics.snapshot()
    assert snap["crypto.sidecar.dishonest"] == 1 and snap["sign.remote_fallback"] == 3
    assert sd.channel.tripped()


def test_dishonest_modexp_caught(port_sidecar):
    addr, srv = port_sidecar
    orig = srv.service.modexp.submit
    srv.service.modexp.submit = lambda items: [v + 1 for v in orig(items)]
    metrics.reset()
    md = RemoteModexpDomain(addr, spot_rate=1.0)
    items = [(3, 65537, (1 << 89) - 1)]
    assert md.powmod_batch(items) == [pow(*items[0])]
    assert metrics.snapshot()["crypto.sidecar.dishonest"] == 1 and md.channel.tripped()


def test_sidecar_coalesces_across_tenants(keys, sock_dir):
    addr = f"unix:{sock_dir}/coal.sock"
    srv, _t = vs.serve(addr, device="cpu", max_wait=0.5)
    try:
        items, want = _verify_items(keys, n=8)
        metrics.reset()
        domains = [RemoteVerifierDomain(addr, spot_rate=0.0) for _ in range(4)]
        results = [None] * 4

        def run(i):
            results[i] = list(domains[i].verify_batch(items))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert not any(t.is_alive() for t in ts) and results == [want] * 4
        snap = metrics.snapshot()
        assert snap["dispatch.items"] == 32 and snap["dispatch.flushes"] < 4
    finally:
        _stop(srv)


def test_stats_frame_and_endpoint(keys, sock_dir):
    addr = f"unix:{sock_dir}/stats.sock"
    srv, _t = vs.serve(addr, device="cpu", stats="127.0.0.1:0", name="sidecar01")
    try:
        port = srv.stats_httpd.server_address[1]
        items, want = _verify_items(keys, n=2)
        chan = SidecarChannel(addr)
        assert list(RemoteVerifierDomain(channel=chan, spot_rate=0.0).verify_batch(items)) == want
        st = chan.stats()
        assert st["device_plane"]["device"] == "cpu" and st["queue"]["shed"] == 0
        assert st["ops"]["verify"] >= 2 and st["device_plane"]["calibration"]["prefer_host"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/info", timeout=10) as r:
            info = json.loads(r.read())
        assert info["role"] == "sidecar" and info["name"] == "sidecar01"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics?format=json", timeout=10) as r:
            assert isinstance(json.loads(r.read()), dict)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics?format=prometheus",
                                    timeout=10) as r:
            assert b"bftkv_sidecar_ops_total" in r.read()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/recalibrate", timeout=10) as r:
            assert json.loads(r.read())["backend"] == "cpu"
        chan.close()
    finally:
        srv.stats_httpd.shutdown()
        srv.stats_httpd.server_close()
        _stop(srv)


def test_main_parses_the_device_argument(monkeypatch):
    seen = {}

    def fake_serve(listen, **kw):
        seen.update(kw, listen=listen)
        raise SystemExit(0)

    monkeypatch.setattr(vs, "serve", fake_serve)
    with pytest.raises(SystemExit):
        vs.main(["--listen", "unix:/tmp/s.sock", "--device", "cpu"])
    assert seen["device"] == "cpu" and seen["listen"] == "unix:/tmp/s.sock"
    with pytest.raises(SystemExit):
        vs.main([])
    assert seen["device"] == "cuda:0"


# -- the kill-mid-traffic case on the reference's loopback cluster ----------------


def test_sidecar_death_mid_traffic_zero_failed_writes(sock_dir, monkeypatch):
    """The reference's acceptance scenario: a 4-node cluster of the
    reference protocol signs and verifies through the port's sidecar (its
    domains in the reference's dispatchers); the sidecar dies mid-traffic,
    every write still commits on local crypto, the breaker opens, and a
    restarted sidecar serves again with re-registered handles."""
    from bftkv_tpu.crypto import vcache
    from bftkv_tpu.ops import dispatch as ref_dispatch
    from cluster_utils import start_cluster

    monkeypatch.setattr(vcache, "_ENABLED", False)
    addr = f"unix:{sock_dir}/kill.sock"
    srv, _t = vs.serve(addr, device="cpu")
    chan = SidecarChannel(addr, breaker_seconds=0.5)
    ref_dispatch.install(ref_dispatch.VerifyDispatcher(
        verifier=RemoteVerifierDomain(channel=chan), calibrate=False))
    ref_dispatch.install_signer(ref_dispatch.SignDispatcher(
        signer=RemoteSignerDomain(channel=chan), calibrate=False, max_wait=0.002))
    c = start_cluster(4, 1, 4, bits=1024)
    try:
        cl = c.clients[0]
        metrics.reset()
        assert cl.write(b"sc/pre", b"v0") is None
        assert metrics.snapshot().get("sign.remote", 0) > 0
        _stop(srv)
        os.unlink(f"{sock_dir}/kill.sock")
        chan.close()
        for i in range(2):
            assert cl.write(b"sc/during/%d" % i, b"v%d" % i) is None
            assert cl.read(b"sc/during/%d" % i) == b"v%d" % i
        assert metrics.snapshot().get("verify.remote_breaker_open", 0) >= 1
        srv, _ = vs.serve(addr, device="cpu")
        time.sleep(0.6)
        reg0 = metrics.snapshot().get("sign.remote_register", 0)
        deadline = time.time() + 20
        while time.time() < deadline:
            assert cl.write(b"sc/after", b"v9") is None
            if metrics.snapshot().get("sign.remote_register", 0) > reg0:
                break
        assert metrics.snapshot().get("sign.remote_register", 0) > reg0
    finally:
        ref_dispatch.uninstall_all()
        c.stop()
        _stop(srv)
