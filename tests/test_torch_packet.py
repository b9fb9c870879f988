"""The port's packet codec (``bftkv_tpu_torch/packet.py``) held against the
reference's (``bftkv_tpu/packet.py``).

- The reference's ``tests/test_packet.py`` (14) and
  ``tests/test_packet_fuzz.py`` (8) cases, against the port: round trips,
  short packets, ``tbs``/``tbss``, hostile length prefixes, fuzzed parsers
  that fail only with interned errors, and the native codec against the
  pure one.
- The port's bytes through both of its codecs (the C codec built into
  ``bftkv_tpu_torch/_build/native/`` and the pure-Python one) equal the
  reference's pure codec on the fuzz corpus, and the parsers agree on
  every mutated input.
"""

from __future__ import annotations

import io
import random
import struct

import pytest

from bftkv_tpu import errors as ref_errors
from bftkv_tpu import packet as ref_pkt
from bftkv_tpu_torch import errors
from bftkv_tpu_torch import packet
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import ecdsa, rsa
from bftkv_tpu_torch.crypto import signature as sigmod
from bftkv_tpu_torch.crypto.message import MessageSecurity
from bftkv_tpu_torch.crypto import vcache
from bftkv_tpu_torch.metrics import registry as metrics

_TRIALS = 1500  # per corpus entry class, as the reference's fuzz runs


@pytest.fixture(autouse=True)
def _fresh_state():
    vcache.reset()
    metrics.reset()
    yield
    vcache.reset()
    metrics.reset()


@pytest.fixture(scope="module")
def rsa_key():
    return rsa.generate(1024, seed=7001)


# -- the reference's tests/test_packet.py --------------------------------------


def test_error_interning():
    e1 = errors.new_error("some failure")
    e2 = errors.error_from_string("some failure")
    assert e1 is e2
    assert errors.error_from_string("permission denied") is errors.ERR_PERMISSION_DENIED


def test_error_roundtrip_equality():
    assert errors.Error("x") == errors.Error("x")
    assert errors.Error("x") != errors.Error("y")
    d = {errors.ERR_EXIST: 1}
    assert d[errors.Error("already exist")] == 1


def test_error_raise_and_catch():
    with pytest.raises(errors.ERR_BAD_TIMESTAMP):
        raise errors.ERR_BAD_TIMESTAMP
    try:
        raise errors.ERR_BAD_TIMESTAMP
    except errors.Error as e:
        assert e == errors.ERR_BAD_TIMESTAMP
        assert e == errors.error_from_string("bad timestamp")
    seen = []
    for _ in range(2):
        try:
            raise errors.ERR_EXIST
        except errors.Error as e:
            seen.append(e)
    assert seen[0] is not seen[1]


def test_roundtrip_full():
    sig = packet.SignaturePacket(type=1, version=3, completed=True, data=b"sigdata", cert=b"certdata")
    ss = packet.SignaturePacket(type=1, version=0, completed=False, data=b"ss", cert=None)
    pkt_b = packet.serialize(b"var", b"value", 42, sig, ss, b"auth")
    p = packet.parse(pkt_b)
    assert p.variable == b"var"
    assert p.value == b"value"
    assert p.t == 42
    assert p.sig.data == b"sigdata"
    assert p.sig.cert == b"certdata"
    assert p.sig.version == 3
    assert p.sig.completed
    assert not p.ss.completed
    assert p.ss.cert is None
    assert p.auth == b"auth"


def test_roundtrip_partial():
    p = packet.parse(packet.serialize(b"x", nfields=1))
    assert p.variable == b"x" and p.value is None and p.t == 0 and p.sig is None
    p = packet.parse(packet.serialize(b"x", b"v", nfields=2))
    assert p.value == b"v" and p.t == 0
    p = packet.parse(packet.serialize(b"x", b"v", 7, nfields=3))
    assert p.t == 7 and p.sig is None and p.ss is None and p.auth is None


def test_nil_signature_roundtrip():
    p = packet.parse(packet.serialize(b"x", b"v", 1, None, None, None))
    assert p.sig is None and p.ss is None and p.auth is None


def test_empty_chunk_parses_as_none():
    assert packet.parse(packet.serialize(b"x", b"", 1)).value is None


def test_tbs_tbss():
    sig = packet.SignaturePacket(data=b"S" * 16)
    ss = packet.SignaturePacket(data=b"T" * 16)
    pkt_b = packet.serialize(b"var", b"val", 9, sig, ss, b"a")
    t = packet.tbs(pkt_b)
    assert t == packet.serialize(b"var", b"val", 9, nfields=3)
    tt = packet.tbss(pkt_b)
    assert tt == packet.serialize(b"var", b"val", 9, sig, nfields=4)
    assert tt.startswith(t)
    pkt2 = packet.serialize(b"var", b"val", 9, None, ss, b"a")
    assert packet.tbs(pkt2) == t


def test_write_once_t():
    pkt_b = packet.serialize(b"x", b"v", packet.WRITE_ONCE_T)
    assert packet.parse(pkt_b).t == packet.WRITE_ONCE_T


def test_signature_packet_roundtrip():
    sig = packet.SignaturePacket(type=5, version=9, completed=True, data=b"d", cert=b"c")
    assert packet.parse_signature(packet.serialize_signature(sig)) == sig
    assert packet.parse_signature(packet.serialize_signature(None)) is None


def test_auth_request_roundtrip():
    pkt_b = packet.serialize_auth_request(2, b"var", b"adata")
    assert packet.parse_auth_request(pkt_b) == (2, b"var", b"adata")


def test_bigint_roundtrip():
    buf = io.BytesIO()
    values = [0, 1, 255, 256, 2**64, 2**2047 + 12345]
    for n in values:
        packet.write_bigint(buf, n)
    buf.seek(0)
    for n in values:
        assert packet.read_bigint(buf) == n


def test_malformed():
    with pytest.raises(errors.Error):
        packet.parse(b"\x00\x00\x00\x00\x00\x00\x00\x09short")
    with pytest.raises(errors.ERR_MALFORMED_REQUEST):
        packet.parse(b"")
    with pytest.raises(errors.Error):
        packet.parse(struct.pack(">Q", 2**63) + b"xx")
    with pytest.raises(errors.Error):
        packet.tbs(struct.pack(">Q", 2**63) + b"xx")
    with pytest.raises(errors.Error):
        packet.tbss(packet.serialize(b"x", b"v", 1, nfields=3))
    with pytest.raises(errors.Error):
        packet.parse_signature(b"")


def test_signature_type_must_fit_byte():
    with pytest.raises(ValueError):
        packet.serialize_signature(packet.SignaturePacket(type=256))
    assert packet.SIGNATURE_TYPE_PASSWORD_AUTH_PROOF <= 0xFF


# -- the reference's tests/test_packet_fuzz.py ---------------------------------


def _mutations(rng: random.Random, blob: bytes):
    """Truncations, bit flips, length-prefix inflation, junk."""
    if blob:
        yield blob[: rng.randrange(len(blob))]
        b = bytearray(blob)
        for _ in range(rng.randint(1, 8)):
            b[rng.randrange(len(b))] = rng.randrange(256)
        yield bytes(b)
        b2 = bytearray(blob)
        if len(b2) >= 4:
            i = rng.randrange(len(b2) - 3)
            b2[i : i + 4] = (0x7FFFFFFF).to_bytes(4, "big")
            yield bytes(b2)
    yield rng.randbytes(rng.randrange(0, 64))


def _assert_interned(fn, blob):
    try:
        fn(blob)
    except errors.Error:
        pass
    except (ValueError, EOFError) as e:
        pytest.fail(f"non-interned {type(e).__name__}: {e!r} for {blob[:30]!r}")
    except Exception as e:
        pytest.fail(f"{type(e).__name__}: {e!r} escaped for {blob[:30]!r}")


def test_packet_parse_fuzz():
    rng = random.Random(1)
    genuine = packet.serialize(b"var", b"value" * 10, 7, None, None)
    for _ in range(_TRIALS):
        for blob in _mutations(rng, genuine):
            _assert_interned(packet.parse, blob)


def test_packet_list_and_results_fuzz():
    rng = random.Random(2)
    lst = packet.serialize_list([b"a" * 9, b"b" * 30, b""])
    res = packet.serialize_results([(None, b"x"), ("some error", b"")])
    for _ in range(_TRIALS):
        for blob in _mutations(rng, lst):
            _assert_interned(packet.parse_list, blob)
        for blob in _mutations(rng, res):
            _assert_interned(packet.parse_results, blob)


def test_signature_packet_fuzz(rsa_key):
    rng = random.Random(3)
    cert = certmod.Certificate(n=rsa_key.n, e=rsa_key.e, name="f")
    genuine = packet.serialize_signature(sigmod.Signer(rsa_key, cert).issue(b"tbs"))
    for _ in range(_TRIALS):
        for blob in _mutations(rng, genuine):
            _assert_interned(packet.parse_signature, blob)


def test_auth_request_fuzz():
    rng = random.Random(4)
    genuine = packet.serialize_auth_request(1, b"var", b"\x01" * 40)
    for _ in range(_TRIALS):
        for blob in _mutations(rng, genuine):
            _assert_interned(packet.parse_auth_request, blob)


def test_certificate_parse_fuzz_both_algs(rsa_key):
    rng = random.Random(5)
    rcert = certmod.Certificate(n=rsa_key.n, e=rsa_key.e, name="r", uid="r@x")
    certmod.sign_certificate(rcert, rsa_key)
    ekey = ecdsa.generate(seed=7002)
    ecert = certmod.make_ec_certificate(ekey.public, name="e", uid="e@x")
    certmod.sign_certificate(ecert, ekey)
    corpus = [rcert.serialize(), ecert.serialize(), rcert.serialize() + ecert.serialize()]
    for _ in range(_TRIALS // 2):
        for genuine in corpus:
            for blob in _mutations(rng, genuine):
                _assert_interned(certmod.parse, blob)


def test_message_envelope_fuzz(rsa_key):
    rng = random.Random(6)
    cert = certmod.Certificate(n=rsa_key.n, e=rsa_key.e, name="m")
    ms = MessageSecurity(rsa_key, cert)
    genuine = ms.encrypt([cert], b"payload", b"nonce-123")
    for _ in range(400):
        for blob in _mutations(rng, genuine):
            _assert_interned(ms.decrypt, blob)


def _outcome(fn, blob):
    try:
        return ("ok", fn(blob))
    except (errors.Error, ref_errors.Error) as e:  # interned by message in each package
        return ("err", str(e))
    except Exception as e:
        return ("exc", type(e).__name__)


def _fuzz_corpus():
    sig = packet.SignaturePacket(type=1, version=3, completed=True, data=b"\x05" * 64, cert=b"c" * 33)
    return [
        packet.serialize(b"var", b"value" * 10, 7, sig, sig, b"auth"),
        packet.serialize(b"var", None, 9, None, None),
        packet.serialize(b"x", nfields=1),
        packet.serialize(b"x", b"v", 5, nfields=3),
        packet.serialize_list([b"a" * 9, b"", b"q" * 120]),
        packet.serialize_signature(sig),
        b"",
    ]


def test_the_native_codec_builds_outside_native():
    # The port's C codec is built from native/packetcodec.c into its own
    # _build/native/ directory.
    assert packet._C is not None, "the native codec did not build"
    assert "bftkv_tpu_torch/_build/native/" in packet._C.__file__.replace("\\", "/")


def test_c_codec_differential_fuzz():
    rng = random.Random(7)
    pairs = [
        (packet.parse, packet._py_parse),
        (packet.tbs, packet._py_tbs),
        (packet.tbss, packet._py_tbss),
        (packet.parse_signature, packet._py_parse_signature),
        (packet.parse_list, packet._py_parse_list),
    ]
    for _ in range(300):
        for genuine in _fuzz_corpus():
            for blob in _mutations(rng, genuine):
                for c_fn, py_fn in pairs:
                    got, want = _outcome(c_fn, blob), _outcome(py_fn, blob)
                    assert got == want, f"{c_fn.__name__}: C={got!r} PY={want!r} for {blob[:40]!r}"


def _random_packet(rng: random.Random, sig_cls):
    var = rng.randbytes(rng.randrange(0, 20))
    val = None if rng.random() < 0.3 else rng.randbytes(rng.randrange(0, 200))
    t = rng.randrange(0, 2**64)

    def mk():
        if rng.random() < 0.4:
            return None
        return sig_cls(
            type=rng.choice([0, 1, 2, 255]),
            version=rng.randrange(0, 2**32),
            completed=rng.random() < 0.5,
            data=None if rng.random() < 0.3 else rng.randbytes(10),
            cert=None if rng.random() < 0.5 else rng.randbytes(10),
        )

    sig, ss = mk(), mk()
    auth = None if rng.random() < 0.5 else rng.randbytes(8)
    return var, val, t, sig, ss, auth, rng.choice([None, 1, 2, 3, 4, 5, 6]), mk()


def test_c_codec_serialize_matches_python():
    rng = random.Random(8)
    for _ in range(500):
        var, val, t, sig, ss, auth, nfields, s = _random_packet(rng, packet.SignaturePacket)
        a = packet.serialize(var, val, t, sig, ss, auth, nfields=nfields)
        b = packet._py_serialize(var, val, t, sig, ss, auth, nfields=nfields)
        assert a == b
        assert packet.serialize_signature(s) == packet._py_serialize_signature(s)


# -- cross-package: the port's two codecs against the reference's pure codec ---


def _ref_sig(s):
    if s is None:
        return None
    return ref_pkt.SignaturePacket(type=s.type, version=s.version, completed=s.completed,
                                   data=s.data, cert=s.cert)


@pytest.mark.parametrize("codec", ["native", "pure"])
def test_serialize_equals_the_reference_pure_codec(codec):
    rng = random.Random(9)
    ser = packet.serialize if codec == "native" else packet._py_serialize
    ser_sig = packet.serialize_signature if codec == "native" else packet._py_serialize_signature
    for _ in range(500):
        var, val, t, sig, ss, auth, nfields, s = _random_packet(rng, packet.SignaturePacket)
        want = ref_pkt._py_serialize(var, val, t, _ref_sig(sig), _ref_sig(ss), auth, nfields=nfields)
        assert ser(var, val, t, sig, ss, auth, nfields=nfields) == want
        assert ser_sig(s) == ref_pkt._py_serialize_signature(_ref_sig(s))


def _as_plain(v):
    """A parse result as plain values, comparable across the packages."""
    if isinstance(v, list):
        return [_as_plain(x) for x in v]
    if hasattr(v, "__dataclass_fields__"):
        return tuple(_as_plain(getattr(v, f)) for f in v.__dataclass_fields__)
    return v


@pytest.mark.parametrize("codec", ["native", "pure"])
def test_parsers_agree_with_the_reference_on_the_fuzz_corpus(codec):
    rng = random.Random(10)
    fns = ("parse", "tbs", "tbss", "parse_signature", "parse_list")
    ours = {f: getattr(packet, f if codec == "native" else f"_py_{f}") for f in fns}
    for _ in range(150):
        for genuine in _fuzz_corpus():
            for blob in _mutations(rng, genuine):
                for f in fns:
                    got = _outcome(ours[f], blob)
                    want = _outcome(getattr(ref_pkt, f"_py_{f}"), blob)
                    assert (got[0], _as_plain(got[1])) == (want[0], _as_plain(want[1])), (f, blob[:40])


def test_list_results_trace_and_acks_equal_the_reference():
    items = [b"a" * 9, b"", b"q" * 120]
    assert packet.serialize_list(items) == ref_pkt.serialize_list(items)
    res = [(None, b"x"), ("some error", b"")]
    assert packet.serialize_results(res) == ref_pkt.serialize_results(res)
    assert packet.wrap_trace(7, 9, b"payload") == ref_pkt.wrap_trace(7, 9, b"payload")
    assert packet.unwrap_trace(ref_pkt.wrap_trace(7, 9, b"p")) == ((7, 9), b"p")
    assert packet.serialize_ws_ack(decline_t=5) == ref_pkt.serialize_ws_ack(decline_t=5)
    assert packet.serialize_digest({3: b"h" * 32}) == ref_pkt.serialize_digest({3: b"h" * 32})
    buf, rbuf = io.BytesIO(), io.BytesIO()
    packet.write_bigint(buf, 2**300 + 5)
    ref_pkt.write_bigint(rbuf, 2**300 + 5)
    assert buf.getvalue() == rbuf.getvalue()


def test_codec_off_flag_keeps_the_pure_codec(monkeypatch):
    monkeypatch.setenv("BFTKV_NATIVE_CODEC", "off")
    assert packet._load_native_codec() is None
