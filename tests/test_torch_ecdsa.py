"""ECDSA P-256 in the port (``bftkv_tpu_torch/crypto/ecdsa.py``) against the
reference's, and EC keys in the port's verify and sign flushes.

Signatures cross between the packages: deterministic signing is
byte-identical, and each package's ``verify_host`` accepts the other's
``sign_batch`` output.  The batches run on the cpu through the RNS
engine's plain version (``BFTKV_EC_BACKEND=rns``, one scalar-mult call
per batch, a few seconds); the reference's jitted scalar mult is reached
only by the test marked ``slow``.
"""

from __future__ import annotations

import random

import pytest

from bftkv_tpu.crypto import ec as ref_ec
from bftkv_tpu.crypto import ecdsa as ref_ecdsa
from bftkv_tpu_torch.crypto import ec, ecdsa, rsa
from bftkv_tpu_torch.errors import ERR_MALFORMED_REQUEST
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import cuda_ec, dispatch
from bftkv_tpu_torch.ops import ec as ec_ops
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = ec.P256.n


@pytest.fixture(autouse=True)
def rns_engine(monkeypatch):
    monkeypatch.setenv("BFTKV_EC_BACKEND", "rns")


@pytest.fixture(scope="module")
def keys():
    return [ecdsa.generate(seed=s) for s in (101, 102)]


def _ref_key(key: ecdsa.ECPrivateKey) -> ref_ecdsa.ECPrivateKey:
    pub = ref_ecdsa.ECPublicKey(x=key.public.x, y=key.public.y)
    return ref_ecdsa.ECPrivateKey(d=key.d, public=pub)


def _ref_pub(pub: ecdsa.ECPublicKey) -> ref_ecdsa.ECPublicKey:
    return ref_ecdsa.ECPublicKey(x=pub.x, y=pub.y)


def _flip(sig: bytes) -> bytes:
    return sig[:-1] + bytes([sig[-1] ^ 1])


def test_seeded_generate_and_public_codec(keys):
    a, b = keys
    assert a == ecdsa.generate(seed=101) and a != b
    assert ec.P256.scalar_base_mult(a.d) == a.public.point
    assert ecdsa.public_from_bytes(a.public.marshal()) == a.public
    assert a.public.marshal() == _ref_pub(a.public).marshal()
    for bad in (b"\x00", b"\x04" + b"\x01" * 64, a.public.marshal()[:-1]):
        with pytest.raises(ERR_MALFORMED_REQUEST):
            ecdsa.public_from_bytes(bad)


def test_deterministic_sign_is_byte_identical_to_the_reference(keys):
    for key in keys:
        for i in range(3):
            msg = b"deterministic %d" % i
            sig = ecdsa.sign(msg, key)
            assert sig == ref_ecdsa.sign(msg, _ref_key(key))
            assert ecdsa._rfc6979_k(7, key.d, N, b"x") == ref_ecdsa._rfc6979_k(7, key.d, N, b"x")
            assert ecdsa.verify_host(msg, sig, key.public)
            assert not ecdsa.verify_host(msg, _flip(sig), key.public)


def test_port_sign_batch_verifies_in_the_reference(keys):
    key = keys[0]
    msgs = [b"port batch %d" % i for i in range(ecdsa.SIGN_HOST_CROSSOVER + 2)]
    sigs = ecdsa.sign_batch(msgs, key, device="cpu")
    for m, s in zip(msgs, sigs):
        assert ref_ecdsa.verify_host(m, s, _ref_pub(key.public))
        assert ecdsa.verify_host(m, s, key.public)
    # Hedged nonces: the device batch differs from deterministic signing.
    assert sigs[0] != ecdsa.sign(msgs[0], key)


def test_reference_sign_batch_on_its_host_path_verifies_in_the_port(keys, monkeypatch):
    monkeypatch.setattr(ref_ecdsa, "SIGN_HOST_CROSSOVER", 1 << 30)
    key = keys[1]
    msgs = [b"reference batch %d" % i for i in range(10)]
    sigs = ref_ecdsa.sign_batch(msgs, _ref_key(key))
    assert all(ecdsa.verify_host(m, s, key.public) for m, s in zip(msgs, sigs))
    assert ecdsa.verify_batch([(m, s, key.public) for m, s in zip(msgs, sigs)], device="cpu") \
        == [True] * len(msgs)


@pytest.mark.slow  # reaches the reference's jitted scalar mult
def test_reference_sign_batch_on_its_device_path_verifies_in_the_port(keys):
    key = keys[1]
    msgs = [b"reference device batch %d" % i for i in range(10)]
    sigs = ref_ecdsa.sign_batch(msgs, _ref_key(key))
    assert all(ecdsa.verify_host(m, s, key.public) for m, s in zip(msgs, sigs))


def _malformed_items(keys):
    """(items, expected verdicts): valid and forged signatures and the items
    that must fail closed — r = 0, s = 0, s = n, s >= n, r >= n, a short
    signature, a signature that is not bytes, an off-curve key, a key on
    another curve."""
    a, b = keys
    items, want = [], []
    for i in range(6):
        key = (a, b)[i % 2]
        msg = b"item %d" % i
        items.append((msg, ecdsa.sign(msg, key), key.public))
        want.append(True)
    good = ecdsa.sign(b"base", a)
    r, s = good[:32], good[32:]
    big = lambda v: v.to_bytes(32, "big")
    bad_sigs = [_flip(good), big(0) + s, r + big(0), r + big(N), r + big(N + 7),
                big(N + 1) + s, good[:63], good + b"\x00"]
    for sig in bad_sigs:
        items.append((b"base", sig, a.public))
        want.append(False)
    items.append((b"base", "x" * 64, a.public))  # not bytes
    want.append(False)
    off = ecdsa.ECPublicKey(x=a.public.x, y=(a.public.y + 1) % ec.P256.p)
    items.append((b"base", good, off))
    want.append(False)
    other = ec.Curve(name="other", p=ec.P256.p, a=ec.P256.a, b=ec.P256.b + 1, gx=ec.P256.gx,
                     gy=ec.P256.gy, n=ec.P256.n, bits=256)
    items.append((b"base", good, ecdsa.ECPublicKey(x=a.public.x, y=a.public.y, curve=other)))
    want.append(False)
    items.append((b"base", good, a.public))
    want.append(True)
    return items, want


@pytest.mark.parametrize("path", ["device", "host"])
def test_verify_batch_fails_malformed_items_closed(keys, monkeypatch, path):
    items, want = _malformed_items(keys)
    monkeypatch.setenv("BFTKV_EC_VERIFY_THRESHOLD", "0" if path == "device" else "1000")
    got = ecdsa.verify_batch(items, device="cpu")
    assert got == want
    for (m, s, k), g in zip(items, got):
        if isinstance(s, bytes) and k.curve.name == "P-256":
            assert ref_ecdsa.verify_host(m, s, ref_ecdsa.ECPublicKey(x=k.x, y=k.y)) is g


def test_mixed_rsa_and_ec_flush_gives_the_host_verdicts(keys, monkeypatch):
    """RSA and EC items in one VerifierDomain flush: the RSA items through
    the RNS verify, the EC items through ecdsa.verify_batch (counted as
    ``verify.ec``), every verdict equal to its host oracle."""
    monkeypatch.setenv("BFTKV_EC_VERIFY_THRESHOLD", "0")
    rkey = rsa.generate(1024, seed=3)
    ec_items, ec_want = _malformed_items(keys)
    items, want = [], []
    for i, (m, s, k) in enumerate(ec_items):
        items.append((m, s, k))
        want.append(ec_want[i])
        if i % 3 == 0:
            msg = b"rsa %d" % i
            sig = rsa.sign(msg, rkey)
            items.append((msg, sig if i % 2 else _flip(sig), rkey.public))
            want.append(bool(i % 2))
    metrics.reset()
    got = rsa.VerifierDomain(device="cpu", host_threshold=0).verify_batch(items)
    assert got.tolist() == want
    snap = metrics.snapshot()
    assert snap["verify.ec"] == len(ec_items)
    assert snap["verify.device"] == len(items) - len(ec_items)


def test_sign_dispatcher_signs_ec_and_rsa_items_in_one_flush(keys):
    rkey = rsa.generate(1024, seed=4)
    a, b = keys
    items = [(b"ec-a %d" % i, a) for i in range(9)] + [(b"rsa %d" % i, rkey) for i in range(3)]
    items += [(b"ec-b %d" % i, b) for i in range(8)]
    random.Random(5).shuffle(items)
    metrics.reset()
    sd = dispatch.SignDispatcher(rsa.SignerDomain(device="cpu"), max_wait=0.05,
                                 calibrate=False, device="cpu").start()
    try:
        sigs = sd.submit(items)
    finally:
        sd.stop()
    for (m, key), sig in zip(items, sigs):
        if hasattr(key, "curve"):
            assert ecdsa.verify_host(m, sig, key.public)
            assert ref_ecdsa.verify_host(m, sig, _ref_pub(key.public))
        else:
            assert sig == rsa.sign(m, key)
    snap = metrics.snapshot()
    assert snap["signdispatch.flushes"] == 1
    # The gauge holds the last key group's fill of the batch cap.
    assert snap["signdispatch.device_occupancy{width=ec}"] in (8 / 1024, 9 / 1024)
    assert "ec.sign_fault" not in snap


def test_sign_fault_is_counted_and_the_batch_signed_on_the_host(keys, monkeypatch):
    """A device that returns wrong nonce points: the spot check catches it,
    ``ec.sign_fault`` counts it and every signature comes from the host."""
    key = keys[0]
    real = ec_ops.scalar_base_mult_hosts

    def faulty(ks, device=None):
        return [ec.P256.double(R) for R in real(ks, device=device)]

    monkeypatch.setattr(ec_ops, "scalar_base_mult_hosts", faulty)
    metrics.reset()
    msgs = [b"fault %d" % i for i in range(8)]
    sigs = ecdsa.sign_batch(msgs, key, device="cpu")
    assert sigs == [ecdsa.sign(m, key) for m in msgs]
    assert metrics.snapshot()["ec.sign_fault"] == 1


def test_a_device_error_reaches_the_verify_caller(keys, monkeypatch):
    """A K5 failure propagates out of VerifierDomain.verify_batch: it is
    never answered by the limb engine or the host."""
    monkeypatch.setenv("BFTKV_EC_VERIFY_THRESHOLD", "0")

    def boom(*a, **kw):
        raise RuntimeError("ec_scalar_mult kernel launch failed")

    monkeypatch.setattr(cuda_ec, "scalar_mult_cuda", boom)
    monkeypatch.setattr(ecdsa, "verify_host", lambda *a: pytest.fail("host verify reached"))
    items, _ = _malformed_items(keys)
    with pytest.raises(RuntimeError, match="ec_scalar_mult"):
        rsa.VerifierDomain(device="cpu", host_threshold=0).verify_batch(items)
    from bftkv_tpu_torch.ops import devbuf

    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())


def test_signer_domain_refuses_ec_keys(keys):
    with pytest.raises(NotImplementedError, match="SignDispatcher"):
        rsa.SignerDomain(device="cpu").sign_batch([(b"m", keys[0])])


def test_host_curve_is_the_reference_curve():
    for name in ("p", "a", "b", "gx", "gy", "n", "bits", "name"):
        assert getattr(ec.P256, name) == getattr(ref_ec.P256, name)
    pt = ec.P256.scalar_base_mult(99)
    assert pt == ref_ec.P256.scalar_base_mult(99)
    assert ec.marshal(ec.P256, pt) == ref_ec.marshal(ref_ec.P256, pt)
    assert ec.unmarshal(ec.P256, ec.marshal(ec.P256, pt)) == pt
