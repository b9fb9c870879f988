"""The port's crypto layer (``bftkv_tpu_torch/crypto``: certificates,
keyring, detached and collective signatures, the verified-signature memo,
Shamir sharing, message security, data encryption, the ``new_crypto``
bundle) held against the reference's (``bftkv_tpu/crypto``).

- The reference's ``tests/test_crypto_layer.py`` (12),
  ``tests/test_verify_cache.py`` (8) and ``tests/test_sss.py`` (5) cases,
  and the cases of ``tests/test_message_sessions.py`` and
  ``tests/test_ec_identity.py`` that need no transport or cluster, against
  the port on the ``cpu`` (the collective verify through the plain
  versions of its kernels, or the host below the domains' crossovers).
- Cross-package: envelopes cross between the packages in both directions
  (the port also on its pure-Python OAEP, the path of a host without the
  ``cryptography`` package); keyrings, certificates and private keys
  serialize to the same bytes; collective signatures, data-encryption
  blobs and ECIES wraps made by one package are accepted by the other.
"""

from __future__ import annotations

from unittest import mock

import numpy as np
import pytest

from bftkv_tpu import errors as ref_errors
from bftkv_tpu import packet as ref_packet
from bftkv_tpu.crypto import cert as ref_cert
from bftkv_tpu.crypto import dataenc as ref_dataenc
from bftkv_tpu.crypto import ecdsa as ref_ecdsa
from bftkv_tpu.crypto import keyring as ref_keyring
from bftkv_tpu.crypto import message as ref_message
from bftkv_tpu.crypto import rsa as ref_rsa
from bftkv_tpu.crypto import signature as ref_signature
from bftkv_tpu_torch import packet
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import dataenc, ecdsa, keyring, message, new_crypto, rsa, signature, sss, vcache
from bftkv_tpu_torch.crypto.keyring import Keyring, parse_private_key, serialize_private_key
from bftkv_tpu_torch.crypto.message import MessageSecurity
from bftkv_tpu_torch.crypto.signature import CollectiveSignature, Signer, verify_with_certificate
from bftkv_tpu_torch.errors import (
    ERR_DECRYPTION_FAILURE,
    ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES,
    ERR_INVALID_SIGNATURE,
    ERR_INVALID_TRANSPORT_SECURITY_DATA,
    ERR_UNKNOWN_SESSION,
)
from bftkv_tpu_torch.metrics import registry as metrics

KEY_BITS = 1024  # small keys keep the suite fast; the layer is width-generic
DEV = "cpu"


@pytest.fixture(autouse=True)
def _fresh_state():
    """The memo and the metrics registry are process-global: no test (and
    no other file in the same worker) sees another's entries."""
    vcache.reset()
    metrics.reset()
    yield
    vcache.reset()
    metrics.reset()


def _rsa_key(seed: int) -> rsa.PrivateKey:
    return rsa.generate(KEY_BITS, seed=seed)


@pytest.fixture(scope="module")
def identities():
    out = []
    for i in range(5):
        key = _rsa_key(8100 + i)
        c = certmod.Certificate(
            n=key.n, e=key.e, name=f"node{i}", address=f"http://127.0.0.1:{6000 + i}",
            uid=f"node{i}@example.test",
        )
        out.append((key, c))
    return out


class FixedQuorum:
    """Duck-typed quorum: sufficient once >= k distinct nodes."""

    def __init__(self, k):
        self.k = k

    def is_sufficient(self, nodes):
        return len({n.id for n in nodes}) >= self.k


# -- the reference's tests/test_crypto_layer.py -------------------------------


def test_cert_roundtrip_and_id(identities):
    key, c = identities[0]
    [parsed] = certmod.parse(c.serialize())
    assert parsed.id == c.id
    assert parsed.name == "node0"
    assert parsed.address.endswith(":6000")
    assert parsed.uid == "node0@example.test"
    assert parsed.n == key.n


def test_cert_sign_merge_signers(identities):
    _, c = identities[0]
    c = certmod.parse(c.serialize())[0]
    for key, _signer_cert in identities[1:3]:
        certmod.sign_certificate(c, key)
    assert set(c.signers()) == {identities[1][1].id, identities[2][1].id}
    assert c.verify_signature(identities[1][1])
    assert not c.verify_signature(identities[3][1])
    c2 = certmod.parse(c.serialize())[0]
    certmod.sign_certificate(c2, identities[3][0])
    c.merge(c2)
    assert set(c.signers()) == {identities[1][1].id, identities[2][1].id, identities[3][1].id}


def test_parse_many(identities):
    parsed = certmod.parse(certmod.serialize_many([c for _, c in identities]))
    assert [p.id for p in parsed] == [c.id for _, c in identities]


def test_keyring_register_merge_persist(identities, tmp_path):
    ring = keyring.Keyring()
    key0, c0 = identities[0]
    ring.register([c0], priv=key0)
    assert ring.lookup(c0.id) is c0
    assert ring.private_key(c0.id).d == key0.d
    copy = certmod.parse(c0.serialize())[0]
    certmod.sign_certificate(copy, identities[1][0])
    ring.register([copy])
    assert identities[1][1].id in ring.lookup(c0.id).signers()
    ring.save_pubring(str(tmp_path / "pubring"))
    ring.save_secring(str(tmp_path / "secring"))
    ring2 = keyring.Keyring()
    ring2.load_pubring(str(tmp_path / "pubring"))
    ring2.load_secring(str(tmp_path / "secring"))
    assert ring2.lookup(c0.id).id == c0.id
    assert ring2.private_key(c0.id).d == key0.d


def test_detached_signature(identities):
    key, c = identities[0]
    pkt = Signer(key, c).issue(b"hello world")
    assert signature.signers(pkt) == [c.id]
    verify_with_certificate(b"hello world", pkt, c)
    with pytest.raises(ERR_INVALID_SIGNATURE):
        verify_with_certificate(b"tampered", pkt, c)
    assert signature.issuer(pkt, None).id == c.id


def test_collective_combine_and_verify(identities):
    tbss = b"<x,v,t,sig>"
    ring = keyring.Keyring()
    for _, c in identities:
        ring.register([c])
    cs = CollectiveSignature(rsa.VerifierDomain(nlimbs=64, device=DEV))
    q = FixedQuorum(3)
    ss = None
    done = False
    for i, (key, c) in enumerate(identities[:3]):
        ss, done = cs.combine(ss, cs.sign(Signer(key, c), tbss), q, ring)
        assert done == (i == 2)
    assert ss.completed
    cs.verify(tbss, ss, q, ring)
    with pytest.raises(ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES):
        cs.verify(tbss, ss, FixedQuorum(4), ring)
    with pytest.raises(ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES):
        cs.verify(b"other", ss, q, ring)


def test_collective_verify_without_keyring_uses_embedded_certs(identities):
    tbss = b"payload"
    cs = CollectiveSignature(rsa.VerifierDomain(nlimbs=64, device=DEV))
    q = FixedQuorum(2)
    ss = None
    for key, c in identities[:2]:
        ss, _ = cs.combine(ss, cs.sign(Signer(key, c), tbss), q, None)
    cs.verify(tbss, ss, q, keyring.Keyring())


def test_duplicate_signer_counted_once(identities):
    tbss = b"dup"
    cs = CollectiveSignature(rsa.VerifierDomain(nlimbs=64, device=DEV))
    key, c = identities[0]
    q = FixedQuorum(2)
    ss = None
    for _ in range(3):
        ss, done = cs.combine(ss, cs.sign(Signer(key, c), tbss), q, None)
    assert not done
    with pytest.raises(ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES):
        cs.verify(tbss, ss, q, keyring.Keyring())


def test_message_security_roundtrip(identities):
    skey, scert = identities[0]
    rkey, rcert = identities[1]
    sender = MessageSecurity(skey, scert)
    recipient = MessageSecurity(rkey, rcert)
    blob = sender.encrypt([rcert, identities[2][1]], b"secret payload", b"nonce42")
    pt, peer, nonce = recipient.decrypt(blob)
    assert (pt, peer.id, nonce) == (b"secret payload", scert.id, b"nonce42")
    third = MessageSecurity(identities[2][0], identities[2][1])
    assert third.decrypt(blob)[0] == b"secret payload"
    outsider = MessageSecurity(identities[3][0], identities[3][1])
    with pytest.raises(ERR_DECRYPTION_FAILURE):
        outsider.decrypt(blob)


def test_message_tamper_detected(identities):
    sender = MessageSecurity(*identities[0])
    recipient = MessageSecurity(*identities[1])
    blob = bytearray(sender.encrypt([identities[1][1]], b"payload", b"n"))
    blob[-1] ^= 0xFF
    with pytest.raises(ERR_DECRYPTION_FAILURE):
        recipient.decrypt(bytes(blob))


def test_dataenc_roundtrip():
    key = b"some derived key material"
    ct = dataenc.encrypt(b"hello", key)
    assert dataenc.decrypt(ct, key) == b"hello"
    with pytest.raises(ERR_DECRYPTION_FAILURE):
        dataenc.decrypt(ct, b"wrong key")


def test_crypto_bundle(identities):
    key, c = identities[0]
    cr = new_crypto(key, c, device=DEV)
    assert cr.signer.cert.id == c.id
    assert cr.keyring.lookup(c.id) is c
    assert cr.collective.verifier.device.type == "cpu"
    verify_with_certificate(b"m", cr.signer.issue(b"m"), c)


# -- the reference's tests/test_verify_cache.py -------------------------------


class _Q:
    def is_sufficient(self, nodes):
        return len(nodes) >= 1


@pytest.fixture(scope="module")
def identity():
    key = _rsa_key(8200)
    return key, certmod.Certificate(n=key.n, e=key.e, name="vc", uid="vc")


def _share(key, cert, tbs: bytes):
    return CollectiveSignature(device=DEV).sign(Signer(key, cert), tbs)


def _ring_of(cert):
    class Ring:
        def get(self, sid):
            return cert if sid == cert.id else None

    return Ring()


def test_hit_requires_exact_triple(identity):
    key, cert = identity
    tbs = b"triple-match"
    sig = rsa.sign(tbs, key)
    vcache.put(cert, tbs, sig)
    assert vcache.get(cert, tbs, sig)
    assert not vcache.get(cert, b"Triple-match", sig)
    assert not vcache.get(cert, tbs, sig[:-1] + bytes([sig[-1] ^ 1]))
    other = _rsa_key(8201)
    assert not vcache.get(certmod.Certificate(n=other.n, e=other.e, name="o", uid="o"), tbs, sig)


def test_same_id_different_key_material_misses(identity):
    key, cert = identity
    tbs = b"id-collision"
    sig = rsa.sign(tbs, key)
    vcache.put(cert, tbs, sig)
    other = _rsa_key(8201)
    forged = certmod.Certificate(n=other.n, e=other.e, name="f", uid="f")
    forged.__dict__["_id"] = cert.id
    assert forged.id == cert.id
    assert not vcache.get(forged, tbs, sig)


def test_revocation_evicts(identity):
    key, cert = identity
    for i in range(3):
        tbs = b"rev-%d" % i
        vcache.put(cert, tbs, rsa.sign(tbs, key))
    assert vcache.get(cert, b"rev-0", rsa.sign(b"rev-0", key))
    vcache.invalidate_signer(cert.id)
    assert len(vcache.cache) == 0
    assert not vcache.get(cert, b"rev-1", rsa.sign(b"rev-1", key))


def test_negative_results_never_cached(identity):
    key, cert = identity
    tbs = b"negative"
    share = _share(key, cert, tbs)
    good = share.data
    share.data = good[:-1] + bytes([good[-1] ^ 1])
    before = len(vcache.cache)
    with pytest.raises(ERR_INVALID_SIGNATURE):
        verify_with_certificate(tbs, share, cert, use_cache=True)
    assert len(vcache.cache) == before, "a failed verify was memoized"
    share.data = good
    verify_with_certificate(tbs, share, cert)


def test_warm_cache_cannot_mask_tampering(identity):
    key, cert = identity
    tbs = b"no-masking"
    share = _share(key, cert, tbs)
    verify_with_certificate(tbs, share, cert)
    good = share.data
    share.data = good[:-1] + bytes([good[-1] ^ 1])
    with pytest.raises(ERR_INVALID_SIGNATURE):
        verify_with_certificate(tbs, share, cert)
    share.data = good
    with pytest.raises(ERR_INVALID_SIGNATURE):
        verify_with_certificate(b"other-tbs", share, cert)


def test_use_cache_false_bypasses_entirely(identity):
    key, cert = identity
    tbs = b"tpa-bypass"
    share = _share(key, cert, tbs)
    vcache.reset()
    metrics.reset()
    CollectiveSignature(device=DEV).verify(tbs, share, _Q(), _ring_of(cert), use_cache=False)
    snap = metrics.snapshot()
    assert snap.get("verify.cache.hits", 0) == 0
    assert snap.get("verify.cache.misses", 0) == 0
    assert len(vcache.cache) == 0


def test_seeding_from_own_signature(identity):
    key, cert = identity
    pkt = Signer(key, cert).issue(b"seeded")
    assert metrics.snapshot().get("verify.cache.seeded", 0) >= 1
    calls = []
    orig = certmod.verify_detached

    def counting(tbs, sig, c):
        calls.append(tbs)
        return orig(tbs, sig, c)

    with mock.patch.object(certmod, "verify_detached", counting):
        verify_with_certificate(b"seeded", pkt, cert)
    assert calls == [], "seeded verify recomputed the math"


def test_collective_verify_memoizes_and_rechecks_quorum(identity):
    key, cert = identity
    tbs = b"quorum-recheck"
    share = _share(key, cert, tbs)
    cs = CollectiveSignature(device=DEV)
    cs.verify(tbs, share, _Q(), _ring_of(cert))

    class Stricter:
        def is_sufficient(self, nodes):
            return len(nodes) >= 2

    with pytest.raises(ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES):
        cs.verify(tbs, share, Stricter(), _ring_of(cert))


# -- the reference's tests/test_sss.py ----------------------------------------

P127 = (1 << 127) - 1


def test_sss_roundtrip_random_subsets():
    import random

    rng = random.Random(7)
    for _ in range(10):
        secret = rng.randrange(P127)
        shares = sss.distribute(secret, 10, 7, P127)
        assert sss.SSSProcess(10, 7, P127, rng.sample(shares, 7)).secret == secret


def test_sss_incremental_and_duplicate_shares():
    secret = 0xDEADBEEF
    shares = sss.distribute(secret, 5, 3, P127)
    proc = sss.SSSProcess(5, 3, P127)
    assert proc.process_response(shares[0]) is None
    assert proc.process_response(shares[0]) is None
    assert proc.process_response(shares[1]) is None
    assert proc.process_response(shares[3]) == secret
    assert proc.process_response(shares[4]) == secret


def test_sss_k_minus_one_insufficient():
    shares = sss.distribute(12345, 6, 4, P127)
    assert sss.SSSProcess(6, 4, P127, shares[:3]).secret is None


def test_sss_lagrange_tiny():
    m, xs = 97, [1, 2]
    assert (sss.lagrange(1, xs, m) * 5 + sss.lagrange(2, xs, m) * 7) % m == 3


def test_sss_bad_params():
    with pytest.raises(ValueError):
        sss.distribute(1, 3, 4, P127)


# -- the transport-free cases of tests/test_message_sessions.py ---------------


class _Ident:
    def __init__(self, name: str, seed: int):
        self.key = _rsa_key(seed)
        self.cert = certmod.Certificate(n=self.key.n, e=self.key.e, name=name, uid=f"{name}@x")
        certmod.sign_certificate(self.cert, self.key)


@pytest.fixture(scope="module")
def idents():
    return [_Ident(f"n{i}", 8300 + i) for i in range(3)]


def _mk(ident):
    return MessageSecurity(ident.key, ident.cert)


def test_bootstrap_then_session_roundtrip(idents):
    a, b = _mk(idents[0]), _mk(idents[1])
    blob1 = a.encrypt([idents[1].cert], b"first", b"n1")
    assert blob1[0] == 0x01
    plain, sender, nonce = b.decrypt(blob1)
    assert (plain, nonce, sender.id) == (b"first", b"n1", idents[0].cert.id)
    blob2 = a.encrypt([idents[1].cert], b"second", b"n2")
    assert blob2[0] == 0x02
    plain, sender, nonce = b.decrypt(blob2)
    assert (plain, nonce, sender.id) == (b"second", b"n2", idents[0].cert.id)
    resp = b.encrypt([idents[0].cert], b"reply", b"n2")
    assert resp[0] == 0x02
    plain, sender, _ = a.decrypt(resp)
    assert plain == b"reply" and sender.id == idents[1].cert.id


def test_multirecipient_bootstrap_isolates_grants(idents):
    a, b, c = (_mk(i) for i in idents)
    blob = a.encrypt([idents[1].cert, idents[2].cert], b"fanout", b"n")
    assert b.decrypt(blob)[0] == c.decrypt(blob)[0] == b"fanout"
    blob2 = a.encrypt([idents[1].cert, idents[2].cert], b"fast", b"n")
    assert blob2[0] == 0x02
    assert b.decrypt(blob2)[0] == b"fast"
    assert c.decrypt(blob2)[0] == b"fast"
    only_b = a.encrypt([idents[1].cert], b"private", b"n")
    with pytest.raises((ERR_DECRYPTION_FAILURE, ERR_UNKNOWN_SESSION)):
        c.decrypt(only_b)


def test_unknown_session_raises_interned_error(idents):
    a, b = _mk(idents[0]), _mk(idents[1])
    b.decrypt(a.encrypt([idents[1].cert], b"x", b"n"))
    fast = a.encrypt([idents[1].cert], b"y", b"n")
    with pytest.raises(ERR_UNKNOWN_SESSION):
        _mk(idents[1]).decrypt(fast)


def test_reflection_rejected(idents):
    a, b = _mk(idents[0]), _mk(idents[1])
    b.decrypt(a.encrypt([idents[1].cert], b"x", b"n"))
    fast = a.encrypt([idents[1].cert], b"y", b"n")
    with pytest.raises((ERR_DECRYPTION_FAILURE, ERR_UNKNOWN_SESSION)):
        a.decrypt(fast)


def test_hostile_grant_cannot_hijack_session(idents):
    a, v, m = (_mk(i) for i in idents)
    v.decrypt(a.encrypt([idents[1].cert], b"x", b"n"))
    sid = next(iter(a._by_peer.values())).sid
    real = message.rng.generate_random
    with mock.patch.object(message.rng, "generate_random",
                           side_effect=lambda n: sid if n == 16 else real(n)):
        hostile = m.encrypt([idents[1].cert], b"evil", b"n")
    v.decrypt(hostile)
    plain, sender, _ = v.decrypt(a.encrypt([idents[1].cert], b"still-works", b"n"))
    assert plain == b"still-works" and sender.id == idents[0].cert.id


def test_tampered_session_payload_fails_closed(idents):
    a, b = _mk(idents[0]), _mk(idents[1])
    b.decrypt(a.encrypt([idents[1].cert], b"x", b"n"))
    fast = bytearray(a.encrypt([idents[1].cert], b"y", b"n"))
    fast[-1] ^= 0x01
    with pytest.raises((ERR_DECRYPTION_FAILURE, ERR_INVALID_TRANSPORT_SECURITY_DATA)):
        b.decrypt(bytes(fast))


def test_garbage_and_empty_fail_closed(idents):
    b = _mk(idents[1])
    for blob in (b"", b"\x00", b"\x03junk", b"\x02\x00", b"\x01" + b"\xff" * 40):
        with pytest.raises((ERR_DECRYPTION_FAILURE, ERR_INVALID_TRANSPORT_SECURITY_DATA)):
            b.decrypt(blob)


# -- the cluster-free cases of tests/test_ec_identity.py ----------------------


def test_ecdsa_sign_verify_roundtrip():
    key = ecdsa.generate(seed=8400)
    sig = ecdsa.sign(b"hello", key)
    assert len(sig) == ecdsa.SIG_BYTES
    assert ecdsa.verify_host(b"hello", sig, key.public)
    assert not ecdsa.verify_host(b"hellO", sig, key.public)
    assert not ecdsa.verify_host(b"hello", sig[:-1] + b"\x00", key.public)
    assert ecdsa.sign(b"hello", key) == sig


def test_ecdsa_batch_sign_and_verify(monkeypatch):
    # The device path at these tiny batches (crossovers 0), on the plain K5.
    monkeypatch.setenv("BFTKV_EC_SIGN_THRESHOLD", "0")
    monkeypatch.setenv("BFTKV_EC_VERIFY_THRESHOLD", "0")
    monkeypatch.setenv("BFTKV_EC_BACKEND", "rns")
    key = ecdsa.generate(seed=8401)
    msgs = [b"m-%d" % i for i in range(5)]
    sigs = ecdsa.sign_batch(msgs, key, device=DEV)
    assert all(ecdsa.verify_host(m, s, key.public) for m, s in zip(msgs, sigs))
    assert sigs != [ecdsa.sign(m, key) for m in msgs]  # hedged nonces
    items = [(m, s, key.public) for m, s in zip(msgs, sigs)]
    items[2] = (msgs[2], sigs[3], key.public)
    items.append((b"junk", b"short", key.public))
    assert ecdsa.verify_batch(items, device=DEV) == [True, True, False, True, True, False]


def test_ec_certificate_roundtrip_and_edges():
    ec_key = ecdsa.generate(seed=8402)
    rsa_key = _rsa_key(8403)
    cert = certmod.make_ec_certificate(ec_key.public, name="e01", address="loop://e01", uid="e01@x")
    certmod.sign_certificate(cert, ec_key)
    certmod.sign_certificate(cert, rsa_key)
    rsa_cert = certmod.Certificate(n=rsa_key.n, e=rsa_key.e, name="r01")
    parsed = certmod.parse(cert.serialize())[0]
    assert parsed.id == cert.id and parsed.alg == certmod.ALG_P256
    assert parsed.name == "e01" and parsed.address == "loop://e01"
    assert parsed.verify_signature(parsed)
    assert parsed.verify_signature(rsa_cert)
    certmod.sign_certificate(rsa_cert, ec_key)
    assert rsa_cert.verify_signature(parsed)


def test_ec_cert_bad_point_rejected():
    cert = certmod.make_ec_certificate(ecdsa.generate(seed=8404).public)
    blob = bytearray(cert.serialize())
    blob[20] ^= 0xFF
    with pytest.raises(Exception):
        certmod.parse(bytes(blob))


def test_keyring_persists_ec_keys(tmp_path):
    ec_key = ecdsa.generate(seed=8405)
    rsa_key = _rsa_key(8406)
    assert parse_private_key(serialize_private_key(ec_key)) == ec_key
    ring = Keyring()
    ec_cert = certmod.make_ec_certificate(ec_key.public, name="e")
    ring.register([ec_cert], priv=ec_key)
    ring.register([certmod.Certificate(n=rsa_key.n, e=rsa_key.e, name="r")], priv=rsa_key)
    ring.save_secring(str(tmp_path / "sec"))
    ring.save_pubring(str(tmp_path / "pub"))
    ring2 = Keyring()
    ring2.load_pubring(str(tmp_path / "pub"))
    ring2.load_secring(str(tmp_path / "sec"))
    assert ring2.private_key(ec_cert.id) == ec_key
    assert ring2.lookup(ec_cert.id).alg == certmod.ALG_P256


def _ec_and_rsa_ids():
    ids = {}
    for i, (name, alg) in enumerate((("e1", "p256"), ("e2", "p256"), ("r1", "rsa"))):
        if alg == "p256":
            k = ecdsa.generate(seed=8410 + i)
            c = certmod.make_ec_certificate(k.public, name=name)
        else:
            k = _rsa_key(8410 + i)
            c = certmod.Certificate(n=k.n, e=k.e, name=name)
        certmod.sign_certificate(c, k)
        ids[name] = (k, c)
    return ids


def test_message_security_ec_pairs():
    ids = {name: (k, c, MessageSecurity(k, c)) for name, (k, c) in _ec_and_rsa_ids().items()}
    for a, b in (("e1", "e2"), ("e1", "r1"), ("r1", "e1")):
        _ka, ca, ma = ids[a]
        _kb, cb, mb = ids[b]
        for i in range(2):
            pt, sender, nonce = mb.decrypt(ma.encrypt([cb], b"payload-%d" % i, b"nonce-%d" % i))
            assert (pt, nonce, sender.id) == (b"payload-%d" % i, b"nonce-%d" % i, ca.id)


def test_verifier_domain_mixed_batch():
    ec_key = ecdsa.generate(seed=8420)
    rsa_key = _rsa_key(8421)
    items = []
    for i in range(4):
        m = b"mix-%d" % i
        if i % 2:
            items.append((m, ecdsa.sign(m, ec_key), ec_key.public))
        else:
            items.append((m, rsa.sign(m, rsa_key), rsa_key.public))
    items[3] = (items[3][0] + b"!", items[3][1], items[3][2])
    got = np.asarray(rsa.VerifierDomain(host_threshold=0, device=DEV).verify_batch(items))
    assert got.tolist() == [True, True, True, False]


# -- cross-package --------------------------------------------------------------


def _ref_identity(key, cert):
    """The same identity as the reference's objects."""
    rkey = ref_rsa.PrivateKey(n=key.n, e=key.e, d=key.d, p=key.p, q=key.q)
    return rkey, ref_cert.parse(cert.serialize())[0]


@pytest.mark.parametrize("port_oaep", ["host", "pure"])
def test_envelopes_cross_both_ways(idents, port_oaep, monkeypatch):
    """Bootstrap and session envelopes between a port node and a reference
    node, each direction; ``pure`` forces the port onto its pure-Python
    OAEP (a host without ``cryptography``) against the reference on the
    library's."""
    if port_oaep == "pure":
        monkeypatch.setattr(message, "_crsa", None)
        monkeypatch.setattr(message, "_OAEP", None)
    port_a = _mk(idents[0])
    assert (port_a._priv is None) == (port_oaep == "pure")
    ref_b = ref_message.MessageSecurity(*_ref_identity(idents[1].key, idents[1].cert))
    rb_cert = _ref_identity(idents[1].key, idents[1].cert)[1]
    for i in range(2):  # bootstrap, then the session fast path
        blob = port_a.encrypt([idents[1].cert], b"p2r-%d" % i, b"n%d" % i)
        assert blob[0] == (0x01 if i == 0 else 0x02)
        pt, sender, nonce = ref_b.decrypt(blob)
        assert (pt, nonce, sender.id) == (b"p2r-%d" % i, b"n%d" % i, idents[0].cert.id)
        reply = ref_b.encrypt([ref_cert.parse(idents[0].cert.serialize())[0]], b"r2p-%d" % i, b"m")
        pt, sender, _ = port_a.decrypt(reply)
        assert (pt, sender.id) == (b"r2p-%d" % i, rb_cert.id)
    # A bootstrap from the reference to a fresh port node (the port unwraps
    # the reference's OAEP on its own path).
    fresh = _mk(idents[2])
    blob = ref_b.encrypt([ref_cert.parse(idents[2].cert.serialize())[0]], b"cold", b"c")
    assert blob[0] == 0x01
    assert fresh.decrypt(blob)[0] == b"cold"


def test_ec_envelopes_and_ecies_cross_both_ways():
    ids = _ec_and_rsa_ids()
    (ek, ec_c), (rk, rc) = ids["e1"], ids["r1"]
    ref_ek = ref_ecdsa.ECPrivateKey(d=ek.d, public=ref_ecdsa.ECPublicKey(x=ek.public.x, y=ek.public.y))
    assert ecdsa.ecies_unwrap(ref_ecdsa.ecies_wrap(b"k" * 32, ref_ek.public), ek) == b"k" * 32
    assert ref_ecdsa.ecies_unwrap(ecdsa.ecies_wrap(b"j" * 32, ek.public), ref_ek) == b"j" * 32
    port_e = MessageSecurity(ek, ec_c)
    ref_r = ref_message.MessageSecurity(*_ref_identity(rk, rc))
    for i in range(2):
        pt, sender, _ = ref_r.decrypt(port_e.encrypt([rc], b"e2r-%d" % i, b"n"))
        assert (pt, sender.id) == (b"e2r-%d" % i, ec_c.id)
        pt, sender, _ = port_e.decrypt(ref_r.encrypt([ref_cert.parse(ec_c.serialize())[0]], b"r2e-%d" % i, b"n"))
        assert (pt, sender.id) == (b"r2e-%d" % i, rc.id)


def test_keyrings_certificates_and_keys_serialize_to_the_same_bytes(identities, tmp_path):
    ec_key = ecdsa.generate(seed=8430)
    ec_c = certmod.make_ec_certificate(ec_key.public, name="e", address="loop://e", uid="e@x")
    certmod.sign_certificate(ec_c, ec_key)
    crypts = []
    for key, c in identities[:3]:
        c = certmod.parse(c.serialize())[0]
        for other, _oc in identities[:3]:
            certmod.sign_certificate(c, other)
        certmod.sign_certificate(c, ec_key)
        crypts.append((key, c))
    # A port bundle's keyring, and the reference's fed the same certs.
    port = new_crypto(*crypts[0], device=DEV)
    ref_ring = ref_keyring.Keyring()
    for key, c in crypts:
        port.keyring.register([c], priv=key)
        ref_ring.register(ref_cert.parse(c.serialize()),
                          priv=ref_rsa.PrivateKey(n=key.n, e=key.e, d=key.d, p=key.p, q=key.q))
    port.keyring.register([ec_c], priv=ec_key)
    ref_ring.register(ref_cert.parse(ec_c.serialize()),
                      priv=ref_ecdsa.ECPrivateKey(d=ec_key.d, public=ref_ecdsa.ECPublicKey(
                          x=ec_key.public.x, y=ec_key.public.y)))
    for ring, tag in ((port.keyring, "port"), (ref_ring, "ref")):
        ring.save_pubring(str(tmp_path / f"pub-{tag}"))
        ring.save_secring(str(tmp_path / f"sec-{tag}"))
    for f in ("pub", "sec"):
        assert (tmp_path / f"{f}-port").read_bytes() == (tmp_path / f"{f}-ref").read_bytes()
    assert certmod.serialize_many(port.keyring.certs()) == ref_cert.serialize_many(ref_ring.certs())
    # Each package loads the other's rings.
    back = Keyring()
    back.load_pubring(str(tmp_path / "pub-ref"))
    back.load_secring(str(tmp_path / "sec-ref"))
    assert back.private_key(ec_c.id) == ec_key
    assert all(back.lookup(c.id).verify_signature(ec_c) for _k, c in crypts)
    assert serialize_private_key(crypts[0][0]) == ref_keyring.serialize_private_key(
        ref_keyring.parse_private_key(serialize_private_key(crypts[0][0])))


def test_collective_signatures_cross_both_ways(identities):
    """Shares issued by one package, combined by it and verified by the
    other; detached signatures and data-encryption blobs too."""
    tbss = b"<x,v,t,sig> cross"
    q = FixedQuorum(3)
    ss = None
    cs = CollectiveSignature(device=DEV)
    for key, c in identities[:3]:
        ss, done = cs.combine(ss, Signer(key, c).issue(tbss), q, None)
    assert done
    wire = packet.serialize_signature(ss)
    ref_cs = ref_signature.CollectiveSignature(ref_rsa.VerifierDomain(nlimbs=64, host_threshold=10**9))
    ref_cs.verify(tbss, ref_packet.parse_signature(wire), q, ref_keyring.Keyring(), use_cache=False)
    with pytest.raises(ref_errors.ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES):
        ref_cs.verify(b"other", ref_packet.parse_signature(wire), q, ref_keyring.Keyring(), use_cache=False)
    # The other way: the reference's shares and combine, the port's verify.
    rss = None
    for key, c in identities[:3]:
        rkey, rc = _ref_identity(key, c)
        rss, _ = ref_cs.combine(rss, ref_signature.Signer(rkey, rc).issue(tbss), q, None)
    back = packet.parse_signature(ref_packet.serialize_signature(rss))
    cs.verify(tbss, back, q, Keyring(), use_cache=False)
    with pytest.raises(ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES):
        cs.verify(tbss, back, FixedQuorum(4), Keyring(), use_cache=False)
    # Detached signatures are byte-identical (PKCS#1 v1.5 is deterministic).
    key, c = identities[0]
    rkey, rc = _ref_identity(key, c)
    assert Signer(key, c).issue(b"m").data == ref_signature.Signer(rkey, rc).issue(b"m").data
    # Data encryption: each package opens the other's blob.
    assert ref_dataenc.decrypt(dataenc.encrypt(b"v", b"k"), b"k") == b"v"
    assert dataenc.decrypt(ref_dataenc.encrypt(b"w", b"k"), b"k") == b"w"
