"""The port's RSA domains (bftkv_tpu_torch.crypto.rsa) at full width on the CPU.

Verdicts are held against host ``pow`` and the reference's host oracle
``bftkv_tpu.crypto.rsa.verify_host``; signatures against host ``sign``
of both packages (PKCS#1 v1.5 is deterministic).  The domains run the
plain PyTorch versions here (``device="cpu"``); tolerance is exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from bftkv_tpu.crypto import rsa as ref_rsa
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import rns
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def keys():
    return {
        2048: [rsa.generate(2048, seed=s) for s in (1, 2)],
        1024: [rsa.generate(1024, seed=3)],
    }


def _ref_key(k: rsa.PrivateKey) -> ref_rsa.PrivateKey:
    return ref_rsa.PrivateKey(n=k.n, e=k.e, d=k.d, p=k.p, q=k.q)


def _flip(sig: bytes) -> bytes:
    return sig[:-1] + bytes([sig[-1] ^ 1])


def test_seeded_generate_is_reproducible_and_valid():
    a, b = rsa.generate(1024, seed=42), rsa.generate(1024, seed=42)
    assert a == b and a != rsa.generate(1024, seed=43)
    assert a.n == a.p * a.q and a.n.bit_length() == 1024
    assert pow(pow(12345, a.e, a.n), a.d, a.n) == 12345


def test_host_sign_and_verify_match_reference(keys):
    for key in keys[2048] + keys[1024]:
        msg = b"host path %d" % key.n.bit_length()
        sig = rsa.sign(msg, key)
        assert sig == ref_rsa.sign(msg, _ref_key(key))
        pub = ref_rsa.PublicKey(n=key.n, e=key.e)
        assert rsa.verify_host(msg, sig, key.public) is ref_rsa.verify_host(msg, sig, pub) is True
        assert rsa.verify_host(msg, _flip(sig), key.public) is False
        assert rsa.emsa_pkcs1v15_sha256(msg, 256) == ref_rsa.emsa_pkcs1v15_sha256(msg, 256)


def _verify_items(keys):
    k1, k2 = keys[2048]
    chan = rns.context().pb[5]
    hostile = rsa.PublicKey(n=chan * ((1 << 2035) + 3))  # shares a channel prime
    items, want = [], []
    for i in range(5):
        key = (k1, k2)[i % 2]
        msg = b"write %d" % i
        items.append((msg, rsa.sign(msg, key), key.public))
    items.append((b"forged", _flip(rsa.sign(b"forged", k1)), k1.public))
    items.append((b"hostile", rsa.sign(b"hostile", k1), hostile))
    items.append((b"too big", (k2.n + 5).to_bytes(257, "big"), k2.public))
    items.append((b"1024", rsa.sign(b"1024", keys[1024][0]), keys[1024][0].public))
    for msg, sig, key in items:
        s = int.from_bytes(sig, "big")
        em = rsa.emsa_pkcs1v15_sha256(msg, key.size_bytes)
        want.append(s < key.n and pow(s, 65537, key.n) == em)
    return items, np.array(want)


def test_verifier_domain_full_width_matches_host(keys):
    items, want = _verify_items(keys)
    assert want.sum() == 6  # the valid items, and only they
    metrics.reset()
    dom = rsa.VerifierDomain(device="cpu", host_threshold=0)
    got = dom.verify_batch(items)
    np.testing.assert_array_equal(got, want)
    ref = [
        ref_rsa.verify_host(m, s, ref_rsa.PublicKey(n=k.n, e=k.e)) for m, s, k in items
    ]
    np.testing.assert_array_equal(got, ref)
    snap = metrics.snapshot()
    # hostile modulus and s >= n verify on the host; the rest on device.
    assert snap["verify.device"] == len(items) - 2
    assert snap["verify.host"] == 2
    assert snap["verify.launch.count"] == 1


def test_verifier_domain_pad_lengths(keys):
    """Batches of 1 and 257 device items pad to 256 and 512 rows."""
    k1 = keys[2048][0]
    msg_sig = [(b"m%d" % i, rsa.sign(b"m%d" % i, k1)) for i in range(3)]
    dom = rsa.VerifierDomain(device="cpu", host_threshold=0)
    assert dom.verify_batch([(msg_sig[0][0], msg_sig[0][1], k1.public)]).tolist() == [True]
    items = [
        (m, s if j % 7 else _flip(s), k1.public)
        for j in range(257)
        for m, s in [msg_sig[j % 3]]
    ]
    np.testing.assert_array_equal(
        dom.verify_batch(items), [j % 7 != 0 for j in range(257)]
    )


def test_verifier_domain_below_threshold_stays_on_host(keys):
    k1 = keys[2048][0]
    metrics.reset()
    dom = rsa.VerifierDomain(device="cpu", host_threshold=4)
    sig = rsa.sign(b"x", k1)
    assert dom.verify_batch([(b"x", sig, k1.public)]).tolist() == [True]
    assert metrics.snapshot() == {"verify.host": 1}


@pytest.mark.parametrize("bits", [1024, 2048])
def test_signer_domain_matches_host_sign(keys, bits):
    ks = keys[bits] * 2
    items = [(b"share %d" % i, k) for i, k in enumerate(ks)]
    metrics.reset()
    dom = rsa.SignerDomain(device="cpu", host_threshold=0)
    sigs = dom.sign_batch(items)
    assert sigs == [rsa.sign(m, k) for m, k in items]
    assert sigs == [ref_rsa.sign(m, _ref_key(k)) for m, k in items]
    snap = metrics.snapshot()
    assert snap["sign.device"] == len(items)
    assert "sign.fault" not in snap and "sign.host" not in snap


def test_signer_fault_check_resigns_a_faulted_half(keys, monkeypatch):
    """A wrong CRT half from the device is caught by the fault check and
    the signature is re-signed on the host (never released faulted)."""
    key = keys[1024][0]
    real = rns.power_mod_rns

    def faulty(bases, exps, mods, **kw):
        vals = real(bases, exps, mods, **kw)
        vals[0] = (vals[0] + 1) % mods[0]
        return vals

    monkeypatch.setattr(rns, "power_mod_rns", faulty)
    metrics.reset()
    items = [(b"a", key), (b"b", key)]
    sigs = rsa.SignerDomain(device="cpu", host_threshold=0).sign_batch(items)
    assert sigs == [rsa.sign(m, k) for m, k in items]
    snap = metrics.snapshot()
    assert snap["sign.fault"] == 1 and snap["sign.device"] == 2


def test_unported_backends_and_ec_keys_raise():
    with pytest.raises(ValueError):
        rsa.VerifierDomain(device="cpu", backend="bogus")
    with pytest.raises(ValueError):
        rsa.SignerDomain(device="cpu", backend="pallas")

    class EcKey:
        curve = "P-256"

    with pytest.raises(NotImplementedError, match="M8"):
        rsa.VerifierDomain(device="cpu").verify_batch([(b"m", b"s", EcKey())])
    with pytest.raises(NotImplementedError, match="M8"):
        rsa.SignerDomain(device="cpu").sign_batch([(b"m", EcKey())])
