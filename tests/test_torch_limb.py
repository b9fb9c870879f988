"""The port's limb and pallas backends of the RSA domains, on the CPU.

The domains run the plain PyTorch versions here (``device="cpu"``):
``backend="limb"`` the limb engine, ``backend="pallas"`` K3's wrapper,
which takes its plain version for CPU tensors.  Verdicts are held
against the host oracle (``pow``), the reference's ``verify_host`` and
the port's ``rns`` backend; signatures against host ``sign`` of both
packages.  Tolerance is exact.  The flags select the backends as the
reference's domains read them.
"""

from __future__ import annotations

import numpy as np
import pytest

from bftkv_tpu.crypto import rsa as ref_rsa
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import modexp, rns
from bftkv_tpu_torch.ops import rsa as rsa_ops
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def keys():
    return [rsa.generate(2048, seed=s) for s in (61, 62)] + [rsa.generate(1024, seed=63)]


def _flip(sig: bytes) -> bytes:
    return sig[:-1] + bytes([sig[-1] ^ 1])


def _adversarial(keys):
    """Valid, forged, hostile-modulus (shares a channel prime), s >= n,
    1024-bit, e=3 and even-modulus items, with the host verdicts."""
    k1, k2, k3 = keys
    hostile = rsa.PublicKey(n=rns.context().pb[5] * ((1 << 2035) + 3))
    items = [(b"w%d" % i, rsa.sign(b"w%d" % i, (k1, k2)[i % 2]), (k1, k2)[i % 2].public)
             for i in range(4)]
    items += [
        (b"forged", _flip(rsa.sign(b"forged", k1)), k1.public),
        (b"hostile", rsa.sign(b"hostile", k1), hostile),
        (b"too big", (k2.n + 5).to_bytes(257, "big"), k2.public),
        (b"1024", rsa.sign(b"1024", k3), k3.public),
        (b"e=3", rsa.sign(b"e=3", k1), rsa.PublicKey(n=k1.n, e=3)),
        (b"even", rsa.sign(b"even", k1), rsa.PublicKey(n=k1.n + 1)),
    ]
    want = []
    for msg, sig, key in items:
        s = int.from_bytes(sig, "big")
        em = rsa.emsa_pkcs1v15_sha256(msg, key.size_bytes)
        want.append(s < key.n and pow(s, key.e, key.n) == em)
    return items, np.array(want)


@pytest.mark.parametrize("backend", ["limb", "pallas"])
def test_limb_verify_backends_match_host_and_rns(keys, backend):
    items, want = _adversarial(keys)
    assert want.tolist() == [True] * 4 + [False] * 3 + [True, False, False]
    metrics.reset()
    got = rsa.VerifierDomain(device="cpu", host_threshold=0, backend=backend).verify_batch(items)
    np.testing.assert_array_equal(got, want)
    ref = [ref_rsa.verify_host(m, s, ref_rsa.PublicKey(n=k.n, e=k.e)) for m, s, k in items]
    np.testing.assert_array_equal(got, ref)
    snap = metrics.snapshot()
    # The hostile modulus is odd and fits: it rides the limb chain, and
    # s >= n rides as s = 0; only e=3 and the even modulus stay on host.
    assert snap["verify.device"] == len(items) - 2
    assert "verify.host" not in snap and snap["verify.launch.count"] == 1
    rns_got = rsa.VerifierDomain(device="cpu", host_threshold=0).verify_batch(items)
    np.testing.assert_array_equal(got, rns_got)


def test_limb_verify_assemble_and_pallas_width(keys):
    k1 = keys[0]
    dom = rsa.VerifierDomain(device="cpu", backend="limb")
    sig = rsa.sign(b"a", k1)
    arrays = dom.assemble([(b"a", sig, k1.public), (b"b", (k1.n + 1).to_bytes(257, "big"), k1.public)])
    assert [a.shape for a in arrays] == [(2, 128)] * 5
    assert not arrays[0][1].any()  # s >= n rides as s = 0
    ref = ref_rsa.VerifierDomain(backend="limb").assemble(
        [(b"a", sig, ref_rsa.PublicKey(n=k1.n)),
         (b"b", (k1.n + 1).to_bytes(257, "big"), ref_rsa.PublicKey(n=k1.n))]
    )
    for a, b in zip(arrays, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="2048-bit"):
        rsa.VerifierDomain(nlimbs=64, device="cpu", backend="pallas")
    rsa.VerifierDomain(nlimbs=64, device="cpu", backend="limb")  # any width


def test_limb_signer_matches_host_sign(keys):
    items = [(b"share %d" % i, k) for i, k in enumerate(keys[2:] * 3)]
    metrics.reset()
    sigs = rsa.SignerDomain(device="cpu", host_threshold=0, backend="limb").sign_batch(items)
    assert sigs == [rsa.sign(m, k) for m, k in items]
    assert sigs == [ref_rsa.sign(m, ref_rsa.PrivateKey(n=k.n, e=k.e, d=k.d, p=k.p, q=k.q))
                    for m, k in items]
    snap = metrics.snapshot()
    assert snap["sign.device"] == len(items)
    assert "sign.fault" not in snap and "sign.host" not in snap


def test_sign_group_the_rns_bases_decline_goes_to_the_limb_path(keys, monkeypatch):
    """power_mod_rns answering None (a modulus sharing a channel prime)
    sends the group to the limb power_batch, not to host signing."""
    key = keys[2]
    calls = []
    real = rsa_ops.power_batch

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(rns, "power_mod_rns", lambda *a, **kw: None)
    monkeypatch.setattr(rsa_ops, "power_batch", spy)
    metrics.reset()
    items = [(b"a", key), (b"b", key)]
    sigs = rsa.SignerDomain(device="cpu", host_threshold=0).sign_batch(items)
    assert sigs == [rsa.sign(m, k) for m, k in items]
    assert calls == [(32, 32)]  # 4 CRT halves padded to the floor of 32 rows
    snap = metrics.snapshot()
    assert snap["sign.device"] == 2 and "sign.host" not in snap


def test_limb_fault_check_resigns_a_faulted_half(keys, monkeypatch):
    key = keys[2]
    real = rsa_ops.power_batch

    def faulty(*args, **kw):
        out = real(*args, **kw).clone()
        out[0, 0] ^= 1
        return out

    monkeypatch.setattr(rsa_ops, "power_batch", faulty)
    metrics.reset()
    items = [(b"a", key), (b"b", key)]
    sigs = rsa.SignerDomain(device="cpu", host_threshold=0, backend="limb").sign_batch(items)
    assert sigs == [rsa.sign(m, k) for m, k in items]
    snap = metrics.snapshot()
    assert snap["sign.fault"] == 1 and snap["sign.device"] == 2


def test_flags_select_the_backends(monkeypatch):
    monkeypatch.delenv("BFTKV_VERIFY_BACKEND", raising=False)
    monkeypatch.delenv("BFTKV_SIGN_BACKEND", raising=False)
    assert rsa.VerifierDomain(device="cpu").backend == "rns"
    assert rsa.SignerDomain(device="cpu").backend == "rns"
    for name in ("limb", "pallas"):
        monkeypatch.setenv("BFTKV_VERIFY_BACKEND", name)
        assert rsa.VerifierDomain(device="cpu").backend == name
        assert ref_rsa.VerifierDomain().backend == name
    assert rsa.VerifierDomain(device="cpu", backend="rns").backend == "rns"  # caller wins
    monkeypatch.setenv("BFTKV_SIGN_BACKEND", "limb")
    assert rsa.SignerDomain(device="cpu").backend == ref_rsa.SignerDomain().backend == "limb"
    monkeypatch.setenv("BFTKV_SIGN_BACKEND", "pallas")  # no pallas sign backend
    with pytest.raises(ValueError):
        rsa.SignerDomain(device="cpu")
    monkeypatch.setenv("BFTKV_VERIFY_BACKEND", "bogus")
    with pytest.raises(ValueError):
        rsa.VerifierDomain(device="cpu")
    monkeypatch.setenv("BFTKV_TPU_MIN_MODEXP_BATCH", "7")
    assert modexp.BatchModExp(device="cpu").min_batch == 7
    monkeypatch.delenv("BFTKV_TPU_MIN_MODEXP_BATCH")
    assert modexp.BatchModExp(device="cpu").min_batch == 4
