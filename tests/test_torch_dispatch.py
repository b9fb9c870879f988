"""The port's dispatchers, and the port's domains inside the reference protocol.

The reference dispatchers take duck-typed domains
(``VerifyDispatcher(verifier=...)``, ``SignDispatcher(signer=...)``), so
a loopback cluster of the reference protocol can run its whole signed
write and read on the port's domains (plain versions, ``device="cpu"``)
with no edit to the reference.  The committed values must equal those of
the same sequence on the reference's own domains.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from bftkv_tpu.crypto import vcache
from bftkv_tpu.ops import dispatch as ref_dispatch
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import dispatch
from cluster_utils import start_cluster
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def keys():
    return [rsa.generate(1024, seed=s) for s in (10, 11, 12)]


def _join_all(threads, timeout=120):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)


def test_verify_dispatcher_scatters_to_the_right_futures(keys):
    """Concurrent submitters with distinct valid/forged mixes each get
    their own verdicts back, from shared flushes."""
    metrics.reset()
    d = dispatch.VerifyDispatcher(
        rsa.VerifierDomain(device="cpu", host_threshold=0),
        max_batch=4096, max_wait=0.05, calibrate=False,
    ).start()
    results, want = {}, {}
    try:
        def worker(t):
            key = keys[t % len(keys)]
            items = []
            for j in range(3 + t % 3):
                msg = b"t%d-%d" % (t, j)
                sig = rsa.sign(msg, key)
                if (t + j) % 3 == 0:
                    sig = sig[:-1] + bytes([sig[-1] ^ 1])
                items.append((msg, sig, key.public))
            want[t] = [(t + j) % 3 != 0 for j in range(len(items))]
            results[t] = d.verify(items)

        _join_all([threading.Thread(target=worker, args=(t,)) for t in range(8)])
    finally:
        d.stop()
    for t in range(8):
        np.testing.assert_array_equal(results[t], want[t])
    snap = metrics.snapshot()
    assert snap["dispatch.verifies"] == sum(len(w) for w in want.values())
    assert snap["dispatch.flushes"] < 8  # coalesced
    assert snap["verify.device"] == snap["dispatch.verifies"]


def test_sign_dispatcher_scatters_to_the_right_futures(keys):
    metrics.reset()
    d = dispatch.SignDispatcher(
        rsa.SignerDomain(device="cpu", host_threshold=0),
        max_batch=64, max_wait=0.05, calibrate=False,
    ).start()
    results = {}
    try:
        def worker(t):
            key = keys[t % len(keys)]
            msgs = [b"s%d-%d" % (t, j) for j in range(2)]
            results[t] = (key, msgs, d.submit([(m, key) for m in msgs]))

        _join_all([threading.Thread(target=worker, args=(t,)) for t in range(4)])
    finally:
        d.stop()
    for key, msgs, sigs in results.values():
        assert sigs == [rsa.sign(m, key) for m in msgs]
    assert metrics.snapshot()["sign.device"] == 8
    # A stopped dispatcher serves the caller inline.
    assert d.sign(b"after stop", keys[0]) == rsa.sign(b"after stop", keys[0])


def test_dispatcher_errors_reach_the_caller(keys):
    class Broken:
        device = None
        host_threshold = 0

        def verify_batch(self, items):
            raise RuntimeError("kernel launch failed")

    d = dispatch.VerifyDispatcher(Broken(), max_wait=0.001, calibrate=False).start()
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            d.verify([(b"m", b"s", keys[0].public)])
    finally:
        d.stop()


def test_calibration_pins_only_a_cpu_device(monkeypatch):
    monkeypatch.delenv("BFTKV_DISPATCH_CROSSOVER", raising=False)
    cal = dispatch.calibration(force=True, device="cpu")
    assert cal["prefer_host"] and cal["verify_crossover"] == dispatch.ALWAYS_HOST
    monkeypatch.setenv("BFTKV_DISPATCH_CROSSOVER", "48")
    cal = dispatch.calibration(force=True, device="cpu")
    assert cal["source"] == "override" and cal["verify_crossover"] == 48
    assert not cal["prefer_host"]
    monkeypatch.setenv("BFTKV_DISPATCH_CROSSOVER", "0")
    assert dispatch.calibration(force=True, device="cpu")["prefer_host"]
    monkeypatch.delenv("BFTKV_DISPATCH_CROSSOVER")
    dispatch.calibration(force=True, device="cpu")


def test_install_get_uninstall():
    v = dispatch.install(
        dispatch.VerifyDispatcher(rsa.VerifierDomain(device="cpu"), calibrate=False)
    )
    s = dispatch.install_signer(
        dispatch.SignDispatcher(rsa.SignerDomain(device="cpu"), calibrate=False)
    )
    try:
        assert dispatch.get() is v and dispatch.get_signer() is s
    finally:
        dispatch.uninstall()
        dispatch.uninstall_signer()
    assert dispatch.get() is None and dispatch.get_signer() is None


def _write_read(cluster, var: bytes, value: bytes) -> bytes:
    c = cluster.clients[0]
    c.write(var, value)
    return c.read(var)


def test_reference_cluster_commits_through_port_domains(monkeypatch):
    """A 4-replica loopback cluster of the reference protocol writes and
    reads on the port's domains, with the same committed values as on
    the reference's own domains — and the port's device counters move."""
    # Verifies must reach the domains, not the verified-signature memo.
    monkeypatch.setattr(vcache, "_ENABLED", False)
    monkeypatch.setattr(ref_dispatch, "_CALIBRATION", None)
    cluster = start_cluster(4, 1, 4, bits=1024)
    try:
        # Reference domains (calibrated: the CPU backend pins host).
        ref_dispatch.install(ref_dispatch.VerifyDispatcher(max_wait=0.005))
        ref_dispatch.install_signer(ref_dispatch.SignDispatcher(max_wait=0.005))
        try:
            ref_vals = [_write_read(cluster, b"port/%d" % i, b"v%d" % i) for i in range(2)]
        finally:
            ref_dispatch.uninstall_all()

        # Port domains; a positive crossover un-pins the CPU backend so
        # every batch really runs the port's plain kernels.
        monkeypatch.setenv("BFTKV_DISPATCH_CROSSOVER", "1")
        ref_dispatch._CALIBRATION = None
        metrics.reset()
        ref_dispatch.install(ref_dispatch.VerifyDispatcher(
            verifier=rsa.VerifierDomain(device="cpu"), max_wait=0.005,
        ))
        ref_dispatch.install_signer(ref_dispatch.SignDispatcher(
            signer=rsa.SignerDomain(device="cpu", host_threshold=0), max_wait=0.01,
        ))
        try:
            port_vals = [
                _write_read(cluster, b"port/%d" % i, b"v%d" % i) for i in range(2)
            ]
        finally:
            ref_dispatch.uninstall_all()
    finally:
        cluster.stop()
    assert ref_vals == port_vals == [b"v0", b"v1"]
    snap = metrics.snapshot()
    assert snap.get("verify.device", 0) > 0
    assert snap.get("sign.device", 0) > 0
    assert "sign.fault" not in snap
