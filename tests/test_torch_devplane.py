"""The port's dispatch plane on the CPU: staging rings (``ops/devbuf.py``),
pipelined flush workers, async launch/complete, calibration, safe
stop/restart — the properties of ``tests/test_device_plane.py`` held
against ``bftkv_tpu_torch``.

The K2 launches here go to a stub of ``cuda_rns.pow_cuda`` that decodes
the STAGED tensors (base halves, exponent nibbles, key index, the moduli
rebuilt from their staged residues) and answers from host ``pow``, as
the reference's tests stub ``_jitted_pow``: a staging bug — a wrong live
row, a wrong pad, a slot reused while its launch is in flight — shows as
a mismatch against independently computed values.
"""

from __future__ import annotations

import sys
import threading
import time

import pytest
import torch

from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import cuda_rns, devbuf, dispatch, rns

M512 = (1 << 511) + 187  # odd pseudo-moduli, two limb-width classes
M768 = (1 << 767) + 183
CPU = torch.device("cpu")


# -- buffer ring ownership ----------------------------------------------------


def _ring(key: str, slots: int) -> devbuf.BufferRing:
    return devbuf.BufferRing(key, {"a": ((4,), torch.int32)}, CPU, slots=slots, width="t")


def test_ring_never_hands_out_inflight_slot():
    ring = _ring("t:ring", 2)
    s1 = ring.acquire()
    s2 = ring.acquire()
    assert s1 is not None and s2 is not None and s1 is not s2
    assert s1.in_flight and s2.in_flight
    # Saturated: acquire must not block liveness — None tells the caller
    # to take a fresh slot, and the overflow is counted.
    assert ring.acquire() is None
    assert ring.overflows == 1
    f = ring.fresh()
    assert f.in_flight and f is not s1 and f is not s2
    ring.release(f)  # unpooled: never enters the ring
    assert ring.acquire() is None
    seq1 = s1.seq
    ring.release(s1, seq1)
    s3 = ring.acquire()
    assert s3 is s1 and s3.seq == seq1 + 1  # recycled only after release
    # A stale release (the slot was re-acquired since) and a double
    # release are detected, not silent.
    with pytest.raises(RuntimeError, match="stale release"):
        ring.release(s3, seq1)
    ring.release(s2)
    with pytest.raises(RuntimeError, match="not in flight"):
        ring.release(s2)


def test_ring_acquire_waits_for_release():
    ring = _ring("t:wait", 1)
    s = ring.acquire()
    t = threading.Timer(0.05, ring.release, args=(s,))
    t.start()
    got = None
    try:
        got = ring.acquire(timeout=2.0)
        assert got is s  # the release woke the waiter within the timeout
    finally:
        t.cancel()
        t.join(5)
        if got is not None:
            ring.release(got)


def test_slot_is_one_tensor_set_on_the_cpu():
    slot = devbuf.Slot({"x": ((2, 3), torch.uint8)}, CPU)
    slot["x"][:] = 7
    assert slot.dev["x"] is slot.host["x"]
    assert slot.upload(("x",))["x"].sum().item() == 42
    assert slot.event is None  # nothing to wait for on the CPU
    slot.record()
    slot.wait()


# -- stub K2 --------------------------------------------------------------------


def _crt_int(ctx, residues) -> int:
    """The modulus rebuilt from its staged base-B residues."""
    m = 0
    for r, p in zip(residues, ctx.pb):
        mi = ctx.M // p
        m += ((int(r) * pow(mi % p, -1, p)) % p) * mi
    return m % ctx.M


def _sigma(ctx, v: int) -> list[int]:
    return [(v % p) * pow((ctx.M // p) % p, -1, p) % p for p in ctx.pb]


def stub_pow(seen: list, crash_bases: frozenset = frozenset()):
    """A drop-in for ``cuda_rns.pow_cuda`` answering from host ``pow`` on
    the staged operands; it snapshots the rings from inside the launch."""

    def fake(base_h, nib_t, idx, ukey, cn):
        ctx = rns.context(cn.digits, 16 * cn.digits)
        seen.append({"digits": cn.digits, "rings": devbuf.stats()})
        mods = [_crt_int(ctx, row[: cn.k]) for row in ukey[0].tolist()]
        out = torch.empty((base_h.shape[0], cn.k), dtype=torch.int64)
        for j in range(base_h.shape[0]):
            b = int.from_bytes(bytes(base_h[j].tolist()), "little")
            if b in crash_bases:
                raise RuntimeError("injected kernel crash")
            e = 0
            for nib in nib_t[:, j].tolist():
                e = (e << 4) | nib
            out[j] = torch.tensor(_sigma(ctx, pow(b, e, mods[int(idx[j])])))
        return out

    return fake


@pytest.fixture()
def stub_kernel(monkeypatch):
    seen: list = []
    monkeypatch.setattr(cuda_rns, "pow_cuda", stub_pow(seen))
    devbuf.reset()
    metrics.reset()
    yield seen
    devbuf.reset()
    metrics.reset()


def _modexp_dispatcher(**kw) -> dispatch.ModexpDispatcher:
    return dispatch.ModexpDispatcher(
        calibrate=False, device_threshold=2, device="cpu", **kw
    )


# -- staged parity: two width classes, interleaved tenants ---------------------


def test_interleaved_widths_scatter_back_bit_for_bit(stub_kernel):
    """Two tenants interleave RSA-512- and RSA-768-class items through the
    async dispatcher; every result equals host ``pow``, and every launch
    held its staging slot in flight."""
    d = _modexp_dispatcher(max_batch=256, max_wait=0.02).start()
    results: dict = {}
    try:

        def tenant(tid: int) -> None:
            items = [(3 + tid * 100 + i, 65537, M512 if i % 2 else M768) for i in range(8)]
            results[tid] = (d.submit(items), items)

        threads = [threading.Thread(target=tenant, args=(t,)) for t in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        d.stop()
    for got, items in results.values():
        assert list(got) == [pow(b, e, m) for b, e, m in items]
    assert {s["digits"] for s in stub_kernel} == {32, 48}
    for s in stub_kernel:
        assert [r for r in s["rings"].values() if r["in_flight"] > 0], (
            "kernel ran without an in-flight staging slot"
        )
    for r in devbuf.stats().values():
        assert r["in_flight"] == 0 and r["acquires"] >= 1
    snap = metrics.snapshot()
    assert snap.get("modexp.device", 0) == 16
    assert "dispatch.launch_rtt" in snap  # the EWMA observed the round trip


def test_kernel_crash_mid_flush_releases_slots_and_reaches_callers(monkeypatch):
    """A launch that dies mid-flush releases its staging slot (and the
    other width group's) and its error reaches every caller of that
    flush.  Divergence from the reference, which answers the crashed
    group from the host: the port has no fallback that hides the device."""
    seen: list = []
    sentinel = 424243  # base staged for the doomed 512-class launch
    monkeypatch.setattr(cuda_rns, "pow_cuda", stub_pow(seen, frozenset({sentinel})))
    devbuf.reset()
    metrics.reset()
    d = _modexp_dispatcher(max_batch=256, max_wait=0.01).start()
    try:
        items = [(7, 3, M768), (sentinel, 65537, M512), (5, 65537, M512)]
        with pytest.raises(RuntimeError, match="injected kernel crash"):
            d.submit(items)
        snap = metrics.snapshot()
        assert "modexp.host" not in snap  # nothing was answered from the host
        assert devbuf.stats() and all(r["in_flight"] == 0 for r in devbuf.stats().values())
        # The rings are healthy: the next flush reuses them and succeeds.
        ok = d.submit([(11, 65537, M512), (13, 65537, M512)])
        assert list(ok) == [pow(11, 65537, M512), pow(13, 65537, M512)]
    finally:
        d.stop()
        devbuf.reset()
        metrics.reset()


def test_power_mod_rns_devbuf_off_matches_on(stub_kernel, monkeypatch):
    """BFTKV_DISPATCH_DEVBUF=off: throwaway staging, identical results."""
    bases, exps, mods = [9, 10, 11], [65537, 3, 17], [M512] * 3
    want = [pow(b, e, m) for b, e, m in zip(bases, exps, mods)]
    assert rns.power_mod_rns(bases, exps, mods, n_bits=512, device="cpu") == want
    assert devbuf.stats()  # the ring path engaged
    devbuf.reset()
    monkeypatch.setenv("BFTKV_DISPATCH_DEVBUF", "off")
    assert rns.power_mod_rns(bases, exps, mods, n_bits=512, device="cpu") == want
    assert devbuf.stats() == {}  # no ring was minted


def test_a_saturated_ring_overflows_to_a_fresh_slot(stub_kernel, monkeypatch):
    """One slot, two deferred launches in flight: the second takes a fresh
    slot (counted), both answer right, and the pooled slot comes back."""
    monkeypatch.setenv("BFTKV_DISPATCH_DEVBUF_RING", "1")
    d1 = rns.power_mod_rns([3], [65537], [M512], n_bits=512, defer=True, device="cpu")
    d2 = rns.power_mod_rns([5], [65537], [M512], n_bits=512, defer=True, device="cpu")
    (ring,) = devbuf.stats().values()
    assert ring["slots"] == 1 and ring["in_flight"] == 1 and ring["overflows"] == 1
    assert d2.wait() == [pow(5, 65537, M512)]
    assert d1.wait() == [pow(3, 65537, M512)]
    (ring,) = devbuf.stats().values()
    assert ring["in_flight"] == 0
    assert metrics.snapshot()["devbuf.overflow{width=32}"] == 1


def test_modexp_dispatcher_routes_ineligible_and_declined_items_to_the_host(stub_kernel):
    hostile = rns.context(32, 512).pb[0] * ((1 << 500) + 1)  # shares a channel prime
    items = [(3, 5, M512), (4, 5, 1 << 20), (-2, 3, M512), (6, 7, hostile), (5, 3, M768)]
    d = _modexp_dispatcher(max_batch=64, max_wait=0.001).start()
    try:
        # Ineligible items decline the async launch: the synchronous path.
        assert d.submit(items) == [pow(b, e, m) for b, e, m in items]
        # All eligible, one group declined by the RNS bases: host for it.
        items2 = [(6, 7, hostile), (8, 9, hostile), (5, 3, M768)]
        assert d.submit(items2) == [pow(b, e, m) for b, e, m in items2]
    finally:
        d.stop()
    snap = metrics.snapshot()
    # The hostile modulus is 512-bit: its width group, M512's item with
    # it, is declined whole.  Only the M768 items ran on the device.
    assert snap["modexp.device"] == 2
    assert snap["modexp.host"] == 6
    assert d.powmod(2, 10, M512) == pow(2, 10, M512)  # stopped: inline


# -- async dispatch layer ---------------------------------------------------------


class _FakeAsyncDispatcher(dispatch._BatchDispatcher):
    """Deterministic async subclass: launches record order, block on
    per-launch events, and can be told to raise at completion."""

    name = "modexpdispatch"

    def __init__(self, **kw):
        super().__init__(**kw)
        self.launched: list = []
        self.finalized: list = []
        self.gates: dict = {}
        self.fail = set()

    def _run_batch(self, items):
        gate = self.gates.get(items[0])
        if gate is not None:
            assert gate.wait(10)
        return [("sync", it) for it in items]

    def _launch_batch(self, items):
        tag = items[0]
        self.launched.append(tag)
        gate = self.gates.get(tag)

        def complete():
            if gate is not None:
                assert gate.wait(10)
            if tag in self.fail:
                raise RuntimeError(f"completion failed: {tag}")
            self.finalized.append(tag)
            return [("async", it) for it in items]

        return complete


def _wait_until(cond, timeout: float = 5.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        time.sleep(0.005)


def test_async_flushes_finalize_fifo_and_overlap():
    """Flush N+1 launches while flush N's completion is pending, and
    completions scatter FIFO."""
    d = _FakeAsyncDispatcher(max_batch=8, max_wait=0.005, calibrate=False, pipeline=1)
    assert d._async  # BFTKV_DISPATCH_ASYNC defaults on
    d.start()
    assert d._pool.drain is not None
    g1, g2 = threading.Event(), threading.Event()
    d.gates.update({"a1": g1, "b1": g2})
    out: dict = {}
    try:
        t1 = threading.Thread(target=lambda: out.update(r1=d.submit(["a1", "a2"])))
        t1.start()
        _wait_until(lambda: d.launched)
        assert d.launched == ["a1"]
        t2 = threading.Thread(target=lambda: out.update(r2=d.submit(["b1"])))
        t2.start()
        _wait_until(lambda: len(d.launched) == 2)
        assert d.launched == ["a1", "b1"]
        assert not d.finalized
        g2.set()  # completion 2 ready first...
        time.sleep(0.05)
        assert d.finalized == []  # ...but FIFO holds it behind 1
        g1.set()
        t1.join(10)
        t2.join(10)
        assert not t1.is_alive() and not t2.is_alive()
        assert d.finalized == ["a1", "b1"]
        assert out["r1"] == [("async", "a1"), ("async", "a2")]
        assert out["r2"] == [("async", "b1")]
    finally:
        g1.set()
        g2.set()
        d.stop()
    assert d._pool is None  # stop() closed the pool, drain included


def test_async_completion_error_reaches_callers_only_of_that_flush():
    d = _FakeAsyncDispatcher(max_batch=4, max_wait=0.002, calibrate=False, pipeline=1).start()
    d.fail.add("bad")
    try:
        with pytest.raises(RuntimeError, match="completion failed"):
            d.submit(["bad"])
        assert d.submit(["fine"]) == [("async", "fine")]
    finally:
        d.stop()


def test_async_off_restores_synchronous_flush(monkeypatch):
    monkeypatch.setenv("BFTKV_DISPATCH_ASYNC", "off")

    class _NeverAsync(_FakeAsyncDispatcher):
        def _launch_batch(self, items):
            pytest.fail("_launch_batch called with ASYNC=off")

    d = _NeverAsync(max_batch=4, max_wait=0.002, calibrate=False).start()
    try:
        assert not d._async and d._pool.drain is None
        assert d.submit(["x", "y"]) == [("sync", "x"), ("sync", "y")]
    finally:
        d.stop()


def test_pipeline_two_runs_two_flushes_at_once(monkeypatch):
    """Two flush workers: a second flush runs while the first is still in
    its launch; pipeline defaults to 1 for a dispatcher with no device."""
    monkeypatch.setenv("BFTKV_DISPATCH_ASYNC", "off")
    assert _FakeAsyncDispatcher(calibrate=False).start().pipeline == 1
    d = _FakeAsyncDispatcher(max_batch=1, max_wait=0.0, calibrate=False, pipeline=2)
    entered = []
    gate = threading.Event()
    real = d._run_batch

    def run(items):
        entered.append(items[0])
        assert gate.wait(10)
        return real(items)

    d._run_batch = run
    d.start()
    out: dict = {}
    try:
        threads = [
            threading.Thread(target=lambda t=t: out.update({t: d.submit([t])})) for t in "xy"
        ]
        for t in threads:
            t.start()
        _wait_until(lambda: len(entered) == 2)  # both flushes in flight
        gate.set()
        for t in threads:
            t.join(10)
        assert out == {"x": [("sync", "x")], "y": [("sync", "y")]}
    finally:
        gate.set()
        d.stop()


# -- stop and restart strand no batch ----------------------------------------------


def test_a_hand_off_to_a_closed_pool_is_flushed_by_its_holder():
    """The reference's caveat (``dispatch.py:270``): a collector abandoned
    by a timed-out stop() can put its batch on the drained queue of the
    old pool after a restart.  Here the old pool refuses the hand-off, so
    the collector flushes the batch itself."""
    d = _FakeAsyncDispatcher(max_batch=4, max_wait=0.001, calibrate=False, pipeline=2)
    d._async = False
    d.start()
    old = d._pool
    d.stop()
    d.start()  # a new generation
    try:
        assert d._pool is not old and old.closed
        p = dispatch._Pending(["late"])
        assert old.hand_off([p]) is False
        assert old.work.empty()  # the refused batch is on no queue
        # What the abandoned collector does with a refused hand-off:
        old.inflight.acquire()
        if not old.hand_off([p]):
            try:
                d._flush([p], old)
            finally:
                old.inflight.release()
        assert p.event.wait(5) and p.result == [("sync", "late")]
        assert d.submit(["new"]) == [("sync", "new")]
    finally:
        d.stop()


def test_a_completion_after_the_drain_closed_is_finalized_by_its_flush():
    d = _FakeAsyncDispatcher(max_batch=4, max_wait=0.001, calibrate=False, pipeline=1).start()
    old = d._pool
    d.stop()
    p = dispatch._Pending(["late"])
    # A flush worker that outlived stop() hands its launch to the closed
    # drain: the flush finalizes it in place.
    d._flush([p], old)
    assert p.event.is_set() and p.result == [("async", "late")]


def test_stop_and_restart_under_load_serve_every_caller():
    """Submitters keep coming while the dispatcher stops and restarts; with
    a short stop timeout some threads are abandoned mid-flush.  Every
    caller still gets its own answer (served by a pool, by the abandoned
    thread, or inline after the stop)."""
    d = _FakeAsyncDispatcher(max_batch=2, max_wait=0.001, calibrate=False, pipeline=2)
    d.STOP_TIMEOUT = 0.01
    real = d._run_batch

    def slow(items):
        time.sleep(0.002)
        return real(items)

    d._run_batch = slow
    d.start()
    results: dict = {}

    def caller(i):
        results[i] = d.submit([i])

    threads = [threading.Thread(target=caller, args=(i,)) for i in range(60)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: widen every race window
    try:
        for n, t in enumerate(threads):
            t.start()
            if n % 10 == 9:
                d.stop()
                d.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads), "a caller was stranded"
    finally:
        sys.setswitchinterval(interval)
        d.stop()
    assert sorted(results) == list(range(60))
    assert all(results[i] in ([("sync", i)], [("async", i)]) for i in range(60))


# -- calibration lifecycle -----------------------------------------------------


def test_crossover_override_and_recalibrate(monkeypatch):
    try:
        monkeypatch.setenv("BFTKV_DISPATCH_CROSSOVER", "48")
        cal = dispatch.calibration(force=True, device="cpu")
        assert cal["source"] == "override"
        assert cal["verify_crossover"] == 48
        assert cal["prefer_host"] is False
        monkeypatch.setenv("BFTKV_DISPATCH_CROSSOVER", "0")
        cal = dispatch.calibration(force=True, device="cpu")
        assert cal["prefer_host"] is True
        assert cal["verify_crossover"] == dispatch.ALWAYS_HOST
        # recalibrate() re-applies the fresh verdict to the installed
        # dispatchers without restarting them.
        monkeypatch.setenv("BFTKV_DISPATCH_CROSSOVER", "33")
        d = dispatch.install(dispatch.VerifyDispatcher(
            rsa.VerifierDomain(device="cpu"), max_batch=8, max_wait=0.001
        ))
        s = dispatch.install_signer(dispatch.SignDispatcher(
            rsa.SignerDomain(device="cpu"), max_batch=8, max_wait=0.001
        ))
        try:
            cal = dispatch.recalibrate()
            assert cal["verify_crossover"] == 33
            assert d.verifier.host_threshold == 33
            assert s.signer.host_threshold == rsa.SignerDomain.HOST_CROSSOVER
        finally:
            dispatch.uninstall_all()
        assert dispatch.get() is None and dispatch.get_signer() is None
    finally:
        monkeypatch.delenv("BFTKV_DISPATCH_CROSSOVER", raising=False)
        dispatch.calibration(force=True, device="cpu")


def test_launch_rtt_ewma_feeds_observed_calibration(monkeypatch):
    monkeypatch.setattr(dispatch, "_LAUNCH_RTT_EWMA", None)
    dispatch.note_launch_rtt(0.100)
    dispatch.note_launch_rtt(0.200)
    assert dispatch.observed_launch_rtt() == pytest.approx(0.8 * 0.100 + 0.2 * 0.200)
    assert metrics.snapshot()["dispatch.launch_rtt"] == pytest.approx(0.12)
    # A CPU device stays pinned whatever the EWMA says.
    cal = dispatch.calibration(force=True, device="cpu")
    assert cal["backend"] == "cpu" and cal["prefer_host"] is True


def test_flush_failpoint_stalls_the_flush(monkeypatch):
    from bftkv_tpu_torch.faults import failpoint as fp

    d = _FakeAsyncDispatcher(max_batch=4, max_wait=0.001, calibrate=False, pipeline=1).start()
    reg = fp.arm(7)
    try:
        reg.add("dispatch.flush", "stall", seconds=0.05, rule_id="stall")
        t0 = time.perf_counter()
        assert d.submit(["x"]) == [("async", "x")]
        assert time.perf_counter() - t0 >= 0.05
    finally:
        fp.disarm()
        d.stop()
