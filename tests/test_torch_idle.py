"""Where the card's time goes, on the CPU: the idle-state ledger on a fake
clock (``ops/idle.py``), the flush phase clocks and launch counts of the
dispatch plane on stubbed kernels, the collector and CPU counters of the
registry, the spans on the profiler's clock and the declared phase of
every span the port opens."""

from __future__ import annotations

import ast
import gc
import json
import re
import threading
import time
from collections import deque
from pathlib import Path

import pytest
import torch

from bftkv_tpu_torch import trace
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import cuda_rns, devbuf, dispatch, idle
from test_torch_devplane import M512, M768, stub_pow
from test_torch_utils import seeded_keys

PORT = Path(__file__).resolve().parents[1] / "bftkv_tpu_torch"


# -- the ledger on a fake clock ---------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _ledger():
    clock, feed = _Clock(), deque()
    return idle.IdleLedger(clock, feed), clock, feed


def test_ledger_states_take_the_first_that_holds():
    """busy over gc over flush_host over queued over no_work, and the
    buckets add up to the time elapsed at every read."""
    led, clock, feed = _ledger()
    steps = [
        (1.0, led.queue_filled),
        (2.0, led.flush_begin),  # items held by a flush beat items queued
        (3.0, led.queue_emptied),
        (4.0, lambda: led.launch_begin("a")),
        (6.0, lambda: led.launch_end("a", 2.0)),
        (8.0, led.flush_end),
    ]
    # A collection under the launch (busy wins) and one in the flush's
    # host time (gc wins).
    feed.extend([(4.5, 4.8), (6.5, 7.0)])
    for t, step in steps:
        clock.t = t
        step()
        assert sum(led.totals().values()) == pytest.approx(t)
    clock.t = 10.0
    got = led.totals()
    assert got == pytest.approx({"busy": 2.0, "gc": 0.5, "flush_host": 3.5,
                                 "queued": 1.0, "no_work": 3.0})
    assert sum(got.values()) == pytest.approx(10.0)


def test_ledger_rebooks_a_late_completion_with_overlapping_launches():
    """Two launches out at once: the time past each one's device interval
    that the other does not cover goes back to the flush's host time (or
    to the collector) once its wait returns."""
    led, clock, feed = _ledger()
    led.flush_begin()
    clock.t = 1.0
    led.launch_begin("a")
    clock.t = 2.0
    led.launch_begin("b")
    clock.t = 5.0
    early = led.totals()
    # Both still out: read as busy since the first enqueue.
    assert early == pytest.approx({"busy": 4.0, "gc": 0.0, "flush_host": 1.0,
                                   "queued": 0.0, "no_work": 0.0})
    led.launch_end("a", 0.5)  # [1, 1.5]; [1.5, 2] goes back, b covers the rest
    clock.t = 6.0
    mid = led.totals()
    assert mid["busy"] == pytest.approx(4.5) and mid["flush_host"] == pytest.approx(1.5)
    feed.append((3.5, 4.0))  # a collection while b was out, past b's interval
    clock.t = 8.0
    led.launch_end("b", 1.0)  # [2, 3]
    late = led.totals()
    assert late == pytest.approx({"busy": 1.5, "gc": 0.5, "flush_host": 6.0,
                                  "queued": 0.0, "no_work": 0.0})
    led.flush_end()
    clock.t = 9.0
    assert led.totals()["no_work"] == pytest.approx(1.0)
    assert sum(led.totals().values()) == pytest.approx(9.0)


def test_ledger_books_a_collection_under_way_when_it_ends():
    """Other threads run inside a collection (its callbacks and finalizers
    are Python code): their events book nothing of it as another state."""
    clock, feed, open_ = _Clock(), deque(), [None]
    led = idle.IdleLedger(clock, feed, open_)
    clock.t = 1.0
    open_[0] = 1.0  # a collection starts
    clock.t = 2.0
    led.flush_begin()  # another thread, inside the collection
    assert led.totals() == pytest.approx({"busy": 0.0, "gc": 1.0, "flush_host": 0.0,
                                          "queued": 0.0, "no_work": 1.0})
    clock.t = 3.0
    feed.append((1.0, 3.0))
    open_[0] = None
    clock.t = 4.0
    assert led.totals() == pytest.approx({"busy": 0.0, "gc": 2.0, "flush_host": 1.0,
                                          "queued": 0.0, "no_work": 1.0})


def test_ledger_without_flushes_books_launches_and_idle_time():
    """A launch outside any flush is busy; the rest is no_work."""
    led, clock, _feed = _ledger()
    clock.t = 1.0
    led.launch_begin("x")
    clock.t = 3.0
    led.launch_end("x", 10.0)  # longer than the host saw: clipped at the return
    clock.t = 4.0
    assert led.totals() == pytest.approx({"busy": 2.0, "gc": 0.0, "flush_host": 0.0,
                                          "queued": 0.0, "no_work": 2.0})


def test_ledger_under_many_threads_loses_no_update():
    """32 threads open and close flushes, queues and launches on one
    ledger with a tiny switch interval: every count comes back to zero,
    the state to ``no_work``, and the buckets still add up."""
    import sys

    led = idle.IdleLedger(gc_feed=deque())
    t0 = led._f

    def worker(k: int) -> None:
        for j in range(200):
            led.queue_filled()
            led.flush_begin()
            led.queue_emptied()
            token = (k, j)
            led.launch_begin(token)
            led.launch_end(token, 1e-6)
            led.flush_end()

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert (led._flushes, led._queued, led._out, led._state()) == (0, 0, {}, "no_work")
    got = led.totals()
    assert sum(got.values()) == pytest.approx(led._f - t0)
    assert all(v >= 0 for v in got.values()) and got["busy"] > 0


def test_a_collection_inside_the_ledgers_lock_does_not_deadlock(monkeypatch):
    """The collector's hook takes no lock: a collection forced while a
    thread holds the ledger's lock, or inside its booking, finishes, and
    ``process.gc.*`` move."""
    before = metrics.snapshot()
    done = threading.Event()

    def forced():
        with idle.ledger._lock:
            gc.collect()
        real = idle.ledger._now
        monkeypatch.setattr(idle.ledger, "_now", lambda: (gc.collect(), real())[1])
        try:
            idle.ledger.totals()
        finally:
            monkeypatch.setattr(idle.ledger, "_now", real)
        done.set()

    t = threading.Thread(target=forced, daemon=True)
    t.start()
    t.join(60)
    assert done.is_set(), "a collection under the ledger's lock deadlocked"
    after = metrics.snapshot()
    assert after["process.gc.collections"] >= before["process.gc.collections"] + 2
    assert after["process.gc.seconds"] > before["process.gc.seconds"]
    assert after["device.idle.gc.seconds"] > before["device.idle.gc.seconds"]


def test_process_cpu_seconds_in_the_snapshot_and_the_prometheus_text():
    t0 = metrics.snapshot()["process.cpu_seconds"]
    deadline = time.process_time() + 0.05
    while time.process_time() < deadline:
        pass
    snap = metrics.snapshot()
    assert snap["process.cpu_seconds"] >= t0 + 0.04
    text = metrics.prometheus()
    assert "# TYPE bftkv_process_cpu_seconds_total counter" in text
    m = re.search(r"^bftkv_process_cpu_seconds_total (\S+)$", text, re.M)
    assert m and float(m.group(1)) >= snap["process.cpu_seconds"]
    for name in idle.BUCKETS.values():
        assert f"# TYPE bftkv_{name.replace('.', '_')}_total counter" in text
        assert name in snap
    # The process's counters outlive a reset of the registry.
    metrics.reset()
    after = metrics.snapshot()
    assert after["process.cpu_seconds"] >= snap["process.cpu_seconds"]
    assert sum(after[n] for n in idle.BUCKETS.values()) >= sum(snap[n] for n in idle.BUCKETS.values())


# -- flushes on stubbed kernels ---------------------------------------------------


def _stub_verify(delay: float):
    """A drop-in for ``cuda_rns.verify_cuda`` that takes ``delay`` seconds
    and answers every row true."""

    def fake(sig_h, em_h, idx, ukey, cn):
        time.sleep(delay)
        return torch.ones(sig_h.shape[0], dtype=torch.int32)

    return fake


@pytest.fixture()
def stubbed(monkeypatch):
    monkeypatch.setattr(cuda_rns, "pow_cuda", stub_pow([]))
    monkeypatch.setattr(cuda_rns, "verify_cuda", _stub_verify(0.02))
    devbuf.reset()
    metrics.reset()
    trace.tracer.reset()
    yield
    devbuf.reset()
    metrics.reset()


def _phase_spans(name: str) -> list[list[dict]]:
    """Each ``<name>.flush`` span's phase children, in order of start."""
    spans = trace.tracer.export()["spans"]
    flushes = [s for s in spans if s["name"] == f"{name}.flush"]
    out = []
    for f in flushes:
        kids = sorted((s for s in spans if s.get("parent") == f["span"]
                       and s["name"].startswith(f"{name}.flush.")), key=lambda s: s["start"])
        out.append(kids)
    return out


def test_phase_samples_follow_a_verify_flush_and_a_sign_flush(stubbed):
    """After one verify flush and one sign flush, each dispatcher has one
    encode, device and decode sample; they fit inside the flush, and its
    phase spans run encode, device, decode (a sign flush: device, decode
    twice, K2 then its fault check)."""
    keys = seeded_keys(2)
    vd = dispatch.VerifyDispatcher(rsa.VerifierDomain(device="cpu", host_threshold=0),
                                   max_batch=64, max_wait=0.001, calibrate=False).start()
    sd = dispatch.SignDispatcher(rsa.SignerDomain(device="cpu", host_threshold=0),
                                 max_batch=8, max_wait=0.001, calibrate=False).start()
    try:
        sigs = sd.submit([(b"m%d" % i, keys[i % 2]) for i in range(4)])
        assert len(sigs) == 4
        assert list(vd.verify([(b"m%d" % i, sigs[i], keys[i % 2].public) for i in range(4)])) == [True] * 4
    finally:
        vd.stop()
        sd.stop()
    snap = metrics.snapshot()
    for name, launches in (("dispatch", 1), ("signdispatch", 2)):
        assert snap[f"{name}.flushes"] == 1
        assert snap[f"{name}.launches"] == launches
        phases = [snap[f"{name}.flush.{p}.sum"] for p in ("encode", "device", "decode")]
        assert all(snap[f"{name}.flush.{p}.count"] == 1 for p in ("encode", "device", "decode"))
        assert all(v > 0 for v in phases)
        assert phases[1] >= 0.02 * launches * 0.9  # the stub's sleep, on the host clock here
        (flush,) = [s for s in trace.tracer.export()["spans"] if s["name"] == f"{name}.flush"]
        assert sum(phases) <= flush["duration"] + 1e-6
        assert flush["attrs"]["launches"] == launches
        (kids,) = _phase_spans(name)
        want = ["encode"] + ["device", "decode"] * launches
        assert [k["name"].rsplit(".", 1)[1] for k in kids] == want
        ends = [k["start"] + k["duration"] for k in kids]
        assert all(ends[i] <= kids[i + 1]["start"] + 1e-6 for i in range(len(kids) - 1))
        assert trace.phase_of(f"{name}.flush.device") == "dispatch"


@pytest.mark.parametrize("use_async", [True, False])
def test_launches_count_the_leases_of_a_flush_with_two_width_groups(stubbed, monkeypatch, use_async):
    """One modexp flush of two limb-width groups takes two leases: two
    launches, not ``ceil(items / max_batch)``; async or not."""
    monkeypatch.setenv("BFTKV_DISPATCH_ASYNC", "on" if use_async else "off")
    d = dispatch.ModexpDispatcher(calibrate=False, device_threshold=2, device="cpu",
                                  max_batch=256, max_wait=0.01).start()
    assert d._async is use_async
    try:
        items = [(3 + i, 65537, M512 if i % 2 else M768) for i in range(6)]
        assert list(d.submit(items)) == [pow(b, e, m) for b, e, m in items]
    finally:
        d.stop()
    snap = metrics.snapshot()
    assert snap["modexpdispatch.flushes"] == 1
    assert sum(r["acquires"] + r["overflows"] for r in devbuf.stats().values()) == 2
    assert snap["modexpdispatch.launches"] == 2
    assert snap["modexpdispatch.flush.device.count"] == 1
    assert snap["modexpdispatch.flush.device.sum"] > 0
    # Async, both groups go on the stream before either is waited on; in
    # turn, the host works between them.
    (kids,) = _phase_spans("modexpdispatch")
    want = ["encode", "device", "decode"] + ([] if use_async else ["device", "decode"])
    assert [k["name"].rsplit(".", 1)[1] for k in kids] == want


class _Event:
    """Stands in for a CUDA event: the fake launcher stamps it."""

    def __init__(self):
        self.cuda_event, self.t = id(self), 0.0

    def elapsed_time(self, end) -> float:
        return 1e3 * (end.t - self.t)


def test_a_launch_on_the_card_books_its_kernels_event_time(monkeypatch):
    """Each kernel launched inside a lease's launch block gets a pair of
    the slot's events to record around it; the launch's device seconds
    are their sum, and its ledger interval starts at the first kernel."""
    events = [(_Event(), _Event()), (_Event(), _Event())]  # the slot's, made earlier
    by_handle = {}
    led, fake, _feed = _ledger()
    monkeypatch.setattr(idle, "ledger", led)
    monkeypatch.setattr(idle, "_clock", fake)
    fc = idle.FlushClock("testdispatch")
    with idle.flushing(fc):
        lt = idle.Launch(events)
    fake.t = 1.0
    lt.enqueue()

    def launcher():  # the C launcher: a 4 ms kernel between its two events
        before, after = idle.kernel_events()
        by_handle.update({e.cuda_event: e for pair in events for e in pair})
        by_handle[before].t, by_handle[after].t = fake.t, fake.t + 0.004

    with idle.launching(lt):
        fake.t = 1.5
        launcher()
        fake.t = 1.6
        launcher()
    assert idle.kernel_events() == (None, None)  # outside the block: untimed
    assert lt.kernels == events
    fake.t = 3.0
    lt.settle()
    assert fc.device_s == pytest.approx(0.008)
    # Busy from the first kernel for the kernels' 8 ms; the rest of the
    # launch, from its first upload, is the flush's host time.
    got = led.totals()
    assert got["busy"] == pytest.approx(0.008)
    assert got["flush_host"] == pytest.approx(3.0 - 0.008)


def test_a_host_flush_books_its_time_as_encode(monkeypatch):
    """A flush that launches nothing: no launch counted, its host time is
    encode, and the ledger saw it as flush_host."""
    metrics.reset()
    clock = idle.FlushClock("testdispatch")
    time.sleep(0.01)
    clock.finish()
    snap = metrics.snapshot()
    assert "testdispatch.launches" not in snap
    assert snap["testdispatch.flush.encode.sum"] >= 0.009
    assert snap["testdispatch.flush.device.sum"] == 0 and snap["testdispatch.flush.decode.sum"] == 0


# -- spans --------------------------------------------------------------------------


def test_a_span_starts_on_the_profilers_clock(tmp_path):
    """A span opened with a ``record_function`` range: its start equals the
    range's ``ts`` · 1000 + ``baseTimeNanoseconds`` of a CPU profile's
    chrome trace within a millisecond."""
    from torch.profiler import ProfilerActivity, profile

    assert trace.tracer.enabled
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("dispatch.wait", profile=True) as sp:
            torch.ones(64).sum()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    (ev,) = [e for e in doc["traceEvents"] if e.get("name") == "dispatch.wait"]
    start_ns = ev["ts"] * 1000 + doc["baseTimeNanoseconds"]
    assert abs(start_ns - sp.start * 1e9) < 1e6


def test_no_record_function_with_tracing_off(monkeypatch):
    monkeypatch.setattr(trace.tracer, "enabled", False)
    import torch.profiler as tp

    def boom(*_a, **_k):
        raise AssertionError("record_function with tracing off")

    monkeypatch.setattr(tp, "record_function", boom)
    with trace.span("dispatch.wait", profile=True):
        pass
    assert trace.profile_open("dispatch.flush") is None
    clock = idle.FlushClock("dispatch")
    assert clock.span is None
    clock.finish(ok=False)


#: Dispatcher names a ``{self.name}``/``{name}`` span name takes.
_DISPATCHERS = ("dispatch", "signdispatch", "modexpdispatch")


def _span_names() -> set[str]:
    """Every span name the port opens (``trace.span``, ``trace.detached``,
    ``trace.child``), f-strings expanded: a dispatcher's own name for a
    leading field, ``x`` for any other, each phase for ``{kind}``."""
    names: set[str] = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            fn = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", None)
            pos = {"span": 0, "detached": 0, "child": 1, "_phase": 0}.get(fn)
            if pos is None or len(node.args) <= pos:
                continue
            arg = node.args[pos]
            if fn == "_phase":  # FlushClock's phases: <name>.flush.<kind>
                names |= {f"{d}.flush.{k}" for d in _DISPATCHERS for k in ("encode", "device", "decode")}
                continue
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                parts = [v.value if isinstance(v, ast.Constant) else None for v in arg.values]
                if parts[0] is None:
                    rest = "".join(p if p is not None else "x" for p in parts[1:])
                    names |= {d + rest for d in _DISPATCHERS}
                else:
                    names.add("".join(p if p is not None else "x" for p in parts))
    return names


def test_every_span_the_port_opens_has_a_declared_phase():
    names = _span_names()
    assert {"dispatch.wait", "dispatch.flush", "signdispatch.launch",
            "modexpdispatch.flush.decode", "rpc.x"} <= names
    prefixes = [k for k in trace.SPAN_PHASES if k.endswith(".")]
    undeclared = sorted(n for n in names
                        if n not in trace.SPAN_PHASES and not any(n.startswith(p) for p in prefixes))
    assert not undeclared, undeclared
    for stale in ("verify.flush", "sign.flush", "modexp.flush"):
        assert stale not in trace.SPAN_PHASES
    for d in _DISPATCHERS:
        assert trace.phase_of(f"{d}.flush") == trace.phase_of(f"{d}.launch") == "dispatch"
