"""Why the card sits idle, as the process sees it: the idle-state ledger,
each flush's phase clocks, and the interpreter's collector and CPU.

**The ledger** (:data:`ledger`) books every second of the process's
life into exactly one bucket; the first state that holds wins:

1. ``busy``: a kernel runs on the card.  A launch's interval starts at
   the host clock of its first kernel call and lasts its kernels' device
   seconds, the card's own (CUDA events around each kernel,
   :func:`kernel_events`), known once its wait returns;
2. ``gc``: the interpreter's collector runs;
3. ``flush_host``: a dispatcher's flush holds items and no launch is on
   the card (encoding, staging, waiting for the interpreter lock after the
   card finished, decoding);
4. ``queued``: items wait in a dispatcher's queue for its batch window
   and no flush has taken them;
5. ``no_work``: none of these: nothing was submitted.

Until a launch's wait returns, the time since its first upload reads as
``busy``; at the return, the part past its device interval that no other
launch covers goes back to the state that held then (``gc``, else
``flush_host`` for a launch of a flush).  So a read while a launch is out
books that stretch provisionally, and a later read corrects it.

**Flush phases** (:class:`FlushClock`): a dispatcher flush, from taking
its batch to scattering the results, is host time before its first upload
(``<name>.flush.encode``), launches on the card (``<name>.flush.device``,
the sum of their device seconds), and host time after a launch's result
is back until the next upload or the scatter (``<name>.flush.decode``:
for a sign flush σ→ints, the CRT recombination, the fault check's host
side and the byte conversion).  A flush that launches nothing books its
whole host time as encode.  ``<name>.launches`` counts the device
launches the flush's leases made.  With tracing on, the flush is a
``<name>.flush`` span whose phases are child spans and
``torch.profiler.record_function`` ranges, on the profiler's clock.

**The process**: a ``gc.callbacks`` hook times each collection, in all
and by generation (it takes no lock: a collection can start while its
thread holds the ledger's), and ``os.times()`` gives the CPU seconds at
read time.

All of it reaches the registry through one collector
(:meth:`Registry.add_collector`), which settles the ledger whenever the
registry is read: counters ``device.busy.seconds``,
``device.idle.gc.seconds``, ``device.idle.flush_host.seconds``,
``device.idle.queued.seconds``, ``device.idle.no_work.seconds``,
``process.gc.seconds``, ``process.gc.collections``, the same by
generation ``process.gc.gen<g>.seconds`` and
``process.gc.gen<g>.collections`` (``g`` 0–2; generation 2 is the full
pass that :mod:`bftkv_tpu_torch.gcpolicy` keeps off the serving path),
and ``process.cpu_seconds``.
"""

from __future__ import annotations

import contextlib
import gc
import os
import threading
import time
from collections import deque

from bftkv_tpu_torch import trace
from bftkv_tpu_torch.devtools.lockwatch import named_lock
from bftkv_tpu_torch.metrics import registry as metrics

__all__ = ["BUCKETS", "FlushClock", "IdleLedger", "Launch", "current_flush", "current_launch",
           "flushing", "kernel_events", "launching", "ledger"]

#: The ledger's states in priority order, and the counter of each.
BUCKETS = {
    "busy": "device.busy.seconds",
    "gc": "device.idle.gc.seconds",
    "flush_host": "device.idle.flush_host.seconds",
    "queued": "device.idle.queued.seconds",
    "no_work": "device.idle.no_work.seconds",
}

_clock = time.perf_counter

# -- the collector's clock ------------------------------------------------------
# Written only by the callback, which runs with the interpreter lock held and
# never nests (a collection cannot start inside another); read by the ledger.

#: The start of the collection under way, else ``None``.
_gc_open: list = [None]
#: Finished collections as (start, end), consumed by the process ledger.
_gc_done: deque = deque(maxlen=1 << 16)
#: [collections, seconds] since the hook went in, in all and by generation.
_gc_total = [0, 0.0]
_gc_by_gen = [[0, 0.0] for _ in range(3)]


def _on_gc(phase: str, info: dict) -> None:
    if phase == "start":
        _gc_open[0] = _clock()
        return
    t, t0 = _clock(), _gc_open[0]
    if t0 is None:  # the hook went in during this collection
        return
    # Done before no longer open: a reader in between sees it twice, never
    # not at all.
    _gc_done.append((t0, t))
    _gc_open[0] = None
    for tot in (_gc_total, _gc_by_gen[info["generation"]]):
        tot[0] += 1
        tot[1] += t - t0


class IdleLedger:
    """The process's accumulator of the card's states (module docstring).

    ``clock``, ``gc_feed`` (a deque of finished collections as ``(start,
    end)``) and ``gc_open`` (``[start]`` of the collection under way, or
    ``[None]``) are seams for tests.  Time up to the *frontier* (the
    earliest enqueue of a launch still out or start of a collection under
    way, else the last event) is booked for good; what lies past it is
    booked on every read.  Other threads can run inside a collection (its
    callbacks and finalizers are Python code), so one may be under way
    while the ledger books.
    """

    def __init__(self, clock=_clock, gc_feed: deque | None = None, gc_open: list | None = None):
        self._now = clock
        self._gc_feed = _gc_done if gc_feed is None else gc_feed
        self._gc_open = _gc_open if gc_feed is None else (gc_open or [None])
        self._lock = named_lock("ops.idle")
        self._f = clock()
        self._final = dict.fromkeys(BUCKETS, 0.0)
        self._flushes = 0
        self._queued = 0
        self._state_f = "no_work"  # the state at the frontier
        self._steps: list[tuple[float, str]] = []  # state changes past it
        self._known: list[tuple[float, float]] = []  # device intervals past it
        self._gc: list[tuple[float, float]] = []  # collections past it
        self._out: dict = {}  # launch token -> h_enq

    def _state(self) -> str:
        return "flush_host" if self._flushes else "queued" if self._queued else "no_work"

    def _book(self, a: float, b: float, into: dict) -> None:
        """Adds ``[a, b]`` to ``into`` by the priority of the states; a
        launch still out is busy, a collection under way is gc, up to ``b``."""
        if b <= a:
            return
        ev: list[tuple[float, int, int]] = []  # (t, kind, delta): 0 busy, 1 gc
        for kind, ivs in ((0, self._known), (1, self._gc)):
            for s, e in ivs:
                s, e = max(s, a), min(e, b)
                if e > s:
                    ev += ((s, kind, 1), (e, kind, -1))
        for h in self._out.values():
            if h < b:
                ev.append((max(h, a), 0, 1))
        g = self._gc_open[0]
        if g is not None and g < b:
            ev.append((max(g, a), 1, 1))
        for t, st in self._steps:
            if a < t < b:
                ev.append((t, 2, 0))
        ev.sort()
        depth = [0, 0]
        steps = iter(self._steps)
        step = next(steps, None)
        state = self._state_f
        t = a
        for te, kind, delta in ev + [(b, 3, 0)]:
            if te > t:
                while step is not None and step[0] <= t:
                    state, step = step[1], next(steps, None)
                into["busy" if depth[0] else "gc" if depth[1] else state] += te - t
                t = te
            if kind < 2:
                depth[kind] += delta

    def _advance(self, now: float) -> None:
        """Books up to the new frontier for good and drops what lies
        behind it."""
        feed = self._gc_feed
        while feed:
            self._gc.append(feed.popleft())
        f1 = min(min(self._out.values(), default=now), now)
        g = self._gc_open[0]
        if g is not None:
            f1 = min(f1, g)
        if f1 <= self._f:
            return
        self._book(self._f, f1, self._final)
        self._f = f1
        while self._steps and self._steps[0][0] <= f1:
            self._state_f = self._steps.pop(0)[1]
        self._known = [iv for iv in self._known if iv[1] > f1]
        self._gc = [iv for iv in self._gc if iv[1] > f1]

    def _shift(self, flushes: int, queued: int) -> None:
        with self._lock:
            now = self._now()
            self._advance(now)
            before = self._state()
            self._flushes += flushes
            self._queued += queued
            after = self._state()
            if after != before:
                if self._f >= now:
                    self._state_f = after
                else:
                    self._steps.append((now, after))

    def flush_begin(self) -> None:
        self._shift(1, 0)

    def flush_end(self) -> None:
        self._shift(-1, 0)

    def queue_filled(self) -> None:
        """A dispatcher's queue went from empty to holding items."""
        self._shift(0, 1)

    def queue_emptied(self) -> None:
        self._shift(0, -1)

    def launch_begin(self, token) -> float:
        """A launch's first upload; returns its ``h_enq``."""
        with self._lock:
            now = self._now()
            self._advance(now)
            self._out[token] = now
            return now

    def launch_end(self, token, device_s: float, start: float | None = None) -> None:
        """The launch's wait returned: it ran ``device_s`` on the card from
        ``start`` (default its enqueue); its interval is now known."""
        with self._lock:
            now = self._now()
            h = self._out.pop(token, None)
            if h is not None:
                s = h if start is None else min(max(start, h), now)
                self._known.append((s, min(s + max(device_s, 0.0), now)))
            self._advance(now)

    def totals(self) -> dict[str, float]:
        """Seconds of each state since the ledger began, up to now."""
        with self._lock:
            now = self._now()
            self._advance(now)
            out = dict(self._final)
            self._book(self._f, now, out)
            return out


ledger = IdleLedger()


# -- flushes and launches --------------------------------------------------------

_tls = threading.local()


def current_flush() -> "FlushClock | None":
    """The flush running on this thread, if any."""
    return getattr(_tls, "flush", None)


@contextlib.contextmanager
def _scoped(attr: str, value):
    prev = getattr(_tls, attr, None)
    setattr(_tls, attr, value)
    try:
        yield value
    finally:
        setattr(_tls, attr, prev)


def flushing(clock: "FlushClock"):
    """Makes ``clock`` this thread's current flush for the block: the
    leases taken inside it book their launches to it."""
    return _scoped("flush", clock)


class FlushClock:
    """One dispatcher flush's phases (module docstring).  Made when the
    flush takes its batch; :meth:`finish` once its callers are answered
    (on the drain thread for an async flush).  Launches enqueue and come
    back in order on one thread at a time, so it takes no lock."""

    __slots__ = ("name", "t0", "launches", "encode_s", "device_s", "decode_s",
                 "span", "_out", "_host_since", "_seg", "_rf")

    def __init__(self, name: str, attrs: dict | None = None):
        self.name = name
        self.launches = 0
        self.encode_s = self.device_s = self.decode_s = 0.0
        self._out = 0
        self._host_since: float | None = None  # last result back, no launch out
        ledger.flush_begin()
        #: The ``<name>.flush`` span (``None`` with tracing off).
        self.span = trace.detached(f"{name}.flush", attrs)
        self.t0 = self.span._t0 if self.span is not None else _clock()
        self._seg = self.t0  # start of the open phase
        self._rf = trace.profile_open(f"{name}.flush.encode") if self.span else None

    def _phase(self, kind: str, t: float, attrs: dict | None = None, then: str | None = None) -> None:
        """Closes the open phase ``kind`` at ``t`` (its child span and
        profiler range) and opens ``then``."""
        if self.span is not None:
            trace.profile_close(self._rf)
            trace.child(self.span, f"{self.name}.flush.{kind}", self._seg, t, attrs)
            self._rf = trace.profile_open(f"{self.name}.flush.{then}") if then else None
        self._seg = t

    def enqueue(self, t: float) -> None:
        """A launch of this flush reached its first upload at ``t``."""
        self.launches += 1
        if self._out == 0:
            if self.launches == 1:
                self.encode_s = t - self.t0
                self._phase("encode", t, then="device")
            elif self._host_since is not None:
                self.decode_s += t - self._host_since
                self._phase("decode", t, then="device")
        self._out += 1

    def back(self, t: float, device_s: float) -> None:
        """A launch's wait returned at ``t`` after ``device_s`` on the card."""
        self.device_s += device_s
        self._out -= 1
        if self._out == 0:
            self._host_since = t
            self._phase("device", t, {"device_ms": round(1e3 * self.device_s, 4)}, then="decode")

    def finish(self, ok: bool = True, error: str | None = None) -> None:
        """The flush answered its callers (``ok``) or failed."""
        t = _clock()
        if self.launches == 0:
            self.encode_s = t - self.t0
            self._phase("encode", t)
        elif self._out == 0 and self._host_since is not None:
            self.decode_s += t - self._host_since
            self._phase("decode", t)
        elif self.span is not None:
            trace.profile_close(self._rf)
        ledger.flush_end()
        if self.launches:
            metrics.incr(f"{self.name}.launches", self.launches)
        if ok:
            metrics.observe(f"{self.name}.flush.encode", self.encode_s)
            metrics.observe(f"{self.name}.flush.device", self.device_s)
            metrics.observe(f"{self.name}.flush.decode", self.decode_s)
        if self.span is not None:
            self.span.attrs["launches"] = self.launches
            if error is not None:
                self.span.attrs["error"] = error
            trace.close(self.span, t)


class Launch:
    """One lease's launch: made with the lease (taking this thread's
    flush), stamped at its first upload, settled once its wait returns.

    Its device seconds are its kernels' own, between two CUDA events the
    C launcher records right around each kernel (:func:`kernel_events`);
    on the CPU, the host time of the launch block.  Events recorded from
    Python, around the whole launch or even around the launcher call,
    also count the card waiting while the host thread waits for the
    interpreter lock (on an H100 the first read 20–27 ms a verify flush,
    the second twice the kernel's 0.12 ms); the copies, a tenth of the
    card's busy time, are left out instead."""

    __slots__ = ("flush", "events", "h_enq", "h_rec", "h_kernel", "kernels", "done")

    def __init__(self, events: list | None = None):
        self.flush = current_flush()
        #: The slot's reusable kernel event pairs (``None`` on the CPU).
        self.events = events
        self.h_enq: float | None = None
        self.h_rec: float | None = None
        self.h_kernel: float | None = None
        self.kernels: list = []  # (start, end) CUDA events per kernel
        self.done = False

    def enqueue(self) -> None:
        self.h_enq = ledger.launch_begin(self)
        if self.flush is not None:
            self.flush.enqueue(self.h_enq)

    def settle(self) -> None:
        """After the wait: books the launch's device seconds from its
        kernels' events, or on the CPU the host time of its block."""
        if self.h_enq is None or self.done:
            return
        self.done = True
        t = _clock()
        if self.kernels:
            device_s = sum(a.elapsed_time(b) for a, b in self.kernels) / 1e3
        elif self.events is None and self.h_rec is not None:
            device_s = self.h_rec - self.h_enq  # the CPU: no events
        else:
            device_s = 0.0
        start = self.h_kernel if self.h_kernel is not None else self.h_enq
        ledger.launch_end(self, device_s, start)
        if self.flush is not None:
            self.flush.back(t, device_s)


def current_launch() -> "Launch | None":
    """The launch whose block runs on this thread, if any."""
    return getattr(_tls, "launch", None)


def launching(launch: "Launch | None"):
    """Makes ``launch`` this thread's current launch for the block: the
    kernels launched inside it are timed for it."""
    return _scoped("launch", launch)


def kernel_events() -> tuple:
    """The ``(before, after)`` CUDA event handles a kernel launcher records
    right around its kernel, for the lease's launch whose block runs on
    this thread (a fresh pair of the slot's for each kernel); ``(None,
    None)`` elsewhere."""
    lt = current_launch()
    if lt is None or lt.events is None:
        return None, None
    import torch

    events, i = lt.events, len(lt.kernels)
    while len(events) <= i:
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for e in pair:
            e.record()  # creates the event
        events.append(pair)
    lt.kernels.append(events[i])
    lt.h_kernel = lt.h_kernel or _clock()
    return events[i][0].cuda_event, events[i][1].cuda_event


# -- the registry's view -----------------------------------------------------------


def _collect() -> dict[str, float]:
    out = {BUCKETS[k]: v for k, v in ledger.totals().items()}
    out["process.gc.collections"] = _gc_total[0]
    out["process.gc.seconds"] = _gc_total[1]
    for g, (n, sec) in enumerate(_gc_by_gen):
        out[f"process.gc.gen{g}.collections"] = n
        out[f"process.gc.gen{g}.seconds"] = sec
    t = os.times()
    out["process.cpu_seconds"] = t.user + t.system
    return out


gc.callbacks.append(_on_gc)
metrics.add_collector(_collect)
