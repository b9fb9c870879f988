"""A copy of ``bftkv_tpu/trace.py`` (imports rewritten to the port's
``flags``, ``metrics`` and ``devtools.lockwatch``); the port's dispatch
plane opens its ``<name>.launch`` / ``<name>.flush`` (with the phase
children ``<name>.flush.encode`` / ``.device`` / ``.decode``) /
``dispatch.wait`` spans through it.  Modules named below without
``_torch`` are the reference's, not yet ported.

Two additions of the port.  A span's ``start`` is epoch time from
``time.time_ns()``, the clock of ``torch.profiler``'s chrome trace
(``ts`` · 1000 + ``baseTimeNanoseconds``), and the dispatch plane's
spans also open a ``torch.profiler.record_function`` range of their
name (``span(..., profile=True)``, :func:`profile_open`) while tracing
is on, so a profile shows the host phases over the kernels they feed.
A span whose end is known only on another thread or after the fact is
made with :func:`detached`, given children with :func:`child` and
recorded by :func:`close`.

End-to-end request tracing: trace-id/span primitives, a bounded ring
collector, and structured slow-request logging.

The reference has no request correlation at all; ``metrics.py`` gives
whole-process counters.  Neither can answer the questions that steer
the store's performance work — *which replica* stalled a fan-out,
*which phase* of a three-phase write burned the latency budget, *how
full* the device verify batches actually ran (Thetacrypt ships
per-request tracing through its threshold-crypto RPC layer for exactly
this reason; "The Latency Price of Threshold Cryptosystems" shows the
threshold path is dominated by stragglers only per-peer spans find).

Deliberately dependency-free, same stance as :mod:`bftkv_tpu_torch.metrics`:

- a **span** is one timed operation (name, trace id, span id, parent
  span id, start, duration, attrs).  ``span("client.write")`` is a
  context manager; nesting on one thread parents automatically through
  a thread-local stack;
- **propagation** crosses threads and nodes explicitly: ``capture()``
  snapshots the current context, ``attach(ctx)`` re-establishes it on
  another thread, and the transport fan-out carries the context inside
  the encrypted payload via the packet-level trace envelope
  (:func:`bftkv_tpu.packet.wrap_trace`) so server-side spans join the
  client's trace — including across processes over HTTP;
- the **collector** is a bounded ring of finished spans (no
  allocation growth under sustained traffic).  A *root* span (no
  parent) finishing over the slow threshold snapshots its whole trace
  into a separate slow ring and emits one JSON line on the
  ``bftkv_tpu_torch.trace.slow`` logger — grep-able, machine-parseable, with
  top-level ``shard``/``peer`` attribution when the trace carries it;
- every recorded span gets a monotonic **sequence number**, and
  :meth:`Tracer.export` drains the ring incrementally from a caller
  cursor — the fleet collector's feed (``/trace?since=N`` on the
  daemon API): spans stop dying in per-process rings and stitch into
  cross-process trees in ``bftkv_tpu.obs``;
- ``/trace`` on the daemon API serves the recent and slow rings.

Span-name taxonomy and label-cardinality rules: docs/DESIGN.md §7.
``BFTKV_TRACE=off`` disables collection (spans become no-ops and no
trace context rides the wire); ``BFTKV_SLOW_TRACE_SECONDS`` sets the
slow threshold (default 1.0).

**Phases (DESIGN.md §18).**  Every span name resolves to exactly one
member of the CLOSED :data:`PHASES` enum via :data:`SPAN_PHASES` — the
vocabulary the critical-path attribution plane
(:mod:`bftkv_tpu.obs.critpath`) decomposes a write's wall clock into.
The registry is closed the same way ``metrics.LABEL_KEYS`` is: a new
span name must either match a declared entry or pass an explicit
``phase=`` (``tools/bftlint``'s ``span-phase`` rule rejects call sites
that would silently land in the implicit ``other`` bucket, because an
unattributed span is exactly the invisible latency this plane exists
to kill).
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from collections import deque
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = [
    "PHASES",
    "SPAN_PHASES",
    "Span",
    "SpanContext",
    "Tracer",
    "attach",
    "capture",
    "child",
    "close",
    "detached",
    "new_id",
    "phase_of",
    "profile_close",
    "profile_open",
    "span",
    "tracer",
]

#: The closed phase enum the write/read wall-clock budget decomposes
#: into (DESIGN.md §18).  Adding a phase is a deliberate
#: schema change: the fleet collector's merged histograms and the
#: committed bench ``phase_budget`` trajectories key off these names.
PHASES = (
    "lease",     # presession/timestamp-lease work before the fan-out
    "fanout",    # fan-out machinery: sealing, staging, wave bookkeeping
    "rpc",       # on-the-wire time of peer RPCs (slowest-peer network)
    "server",    # remote admission + verify + storage (stitched spans)
    "dispatch",  # batching-dispatcher queue wait (collector + flush)
    "sidecar",   # shared-crypto-service round trips
    "combine",   # collective-signature combine/mint/verify (host side)
    "backfill",  # async certified-record back-fill tail
    "other",     # root self-time, quorum selection, uncategorized
)

#: Span name → phase.  Exact names win; a key ending in ``.`` is a
#: prefix rule (``rpc.`` covers every ``rpc.<cmd>``).  CLOSED: a span
#: name resolving to none of these lands in ``other`` at runtime, and
#: ``tools/bftlint`` rejects the call site unless it passes an
#: explicit ``phase=`` — new spans must declare their phase.
SPAN_PHASES: dict[str, str] = {
    # client roots + local bookkeeping
    "client.write": "other",
    "client.read": "other",
    "client.read_certified": "other",
    "client.write_many": "other",
    "client.read_many": "other",
    "quorum.select": "other",
    "fault.delay": "other",
    # presession / leases
    "presession.": "lease",
    # fan-out rounds (the span wraps the whole round; its rpc children
    # own the wire time, so the self-time left here is the fan-out
    # machinery itself)
    "phase.time": "fanout",
    "phase.sign": "fanout",
    "phase.write": "fanout",
    "phase.write_sign": "fanout",
    "read.certify": "fanout",
    "read.certified_only": "fanout",
    "read.certified_record": "fanout",
    # per-peer wire time
    "rpc.": "rpc",
    # remote side (stitched into the client's trace)
    "server.": "server",
    "storage.write": "server",
    # collective-signature host crypto
    "phase.ack": "combine",
    "verify.collective": "combine",
    # batching dispatcher + shared crypto service
    # (dispatch.wait, and each dispatcher's <name>.flush, its phase
    # children <name>.flush.encode / .device / .decode and <name>.launch)
    "dispatch.": "dispatch",
    "signdispatch.": "dispatch",
    "modexpdispatch.": "dispatch",
    "sidecar.call": "sidecar",
    # async tails + repair/anti-entropy planes
    "backfill.": "backfill",
    "sync.repair.backfill": "backfill",
    "sync.": "other",
    # edge gateway (own roots; their quorum-client children re-enter
    # the client.* taxonomy above)
    "gateway.": "other",
    "gateway_client.": "other",
}

#: Longest-match prefix rules, precomputed (longest first so
#: ``sync.repair.backfill`` beats ``sync.``).
_PREFIX_RULES = sorted(
    (k for k in SPAN_PHASES if k.endswith(".")),
    key=len, reverse=True,
)

_phase_memo: dict[str, str] = {}


def phase_of(name: str) -> str:
    """The declared phase of span ``name`` (``other`` for names outside
    the registry — bftlint keeps that set empty in-tree)."""
    p = _phase_memo.get(name)
    if p is None:
        p = SPAN_PHASES.get(name)
        if p is None:
            for prefix in _PREFIX_RULES:
                if name.startswith(prefix):
                    p = SPAN_PHASES[prefix]
                    break
            else:
                p = "other"
        _phase_memo[name] = p
    return p

slow_log = logging.getLogger("bftkv_tpu_torch.trace.slow")

# Trace/span ids are correlation handles, not secrets (they only ever
# ride *inside* the encrypted transport envelope), so a seeded PRNG is
# fine — and ~100x cheaper than os.urandom per span.
_rng = random.Random(int.from_bytes(os.urandom(8), "big"))


def new_id() -> int:
    """A non-zero 63-bit id (0 is reserved as "absent" on the wire)."""
    return _rng.getrandbits(63) | 1


class SpanContext:
    """What propagation carries: (trace_id, span_id) of the parent."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: int, span_id: int):
        self.trace_id = trace_id
        self.span_id = span_id


class Span:
    __slots__ = (
        "trace_id",
        "span_id",
        "parent_id",
        "name",
        "start",
        "duration",
        "attrs",
        "seq",
        "phase",
        "_t0",
    )

    def __init__(self, trace_id, span_id, parent_id, name, attrs,
                 phase=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        # Epoch seconds, the clock of torch.profiler's chrome trace.
        self.start = time.time_ns() * 1e-9
        self.duration = 0.0
        self.attrs = attrs
        self.seq = 0  # assigned by Tracer.record under its lock
        #: Explicit phase override (dynamic-named spans); None =
        #: resolve from the SPAN_PHASES registry at export time.
        self.phase = phase
        self._t0 = time.perf_counter()

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def to_dict(self) -> dict:
        d = {
            "trace": f"{self.trace_id:016x}",
            "span": f"{self.span_id:016x}",
            "name": self.name,
            "start": self.start,
            "duration": self.duration,
            # Resolved lazily (exports are rare next to records) so the
            # record hot path never pays the registry lookup.
            "phase": self.phase or phase_of(self.name),
        }
        if self.parent_id is not None:
            d["parent"] = f"{self.parent_id:016x}"
        if self.attrs:
            d["attrs"] = self.attrs
        return d


#: Sink for spans created while tracing is disabled: attrs writes land
#: here and are discarded, so call sites never branch on enablement.
_NULL_SPAN = Span(0, 0, None, "", {})

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def capture() -> SpanContext | None:
    """The current context — the innermost open span on this thread, or
    the remotely attached context, or None.  What the transport layer
    snapshots on the caller's thread before fanning out."""
    if not tracer.enabled:
        return None
    st = getattr(_tls, "stack", None)
    if st:
        return st[-1].context()
    return getattr(_tls, "remote", None)


class attach:
    """Re-establish a captured/propagated context on this thread, so
    the next ``span()`` parents to it.  ``attach(None)`` is a no-op
    shield (it masks any context leaked by a previous user of a pooled
    thread).  Restores the previous context on exit."""

    __slots__ = ("ctx", "_prev")

    def __init__(self, ctx: SpanContext | None):
        self.ctx = ctx

    def __enter__(self) -> SpanContext | None:
        self._prev = getattr(_tls, "remote", None)
        _tls.remote = self.ctx
        return self.ctx

    def __exit__(self, *exc) -> bool:
        _tls.remote = self._prev
        return False


class span:
    """Context manager: one timed span, auto-parented.

    Yields the :class:`Span` so callers can add attrs mid-flight
    (``sp.attrs["batch_size"] = n``).  On exit the span is recorded in
    the process tracer; an exception leaving the block lands in
    ``attrs["error"]`` (interned error message when available) and
    still propagates.  ``profile=True`` also opens a
    ``torch.profiler.record_function`` range of the span's name."""

    __slots__ = ("name", "attrs", "phase", "profile", "_sp", "_rf")

    def __init__(self, name: str, attrs: dict | None = None,
                 phase: str | None = None, profile: bool = False):
        self.name = name
        self.attrs = attrs
        self.phase = phase
        self.profile = profile

    def __enter__(self) -> Span:
        if not tracer.enabled:
            self._sp = None
            return _NULL_SPAN
        st = _stack()
        if st:
            parent = st[-1]
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            remote = getattr(_tls, "remote", None)
            if remote is not None:
                trace_id, parent_id = remote.trace_id, remote.span_id
            else:
                trace_id, parent_id = new_id(), None
        sp = Span(trace_id, new_id(), parent_id, self.name,
                  dict(self.attrs) if self.attrs else {},
                  phase=self.phase)
        st.append(sp)
        self._sp = sp
        self._rf = profile_open(self.name) if self.profile else None
        return sp

    def __exit__(self, etype, exc, tb) -> bool:
        sp = self._sp
        if sp is None:
            return False
        profile_close(self._rf)
        _stack().pop()
        sp.duration = time.perf_counter() - sp._t0
        if etype is not None:
            msg = getattr(exc, "message", None)
            sp.attrs["error"] = msg if isinstance(msg, str) else repr(exc)
        tracer.record(sp)
        return False


def profile_open(name: str):
    """Opens a ``torch.profiler.record_function`` range named ``name``
    while tracing is on (``None`` otherwise); :func:`profile_close` ends
    it."""
    if not tracer.enabled:
        return None
    from torch.profiler import record_function

    rf = record_function(name)
    rf.__enter__()
    return rf


def profile_close(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


def detached(name: str, attrs: dict | None = None) -> Span | None:
    """A span opened now under the current context but kept off the
    thread's stack, for one that ends elsewhere; ``None`` with tracing
    off.  :func:`close` records it."""
    if not tracer.enabled:
        return None
    parent = capture()
    if parent is None:
        trace_id, parent_id = new_id(), None
    else:
        trace_id, parent_id = parent.trace_id, parent.span_id
    return Span(trace_id, new_id(), parent_id, name, dict(attrs) if attrs else {})


def child(parent: Span, name: str, t0: float, t1: float, attrs: dict | None = None) -> None:
    """Records a finished child of ``parent`` over the
    ``time.perf_counter()`` interval ``[t0, t1]``."""
    sp = Span(parent.trace_id, new_id(), parent.span_id, name, dict(attrs) if attrs else {})
    sp.start = parent.start + (t0 - parent._t0)
    sp.duration = max(0.0, t1 - t0)
    tracer.record(sp)


def close(sp: Span, t1: float | None = None) -> None:
    """Records a :func:`detached` span as ending at the
    ``time.perf_counter()`` reading ``t1`` (default now)."""
    sp.duration = (time.perf_counter() if t1 is None else t1) - sp._t0
    tracer.record(sp)


class Tracer:
    """Bounded ring collector + slow-trace capture.

    ``max_spans`` bounds total retained spans (the ring IS the storage
    — traces are grouped on demand); ``max_slow`` bounds retained slow
    traces.  All methods are thread-safe; the span hot path is one
    lock-guarded deque append."""

    def __init__(
        self,
        max_spans: int = 8192,
        slow_threshold: float | None = None,
        max_slow: int = 64,
    ):
        self.enabled = flags.raw("BFTKV_TRACE", "on").lower() not in (
            "off", "0", "false",
        )
        if slow_threshold is None:
            slow_threshold = float(
                flags.raw("BFTKV_SLOW_TRACE_SECONDS", "1.0")
            )
        self.slow_threshold = slow_threshold
        self._lock = named_lock("trace.collector")
        self._spans: "deque[Span]" = deque(maxlen=max_spans)
        self._slow: "deque[dict]" = deque(maxlen=max_slow)
        # Monotonic sequence of recorded spans — the export cursor.
        # Survives ring wrap-around: a drained reader can tell exactly
        # how many spans it lost to overwrite (export()'s "dropped").
        self._seq = 0
        # Cumulative ring-overwrite counts (spans/slow entries pushed
        # off the bounded rings before ANY reader drained them) —
        # attribution silently under-samples by exactly these, so they
        # ride every export doc and the trace.ring.dropped /
        # trace.slow.dropped gauges the fleet plane sums.
        # Reader-relative on purpose: a full ring whose tail every
        # scrape keeps up with loses nothing — counting raw evictions
        # would turn the gauge permanently nonzero on any long-lived
        # busy daemon and cry wolf forever.
        self._ring_dropped = 0
        self._slow_dropped = 0
        self._drained_to = 0  # highest seq any export() has covered
        self._slow_seq = 0  # monotonic count of slow captures
        self._slow_seen = 0  # _slow_seq at the last slow() read

    # -- recording --------------------------------------------------------

    def record(self, sp: Span) -> None:
        with self._lock:
            self._seq += 1
            sp.seq = self._seq
            if (
                len(self._spans) == self._spans.maxlen
                and self._spans[0].seq > self._drained_to
            ):
                self._ring_dropped += 1
            self._spans.append(sp)
        if sp.parent_id is None and sp.duration >= self.slow_threshold:
            self._capture_slow(sp)

    def _capture_slow(self, root: Span) -> None:
        spans = self.trace(root.trace_id)
        entry = {
            "trace_id": f"{root.trace_id:016x}",
            "root": root.name,
            "duration": root.duration,
            "start": root.start,
            "spans": spans,
        }
        # Attribution without grepping every daemon: the owning shard
        # (stamped on the root span by the routed client paths) and the
        # peer behind the slowest rpc.* span — the straggler that most
        # plausibly burned the budget.
        shard = root.attrs.get("shard")
        if shard is not None:
            entry["shard"] = shard
        rpcs = [
            s for s in spans
            if s["name"].startswith("rpc.") and s.get("attrs", {}).get("peer")
        ]
        if rpcs:
            entry["peer"] = max(rpcs, key=lambda s: s["duration"])[
                "attrs"
            ]["peer"]
        with self._lock:
            if len(self._slow) == self._slow.maxlen:
                # oldest retained entry is capture #(_slow_seq-maxlen+1)
                evicted = self._slow_seq - self._slow.maxlen + 1
                if evicted > self._slow_seen:
                    self._slow_dropped += 1
            self._slow_seq += 1
            self._slow.append(entry)
        # One grep-able JSON line per slow request: the root, its
        # duration, and a per-span breakdown compact enough for logs.
        try:
            slow_log.warning(json.dumps({
                "event": "slow_request",
                "trace_id": entry["trace_id"],
                "root": root.name,
                "duration_s": round(root.duration, 6),
                "threshold_s": self.slow_threshold,
                **({"shard": shard} if shard is not None else {}),
                **(
                    {"peer": entry["peer"]} if "peer" in entry else {}
                ),
                "spans": [
                    {
                        "name": s["name"],
                        "duration_s": round(s["duration"], 6),
                        **({"attrs": s["attrs"]} if s.get("attrs") else {}),
                    }
                    for s in spans
                ],
            }, default=str))
        except Exception:  # a weird attr value must never kill a request
            pass

    def cursor(self) -> int:
        """The current export cursor (sequence of the newest recorded
        span) without serializing anything — pass to :meth:`export` as
        ``since`` to drain only what happens after this point (the
        bench's per-round breakdown uses it to scope one section)."""
        with self._lock:
            return self._seq

    # -- export (the fleet collector's feed) ------------------------------

    def export(self, since: int = 0) -> dict:
        """Incremental drain: every retained span recorded after cursor
        ``since`` (0 = from the beginning), oldest first.

        Returns ``{"cursor", "dropped", "spans"}`` — pass ``cursor``
        back as the next ``since``.  ``dropped`` counts spans that were
        recorded after ``since`` but already overwritten by the bounded
        ring before this drain (a slow scraper loses the oldest spans,
        never blocks the hot path).  A ``since`` ahead of the current
        sequence means the process (or the ring) restarted: the drain
        resyncs from the beginning rather than returning nothing
        forever.  Read-only — concurrent exports with different cursors
        (several collectors) do not disturb each other."""
        with self._lock:
            seq = self._seq
            if since > seq:
                since = 0
            fresh = [s for s in self._spans if s.seq > since]
            # This reader was offered everything up to seq (overwritten
            # spans are reported via "dropped" below): later evictions
            # of these spans are not loss.
            self._drained_to = max(self._drained_to, seq)
            ring_dropped = self._ring_dropped
            slow_dropped = self._slow_dropped
        # Serialize OUTSIDE the lock (same discipline as percentile/
        # snapshot in metrics.py): a near-full-ring drain would
        # otherwise stall every concurrent record() — a span is
        # immutable once recorded, so the reference snapshot suffices.
        out = [s.to_dict() for s in fresh]
        oldest = fresh[0].seq if fresh else seq + 1
        # Gauges refresh on every drain (the record hot path never pays
        # a metrics lock): each collector scrape — and any /trace hit —
        # keeps /metrics at most one drain stale.
        from bftkv_tpu_torch.metrics import registry as _metrics

        _metrics.gauge("trace.ring.dropped", ring_dropped)
        _metrics.gauge("trace.slow.dropped", slow_dropped)
        return {
            "cursor": seq,
            "dropped": max(0, oldest - since - 1),
            "ring_dropped": ring_dropped,
            "slow_dropped": slow_dropped,
            "spans": out,
        }

    # -- querying ---------------------------------------------------------

    def trace(self, trace_id: int) -> list[dict]:
        """Every retained span of one trace, oldest first."""
        with self._lock:
            return [
                s.to_dict() for s in self._spans if s.trace_id == trace_id
            ]

    def traces(self, limit: int = 20) -> list[dict]:
        """The most recent ``limit`` traces assembled from the ring
        (newest last), each ``{"trace_id", "root", "duration", "spans"}``.
        A trace whose root span already fell off the ring reports the
        longest retained span as its root."""
        with self._lock:
            spans = [s.to_dict() for s in self._spans]
        grouped: dict[str, list[dict]] = {}
        order: list[str] = []
        for s in spans:
            tid = s["trace"]
            if tid not in grouped:
                grouped[tid] = []
                order.append(tid)
            grouped[tid].append(s)
        out = []
        for tid in order[-limit:]:
            ss = grouped[tid]
            root = next(
                (s for s in ss if "parent" not in s),
                max(ss, key=lambda s: s["duration"]),
            )
            out.append({
                "trace_id": tid,
                "root": root["name"],
                "duration": root["duration"],
                "spans": ss,
            })
        return out

    def slow(self) -> list[dict]:
        with self._lock:
            self._slow_seen = self._slow_seq
            return list(self._slow)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._slow.clear()
            self._seq = 0  # export() resyncs stale cursors from zero
            self._ring_dropped = 0
            self._slow_dropped = 0
            self._drained_to = 0
            self._slow_seq = 0
            self._slow_seen = 0


tracer = Tracer()
