"""Counter, gauge and sample registry for the port's crypto plane.

Names and snapshot keys are the reference's (``bftkv_tpu/metrics.py``),
so a run of the port reads like a run of the reference:

- counters (``incr``): ``verify.device``, ``verify.host``,
  ``sign.device``, ``sign.host``, ``sign.fault``,
  ``sign.fault_check_divergence``, ``modexp.device``, ``modexp.host``,
  ``<name>.flushes`` / ``.items`` of each dispatcher, ``<name>.launches``
  (the device launches its flushes' staging leases made),
  ``devbuf.overflow{width=…}``;
- counters read at read time from a collector (:meth:`Registry.add_collector`,
  ``ops/idle.py``): the card's idle-state ledger in seconds,
  ``device.busy.seconds``, ``device.idle.gc.seconds``,
  ``device.idle.flush_host.seconds``, ``device.idle.queued.seconds``,
  ``device.idle.no_work.seconds`` (they sum to the process's life), and
  the process's ``process.gc.seconds``, ``process.gc.collections``, the
  same by generation (``process.gc.gen2.seconds``, ...) and
  ``process.cpu_seconds`` (user + system, ``os.times()``; on
  ``/metrics`` ``bftkv_process_cpu_seconds_total``);
- gauges (``gauge``, last write wins): ``dispatch.launch_rtt``,
  ``dispatch.crossover``, ``<name>.occupancy``,
  ``<name>.device_occupancy{width=…}``, ``<name>.throughput``,
  ``devbuf.in_flight{width=…}``, ``devbuf.saturation{width=…}``;
- samples (``observe``, and ``timer`` around a block):
  ``<name>.flush.seconds``, its phases ``<name>.flush.encode`` /
  ``.device`` / ``.decode`` (``ops/idle.py``), ``<name>.wait``,
  ``<name>.batch``, ``verify.launch``.  The snapshot carries ``<name>.count``,
  ``<name>.sum``, ``<name>.p50`` and ``<name>.p99``, and the series'
  fixed-bucket counts (:data:`BUCKETS`, whole run), one key
  ``<name>.bucket{...,le=…}`` per non-empty bucket, as the reference
  emits them: the fleet collector merges latency across processes from
  these keys.

- the sidecar's (``cmd/verify_sidecar.py``, ``crypto/remote_verify.py``):
  ``sidecar.ops{op=…}``, ``sidecar.items{op=…}``, ``sidecar.shed{op=…}``,
  ``sidecar.recalibrations``, ``sidecar.recalibration_errors``; on the
  tenant side ``verify.remote``, ``verify.remote_fallback``,
  ``verify.remote_shed``, ``verify.remote_breaker_open``,
  ``verify.remote_bad_mac``, ``verify.spot_check``, ``sign.remote``,
  ``sign.remote_fallback``, ``sign.remote_shed``, ``sign.remote_refused``,
  ``sign.remote_register``, ``modexp.remote``, ``modexp.remote_fallback``,
  ``modexp.remote_shed``, ``crypto.sidecar.dishonest``; the admission
  queue's gauges ``admission.inflight`` / ``.waiting`` / ``.limit`` /
  ``.queue_limit`` and samples ``admission.wait{resource=sidecar}``.

A labelled series flattens to ``name{k=v,...}`` in the snapshot, as in
the reference; :meth:`Registry.prometheus` renders the same series as
the reference's Prometheus text, byte for byte (the daemon's, the
gateway's and the sidecar's ``/metrics``): counters as
``bftkv_<name>_total``, gauges plain, ``observe()`` series as
fixed-bucket histograms, so a scraper can sum bucket counts across
processes.  Counters are sharded per thread, as in the reference: an
``incr`` takes no shared lock, and readers sum the shards.
``chip_smoke.py`` reads the snapshot to show which path ran.
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from collections import defaultdict

from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["BUCKETS", "LABEL_KEYS", "Registry", "histogram_quantile", "registry"]

#: The closed set of label keys an instrument may carry (the reference's
#: ``bftkv_tpu/metrics.py``): low-cardinality dimensions only; a new key
#: is a schema change of both packages.
LABEL_KEYS = (
    "transport",  # backend: http / loop / visual / ws
    "side",       # client / server
    "cmd",        # protocol command name
    "shard",      # shard index
    "op",         # gateway op (read/write) / sidecar op (verify/sign/modexp)
    "point",      # failpoint name
    "action",     # failpoint action kind
    "endpoint",   # daemon API endpoint (closed set + "other")
    "peer",       # normalized link name (bounded by fleet size)
    "event",      # visual/ws event type
    "kind",       # autopilot plan kind: split / retire
    "resource",   # capacity-plane resource
    "width",      # device batch limb-width group
    "le",         # histogram bucket bound (the BUCKETS ladder)
)

#: The reference's fixed histogram bucket upper bounds
#: (``bftkv_tpu/metrics.py``), identical in every process so bucket
#: counts merge across processes (``workload/driver.py``'s latency
#: histograms).
BUCKETS: tuple = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 1000.0, 100000.0,
)


def histogram_quantile(q: float, buckets: list[int] | tuple) -> float | None:
    """Quantile estimate from per-bucket counts (``len(BUCKETS) + 1``, the
    last being the +Inf overflow): the upper bound of the bucket holding
    the q-th sample; ``None`` on an empty histogram."""
    total = sum(buckets)
    if total <= 0:
        return None
    rank = q * total
    acc = 0
    for i, c in enumerate(buckets):
        acc += c
        if acc > rank or acc >= total:
            return BUCKETS[i] if i < len(BUCKETS) else float("inf")
    return float("inf")


def _bucket_index(value: float) -> int:
    """Index of the bucket of :data:`BUCKETS` holding ``value`` (the first
    bound >= value); ``len(BUCKETS)`` is the +Inf overflow."""
    lo, hi = 0, len(BUCKETS)
    while lo < hi:
        mid = (lo + hi) // 2
        if value <= BUCKETS[mid]:
            hi = mid
        else:
            lo = mid + 1
    return lo


#: Samples kept per series for the percentiles (``.count``/``.sum``
#: and the bucket counts cover the whole run).
_MAX_SAMPLES = 65536


def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
    return (name, tuple(sorted(labels.items())) if labels else ())


def _flat(name: str, labels: tuple) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _prom_name(name: str) -> str:
    return "bftkv_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)


def _prom_escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: tuple, extra: tuple = ()) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_prom_escape(v)}"' for k, v in items) + "}"


def _prom_value(v) -> str:
    return repr(v) if isinstance(v, float) else str(v)


def _by_name(d: dict) -> dict[str, list]:
    g: dict[str, list] = {}
    for (name, labels), v in d.items():
        g.setdefault(name, []).append((labels, v))
    return g


class Registry:
    def __init__(self):
        self._lock = named_lock("metrics")
        # Counters are sharded per thread: each thread writes only its
        # own dict, readers sum the shards (exact at read time).  Shards
        # of finished threads stay in the list, so their counts keep
        # counting.
        self._tl = threading.local()
        self._counter_shards: list[dict] = []
        self._gauges: dict[tuple, float] = {}
        self._counts: dict[tuple, int] = defaultdict(int)
        self._sums: dict[tuple, float] = defaultdict(float)
        self._samples: dict[tuple, list[float]] = defaultdict(list)
        self._sample_pos: dict[tuple, int] = defaultdict(int)
        # Fixed-bucket counts per series (len(BUCKETS) + 1, the last the
        # +Inf overflow), over the whole run.
        self._buckets: dict[tuple, list[int]] = defaultdict(lambda: [0] * (len(BUCKETS) + 1))
        self._collectors: list = []

    def _local_counters(self) -> dict:
        d = getattr(self._tl, "counters", None)
        if d is None:
            d = self._tl.counters = defaultdict(int)
            with self._lock:
                self._counter_shards.append(d)
        return d

    def _counter_totals(self) -> dict:
        totals: dict[tuple, int] = defaultdict(int)
        with self._lock:
            shards = list(self._counter_shards)
        for d in shards:
            # One C-level copy under the GIL: the owner cannot tear it.
            for k, v in d.copy().items():
                totals[k] += v
        for fn in list(self._collectors):
            for name, v in fn().items():
                totals[(name, ())] = v
        return dict(totals)

    def add_collector(self, fn) -> None:
        """``fn()`` returns unlabelled counters by name, read whenever
        :meth:`snapshot` or :meth:`prometheus` reads the counters (their
        values are the collector's, untouched by :meth:`reset`)."""
        self._collectors.append(fn)

    def incr(self, name: str, n: int = 1, labels: dict | None = None) -> None:
        self._local_counters()[_key(name, labels)] += n

    def gauge(self, name: str, value: float, labels: dict | None = None) -> None:
        """Last-write-wins instantaneous value."""
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float, labels: dict | None = None) -> None:
        """One sample (seconds, batch size, ...): the totals and bucket
        counts cover the whole run, the percentiles the newest
        ``_MAX_SAMPLES``."""
        k = _key(name, labels)
        with self._lock:
            self._counts[k] += 1
            self._sums[k] += value
            self._buckets[k][_bucket_index(value)] += 1
            s = self._samples[k]
            if len(s) < _MAX_SAMPLES:
                s.append(value)
            else:
                s[self._sample_pos[k]] = value
                self._sample_pos[k] = (self._sample_pos[k] + 1) % _MAX_SAMPLES

    @contextlib.contextmanager
    def timer(self, name: str):
        """Observes the block's seconds under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def percentile(self, name: str, q: float, labels: dict | None = None) -> float | None:
        """The sample at rank ``q`` of the series' kept samples; ``None``
        for a series with none.  Sorted outside the lock."""
        with self._lock:
            s = list(self._samples.get(_key(name, labels), ()))
        if not s:
            return None
        s.sort()
        return s[min(len(s) - 1, int(q * len(s)))]

    def snapshot(self) -> dict:
        counters = self._counter_totals()
        with self._lock:
            gauges = dict(self._gauges)
            counts = dict(self._counts)
            sums = dict(self._sums)
            series = {k: list(s) for k, s in self._samples.items() if s}
            buckets = {k: list(b) for k, b in self._buckets.items()}
        out: dict = {}
        for (name, labels), v in counters.items():
            out[_flat(name, labels)] = v
        for (name, labels), v in gauges.items():
            out[_flat(name, labels)] = v
        for (name, labels), v in counts.items():
            out[_flat(name + ".count", labels)] = v
        for (name, labels), v in sums.items():
            out[_flat(name + ".sum", labels)] = v
        for (name, labels), s in series.items():
            s.sort()
            for q, tag in ((0.5, "p50"), (0.99, "p99")):
                out[_flat(f"{name}.{tag}", labels)] = s[min(len(s) - 1, int(q * len(s)))]
        # One key per non-empty bucket; ``le`` follows the series' own
        # labels, so the key parses with the same name{k=v,...} grammar.
        for (name, labels), b in buckets.items():
            for i, c in enumerate(b):
                if c:
                    le = BUCKETS[i] if i < len(BUCKETS) else "+Inf"
                    out[_flat(f"{name}.bucket", labels + (("le", le),))] = c
        return out

    def histograms(self) -> dict:
        """Flat series key -> ``{"count", "sum", "buckets"}``, ``buckets``
        the raw per-bucket counts (len(BUCKETS) + 1, the last +Inf)."""
        with self._lock:
            counts = dict(self._counts)
            sums = dict(self._sums)
            buckets = {k: list(b) for k, b in self._buckets.items()}
        return {
            _flat(name, labels): {
                "count": counts.get((name, labels), 0),
                "sum": sums.get((name, labels), 0.0),
                "buckets": b,
            }
            for (name, labels), b in buckets.items()
        }

    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4), the reference's:
        counters (``_total``), then gauges, then each ``observe()``
        series as a histogram (cumulative ``_bucket{le=…}`` up to
        ``+Inf``, ``_sum``, ``_count``); one ``# TYPE`` line a name, each
        group sorted by name, then labels."""
        counters = self._counter_totals()
        with self._lock:
            gauges = dict(self._gauges)
            counts = dict(self._counts)
            sums = dict(self._sums)
            series = {k: list(b) for k, b in self._buckets.items()}
        lines: list[str] = []
        for kind, group, suffix in (("counter", counters, "_total"), ("gauge", gauges, "")):
            for name, rows in sorted(_by_name(group).items()):
                pn = _prom_name(name) + suffix
                lines.append(f"# TYPE {pn} {kind}")
                for labels, v in sorted(rows):
                    lines.append(f"{pn}{_prom_labels(labels)} {_prom_value(v)}")
        for name, rows in sorted(_by_name(series).items()):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} histogram")
            for labels, b in sorted(rows):
                acc = 0
                for i, c in enumerate(b):
                    acc += c
                    le = BUCKETS[i] if i < len(BUCKETS) else "+Inf"
                    lines.append(f"{pn}_bucket{_prom_labels(labels, (('le', le),))} {acc}")
                key = (name, labels)
                lines.append(f"{pn}_sum{_prom_labels(labels)} {_prom_value(sums.get(key, 0.0))}")
                lines.append(f"{pn}_count{_prom_labels(labels)} {_prom_value(counts.get(key, 0))}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            shards = list(self._counter_shards)
            self._gauges.clear()
            self._counts.clear()
            self._sums.clear()
            self._samples.clear()
            self._sample_pos.clear()
            self._buckets.clear()
        for d in shards:
            d.clear()


registry = Registry()
