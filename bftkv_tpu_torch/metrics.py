"""Counter, gauge and sample registry for the port's crypto plane.

Names and snapshot keys are the reference's (``bftkv_tpu/metrics.py``),
so a run of the port reads like a run of the reference:

- counters (``incr``): ``verify.device``, ``verify.host``,
  ``sign.device``, ``sign.host``, ``sign.fault``,
  ``sign.fault_check_divergence``, ``modexp.device``, ``modexp.host``,
  ``<name>.flushes`` / ``.items`` / ``.launches`` of each dispatcher,
  ``devbuf.overflow{width=…}``;
- gauges (``gauge``, last write wins): ``dispatch.launch_rtt``,
  ``dispatch.crossover``, ``<name>.occupancy``,
  ``<name>.device_occupancy{width=…}``, ``<name>.throughput``,
  ``devbuf.in_flight{width=…}``, ``devbuf.saturation{width=…}``;
- samples (``observe``, and ``timer`` around a block):
  ``<name>.flush.seconds``, ``<name>.wait``, ``<name>.batch``,
  ``verify.launch``.  The snapshot carries ``<name>.count``,
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
Prometheus text (the sidecar's stats endpoint).  ``chip_smoke.py`` reads
the snapshot to show which path ran.
"""

from __future__ import annotations

import contextlib
import re
import time

from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["BUCKETS", "Registry", "histogram_quantile", "registry"]

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
#: cover the whole run).
_MAX_SAMPLES = 65536


def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
    return (name, tuple(sorted(labels.items())) if labels else ())


def _flat(name: str, labels: tuple) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _prom_escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class Registry:
    def __init__(self):
        self._lock = named_lock("metrics")
        self._counters: dict[tuple, int] = {}
        self._gauges: dict[tuple, float] = {}
        self._samples: dict[tuple, list] = {}  # key -> [count, sum, ring, pos, buckets]

    def incr(self, name: str, n: int = 1, labels: dict | None = None) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + n

    def gauge(self, name: str, value: float, labels: dict | None = None) -> None:
        """Last-write-wins instantaneous value."""
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def observe(self, name: str, value: float, labels: dict | None = None) -> None:
        """One sample (seconds, batch size, ...)."""
        k = _key(name, labels)
        with self._lock:
            s = self._samples.get(k)
            if s is None:
                s = self._samples[k] = [0, 0.0, [], 0, [0] * (len(BUCKETS) + 1)]
            s[0] += 1
            s[1] += value
            s[4][_bucket_index(value)] += 1
            ring = s[2]
            if len(ring) < _MAX_SAMPLES:
                ring.append(value)
            else:
                ring[s[3]] = value
                s[3] = (s[3] + 1) % _MAX_SAMPLES

    @contextlib.contextmanager
    def timer(self, name: str):
        """Observes the block's seconds under ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            samples = {k: (c, t, list(r), list(b)) for k, (c, t, r, _p, b) in self._samples.items()}
        out: dict = {}
        for (name, labels), v in counters.items():
            out[_flat(name, labels)] = v
        for (name, labels), v in gauges.items():
            out[_flat(name, labels)] = v
        for (name, labels), (count, total, ring, _b) in samples.items():
            out[_flat(name + ".count", labels)] = count
            out[_flat(name + ".sum", labels)] = total
            ring.sort()
            for q, tag in ((0.5, "p50"), (0.99, "p99")):
                out[_flat(f"{name}.{tag}", labels)] = ring[min(len(ring) - 1, int(q * len(ring)))]
        # One key per non-empty bucket; ``le`` follows the series' own
        # labels, so the key parses with the same name{k=v,...} grammar.
        for (name, labels), (_c, _t, _r, buckets) in samples.items():
            for i, c in enumerate(buckets):
                if c:
                    le = BUCKETS[i] if i < len(BUCKETS) else "+Inf"
                    out[_flat(f"{name}.bucket", labels + (("le", le),))] = c
        return out

    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4): counters as
        ``bftkv_<name>_total``, gauges plain, samples as ``_sum`` and
        ``_count``."""
        with self._lock:
            rows = [("counter", k, v, "_total") for k, v in self._counters.items()]
            rows += [("gauge", k, v, "") for k, v in self._gauges.items()]
            for k, (count, total, _ring, _pos, _b) in self._samples.items():
                rows += [("summary", k, total, "_sum"), ("summary", k, count, "_count")]
        lines, typed = [], set()
        for kind, (name, labels), v, suffix in sorted(rows, key=lambda r: (r[1], r[3])):
            pn = "bftkv_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)
            if pn not in typed:
                typed.add(pn)
                lines.append(f"# TYPE {pn}{'_total' if kind == 'counter' else ''} {kind}")
            lab = ",".join(f'{k}="{_prom_escape(x)}"' for k, x in labels)
            lines.append(f"{pn}{suffix}{'{' + lab + '}' if lab else ''} {v!r}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._samples.clear()


registry = Registry()
