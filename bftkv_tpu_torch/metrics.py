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
  ``<name>.sum``, ``<name>.p50`` and ``<name>.p99``.

A labelled series flattens to ``name{k=v,...}`` in the snapshot, as in
the reference.  ``chip_smoke.py`` reads the snapshot to show which path
ran.
"""

from __future__ import annotations

import contextlib
import time

from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["Registry", "registry"]

#: Samples kept per series for the percentiles (``.count``/``.sum``
#: cover the whole run).
_MAX_SAMPLES = 65536


def _key(name: str, labels: dict | None) -> tuple[str, tuple]:
    return (name, tuple(sorted(labels.items())) if labels else ())


def _flat(name: str, labels: tuple) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class Registry:
    def __init__(self):
        self._lock = named_lock("metrics")
        self._counters: dict[tuple, int] = {}
        self._gauges: dict[tuple, float] = {}
        self._samples: dict[tuple, list] = {}  # key -> [count, sum, ring, pos]

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
                s = self._samples[k] = [0, 0.0, [], 0]
            s[0] += 1
            s[1] += value
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
            samples = {k: (c, t, list(r)) for k, (c, t, r, _p) in self._samples.items()}
        out: dict = {}
        for (name, labels), v in counters.items():
            out[_flat(name, labels)] = v
        for (name, labels), v in gauges.items():
            out[_flat(name, labels)] = v
        for (name, labels), (count, total, ring) in samples.items():
            out[_flat(name + ".count", labels)] = count
            out[_flat(name + ".sum", labels)] = total
            ring.sort()
            for q, tag in ((0.5, "p50"), (0.99, "p99")):
                out[_flat(f"{name}.{tag}", labels)] = ring[min(len(ring) - 1, int(q * len(ring)))]
        return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._samples.clear()


registry = Registry()
