"""Minimal counter/timer registry for the port's crypto plane.

The counters this slice moves (``verify.device``, ``verify.host``,
``sign.device``, ``sign.host``, ``sign.fault``,
``sign.fault_check_divergence``) and the ``verify.launch`` timer keep the
reference's names (``bftkv_tpu/metrics.py``), so a run of the port reads
like a run of the reference.  ``chip_smoke.py`` reads them to show the
device path ran.
"""

from __future__ import annotations

import contextlib
import threading
import time

__all__ = ["Registry", "registry"]


class Registry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._timers: dict[str, list[float]] = {}  # name -> [count, sum]

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    @contextlib.contextmanager
    def timer(self, name: str):
        """Times the block; the snapshot carries ``name.count``/``.sum``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                c = self._timers.setdefault(name, [0, 0.0])
                c[0] += 1
                c[1] += dt

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = dict(self._counters)
            for name, (count, total) in self._timers.items():
                out[f"{name}.count"] = count
                out[f"{name}.sum"] = total
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()


registry = Registry()
