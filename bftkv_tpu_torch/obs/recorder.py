"""Flight recorder: a bounded on-disk black box for anomaly windows.

Counterpart of ``bftkv_tpu/obs/recorder.py``.

Every diagnostic surface this tree grew is a *ring*: the trace rings
overwrite in seconds under load, metrics are cumulative (the delta
that mattered is gone), the anomaly feed is bounded, the failpoint
trace caps out.  By the time a human looks at a 3 a.m. page, the
evidence has been overwritten.  The recorder closes that gap: on any
anomaly-feed event (and on ``cmd.fleet --bundle`` demand) it snapshots
the rings THAT INSTANT into one timestamped bundle directory::

    <dir>/bundle-<utcstamp>-<reason>/
        manifest.json     # ts, reason, anomalies, file inventory+sizes
        traces.json       # recent + slow tracer rings
        metrics.json      # flat metrics snapshot
        health.json       # fleet health document (budgets, epochs)
        anomalies.json    # the collector's anomaly ring
        failpoints.json   # fault-injection event log
        lockwatch.json    # lock sanitizer report (when armed)
        profile.txt       # last captured profile window (when any)

Disk discipline, because a flapping anomaly must not fill the volume:

- **coalescing** — anomalies inside ``min_interval_s`` of the last
  bundle AMEND that bundle's manifest instead of minting a new one
  (one fault window → one bundle, the nemesis oracle's shape);
  :meth:`mark_window` opens a fresh coalescing epoch so back-to-back
  windows never share a bundle;
- **size cap** — total bytes across bundles ≤ ``max_bytes`` and at
  most ``max_bundles`` directories; oldest bundles are evicted first
  (the black box keeps the *recent* past, like its aviation namesake);
- bundles are plain JSON + text, readable with no live fleet and no
  bftkv import.

Design: docs/DESIGN.md §18.
"""

from __future__ import annotations

import json
import os
import shutil
import time

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["FlightRecorder", "default_dir", "read_manifest"]


def default_dir() -> str:
    """``BFTKV_RECORDER_DIR`` or ``<tmp>/bftkv-blackbox``."""
    d = flags.raw("BFTKV_RECORDER_DIR")
    if d:
        return d
    import tempfile

    return os.path.join(tempfile.gettempdir(), "bftkv-blackbox")


def read_manifest(bundle_dir: str) -> dict:
    """One bundle's manifest — stdlib-only on purpose (a bundle must
    open on a laptop with nothing installed)."""
    with open(os.path.join(bundle_dir, "manifest.json")) as f:
        return json.load(f)


class FlightRecorder:
    """``dir``: bundle root (created on first use).  The feed objects
    are all optional — a recorder wired to nothing still writes valid
    (if sparse) bundles, which is what the no-live-fleet tests prove.

    Thread-safe; :meth:`on_anomaly` is shaped to hang directly off
    ``FleetCollector.add_anomaly_listener``."""

    def __init__(
        self,
        dir: str | None = None,
        *,
        collector=None,
        tracer=None,
        metrics=None,
        fp_registry=None,
        min_interval_s: float | None = None,
        max_bundles: int = 16,
        max_bytes: int | None = None,
    ):
        self.dir = dir or default_dir()
        self.collector = collector
        self.tracer = tracer
        self.metrics = metrics
        self.fp_registry = fp_registry
        self.min_interval_s = (
            min_interval_s
            if min_interval_s is not None
            else (flags.get_float("BFTKV_RECORDER_MIN_INTERVAL") or 5.0)
        )
        self.max_bundles = max_bundles
        self.max_bytes = (
            max_bytes
            if max_bytes is not None
            else (flags.get_int("BFTKV_RECORDER_MAX_MB") or 64) * 1048576
        )
        self._lock = named_lock("obs.recorder")
        self._last_bundle: str | None = None
        self._last_ts = 0.0
        self._epoch = 0  # bumped by mark_window: never coalesce across
        self._last_epoch = -1
        self.bundle_count = 0  # bundles CREATED by this recorder
        self.coalesced = 0
        self.suppressed = 0

    # -- the anomaly→bundle path -------------------------------------------

    def add_to(self, collector) -> "FlightRecorder":
        """Subscribe to a collector's anomaly feed (and adopt it as the
        health/anomaly source when none was given).  The collector also
        learns about the recorder so its ``/fleet/bundle`` endpoint can
        serve demand snapshots."""
        if self.collector is None:
            self.collector = collector
        collector.recorder = self
        collector.add_anomaly_listener(self.on_anomaly)
        return self

    def on_anomaly(self, anomaly: dict) -> None:
        """One anomaly event → one bundle, coalesced: follow-up events
        amend the window's bundle instead of minting new snapshots.
        With :meth:`mark_window` in use (epoch > 0, the nemesis) the
        window boundary IS the coalescing boundary — every same-epoch
        event amends; without it, ``min_interval_s`` rate-limits."""
        with self._lock:
            same_epoch = self._last_epoch == self._epoch
            recent = (time.time() - self._last_ts) < self.min_interval_s
            coalesce = self._last_bundle is not None and same_epoch and (
                recent or self._epoch > 0
            )
            if coalesce:
                self._amend_locked(anomaly)
                self.coalesced += 1
                return
        try:
            self.snapshot(
                reason=str(anomaly.get("kind", "anomaly")),
                anomalies=[anomaly],
            )
        except OSError:
            with self._lock:
                self.suppressed += 1  # a full disk must not kill scrapes

    def mark_window(self) -> None:
        """Open a new coalescing epoch: the NEXT anomaly mints a fresh
        bundle even if the previous one is recent.  The nemesis calls
        this at each fault-window boundary so one window maps to one
        bundle deterministically."""
        with self._lock:
            self._epoch += 1

    def _amend_locked(self, anomaly: dict) -> None:
        path = os.path.join(self._last_bundle, "manifest.json")
        try:
            with open(path) as f:
                manifest = json.load(f)
            manifest.setdefault("anomalies", []).append(anomaly)
            manifest["amended_ts"] = time.time()
            tmp = path + "~"
            with open(tmp, "w") as f:
                json.dump(manifest, f, indent=1, default=repr)
            os.replace(tmp, path)
        except OSError:
            self.suppressed += 1

    # -- snapshotting ------------------------------------------------------

    def _feeds(self) -> dict:
        """name → JSON-able payload, best effort per feed (one broken
        feed must not cost the bundle the others)."""
        out: dict = {}
        tracer = self.tracer
        if tracer is None:
            from bftkv_tpu_torch import trace as trmod

            tracer = trmod.tracer
        metrics = self.metrics
        if metrics is None:
            from bftkv_tpu_torch.metrics import registry as metrics
        feeds = {
            "traces.json": lambda: {
                "recent": tracer.traces(limit=50),
                "slow": tracer.slow(),
            },
            "metrics.json": metrics.snapshot,
        }
        if self.collector is not None:
            feeds["health.json"] = self.collector.health
            feeds["anomalies.json"] = self.collector.anomalies
            # The capacity plane standalone (it also rides health.json):
            # a resource_saturated bundle must answer "what was full"
            # on a laptop without digging through the health document.
            cap = getattr(self.collector, "capacity", None)
            if cap is not None:
                feeds["capacity.json"] = lambda: {
                    **cap.doc(),
                    "verdict": cap.verdict(),
                }
        fp_registry = self.fp_registry
        if fp_registry is None:
            from bftkv_tpu_torch.faults import failpoint as fp

            fp_registry = fp._active
        feeds["failpoints.json"] = lambda: [
            list(e) for e in fp_registry.trace()[-500:]
        ]

        def lockwatch_doc():
            from bftkv_tpu_torch.devtools import lockwatch

            return lockwatch.report() if lockwatch.enabled() else None

        feeds["lockwatch.json"] = lockwatch_doc
        for name, fn in feeds.items():
            try:
                out[name] = fn()
            except Exception as e:
                out[name] = {"feed_error": repr(e)}
        return out

    def snapshot(
        self,
        reason: str = "demand",
        anomalies: list | None = None,
    ) -> str:
        """Write one bundle NOW (the ``cmd.fleet --bundle`` demand
        path, and the first event of each anomaly window).  Returns the
        bundle directory path."""
        feeds = self._feeds()  # outside the lock: feeds take their own
        from bftkv_tpu_torch.obs import profiler

        profile = profiler.last()
        with self._lock:
            # One clock read for both halves: seconds and milliseconds
            # sampled separately can straddle a second boundary and
            # mint "57.999" AFTER "57.001" — and bundles() name-sort
            # IS the eviction order.
            now = time.time()
            stamp = time.strftime(
                "%Y%m%dT%H%M%S", time.gmtime(now)
            ) + f".{int(now * 1000) % 1000:03d}"
            safe = "".join(
                c if c.isalnum() or c in "-_" else "_" for c in reason
            )[:48]
            bundle = os.path.join(self.dir, f"bundle-{stamp}-{safe}")
            os.makedirs(bundle, exist_ok=True)
            files: dict[str, int] = {}
            for name, payload in feeds.items():
                p = os.path.join(bundle, name)
                with open(p, "w") as f:
                    json.dump(payload, f, indent=1, default=repr)
                files[name] = os.path.getsize(p)
            if profile:
                p = os.path.join(bundle, "profile.txt")
                with open(p, "w") as f:
                    f.write(profile)
                files["profile.txt"] = os.path.getsize(p)
            manifest = {
                "ts": time.time(),
                "reason": reason,
                "anomalies": list(anomalies or []),
                "files": files,
                "bytes": sum(files.values()),
            }
            mp = os.path.join(bundle, "manifest.json")
            with open(mp, "w") as f:
                json.dump(manifest, f, indent=1, default=repr)
            self._last_bundle = bundle
            self._last_ts = time.time()
            self._last_epoch = self._epoch
            self.bundle_count += 1
            self._enforce_caps_locked(keep=bundle)
        return bundle

    # -- disk bounds -------------------------------------------------------

    def bundles(self) -> list[str]:
        """Bundle directories on disk, oldest first (the stamp sorts)."""
        if not os.path.isdir(self.dir):
            return []
        return sorted(
            os.path.join(self.dir, n)
            for n in os.listdir(self.dir)
            if n.startswith("bundle-")
            and os.path.isdir(os.path.join(self.dir, n))
        )

    @staticmethod
    def _du(path: str) -> int:
        total = 0
        for dirpath, _dirs, files in os.walk(path):
            for fn in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, fn))
                except OSError:
                    pass
        return total

    def _enforce_caps_locked(self, keep: str) -> None:
        """Evict oldest bundles past either cap.  ``keep`` (the bundle
        just written) survives even when it alone busts the byte cap —
        an empty black box is worse than an oversized one."""
        bundles = self.bundles()
        sizes = {b: self._du(b) for b in bundles}
        while bundles and (
            len(bundles) > self.max_bundles
            or sum(sizes[b] for b in bundles) > self.max_bytes
        ):
            victim = bundles[0] if bundles[0] != keep else (
                bundles[1] if len(bundles) > 1 else None
            )
            if victim is None:
                break
            shutil.rmtree(victim, ignore_errors=True)
            bundles.remove(victim)
