"""Bounded admission queue of the port's crypto sidecar (a copy of
``bftkv_tpu/admission.py``, which the edge gateway shares).

One instance guards one service's expensive path: at most
``max_inflight`` operations run concurrently, at most ``max_queue``
more may WAIT for a slot (for up to ``max_wait`` seconds), and
anything past that is shed instantly — counted on the instance and on
the ``metric`` counter (labelled by ``op``) — instead of queueing
unbounded work onto a resource that is already the bottleneck.

Grew out of the gateway's admission control (DESIGN.md §14.4); the
sidecar reuses it verbatim with ``metric="sidecar.shed"`` so both
tiers shed with identical semantics (DESIGN.md §17.4).
"""

from __future__ import annotations

import threading
import time

from bftkv_tpu_torch.metrics import registry as metrics

__all__ = ["AdmissionQueue"]


class AdmissionQueue:
    """Bounded admission for a service's expensive (shared-resource)
    work.

    At most ``max_inflight`` operations run concurrently; at most
    ``max_queue`` more may WAIT for a slot (for up to ``max_wait``
    seconds).  Anything past that is shed instantly — ``metric``
    (default ``gateway.shed``) — instead of queueing unbounded work.
    Cheap paths (cache hits, control frames) never enter admission at
    all."""

    def __init__(
        self,
        max_inflight: int = 64,
        max_queue: int = 128,
        max_wait: float = 2.0,
        metric: str = "gateway.shed",
    ):
        self.max_inflight = max_inflight
        self.max_queue = max_queue
        self.max_wait = max_wait
        self.metric = metric
        #: Capacity-plane tier label ("gateway" / "sidecar"), derived
        #: from the shed-counter prefix so both tiers publish under the
        #: one closed `resource` dimension without a new ctor knob.
        self.tier = metric.split(".", 1)[0]
        self._cv = threading.Condition()
        self._inflight = 0
        self._waiting = 0
        #: Per-INSTANCE shed count — the process metrics registry is
        #: shared by every gateway/sidecar in one process, so /info
        #: must not report tier-wide totals as this instance's own.
        self.shed = 0

    def _publish(self) -> None:
        """Capacity-plane gauges (caller holds ``_cv``; the metrics
        registry lock is a leaf, same order ``incr`` already uses)."""
        lab = {"resource": self.tier}
        metrics.gauge("admission.inflight", float(self._inflight), labels=lab)
        metrics.gauge("admission.waiting", float(self._waiting), labels=lab)
        metrics.gauge("admission.limit", float(self.max_inflight), labels=lab)
        metrics.gauge("admission.queue_limit", float(self.max_queue), labels=lab)

    def acquire(self, op: str) -> bool:
        """True = admitted (caller MUST release); False = shed."""
        t0 = time.monotonic()
        deadline = t0 + self.max_wait
        with self._cv:
            if self._inflight < self.max_inflight:
                self._inflight += 1
                self._publish()
                metrics.observe(
                    "admission.wait", 0.0, labels={"resource": self.tier}
                )
                return True
            if self._waiting >= self.max_queue:
                self.shed += 1
                metrics.incr(self.metric, labels={"op": op})
                self._publish()
                return False
            self._waiting += 1
            self._publish()
            try:
                while self._inflight >= self.max_inflight:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cv.wait(remaining):
                        if self._inflight >= self.max_inflight:
                            self.shed += 1
                            metrics.incr(
                                self.metric, labels={"op": op}
                            )
                            metrics.observe(
                                "admission.wait",
                                time.monotonic() - t0,
                                labels={"resource": self.tier},
                            )
                            return False
                self._inflight += 1
                metrics.observe(
                    "admission.wait",
                    time.monotonic() - t0,
                    labels={"resource": self.tier},
                )
                return True
            finally:
                self._waiting -= 1
                self._publish()

    def release(self) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify()
            self._publish()

    def depth(self) -> tuple[int, int]:
        with self._cv:
            return self._inflight, self._waiting
