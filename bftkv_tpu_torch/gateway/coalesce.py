"""Write coalescing: burst traffic collapses into shared quorum rounds.

Counterpart of ``bftkv_tpu/gateway/coalesce.py``.

Every caller's write lands in one queue; a flusher drains it with a
tiny linger window and turns one drained batch into the FEWEST quorum
rounds that commit it:

- a **same-variable burst** keeps only its newest value — one
  piggybacked WRITE_SIGN round (the collapsed path via
  ``Client.write``) commits it, and every caller of a superseded value
  is acked off that same round (``gateway.write.coalesced`` counts the
  writes that never paid a round of their own).  Within one burst the
  intermediate values were each durably superseded before any reader
  could require them — the same contract as a client overwriting its
  own variable back-to-back, minus the abandoned rounds;
- a **cross-variable burst** goes through ``Client.write_many``, which
  splits the batch by owning shard (``choose_quorum_for``) and runs
  one batched pipeline per shard.

The coalescer never re-orders across flushes and never merges across
variables, so per-variable semantics are exactly the underlying
client's.
"""

from __future__ import annotations

import logging
import queue
import threading

from bftkv_tpu_torch import trace
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["WriteCoalescer"]

log = logging.getLogger("bftkv_tpu_torch.gateway")


class _Waiter:
    __slots__ = ("variable", "value", "event", "error")

    def __init__(self, variable: bytes, value: bytes):
        self.variable = variable
        self.value = value
        self.event = threading.Event()
        self.error: Exception | None = None


class WriteCoalescer:
    LINGER = 0.003
    MAX_BATCH = 256

    def __init__(self, client, linger: float | None = None):
        self.client = client
        self.linger = self.LINGER if linger is None else linger
        self._q: "queue.SimpleQueue[_Waiter]" = queue.SimpleQueue()
        self._lock = named_lock("gateway.coalesce")
        self._thread: threading.Thread | None = None
        self._stopped = False

    def stop(self) -> None:
        self._stopped = True

    def submit_wait(
        self, variable: bytes, value: bytes, timeout: float = 30.0
    ) -> Exception | None:
        """Enqueue one write and block until its burst commits (or
        fails).  Returns None on success, the per-write error
        otherwise; a flusher wedged past ``timeout`` reports as a
        TimeoutError rather than hanging the caller."""
        w = _Waiter(variable, value)
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="bftkv-gw-coalesce"
                )
                self._thread.start()
        self._q.put(w)
        if not w.event.wait(timeout):
            return TimeoutError("gateway write coalescer timed out")
        return w.error

    def _run(self) -> None:
        import time

        while not self._stopped:
            try:
                batch = [self._q.get(timeout=5.0)]
            except queue.Empty:
                continue  # daemon thread: cheap to keep parked
            deadline = time.monotonic() + self.linger
            while len(batch) < self.MAX_BATCH:
                try:
                    batch.append(
                        self._q.get(
                            timeout=max(0.0, deadline - time.monotonic())
                        )
                    )
                except queue.Empty:
                    break
            try:
                self._flush(batch)
            except Exception as e:  # defensive: never strand waiters
                log.exception("gateway coalescer flush failed")
                for w in batch:
                    if not w.event.is_set():
                        w.error = e
                        w.event.set()

    def _flush(self, batch: list[_Waiter]) -> None:
        # Same-variable collapse: the LAST submitted value wins its
        # variable; every earlier waiter rides the winning write.
        by_var: "dict[bytes, list[_Waiter]]" = {}
        for w in batch:
            by_var.setdefault(w.variable, []).append(w)
        coalesced = len(batch) - len(by_var)
        if coalesced:
            metrics.incr("gateway.write.coalesced", coalesced)
        items = [(var, ws[-1].value) for var, ws in by_var.items()]
        with trace.span(
            "gateway.write_flush",
            attrs={"batch": len(batch), "variables": len(items)},
        ):
            if len(items) == 1:
                var, val = items[0]
                err = None
                try:
                    # ONE piggybacked WRITE_SIGN round (the collapsed path).
                    self.client.write(var, val)
                except Exception as e:
                    err = e
                errs = {var: err}
            else:
                # Cross-variable burst: one batched pipeline per owning
                # shard (write_many splits by choose_quorum_for).
                metrics.incr("gateway.write.batched_rounds")
                try:
                    res = self.client.write_many(items)
                    errs = {var: e for (var, _v), e in zip(items, res)}
                except Exception as e:
                    errs = {var: e for var, _v in items}
        for var, ws in by_var.items():
            err = errs.get(var)
            for w in ws:
                w.error = err
                w.event.set()
