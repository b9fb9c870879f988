"""Certified-record cache: bounded LRU + TTL, certified entries only.

Counterpart of ``bftkv_tpu/gateway/cache.py``.

The cache stores RAW record bytes ``<x, t, v, ss>`` whose completed
collective signature the gateway has already verified against the owner
quorum (gateway.py enforces that before every ``put`` — this module
just keeps the soundness-preserving bookkeeping):

- ``put`` never lets an older version clobber a newer one (a slow fill
  racing a write-through of the next timestamp must lose);
- entries expire after ``ttl`` seconds and evict LRU past
  ``max_entries`` — the backstop for invalidation traffic the gateway
  never saw (a direct client write, another gateway's write);
- every entry is indexed by its anti-entropy digest bucket
  (``sync.digest.bucket_of`` — the same ``sha256(x)[0]`` the routing
  plane uses), so a divergent-bucket signal from the sync plane
  invalidates exactly the affected 1/256th of the cache.

TPA-protected records must never be cached (the gateway would serve a
proof-gated value prooflessly); gateway.py filters them before ``put``.
"""

from __future__ import annotations

import time
from collections import OrderedDict

from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.sync.digest import bucket_of
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["CertifiedCache"]


class _Entry:
    __slots__ = ("t", "record", "expires")

    def __init__(self, t: int, record: bytes, expires: float):
        self.t = t
        self.record = record
        self.expires = expires


class CertifiedCache:
    def __init__(self, max_entries: int = 65536, ttl: float = 30.0):
        self.max_entries = max_entries
        self.ttl = ttl
        self._lock = named_lock("gateway.cache")
        self._od: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._buckets: dict[int, set[bytes]] = {}

    def __len__(self) -> int:
        with self._lock:
            return len(self._od)

    def get(
        self, variable: bytes, *, allow_stale: bool = False
    ) -> _Entry | None:
        """The live entry for ``variable`` (LRU-touched), or None.
        ``allow_stale`` also returns a TTL-expired entry — the
        degraded-shard fallback: the bytes are still CERTIFIED, only
        their freshness window has lapsed (gateway.py counts
        ``gateway.cache.stale_served`` when it uses one)."""
        now = time.monotonic()
        with self._lock:
            ent = self._od.get(variable)
            if ent is None:
                return None
            if ent.expires <= now and not allow_stale:
                return None
            self._od.move_to_end(variable)
            return ent

    def put(self, variable: bytes, t: int, record: bytes) -> bool:
        """Install a CERTIFIED record (caller has verified ``ss``).
        Returns False when a same-or-newer version is already cached —
        a stale fill racing a fresher write-through must not regress
        the entry (the TTL clock does restart on an exact-t refresh)."""
        now = time.monotonic()
        with self._lock:
            ent = self._od.get(variable)
            if ent is not None and ent.t > t:
                return False
            self._od[variable] = _Entry(t, record, now + self.ttl)
            self._od.move_to_end(variable)
            self._buckets.setdefault(bucket_of(variable), set()).add(
                variable
            )
            while len(self._od) > self.max_entries:
                old_var, _old = self._od.popitem(last=False)
                self._unindex_locked(old_var)
                metrics.incr("gateway.cache.evictions")
        return True

    def _unindex_locked(self, variable: bytes) -> None:
        b = bucket_of(variable)
        vs = self._buckets.get(b)
        if vs is not None:
            vs.discard(variable)
            if not vs:
                self._buckets.pop(b, None)

    def invalidate(self, variable: bytes) -> bool:
        with self._lock:
            ent = self._od.pop(variable, None)
            if ent is not None:
                self._unindex_locked(variable)
        if ent is not None:
            metrics.incr("gateway.cache.invalidations")
        return ent is not None

    def invalidate_bucket(self, bucket: int) -> int:
        """Drop every entry whose variable hashes into ``bucket`` (the
        anti-entropy invalidation hook).  Returns the count dropped."""
        with self._lock:
            vs = self._buckets.pop(bucket, None)
            if not vs:
                return 0
            for v in vs:
                self._od.pop(v, None)
            n = len(vs)
        metrics.incr("gateway.cache.invalidations", n)
        return n

    def clear(self) -> None:
        with self._lock:
            self._od.clear()
            self._buckets.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._od),
                "max_entries": self.max_entries,
                "ttl_s": self.ttl,
            }
