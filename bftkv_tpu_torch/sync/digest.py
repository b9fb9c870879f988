"""Keyspace digest tree: prefix-bucketed rolling hashes over the
replica's completed records (counterpart of ``bftkv_tpu/sync/digest.py``).

The tree summarizes what a replica would serve: for every variable, the
*latest completed* version (``ss`` present and completed — in-progress
sign records and bare auth records are invisible, exactly as they are to
a quorum read).  Each variable lands in one of 256 buckets by the first
byte of ``sha256(variable)``; a bucket's hash is the XOR-fold of its
record hashes ``sha256(len(x) | x | t | sha256(v))`` — XOR is
commutative, so bucket membership needs no ordering and a single
record's change re-derives from the bucket's variables alone.

Incrementality: the first build walks ``storage.keys()`` once; after
that, every server-side persist marks the written VARIABLE dirty and
the next digest request re-reads only the dirty variables — each
bucket hash is patched by XOR-ing the variable's cached old
contribution out and its fresh one in, so a digest round after N
changed records costs O(N) storage reads regardless of keyspace size
(the §19 log engine's bound; it holds for every backend).  The tree
caches one integer per variable, never record bytes — storage stays
the single source of truth, so a crash/restart simply rebuilds.

Two replicas with equal trees serve identical completed state; a
divergent bucket names the (at most 1/256th) slice of the keyspace to
pull.  The reference has no analog — its only repair plane is client
read-repair (protocol/client.go:281-302).

Sharding interplay: a digest bucket is exactly one *routing* bucket
(``quorum.wotqs.route_bucket`` uses the same ``sha256(x)[0]``), so
shard ownership partitions the tree cleanly.  The tree itself stays
shard-blind on purpose — it summarizes what the replica HAS, including
buckets a routing-generation change just took away, which is how a new
owner pulls migrated state (the old owner serves it; the pull filter
and the admission gate live on the *consuming* side, sync/daemon.py).
"""

from __future__ import annotations

import hashlib
import struct

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch.errors import ERR_NOT_FOUND

# Variables holding threshold-CA shares are replica-local secrets and
# never sync — the ONE sentinel the server defines, not a copy that
# could silently diverge from it.
from bftkv_tpu_torch.protocol.server import HIDDEN_PREFIX
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = [
    "DigestTree",
    "bucket_of",
    "record_hash",
    "latest_completed",
    "HIDDEN_PREFIX",
]

_EMPTY = bytes(pkt.DIGEST_HASH_LEN)


def bucket_of(variable: bytes) -> int:
    return hashlib.sha256(variable).digest()[0]


def record_hash(variable: bytes, t: int, value: bytes | None) -> bytes:
    h = hashlib.sha256()
    h.update(struct.pack(">Q", len(variable)))
    h.update(variable)
    h.update(struct.pack(">Q", t))
    h.update(hashlib.sha256(value or b"").digest())
    return h.digest()


def latest_completed(
    storage, variable: bytes
) -> tuple[int, bytes, pkt.Packet] | None:
    """(t, raw record bytes, parsed packet) of the newest stored
    version whose collective signature is completed, or None.  Scans
    versions descending — the same walk the server read path does past
    in-progress sign records.  The parsed packet rides along so
    digest/admission callers never re-parse multi-MB records.

    TPA-protected records (stored ``auth`` params) are invisible to the
    sync plane entirely: the read path serves their values only behind
    a cryptographically verified auth proof, and the sync peer gate is
    weaker than that (keyring membership — which open Join enrollment
    can satisfy).  Excluding them from BOTH digest and pull keeps the
    trees consistent; protected variables keep the reference's
    read-repair-only recovery."""
    try:
        versions = sorted(storage.versions(variable), reverse=True)
    except Exception:
        return None
    for t in versions:
        try:
            raw = storage.read(variable, t)
        except ERR_NOT_FOUND:
            continue
        try:
            p = pkt.parse(raw)
        except Exception:
            # Undecodable stored bytes: the digest skips them —
            # hostile storage must not kill the sync round.
            continue
        if p.auth is not None:
            return None  # protected variable: not syncable at all
        if p.ss is not None and p.ss.completed:
            return t, raw, p
    return None


class DigestTree:
    """Per-storage digest with dirty-VARIABLE invalidation: a digest
    round costs O(records changed since the last round), not O(dirty
    buckets × bucket population)."""

    def __init__(self, storage):
        self.storage = storage
        self._lock = named_lock("sync.digest")
        self._vars: dict[int, set[bytes]] = {}
        #: variable -> its current XOR contribution to its bucket (as
        #: an int; 0 = contributes nothing).  The cache that buys
        #: O(changed): patching a bucket is old-out/new-in, no walk.
        self._contrib: dict[bytes, int] = {}
        self._hash_int: dict[int, int] = {}
        self._dirty: dict[int, set[bytes]] = {}
        self._built = False

    # -- write-path hook ---------------------------------------------------

    def mark(self, variable: bytes) -> None:
        """Invalidate the written variable (cheap dict ops only; called
        from every server persist).  Recording even before the first
        build means a write landing DURING the build's keyspace scan
        cannot be lost — the merge in :meth:`_ensure_built` keeps it."""
        if variable.startswith(HIDDEN_PREFIX):
            return
        b = bucket_of(variable)
        with self._lock:
            self._vars.setdefault(b, set()).add(variable)
            self._dirty.setdefault(b, set()).add(variable)

    # -- digest ------------------------------------------------------------

    def _ensure_built(self) -> None:
        """One-time keyspace enumeration, with the storage walk OUTSIDE
        the tree lock — ``mark()`` sits on the foreground write path
        and must never wait behind a 100k-variable listdir."""
        with self._lock:
            if self._built:
                return
        keys = self.storage.keys()
        with self._lock:
            if self._built:
                return  # another thread's scan won; marks kept us fresh
            for var in keys:
                if var.startswith(HIDDEN_PREFIX):
                    continue
                b = bucket_of(var)
                self._vars.setdefault(b, set()).add(var)
                self._dirty.setdefault(b, set()).add(var)
            self._built = True

    def buckets(self) -> dict[int, bytes]:
        """Non-empty bucket hashes, re-reading only DIRTY variables.

        The per-record storage reads happen OUTSIDE the tree lock:
        ``mark()`` sits on every server persist, so holding the lock
        through the reads would stall the foreground write path behind
        a background digest request.  A variable marked dirty again
        mid-recompute lands in the next round's dirty set and refreshes
        then — staleness is bounded by one round either way."""
        self._ensure_built()
        with self._lock:
            dirty = self._dirty
            self._dirty = {}
            todo = [
                (b, var) for b, vs in dirty.items() for var in sorted(vs)
            ]
        fresh: list[tuple[int, bytes, int]] = []
        for b, var in todo:
            rec = latest_completed(self.storage, var)
            if rec is None:
                new = 0
            else:
                t, _raw, p = rec
                new = int.from_bytes(record_hash(var, t, p.value), "big")
            fresh.append((b, var, new))
        with self._lock:
            for b, var, new in fresh:
                old = self._contrib.get(var, 0)
                if new == old:
                    continue
                acc = self._hash_int.get(b, 0) ^ old ^ new
                if acc:
                    self._hash_int[b] = acc
                else:
                    self._hash_int.pop(b, None)
                if new:
                    self._contrib[var] = new
                else:
                    self._contrib.pop(var, None)
            return {
                b: acc.to_bytes(pkt.DIGEST_HASH_LEN, "big")
                for b, acc in self._hash_int.items()
            }

    def bucket_variables(self, b: int) -> list[bytes]:
        """Variables currently assigned to bucket ``b`` (serving side
        of SYNC_PULL)."""
        self._ensure_built()
        with self._lock:
            return sorted(self._vars.get(b, ()))

    def root(self) -> bytes:
        """One hash over the whole tree (convergence checks/tests)."""
        h = hashlib.sha256()
        for b, digest in sorted(self.buckets().items()):
            h.update(bytes([b]))
            h.update(digest)
        return h.digest()

    def serialize(self) -> bytes:
        return pkt.serialize_digest(self.buckets())
