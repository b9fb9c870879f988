"""Bounded LRU memo of *successful* signature verifications (counterpart of
``bftkv_tpu/crypto/vcache.py``).

The write hot path re-verifies the same ``<x,t,v>`` triple at several
stations: a writer signature is checked by every replica at sign
admission, the collective signature is checked by the client after
combine and again by every replica at write time, then again on read
(complete-fan-out candidates), read-repair and anti-entropy
re-admission.  Each check is the same pure mathematical fact —
"``sig`` verifies over ``tbs`` under public key ``K``" — recomputed
from scratch (BENCH_r05: 3,840 verifies for 160 writes, ~24 per
write).

This memo caches that fact.  Soundness argument (DESIGN.md §9):

- The key is the full triple ``(signer id, public-key fingerprint,
  tbs digest, sig digest)`` — flipping any byte of signer key, message
  or signature misses.  Verification is a deterministic function of
  exactly those inputs; membership/quorum/revocation *policy* is NOT
  cached and is re-evaluated by the caller on every request.
- Only **positive** results are stored.  A negative is never cached: a
  Byzantine peer must not be able to poison a rejection (e.g. one
  induced by a transient keyring gap) into a later acceptance — and
  conversely a cached rejection could mask a later honest retry.
- Entries are evicted on revocation of their signer.  This is
  belt-and-braces (revocation is enforced by quorum policy outside the
  math), but it keeps the cache from holding facts about identities
  the node has decided to forget.
- TPA-protected verifies bypass the cache entirely (callers pass
  ``use_cache=False``): auth proofs are password-derived and replayed
  across requests, so they are exactly the shape where a stale cached
  fact could outlive an auth-state change.

A successful *signing* operation may also seed the memo ("seeding"):
RSASSA-PKCS1-v1_5 and deterministic-nonce ECDSA are correct signature
schemes, so a signature this process just produced with key ``K`` over
``tbs`` verifies under ``K`` by construction.

The memo is process-global: one OS process is one trust domain (a
replica, a client, or an in-process test/bench cluster whose host is
one domain by construction — the same stance the batching dispatchers
take, ops/dispatch.py).  Facts cached here are domain-independent
mathematics; trust decisions stay with each caller's keyring/quorum.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = [
    "VerifyCache",
    "cache",
    "enabled",
    "fingerprint",
    "get",
    "put",
    "seed_own_signature",
    "invalidate_signer",
    "reset",
]


def fingerprint(cert) -> bytes:
    """Digest binding the signer's *public key material* (not just its
    id): two certificates sharing an id but differing in key bytes must
    never share cache entries."""
    fp = getattr(cert, "_vcache_fp", None)
    if fp is None:
        # Fields are separator-delimited: without boundaries,
        # (n=...6, e=5537) and (n=..., e=65537) would concatenate to
        # the same digest and two distinct keys could share entries —
        # exactly the collision this fingerprint exists to prevent.
        # "|" cannot appear in decimal digits or the alg names, and
        # the binary point comes last.
        h = hashlib.sha256()
        h.update(str(getattr(cert, "alg", "")).encode())
        h.update(b"|")
        h.update(str(getattr(cert, "n", 0)).encode())
        h.update(b"|")
        h.update(str(getattr(cert, "e", 0)).encode())
        h.update(b"|")
        point = getattr(cert, "point", None)
        if point:
            h.update(point if isinstance(point, bytes) else bytes(point))
        fp = h.digest()
        try:
            cert._vcache_fp = fp
        except Exception:
            pass  # immutable cert types still work, just un-memoized
    return fp


class VerifyCache:
    """LRU of (signer id, key fp, tbs digest, sig digest) → verified."""

    def __init__(self, maxsize: int = 65536):
        self.maxsize = maxsize
        self._lock = named_lock("crypto.vcache")
        self._entries: "OrderedDict[tuple, bool]" = OrderedDict()
        # signer id -> set of entry keys, for O(entries-of-signer)
        # revocation eviction.
        self._by_signer: dict[int, set] = {}

    @staticmethod
    def _key(signer_id: int, key_fp: bytes, tbs: bytes, sig: bytes) -> tuple:
        return (
            signer_id,
            key_fp,
            hashlib.sha256(tbs).digest(),
            hashlib.sha256(sig).digest(),
        )

    def get(self, signer_id: int, key_fp: bytes, tbs: bytes, sig: bytes) -> bool:
        """True iff this exact triple is known-verified.

        Lock-free: this is the hottest call on the write path, and a
        shared lock here was a measured GIL convoy (every blocked
        acquire parks the thread).  Membership test and LRU touch are
        each single C-level OrderedDict operations — atomic under the
        GIL; a concurrent eviction between them only makes the touch a
        no-op (the except), never a wrong answer."""
        k = self._key(signer_id, key_fp, tbs, sig)
        entries = self._entries
        hit = k in entries
        if hit:
            try:
                entries.move_to_end(k)
            except (KeyError, RuntimeError):
                pass
        metrics.incr("verify.cache.hits" if hit else "verify.cache.misses")
        return hit

    def put(self, signer_id: int, key_fp: bytes, tbs: bytes, sig: bytes) -> None:
        """Record a SUCCESSFUL verification (positives only by contract;
        callers must never put a failure)."""
        k = self._key(signer_id, key_fp, tbs, sig)
        with self._lock:
            self._entries[k] = True
            self._entries.move_to_end(k)
            self._by_signer.setdefault(signer_id, set()).add(k)
            while len(self._entries) > self.maxsize:
                old, _ = self._entries.popitem(last=False)
                keys = self._by_signer.get(old[0])
                if keys is not None:
                    keys.discard(old)
                    if not keys:
                        del self._by_signer[old[0]]

    def invalidate_signer(self, signer_id: int) -> None:
        with self._lock:
            keys = self._by_signer.pop(signer_id, None)
            if keys:
                for k in keys:
                    self._entries.pop(k, None)
                metrics.incr("verify.cache.evicted", len(keys))

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()
            self._by_signer.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: Process-global instance; ``BFTKV_VERIFY_CACHE=0`` disables all
#: consultation and seeding, ``BFTKV_VERIFY_CACHE_MAX`` sizes it.
cache = VerifyCache(
    maxsize=int(flags.raw("BFTKV_VERIFY_CACHE_MAX", "65536") or 65536)
)

_ENABLED = flags.raw("BFTKV_VERIFY_CACHE", "1") != "0"


def enabled() -> bool:
    return _ENABLED


def get(cert, tbs: bytes, sig: bytes) -> bool:
    """True iff (cert, tbs, sig) is a memoized successful verify."""
    if not _ENABLED:
        return False
    return cache.get(cert.id, fingerprint(cert), tbs, sig)


def put(cert, tbs: bytes, sig: bytes) -> None:
    if not _ENABLED:
        return
    cache.put(cert.id, fingerprint(cert), tbs, sig)


def seed_own_signature(cert, tbs: bytes, sig: bytes) -> None:
    """Seed from a signature this process just PRODUCED with its own
    key: sign-then-verify succeeds by the scheme's correctness, so the
    fact is as established as a fresh verify."""
    if not _ENABLED:
        return
    metrics.incr("verify.cache.seeded")
    cache.put(cert.id, fingerprint(cert), tbs, sig)


def invalidate_signer(signer_id: int) -> None:
    cache.invalidate_signer(signer_id)


def reset() -> None:
    cache.reset()
