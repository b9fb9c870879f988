"""Anti-entropy: Byzantine-safe replica state-sync (counterpart of
``bftkv_tpu/sync/__init__.py``).

The reference protocol repairs stale replicas only opportunistically —
a client pushes the winning packet back during a quorum read
(protocol/client.go:281-302) — so a replica that was down during a
write window stays stale until some client happens to read that exact
key through it.  This package is the explicit state-recovery plane
(the Thetacrypt lesson, PAPERS.md), kept OFF the hot path: background
digest exchange + record pull whose verification cost rides the
existing batched device pipeline.

- :mod:`bftkv_tpu_torch.sync.digest` — prefix-bucketed rolling hashes over
  ``<variable, t, value-hash>`` triples, computed incrementally from
  storage (``keys()``/``versions()``/``read()`` contract);
- :mod:`bftkv_tpu_torch.sync.daemon` — the :class:`SyncDaemon` round loop
  and :func:`admit_records`, the full local admission path every pulled
  record must survive (collective-signature sufficiency verified as one
  device batch, then timestamp/TOFU/equivocation checks);
- wire: ``SYNC_DIGEST`` / ``SYNC_PULL`` commands
  (:mod:`bftkv_tpu_torch.transport`), codecs in :mod:`bftkv_tpu_torch.packet`,
  handlers in :class:`bftkv_tpu_torch.protocol.server.Server`.

Peers are never trusted: a Byzantine peer can waste bandwidth but can
never poison state, because admission is the same code path a client
write faces.
"""

from __future__ import annotations

from bftkv_tpu_torch.sync.daemon import SyncDaemon, admit_records
from bftkv_tpu_torch.sync.digest import DigestTree, bucket_of, record_hash

__all__ = [
    "SyncDaemon",
    "admit_records",
    "DigestTree",
    "bucket_of",
    "record_hash",
]
