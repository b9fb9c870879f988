"""Versioned key-value storage backends (counterpart of ``bftkv_tpu/storage/__init__.py``).

Capability parity with the reference storage layer
(reference: storage/storage.go:14-17): ``read(variable, t)`` with
``t == 0`` meaning "the latest version", ``write(variable, t, value)``
appending a version. Every version is retained — the store *is* the
durable state of a replica (SURVEY.md §5 "Checkpoint / resume").

Backends:

- :class:`bftkv_tpu_torch.storage.plain.PlainStorage` — one file per version
  (reference: storage/plain/plain.go:22-90);
- :class:`bftkv_tpu_torch.storage.memkv.MemStorage` — in-process sorted map,
  used by tests and simulated clusters;
- :class:`bftkv_tpu_torch.storage.native.NativeStorage` — C++ log-structured
  engine (the leveldb-equivalent, reference: storage/leveldb/leveldb.go),
  loaded via ctypes when the shared library has been built;
- :class:`bftkv_tpu_torch.storage.logkv.LogStorage` — append-only group-commit
  segment log with compaction and snapshot shipping (DESIGN.md §19),
  the planet-scale engine (`--storage log`).

Optional seams (feature-detected with ``getattr``, never required —
the Protocol below stays the contract every backend must meet):

- ``write_batch(items)`` — persist a coalesced batch under ONE
  durability barrier (group commit).  The server's persist-many path
  and ``admit_records`` use it when present and fall back to per-item
  ``write`` when not;
- ``sorted_keys(after=None, limit=None)`` — a cheap sorted-keyspace
  cursor for the windowed ``pending_variables`` repair scan, replacing
  a full ``sorted(keys())`` per round;
- ``snapshot_records(pred)`` / ``seal_active()`` — sealed-segment bulk
  streaming, the §15 migration pre-copy transfer unit;
- ``reopen()`` / ``close()`` — crash-restart onto the same directory
  (index rebuild, torn-tail truncation) and clean shutdown.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.errors import ERR_NOT_FOUND

__all__ = ["Storage", "ERR_NOT_FOUND", "ENGINES", "open_engine"]

#: The engines the daemon's ``--storage`` switch names.
ENGINES = ("plain", "log", "native", "mem")


def open_engine(kind: str | None, path: str = ""):
    """Open the engine ``kind`` on ``path`` with the daemon's durability
    settings (the reference's ``cmd/bftkv.py::build_server`` switch):
    PlainStorage fsyncs each write unless ``BFTKV_PLAIN_FSYNC=0``,
    LogStorage group-commits its fsyncs, NativeStorage and MemStorage
    take their defaults.  ``kind=None`` reads ``BFTKV_STORAGE`` (unset:
    ``plain``, the daemon's default)."""
    kind = kind or flags.get("BFTKV_STORAGE") or "plain"
    if kind == "plain":
        from bftkv_tpu_torch.storage.plain import PlainStorage

        return PlainStorage(path, fsync=flags.raw("BFTKV_PLAIN_FSYNC", "1") != "0")
    if kind == "log":
        from bftkv_tpu_torch.storage.logkv import LogStorage

        return LogStorage(path)
    if kind == "native":
        from bftkv_tpu_torch.storage.native import NativeStorage

        return NativeStorage(path)
    if kind == "mem":
        from bftkv_tpu_torch.storage.memkv import MemStorage

        return MemStorage()
    raise ValueError(f"unknown storage engine {kind!r} (one of {', '.join(ENGINES)})")


@runtime_checkable
class Storage(Protocol):
    """The storage interface (reference: storage/storage.go:14-17)."""

    def read(self, variable: bytes, t: int = 0) -> bytes:
        """Return the value at timestamp ``t``; ``t == 0`` means latest.

        Raises ``ERR_NOT_FOUND`` if the variable (or that version) does
        not exist.
        """
        ...

    def write(self, variable: bytes, t: int, value: bytes) -> None:
        """Store ``value`` as version ``t`` of ``variable``."""
        ...

    def versions(self, variable: bytes) -> list[int]:
        """All stored version timestamps for ``variable`` (any order;
        empty if unknown).

        Part of the storage contract: the server's read path scans back
        past in-progress sign records with it (the reference walks the
        leveldb key range the same way, storage/leveldb/leveldb.go:30-46).
        A backend without it degrades to a bounded countdown that cannot
        reach completed versions more than 1024 timestamps behind an
        incomplete write-once record.
        """
        ...

    def keys(self) -> list[bytes]:
        """Every stored variable, each exactly once (any order).

        The keyspace-enumeration half of the anti-entropy contract
        (``bftkv_tpu_torch.sync``): a replica's digest tree is computed from
        ``keys()`` × ``versions()`` × ``read()``.  The reference has no
        analog — its repair plane is client read-repair only — so this
        is a genuine contract extension all three backends implement.
        """
        ...

    def scan(self) -> list[tuple[bytes, int]]:
        """Every stored ``(variable, t)`` pair (any order) — the full
        version inventory in one call, for digest builds and
        differential backend tests.  Equivalent to
        ``[(v, t) for v in keys() for t in versions(v)]`` but a backend
        may implement it with one index walk."""
        ...
