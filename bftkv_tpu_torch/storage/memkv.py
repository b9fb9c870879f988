"""In-memory versioned KV store (counterpart of ``bftkv_tpu/storage/memkv.py``).

The simulated-cluster backend: hundreds of replicas in one process each
get an isolated ``MemStorage`` (the analog of the reference tests running
one leveldb per key directory). Layout mirrors the leveldb backend's key
order — per-variable versions kept sorted so "latest" is O(1)
(reference: storage/leveldb/leveldb.go:30-46, prefix iterator ``Last()``).
"""

from __future__ import annotations

import bisect

from bftkv_tpu_torch.errors import ERR_NOT_FOUND
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.devtools.lockwatch import named_lock


class MemStorage:
    def __init__(self):
        # variable -> (sorted list of t, {t: value})
        self._data: dict[bytes, tuple[list[int], dict[int, bytes]]] = {}
        self._lock = named_lock("storage.mem")

    def read(self, variable: bytes, t: int = 0) -> bytes:
        with self._lock:
            entry = self._data.get(variable)
            if entry is None:
                raise ERR_NOT_FOUND
            ts, values = entry
            if t == 0:
                t = ts[-1]
            value = values.get(t)
            if value is None:
                raise ERR_NOT_FOUND
            return value

    def versions(self, variable: bytes) -> list[int]:
        """All stored timestamps for ``variable`` (ascending)."""
        with self._lock:
            entry = self._data.get(variable)
            return list(entry[0]) if entry else []

    def keys(self) -> list[bytes]:
        """Every stored variable (storage contract — anti-entropy)."""
        with self._lock:
            return list(self._data)

    def scan(self) -> list[tuple[bytes, int]]:
        """Every stored ``(variable, t)`` pair, one index walk."""
        with self._lock:
            return [
                (var, t)
                for var, (ts, _values) in self._data.items()
                for t in ts
            ]

    def write(self, variable: bytes, t: int, value: bytes) -> None:
        if fp.ARMED:
            # ``storage.write`` failpoint: the in-memory backend can
            # only fail whole ("torn" is meaningless without files).
            act = fp.fire("storage.write", backend="mem", op="write")
            if act is not None and act.kind in ("io_error", "torn"):
                raise OSError("injected storage I/O error")
        with self._lock:
            entry = self._data.get(variable)
            if entry is None:
                entry = ([], {})
                self._data[variable] = entry
            ts, values = entry
            if t not in values:
                bisect.insort(ts, t)
            values[t] = value
