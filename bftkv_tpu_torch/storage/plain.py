"""Plain-file storage: one file per version (counterpart of ``bftkv_tpu/storage/plain.py``).

File name is ``hex(variable).t`` inside the store directory; the latest
version is found by scanning for the maximum ``t`` suffix
(reference: storage/plain/plain.go:28-60). Writes are **crash-safe**:
write-to-temp, fsync the file, rename, fsync the directory — a torn
write can only ever leave a partial ``.tmp`` the read/inventory paths
ignore, never a half-written version (the reference renames but never
fsyncs, plain.go:62-75, so a power cut could publish an empty rename or
lose the directory entry).  The whole store is guarded by a lock the
same way the reference serializes file I/O with a mutex
(reference: storage/plain/plain.go:19).
"""

from __future__ import annotations

import bisect
import os
import threading
from collections import OrderedDict

from bftkv_tpu_torch.errors import ERR_NOT_FOUND
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools import lockwatch
from bftkv_tpu_torch.devtools.lockwatch import named_lock


class PlainStorage:
    def __init__(self, path: str, *, fsync: bool | None = None):
        self.path = path
        self._lock = named_lock("storage.plain")
        # The write *ordering* (temp + rename) is always on — a crash
        # can never publish a torn version.  The per-write fsync pair
        # (file + directory) is a durability policy: ~5 ms/write on
        # commodity disks, so the library default matches the
        # reference's leveldb stance (WriteOptions.sync=false) and the
        # daemon opts IN (cmd/bftkv.py) — power-cut durability is a
        # deployment property, not a test-harness one.
        # BFTKV_PLAIN_FSYNC=1/0 overrides either way.
        if fsync is None:
            env = flags.raw("BFTKV_PLAIN_FSYNC", "")
            fsync = env == "1"
        self.fsync = fsync
        # stem -> max stored t.  ``read(variable, 0)`` used to list the
        # WHOLE directory to find the latest version — O(total files)
        # of GIL-dropping syscalls per read, quadratic over a write
        # burst.  The index is rebuilt from one listing on first use
        # (so a restart onto an existing store stays correct) and
        # maintained by ``write``; the store is single-process by
        # contract (the reference serializes it behind one mutex too),
        # so no other writer can stale it.
        self._latest: dict[str, int] | None = None
        # stem -> sorted stored ts, rebuilt by the same one-time listing
        # and maintained by ``write``.  ``versions()`` used to list the
        # whole directory per call — profiled hot in repair scans,
        # where every pending variable asks for its version set.
        self._versions: dict[str, list[int]] | None = None
        # Write-through record cache (the block-cache any storage
        # engine keeps): the protocol re-reads a variable's latest
        # record at every admission station, and on slow filesystems
        # those opens dominated the whole write path.  Bounded LRU of
        # (stem, t) -> bytes; entries are installed from durable state
        # only (after the atomic rename), so the cache can never serve
        # bytes a crash could lose that the file couldn't.
        # BFTKV_PLAIN_CACHE sizes it (entries; 0 disables).
        self._cache: "OrderedDict[tuple[str, int], bytes]" = OrderedDict()
        self._cache_max = int(flags.raw("BFTKV_PLAIN_CACHE", "1024") or 0)
        os.makedirs(path, exist_ok=True)

    def _prefix(self, variable: bytes) -> str:
        # hex(variable) as the file stem (reference: plain.go:28-33), but
        # long variables would blow the 255-byte filename limit — hash them.
        if len(variable) > 96:
            import hashlib

            return "h" + hashlib.sha256(variable).hexdigest()
        return variable.hex()

    def _index_locked(self) -> dict[str, int]:
        """The latest-version index; caller holds the lock.

        The FIRST-use rebuild lists the directory while holding the
        lock — deliberately: ``write()`` only maintains the index when
        it exists, so a rebuild racing a concurrent write outside the
        lock could publish an index missing that write's version
        forever.  One listing per process lifetime; lockwatch-waived
        with that reason."""
        idx = self._latest
        if idx is None:
            idx = {}
            vers: dict[str, list[int]] = {}
            try:
                with lockwatch.waiver(
                    "plain: one-time index rebuild must hold the store "
                    "lock (write() skips index updates while it is None)"
                ):
                    names = os.listdir(self.path)
            except FileNotFoundError:
                names = []
            for name in names:
                stem, sep, suffix = name.rpartition(".")
                if not sep:
                    continue
                try:
                    t = int(suffix)
                except ValueError:
                    continue  # .tmp / .k sidecars
                if t > idx.get(stem, -1):
                    idx[stem] = t
                vers.setdefault(stem, []).append(t)
            for ts in vers.values():
                ts.sort()
            self._versions = vers
            self._latest = idx
        return idx

    def _latest_t(self, variable: bytes) -> int | None:
        return self._index_locked().get(self._prefix(variable))

    def read(self, variable: bytes, t: int = 0) -> bytes:
        # The lock covers only index/cache state; the file I/O itself
        # runs outside it (data files are never deleted and renames are
        # atomic, so a concurrent writer cannot tear a read — but a
        # lock held across a ~10 ms open on a slow filesystem WOULD
        # serialize every concurrent handler touching this store).
        stem = self._prefix(variable)
        with self._lock:
            if t == 0:
                latest = self._latest_t(variable)
                if latest is None:
                    raise ERR_NOT_FOUND
                t = latest
            if self._cache_max:
                data = self._cache.get((stem, t))
                if data is not None:
                    self._cache.move_to_end((stem, t))
                    return data
        fn = os.path.join(self.path, f"{stem}.{t}")
        try:
            with open(fn, "rb") as f:
                data = f.read()
        except FileNotFoundError:
            raise ERR_NOT_FOUND from None
        with self._lock:
            self._cache_put_locked(stem, t, data)
        return data

    def _cache_put_locked(self, stem: str, t: int, data: bytes) -> None:
        if not self._cache_max:
            return
        self._cache[(stem, t)] = data
        self._cache.move_to_end((stem, t))
        while len(self._cache) > self._cache_max:
            self._cache.popitem(last=False)

    def _write_atomic(self, fn: str, data: bytes) -> None:
        """temp + fsync(file) + rename + fsync(dir).  After a crash at
        ANY point, readers see either the old state or the complete new
        file — never a torn version.  The temp name is per-thread: I/O
        runs outside the store lock, and two racing persists of one
        ``(variable, t)`` (a late staged-sign tail vs the write phase)
        must not interleave inside a shared temp file.  Non-integer
        suffixes are invisible to every read/inventory path."""
        tmp = f"{fn}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        os.replace(tmp, fn)
        if self.fsync:
            dfd = os.open(self.path, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)

    def write(self, variable: bytes, t: int, value: bytes) -> None:
        # File I/O outside the lock (see read()): per-(variable, t) the
        # rename is atomic and last-writer-wins, and the index/cache
        # update re-takes the lock after the bytes are durable.
        stem = self._prefix(variable)
        if stem.startswith("h"):
            # Hash-stemmed long variable: the name is one-way, so
            # keys() needs a sidecar holding the raw bytes.  ".k"
            # never parses as a version (int("k") fails) and the
            # write is atomic like the data files'.
            kf = os.path.join(self.path, stem + ".k")
            if not os.path.exists(kf):
                self._write_atomic(kf, variable)
        fn = os.path.join(self.path, f"{stem}.{t}")
        if fp.ARMED:
            # ``storage.write`` failpoint: injected I/O error, or a
            # torn write — half the bytes land in the .tmp and the
            # "process" dies before rename (the crash the atomic
            # protocol exists to survive).
            act = fp.fire("storage.write", backend="plain", op="write")
            if act is not None:
                if act.kind == "torn":
                    with open(fn + ".tmp", "wb") as f:
                        f.write(value[: max(1, len(value) // 2)])
                    raise OSError("injected torn write")
                if act.kind == "io_error":
                    raise OSError("injected storage I/O error")
        self._write_atomic(fn, value)
        with self._lock:
            if self._latest is not None and t > self._latest.get(stem, -1):
                self._latest[stem] = t
            if self._versions is not None:
                ts = self._versions.setdefault(stem, [])
                i = bisect.bisect_left(ts, t)
                if i == len(ts) or ts[i] != t:
                    ts.insert(i, t)
            self._cache_put_locked(stem, t, value)

    def versions(self, variable: bytes) -> list[int]:
        """All stored timestamps for ``variable`` (ascending).

        Served from the version index — this used to list the WHOLE
        directory per call, and repair scans (which ask for every
        pending variable's version set) profiled it hot.  The lock
        covers only the index lookup; the one-time rebuild inside
        ``_index_locked`` carries the listing cost exactly once per
        process lifetime."""
        stem = self._prefix(variable)
        with self._lock:
            self._index_locked()
            vs = self._versions.get(stem) if self._versions else None
            return list(vs) if vs else []

    def _inventory(self) -> dict[bytes, list[int]]:
        """variable → timestamps, decoded from the directory listing.
        Lock-free (see :meth:`versions`): touches no shared state."""
        try:
            names = os.listdir(self.path)
        except FileNotFoundError:
            return {}
        stems: dict[str, list[int]] = {}
        for name in names:
            stem, sep, suffix = name.rpartition(".")
            if not sep:
                continue
            try:
                t = int(suffix)
            except ValueError:
                continue  # .tmp / .k sidecars
            stems.setdefault(stem, []).append(t)
        out: dict[bytes, list[int]] = {}
        for stem, ts in stems.items():
            if stem.startswith("h"):
                try:
                    with open(os.path.join(self.path, stem + ".k"), "rb") as f:
                        var = f.read()
                except OSError:
                    continue  # pre-sidecar legacy file: not enumerable
            else:
                try:
                    var = bytes.fromhex(stem)
                except ValueError:
                    continue
            out[var] = sorted(ts)
        return out

    def keys(self) -> list[bytes]:
        """Every stored variable (storage contract — anti-entropy)."""
        return list(self._inventory())

    def scan(self) -> list[tuple[bytes, int]]:
        """Every stored ``(variable, t)`` pair, one directory walk."""
        return [
            (var, t)
            for var, ts in self._inventory().items()
            for t in ts
        ]
