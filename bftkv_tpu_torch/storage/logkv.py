"""Log-structured storage: group-commit segment log (DESIGN.md §19) (counterpart of ``bftkv_tpu/storage/logkv.py``).

PlainStorage pays four syscalls and two fsyncs *per record* and its
write cost grows with the directory (ROADMAP: "hopeless at millions of
users").  This engine appends every record to one active segment file
and amortizes the fsync: a single durability barrier covers every
record appended since the last one (group commit — the same move "The
Latency Price of Threshold Cryptosystems" makes for signing cost: keep
the expensive step off the per-op critical path).  Write cost is
O(record), independent of keyspace size.

Three cooperating pieces:

- :mod:`bftkv_tpu_torch.storage.segment` — checksummed record framing, torn
  tails detectable at the first bad CRC;
- this module — the engine: sparse in-RAM index (latest-t plus version
  offsets; values stay on disk, so memory is bounded by the version
  *count*, not the data), group-commit fsync, restart rebuild from a
  sequential segment scan, sealed-segment snapshot shipping;
- :mod:`bftkv_tpu_torch.storage.compact` — background compaction preserving
  the §12 commit-pending residue semantics.

Durability policy: **durable by default** — the engine exists to make
fsync cheap, so unlike PlainStorage there is no daemon opt-in split;
pass ``fsync=False`` only where the harness explicitly trades
power-cut durability for speed (in-process chaos clusters, fill
microbenches).  Single writes fsync before returning; concurrent
writers share one barrier (the caller that loses the leader race waits
for the winner's fsync instead of issuing its own); ``write_batch``
appends the whole batch then fsyncs once.

Crash model: a record is either fully replayed or truncated at the
torn tail — the index is rebuilt from the segments on open, so "died
after append, before index update" recovers the append, and "died
mid-append" loses only the unacknowledged record.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from collections import OrderedDict

from bftkv_tpu_torch.errors import ERR_NOT_FOUND
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools import lockwatch
from bftkv_tpu_torch.devtools.lockwatch import named_lock
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.storage import segment as seg

__all__ = ["LogStorage"]

#: Open read-fds kept per store (LRU) — sealed segments are immutable,
#: so a cached descriptor can never serve stale bytes.
_FD_CACHE = 64


class LogStorage:
    def __init__(
        self,
        path: str,
        *,
        fsync: bool | None = None,
        segment_bytes: int | None = None,
        group_commit_s: float | None = None,
        compact_trigger: float | None = None,
    ):
        self.path = path
        self.fsync = True if fsync is None else fsync
        if segment_bytes is None:
            segment_bytes = (
                flags.get_int("BFTKV_LOG_SEGMENT_MB") * 1024 * 1024
            )
        self.segment_bytes = max(1, segment_bytes)
        if group_commit_s is None:
            group_commit_s = (
                flags.get_float("BFTKV_LOG_GROUP_COMMIT_MS") / 1000.0
            )
        self.group_commit_s = max(0.0, group_commit_s)
        # Published once: the capacity plane reads the linger window as
        # the commit-wait saturation denominator (DESIGN.md §20).
        metrics.gauge("storage.log.linger_ms", self.group_commit_s * 1000.0)
        if compact_trigger is None:
            compact_trigger = flags.get_float("BFTKV_LOG_COMPACT_TRIGGER")
        self.compact_trigger = compact_trigger
        # Index + active-segment state.  Appends MUST serialize (one
        # tail), so unlike PlainStorage the data write happens under
        # the store lock — but it is a buffered-to-OS file write, not
        # a patched blocking call; the fsync barrier runs outside.
        self._lock = named_lock("storage.log")
        # variable -> (sorted ts, {t: ((first, gen), value_off, value_len)})
        self._data: dict[
            bytes, tuple[list[int], dict[int, tuple[tuple[int, int], int, int]]]
        ] = {}
        self._rec_len: dict[tuple[bytes, int], int] = {}
        self._paths: dict[tuple[int, int], str] = {}
        self._fds: "OrderedDict[str, int]" = OrderedDict()
        self._sorted: list[bytes] | None = None
        self._sealed_bytes = 0
        self._dead_bytes = 0
        # Group-commit state: (seq, offset) durable high-water mark.
        self._cv = threading.Condition()
        self._flushed: tuple[int, int] = (0, 0)
        self._flushing = False
        self._pending_truncate = False
        self._compact_thread: threading.Thread | None = None
        self.compactions = 0
        os.makedirs(path, exist_ok=True)
        self._open_state()

    # -- open / rebuild ----------------------------------------------------

    def _open_state(self) -> None:
        """Rebuild the index from one sequential scan of the segments
        (spill-safe: offsets only, values stay on disk), truncate the
        torn tail of the last segment, and pick/create the active
        segment.  Runs in ``__init__``/``reopen`` only — no store lock
        exists to hold yet."""
        segments = seg.list_segments(self.path)
        last_i = len(segments) - 1
        for i, (first, last, gen, p) in enumerate(segments):
            fkey = (first, gen)
            self._paths[fkey] = p
            entries, good_end = seg.scan_segment(p)
            size = os.path.getsize(p)
            if good_end < size:
                if i == last_i:
                    # Torn tail: the crash the checksum exists to
                    # catch.  Truncate so future appends replay.
                    os.truncate(p, good_end)
                    metrics.incr("storage.log.torn_truncated")
                else:
                    # A sealed segment should never tear (fsynced at
                    # seal); bit rot loses its tail records only.
                    metrics.incr("storage.log.sealed_tear")
            for variable, t, voff, vlen, rec_len in entries:
                self._index_put(variable, t, fkey, voff, vlen, rec_len)
        # Active segment: the last plain (gen 0) segment, if it is
        # last in replay order and still has room; else a fresh one.
        active = None
        if segments:
            first, last, gen, p = segments[-1]
            if gen == 0 and os.path.getsize(p) < self.segment_bytes:
                active = (first, p)
        if active is None:
            nxt = (segments[-1][1] + 1) if segments else 0
            p = seg.segment_path(self.path, nxt, nxt, 0)
            active = (nxt, p)
            self._paths[(nxt, 0)] = p
        self._seq, self._active_path = active
        # buffering=0: every append is pushed to the OS immediately,
        # so read fds and the fsync barrier see it without a flush.
        self._f = open(self._active_path, "ab", buffering=0)
        self._size = os.path.getsize(self._active_path)
        self._sealed_bytes = sum(
            os.path.getsize(p)
            for k, p in self._paths.items()
            if p != self._active_path
        )
        self._flushed = (self._seq, 0)

    def _index_put(
        self,
        variable: bytes,
        t: int,
        fkey: tuple[int, int],
        voff: int,
        vlen: int,
        rec_len: int,
    ) -> None:
        entry = self._data.get(variable)
        if entry is None:
            entry = ([], {})
            self._data[variable] = entry
            self._sorted = None  # new key: sorted-keys cache is stale
        ts, locs = entry
        if t not in locs:
            bisect.insort(ts, t)
        else:
            # Same (variable, t) rewritten (pending -> certified
            # back-fill): the superseded bytes are dead for compaction.
            self._dead_bytes += self._rec_len.get((variable, t), 0)
        locs[t] = (fkey, voff, vlen)
        self._rec_len[(variable, t)] = rec_len

    # -- append / group commit ---------------------------------------------

    def _append_locked(self, variable: bytes, t: int, value: bytes) -> None:
        """Append one record and index it; caller holds the lock and
        owns the commit barrier.  Rotation (seal + new segment) happens
        here when the active segment fills."""
        if self._pending_truncate:
            # A prior injected torn append left garbage past _size in
            # a process that kept running; roll the tail back first.
            os.ftruncate(self._f.fileno(), self._size)
            self._pending_truncate = False
        buf = seg.encode_record(variable, t, value)
        if fp.ARMED:
            # ``storage.write`` failpoint: torn = half the record
            # lands and the "process" dies before the index update —
            # exactly the crash the CRC framing recovers from.
            act = fp.fire("storage.write", backend="log", op="write")
            if act is not None:
                if act.kind == "torn":
                    self._f.write(buf[: max(1, len(buf) // 2)])
                    self._pending_truncate = True
                    raise OSError("injected torn write")
                if act.kind == "io_error":
                    raise OSError("injected storage I/O error")
        voff = self._size + seg.HEADER.size + len(variable)
        self._f.write(buf)
        self._index_put(
            variable, t, (self._seq, 0), voff, len(value), len(buf)
        )
        self._size += len(buf)
        if self._size >= self.segment_bytes:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Seal the active segment and start the next one.  Rare (once
        per BFTKV_LOG_SEGMENT_MB of appends), so the seal fsync runs
        under the store lock — appends must not interleave with the
        writer swap."""
        with lockwatch.waiver(
            "log: segment seal fsyncs + opens under the store lock; "
            "rare (once per segment) and appends must not interleave "
            "with the writer swap"
        ):
            if self.fsync:
                os.fsync(self._f.fileno())
            self._f.close()
            nxt = self._seq + 1
            p = seg.segment_path(self.path, nxt, nxt, 0)
            self._f = open(p, "ab", buffering=0)
        self._sealed_bytes += self._size
        self._paths[(nxt, 0)] = p
        self._seq, self._active_path, self._size = nxt, p, 0
        with self._cv:
            # Everything in older segments is durable once sealed.
            if self.fsync and self._flushed < (nxt, 0):
                self._flushed = (nxt, 0)
        metrics.incr("storage.log.seals")
        self._maybe_compact_locked()

    def _commit(self, pos: tuple[int, int]) -> None:
        """Group-commit barrier: return once every byte up to ``pos``
        is fsynced.  One caller at a time leads the fsync; everyone who
        lost the race piggybacks on the leader's barrier instead of
        issuing their own — N concurrent writers, one fsync."""
        t0 = time.monotonic()
        try:
            self._commit_inner(pos)
        finally:
            # Commit-wait = linger + fsync + barrier queueing; its p99
            # against the configured linger is the log_commit
            # saturation signal (capacity plane, DESIGN.md §20).
            metrics.observe(
                "storage.log.commit_wait", time.monotonic() - t0
            )

    def _commit_inner(self, pos: tuple[int, int]) -> None:
        while True:
            with self._cv:
                if self._flushed >= pos:
                    return
                if self._flushing:
                    self._cv.wait(timeout=5.0)
                    continue
                self._flushing = True
            target = None
            try:
                if self.group_commit_s:
                    # The linger window: let concurrent writers join
                    # this barrier (outside every lock).
                    time.sleep(self.group_commit_s)
                with self._lock:
                    snap = (self._seq, self._size)
                    f = self._f
                if fp.ARMED:
                    # ``storage.fsync`` failpoint: a stalled durability
                    # barrier — every writer joined on this group
                    # commit waits it out (slow-disk model; the
                    # capacity plane must name log_commit for it).
                    act = fp.fire("storage.fsync", backend="log")
                    if act is not None and act.kind == "stall":
                        time.sleep(fp.delay_seconds(act))
                try:
                    os.fsync(f.fileno())
                except ValueError:
                    # Rotation closed this writer after the snapshot;
                    # the seal path fsynced it — the barrier holds.
                    pass
                target = snap
                metrics.incr("storage.log.fsync")
            finally:
                with self._cv:
                    self._flushing = False
                    if target is not None and self._flushed < target:
                        self._flushed = target
                    self._cv.notify_all()

    # -- storage contract ---------------------------------------------------

    def write(self, variable: bytes, t: int, value: bytes) -> None:
        with self._lock:
            self._append_locked(variable, t, value)
            pos = (self._seq, self._size)
        if self.fsync:
            self._commit(pos)

    def write_batch(self, items) -> None:
        """The group-commit seam: append every ``(variable, t, value)``
        then fsync ONCE — the whole coalesced batch (gateway write
        coalescer, sync back-fill, ``admit_records``) shares a single
        durability barrier."""
        items = list(items)
        if not items:
            return
        if fp.ARMED:
            # Batch-level failpoint eval: one fate for the whole batch
            # (a real torn batch tears at one record; the per-record
            # path in _append_locked models that — here the injected
            # error fails the batch before any index update).
            act = fp.fire("storage.write", backend="log", op="write_batch")
            if act is not None and act.kind in ("io_error", "torn"):
                raise OSError("injected storage I/O error")
        with self._lock:
            for variable, t, value in items:
                self._append_locked(variable, t, value)
            pos = (self._seq, self._size)
        metrics.observe("storage.log.batch", len(items))
        if self.fsync:
            self._commit(pos)

    def read(self, variable: bytes, t: int = 0) -> bytes:
        with self._lock:
            entry = self._data.get(variable)
            if entry is None:
                raise ERR_NOT_FOUND
            ts, locs = entry
            if t == 0:
                t = ts[-1]
            loc = locs.get(t)
            if loc is None:
                raise ERR_NOT_FOUND
            fkey, voff, vlen = loc
            path = self._paths[fkey]
        data = os.pread(self._fd(path), vlen, voff)
        if len(data) < vlen:
            # Compaction swapped the file under a stale fd (unlinked
            # files keep serving, but a re-resolve is the safe path).
            with self._lock:
                entry = self._data.get(variable)
                loc = entry[1].get(t) if entry else None
                if loc is None:
                    raise ERR_NOT_FOUND
                fkey, voff, vlen = loc
                path = self._paths[fkey]
            data = os.pread(self._fd(path), vlen, voff)
        return data

    def versions(self, variable: bytes) -> list[int]:
        """All stored timestamps (ascending) — one index lookup; no
        directory listing, no file I/O."""
        with self._lock:
            entry = self._data.get(variable)
            return list(entry[0]) if entry else []

    def keys(self) -> list[bytes]:
        with self._lock:
            return list(self._data)

    def scan(self) -> list[tuple[bytes, int]]:
        with self._lock:
            return [
                (var, t)
                for var, (ts, _locs) in self._data.items()
                for t in ts
            ]

    def sorted_keys(
        self, after: bytes | None = None, limit: int | None = None
    ) -> list[bytes]:
        """Sorted keyspace slice — the cheap ``pending_variables``
        cursor seam: the sort is cached and only invalidated when a NEW
        variable appears, so a steady-state repair round costs one
        bisect + slice instead of re-sorting the whole keyspace."""
        with self._lock:
            if self._sorted is None:
                self._sorted = sorted(self._data)
            keys = self._sorted
            lo = 0
            if after is not None:
                lo = bisect.bisect_right(keys, after)
            hi = len(keys) if limit is None else min(len(keys), lo + limit)
            return keys[lo:hi]

    # -- snapshot shipping (DESIGN.md §19.4) --------------------------------

    def seal_active(self) -> None:
        """Force-seal the active segment (if non-empty) so its records
        become part of the sealed snapshot set."""
        with self._lock:
            if self._size:
                self._rotate_locked()

    def sealed_segment_paths(self) -> list[str]:
        with self._lock:
            return [
                p for p in self._paths.values() if p != self._active_path
            ]

    def snapshot_records(self, pred=None):
        """Stream ``(variable, t, value)`` for every LIVE record whose
        variable passes ``pred`` — the §15 pre-copy bulk transfer unit.
        Seals the active segment first, then reads the sealed segments
        *sequentially* (bulk I/O, no per-key seeks); a record yields
        only if the index still points at it, so superseded duplicates
        and compacted-away residue never ship."""
        self.seal_active()
        with self._lock:
            files = [
                (fkey, p)
                for fkey, p in sorted(self._paths.items())
                if p != self._active_path
            ]
        for fkey, path in files:
            try:
                f = open(path, "rb")
            except OSError:
                continue  # compacted away mid-stream: its records moved
            with f:
                for variable, t, value, voff, _vlen in seg.iter_records(f):
                    if pred is not None and not pred(variable):
                        continue
                    with self._lock:
                        entry = self._data.get(variable)
                        loc = entry[1].get(t) if entry else None
                        live = loc is not None and loc[0] == fkey and (
                            loc[1] == voff
                        )
                    if live:
                        yield variable, t, value

    # -- compaction hooks ---------------------------------------------------

    def dead_ratio(self) -> float:
        with self._lock:
            if not self._sealed_bytes:
                return 0.0
            return self._dead_bytes / self._sealed_bytes

    def _maybe_compact_locked(self) -> None:
        """Arm background compaction when the sealed dead-byte ratio
        crosses the trigger (0 disables).  One flight at a time; the
        caller holds the store lock (the trigger check is field reads,
        the work runs on the spawned thread)."""
        if self.compact_trigger <= 0 or not self._sealed_bytes:
            return
        if self._dead_bytes / self._sealed_bytes < self.compact_trigger:
            return
        t = self._compact_thread
        if t is not None and t.is_alive():
            return
        t = threading.Thread(
            target=self._compact_quiet, name="logkv-compact", daemon=True
        )
        self._compact_thread = t
        t.start()

    def _compact_quiet(self) -> None:
        try:
            self.compact()
        except Exception:
            # Background compaction must never take the store down —
            # the log stays append-correct without it; the failure is
            # counted and the next trigger retries.
            metrics.incr("storage.log.compact_failed")

    def compact(self) -> dict:
        """Synchronous compaction (tests call this directly; the
        trigger path runs it on a background thread)."""
        from bftkv_tpu_torch.storage.compact import compact_store

        stats = compact_store(self)
        self.compactions += 1
        metrics.incr("storage.log.compactions")
        return stats

    # -- lifecycle ----------------------------------------------------------

    def _fd(self, path: str) -> int:
        with self._lock:
            fd = self._fds.get(path)
            if fd is not None:
                self._fds.move_to_end(path)
                return fd
        fd = os.open(path, os.O_RDONLY)
        with self._lock:
            have = self._fds.get(path)
            if have is not None:
                os.close(fd)
                return have
            self._fds[path] = fd
            while len(self._fds) > _FD_CACHE:
                _p, old = self._fds.popitem(last=False)
                os.close(old)
            return fd

    def _drop_fds_locked(self, paths) -> None:
        for p in paths:
            fd = self._fds.pop(p, None)
            if fd is not None:
                os.close(fd)

    def close(self) -> None:
        """Clean shutdown: one final barrier, then drop descriptors.
        The on-disk log IS the store — reopen rebuilds the index."""
        t = self._compact_thread
        if t is not None and t.is_alive():
            t.join(timeout=10.0)
        with self._lock:
            if self.fsync:
                with lockwatch.waiver(
                    "log: close-time fsync under the store lock — "
                    "shutdown path, no concurrent appends to stall"
                ):
                    try:
                        os.fsync(self._f.fileno())
                    except (OSError, ValueError):
                        pass  # already closed/rotated: nothing to sync
            self._f.close()
            self._drop_fds_locked(list(self._fds))

    def reopen(self) -> None:
        """Crash-restart onto the same log directory: drop every
        descriptor and the whole in-RAM index, then rebuild from the
        segment scan (truncating any torn tail) — what a restarted
        daemon does on its data dir, exercisable in-process."""
        self.close()
        with self._lock:
            with lockwatch.waiver(
                "log: crash-restart rebuild scans the segment files "
                "under the store lock — no reader may observe a "
                "half-built index"
            ):
                self._data.clear()
                self._rec_len.clear()
                self._paths.clear()
                self._sorted = None
                self._dead_bytes = 0
                self._pending_truncate = False
                self._open_state()
