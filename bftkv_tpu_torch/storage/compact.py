"""Residue-preserving compaction for the log engine (DESIGN.md §19.3) (counterpart of ``bftkv_tpu/storage/compact.py``).

An append-only log accumulates dead bytes two ways: the same
``(variable, t)`` rewritten in place (every piggybacked write persists
a pending record that the async back-fill later overwrites with the
certified bytes — §12), and pending residue superseded by a newer
certified version.  Compaction rewrites the sealed segments keeping
only what the protocol can still need:

- the **latest version of every variable** — certified or not:
  uncertified latest residue is exactly what the repair daemon
  certifies-or-demotes (§13), and §10.4's inert stale copies (records
  a routing change stranded here) must stay serveable for migration
  pulls, so compaction is deliberately shard-blind;
- **every certified version** — the read path scans back to them past
  in-progress sign records, and explicit ``read(variable, t)`` serves
  certified history;
- **anything that is not a syncable protocol record** — unparsable
  bytes, TPA-protected (``auth``) records, hidden threshold-CA shares,
  legacy sign-phase shapes without ``ss``: the compactor never guesses
  about bytes it does not understand;
- DROPPED: a **pending** version (partial collective signature)
  strictly below a newer **certified** version of the same variable —
  §12's certified-beats-residue rule says such residue can never be
  upgraded into serving state again (``_stale_version_upgrade``
  declines it), so it is unreachable by every read/repair/sync path.

Crash safety: survivors stream into a ``.tmp``, fsync, then one rename
publishes the compacted segment; the input segments are unlinked only
after.  A crash between rename and unlink leaves both — segment.py's
open-time supersede rule deletes the covered inputs (idempotent).
"""

from __future__ import annotations

import os
import time

from bftkv_tpu_torch import flags
from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch.errors import ERR_NOT_FOUND
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.storage import segment as seg

__all__ = ["compact_store"]


class _RateGovernor:
    """Token-bucket IO governor for the compactor's copy loop.

    ``BFTKV_LOG_COMPACT_MBPS`` caps the sustained copy rate: each
    record written debits its bytes, and whenever the copy runs ahead
    of the configured rate the compactor sleeps off the surplus —
    between record copies, never while holding the store lock, so
    foreground writes and the fsync barrier keep their own pace while
    compaction IO stops competing with them for the disk.  Unset or 0
    = ungoverned (the pre-governor behaviour).  Throttle sleeps are
    observable (``storage.compact.throttle``) so a governed compaction
    that can't keep up with dead-byte accrual shows as compact_io
    saturation in the capacity plane rather than as mystery latency.
    """

    def __init__(self, mbps: float | None):
        self.rate = max(0.0, (mbps or 0.0)) * 1024 * 1024
        self._t0 = time.monotonic()
        self._bytes = 0

    def debit(self, n: int) -> None:
        if self.rate <= 0:
            return
        self._bytes += n
        ahead = self._bytes / self.rate - (time.monotonic() - self._t0)
        if ahead > 0.001:
            metrics.observe("storage.compact.throttle", ahead)
            time.sleep(ahead)


def _max_certified(store, variable: bytes, cache: dict) -> int | None:
    """Newest version of ``variable`` whose stored record carries a
    completed collective signature, or None — the §12 bar a pending
    version must be UNDER for compaction to drop it."""
    if variable in cache:
        return cache[variable]
    best = None
    for t in sorted(store.versions(variable), reverse=True):
        try:
            raw = store.read(variable, t)
        except ERR_NOT_FOUND:
            continue
        try:
            p = pkt.parse(raw)
        except Exception:
            continue  # non-record bytes cannot certify anything
        if p.ss is not None and p.ss.completed:
            best = t
            break
    cache[variable] = best
    return best


def _keep(store, variable: bytes, t: int, value: bytes, cache: dict) -> bool:
    ts = store.versions(variable)
    if ts and t == ts[-1]:
        return True  # latest version always survives (incl. residue)
    try:
        p = pkt.parse(value)
    except Exception:
        return True  # not a protocol record: never the compactor's call
    if p.auth is not None or p.ss is None:
        return True  # TPA-protected / legacy shape: conservative
    if p.ss.completed:
        return True  # certified history stays readable
    mc = _max_certified(store, variable, cache)
    return mc is None or mc < t


def compact_store(store) -> dict:
    """Rewrite the sealed segments of a LogStorage into one compacted
    segment, dropping dead copies and §12-reclaimable pending residue.
    Runs concurrently with writes: a record whose index entry moved
    mid-flight is simply left where the index says it is."""
    with store._lock:
        inputs = sorted(
            (fkey, p)
            for fkey, p in store._paths.items()
            if p != store._active_path
        )
    if not inputs:
        return {"inputs": 0, "kept": 0, "dropped": 0, "reclaimed_bytes": 0}

    first = min(fk[0] for fk, _p in inputs)
    # parse_segment_name gives the true covered range for compacted
    # inputs; plain inputs cover just their own seq.
    last = max(
        seg.parse_segment_name(os.path.basename(p))[1] for _fk, p in inputs
    )
    gen = max(fk[1] for fk, _p in inputs) + 1
    out_path = seg.segment_path(store.path, first, last, gen)
    tmp = out_path + ".tmp"

    cert_cache: dict = {}
    survivors: list[tuple[bytes, int, tuple[int, int], int, int, int]] = []
    dropped: list[tuple[bytes, int, tuple[int, int], int]] = []
    in_bytes = 0
    out_size = 0
    gov = _RateGovernor(flags.get_float("BFTKV_LOG_COMPACT_MBPS"))
    copy_t0 = time.monotonic()
    with open(tmp, "wb") as out:
        for fkey, path in inputs:
            in_bytes += os.path.getsize(path)
            try:
                f = open(path, "rb")
            except OSError:
                continue  # raced another compaction's unlink
            with f:
                for variable, t, value, voff, vlen in seg.iter_records(f):
                    with store._lock:
                        entry = store._data.get(variable)
                        loc = entry[1].get(t) if entry else None
                        live = (
                            loc is not None
                            and loc[0] == fkey
                            and loc[1] == voff
                        )
                    if not live:
                        continue  # superseded copy: dead bytes
                    if not _keep(store, variable, t, value, cert_cache):
                        dropped.append((variable, t, fkey, voff))
                        continue
                    buf = seg.encode_record(variable, t, value)
                    new_voff = (
                        out_size + seg.HEADER.size + len(variable)
                    )
                    out.write(buf)
                    gov.debit(len(buf))
                    survivors.append(
                        (variable, t, fkey, voff, new_voff, len(buf))
                    )
                    out_size += len(buf)
        out.flush()
        os.fsync(out.fileno())
    os.replace(tmp, out_path)
    dfd = os.open(store.path, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)

    new_fkey = (first, gen)
    stale_copy_bytes = 0
    with store._lock:
        store._paths[new_fkey] = out_path
        for variable, t, fkey, voff, new_voff, rec_len in survivors:
            entry = store._data.get(variable)
            loc = entry[1].get(t) if entry else None
            if loc is not None and loc[0] == fkey and loc[1] == voff:
                vlen = loc[2]
                entry[1][t] = (new_fkey, new_voff, vlen)
                store._rec_len[(variable, t)] = rec_len
            else:
                # Overwritten while we copied: the fresh copy in the
                # compacted file is immediately dead.
                stale_copy_bytes += rec_len
        for variable, t, fkey, voff in dropped:
            entry = store._data.get(variable)
            loc = entry[1].get(t) if entry else None
            if loc is not None and loc[0] == fkey and loc[1] == voff:
                entry[1].pop(t)
                entry[0].remove(t)
                store._rec_len.pop((variable, t), None)
        input_paths = [p for _fk, p in inputs]
        for fkey, _p in inputs:
            store._paths.pop(fkey, None)
        store._drop_fds_locked(input_paths)
        store._sealed_bytes = max(
            0, store._sealed_bytes - in_bytes + out_size
        )
        store._dead_bytes = stale_copy_bytes
    for p in input_paths:
        try:
            os.unlink(p)
        except OSError:
            pass  # already gone (open-time supersede recovery raced us)
    # Compaction IO accounting (capacity plane: compact_io resource).
    metrics.incr("storage.compact.read_bytes", in_bytes)
    metrics.incr("storage.compact.written_bytes", out_size)
    dt = max(1e-9, time.monotonic() - copy_t0)
    metrics.gauge(
        "storage.compact.mbps", (in_bytes + out_size) / dt / (1024 * 1024)
    )
    return {
        "inputs": len(inputs),
        "kept": len(survivors),
        "dropped": len(dropped),
        "reclaimed_bytes": max(0, in_bytes - out_size),
    }
