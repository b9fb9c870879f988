"""Segment files for the log-structured store (DESIGN.md §19) (counterpart of ``bftkv_tpu/storage/segment.py``).

One segment is an append-only file of checksummed records::

    crc32(u32) | key_len(u32) | t(u64) | value_len(u32) | key | value

The CRC covers everything after itself (header tail + key + value), so
a torn append — a crash mid-write — is detectable at exactly the first
bad record: replay truncates there and every byte before it is intact.
Compare PlainStorage, where the same crash safety costs a temp file,
two fsyncs and a rename *per record*; here the unit of durability is
the segment tail, and one fsync covers every record appended since the
last (the group-commit amortization, DESIGN.md §19.2).

Naming carries the replay order and the compaction lineage:

- ``seg-<seq>.log`` — a plain segment, covering sequence range
  ``[seq, seq]``, generation 0;
- ``seg-<first>-<last>.c<gen>.log`` — a compacted segment replacing
  every lower-generation segment whose range it covers.

Replay order is ``(first, gen)`` ascending; within a file, byte order.
That equals append order, so same-``(variable, t)`` overwrites resolve
last-writer-wins exactly as they were issued.  A crash between a
compaction's rename and its input unlinks leaves both on disk; open
detects the covered inputs and deletes them (idempotent recovery).
"""

from __future__ import annotations

import os
import re
import struct
import zlib

__all__ = [
    "HEADER",
    "encode_record",
    "iter_records",
    "scan_segment",
    "segment_path",
    "parse_segment_name",
    "list_segments",
]

#: crc32 | key_len | t | value_len
HEADER = struct.Struct(">IIQI")

_NAME = re.compile(
    r"^seg-(\d{12})(?:-(\d{12})\.c(\d+))?\.log$"
)


def encode_record(variable: bytes, t: int, value: bytes) -> bytes:
    """One framed record; the CRC seals header tail + key + value."""
    tail = struct.pack(">IQI", len(variable), t, len(value))
    crc = zlib.crc32(tail)
    crc = zlib.crc32(variable, crc)
    crc = zlib.crc32(value, crc)
    return struct.pack(">I", crc) + tail + variable + value


def iter_records(f, *, base: int = 0):
    """Yield ``(variable, t, value, value_off, value_len)`` from an open
    binary file positioned at ``base``, stopping at EOF **or at the
    first record that fails its checksum** — the torn tail.  The
    generator's ``good_end`` attribute is not expressible; use
    :func:`scan_segment` when the truncation offset matters."""
    for rec in _scan(f, base):
        yield rec[:5]


def _scan(f, base: int):
    f.seek(base)
    off = base
    while True:
        head = f.read(HEADER.size)
        if len(head) < HEADER.size:
            return
        crc, klen, t, vlen = HEADER.unpack(head)
        body = f.read(klen + vlen)
        if len(body) < klen + vlen:
            return  # short body: torn tail
        want = zlib.crc32(head[4:])
        want = zlib.crc32(body, want)
        if want != crc:
            return  # checksum mismatch: torn tail (or bit rot) — stop
        variable = body[:klen]
        value = body[klen:]
        rec_len = HEADER.size + klen + vlen
        yield (variable, t, value, off + HEADER.size + klen, vlen, rec_len)
        off += rec_len


def scan_segment(path: str):
    """Replay one segment: returns ``(entries, good_end)`` where
    ``entries`` is ``[(variable, t, value_off, value_len, rec_len)]``
    (values stay on disk — the rebuild is index-only, spill-safe for
    keyspaces whose values dwarf RAM) and ``good_end`` is the offset
    past the last intact record.  ``good_end < file size`` means a torn
    tail the caller should truncate before appending."""
    entries: list[tuple[bytes, int, int, int, int]] = []
    good_end = 0
    with open(path, "rb") as f:
        for variable, t, _value, voff, vlen, rec_len in _scan(f, 0):
            entries.append((variable, t, voff, vlen, rec_len))
            good_end += rec_len
    return entries, good_end


def segment_path(root: str, first: int, last: int, gen: int) -> str:
    if gen == 0 and first == last:
        return os.path.join(root, f"seg-{first:012d}.log")
    return os.path.join(root, f"seg-{first:012d}-{last:012d}.c{gen}.log")


def parse_segment_name(name: str) -> tuple[int, int, int] | None:
    """``(first, last, gen)`` for a segment file name, else None."""
    m = _NAME.match(name)
    if m is None:
        return None
    first = int(m.group(1))
    if m.group(2) is None:
        return first, first, 0
    return first, int(m.group(2)), int(m.group(3))


def list_segments(root: str) -> list[tuple[int, int, int, str]]:
    """Segments in replay order, after compaction-crash recovery:
    returns ``[(first, last, gen, path)]`` sorted by ``(first, gen)``,
    having deleted any segment fully covered by a higher-generation
    compacted segment (the leftover inputs of a compaction that crashed
    after its rename but before its unlinks) and any stale ``.tmp``."""
    found: list[tuple[int, int, int, str]] = []
    try:
        names = os.listdir(root)
    except FileNotFoundError:
        return []
    for name in names:
        if name.endswith(".tmp"):
            os.unlink(os.path.join(root, name))
            continue
        parsed = parse_segment_name(name)
        if parsed is None:
            continue
        first, last, gen = parsed
        found.append((first, last, gen, os.path.join(root, name)))
    # Supersede: (first,last,gen) is dead if another file covers its
    # whole range at a strictly higher generation.
    live: list[tuple[int, int, int, str]] = []
    for first, last, gen, path in found:
        covered = any(
            f2 <= first and last <= l2 and g2 > gen
            for f2, l2, g2, _p in found
        )
        if covered:
            os.unlink(path)
        else:
            live.append((first, last, gen, path))
    live.sort(key=lambda e: (e[0], e[2]))
    return live
