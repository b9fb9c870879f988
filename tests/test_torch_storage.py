"""The port's storage engines (``bftkv_tpu_torch/storage/``) against the
reference's.

The first two parts rewrite the reference's cases (``tests/test_storage.py``
and ``tests/test_logkv.py``) against the port; the last part carries stores
across the packages: a ``LogStorage`` directory (compacted, and with a torn
tail), a ``PlainStorage`` directory and a ``NativeStorage`` file written by
one package open in the other and read back every version, both ways, and
the same writes give the same bytes on disk.  Exact everywhere.
"""

import os
import threading
import time

import pytest

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch.errors import ERR_NOT_FOUND
from bftkv_tpu_torch.storage.logkv import LogStorage
from bftkv_tpu_torch.storage.memkv import MemStorage
from bftkv_tpu_torch.storage.native import NativeStorage
from bftkv_tpu_torch.storage.plain import PlainStorage


# == the four engines (test_storage.py) ==


@pytest.fixture(params=["mem", "plain", "native", "log"])
def store(request, tmp_path):
    if request.param == "mem":
        yield MemStorage()
    elif request.param == "plain":
        yield PlainStorage(str(tmp_path / "db"))
    elif request.param == "log":
        s = LogStorage(str(tmp_path / "db-log"), fsync=False)
        yield s
        s.close()
    else:
        s = NativeStorage(str(tmp_path / "db.log"))
        yield s
        s.close()


def test_not_found(store):
    with pytest.raises(ERR_NOT_FOUND):
        store.read(b"missing")
    with pytest.raises(ERR_NOT_FOUND):
        store.read(b"missing", 3)


def test_versions_and_latest(store):
    store.write(b"x", 1, b"v1")
    store.write(b"x", 3, b"v3")
    store.write(b"x", 2, b"v2")
    assert store.read(b"x", 1) == b"v1"
    assert store.read(b"x", 2) == b"v2"
    assert store.read(b"x") == b"v3"  # t=0 -> latest
    with pytest.raises(ERR_NOT_FOUND):
        store.read(b"x", 4)


def test_versions_listing(store):
    # versions() is part of the storage contract (the server read path's
    # scan past in-progress sign records; reference: leveldb.go:30-46).
    assert store.versions(b"x") == []
    store.write(b"x", 1, b"v1")
    store.write(b"x", 3, b"v3")
    store.write(b"x", 2**64 - 1, b"once")
    assert sorted(store.versions(b"x")) == [1, 3, 2**64 - 1]
    assert store.versions(b"other") == []


def test_native_versions_survive_reopen(tmp_path):
    path = str(tmp_path / "db.log")
    s = NativeStorage(path)
    for t in range(1, 100):
        s.write(b"x", t, b"v%d" % t)
    s.close()
    s = NativeStorage(path)
    assert sorted(s.versions(b"x")) == list(range(1, 100))
    s.close()


def test_overwrite_same_t(store):
    store.write(b"x", 5, b"a")
    store.write(b"x", 5, b"b")
    assert store.read(b"x", 5) == b"b"
    assert store.read(b"x") == b"b"


def test_empty_value_and_binary_keys(store):
    var = bytes(range(256))
    store.write(var, 1, b"")
    assert store.read(var) == b""


def test_writeonce_timestamp(store):
    t = 2**64 - 1
    store.write(b"once", t, b"final")
    assert store.read(b"once") == b"final"
    assert store.read(b"once", t) == b"final"


@pytest.mark.parametrize("cls", ["plain", "native", "log"])
def test_persistence_across_reopen(cls, tmp_path):
    if cls == "plain":
        path = str(tmp_path / "db")
        s = PlainStorage(path)
    elif cls == "log":
        path = str(tmp_path / "db-log")
        s = LogStorage(path, fsync=False)
    else:
        path = str(tmp_path / "db.log")
        s = NativeStorage(path)
    s.write(b"x", 1, b"v1")
    s.write(b"x", 2, b"v2")
    s.write(b"y", 7, b"w")
    if cls == "native":
        s.close()
        s = NativeStorage(path)
    elif cls == "log":
        s.close()
        s = LogStorage(path, fsync=False)
    else:
        s = PlainStorage(path)
    assert s.read(b"x") == b"v2"
    assert s.read(b"x", 1) == b"v1"
    assert s.read(b"y") == b"w"
    if cls in ("native", "log"):
        s.close()


def test_keys_and_scan(store):
    # keys()/scan() are part of the storage contract (the anti-entropy
    # digest tree enumerates the keyspace with them; bftkv_tpu/sync).
    assert store.keys() == []
    assert store.scan() == []
    long_var = b"\xff" * 200  # hash-stemmed in the plain backend
    store.write(b"x", 1, b"a")
    store.write(b"x", 3, b"c")
    store.write(b"y", 2, b"b")
    store.write(long_var, 7, b"z")
    assert sorted(store.keys()) == sorted([b"x", b"y", long_var])
    assert sorted(store.scan()) == sorted(
        [(b"x", 1), (b"x", 3), (b"y", 2), (long_var, 7)]
    )
    # Overwriting an existing version must not duplicate inventory rows.
    store.write(b"x", 3, b"c2")
    assert sorted(store.keys()) == sorted([b"x", b"y", long_var])
    assert len(store.scan()) == 4


def test_backend_differential_parity(tmp_path):
    """Drive the identical write/read/versions/keys/scan sequence
    through all four backends and assert identical observable results
    — the contract is one, the engines are four.  The log engine
    additionally crash-restarts mid-trace (index dropped, rebuilt from
    the segment scan) and again before observation: replay must land
    on the exact same view the backends that never died present."""
    import random

    backends = {
        "mem": MemStorage(),
        "plain": PlainStorage(str(tmp_path / "p")),
        "native": NativeStorage(str(tmp_path / "n.log")),
        # Tiny segments so the trace spans several sealed files — the
        # replay exercises multi-segment rebuild, not just one tail.
        "log": LogStorage(
            str(tmp_path / "l"), fsync=False, segment_bytes=512
        ),
    }
    rng = random.Random(42)
    variables = [b"a", b"b" * 40, b"\x00\x01", b"h" * 120, b""]
    ops = []
    for _ in range(120):
        var = rng.choice(variables)
        t = rng.randint(1, 12)
        ops.append((var, t, b"v%d-%d" % (t, rng.randint(0, 3))))

    for i, (var, t, val) in enumerate(ops):
        for s in backends.values():
            s.write(var, t, val)
        if i == 60:
            backends["log"].reopen()  # crash-restart mid-trace

    backends["log"].reopen()  # and once more before observing

    def observe(s):
        out = {
            "keys": sorted(s.keys()),
            "scan": sorted(s.scan()),
        }
        for var in variables:
            out[("versions", var)] = sorted(s.versions(var))
            for t in [0] + sorted({t for v, t, _ in ops if v == var}):
                try:
                    out[("read", var, t)] = s.read(var, t)
                except ERR_NOT_FOUND:
                    out[("read", var, t)] = None
        return out

    views = {name: observe(s) for name, s in backends.items()}
    assert views["mem"] == views["plain"]
    assert views["mem"] == views["native"]
    assert views["mem"] == views["log"]
    backends["native"].close()
    backends["log"].close()


def test_native_large_values(tmp_path):
    s = NativeStorage(str(tmp_path / "db.log"))
    big = bytes(1024 * 1024)
    s.write(b"big", 1, big)
    s.write(b"big", 2, b"tiny")
    assert s.read(b"big", 1) == big
    assert s.read(b"big") == b"tiny"
    s.close()


def test_plain_torn_write_recovery(tmp_path):
    """A write torn mid-flight (storage failpoint: partial bytes land in
    the .tmp, the process dies before rename) must leave the store
    readable at the previous version after "restart", keep the torn
    remnant out of versions()/keys()/scan(), and let a subsequent write
    of the same version succeed."""
    from bftkv_tpu_torch.faults import failpoint as fp

    path = str(tmp_path / "db")
    s = PlainStorage(path)
    s.write(b"x", 1, b"v1")

    fp.arm(3)
    try:
        fp.registry.add(
            "storage.write", "torn", match={"backend": "plain"}, times=1
        )
        with pytest.raises(OSError):
            s.write(b"x", 2, b"v2-that-tears")
    finally:
        fp.disarm()

    # The torn remnant is on disk but invisible to every read surface.
    import os

    assert any(n.endswith(".tmp") for n in os.listdir(path))
    s2 = PlainStorage(path)  # crash-restart onto the same dir
    assert s2.read(b"x") == b"v1"
    assert s2.versions(b"x") == [1]
    assert s2.keys() == [b"x"]
    assert s2.scan() == [(b"x", 1)]

    # Recovery: the same version writes cleanly over the stale .tmp.
    s2.write(b"x", 2, b"v2")
    assert s2.read(b"x") == b"v2"
    assert s2.versions(b"x") == [1, 2]


def test_log_crash_replay_torn_tail(tmp_path):
    """Crash-point replay, case 1: the process dies MID-append — half a
    record lands on disk.  Reopen truncates the tail at the first bad
    checksum and recovers the exact pre-crash ``scan()``; the same
    version then writes cleanly over the reclaimed space."""
    from bftkv_tpu_torch.faults import failpoint as fp

    s = LogStorage(str(tmp_path / "db"), fsync=False)
    s.write(b"x", 1, b"v1")
    s.write(b"y", 2, b"v2")
    before = sorted(s.scan())

    fp.arm(3)
    try:
        fp.registry.add(
            "storage.write", "torn", match={"backend": "log"}, times=1
        )
        with pytest.raises(OSError):
            s.write(b"x", 3, b"v3-that-tears")
    finally:
        fp.disarm()

    s.reopen()  # crash-restart onto the same segment directory
    assert sorted(s.scan()) == before
    assert s.read(b"x") == b"v1"
    assert s.versions(b"x") == [1]

    s.write(b"x", 3, b"v3")
    assert s.read(b"x") == b"v3"
    s.close()


def test_log_crash_replay_append_before_index(tmp_path):
    """Crash-point replay, case 2: the record hit the log in full but
    the process died BEFORE any index update.  Replay recovers it — the
    log is the truth, the in-RAM index is a cache."""
    from bftkv_tpu_torch.storage import segment as seg

    s = LogStorage(str(tmp_path / "db"), fsync=False)
    s.write(b"x", 1, b"v1")
    # The crash point: a complete, checksummed record the dying process
    # never indexed (appended behind the store's back).
    with open(s._active_path, "ab") as f:
        f.write(seg.encode_record(b"y", 7, b"w"))
    s.reopen()
    assert sorted(s.scan()) == [(b"x", 1), (b"y", 7)]
    assert s.read(b"y") == b"w"
    assert s.versions(b"y") == [7]
    s.close()


def test_plain_fsync_policy(tmp_path, monkeypatch):
    """Durability policy: the library default is no per-write fsync
    (the reference's leveldb stance); the daemon opts in explicitly,
    and BFTKV_PLAIN_FSYNC overrides either way.  The crash-safe write
    ORDERING (temp + rename) is unconditional."""
    monkeypatch.delenv("BFTKV_PLAIN_FSYNC", raising=False)
    assert PlainStorage(str(tmp_path / "a")).fsync is False
    monkeypatch.setenv("BFTKV_PLAIN_FSYNC", "1")
    assert PlainStorage(str(tmp_path / "b")).fsync is True
    s = PlainStorage(str(tmp_path / "c"), fsync=True)
    assert s.fsync is True
    s.write(b"x", 1, b"v1")  # exercises the fsync(file)+fsync(dir) path
    assert s.read(b"x") == b"v1"
    assert s.versions(b"x") == [1]


# == the log engine (test_logkv.py) ==


def _record(variable: bytes, t: int, *, completed: bool, value: bytes = b"v"):
    """A minimal protocol record: parsable, carries a collective
    signature whose ``completed`` bit drives the §12/§19.3 keep rules."""
    sig = pkt.SignaturePacket(
        type=1, version=0, completed=True, data=b"s", cert=b"c"
    )
    ss = pkt.SignaturePacket(
        type=1, version=0, completed=completed, data=b"ss", cert=None
    )
    return pkt.serialize(variable, value, t, sig, ss)


# -- group commit ------------------------------------------------------------


def test_write_batch_one_fsync(tmp_path, monkeypatch):
    """The group-commit contract: a coalesced batch shares ONE
    durability barrier, however many records it carries."""
    import os as os_mod

    calls = []
    real = os_mod.fsync
    monkeypatch.setattr(
        os_mod, "fsync", lambda fd: (calls.append(fd), real(fd))[1]
    )
    s = LogStorage(str(tmp_path / "db"), fsync=True, group_commit_s=0)
    calls.clear()
    s.write_batch([(b"k%03d" % i, 1, b"v%d" % i) for i in range(50)])
    assert len(calls) == 1
    for i in range(50):
        assert s.read(b"k%03d" % i) == b"v%d" % i
    s.close()


def test_single_writes_durable_and_concurrent(tmp_path, monkeypatch):
    """Single writes stay durable-by-default (fsync unless opted out),
    and concurrent writers never fsync MORE than once per write —
    losers of the leader race piggyback on the leader's barrier."""
    import os as os_mod

    count = [0]
    real = os_mod.fsync

    def counting(fd):
        count[0] += 1
        return real(fd)

    monkeypatch.setattr(os_mod, "fsync", counting)
    s = LogStorage(str(tmp_path / "db"), group_commit_s=0)
    assert s.fsync is True  # durable by default, unlike PlainStorage
    count[0] = 0
    errs = []

    def worker(w):
        try:
            for i in range(10):
                s.write(b"w%d-%d" % (w, i), 1, b"x")
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert 1 <= count[0] <= 40
    for w in range(4):
        for i in range(10):
            assert s.read(b"w%d-%d" % (w, i)) == b"x"
    s.close()


# -- compaction --------------------------------------------------------------


def test_compaction_residue_semantics(tmp_path):
    """§19.3 keep rules on real records: a pending version below a
    newer certified one compacts away; certified history, uncertified
    LATEST residue, and unparsable bytes all survive — before and
    after a crash-restart replay of the compacted segment."""
    s = LogStorage(str(tmp_path / "db"), fsync=False, compact_trigger=0)
    # a: pending@1 (reclaimable), certified@2, pending@3 (latest residue)
    s.write(b"a", 1, _record(b"a", 1, completed=False, value=b"a1"))
    s.write(b"a", 2, _record(b"a", 2, completed=True, value=b"a2"))
    s.write(b"a", 3, _record(b"a", 3, completed=False, value=b"a3"))
    # b: certified history — every version stays readable
    s.write(b"b", 1, _record(b"b", 1, completed=True, value=b"b1"))
    s.write(b"b", 2, _record(b"b", 2, completed=True, value=b"b2"))
    # c: unparsable bytes below a certified latest — never dropped
    s.write(b"c", 1, b"\x00not-a-record")
    s.write(b"c", 2, _record(b"c", 2, completed=True, value=b"c2"))

    s.seal_active()
    stats = s.compact()
    assert stats["dropped"] == 1  # exactly a@1
    assert stats["kept"] == 6

    def check(store):
        assert store.versions(b"a") == [2, 3]
        assert pkt.parse(store.read(b"a", 2)).value == b"a2"
        assert pkt.parse(store.read(b"a", 3)).value == b"a3"
        assert store.versions(b"b") == [1, 2]
        assert store.versions(b"c") == [1, 2]
        assert store.read(b"c", 1) == b"\x00not-a-record"

    check(s)
    s.reopen()  # replay the compacted segment from disk
    check(s)
    s.close()


def test_compaction_trigger_reclaims_dead_bytes(tmp_path):
    """Overwriting the same (variable, t) accumulates dead bytes in
    sealed segments; the background trigger compacts them away and the
    store keeps serving the live copies."""
    s = LogStorage(
        str(tmp_path / "db"),
        fsync=False,
        segment_bytes=2048,
        compact_trigger=0.3,
    )
    payload = bytes(128)
    for round_ in range(6):
        for i in range(20):
            s.write(b"k%02d" % i, 1, payload + b"%d" % round_)
    deadline = time.time() + 5.0
    while time.time() < deadline:
        if s.compactions and s.dead_ratio() < 0.3:
            break
        time.sleep(0.02)
    assert s.compactions >= 1
    for i in range(20):
        assert s.read(b"k%02d" % i) == payload + b"5"
    s.close()


# -- O(changed) digests ------------------------------------------------------


class _CountingStorage:
    """Storage proxy counting read()/versions() calls — the probe the
    O(changed) assertions use."""

    def __init__(self, inner):
        self.inner = inner
        self.reads = 0
        self.version_calls = 0

    def read(self, variable, t=0):
        self.reads += 1
        return self.inner.read(variable, t)

    def versions(self, variable):
        self.version_calls += 1
        return self.inner.versions(variable)

    def __getattr__(self, name):
        return getattr(self.inner, name)


def test_digest_tree_reads_o_changed(tmp_path):
    """After the initial build, a digest round re-reads ONLY dirty
    variables: 100 changed records out of 3000 cost ~100 reads, not a
    keyspace sweep."""
    # The reference's digest tree (the port's sync/ is a later slice),
    # over the port's store.
    from bftkv_tpu.sync.digest import DigestTree

    s = LogStorage(str(tmp_path / "db"), fsync=False)
    n = 3000
    for i in range(n):
        var = b"key-%05d" % i
        s.write(var, 1, _record(var, 1, completed=True))
    probe = _CountingStorage(s)
    tree = DigestTree(probe)
    tree.buckets()  # full build: O(keyspace), once
    base = tree.root()

    probe.reads = 0
    probe.version_calls = 0
    changed = [b"key-%05d" % i for i in range(0, 1000, 10)]  # 100 vars
    for var in changed:
        s.write(var, 2, _record(var, 2, completed=True))
        tree.mark(var)
    tree.buckets()
    assert tree.root() != base
    # Bounded by the CHANGED set (small constant per variable), far
    # under the 3000-key keyspace.
    assert probe.reads <= 4 * len(changed)
    assert probe.version_calls <= 4 * len(changed)

    probe.reads = 0
    probe.version_calls = 0
    tree.buckets()  # nothing dirty: free
    assert probe.reads == 0 and probe.version_calls == 0
    s.close()


# -- repair-scan cursor ------------------------------------------------------


def test_pending_variables_storage_served_cursor(tmp_path):
    """``pending_variables`` on a §19 store pages through the keyspace
    via the storage-served sorted_keys cursor: each window reads only
    window-many records, finds exactly the pending residue, and the
    cursor walk terminates."""
    # The reference's server method (the port's protocol/ is a later
    # slice), over the port's store.
    from bftkv_tpu.protocol.server import Server

    s = LogStorage(str(tmp_path / "db"), fsync=False)
    pending_vars = set()
    for i in range(40):
        var = b"key-%03d" % i
        completed = i % 8 != 0
        if not completed:
            pending_vars.add(var)
        s.write(var, 1, _record(var, 1, completed=completed))

    class _Stub:
        storage = s

    stub = _Stub()
    probe = _CountingStorage(s)
    stub.storage = probe

    found = set()
    cursor = None
    rounds = 0
    while True:
        probe.reads = 0
        got, cursor = Server.pending_variables(
            stub, after=cursor, scan_window=7
        )
        rounds += 1
        assert probe.reads <= 7  # the window bounds the record reads
        found.update(v for v, _t, _raw, _p in got)
        if cursor is None:
            break
        assert rounds <= 40
    assert found == pending_vars
    assert rounds == 6  # ceil(40 / 7) windows, not a full-store parse
    s.close()


def test_sorted_keys_window(tmp_path):
    s = LogStorage(str(tmp_path / "db"), fsync=False)
    import random

    keys = [b"k%03d" % i for i in range(50)]
    for k in random.Random(7).sample(keys, len(keys)):
        s.write(k, 1, b"v")
    assert s.sorted_keys() == keys
    assert s.sorted_keys(after=b"k010", limit=5) == keys[11:16]
    assert s.sorted_keys(after=keys[-1]) == []
    # The cached sort survives same-key updates and extends on new keys.
    s.write(b"k000", 2, b"v2")
    s.write(b"zzz", 1, b"v")
    assert s.sorted_keys() == keys + [b"zzz"]
    s.close()


# -- snapshot shipping -------------------------------------------------------


def test_snapshot_records_live_only(tmp_path):
    """snapshot_records seals the active segment and streams exactly
    the LIVE records (superseded same-(variable, t) copies stay dead),
    honoring the predicate."""
    s = LogStorage(str(tmp_path / "db"), fsync=False)
    s.write(b"x", 1, b"old")
    s.write(b"x", 1, b"new")  # supersedes the first copy
    s.write(b"x", 2, b"x2")
    s.write(b"y", 1, b"y1")
    got = sorted(s.snapshot_records())
    assert got == [(b"x", 1, b"new"), (b"x", 2, b"x2"), (b"y", 1, b"y1")]
    only_y = list(s.snapshot_records(lambda v: v == b"y"))
    assert only_y == [(b"y", 1, b"y1")]
    assert s.sealed_segment_paths()  # the active segment was sealed
    s.close()


# -- fill-scaling p50 --------------------------------------------------------


def _fill_p50(path: str, n: int, samples: int = 2000) -> float:
    """Median append latency measured AFTER ``n`` resident keys."""
    s = LogStorage(path, fsync=False)
    payload = b"p" * 64
    for i in range(n):
        s.write(b"fill-%07d" % i, 1, payload)
    lat = []
    for i in range(samples):
        t0 = time.perf_counter()
        s.write(b"probe-%07d" % i, 1, payload)
        lat.append(time.perf_counter() - t0)
    s.close()
    lat.sort()
    return lat[len(lat) // 2]


def test_fill_p50_flat_10k_vs_100k(tmp_path):
    """Append cost must not scale with resident keyspace: p50 at 100k
    keys within 1.3x of p50 at 10k (plus a scheduler-noise epsilon)."""
    p10k = _fill_p50(str(tmp_path / "s10k"), 10_000)
    p100k = _fill_p50(str(tmp_path / "s100k"), 100_000)
    assert p100k <= 1.3 * p10k + 5e-6, (p10k, p100k)


# The reference's 1M-key form of this check is a slow test; the port's
# 1M-key fill runs in chip_smoke.py's quorum phase.


# == stores carried across the packages ==

from bftkv_tpu import packet as ref_pkt  # noqa: E402
from bftkv_tpu.faults import failpoint as ref_fp  # noqa: E402
from bftkv_tpu.storage import logkv as ref_logkv  # noqa: E402
from bftkv_tpu.storage import native as ref_native  # noqa: E402
from bftkv_tpu.storage import plain as ref_plain  # noqa: E402
from bftkv_tpu_torch.faults import failpoint as fp  # noqa: E402
from bftkv_tpu_torch.storage.compact import compact_store  # noqa: E402

# Per engine: how each package opens it on a path.
ENGINES = {
    "log": (lambda p: LogStorage(p, fsync=False, segment_bytes=1024, compact_trigger=0),
            lambda p: ref_logkv.LogStorage(p, fsync=False, segment_bytes=1024, compact_trigger=0)),
    "plain": (PlainStorage, ref_plain.PlainStorage),
    "native": (NativeStorage, ref_native.NativeStorage),
}


def _trace():
    """Seeded writes: protocol records (pending below certified), raw and
    empty values, binary and long keys, a rewrite of the same (x, t)."""
    import random

    rng = random.Random(1234)
    out = []
    for i in range(90):
        var = rng.choice([b"a", b"key/%d" % (i % 7), b"\x00\xff", b"h" * 130])
        t = rng.randint(1, 9)
        kind = i % 3
        if kind == 0:
            sig = pkt.SignaturePacket(type=1, version=0, completed=True, data=b"s%d" % i, cert=b"c")
            ss = pkt.SignaturePacket(type=1, version=0, completed=bool(i % 2), data=b"ss", cert=None)
            val = pkt.serialize(var, b"v%d" % i, t, sig, ss)
        elif kind == 1:
            val = bytes(rng.randrange(256) for _ in range(rng.randint(0, 40)))
        else:
            val = b""
        out.append((var, t, val))
    return out


def _view(s):
    out = {"keys": sorted(s.keys()), "scan": sorted(s.scan())}
    for var in out["keys"]:
        out[("versions", var)] = sorted(s.versions(var))
        out[("latest", var)] = s.read(var)
        for t in s.versions(var):
            out[(var, t)] = s.read(var, t)
    return out


def _close(s):
    if hasattr(s, "close"):
        s.close()


def _tree(root):
    """Every file under ``root`` (or the one file) with its bytes."""
    if os.path.isfile(root):
        return {"": open(root, "rb").read()}
    return {os.path.relpath(os.path.join(d, n), root): open(os.path.join(d, n), "rb").read()
            for d, _, names in os.walk(root) for n in names}


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_stores_open_in_the_other_package(tmp_path, engine, writer):
    mine, theirs = ENGINES[engine]
    make_w, make_r = (mine, theirs) if writer == "port" else (theirs, mine)
    path = str(tmp_path / "db")
    w = make_w(path)
    for var, t, val in _trace():
        w.write(var, t, val)
    want = _view(w)
    _close(w)
    r = make_r(path)
    assert _view(r) == want
    _close(r)
    # The same writes from the other package give the same bytes on disk.
    other = str(tmp_path / "db2")
    o = make_r(other)
    for var, t, val in _trace():
        o.write(var, t, val)
    _close(o)
    assert _tree(other) == _tree(path)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_compacted_log_opens_in_the_other_package(tmp_path, writer):
    mine, theirs = ENGINES["log"]
    make_w, make_r = (mine, theirs) if writer == "port" else (theirs, mine)
    path = str(tmp_path / "db")
    w = make_w(path)
    for var, t, val in _trace():
        w.write(var, t, val)
    w.seal_active()
    stats = w.compact()
    assert stats["dropped"] > 0
    want = _view(w)
    _close(w)
    r = make_r(path)
    assert _view(r) == want
    _close(r)
    # The port's compaction of the same log leaves the reference's bytes.
    if writer == "ref":
        again = str(tmp_path / "db2")
        p = mine(again)
        for var, t, val in _trace():
            p.write(var, t, val)
        p.seal_active()
        assert p.compact() == stats
        _close(p)
        assert _tree(again) == _tree(path)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_torn_log_tail_recovers_in_the_other_package(tmp_path, writer):
    """A record torn mid-append by one package: the other truncates the
    tail at the bad checksum and recovers the exact pre-crash view."""
    mine, theirs = ENGINES["log"]
    make_w, make_r = (mine, theirs) if writer == "port" else (theirs, mine)
    fpm = fp if writer == "port" else ref_fp
    path = str(tmp_path / "db")
    w = make_w(path)
    for var, t, val in _trace()[:40]:
        w.write(var, t, val)
    want = _view(w)
    fpm.arm(3)
    try:
        fpm.registry.add("storage.write", "torn", match={"backend": "log"}, times=1)
        with pytest.raises(OSError):
            w.write(b"x", 3, b"v3-that-tears" * 10)
    finally:
        fpm.disarm()
    _close(w)
    r = make_r(path)
    assert _view(r) == want
    r.write(b"x", 3, b"v3")
    assert r.read(b"x") == b"v3"
    _close(r)


def test_compact_store_keeps_every_certified_record(tmp_path):
    """``compact_store`` (the engine's compaction entry) on a log of
    certified records written by the reference: every record reads back
    in both packages and parses in both codecs."""
    path = str(tmp_path / "db")
    w = ref_logkv.LogStorage(path, fsync=False, segment_bytes=1024, compact_trigger=0)
    recs = {}
    for i in range(60):
        var = b"c/%d" % (i % 20)
        sig = ref_pkt.SignaturePacket(type=1, version=0, completed=True, data=b"s", cert=b"c")
        raw = ref_pkt.serialize(var, b"v%d" % i, i // 20 + 1, sig, sig)
        w.write(var, i // 20 + 1, raw)
        recs[(var, i // 20 + 1)] = raw
    w.write(b"c/0", 1, recs[(b"c/0", 1)])  # a dead copy to reclaim
    _close(w)
    s = LogStorage(path, fsync=False, segment_bytes=1024, compact_trigger=0)
    s.seal_active()
    stats = compact_store(s)
    assert stats["kept"] == len(recs)
    s.reopen()
    for (var, t), raw in recs.items():
        assert s.read(var, t) == raw
        assert pkt.parse(raw).value == ref_pkt.parse(raw).value
    _close(s)
