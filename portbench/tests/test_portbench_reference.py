"""The reference accepts what a tiny CPU cluster of the port stored, and
rejects each broken guarantee: a flipped collective-signature byte, one
signer fewer than suff, an acknowledged write missing from storage, a
stale read; the control (suff - 1 signers) fails every record."""

from __future__ import annotations

import pytest

from portbench import cluster as clustermod
from portbench import keys as keysmod
from portbench.reference import check, control, wire
from portbench.tests.conftest import TINY

N, N_RW, CLIENTS = TINY["servers"], TINY["storage_nodes"], 1


@pytest.fixture(scope="module")
def written():
    keys = keysmod.make_keys(424242, N + N_RW + CLIENTS, TINY["key_bits"], workers=1)
    cl = clustermod.build(TINY, CLIENTS, keys, "cpu")
    try:
        items = [(b"ref/%d" % i, bytes([i]) * 1024) for i in range(6)]
        assert cl.clients[0].write_many(items) == [None] * len(items)
        cl.drain()
        stored = {var: cl.stored(var) for var, _ in items}
    finally:
        cl.stop()
    uni = check.Universe([k.public for k in keys[:N]], [k.public for k in keys[N + N_RW:]], N_RW)
    history = {var: (0, [check.Version(v, 0.0, 1.0, True)]) for var, v in items}
    return keys, uni, history, stored


def _with(stored, var, fn):
    out = dict(stored)
    out[var] = [fn(raw) if raw is not None else None for raw in stored[var]]
    return out


def _numbers(uni, history, stored, reads=()):
    return check.check(uni, history, list(reads), stored, sorted(history))


def test_quorum_sizes_are_worked_out_from_n():
    assert check.bmasking(64) == (21, 64, 43, 43)
    assert check.bmasking(10) == (3, 10, 7, 7)
    assert check.write_threshold(8) == 3 and check.write_threshold(6) == 2


def test_accepts_what_the_cluster_stored(written):
    _keys, uni, history, stored = written
    assert _numbers(uni, history, stored) == {"missing_writes": 0, "bad_certificates": 0, "bad_reads": 0}


def test_rejects_a_flipped_collective_signature_byte(written):
    _keys, uni, history, stored = written
    var = sorted(history)[0]

    def flip(raw):
        rec = wire.parse_record(raw)
        entries = wire.parse_entries(rec.ss.data)
        sid, sig = entries[0]
        entries[0] = (sid, bytes([sig[0] ^ 1]) + sig[1:])
        # Every signer's entry is needed at this size (4 servers, suff 3),
        # so one bad entry leaves too few.
        rec.ss.data = wire.serialize_entries(entries[: check.bmasking(N)[3]])
        return wire.serialize_record(rec.variable, rec.value, rec.t, rec.sig, rec.ss)

    assert _numbers(uni, history, _with(stored, var, flip))["bad_certificates"] == 1


def test_rejects_one_signer_fewer_than_suff(written):
    _keys, uni, history, stored = written
    var = sorted(history)[1]
    suff = check.bmasking(N)[3]

    def drop(raw):
        rec = wire.parse_record(raw)
        rec.ss.data = wire.serialize_entries(wire.parse_entries(rec.ss.data)[: suff - 1])
        return wire.serialize_record(rec.variable, rec.value, rec.t, rec.sig, rec.ss)

    assert _numbers(uni, history, _with(stored, var, drop))["bad_certificates"] == 1


def test_rejects_an_acknowledged_write_missing_from_storage(written):
    _keys, uni, history, stored = written
    var = sorted(history)[2]
    gone = dict(stored)
    gone[var] = [None] * (N_RW - check.write_threshold(N_RW) + 1) + stored[var][N_RW - check.write_threshold(N_RW) + 1:]
    assert _numbers(uni, history, gone)["missing_writes"] == 1


def test_rejects_a_stale_or_unwritten_read(written):
    _keys, uni, history, stored = written
    var = sorted(history)[3]
    h = dict(history)
    old = h[var][1][0]
    new = check.Version(b"n" * 1024, 2.0, 3.0, True)
    h[var] = (0, [old, new])
    stale = check.Read(var, 4.0, 5.0, old.value)
    ok = check.Read(var, 2.5, 5.0, old.value)  # concurrent with the new write
    never = check.Read(var, 4.0, 5.0, b"x" * 1024)
    stored2 = _with(stored, var, lambda raw: raw)
    assert _numbers(uni, h, stored2, [ok])["bad_reads"] == 0
    assert _numbers(uni, h, stored2, [stale, never])["bad_reads"] == 2


def test_control_fails_every_record(written):
    keys, uni, _history, _stored = written
    items = [(b"ctl/%d" % i, bytes([7 + i]) * 1024, 0) for i in range(3)]
    servers, writers = [k.private for k in keys[:N]], [k.private for k in keys[N + N_RW:]]
    stored = control.records(servers, writers, N_RW, items)
    history = {var: (w, [check.Version(v, 0.0, 1.0, True)]) for var, v, w in items}
    assert _numbers(uni, history, stored)["bad_certificates"] == len(items)
    full = control.records(servers, writers, N_RW, items, short_by=0)
    assert _numbers(uni, history, full)["bad_certificates"] == 0
