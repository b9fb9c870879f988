"""P-256 deployments: the harness's keys and the reference's plain ECDSA
against the port's, a tiny P-256 cluster held to the reference, its
control, K5 in the frozen work model and its hooks, and the seeds' keys
pinned (a change to a key's label fails here)."""

from __future__ import annotations

import hashlib
import random
import time

import pytest

from portbench import cluster as clustermod
from portbench import keys as keysmod
from portbench import run
from portbench.hooks import KernelHooks
from portbench.reference import check, control, p256, sigs, wire
from portbench.tests.conftest import READ_MIX, WRITE_MIX
from portbench.workmodel import EC_K, Launch, bound_s, bytes_of, ops_of

TINY_P256 = {"servers": 4, "storage_nodes": 4, "key_algorithm": "p256", "key_bits": 256, "storage": "mem",
             "transport": "loopback", "dispatch_max_batch": 4096}
N, N_RW, CLIENTS = TINY_P256["servers"], TINY_P256["storage_nodes"], 1
#: On the CPU the port's batched EC paths run PyTorch's plain versions, minutes
#: a batch: the cluster tests keep ECDSA on the port's host curve (the card
#: runs K5; ``test_k5_hooks_count_live_points`` drives the batched path here).
HOST_EC = {"BFTKV_EC_VERIFY_THRESHOLD": "1000000", "BFTKV_EC_SIGN_THRESHOLD": "1000000"}


@pytest.fixture
def host_ec(monkeypatch):
    for k, v in HOST_EC.items():
        monkeypatch.setenv(k, v)


def _port_key(k: keysmod.EcKey):
    from bftkv_tpu_torch.crypto import ecdsa

    return ecdsa.ECPrivateKey(d=k.d, public=ecdsa.ECPublicKey(x=k.x, y=k.y))


@pytest.fixture(scope="module")
def ec_keys():
    return keysmod.make_keys(2**31 + 77, 6, 256, algorithm="p256")


def test_public_points_and_ids_are_the_ports(ec_keys):
    from bftkv_tpu_torch.crypto import cert, ec

    for k in ec_keys:
        assert 1 <= k.d < p256.N
        assert (k.x, k.y) == ec.P256.scalar_base_mult(k.d)
        assert p256.marshal((k.x, k.y)) == _port_key(k).public.marshal()
        want = cert.key_id_ec(cert.ALG_P256, _port_key(k).public.marshal())
        assert sigs.signer_id(k.public) == p256.key_id_ec("p256", p256.marshal((k.x, k.y))) == want
        assert cert.private_key_id(_port_key(k)) == want
    for d in (1, 2, 15, 16, 17, 255, 256, 2**255, p256.N - 1):
        assert p256.base_mult(d) == ec.P256.scalar_base_mult(d)


def test_verify_accepts_the_ports_signatures_and_rejects_faults(ec_keys):
    from bftkv_tpu_torch.crypto import ecdsa

    rng = random.Random(5)
    for i, k in enumerate(ec_keys):
        msg = rng.randbytes(40 + i)
        sig = ecdsa.sign(msg, _port_key(k))
        q = (k.x, k.y)
        assert p256.verify(msg, sig, q) and sigs.verify(k.public, msg, sig)
        flipped = bytearray(sig)
        flipped[rng.randrange(64)] ^= 1 << rng.randrange(8)
        assert not p256.verify(msg, bytes(flipped), q)
        assert not p256.verify(msg[:-1] + bytes([msg[-1] ^ 1]), sig, q)
        other = ec_keys[(i + 1) % len(ec_keys)]
        assert not p256.verify(msg, sig, (other.x, other.y))
        assert not p256.verify(msg, sig[:32] + bytes(32), q)  # s = 0
        for r in (p256.N, p256.N + 1, 2**256 - 1):  # r >= n
            assert not p256.verify(msg, r.to_bytes(32, "big") + sig[32:], q)
        assert not p256.verify(msg, sig, (k.x, (k.y + 1) % p256.P))  # off the curve
        assert not p256.verify(msg, sig[:-1], q)
        # The reference's own signatures verify under the port's verify.
        assert ecdsa.verify_host(msg, sigs.sign(k.private, msg), _port_key(k).public)


def test_keys_of_a_seed_are_pinned():
    rsa = keysmod.make_keys(2**33 + 7, 3, 512, workers=1)
    digest = hashlib.sha256(repr([k.as_tuple() for k in rsa]).encode()).hexdigest()
    assert digest == "e22ad5822ad5cdc6b5b8dc89b6550cab86955d4d6c5726a18d46a25c5efbd757"
    assert hex(rsa[0].n).startswith("0xaed627b43a0831bff8ad4c1203110cb3")
    assert [k.public for k in rsa] == [("rsa", (k.n, 65537)) for k in rsa]
    ec = keysmod.make_keys(2**33 + 7, 2, 256, algorithm="p256")
    assert [hex(k.d)[:18] for k in ec] == ["0xdcacb80cf82a9022", "0x326aff6602f8804d"]
    assert ec[0].d == 1 + random.Random(f"{2**33 + 7}/p256/0").randrange(p256.N - 1)


def test_bad_algorithms_and_widths_are_refused():
    with pytest.raises(ValueError):
        keysmod.make_keys(1, 1, 384, algorithm="p256")
    with pytest.raises(ValueError):
        keysmod.make_keys(1, 1, 256, algorithm="ed25519")
    with pytest.raises(ValueError):
        clustermod.build({**TINY_P256, "key_bits": 384}, CLIENTS,
                         keysmod.make_keys(1, N + N_RW + CLIENTS, 256, algorithm="p256"), "cpu")
    with pytest.raises(ValueError):
        clustermod.build({**TINY_P256, "key_algorithm": "dsa"}, CLIENTS, [], "cpu")


def test_a_key_whose_point_is_not_d_g_is_refused():
    ks = keysmod.make_keys(3, N + N_RW + CLIENTS, 256, algorithm="p256")
    ks[2] = keysmod.EcKey(ks[2].d + 1, ks[2].x, ks[2].y)
    with pytest.raises(RuntimeError, match="key 2"):
        clustermod.build(TINY_P256, CLIENTS, ks, "cpu")


@pytest.fixture(scope="module")
def p256_written():
    keys = keysmod.make_keys(424243, N + N_RW + CLIENTS, 256, algorithm="p256")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in HOST_EC.items():
            mp.setenv(k, v)
        return _write_and_read(keys)


def _write_and_read(keys):
    cl = clustermod.build(TINY_P256, CLIENTS, keys, "cpu")
    try:
        items = [(b"ec/%d" % i, bytes([i]) * 1024) for i in range(4)]
        assert cl.clients[0].write_many(items) == [None] * len(items)
        read_back = [cl.clients[0].read(var) for var, _ in items[:2]]
        cl.drain()
        stored = {var: cl.stored(var) for var, _ in items}
    finally:
        cl.stop()
    uni = check.Universe([k.public for k in keys[:N]], [k.public for k in keys[N + N_RW:]], N_RW)
    history = {var: (0, [check.Version(v, 0.0, 1.0, True)]) for var, v in items}
    reads = [check.Read(var, 2.0, 3.0, got) for (var, _v), got in zip(items, read_back)]
    return keys, uni, history, stored, reads


def test_a_p256_cluster_passes_the_reference(p256_written):
    _keys, uni, history, stored, reads = p256_written
    assert all(len([r for r in stored[v] if r is not None]) >= check.write_threshold(N_RW) for v in history)
    assert check.check(uni, history, reads, stored, sorted(history)) == {
        "missing_writes": 0, "bad_certificates": 0, "bad_reads": 0}
    var = sorted(history)[0]

    def flip(raw):
        rec = wire.parse_record(raw)
        entries = wire.parse_entries(rec.ss.data)
        sid, sig = entries[0]
        entries[0] = (sid, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:])
        rec.ss.data = wire.serialize_entries(entries[: check.bmasking(N)[3]])
        return wire.serialize_record(rec.variable, rec.value, rec.t, rec.sig, rec.ss)

    flipped = {**stored, var: [flip(raw) if raw else raw for raw in stored[var]]}
    assert check.check(uni, history, [], flipped, [var])["bad_certificates"] == 1


def test_the_p256_control_fails_every_record(p256_written):
    keys, uni, _history, _stored, _reads = p256_written
    items = [(b"ctl/%d" % i, bytes([9 + i]) * 1024, 0) for i in range(3)]
    servers, writers = [k.private for k in keys[:N]], [k.private for k in keys[N + N_RW:]]
    history = {var: (w, [check.Version(v, 0.0, 1.0, True)]) for var, v, w in items}
    stored = control.records(servers, writers, N_RW, items)
    assert check.check(uni, history, [], stored, sorted(history))["bad_certificates"] == len(items)
    full = control.records(servers, writers, N_RW, items, short_by=0)
    assert check.check(uni, history, [], full, sorted(history))["bad_certificates"] == 0


@pytest.mark.parametrize("mix", [WRITE_MIX, READ_MIX], ids=["write", "read"])
def test_a_whole_p256_run_is_correct(mix_file, host_ec, mix):
    run.environment()
    wanted = [{"name": "setup_s", "unit": "s"}, {"name": "signed_writes_per_s", "unit": "writes/s"}]
    out = run.run_cell({"name": "tiny_p256", "chips": 1}, TINY_P256, mix_file({**mix, "clients": 2}), 2**33 + 5,
                       1.0, False, wanted, device="cpu", t_start=time.perf_counter(), log=lambda *a, **k: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_k5_work_model_at_t64_and_t8192():
    per_point = 6 * 3920 * 2 * 27 * 28
    for t in (64, 8192):
        launch = Launch("k5", t, 256, 256)
        assert ops_of(launch) == per_point * t
        assert bytes_of(launch) == (2 * 3 * 55 * 4 + 64) * t
        assert bound_s(launch) == ops_of(launch) / 1.979e15
    # PERF.md's kernel table: K5, T=8192, bound 0.14721 ms (operations).
    assert bound_s(Launch("k5", 8192, 256, 256)) * 1e3 == pytest.approx(0.14721, rel=1e-4)
    assert EC_K == 27


def test_k5_hooks_count_live_points(monkeypatch):
    from bftkv_tpu_torch.crypto import ec
    from bftkv_tpu_torch.ops import ec as ec_ops
    from bftkv_tpu_torch.ops import ec_rns

    from bftkv_tpu_torch.ops import cuda_ec

    monkeypatch.setenv("BFTKV_EC_BACKEND", "rns")
    before = (ec_rns.scalar_mult_hosts, ec_rns.scalar_base_mult_hosts, cuda_ec.scalar_mult_cuda)
    hooks = KernelHooks()
    hooks.install()
    try:
        got = ec_ops.scalar_base_mult_hosts([3, 5, 7], device="cpu")
        ec_rns.scalar_base_mult_hosts([11] * 9, device="cpu")
        ec_rns.scalar_mult_hosts([(ec.P256.gx, ec.P256.gy)], [2], device="cpu")
    finally:
        hooks.remove()
    assert got == [ec.P256.scalar_base_mult(k) for k in (3, 5, 7)]
    assert [(x.kernel, x.rows) for x in hooks.launches] == [("k5", 3), ("k5", 9), ("k5", 1)]
    assert hooks.unmodelled == {"k1": 0, "k2": 0, "k5": 0}
    assert (ec_rns.scalar_mult_hosts, ec_rns.scalar_base_mult_hosts, cuda_ec.scalar_mult_cuda) == before


def _cut_to_one_short(record: bytes) -> bytes:
    """The record with its collective signature cut to suff - 1 signers."""
    rec = wire.parse_record(record)
    if rec.ss is None:
        return record
    rec.ss.data = wire.serialize_entries(wire.parse_entries(rec.ss.data)[: check.bmasking(N)[3] - 1])
    return wire.serialize_record(rec.variable, rec.value, rec.t, rec.sig, rec.ss)


@pytest.mark.parametrize("fault, number", [("value", "missing_writes"), ("one_signer_short", "bad_certificates")])
def test_a_p256_store_that_alters_what_it_holds(mix_file, host_ec, monkeypatch, fault, number):
    from bftkv_tpu_torch.storage.memkv import MemStorage

    orig = MemStorage.write
    if fault == "value":
        def alter(record):
            at = 8 + int.from_bytes(record[:8], "big") + 8 + 100  # inside the 1 KiB value
            return record[:at] + bytes([record[at] ^ 1]) + record[at + 1:]
    else:
        alter = _cut_to_one_short
    monkeypatch.setattr(MemStorage, "write", lambda self, variable, t, value: orig(self, variable, t, alter(value)))
    run.environment()
    out = run.run_cell({"name": "tiny_p256", "chips": 1}, TINY_P256, mix_file({**WRITE_MIX, "clients": 2}), 17,
                       1.0, False, [{"name": "setup_s", "unit": "s"}], device="cpu", t_start=time.perf_counter(),
                       log=lambda *a, **k: None)
    assert not out["correct"] and out["checks"][number]["value"] > 0
