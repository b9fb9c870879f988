"""The port's protocol layer against the reference's cases and the
reference itself: ``tests/test_protocol.py``, ``test_batch_write.py``,
``test_piggyback.py``, ``test_bulk_revoke.py`` and
``test_protocol_auth.py`` rewritten against port clusters on the cpu;
the same plaintext frames through a reference ``Server`` and a port
``Server`` of one identity and one store give the same bytes; port and
reference clients and servers interoperate over localhost HTTP; the
batched equivocation mask equals the reference's.

Clusters are 4 servers + 4 storage nodes on 1024-bit seeded keys.  The
TPA and threshold modexps run on host ``pow`` and threshold ECDSA on the
host curve (the plain K2 batch of the 2048-bit TPA group takes seconds
on a CPU); the card's path is ``chip_smoke.py``'s protocol phase.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import pytest

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch import topology
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.crypto import new_crypto, rsa, vcache
from bftkv_tpu_torch.crypto.signature import serialize_entries
from bftkv_tpu_torch.crypto.threshold import ThresholdAlgo
from bftkv_tpu_torch.crypto.threshold import ecdsa as port_tecdsa
from bftkv_tpu_torch.errors import (
    ERR_INVALID_QUORUM_CERTIFICATE,
    ERR_INVALID_TIMESTAMP,
    ERR_PERMISSION_DENIED,
    Error,
)
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.graph import Graph
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import dispatch, modexp
from bftkv_tpu_torch.packet import SIGNATURE_TYPE_NATIVE, SignaturePacket
from bftkv_tpu_torch.protocol.client import Client, _SignedValue
from bftkv_tpu_torch.protocol.server import Server
from bftkv_tpu_torch.quorum.wotqs import WotQS
from bftkv_tpu_torch.transport.loopback import TrLoopback

from test_torch_utils import BITS, DEVICE, seeded_key, start_cluster


@pytest.fixture(autouse=True)
def _host_engines(monkeypatch):
    """Both packages' shared modexp engines on host ``pow`` and both
    packages' threshold ECDSA on the host curve."""
    from bftkv_tpu.crypto.threshold import ecdsa as ref_tecdsa
    from bftkv_tpu.ops import modexp as ref_modexp

    monkeypatch.setattr(modexp.BatchModExp, "_shared",
                        {modexp.devmod.resolve(DEVICE): modexp.BatchModExp(min_batch=10**9, device=DEVICE)})
    monkeypatch.setattr(ref_modexp.BatchModExp, "_shared", ref_modexp.BatchModExp(min_batch=10**9))
    monkeypatch.setattr(port_tecdsa._ECDSAGroupOps, "_device_capable", lambda self: False)
    monkeypatch.setattr(ref_tecdsa._ECDSAGroupOps, "_device_capable", lambda self: False)


# -- test_protocol.py -----------------------------------------------
# Protocol-layer integration tests: the reference's tier-3 behavioral
# spec, un-skipped (reference: protocol/server_test.go:34-59,
# rw_test.go, mal_test.go TOFU scenario, protocol.go Joining).

@pytest.fixture(scope="module")
def proto_cluster():
    c = start_cluster(n_servers=4, n_users=2, bits=BITS, unsigned_users=1)
    yield c
    c.stop()


def test_basic_write_read(proto_cluster):
    """reference: protocol/server_test.go:34-59."""
    cli = proto_cluster.clients[0]
    cli.write(b"test_basic", b"hello world")
    assert cli.read(b"test_basic") == b"hello world"


def test_overwrite_bumps_timestamp(proto_cluster):
    cli = proto_cluster.clients[0]
    cli.write(b"test_over", b"v1")
    cli.write(b"test_over", b"v2")
    assert cli.read(b"test_over") == b"v2"
    # storage holds both versions; latest has t=2
    srv = proto_cluster.storage_servers[0]
    stored = pkt.parse(srv.storage.read(b"test_over", 0))
    assert stored.t == 2
    assert stored.value == b"v2"


def test_write_once_is_final(proto_cluster):
    cli = proto_cluster.clients[0]
    cli.write_once(b"test_once", b"forever")
    assert cli.read(b"test_once") == b"forever"
    # t is pinned at 2^64-1; the next Write's time phase must refuse
    # (reference: client.go:85-87 ErrInvalidTimestamp)
    with pytest.raises(ERR_INVALID_TIMESTAMP):
        cli.write(b"test_once", b"again")


def test_tofu_rejects_foreign_writer(proto_cluster):
    """A different user (different id AND uid) cannot overwrite
    (reference: server.go:329-337, mal_test.go TOFU scenario)."""
    owner, intruder = proto_cluster.clients[0], proto_cluster.clients[1]
    owner.write(b"test_tofu", b"mine")
    # TOFU ownership is established by the CERTIFIED record (pending
    # residue never owns — DESIGN.md §12); settle the async tail first.
    owner.drain_tails()
    with pytest.raises(Error):
        intruder.write(b"test_tofu", b"stolen")
    assert owner.read(b"test_tofu") == b"mine"


def test_unsigned_user_has_no_quorum_certificate(proto_cluster):
    """The unsigned user's cert fails the CERT-quorum threshold at sign
    time (reference: server.go:211-214; setup.sh leaves u04 unsigned)."""
    unsigned = proto_cluster.clients[1]  # last user is the unsigned one
    with pytest.raises(ERR_INVALID_QUORUM_CERTIFICATE):
        unsigned.write(b"test_unsigned_var", b"x")


def test_read_missing_variable(proto_cluster):
    cli = proto_cluster.clients[0]
    assert cli.read(b"test_never_written") is None


def test_read_repair(proto_cluster):
    """A server that missed the write gets healed by the next read
    (reference: client.go:281-302)."""
    cli = proto_cluster.clients[0]
    cli.write(b"test_repair", b"healme")
    cli.drain_tails()  # back-fill delivers the full-quorum copies
    victim = proto_cluster.storage_servers[0]
    # wipe the victim's copy
    victim.storage._data.pop(b"test_repair", None)  # type: ignore[attr-defined]
    assert cli.read(b"test_repair") == b"healme"
    # the read worker finishes write-back asynchronously
    deadline = time.time() + 5
    while time.time() < deadline:
        try:
            raw = victim.storage.read(b"test_repair", 0)
            assert pkt.parse(raw).value == b"healme"
            return
        except Exception:
            time.sleep(0.05)
    raise AssertionError("read repair never reached the stale server")


def test_joining_discovers_the_graph():
    """A client knowing one server crawls the whole membership
    (reference: protocol/protocol.go:21-52)."""
    c = start_cluster(n_servers=4, n_users=1, bits=BITS)
    try:
        uni = c.universe
        user = uni.users[0]
        # the newcomer's initial view: itself + one server only
        keep = {user.id, uni.servers[0].id}
        seed = [cc for cc in uni.view_of(user) if cc.id in keep]
        graph, crypt, qs = topology.make_node(user, seed, device=DEVICE)
        tr = TrLoopback(crypt, c.net)
        newcomer = Client(graph, qs, tr, crypt, device=DEVICE)
        assert len(graph.get_peers()) == 1
        newcomer.joining()
        ids = {n.id for n in graph.get_peers()}
        for s in uni.servers:
            assert s.cert.id in ids
    finally:
        c.stop()


def test_cluster_on_native_storage(tmp_path_factory):
    """A full protocol round on the C++ log-structured backend —
    incl. the read scan-back which needs ``versions()``
    (reference: server.go:166-180 over leveldb.go:30-46)."""
    from bftkv_tpu_torch.storage.native import NativeStorage

    base = tmp_path_factory.mktemp("nativedb")
    counter = [0]

    def factory():
        counter[0] += 1
        return NativeStorage(str(base / f"db{counter[0]}.log"))

    c = start_cluster(n_servers=4, n_users=1, bits=BITS, storage_factory=factory)
    try:
        cli = c.clients[0]
        cli.write(b"native_rt", b"v1")
        cli.write(b"native_rt", b"v2")
        assert cli.read(b"native_rt") == b"v2"

        # In-progress sign record (no completed ss) far above the last
        # completed version: the read must scan back via versions().
        srv = c.storage_servers[0]
        completed = srv.storage.read(b"native_rt", 0)
        p = pkt.parse(completed)
        stale = pkt.serialize(b"native_rt", b"ghost", p.t + 5000, p.sig, None)
        srv.storage.write(b"native_rt", p.t + 5000, stale)
        raw = srv._read(pkt.serialize(b"native_rt", None, 0), None, None)
        assert pkt.parse(raw).value == b"v2"
    finally:
        c.stop()
        for s in c.all_servers:
            s.storage.close()


def test_concurrent_writers_same_variable():
    """Two *distinct* signed clients race writes to one variable
    (reference: protocol/rw_test.go TestConflict /
    TestManyClientsConcurrentWrite — distinct keys per writer: one key
    racing itself would equivocate and get revoked): individual rounds
    may fail with interned protocol errors (equivocation / bad
    timestamp), but the system stays consistent — readers converge on a
    value some writer actually wrote."""
    import threading

    from bftkv_tpu_torch.errors import Error

    # Dedicated proto_cluster: the storm legitimately triggers server-side
    # conflict handling, which must not leak into other tests' state.
    c = start_cluster(n_servers=4, n_users=2, n_rw=4, bits=BITS)
    try:
        attempted: list[bytes] = []
        written: list[bytes] = []
        unexpected: list = []

        def storm(client, tag):
            for i in range(6):
                val = b"%s-%d" % (tag, i)
                # A write that errors after collecting its collective
                # signature can still land on some servers and win the
                # read — converged values come from *attempted*, not
                # only acknowledged, writes.
                attempted.append(val)
                try:
                    client.write(b"conflict/x", val)
                    written.append(val)
                except Error:
                    pass  # protocol-level rejection is legitimate here
                except Exception as e:  # pragma: no cover
                    unexpected.append(e)

        threads = [
            threading.Thread(target=storm, args=(c.clients[0], b"a")),
            threading.Thread(target=storm, args=(c.clients[1], b"b")),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not unexpected, unexpected
        assert written, "at least one write must succeed"
        r1 = c.clients[0].read(b"conflict/x")
        r2 = c.clients[1].read(b"conflict/x")
        assert r1 in attempted
        assert r2 == r1  # convergence across readers
    finally:
        c.stop()


# -- test_batch_write.py --------------------------------------------
# The batched write pipeline (``Client.write_many`` + the BATCH_*
# server handlers).
# 
# The batch path must keep exact single-``write`` semantics per item —
# timestamp, quorum-certificate, equivocation, TOFU, write-once, and
# collective-signature checks all still run on every replica — while the
# three phases each cross the network once for the whole batch.  These
# tests assert equivalence with the single path, per-item error
# independence, and interop in both directions (batch-written values read
# back through the normal quorum read; singly-written variables update
# through the batch path).

@pytest.fixture(scope="module")
def batch_cluster():
    c = start_cluster(4, 2, 4)
    yield c
    c.stop()


def test_write_many_roundtrip(batch_cluster):
    c = batch_cluster.clients[0]
    items = [(b"batch/x%d" % i, b"value-%d" % i) for i in range(8)]
    errs = c.write_many(items)
    assert errs == [None] * len(items)
    for var, val in items:
        assert c.read(var) == val


def test_write_many_interops_with_single_path(batch_cluster):
    c = batch_cluster.clients[0]
    # Singly-written variable updates through the batch path at t+1...
    c.write(b"batch/mix", b"v1")
    errs = c.write_many([(b"batch/mix", b"v2"), (b"batch/other", b"o1")])
    assert errs == [None, None]
    assert c.read(b"batch/mix") == b"v2"
    # ...and a batch-written variable updates through the single path.
    c.write(b"batch/other", b"o2")
    assert c.read(b"batch/other") == b"o2"


def test_write_many_per_item_errors_are_independent(batch_cluster):
    c = batch_cluster.clients[0]
    # A write-once variable rejects updates but must not sink the batch.
    c.write_once(b"batch/frozen", b"forever")
    errs = c.write_many(
        [(b"batch/frozen", b"mutate?"), (b"batch/live", b"fine")]
    )
    # Same mapping as the single path: an immutable variable surfaces at
    # the Time phase as maxt == 2^64-1 (client.go:90-92 analog).
    assert errs[0] == ERR_INVALID_TIMESTAMP
    assert errs[1] is None
    assert c.read(b"batch/frozen") == b"forever"
    assert c.read(b"batch/live") == b"fine"


def test_write_many_rejects_hidden_prefix_per_item(batch_cluster):
    c = batch_cluster.clients[0]
    errs = c.write_many(
        [(b"!!!secret!!!x", b"nope"), (b"batch/visible", b"yes")]
    )
    assert errs[0] == ERR_PERMISSION_DENIED
    assert errs[1] is None
    assert c.read(b"batch/visible") == b"yes"


def test_write_many_rejects_duplicate_variables(batch_cluster):
    c = batch_cluster.clients[0]
    with pytest.raises(ValueError):
        c.write_many([(b"batch/dup", b"a"), (b"batch/dup", b"b")])


def test_write_many_empty_batch(batch_cluster):
    assert batch_cluster.clients[0].write_many([]) == []


def test_write_many_monotonic_timestamps(batch_cluster):
    """Repeated batches bump t exactly like repeated single writes."""
    c = batch_cluster.clients[0]
    for round_no in range(3):
        errs = c.write_many([(b"batch/t", b"round-%d" % round_no)])
        assert errs == [None]
    assert c.read(b"batch/t") == b"round-2"
    srv = batch_cluster.servers[0]
    stored = pkt.parse(srv.storage.read(b"batch/t", 0))
    assert stored.t == 3


def test_write_many_two_clients_see_each_other(batch_cluster):
    """Client B's batch write at t, then client A single-writes at t+1
    (same-uid TOFU applies across users of the same uid universe)."""
    a, b = batch_cluster.clients[0], batch_cluster.clients[1]
    errs = b.write_many([(b"batch/shared-%d" % i, b"from-b") for i in range(4)])
    assert errs == [None] * 4
    assert a.read(b"batch/shared-0") == b"from-b"


def test_write_many_with_dispatchers_installed(batch_cluster):
    """The pipeline's device batches coalesce through the global
    dispatchers exactly like the single path (here the cpu dispatchers:
    their calibration pins the host tier)."""
    dispatch.install(dispatch.VerifyDispatcher(device=DEVICE))
    dispatch.install_signer(dispatch.SignDispatcher(device=DEVICE))
    try:
        c = batch_cluster.clients[0]
        items = [(b"batch/disp%d" % i, bytes([i]) * 64) for i in range(16)]
        assert c.write_many(items) == [None] * 16
        for var, val in items:
            assert c.read(var) == val
    finally:
        dispatch.uninstall_all()


def test_read_many_roundtrip(batch_cluster):
    c = batch_cluster.clients[0]
    items = [(b"rm/%d" % i, b"rv-%d" % i) for i in range(6)]
    assert c.write_many(items) == [None] * 6
    got = c.read_many([v for v, _ in items])
    assert got == [val for _, val in items]


def test_read_many_mixed_missing_and_errors(batch_cluster):
    c = batch_cluster.clients[0]
    c.write(b"rm/present", b"here")
    got = c.read_many([b"rm/present", b"rm/never-written", b"!!!secret!!!x"])
    assert got[0] == b"here"
    assert got[1] is None  # no data: every replica answers "empty"
    assert got[2] == ERR_PERMISSION_DENIED  # hidden prefix, per item


def test_read_many_repairs_stale_replica(batch_cluster):
    """A replica that missed the write phase gets read-repaired by the
    batch.  The victim must be a node the READ quorum actually consults
    (a storage node: W = U − {Ci} + R lands writes there), and healing
    means the *collective signature* is back, not just the value."""
    import time

    c = batch_cluster.clients[0]
    c.write(b"rm/heal", b"healthy")
    c.drain_tails()  # the collective back-fill rides the async tail
    victim = batch_cluster.storage_servers[0]
    stored = victim.storage.read(b"rm/heal", 0)
    p = pkt.parse(stored)
    assert p.ss is not None and p.ss.completed  # precondition: healthy
    # Realistic staleness: the replica saw the sign request (persisted
    # without ss — the in-progress marker) but missed the write phase.
    victim.storage.write(
        b"rm/heal",
        p.t,
        pkt.serialize(b"rm/heal", p.value, p.t, p.sig, None),
    )
    got = c.read_many([b"rm/heal"])
    assert got == [b"healthy"]
    deadline = time.time() + 5
    healed = False
    while time.time() < deadline and not healed:
        rp = pkt.parse(victim.storage.read(b"rm/heal", 0))
        healed = rp.ss is not None and rp.ss.completed
        if not healed:
            time.sleep(0.05)
    assert healed, "stale replica was not repaired by read_many"


def test_concurrent_overlapping_batches_converge(batch_cluster):
    """Two clients batch-writing OVERLAPPING variables concurrently:
    every per-item outcome is success or one of the protocol's conflict
    errors, and afterwards each variable reads back as ONE consistent
    value on a quorum (a written value — or nothing, when the conflict
    sank both writers).  Mirrors the reference's concurrency scenarios
    (rw_test.go) on the batch path."""
    import threading

    from bftkv_tpu_torch.errors import (
        ERR_BAD_TIMESTAMP,
        ERR_EQUIVOCATION,
        ERR_INSUFFICIENT_NUMBER_OF_RESPONSES,
        ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES,
        ERR_INVALID_SIGN_REQUEST,
    )

    a, b = batch_cluster.clients[0], batch_cluster.clients[1]
    shared = [b"conc/%d" % i for i in range(6)]
    outcomes: dict = {}

    def run(tag, client):
        try:
            outcomes[tag] = client.write_many(
                [(v, b"%s-val" % tag) for v in shared]
            )
        except Exception as e:  # keep the real failure, not a KeyError
            outcomes[tag] = e

    ts = [
        threading.Thread(target=run, args=(t, c))
        for t, c in ((b"A", a), (b"B", b))
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join()

    conflict_errors = (
        ERR_BAD_TIMESTAMP,
        ERR_EQUIVOCATION,
        ERR_INSUFFICIENT_NUMBER_OF_RESPONSES,
        ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES,
        ERR_INVALID_SIGN_REQUEST,
    )
    for tag in (b"A", b"B"):
        assert isinstance(outcomes[tag], list), outcomes[tag]
        for err in outcomes[tag]:
            assert err is None or err in conflict_errors, err

    for v in shared:
        got = a.read(v)
        # A conflict may sink both writers (neither reaches quorum);
        # what must never happen is a torn or reader-dependent value.
        assert got in (b"A-val", b"B-val", None), (v, got)
        assert b.read(v) == got




def test_write_many_over_http():
    """One batched round over real localhost HTTP sockets."""
    c = start_cluster(4, 1, 4, transport="http")
    try:
        client = c.clients[0]
        items = [(b"hb/%d" % i, b"http-%d" % i) for i in range(6)]
        assert client.write_many(items) == [None] * 6
        for var, val in items:
            assert client.read(var) == val
        assert client.read_many([v for v, _ in items]) == [
            val for _, val in items
        ]
    finally:
        c.stop()


def test_batch_frame_cert_survives_rejected_carrier(batch_cluster):
    """Mid-join writer: replicas lack the writer's cert and the batch
    pipeline embeds it on the FIRST item only.  If that carrier item is
    itself rejected (hidden prefix), the frame-level cert harvest must
    still resolve the remaining items' signer (the harvest must run
    before the per-item policy checks)."""
    c = batch_cluster.clients[0]
    cid = c.crypt.signer.cert.id
    saved = []
    for s in batch_cluster.all_servers:
        cert = s.crypt.keyring.get(cid)
        if cert is not None:
            saved.append((s, cert))
            s.crypt.keyring.remove([cid])
    try:
        errs = c.write_many(
            [
                (b"!!!secret!!!carrier", b"nope"),
                (b"batch/after-carrier", b"survives"),
            ]
        )
        assert errs[0] == ERR_PERMISSION_DENIED
        assert errs[1] is None, errs[1]
        assert c.read(b"batch/after-carrier") == b"survives"
    finally:
        for s, cert in saved:
            s.crypt.keyring.register([cert])


def test_batch_overwrite_by_midjoin_writer(batch_cluster):
    """Mid-join writer OVERWRITES through the batch path.  TOFU in
    ``_write_storage_checks`` resolves new_issuer for items 2..B from
    the frame-level cert harvest, and prev_issuer from the stored
    record — which ``_batch_sign`` must persist self-contained (the
    carrier's cert restored) or all later overwrites of the variable
    fail until join gossip lands the writer's cert."""
    c = batch_cluster.clients[0]
    cid = c.crypt.signer.cert.id
    saved = []
    for s in batch_cluster.all_servers:
        cert = s.crypt.keyring.get(cid)
        if cert is not None:
            saved.append((s, cert))
            s.crypt.keyring.remove([cid])
    variables = [b"batch/midjoin-ow-%d" % i for i in range(3)]
    try:
        errs = c.write_many([(v, b"gen1-" + v) for v in variables])
        assert errs == [None] * 3, errs
        # Overwrite through the batch path: every item, not just the
        # cert-carrying first one, must pass TOFU on every replica.
        errs = c.write_many([(v, b"gen2-" + v) for v in variables])
        assert errs == [None] * 3, errs
        for v in variables:
            assert c.read(v) == b"gen2-" + v
        # And the single path can overwrite a batch-written variable
        # mid-join too (prev_issuer comes from the stored record).
        c.write(variables[1], b"gen3")
        assert c.read(variables[1]) == b"gen3"
    finally:
        for s, cert in saved:
            s.crypt.keyring.register([cert])


# -- test_piggyback.py ----------------------------------------------
# Round-collapsed writes: piggybacked shares, presession
# leases, 2f+1 early commit with the async certify tail.
# 
# The acceptance smoke lives here too: a steady-state write crosses the
# network in at most TWO quorum round trips — the combined WRITE_SIGN
# fan-out the caller waits on, plus the async collective back-fill —
# counted from the client-side ``transport.rpcs`` deltas.

@pytest.fixture(scope="module")
def pb_cluster():
    c = start_cluster(4, 1, 4, bits=BITS)
    yield c
    c.stop()


def _client_rpcs(snap: dict) -> dict[str, int]:
    """client-side transport.rpcs by command name."""
    out: dict[str, int] = {}
    for k, v in snap.items():
        if k.startswith("transport.rpcs{") and "side=client" in k:
            cmd = k.split("cmd=")[1].split(",")[0].rstrip("}")
            out[cmd] = out.get(cmd, 0) + v
    return out


def _delta(after: dict, before: dict) -> dict[str, int]:
    return {
        k: v - before.get(k, 0)
        for k, v in after.items()
        if v - before.get(k, 0) > 0
    }


# -- the acceptance smoke: <= 2 quorum round trips per steady write ---------


def test_steady_state_write_is_two_round_trips(pb_cluster):
    """After warmup, one write = one WRITE_SIGN fan-out (the round the
    caller waits on) + one batched BATCH_WRITE back-fill round on the
    async tail — and NOTHING else: no TIME round, no SIGN round."""
    cl = pb_cluster.clients[0]
    cl.write(b"rt/warm", b"v")  # sessions + quorum caches + pump
    cl.drain_tails()

    before = _client_rpcs(metrics.snapshot())
    cl.write(b"rt/steady", b"value")
    cl.drain_tails()
    after = _client_rpcs(metrics.snapshot())
    d = _delta(after, before)

    # Only the two write-path rounds crossed the network.
    assert set(d) <= {"write_sign", "batch_write"}, d
    assert d.get("write_sign", 0) >= 1

    # Round-trip bound: the combined round fans to (at most) the
    # sign q ∪ write q union, the back-fill to the write quorum — two
    # rounds' worth of RPCs.
    qa = qm.choose_quorum_for(cl.qs, b"rt/steady", qm.AUTH | qm.PEER)
    qw = qm.choose_quorum_for(cl.qs, b"rt/steady", qm.WRITE)
    union = {n.id for n in qa.nodes()} | {n.id for n in qw.nodes()}
    assert d.get("write_sign", 0) <= len(union)
    assert d.get("batch_write", 0) <= len(qw.nodes())
    assert sum(d.values()) <= len(union) + len(qw.nodes())


def test_repeat_writer_uses_lease_no_declines(pb_cluster):
    """Overwriting a variable this client already wrote costs zero
    timestamp declines: the presession lease supplies the guess."""
    cl = pb_cluster.clients[0]
    cl.write(b"lease/x", b"v1")
    before = metrics.snapshot().get("client.piggyback.retry_t", 0)
    cl.write(b"lease/x", b"v2")
    cl.write(b"lease/x", b"v3")
    assert metrics.snapshot().get("client.piggyback.retry_t", 0) == before
    assert cl.read(b"lease/x") == b"v3"


def test_stale_lease_declines_and_retries_in_round(pb_cluster):
    """A cold lease guesses t=1 against a variable that moved on; the
    quorum answers with stored-timestamp hints and the SAME round
    structure retries — no TIME round, no revocation of the honest
    writer."""
    cl = pb_cluster.clients[0]
    cl.write(b"stale/x", b"v1")
    cl.write(b"stale/x", b"v2")
    cl._presession.lease_drop(b"stale/x")  # simulate a restarted client
    before = metrics.snapshot()
    cl.write(b"stale/x", b"v3")
    snap = metrics.snapshot()
    assert snap.get("client.piggyback.retry_t", 0) > before.get(
        "client.piggyback.retry_t", 0
    )
    # the decline path must not have touched the TIME round
    assert _delta(_client_rpcs(snap), _client_rpcs(before)).get(
        "time", 0
    ) == 0
    assert cl.read(b"stale/x") == b"v3"
    # an optimistic decline is not equivocation: nobody got revoked
    assert not cl.self_node.revoked


def test_tail_certifies_the_record(pb_cluster):
    """After the tail drains, the write plane holds the record with a
    completed, sufficient collective signature (the wotqs math is
    untouched: suff signers, verified)."""
    cl = pb_cluster.clients[0]
    cl.write(b"cert/x", b"certified")
    cl.drain_tails()
    qa = qm.choose_quorum_for(cl.qs, b"cert/x", qm.AUTH)
    certified = 0
    for srv in pb_cluster.storage_servers:
        raw = srv.storage.read(b"cert/x", 0)
        p = pkt.parse(raw)
        if p.ss is not None and p.ss.completed:
            srv.crypt.collective.verify(
                pkt.tbss(raw), p.ss, qa, srv.crypt.keyring
            )
            certified += 1
    assert certified == len(pb_cluster.storage_servers)


def test_read_before_backfill_resolves_committed_value(pb_cluster):
    """The race the early commit opens: a read lands after the 2f+1
    commit but before the collective back-fill.  The pending record is
    served, wins by responder threshold, and the READER completes the
    certification — the committed value comes back, never a bare
    unbacked one."""
    cl = pb_cluster.clients[0]
    fp.arm(81)
    try:
        # Cut the back-fill entirely: both delivery shapes drop (the
        # coalescer's BATCH_WRITE and the certify-repair WRITE).
        fp.registry.add(
            "transport.send",
            "drop",
            match={"cmd": lambda c: c in ("write", "batch_write")},
            rule_id="bf",
        )
        before = metrics.snapshot().get("client.read.certified", 0)
        cl.write(b"race/x", b"committed")
        cl.drain_tails()
        # Every write-plane copy that exists is still commit-pending,
        # and at least the commit threshold (f+1) of them exist — the
        # wave-1 fan-out wrote those; the rest would have come from the
        # (cut) back-fill.
        pending = 0
        for srv in pb_cluster.storage_servers:
            try:
                raw = srv.storage.read(b"race/x", 0)
            except Exception:
                continue
            p = pkt.parse(raw)
            assert p.ss is not None and not p.ss.completed
            pending += 1
        assert pending >= 2  # f+1 for the 4-node write plane
        assert cl.read(b"race/x") == b"committed"
        assert metrics.snapshot().get("client.read.certified", 0) > before
    finally:
        fp.disarm()
    # With the drop healed, the next read re-certifies and its repair
    # tail upgrades the pending copies to the certified record.  The
    # reference polls for the upgrade against a 5 s deadline; here the
    # client quiesces first (its certify-repair tails and the back-fill
    # coalescer, with no time bound), so the state is final when read.
    assert cl.read(b"race/x") == b"committed"
    cl._backfills.drain(None)
    cl.drain_tails(timeout=None)
    done = sum(
        1
        for srv in pb_cluster.storage_servers
        if (p := pkt.parse(srv.storage.read(b"race/x", 0))).ss is not None
        and p.ss.completed
    )
    assert done >= 1


def test_batched_read_resolves_pending_too(pb_cluster):
    """read_many hits the same pending-resolution path."""
    cl = pb_cluster.clients[0]
    fp.arm(82)
    try:
        fp.registry.add(
            "transport.send",
            "drop",
            match={"cmd": lambda c: c in ("write", "batch_write")},
            rule_id="bf2",
        )
        cl.write(b"race/m1", b"mv1")
        cl.write(b"race/m2", b"mv2")
        cl.drain_tails()
        assert cl.read_many([b"race/m1", b"race/m2"]) == [b"mv1", b"mv2"]
    finally:
        fp.disarm()


# -- starved tails surface in the health plane ------------------------------


def test_starved_tail_raises_anomaly():
    """n=5 clique: commit lands at 2f+1 = 3 acks but suff = 4.  Two
    share-withholding clique members (Byzantine-lite: honest persist,
    shareless ack — clean drops beyond f would fail the round outright,
    so starvation is inherently a misbehavior phenomenon) starve the
    tail.  The write still succeeds (that is the point of early
    commit), the counter fires, the fleet collector turns it into an
    anomaly, and a later read certifies the record anyway (helping)."""
    from bftkv_tpu_torch.obs import FleetCollector, LocalSource

    c = start_cluster(5, 1, 4, bits=BITS)
    cl = c.clients[0]

    def shareless(server, cmd, req, peer, sender):
        server._write_sign(req, peer, sender)  # honest admission+persist
        return pkt.serialize_ws_ack(share=b"")  # ... but no share

    try:
        cl.write(b"starve/warm", b"v")
        cl.drain_tails()
        collector = FleetCollector(
            [
                LocalSource("a01", lambda: c.servers[0]),
            ],
            local_metrics=metrics,
        )
        collector.scrape_once()  # baseline for counter deltas
        fp.arm(83)
        try:
            fp.registry.add(
                "server.admission",
                "handle",
                match={
                    "node": lambda n: n in ("a04", "a05"),
                    "cmd": "write_sign",
                },
                fn=shareless,
                rule_id="withhold2",
            )
            before = metrics.snapshot().get("client.tail.starved", 0)
            cl.write(b"starve/x", b"survives")
            cl.drain_tails()
            assert (
                metrics.snapshot().get("client.tail.starved", 0)
                == before + 1
            )
        finally:
            fp.disarm()
        collector.scrape_once()
        kinds = {a["kind"] for a in collector.anomalies()}
        assert "tail_starved" in kinds
        # the read certifies the starved record (misbehavior healed)
        assert cl.read(b"starve/x") == b"survives"
    finally:
        c.stop()


# -- negotiation: old servers keep working ----------------------------------


class LegacyServer(Server):
    """A pre-piggyback server: WRITE_SIGN is an unknown command."""

    _handlers = {
        k: v for k, v in Server._handlers.items() if k != tp.WRITE_SIGN
    }


def test_legacy_quorum_falls_back_to_classic_rounds():
    c = start_cluster(4, 1, 4, bits=BITS, server_cls=LegacyServer)
    cl = c.clients[0]
    try:
        before = metrics.snapshot().get("client.piggyback.fallback", 0)
        cl.write(b"legacy/x", b"old school")
        assert cl.read(b"legacy/x") == b"old school"
        snap = metrics.snapshot()
        assert snap.get("client.piggyback.fallback", 0) > before
        assert cl._legacy_peers  # the quorum is remembered as legacy
        # subsequent writes skip the probe entirely
        rpcs_before = _client_rpcs(metrics.snapshot())
        cl.write(b"legacy/y", b"still old school")
        d = _delta(_client_rpcs(metrics.snapshot()), rpcs_before)
        assert d.get("write_sign", 0) == 0
        assert cl.read(b"legacy/y") == b"still old school"
    finally:
        c.stop()


def test_piggyback_off_env_uses_classic_rounds(monkeypatch):
    from bftkv_tpu_torch.protocol import client as client_mod

    monkeypatch.setattr(client_mod, "_PIGGYBACK", False)
    c = start_cluster(4, 1, 4, bits=BITS)
    cl = c.clients[0]
    try:
        before = _client_rpcs(metrics.snapshot())
        cl.write(b"off/x", b"classic")
        d = _delta(_client_rpcs(metrics.snapshot()), before)
        assert d.get("write_sign", 0) == 0
        assert d.get("time", 0) >= 1 and d.get("sign", 0) >= 1
        assert cl.read(b"off/x") == b"classic"
    finally:
        c.stop()


def test_ws_ack_codec_roundtrip():
    s, share, t = pkt.parse_ws_ack(pkt.serialize_ws_ack(share=b"abc"))
    assert (s, share, t) == (pkt.WS_ACCEPT, b"abc", 0)
    s, share, t = pkt.parse_ws_ack(pkt.serialize_ws_ack(decline_t=42))
    assert (s, share, t) == (pkt.WS_DECLINE_T, b"", 42)
    s, share, t = pkt.parse_ws_ack(pkt.serialize_ws_ack())
    assert (s, share, t) == (pkt.WS_ACCEPT, b"", 0)
    for bad in (b"", b"\x01", b"\x01short", b"\x02xxxxxxxxx"):
        with pytest.raises(Error):
            pkt.parse_ws_ack(bad)


# -- test_bulk_revoke.py --------------------------------------------
# 256 simulated replicas, f = 85 colluders (BASELINE.md's config 5), batched
# revoke-on-read tally.
# 
# The reference forges the read-response map directly and runs the
# revocation logic with no servers (protocol/revoke_test.go:67-159);
# this is the same pattern at 256 replicas, asserting (a) the honest
# reader still converges on the honestly-quorate value, (b) exactly the
# 85 equivocators are revoked — zero safety violations — and (c) the
# device tally path and the Python scan agree bit-for-bit.

UNIVERSE = 256
F_BYZ = 85
T = 7  # the forged timestamp

HONEST_A = list(range(0, 128))            # honest signers of value A
HONEST_B = list(range(128, 171))          # honest signers of value B (stale)
COLLUDERS = list(range(171, 256))         # signed both values


class _Ref:
    __slots__ = ("id", "name", "address", "active")

    def __init__(self, i):
        self.id = 1_000_000 + i
        self.name = f"r{i:03d}"
        self.address = ""
        self.active = True


class _RecordingTransport:
    def __init__(self):
        self.notified = []

    def multicast(self, cmd, peers, data, cb):
        self.notified.append((cmd, len(peers)))


class _MajorityQuorum:
    """Threshold = an honest-majority bucket (128 of 256)."""

    def is_threshold(self, nodes):
        return len(nodes) >= 128


def _ss_for(signers):
    return SignaturePacket(
        type=SIGNATURE_TYPE_NATIVE,
        version=1,
        completed=True,
        data=serialize_entries(
            [(1_000_000 + i, b"opaque-sig") for i in signers]
        ),
    )


def _forged_map():
    """m[t][value] = [_SignedValue per responding replica]."""
    replicas = [_Ref(i) for i in range(UNIVERSE)]
    ss_a = _ss_for(HONEST_A + COLLUDERS)
    ss_b = _ss_for(HONEST_B + COLLUDERS)
    m = {T: {}}
    m[T][b"value-A"] = [
        _SignedValue(replicas[i], None, ss_a, b"pktA")
        for i in HONEST_A + COLLUDERS
    ]
    m[T][b"value-B"] = [
        _SignedValue(replicas[i], None, ss_b, b"pktB")
        for i in HONEST_B + COLLUDERS
    ]
    return m


def _reader():
    ident = topology.new_identity("reader", key=seeded_key(1024, 900))
    graph = Graph()
    graph.set_self_nodes([ident.cert])
    crypt = new_crypto(ident.key, ident.cert, device=DEVICE)
    tr = _RecordingTransport()
    return Client(graph, WotQS(graph), tr, crypt, device=DEVICE), graph, tr


@pytest.mark.parametrize("batched", [True, False])
def test_bulk_revoke_identifies_exactly_the_colluders(batched):
    client, graph, tr = _reader()
    client.BATCH_REVOKE_THRESHOLD = 1 if batched else 10**9
    m = _forged_map()

    # (a) the honest reader converges on the honestly-quorate value
    value, maxt = client._max_timestamped_value(m, _MajorityQuorum())
    assert (value, maxt) == (b"value-A", T)

    # (b) revocation: exactly the 85 double-signers, nobody honest
    client._revoke_on_read(m)
    revoked = {1_000_000 + i for i in COLLUDERS}
    got = set(graph.revoked)
    assert got == revoked
    assert len(got) == F_BYZ

    # No NOTIFY broadcast here: none of the forged signer ids resolve
    # to known certificates, and only resolvable certs serialize into
    # the revocation list (reference: client.go:341-346 — same
    # property). The graph still blocks them from future quorums.
    assert not tr.notified


def test_batched_and_scan_paths_agree_on_random_overlaps():
    import random

    rng = random.Random(7)
    for _ in range(5):
        rows = [
            {rng.randrange(300) for _ in range(rng.randrange(1, 120))}
            for _ in range(rng.randrange(2, 6))
        ]
        batched = Client._equivocators_batched(rows, device=DEVICE)
        seen: dict[int, int] = {}
        scan = set()
        for rno, row in enumerate(rows):
            for sid in row:
                if sid in seen and seen[sid] != rno:
                    scan.add(sid)
                else:
                    seen.setdefault(sid, rno)
        assert batched == scan


# -- test_protocol_auth.py ------------------------------------------
# TPA roaming + threshold-CA through live servers
# (reference: protocol/roaming_test.go:15-29, dist_test.go:29-105).

@pytest.fixture(scope="module")
def auth_cluster():
    c = start_cluster(n_servers=4, n_users=2, n_rw=4, bits=BITS)
    yield c
    c.stop()


def test_tpa_roundtrip(auth_cluster):
    """First authenticate sets up the shared secret; a later one (the
    'roaming' device) recovers the same cipher key
    (reference: roaming_test.go:15-29)."""
    cli = auth_cluster.clients[0]
    proof, key = cli.authenticate(b"tpa_var", b"correct horse")
    assert proof is not None and key
    proof2, key2 = cli.authenticate(b"tpa_var", b"correct horse")
    assert key2 == key


def test_tpa_wrong_password(auth_cluster):
    cli = auth_cluster.clients[0]
    cli.authenticate(b"tpa_wp", b"right password")
    with pytest.raises(Error):
        cli.authenticate(b"tpa_wp", b"wrong password")


def test_tpa_protected_write_read(auth_cluster):
    """The proof gates reads on servers that hold the auth params —
    the quorum servers, which stored them at setAuth/sign time
    (reference: server.go:181-185; full value secrecy additionally
    comes from API-layer symmetric encryption, api.go:149-163)."""
    from bftkv_tpu_torch import packet as pkt
    from bftkv_tpu_torch.errors import ERR_AUTHENTICATION_FAILURE

    cli = auth_cluster.clients[0]
    proof, _key = cli.authenticate(b"tpa_rw", b"pw1")
    cli.write(b"tpa_rw", b"secret-value", proof=proof)
    assert cli.read(b"tpa_rw", proof=proof) == b"secret-value"
    # A quorum server holds the auth params (stored at setAuth/sign
    # time) and refuses any read of the protected variable without the
    # proof; with the proof it answers (with no completed version —
    # W = U − {Ci} + R keeps completed writes off the clique servers,
    # reference: wotqs.go:108-110).
    srv = auth_cluster.servers[0]
    with pytest.raises(ERR_AUTHENTICATION_FAILURE):
        srv._read(pkt.serialize(b"tpa_rw", None, 0, None, None), None, None)
    raw = srv._read(pkt.serialize(b"tpa_rw", None, 0, None, proof), None, None)
    # The clique never holds a COMPLETED version (W = U − {Ci} + R);
    # since the round collapse it may serve its commit-pending copy —
    # uncertified, so a reader accepts it only through the resolve
    # path.  Either way: no certified record here.
    if raw is not None:
        p = pkt.parse(raw)
        assert p.ss is not None and not p.ss.completed


def test_threshold_rsa_ca(auth_cluster):
    """Distribute an RSA CA key, threshold-sign, verify against the
    public key (reference: dist_test.go:29-105)."""
    cli = auth_cluster.clients[0]
    key = seeded_key(2048, 901)
    cli.distribute("ca-rsa", key)
    tbs = b"an X.509 to-be-signed blob"
    sig = cli.dist_sign("ca-rsa", tbs, ThresholdAlgo.RSA, "sha256")
    assert rsa.verify_host(tbs, sig, key.public)


def test_threshold_dsa_ca(auth_cluster):
    from bftkv_tpu_torch.crypto.threshold import dsa as tdsa

    cli = auth_cluster.clients[0]
    key = tdsa.generate(1024, seed=903)
    cli.distribute("ca-dsa", key)
    tbs = b"dsa signing payload"
    sig = cli.dist_sign("ca-dsa", tbs, ThresholdAlgo.DSA, "sha256")
    # standard DSA verify: v = (g^u1 · y^u2 mod p) mod q == r
    size = (key.q.bit_length() + 7) // 8
    r = int.from_bytes(sig[:size], "big")
    s = int.from_bytes(sig[size:], "big")
    assert 0 < r < key.q and 0 < s < key.q
    ops = tdsa._DSAGroupOps(key.p, key.q, key.g, DEVICE)
    m = ops.os2i(hashlib.sha256(tbs).digest())
    w = pow(s, -1, key.q)
    v = (
        pow(key.g, m * w % key.q, key.p)
        * pow(key.y, r * w % key.q, key.p)
    ) % key.p % key.q
    assert v == r


def test_threshold_ecdsa_ca(auth_cluster):
    pytest.importorskip("cryptography")  # oracle cross-check needs the host lib
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import ec as cec
    from cryptography.hazmat.primitives.asymmetric.utils import (
        encode_dss_signature,
    )

    from bftkv_tpu_torch.crypto import ec
    from bftkv_tpu_torch.crypto.threshold import ecdsa as tec

    cli = auth_cluster.clients[0]
    key = tec.generate(ec.P256, seed=904)
    cli.distribute("ca-ec", key)
    tbs = b"ecdsa signing payload"
    sig = cli.dist_sign("ca-ec", tbs, ThresholdAlgo.ECDSA, "sha256")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    pub = key.curve.scalar_base_mult(key.d)
    pubkey = cec.EllipticCurvePublicNumbers(
        pub[0], pub[1], cec.SECP256R1()
    ).public_key()
    pubkey.verify(encode_dss_signature(r, s), tbs, cec.ECDSA(hashes.SHA256()))




def test_threshold_x509_issuance(auth_cluster):
    """The threshold CA issues a real X.509 certificate: template TBS
    threshold-signed, certificate reassembled, verifiable with the
    standard library against the CA public key
    (reference: cmd/bftrw/bftrw.go:216-302)."""
    import datetime

    pytest.importorskip("cryptography")  # X.509 interop needs the host lib
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import (
        padding as cpadding,
        rsa as crsa,
    )

    from bftkv_tpu_torch.cmd.bftrw import threshold_sign_x509

    cli = auth_cluster.clients[0]
    ca_key = seeded_key(2048, 902)
    cli.distribute("x509-ca", ca_key)

    # Build a template: self-signed leaf with a SubjectKeyId.
    leaf = crsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(x509.NameOID.COMMON_NAME, "leaf")])
    now = datetime.datetime(2026, 1, 1)
    template = (
        x509.CertificateBuilder()
        .subject_name(name)
        .issuer_name(name)
        .public_key(leaf.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(
            x509.SubjectKeyIdentifier.from_public_key(leaf.public_key()),
            critical=False,
        )
        .sign(leaf, hashes.SHA256())
    )

    class _Api:  # the slice of api.API threshold_sign_x509 needs
        def sign(self, caname, tbs, algo, hash_name):
            return cli.dist_sign(caname, tbs, algo, hash_name)

    out_der = threshold_sign_x509(_Api(), "x509-ca", template.public_bytes(
        serialization.Encoding.DER))
    issued = x509.load_der_x509_certificate(out_der)
    assert issued.tbs_certificate_bytes == template.tbs_certificate_bytes
    ca_pub = crsa.RSAPublicNumbers(ca_key.e, ca_key.n).public_key()
    ca_pub.verify(
        issued.signature,
        issued.tbs_certificate_bytes,
        cpadding.PKCS1v15(),
        hashes.SHA256(),
    )


# -- across the packages ----------------------------------------------------


def _homes(uni, root) -> dict:
    """Every principal's home directory, written by the port's topology."""
    paths = {}
    for ident in uni.servers + uni.storage_nodes + uni.users:
        paths[ident.name] = str(root / ident.name)
        topology.save_home(paths[ident.name], ident, uni.view_of(ident))
    return paths


def _ref_node(home, *, http: bool, net=None):
    """A reference ``(graph, crypt, qs, transport)`` from a home."""
    from bftkv_tpu import topology as ref_topology
    from bftkv_tpu.transport.http import TrHTTP as RefHTTP
    from bftkv_tpu.transport.loopback import TrLoopback as RefLoopback

    graph, crypt, qs = ref_topology.load_home(home)
    return graph, crypt, qs, RefHTTP(crypt) if http else RefLoopback(crypt, net)


def _port_node(home, *, http: bool, net=None):
    from bftkv_tpu_torch.transport.http import TrHTTP

    graph, crypt, qs = topology.load_home(home, device=DEVICE)
    return graph, crypt, qs, TrHTTP(crypt) if http else TrLoopback(crypt, net)


def _ref_server(home, storage=None, *, http=True, net=None):
    from bftkv_tpu.protocol.server import Server as RefServer
    from bftkv_tpu.storage.memkv import MemStorage as RefMem

    graph, crypt, qs, tr = _ref_node(home, http=http, net=net)
    return RefServer(graph, qs, tr, crypt, storage if storage is not None else RefMem())


def _port_server(home, storage=None, *, http=True, net=None):
    from bftkv_tpu_torch.storage.memkv import MemStorage

    graph, crypt, qs, tr = _port_node(home, http=http, net=net)
    return Server(graph, qs, tr, crypt, storage if storage is not None else MemStorage(),
                  device=DEVICE)


def _ref_client(home):
    from bftkv_tpu.protocol.client import Client as RefClient

    graph, crypt, qs, tr = _ref_node(home, http=True)
    return RefClient(graph, qs, tr, crypt)


def _port_client(home):
    graph, crypt, qs, tr = _port_node(home, http=True)
    return Client(graph, qs, tr, crypt, device=DEVICE)


class _RecordingServer(Server):
    """A port server that records every plaintext frame its handlers get,
    as ``(cmd, frame, sender id)`` in arrival order."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.frames = []
        for cmd, name in self._handlers.items():
            setattr(self, name, self._recorder(cmd, getattr(self, name)))

    def _recorder(self, cmd, run):
        def record(req, peer, sender):
            self.frames.append((cmd, bytes(req), sender.id))
            return run(req, peer, sender)
        return record


def _answer(srv, cmd, frame, sender_id):
    """One plaintext frame through ``srv``'s handler: the reply bytes, or
    the error's message."""
    peer = srv.crypt.keyring.get(sender_id)
    try:
        return getattr(srv, srv._handlers[cmd])(frame, peer, peer) or b""
    except Exception as e:  # the error crosses the wire as its message
        return "error: " + str(e)


def test_handler_bytes_equal_across_the_packages(tmp_path, monkeypatch):
    """The frames a port client's writes and reads put on the wire, replayed
    in order into a reference ``Server`` and a port ``Server`` built from
    the same home on empty stores, give the same bytes; so do hostile
    frames.  The frames cover TIME, READ, SIGN, WRITE (classic rounds),
    WRITE_SIGN and its BATCH_WRITE back-fill, and BATCH_TIME, BATCH_SIGN,
    BATCH_WRITE and BATCH_READ."""
    from bftkv_tpu.crypto import vcache as ref_vcache
    from bftkv_tpu_torch.protocol import client as client_mod

    c = start_cluster(4, 1, 4, server_cls=_RecordingServer)
    try:
        cl = c.clients[0]
        cl.write(b"hb/single", b"collapsed")
        cl.drain_tails()
        assert cl.read(b"hb/single") == b"collapsed"
        with monkeypatch.context() as m:
            m.setattr(client_mod, "_PIGGYBACK", False)
            cl.write(b"hb/classic", b"three rounds")
        assert cl.write_many([(b"hb/b%d" % i, b"bv%d" % i) for i in range(4)]) == [None] * 4
        cl.drain_tails()
        assert cl.read_many([b"hb/b0", b"hb/b3", b"hb/none"]) == [b"bv0", b"bv3", None]
        cl.drain_tails()
        homes = _homes(c.universe, tmp_path)
        recorded = {s.self_node.name: s.frames for s in c.all_servers}
    finally:
        c.stop()

    seen = set()
    for name in ("a01", "rw01"):
        frames = list(recorded[name])
        seen |= {cmd for cmd, _, _ in frames}
        sender = frames[-1][2]
        frames += [
            (tp.READ, pkt.serialize(b"!!!secret!!!x", None, 0), sender),
            (tp.WRITE, frames[0][1][:7], sender),
            (tp.BATCH_SIGN, b"\xff\xff\xff\x7f" + b"\x00" * 8, sender),
            (tp.BATCH_READ, b"\x00\x00\x00\x09abc", sender),
            (tp.SIGN, b"", sender),
        ]
        vcache.reset()
        ref_vcache.reset()
        ref, port = _ref_server(homes[name], http=False), _port_server(homes[name], http=False)
        replies = errors = 0
        for cmd, frame, sid in frames:
            want = _answer(ref, cmd, frame, sid)
            got = _answer(port, cmd, frame, sid)
            assert got == want, (name, tp.COMMAND_NAMES[cmd], got, want)
            replies += isinstance(want, bytes) and len(want) > 0
            errors += isinstance(want, str)
        assert replies >= 8 and errors >= 5, (name, replies, errors)
        assert sorted(port.storage.scan()) == sorted(ref.storage.scan())
    assert {tp.TIME, tp.READ, tp.SIGN, tp.WRITE, tp.WRITE_SIGN, tp.BATCH_TIME,
            tp.BATCH_SIGN, tp.BATCH_WRITE, tp.BATCH_READ} <= seen


def test_http_writes_cross_the_packages(tmp_path):
    """Over localhost HTTP: a port client writes through a reference
    cluster and the reference client reads it back; a reference client
    writes through a port cluster and the port client reads it back;
    then one cluster of two servers of each package serves both."""
    from test_torch_utils import build_universe

    uni = build_universe(4, 1, 4, transport="http")
    homes = _homes(uni, tmp_path)
    names = [i.name for i in uni.servers + uni.storage_nodes]
    user = homes[uni.users[0].name]

    def run(make):  # make(i, name) -> a started-able server
        servers = [make(i, n) for i, n in enumerate(names)]
        for s in servers:
            s.start()
        return servers

    def stop(servers):
        for s in servers:
            s.tr.stop()

    # Reference cluster, port writer, reference reader.
    servers = run(lambda i, n: _ref_server(homes[n]))
    try:
        pc, rc = _port_client(user), _ref_client(user)
        pc.write(b"x/port", b"from the port")
        assert pc.write_many([(b"x/pm%d" % i, b"pm%d" % i) for i in range(3)]) == [None] * 3
        pc.drain_tails()
        assert rc.read(b"x/port") == b"from the port"
        assert rc.read_many([b"x/pm%d" % i for i in range(3)]) == [b"pm%d" % i for i in range(3)]
        ref_stores = [s.storage for s in servers]
    finally:
        stop(servers)

    # Port cluster on the reference servers' records: what they stored
    # serves the port's servers; a reference writer, a port reader.
    def port_store(ref_store):
        from bftkv_tpu_torch.storage.memkv import MemStorage

        st = MemStorage()
        for var, t in ref_store.scan():
            st.write(var, t, ref_store.read(var, t))
        return st

    servers = run(lambda i, n: _port_server(homes[n], port_store(ref_stores[i])))
    try:
        pc, rc = _port_client(user), _ref_client(user)
        assert pc.read(b"x/port") == b"from the port"
        rc.write(b"x/ref", b"from the reference")
        rc.drain_tails()
        assert pc.read(b"x/ref") == b"from the reference"
        assert pc.read_many([b"x/pm0", b"x/ref"]) == [b"pm0", b"from the reference"]
        port_stores = [s.storage for s in servers]
    finally:
        stop(servers)

    # Mixed: the first two of each plane are reference servers on the
    # port servers' records, the others port servers.
    def ref_store(st):
        from bftkv_tpu.storage.memkv import MemStorage as RefMem

        out = RefMem()
        for var, t in st.scan():
            out.write(var, t, st.read(var, t))
        return out

    def mixed(i, n):
        if i % 4 < 2:
            return _ref_server(homes[n], ref_store(port_stores[i]))
        return _port_server(homes[n], port_stores[i])

    servers = run(mixed)
    try:
        pc, rc = _port_client(user), _ref_client(user)
        assert rc.read(b"x/ref") == b"from the reference"
        pc.write(b"x/mixed", b"p")
        pc.drain_tails()
        assert rc.read(b"x/mixed") == b"p"
        rc.write(b"x/mixed", b"r")
        rc.drain_tails()
        assert pc.read(b"x/mixed") == b"r"
        assert rc.write_many([(b"x/rm%d" % i, b"r%d" % i) for i in range(3)]) == [None] * 3
        rc.drain_tails()
        assert pc.read_many([b"x/rm%d" % i for i in range(3)]) == [b"r%d" % i for i in range(3)]
    finally:
        stop(servers)


def test_batched_equivocation_mask_equals_the_reference():
    """The port's unpadded mask (one reduction on the client's device)
    names the same signers as the reference's power-of-two padded jit, on
    seeded rows; at and past ``BATCH_REVOKE_THRESHOLD`` entries too."""
    import random

    from bftkv_tpu.protocol.client import Client as RefClient

    rng = random.Random(11)
    for nrows, width in ((2, 40), (3, 300), (5, 700), (9, 1000)):
        rows = [
            {rng.randrange(width) for _ in range(rng.randrange(1, width))}
            for _ in range(nrows)
        ]
        got = Client._equivocators_batched(rows, device=DEVICE)
        assert got == RefClient._equivocators_batched(rows)


# -- regions on the port's cluster (tests/test_regions.py's cluster and -----
# -- gray-baseline cases) ----------------------------------------------------


@pytest.fixture()
def wan_cluster():
    # The health singletons are process-global: scrub signals earlier
    # tests may have left on the same loop:// addresses.
    tp.peer_latency.reset()
    tp.peer_health.reset()
    c = start_cluster(4, 1, 4, n_regions=3)
    yield c
    c.stop()
    tp.peer_latency.reset()
    tp.peer_health.reset()


def _rtt():
    from bftkv_tpu_torch import regions as rg
    from bftkv_tpu_torch.regions.topology import RttMatrix

    rg.regionmap.set_rtt(RttMatrix.parse("20/80/150", rg.regionmap.regions()))
    return rg


def test_rank_nodes_puts_same_region_first_and_orders_by_rtt(wan_cluster):
    cl = wan_cluster.clients[0]  # u01 → r0
    qa = qm.choose_quorum_for(cl.qs, b"regions/x", qm.AUTH | qm.PEER)
    rg = _rtt()
    order = [rg.region_of(n.name) for n in cl._rank_nodes(qa.nodes())]
    n_same = order.count("r0")
    assert n_same >= 1
    assert all(r == "r0" for r in order[:n_same])
    assert order[n_same:] == ["r1", "r2"]


def test_ranking_is_a_permutation_and_never_changes_thresholds(wan_cluster):
    cl = wan_cluster.clients[0]
    qa = qm.choose_quorum_for(cl.qs, b"regions/y", qm.AUTH | qm.PEER)
    nodes = qa.nodes()
    _rtt()
    ranked = cl._rank_nodes(nodes)
    assert sorted(n.id for n in ranked) == sorted(n.id for n in nodes)
    assert qa.is_threshold(ranked) == qa.is_threshold(nodes)
    assert qa.is_sufficient(ranked) == qa.is_sufficient(nodes)
    for k in range(1, len(ranked) + 1):
        prefix = ranked[:k]
        shuffled = sorted(prefix, key=lambda n: n.id)
        assert qa.is_sufficient(prefix) == qa.is_sufficient(shuffled)
        assert qa.is_threshold(prefix) == qa.is_threshold(shuffled)


def test_cross_region_members_ride_the_hedge_wave_not_the_prefix(wan_cluster):
    from bftkv_tpu_torch.protocol.client import _staged_wave

    cl = wan_cluster.clients[0]
    qa = qm.choose_quorum_for(cl.qs, b"regions/z", qm.AUTH | qm.PEER)
    rg = _rtt()
    wave1, rest = _staged_wave(qa, cl._rank_nodes(qa.nodes()))
    assert qa.is_sufficient(wave1)
    assert not qa.is_sufficient(wave1[:-1])  # minimal, not padded
    assert all(rg.region_of(n.name) != "r2" for n in wave1)
    assert [rg.region_of(n.name) for n in rest] == ["r2"]


def test_rank_nodes_region_axis_gated_by_flag(wan_cluster, monkeypatch):
    monkeypatch.setenv("BFTKV_REGION_RANK", "off")
    cl = wan_cluster.clients[0]
    qa = qm.choose_quorum_for(cl.qs, b"regions/g", qm.AUTH | qm.PEER)
    _rtt()
    nodes = qa.nodes()
    assert [n.id for n in cl._rank_nodes(nodes)] == [n.id for n in nodes]


def test_regioned_cluster_writes_and_reads(wan_cluster):
    cl = wan_cluster.clients[0]
    _rtt()
    cl.write(b"regions/w", b"geo")
    assert cl.read(b"regions/w") == b"geo"


def test_fleet_baseline_compares_within_region_class_only():
    from bftkv_tpu_torch import regions as rg
    from bftkv_tpu_torch.transport.latency import PeerLatency

    rg.install({"a": "r0", "b": "r0", "c": "r0", "z": "r1", "d": "r0"})
    try:
        pl = PeerLatency()
        for _ in range(6):
            for near in ("a", "b", "c"):
                pl.record(near, 0.010)
        for _ in range(6):
            pl.record("z", 1.0)
        assert not pl.is_gray("z")
        for _ in range(6):
            pl.record("d", 1.0)
        assert pl.is_gray("d")
    finally:
        rg.clear()


def test_fleet_baseline_unchanged_without_region_map():
    from bftkv_tpu_torch import regions as rg
    from bftkv_tpu_torch.transport.latency import PeerLatency

    rg.clear()
    pl = PeerLatency()
    for _ in range(6):
        for near in ("a", "b", "c"):
            pl.record(near, 0.010)
    for _ in range(6):
        pl.record("z", 1.0)
    assert pl.is_gray("z")


# -- the stale-route reroute (tests/test_route_epoch.py) ---------------------


def test_stale_client_reroutes_in_round():
    from bftkv_tpu_torch.quorum.wotqs import RouteTable, route_bucket

    cluster = start_cluster(4, 2, 4, n_shards=2)
    try:
        fresh, stale = cluster.clients
        qs = fresh.qs
        x = None
        i = 0
        while x is None:
            c = b"flap/%d" % i
            i += 1
            if qs.shard_of(c) == 0:
                x = c
        stale.write(x, b"v0")
        stale.drain_tails()
        # An abrupt flip to shard 1 delivered to everyone except `stale`.
        rt = None
        for principal in cluster.all_servers + [fresh]:
            pq = principal.qs
            if rt is None:
                table = list(pq.effective_route())
                table[route_bucket(x)] = 1
                rt = RouteTable(1, pq.route_cliques(), table, {}, set())
            assert pq.install_route_table(rt)
        metrics.reset()
        stale.write(x, b"v1")  # declines at the old owner, re-routes
        stale.drain_tails()
        snap = metrics.snapshot()
        assert sum(v for k, v in snap.items() if k.startswith("server.epoch_stale")) > 0
        assert snap.get("client.route.rerouted", 0) > 0
        assert stale.qs.shard_of(x) == 1  # hint adopted
        assert fresh.read(x) == b"v1"
    finally:
        cluster.stop()
