"""The port's edge gateway tier (``bftkv_tpu_torch/gateway``) against the
reference's cases (``tests/test_gateway.py``) on port clusters on the cpu:
certified cache soundness, coalescing, shedding, invalidation and
horizontal stacking; a reference and a port ``Gateway`` of one home answer
the same front-door frames with the same bytes; ``run_gateway`` serves a
port cluster as a process.

The load-bearing assertions are the soundness ones: a poisoned fill —
bytes whose collective signature does not verify against the OWNER
quorum, whether tampered or minted by the wrong shard's clique — is
never cached, never served, and counted; and the GatewayClient refuses
served bytes it cannot verify itself.
"""

import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch import topology
from bftkv_tpu_torch.errors import (
    ERR_GATEWAY_OVERLOADED,
    ERR_UNCERTIFIED_RECORD,
)
from bftkv_tpu_torch.gateway import CertifiedCache, GatewayClient
from bftkv_tpu_torch.metrics import registry as metrics

from test_torch_utils import DEVICE, free_port_block, start_cluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster():
    cl = start_cluster(4, 1, 4, n_gateways=2)
    yield cl
    cl.stop()


@pytest.fixture()
def gwc(cluster):
    return cluster.gateway_client(0)


def snap(name: str) -> float:
    return metrics.snapshot().get(name, 0)


# -- cache unit behavior ----------------------------------------------------


def test_cache_newer_t_wins_and_ttl():
    c = CertifiedCache(max_entries=8, ttl=0.05)
    assert c.put(b"x", 3, b"rec3")
    assert not c.put(b"x", 2, b"rec2")  # stale fill loses
    assert c.get(b"x").record == b"rec3"
    assert c.put(b"x", 4, b"rec4")
    time.sleep(0.06)
    assert c.get(b"x") is None  # expired
    assert c.get(b"x", allow_stale=True).record == b"rec4"


def test_cache_lru_bound_and_bucket_invalidation():
    c = CertifiedCache(max_entries=2, ttl=60)
    c.put(b"a", 1, b"ra")
    c.put(b"b", 1, b"rb")
    c.put(b"c", 1, b"rc")  # evicts a (LRU)
    assert c.get(b"a") is None
    assert len(c) == 2
    from bftkv_tpu_torch.sync.digest import bucket_of

    assert c.invalidate_bucket(bucket_of(b"b")) >= 1
    assert c.get(b"b") is None


# -- read-through + write path ---------------------------------------------


def test_certified_read_through_and_hit(cluster, gwc):
    c = cluster.clients[0]
    c.write(b"gwt/direct", b"v1")
    c.drain_tails()
    h0, m0 = snap("gateway.cache.hits"), snap("gateway.cache.misses")
    assert gwc.read(b"gwt/direct") == b"v1"  # fill (miss)
    assert gwc.read(b"gwt/direct") == b"v1"  # cache hit
    assert snap("gateway.cache.misses") == m0 + 1
    assert snap("gateway.cache.hits") == h0 + 1


def test_absent_key_not_cached(gwc):
    assert gwc.read(b"gwt/never-written") is None
    assert gwc.read(b"gwt/never-written") is None


def test_write_through_and_invalidation_on_backfill(cluster, gwc):
    """A gateway write invalidates the stale entry and the certified
    back-fill re-fills the cache — the subsequent read is a HIT on the
    new value, no quorum fill."""
    gwc.write(b"gwt/w", b"old")
    assert gwc.read(b"gwt/w") == b"old"
    f0 = snap("gateway.cache.fills")
    b0 = snap("gateway.cache.backfill_puts")
    gwc.write(b"gwt/w", b"new")
    assert snap("gateway.cache.backfill_puts") > b0
    assert gwc.read(b"gwt/w") == b"new"
    assert snap("gateway.cache.fills") == f0  # served from write-through


def test_same_variable_burst_coalesces(cluster, gwc):
    c0 = snap("gateway.write.coalesced")
    ws0 = snap("server.write_sign.count")
    errs: list = []

    def w(i):
        try:
            gwc.write(b"gwt/burst", b"b%d" % i)
        except Exception as e:  # pragma: no cover - surfaced below
            errs.append(e)

    ts = [threading.Thread(target=w, args=(i,)) for i in range(10)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    coalesced = snap("gateway.write.coalesced") - c0
    assert coalesced >= 1
    # The burst cost fewer WRITE_SIGN fan-outs than callers: at most
    # (callers - coalesced) rounds × quorum size posts crossed servers.
    got = gwc.read(b"gwt/burst")
    assert got is not None and got.startswith(b"b")
    assert snap("server.write_sign.count") - ws0 <= (10 - coalesced) * 8


def test_cross_variable_burst_batches(cluster, gwc):
    r0 = snap("gateway.write.batched_rounds")
    errs: list = []

    def w(i):
        try:
            gwc.write(b"gwt/multi/%d" % i, b"m%d" % i)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    ts = [threading.Thread(target=w, args=(i,)) for i in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    for i in range(6):
        assert gwc.read(b"gwt/multi/%d" % i) == b"m%d" % i
    assert snap("gateway.write.batched_rounds") > r0


# -- admission / shedding ---------------------------------------------------


def test_shed_path(cluster, gwc):
    gw = cluster.gateways[0]
    old = (gw.admission.max_inflight, gw.admission.max_queue)
    s0 = snap("gateway.shed{op=read}")
    gw.admission.max_inflight = 0
    gw.admission.max_queue = 0
    try:
        # Both gateways must shed or the HRW failover masks the test.
        for g in cluster.gateways:
            g.admission.max_inflight = 0
            g.admission.max_queue = 0
        with pytest.raises(ERR_GATEWAY_OVERLOADED):
            gwc.read(b"gwt/shed-me")
    finally:
        for g in cluster.gateways:
            g.admission.max_inflight, g.admission.max_queue = old
    assert snap("gateway.shed{op=read}") > s0
    # Cache hits bypass admission entirely.
    gwc.write(b"gwt/shed-hit", b"v")
    assert gwc.read(b"gwt/shed-hit") == b"v"
    for g in cluster.gateways:
        g.admission.max_inflight = 0
        g.admission.max_queue = 0
    try:
        assert gwc.read(b"gwt/shed-hit") == b"v"
    finally:
        for g in cluster.gateways:
            g.admission.max_inflight, g.admission.max_queue = old


# -- cache soundness: poisoned fills ---------------------------------------


def test_poisoned_fill_never_served(cluster, gwc, monkeypatch):
    """A fill whose bytes were tampered with (value flipped, signature
    kept) must fail the gateway's owner-quorum verification: counted,
    never cached, never served."""
    gw = cluster.gateways[0]
    c = cluster.clients[0]
    c.write(b"gwt/poison", b"honest")
    c.drain_tails()
    value, t, record = gw.client.read_certified(b"gwt/poison")
    assert value == b"honest" and record is not None
    p = pkt.parse(record)
    forged = pkt.serialize(
        p.variable, b"FORGED!", p.t, p.sig, p.ss, p.auth
    )

    for g in cluster.gateways:
        monkeypatch.setattr(
            g.client,
            "read_certified",
            lambda variable, proof=None: (b"FORGED!", t, forged),
        )
    v0 = snap("gateway.cache.verify_fail")
    with pytest.raises(ERR_UNCERTIFIED_RECORD):
        gwc.read(b"gwt/poison")
    assert snap("gateway.cache.verify_fail") > v0
    assert gw.cache.get(b"gwt/poison") is None
    monkeypatch.undo()
    assert gwc.read(b"gwt/poison") == b"honest"


def test_poisoned_backfill_never_cached(cluster):
    """The write-through (on_certified) plane crosses the same gate."""
    gw = cluster.gateways[0]
    v0 = snap("gateway.cache.verify_fail")
    gw._on_certified(b"gwt/bogus", b"\x00garbage-not-a-record")
    assert snap("gateway.cache.verify_fail") > v0
    assert gw.cache.get(b"gwt/bogus") is None


def test_client_side_verification(cluster, gwc):
    """Even a compromised gateway cannot forge a read: the
    GatewayClient re-verifies the served record itself."""
    c = cluster.clients[0]
    c.write(b"gwt/cliver", b"real")
    c.drain_tails()
    _v, _t, raw = gwc.read_record(b"gwt/cliver")
    p = pkt.parse(raw)
    forged = pkt.serialize(p.variable, b"evil", p.t, p.sig, p.ss)
    with pytest.raises(ERR_UNCERTIFIED_RECORD):
        gwc._check_served(b"gwt/cliver", forged)
    # and a record for ANOTHER variable is rejected by name binding
    with pytest.raises(ERR_UNCERTIFIED_RECORD):
        gwc._check_served(b"gwt/other", raw)


def test_wrong_quorum_signature_rejected():
    """A collective signature minted by a clique that does NOT own the
    variable is unusable: the certified-fill rule verifies against the
    owner quorum, where foreign signers can never reach sufficiency."""
    cl = start_cluster(4, 1, 4, n_shards=2, n_gateways=1)
    try:
        gw = cl.gateways[0]
        c = cl.clients[0]
        shard_of = c.qs.shard_of
        # a variable owned by shard 0, and shard 1's servers
        var = next(
            b"gwt/wq/%d" % i
            for i in range(4096)
            if shard_of(b"gwt/wq/%d" % i) == 0
        )
        foreign = [
            s for s in cl.servers if s.qs.my_shard() == 1
        ]
        assert foreign
        # Forge: writer-sign <x,v,t> as the user, then collect a
        # "collective" signature from the WRONG clique's signers.
        tbs = pkt.serialize(var, b"squat", 1, nfields=3)
        sig = c.crypt.signer.issue(tbs)
        tbss = pkt.serialize(var, b"squat", 1, sig, nfields=4)
        from bftkv_tpu_torch.crypto import signature as sigmod

        entries = []
        for s in foreign:
            share = s.crypt.collective.sign(s.crypt.signer, tbss)
            entries.extend(sigmod.parse_entries(share.data))
        ss = pkt.SignaturePacket(
            type=pkt.SIGNATURE_TYPE_NATIVE,
            version=1,
            completed=True,
            data=sigmod.serialize_entries(entries),
        )
        forged = pkt.serialize(var, b"squat", 1, sig, ss)
        v0 = snap("gateway.cache.verify_fail")
        with pytest.raises(ERR_UNCERTIFIED_RECORD):
            gw._verify_certified(var, forged)
        assert snap("gateway.cache.verify_fail") > v0
        # Sanity — the same shares DO satisfy the minting clique's own
        # sufficiency, so the rejection above is quorum BINDING (the
        # owner clique's threshold), not malformedness.
        foreign_var = next(
            b"gwt/wq/%d" % i
            for i in range(4096)
            if shard_of(b"gwt/wq/%d" % i) == 1
        )
        qa1 = qm.choose_quorum_for(gw.qs, foreign_var, qm.AUTH)
        signers = [
            gw.crypt.keyring.get(sid)
            for sid, _sb in sigmod.parse_entries(ss.data)
        ]
        assert qa1.is_sufficient([s for s in signers if s is not None])
    finally:
        cl.stop()


# -- anti-entropy invalidation ---------------------------------------------


def test_sync_invalidation(cluster, gwc):
    # The entry lives on the HRW-primary gateway for this variable.
    primary_id = gwc._route(b"gwt/sync")[0].id
    gw = next(
        g
        for g in cluster.gateways
        if g.self_node.get_self_id() == primary_id
    )
    c = cluster.clients[0]
    c.write(b"gwt/sync", b"old")
    c.drain_tails()
    assert gwc.read(b"gwt/sync") == b"old"
    gw.sync_invalidate_round()  # baseline digests
    c.write(b"gwt/sync", b"new")
    c.drain_tails()
    # TTL has not lapsed: without the sync plane this read is stale.
    assert gwc.read(b"gwt/sync") == b"old"
    i0 = snap("gateway.cache.sync_invalidated")
    assert gw.sync_invalidate_round() >= 1
    assert snap("gateway.cache.sync_invalidated") > i0
    assert gwc.read(b"gwt/sync") == b"new"


# -- horizontal stacking ----------------------------------------------------


def test_hrw_routing_is_sticky(cluster, gwc):
    order1 = [g.id for g in gwc._route(b"gwt/route-x")]
    order2 = [g.id for g in gwc._route(b"gwt/route-x")]
    assert order1 == order2
    assert len(set(order1)) == 2
    # different variables spread across gateways
    firsts = {gwc._route(b"gwt/route-%d" % i)[0].id for i in range(32)}
    assert len(firsts) == 2


def test_gateway_failover(cluster):
    """A dead gateway is routed around — the tier is stateless."""
    gwc = cluster.gateway_client(0)
    gwc.write(b"gwt/fo", b"v")
    primary_id = gwc._route(b"gwt/fo")[0].id
    primary = next(
        g
        for g in cluster.gateways
        if g.self_node.get_self_id() == primary_id
    )
    primary.tr.stop()
    try:
        f0 = snap("gateway.client.failover")
        assert gwc.read(b"gwt/fo") == b"v"
        assert snap("gateway.client.failover") > f0
    finally:
        primary.start(primary.address)


# -- observability sources ----------------------------------------------


def test_local_sources_read_the_gateways(cluster, gwc):
    """What the fleet collector reads of each member (``obs.source``; the
    collector itself is not ported yet): gateways report role=gateway and
    their own cache and shed counts, servers their clique seat, and a
    shed shows in the gateway's count and the process counter."""
    from bftkv_tpu_torch.obs import LocalSource

    sources = [LocalSource(s.self_node.name, lambda s=s: s) for s in cluster.all_servers]
    sources += [LocalSource(gw.self_node.name, lambda gw=gw: gw) for gw in cluster.gateways]
    before = {gw.self_node.name: gw.admission.shed for gw in cluster.gateways}
    s0 = snap("gateway.shed{op=read}")
    for g in cluster.gateways:
        g.admission.max_inflight = 0
        g.admission.max_queue = 0
    try:
        with pytest.raises(ERR_GATEWAY_OVERLOADED):
            gwc.read(b"gwt/fleet-shed")
    finally:
        for g in cluster.gateways:
            g.admission.max_inflight = 64
            g.admission.max_queue = 128
    assert snap("gateway.shed{op=read}") > s0
    docs = {src.name: src.info() for src in sources}
    assert all(src.probe() for src in sources)
    gws = {n: d for n, d in docs.items() if d["role"] == "gateway"}
    assert set(gws) == {"gw01", "gw02"}
    assert sum(d["gateway"]["shed"] - before[n] for n, d in gws.items()) >= 1
    for n, d in docs.items():
        if n.startswith("a"):
            assert d["role"] == "clique" and d["shard"] == 0, d
            assert not set(d["clique"]["members"]) & {"gw01", "gw02"}
        elif n not in gws:  # storage-only rw nodes hold no clique seat
            assert d["role"] is None and d["clique"] is None, d


# -- across the packages --------------------------------------------------


def _gw_home(uni, root, i=0):
    ident = uni.gateways[i]
    home = str(root / ident.name)
    topology.save_home(home, ident, uni.view_of(ident))
    return home


def _answer(gw, run, frame):
    try:
        return run(frame, None) or b""
    except Exception as e:  # the error crosses the wire as its message
        return "error: " + str(e)


def test_gateway_frames_bytes_equal_across_the_packages(tmp_path):
    """A reference ``Gateway`` and a port ``Gateway`` built from the same
    gateway home, in front of one port cluster on localhost HTTP, answer
    the same plaintext GW_READ frames with the same bytes (certified fills,
    cache hits, an absent key, a hidden variable, garbage), and each
    serves what the other wrote through GW_WRITE."""
    from bftkv_tpu import topology as ref_topology
    from bftkv_tpu.gateway import Gateway as RefGateway
    from bftkv_tpu.transport.http import TrHTTP as RefHTTP
    from bftkv_tpu_torch.gateway import Gateway
    from bftkv_tpu_torch.transport.http import TrHTTP

    cl = start_cluster(4, 1, 4, transport="http", n_gateways=1)
    ref = port = None
    try:
        c = cl.clients[0]
        for i in range(3):
            c.write(b"gwx/%d" % i, b"value-%d" % i)
        c.drain_tails()
        home = _gw_home(cl.universe, tmp_path)
        g, cr, q = ref_topology.load_home(home)
        ref = RefGateway(g, q, RefHTTP(cr), cr)
        g, cr, q = topology.load_home(home, device=DEVICE)
        port = Gateway(g, q, TrHTTP(cr), cr, device=DEVICE)
        frames = [pkt.serialize(b"gwx/%d" % i, None, 0, None, None) for i in range(3)] * 2
        frames += [
            pkt.serialize(b"gwx/none", None, 0, None, None),
            pkt.serialize(b"!!!secret!!!x", None, 0, None, None),
            b"\x00\x00\x00\x09abc",
            b"",
        ]
        got = [_answer(port, port._gw_read, f) for f in frames]
        want = [_answer(ref, ref._gw_read, f) for f in frames]
        assert got == want
        assert all(isinstance(x, bytes) and pkt.parse(x).value == b"value-%d" % (i % 3)
                   for i, x in enumerate(got[:6]))
        assert got[6] == b"" and all(isinstance(x, str) for x in got[7:])
        # Writes through either package's gateway read back through the other.
        assert _answer(ref, ref._gw_write, pkt.serialize(b"gwx/by-ref", b"r", 0, None, None)) == b""
        assert _answer(port, port._gw_write, pkt.serialize(b"gwx/by-port", b"p", 0, None, None)) == b""
        assert port.read_value(b"gwx/by-ref") == b"r"
        assert ref.read_value(b"gwx/by-port") == b"p"
    finally:
        for gw in (ref, port):
            if gw is not None:
                gw.stop()
        cl.stop()


# -- the process ----------------------------------------------------------


def test_run_gateway_process_serves_a_port_cluster(tmp_path):
    """``python -m bftkv_tpu_torch.cmd.run_gateway --device cpu`` in front of
    a port cluster on localhost HTTP: its operator API reads what a client
    wrote (a certified fill, then a cache hit) and writes through the
    quorum; ``/info`` is role=gateway."""
    import json

    cl = start_cluster(4, 1, 4, transport="http", n_gateways=1)
    cl.gateways.pop().stop()  # the process serves gw01's address instead
    proc = None
    try:
        c = cl.clients[0]
        c.write(b"gwp/x", b"through the process")
        c.drain_tails()
        home = _gw_home(cl.universe, tmp_path)
        with open(os.path.join(home, "address"), "w") as f:
            f.write(cl.universe.gateway_addrs["gw01"] + "\n")
        api = free_port_block(1)
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.Popen(
            [sys.executable, "-m", "bftkv_tpu_torch.cmd.run_gateway", "--home", home,
             "--api", f"127.0.0.1:{api}", "--sync-invalidate", "0", "--device", "cpu"],
            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        base = f"http://127.0.0.1:{api}"
        deadline = time.monotonic() + 120
        while True:
            try:
                with urllib.request.urlopen(base + "/info", timeout=5) as res:
                    info = json.loads(res.read())
                break
            except OSError:
                assert proc.poll() is None, proc.stdout.read().decode()
                assert time.monotonic() < deadline, "run_gateway never served its API"
                time.sleep(0.3)
        assert info["role"] == "gateway" and info["name"] == "gw01"
        for _ in range(2):
            with urllib.request.urlopen(base + "/read/gwp/x", timeout=60) as res:
                assert res.read() == b"through the process"
        req = urllib.request.Request(base + "/write/gwp/y", data=b"via gw", method="POST")
        with urllib.request.urlopen(req, timeout=60) as res:
            assert res.status == 200
        assert c.read(b"gwp/y") == b"via gw"
        with urllib.request.urlopen(base + "/info", timeout=5) as res:
            stats = json.loads(res.read())["gateway"]
        assert stats["misses"] >= 1 and stats["hits"] >= 1, stats
    finally:
        if proc is not None:
            proc.terminate()
            proc.wait(timeout=30)
        cl.stop()
