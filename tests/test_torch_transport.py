"""The port's transport layer against the reference's cases and the
reference itself: loopback multicast (fan-in, early stop, errors), the
per-peer latency tracker fed the same samples as the reference's, HTTP
requests and their error mapping, and ``tests/test_presession.py``,
``test_session_bounds.py`` and ``test_http_cluster.py`` rewritten against
port clusters on the cpu (1024-bit seeded keys).
"""

from __future__ import annotations

import math
import random
import threading

import pytest

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import rsa, vcache
from bftkv_tpu_torch.crypto.message import MessageSecurity
from bftkv_tpu_torch.crypto.presession import MAX_UINT64, Presession
from bftkv_tpu_torch.errors import Error
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import dispatch, modexp
from bftkv_tpu_torch.transport.http import TrHTTP
from bftkv_tpu_torch.transport.latency import PeerLatency
from bftkv_tpu_torch.transport.loopback import ERR_UNREACHABLE, TrLoopback

from test_torch_utils import BITS, DEVICE, seeded_key, start_cluster


@pytest.fixture(autouse=True)
def _host_modexp(monkeypatch):
    """The TPA modexps on host ``pow`` (the plain K2 batch of the 2048-bit
    TPA group takes seconds on a CPU)."""
    monkeypatch.setattr(modexp.BatchModExp, "_shared",
                        {modexp.devmod.resolve(DEVICE): modexp.BatchModExp(min_batch=10**9, device=DEVICE)})


@pytest.fixture(scope="module")
def loop_cluster():
    c = start_cluster(4, 1, 4)
    yield c
    c.stop()


# -- loopback multicast ------------------------------------------------------


def _time_frame(var: bytes) -> bytes:
    return pkt.serialize(var, None, 0)


def test_multicast_fans_in_every_response(loop_cluster):
    cl = loop_cluster.clients[0]
    peers = [cl.crypt.keyring.get(s.self_node.get_self_id()) for s in loop_cluster.servers]
    got = []
    tp.multicast(cl.tr, tp.TIME, peers, [_time_frame(b"mc/x")], lambda r: got.append(r) or False)
    assert sorted(r.peer.id for r in got) == sorted(p.id for p in peers)
    assert all(r.err is None for r in got)


def test_multicast_callback_stops_the_fan_in(loop_cluster):
    cl = loop_cluster.clients[0]
    peers = [cl.crypt.keyring.get(s.self_node.get_self_id()) for s in loop_cluster.all_servers]
    got = []
    tp.multicast(cl.tr, tp.TIME, peers, [_time_frame(b"mc/y")], lambda r: got.append(r) or True)
    assert len(got) == 1


def test_multicast_reports_unreachable_and_handler_errors(loop_cluster):
    cl = loop_cluster.clients[0]
    live = cl.crypt.keyring.get(loop_cluster.servers[0].self_node.get_self_id())
    key = seeded_key(BITS, 970)
    ghost = certmod.Certificate(n=key.n, e=key.e, name="ghost", address="loop://ghost")
    got = {}

    def cb(r):
        got[r.peer.name] = r
        return False

    # The ghost has no server on the net; the live server refuses a SIGN
    # frame that does not parse.
    tp.multicast(cl.tr, tp.SIGN, [live, ghost], [b"\x00garbage"], cb)
    assert isinstance(got["ghost"].err, ERR_UNREACHABLE)
    assert isinstance(got[live.name].err, Error)
    assert got[live.name].data is None or got[live.name].data == b""


def test_inline_fanout_rule_follows_the_calibration(monkeypatch):
    """On the cpu the dispatchers' calibration pins the host tier, so the
    loopback fan-out may run inline; a dispatcher that does not prefer the
    host (a card) sends it to the threaded fan-out."""
    monkeypatch.setattr(tp, "_INLINE_FANOUT", "auto")
    dispatch.install(dispatch.VerifyDispatcher(device=DEVICE))
    try:
        assert tp._inline_fanout_ok()
        monkeypatch.setattr(dispatch.get(), "_prefer_host", False)
        assert not tp._inline_fanout_ok()
    finally:
        dispatch.uninstall()
    monkeypatch.setattr(tp, "_INLINE_FANOUT", "0")
    assert not tp._inline_fanout_ok()


# -- the latency tracker against the reference's ---------------------------


def test_latency_tracker_equals_the_reference_on_one_feed():
    """The same seeded samples (fast peers, a gray one, timeouts) into
    both packages' ``PeerLatency`` give the same deadlines, hedge delays,
    quantiles and gray flags after every sample."""
    from bftkv_tpu.transport.latency import PeerLatency as RefLatency

    rng = random.Random(17)
    port, ref = PeerLatency(), RefLatency()
    peers = ["loop://p%d" % i for i in range(6)]
    for step in range(400):
        addr = rng.choice(peers)
        secs = rng.lognormvariate(-4, 0.6) * (40 if addr == peers[5] and rng.random() < 0.3 else 1)
        timeout = rng.random() < 0.01
        port.record(addr, secs, timeout=timeout)
        ref.record(addr, secs, timeout=timeout)
        if step % 7 == 0:
            group = rng.sample(peers, 3)
            assert port.hedge_delay(group) == ref.hedge_delay(group)
            for a in peers:
                assert port.deadline(a, 10.0) == ref.deadline(a, 10.0)
                assert port.is_gray(a) == ref.is_gray(a)
                assert port.quantile(a, 0.99) == ref.quantile(a, 0.99)
                assert port.ewma(a) == ref.ewma(a)


# -- adaptive per-peer deadlines (tests/test_recovery.py's cases) -----------


def test_adaptive_deadline_tracks_peer_history():
    pl = PeerLatency()
    pl.floor = 0.05
    addr = "loop://fast"
    for _ in range(8):
        pl.record(addr, 0.01)
    dl = pl.deadline(addr, 10.0)
    assert 0.05 <= dl <= 0.5
    assert pl.deadline("loop://stranger", 10.0) == 10.0
    assert any(k.startswith("transport.peer.deadline_ms") for k in metrics.snapshot())


def test_adaptive_deadline_disabled_env(monkeypatch):
    monkeypatch.setenv("BFTKV_ADAPTIVE_TIMEOUT", "off")
    pl = PeerLatency()
    for _ in range(8):
        pl.record("loop://x", 0.01)
    assert pl.deadline("loop://x", 10.0) == 10.0


def test_gray_flag_trips_and_recovers():
    pl = PeerLatency()
    addr = "loop://grayish"
    before = metrics.snapshot().get("transport.peer.slow{peer=grayish}", 0)
    for _ in range(6):
        pl.record(addr, 0.02)
    assert not pl.is_gray(addr)
    pl.record(addr, 1.5)
    assert pl.is_gray(addr)
    assert metrics.snapshot().get("transport.peer.slow{peer=grayish}", 0) == before + 1
    pl.record(addr, 0.02)
    assert not pl.is_gray(addr)


def test_hedge_delay_bounded():
    pl = PeerLatency()
    assert pl.hedge_delay(["loop://nobody"]) == pl.hedge_min
    for _ in range(8):
        pl.record("loop://slowish", 5.0)
    assert pl.hedge_delay(["loop://slowish"]) == pl.hedge_cap


def test_timeout_records_as_gray_sample():
    pl = PeerLatency()
    pl.record("loop://dead", 1.0, timeout=True)
    assert pl.is_gray("loop://dead")


# -- HTTP (tests/test_http_cluster.py) -------------------------------------

@pytest.fixture(scope="module")
def http_cluster():
    # 4 quorum + 4 rw nodes: the READ-complement clique needs >= 4 nodes
    # for f >= 1 (wotqs.go:55-66), else the READ quorum is empty.
    cluster = start_cluster(4, 3, 4, bits=BITS, transport="http")
    yield cluster
    cluster.stop()


def test_http_write_read_roundtrip(http_cluster):
    c = http_cluster.clients[0]
    c.write(b"http/x", b"over the wire")
    assert c.read(b"http/x") == b"over the wire"
    # A second client sees the committed value through its own ports.
    assert http_cluster.clients[1].read(b"http/x") == b"over the wire"


def test_http_missing_variable_reads_none(http_cluster):
    assert http_cluster.clients[0].read(b"http/never-written") is None


def test_http_error_tunnel(http_cluster):
    """Interned errors survive the x-error header round trip
    (reference: transport/http/http.go:59-66): a hostile body fails
    session-layer decryption server-side and the client re-raises the
    *same interned error object*, not a generic HTTP failure."""
    addr = http_cluster.universe.servers[0].cert.address
    tr = http_cluster.clients[0].tr
    with pytest.raises(Error) as ei:
        tr.post(addr + "/bftkv/v1/sign", b"\xde\xad\xbe\xef" * 8)
    import bftkv_tpu_torch.errors as errors

    assert errors.error_from_string(ei.value.message) is type(ei.value)


def test_http_concurrent_writes_share_device_batches(http_cluster, monkeypatch):
    """N clients writing concurrently through real sockets: all writes
    land, and the dispatcher coalesces verify calls from concurrent
    handler threads into shared launches (mean batch > 1).

    Calibration and the verify memo are disabled for the duration:
    both would (correctly) keep verifies away from the dispatcher on a
    CPU backend, and this test exists to observe the coalescing
    machinery itself."""
    monkeypatch.setattr(vcache, "_ENABLED", False)
    metrics.reset()
    dispatch.install(
        dispatch.VerifyDispatcher(max_batch=256, max_wait=0.01, calibrate=False, device=DEVICE)
    )
    try:
        errors: list = []

        def run(ci, client):
            try:
                for i in range(3):
                    client.write(b"http/c%d/%d" % (ci, i), b"v%d-%d" % (ci, i))
            except Exception as e:  # pragma: no cover - surfaced below
                errors.append(e)

        threads = [
            threading.Thread(target=run, args=(ci, c))
            for ci, c in enumerate(http_cluster.clients)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        for ci in range(len(http_cluster.clients)):
            assert http_cluster.clients[0].read(b"http/c%d/2" % ci) == b"v%d-2" % ci

        snap = metrics.snapshot()
        assert snap.get("dispatch.flushes", 0) >= 1
        mean = snap["dispatch.verifies"] / snap["dispatch.flushes"]
        assert mean > 1.0, f"no cross-request coalescing observed: {snap}"
    finally:
        dispatch.uninstall()


def test_http_connections_are_reused(http_cluster):
    """The per-peer keep-alive pool carries repeat RPCs on existing
    sockets: after a warm first write, further writes mostly reuse
    (transport.conn.reused grows much faster than .dialed)."""
    c = http_cluster.clients[0]
    c.write(b"http/pool-warm", b"w")  # dials + pools the quorum links
    metrics.reset()
    for i in range(3):
        c.write(b"http/pool/%d" % i, b"v%d" % i)
    snap = metrics.snapshot()
    reused = snap.get("transport.conn.reused", 0)
    dialed = snap.get("transport.conn.dialed", 0)
    assert reused > 0, f"no connection reuse observed: {snap}"
    # A write is ~12 RPCs; with warm pools nearly all should reuse.
    assert reused >= 3 * dialed, (reused, dialed)


def test_http_transport_is_really_used(http_cluster):
    """Guard against the fixture silently falling back to loopback."""
    assert isinstance(http_cluster.clients[0].tr, TrHTTP)
    addr = http_cluster.universe.servers[0].cert.address
    assert addr.startswith("http://127.0.0.1:")
    assert int(addr.rsplit(":", 1)[1]) >= 20000  # away from the reference's blocks


# -- presession (tests/test_presession.py) ---------------------------------

class _FakeClient:
    tr = None


# -- leases -----------------------------------------------------------------


def test_lease_lifecycle():
    p = Presession(_FakeClient())
    assert p.next_t(b"x") == 1  # never seen: optimistic first write
    p.lease_update(b"x", 4)
    assert p.next_t(b"x") == 5
    p.lease_update(b"x", 2)  # leases only move forward
    assert p.next_t(b"x") == 5
    p.lease_drop(b"x")
    assert p.next_t(b"x") == 1


def test_lease_never_aliases_write_once_marker():
    p = Presession(_FakeClient())
    p.lease_update(b"sealed", MAX_UINT64)
    # guessing MAX_UINT64 would BE a write-once; the quorum answers
    # ERR_NO_MORE_WRITE to t=1, which is the correct outcome
    assert p.next_t(b"sealed") == 1


def test_lease_lru_bound():
    p = Presession(_FakeClient())
    p.LEASE_MAX = 4
    for i in range(8):
        p.lease_update(b"k%d" % i, i + 1)
    assert len(p._leases) == 4
    assert p.next_t(b"k7") == 9  # newest kept
    assert p.next_t(b"k0") == 1  # oldest evicted


def test_presession_off_disables_leases(monkeypatch):
    monkeypatch.setenv("BFTKV_PRESESSION", "off")
    p = Presession(_FakeClient())
    p.lease_update(b"x", 9)
    assert p.next_t(b"x") == 1


# -- signer maps (share-combination state) ----------------------------------


def test_signer_map_memoized_per_quorum_object():
    class _N:
        def __init__(self, i):
            self.id = i

    class _Q:
        def __init__(self):
            self.calls = 0
            self._nodes = [_N(1), _N(2)]

        def nodes(self):
            self.calls += 1
            return self._nodes

    q = _Q()
    p = Presession(_FakeClient())
    m1 = p.signer_map(q)
    m2 = p.signer_map(q)
    assert m1 is m2 and set(m1) == {1, 2}
    assert q.calls == 1


# -- session warming --------------------------------------------------------


def test_pump_reseals_cold_peer():
    c = start_cluster(4, 1, 4, bits=BITS)
    cl = c.clients[0]
    try:
        cl.write(b"warm/x", b"v")  # establishes sessions + warm set
        cl.drain_tails()
        msg = cl.tr.security.message
        victim = next(iter(cl._presession._warm_peers.values()))
        msg.invalidate(victim.id)
        assert not msg.has_session(victim.id)
        before = metrics.snapshot().get(
            "crypto.session.reseal{cmd=presession}", 0
        )
        resealed = cl._presession.warm_once()
        # The invalidated victim, plus any quorum member the staged
        # wave never had to contact — warming those is the pump's job.
        assert resealed >= 1
        assert msg.has_session(victim.id)
        assert (
            metrics.snapshot().get(
                "crypto.session.reseal{cmd=presession}", 0
            )
            == before + resealed
        )
        # nothing cold: the next round is a no-op
        assert cl._presession.warm_once() == 0
    finally:
        c.stop()


def test_pump_skips_open_breaker_peer_until_half_open():
    """A downed peer whose circuit breaker is OPEN stops consuming pump
    work (crypto.session.reseal_skipped); once the breaker's open
    window lapses (half-open), the pump re-seals it again — without
    ever consuming the breaker's one half-open probe slot itself."""
    import time as _time

    from bftkv_tpu_torch import transport as tp

    c = start_cluster(4, 1, 4, bits=BITS)
    cl = c.clients[0]
    was_enabled = tp.peer_health.enabled
    try:
        cl.write(b"skip/x", b"v")  # establishes sessions + warm set
        cl.drain_tails()
        cl._presession.warm_once()  # seal every staged-wave leftover
        msg = cl.tr.security.message
        victim = next(iter(cl._presession._warm_peers.values()))
        msg.invalidate(victim.id)
        assert not msg.has_session(victim.id)

        tp.peer_health.enabled = True
        tp.peer_health.reset()
        for _ in range(tp.peer_health.threshold):
            tp.peer_health.fail(victim.address)
        assert tp.peer_health.is_open(victim.address)

        before = metrics.snapshot().get("crypto.session.reseal_skipped", 0)
        assert cl._presession.warm_once() == 0
        assert not msg.has_session(victim.id)  # no pump work burned
        assert (
            metrics.snapshot().get("crypto.session.reseal_skipped", 0)
            == before + 1
        )
        # is_open never consumed the half-open probe: force the open
        # window to lapse and the pump immediately re-seals.
        with tp.peer_health._lock:
            tp.peer_health._states[victim.address][1] = (
                _time.monotonic() - 1.0
            )
        assert not tp.peer_health.is_open(victim.address)
        assert cl._presession.warm_once() >= 1
        assert msg.has_session(victim.id)
    finally:
        tp.peer_health.enabled = was_enabled
        tp.peer_health.reset()
        c.stop()


def test_restarted_peer_costs_one_reseal_not_group_bootstrap():
    """The stale-session edge: a replica restart invalidates only ITS
    pairwise session.  The next write's grouped sealing keeps every
    other peer on the session envelope — the per-recipient OAEP
    bootstrap wrap count grows by ~the single resealed peer, not by the
    whole group — and the transport's unknown-session retry heals the
    one stale link (crypto.session.reseal)."""
    c = start_cluster(4, 1, 4, bits=BITS)
    cl = c.clients[0]
    try:
        cl.write(b"reseal/x", b"v1")
        cl.drain_tails()
        cl.write(b"reseal/y", b"v2")  # steady state: all sessions warm
        cl.drain_tails()

        snap0 = metrics.snapshot()
        c.restart("rw01")  # fresh Server + MessageSecurity on the same data
        cl.write(b"reseal/z", b"v3")
        cl.drain_tails()
        snap1 = metrics.snapshot()

        reseals = sum(
            snap1.get(k, 0) - snap0.get(k, 0)
            for k in snap1
            if k.startswith("crypto.session.reseal")
        )
        assert reseals >= 1
        # The client's own sealing stayed warm for everyone else: its
        # share of fresh bootstrap wraps is the restarted peer's reseal
        # (the restarted SERVER also bootstraps its response sessions —
        # one per peer it answers — so bound the total instead of
        # demanding zero).
        wraps = snap1.get(
            "crypto.session.bootstrap_wraps", 0
        ) - snap0.get("crypto.session.bootstrap_wraps", 0)
        group = len(c.all_servers)
        assert wraps < 2 * group, (
            f"{wraps} bootstrap wraps after one peer restart — "
            "the whole group degraded to bootstrap sealing"
        )
        assert cl.read(b"reseal/z") == b"v3"
    finally:
        c.stop()


def test_pump_thread_lifecycle():
    p = Presession(_FakeClient(), interval=0.01)
    p.ensure_pump()
    assert p._pump is not None and p._pump.is_alive()
    p.ensure_pump()  # idempotent
    p.stop()
    p._pump.join(timeout=2)
    assert not p._pump.is_alive()


def test_pump_not_started_when_disabled(monkeypatch):
    monkeypatch.setenv("BFTKV_PRESESSION", "off")
    p = Presession(_FakeClient(), interval=0.01)
    p.ensure_pump()
    assert p._pump is None


# -- session bounds (tests/test_session_bounds.py) ------------------------

def _cluster():
    return start_cluster(4, 1, 4)


def test_auth_attempts_survive_eviction():
    # Eviction must not reset the brute-force penalty: retire a hot
    # AuthServer with attempts, then re-create it — counter carries.
    c = _cluster()
    try:
        cl = c.clients[0]
        var = b"bf/x"
        cl.authenticate(var, b"right")  # creates the auth data + sessions
        srv = c.servers[0]
        assert var in srv._auth
        srv._auth[var].attempts = 3
        # Force eviction via the TTL path.
        with srv._auth_lock:
            srv._auth_evict_locked(now=1e12)
        assert var not in srv._auth
        assert srv._auth_attempts.get(var) == 3
        # Next authenticate rebuilds the AuthServer WITH the carried
        # count (consumed from _auth_attempts at rebuild).  The client
        # needs only k of n for the final phase, so this server may not
        # observe "done": its counter is either reset (0) or the seeded
        # 3 plus this run's attempt — never restarted from scratch.
        cl.authenticate(var, b"right")
        assert var in srv._auth
        assert var not in srv._auth_attempts
        assert srv._auth[var].attempts in (0, 3, 4), srv._auth[var].attempts
        # At least one replica completed the handshake and cleared it.
        assert any(
            s._auth.get(var) is not None and s._auth[var].attempts == 0
            for s in c.servers
        )
    finally:
        c.stop()


def _pool_keys(count: int) -> list:
    """``count`` distinct 1024-bit RSA keys, made from the products of
    pairs of a few seeded keys' primes (generating 200 keys would cost
    half a minute here)."""
    import itertools

    primes = [p for i in range(11) for p in (seeded_key(BITS, 960 + i).p, seeded_key(BITS, 960 + i).q)]
    out = []
    for p, q in itertools.combinations(primes, 2):
        lam = (p - 1) * (q - 1) // math.gcd(p - 1, q - 1)
        out.append(rsa.PrivateKey(n=p * q, e=65537, d=pow(65537, -1, lam), p=p, q=q))
        if len(out) == count:
            return out
    raise ValueError(count)


def test_message_security_tables_bounded():
    key = seeded_key(BITS, 959)
    cert = certmod.Certificate(n=key.n, e=key.e, name="m")
    ms = MessageSecurity(key, cert)
    ms._CACHE_MAX = 64
    # 200 distinct "peers" bootstrap sessions at us.
    for i, pk in enumerate(_pool_keys(200)):
        pc = certmod.Certificate(n=pk.n, e=pk.e, name="p%d" % i)
        peer = MessageSecurity(pk, pc)
        blob = peer.encrypt([cert], b"hi", b"n%d" % i)
        ms.decrypt(blob)
    assert len(ms._by_id) <= 64
    assert len(ms._by_peer) <= 64


def test_auth_attempts_fold_after_midflight_eviction():
    """An AuthServer fetched under _auth_lock is used
    outside it; if eviction retires it mid-handshake, wrong-password
    increments made on the retired object must still land in the
    durable counter (or in the replacement instance) when the handler
    finishes."""
    c = _cluster()
    try:
        cl = c.clients[0]
        var = b"bf/race"
        cl.authenticate(var, b"right")
        srv = c.servers[0]
        a = srv._auth[var]

        # Handler holds `a`; TTL eviction retires it concurrently with
        # attempts=2 recorded at retirement time.
        a.attempts = 2
        with srv._auth_lock:
            srv._auth_evict_locked(now=1e12)
        assert srv._auth_attempts.get(var) == 2

        # The in-flight handler then increments the retired object
        # (wrong password inside make_response) and finishes.
        a.attempts = 3
        srv._auth_fold_attempts(var, a)
        assert srv._auth_attempts.get(var) == 3

        # Replacement case: a new instance owns the variable while the
        # evicted one is still live; fold carries max() into it.
        cl.authenticate(var, b"right")  # rebuilds the map entry
        cur = srv._auth[var]
        assert cur is not a
        base = cur.attempts
        a.attempts = base + 5
        srv._auth_fold_attempts(var, a)
        assert srv._auth[var].attempts == base + 5

        # And folding a stale lower count never regresses the counter.
        a.attempts = 1
        srv._auth_fold_attempts(var, a)
        assert srv._auth[var].attempts == base + 5
    finally:
        c.stop()


# -- hedged staged fan-out and health-aware staging (tests/test_hedge.py; its
# -- p50 timing gate and fleet-feed cases wait for obs/) ---------------------

@pytest.fixture()
def hedge_cluster():
    tp.peer_latency.reset()
    c = start_cluster(4, 1, 4, bits=BITS)
    cl = c.clients[0]
    # Warm sessions + the latency tracker outside the measured region.
    for i in range(4):
        cl.write(b"hedge/warm/%d" % i, b"w")
    cl.drain_tails()
    yield c
    c.stop()
    fp.disarm()
    tp.peer_latency.reset()




def _gray_target(cluster) -> str:
    """The first clique member: guaranteed to sit in the minimal
    staged prefix of an interleaved WRITE_SIGN wave."""
    return cluster.universe.servers[0].name






def test_ranking_pushes_flagged_peers_back(hedge_cluster):
    """Health-aware staging: a gray member sorts behind healthy ones,
    an open-breaker member behind gray; healthy order is preserved
    bit-for-bit (stable sort on flags only)."""
    from bftkv_tpu_torch import quorum as qm

    cl = hedge_cluster.clients[0]
    qa = qm.choose_quorum_for(cl.qs, b"hedge/rank", qm.AUTH | qm.PEER)
    nodes = qa.nodes()
    assert cl._rank_nodes(nodes) == list(nodes)  # no signal: unchanged

    gray = nodes[0]
    tp.peer_latency.record(gray.address, 0.01)
    tp.peer_latency.record(gray.address, 9.0, timeout=True)
    assert tp.peer_latency.is_gray(gray.address)
    ranked = cl._rank_nodes(nodes)
    assert ranked[-1] is gray
    assert ranked[:-1] == [n for n in nodes if n is not gray]

    was_enabled = tp.peer_health.enabled
    tp.peer_health.enabled = True
    try:
        down = nodes[1]
        for _ in range(tp.peer_health.threshold):
            tp.peer_health.fail(down.address)
        ranked = cl._rank_nodes(nodes)
        assert ranked[-1] is down  # open breaker ranks even behind gray
        assert ranked[-2] is gray
    finally:
        tp.peer_health.enabled = was_enabled
        tp.peer_health.reset()
    tp.peer_latency.reset()


def test_fleet_snapshot_feeds_ranking(hedge_cluster):
    """apply_fleet_snapshot: members the /fleet document reports down
    go to the back of the staged wave."""
    from bftkv_tpu_torch import quorum as qm

    cl = hedge_cluster.clients[0]
    qa = qm.choose_quorum_for(cl.qs, b"hedge/fleet", qm.AUTH | qm.PEER)
    nodes = qa.nodes()
    victim = nodes[0]
    cl.apply_fleet_snapshot(
        {
            "shards": {
                "0": {
                    "members": [
                        {"name": victim.name, "status": "down"},
                    ]
                }
            }
        }
    )
    try:
        ranked = cl._rank_nodes(nodes)
        assert ranked[-1] is victim
    finally:
        cl.apply_fleet_snapshot({"shards": {}})


def test_hedge_disabled_env(hedge_cluster, monkeypatch):
    """BFTKV_HEDGE=off: no hedged waves, no health ranking — the
    pre-hedging staged fan-out, bit for bit."""
    from bftkv_tpu_torch import quorum as qm

    monkeypatch.setenv("BFTKV_HEDGE", "off")
    cl = hedge_cluster.clients[0]
    qa = qm.choose_quorum_for(cl.qs, b"hedge/off", qm.AUTH | qm.PEER)
    nodes = qa.nodes()
    tp.peer_latency.record(nodes[0].address, 9.0, timeout=True)
    assert cl._rank_nodes(nodes) == list(nodes)  # ranking off too

    before = sum(
        v
        for k, v in metrics.snapshot().items()
        if k.startswith("transport.hedge.sent")
    )
    fp.arm(5)
    fp.registry.add(
        "transport.send",
        "delay",
        match={"dst": _gray_target(hedge_cluster)},
        seconds=0.3,
        rule_id="slow_node:off",
    )
    try:
        cl.write(b"hedge/off", b"v")
    finally:
        fp.disarm()
    cl.drain_tails()
    after = sum(
        v
        for k, v in metrics.snapshot().items()
        if k.startswith("transport.hedge.sent")
    )
    assert after == before
    assert cl.read(b"hedge/off") == b"v"
    tp.peer_latency.reset()
