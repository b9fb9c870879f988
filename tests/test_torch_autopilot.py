"""The port's topology autopilot (``bftkv_tpu_torch/autopilot/``) against
the reference's cases (``tests/test_autopilot.py``), on port clusters on
the cpu with 1024-bit keys: the pure decisions, the hatch, the 3-phase
split under a live writer, status, retirement of a spent clique (from a
plan and from a real f-budget), the log-backed snapshot pre-copy, a
retirement blocked without a copy, spare admission, the linearized table
issuer and ``next_table``.  Across the packages: ``decide`` and
``next_table`` on 200 seeded load and owner vectors give the reference's
``Plan`` fields and ``RouteTable.serialize()`` bytes, and the watcher's
``advise`` the reference's list on the same ``/fleet`` documents.

The split smoke waits on conditions with deadlines (a write landed before
the flip, one after it), never on fixed sleeps."""

from __future__ import annotations

import random
import threading
import time
import types

import pytest

from bftkv_tpu_torch import quorum as q
from bftkv_tpu_torch.autopilot import Autopilot, Plan, decide
from bftkv_tpu_torch.autopilot.plan import HOT_SKEW, MIN_LOAD, next_table
from bftkv_tpu_torch.quorum.wotqs import ROUTE_BUCKETS

from test_torch_utils import DEVICE, start_cluster

BITS = 1024
DEADLINE_S = 120.0


# -- decisions (pure) -----------------------------------------------------


def test_decide_nothing_on_balance():
    owner = [b % 2 for b in range(ROUTE_BUCKETS)]
    assert decide({0: 1, 1: 1}, [1] * ROUTE_BUCKETS, owner, 2) is None


def test_decide_split_hot_shard():
    owner = [b % 2 for b in range(ROUTE_BUCKETS)]
    load = [0] * ROUTE_BUCKETS
    for b in range(0, 40, 2):
        load[b] = 50
    plan = decide({0: 1, 1: 1}, load, owner, 2)
    assert plan is not None and plan.kind == "split" and plan.shard == 0
    assert plan.assign and set(plan.assign.values()) == {1}
    assert all(load[b] > 0 for b in plan.assign)


def test_decide_retire_beats_split():
    owner = [b % 2 for b in range(ROUTE_BUCKETS)]
    load = [10] * ROUTE_BUCKETS
    plan = decide({0: 1, 1: -1}, load, owner, 2)
    assert plan is not None and plan.kind == "retire" and plan.shard == 1
    assert set(plan.assign) == {b for b in range(ROUTE_BUCKETS) if owner[b] == 1}
    assert set(plan.assign.values()) == {0}
    assert decide({0: -1, 1: -1}, load, owner, 2) is None
    assert decide({0: -1}, load, [0] * ROUTE_BUCKETS, 1) is None


def test_decide_ignores_tiny_load():
    owner = [b % 2 for b in range(ROUTE_BUCKETS)]
    load = [0] * ROUTE_BUCKETS
    load[0] = 5
    assert decide({0: 1, 1: 1}, load, owner, 2) is None


def test_autopilot_hatch(monkeypatch):
    from bftkv_tpu_torch.autopilot import autopilot_enabled

    monkeypatch.delenv("BFTKV_AUTOPILOT", raising=False)
    assert autopilot_enabled()
    monkeypatch.setenv("BFTKV_AUTOPILOT", "off")
    assert not autopilot_enabled()
    # Off disables deciding only.
    ap = Autopilot([], [])
    assert ap.decide() is None and ap.status()["enabled"] is False


# -- across the packages ----------------------------------------------------


def _seeded_inputs(rng: random.Random):
    nshards = rng.choice((1, 2, 2, 3, 4))
    owner = [rng.randrange(nshards) for _ in range(ROUTE_BUCKETS)]
    shape = rng.randrange(4)
    if shape == 0:
        load = [rng.randrange(3) for _ in range(ROUTE_BUCKETS)]
    elif shape == 1:  # one hot shard
        hot = rng.randrange(nshards)
        load = [rng.randrange(40) if owner[b] == hot else rng.randrange(2) for b in range(ROUTE_BUCKETS)]
    elif shape == 2:  # a few hot buckets
        load = [0] * ROUTE_BUCKETS
        for b in rng.sample(range(ROUTE_BUCKETS), rng.randrange(1, 12)):
            load[b] = rng.randrange(1, 200)
    else:
        load = [rng.randrange(100) for _ in range(ROUTE_BUCKETS)]
    f_rem = {sh: rng.choice((-1, 0, 1, 1, 2, 2, 2)) for sh in range(nshards) if rng.random() < 0.9}
    retiring = {sh for sh in range(nshards) if rng.random() < 0.15}
    kw = {}
    if rng.random() < 0.3:
        kw["hot_skew"] = rng.choice((1.2, HOT_SKEW, 1.9))
    if rng.random() < 0.3:
        kw["min_load"] = rng.choice((0, 8, MIN_LOAD, 500))
    return f_rem, load, owner, nshards, retiring, kw


def _plan_fields(p):
    return None if p is None else (p.kind, p.shard, dict(p.assign), p.reason)


def test_decide_and_next_table_equal_the_references():
    """200 seeded (f-budget, load, owner, shard count, retiring) inputs:
    the port's plan equals the reference's field for field, and the
    tables ``next_table`` builds from it (flip and finalize shapes) equal
    the reference's byte for byte."""
    from bftkv_tpu.autopilot.plan import decide as ref_decide
    from bftkv_tpu.autopilot.plan import next_table as ref_next_table

    rng = random.Random(16)
    kinds = set()
    for i in range(200):
        f_rem, load, owner, nshards, retiring, kw = _seeded_inputs(rng)
        got = decide(f_rem, load, owner, nshards, retiring=set(retiring), **kw)
        want = ref_decide(f_rem, load, owner, nshards, retiring=set(retiring), **kw)
        assert _plan_fields(got) == _plan_fields(want), i
        kinds.add(got.kind if got else None)
        cliques = tuple(1000 + 17 * s for s in range(nshards))
        qs = types.SimpleNamespace(effective_route=lambda o=owner: list(o),
                                   route_cliques=lambda c=cliques: c,
                                   route_epoch=lambda e=i % 7: e)
        assign = got.assign if got else {b: (owner[b] + 1) % nshards for b in range(0, ROUTE_BUCKETS, 9)}
        for dual, ret, epoch in ((True, None, None), (False, retiring, None), (True, retiring, 40 + i)):
            a = next_table(qs, assign, dual=dual, retiring=ret, epoch=epoch)
            b = ref_next_table(qs, assign, dual=dual, retiring=ret, epoch=epoch)
            assert a.serialize() == b.serialize(), (i, dual)
    assert kinds == {None, "split", "retire"}
    empty = types.SimpleNamespace(effective_route=lambda: [], route_cliques=lambda: (), route_epoch=lambda: 0)
    with pytest.raises(ValueError):
        next_table(empty, {})


def _seeded_fleet_doc(rng: random.Random) -> dict:
    shards = {}
    for sh in range(rng.choice((1, 2, 3, 4))):
        sd: dict = {}
        if rng.random() < 0.9:
            f = rng.choice((1, 2, 21))
            down = [f"a{j:02d}" for j in range(rng.randrange(0, f + 2))]
            sd["f_budget"] = {"f": f, "remaining": f - len(down), "down": down}
        if rng.random() < 0.85:
            sd["slo"] = {"write": {"count": rng.choice((0, 3, 20, 60, 400)) * rng.randrange(1, 4)}}
        elif rng.random() < 0.5:
            sd["slo"] = {"write": None}
        shards[str(sh)] = sd
    return {"shards": shards, "members": {}, "ts": rng.random()}


def test_advise_equals_the_references():
    """The watcher's advice on 200 seeded ``/fleet`` documents (spent and
    healthy budgets, skewed and level write counts, missing sections),
    at the default and at other skews, equals the reference's."""
    from bftkv_tpu.autopilot.__main__ import advise as ref_advise
    from bftkv_tpu_torch.autopilot.__main__ import advise

    rng = random.Random(61)
    seen = set()
    for i in range(200):
        doc = _seeded_fleet_doc(rng)
        for skew in (HOT_SKEW, 1.1, 3.0):
            got = advise(doc, skew)
            assert got == ref_advise(doc, skew), (i, doc)
            seen.update(a["kind"] for a in got)
    assert seen == {"split", "retire"}
    assert advise({}) == [] and advise({"shards": {}}) == []


def test_watcher_once_exit_codes(monkeypatch, capsys):
    """``--once``: exit 0 with ``advice: []`` on a quiet fleet, 3 with
    advice pending, over a served ``/fleet`` document; the hatch prints
    the disabled line and exits 0."""
    import http.server
    import json

    from bftkv_tpu_torch.autopilot import __main__ as watcher

    docs = [{"shards": {"0": {"f_budget": {"f": 1, "remaining": 1, "down": []},
                              "slo": {"write": {"count": 8}}}}},
            {"shards": {"0": {"f_budget": {"f": 1, "remaining": 1, "down": []},
                              "slo": {"write": {"count": 200}}},
                        "1": {"f_budget": {"f": 1, "remaining": 0, "down": ["a05"]},
                              "slo": {"write": {"count": 2}}}}}]

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps(docs[0]).encode()
            self.send_response(200)
            self.send_header("content-length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/fleet"
    try:
        assert watcher.main(["--fleet-url", url, "--once"]) == 0
        assert json.loads(capsys.readouterr().out)["advice"] == []
        docs.pop(0)
        assert watcher.main(["--fleet-url", url, "--once"]) == 3
        kinds = [a["kind"] for a in json.loads(capsys.readouterr().out)["advice"]]
        assert kinds == ["retire", "split"]
        monkeypatch.setenv("BFTKV_AUTOPILOT", "off")
        assert watcher.main(["--fleet-url", url, "--once"]) == 0
        assert "disabled" in capsys.readouterr().out
    finally:
        srv.shutdown()
        srv.server_close()


# -- live clusters --------------------------------------------------------


@pytest.fixture(scope="module")
def split_cluster():
    cluster = start_cluster(4, 2, 4, bits=BITS, n_shards=2, device=DEVICE)
    yield cluster
    cluster.stop()


def hot_keys_for(qs, shard, n, tag=b"hot"):
    out, i = [], 0
    while len(out) < n and i < 65536:
        k = b"%s/%d" % (tag, i)
        i += 1
        if qs.shard_of(k) == shard:
            out.append(k)
    return out


class _Writer:
    """One thread writing the keys round robin until stopped; counts its
    acknowledged writes under a condition the test waits on."""

    def __init__(self, cl, keys, value=lambda i, k: b"w%d-" % i + k):
        self.cl, self.keys, self.value = cl, keys, value
        self.ok, self.failures = 0, []
        self.cond = threading.Condition()
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        i = 0
        while not self._stop.is_set():
            i += 1
            k = self.keys[i % len(self.keys)]
            try:
                self.cl.write(k, self.value(i, k))
            except Exception as e:  # must not fire
                self.failures.append(e)
                continue
            with self.cond:
                self.ok += 1
                self.cond.notify_all()

    def wait_past(self, n: int) -> int:
        """Waits (with a deadline) until more than ``n`` writes landed."""
        with self.cond:
            assert self.cond.wait_for(lambda: self.ok > n or self.failures, DEADLINE_S), \
                f"no write landed past {n} in {DEADLINE_S} s"
            return self.ok

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(DEADLINE_S)
        assert not self._t.is_alive()


def _shard_members(cluster, idx):
    return [s for s in cluster.all_servers if s.qs.shard_index_of(s.self_node.get_self_id()) == idx]


def test_split_smoke(split_cluster):
    """A hot-shard workload on a 2-clique loopback fleet triggers an
    automatic split; writes keep succeeding ACROSS the flip; the moved
    keys' history and new writes are readable afterwards; every member
    lands on the finalize epoch; a new-owner replica verifies a migrated
    record against its own clique."""
    from bftkv_tpu_torch import packet as pkt
    from bftkv_tpu_torch.sync.digest import latest_completed

    cluster = split_cluster
    cl = cluster.clients[0]
    qs = cl.qs
    keys = hot_keys_for(qs, 0, 16)
    for k in keys:
        cl.write(k, b"v1-" + k)
    cl.drain_tails()

    ap = Autopilot.for_cluster(cluster)
    plan = ap.decide()
    assert plan is not None and plan.kind == "split" and plan.shard == 0

    with _Writer(cl, keys) as w:
        before = w.wait_past(0)  # the writer is writing before the flip
        report = ap.execute(plan, pace=0.1)
        during = w.ok - before
        w.wait_past(w.ok)  # and writes after the finalize table
    cl.drain_tails()

    assert report["ok"], report
    assert not w.failures, w.failures[:3]
    assert during > 0, "no write landed while the migration ran"
    moved = [k for k in keys if qs.shard_of(k) == 1]
    assert moved, "no hot key rerouted by the split"
    epochs = {s.qs.route_epoch() for s in cluster.all_servers}
    epochs |= {c.qs.route_epoch() for c in cluster.clients}
    assert epochs == {report["final_epoch"]}
    for k in keys:
        assert cl.read(k) is not None
    for k in moved[:4]:
        cl.write(k, b"post-" + k)
    cl.drain_tails()
    for k in moved[:4]:
        assert cl.read(k) == b"post-" + k
    checked = 0
    for srv in _shard_members(cluster, 1):
        for k in moved:
            rec = latest_completed(srv.storage, k)
            if rec is None:
                continue
            _t, raw, p = rec
            srv.crypt.collective.verify(
                pkt.tbss(raw), p.ss, q.choose_quorum_for(srv.qs, k, q.AUTH), srv.crypt.keyring,
            )
            checked += 1
    assert checked > 0


def test_status_and_last_decision(split_cluster):
    st = Autopilot.for_cluster(split_cluster).status()
    assert "enabled" in st and "epoch" in st and "last" in st
    assert st["last"] == {"kind": None} and st["retired"] == [] and st["migrations"] == 0


def _build(**kw):
    from bftkv_tpu_torch.faults.harness import build_cluster

    return build_cluster(4, 1, 4, bits=BITS, n_shards=2, device=DEVICE, **kw)


def test_retire_spent_clique():
    """Every certified record of the retiring clique's buckets is readable
    from the new owner before the flip; new writes re-route."""
    cluster = _build()
    try:
        cl = cluster.clients[0]
        qs = cl.qs
        keys = hot_keys_for(qs, 1, 10, tag=b"ret")
        for k in keys:
            cl.write(k, b"v-" + k)
        cl.drain_tails()
        ap = Autopilot.for_cluster(cluster)
        owner = qs.effective_route()
        assign = {b: 0 for b in range(ROUTE_BUCKETS) if owner[b] == 1}
        report = ap.execute(Plan("retire", 1, assign, reason="test"))
        assert report["ok"], report
        assert "handoff_misses" not in report
        assert ap.verify_handoff(set(assign), _shard_members(cluster, 1), _shard_members(cluster, 0)) == []
        for k in keys:
            assert cl.read(k) == b"v-" + k
            assert qs.shard_of(k) == 0
        for k in keys[:4]:
            cl.write(k, b"v2-" + k)
        cl.drain_tails()
        for k in keys[:4]:
            assert cl.read(k) == b"v2-" + k
        assert 1 in ap.status()["retired"]
    finally:
        cluster.stop()


def test_split_snapshot_precopy_log_backed(tmp_path):
    """A split over log-backed replicas bulk-ships sealed-segment
    snapshots through the full admission path before the converge loop,
    with zero failed writes and the moved history readable after."""
    import itertools
    import os

    from bftkv_tpu_torch.storage.logkv import LogStorage

    counter = itertools.count()
    root = str(tmp_path / "logs")

    def factory():
        return LogStorage(os.path.join(root, "replica-%03d" % next(counter)),
                          fsync=False, segment_bytes=1 << 16)

    cluster = _build(storage_factory=factory)
    try:
        cl = cluster.clients[0]
        qs = cl.qs
        keys = hot_keys_for(qs, 0, 16, tag=b"snap")
        for k in keys:
            cl.write(k, b"v-" + k)
        cl.drain_tails()
        ap = Autopilot.for_cluster(cluster)
        owner = qs.effective_route()
        shard0 = [b for b in range(ROUTE_BUCKETS) if owner[b] == 0]
        assign = {b: 1 for b in shard0[: len(shard0) // 2]}
        with _Writer(cl, keys, value=lambda i, k: b"w%d" % i) as w:
            w.wait_past(0)
            report = ap.execute(Plan("split", 0, assign, reason="test"))
        cl.drain_tails()
        assert report["ok"], report
        assert report.get("snapshot_shipped", 0) > 0, report
        assert not w.failures, w.failures[:3]
        for k in keys:
            assert cl.read(k) is not None
        moved = [k for k in keys if qs.shard_of(k) == 1]
        assert moved, "no key rerouted by the split"
        for k in moved[:4]:
            cl.write(k, b"post-" + k)
        cl.drain_tails()
        for k in moved[:4]:
            assert cl.read(k) == b"post-" + k
    finally:
        cluster.stop()


def test_decide_retire_from_real_f_budget():
    """Crash enough of one clique that the fleet collector's f-budget hits
    zero: the next decision retires that clique, and executing it under
    the crash completes with the history readable."""
    from bftkv_tpu_torch import trace as trmod
    from bftkv_tpu_torch.metrics import registry as mreg
    from bftkv_tpu_torch.obs import FleetCollector, LocalSource

    cluster = _build()
    try:
        cl = cluster.clients[0]
        keys = hot_keys_for(cl.qs, 1, 6, tag=b"fb")
        for k in keys:
            cl.write(k, b"v-" + k)
        cl.drain_tails()
        collector = FleetCollector(
            [LocalSource(name, lambda n=name: cluster.server_named(n)) for name in sorted(cluster._by_name)],
            local_metrics=mreg, local_tracer=trmod.tracer,
        )
        collector.scrape_once()
        ap = Autopilot.for_cluster(cluster, collector=collector)
        assert collector.autopilot_status == ap.status
        plan = ap.decide()
        assert plan is None or plan.kind != "retire"
        names: dict[int, list] = {}
        for s in cluster.servers:
            names.setdefault(s.qs.shard_index_of(s.self_node.get_self_id()), []).append(s.self_node.name)
        for name in names[1][:2]:  # f=1 for a 4-clique: 2 down = spent
            cluster.crash(name)
        collector.scrape_once()
        doc = collector.health()
        assert doc["shards"]["1"]["f_budget"]["remaining"] <= 0
        assert doc["autopilot"]["enabled"] is True
        plan = ap.decide()
        assert plan is not None and plan.kind == "retire" and plan.shard == 1
        assert set(plan.assign.values()) == {0}
        report = ap.execute(plan)
        assert report["ok"], report
        for k in keys:
            assert cl.read(k) == b"v-" + k
            assert cl.qs.shard_of(k) == 0
    finally:
        cluster.stop()


def test_retire_blocked_without_copy():
    """A retirement whose pre-copy cannot complete must not flip: abort,
    rescind, and the old clique keeps serving its keys."""
    cluster = _build()
    try:
        cl = cluster.clients[0]
        qs = cl.qs
        keys = hot_keys_for(qs, 1, 4, tag=b"blocked")
        for k in keys:
            cl.write(k, b"v-" + k)
        cl.drain_tails()
        ap = Autopilot.for_cluster(cluster)
        ap.MAX_SYNC_ROUNDS = 0
        owner = qs.effective_route()
        assign = {b: 0 for b in range(ROUTE_BUCKETS) if owner[b] == 1}
        report = ap.execute(Plan("retire", 1, assign, reason="test"))
        assert not report["ok"] and report["aborted"] == "precopy_blocked"
        assert report["rescind_epoch"] > 0
        for k in keys:
            assert qs.shard_of(k) == 1
            assert cl.read(k) == b"v-" + k
    finally:
        cluster.stop()


def test_admit_spares_bumps_generation():
    from bftkv_tpu_torch import topology

    from test_torch_utils import seeded_key

    cluster = start_cluster(4, 1, 2, bits=BITS, n_shards=1, device=DEVICE)
    try:
        ap = Autopilot.for_cluster(cluster)
        spare = topology.new_identity("sp01", address="loop://sp01", uid="sp01@spare",
                                      key=seeded_key(BITS, 900))
        gens = {id(s): s.self_node.generation for s in cluster.all_servers}
        accepted = ap.admit_spares([spare.cert])
        assert accepted == len(cluster.all_servers) + len(cluster.clients)
        for s in cluster.all_servers:
            assert s.self_node.generation > gens[id(s)]
            assert s.crypt.keyring.get(spare.cert.id) is not None
    finally:
        cluster.stop()


@pytest.fixture(scope="module")
def two_shards():
    cluster = start_cluster(4, 1, 4, bits=BITS, n_shards=2, device=DEVICE, key_base=40)
    yield cluster
    cluster.stop()


def test_issue_table_linearizes(two_shards):
    """Tables issued one after another get distinct epochs and chain their
    contents; a staged table stays out of the chain."""
    ap = Autopilot.for_cluster(two_shards)
    qs = two_shards.clients[0].qs
    owner = qs.effective_route()
    b1 = next(b for b in range(ROUTE_BUCKETS) if owner[b] == 0)
    b2 = next(b for b in range(ROUTE_BUCKETS) if owner[b] == 0 and b != b1)
    rt1 = ap.issue_table({b1: 1}, dual=False)
    rt2 = ap.issue_table({b2: 1}, dual=False)
    assert rt2.epoch > rt1.epoch
    assert rt2.cliques[rt2.table[b1]] == rt1.cliques[rt1.table[b1]]
    rt_stage = ap.issue_table({b1: 0}, dual=True, stage=True)
    rt3 = ap.issue_table({}, dual=False)
    assert rt3.epoch > rt_stage.epoch
    assert rt3.cliques[rt3.table[b1]] == rt2.cliques[rt2.table[b1]]


def test_issue_table_under_concurrent_issuers(two_shards):
    """Eight threads issuing at once: every epoch distinct, and the last
    table holds every thread's move."""
    ap = Autopilot.for_cluster(two_shards)
    owner = two_shards.clients[0].qs.effective_route()
    mine = [b for b in range(ROUTE_BUCKETS) if owner[b] == 0][:8]
    tables = []
    lock = threading.Lock()

    def issue(b):
        rt = ap.issue_table({b: 1}, dual=False)
        with lock:
            tables.append(rt)

    threads = [threading.Thread(target=issue, args=(b,)) for b in mine]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    assert len({rt.epoch for rt in tables}) == len(mine)
    last = max(tables, key=lambda rt: rt.epoch)
    cid1 = last.cliques[1]
    assert all(last.cliques[last.table[b]] == cid1 for b in mine)


def test_next_table_shapes(two_shards):
    qs = two_shards.clients[0].qs
    owner = qs.effective_route()
    b = next(i for i in range(ROUTE_BUCKETS) if owner[i] == 0)
    rt = next_table(qs, {b: 1}, dual=True)
    assert qs.route_epoch() == 0 and rt.epoch == 1
    assert rt.dual == {b: 0}
    rt2 = next_table(qs, {b: 1}, dual=False, retiring={0})
    assert rt2.dual == {} and rt2.retiring == {0}


def test_watch_loop_starts_and_stops(two_shards):
    """``start`` runs ``step`` on its interval (reconcile, decide) until
    ``stop``; a quiet two-shard cluster needs nothing."""
    ap = Autopilot.for_cluster(two_shards)
    ran = threading.Event()
    step = ap.step

    def counted_step(**kw):
        out = step(**kw)
        ran.set()
        return out

    ap.step = counted_step
    ap.start(interval=0.05)
    try:
        assert ran.wait(DEADLINE_S)
    finally:
        t0 = time.monotonic()
        ap.stop()
    assert time.monotonic() - t0 < 15 and ap._thread is None
    assert ap.status()["last"] == {"kind": None}
