"""The port's fleet health plane (``bftkv_tpu_torch/obs``) against the
reference's cases: ``tests/test_fleet.py`` (trace export/drain, stitching,
f-budget aggregation, the anomaly feed, the /fleet HTTP surface against
fake sources), ``tests/test_fleet_cluster.py`` (a live 2-shard loopback
cluster of port nodes on the cpu) and ``tests/test_wan_smoke.py`` (a
2-region fleet under the wan2 matrix).  Across the packages: both
collectors fed the same member snapshots and traces give equal /fleet
documents (less timestamps) and equal Prometheus text, and both
``cmd.fleet`` renderers the same text and exit code."""

from __future__ import annotations

import json
import threading
import urllib.request

from bftkv_tpu_torch import trace
from bftkv_tpu_torch.metrics import BUCKETS, Registry
from bftkv_tpu_torch.obs import FleetCollector, Stitcher
from bftkv_tpu_torch.obs.collector import parse_flat_key


# -- trace export / drain ---------------------------------------------------


def test_export_cursor_drains_incrementally():
    t = trace.Tracer(max_spans=64)
    old, trace.tracer = trace.tracer, t
    try:
        with trace.span("a"):
            pass
        out = t.export(0)
        assert [s["name"] for s in out["spans"]] == ["a"]
        assert out["dropped"] == 0
        cur = out["cursor"]
        with trace.span("b"):
            pass
        out2 = t.export(cur)
        assert [s["name"] for s in out2["spans"]] == ["b"]
        # nothing new: empty drain, cursor stable
        out3 = t.export(out2["cursor"])
        assert out3["spans"] == [] and out3["dropped"] == 0
    finally:
        trace.tracer = old


def test_export_reports_ring_overflow_as_dropped():
    t = trace.Tracer(max_spans=4)
    old, trace.tracer = trace.tracer, t
    try:
        cur = t.export(0)["cursor"]
        for i in range(10):
            with trace.span(f"s{i}"):
                pass
        out = t.export(cur)
        # ring holds the newest 4; the 6 older ones are honestly lost
        assert len(out["spans"]) == 4
        assert out["dropped"] == 6
        # a cursor AHEAD of the sequence (process restarted) resyncs
        t.reset()
        with trace.span("fresh"):
            pass
        out2 = t.export(cur + 1000)
        assert [s["name"] for s in out2["spans"]] == ["fresh"]
    finally:
        trace.tracer = old


def test_ring_dropped_is_reader_relative():
    """The cumulative overwrite gauge counts only spans evicted before
    ANY reader drained them: a full ring whose tail every scrape keeps
    up with loses nothing — otherwise the TRACE DROPS warning would
    fire forever on any busy long-lived daemon."""
    t = trace.Tracer(max_spans=4)
    old, trace.tracer = trace.tracer, t
    try:
        for i in range(10):
            with trace.span(f"s{i}"):
                pass
        out = t.export(0)
        # spans 1-6 were overwritten before this first drain: real loss
        assert out["ring_dropped"] == 6
        cur = out["cursor"]
        # the ring stays full, but these evictions overwrite spans the
        # drain above was already offered — not loss
        for i in range(4):
            with trace.span(f"t{i}"):
                pass
        out2 = t.export(cur)
        assert out2["ring_dropped"] == 6
        assert [s["name"] for s in out2["spans"]] == [
            "t0", "t1", "t2", "t3",
        ]
    finally:
        trace.tracer = old


def test_slow_dropped_is_reader_relative():
    t = trace.Tracer(max_spans=64, max_slow=2, slow_threshold=0.0)
    old, trace.tracer = trace.tracer, t
    try:
        for i in range(4):
            with trace.span(f"s{i}"):
                pass
        # 4 slow roots through a 2-deep ring, never read: 2 lost
        assert t.export(0)["slow_dropped"] == 2
        t.slow()  # a reader drained the ring
        for i in range(2):
            with trace.span(f"u{i}"):
                pass
        # the 2 evictions overwrote already-read entries: not loss
        assert t.export(0)["slow_dropped"] == 2
    finally:
        trace.tracer = old


def test_export_vs_record_race_loses_nothing():
    """Concurrent drain-vs-record: every recorded span shows up in
    exactly one drain (no loss, no duplication) as long as the ring
    does not overflow."""
    t = trace.Tracer(max_spans=65536)
    old, trace.tracer = trace.tracer, t
    try:
        n_threads, per_thread = 4, 500
        seen: list = []
        stop = threading.Event()

        def drain():
            cur = 0
            while True:
                out = t.export(cur)
                assert out["dropped"] == 0
                cur = out["cursor"]
                seen.extend(s["name"] for s in out["spans"])
                if stop.is_set() and not out["spans"]:
                    return

        def record(k: int):
            for i in range(per_thread):
                with trace.span(f"w{k}.{i}"):
                    pass

        drainer = threading.Thread(target=drain)
        writers = [
            threading.Thread(target=record, args=(k,))
            for k in range(n_threads)
        ]
        drainer.start()
        for w in writers:
            w.start()
        for w in writers:
            w.join()
        stop.set()
        drainer.join()
        # Filter to this test's own spans: an async tail from an
        # earlier test's fan-out pool may legitimately record into the
        # swapped-in tracer (pool threads outlive their test).
        mine = [n for n in seen if n.startswith("w") and "." in n]
        assert len(mine) == n_threads * per_thread
        assert len(set(mine)) == len(mine)
    finally:
        trace.tracer = old


def test_slow_trace_carries_shard_and_peer():
    t = trace.Tracer(slow_threshold=0.0)
    old, trace.tracer = trace.tracer, t
    try:
        with trace.span("client.write", attrs={"shard": 1}):
            with trace.span("rpc.write", attrs={"peer": "b02"}):
                pass
        entry = t.slow()[0]
        assert entry["shard"] == 1
        assert entry["peer"] == "b02"
    finally:
        trace.tracer = old


# -- stitching --------------------------------------------------------------


def _span(tid, sid, name, parent=None, duration=1.0, attrs=None):
    d = {
        "trace": tid,
        "span": sid,
        "name": name,
        "start": 0.0,
        "duration": duration,
    }
    if parent:
        d["parent"] = parent
    if attrs:
        d["attrs"] = attrs
    return d


def test_stitcher_joins_sources_and_dedups():
    st = Stitcher()
    assert st.add("a01", [_span("t1", "s1", "client.write", duration=2.0)]) == 1
    # re-scrape overlap: same span again is not double counted
    assert st.add("a01", [_span("t1", "s1", "client.write")]) == 0
    st.add("rw01", [_span("t1", "s2", "server.write", parent="s1")])
    assert st.summary() == {"traces": 1, "stitched": 1}
    [tr] = st.traces()
    assert tr["root"] == "client.write" and tr["stitched"]
    assert tr["sources"] == ["a01", "rw01"]
    tree = st.tree("t1")
    assert tree["children"][0]["name"] == "client.write"
    assert tree["children"][0]["children"][0]["src"] == "rw01"
    assert st.tree("nope") is None


def test_stitcher_bounded():
    st = Stitcher(max_traces=4)
    for i in range(10):
        st.add("x", [_span(f"t{i}", f"s{i}", "root")])
    assert st.summary()["traces"] == 4


# -- flat-key parsing -------------------------------------------------------


def test_parse_flat_key():
    assert parse_flat_key("plain") == ("plain", {})
    assert parse_flat_key("a.b{shard=1,le=0.5}") == (
        "a.b", {"shard": "1", "le": "0.5"}
    )


# -- collector over fake sources --------------------------------------------


class FakeSource:
    """A scriptable fleet member."""

    def __init__(self, name, shard, clique, up=True):
        self.name = name
        self.up = up
        self._info = {
            "name": name,
            "shard": shard,
            "shard_count": 2,
            "role": "clique" if name in clique["members"] else "storage",
            "clique": clique,
            "owned_buckets": 128,
        }
        self.snap: dict = {}
        self.spans: list = []
        self.slow: list = []

    def info(self):
        return self._info

    def metrics(self):
        if not self.up:
            raise OSError("down")
        return self.snap

    def trace_export(self, cursor):
        return {
            "cursor": cursor + len(self.spans),
            "dropped": 0,
            "spans": self.spans,
            "slow": self.slow,
        }

    def probe(self):
        return self.up


def _clique(names):
    n = len(names)
    f = (n - 1) // 3
    return {
        "n": n,
        "f": f,
        "threshold": 2 * f + 1,
        "suff": f + (n - f) // 2 + 1,
        "members": sorted(names),
    }


def _two_shard_fleet():
    ca = _clique(["a01", "a02", "a03", "a04"])
    cb = _clique(["b01", "b02", "b03", "b04"])
    srcs = [FakeSource(n, 0, ca) for n in ca["members"]]
    srcs += [FakeSource(n, 1, cb) for n in cb["members"]]
    srcs.append(FakeSource("rw01", 0, ca))  # storage member of shard 0
    return srcs


def test_f_budget_decrements_only_the_dark_members_shard():
    srcs = _two_shard_fleet()
    coll = FleetCollector(srcs)
    doc = coll.scrape_once()
    assert set(doc["shards"]) == {"0", "1"}
    for sd in doc["shards"].values():
        assert sd["f_budget"] == {
            "f": 1, "used": 0, "remaining": 1, "down": [],
            "storage_down": [],
        }
    next(s for s in srcs if s.name == "b02").up = False
    doc = coll.scrape_once()
    assert doc["shards"]["1"]["f_budget"]["remaining"] == 0
    assert doc["shards"]["1"]["f_budget"]["down"] == ["b02"]
    assert doc["shards"]["0"]["f_budget"]["remaining"] == 1
    kinds = [(a["kind"], a["source"], a["shard"]) for a in doc["anomalies"]]
    assert ("member_down", "b02", 1) in kinds
    # a dark STORAGE node alarms but does not consume the clique budget
    next(s for s in srcs if s.name == "rw01").up = False
    doc = coll.scrape_once()
    assert doc["shards"]["0"]["f_budget"]["remaining"] == 1
    assert doc["shards"]["0"]["f_budget"]["storage_down"] == ["rw01"]
    # recovery emits member_up and restores the budget
    next(s for s in srcs if s.name == "b02").up = True
    doc = coll.scrape_once()
    assert doc["shards"]["1"]["f_budget"]["remaining"] == 1
    assert any(a["kind"] == "member_up" for a in doc["anomalies"])


def test_counter_deltas_become_anomalies_once():
    srcs = _two_shard_fleet()
    coll = FleetCollector(srcs)
    coll.scrape_once()
    a01 = srcs[0]
    a01.snap = {"server.wrong_shard{shard=0}": 3, "server.equivocation": 1}
    doc = coll.scrape_once()
    got = {
        (a["kind"], a["source"], a["shard"], a["count"])
        for a in doc["anomalies"]
    }
    assert ("wrong_shard", "a01", 0, 3) in got
    assert ("equivocation", "a01", 0, 1) in got
    # unchanged counters do not re-fire
    n = len(coll.anomalies())
    coll.scrape_once()
    assert len(coll.anomalies()) == n


def test_slo_histograms_merge_across_members_per_shard():
    srcs = _two_shard_fleet()
    bucket_of = lambda le: (
        f"client.write.latency.bucket{{shard=1,le={le}}}"
    )
    # two daemons each observed one write into the 0.25 bucket
    for s in srcs[4:6]:
        s.snap = {bucket_of(0.25): 1}
    coll = FleetCollector(srcs)
    doc = coll.scrape_once()
    slo = doc["shards"]["1"]["slo"]["write"]
    assert slo["count"] == 2
    assert slo["p50_le_s"] == 0.25
    assert slo["buckets"][BUCKETS.index(0.25)] == 2
    assert "write" not in doc["shards"]["0"]["slo"]


def test_slow_entries_become_shard_exemplars():
    srcs = _two_shard_fleet()
    srcs[0].slow = [
        {"trace_id": "abc", "root": "client.write", "duration": 2.0,
         "shard": 0, "peer": "a03"}
    ]
    coll = FleetCollector(srcs)
    doc = coll.scrape_once()
    [ex] = doc["shards"]["0"]["exemplars"]
    assert ex["trace_id"] == "abc" and ex["peer"] == "a03"
    assert doc["shards"]["1"]["exemplars"] == []


def test_fleet_http_endpoint_json_and_prometheus():
    from bftkv_tpu_torch.obs.http import serve_fleet

    coll = FleetCollector(_two_shard_fleet())
    coll.scrape_once()
    httpd = serve_fleet(coll, "127.0.0.1:0")
    port = httpd.server_address[1]
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/fleet", timeout=10
        ) as r:
            assert r.headers["content-type"].startswith("application/json")
            doc = json.loads(r.read())
        assert doc["fleet"]["daemons"] == 9
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/fleet",
            headers={"accept": "text/plain"},
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            text = r.read().decode()
        assert 'bftkv_fleet_f_budget_remaining{shard="0"} 1' in text
        assert 'bftkv_fleet_f_budget_remaining{shard="1"} 1' in text
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=10
        ) as r:
            assert r.read() == b"ok\n"
    finally:
        httpd.shutdown()


def test_local_metrics_feed_and_render():
    """The in-process feed path (nemesis mode): a process-wide registry
    backs counter-delta anomalies, and the CLI renderer accepts the
    document."""
    from bftkv_tpu_torch.cmd.fleet import render

    reg = Registry()
    coll = FleetCollector(_two_shard_fleet(), local_metrics=reg)
    coll.scrape_once()
    reg.incr("transport.peer.opens", 2)
    doc = coll.scrape_once()
    assert any(
        a["kind"] == "peer_circuit_open" and a["count"] == 2
        for a in doc["anomalies"]
    )
    text = render(doc)
    assert "shard 0" in text and "budget 1/1" in text


def test_fleet_prometheus_one_type_line_per_family():
    """A second '# TYPE' line for one metric name is a parse error in
    a real Prometheus server — multi-shard fleets must group samples
    per family (and histograms need a _sum for rate(sum)/rate(count))."""
    srcs = _two_shard_fleet()
    for s in srcs[:2]:
        s.snap = {
            "client.write.latency.bucket{shard=0,le=0.25}": 1,
            "client.write.latency.sum{shard=0}": 0.2,
        }
    for s in srcs[4:6]:
        s.snap = {
            "client.write.latency.bucket{shard=1,le=0.5}": 1,
            "client.write.latency.sum{shard=1}": 0.4,
        }
    coll = FleetCollector(srcs)
    coll.scrape_once()
    text = coll.prometheus()
    seen = set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            _, _, name, _typ = line.split()
            assert name not in seen, f"duplicate TYPE for {name}"
            seen.add(name)
    assert 'bftkv_fleet_shard_n{shard="0"} 4' in text
    assert 'bftkv_fleet_shard_n{shard="1"} 4' in text
    assert 'bftkv_fleet_write_latency_sum{shard="0"} 0.4' in text
    assert 'bftkv_fleet_write_latency_sum{shard="1"} 0.8' in text
    assert 'bftkv_fleet_write_latency_count{shard="0"} 2' in text
    doc = coll.health()
    assert doc["shards"]["0"]["slo"]["write"]["sum_s"] == 0.4


def test_info_refreshes_on_cadence_and_recovery():
    """Topology is not static: the collector re-fetches /info on a
    scrape cadence (and after a down→up transition) so membership
    churn reseats the health document instead of going stale."""
    srcs = _two_shard_fleet()
    coll = FleetCollector(srcs)
    coll.INFO_REFRESH_SCRAPES = 10**9  # cadence off for this test
    coll.scrape_once()
    mover = next(s for s in srcs if s.name == "a04")
    mover._info = dict(mover._info, shard=1)
    coll.scrape_once()
    # no refresh yet: still seated in shard 0
    assert any(
        m["name"] == "a04"
        for m in coll.health()["shards"]["0"]["members"]
    )
    coll.INFO_REFRESH_SCRAPES = 1  # every scrape is a refresh tick
    coll.scrape_once()
    doc = coll.health()
    assert any(
        m["name"] == "a04" for m in doc["shards"]["1"]["members"]
    )
    assert not any(
        m["name"] == "a04" for m in doc["shards"]["0"]["members"]
    )
    # recovery refresh: a member that went down and came back re-reads
    # its seat even with the cadence off
    coll.INFO_REFRESH_SCRAPES = 10**9
    mover.up = False
    coll.scrape_once()
    mover._info = dict(mover._info, shard=0)
    mover.up = True
    coll.scrape_once()  # up-transition marks stale...
    coll.scrape_once()  # ...next scrape re-fetches
    assert any(
        m["name"] == "a04"
        for m in coll.health()["shards"]["0"]["members"]
    )


def test_down_from_boot_member_is_unseated_not_misbinned():
    """A member that never answered /info has an UNKNOWN seat: binning
    it into shard 0 would let its real shard report a full f-budget
    with a clique member dark.  It must surface as fleet.unseated (and
    the CLI must refuse to call the fleet healthy)."""
    from bftkv_tpu_torch.cmd.fleet import _exit_code

    class DeadSource:
        name = "127.0.0.1:9"

        def info(self):
            raise OSError("connection refused")

        def metrics(self):
            raise OSError("connection refused")

        def trace_export(self, cursor):
            raise OSError("connection refused")

        def probe(self):
            return False

    srcs = _two_shard_fleet() + [DeadSource()]
    coll = FleetCollector(srcs)
    doc = coll.scrape_once()
    assert doc["fleet"]["unseated"] == ["127.0.0.1:9"]
    assert "127.0.0.1:9" in doc["fleet"]["down"]
    # no shard claims it, and no budget silently absorbs it
    for sd in doc["shards"].values():
        assert all(m["name"] != "127.0.0.1:9" for m in sd["members"])
        assert sd["f_budget"]["remaining"] == sd["f_budget"]["f"]
    assert _exit_code(doc) == 1


# -- across the packages ----------------------------------------------------


def _strip_ts(x):
    """``x`` less its wall-clock readings: timestamps and each member's
    measured scrape time."""
    if isinstance(x, dict):
        return {k: _strip_ts(v) for k, v in x.items() if k not in ("ts", "scrape_s", "last_ok_age_s")}
    if isinstance(x, list):
        return [_strip_ts(v) for v in x]
    return x


def _differences(a, b, path="") -> list:
    """Paths at which two JSON-like documents differ."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f"{path}/{k}: missing" for k in set(a) ^ set(b)]
        for k in set(a) & set(b):
            out += _differences(a[k], b[k], f"{path}/{k}")
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in _differences(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r:.200} != {b!r:.200}"]


def _scripted_scrapes(srcs, scrape):
    """Three scrapes of the two-shard fleet with merged SLO buckets,
    counter deltas, spans that stitch across members, slow exemplars,
    one then two dark clique members of shard 1 (its budget below 0) and
    a dark storage node; ``scrape`` is called
    after each script step with the step number."""
    import random

    rng = random.Random(15)
    for i in range(3):
        for k, s in enumerate(srcs):
            sh = 0 if s.name[0] in "ar" else 1
            le = BUCKETS[rng.randrange(len(BUCKETS))]
            s.snap = {
                f"client.write.latency.bucket{{shard={sh},le={le}}}": i + 1,
                f"client.read.latency.bucket{{shard={sh},le=0.05}}": 2 * i,
                f"client.write.latency.sum{{shard={sh}}}": 0.3 * (i + 1),
                "server.equivocation": i,
                f"server.wrong_shard{{shard={sh}}}": i * k,
                "transport.peer.opens": i,
            }
            s.spans = [
                _span(f"t{i}", f"r{i}", "client.write", duration=0.4,
                      attrs={"shard": sh}),
                _span(f"t{i}", f"c{i}{k}", "rpc.write", parent=f"r{i}",
                      duration=0.1),
            ] if k < 3 else []
            s.slow = [{"trace_id": f"t{i}", "root": "client.write",
                       "duration": 1.5, "shard": sh, "peer": "a02"}] if k == 0 else []
        srcs[5].up = i == 0
        srcs[6].up = i != 2
        srcs[8].up = i == 0
        scrape(i)


def test_fleet_documents_equal_the_references():
    """Both packages' collectors over the same scripted members give
    equal /fleet documents (less wall-clock readings), equal Prometheus text,
    and both ``cmd.fleet`` renderers the same text, budget and capacity
    tables, watch line and exit code."""
    from bftkv_tpu.cmd import fleet as ref_cli
    from bftkv_tpu.obs import FleetCollector as RefCollector
    from bftkv_tpu_torch.cmd import fleet as cli

    srcs = _two_shard_fleet()
    port, ref = FleetCollector(srcs), RefCollector(srcs)
    codes = []

    def scrape(_i):
        dp, dr = port.scrape_once(), ref.scrape_once()
        assert not _differences(_strip_ts(dp), _strip_ts(dr))
        assert port.prometheus() == ref.prometheus()
        # Both renderers on one document (it carries wall-clock readings).
        for fn in ("render", "render_budget", "render_capacity"):
            assert getattr(cli, fn)(dp) == getattr(ref_cli, fn)(dp), fn
        # The watch line opens with the wall clock's [HH:MM:SS].
        assert cli._watch_line(dp)[10:] == ref_cli._watch_line(dp)[10:]
        codes.append((cli._exit_code(dp), ref_cli._exit_code(dr)))

    _scripted_scrapes(srcs, scrape)
    assert _strip_ts(port.health()) == _strip_ts(ref.health())
    assert _strip_ts(port.anomalies()) == _strip_ts(ref.anomalies())
    assert [c for c, _r in codes] == [c for _c, c in codes]
    assert {c for c, _r in codes} >= {0, 1}
    doc = port.health()
    assert doc["shards"]["0"]["slo"]["write"]["count"] > 0
    assert doc["traces"]["stitched"] >= 1
    for tid in ("t0", "t1", "t2", "nope"):
        assert port.stitcher.tree(tid) == ref.stitcher.tree(tid)


def test_fleet_http_hostile_probes():
    """The /fleet surface over garbage: unknown trace ids (percent-encoded,
    oversized, with a query) answer 404, unknown endpoints 404, and the
    collector keeps serving after each."""
    import urllib.error

    from bftkv_tpu_torch.obs.http import serve_fleet

    coll = FleetCollector(_two_shard_fleet())
    coll.scrape_once()
    httpd = serve_fleet(coll, "127.0.0.1:0")
    port = httpd.server_address[1]
    try:
        for path in ("/fleet/trace/garbage", "/fleet/trace/%00%ff", "/fleet/trace/" + "x" * 4000,
                     "/fleet/trace/?since=abc", "/nope", "/fleet/bundle"):
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10)
                raise AssertionError(f"{path} answered 200")
            except urllib.error.HTTPError as e:
                assert e.code == 404, (path, e.code)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/fleet/bundle", data=b"", method="POST")
        try:
            urllib.request.urlopen(req, timeout=10)
            raise AssertionError("demand bundle without a recorder answered 200")
        except urllib.error.HTTPError as e:
            assert e.code == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet?format=prometheus", timeout=10) as r:
            assert r.read().decode() == coll.prometheus()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/fleet/capacity", timeout=10) as r:
            assert json.loads(r.read()) == json.loads(json.dumps(coll.health().get("capacity") or {}))
    finally:
        httpd.shutdown()


# -- a live 2-shard loopback cluster (tests/test_fleet_cluster.py) ----------------


import pytest  # noqa: E402


@pytest.fixture(scope="module")
def fleet():
    from bftkv_tpu_torch.metrics import registry
    from bftkv_tpu_torch.obs import LocalSource
    from test_torch_utils import start_cluster

    cl = start_cluster(4, 1, 4, n_shards=2)
    idents = cl.universe.servers + cl.universe.storage_nodes
    sources = [
        LocalSource(ident.name, (lambda s=srv: s))
        for ident, srv in zip(idents, cl.all_servers)
    ]
    coll = FleetCollector(
        sources, local_metrics=registry, local_tracer=trace.tracer
    )
    yield cl, coll
    cl.stop()


def _shard_key(client, shard, tag=b"fleet"):
    i = 0
    while i < 4096:
        k = b"%s/%d" % (tag, i)
        if client.qs.shard_of(k) == shard:
            return k
        i += 1
    raise AssertionError("no key for shard")


def test_scrape_aggregate_f_budget(fleet):
    cl, coll = fleet
    c = cl.clients[0]
    for sh in (0, 1):
        c.write(_shard_key(c, sh), b"v")
    doc = coll.scrape_once()
    assert set(doc["shards"]) == {"0", "1"}
    for sh, sd in doc["shards"].items():
        assert (sd["n"], sd["f"], sd["threshold"]) == (4, 1, 3)
        assert sd["f_budget"] == {
            "f": 1, "used": 0, "remaining": 1, "down": [],
            "storage_down": [],
        }
        # The routed writes produced a per-shard merged write SLO: the
        # port registry's fixed-bucket keys reach the collector.
        assert sd["slo"]["write"]["count"] >= 1
    assert doc["traces"]["traces"] >= 2
    assert doc["fleet"]["up"] == 16


def test_kill_one_replica_decrements_exactly_that_shard(fleet):
    cl, coll = fleet
    victim_name = None
    for srv in cl.servers:
        if srv.qs.my_shard() == 1:
            victim_name = srv.self_node.name
            srv.tr.stop()
            break
    assert victim_name
    doc = coll.scrape_once()
    assert doc["shards"]["1"]["f_budget"]["used"] == 1
    assert doc["shards"]["1"]["f_budget"]["remaining"] == 0
    assert doc["shards"]["1"]["f_budget"]["down"] == [victim_name]
    assert doc["shards"]["0"]["f_budget"] == {
        "f": 1, "used": 0, "remaining": 1, "down": [], "storage_down": [],
    }
    assert any(
        a["kind"] == "member_down"
        and a["source"] == victim_name
        and a["shard"] == 1
        for a in doc["anomalies"]
    )
    c = cl.clients[0]
    k = _shard_key(c, 1, tag=b"fleet/degraded")
    c.write(k, b"still-live")
    assert c.read(k) == b"still-live"


def test_fleet_endpoint_serves_the_same_budget(fleet):
    from bftkv_tpu_torch.obs.http import serve_fleet

    _cl, coll = fleet
    httpd = serve_fleet(coll, "127.0.0.1:0")
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/fleet", timeout=10
        ) as r:
            doc = json.loads(r.read())
        assert doc["shards"]["1"]["f_budget"]["remaining"] == 0
        assert doc["shards"]["0"]["f_budget"]["remaining"] == 1
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/fleet",
            headers={"accept": "text/plain"},
        )
        with urllib.request.urlopen(req, timeout=10) as r:
            text = r.read().decode()
        assert 'bftkv_fleet_f_budget_remaining{shard="1"} 0' in text
    finally:
        httpd.shutdown()


# -- WAN smoke (tests/test_wan_smoke.py) -------------------------------------------


@pytest.fixture(scope="module")
def wan_fleet():
    from bftkv_tpu_torch import transport as tp
    from bftkv_tpu_torch.faults import failpoint as fp
    from bftkv_tpu_torch.regions.topology import install_matrix
    from test_torch_utils import start_cluster

    tp.peer_latency.reset()
    tp.peer_health.reset()
    cluster = start_cluster(4, 2, 4, n_gateways=1, n_regions=2)
    reg = fp.arm(5)
    matrix, _program = install_matrix(reg, "wan2")
    yield cluster, reg, matrix
    fp.disarm()
    cluster.stop()
    tp.peer_latency.reset()
    tp.peer_health.reset()


def _p50(lats: list[float]) -> float:
    s = sorted(lats)
    return s[len(s) // 2]


def test_same_region_gateway_read_at_cache_latency(wan_fleet):
    import time

    cluster, _reg, _matrix = wan_fleet
    uni = cluster.universe
    assert uni.users[0].region == uni.gateways[0].region
    assert uni.users[1].region != uni.gateways[0].region
    gw_same = cluster.gateway_client(0)
    gw_cross = cluster.gateway_client(1)

    gw_same.write(b"wan/smoke", b"v1")
    assert gw_same.read(b"wan/smoke") == b"v1"  # warm the edge cache

    same, cross = [], []
    for _ in range(9):
        t0 = time.perf_counter()
        assert gw_same.read(b"wan/smoke") == b"v1"
        same.append(time.perf_counter() - t0)
    for _ in range(5):
        t0 = time.perf_counter()
        assert gw_cross.read(b"wan/smoke") == b"v1"
        cross.append(time.perf_counter() - t0)
    # One intra-region hop (~10 ms one-way under wan2) against a fan-out
    # of at least 30 ms more: the reference's bound.
    assert _p50(same) < 0.035, f"same-region read p50 {_p50(same):.4f}s"
    assert _p50(cross) > _p50(same)


def test_region_rows_in_health_and_fleet_render(wan_fleet):
    from collections import Counter

    from bftkv_tpu_torch import regions as rg
    from bftkv_tpu_torch.cmd.fleet import render as fleet_render
    from bftkv_tpu_torch.obs import LocalSource

    cluster, _reg, _matrix = wan_fleet
    uni = cluster.universe
    idents = uni.servers + uni.storage_nodes
    sources = [
        LocalSource(ident.name, lambda s=srv: s)
        for ident, srv in zip(idents, cluster.all_servers)
    ]
    for gw in cluster.gateways:
        sources.append(LocalSource(gw.self_node.name, lambda g=gw: g))
    coll = FleetCollector(sources)
    coll.scrape_once()
    doc = coll.health()

    regs = doc["regions"]
    assert regs["n"] == 2
    expected = Counter(
        i.region for i in uni.servers + uni.storage_nodes + uni.gateways
    )
    assert set(regs["rows"]) == set(expected)
    for r, row in regs["rows"].items():
        assert row["members"] == expected[r]
        assert row["up"] == row["members"]
        assert row["down"] == [] and not row["dark"]
    gw_region = uni.gateways[0].region
    assert regs["rows"][gw_region]["gateways"] == [uni.gateways[0].name]
    assert regs["f_budget"]["f"] == 0
    assert regs["f_budget"]["remaining"] == 0
    assert regs["f_budget"]["dark"] == []
    assert not [a for a in coll.anomalies() if a["kind"] == "region_down"]

    out = fleet_render(doc)
    assert "regions: 2" in out
    for r, row in regs["rows"].items():
        assert f"{r}: {row['up']}/{row['members']} up" in out
    assert sorted(regs["rows"]) == rg.regionmap.regions()
