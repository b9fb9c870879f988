"""The port's critical-path attribution (``bftkv_tpu_torch/obs/critpath``)
against the reference's ``tests/test_critpath.py``, plus a cross check
(the same trace trees give JSON-equal attributions and budgets in both
packages): hand-built
trace trees with known exclusive times, overlap/straggler semantics,
child clipping, p99-exemplar selection, histogram merge across
members — plus the collector's one-scrape-deferred attribution pass,
the SLO burn-rate anomaly hysteresis, and the loopback acceptance bar
(per-phase exclusive times sum to the root span's duration)."""

from __future__ import annotations

import pytest

from bftkv_tpu_torch import trace
from bftkv_tpu_torch.metrics import BUCKETS
from bftkv_tpu_torch.obs import FleetCollector
from bftkv_tpu_torch.obs.critpath import PhaseBudget, attribute
from bftkv_tpu_torch.trace import PHASES, phase_of

from test_torch_utils import start_cluster


def sp(name, start, dur, *, span, parent=None, trace_id="t1",
       phase=None, attrs=None):
    d = {"trace": trace_id, "span": span, "name": name,
         "start": float(start), "duration": float(dur)}
    if parent is not None:
        d["parent"] = parent
    if phase is not None:
        d["phase"] = phase
    if attrs:
        d["attrs"] = attrs
    return d


def _bd(op="write", shard=0, root_s=1.0, phases=None, tid="t"):
    phases = phases or {"rpc": root_s}
    return {"op": op, "shard": shard, "trace_id": tid, "root_s": root_s,
            "phases": phases, "attributed_s": sum(phases.values())}


# -- the phase registry -----------------------------------------------------


def test_phase_registry_closed_enum():
    assert set(PHASES) == {
        "lease", "fanout", "rpc", "server", "dispatch", "sidecar",
        "combine", "backfill", "other",
    }
    assert phase_of("presession.lease") == "lease"
    assert phase_of("rpc.write_sign") == "rpc"  # prefix rule
    assert phase_of("sidecar.call") == "sidecar"
    # longest prefix wins: sync.repair.backfill is the back-fill tail,
    # not generic sync work
    assert phase_of("sync.repair.backfill") == "backfill"
    assert phase_of("sync.pull") == "other"
    # outside the registry: lands in "other" at runtime (bftlint keeps
    # that set empty in-tree)
    assert phase_of("totally.unknown") == "other"


# -- one-trace attribution --------------------------------------------------


def test_exclusive_times_known_tree():
    spans = [
        sp("client.write", 0.0, 1.0, span="r", attrs={"shard": 2}),
        sp("presession.lease", 0.0, 0.2, span="a", parent="r"),
        sp("phase.write_sign", 0.2, 0.7, span="b", parent="r"),
        sp("rpc.write_sign", 0.3, 0.5, span="c", parent="b"),
    ]
    bd = attribute(spans)
    assert bd["op"] == "write" and bd["shard"] == 2
    assert bd["root_s"] == pytest.approx(1.0)
    ph = bd["phases"]
    assert ph["lease"] == pytest.approx(0.2)
    assert ph["rpc"] == pytest.approx(0.5)
    # fan-out self time = round span minus its rpc child
    assert ph["fanout"] == pytest.approx(0.2)
    # root self time (0.9..1.0) is "other"
    assert ph["other"] == pytest.approx(0.1)
    assert sum(ph.values()) == pytest.approx(bd["root_s"])
    assert bd["attributed_s"] == pytest.approx(bd["root_s"])


def test_overlapping_siblings_straggler_owns_overlap():
    # sidecar [0.0, 0.6] and rpc [0.2, 0.8] overlap on [0.2, 0.6]; the
    # LAST-ENDING sibling (the straggler the caller waited on) claims
    # it — rpc gets 0.6, sidecar only its un-overlapped 0.2.
    spans = [
        sp("client.write", 0.0, 1.0, span="r"),
        sp("sidecar.call", 0.0, 0.6, span="a", parent="r"),
        sp("rpc.write_sign", 0.2, 0.6, span="b", parent="r"),
    ]
    ph = attribute(spans)["phases"]
    assert ph["rpc"] == pytest.approx(0.6)
    assert ph["sidecar"] == pytest.approx(0.2)
    assert ph["other"] == pytest.approx(0.2)
    assert sum(ph.values()) == pytest.approx(1.0)


def test_overlapping_same_phase_counted_once():
    # Two parallel RPCs [0, 0.6] + [0.2, 0.8]: union is 0.8 seconds of
    # wall clock, never the 1.2 a naive per-span sum would claim.
    spans = [
        sp("client.write", 0.0, 1.0, span="r"),
        sp("rpc.write_sign", 0.0, 0.6, span="a", parent="r"),
        sp("rpc.write_sign", 0.2, 0.6, span="b", parent="r"),
    ]
    ph = attribute(spans)["phases"]
    assert ph["rpc"] == pytest.approx(0.8)
    assert sum(ph.values()) == pytest.approx(1.0)


def test_child_outliving_root_is_clipped():
    # An async back-fill tail outlives the root (early commit): only
    # its in-window slice [0.9, 1.0] enters the budget, so the phase
    # sum still equals the root duration exactly.
    spans = [
        sp("client.write", 0.0, 1.0, span="r"),
        sp("backfill.record", 0.9, 1.6, span="a", parent="r"),
    ]
    ph = attribute(spans)["phases"]
    assert ph["backfill"] == pytest.approx(0.1)
    assert sum(ph.values()) == pytest.approx(1.0)


def test_clock_skewed_child_outside_window_drops_to_parent():
    # Cross-process skew pushed the stitched child entirely outside the
    # root's window: it attributes nothing (coarser, never double).
    spans = [
        sp("client.write", 0.0, 1.0, span="r"),
        sp("server.write_sign", 5.0, 0.3, span="a", parent="r"),
    ]
    ph = attribute(spans)["phases"]
    assert ph["server"] == 0.0
    assert ph["other"] == pytest.approx(1.0)


def test_explicit_phase_attr_wins_over_registry():
    spans = [
        sp("client.write", 0.0, 1.0, span="r"),
        sp("verify:flush", 0.0, 0.3, span="a", parent="r",
           phase="dispatch"),
    ]
    ph = attribute(spans)["phases"]
    assert ph["dispatch"] == pytest.approx(0.3)


def test_non_root_traces_return_none():
    assert attribute([]) is None
    # a server-only fragment (root never stitched in) has no budget
    assert attribute(
        [sp("server.write_sign", 0.0, 0.5, span="a", parent="gone")]
    ) is None
    # batch roots are deliberately outside ROOT_OPS
    assert attribute(
        [sp("client.write_many", 0.0, 0.5, span="r")]
    ) is None


def test_read_root_reports_as_read():
    bd = attribute([sp("client.read_certified", 0.0, 0.2, span="r")])
    assert bd["op"] == "read"
    assert bd["phases"]["other"] == pytest.approx(0.2)


# -- aggregation: histograms + exemplars ------------------------------------


def test_budget_doc_counts_and_shares():
    pb = PhaseBudget()
    for _ in range(4):
        pb.observe(_bd(shard=1, root_s=0.4,
                       phases={"rpc": 0.3, "other": 0.1}))
    d = pb.doc()["write"][1]
    assert d["count"] == 4
    assert d["root_sum_s"] == pytest.approx(1.6)
    assert d["phases"]["rpc"]["share"] == pytest.approx(0.75)
    assert d["phases"]["other"]["share"] == pytest.approx(0.25)
    assert sum(d["phases"]["rpc"]["buckets"]) == 4


def test_p99_exemplar_is_a_straggler_not_the_mean():
    pb = PhaseBudget(max_exemplars=4)
    for i in range(100):
        pb.observe(_bd(root_s=0.01, phases={"rpc": 0.01},
                       tid=f"fast{i}"))
    for i in range(5):
        pb.observe(_bd(root_s=2.0, phases={"server": 2.0},
                       tid=f"slow{i}"))
    d = pb.doc()["write"][0]
    ex = d["p99_exemplar"]
    # the exemplar's breakdown is a slow trace's — all server time —
    # even though 100/105 observations were fast rpc-bound writes
    assert ex["root_s"] == pytest.approx(2.0)
    assert set(ex["phases"]) == {"server"}
    assert ex["trace_id"].startswith("slow")
    assert d["root_p99_le_s"] >= 2.0


def test_histogram_merge_across_members():
    a, b = PhaseBudget(), PhaseBudget()
    a.observe(_bd(root_s=0.1, phases={"rpc": 0.1}, tid="m1"))
    b.observe(_bd(root_s=1.0, phases={"server": 1.0}, tid="m2"))
    b.observe(_bd(op="read", shard=1, root_s=0.2,
                  phases={"rpc": 0.2}, tid="m3"))
    a.merge(b)
    doc = a.doc()
    d = doc["write"][0]
    assert d["count"] == 2
    assert d["root_sum_s"] == pytest.approx(1.1)
    # bucket vectors summed, both phases present
    assert sum(d["phases"]["rpc"]["buckets"]) == 1
    assert sum(d["phases"]["server"]["buckets"]) == 1
    # exemplars re-ranked across members: the merged p99 exemplar is
    # the other member's slow trace
    assert d["p99_exemplar"]["trace_id"] == "m2"
    assert doc["read"][1]["count"] == 1
    # merge is summation on the fixed ladder: merging into a fresh
    # budget reproduces the same doc
    c = PhaseBudget()
    c.merge(a)
    assert c.doc()["write"][0]["root_sum_s"] == pytest.approx(1.1)


# -- the collector's deferred attribution pass ------------------------------


_CLIQUE = {"n": 4, "f": 1, "threshold": 3, "suff": 3,
           "members": ["a01", "a02", "a03", "a04"]}


class _Src:
    """A scriptable member whose /trace feed drains per scrape."""

    def __init__(self, name, spans_by_scrape, ring_dropped=0):
        self.name = name
        self._spans = list(spans_by_scrape)
        self._cursor = 0
        self.ring_dropped = ring_dropped
        self._info = {"name": name, "shard": 0, "shard_count": 1,
                      "role": "clique", "clique": _CLIQUE,
                      "owned_buckets": 128}

    def info(self):
        return self._info

    def metrics(self):
        return {}

    def probe(self):
        return True

    def trace_export(self, cursor):
        spans = self._spans.pop(0) if self._spans else []
        self._cursor += len(spans)
        return {"cursor": self._cursor, "dropped": 0, "spans": spans,
                "slow": [], "ring_dropped": self.ring_dropped,
                "slow_dropped": 0}


def test_collector_attributes_one_scrape_after_root():
    # Scrape 1 carries the client-side tree; the server's stitched
    # fragment only lands on scrape 2 — attribution must wait for it.
    client_spans = [
        sp("client.write", 0.0, 1.0, span="r", attrs={"shard": 0}),
        sp("rpc.write_sign", 0.1, 0.8, span="c", parent="r"),
    ]
    server_spans = [
        sp("server.write_sign", 0.2, 0.5, span="s", parent="c"),
    ]
    srcs = [
        _Src("a01", [client_spans, []], ring_dropped=3),
        _Src("a02", [[], server_spans]),
    ]
    coll = FleetCollector(srcs)
    doc1 = coll.scrape_once()
    assert doc1["write_budget_by_phase"] == {}
    doc2 = coll.scrape_once()
    budget = doc2["write_budget_by_phase"][0]
    assert budget["count"] == 1
    ph = {p: d["sum_s"] for p, d in budget["phases"].items()}
    # the late-arriving server fragment made it into the budget
    assert ph["server"] == pytest.approx(0.5, abs=1e-6)
    assert ph["rpc"] == pytest.approx(0.3, abs=1e-6)
    assert sum(ph.values()) == pytest.approx(1.0, abs=1e-6)
    # the per-shard view is the same budget
    assert doc2["shards"]["0"]["budget"]["write"]["count"] == 1
    # ring-drop satellites: members' self-reported overwrite counts
    # aggregate fleet-wide instead of dying in per-daemon counters
    assert doc2["fleet"]["trace_drops"]["ring"] == 3
    prom = coll.prometheus()
    assert "bftkv_fleet_phase_seconds_bucket" in prom
    assert 'phase="rpc"' in prom
    assert "bftkv_fleet_trace_ring_dropped 3" in prom


# -- SLO burn rate ----------------------------------------------------------


def _vec(fast=0, slow=0):
    v = [0] * (len(BUCKETS) + 1)
    v[0] = fast                       # ≤ 1 ms bucket
    v[BUCKETS.index(2.5)] = slow      # ≤ 2.5 s bucket, over any sane SLO
    return v


def test_slo_burn_needs_k_consecutive_breaches(monkeypatch):
    monkeypatch.setenv("BFTKV_SLO_WRITE_P99", "0.5")
    monkeypatch.setenv("BFTKV_SLO_BURN_SCRAPES", "3")
    coll = FleetCollector([])
    seen: list = []
    coll.add_anomaly_listener(seen.append)
    fast, slow = 0, 0

    def scrape(d_fast=0, d_slow=0):
        nonlocal fast, slow
        fast += d_fast
        slow += d_slow
        coll._slo_burn_check({(0, "write"): _vec(fast, slow)})

    def burns():
        return [a for a in seen if a["kind"] == "slo_burn"]

    scrape(d_slow=1)          # breach 1
    scrape(d_slow=1)          # breach 2
    assert burns() == []      # one (or two) slow scrapes never page
    scrape()                  # idle: no traffic, burn count HOLDS
    assert burns() == []
    scrape(d_slow=1)          # breach 3 -> fires
    assert len(burns()) == 1
    assert burns()[0]["shard"] == 0
    scrape(d_slow=1)          # still burning: fires once per episode
    assert len(burns()) == 1
    scrape(d_fast=50)         # healthy scrape re-arms the hysteresis
    scrape(d_slow=1)
    scrape(d_slow=1)
    assert len(burns()) == 1  # re-armed: two breaches are not three
    scrape(d_slow=1)
    assert len(burns()) == 2  # a second full episode fires again


def test_slo_burn_disabled_without_flag(monkeypatch):
    monkeypatch.delenv("BFTKV_SLO_WRITE_P99", raising=False)
    coll = FleetCollector([])
    seen: list = []
    coll.add_anomaly_listener(seen.append)
    for _ in range(5):
        coll._slo_burn_check({(0, "write"): _vec(slow=100)})
    assert seen == []


# -- loopback acceptance: budgets sum to the root ---------------------------


def test_loopback_write_budget_sums_to_root():
    """The acceptance bar: on a real loopback cluster_4 write, the
    per-phase exclusive times sum to within 10% of the root span's
    duration (by construction they match exactly), and the budget
    actually attributes time to real phases."""
    t = trace.Tracer()
    old, trace.tracer = trace.tracer, t
    cluster = start_cluster(4, 1, 4, bits=1024)
    try:
        cl = cluster.clients[0]
        cl.write(b"critpath/warm", b"v0")
        cl.drain_tails()
        cur = t.export(0)["cursor"]
        for i in range(3):
            cl.write(b"critpath/%d" % i, b"payload-%d" % i)
        cl.drain_tails()
        spans = t.export(cur)["spans"]
    finally:
        cluster.stop()
        trace.tracer = old
    traces: dict[str, list] = {}
    for s in spans:
        traces.setdefault(s["trace"], []).append(s)
    budgets = [
        bd for bd in (attribute(v) for v in traces.values())
        if bd is not None and bd["op"] == "write"
    ]
    assert len(budgets) == 3
    for bd in budgets:
        assert bd["root_s"] > 0
        gap = abs(sum(bd["phases"].values()) - bd["root_s"])
        assert gap <= 0.10 * bd["root_s"] + 1e-9
        assert set(bd["phases"]) == set(PHASES)
    # the decomposition is non-degenerate: real fan-out/rpc time was
    # attributed, not everything lumped into "other"
    total = sum(bd["root_s"] for bd in budgets)
    named = sum(
        v for bd in budgets for p, v in bd["phases"].items()
        if p != "other"
    )
    assert named > 0.25 * total


# -- across the packages ----------------------------------------------------


def test_attribution_and_budgets_equal_the_references():
    """The same seeded trace trees (random nesting, overlap, clock-skewed
    and overrunning children, explicit phase attrs) give JSON-equal
    breakdowns from both packages' ``attribute``, and the same breakdowns
    fed to both ``PhaseBudget``s (with a merge) give equal documents."""
    import json
    import random

    from bftkv_tpu.obs.critpath import PhaseBudget as RefBudget
    from bftkv_tpu.obs.critpath import attribute as ref_attribute

    rng = random.Random(15)
    names = ["client.write", "client.read", "rpc.write", "server.write",
             "crypto.verify", "storage.put", "fanout", "x.unknown"]
    port_b, ref_b = PhaseBudget(), RefBudget()
    port_m, ref_m = PhaseBudget(), RefBudget()
    seen = 0
    for t in range(60):
        tid = f"tr{t}"
        root = {"trace": tid, "span": "r", "name": rng.choice(names[:2]),
                "start": 100.0, "duration": rng.uniform(0.01, 2.0),
                "attrs": {"shard": rng.randrange(2)}}
        spans = [root]
        for k in range(rng.randrange(8)):
            parent = rng.choice(spans)
            s = {"trace": tid, "span": f"s{k}", "parent": parent["span"],
                 "name": rng.choice(names[2:]),
                 "start": parent["start"] + rng.uniform(-0.2, parent["duration"]),
                 "duration": rng.uniform(0.0, 1.5)}
            if rng.random() < 0.2:
                s["attrs"] = {"phase": rng.choice(PHASES)}
            spans.append(s)
        if t % 7 == 0:
            spans = spans[1:] or spans  # no root: None in both
        rng.shuffle(spans)
        got, want = attribute(spans), ref_attribute(spans)
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        if got is not None:
            seen += 1
            (port_b if t % 2 else port_m).observe(got)
            (ref_b if t % 2 else ref_m).observe(want)
    assert seen > 30
    port_b.merge(port_m)
    ref_b.merge(ref_m)
    assert json.dumps(port_b.doc(), sort_keys=True) == json.dumps(ref_b.doc(), sort_keys=True)
    assert PhaseBudget.fleet_shares(port_b.doc()) == RefBudget.fleet_shares(ref_b.doc())
