"""The port's capacity plane (``bftkv_tpu_torch/obs/capacity``) against
the reference's ``tests/test_capacity.py``, plus a cross check (the same
member snapshots give JSON-equal rows in both packages): USE rows from induced
saturation, the bottleneck verdict, device-occupancy parity, and the
``resource_saturated`` hysteresis — plus the loopback fleet scrape the
CI capacity smoke step asserts against."""

from __future__ import annotations

import threading
import time

import pytest

from bftkv_tpu_torch.admission import AdmissionQueue
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.metrics import Registry, registry as metrics
from bftkv_tpu_torch.obs import FleetCollector
from bftkv_tpu_torch.obs.capacity import CapacityPlane, RESOURCE_PHASES, RESOURCES


@pytest.fixture(autouse=True)
def _clean_registry():
    """Capacity reads the process registry; every test starts and ends
    with a blank one (and a disarmed failpoint registry) so induced
    saturation cannot bleed across tests."""
    metrics.reset()
    fp.disarm()
    yield
    fp.disarm()
    metrics.reset()


def _observe_twice(cp: CapacityPlane, member: str = "m") -> dict:
    """Baseline-then-read: the first scrape seeds the counter-delta
    baseline from an empty snapshot, so the second scrape's deltas
    equal the totals accumulated by the test body."""
    cp.observe(member, {}, now=0.0)
    return cp.observe(member, metrics.snapshot(), now=1.0)


# -- vocabulary closure -----------------------------------------------------


def test_resource_vocabulary_is_closed_and_mapped():
    """Every resource maps to phases (the verdict join) and nothing
    else does — adding a resource without the mapping is the schema
    drift the closed vocabulary exists to prevent."""
    assert set(RESOURCE_PHASES) == set(RESOURCES)
    from bftkv_tpu_torch.trace import PHASES

    for res, phases in RESOURCE_PHASES.items():
        for p in phases:
            assert p in PHASES, f"{res} maps to unknown phase {p}"


# -- seeded induction: admission --------------------------------------------


def test_shrunk_sidecar_admission_names_admission():
    """A sidecar AdmissionQueue shrunk to one slot + one queue slot
    under 4 concurrent holders saturates: waiters queue, one sheds, and
    the verdict names admission."""
    q = AdmissionQueue(
        max_inflight=1, max_queue=1, max_wait=0.05, metric="sidecar.shed"
    )
    assert q.acquire("sign")  # holds the only slot for the duration
    results = []

    def contender():
        results.append(q.acquire("sign"))

    threads = [threading.Thread(target=contender) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not any(results)  # all queued-then-timed-out or shed
    cp = CapacityPlane()
    rows = _observe_twice(cp)
    adm = rows["admission"]
    assert adm["utilization"] == 1.0
    assert adm["saturation"] == 1.0
    assert adm["errors"] >= 1  # instant sheds past the queue limit
    assert adm["tiers"]["sidecar"]["shed"] >= 1
    v = cp.verdict()
    assert v["top"]["resource"] == "admission"
    assert "admission on m limits throughput" in v["summary"]
    q.release()


def test_admission_verdict_survives_phase_join():
    """With a real phase-share join the admission verdict stands when
    the budget says time is spent in the phases admission backs."""
    q = AdmissionQueue(
        max_inflight=1, max_queue=1, max_wait=0.01, metric="sidecar.shed"
    )
    assert q.acquire("sign")
    assert not q.acquire("sign")  # queue empty+held → instant shed path
    cp = CapacityPlane()
    _observe_twice(cp)
    v = cp.verdict({"server": 0.4, "sidecar": 0.3, "rpc": 0.3})
    assert v["top"]["resource"] == "admission"
    assert v["top"]["phase_weight"] == pytest.approx(0.7)
    q.release()


# -- seeded induction: log-commit path --------------------------------------


def test_stalled_fsync_names_log_commit(tmp_path):
    """Stalling the durability barrier via the storage.fsync failpoint
    drives commit-wait p99 past the saturation reference: the verdict
    names the commit path."""
    from bftkv_tpu_torch.storage.logkv import LogStorage

    st = LogStorage(str(tmp_path / "db"), group_commit_s=0.0)
    try:
        fp.registry.arm(0)
        fp.registry.add("storage.fsync", "stall", seconds=0.3)
        st.write(b"k", 1, b"v")
    finally:
        fp.disarm()
        st.close()
    cp = CapacityPlane()
    rows = _observe_twice(cp)
    lc = rows["log_commit"]
    assert lc["saturation"] == 1.0
    assert lc["commit_wait_p99_s"] >= 0.3
    v = cp.verdict()
    assert v["top"]["resource"] == "log_commit"
    assert "log_commit on m limits throughput" in v["summary"]


# -- device-occupancy parity ------------------------------------------------


def test_device_occupancy_matches_items_per_launch(keys64):
    """The occupancy gauge must agree with the dispatcher's own
    items/flushes counters: occupancy == (items per launch) / max_batch
    when every flush fits one launch."""
    from bftkv_tpu_torch.crypto import rsa
    from bftkv_tpu_torch.ops import dispatch

    key = keys64
    d = dispatch.VerifyDispatcher(
        max_batch=8, max_wait=0.01, calibrate=False, device="cpu"
    ).start()
    try:
        msgs = [b"m%d" % i for i in range(4)]
        items = [(m, rsa.sign(m, key), key.public) for m in msgs]
        assert d.verify(items).all()
    finally:
        d.stop()
    cp = CapacityPlane()
    rows = _observe_twice(cp)
    disp = rows["dispatch"]["dispatchers"]["dispatch"]
    snap = metrics.snapshot()
    items_n = snap["dispatch.verifies"]
    flushes = snap["dispatch.flushes"]
    assert disp["items_per_launch"] == pytest.approx(items_n / flushes)
    occ = rows["dispatch"]["utilization"]
    assert occ == pytest.approx((items_n / flushes) / 8, abs=0.01)


@pytest.fixture(scope="module")
def keys64():
    from test_torch_utils import seeded_key

    return seeded_key(2048, 64)


# -- hysteresis -------------------------------------------------------------


def _saturated_snap(n_shed: float) -> dict:
    """A synthetic member snapshot with a saturated sidecar admission
    tier; bumping ``n_shed`` each scrape keeps it traffic-bearing."""
    return {
        "admission.limit{resource=sidecar}": 2.0,
        "admission.inflight{resource=sidecar}": 2.0,
        "admission.waiting{resource=sidecar}": 4.0,
        "admission.queue_limit{resource=sidecar}": 4.0,
        "sidecar.shed": n_shed,
        "admission.wait.count{resource=sidecar}": n_shed,
    }


def _healthy_snap(n: float) -> dict:
    return {
        "admission.limit{resource=sidecar}": 2.0,
        "admission.inflight{resource=sidecar}": 0.0,
        "admission.waiting{resource=sidecar}": 0.0,
        "admission.queue_limit{resource=sidecar}": 4.0,
        "sidecar.shed": 0.0,
        "admission.wait.count{resource=sidecar}": n,
    }


def test_resource_saturated_fires_once_per_episode(monkeypatch):
    """slo_burn's exact contract: k consecutive traffic-bearing
    breaching scrapes fire ONCE; staying saturated does not re-fire;
    a healthy scrape re-arms for the next episode."""
    monkeypatch.setenv("BFTKV_SAT_THRESHOLD", "0.8")
    monkeypatch.setenv("BFTKV_SAT_SCRAPES", "3")
    cp = CapacityPlane()
    shed = 0.0
    fired = []
    for i in range(5):
        shed += 1.0
        cp.observe("m", _saturated_snap(shed), now=float(i))
        fired.append(cp.check())
    # scrape 0 seeds the baseline (shed delta == total, still >0, so it
    # counts); fires exactly at the 3rd consecutive breach, then never
    # again while the episode persists
    assert [len(f) for f in fired] == [0, 0, 1, 0, 0]
    ev = fired[2][0]
    assert ev == {
        "member": "m",
        "resource": "admission",
        "saturation": 1.0,
        "utilization": 1.0,
    }
    # recovery re-arms: healthy scrape, then a fresh 3-breach episode
    cp.observe("m", _healthy_snap(shed + 1), now=5.0)
    assert cp.check() == []
    for i in range(3):
        shed += 1.0
        cp.observe("m", _saturated_snap(shed), now=6.0 + i)
        out = cp.check()
        assert len(out) == (1 if i == 2 else 0)


def test_idle_scrapes_hold_the_count(monkeypatch):
    """An idle scrape (no admission traffic) neither advances nor
    resets the hysteresis — idle can neither saturate nor recover."""
    monkeypatch.setenv("BFTKV_SAT_THRESHOLD", "0.8")
    monkeypatch.setenv("BFTKV_SAT_SCRAPES", "2")
    cp = CapacityPlane()
    cp.observe("m", _saturated_snap(1.0), now=0.0)
    assert cp.check() == []
    # identical snapshot: zero deltas → idle → count held, not reset
    cp.observe("m", _saturated_snap(1.0), now=1.0)
    assert cp.check() == []
    cp.observe("m", _saturated_snap(2.0), now=2.0)
    assert len(cp.check()) == 1


# -- fleet integration (the CI capacity smoke references this) --------------


def test_fleet_scrape_renders_capacity_and_emits_anomaly(monkeypatch):
    """Loopback fleet: the collector folds member metrics into the
    capacity section, health() carries it, render_capacity names the
    saturated resource, and sustained saturation surfaces in the
    anomaly feed as resource_saturated (recorder auto-bundle trigger)."""
    from bftkv_tpu_torch.cmd.fleet import render_capacity
    from test_torch_fleet import _two_shard_fleet

    monkeypatch.setenv("BFTKV_SAT_THRESHOLD", "0.8")
    monkeypatch.setenv("BFTKV_SAT_SCRAPES", "2")
    srcs = _two_shard_fleet()
    hot = next(s for s in srcs if s.name == "a01")
    reg = Registry()
    coll = FleetCollector(srcs, local_metrics=reg)
    shed = 0.0
    doc = None
    for _ in range(3):
        shed += 2.0
        hot.snap = _saturated_snap(shed)
        doc = coll.scrape_once()
    cap = doc["capacity"]
    assert cap["members"]["a01"]["admission"]["saturation"] == 1.0
    assert cap["fleet"]["admission"]["saturation"] == 1.0
    assert cap["verdict"]["top"]["resource"] == "admission"
    text = render_capacity(doc)
    assert "admission" in text and "verdict:" in text
    assert "a01" in text
    sat = [a for a in doc["anomalies"] if a["kind"] == "resource_saturated"]
    assert len(sat) == 1 and sat[0]["source"] == "a01"
    assert "admission" in sat[0]["detail"]


def test_fleet_prometheus_exports_resource_family():
    srcs_mod = __import__("tests.test_fleet", fromlist=["_two_shard_fleet"])
    srcs = srcs_mod._two_shard_fleet()
    hot = next(s for s in srcs if s.name == "b01")
    hot.snap = _saturated_snap(3.0)
    coll = FleetCollector(srcs)
    coll.scrape_once()
    text = coll.prometheus()
    assert "# TYPE bftkv_fleet_resource_saturation gauge" in text
    assert (
        'bftkv_fleet_resource_saturation{member="b01",resource="admission"}'
        in text
    )
    assert "bftkv_fleet_resource_verdict_score" in text


def test_capacity_forget_drops_member_state():
    cp = CapacityPlane()
    cp.observe("m", _saturated_snap(1.0), now=0.0)
    assert "m" in cp.doc()["members"]
    cp.forget("m")
    assert cp.doc() == {"members": {}, "fleet": {}}


def test_verdict_without_saturation_reports_next_wall():
    """Nothing queued anywhere: the verdict degrades to naming the
    fullest resource instead of inventing a bottleneck."""
    cp = CapacityPlane()
    cp.observe(
        "m",
        {
            "admission.limit{resource=gateway}": 4.0,
            "admission.inflight{resource=gateway}": 2.0,
            "admission.waiting{resource=gateway}": 0.0,
            "admission.queue_limit{resource=gateway}": 8.0,
        },
        now=0.0,
    )
    v = cp.verdict()
    assert v["top"] is None
    assert "no saturated resource" in v["summary"]
    assert "admission" in v["summary"]


def test_compute_member_first_scrape_uses_totals():
    """dt and prev defaults: first scrape (empty prev) reads deltas as
    totals — the honest first reading, not a zero row."""
    from bftkv_tpu_torch.obs.capacity import _index, compute_member

    idx = _index(
        {
            "storage.compact.read_bytes": 2.0 * 1024 * 1024,
            "storage.compact.written_bytes": 1.0 * 1024 * 1024,
            "storage.compact.mbps": 3.0,
        }
    )
    rows = compute_member(idx, {}, 1.0)
    assert rows["compact_io"]["mbps"] == pytest.approx(3.0)
    assert rows["compact_io"]["utilization"] == 1.0  # ungoverned + active


def test_compact_governor_throttles_and_reports(tmp_path, monkeypatch):
    """BFTKV_LOG_COMPACT_MBPS bounds the copy loop: with a tiny budget
    the governor sleeps, the throttle histogram records the debt, and
    the capacity row reads as saturated."""
    monkeypatch.setenv("BFTKV_LOG_COMPACT_MBPS", "0.5")
    from bftkv_tpu_torch.storage.logkv import LogStorage

    st = LogStorage(str(tmp_path / "db"), fsync=False, group_commit_s=0.0)
    try:
        blob = b"x" * 4096
        for i in range(64):
            st.write(b"k%d" % i, 1, blob)
        st.seal_active()
        t0 = time.monotonic()
        st.compact()
        elapsed = time.monotonic() - t0
    finally:
        st.close()
    snap = metrics.snapshot()
    moved = snap.get("storage.compact.read_bytes", 0) + snap.get(
        "storage.compact.written_bytes", 0
    )
    assert moved > 0
    # ~0.5 MB at 0.5 MB/s cannot finish instantly
    throttled = snap.get("storage.compact.throttle.sum", 0.0)
    assert throttled > 0.0
    assert elapsed >= throttled * 0.5
    cp = CapacityPlane()
    rows = _observe_twice(cp)
    io = rows["compact_io"]
    assert io["mbps"] <= 0.75  # governed at 0.5, tolerance for rounding
    assert io["saturation"] > 0.0


# -- across the packages ----------------------------------------------------


def _seeded_snaps(seed: int, scrapes: int) -> list:
    """Cumulative member snapshots over the closed vocabulary: admission
    tiers, the three dispatchers with their per-width occupancy, staging
    rings, the log commit path, the fan-out pool, sync repair, GIL."""
    import random

    rng = random.Random(seed)
    tot: dict = {}
    out = []
    for i in range(scrapes):
        def bump(k, hi):
            tot[k] = tot.get(k, 0) + rng.randrange(hi)
        for tier in ("sidecar", "gateway"):
            lab = f"{{resource={tier}}}"
            tot["admission.limit" + lab] = 4.0
            tot["admission.inflight" + lab] = float(rng.randrange(5))
            tot["admission.waiting" + lab] = float(rng.randrange(9))
            tot["admission.queue_limit" + lab] = 8.0
            bump("admission.wait.count" + lab, 20)
            tot["admission.wait.p99" + lab] = rng.uniform(0, 0.5)
            bump(f"{tier}.shed", 3)
        for name in ("dispatch", "signdispatch", "modexpdispatch"):
            for w in ("32", "64", "ec"):
                tot[f"{name}.device_occupancy{{width={w}}}"] = rng.random()
            bump(f"{name}.flushes", 10)
            bump(f"{name}.items", 4000)
            tot[f"{name}.wait.p99"] = rng.uniform(0, 0.4)
        tot["dispatch.launch_rtt"] = rng.uniform(0.001, 0.01)
        for w in ("32", "64"):
            tot[f"devbuf.saturation{{width={w}}}"] = rng.random()
        bump("storage.log.batch.count", 50)
        tot["storage.log.batch.sum"] = tot.get("storage.log.batch.sum", 0) + rng.uniform(0, 40)
        bump("storage.log.commit_wait.count", 50)
        tot["storage.log.commit_wait.p99"] = rng.uniform(0, 0.3)
        bump("storage.log.fsync", 30)
        tot["storage.log.linger_ms"] = 2.0
        tot["transport.pool.cap{resource=fanout_pool}"] = 64.0
        tot["transport.pool.busy{resource=fanout_pool}"] = float(rng.randrange(65))
        bump("transport.pool.saturated", 4)
        bump("transport.conn.dialed", 5)
        bump("transport.conn.reused", 50)
        tot["sync.repair.backlog"] = float(rng.randrange(100))
        tot["gil.runnable"] = float(rng.randrange(12))
        out.append(dict(tot))
    return out


def test_capacity_rows_equal_the_references(monkeypatch):
    """The same seeded member snapshots give JSON-equal capacity rows,
    documents, verdicts and ``resource_saturated`` checks in both
    packages, scrape by scrape."""
    import json

    from bftkv_tpu.obs.capacity import CapacityPlane as RefPlane

    monkeypatch.setenv("BFTKV_SAT_SCRAPES", "2")
    dump = lambda x: json.dumps(x, sort_keys=True, default=str)
    port, ref = CapacityPlane(), RefPlane()
    members = {m: _seeded_snaps(seed, 6) for seed, m in enumerate(("a01", "rw01", "sidecar01"))}
    fired = 0
    for i in range(6):
        for m, snaps in members.items():
            assert dump(port.observe(m, snaps[i], now=float(i))) == dump(ref.observe(m, snaps[i], now=float(i)))
        assert dump(port.doc()) == dump(ref.doc())
        shares = {"crypto": 0.5, "storage": 0.3, "rpc": 0.2}
        assert dump(port.verdict(shares)) == dump(ref.verdict(shares))
        got = port.check()
        assert dump(got) == dump(ref.check())
        fired += len(got)
    assert fired >= 1
    port.forget("a01")
    ref.forget("a01")
    assert dump(port.doc()) == dump(ref.doc())
