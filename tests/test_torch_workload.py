"""The port's workload engine (``bftkv_tpu_torch/workload``) against the
reference's cases (``tests/test_workload.py``): seeded spec determinism
across runs and worker counts, the bucket-vector merge law, key-model
sanity bounds, the open-loop overload regression (latency from the
SCHEDULED start, backlog reported not absorbed), a loopback port cluster
smoke, the universe profiler's O(universe)-per-op oracle; every preset's
op stream equals the reference's at one seed; ``run_multiprocess`` with 2
worker processes against a port cluster on localhost HTTP."""

import time

import pytest

from bftkv_tpu_torch.metrics import BUCKETS
from bftkv_tpu_torch.workload.driver import (
    LatencyHist,
    OpenLoop,
    merge_reports,
    run_in_process,
)
from bftkv_tpu_torch.workload.spec import WorkloadSpec, parse_spec
from bftkv_tpu_torch.workload.universe import (
    apply_churn,
    build_synthetic_graph,
    churn_schedule,
    profile_universe,
)

from test_torch_utils import start_cluster


# -- spec determinism ---------------------------------------------------


def test_stream_identical_across_runs_and_canonical_roundtrip():
    spec = WorkloadSpec.preset("storm", rate=40.0, duration_s=1.0, seed=5)
    total = spec.total_ops()
    ops1 = [spec.op_at(g) for g in range(total)]
    ops2 = [spec.op_at(g) for g in range(total)]
    assert ops1 == ops2
    again = parse_spec(spec.canonical())
    assert again == spec
    assert [again.op_at(g) for g in range(total)] == ops1


def test_stream_identical_across_worker_counts():
    """Worker slices partition the SAME global stream: op g is op g
    no matter how many workers the spec is split over."""
    spec = WorkloadSpec.preset("write_heavy", rate=50.0, duration_s=1.0,
                               seed=9)
    full = list(spec.iter_ops(0, 1))
    for w in (2, 4, 8):
        sliced = []
        for ci in range(w):
            sliced.extend(spec.iter_ops(ci, w))
        assert sorted(sliced, key=lambda o: o.index) == full


def test_owner_slots_respect_worker_divisibility():
    """g % owners ≡ g % W composes: every owner slot maps to exactly
    one worker when W divides owners — the TOFU safety arithmetic."""
    spec = WorkloadSpec(owners=8, rate=100.0, duration_s=0.5, seed=3)
    for w in (2, 4, 8):
        owner_to_worker: dict = {}
        for ci in range(w):
            for op in spec.iter_ops(ci, w):
                assert owner_to_worker.setdefault(op.owner, ci) == ci


def test_arrival_programs_monotone_and_sized():
    for name in ("read_heavy", "write_heavy", "storm", "ramp"):
        spec = WorkloadSpec.preset(name, rate=40.0, duration_s=2.0, seed=1)
        total = spec.total_ops()
        assert total >= int(40.0 * 2.0)  # ramp/storm only add rate
        dues = [spec.due(g) for g in range(total)]
        assert all(b >= a for a, b in zip(dues, dues[1:]))
        assert dues[-1] <= spec.duration_s + 1e-6


# -- key models ---------------------------------------------------------


def test_zipf_rank_zero_is_hottest():
    spec = WorkloadSpec(keys="zipf", zipf_s=1.2, keyspace=64,
                        rate=1000.0, duration_s=1.0, seed=4)
    ranks = [spec.op_at(g).rank for g in range(1000)]
    counts = [ranks.count(r) for r in range(64)]
    assert counts[0] == max(counts)
    assert counts[0] > 3 * max(counts[32:], default=0)


def test_hotset_bounds_and_churn():
    spec = WorkloadSpec(keys="hotset", hot_keys=4, hot_frac=0.9,
                        churn_every=100, keyspace=256,
                        rate=1000.0, duration_s=1.0, seed=7)
    epoch0, epoch1 = spec.hot_set(0), spec.hot_set(1)
    assert len(epoch0) == len(epoch1) == 4
    assert epoch0 != epoch1  # churn rotates the set
    hot_hits = sum(
        1 for g in range(100) if spec.op_at(g).rank in epoch0
    )
    # 90% of draws land in the 4-key hot set (binomial, wide bound).
    assert hot_hits >= 75


def test_storm_window_concentrates_on_hot_set():
    spec = WorkloadSpec.preset("storm", rate=100.0, duration_s=2.0,
                               seed=2, churn_every=0)
    in_storm = [
        op for op in spec.iter_ops() if spec.in_storm(op.due_s)
    ]
    assert in_storm, "storm window produced no ops"
    hot = spec.hot_set(0)
    assert all(op.rank in hot for op in in_storm)


# -- histogram merge law ------------------------------------------------


def test_bucket_merge_equals_single_stream():
    import hashlib

    lats = [
        int.from_bytes(hashlib.sha256(b"lat%d" % i).digest()[:4], "big")
        / 2**32 * 0.4
        for i in range(600)
    ]
    whole = LatencyHist()
    parts = [LatencyHist() for _ in range(3)]
    for i, v in enumerate(lats):
        whole.observe(v)
        parts[i % 3].observe(v)
    merged = LatencyHist()
    for p in parts:
        merged.merge(p)
    assert merged.counts == whole.counts
    assert merged.n == whole.n
    assert merged.total == pytest.approx(whole.total)
    for q in (0.5, 0.9, 0.99):
        assert merged.quantile(q) == whole.quantile(q)


def test_merge_reports_sums_bucket_vectors():
    spec = WorkloadSpec(rate=100.0, duration_s=1.0, seed=1)
    reports = []
    ref = LatencyHist()
    for w in range(2):
        h = LatencyHist()
        for i in range(50):
            v = 0.001 * (i + 1) * (w + 1)
            h.observe(v)
            ref.observe(v)
        reports.append({
            "lat_buckets": h.counts, "lat_total_s": h.total,
            "ops": {"write": 50}, "offered_ops": 50, "elapsed_s": 1.0,
            "backlog": {"ops_behind": w, "max_sched_lag_s": 0.1 * w},
        })
    merged = merge_reports(reports, spec, workers=2)
    assert merged["lat_buckets"] == ref.counts
    assert merged["offered_ops"] == 100
    assert merged["ops"] == {"write": 100}
    assert merged["p99_offered_s"] == ref.quantile(0.99)
    assert merged["backlog"] == {"ops_behind": 1, "max_sched_lag_s": 0.1}
    assert merged["mode"] == "multi_process"


def test_hist_rejects_wrong_ladder():
    with pytest.raises(ValueError):
        LatencyHist(counts=[0] * len(BUCKETS))


# -- open-loop overload regression --------------------------------------


def test_openloop_reports_backlog_and_charges_from_due():
    """The overload rule: when the scheduler falls behind, an
    op's latency still runs from its SCHEDULED start and the backlog
    is reported — never silently absorbed into a slower offered
    load."""
    ol = OpenLoop(rate=1000.0, workers=1)
    lag_seen = []
    for k in range(6):
        due = ol.wait(0, k)
        time.sleep(0.01)  # deliberately slower than the 1ms schedule
        lag_seen.append(time.perf_counter() - due)
    backlog = ol.backlog()
    assert backlog["ops_behind"] >= 4
    assert backlog["max_sched_lag_s"] > 0
    # Latency measured from the due time grows with the queue: the
    # coordinated-omission correction is visible in the samples.
    assert lag_seen[-1] > lag_seen[0]
    assert lag_seen[-1] >= 0.04


def test_openloop_on_time_has_no_backlog():
    # 50ms spacing: trivially keepable even on a loaded 1-core box.
    ol = OpenLoop(rate=20.0, workers=1)
    for k in range(3):
        ol.wait(0, k)
    assert ol.backlog() == {"ops_behind": 0, "max_sched_lag_s": 0.0}


# -- loopback cluster smoke --------------------------------------------


@pytest.fixture(scope="module")
def wl_cluster():
    c = start_cluster(4, 2, 4)
    yield c
    c.stop()


def test_run_in_process_smoke(wl_cluster):
    spec = WorkloadSpec.preset(
        "write_heavy", rate=30.0, duration_s=1.0, seed=6, owners=2,
        keyspace=32,
    )
    rep = run_in_process(spec, wl_cluster.clients, workers=2)
    assert rep["errors"] == 0, rep["error_samples"]
    assert rep["offered_ops"] == spec.total_ops()
    assert rep["achieved_rate_per_sec"] > 0
    assert rep["p50_offered_s"] is not None
    assert sum(rep["ops"].values()) == rep["offered_ops"]
    assert rep["mode"] == "in_process"
    # Written values are readable back through the cluster.
    wrote = [
        op for op in spec.iter_ops() if op.kind == "write"
    ]
    assert wrote
    got = wl_cluster.clients[0].read(
        spec.key_bytes(wrote[-1].owner, wrote[-1].rank)
    )
    assert got is not None


def test_run_in_process_rejects_nondivisible_workers(wl_cluster):
    spec = WorkloadSpec(owners=3, rate=10.0, duration_s=0.2)
    with pytest.raises(ValueError):
        run_in_process(spec, wl_cluster.clients, workers=2)


# -- universe scaling ---------------------------------------------------


def test_universe_profile_oracle_zero_o_universe_calls():
    """The universe profiler's bar at test scale: once memos are warm,
    steady-state choose_quorum_for does NO O(universe) graph
    traversal — counted, not timed."""
    res = profile_universe(200, shard_size=4, ops=64, churn_events=2,
                           seed=1)
    assert res["n_cliques"] == 50
    assert res["o_universe_calls_steady"] == 0
    assert res["steady_per_op_us"] < 10_000


def test_synthetic_graph_shapes_and_churn():
    g, certs = build_synthetic_graph(48, shard_size=4, seed=2)
    cliques = g.get_disjoint_cliques(min_size=4)
    assert len(cliques) == 12
    assert all(len(c.nodes) == 4 for c in cliques)
    sched = churn_schedule(6, n_nodes=48, duration_s=1.0, seed=2,
                           storm_start_frac=0.5, storm_revokes=3)
    assert sched == churn_schedule(6, n_nodes=48, duration_s=1.0, seed=2,
                                   storm_start_frac=0.5, storm_revokes=3)
    assert sum(1 for e in sched if e.kind == "revoke") >= 3
    gen0 = g.generation
    for ev in sched:
        apply_churn(g, certs, ev, shard_size=4, seed=2)
    assert g.generation > gen0
    assert g.get_disjoint_cliques(min_size=4)


def test_flag_overrides_splice_env_knobs(monkeypatch):
    """BFTKV_WORKLOAD_{SEED,RATE,DURATION} resolve through one read
    path (spec.flag_overrides): unset flags leave caller defaults
    untouched, set flags override the matching spec fields."""
    from bftkv_tpu_torch.workload.spec import flag_overrides

    for name in ("BFTKV_WORKLOAD_SEED", "BFTKV_WORKLOAD_RATE",
                 "BFTKV_WORKLOAD_DURATION"):
        monkeypatch.delenv(name, raising=False)
    assert flag_overrides() == {}
    monkeypatch.setenv("BFTKV_WORKLOAD_SEED", "7")
    monkeypatch.setenv("BFTKV_WORKLOAD_RATE", "33.5")
    monkeypatch.setenv("BFTKV_WORKLOAD_DURATION", "2.5")
    over = flag_overrides()
    assert over == {"seed": 7, "rate": 33.5, "duration_s": 2.5}
    spec = WorkloadSpec.preset("storm", **over)
    assert (spec.seed, spec.rate, spec.duration_s) == (7, 33.5, 2.5)


# -- across the packages -------------------------------------------------


def _ops(spec):
    return [(op.index, op.kind, op.owner, op.rank, spec.key_bytes(op.owner, op.rank),
             op.size, op.due_s) for op in spec.iter_ops()]


@pytest.mark.parametrize("preset", ["read_heavy", "write_heavy", "storm", "ramp", "shards"])
def test_every_preset_gives_the_reference_op_stream(preset):
    """One seed, one op stream: kind, owner, key, size and due time of
    every op equal the reference ``WorkloadSpec``'s, and so do the
    canonical forms and the op count."""
    from bftkv_tpu.workload import spec as ref_spec

    kw = dict(rate=60.0, duration_s=2.0, seed=11)
    port = WorkloadSpec.preset(preset, **kw)
    ref = ref_spec.WorkloadSpec.preset(preset, **kw)
    assert port.canonical() == ref.canonical()
    assert port.total_ops() == ref.total_ops() > 0
    assert _ops(port) == _ops(ref)
    assert parse_spec(ref.canonical()) == port


def test_presets_are_the_references():
    from bftkv_tpu.workload import spec as ref_spec
    from bftkv_tpu_torch.workload.spec import OP_KINDS, PRESETS

    assert sorted(PRESETS) == sorted(ref_spec.PRESETS)
    assert OP_KINDS == ref_spec.OP_KINDS
    assert BUCKETS == __import__("bftkv_tpu.metrics", fromlist=["BUCKETS"]).BUCKETS


def test_run_multiprocess_two_workers_over_http(tmp_path):
    """``run_multiprocess`` with 2 worker processes (each a port client on
    ``--device cpu``, its own home, dispatchers installed) against a port
    cluster on localhost HTTP: the merged report counts every op, no
    error, and the workers' writes read back."""
    from bftkv_tpu_torch.workload.driver import run_multiprocess

    c = start_cluster(4, 2, 4, transport="http")
    try:
        spec = WorkloadSpec.preset("write_heavy", rate=20.0, duration_s=1.0, seed=3,
                                   owners=2, keyspace=16)
        rep = run_multiprocess(spec, c, str(tmp_path), procs=2, timeout_s=240.0,
                               device="cpu")
        assert rep["worker_reports"] == 2
        assert rep["mode"] == "multi_process" and rep["workers"] == 2
        assert rep["errors"] == 0, rep["error_samples"]
        assert rep["offered_ops"] == spec.total_ops()
        assert sum(rep["lat_buckets"]) == rep["offered_ops"]
        wrote = [op for op in spec.iter_ops() if op.kind == "write"]
        assert wrote
        assert c.clients[0].read(spec.key_bytes(wrote[-1].owner, wrote[-1].rank)) is not None
    finally:
        c.stop()
