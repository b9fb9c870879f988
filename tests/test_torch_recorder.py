"""The port's flight recorder (``bftkv_tpu_torch/obs/recorder``) against
the reference's ``tests/test_recorder.py``, plus a cross check (the same
anomalies give equal manifests in both packages): the anomaly→bundle path,
window coalescing, the rate limit and disk caps, and the contract that
a bundle opens with plain stdlib json and no live fleet."""

from __future__ import annotations

import json
import os
import time

from bftkv_tpu_torch.obs import FleetCollector
from bftkv_tpu_torch.obs.recorder import FlightRecorder, read_manifest


def _emit(coll, kind="member_down", source="a01", shard=0,
          detail="probe failed"):
    coll._emit(kind, source, shard, detail)


# -- anomaly -> bundle ------------------------------------------------------


def test_anomaly_mints_bundle_whose_manifest_names_it(tmp_path):
    coll = FleetCollector([])
    rec = FlightRecorder(
        str(tmp_path / "bb"), min_interval_s=3600
    ).add_to(coll)
    assert coll.recorder is rec  # /fleet/bundle's demand seam
    _emit(coll)
    bundles = rec.bundles()
    assert len(bundles) == 1 and rec.bundle_count == 1
    man = read_manifest(bundles[0])
    assert man["reason"] == "member_down"
    assert [a["kind"] for a in man["anomalies"]] == ["member_down"]
    assert man["anomalies"][0]["source"] == "a01"
    # the manifest inventories every file with its true size, and each
    # JSON feed parses with nothing but the stdlib — no live fleet, no
    # bftkv import needed to open a black box
    assert man["files"] and man["bytes"] == sum(man["files"].values())
    for name, size in man["files"].items():
        p = os.path.join(bundles[0], name)
        assert os.path.getsize(p) == size
        if name.endswith(".json"):
            with open(p) as f:
                json.load(f)
    for expected in ("traces.json", "metrics.json", "anomalies.json",
                     "failpoints.json"):
        assert expected in man["files"]


def test_same_window_anomalies_amend_not_mint(tmp_path):
    coll = FleetCollector([])
    rec = FlightRecorder(
        str(tmp_path / "bb"), min_interval_s=3600
    ).add_to(coll)
    _emit(coll, "member_down")
    _emit(coll, "gray_member", detail="a02 straggling")
    assert len(rec.bundles()) == 1
    assert rec.coalesced == 1
    man = read_manifest(rec.bundles()[0])
    assert [a["kind"] for a in man["anomalies"]] == [
        "member_down", "gray_member",
    ]
    assert "amended_ts" in man


def test_rate_limit_window_expiry_mints_fresh_bundle(tmp_path):
    coll = FleetCollector([])
    rec = FlightRecorder(
        str(tmp_path / "bb"), min_interval_s=0.05
    ).add_to(coll)
    _emit(coll)
    time.sleep(0.08)  # outside min_interval: a new event, a new box
    _emit(coll, "slo_burn")
    assert len(rec.bundles()) == 2
    assert rec.coalesced == 0


def test_mark_window_opens_fresh_epoch(tmp_path):
    # The nemesis contract: back-to-back fault windows never share a
    # bundle even when the rate limit would have coalesced them, and
    # within one window every follow-up amends.
    coll = FleetCollector([])
    rec = FlightRecorder(
        str(tmp_path / "bb"), min_interval_s=3600
    ).add_to(coll)
    rec.mark_window()
    _emit(coll, "member_down")
    _emit(coll, "member_down", source="a02")
    rec.mark_window()
    _emit(coll, "gray_member")
    bundles = rec.bundles()
    assert len(bundles) == 2
    assert rec.coalesced == 1
    kinds = [
        [a["kind"] for a in read_manifest(b)["anomalies"]]
        for b in bundles
    ]
    assert kinds == [["member_down", "member_down"], ["gray_member"]]


# -- disk bounds ------------------------------------------------------------


def test_bundle_count_cap_evicts_oldest(tmp_path):
    rec = FlightRecorder(str(tmp_path / "bb"), max_bundles=3)
    for i in range(6):
        rec.snapshot(reason=f"r{i}")
        time.sleep(0.002)  # distinct millisecond stamps
    bundles = rec.bundles()
    assert len(bundles) == 3
    # oldest evicted first; the black box keeps the recent past
    assert [b.rsplit("-", 1)[1] for b in bundles] == ["r3", "r4", "r5"]
    assert rec.bundle_count == 6  # created, not surviving


def test_byte_cap_keeps_at_least_the_newest(tmp_path):
    rec = FlightRecorder(str(tmp_path / "bb"), max_bytes=1)
    a = rec.snapshot(reason="first")
    time.sleep(0.002)
    b = rec.snapshot(reason="second")
    # 1 byte fits nothing, but the just-written bundle must survive —
    # an empty black box is worse than an oversized one
    assert rec.bundles() == [b]
    assert not os.path.isdir(a)


def test_full_disk_suppressed_never_raises(tmp_path):
    blocked = tmp_path / "blocked"
    blocked.write_text("a file where the bundle dir must go")
    coll = FleetCollector([])
    rec = FlightRecorder(str(blocked)).add_to(coll)
    _emit(coll)  # must not raise out of the anomaly feed
    assert rec.suppressed == 1 and rec.bundle_count == 0


# -- demand snapshots with no live fleet ------------------------------------


def test_demand_snapshot_with_nothing_wired(tmp_path):
    # A recorder wired to no collector still writes a valid (sparse)
    # bundle from the process-wide feeds — the cmd.fleet --bundle path
    # against a dead fleet.
    rec = FlightRecorder(str(tmp_path / "bb"))
    bundle = rec.snapshot()
    man = read_manifest(bundle)
    assert man["reason"] == "demand"
    assert man["anomalies"] == []
    assert "traces.json" in man["files"]
    assert "health.json" not in man["files"]  # no collector wired
    with open(os.path.join(bundle, "metrics.json")) as f:
        assert isinstance(json.load(f), dict)


def test_reason_is_sanitized_into_the_dirname(tmp_path):
    rec = FlightRecorder(str(tmp_path / "bb"))
    bundle = rec.snapshot(reason="slo_burn: shard 0 / p99>0.5s!")
    name = os.path.basename(bundle)
    assert name.startswith("bundle-")
    tail = name.split("-", 2)[2]
    assert all(c.isalnum() or c in "-_" for c in tail)
    assert os.path.isdir(bundle)


# -- across the packages ----------------------------------------------------


def test_bundles_equal_the_references(tmp_path):
    """Both packages' recorders, each on its own collector, fed the same
    anomaly sequence (two fault windows, a follow-up that amends, a demand
    snapshot) over the same feeds: the same number of bundles, amended
    and coalesced alike, manifests naming the same reasons and anomalies
    (less timestamps) over the same files, and byte-equal feed files."""
    import types

    from bftkv_tpu.obs import FleetCollector as RefCollector
    from bftkv_tpu.obs.recorder import FlightRecorder as RefRecorder
    from bftkv_tpu.obs.recorder import read_manifest as ref_read

    snap = {"client.write.latency.count": 3, "verify.device": 12}
    feeds = dict(
        tracer=types.SimpleNamespace(traces=lambda limit=50: [{"trace": "t1"}],
                                     slow=lambda: [{"trace_id": "t1", "duration": 2.0}]),
        metrics=types.SimpleNamespace(snapshot=lambda: dict(snap)),
        fp_registry=types.SimpleNamespace(trace=lambda: [(1, "transport.send", "drop", "r1")]),
    )

    def drive(coll_cls, rec_cls, root):
        coll = coll_cls([])
        rec = rec_cls(str(root), min_interval_s=3600, **feeds).add_to(coll)
        for window, kinds in enumerate((("member_down", "fault"), ("sidecar_down",))):
            rec.mark_window()
            for kind in kinds:
                coll._emit(kind, f"rw0{window + 1}", 0, "chaos window")
        rec.snapshot(reason="demand: all/ok")
        return rec

    port = drive(FleetCollector, FlightRecorder, tmp_path / "port")
    ref = drive(RefCollector, RefRecorder, tmp_path / "ref")
    assert (port.bundle_count, port.coalesced, port.suppressed) == (
        ref.bundle_count, ref.coalesced, ref.suppressed) == (3, 1, 0)
    strip = lambda d: {k: v for k, v in d.items() if k not in ("ts", "amended_ts")}
    for pb, rb in zip(port.bundles(), ref.bundles(), strict=True):
        assert os.path.basename(pb)[len("bundle-YYYYmmddTHHMMSS.mmm"):] == \
            os.path.basename(rb)[len("bundle-YYYYmmddTHHMMSS.mmm"):]
        pm, rm = read_manifest(pb), ref_read(rb)
        assert pm["reason"] == rm["reason"]
        assert [strip(a) for a in pm["anomalies"]] == [strip(a) for a in rm["anomalies"]]
        assert sorted(pm["files"]) == sorted(rm["files"])
        for name in ("metrics.json", "traces.json", "failpoints.json", "lockwatch.json"):
            with open(os.path.join(pb, name)) as f, open(os.path.join(rb, name)) as g:
                assert f.read() == g.read(), name
