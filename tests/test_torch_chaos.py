"""The port's chaos layer (``bftkv_tpu_torch/faults``: the nemesis, the
loopback chaos harness, the Byzantine failpoint programs and the safety
checker) against the reference's cases (``tests/test_chaos.py``), on a
4 + 4 port cluster on the cpu with 1024-bit keys.  Across the packages:
``Nemesis.plan`` equals the reference's for seeds 0–31 over several
step counts and kind pools, on a dummy and on a live cluster; both
``SafetyChecker``s give the same verdicts on the same recorded history,
planted violations included; the CLI's refusals of the autopilot.

Tier-1 keeps the short deterministic runs; the long seeded soak is
``slow``-marked, as in the reference."""

from __future__ import annotations

import types

import pytest

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch.faults import byzantine as byz
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.faults.checker import SafetyChecker
from bftkv_tpu_torch.faults.harness import build_cluster
from bftkv_tpu_torch.faults.nemesis import STEP_KINDS, Nemesis

from test_torch_utils import DEVICE

BITS = 1024


@pytest.fixture(autouse=True)
def _disarmed():
    fp.disarm()
    yield
    fp.disarm()


@pytest.fixture()
def cluster():
    c = build_cluster(4, 1, 4, bits=BITS, device=DEVICE)
    try:
        yield c
    finally:
        c.stop()


def _roots(cluster):
    return {s._sync_tree().root() for s in cluster.storage_servers}


def test_partition_crash_restart_checker_clean(cluster):
    """The tier-1 short chaos run: partition one replica, crash-restart
    another onto the same storage, keep writing throughout, converge
    via anti-entropy, and demand ZERO safety violations."""
    nem = Nemesis(cluster, seed=11)
    fp.registry.arm(11)
    cl = cluster.clients[0]

    cl.write_once(b"chaos/once", b"immutable")
    cluster.recorder.write_once_ok("u01", b"chaos/once", b"immutable")
    nem.traffic("baseline")

    rules = nem.partition("rw01")
    try:
        nem.traffic("partitioned")
    finally:
        nem.heal(rules)

    cluster.crash("rw02")
    nem.traffic("crashed")
    restarted = cluster.restart("rw02")
    # The restarted replica is a fresh Server on the cluster's device.
    assert str(restarted.device) == DEVICE

    nem.traffic("healed")
    cluster.recorder.read_ok("u01", b"chaos/once", cl.read(b"chaos/once"))

    assert nem.converge(), "anti-entropy must reconverge all replicas"
    assert len(_roots(cluster)) == 1
    trace = fp.registry.trace()
    assert trace, "the partition must actually have dropped packets"
    fp.disarm()

    checker = SafetyChecker(cluster.recorder, f=cluster.f)
    violations = checker.check(cluster.storage_servers)
    assert violations == [], violations
    assert nem.failures == {"write": 0, "read": 0}
    for var, val in sorted(nem._written.items())[:3]:
        for srv in cluster.storage_servers:
            assert pkt.parse(srv.storage.read(var, 0)).value == val


def test_byzantine_programs_checker_clean(cluster):
    """Byzantine modes as failpoint programs: a colluder and a stale
    replayer achieve nothing an honest reader can observe — and the
    checker proves it."""
    nem = Nemesis(cluster, seed=12)
    fp.registry.arm(12)
    cl = cluster.clients[0]
    nem.traffic("pre")

    colluder = byz.make_colluder(fp.registry, "rw01")
    stale = byz.make_stale_replayer(fp.registry, "rw02")
    try:
        nem.traffic("byz")
        cl.write(b"chaos/fresh", b"old")
        cl.write(b"chaos/fresh", b"new")
        cl.drain_tails()
        cluster.recorder.write_ok("u01", b"chaos/fresh", b"new")
        got = cl.read(b"chaos/fresh")
        cluster.recorder.read_ok("u01", b"chaos/fresh", got)
        assert got == b"new"
    finally:
        fp.registry.remove_all(colluder + stale)
    assert any(r.fires for r in stale), "stale replayer must have answered"

    assert nem.converge()
    fp.disarm()
    violations = SafetyChecker(cluster.recorder, f=cluster.f).check(
        cluster.storage_servers
    )
    assert violations == [], violations


def _plant(cluster):
    """The reference's planted violations: a fabricated read and a
    conflicting commit at 2f+1 replicas."""
    rec = cluster.recorder
    cl = cluster.clients[0]
    cl.write(b"chk/x", b"real")
    rec.read_ok("u01", b"chk/x", b"FABRICATED")  # nothing signed this
    for node in ("rw01", "rw02", "rw03"):
        rec.record(
            "persist", node=node, honest=True, variable=b"chk/y", t=9,
            value=b"A", completed=True,
        )
        rec.record(
            "persist", node=node, honest=True, variable=b"chk/y", t=9,
            value=b"B", completed=True,
        )


def test_checker_catches_planted_violations(cluster):
    """The checker itself must not be vacuous: plant a fabricated read
    and a conflicting commit in the history and see both flagged."""
    _plant(cluster)
    violations = SafetyChecker(cluster.recorder, f=cluster.f).check(
        cluster.storage_servers
    )
    assert any("no verifiable collective signature" in v for v in violations)
    assert any("conflicting commits" in v for v in violations)


def test_seeded_nemesis_run_end_to_end(cluster):
    """``Nemesis.run`` — the programmatic form of
    ``python -m bftkv_tpu_torch.faults.nemesis --seed N``: seeded plan,
    traffic, repair, convergence, checker."""
    report = Nemesis(cluster, seed=3).run(steps=3)
    assert report["violations"] == []
    assert report["converged"] is True
    assert report["faults_fired"] >= 0
    assert len(report["plan"]) == 3
    assert Nemesis(cluster, seed=3).plan(3) == report["plan"]


@pytest.mark.slow
def test_long_nemesis_soak():
    """Nightly soak: a 12-step seeded schedule with dwell, fresh
    cluster, zero violations and full convergence demanded."""
    c = build_cluster(4, 1, 4, bits=BITS, device=DEVICE)
    try:
        report = Nemesis(c, seed=42).run(steps=12, dwell=0.2)
        assert report["violations"] == [], report["violations"]
        assert report["converged"] is True
        assert report["faults_fired"] > 0
    finally:
        c.stop()


# -- across the packages ----------------------------------------------------


_KIND_POOLS = [
    None,
    ("partition", "crash_restart", "link_delay"),
    ("slow_node", "link_delay", "crash_restart"),
    ("sidecar_crash", "partition", "crash_restart", "link_delay", "sidecar_crash"),
    ("overload", "region_partition", "route_flap", "stale_replay", "collude", "clock_skew"),
]


def test_plans_equal_the_references_on_a_dummy_cluster():
    """``plan`` is a pure function of (seed, cluster shape): seeds 0–31,
    several step counts and kind pools, on the reference's dummy
    cluster (``tests/test_failpoints.py``'s), both with and without the
    autopilot flag (which only widens the plan on sharded clusters)."""
    from bftkv_tpu.faults.nemesis import STEP_KINDS as REF_KINDS
    from bftkv_tpu.faults.nemesis import Nemesis as RefNemesis

    assert STEP_KINDS == REF_KINDS
    dummy = types.SimpleNamespace(
        names=lambda storage_only=True: ["rw01", "rw02", "rw03", "rw04"]
    )
    for seed in range(32):
        for steps in (1, 4, 12):
            for kinds in _KIND_POOLS:
                for autopilot in (False, True):
                    got = Nemesis(dummy, seed=seed, autopilot=autopilot).plan(steps, kinds=kinds)
                    want = RefNemesis(dummy, seed=seed, autopilot=autopilot).plan(steps, kinds=kinds)
                    assert got == want, (seed, steps, kinds)
    p1 = Nemesis(dummy, seed=7).plan(8)
    assert {s["kind"] for s in p1} <= set(STEP_KINDS)
    assert "route_flap" not in {s["kind"] for s in p1}


def test_plans_and_checker_verdicts_equal_the_references(cluster):
    """On the live port cluster: the reference's ``Nemesis.plan`` over the
    port cluster equals the port's for seeds 0–31, and after a seeded run
    plus the planted violations both packages' ``SafetyChecker``s read
    the same recorded history and the same replicas into the same
    verdicts."""
    from bftkv_tpu.faults.checker import SafetyChecker as RefChecker
    from bftkv_tpu.faults.nemesis import Nemesis as RefNemesis

    for seed in range(32):
        for steps, kinds in ((4, None), (12, _KIND_POOLS[2])):
            assert Nemesis(cluster, seed=seed).plan(steps, kinds=kinds) == \
                RefNemesis(cluster, seed=seed).plan(steps, kinds=kinds), seed
    report = Nemesis(cluster, seed=7).run(steps=2)
    assert report["violations"] == []
    clean = RefChecker(cluster.recorder, f=cluster.f).check(cluster.storage_servers)
    assert clean == []
    _plant(cluster)
    kw = dict(f=cluster.f, shard_of_node=cluster.shard_map(), routing_stable=True)
    got = SafetyChecker(cluster.recorder, **kw).check(cluster.storage_servers)
    want = RefChecker(cluster.recorder, **kw).check(cluster.storage_servers)
    assert got == want and len(got) == 2, got


def test_cli_seed_7_exits_0_on_the_cpu(capsys):
    """``python -m bftkv_tpu_torch.faults.nemesis --seed 7``: the roadmap's
    stop condition, here with every node on the cpu."""
    from bftkv_tpu_torch.faults import nemesis

    assert nemesis.main(["--seed", "7", "--device", DEVICE]) == 0
    out = capsys.readouterr().out
    assert "nemesis: ok" in out and "detected=4/4" in out, out


def test_cli_sidecar_chaos_form_with_the_flight_recorder(capsys, monkeypatch, tmp_path):
    """The documented sidecar chaos form with ``BFTKV_FLIGHT_RECORDER=1``:
    the embedded sidecar serves on the device, every sidecar_crash window
    costs zero failed writes and surfaces as sidecar_down, and every
    fault window leaves exactly one bundle."""
    from bftkv_tpu_torch.faults import nemesis
    from bftkv_tpu_torch.ops import dispatch

    monkeypatch.setenv("BFTKV_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("BFTKV_RECORDER_DIR", str(tmp_path / "bb"))
    rc = nemesis.main([
        "--seed", "7", "--steps", "12", "--sidecar", "--device", DEVICE, "--json",
        "--kinds", "sidecar_crash,partition,crash_restart,link_delay,sidecar_crash",
    ])
    import json

    report = json.loads(capsys.readouterr().out)
    assert rc == 0, {k: report[k] for k in ("violations", "undetected", "sidecar_blocked", "recorder_missing")}
    crashes = [d for d in report["detection"] if d["kind"] == "sidecar_crash"]
    assert crashes and all(d["anomaly"] in ("sidecar_down", "sidecar_dishonest") for d in crashes)
    assert report["failures"]["write"] == 0 and report["sidecar_blocked"] == []
    # One bundle per fault window (the repair scrape after the last window
    # may mint one more, outside every window).
    windows = [d for d in report["detection"] if d["anomaly"] != "vacuous"]
    assert windows and all(d.get("bundles") == 1 for d in windows), report["detection"]
    assert report["recorder_missing"] == [] and report["recorder"]["bundles"] >= len(windows)
    # The harness's dispatchers are process-wide: stop() uninstalls them.
    assert dispatch.get() is None and dispatch.get_signer() is None


@pytest.mark.parametrize("argv", [
    ["--autopilot"],
    ["--autopilot", "--shards", "2", "--kinds", "route_flap"],
    ["--kinds", "route_flap"],
    ["--kinds", "partition,route_flap", "--shards", "2"],
])
def test_autopilot_and_route_flap_refused_before_any_cluster(argv, monkeypatch, capsys):
    """The autopilot is not ported: ``--autopilot`` and the ``route_flap``
    kind exit 2 naming ``autopilot/`` before a cluster (or a sidecar) is
    built; ``Nemesis.run`` with the autopilot raises before arming."""
    from bftkv_tpu_torch.faults import nemesis

    def boom(*a, **k):
        raise AssertionError("a cluster was built")

    monkeypatch.setattr(nemesis, "build_cluster", boom)
    monkeypatch.setattr(nemesis, "SidecarHarness", boom)
    with pytest.raises(SystemExit) as e:
        nemesis.main(argv + ["--device", DEVICE])
    assert e.value.code == 2
    assert "autopilot/" in capsys.readouterr().err
    dummy = types.SimpleNamespace(names=lambda storage_only=True: ["rw01"])
    with pytest.raises(RuntimeError, match="autopilot/"):
        Nemesis(dummy, seed=1, autopilot=True).run(steps=1)
    assert not fp.ARMED
