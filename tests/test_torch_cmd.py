"""The port's operator surfaces (``bftkv_tpu_torch/cmd``) against the
reference's cases (``tests/test_cmd.py``): genkeys → run_cluster (real OS
processes, every daemon on ``--device cpu``, the whole fleet signing and
verifying through one spawned crypto sidecar) → bftrw write/read/
writemany/readmany → the daemon's client API, ``/show``, ``/metrics``,
``/info``, ``/trace`` and the profile endpoints.  Across the packages:
homes written by either package's genkeys load in the other's
``load_home``, and the reference's ``bftrw read`` reads what the port's
``bftrw`` wrote through the port's daemons.  Ports are probed
(``free_port_block``), never fixed.
"""

import json
import os
import subprocess
import sys
import time
import urllib.parse
import urllib.request

import pytest

from test_torch_utils import free_port_block

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV = dict(
    os.environ,
    PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
)


def run_cmd(args, env=ENV, **kw):
    return subprocess.run(
        [sys.executable, "-m"] + args,
        env=env, cwd=REPO, capture_output=True, timeout=180, **kw
    )


def wait_port(port: int, timeout: float = 180.0) -> None:
    # Generous: a co-scheduled test suite can stretch 9 interpreters'
    # torch imports past a minute on a shared CPU box.
    import socket

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with socket.socket() as s:
            s.settimeout(1.0)
            try:
                s.connect(("127.0.0.1", port))
                return
            except OSError:
                time.sleep(0.3)
    raise TimeoutError(f"port {port} never came up")


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    from bftkv_tpu_torch.cmd import run_cluster

    tmp = tmp_path_factory.mktemp("cmd")
    keys = str(tmp / "keys")
    dbs = str(tmp / "dbs")
    base = free_port_block(8)
    api = free_port_block(9)
    fleet_port = free_port_block(1)
    gen = run_cmd([
        "bftkv_tpu_torch.cmd.genkeys", "--out", keys,
        "--servers", "4", "--rw", "4", "--users", "1", "--bits", "1024",
        "--base-port", str(base), "--rw-base-port", str(base + 4),
    ])
    assert gen.returncode == 0, gen.stderr.decode()

    homes = run_cluster.server_homes(keys)
    assert len(homes) == 8
    # The client APIs act as the user identity: server identities
    # under-collect collective signatures (their AUTH|PEER quorum
    # excludes self) — same property as the reference topology.
    procs = run_cluster.spawn(
        homes, dbs, storage="native", api_base=api,
        client_home=os.path.join(keys, "u01"), extra_env=ENV,
        # The whole fleet signs and verifies through one shared sidecar
        # process (a unix socket under dbs), so every case below runs
        # the sidecar path too.
        sidecar="auto", device="cpu",
        # The health plane beside it: the collector process scrapes the
        # 8 daemons and the sidecar's stats port, with a flight recorder.
        fleet=fleet_port, fleet_interval=0.5, recorder=str(tmp / "blackbox"),
        # And the advisory topology watcher over the collector's /fleet.
        autopilot=True,
    )
    try:
        for port in range(base, base + 8):
            wait_port(port)
        wait_port(api)
        wait_port(fleet_port)
        yield {"keys": keys, "dbs": dbs, "procs": procs, "api": api, "base": base,
               "fleet": fleet_port, "recorder": str(tmp / "blackbox")}
    finally:
        run_cluster.shutdown(procs)


def test_bftrw_write_read_across_processes(cluster):
    home = os.path.join(cluster["keys"], "u01")
    w = run_cmd(["bftkv_tpu_torch.cmd.bftrw", "--home", home, "--device", "cpu", "write", "smoke/x",
                 "hello from bftrw"])
    assert w.returncode == 0, w.stderr.decode()
    r = run_cmd(["bftkv_tpu_torch.cmd.bftrw", "--home", home, "--device", "cpu", "read", "smoke/x"])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == b"hello from bftrw"


def test_bftrw_writemany_readmany(cluster):
    home = os.path.join(cluster["keys"], "u01")
    lines = b"\n".join(b"bulk/%d=value-%d" % (i, i) for i in range(5))
    w = run_cmd(
        ["bftkv_tpu_torch.cmd.bftrw", "--home", home, "--device", "cpu", "writemany"], input=lines
    )
    assert w.returncode == 0, w.stderr.decode()
    assert b"5/5 written" in w.stderr
    r = run_cmd(
        ["bftkv_tpu_torch.cmd.bftrw", "--home", home, "--device", "cpu", "readmany"]
        + ["bulk/%d" % i for i in range(5)]
    )
    assert r.returncode == 0, r.stderr.decode()
    for i in range(5):
        assert b"bulk/%d=value-%d" % (i, i) in r.stdout


def test_daemon_client_api(cluster):
    # The daemon's own client writes through the quorum...
    req = urllib.request.Request(
        f"http://127.0.0.1:{cluster["api"]}/write/smoke/api", data=b"via api",
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as res:
        assert res.status == 200
    # ...and any other replica's API reads it back.
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"] + 1}/read/smoke/api", timeout=60
    ) as res:
        assert res.read() == b"via api"


def test_daemon_show_and_metrics(cluster):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/show", timeout=30
    ) as res:
        body = res.read().decode()
    assert "self: a01" in body and "peer:" in body
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/metrics", timeout=30
    ) as res:
        import json

        assert res.headers.get("content-type", "").startswith(
            "application/json"
        )
        snap = json.loads(res.read())
    assert isinstance(snap, dict)
    # A daemon on the cpu (and a sidecar-mode daemon anywhere) never
    # initialises CUDA: the card belongs to the sidecar.
    assert snap["device.cuda_initialized"] == 0
    # Content negotiation: a Prometheus scraper's Accept header gets
    # text exposition from the same endpoint.
    req = urllib.request.Request(
        f"http://127.0.0.1:{cluster["api"]}/metrics",
        headers={"accept": "text/plain"},
    )
    with urllib.request.urlopen(req, timeout=30) as res:
        assert res.headers.get("content-type", "").startswith("text/plain")
        prom = res.read().decode()
    assert "# TYPE" in prom
    assert "_total" in prom  # counters end in _total
    # ?format=prometheus works without the header (curl-friendly)
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/metrics?format=prometheus", timeout=30
    ) as res:
        assert res.read().decode().startswith("# TYPE")


def test_daemon_info_endpoint(cluster):
    import json

    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/info", timeout=30
    ) as res:
        info = json.loads(res.read())
    assert info["name"] == "a01"
    # the clique thresholds the fleet collector aggregates against,
    # straight from the wotqs b-masking math (n=4 -> f=1, 2f+1=3)
    assert info["clique"]["n"] == 4
    assert info["clique"]["f"] == 1
    assert info["clique"]["threshold"] == 3
    assert info["role"] == "clique"
    assert set(info["clique"]["members"]) == {"a01", "a02", "a03", "a04"}


def test_daemon_trace_export_cursor(cluster):
    import json

    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/trace?since=0", timeout=30
    ) as res:
        doc = json.loads(res.read())
    assert {"cursor", "dropped", "spans", "slow"} <= set(doc)
    cur = doc["cursor"]
    # draining again from the returned cursor yields nothing new
    # (no traffic between the two calls except other tests' residue;
    # allow spans but require the cursor to be monotonic)
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/trace?since={cur}", timeout=30
    ) as res:
        doc2 = json.loads(res.read())
    assert doc2["cursor"] >= cur
    assert isinstance(doc2["spans"], list)


def test_daemon_trace_endpoint(cluster):
    import json

    # Drive one write through the daemon's client so a trace exists.
    req = urllib.request.Request(
        f"http://127.0.0.1:{cluster["api"]}/write/smoke/traced", data=b"t",
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as res:
        assert res.status == 200
    # Straggler fan-out workers may still be recording rpc spans right
    # after the write returns; poll until the trace settles.
    deadline = time.monotonic() + 30
    names: list = []
    while time.monotonic() < deadline:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{cluster["api"]}/trace?limit=50", timeout=30
        ) as res:
            doc = json.loads(res.read())
        assert set(doc) == {"slow_threshold_s", "slow", "recent"}
        roots = [t for t in doc["recent"] if t["root"] == "client.write"]
        if roots:
            names = [s["name"] for s in roots[-1]["spans"]]
            if (
                "quorum.select" in names
                and sum(1 for n in names if n.startswith("rpc.")) >= 3
            ):
                break
        time.sleep(0.5)
    assert "quorum.select" in names, names
    assert sum(1 for n in names if n.startswith("rpc.")) >= 3, names


def test_daemon_profile_endpoint(cluster):
    """The torch.profiler trace endpoint (pprof analog,
    reference: cmd/bftkv/main.go:20,253) captures a trace directory
    confined under the fixed profile root; ``/profile`` answers a
    collapsed-stack window."""
    import tempfile

    outdir = os.path.join(tempfile.gettempdir(), "bftkv-profile", "smoke")
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/debug/profile?seconds=0.2&name=smoke",
        timeout=90,
    ) as res:
        assert b"trace captured" in res.read()
    found = []
    for root, _dirs, files in os.walk(outdir):
        found += [f for f in files if f.endswith(".pt.trace.json")]
    assert found, f"no trace artifacts under {outdir}"
    # Names that would escape the root collapse into it.
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/debug/profile?seconds=0&name=..",
        timeout=90,
    ) as res:
        assert os.path.join("bftkv-profile", "trace") in res.read().decode()
    with urllib.request.urlopen(
        f"http://127.0.0.1:{cluster["api"]}/profile?seconds=0.2", timeout=60
    ) as res:
        assert res.read().decode().startswith("# bftkv profile:")


def test_daemon_api_missing_variable(cluster):
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(
            f"http://127.0.0.1:{cluster["api"]}/read/smoke/none", timeout=60
        )
    assert ei.value.code == 404


def test_reference_bftrw_reads_what_the_port_bftrw_wrote(cluster):
    """The reference's user CLI, on the same home, reads through the
    port's daemons a value the port's CLI wrote."""
    home = os.path.join(cluster["keys"], "u01")
    w = run_cmd(["bftkv_tpu_torch.cmd.bftrw", "--home", home, "--device", "cpu",
                 "write", "cross/x", "written by the port"])
    assert w.returncode == 0, w.stderr.decode()
    r = run_cmd(["bftkv_tpu.cmd.bftrw", "--home", home, "read", "cross/x"],
                env=dict(ENV, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == b"written by the port"


def _same_home(a, b) -> None:
    """Two loaded ``(graph, crypt, qs)`` of one home: same self, peers,
    signer key and trust edges."""
    (ga, ca, _qa), (gb, cb, _qb) = a, b
    assert (ga.name, ga.id, ga.address) == (gb.name, gb.id, gb.address)
    assert sorted((p.name, p.id, p.address) for p in ga.get_peers()) == sorted(
        (p.name, p.id, p.address) for p in gb.get_peers())
    assert ca.signer.cert.serialize() == cb.signer.cert.serialize()
    assert (ca.signer.key.n, ca.signer.key.d) == (cb.signer.key.n, cb.signer.key.d)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_genkeys_homes_load_in_both_packages(tmp_path, writer):
    """Homes written by either package's ``genkeys`` load in the other's
    ``load_home`` with the same identity, peers and keys; a share signed by
    one package's loaded crypt verifies in the other's collective
    signature."""
    from bftkv_tpu import topology as ref_topology
    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch.cmd import run_cluster

    pkg = "bftkv_tpu_torch" if writer == "port" else "bftkv_tpu"
    keys = str(tmp_path / "keys")
    gen = run_cmd([
        f"{pkg}.cmd.genkeys", "--out", keys, "--servers", "4", "--rw", "0",
        "--users", "1", "--bits", "1024", "--base-port", "6001",
    ], env=dict(ENV, JAX_PLATFORMS="cpu"))
    assert gen.returncode == 0, gen.stderr.decode()
    homes = sorted(os.path.join(keys, n) for n in os.listdir(keys))
    assert [os.path.basename(h) for h in homes] == ["a01", "a02", "a03", "a04", "u01"]
    assert run_cluster.server_homes(keys) == homes[:4]
    loaded = {}
    for home in homes:
        port = topology.load_home(home, device="cpu")
        ref = ref_topology.load_home(home)
        _same_home(port, ref)
        loaded[os.path.basename(home)] = (port, ref)
    # a01's share, signed by each package, verifies in the other's
    # keyring as a member of u01's quorum.
    from bftkv_tpu_torch.crypto import signature as sigmod

    (pa, _r), ((_pg, pcr, _pq), (_rg, rcr, _rq)) = loaded["a01"], loaded["u01"]
    tbs = b"home-crossing"
    share = pa[1].collective.sign(pa[1].signer, tbs)
    entries = sigmod.parse_entries(share.data)
    assert [sid for sid, _ in entries] == [pa[0].id]
    key = rcr.keyring.get(pa[0].id).public_key
    assert rcr.collective.verifier.verify_batch([(tbs, entries[0][1], key)])[0]
    key = pcr.keyring.get(pa[0].id).public_key
    assert pcr.collective.verifier.verify_batch([(tbs, entries[0][1], key)])[0]


def test_run_cluster_refuses_the_fleet_collector(tmp_path, cluster):
    """What of the health plane the runner refuses, as the reference does:
    ``--autopilot`` without ``--fleet`` (the watcher reads the collector's
    ``/fleet``) exits 2 before any process starts, and ``spawn`` raises
    for it and for ``--fleet`` without ``--api-base``.  With ``--fleet``
    the watcher runs beside the collector (the ``cluster`` fixture): its
    process is up, and a ``--once`` scrape of the same ``/fleet`` exits 0
    with no advice (one low-traffic shard: nothing to split or retire)."""
    from bftkv_tpu_torch.cmd import run_cluster

    r = run_cmd(["bftkv_tpu_torch.cmd.run_cluster", "--keys", str(tmp_path / "k"),
                 "--db-root", str(tmp_path / "d"), "--autopilot", "--device", "cpu"])
    assert r.returncode == 2 and b"--autopilot needs --fleet" in r.stderr, r.stderr.decode()
    for kw, msg in (({"api_base": 7000, "autopilot": True}, "--autopilot needs --fleet"),
                    ({"autopilot": True}, "--autopilot needs --fleet"),
                    ({"fleet": 7899}, "needs --api-base")):
        with pytest.raises(ValueError, match=msg):
            run_cluster.spawn(["h"], str(tmp_path / "d"), device="cpu", **kw)
    assert not (tmp_path / "d").exists()
    watchers = [p for p in cluster["procs"] if "bftkv_tpu_torch.autopilot" in p.args]
    assert len(watchers) == 1 and watchers[0].poll() is None
    assert watchers[0].args[-4:] == ["--fleet-url", f"http://127.0.0.1:{cluster['fleet']}/fleet",
                                     "--interval", "2.0"]
    once = run_cmd(["bftkv_tpu_torch.autopilot", "--fleet-url",
                    f"http://127.0.0.1:{cluster['fleet']}/fleet", "--once"])
    assert once.returncode == 0, once.stderr.decode()
    assert json.loads(once.stdout)["advice"] == []


def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=30) as res:
        return json.loads(res.read())


def test_fleet_collector_beside_the_port_daemons(cluster):
    """``run_cluster --fleet --recorder`` over the port's daemons: the
    collector process serves /fleet with the 8 daemons and the sidecar
    (``role=sidecar``) up, both shard budgets full and the capacity
    plane's dispatch row filled; a write through a
    daemon's API reaches the fleet's write SLO (the daemons' fixed-bucket
    latency keys); ``cmd.fleet`` one-shot over the same APIs exits 0 in
    JSON and text; the collector answers 404 to a garbage trace id and
    POST /fleet/bundle writes a bundle under the recorder's directory;
    the daemons' /trace answers hostile ``since`` values."""
    import urllib.error

    fleet = f"http://127.0.0.1:{cluster['fleet']}"
    req = urllib.request.Request(
        f"http://127.0.0.1:{cluster['api']}/write/smoke/fleet", data=b"slo", method="POST",
    )
    with urllib.request.urlopen(req, timeout=60) as res:
        assert res.status == 200
    deadline = time.monotonic() + 60
    doc = {}
    while time.monotonic() < deadline:
        doc = _get_json(fleet + "/fleet")
        slo = [sd.get("slo", {}).get("write", {}).get("count", 0) for sd in doc.get("shards", {}).values()]
        if doc.get("fleet", {}).get("up") == 9 and sum(slo) >= 1:
            break
        time.sleep(0.5)
    assert doc["fleet"]["daemons"] == 9 and doc["fleet"]["up"] == 9, doc["fleet"]
    assert doc["sidecars"]["sidecar01"]["status"] == "up"
    assert doc["sidecars"]["sidecar01"]["device_plane"]["device"] == "cpu"
    # The capacity plane's dispatch row reads the daemons' dispatchers.
    assert doc["capacity"]["fleet"]["dispatch"]["utilization"] > 0
    for sd in doc["shards"].values():
        assert sd["f_budget"]["remaining"] == sd["f_budget"]["f"] == 1, sd["f_budget"]
    assert sum(sd["slo"]["write"]["count"] for sd in doc["shards"].values() if "write" in sd["slo"]) >= 1

    args = ["bftkv_tpu_torch.cmd.fleet", "--api-base", str(cluster["api"]), "--count", "9"]
    r = run_cmd(args + ["--json"])
    assert r.returncode == 0, r.stderr.decode()
    one = json.loads(r.stdout)
    assert one["fleet"]["up"] == 9
    r = run_cmd(args + ["--capacity"])
    assert r.returncode == 0 and b"budget 1/1" in r.stdout, r.stdout.decode()

    try:
        urllib.request.urlopen(fleet + "/fleet/trace/garbage%00", timeout=30)
        raise AssertionError("a garbage trace id answered 200")
    except urllib.error.HTTPError as e:
        assert e.code == 404
    req = urllib.request.Request(fleet + "/fleet/bundle", data=b"", method="POST")
    bundle = json.loads(urllib.request.urlopen(req, timeout=60).read())["bundle"]
    assert bundle.startswith(cluster["recorder"]) and os.path.exists(os.path.join(bundle, "manifest.json"))
    for since in ("abc", "-5", "1e4"):
        got = _get_json(f"http://127.0.0.1:{cluster['api']}/trace?since={since}")
        assert {"cursor", "dropped", "spans", "slow"} <= set(got)


def test_default_chaos_program_arms_the_references_rules():
    """The daemon's ``--chaos-seed`` program: the reference's three rules,
    seeded, inside the f budget."""
    from bftkv_tpu.faults import default_chaos_program as ref_program
    from bftkv_tpu.faults import failpoint as ref_fp
    from bftkv_tpu_torch import faults

    try:
        rules = faults.default_chaos_program(faults.arm(7))
        ref_rules = ref_program(ref_fp.arm(7))
        shape = lambda rs: [(r.rule_id, r.point, r.kind, r.prob) for r in rs]
        assert shape(rules) == shape(ref_rules)
        assert [r.rule_id for r in rules] == ["default:delay", "default:drop", "default:abort"]
    finally:
        faults.disarm()
        ref_fp.disarm()
