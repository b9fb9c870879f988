"""Cluster runner — one daemon process per home directory (counterpart of
``bftkv_tpu/cmd/run_cluster.py``).

The reference spawns one ``bftkv`` per key dir with sequential ports
(scripts/run.sh:27-41); here the address already lives in each home's
certificate, so the runner just enumerates server homes (names not
starting with ``u``) and execs the daemon for each:

    python -m bftkv_tpu_torch.cmd.genkeys --out keys --servers 4 --rw 4
    python -m bftkv_tpu_torch.cmd.run_cluster --keys keys --db-root dbs \
        [--device cpu] [--sidecar auto]

The runner lives until SIGINT/SIGTERM and then tears the fleet down.
``--api-base`` exposes the client API on sequential ports (reference
run.sh uses 6001+ for its debug API).

``--device`` (default ``cuda:0``) is passed to every daemon, gateway and
spawned sidecar.  With ``--sidecar auto`` the one sidecar process owns
the card and the daemons create no CUDA context.  ``--fleet`` boots the
fleet health collector (``python -m bftkv_tpu_torch.cmd.fleet``, a host
process that takes no device), ``--recorder`` attaches the flight recorder
to it, and ``--autopilot`` (which needs ``--fleet``) boots the advisory
topology watcher beside it (``python -m bftkv_tpu_torch.autopilot``, a
host process as well).
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags


def server_homes(keys_dir: str) -> list[str]:
    out = []
    if not os.path.isdir(keys_dir):
        return out  # --shards generates into a fresh dir
    for name in sorted(os.listdir(keys_dir)):
        home = os.path.join(keys_dir, name)
        # u* are client homes, gw* are edge gateway homes (run by
        # bftkv_tpu_torch.cmd.run_gateway, not the replica daemon).
        if not os.path.isdir(home) or name.startswith(("u", "gw")):
            continue
        out.append(home)
    return out


def gateway_homes(keys_dir: str) -> list[str]:
    if not os.path.isdir(keys_dir):
        return []
    return sorted(
        os.path.join(keys_dir, name)
        for name in os.listdir(keys_dir)
        if name.startswith("gw")
        and os.path.isdir(os.path.join(keys_dir, name))
    )


def spawn(
    homes: list[str],
    db_root: str,
    *,
    storage: str = "plain",
    api_base: int = 0,
    api_host: str = "127.0.0.1",
    bind_host: str = "",
    join: bool = False,
    client_home: str = "",
    verify_sidecar: str = "",
    sidecar: str = "",
    anti_entropy: float = 0.0,
    slow_trace: float | None = None,
    rpc_timeout: float | None = None,
    chaos_seed: int | None = None,
    fleet: int = 0,
    fleet_interval: float = 2.0,
    recorder: str = "",
    autopilot: bool = False,
    gw_homes: list[str] | None = None,
    gw_sync_invalidate: float = 5.0,
    extra_env: dict | None = None,
    device=devmod.DEFAULT,
    log_dir: str = "",
) -> list[subprocess.Popen]:
    """``verify_sidecar``: "auto" spawns one shared sidecar process and
    routes every daemon's verification through it (public data only —
    signing stays per-replica); "host:port" uses an existing one.

    ``sidecar``: the full shared crypto service — "auto" spawns ONE
    sidecar (mode-0600 unix socket under db_root) that every replica
    AND gateway signs+verifies through, with its stats endpoint on the
    port after the gateways' (``role=sidecar``, outside all f-budget
    math).  ``fleet`` boots the collector process (``cmd.fleet
    --listen``), ``recorder`` its flight recorder, ``autopilot`` the
    advisory watcher over the collector's ``/fleet`` (it needs
    ``fleet``).

    ``device`` (default ``cuda:0``, which raises here without CUDA, before
    any process starts) is passed to every process as ``--device``.
    ``log_dir`` sends each process's stdout and stderr to
    ``<log_dir>/<name>.log`` (default: this process's own)."""
    device = str(devmod.resolve(device))
    if sidecar and verify_sidecar:
        raise ValueError("--sidecar supersedes --verify-sidecar; "
                         "pass one")
    if fleet and not api_base:
        # Argument-only precondition: checked BEFORE any daemon spawns
        # (raising mid-spawn would orphan the just-launched fleet).
        raise ValueError("--fleet needs --api-base (it scrapes the "
                         "daemon APIs)")
    if autopilot and not fleet:
        raise ValueError("--autopilot needs --fleet (it watches the "
                         "collector's /fleet document)")
    os.makedirs(db_root, exist_ok=True)
    procs = []
    env = dict(os.environ, **(extra_env or {}))
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)

    def popen(cmd, name):
        if not log_dir:
            return subprocess.Popen(cmd, env=env)
        with open(os.path.join(log_dir, name + ".log"), "ab") as out:
            return subprocess.Popen(cmd, env=env, stdout=out, stderr=subprocess.STDOUT)

    if verify_sidecar == "auto" or verify_sidecar.startswith("auto:"):
        # "auto" → a mode-0600 Unix socket under db_root (a TCP port
        # could be squatted by another local user after a sidecar
        # crash); "auto:HOST:PORT" / "auto:unix:/path" → explicit
        # address.  (Exact prefix match: a real host named
        # auto*.example resolves as an existing sidecar, not a spawn
        # request.)
        _, _, rest = verify_sidecar.partition(":")
        verify_sidecar = rest or "unix:" + os.path.join(
            os.path.abspath(db_root), "verify.sock"
        )
        procs.append(popen(
            [
                sys.executable, "-m", "bftkv_tpu_torch.cmd.verify_sidecar",
                "--listen", verify_sidecar, "--device", device,
            ],
            "verify_sidecar",
        ))
    sidecar_stats = ""
    if sidecar == "auto" or sidecar.startswith("auto:"):
        _, _, rest = sidecar.partition(":")
        sidecar = rest or "unix:" + os.path.join(
            os.path.abspath(db_root), "sidecar.sock"
        )
        cmd = [
            sys.executable, "-m", "bftkv_tpu_torch.cmd.verify_sidecar",
            "--listen", sidecar, "--device", device,
        ]
        if api_base:
            # Stats ride the port after the gateways' APIs so the
            # fleet collector's sequential scrape covers the sidecar
            # (role=sidecar — excluded from every f-budget).
            sidecar_stats = (
                f"{api_host}:"
                f"{api_base + len(homes) + len(gw_homes or [])}"
            )
            cmd += ["--stats", sidecar_stats]
        procs.append(popen(cmd, "sidecar"))
    for i, home in enumerate(homes):
        name = os.path.basename(home)
        cmd = [
            sys.executable, "-m", "bftkv_tpu_torch.cmd.bftkv",
            "--home", home,
            "--db", os.path.join(db_root, name),
            "--storage", storage,
            "--revlist", os.path.join(db_root, name + ".rev"),
            "--device", device,
        ]
        if api_base:
            cmd += ["--api", f"{api_host}:{api_base + i}"]
            if client_home:
                cmd += ["--client-home", client_home]
        if bind_host:
            cmd += ["--bind-host", bind_host]
        if join:
            cmd += ["--join"]
        if sidecar:
            cmd += ["--sidecar", sidecar]
        elif verify_sidecar:
            cmd += ["--verify-sidecar", verify_sidecar]
        if anti_entropy > 0:
            cmd += ["--anti-entropy", str(anti_entropy)]
        if slow_trace is not None:
            cmd += ["--slow-trace", str(slow_trace)]
        if rpc_timeout is not None:
            cmd += ["--rpc-timeout", str(rpc_timeout)]
        if chaos_seed is not None:
            # seed + index: each daemon's schedule is reproducible run
            # to run but the fleet does not fire faults in lockstep.
            cmd += ["--chaos-seed", str(chaos_seed + i)]
        procs.append(popen(cmd, name))
    # Edge gateways ride after the replicas: their operator APIs take
    # the next sequential ports, so the fleet collector scrapes the
    # whole tier with one --count.
    for j, home in enumerate(gw_homes or []):
        cmd = [
            sys.executable, "-m", "bftkv_tpu_torch.cmd.run_gateway",
            "--home", home,
            "--sync-invalidate", str(gw_sync_invalidate),
            "--device", device,
        ]
        if api_base:
            cmd += ["--api", f"{api_host}:{api_base + len(homes) + j}"]
        if bind_host:
            cmd += ["--bind-host", bind_host]
        if rpc_timeout is not None:
            cmd += ["--rpc-timeout", str(rpc_timeout)]
        if sidecar:
            cmd += ["--sidecar", sidecar]
        if fleet:
            cmd += ["--fleet", f"http://127.0.0.1:{fleet}/fleet"]
        procs.append(popen(cmd, os.path.basename(home)))
    if fleet:
        # The health plane rides alongside the fleet: one collector
        # process (host only, no device) scraping every daemon's (and
        # gateway's, and the spawned sidecar's) /info + /metrics +
        # /trace, serving the aggregate on /fleet.  --recorder attaches
        # the flight recorder to it.
        cmd = [
            sys.executable, "-m", "bftkv_tpu_torch.cmd.fleet",
            "--api-base", str(api_base),
            "--count", str(
                len(homes)
                + len(gw_homes or [])
                + (1 if sidecar_stats else 0)
            ),
            "--api-host", api_host,
            "--listen", f"127.0.0.1:{fleet}",
            "--interval", str(fleet_interval),
        ]
        if recorder:
            cmd += ["--recorder", recorder]
        procs.append(popen(cmd, "fleet"))
    if autopilot:
        # Advisory watcher over the collector's /fleet document: prints
        # retire/split decisions as JSON lines (BFTKV_AUTOPILOT=off
        # silences it).  In-process fleets (nemesis, tests) run the
        # executing Autopilot directly.
        procs.append(popen(
            [
                sys.executable, "-m", "bftkv_tpu_torch.autopilot",
                "--fleet-url", f"http://127.0.0.1:{fleet}/fleet",
                "--interval", str(max(fleet_interval * 2, 2.0)),
            ],
            "autopilot",
        ))
    return procs


def shutdown(procs: list[subprocess.Popen], timeout: float = 10.0) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="bftkv cluster runner")
    ap.add_argument("--keys", required=True, help="directory of home dirs")
    ap.add_argument("--db-root", required=True)
    # The log engine is the cluster default (group commit
    # beats per-write fsync pairs under any concurrency; bench r9/r10
    # cluster_4_log vs cluster_4) — plain stays selectable, and the
    # single-daemon CLI (cmd/bftkv.py) keeps its plain default.
    ap.add_argument("--storage", choices=["plain", "log", "native", "mem"],
                    default=flags.get("BFTKV_STORAGE") or "log")
    ap.add_argument("--api-base", type=int, default=0,
                    help="client API port for the first server, +1 each")
    ap.add_argument("--client-home", default="",
                    help="user home the client APIs act as (see bftkv --help)")
    ap.add_argument("--api-host", default="127.0.0.1",
                    help="interface the client APIs listen on")
    ap.add_argument("--bind-host", default="",
                    help="protocol listen interface override (containers: "
                         "0.0.0.0)")
    ap.add_argument("--verify-sidecar", default="",
                    help='"auto" spawns one shared verification sidecar '
                         "for the fleet; or host:port of an existing one")
    ap.add_argument("--sidecar", default="",
                    help='"auto" spawns ONE shared crypto sidecar (sign+'
                         "verify+modexp, unix socket under --db-root) "
                         "that every replica and gateway batches "
                         "through.  Or host:port/unix:path of an "
                         "existing one")
    ap.add_argument("--anti-entropy", type=float, default=0.0,
                    metavar="SECONDS",
                    help="per-daemon background state-sync interval "
                         "(jittered; 0 disables — see bftkv --help)")
    ap.add_argument("--slow-trace", type=float, default=None,
                    metavar="SECONDS",
                    help="per-daemon slow-request trace threshold "
                         "(see bftkv --help)")
    ap.add_argument("--rpc-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="per-daemon per-RPC response deadline "
                         "(see bftkv --help)")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="N",
                    help="TESTING: arm every daemon's deterministic "
                         "failpoint registry (daemon i gets seed N+i); "
                         "same N replays the same fleet-wide fault "
                         "schedule (see bftkv --help)")
    ap.add_argument("--fleet", type=int, default=0, metavar="PORT",
                    help="boot the fleet health collector alongside the "
                         "cluster, serving /fleet (JSON + Prometheus) on "
                         "127.0.0.1:PORT — per-shard f-budget, stitched "
                         "cross-process traces, anomaly feed "
                         "(bftkv_tpu_torch.obs; needs --api-base)")
    ap.add_argument("--fleet-interval", type=float, default=2.0,
                    metavar="SECONDS", help="collector scrape interval")
    ap.add_argument("--recorder", default="", metavar="DIR",
                    help="attach the flight recorder to the --fleet "
                         "collector: every anomaly snapshots a rate-"
                         "limited black-box bundle (traces, metrics, "
                         "anomaly ring, failpoint log, last profile) "
                         "under DIR; POST /fleet/bundle takes one on "
                         "demand (needs --fleet)")
    ap.add_argument("--autopilot", action="store_true",
                    help="boot the topology autopilot watcher beside "
                         "the fleet collector (needs --fleet): it "
                         "consumes /fleet and prints split/retire "
                         "decisions as JSON lines "
                         "(BFTKV_AUTOPILOT=off disables)")
    ap.add_argument("--device", default=devmod.DEFAULT,
                    help="device of every daemon, gateway and spawned "
                         "sidecar: cuda:N (default cuda:0) or cpu")
    ap.add_argument("--shards", type=int, default=0, metavar="N",
                    help="one-box sharded quickstart: when --keys holds "
                         "no server homes yet, generate an N-clique "
                         "topology there first (4 servers + 4 rw per "
                         "shard, 1 user; the keyspace hash-routes "
                         "across the cliques) and then run it")
    ap.add_argument("--gateways", type=int, default=0, metavar="N",
                    help="run N edge gateways (cmd.run_gateway) from "
                         "the gw* homes under --keys; their operator "
                         "APIs take the ports after the daemons'.  The --shards "
                         "quickstart generates the gw homes too")
    ap.add_argument("--regions", type=int, default=0, metavar="N",
                    help="quickstart only: generate the topology with "
                         "N region labels (genkeys --regions).  Each "
                         "daemon picks its region up from its home's "
                         "`regions` file automatically, so an already-"
                         "generated labeled keyset needs no flag here")
    args = ap.parse_args(argv)
    if args.autopilot and not args.fleet:
        print("run_cluster: --autopilot needs --fleet (it watches the "
              "collector's /fleet document)", file=sys.stderr)
        return 2

    if args.shards and not server_homes(args.keys):
        from bftkv_tpu_torch.cmd import genkeys

        print(
            f"run_cluster: generating {args.shards}-shard topology "
            f"under {args.keys}", flush=True,
        )
        genkeys.main([
            "--out", args.keys, "--shards", str(args.shards),
            "--servers", "4", "--rw", "4", "--users", "1",
            "--gateways", str(args.gateways),
            "--regions", str(args.regions),
        ])

    homes = server_homes(args.keys)
    if not homes:
        print(f"no server homes under {args.keys}", file=sys.stderr)
        return 1
    if args.fleet and not args.api_base:
        print("--fleet needs --api-base (the collector scrapes the "
              "daemon APIs)", file=sys.stderr)
        return 1
    if args.recorder and not args.fleet:
        print("--recorder needs --fleet (the recorder hangs off the "
              "collector's anomaly feed)", file=sys.stderr)
        return 1
    gw_homes = gateway_homes(args.keys)[: args.gateways]
    if args.gateways and len(gw_homes) < args.gateways:
        print(f"--gateways {args.gateways} but only {len(gw_homes)} gw* "
              f"homes under {args.keys} (genkeys --gateways)",
              file=sys.stderr)
        return 1
    procs = spawn(homes, args.db_root, storage=args.storage,
                  api_base=args.api_base, api_host=args.api_host,
                  bind_host=args.bind_host, client_home=args.client_home,
                  verify_sidecar=args.verify_sidecar,
                  sidecar=args.sidecar,
                  anti_entropy=args.anti_entropy,
                  slow_trace=args.slow_trace,
                  rpc_timeout=args.rpc_timeout,
                  chaos_seed=args.chaos_seed, gw_homes=gw_homes,
                  fleet=args.fleet, fleet_interval=args.fleet_interval,
                  recorder=args.recorder, autopilot=args.autopilot,
                  device=args.device)
    # The sidecar (if spawned, always first) is an optional optimizer
    # whose clients fall back to local verification: its death must not
    # tear down the replica fleet, and it is not a "server".
    servers = [p for p in procs if "bftkv_tpu_torch.cmd.bftkv" in p.args]
    print(f"run_cluster: {len(servers)} servers up"
          + (f", {len(gw_homes)} gateways" if gw_homes else ""),
          flush=True)

    stopping = False

    def handler(signum, frame):
        nonlocal stopping
        stopping = True

    signal.signal(signal.SIGTERM, handler)
    signal.signal(signal.SIGINT, handler)
    while not stopping and all(p.poll() is None for p in servers):
        time.sleep(0.5)
    shutdown(procs)
    print("run_cluster: stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
