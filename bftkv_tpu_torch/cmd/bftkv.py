"""``bftkv`` server daemon (counterpart of ``bftkv_tpu/cmd/bftkv.py``).

Capability parity with the reference daemon (cmd/bftkv/main.go:36-267):
load a home directory (pubring/secring), build
graph/quorum/transport/storage, start the protocol server on the
certificate's address, and optionally expose a client-facing HTTP API:

    GET/POST /read/<var>      value bytes (404 when absent)
    POST     /write/<var>     body = value
    POST     /writeonce/<var> body = value (t = 2^64-1, immutable)
    POST     /joining         re-crawl the trust graph
    POST     /leaving
    GET      /show            trust-graph dump (text)
    GET      /metrics         JSON metrics snapshot (no reference
                              analog; stands in for the visualizer feed)

The revocation list is loaded at startup and persisted on shutdown —
the reference parses it but leaves persistence disabled
(main.go:119-121,170-183); here it round-trips.

    python -m bftkv_tpu_torch.cmd.bftkv --home keys/a01 --db dbs/a01 \
        --api 127.0.0.1:7001 [--storage native] [--dispatch] [--device cpu]

``--device`` (default ``cuda:0``, which raises without CUDA) places the
daemon's crypto: its collective verifier, its protocol node and, with
``--dispatch``, the dispatchers.  Under ``--sidecar`` or
``--verify-sidecar`` the card belongs to the sidecar: the daemon then
creates no CUDA context of its own (its device is resolved, never
touched, unless a batch it must verify itself reaches the card).
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os
import signal
import sys
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.errors import ERR_NOT_FOUND, Error
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch import flags

MAX_UINT64 = (1 << 64) - 1


def build_server(args):
    from bftkv_tpu_torch import storage as storagemod
    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch.protocol.server import Server
    from bftkv_tpu_torch.transport.http import TrHTTP

    graph, crypt, qs = topology.load_home(args.home, device=args.device)

    # The daemon is durable by default: plain fsyncs file + dir per
    # write (BFTKV_PLAIN_FSYNC=0 opts out), log group-commits its fsyncs.
    storage = storagemod.open_engine(args.storage, args.db)

    # Revocation list (reference: main.go:119-121 parses; persistence
    # re-enabled here).
    try:
        with open(args.revlist, "rb") as f:
            from bftkv_tpu_torch.crypto import cert as certmod

            revoked = certmod.parse(f.read())
            # revoke() (not revoke_nodes) so the peers also leave the
            # vertex set quorum selection reads — matching every other
            # revocation site (client.py / server.py).
            for n in revoked:
                graph.revoke(n)
            if revoked:
                print(f"revoked {len(revoked)} node(s) from {args.revlist}")
    except OSError:
        pass
    except Exception as e:
        # A torn .rev (crash mid-persist) must not brick the daemon.
        print(f"warning: ignoring unreadable revocation list: {e}")

    if args.ws:
        from bftkv_tpu_torch.transport.visual import TrVisual, WsHub

        host, _, port = args.ws.rpartition(":")
        hub = WsHub((host or "127.0.0.1", int(port)))
        tr = TrVisual(crypt, hub, graph)
        print(f"bftkv: visualizer feed @ ws://{host or '127.0.0.1'}:{port}")
    else:
        tr = TrHTTP(crypt, rpc_timeout=args.rpc_timeout)
    server = Server(graph, qs, tr, crypt, storage, device=args.device)
    return server, graph, crypt, qs, tr


class _ApiHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *a):
        pass

    def _reply(self, code: int, body: bytes, ctype="application/octet-stream"):
        self.send_response(code)
        self.send_header("content-type", ctype)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _var(self, prefix: str) -> bytes:
        rest = self.path[len(prefix):]
        return urllib.parse.unquote(rest).encode()

    _MUTATING = ("/write/", "/writeonce/", "/joining", "/leaving")

    #: Fixed endpoint names for the api.requests label — anything else
    #: (including variable-bearing paths' tails) collapses to "other"
    #: so hostile URLs cannot blow up label cardinality.
    _ENDPOINTS = frozenset(
        ("read", "write", "writeonce", "joining", "leaving", "show",
         "visual", "debug", "metrics", "trace", "info", "profile")
    )

    def _handle(self):
        svc = self.server.svc
        path = self.path
        ep = path.split("?", 1)[0].split("/", 2)[1] if "/" in path else ""
        metrics.incr(
            "api.requests",
            labels={"endpoint": ep if ep in self._ENDPOINTS else "other"},
        )
        # Always drain the body: HTTP/1.1 keep-alive reuses the
        # connection, and unread bytes would be parsed as the next
        # request line.
        try:
            length = int(self.headers.get("content-length", "0") or 0)
            body = self.rfile.read(length) if length > 0 else b""
        except (ValueError, OSError):
            self._reply(400, b"bad request\n", "text/plain")
            return
        if self.command == "GET" and path.startswith(self._MUTATING):
            # Idempotent GETs (prefetchers, probes) must not mutate
            # quorum state.
            self._reply(405, b"method not allowed\n", "text/plain")
            return
        try:
            if path.startswith("/read/"):
                value = svc.client.read(self._var("/read/"))
                if value is None:
                    self._reply(404, b"not found\n", "text/plain")
                else:
                    self._reply(200, value)
            elif path.startswith("/write/") or path.startswith("/writeonce/"):
                if path.startswith("/write/"):
                    svc.client.write(self._var("/write/"), body)
                else:
                    svc.client.write_once(self._var("/writeonce/"), body)
                self._reply(200, b"ok\n", "text/plain")
            elif path == "/joining":
                svc.client.joining()
                self._reply(200, b"joined\n", "text/plain")
            elif path == "/leaving":
                svc.client.leaving()
                self._reply(200, b"left\n", "text/plain")
            elif path == "/show":
                self._reply(200, svc.show().encode(), "text/plain")
            elif path == "/visual":
                import os as _os

                page = _os.path.join(
                    _os.path.dirname(_os.path.dirname(
                        _os.path.dirname(_os.path.abspath(__file__)))),
                    "visual", "index.html",
                )
                with open(page, "rb") as f:
                    self._reply(200, f.read(), "text/html")
            elif path.startswith("/debug/profile"):
                # torch.profiler trace capture (stands in for the
                # reference's pprof endpoint, cmd/bftkv/main.go:20,253):
                # a Chrome/Perfetto trace of this process.  The output
                # location is confined to a fixed root — the API may be
                # exposed beyond localhost.
                import re as _re
                import tempfile as _tf
                import time as _time
                import urllib.parse as _up

                q = _up.parse_qs(_up.urlparse(path).query)
                try:
                    seconds = float(q.get("seconds", ["2"])[0])
                except ValueError:
                    seconds = 2.0
                if not (seconds >= 0.0):  # also catches NaN
                    seconds = 0.0
                seconds = min(seconds, 30.0)
                name = _re.sub(
                    r"[^A-Za-z0-9_.-]", "_", q.get("name", ["trace"])[0]
                )[:64]
                # "", "." and ".." survive the character filter but
                # escape (or collapse into) the confinement root.
                if name in ("", ".", ".."):
                    name = "trace"
                outdir = os.path.join(
                    _tf.gettempdir(), "bftkv-profile", name
                )
                _torch_trace(outdir, seconds)
                self._reply(
                    200,
                    f"trace captured to {outdir}\n".encode(),
                    "text/plain",
                )
            elif path == "/metrics" or path.startswith("/metrics?"):
                # Content negotiation: Prometheus scrapers ask for text
                # (or pass ?format=prometheus); everyone else keeps the
                # original JSON snapshot.
                devmod.note_cuda_state(metrics)
                q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
                accept = self.headers.get("accept") or ""
                want_prom = q.get("format", [""])[0] == "prometheus" or (
                    "application/json" not in accept
                    and ("text/plain" in accept or "openmetrics" in accept)
                )
                if want_prom:
                    self._reply(
                        200,
                        metrics.prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                else:
                    body = json.dumps(
                        metrics.snapshot(), sort_keys=True
                    ).encode()
                    self._reply(200, body, "application/json")
            elif path == "/trace" or path.startswith("/trace?"):
                from bftkv_tpu_torch import trace as trmod

                q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
                if "since" in q:
                    # Incremental drain for the fleet collector: spans
                    # after the caller's cursor + the slow ring (its
                    # entries carry shard/peer attribution the /fleet
                    # exemplars surface).
                    try:
                        since = int(q["since"][0])
                    except ValueError:
                        since = 0
                    doc = trmod.tracer.export(max(0, since))
                    doc["slow"] = trmod.tracer.slow()
                    body = json.dumps(
                        doc, sort_keys=True, default=str
                    ).encode()
                    self._reply(200, body, "application/json")
                    return
                try:
                    limit = int(q.get("limit", ["20"])[0])
                except ValueError:
                    limit = 20
                limit = max(1, min(limit, 200))
                body = json.dumps(
                    {
                        "slow_threshold_s": trmod.tracer.slow_threshold,
                        "slow": trmod.tracer.slow(),
                        "recent": trmod.tracer.traces(limit),
                    },
                    sort_keys=True,
                    default=str,
                ).encode()
                self._reply(200, body, "application/json")
            elif path == "/profile" or path.startswith("/profile?"):
                # Wall-clock sampling profile (collapsed flamegraph
                # stacks, obs/profiler.py): the window snapshots the
                # continuous sampler when BFTKV_PROFILE is armed, or
                # runs a temporary one — either way bounded, text/plain,
                # pipe straight into flamegraph.pl / speedscope.
                from bftkv_tpu_torch.obs import profiler

                q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
                try:
                    seconds = float(q.get("seconds", ["2"])[0])
                except ValueError:
                    seconds = 2.0
                if not (seconds >= 0.05):  # also catches NaN
                    seconds = 0.05
                body = profiler.profile_for(min(seconds, 30.0)).encode()
                self._reply(200, body, "text/plain; charset=utf-8")
            elif path == "/info":
                body = json.dumps(
                    self.server.svc.info(), sort_keys=True
                ).encode()
                self._reply(200, body, "application/json")
            else:
                self._reply(404, b"unknown endpoint\n", "text/plain")
        except Error as e:
            code = 404 if type(e) is ERR_NOT_FOUND else 500
            self._reply(code, (e.message + "\n").encode(), "text/plain")
        except Exception as e:  # operator surface: never kill the daemon
            self._reply(500, (str(e) + "\n").encode(), "text/plain")

    do_GET = _handle
    do_POST = _handle


def _torch_trace(outdir: str, seconds: float) -> None:
    """A ``seconds`` window of ``torch.profiler`` into ``outdir`` (one
    ``*.pt.trace.json``).  CUDA activity is traced only where this
    process already holds a CUDA context: a sidecar-mode daemon must not
    create one for a trace."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(outdir)):
        time.sleep(seconds)


class _ApiService:
    """The daemon's own protocol client + graph introspection
    (reference: apiService, main.go:209-267)."""

    def __init__(self, client, graph, qs=None):
        self.client = client
        self.graph = graph
        self.qs = qs  # the DAEMON's quorum system (not the client's)

    def info(self) -> dict:
        """Machine-readable identity + shard seat for the fleet
        collector (``bftkv_tpu_torch.obs``): who am I, which shard do I
        serve, and the b-masking thresholds of that shard's clique —
        computed HERE from the same ``quorum/wotqs.py`` state the
        protocol uses, so the health plane can never drift from the
        quorum math."""
        from bftkv_tpu_torch.obs.source import seat_document

        g = self.graph
        out: dict = {
            "name": g.name,
            "id": f"{g.id:016x}",
            "addr": g.address,
            "uid": g.uid,
        }
        qs = self.qs if self.qs is not None else getattr(
            self.client, "qs", None
        )
        out.update(seat_document(qs, g.id))
        return out

    def show(self) -> str:
        g = self.graph
        lines = [f"self: {g.name} id={g.id:016x} addr={g.address} uid={g.uid}"]
        qs = self.qs if self.qs is not None else getattr(
            self.client, "qs", None
        )
        if qs is not None and hasattr(qs, "shard_count"):
            try:
                nsh = qs.shard_count()
                if nsh > 1:
                    owned = qs.owned_buckets()
                    mine = qs.my_shard()
                    lines.append(
                        f"shards: {nsh} (mine={mine}, "
                        "owned_buckets="
                        f"{'all' if owned is None else len(owned)}/256)"
                    )
            except Exception:
                pass
        for peer in g.get_peers():
            lines.append(
                f"peer: {peer.name} id={peer.id:016x} addr={peer.address} "
                f"active={peer.active} "
                f"signers={[f'{s:016x}' for s in peer.signers()]}"
            )
        revoked = g.serialize_revoked()
        lines.append(f"revoked: {len(revoked)} bytes")
        return "\n".join(lines) + "\n"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="bftkv server daemon")
    ap.add_argument("--home", required=True, help="home dir (pubring/secring)")
    ap.add_argument("--db", default="", help="storage path (dir or log file)")
    ap.add_argument("--storage", choices=["plain", "log", "native", "mem"],
                    default=flags.get("BFTKV_STORAGE") or "plain")
    ap.add_argument("--api", default="", help="client API listen addr host:port")
    ap.add_argument("--client-home", default="",
                    help="home dir whose identity performs client-API "
                         "reads/writes (a *user* identity: a server's own "
                         "identity under-collects collective signatures — "
                         "its AUTH|PEER quorum excludes itself, so its "
                         "sufficiency target is below what verifying "
                         "replicas require on the full clique; the "
                         "reference has the same property)")
    ap.add_argument("--revlist", default="", help="revocation list file")
    ap.add_argument("--ws", default="",
                    help="WebSocket visualizer feed addr host:port "
                         "(view at /visual on the client API)")
    ap.add_argument("--bind-host", default="",
                    help="listen on this host instead of the certificate "
                         "address's host (containers: 0.0.0.0 so published "
                         "ports are reachable while peers still dial the "
                         "certificate address)")
    ap.add_argument("--join", action="store_true",
                    help="crawl the trust graph at startup")
    ap.add_argument("--anti-entropy", type=float, default=0.0,
                    metavar="SECONDS",
                    help="background replica state-sync interval "
                         "(jittered; 0 disables). Each round pulls "
                         "digests from f+1 distinct peers and admits "
                         "divergent records only through the full "
                         "local admission path — a restarted or "
                         "lagging replica converges without client "
                         "traffic (bftkv_tpu_torch/sync)")
    ap.add_argument("--slow-trace", type=float, default=None,
                    metavar="SECONDS",
                    help="slow-request threshold: a request trace whose "
                         "root span exceeds it is kept on /trace and "
                         "logged as one JSON line (default from "
                         "BFTKV_SLOW_TRACE_SECONDS, else 1.0)")
    ap.add_argument("--rpc-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="per-RPC response deadline for inter-replica "
                         "calls (default from BFTKV_RPC_TIMEOUT / "
                         "BFTKV_HTTP_TIMEOUT, else 10)")
    ap.add_argument("--chaos-seed", type=int, default=None, metavar="N",
                    help="TESTING: arm the deterministic failpoint "
                         "registry with this seed and install the "
                         "default chaos program (seeded transport "
                         "delays/drops + sync-round aborts; "
                         "bftkv_tpu_torch.faults). Same seed => same fault "
                         "schedule every run")
    ap.add_argument("--dispatch", action="store_true",
                    help="install the verify/sign dispatchers on --device "
                         "(one replica process per card)")
    ap.add_argument("--device", default=devmod.DEFAULT,
                    help="device of the daemon's crypto: cuda:N (the "
                         "kernels; default cuda:0, which raises without "
                         "CUDA) or cpu (host tier and plain versions)")
    ap.add_argument("--sidecar", default="",
                    help="host:port or unix:/path of a shared CRYPTO "
                         "sidecar (cmd.verify_sidecar): verification AND "
                         "RSA signing batch across every co-located "
                         "tenant process.  Results are never trusted — "
                         "signatures are self-checked with the public "
                         "exponent and verdicts spot-checked locally "
                         "(BFTKV_SIDECAR_SPOT_RATE); sign keys only "
                         "cross a unix: socket or an HMAC channel "
                         "(--sidecar-secret), else signing stays local")
    ap.add_argument("--sidecar-secret", default="",
                    help="file with a shared secret: HMAC-authenticate "
                         "sidecar frames both ways (enables remote "
                         "signing over TCP; always fail-closed)")
    ap.add_argument("--verify-sidecar", default="",
                    help="host:port or unix:/path of a shared verify "
                         "sidecar (cmd.verify_sidecar); co-located "
                         "replicas consolidate their verification "
                         "batches into one accelerator-owning process — "
                         "verification is public data, signing stays "
                         "in-process. Prefer unix: (mode-0600 socket); "
                         "a TCP port can be squatted after a crash")
    ap.add_argument("--verify-sidecar-secret", default="",
                    help="file with a shared secret: HMAC-authenticate "
                         "sidecar frames both ways and fail closed "
                         "(local verify) on mismatch — use with TCP")
    args = ap.parse_args(argv)
    # SIGUSR1 dumps every thread's stack to stderr: the operator's view
    # of a daemon that does not stop.
    faulthandler.register(signal.SIGUSR1, all_threads=True)
    # The device is resolved (and refused without CUDA) before anything
    # else; resolving creates no CUDA context.
    args.device = devmod.resolve(args.device)
    if not args.db and args.storage != "mem":
        args.db = args.home.rstrip("/") + ".db"
    if not args.revlist:
        args.revlist = args.home.rstrip("/") + ".rev"
    if args.slow_trace is not None:
        from bftkv_tpu_torch import trace as trmod

        trmod.tracer.slow_threshold = args.slow_trace
    if args.chaos_seed is not None:
        from bftkv_tpu_torch import faults

        faults.default_chaos_program(faults.arm(args.chaos_seed))
        print(
            f"bftkv: CHAOS armed, seed={args.chaos_seed} "
            "(deterministic failpoint program)", flush=True,
        )

    server, graph, crypt, qs, tr = build_server(args)

    if args.sidecar:
        from bftkv_tpu_torch.ops import dispatch

        from bftkv_tpu_torch.crypto.remote_verify import (
            RemoteSignerDomain,
            RemoteVerifierDomain,
            SidecarChannel,
        )

        secret = None
        if args.sidecar_secret:
            from bftkv_tpu_torch.cmd.verify_sidecar import load_secret

            secret = load_secret(args.sidecar_secret)
        # ONE channel for both domains: a dishonest verdict on either
        # op benches the service for both.  calibrate=False on both
        # dispatchers: calibration probes the card (a CUDA context in
        # this process, which must leave the card to the sidecar), and
        # the CPU prefer_host bypass would keep Signer.issue_many from
        # ever reaching the remote domain (the sidecar's own
        # dispatchers re-apply the measured crossover server-side).
        # The per-process window stays short — the cross-process
        # coalescing happens in the sidecar.
        chan = SidecarChannel(args.sidecar, secret=secret)
        dispatch.install(
            dispatch.VerifyDispatcher(
                verifier=RemoteVerifierDomain(channel=chan),
                calibrate=False,
            )
        )
        dispatch.install_signer(
            dispatch.SignDispatcher(
                signer=RemoteSignerDomain(channel=chan),
                calibrate=False,
                max_wait=0.002,
            )
        )
        if not chan.carries_keys:
            print(
                "bftkv: sidecar channel cannot carry sign keys "
                "(plain TCP without --sidecar-secret); signing stays "
                "local, verification remotes", flush=True,
            )
    elif args.verify_sidecar:
        from bftkv_tpu_torch.ops import dispatch

        from bftkv_tpu_torch.crypto.remote_verify import RemoteVerifierDomain

        # Verification goes to the sidecar (which owns the accelerator);
        # this process must NOT also install device crypto — signing
        # stays host-side unless --dispatch explicitly claims a chip.
        secret = None
        if args.verify_sidecar_secret:
            from bftkv_tpu_torch.cmd.verify_sidecar import load_secret

            secret = load_secret(args.verify_sidecar_secret)
        dispatch.install(
            dispatch.VerifyDispatcher(
                verifier=RemoteVerifierDomain(
                    args.verify_sidecar, secret=secret
                ),
                calibrate=False,
            )
        )
        if args.dispatch:
            dispatch.install_signer(dispatch.SignDispatcher(device=args.device))
    elif args.dispatch:
        from bftkv_tpu_torch.ops import dispatch

        dispatch.install(dispatch.VerifyDispatcher(device=args.device))
        dispatch.install_signer(dispatch.SignDispatcher(device=args.device))

    from bftkv_tpu_torch.obs import profiler

    if profiler.enabled():
        # Continuous sampler (BFTKV_PROFILE=1): /profile windows then
        # snapshot an always-running comb instead of arming on demand.
        profiler.ensure_started()
        print(
            f"bftkv: profiler armed @ {profiler.ensure_started().hz:g} Hz "
            "(/profile?seconds=N)", flush=True,
        )

    server.start(bind_host=args.bind_host)
    where = (
        f"{args.bind_host} (cert addr {graph.address})"
        if args.bind_host
        else graph.address
    )
    print(f"bftkv: serving {graph.name} @ {where}", flush=True)

    sync_daemon = None
    if args.anti_entropy > 0:
        from bftkv_tpu_torch.sync import SyncDaemon

        sync_daemon = SyncDaemon(server, interval=args.anti_entropy).start()
        print(
            f"bftkv: anti-entropy every ~{args.anti_entropy:g}s", flush=True
        )

    from bftkv_tpu_torch.protocol.client import Client

    if args.client_home:
        from bftkv_tpu_torch import topology
        from bftkv_tpu_torch.transport.http import TrHTTP

        cgraph, ccrypt, cqs = topology.load_home(args.client_home, device=args.device)
        client = Client(
            cgraph, cqs, TrHTTP(ccrypt, rpc_timeout=args.rpc_timeout), ccrypt,
            device=args.device,
        )
    else:
        client = Client(graph, qs, tr, crypt, device=args.device)
    if args.join:
        client.joining()

    api_httpd = None
    if args.api:
        host, _, port = args.api.rpartition(":")
        api_httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)),
                                        _ApiHandler)
        api_httpd.daemon_threads = True
        api_httpd.svc = _ApiService(client, graph, qs)
        threading.Thread(target=api_httpd.serve_forever, daemon=True).start()
        print(f"bftkv: client API @ {args.api}", flush=True)

    stop = threading.Event()

    def shutdown(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    stop.wait()

    # Persist the revocation list atomically (re-enabling
    # main.go:170-183; a torn write must not poison the next boot).
    rl = graph.serialize_revoked()
    if rl:
        tmp = args.revlist + "~"
        with open(tmp, "wb") as f:
            f.write(rl)
        os.replace(tmp, args.revlist)
    if api_httpd is not None:
        api_httpd.shutdown()
    if sync_daemon is not None:
        sync_daemon.stop()
    server.stop()
    if hasattr(server.storage, "close"):
        server.storage.close()
    print("bftkv: stopped", flush=True)
    return 0


if __name__ == "__main__":
    # Leave without the interpreter's finalization: storage is closed and
    # the revocation list written, but the transport's and API's daemon
    # threads may still sit in a blocking call, and one of 72 such
    # daemons aborted after "bftkv: stopped" ("FATAL: exception not
    # rethrown", exit -6) as finalization ended them.
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
