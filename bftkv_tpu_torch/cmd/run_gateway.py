"""``run_gateway`` — one edge gateway process (bftkv_tpu_torch/gateway;
counterpart of ``bftkv_tpu/cmd/run_gateway.py``).

Loads a gateway home (``genkeys --gateways N`` emits ``gw01..``),
starts the front-door protocol listener on the certificate's address
(clients reach it with GW_READ/GW_WRITE over the same encrypted
transport every other command uses), and optionally exposes an
operator HTTP API:

    GET/POST /read/<var>    value bytes through the certified cache
    POST     /write/<var>   body = value, coalesced upstream
    GET      /metrics       JSON snapshot or Prometheus text
    GET      /info          identity + role=gateway + cache stats
                            (the fleet collector scrapes this)
    GET      /trace         recent + slow traces (?since= drains)

    python -m bftkv_tpu_torch.cmd.run_gateway --home keys/gw01 \
        --api 127.0.0.1:7801 [--sync-invalidate 5] [--fleet URL] [--device cpu]

``--device`` (default ``cuda:0``, which raises without CUDA) places the
gateway's crypto; under ``--sidecar`` the gateway creates no CUDA context.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.errors import Error
from bftkv_tpu_torch.metrics import registry as metrics


class _GwApiHandler(BaseHTTPRequestHandler):
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
        return urllib.parse.unquote(self.path[len(prefix):]).encode()

    def _handle(self):
        gw = self.server.gateway
        path = self.path
        try:
            length = int(self.headers.get("content-length", "0") or 0)
            body = self.rfile.read(length) if length > 0 else b""
        except (ValueError, OSError):
            self._reply(400, b"bad request\n", "text/plain")
            return
        if self.command == "GET" and path.startswith("/write/"):
            self._reply(405, b"method not allowed\n", "text/plain")
            return
        try:
            if path.startswith("/read/"):
                value = gw.read_value(self._var("/read/"))
                if value is None:
                    self._reply(404, b"not found\n", "text/plain")
                else:
                    self._reply(200, value)
            elif path.startswith("/write/"):
                gw.write_value(self._var("/write/"), body)
                self._reply(200, b"ok\n", "text/plain")
            elif path == "/metrics" or path.startswith("/metrics?"):
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
                    self._reply(
                        200,
                        json.dumps(
                            metrics.snapshot(), sort_keys=True
                        ).encode(),
                        "application/json",
                    )
            elif path == "/info":
                self._reply(
                    200,
                    json.dumps(gw.info(), sort_keys=True).encode(),
                    "application/json",
                )
            elif path == "/trace" or path.startswith("/trace?"):
                from bftkv_tpu_torch import trace as trmod

                q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
                if "since" in q:
                    try:
                        since = int(q["since"][0])
                    except ValueError:
                        since = 0
                    doc = trmod.tracer.export(max(0, since))
                    doc["slow"] = trmod.tracer.slow()
                else:
                    doc = {
                        "slow": trmod.tracer.slow(),
                        "recent": trmod.tracer.traces(20),
                    }
                self._reply(
                    200,
                    json.dumps(doc, sort_keys=True, default=str).encode(),
                    "application/json",
                )
            else:
                self._reply(404, b"unknown endpoint\n", "text/plain")
        except Error as e:
            self._reply(500, (e.message + "\n").encode(), "text/plain")
        except Exception as e:  # operator surface: never kill the daemon
            self._reply(500, (str(e) + "\n").encode(), "text/plain")

    do_GET = _handle
    do_POST = _handle


def _fleet_poll(gw, url: str, interval: float, stop: threading.Event):
    """Feed the collector's /fleet JSON into the gateway's routing
    (down members to the back of upstream waves; exhausted-budget
    shards onto the stale-cache fallback)."""
    while not stop.wait(interval):
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                gw.apply_fleet_snapshot(json.loads(r.read()))
            metrics.incr("gateway.fleet.polls")
        except Exception:
            metrics.incr("gateway.fleet.poll_errors")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="bftkv edge gateway daemon")
    ap.add_argument("--home", required=True,
                    help="gateway home dir (genkeys --gateways)")
    ap.add_argument("--listen", default="",
                    help="front-door listen addr host:port (default: "
                         "the certificate address)")
    ap.add_argument("--api", default="",
                    help="operator HTTP API listen addr host:port")
    ap.add_argument("--bind-host", default="",
                    help="listen interface override (containers)")
    ap.add_argument("--cache-max", type=int, default=65536)
    ap.add_argument("--cache-ttl", type=float, default=30.0,
                    help="certified-cache TTL seconds (the invalidation "
                         "backstop)")
    ap.add_argument("--max-inflight", type=int, default=64,
                    help="concurrent upstream quorum operations")
    ap.add_argument("--max-queue", type=int, default=128,
                    help="admission waiters beyond which requests shed")
    ap.add_argument("--sync-invalidate", type=float, default=5.0,
                    metavar="SECONDS",
                    help="anti-entropy invalidation poll interval "
                         "(SYNC_DIGEST diff per shard; 0 disables)")
    ap.add_argument("--fleet", default="", metavar="URL",
                    help="poll this /fleet endpoint and route around "
                         "down members / degraded shards")
    ap.add_argument("--fleet-interval", type=float, default=5.0)
    ap.add_argument("--rpc-timeout", type=float, default=None)
    ap.add_argument("--sidecar", default="",
                    help="host:port or unix:/path of the shared crypto "
                         "sidecar: the gateway's certified-fill verifies "
                         "and coalesced-write signing batch across the "
                         "whole box (results self-/spot-checked; see "
                         "bftkv --sidecar)")
    ap.add_argument("--sidecar-secret", default="",
                    help="shared-secret file for HMAC sidecar frames")
    ap.add_argument("--device", default=devmod.DEFAULT,
                    help="device of the gateway's crypto: cuda:N (default "
                         "cuda:0, which raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    args.device = devmod.resolve(args.device)

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
        chan = SidecarChannel(args.sidecar, secret=secret)
        # calibrate=False: calibration would probe the card, which the
        # sidecar owns (see bftkv --sidecar).
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

    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch.gateway import Gateway
    from bftkv_tpu_torch.transport.http import TrHTTP

    graph, crypt, qs = topology.load_home(args.home, device=args.device)
    tr = TrHTTP(crypt, rpc_timeout=args.rpc_timeout)
    gw = Gateway(
        graph, qs, tr, crypt,
        device=args.device,
        cache_max=args.cache_max,
        cache_ttl=args.cache_ttl,
        max_inflight=args.max_inflight,
        max_queue=args.max_queue,
    )
    listen = args.listen
    if not listen:
        # genkeys drops the configured dial address beside the keys
        # (gateway certs carry none — they stay out of quorum planes).
        try:
            with open(os.path.join(args.home, "address")) as f:
                listen = f.read().strip().split("://", 1)[-1]
        except OSError:
            pass
    if not listen:
        print("run_gateway: no --listen and no address file in home",
              file=sys.stderr)
        return 1
    if args.bind_host:
        listen = f"{args.bind_host}:{listen.rsplit(':', 1)[-1]}"
    gw.start(listen)
    print(f"run_gateway: serving {graph.name} @ {listen}", flush=True)
    if args.sync_invalidate > 0:
        gw.start_sync_invalidation(args.sync_invalidate)

    stop = threading.Event()
    if args.fleet:
        threading.Thread(
            target=_fleet_poll,
            args=(gw, args.fleet, args.fleet_interval, stop),
            daemon=True,
        ).start()
        print(f"run_gateway: routing off {args.fleet}", flush=True)

    api_httpd = None
    if args.api:
        host, _, port = args.api.rpartition(":")
        api_httpd = ThreadingHTTPServer(
            (host or "127.0.0.1", int(port)), _GwApiHandler
        )
        api_httpd.daemon_threads = True
        api_httpd.gateway = gw
        threading.Thread(target=api_httpd.serve_forever, daemon=True).start()
        print(f"run_gateway: operator API @ {args.api}", flush=True)

    def shutdown(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, shutdown)
    signal.signal(signal.SIGINT, shutdown)
    stop.wait()
    if api_httpd is not None:
        api_httpd.shutdown()
    gw.stop()
    print("run_gateway: stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
