"""HTTP surface of the fleet collector: ``/fleet`` JSON + Prometheus.

Counterpart of ``bftkv_tpu/obs/http.py``.

Same stance as the daemon API (cmd/bftkv.py): stdlib-only threading
HTTP server, content negotiation on one path — scrapers asking for
text (or ``?format=prometheus``) get the exposition, everyone else the
full JSON health document.  ``/fleet/trace/<id>`` serves one stitched
trace as a nested tree; ``/fleet/capacity`` serves just the capacity
section (USE rows + bottleneck verdict, DESIGN.md §20) for dashboards
that poll only the planning signal.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["serve_fleet"]


class _FleetHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *a):
        pass

    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("content-type", ctype)
        self.send_header("content-length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        collector = self.server.collector
        try:
            if self.path == "/fleet/bundle" or self.path.startswith(
                "/fleet/bundle?"
            ):
                # Demand flight-recorder snapshot (cmd.fleet --bundle
                # against a listening collector): POST-only — it writes
                # to disk.
                rec = getattr(collector, "recorder", None)
                if rec is None:
                    self._reply(
                        404,
                        b"no flight recorder attached "
                        b"(cmd.fleet --recorder DIR)\n",
                        "text/plain",
                    )
                    return
                bundle = rec.snapshot(reason="demand")
                self._reply(
                    200,
                    json.dumps({"bundle": bundle}).encode() + b"\n",
                    "application/json",
                )
            else:
                self._reply(404, b"unknown endpoint\n", "text/plain")
        except Exception as e:  # operator surface: never die
            self._reply(500, (str(e) + "\n").encode(), "text/plain")

    def do_GET(self):
        collector = self.server.collector
        path = self.path
        try:
            if path.startswith("/fleet/trace/"):
                tid = urllib.parse.unquote(path[len("/fleet/trace/"):])
                tree = collector.stitcher.tree(tid.split("?", 1)[0])
                if tree is None:
                    self._reply(404, b"unknown trace\n", "text/plain")
                    return
                self._reply(
                    200,
                    json.dumps(tree, sort_keys=True, default=str).encode(),
                    "application/json",
                )
            elif path == "/fleet/capacity" or path.startswith(
                "/fleet/capacity?"
            ):
                # Just the capacity section — the health document is
                # large; a saturation dashboard needs only this.
                self._reply(
                    200,
                    json.dumps(
                        collector.health().get("capacity") or {},
                        sort_keys=True,
                        default=str,
                    ).encode(),
                    "application/json",
                )
            elif path == "/fleet" or path.startswith("/fleet?"):
                q = urllib.parse.parse_qs(
                    urllib.parse.urlparse(path).query
                )
                accept = self.headers.get("accept") or ""
                want_prom = q.get("format", [""])[0] == "prometheus" or (
                    "application/json" not in accept
                    and (
                        "text/plain" in accept or "openmetrics" in accept
                    )
                )
                if want_prom:
                    self._reply(
                        200,
                        collector.prometheus().encode(),
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                else:
                    self._reply(
                        200,
                        json.dumps(
                            collector.health(),
                            sort_keys=True,
                            default=str,
                        ).encode(),
                        "application/json",
                    )
            elif path == "/metrics" or path.startswith("/metrics?"):
                # Scraper convenience: the collector exposes ITS fleet
                # rollup here, so one Prometheus job covers the plane.
                self._reply(
                    200,
                    collector.prometheus().encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            elif path == "/healthz":
                self._reply(200, b"ok\n", "text/plain")
            else:
                self._reply(404, b"unknown endpoint\n", "text/plain")
        except Exception as e:  # operator surface: never die
            self._reply(500, (str(e) + "\n").encode(), "text/plain")


def serve_fleet(collector, addr: str) -> ThreadingHTTPServer:
    """Serve ``/fleet`` for ``collector`` on ``host:port``; returns the
    started server (daemon threads — call ``.shutdown()`` to stop)."""
    host, _, port = addr.rpartition(":")
    httpd = ThreadingHTTPServer((host or "127.0.0.1", int(port)),
                                _FleetHandler)
    httpd.daemon_threads = True
    httpd.collector = collector
    threading.Thread(
        target=httpd.serve_forever, name="fleet-http", daemon=True
    ).start()
    return httpd
