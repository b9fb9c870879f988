"""HTTP transport: POST bodies under ``/bftkv/v1/<cmd>``, errors tunneled
in the ``x-error`` response header (counterpart of
``bftkv_tpu/transport/http.py``).

Capability parity with the reference (transport/http/http.go): 5 s
connect / 10 s response timeouts (http.go:39-50), path→command dispatch
(http.go:97-149), interned errors round-tripped via ``x-error``
(http.go:59-66), crypto delegation for the session layer
(http.go:151-161). The server is a threading HTTP server — one OS
thread per in-flight request, matching the reference's ``net/http``
concurrency model (many servers run in one test process).
"""

from __future__ import annotations

import http.client
import socket
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.errors import Error, error_from_string
from bftkv_tpu_torch.metrics import registry as metrics

__all__ = ["TrHTTP", "MalTrHTTP", "default_rpc_timeout"]

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

CONNECT_TIMEOUT = 5.0
# The reference pins 10 s (http.go:39-50); configurable because a
# many-server in-process cluster on a shared CPU box can push honest
# handlers past it (tests; CI), and chaos-delay runs need it *short*.
# BFTKV_RPC_TIMEOUT is the canonical knob (--rpc-timeout plumbs it);
# BFTKV_HTTP_TIMEOUT stays honored for compatibility.
RESPONSE_TIMEOUT = float(
    flags.raw("BFTKV_RPC_TIMEOUT")
    or flags.raw("BFTKV_HTTP_TIMEOUT")
    or "10"
)
NONCE_SIZE = 8


def default_rpc_timeout() -> float:
    return RESPONSE_TIMEOUT


def _is_timeout(e: Exception) -> bool:
    if isinstance(e, (TimeoutError, socket.timeout)):
        return True
    reason = getattr(e, "reason", None)
    return isinstance(reason, (TimeoutError, socket.timeout))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    #: Socket timeout for one keep-alive connection's next request:
    #: clients pool persistent connections now, and an idle connection
    #: must release its server thread instead of parking it forever.
    timeout = 60.0

    def log_message(self, fmt, *args):  # quiet; observability lives upstream
        pass

    def do_POST(self):
        path = self.path.lower()
        if not path.startswith(tp.PREFIX):
            self.send_error(404)
            return
        cmd = tp.COMMANDS_BY_NAME.get(path[len(tp.PREFIX) :])
        if cmd is None:
            self.send_error(404)
            return
        try:
            length = int(self.headers.get("content-length", "0"))
            body = self.rfile.read(length)
        except Exception:
            self.send_error(400)
            return
        try:
            res = self.server.owner_handler(cmd, body)
        except Error as e:
            self.send_response(500)
            self.send_header("x-error", e.message)
            self.send_header("content-length", "0")
            self.end_headers()
            return
        except Exception:
            self.send_response(500)
            self.send_header("x-error", "internal error")
            self.send_header("content-length", "0")
            self.end_headers()
            return
        res = res or b""
        self.send_response(200)
        self.send_header("content-type", "application/octet-stream")
        self.send_header("content-length", str(len(res)))
        self.end_headers()
        self.wfile.write(res)


class _ConnPool:
    """Bounded per-peer pool of keep-alive ``HTTPConnection`` objects.

    The old client opened a fresh TCP connection per RPC
    (``urllib.request.urlopen``) — three-way handshake plus slow-start
    on every one of a write's ~12 posts.  Connections returned here are
    reused across RPCs (``transport.conn.reused``), dialed on demand
    (``transport.conn.dialed``), and capped at ``per_peer`` idle
    connections per (host, port) so a wide fan-out cannot accumulate
    sockets without bound."""

    def __init__(self, per_peer: int | None = None):
        if per_peer is None:
            per_peer = int(flags.raw("BFTKV_HTTP_POOL", "4") or 4)
        self.per_peer = per_peer
        self._lock = named_lock("transport.pool")
        self._idle: dict[tuple[str, int], list[http.client.HTTPConnection]] = {}
        self._closed = False

    def acquire(
        self, host: str, port: int, timeout: float
    ) -> tuple[http.client.HTTPConnection, bool]:
        """(connection, was_reused).  A reused connection's socket
        deadline is refreshed to this RPC's timeout."""
        key = (host, port)
        with self._lock:
            idle = self._idle.get(key)
            conn = idle.pop() if idle else None
        if conn is not None:
            conn.timeout = timeout
            if conn.sock is None:
                conn = None  # closed under us: dial honestly instead
            else:
                try:
                    conn.sock.settimeout(timeout)
                except OSError:
                    conn = None
            if conn is not None:
                metrics.incr("transport.conn.reused")
                return conn, True
        conn = http.client.HTTPConnection(host, port, timeout=timeout)
        conn.connect()
        metrics.incr("transport.conn.dialed")
        return conn, False

    def release(self, host: str, port: int, conn) -> None:
        with self._lock:
            if not self._closed:
                idle = self._idle.setdefault((host, port), [])
                if len(idle) < self.per_peer:
                    idle.append(conn)
                    total = sum(len(v) for v in self._idle.values())
                    metrics.gauge(
                        "transport.conn.idle", float(total),
                        labels={"resource": "conn_pool"},
                    )
                    return
        try:
            conn.close()
        except Exception:
            pass  # over-quota idle socket: close is best-effort

    def close_all(self) -> None:
        with self._lock:
            conns = [c for idle in self._idle.values() for c in idle]
            self._idle.clear()
            self._closed = True
        for c in conns:
            try:
                c.close()
            except Exception:
                pass  # already-dead sockets close noisily on shutdown


class TrHTTP:
    """(reference: http.go:21-95)."""

    def __init__(self, security, *, rpc_timeout: float | None = None):
        self.security = security
        #: Per-RPC response deadline; the transport-agnostic fault and
        #: retry layer (transport._send) reads the same attribute.
        self.rpc_timeout = (
            rpc_timeout if rpc_timeout is not None else RESPONSE_TIMEOUT
        )
        self.link_id = ""  # set on start(); clients keep ""
        self._server: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._pool = _ConnPool()

    # -- client side ------------------------------------------------------
    def post(self, addr: str, msg: bytes) -> bytes:
        """One RPC over a pooled keep-alive connection.

        A *reused* connection that dies before any response byte
        arrives (the server closed it while idle — the classic
        keep-alive race) is re-dialed once, transparently; the retry
        honors the same per-RPC deadline and is invisible to the
        circuit-breaker/retry layer above (``transport._send``), which
        only ever sees one logical attempt."""
        parts = urllib.parse.urlsplit(addr)
        host = parts.hostname or ""
        port = parts.port or 80
        path = parts.path
        cmd_name = addr.rsplit("/", 1)[-1]
        body = msg or b""
        # The adaptive per-peer deadline (transport.current_deadline)
        # replaces the one fixed response timeout when the fan-out
        # layer computed one for this peer; the fixed rpc_timeout stays
        # the ceiling either way.
        timeout = tp.current_deadline(self.rpc_timeout)
        while True:
            try:
                conn, reused = self._pool.acquire(host, port, timeout)
            except Exception as e:
                if _is_timeout(e):
                    raise tp.ERR_RPC_TIMEOUT from None
                raise tp.ERR_SERVER_ERROR from None
            try:
                try:
                    conn.request(
                        "POST",
                        path,
                        body=body,
                        headers={"content-type": "application/octet-stream"},
                    )
                    res = conn.getresponse()
                except (
                    http.client.RemoteDisconnected,
                    BrokenPipeError,
                    ConnectionResetError,
                ):
                    conn.close()
                    if reused:
                        # Stale pooled connection (the server closed it
                        # while idle): discard and retry transparently.
                        # EVERY aged pooled connection may be stale at
                        # once, so keep discarding until a fresh dial —
                        # only a fresh connection failing this way is a
                        # real server failure.  No response byte was
                        # consumed, so the request cannot have been
                        # half-served twice from this client's view.
                        metrics.incr("transport.conn.redialed")
                        continue
                    raise tp.ERR_SERVER_ERROR from None
                data = res.read()
                keep = not res.will_close
                errs = res.getheader("x-error")
                status = res.status
                if keep:
                    self._pool.release(host, port, conn)
                else:
                    conn.close()
                if status == 500 and errs:
                    raise error_from_string(errs)
                if status != 200:
                    raise tp.ERR_SERVER_ERROR
                tp.record_rpc("http", "client", cmd_name, len(data), len(body))
                return data
            except Error:
                raise
            except Exception as e:
                try:
                    conn.close()
                except Exception:
                    pass  # best-effort close; e is classified below
                if _is_timeout(e):
                    raise tp.ERR_RPC_TIMEOUT from None
                raise tp.ERR_SERVER_ERROR from None

    def multicast(self, cmd: int, peers: list, data: bytes | None, cb) -> None:
        tp.multicast(self, cmd, peers, [data], cb)

    def multicast_m(self, cmd: int, peers: list, mdata: list, cb) -> None:
        tp.multicast(self, cmd, peers, mdata, cb)

    # -- server side ------------------------------------------------------
    def start(self, o, addr: str) -> None:
        """``addr`` is ``host:port`` (the listen side of the node's
        certificate address)."""
        host, _, port = addr.rpartition(":")
        self.link_id = addr  # this node's side of every link
        self._server = ThreadingHTTPServer(
            (host or "127.0.0.1", int(port)), _Handler
        )
        self._server.owner_handler = self._dispatch(o)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def _dispatch(self, o):
        return tp.instrument_handler("http", o.handler)

    def stop(self) -> None:
        self._pool.close_all()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

    # -- session-layer delegation (reference: http.go:151-161) ------------
    def generate_random(self) -> bytes:
        from bftkv_tpu_torch.crypto import rng

        return rng.generate_random(NONCE_SIZE)

    def encrypt(self, peers: list, plain: bytes, nonce: bytes) -> bytes:
        return self.security.message.encrypt(peers, plain, nonce)

    def decrypt(self, data: bytes):
        return self.security.message.decrypt(data)


class MalTrHTTP(TrHTTP):
    """Routes to a ``mal_handler`` when present — the Byzantine test hook
    (reference: transport/maltransport.go:10-12, http/malhttp.go:21-41)."""

    def _dispatch(self, o):
        return getattr(o, "mal_handler", None) or o.handler
