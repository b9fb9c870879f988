"""Visual transport: live trust-graph + request feed over WebSocket.

Counterpart of ``bftkv_tpu/transport/visual.py``.

Capability parity with the reference's http-visual transport
(reference: transport/http-visual/http-visual.go:43-173): wraps the
HTTP transport, and pushes JSON events — request commands as they are
served, the trust graph, and revocations — to any connected WebSocket
client. The browser side is ``visual/index.html`` (vanilla JS + SVG;
the reference vendors cytoscape.js, which a zero-dependency build
cannot).

The WebSocket server is a minimal RFC 6455 implementation (stdlib
only): HTTP upgrade handshake, unfragmented server→client text frames,
close/ping handling. Pushes are fire-and-forget; a slow or dead client
is dropped.
"""

from __future__ import annotations

import base64
import hashlib
import json
import socket
import socketserver
import struct
import threading

from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.transport.http import TrHTTP
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["TrVisual", "WsHub"]

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()
    ).decode()


def _frame_text(payload: bytes) -> bytes:
    n = len(payload)
    if n < 126:
        hdr = struct.pack(">BB", 0x81, n)
    elif n < 1 << 16:
        hdr = struct.pack(">BBH", 0x81, 126, n)
    else:
        hdr = struct.pack(">BBQ", 0x81, 127, n)
    return hdr + payload


class _WsHandler(socketserver.BaseRequestHandler):
    def handle(self):
        sock: socket.socket = self.request
        try:
            data = b""
            while b"\r\n\r\n" not in data:
                chunk = sock.recv(4096)
                if not chunk:
                    return
                data += chunk
            headers = {}
            for line in data.split(b"\r\n")[1:]:
                if b":" in line:
                    k, v = line.split(b":", 1)
                    headers[k.strip().lower()] = v.strip()
            key = headers.get(b"sec-websocket-key")
            if key is None:
                sock.sendall(b"HTTP/1.1 400 Bad Request\r\n\r\n")
                return
            sock.sendall(
                (
                    "HTTP/1.1 101 Switching Protocols\r\n"
                    "Upgrade: websocket\r\n"
                    "Connection: Upgrade\r\n"
                    f"Sec-WebSocket-Accept: {_ws_accept(key.decode())}\r\n\r\n"
                ).encode()
            )
        except OSError:
            return
        hub: "WsHub" = self.server.hub
        hub.attach(sock)
        # The hub owns writes; this thread just watches for close/ping.
        try:
            while True:
                hdr = sock.recv(2)
                if len(hdr) < 2:
                    break
                opcode = hdr[0] & 0x0F
                ln = hdr[1] & 0x7F
                masked = hdr[1] & 0x80
                if ln == 126:
                    ln = struct.unpack(">H", sock.recv(2))[0]
                elif ln == 127:
                    ln = struct.unpack(">Q", sock.recv(8))[0]
                mask = sock.recv(4) if masked else b"\0" * 4
                payload = b""
                while len(payload) < ln:
                    chunk = sock.recv(ln - len(payload))
                    if not chunk:
                        break
                    payload += chunk
                if opcode == 0x8:  # close
                    break
                if opcode == 0x9:  # ping → pong
                    body = bytes(
                        b ^ mask[i % 4] for i, b in enumerate(payload)
                    )
                    with hub._lock:
                        sock.sendall(
                            struct.pack(">BB", 0x8A, len(body)) + body
                        )
        except OSError:
            pass
        finally:
            hub.detach(sock)


class WsHub(socketserver.ThreadingTCPServer):
    """Accepts WebSocket clients and broadcasts JSON events."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr: tuple[str, int]):
        super().__init__(addr, _WsHandler)
        self.hub = self
        self._clients: set[socket.socket] = set()
        self._lock = named_lock("transport.visual")
        # Snapshot sources re-broadcast state (the trust graph) whenever
        # a client attaches, so late joiners see the current picture.
        self.on_attach: list = []
        self._thread = threading.Thread(target=self.serve_forever, daemon=True)
        self._thread.start()

    def attach(self, sock: socket.socket) -> None:
        with self._lock:
            self._clients.add(sock)
        for cb in list(self.on_attach):
            try:
                cb()
            except Exception:
                pass  # an observer callback must never break the hub

    def detach(self, sock: socket.socket) -> None:
        with self._lock:
            self._clients.discard(sock)
        try:
            sock.close()
        except OSError:
            pass

    @property
    def client_count(self) -> int:
        with self._lock:
            return len(self._clients)

    def push(self, event: dict) -> None:
        frame = _frame_text(json.dumps(event).encode())
        sent = 0
        with self._lock:
            dead = []
            for c in self._clients:
                try:
                    c.sendall(frame)
                    sent += 1
                except OSError:
                    dead.append(c)
            for c in dead:
                self._clients.discard(c)
        # The ws feed is a one-way broadcast, so "bytes_out per event
        # type" is its whole transport story (the RPC legs underneath
        # are already counted by the inherited TrHTTP instrumentation).
        labels = {"transport": "ws", "event": str(event.get("type", "?"))}
        metrics.incr("transport.ws.events", labels=labels)
        if sent:
            # Own family (not transport.bytes_out): its label schema is
            # per-event, not record_rpc's (transport, side, cmd).
            metrics.incr(
                "transport.ws.bytes_out", sent * len(frame), labels=labels
            )
        if dead:
            metrics.incr("transport.ws.dropped_clients", len(dead))

    def stop(self) -> None:
        self.shutdown()
        self.server_close()
        with self._lock:
            clients, self._clients = list(self._clients), set()
        for c in clients:
            try:
                c.close()
            except OSError:
                pass


class TrVisual(TrHTTP):
    """TrHTTP that narrates requests and graph state to a WsHub
    (reference: http-visual.go:43-173)."""

    def __init__(self, security, hub: WsHub, graph=None):
        super().__init__(security)
        self.hub = hub
        self.graph = graph

    # -- server side: narrate every dispatched command --------------------
    def _dispatch(self, o):
        inner = super()._dispatch(o)

        def narrating(cmd: int, data: bytes):
            self.hub.push(
                {
                    "type": "request",
                    "command": tp.COMMAND_NAMES.get(cmd, str(cmd)),
                    "node": getattr(self.graph, "name", ""),
                }
            )
            try:
                return inner(cmd, data)
            finally:
                if cmd in (tp.REVOKE, tp.NOTIFY):
                    self.push_graph()

        return narrating

    def start(self, o, addr: str) -> None:
        super().start(o, addr)
        self.hub.on_attach.append(self.push_graph)
        self.push_graph()

    def stop(self) -> None:
        try:
            self.hub.on_attach.remove(self.push_graph)
        except ValueError:
            pass
        super().stop()

    # -- graph snapshots ---------------------------------------------------
    def push_graph(self) -> None:
        g = self.graph
        if g is None:
            return
        nodes = [{"id": f"{g.id:016x}", "name": g.name, "self": True}]
        edges = []
        for peer in g.get_peers():
            nodes.append(
                {"id": f"{peer.id:016x}", "name": peer.name, "self": False}
            )
            for signer in peer.signers():
                edges.append({"from": f"{signer:016x}", "to": f"{peer.id:016x}"})
        revoked = [f"{rid:016x}" for rid in getattr(g, "revoked", {})]
        self.hub.push(
            {"type": "graph", "nodes": nodes, "edges": edges,
             "revoked": revoked}
        )
