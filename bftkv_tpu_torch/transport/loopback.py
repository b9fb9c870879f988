"""In-process loopback transport: direct handler calls, no sockets
(counterpart of ``bftkv_tpu/transport/loopback.py``).

The reference exercises its protocol state machines without transport by
direct calls (the tier-2 "fake backend" pattern —
reference: crypto/threshold/dsa/test_utils/test_utils.go:28-54,
protocol/revoke_test.go:27; SURVEY.md §4). This transport makes that a
first-class backend: the full session layer (sign-then-encrypt, nonce
echo) still runs, only the HTTP hop is elided — so protocol tests and
crypto-bound benchmarks measure the framework, not socket overhead.
"""

from __future__ import annotations

from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.errors import new_error

__all__ = ["LoopbackNet", "TrLoopback"]

ERR_UNREACHABLE = new_error("transport: peer unreachable")


class LoopbackNet:
    """A process-wide registry: address → TransportServer."""

    def __init__(self):
        self.servers: dict[str, object] = {}

    def register(self, addr: str, handler) -> None:
        self.servers[addr] = handler

    def unregister(self, addr: str) -> None:
        self.servers.pop(addr, None)


class TrLoopback:
    """Same interface as TrHTTP over a shared :class:`LoopbackNet`."""

    #: Posts are synchronous in-process calls: when calibration says the
    #: crypto is all-host anyway, the multicast fan-out runs inline on
    #: the caller thread instead of spraying GIL-bound work across pool
    #: threads (transport.multicast).
    INLINE_FANOUT = True

    def __init__(
        self, security, net: LoopbackNet, *, rpc_timeout: float | None = None
    ):
        self.security = security
        self.net = net
        self._addr: str | None = None
        #: Per-RPC deadline honored by the transport-agnostic delay
        #: failpoint (a chaos delay past it becomes a timeout, exactly
        #: like the HTTP socket deadline).  Default mirrors TrHTTP's.
        if rpc_timeout is None:
            from bftkv_tpu_torch.transport.http import default_rpc_timeout

            rpc_timeout = default_rpc_timeout()
        self.rpc_timeout = rpc_timeout
        self.link_id = ""  # servers get theirs on start(); see harness

    # -- client side ------------------------------------------------------
    def post(self, addr: str, msg: bytes) -> bytes:
        if not addr.startswith("loop://"):
            raise ERR_UNREACHABLE
        base, _, name = addr[len("loop://") :].rpartition(tp.PREFIX)
        handler = self.net.servers.get(base)
        if handler is None:
            raise ERR_UNREACHABLE
        cmd = tp.COMMANDS_BY_NAME.get(name)
        if cmd is None:
            raise ERR_UNREACHABLE
        res = handler(cmd, msg) or b""
        tp.record_rpc("loop", "client", name, len(res), len(msg or b""))
        return res

    def multicast(self, cmd: int, peers: list, data: bytes | None, cb) -> None:
        tp.multicast(self, cmd, peers, [data], cb)

    def multicast_m(self, cmd: int, peers: list, mdata: list, cb) -> None:
        tp.multicast(self, cmd, peers, mdata, cb)

    # -- server side ------------------------------------------------------
    def start(self, o, addr: str) -> None:
        self._addr = addr
        self.link_id = addr  # this node's side of every link
        # Same transport.* accounting as TrHTTP._dispatch, so
        # single-process cluster tests see the byte/RPC series a
        # deployed fleet exports.
        self.net.register(addr, tp.instrument_handler("loop", o.handler))

    def stop(self) -> None:
        if self._addr is not None:
            self.net.unregister(self._addr)
            self._addr = None

    # -- session layer ----------------------------------------------------
    def generate_random(self) -> bytes:
        from bftkv_tpu_torch.crypto import rng

        return rng.generate_random(8)

    def encrypt(self, peers: list, plain: bytes, nonce: bytes) -> bytes:
        return self.security.message.encrypt(peers, plain, nonce)

    def decrypt(self, data: bytes):
        return self.security.message.decrypt(data)
