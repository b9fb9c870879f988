"""GatewayClient: the end-client side of the front door.

Counterpart of ``bftkv_tpu/gateway/client.py``.

Wraps an ordinary protocol :class:`~bftkv_tpu_torch.protocol.client.Client`'s
transport/crypto/quorum state and talks to a SET of gateways over the
same encrypted session envelope every other command uses — one post per
operation instead of a quorum fan-out.

Routing is rendezvous (HRW) per variable over the gateway set: the same
variable always lands on the same gateway first, so cache hit rates do
not dilute as gateways are added, and write bursts for one variable
meet in one coalescer.  Transport-level failures fail over down the
HRW order (the tier is stateless — any gateway can serve anything);
protocol errors are answers and raise immediately.

Trust: the gateway is NOT trusted.  Every non-empty read is re-verified
here — the served record must name the requested variable and carry a
completed collective signature that verifies against the owner quorum
from THIS client's keyring (memoized by the process verify cache, so
repeat reads of one record cost a dict hit, not RSA).  A compromised
gateway can therefore serve stale-but-certified state at worst, never a
fabricated value — the same bound a Byzantine quorum member already
has against a direct reader.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch import trace
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.errors import ERR_UNCERTIFIED_RECORD, Error
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["GatewayClient", "GatewayPeer"]


class GatewayPeer:
    """A gateway certificate paired with its dial address.

    Gateway certificates deliberately carry NO address (an addressed
    vertex would enter the quorum planes' ``U`` — see
    ``topology.Universe.gateways``), so the transport-facing peer
    object is this wrapper: ``address`` comes from deployment config,
    everything else (id, keys, name) delegates to the certificate."""

    def __init__(self, cert, address: str):
        self.cert = cert
        self.address = address

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "cert"), name)

    def __repr__(self) -> str:  # pragma: no cover
        return f"GatewayPeer({self.cert.name} @ {self.address})"

#: Transport-failure messages that trigger failover to the next
#: gateway; anything else is an answer from a live gateway and raises.
_FAILOVER = {
    tp.ERR_UNREACHABLE.message,
    tp.ERR_RPC_TIMEOUT.message,
    tp.ERR_SERVER_ERROR.message,
    tp.ERR_PEER_OPEN.message,
    tp.ERR_NO_ADDRESS.message,
}


class GatewayClient:
    def __init__(self, client, gateways: list, *, verify: bool = True):
        """``client``: the protocol client whose transport, keyring and
        quorum system this front end rides (it is NOT used for quorum
        fan-outs here).  ``gateways``: peer objects with ``.id``,
        key material, and ``.address`` — typically
        :class:`GatewayPeer` wrappers pairing a gateway certificate
        with its configured dial address."""
        if not gateways:
            raise ValueError("GatewayClient needs at least one gateway")
        self.client = client
        self.gateways = list(gateways)
        self.verify = verify
        # Verified-record memo, keyed by sha256(variable | record):
        # repeat serves of one cached record re-verify as a dict hit.
        # Content-addressed, so it can never validate different bytes;
        # bounded LRU, so a hostile gateway can at worst evict entries.
        self._verified: "OrderedDict[bytes, None]" = OrderedDict()
        self._verified_lock = named_lock("gateway.client.verified")

    _VERIFIED_MAX = 4096

    def _route(self, variable: bytes) -> list:
        """HRW order for ``variable`` over the gateway set."""
        def score(gw):
            h = hashlib.sha256()
            h.update(variable)
            h.update(int(getattr(gw, "id", 0)).to_bytes(8, "big"))
            return h.digest()

        return sorted(self.gateways, key=score)

    def _post(self, cmd: int, gw, req: bytes):
        box: dict = {}

        def cb(res: tp.MulticastResponse) -> bool:
            box["res"] = res
            return True

        self.client.tr.multicast(cmd, [gw], req, cb)
        return box.get("res")

    def _call(self, cmd: int, variable: bytes, req: bytes) -> bytes | None:
        last: Exception | None = None
        for gw in self._route(variable):
            res = self._post(cmd, gw, req)
            if res is None:
                continue
            if res.err is None:
                return res.data
            last = res.err
            if getattr(res.err, "message", None) in _FAILOVER:
                metrics.incr("gateway.client.failover")
                continue  # dead gateway: any other can serve
            raise res.err  # an answer, not an outage
        raise last if last is not None else tp.ERR_UNREACHABLE

    # -- reads -------------------------------------------------------------

    def read(self, variable: bytes, proof=None) -> bytes | None:
        with metrics.timer("gateway.client.read.latency"), trace.span(
            "gateway_client.read"
        ):
            req = pkt.serialize(variable, None, 0, None, proof)
            raw = self._call(tp.GW_READ, variable, req)
            if not raw:
                return None
            p = self._check_served(variable, raw)
            return p.value

    def read_record(
        self, variable: bytes, proof=None
    ) -> tuple[bytes | None, int, bytes | None]:
        """Like :meth:`read` but returns ``(value, t, raw record)`` —
        callers that persist or forward certified records use this."""
        req = pkt.serialize(variable, None, 0, None, proof)
        raw = self._call(tp.GW_READ, variable, req)
        if not raw:
            return None, 0, None
        p = self._check_served(variable, raw)
        return p.value, p.t, raw

    def _check_served(self, variable: bytes, raw: bytes):
        """The client-side half of the certified rule: a served record
        must name the requested variable and (with ``verify`` on)
        carry a completed collective signature endorsed by the owner
        quorum — verified HERE, against this client's own keyring."""
        h = None
        if self.verify:
            h = hashlib.sha256(
                len(variable).to_bytes(8, "big") + variable + raw
            ).digest()
            with self._verified_lock:
                if h in self._verified:
                    self._verified.move_to_end(h)
                    return pkt.parse(raw)
        try:
            p = pkt.parse(raw)
        except Exception:
            raise ERR_UNCERTIFIED_RECORD from None
        if (p.variable or b"") != variable or p.ss is None or (
            not p.ss.completed
        ):
            metrics.incr("gateway.client.verify_fail")
            raise ERR_UNCERTIFIED_RECORD
        if self.verify:
            qa = qm.choose_quorum_for(self.client.qs, variable, qm.AUTH)
            try:
                with trace.span("gateway_client.verify"):
                    self.client.crypt.collective.verify(
                        pkt.tbss(raw), p.ss, qa, self.client.crypt.keyring
                    )
            except Exception:
                metrics.incr("gateway.client.verify_fail")
                raise ERR_UNCERTIFIED_RECORD from None
            with self._verified_lock:
                self._verified[h] = None
                self._verified.move_to_end(h)
                while len(self._verified) > self._VERIFIED_MAX:
                    self._verified.popitem(last=False)
        return p

    # -- writes ------------------------------------------------------------

    def write(self, variable: bytes, value: bytes) -> None:
        """Write through the front door: the HRW-primary gateway signs
        and commits the value upstream (coalescing same-variable
        bursts into one round).  Raises the per-write error on
        failure, exactly like ``Client.write``."""
        with metrics.timer("gateway.client.write.latency"), trace.span(
            "gateway_client.write"
        ):
            req = pkt.serialize(variable, value, 0, None, None)
            self._call(tp.GW_WRITE, variable, req)

    def read_many(self, variables: list[bytes], proof=None) -> list:
        """Convenience sequential batch (one post per variable; the
        gateway's cache makes the common case one dict hit each).
        Returns value / None / the per-item :class:`Error`."""
        out: list = []
        for v in variables:
            try:
                out.append(self.read(v, proof))
            except Error as e:
                out.append(e)
        return out
