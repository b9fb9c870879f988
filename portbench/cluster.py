"""The system under test: one configuration's cluster of the port, in one process.

``build`` takes the benchmark's keys (servers, then storage nodes, then
clients) in the configuration's ``key_algorithm`` ("rsa" or "p256") and
builds the deployment the configuration file states with the port's own
set-up path: ``topology.build_universe`` certifies the
universe, ``topology.make_node`` wires each principal, every server and
storage node is a port ``Server`` on ``MemStorage`` over one
``LoopbackNet``, every client a port ``Client``, and the process-wide
``VerifyDispatcher`` and ``SignDispatcher`` run on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["Cluster", "build"]


@dataclass
class Cluster:
    storage: list
    clients: list
    fanout: str
    nodes: list = field(default_factory=list)

    def stored(self, variable: bytes) -> list[bytes | None]:
        """Each storage node's latest record of ``variable`` (``None``
        where it holds none)."""
        from bftkv_tpu_torch.errors import ERR_NOT_FOUND

        out = []
        for srv in self.storage:
            try:
                out.append(srv.storage.read(variable, 0))
            except ERR_NOT_FOUND:
                out.append(None)
        return out

    def drain(self, timeout: float = 60.0) -> None:
        for c in self.clients:
            c.drain_tails(timeout)

    def stop(self) -> None:
        from bftkv_tpu_torch.ops import dispatch

        for srv in self.nodes:
            srv.tr.stop()
        dispatch.uninstall_all()


def _port_keys(config: dict, keys: list) -> list:
    """The benchmark's keys (:mod:`portbench.keys`) as the port's private
    keys of the configuration's algorithm."""
    from bftkv_tpu_torch.crypto import ec, ecdsa, rsa

    alg = config["key_algorithm"]
    if alg == "rsa":
        return [rsa.PrivateKey(n=k.n, e=k.e, d=k.d, p=k.p, q=k.q) for k in keys]
    if alg != "p256":
        raise ValueError(f"key_algorithm {alg!r}: the harness builds 'rsa' and 'p256'")
    if config["key_bits"] != 256:
        raise ValueError(f"key_bits {config['key_bits']}: P-256 keys are 256 bits")
    out = []
    for i, k in enumerate(keys):
        if ec.P256.scalar_base_mult(k.d) != (k.x, k.y):
            raise RuntimeError(f"key {i}: the port's d·G differs from the harness's public point")
        out.append(ecdsa.ECPrivateKey(d=k.d, public=ecdsa.ECPublicKey(x=k.x, y=k.y)))
    return out


def build(config: dict, n_clients: int, keys: list, device) -> Cluster:
    """The cluster of ``config`` with ``n_clients`` client identities;
    ``keys`` are the benchmark's keys of its algorithm, servers first."""
    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch import transport as tp
    from bftkv_tpu_torch.ops import dispatch
    from bftkv_tpu_torch.protocol.client import Client
    from bftkv_tpu_torch.protocol.server import Server
    from bftkv_tpu_torch.storage.memkv import MemStorage
    from bftkv_tpu_torch.transport.loopback import LoopbackNet, TrLoopback

    for key, want in (("storage", "mem"), ("transport", "loopback")):
        if config[key] != want:
            raise ValueError(f"{key} {config[key]!r}: the harness builds {want!r} only")
    n, n_rw = config["servers"], config["storage_nodes"]
    if len(keys) != n + n_rw + n_clients:
        raise ValueError(f"{len(keys)} keys for {n} servers, {n_rw} storage nodes, {n_clients} clients")
    pkeys = _port_keys(config, keys)
    uni = topology.build_universe(n, n_clients, n_rw, bits=config["key_bits"], alg=config["key_algorithm"],
                                  keys=pkeys)
    net = LoopbackNet()
    nodes = {}
    for ident in uni.servers + uni.storage_nodes:
        g, crypt, qs = topology.make_node(ident, uni.view_of(ident), device=device)
        srv = Server(g, qs, TrLoopback(crypt, net), crypt, MemStorage(), device=device)
        srv.start()
        nodes[ident.name] = srv
    clients = []
    for ident in uni.users:
        g, crypt, qs = topology.make_node(ident, uni.view_of(ident), device=device)
        tr = TrLoopback(crypt, net)
        tr.link_id = ident.name
        clients.append(Client(g, qs, tr, crypt, device=device))
    mb = config["dispatch_max_batch"]
    dispatch.install(dispatch.VerifyDispatcher(max_batch=mb, device=device))
    dispatch.install_signer(dispatch.SignDispatcher(max_batch=mb, device=device))
    fanout = "inline" if tp._inline_fanout_ok() else "threaded"
    return Cluster(
        storage=[nodes[i.name] for i in uni.storage_nodes],
        clients=clients,
        fanout=fanout,
        nodes=list(nodes.values()),
    )
