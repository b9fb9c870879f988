"""In-package loopback chaos cluster (counterpart of
``bftkv_tpu/faults/harness.py``).

The nemesis CLI (``python -m bftkv_tpu_torch.faults.nemesis``) needs
the same capability *inside* the package — plus two chaos-specific
powers the test fixture doesn't have:

- every replica's storage is wrapped in a
  :class:`~bftkv_tpu_torch.faults.checker.RecordingStorage` feeding one
  shared :class:`~bftkv_tpu_torch.faults.checker.HistoryRecorder`;
- :meth:`ChaosCluster.crash` / :meth:`ChaosCluster.restart` model a
  real crash-restart: the old ``Server`` object is abandoned, a fresh
  one is built from the same identity **onto the same storage** (the
  in-process analog of restarting a daemon on its data dir), so
  anti-entropy has to converge the rejoined replica.

Every node of the cluster (servers, storage nodes, clients, gateways) is
built on one ``device`` (default ``cuda:0``, which raises without CUDA;
``"cpu"`` runs the plain versions of the kernels): a restarted replica
comes back on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import topology
from bftkv_tpu_torch.faults.checker import HistoryRecorder, RecordingStorage
from bftkv_tpu_torch.protocol.client import Client
from bftkv_tpu_torch.protocol.server import Server
from bftkv_tpu_torch.storage.memkv import MemStorage
from bftkv_tpu_torch.transport.loopback import LoopbackNet, TrLoopback

__all__ = ["ChaosCluster", "build_cluster"]


@dataclass
class ChaosCluster:
    universe: topology.Universe
    net: LoopbackNet
    recorder: HistoryRecorder
    device: object = None
    servers: list[Server] = field(default_factory=list)  # quorum (a*)
    storage_servers: list[Server] = field(default_factory=list)  # rw*
    clients: list[Client] = field(default_factory=list)
    gateways: list = field(default_factory=list)  # bftkv_tpu_torch.gateway
    gateway_addrs: dict[str, str] = field(default_factory=dict)
    _by_name: dict[str, Server] = field(default_factory=dict)
    _idents: dict[str, object] = field(default_factory=dict)

    def gateway_names(self) -> list[str]:
        return [gw.self_node.name for gw in self.gateways]

    def gateway_client(self, i: int = 0, *, verify: bool = True):
        from bftkv_tpu_torch.gateway import GatewayClient, GatewayPeer

        client = self.clients[i % len(self.clients)]
        peers = [
            GatewayPeer(
                client.crypt.keyring.get(gw.self_node.get_self_id()),
                self.gateway_addrs[gw.self_node.name],
            )
            for gw in self.gateways
        ]
        return GatewayClient(client, peers, verify=verify)

    @property
    def all_servers(self) -> list[Server]:
        return self.servers + self.storage_servers

    @property
    def f(self) -> int:
        """Fault bound of the replica group chaos targets (the storage
        replicas when present, else the quorum servers).  Sharded
        clusters use the PER-SHARD group size: each shard tolerates its
        own f, and the checker's commit threshold must match the quorum
        a single shard actually forms."""
        n = len(self.storage_servers) or len(self.servers)
        nsh = len(self.universe.shards)
        if nsh > 1:
            n = max(1, n // nsh)
        return (n - 1) // 3

    def server_named(self, name: str) -> Server:
        return self._by_name[name]

    def names(self, storage_only: bool = True) -> list[str]:
        if len(self.universe.shards) > 1:
            # Sharded cluster: chaos targets span BOTH planes of every
            # shard — faults must be able to straddle shard boundaries.
            return [
                i.name
                for i in self.universe.servers + self.universe.storage_nodes
            ]
        idents = (
            self.universe.storage_nodes
            if storage_only and self.universe.storage_nodes
            else self.universe.servers
        )
        return [i.name for i in idents]

    def shard_map(self) -> dict[str, int] | None:
        """Replica name -> shard index (clique membership or storage
        assignment), or None for unsharded clusters — the checker's
        cross-shard invariant input."""
        out: dict[str, int] = {}
        sharded = False
        for name, srv in self._by_name.items():
            idx_of = getattr(srv.qs, "shard_index_of", None)
            if idx_of is None:
                continue
            idx = idx_of(srv.self_node.get_self_id())
            if idx is not None:
                out[name] = idx
                sharded = True
        return out if sharded else None

    # -- crash / restart ---------------------------------------------------

    def crash(self, name: str) -> None:
        """Take the replica dark: transport unregistered, peers see
        unreachable.  State (the recording storage) survives."""
        self._by_name[name].tr.stop()

    def restart(self, name: str) -> Server:
        """Fresh Server from the same identity onto the same storage —
        the crash-restart the anti-entropy plane must repair."""
        old = self._by_name[name]
        old.tr.stop()  # idempotent when already crashed
        # Disk-backed engines (§19 log): a real restart re-opens the
        # data dir — drop the in-RAM index, rebuild from the segment
        # scan, truncate any torn tail.  The RecordingStorage wrapper
        # passes reopen() through; memory backends have none.
        reopen = getattr(old.storage, "reopen", None)
        if reopen is not None:
            reopen()
        ident = self._idents[name]
        graph, crypt, qs = topology.make_node(
            ident, self.universe.view_of(ident), device=self.device
        )
        srv = type(old)(
            graph, qs, TrLoopback(crypt, self.net), crypt, old.storage,
            device=self.device,
        )
        srv.start()
        self._by_name[name] = srv
        for pool in (self.servers, self.storage_servers):
            for i, s in enumerate(pool):
                if s is old:
                    pool[i] = srv
        return srv

    def stop(self) -> None:
        for gw in self.gateways:
            gw.stop()
        for s in self.all_servers:
            s.tr.stop()
        if self.universe.regions:
            # Process-global geography must not outlive its fleet.
            from bftkv_tpu_torch import regions

            regions.clear()


def build_cluster(
    n_servers: int = 4,
    n_users: int = 1,
    n_rw: int = 4,
    *,
    bits: int = 1024,
    recorder: HistoryRecorder | None = None,
    server_cls=Server,
    storage_factory=MemStorage,
    n_shards: int = 1,
    n_gateways: int = 0,
    n_regions: int = 0,
    device=None,
) -> ChaosCluster:
    """``device`` places every node (``None``: ``cuda:0``, which raises
    here without CUDA, before any key is generated)."""
    device = devmod.resolve(device)
    uni = topology.build_universe(
        n_servers, n_users, n_rw, scheme="loop", bits=bits,
        n_shards=n_shards, n_gateways=n_gateways, n_regions=n_regions,
    )
    if uni.regions:
        from bftkv_tpu_torch import regions

        regions.install(uni.regions)
    net = LoopbackNet()
    recorder = recorder or HistoryRecorder()
    cluster = ChaosCluster(
        universe=uni, net=net, recorder=recorder, device=device
    )
    for ident in uni.servers + uni.storage_nodes:
        graph, crypt, qs = topology.make_node(
            ident, uni.view_of(ident), device=device
        )
        storage = RecordingStorage(
            storage_factory(), ident.name, recorder
        )
        srv = server_cls(
            graph, qs, TrLoopback(crypt, net), crypt, storage, device=device
        )
        srv.start()
        cluster._by_name[ident.name] = srv
        cluster._idents[ident.name] = ident
        if ident in uni.servers:
            cluster.servers.append(srv)
        else:
            cluster.storage_servers.append(srv)
    for i, ident in enumerate(uni.users):
        graph, crypt, qs = topology.make_node(
            ident, uni.view_of(ident), device=device
        )
        tr = TrLoopback(crypt, net)
        tr.link_id = ident.name  # clients are partitionable links too
        cluster.clients.append(Client(graph, qs, tr, crypt, device=device))
    for ident in uni.gateways:
        from bftkv_tpu_torch.gateway import Gateway

        graph, crypt, qs = topology.make_node(
            ident, uni.view_of(ident), device=device
        )
        gw = Gateway(graph, qs, TrLoopback(crypt, net), crypt, device=device)
        dial = uni.gateway_addrs[ident.name]
        gw.start(dial.split("://", 1)[-1])
        cluster.gateways.append(gw)
        cluster.gateway_addrs[ident.name] = dial
    return cluster
