"""Helpers shared by the port's tests (tests/test_torch_*.py), and their
own tests.

Imports torch and the port only, so the card's test file can use it on a
machine without JAX.  The other test modules import it by its bare name,
as they import ``cluster_utils``.
"""

from __future__ import annotations

import functools
import random
import socket
from dataclasses import dataclass, field

import pytest
import torch


def moduli(ctx, bits: int, count: int, seed: int) -> list[int]:
    """``count`` seeded odd ``bits``-bit moduli that the RNS context takes."""
    rng = random.Random(seed)
    out = []
    while len(out) < count:
        n = rng.getrandbits(bits) | 1 | (1 << (bits - 1))
        if ctx.key_rows(n) is not None:
            out.append(n)
    return out


@pytest.fixture(scope="module")
def one_torch_thread():
    """Runs a module's tests with one intra-op torch thread.

    The suite runs in several pytest-xdist workers at once; torch's own
    thread pool in each of them oversubscribes the cores many times over
    and makes the plain versions' small products some 50x slower.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the port's in-process clusters ------------------------------------------

#: The cluster tests' device and key width (the reference's tests use
#: 1024-bit keys on the CPU as well).
DEVICE = "cpu"
BITS = 1024


@functools.lru_cache(maxsize=None)
def seeded_key(bits: int, seed: int):
    """One seeded RSA key, generated once per process: clusters of a test
    module reuse the same identities' keys instead of generating anew."""
    from bftkv_tpu_torch.crypto import rsa

    return rsa.generate(bits, seed=seed)


def seeded_keys(count: int, bits: int = BITS, base: int = 0) -> list:
    return [seeded_key(bits, base + i) for i in range(count)]


def free_port_block(n: int, *, lo: int = 20000, hi: int = 32000, tries: int = 200) -> int:
    """The first port of ``n`` consecutive ports that the OS lets this
    process bind on 127.0.0.1, probed from a random start in
    ``[lo, hi)``: above the reference's fixed blocks from 16001
    (``cluster_utils.py``) and below the OS's ephemeral range, so no
    pytest-xdist worker's cluster takes another's ports."""
    rng = random.Random()
    for _ in range(tries):
        base = rng.randrange(lo, hi - n)
        held = []
        try:
            for port in range(base, base + n):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                held.append(s)
                s.bind(("127.0.0.1", port))
        except OSError:
            continue
        finally:
            for s in held:
                s.close()
        return base
    raise RuntimeError(f"no {n} consecutive free ports in [{lo}, {hi})")


@dataclass
class Cluster:
    """The port's counterpart of ``cluster_utils.Cluster``."""

    universe: object
    net: object
    servers: list = field(default_factory=list)  # quorum (a*)
    storage_servers: list = field(default_factory=list)  # rw*
    clients: list = field(default_factory=list)
    gateways: list = field(default_factory=list)  # bftkv_tpu_torch.gateway
    gateway_addrs: dict = field(default_factory=dict)

    @property
    def all_servers(self) -> list:
        return self.servers + self.storage_servers

    def gateway_client(self, i: int = 0, *, verify: bool = True):
        """A front-door client riding user ``i``'s identity against every
        gateway of the cluster (``cluster_utils.Cluster.gateway_client``)."""
        from bftkv_tpu_torch.gateway import GatewayClient, GatewayPeer

        client = self.clients[i]
        peers = [
            GatewayPeer(client.crypt.keyring.get(gw.self_node.get_self_id()),
                        self.gateway_addrs[gw.self_node.name])
            for gw in self.gateways
        ]
        return GatewayClient(client, peers, verify=verify)

    def stop(self) -> None:
        for gw in self.gateways:
            gw.stop()
        for s in self.all_servers:
            s.tr.stop()
        if self.universe.regions:
            from bftkv_tpu_torch import regions

            regions.clear()

    def server_named(self, name: str):
        idents = self.universe.servers + self.universe.storage_nodes
        for ident, srv in zip(idents, self.all_servers):
            if ident.name == name:
                return srv
        raise KeyError(name)

    def restart(self, name: str):
        """A fresh server of the same class from the same identity onto
        the same store (the reference harness's crash-restart), on the
        old one's device and loopback net."""
        from bftkv_tpu_torch import topology
        from bftkv_tpu_torch.transport.loopback import TrLoopback

        old = self.server_named(name)
        old.tr.stop()
        ident = next(i for i in self.universe.servers + self.universe.storage_nodes
                     if i.name == name)
        graph, crypt, qs = topology.make_node(ident, self.universe.view_of(ident),
                                              device=old.device)
        srv = type(old)(graph, qs, TrLoopback(crypt, self.net), crypt, old.storage,
                        device=old.device)
        srv.start()
        for pool in (self.servers, self.storage_servers):
            for i, s in enumerate(pool):
                if s is old:
                    pool[i] = srv
        return srv


def build_universe(
    n_servers: int = 4,
    n_users: int = 1,
    n_rw: int = 4,
    *,
    bits: int = BITS,
    transport: str = "loop",
    unsigned_users: int = 0,
    n_shards: int = 1,
    n_regions: int = 0,
    key_base: int = 0,
    n_gateways: int = 0,
):
    """A seeded universe of the port's topology: ``transport="http"``
    addresses every server (and gateway) at a free localhost port block."""
    from bftkv_tpu_torch import topology

    n_keys = (n_servers + n_rw) * n_shards + n_users + n_gateways
    kw = dict(
        bits=bits, unsigned_users=unsigned_users, n_shards=n_shards,
        n_regions=n_regions, keys=seeded_keys(n_keys, bits, key_base),
        n_gateways=n_gateways,
    )
    if transport == "http":
        n_nodes = n_servers * n_shards + n_rw * n_shards
        base = free_port_block(n_nodes + n_gateways)
        return topology.build_universe(
            n_servers, n_users, n_rw, scheme="http", base_port=base,
            rw_base_port=base + n_servers * n_shards,
            gw_base_port=base + n_nodes, **kw,
        )
    if transport != "loop":
        raise ValueError(f"transport must be 'loop' or 'http', got {transport!r}")
    return topology.build_universe(n_servers, n_users, n_rw, scheme="loop", **kw)


def start_cluster(
    n_servers: int = 4,
    n_users: int = 1,
    n_rw: int = 4,
    *,
    bits: int = BITS,
    unsigned_users: int = 0,
    storage_factory=None,
    server_cls=None,
    client_cls=None,
    transport_cls=None,
    transport: str = "loop",
    n_shards: int = 1,
    n_regions: int = 0,
    device=DEVICE,
    key_base: int = 0,
    n_gateways: int = 0,
) -> Cluster:
    """The port's ``cluster_utils.start_cluster``: ``n_servers`` quorum
    servers and ``n_rw`` storage nodes (per shard) and ``n_users``
    clients, every one a port node on ``device``, over one loopback net
    (``transport="loop"``) or on localhost HTTP (``"http"``, ports from
    :func:`free_port_block`).  Keys are seeded (:func:`seeded_key`)."""
    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch.protocol.client import Client
    from bftkv_tpu_torch.protocol.server import Server
    from bftkv_tpu_torch.storage.memkv import MemStorage
    from bftkv_tpu_torch.transport.http import TrHTTP
    from bftkv_tpu_torch.transport.loopback import LoopbackNet, TrLoopback

    storage_factory = storage_factory or MemStorage
    server_cls = server_cls or Server
    client_cls = client_cls or Client
    uni = build_universe(
        n_servers, n_users, n_rw, bits=bits, transport=transport,
        unsigned_users=unsigned_users, n_shards=n_shards, n_regions=n_regions,
        key_base=key_base, n_gateways=n_gateways,
    )
    if transport == "http":
        http_cls = transport_cls or TrHTTP
        net = None
        make_tr = lambda crypt: http_cls(crypt)
    else:
        net = LoopbackNet()
        loop_cls = transport_cls or TrLoopback
        make_tr = lambda crypt: loop_cls(crypt, net)
    if uni.regions:
        from bftkv_tpu_torch import regions

        regions.install(uni.regions)
    cluster = Cluster(universe=uni, net=net)
    for ident in uni.servers + uni.storage_nodes:
        graph, crypt, qs = topology.make_node(ident, uni.view_of(ident), device=device)
        srv = server_cls(graph, qs, make_tr(crypt), crypt, storage_factory(), device=device)
        srv.start()
        (cluster.servers if ident in uni.servers else cluster.storage_servers).append(srv)
    for ident in uni.users:
        graph, crypt, qs = topology.make_node(ident, uni.view_of(ident), device=device)
        tr = make_tr(crypt)
        tr.link_id = ident.name
        cluster.clients.append(client_cls(graph, qs, tr, crypt, device=device))
    for ident in uni.gateways:
        from bftkv_tpu_torch.gateway import Gateway

        graph, crypt, qs = topology.make_node(ident, uni.view_of(ident), device=device)
        gw = Gateway(graph, qs, make_tr(crypt), crypt, device=device)
        dial = uni.gateway_addrs[ident.name]
        gw.start(dial.split("://", 1)[-1])
        cluster.gateways.append(gw)
        cluster.gateway_addrs[ident.name] = dial
    return cluster


@pytest.mark.parametrize("bits", [512, 1024, 2048])
def test_moduli_are_seeded_odd_and_accepted(bits):
    from bftkv_tpu_torch.ops import rns

    ctx = rns.context()
    ns = moduli(ctx, bits, 3, seed=bits)
    assert ns == moduli(ctx, bits, 3, seed=bits)
    assert len(set(ns)) == 3
    for n in ns:
        assert n % 2 == 1 and n.bit_length() == bits
        assert ctx.key_rows(n) is not None


def test_one_torch_thread_pins_one_thread(one_torch_thread):
    assert torch.get_num_threads() == 1


def test_free_port_block_binds_and_avoids_the_reference_blocks():
    base = free_port_block(8)
    assert 20000 <= base and base + 8 <= 32000
    socks = []
    try:
        for port in range(base, base + 8):
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            socks.append(s)
            s.bind(("127.0.0.1", port))
    finally:
        for s in socks:
            s.close()


def test_port_cluster_writes_and_reads_on_the_cpu():
    """The tier-1 port cluster drive: a 4+4 loopback cluster of port
    servers and a port client on ``cpu``."""
    c = start_cluster(4, 1, 4)
    try:
        cl = c.clients[0]
        cl.write(b"drive/x", b"v1")
        assert cl.read(b"drive/x") == b"v1"
        assert all(s.device == torch.device("cpu") for s in c.all_servers)
    finally:
        c.stop()
