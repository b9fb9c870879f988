"""Programmatic key/topology generation — the GnuPG script replacement (counterpart of ``bftkv_tpu/topology.py``).

The reference builds its test universe with shell + GnuPG
(scripts/setup.sh:17-48, gen.sh, clique.sh, trust.sh): server cliques
are pairwise cross-signed keys, trust edges are directed key
signatures living in *each node's own keyring*, and the node address
rides inside the PGP uid comment.  Here the same topology is built
programmatically: RSA keys, compact certificates with first-class
address fields, explicit cross-sign / sign helpers, and per-principal
keyring views.

Canonical shape (mirrors setup.sh):
- ``n`` quorum servers (a01…) pairwise cross-signed into one clique;
- ``n_rw`` storage-only nodes (rw01…) that each sign every quorum
  server in their own view (``trust.sh -t signer rwXX a*``) — they are
  not cross-signed, so they form the READ-quorum complement;
- users sign the first ``n-(f+1)`` servers and every rw node in their
  own view (``trust.sh -t signer uXX a0[1-6] rw*``);
- the last ``f+1`` servers counter-sign each user's certificate so
  users carry a valid quorum certificate (``trust.sh -t signee a07 u01
  …``; u04 deliberately left unsigned for TOFU tests →
  ``unsigned_users``).

Keeping the user→server edges out of the shared certificates is
essential: they exist only in the signer's own keyring, exactly as
with GnuPG.  A universal shared view would create spurious
bidirectional user↔server edges that poison the unique-maximal-clique
assumption (reference: graph.go:347-355).

Device seam: :func:`make_node` and :func:`load_home` build the node's
``CollectiveSignature``, whose batched verify runs on a device, so both
take ``device=`` (``None``: ``cuda:0``, which raises without CUDA;
``"cpu"``: the plain versions).  :func:`new_identity` and
:func:`build_universe` also take pre-made keys, so a seeded universe can
be built without generating keys.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import new_crypto, rsa
from bftkv_tpu_torch.graph import Graph
from bftkv_tpu_torch.quorum.wotqs import WotQS

__all__ = [
    "Identity",
    "new_identity",
    "cross_sign",
    "sign",
    "Universe",
    "build_universe",
    "make_node",
]


@dataclass
class Identity:
    """One principal: private key + its certificate.

    ``region`` is deployment-plane metadata (DESIGN.md §21): never
    serialized into the certificate wire format (the TOFU-pinned uid
    and BCR frames are untouched), persisted instead via the home
    directory's ``regions`` file and the process-global
    :mod:`bftkv_tpu_torch.regions` map."""

    name: str
    key: object  # rsa.PrivateKey | ecdsa.ECPrivateKey
    cert: certmod.Certificate
    region: str | None = None

    @property
    def id(self) -> int:
        return self.cert.id


def new_identity(
    name: str,
    address: str = "",
    uid: str = "",
    bits: int = 2048,
    alg: str = certmod.ALG_RSA,
    key=None,
) -> Identity:
    """``alg``: "rsa" (default) or "p256" — ECDSA P-256 identity keys
    (BASELINE config 4; reference parity: the PGP layer accepts any key
    algorithm, crypto_pgp.go:310-405).  ``key``: a pre-made private key
    of that algorithm (``None``: generate one of ``bits``)."""
    if alg == certmod.ALG_P256:
        from bftkv_tpu_torch.crypto import ecdsa as _ecdsa

        key = key if key is not None else _ecdsa.generate()
        cert = certmod.make_ec_certificate(
            key.public, name=name, address=address, uid=uid or name
        )
    else:
        key = key if key is not None else rsa.generate(bits)
        cert = certmod.Certificate(
            n=key.n, e=key.e, name=name, address=address, uid=uid or name
        )
    # Self-signature, as gpg does on generation.
    certmod.sign_certificate(cert, key)
    return Identity(name=name, key=key, cert=cert)


def cross_sign(members: list[Identity]) -> None:
    """Pairwise cross-sign: every member signs every other member's
    certificate — a trust clique (reference: scripts/clique.sh)."""
    for a in members:
        for b in members:
            if a is not b:
                certmod.sign_certificate(b.cert, a.key)


def sign(signer: Identity, signee: Identity) -> None:
    """Directed trust edge signer→signee (reference: scripts/sign.sh)."""
    certmod.sign_certificate(signee.cert, signer.key)


@dataclass
class Universe:
    servers: list[Identity]
    storage_nodes: list[Identity] = field(default_factory=list)
    users: list[Identity] = field(default_factory=list)
    # ids of the servers that counter-sign user certs (a07–a10 analog);
    # users trust the *other* servers.
    cert_signer_ids: set[int] = field(default_factory=set)
    # Operator extension (not in the reference topology): servers trust
    # the rw storage nodes in their own views, so a *daemon's own
    # client* has a non-empty READ quorum (the reference's canonical
    # setup.sh gives servers no path to rw, so its debug-API reads
    # cannot reach a read quorum either).
    server_trust_rw: bool = False
    # Keyspace sharding: ``servers`` grouped by quorum clique (one
    # group per shard; [servers] when unsharded).  Populated by
    # build_universe; consumers that predate sharding can ignore it.
    shards: list[list[Identity]] = field(default_factory=list)
    # Edge gateway identities (the reference's gateway/): user-shaped
    # principals (quorum-certified clients of every clique) that all
    # share ONE uid — TOFU matches issuer id OR uid
    # (server.go:329-337), so a variable written through gateway A can
    # be overwritten through gateway B: the stateless tier is
    # horizontally stackable without ownership pinning to one box.
    # Their certificates carry NO address on purpose: the quorum plane
    # is built from ADDRESSED vertices (wotqs ``W = U − {Ci} + R``,
    # clique discovery, shard complements), and an addressed gateway
    # cert would drag the front door into every principal's write
    # plane.  Dial addresses are deployment config: ``gateway_addrs``.
    gateways: list[Identity] = field(default_factory=list)
    gateway_addrs: dict[str, str] = field(default_factory=dict)
    # Region labels (``n_regions``): name → region AND address →
    # region for every labeled principal — the exact mapping
    # :func:`bftkv_tpu_torch.regions.install` takes.  Empty = single-region.
    regions: dict[str, str] = field(default_factory=dict)

    @property
    def all(self) -> list[Identity]:
        return self.servers + self.storage_nodes + self.users + self.gateways

    def certs(self) -> list[certmod.Certificate]:
        return [i.cert for i in self.all]

    def view_of(self, identity: Identity) -> list[certmod.Certificate]:
        """``identity``'s keyring view: private certificate copies with
        this principal's own trust edges added — and no one else's."""
        own = certmod.parse(certmod.serialize_many(self.certs()))
        by_id = {c.id: c for c in own}
        server_ids = {s.id for s in self.servers}
        rw_ids = {s.id for s in self.storage_nodes}
        if any(
            u.id == identity.id for u in self.users + self.gateways
        ):
            for c in own:
                if (
                    c.id in server_ids and c.id not in self.cert_signer_ids
                ) or c.id in rw_ids:
                    certmod.sign_certificate(c, identity.key)
        elif identity.id in rw_ids:
            for c in own:
                if c.id in server_ids:
                    certmod.sign_certificate(c, identity.key)
        # server_trust_rw edges are deliberately NOT certificate
        # signatures: see local_trust_of / Graph.add_local_edges — a
        # serialized a→rw edge would leak to every peer via join
        # responses and form bidirectional a↔rw cliques in their
        # graphs, silently breaking client quorums post-join.
        return list(by_id.values())

    def local_trust_of(self, identity: Identity) -> list[int]:
        """Ids this principal trusts via LOCAL-ONLY graph edges (the
        ``server_trust_rw`` operator extension): a daemon's own
        client-API reads need the rw nodes in its read quorum, but the
        edges must never serialize into certificates."""
        if self.server_trust_rw and any(
            s.id == identity.id for s in self.servers
        ):
            return [s.id for s in self.storage_nodes]
        return []


#: Shard-group name prefixes.  'r' and 'u' are skipped: "rXX" would
#: collide with the rw storage names and "uXX" with users (and the
#: cluster runner treats u* homes as clients).
_SHARD_PREFIXES = "abcdefghijklmnopqstvwxyz"


def build_universe(
    n_servers: int = 4,
    n_users: int = 1,
    n_rw: int = 0,
    *,
    scheme: str = "loop",
    base_port: int = 6001,
    rw_base_port: int = 6101,
    bits: int = 2048,
    unsigned_users: int = 0,
    server_trust_rw: bool = False,
    alg: str = certmod.ALG_RSA,
    n_shards: int = 1,
    n_gateways: int = 0,
    gw_base_port: int = 6201,
    n_regions: int = 0,
    keys=None,
) -> Universe:
    """The canonical test topology (reference: scripts/setup.sh:17-48).

    ``unsigned_users``: how many trailing users get *no* server
    counter-signatures — they carry no quorum certificate, the TOFU /
    registration test subject (reference: u04 / test1).

    ``alg``: identity-key algorithm for every principal — "rsa",
    "p256", or "mixed" (alternating, exercising algorithm agility in
    one cluster the way the reference's PGP layer would accept mixed
    keyrings).

    ``n_shards``: keyspace sharding — build ``n_shards`` disjoint
    server cliques of ``n_servers`` each (named a01.., b01.., c01..)
    and ``n_rw`` storage nodes *per shard*.  ``n_servers``/``n_rw``
    are PER-SHARD counts.  Users sign the non-counter-signing servers
    of every shard and are counter-signed by every shard's last f+1
    servers, so one client identity carries a valid quorum certificate
    at every clique.  ``n_shards=1`` is byte-compatible with the
    pre-sharding topology.

    ``n_regions``: region labels (DESIGN.md §21) — every plane's
    principals are assigned round-robin to ``r0..r{n_regions-1}``
    (clique member i → ``r{i % n_regions}``, same for storage, users
    and gateways), so each shard's seats spread across regions the way
    a geo-replicated deployment would place them.  Labels land on the
    identities (``Identity.region``) and in ``Universe.regions``
    (name → region and address → region), never in the certificate
    wire format.  0 = unlabeled (the loopback world).

    ``n_gateways``: edge gateway identities (gw01..) — user-shaped
    trust (quorum-certified, sign the servers in their own views) with
    one SHARED uid across all gateways (TOFU interchangeability) and
    deliberately NO certificate address: quorum planes are built from
    addressed vertices, so an addressed gateway cert would enter every
    principal's write plane (see Universe.gateways).  Dial addresses
    are deployment config, returned in ``gateway_addrs``.

    ``keys``: an iterable of pre-made private keys, taken in the order
    the principals are made (servers shard by shard, storage nodes,
    users, gateways), each matching its principal's ``alg``; ``None``
    generates every key.
    """
    key_iter = iter(keys) if keys is not None else None

    def next_key():
        return next(key_iter) if key_iter is not None else None

    if not 1 <= n_shards <= len(_SHARD_PREFIXES):
        raise ValueError(f"n_shards must be 1..{len(_SHARD_PREFIXES)}")

    def alg_for(i: int) -> str:
        if alg == "mixed":
            return certmod.ALG_P256 if i % 2 else certmod.ALG_RSA
        return alg

    def addr(name: str, port: int) -> str:
        if scheme == "loop":
            return f"loop://{name}"
        return f"http://127.0.0.1:{port}"

    shards: list[list[Identity]] = []
    for s in range(n_shards):
        prefix = _SHARD_PREFIXES[s]
        group = [
            new_identity(
                f"{prefix}{i + 1:02d}",
                address=addr(
                    f"{prefix}{i + 1:02d}",
                    base_port + s * n_servers + i,
                ),
                uid=f"{prefix}{i + 1:02d}@server",
                bits=bits,
                alg=alg_for(i),
                key=next_key(),
            )
            for i in range(n_servers)
        ]
        # Cross-sign within the shard only: the cliques must stay
        # disjoint or clique discovery merges them into one quorum.
        cross_sign(group)
        shards.append(group)
    servers = [s for group in shards for s in group]

    storage_nodes = [
        new_identity(
            f"rw{i + 1:02d}",
            address=addr(f"rw{i + 1:02d}", rw_base_port + i),
            uid=f"rw{i + 1:02d}@storage",
            bits=bits,
            alg=alg_for(i),
            key=next_key(),
        )
        for i in range(n_rw * n_shards)
    ]

    f = (n_servers - 1) // 3
    cert_signers = [
        s for group in shards for s in (group[-(f + 1) :] if group else [])
    ]

    users = []
    for i in range(n_users):
        name = f"u{i + 1:02d}"
        u = new_identity(
            name, uid=f"{name}@example.com", bits=bits, alg=alg_for(i),
            key=next_key(),
        )
        # The user's own trust edges are added per-view by
        # :meth:`Universe.view_of`, never onto the shared certs.
        if i < n_users - unsigned_users:
            for s in cert_signers:
                sign(s, u)  # quorum certificate on the user's cert
        users.append(u)

    gateways = []
    gateway_addrs: dict[str, str] = {}
    for i in range(n_gateways):
        name = f"gw{i + 1:02d}"
        g = new_identity(
            name,
            # NO cert address (see Universe.gateways); the dial address
            # is deployment config, returned beside the identity.
            # ONE uid for the whole tier: TOFU ownership of a variable
            # written through any gateway transfers to every other.
            uid="gateway@bftkv",
            bits=bits,
            alg=alg_for(i),
            key=next_key(),
        )
        gateway_addrs[name] = addr(name, gw_base_port + i)
        for s in cert_signers:
            sign(s, g)  # quorum certificate, like any signed user
        gateways.append(g)

    regions_map: dict[str, str] = {}
    if n_regions:
        if n_regions < 1:
            raise ValueError("n_regions must be >= 0")

        def label(i: int) -> str:
            return f"r{i % n_regions}"

        for group in shards:
            for i, ident in enumerate(group):
                ident.region = label(i)
        for plane in (storage_nodes, users, gateways):
            for i, ident in enumerate(plane):
                ident.region = label(i)
        for ident in servers + storage_nodes + users + gateways:
            if ident.region is None:
                continue
            regions_map[ident.name] = ident.region
            if ident.cert.address:
                regions_map[ident.cert.address] = ident.region
        for name, a in gateway_addrs.items():
            r = regions_map.get(name)
            if r:
                regions_map[a] = r

    return Universe(
        servers=servers,
        storage_nodes=storage_nodes,
        users=users,
        cert_signer_ids={s.id for s in cert_signers},
        server_trust_rw=server_trust_rw,
        shards=shards,
        gateways=gateways,
        gateway_addrs=gateway_addrs,
        regions=regions_map,
    )


def save_home(
    path: str,
    identity: Identity,
    view: list[certmod.Certificate],
    local_trust: list[int] | None = None,
    regions: dict[str, str] | None = None,
) -> None:
    """Persist one principal's home directory: ``pubring`` (its whole
    certificate view) + ``secring`` (its private key) — the layout the
    daemon/CLI load, replacing the reference's per-node GnuPG key dirs
    (reference: scripts/gen.sh, cmd/bftkv/main.go:69-72).

    ``local_trust``: ids for local-only graph edges (``localtrust``
    file, one hex id per line) — applied by :func:`load_home`, never
    serialized into certificates.

    ``regions``: the universe's region labels (``Universe.regions``)
    — a ``regions`` file of ``<name-or-address> <region>`` lines,
    merged into the process-global region map by :func:`load_home`
    (the localtrust pattern: deployment metadata beside the keyring,
    never inside the certificates)."""
    import os

    from bftkv_tpu_torch.crypto.keyring import Keyring

    os.makedirs(path, exist_ok=True)
    ring = Keyring()
    # The principal's own cert goes first: consumers take pubring[0]
    # as the owner's cert (reference: api.go:63-66 reads peer
    # pubrings and signs certs[0]).
    ordered = sorted(view, key=lambda c: c.id != identity.cert.id)
    ring.register(ordered, priv=identity.key)
    ring.save_pubring(os.path.join(path, "pubring"))
    ring.save_secring(os.path.join(path, "secring"))
    if local_trust:
        with open(os.path.join(path, "localtrust"), "w") as f:
            f.write("".join(f"{i:016x}\n" for i in local_trust))
    if regions:
        with open(os.path.join(path, "regions"), "w") as f:
            f.write(
                "".join(
                    f"{k} {r}\n" for k, r in sorted(regions.items())
                )
            )


def load_home(path: str, *, device=None):
    """Load a home directory saved by :func:`save_home`; returns the
    ``(graph, crypt, qs)`` triple with self = the cert matching the
    secring key (reference: cmd/bftkv/main.go:124-141).  ``device``
    places the collective signature's batched verify (``None``:
    ``cuda:0``; ``"cpu"``: the plain versions)."""
    import os

    from bftkv_tpu_torch.crypto import Crypto
    from bftkv_tpu_torch.crypto.keyring import Keyring
    from bftkv_tpu_torch.crypto.message import MessageSecurity
    from bftkv_tpu_torch.crypto.signature import CollectiveSignature, Signer

    ring = Keyring()
    view = ring.load_pubring(os.path.join(path, "pubring"))
    ring.load_secring(os.path.join(path, "secring"))
    self_cert = None
    key = None
    for c in view:
        try:
            key = ring.private_key(c.id)
            self_cert = c
            break
        except Exception:
            continue
    if self_cert is None or key is None:
        raise FileNotFoundError(f"no self key found under {path}")

    graph = Graph()
    graph.set_self_nodes([self_cert])
    graph.add_peers([c for c in view if c.id != self_cert.id])
    lt = os.path.join(path, "localtrust")
    if os.path.exists(lt):
        with open(lt) as f:
            ids = [int(line, 16) for line in f if line.strip()]
        graph.add_local_edges(self_cert.id, ids)
    rf = os.path.join(path, "regions")
    if os.path.exists(rf):
        from bftkv_tpu_torch import regions as _regions

        labels: dict[str, str] = {}
        with open(rf) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 2:
                    labels[parts[0]] = parts[1]
        if labels:
            _regions.regionmap.merge(labels)
    crypt = Crypto(
        keyring=ring,
        signer=Signer(key, self_cert),
        message=MessageSecurity(key, self_cert),
        collective=CollectiveSignature(device=device),
    )
    return graph, crypt, WotQS(graph)


def make_node(
    identity: Identity,
    view: list[certmod.Certificate],
    local_trust: list[int] | None = None,
    *,
    device=None,
):
    """Wire one node: trust graph with ``identity`` as self, every
    other principal in ``view`` as a peer, and a crypto bundle whose
    keyring holds the whole view (reference: cmd/bftkv/main.go:124-141
    builds the same triple from the pubring/secring files).

    ``view`` is typically :meth:`Universe.view_of`; pass pre-parsed
    private copies — nodes must not share mutable certificate state.
    ``local_trust`` (typically :meth:`Universe.local_trust_of`): ids
    for in-memory-only trust edges.  ``device`` places the collective
    signature's batched verify (``None``: ``cuda:0``; ``"cpu"``: the
    plain versions).
    """
    self_cert = next(c for c in view if c.id == identity.cert.id)

    graph = Graph()
    graph.set_self_nodes([self_cert])
    graph.add_peers([c for c in view if c.id != self_cert.id])
    if local_trust:
        graph.add_local_edges(self_cert.id, local_trust)

    crypt = new_crypto(identity.key, self_cert, device=device)
    crypt.keyring.register(view)

    qs = WotQS(graph)
    return graph, crypt, qs
