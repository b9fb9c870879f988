"""High-level client API — the external-program facade (counterpart of
``bftkv_tpu/api.py``).

Capability parity with the reference (api/api.go:32-239):
- :func:`open_client` — load the home keyrings, build
  graph/quorum/transport/client, join the network (api.go:32-54);
- :meth:`API.register` — decentralized enrollment: sign peer certs,
  authenticate, collect quorum signatures on our own certificate,
  merge and persist (api.go:74-147);
- password-protected :meth:`API.write`/:meth:`API.read` — wrap values
  with the TPA-derived symmetric key (api.go:149-185);
- :meth:`API.update_cert` — atomically rewrite the pubring
  (api.go:187-203);
- :meth:`API.distribute`/:meth:`API.sign` — threshold-CA passthroughs.
"""

from __future__ import annotations

import os

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch import topology
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import dataenc
from bftkv_tpu_torch.errors import ERR_AUTHENTICATION_FAILURE
from bftkv_tpu_torch.protocol.client import Client

__all__ = ["API", "open_client"]


class API:
    def __init__(self, path: str, client: Client, graph, crypt, qs, tr):
        self.path = path
        self.client = client
        self.graph = graph
        self.crypt = crypt
        self.qs = qs
        self.tr = tr

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        self.client.leaving()

    # -- enrollment (reference: api.go:58-147) ----------------------------

    def _sign_peers(self, cert_paths: list[str]) -> None:
        """Trust edges self→peer for each peer home dir
        (reference: api.go:58-72)."""
        for p in cert_paths:
            try:
                with open(os.path.join(p, "pubring"), "rb") as f:
                    peers = certmod.parse(f.read())
            except OSError:
                continue
            if not peers:
                continue
            peer = peers[0]
            certmod.sign_certificate(peer, self.crypt.signer.key)
            self.graph.add_nodes([peer])
            self.crypt.keyring.register([peer])

    def register(self, cert_paths: list[str], password: str) -> None:
        """Join the network and get our certificate counter-signed by a
        quorum (reference: api.go:74-147).

        Sharded namespaces: enrollment is scoped to the clique owning
        ``sha256(uid)`` — the TPA auth record for the uid lives only at
        its owner shard (every other shard's admission rejects it), so
        only that clique can verify the proof and counter-sign, and the
        resulting quorum certificate is valid for variables that clique
        owns.  Fleet-wide write access needs counter-signatures from
        every clique, which is an operator action (``genkeys`` signs
        generated users at every shard); per-shard runtime enrollment
        for one uid is an open item."""
        self._sign_peers(cert_paths)
        self.client.joining()  # construct the full graph
        self._sign_peers(cert_paths)  # re-sign: joining may overwrite

        variable = self.graph.uid.encode()
        proof, _key = self.client.authenticate(variable, password.encode())

        t = 1  # no longer temporary
        cert_blob = self.graph.serialize_self()
        tbs = pkt.serialize(variable, cert_blob, t, nfields=3)
        sig = self.crypt.signer.issue(tbs)
        req = pkt.serialize(variable, cert_blob, t, sig, proof)
        q = qm.choose_quorum_for(self.qs, variable, qm.AUTH | qm.PEER)
        signed: list[certmod.Certificate] = []
        succ: list = []

        def cb(res: tp.MulticastResponse) -> bool:
            if res.err is None and res.data:
                try:
                    certs = certmod.parse(res.data)
                except Exception:
                    return False
                signed.extend(certs)
                succ.append(res.peer)
            return False  # collect as many signatures as possible

        self.tr.multicast(tp.REGISTER, q.nodes(), req, cb)
        if not q.is_sufficient(succ):
            raise ERR_AUTHENTICATION_FAILURE

        # Fold every returned signature into our own certificate.
        self_cert = self.crypt.keyring.lookup(self.graph.id)
        for c in signed:
            if c.id == self_cert.id:
                self_cert.merge(c)
        self.graph.add_nodes([self_cert])
        # Gossip the updated certificate so servers can resolve our
        # quorum certificate on future writes (the reference defers
        # this to the next OpenClient's Joining, api_test.go:114-121),
        # and persist it so registration survives a restart.
        self.client.joining()
        self.update_cert()

    # -- data plane (reference: api.go:149-185) ---------------------------

    def write(self, variable: bytes, value: bytes, password: str = "") -> None:
        proof = None
        if password:
            proof, key = self.client.authenticate(variable, password.encode())
            value = dataenc.encrypt(value, key)
        self.client.write(variable, value, proof)

    def write_once(
        self, variable: bytes, value: bytes, password: str = ""
    ) -> None:
        """Immutable write (t = 2^64-1), with the same password
        protection as :meth:`write`."""
        proof = None
        if password:
            proof, key = self.client.authenticate(variable, password.encode())
            value = dataenc.encrypt(value, key)
        self.client.write_once(variable, value, proof)

    def write_many(
        self, items: list[tuple[bytes, bytes]]
    ) -> list[Exception | None]:
        """Batched write of distinct, password-free variables — one
        protocol round trip per phase for the whole batch
        (:meth:`bftkv_tpu_torch.protocol.client.Client.write_many`).
        Password-protected variables need per-variable TPA proofs; use
        :meth:`write` for those."""
        return self.client.write_many(items)

    def read_many(self, variables: list[bytes]) -> list:
        """Batched read of password-free variables; one entry per
        variable — value bytes, ``None``, or the per-item error."""
        return self.client.read_many(variables)

    def read(self, variable: bytes, password: str = "") -> bytes | None:
        proof = None
        key = None
        if password:
            proof, key = self.client.authenticate(variable, password.encode())
        value = self.client.read(variable, proof)
        if key is not None and value:
            value = dataenc.decrypt(value, key)
        return value

    # -- maintenance ------------------------------------------------------

    def update_cert(self) -> None:
        """Atomically rewrite the pubring with the current graph view
        (reference: api.go:187-203)."""
        path = os.path.join(self.path, "pubring")
        tmp = path + "~"
        with open(tmp, "wb") as f:
            f.write(self.graph.serialize_nodes())
        os.replace(tmp, path)

    # -- threshold CA (reference: api.go:225-233) -------------------------

    def distribute(self, caname: str, key) -> None:
        self.client.distribute(caname, key)

    def sign(self, caname: str, tbs: bytes, algo, hash_name: str) -> bytes:
        return self.client.dist_sign(caname, tbs, algo, hash_name)

    @property
    def uid(self) -> str:
        return self.graph.uid


def open_client(
    path: str, transport_factory=None, *, join: bool = True, device=None
) -> API:
    """Open a home directory and join the network
    (reference: api.go:32-54).  ``device`` places the client's crypto
    (``None``: ``cuda:0``, which raises without CUDA; ``"cpu"``: the
    plain versions)."""
    graph, crypt, qs = topology.load_home(path, device=device)
    if transport_factory is None:
        from bftkv_tpu_torch.transport.http import TrHTTP

        tr = TrHTTP(crypt)
    else:
        tr = transport_factory(crypt)
    client = Client(graph, qs, tr, crypt, device=device)
    if join:
        client.joining()
    return API(path, client, graph, crypt, qs, tr)
