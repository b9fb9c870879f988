"""Web-of-Trust graph: the membership/trust substrate (counterpart of ``bftkv_tpu/graph.py``).

Capability parity with the reference trust graph
(reference: node/graph/graph.go:20-438). Vertices are 64-bit node ids;
a directed edge signer → signee exists for every certificate signature.
Quorums are maximal cliques in this graph (reference: docs/design.md:61-69).

Semantics preserved exactly (SURVEY.md §7 hard part #5):

- ``add_nodes`` skips revoked ids, creates placeholder vertices (no
  instance) for unknown signers, and replaces the instance on re-add
  (graph.go:46-75);
- ``find_maximal_clique`` *assumes a unique maximal clique per seed*:
  it grows one clique greedily, then if any other vertex is mutually
  connected to the seed but outside the clique it logs and returns
  ``None`` (graph.go:332-362);
- clique weight = number of seed out-edges into the clique
  (graph.go:385-393);
- ``get_in_reachable`` excludes destinations themselves and short-
  circuits on the first destination match (graph.go:395-418);
- the graph itself implements the node interface by delegating to
  ``self_vertices[0]`` (graph.go:224-257).

The graph also exports a dense boolean adjacency view
(``adjacency``) so quorum tallies and clique checks can run as vmapped
boolean reductions on device (``bftkv_tpu_torch.ops.tally``) — the
"vote tallying" target of BASELINE.json.
"""

from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass, field

import numpy as np
from bftkv_tpu_torch.devtools.lockwatch import named_lock

log = logging.getLogger("bftkv_tpu_torch.graph")


@dataclass
class Vertex:
    instance: object | None = None
    # out-edges: signee id -> Vertex (this vertex signed those certs)
    edges: dict[int, "Vertex"] = field(default_factory=dict)


@dataclass
class Clique:
    nodes: list = field(default_factory=list)
    weight: int = 0


class Graph:
    def __init__(self):
        self.vertices: dict[int, Vertex] = {}
        self.revoked: dict[int, object | None] = {}
        self.self_vertices: list[Vertex] = []
        # Bumped on every structural mutation; quorum systems key their
        # clique/quorum caches on it so choose_quorum is O(1) between
        # membership changes (the reference rediscovers cliques on every
        # call — O(V²) per write phase, wotqs.go:117-127). Mutations can
        # come from concurrent server handler threads (join/revoke), so
        # the bump is locked — a lost increment would let a stale cached
        # quorum survive a membership change.
        self.generation = 0
        self._gen_lock = named_lock("graph.generation")
        # Operator-local trust edges (add_local_edges): present in
        # ``Vertex.edges`` for quorum traversal but excluded from shard
        # clique enumeration — they exist in THIS view only, and the
        # routing table must be a function of certificate-borne edges
        # every principal's view shares.
        self._local_edge_pairs: set[tuple[int, int]] = set()

    def _bump_generation(self) -> None:
        with self._gen_lock:
            self.generation += 1

    # -- construction (graph.go:46-146) -----------------------------------
    def add_nodes(self, nodes: list) -> list:
        self._bump_generation()
        res = []
        for n in nodes:
            skid = n.id
            if skid in self.revoked:
                continue
            self_v = self.vertices.get(skid)
            if self_v is None:
                self_v = Vertex(instance=n)
                self.vertices[skid] = self_v
            else:
                self_v.instance = n  # replace with the newly added one
            for signer in n.signers():
                if signer in self.revoked:
                    continue
                v = self.vertices.get(signer)
                if v is None:
                    v = Vertex(instance=None)  # placeholder
                    self.vertices[signer] = v
                v.edges[skid] = self_v
                # A certificate now backs this edge: it is no longer
                # local-only (shard enumeration may use it).
                self._local_edge_pairs.discard((signer, skid))
            res.append(n)
        return res

    def set_self_nodes(self, nodes: list) -> None:
        for n in nodes:
            v = self.vertices.get(n.id)
            if v is None or v.instance is None:
                self.add_nodes([n])
                v = self.vertices[n.id]
            self.self_vertices.append(v)

    def remove_nodes(self, nodes: list) -> None:
        self._bump_generation()
        for n in nodes:
            nid = n.id
            for v in self.vertices.values():
                v.edges.pop(nid, None)
            self.vertices.pop(nid, None)
            self._local_edge_pairs = {
                p for p in self._local_edge_pairs if nid not in p
            }
            for i, sv in enumerate(self.self_vertices):
                if sv.instance is not None and sv.instance.id == nid:
                    del self.self_vertices[i]
                    break

    def add_peers(self, peers: list) -> list:
        peers = self.add_nodes(peers)
        for n in peers:
            n.active = True
        return peers

    def add_local_edges(self, signer_id: int, signee_ids: list[int]) -> None:
        """Operator-configured trust edges that exist ONLY in this
        node's in-memory graph — never as certificate signatures, so
        join gossip cannot propagate them to peers.  (A serialized
        a→rw edge would combine with the rw→a edges rw nodes share in
        their views into bidirectional cliques in *other* nodes'
        graphs, silently reshaping their quorums — the
        ``server_trust_rw`` incident, round 4.)"""
        self._bump_generation()
        sv = self.vertices.get(signer_id)
        if sv is None:
            sv = self.vertices[signer_id] = Vertex(instance=None)
        for sid in signee_ids:
            if sid in self.revoked:
                continue
            v = self.vertices.get(sid)
            if v is None:
                v = self.vertices[sid] = Vertex(instance=None)
            if sid not in sv.edges:
                # Only a genuinely NEW edge is local-only; an existing
                # certificate-borne edge (every view has it) must keep
                # counting for shard enumeration.
                self._local_edge_pairs.add((signer_id, sid))
            sv.edges[sid] = v

    def get_peers(self) -> list:
        self_id = self.get_self_id()
        return [
            v.instance
            for v in self.vertices.values()
            if v.instance is not None and v.instance.id != self_id
        ]

    def remove_peers(self, peers: list) -> None:
        self.remove_nodes(peers)

    def revoke(self, n) -> None:
        self._bump_generation()
        v = self.vertices.get(n.id)
        instance = None
        if v is not None:
            instance = v.instance
            self.remove_nodes([instance] if instance is not None else [n])
        # Keep the best certificate we have: serialize_revoked() skips
        # entries without one, and a revocation loaded from a persisted
        # list (whose peer is absent from this graph) must round-trip
        # to the next persist. ``n`` may be a bare Ref — hasattr guards.
        if instance is None and hasattr(n, "serialize"):
            instance = n
        self.revoked[n.id] = instance if instance is not None else (
            self.revoked.get(n.id)
        )

    def revoke_nodes(self, nodes: list) -> None:
        self._bump_generation()
        for n in nodes:
            self.revoked[n.id] = n

    def in_graph(self, n) -> bool:
        return n.id in self.vertices

    # -- serialization (graph.go:148-213) ---------------------------------
    def serialize_self(self) -> bytes:
        return b"".join(
            v.instance.serialize()
            for v in self.self_vertices
            if v.instance is not None
        )

    def serialize_nodes(self) -> bytes:
        out = [self.serialize_self()]
        for v in self.vertices.values():
            if v.instance is None or v in self.self_vertices:
                continue
            out.append(v.instance.serialize())
        return b"".join(out)

    def serialize_revoked(self) -> bytes:
        return b"".join(
            n.serialize() for n in self.revoked.values() if n is not None
        )

    # -- node interface by delegation (graph.go:224-257) ------------------
    @property
    def id(self) -> int:
        return self.self_vertices[0].instance.id

    @property
    def name(self) -> str:
        return self.self_vertices[0].instance.name

    @property
    def address(self) -> str:
        return self.self_vertices[0].instance.address

    @property
    def uid(self) -> str:
        return self.self_vertices[0].instance.uid

    def signers(self) -> list[int]:
        return self.self_vertices[0].instance.signers()

    def serialize(self) -> bytes:
        return self.self_vertices[0].instance.serialize()

    def get_self_id(self) -> int:
        if not self.self_vertices or self.self_vertices[0].instance is None:
            return 0
        return self.self_vertices[0].instance.id

    def size(self) -> int:
        return len(self.vertices)

    # -- traversal (graph.go:279-438) -------------------------------------
    def _bfs(self, start: Vertex):
        """Yield (vertex, distance) in BFS order over out-edges."""
        seen = {start.instance.id}
        q = deque([(start, 0)])
        while q:
            v, d = q.popleft()
            yield v, d
            for vid, e in v.edges.items():
                if vid not in seen:
                    seen.add(vid)
                    q.append((e, d + 1))

    def get_reachable_nodes(self, sid: int, distance: int) -> list:
        v = self.vertices.get(sid)
        if v is None:
            return []
        nodes = []
        for vd, d in self._bfs(v):
            if distance >= 0 and d > distance:
                break
            if vd.instance is not None:
                nodes.append(vd.instance)
        return nodes

    def get_cliques(self, sid: int, distance: int) -> list[Clique]:
        start = self.vertices.get(sid)
        cliques: list[Clique] = []
        if start is None or start.instance is None:
            return cliques
        found_ids: set[int] = set()
        for vd, d in self._bfs(start):
            if distance >= 0 and d > distance:
                break
            if vd.instance is None or vd.instance.id in found_ids:
                continue
            clique = self._find_maximal_clique(vd)
            if clique is not None:
                clique.weight = sum(
                    1 for n in clique.nodes if n.id in start.edges
                )
                cliques.append(clique)
                found_ids.update(n.id for n in clique.nodes)
        return cliques

    def _bidirect(self, v: Vertex, clique: list[Vertex]) -> bool:
        vid = v.instance.id
        for c in clique:
            if vid not in c.edges or c.instance.id not in v.edges:
                return False
        return True

    def _find_maximal_clique(self, s: Vertex) -> Clique | None:
        """Grow one clique greedily; bail if it is not unique
        (graph.go:332-362)."""
        clique = [s]
        for v in self.vertices.values():
            if v.instance is None or v is s:
                continue
            if self._bidirect(v, clique):
                clique.append(v)
        members = set(id(c) for c in clique)
        for v in self.vertices.values():
            if (
                v.instance is not None
                and v is not s
                and id(v) not in members
                and self._bidirect(v, [s])
            ):
                log.info(
                    "graph: found more than one maximal clique for %s <-> %s",
                    s.instance.name,
                    v.instance.name,
                )
                return None
        return Clique(nodes=[c.instance for c in clique])

    def get_disjoint_cliques(self, min_size: int = 4) -> list[Clique]:
        """Disjoint-leaning maximal cliques over *addressed* vertices —
        the shard universe (hash-routed quorums).

        Unlike :meth:`get_cliques` this enumeration is global (not BFS
        from a seed): a replica's own out-edges never reach another
        shard's clique, yet its graph holds every certificate — and the
        cross-signatures ride inside the certificates — so the
        bidirectional edge set among addressed nodes is identical in
        every principal's view.  Determinism matters more than clique
        quality here (all views MUST route a key to the same clique):
        seeds and growth both iterate in ascending node-id order, each
        node joins at most one clique (``covered``), and unaddressed
        principals (users) are excluded entirely so a user's mutual
        edges with its certificate counter-signers cannot mint a bogus
        shard.  Cliques below ``min_size`` (f < 1: no b-masking
        parameters) are dropped — a single-clique graph therefore
        yields at most one shard and keyed routing degenerates.
        """
        ids = sorted(
            vid
            for vid, v in self.vertices.items()
            if v.instance is not None
            and getattr(v.instance, "address", "")
        )

        def cert_edge(a_vid: int, b_vid: int) -> bool:
            # Certificate-borne edge only: local-trust edges
            # (add_local_edges) exist in this view alone and must not
            # shape the shared routing table.
            return (
                b_vid in self.vertices[a_vid].edges
                and (a_vid, b_vid) not in self._local_edge_pairs
            )

        id_set = set(ids)
        covered: set[int] = set()
        out: list[Clique] = []
        for vid in ids:
            if vid in covered:
                continue
            # Grow only from the seed's MUTUAL cert-edge neighbors: any
            # joiner must share a bidirectional edge with the seed (a
            # clique member), so scanning the full addressed id list —
            # O(V) per seed, O(V²) total, the 10k-universe wall the §23
            # profiler measured — tests exactly the same candidates in
            # the same ascending order and yields identical cliques at
            # O(V + Σdeg·k).
            cands = sorted(
                wid
                for wid in self.vertices[vid].edges
                if wid in id_set
                and wid != vid
                and wid not in covered
                and cert_edge(vid, wid)
                and cert_edge(wid, vid)
            )
            clique = [vid]
            for wid in cands:
                if all(
                    cert_edge(wid, cid) and cert_edge(cid, wid)
                    for cid in clique
                ):
                    clique.append(wid)
            if len(clique) >= min_size:
                out.append(
                    Clique(
                        nodes=[self.vertices[c].instance for c in clique]
                    )
                )
                covered.update(clique)
        return out

    def weight_from(self, sid: int, nodes: list) -> int:
        """Seed weight into a node set: the number of ``sid``'s
        out-edges landing in ``nodes`` (the clique-weight rule of
        :meth:`get_cliques`, graph.go:385-393, for cliques found by
        global enumeration rather than BFS)."""
        v = self.vertices.get(sid)
        if v is None:
            return 0
        return sum(1 for n in nodes if n.id in v.edges)

    def get_in_reachable(self, destinations: list) -> list:
        res = []
        self_id = self.get_self_id()
        for v in self.vertices.values():
            if v.instance is None or v.instance.id == self_id:
                continue
            tid = v.instance.id
            found = False
            for d in destinations:
                if d.id == tid:  # exclude destinations themselves
                    found = False
                    break
                if d.id in v.edges:
                    found = True
            if found:
                res.append(v.instance)
        return res

    # -- dense views for device tallies -----------------------------------
    def adjacency(self) -> tuple[np.ndarray, list[int]]:
        """Boolean adjacency matrix over nodes with instances, plus the
        id order. ``adj[i, j]`` = node i signed node j's cert."""
        ids = [
            vid for vid, v in self.vertices.items() if v.instance is not None
        ]
        index = {vid: i for i, vid in enumerate(ids)}
        adj = np.zeros((len(ids), len(ids)), dtype=bool)
        for vid, v in self.vertices.items():
            i = index.get(vid)
            if i is None:
                continue
            for tid in v.edges:
                j = index.get(tid)
                if j is not None:
                    adj[i, j] = True
        return adj, ids
