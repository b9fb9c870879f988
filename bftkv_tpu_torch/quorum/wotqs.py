"""Web-of-Trust quorum system: quorums from trust-graph cliques (counterpart of ``bftkv_tpu/quorum/wotqs.py``).

Capability parity with the reference wotqs
(reference: quorum/wotqs/wotqs.go:32-206), semantics preserved exactly:

- trust distance by access type — CERT: 0, AUTH: 1, else 2
  (wotqs.go:117-127);
- each clique becomes a quorum-clique ``qc`` with the b-masking
  parameters f = (n-1)/3, min = 3f+1, threshold = 2f+1 (f+1 for
  READ/CERT), suff = f + (n-f)/2 + 1, suff zeroed when the seed's
  weight into the clique is too small (wotqs.go:36-70);
- READ adds the complement of the reachable set, WRITE adds the
  complement of all peers with f = 0 — "W = U − {Ci} + R"
  (wotqs.go:72-115);
- PEER excludes the self node (wotqs.go:38-47);
- the predicates intersect the candidate node set against every qc
  (wotqs.go:144-193).

Vectorized form: a quorum precomputes a boolean membership matrix
``(nqc, nuniverse)`` over a node-id index; the per-callback
``intersection`` loops (the O(|s1|·|s2|) hot path flagged in SURVEY.md
§2) become vectorized membership counts, and the same matrix feeds the
batched device tallies in ``bftkv_tpu_torch.ops.tally`` for bulk paths
(revoke-on-read over many reads at once).
"""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass, field

import numpy as np

from bftkv_tpu_torch import quorum as q
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.devtools.lockwatch import named_lock

#: Keyspace routing granularity: ``sha256(x)[0]`` — deliberately the
#: same bucketing as the anti-entropy digest tree
#: (``bftkv_tpu_torch.sync.digest.bucket_of``), so one digest bucket is owned
#: by exactly one shard and "sync only what your cliques own" is a
#: bucket-set intersection, not a per-variable walk.
ROUTE_BUCKETS = 256


def route_bucket(x: bytes) -> int:
    """The routing bucket of a variable name."""
    return hashlib.sha256(x).digest()[0]


class RouteTable:
    """One epoch of the versioned route table (DESIGN.md §15).

    Epoch 0 is implicit: the pure HRW table every view derives from the
    certificate-borne clique set (no RouteTable object exists).  An
    installed table (epoch ≥ 1) overrides bucket ownership — the
    topology autopilot's split / retire plans are exactly such tables.

    Shards are identified by **clique id** (the smallest member id of
    the clique), never by positional index: a table must keep meaning
    the same thing across graph generations, and after a retirement the
    dissolved clique's index disappears while its id never re-binds.
    ``table[b]`` / ``dual[b]`` index into ``cliques``.

    ``dual`` is the dual-epoch admission window: for a moving bucket it
    names the OLD owner clique, which may keep serving reads, accepting
    certifications of versions it already stored (echoes, back-fills,
    sync), and syncing — but never mints NEW versions (the new owner is
    the single write serializer, so invariant 5 survives the flip).
    ``retiring`` marks cliques being drained; a well-formed table routes
    no bucket to them.

    The table is signed (detached, over :meth:`payload`) by the issuing
    principal.  Routing is a LIVENESS surface, not a safety one — a
    forged table can misroute a client, whose writes then die in the
    honest owner's admission gate and reroute off the decline hint —
    but verification keeps a compromised distributor from silently
    degrading a fleet, so installs may demand it."""

    __slots__ = ("epoch", "cliques", "table", "dual", "retiring",
                 "issuer", "sig")

    def __init__(self, epoch, cliques, table, dual=None, retiring=(),
                 issuer=0, sig=b""):
        self.epoch = int(epoch)
        self.cliques = tuple(int(c) for c in cliques)
        self.table = tuple(int(i) for i in table)
        self.dual = {int(b): int(i) for b, i in (dual or {}).items()}
        self.retiring = frozenset(int(i) for i in retiring)
        self.issuer = int(issuer)
        self.sig = bytes(sig)
        if len(self.table) != ROUTE_BUCKETS:
            raise ValueError("route table must cover every bucket")
        if any(i >= len(self.cliques) for i in self.table):
            raise ValueError("route entry names an unknown clique")

    def payload(self) -> bytes:
        """Canonical signed bytes: everything but issuer/sig."""
        out = [b"rt1", struct.pack(">QH", self.epoch, len(self.cliques))]
        out += [struct.pack(">Q", c) for c in self.cliques]
        out.append(bytes(self.table))
        out.append(struct.pack(">H", len(self.dual)))
        for b in sorted(self.dual):
            out.append(struct.pack(">BB", b, self.dual[b]))
        out.append(struct.pack(">B", len(self.retiring)))
        out += [struct.pack(">B", i) for i in sorted(self.retiring)]
        return b"".join(out)

    def serialize(self) -> bytes:
        p = self.payload()
        return p + struct.pack(">QH", self.issuer, len(self.sig)) + self.sig

    @classmethod
    def parse(cls, data: bytes) -> "RouteTable":
        try:
            return cls._parse(data)
        except ValueError:
            raise
        except Exception as e:
            # Hostile-input contract: truncated / huge-count / garbage
            # bytes reject as ValueError, never as a struct/index
            # internals leak.
            raise ValueError(f"malformed route table: {e}") from None

    @classmethod
    def _parse(cls, data: bytes) -> "RouteTable":
        if data[:3] != b"rt1":
            raise ValueError("not a route table")
        off = 3
        epoch, nclique = struct.unpack_from(">QH", data, off)
        off += 10
        cliques = struct.unpack_from(">" + "Q" * nclique, data, off)
        off += 8 * nclique
        table = data[off:off + ROUTE_BUCKETS]
        off += ROUTE_BUCKETS
        (ndual,) = struct.unpack_from(">H", data, off)
        off += 2
        dual = {}
        for _ in range(ndual):
            b, i = struct.unpack_from(">BB", data, off)
            off += 2
            dual[b] = i
        (nret,) = struct.unpack_from(">B", data, off)
        off += 1
        retiring = struct.unpack_from(">" + "B" * nret, data, off)
        off += nret
        issuer, siglen = struct.unpack_from(">QH", data, off)
        off += 10
        sig = data[off:off + siglen]
        return cls(epoch, cliques, table, dual, retiring, issuer, sig)

    def sign(self, key, cert) -> "RouteTable":
        """Detached signature by ``cert``'s principal (RSA or P-256 —
        the same algorithms certificate edges use)."""
        from bftkv_tpu_torch.crypto import cert as certmod
        from bftkv_tpu_torch.crypto import ecdsa as _ecdsa
        from bftkv_tpu_torch.crypto import rsa as _rsa

        self.issuer = cert.id
        if certmod.is_ec(key):
            self.sig = _ecdsa.sign(self.payload(), key)
        else:
            self.sig = _rsa.sign(self.payload(), key)
        return self

    def verify(self, keyring) -> bool:
        """True iff the issuer is in ``keyring`` and the detached
        signature verifies over :meth:`payload`."""
        from bftkv_tpu_torch.crypto import cert as certmod

        signer = keyring.get(self.issuer)
        if signer is None or not self.sig:
            return False
        return certmod.verify_detached(self.payload(), self.sig, signer)


def _howmany(a: int, b: int) -> int:
    return (a + b - 1) // b


def bmasking_params(n: int) -> tuple[int, int, int, int]:
    """``(f, min, threshold, suff)`` for a clique of ``n`` nodes — the
    b-masking write-path form (wotqs.go:36-70).  THE single source of
    the formulas: ``_new_qc`` applies its access-type adjustments on
    top (READ/CERT commit at ``f + 1``; ``suff`` zeroes when the
    seed's trust weight into the clique is too small), and the fleet
    health plane (``seat_info``/``/info``) reports these raw values."""
    f = (n - 1) // 3
    return f, 3 * f + 1, 2 * f + 1, f + (n - f) // 2 + 1


@dataclass
class QC:
    """One quorum clique with its b-masking parameters (wotqs.go:16-22)."""

    nodes: list
    f: int = 0
    min: int = 0
    threshold: int = 0
    suff: int = 0


@dataclass
class WotQuorum:
    qcs: list[QC] = field(default_factory=list)

    def __post_init__(self):
        # id universe + per-qc membership rows for vectorized tallies
        ids: list[int] = []
        index: dict[int, int] = {}
        for qc in self.qcs:
            for n in qc.nodes:
                if n.id not in index:
                    index[n.id] = len(ids)
                    ids.append(n.id)
        self._index = index
        m = np.zeros((len(self.qcs), len(ids)), dtype=bool)
        for i, qc in enumerate(self.qcs):
            for n in qc.nodes:
                m[i, index[n.id]] = True
        self._membership = m
        self._f = np.array([qc.f for qc in self.qcs], dtype=np.int32)
        self._min = np.array([qc.min for qc in self.qcs], dtype=np.int32)
        self._threshold = np.array(
            [qc.threshold for qc in self.qcs], dtype=np.int32
        )
        self._suff = np.array([qc.suff for qc in self.qcs], dtype=np.int32)

    # -- vectorized intersection counts -----------------------------------
    def mask_of(self, nodes: list) -> np.ndarray:
        mask = np.zeros(len(self._index), dtype=bool)
        for n in nodes:
            i = self._index.get(n.id)
            if i is not None:
                mask[i] = True
        return mask

    def _counts(self, nodes: list) -> np.ndarray:
        if not self.qcs:
            return np.zeros(0, dtype=np.int64)
        return self._membership.astype(np.int32) @ self.mask_of(nodes).astype(
            np.int32
        )

    # -- Quorum interface (wotqs.go:132-193) ------------------------------
    def nodes(self) -> list:
        out = []
        for qc in self.qcs:
            for n in qc.nodes:
                if n.active and n.address != "":
                    out.append(n)
        return out

    def is_quorum(self, nodes: list) -> bool:
        if not self.qcs:
            return False
        c = self._counts(nodes)
        return bool(np.all((self._f <= 0) | (c >= self._min)))

    def is_threshold(self, nodes: list) -> bool:
        if not self.qcs:
            return False
        c = self._counts(nodes)
        return bool(np.all((self._threshold <= 0) | (c >= self._threshold)))

    def is_sufficient(self, nodes: list) -> bool:
        c = self._counts(nodes)
        return bool(np.any((self._suff > 0) & (c >= self._suff)))

    def reject(self, nodes: list) -> bool:
        # Vacuously true with no qcs (the reference's bare loop,
        # wotqs.go:178-185) — fail-safe in degenerate trust configs.
        c = self._counts(nodes)
        return bool(np.all((self._f > 0) & (c > self._f)))

    def get_threshold(self) -> int:
        return int(self._threshold.sum())

    # -- dense views for device tallies (bftkv_tpu_torch.ops.tally) -------------
    def membership_matrix(self) -> tuple[np.ndarray, dict[int, int]]:
        return self._membership, dict(self._index)

    def bounds(self) -> dict[str, np.ndarray]:
        return {
            "f": self._f,
            "min": self._min,
            "threshold": self._threshold,
            "suff": self._suff,
        }


class _ShardTopo:
    """One generation's shard view: the disjoint clique list, the
    256-bucket HRW route table, and the complement-node assignment.

    Everything here is a pure function of the addressed-node edge set,
    which is identical in every principal's graph view (certificates
    carry their own signature sets), so clients, clique replicas, and
    storage nodes all route a key to the same shard without any
    coordination."""

    __slots__ = ("shards", "table", "member", "assign")

    def __init__(self, graph):
        self.shards = graph.get_disjoint_cliques(min_size=4)
        # Deterministic shard order: by smallest member id.
        self.shards.sort(key=lambda c: min(n.id for n in c.nodes))
        #: node id -> shard index, clique members only.
        self.member: dict[int, int] = {
            n.id: i for i, c in enumerate(self.shards) for n in c.nodes
        }
        nsh = len(self.shards)
        if nsh <= 1:
            self.table = []
            self.assign = {}
            return
        # Rendezvous (HRW) hash: bucket b belongs to the clique with the
        # highest sha256(clique id | b); clique id = smallest member id.
        # Adding/removing one clique moves only that clique's buckets.
        cids = [
            min(n.id for n in c.nodes).to_bytes(8, "big")
            for c in self.shards
        ]
        self.table = [
            max(
                range(nsh),
                key=lambda i: hashlib.sha256(
                    cids[i] + bytes([b])
                ).digest(),
            )
            for b in range(ROUTE_BUCKETS)
        ]
        # Complement (storage-plane) nodes — addressed, in no clique —
        # are partitioned round-robin in ascending-id order so every
        # shard keeps a balanced READ/WRITE complement ("W = U - {Ci}
        # + R" per shard instead of one global W that would drag every
        # storage node into every shard's write fan-out).
        comp = sorted(
            vid
            for vid, v in graph.vertices.items()
            if v.instance is not None
            and getattr(v.instance, "address", "")
            and vid not in self.member
        )
        self.assign = {vid: i % nsh for i, vid in enumerate(comp)}

    def shard_index_of(self, node_id: int) -> int | None:
        i = self.member.get(node_id)
        if i is not None:
            return i
        return self.assign.get(node_id)

    def shard_of_bucket(self, b: int) -> int | None:
        if not self.table:
            return None
        return self.table[b]


class WotQS:
    """The quorum system over a trust graph (wotqs.go:32-34).

    Quorums are memoized per (access-type, graph generation): the
    reference rediscovers maximal cliques on every ``ChooseQuorum`` —
    O(V²) work called 3+ times per write — which dominates at 64–256
    replicas. Membership changes bump ``graph.generation`` and
    invalidate the cache; per-node ``active`` flips need no
    invalidation because ``WotQuorum.nodes()`` re-filters on each call.
    """

    def __init__(self, graph):
        self.g = graph
        self._cache: dict[int, WotQuorum] = {}
        self._cache_gen: int | None = None
        self._cache_lock = named_lock("quorum.cache")
        # Keyed-routing state, all memoized per graph generation under
        # the same guard discipline as ``_cache``:
        #   _topo       — shard cliques + bucket route table + complement
        #                 assignment (one _ShardTopo, O(V^2) to build);
        #   _kcache     — (rw, shard index) -> WotQuorum for shards this
        #                 node is NOT a member of (members delegate to
        #                 the classic path and its memo).
        self._topo: _ShardTopo | None = None
        self._topo_gen: int | None = None
        self._kcache: dict[tuple[int, int], WotQuorum] = {}
        self._kcache_gen: int | None = None
        # Epoched routing (DESIGN.md §15):
        #   _route       — installed RouteTable override (None = epoch 0,
        #                  pure HRW);
        #   _route_cache — (route, topo) -> resolved (owner[], dual{},
        #                  retiring set) in TOPO-index space;
        #   _hints       — client-side decline hints: bucket -> (epoch,
        #                  owner idx), applied to ROUTING only (never to
        #                  the admission gates — hints are liveness
        #                  hints, not authenticated state).
        self._route: RouteTable | None = None
        self._route_cache: tuple | None = None
        self._hints: dict[int, tuple[int, int]] = {}
        # Per-bucket route load (client-side write/read selection
        # counts) — the autopilot's hot-bucket signal.  Plain ints;
        # racy increments only lose stats, never correctness.
        self._bucket_load = [0] * ROUTE_BUCKETS

    def _new_qc(self, nodes: list, weight: int, rw: int) -> QC | None:
        if rw & q.PEER:
            self_id = self.g.get_self_id()
            nodes = [n for n in nodes if n.id != self_id]
        n = len(nodes)
        if n == 0:
            return None
        if rw == q.WRITE:
            return QC(nodes, 0, 0, 0, 0)
        f, min_, threshold, suff = bmasking_params(n)
        if f < 1:
            return None
        if rw & (q.CERT | q.READ):
            threshold = f + 1
        if weight <= n - suff:
            suff = 0
        return QC(nodes, f, min_, threshold, suff)

    def _complement(
        self, u: list, c: list[QC], e: list[QC], rw: int
    ) -> list[QC]:
        covered = {n.id for qc in c for n in qc.nodes}
        nodes = [n for n in u if n.id not in covered]
        qc = self._new_qc(nodes, 0, rw)
        if qc is not None:
            e = e + [qc]
        return e

    def _quorum_from(self, rw: int, sid: int, distance: int) -> WotQuorum:
        qcs: list[QC] = []
        for c in self.g.get_cliques(sid, distance):
            qc = self._new_qc(c.nodes, c.weight, rw | q.AUTH)
            if qc is not None:
                qcs.append(qc)
        if rw & (q.READ | q.WRITE):
            e = qcs if rw & q.AUTH else []
            e = self._complement(
                self.g.get_reachable_nodes(sid, distance), qcs, e, q.READ
            )  # R = {Vi} - {Ci}
            if rw & q.WRITE:
                e = self._complement(
                    self.g.get_peers(), qcs + e, e, q.WRITE
                )  # W = U - {Ci} + R
            qcs = e
        return WotQuorum(qcs)

    def choose_quorum(self, rw: int) -> WotQuorum:
        gen = getattr(self.g, "generation", None)
        with self._cache_lock:
            if gen is None or gen != self._cache_gen:
                self._cache.clear()
                self._cache_gen = gen
            else:
                quorum = self._cache.get(rw)
                if quorum is not None:
                    metrics.incr("quorum.cache.hits")
                    return quorum
        metrics.incr("quorum.cache.misses")
        if rw & q.CERT:
            distance = 0
        elif rw & q.AUTH:
            distance = 1
        else:
            distance = 2
        quorum = self._quorum_from(rw, self.g.get_self_id(), distance)
        if gen is not None:
            with self._cache_lock:
                # Store only if the graph did not mutate while we were
                # computing — a quorum built from the pre-mutation graph
                # must not be served under the post-mutation generation.
                if (
                    self._cache_gen == gen
                    and getattr(self.g, "generation", None) == gen
                ):
                    self._cache[rw] = quorum
        return quorum

    # -- keyed routing: one namespace, many quorums ----------------------

    def _topology(self) -> _ShardTopo:
        """The generation's shard topology, memoized with the same
        mutation guard as :meth:`choose_quorum` — a topology computed
        from the pre-mutation graph is never cached under the
        post-mutation generation."""
        gen = getattr(self.g, "generation", None)
        with self._cache_lock:
            if (
                gen is not None
                and gen == self._topo_gen
                and self._topo is not None
            ):
                return self._topo
        topo = _ShardTopo(self.g)
        if gen is not None:
            with self._cache_lock:
                if getattr(self.g, "generation", None) == gen:
                    self._topo = topo
                    self._topo_gen = gen
        return topo

    # -- epoched route table (DESIGN.md §15) -------------------------------

    def route_epoch(self) -> int:
        """The installed route-table epoch (0 = pure HRW routing)."""
        rt = self._route
        return rt.epoch if rt is not None else 0

    def route_table(self) -> RouteTable | None:
        return self._route

    def install_route_table(
        self, rt: RouteTable, keyring=None
    ) -> bool:
        """Adopt ``rt`` if it is NEWER than the installed epoch (and,
        when ``keyring`` is given, its signature verifies).  Returns
        True when ``rt`` is now (or already was) the active epoch —
        installs are idempotent, stale epochs are refused so a replayed
        old table can never roll routing back."""
        if keyring is not None and not rt.verify(keyring):
            metrics.incr("quorum.route.bad_sig")
            return False
        with self._cache_lock:
            cur = self._route
            if cur is not None and rt.epoch <= cur.epoch:
                if rt.epoch < cur.epoch:
                    metrics.incr("quorum.route.stale_install")
                return rt.epoch == cur.epoch
            self._route = rt
            self._route_cache = None
            # Decline hints at or below the new epoch are superseded.
            self._hints = {
                b: h for b, h in self._hints.items() if h[0] > rt.epoch
            }
        metrics.incr("quorum.route.installs")
        metrics.gauge("quorum.route.epoch", rt.epoch)
        return True

    def _routing(self, topo: _ShardTopo) -> tuple | None:
        """The installed table resolved into TOPO-index space:
        ``(owner[ROUTE_BUCKETS], dual {bucket: old idx}, retiring idx
        set)``, or None when no table is installed / unsharded.  A
        table entry naming a clique absent from the current topology
        (retired and removed) falls back to the HRW owner."""
        rt = self._route
        if rt is None or len(topo.shards) <= 1:
            return None
        cached = self._route_cache
        if (
            cached is not None
            and cached[0] is rt
            and cached[1] is topo
        ):
            return cached[2]
        cid_to_idx = {
            min(n.id for n in c.nodes): i
            for i, c in enumerate(topo.shards)
        }
        owner = list(topo.table)
        dual: dict[int, int] = {}
        retiring: set[int] = set()
        for b in range(ROUTE_BUCKETS):
            idx = cid_to_idx.get(rt.cliques[rt.table[b]])
            if idx is not None:
                owner[b] = idx
        for b, old in rt.dual.items():
            if old < len(rt.cliques) and 0 <= b < ROUTE_BUCKETS:
                idx = cid_to_idx.get(rt.cliques[old])
                if idx is not None and idx != owner[b]:
                    dual[b] = idx
        for i in rt.retiring:
            if i < len(rt.cliques):
                idx = cid_to_idx.get(rt.cliques[i])
                if idx is not None:
                    retiring.add(idx)
        resolved = (owner, dual, retiring)
        with self._cache_lock:
            self._route_cache = (rt, topo, resolved)
        return resolved

    def _owner_idx(
        self, b: int, topo: _ShardTopo, with_hints: bool = False
    ) -> int | None:
        """The shard index owning bucket ``b``: the installed table's
        word, else HRW.  ``with_hints`` additionally applies newer-epoch
        decline hints — ROUTING (client quorum selection) only; the
        admission gates never consult hints."""
        if not topo.table:
            return None
        r = self._routing(topo)
        owner = r[0][b] if r is not None else topo.table[b]
        if with_hints and self._hints:
            h = self._hints.get(b)
            if (
                h is not None
                and h[0] > self.route_epoch()
                and 0 <= h[1] < len(topo.shards)
            ):
                owner = h[1]
        return owner

    def effective_route(self) -> list[int]:
        """Owner shard index per bucket under the installed epoch (no
        hints) — the autopilot's plan input."""
        topo = self._topology()
        if not topo.table:
            return []
        return [self._owner_idx(b, topo) for b in range(ROUTE_BUCKETS)]

    def route_cliques(self) -> tuple[int, ...]:
        """Clique ids (smallest member id) in shard-index order."""
        topo = self._topology()
        return tuple(min(n.id for n in c.nodes) for c in topo.shards)

    def route_role(self, x: bytes) -> str:
        """This node's relation to ``x`` under the installed epoch:
        ``owner`` (full write admission), ``dual`` (old owner inside
        the dual-epoch window: serve + certify stored versions, never
        mint new ones), or ``foreign``.  Unsharded graphs and
        unassigned principals are always ``owner``."""
        topo = self._topology()
        if len(topo.shards) <= 1:
            return "owner"
        mine = topo.shard_index_of(self.g.get_self_id())
        if mine is None:
            return "owner"
        b = route_bucket(x)
        if self._owner_idx(b, topo) == mine:
            return "owner"
        r = self._routing(topo)
        if r is not None and r[1].get(b) == mine:
            return "dual"
        return "foreign"

    def route_hint(self, x: bytes) -> tuple[int, int | None]:
        """``(epoch, owner shard index)`` for a wrong-shard decline —
        what a stale-routed client needs to re-route in-round."""
        topo = self._topology()
        if not topo.table:
            return self.route_epoch(), None
        return self.route_epoch(), self._owner_idx(route_bucket(x), topo)

    def bucket_moved(self, x: bytes) -> bool:
        """Whether ``x``'s bucket is owned by a different shard than
        the pure-HRW (epoch-0) table would assign — i.e. some epoch
        moved it.  The chaos checker uses this to widen its invariant-3
        audit ONLY where migration can legitimately explain a foreign
        clique's signature."""
        topo = self._topology()
        if not topo.table:
            return False
        b = route_bucket(x)
        return self._owner_idx(b, topo) != topo.table[b]

    def stale_routed(self, x: bytes) -> bool:
        """Whether a misrouted request for ``x`` landing HERE looks
        stale-ROUTED rather than Byzantine: an epoch override moved the
        bucket away from this node's shard, which is exactly where an
        epoch-N client would still send it."""
        if self._route is None:
            return False
        topo = self._topology()
        if len(topo.shards) <= 1 or not topo.table:
            return False
        mine = topo.shard_index_of(self.g.get_self_id())
        if mine is None:
            return False
        b = route_bucket(x)
        return topo.table[b] == mine and self._owner_idx(b, topo) != mine

    def note_route_hint(self, x: bytes, epoch: int, owner: int) -> bool:
        """Record a decline hint (client side): bucket ``x`` is owned
        by shard ``owner`` as of ``epoch``.  Only hints NEWER than the
        installed epoch stick, so a Byzantine replica can at worst
        trigger one wasted re-route, never roll routing back — and an
        ABSURDLY far-future epoch is rejected outright, or one hostile
        decline could pin a bucket's hint above every honest epoch the
        fleet will ever reach (a per-bucket liveness DoS)."""
        if epoch <= self.route_epoch() or owner is None:
            return False
        if epoch > self.route_epoch() + 1_000_000:
            metrics.incr("quorum.route.hint_absurd")
            return False
        b = route_bucket(x)
        cur = self._hints.get(b)
        if cur is not None and cur[0] >= epoch:
            return False
        self._hints[b] = (epoch, int(owner))
        metrics.incr("quorum.route.hints")
        return True

    def dual_pull_shards(self) -> set[int]:
        """Shard indices this node must ALSO anti-entropy from: the old
        owners of buckets it newly owns (pre-copy / dual window), plus
        the new owners of buckets it is handing off (so the old owner
        converges in-flight tails before going inert)."""
        topo = self._topology()
        r = self._routing(topo)
        if r is None:
            return set()
        mine = topo.shard_index_of(self.g.get_self_id())
        if mine is None:
            return set()
        owner, dual, _ = r
        out: set[int] = set()
        for b, old in dual.items():
            if owner[b] == mine and old != mine:
                out.add(old)
            elif old == mine and owner[b] != mine:
                out.add(owner[b])
        return out

    def signs_for(self, x: bytes) -> bool:
        """Whether this node holds a sign seat for ``x``: a clique
        member of the owner shard — or of the dual old-owner shard
        inside the window (it must keep issuing shares for versions it
        already stored: certify-on-read, repair, in-flight tails)."""
        topo = self._topology()
        if len(topo.shards) <= 1:
            qa = self.choose_quorum(q.AUTH)
            myid = self.g.get_self_id()
            return any(n.id == myid for n in qa.nodes())
        myid = self.g.get_self_id()
        mine = topo.member.get(myid)
        if mine is None:
            return False  # storage plane never signs
        b = route_bucket(x)
        if self._owner_idx(b, topo) == mine:
            return True
        r = self._routing(topo)
        return r is not None and r[1].get(b) == mine

    def alt_quorums_for(self, x: bytes, rw: int) -> list[WotQuorum]:
        """Extra quorums a verifier may accept for ``x`` during the
        dual-epoch window: the old owner's, in VERIFY VIEW.  Empty
        outside a window — after the drain re-certifies migrated
        records, only the owner quorum vouches (DESIGN.md §15.3).

        Verify view matters: a clique server's trust weight into a
        FOREIGN clique is zero (cliques cross-sign internally only), so
        the reference's low-weight-viewer rule would zero ``suff`` and
        make the old clique's signatures unjudgeable exactly where
        migration admission needs to judge them."""
        topo = self._topology()
        r = self._routing(topo)
        if r is None:
            return []
        old = r[1].get(route_bucket(x))
        if old is None:
            return []
        return [self.quorum_for_shard(old, rw, verify_view=True)]

    def bucket_load(self) -> list[int]:
        """Per-bucket route-selection counts since the last reset."""
        return list(self._bucket_load)

    def reset_bucket_load(self) -> None:
        self._bucket_load = [0] * ROUTE_BUCKETS

    # -- shard introspection ----------------------------------------------

    def shard_count(self) -> int:
        return len(self._topology().shards)

    def shard_of(self, x: bytes) -> int | None:
        """The shard index owning variable ``x`` (None = unsharded),
        under the installed route epoch + any newer decline hints."""
        topo = self._topology()
        if not topo.table:
            return None
        return self._owner_idx(route_bucket(x), topo, with_hints=True)

    def shard_index_of(self, node_id: int) -> int | None:
        """Which shard a node serves: its clique's index, or — for a
        complement/storage node — its round-robin assignment.  None for
        unassigned principals (users) or unsharded graphs."""
        topo = self._topology()
        if len(topo.shards) <= 1:
            return None
        return topo.shard_index_of(node_id)

    def my_shard(self) -> int | None:
        return self.shard_index_of(self.g.get_self_id())

    def owns(self, x: bytes) -> bool:
        """Admission gate: does this node's shard own ``x``?  Always
        True on unsharded graphs and for unassigned principals; inside
        a dual-epoch window the OLD owner still counts (it serves,
        syncs, and certifies stored versions until the drain ends)."""
        return self.route_role(x) != "foreign"

    def shard_buckets(self) -> list[int]:
        """Route buckets assigned to each shard under the installed
        epoch (``[ROUTE_BUCKETS]`` when unsharded) — the balance series
        benches report."""
        topo = self._topology()
        if len(topo.shards) <= 1:
            return [ROUTE_BUCKETS]
        counts = [0] * len(topo.shards)
        for b in range(ROUTE_BUCKETS):
            counts[self._owner_idx(b, topo)] += 1
        return counts

    def owned_buckets(self) -> set[int] | None:
        """The route buckets this node's shard owns under the installed
        epoch — plus, inside a dual-epoch window, the moving buckets it
        is old owner of (it must keep converging them until the drain
        ends).  None when every bucket is local (unsharded graph /
        unassigned principal) — the anti-entropy plane's pull filter."""
        topo = self._topology()
        if len(topo.shards) <= 1:
            return None
        mine = topo.shard_index_of(self.g.get_self_id())
        if mine is None:
            return None
        r = self._routing(topo)
        out = set()
        for b in range(ROUTE_BUCKETS):
            owner = r[0][b] if r is not None else topo.table[b]
            if owner == mine or (r is not None and r[1].get(b) == mine):
                out.add(b)
        return out

    def seat_info(self, node_id: int | None = None) -> dict:
        """One node's shard seat + its clique's b-masking thresholds —
        the fleet health plane's ``/info`` payload, computed HERE (the
        only place that owns the quorum math) so HTTP-scraped daemons
        and in-process chaos fleets can never report different budgets
        for the same topology.

        ``shard`` is the seat index (0 on unsharded graphs for seated
        nodes, None for unassigned principals); ``role`` is ``clique``
        or ``storage``; ``clique`` carries the owner clique's
        ``n / f / threshold (2f+1) / suff`` and member names — the RAW
        :func:`bmasking_params` write-path values.  Per-access-type
        adjustments (READ commits at ``f+1``; ``suff`` zeroed for a
        low-weight viewer) are viewer/access dependent and belong to
        ``_new_qc``, not to a fleet-wide health document."""
        if node_id is None:
            node_id = self.g.get_self_id()
        topo = self._topology()
        nsh = len(topo.shards)
        mine = topo.shard_index_of(node_id)
        r = self._routing(topo)
        inst = getattr(self.g.vertices.get(node_id), "instance", None)
        from bftkv_tpu_torch import regions as _regions

        out: dict = {
            "shard": (
                mine if nsh > 1 else (0 if mine is not None else None)
            ),
            "shard_count": max(nsh, 1),
            "role": None,
            "clique": None,
            # Deployment-plane region label (DESIGN.md §21): resolved
            # from the process region map, never from the certificate.
            "region": _regions.region_of(getattr(inst, "name", None)),
            "owned_buckets": ROUTE_BUCKETS,
            # Epoched routing: the installed route-table epoch (0 =
            # pure HRW) and the dual-window width — the fleet plane's
            # epoch-skew signal rides on members disagreeing here.
            "epoch": self.route_epoch(),
            "dual_buckets": len(r[1]) if r is not None else 0,
        }
        if mine is None:
            return out
        out["role"] = (
            "clique" if topo.member.get(node_id) == mine else "storage"
        )
        if nsh > 1:
            out["owned_buckets"] = sum(
                1
                for b in range(ROUTE_BUCKETS)
                if self._owner_idx(b, topo) == mine
            )
        clique = topo.shards[mine]
        n = len(clique.nodes)
        f, _min, threshold, suff = bmasking_params(n)
        out["clique"] = {
            "n": n,
            "f": f,
            "threshold": threshold,
            "suff": suff,
            "members": sorted(nd.name for nd in clique.nodes),
        }
        return out

    def choose_quorum_for(self, x: bytes, rw: int) -> WotQuorum:
        """Keyed quorum selection: hash-route ``x`` to its owner clique.

        Single-clique graphs take the classic path unchanged (same
        memo, same objects).  A member of the owner clique also takes
        the classic path — its BFS view IS the owner shard, so the
        distance semantics (CERT: 0, AUTH: 1) stay intact.  Only a
        non-member (a client, or a storage node verifying a foreign
        shard's record) builds the owner-clique quorum explicitly,
        with READ/WRITE complements drawn from the shard's complement
        partition so no operation ever fans out beyond its shard."""
        topo = self._topology()
        if len(topo.shards) <= 1:
            return self.choose_quorum(rw)
        b = route_bucket(x)
        idx = self._owner_idx(b, topo, with_hints=True)
        self._bucket_load[b] += 1
        metrics.incr("quorum.route.shard", labels={"shard": idx})
        return self.quorum_for_shard(idx, rw)

    def quorum_for_shard(
        self, idx: int, rw: int, verify_view: bool = False
    ) -> WotQuorum:
        """The quorum of shard ``idx`` by INDEX — the keyed selection
        seam :meth:`choose_quorum_for` routes through, public so a
        decline-hinted client (and the migration executor) can address
        an owner clique directly.

        ``verify_view``: build the quorum for JUDGING collective
        signatures rather than collecting them — ``suff`` comes from
        the clique's own b-masking parameters regardless of this
        viewer's trust weight into the clique.  The low-weight veto
        protects a viewer collecting shares it cannot vouch for; a
        verifier only counts cryptographically checked signatures
        against the clique the shared certificate graph defines, which
        is what every clique member does natively.  Migration admission
        (sync pulls of the old owner's certified records, checker
        audits across an epoch change) runs in this view."""
        # Read the generation BEFORE fetching the topology: a mutation
        # landing between the two makes gen newer than the topo and the
        # store guard below rejects the result — reading gen after
        # would let a quorum built from a pre-mutation topology slip
        # into the cache under the post-mutation generation.
        gen = getattr(self.g, "generation", None)
        topo = self._topology()
        if len(topo.shards) <= 1:
            return self.choose_quorum(rw)
        if not 0 <= idx < len(topo.shards):
            # Cross-generation race: the index came from a topology
            # that no longer exists (a clique dissolved between route
            # resolution and this call).  The classic path is the safe
            # degradation — admission on the far side still gates.
            return self.choose_quorum(rw)
        if topo.member.get(self.g.get_self_id()) == idx:
            return self.choose_quorum(rw)
        key = (rw, idx, verify_view)
        with self._cache_lock:
            if gen is None or gen != self._kcache_gen:
                self._kcache.clear()
                self._kcache_gen = gen
            else:
                quorum = self._kcache.get(key)
                if quorum is not None:
                    metrics.incr("quorum.cache.hits")
                    return quorum
        metrics.incr("quorum.cache.misses")
        quorum = self._quorum_for_shard(
            rw, idx, topo, verify_view=verify_view
        )
        if gen is not None:
            with self._cache_lock:
                if (
                    self._kcache_gen == gen
                    and getattr(self.g, "generation", None) == gen
                ):
                    self._kcache[key] = quorum
        return quorum

    def _quorum_for_shard(
        self, rw: int, idx: int, topo: _ShardTopo,
        verify_view: bool = False,
    ) -> WotQuorum:
        """Build the owner clique's quorum from a non-member's seat —
        the same b-masking construction as :meth:`_quorum_from`, with
        two shard-local substitutions: the clique comes from the global
        enumeration (BFS cannot reach a foreign clique), and the
        READ/WRITE complements keep only nodes assigned to this shard's
        complement partition."""
        owner = topo.shards[idx]
        sid = self.g.get_self_id()
        nodes = list(owner.nodes)
        # Verify view: judge signatures against the clique's own
        # b-masking ``suff`` — the viewer-weight veto would zero it
        # for any server outside the clique (see quorum_for_shard).
        weight = (
            len(nodes) if verify_view
            else self.g.weight_from(sid, nodes)
        )
        qcs: list[QC] = []
        qc = self._new_qc(nodes, weight, rw | q.AUTH)
        if qc is not None:
            qcs.append(qc)
        if rw & (q.READ | q.WRITE):
            if rw & q.CERT:
                distance = 0
            elif rw & q.AUTH:
                distance = 1
            else:
                distance = 2

            def local(n) -> bool:
                return topo.assign.get(n.id) == idx

            e = qcs if rw & q.AUTH else []
            reach = [
                n
                for n in self.g.get_reachable_nodes(sid, distance)
                if local(n)
            ]
            e = self._complement(reach, qcs, e, q.READ)  # R = {Vi} - {Ci}
            if rw & q.WRITE:
                peers = [n for n in self.g.get_peers() if local(n)]
                e = self._complement(peers, qcs + e, e, q.WRITE)
            qcs = e
        return WotQuorum(qcs)
