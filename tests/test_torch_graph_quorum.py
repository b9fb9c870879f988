"""The port's trust graph and web-of-trust quorum system
(``bftkv_tpu_torch/graph.py``, ``quorum/``) against the reference's.

The first three parts rewrite the reference's graph-level cases
(``tests/test_graph_quorum.py``, ``test_shard_quorum.py``, and the CPU
cases of ``test_route_epoch.py``) against the port; the last part crosses
the packages on the same certificates: membership, bounds, predicate
answers, route tables and seat info equal, and a route table signed by
one package verifies in the other.  Exact everywhere (booleans, integers,
bytes).
"""

import threading
from dataclasses import dataclass, field

import numpy as np
import pytest

from bftkv_tpu_torch import quorum as q
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.errors import (
    ERR_WRONG_SHARD,
    parse_wrong_shard,
    wrong_shard_error,
)
from bftkv_tpu_torch.graph import Graph
from bftkv_tpu_torch.ops import tally
from bftkv_tpu_torch.quorum.wotqs import (
    ROUTE_BUCKETS,
    RouteTable,
    WotQS,
    route_bucket,
)


# == the trust graph and quorum predicates (test_graph_quorum.py) ==


@dataclass
class FakeNode:
    """Duck-typed node: the graph/quorum layers only need the
    certificate fields (reference: crypto/cert/cert.go:6-16)."""

    _id: int
    name: str
    address: str = ""
    uid: str = ""
    active: bool = True
    signer_ids: set = field(default_factory=set)

    @property
    def id(self):
        return self._id

    def signers(self):
        return list(self.signer_ids)

    def serialize(self):
        return self.name.encode()


def mkuniverse():
    nodes = {}
    nid = iter(range(1, 1000))

    def add(name, address="", uid=""):
        n = FakeNode(next(nid), name, address=address, uid=uid)
        nodes[name] = n
        return n

    for i in range(1, 11):
        add(f"a{i:02d}", address=f"http://a{i:02d}")
    for i in range(1, 11):
        add(f"b{i:02d}", address=f"http://b{i:02d}")
    for i in range(1, 7):
        add(f"rw{i:02d}", address=f"http://rw{i:02d}")
    for i in (1, 2, 3, 4):
        add(f"u{i:02d}", uid="foo@example.test")

    def sign(signer, signee):
        nodes[signee].signer_ids.add(nodes[signer].id)

    # two 10-cliques: pairwise cross-signed
    for grp in ("a", "b"):
        names = [f"{grp}{i:02d}" for i in range(1, 11)]
        for s1 in names:
            for s2 in names:
                if s1 != s2:
                    sign(s1, s2)
    # users sign the a-servers and rw nodes
    for u in ("u01", "u02", "u03", "u04"):
        for i in range(1, 11):
            sign(u, f"a{i:02d}")
        for i in range(1, 7):
            sign(u, f"rw{i:02d}")
    # a07-a10 sign the users' certs (u04 deliberately unsigned)
    for u in ("u01", "u02", "u03"):
        for i in (7, 8, 9, 10):
            sign(f"a{i:02d}", u)
    return nodes


@pytest.fixture()
def universe():
    return mkuniverse()


def build_graph(nodes, self_name):
    g = Graph()
    g.add_nodes(list(nodes.values()))
    g.set_self_nodes([nodes[self_name]])
    return g


def names_of(nodeset, nodes):
    byid = {n.id: name for name, n in nodes.items()}
    return sorted(byid[n.id] for n in nodeset)


def test_bfs_reachable(universe):
    g = build_graph(universe, "u01")
    # distance 0: just self
    r0 = g.get_reachable_nodes(universe["u01"].id, 0)
    assert names_of(r0, universe) == ["u01"]
    # distance 1: everything u01 signed
    r1 = g.get_reachable_nodes(universe["u01"].id, 1)
    expected = ["u01"] + [f"a{i:02d}" for i in range(1, 11)] + [
        f"rw{i:02d}" for i in range(1, 7)
    ]
    assert names_of(r1, universe) == sorted(expected)
    # distance 2: + users signed by a07-a10 (u02, u03), b-clique unreachable
    r2 = g.get_reachable_nodes(universe["u01"].id, 2)
    assert "u02" in names_of(r2, universe)
    assert "b01" not in names_of(r2, universe)
    # BFS visits each node once
    ids = [n.id for n in r2]
    assert len(ids) == len(set(ids))


def test_user_seed_clique(universe):
    g = build_graph(universe, "u01")
    cliques = g.get_cliques(universe["u01"].id, 0)
    assert len(cliques) == 1
    # u01 <-> a07..a10 are mutually signed: that's the seed clique
    assert names_of(cliques[0].nodes, universe) == [
        "a07",
        "a08",
        "a09",
        "a10",
        "u01",
    ]


def test_server_clique_and_weight(universe):
    g = build_graph(universe, "u01")
    cliques = g.get_cliques(universe["u01"].id, 2)
    byset = {tuple(names_of(c.nodes, universe)): c for c in cliques}
    a_clique = byset.get(tuple(f"a{i:02d}" for i in range(1, 11)))
    assert a_clique is not None
    # weight = #edges from the seed (u01) into the clique: u01 signed all 10
    assert a_clique.weight == 10


def test_nonunique_maximal_clique_bails(universe):
    # x is mutually signed with members of two disjoint cliques -> the
    # unique-maximal-clique assumption breaks and the seed yields nothing
    # (reference: graph.go:332-362)
    nodes = universe
    x = FakeNode(999, "x", address="http://x")
    nodes["x"] = x
    for peer in ("a01", "b01"):
        x.signer_ids.add(nodes[peer].id)
        nodes[peer].signer_ids.add(x.id)
    g = build_graph(nodes, "x")
    cliques = g.get_cliques(x.id, 0)
    assert cliques == []


def test_revoke_removes_and_blocks_readd(universe):
    g = build_graph(universe, "u01")
    a01 = universe["a01"]
    g.revoke(a01)
    assert not g.in_graph(a01)
    assert a01.id in g.revoked
    # re-adding is blocked
    g.add_nodes([a01])
    assert not g.in_graph(a01)
    # the a-clique shrinks to 9
    cliques = g.get_cliques(universe["u01"].id, 2)
    sizes = sorted(len(c.nodes) for c in cliques)
    assert 9 in sizes


def test_in_reachable(universe):
    g = build_graph(universe, "a01")
    # who signed u01 (besides destinations themselves)?
    res = g.get_in_reachable([universe["u01"]])
    got = names_of(res, universe)
    assert got == ["a07", "a08", "a09", "a10"]


def test_wotqs_cert_quorum_params(universe):
    g = build_graph(universe, "a01")
    qs = WotQS(g)
    qr = qs.choose_quorum(q.CERT | q.AUTH)
    # distance 0 from a01: the 10-clique; CERT -> threshold = f+1
    assert len(qr.qcs) == 1
    qc = qr.qcs[0]
    assert (qc.f, qc.min, qc.threshold, qc.suff) == (3, 10, 4, 7)
    a_nodes = [universe[f"a{i:02d}"] for i in range(1, 11)]
    assert qr.is_quorum(a_nodes)
    assert qr.is_threshold(a_nodes[:4])
    assert not qr.is_threshold(a_nodes[:3])
    assert qr.is_sufficient(a_nodes[:7])
    assert not qr.is_sufficient(a_nodes[:6])
    assert not qr.reject(a_nodes[:3])
    assert qr.reject(a_nodes[:4])


def test_wotqs_auth_quorum_threshold(universe):
    g = build_graph(universe, "a01")
    qs = WotQS(g)
    qa = qs.choose_quorum(q.AUTH)
    qc = qa.qcs[0]
    assert qc.threshold == 7  # 2f+1 for AUTH
    assert qa.get_threshold() == sum(c.threshold for c in qa.qcs)


def test_wotqs_peer_excludes_self(universe):
    g = build_graph(universe, "a01")
    qs = WotQS(g)
    qp = qs.choose_quorum(q.AUTH | q.PEER)
    all_nodes = {n.id for qc in qp.qcs for n in qc.nodes}
    assert universe["a01"].id not in all_nodes
    # 9-node clique: f = 2
    assert qp.qcs[0].f == 2


def test_wotqs_write_quorum_covers_peers(universe):
    g = build_graph(universe, "a01")
    qs = WotQS(g)
    qw = qs.choose_quorum(q.WRITE)
    # Pure WRITE drops the clique qcs and keeps only the complements:
    # "W = U - {Ci} + R" (wotqs.go:103-113). From a01 that is every peer
    # outside the a-clique, with f == 0 (any node may store).
    covered = {n.id for qc in qw.qcs for n in qc.nodes}
    for name, n in universe.items():
        if name.startswith(("b", "rw")):
            assert n.id in covered, name
        if name.startswith("a"):
            assert n.id not in covered, name
    assert all(qc.f == 0 for qc in qw.qcs)
    # time phase uses READ|AUTH which *keeps* the cliques (client.go:64)
    qt = qs.choose_quorum(q.READ | q.AUTH)
    t_covered = {n.id for qc in qt.qcs for n in qc.nodes}
    assert universe["a02"].id in t_covered


def test_wotqs_inactive_nodes_filtered(universe):
    g = build_graph(universe, "a01")
    qs = WotQS(g)
    universe["a02"].active = False
    qr = qs.choose_quorum(q.CERT | q.AUTH)
    assert universe["a02"].id not in {n.id for n in qr.nodes()}
    universe["a02"].active = True


def test_tally_matches_host_predicates(universe):
    g = build_graph(universe, "a01")
    qs = WotQS(g)
    qr = qs.choose_quorum(q.AUTH)
    membership, index = qr.membership_matrix()
    bounds = qr.bounds()
    rng = np.random.default_rng(0)
    universe_nodes = {n.id: n for n in universe.values()}
    ids = list(index.keys())
    batch = []
    masks = []
    for _ in range(64):
        k = rng.integers(0, len(ids) + 1)
        chosen = rng.choice(ids, size=k, replace=False) if k else []
        nodes = [universe_nodes[i] for i in chosen]
        batch.append(nodes)
        masks.append(qr.mask_of(nodes))
    cand = np.stack(masks) if masks else np.zeros((0, len(ids)), bool)
    th = np.asarray(
        tally.is_threshold_batch(membership, cand, bounds["threshold"], device="cpu")
    )
    su = np.asarray(tally.is_sufficient_batch(membership, cand, bounds["suff"], device="cpu"))
    rj = np.asarray(tally.reject_batch(membership, cand, bounds["f"], device="cpu"))
    iq = np.asarray(
        tally.is_quorum_batch(membership, cand, bounds["f"], bounds["min"], device="cpu")
    )
    for i, nodes in enumerate(batch):
        assert th[i] == qr.is_threshold(nodes)
        assert su[i] == qr.is_sufficient(nodes)
        assert rj[i] == qr.reject(nodes)
        assert iq[i] == qr.is_quorum(nodes)


def test_equivocation_pairs():
    # 3 values at one timestamp; node 2 signed two of them
    sets = np.zeros((3, 5), dtype=bool)
    sets[0, [0, 2]] = True
    sets[1, [1, 2]] = True
    sets[2, [3]] = True
    eq = np.asarray(tally.equivocation_pairs(sets, device="cpu"))
    assert list(np.nonzero(eq)[0]) == [2]


# == keyed routing over shards (test_shard_quorum.py) ==


def mk_shard_universe(n_per_clique=4, n_rw=8, cliques=("a", "b")):
    nodes = {}
    nid = iter(range(1, 1000))

    def add(name, address="", uid=""):
        n = FakeNode(next(nid), name, address=address, uid=uid)
        nodes[name] = n
        return n

    for grp in cliques:
        for i in range(1, n_per_clique + 1):
            add(f"{grp}{i:02d}", address=f"http://{grp}{i:02d}")
    for i in range(1, n_rw + 1):
        add(f"rw{i:02d}", address=f"http://rw{i:02d}")
    add("u01", uid="u01@example.test")

    def sign(signer, signee):
        nodes[signee].signer_ids.add(nodes[signer].id)

    for grp in cliques:
        names = [f"{grp}{i:02d}" for i in range(1, n_per_clique + 1)]
        for s1 in names:
            for s2 in names:
                if s1 != s2:
                    sign(s1, s2)
    for grp in cliques:
        for i in range(1, n_per_clique + 1):
            sign("u01", f"{grp}{i:02d}")
    for i in range(1, n_rw + 1):
        sign("u01", f"rw{i:02d}")
        for grp in cliques:
            for j in range(1, n_per_clique + 1):
                sign(f"rw{i:02d}", f"{grp}{j:02d}")
    return nodes


def build(nodes, self_name, order=None):
    g = Graph()
    ordered = (
        [nodes[n] for n in order] if order else list(nodes.values())
    )
    g.add_nodes(ordered)
    g.set_self_nodes([nodes[self_name]])
    return g


@pytest.fixture()
def suniverse():
    return mk_shard_universe()


def shard_names(qs, suniverse):
    byid = {n.id: name for name, n in suniverse.items()}
    topo = qs._topology()
    return [sorted(byid[n.id] for n in c.nodes) for c in topo.shards]


# -- enumeration ----------------------------------------------------------


def test_two_cliques_enumerated(suniverse):
    qs = WotQS(build(suniverse, "u01"))
    groups = shard_names(qs, suniverse)
    assert sorted(map(tuple, groups)) == [
        tuple(f"a{i:02d}" for i in range(1, 5)),
        tuple(f"b{i:02d}" for i in range(1, 5)),
    ]
    assert qs.shard_count() == 2


def test_users_never_form_shards(suniverse):
    # u01 <-> nothing bidirectionally except... give u01 mutual edges
    # with a whole clique: still no shard membership (no address).
    for i in range(1, 5):
        suniverse["u01"].signer_ids.add(suniverse[f"a{i:02d}"].id)
    qs = WotQS(build(suniverse, "u01"))
    for grp in shard_names(qs, suniverse):
        assert "u01" not in grp


def test_single_clique_degenerates(suniverse):
    solo = {
        name: n
        for name, n in suniverse.items()
        if not name.startswith("b")
    }
    qs = WotQS(build(solo, "u01"))
    assert qs.shard_count() == 1
    assert qs.shard_of(b"x") is None
    assert qs.owns(b"anything")
    assert qs.owned_buckets() is None
    assert qs.shard_buckets() == [ROUTE_BUCKETS]
    # Bit-for-bit: the keyed API returns the SAME memoized object the
    # unkeyed call returns.
    qa = qs.choose_quorum(q.AUTH)
    assert qs.choose_quorum_for(b"x", q.AUTH) is qa


def test_local_trust_edges_do_not_shape_shards(suniverse):
    """server_trust_rw-style local edges exist in ONE view only; letting
    them into clique enumeration would give that view a different route
    table than the rest of the fleet.  a01's local a01->rw edges +
    rw->a01 certificate edges look bidirectional in a01's graph — the
    enumeration must still produce the pure server cliques."""
    g = build(suniverse, "a01")
    baseline = [sorted(n.id for n in c.nodes)
                for c in g.get_disjoint_cliques()]
    g.add_local_edges(
        suniverse["a01"].id,
        [suniverse[f"rw{i:02d}"].id for i in range(1, 9)],
    )
    got = [sorted(n.id for n in c.nodes) for c in g.get_disjoint_cliques()]
    assert got == baseline
    # An operator redundantly listing a CLIQUE-MATE in localtrust must
    # not demote the certificate-borne edge either: the clique survives.
    g.add_local_edges(suniverse["a01"].id, [suniverse["a02"].id])
    got = [sorted(n.id for n in c.nodes) for c in g.get_disjoint_cliques()]
    assert got == baseline


# -- routing --------------------------------------------------------------


def test_route_table_covers_every_bucket(suniverse):
    qs = WotQS(build(suniverse, "u01"))
    counts = qs.shard_buckets()
    assert sum(counts) == ROUTE_BUCKETS
    assert len(counts) == 2
    assert all(c > 0 for c in counts)
    # HRW over 256 buckets / 2 cliques: grossly unbalanced would mean a
    # broken hash, not bad luck.
    assert max(counts) / min(counts) < 2.0


def test_routing_agrees_across_views_and_orders(suniverse):
    names = list(suniverse)
    qs1 = WotQS(build(suniverse, "u01", order=names))
    qs2 = WotQS(build(suniverse, "a01", order=list(reversed(names))))
    qs3 = WotQS(build(suniverse, "rw01", order=sorted(names)))
    for i in range(64):
        x = b"var/%d" % i
        assert qs1.shard_of(x) == qs2.shard_of(x) == qs3.shard_of(x)


def test_ownership_matches_route(suniverse):
    qs_a = WotQS(build(suniverse, "a01"))
    qs_b = WotQS(build(suniverse, "b01"))
    a_idx = qs_a.my_shard()
    b_idx = qs_b.my_shard()
    assert a_idx is not None and b_idx is not None and a_idx != b_idx
    hits = {True: 0, False: 0}
    for i in range(64):
        x = b"own/%d" % i
        owner = qs_a.shard_of(x)
        assert qs_a.owns(x) == (owner == a_idx)
        assert qs_b.owns(x) == (owner == b_idx)
        hits[qs_a.owns(x)] += 1
    assert hits[True] and hits[False]  # both outcomes actually exercised


def test_complement_partition_balanced(suniverse):
    qs = WotQS(build(suniverse, "rw01"))
    topo = qs._topology()
    per_shard = [0, 0]
    for nid, idx in topo.assign.items():
        per_shard[idx] += 1
    assert per_shard == [4, 4]
    # every rw node got an assignment, no clique member did
    assert set(topo.assign) & set(topo.member) == set()
    mine = qs.my_shard()
    owned = qs.owned_buckets()
    assert owned is not None
    assert owned == {
        b for b in range(ROUTE_BUCKETS) if topo.table[b] == mine
    }


def test_keyed_quorum_stays_inside_shard(suniverse):
    qs = WotQS(build(suniverse, "u01"))
    topo = qs._topology()
    for i in range(16):
        x = b"q/%d" % i
        idx = qs.shard_of(x)
        allowed = {n.id for n in topo.shards[idx].nodes} | {
            nid for nid, a in topo.assign.items() if a == idx
        }
        for rw in (q.READ | q.AUTH, q.AUTH | q.PEER, q.WRITE, q.READ):
            quorum = qs.choose_quorum_for(x, rw)
            got = {n.id for qc in quorum.qcs for n in qc.nodes}
            assert got, (i, rw)
            assert got <= allowed, (i, rw, got - allowed)


def test_keyed_cache_and_generation(suniverse):
    g = build(suniverse, "u01")
    qs = WotQS(g)
    x = b"cache/1"
    q1 = qs.choose_quorum_for(x, q.WRITE)
    assert qs.choose_quorum_for(x, q.WRITE) is q1  # memoized
    g.remove_nodes([suniverse["rw08"]])  # bumps generation
    q2 = qs.choose_quorum_for(x, q.WRITE)
    assert q2 is not q1
    assert suniverse["rw08"].id not in {
        n.id for qc in q2.qcs for n in qc.nodes
    }


def test_route_metric_closed_enum(suniverse):
    """The ``quorum.route.shard`` labels this ``WotQS`` adds are shard
    indices only.  The registry is global to the process, so the check is
    a delta: the labels and counts this test's 32 selections add, not
    whatever other tests left there."""
    from bftkv_tpu_torch.metrics import registry as metrics

    def route_counts():
        return {k: v for k, v in metrics.snapshot().items()
                if k.startswith("quorum.route.shard{")}

    qs = WotQS(build(suniverse, "u01"))
    before = route_counts()
    for i in range(32):
        qs.choose_quorum_for(b"m/%d" % i, q.READ)
    after = route_counts()
    added = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    assert added and len(added) <= qs.shard_count()
    assert sum(added.values()) == 32
    assert set(added) <= {"quorum.route.shard{shard=%d}" % i for i in range(qs.shard_count())}


# -- the choose_quorum generation-guard race (wotqs.py:207-235) -----------


def test_choose_quorum_generation_race():
    """A quorum built from the pre-mutation graph must never be served
    under the post-mutation generation: the clique walk completes on
    the old graph, membership mutates before the builder can memoize,
    and the guarded store has to DROP the stale result (wotqs.py's
    choose_quorum store guard — implemented but previously untested)."""
    # 6-node clique: still a valid quorum (f=1) after one node leaves,
    # so the post-mutation rebuild is a real quorum, not a degenerate
    # empty one.
    nodes = mk_shard_universe(n_per_clique=6, n_rw=8, cliques=("a",))
    g = build(nodes, "a01")
    qs = WotQS(g)
    started = threading.Event()
    proceed = threading.Event()
    real = g.get_cliques

    def stale_get_cliques(sid, distance):
        # Snapshot the PRE-mutation cliques, then let the mutation land
        # before returning — the builder finishes its construction from
        # a world that no longer exists.
        res = real(sid, distance)
        started.set()
        assert proceed.wait(5), "mutator never released the builder"
        return res

    g.get_cliques = stale_get_cliques
    box = {}

    def build_quorum():
        box["q"] = qs.choose_quorum(q.AUTH)

    t = threading.Thread(target=build_quorum)
    t.start()
    assert started.wait(5)
    # Membership mutation lands while the builder holds the old clique
    # list: a02 leaves, generation bumps.
    g.remove_nodes([nodes["a02"]])
    proceed.set()
    t.join(5)
    g.get_cliques = real
    stale = box["q"]
    assert nodes["a02"].id in {
        n.id for qc in stale.qcs for n in qc.nodes
    }, "builder should have constructed from the pre-mutation graph"
    # The next call must rebuild from the mutated graph — serving the
    # stale quorum out of the memo would resurrect a02 post-removal.
    fresh = qs.choose_quorum(q.AUTH)
    assert fresh is not stale
    assert fresh.qcs, "5-node clique must still form a quorum"
    assert nodes["a02"].id not in {
        n.id for qc in fresh.qcs for n in qc.nodes
    }


def test_live_generation_churn_under_writers(suniverse):
    """The autopilot's steady state: graph generations keep bumping
    (spare admission, revocations) WHILE writer threads select keyed
    quorums.  No quorum may ever be served under the wrong generation:
    whenever a writer observes a quiescent generation around its call
    (same before and after), the returned quorum must reflect exactly
    that generation's membership — here, whether rw08 exists."""
    g = build(suniverse, "u01")
    qs = WotQS(g)
    rw08 = suniverse["rw08"]
    # The route table derives from the CLIQUES alone, so it is stable
    # under rw (complement) churn; rw08's seat is its round-robin slot,
    # also stable whenever it is present.  Keys routed to that shard
    # must include rw08 in their WRITE complement exactly when the
    # generation they were served under had rw08 in the graph.
    rw_idx = qs.shard_index_of(rw08.id)
    assert rw_idx is not None
    keys = []
    i = 0
    while len(keys) < 8:
        x = b"churn/%d" % i
        i += 1
        if qs.shard_of(x) == rw_idx:
            keys.append(x)
    stop = threading.Event()
    present = {}  # generation -> rw08 in the graph at that generation
    lock = threading.Lock()
    violations: list = []

    def record(gen: int, has: bool) -> None:
        with lock:
            present[gen] = has

    record(g.generation, True)

    def churn():
        for _ in range(60):
            g.remove_nodes([rw08])
            record(g.generation, False)
            g.add_peers([rw08])
            record(g.generation, True)
        stop.set()

    def writer(wi: int):
        i = 0
        while not stop.is_set():
            i += 1
            x = keys[(wi + i) % len(keys)]
            gen_before = g.generation
            quorum = qs.choose_quorum_for(x, q.WRITE)
            topo_n = qs.shard_count()
            gen_after = g.generation
            if gen_before != gen_after:
                continue  # mutation mid-call: nothing to assert
            with lock:
                expect = present.get(gen_before)
            if expect is None:
                continue
            got = any(
                n.id == rw08.id
                for qc in quorum.qcs
                for n in qc.nodes
            )
            if got != expect:
                violations.append(
                    (wi, gen_before, expect, got)
                )
            if topo_n != 2:
                violations.append((wi, gen_before, "shards", topo_n))

    threads = [
        threading.Thread(target=writer, args=(wi,), daemon=True)
        for wi in range(4)
    ]
    churner = threading.Thread(target=churn, daemon=True)
    for t in threads:
        t.start()
    churner.start()
    churner.join(30)
    stop.set()
    for t in threads:
        t.join(10)
    assert not violations, violations[:5]
    # and the memos settled on the FINAL generation's world
    final = qs.choose_quorum_for(keys[0], q.WRITE)
    assert any(
        n.id == rw08.id for qc in final.qcs for n in qc.nodes
    )


def test_keyed_topology_generation_race(suniverse):
    """Same guard discipline for the shard topology memo: a routing
    table computed from the pre-mutation graph must not survive the
    mutation, or keys would keep routing to a dissolved clique."""
    g = build(suniverse, "u01")
    qs = WotQS(g)
    started = threading.Event()
    proceed = threading.Event()
    real = g.get_disjoint_cliques

    def stale_disjoint(min_size=4):
        res = real(min_size)
        started.set()
        assert proceed.wait(5)
        return res

    g.get_disjoint_cliques = stale_disjoint
    box = {}
    t = threading.Thread(
        target=lambda: box.setdefault("n", qs.shard_count())
    )
    t.start()
    assert started.wait(5)
    for name in ("b01", "b02", "b03", "b04"):
        g.remove_nodes([suniverse[name]])  # the b-clique dissolves
    proceed.set()
    t.join(5)
    g.get_disjoint_cliques = real
    assert box["n"] == 2  # the racer built from the old world...
    assert qs.shard_count() == 1  # ...but the memo did not keep it


# == epoched route tables (test_route_epoch.py, CPU cases) ==


def mk_qs(suniverse, who="u01"):
    return WotQS(build(suniverse, who))


def flip_table(qs, moves: dict, *, dual=True, epoch=None, retiring=()):
    owner = qs.effective_route()
    table = list(owner)
    dual_map = {}
    for b, dest in moves.items():
        if dual:
            dual_map[b] = table[b]
        table[b] = dest
    return RouteTable(
        epoch=(qs.route_epoch() + 1) if epoch is None else epoch,
        cliques=qs.route_cliques(),
        table=table,
        dual=dual_map,
        retiring=retiring,
    )


# -- wire format ----------------------------------------------------------


def test_route_table_roundtrip(suniverse):
    qs = mk_qs(suniverse)
    rt = flip_table(qs, {3: 1, 7: 0}, retiring={1})
    rt2 = RouteTable.parse(rt.serialize())
    assert rt2.epoch == rt.epoch
    assert rt2.cliques == rt.cliques
    assert rt2.table == rt.table
    assert rt2.dual == rt.dual
    assert rt2.retiring == rt.retiring


def test_route_table_sign_verify():
    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch.crypto.keyring import Keyring

    ident = topology.new_identity("ap01", key=rsa.generate(1024, seed=11))
    ring = Keyring()
    ring.register([ident.cert])
    rt = RouteTable(
        epoch=2,
        cliques=(1, 2),
        table=[0] * ROUTE_BUCKETS,
        dual={5: 1},
    )
    rt.sign(ident.key, ident.cert)
    assert rt.verify(ring)
    rt2 = RouteTable.parse(rt.serialize())
    assert rt2.verify(ring)
    rt2.epoch = 3  # tamper
    assert not rt2.verify(ring)
    # unknown issuer
    assert not RouteTable.parse(rt.serialize()).verify(Keyring())


# -- install semantics ----------------------------------------------------


def test_install_monotonic(suniverse):
    qs = mk_qs(suniverse)
    assert qs.route_epoch() == 0
    rt1 = flip_table(qs, {})
    assert qs.install_route_table(rt1)
    assert qs.route_epoch() == 1
    # re-install of the current epoch is an idempotent True
    assert qs.install_route_table(rt1)
    # a stale epoch can never roll routing back
    stale = flip_table(qs, {}, epoch=0)
    assert not qs.install_route_table(stale)
    assert qs.route_epoch() == 1
    rt2 = flip_table(qs, {})
    assert qs.install_route_table(rt2)
    assert qs.route_epoch() == 2


def test_signed_install_requires_valid_signature(suniverse):
    from bftkv_tpu_torch import topology
    from bftkv_tpu_torch.crypto.keyring import Keyring

    ident = topology.new_identity("ap01", key=rsa.generate(1024, seed=11))
    ring = Keyring()
    ring.register([ident.cert])
    qs = mk_qs(suniverse)
    rt = flip_table(qs, {})
    assert not qs.install_route_table(rt, ring)  # unsigned
    rt.sign(ident.key, ident.cert)
    assert qs.install_route_table(rt, ring)


# -- ownership + dual window ----------------------------------------------


def moving_bucket(qs, owner_idx):
    for b in range(ROUTE_BUCKETS):
        if qs.effective_route()[b] == owner_idx:
            return b
    raise AssertionError("no bucket owned by shard")


def var_in_bucket(b):
    i = 0
    while True:
        x = b"ep/%d" % i
        if route_bucket(x) == b:
            return x
        i += 1


def test_dual_window_roles(suniverse):
    qs_a = mk_qs(suniverse, "a01")
    qs_b = mk_qs(suniverse, "b01")
    a_idx, b_idx = qs_a.my_shard(), qs_b.my_shard()
    mb = moving_bucket(qs_a, a_idx)
    x = var_in_bucket(mb)
    assert qs_a.route_role(x) == "owner"
    assert qs_b.route_role(x) == "foreign"
    # flip mb from a's shard to b's with the dual window open
    for qs in (qs_a, qs_b):
        assert qs.install_route_table(
            flip_table(qs, {mb: b_idx}, dual=True)
        )
    assert qs_a.route_role(x) == "dual"
    assert qs_b.route_role(x) == "owner"
    assert qs_a.owns(x) and qs_b.owns(x)  # both inside the window
    assert qs_a.signs_for(x) and qs_b.signs_for(x)
    assert mb in qs_a.owned_buckets() and mb in qs_b.owned_buckets()
    assert qs_b.dual_pull_shards() == {a_idx}
    assert qs_a.dual_pull_shards() == {b_idx}
    assert len(qs_b.alt_quorums_for(x, q.AUTH)) == 1
    # finalize: window closes, old owner goes inert
    for qs in (qs_a, qs_b):
        assert qs.install_route_table(
            flip_table(qs, {mb: b_idx}, dual=False)
        )
    assert qs_a.route_role(x) == "foreign"
    assert not qs_a.owns(x) and qs_b.owns(x)
    assert not qs_a.signs_for(x)
    assert qs_a.alt_quorums_for(x, q.AUTH) == []
    assert mb not in qs_a.owned_buckets()


def test_stale_routed_and_hint(suniverse):
    qs_a = mk_qs(suniverse, "a01")
    a_idx = qs_a.my_shard()
    b_idx = 1 - a_idx
    mb = moving_bucket(qs_a, a_idx)
    x = var_in_bucket(mb)
    assert not qs_a.stale_routed(x)
    assert qs_a.install_route_table(
        flip_table(qs_a, {mb: b_idx}, dual=False)
    )
    # an epoch-0 client would still send x here: that is a stale route
    assert qs_a.stale_routed(x)
    epoch, owner = qs_a.route_hint(x)
    assert epoch == 1 and owner == b_idx


def test_note_route_hint_only_newer(suniverse):
    qs = mk_qs(suniverse)
    x = b"hint/x"
    b = route_bucket(x)
    owner = qs.effective_route()[b]
    other = 1 - owner
    assert not qs.note_route_hint(x, 0, other)  # not newer than epoch 0
    assert qs.note_route_hint(x, 3, other)
    assert qs.shard_of(x) == other  # hint steers ROUTING...
    assert qs.effective_route()[b] == owner  # ...but not admission
    # a newer installed table supersedes the hint
    assert qs.install_route_table(flip_table(qs, {}, epoch=3))
    assert qs.shard_of(x) == owner


def test_verify_view_quorum_suff(suniverse):
    """A clique server's weight into a FOREIGN clique is zero, so the
    low-weight rule zeroes suff — unless the verify view is requested
    (migration admission judges the old owner's signatures there)."""
    qs_a = mk_qs(suniverse, "a01")
    b_idx = 1 - qs_a.my_shard()
    collect = qs_a.quorum_for_shard(b_idx, q.AUTH)
    judge = qs_a.quorum_for_shard(b_idx, q.AUTH, verify_view=True)
    assert all(s == 0 for s in collect.bounds()["suff"])
    assert any(s > 0 for s in judge.bounds()["suff"])


def test_seat_info_reports_epoch(suniverse):
    qs = mk_qs(suniverse, "a01")
    assert qs.seat_info()["epoch"] == 0
    mb = moving_bucket(qs, qs.my_shard())
    assert qs.install_route_table(
        flip_table(qs, {mb: 1 - qs.my_shard()}, dual=True)
    )
    info = qs.seat_info()
    assert info["epoch"] == 1
    assert info["dual_buckets"] == 1


# -- wrong-shard decline format -------------------------------------------


def test_wrong_shard_error_forms():
    bare = wrong_shard_error()
    assert bare is ERR_WRONG_SHARD
    assert parse_wrong_shard(bare) == (None, None)
    hinted = wrong_shard_error(4, 2)
    assert parse_wrong_shard(hinted) == (4, 2)
    assert parse_wrong_shard(hinted()) == (4, 2)  # instance too
    assert parse_wrong_shard("wrong shard epoch=9 owner=0") == (9, 0)
    assert parse_wrong_shard("bad timestamp") is None
    # interned round trip through the wire form
    from bftkv_tpu_torch.errors import error_from_string

    assert parse_wrong_shard(error_from_string(hinted.message)) == (4, 2)


# == across the packages, on the same certificates ==

import functools  # noqa: E402

from bftkv_tpu import graph as ref_graph  # noqa: E402
from bftkv_tpu.crypto import cert as ref_cert  # noqa: E402
from bftkv_tpu.crypto import keyring as ref_keyring  # noqa: E402
from bftkv_tpu.ops import tally as ref_tally  # noqa: E402
from bftkv_tpu.quorum import wotqs as ref_wotqs  # noqa: E402
from bftkv_tpu_torch import topology  # noqa: E402
from bftkv_tpu_torch.crypto import cert as certmod  # noqa: E402
from bftkv_tpu_torch.crypto import keyring  # noqa: E402

# (servers per clique, rw per shard, shards)
CROSS = [(4, 2, 1), (7, 3, 2), (16, 4, 3)]
RWS = [q.AUTH, q.AUTH | q.PEER, q.CERT | q.AUTH, q.READ | q.AUTH, q.READ, q.WRITE]


@functools.lru_cache(maxsize=None)
def _universe(n, n_rw, shards):
    keys = [rsa.generate(512, seed=5000 + i) for i in range(n * shards + n_rw * shards + 2)]
    return topology.build_universe(n, 2, n_rw, n_shards=shards, keys=keys,
                                   server_trust_rw=True)


def _graphs(uni, ident):
    """The port's graph from certificates the reference serialized, and
    the reference's graph from certificates the port serialized."""
    ref_view = ref_cert.parse(certmod.serialize_many(uni.view_of(ident)))
    port_view = certmod.parse(ref_cert.serialize_many(ref_view))
    local = uni.local_trust_of(ident)
    out = []
    for G, view in ((Graph, port_view), (ref_graph.Graph, ref_view)):
        g = G()
        me = next(c for c in view if c.id == ident.id)
        g.set_self_nodes([me])
        g.add_peers([c for c in view if c.id != ident.id])
        if local:
            g.add_local_edges(ident.id, local)
        out.append(g)
    return out


def _principals(uni):
    return [uni.servers[0], uni.servers[-1], uni.storage_nodes[0], uni.users[0]]


def _same_quorum(mine, theirs):
    m1, i1 = mine.membership_matrix()
    m2, i2 = theirs.membership_matrix()
    assert i1 == i2
    np.testing.assert_array_equal(m1, m2)
    b1, b2 = mine.bounds(), theirs.bounds()
    assert b1.keys() == b2.keys()
    for k in b1:
        np.testing.assert_array_equal(b1[k], b2[k])
    assert mine.get_threshold() == theirs.get_threshold()
    assert [n.id for n in mine.nodes()] == [n.id for n in theirs.nodes()]


@pytest.mark.parametrize("shape", CROSS, ids=lambda s: "n%d-rw%d-s%d" % s)
def test_quorums_and_routes_equal_across_packages(shape):
    uni = _universe(*shape)
    probes = [b"x/%d" % i for i in range(24)]
    for ident in _principals(uni):
        g1, g2 = _graphs(uni, ident)
        qs1, qs2 = WotQS(g1), ref_wotqs.WotQS(g2)
        for rw in RWS:
            _same_quorum(qs1.choose_quorum(rw), qs2.choose_quorum(rw))
            for x in probes[:6]:
                _same_quorum(qs1.choose_quorum_for(x, rw), qs2.choose_quorum_for(x, rw))
        assert qs1.shard_count() == qs2.shard_count() == shape[2]
        assert qs1.route_cliques() == qs2.route_cliques()
        assert qs1.effective_route() == qs2.effective_route()
        assert qs1.shard_buckets() == qs2.shard_buckets()
        assert qs1.owned_buckets() == qs2.owned_buckets()
        assert [qs1.shard_of(x) for x in probes] == [qs2.shard_of(x) for x in probes]
        assert [qs1.route_role(x) for x in probes] == [qs2.route_role(x) for x in probes]
        assert [qs1.signs_for(x) for x in probes] == [qs2.signs_for(x) for x in probes]
        for node in list(uni.servers[:2]) + list(uni.storage_nodes[:1]) + [ident]:
            assert qs1.seat_info(node.id) == qs2.seat_info(node.id)
        if shape[2] > 1:
            for qs in (qs1, qs2):
                table = list(qs.effective_route())
                table[route_bucket(b"mv")] = (table[route_bucket(b"mv")] + 1) % shape[2]
            rt1 = RouteTable(3, qs1.route_cliques(), table, {route_bucket(b"mv"): 0}, {1})
            rt2 = ref_wotqs.RouteTable(3, qs2.route_cliques(), table, {route_bucket(b"mv"): 0}, {1})
            assert rt1.serialize() == rt2.serialize()
            assert qs1.install_route_table(rt1) and qs2.install_route_table(rt2)
            assert [qs1.route_role(x) for x in probes] == [qs2.route_role(x) for x in probes]
            assert qs1.seat_info() == qs2.seat_info()
            assert qs1.dual_pull_shards() == qs2.dual_pull_shards()


@pytest.mark.parametrize("shape", CROSS, ids=lambda s: "n%d-rw%d-s%d" % s)
def test_predicates_and_tallies_from_a_real_quorum(shape):
    """On a real quorum, the port's ``WotQuorum`` predicates, the
    reference's, the port's tallies on the cpu and the reference's jitted
    tallies give the same answer for every candidate set."""
    uni = _universe(*shape)
    rng = np.random.default_rng(sum(shape))
    for ident in _principals(uni)[::3]:
        g1, g2 = _graphs(uni, ident)
        for rw in (q.AUTH | q.PEER, q.CERT | q.AUTH, q.READ | q.AUTH):
            qr1 = WotQS(g1).choose_quorum(rw)
            qr2 = ref_wotqs.WotQS(g2).choose_quorum(rw)
            membership, index = qr1.membership_matrix()
            bounds = qr1.bounds()
            ids = list(index)
            by1 = {n.id: n for qc in qr1.qcs for n in qc.nodes}
            by2 = {n.id: n for qc in qr2.qcs for n in qc.nodes}
            # Node ids are 64-bit: draw positions, not ids.
            sets = [[ids[j] for j in rng.choice(len(ids), size=int(k), replace=False)]
                    for k in rng.integers(0, len(ids) + 1, size=48)]
            cand = np.stack([qr1.mask_of([by1[i] for i in s]) for s in sets])
            mine = {
                "threshold": tally.is_threshold_batch(membership, cand, bounds["threshold"], device="cpu"),
                "quorum": tally.is_quorum_batch(membership, cand, bounds["f"], bounds["min"], device="cpu"),
                "sufficient": tally.is_sufficient_batch(membership, cand, bounds["suff"], device="cpu"),
                "reject": tally.reject_batch(membership, cand, bounds["f"], device="cpu"),
            }
            theirs = {
                "threshold": ref_tally.is_threshold_batch(membership, cand, bounds["threshold"]),
                "quorum": ref_tally.is_quorum_batch(membership, cand, bounds["f"], bounds["min"]),
                "sufficient": ref_tally.is_sufficient_batch(membership, cand, bounds["suff"]),
                "reject": ref_tally.reject_batch(membership, cand, bounds["f"]),
            }
            for k in mine:
                np.testing.assert_array_equal(mine[k].numpy(), np.asarray(theirs[k]))
            for row, s in enumerate(sets):
                n1 = [by1[i] for i in s]
                n2 = [by2[i] for i in s]
                host = {
                    "threshold": (qr1.is_threshold(n1), qr2.is_threshold(n2)),
                    "quorum": (qr1.is_quorum(n1), qr2.is_quorum(n2)),
                    "sufficient": (qr1.is_sufficient(n1), qr2.is_sufficient(n2)),
                    "reject": (qr1.reject(n1), qr2.reject(n2)),
                }
                for k, (a, b) in host.items():
                    assert a == b == bool(mine[k][row]), (k, row)


def test_route_tables_signed_by_one_package_verify_in_the_other():
    port_ident = topology.new_identity("ap01", key=rsa.generate(1024, seed=21))
    ref_key = ref_keyring.parse_private_key(
        keyring.serialize_private_key(rsa.generate(1024, seed=22)))
    ref_c = ref_cert.Certificate(n=ref_key.n, e=ref_key.e, name="ap02", uid="ap02")
    ref_cert.sign_certificate(ref_c, ref_key)
    port_ring, ref_ring = keyring.Keyring(), ref_keyring.Keyring()
    port_ring.register(certmod.parse(ref_c.serialize()) + [port_ident.cert])
    ref_ring.register(ref_cert.parse(port_ident.cert.serialize()) + [ref_c])
    args = (4, (7, 9), [b % 2 for b in range(ROUTE_BUCKETS)], {5: 1, 6: 0}, {1})
    mine = RouteTable(*args).sign(port_ident.key, port_ident.cert)
    theirs = ref_wotqs.RouteTable(*args).sign(ref_key, ref_c)
    assert ref_wotqs.RouteTable.parse(mine.serialize()).verify(ref_ring)
    assert RouteTable.parse(theirs.serialize()).verify(port_ring)
    # Same payload bytes in both packages; a tampered epoch fails in both.
    assert mine.payload() == theirs.payload()
    bad = ref_wotqs.RouteTable.parse(mine.serialize())
    bad.epoch = 5
    assert not bad.verify(ref_ring)
    bad = RouteTable.parse(theirs.serialize())
    bad.epoch = 5
    assert not bad.verify(port_ring)
