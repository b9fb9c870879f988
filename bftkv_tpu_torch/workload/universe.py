"""Planet-scale universe generation + the scaling profiler.

Counterpart of ``bftkv_tpu/workload/universe.py``.

Real identities pay an RSA keygen (~100 ms each) — a 10k-node universe
would spend 20 minutes minting keys before the first routing question.
This module generates SYNTHETIC principals instead: lightweight cert
objects satisfying exactly the duck-type the trust graph consumes
(``id`` / ``name`` / ``address`` / ``signers()`` / ``serialize()``),
streamed in per-shard cliques, so clique discovery, ``_ShardTopo``
build, and ``choose_quorum_for`` can be exercised and profiled at
10k–100k nodes.  The routing plane is a pure function of the edge set
— no signature is ever verified to build a topology — so synthetic
certs measure the real code paths.

Membership churn and revocation storms are SCHEDULES (deterministic
event lists from the sha256(seed|stream|counter) discipline), applied
as graph mutations; each bumps ``graph.generation`` and the §18
scaling question is how fast the generation-guard memos rebuild.

The profiler (`python -m bftkv_tpu_torch.workload.universe --nodes 10000`)
verifies the acceptance bar directly: steady-state ``choose_quorum_for``
must do NO O(universe) work per op — counted, not timed: the O(V)
graph traversals (``get_disjoint_cliques``, ``get_reachable_nodes``,
``get_peers``) are instrumented and must not fire once the memos are
warm.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass

from bftkv_tpu_torch import quorum as q
from bftkv_tpu_torch.graph import Graph
from bftkv_tpu_torch.quorum.wotqs import WotQS

__all__ = [
    "SynthCert", "ChurnEvent", "synthetic_certs", "build_synthetic_graph",
    "churn_schedule", "apply_churn", "profile_universe", "main",
]

#: Synthetic ids live above 2^62 so a grafted REAL universe (random
#: 64-bit cert ids are overwhelmingly below this on test fixtures)
#: keeps the smallest ids — shard order, which sorts by min member id,
#: then puts real cliques first deterministically.
_SYNTH_ID_BASE = 1 << 62


class SynthCert:
    """A certificate-shaped principal without the cryptography: the
    trust graph only reads identity and the signer-id list."""

    __slots__ = ("id", "name", "address", "active", "_signers")

    def __init__(self, nid: int, name: str, address: str,
                 signers: list[int]):
        self.id = nid
        self.name = name
        self.address = address
        self.active = True
        self._signers = signers

    def signers(self) -> list[int]:
        return self._signers

    def serialize(self) -> bytes:
        return b"synth:%016x" % self.id

    def __repr__(self) -> str:  # pragma: no cover
        return f"SynthCert({self.name})"


def synthetic_certs(
    n_nodes: int, *, shard_size: int = 4, seed: int = 0,
    id_base: int = _SYNTH_ID_BASE,
) -> list[SynthCert]:
    """``n_nodes`` synthetic principals in disjoint cliques of
    ``shard_size``: every member's signer list is its clique peers, so
    ``Graph.add_nodes`` materializes the full bidirectional clique edge
    set.  Generation is streamed — O(n) time, O(n) memory, no pairwise
    scans.  A trailing partial clique below the b-masking floor (4) is
    still generated; ``get_disjoint_cliques(min_size=4)`` drops it."""
    if shard_size < 1:
        raise ValueError("shard_size must be >= 1")
    # A seed offset keeps distinct universes disjoint in id space.
    base = id_base + (seed % 4096) * (1 << 40)
    out: list[SynthCert] = []
    for c0 in range(0, n_nodes, shard_size):
        members = list(range(c0, min(c0 + shard_size, n_nodes)))
        ids = [base + m for m in members]
        for m, nid in zip(members, ids):
            out.append(SynthCert(
                nid,
                f"syn{seed}-{m}",
                f"syn://{m}",
                [i for i in ids if i != nid],
            ))
    return out


def build_synthetic_graph(
    n_nodes: int, *, shard_size: int = 4, seed: int = 0,
) -> tuple[Graph, list[SynthCert]]:
    """A standalone synthetic universe with the first node as self."""
    certs = synthetic_certs(n_nodes, shard_size=shard_size, seed=seed)
    g = Graph()
    g.set_self_nodes([certs[0]])
    g.add_peers(certs[1:])
    return g, certs


# -- churn / revocation-storm schedules ----------------------------------

@dataclass(frozen=True)
class ChurnEvent:
    t_s: float      # seconds from universe t0
    kind: str       # join | leave | revoke
    index: int      # node index (leave/revoke) or join sequence number


def churn_schedule(
    n_events: int, *, n_nodes: int, duration_s: float, seed: int = 0,
    storm_start_frac: float | None = None, storm_frac: float = 0.1,
    storm_revokes: int = 0,
) -> list[ChurnEvent]:
    """A deterministic membership-churn schedule: ``n_events`` draws of
    join/leave/revoke spread over the run, plus an optional revocation
    STORM (``storm_revokes`` revokes packed into a burst window) —
    the workload-event form of the §23 churn model.  Every draw is
    sha256(seed|churn|i); one seed replays one schedule."""
    events: list[ChurnEvent] = []
    kinds = ("join", "leave", "revoke")
    for i in range(n_events):
        h = hashlib.sha256(f"{seed}|churn|{i}".encode()).digest()
        u_t = int.from_bytes(h[:8], "big") / 2**64
        u_k = int.from_bytes(h[8:16], "big") / 2**64
        u_n = int.from_bytes(h[16:24], "big") / 2**64
        events.append(ChurnEvent(
            t_s=round(u_t * duration_s, 4),
            kind=kinds[int(u_k * len(kinds))],
            index=int(u_n * n_nodes),
        ))
    if storm_start_frac is not None and storm_revokes > 0:
        a = duration_s * storm_start_frac
        w = duration_s * storm_frac
        for i in range(storm_revokes):
            h = hashlib.sha256(f"{seed}|storm|{i}".encode()).digest()
            u_t = int.from_bytes(h[:8], "big") / 2**64
            u_n = int.from_bytes(h[8:16], "big") / 2**64
            events.append(ChurnEvent(
                t_s=round(a + u_t * w, 4),
                kind="revoke",
                index=int(u_n * n_nodes),
            ))
    events.sort(key=lambda e: (e.t_s, e.kind, e.index))
    return events


def apply_churn(
    graph: Graph, certs: list[SynthCert], ev: ChurnEvent, *,
    shard_size: int = 4, seed: int = 0,
) -> None:
    """Apply one schedule event to a live graph.  ``join`` adds a
    whole fresh clique (membership grows in quorum-capable units);
    ``leave`` removes a node; ``revoke`` revokes one.  Each bumps the
    graph generation — the memo-rebuild cost the profiler charges."""
    if ev.kind == "join":
        new = synthetic_certs(
            shard_size, shard_size=shard_size, seed=seed,
            id_base=_SYNTH_ID_BASE + (1 << 50) + ev.index * (1 << 20),
        )
        graph.add_peers(new)
        certs.extend(new)
    elif certs:
        target = certs[ev.index % len(certs)]
        if ev.kind == "leave":
            graph.remove_nodes([target])
        else:
            graph.revoke(target)


# -- the scaling profiler ------------------------------------------------

class _CallCounter:
    """Count invocations of the O(universe) graph traversals — the
    per-op acceptance oracle: once the generation-guard memos are warm,
    steady-state routing must not call any of these."""

    WRAPPED = ("get_disjoint_cliques", "get_reachable_nodes", "get_peers")

    def __init__(self, graph: Graph):
        self.graph = graph
        self.counts = {name: 0 for name in self.WRAPPED}
        self._orig: dict = {}

    def __enter__(self) -> "_CallCounter":
        for name in self.WRAPPED:
            orig = getattr(self.graph, name)
            self._orig[name] = orig

            def wrapped(*a, _n=name, _f=orig, **kw):
                self.counts[_n] += 1
                return _f(*a, **kw)

            setattr(self.graph, name, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        for name, orig in self._orig.items():
            setattr(self.graph, name, orig)

    def total(self) -> int:
        return sum(self.counts.values())


def profile_universe(
    n_nodes: int, *, shard_size: int = 4, ops: int = 2000,
    churn_events: int = 4, seed: int = 0,
) -> dict:
    """Build an ``n_nodes`` synthetic universe and profile the routing
    plane at that size: graph build, clique discovery, ``_ShardTopo``
    build, steady-state ``choose_quorum_for`` per-op cost, and the
    amortized memo-rebuild cost under churn.  The per-op O(universe)
    check is counted (see :class:`_CallCounter`), not inferred from
    wall time."""
    t0 = time.perf_counter()
    graph, certs = build_synthetic_graph(
        n_nodes, shard_size=shard_size, seed=seed
    )
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cliques = graph.get_disjoint_cliques(min_size=4)
    cliques_s = time.perf_counter() - t0

    qs = WotQS(graph)
    t0 = time.perf_counter()
    topo = qs._topology()
    topo_s = time.perf_counter() - t0

    rw = q.WRITE
    # Warm the per-shard quorum memos on every bucket the op loop hits
    # (first touch of a shard pays its one-time quorum build; steady
    # state is what production serves and what the oracle counts).
    keys = [b"uni/%d/%d" % (seed, i) for i in range(ops)]
    for k in keys:
        qs.choose_quorum_for(k, rw)

    with _CallCounter(graph) as counter:
        t0 = time.perf_counter()
        for k in keys:
            qs.choose_quorum_for(k, rw)
        steady_s = time.perf_counter() - t0
    per_op_us = steady_s / max(ops, 1) * 1e6

    # Churn: each event invalidates the generation memos; the next op
    # pays one topology rebuild, every following op rides the memo.
    sched = churn_schedule(
        churn_events, n_nodes=len(certs), duration_s=1.0, seed=seed
    )
    t0 = time.perf_counter()
    rebuilds = 0
    for ev in sched:
        apply_churn(graph, certs, ev, shard_size=shard_size, seed=seed)
        qs.choose_quorum_for(b"uni/churn/%d" % rebuilds, rw)
        rebuilds += 1
    churn_s = time.perf_counter() - t0

    return {
        "n_nodes": n_nodes,
        "shard_size": shard_size,
        "n_cliques": len(cliques),
        "route_buckets": len(topo.table),
        "build_s": round(build_s, 3),
        "cliques_s": round(cliques_s, 3),
        "topo_s": round(topo_s, 3),
        "steady_ops": ops,
        "steady_per_op_us": round(per_op_us, 2),
        # The acceptance oracle: O(universe) traversals during the
        # steady window.  Must be 0.
        "o_universe_calls_steady": counter.total(),
        "o_universe_call_counts": counter.counts,
        "churn_events": rebuilds,
        "churn_rebuild_s_per_event": round(churn_s / max(rebuilds, 1), 3),
    }


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="profile the routing plane at planet scale"
    )
    ap.add_argument("--nodes", type=int, default=10000)
    ap.add_argument("--shard-size", type=int, default=4)
    ap.add_argument("--ops", type=int, default=2000)
    ap.add_argument("--churn", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    res = profile_universe(
        args.nodes, shard_size=args.shard_size, ops=args.ops,
        churn_events=args.churn, seed=args.seed,
    )
    print(json.dumps(res, indent=1, sort_keys=True))
    return 0 if res["o_universe_calls_steady"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
