"""Autopilot decisions: pure functions from health + load to a Plan
(counterpart of ``bftkv_tpu/autopilot/plan.py``).

The detect half already exists — per-shard f-budgets and SLO
histograms (the fleet collector) and per-bucket route load
(``WotQS.bucket_load``).  This module is the *decide* half: given
those inputs, emit at most one :class:`Plan` — split a hot shard's
buckets across cliques, or drain-and-retire a clique whose f-budget is
spent.  Everything here is deterministic and side-effect free so the
same inputs always yield the same plan (the chaos soak replays them).

The *execute* half (``daemon.py``) turns a Plan into three phases —
pre-copy, flip, drain — riding the background anti-entropy/repair
planes, never the write's one-round critical path ("The Latency Price
of Threshold Cryptosystems": keep expensive coordination off the
latency-critical path).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from bftkv_tpu_torch.quorum.wotqs import ROUTE_BUCKETS, RouteTable

__all__ = [
    "Plan",
    "decide",
    "next_table",
    "HOT_SKEW",
    "MIN_LOAD",
]

#: A shard is "hot" when its routed load reaches this multiple of the
#: fair share (total / shards).  1.6 = carrying 60% more than its
#: share.  (At 2 shards the worst case is exactly 2× fair, so a bound
#: of 2.0 could never trigger there.)
HOT_SKEW = 1.6

#: Ignore load signals below this many routed operations — deciding
#: off a handful of requests would make the autopilot twitchy.
MIN_LOAD = 32


@dataclass
class Plan:
    """One topology decision.  ``kind``: ``split`` | ``retire``.
    ``shard``: the source shard index; ``assign``: bucket → destination
    shard index for every moving bucket; ``reason``: human-readable
    trail for the fleet document."""

    kind: str
    shard: int
    assign: dict[int, int] = field(default_factory=dict)
    reason: str = ""


def _shard_loads(
    bucket_load: list[int], owner_of: list[int], nshards: int
) -> list[int]:
    loads = [0] * nshards
    for b, n in enumerate(bucket_load[:ROUTE_BUCKETS]):
        if n and 0 <= owner_of[b] < nshards:
            loads[owner_of[b]] += n
    return loads


def decide(
    f_remaining: dict[int, int],
    bucket_load: list[int],
    owner_of: list[int],
    nshards: int,
    *,
    hot_skew: float = HOT_SKEW,
    min_load: int = MIN_LOAD,
    retiring: set[int] | None = None,
) -> Plan | None:
    """At most one decision, priority ordered:

    1. **retire** — a shard whose f-budget is exhausted
       (``remaining <= 0``: as many clique members dark as the
       b-masking bound tolerates; the next fault stalls its write
       quorum or breaks masking).  All its buckets move to the
       surviving shards, spread by current load (least-loaded first).
    2. **split** — the hottest shard carries more than ``hot_skew``
       times the fair share of routed load: its hottest buckets move
       to the least-loaded shard until roughly half its load is gone.

    Returns None when the topology needs nothing (the steady state).
    """
    retiring = retiring or set()
    if nshards < 2:
        return None  # nowhere to move anything

    # -- retire: tolerance exhausted beats load every time -----------------
    for sh in sorted(f_remaining):
        if f_remaining[sh] > 0 or sh in retiring or sh >= nshards:
            continue
        survivors = [
            i
            for i in range(nshards)
            if i != sh
            and i not in retiring
            and f_remaining.get(i, 1) > 0
        ]
        if not survivors:
            return None  # no healthy destination: a human's problem
        loads = _shard_loads(bucket_load, owner_of, nshards)
        # Spread the dying clique's buckets over survivors, filling the
        # least-loaded first (simple greedy; buckets are fungible).
        assign: dict[int, int] = {}
        weights = {i: loads[i] for i in survivors}
        for b in range(ROUTE_BUCKETS):
            if owner_of[b] != sh:
                continue
            dest = min(weights, key=lambda i: (weights[i], i))
            assign[b] = dest
            weights[dest] += max(bucket_load[b], 1)
        if not assign:
            return None
        return Plan(
            kind="retire",
            shard=sh,
            assign=assign,
            reason=(
                f"shard {sh} f-budget exhausted "
                f"(remaining={f_remaining[sh]}); draining "
                f"{len(assign)} buckets to {sorted(set(assign.values()))}"
            ),
        )

    # -- split: hot-shard load rebalance -----------------------------------
    total = sum(bucket_load[:ROUTE_BUCKETS])
    if total < min_load:
        return None
    loads = _shard_loads(bucket_load, owner_of, nshards)
    hot = max(range(nshards), key=lambda i: loads[i])
    fair = total / nshards
    if loads[hot] < hot_skew * fair:
        return None
    candidates = [
        i for i in range(nshards) if i != hot and i not in retiring
    ]
    if not candidates:
        return None
    target = min(candidates, key=lambda i: (loads[i], i))
    # Move the hot shard's hottest buckets until ~half its load moved.
    hot_buckets = sorted(
        (b for b in range(ROUTE_BUCKETS) if owner_of[b] == hot),
        key=lambda b: -bucket_load[b],
    )
    moved, goal = 0, loads[hot] / 2.0
    assign = {}
    for b in hot_buckets:
        if moved >= goal or len(assign) >= len(hot_buckets) - 1:
            break
        if bucket_load[b] <= 0:
            break  # only observed-hot buckets move; cold ones stay
        assign[b] = target
        moved += bucket_load[b]
    if not assign:
        return None
    return Plan(
        kind="split",
        shard=hot,
        assign=assign,
        reason=(
            f"shard {hot} at {loads[hot]}/{total} routed ops "
            f"(fair share {fair:.0f}); moving {len(assign)} hot "
            f"buckets ({moved} ops) to shard {target}"
        ),
    )


def next_table(
    qs,
    assign: dict[int, int],
    *,
    dual: bool = True,
    retiring: set[int] | None = None,
    epoch: int | None = None,
) -> RouteTable:
    """The epoch-N+1 route table realizing ``assign`` (bucket → new
    owner shard index) on top of ``qs``'s current effective route.
    ``dual=True`` opens the dual-epoch admission window for every
    moving bucket (the flip table); ``dual=False`` closes it (the
    finalize table — and the abrupt form the route_flap fault ships).
    """
    owner = qs.effective_route()
    if not owner:
        raise ValueError("unsharded topology has no route table")
    cliques = qs.route_cliques()
    table = list(owner)
    dual_map: dict[int, int] = {}
    for b, dest in assign.items():
        if table[b] != dest:
            if dual:
                dual_map[b] = table[b]
            table[b] = dest
    return RouteTable(
        epoch=(qs.route_epoch() + 1) if epoch is None else epoch,
        cliques=cliques,
        table=table,
        dual=dual_map,
        retiring=retiring or set(),
    )
