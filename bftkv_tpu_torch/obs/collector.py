"""The fleet collector: scrape → stitch → BFT-native health.

Counterpart of ``bftkv_tpu/obs/collector.py``.

One :class:`FleetCollector` watches every member of a (possibly
sharded) fleet through :mod:`bftkv_tpu_torch.obs.source` objects and keeps
three products current:

**f-budget per shard.**  The paper's tolerance is quantitative: a
clique of ``n`` replicas survives ``f = (n-1)//3`` faults, commits at
``2f+1`` and collects signatures at ``suff = f + (n-f)//2 + 1``
(``quorum/wotqs.py``).  The collector counts clique members that fail
their liveness probe and reports ``remaining = f - down`` — the number
of additional faults the shard can absorb before its write quorum
stalls (liveness) or its masking assumption breaks (safety).  Storage
(complement) members are tracked and alarmed but do not consume the
clique budget: the WRITE complement runs with ``f = 0`` by
construction (wotqs ``W = U − {Ci} + R``).

**SLO histograms per shard.**  Daemons export fixed-bucket latency
histograms (``metrics.BUCKETS``) precisely so this code can sum bucket
vectors across processes and estimate fleet-wide p50/p99 — per-daemon
summary quantiles cannot be merged.  Slow-trace entries (which carry
``shard``/``peer`` attribution) become exemplars: a latency regression
links directly to trace ids you can pull.

**Anomaly feed.**  A bounded ring of events derived from what already
exists: per-source counter deltas (``server.wrong_shard``,
``server.equivocation``, ``server.verify.collective_fail``,
``transport.peer.opens``, ``faults.fired``), membership transitions
(probe up→down / down→up), and — in-process — the failpoint
registry's fault trace, so an injected partition surfaces in the feed
within one scrape interval (the chaos nemesis asserts exactly this).
"""

from __future__ import annotations

import re
import threading
import time
from collections import OrderedDict, deque

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.metrics import BUCKETS, histogram_quantile
from bftkv_tpu_torch.obs.capacity import CapacityPlane
from bftkv_tpu_torch.obs.critpath import ROOT_OPS, PhaseBudget, attribute
from bftkv_tpu_torch.obs.stitch import Stitcher
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["FleetCollector", "parse_flat_key"]

_FLAT_KEY = re.compile(r"^([^{]+)\{(.*)\}$")

#: Counter families whose per-scrape delta becomes one anomaly event.
#: Closed list — the feed must not turn into a second metrics dump.
ANOMALY_COUNTERS = {
    "server.wrong_shard": "wrong_shard",
    "server.equivocation": "equivocation",
    "server.verify.collective_fail": "collective_verify_fail",
    "transport.peer.opens": "peer_circuit_open",
    "faults.fired": "fault_injected",
    # A committed piggybacked write whose async tail never reached a
    # verifying ``suff`` share set: the record stays commit-pending
    # until a reader certifies it — worth an operator's attention.
    "client.tail.starved": "tail_starved",
    # The repair daemon's verdict on residue that can NEVER certify
    # (the SIGN round could not mint a verifying suff): same starved-
    # tail condition, detected from the replica's seat instead of the
    # writer's — only misbehavior or >f loss can produce it.
    "sync.repair.demoted": "tail_starved",
    # Gray failure: a peer whose observed RTT jumped far above its own
    # baseline (transport/latency.py) — alive for the prober, poison
    # for tail latency.  One event per gray episode, not per RPC.
    "transport.peer.slow": "gray_member",
    # Edge gateway tier (bftkv_tpu_torch/gateway).  Sustained shedding means
    # the front door is turning clients away — capacity, not safety.
    "gateway.shed": "gateway_shed",
    # A fill (or write-through) whose collective signature failed
    # verification against the owner quorum: someone fed the gateway a
    # record the quorum never endorsed — the Byzantine-fill signal.
    "gateway.cache.verify_fail": "gateway_poisoned_fill",
    # Epoched routing (DESIGN.md §15): a replica declined a request
    # for a bucket an epoch flip moved away from it — some client is
    # still routing on an older epoch (the route_flap fault's shape;
    # benign in small bursts around a flip, sustained means a member
    # never received the new table).
    "server.epoch_stale": "epoch_skew",
    # Shared crypto sidecar (DESIGN.md §17).  The breaker opened: the
    # service is unreachable/broken and tenants are on local crypto —
    # capacity, not safety (results were never trusted).
    "verify.remote_breaker_open": "sidecar_down",
    # A spot-check or signature self-check caught the sidecar lying
    # (wrong verdict / forged signature): the Byzantine-service
    # signal.  The tenant already fell back to local crypto.
    "crypto.sidecar.dishonest": "sidecar_dishonest",
    # Sustained sidecar shedding: the shared crypto plane is turning
    # batches away — tenants absorb them locally, at host speed.
    "sidecar.shed": "sidecar_shed",
}


def parse_flat_key(key: str) -> tuple[str, dict]:
    """``name{k=v,...}`` → ``(name, {k: v})`` (the snapshot grammar)."""
    m = _FLAT_KEY.match(key)
    if not m:
        return key, {}
    labels: dict = {}
    for part in m.group(2).split(","):
        if "=" in part:
            k, _, v = part.partition("=")
            labels[k] = v
    return m.group(1), labels


class _Member:
    __slots__ = (
        "source",
        "info",
        "info_stale",
        "status",
        "last_ok",
        "last_err",
        "scrape_s",
        "cursor",
        "prev_counters",
        "ring_dropped",
        "slow_dropped",
    )

    def __init__(self, source):
        self.source = source
        self.info: dict = {}
        #: Re-fetch /info on the next scrape (set on recovery and on
        #: the periodic refresh tick) — but keep the LAST KNOWN seat
        #: meanwhile: a down member's f-budget attribution needs it.
        self.info_stale = True
        self.status = "unknown"  # unknown | up | down
        self.last_ok = 0.0
        self.last_err = ""
        self.scrape_s = 0.0
        self.cursor = 0
        self.prev_counters: dict = {}
        #: Cumulative trace-ring overwrite counts the member self-
        #: reports on /trace — the fleet-wide under-sampling signal.
        self.ring_dropped = 0
        self.slow_dropped = 0


class FleetCollector:
    """``sources``: one per fleet member.  ``local_metrics`` /
    ``local_tracer`` / ``fp_registry``: process-wide feeds for
    in-process clusters (every loopback server shares one registry and
    tracer, so these attach once, to the collector, not per source).
    ``scrape_once()`` is synchronous and reentrant-safe;
    ``start(interval)`` runs it on a daemon thread."""

    #: Every member's /info (shard seat, clique membership) is
    #: re-fetched at this scrape cadence — and immediately after a
    #: down→up transition — so membership churn reseats the health
    #: document instead of going stale forever.
    INFO_REFRESH_SCRAPES = 30

    def __init__(
        self,
        sources: list,
        *,
        interval: float = 2.0,
        local_metrics=None,
        local_tracer=None,
        fp_registry=None,
        max_anomalies: int = 1024,
    ):
        self.members = {s.name: _Member(s) for s in sources}
        self.interval = interval
        self.local_metrics = local_metrics
        self.local_tracer = local_tracer
        self.fp_registry = fp_registry
        self.stitcher = Stitcher()
        self._lock = named_lock("obs.collector")
        self._anomalies: deque = deque(maxlen=max_anomalies)
        self._anomaly_seq = 0
        self._local_cursor = 0
        self._local_prev: dict = {}
        self._fp_seq = 0
        self._scrapes = 0
        self._slo: dict = {}  # (shard, op) -> merged bucket vector
        self._slo_sums: dict = {}  # (shard, op) -> merged latency sum
        self._exemplars: dict = {}  # shard -> deque of slow entries
        #: Critical-path attribution (DESIGN.md §18): per-(op, shard)
        #: phase budgets over the stitched traces.
        self.budget = PhaseBudget()
        #: trace id -> scrape index its root was first seen.  A trace
        #: is attributed one full scrape AFTER its root appears, so
        #: server-side fragments scraped from other daemons in between
        #: make it into the tree (bounded; overflow = oldest dropped,
        #: counted so under-sampling is visible, never silent).
        self._attr_pending: "OrderedDict[str, int]" = OrderedDict()
        self._attr_dropped = 0
        #: SLO burn-rate state: previous merged write vectors (per-
        #: scrape deltas are the burn signal — cumulative histograms
        #: stop moving once counts are large) + per-shard consecutive
        #: breach counts with hysteresis.
        self._burn_prev: dict = {}
        self._burn_count: dict = {}
        #: Capacity plane (DESIGN.md §20): per-member USE rows folded
        #: from every scraped metrics snapshot + the local feed, the
        #: bottleneck verdict, and the resource_saturated hysteresis.
        self.capacity = CapacityPlane()
        self._local_ring_dropped = 0
        self._local_slow_dropped = 0
        #: Regions currently dark (every labeled member down) — the
        #: region_down/region_up transition state (DESIGN.md §21).
        self._region_dark: set = set()
        #: Anomaly listeners (the flight recorder's feed), called
        #: OUTSIDE the collector lock — a listener may read health().
        self._listeners: list = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        #: Optional zero-arg callable set by an attached topology
        #: autopilot; its status rides the health document so /fleet
        #: reports the last decision next to the budgets it came from.
        self.autopilot_status = None

    # -- anomaly feed ------------------------------------------------------

    def add_anomaly_listener(self, fn) -> None:
        """``fn(anomaly_dict)`` on every fresh anomaly — the flight
        recorder's anomaly→bundle path.  Called OUTSIDE the collector
        lock (a listener may call :meth:`health`/:meth:`anomalies`); a
        raising listener never takes the scrape down."""
        with self._lock:
            self._listeners.append(fn)

    def _emit(self, kind: str, source: str, shard, detail: str, count=1):
        with self._lock:
            self._anomaly_seq += 1
            anomaly = {
                "seq": self._anomaly_seq,
                "ts": time.time(),
                "kind": kind,
                "source": source,
                "shard": shard,
                "detail": detail,
                "count": count,
            }
            self._anomalies.append(anomaly)
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(anomaly)
            except Exception:
                pass  # a broken black box must not break detection

    def anomalies(self, since_seq: int = 0, limit: int = 200) -> list[dict]:
        with self._lock:
            return [a for a in self._anomalies if a["seq"] > since_seq][
                -limit:
            ]

    # -- critical-path attribution (DESIGN.md §18) -------------------------

    ATTR_PENDING_MAX = 2048

    def _note_roots(self, spans: list) -> None:
        """Mark every fresh write/read root trace for attribution ONE
        scrape later — the deferral that lets server-side fragments
        from other daemons join the tree first."""
        with self._lock:
            cur = self._scrapes
            for s in spans:
                if "parent" not in s and s.get("name") in ROOT_OPS:
                    tid = s.get("trace")
                    if tid and tid not in self._attr_pending:
                        self._attr_pending[tid] = cur
                        while len(self._attr_pending) > self.ATTR_PENDING_MAX:
                            self._attr_pending.popitem(last=False)
                            self._attr_dropped += 1

    def _ingest_spans(self, who: str, texp: dict, m=None) -> None:
        """One source's trace export → stitcher + root marking + the
        member's self-reported ring-drop counters."""
        spans = texp.get("spans") or []
        self.stitcher.add(who, spans)
        self._note_roots(spans)
        if m is not None:
            m.ring_dropped = texp.get("ring_dropped", m.ring_dropped)
            m.slow_dropped = texp.get("slow_dropped", m.slow_dropped)

    def _attribute_pass(self) -> None:
        """Attribute every due trace (root seen at least one full
        scrape ago) into the per-(op, shard) phase budgets."""
        with self._lock:
            cur = self._scrapes
            due = [t for t, sc in self._attr_pending.items() if sc < cur]
            for tid in due:
                del self._attr_pending[tid]
        for tid in due:
            spans = self.stitcher.spans(tid)
            if not spans:
                continue  # evicted before its turn: under-sampled, not wrong
            breakdown = attribute(spans)
            if breakdown is not None:
                self.budget.observe(breakdown)

    # -- SLO burn rate (hysteresis) ----------------------------------------

    def _slo_burn_check(self, slo_counts: dict) -> None:
        """``slo_burn`` when a shard's PER-SCRAPE write p99 (delta of
        the merged bucket vectors — cumulative histograms stop moving
        once counts are large) exceeds ``BFTKV_SLO_WRITE_P99`` for k
        consecutive traffic-bearing scrapes.  One slow scrape never
        fires it; a clean scrape re-arms."""
        thr = flags.get_float("BFTKV_SLO_WRITE_P99")
        if thr is None:
            return
        if not slo_counts:
            return  # no merged histograms at all: nothing to judge
        k = max(flags.get_int("BFTKV_SLO_BURN_SCRAPES") or 3, 1)
        for (sh, op), vec in slo_counts.items():
            if op != "write":
                continue
            prev = self._burn_prev.get((sh, op))
            delta = [
                c - (prev[i] if prev and i < len(prev) else 0)
                for i, c in enumerate(vec)
            ]
            if sum(delta) <= 0:
                # No fresh writes this scrape (or a restart shrank the
                # merge): neither a breach nor a recovery — the burn
                # count holds, idle time can't page or un-page anyone.
                continue
            p99 = histogram_quantile(0.99, delta)
            if p99 is not None and p99 > thr:
                n = self._burn_count.get(sh, 0) + 1
                self._burn_count[sh] = n
                if n == k:  # fires ONCE per burn episode
                    self._emit(
                        "slo_burn", "collector", sh,
                        f"write p99_le {p99:g}s > slo {thr:g}s "
                        f"for {k} consecutive scrapes",
                    )
            else:
                self._burn_count[sh] = 0  # recovery re-arms
        self._burn_prev = {key: list(v) for key, v in slo_counts.items()}

    # -- scraping ----------------------------------------------------------

    def _shard_of_member(self, name: str):
        m = self.members.get(name)
        if m is None:
            return None
        return m.info.get("shard")

    def _counter_deltas(self, who: str, shard, prev: dict, snap: dict) -> dict:
        """Diff the watched counter families and emit anomalies; returns
        the new baseline (watched keys only)."""
        base: dict = {}
        for key, val in snap.items():
            if not isinstance(val, (int, float)):
                continue
            name, labels = parse_flat_key(key)
            kind = ANOMALY_COUNTERS.get(name)
            if kind is None:
                continue
            base[key] = val
            delta = val - prev.get(key, 0)
            if delta > 0:
                detail = (
                    ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                    or name
                )
                sh = labels.get("shard")
                if sh is not None and sh.isdigit():
                    sh = int(sh)
                else:
                    sh = shard
                self._emit(kind, who, sh, detail, int(delta))
        return base

    _SLO_OPS = {
        "client.write.latency": "write",
        "client.read.latency": "read",
    }

    def _merge_slo(self, shard_counts: dict, shard_sums: dict,
                   snap: dict) -> None:
        """Fold one daemon's ``client.{write,read}.latency`` bucket and
        sum keys into the per-shard merged histograms.  Shard-labeled
        series win; unlabeled series only count when the fleet is
        unsharded (they would double-count otherwise — the client
        observes both)."""
        sharded = any(
            (m.info.get("shard_count") or 1) > 1
            for m in self.members.values()
        )
        for key, val in snap.items():
            name, labels = parse_flat_key(key)
            if name.endswith(".bucket"):
                op = self._SLO_OPS.get(name[: -len(".bucket")])
                kind = "bucket"
            elif name.endswith(".sum"):
                op = self._SLO_OPS.get(name[: -len(".sum")])
                kind = "sum"
            else:
                continue
            if op is None:
                continue
            sh = labels.get("shard")
            if sh is None:
                if sharded:
                    continue
                sh = 0
            else:
                sh = int(sh) if str(sh).isdigit() else sh
            if kind == "sum":
                shard_sums[(sh, op)] = shard_sums.get((sh, op), 0.0) + val
                continue
            le = labels.get("le")
            try:
                idx = (
                    len(BUCKETS)
                    if le == "+Inf"
                    else BUCKETS.index(float(le))
                )
            except (TypeError, ValueError):
                continue
            h = shard_counts.setdefault(
                (sh, op), [0] * (len(BUCKETS) + 1)
            )
            h[idx] += int(val)

    def _ingest_slow(self, who: str, shard, slow: list) -> None:
        for entry in slow or []:
            sh = entry.get("shard")
            if sh is None:
                sh = shard
            if sh is None:
                sh = 0  # unsharded fleets report as shard 0 throughout
            ex = {
                "trace_id": entry.get("trace_id"),
                "root": entry.get("root"),
                "duration": round(entry.get("duration", 0.0), 4),
                "source": who,
            }
            if "peer" in entry:
                ex["peer"] = entry["peer"]
            with self._lock:  # health() iterates these concurrently
                d = self._exemplars.setdefault(sh, deque(maxlen=16))
                if not any(
                    e["trace_id"] == ex["trace_id"] for e in d
                ):
                    d.append(ex)

    def _fetch(self, m: _Member) -> tuple:
        """The NETWORK phase for one member — no shared-state writes,
        so many of these run concurrently (a hung daemon then costs one
        source-timeout of wall clock per scrape, not one per hung
        member serially).  Returns
        ``(info|None, ok, snap, texp, err, elapsed_s)``."""
        t0 = time.perf_counter()
        info = None
        try:
            # Gateways and sidecars self-report their live stats on
            # /info (cache/shed; queue/occupancy), so their seat
            # document is live data, not topology — refetch every
            # scrape instead of on the 30-scrape cadence.
            if (
                m.info_stale
                or not m.info
                or m.info.get("role") in ("gateway", "sidecar")
            ):
                info = m.source.info() or {}
            if not getattr(m.source, "PROBE_BY_SCRAPE", False):
                # In-process sources: the probe is the signal (their
                # metrics feed is process-wide, always "up").
                if not m.source.probe():
                    return (info, False, None, None, "probe failed",
                            time.perf_counter() - t0)
            # HTTP sources skip the extra probe round trip: the
            # metrics fetch succeeding IS the liveness signal.
            snap = m.source.metrics()
            texp = m.source.trace_export(m.cursor)
            return info, True, snap, texp, "", time.perf_counter() - t0
        except Exception as e:
            return (info, False, None, None,
                    str(e) or type(e).__name__,
                    time.perf_counter() - t0)

    def scrape_once(self) -> dict:
        """One pass over every source + the process-wide feeds.
        Returns the fresh :meth:`health` document."""
        slo_counts: dict = {}
        slo_sums: dict = {}
        renames: list[tuple[str, str]] = []
        with self._lock:
            members = list(self.members.items())
            refresh_tick = self._scrapes % self.INFO_REFRESH_SCRAPES == 0
        if refresh_tick:
            # Topology is not static: /joining, /leaving, and
            # revocations reseat members.  Mark every seat stale on a
            # slow cadence so the health plane converges to membership
            # changes instead of grouping by a boot-time snapshot
            # forever.
            for _n, m in members:
                m.info_stale = True

        # Phase 1 — network, concurrent per member.
        results: dict = {}
        if len(members) > 1:
            def run(name, m):
                results[name] = self._fetch(m)

            threads = [
                threading.Thread(target=run, args=(n, m), daemon=True)
                for n, m in members
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            results = {n: self._fetch(m) for n, m in members}

        # Phase 2 — state, sequential (stitcher/deltas/anomalies).
        for name, m in members:
            info, ok, snap, texp, err, elapsed = results[name]
            prev_status = m.status
            if info is not None:
                m.info = info
                m.info_stale = False
                reported = info.get("name")
                if reported and reported != name:
                    # An HTTPSource starts out named host:port; the
                    # daemon's /info supplies the real member name —
                    # which must match clique-member lists for the
                    # f-budget attribution to line up.
                    renames.append((name, reported))
                    name = reported
            if ok:
                m.cursor = texp.get("cursor", m.cursor)
                self._ingest_spans(name, texp, m)
                shard = m.info.get("shard")
                self._ingest_slow(name, shard, texp.get("slow"))
                m.prev_counters = self._counter_deltas(
                    name, shard, m.prev_counters, snap
                )
                self._merge_slo(slo_counts, slo_sums, snap)
                self.capacity.observe(name, snap)
                m.status = "up"
                m.last_ok = time.time()
                m.last_err = ""
            else:
                m.status = "down"
                m.last_err = err
            m.scrape_s = elapsed
            if prev_status in ("up", "unknown") and m.status == "down":
                self._emit(
                    "member_down", name, m.info.get("shard"), m.last_err
                )
            elif prev_status == "down" and m.status == "up":
                # A restart may have come back with a different seat.
                m.info_stale = True
                self._emit("member_up", name, m.info.get("shard"), "")
        with self._lock:
            # Key mutation under the lock: /fleet handler threads read
            # the dict concurrently via _members_snapshot().
            for old, new in renames:
                if new not in self.members:
                    self.members[new] = self.members.pop(old)

        # Process-wide feeds (in-process clusters).
        if self.local_metrics is not None:
            snap = self.local_metrics.snapshot()
            self._local_prev = self._counter_deltas(
                "process", None, self._local_prev, snap
            )
            self._merge_slo(slo_counts, slo_sums, snap)
            self.capacity.observe("process", snap)
        if self.local_tracer is not None:
            texp = self.local_tracer.export(self._local_cursor)
            self._local_cursor = texp["cursor"]
            self._ingest_spans("process", texp)
            self._local_ring_dropped = texp.get("ring_dropped", 0)
            self._local_slow_dropped = texp.get("slow_dropped", 0)
            self._ingest_slow("process", None, self.local_tracer.slow())
        if self.fp_registry is not None:
            events = self.fp_registry.trace()
            if events and events[-1].seq < self._fp_seq:
                self._fp_seq = 0  # registry re-armed: sequence restarted
            for ev in events:
                if ev.seq <= self._fp_seq:
                    continue
                self._fp_seq = ev.seq
                target = ev.rule_id.split(":", 1)[1].split(":", 1)[0] \
                    if ":" in ev.rule_id else ""
                self._emit(
                    "fault",
                    target or "?",
                    self._shard_of_member(target),
                    f"{ev.point}:{ev.rule_id}:{ev.kind}",
                )

        # Region plane (DESIGN.md §21): a whole region going dark is a
        # different animal than f scattered members — judge it after
        # every member's probe verdict landed this scrape.
        self._region_check()

        # Diagnosis tier (DESIGN.md §18): attribute every trace whose
        # root has waited one full scrape, then judge the SLO burn rate
        # on this scrape's delta — both AFTER every feed was ingested.
        self._attribute_pass()
        self._slo_burn_check(slo_counts)
        # Capacity hysteresis (DESIGN.md §20): sustained per-resource
        # saturation becomes resource_saturated — same episode contract
        # as slo_burn, emitted through the feed so the flight recorder
        # snapshots capacity state with the bundle.
        for ev in self.capacity.check():
            self._emit(
                "resource_saturated",
                ev["member"],
                self._shard_of_member(ev["member"]),
                f"{ev['resource']} saturation {ev['saturation']:.2f} "
                f"(utilization {ev['utilization']:.2f})",
            )

        with self._lock:
            if slo_counts:
                self._slo = slo_counts
                self._slo_sums = slo_sums
            self._scrapes += 1
        return self.health()

    # -- health document ---------------------------------------------------

    def _members_snapshot(self) -> dict:
        """A consistent copy for reader threads — the scrape thread
        renames keys (host:port → daemon name) under the same lock."""
        with self._lock:
            return dict(self.members)

    def _shards(self, members: dict) -> dict:
        """Group members by shard seat; daemons that reported an /info
        WITHOUT a seat (unsharded storage nodes, degenerate graphs)
        fold into shard 0 so the fleet is fully accounted for.  A
        member that never answered /info at all is excluded here — its
        seat is UNKNOWN, and binning it anywhere would let the shard
        it really belongs to report a full f-budget while one of its
        clique members is dark (health() surfaces these as
        ``fleet.unseated`` instead).  Gateways (``role: gateway``) and
        the crypto sidecar (``role: sidecar``) are deliberately NOT
        shard members: neither holds a quorum seat, so they must never
        enter the clique f-budget math — they report under
        ``health()["gateways"]`` / ``health()["sidecars"]`` instead."""
        shards: dict = {}
        for name, m in members.items():
            if not m.info or m.info.get("role") in ("gateway", "sidecar"):
                continue
            sh = m.info.get("shard")
            sh = 0 if sh is None else sh
            shards.setdefault(sh, []).append((name, m))
        return shards

    def _gateways(self, members: dict, now: float) -> dict:
        """The edge tier's health rows: status + the gateway's own
        cache/shed stats as self-reported on /info."""
        out: dict = {}
        for name, m in members.items():
            if not m.info or m.info.get("role") != "gateway":
                continue
            out[name] = {
                "status": m.status,
                "scrape_s": round(m.scrape_s, 4),
                "last_ok_age_s": round(now - m.last_ok, 1)
                if m.last_ok
                else None,
                **(m.info.get("gateway") or {}),
            }
        return out

    @staticmethod
    def _region_groups(members: dict) -> dict:
        """Region label -> [(name, member)] over every member whose
        /info carried a ``region`` seat field.  Empty on loopback
        fleets (no region map installed) — the whole region plane then
        stays invisible, bit-for-bit pre-region behavior."""
        groups: dict = {}
        for name, m in members.items():
            r = (m.info or {}).get("region")
            if r is None:
                continue
            groups.setdefault(r, []).append((name, m))
        return groups

    def _region_check(self) -> None:
        """Emit ``region_down`` when EVERY member of a region fails its
        probe (``region_up`` on recovery).  The region plane has its own
        two-level budget (DESIGN.md §21): node-level, a region whose
        clique seats stay within each shard's ``f`` leaves writes alive;
        region-level, ``f_regions = (n_regions-1)//3`` whole-region
        losses are masked — which is 0 below four regions, so ANY
        whole-region outage drives the region budget negative and the
        anomaly names that arithmetic even while zero writes fail."""
        with self._lock:
            members = dict(self.members)
        groups = self._region_groups(members)
        if not groups:
            return
        f_regions = (len(groups) - 1) // 3
        for r, mem in sorted(groups.items()):
            dark = all(m.status == "down" for _n, m in mem)
            was = r in self._region_dark
            if dark and not was:
                self._region_dark.add(r)
                used = len(self._region_dark)
                self._emit(
                    "region_down", r, None,
                    f"all {len(mem)} members of region {r} dark; "
                    f"region f-budget {f_regions}-{used}="
                    f"{f_regions - used}",
                )
            elif was and not dark:
                self._region_dark.discard(r)
                self._emit(
                    "region_up", r, None,
                    f"{sum(1 for _n, m in mem if m.status == 'up')}"
                    f"/{len(mem)} members back",
                )

    def _regions(self, members: dict, now: float) -> dict:
        """The WAN plane's health rows (DESIGN.md §21): per-region
        member/up/down rollup plus the REGION-LEVEL f-budget —
        ``f_regions = (n_regions-1)//3`` whole-region outages masked,
        so three regions budget 0 and one dark region reads -1.
        Empty dict when no member carries a region seat."""
        groups = self._region_groups(members)
        if not groups:
            return {}
        f_regions = (len(groups) - 1) // 3
        dark = sorted(
            r for r, mem in groups.items()
            if all(m.status == "down" for _n, m in mem)
        )
        rows: dict = {}
        for r, mem in sorted(groups.items()):
            down = sorted(n for n, m in mem if m.status == "down")
            shards = sorted(
                {
                    m.info.get("shard")
                    for _n, m in mem
                    if m.info.get("shard") is not None
                },
                key=str,
            )
            rows[r] = {
                "members": len(mem),
                "up": len(mem) - len(down),
                "down": down,
                "dark": r in dark,
                "shards": shards,
                "gateways": sorted(
                    n for n, m in mem
                    if m.info.get("role") == "gateway"
                ),
            }
        return {
            "n": len(groups),
            "f_budget": {
                "f": f_regions,
                "used": len(dark),
                "remaining": f_regions - len(dark),
                "dark": dark,
            },
            "rows": rows,
        }

    def _sidecars(self, members: dict, now: float) -> dict:
        """The shared crypto service's health rows: status + the
        sidecar's own queue/occupancy/shed stats as self-reported on
        /info — a ``role=sidecar`` member is an optimizer, never a
        quorum seat, so it lives here instead of any f-budget."""
        out: dict = {}
        for name, m in members.items():
            if not m.info or m.info.get("role") != "sidecar":
                continue
            out[name] = {
                "status": m.status,
                "scrape_s": round(m.scrape_s, 4),
                "last_ok_age_s": round(now - m.last_ok, 1)
                if m.last_ok
                else None,
                **(m.info.get("sidecar") or {}),
            }
        return out

    def health(self) -> dict:
        shards_doc: dict = {}
        now = time.time()
        all_members = self._members_snapshot()
        budget_doc = self.budget.doc()
        with self._lock:
            slo = {k: list(v) for k, v in self._slo.items()}
            slo_sums = dict(self._slo_sums)
            exemplars = {k: list(v) for k, v in self._exemplars.items()}
            attr_pending = len(self._attr_pending)
            attr_dropped = self._attr_dropped
        for sh, members in sorted(
            self._shards(all_members).items(), key=lambda kv: str(kv[0])
        ):
            clique = next(
                (
                    m.info["clique"]
                    for _n, m in members
                    if m.info.get("clique")
                ),
                None,
            )
            cnames = set(clique["members"]) if clique else {
                n for n, _m in members
            }
            down = sorted(
                n for n, m in members if m.status == "down"
            )
            clique_down = [n for n in down if n in cnames]
            f = clique["f"] if clique else max((len(cnames) - 1) // 3, 0)
            doc = {
                "n": clique["n"] if clique else len(cnames),
                "f": f,
                "threshold": clique["threshold"] if clique else 2 * f + 1,
                "suff": clique["suff"] if clique else None,
                "members": [
                    {
                        "name": n,
                        "role": m.info.get("role")
                        or ("clique" if n in cnames else "storage"),
                        "status": m.status,
                        "scrape_s": round(m.scrape_s, 4),
                        "last_ok_age_s": round(now - m.last_ok, 1)
                        if m.last_ok
                        else None,
                        # Route-table epoch the member self-reports; a
                        # fleet mid-flip shows a mixed column here.
                        "epoch": m.info.get("epoch"),
                    }
                    for n, m in sorted(members)
                ],
                "f_budget": {
                    "f": f,
                    "used": len(clique_down),
                    "remaining": f - len(clique_down),
                    "down": clique_down,
                    "storage_down": [n for n in down if n not in cnames],
                },
            }
            slo_doc = {}
            for op in ("write", "read"):
                h = slo.get((sh, op))
                if h and sum(h):
                    slo_doc[op] = {
                        "count": sum(h),
                        "sum_s": round(slo_sums.get((sh, op), 0.0), 6),
                        "p50_le_s": histogram_quantile(0.5, h),
                        "p99_le_s": histogram_quantile(0.99, h),
                        "buckets": h,
                    }
            doc["slo"] = slo_doc
            doc["exemplars"] = exemplars.get(sh, [])
            # The phase budget of this shard's writes/reads: where the
            # wall clock went, exclusive per phase, p99 exemplar first.
            doc["budget"] = {
                op: budget_doc[op][sh]
                for op in ("write", "read")
                if sh in budget_doc.get(op, {})
            }
            shards_doc[str(sh)] = doc

        up = [n for n, m in all_members.items() if m.status == "up"]
        # Fleet-wide epoch spread: every member's self-reported
        # route-table epoch (None = never answered /info or pre-epoch
        # daemon).  min != max while a flip is propagating.
        epochs = sorted(
            {
                m.info.get("epoch")
                for m in all_members.values()
                if isinstance(m.info.get("epoch"), int)
            }
        )
        autopilot = None
        status_fn = self.autopilot_status
        if callable(status_fn):
            try:
                autopilot = status_fn()
            except Exception:
                autopilot = None
        with self._lock:
            anomalies = list(self._anomalies)[-200:]
            scrapes = self._scrapes
        return {
            "ts": now,
            "scrapes": scrapes,
            "interval_s": self.interval,
            "fleet": {
                "daemons": len(all_members),
                "up": len(up),
                "down": sorted(set(all_members) - set(up)),
                # Seat unknown (never answered /info): every f-budget
                # above is indeterminate while one of these is dark —
                # the CLI exit code treats that as unhealthy.
                "unseated": sorted(
                    n for n, m in all_members.items() if not m.info
                ),
                "route_epochs": {
                    "min": epochs[0] if epochs else None,
                    "max": epochs[-1] if epochs else None,
                    "skewed": len(epochs) > 1,
                },
                # Fleet-wide trace-ring overwrite totals: nonzero means
                # attribution/stitching under-sample — turn down traffic
                # per scrape or raise the ring.
                "trace_drops": {
                    "ring": self._local_ring_dropped + sum(
                        m.ring_dropped for m in all_members.values()
                    ),
                    "slow": self._local_slow_dropped + sum(
                        m.slow_dropped for m in all_members.values()
                    ),
                    "attr_pending": attr_pending,
                    "attr_dropped": attr_dropped,
                },
            },
            "autopilot": autopilot,
            # The full attribution document, op → shard → budget (the
            # per-shard copies above are views into this): where each
            # op's wall clock went, exclusive per phase (DESIGN.md §18).
            "write_budget_by_phase": budget_doc.get("write", {}),
            "read_budget_by_phase": budget_doc.get("read", {}),
            # Capacity plane (DESIGN.md §20): USE rows per member +
            # fleet fold + the bottleneck verdict, joined against the
            # write budget's phase shares above.
            "capacity": {
                **self.capacity.doc(),
                "verdict": self.capacity.verdict(
                    PhaseBudget.fleet_shares(budget_doc)
                ),
            },
            "shards": shards_doc,
            "regions": self._regions(all_members, now),
            "gateways": self._gateways(all_members, now),
            "sidecars": self._sidecars(all_members, now),
            "traces": {
                **self.stitcher.summary(),
                "recent": self.stitcher.traces(limit=10),
            },
            "anomalies": anomalies,
            "bucket_bounds": list(BUCKETS),
        }

    def prometheus(self) -> str:
        """The fleet document as Prometheus text — gauges with a
        ``shard`` label, counters for the anomaly feed.  Samples group
        by family with exactly ONE ``# TYPE`` line each (a repeated
        TYPE line for a name is a parse error in a real Prometheus
        server, which would reject the whole exposition on any
        multi-shard fleet)."""
        doc = self.health()
        order: list[str] = []  # family base names, first-seen order
        types: dict[str, str] = {}
        samples: dict[str, list[str]] = {}

        def add(family: str, typ: str, suffix: str, sample: str):
            base = "bftkv_fleet_" + family
            if base not in types:
                types[base] = typ
                order.append(base)
                samples[base] = []
            samples[base].append(base + suffix + " " + sample)

        add("daemons", "gauge", "", str(doc["fleet"]["daemons"]))
        add("daemons_up", "gauge", "", str(doc["fleet"]["up"]))
        add("scrapes", "gauge", "", str(doc["scrapes"]))
        repochs = doc["fleet"].get("route_epochs") or {}
        if isinstance(repochs.get("max"), int):
            add("route_epoch", "gauge", "", str(repochs["max"]))
            add("route_epoch_skewed", "gauge", "",
                "1" if repochs.get("skewed") else "0")
        gws = doc.get("gateways") or {}
        if gws:
            add("gateways", "gauge", "", str(len(gws)))
            add("gateways_up", "gauge", "",
                str(sum(1 for g in gws.values() if g["status"] == "up")))
            for name, g in sorted(gws.items()):
                lab = f'{{gateway="{name}"}}'
                for field in ("hits", "misses", "shed", "verify_fail"):
                    if isinstance(g.get(field), (int, float)):
                        add(f"gateway_{field}", "gauge", lab,
                            str(g[field]))
        regs = doc.get("regions") or {}
        if regs:
            add("regions", "gauge", "", str(regs["n"]))
            add("region_budget_remaining", "gauge", "",
                str(regs["f_budget"]["remaining"]))
            for rname, row in sorted(regs["rows"].items()):
                lab = f'{{region="{rname}"}}'
                add("region_members", "gauge", lab, str(row["members"]))
                add("region_members_up", "gauge", lab, str(row["up"]))
        scs = doc.get("sidecars") or {}
        if scs:
            add("sidecars_up", "gauge", "",
                str(sum(1 for s in scs.values() if s["status"] == "up")))
            for name, s in sorted(scs.items()):
                lab = f'{{sidecar="{name}"}}'
                q = s.get("queue") or {}
                for field in ("inflight", "waiting", "shed"):
                    if isinstance(q.get(field), (int, float)):
                        add(f"sidecar_{field}", "gauge", lab,
                            str(q[field]))
        # Capacity plane: ONE gauge family per USE axis, labeled
        # (member, resource) — resource names are the closed
        # capacity.RESOURCES enum, so cardinality is members x |enum|.
        cap = doc.get("capacity") or {}
        for member, rows in sorted((cap.get("members") or {}).items()):
            for res, row in sorted(rows.items()):
                lab = f'{{member="{member}",resource="{res}"}}'
                for field in ("utilization", "saturation", "errors"):
                    add(f"resource_{field}", "gauge", lab,
                        str(row.get(field, 0)))
        top = (cap.get("verdict") or {}).get("top")
        if top:
            add("resource_verdict_score", "gauge",
                f'{{member="{top["member"]}",resource="{top["resource"]}"}}',
                str(top["score"]))
        add("traces_stitched", "gauge", "",
            str(doc["traces"]["stitched"]))
        drops = doc["fleet"].get("trace_drops") or {}
        add("trace_ring_dropped", "gauge", "", str(drops.get("ring", 0)))
        add("trace_slow_dropped", "gauge", "", str(drops.get("slow", 0)))
        add("anomalies_total", "counter", "", str(self._anomaly_seq))
        for sh, sd in sorted(doc["shards"].items()):
            lab = f'{{shard="{sh}"}}'
            for field in ("n", "f", "threshold"):
                if sd[field] is not None:
                    add(f"shard_{field}", "gauge", lab, str(sd[field]))
            fb = sd["f_budget"]
            add("f_budget_remaining", "gauge", lab, str(fb["remaining"]))
            add("members_down", "gauge", lab,
                str(len(fb["down"]) + len(fb["storage_down"])))
            for op, s in sd["slo"].items():
                fam = f"{op}_latency"
                acc = 0
                for i, c in enumerate(s["buckets"]):
                    acc += c
                    le = BUCKETS[i] if i < len(BUCKETS) else "+Inf"
                    add(fam, "histogram",
                        f'_bucket{{shard="{sh}",le="{le}"}}', str(acc))
                add(fam, "histogram", "_sum" + lab, str(s["sum_s"]))
                add(fam, "histogram", "_count" + lab, str(s["count"]))
        # Critical-path attribution: ONE histogram family labeled by
        # (shard, op, phase) — ``bftkv_fleet_phase_seconds`` is the
        # per-phase exclusive-time distribution (DESIGN.md §18).
        # Emitted from the top-level attribution doc, so a budget
        # survives even when no member's /info seated its shard.
        for op in ("write", "read"):
            for sh, b in sorted(
                doc.get(f"{op}_budget_by_phase", {}).items(),
                key=lambda kv: str(kv[0]),
            ):
                for phase, pd in sorted(b.get("phases", {}).items()):
                    plab = f'shard="{sh}",op="{op}",phase="{phase}"'
                    acc = 0
                    for i, c in enumerate(pd["buckets"]):
                        acc += c
                        le = BUCKETS[i] if i < len(BUCKETS) else "+Inf"
                        add("phase_seconds", "histogram",
                            f'_bucket{{{plab},le="{le}"}}', str(acc))
                    add("phase_seconds", "histogram",
                        "_sum{" + plab + "}", str(pd["sum_s"]))
                    add("phase_seconds", "histogram",
                        "_count{" + plab + "}", str(b["count"]))

        lines: list[str] = []
        for base in order:
            lines.append(f"# TYPE {base} {types[base]}")
            lines.extend(samples[base])
        return "\n".join(lines) + "\n"

    # -- background loop ---------------------------------------------------

    def start(self, interval: float | None = None) -> "FleetCollector":
        if interval is not None:
            self.interval = interval
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.scrape_once()
                except Exception:  # scraping must never die
                    pass
                self._stop.wait(self.interval)

        self._thread = threading.Thread(
            target=loop, name="fleet-collector", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5)
            self._thread = None
