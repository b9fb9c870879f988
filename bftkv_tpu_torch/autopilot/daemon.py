"""The topology autopilot: detect → decide → execute, live (counterpart of
``bftkv_tpu/autopilot/daemon.py``).

One :class:`Autopilot` closes the loop between the fleet health plane
(detect: f-budgets, SLO histograms, anomaly feed) and the react
primitives (repair, hedging, health ranking): it watches a fleet's
health and route load,
decides (``plan.decide``) and executes topology changes while traffic
runs.  Every phase rides the background anti-entropy / repair planes —
the write's one-round critical path never waits on reconfiguration.

A migration executes in three phases (DESIGN.md §15):

1. **pre-copy** — the epoch-N+1 table (dual window open) installs on
   the NEW owners first; their sync daemons pull the moving buckets
   from the old owners (``dual_pull_shards`` widens their poll set)
   until residual divergence is at or below the watermark.  For a
   retirement, every certified record must additionally be READABLE
   from its new owner before the flip (``verify_handoff``) — the old
   clique keeps being routed to until that holds.
2. **flip** — the same table distributes fleet-wide.  Both owners
   accept the moving buckets (dual window): the new owner is the
   single serializer for NEW versions, the old owner keeps serving and
   certifying versions it already stored, and stale-routed clients
   re-route in-round off hinted declines.
3. **drain** — anti-entropy converges the window, the repair plane
   certifies residue, the new owners re-certify migrated records
   against their own cliques (``SyncDaemon.recertify_buckets``), and
   the epoch-N+2 finalize table (dual closed) goes out.  The old
   owner's copies are now inert: served if asked, never routed to,
   never synced by anyone who doesn't own them.

``BFTKV_AUTOPILOT=off`` disables decisions; the executor stays callable
for operator-forced migrations.

The autopilot takes no device and adds no CPU path of its own: it acts
on servers and clients that were built on one (``device=`` of
``build_cluster``/``make_node``), whose sync daemons' admission and
re-certification verify and sign there.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.autopilot.plan import HOT_SKEW, MIN_LOAD, Plan, decide
from bftkv_tpu_torch.devtools.lockwatch import named_lock
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.quorum.wotqs import ROUTE_BUCKETS, RouteTable, route_bucket

__all__ = ["Autopilot", "autopilot_enabled"]

log = logging.getLogger("bftkv_tpu_torch.autopilot")


def autopilot_enabled() -> bool:
    """``BFTKV_AUTOPILOT`` — automatic topology decisions (default
    on).  Off disables DECIDING only; forced executes stay available."""
    return flags.raw("BFTKV_AUTOPILOT", "on").lower() not in (
        "off", "0", "false",
    )


class Autopilot:
    """In-process autopilot over a cluster of ``Server`` objects (and
    the clients that route to them).

    ``members``: every replica whose quorum system receives route
    tables; ``clients``: client objects (their quorum systems route
    writes, so they get tables too — and their ``bucket_load`` is the
    hot-bucket signal).  ``collector``: a FleetCollector for f-budget
    input; optional — load-only autopilots (benches) run without one.
    ``signer``: optional ``(private_key, certificate)`` pair; when set,
    every distributed table is signed and installs verify it."""

    #: Sync rounds per convergence attempt before giving up on the
    #: watermark (the dual window + drain close the remainder).
    MAX_SYNC_ROUNDS = 12

    def __init__(
        self,
        members: list,
        clients: list | None = None,
        *,
        collector=None,
        signer: tuple | None = None,
        watermark: int = 0,
        hot_skew: float = HOT_SKEW,
        min_load: int = MIN_LOAD,
        rng: random.Random | None = None,
    ):
        self._members = list(members)
        #: Optional provider of the CURRENT member list — the chaos
        #: harness replaces Server objects on crash-restart, and tables
        #: must reach the live instance, not a dead one's quorum system.
        self._members_provider = None
        self.clients = list(clients or [])
        #: The newest table this autopilot distributed — re-delivered
        #: to rejoining members by :meth:`reconcile`.
        self._current: RouteTable | None = None
        self.collector = collector
        self.signer = signer
        self.watermark = watermark
        self.hot_skew = hot_skew
        self.min_load = min_load
        self._rng = rng or random.Random(0)
        #: Principal names whose table delivery is suppressed — the
        #: nemesis route_flap fault window.
        self.suppressed: set[str] = set()
        self.last_decision: dict = {"kind": None}
        self.history: list[dict] = []
        self._retired: set[int] = set()
        self._lock = named_lock("autopilot")
        self._epoch_hwm = 0  # see alloc_epoch
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        if collector is not None:
            # The fleet document reports the autopilot's last decision
            # next to the budgets it decided from.
            collector.autopilot_status = self.status

    @property
    def members(self) -> list:
        if self._members_provider is not None:
            return list(self._members_provider())
        return self._members

    @classmethod
    def for_cluster(cls, cluster, collector=None, **kw) -> "Autopilot":
        """Wire an autopilot over a ChaosCluster / test Cluster: every
        server (both planes) gets tables; every client routes + feeds
        load.  Members resolve through the cluster LIVE, so a
        crash-restarted replica's fresh Server still receives tables."""
        ap = cls(
            [],
            list(cluster.clients),
            collector=collector,
            **kw,
        )
        ap._members_provider = lambda: list(cluster.all_servers)
        return ap

    # -- identity helpers --------------------------------------------------

    def _name_of(self, principal) -> str:
        node = getattr(principal, "self_node", None) or getattr(
            principal, "graph", None
        )
        return getattr(node, "name", "?") if node is not None else "?"

    def _qs_of(self, principal):
        return principal.qs

    def _servers_of_shard(self, idx: int) -> list:
        out = []
        for srv in self.members:
            qs = self._qs_of(srv)
            idx_of = getattr(qs, "shard_index_of", None)
            if idx_of is None:
                continue
            if idx_of(srv.self_node.get_self_id()) == idx:
                out.append(srv)
        return out

    def _reference_qs(self):
        for p in self.clients + self.members:
            qs = self._qs_of(p)
            if getattr(qs, "shard_count", lambda: 1)() > 1:
                return qs
        return None

    # -- distribution ------------------------------------------------------

    def _signed(self, rt: RouteTable) -> RouteTable:
        if self.signer is not None:
            key, cert = self.signer
            rt.sign(key, cert)
        return rt

    def distribute(
        self, rt: RouteTable, targets: list | None = None
    ) -> int:
        """Install ``rt`` on every (non-suppressed) target's quorum
        system; returns the number of accepting installs.  Tables are
        objects here (one process); a daemon fleet ships the same
        serialized+signed bytes — the install path verifies them
        identically."""
        installed = 0
        for p in targets if targets is not None else (
            self.members + self.clients
        ):
            if self._name_of(p) in self.suppressed:
                continue
            qs = self._qs_of(p)
            fn = getattr(qs, "install_route_table", None)
            if fn is None:
                continue
            keyring = (
                p.crypt.keyring if self.signer is not None else None
            )
            if fn(rt, keyring):
                installed += 1
        return installed

    def _base_route(self, qs) -> list[int]:
        """The bucket→shard-index base the NEXT table builds on: the
        newest table THIS autopilot issued (resolved against the
        current clique set), falling back to the reference quorum
        system's effective route.  Building on ``_current`` rather
        than on some member's installed view LINEARIZES table content:
        a route_flap window racing a migration's flip can no longer
        erase the flip's moves by building from a stale base — every
        issued table contains every earlier table's moves."""
        effective = qs.effective_route()
        cur = self._current
        if cur is None:
            return list(effective)
        cliques = qs.route_cliques()
        cid_to_idx = {c: i for i, c in enumerate(cliques)}
        owner = []
        for b in range(ROUTE_BUCKETS):
            idx = cid_to_idx.get(cur.cliques[cur.table[b]])
            owner.append(idx if idx is not None else effective[b])
        return owner

    def issue_table(
        self,
        assign: dict[int, int],
        *,
        dual: bool,
        retiring: set[int] | None = None,
        stage: bool = False,
    ) -> RouteTable:
        """Mint the next route table under ONE lock: epoch allocation
        and content derivation are atomic, so concurrent issuers (a
        migration in flight while a route_flap window ships its own
        table) produce distinct epochs whose contents CHAIN — the
        highest epoch supersedes the rest without losing their moves.
        ``dual=True`` opens the dual-epoch window for every bucket
        ``assign`` actually moves; ``dual=False`` closes every window
        (the finalize / abrupt-flap shape).

        ``stage=True`` mints a PRE-COPY table that stays OUT of the
        chain: it goes to the new owners only, and a concurrent issuer
        must not build on moves whose copy has not converged (that
        leak — a flap table inheriting an unfinished flip's moves and
        shipping them fleet-wide — is exactly how history goes
        unreadable).  The real flip re-issues at a fresh epoch."""
        qs = self._reference_qs()
        with self._lock:
            self._epoch_hwm = (
                max(self._epoch_hwm, qs.route_epoch() if qs else 0) + 1
            )
            epoch = self._epoch_hwm
            table = self._base_route(qs)
            cliques = qs.route_cliques()
            dual_map: dict[int, int] = {}
            for b, dest in assign.items():
                if table[b] != dest:
                    if dual:
                        dual_map[b] = table[b]
                    table[b] = dest
            rt = RouteTable(
                epoch, cliques, table, dual_map, retiring or set()
            )
            if not stage:
                self._current = rt
        return self._signed(rt)

    def reconcile(self) -> int:
        """Re-deliver the newest table to every member/client — how a
        crash-restarted replica (fresh quorum system, epoch 0) rejoins
        the current epoch instead of resurrecting HRW routing for
        buckets that migrated away.  Idempotent everywhere else."""
        if self._current is None:
            return 0
        return self.distribute(self._current)

    # -- detect + decide ---------------------------------------------------

    def _f_remaining(self) -> dict[int, int]:
        """Per-shard f-budget remaining, from the collector's health
        document (the same wotqs math the fleet plane reports)."""
        if self.collector is None:
            return {}
        doc = self.collector.health()
        out: dict[int, int] = {}
        for sh, sd in doc.get("shards", {}).items():
            try:
                out[int(sh)] = sd["f_budget"]["remaining"]
            except (KeyError, TypeError, ValueError):
                continue
        return out

    def _bucket_load(self) -> list[int]:
        """Client-side routed-ops per bucket, summed across clients —
        the hot-bucket signal (servers' own selections would double
        count the same traffic)."""
        load = [0] * ROUTE_BUCKETS
        for c in self.clients:
            get = getattr(self._qs_of(c), "bucket_load", None)
            if get is None:
                continue
            for b, n in enumerate(get()):
                load[b] += n
        return load

    def decide(self) -> Plan | None:
        if not autopilot_enabled():
            return None
        qs = self._reference_qs()
        if qs is None:
            return None
        owner_of = qs.effective_route()
        if not owner_of:
            return None
        plan = decide(
            self._f_remaining(),
            self._bucket_load(),
            owner_of,
            qs.shard_count(),
            hot_skew=self.hot_skew,
            min_load=self.min_load,
            retiring=set(self._retired),
        )
        return plan

    # -- execute -----------------------------------------------------------

    def _sync_daemons(self, servers: list) -> list:
        from bftkv_tpu_torch.sync import SyncDaemon

        return [
            SyncDaemon(
                s, interval=999, rng=random.Random(self._rng.random())
            )
            for s in servers
        ]

    def _bucket_hashes(self, servers: list) -> list[dict]:
        out = []
        for s in servers:
            try:
                out.append(s._sync_tree().buckets())
            except Exception:
                out.append({})
        return out

    def _residual(
        self, moving: set[int], old_servers: list, new_servers: list
    ) -> int:
        """Moving buckets where no new owner matches any old owner's
        digest — the pre-copy divergence measure.  (Live traffic can
        keep a bucket nominally divergent forever; the watermark and
        the dual window absorb that tail.)"""
        olds = self._bucket_hashes(old_servers)
        news = self._bucket_hashes(new_servers)
        residual = 0
        for b in moving:
            have = {h.get(b) for h in olds if h.get(b) is not None}
            if not have:
                continue  # nothing stored: nothing to copy
            if not any(h.get(b) in have for h in news):
                residual += 1
        return residual

    def _converge(
        self, moving: set[int], old_servers: list, new_servers: list
    ) -> int:
        daemons = self._sync_daemons(new_servers)
        residual = len(moving)
        for _ in range(self.MAX_SYNC_ROUNDS):
            residual = self._residual(moving, old_servers, new_servers)
            if residual <= self.watermark:
                return residual
            for d in daemons:
                try:
                    d.run_round()
                except Exception:
                    log.exception("autopilot: pre-copy sync round failed")
        return self._residual(moving, old_servers, new_servers)

    def _snapshot_precopy(
        self, moving: set[int], old_servers: list, new_servers: list
    ) -> int:
        """Sealed-segment bulk ship (DESIGN.md §19.5): when an old
        owner's storage exposes ``snapshot_records``, stream its live
        records for the moving buckets straight into the new owners'
        admission path before any digest-round sync runs.  Sequential
        segment reads on the sender, the FULL admission path on the
        receiver (``admit_records`` parses, verifies, and gates every
        record — a snapshot is a transport optimization, never a trust
        shortcut).  Returns records shipped; 0 means the memory-backed
        fallback (sync rounds) does all the copying."""
        from bftkv_tpu_torch.sync.daemon import MAX_PULL_RECORDS
        from bftkv_tpu_torch.sync.digest import HIDDEN_PREFIX

        def pred(variable: bytes) -> bool:
            if variable.startswith(HIDDEN_PREFIX):
                return False
            return route_bucket(variable) in moving

        shipped = 0
        for old in old_servers:
            snap = getattr(old.storage, "snapshot_records", None)
            if snap is None:
                continue
            chunk: list[bytes] = []
            try:
                for _variable, _t, value in snap(pred):
                    chunk.append(value)
                    if len(chunk) >= MAX_PULL_RECORDS:
                        shipped += self._ship_chunk(chunk, new_servers)
                        chunk = []
                if chunk:
                    shipped += self._ship_chunk(chunk, new_servers)
            except Exception:
                # Snapshot source failed mid-stream (compaction race,
                # I/O fault): the digest-round sync below copies
                # whatever didn't ship — correctness never depends on
                # the fast path.
                log.exception("autopilot: snapshot pre-copy failed")
        if shipped:
            metrics.incr("autopilot.snapshot_shipped", shipped)
        return shipped

    @staticmethod
    def _ship_chunk(chunk: list[bytes], new_servers: list) -> int:
        from bftkv_tpu_torch.sync.daemon import admit_records

        admitted = 0
        for new in new_servers:
            try:
                got = admit_records(new, chunk)
                admitted += got.get("admitted", 0)
            except Exception:
                log.exception("autopilot: snapshot admit failed")
        return admitted

    def verify_handoff(
        self,
        moving: set[int],
        old_servers: list,
        new_servers: list,
        strict: bool = True,
    ) -> list[str]:
        """The recorded-history check retirement gates on: every
        certified record an old-owner replica holds in a moving bucket
        must be READABLE (present, certified, at the same-or-newer
        timestamp) on at least one new owner.  Returns human-readable
        misses (empty = safe to stop routing to the old clique).

        ``strict=False`` (the SPLIT gate) requires existence of SOME
        certified version at the new owner rather than the newest: a
        saturating writer advances ``t`` continuously, so "caught up to
        this instant" is unreachable without pausing writes — which
        the critical path never does.  The dual-epoch window closes
        the remaining version gap via anti-entropy after the flip;
        retirement keeps the strict form (the old clique must owe
        NOTHING before it stops being routed to)."""
        from bftkv_tpu_torch.sync.digest import HIDDEN_PREFIX, latest_completed

        misses: list[str] = []
        # Highest certified t per variable across EVERY old owner — a
        # pending-only copy on one replica must not mask the certified
        # copy on another (the write plane certifies before the sign
        # plane's residue is repaired, so the split is the common case).
        owed: dict[bytes, int] = {}
        for old in old_servers:
            # The digest tree's bucket index serves exactly the moving
            # variables — O(moving), not O(keyspace).  Fall back to the
            # full key listing only when the tree is unavailable.
            try:
                tree = old._sync_tree()
                keys = sorted(
                    v for b in moving for v in tree.bucket_variables(b)
                )
            except Exception:
                try:
                    keys = sorted(old.storage.keys())
                except Exception:
                    continue
            for variable in keys:
                if variable.startswith(HIDDEN_PREFIX):
                    continue
                if route_bucket(variable) not in moving:
                    continue
                rec = latest_completed(old.storage, variable)
                if rec is None:
                    continue  # nothing certified here: nothing owed
                if rec[0] > owed.get(variable, -1):
                    owed[variable] = rec[0]
        for variable, t_old in sorted(owed.items()):
            ok = False
            for new in new_servers:
                got = latest_completed(new.storage, variable)
                if got is not None and (not strict or got[0] >= t_old):
                    ok = True
                    break
            if not ok:
                misses.append(
                    f"{variable!r} certified at t={t_old} on the old "
                    "owners not readable from any new owner"
                )
        return misses

    def execute(self, plan: Plan, *, pace: float = 0.0) -> dict:
        """Run one plan through pre-copy → flip → drain.  ``pace``
        sleeps between phases (the chaos soak uses it to land faults
        INSIDE an in-flight migration).  Returns the phase report that
        also becomes ``last_decision``."""
        t0 = time.monotonic()
        moving = set(plan.assign)
        targets = sorted(set(plan.assign.values()))
        old_servers = self._servers_of_shard(plan.shard)
        new_servers = [
            s for idx in targets for s in self._servers_of_shard(idx)
        ]
        report: dict = {
            "kind": plan.kind,
            "shard": plan.shard,
            "targets": targets,
            "buckets": len(moving),
            "reason": plan.reason,
            "ok": False,
        }
        with self._lock:
            self.last_decision = report
            self.history.append(report)
        metrics.incr("autopilot.plans", labels={"kind": plan.kind})

        retiring = (
            {plan.shard} | self._retired
            if plan.kind == "retire"
            else set(self._retired)
        )

        # Phase 1 — pre-copy: a STAGED table (outside the issuance
        # chain) goes to the new owners only; the dual window makes
        # the moving buckets theirs to pull, and anti-entropy runs
        # until every certified record is readable from a new owner
        # (hash residual is reported, the handoff check is the gate —
        # exact digest equality is unreachable under live traffic).
        rt_stage = self.issue_table(
            plan.assign, dual=True, retiring=retiring, stage=True
        )
        strict = plan.kind == "retire"
        t_pre = time.monotonic()
        self.distribute(rt_stage, targets=new_servers)
        # §19.5 fast path first: bulk-ship sealed-segment snapshots of
        # the moving buckets through full admission, then let the
        # digest rounds close whatever the snapshot missed (records
        # appended after the seal, memory-backed old owners).
        report["snapshot_shipped"] = self._snapshot_precopy(
            moving, old_servers, new_servers
        )
        residual = self._converge(moving, old_servers, new_servers)
        misses = self.verify_handoff(
            moving, old_servers, new_servers, strict=strict
        )
        if misses:
            self._converge(moving, old_servers, new_servers)
            misses = self.verify_handoff(
                moving, old_servers, new_servers, strict=strict
            )
        report["precopy_s"] = round(time.monotonic() - t_pre, 3)
        report["residual"] = residual
        if misses:
            # The flip never outruns the copy: moving a populated
            # bucket before its certified history is readable from the
            # new owner would strand that history (readers route to
            # the new owner) — and a retiring clique must stay routed
            # to until it owes nothing.  Abort WITHOUT flipping and
            # rescind: a fresh no-move fleet table supersedes the
            # staged one everywhere, so the fleet lands back on one
            # consistent view and a later pass retries the plan.
            report["handoff_misses"] = misses[:20]
            report["aborted"] = "precopy_blocked"
            rescind = self.issue_table(
                {}, dual=False, retiring=set(self._retired)
            )
            self.distribute(rescind)
            report["rescind_epoch"] = rescind.epoch
            metrics.incr("autopilot.precopy_blocked")
            log.warning(
                "autopilot: %s of shard %d aborted: %d record(s) not "
                "yet readable from new owners",
                plan.kind, plan.shard, len(misses),
            )
            return report
        if pace:
            time.sleep(pace)

        # Phase 2 — flip: a FRESH epoch (chained on the fleet-wide
        # base, so concurrently issued tables keep their moves) goes
        # fleet-wide; stale clients re-route off hinted declines; both
        # owners hold the dual window.
        t_flip = time.monotonic()
        rt_flip = self.issue_table(
            plan.assign, dual=True, retiring=retiring
        )
        self.distribute(rt_flip)
        report["flip_s"] = round(time.monotonic() - t_flip, 3)
        report["epoch"] = rt_flip.epoch
        if pace:
            time.sleep(pace)

        # Phase 3 — drain: converge the window, certify residue,
        # re-certify migrated history against the new cliques, close.
        t_drain = time.monotonic()
        self._converge(moving, old_servers, new_servers)
        recert_failed = 0
        for attempt in range(3):
            recert_failed = 0
            for d in self._sync_daemons(new_servers):
                try:
                    got = d.recertify_buckets(moving)
                    recert_failed += got["failed"]
                except Exception:
                    recert_failed += 1
                    log.exception("autopilot: drain recertify failed")
            if recert_failed == 0:
                break
            # A fault window can make a recertify SIGN round time out;
            # the records stay readable through the dual window, so
            # retry rather than strand them.
            time.sleep(max(pace, 0.2))
        if plan.kind == "retire":
            # Forced residue repair ONLY when the old clique is going
            # away — its pending residue must certify-or-demote before
            # nobody routes to it.  A split's in-flight tails belong to
            # live writers; force-repairing them mid-write would demote
            # healthy residue the async tail is about to certify.
            for d in self._sync_daemons(old_servers):
                try:
                    d.repair_once()
                except Exception:
                    log.exception(
                        "autopilot: old-owner drain repair failed"
                    )
        if recert_failed:
            # Never close a window on un-recertified history: an
            # old-signature record would become inadmissible (alt
            # quorums empty) and its bucket permanently divergent.
            # The fleet stays consistently on the flip table — reads,
            # writes, and sync all work; a later pass closes it.
            report["drain_s"] = round(time.monotonic() - t_drain, 3)
            report["window_open"] = recert_failed
            report["elapsed_s"] = round(time.monotonic() - t0, 3)
            report["ok"] = True
            metrics.incr("autopilot.window_left_open")
            log.warning(
                "autopilot: %s done but dual window left open "
                "(%d record(s) not yet re-certified)",
                plan.kind, recert_failed,
            )
            if plan.kind == "retire":
                self._retired.add(plan.shard)
            return report
        # The finalize table chains on the flip (issue_table builds on
        # ``_current``), so re-applying ``assign`` is a no-op — what
        # changes is the dual map emptying: the window closes.
        rt_final = self.issue_table(
            plan.assign, dual=False, retiring=retiring
        )
        self.distribute(rt_final)
        report["drain_s"] = round(time.monotonic() - t_drain, 3)
        report["final_epoch"] = rt_final.epoch
        report["elapsed_s"] = round(time.monotonic() - t0, 3)
        report["ok"] = True
        if plan.kind == "retire":
            self._retired.add(plan.shard)
        metrics.incr("autopilot.migrations", labels={"kind": plan.kind})
        log.info("autopilot: %s done: %s", plan.kind, report)
        return report

    # -- spare admission ---------------------------------------------------

    def admit_spares(self, certs: list) -> int:
        """Admit quorum-certified spare replicas into every member's
        trust graph + keyring.  The graph mutation bumps
        ``graph.generation``, so every quorum/topology memo rebuilds —
        the existing guards do the invalidation work (DESIGN.md §10.3).
        Returns how many members accepted."""
        from bftkv_tpu_torch.crypto import cert as certmod

        payload = certmod.serialize_many(certs)
        accepted = 0
        for p in self.members + self.clients:
            try:
                fresh = certmod.parse(payload)  # private copies per view
                p.self_node.add_peers(fresh)
                p.crypt.keyring.register(fresh)
                accepted += 1
            except Exception:
                log.exception(
                    "autopilot: admit failed at %s", self._name_of(p)
                )
        metrics.incr("autopilot.admitted", len(certs))
        return accepted

    # -- loop --------------------------------------------------------------

    def step(self, *, pace: float = 0.0) -> dict | None:
        """One detect→decide→execute pass (scrapes the collector when
        present).  Returns the migration report, or None when the
        topology needs nothing."""
        self.reconcile()  # rejoining members pick the current epoch up
        if self.collector is not None:
            try:
                self.collector.scrape_once()
            except Exception:
                pass
        plan = self.decide()
        if plan is None:
            return None
        return self.execute(plan, pace=pace)

    def force_split(self, shard: int | None = None, *, pace: float = 0.0) -> dict:
        """Operator/chaos hook: split ``shard`` (default: the busiest)
        in half by observed load, watermark rules intact."""
        qs = self._reference_qs()
        owner_of = qs.effective_route()
        load = self._bucket_load()
        nsh = qs.shard_count()
        if shard is None:
            shard = max(
                range(nsh),
                key=lambda i: sum(
                    load[b]
                    for b in range(ROUTE_BUCKETS)
                    if owner_of[b] == i
                ),
            )
        target = min(
            (i for i in range(nsh) if i != shard),
            key=lambda i: sum(
                load[b] for b in range(ROUTE_BUCKETS) if owner_of[b] == i
            ),
        )
        mine = sorted(
            (b for b in range(ROUTE_BUCKETS) if owner_of[b] == shard),
            key=lambda b: (-load[b], b),
        )
        assign = {b: target for b in mine[: max(1, len(mine) // 2)]}
        return self.execute(
            Plan("split", shard, assign, reason="forced split"),
            pace=pace,
        )

    def status(self) -> dict:
        qs = self._reference_qs()
        with self._lock:
            last = dict(self.last_decision)
        return {
            "enabled": autopilot_enabled(),
            "epoch": qs.route_epoch() if qs is not None else 0,
            "retired": sorted(self._retired),
            "last": last,
            "migrations": len(
                [h for h in self.history if h.get("ok")]
            ),
        }

    def start(self, interval: float = 2.0) -> "Autopilot":
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                try:
                    self.step()
                except Exception:
                    log.exception("autopilot step failed")
                self._stop.wait(interval)

        self._thread = threading.Thread(
            target=loop, name="bftkv-autopilot", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10)
            self._thread = None
