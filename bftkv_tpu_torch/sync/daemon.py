"""Anti-entropy daemon: background replica convergence without trust
(counterpart of ``bftkv_tpu/sync/daemon.py``).

A restarted, rejoined, or lagging replica converges by pulling from its
peers instead of waiting for a client to read the exact keys it missed
(the reference's only repair plane, protocol/client.go:281-302 — which
silently erodes the ``3f+1`` margin for any key nobody re-reads).

Each (jitter-scheduled) round:

1. ``SYNC_DIGEST`` to the peer set — a digest is ≤ 8 KB, so polling is
   the cheap half — and compare each peer's bucket hashes against the
   local :class:`~bftkv_tpu_torch.sync.digest.DigestTree`;
2. ``SYNC_PULL`` the divergent buckets from up to ``f+1`` *distinct*
   divergent peers: with at most ``f`` Byzantine replicas, at least one
   pulled peer is honest, which is all liveness needs — safety needs
   none;
3. feed every pulled record through :func:`admit_records` — the FULL
   local admission path.

Admission re-runs exactly what the write handler runs: collective-
signature sufficiency against the local AUTH quorum and keyring (all
pulled signatures verify as ONE device batch through the installed
``ops.dispatch`` verify dispatcher via ``collective.verify_many``),
then timestamp monotonicity / equivocation / TOFU via the server's
``_write_storage_checks``.  A Byzantine peer can therefore waste
bandwidth but can never poison state: forged, replayed, cert-stripped,
or re-keyed records all die in admission with ``sync.rejected``
incremented and local state untouched.

Metrics: ``sync.rounds``, ``sync.pull.records`` (admitted),
``sync.rejected``, ``sync.pull.stale`` (honest-but-old), and
``sync.pull.verify_batch`` (device batch size per pull).
"""

from __future__ import annotations

import logging
import random
import threading
import time

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch import trace
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.sync.digest import HIDDEN_PREFIX, latest_completed
from bftkv_tpu_torch import flags

__all__ = ["SyncDaemon", "admit_records", "repair_enabled"]

log = logging.getLogger("bftkv_tpu_torch.sync")


def repair_enabled() -> bool:
    """``BFTKV_REPAIR`` — the pending-residue repair plane (default
    on).  ``BFTKV_REPAIR_AFTER`` sets the grace window in seconds."""
    return flags.raw("BFTKV_REPAIR", "on").lower() not in (
        "off", "0", "false",
    )

#: Upper bounds on one pull response: record count AND total bytes.
#: The transport has already buffered the body by the time these apply
#: (that bound is transport-wide), so what they cap is the parse +
#: admission amplification a hostile peer can force per round.
MAX_PULL_RECORDS = 8192
#: Strictly above the worst case a conforming server can send (its
#: 32 MiB budget may be overshot by one ≤32 MiB record plus list
#: framing) — only a NON-conforming peer trips this, where discarding
#: is correct and cannot livelock convergence.
MAX_PULL_BYTES = 80 << 20


def admit_records(server, records: list[bytes]) -> dict:
    """Run pulled records through the full local admission path.

    Returns counters: ``admitted`` / ``rejected`` / ``stale``.  Never
    raises on record content — a hostile record is a counter bump, not
    a daemon crash.
    """
    stats = {"admitted": 0, "rejected": 0, "stale": 0}
    parsed: list[tuple[bytes, object, bytes] | None] = []
    jobs: list[tuple[bytes, object]] = []
    owns = getattr(server.qs, "owns", None)
    for raw in records[:MAX_PULL_RECORDS]:
        try:
            p = pkt.parse(raw)
            variable = p.variable or b""
            if variable.startswith(HIDDEN_PREFIX):
                raise ValueError("hidden variable")
            if owns is not None and not owns(variable):
                # Sharded namespace: records of foreign shards never
                # enter local state (the same gate the write handler
                # applies) — a peer cannot use the sync plane to park
                # another shard's history here.
                raise ValueError("wrong shard")
            if p.sig is None or p.ss is None or not p.ss.completed:
                raise ValueError("not a completed record")
            if p.auth is not None:
                # TPA-protected state never rides the sync plane
                # (sync/digest.py latest_completed explains why).
                raise ValueError("protected record")
            local = latest_completed(server.storage, variable)
            if local is not None:
                lt, _lraw, lp = local
                if lt > p.t:
                    stats["stale"] += 1  # honest-but-old: not Byzantine
                    parsed.append(None)
                    continue
                if lt == p.t and lp.value == p.value:
                    parsed.append(None)  # already converged on this key
                    continue
            tbss = pkt.tbss(raw)
        except Exception:
            stats["rejected"] += 1
            parsed.append(None)
            continue
        parsed.append((raw, p, tbss))
        jobs.append((tbss, p.ss))

    # ONE device batch for every pulled collective signature: verify_many
    # routes through the installed ops.dispatch verify dispatcher, so a
    # whole pull costs one kernel launch, not per-record host checks.
    if jobs:
        # Keyed to the OWNER quorum, exactly like the write handler:
        # every surviving record passed the owns() gate above, so they
        # all share this replica's shard and one keyed quorum covers
        # the batch.  The unkeyed quorum would accept a foreign
        # clique's threshold (is_sufficient is any-QC), letting a
        # Byzantine peer launder another shard's signatures through
        # the sync plane.
        first_var = next(
            e[1].variable or b"" for e in parsed if e is not None
        )
        qa = qm.choose_quorum_for(server.qs, first_var, qm.AUTH)
        metrics.observe("sync.pull.verify_batch", len(jobs))
        with trace.span(
            "server.verify_batch",
            attrs={"batch_size": len(jobs), "kind": "sync_pull"},
        ):
            verrs = server.crypt.collective.verify_many(
                jobs, qa, server.crypt.keyring
            )
        # Dual-epoch migration window (DESIGN.md §15): records the OLD
        # owner clique certified while it owned the bucket must be
        # admissible at the NEW owner — that pull IS the pre-copy.
        # Failures retry per-record against the dual quorum the route
        # table names for that record's bucket; outside a window
        # alt_quorums_for is empty and nothing changes.
        if any(e is not None for e in verrs):
            alt_of = getattr(server.qs, "alt_quorums_for", None)
            if alt_of is not None:
                live = [e for e in parsed if e is not None]
                for j, err in enumerate(verrs):
                    if err is None:
                        continue
                    raw_j, p_j, tbss_j = live[j]
                    for alt in alt_of(p_j.variable or b"", qm.AUTH):
                        try:
                            server.crypt.collective.verify(
                                tbss_j, p_j.ss, alt, server.crypt.keyring
                            )
                            verrs[j] = None
                            metrics.incr("sync.pull.dual_verified")
                            break
                        except Exception:
                            # Try the next dual-window quorum; verrs[j]
                            # stays set when none verifies.
                            continue
    else:
        verrs = []

    vi = 0
    persists: list[tuple[bytes, int, bytes]] = []
    seen_vars: set[bytes] = set()
    for entry in parsed:
        if entry is None:
            continue
        raw, p, _tbss = entry
        err = verrs[vi]
        vi += 1
        if err is not None:
            stats["rejected"] += 1
            continue
        variable = p.variable or b""
        if variable in seen_vars and persists:
            # One variable twice in a pull (hostile peers can): the
            # second record's admission gates must see the first's
            # stored state — flush the deferred batch first.
            server._persist_many(persists)
            persists = []
        seen_vars.add(variable)
        try:
            # Timestamp monotonicity, equivocation, and TOFU against the
            # locally stored record — the same checks ``_write`` runs.
            out = server._write_storage_checks(
                variable, p.value, p.t, p.sig, p.ss, raw
            )
        except Exception:
            stats["rejected"] += 1
            continue
        persists.append((variable, p.t, out))
        stats["admitted"] += 1
    # ONE durability barrier for the whole admitted pull — the §19
    # group-commit seam (falls back to per-record writes elsewhere).
    server._persist_many(persists)

    metrics.incr("sync.pull.records", stats["admitted"])
    metrics.incr("sync.rejected", stats["rejected"])
    metrics.incr("sync.pull.stale", stats["stale"])
    return stats


class SyncDaemon:
    """Background anti-entropy loop for one server."""

    #: Bound on the pending-residue scan per repair round.
    REPAIR_SCAN_MAX = 4096

    def __init__(
        self,
        server,
        interval: float = 30.0,
        jitter: float = 0.5,
        rng: random.Random | None = None,
        repair_after: float | None = None,
    ):
        self.server = server
        self.interval = interval
        self.jitter = jitter
        if repair_after is None:
            repair_after = float(
                flags.raw("BFTKV_REPAIR_AFTER", "5") or 5
            )
        #: Grace window: a pending record younger than this (measured
        #: from when THIS daemon first observed it — storage records
        #: carry no wall clock) is presumed to be a live write's tail
        #: still in flight and left alone.
        self.repair_after = repair_after
        self._rng = rng or random.Random()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # variable -> monotonic time first seen pending.
        self._pending_seen: dict[bytes, float] = {}
        # (variable, t) this daemon demoted: never-certifiable residue
        # is tried once, surfaced once, and not retried every round.
        self._demoted: set[tuple[bytes, int]] = set()
        self._backfills = None  # lazy _BackfillCoalescer(server)
        # Windowed-scan cursor (None = start of keyspace) and the
        # variables seen pending so far in the current scan CYCLE —
        # watch-list eviction is only sound once a cycle covered the
        # whole keyspace.
        self._scan_cursor: bytes | None = None
        self._cycle_live: set[bytes] = set()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SyncDaemon":
        if self._thread is None:
            self._stop = threading.Event()  # a prior stop() left it set
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="bftkv-sync"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _loop(self) -> None:
        # Local ref: a wedged thread abandoned by a timed-out stop()
        # must keep honoring the OLD event, never a successor start()'s
        # (the dispatch workers' discipline, ops/dispatch.py).
        stop = self._stop
        while not stop.is_set():
            # Jittered so a fleet restarted together does not stampede.
            delay = self.interval * (
                1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
            )
            if stop.wait(max(0.1, delay)):
                return
            try:
                self.run_round()
            except Exception:
                log.exception("anti-entropy round failed")
            try:
                self.repair_round()
            except Exception:
                log.exception("repair round failed")

    # -- one round ---------------------------------------------------------

    def _peers(self) -> list:
        peers = [
            n
            for n in self.server.self_node.get_peers()
            if getattr(n, "address", "") and getattr(n, "active", True)
        ]
        # Sharded namespace: only same-shard peers can hold records we
        # own (every replica applies the wrong-shard admission gate), so
        # polling foreign shards is pure waste.  Peers without a shard
        # assignment are kept — fail open, admission stays the shield.
        qs = getattr(self.server, "qs", None)
        idx_of = getattr(qs, "shard_index_of", None)
        if idx_of is None:
            return peers
        mine = idx_of(self.server.self_node.get_self_id())
        if mine is None:
            return peers
        # Epoched migration (DESIGN.md §15): during a pre-copy / dual
        # window the new owner of a moving bucket must pull from the
        # OLD owner's shard (and the old owner from the new, so its
        # in-flight tails converge before it goes inert) — the dual
        # shard set widens the poll set for exactly that window.
        keep = {mine} | getattr(qs, "dual_pull_shards", lambda: set())()
        return [
            n for n in peers if idx_of(n.id) is None or idx_of(n.id) in keep
        ]

    def _ask(self, cmd: int, peer, payload: bytes) -> bytes | None:
        """Point-to-point request over the encrypted transport;
        ``tp.multicast`` blocks until the single callback ran."""
        box: dict = {}

        def cb(res: tp.MulticastResponse) -> bool:
            box["res"] = res
            return True

        self.server.tr.multicast(cmd, [peer], payload, cb)
        res = box.get("res")
        if res is None or res.err is not None:
            return None
        return res.data

    def run_round(self) -> dict:
        """One anti-entropy round: digest-poll the peer set (cheap — a
        digest is ≤ 8 KB), then pull divergent buckets from up to
        ``f+1`` distinct divergent peers.  With at most ``f`` Byzantine
        replicas among them, at least one pulled peer is honest, so a
        round reaches every record some honest divergent peer serves;
        safety never depends on the count — admission re-verifies
        everything.  Returns aggregate counters."""
        if fp.ARMED:
            # ``sync.round`` failpoint: the round aborts before any
            # digest poll — a daemon wedged or killed mid-schedule.
            act = fp.fire(
                "sync.round",
                node=getattr(self.server.self_node, "name", ""),
            )
            if act is not None and act.kind == "abort":
                metrics.incr("sync.aborted")
                return {"peers": 0, "pulled_peers": 0, "admitted": 0,
                        "rejected": 0, "stale": 0, "aborted": 1}
        with trace.span("sync.round") as sp:
            stats = self._run_round_inner()
            sp.attrs.update(stats)
        return stats

    def _run_round_inner(self) -> dict:
        stats = {"peers": 0, "pulled_peers": 0, "admitted": 0,
                 "rejected": 0, "stale": 0}
        peers = self._peers()
        if not peers:
            return stats
        # get_peers() excludes self, so the replica count is
        # len(peers)+1 and the fault bound is f = (n-1)//3 = peers//3 —
        # computing it off the peer list directly would undercount by
        # one for every n = 3f+1 cluster and let a single Byzantine
        # peer absorb the whole round's pull budget.
        f = len(peers) // 3
        local = self.server._sync_tree()
        # Shard-aware digest comparison: only buckets this replica's
        # shard owns are worth pulling — a foreign shard's buckets
        # diverge forever by design (their records die in our
        # admission), and without the filter every round would re-pull
        # them just to reject them.
        owned = None
        get_owned = getattr(getattr(self.server, "qs", None),
                            "owned_buckets", None)
        if get_owned is not None:
            owned = get_owned()
        divergent_peers: list[tuple[object, list[int]]] = []
        for peer in peers:
            stats["peers"] += 1
            data = self._ask(tp.SYNC_DIGEST, peer, b"")
            if data is None:
                continue
            try:
                theirs = pkt.parse_digest(data)
            except Exception:
                metrics.incr("sync.rejected")
                stats["rejected"] += 1
                continue
            mine = local.buckets()
            divergent = [
                b
                for b, h in sorted(theirs.items())
                if mine.get(b) != h and (owned is None or b in owned)
            ]
            if divergent:
                divergent_peers.append((peer, divergent))
        self._rng.shuffle(divergent_peers)
        for peer, divergent in divergent_peers[: f + 1]:
            stats["pulled_peers"] += 1
            raw = self._ask(
                tp.SYNC_PULL, peer, pkt.serialize_bucket_ids(divergent)
            )
            if raw is None:
                continue
            if len(raw) > MAX_PULL_BYTES:
                metrics.incr("sync.rejected")
                stats["rejected"] += 1
                continue
            try:
                records = pkt.parse_list(raw)
            except Exception:
                metrics.incr("sync.rejected")
                stats["rejected"] += 1
                continue
            got = admit_records(self.server, records)
            for k in ("admitted", "rejected", "stale"):
                stats[k] += got[k]
        metrics.incr("sync.rounds")
        return stats

    # -- pending-residue repair (DESIGN.md §13.1) --------------------------
    #
    # A writer that crashes after the 2f+1 commit but before its async
    # back-fill leaves commit-PENDING residue on the quorum: a record
    # the plane has accepted but that carries no verifying collective
    # signature yet.  Before this plane, such a record was certified
    # only if some client happened to READ the variable (certify-on-
    # read) — anti-entropy never ships pending records, so convergence
    # depended on client liveness.  The repair round closes that: each
    # replica scans ITS OWN store for pending residue past the grace
    # window, runs the same idempotent SIGN round the read path uses to
    # mint a verifying collective signature, back-fills the certified
    # record plane-wide through the back-fill coalescer, and demotes
    # residue that cannot reach ``suff`` (``sync.repair.demoted``
    # feeds the fleet feed's ``tail_starved`` anomaly).  Safety: the
    # SIGN round re-collects shares for the EXACT stored <x, v, t,
    # sig> (honest replicas already signed it — re-signing the exact
    # stored pair is the one re-sign the equivocation rule permits),
    # and the back-fill rides the same certified-beats-residue /
    # upgrade-in-place admission rules every write already obeys, so
    # concurrent repairs from several replicas are idempotent races.

    def repair_once(self) -> dict:
        """One repair pass ignoring the grace window (tests, CLI)."""
        return self.repair_round(force=True)

    def repair_round(self, *, force: bool = False) -> dict:
        stats = {"scanned": 0, "certified": 0, "demoted": 0,
                 "waiting": 0, "retrying": 0}
        if not repair_enabled():
            return stats
        srv = self.server
        now = time.monotonic()
        # Windowed scan: at most REPAIR_SCAN_MAX keys read+parsed per
        # round, resuming where the last round stopped — a big fully-
        # certified store costs one bounded slice per round, never a
        # full sweep.
        pending, self._scan_cursor = srv.pending_variables(
            limit=self.REPAIR_SCAN_MAX,
            after=self._scan_cursor,
            scan_window=self.REPAIR_SCAN_MAX,
        )
        cycle_done = self._scan_cursor is None
        # Cursor lag for the capacity plane: 1.0 = this round's scan
        # window came back full (the cursor cannot cover the keyspace
        # in one round — repair is running behind residue accrual);
        # 0.0 = the cycle completed inside the window.
        metrics.gauge(
            "sync.repair.cursor_lag",
            0.0 if cycle_done else min(
                1.0, len(pending) / max(1, self.REPAIR_SCAN_MAX)
            ),
        )
        metrics.gauge("sync.repair.backlog", float(len(pending)))
        due: list[tuple[bytes, int, bytes, object]] = []
        for variable, t, raw, p in pending:
            self._cycle_live.add(variable)
            if (variable, t) in self._demoted:
                continue
            stats["scanned"] += 1
            first = self._pending_seen.setdefault(variable, now)
            if force or now - first >= self.repair_after:
                due.append((variable, t, raw, p))
            else:
                stats["waiting"] += 1
        # Residue that resolved on its own (back-fill landed, a newer
        # write certified) leaves the watch list — judged only once a
        # scan CYCLE has covered the whole keyspace (absence from one
        # window just means "not in this window").
        if cycle_done:
            for v in list(self._pending_seen):
                if v not in self._cycle_live:
                    del self._pending_seen[v]
            self._cycle_live = set()
        if not due:
            return stats
        certified: list[tuple[bytes, bytes]] = []
        with trace.span("sync.repair", attrs={"due": len(due)}):
            for variable, t, raw, p in due:
                verdict, rec = self._certify_record(variable, t, raw, p)
                if verdict == "certified":
                    stats["certified"] += 1
                    metrics.incr("sync.repair.certified")
                    certified.append((variable, rec))
                    self._pending_seen.pop(variable, None)
                elif verdict == "refused":
                    # The quorum ANSWERED and would not endorse the
                    # record (bad writer signature, conflicting value):
                    # only misbehavior can produce this — surface it
                    # exactly once and stop burning quorum signs on it.
                    # The record stays gated client-side (resolve
                    # demotes uncertifiable pending buckets), so
                    # nothing unbacked is ever served off it.
                    stats["demoted"] += 1
                    metrics.incr("sync.repair.demoted")
                    self._demoted.add((variable, t))
                    self._pending_seen.pop(variable, None)
                    log.warning(
                        "repair: demoted uncertifiable pending "
                        "residue %r (t=%d)", variable, t,
                    )
                else:
                    # Quorum UNREACHABLE (timeouts, partition, circuit
                    # open): that is an outage, not a verdict — a
                    # transient blip must not permanently demote
                    # healthy residue or raise a false misbehavior
                    # anomaly.  Leave the watch entry; the next round
                    # retries after the partition heals.
                    stats["retrying"] += 1
                    metrics.incr("sync.repair.retry")
        if certified:
            self._backfill(certified)
        return stats

    #: Transport-level failure messages: an outage, never a verdict.
    _OUTAGE_ERRS = frozenset(
        e.message
        for e in (
            tp.ERR_UNREACHABLE,
            tp.ERR_RPC_TIMEOUT,
            tp.ERR_SERVER_ERROR,
            tp.ERR_PEER_OPEN,
        )
    )

    def _certify_record(
        self, variable: bytes, t: int, raw: bytes, p
    ):
        """Mint a verifying collective signature for one pending record
        via the idempotent SIGN round (the certify-on-read recipe, run
        from the replica's seat) and persist the certified bytes
        locally through the full write-path checks.  Returns
        ``("certified", record)`` on success, ``("refused", None)``
        when some quorum member ANSWERED and would not endorse the
        record (demotable misbehavior), or ``("outage", None)`` when
        the round failed on transport errors alone — a partition or
        timeout blip that the caller must retry, never demote."""
        srv = self.server
        # Plain AUTH: the owner clique from the replica's own seat (the
        # client-shaped AUTH|PEER view is empty on a server — same
        # quorum flags admit_records verifies with).
        qa = qm.choose_quorum_for(srv.qs, variable, qm.AUTH)
        # Residue whose bucket migrated AWAY (epoch flip): the owner is
        # now a foreign clique, and this seat's trust weight into it is
        # zero — the low-weight veto would zero ``suff`` and the round
        # could never combine.  Judge sufficiency in verify view: the
        # shares are still cryptographically checked against the owner
        # clique the shared certificate graph defines (DESIGN.md §15).
        qs = srv.qs
        shard_of = getattr(qs, "shard_of", None)
        my_shard = getattr(qs, "my_shard", None)
        qfs = getattr(qs, "quorum_for_shard", None)
        if shard_of is not None and my_shard is not None and qfs is not None:
            owner = shard_of(variable)
            mine = my_shard()
            if owner is not None and mine is not None and owner != mine:
                qa = qfs(owner, qm.AUTH, True)
        req = pkt.serialize(variable, p.value, t, p.sig, None)
        tbss = pkt.tbss(raw)
        ss = None
        done_flag = [False]
        failure: list = []
        refused = [0]

        def cb(res: tp.MulticastResponse) -> bool:
            nonlocal ss
            if res.err is None and res.data is not None:
                try:
                    share = pkt.parse_signature(res.data)
                    ss, done = srv.crypt.collective.combine(
                        ss, share, qa, srv.crypt.keyring
                    )
                    done_flag[0] = done
                    return done
                except Exception:
                    # An unusable share IS an answer from a reachable
                    # peer — the refusal class, not an outage.
                    refused[0] += 1
            elif (
                getattr(res.err, "message", None)
                not in self._OUTAGE_ERRS
            ):
                # Interned protocol error (equivocation, invalid
                # signature, bad timestamp, ...): the peer answered
                # and said no.
                refused[0] += 1
            failure.append(res.peer)
            return qa.reject(failure)

        with trace.span("sync.repair.sign", attrs={"t": t}):
            srv.tr.multicast(tp.SIGN, qa.nodes(), req, cb)
            try:
                srv.crypt.collective.verify(
                    tbss, ss, qa, srv.crypt.keyring
                )
            except Exception:
                return ("refused" if refused[0] else "outage", None)
        ss.completed = True
        rec = pkt.serialize(variable, p.value, t, p.sig, ss)
        try:
            # Local admission first (timestamp / equivocation / TOFU /
            # upgrade-in-place — exactly what the write handler runs);
            # local state may have legitimately moved past this record,
            # in which case the no-op answer is the correct one.
            out = srv._write_storage_checks(
                variable, p.value, t, p.sig, ss, rec
            )
            if out is not None:
                srv._persist(variable, t, out)
        except Exception:
            log.exception("repair: local admission of %r failed", variable)
        return "certified", rec

    def recertify_buckets(self, buckets: set[int] | None = None) -> dict:
        """Migration drain sweep (DESIGN.md §15.3): re-certify every
        completed record in ``buckets`` (default: all owned) whose
        collective signature does NOT verify against this replica's
        owner quorum — i.e. records pre-copied from the clique that
        owned the bucket in an earlier epoch.  The same idempotent SIGN
        round the repair plane uses mints a fresh owner-clique
        signature over the EXACT stored ``<x, v, t, sig>`` (the one
        re-sign the equivocation rule permits), so after the sweep the
        bucket's history verifies against its new owner alone and the
        dual-epoch verification window can close."""
        from bftkv_tpu_torch.quorum.wotqs import route_bucket

        srv = self.server
        stats = {"scanned": 0, "recertified": 0, "failed": 0}
        owned = None
        get_owned = getattr(srv.qs, "owned_buckets", None)
        if get_owned is not None:
            owned = get_owned()
        certified: list[tuple[bytes, bytes]] = []
        for variable in sorted(srv.storage.keys()):
            if variable.startswith(HIDDEN_PREFIX):
                continue
            b = route_bucket(variable)
            if buckets is not None and b not in buckets:
                continue
            if owned is not None and b not in owned:
                continue
            rec = latest_completed(srv.storage, variable)
            if rec is None:
                continue
            t, raw, p = rec
            if p.auth is not None:
                continue  # TPA-protected: needs the client's proof
            stats["scanned"] += 1
            qa = qm.choose_quorum_for(srv.qs, variable, qm.AUTH)
            try:
                srv.crypt.collective.verify(
                    pkt.tbss(raw), p.ss, qa, srv.crypt.keyring
                )
                continue  # already vouched for by the owner quorum
            except Exception:
                pass  # not certified as-is: certify-or-demote below
            verdict, out = self._certify_record(variable, t, raw, p)
            if verdict == "certified":
                stats["recertified"] += 1
                metrics.incr("sync.recertified")
                certified.append((variable, out))
            else:
                stats["failed"] += 1
                metrics.incr("sync.recertify_failed")
        if certified:
            self._backfill(certified)
        return stats

    def _backfill(self, items: list[tuple[bytes, bytes]]) -> None:
        """Push certified records plane-wide through the same back-fill
        coalescer the collapsed write's async tail uses (one batched
        single-shard BATCH_WRITE round per group); bounded-blocking so
        a repair round leaves a settled plane behind it."""
        from bftkv_tpu_torch.protocol.client import _BackfillCoalescer

        if self._backfills is None:
            # The coalescer only touches .qs and .tr — a Server
            # satisfies that surface exactly like a Client.
            self._backfills = _BackfillCoalescer(self.server)
        for variable, rec in items:
            self._backfills.submit(variable, rec)
        self._backfills.drain(timeout=15.0)
        # The coalescer covers the WRITE plane; the sign quorum's
        # members hold the pending residue too (and the repair SIGN
        # round just re-marked it in-progress there), so the certified
        # bytes must reach them as well or a clique member outside the
        # write plane would keep residue until some client read it.
        # Grouped per owning shard, exactly like the coalescer: a
        # BATCH_WRITE frame is verified against ONE owner quorum
        # server-side (a sharded replica's store only holds owned
        # variables, so this is one group in practice — the grouping
        # guards duck-typed quorum systems without that invariant).
        srv = self.server
        shard_of = getattr(srv.qs, "shard_of", None)
        groups: dict[object, list[tuple[bytes, bytes]]] = {}
        for variable, rec in items:
            key = shard_of(variable) if shard_of is not None else None
            groups.setdefault(key, []).append((variable, rec))
        for group in groups.values():
            qa = qm.choose_quorum_for(srv.qs, group[0][0], qm.AUTH)
            with trace.span(
                "sync.repair.backfill", attrs={"batch": len(group)}
            ):
                srv.tr.multicast(
                    tp.BATCH_WRITE,
                    qa.nodes(),
                    pkt.serialize_list([rec for _v, rec in group]),
                    None,
                )
