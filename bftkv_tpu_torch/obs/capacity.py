"""USE-method capacity plane + the fleet bottleneck-verdict engine
(DESIGN.md §20; counterpart of ``bftkv_tpu/obs/capacity.py``).

The diagnosis tier so far answers "why was THIS request slow" (§18:
attribution, profiler, recorder).  This module answers the planning
question — **what limits throughput right now** — by reading every
bounded resource in the box through one closed vocabulary and the USE
method: *Utilization* (how full is the resource), *Saturation* (how
much work is queued/shed/throttled behind it, normalized to [0, 1]),
*Errors* (work the resource refused this scrape).

The resource vocabulary is CLOSED, exactly like ``metrics.LABEL_KEYS``
and ``trace.PHASES`` — the ``resource`` metric label, the
``bftkv_fleet_resource_*`` Prometheus family, the ``/fleet`` capacity
section, and the verdict join all key off :data:`RESOURCES`.  Adding a
resource is a deliberate schema change (declare the name here, map its
phases, document the signals in §20).

The **verdict** joins per-resource saturation with §18's phase budgets:
a saturated resource only limits throughput to the extent the write
path actually *spends time* in the phases that resource backs, so each
(member, resource) is scored ``saturation x phase-share`` (share floor
0.05 — a fully saturated resource in a currently-unattributed phase
still ranks above quiet ones; the GIL is cross-cutting and carries a
flat floor instead of a phase).  The ranked list, per member and
fleet-wide, is what ``cmd.fleet --capacity`` prints under the verdict
line.

Sustained saturation becomes the ``resource_saturated`` anomaly with
``slo_burn``'s exact hysteresis contract: ``BFTKV_SAT_THRESHOLD``
breached for ``BFTKV_SAT_SCRAPES`` consecutive traffic-bearing scrapes
fires ONCE per episode; idle scrapes hold the count; a healthy scrape
re-arms.  The collector emits it through the anomaly feed, so the
flight recorder snapshots capacity state automatically.
"""

from __future__ import annotations

import time

from bftkv_tpu_torch import flags

__all__ = [
    "RESOURCES",
    "RESOURCE_PHASES",
    "CapacityPlane",
    "compute_member",
]

#: The closed resource vocabulary (same cardinality rule as
#: ``metrics.LABEL_KEYS``): every bounded resource the box can queue
#: behind, one canonical name each.
RESOURCES = (
    "admission",     # AdmissionQueue slots (gateway + sidecar tiers)
    "dispatch",      # device batch plane (sign/verify/modexp launches)
    "fanout_pool",   # transport._DaemonPool multicast workers
    "conn_pool",     # per-peer keep-alive HTTP connection pool
    "log_commit",    # log-engine group-commit fsync barrier
    "compact_io",    # compaction copy bandwidth (governed)
    "sync_lag",      # repair daemon scan-cursor backlog
    "gil",           # interpreter: runnable (GIL-queued) threads
)

#: Verdict join: which §18 phases each resource backs.  A resource's
#: weight is the write budget's share-sum over these phases (floor
#: applied in :meth:`CapacityPlane.verdict`).  ``gil`` is cross-cutting
#: — it maps to no phase and scores on a flat floor.
RESOURCE_PHASES: dict[str, tuple[str, ...]] = {
    "admission": ("server", "sidecar"),
    "dispatch": ("dispatch",),
    "fanout_pool": ("fanout",),
    "conn_pool": ("rpc",),
    "log_commit": ("server",),
    "compact_io": ("server",),
    "sync_lag": ("backfill",),
    "gil": (),
}

#: Cross-cutting / unattributed weight floor (see module doc).
_SHARE_FLOOR = 0.05
_GIL_WEIGHT = 0.25

#: Saturation scale constants: pool submits queued per scrape that
#: count as "fully saturated", and runnable threads past the one the
#: GIL can run that count the same.
_POOL_SAT_REF = 8.0
_GIL_SAT_REF = 4.0


def _index(snap: dict) -> dict:
    """Flat snapshot → ``name -> [(labels, value)]`` (one parse pass)."""
    from bftkv_tpu_torch.obs.collector import parse_flat_key

    idx: dict[str, list[tuple[dict, float]]] = {}
    for k, v in snap.items():
        if not isinstance(v, (int, float)):
            continue
        name, labels = parse_flat_key(k)
        idx.setdefault(name, []).append((labels, float(v)))
    return idx


def _first(idx: dict, name: str, **want) -> float | None:
    for labels, v in idx.get(name, ()):
        if all(labels.get(k) == w for k, w in want.items()):
            return v
    return None


def _sum(idx: dict, name: str, **want) -> float:
    return sum(
        v
        for labels, v in idx.get(name, ())
        if all(labels.get(k) == w for k, w in want.items())
    )


def _delta(idx: dict, prev: dict, name: str, **want) -> float:
    """Per-scrape counter delta (floored at 0 — a member restart resets
    its counters; a negative delta is a reboot, not negative traffic)."""
    return max(0.0, _sum(idx, name, **want) - _sum(prev, name, **want))


def compute_member(
    idx: dict, prev: dict, dt: float, *, wait_ref: float | None = None
) -> dict:
    """USE rows for one member from an indexed snapshot (``_index``)
    plus the previous scrape's index (counter-delta baseline; ``{}``
    on the first scrape makes deltas equal totals, which is the honest
    first reading).  Returns ``{resource: row}`` with only the
    resources the member actually exposes; each row carries
    ``utilization`` / ``saturation`` in [0, 1], ``errors`` (count this
    scrape), a private ``_traffic`` bool for the hysteresis, and
    resource-specific extras (occupancy breakdowns, rates)."""
    if wait_ref is None:
        wait_ref = flags.get_float("BFTKV_SAT_WAIT_REF") or 0.25
    dt = max(dt, 1e-9)
    rows: dict[str, dict] = {}

    # -- admission ---------------------------------------------------------
    tiers = {}
    for tier in ("gateway", "sidecar"):
        limit = _first(idx, "admission.limit", resource=tier)
        if limit is None:
            continue
        inflight = _first(idx, "admission.inflight", resource=tier) or 0.0
        waiting = _first(idx, "admission.waiting", resource=tier) or 0.0
        qlimit = _first(idx, "admission.queue_limit", resource=tier) or 1.0
        shed = _delta(idx, prev, f"{tier}.shed")
        wait_p99 = _first(idx, "admission.wait.p99", resource=tier) or 0.0
        tiers[tier] = {
            "inflight": inflight,
            "waiting": waiting,
            "limit": limit,
            "shed": shed,
            "wait_p99_s": round(wait_p99, 6),
            "utilization": min(1.0, inflight / max(1.0, limit)),
            "saturation": max(
                min(1.0, waiting / max(1.0, qlimit)),
                min(1.0, wait_p99 / wait_ref),
                1.0 if shed > 0 else 0.0,
            ),
        }
    if tiers:
        rows["admission"] = {
            "utilization": max(t["utilization"] for t in tiers.values()),
            "saturation": max(t["saturation"] for t in tiers.values()),
            "errors": sum(t["shed"] for t in tiers.values()),
            "_traffic": any(
                _delta(idx, prev, "admission.wait.count", resource=t) > 0
                or tiers[t]["shed"] > 0
                for t in tiers
            ),
            "tiers": tiers,
        }

    # -- dispatch ----------------------------------------------------------
    disps = {}
    for name in ("dispatch", "signdispatch", "modexpdispatch"):
        widths = {
            labels.get("width", "all"): v
            for labels, v in idx.get(f"{name}.device_occupancy", ())
        }
        flushes = _delta(idx, prev, f"{name}.flushes")
        items = _delta(idx, prev, f"{name}.items")
        if not widths and not flushes:
            continue
        wait_p99 = _first(idx, f"{name}.wait.p99") or 0.0
        disps[name] = {
            "device_occupancy": widths,
            "items_per_launch": round(items / flushes, 2) if flushes else None,
            "wait_p99_s": round(wait_p99, 6),
            "flushes": flushes,
        }
    if disps:
        # Device-plane signals: observed launch RTT (the online
        # recalibration EWMA) and per-width staging buffer-ring
        # saturation.  A full ring means flushes are allocating fresh
        # staging arrays behind a busy device — the buffer rings are the
        # wall, which folds into the row's saturation alongside caller
        # wait: either one pushing up is the dispatch plane telling the
        # fleet it cannot absorb more offered load.
        launch_rtt = _first(idx, "dispatch.launch_rtt")
        rings = {
            labels.get("width", "all"): v
            for labels, v in idx.get("devbuf.saturation", ())
        }
        ring_sat = max(rings.values(), default=0.0)
        row = {
            "utilization": max(
                (
                    occ
                    for d in disps.values()
                    for occ in d["device_occupancy"].values()
                ),
                default=0.0,
            ),
            "saturation": max(
                min(
                    1.0,
                    max(d["wait_p99_s"] for d in disps.values()) / wait_ref,
                ),
                min(1.0, ring_sat),
            ),
            "errors": 0.0,
            "_traffic": any(d["flushes"] > 0 for d in disps.values()),
            "dispatchers": disps,
        }
        if launch_rtt is not None:
            row["launch_rtt_s"] = round(launch_rtt, 6)
        if rings:
            row["buffer_rings"] = {
                w: round(v, 4) for w, v in sorted(rings.items())
            }
        rows["dispatch"] = row

    # -- fanout_pool -------------------------------------------------------
    cap = _first(idx, "transport.pool.cap", resource="fanout_pool")
    if cap:
        busy = _first(idx, "transport.pool.busy", resource="fanout_pool") or 0.0
        queued = _delta(idx, prev, "transport.pool.saturated")
        overflow = _delta(idx, prev, "transport.pool.nested_overflow")
        rows["fanout_pool"] = {
            "utilization": min(1.0, busy / cap),
            "saturation": min(1.0, queued / _POOL_SAT_REF),
            "errors": overflow,
            "_traffic": True,  # gauge presence == fan-out happened
            "busy": busy,
            "cap": cap,
            "queued_submits": queued,
        }

    # -- conn_pool ---------------------------------------------------------
    dialed = _delta(idx, prev, "transport.conn.dialed")
    reused = _delta(idx, prev, "transport.conn.reused")
    if dialed or reused or idx.get("transport.conn.idle"):
        total = dialed + reused
        miss = dialed / total if total else 0.0
        rows["conn_pool"] = {
            "utilization": round(miss, 4),
            "saturation": round(miss if total else 0.0, 4),
            "errors": 0.0,
            "_traffic": total > 0,
            "dialed": dialed,
            "reused": reused,
            "idle": _first(idx, "transport.conn.idle", resource="conn_pool")
            or 0.0,
        }

    # -- log_commit --------------------------------------------------------
    commits = _delta(idx, prev, "storage.log.commit_wait.count")
    if commits or idx.get("storage.log.linger_ms"):
        linger_s = (_first(idx, "storage.log.linger_ms") or 0.0) / 1000.0
        p99 = _first(idx, "storage.log.commit_wait.p99") or 0.0
        fsyncs = _delta(idx, prev, "storage.log.fsync")
        bsum = _delta(idx, prev, "storage.log.batch.sum")
        bcount = _delta(idx, prev, "storage.log.batch.count")
        rows["log_commit"] = {
            # Linger occupancy: fraction of the scrape the fsync leader
            # spent inside a linger window.
            "utilization": min(1.0, fsyncs * linger_s / dt),
            "saturation": min(
                1.0, p99 / max(4.0 * linger_s, wait_ref)
            ),
            "errors": _delta(idx, prev, "storage.log.torn_truncated")
            + _delta(idx, prev, "storage.log.sealed_tear"),
            "_traffic": commits > 0,
            "fsync_per_s": round(fsyncs / dt, 2),
            "batch_fill": round(bsum / bcount, 2) if bcount else None,
            "commit_wait_p99_s": round(p99, 6),
            "linger_ms": round(linger_s * 1000.0, 3),
        }

    # -- compact_io --------------------------------------------------------
    moved = _delta(idx, prev, "storage.compact.read_bytes") + _delta(
        idx, prev, "storage.compact.written_bytes"
    )
    if moved or idx.get("storage.compact.mbps"):
        governor = flags.get_float("BFTKV_LOG_COMPACT_MBPS") or 0.0
        mbps = moved / dt / (1024 * 1024)
        throttle = _delta(idx, prev, "storage.compact.throttle.sum")
        rows["compact_io"] = {
            "utilization": min(1.0, mbps / governor)
            if governor
            else (1.0 if moved else 0.0),
            "saturation": min(1.0, throttle / dt),
            "errors": _delta(idx, prev, "storage.log.compact_failed"),
            "_traffic": moved > 0,
            "mbps": round(mbps, 3),
            "throttle_s": round(throttle, 4),
        }

    # -- sync_lag ----------------------------------------------------------
    lag = _first(idx, "sync.repair.cursor_lag")
    if lag is not None:
        rows["sync_lag"] = {
            "utilization": min(1.0, lag),
            "saturation": min(1.0, lag),
            "errors": _delta(idx, prev, "sync.repair.demoted"),
            "_traffic": True,
            "backlog": _first(idx, "sync.repair.backlog") or 0.0,
        }

    # -- gil ---------------------------------------------------------------
    runnable = _first(idx, "gil.runnable", resource="gil")
    if runnable is not None:
        rows["gil"] = {
            "utilization": min(1.0, runnable / (1.0 + _GIL_SAT_REF)),
            # >1 runnable thread means someone is queued on the GIL.
            "saturation": min(1.0, max(0.0, runnable - 1.0) / _GIL_SAT_REF),
            "errors": 0.0,
            "_traffic": True,
            "runnable": runnable,
        }

    return rows


class CapacityPlane:
    """Per-member USE state + the verdict engine + the
    ``resource_saturated`` hysteresis.  One instance per collector (and
    one inside the bench harness); ``observe`` folds a member's metrics
    snapshot each scrape, ``doc``/``verdict`` render, ``check`` runs
    the anomaly hysteresis and returns newly-fired episodes."""

    def __init__(self) -> None:
        self._prev: dict[str, dict] = {}     # member -> last index
        self._last_ts: dict[str, float] = {}  # member -> last observe ts
        self._rows: dict[str, dict] = {}     # member -> resource rows
        self._sat_count: dict[tuple[str, str], int] = {}

    # -- fold --------------------------------------------------------------

    def observe(self, member: str, snap: dict, now: float | None = None) -> dict:
        """Fold one member scrape; returns the member's USE rows."""
        if now is None:
            now = time.monotonic()
        idx = _index(snap)
        prev = self._prev.get(member, {})
        dt = now - self._last_ts.get(member, now - 1.0)
        rows = compute_member(idx, prev, dt)
        self._prev[member] = idx
        self._last_ts[member] = now
        self._rows[member] = rows
        return rows

    def forget(self, member: str) -> None:
        self._prev.pop(member, None)
        self._last_ts.pop(member, None)
        self._rows.pop(member, None)
        for key in [k for k in self._sat_count if k[0] == member]:
            del self._sat_count[key]

    # -- render ------------------------------------------------------------

    def doc(self) -> dict:
        """``{member: {resource: row}}`` with the private keys dropped
        and a fleet-wide per-resource max fold."""
        members = {
            m: {
                res: {k: v for k, v in row.items() if not k.startswith("_")}
                for res, row in rows.items()
            }
            for m, rows in self._rows.items()
        }
        fleet: dict[str, dict] = {}
        for rows in self._rows.values():
            for res, row in rows.items():
                agg = fleet.setdefault(
                    res, {"utilization": 0.0, "saturation": 0.0, "errors": 0.0}
                )
                agg["utilization"] = max(agg["utilization"], row["utilization"])
                agg["saturation"] = max(agg["saturation"], row["saturation"])
                agg["errors"] += row["errors"]
        return {"members": members, "fleet": fleet}

    def verdict(self, phase_shares: dict | None = None) -> dict:
        """Rank (member, resource) by ``saturation x phase-weight``.

        ``phase_shares`` is ``{phase: share}`` from the write budget
        (shares sum to ~1 across ``trace.PHASES``); None or empty —
        e.g. before any trace has been attributed — degrades to pure
        saturation ranking (weight 1.0), which is still a verdict, just
        an unjoined one."""
        shares = phase_shares or {}
        ranked = []
        for member, rows in self._rows.items():
            for res, row in rows.items():
                sat = row["saturation"]
                if sat <= 0 and row["errors"] <= 0:
                    continue
                if not shares:
                    weight = 1.0
                elif res == "gil":
                    weight = _GIL_WEIGHT
                else:
                    weight = max(
                        sum(
                            shares.get(p, 0.0)
                            for p in RESOURCE_PHASES.get(res, ())
                        ),
                        _SHARE_FLOOR,
                    )
                ranked.append(
                    {
                        "member": member,
                        "resource": res,
                        "saturation": round(sat, 4),
                        "utilization": round(row["utilization"], 4),
                        "phase_weight": round(weight, 4),
                        "score": round(sat * weight, 4),
                    }
                )
        ranked.sort(key=lambda r: (-r["score"], -r["saturation"]))
        top = ranked[0] if ranked else None
        if top is not None:
            summary = (
                f"{top['resource']} on {top['member']} limits throughput "
                f"(saturation {top['saturation']:.2f} x phase weight "
                f"{top['phase_weight']:.2f})"
            )
        else:
            # Nothing saturated: report the fullest resource instead —
            # "you are not queueing anywhere; here is the next wall".
            best = None
            for member, rows in self._rows.items():
                for res, row in rows.items():
                    if best is None or row["utilization"] > best[2]:
                        best = (member, res, row["utilization"])
            summary = (
                "no saturated resource"
                + (
                    f"; highest utilization {best[1]} on {best[0]} "
                    f"({best[2]:.2f})"
                    if best
                    else ""
                )
            )
        return {"ranked": ranked, "top": top, "summary": summary}

    # -- anomaly hysteresis ------------------------------------------------

    def check(self) -> list[dict]:
        """The ``resource_saturated`` hysteresis, slo_burn's contract:
        saturation >= BFTKV_SAT_THRESHOLD on a traffic-bearing scrape
        advances the (member, resource) counter; BFTKV_SAT_SCRAPES
        consecutive ones fire ONCE; idle holds; healthy re-arms.
        Returns the episodes fired by the LATEST observed scrapes."""
        thr = flags.get_float("BFTKV_SAT_THRESHOLD")
        if not thr:
            return []
        k = max(flags.get_int("BFTKV_SAT_SCRAPES") or 3, 1)
        fired = []
        for member, rows in self._rows.items():
            for res, row in rows.items():
                key = (member, res)
                if row["saturation"] >= thr and row.get("_traffic", True):
                    n = self._sat_count.get(key, 0) + 1
                    self._sat_count[key] = n
                    if n == k:
                        fired.append(
                            {
                                "member": member,
                                "resource": res,
                                "saturation": row["saturation"],
                                "utilization": row["utilization"],
                            }
                        )
                elif row.get("_traffic", True):
                    self._sat_count[key] = 0
                # idle scrape: hold the count (idle can neither
                # saturate nor recover a resource).
        return fired
