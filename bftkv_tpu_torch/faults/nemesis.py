"""Chaos nemesis: seeded, timed fault schedules against a live cluster
(counterpart of ``bftkv_tpu/faults/nemesis.py``).

A :class:`Nemesis` turns one integer seed into a deterministic plan of
chaos steps and executes them against a
:class:`~bftkv_tpu_torch.faults.harness.ChaosCluster` while client traffic
runs, then repairs the world (heal partitions, restart crashed
replicas, drive anti-entropy to convergence) and hands the recorded
history to the :class:`~bftkv_tpu_torch.faults.checker.SafetyChecker`.

Step kinds:

- ``partition`` — a link-matrix cut isolating one replica from
  everyone (drop rules on ``transport.send``, both directions), healed
  at the end of the step;
- ``crash_restart`` — the replica goes dark mid-traffic and is
  restarted as a *fresh* ``Server`` on the same storage; anti-entropy
  must converge it back;
- ``clock_skew`` — the replica's ``time`` answers are shifted by a
  seeded delta (the timestamp path under desynchronized clocks);
- ``link_delay`` — seeded delays on one replica's inbound links (the
  partial-synchrony regime where threshold systems pay their latency
  price);
- ``stale_replay`` / ``collude`` — Byzantine modes as failpoint
  programs (:mod:`bftkv_tpu_torch.faults.byzantine`): genuinely-signed stale
  answers, or the full sign-anything/store-anything colluder;
- ``region_partition`` — a WHOLE region loses its WAN egress: every
  link crossing the region boundary is cut while intra-region links
  stay up (DESIGN.md §21).  Eligible only for regions whose seats stay
  within every plane's node-level ``f`` and hold no clients/gateways,
  so the acceptance bar is ZERO failed writes plus the ``region_down``
  anomaly naming the negative region-level budget.

Every step touches at most one replica at a time, keeping the
adversary inside the ``f`` budget a ``3f+1`` cluster promises to
tolerate — so ZERO safety violations is the pass bar, not a wish.

One seeded round from the shell::

    python -m bftkv_tpu_torch.faults.nemesis --seed 7 [--device cpu]

exits non-zero if the checker reports any violation, and prints the
plan + fault-trace summary as JSON (``--json``) for the CI soak lane.

Every node of the cluster, and the embedded sidecar under ``--sidecar``,
runs on ``--device`` (default ``cuda:0``, which raises without CUDA).
The topology autopilot is not ported yet: ``--autopilot`` and the
``route_flap`` kind (which needs it) exit 2 before any cluster is built.
"""

from __future__ import annotations

import os
import random
import threading
import time

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.faults import byzantine, failpoint as fp
from bftkv_tpu_torch.faults.checker import SafetyChecker
from bftkv_tpu_torch.faults.harness import ChaosCluster, build_cluster
from bftkv_tpu_torch.storage.memkv import MemStorage

__all__ = ["Nemesis", "SidecarHarness", "main"]

#: What ``--autopilot`` (and the ``route_flap`` kind behind it) needs and
#: this package does not have yet.
AUTOPILOT_NOT_PORTED = (
    "needs the topology autopilot (autopilot/), which the port does not "
    "have yet; use bftkv_tpu.faults.nemesis for it"
)

STEP_KINDS = (
    "partition",
    "crash_restart",
    "clock_skew",
    "link_delay",
    "stale_replay",
    "collude",
    "slow_node",
    "route_flap",
    "sidecar_crash",
    "overload",
    "region_partition",
)


class SidecarHarness:
    """Embedded shared-crypto sidecar for chaos runs (``--sidecar``).

    Boots one in-process sidecar on a mode-0600 unix socket and routes
    the WHOLE cluster's verify+sign dispatchers through it, so every
    traffic window crosses the service.  ``crash()`` is the kill -9
    shape: listener gone, socket unlinked, the tenant connection
    severed — clients must fall back to local crypto with ZERO failed
    writes and the breaker-open counter must surface as the
    ``sidecar_down`` anomaly.  ``restart()`` serves the same path again
    and clears the (short) breaker so the next window re-registers
    sign-key handles over a fresh connection.

    The sidecar serves on ``device`` (default ``cuda:0``, which raises
    without CUDA): its verify and sign flushes launch the card's kernels.
    The tenants' local fallback stays the reference's (host crypto)."""

    def __init__(self, device=None):
        import os
        import tempfile

        from bftkv_tpu_torch.cmd import verify_sidecar
        from bftkv_tpu_torch.crypto.remote_verify import (
            RemoteSignerDomain,
            RemoteVerifierDomain,
            SidecarChannel,
        )
        from bftkv_tpu_torch.ops import dispatch

        self.device = devmod.resolve(device)
        self._os = os
        self._verify_sidecar = verify_sidecar
        self._dir = tempfile.mkdtemp(prefix="bftkv-sidecar-")
        self._path = os.path.join(self._dir, "crypto.sock")
        self.addr = "unix:" + self._path
        self.srv, _ = verify_sidecar.serve(self.addr, device=self.device)
        # Short breaker: a healed window must be able to go remote
        # again within the next window, exercising reconnect +
        # handle re-registration instead of one long local stretch.
        self.channel = SidecarChannel(self.addr, breaker_seconds=1.0)
        dispatch.install(
            dispatch.VerifyDispatcher(
                verifier=RemoteVerifierDomain(channel=self.channel),
                calibrate=False,
            )
        )
        dispatch.install_signer(
            dispatch.SignDispatcher(
                signer=RemoteSignerDomain(channel=self.channel),
                calibrate=False,
                max_wait=0.002,
            )
        )

    def crash(self) -> None:
        self.srv.service.stop()
        self.srv.shutdown()
        self.srv.server_close()
        try:
            self._os.unlink(self._path)
        except OSError:
            pass
        # Sever the established tenant connection too: a threading
        # server's live handler would otherwise keep answering.
        self.channel.close()

    def restart(self) -> None:
        self.srv, _ = self._verify_sidecar.serve(self.addr, device=self.device)
        self.channel.reset()

    def stop(self) -> None:
        from bftkv_tpu_torch.ops import dispatch

        try:
            self.crash()
        except Exception:
            pass  # teardown-only: a half-crashed sidecar is fine here
        dispatch.uninstall_all()


#: Anomaly kinds that validly evidence each fault kind in a window's
#: flight-recorder bundle — the mirror of hit()'s own acceptance in
#: _window_check (which of them lands first is a race between the
#: failpoint echo, the counter-delta feeds, and member-state scrapes).
_BUNDLE_OK_KINDS: dict[str, set] = {
    "route_flap": {"epoch_skew"},
    "sidecar_crash": {"sidecar_down", "sidecar_dishonest"},
    "crash_restart": {"member_down"},
    "slow_node": {"fault", "gray_member"},
    "overload": {"resource_saturated"},
    # Probes observe cuts (_ChaosProbeSource), so a partitioned member
    # also transitions down at scrape time — either signal is the
    # window's valid black-box evidence.
    "partition": {"fault", "member_down"},
    "region_partition": {"region_down", "member_down", "fault"},
}


class _ChaosProbeSource:
    """A :class:`~bftkv_tpu_torch.obs.source.LocalSource` whose probe also
    crosses the failpoint plane.  In-process partitions never
    unregister a transport, so the stock registration check would call
    a fully cut-off member healthy — but a real external health
    checker's probe RPC would be dropped by the same rule that drops
    everyone else's traffic.  The probe asks the registry the same
    question side-effect-free (:meth:`FaultRegistry.would_drop`): no
    rule budgets consumed, no fault-trace echo, no perturbed seeded
    draws.  Probes carry no region label, so they count as
    outside-the-boundary traffic for a region cut and never match the
    WAN topology's delay rules."""

    def __init__(self, inner, registry: fp.FaultRegistry):
        self._inner = inner
        self._registry = registry
        self.name = inner.name

    def __getattr__(self, attr):
        return getattr(self._inner, attr)

    def probe(self) -> bool:
        if not self._inner.probe():
            return False
        return not self._registry.would_drop(
            "transport.send", src="fleet", dst=self.name, cmd="probe"
        )


class Nemesis:
    def __init__(
        self,
        cluster: ChaosCluster,
        seed: int = 0,
        registry: fp.FaultRegistry | None = None,
        autopilot: bool = False,
        sidecar_ctl: SidecarHarness | None = None,
        rtt_spec: str | None = None,
        workload: str | None = None,
    ):
        self.cluster = cluster
        self.seed = seed
        self.registry = registry or fp.registry
        #: Spec-shaped traffic (``--workload``, DESIGN.md §23): each
        #: window drains the next slice of ONE deterministic workload
        #: op stream on top of the coverage burst, so faults land
        #: under a production op mix (hot-set storms, ramps) instead
        #: of only the hand-rolled burst.
        self.workload = None
        self._wl_cursor = 0
        if workload:
            from bftkv_tpu_torch.workload.spec import parse_spec

            self.workload = parse_spec(workload)
        #: WAN link-delay program (``--rtt-matrix``): compiled onto
        #: quiet background delay rules right after :meth:`run` arms
        #: the registry, so the whole schedule executes under the
        #: deployment geography (DESIGN.md §21).
        self.rtt_spec = rtt_spec
        self.wan = None
        #: region_partition windows where a write failed: an eligible
        #: region's outage stays inside every plane's node-level f
        #: budget by construction, so writes may slow, never fail.
        self.region_blocked: list[dict] = []
        #: Embedded crypto sidecar under test (``--sidecar``): enables
        #: the sidecar_crash step kind and its zero-failed-writes
        #: oracle.
        self.sidecar_ctl = sidecar_ctl
        self.sidecar_blocked: list[dict] = []
        #: Topology autopilot under test: built in :meth:`run` (it
        #: wants the collector), drives ONE forced migration while the
        #: second half of the fault schedule lands — reconfiguration
        #: under chaos, the DESIGN.md §15 acceptance shape.  The
        #: ``route_flap`` step kind needs it too (it ships tables).
        self._want_autopilot = autopilot
        self.autopilot = None
        self._migration: dict | None = None
        self._written: dict[bytes, bytes] = {}
        self.failures = {"write": 0, "read": 0}
        #: Fleet health collector watching the same cluster — the chaos
        #: suite double-checks the *observability plane*: every injected
        #: fault must surface in the anomaly feed within one scrape of
        #: its window (built in :meth:`run`; None = detection off).
        self.collector = None
        self.detection: list[dict] = []
        #: Flight recorder under test (``BFTKV_FLIGHT_RECORDER=1``):
        #: every fault window must yield exactly ONE black-box bundle
        #: whose manifest names the detected anomaly — the "what did
        #: the box look like when it broke" oracle (DESIGN.md §18).
        self.recorder = None
        self.recorder_missing: list[dict] = []
        #: slow_node windows where a write failed: a gray member inside
        #: the f budget must never BLOCK commit — slower is fine,
        #: failed is a violation (the acceptance bar of DESIGN.md §13).
        self.gray_blocked: list[dict] = []
        #: Front-door client when the cluster runs gateways: part of
        #: every traffic window then, so gateway↔quorum faults (and
        #: Byzantine fill attempts crossing the cache) manifest — and
        #: every gateway-served read is RECORDED, so checker invariant
        #: 3 (reads backed by a verifying collective signature) also
        #: proves no uncertified value was ever served off the cache.
        self._gwc = (
            cluster.gateway_client(0)
            if getattr(cluster, "gateways", None)
            else None
        )
        self._gw_seq = 0
        #: The most recently direct-written variable, tracked
        #: explicitly — a lexicographic max over ``_written`` stops
        #: being "newest" once window tags reach two digits.
        self._last_direct_var: bytes | None = None

    # -- deterministic planning -------------------------------------------

    def _region_pool(self) -> list[str]:
        """Regions eligible for a whole-region outage.  The two-level
        budget (DESIGN.md §21) must keep writes alive, so a region
        qualifies only when it holds no client or gateway identities
        and its seats stay within the NODE-level budget of every
        plane: at most ``f`` members of each shard clique and at most
        ``f`` storage replicas.  Empty when no region map is installed
        — plan() then degrades the kind to a plain partition."""
        uni = getattr(self.cluster, "universe", None)
        rmap = getattr(uni, "regions", None) or {}
        if not rmap:
            return []

        def reg(name: str) -> str | None:
            return rmap.get(name)

        barred = {
            reg(i.name)
            for i in list(getattr(uni, "users", ()))
            + list(getattr(uni, "gateways", ()))
        }
        clique_groups = [
            [i.name for i in g]
            for g in (getattr(uni, "shards", None) or [])
            if g
        ] or [[i.name for i in getattr(uni, "servers", ())]]
        storage = [i.name for i in getattr(uni, "storage_nodes", ())]
        out = []
        labels = sorted(
            {
                r
                for k, r in rmap.items()
                if "://" not in k and ":" not in k
            }
        )
        for r in labels:
            if r in barred:
                continue
            ok = all(
                sum(1 for n in g if reg(n) == r) <= (len(g) - 1) // 3
                for g in clique_groups
            )
            if ok and storage:
                ok = (
                    sum(1 for n in storage if reg(n) == r)
                    <= self.cluster.f
                )
            if ok:
                out.append(r)
        return out

    def plan(self, steps: int = 4, kinds: tuple | None = None) -> list[dict]:
        """Pure function of (seed, cluster shape): the schedule replays
        identically run to run.  ``kinds`` restricts the step pool
        (the slow_node-heavy CI soak uses it).

        ``stale_replay`` targets only the storage plane: single reads
        fan out to the read complement ``R = {Vi} − {Ci}`` (wotqs), so
        a read-replayer programmed onto a *quorum* server would never
        receive a read — a fault that cannot manifest exercises
        nothing and is undetectable by construction.

        ``slow_node`` is the gray failure: the member stays ALIVE and
        honest but every inbound link to it is delayed (~5-10x a
        loopback p99); the ``write_sign`` mode is the gray colluder —
        prompt on every command except the one on the write's critical
        path."""
        rng = random.Random(self.seed)
        kinds = tuple(kinds) if kinds else STEP_KINDS
        targets = sorted(self.cluster.names(storage_only=True))
        uni = getattr(self.cluster, "universe", None)
        storage = sorted(
            i.name for i in getattr(uni, "storage_nodes", ())
        ) or targets
        clique = sorted(
            i.name for i in getattr(uni, "servers", ())
        ) or targets
        # write_sign-mode gray colluders must sit in the staged WRITE
        # wave or the fault cannot manifest (the staged fan-out asks
        # the first 2f+1 clique members of the owner shard; a member
        # outside that prefix never receives a WRITE_SIGN at all —
        # same honesty rule as stale_replay's storage-plane scoping).
        shard_groups = [
            [i.name for i in g]
            for g in (getattr(uni, "shards", None) or [])
            if g
        ] or [clique]
        ws_pool = []
        for names in shard_groups:
            f_g = (len(names) - 1) // 3
            ws_pool += names[: 2 * f_g + 1]
        ws_pool = ws_pool or clique
        # Edge gateways join the link-fault pools: a partition or delay
        # on a gateway's links IS the gateway↔quorum fault class (its
        # upstream fan-outs carry its own link id).
        gw_names = sorted(
            getattr(self.cluster, "gateway_names", lambda: [])()
        )
        # route_flap needs ≥ 2 shards AND the autopilot (it ships the
        # epoch-N+1 table); unsupported configs degrade the kind to a
        # partition so a seeded plan stays runnable everywhere.
        flap_ok = (
            self._want_autopilot
            and len(getattr(uni, "shards", None) or []) > 1
        )
        client_names = sorted(
            getattr(c.self_node, "name", f"u{i + 1:02d}")
            for i, c in enumerate(
                getattr(self.cluster, "clients", []) or []
            )
        ) or ["u01"]
        region_pool = self._region_pool()
        out = []
        for i in range(steps):
            kind = kinds[rng.randrange(len(kinds))]
            if kind == "route_flap" and not flap_ok:
                kind = "partition"
            if kind == "sidecar_crash" and self.sidecar_ctl is None:
                # No embedded sidecar armed: degrade like route_flap
                # so one seeded plan stays runnable everywhere.
                kind = "partition"
            if kind == "overload" and self._overload_queue() is None:
                # No admission-bearing component (no sidecar, no
                # gateways): nothing to clamp — degrade, same rule.
                kind = "partition"
            if kind == "region_partition" and not region_pool:
                # No eligible region (map not installed, or every
                # region hosts clients/gateways or exceeds a plane's
                # node-level f): degrade, same rule as route_flap.
                kind = "partition"
            if kind == "region_partition":
                pool = region_pool
            elif kind == "overload":
                pool = [self._overload_queue()[1]]
            elif kind == "sidecar_crash":
                pool = ["sidecar01"]
            elif kind == "route_flap":
                # The held-back principal is a CLIENT: its writes keep
                # routing on epoch N, land on the old owner, and must
                # re-route off the hinted decline — the fault class the
                # epoch_stale counter and epoch_skew anomaly exist for.
                pool = client_names
            elif kind == "stale_replay":
                pool = storage
            elif kind == "slow_node":
                # Gray CLIQUE members are the interesting case: they
                # sit on the WRITE_SIGN critical path.
                mode = ("all", "write_sign")[rng.randrange(2)]
                pool = ws_pool if mode == "write_sign" else clique
            elif kind in ("partition", "link_delay") and gw_names:
                pool = targets + gw_names
            else:
                pool = targets
            step = {"step": i, "kind": kind, "target": pool[rng.randrange(len(pool))]}
            if kind == "clock_skew":
                step["delta"] = rng.choice([-1000, 1000, 1 << 20])
            elif kind == "link_delay":
                step["seconds"] = round(0.01 + 0.04 * rng.random(), 4)
            elif kind == "slow_node":
                step["seconds"] = round(0.4 + 0.3 * rng.random(), 3)
                step["mode"] = mode
            out.append(step)
        return out

    # -- primitives --------------------------------------------------------

    def partition(self, isolated: str, rule_id: str = "") -> list[fp.Rule]:
        """Cut every link to/from ``isolated`` (peers AND clients)."""
        name = isolated

        def cut(ctx: dict) -> bool:
            return ctx.get("src") == name or ctx.get("dst") == name

        return [
            self.registry.add(
                "transport.send",
                "drop",
                match=cut,
                rule_id=rule_id or f"partition:{name}",
            )
        ]

    def region_partition(
        self, region: str, rule_id: str = ""
    ) -> list[fp.Rule]:
        """Whole-region WAN outage: every link CROSSING the region
        boundary is cut, both directions, while intra-region links
        stay up — a region loses its egress, not its LAN.  Fleet
        probes carry no region label, so they count as outside traffic
        and observe the cut like any external health checker."""
        from bftkv_tpu_torch import regions as rg

        def cut(ctx: dict) -> bool:
            a = rg.region_of(ctx.get("src") or "")
            b = rg.region_of(ctx.get("dst") or "")
            return (a == region) != (b == region)

        return [
            self.registry.add(
                "transport.send",
                "drop",
                match=cut,
                rule_id=rule_id or f"region_partition:{region}",
            )
        ]

    def link_delay(
        self, target: str, seconds: float, rule_id: str = ""
    ) -> list[fp.Rule]:
        return [
            self.registry.add(
                "transport.send",
                "delay",
                match={"dst": target},
                seconds=seconds,
                max_seconds=seconds * 3,
                rule_id=rule_id or f"delay:{target}",
            )
        ]

    def slow_node(
        self,
        target: str,
        seconds: float,
        mode: str = "all",
        rule_id: str = "",
    ) -> list[fp.Rule]:
        """Gray failure: ``target`` stays alive and honest, but every
        inbound post to it is delayed.  ``mode="write_sign"`` is the
        gray *colluder* — prompt on every command except WRITE_SIGN,
        so only the collapsed write's critical path suffers (a plain
        liveness probe sees a healthy member)."""
        match: dict = {"dst": target}
        if mode == "write_sign":
            match["cmd"] = "write_sign"
        return [
            self.registry.add(
                "transport.send",
                "delay",
                match=match,
                seconds=seconds,
                max_seconds=seconds * 1.5,
                rule_id=rule_id or f"slow_node:{target}",
            )
        ]

    def _overload_queue(self):
        """``(AdmissionQueue, member label)`` for the overload step —
        the embedded sidecar's admission when armed, else the first
        gateway's — or None when the cluster has neither (plan()
        degrades the step)."""
        if self.sidecar_ctl is not None:
            return self.sidecar_ctl.srv.service.admission, "sidecar01"
        gws = getattr(self.cluster, "gateways", None) or []
        if gws:
            return gws[0].admission, gws[0].self_node.name
        return None

    def overload_burst(self, adm, contenders: int = 4) -> None:
        """One saturated burst against a clamped admission queue: hold
        the only slot, throw contenders at the one queue slot — the
        overflow sheds instantly, the waiters time out, and the wait
        histogram + gauges record the clamp for the capacity plane."""
        held = adm.acquire("chaos-overload")
        threads = [
            threading.Thread(
                target=adm.acquire, args=("chaos-overload",), daemon=True
            )
            for _ in range(contenders)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if held:
            adm.release()

    def clock_skew(
        self, target: str, delta: int, rule_id: str = ""
    ) -> list[fp.Rule]:
        return [
            self.registry.add(
                "server.time",
                "skew",
                match={"node": target},
                delta=delta,
                rule_id=rule_id or f"skew:{target}",
            )
        ]

    def heal(self, rules: list[fp.Rule]) -> None:
        self.registry.remove_all(rules)

    # -- traffic -----------------------------------------------------------

    def _client(self, i: int):
        clients = self.cluster.clients
        return clients[i % len(clients)]

    def traffic(self, tag: str, writes: int = 3, reads: int = 3) -> None:
        """A burst of recorded writes + reads.  Failures are counted,
        not raised: under a partition failing is correct behavior.

        Sharded clusters get COVERAGE traffic on top of the base burst:
        at least one write and one read per shard each window.  A fault
        on a replica only *manifests* when traffic crosses it (a
        partition rule fires on a cut send, a Byzantine handler on an
        arriving request) — without coverage, a window whose random
        keys all routed elsewhere would leave the fault invisible to
        both the checker and the detection assertion."""
        rec = self.cluster.recorder
        cl = self._client(0)
        cname = "u01"
        for i in range(writes):
            var = f"chaos/{tag}/{i}".encode()
            val = f"value-{tag}-{i}".encode()
            self._write_one(cl, rec, cname, var, val)
        shard_of = getattr(cl.qs, "shard_of", None)
        nsh = (
            cl.qs.shard_count()
            if hasattr(cl.qs, "shard_count")
            else 1
        )
        # One small write_many per shard: the batched pipeline keeps
        # the classic BATCH_TIME/SIGN/WRITE rounds, which is the only
        # remaining traffic that crosses ``server.time`` — without it a
        # clock-skew fault could never manifest under collapsed single
        # writes (same honesty rule as stale_replay's storage-plane
        # scoping: an uncrossed fault is undetectable by construction).
        for s in range(nsh) if (shard_of and nsh > 1) else [None]:
            batch: list[tuple[bytes, bytes]] = []
            i = 0
            while len(batch) < 2 and i < 4096:
                v = f"chaos/{tag}/batch/{s}/{i}".encode()
                i += 1
                if s is None or shard_of(v) == s:
                    batch.append((v, f"batch-{tag}-{i}".encode()))
            try:
                res = cl.write_many(batch)
            except Exception as e:
                res = [e] * len(batch)
            for (v, val), err in zip(batch, res):
                if err is None:
                    rec.write_ok(cname, v, val)
                    self._written[v] = val
                else:
                    rec.write_fail(cname, v, err)
                    self.failures["write"] += 1
        if shard_of is not None and nsh > 1:
            covered = {
                shard_of(f"chaos/{tag}/{i}".encode())
                for i in range(writes)
            }
            i = 0
            while len(covered) < nsh and i < 4096:
                var = f"chaos/{tag}/cover/{i}".encode()
                i += 1
                s = shard_of(var)
                if s in covered:
                    continue
                covered.add(s)
                self._write_one(
                    cl, rec, cname, var, f"cover-{tag}".encode()
                )
        if self._gwc is not None:
            self._gateway_traffic(tag)
        if self.workload is not None:
            self._workload_traffic(writes + reads)
        # str seeds hash via sha512 (deterministic); a tuple seed would
        # go through PYTHONHASHSEED-salted hash() and break replay.
        rng = random.Random(f"{self.seed}|{tag}")
        candidates = sorted(self._written)
        picks = [
            candidates[rng.randrange(len(candidates))]
            for _ in range(min(reads, len(candidates)))
        ]
        if shard_of is not None and nsh > 1:
            # One read per shard (newest written var of each), so a
            # read-path fault (stale replayer) sees traffic too.
            per_shard: dict = {}
            for var in candidates:
                per_shard[shard_of(var)] = var
            picks += [
                v
                for s, v in sorted(per_shard.items())
                if not any(shard_of(p) == s for p in picks)
            ]
        for var in picks:
            try:
                rec.read_ok(cname, var, cl.read(var))
            except Exception as e:
                rec.read_fail(cname, var, e)
                self.failures["read"] += 1

    def _gateway_traffic(self, tag: str) -> None:
        """Per-window front-door traffic: one coalesced write + its
        read-back (write-through cache), plus a quorum FILL of the
        newest directly-written variable — so gateway↔quorum faults
        and Byzantine fill attempts have certified-cache traffic to
        cross in every window.  Failures count, never raise (under a
        partitioned gateway failing is correct).  The gateway keyspace
        (``chaos/gw/``) is disjoint from the direct clients' — TOFU
        ownership pins a variable to one writing identity."""
        rec = self.cluster.recorder
        gwc = self._gwc
        cname = "gw"
        self._gw_seq += 1
        var = f"chaos/gw/{tag}/{self._gw_seq}".encode()
        val = f"gw-{tag}".encode()
        try:
            gwc.write(var, val)
            rec.write_ok(cname, var, val)
            self._written[var] = val
        except Exception as e:
            rec.write_fail(cname, var, e)
            self.failures["write"] += 1
        reads = [var]
        if self._last_direct_var is not None:
            # The newest direct var: a COLD quorum fill every window,
            # crossing whatever fault (Byzantine replayer, cut link)
            # is armed on the gateway↔quorum path.
            reads.append(self._last_direct_var)
        for rv in reads:
            try:
                rec.read_ok(cname, rv, gwc.read(rv))
            except Exception as e:
                rec.read_fail(cname, rv, e)
                self.failures["read"] += 1

    def _workload_traffic(self, n: int) -> None:
        """Drain the next ``n`` ops of the ``--workload`` spec stream
        through the recorded-traffic plane.  The stream position
        advances monotonically across windows — op ``g`` is always op
        ``g``, so one seed replays one schedule regardless of window
        count or fault outcome.  Writes are recorded for the checker;
        reads of never-written ranks execute but stay unrecorded (a
        quorum miss carries no invariant).  TOFU holds by construction:
        owner slot ``o`` is always written by client ``o % clients``."""
        spec = self.workload
        rec = self.cluster.recorder
        clients = self.cluster.clients
        for g in range(self._wl_cursor, self._wl_cursor + n):
            op = spec.op_at(g)
            idx = op.owner % len(clients)
            cl = clients[idx]
            cname = f"u{idx + 1:02d}"
            var = spec.key_bytes(op.owner, op.rank)
            if op.kind == "write":
                val = (b"wl-%d" % g).ljust(min(op.size, 1024), b".")
                self._write_one(cl, rec, cname, var, val)
            elif op.kind == "write_many":
                val = (b"wlm-%d" % g).ljust(min(op.size, 1024), b".")
                items = [
                    (spec.key_bytes(op.owner, op.rank + j), val)
                    for j in range(min(spec.wm_batch, 4))
                ]
                try:
                    res = cl.write_many(items)
                except Exception as e:
                    res = [e] * len(items)
                for (v, vv), err in zip(items, res):
                    if err is None:
                        rec.write_ok(cname, v, vv)
                        self._written[v] = vv
                    else:
                        rec.write_fail(cname, v, err)
                        self.failures["write"] += 1
            elif op.kind == "scan":
                keys = [
                    spec.key_bytes(op.owner, op.rank + j)
                    for j in range(min(spec.scan_width, spec.keyspace))
                ]
                try:
                    cl.read_many(keys)
                except Exception:
                    self.failures["read"] += 1
            else:  # read | gateway_read (degrades without gateways)
                rdr = (
                    self._gwc
                    if op.kind == "gateway_read" and self._gwc is not None
                    else cl
                )
                rname = "gw" if rdr is self._gwc else cname
                try:
                    got = rdr.read(var)
                    if var in self._written:
                        rec.read_ok(rname, var, got)
                except Exception as e:
                    if var in self._written:
                        rec.read_fail(rname, var, e)
                    self.failures["read"] += 1
        self._wl_cursor += n

    def _write_one(self, cl, rec, cname: str, var: bytes, val: bytes) -> None:
        try:
            cl.write(var, val)
            rec.write_ok(cname, var, val)
            self._written[var] = val
            self._last_direct_var = var
        except Exception as e:
            rec.write_fail(cname, var, e)
            self.failures["write"] += 1

    # -- convergence -------------------------------------------------------

    def converge(self, max_rounds: int = 6) -> bool:
        """Drive anti-entropy rounds until every storage replica's
        digest root agrees (bounded).  Returns True on convergence.

        Sharded clusters converge PER SHARD: replicas of different
        shards hold disjoint keyspace slices by design, so roots are
        compared within each shard group, never across."""
        from bftkv_tpu_torch.sync import SyncDaemon

        replicas = self.cluster.storage_servers or self.cluster.servers

        def group_of(s) -> object:
            idx_of = getattr(s.qs, "shard_index_of", None)
            if idx_of is None:
                return "all"
            idx = idx_of(s.self_node.get_self_id())
            return "all" if idx is None else idx

        def owned_root(s) -> object:
            """The digest root restricted to buckets the replica OWNS:
            after a migration the old owner's moved-bucket copies are
            inert by design (never synced again), so the full-tree
            root would diverge forever without any safety meaning."""
            tree = s._sync_tree()
            owned = getattr(s.qs, "owned_buckets", lambda: None)()
            if owned is None:
                return tree.root()
            return tuple(
                sorted(
                    (b, h)
                    for b, h in tree.buckets().items()
                    if b in owned
                )
            )

        def converged() -> bool:
            roots: dict[object, set] = {}
            for s in replicas:
                roots.setdefault(group_of(s), set()).add(owned_root(s))
            return all(len(r) == 1 for r in roots.values())

        daemons = [
            SyncDaemon(s, interval=999, rng=random.Random(self.seed + i))
            for i, s in enumerate(replicas)
        ]
        for _ in range(max_rounds):
            if converged():
                return True
            for d in daemons:
                try:
                    d.run_round()
                except Exception:
                    pass
        return converged()

    # -- detection (the observability plane under test) --------------------

    def _forced_migration(self) -> None:
        """One forced hot-shard split, executed on a side thread while
        the fault schedule keeps landing.  A pre-copy blocked by an
        active fault window ABORTS without flipping (correct behavior,
        like failing writes under partition) — retried a couple of
        times so the migration completes once the window heals.  A
        migration that never completes is a report (and a run-failing
        violation), never a crash of the nemesis itself."""
        for attempt in range(3):
            try:
                self._migration = self.autopilot.force_split(pace=0.4)
            except Exception as e:
                self._migration = {"ok": False, "error": repr(e)}
                return
            if self._migration.get("ok"):
                return
            time.sleep(1.0 + attempt)

    def _make_collector(self):
        from bftkv_tpu_torch import trace as trmod
        from bftkv_tpu_torch.metrics import registry as mreg
        from bftkv_tpu_torch.obs import FleetCollector, LocalSource

        sources = [
            # server_named resolves through _by_name, so a source keeps
            # following its member across crash-restarts.  Every probe
            # is wrapped to observe armed drop rules (in-process cuts
            # never unregister a transport).
            _ChaosProbeSource(
                LocalSource(
                    name, lambda n=name: self.cluster.server_named(n)
                ),
                self.registry,
            )
            for name in sorted(self.cluster._by_name)
        ]
        for gw in getattr(self.cluster, "gateways", ()):
            sources.append(
                _ChaosProbeSource(
                    LocalSource(gw.self_node.name, lambda gw=gw: gw),
                    self.registry,
                )
            )
        return FleetCollector(
            sources,
            local_metrics=mreg,
            local_tracer=trmod.tracer,
            fp_registry=self.registry,
        )

    def _observe_window(self, step: dict, seq0: int) -> None:
        """Scrape INSIDE the fault window, then the assertion that
        makes chaos a test of the health plane: the injected fault must
        be in the anomaly feed within one scrape interval.  The
        multicast fan-out abandons stragglers at the quorum threshold,
        so the window's last RPC — the one that trips the rule on the
        target — may still be in flight when traffic() returns; the
        bounded re-scrape below IS the "one interval" allowance, and
        the fault stays armed throughout.

        ``hit()`` returns the MATCHED anomaly kind (or a vacuous
        marker), not just a bool: the flight-recorder oracle below
        needs to know which anomaly this window's bundle must name."""
        if self.collector is None:
            return
        kind, target = step["kind"], step["target"]
        rec = self.recorder
        bundles0: set = set()
        if rec is not None:
            # New coalescing epoch: this window's anomalies mint ONE
            # fresh bundle (follow-ups amend it), never share the
            # previous window's.
            rec.mark_window()
            bundles0 = set(rec.bundles())

        def hit() -> str | None:
            fresh = self.collector.anomalies(since_seq=seq0)
            if kind == "route_flap":
                # The stale-routed client's declined writes surface as
                # the old owner's server.epoch_stale counter delta →
                # epoch_skew anomaly (source is the process-wide
                # metrics feed on loopback clusters, so kind alone is
                # the match).
                if any(a["kind"] == "epoch_skew" for a in fresh):
                    return "epoch_skew"
                return None
            if kind == "sidecar_crash":
                # The crypto service died: tenants must notice — the
                # breaker-open counter delta maps to sidecar_down in
                # the feed (sidecar_dishonest would also count: either
                # way the plane flagged the service).
                for a in fresh:
                    if a["kind"] in ("sidecar_down", "sidecar_dishonest"):
                        return a["kind"]
                return None
            if kind == "overload":
                # The clamped admission tier must surface through the
                # capacity plane's hysteresis: a resource_saturated
                # anomaly naming admission (the gauges ride the
                # process-wide feed, so kind+detail is the match).
                for a in fresh:
                    if (
                        a["kind"] == "resource_saturated"
                        and "admission" in a["detail"]
                    ):
                        return "resource_saturated"
                return None
            if kind == "region_partition":
                # The outage must be named AS a region event: the
                # region_down anomaly carries the region-level budget
                # arithmetic (f_regions - dark < 0, DESIGN.md §21).
                # State form: the rollup reports the region dark at
                # scrape time — consecutive windows on one region
                # never transition back to up in between.
                for a in fresh:
                    if (
                        a["kind"] == "region_down"
                        and a["source"] == target
                    ):
                        return "region_down"
                regs = self.collector.health().get("regions") or {}
                row = (regs.get("rows") or {}).get(target)
                if row and row.get("dark"):
                    return "region_down"
                return None
            if kind == "crash_restart":
                # The plane "sees" an outage either as a fresh
                # member_down transition or as the member simply BEING
                # down at scrape time — consecutive crash windows on
                # one target never transition back to up in between,
                # so the transition alone would under-report.
                m = self.collector.members.get(target)
                if m is not None and m.status == "down":
                    return "member_down"
                if any(
                    a["kind"] == "member_down" and a["source"] == target
                    for a in fresh
                ):
                    return "member_down"
                return None
            if kind == "slow_node":
                # A gray member surfaces three ways: the injected-fault
                # echo (fp registry); a gray_member anomaly from the
                # transport.peer.slow delta, attributed to the peer in
                # the detail string (the counter is recorded client-
                # side, so the scrape source is the process); or the
                # member simply BEING flagged gray at observe time —
                # health-aware staging ranks a still-gray member out of
                # the wave, so consecutive windows on one target may
                # see no fresh traffic at all (the crash_restart
                # being-down-at-scrape rule, gray form).
                from bftkv_tpu_torch import transport as _tp

                try:
                    srv = self.cluster.server_named(target)
                    addr = getattr(srv.self_node, "address", "")
                except Exception:
                    addr = ""
                if addr and _tp.peer_latency.is_gray(addr):
                    return "gray_member"
                for a in fresh:
                    if a["kind"] == "fault" and a["source"] == target:
                        return "fault"
                    if (
                        a["kind"] == "gray_member"
                        and target in a["detail"]
                    ):
                        return "gray_member"
                # Vacuous window: the delay rule never FIRED — health-
                # aware staging (or an earlier gray verdict whose flag
                # has since decayed) kept every post off the target.
                # An uncrossed fault is undetectable by construction
                # (the plan()'s honesty rule), so a zero-fire window
                # counts as detected; when the rule DID fire, only the
                # real channels above count — a crossed fault must
                # surface in the health feed.
                fired = any(
                    e.rule_id == f"slow_node:{target}"
                    and e.seq > step.get("_fp_seq0", 0)
                    for e in self.registry.trace()
                )
                return None if fired else "vacuous"
            if any(
                a["kind"] == "fault" and a["source"] == target
                for a in fresh
            ):
                return "fault"
            return None

        matched = None
        # Generous tail (~6 s worst case, first scrape usually wins):
        # under 2-CPU contention an abandoned straggler post — the one
        # carrying the only RPC that trips the rule on the target — can
        # sit queued behind the writers for whole seconds.
        for attempt in range(24):
            if attempt:
                time.sleep(0.25)
            self.collector.scrape_once()
            matched = hit()
            if matched:
                break
        entry = {
            "step": step["step"], "kind": kind, "target": target,
            "detected": matched is not None, "anomaly": matched,
        }
        if rec is not None and matched and matched != "vacuous":
            # The bundle-per-fault oracle: this window must have minted
            # exactly one bundle whose manifest names the matched
            # anomaly.  Detections via member STATE (down/gray at
            # scrape, no fresh anomaly event) take a demand snapshot
            # naming the verdict — the black box records what the
            # plane concluded, however it concluded it.
            new = sorted(set(rec.bundles()) - bundles0)
            if not new:
                rec.snapshot(
                    reason=f"step{step['step']}-{kind}",
                    anomalies=[{
                        "kind": matched,
                        "source": target,
                        "detail": "state-detected at scrape",
                    }],
                )
                new = sorted(set(rec.bundles()) - bundles0)
            kinds: set = set()
            for b in new:
                try:
                    from bftkv_tpu_torch.obs.recorder import read_manifest

                    kinds.update(
                        str(a.get("kind"))
                        for a in read_manifest(b).get("anomalies", [])
                    )
                except (OSError, ValueError):
                    pass
            entry["bundles"] = len(new)
            entry["bundle_anomalies"] = sorted(kinds)
            # Any anomaly kind that validly evidences THIS fault kind
            # satisfies the oracle, not just the one hit() matched
            # first: a slow_node verdict may be state-detected as
            # gray_member while the window's bundle was minted by the
            # equally-valid "fault" echo event — that bundle IS the
            # black box of this window, not a miss.
            ok_kinds = _BUNDLE_OK_KINDS.get(kind, {"fault"}) | {matched}
            if len(new) != 1 or not (kinds & ok_kinds):
                self.recorder_missing.append(dict(entry))
        self.detection.append(entry)

    # -- one full run ------------------------------------------------------

    def run_step(self, step: dict, dwell: float = 0.0) -> None:
        kind, target = step["kind"], step["target"]
        tag = f"s{step['step']}-{kind}"
        seq0 = (
            self.collector._anomaly_seq if self.collector is not None else 0
        )
        if kind == "partition":
            rules = self.partition(target)
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
                if dwell:
                    time.sleep(dwell)
            finally:
                self.heal(rules)
        elif kind == "region_partition":
            w0 = self.failures["write"]
            rules = self.region_partition(target)
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
                if dwell:
                    time.sleep(dwell)
            finally:
                self.heal(rules)
            if self.failures["write"] > w0:
                # The pool admits only regions whose seats fit every
                # plane's node-level f, so a whole-region outage may
                # slow writes (cross-region hedges), never fail them —
                # the DESIGN.md §21 acceptance bar.
                self.region_blocked.append(
                    {
                        "step": step["step"],
                        "region": target,
                        "failed_writes": self.failures["write"] - w0,
                    }
                )
        elif kind == "crash_restart":
            self.cluster.crash(target)
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
                if dwell:
                    time.sleep(dwell)
            finally:
                self.cluster.restart(target)
                if self.autopilot is not None:
                    # A restarted replica boots at epoch 0; re-deliver
                    # the current table or it would resurrect HRW
                    # routing for buckets that migrated away.
                    self.autopilot.reconcile()
        elif kind == "clock_skew":
            rules = self.clock_skew(target, step["delta"])
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
            finally:
                self.heal(rules)
        elif kind == "link_delay":
            rules = self.link_delay(target, step["seconds"])
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
            finally:
                self.heal(rules)
        elif kind == "slow_node":
            w0 = self.failures["write"]
            ev = self.registry.trace()
            step["_fp_seq0"] = ev[-1].seq if ev else 0
            rules = self.slow_node(
                target, step["seconds"], step.get("mode", "all")
            )
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
            finally:
                self.heal(rules)
            if self.failures["write"] > w0:
                # ≤f gray members may make a write SLOW, never make it
                # FAIL — the hedging/health-staging acceptance bar.
                self.gray_blocked.append(
                    {
                        "step": step["step"],
                        "target": target,
                        "mode": step.get("mode", "all"),
                        "failed_writes": self.failures["write"] - w0,
                    }
                )
        elif kind == "sidecar_crash":
            w0 = self.failures["write"]
            self.sidecar_ctl.crash()
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
                if dwell:
                    time.sleep(dwell)
            finally:
                self.sidecar_ctl.restart()
            if self.failures["write"] > w0:
                # The sidecar is an OPTIMIZER: its death may slow
                # writes (local crypto), never fail them.
                self.sidecar_blocked.append(
                    {
                        "step": step["step"],
                        "failed_writes": self.failures["write"] - w0,
                    }
                )
        elif kind == "overload":
            # The saturation oracle: clamp a real admission queue to
            # one slot, drive bursts past it for BFTKV_SAT_SCRAPES
            # consecutive scrapes, and require the capacity plane's
            # resource_saturated anomaly (DESIGN.md §20) to name the
            # clamped resource in the feed — the chaos-side proof that
            # the USE hysteresis fires on genuine induced overload,
            # not just in unit tests.
            adm, _label = self._overload_queue()
            saved = (adm.max_inflight, adm.max_queue, adm.max_wait)
            adm.max_inflight, adm.max_queue, adm.max_wait = 1, 1, 0.05
            try:
                k = max(flags.get_int("BFTKV_SAT_SCRAPES") or 3, 1)
                for _ in range(k + 1):
                    self.overload_burst(adm)
                    if self.collector is not None:
                        self.collector.scrape_once()
                self.traffic(tag)
                self._observe_window(step, seq0)
            finally:
                (
                    adm.max_inflight,
                    adm.max_queue,
                    adm.max_wait,
                ) = saved
        elif kind == "stale_replay":
            rules = byzantine.make_stale_replayer(self.registry, target)
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
            finally:
                self.registry.remove_all(rules)
        elif kind == "collude":
            rules = byzantine.make_colluder(self.registry, target)
            try:
                self.traffic(tag)
                self._observe_window(step, seq0)
            finally:
                self.registry.remove_all(rules)
        elif kind == "route_flap":
            self._route_flap(step, tag, seq0)
        else:  # pragma: no cover
            raise ValueError(f"unknown step kind {kind!r}")

    def _route_flap(self, step: dict, tag: str, seq0: int) -> None:
        """Epoch N+1 delivered to everyone EXCEPT ``target`` (a
        client) for one window: the window's own traffic keys are the
        moving buckets, so the stale client's writes land on the old
        owner, decline with the routing hint, and must re-route
        in-round — surfacing as ``server.epoch_stale`` →
        ``epoch_skew`` in the health feed.  Healing delivers the
        held-back table."""
        from bftkv_tpu_torch.quorum.wotqs import route_bucket

        ap = self.autopilot
        target = step["target"]
        cl = self._client(0)
        qs = cl.qs
        nsh = qs.shard_count()
        owner = qs.effective_route()
        shard_of = qs.shard_of
        # Candidate moving buckets: this window's OWN write keys (the
        # three singles plus the per-shard batch keys traffic() will
        # select with the same arithmetic).  Buckets holding HISTORY
        # are excluded — an abrupt flip ships no pre-copy, so moving a
        # populated bucket would strand its records at the old owner
        # (readers route to the new one); fresh-key buckets carry
        # nothing and the fault still manifests on this window's
        # writes.  Real migrations move populated buckets through the
        # full pre-copy/dual/drain machinery instead.
        candidates = [f"chaos/{tag}/{i}".encode() for i in range(3)]
        for s in range(nsh):
            picked, i = 0, 0
            while picked < 2 and i < 4096:
                v = f"chaos/{tag}/batch/{s}/{i}".encode()
                i += 1
                if shard_of(v) == s:
                    candidates.append(v)
                    picked += 1
        forbidden = {route_bucket(v) for v in self._written}
        forbidden.add(route_bucket(b"chaos/once"))
        assign = {}
        for v in candidates:
            b = route_bucket(v)
            if b in forbidden:
                continue
            assign[b] = (owner[b] + 1) % nsh
        # Issued through the autopilot's linearized table issuer, so a
        # concurrently in-flight migration can neither mint the same
        # epoch nor lose its moves to this table.
        rt = ap.issue_table(assign, dual=False)
        ap.suppressed.add(target)
        try:
            ap.distribute(rt)
            self.traffic(tag)
            self._observe_window(step, seq0)
        finally:
            ap.suppressed.discard(target)
            ap.distribute(rt)  # heal: the held-back member catches up

    def run(
        self,
        steps: int = 4,
        dwell: float = 0.0,
        detect: bool = True,
        kinds: tuple | None = None,
    ) -> dict:
        """Arm, execute the seeded plan with traffic, repair, check.
        Returns a report dict (``violations`` empty = safe run;
        ``undetected`` empty = every fault surfaced in the health
        plane's anomaly feed within its own window; ``gray_blocked``
        empty = no slow_node window ever blocked a commit)."""
        if self._want_autopilot:
            raise RuntimeError(f"the autopilot {AUTOPILOT_NOT_PORTED}")
        plan = self.plan(steps, kinds=kinds)
        # Shard layout before the run: if it survives unchanged (no
        # membership churn rerouted the keyspace), the checker may apply
        # the strict one-shard-per-variable invariant.
        shard_map_before = self.cluster.shard_map()
        self.registry.arm(self.seed)
        self.wan = None
        if self.rtt_spec:
            # Arm cleared the rule table; compile the deployment
            # geography onto it FIRST — quiet background rules, so a
            # fault rule armed later at the same point always wins and
            # the trace/anomaly feed stays fault-only (DESIGN.md §21).
            from bftkv_tpu_torch.regions.topology import install_matrix

            self.wan = install_matrix(self.registry, self.rtt_spec)
        self.detection = []  # a re-run must not inherit stale verdicts
        self.gray_blocked = []
        self.sidecar_blocked = []
        self.region_blocked = []
        self.recorder_missing = []
        self._migration = None
        self.collector = self._make_collector() if detect else None
        self.recorder = None
        if self.collector is not None and flags.enabled(
            "BFTKV_FLIGHT_RECORDER"
        ):
            import tempfile

            from bftkv_tpu_torch.obs.recorder import FlightRecorder

            rdir = flags.raw("BFTKV_RECORDER_DIR") or tempfile.mkdtemp(
                prefix="bftkv-nemesis-blackbox-"
            )
            # Bundle-count cap must clear the schedule: one bundle per
            # fault window is the oracle, eviction mid-run would fake a
            # missing bundle.
            self.recorder = FlightRecorder(
                rdir,
                fp_registry=self.registry,
                max_bundles=max(2 * steps + 8, 32),
            ).add_to(self.collector)
        self.autopilot = None
        epoch_of = getattr(
            self._client(0).qs, "route_epoch", lambda: 0
        )
        epoch_before = epoch_of()
        try:
            if self.collector is not None:
                # Baseline scrape: counter-delta anomalies measure from
                # here, and every member's shard seat is on file before
                # the first fault lands.
                self.collector.scrape_once()
            cl = self._client(0)
            once_var, once_val = b"chaos/once", b"immutable"
            cl.write_once(once_var, once_val)
            self.cluster.recorder.write_once_ok("u01", once_var, once_val)
            self.traffic("baseline")
            mig_thread: threading.Thread | None = None
            for i, step in enumerate(plan):
                if (
                    self.autopilot is not None
                    and mig_thread is None
                    and i >= len(plan) // 2
                    and self._client(0).qs.shard_count() > 1
                ):
                    # ONE forced hot-shard migration, paced so the
                    # remaining fault steps land INSIDE the pre-copy /
                    # flip / drain phases — reconfiguration under
                    # chaos is the thing under test.
                    mig_thread = threading.Thread(
                        target=self._forced_migration, daemon=True
                    )
                    mig_thread.start()
                self.run_step(step, dwell=dwell)
            if mig_thread is not None:
                mig_thread.join(timeout=240)
                if mig_thread.is_alive():
                    self._migration = {"ok": False, "error": "timeout"}
            self.traffic("final")
            try:
                self.cluster.recorder.read_ok(
                    "u01", once_var, cl.read(once_var)
                )
            except Exception as e:
                self.cluster.recorder.read_fail("u01", once_var, e)
            # Collapsed writes certify on an async tail; quiesce every
            # client's tails before convergence + the final safety
            # check, so "back-fill still in flight" can never be
            # mistaken for a violation (or mask one).  Gateways write
            # through their own internal clients — drain those too.
            for cl in list(self.cluster.clients) + [
                gw.client for gw in getattr(self.cluster, "gateways", ())
            ]:
                drain = getattr(cl, "drain_tails", None)
                if drain is not None:
                    drain()
            converged = self.converge(
                max_rounds=10 if self.autopilot is not None else 6
            )
            trace = self.registry.trace()
            if self.collector is not None:
                # Post-repair scrape: restarted members flip back to up
                # (member_up anomalies close the windows).
                self.collector.scrape_once()
        finally:
            self.registry.disarm()
        shard_map = self.cluster.shard_map()
        epoch_after = epoch_of()
        routing_changed = epoch_after != epoch_before
        checker = SafetyChecker(
            self.cluster.recorder,
            f=self.cluster.f,
            shard_of_node=shard_map,
            # Strict one-shard-per-variable only when NOTHING rerouted
            # the keyspace: same seats AND same route epoch.  An epoch
            # change legitimately migrates certified history between
            # cliques (invariant 5's weak form still applies).
            routing_stable=(
                shard_map == shard_map_before and not routing_changed
            ),
            routing_changed=routing_changed,
        )
        replicas = self.cluster.storage_servers or self.cluster.servers
        violations = checker.check(replicas)
        # Retirement acceptance is a recorded-history check, not mere
        # absence of errors: every certified record the migrated
        # buckets held must be readable from the new owners.
        if self._migration is not None and not self._migration.get("ok"):
            violations = violations + [
                f"autopilot migration failed: {self._migration}"
            ]
        autopilot_doc = None
        if self.autopilot is not None:
            autopilot_doc = {
                "migration": self._migration,
                "status": self.autopilot.status(),
            }
        return {
            "seed": self.seed,
            "shards": len(set(shard_map.values())) if shard_map else 1,
            "regions": (
                self.cluster.universe.regions and
                sorted({
                    r
                    for k, r in self.cluster.universe.regions.items()
                    if "://" not in k and ":" not in k
                })
                or None
            ),
            "rtt_matrix": (
                self.wan[0].describe() if self.wan else None
            ),
            "route_epoch": epoch_after,
            "workload": (
                {
                    "spec": self.workload.canonical(),
                    "ops_drained": self._wl_cursor,
                }
                if self.workload is not None
                else None
            ),
            "autopilot": autopilot_doc,
            "plan": plan,
            "converged": converged,
            "faults_fired": len(trace),
            "fault_trace": [list(e) for e in trace[:200]],
            "failures": dict(self.failures),
            "violations": violations,
            "detection": self.detection,
            "undetected": [d for d in self.detection if not d["detected"]],
            "gray_blocked": self.gray_blocked,
            "sidecar_blocked": self.sidecar_blocked,
            "region_blocked": self.region_blocked,
            "recorder": (
                {
                    "dir": self.recorder.dir,
                    "bundles": self.recorder.bundle_count,
                    "coalesced": self.recorder.coalesced,
                    "missing": self.recorder_missing,
                }
                if self.recorder is not None
                else None
            ),
            "recorder_missing": self.recorder_missing,
            "anomalies": (
                len(self.collector.anomalies())
                if self.collector is not None
                else None
            ),
        }


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="seeded chaos round against an in-process cluster"
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--servers", type=int, default=4,
                    help="quorum servers per shard")
    ap.add_argument("--rw", type=int, default=4,
                    help="storage nodes per shard")
    ap.add_argument("--shards", type=int, default=1,
                    help="disjoint quorum cliques: faults then straddle "
                         "shard boundaries and the checker enforces the "
                         "cross-shard invariant")
    ap.add_argument("--gateways", type=int, default=0,
                    help="run N edge gateways in-process: every traffic "
                         "window crosses the certified cache (write + "
                         "read-back + cold fill), gateway links join "
                         "the partition/link_delay target pool, and "
                         "checker invariant 3 proves no uncertified "
                         "value was ever served through the cache")
    ap.add_argument("--regions", type=int, default=0,
                    help="label every principal round-robin into N "
                         "regions and install the process region map: "
                         "locality-aware staging gets a geography to "
                         "rank, the fleet collector grows region rows "
                         "with the region-level f-budget, and the "
                         "region_partition kind becomes eligible")
    ap.add_argument("--rtt-matrix",
                    default=flags.raw("BFTKV_WAN_RTT_MATRIX") or "",
                    help="WAN link-delay program (regions/topology.py): "
                         "a named matrix (wan2, wan3) or an RTT spec in "
                         "ms, compiled onto quiet background "
                         "transport.send delay rules so the whole "
                         "schedule runs under deployment geography; "
                         "needs --regions (default: BFTKV_WAN_RTT_MATRIX)")
    ap.add_argument("--workload",
                    default=flags.raw("BFTKV_WORKLOAD") or "",
                    help="drive spec-shaped traffic through every "
                         "window on top of the coverage burst: a "
                         "workload spec `preset[,k=v,...]` "
                         "(bftkv_tpu_torch/workload/spec.py, e.g. "
                         "`storm,seed=7`); the op stream position "
                         "advances across windows so one seed replays "
                         "one schedule (default: BFTKV_WORKLOAD)")
    ap.add_argument("--bits", type=int, default=1024)
    ap.add_argument("--device", default=devmod.DEFAULT,
                    help="where every node's crypto, and the embedded "
                         "sidecar's, runs: cuda:N (default cuda:0) or cpu "
                         "(the plain versions of the kernels)")
    ap.add_argument("--dwell", type=float, default=0.0,
                    help="extra seconds to hold each fault window open")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--no-detect", action="store_true",
                    help="skip the fleet-collector detection assertion "
                         "(safety checking only)")
    ap.add_argument("--kinds", default="",
                    help="comma-separated step-kind pool override "
                         "(e.g. a slow_node-heavy soak: "
                         "--kinds slow_node,link_delay,crash_restart; "
                         "route_flap needs the autopilot: refused)")
    ap.add_argument("--autopilot", action="store_true",
                    help="the topology autopilot under chaos: not ported "
                         "yet (refused, exit 2)")
    ap.add_argument("--storage", choices=["mem", "log"], default="mem",
                    help="replica storage engine: `log` gives every "
                         "replica its own on-disk §19 segment-log "
                         "directory, so crash_restart re-opens the "
                         "SAME log dir (index rebuild + torn-tail "
                         "truncation under chaos)")
    ap.add_argument("--sidecar", action="store_true",
                    help="route the whole cluster's verify+sign through "
                         "an embedded shared crypto sidecar and add the "
                         "sidecar_crash kind to the fault pool: a dead "
                         "sidecar must cost zero failed writes (local "
                         "fallback), surface as the sidecar_down "
                         "anomaly, and reconnect must re-register "
                         "sign-key handles")
    args = ap.parse_args(argv)

    if args.autopilot:
        ap.error(f"--autopilot {AUTOPILOT_NOT_PORTED}")
    kinds = tuple(
        k.strip() for k in args.kinds.split(",") if k.strip()
    ) or None
    if kinds and any(k not in STEP_KINDS for k in kinds):
        ap.error(f"--kinds must draw from {STEP_KINDS}")
    if kinds and "route_flap" in kinds:
        ap.error(f"--kinds route_flap {AUTOPILOT_NOT_PORTED}")
    if kinds and "sidecar_crash" in kinds and not args.sidecar:
        ap.error("--kinds sidecar_crash needs --sidecar")
    if kinds and "region_partition" in kinds and args.regions < 2:
        ap.error("--kinds region_partition needs --regions 2+")
    if args.rtt_matrix and args.regions < 2:
        ap.error("--rtt-matrix needs --regions 2+")
    if args.workload:
        from bftkv_tpu_torch.workload.spec import parse_spec

        try:
            parse_spec(args.workload)
        except ValueError as e:
            ap.error(f"--workload: {e}")
    device = devmod.resolve(args.device)

    # The sidecar's dispatchers are process-global, so it arms BEFORE
    # the cluster boots: every server's share issuance and collective
    # verify then routes through the service under test.
    sidecar_ctl = SidecarHarness(device=device) if args.sidecar else None
    storage_factory = MemStorage
    log_root = None
    if args.storage == "log":
        import tempfile

        from bftkv_tpu_torch.storage.logkv import LogStorage

        log_root = tempfile.TemporaryDirectory(prefix="bftkv-nemesis-log-")
        counter = iter(range(10_000))

        def storage_factory(root=log_root.name):
            # One log dir per replica; crash_restart re-opens the same
            # dir via the harness's reopen() hook.  fsync stays ON —
            # the soak exercises the real durability path; the tiny
            # segment size forces seals + compaction within the run.
            return LogStorage(
                os.path.join(root, f"replica-{next(counter):03d}"),
                segment_bytes=256 * 1024,
            )

    cluster = build_cluster(
        args.servers, 1, args.rw, bits=args.bits, n_shards=args.shards,
        n_gateways=args.gateways, storage_factory=storage_factory,
        n_regions=args.regions, device=device,
    )
    try:
        report = Nemesis(
            cluster, seed=args.seed, autopilot=args.autopilot,
            sidecar_ctl=sidecar_ctl, rtt_spec=args.rtt_matrix or None,
            workload=args.workload or None,
        ).run(
            steps=args.steps, dwell=args.dwell,
            detect=not args.no_detect, kinds=kinds,
        )
    finally:
        cluster.stop()
        if sidecar_ctl is not None:
            sidecar_ctl.stop()
        if log_root is not None:
            for srv in cluster.all_servers:
                close = getattr(srv.storage, "close", None)
                if close is not None:
                    close()
            log_root.cleanup()
    # Lock-order chaos soak (DESIGN.md §16): with BFTKV_LOCKWATCH=1 the
    # whole schedule ran under the runtime lock sanitizer — any cycle in
    # the acquisition-order graph or blocking call under a watched lock
    # fails the soak exactly like a safety violation.
    from bftkv_tpu_torch.devtools import lockwatch

    report["lockwatch"] = (
        lockwatch.report() if lockwatch.enabled() else None
    )
    lockwatch_msg = (
        lockwatch.fail_message() if lockwatch.enabled() else None
    )
    # Workload-armed oracle (DESIGN.md §23): spec-shaped traffic must
    # degrade under faults, never fail.  Coverage-only runs keep the
    # historical count-don't-raise behavior.
    workload_failed_writes = (
        report["failures"]["write"] if report.get("workload") else 0
    )
    failed = bool(
        report["violations"]
        or not report["converged"]
        or report["undetected"]
        or report["gray_blocked"]
        or report["sidecar_blocked"]
        or report["region_blocked"]
        or report["recorder_missing"]
        or workload_failed_writes
        or lockwatch_msg
    )
    if args.json:
        print(json.dumps(report, indent=2, default=repr))
        return 1 if failed else 0
    detected = [d for d in report["detection"] if d["detected"]]
    print(
        f"nemesis seed={report['seed']} shards={report['shards']} "
        f"steps={len(report['plan'])} "
        f"faults_fired={report['faults_fired']} "
        f"failures={report['failures']} converged={report['converged']} "
        f"detected={len(detected)}/{len(report['detection'])}"
    )
    if report.get("autopilot"):
        mig = report["autopilot"]["migration"]
        print(
            f"autopilot: route epoch {report['route_epoch']} · "
            + (
                "no migration ran"
                if mig is None
                else (
                    f"{mig.get('kind', '?')} shard {mig.get('shard')} → "
                    f"{mig.get('targets')} "
                    f"({mig.get('buckets')} buckets) "
                    + ("ok" if mig.get("ok") else "FAILED")
                )
            )
        )
    for v in report["violations"]:
        print(f"VIOLATION: {v}")
    for d in report["undetected"]:
        print(
            f"UNDETECTED: step {d['step']} {d['kind']} on {d['target']} "
            "never surfaced in the health feed"
        )
    for g in report["gray_blocked"]:
        print(
            f"GRAY BLOCKED: step {g['step']} slow_node({g['mode']}) on "
            f"{g['target']} failed {g['failed_writes']} write(s) — a "
            "single gray member must never block commit"
        )
    for s in report["sidecar_blocked"]:
        print(
            f"SIDECAR BLOCKED: step {s['step']} sidecar_crash failed "
            f"{s['failed_writes']} write(s) — a dead crypto sidecar "
            "must degrade to local crypto, never block a write"
        )
    for r in report["region_blocked"]:
        print(
            f"REGION BLOCKED: step {r['step']} region_partition on "
            f"{r['region']} failed {r['failed_writes']} write(s) — an "
            "in-budget whole-region outage must never block a write"
        )
    if report.get("recorder"):
        r = report["recorder"]
        print(
            f"flight recorder: {r['bundles']} bundle(s) "
            f"({r['coalesced']} coalesced) under {r['dir']}"
        )
    for rm in report["recorder_missing"]:
        print(
            f"NO BUNDLE: step {rm['step']} {rm['kind']} on "
            f"{rm['target']} detected as {rm['anomaly']} but the window "
            f"minted {rm.get('bundles', 0)} bundle(s) naming "
            f"{rm.get('bundle_anomalies', [])} — the black box missed it"
        )
    if report["violations"]:
        print("nemesis: SAFETY VIOLATIONS FOUND")
        return 1
    if not report["converged"]:
        print("nemesis: replicas did not converge")
        return 1
    if report["undetected"]:
        print("nemesis: FAULTS INVISIBLE TO THE HEALTH PLANE")
        return 1
    if report["gray_blocked"]:
        print("nemesis: GRAY MEMBER BLOCKED COMMITS")
        return 1
    if report["sidecar_blocked"]:
        print("nemesis: SIDECAR DEATH BLOCKED WRITES")
        return 1
    if report["region_blocked"]:
        print("nemesis: REGION OUTAGE BLOCKED WRITES")
        return 1
    if report["recorder_missing"]:
        print("nemesis: FAULT WINDOWS WITHOUT A FLIGHT-RECORDER BUNDLE")
        return 1
    if workload_failed_writes:
        print(
            f"nemesis: WORKLOAD WRITES FAILED "
            f"({workload_failed_writes}) — spec-shaped load must "
            f"degrade under faults, never fail"
        )
        return 1
    if lockwatch_msg:
        print(lockwatch_msg)
        print("nemesis: LOCKWATCH FINDINGS (cycle or I/O under lock)")
        return 1
    print(
        "nemesis: ok (zero safety violations; every fault window "
        "visible in the health feed; no gray member blocked a commit"
        + ("; lockwatch clean)" if lockwatch.enabled() else ")")
    )
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
