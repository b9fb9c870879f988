"""Chaos safety checker: history recorder + BFT invariants.

Counterpart of ``bftkv_tpu/faults/checker.py``.

The nemesis runs faults; this module decides whether the run *meant*
anything.  A :class:`HistoryRecorder` collects two event streams while
chaos runs:

- **client ops** — the harness records every write / write-once / read
  outcome observed by honest clients;
- **replica persists** — each replica's storage is wrapped in a
  :class:`RecordingStorage` that notes every stored protocol record
  (variable, t, value, completed?) per node.  Observation lives in the
  harness wrapper, not in a core hook: the store under test runs
  unmodified.

After the run :class:`SafetyChecker` evaluates the paper's safety
contract over the whole history plus the replicas' final state:

1. **Write-once immutability** — a variable committed with
   ``write_once`` never reads back as anything else, and no honest
   replica ever persists a different completed value at ``t = 2^64-1``.
2. **Timestamp monotonicity at honest replicas** — the sequence of
   completed records an honest replica persists for one variable never
   goes back in time (Byzantine replicas are exempt: they may store
   anything, the point is that it must not matter).
3. **Read integrity** — every successful read's value is backed by a
   record carrying a *sufficient collective signature* that actually
   verifies against an honest replica's quorum and keyring.  A value
   no sign quorum endorsed appearing at a reader is the smoking gun of
   a safety violation, whatever path it took.
4. **No conflicting commits** — no two different values at the same
   ``(variable, t)`` are each persisted by ``2f+1`` distinct replicas:
   two such sets would both intersect every quorum in an honest
   replica that acked both, which the equivocation checks forbid.

Liveness is deliberately NOT checked: during a partition, failing
writes is the *correct* behavior.  Failures are recorded (the nemesis
reports them) but only safety violations fail a run.
"""

from __future__ import annotations

from typing import Iterable

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch.protocol import MAX_UINT64
from bftkv_tpu_torch.sync.digest import HIDDEN_PREFIX
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = [
    "Event",
    "HistoryRecorder",
    "RecordingStorage",
    "SafetyChecker",
]


class Event:
    """One history entry; ``kind`` ∈ {persist, write_ok, write_once_ok,
    write_fail, read_ok, read_fail}."""

    __slots__ = ("seq", "kind", "fields")

    def __init__(self, seq: int, kind: str, fields: dict):
        self.seq = seq
        self.kind = kind
        self.fields = fields

    def __getattr__(self, name):
        try:
            return self.fields[name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self) -> str:  # pragma: no cover
        return f"Event({self.seq}, {self.kind}, {self.fields})"


class HistoryRecorder:
    """Thread-safe append-only history; one global sequence."""

    def __init__(self):
        self._lock = named_lock("faults.checker")
        self._events: list[Event] = []
        self._seq = 0

    def record(self, kind: str, **fields) -> None:
        with self._lock:
            self._seq += 1
            self._events.append(Event(self._seq, kind, fields))

    def events(self, kind: str | None = None) -> list[Event]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e.kind == kind]

    # -- harness conveniences --------------------------------------------

    def write_ok(self, client: str, variable: bytes, value: bytes) -> None:
        self.record("write_ok", client=client, variable=variable, value=value)

    def write_once_ok(
        self, client: str, variable: bytes, value: bytes
    ) -> None:
        self.record(
            "write_once_ok", client=client, variable=variable, value=value
        )

    def write_fail(
        self, client: str, variable: bytes, err: Exception
    ) -> None:
        self.record("write_fail", client=client, variable=variable, err=err)

    def read_ok(
        self, client: str, variable: bytes, value: bytes | None
    ) -> None:
        self.record("read_ok", client=client, variable=variable, value=value)

    def read_fail(self, client: str, variable: bytes, err: Exception) -> None:
        self.record("read_fail", client=client, variable=variable, err=err)


class RecordingStorage:
    """Storage wrapper: delegates everything, records protocol persists.

    Wrap a replica's storage *before* the server touches it (the sync
    digest tree captures ``server.storage`` lazily).  Survives
    crash-restart by construction — the nemesis hands the same wrapper
    to the restarted server, which is exactly "the same storage dir".
    """

    def __init__(
        self, inner, node: str, recorder: HistoryRecorder, honest: bool = True
    ):
        self.inner = inner
        self.node = node
        self.recorder = recorder
        self.honest = honest

    # -- storage contract -------------------------------------------------

    def read(self, variable: bytes, t: int = 0) -> bytes:
        return self.inner.read(variable, t)

    def versions(self, variable: bytes) -> list[int]:
        return self.inner.versions(variable)

    def keys(self) -> list[bytes]:
        return self.inner.keys()

    def scan(self) -> list[tuple[bytes, int]]:
        return self.inner.scan()

    def write(self, variable: bytes, t: int, value: bytes) -> None:
        self.inner.write(variable, t, value)
        self._record_persist(variable, t, value)

    def write_batch(self, items) -> None:
        """Group-commit seam passthrough: the batch persists through
        the inner engine's one-barrier path when it has one (per-item
        writes otherwise), and EVERY item is recorded — the checker's
        commit-point evidence must not thin out because the persists
        were coalesced."""
        items = list(items)
        wb = getattr(self.inner, "write_batch", None)
        if wb is not None:
            wb(items)
        else:
            for variable, t, value in items:
                self.inner.write(variable, t, value)
        for variable, t, value in items:
            self._record_persist(variable, t, value)

    def _record_persist(self, variable: bytes, t: int, value: bytes) -> None:
        if variable.startswith(HIDDEN_PREFIX):
            return  # threshold-CA shares: not protocol records
        completed = False
        pvalue = None
        try:
            p = pkt.parse(value)
            pvalue = p.value
            completed = p.ss is not None and p.ss.completed
        except Exception:
            pass  # non-record bytes (mal tests): recorded as incomplete
        self.recorder.record(
            "persist",
            node=self.node,
            honest=self.honest,
            variable=variable,
            t=t,
            value=pvalue,
            completed=completed,
        )

    def __getattr__(self, name: str):
        # Optional-seam passthrough (sorted_keys / snapshot_records /
        # reopen / close / ...): capability detection on the wrapper
        # must reflect the inner engine's true surface.
        return getattr(self.inner, name)

    # MalStorage pass-through so byzantine programs keep their side area.
    def mal_write(self, variable: bytes, t: int, value: bytes) -> None:
        mw = getattr(self.inner, "mal_write", None)
        if mw is not None:
            mw(variable, t, value)
        else:
            self.inner.write(variable, t, value)


class SafetyChecker:
    """Evaluates the safety invariants over a recorded history.

    ``shard_of_node`` (replica name -> shard index) activates the
    cross-shard invariant for hash-routed sharded clusters; when
    ``routing_stable`` also holds (the shard layout did not change
    during the run — membership churn reroutes the keyspace, and
    migration then LEGITIMATELY copies a variable between shards), the
    strict form applies: a variable never commits certified values in
    two different shards at all."""

    def __init__(
        self,
        recorder: HistoryRecorder,
        f: int,
        shard_of_node: dict[str, int] | None = None,
        routing_stable: bool = False,
        routing_changed: bool = False,
    ):
        self.recorder = recorder
        self.f = f
        self.shard_of_node = shard_of_node
        self.routing_stable = routing_stable
        #: A route-table epoch advanced during the run (autopilot split
        #: / retirement / route_flap): invariant 3's backing signature
        #: may then legitimately verify against the clique that owned
        #: the bucket when the value committed, not the current owner —
        #: the read-integrity search widens to every shard's quorum.
        #: Invariant 5 (no cross-shard equivocation) is untouched.
        self.routing_changed = routing_changed

    def check(self, honest_servers: Iterable) -> list[str]:
        """Returns human-readable violations (empty = safe run).
        ``honest_servers``: the honest replica Server objects, used for
        final-state lookups and collective-signature verification."""
        servers = list(honest_servers)
        out: list[str] = []
        out += self._check_write_once(servers)
        out += self._check_monotonic()
        out += self._check_read_integrity(servers)
        out += self._check_conflicting_commits()
        if self.shard_of_node:
            out += self._check_cross_shard()
        return out

    # -- 1. write-once immutability --------------------------------------

    def _check_write_once(self, servers) -> list[str]:
        out = []
        expected: dict[bytes, bytes] = {}
        for e in self.recorder.events():
            if e.kind == "write_once_ok":
                var, val = e.variable, e.value
                if var in expected and expected[var] != val:
                    out.append(
                        f"write-once {var!r} committed twice with different "
                        f"values ({expected[var]!r} then {val!r})"
                    )
                expected.setdefault(var, val)
            elif e.kind == "read_ok" and e.variable in expected:
                if e.value != expected[e.variable]:
                    out.append(
                        f"write-once {e.variable!r} read back as "
                        f"{e.value!r}, expected {expected[e.variable]!r}"
                    )
            elif (
                e.kind == "persist"
                and e.fields.get("honest")
                and e.fields.get("completed")
                and e.t == MAX_UINT64
                and e.variable in expected
                and e.value != expected[e.variable]
            ):
                out.append(
                    f"honest replica {e.node} persisted conflicting "
                    f"write-once value for {e.variable!r}"
                )
        return out

    # -- 2. timestamp monotonicity at honest replicas --------------------

    def _check_monotonic(self) -> list[str]:
        out = []
        latest: dict[tuple[str, bytes], int] = {}
        for e in self.recorder.events("persist"):
            if not e.fields.get("honest") or not e.fields.get("completed"):
                continue
            key = (e.node, e.variable)
            prev = latest.get(key)
            if prev is not None and e.t < prev:
                out.append(
                    f"honest replica {e.node} went back in time on "
                    f"{e.variable!r}: t={prev} then t={e.t}"
                )
            latest[key] = max(prev or 0, e.t)
        return out

    # -- 3. read integrity ------------------------------------------------

    def _check_read_integrity(self, servers) -> list[str]:
        out = []
        seen: set[tuple[bytes, bytes]] = set()
        for e in self.recorder.events("read_ok"):
            if not e.value:  # empty read: nothing claimed, nothing to back
                continue
            key = (e.variable, e.value)
            if key in seen:
                continue
            seen.add(key)
            if not self._value_is_backed(servers, e.variable, e.value):
                out.append(
                    f"read of {e.variable!r} returned {e.value!r} with no "
                    "verifiable collective signature at any honest replica"
                )
        return out

    def _value_is_backed(self, servers, variable: bytes, value: bytes) -> bool:
        for srv in servers:
            try:
                versions = srv.storage.versions(variable)
            except Exception:
                continue
            for t in sorted(versions, reverse=True):
                try:
                    raw = srv.storage.read(variable, t)
                    p = pkt.parse(raw)
                except Exception:
                    continue
                if (
                    p.value != value
                    or p.ss is None
                    or not p.ss.completed
                ):
                    continue
                # Keyed: the signature must verify against the quorum
                # of the shard that OWNS the variable — a value
                # endorsed only by a foreign clique is not backed.
                # After an epoch change (routing_changed) the THEN
                # owner is also acceptable FOR MOVED BUCKETS ONLY:
                # migration moves certified history between cliques by
                # design, but a variable whose bucket never moved must
                # still verify against its one owner — widening the
                # audit fleet-wide would let a cross-shard laundering
                # bug hide behind any unrelated epoch bump.
                quorums = [
                    qm.choose_quorum_for(srv.qs, variable, qm.AUTH)
                ]
                moved = getattr(
                    srv.qs, "bucket_moved", lambda _v: True
                )
                if self.routing_changed and moved(variable):
                    qfs = getattr(srv.qs, "quorum_for_shard", None)
                    nsh = getattr(srv.qs, "shard_count", lambda: 1)()
                    if qfs is not None:
                        # Verify view: the auditor judges signatures
                        # against each clique's own suff, exactly as
                        # migration admission does.
                        quorums += [
                            qfs(i, qm.AUTH, True) for i in range(nsh)
                        ]
                for quorum in quorums:
                    try:
                        srv.crypt.collective.verify(
                            pkt.tbss(raw),
                            p.ss,
                            quorum,
                            srv.crypt.keyring,
                        )
                        return True
                    except Exception:
                        continue
        return False

    # -- 4. no two conflicting values both gather 2f+1 acks ---------------

    def _check_conflicting_commits(self) -> list[str]:
        out = []
        acks: dict[tuple[bytes, int], dict[bytes, set[str]]] = {}
        for e in self.recorder.events("persist"):
            if not e.fields.get("completed") or e.value is None:
                continue
            acks.setdefault((e.variable, e.t), {}).setdefault(
                e.value, set()
            ).add(e.node)
        need = 2 * self.f + 1
        for (var, t), by_value in acks.items():
            committed = [
                v for v, nodes in by_value.items() if len(nodes) >= need
            ]
            if len(committed) > 1:
                out.append(
                    f"conflicting commits at ({var!r}, t={t}): "
                    f"{len(committed)} values each gathered {need}+ acks"
                )
        return out

    # -- 5. cross-shard: one variable, one owner clique --------------------

    def _check_cross_shard(self) -> list[str]:
        """Sharding's new failure mode: shard B's replicas never run
        shard A's equivocation checks, so a split-brain would show up as
        certified state for one variable living in two shards.  Two
        forms, by strength:

        - always: no (variable, t) carries two DIFFERENT certified
          values at honest replicas of two different shards — that is
          cross-shard equivocation, impossible while routing holds (only
          the owner clique will sign x, and every replica's admission
          verifies the collective signature against the owner quorum);
        - when ``routing_stable``: no variable has certified values in
          two shards AT ALL — same-value copies across shards are
          legitimate only as migration after a routing change, which a
          stable run rules out."""
        out = []
        shard_of = self.shard_of_node or {}
        # (variable, t) -> value -> shard set; variable -> shard set.
        by_vt: dict[tuple[bytes, int], dict[bytes, set[int]]] = {}
        by_var: dict[bytes, set[int]] = {}
        for e in self.recorder.events("persist"):
            if not e.fields.get("honest") or not e.fields.get("completed"):
                continue
            shard = shard_of.get(e.node)
            if shard is None or e.value is None:
                continue
            by_vt.setdefault((e.variable, e.t), {}).setdefault(
                e.value, set()
            ).add(shard)
            by_var.setdefault(e.variable, set()).add(shard)
        for (var, t), by_value in by_vt.items():
            if len(by_value) < 2:
                continue
            shard_sets = list(by_value.values())
            spread = set().union(*shard_sets)
            if len(spread) > 1:
                out.append(
                    f"cross-shard equivocation at ({var!r}, t={t}): "
                    f"{len(by_value)} certified values across shards "
                    f"{sorted(spread)}"
                )
        if self.routing_stable:
            for var, shards in by_var.items():
                if len(shards) > 1:
                    out.append(
                        f"variable {var!r} committed certified values in "
                        f"{len(shards)} shards {sorted(shards)} with no "
                        "routing change to explain migration"
                    )
        return out
