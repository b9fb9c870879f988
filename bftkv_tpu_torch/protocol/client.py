"""Protocol client: the replicated-KV state machine, client side
(counterpart of ``bftkv_tpu/protocol/client.py``).

Capability parity with the reference (protocol/client.go:52-546):
- ``write``: Time → Sign → Write three phases (client.go:62-123);
- ``collect_signatures``: self-sign TBS, accumulate a collective
  signature over the AUTH|PEER quorum (client.go:125-170);
- ``read``: fan-out with responses bucketed by ``(t, value)``, early
  return through a result queue once a bucket reaches threshold at the
  max timestamp, then read-repair (``write_back``) and revoke-on-read
  of equivocating signers (client.go:189-353);
- TPA rounds (client.go:359-474) and threshold-signing rounds
  (client.go:480-546) with the ``ERR_CONTINUE`` phase loop.

Device seam: the client is built for one ``device`` (``None``:
``cuda:0``, which raises without CUDA), where its crypt verifies and
where the batched revoke-on-read tally and the TPA modexps run.

Every callback runs on the multicast fan-in thread (one per request),
so per-operation state needs no locks — same discipline as the
reference's closure-over-locals pattern.
"""

from __future__ import annotations

import logging
import queue
import random as _random
import threading
import time

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch import trace
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.crypto import auth as authmod
from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import signature as sigmod
from bftkv_tpu_torch.crypto import vcache
from bftkv_tpu_torch.crypto.threshold import ThresholdAlgo, serialize_params
from bftkv_tpu_torch.errors import (
    error_from_string,
    parse_wrong_shard,
    ERR_CONTINUE,
    ERR_INSUFFICIENT_NUMBER_OF_QUORUM,
    ERR_INSUFFICIENT_NUMBER_OF_RESPONSES,
    ERR_INSUFFICIENT_NUMBER_OF_SECRETS,
    ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES,
    ERR_INSUFFICIENT_NUMBER_OF_VALID_RESPONSES,
    ERR_INVALID_RESPONSE,
    ERR_INVALID_TIMESTAMP,
    ERR_MALFORMED_REQUEST,
    ERR_NO_AUTHENTICATION_DATA,
    ERR_NO_MORE_WRITE,
    ERR_UNKNOWN_COMMAND,
)
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.protocol import MAX_UINT64, Protocol, Ref, majority_error

__all__ = ["Client", "MAX_UINT64"]

log = logging.getLogger("bftkv_tpu_torch.protocol.client")

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

#: Sign rounds fan out to a minimal sufficient prefix first (one
#: private-key op saved per skipped replica per write); ``full``
#: restores the reference's ask-everyone shape.
_STAGED_SIGN_FANOUT = (
    flags.raw("BFTKV_SIGN_FANOUT", "staged") != "full"
)

#: Round-collapsed writes: ONE WRITE_SIGN fan-out replaces the classic
#: time → sign → write rounds; the collective-signature shares ride the
#: acks, the client commits at the write threshold, and the combined
#: signature back-fills on the async tail (DESIGN.md §12).
#: ``BFTKV_PIGGYBACK=off`` restores the classic rounds.
_PIGGYBACK = flags.raw("BFTKV_PIGGYBACK", "on").lower() not in (
    "off", "0", "false",
)

#: Retries of the combined round on stale-timestamp declines before
#: giving the write to the classic path (each retry consumed one
#: quorum hint, so loops mean a genuine write race).
_WS_RETRIES = 3


class _PiggybackFallback(Exception):
    """Internal: this write must re-run on the classic three-round path
    (legacy peers in the quorum, or a persistent timestamp race)."""


def _interleave(a: list, b: list) -> list:
    """a1 b1 a2 b2 ... — puts a minimal commit prefix (sign-quorum
    threshold + write-plane threshold) at the head of the inline
    fan-out, so the caller unblocks after the fewest possible posts."""
    out: list = []
    for i in range(max(len(a), len(b))):
        if i < len(a):
            out.append(a[i])
        if i < len(b):
            out.append(b[i])
    return out

#: write_many pipelining: at most this many chunk write-rounds in
#: flight behind the caller thread's time+sign rounds (1 disables).
_WRITE_PIPELINE_WINDOW = int(
    flags.raw("BFTKV_WRITE_PIPELINE", "2") or 2
)
#: Chunk floor — batches at or below this size stay monolithic, so the
#: server-side device launches stay amortized.
_WRITE_PIPELINE_CHUNK = int(
    flags.raw("BFTKV_WRITE_CHUNK", "256") or 256
)


def _staged_wave(qa, nodes: list | None = None) -> tuple[list, list]:
    """(wave1, rest) for a staged sign fan-out: the minimal prefix of
    the quorum whose full success would already be sufficient, and the
    remainder to ask only on shortfall.  Degenerates to (all, [])
    when staging is disabled or no prefix suffices.  ``nodes``
    overrides the ask order (health-aware staging) — the quorum
    predicates still run over the same member set, so ordering can
    never change *which* thresholds are required."""
    if nodes is None:
        nodes = qa.nodes()
    if _STAGED_SIGN_FANOUT:
        prefix: list = []
        for nd in nodes:
            prefix.append(nd)
            if qa.is_sufficient(prefix):
                return prefix, nodes[len(prefix) :]
    return nodes, []


class _BackfillCoalescer:
    """Batches the async back-fill of certified records into shared
    BATCH_WRITE rounds.

    Every committed collapsed write owes the write plane one delivery
    of its certified record.  Done per write that is a 4-post WRITE
    round — ~40% of the whole write's post budget.  Concurrent writers
    instead enqueue here; one daemon flusher drains the queue with a
    tiny linger, groups records by owning shard (a BATCH_WRITE frame
    must be single-shard: servers verify it against one owner quorum),
    and delivers each group as ONE batched round whose collective
    signatures the servers verify in one device batch.  ``drain()``
    blocks until everything submitted has been delivered — the
    quiescence hook behind ``Client.drain_tails``."""

    LINGER = 0.003
    MAX_BATCH = 128

    def __init__(self, client):
        self.client = client
        self._q: "queue.SimpleQueue[tuple[bytes, bytes]]" = (
            queue.SimpleQueue()
        )
        self._cv = threading.Condition()
        self._pending = 0
        self._thread: threading.Thread | None = None

    def submit(self, variable: bytes, record: bytes) -> None:
        with self._cv:
            self._pending += 1
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="bftkv-backfill"
                )
                self._thread.start()
        self._q.put((variable, record))

    def drain(self, timeout: float | None = 30.0) -> None:
        with self._cv:
            self._cv.wait_for(
                lambda: self._pending == 0, timeout=timeout
            )

    def _run(self) -> None:
        while True:
            try:
                batch = [self._q.get(timeout=5.0)]
            except queue.Empty:
                continue  # daemon thread: cheap to keep parked
            deadline = time.monotonic() + self.LINGER
            while len(batch) < self.MAX_BATCH:
                try:
                    batch.append(
                        self._q.get(
                            timeout=max(0.0, deadline - time.monotonic())
                        )
                    )
                except queue.Empty:
                    break
            try:
                self._flush(batch)
            except Exception:
                log.exception("back-fill flush failed")
            finally:
                with self._cv:
                    self._pending -= len(batch)
                    self._cv.notify_all()

    def _flush(self, batch: list[tuple[bytes, bytes]]) -> None:
        # Group by owning shard: all phases of one record must agree
        # on the clique, and a BATCH_WRITE frame is verified against
        # one owner quorum server-side.
        shard_of = getattr(self.client.qs, "shard_of", None)
        groups: dict[object, list[tuple[bytes, bytes]]] = {}
        for variable, record in batch:
            key = shard_of(variable) if shard_of is not None else None
            groups.setdefault(key, []).append((variable, record))
        for items in groups.values():
            qw = qm.choose_quorum_for(
                self.client.qs, items[0][0], qm.WRITE
            )
            with trace.span(
                "backfill.flush", attrs={"batch": len(items)}
            ):
                self.client.tr.multicast(
                    tp.BATCH_WRITE,
                    qw.nodes(),
                    pkt.serialize_list([rec for _v, rec in items]),
                    None,
                )
            metrics.incr("client.write.backfill", len(items))
            metrics.observe("client.backfill.batch", len(items))


class _SignedValue:
    """One read response: (node, sig, ss, raw packet)
    (reference: client.go:172-177)."""

    __slots__ = ("node", "sig", "ss", "packet")

    def __init__(self, node, sig, ss, packet):
        self.node = node
        self.sig = sig
        self.ss = ss
        self.packet = packet


class _InProgress(Exception):
    """Internal sentinel: no bucket has reached threshold yet
    (reference: errInProgress, client.go:179)."""


#: Neutral per-item outcome: the response neither advances the item's
#: quorum count nor counts as a failure (e.g. a sign share whose signer
#: the client cannot resolve — the single path's combine() likewise
#: keeps waiting without charging the server as failed).
_SKIP = object()


class _BatchTally:
    """Per-item quorum accounting for one batched multicast.

    A server that succeeds on *every* item lands in one shared list, so
    the common case costs a single predicate test per response; per-item
    lists exist only for the (rare) items some server failed or skipped.
    Because ``all_ok`` only holds servers that succeeded on every item,
    it is a subset of every item's ok-set — one passing test covers the
    batch.
    """

    def __init__(self, n: int, predicate, reject):
        self.n = n
        self.predicate = predicate  # is_threshold / is_sufficient
        self.reject = reject
        self.all_ok: list = []
        self.partial: dict[int, list] = {}
        self.fails: dict[int, list] = {}  # i -> [(peer, err)]
        self.done = [False] * n
        self.rejected: list[Exception | None] = [None] * n

    def record(self, peer, per_item_err: list) -> bool:
        """One server's per-item outcomes (``None`` ok, ``_SKIP``
        neutral, exception failed); True = stop the multicast."""
        if all(e is None for e in per_item_err):
            self.all_ok.append(peer)
        else:
            for i, e in enumerate(per_item_err):
                if e is None:
                    self.partial.setdefault(i, []).append(peer)
                elif e is not _SKIP:
                    self.fails.setdefault(i, []).append((peer, e))
        return self._update()

    def fail_server(self, peer, err: Exception | None) -> bool:
        """The whole response failed (transport error, bad codec)."""
        for i in range(self.n):
            self.fails.setdefault(i, []).append((peer, err))
        return self._update()

    def _update(self) -> bool:
        if self.predicate(self.all_ok):
            for i in range(self.n):
                self.done[i] = True
        else:
            for i, extra in self.partial.items():
                if not self.done[i]:
                    self.done[i] = self.predicate(self.all_ok + extra)
            for i, fl in self.fails.items():
                if not self.done[i] and self.rejected[i] is None:
                    if self.reject([p for p, _ in fl]):
                        self.rejected[i] = majority_error(
                            [e for _, e in fl if e is not None],
                            ERR_INSUFFICIENT_NUMBER_OF_VALID_RESPONSES,
                        )
        return all(
            self.done[i] or self.rejected[i] is not None for i in range(self.n)
        )

    def item_error(self, i: int, insufficient) -> Exception | None:
        """Final per-item outcome after the fan-out completed."""
        if self.done[i]:
            return None
        if self.rejected[i] is not None:
            return self.rejected[i]
        return majority_error(
            [e for _, e in self.fails.get(i, []) if e is not None], insufficient
        )


def _batch_cb(tally: _BatchTally, expected: int, per_item_fn):
    """The response-envelope handling shared by the three batch phases:
    transport errors, result-codec errors, and length mismatches are
    whole-server failures; ``per_item_fn(k, payload)`` maps one decoded
    ok-payload to ``None`` / ``_SKIP`` / an exception."""

    def cb(res: tp.MulticastResponse) -> bool:
        if res.err is not None or res.data is None:
            return tally.fail_server(res.peer, res.err)
        try:
            out = pkt.parse_results(res.data)
            if len(out) != expected:
                raise ERR_MALFORMED_REQUEST
        except Exception as e:
            return tally.fail_server(res.peer, e)
        per_item = [
            error_from_string(errstr)
            if errstr is not None
            else per_item_fn(k, payload)
            for k, (errstr, payload) in enumerate(out)
        ]
        return tally.record(res.peer, per_item)

    return cb


class _shard_timer:
    """Latency timer that observes BOTH the unlabeled series (the
    historical key bench.py and single-process consumers read) and,
    when the namespace is sharded, the same series with a ``shard``
    label — the per-shard SLO histograms the fleet collector merges."""

    __slots__ = ("name", "shard", "_t0")

    def __init__(self, name: str, shard: int | None):
        self.name = name
        self.shard = shard

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self._t0
        metrics.observe(self.name, dt)
        if self.shard is not None:
            metrics.observe(self.name, dt, labels={"shard": self.shard})
        return False


class Client(Protocol):
    def __init__(self, self_node, qs, tr, crypt, *, device=None):
        super().__init__(self_node, qs, tr, crypt, device=device)
        from bftkv_tpu_torch.crypto.presession import Presession

        #: Presession material (timestamp leases, warm sessions, signer
        #: maps) — the offline half of the round-collapsed write.
        self._presession = Presession(self)
        #: Peers that answered ERR_UNKNOWN_COMMAND to WRITE_SIGN: old
        #: servers.  A quorum containing one runs the classic rounds.
        self._legacy_peers: set[int] = set()
        #: Outstanding async write tails (certify-repair pushes) and
        #: the back-fill coalescer; ``drain_tails`` quiesces both —
        #: benches, the chaos checker, and tests use it.
        self._tails: list[threading.Thread] = []
        self._tails_lock = named_lock("client.tails")
        self._backfills = _BackfillCoalescer(self)
        #: Optional /fleet member-status hints for health-aware staging
        #: (``apply_fleet_snapshot``); the client's own breaker/latency
        #: state works without them.
        self._health_hints: dict[str, str] = {}
        #: Certified-record observer: ``fn(variable, record)`` called
        #: with every record this client has VERIFIED a completed
        #: collective signature for (the collapsed write's tail, the
        #: batched write's phase-2 output).  The edge gateway hooks its
        #: write-through cache fill here — invalidation rides the same
        #: plane that delivers the certified bytes (DESIGN.md §14).
        self.on_certified = None

    def _notify_certified(self, variable: bytes, record: bytes) -> None:
        cb = self.on_certified
        if cb is None:
            return
        try:
            cb(variable, record)
        except Exception:
            log.exception("on_certified observer failed")

    # -- health-aware staging (DESIGN.md §13) -----------------------------

    def apply_fleet_snapshot(self, health: dict) -> None:
        """Feed a fleet-collector health document
        (``obs.FleetCollector.health()`` / the ``/fleet`` JSON) into
        the staging order: members the fleet plane reports down go to
        the back of every staged wave.  Entirely optional and
        advisory — quorum thresholds are untouched."""
        hints: dict[str, str] = {}
        for sd in (health.get("shards") or {}).values():
            for m in sd.get("members", ()):  # pragma: no branch
                name = m.get("name")
                if name:
                    hints[name] = m.get("status", "")
        self._health_hints = hints

    def _rank_nodes(self, nodes: list) -> list:
        """Health- and locality-aware ask order: open-circuit and
        fleet-reported-down members last, gray (recently slow) members
        next-to-last, then — inside each health class — same-region
        members before cross-region ones (by RTT-matrix distance when
        one is installed; DESIGN.md §21), cold-session peers after
        warm ones.  The sort is stable and keys on health flags and
        region labels only (never raw latency samples), so with no
        health signal and no region map the quorum's own order is
        preserved bit-for-bit — deterministic fan-outs stay
        deterministic.  Ordering only changes which members land in
        the minimal first wave — never which thresholds the quorum
        requires (DESIGN.md §13.3)."""
        from bftkv_tpu_torch import regions as rg

        own = None
        if rg.regionmap.installed() and flags.enabled(
            "BFTKV_REGION_RANK"
        ):
            own = rg.self_region(getattr(self.self_node, "name", None))
        if len(nodes) <= 1 or not (
            tp.hedging_enabled() or own is not None
        ):
            return list(nodes)
        msg = getattr(getattr(self.tr, "security", None), "message", None)
        has_session = getattr(msg, "has_session", None)
        hints = self._health_hints
        plat = tp.peer_latency

        def key(n):
            addr = getattr(n, "address", "") or ""
            down = tp.peer_health.is_open(addr) or (
                hints.get(getattr(n, "name", ""), "") == "down"
            )
            cold = has_session is not None and not has_session(n.id)
            loc = 0.0
            if own is not None:
                other = rg.region_of(
                    getattr(n, "name", None)
                ) or rg.region_of(addr)
                loc = rg.regionmap.rank(own, other)
            return (
                2 if down else (1 if plat.is_gray(addr) else 0),
                loc,
                cold,
            )

        return sorted(nodes, key=key)

    def drain_tails(self, timeout: float | None = 30.0) -> None:
        """Quiesce every outstanding async write tail (bounded)."""
        self._backfills.drain(timeout)
        with self._tails_lock:
            tails = list(self._tails)
        deadline = (
            None if timeout is None else time.monotonic() + timeout
        )
        for th in tails:
            th.join(
                None
                if deadline is None
                else max(0.0, deadline - time.monotonic())
            )
        with self._tails_lock:
            self._tails = [t for t in self._tails if t.is_alive()]

    def _track_tail(self, th: threading.Thread) -> None:
        with self._tails_lock:
            self._tails = [t for t in self._tails if t.is_alive()]
            self._tails.append(th)

    def _shard_label(self, variable: bytes) -> int | None:
        """The owning shard of ``variable`` for metric labels/span
        attrs — None when the namespace is unsharded (no label: the
        unlabeled series IS the whole story there)."""
        shard_of = getattr(self.qs, "shard_of", None)
        if shard_of is None:
            return None
        try:
            return shard_of(variable)
        except Exception:
            return None

    # -- write path (reference: client.go:62-170) -------------------------

    def write(self, variable: bytes, value: bytes, proof=None) -> None:
        """Signed write.  Steady state is the round-collapsed path: ONE
        WRITE_SIGN fan-out (timestamp from the presession lease, shares
        piggybacked on the acks, commit at the write threshold, the
        collective signature back-filled on the async tail).  The
        classic three rounds — collect timestamps from a READ|AUTH
        quorum, then sign + store (reference: client.go:62-92) — remain
        as the fallback for legacy quorums, persistent write races, and
        ``BFTKV_PIGGYBACK=off``."""
        shard = self._shard_label(variable)
        attrs = {"value_bytes": len(value)}
        if shard is not None:
            attrs["shard"] = shard  # slow-trace attribution (trace.py)
        with _shard_timer("client.write.latency", shard), trace.span(
            "client.write", attrs=attrs
        ):
            if self._piggyback_ok(variable):
                try:
                    self._write_piggyback(variable, value, proof)
                    metrics.incr("client.write.ok")
                    return
                except _PiggybackFallback:
                    metrics.incr("client.piggyback.fallback")
            self._with_reroute(
                variable,
                lambda: self._write_classic(variable, value, proof),
            )
            metrics.incr("client.write.ok")

    # -- epoched-routing decline hints (DESIGN.md §15) ---------------------

    def _note_route_hint(self, variable: bytes, epoch, owner) -> bool:
        """Adopt a wrong-shard decline's routing hint: bucket ``x`` is
        owned by shard ``owner`` as of the responder's ``epoch``.  Only
        newer-than-installed epochs stick (quorum-system rule), so a
        Byzantine decline can cost at most one wasted re-route."""
        note = getattr(self.qs, "note_route_hint", None)
        if note is None or epoch is None or owner is None:
            return False
        return note(variable, epoch, owner)

    def _with_reroute(self, variable: bytes, fn):
        """Run one classic-path round sequence, re-routing ONCE when
        the quorum's majority answer is a wrong-shard decline carrying
        a routing hint — the stale-route client's refetch-and-retry:
        the hint re-aims ``choose_quorum_for`` at the owning clique and
        the sequence re-runs there."""
        try:
            return fn()
        except Exception as e:
            ws = parse_wrong_shard(e)
            if ws is None:
                raise
            # The hint may be a no-op (our own table advanced mid-round
            # past the responder's epoch) — the retry below still runs
            # on the CURRENT route, which is exactly the fix then.
            self._note_route_hint(variable, ws[0], ws[1])
            metrics.incr("client.route.rerouted")
            return fn()

    def _write_classic(self, variable: bytes, value: bytes, proof) -> None:
        """The classic three rounds: TIME below, then sign + write."""
        with trace.span("quorum.select"):
            qr = qm.choose_quorum_for(self.qs, variable, qm.READ | qm.AUTH)
        maxt = 0
        actives: list = []
        failure: list = []
        errs: list = []

        def cb(res: tp.MulticastResponse) -> bool:
            nonlocal maxt
            if res.err is None and res.data and len(res.data) <= 8:
                t = int.from_bytes(res.data, "big")
                if t > maxt:
                    maxt = t
                actives.append(res.peer)
                return qr.is_threshold(actives)
            if res.err is not None:
                errs.append(res.err)
            failure.append(res.peer)
            return qr.reject(failure)

        with trace.span("phase.time", attrs={"peers": len(qr.nodes())}):
            self.tr.multicast(tp.TIME, qr.nodes(), variable, cb)
        if not qr.is_threshold(actives):
            # The majority failure (e.g. a hinted wrong-shard decline
            # after an epoch flip) must surface — the reroute wrapper
            # reads the hint off it.
            raise majority_error(errs, ERR_INSUFFICIENT_NUMBER_OF_QUORUM)
        if maxt == MAX_UINT64:
            raise ERR_INVALID_TIMESTAMP
        self._write_with_timestamp(variable, value, maxt + 1, proof)

    def write_once(self, variable: bytes, value: bytes, proof=None) -> None:
        """t = 2^64-1 marks the value immutable forever
        (reference: client.go:90-92).  No timestamp discovery is needed
        in either shape — the ceiling either wins or the variable is
        already sealed — so the collapsed path needs exactly one round
        here too."""
        if self._piggyback_ok(variable):
            try:
                self._write_piggyback(
                    variable, value, proof, t_fixed=MAX_UINT64
                )
                return
            except _PiggybackFallback:
                metrics.incr("client.piggyback.fallback")
        self._with_reroute(
            variable,
            lambda: self._write_with_timestamp(
                variable, value, MAX_UINT64, proof
            ),
        )

    def _write_with_timestamp(
        self, variable: bytes, value: bytes, t: int, proof
    ) -> None:
        sig, ss = self.collect_signatures(variable, value, t, proof)

        qw = qm.choose_quorum_for(self.qs, variable, qm.WRITE)
        data = pkt.serialize(variable, value, t, sig, ss)
        nodes: list = []
        failure: list = []
        errs: list = []

        def cb(res: tp.MulticastResponse) -> bool:
            if res.err is None:
                nodes.append(res.peer)
                return qw.is_threshold(nodes)
            failure.append(res.peer)
            errs.append(res.err)
            return qw.reject(failure)

        with trace.span("phase.write", attrs={"peers": len(qw.nodes())}):
            self.tr.multicast(tp.WRITE, qw.nodes(), data, cb)
        if not qw.is_threshold(nodes):
            raise majority_error(errs, ERR_INSUFFICIENT_NUMBER_OF_RESPONSES)

    def collect_signatures(
        self, variable: bytes, value: bytes, t: int, proof
    ):
        """Self-sign <x,v,t>, then accumulate quorum members' signature
        shares into a collective signature until sufficient
        (reference: client.go:125-170).  Returns ``(sig, ss)``."""
        with trace.span("phase.sign") as sp:
            tbs = pkt.serialize(variable, value, t, nfields=3)
            sig = self.crypt.signer.issue(tbs)
            tbss = pkt.serialize(variable, value, t, sig, nfields=4)

            qa = qm.choose_quorum_for(self.qs, variable, qm.AUTH | qm.PEER)
            sp.attrs["peers"] = len(qa.nodes())
            # The client's auth proof rides in the ss slot of the request
            # (reference: client.go:142).
            req = pkt.serialize(variable, value, t, sig, proof)
            ss = None
            done_flag = [False]
            failure: list = []
            errs: list = []

            def cb(res: tp.MulticastResponse) -> bool:
                nonlocal ss
                err = res.err
                if err is None and res.data is not None:
                    try:
                        share = pkt.parse_signature(res.data)
                        ss, done = self.crypt.collective.combine(
                            ss, share, qa, self.crypt.keyring
                        )
                        done_flag[0] = done
                        return done
                    except Exception as e:
                        err = e
                if err is None:
                    return False
                errs.append(err)
                failure.append(res.peer)
                return qa.reject(failure)

            # Staged fan-out: ask a minimal sufficient prefix first and
            # expand to the rest only if it does not complete.  Every
            # share costs the responder a private-key operation, so the
            # reference's ask-everyone fan-out burns (n - suff) signs
            # per write for shares the combine then discards; safety is
            # untouched — equivocation protection comes from sufficient
            # signer sets intersecting in an honest node, not from how
            # many replicas were *asked* (DESIGN.md §9).  A fault in
            # the first wave costs one extra round to the remainder
            # (BFTKV_SIGN_FANOUT=full restores the old behavior) — or,
            # with a gray peer in the wave, one hedge delay
            # (multicast_staged; DESIGN.md §13).  Health-aware order
            # keeps known-slow/down members out of the first wave.
            wave1, rest = _staged_wave(qa, self._rank_nodes(qa.nodes()))
            stats = tp.multicast_staged(
                self.tr,
                tp.SIGN,
                [wave1, rest],
                req,
                cb,
                need_more=lambda: not done_flag[0],
            )
            if stats["expanded"] or stats["hedged"]:
                metrics.incr("client.sign.fanout_expanded")
            with trace.span("verify.collective"):
                try:
                    self.crypt.collective.verify(
                        tbss, ss, qa, self.crypt.keyring
                    )
                except Exception as e:
                    raise majority_error(errs, e)
            return sig, ss

    # -- round-collapsed write (piggyback; DESIGN.md §12) ------------------

    def _piggyback_ok(self, variable: bytes) -> bool:
        """Whether this write may take the collapsed path: the feature
        is on and no quorum member is a known legacy server."""
        if not _PIGGYBACK:
            return False
        if not self._legacy_peers:
            return True
        qa = qm.choose_quorum_for(self.qs, variable, qm.AUTH | qm.PEER)
        qw = qm.choose_quorum_for(self.qs, variable, qm.WRITE)
        return not any(
            n.id in self._legacy_peers for n in qa.nodes() + qw.nodes()
        )

    def _write_piggyback(
        self, variable: bytes, value: bytes, proof, t_fixed: int | None = None
    ) -> None:
        """The collapsed write: optimistic timestamp from the lease,
        one combined WRITE_SIGN round, bounded decline-driven retries.
        Raises ``_PiggybackFallback`` when the classic rounds must take
        over (legacy peers; a write race outlasting the retry budget)."""
        if t_fixed is not None:
            t = t_fixed
        else:
            # Budget phase "lease" (DESIGN.md §18): what the optimistic
            # timestamp actually costs on the critical path — near-zero
            # when the lease is warm, which is the claim item 3's
            # offline-everything work needs a ruler for.
            with trace.span("presession.lease"):
                t = self._presession.next_t(variable)
        for attempt in range(_WS_RETRIES + 1):
            status, arg = self._ws_round(variable, value, t, proof)
            if status == "commit":
                metrics.incr("client.piggyback.ok")
                self._presession.lease_update(variable, t)
                return
            if status == "reroute":
                # Wrong-shard decline with a NEWER-epoch hint: the hint
                # is noted in the quorum system, so the retry below
                # re-routes this round to the owning clique.  The lease
                # may be aimed at the old owner's history — the new
                # owner's decline-hint loop re-seats it if stale.
                metrics.incr("client.route.rerouted")
                continue
            if status == "retry" and t_fixed is None:
                # Stale lease: the quorum answered with its stored
                # timestamps; retry ONE past the highest.  This in-round
                # exchange is what replaced the TIME round.  A hint AT
                # our own guess means a live racer — jitter before
                # retrying, or two lockstep writers can split the
                # clique 2f+1-less forever (the legacy rounds broke the
                # tie by failing one writer's sign outright; declines
                # are gentler, so the tie-break must be explicit).
                metrics.incr("client.piggyback.retry_t")
                self._presession.lease_update(variable, arg)
                if arg >= t:
                    time.sleep(_random.random() * 0.004 * (attempt + 1))
                t = arg + 1
                continue
            if status == "fallback":
                raise _PiggybackFallback
            if status == "retry":
                # t_fixed is set (write_once): an honest replica never
                # declines t = 2^64-1, so a hint here is a Byzantine or
                # inconsistent answer — give the write to the classic
                # rounds rather than looping on a fixed timestamp.
                raise _PiggybackFallback
            if t_fixed is None and arg == ERR_NO_MORE_WRITE:
                # Keep the client contract of the classic rounds: a
                # normal write of a sealed (write-once) variable fails
                # with the TIME phase's ERR_INVALID_TIMESTAMP
                # (reference: client.go:85-87).
                raise ERR_INVALID_TIMESTAMP
            raise arg
        raise _PiggybackFallback  # persistent race: let TIME arbitrate

    def _ws_round(
        self, variable: bytes, value: bytes, t: int, proof
    ) -> tuple[str, object]:
        """One combined round, driven on the CALLER thread.

        The fan-out asks a minimal *wave* first — the shortest prefix of
        the interleaved sign∪write quorum whose full success already
        commits (2f+1 clique + write-plane threshold) AND reaches
        ``suff`` shares — so the steady state costs exactly one
        private-key op per wave-1 clique member, same as the classic
        staged sign round, with zero separate TIME/WRITE rounds.  The
        remainder is asked only on shortfall (a failed or declining
        wave-1 member), mirroring ``_staged_wave``.

        On commit the tail is CHEAP — mint + one ~0.2 ms verify — and
        the certified record is handed to the back-fill coalescer
        (one batched BATCH_WRITE round amortized over concurrent
        writes); only the rare shortfall path spawns a thread.  Returns
        ``("commit", t) | ("retry", max stored-t hint) |
        ("fallback", None) | ("fail", error)``."""
        tbs = pkt.serialize(variable, value, t, nfields=3)
        sig = self.crypt.signer.issue(tbs)
        tbss = pkt.serialize(variable, value, t, sig, nfields=4)
        req = pkt.serialize(variable, value, t, sig, proof)

        with trace.span("quorum.select"):
            qa = qm.choose_quorum_for(
                self.qs, variable, qm.AUTH | qm.PEER
            )
            qw = qm.choose_quorum_for(self.qs, variable, qm.WRITE)
        # Health-aware staging: rank each plane before interleaving so
        # open-breaker / gray members fall out of the minimal commit
        # prefix (the quorums' memoized node lists are never mutated —
        # _rank_nodes returns a sorted copy).
        qa_nodes = self._rank_nodes(qa.nodes())
        qa_ids = {n.id for n in qa_nodes}
        extra = [
            n for n in self._rank_nodes(qw.nodes()) if n.id not in qa_ids
        ]
        nodes = _interleave(qa_nodes, extra)
        self._presession.note_peers(nodes)
        self._presession.ensure_pump()
        smap = self._presession.signer_map(qa)

        acks: list = []
        entries: dict[int, bytes] = {}
        extra_certs: dict[int, object] = {}
        fails: list = []
        errs: list = []
        hints: list[int] = []
        shard_hints: list[tuple[int, int]] = []  # (epoch, owner) declines
        legacy: list = []

        def add_share(share_bytes: bytes) -> None:
            try:
                share = pkt.parse_signature(share_bytes)
                if share is None:
                    return
                if share.cert:
                    for c in certmod.parse(share.cert):
                        if self.crypt.keyring.get(c.id) is None:
                            extra_certs.setdefault(c.id, c)
                for sid, sb in sigmod.parse_entries(share.data):
                    if sid in smap or sid in extra_certs:
                        entries.setdefault(sid, sb)
            except Exception:
                return  # an unparsable share is simply not counted

        def committed() -> bool:
            return qa.is_threshold(acks) and qw.is_threshold(acks)

        def share_certs() -> list:
            out = []
            for sid in entries:
                c = smap.get(sid) or extra_certs.get(sid)
                if c is not None:
                    out.append(c)
            return out

        def done_now() -> bool:
            return committed() and qa.is_sufficient(share_certs())

        def cb(res: tp.MulticastResponse) -> bool:
            err = res.err
            if err is None and res.data is not None:
                try:
                    status, share_bytes, stored_t = pkt.parse_ws_ack(
                        res.data
                    )
                except Exception as e:
                    err = e
                else:
                    if status == pkt.WS_DECLINE_T:
                        hints.append(stored_t)
                        errs.append(ERR_INVALID_TIMESTAMP())
                        fails.append(res.peer)
                    else:
                        acks.append(res.peer)
                        if share_bytes:
                            add_share(share_bytes)
                    # Consume until committed AND sufficient: every
                    # response carries state (shares, decline hints),
                    # but once the commit predicate holds, waiting for
                    # a straggler buys nothing — the tail's back-fill
                    # reaches it anyway (DESIGN.md §13.2).
                    return done_now()
            if err == ERR_UNKNOWN_COMMAND:
                legacy.append(res.peer)
                self._legacy_peers.add(res.peer.id)
            ws = parse_wrong_shard(err)
            if ws is not None and ws[1] is not None:
                # Epoched wrong-shard decline: the responder told us
                # its epoch and the owning shard — reroute in-round.
                shard_hints.append(ws)
            errs.append(err)
            fails.append(res.peer)
            return False

        wave1, rest = nodes, []
        if _STAGED_SIGN_FANOUT:
            for i in range(1, len(nodes) + 1):
                prefix = nodes[:i]
                if (
                    qa.is_threshold(prefix)
                    and qw.is_threshold(prefix)
                    and qa.is_sufficient(prefix)
                ):
                    wave1, rest = prefix, nodes[i:]
                    break

        with trace.span(
            "phase.write_sign",
            attrs={"peers": len(nodes), "wave1": len(wave1)},
        ):
            # Staged + hedged: the remainder goes out on shortfall — or
            # EARLY, after one hedge delay, when a wave-1 straggler
            # (gray peer) stalls the round (transport.multicast_staged).
            stats = tp.multicast_staged(
                self.tr,
                tp.WRITE_SIGN,
                [wave1, rest],
                req,
                cb,
                need_more=lambda: not done_now(),
            )
        if stats["expanded"] or stats["hedged"]:
            metrics.incr("client.piggyback.expanded")
        if stats["hedged"]:
            metrics.incr("client.piggyback.hedged")

        if not committed():
            if legacy:
                return ("fallback", None)
            if shard_hints:
                # Reroute even when the hint is a no-op (our table may
                # have advanced past the responder's epoch mid-round) —
                # the retry re-selects on the CURRENT route either way,
                # and the attempt budget bounds Byzantine decline spam.
                epoch, owner = max(shard_hints)
                self._note_route_hint(variable, epoch, owner)
                return ("reroute", (epoch, owner))
            if hints:
                return ("retry", max(hints))
            return (
                "fail",
                majority_error(
                    [e for e in errs if e is not None],
                    ERR_INSUFFICIENT_NUMBER_OF_RESPONSES,
                ),
            )

        # Committed.  Finish the tail: mint + verify + batched
        # back-fill — sub-millisecond next to the round itself, so it
        # runs inline; the coalescer carries the network round.
        self._ws_finish(
            variable, value, t, sig, tbss, qa, smap, entries, extra_certs
        )
        return ("commit", t)

    def _ws_finish(
        self, variable, value, t, sig, tbss, qa, smap, entries,
        extra_certs,
    ) -> None:
        """Mint the collective signature from the piggybacked shares,
        verify it against the sign quorum (``suff`` signers — the wotqs
        math is untouched), and hand the certified record to the
        back-fill coalescer.  A share set that cannot reach a verifying
        ``suff`` is surfaced as ``client.tail.starved`` — the fleet
        collector turns that counter into an anomaly (note ``n − f ≥
        suff`` for every clique size: clean crashes within the fault
        budget cannot starve a tail, only misbehavior can — the round
        itself would have failed first)."""
        with trace.span("phase.ack", attrs={"shares": len(entries)}):
            signers_ = [
                smap.get(sid) or extra_certs.get(sid) for sid in entries
            ]
            if not qa.is_sufficient([c for c in signers_ if c is not None]):
                metrics.incr("client.tail.starved")
                log.warning(
                    "write tail starved: %d shares never reached suff "
                    "for %r (t=%d)", len(entries), variable, t,
                )
                return
            embeds = list(extra_certs.values())
            ss = pkt.SignaturePacket(
                type=pkt.SIGNATURE_TYPE_NATIVE,
                version=1,
                completed=True,
                data=sigmod.serialize_entries(list(entries.items())),
                cert=certmod.serialize_many(embeds) if embeds else None,
            )
            with trace.span("verify.collective"):
                try:
                    self.crypt.collective.verify(
                        tbss, ss, qa, self.crypt.keyring
                    )
                except Exception:
                    metrics.incr("client.tail.starved")
                    log.warning(
                        "write tail starved: combined signature for %r "
                        "(t=%d) failed verification", variable, t,
                    )
                    return
            record = pkt.serialize(variable, value, t, sig, ss)
            self._notify_certified(variable, record)
            self._backfills.submit(variable, record)

    # -- batched write pipeline (no reference analog) ---------------------

    def _shard_groups(
        self, variables: list[bytes]
    ) -> list[tuple[int, list[int]]] | None:
        """Partition a batch by owning shard.  Returns None when the
        quorum system is unkeyed, the namespace is unsharded, or every
        item already routes to one shard — the batch then runs exactly
        as before.  Otherwise: (shard, item indices) groups in shard
        order."""
        shard_of = getattr(self.qs, "shard_of", None)
        if shard_of is None:
            return None
        groups: dict[int | None, list[int]] = {}
        for i, v in enumerate(variables):
            groups.setdefault(shard_of(v), []).append(i)
        if len(groups) <= 1:
            return None
        return sorted(
            ((s, idx) for s, idx in groups.items()),
            key=lambda t: (t[0] is None, t[0]),
        )

    def write_many(
        self, items: list[tuple[bytes, bytes]], proof=None, *, window=None
    ) -> list[Exception | None]:
        """Batched three-phase signed write of B *distinct* variables.

        Same per-item semantics as ``write`` — every item independently
        passes the timestamp, quorum-certificate, equivocation, TOFU,
        and collective-signature checks on every replica — but the three
        phases each cross the network once for the whole batch, and
        every signature operation (client TBS signing, server writer-sig
        verification, server share issuance, collective verification)
        runs as one device batch instead of B×n individual calls.

        Large batches run as a **pipelined** sequence of chunks: chunk
        k's write round (the BATCH_WRITE fan-out and its threshold
        wait) runs on a background worker while chunk k+1's time+sign
        rounds proceed on the caller thread, with at most ``window``
        write rounds in flight (default 2, ``BFTKV_WRITE_PIPELINE``).
        Chunks are a latency/occupancy trade: each chunk's server-side
        crypto still batches into shared device launches, and the
        chunk floor (``BFTKV_WRITE_CHUNK``, default 256) keeps those
        launches amortized.  Items within a chunk keep exactly the
        monolithic path's semantics; chunks touch disjoint variables
        (enforced below), so inter-chunk ordering is immaterial.

        Returns a list aligned with ``items``: ``None`` per success, the
        per-item error otherwise.
        """
        if not items:
            return []
        variables = [v for v, _ in items]
        if len(set(variables)) != len(variables):
            # Duplicates in one batch would equivocate against each
            # other at the same timestamp; that is a caller bug.
            raise ValueError("write_many: duplicate variables in one batch")
        groups = self._shard_groups(variables)
        if groups is not None:
            # Sharded namespace: each shard's items are one independent
            # batch against that shard's quorums (all five phases of an
            # item must agree on the clique).  Groups run sequentially
            # on the caller thread; intra-group pipelining still
            # overlaps the rounds that dominate.
            metrics.incr("client.write_many.shard_split")
            results: list[Exception | None] = [None] * len(items)
            for _shard, idx in groups:
                sub = self.write_many(
                    [items[i] for i in idx], proof, window=window
                )
                for i, r in zip(idx, sub):
                    results[i] = r
            return results
        n = len(items)

        if window is None:
            window = _WRITE_PIPELINE_WINDOW
        chunk_size = _WRITE_PIPELINE_CHUNK
        with metrics.timer("client.write_many.latency"), trace.span(
            "client.write_many", attrs={"batch": n}
        ):
            if window <= 1 or n <= chunk_size:
                results: list[Exception | None] = [None] * n
                state = self._wm_time_sign(items, proof, results)
                if state is not None:
                    self._wm_write(items, results, *state)
                return results
            return self._write_many_pipelined(
                items, proof, window, chunk_size
            )

    def _write_many_pipelined(
        self, items, proof, window: int, chunk_size: int
    ) -> list:
        """Chunked 3-stage pipeline: the caller thread drives time+sign
        rounds chunk by chunk; completed chunks' write rounds run on a
        background worker, bounded to ``window`` in flight."""
        n = len(items)
        results: list[Exception | None] = [None] * n
        sem = threading.Semaphore(window)
        workers: list[threading.Thread] = []
        ctx = trace.capture()

        def run_write(chunk, chunk_results, state):
            try:
                with trace.attach(ctx):
                    self._wm_write(chunk, chunk_results, *state)
            except Exception as e:  # defensive: never strand the join
                for k in range(len(chunk_results)):
                    if chunk_results[k] is None:
                        chunk_results[k] = e
            finally:
                sem.release()

        spans: list[tuple[int, list]] = []  # (offset, chunk_results)
        for off in range(0, n, chunk_size):
            chunk = items[off : off + chunk_size]
            chunk_results: list = [None] * len(chunk)
            spans.append((off, chunk_results))
            state = self._wm_time_sign(chunk, proof, chunk_results)
            if state is None:
                continue
            sem.acquire()
            metrics.incr("client.write_many.pipelined_chunks")
            t = threading.Thread(
                target=run_write,
                args=(chunk, chunk_results, state),
                daemon=True,
            )
            t.start()
            workers.append(t)
        for t in workers:
            t.join()
        for off, chunk_results in spans:
            results[off : off + len(chunk_results)] = chunk_results
        return results

    def _wm_time_sign(self, items, proof, results):
        """Phases 1+2 of the batched write for one chunk: timestamps,
        share collection, collective verification.  Fills ``results``
        (aligned with ``items``) with per-item errors; returns the
        phase-3 state ``(pending, ts, sigs, sss)`` or ``None`` when no
        item survived."""
        n = len(items)
        # ---- phase 1: timestamps (reference: client.go:62-92) ----
        # Any item keys the quorum: write_many has already grouped the
        # batch so every item routes to the same shard.
        with trace.span("quorum.select"):
            qr = qm.choose_quorum_for(
                self.qs, items[0][0], qm.READ | qm.AUTH
            )
        maxts = [0] * n
        tally = _BatchTally(n, qr.is_threshold, qr.reject)

        def on_time(i: int, payload: bytes):
            # Same strictness as the single path (`res.data and
            # len(res.data) <= 8`): an empty or oversized timestamp
            # is a failed response, not t=0 — a Byzantine replica
            # must not pad the quorum with vacuous answers.
            if not payload or len(payload) > 8:
                return ERR_INVALID_TIMESTAMP
            t = int.from_bytes(payload, "big")
            if t > maxts[i]:
                maxts[i] = t
            return None

        with metrics.timer("client.write_many.phase_time"), trace.span(
            "phase.time", attrs={"peers": len(qr.nodes())}
        ):
            self.tr.multicast(
                tp.BATCH_TIME,
                qr.nodes(),
                pkt.serialize_list([v for v, _ in items]),
                _batch_cb(tally, n, on_time),
            )
        for i in range(n):
            err = tally.item_error(i, ERR_INSUFFICIENT_NUMBER_OF_QUORUM)
            if err is not None:
                results[i] = err
            elif maxts[i] == MAX_UINT64:
                results[i] = ERR_INVALID_TIMESTAMP

        # ---- phase 2: sign (reference: client.go:125-170) --------
        pending = [i for i in range(n) if results[i] is None]
        if not pending:
            return None
        ts = {i: maxts[i] + 1 for i in pending}
        tbs_list = [
            pkt.serialize(items[i][0], items[i][1], ts[i], nfields=3)
            for i in pending
        ]
        with metrics.timer("client.write_many.phase_self_sign"):
            # The writer cert rides the FIRST item only; servers
            # resolve embedded certs frame-wide in _batch_sign, so
            # B−1 cert copies come off the wire and off the
            # server's parse path.
            pkts = self.crypt.signer.issue_many(
                tbs_list, include_cert=False
            )
            if pkts:
                pkts[0].cert = self.crypt.signer.cert.serialize()
            sigs = dict(zip(pending, pkts))
        reqs = [
            pkt.serialize(items[i][0], items[i][1], ts[i], sigs[i], proof)
            for i in pending
        ]

        qa = qm.choose_quorum_for(self.qs, items[0][0], qm.AUTH | qm.PEER)
        entries: dict[int, dict[int, bytes]] = {i: {} for i in pending}
        extra_certs: dict[int, object] = {}  # embedded, not in keyring
        stally = _BatchTally(len(pending), qa.is_sufficient, qa.reject)

        def on_share(k: int, payload: bytes):
            # Count only shares whose signer RESOLVES — sufficiency
            # must track usable signatures, not responding servers,
            # or an unresolvable (Byzantine) share would stop the
            # fan-out early and starve verification below quorum.
            try:
                share = pkt.parse_signature(payload)
                if share is not None and share.cert:
                    for c in certmod.parse(share.cert):
                        if self.crypt.keyring.get(c.id) is None:
                            extra_certs.setdefault(c.id, c)
                added = False
                for sid, sb in sigmod.parse_entries(
                    share.data if share else None
                ):
                    if (
                        self.crypt.keyring.get(sid) is not None
                        or sid in extra_certs
                    ):
                        entries[pending[k]].setdefault(sid, sb)
                        added = True
                return None if added else _SKIP
            except Exception as e:
                return e

        with metrics.timer("client.write_many.phase_sign"), trace.span(
            "phase.sign", attrs={"peers": len(qa.nodes())}
        ):
            # Staged fan-out, as in collect_signatures: a minimal
            # sufficient prefix signs first; the remainder is asked
            # only if some item is still short.  Health-ranked, so a
            # known-gray member never anchors the batch's first wave.
            wave1, rest = _staged_wave(qa, self._rank_nodes(qa.nodes()))
            payload_bytes = pkt.serialize_list(reqs)
            cb = _batch_cb(stally, len(pending), on_share)
            self.tr.multicast(tp.BATCH_SIGN, wave1, payload_bytes, cb)
            if rest and not all(stally.done):
                metrics.incr("client.sign.fanout_expanded")
                self.tr.multicast(tp.BATCH_SIGN, rest, payload_bytes, cb)
        jobs: list[tuple[bytes, pkt.SignaturePacket]] = []
        jidx: list[int] = []
        sss: dict[int, pkt.SignaturePacket] = {}
        for k, i in enumerate(pending):
            err = stally.item_error(
                k, ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES
            )
            if err is not None:
                results[i] = err
                continue
            embeds = [
                extra_certs[sid]
                for sid in entries[i]
                if sid in extra_certs
            ]
            ss = pkt.SignaturePacket(
                type=pkt.SIGNATURE_TYPE_NATIVE,
                version=1,
                completed=True,
                data=sigmod.serialize_entries(list(entries[i].items())),
                cert=certmod.serialize_many(embeds) if embeds else None,
            )
            sss[i] = ss
            tbss = pkt.serialize(
                items[i][0], items[i][1], ts[i], sigs[i], nfields=4
            )
            jobs.append((tbss, ss))
            jidx.append(i)
        if jobs:
            with metrics.timer(
                "client.write_many.phase_verify"
            ), trace.span(
                "verify.collective", attrs={"batch_size": len(jobs)}
            ):
                verrs = self.crypt.collective.verify_many(
                    jobs, qa, self.crypt.keyring
                )
            for j, i in enumerate(jidx):
                if verrs[j] is not None:
                    results[i] = verrs[j]

        pending = [i for i in range(len(items)) if results[i] is None]
        if not pending:
            return None
        return pending, ts, sigs, sss

    def _wm_write(self, items, results, pending, ts, sigs, sss) -> None:
        """Phase 3 of the batched write for one chunk
        (reference: client.go:94-121)."""
        data = [
            pkt.serialize(
                items[i][0], items[i][1], ts[i], sigs[i], sss[i]
            )
            for i in pending
        ]
        qw = qm.choose_quorum_for(self.qs, items[0][0], qm.WRITE)
        wtally = _BatchTally(len(pending), qw.is_threshold, qw.reject)
        with metrics.timer("client.write_many.phase_write"), trace.span(
            "phase.write", attrs={"peers": len(qw.nodes())}
        ):
            self.tr.multicast(
                tp.BATCH_WRITE,
                qw.nodes(),
                pkt.serialize_list(data),
                _batch_cb(wtally, len(pending), lambda k, payload: None),
            )
        nok = 0
        for k, i in enumerate(pending):
            err = wtally.item_error(
                k, ERR_INSUFFICIENT_NUMBER_OF_RESPONSES
            )
            if err is not None:
                results[i] = err
            else:
                nok += 1
                # data[k] is the certified record (phase 2 verified its
                # completed collective signature) the quorum just
                # committed — the gateway's write-through fill.
                self._notify_certified(items[i][0], data[k])
        metrics.incr("client.write.ok", nok)

    def read_many(
        self, variables: list[bytes], proof=None
    ) -> list[bytes | None | Exception | type[Exception]]:
        """Batched quorum read: one round trip carries B variables.

        Same per-item semantics as ``read`` — responses bucket by
        ``(t, value)`` per variable, a value wins once its responder
        set reaches threshold at the max timestamp, equivocating
        signers are revoked (one NOTIFY broadcast for the whole
        batch), and stale replicas get read-repaired (per-node batches
        of exactly the packets each node is missing).  Like the single
        path, the fan-out consumes every response and revocation +
        repair run on a background worker after the values return.

        Returns one entry per variable: the value bytes, ``None`` for
        an empty value, or the per-item error (an interned ``Error``
        class or instance — compare with ``==`` as usual).
        """
        if not variables:
            return []
        groups = self._shard_groups(variables)
        if groups is not None:
            metrics.incr("client.read_many.shard_split")
            results_all: list = [None] * len(variables)
            for _shard, idx in groups:
                sub = self.read_many([variables[i] for i in idx], proof)
                for i, r in zip(idx, sub):
                    results_all[i] = r
            return results_all
        n = len(variables)
        q = qm.choose_quorum_for(self.qs, variables[0], qm.READ)
        reqs = [pkt.serialize(v, None, 0, None, proof) for v in variables]
        ms: list[dict] = [{} for _ in range(n)]
        fails: list[list] = [[] for _ in range(n)]

        with metrics.timer("client.read_many.latency"), trace.span(
            "client.read_many", attrs={"batch": n}
        ):

            def cb(res: tp.MulticastResponse) -> bool:
                if res.err is not None or res.data is None:
                    for f in fails:
                        f.append(res.err)
                    return False
                try:
                    out = pkt.parse_results(res.data)
                    if len(out) != n:
                        raise ERR_MALFORMED_REQUEST
                except Exception as e:
                    for f in fails:
                        f.append(e)
                    return False
                for k, (errstr, payload) in enumerate(out):
                    if errstr is not None:
                        fails[k].append(error_from_string(errstr))
                        continue
                    err = self._process_response(
                        tp.MulticastResponse(res.peer, payload or None, None),
                        ms[k],
                        variables[k],
                    )
                    if err is not None:
                        fails[k].append(err)
                return False  # consume the full quorum, as _read_worker does

            self.tr.multicast(
                tp.BATCH_READ, q.nodes(), pkt.serialize_list(reqs), cb
            )

            # Resolve ONCE over the complete fan-out.  The batch path
            # consumes every response anyway (no early delivery to
            # gain), and resolving per-response would freeze an item at
            # the first threshold-reaching bucket — a stale value can
            # hit threshold before a slower honest replica delivers the
            # newest packet with its collective signature, making the
            # result depend on arrival order.  Full-set resolution is
            # deterministic: highest threshold-reaching bucket wins,
            # and a *signed* strictly-newer candidate beats it; a
            # fabricated lone high-t bucket has neither threshold nor a
            # forgeable signature (see _resolve_complete_fanout_many).
            resolved: list[tuple[bytes | None, int] | None] = [None] * n
            try:
                resolved = self._resolve_complete_fanout_many(
                    ms, q, key=variables[0], keys=variables
                )
                self._certify_resolved(ms, q, resolved, variables, proof)
            except Exception as e:
                for k in range(n):
                    fails[k].append(e)

            results: list = []
            winners: list[tuple[int, bytes | None, int]] = []
            for k in range(n):
                if resolved[k] is not None:
                    value, maxt = resolved[k]
                    results.append(value)
                    self._presession.lease_update(variables[k], maxt)
                    winners.append((k, value, maxt))
                else:
                    results.append(
                        majority_error(
                            [e for e in fails[k] if e is not None],
                            ERR_INSUFFICIENT_NUMBER_OF_RESPONSES,
                        )
                    )
            metrics.incr("client.read.ok", len(winners))

        # Revocation + repair happen after the caller has its values,
        # mirroring _read_worker's early delivery: one lagging stale
        # replica must not inflate every batched read.
        worker = threading.Thread(
            target=self._read_many_post,
            args=(q, ms, winners),
            daemon=True,
        )
        worker.start()
        return results

    def _read_many_post(self, q, ms: list[dict], winners: list) -> None:
        # Revoke equivocators across the whole batch; one NOTIFY.
        revoked: set[int] = set()
        for m in ms:
            revoked |= self._revoke_equivocators(m, revoked)
        if revoked:
            self._broadcast_revocations()

        # Read-repair, grouped per stale node so each replica receives
        # exactly the packets it is missing (a union batch would make
        # every stale node re-verify the whole batch: O(B²) work).
        per_node: dict[int, tuple[object, list[bytes]]] = {}
        for _k, value, maxt in winners:
            if not value:
                continue
            m = ms[_k]
            bucket = m.get(maxt, {}).get(value)
            if not bucket or bucket[0].packet is None:
                continue
            have = {sv.node.id for sv in bucket}
            stale = [nd for nd in q.nodes() if nd.id not in have]
            for nd in stale:
                per_node.setdefault(nd.id, (nd, []))[1].append(
                    bucket[0].packet
                )
        if per_node:
            # Same unit as the single path: one count per (item, stale
            # node) send, so mixed traffic sums meaningfully.
            metrics.incr(
                "client.read.repair",
                sum(len(pkts) for _nd, pkts in per_node.values()),
            )
            peers = [nd for nd, _pkts in per_node.values()]
            payloads = [
                pkt.serialize_list(pkts) for _nd, pkts in per_node.values()
            ]
            self.tr.multicast_m(tp.BATCH_WRITE, peers, payloads, None)

    # -- read path (reference: client.go:189-353) -------------------------

    def read(self, variable: bytes, proof=None) -> bytes | None:
        """Quorum read, resolved over the COMPLETE fan-out; the worker
        thread finishes revoke-on-read and read-repair
        (reference: client.go:237-279 returns at first threshold).

        Divergence — deterministic resolution (the batch path's rule,
        DESIGN.md §3.3, applied to the single path too):
        freezing at the first threshold made the winner arrival-order
        dependent — a committed newest write with a single honest
        holder lost to a stale threshold whenever its response arrived
        late, so the same read could return either value under load.
        Resolving over the complete fan-out costs the early-exit
        latency but makes the outcome a function of the response SET,
        with the lone signed newest verified cryptographically
        (``_resolve_complete_fanout_many``)."""
        shard = self._shard_label(variable)
        attrs = {}
        if shard is not None:
            attrs["shard"] = shard
        with _shard_timer("client.read.latency", shard), trace.span(
            "client.read", attrs=attrs
        ):
            with trace.span("quorum.select"):
                q = qm.choose_quorum_for(self.qs, variable, qm.READ)
            req = pkt.serialize(variable, None, 0, None, proof)
            ch: "queue.Queue[tuple[bytes | None, Exception | None]]" = (
                queue.Queue(maxsize=1)
            )

            worker = threading.Thread(
                target=self._read_worker,
                args=(q, req, ch, variable, trace.capture(), proof),
                daemon=True,
            )
            worker.start()
            value, err = ch.get()
            if err is not None:
                raise err
            return value

    def read_certified(
        self, variable: bytes, proof=None
    ) -> tuple[bytes | None, int, bytes | None]:
        """One quorum read resolved over the COMPLETE fan-out, returned
        WITH its certified record bytes: ``(value, t, record)`` where
        ``record`` is the raw ``<x, t, v, ss>`` packet whose collective
        signature this client verified (or certified on read) — the
        reusable fill seam the edge gateway's read-through cache is
        built on (DESIGN.md §14).  ``record`` is None exactly when the
        read resolved empty (nothing stored / empty value at t=0).
        Same resolution, revoke-on-read, and read-repair semantics as
        :meth:`read`; raises the same errors on quorum failure."""
        shard = self._shard_label(variable)
        attrs = {}
        if shard is not None:
            attrs["shard"] = shard
        with _shard_timer("client.read.latency", shard), trace.span(
            "client.read_certified", attrs=attrs
        ):
            with trace.span("quorum.select"):
                q = qm.choose_quorum_for(self.qs, variable, qm.READ)
            req = pkt.serialize(variable, None, 0, None, proof)
            m: dict = {}
            fails: list = []

            def cb(res: tp.MulticastResponse) -> bool:
                err = self._process_response(res, m, variable)
                if err is not None:
                    fails.append(err)
                return False  # full fan-out, as read() resolves

            self.tr.multicast(tp.READ, q.nodes(), req, cb)
            resolved = self._resolve_complete_fanout_many(
                [m], q, key=variable
            )
            # Pending winners leave certified or get demoted — the
            # no-bare-value rule the cache's soundness rests on.
            self._certify_resolved([m], q, resolved, [variable], proof)
            (res0,) = resolved
            if res0 is None:
                raise majority_error(
                    [e for e in fails if e is not None],
                    ERR_INSUFFICIENT_NUMBER_OF_RESPONSES,
                )
            value, maxt = res0
            self._presession.lease_update(variable, maxt)
            record = self._certified_bucket_record(m, value, maxt)
            if value and record is None:
                # Resolution fell back through _certify_resolved's
                # demote path (_read_certified_only resolves from its
                # OWN response map), so the winning certified bytes
                # are not in ``m`` — re-collect them with one
                # certified-only round.  Without this, a caller that
                # needs the record (the gateway fill) would see "no
                # data" for a variable that HAS a certified value.
                m2: dict = {}
                req2 = pkt.serialize(variable, None, 1, None, proof)

                def cb2(res: tp.MulticastResponse) -> bool:
                    self._process_response(res, m2, variable)
                    return False

                with trace.span("read.certified_record"):
                    self.tr.multicast(tp.READ, q.nodes(), req2, cb2)
                record = self._certified_bucket_record(m2, value, maxt)
            metrics.incr("client.read.ok")
        # Revoke-on-read + read-repair off the caller's critical path,
        # exactly like the single read's worker tail.
        worker = threading.Thread(
            target=self._read_certified_post,
            args=(q, m, value, maxt),
            daemon=True,
        )
        worker.start()
        return value, maxt, record

    @staticmethod
    def _certified_bucket_record(
        m: dict, value, maxt: int
    ) -> bytes | None:
        """The raw completed-``ss`` packet backing ``(value, maxt)`` in
        a response map, or None."""
        if not value:
            return None
        for sv in m.get(maxt, {}).get(value or b"") or []:
            if sv.ss is not None and sv.ss.completed and sv.packet:
                return sv.packet
        return None

    def _read_certified_post(self, q, m, value, maxt) -> None:
        try:
            self._revoke_on_read(m)
            if value:
                self._write_back(q.nodes(), m, value, maxt)
        except Exception:
            log.exception("read_certified repair tail failed")

    def _read_worker(
        self, q, req: bytes, ch, variable: bytes, tctx=None, proof=None
    ) -> None:
        # The fan-out runs on this worker thread; re-attach the read's
        # trace context so per-peer rpc spans join the caller's trace.
        with trace.attach(tctx):
            self._read_worker_inner(q, req, ch, variable, proof)

    def _read_worker_inner(
        self, q, req: bytes, ch, variable: bytes, proof=None
    ) -> None:
        m: dict[int, dict[bytes, list[_SignedValue]]] = {}
        done = False
        value = None
        maxt = 0
        failure: list = []
        errs: list = []

        def deliver(val, err) -> None:
            nonlocal done
            if not done:
                done = True
                ch.put((val, err))

        def cb(res: tp.MulticastResponse) -> bool:
            err = self._process_response(res, m, variable)
            if err is not None:
                failure.append(res.peer)
                errs.append(err)
                if not done and q.reject(failure):
                    # Fast-fail stays: rejection is monotone in the
                    # failure set, so it cannot flip with more
                    # responses the way a value resolution can.
                    deliver(
                        None,
                        majority_error(
                            errs, ERR_INSUFFICIENT_NUMBER_OF_VALID_RESPONSES
                        ),
                    )
            return False  # go through all members of the quorum

        self.tr.multicast(tp.READ, q.nodes(), req, cb)
        if not done:
            # Deterministic resolution over the complete response set:
            # threshold winner at the highest t, unless a *verified*
            # collective signature endorses a strictly newer candidate
            # (see _resolve_complete_fanout_many).
            try:
                resolved = self._resolve_complete_fanout_many(
                    [m], q, key=variable
                )
                self._certify_resolved(
                    [m], q, resolved, [variable], proof
                )
                (res0,) = resolved
                if res0 is not None:
                    value, maxt = res0
                    self._presession.lease_update(variable, maxt)
                    deliver(value, None)
            except Exception as e:
                # The worker must ALWAYS deliver: an exception here
                # (e.g. quorum recomputation mid-read) would otherwise
                # strand read() on ch.get() forever.
                deliver(None, e)
        deliver(None, ERR_INSUFFICIENT_NUMBER_OF_RESPONSES)
        self._revoke_on_read(m)
        if value:
            self._write_back(q.nodes(), m, value, maxt)

    @staticmethod
    def _process_response(
        res: tp.MulticastResponse, m, variable: bytes | None = None
    ) -> Exception | None:
        """Bucket one response by (t, value) (reference: client.go:207-230).

        A non-empty response whose packet names a *different* variable
        is an invalid response, not a bucket entry: collective
        signatures bind <x, v, t>, so an unchecked x would let one
        Byzantine replica answer read(x) with a genuinely-signed packet
        for some other variable y and have the complete-fan-out
        fallback serve y's value for x (the reference never accepts
        below-threshold buckets, so it never needed this check).
        """
        if res.err is not None:
            return res.err
        val = None
        sig = ss = None
        t = 0
        raw = res.data
        if raw:
            try:
                p = pkt.parse(raw)
            except Exception as e:
                return e
            if variable is not None and (p.variable or b"") != variable:
                return ERR_INVALID_RESPONSE
            val, t, sig, ss = p.value, p.t, p.sig, p.ss
        vl = m.setdefault(t, {})
        vl.setdefault(val or b"", []).append(
            _SignedValue(res.peer, sig, ss, raw)
        )
        return None

    @staticmethod
    def _max_timestamped_value(m, q) -> tuple[bytes | None, int]:
        """First value at the max timestamp whose responder set reaches
        threshold (reference: client.go:189-205)."""
        if not m:
            raise _InProgress
        maxt = max(m)
        for val, svl in m[maxt].items():
            if q.is_threshold([sv.node for sv in svl]):
                return (val or None), maxt
        raise _InProgress

    def _resolve_complete_fanout_many(
        self,
        ms: list[dict],
        q,
        key: bytes | None = None,
        keys: list | None = None,
    ) -> list[tuple[bytes | None, int] | None]:
        """Complete-fan-out fallback for a list of response maps,
        timestamps descending per item: a bucket wins by responder
        threshold (the reference's only rule) or by a *sufficient
        collective signature* on its packet; all candidate signatures
        across all items verify in ONE device batch (verify_many).

        The reference checks only the global max timestamp, so a single
        Byzantine replica answering with an unsigned fabricated higher
        t fails the read whenever its response arrives before the
        honest threshold forms (client.go:189-205).  Responder
        thresholds alone cannot close that gap: the write quorum's
        read-class components commit at f+1 acks, so a *committed*
        newest write may have a single honest holder and look exactly
        like the liar's lone bucket.  The collective signature is the
        discriminator — it cryptographically proves a sign quorum
        endorsed <x,v,t> (and _process_response has already bound the
        packet's variable to the one requested), so accepting it — and
        then write-backing it — completes an in-flight write rather
        than serving a fabrication; a liar cannot forge it.
        """
        resolved: list[tuple[bytes | None, int] | None] = [None] * len(ms)
        jobs: list[tuple[bytes, pkt.SignaturePacket]] = []
        meta: list[tuple[int, int, bytes]] = []  # (item, t, val)
        sig_won: list[bool] = [False] * len(ms)
        for k, m in enumerate(ms):
            # Highest-t bucket that wins by responder threshold...
            t_thr = -1
            for t in sorted(m, reverse=True):
                for val, svl in m[t].items():
                    if q.is_threshold([sv.node for sv in svl]):
                        resolved[k] = ((val or None), t)
                        t_thr = t
                        break
                if t_thr >= 0:
                    break
            # ...but a *signed* candidate at a strictly newer t beats
            # it (ordering matters: the in-flight newest write sits
            # above the stale-but-threshold-reaching previous value).
            for t in sorted(m, reverse=True):
                if t <= max(t_thr, 0):
                    break
                for val, svl in m[t].items():
                    for sv in svl:
                        if sv.ss is None or not sv.packet:
                            continue
                        jobs.append((pkt.tbss(sv.packet), sv.ss))
                        meta.append((k, t, val))
        if jobs:
            try:
                # ``key`` keys the AUTH quorum to the shard being read:
                # a candidate must be endorsed by the OWNER clique, not
                # by whatever clique the unkeyed path would pick.
                qa = qm.choose_quorum_for(self.qs, key or b"", qm.AUTH)
                errs = self.crypt.collective.verify_many(
                    jobs, qa, self.crypt.keyring
                )
                # Dual-epoch admission window (DESIGN.md §15): a record
                # certified by the OLD owner clique is still readable
                # mid-migration — retry each failure against the dual
                # quorum(s) the route table names for THAT item's own
                # bucket (a batch groups by owner shard, but only some
                # of its buckets may be inside a window).  Outside a
                # window alt_quorums_for is empty and nothing changes.
                if any(e is not None for e in errs):
                    alt_of = getattr(
                        self.qs, "alt_quorums_for", lambda *_a: []
                    )
                    for i, e in enumerate(errs):
                        if e is None:
                            continue
                        k = meta[i][0]
                        item_key = (
                            keys[k]
                            if keys is not None and k < len(keys)
                            else key
                        )
                        for alt in alt_of(item_key or b"", qm.AUTH):
                            try:
                                self.crypt.collective.verify(
                                    jobs[i][0],
                                    jobs[i][1],
                                    alt,
                                    self.crypt.keyring,
                                )
                                errs[i] = None
                                break
                            except Exception:
                                # Share verifies under none of the
                                # candidate quorums so far: try the
                                # next; errs[i] stays set if all fail.
                                continue
            except Exception:
                # Verification machinery failing must not discard the
                # threshold resolutions already computed above — those
                # items' reads are valid regardless of the candidates.
                # Degrade loudly: this signals broken crypto plumbing,
                # not a Byzantine peer.
                metrics.incr("client.read.fallback_verify_error")
                log.exception(
                    "complete-fan-out candidate verification failed"
                )
                return resolved
            # meta is ordered highest-t first per item, so the first
            # verified candidate per item is the freshest.
            for (k, t, val), err in zip(meta, errs):
                if err is None and not sig_won[k]:
                    resolved[k] = ((val or None), t)
                    sig_won[k] = True
        return resolved

    def _certify_resolved(
        self, ms: list[dict], q, resolved: list, variables: list[bytes],
        proof=None,
    ) -> None:
        """Commit-pending winners must leave the read CERTIFIED.

        A bucket that won by responder threshold but holds only
        commit-pending records (piggybacked writes whose collective
        back-fill has not landed yet) is completed ON READ: one SIGN
        round to the owner sign quorum re-collects shares for the exact
        stored ``<x, v, t, sig>`` (idempotent at every honest replica —
        they already signed it), the combined signature is verified,
        and the winning bucket's repair packet is upgraded to the
        certified bytes so read-repair spreads the completed record.
        A pending bucket that CANNOT certify is demoted and the item
        re-resolved without it — a bare value is never served
        (DESIGN.md §12.3).  Mutates ``resolved`` in place."""
        for k in range(len(resolved)):
            demoted = False
            while resolved[k] is not None:
                value, t = resolved[k]
                if not value:
                    break  # empty read: nothing claimed, nothing to back
                bucket = ms[k].get(t, {}).get(value or b"")
                if not bucket or any(
                    sv.ss is not None and sv.ss.completed for sv in bucket
                ):
                    break  # certified (or an empty t=0 resolution)
                ss = self._certify_pending(variables[k], bucket, proof)
                if ss is not None:
                    metrics.incr("client.read.certified")
                    base = pkt.parse(bucket[0].packet)
                    certified = pkt.serialize(
                        base.variable, base.value, base.t, base.sig, ss
                    )
                    bucket[0] = _SignedValue(
                        bucket[0].node, base.sig, ss, certified
                    )
                    # Push the now-certified bytes to the read quorum on
                    # an async tail: the regular read-repair skips nodes
                    # that already "have" the value, but they only hold
                    # the PENDING form — the upgrade must reach them or
                    # the record would stay uncertified until the next
                    # certify-on-read.  Idempotent at every replica
                    # (same <t, value>, verified ss).  Bind the loop
                    # locals as defaults: the k-loop rebinds them before
                    # the thread runs when several items certify.
                    nodes = list(q.nodes())
                    th = threading.Thread(
                        target=lambda ns=nodes, data=certified: (
                            self.tr.multicast(tp.WRITE, ns, data, None)
                        ),
                        daemon=True,
                        name="bftkv-certify-repair",
                    )
                    self._track_tail(th)
                    th.start()
                    break
                # Unbackable pending bucket: demote it and re-resolve.
                metrics.incr("client.read.pending_unbacked")
                demoted = True
                vl = ms[k].get(t)
                if vl is not None:
                    vl.pop(value or b"", None)
                    if not vl:
                        ms[k].pop(t, None)
                resolved[k] = self._resolve_complete_fanout_many(
                    [ms[k]], q, key=variables[k]
                )[0]
            if resolved[k] is None and demoted:
                # Every candidate was an uncertifiable pending record —
                # a replica serving a pending latest HIDES its previous
                # certified version, so ask the quorum again for the
                # latest CERTIFIED records only (read request t=1; old
                # servers already behave that way).
                resolved[k] = self._read_certified_only(
                    variables[k], q, proof
                )

    def _read_certified_only(
        self, variable: bytes, q, proof
    ) -> tuple[bytes | None, int] | None:
        """One certified-only read round (request ``t = 1``), resolved
        over the complete fan-out; pending records cannot appear."""
        metrics.incr("client.read.certified_fallback")
        req = pkt.serialize(variable, None, 1, None, proof)
        m: dict = {}

        def cb(res: tp.MulticastResponse) -> bool:
            self._process_response(res, m, variable)
            return False

        with trace.span("read.certified_only"):
            self.tr.multicast(tp.READ, q.nodes(), req, cb)
        try:
            return self._resolve_complete_fanout_many(
                [m], q, key=variable
            )[0]
        except Exception:
            return None

    def _certify_pending(
        self, variable: bytes, bucket: list, proof
    ) -> pkt.SignaturePacket | None:
        """Collect a fresh collective signature for a commit-pending
        record (helping: completing the in-flight write's tail from the
        reader's seat).  Returns the verified ``ss`` or None."""
        base = bucket[0].packet
        if not base:
            return None
        try:
            p = pkt.parse(base)
        except Exception:
            return None
        if p.sig is None:
            return None
        qa = qm.choose_quorum_for(self.qs, variable, qm.AUTH | qm.PEER)
        req = pkt.serialize(p.variable or b"", p.value, p.t, p.sig, proof)
        tbss = pkt.tbss(base)
        ss = None
        done_flag = [False]
        failure: list = []

        def cb(res: tp.MulticastResponse) -> bool:
            nonlocal ss
            if res.err is None and res.data is not None:
                try:
                    share = pkt.parse_signature(res.data)
                    ss, done = self.crypt.collective.combine(
                        ss, share, qa, self.crypt.keyring
                    )
                    done_flag[0] = done
                    return done
                except Exception:
                    pass  # malformed/forged share: count the peer below
            failure.append(res.peer)
            return qa.reject(failure)

        with trace.span("read.certify", attrs={"peers": len(qa.nodes())}):
            wave1, rest = _staged_wave(qa, self._rank_nodes(qa.nodes()))
            tp.multicast_staged(
                self.tr,
                tp.SIGN,
                [wave1, rest],
                req,
                cb,
                need_more=lambda: not done_flag[0],
            )
            try:
                self.crypt.collective.verify(
                    tbss, ss, qa, self.crypt.keyring
                )
            except Exception:
                return None
        ss.completed = True
        return ss

    def _write_back(self, universe, m, value: bytes, t: int) -> None:
        """Read-repair: push the winning packet to every node that did
        not respond with it (reference: client.go:281-302)."""
        have = {sv.node.id for sv in m.get(t, {}).get(value, ())}
        stale = [n for n in universe if n.id not in have]
        if not stale:
            return
        bucket = m.get(t, {}).get(value)
        if not bucket:
            return
        metrics.incr("client.read.repair", len(stale))
        self.tr.multicast(tp.WRITE, stale, bucket[0].packet, None)

    #: Signer-entry count above which revoke-on-read tallies on device
    #: (256 simulated replicas with f=85 colluders — the sweep is
    #: one einsum instead of a Python scan over ~10^4 entries).
    BATCH_REVOKE_THRESHOLD = 512

    def _revoke_on_read(self, m) -> None:
        """Signers that signed two different values at the same
        timestamp get revoked; the revocation list is broadcast
        (reference: client.go:304-353)."""
        if self._revoke_equivocators(m, set()):
            self._broadcast_revocations()

    def _revoke_equivocators(self, m, already: set[int]) -> set[int]:
        """Scan one response map and revoke double-signers not in
        ``already``; returns the newly revoked ids (the caller owns the
        NOTIFY broadcast so batched reads send it once)."""
        revoked: set[int] = set()
        for t, vl in m.items():
            if t == 0:
                continue
            # One signer-id set per distinct value observed at t.
            rows: list[set[int]] = [
                {sid for sv in svl for sid in sigmod.signers(sv.ss)}
                for svl in vl.values()
            ]
            if len(rows) < 2:
                continue
            total = sum(len(r) for r in rows)
            if total >= self.BATCH_REVOKE_THRESHOLD:
                bad = self._equivocators_batched(rows, device=self.device)
            else:
                seen: dict[int, int] = {}
                bad = set()
                for round_no, row in enumerate(rows):
                    for sid in row:
                        prev = seen.get(sid)
                        if prev is None:
                            seen[sid] = round_no
                        elif prev != round_no:
                            bad.add(sid)
            for sid in bad:
                if sid not in revoked and sid not in already:
                    self._do_revoke(sid)
                    revoked.add(sid)
        return revoked

    def _broadcast_revocations(self) -> None:
        rl = self.self_node.serialize_revoked()
        if rl:
            self.tr.multicast(tp.NOTIFY, self.self_node.get_peers(), rl, None)

    @staticmethod
    def _equivocators_batched(rows: list[set[int]], *, device=None) -> set[int]:
        """Device sweep: (nvalues, U) bool → equivocator mask in one
        reduction (ops.tally.equivocation_pairs) on ``device`` (``None``:
        ``cuda:0``).  No padding: the reduction is not compiled per
        shape, and zero rows and columns change no signer's count."""
        import numpy as np

        from bftkv_tpu_torch.ops import tally

        ids = sorted(set().union(*rows))
        index = {sid: i for i, sid in enumerate(ids)}
        sets = np.zeros((len(rows), len(ids)), dtype=bool)
        for r, row in enumerate(rows):
            for sid in row:
                sets[r, index[sid]] = True
        mask = tally.equivocation_pairs(sets, device=device).cpu().numpy()
        return {ids[i] for i in np.nonzero(mask)[0]}

    def _do_revoke(self, sid: int) -> None:
        node = self.crypt.keyring.get(sid)
        if node is None:
            node = Ref(sid)
        self.self_node.revoke(node)
        vcache.invalidate_signer(sid)
        metrics.incr("client.revocations")

    # -- TPA rounds (reference: client.go:359-474) ------------------------

    def authenticate(self, variable: bytes, cred: bytes):
        """Threshold password authentication.  Returns ``(proof, key)``:
        the collective-signature proof and the symmetric cipher key
        (reference: client.go:359-377)."""
        q = qm.choose_quorum_for(self.qs, variable, qm.AUTH | qm.PEER)
        aclient = authmod.AuthClient(
            cred, len(q.nodes()), q.get_threshold(), device=self.device
        )
        try:
            proof = self._do_authentication(aclient, variable, q)
        except ERR_NO_AUTHENTICATION_DATA:
            # Virgin variable: distribute fresh auth params, then retry.
            self._setup_auth_params(variable, cred, q)
            proof = self._do_authentication(aclient, variable, q)
        key = aclient.get_cipher_key()
        return proof, key

    def _do_authentication(self, aclient, variable: bytes, q):
        nodes = q.nodes()
        pdata = aclient.initiate([n.id for n in nodes])
        phase = 0
        while not aclient.done(phase):
            mpkt = [
                pkt.serialize_auth_request(phase, variable, pdata[n.id])
                if n.id in pdata
                else None
                for n in nodes
            ]
            succ: list = []
            failure: list = []
            errs: list = []
            nextp = None

            def cb(res: tp.MulticastResponse) -> bool:
                nonlocal nextp
                err = res.err
                if err is None:
                    try:
                        out = aclient.process_response(
                            phase, res.data or b"", res.peer.id
                        )
                        succ.append(res.peer)
                        if out is not None:
                            nextp = out
                            return True
                        return False
                    except Exception as e:
                        err = e
                errs.append(err)
                failure.append(res.peer)
                return q.reject(failure)

            self.tr.multicast_m(tp.AUTH, nodes, mpkt, cb)
            if nextp is None:
                raise majority_error(errs, ERR_INSUFFICIENT_NUMBER_OF_SECRETS)
            pdata = nextp
            nodes = succ
            phase += 1

        # pdata now maps node id -> its released signature share.
        ss = None
        suff = False
        for data in pdata.values():
            try:
                share = pkt.parse_signature(data)
            except Exception:
                # Undecodable share from this node: skip it — the
                # threshold check below decides sufficiency.
                continue
            if share is None:
                continue
            ss, suff = self.crypt.collective.combine(
                ss, share, q, self.crypt.keyring
            )
        if not suff:
            raise ERR_INSUFFICIENT_NUMBER_OF_SIGNATURES
        return ss

    def _setup_auth_params(self, variable: bytes, cred: bytes, q) -> None:
        """Shamir-share a fresh secret across the quorum
        (reference: client.go:439-474)."""
        tbs = pkt.serialize(variable, None, 0, nfields=3)
        sig = self.crypt.signer.issue(tbs)
        params = authmod.generate_partial_auth_params(
            cred, len(q.nodes()), q.get_threshold(), device=self.device
        )
        mpkt = [
            pkt.serialize(variable, None, 0, sig, None, p) for p in params
        ]
        succ: list = []

        def cb(res: tp.MulticastResponse) -> bool:
            if res.err is None:
                succ.append(res.peer)
            return False  # broadcast to as many as possible

        self.tr.multicast_m(tp.SETAUTH, q.nodes(), mpkt, cb)
        if not q.is_sufficient(succ):
            raise ERR_INSUFFICIENT_NUMBER_OF_VALID_RESPONSES

    # -- distributed crypto (reference: client.go:480-546) ----------------

    def distribute(self, caname: str, key) -> None:
        """Deal threshold shares of ``key`` to an AUTH quorum
        (reference: client.go:480-507)."""
        # The CA name keys the shard so distribute and dist_sign agree
        # on which clique holds the threshold shares.
        q = qm.choose_quorum_for(self.qs, caname.encode(), qm.AUTH)
        k = q.get_threshold()
        secrets, algo = self.threshold.distribute(key, q.nodes(), k)
        mpkt = [
            pkt.serialize(caname.encode(), serialize_params(algo, s), nfields=2)
            for s in secrets
        ]
        succ = 0

        def cb(res: tp.MulticastResponse) -> bool:
            nonlocal succ
            if res.err is None:
                succ += 1
            return False

        self.tr.multicast_m(tp.DISTRIBUTE, q.nodes(), mpkt, cb)
        if succ < k:
            raise ERR_INSUFFICIENT_NUMBER_OF_RESPONSES

    def dist_sign(
        self, caname: str, tbs: bytes, algo: ThresholdAlgo, hash_name: str
    ) -> bytes:
        """Threshold-sign ``tbs`` with the CA key dealt under ``caname``;
        loops phases until the signature completes
        (reference: client.go:509-546)."""
        proc = self.threshold.new_process(tbs, algo, hash_name)
        while True:
            nodes, req = proc.make_request()
            if not nodes:
                raise ERR_INSUFFICIENT_NUMBER_OF_RESPONSES
            data = pkt.serialize(caname.encode(), req, nfields=2)
            sig_out = None
            err_out: Exception | None = None
            succ = 0
            errs: list = []

            def cb(res: tp.MulticastResponse) -> bool:
                nonlocal sig_out, err_out, succ
                if res.err is None and res.data is not None:
                    succ += 1
                    try:
                        sig_out = proc.process_response(res.data, res.peer)
                    except Exception as e:
                        err_out = e
                        return True
                    return sig_out is not None
                if res.err is not None:
                    errs.append(res.err)
                return False

            self.tr.multicast(tp.DISTSIGN, nodes, data, cb)
            if isinstance(err_out, ERR_CONTINUE):
                continue
            if err_out is not None:
                raise err_out
            if sig_out is not None:
                return sig_out
            if succ == 0:  # no more new responses
                raise majority_error(errs, ERR_INSUFFICIENT_NUMBER_OF_RESPONSES)
