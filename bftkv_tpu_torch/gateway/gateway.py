"""The gateway process: certified front door over the existing transport.

Counterpart of ``bftkv_tpu/gateway/gateway.py``.

A :class:`Gateway` is wired exactly like a :class:`~bftkv_tpu_torch.protocol.
server.Server` — ``(self_node, qs, tr, crypt)`` from ``topology.
make_node`` — but holds no storage: its only state is a soundness-
checked cache.  It registers on the transport as a listener for the two
front-door commands (``GW_READ`` / ``GW_WRITE``, same encrypted
session envelope + nonce echo as every other command) and drives the
quorums through an internal protocol :class:`~bftkv_tpu_torch.protocol.
client.Client` — which means every upstream RPC inherits the hedged
staged fan-out, adaptive per-peer deadlines, and health-aware staging
order of DESIGN.md §13 for free.

Soundness (the certified-fill rule, DESIGN.md §14.2): every record the
gateway caches or serves has had its completed collective signature
verified against the OWNER quorum *by this gateway* — fills from the
client resolve path are re-verified at the cache boundary, a fill that
fails verification increments ``gateway.cache.verify_fail`` and is
never served, and TPA-protected records (proof-gated reads) are never
cached at all.  The gateway therefore cannot be tricked into serving a
fabrication, and a *compromised* gateway still cannot forge one — the
:class:`~bftkv_tpu_torch.gateway.client.GatewayClient` re-verifies the same
signature before trusting the bytes.
"""

from __future__ import annotations

import logging
import threading
import time

from bftkv_tpu_torch import flags
from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import quorum as qm
from bftkv_tpu_torch import regions as rg
from bftkv_tpu_torch import trace
from bftkv_tpu_torch import transport as tp
from bftkv_tpu_torch.errors import (
    ERR_GATEWAY_OVERLOADED,
    ERR_PERMISSION_DENIED,
    ERR_UNCERTIFIED_RECORD,
    ERR_UNKNOWN_COMMAND,
)
# AdmissionQueue lives in bftkv_tpu_torch/admission.py so the crypto sidecar
# shares the exact shed semantics (DESIGN.md §17.4); re-exported here
# for existing importers.
from bftkv_tpu_torch.admission import AdmissionQueue
from bftkv_tpu_torch.gateway.cache import CertifiedCache
from bftkv_tpu_torch.gateway.coalesce import WriteCoalescer
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.protocol.client import Client
from bftkv_tpu_torch.protocol.server import HIDDEN_PREFIX
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["AdmissionQueue", "Gateway"]

log = logging.getLogger("bftkv_tpu_torch.gateway")


class Gateway:
    #: How long a fill follower waits for the leader before taking the
    #: fill over itself (single-flight on hot-key miss storms).
    FILL_WAIT = 10.0

    def __init__(
        self,
        self_node,
        qs,
        tr,
        crypt,
        *,
        cache_max: int = 65536,
        cache_ttl: float = 30.0,
        max_inflight: int = 64,
        max_queue: int = 128,
        linger: float | None = None,
        device=None,
    ):
        """``device`` places the gateway client's crypto (``None``:
        ``cuda:0``, which raises without CUDA; ``"cpu"``: the plain
        versions)."""
        self.self_node = self_node
        self.qs = qs
        self.tr = tr
        self.crypt = crypt
        self.address = ""  # set by start()
        self.client = Client(self_node, qs, tr, crypt, device=device)
        # Write-through: every record the client certifies (collapsed
        # write tails, batched writes) re-verifies at the cache
        # boundary and replaces the stale entry — invalidation rides
        # the same plane that delivers the certified bytes.
        self.client.on_certified = self._on_certified
        self.cache = CertifiedCache(cache_max, cache_ttl)
        self.coalescer = WriteCoalescer(self.client, linger=linger)
        self.admission = AdmissionQueue(max_inflight, max_queue)
        self._fill_lock = named_lock("gateway.fill")
        self._fills: dict[bytes, threading.Event] = {}
        # Per-INSTANCE observability counters for /info: the process
        # metrics registry is shared tier-wide in one process, so
        # reporting its totals per gateway would double-count
        # (increments ride the same lock-free-ish sites the metrics
        # do; they are stats, and a lost race costs one count).
        self._hits = 0
        self._misses = 0
        self._verify_fails = 0
        #: Shards the fleet snapshot reports over budget — reads for
        #: them prefer a stale-but-certified cache entry over a fill
        #: that would pile onto a struggling quorum.
        self._degraded_shards: set = set()
        # Region-local read tier (DESIGN.md §21): a freshness lease
        # bounds how stale a same-region certified-cache read can be.
        # While the last sync-invalidation round completed recently
        # (every shard group answered its digest poll within
        # BFTKV_REGION_LEASE_S), TTL-expired entries may still be
        # served: every survivor was confirmed unchanged (or dropped)
        # at that poll, so staleness is bounded by TTL + lease + one
        # poll RTT instead of forcing a cross-region quorum fill.
        self._lease_s = flags.get_float("BFTKV_REGION_LEASE_S") or 0.0
        self._lease_until = 0.0
        self._lease_served = 0
        # Anti-entropy invalidation state: per-peer last-seen digest +
        # a STICKY peer cursor per shard group (a digest only means
        # something diffed against the SAME peer's previous one, so the
        # poll target moves only when the current one stops answering).
        self._digests: dict[int, dict[int, bytes]] = {}
        self._sync_cursor: dict[object, int] = {}
        self._sync_stop = threading.Event()
        self._sync_thread: threading.Thread | None = None

    # -- lifecycle ---------------------------------------------------------

    def start(self, addr: str) -> None:
        """Register the front-door listener at ``addr`` (the listen
        side of the configured dial address — gateway certificates
        carry none; see ``topology.Universe.gateways``)."""
        addr = addr.split("://", 1)[-1]
        self.address = addr
        self.tr.start(self, addr)
        log.info("gateway @ %s running", addr)

    def stop(self) -> None:
        self._sync_stop.set()
        self.coalescer.stop()
        self.tr.stop()

    # -- dispatch (the Server.handler shape) -------------------------------

    _handlers = {tp.GW_READ: "_gw_read", tp.GW_WRITE: "_gw_write"}

    def handler(self, cmd: int, data: bytes) -> bytes | None:
        plain, sender, nonce = self.crypt.message.decrypt(data)
        tctx, plain = pkt.unwrap_trace(plain)
        name = self._handlers.get(cmd)
        if name is None:
            raise ERR_UNKNOWN_COMMAND
        cmd_name = tp.COMMAND_NAMES.get(cmd, cmd)
        metrics.incr(f"gateway.{cmd_name}.count")
        run = getattr(self, name)
        if tctx is not None:
            with trace.attach(trace.SpanContext(*tctx)), trace.span(
                f"gateway.{cmd_name}",
                attrs={"node": getattr(self.self_node, "name", "")},
            ):
                res = run(plain, sender)
        else:
            res = run(plain, sender)
        return self.crypt.message.encrypt([sender], res or b"", nonce)

    # -- certified-fill rule ----------------------------------------------

    def _verify_certified(self, variable: bytes, raw: bytes):
        """The soundness gate every record crosses before the cache or
        a client sees it: parse, bind to the requested variable, and
        verify the COMPLETED collective signature against the owner
        quorum.  Returns the parsed packet; raises
        ``ERR_UNCERTIFIED_RECORD`` (and counts
        ``gateway.cache.verify_fail``) on any shortfall."""
        try:
            p = pkt.parse(raw)
            if (
                (p.variable or b"") != variable
                or p.sig is None
                or p.ss is None
                or not p.ss.completed
            ):
                raise ERR_UNCERTIFIED_RECORD
            qa = qm.choose_quorum_for(self.qs, variable, qm.AUTH)
            with trace.span("gateway.verify_fill"):
                try:
                    self.crypt.collective.verify(
                        pkt.tbss(raw), p.ss, qa, self.crypt.keyring
                    )
                except Exception:
                    # Dual-epoch migration window (DESIGN.md §15): a
                    # record the OLD owner clique certified while it
                    # owned the bucket is still a sound fill — retry
                    # against the dual quorum the route table names.
                    # Outside a window alt_quorums_for is empty and the
                    # failure stands (the Byzantine-fill signal).
                    alts = getattr(
                        self.qs, "alt_quorums_for", lambda *_a: []
                    )(variable, qm.AUTH)
                    if not alts:
                        raise
                    err = None
                    for alt in alts:
                        try:
                            self.crypt.collective.verify(
                                pkt.tbss(raw), p.ss, alt,
                                self.crypt.keyring,
                            )
                            err = None
                            break
                        except Exception as e:
                            err = e
                    if err is not None:
                        raise err
        except Exception:
            self._verify_fails += 1
            metrics.incr("gateway.cache.verify_fail")
            raise ERR_UNCERTIFIED_RECORD from None
        return p

    def _on_certified(self, variable: bytes, record: bytes) -> None:
        """Write-through fill from the client's certified-record plane
        (collapsed-write tails, batched writes).  Re-verified at the
        boundary — the certified-fill rule has no side doors."""
        try:
            p = self._verify_certified(variable, record)
        except Exception:
            return  # counted by _verify_certified; never cached
        if p.auth is not None:
            return  # proof-gated record: never cached
        if self.cache.put(variable, p.t, record):
            metrics.incr("gateway.cache.backfill_puts")

    # -- read path ---------------------------------------------------------

    def _shard_of(self, variable: bytes):
        shard_of = getattr(self.qs, "shard_of", None)
        if shard_of is None:
            return None
        try:
            return shard_of(variable)
        except Exception:
            return None

    def _gw_read(self, req: bytes, sender) -> bytes:
        p = pkt.parse(req)
        variable, proof = p.variable or b"", p.ss
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        ent = self.cache.get(variable)
        if ent is not None:
            self._hits += 1
            metrics.incr("gateway.cache.hits")
            return ent.record
        if self._lease_s > 0.0 and time.monotonic() < self._lease_until:
            # Live freshness lease: a TTL-expired entry that survived
            # the last complete digest poll is still within the §21
            # staleness bound — serve it at cache latency instead of
            # paying a (possibly cross-region) quorum fill.
            leased = self.cache.get(variable, allow_stale=True)
            if leased is not None:
                self._lease_served += 1
                metrics.incr("gateway.cache.lease_served")
                return leased.record
        self._misses += 1
        metrics.incr("gateway.cache.misses")
        # Single-flight: concurrent misses on one hot key ride the
        # leader's fill instead of stampeding the quorum.
        while True:
            with self._fill_lock:
                ev = self._fills.get(variable)
                if ev is None:
                    self._fills[variable] = ev = threading.Event()
                    break
            ev.wait(self.FILL_WAIT)
            ent = self.cache.get(variable)
            if ent is not None:
                # Counted as the miss it was; the leader's fill served
                # it without a quorum round of this request's own.
                metrics.incr("gateway.fill.coalesced")
                return ent.record
            # Leader failed or the record was uncacheable: take over.
        try:
            return self._fill(variable, proof)
        finally:
            with self._fill_lock:
                self._fills.pop(variable, None)
            ev.set()

    def _fill(self, variable: bytes, proof) -> bytes:
        if not self.admission.acquire("read"):
            raise ERR_GATEWAY_OVERLOADED
        try:
            with trace.span("gateway.fill"):
                value, t, record = self.client.read_certified(
                    variable, proof
                )
        except Exception:
            # Degraded owner shard: a certified-but-expired entry beats
            # an error when the fleet snapshot says the quorum is over
            # its fault budget (stale serving is flagged, never silent).
            sh = self._shard_of(variable)
            if sh is not None and sh in self._degraded_shards:
                stale = self.cache.get(variable, allow_stale=True)
                if stale is not None:
                    metrics.incr("gateway.cache.stale_served")
                    return stale.record
            raise
        finally:
            self.admission.release()
        if record is None:
            if value:
                # The read resolved a value but its certified bytes
                # could not be collected (races only — read_certified
                # re-collects them itself): failing honestly beats
                # serving "no data" for a variable that has one.
                metrics.incr("gateway.fill.record_missing")
                raise ERR_UNCERTIFIED_RECORD
            return b""  # empty read: nothing stored (never cached)
        parsed = self._verify_certified(variable, record)
        if parsed.auth is None:
            self.cache.put(variable, t, record)
            metrics.incr("gateway.cache.fills")
        return record

    # -- write path --------------------------------------------------------

    def _gw_write(self, req: bytes, sender) -> bytes | None:
        p = pkt.parse(req)
        variable, value = p.variable or b"", p.value or b""
        if variable.startswith(HIDDEN_PREFIX):
            raise ERR_PERMISSION_DENIED
        if not self.admission.acquire("write"):
            raise ERR_GATEWAY_OVERLOADED
        # Drop the stale entry BEFORE the round: the on_certified
        # write-through delivers the new record mid-flush, and the
        # cache's newer-t-wins rule lets a racing re-fill of the old
        # version lose to it — invalidating after the commit would
        # instead discard the freshly delivered record.
        self.cache.invalidate(variable)
        try:
            err = self.coalescer.submit_wait(variable, value)
        finally:
            self.admission.release()
        if err is not None:
            raise err
        metrics.incr("gateway.write.ok")
        return None

    # -- operator API helpers (cmd/run_gateway.py) -------------------------

    def read_value(self, variable: bytes, proof=None) -> bytes | None:
        """The gateway's own serving path, value-shaped — what the
        run_gateway HTTP API's ``/read/`` uses.  Same cache → admission
        → certified fill pipeline as a GW_READ."""
        raw = self._gw_read(
            pkt.serialize(variable, None, 0, None, proof), None
        )
        return pkt.parse(raw).value if raw else None

    def write_value(self, variable: bytes, value: bytes) -> None:
        self._gw_write(
            pkt.serialize(variable, value, 0, None, None), None
        )

    # -- fleet-snapshot routing (DESIGN.md §14.4) --------------------------

    def apply_fleet_snapshot(self, health: dict) -> None:
        """Feed a ``/fleet`` health document in: down members drop to
        the back of the upstream staging order (the client's own
        health-aware ranking), and shards whose f-budget is EXHAUSTED
        are marked degraded — their read misses prefer the
        stale-cache fallback over a fill that would stack more load on
        a quorum already past its masking bound."""
        self.client.apply_fleet_snapshot(health)
        degraded: set = set()
        for sh, sd in (health.get("shards") or {}).items():
            fb = sd.get("f_budget") or {}
            remaining = fb.get("remaining")
            if remaining is not None and remaining < 0:
                try:
                    degraded.add(int(sh))
                except (TypeError, ValueError):
                    degraded.add(sh)
        self._degraded_shards = degraded

    # -- anti-entropy invalidation (DESIGN.md §14.3) -----------------------

    def _sync_groups(self) -> dict[object, list]:
        """Addressed non-gateway peers grouped by shard (a digest only
        describes the serving replica's own slice, so every shard needs
        its own poll target)."""
        my_uid = getattr(self.self_node, "uid", None)
        peers = [
            n
            for n in self.self_node.get_peers()
            if getattr(n, "address", "") and getattr(n, "active", True)
            # Peer gateways share this tier's uid and answer
            # ERR_UNKNOWN_COMMAND to SYNC_DIGEST — skip them.
            and getattr(n, "uid", None) != my_uid
        ]
        idx_of = getattr(self.qs, "shard_index_of", None)
        seat_info = getattr(self.qs, "seat_info", None)
        groups: dict[object, list] = {}
        for n in peers:
            key = idx_of(n.id) if idx_of is not None else None
            groups.setdefault(key, []).append(n)
        # Storage-plane peers first: a collapsed write's certified
        # record lands there via the back-fill within the round, while
        # clique members keep commit-PENDING residue (invisible to
        # their digests) until the repair plane sweeps — polling a
        # clique member would lag the invalidation by a repair cycle.
        if seat_info is not None:
            def plane(n):
                # Addressed non-clique peers ARE the storage plane
                # (role is None for them on unsharded graphs).
                try:
                    return 1 if seat_info(n.id)["role"] == "clique" else 0
                except Exception:
                    return 0

            for key in groups:
                groups[key].sort(key=plane)
        return groups

    def sync_invalidate_round(self) -> int:
        """One cheap invalidation poll: SYNC_DIGEST from ONE sticky
        peer per shard group (a digest only diffs meaningfully against
        the same peer's previous one; the cursor advances only when
        that peer stops answering), dropping every cached entry whose
        bucket hash changed.  Returns entries dropped.  The TTL remains
        the backstop; this shortens the staleness window to ~one poll
        interval for write traffic the gateway never carried itself."""
        dropped = 0
        groups = self._sync_groups()
        polled_ok = bool(groups)
        for key, peers in sorted(
            groups.items(), key=lambda kv: str(kv[0])
        ):
            cursor = self._sync_cursor.setdefault(key, 0)
            peer = peers[cursor % len(peers)]
            box: dict = {}

            def cb(res: tp.MulticastResponse) -> bool:
                box["res"] = res
                return True

            self.tr.multicast(tp.SYNC_DIGEST, [peer], b"", cb)
            res = box.get("res")
            if res is None or res.err is not None or res.data is None:
                self._sync_cursor[key] = cursor + 1  # dead: move on
                polled_ok = False
                continue
            try:
                theirs = pkt.parse_digest(res.data)
            except Exception:
                self._sync_cursor[key] = cursor + 1
                polled_ok = False
                continue
            prev = self._digests.get(peer.id)
            self._digests[peer.id] = theirs
            if prev is None:
                continue  # first sighting: nothing to diff against
            changed = [
                b
                for b in set(theirs) | set(prev)
                if theirs.get(b) != prev.get(b)
            ]
            dropped += sum(
                self.cache.invalidate_bucket(b) for b in changed
            )
        if dropped:
            metrics.incr("gateway.cache.sync_invalidated", dropped)
        if self._lease_s > 0.0 and polled_ok:
            # Every shard group answered: surviving cache entries were
            # confirmed unchanged (changed buckets just dropped), so
            # the freshness lease renews.  A failed poll lets the lease
            # lapse — stale serving must never outrun the digest plane.
            self._lease_until = time.monotonic() + self._lease_s
        return dropped

    def start_sync_invalidation(self, interval: float = 5.0) -> None:
        if self._sync_thread is not None:
            return
        self._sync_stop = threading.Event()

        def loop():
            while not self._sync_stop.wait(interval):
                try:
                    self.sync_invalidate_round()
                except Exception:
                    log.exception("gateway sync-invalidation failed")

        self._sync_thread = threading.Thread(
            target=loop, daemon=True, name="bftkv-gw-sync"
        )
        self._sync_thread.start()

    # -- observability -----------------------------------------------------

    def info(self) -> dict:
        """The ``/info`` document the fleet collector scrapes.  ``role``
        = "gateway" keeps this member OUT of the clique f-budget math —
        a gateway is not a quorum seat (obs/collector.py)."""
        g = self.self_node
        inflight, waiting = self.admission.depth()
        return {
            "name": getattr(g, "name", ""),
            "id": f"{g.get_self_id():016x}",
            "addr": getattr(self, "address", ""),
            "role": "gateway",
            "shard": None,
            "clique": None,
            "region": rg.self_region(getattr(g, "name", None)),
            "gateway": {
                **self.cache.stats(),
                "lease_served": self._lease_served,
                "lease_live": (
                    self._lease_s > 0.0
                    and time.monotonic() < self._lease_until
                ),
                # Per-INSTANCE counters: several gateways in one
                # process share the metrics registry, so snapshot
                # totals would report the whole tier as each member.
                "hits": self._hits,
                "misses": self._misses,
                "verify_fail": self._verify_fails,
                "shed": self.admission.shed,
                "inflight": inflight,
                "queued": waiting,
                "degraded_shards": sorted(
                    str(s) for s in self._degraded_shards
                ),
            },
        }
