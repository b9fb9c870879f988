"""Transport: the 13-command RPC fabric between mutually-distrusting nodes
(counterpart of ``bftkv_tpu/transport/__init__.py``).

Capability parity with the reference's transport core
(reference: transport/transport.go):

- command enum and URL mapping under ``/bftkv/v1/`` (transport.go:14-35);
- the shared **multicast fan-out**: one worker per peer doing
  POST → decrypt → nonce check, fan-in over a queue, with
  **callback-driven early termination** — returning True from the
  callback stops consuming; this is how quorum thresholds short-circuit
  network waits (transport.go:67-137);
- single-payload mode encrypts once to the whole recipient set;
  ``multicast_m`` encrypts per-peer (transport.go:101-109);
- every payload crosses the wire sign-then-encrypted with a nonce the
  responder must echo (replay protection, transport.go:121-124).

Byzantine-boundary note (SURVEY.md §5): replicas distrust each other, so
inter-replica traffic stays ordinary RPC — ICI/DCN collectives apply
only *inside* one replica's accelerator pool. This module is the
cross-replica backend; the device work it feeds is batched downstream
at the crypto layer.  Device seam: :func:`_inline_fanout_ok` asks the
installed dispatchers' calibration; on ``cuda`` it picks the threaded
fan-out, so concurrent handlers' crypto coalesce into shared launches.
"""

from __future__ import annotations

import queue
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Protocol

from bftkv_tpu_torch import packet as pkt
from bftkv_tpu_torch import trace
from bftkv_tpu_torch.errors import ERR_UNKNOWN_SESSION, new_error
from bftkv_tpu_torch.faults import failpoint as fp
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.transport.latency import (
    adaptive_enabled,
    hedging_enabled,
    peer_latency,
)
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = [
    "JOIN",
    "LEAVE",
    "TIME",
    "READ",
    "WRITE",
    "SIGN",
    "AUTH",
    "SETAUTH",
    "DISTRIBUTE",
    "DISTSIGN",
    "REGISTER",
    "REVOKE",
    "NOTIFY",
    "BATCH_TIME",
    "BATCH_SIGN",
    "BATCH_WRITE",
    "BATCH_READ",
    "SYNC_DIGEST",
    "SYNC_PULL",
    "WRITE_SIGN",
    "GW_READ",
    "GW_WRITE",
    "PREFIX",
    "COMMAND_NAMES",
    "MulticastResponse",
    "Transport",
    "TransportServer",
    "multicast",
    "multicast_staged",
    "record_rpc",
    "instrument_handler",
    "RetryPolicy",
    "PeerHealth",
    "peer_health",
    "peer_latency",
    "adaptive_enabled",
    "hedging_enabled",
    "current_deadline",
    "default_retry_policy",
]

# Command enum (reference: transport.go:14-28).
JOIN = 0
LEAVE = 1
TIME = 2
READ = 3
WRITE = 4
SIGN = 5
AUTH = 6
SETAUTH = 7
DISTRIBUTE = 8
DISTSIGN = 9
REGISTER = 10
REVOKE = 11
NOTIFY = 12
# Batch pipeline extensions (no reference analog — the reference calls
# every phase per-variable; these carry B independent requests in one
# round trip so server-side crypto batches into shared device launches,
# SURVEY §7's "protocol layer accumulating work into batches").
BATCH_TIME = 13
BATCH_SIGN = 14
BATCH_WRITE = 15
BATCH_READ = 16
# Anti-entropy plane (no reference analog — the reference repairs stale
# replicas only via client read-repair, client.go:281-302): peers
# exchange keyspace digests and stream only divergent records; pulled
# records pass the puller's FULL admission path, so these commands give
# a Byzantine peer no authority (sync/).
SYNC_DIGEST = 17
SYNC_PULL = 18
# Round-collapsed write (no reference analog — the reference pays a
# separate sign round before every write): ONE fan-out carries the
# writer-signed record; quorum members run the full sign-path checks,
# persist the record as commit-pending, and piggyback their
# collective-signature share inside the ack (packet.serialize_ws_ack).
# Old servers answer ERR_UNKNOWN_COMMAND and the client falls back to
# the classic time → sign → write rounds for that quorum.
WRITE_SIGN = 19
# Edge gateway tier (the reference's gateway/; no Go analog): the
# client-facing front-door commands.  GW_READ answers with a CERTIFIED
# record <x,t,v,ss> (cache hit or verified quorum fill — the gateway
# never serves bytes whose collective signature it has not verified
# against the owner quorum, and the GatewayClient re-verifies, so a
# compromised gateway cannot forge reads).  GW_WRITE hands the value to
# the gateway's write coalescer, which signs and commits it upstream
# under the gateway identity.  Quorum servers answer
# ERR_UNKNOWN_COMMAND to both — only a Gateway handles them.
GW_READ = 20
GW_WRITE = 21

PREFIX = "/bftkv/v1/"

COMMAND_NAMES = {
    JOIN: "join",
    LEAVE: "leave",
    TIME: "time",
    READ: "read",
    WRITE: "write",
    SIGN: "sign",
    AUTH: "auth",
    SETAUTH: "setauth",
    DISTRIBUTE: "distribute",
    DISTSIGN: "distsign",
    REGISTER: "register",
    REVOKE: "revoke",
    NOTIFY: "notify",
    BATCH_TIME: "batch_time",
    BATCH_SIGN: "batch_sign",
    BATCH_WRITE: "batch_write",
    BATCH_READ: "batch_read",
    SYNC_DIGEST: "sync_digest",
    SYNC_PULL: "sync_pull",
    WRITE_SIGN: "write_sign",
    GW_READ: "gw_read",
    GW_WRITE: "gw_write",
}
COMMANDS_BY_NAME = {v: k for k, v in COMMAND_NAMES.items()}

def record_rpc(
    transport: str, side: str, cmd_name: str, n_in: int, n_out: int
) -> None:
    """Shared byte/RPC accounting for every transport backend, so
    single-process (loopback/visual) clusters read the same
    ``transport.*`` series a deployed HTTP fleet does.  One label set
    per (transport, side, command) — all three dimensions are small
    closed enums, so cardinality stays bounded (DESIGN.md §7).  Byte
    directions are from the recording node's perspective."""
    labels = {"transport": transport, "side": side, "cmd": cmd_name}
    metrics.incr("transport.rpcs", labels=labels)
    if n_in:
        metrics.incr("transport.bytes_in", n_in, labels=labels)
    if n_out:
        metrics.incr("transport.bytes_out", n_out, labels=labels)


def instrument_handler(transport: str, handler: Callable) -> Callable:
    """Wrap a TransportServer handler with server-side
    :func:`record_rpc` accounting — shared by every backend's server
    seam (TrHTTP._dispatch, TrLoopback.start)."""

    def instrumented(cmd: int, data: bytes) -> bytes | None:
        res = None
        try:
            res = handler(cmd, data)
            return res
        finally:
            record_rpc(
                transport,
                "server",
                COMMAND_NAMES.get(cmd, str(cmd)),
                len(data or b""),
                len(res or b""),
            )

    return instrumented


ERR_TRANSPORT_SECURITY = new_error("transport: transport security error")
ERR_NONCE_MISMATCH = new_error("transport: nonce mismatch")
ERR_SERVER_ERROR = new_error("transport: server error")
ERR_NO_ADDRESS = new_error("transport: no address")
# Hardened-client vocabulary.  ERR_UNREACHABLE interns the same message
# as the loopback transport's (interning makes them the identical
# class); ERR_RPC_TIMEOUT is a per-RPC deadline expiry; ERR_PEER_OPEN
# is a post skipped because the peer's circuit breaker is open.
ERR_UNREACHABLE = new_error("transport: peer unreachable")
ERR_RPC_TIMEOUT = new_error("transport: rpc timeout")
ERR_PEER_OPEN = new_error("transport: peer circuit open")

#: Errors the retry policy may retry and the health tracker counts:
#: transport-level failures only — interned protocol errors (bad
#: timestamp, equivocation, ...) are *answers*, not outages.
_TRANSIENT = {
    ERR_SERVER_ERROR.message,
    ERR_UNREACHABLE.message,
    ERR_RPC_TIMEOUT.message,
}


class RetryPolicy:
    """Bounded jittered-backoff retries for one logical post.

    ``retries`` is the number of *re*-attempts after the first try (0 =
    off, the default — retry changes delivery to at-least-once, which
    is safe for this protocol's idempotent commands but is the
    operator's call).  Backoff doubles per attempt up to ``max_backoff``
    with ±50% jitter so synchronized clients do not re-stampede a
    recovering peer."""

    __slots__ = ("retries", "backoff", "max_backoff")

    def __init__(
        self,
        retries: int = 0,
        backoff: float = 0.05,
        max_backoff: float = 1.0,
    ):
        self.retries = retries
        self.backoff = backoff
        self.max_backoff = max_backoff

    def delay(self, attempt: int) -> float:
        base = min(self.backoff * (2 ** (attempt - 1)), self.max_backoff)
        return base * (0.5 + random.random())


#: Process default; a transport instance overrides with its own
#: ``retry_policy`` attribute.
default_retry_policy = RetryPolicy(
    retries=int(flags.raw("BFTKV_RPC_RETRIES", "0") or 0),
    backoff=float(flags.raw("BFTKV_RPC_BACKOFF", "0.05") or 0.05),
)


class PeerHealth:
    """Per-peer consecutive-failure tracking with a circuit breaker.

    After ``threshold`` consecutive transient failures a peer's circuit
    opens: posts to it are skipped instantly (``ERR_PEER_OPEN``)
    instead of each fan-out eating the full RPC timeout every round.
    After ``open_secs`` one probe is let through (half-open); success
    closes the circuit, failure re-opens it.  Disabled by default
    (``BFTKV_PEER_CB=1`` enables) — skipping a peer trades a little
    completeness for tail latency, which is an operator decision."""

    def __init__(
        self,
        threshold: int = 3,
        open_secs: float = 5.0,
        enabled: bool = False,
    ):
        self.threshold = threshold
        self.open_secs = open_secs
        self.enabled = enabled
        self._lock = named_lock("transport.breaker")
        # addr -> [consecutive_fails, open_until_monotonic]
        self._states: dict[str, list] = {}

    def allow(self, addr: str) -> bool:
        if not self.enabled:
            return True
        with self._lock:
            st = self._states.get(addr)
            if st is None or st[0] < self.threshold:
                return True
            now = time.monotonic()
            if now >= st[1]:
                # Half-open: this caller probes; concurrent callers keep
                # skipping until the probe resolves.
                st[1] = now + self.open_secs
                return True
            return False

    def ok(self, addr: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            st = self._states.pop(addr, None)
        if st is not None and st[0] >= self.threshold:
            metrics.incr("transport.peer.recovered")

    def fail(self, addr: str) -> None:
        if not self.enabled:
            return
        with self._lock:
            st = self._states.setdefault(addr, [0, 0.0])
            st[0] += 1
            st[1] = time.monotonic() + self.open_secs
            opened = st[0] == self.threshold  # the open *transition*
        if opened:
            metrics.incr("transport.peer.opens")

    def is_open(self, addr: str) -> bool:
        """Read-only open check — unlike :meth:`allow`, never consumes
        the half-open probe slot.  Health-aware staging and the
        presession pump use this to *look* without probing; the actual
        post still goes through ``allow()``."""
        if not self.enabled:
            return False
        with self._lock:
            st = self._states.get(addr)
            return (
                st is not None
                and st[0] >= self.threshold
                and time.monotonic() < st[1]
            )

    def open_peers(self) -> list[str]:
        with self._lock:
            now = time.monotonic()
            return [
                a
                for a, st in self._states.items()
                if st[0] >= self.threshold and now < st[1]
            ]

    def reset(self) -> None:
        with self._lock:
            self._states.clear()


peer_health = PeerHealth(
    threshold=int(flags.raw("BFTKV_PEER_CB_THRESHOLD", "3") or 3),
    open_secs=float(flags.raw("BFTKV_PEER_CB_OPEN_SECS", "5") or 5),
    enabled=flags.raw("BFTKV_PEER_CB", "") == "1",
)


@dataclass
class MulticastResponse:
    """(reference: transport.go:44-48)."""

    peer: object
    data: bytes | None
    err: Exception | None


class _DaemonPool:
    """Bounded, reusable daemon-thread pool for the multicast fan-out.

    The reference spawns one goroutine per peer per multicast
    (transport.go:110-127), which is cheap in Go; a Python thread is
    not — a three-phase write over 64 replicas would create ~200
    threads, and the old effectively-unbounded cap (4096) let every
    burst turn into raw thread churn on a 2-CPU box.  This pool grows
    lazily up to ``max_workers``, reuses idle workers, retires them
    after ``idle_ttl`` down to a small floor, and differs from
    ``concurrent.futures`` in two load-bearing ways: workers are
    *daemonic* (abandoned early-exit posts must not block interpreter
    exit), and a **nested** submit — a handler running ON a pool worker
    fanning out again (loopback NOTIFY broadcast) — may spawn past the
    cap.  Without that escape a full pool of workers each waiting on
    its own nested fan-out is a circular-wait deadlock; with it the
    overflow is bounded by the nesting degree, not the burst size.
    ``transport.pool.saturated`` counts submits that had to queue
    behind the cap.
    """

    IDLE_TTL = 10.0
    MIN_WORKERS = 4

    def __init__(self, max_workers: int | None = None):
        if max_workers is None:
            max_workers = int(
                flags.raw("BFTKV_FANOUT_WORKERS", "256") or 256
            )
        # SimpleQueue: C-implemented put/get — the shared Condition
        # machinery of queue.Queue was a measured lock convoy with ~100
        # workers contending one mutex.
        self._q: "queue.SimpleQueue[Callable[[], None]]" = queue.SimpleQueue()
        self._lock = named_lock("transport.pool.workers")
        self._idle = 0
        self._count = 0
        self._max = max_workers
        self._tls = threading.local()

    def submit(self, fn: Callable[[], None]) -> None:
        # Reserve a worker *at submit time*: either claim an idle one or
        # spawn. Without the reservation, a burst of submits all observe
        # the same not-yet-woken idle worker and pile onto one thread —
        # serializing the fan-out and, for nested multicasts, queueing a
        # task behind the very worker that waits on it.
        with self._lock:
            if self._idle > 0:
                self._idle -= 1
                spawn = False
            elif self._count < self._max:
                self._count += 1
                spawn = True
            elif getattr(self._tls, "in_worker", False):
                # Nested fan-out from a saturated pool: spawning past
                # the cap is the deadlock escape (see class doc).
                self._count += 1
                spawn = True
                metrics.incr("transport.pool.nested_overflow")
            else:
                spawn = False  # cap: task waits for the next free worker
                metrics.incr("transport.pool.saturated")
            busy, cap = self._count - self._idle, self._max
        # Capacity-plane gauges, outside the pool lock (the metrics
        # registry lock is independent; values are the snapshot above).
        metrics.gauge(
            "transport.pool.busy", float(busy),
            labels={"resource": "fanout_pool"},
        )
        metrics.gauge(
            "transport.pool.cap", float(cap),
            labels={"resource": "fanout_pool"},
        )
        self._q.put(fn)
        if spawn:
            threading.Thread(
                target=self._worker, daemon=True, name="bftkv-fanout"
            ).start()

    def _worker(self) -> None:
        self._tls.in_worker = True
        while True:
            try:
                fn = self._q.get(timeout=self.IDLE_TTL)
            except queue.Empty:
                # Idle past the TTL: retire down to the floor.  A claim
                # racing this timeout decremented _idle already, so the
                # guard also guarantees the claimed task keeps a worker.
                with self._lock:
                    if self._idle > 0 and self._count > self.MIN_WORKERS:
                        self._idle -= 1
                        self._count -= 1
                        return
                continue
            try:
                fn()
            except Exception:  # workers must survive any task error
                pass
            with self._lock:
                self._idle += 1


_pool = _DaemonPool()


class TransportServer(Protocol):
    """(reference: transport.go:50-52)."""

    def handler(self, cmd: int, data: bytes) -> bytes | None: ...


class Transport(Protocol):
    """(reference: transport.go:54-65)."""

    def multicast(
        self, cmd: int, peers: list, data: bytes | None, cb: Callable
    ) -> None: ...

    def multicast_m(
        self, cmd: int, peers: list, mdata: list[bytes], cb: Callable
    ) -> None: ...

    def start(self, o: TransportServer, addr: str) -> None: ...

    def stop(self) -> None: ...

    def post(self, addr: str, msg: bytes) -> bytes: ...

    def generate_random(self) -> bytes: ...

    def encrypt(self, peers: list, plain: bytes, nonce: bytes) -> bytes: ...

    def decrypt(self, data: bytes) -> tuple[bytes, object, bytes]: ...


def multicast(
    tr: Transport,
    cmd: int,
    peers: list,
    mdata: list[bytes | None],
    cb: Callable[[MulticastResponse], bool] | None,
) -> None:
    """Shared fan-out helper (reference: transport.go:67-137).

    ``mdata`` with one element = single-payload mode (encrypt once to
    the whole peer set); len(mdata) == len(peers) = per-peer payloads.
    The callback runs on the caller's thread; returning True stops the
    fan-in (in-flight posts complete in their workers and are dropped).
    """
    if not peers:
        return
    name = COMMAND_NAMES.get(cmd)
    if name is None:
        raise new_error("transport: unknown command")
    # Snapshot the caller's trace context ONCE: encryption happens on
    # this thread (single-payload mode encrypts once for all peers, so
    # per-peer parents are impossible by construction) and the context
    # rides INSIDE the encrypted payload (packet.wrap_trace).  Server
    # spans parent to the caller's phase span; the per-peer rpc spans
    # below are its siblings.
    ctx = trace.capture()
    ch: "queue.SimpleQueue[MulticastResponse]" = queue.SimpleQueue()
    cipher = None
    nonce = None
    payload = None
    launched = 0
    # Single-payload mode seals the shared plaintext ONCE per *session
    # group* instead of per peer: recipients holding a pairwise session
    # share one session envelope; the cold remainder shares one
    # bootstrap envelope (MessageSecurity.encrypt_grouped).  Without
    # the split, one sessionless peer in the set degraded every round
    # to a full per-recipient bootstrap re-encryption.
    grouped: list | None = None
    if len(mdata) == 1 and len(peers) > 1:
        payload = mdata[0] or b""
        if ctx is not None:
            payload = pkt.wrap_trace(ctx.trace_id, ctx.span_id, payload)
        grouped, g_nonce = _seal_grouped(tr, peers, payload)
        if grouped is not None:
            nonce = g_nonce  # fall back to the whole-set encrypt
    if (
        not fp.ARMED
        and getattr(tr, "INLINE_FANOUT", False)
        and _inline_fanout_ok()
    ):
        # In-process transport + calibrated all-host crypto: every post
        # is GIL-bound Python, so the one-thread-per-peer fan-out only
        # adds queue hand-offs and wake-up convoy — post inline on this
        # thread, early-exiting at the callback's threshold; the
        # remaining peers' posts ride ONE background task (delivery to
        # the full set is unchanged, exactly like the threaded path's
        # abandoned-but-completing workers).  The failpoint plane keeps
        # the threaded path: chaos delays must stack per-link, not
        # serialize through the caller.
        _multicast_inline(
            tr, name, peers, mdata, cb, ctx, grouped, nonce, payload, ch
        )
        return
    for i, peer in enumerate(peers):
        if grouped is not None:
            cipher = grouped[i]
        elif i < len(mdata):
            try:
                cipher, nonce, payload = _seal_one(tr, peers, mdata, i, ctx)
            except Exception as e:
                ch.put(MulticastResponse(peer, None, e))
                launched += 1
                continue

        _launch_post(tr, name, peer, cipher, nonce, payload, ctx, ch)
        launched += 1

    for _ in range(launched):
        mr = ch.get()
        if cb is not None and cb(mr):
            break  # early exit; remaining posts finish in their threads


def _seal_grouped(tr, peers: list, payload: bytes):
    """Attempt the warm/cold grouped sealing of one shared payload to
    the whole peer set.  Returns ``(per-peer ciphers, nonce)`` or
    ``(None, None)`` when the security layer cannot group (caller
    falls back to per-peer sealing).  Shared by :func:`multicast` and
    :func:`multicast_staged` so the fallback semantics cannot drift."""
    sec = getattr(tr, "security", None)
    msg_sec = getattr(sec, "message", None)
    if msg_sec is None or not hasattr(msg_sec, "encrypt_grouped"):
        return None, None
    nonce = tr.generate_random()
    try:
        return msg_sec.encrypt_grouped(peers, payload, nonce), nonce
    except Exception:
        return None, None


def _launch_post(tr, name, peer, cipher, nonce, payload, ctx, ch) -> None:
    """Submit one peer's post to the fan-out pool, traced.  Pool
    workers are reused across requests: attach() both parents the span
    to the captured context and shields the thread from any context a
    previous task leaked.  Shared by :func:`multicast` and
    :func:`multicast_staged`."""

    def work():
        addr = getattr(peer, "address", "")
        if not addr:
            ch.put(MulticastResponse(peer, None, ERR_NO_ADDRESS()))
            return
        if ctx is None:
            _post_one(tr, name, peer, addr, cipher, nonce, payload, ch)
            return
        with trace.attach(ctx), trace.span(
            f"rpc.{name}",
            attrs={"peer": getattr(peer, "name", "") or addr},
        ):
            _post_one(tr, name, peer, addr, cipher, nonce, payload, ch)

    _pool.submit(work)


def _seal_one(tr, peers: list, mdata: list, i: int, ctx):
    """Seal ``mdata``'s payload for the ``i``-th peer: fresh nonce,
    trace-wrap, and the single-payload-mode recipients slice (one
    element in ``mdata`` = encrypt once to the whole remaining set).
    Shared by the threaded loop, the inline loop, and the inline tail —
    raising on encrypt failure; callers own the error policy.
    Returns ``(cipher, nonce, payload)``."""
    nonce = tr.generate_random()
    payload = mdata[i] or b""
    if ctx is not None:
        payload = pkt.wrap_trace(ctx.trace_id, ctx.span_id, payload)
    recipients = peers[i : i + len(peers) - len(mdata) + 1]
    return tr.encrypt(recipients, payload, nonce), nonce, payload


def _inline_fanout_ok() -> bool:
    """Inline fan-out engages only when every installed dispatcher
    prefers host (calibration said the backend is all-host — CPU): on a
    real accelerator the threaded fan-out is what lets concurrent
    handlers' crypto coalesce into shared device launches."""
    if _INLINE_FANOUT == "0":
        return False
    if _INLINE_FANOUT == "1":
        return True
    from bftkv_tpu_torch.ops import dispatch

    for d in (dispatch.get(), dispatch.get_signer()):
        if d is not None and not d.prefer_host(1):
            return False
    return True


_INLINE_FANOUT = flags.raw("BFTKV_INLINE_FANOUT", "auto")


def _multicast_inline(
    tr, name, peers, mdata, cb, ctx, grouped, nonce, payload, ch
) -> None:
    """Sequential fan-out on the caller thread (see the call site).

    Single-payload mode uses the grouped ciphers (or one whole-set
    encrypt); per-peer mode encrypts as it goes.  After the callback
    stops the fan-in, the unsent remainder is posted by one pool task —
    responses discarded, exactly as the threaded path discards
    responses that arrive after an early exit."""
    cipher = None
    stop_at = len(peers)
    for i, peer in enumerate(peers):
        if grouped is not None:
            cipher = grouped[i]
        elif i < len(mdata):
            try:
                cipher, nonce, payload = _seal_one(tr, peers, mdata, i, ctx)
            except Exception as e:
                if cb is not None and cb(MulticastResponse(peer, None, e)):
                    stop_at = i + 1
                    break
                continue
        addr = getattr(peer, "address", "")
        if not addr:
            mr = MulticastResponse(peer, None, ERR_NO_ADDRESS())
        else:
            with trace.span(
                f"rpc.{name}",
                attrs={"peer": getattr(peer, "name", "") or addr},
            ):
                _post_one(tr, name, peer, addr, cipher, nonce, payload, ch)
            mr = ch.get()
        if cb is not None and cb(mr):
            stop_at = i + 1
            break
    if stop_at >= len(peers):
        return
    rest = list(
        zip(
            range(stop_at, len(peers)),
            peers[stop_at:],
        )
    )

    def post_tail():
        tail_ch: "queue.SimpleQueue" = queue.SimpleQueue()
        t_nonce, t_payload, t_cipher = nonce, payload, cipher
        with trace.attach(ctx):
            for j, peer in rest:
                if grouped is not None:
                    t_cipher = grouped[j]
                elif j < len(mdata):
                    try:
                        t_cipher, t_nonce, t_payload = _seal_one(
                            tr, peers, mdata, j, ctx
                        )
                    except Exception:
                        # Per-peer seal failure (no session, no cert):
                        # skip the peer; quorum thresholds decide.
                        continue
                addr = getattr(peer, "address", "")
                if addr:
                    _post_one(
                        tr, name, peer, addr, t_cipher, t_nonce, t_payload,
                        tail_ch,
                    )

    _pool.submit(post_tail)


#: Per-RPC deadline override, set by ``_send`` around each post so a
#: transport backend (TrHTTP) can honor the *adaptive* per-peer
#: deadline without a signature change to ``post()``.
_tls_deadline = threading.local()


def current_deadline(default: float) -> float:
    """The effective deadline for the RPC in flight on this thread:
    the adaptive per-peer deadline when one was computed, else
    ``default`` (the transport's fixed ``rpc_timeout``)."""
    v = getattr(_tls_deadline, "value", None)
    return default if v is None else v


def _inject_send_fault(tr, url, data, name, addr, deadline=None):
    """``transport.send`` failpoint: per-link drop / delay / duplicate /
    corrupt.  Returns the (possibly corrupted) payload to post, or
    raises the injected transport error."""
    if not fp.ARMED:
        # Callers guard too; this local guard keeps the zero-overhead
        # contract (no link_of/context construction) self-contained.
        return data
    act = fp.fire(
        "transport.send",
        src=fp.link_of(getattr(tr, "link_id", "") or ""),
        dst=fp.link_of(addr),
        cmd=name,
    )
    if act is None:
        return data
    if act.kind == "drop":
        raise ERR_UNREACHABLE
    if act.kind == "delay":
        secs = fp.delay_seconds(act)
        if deadline is None:
            deadline = getattr(tr, "rpc_timeout", None)
        if deadline is not None and secs >= deadline:
            # The peer "answers" after the deadline: the caller sees a
            # timeout, never the late bytes (loopback's analog of the
            # HTTP socket timeout).
            time.sleep(deadline)
            raise ERR_RPC_TIMEOUT
        with trace.span("fault.delay", attrs={"seconds": round(secs, 4)}):
            time.sleep(secs)
        return data
    if act.kind == "corrupt":
        return fp.corrupt_bytes(data, act.params["u"])
    if act.kind == "dup":
        # Deliver twice; the response to the duplicate is discarded.
        try:
            tr.post(url, data)
        except Exception:
            pass  # the duplicate's response is deliberately discarded
        return data
    return data


def _send(tr, url, cipher, name, addr) -> bytes:
    """One logical post: fault injection, adaptive per-peer deadline,
    RTT recording, circuit-breaker accounting, and bounded
    jittered-backoff retries on *transient* transport errors (server
    error / unreachable / rpc timeout — never interned protocol
    errors, which are answers)."""
    policy = getattr(tr, "retry_policy", None) or default_retry_policy
    base_timeout = getattr(tr, "rpc_timeout", None)
    deadline = (
        peer_latency.deadline(addr, base_timeout)
        if base_timeout is not None
        else None
    )
    attempt = 0
    while True:
        t0 = time.perf_counter()
        try:
            data = cipher
            if fp.ARMED:
                data = _inject_send_fault(tr, url, data, name, addr, deadline)
            _tls_deadline.value = deadline
            try:
                res = tr.post(url, data)
            finally:
                _tls_deadline.value = None
            # Every successful post seeds the per-peer latency tracker
            # — this is where the connection pool's observed RTTs feed
            # the adaptive deadlines and hedge delays.
            peer_latency.record(addr, time.perf_counter() - t0)
            peer_health.ok(addr)
            return res
        except Exception as e:
            transient = getattr(e, "message", None) in _TRANSIENT
            if getattr(e, "message", None) == ERR_RPC_TIMEOUT.message:
                # A deadline expiry IS a latency sample: the RTT was at
                # least the deadline, and the gray flag must trip.
                peer_latency.record(
                    addr, time.perf_counter() - t0, timeout=True
                )
            attempt += 1
            if not transient or attempt > policy.retries:
                if transient:
                    peer_health.fail(addr)
                else:
                    # A non-transient error is an ANSWER (tunneled
                    # x-error / loopback raise): the peer is reachable,
                    # so it must close a half-open circuit — otherwise
                    # a recovered replica whose honest replies are
                    # protocol errors would stay skipped forever.
                    peer_health.ok(addr)
                raise
            metrics.incr("transport.retries", labels={"cmd": name})
            time.sleep(policy.delay(attempt))


def _any_unhealthy(peers: list) -> bool:
    """Whether any peer in the set is currently flagged unhealthy —
    open circuit breaker or gray (recently slow).  The hedged fan-out
    costs thread hand-offs the healthy inline path avoids, so it only
    engages when there is something to hedge against (or chaos is
    armed, where per-link delays need the threaded path anyway)."""
    for p in peers:
        addr = getattr(p, "address", "") or ""
        if addr and (peer_health.is_open(addr) or peer_latency.is_gray(addr)):
            return True
    return False


def multicast_staged(
    tr,
    cmd: int,
    waves: list[list],
    data: bytes | None,
    cb: Callable[[MulticastResponse], bool] | None,
    *,
    need_more: Callable[[], bool] | None = None,
    hedge: bool = True,
) -> dict:
    """Staged single-payload fan-out with hedging (DESIGN.md §13).

    ``waves`` is an ordered list of peer lists: wave 0 is the minimal
    prefix whose full success already satisfies the caller; later
    waves are asked only on shortfall.  ``need_more()`` is the
    shortfall predicate, consulted at every wave boundary; ``cb``
    follows :func:`multicast` semantics (returning True stops the
    fan-in), and the fan-out additionally stops once ``need_more()``
    goes False — a satisfied caller must not keep blocking on a
    straggler's response.

    With hedging armed (``BFTKV_HEDGE``, and either chaos armed or
    some peer flagged unhealthy), the waves run on the threaded pool
    and waiting longer than the peers' p99-derived hedge delay for the
    next response launches the next wave EARLY (``transport.hedge.sent``)
    instead of blocking on the straggler.  Amplification stays bounded
    by construction: the union of all waves is exactly the peer set a
    non-staged fan-out always posted to, so hedging can never exceed
    the classic ask-everyone cost; ``transport.hedge.wasted`` counts
    hedged posts whose responses went unused.  Otherwise the waves run
    as plain sequential multicasts (the pre-hedging behavior, inline
    fan-out included).

    Returns ``{"hedged": n, "wasted": n, "expanded": bool,
    "threaded": bool}``.
    """
    waves = [list(w) for w in waves if w]
    stats = {"hedged": 0, "wasted": 0, "expanded": False, "threaded": False}
    if not waves:
        return stats
    if need_more is None:
        need_more = lambda: True  # noqa: E731
    name = COMMAND_NAMES.get(cmd)
    if name is None:
        raise new_error("transport: unknown command")
    flat = [p for w in waves for p in w]
    if (
        not (hedge and hedging_enabled())
        or len(waves) == 1
        or not (fp.ARMED or _any_unhealthy(flat))
    ):
        multicast(tr, cmd, waves[0], [data], cb)
        for w in waves[1:]:
            if not need_more():
                break
            stats["expanded"] = True
            multicast(tr, cmd, w, [data], cb)
        return stats

    stats["threaded"] = True
    ctx = trace.capture()
    ch: "queue.SimpleQueue[MulticastResponse]" = queue.SimpleQueue()
    payload = data or b""
    if ctx is not None:
        payload = pkt.wrap_trace(ctx.trace_id, ctx.span_id, payload)
    # Grouped sealing over the whole union (the same warm/cold session
    # split the plain single-payload multicast uses); per-peer sealing
    # is the fallback.
    grouped, nonce = _seal_grouped(tr, flat, payload)
    offsets: list[int] = []
    off = 0
    for w in waves:
        offsets.append(off)
        off += len(w)

    def launch(base: int, peers_w: list) -> None:
        for j, peer in enumerate(peers_w):
            if grouped is not None:
                cipher, pn = grouped[base + j], nonce
            else:
                try:
                    pn = tr.generate_random()
                    cipher = tr.encrypt([peer], payload, pn)
                except Exception as e:
                    ch.put(MulticastResponse(peer, None, e))
                    continue
            _launch_post(tr, name, peer, cipher, pn, payload, ctx, ch)

    launch(offsets[0], waves[0])
    outstanding = len(waves[0])
    next_wave = 1
    hedged_ids: set[int] = set()
    answered_hedged = 0

    def wave_delay(w: list) -> float:
        return peer_latency.hedge_delay(
            [getattr(p, "address", "") or "" for p in w]
        )

    # The hedge trigger tracks the most recently LAUNCHED wave: with
    # locality-ordered staging wave 0 is same-region, so its (small)
    # p99 sets the trigger and a 150 ms cross-region member waiting in
    # a later wave can never inflate it; once a cross-region wave has
    # launched, the trigger honestly widens to that wave's own p99
    # (DESIGN.md §21).
    delay = wave_delay(waves[0])
    while outstanding > 0 or (next_wave < len(waves) and need_more()):
        if outstanding == 0:
            stats["expanded"] = True  # classic shortfall expansion
            launch(offsets[next_wave], waves[next_wave])
            outstanding += len(waves[next_wave])
            delay = max(delay, wave_delay(waves[next_wave]))
            next_wave += 1
            continue
        can_hedge = next_wave < len(waves) and need_more()
        try:
            mr = ch.get(timeout=delay if can_hedge else None)
        except queue.Empty:
            # No progress for one hedge delay: the next wave goes out
            # now; the straggler's post keeps running in its worker and
            # its response is still consumed if it arrives in time.
            w = waves[next_wave]
            launch(offsets[next_wave], w)
            hedged_ids.update(id(p) for p in w)
            stats["hedged"] += len(w)
            metrics.incr(
                "transport.hedge.sent", len(w), labels={"cmd": name}
            )
            outstanding += len(w)
            delay = max(delay, wave_delay(w))
            next_wave += 1
            continue
        outstanding -= 1
        if id(mr.peer) in hedged_ids:
            answered_hedged += 1
        if (cb is not None and cb(mr)) or not need_more():
            break  # satisfied: stragglers finish in their workers
    wasted = stats["hedged"] - answered_hedged
    if wasted > 0:
        stats["wasted"] = wasted
        metrics.incr(
            "transport.hedge.wasted", wasted, labels={"cmd": name}
        )
    return stats


def _post_one(tr, name, peer, addr, cipher, nonce, payload, ch) -> None:
    """One peer's post → decrypt → nonce check (the body of the fan-out
    worker, split out so the traced and untraced paths share it)."""
    try:
        url = addr + PREFIX + name
        if not peer_health.allow(addr):
            metrics.incr("transport.peer.skipped", labels={"cmd": name})
            ch.put(MulticastResponse(peer, None, ERR_PEER_OPEN()))
            return
        try:
            res = _send(tr, url, cipher, name, addr)
            plain, _sender, echoed = tr.decrypt(res)
        except ERR_UNKNOWN_SESSION:
            # The peer does not hold the session this envelope
            # used: restart, cache eviction, or our fast-path
            # envelope overtook its establishing bootstrap.
            # Retry once with a *forced* bootstrap for this peer
            # alone — self-contained, decryptable regardless of
            # the peer's session state.
            sec = getattr(tr, "security", None)
            if sec is None:
                raise
            sec.message.invalidate(peer.id)
            # Re-seal for THIS peer alone: the rest of the group keeps
            # its warm session envelopes (a restarted peer must not
            # degrade the whole fan-out back to bootstrap sealing).
            metrics.incr("crypto.session.reseal", labels={"cmd": name})
            nonce2 = tr.generate_random()
            cipher2 = sec.message.encrypt(
                [peer], payload, nonce2, force_bootstrap=True
            )
            res = _send(tr, url, cipher2, name, addr)
            plain, _sender, echoed = tr.decrypt(res)
            if echoed != nonce2:
                ch.put(MulticastResponse(peer, None, ERR_NONCE_MISMATCH()))
                return
            ch.put(MulticastResponse(peer, plain, None))
            return
        if echoed != nonce:
            ch.put(MulticastResponse(peer, None, ERR_NONCE_MISMATCH()))
            return
        ch.put(MulticastResponse(peer, plain, None))
    except Exception as e:
        ch.put(MulticastResponse(peer, None, e))
