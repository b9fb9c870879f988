"""Per-peer latency tracking: adaptive deadlines, hedge delays, and
gray-failure detection (counterpart of ``bftkv_tpu/transport/latency.py``).

"The Latency Price of Threshold Cryptosystems" (PAPERS.md) observes
that a threshold protocol is only as fast as its slowest *required*
responder — and the fixed ``BFTKV_RPC_TIMEOUT`` makes every dead or
gray (slow-but-alive) peer cost the full worst-case deadline per
fan-out.  This module closes that gap with three per-peer signals, all
derived from the RTTs the transport already observes on its pooled
connections (``transport._send`` times every post, success or
timeout):

- **adaptive deadline** — ``clamp(MULT x p99 + slack, FLOOR,
  rpc_timeout)``: a peer whose recent p99 is 40 ms stops being allowed
  to park a fan-out worker for the full 10 s; a peer with no samples
  keeps the configured worst case.  Exported as the
  ``transport.peer.deadline_ms`` gauge per peer.  The floor is
  deliberately generous (1 s default): an honest replica on a
  contended box must never be declared dead by its own good history.
- **hedge delay** — how long a *staged* fan-out waits for the current
  wave before launching the next one early
  (:func:`bftkv_tpu_torch.transport.multicast_staged`): ``clamp(HEDGE_MULT x
  p99 + slack, HEDGE_MIN, HEDGE_CAP)``.  Hedging is cheap (extra posts
  the quorum math already tolerates — amplification is bounded by the
  quorum size, the exact set the pre-staging fan-out always paid), so
  it fires early where the deadline fires late.
- **gray flag** — a sample far above the peer's own p50, OR a p50
  persistently above the fleet's (3x the median of the OTHER peers'
  p50s, compared within the peer's region class only — geography is
  not grayness, DESIGN.md §21), marks the peer gray for ``GRAY_SECS``
  (and bumps
  ``transport.peer.slow``, which the fleet collector turns into a
  ``gray_member`` anomaly).  Health-aware staging reads this flag to
  push gray peers out of the first wave.  The fleet-relative clause is
  what keeps a *consistently* slow peer flagged: a peer delayed on
  every post absorbs the delay into its own p50 within half a ring,
  and a purely self-relative rule would then clear the flag and drag
  the straggler back into the first wave forever.

All state is in-memory, advisory, and process-global (like
``transport.peer_health``): nothing here changes *which* responses a
quorum requires, only how long the client waits for whom, and in what
order it asks (DESIGN.md §13).
"""

from __future__ import annotations

import time
from collections import deque

from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = [
    "PeerLatency",
    "peer_latency",
    "adaptive_enabled",
    "hedging_enabled",
]


def _flag(name: str, default: str = "on") -> bool:
    return flags.raw(name, default).lower() not in ("off", "0", "false")


def adaptive_enabled() -> bool:
    """``BFTKV_ADAPTIVE_TIMEOUT`` — per-peer EWMA/quantile deadlines in
    place of the one fixed RPC timeout (default on)."""
    return _flag("BFTKV_ADAPTIVE_TIMEOUT")


def hedging_enabled() -> bool:
    """``BFTKV_HEDGE`` — hedged staged fan-out AND health-aware staging
    order (default on)."""
    return _flag("BFTKV_HEDGE")


def _link_of(addr: str) -> str:
    # Mirrors faults.failpoint.link_of without importing the chaos
    # plane into the hot path: scheme and path stripped.
    if "://" in addr:
        addr = addr.split("://", 1)[1]
    return addr.split("/", 1)[0]


class _Peer:
    __slots__ = (
        "ewma", "ring", "sorted", "dirty", "gray_until", "samples",
        "last_deadline_ms",
    )

    def __init__(self, ring_size: int):
        self.ewma = 0.0
        self.ring: deque[float] = deque(maxlen=ring_size)
        self.sorted: list[float] = []
        self.dirty = True
        self.gray_until = 0.0
        self.samples = 0
        self.last_deadline_ms = -1.0


class PeerLatency:
    """Per-peer RTT statistics over a bounded recent window.

    The window is small (32 samples) on purpose: a gray peer's recovery
    should be *believed* within a few dozen RPCs, and quantiles over a
    short ring track regime changes faster than long-horizon EWMAs.
    The EWMA (alpha 0.2) is kept alongside as the cheap ranking key for
    health-aware staging."""

    RING = 32
    ALPHA = 0.2
    #: Deadline shape: MULT x p99 + SLACK, clamped to [FLOOR, rpc_timeout].
    MULT = 8.0
    SLACK = 0.1
    #: Hedge-delay shape: HEDGE_MULT x p99 + HEDGE_SLACK in
    #: [HEDGE_MIN, HEDGE_CAP].
    HEDGE_MULT = 1.5
    HEDGE_SLACK = 0.01
    #: A sample above max(GRAY_FACTOR x p50, GRAY_ABS) flags the peer
    #: gray.  GRAY_ABS guards cold/noisy p50s: sub-100 ms jitter on a
    #: contended box must not cry wolf.
    GRAY_FACTOR = 3.0
    GRAY_ABS = 0.25
    GRAY_SECS = 10.0

    def __init__(self):
        self._lock = named_lock("transport.latency")
        self._peers: dict[str, _Peer] = {}
        self.floor = float(
            flags.raw("BFTKV_ADAPTIVE_FLOOR", "1.0") or 1.0
        )
        self.hedge_min = float(
            flags.raw("BFTKV_HEDGE_MIN", "0.02") or 0.02
        )
        self.hedge_cap = float(
            flags.raw("BFTKV_HEDGE_CAP", "0.5") or 0.5
        )

    def _peer(self, addr: str) -> _Peer:
        p = self._peers.get(addr)
        if p is None:
            p = self._peers.setdefault(addr, _Peer(self.RING))
        return p

    # -- recording ---------------------------------------------------------

    def record(self, addr: str, seconds: float, *, timeout: bool = False) -> None:
        """One observed RTT (or deadline expiry with ``timeout=True`` —
        the RTT was *at least* the deadline, which is exactly what the
        next deadline computation should see)."""
        if not addr:
            return
        now = time.monotonic()
        with self._lock:
            p = self._peer(addr)
            p.ring.append(seconds)
            p.dirty = True
            p.samples += 1
            p.ewma = (
                seconds
                if p.samples == 1
                else p.ewma + self.ALPHA * (seconds - p.ewma)
            )
            p50 = self._quantile_locked(p, 0.5)
            # Fleet-relative persistence: a peer whose OWN p50 sits
            # far above the other peers' median is gray even though
            # each sample looks normal against its own (shifted)
            # baseline.  None with <1 comparable other peer — the
            # self-relative rule then stands alone, as before.
            baseline = self._fleet_baseline_locked(addr)
            persistent = (
                baseline is not None
                and p.samples >= 4
                and p50 is not None
                and p50 > max(self.GRAY_FACTOR * baseline, self.GRAY_ABS)
            )
            slow = timeout or persistent or (
                p.samples >= 4
                and p50 is not None
                and seconds > max(self.GRAY_FACTOR * p50, self.GRAY_ABS)
            )
            if slow:
                was_gray = now < p.gray_until
                p.gray_until = now + self.GRAY_SECS
            elif (
                p50 is not None
                and seconds <= max(2.0 * p50, self.GRAY_ABS)
                and now < p.gray_until
            ):
                # A genuinely fast answer clears the flag early — a
                # recovered peer must not stay demoted for GRAY_SECS.
                # (A persistently-shifted p50 blocks this branch via
                # ``persistent`` until the ring has genuinely drained.)
                p.gray_until = 0.0
                slow = was_gray = False
        if slow and not was_gray:
            # The gray *transition*, not every slow sample: the fleet
            # collector turns the counter delta into one gray_member
            # anomaly per episode, not one per RPC.
            metrics.incr(
                "transport.peer.slow", labels={"peer": _link_of(addr)}
            )

    def _fleet_baseline_locked(self, exclude: str) -> float | None:
        """Median of the OTHER warmed-up peers' p50s **within the
        excluded peer's region class** — the fleet's idea of a normal
        RTT for peers at that distance, against which a persistently
        shifted peer is judged.  The region restriction is what makes
        gray detection WAN-correct: under an RTT matrix every
        cross-region peer's p50 legitimately sits multiples above the
        near peers' median, and a whole-fleet baseline would flag all
        of geography as gray (DESIGN.md §21).  With no region map
        every peer shares one class (None) and the clause behaves
        exactly as before.  None when fewer than one comparable other
        peer has history."""
        from bftkv_tpu_torch import regions as rg

        cls = rg.region_of(exclude)
        p50s = [
            q
            for a, p in self._peers.items()
            if a != exclude
            and rg.region_of(a) == cls
            and p.samples >= 4
            and (q := self._quantile_locked(p, 0.5)) is not None
        ]
        if not p50s:
            return None
        p50s.sort()
        return p50s[len(p50s) // 2]

    # -- queries -----------------------------------------------------------

    def _quantile_locked(self, p: _Peer, q: float) -> float | None:
        if not p.ring:
            return None
        if p.dirty:
            p.sorted = sorted(p.ring)
            p.dirty = False
        s = p.sorted
        return s[min(len(s) - 1, int(q * len(s)))]

    def quantile(self, addr: str, q: float) -> float | None:
        with self._lock:
            p = self._peers.get(addr)
            if p is None:
                return None
            return self._quantile_locked(p, q)

    def ewma(self, addr: str) -> float:
        with self._lock:
            p = self._peers.get(addr)
            return p.ewma if p is not None else 0.0

    def is_gray(self, addr: str) -> bool:
        with self._lock:
            p = self._peers.get(addr)
            return p is not None and time.monotonic() < p.gray_until

    def deadline(self, addr: str, rpc_timeout: float) -> float:
        """The per-RPC deadline for ``addr``: adaptive when enabled and
        the peer has history, else the configured worst case."""
        if not adaptive_enabled():
            return rpc_timeout
        with self._lock:
            p = self._peers.get(addr)
            if p is None or p.samples < 4:
                return rpc_timeout
            p99 = self._quantile_locked(p, 0.99) or 0.0
            dl = min(max(self.MULT * p99 + self.SLACK, self.floor),
                     rpc_timeout)
            ms = round(dl * 1000.0, 1)
            publish = ms != p.last_deadline_ms
            p.last_deadline_ms = ms
        if publish:
            metrics.gauge(
                "transport.peer.deadline_ms", ms,
                labels={"peer": _link_of(addr)},
            )
        return dl

    def hedge_delay(self, addrs: list[str]) -> float:
        """How long a staged fan-out should wait on the given wave
        before launching the next one: the slowest member's hedge
        delay (waiting for the wave means waiting for its straggler)."""
        out = self.hedge_min
        with self._lock:
            for addr in addrs:
                p = self._peers.get(addr)
                if p is None or p.samples < 2:
                    continue
                p99 = self._quantile_locked(p, 0.99) or 0.0
                out = max(out, self.HEDGE_MULT * p99 + self.HEDGE_SLACK)
        return min(out, self.hedge_cap)

    def reset(self) -> None:
        with self._lock:
            self._peers.clear()


peer_latency = PeerLatency()
