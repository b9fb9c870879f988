"""Presession pump: per-peer session/lease material kept warm OFF the
write critical path (TALUS' one-round-online recipe; counterpart of
``bftkv_tpu/crypto/presession.py``).

"The Latency Price of Threshold Cryptosystems" and TALUS both observe
that round count — not crypto cost — dominates threshold-protocol
latency, and that the fix is to move every piece of per-operation setup
that does not depend on the value being written out of the online
phase.  For this store that setup is:

- **transport sessions** — a cold peer costs a bootstrap envelope (one
  RSA sign + per-recipient OAEP both ways) on the first fan-out that
  touches it.  The pump probes the hot quorums' peers and re-seals the
  cold ones with a no-op NOTIFY post, so steady-state writes only ever
  pay the symmetric session path (``crypto.session.reseal`` counts
  pump-driven reseals, same series as the transport's unknown-session
  retry);
- **timestamp leases** — the highest timestamp this client committed
  (or resolved on read) per variable.  The piggybacked write guesses
  ``lease + 1`` (or 1 for a variable it has never touched) instead of
  paying a TIME round; a stale guess costs one in-round decline+retry
  (the servers answer with their stored timestamp — packet.WS_DECLINE),
  never a safety risk: servers refuse to sign at-or-below their stored
  timestamp, so an optimistic client can never be tricked into — or
  punished for — double-signing (DESIGN.md §12);
- **share-combination state** — the sign quorum's signer-id → certificate
  map, resolved once per quorum object instead of per share arrival, so
  the in-round combine is dict lookups.

The pump is a daemon thread started lazily on the first piggybacked
write (``BFTKV_PRESESSION=off`` disables pump AND leases — every write
then re-discovers its timestamp in-round).  All state is in-memory and
LRU-bounded; nothing here carries authority — leases are guesses the
quorum corrects, sessions are transport plumbing.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.devtools.lockwatch import named_lock

__all__ = ["Presession", "enabled"]

MAX_UINT64 = 2**64 - 1


def enabled() -> bool:
    return flags.raw("BFTKV_PRESESSION", "on").lower() not in (
        "off", "0", "false",
    )


class Presession:
    """One client's presession state + pump.  Thread-safe; every method
    is cheap enough for the write hot path."""

    #: Bounds: leases are 8-byte ints, quorum maps a handful of refs.
    LEASE_MAX = 65536
    QUORUM_MEMO_MAX = 64

    def __init__(self, client, *, interval: float = 5.0):
        self.client = client
        self.interval = interval
        self._lock = named_lock("crypto.presession")
        self._leases: "OrderedDict[bytes, int]" = OrderedDict()
        # id(quorum) -> (quorum strong ref, {signer id: cert}); the
        # strong ref pins the id so a recycled address can never alias.
        self._signer_maps: "OrderedDict[int, tuple]" = OrderedDict()
        # Peers the pump keeps warm: the union of every quorum noted by
        # the write path (bounded: peers re-note on every write).
        self._warm_peers: "OrderedDict[int, object]" = OrderedDict()
        self._pump: threading.Thread | None = None
        self._stop = threading.Event()

    # -- timestamp leases --------------------------------------------------

    def next_t(self, variable: bytes) -> int:
        """The optimistic timestamp for the next write of ``variable``:
        one past this client's lease, or 1 for a variable it has never
        written (servers hold t=0 for fresh variables, so 1 is the
        first admissible guess).  A lease at the write-once ceiling
        still guesses 1 — the quorum answers ERR_NO_MORE_WRITE, which
        is the correct outcome, and the guess must never accidentally
        equal 2^64-1 (that value IS the write-once marker)."""
        if not enabled():
            return 1
        with self._lock:
            t = self._leases.get(variable)
        if t is None or t >= MAX_UINT64 - 1:
            return 1
        return t + 1

    def lease_update(self, variable: bytes, t: int) -> None:
        """Record a committed (or read-resolved) timestamp; leases only
        move forward."""
        if not enabled():
            return
        with self._lock:
            if t > self._leases.get(variable, 0):
                self._leases[variable] = t
                self._leases.move_to_end(variable)
                while len(self._leases) > self.LEASE_MAX:
                    self._leases.popitem(last=False)

    def lease_drop(self, variable: bytes) -> None:
        with self._lock:
            self._leases.pop(variable, None)

    # -- share-combination state -------------------------------------------

    def signer_map(self, quorum) -> dict[int, object]:
        """``{signer id: certificate}`` over ``quorum``'s members —
        the combine step's resolution table, computed once per quorum
        object (wotqs memoizes quorums per (access, generation), so the
        object identity IS the cache key)."""
        key = id(quorum)
        with self._lock:
            hit = self._signer_maps.get(key)
            if hit is not None and hit[0] is quorum:
                self._signer_maps.move_to_end(key)
                return hit[1]
        m = {n.id: n for n in quorum.nodes()}
        with self._lock:
            self._signer_maps[key] = (quorum, m)
            self._signer_maps.move_to_end(key)
            while len(self._signer_maps) > self.QUORUM_MEMO_MAX:
                self._signer_maps.popitem(last=False)
        return m

    # -- session warming ---------------------------------------------------

    def note_peers(self, nodes: list) -> None:
        """Remember the peers of a quorum this client is actively
        writing through — the pump's warm set."""
        with self._lock:
            for n in nodes:
                self._warm_peers[n.id] = n
                self._warm_peers.move_to_end(n.id)
            while len(self._warm_peers) > 1024:
                self._warm_peers.popitem(last=False)

    def _cold_peers(self) -> list:
        sec = getattr(self.client.tr, "security", None)
        msg = getattr(sec, "message", None)
        if msg is None or not hasattr(msg, "has_session"):
            return []
        with self._lock:
            peers = list(self._warm_peers.values())
        return [
            n
            for n in peers
            if getattr(n, "address", "") and not msg.has_session(n.id)
        ]

    def warm_once(self) -> int:
        """One pump round: re-seal every cold warm-set peer with a
        no-op NOTIFY post (the bootstrap envelope it forces is exactly
        the session grant).  Returns how many peers were resealed.

        Peers whose circuit breaker is currently OPEN are skipped
        (``crypto.session.reseal_skipped``): a downed peer's bootstrap
        envelope is pure wasted pump work — each round would burn an
        RSA sign + OAEP wrap just to hit the breaker (or worse, eat a
        timeout probing it).  The read-only ``is_open`` check never
        consumes the breaker's half-open probe slot, so once the
        breaker half-opens the peer re-enters the pump naturally."""
        from bftkv_tpu_torch import transport as tp

        cold = self._cold_peers()
        skipped = [
            n
            for n in cold
            if tp.peer_health.is_open(getattr(n, "address", "") or "")
        ]
        if skipped:
            metrics.incr(
                "crypto.session.reseal_skipped", len(skipped)
            )
            open_ids = {id(n) for n in skipped}
            cold = [n for n in cold if id(n) not in open_ids]
        if not cold:
            return 0
        metrics.incr("crypto.session.reseal", len(cold), labels={"cmd": "presession"})
        try:
            # NOTIFY is a server-side no-op; its only effect here is the
            # bootstrap envelope that re-establishes the pairwise
            # session — off the write critical path, which is the point.
            self.client.tr.multicast(tp.NOTIFY, cold, b"", None)
        except Exception:
            pass  # a dead peer stays cold; the next round retries
        return len(cold)

    def ensure_pump(self) -> None:
        """Start the background pump (idempotent, lazy)."""
        if not enabled():
            return
        with self._lock:
            if self._pump is not None and self._pump.is_alive():
                return
            self._stop.clear()
            self._pump = threading.Thread(
                target=self._run, daemon=True, name="bftkv-presession"
            )
            self._pump.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.warm_once()
            except Exception:  # the pump must never die of one bad round
                pass
