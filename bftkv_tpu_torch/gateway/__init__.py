"""Edge gateway tier: the stateless front door in front of the quorums.

Counterpart of ``bftkv_tpu/gateway/__init__.py``.

Every client today pays a full quorum fan-out per read and a WRITE_SIGN
round per write.  The gateway (ROADMAP item 1; "The Latency Price of
Threshold Cryptosystems" frames the win — keep threshold-crypto rounds
off the client-facing critical path) multiplexes that traffic:

- **certified read-through cache** (:mod:`bftkv_tpu_torch.gateway.cache`):
  the gateway fills from the quorums through the client's resolve path
  and VERIFIES the collective signature against the owner quorum on
  every fill — only a certified ``<x, t, v, ss>`` is ever cached or
  served, so a compromised gateway cannot forge reads (and the
  :class:`GatewayClient` re-verifies what it is served);
- **write coalescing** (:mod:`bftkv_tpu_torch.gateway.coalesce`): a
  same-variable write burst collapses into ONE piggybacked WRITE_SIGN
  round with per-caller acks fanned back out; cross-variable bursts
  batch per shard via ``choose_quorum_for``;
- **admission control / load shedding**: a bounded admission queue
  sheds excess load instantly (``gateway.shed``) instead of queueing
  it onto the quorums; gateway→quorum RPCs ride the hedged,
  health-ranked staged fan-out (DESIGN.md §13) and a fleet snapshot
  routes reads of degraded shards onto the stale-cache fallback.

Gateways are stateless (the cache is a soundness-checked accelerator,
never a source of truth) and horizontally stackable with zero
coordination: N gateways share one TOFU uid (topology.build_universe
``n_gateways``), so a variable written through one can be overwritten
through any other.  DESIGN.md §14.
"""

from bftkv_tpu_torch.gateway.cache import CertifiedCache
from bftkv_tpu_torch.gateway.client import GatewayClient, GatewayPeer
from bftkv_tpu_torch.gateway.coalesce import WriteCoalescer
from bftkv_tpu_torch.gateway.gateway import AdmissionQueue, Gateway

__all__ = [
    "AdmissionQueue",
    "CertifiedCache",
    "Gateway",
    "GatewayClient",
    "GatewayPeer",
    "WriteCoalescer",
]
