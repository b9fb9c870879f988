"""Quorum interfaces (reference: quorum/quorum.go:10-29) (counterpart of ``bftkv_tpu/quorum/__init__.py``).

Access-type flags combine to pick quorum shape and trust distance:
``READ | AUTH`` for the timestamp phase, ``AUTH | PEER`` for signature
collection, ``WRITE`` for the store phase, ``AUTH | CERT`` for quorum-
certificate checks (reference call sites: protocol/client.go:64,101,141,
protocol/server.go:211).
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

READ = 0x01
WRITE = 0x02
AUTH = 0x04
CERT = 0x08
PEER = 0x10

__all__ = [
    "READ",
    "WRITE",
    "AUTH",
    "CERT",
    "PEER",
    "Quorum",
    "QuorumSystem",
    "KeyedQuorumSystem",
    "choose_quorum_for",
]


@runtime_checkable
class Quorum(Protocol):
    def nodes(self) -> list: ...

    def is_quorum(self, nodes: list) -> bool: ...

    def is_threshold(self, nodes: list) -> bool: ...

    def is_sufficient(self, nodes: list) -> bool: ...

    def reject(self, nodes: list) -> bool: ...

    def get_threshold(self) -> int: ...


@runtime_checkable
class QuorumSystem(Protocol):
    def choose_quorum(self, rw: int) -> Quorum: ...


@runtime_checkable
class KeyedQuorumSystem(QuorumSystem, Protocol):
    """Keyed variant: one namespace, many quorums.  ``x`` (the variable
    name) routes to the quorum clique that owns it, so all phases of one
    operation — time, sign-collect, write, read, certificate checks —
    agree on the shard.  Implementations MUST degenerate to
    ``choose_quorum(rw)`` on single-clique trust graphs."""

    def choose_quorum_for(self, x: bytes, rw: int) -> Quorum: ...


def choose_quorum_for(qs, x: bytes, rw: int) -> Quorum:
    """Route through the keyed API when the quorum system has one,
    falling back to the unkeyed ``choose_quorum`` otherwise — the ONE
    seam every protocol call site goes through, so custom/test quorum
    systems keep working unmodified."""
    fn = getattr(qs, "choose_quorum_for", None)
    if fn is not None:
        return fn(x, rw)
    return qs.choose_quorum(rw)
