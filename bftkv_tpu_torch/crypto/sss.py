"""Shamir secret sharing over Z_m (counterpart of
``bftkv_tpu/crypto/sss.py``).

Capability parity with the reference's SSS package
(reference: crypto/sss/sss.go:23-107): polynomial ``distribute``, an
incremental :class:`SSSProcess` that reconstructs once ``k`` shares have
arrived, and the ``lagrange`` coefficient helper used by the TPA and
threshold-DSA layers.

These are dealer/one-shot control-plane operations (a handful of bigint
muls per call), so they run host-side on Python ints; the hot modexp work
that *consumes* shares (TPA response combination, threshold signing) is
what runs on the card's kernels.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

__all__ = ["Coordinate", "SSSProcess", "distribute", "lagrange"]


@dataclass(frozen=True)
class Coordinate:
    """One share: the polynomial evaluated at x (x in 1..n)."""

    x: int
    y: int


def distribute(secret: int, n: int, k: int, m: int) -> list[Coordinate]:
    """Split ``secret`` into ``n`` shares, any ``k`` of which reconstruct.

    A random degree-(k-1) polynomial with constant term ``secret`` over
    Z_m, evaluated at x = 1..n (reference: sss.go:23-47).
    """
    if not (1 <= k <= n):
        raise ValueError("sss.distribute: need 1 <= k <= n")
    poly = [secret % m] + [secrets.randbelow(m) for _ in range(k - 1)]
    shares = []
    for i in range(1, n + 1):
        f = 0
        for c in reversed(poly):  # Horner
            f = (f * i + c) % m
        shares.append(Coordinate(i, f))
    return shares


def lagrange(x: int, xs: list[int], m: int) -> int:
    """Lagrange basis coefficient λ_x at 0 for sample points ``xs``
    (reference: sss.go:94-107)."""
    a = 1
    b = 1
    for xj in xs:
        if xj == x:
            continue
        a = a * xj
        b = b * (xj - x)
    return (a * pow(b, -1, m)) % m


class SSSProcess:
    """Accumulates shares; exposes the secret once k distinct ones arrive
    (reference: sss.go:49-92)."""

    def __init__(self, n: int, k: int, m: int, shares: list[Coordinate] = ()):
        self.n = n
        self.k = k
        self.m = m
        self._res: list[Coordinate] = []
        self.secret: int | None = None
        for s in shares:
            if self.process_response(s) is not None:
                break

    def process_response(self, share: Coordinate) -> int | None:
        """Feed one share; returns the secret once reconstructable."""
        if self.secret is not None:
            return self.secret
        if any(r.x == share.x for r in self._res):
            return None
        self._res.append(share)
        if len(self._res) == self.k:
            xs = [r.x for r in self._res]
            s = 0
            for r in self._res:
                s = (s + lagrange(r.x, xs, self.m) * r.y) % self.m
            self.secret = s
        return self.secret
