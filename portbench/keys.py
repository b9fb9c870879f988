"""Seeded identity keys, made by the benchmark for both sides, in the
configuration's key algorithm.

- RSA: key ``i`` of a run is drawn from ``random.Random(f"{seed}/{bits}/{i}")``:
  two primes of ``bits/2`` bits found by a sieve over small primes and
  Miller-Rabin, with ``e = 65537``, in a pool of worker processes;
- P-256: key ``i`` is the scalar ``d`` in [1, n-1] drawn from
  ``random.Random(f"{seed}/p256/{i}")``, its public point ``Q = d·G``
  worked out by the reference's plain curve code.

The keys are made anew in every run and count as set-up: a seed's work is
the same in each of its runs, so no run finds them ready and another not.
"""

from __future__ import annotations

import multiprocessing
import os
import random
from concurrent.futures import ProcessPoolExecutor

from portbench.reference import p256, sigs

__all__ = ["E", "EcKey", "RsaKey", "generate", "make_keys"]

E = 65537

_SIEVE_SPAN = 1 << 13
_MR_ROUNDS = 8


def _small_primes(limit: int) -> list[int]:
    mark = bytearray([1]) * limit
    mark[0:2] = b"\x00\x00"
    for i in range(2, int(limit ** 0.5) + 1):
        if mark[i]:
            mark[i * i :: i] = bytearray(len(mark[i * i :: i]))
    return [i for i in range(3, limit) if mark[i]]


_SMALL = _small_primes(1 << 14)


class RsaKey:
    """An RSA private key as plain integers (``n = p·q``, ``d·e ≡ 1``)."""

    __slots__ = ("n", "e", "d", "p", "q")

    def __init__(self, n: int, e: int, d: int, p: int, q: int):
        self.n, self.e, self.d, self.p, self.q = n, e, d, p, q

    def as_tuple(self) -> tuple[int, int, int, int, int]:
        return (self.n, self.e, self.d, self.p, self.q)

    @property
    def public(self) -> tuple:
        """The reference's tagged public key (:mod:`portbench.reference.sigs`)."""
        return (sigs.RSA, (self.n, self.e))

    @property
    def private(self) -> tuple:
        return (sigs.RSA, self.as_tuple())


class EcKey:
    """A P-256 private key ``d`` and its public point ``(x, y) = d·G``."""

    __slots__ = ("d", "x", "y")

    def __init__(self, d: int, x: int, y: int):
        self.d, self.x, self.y = d, x, y

    @property
    def public(self) -> tuple:
        return (sigs.P256, (self.x, self.y))

    @property
    def private(self) -> tuple:
        return (sigs.P256, (self.d, self.x, self.y))


def _miller_rabin(n: int, rng: random.Random) -> bool:
    d, r = n - 1, 0
    while not d & 1:
        d >>= 1
        r += 1
    bases = [2] + [rng.randrange(3, n - 2) for _ in range(_MR_ROUNDS - 1)]
    for a in bases:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(bits: int, rng: random.Random) -> int:
    while True:
        start = rng.getrandbits(bits) | (3 << (bits - 2)) | 1
        # Odd candidates start + 2j, j < span: strike those a small prime divides.
        alive = bytearray([1]) * _SIEVE_SPAN
        for p in _SMALL:
            j = (-start * pow(2, -1, p)) % p
            alive[j::p] = bytearray(len(alive[j::p]))
        for j in range(_SIEVE_SPAN):
            if not alive[j]:
                continue
            c = start + 2 * j
            if c.bit_length() != bits or c % E == 1:
                continue
            if pow(2, c - 1, c) == 1 and _miller_rabin(c, rng):
                return c


def generate(bits: int, label: str) -> tuple[int, int, int, int, int]:
    """One key, as ``(n, e, d, p, q)``, drawn from ``label``."""
    rng = random.Random(label)
    while True:
        p = _prime(bits // 2, rng)
        q = _prime(bits - bits // 2, rng)
        n = p * q
        if p == q or n.bit_length() != bits:
            continue
        d = pow(E, -1, (p - 1) * (q - 1))
        return (n, E, d, p, q)


def _generate_job(job: tuple[int, str]) -> tuple[int, int, int, int, int]:
    return generate(*job)


def _p256_key(label: str) -> EcKey:
    d = 1 + random.Random(label).randrange(p256.N - 1)
    return EcKey(d, *p256.base_mult(d))


def make_keys(seed: int, count: int, bits: int, *, algorithm: str = sigs.RSA,
              workers: int | None = None) -> list:
    """``count`` keys of ``algorithm`` ("rsa" of ``bits`` bits, or "p256",
    whose ``bits`` is 256) for ``seed``."""
    if algorithm == sigs.P256:
        if bits != 256:
            raise ValueError(f"P-256 keys are 256 bits, not {bits}")
        return [_p256_key(f"{seed}/p256/{i}") for i in range(count)]
    if algorithm != sigs.RSA:
        raise ValueError(f"key algorithm {algorithm!r}: the harness makes {sigs.ALGORITHMS}")
    jobs = [(bits, f"{seed}/{bits}/{i}") for i in range(count)]
    workers = workers or min(count, os.cpu_count() or 1)
    if workers <= 1:
        tuples = [_generate_job(job) for job in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            tuples = list(pool.map(_generate_job, jobs))
    return [RsaKey(*t) for t in tuples]
