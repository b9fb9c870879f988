"""Threshold DSA: the mod-p instantiation of the dealerless core
(counterpart of ``bftkv_tpu/crypto/threshold/dsa.py``).

Capability parity with the reference (crypto/threshold/dsa/dsa.go):
partial R is ``g^{a_i} mod p``; the combine is
``r = (Π r_i^{λ_i})^{(Σ v_i λ_i)^{-1}} mod p mod q`` — here the Π term's
exponentiations run as one batched modexp launch (dsa.go:27-52): the RNS
modexp, kernel K2, on the group's ``device``.
"""

from __future__ import annotations

import io
import random
import secrets
import subprocess
from dataclasses import dataclass

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.crypto import sss
from bftkv_tpu_torch.crypto.threshold import ThresholdAlgo
from bftkv_tpu_torch.crypto.threshold.dsa_core import DsaContext, PartialR
from bftkv_tpu_torch.ops.modexp import BatchModExp
from bftkv_tpu_torch.packet import read_bigint, write_bigint

__all__ = ["DSAPrivateKey", "DSAGroup", "new", "generate"]


@dataclass(frozen=True)
class DSAPrivateKey:
    p: int
    q: int
    g: int
    x: int  # private
    y: int  # public = g^x mod p


def generate(key_size: int = 2048, *, seed: int | None = None) -> DSAPrivateKey:
    """FFC parameter + key generation (setup path only).

    With ``seed`` the group and the key are drawn from
    ``random.Random(seed)`` and are reproducible — for tests and smoke runs,
    never for real keys.  Without it: the host ``cryptography`` library
    when installed, else the ``openssl`` CLI, else the pure-Python
    generator on the ``secrets`` source."""
    if seed is not None:
        return _generate_py(key_size, random.Random(seed))
    try:
        from cryptography.hazmat.primitives.asymmetric import dsa as _cdsa
    except Exception:
        try:
            return _generate_openssl(key_size)
        except (OSError, subprocess.SubprocessError, ValueError):
            return _generate_py(key_size, secrets.SystemRandom())

    k = _cdsa.generate_private_key(key_size)
    nums = k.private_numbers()
    pub = nums.public_numbers
    par = pub.parameter_numbers
    return DSAPrivateKey(p=par.p, q=par.q, g=par.g, x=nums.x, y=pub.y)


def _generate_openssl(key_size: int) -> DSAPrivateKey:
    """``openssl dsaparam`` FFC params + our own x/y.

    Dss-Parms ::= SEQUENCE { p, q, g } — parsed with the same minimal
    DER reader the RSA fallback uses."""
    from bftkv_tpu_torch.crypto import rsa as _rsa

    pem = subprocess.run(
        ["openssl", "dsaparam", str(key_size)],
        capture_output=True,
        check=True,
        timeout=300,
    ).stdout
    der = _rsa._pem_der(pem, b"DSA PARAMETERS")
    p, q, g = _rsa._der_ints(der)[:3]
    x = secrets.randbelow(q - 1) + 1
    return DSAPrivateKey(p=p, q=q, g=g, x=x, y=pow(g, x, p))


def _generate_py(key_size: int, rng) -> DSAPrivateKey:
    """A prime q of 256 bits (160 below 2048-bit p), p = 2·q·m + 1 prime
    of ``key_size`` bits, g = h^((p−1)/q) ≠ 1, and x, y = g^x."""
    from bftkv_tpu_torch.crypto.rsa import _is_probable_prime

    qbits = 256 if key_size >= 2048 else 160
    while True:
        q = rng.getrandbits(qbits) | (1 << (qbits - 1)) | 1
        if _is_probable_prime(q, rng):
            break
    mbits = key_size - qbits - 1
    while True:
        m = rng.getrandbits(mbits) | (1 << (mbits - 1))
        p = 2 * q * m + 1
        if p.bit_length() == key_size and all(p % sp for sp in _SMALL_PRIMES) \
                and _is_probable_prime(p, rng):
            break
    h = 2
    while (g := pow(h, (p - 1) // q, p)) == 1:
        h += 1
    x = rng.randrange(1, q)
    return DSAPrivateKey(p=p, q=q, g=g, x=x, y=pow(g, x, p))


_SMALL_PRIMES = [n for n in range(3, 2000, 2) if all(n % d for d in range(3, int(n ** 0.5) + 1, 2))]


class _DSAGroupOps:
    def __init__(self, p: int, q: int, g: int, device=None):
        self.p = p
        self.q = q
        self.g = g
        self._engine = BatchModExp.shared(device)

    def calculate_partial_r(self, ai: int) -> bytes:
        ri = pow(self.g, ai, self.p)
        return ri.to_bytes((ri.bit_length() + 7) // 8 or 1, "big")

    def calculate_r(self, rs: list[PartialR]) -> int:
        """One kernel launch for the 2t Lagrange exponentiations
        (reference: dsa.go:33-52)."""
        xs = [pr.x for pr in rs]
        pairs = []
        v = 0
        for pr in rs:
            lam = sss.lagrange(pr.x, xs, self.q)
            pairs.append((int.from_bytes(pr.ri, "big"), lam))
            v = (v + pr.vi * lam) % self.q
        terms = self._engine.modexp(pairs, self.p)
        r = 1
        for t in terms:
            r = (r * t) % self.p
        v_inv = pow(v, -1, self.q)
        return pow(r, v_inv, self.p) % self.q

    def subgroup_order(self) -> int:
        return self.q

    def serialize(self, buf: io.BytesIO) -> None:
        write_bigint(buf, self.p)
        write_bigint(buf, self.q)
        write_bigint(buf, self.g)

    def os2i(self, os: bytes) -> int:
        order_size = (self.q.bit_length() + 7) // 8
        return int.from_bytes(os[:order_size], "big")


class DSAGroup:
    """The mod-p group plugin; its operations run their batched modexps
    on ``device`` (``None``: ``cuda:0``)."""

    def __init__(self, device=None):
        self.device = devmod.resolve(device)

    def parse_key(self, key: DSAPrivateKey):
        return _DSAGroupOps(key.p, key.q, key.g, self.device), key.x

    def parse_params(self, r: io.BytesIO) -> _DSAGroupOps:
        p = read_bigint(r)
        q = read_bigint(r)
        g = read_bigint(r)
        return _DSAGroupOps(p, q, g, self.device)


def new(crypt, *, device=None) -> DsaContext:
    return DsaContext(crypt, DSAGroup(device), ThresholdAlgo.DSA)
