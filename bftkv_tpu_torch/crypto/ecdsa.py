"""ECDSA P-256 identity keys: sign and verify, host and batched.

Counterpart of ``bftkv_tpu/crypto/ecdsa.py`` (its sign/verify half; the
ECIES key wrap waits for the port's ``crypto/aead.py``).  A cluster can
run on ECDSA P-256 certificates; this module supplies the primitives:

- deterministic ECDSA (RFC 6979 nonces) over SHA-256, fixed 64-byte
  ``r‖s`` signatures — :func:`sign` is byte-identical to the reference's;
- **batched signing** (:func:`sign_batch`): nonces are derived on the
  host, hedged with per-batch randomness, then all ``k·G`` base mults
  ride one batched launch (:func:`bftkv_tpu_torch.ops.ec.scalar_mult_hosts`;
  on ``cuda`` kernel K5);
- **batched verification** (:func:`verify_batch`): each item needs
  ``u1·G + u2·Q``; the 2·T scalar mults ride one launch, the T point
  adds stay on the host; malformed signatures and keys fail closed per
  item.

Both batches take ``device`` (default the card).  A device error
propagates to the caller: the host path serves small batches (below the
crossovers) and the sign fault hardening, never a failed launch.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets as pysecrets
from dataclasses import dataclass

from bftkv_tpu_torch import flags
from bftkv_tpu_torch.crypto import ec, rng
from bftkv_tpu_torch.metrics import registry as metrics

__all__ = [
    "ECPublicKey",
    "ECPrivateKey",
    "generate",
    "public_from_bytes",
    "sign",
    "sign_batch",
    "verify_host",
    "verify_batch",
]

SIG_BYTES = 64  # r ‖ s, 32 bytes each

#: Below these batch sizes the host path serves the batch: a launch costs
#: more than a few host P-256 ops (the reference's crossovers, kept).
VERIFY_HOST_CROSSOVER = 24
SIGN_HOST_CROSSOVER = 8


@dataclass(frozen=True)
class ECPublicKey:
    """P-256 public key; ``curve`` marks it as EC for dispatchers."""

    x: int
    y: int
    curve: ec.Curve = ec.P256

    @property
    def point(self):
        return (self.x, self.y)

    def marshal(self) -> bytes:
        return ec.marshal(self.curve, self.point)


@dataclass(frozen=True)
class ECPrivateKey:
    d: int
    public: ECPublicKey
    curve: ec.Curve = ec.P256


def generate(curve: ec.Curve = ec.P256, *, seed: int | None = None) -> ECPrivateKey:
    """A new key; with ``seed`` the scalar is drawn from
    ``random.Random(seed)`` and is reproducible — for benchmarks and
    smoke runs, never for real keys."""
    if seed is None:
        d = 1 + pysecrets.randbelow(curve.n - 1)
    else:
        import random

        d = 1 + random.Random(seed).randrange(curve.n - 1)
    pt = curve.scalar_base_mult(d)
    return ECPrivateKey(d=d, public=ECPublicKey(x=pt[0], y=pt[1], curve=curve), curve=curve)


def public_from_bytes(data: bytes, curve: ec.Curve = ec.P256) -> ECPublicKey:
    pt = ec.unmarshal(curve, data)
    if pt is None:
        from bftkv_tpu_torch.errors import ERR_MALFORMED_REQUEST

        raise ERR_MALFORMED_REQUEST
    return ECPublicKey(x=pt[0], y=pt[1], curve=curve)


# ---------------------------------------------------------------------------
# RFC 6979 deterministic nonce
# ---------------------------------------------------------------------------


def _bits2int(b: bytes, n: int) -> int:
    v = int.from_bytes(b, "big")
    excess = len(b) * 8 - n.bit_length()
    return v >> excess if excess > 0 else v


def _rfc6979_k(e: int, d: int, n: int, extra: bytes = b"") -> int:
    """Nonce per RFC 6979 §3.2 (SHA-256); ``extra`` is the §3.6
    additional input k' — used to HEDGE device-batched signing (see
    :func:`sign_batch`)."""
    qlen = (n.bit_length() + 7) // 8
    x = d.to_bytes(qlen, "big")
    h1 = (e % n).to_bytes(qlen, "big")
    K = b"\x00" * 32
    V = b"\x01" * 32
    K = hmac.new(K, V + b"\x00" + x + h1 + extra, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    K = hmac.new(K, V + b"\x01" + x + h1 + extra, hashlib.sha256).digest()
    V = hmac.new(K, V, hashlib.sha256).digest()
    while True:
        t = b""
        while len(t) < qlen:
            V = hmac.new(K, V, hashlib.sha256).digest()
            t += V
        k = _bits2int(t[:qlen], n)
        if 1 <= k < n:
            return k
        K = hmac.new(K, V + b"\x00", hashlib.sha256).digest()
        V = hmac.new(K, V, hashlib.sha256).digest()


def _msg_scalar(message: bytes, n: int) -> int:
    return _bits2int(hashlib.sha256(message).digest(), n)


# ---------------------------------------------------------------------------
# Sign / verify
# ---------------------------------------------------------------------------


def _finish_sign(e: int, d: int, k: int, R, n: int) -> bytes | None:
    r = R[0] % n
    if r == 0:
        return None
    s = (pow(k, -1, n) * (e + r * d)) % n
    if s == 0:
        return None
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


def sign(message: bytes, key: ECPrivateKey) -> bytes:
    """64-byte r‖s over SHA-256(message), deterministic nonce (host)."""
    n = key.curve.n
    e = _msg_scalar(message, n)
    k = _rfc6979_k(e, key.d, n)
    while True:
        R = key.curve.scalar_base_mult(k)
        sig = _finish_sign(e, key.d, k, R, n)
        if sig is not None:
            return sig
        k = (k + 1) % n or 1  # astronomically unlikely; stay total


def _threshold(name: str, default: int) -> int:
    return int(flags.raw(name, default))


def sign_batch(messages: list[bytes], key: ECPrivateKey, *, device=None) -> list[bytes]:
    """All nonce base mults in ONE launch on ``device``; per-item scalar
    arithmetic is host work.

    Device-batch fault hardening, as the reference's: the nonce is HEDGED
    with per-batch randomness (RFC 6979 §3.6 additional input), so a
    signature over a faulted R can never be paired with a same-k correct
    one; and one random item per batch is verified on the host — on a
    mismatch ``ec.sign_fault`` is counted and the batch is signed on the
    host, so a systematically faulting kernel cannot stay hidden.
    """
    from bftkv_tpu_torch.ops import ec as ec_ops

    if not messages:
        return []
    n = key.curve.n
    if len(messages) < _threshold("BFTKV_EC_SIGN_THRESHOLD", SIGN_HOST_CROSSOVER):
        return [sign(m, key) for m in messages]
    hedge = rng.generate_random(32)
    es = [_msg_scalar(m, n) for m in messages]
    ks = [_rfc6979_k(e, key.d, n, extra=hedge) for e in es]
    Rs = ec_ops.scalar_base_mult_hosts(ks, device=device)
    out = []
    for msg, e, k, R in zip(messages, es, ks, Rs):
        sig = _finish_sign(e, key.d, k, R, n)
        if sig is None:  # r/s ≡ 0 (~2^-256); re-sign THIS message
            sig = sign(msg, key)
        out.append(sig)
    spot = pysecrets.randbelow(len(out))
    if not verify_host(messages[spot], out[spot], key.public):
        metrics.incr("ec.sign_fault")
        return [sign(m, key) for m in messages]
    return out


def _split_sig(sig: bytes, n: int) -> tuple[int, int] | None:
    if len(sig) != SIG_BYTES:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (1 <= r < n and 1 <= s < n):
        return None
    return r, s


def verify_host(message: bytes, sig: bytes, key: ECPublicKey) -> bool:
    n = key.curve.n
    rs = _split_sig(sig, n)
    if rs is None or not key.curve.on_curve(key.point):
        return False
    r, s = rs
    e = _msg_scalar(message, n)
    w = pow(s, -1, n)
    R = key.curve.add(
        key.curve.scalar_base_mult(e * w % n),
        key.curve.scalar_mult(key.point, r * w % n),
    )
    return R is not None and R[0] % n == r


def verify_batch(items: list[tuple[bytes, bytes, ECPublicKey]], *, device=None) -> list[bool]:
    """Batched verify: the 2·T scalar mults (u1·G, u2·Q) ride one launch
    on ``device``; malformed signatures and keys fail closed per item.
    Small batches stay on the host (``VERIFY_HOST_CROSSOVER``)."""
    from bftkv_tpu_torch.ops import ec as ec_ops

    if not items:
        return []
    if len(items) < _threshold("BFTKV_EC_VERIFY_THRESHOLD", VERIFY_HOST_CROSSOVER):
        out = []
        for message, sig, key in items:
            try:
                out.append(verify_host(message, sig, key))
            except Exception:
                out.append(False)
        return out
    n = ec.P256.n
    g = (ec.P256.gx, ec.P256.gy)
    pts, scalars = [], []
    meta: list[tuple[int, int] | None] = []
    valid = 0
    for message, sig, key in items:
        rs = _split_sig(sig, n) if isinstance(sig, bytes) else None
        if (
            rs is None
            or key.curve.name != "P-256"
            or not key.curve.on_curve(key.point)
        ):
            meta.append(None)
            continue
        r, s = rs
        e = _msg_scalar(message, n)
        w = pow(s, -1, n)
        pts.extend([g, key.point])
        scalars.extend([e * w % n, r * w % n])
        meta.append((r, valid))
        valid += 1
    if not pts:
        return [False] * len(items)
    muls = ec_ops.scalar_mult_hosts(pts, scalars, device=device)
    out = []
    for m in meta:
        if m is None:
            out.append(False)
            continue
        r, j = m
        R = ec.P256.add(muls[2 * j], muls[2 * j + 1])
        out.append(R is not None and R[0] % n == r)
    return out
