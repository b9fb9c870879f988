"""Plain ECDSA over NIST P-256, in the host's integers.

- the curve y² = x³ − 3x + b over GF(p) (FIPS 186-4, D.1.2.3), points
  in Jacobian coordinates ``(X, Y, Z)`` for x = X/Z², y = Y/Z³ with Z = 0
  the point at infinity; affine points are ``(x, y)``;
- a signature is 64 bytes, ``r`` then ``s``, each 32 bytes big-endian,
  over SHA-256 of the message, the digest read as a big-endian integer
  (256 bits, n's width, so nothing is cut);
- a scalar multiple of a point is a sum of 4-bit windows from the point's
  comb, the 15 multiples j·16^i·Q of each of its 64 windows, built once a
  point; a verify sums u1·G and u2·Q into one accumulator;
- a signer's id is the first 8 bytes (big-endian) of
  SHA-256("p256" || 0x04 || x || y), the point in SEC1's uncompressed form.
"""

from __future__ import annotations

import functools
import hashlib
import hmac

__all__ = ["B", "G", "N", "P", "base_mult", "key_id_ec", "marshal", "on_curve", "sign", "verify"]

P = 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF
N = 0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551
B = 0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B
G = (0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
     0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5)

_INF = (1, 1, 0)


def on_curve(pt: tuple[int, int]) -> bool:
    x, y = pt
    return 0 <= x < P and 0 <= y < P and (y * y - x * x * x + 3 * x - B) % P == 0


def _double(pt: tuple[int, int, int]) -> tuple[int, int, int]:
    x1, y1, z1 = pt
    if z1 == 0 or y1 == 0:
        return _INF
    delta = z1 * z1 % P
    gamma = y1 * y1 % P
    beta = x1 * gamma % P
    alpha = 3 * (x1 - delta) * (x1 + delta) % P
    x3 = (alpha * alpha - 8 * beta) % P
    z3 = ((y1 + z1) ** 2 - gamma - delta) % P
    y3 = (alpha * (4 * beta - x3) - 8 * gamma * gamma) % P
    return x3, y3, z3


def _add_affine(pt: tuple[int, int, int], q: tuple[int, int]) -> tuple[int, int, int]:
    """``pt + q`` for a Jacobian ``pt`` and an affine ``q``."""
    x1, y1, z1 = pt
    if z1 == 0:
        return q[0], q[1], 1
    z1z1 = z1 * z1 % P
    u2 = q[0] * z1z1 % P
    s2 = q[1] * z1 * z1z1 % P
    h = (u2 - x1) % P
    r = 2 * (s2 - y1) % P
    if h == 0:
        return _double(pt) if r == 0 else _INF
    hh = h * h % P
    i = 4 * hh % P
    j = h * i % P
    v = x1 * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * y1 * j) % P
    z3 = ((z1 + h) ** 2 - z1z1 - hh) % P
    return x3, y3, z3


def _affine(pt: tuple[int, int, int]) -> tuple[int, int] | None:
    x, y, z = pt
    if z == 0:
        return None
    zi = pow(z, -1, P)
    zi2 = zi * zi % P
    return x * zi2 % P, y * zi2 * zi % P


@functools.lru_cache(maxsize=256)
def _comb(q: tuple[int, int]) -> tuple[tuple, ...]:
    """``rows[i][j] = j·16^i·q`` (affine) for i < 64, 1 <= j < 16."""
    rows = []
    base = q
    for _ in range(64):
        row, acc = [None, base], (base[0], base[1], 1)
        for _j in range(2, 16):
            acc = _add_affine(acc, base)
            row.append(_affine(acc))
        rows.append(tuple(row))
        base = _affine(_add_affine(acc, base))
    return tuple(rows)


def _sum_into(acc: tuple[int, int, int], u: int, q: tuple[int, int]) -> tuple[int, int, int]:
    """``acc + u·q``, a window of ``u`` at a time."""
    rows = _comb(q)
    for i in range(64):
        nib = u >> 4 * i & 15
        if nib:
            acc = _add_affine(acc, rows[i][nib])
    return acc


def base_mult(d: int) -> tuple[int, int] | None:
    """``d·G``, affine (``None`` for the point at infinity)."""
    return _affine(_sum_into(_INF, d % N, G))


def _digest(message: bytes) -> int:
    return int.from_bytes(hashlib.sha256(message).digest(), "big")


def verify(message: bytes, sig: bytes, q: tuple[int, int]) -> bool:
    if len(sig) != 64 or not on_curve(q):
        return False
    r, s = int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:], "big")
    if not (1 <= r < N and 1 <= s < N):
        return False
    w = pow(s, -1, N)
    pt = _affine(_sum_into(_sum_into(_INF, _digest(message) * w % N, G), r * w % N, q))
    return pt is not None and pt[0] % N == r


def sign(message: bytes, d: int) -> bytes:
    """A valid signature by ``d``, with a nonce drawn from ``d`` and the
    message by HMAC-SHA256 (any nonce unique to the message serves)."""
    e = _digest(message)
    ctr = 0
    while True:
        mac = hmac.new(d.to_bytes(32, "big"), ctr.to_bytes(4, "big") + message, hashlib.sha256)
        k = int.from_bytes(mac.digest(), "big") % (N - 1) + 1
        r = base_mult(k)[0] % N
        s = pow(k, -1, N) * (e + r * d) % N
        if r and s:
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")
        ctr += 1


def marshal(pt: tuple[int, int]) -> bytes:
    """SEC1 uncompressed: 0x04 || x || y."""
    return b"\x04" + pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def key_id_ec(alg: str, point: bytes) -> int:
    return int.from_bytes(hashlib.sha256(alg.encode() + point).digest()[:8], "big")
