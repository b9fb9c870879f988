"""Short-Weierstrass elliptic-curve arithmetic over prime fields: a copy of
``bftkv_tpu/crypto/ec.py`` (imports rewritten to the port's ``errors``).

Host-side oracle for the EC capability the reference gets from Go's
``crypto/elliptic`` (used by threshold ECDSA —
reference: crypto/threshold/ecdsa/ecdsa.go:31-59): point add, double,
scalar mult, and SEC1 uncompressed marshal/unmarshal. The batched device
versions (``bftkv_tpu_torch.ops.ec`` and ``ops.ec_rns``) mirror this
interface over ``(batch,)`` scalars; this module is their correctness
oracle and the small-batch path.

Curves are value objects (p, a, b, gx, gy, n, bits); P-256 is provided.
Points are affine ``(x, y)`` tuples, with ``None`` as the identity.
"""

from __future__ import annotations

from dataclasses import dataclass

from bftkv_tpu_torch.errors import ERR_MALFORMED_REQUEST

__all__ = ["Curve", "P256", "marshal", "unmarshal"]

Point = "tuple[int, int] | None"


@dataclass(frozen=True)
class Curve:
    name: str
    p: int  # field prime
    a: int  # y² = x³ + ax + b
    b: int
    gx: int
    gy: int
    n: int  # group order
    bits: int

    # -- group law (Jacobian internally for fewer inversions) -------------
    def add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        j = _jac_add(self, _to_jac(p1), _to_jac(p2))
        return _from_jac(self, j)

    def double(self, pt):
        if pt is None:
            return None
        return _from_jac(self, _jac_double(self, _to_jac(pt)))

    def scalar_mult(self, pt, k: int):
        """k·pt by left-to-right double-and-add (host path; the device
        kernel uses a fixed-window uniform schedule)."""
        if pt is None or k % self.n == 0:
            return None
        k %= self.n
        acc = None
        for bit in bin(k)[2:]:
            acc = (
                None if acc is None
                else _from_jac(self, _jac_double(self, _to_jac(acc)))
            )
            if bit == "1":
                acc = self.add(acc, pt)
        return acc

    def scalar_base_mult(self, k: int):
        return self.scalar_mult((self.gx, self.gy), k)

    def on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        if not (0 <= x < self.p and 0 <= y < self.p):
            return False
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0


def _to_jac(pt):
    return (pt[0], pt[1], 1)


def _from_jac(curve: Curve, j):
    x, y, z = j
    if z == 0:
        return None
    p = curve.p
    zinv = pow(z, -1, p)
    zinv2 = (zinv * zinv) % p
    return (x * zinv2 % p, y * zinv2 * zinv % p)


def _jac_double(curve: Curve, j):
    x, y, z = j
    p = curve.p
    if z == 0 or y == 0:
        return (1, 1, 0)
    s = 4 * x * y % p * y % p
    m = (3 * x * x + curve.a * pow(z, 4, p)) % p
    x2 = (m * m - 2 * s) % p
    y2 = (m * (s - x2) - 8 * pow(y, 4, p)) % p
    z2 = 2 * y * z % p
    return (x2, y2, z2)


def _jac_add(curve: Curve, j1, j2):
    x1, y1, z1 = j1
    x2, y2, z2 = j2
    p = curve.p
    if z1 == 0:
        return j2
    if z2 == 0:
        return j1
    z1s, z2s = z1 * z1 % p, z2 * z2 % p
    u1, u2 = x1 * z2s % p, x2 * z1s % p
    s1, s2 = y1 * z2s * z2 % p, y2 * z1s * z1 % p
    if u1 == u2:
        if s1 != s2:
            return (1, 1, 0)
        return _jac_double(curve, j1)
    h = (u2 - u1) % p
    r = (s2 - s1) % p
    h2 = h * h % p
    h3 = h2 * h % p
    x3 = (r * r - h3 - 2 * u1 * h2) % p
    y3 = (r * (u1 * h2 - x3) - s1 * h3) % p
    z3 = h * z1 % p * z2 % p
    return (x3, y3, z3)


P256 = Curve(
    name="P-256",
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    a=-3 % 0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    bits=256,
)


def marshal(curve: Curve, pt) -> bytes:
    """SEC1 uncompressed encoding (0x04 ‖ X ‖ Y); identity → b"\\x00"."""
    if pt is None:
        return b"\x00"
    size = (curve.bits + 7) // 8
    return b"\x04" + pt[0].to_bytes(size, "big") + pt[1].to_bytes(size, "big")


def unmarshal(curve: Curve, data: bytes):
    if data == b"\x00":
        return None
    size = (curve.bits + 7) // 8
    if len(data) != 1 + 2 * size or data[0] != 4:
        raise ERR_MALFORMED_REQUEST
    x = int.from_bytes(data[1 : 1 + size], "big")
    y = int.from_bytes(data[1 + size :], "big")
    pt = (x, y)
    if not curve.on_curve(pt):
        raise ERR_MALFORMED_REQUEST
    return pt
