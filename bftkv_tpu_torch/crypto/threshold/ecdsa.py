"""Threshold ECDSA: the elliptic-curve instantiation of the dealerless core
(counterpart of ``bftkv_tpu/crypto/threshold/ecdsa.py``).

Capability parity with the reference (crypto/threshold/ecdsa/ecdsa.go):
partial R is ``a_i·G`` marshalled; the combine is
``R = (Σ v_i λ_i)^{-1} · Σ λ_i·R_i`` with ``r = R.x mod n``
(ecdsa.go:31-59); curve parameters travel inside the share
(ecdsa.go:65-98).
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.crypto import ec, sss
from bftkv_tpu_torch.crypto.threshold import ThresholdAlgo
from bftkv_tpu_torch.crypto.threshold.dsa_core import DsaContext, PartialR
from bftkv_tpu_torch.packet import read_bigint, write_bigint

__all__ = ["ECDSAPrivateKey", "ECDSAGroup", "new", "generate"]


@dataclass(frozen=True)
class ECDSAPrivateKey:
    curve: ec.Curve
    d: int  # private scalar


def generate(curve: ec.Curve = ec.P256, *, seed: int | None = None) -> ECDSAPrivateKey:
    """A new key; with ``seed`` the scalar is drawn from
    ``random.Random(seed)`` — for tests and smoke runs, never for real
    keys."""
    if seed is not None:
        import random

        return ECDSAPrivateKey(curve, random.Random(seed).randrange(1, curve.n))
    import secrets as pysecrets

    return ECDSAPrivateKey(curve, 1 + pysecrets.randbelow(curve.n - 1))


class _ECDSAGroupOps:
    def __init__(self, curve: ec.Curve, device=None):
        self.curve = curve
        self.device = device

    def _device_capable(self) -> bool:
        return self.curve.name == "P-256" or (
            self.curve.p == ec.P256.p and self.curve.n == ec.P256.n
        )

    def calculate_partial_r(self, ai: int) -> bytes:
        """a_i·G — one batched scalar mult on ``device`` for P-256 (kernel
        K5 on the card; reference: ecdsa.go:31-41)."""
        if self._device_capable():
            from bftkv_tpu_torch.ops import ec as ec_ops

            # Use *this* curve's generator: parse_params can produce a
            # P-256-field curve with a different base point.
            pt = ec_ops.scalar_mult_hosts(
                [(self.curve.gx, self.curve.gy)], [ai], device=self.device
            )[0]
        else:
            pt = self.curve.scalar_base_mult(ai)
        return ec.marshal(self.curve, pt)

    def calculate_r(self, rs: list[PartialR]) -> int:
        """R = (Σ v_i λ_i)^{-1} · Σ λ_i·R_i; the λ_i·R_i scalar mults and
        the final inversion mult ride device launches for P-256
        (reference: ecdsa.go:43-59)."""
        xs = [pr.x for pr in rs]
        n = self.curve.n
        pts = [ec.unmarshal(self.curve, pr.ri) for pr in rs]
        lams = [sss.lagrange(pr.x, xs, n) for pr in rs]
        v = sum(pr.vi * lam for pr, lam in zip(rs, lams)) % n
        v_inv = pow(v, -1, n)
        if self._device_capable():
            from bftkv_tpu_torch.ops import ec as ec_ops

            # v_inv·Σλ_i·R_i == Σ(v_inv·λ_i)·R_i — fold the inversion
            # into the coefficients so everything is one launch.
            final = ec_ops.linear_combine_hosts(
                pts, [(v_inv * lam) % n for lam in lams], device=self.device
            )
        else:
            acc = None
            for pt, lam in zip(pts, lams):
                acc = self.curve.add(acc, self.curve.scalar_mult(pt, lam))
            final = self.curve.scalar_mult(acc, v_inv)
        return final[0] % n

    def subgroup_order(self) -> int:
        return self.curve.n

    def serialize(self, buf: io.BytesIO) -> None:
        """p, n, b, gx, gy, u32 bits — a = -3 implied, like Go's
        CurveParams (reference: ecdsa.go:65-86)."""
        write_bigint(buf, self.curve.p)
        write_bigint(buf, self.curve.n)
        write_bigint(buf, self.curve.b)
        write_bigint(buf, self.curve.gx)
        write_bigint(buf, self.curve.gy)
        buf.write(struct.pack(">I", self.curve.bits))

    def os2i(self, os: bytes) -> int:
        """Leftmost order-size bits of the digest (FIPS 186 truncation —
        reference: ecdsa.go:88-98)."""
        order_size = (self.curve.n.bit_length() + 7) // 8
        os = os[:order_size]
        ret = int.from_bytes(os, "big")
        excess = len(os) * 8 - self.curve.n.bit_length()
        if excess > 0:
            ret >>= excess
        return ret


class ECDSAGroup:
    """The elliptic-curve group plugin; P-256 scalar mults run on
    ``device`` (``None``: ``cuda:0``)."""

    def __init__(self, device=None):
        self.device = devmod.resolve(device)

    def parse_key(self, key: ECDSAPrivateKey):
        return _ECDSAGroupOps(key.curve, self.device), key.d

    def parse_params(self, r: io.BytesIO) -> _ECDSAGroupOps:
        p = read_bigint(r)
        n = read_bigint(r)
        b = read_bigint(r)
        gx = read_bigint(r)
        gy = read_bigint(r)
        (bits,) = struct.unpack(">I", r.read(4))
        curve = ec.Curve(
            name=f"custom-{bits}", p=p, a=(-3) % p, b=b, gx=gx, gy=gy, n=n,
            bits=bits,
        )
        return _ECDSAGroupOps(curve, self.device)


def new(crypt, *, device=None) -> DsaContext:
    return DsaContext(crypt, ECDSAGroup(device), ThresholdAlgo.ECDSA)
