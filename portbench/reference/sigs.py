"""The identity-key algorithms the reference knows, picked by a key's tag.

A public key is ``("rsa", (n, e))`` or ``("p256", (x, y))``; a private
key ``("rsa", (n, e, d, p, q))`` or ``("p256", (d, x, y))``.  RSA is
PKCS#1 v1.5 over SHA-256 (:mod:`portbench.reference.wire`), P-256 is
ECDSA over SHA-256 (:mod:`portbench.reference.p256`).
"""

from __future__ import annotations

from portbench.reference import p256, wire

__all__ = ["ALGORITHMS", "P256", "RSA", "public_of", "sign", "signer_id", "verify"]

RSA, P256 = "rsa", "p256"
ALGORITHMS = (RSA, P256)


def _alg(key: tuple) -> str:
    if key[0] not in ALGORITHMS:
        raise ValueError(f"key algorithm {key[0]!r}: the reference knows {ALGORITHMS}")
    return key[0]


def signer_id(public: tuple) -> int:
    """The id a signature entry names its signer by."""
    a, b = public[1]
    if _alg(public) == RSA:
        return wire.key_id(a, b)
    return p256.key_id_ec(P256, p256.marshal((a, b)))


def verify(public: tuple, message: bytes, sig: bytes) -> bool:
    a, b = public[1]
    if _alg(public) == RSA:
        return wire.rsa_verify(message, sig, a, b)
    return p256.verify(message, sig, (a, b))


def sign(private: tuple, message: bytes) -> bytes:
    if _alg(private) == RSA:
        n, _e, d, p, q = private[1]
        return wire.rsa_sign(message, n, d, p, q)
    return p256.sign(message, private[1][0])


def public_of(private: tuple) -> tuple:
    alg = _alg(private)
    return (alg, private[1][:2]) if alg == RSA else (alg, private[1][1:])
