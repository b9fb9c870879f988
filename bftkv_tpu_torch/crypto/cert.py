"""Key identity and the algorithm rule of the certificate layer (the part
of ``bftkv_tpu/crypto/cert.py`` the crypto plane and the sidecar's
tenant client use).

A node id is the first 8 bytes (big-endian) of SHA-256 over the public
key, the analog of a PGP 64-bit key id; :func:`is_ec` is the one rule
every layer shares to tell EC P-256 keys from RSA keys.  The certificate
format itself comes with the protocol layer.
"""

from __future__ import annotations

import hashlib
import struct

__all__ = ["ALG_P256", "ALG_RSA", "is_ec", "key_id", "key_id_ec", "private_key_id"]

ALG_RSA = "rsa"
ALG_P256 = "p256"


def key_id(n: int, e: int) -> int:
    h = hashlib.sha256()
    h.update(n.to_bytes((n.bit_length() + 7) // 8, "big"))
    h.update(struct.pack(">I", e))
    return struct.unpack(">Q", h.digest()[:8])[0]


def key_id_ec(alg: str, point: bytes) -> int:
    h = hashlib.sha256()
    h.update(alg.encode())
    h.update(point)
    return struct.unpack(">Q", h.digest()[:8])[0]


def is_ec(key) -> bool:
    """True for EC key objects (public or private)."""
    return hasattr(key, "curve")


def private_key_id(key) -> int:
    """Node id for either private-key type."""
    if is_ec(key):
        return key_id_ec(ALG_P256, key.public.marshal())
    return key_id(key.n, key.e)
