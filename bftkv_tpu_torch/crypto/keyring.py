"""Keyring: the certificate store backing identity and trust (counterpart of
``bftkv_tpu/crypto/keyring.py``).

Capability parity with the reference keyring
(reference: crypto/pgp/crypto_pgp.go:115-223 — pub/sec/self rings,
register, remove, persistence). Certificates are stored by 64-bit id;
registering a cert that is already present merges its signature set
(new trust edges accumulate, reference: crypto_pgp.go:186-204).
"""

from __future__ import annotations

import io
import os

from bftkv_tpu_torch.crypto import cert as certmod
from bftkv_tpu_torch.crypto import rsa
from bftkv_tpu_torch.errors import ERR_CERTIFICATE_NOT_FOUND, ERR_KEY_NOT_FOUND
from bftkv_tpu_torch.packet import read_bigint, write_bigint

_SECMAGIC = b"BSK1"
_SECMAGIC_EC = b"BSK2"


def serialize_private_key(key) -> bytes:
    """RSA ("BSK1": n,e,d,p,q bigints) or ECDSA P-256 ("BSK2": d)."""
    buf = io.BytesIO()
    if certmod.is_ec(key):
        buf.write(_SECMAGIC_EC)
        write_bigint(buf, key.d)
        return buf.getvalue()
    buf.write(_SECMAGIC)
    for x in (key.n, key.e, key.d, key.p, key.q):
        write_bigint(buf, x)
    return buf.getvalue()


def read_private_key(r: io.BytesIO):
    """Read one self-delimiting key record from a stream; None at EOF."""
    magic = r.read(4)
    if len(magic) == 0:
        return None
    if magic == _SECMAGIC_EC:
        from bftkv_tpu_torch.crypto import ec, ecdsa

        d = read_bigint(r)
        pt = ec.P256.scalar_base_mult(d)
        if pt is None:
            raise ERR_KEY_NOT_FOUND
        return ecdsa.ECPrivateKey(
            d=d, public=ecdsa.ECPublicKey(x=pt[0], y=pt[1])
        )
    if magic != _SECMAGIC:
        raise ERR_KEY_NOT_FOUND
    n, e, d, p, q = (read_bigint(r) for _ in range(5))
    return rsa.PrivateKey(n=n, e=e, d=d, p=p, q=q)


def parse_private_key(data: bytes):
    key = read_private_key(io.BytesIO(data))
    if key is None:
        raise ERR_KEY_NOT_FOUND
    return key


class Keyring:
    def __init__(self):
        self._certs: dict[int, certmod.Certificate] = {}
        self._keys: dict[int, rsa.PrivateKey] = {}

    # -- registration -----------------------------------------------------
    def register(
        self,
        certs: list[certmod.Certificate],
        priv=None,
    ) -> None:
        for c in certs:
            existing = self._certs.get(c.id)
            if existing is None:
                self._certs[c.id] = c
            elif existing is not c:
                existing.merge(c)
        if priv is not None:
            self._keys[certmod.private_key_id(priv)] = priv

    def remove(self, ids: list[int]) -> None:
        for i in ids:
            self._certs.pop(i, None)
            self._keys.pop(i, None)

    # -- lookup -----------------------------------------------------------
    def lookup(self, node_id: int) -> certmod.Certificate:
        c = self._certs.get(node_id)
        if c is None:
            raise ERR_CERTIFICATE_NOT_FOUND
        return c

    def get(self, node_id: int) -> certmod.Certificate | None:
        return self._certs.get(node_id)

    def private_key(self, node_id: int):
        k = self._keys.get(node_id)
        if k is None:
            raise ERR_KEY_NOT_FOUND
        return k

    def certs(self) -> list[certmod.Certificate]:
        return list(self._certs.values())

    # -- persistence ("rings", reference: crypto_pgp.go:206-223) ----------
    def save_pubring(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(certmod.serialize_many(self.certs()))
        os.replace(tmp, path)

    def load_pubring(self, path: str) -> list[certmod.Certificate]:
        with open(path, "rb") as f:
            certs = certmod.parse(f.read())
        self.register(certs)
        return certs

    def save_secring(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            for key in self._keys.values():
                f.write(serialize_private_key(key))
        os.replace(tmp, path)

    def load_secring(self, path: str) -> None:
        with open(path, "rb") as f:
            r = io.BytesIO(f.read())
        while True:
            key = read_private_key(r)
            if key is None:
                return
            self._keys[certmod.private_key_id(key)] = key
