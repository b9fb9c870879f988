"""AEAD seam (a copy of ``bftkv_tpu/crypto/aead.py``): AES-256-GCM when
the host ``cryptography`` library is present, a dependency-free stdlib
AEAD otherwise.  The port's sidecar seals REGISTER payloads with it
(``cmd/verify_sidecar.py::wrap_keys``).

It presents one interface whether or not ``cryptography`` is installed,
so the port imports and runs on hosts without the library.

The fallback is encrypt-then-MAC over C-accelerated stdlib primitives:
a SHAKE-256 keystream over the key and nonce with an HMAC-SHA256 tag over
``len(aad) | len(ct) | aad | nonce | ct``, truncated to GCM's 16 bytes
so blob sizes match either way.  It presents the exact ``AESGCM``
interface (``encrypt(nonce, data, aad)`` / ``decrypt(nonce, data, aad)``
raising on tag mismatch).

Interop note: the fallback is *not* wire-compatible with AES-GCM — all
nodes of one cluster must run the same stack (both with or both without
``cryptography``); a sidecar and its tenants share one host, so they
always do.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac
import struct

__all__ = ["AESGCM", "HAVE_HOST_AEAD"]

try:  # pragma: no cover - exercised only where the library exists
    from cryptography.hazmat.primitives.ciphers.aead import (
        AESGCM as _HostAESGCM,
    )

    HAVE_HOST_AEAD = True
except Exception as _e:  # ModuleNotFoundError, or a broken install
    _HostAESGCM = None
    HAVE_HOST_AEAD = False
    # Loud, once: the fallback is not wire-compatible with AES-GCM, so
    # a node silently downgrading (e.g. a *broken* cryptography install
    # rather than an absent one) would fail every envelope against
    # GCM-speaking peers with nothing in the logs naming the cause.
    import logging

    logging.getLogger("bftkv_tpu_torch.crypto.aead").warning(
        "host cryptography library unavailable (%s: %s); using the "
        "stdlib fallback AEAD — all cluster nodes must match",
        type(_e).__name__,
        _e,
    )


def _xor(a: bytes, b: bytes) -> bytes:
    # int XOR runs in C; a Python byte loop would dominate large frames.
    return (
        int.from_bytes(a, "big") ^ int.from_bytes(b, "big")
    ).to_bytes(len(a), "big")


class _FallbackAEAD:
    """Drop-in ``AESGCM`` built from hashlib/hmac (see module doc)."""

    _TAG = 16  # truncated HMAC-SHA256, same length as the GCM tag

    __slots__ = ("_enc", "_mac")

    def __init__(self, key: bytes):
        if not isinstance(key, (bytes, bytearray)) or len(key) not in (
            16,
            24,
            32,
        ):
            raise ValueError("AEAD key must be 16/24/32 bytes")
        self._enc = hashlib.sha256(b"bftkv aead enc\x00" + bytes(key)).digest()
        self._mac = hashlib.sha256(b"bftkv aead mac\x00" + bytes(key)).digest()

    def _keystream(self, nonce: bytes, n: int) -> bytes:
        # SHAKE-256 as the keystream XOF: ONE C call for the whole
        # stream.  The old per-32-byte SHA-256 counter loop cost ~1 C
        # call per 32 bytes — measured at roughly a quarter of all
        # write-path CPU at 1 KB values (~6x slower than the XOF).
        # Construction change is fallback-internal; the all-nodes-same-
        # stack deployment rule (module doc) is unchanged.
        return hashlib.shake_256(self._enc + nonce).digest(n)

    def _tag(self, nonce: bytes, ct: bytes, aad: bytes | None) -> bytes:
        aad = aad or b""
        m = _hmac.new(self._mac, digestmod=hashlib.sha256)
        m.update(struct.pack(">QQ", len(aad), len(ct)))
        m.update(aad)
        m.update(nonce)
        m.update(ct)
        return m.digest()[: self._TAG]

    def encrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        data = bytes(data)
        ct = _xor(data, self._keystream(nonce, len(data))) if data else b""
        return ct + self._tag(nonce, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes, aad: bytes | None) -> bytes:
        data = bytes(data)
        if len(data) < self._TAG:
            raise ValueError("aead: ciphertext shorter than tag")
        ct, tag = data[: -self._TAG], data[-self._TAG :]
        if not _hmac.compare_digest(tag, self._tag(nonce, ct, aad)):
            raise ValueError("aead: tag mismatch")
        return _xor(ct, self._keystream(nonce, len(ct))) if ct else b""


AESGCM = _HostAESGCM if HAVE_HOST_AEAD else _FallbackAEAD
