"""Symmetric data encryption for password-protected values (counterpart of
``bftkv_tpu/crypto/dataenc.py``).

Capability parity with the reference's ``DataEncryption`` interface
(reference: crypto/crypto.go:77-81, impl crypto_pgp.go:525-554 — PGP
symmetric packets keyed by the TPA-derived secret). Here: AES-256-GCM
with an HKDF-expanded key; the key material comes from the TPA cipher
key (``bftkv_tpu_torch.crypto.auth``) or any caller-supplied secret.
"""

from __future__ import annotations

import hashlib
import os

from bftkv_tpu_torch.crypto.aead import AESGCM
from bftkv_tpu_torch.errors import ERR_DECRYPTION_FAILURE

_INFO = b"bftkv_tpu data encryption v1"


def _derive(key: bytes) -> bytes:
    # Single-block HKDF-expand (SHA-256) of the caller's key material.
    prk = hashlib.sha256(_INFO + key).digest()
    return prk


def encrypt(value: bytes, key: bytes) -> bytes:
    nonce = os.urandom(12)
    return nonce + AESGCM(_derive(key)).encrypt(nonce, value, None)


def decrypt(blob: bytes, key: bytes) -> bytes:
    if len(blob) < 13:
        raise ERR_DECRYPTION_FAILURE
    try:
        return AESGCM(_derive(key)).decrypt(blob[:12], blob[12:], None)
    except Exception:
        raise ERR_DECRYPTION_FAILURE from None
