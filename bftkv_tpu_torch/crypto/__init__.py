"""The crypto capability seams of the port (counterpart of
``bftkv_tpu/crypto/__init__.py``).

Mirrors the reference's interface bundle (crypto/crypto.go:35-111):
keyring, certificate, signature, message security, collective signature,
data encryption, RNG, plus the threshold-crypto interfaces.  The batched
verify of collective signatures runs on the card (kernel K1) unless the
bundle is built for another ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from bftkv_tpu_torch.crypto.keyring import Keyring
from bftkv_tpu_torch.crypto.message import MessageSecurity
from bftkv_tpu_torch.crypto.signature import CollectiveSignature, Signer

__all__ = [
    "Crypto",
    "new_crypto",
    "Keyring",
    "MessageSecurity",
    "CollectiveSignature",
    "Signer",
]


@dataclass
class Crypto:
    """The crypto bundle injected everywhere — transport security,
    protocol signing, threshold (reference: crypto/crypto.go:103-111,
    factory crypto_pgp.go:583-593)."""

    keyring: Keyring
    signer: Signer | None = None
    message: MessageSecurity | None = None
    collective: CollectiveSignature = field(default_factory=CollectiveSignature)


def new_crypto(key=None, certificate=None, *, device=None) -> Crypto:
    """Build a bundle for one identity; ``key``/``certificate`` may be
    omitted for verify-only consumers.  ``device`` places the collective
    signature's batched verify (``None``: ``cuda:0``; ``"cpu"``: the plain
    versions)."""
    ring = Keyring()
    signer = None
    message = None
    if key is not None and certificate is not None:
        ring.register([certificate], priv=key)
        signer = Signer(key, certificate)
        message = MessageSecurity(key, certificate)
    return Crypto(
        keyring=ring,
        signer=signer,
        message=message,
        collective=CollectiveSignature(device=device),
    )
