"""Threshold signing: k-of-n RSA / DSA / ECDSA for the decentralized CA
(counterpart of ``bftkv_tpu/crypto/threshold/__init__.py``).

Capability parity with the reference's threshold dispatcher
(reference: crypto/threshold/threhold.go:25-88): route
Distribute/Sign/NewProcess by key type or the 1-byte algorithm tag
prefixed onto stored shares.

The schemes:

- RSA (``threshold.rsa``): dealer splits the private exponent additively
  along a combinatorial tree so any k-of-n subset's fragments recombine;
- DSA/ECDSA (``threshold.dsa_core`` + group plugins): dealerless 3-phase
  signing with joint Shamir shares, per-recipient share encryption
  through the message-security layer.
"""

from __future__ import annotations

import enum
from typing import Protocol

from bftkv_tpu_torch.errors import ERR_UNSUPPORTED_ALGORITHM

__all__ = [
    "ThresholdAlgo",
    "Threshold",
    "ThresholdProcess",
    "ThresholdInstance",
    "serialize_params",
    "parse_params",
]


class ThresholdAlgo(enum.IntEnum):
    """1-byte algorithm tag (reference: crypto/crypto.go:83-90)."""

    UNKNOWN = 0
    RSA = 1
    DSA = 2
    ECDSA = 3


class ThresholdProcess(Protocol):
    """Client-side accumulation of partial signatures
    (reference: crypto/crypto.go:98-101)."""

    def make_request(self) -> tuple[list | None, bytes | None]: ...

    def process_response(self, data: bytes, peer) -> bytes | None: ...


class Threshold(Protocol):
    """(reference: crypto/crypto.go:92-96)."""

    def distribute(
        self, key, nodes: list, k: int
    ) -> tuple[list[bytes], ThresholdAlgo]: ...

    def sign(
        self, sec: bytes, req: bytes | None, peer_id: int, self_id: int
    ) -> bytes | None: ...

    def new_process(
        self, tbs: bytes, algo: ThresholdAlgo, hash_name: str
    ) -> ThresholdProcess: ...


def serialize_params(algo: ThresholdAlgo, data: bytes) -> bytes:
    """Prefix the 1-byte algo tag (reference: threhold.go:84-88)."""
    return bytes([int(algo)]) + data


def parse_params(aux: bytes) -> tuple[ThresholdAlgo, bytes]:
    if not aux:
        raise ERR_UNSUPPORTED_ALGORITHM
    try:
        algo = ThresholdAlgo(aux[0])
    except ValueError:
        raise ERR_UNSUPPORTED_ALGORITHM from None
    return algo, aux[1:]


class ThresholdInstance:
    """Routes by key type (distribute) or algo tag (sign/new_process)
    (reference: threhold.go:19-81).  ``device`` places the three schemes'
    batched modexps and scalar mults (``None``: ``cuda:0``)."""

    def __init__(self, crypt, *, device=None):
        from bftkv_tpu_torch.crypto.threshold import dsa, ecdsa
        from bftkv_tpu_torch.crypto.threshold import rsa as trsa

        self._impls = {
            ThresholdAlgo.RSA: trsa.RSAThreshold(crypt, device=device),
            ThresholdAlgo.DSA: dsa.new(crypt, device=device),
            ThresholdAlgo.ECDSA: ecdsa.new(crypt, device=device),
        }

    def _by_key(self, key):
        from bftkv_tpu_torch.crypto import rsa as rsakeys
        from bftkv_tpu_torch.crypto.threshold import dsa, ecdsa

        if isinstance(key, rsakeys.PrivateKey):
            return self._impls[ThresholdAlgo.RSA]
        if isinstance(key, dsa.DSAPrivateKey):
            return self._impls[ThresholdAlgo.DSA]
        if isinstance(key, ecdsa.ECDSAPrivateKey):
            return self._impls[ThresholdAlgo.ECDSA]
        raise ERR_UNSUPPORTED_ALGORITHM

    def distribute(self, key, nodes: list, k: int):
        return self._by_key(key).distribute(key, nodes, k)

    def sign(
        self, aux: bytes, req: bytes | None, peer_id: int, self_id: int
    ) -> bytes | None:
        algo, params = parse_params(aux)
        impl = self._impls.get(algo)
        if impl is None:
            raise ERR_UNSUPPORTED_ALGORITHM
        return impl.sign(params, req, peer_id, self_id)

    def new_process(self, tbs: bytes, algo: ThresholdAlgo, hash_name: str):
        impl = self._impls.get(algo)
        if impl is None:
            raise ERR_UNSUPPORTED_ALGORITHM
        return impl.new_process(tbs, algo, hash_name)
