"""Host-side codec between Python ints and fixed-limb arrays.

A copy of ``bftkv_tpu/ops/limb.py`` (host numpy; the port imports
nothing of the reference).  A non-negative big integer is a
little-endian vector of ``LIMB_BITS``-bit digits stored in ``uint32``
lanes, shape ``(..., nlimbs)``.
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def nlimbs_for_bits(bits: int) -> int:
    return -(-bits // LIMB_BITS)


def int_to_limbs(x: int, nlimbs: int) -> np.ndarray:
    """Encode a Python int into a little-endian limb vector."""
    if x < 0:
        raise ValueError("int_to_limbs: negative")
    if x >> (LIMB_BITS * nlimbs):
        raise ValueError(f"int_to_limbs: {x.bit_length()} bits > {nlimbs} limbs")
    raw = x.to_bytes(nlimbs * 2, "little")
    return np.frombuffer(raw, dtype="<u2").astype(np.uint32)


def limbs_to_int(a: np.ndarray) -> int:
    """Decode a little-endian limb vector (one number, 1-D)."""
    a = np.asarray(a, dtype=np.uint64)
    x = 0
    for i in range(a.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(a[..., i])
    return x


def ints_to_limbs(xs: list[int] | tuple[int, ...], nlimbs: int) -> np.ndarray:
    """Encode a batch of ints, shape ``(len(xs), nlimbs)``."""
    return np.stack([int_to_limbs(x, nlimbs) for x in xs])


def limbs_to_ints(a: np.ndarray) -> list[int]:
    """Decode a batch, shape ``(batch, nlimbs)`` → list of ints."""
    return [limbs_to_int(row) for row in np.asarray(a)]
