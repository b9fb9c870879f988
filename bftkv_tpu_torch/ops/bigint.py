"""Host-side Montgomery precompute (counterpart of ``bftkv_tpu/ops/bigint.py``).

Only :class:`MontgomeryDomain` is ported in this slice: the RSA domains
use it as their key-eligibility check (an even modulus, or one wider
than the limb budget, is refused with ``ValueError``).  The batched limb
kernels (``mont_mul``, ``mont_exp``, ``carry_resolve``) arrive with the
limb-backend slice.
"""

from __future__ import annotations

from bftkv_tpu_torch.ops import limb as limb_codec
from bftkv_tpu_torch.ops.limb import LIMB_BITS

__all__ = ["MontgomeryDomain"]


class MontgomeryDomain:
    """Host-side precomputation for one odd modulus.

    Holds ``n``, ``n' = -n⁻¹ mod R`` and ``R² mod n`` as limb arrays.
    """

    def __init__(self, n: int, nlimbs: int | None = None):
        if n % 2 == 0:
            raise ValueError("Montgomery modulus must be odd")
        if nlimbs is None:
            nlimbs = limb_codec.nlimbs_for_bits(n.bit_length())
        self.n_int = n
        self.nlimbs = nlimbs
        r = 1 << (LIMB_BITS * nlimbs)
        if n >= r:
            raise ValueError("modulus does not fit limb count")
        self.r_int = r
        n_prime = (-pow(n, -1, r)) % r
        r2 = (r * r) % n
        self.n = limb_codec.int_to_limbs(n, nlimbs)
        self.n_prime = limb_codec.int_to_limbs(n_prime, nlimbs)
        self.r2 = limb_codec.int_to_limbs(r2, nlimbs)
        self.one_mont = limb_codec.int_to_limbs(r % n, nlimbs)

    def encode(self, xs: list[int]):
        """ints → Montgomery-form limb batch (host-side)."""
        return limb_codec.ints_to_limbs(
            [(x * self.r_int) % self.n_int for x in xs], self.nlimbs
        )

    def decode(self, a) -> list[int]:
        """Montgomery-form limb batch → ints (host-side)."""
        rinv = pow(self.r_int, -1, self.n_int)
        return [(x * rinv) % self.n_int for x in limb_codec.limbs_to_ints(a)]
