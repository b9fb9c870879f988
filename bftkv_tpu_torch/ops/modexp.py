"""Shared batched-modexp engine (counterpart of ``bftkv_tpu/ops/modexp.py``).

Threshold RSA's per-fragment signing, threshold DSA's partial-R
combination and TPA's DH rounds all bottom out in ``pow(b, e, n)`` loops
over one modulus; :meth:`BatchModExp.modexp` runs such a batch as one
device launch:

- batches below ``min_batch`` (``BFTKV_TPU_MIN_MODEXP_BATCH``, default
  4) and even moduli: host ``pow``;
- operands up to 1024 or 2048 bits: the RNS windowed modexp
  (:func:`bftkv_tpu_torch.ops.rns.power_mod_rns`, kernel K2), its
  operands staged through the persistent rings of
  :mod:`bftkv_tpu_torch.ops.devbuf` (reference ``modexp.py:80-95``);
- wider operands (threshold-RSA fragment exponents outgrow the key), or
  a modulus the RNS bases decline: the limb engine's ``power_batch``,
  with the exponent width bucketed to 64/128/256 limbs;
- exponents over 256 limbs: host ``pow``.

Only the RNS path's "this modulus cannot ride RNS" answer (``None``)
sends a batch to the limb path; an RNS error propagates (the reference
degrades on any exception, ``ops/modexp.py:89-104``).  Per-modulus
Montgomery precomputation is LRU-bounded since moduli can be influenced
by remote peers.
"""

from __future__ import annotations

import numpy as np

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import bigint, limb, rns
from bftkv_tpu_torch.ops import rsa as rsa_ops

__all__ = ["BatchModExp"]


class BatchModExp:
    _shared = None
    _DOM_CACHE_MAX = 64

    # Exponents can outgrow the modulus (threshold-RSA fragments double in
    # width per tree level).  Past this limb width the window loop
    # dominates and host pow wins; cap the device path.
    MAX_EXP_LIMBS = 256  # 4096 bits

    def __init__(self, min_batch: int | None = None, *, device=None):
        self.device = devmod.resolve(device)
        if min_batch is None:
            min_batch = int(flags.raw("BFTKV_TPU_MIN_MODEXP_BATCH", "4"))
        self.min_batch = min_batch
        self._domains = bigint.DomainCache(self._DOM_CACHE_MAX)

    @classmethod
    def shared(cls) -> "BatchModExp":
        if cls._shared is None:
            cls._shared = cls()
        return cls._shared

    def modexp(self, pairs: list[tuple[int, int]], n: int) -> list[int]:
        """[(base, exp)] → [base^exp mod n] — one device launch when the
        batch is big enough and ``n`` is odd (Montgomery-compatible)."""
        if not pairs:
            return []
        if len(pairs) < self.min_batch or n % 2 == 0 or n <= 1:
            return [pow(b % n, e, n) for b, e in pairs]
        max_e = max(e for _, e in pairs)
        width = max(n.bit_length(), max_e.bit_length())
        nb = next((w for w in (1024, 2048) if width <= w), None)
        if nb is not None:
            vals = rns.power_mod_rns(
                [b for b, _ in pairs], [e for _, e in pairs], [n] * len(pairs),
                n_bits=nb, device=self.device,
            )
            if vals is not None:
                metrics.incr("modexp.rns_staged", len(pairs))
                return vals
            # A modulus the RNS bases cannot take: the limb path.

        e_limbs = max(limb.nlimbs_for_bits(max_e.bit_length()), 1)
        if e_limbs > self.MAX_EXP_LIMBS:
            return [pow(b % n, e, n) for b, e in pairs]
        # Bucket the exponent width (64/128/256 limbs) so varying widths
        # share a handful of shapes.
        e_limbs = next(b for b in (64, 128, 256) if e_limbs <= b)
        nlimbs = limb.nlimbs_for_bits(n.bit_length())
        dom = self._domains.get(n, nlimbs)  # n is odd and fits: never None
        base = limb.ints_to_limbs([b % n for b, _ in pairs], nlimbs)
        exp = limb.ints_to_limbs([e for _, e in pairs], e_limbs)
        out = rsa_ops.power_batch(
            base, exp,
            *(np.broadcast_to(a, base.shape) for a in (dom.n, dom.n_prime, dom.r2, dom.one_mont)),
            device=self.device,
        )
        return limb.limbs_to_ints(out.cpu().numpy())
