"""Batched RSA on the limb engine (counterpart of ``bftkv_tpu/ops/rsa.py``).

- :func:`verify_batch_e65537` — the ``limb`` verify backend: s^65537 mod n
  == em per row, through :func:`_verify_chain`;
- :func:`power_batch` — base^e mod n with per-row full-width exponents,
  the limb modexp of the ``limb`` sign backend and of
  :class:`bftkv_tpu_torch.ops.modexp.BatchModExp`.

The JAX package computes these in XLA, outside any Pallas kernel, so on
the card they stay PyTorch tensor programs.  :func:`_verify_chain` on CPU
tensors is also the plain version of kernel K3
(:mod:`bftkv_tpu_torch.ops.cuda_mont`), which computes the same chain.
"""

from __future__ import annotations

import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.ops import bigint

__all__ = ["power_batch", "verify_batch_e65537"]

F4 = 65537


def _verify_chain(sig, em, n, n_prime, r2) -> torch.Tensor:
    """(T, L) ``v XOR em`` with v = sig^65537 mod n, as int64 digits.

    The chain of ``pallas_mont._verify_kernel``: to-Montgomery with r2,
    16 squarings, ×s, from-Montgomery, then the XOR the Pallas kernel
    writes (a row verifies iff its diff is all zero).
    """
    s_mont = bigint.to_mont(sig, r2, n, n_prime)
    v_mont = bigint.mont_pow_static(s_mont, F4, n, n_prime)
    return bigint.from_mont(v_mont, n, n_prime) ^ em


def verify_batch_e65537(sig, em, n, n_prime, r2, *, device=None) -> torch.Tensor:
    """sig^65537 mod n == em, elementwise over the batch.

    All operands are ``(batch, L)`` 16-bit digit arrays (per-element
    public keys: a batch may mix keys freely).  Returns a ``(batch,)``
    bool tensor on ``device``.
    """
    dev = devmod.resolve(device)
    ops = [bigint.limbs_from_numpy(a, dev) for a in (sig, em, n, n_prime, r2)]
    return (_verify_chain(*ops) == 0).all(dim=-1)


def power_batch(base, e, n, n_prime, r2, one_mont, *, device=None) -> torch.Tensor:
    """base^e mod n with per-element full-width exponents.

    ``(batch, L)`` digit arrays, ``e`` ``(batch, E)`` (E may differ from
    L).  The workhorse of threshold-RSA partial signing and of the limb
    CRT sign.  Returns ``(batch, L)`` int64 digits on ``device``.
    """
    dev = devmod.resolve(device)
    base, e, n, n_prime, r2, one_mont = (
        bigint.limbs_from_numpy(a, dev) for a in (base, e, n, n_prime, r2, one_mont)
    )
    b_mont = bigint.to_mont(base, r2, n, n_prime)
    v_mont = bigint.mont_exp(b_mont, e, n, n_prime, one_mont.expand(b_mont.shape))
    return bigint.from_mont(v_mont, n, n_prime)
