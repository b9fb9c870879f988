"""Batched big-integer arithmetic as PyTorch tensor programs — the limb engine.

Counterpart of ``bftkv_tpu/ops/bigint.py``.  Numbers are ``(batch, L)``
tensors of 16-bit digits, little-endian, as the reference's ``(batch, L)``
uint32 arrays (:func:`limbs_from_numpy` carries those across).  The
tensors are int64 because CPU torch's uint32 support is partial; every
intermediate is an exact integer below 2^33, so the digits equal the
reference's bit for bit.

The programs are the reference's, op for op:

- digit products of 16-bit limbs are exact; column sums are kept below
  2^25 by a lo/hi split (:func:`_mul_cols`, a Toeplitz product);
- carries resolve in two local passes, then a Kogge–Stone
  generate/propagate done as log₂ steps (:func:`carry_resolve`);
- modular arithmetic is Montgomery form (REDC with R = 2^(16·L));
- :func:`mont_exp` is a fixed 4-bit window.  Its window select is an
  arithmetic one-hot blend over all 16 table entries (the reference
  gathers, ``bigint.py:259-261``): on the card a gather would be an
  address that depends on a secret nibble.  The values are the same.

:class:`MontgomeryDomain` (host precompute) is also the RSA domains'
key-eligibility check: an even modulus, or one wider than the limb
budget, is refused with ``ValueError``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.ops import limb as limb_codec
from bftkv_tpu_torch.ops.limb import LIMB_BITS, LIMB_MASK

__all__ = [
    "DomainCache",
    "MontgomeryDomain",
    "add",
    "carry_resolve",
    "from_mont",
    "geq",
    "limbs_from_numpy",
    "mont_exp",
    "mont_mul",
    "mont_pow_static",
    "mul",
    "sub_mod_r",
    "to_mont",
]

_WINDOW = 4


def limbs_from_numpy(a, device) -> torch.Tensor:
    """``(..., L)`` 16-bit digit arrays (the reference's uint32 limbs, e.g.
    ``MontgomeryDomain.n``) → int64 tensor on ``device``, same shape: the
    form the limb engine takes.  The limb counterpart of
    :func:`bftkv_tpu_torch.ops.rns.consts_from_numpy`."""
    dev = devmod.resolve(device)
    a = np.asarray(a)
    if a.dtype.kind not in "iu":
        raise TypeError(f"limbs must be integers, got {a.dtype}")
    a = a.astype(np.int64)
    if a.size and (a.min() < 0 or a.max() > LIMB_MASK):
        raise ValueError("limbs must be 16-bit digits in [0, 2^16)")
    return torch.as_tensor(a, device=dev)


def _shift_up(x: torch.Tensor, s: int = 1) -> torch.Tensor:
    """Multiply by the limb base^s: out[..., k] = x[..., k-s], 0-filled."""
    return torch.nn.functional.pad(x, (s, 0))[..., : x.shape[-1]]


def carry_resolve(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """Resolve lane values (< 2^32) into canonical 16-bit digits.

    The represented value Σ x_k·2^(16k) must fit in ``out_len`` digits.
    Two local passes bound each lane's outstanding carry to one bit, then
    a Kogge–Stone generate/propagate scan finishes the ripple in log₂
    steps (the reference's ``lax.associative_scan``; the carries are
    determined by the value, so the digits are the same).
    """
    k = x.shape[-1]
    w = max(out_len, k) + 1
    x = torch.nn.functional.pad(x, (0, w - k))
    # Pass 1: split digit/carry (carry ≤ 2^16-1).
    e = (x & LIMB_MASK) + _shift_up(x >> LIMB_BITS)  # < 2^17
    # Pass 2: now carries are single bits.
    t = (e & LIMB_MASK) + _shift_up(e >> LIMB_BITS)  # ≤ 2^16
    r = t & LIMB_MASK
    g = t >> LIMB_BITS  # generate, 0/1
    p = (r == LIMB_MASK).to(torch.int64)  # propagate
    s = 1
    while s < w:
        g = g | (p & _shift_up(g, s))
        p = p & _shift_up(p, s)
        s *= 2
    return ((r + _shift_up(g)) & LIMB_MASK)[..., :out_len]


def _mul_cols(a: torch.Tensor, b: torch.Tensor, ncols: int) -> torch.Tensor:
    """Unresolved column sums of a·b, first ``ncols`` digit positions.

    The reference gathers ``b`` into anti-diagonal (Toeplitz) alignment;
    here the same alignment is a sliding-window view of zero-padded ``b``
    (``win[..., i', k] = b[..., k + i' - (L-1)]``) paired with ``a``
    reversed, so no index tensor is read.  The columns are the
    reference's: Σ_i lo(a_i·b_{k-i}) + Σ_i hi(a_i·b_{k-1-i}).
    """
    nl = a.shape[-1]
    win = torch.nn.functional.pad(b, (nl - 1, ncols - nl)).unfold(-1, ncols, 1)
    p = a.flip(-1)[..., :, None] * win  # (..., nl, ncols) exact digit products
    hi = (p >> LIMB_BITS).sum(dim=-2)
    lo = p.sum(dim=-2) - (hi << LIMB_BITS)  # Σ (p & mask) ≤ nl·(2^16-1) < 2^24
    return lo + _shift_up(hi)  # < 2^25


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full product, ``(..., L) × (..., L) → (..., 2L)``."""
    nl = a.shape[-1]
    return carry_resolve(_mul_cols(a, b, 2 * nl), 2 * nl)


def _mul_lo(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Low half of the product (mod R), ``(..., L) → (..., L)``."""
    nl = a.shape[-1]
    return carry_resolve(_mul_cols(a, b, nl), nl)


def add(a: torch.Tensor, b: torch.Tensor, out_len: int) -> torch.Tensor:
    """a + b into ``out_len`` digits (must fit)."""
    w = max(a.shape[-1], b.shape[-1])
    ext = lambda x: torch.nn.functional.pad(x, (0, w - x.shape[-1]))
    return carry_resolve(ext(a) + ext(b), out_len)


def sub_mod_r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod R over the common digit width (two's-complement add)."""
    s = a + (LIMB_MASK - b)
    s[..., 0] += 1
    return carry_resolve(s, a.shape[-1])


def geq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic a ≥ b over the last axis; returns (...,) bool."""
    ne = (a != b).to(torch.int8)
    # Highest differing digit (0 if all equal — then a == b there, so ≥);
    # argmax returns the first maximum, as jnp.argmax does.
    rev_arg = torch.argmax(ne.flip(-1), dim=-1)
    idx = (a.shape[-1] - 1 - rev_arg)[..., None]
    at = torch.take_along_dim(a, idx, dim=-1)[..., 0]
    bt = torch.take_along_dim(b, idx, dim=-1)[..., 0]
    return at >= bt


def _cond_sub(t: torch.Tensor, n: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """t (+ hi·R) − n if that quantity is ≥ 0 and t < 2n; else t. L digits."""
    need = (hi != 0) | geq(t, n)
    return torch.where(need[..., None], sub_mod_r(t, n), t)


def mont_mul(
    a: torch.Tensor, b: torch.Tensor, n: torch.Tensor, n_prime: torch.Tensor
) -> torch.Tensor:
    """Montgomery product abR⁻¹ mod n (REDC). All inputs < n, L digits."""
    nl = a.shape[-1]
    t_cols = _mul_cols(a, b, 2 * nl)  # unresolved T = a·b
    t_lo = carry_resolve(t_cols[..., :nl], nl)  # T mod R (low half exact)
    m = _mul_lo(t_lo, n_prime.expand(t_lo.shape))
    mn_cols = _mul_cols(m, n.expand(m.shape), 2 * nl)
    # (T + m·n) / R: sum the unresolved columns, resolve into 2L+1 digits.
    s = carry_resolve(t_cols + mn_cols, 2 * nl + 1)  # sums < 2^26: exact
    t = s[..., nl : 2 * nl]
    hi = s[..., 2 * nl]
    return _cond_sub(t, n.expand(t.shape), hi)


def to_mont(
    x: torch.Tensor, r2: torch.Tensor, n: torch.Tensor, n_prime: torch.Tensor
) -> torch.Tensor:
    return mont_mul(x, r2.expand(x.shape), n, n_prime)


def from_mont(x: torch.Tensor, n: torch.Tensor, n_prime: torch.Tensor) -> torch.Tensor:
    one = torch.zeros_like(x)
    one[..., 0] = 1
    return mont_mul(x, one, n, n_prime)


def mont_pow_static(
    a_mont: torch.Tensor, e: int, n: torch.Tensor, n_prime: torch.Tensor
) -> torch.Tensor:
    """a^e in Montgomery form for a *static public* exponent (e.g. 65537):
    the square-and-multiply chain unrolls in Python."""
    if e <= 0:
        raise ValueError("mont_pow_static: exponent must be positive")
    acc = a_mont
    for bit in bin(e)[3:]:  # skip leading 1
        acc = mont_mul(acc, acc, n, n_prime)
        if bit == "1":
            acc = mont_mul(acc, a_mont, n, n_prime)
    return acc


def mont_exp(
    a_mont: torch.Tensor,
    e: torch.Tensor,
    n: torch.Tensor,
    n_prime: torch.Tensor,
    one_mont: torch.Tensor,
) -> torch.Tensor:
    """a^e in Montgomery form; ``e`` is a per-element (or shared) limb tensor.

    Fixed 4-bit windows, most significant first: 4 squarings and one
    product with the table entry per window, the same schedule for every
    row.  The entry is chosen by a one-hot blend over all 16 entries, so
    no index or address depends on the (secret) exponent.
    """
    a_mont, n, n_prime, one_mont = torch.broadcast_tensors(a_mont, n, n_prime, one_mont)
    if e.dim() < a_mont.dim():
        e = e.expand(a_mont.shape[:-1] + e.shape[-1:])
    nwin = e.shape[-1] * (LIMB_BITS // _WINDOW)

    # Power table t[j] = a^j·R mod n for j in [0, 16), shape (..., 16, L).
    powers = [one_mont]
    for _ in range(15):
        powers.append(mont_mul(powers[-1], a_mont, n, n_prime))
    table = torch.stack(powers, dim=-2)
    entries = torch.arange(16, device=e.device)

    acc = one_mont
    for j in range(nwin):
        widx = nwin - 1 - j  # window j counts from the most significant end
        limb_idx = widx // (LIMB_BITS // _WINDOW)
        shift = (widx % (LIMB_BITS // _WINDOW)) * _WINDOW
        wv = (e[..., limb_idx] >> shift) & (2**_WINDOW - 1)
        for _ in range(_WINDOW):
            acc = mont_mul(acc, acc, n, n_prime)
        onehot = (wv[..., None] == entries).to(table.dtype)  # (..., 16)
        sel = (onehot[..., None] * table).sum(dim=-2)
        acc = mont_mul(acc, sel, n, n_prime)
    return acc


class MontgomeryDomain:
    """Host-side precomputation for one odd modulus.

    Holds ``n``, ``n' = -n⁻¹ mod R``, ``R² mod n`` and ``R mod n`` as
    uint32 limb arrays (the reference's form; :func:`limbs_from_numpy`
    moves them onto a device).
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


class DomainCache:
    """Thread-safe LRU of :class:`MontgomeryDomain` by (modulus, limbs),
    holding None for a modulus the domain refuses.  Bounded, since moduli
    reach the domains from certificates and peers (attacker-influenced)."""

    def __init__(self, cap: int):
        self.cap = cap
        self._doms: "OrderedDict[tuple[int, int], MontgomeryDomain | None]" = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._doms)

    def __contains__(self, key) -> bool:
        return key in self._doms

    def get(self, n: int, nlimbs: int) -> MontgomeryDomain | None:
        key = (n, nlimbs)
        with self._lock:
            dom = self._doms.get(key, False)
            if dom is not False:
                self._doms.move_to_end(key)
                return dom
        try:
            dom = MontgomeryDomain(n, nlimbs)
        except ValueError:
            dom = None
        with self._lock:
            self._doms[key] = dom
            if len(self._doms) > self.cap:
                self._doms.popitem(last=False)
        return dom
