"""RSA in a residue number system — the port's RNS engine.

Counterpart of ``bftkv_tpu/ops/rns.py``.  Numbers live as residues
modulo ~2k primes of 11-12 bits (two bases B, B' plus a 2^12 redundant
channel), so a product is channelwise; Montgomery reduction (Bajard's
AMM) needs two base extensions per product, each Σ_i σ_i·(M/p_i mod
target) over a matrix fixed by the bases; the return extension is made
exact with the Shenoy–Kumaresan correction through the 2^12 channel;
the verify check needs no conversion back to positional form
(Δ_j = (v_j − em_j)·N⁻¹ mod p_j is one small α in every channel iff the
signature is valid).

Three parts:

- **host side, copied** from the reference: :class:`RNSContext` with its
  per-key rows, :func:`context`, :func:`stack_key_rows`,
  :func:`digits_to_halves`, :func:`_crt_matrix`, :func:`_sigma_to_ints`,
  :class:`DeferredModexp`;
- **plain PyTorch versions** of the device math (:func:`_mont_mul`,
  :func:`_to_residues`, :func:`_verify_kernel`, :func:`_pow_kernel`).
  Residues are canonical integers in [0, p), so int64 arithmetic gives
  the reference's f32-Barrett values bit for bit; the base-extension
  dot products run in float64, exact because every sum stays below
  2^32 (k ≤ 256 terms of < 2^24), far under float64's 2^53 — and
  float64 never takes the TF32 path on CUDA;
- **entry points** :func:`verify_e65537_rns_indexed` and
  :func:`power_mod_rns`.  They stage their operands into a slot of a
  persistent ring (:mod:`bftkv_tpu_torch.ops.devbuf`; :func:`_pow_staging`,
  :func:`_verify_staging`), writing each integer's little-endian bytes
  straight into its row (a row's 8-bit digit halves are exactly those
  bytes), and go through the wrappers in
  :mod:`bftkv_tpu_torch.ops.cuda_rns`, which launch the hand-written
  kernels for CUDA tensors and run the plain versions above only for CPU
  tensors.  On the card the copies in, the launch and the copy out go on
  the calling thread's current stream, and an event recorded behind them
  is what the caller (or :meth:`DeferredModexp.wait`) waits on.

**The split over local cards** (the reference's ``_mesh``, ``_shardable``
and its ``shard_map`` verify and pow jits).  Both entry points split a
padded batch into contiguous row shards, one per device of
:func:`shard_devices` — every local ``cuda:i`` from the caller's card
on, or none under two cards or with ``BFTKV_SHARD=off`` — when the padded batch divides by the shard
count.  Each shard stages into its own card's ring, with the key rows
and the constants copied to that card, and launches on its own stream
(shard 0 on the caller's current stream, shard i > 0 on the thread's
stream i of its card, :func:`bftkv_tpu_torch.device.stream`); the
results are joined in order.  There is no collective: the shards share
nothing but the host arrays.  :func:`shard_over` is the test seam in
place of the reference's ``hostcpu.force_cpu(n)``: it names the shard
devices, repeats allowed, so that n shards run on one card or on the
``cpu``.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.ops import devbuf, limb

__all__ = [
    "RNSContext",
    "context",
    "consts",
    "consts_from_numpy",
    "context_arrays",
    "gather_key",
    "key_rows_from_numpy",
    "verify_e65537_rns_indexed",
    "power_mod_rns",
    "bytes_rows",
    "stack_key_rows",
    "digits_to_halves",
    "digits_to_halves_u8",
    "shard_devices",
    "shard_over",
    "shard_scope",
]

PR_BITS = 12
PR = 1 << PR_BITS  # redundant modulus (power of two)
_PR_MASK = PR - 1
DIGITS = 128  # 16-bit digits per 2048-bit number
# Largest context the CUDA kernels take (csrc/rns_pow.cu::rns_pow_launch): K2
# runs one warp per 16 of the k + 1 extension outputs, at most 16 warps, and
# sums k products of 12-bit residues exactly in uint32.  K1
# (csrc/rns_chain.cu::rns_verify_launch) runs at most 12 warps and refuses
# k > 191; the verify path's one context has k = 188.
MAX_CHANNELS = 255
MAX_DIGITS = 256


def _gen_primes(lo: int, hi: int) -> list[int]:
    sieve = np.ones(hi - lo, dtype=bool)
    for p in range(2, int(hi**0.5) + 1):
        start = max(p * p, ((lo + p - 1) // p) * p)
        sieve[start - lo :: p] = False
    return [int(lo + i) for i in np.nonzero(sieve)[0]]


class RNSContext:
    """Shared (key-independent) precomputation for one digit width.

    A copy of the reference's ``RNSContext``: same primes, same order,
    same arrays (f32 holding exact integers, matrices as 6-bit planes),
    so :func:`consts_from_numpy` takes either package's arrays.
    """

    def __init__(self, digits: int = DIGITS, n_bits: int = 2048):
        # All primes below 2^12, largest first; two interleaved bases
        # so both get ~equal bit mass.  Each base must clear n_bits by a
        # healthy margin (the AMM slack analysis needs M > (k+2)^2 N).
        primes = [p for p in _gen_primes(1 << 10, 1 << PR_BITS)][::-1]
        need = n_bits + 64
        self.pb: list[int] = []
        self.pq: list[int] = []
        bits_b = bits_q = 0.0
        for p in primes:
            if bits_b <= bits_q:
                self.pb.append(p)
                bits_b += np.log2(p)
            else:
                self.pq.append(p)
                bits_q += np.log2(p)
            if bits_b > need and bits_q > need:
                break
        else:
            raise ValueError("not enough sub-2^12 primes for the bases")
        k = min(len(self.pb), len(self.pq))
        self.pb, self.pq = self.pb[:k], self.pq[:k]
        self.k = k
        self.digits = digits
        self.M = 1
        for p in self.pb:
            self.M *= p
        self.Mq = 1
        for q in self.pq:
            self.Mq *= q
        if self.M <= (1 << need) or self.Mq <= (1 << need):
            raise ValueError("base bit mass too small")

        f = lambda xs: np.asarray(xs, dtype=np.float32)
        self.p_all = f(self.pb + self.pq)
        self.inv_all = np.float32(1.0) / self.p_all  # the reference's Barrett reciprocals

        # --- extension B -> B' (+ redundant channel) ------------------
        Mi = [self.M // p for p in self.pb]
        self.invMi_b = f([pow(Mi[i] % p, -1, p) for i, p in enumerate(self.pb)])
        E1 = np.zeros((k, k + 1), dtype=np.int64)
        for i in range(k):
            for j, q in enumerate(self.pq):
                E1[i, j] = Mi[i] % q
            E1[i, k] = Mi[i] % PR
        self._E1 = self._split6(E1)

        # --- extension B' -> B (+ redundant channel, Shenoy) ----------
        Mqj = [self.Mq // q for q in self.pq]
        self.invMi_q = f([pow(Mqj[j] % q, -1, q) for j, q in enumerate(self.pq)])
        E2 = np.zeros((k, k + 1), dtype=np.int64)
        for j in range(k):
            for i, p in enumerate(self.pb):
                E2[j, i] = Mqj[j] % p
            E2[j, k] = Mqj[j] % PR
        self._E2 = self._split6(E2)
        self.Mq_mod_b = f([self.Mq % p for p in self.pb])
        self.invMq_pr = np.float32(pow(self.Mq % PR, -1, PR))
        self.invM_q = f([pow(self.M % q, -1, q) for q in self.pq])
        self.invM_pr = np.float32(pow(self.M % PR, -1, PR))

        # --- digit -> residue conversion ------------------------------
        # Rows are the 8-bit halves of the 16-bit digits (lo, hi).
        D = np.zeros((2 * digits, 2 * k + 1), dtype=np.int64)
        for d in range(digits):
            w_lo = pow(1 << 16, d)
            w_hi = (w_lo << 8)
            for ch, p in enumerate(self.pb + self.pq):
                D[2 * d, ch] = w_lo % p
                D[2 * d + 1, ch] = w_hi % p
            D[2 * d, 2 * k] = w_lo % PR
            D[2 * d + 1, 2 * k] = w_hi % PR
        self._D = self._split6(D)

    @staticmethod
    def _split6(m: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """12-bit entries → two 6-bit f32 planes."""
        return (
            (m & 63).astype(np.float32),
            (m >> 6).astype(np.float32),
        )

    # -- per-key (per modulus N) data, host side ------------------------

    @functools.lru_cache(maxsize=4096)
    def key_rows(self, n: int):
        """Channel constants for one public modulus ``n`` (cached).

        Returns None for moduli that cannot ride the RNS path: even, too
        wide for the digit budget, or sharing a factor with a channel
        prime — certificates are attacker-supplied, so such keys must
        fall back, not raise.
        """
        if n <= 0 or n % 2 == 0 or n.bit_length() > 16 * self.digits:
            return None
        chans = self.pb + self.pq
        for p in chans:
            if n % p == 0:
                return None
        f = lambda xs: np.asarray(xs, dtype=np.float32)
        n_all = f([n % p for p in chans])
        n_r = np.float32(n % PR)
        neg_ninv_b = f([(-pow(n, -1, p)) % p for p in self.pb])
        ninv_all = f([pow(n % p, -1, p) for p in chans])
        m2 = (self.M * self.M) % n
        m2_all = f([m2 % p for p in chans])
        m2_r = np.float32(m2 % PR)
        return n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r


@functools.lru_cache(maxsize=4)
def context(digits: int = DIGITS, n_bits: int = 2048) -> RNSContext:
    return RNSContext(digits, n_bits)


# ---------------------------------------------------------------------------
# Carrying the reference's parameters across: the system has no model
# weights; its parameters are the context constants and the key rows.
# ---------------------------------------------------------------------------

#: The RNSContext attributes the device math reads.
CONTEXT_ARRAYS = (
    "p_all", "inv_all", "invMi_b", "invMi_q", "_E1", "_E2", "_D",
    "Mq_mod_b", "invMq_pr", "invM_q", "invM_pr",
)


def context_arrays(ctx) -> dict:
    """The :data:`CONTEXT_ARRAYS` of an ``RNSContext`` (either package's)
    as a dict of numpy arrays, the form :func:`consts_from_numpy` takes."""
    return {name: getattr(ctx, name) for name in CONTEXT_ARRAYS}


def _exact_int(a, name: str) -> np.ndarray:
    a = np.asarray(a, dtype=np.float64)
    out = a.astype(np.int64)
    if not np.array_equal(out, a) or (out < 0).any() or (out >= 1 << 24).any():
        raise ValueError(f"{name}: not exact non-negative integers < 2^24")
    return out


def barrett_mu(p) -> np.ndarray:
    """μ_p = ⌊2^32/p⌋ (uint64 values < 2^32 for p ≥ 2).  The kernels reduce an
    x < 2^32 as q = umulhi(x, μ_p), r = x − q·p, one conditional
    subtraction of p."""
    p = np.asarray(p, dtype=np.uint64)
    if (p < 2).any():
        raise ValueError("Barrett reciprocals need p >= 2")
    return (np.uint64(1) << np.uint64(32)) // p


def shoup_w(w, p) -> np.ndarray:
    """w′ = ⌊w·2^32/p⌋ for a fixed multiplier w < p.  The kernels reduce a·w
    (a < 2^32) as q = umulhi(a, w′), r = a·w − q·p mod 2^32, one
    conditional subtraction of p."""
    w = np.asarray(w, dtype=np.uint64)
    p = np.asarray(p, dtype=np.uint64)
    if (w >= p).any():
        raise ValueError("Shoup multipliers must be reduced: w < p")
    return (w << np.uint64(32)) // p


#: The RNS kernels' tensor-core tile: mma.sync m16n8k32 (M channels out, K channels in).
MMA_M, MMA_K = 16, 32


def mma_dims(k: int) -> tuple[int, int]:
    """(M_pad, K_pad): the k+1 extension outputs (B′ or B, then 2^12) and
    the k inputs, padded to whole tensor-core tiles."""
    return -(-(k + 1) // MMA_M) * MMA_M, -(-k // MMA_K) * MMA_K


def _fragment_index(m_pad: int, k_pad: int):
    """(row, col) of A = (M_pad, K_pad) for each byte of the fragment
    order (M tile, K step, lane, 16 bytes): lane = 4g + t holds the s8
    words (g, 4t), (g+8, 4t), (g, 16+4t), (g+8, 16+4t) of its tile, four
    consecutive K entries per word, lowest first — PTX's A layout of
    mma.m16n8k32 (row-major A)."""
    mt, ks, lane, byte = np.meshgrid(
        np.arange(m_pad // MMA_M), np.arange(k_pad // MMA_K), np.arange(32),
        np.arange(16), indexing="ij",
    )
    g, t = lane >> 2, lane & 3
    word, b = byte >> 2, byte & 3
    row = mt * MMA_M + g + 8 * (word & 1)
    col = ks * MMA_K + 16 * (word >> 1) + 4 * t + b
    return row, col


def mma_planes(E1: np.ndarray, E2: np.ndarray) -> np.ndarray:
    """The kernels' A operands: for each extension matrix E (k, k+1), A = Eᵀ zero
    padded to (M_pad, K_pad), split into 6-bit planes (lo, hi), each
    entry < 64, as int8 in fragment order.  Shape (2 extensions, 2
    planes, M_pad/16, K_pad/32, 32 lanes, 16 bytes)."""
    k = E1.shape[0]
    m_pad, k_pad = mma_dims(k)
    row, col = _fragment_index(m_pad, k_pad)
    out = []
    for E in (E1, E2):
        a = np.zeros((m_pad, k_pad), dtype=np.int64)
        a[: k + 1, :k] = np.asarray(E, dtype=np.int64).T
        out.append([(a & 63)[row, col], (a >> 6)[row, col]])
    return np.asarray(out, dtype=np.int8)


class _Consts:
    """Context constants as int64 tensors on one device, plus the packed
    int32/int16/int8 forms the CUDA kernels read (``kern``)."""

    def __init__(self, arrays: dict, device: torch.device):
        missing = [n for n in CONTEXT_ARRAYS if n not in arrays]
        if missing:
            raise KeyError(f"context arrays missing {missing}")
        p_all = _exact_int(arrays["p_all"], "p_all")
        if not np.array_equal(
            np.float32(1.0) / p_all.astype(np.float32),
            np.asarray(arrays["inv_all"], dtype=np.float32),
        ):
            raise ValueError("inv_all does not belong to p_all")
        k = len(np.asarray(arrays["invMi_b"]))
        if p_all.shape != (2 * k,):
            raise ValueError(f"p_all shape {p_all.shape} != ({2 * k},)")
        if k > MAX_CHANNELS:
            raise ValueError(f"k={k} channels exceeds {MAX_CHANNELS}")

        def plane(name):
            lo, hi = arrays[name]
            return _exact_int(np.asarray(lo) + 64.0 * np.asarray(hi), name)

        E1, E2, D = plane("_E1"), plane("_E2"), plane("_D")
        if E1.shape != (k, k + 1) or E2.shape != (k, k + 1):
            raise ValueError("extension matrices must be (k, k+1)")
        if D.shape[1] != 2 * k + 1 or D.shape[0] % 2:
            raise ValueError("conversion matrix must be (2·digits, 2k+1)")
        if D.shape[0] // 2 > MAX_DIGITS:
            raise ValueError(f"{D.shape[0] // 2} digits exceeds {MAX_DIGITS}")
        self.k = k
        self.digits = D.shape[0] // 2
        self.device = device
        t64 = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        vec = lambda name: _exact_int(arrays[name], name)
        self.pb = t64(p_all[:k])
        self.pq = t64(p_all[k:])
        self.invMi_b = t64(vec("invMi_b"))
        self.invMi_q = t64(vec("invMi_q"))
        self.Mq_mod_b = t64(vec("Mq_mod_b"))
        self.invM_q = t64(vec("invM_q"))
        self.invMq_pr = int(_exact_int(arrays["invMq_pr"], "invMq_pr"))
        self.invM_pr = int(_exact_int(arrays["invM_pr"], "invM_pr"))
        # float64 copies for the exact dot products of the plain version.
        self.E1f, self.E2f, self.Df = f64(E1), f64(E2), f64(D)
        t32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=device)
        t16 = lambda a: torch.as_tensor(a, dtype=torch.int16, device=device)
        u32 = lambda a: t32(np.asarray(a, dtype=np.uint32).view(np.int32))
        pb, pq = p_all[:k], p_all[k:]
        self.kern = {
            "p_all": t32(p_all),
            "invMi_b": t32(vec("invMi_b")),
            "invMi_q": t32(vec("invMi_q")),
            "Mq_mod_b": t32(vec("Mq_mod_b")),
            "invM_q": t32(vec("invM_q")),
            "D": t16(D),  # entries < 2^12: the kernels read them as uint16
            # The kernels' reciprocals, as uint32 bit patterns: Barrett's μ_p
            # per channel of [B | B'], Shoup's w' of each fixed multiplier.
            "mu_all": u32(barrett_mu(p_all)),
            "invMi_b_sh": u32(shoup_w(vec("invMi_b"), pb)),
            "Mq_mod_b_sh": u32(shoup_w(vec("Mq_mod_b"), pb)),
            "invM_q_sh": u32(shoup_w(vec("invM_q"), pq)),
            # The extension matrices as int8 6-bit planes in mma fragment order.
            "E_mma": torch.as_tensor(mma_planes(E1, E2), device=device),
        }


def consts_from_numpy(arrays: dict, device) -> _Consts:
    """The port's constant tensors from an ``RNSContext``'s numpy arrays
    (``p_all``, ``inv_all``, ``invMi_b``, ``invMi_q``, ``_E1``, ``_E2``,
    ``_D``, ``Mq_mod_b``, ``invMq_pr``, ``invM_q``, ``invM_pr``)."""
    return _Consts(arrays, devmod.resolve(device))


_consts_lock = threading.Lock()
_consts_cache: dict = {}


def consts(digits: int, n_bits: int, device) -> _Consts:
    """Constants of :func:`context` ``(digits, n_bits)`` on ``device``, cached.

    Built on whatever stream is current at first use; on the card the
    build waits for its copies, so every flush worker's stream may read
    them at once.
    """
    dev = devmod.resolve(device)
    key = (digits, n_bits, str(dev))
    with _consts_lock:
        cn = _consts_cache.get(key)
        if cn is None:
            cn = _Consts(context_arrays(context(digits, n_bits)), dev)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            _consts_cache[key] = cn
        return cn


def key_rows_from_numpy(ukey: tuple, device) -> tuple:
    """Stacked key rows (the :func:`stack_key_rows` tuple, numpy f32 of
    exact integers) → int32 tensors on ``device``, same shapes: the form
    the kernels read."""
    if len(ukey) != 6:
        raise ValueError(f"expected 6 key-row arrays, got {len(ukey)}")
    dev = devmod.resolve(device)
    return tuple(
        torch.as_tensor(_exact_int(u, "key row"), dtype=torch.int32, device=dev)
        for u in ukey
    )


def gather_key(ukey: tuple, idx: torch.Tensor) -> tuple:
    """Per-row int64 key tensors ``u[idx]`` for the plain versions."""
    i = idx.long()
    return tuple(u[i].long() for u in ukey)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the device math.  All tensors int64 holding
# canonical residues; channels ride the last axis.  One number is
# (xb (T,k), xq (T,k), xr (T,1)).
# ---------------------------------------------------------------------------


def _barrett(x, p):
    """x mod p, exact (the reference's f32 reciprocal + fixups)."""
    return torch.remainder(x, p)


def _mulmod(a, b, p):
    return _barrett(a * b, p)


def _dot(x, m64):
    """Exact Σ_i x[:, i]·M[i, j]: float64 sums of < 2^32 are exact."""
    return (x.to(torch.float64) @ m64).to(torch.int64)


def _mont_mul(cn: _Consts, a, b, key):
    """RNS Montgomery product (Bajard AMM + Shenoy return extension)."""
    ab, aq, ar = a
    bb, bq, br = b
    n_all, n_r, neg_ninv_b = key[0], key[1], key[2]
    k = cn.k
    nq = n_all[:, k:]

    db = _mulmod(ab, bb, cn.pb)
    dq = _mulmod(aq, bq, cn.pq)
    dr = (ar * br) & _PR_MASK

    # q = d·(−N⁻¹) mod M, channelwise in B; approximate extension of
    # q̂ = Σ σ_i·M_i (= q + α₁M) to B' ∪ {2^12}.
    qb = _mulmod(db, neg_ninv_b, cn.pb)
    sigma = _mulmod(qb, cn.invMi_b, cn.pb)
    s = _dot(sigma, cn.E1f)
    qhat_q = _barrett(s[:, :k], cn.pq)
    qhat_r = s[:, k:] & _PR_MASK

    # r = (d + q̂·N)/M in B' and the redundant channel.
    t = _mulmod(qhat_q, nq, cn.pq)
    rq = _mulmod(_barrett(dq + t, cn.pq), cn.invM_q, cn.pq)
    rr = (((dr + qhat_r * n_r) & _PR_MASK) * cn.invM_pr) & _PR_MASK

    # Exact extension of r from B' back to B (Shenoy via 2^12 channel).
    sigma2 = _mulmod(rq, cn.invMi_q, cn.pq)
    z = _dot(sigma2, cn.E2f)
    ext_b = _barrett(z[:, :k], cn.pb)
    ext_r = z[:, k:] & _PR_MASK
    # Non-negative: & on two's complement is mod 2^12 for negatives too.
    alpha = (((ext_r - rr) & _PR_MASK) * cn.invMq_pr) & _PR_MASK
    corr = _mulmod(alpha, cn.Mq_mod_b, cn.pb)
    rb = _barrett(ext_b - corr, cn.pb)
    return rb, rq, rr


def _to_residues(cn: _Consts, digit_halves):
    """(T, 2·digits) 8-bit digit halves → residues over [B | B' | 2^12]."""
    s = _dot(digit_halves, cn.Df)
    k = cn.k
    return (
        _barrett(s[:, :k], cn.pb),
        _barrett(s[:, k : 2 * k], cn.pq),
        s[:, 2 * k :] & _PR_MASK,
    )


def _ones_like(x):
    return tuple(torch.ones_like(t) for t in x)


def _verify_kernel(cn: _Consts, sig_halves, em_halves, key):
    """(T,) bool: s^65537 ≡ em (mod N) per row."""
    n_all, n_r, neg_ninv_b, ninv_all, m2_all, m2_r = key
    k = cn.k
    s = _to_residues(cn, sig_halves)
    em_b, em_q, _em_r = _to_residues(cn, em_halves)

    m2 = (m2_all[:, :k], m2_all[:, k:], m2_r)
    sm = _mont_mul(cn, s, m2, key)  # to Montgomery form

    acc = sm
    for _ in range(16):
        acc = _mont_mul(cn, acc, acc, key)
    acc = _mont_mul(cn, acc, sm, key)
    vb, vq, _vr = _mont_mul(cn, acc, _ones_like(sm), key)  # v < (k+1)N

    delta_b = _mulmod(_barrett(vb - em_b, cn.pb), ninv_all[:, :k], cn.pb)
    delta_q = _mulmod(_barrett(vq - em_q, cn.pq), ninv_all[:, k:], cn.pq)
    alpha = delta_b[:, :1]
    ok = (delta_b == alpha).all(dim=1) & (delta_q == alpha).all(dim=1)
    return ok & (alpha[:, 0] <= cn.k + 1)


def _pow_kernel(cn: _Consts, base_halves, exp_nibbles_t, key):
    """acc = base^exp mod N per row; returns CRT coefficients σ over B.

    ``exp_nibbles_t``: (W, T) most-significant nibble first.  The window
    select is a one-hot blend over all 16 entries, as in the reference.
    """
    k = cn.k
    m2 = (key[4][:, :k], key[4][:, k:], key[5])
    base = _to_residues(cn, base_halves)
    ones = _ones_like(base)
    base_m = _mont_mul(cn, base, m2, key)  # to Montgomery form
    one_m = _mont_mul(cn, m2, ones, key)  # M mod N, the Montgomery one

    tab = [one_m, base_m]
    for _ in range(14):
        tab.append(_mont_mul(cn, tab[-1], base_m, key))
    tabs = [torch.stack([t[c] for t in tab], dim=1) for c in range(3)]  # (T,16,·)

    acc = one_m
    for nib in exp_nibbles_t.to(torch.int64):
        for _ in range(4):
            acc = _mont_mul(cn, acc, acc, key)
        oh = torch.nn.functional.one_hot(nib, 16).unsqueeze(-1)  # (T,16,1)
        sel = tuple((oh * t).sum(dim=1) for t in tabs)
        acc = _mont_mul(cn, acc, sel, key)
    vb, _vq, _vr = _mont_mul(cn, acc, ones, key)  # out of Montgomery form
    return _mulmod(vb, cn.invMi_b, cn.pb)


# ---------------------------------------------------------------------------
# Host-side integer rebuild of σ (copied).
# ---------------------------------------------------------------------------


def _crt_matrix(ctx: RNSContext) -> np.ndarray:
    """(k, D) float64 16-bit digit planes of M_i = M/p_i, cached on ctx.
    Row sums Σ σ_i·M_i stay < k·2^12·2^16 = 2^35 < 2^53: exact."""
    m = getattr(ctx, "_crt_digits", None)
    if m is None:
        width = (ctx.M.bit_length() + PR_BITS + 15) // 16 + 1
        m = np.zeros((ctx.k, width), dtype=np.float64)
        for i, p in enumerate(ctx.pb):
            m[i] = limb.int_to_limbs(ctx.M // p, width)
        ctx._crt_digits = m
    return m


def _sigma_to_ints(ctx: RNSContext, sigma: np.ndarray) -> list[int]:
    """Batched RNS→integer via a float64 digit matmul + one carry pass."""
    m = _crt_matrix(ctx)
    acc = sigma.astype(np.float64) @ m  # (T, D) digit sums < 2^35
    acc = acc.astype(np.int64)
    carry = np.zeros(acc.shape[0], dtype=np.int64)
    out = np.empty_like(acc, dtype=np.uint16)
    for d in range(acc.shape[1]):
        s = acc[:, d] + carry
        out[:, d] = (s & 0xFFFF).astype(np.uint16)
        carry = s >> 16
    vals = [int.from_bytes(row.tobytes(), "little") for row in out]
    return [v % ctx.M for v in vals]


class DeferredModexp:
    """Handle for a non-blocking :func:`power_mod_rns` launch: each
    shard's kernel and copy of σ out are already on its stream.
    :meth:`wait` waits for every shard's event, releases every staging
    slot and rebuilds the integers (once); an error of any shard
    propagates after all of them are released.  ``events`` are those
    CUDA events (none on the CPU); ``event`` is the last one."""

    __slots__ = ("_finish", "_value", "_done", "events")

    def __init__(self, finish, events=()):
        self._finish = finish
        self._value = None
        self._done = False
        self.events = tuple(events)

    @property
    def event(self):
        return self.events[-1] if self.events else None

    def wait(self) -> list[int]:
        if not self._done:
            self._done = True
            fin, self._finish = self._finish, None
            self._value = fin()
        return self._value


# ---------------------------------------------------------------------------
# Staging and entry points.
# ---------------------------------------------------------------------------

#: The stacked key-row tensors the kernels read, with their widths in k.
KEY_ROWS = ("n_all", "n_r", "neg_ninv_b", "ninv_all", "m2_all", "m2_r")


def _key_spec(k: int, kpad: int) -> dict:
    return {
        name: ((kpad, w), torch.int32)
        for name, w in zip(KEY_ROWS, (2 * k, 1, k, 2 * k, 2 * k, 1))
    }


def _pow_staging(digits: int, n_bits: int, padded: int, kpad: int, dev: torch.device):
    """One K2 launch's slot: the reference's ``base_halves``, ``nib_t``
    and ``idx``, the unique key rows, and the output σ."""
    k = context(digits, n_bits).k
    spec = {
        "base_halves": ((padded, 2 * digits), torch.uint8),
        "nib_t": ((4 * digits, padded), torch.uint8),
        "idx": ((padded,), torch.int32),
        **_key_spec(k, kpad),
        "sigma": ((padded, k), torch.int32),
    }
    return devbuf.lease(f"pow:{digits}:{n_bits}:{padded}:{kpad}:{dev}", spec, dev,
                        width=str(digits))


def _verify_staging(padded: int, kpad: int, dev: torch.device):
    """One K1 launch's slot: sig and em halves, key index, the unique key
    rows, and the verdicts."""
    k = context().k
    spec = {
        "sig_halves": ((padded, 2 * DIGITS), torch.uint8),
        "em_halves": ((padded, 2 * DIGITS), torch.uint8),
        "idx": ((padded,), torch.int32),
        **_key_spec(k, kpad),
        "ok": ((padded,), torch.int32),
    }
    return devbuf.lease(f"verify:{padded}:{kpad}:{dev}", spec, dev, width="verify")


def bytes_rows(values, nbytes: int) -> np.ndarray:
    """(len(values), nbytes) uint8: each non-negative integer's
    little-endian bytes — its 8-bit digit halves, low half first, so
    ``digits_to_halves_u8(int_to_limbs(v, nbytes // 2))`` row for row."""
    blob = b"".join(v.to_bytes(nbytes, "little") for v in values)
    return np.frombuffer(blob, dtype=np.uint8).reshape(len(values), nbytes)


def _stage_key_rows(slot, urows: list) -> None:
    """The unique key rows into the slot; rows past them copy row 0, as
    the reference pads the unique-key axis."""
    n = len(urows)
    for i, name in enumerate(KEY_ROWS):
        a = slot[name]
        a[:n] = np.stack([np.asarray(r[i]) for r in urows]).reshape(n, -1)
        a[n:] = a[0]


_shard_lock = threading.Lock()
_SHARD_OVER: list | None = None


@contextlib.contextmanager
def shard_over(devices):
    """Test seam: while the block runs, every launch in the process splits
    over ``devices`` (repeats allowed, e.g. ``["cuda:0", "cuda:0"]`` or
    ``["cpu", "cpu"]``) instead of over the local cards.
    ``BFTKV_SHARD=off`` still wins."""
    global _SHARD_OVER
    devs = [devmod.resolve(d) for d in devices]
    if not devs:
        raise ValueError("shard_over needs at least one device")
    with _shard_lock:
        prev, _SHARD_OVER = _SHARD_OVER, devs
    try:
        yield devs
    finally:
        with _shard_lock:
            _SHARD_OVER = prev


def shard_devices(device=None) -> list | None:
    """The devices a launch on ``device`` splits over: the :func:`shard_over`
    list, else every local card when ``device`` is a card and there are
    two or more; ``None`` (no split) otherwise and under ``BFTKV_SHARD=off``.
    The list is rotated to start at ``device`` where it holds it, so shard
    0 runs on the caller's card and stream."""
    if flags.raw("BFTKV_SHARD", "auto") == "off":
        return None
    dev = devmod.resolve(device)
    with _shard_lock:
        over = _SHARD_OVER
    if over is not None:
        devs = list(over)
    elif dev.type != "cuda" or torch.cuda.device_count() < 2:
        return None
    else:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if dev in devs:
        first = devs.index(dev)
        devs = devs[first:] + devs[:first]
    return devs


def _shardable(padded: int, shards) -> bool:
    """The reference's rule: the padded batch must divide by the shard count."""
    return shards is not None and padded % len(shards) == 0


def _row_shards(dev: torch.device, padded: int) -> list:
    """The device of each contiguous row shard of a padded launch."""
    shards = shard_devices(dev)
    return shards if _shardable(padded, shards) else [dev]


@contextlib.contextmanager
def shard_scope(dev: torch.device, lane: int):
    """Shard ``lane``'s scope on ``dev``: the card made current, lane 0 on
    the caller's current stream of it, lane i > 0 on the thread's stream
    i of it."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev):
        if lane == 0:
            yield
        else:
            with torch.cuda.stream(devmod.stream(dev, lane)):
                yield


def _launch_shards(dev: torch.device, t: int, padded: int, lease_for, fill) -> list:
    """Launches a padded batch of ``t`` live rows as contiguous row shards
    (one, unless the batch splits): per shard, ``lease_for(rows, device)``
    gives its slot and ``fill(slot, lo, live, device)`` stages rows
    ``[lo, lo + live)`` and launches, inside the shard's scope.  Returns
    ``[(lease, live)]``; a launch error releases every slot."""
    shards = _row_shards(dev, padded)
    per = padded // len(shards)
    launches: list = []
    try:
        for lane, sdev in enumerate(shards):
            lo = lane * per
            live = max(0, min(t, lo + per) - lo)
            with shard_scope(sdev, lane):
                lease = lease_for(per, sdev)
                launches.append((lease, live))
                with lease.launch() as slot:
                    fill(slot, lo, live, sdev)
    except BaseException:
        for lease, _live in launches:
            lease.release()
        raise
    return launches


def _collect_all(launches, read) -> list:
    """``read(slot, live)`` of every shard in order, each slot released; the
    first error propagates after every slot is released."""
    out, err = [], None
    for lease, live in launches:
        try:
            out.append(lease.collect(lambda slot: read(slot, live)))
        except Exception as e:
            err = err or e
    if err is not None:
        raise err
    return out


def _pad_rows(t: int, floor: int) -> int:
    """Power-of-two buckets with a floor, as the reference pads."""
    return max(floor, 1 << (t - 1).bit_length())


def power_mod_rns(
    bases: list[int], exps: list[int], mods: list[int], *,
    n_bits: int = 1024, defer: bool = False, device=None,
):
    """Batched x^e mod m with per-row (x, e, m) — the CRT-signing
    workhorse.  Returns a list of ints, or None when any modulus cannot
    ride the RNS path (the caller falls back).

    ``defer=True`` returns a :class:`DeferredModexp`: the launch is on
    the current stream (each shard's on its own, where the batch splits),
    nothing has waited for it yet, and the staging slots stay in flight
    until ``wait()``.  An error of the build or a launch propagates, every
    slot released.
    """
    from bftkv_tpu_torch.ops import cuda_rns

    dev = devmod.resolve(device)
    if not mods:
        return []
    for e in exps:
        if e < 0 or e.bit_length() > n_bits:
            return None
    digits = max(32, (n_bits + 15) // 16)
    ctx = context(digits, n_bits)
    unique: dict[int, int] = {}
    urows: list = []
    idxs: list[int] = []
    for m in mods:
        u = unique.get(m)
        if u is None:
            r = ctx.key_rows(m)
            if r is None:
                return None
            u = unique[m] = len(urows)
            urows.append(r)
        idxs.append(u)
    t = len(idxs)
    # Power-of-two batch buckets (floor 64) and a unique-modulus axis with
    # floor 64, as the reference pads.  Only the t live rows are encoded;
    # the pad rows copy row 0 (pad base = row 0's, pad key index 0), as
    # the reference stages.
    padded = _pad_rows(t, 64)
    kpad = _pad_rows(len(urows), 64)
    nb = 2 * digits
    base_rows = bytes_rows([b % m for b, m in zip(bases, mods)], nb)
    eb = bytes_rows(exps, nb)
    nib = np.empty((t, 2 * nb), dtype=np.uint8)
    nib[:, 0::2] = eb & 0xF  # nibbles least significant first
    nib[:, 1::2] = eb >> 4
    nib = nib[:, ::-1]  # most-significant nibble first

    def fill(slot, lo, live, sdev):
        bh, nt, ix = slot["base_halves"], slot["nib_t"], slot["idx"]
        bh[:live] = base_rows[lo : lo + live]
        nt[:, :live] = nib[lo : lo + live].T
        ix[:live] = idxs[lo : lo + live]
        if len(ix) > live:
            bh[live:] = base_rows[0]
            nt[:, live:] = nib[0][:, None]
            ix[live:] = 0
        _stage_key_rows(slot, urows)
        d = slot.upload(("base_halves", "nib_t", "idx") + KEY_ROWS)
        slot.download("sigma", cuda_rns.pow_cuda(
            d["base_halves"], d["nib_t"], d["idx"], tuple(d[n] for n in KEY_ROWS),
            consts(digits, n_bits, sdev),
        ))

    launches = _launch_shards(
        dev, t, padded, lambda rows, sdev: _pow_staging(digits, n_bits, rows, kpad, sdev), fill)
    mods_live = list(mods)

    def finish() -> list[int]:
        sigma = np.concatenate(_collect_all(launches, lambda s, live: s["sigma"][:live].copy()))
        vals = _sigma_to_ints(ctx, sigma)
        return [v % m for v, m in zip(vals, mods_live)]

    if not defer:
        return finish()
    return DeferredModexp(finish, [l.slot.event for l, _ in launches if l.slot.event is not None])


def digits_to_halves(digits_u32: np.ndarray) -> np.ndarray:
    """(T, D) 16-bit digits → (T, 2D) interleaved 8-bit halves (f32)."""
    return digits_to_halves_u8(digits_u32).astype(np.float32)


def digits_to_halves_u8(digits_u32: np.ndarray) -> np.ndarray:
    """Same as :func:`digits_to_halves` but uint8 — the wire form."""
    t = digits_u32.shape[0]
    out = np.empty((t, 2 * digits_u32.shape[1]), dtype=np.uint8)
    out[:, 0::2] = (digits_u32 & 0xFF).astype(np.uint8)
    out[:, 1::2] = (digits_u32 >> 8).astype(np.uint8)
    return out


def verify_e65537_rns_indexed(
    sigs: list[int], ems: list[int], key_idx, unique_rows: list, *, device=None
) -> np.ndarray:
    """Batched RSA-2048 e=65537 verify → (T,) bool numpy verdicts.

    ``sigs``/``ems``: integers below 2^2048 (the caller keeps s < n);
    ``unique_rows``: :meth:`RNSContext.key_rows` of the *distinct* keys
    only; ``key_idx`` maps each item to its key row.  One launch of K1
    (one per shard where the batch splits): the rows are padded to a
    power of two (floor 256) with s = 0 against row 0's em and key —
    0^e never equals a PKCS#1 encoding — and the key axis to a floor of
    64 with copies of row 0; the gather happens on the device.
    """
    from bftkv_tpu_torch.ops import cuda_rns

    dev = devmod.resolve(device)
    t = len(sigs)
    idx = np.asarray(key_idx, dtype=np.int64)
    n_keys = len(unique_rows)
    if t == 0 or len(ems) != t or idx.shape != (t,) or (idx < 0).any() or (idx >= n_keys).any():
        raise ValueError("key_idx must map every row into the unique key rows")
    padded = _pad_rows(t, 256)
    kpad = _pad_rows(n_keys, 64)
    sig_rows = bytes_rows(sigs, 2 * DIGITS)
    em_rows = bytes_rows(ems, 2 * DIGITS)

    def fill(slot, lo, live, sdev):
        sh, eh, ix = slot["sig_halves"], slot["em_halves"], slot["idx"]
        sh[:live] = sig_rows[lo : lo + live]
        eh[:live] = em_rows[lo : lo + live]
        ix[:live] = idx[lo : lo + live]
        if len(ix) > live:
            sh[live:] = 0
            eh[live:] = em_rows[0]
            ix[live:] = 0
        _stage_key_rows(slot, unique_rows)
        d = slot.upload(("sig_halves", "em_halves", "idx") + KEY_ROWS)
        slot.download("ok", cuda_rns.verify_cuda(
            d["sig_halves"], d["em_halves"], d["idx"], tuple(d[n] for n in KEY_ROWS),
            consts(DIGITS, 2048, sdev),
        ))

    launches = _launch_shards(
        dev, t, padded, lambda rows, sdev: _verify_staging(rows, kpad, sdev), fill)
    return np.concatenate(_collect_all(launches, lambda s, live: s["ok"][:live] != 0))


def stack_key_rows(rows: list):
    """Stack per-key row tuples (from :meth:`RNSContext.key_rows`) into
    the batch arrays the verify and pow paths take.  The (T, 1) reshape
    of the scalar redundant-channel entries lives here and only here."""
    stack = lambda i: np.stack([np.asarray(r[i]) for r in rows])
    t = len(rows)
    return (
        stack(0),
        stack(1).reshape(t, 1),
        stack(2),
        stack(3),
        stack(4),
        stack(5).reshape(t, 1),
    )
