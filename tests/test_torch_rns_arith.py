"""K1's own word arithmetic (``csrc/rns_chain.cu``) and the digit
conversion K1 and K2 share (``csrc/rns_mma.cuh``), modelled in numpy.

The CUDA kernels cannot run here, so these tests hold numpy models of
what they do, in their thread layouts, against the plain versions in
``ops/rns.py`` — exactly:

- the α check: each thread's 4 (channel, slot) pairs of the mma C
  fragment, Δ by Barrett, channel 0's α per slot through shared memory,
  per-slot mismatch words over the channels j < k only, the α ≤ k+1 bound
  and the bad-key-index mask, against ``rns._verify_kernel``'s verdicts at
  k=188 on valid, forged, hostile-modulus and bad-index rows;
- Barrett of the check's products (< 2^24) for every prime of both
  contexts;
- the conversion, one thread per output channel summing 8 row slots,
  against ``rns._to_residues`` at k=94 and k=188.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from bftkv_tpu_torch.ops import limb, rns
from test_torch_k2_arith import barrett_model
from test_torch_utils import moduli

CONTEXTS = [(64, 1024), (128, 2048)]  # k = 94 and k = 188
SLOTS = 8


def _pairs(k: int):
    """Channel j and slot of every (warp, lane, pair p = 2h + cs) of a block:
    channels warp·16 + g + 8h, slots 2t + cs (lane = 4g + t)."""
    mt = (k + 1 + 15) // 16
    warp, lane, p = np.meshgrid(np.arange(mt), np.arange(32), np.arange(4), indexing="ij")
    g, t = lane >> 2, lane & 3
    return warp * 16 + g + 8 * (p >> 1), 2 * t + (p & 1)


def _consts(cn):
    k = cn.k
    p = cn.kern["p_all"].numpy().astype(np.uint64)
    mu = cn.kern["mu_all"].numpy().view(np.uint32).astype(np.uint64)
    return p[:k], p[k:], mu[:k], mu[k:]


# -- the alpha check ----------------------------------------------------------


def check_model(cn, v, em, ninv, idx, n_keys: int) -> np.ndarray:
    """K1's check for one block's 8 slots.  v, em: ((8, k) B, (8, k) B')
    residues; ninv: (8, 2k) the slots' key rows (index clamped to 0);
    idx: the slots' key indices.  Returns the 8 verdicts."""
    k = cn.k
    pb, pq, mub, muq = _consts(cn)
    j, slot = _pairs(k)
    chan = j < k
    x = np.where(chan, j, 0)
    one = lambda a: np.where(chan, a, 1).astype(np.uint64)
    p_b, p_q = one(pb[x]), one(pq[x])
    mu_b = np.where(chan, mub[x], 0xFFFFFFFF).astype(np.uint64)
    mu_q = np.where(chan, muq[x], 0xFFFFFFFF).astype(np.uint64)
    pick = lambda a: np.where(chan, a[slot, x], 0).astype(np.uint64)
    vb, vq, eb, eq = pick(v[0]), pick(v[1]), pick(em[0]), pick(em[1])
    nb, nq = pick(ninv[:, :k]), pick(ninv[:, k:])
    xb = np.where(vb >= eb, vb - eb, vb + p_b - eb)
    xq = np.where(vq >= eq, vq - eq, vq + p_q - eq)
    assert (xb * nb < 1 << 24).all() and (xq * nq < 1 << 24).all()
    db = barrett_model(xb * nb, p_b, mu_b)
    dq = barrett_model(xq * nq, p_q, mu_q)
    alpha0 = np.zeros(SLOTS, np.uint64)
    alpha0[slot[j == 0]] = db[j == 0]  # the thread holding channel 0
    assert (j == 0).sum() == SLOTS
    bad = np.zeros(SLOTS, bool)
    mism = chan & ((db != alpha0[slot]) | (dq != alpha0[slot]))
    np.logical_or.at(bad, slot[mism], True)
    in_range = (idx >= 0) & (idx < n_keys)
    return ~bad & (alpha0 <= k + 1) & in_range


def _key_rows_any(ctx, n: int):
    """Key rows for any odd n, 0 where n is not invertible mod a channel
    prime (a hostile modulus sharing a prime, which the entry points send
    to the host, still runs the same arithmetic in the kernel)."""
    chans = ctx.pb + ctx.pq
    inv = lambda a, p: pow(a, -1, p) if a % p else 0
    f = lambda xs: np.asarray(xs, dtype=np.float32)
    m2 = (ctx.M * ctx.M) % n
    return (f([n % p for p in chans]), np.float32(n % rns.PR),
            f([(-inv(n, p)) % p for p in ctx.pb]), f([inv(n, p) for p in chans]),
            f([m2 % p for p in chans]), np.float32(m2 % rns.PR))


def _chain_v(cn, s, key):
    """v = s^65537 mod N in RNS, as rns._verify_kernel forms it."""
    k = cn.k
    sm = rns._mont_mul(cn, s, (key[4][:, :k], key[4][:, k:], key[5]), key)
    acc = sm
    for _ in range(16):
        acc = rns._mont_mul(cn, acc, acc, key)
    acc = rns._mont_mul(cn, acc, sm, key)
    return rns._mont_mul(cn, acc, rns._ones_like(sm), key)


def test_alpha_check_in_the_fragment_layout_equals_the_plain_verdicts():
    ctx = rns.context()
    cn = rns.consts(rns.DIGITS, 2048, "cpu")
    ns = moduli(ctx, 2048, 2, seed=71)
    rng = random.Random(72)
    hostile = ctx.pb[0] * (rng.getrandbits(2036) | (1 << 2035) | 1)
    ns.append(hostile)
    ukey_np = rns.stack_key_rows([ctx.key_rows(n) for n in ns[:2]] + [_key_rows_any(ctx, hostile)])
    ukey = rns.key_rows_from_numpy(ukey_np, "cpu")
    n_keys = len(ns)
    rows = []  # (sig, em, idx)
    for i in range(11):
        key = i % 3
        n = ns[key]
        s = rng.randrange(n)
        em = pow(s, 65537, n)
        if i in (1, 6):
            s ^= 1 << rng.randrange(2040)  # forged: one bit flipped
        rows.append((s, em, key))
    s0 = rng.randrange(ns[0])
    rows.append((s0, pow(s0, 65537, ns[0]), n_keys))  # bad index, valid under key 0
    rows.append((s0, pow(s0, 65537, ns[0]), -1))
    t = len(rows)
    halves = lambda xs: torch.as_tensor(
        rns.digits_to_halves_u8(np.stack([limb.int_to_limbs(x, rns.DIGITS) for x in xs])))
    sh, eh = halves([r[0] for r in rows]), halves([r[1] for r in rows])
    idx = np.asarray([r[2] for r in rows], np.int32)
    kid = torch.as_tensor(np.where((idx >= 0) & (idx < n_keys), idx, 0))
    key = rns.gather_key(ukey, kid)
    plain = rns._verify_kernel(cn, sh, eh, key).numpy()
    want = plain & (idx >= 0) & (idx < n_keys)
    assert plain[-2:].all() and not want[-2:].any()  # the mask decides the bad rows
    assert want[[0, 3, 9]].all() and not want[[1, 6]].any()
    assert not want[[2, 5, 8]].all()  # the hostile modulus fails somewhere

    v = [x.numpy() for x in _chain_v(cn, rns._to_residues(cn, sh), key)]
    em = [x.numpy() for x in rns._to_residues(cn, eh)]
    ninv = key[3].numpy()
    got = np.zeros(t, bool)
    for row0 in range(0, t, SLOTS):
        r = np.minimum(row0 + np.arange(SLOTS), t - 1)  # clamped slots past T
        out = check_model(cn, (v[0][r], v[1][r]), (em[0][r], em[1][r]), ninv[r], idx[r], n_keys)
        live = row0 + np.arange(SLOTS) < t
        got[row0 + np.arange(SLOTS)[live]] = out[live]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("digits,n_bits", CONTEXTS)
def test_barrett_of_the_check_products_is_exact_for_every_prime(digits, n_bits):
    cn = rns.consts(digits, n_bits, "cpu")
    pb, pq, mub, muq = _consts(cn)
    rng = np.random.default_rng(n_bits + 5)
    for p, mu in ((pb, mub), (pq, muq)):
        p, mu = p[:, None], mu[:, None]
        a = rng.integers(0, p, (p.shape[0], 3000), dtype=np.uint64)
        w = rng.integers(0, p, (p.shape[0], 3000), dtype=np.uint64)
        edge = np.concatenate([np.zeros_like(p), p - 1, np.ones_like(p)], axis=1)
        a, w = np.concatenate([a, edge, p - 1], axis=1), np.concatenate([w, p - 1, edge], axis=1)
        x = a * w
        assert x.max() < 1 << 24
        np.testing.assert_array_equal(barrett_model(x, p, mu), x % p)


# -- the digit conversion -----------------------------------------------------


def conversion_model(cn, h: np.ndarray, row0: int, rows_per_block: int):
    """The shared to_residues for one block: slot s runs row row0 + s % R
    (clamped); thread ch sums Σ_d halves[d][s]·D[d][ch] for all 8 slots in
    uint32, then reduces (Barrett, or mod 2^12 at ch = 2k); each thread
    reads its pairs back.  Returns per slot (B (8, k), B' (8, k), 2^12 (8,))."""
    k, t = cn.k, h.shape[0]
    rows = np.minimum(row0 + np.arange(SLOTS) % rows_per_block, t - 1)
    halves = h[rows].astype(np.uint64)                 # (8, nd)
    D = cn.Df.numpy().astype(np.uint64)                # (nd, 2k+1)
    acc = halves @ D                                   # (8, 2k+1)
    assert acc.max() < 1 << 32
    p = cn.kern["p_all"].numpy().astype(np.uint64)
    mu = cn.kern["mu_all"].numpy().view(np.uint32).astype(np.uint64)
    res = np.empty_like(acc)
    res[:, : 2 * k] = barrett_model(acc[:, : 2 * k], p, mu)
    res[:, 2 * k] = acc[:, 2 * k] & 4095
    j, slot = _pairs(k)
    chan = j < k
    xb = np.where(chan, res[slot, np.where(chan, j, 0)], 0)
    xq = np.where(chan, res[slot, k + np.where(chan, j, 0)], 0)
    out_b = np.full((SLOTS, k), -1, np.int64)
    out_q = np.full((SLOTS, k), -1, np.int64)
    out_b[slot[chan], j[chan]] = xb[chan]
    out_q[slot[chan], j[chan]] = xq[chan]
    return out_b, out_q, res[:, 2 * k].astype(np.int64), rows


@pytest.mark.parametrize("digits,n_bits", CONTEXTS)
@pytest.mark.parametrize("rows_per_block,t", [(8, 13), (4, 6)], ids=["K1", "K2"])
@pytest.mark.parametrize("fill", ["random", "all_255"])
def test_channel_per_thread_conversion_equals_to_residues(digits, n_bits, rows_per_block, t, fill):
    cn = rns.consts(digits, n_bits, "cpu")
    rng = np.random.default_rng(digits + t)
    h = (rng.integers(0, 256, (t, 2 * digits)) if fill == "random"
         else np.full((t, 2 * digits), 255)).astype(np.uint8)
    want_b, want_q, want_r = (x.numpy() for x in rns._to_residues(cn, torch.as_tensor(h)))
    for row0 in range(0, t, rows_per_block):
        b, q, r, rows = conversion_model(cn, h, row0, rows_per_block)
        assert (b >= 0).all() and (q >= 0).all()  # every slot's channels are read out
        np.testing.assert_array_equal(b, want_b[rows])
        np.testing.assert_array_equal(q, want_q[rows])
        np.testing.assert_array_equal(r, want_r[rows, 0])
