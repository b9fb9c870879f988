"""K2's word arithmetic (``csrc/rns_pow.cu``), modelled in numpy.

The CUDA kernel cannot run here, so these tests hold the host-side
constants and layouts it reads, and a numpy model of the arithmetic it
does on them, against plain integer math — exactly, at the two contexts
of the main path (k=94: 1024-bit CRT halves, k=188: 2048-bit moduli):

- Barrett with μ_p = ⌊2^32/p⌋ and Shoup with w′ = ⌊w·2^32/p⌋, as written
  in the kernel (32-bit wraparound, one conditional subtraction);
- the int8 6-bit planes of E1/E2 in mma fragment order, unpacked;
- one base extension through the tensor-core fragments of
  ``mma.m16n8k32.row.col.s32.s8.s8.s32`` (PTX's fragment layouts, written
  here independently of the packing), the three Karatsuba plane products
  and the uint32 recombination, against ``rns._dot``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bftkv_tpu_torch.ops import rns

CONTEXTS = [(64, 1024), (128, 2048)]  # k = 94 and k = 188
M32 = np.uint64(0xFFFFFFFF)


def _cn(digits, n_bits):
    return rns.consts(digits, n_bits, "cpu")


def _u32(t) -> np.ndarray:
    return t.numpy().view(np.uint32).astype(np.uint64)


def barrett_model(x, p, mu):
    """The kernel's barrett(): r = x − umulhi(x, μ)·p mod 2^32, one fix."""
    q = (x * mu) >> np.uint64(32)
    r = (x - q * p) & M32
    assert (r < 2 * p).all()
    return np.where(r >= p, r - p, r)


def shoup_model(a, w, w_sh, p):
    """The kernel's shoup(): r = a·w − umulhi(a, w′)·p mod 2^32, one fix."""
    q = (a * w_sh) >> np.uint64(32)
    r = ((a * w) - q * p) & M32
    assert (r < 2 * p).all()
    return np.where(r >= p, r - p, r)


def _edges(p: np.ndarray, rng, n_random: int) -> np.ndarray:
    """Per prime (rows): random x < 2^32 and the edges 0, p−1, multiples
    of p (including the largest below 2^32), 2^32 − 1."""
    p = p[:, None]
    top = (np.uint64(1 << 32) - 1) // p * p
    cols = [np.zeros_like(p), p - 1, p, 2 * p, 4095 * p, top, top - 1, top + p - 1,
            np.full_like(p, (1 << 32) - 1)]
    rand = rng.integers(0, 1 << 32, (p.shape[0], n_random), dtype=np.uint64)
    return np.concatenate([np.broadcast_to(c, (p.shape[0], 1)) for c in cols] + [rand], axis=1)


@pytest.mark.parametrize("digits,n_bits", CONTEXTS)
def test_barrett_with_mu_is_exact_for_every_prime(digits, n_bits):
    cn = _cn(digits, n_bits)
    p = cn.kern["p_all"].numpy().astype(np.uint64)
    mu = _u32(cn.kern["mu_all"])
    np.testing.assert_array_equal(mu, (np.uint64(1) << np.uint64(32)) // p)
    x = _edges(p, np.random.default_rng(digits), 2000)
    np.testing.assert_array_equal(barrett_model(x, p[:, None], mu[:, None]), x % p[:, None])


def test_barrett_on_an_inert_channel_gives_zero():
    # Channels without a prime hold p = 1 and μ = 2^32 − 1.
    x = np.array([0, 1, 2, 4095, (1 << 24) - 1, (1 << 32) - 1], dtype=np.uint64)
    np.testing.assert_array_equal(barrett_model(x, np.uint64(1), M32), 0)
    np.testing.assert_array_equal(shoup_model(x, np.uint64(0), np.uint64(0), np.uint64(1)), 0)


@pytest.mark.parametrize("digits,n_bits", CONTEXTS)
def test_shoup_with_w_prime_is_exact_for_every_fixed_multiplier(digits, n_bits):
    cn = _cn(digits, n_bits)
    k = cn.k
    p = cn.kern["p_all"].numpy().astype(np.uint64)
    rng = np.random.default_rng(n_bits)
    for name, ps in (("invMi_b", p[:k]), ("Mq_mod_b", p[:k]), ("invM_q", p[k:])):
        w = cn.kern[name].numpy().astype(np.uint64)
        w_sh = _u32(cn.kern[name + "_sh"])
        np.testing.assert_array_equal(w_sh, (w << np.uint64(32)) // ps, err_msg=name)
        a = _edges(ps, rng, 500)  # includes the largest a, 2^32 − 1
        got = shoup_model(a, w[:, None], w_sh[:, None], ps[:, None])
        np.testing.assert_array_equal(got, (a * w[:, None]) % ps[:, None], err_msg=name)
    # The product folds M^-1 and (M'/m_j)^-1 over B' into one multiplier,
    # derived at the start as Barrett of the product and w' = floor(w 2^32/p).
    mu = _u32(cn.kern["mu_all"])[k:]
    w = barrett_model(cn.kern["invM_q"].numpy().astype(np.uint64)
                      * cn.kern["invMi_q"].numpy().astype(np.uint64), p[k:], mu)
    w_sh = (w << np.uint64(32)) // p[k:]
    a = _edges(p[k:], rng, 500)
    np.testing.assert_array_equal(shoup_model(a, w[:, None], w_sh[:, None], p[k:, None]),
                                  (a * w[:, None]) % p[k:, None])


@pytest.mark.parametrize("digits,n_bits", CONTEXTS)
def test_shoup_with_the_per_row_key_constants_is_exact(digits, n_bits):
    """The kernel derives its key multipliers once per row — −N⁻¹·(M/m_j)⁻¹
    over B (Barrett of the product) and N over B′ — and their w′ as
    ⌊w·2^32/p⌋; the products it reduces are < 2^24."""
    ctx = rns.context(digits, n_bits)
    k = ctx.k
    p = np.asarray(ctx.p_all, dtype=np.uint64)
    rng = np.random.default_rng(7)
    found = 0
    while found < 3:
        n = int.from_bytes(rng.bytes(n_bits // 8), "big") | 1 | (1 << (n_bits - 1))
        rows = ctx.key_rows(n)
        if rows is None:
            continue
        found += 1
        mu = (np.uint64(1) << np.uint64(32)) // p[:k]
        invmi_b = np.asarray(ctx.invMi_b, dtype=np.float64).astype(np.uint64)
        qsig = barrett_model(np.asarray(rows[2], np.uint64) * invmi_b, p[:k], mu)
        for w, ps in ((qsig, p[:k]), (np.asarray(rows[0], np.uint64)[k:], p[k:])):
            w_sh = (w << np.uint64(32)) // ps
            a = _edges(ps, rng, 200)
            np.testing.assert_array_equal(shoup_model(a, w[:, None], w_sh[:, None], ps[:, None]),
                                          (a * w[:, None]) % ps[:, None])


def _unpack_a(plane: np.ndarray) -> np.ndarray:
    """One int8 plane in fragment order (mt, ks, 32 lanes, 16 bytes) →
    the (16·mt, 32·ks) A matrix, by PTX's A layout (see mma_m16n8k32)."""
    mt, ks = plane.shape[:2]
    a = np.zeros((16 * mt, 32 * ks), np.int64)
    for lane in range(32):
        grp, tid = lane >> 2, lane & 3
        for r in range(4):
            rows = np.arange(mt)[:, None] * 16 + grp + 8 * (r & 1)
            cols = np.arange(ks)[None, :] * 32 + 4 * tid + 16 * (r >> 1)
            for b in range(4):
                a[rows, cols + b] = plane[:, :, lane, 4 * r + b]
    return a


@pytest.mark.parametrize("digits,n_bits", CONTEXTS)
def test_mma_planes_unpack_to_the_extension_matrices(digits, n_bits):
    cn = _cn(digits, n_bits)
    k = cn.k
    planes = cn.kern["E_mma"].numpy()
    m_pad, k_pad = rns.mma_dims(k)
    assert planes.shape == (2, 2, m_pad // 16, k_pad // 32, 32, 16)
    assert planes.dtype == np.int8 and planes.min() >= 0 and planes.max() < 64
    for e, E in enumerate((cn.E1f, cn.E2f)):
        a = _unpack_a(planes[e, 0]) + 64 * _unpack_a(planes[e, 1])
        assert a.shape == (m_pad, k_pad)
        np.testing.assert_array_equal(a[: k + 1, :k].T, E.numpy().astype(np.int64))
        assert not a[k + 1 :].any() and not a[:, k:].any()  # padding is zero


# -- one extension through the mma fragments ----------------------------------


def _bytes_of(words: np.ndarray) -> np.ndarray:
    """uint32 words (..., n) → their 4 bytes each as signed int8, lowest first."""
    return words.astype("<u4").view(np.int8).reshape(*words.shape[:-1], -1, 4)


def mma_m16n8k32(a_regs: np.ndarray, b_regs: np.ndarray, c: np.ndarray) -> np.ndarray:
    """One warp's mma.m16n8k32.row.col.s32.s8.s8.s32 from its fragments:
    a_regs (32 lanes, 4) and b_regs (32, 2) uint32, c (32, 4) int32.  The
    layouts are PTX's: lane = 4·group + tid; A element i of register i//4
    sits at row group (+8 for registers 1, 3) and column 4·tid + i%4 (+16
    for registers 2, 3); B register r holds rows 4·tid + i%4 (+16 for r = 1)
    of column group; C element i sits at row group (+8 for i ≥ 2), column
    2·tid + i%2."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    ab, bb = _bytes_of(a_regs), _bytes_of(b_regs)
    for lane in range(32):
        grp, tid = lane >> 2, lane & 3
        for r in range(4):
            A[grp + 8 * (r & 1), 4 * tid + 16 * (r >> 1) : 4 * tid + 16 * (r >> 1) + 4] = ab[lane, r]
        for r in range(2):
            B[4 * tid + 16 * r : 4 * tid + 16 * r + 4, grp] = bb[lane, r]
    D = A @ B
    out = c.astype(np.int64).copy()
    for lane in range(32):
        grp, tid = lane >> 2, lane & 3
        for i in range(4):
            out[lane, i] += D[grp + 8 * (i >> 1), 2 * tid + (i & 1)]
    return out.astype(np.int32)


def extend_model(planes: np.ndarray, e: int, sigma: np.ndarray, k: int) -> np.ndarray:
    """The kernel's extend(e) for 8 row slots: σ (8, k) < 2^12 → S (8, k+1)
    uint32, through the fragments, three Karatsuba products and S = ll +
    ((ss − ll − hh) << 6) + (hh << 12) mod 2^32."""
    m_pad, k_pad = rns.mma_dims(k)
    # sigma's int8 planes [slot][i] as the kernel's put_sigma writes them.
    sig = np.zeros((2, 8, k_pad), np.uint8)
    sig[0, :, :k] = sigma & 63
    sig[1, :, :k] = sigma >> 6
    sig_w = sig.view("<u4")  # (2, 8, k_pad / 4) words
    a_w = planes.view("<u4")  # (2, 2, mt, ks, 32, 4)
    S = np.zeros((8, m_pad), np.uint64)
    lanes = np.arange(32)
    grp, tid = lanes >> 2, lanes & 3
    for mt in range(m_pad // 16):
        acc = {n: np.zeros((32, 4), np.int32) for n in ("ll", "ss", "hh")}
        for ks in range(k_pad // 32):
            b = [np.stack([sig_w[pl, grp, ks * 8 + tid], sig_w[pl, grp, ks * 8 + 4 + tid]], 1)
                 for pl in (0, 1)]
            al, ah = a_w[e, 0, mt, ks], a_w[e, 1, mt, ks]
            add = lambda x, y: ((x.astype(np.uint64) + y) & M32).astype(np.uint32)
            acc["ll"] = mma_m16n8k32(al, b[0], acc["ll"])
            acc["hh"] = mma_m16n8k32(ah, b[1], acc["hh"])
            acc["ss"] = mma_m16n8k32(add(al, ah), add(b[0], b[1]), acc["ss"])
        ll, ss, hh = (acc[n].astype(np.int64) & 0xFFFFFFFF for n in ("ll", "ss", "hh"))
        s = (ll + (((ss - ll - hh) & 0xFFFFFFFF) << 6) + (hh << 12)) & 0xFFFFFFFF
        for i in range(4):
            S[2 * tid + (i & 1), mt * 16 + grp + 8 * (i >> 1)] = s[:, i]
    return S[:, : k + 1]


@pytest.mark.parametrize("digits,n_bits", CONTEXTS)
@pytest.mark.parametrize("worst", [False, True], ids=["random", "p_minus_1"])
def test_extension_through_int8_fragments_equals_the_plain_dot(digits, n_bits, worst):
    cn = _cn(digits, n_bits)
    k = cn.k
    planes = cn.kern["E_mma"].numpy()
    rng = np.random.default_rng(digits + worst)
    for e, (ps, E) in enumerate(((cn.pb, cn.E1f), (cn.pq, cn.E2f))):
        p = ps.numpy()
        sigma = np.broadcast_to(p - 1, (8, k)) if worst else rng.integers(0, p, (8, k))
        sigma = np.ascontiguousarray(sigma, dtype=np.int64)
        want = rns._dot(torch.as_tensor(sigma), E).numpy()
        assert want.max() < 1 << 32
        np.testing.assert_array_equal(extend_model(planes, e, sigma, k), want)
