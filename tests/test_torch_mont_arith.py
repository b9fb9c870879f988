"""A model of K3's per-lane arithmetic (``ops/csrc/mont_chain.cu``), in numpy.

K3 splits each row's Montgomery products across a group of TPI lanes of one
warp, each lane owning W = 64 / TPI consecutive 32-bit words.  The CUDA
kernel cannot run here, so this file models it step for step in the same
layout: the lanes' local multiply-add chains, lane 0's m broadcast, the
one-word shift by shuffle, the pending carries, the ballot carry and borrow
scans and the masked final subtraction.  The model runs the whole chain and
is held against the plain version (``ops/rsa.py::_verify_chain``) and host
``pow`` at full width, on rows that stress the carries; it asserts the
bounds the kernel's head comment proves at every step.

Arrays are ``(rows, TPI, W)`` uint64 holding 32-bit words (``[..., l, k]``
is word ``l*W + k``), or ``(rows, TPI)`` for one value per lane.
"""

from __future__ import annotations

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bftkv_tpu_torch.ops import bigint, cuda_mont, limb
from bftkv_tpu_torch.ops import rsa as rsa_ops

TPI = cuda_mont.THREADS_PER_ROW
W = 64 // TPI
M32 = np.uint64(0xFFFFFFFF)
R_BITS = 2048
H_BOUND = 1 << 33  # the pending carry's bound (mont_chain.cu's head comment)

SRC = Path(__file__).resolve().parents[1] / "bftkv_tpu_torch" / "ops" / "csrc" / "mont_chain.cu"


# -- the model -----------------------------------------------------------------


def to_lanes(xs: list[int]) -> np.ndarray:
    """Integers < 2^2048 → ``(rows, TPI, W)`` words."""
    words = [[(x >> (32 * j)) & 0xFFFFFFFF for j in range(64)] for x in xs]
    return np.asarray(words, dtype=np.uint64).reshape(len(xs), TPI, W)


def from_lanes(t: np.ndarray) -> list[int]:
    flat = t.reshape(t.shape[0], -1)
    return [sum(int(w) << (32 * j) for j, w in enumerate(row)) for row in flat]


def digits_to_lanes(d: np.ndarray) -> np.ndarray:
    """``load_words``: (rows, 128) 16-bit digits → lane words."""
    d = d.astype(np.uint64) & np.uint64(0xFFFF)
    return (d[:, 0::2] | (d[:, 1::2] << np.uint64(16))).reshape(d.shape[0], TPI, W)


def ballot_scan(g: np.ndarray, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``scan``: per-lane generate/propagate flags (rows, tpi) → carry into
    each lane (rows, tpi) and out of the top lane (rows,), from two ballots
    and one add."""
    tpi = g.shape[1]
    assert not (g & p).any(), "generate and propagate are exclusive"
    bit = np.uint64(1) << np.arange(tpi, dtype=np.uint64)
    G = (g.astype(np.uint64) * bit).sum(axis=1)
    P = (p.astype(np.uint64) * bit).sum(axis=1)
    s = (G | P) + G
    cin = ((s ^ P)[:, None] >> np.arange(tpi, dtype=np.uint64)) & np.uint64(1)
    return cin, s >> np.uint64(tpi)


def _add_word(t: np.ndarray, c: np.ndarray, k: int) -> np.ndarray:
    """t[..., k] += c (c < 2^34); returns the carry out of word k."""
    q = t[..., k] + c
    t[..., k] = q & M32
    return q >> np.uint64(32)


def resolve(t: np.ndarray, h: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pending carries h (at each lane's top word) → canonical words and the
    bits above word 63 (``mont_mul``'s resolve step)."""
    t = t.copy()
    g = _add_word(t, h, W - 1)  # <= 2
    assert (g <= 2).all()
    c = np.zeros_like(g)
    c[:, 1:] = g[:, :-1]  # __shfl_up_sync by one; lane 0 takes 0
    g_top = g[:, -1]
    for k in range(W):
        c = _add_word(t, c, k)
    assert (c <= 1).all()
    ones = (t == M32).all(axis=2)
    cin, cout = ballot_scan(c == 1, ones)
    for k in range(W):
        cin = _add_word(t, cin, k)
    return t, g_top + cout


def cond_sub(t: np.ndarray, hi: np.ndarray, n: np.ndarray) -> np.ndarray:
    """t - n where t (+ hi * 2^2048) >= n, else t: borrows by the ballot scan,
    the mask applied with no branch."""
    d = np.empty_like(t)
    bo = np.zeros(t.shape[:2], dtype=np.uint64)
    for k in range(W):
        x = t[..., k] - n[..., k] - bo  # wraps mod 2^64, as the kernel's uint64
        d[..., k] = x & M32
        bo = x >> np.uint64(63)
    zero = (d == 0).all(axis=2)
    bin_, bout = ballot_scan(bo == 1, zero)
    for k in range(W):
        x = d[..., k] - bin_
        d[..., k] = x & M32
        bin_ = x >> np.uint64(63)
    need = (hi != 0) | (bout == 0)
    mask = np.where(need, M32, np.uint64(0))[:, None, None]
    return (d & mask) | (t & ~mask & M32)


def mont_mul(a, b, n, n0p, stats: dict | None = None) -> np.ndarray:
    """a * b * 2^-2048 mod n by the kernel's CIOS across the group."""
    rows = a.shape[0]
    t = np.zeros_like(a)
    h = np.zeros((rows, TPI), dtype=np.uint64)
    h_max = 0
    for src in range(TPI):
        for kk in range(W):
            bi = b[:, src, kk][:, None]  # __shfl_sync from lane src
            c = np.zeros_like(h)
            for k in range(W):  # t += a * b_i, local chain
                assert (c <= M32).all()  # so a*b + t + c <= 2^64 - 1
                p = a[..., k] * bi + t[..., k] + c
                t[..., k] = p & M32
                c = p >> np.uint64(32)
            c = c + _add_word(t, h, W - 1)  # fold the pending carry
            m = (t[:, 0, 0] * n0p) & M32  # lane 0's exact low word
            c2 = np.zeros_like(h)
            for k in range(W):  # t += m * n
                p = m[:, None] * n[..., k] + t[..., k] + c2
                t[..., k] = p & M32
                c2 = p >> np.uint64(32)
            assert (t[:, 0, 0] == 0).all()
            nxt = np.zeros_like(h)
            nxt[:, :-1] = t[:, 1:, 0]  # __shfl_down_sync by one; top lane 0
            t = np.concatenate([t[..., 1:], nxt[..., None]], axis=2)
            h = c + c2
            h_max = max(h_max, int(h.max()))
            assert h_max <= H_BOUND
    if stats is not None:
        stats["h_max"] = max(stats.get("h_max", 0), h_max)
    t, hi = resolve(t, h)
    assert (hi <= 1).all()
    return cond_sub(t, hi, n)


def chain(sig, em, n, nprime, r2, stats: dict | None = None) -> np.ndarray:
    """``mont_verify_kernel`` on (rows, 128) digit arrays → the (rows, 128)
    diff."""
    nn = digits_to_lanes(n)
    n0 = (nprime[:, 0].astype(np.uint64) & np.uint64(0xFFFF)) | (
        (nprime[:, 1].astype(np.uint64) & np.uint64(0xFFFF)) << np.uint64(16))
    sm = digits_to_lanes(r2)
    acc = digits_to_lanes(sig)
    one = np.zeros_like(acc)
    one[:, 0, 0] = 1
    for p in range(19):
        b = sm if p in (0, 17) else (one if p == 18 else acc)
        acc = mont_mul(acc, b, nn, n0, stats)
        if p == 0:
            sm = acc
    words = acc.reshape(acc.shape[0], 64)
    digits = np.stack([words & np.uint64(0xFFFF), words >> np.uint64(16)], axis=2)
    return digits.reshape(-1, 128).astype(np.int64) ^ em.astype(np.int64)


# -- cases -----------------------------------------------------------------------

SPECIAL_N = {
    "2^2048-1": (1 << 2048) - 1,
    "2^2047+1": (1 << 2047) + 1,
    "random": random.Random(5).getrandbits(2048) | 1 | (1 << 2047),
}
R = 1 << R_BITS


def _n0p(ns: list[int]) -> np.ndarray:
    return np.asarray([(-pow(n, -1, 1 << 32)) % (1 << 32) for n in ns], dtype=np.uint64)


def _mm(a: list[int], b: list[int], ns: list[int], stats=None) -> list[int]:
    return from_lanes(mont_mul(to_lanes(a), to_lanes(b), to_lanes(ns), _n0p(ns), stats))


def _host_mm(a: int, b: int, n: int) -> int:
    return a * b * pow(R, -1, n) % n


def _operands(rows: list[tuple[int, int, int]]):
    """[(s, em, n)] → the five (rows, 128) digit arrays K3 takes, as the
    domains build them (``bigint.MontgomeryDomain``)."""
    doms = {n: bigint.MontgomeryDomain(n, 128) for _s, _e, n in rows}
    return (
        np.stack([limb.int_to_limbs(s, 128) for s, _e, _n in rows]),
        np.stack([limb.int_to_limbs(e, 128) for _s, e, _n in rows]),
        *(np.stack([getattr(doms[n], f) for _s, _e, n in rows]) for f in ("n", "n_prime", "r2")),
    )


def adversarial_rows(seed: int) -> list[tuple[int, int, int]]:
    """(s, em, n) rows that stress the carries: the extreme moduli, s = n - 1,
    s with s*R mod n = n - 1 (so the first squaring has a = b = n - 1), s
    with all-ones words, s = 0, s >= n, and a valid and a forged random row
    per modulus."""
    rng = random.Random(seed)
    rows = []
    for n in SPECIAL_N.values():
        all_ones = int("F" * 256, 16) % n
        for s in (n - 1, (-pow(R, -1, n)) % n, all_ones, 0, rng.randrange(n)):
            rows.append((s, pow(s, 65537, n), n))
        rows.append((rng.randrange(n), rng.randrange(n), n))  # forged
    return rows


# -- tests -------------------------------------------------------------------------


def test_the_model_runs_the_kernels_layout():
    """TPI and the rows per block are the kernel's, as its source sets them."""
    src = SRC.read_text()
    tpi = int(re.search(r"constexpr int kTpi = (\d+);", src).group(1))
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert (tpi, threads // tpi) == (cuda_mont.THREADS_PER_ROW, cuda_mont.ROWS_PER_BLOCK)
    assert 64 % tpi == 0 and W >= 2 and cuda_mont.TILE % cuda_mont.ROWS_PER_BLOCK == 0


def test_lane_layout_round_trips():
    xs = [random.Random(1).getrandbits(2048) for _ in range(3)]
    assert from_lanes(to_lanes(xs)) == xs
    d = np.stack([limb.int_to_limbs(x, 128) for x in xs])
    np.testing.assert_array_equal(digits_to_lanes(d), to_lanes(xs))


@pytest.mark.parametrize("name", list(SPECIAL_N))
@pytest.mark.parametrize("case", ["n-1 squared", "all-ones", "zero", "a >= n", "one", "random"])
def test_mont_mul_model_matches_host(name, case):
    n = SPECIAL_N[name]
    rng = random.Random(f"{name}/{case}")
    a, b = {
        "n-1 squared": (n - 1, n - 1),
        "all-ones": (int("F" * 256, 16) % n, int("F" * 256, 16) % n),
        "zero": (0, rng.randrange(n)),
        "a >= n": (R - 1, n - 1),  # the first product's a is s, which may be >= n
        "one": (n - 1, 1),
        "random": (rng.randrange(n), rng.randrange(n)),
    }[case]
    assert _mm([a], [b], [n]) == [_host_mm(a, b, n)]


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(st.data())
def test_pending_carry_stays_within_its_bound(data):
    """The property the kernel's head comment proves: every pending carry
    h <= 2^33 and every chain carry < 2^32 (the model asserts both at every
    step), and the product is right."""
    n = data.draw(st.sampled_from(list(SPECIAL_N.values()))
                  | st.integers(1 << 2047, R - 1).map(lambda x: x | 1))
    a = data.draw(st.integers(0, R - 1) | st.just(n - 1))
    b = data.draw(st.integers(0, n - 1) | st.just(n - 1))
    stats = {}
    assert _mm([a], [b], [n], stats) == [_host_mm(a, b, n)]
    assert stats["h_max"] <= H_BOUND


def test_pending_carry_bound_is_nearly_reached():
    """At a = b = n - 1 = 2^2048 - 2 the pending carries run close to 2^33,
    so the bound is not slack by more than a factor of two."""
    n = (1 << 2048) - 1
    stats = {}
    assert _mm([n - 1], [n - 1], [n], stats) == [_host_mm(n - 1, n - 1, n)]
    assert H_BOUND // 2 < stats["h_max"] <= H_BOUND


def _state(words_per_lane: list[list[int]], h: list[int]):
    t = np.asarray([words_per_lane], dtype=np.uint64)
    return t, np.asarray([h], dtype=np.uint64)


def _value(t: np.ndarray, h: np.ndarray) -> int:
    v = from_lanes(t)[0]
    return v + sum(int(x) << (32 * (l * W + W - 1)) for l, x in enumerate(h[0]))


@pytest.mark.parametrize("case", ["carry across every lane", "top excess", "h at bound",
                                  "no carry", "random"])
def test_resolve_gives_the_value(case):
    ones = [0xFFFFFFFF] * W
    rng = random.Random(3)
    t, h = {
        # lane 0's pending carry ripples through every all-ones lane
        "carry across every lane": _state([ones] * TPI, [1] + [0] * (TPI - 1)),
        "top excess": _state([ones] * TPI, [0] * (TPI - 1) + [H_BOUND]),
        "h at bound": _state([ones] * TPI, [H_BOUND] * TPI),
        "no carry": _state([[0] * W] * TPI, [0] * TPI),
        "random": _state([[rng.getrandbits(32) for _ in range(W)] for _ in range(TPI)],
                         [rng.randrange(H_BOUND + 1) for _ in range(TPI)]),
    }[case]
    v = _value(t, h)
    got, hi = resolve(t, h)
    assert from_lanes(got)[0] + (int(hi[0]) << 2048) == v
    if case == "carry across every lane":
        # every word from lane 0's top up wrapped to 0, and bit 2048 is set
        assert from_lanes(got)[0] == (1 << (32 * (W - 1))) - 1 and hi[0] == 1


@pytest.mark.parametrize("case", ["t = n", "t = n - 1", "t = n + 1",
                                  "borrow across every lane", "hi set", "t = 0"])
def test_cond_sub_gives_t_mod_n(case):
    n = SPECIAL_N["random"]
    t, hi = {
        "t = n": (n, 0),  # every lane propagates a zero borrow
        "t = n - 1": (n - 1, 0),
        "t = n + 1": (n + 1, 0),
        # low word 0, below n's; every other word equal to n's: the borrow
        # crosses every lane boundary and t < n
        "borrow across every lane": (n - (n & 0xFFFFFFFF), 0),
        "hi set": (2 * n - R - 1, 1),  # t = 2n - 1 with bit 2048 set
        "t = 0": (0, 0),
    }[case]
    v = t + (hi << 2048)
    assert 0 <= v < 2 * n
    got = cond_sub(to_lanes([t % R]), np.asarray([hi], dtype=np.uint64), to_lanes([n]))
    assert from_lanes(got) == [v % n]


@pytest.mark.parametrize("tpi", [4, 8])
def test_ballot_scan_matches_a_ripple_on_every_pattern(tpi):
    """Every generate/propagate/kill pattern of ``tpi`` lanes."""
    pats = np.stack(np.meshgrid(*[np.arange(3)] * tpi, indexing="ij"), -1).reshape(-1, tpi)
    g, p = pats == 1, pats == 2
    cin, cout = ballot_scan(g, p)
    want = np.zeros(pats.shape, dtype=np.uint64)
    c = np.zeros(len(pats), dtype=bool)
    for lane in range(tpi):
        want[:, lane] = c
        c = g[:, lane] | (p[:, lane] & c)
    np.testing.assert_array_equal(cin, want)
    np.testing.assert_array_equal(cout, c)


@pytest.fixture(scope="module")
def chain_case():
    rows = adversarial_rows(seed=11)
    rng = random.Random(12)
    n = SPECIAL_N["random"]
    rows.append((rng.randrange(n, R), rng.randrange(n), n))  # s >= n, raw
    rows.append((0, rng.randrange(n), n))  # s >= n as assemble passes it
    ops = _operands(rows)
    return rows, ops, chain(*ops)


def test_chain_model_matches_the_plain_version(chain_case):
    _rows, ops, diff = chain_case
    plain = rsa_ops._verify_chain(*(torch.as_tensor(a.astype(np.int64)) for a in ops))
    np.testing.assert_array_equal(diff, plain.numpy())


def test_chain_model_verdicts_match_host_pow(chain_case):
    rows, _ops, diff = chain_case
    got = (diff == 0).all(axis=1).tolist()
    assert got == [pow(s, 65537, n) == e for s, e, n in rows]
    assert any(got) and not all(got)
    # the diff is v XOR em digit for digit
    for (s, e, n), d in zip(rows, diff):
        v = pow(s, 65537, n)
        assert limb.limbs_to_int(d.astype(np.int64) ^ limb.int_to_limbs(e, 128)) == v


def test_chain_model_on_seeded_rows_matches_host_pow():
    rng = random.Random(13)
    ns = [rng.getrandbits(2048) | 1 | (1 << 2047) for _ in range(2)]
    rows = []
    for j in range(8):
        n = ns[j % 2]
        s = rng.randrange(n)
        rows.append((s, pow(s, 65537, n) if j % 3 else rng.randrange(n), n))
    diff = chain(*_operands(rows))
    assert (diff == 0).all(axis=1).tolist() == [j % 3 != 0 for j in range(8)]
