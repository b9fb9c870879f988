"""The port's RNS engine (bftkv_tpu_torch.ops.rns) against the JAX package.

Tolerance everywhere is exact: every value is an integer.  The same
seeded numpy inputs go through the reference's jitted XLA functions —
the plain route to the Pallas chains, which the reference's own tests
hold bit-identical to them (tests/test_pallas_rns.py) — and through the
port's plain PyTorch versions on the CPU, on the same constants carried
across by ``consts_from_numpy`` / ``key_rows_from_numpy``.  Small RNS
contexts keep the JAX compiles cheap; full 2048-bit width is held
against host ``pow`` in tests/test_torch_rsa.py.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bftkv_tpu.ops import bigint as ref_bigint
from bftkv_tpu.ops import limb as ref_limb
from bftkv_tpu.ops import rns as ref_rns
from bftkv_tpu_torch.ops import bigint, cuda_rns, limb, rns
from test_torch_utils import moduli as _moduli
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CTXS = [(16, 256), (32, 512)]
T = 8
N_KEYS = 3


class _Case:
    """One context's reference constants, port constants and inputs."""

    def __init__(self, digits: int, n_bits: int):
        self.ref_ctx = ref_rns.context(digits, n_bits)
        self.ref_cn = ref_rns._Consts(self.ref_ctx)
        self.cn = rns.consts_from_numpy(rns.context_arrays(self.ref_ctx), "cpu")
        self.k, self.digits, self.n_bits = self.ref_ctx.k, digits, n_bits
        rng = np.random.default_rng(digits)
        self.rng = rng
        self.ns = _moduli(self.ref_ctx, n_bits, N_KEYS, seed=n_bits)
        ukey = ref_rns.stack_key_rows([self.ref_ctx.key_rows(n) for n in self.ns])
        self.idx = rng.integers(0, N_KEYS, T)
        self.key_np = tuple(u[self.idx] for u in ukey)
        self.key_jax = tuple(jnp.asarray(u) for u in self.key_np)
        ukey_t = rns.key_rows_from_numpy(ukey, "cpu")
        self.key_t = rns.gather_key(ukey_t, torch.as_tensor(self.idx))

    def residues(self):
        p = self.ref_ctx.p_all.astype(np.int64)
        k = self.k
        return (
            self.rng.integers(0, 1 << 30, (T, k)) % p[:k],
            self.rng.integers(0, 1 << 30, (T, k)) % p[k:],
            self.rng.integers(0, 1 << 12, (T, 1)),
        )

    def halves(self, values: list[int]) -> np.ndarray:
        digits = np.stack([ref_limb.int_to_limbs(v, self.digits) for v in values])
        return ref_rns.digits_to_halves(digits)


@pytest.fixture(scope="module", params=CTXS, ids=lambda c: f"d{c[0]}_b{c[1]}")
def case(request):
    return _Case(*request.param)


def _f32(xs):
    return tuple(jnp.asarray(x, jnp.float32) for x in xs)


def _i64(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("digits,n_bits", CTXS + [(128, 2048)])
def test_context_arrays_match_reference(digits, n_bits):
    ref = ref_rns.context(digits, n_bits)
    port = rns.context(digits, n_bits)
    assert (port.k, port.pb, port.pq, port.M, port.Mq) == (
        ref.k, ref.pb, ref.pq, ref.M, ref.Mq
    )
    for name in rns.CONTEXT_ARRAYS:
        a, b = getattr(ref, name), getattr(port, name)
        if isinstance(a, tuple):
            assert all(np.array_equal(x, y) for x, y in zip(a, b)), name
        else:
            assert np.array_equal(a, b), name
    np.testing.assert_array_equal(ref_rns._crt_matrix(ref), rns._crt_matrix(port))


def test_key_rows_match_reference():
    ref, port = ref_rns.context(), rns.context()
    good = _moduli(ref, 2048, 2, seed=7)
    chan = ref.pb[3]
    hostile = [
        good[0] + 1,  # even
        chan * ((1 << 2030) + 1),  # shares a channel prime
        (1 << 2049) + 1,  # wider than the digit budget
        0,
    ]
    for n in good:
        for a, b in zip(ref.key_rows(n), port.key_rows(n)):
            np.testing.assert_array_equal(a, b)
    for n in hostile:
        assert ref.key_rows(n) is None and port.key_rows(n) is None
    rows = [ref.key_rows(n) for n in good]
    for a, b in zip(ref_rns.stack_key_rows(rows), rns.stack_key_rows(rows)):
        np.testing.assert_array_equal(a, b)


def test_limb_codec_matches_reference():
    rng = random.Random(3)
    xs = [0, 1, (1 << 2048) - 1] + [rng.getrandbits(2000) for _ in range(5)]
    for x in xs:
        np.testing.assert_array_equal(
            limb.int_to_limbs(x, 128), ref_limb.int_to_limbs(x, 128)
        )
        assert limb.limbs_to_int(limb.int_to_limbs(x, 128)) == x
    a = limb.ints_to_limbs(xs, 128)
    np.testing.assert_array_equal(a, ref_limb.ints_to_limbs(xs, 128))
    assert limb.limbs_to_ints(a) == ref_limb.limbs_to_ints(a) == xs
    assert limb.nlimbs_for_bits(1025) == ref_limb.nlimbs_for_bits(1025) == 65
    digits = np.stack([limb.int_to_limbs(x, 128) for x in xs])
    np.testing.assert_array_equal(
        rns.digits_to_halves(digits), ref_rns.digits_to_halves(digits)
    )
    np.testing.assert_array_equal(
        rns.digits_to_halves_u8(digits), ref_rns.digits_to_halves_u8(digits)
    )


def test_montgomery_domain_matches_reference():
    n = _moduli(rns.context(), 2048, 1, seed=11)[0]
    a, b = bigint.MontgomeryDomain(n, 128), ref_bigint.MontgomeryDomain(n, 128)
    for f in ("n", "n_prime", "r2", "one_mont"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.n_int, a.r_int, a.nlimbs) == (b.n_int, b.r_int, b.nlimbs)
    xs = [5, n - 1, 1 << 1000]
    np.testing.assert_array_equal(a.encode(xs), b.encode(xs))
    assert a.decode(a.encode(xs)) == b.decode(b.encode(xs)) == xs
    for bad in (n + 1, (1 << 2048) + 1):
        with pytest.raises(ValueError):
            bigint.MontgomeryDomain(bad, 128)


def test_mont_mul_matches_reference(case):
    a, b = case.residues(), case.residues()
    want = jax.jit(lambda a, b, key: ref_rns._mont_mul(case.ref_cn, a, b, key))(
        _f32(a), _f32(b), case.key_jax
    )
    got = rns._mont_mul(
        case.cn,
        tuple(torch.as_tensor(x) for x in a),
        tuple(torch.as_tensor(x) for x in b),
        case.key_t,
    )
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_i64(w), g.numpy())


def test_to_residues_matches_reference(case):
    h = case.rng.integers(0, 256, (T, 2 * case.digits)).astype(np.uint8)
    want = jax.jit(lambda h: ref_rns._to_residues(case.ref_cn, h))(
        jnp.asarray(h, jnp.float32)
    )
    got = rns._to_residues(case.cn, torch.as_tensor(h))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_i64(w), g.numpy())


def test_verify_kernel_matches_reference(case):
    rng = random.Random(case.n_bits)
    ns = [case.ns[i] for i in case.idx]
    sigs = [rng.randrange(n) for n in ns]
    # Every other row valid; the rest random (≡ forged) residues.
    ems = [
        pow(s, 65537, n) if j % 2 == 0 else rng.randrange(n)
        for j, (s, n) in enumerate(zip(sigs, ns))
    ]
    sh, eh = case.halves(sigs), case.halves(ems)
    want = np.asarray(
        jax.jit(lambda s, e, key: ref_rns._verify_kernel(case.ref_cn, s, e, key))(
            sh, eh, case.key_jax
        )
    )
    got = rns._verify_kernel(
        case.cn,
        torch.as_tensor(sh.astype(np.uint8)),
        torch.as_tensor(eh.astype(np.uint8)),
        case.key_t,
    ).numpy()
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        got, [pow(s, 65537, n) == e for s, e, n in zip(sigs, ems, ns)]
    )


def test_pow_kernel_matches_reference(case):
    rng = random.Random(case.n_bits + 1)
    ns = [case.ns[i] for i in case.idx]
    bases = [rng.randrange(n) for n in ns]
    nib = case.rng.integers(0, 16, (4 * case.digits, T)).astype(np.uint8)
    bh = case.halves(bases)
    want = np.asarray(
        jax.jit(lambda b, e, key: ref_rns._pow_kernel(case.ref_cn, b, e, key))(
            bh, jnp.asarray(nib, jnp.float32), case.key_jax
        )
    )
    got = rns._pow_kernel(
        case.cn, torch.as_tensor(bh.astype(np.uint8)), torch.as_tensor(nib), case.key_t
    ).numpy()
    np.testing.assert_array_equal(_i64(want), got)
    # σ rebuilds base^exp mod n (exponent = the nibbles, MS first).
    exps = [int("".join("%x" % v for v in nib[:, j]), 16) for j in range(T)]
    vals = rns._sigma_to_ints(rns.context(case.digits, case.n_bits), got)
    assert [v % n for v, n in zip(vals, ns)] == [
        pow(b, e, n) for b, e, n in zip(bases, exps, ns)
    ]


@pytest.mark.parametrize("defer", [False, True])
def test_power_mod_rns_cpu_matches_pow(defer):
    ctx = rns.context(32, 512)
    rng = random.Random(5)
    mods = _moduli(ctx, 512, 3, seed=9)
    rows = [mods[i % 3] for i in range(5)]
    bases = [rng.getrandbits(1024) for _ in rows]
    exps = [rng.getrandbits(512) for _ in rows]
    before = dict(cuda_rns.LAUNCHES)
    out = rns.power_mod_rns(bases, exps, rows, n_bits=512, defer=defer, device="cpu")
    vals = out.wait() if defer else out
    assert vals == [pow(b, e, m) for b, e, m in zip(bases, exps, rows)]
    # The CPU path runs the plain version: no kernel launch is counted.
    assert cuda_rns.LAUNCHES == before
    # A modulus the bases cannot take → None (the caller falls back).
    assert rns.power_mod_rns([3], [5], [ctx.pb[0] * 1001], n_bits=512, device="cpu") is None
    assert rns.power_mod_rns([3], [1 << 600], [mods[0]], n_bits=512, device="cpu") is None
    assert rns.power_mod_rns([], [], [], device="cpu") == []


def test_consts_from_numpy_validates_arrays():
    arrays = rns.context_arrays(ref_rns.context(16, 256))
    cn = rns.consts_from_numpy(arrays, "cpu")
    assert cn.k == ref_rns.context(16, 256).k and cn.digits == 16
    bad = dict(arrays, inv_all=arrays["inv_all"][::-1].copy())
    with pytest.raises(ValueError):
        rns.consts_from_numpy(bad, "cpu")
    with pytest.raises(KeyError):
        rns.consts_from_numpy({k: v for k, v in arrays.items() if k != "_D"}, "cpu")
    with pytest.raises(ValueError):
        rns.key_rows_from_numpy((np.full((2, 3), 0.5, np.float32),) * 6, "cpu")


def test_consts_refuse_contexts_the_kernels_do_not_take():
    k = rns.MAX_CHANNELS + 1
    p_all = np.arange(3, 3 + 4 * k, 2, dtype=np.float32)
    arrays = {name: np.zeros(1, np.float32) for name in rns.CONTEXT_ARRAYS}
    arrays.update(p_all=p_all, inv_all=np.float32(1.0) / p_all,
                  invMi_b=np.ones(k, np.float32))
    with pytest.raises(ValueError, match=f"k={k} channels exceeds {rns.MAX_CHANNELS}"):
        rns.consts_from_numpy(arrays, "cpu")
