"""The port's limb engine and K3's plain version against the JAX package.

Tolerance everywhere is exact: every value is an integer.  The same
seeded numpy inputs (the reference's uint32 digit arrays, carried across
by ``limbs_from_numpy``) go through ``bftkv_tpu.ops.bigint`` /
``ops.rsa`` / ``ops.pallas_mont`` (the Pallas kernel in interpret mode,
as the reference's own tests run it on the CPU) and through the port's
PyTorch programs on the CPU; both are also held against Python ints.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bftkv_tpu.ops import bigint as ref_bigint
from bftkv_tpu.ops import limb as ref_limb
from bftkv_tpu.ops import pallas_mont as ref_pallas_mont
from bftkv_tpu.ops import rsa as ref_rsa_ops
from bftkv_tpu_torch.ops import bigint, cuda_mont
from bftkv_tpu_torch.ops import rsa as rsa_ops
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

rng = random.Random(2026)


def _t(a) -> torch.Tensor:
    return bigint.limbs_from_numpy(np.asarray(a), "cpu")


def _eq(ref, got: torch.Tensor) -> None:
    np.testing.assert_array_equal(np.asarray(ref).astype(np.int64), got.numpy())


def _odd(bits: int) -> int:
    return rng.getrandbits(bits) | (1 << (bits - 1)) | 1


@pytest.mark.parametrize("bits", [64, 256])
def test_carry_resolve_matches_reference(bits):
    nl = ref_limb.nlimbs_for_bits(bits)
    # Lane values up to 2^26 (the worst case the products give), and runs
    # of all-ones digits that make long carry chains.
    raw = np.array(
        [[rng.getrandbits(26) for _ in range(nl)] for _ in range(6)]
        + [[0xFFFF] * (nl - 1) + [1 << 20], [1 << 17] + [0xFFFF] * (nl - 1)],
        dtype=np.uint32,
    )
    for out_len in (nl, nl + 2):
        got = bigint.carry_resolve(torch.as_tensor(raw.astype(np.int64)), out_len)
        _eq(ref_bigint.carry_resolve(raw, out_len), got)
        r = 1 << (16 * out_len)
        for row_raw, row in zip(raw, got.numpy()):
            want = sum(int(v) << (16 * i) for i, v in enumerate(row_raw)) % r
            assert ref_limb.limbs_to_int(row) == want


@pytest.mark.parametrize("bits", [64, 256, 2048])
def test_mul_matches_reference(bits):
    nl = ref_limb.nlimbs_for_bits(bits)
    m = (1 << bits) - 1  # all-0xFFFF digits: worst-case carry chains
    xs = [rng.getrandbits(bits) for _ in range(4)] + [m, m, 0]
    ys = [rng.getrandbits(bits) for _ in range(4)] + [m, 1, m]
    a, b = ref_limb.ints_to_limbs(xs, nl), ref_limb.ints_to_limbs(ys, nl)
    for ncols in (nl, 2 * nl):  # the unresolved columns, both widths
        _eq(ref_bigint._mul_cols(jnp.asarray(a), jnp.asarray(b), ncols),
            bigint._mul_cols(_t(a), _t(b), ncols))
    got = bigint.mul(_t(a), _t(b))
    _eq(ref_bigint.mul(a, b), got)
    assert ref_limb.limbs_to_ints(got.numpy()) == [x * y for x, y in zip(xs, ys)]


def test_add_sub_geq_match_reference():
    nl = 16
    xs = [rng.getrandbits(250) for _ in range(6)]
    ys = [rng.getrandbits(250) for _ in range(6)]
    # Ties: equal rows, and rows that differ only in the lowest digit.
    xs += [xs[0], 5, 1 << 200]
    ys += [xs[0], 4, (1 << 200) + 1]
    a, b = ref_limb.ints_to_limbs(xs, nl), ref_limb.ints_to_limbs(ys, nl)
    s = bigint.add(_t(a), _t(b), nl + 1)
    _eq(ref_bigint.add(a, b, nl + 1), s)
    assert ref_limb.limbs_to_ints(s.numpy()) == [x + y for x, y in zip(xs, ys)]
    d = bigint.sub_mod_r(_t(a), _t(b))
    _eq(ref_bigint.sub_mod_r(a, b), d)
    r = 1 << (16 * nl)
    assert ref_limb.limbs_to_ints(d.numpy()) == [(x - y) % r for x, y in zip(xs, ys)]
    ge = bigint.geq(_t(a), _t(b))
    np.testing.assert_array_equal(np.asarray(ref_bigint.geq(a, b)), ge.numpy())
    assert ge.tolist() == [x >= y for x, y in zip(xs, ys)]


@pytest.mark.parametrize("per_row", [False, True], ids=["one_modulus", "per_row_moduli"])
def test_mont_mul_matches_reference(per_row):
    ns = [_odd(256) for _ in range(3 if per_row else 1)]
    doms = [ref_bigint.MontgomeryDomain(n, 16) for n in ns]
    rows = [doms[i % len(doms)] for i in range(5)]
    xs = [rng.randrange(d.n_int) for d in rows]
    ys = [rng.randrange(d.n_int) for d in rows]
    am = np.stack([d.encode([x])[0] for d, x in zip(rows, xs)])
    bm = np.stack([d.encode([y])[0] for d, y in zip(rows, ys)])
    n, npr = np.stack([d.n for d in rows]), np.stack([d.n_prime for d in rows])
    got = bigint.mont_mul(_t(am), _t(bm), _t(n), _t(npr))
    _eq(ref_bigint.mont_mul(am, bm, n, npr), got)
    for d, x, y, row in zip(rows, xs, ys, got.numpy()):
        assert d.decode(row[None])[0] == (x * y) % d.n_int
    # to/from Montgomery round trip
    plain = ref_limb.ints_to_limbs(xs, 16)
    r2 = np.stack([d.r2 for d in rows])
    m = bigint.to_mont(_t(plain), _t(r2), _t(n), _t(npr))
    _eq(ref_bigint.to_mont(plain, r2, n, npr), m)
    assert ref_limb.limbs_to_ints(bigint.from_mont(m, _t(n), _t(npr)).numpy()) == xs


@pytest.mark.parametrize("e", [3, 17, 65537])
def test_mont_pow_static_matches_reference(e):
    dom = ref_bigint.MontgomeryDomain(_odd(512))
    xs = [rng.randrange(dom.n_int) for _ in range(4)]
    am = dom.encode(xs)
    got = bigint.mont_pow_static(_t(am), e, _t(dom.n), _t(dom.n_prime))
    _eq(ref_bigint.mont_pow_static(am, e, dom.n, dom.n_prime), got)
    assert dom.decode(got.numpy()) == [pow(x, e, dom.n_int) for x in xs]
    with pytest.raises(ValueError):
        bigint.mont_pow_static(_t(am), 0, _t(dom.n), _t(dom.n_prime))


@pytest.mark.parametrize("bits,ebits", [(256, 256), (512, 64), (256, 32)],
                         ids=["256_256", "512_64", "256_shared"])
def test_mont_exp_matches_reference(bits, ebits):
    dom = ref_bigint.MontgomeryDomain(_odd(bits))
    xs = [rng.randrange(dom.n_int) for _ in range(4)]
    am = dom.encode(xs)
    if ebits == 32:  # one exponent shared by every row (e.g. a fixed e)
        es = [65537] * 4
        e = ref_limb.int_to_limbs(65537, 2)
    else:
        es = [rng.getrandbits(ebits) | 1 for _ in range(4)]
        e = ref_limb.ints_to_limbs(es, ref_limb.nlimbs_for_bits(ebits))
    one = np.broadcast_to(dom.one_mont, am.shape)
    got = bigint.mont_exp(_t(am), _t(e), _t(dom.n), _t(dom.n_prime), _t(one))
    _eq(ref_bigint.mont_exp(am, e, dom.n, dom.n_prime, one), got)
    assert dom.decode(got.numpy()) == [pow(x, ei, dom.n_int) for x, ei in zip(xs, es)]


def test_power_batch_matches_reference():
    ns = [_odd(256) for _ in range(2)]
    doms = [bigint.MontgomeryDomain(n, 16) for n in ns]
    rows = [doms[i % 2] for i in range(4)]
    bases = [rng.randrange(d.n_int) for d in rows]
    exps = [rng.getrandbits(300) for _ in rows]
    args = (
        ref_limb.ints_to_limbs(bases, 16), ref_limb.ints_to_limbs(exps, 64),
        *(np.stack([getattr(d, f) for d in rows]) for f in ("n", "n_prime", "r2", "one_mont")),
    )
    got = rsa_ops.power_batch(*args, device="cpu")
    _eq(ref_rsa_ops.power_batch(*args), got)
    assert ref_limb.limbs_to_ints(got.numpy()) == [
        pow(b, e, d.n_int) for b, e, d in zip(bases, exps, rows)
    ]


def test_limbs_from_numpy_validates():
    dom = ref_bigint.MontgomeryDomain(_odd(256), 16)
    t = bigint.limbs_from_numpy(dom.n, "cpu")
    assert t.dtype == torch.int64 and tuple(t.shape) == (16,)
    np.testing.assert_array_equal(t.numpy(), dom.n)
    with pytest.raises(ValueError):
        bigint.limbs_from_numpy(np.array([1 << 16], np.uint32), "cpu")
    with pytest.raises(ValueError):
        bigint.limbs_from_numpy(np.array([-1], np.int64), "cpu")
    with pytest.raises(TypeError):
        bigint.limbs_from_numpy(np.array([0.5]), "cpu")


# -- K3's plain version at full width (256 rows x 128 digits) ------------------


@pytest.fixture(scope="module")
def k3_case():
    """256 rows over two 2048-bit moduli: valid, forged, s = 0 and
    s >= n rows, as the reference's MontgomeryDomain digit arrays."""
    r = random.Random(7)
    doms = [ref_bigint.MontgomeryDomain(_odd(2048), 128) for _ in range(2)]
    rows, want = [], []
    for j in range(256):
        d = doms[j % 2]
        s = r.randrange(d.n_int)
        kind = j % 4
        if kind == 2:
            s = 0
        elif kind == 3 and j % 8 == 3:
            s = r.randrange(d.n_int, 1 << 2048)
        em = pow(s, 65537, d.n_int) if kind in (0, 3) else r.getrandbits(2040)
        rows.append((s, em, d))
        want.append(pow(s, 65537, d.n_int) == em)
    ops = (
        ref_limb.ints_to_limbs([s for s, _e, _d in rows], 128),
        ref_limb.ints_to_limbs([e for _s, e, _d in rows], 128),
        *(np.stack([getattr(d, f) for _s, _e, d in rows]) for f in ("n", "n_prime", "r2")),
    )
    diff = rsa_ops._verify_chain(*(_t(a) for a in ops))
    return ops, diff, want


def test_k3_plain_matches_pallas_kernel_and_xla(k3_case):
    ops, diff, want = k3_case
    assert sum(want) == 128 and not all(want)
    # The Pallas kernel's whole (T, 128) diff, laid out as verify_e65537
    # lays it out, in interpret mode.
    spec = pl.BlockSpec((ref_pallas_mont.TILE, 128), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    ref_diff = pl.pallas_call(
        ref_pallas_mont._verify_kernel,
        out_shape=jax.ShapeDtypeStruct((256, 128), jnp.uint32),
        grid=(256 // ref_pallas_mont.TILE,), in_specs=[spec] * 5, out_specs=spec,
        interpret=True,
    )(*ops)
    _eq(ref_diff, diff)
    verdicts = (diff == 0).all(dim=-1).numpy()
    np.testing.assert_array_equal(verdicts, want)
    np.testing.assert_array_equal(np.asarray(ref_rsa_ops.verify_batch_e65537(*ops)), want)
    np.testing.assert_array_equal(
        rsa_ops.verify_batch_e65537(*ops, device="cpu").numpy(), want
    )


def test_k3_wrapper_on_cpu_runs_the_plain_chain(k3_case):
    ops, diff, want = k3_case
    t = [torch.as_tensor(a.astype(np.int32)) for a in ops]
    before = dict(cuda_mont.LAUNCHES)
    got = cuda_mont.verify_cuda(*t)
    assert torch.equal(got, (diff == 0).all(dim=-1)) and got.tolist() == want
    assert cuda_mont.LAUNCHES == before  # the CPU runs no kernel
    for bad_rows in (0, 128, 300):
        with pytest.raises(ValueError, match="multiple of 256"):
            cuda_mont.verify_diff(*(torch.zeros((bad_rows, 128), dtype=torch.int32),) * 5)
    with pytest.raises(TypeError):
        cuda_mont.verify_diff(t[0].long(), *t[1:])
    with pytest.raises(ValueError, match="shape"):
        cuda_mont.verify_diff(t[0][:, :64].contiguous(), *t[1:])


def test_k3_n0_prime_is_the_low_word_of_n_prime():
    """K3 takes n0' = n'[0] | n'[1] << 16 from the int32 digit rows it is
    given (``mont_chain.cu``); on the reference's n' that is -n^-1 mod 2^32."""
    ns = [_odd(2048) for _ in range(6)] + [(1 << 2048) - 1, (1 << 2047) + 1]
    nprime = torch.as_tensor(
        np.stack([ref_bigint.MontgomeryDomain(n, 128).n_prime for n in ns]).astype(np.int32)
    )
    n0 = (nprime[:, 0].long() & 0xFFFF) | ((nprime[:, 1].long() & 0xFFFF) << 16)
    assert n0.tolist() == [(-pow(n, -1, 1 << 32)) % (1 << 32) for n in ns]
