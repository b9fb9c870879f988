"""The port's RNS P-256 engine (``bftkv_tpu_torch/ops/ec_rns.py``) against the
reference's (``bftkv_tpu/ops/ec_rns.py``) and the host curve.

The reference's field and group-law methods run op by op (never its jitted
``_scalar_mult_fn``) on the same seeded residues, transposed between the
reference's channel-major (k, T) layout and the port's channels-last
(T, k); every result must be equal bit for bit.  Whole scalar mults are
held against ``crypto/ec.py`` on random points and the edge cases of
``tests/test_ec_ops.py`` and ``tests/test_ec_rns.py``.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bftkv_tpu.ops import ec_rns as ref_ec_rns
from bftkv_tpu_torch.crypto.ec import P256
from bftkv_tpu_torch.ops import devbuf, ec_rns
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

G = (P256.gx, P256.gy)
N = P256.n


@pytest.fixture(scope="module")
def ref():
    return ref_ec_rns._engine()


@pytest.fixture(scope="module")
def eng():
    return ec_rns.engine("cpu")


def to_ref(tr):
    """Port triplet (b (T,k), q (T,k), r (T,1)) int64 → reference (k,T) f32."""
    return tuple(jnp.asarray(x.numpy().T.astype(np.float32)) for x in tr)


def from_ref(tr):
    return tuple(torch.from_numpy(np.asarray(x).T.astype(np.int64)) for x in tr)


def assert_same(port, reference):
    for a, b in zip(port, from_ref(reference)):
        assert torch.equal(a, b)


def rand_res(eng, t: int, rng: np.random.Generator):
    """Seeded random residues over [B | B' | 2^12] (any value, not only < c·p)."""
    ctx = eng.ctx
    b = np.stack([rng.integers(0, p, t) for p in ctx.pb], axis=1)
    q = np.stack([rng.integers(0, p, t) for p in ctx.pq], axis=1)
    r = rng.integers(0, 4096, (t, 1))
    return tuple(torch.from_numpy(x.astype(np.int64)) for x in (b, q, r))


def res_of(eng, vals: list[int]):
    """Residues of the integers ``vals`` (channels-last)."""
    ctx = eng.ctx
    mk = lambda mods: torch.tensor([[v % m for m in mods] for v in vals], dtype=torch.int64)
    return mk(ctx.pb), mk(ctx.pq), mk([4096])


def points_res(eng, pts: list):
    """Montgomery-form Jacobian residues of affine host points (None = identity)."""
    block = np.zeros((3, 2 * eng.k + 1, len(pts)), dtype=np.int32)
    eng.encode_points_into(pts, block)
    return eng.unstack(torch.from_numpy(block))


def host_points(seed: int, count: int) -> list:
    rng = random.Random(seed)
    return [P256.scalar_base_mult(rng.randrange(1, N)) for _ in range(count)]


# -- constants ------------------------------------------------------------------


def test_constants_equal_the_reference(ref, eng):
    col = lambda x: np.asarray(x)[:, 0].astype(np.int64)
    k = eng.k
    assert k == ref.k == 27
    assert eng.ctx.pb == ref.ctx.pb and eng.ctx.pq == ref.ctx.pq
    n_all, n_r, nnb = (x.numpy()[0] for x in eng.key)
    np.testing.assert_array_equal(n_all, np.concatenate([col(ref.nb), col(ref.nq)]))
    assert int(n_r[0]) == int(np.asarray(ref.nr)[0, 0])
    np.testing.assert_array_equal(nnb, col(ref.neg_ninv_b))
    np.testing.assert_array_equal(eng.pinv_b.numpy()[0], col(ref.pinv_b))
    for s in (ec_rns._S_SMALL, ec_rns._S_L1, ec_rns._S_L2):
        for mine, theirs in zip(eng.sp[s], ref.sp[s]):
            np.testing.assert_array_equal(mine.numpy()[0], col(theirs))
    for mine, theirs in zip(eng.one_m + eng.zero, ref.one_m + ref.zero):
        np.testing.assert_array_equal(mine.numpy()[0], col(theirs))
    cn = eng.cn
    for name in ("invMi_b", "invMi_q", "Mq_mod_b", "invM_q"):
        np.testing.assert_array_equal(getattr(cn, name).numpy(), col(getattr(ref, name)))
    assert cn.invMq_pr == int(ref.invMq_pr) and cn.invM_pr == int(ref.invM_pr)
    # The kernel's constants: E1 and E2 as int8 planes in mma fragment order
    # (rns.mma_planes at k = 27) are the reference's split matrices; the
    # field table and the key rows are the values checked above.
    from test_torch_k2_arith import _unpack_a

    planes = cn.kern["E_mma"].numpy()
    join = lambda pair: (np.asarray(pair[0]) + 64 * np.asarray(pair[1])).astype(np.int64)
    for e, (main, red) in enumerate(((ref.E1qT, ref.E1r), (ref.E2bT, ref.E2r))):
        a = _unpack_a(planes[e, 0]) + 64 * _unpack_a(planes[e, 1])  # Eᵀ, zero padded
        np.testing.assert_array_equal(a[:k, :k], join(main))
        np.testing.assert_array_equal(a[k, :k], join(red)[:, 0])
        assert not a[k + 1 :].any() and not a[:, k:].any()
    field = dict(zip(ec_rns.FIELD_ROWS, eng.field.numpy().astype(np.int64)))
    cat = lambda trip: np.concatenate([col(x) for x in trip])
    np.testing.assert_array_equal(field["pinv_b"], np.concatenate([col(ref.pinv_b), [0] * (k + 1)]))
    np.testing.assert_array_equal(field["one"], cat(ref.one_m))
    for name, s in (("sp_small", ec_rns._S_SMALL), ("sp_l1", ec_rns._S_L1), ("sp_l2", ec_rns._S_L2)):
        np.testing.assert_array_equal(field[name], cat(ref.sp[s]))
    for mine, theirs in zip(eng.ukey, eng.key):
        np.testing.assert_array_equal(mine.numpy(), theirs.numpy())


# -- field ops, op by op --------------------------------------------------------

FIELD_OPS = ["fmul", "fadd", "fdbl", "fsub_small", "fsub_l1", "fsub_l2"]


@pytest.mark.parametrize("op", FIELD_OPS)
def test_field_op_equals_the_reference(ref, eng, op):
    rng = np.random.default_rng(FIELD_OPS.index(op) + 11)
    a, b = rand_res(eng, 64, rng), rand_res(eng, 64, rng)
    # Edge columns: zeros, and one operand equal to the other.
    a = tuple(torch.cat([x[:2] * 0, x[2:]]) for x in a)
    b = tuple(torch.cat([y[:4], x[4:5], y[5:]]) for x, y in zip(a, b))
    if op.startswith("fsub"):
        s = {"small": ec_rns._S_SMALL, "l1": ec_rns._S_L1, "l2": ec_rns._S_L2}[op[5:]]
        assert_same(eng.fsub(a, b, s), ref.fsub(to_ref(a), to_ref(b), s))
    elif op == "fdbl":
        assert_same(eng.fdbl(a), ref.fdbl(to_ref(a)))
    else:
        assert_same(getattr(eng, op)(a, b), getattr(ref, op)(to_ref(a), to_ref(b)))


def test_is_zero_equals_the_reference(ref, eng):
    p = P256.p
    # Multiples c·p up to and past the test's bound (alpha <= 64), values
    # near them, 0, and random residues.
    vals = [c * p for c in (0, 1, 2, 31, 63, 64, 65, 100, 3000)] + [1, p - 1, p + 1, 64 * p + 1]
    v = res_of(eng, vals)
    rnd = rand_res(eng, 8, np.random.default_rng(3))
    v = tuple(torch.cat([x, y]) for x, y in zip(v, rnd))
    got = eng.is_zero(v)
    want = torch.from_numpy(np.array(ref.is_zero(to_ref(v))))
    assert torch.equal(got, want)
    assert got[:6].all() and not got[6:].any()


def _group_inputs(eng):
    """Jacobian residues with the group law's edge lanes: P + Q, P + P (the
    doubling lane), P + (−P), O + P, P + O, O + O, and two random-residue
    columns."""
    P, Q = host_points(5, 2)
    negP = (P[0], (-P[1]) % P256.p)
    A = points_res(eng, [P, P, P, None, P, None, G, Q])
    B = points_res(eng, [Q, P, negP, Q, None, None, G, P])
    rng = np.random.default_rng(9)
    junk = [rand_res(eng, 2, rng) for _ in range(6)]
    A = tuple(tuple(torch.cat([x, j]) for x, j in zip(c, junk[i])) for i, c in enumerate(A))
    B = tuple(tuple(torch.cat([x, j]) for x, j in zip(c, junk[3 + i])) for i, c in enumerate(B))
    return A, B


def test_jac_double_equals_the_reference(ref, eng):
    A, _ = _group_inputs(eng)
    got = eng.jac_double(*A)
    want = ref.jac_double(*(to_ref(c) for c in A))
    for g, w in zip(got, want):
        assert_same(g, w)
    # The identity's Z stays exactly 0 through a doubling.
    assert all(not z[3].any() and not z[5].any() for z in got[2])


def test_jac_add_equals_the_reference(ref, eng):
    A, B = _group_inputs(eng)
    got = eng.jac_add(A, B)
    want = ref.jac_add(tuple(to_ref(c) for c in A), tuple(to_ref(c) for c in B))
    for g, w in zip(got, want):
        assert_same(g, w)
    # P + (−P) and O + O give an exact-0 Z.
    assert all(not z[2].any() and not z[5].any() for z in got[2])


def test_window_step_equals_the_reference(ref, eng):
    """One window of the scalar mult (4 doublings, the one-hot blend, the
    unified add): the port's ``_window`` against the reference's scan
    body, run op by op on the same table and accumulator."""
    pts = host_points(13, 4) + [G, None, G, host_points(14, 1)[0]]
    acc = points_res(eng, host_points(15, 6) + [None, G])
    cat = ec_rns._table(eng, points_res(eng, pts))
    nib = torch.tensor([0, 1, 15, 7, 2, 9, 0, 3])
    got = ec_rns._window(eng, acc, cat, nib)

    racc = tuple(to_ref(c) for c in acc)
    rcat = [[jnp.asarray(np.transpose(cat[i][j].numpy(), (0, 2, 1)).astype(np.float32))
             for j in range(3)] for i in range(3)]
    for _ in range(4):
        racc = ref.jac_double(*racc)
    m16 = (jnp.asarray(nib.numpy().astype(np.float32))[None, None, :]
           == jnp.arange(16, dtype=jnp.float32)[:, None, None]).astype(jnp.float32)
    q = tuple(tuple(jnp.sum(m16 * rcat[i][j], axis=0) for j in range(3)) for i in range(3))
    want = ref.jac_add(racc, q)
    for g, w in zip(got, want):
        assert_same(g, w)


# -- staging and codecs ---------------------------------------------------------


def test_staged_residues_equal_encode_points_into(ref, eng):
    pts = host_points(21, 9) + [None, G, (0, P256.p - 1), None]
    mine = np.zeros((3, 2 * eng.k + 1, len(pts)), dtype=np.int32)
    eng.encode_points_into(pts, mine)
    theirs = np.zeros((3, 2 * eng.k + 1, len(pts)), dtype=np.float32)
    ref.encode_points_into(pts, theirs)
    np.testing.assert_array_equal(mine, theirs.astype(np.int64))


def test_decode_equals_the_reference(ref, eng):
    """The device half of the decode (the strip and σ) equals the
    reference's σ bit for bit, and the host half gives the reference's
    affine points, identities included."""
    A, B = _group_inputs(eng)
    block = eng.stack(eng.jac_add(A, B))[:, :, :8]
    comps = [to_ref(c) for c in eng.unstack(block)]
    sigma = eng.strip_sigma(block)
    assert sigma.shape == (3, 8, eng.k) and sigma.dtype == torch.int32
    for c, comp in enumerate(comps):
        plain = ref.fmul(comp, tuple(jnp.ones_like(x) for x in comp))
        want = ref_ec_rns._mulmod(plain[0], ref.invMi_b, ref.ib, ref.pb)
        np.testing.assert_array_equal(sigma[c].numpy(), np.asarray(want).T.astype(np.int64))
    got = eng.decode_points(block.numpy())
    assert got == ref.decode_points(*comps)
    assert None in got


def test_nibbles_equal_the_reference():
    rng = random.Random(31)
    ks = [0, 1, 15, 16, N - 1, N, N + 5, 2**256 - 1] + [rng.randrange(N) for _ in range(8)]
    mine = ec_rns._nibbles(ks)
    theirs = ref_ec_rns._nibbles(ks)
    assert mine.shape == theirs.shape == (64, len(ks))
    np.testing.assert_array_equal(mine.astype(np.float32), theirs)


def test_scalar_mult_matches_the_host_curve():
    """Random points and the reference tests' edge cases in one batch: k·O,
    0·P, 1·G, n·G, (n−1)·P = −P, the small scalars whose windows hit the
    doubling lane (2·G, 3·G), and random scalars."""
    rng = random.Random(41)
    p1 = P256.scalar_base_mult(12345)
    pts = [None, p1, p1, G, p1, G, G, G, G, G] + host_points(42, 6)
    ks = [5, 0, N, 2, N - 1, 0, 1, N, N - 1, 3] + [rng.randrange(N) for _ in range(6)]
    got = ec_rns.scalar_mult_hosts(pts, ks, device="cpu")
    want = [P256.scalar_mult(pt, k) if pt is not None else None for pt, k in zip(pts, ks)]
    assert got == want
    assert got[4] == (p1[0], (-p1[1]) % P256.p)


def test_staging_watermark_reencodes_only_dirty_columns(monkeypatch):
    """A slot's pad columns past its ``pad_lo`` watermark already hold the
    identity and nibble 0: a smaller batch after a larger one re-pads the
    columns the larger one dirtied, and the results stay right."""
    monkeypatch.setenv("BFTKV_DISPATCH_DEVBUF_RING", "1")
    devbuf.reset()
    try:
        eng = ec_rns.engine("cpu")
        first = ec_rns.scalar_mult_hosts([G] * 6, [2, 3, 4, 5, 6, 7], device="cpu")
        assert first == [P256.scalar_mult(G, k) for k in range(2, 8)]
        second = ec_rns.scalar_mult_hosts([G, G], [9, N - 2], device="cpu")
        assert second == [P256.scalar_mult(G, 9), P256.scalar_mult(G, N - 2)]
        (ring,) = [r for key, r in devbuf._RINGS.items() if key.startswith("ec:8:")]
        (slot,) = ring._slots
        assert int(slot["pad_lo"][0]) == 2 and not slot.in_flight
        ident = np.zeros((3, 2 * eng.k + 1, 6), dtype=np.int32)
        eng.encode_points_into([None] * 6, ident)
        np.testing.assert_array_equal(slot["res"][:, :, 2:], ident)
        assert not slot["nib"][:, 2:].any()
        assert devbuf.stats()[ring.key]["width"] == "ec"
    finally:
        devbuf.reset()


def test_k5_wrapper_refuses_wrong_operands():
    """The wrapper's checks run before either route: a wrong dtype, shape,
    layout or device never reaches the kernel or the plain version."""
    from bftkv_tpu_torch.ops import cuda_ec

    eng = ec_rns.engine("cpu")
    res = torch.zeros((3, 2 * eng.k + 1, 8), dtype=torch.int32)
    nib = torch.zeros((64, 8), dtype=torch.uint8)
    bad = [
        (res.to(torch.int64), nib, TypeError),
        (res, nib.to(torch.int32), TypeError),
        (res[:, :-1].contiguous(), nib, ValueError),
        (res, nib[:, :4].contiguous(), ValueError),
        (res[:, :, ::2], nib[:, ::2], ValueError),
        (torch.zeros((3, 2 * eng.k + 1, 0), dtype=torch.int32), nib[:, :0], ValueError),
    ]
    for r, n, err in bad:
        with pytest.raises(err):
            cuda_ec.scalar_mult_cuda(r, n, eng)
