"""A model of K5's per-lane arithmetic (``ops/csrc/ec_p256.cu``), in numpy.

K5 runs one P-256 scalar mult per warp: lane j < k owns channel j of B (its
``b`` slot) and of B′ (its ``q`` slot), lane k holds the 2^12 channel in its
``q`` slot and computes the second extension's 2^12 output in its ``b``
slot, and the lanes past it idle on modulus 4096.  The CUDA kernel cannot
run on the CPU, so this file models it step for step in the same layout, on the
same lane-constant table the kernel reads (``ec_rns.lane_table``): the
Barrett steps, each base extension as k broadcasts (the kernel's
``__shfl_sync``) of σ_i·E[i][lane] with its sum bound asserted, α taken
from lane k, ``is_zero`` by lane agreement, the uint16 window table and the
one-hot blend.  The model is held against the plain versions
(``ec_rns._P256RNS``'s ``fmul``/``is_zero``/``jac_double``/``jac_add`` and
``_scalar_mult``) bit for bit, and a whole scalar mult against the host
curve.

Arrays are ``(T, 32)`` uint64, one value per lane; a number is the pair of
its ``b`` and ``q`` slots.
"""

from __future__ import annotations

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bftkv_tpu_torch.crypto.ec import P256
from bftkv_tpu_torch.ops import cuda_ec, ec_rns, rns
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SRC = Path(__file__).resolve().parents[1] / "bftkv_tpu_torch" / "ops" / "csrc" / "ec_p256.cu"
LANES = ec_rns.LANES
U32 = np.uint64(0xFFFFFFFF)
EXT_BOUND = 1 << 29  # an extension sum's bound (ec_p256.cu's head comment)
G = (P256.gx, P256.gy)
N = P256.n


@pytest.fixture(scope="module")
def eng():
    return ec_rns.engine("cpu")


class Model:
    """The kernel's Field, lane by lane."""

    def __init__(self, eng):
        self.k = k = eng.k
        tab = eng.lane.numpy().view(np.uint32).astype(np.uint64)
        nrow = len(ec_rns.LANE_ROWS)
        self.c = {name: tab[i][None, :] for i, name in enumerate(ec_rns.LANE_ROWS)}
        self.e1, self.e2 = tab[nrow : nrow + k], tab[nrow + k : nrow + 2 * k]
        self.lane = np.arange(LANES)[None, :]
        c = self.c
        self.one = (c["one_b"], c["one_q"])
        self.sp = {ec_rns._S_SMALL: (c["sp_small_b"], c["sp_small_q"]),
                   ec_rns._S_L1: (c["sp_l1_b"], c["sp_l1_q"]),
                   ec_rns._S_L2: (c["sp_l2_b"], c["sp_l2_q"])}
        self.max_ext = 0

    @staticmethod
    def barrett(x, p, mu):
        assert (x <= U32).all()
        r = x - ((x * mu) >> np.uint64(32)) * p
        assert (r < 2 * p).all()  # one conditional subtraction is enough
        return np.where(r >= p, r - p, r)

    def extend(self, sigma, e):
        """Σ_i σ_i·E[i][lane] over source lanes i < k (k shuffles)."""
        acc = np.zeros_like(sigma)
        for i in range(self.k):
            acc = acc + sigma[:, i : i + 1] * e[i][None, :]
        self.max_ext = max(self.max_ext, int(acc.max()))
        assert (acc < EXT_BOUND).all()
        return acc

    def mul(self, a, b):
        c, br = self.c, self.barrett
        pb, mub, pq, muq = c["pb"], c["mub"], c["pq"], c["muq"]
        db = br(a[0] * b[0], pb, mub)
        dq = br(a[1] * b[1], pq, muq)
        qb = br(db * c["neg_ninv_b"], pb, mub)
        sg = br(qb * c["invMi_b"], pb, mub)
        qh = br(self.extend(sg, self.e1), pq, muq)
        s = dq + br(qh * c["nq"], pq, muq)
        s = np.where(s >= pq, s - pq, s)
        rq = br(s * c["invM_q"], pq, muq)
        sg2 = br(rq * c["invMi_q"], pq, muq)
        eb = br(self.extend(sg2, self.e2), pb, mub)
        al_lane = ((((eb - rq) & U32) & np.uint64(4095)) * c["invMq_pr"]) & np.uint64(4095)
        al = al_lane[:, self.k : self.k + 1]  # the shuffle from lane k
        corr = br(al * c["Mq_mod_b"], pb, mub)
        return np.where(eb >= corr, eb - corr, eb + pb - corr), rq

    def add(self, a, b):
        c = self.c
        x, y = a[0] + b[0], a[1] + b[1]
        return np.where(x >= c["pb"], x - c["pb"], x), np.where(y >= c["pq"], y - c["pq"], y)

    def dbl(self, a):
        return self.add(a, a)

    def sub(self, a, b, s):
        c = self.c
        x = np.where(a[0] >= b[0], a[0] - b[0], a[0] + c["pb"] - b[0]) + self.sp[s][0]
        y = np.where(a[1] >= b[1], a[1] - b[1], a[1] + c["pq"] - b[1]) + self.sp[s][1]
        return np.where(x >= c["pb"], x - c["pb"], x), np.where(y >= c["pq"], y - c["pq"], y)

    def is_zero(self, v):
        w = self.barrett(v[0] * self.c["pinv_b"], self.c["pb"], self.c["mub"])
        a = w[:, :1]
        agree = ((w == a) | (self.lane >= self.k)).all(axis=1)  # __all_sync
        return agree & (a[:, 0] <= np.uint64(2 * ec_rns._S_SMALL))

    @staticmethod
    def sel(f, a, b):
        return tuple(np.where(f[:, None], x, y) for x, y in zip(a, b))

    def jac_double(self, P):
        L1, L2 = ec_rns._S_L1, ec_rns._S_L2
        X, Y, Z = P
        delta = self.mul(Z, Z)
        gamma = self.mul(Y, Y)
        beta = self.mul(X, gamma)
        t0 = self.sub(X, delta, L1)
        t1 = self.add(X, delta)
        alpha = self.mul(t0, self.add(self.dbl(t1), t1))
        beta4 = self.dbl(self.dbl(beta))
        X3 = self.sub(self.mul(alpha, alpha), self.dbl(beta4), L1)
        Z3 = self.dbl(self.mul(Y, Z))
        g2 = self.mul(gamma, gamma)
        Y3 = self.sub(self.mul(alpha, self.sub(beta4, X3, L2)), self.dbl(self.dbl(self.dbl(g2))), L1)
        return X3, Y3, Z3

    def jac_add(self, A, B):
        S, L1, L2 = ec_rns._S_SMALL, ec_rns._S_L1, ec_rns._S_L2
        Z1Z1, Z2Z2 = self.mul(A[2], A[2]), self.mul(B[2], B[2])
        U1, U2 = self.mul(A[0], Z2Z2), self.mul(B[0], Z1Z1)
        S1 = self.mul(self.mul(A[1], B[2]), Z2Z2)
        S2 = self.mul(self.mul(B[1], A[2]), Z1Z1)
        H, R = self.sub(U2, U1, S), self.sub(S2, S1, S)
        H2 = self.mul(H, H)
        H3 = self.mul(H2, H)
        U1H2 = self.mul(U1, H2)
        X3 = self.sub(self.sub(self.mul(R, R), H3, L1), self.dbl(U1H2), L1)
        Y3 = self.sub(self.mul(R, self.sub(U1H2, X3, L2)), self.mul(S1, H3), L1)
        Z3 = self.mul(self.mul(A[2], B[2]), H)
        D = self.jac_double(A)
        inf1, inf2 = self.is_zero(A[2]), self.is_zero(B[2])
        same_x = self.is_zero(H) & ~inf1 & ~inf2
        same_y = self.is_zero(R)
        is_dbl, to_inf = same_x & same_y, same_x & ~same_y
        out = [self.sel(is_dbl, d, v) for d, v in zip(D, (X3, Y3, Z3))]
        zero = (np.zeros_like(H[0]), np.zeros_like(H[0]))
        out[2] = self.sel(to_inf, zero, out[2])
        return tuple(self.sel(inf1, b, self.sel(inf2, a, o)) for a, b, o in zip(A, B, out))

    # -- the window table in shared memory and the blend ----------------------

    @staticmethod
    def put(tab, e, P):
        """Entry e into the (T, 16, 6, 32) uint16 table (X, Y, Z × (b, q))."""
        for i, (b, q) in enumerate(P):
            tab[:, e, 2 * i] = b.astype(np.uint16)
            tab[:, e, 2 * i + 1] = q.astype(np.uint16)

    @staticmethod
    def blend(tab, nib, reads=None):
        """The kernel's select: all 16 entries read, masked by the nibble."""
        s = np.zeros((tab.shape[0], 6, LANES), dtype=np.uint64)
        for e in range(16):
            m = np.where(nib == e, U32, np.uint64(0))[:, None, None]
            if reads is not None:
                reads.append(e)
            s |= tab[:, e].astype(np.uint64) & m
        return tuple((s[:, 2 * i], s[:, 2 * i + 1]) for i in range(3))

    def scalar_mult(self, P, nib):
        t = P[0][0].shape[0]
        ident = (self.one, self.one, (np.zeros((1, LANES), np.uint64),) * 2)
        ident = tuple(tuple(np.broadcast_to(x, (t, LANES)).copy() for x in c) for c in ident)
        tab = np.zeros((t, 16, 6, LANES), dtype=np.uint16)
        self.put(tab, 0, ident)
        self.put(tab, 1, P)
        cur = P
        for e in range(2, 16):
            cur = self.jac_add(cur, P)
            self.put(tab, e, cur)
        acc = ident
        for w in range(64):
            for _ in range(4):
                acc = self.jac_double(acc)
            acc = self.jac_add(acc, self.blend(tab, nib[w]))
        return acc


def to_lanes(eng, tr):
    """Plain triplet (b (T,k), q (T,k), r (T,1)) → lane pair (b, q) as the
    kernel loads it: b of lanes >= k and q of lanes > k are 0."""
    k = eng.k
    b, q, r = (x.numpy().astype(np.uint64) for x in tr)
    B = np.zeros((b.shape[0], LANES), np.uint64)
    Q = np.zeros_like(B)
    B[:, :k], Q[:, :k], Q[:, k] = b, q, r[:, 0]
    return B, Q


def from_lanes(eng, pair):
    k = eng.k
    B, Q = pair
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))
    return as_t(B[:, :k]), as_t(Q[:, :k]), as_t(Q[:, k : k + 1])


def assert_same(eng, model_pair, plain):
    for a, b in zip(from_lanes(eng, model_pair), plain):
        assert torch.equal(a, b)


def rand_res(eng, t, seed, hi=False):
    """Seeded residues (``hi``: every channel at p − 1, the sums' worst case)."""
    rng = np.random.default_rng(seed)
    ctx = eng.ctx
    pick = lambda p, n: np.full(n, p - 1) if hi else rng.integers(0, p, n)
    b = np.stack([pick(p, t) for p in ctx.pb], axis=1)
    q = np.stack([pick(p, t) for p in ctx.pq], axis=1)
    r = pick(4096, (t, 1)).reshape(t, 1)
    return tuple(torch.from_numpy(x.astype(np.int64)) for x in (b, q, r))


def points(eng, pts):
    block = np.zeros((3, 2 * eng.k + 1, len(pts)), dtype=np.int32)
    eng.encode_points_into(pts, block)
    return eng.unstack(torch.from_numpy(block))


def host_points(seed, count):
    rng = random.Random(seed)
    return [P256.scalar_base_mult(rng.randrange(1, N)) for _ in range(count)]


# -- the kernel's layout constants ----------------------------------------------


def test_layout_constants_match_the_kernel_source(eng):
    src = SRC.read_text()
    const = lambda name: int(re.search(rf"constexpr \w+ {name} = (\d+)", src).group(1))
    assert const("kK") == eng.k == 27
    assert re.search(r"constexpr int kRLane = kK;", src)
    assert re.search(r"constexpr int kChan = 2 \* kK \+ 1;", src)
    assert const("kNwin") == cuda_ec.NWIN == ec_rns._NWIN
    assert const("kEntries") == 16 and const("kSlotsPerEntry") == 6
    assert const("kZeroAlphaMax") == 2 * ec_rns._S_SMALL
    assert const("kPrMask") == rns.PR - 1
    body = re.search(r"enum Row : int \{(.*?)\};", src, re.S).group(1)
    names = [n.strip().split("=")[0].strip() for n in body.split(",")]
    norm = lambda n: n.lower().replace("_", "")
    assert [norm(n[1:]) for n in names[: len(ec_rns.LANE_ROWS)]] == \
        [norm(n) for n in ec_rns.LANE_ROWS]
    assert names[len(ec_rns.LANE_ROWS) :] == ["kE1", "kE2", "kRows"]
    assert re.search(r"kE2 = kE1 \+ kK, kRows = kE2 \+ kK", body)
    assert eng.lane.shape == (len(ec_rns.LANE_ROWS) + 2 * eng.k, LANES)


def test_lane_table_holds_the_redundant_channel_on_lane_k(eng):
    k, ctx = eng.k, eng.ctx
    m = Model(eng)
    c = {n: v[0] for n, v in m.c.items()}
    n_all, n_r = ctx.key_rows(P256.p)[:2]
    assert c["pq"][k] == c["pb"][k] == rns.PR and c["muq"][k] == 1 << 20
    assert c["nq"][k] == int(n_r) and c["invM_q"][k] == int(ctx.invM_pr)
    assert c["one_q"][k] == ctx.M % P256.p % rns.PR
    assert list(c["pb"][:k]) == ctx.pb and list(c["pq"][:k]) == ctx.pq
    np.testing.assert_array_equal(c["nq"][:k], np.asarray(n_all[k:], dtype=np.uint64))
    idle = slice(k + 1, LANES)
    assert (c["pb"][idle] == rns.PR).all() and (c["pq"][idle] == rns.PR).all()
    for name in ("neg_ninv_b", "invMi_b", "nq", "invM_q", "invMi_q", "Mq_mod_b", "pinv_b",
                 "one_b", "one_q", "sp_l1_b", "sp_l1_q"):
        assert not c[name][idle].any(), name
    assert not m.e1[:, k + 1 :].any() and not m.e2[:, k + 1 :].any()


def test_barrett_step_is_exact_for_every_channel(eng):
    m = Model(eng)
    rng = np.random.default_rng(1)
    xs = np.concatenate([rng.integers(0, 1 << 32, 4000, dtype=np.uint64),
                         np.array([0, 1, (1 << 32) - 1, (1 << 29) - 1, (1 << 24) - 1], np.uint64)])
    x = np.broadcast_to(xs[:, None], (xs.size, LANES))
    got = m.barrett(x, m.c["pb"], m.c["mub"])
    np.testing.assert_array_equal(got, x % m.c["pb"])
    got = m.barrett(x, m.c["pq"], m.c["muq"])
    np.testing.assert_array_equal(got, x % m.c["pq"])


# -- field ops and group law against the plain versions --------------------------


@pytest.mark.parametrize("inputs", ["random", "all_max", "zeros"])
def test_extension_sums_stay_in_bounds_and_the_product_equals_plain(eng, inputs):
    m = Model(eng)
    a = rand_res(eng, 16, 3, hi=inputs == "all_max")
    b = rand_res(eng, 16, 4, hi=inputs == "all_max")
    if inputs == "zeros":
        a = tuple(x * 0 for x in a)
    assert_same(eng, m.mul(to_lanes(eng, a), to_lanes(eng, b)), eng.fmul(a, b))
    assert m.max_ext < EXT_BOUND
    if inputs == "all_max":  # the bound is near its worst case here
        assert m.max_ext > EXT_BOUND // 8


@pytest.mark.parametrize("op", ["fadd", "fdbl", "fsub_small", "fsub_l1", "fsub_l2"])
def test_channelwise_op_equals_plain(eng, op):
    m = Model(eng)
    a, b = rand_res(eng, 32, 5), rand_res(eng, 32, 6)
    la, lb = to_lanes(eng, a), to_lanes(eng, b)
    if op == "fadd":
        assert_same(eng, m.add(la, lb), eng.fadd(a, b))
    elif op == "fdbl":
        assert_same(eng, m.dbl(la), eng.fdbl(a))
    else:
        s = {"small": ec_rns._S_SMALL, "l1": ec_rns._S_L1, "l2": ec_rns._S_L2}[op[5:]]
        assert_same(eng, m.sub(la, lb, s), eng.fsub(a, b, s))


def test_is_zero_by_lane_agreement(eng):
    m = Model(eng)
    p = P256.p
    vals = [c * p for c in (0, 1, 2, 63, 64, 65, 1000)] + [1, p + 1]
    mk = lambda mods: torch.tensor([[v % q for q in mods] for v in vals], dtype=torch.int64)
    v = (mk(eng.ctx.pb), mk(eng.ctx.pq), mk([4096]))
    got = m.is_zero(to_lanes(eng, v))
    assert got.tolist() == eng.is_zero(v).tolist() == [True] * 5 + [False] * 4


def _edge_lanes(eng):
    P, Q = host_points(5, 2)
    negP = (P[0], (-P[1]) % P256.p)
    A = points(eng, [P, P, P, None, P, None, G, Q])
    B = points(eng, [Q, P, negP, Q, None, None, G, P])
    return A, B


def test_jac_double_equals_plain_and_keeps_the_identity_z_exactly_zero(eng):
    m = Model(eng)
    A, _ = _edge_lanes(eng)
    got = m.jac_double(tuple(to_lanes(eng, c) for c in A))
    for g, w in zip(got, eng.jac_double(*A)):
        assert_same(eng, g, w)
    zb, zq = got[2]
    k = eng.k
    for col in (3, 5):  # the identity columns: Z exactly 0 in every live lane
        assert not zb[col, :k].any() and not zq[col, : k + 1].any()


def test_jac_add_equals_plain_on_the_edge_lanes(eng):
    m = Model(eng)
    A, B = _edge_lanes(eng)
    got = m.jac_add(tuple(to_lanes(eng, c) for c in A), tuple(to_lanes(eng, c) for c in B))
    for g, w in zip(got, eng.jac_add(A, B)):
        assert_same(eng, g, w)
    zb, zq = got[2]
    k = eng.k
    for col in (2, 5):  # P + (−P) and O + O
        assert not zb[col, :k].any() and not zq[col, : k + 1].any()
    assert not m.is_zero(got[2])[[0, 1, 3, 4, 6, 7]].any()


def test_one_hot_blend_reads_every_entry_whatever_the_nibble():
    rng = np.random.default_rng(8)
    tab = rng.integers(0, 4096, (16, 16, 6, LANES)).astype(np.uint16)
    seen = []
    for v in range(16):
        reads = []
        nib = np.full(16, v)
        nib[::3] = (v + 5) % 16
        got = Model.blend(tab, nib, reads)
        want = tab[np.arange(16), nib].astype(np.uint64)
        for i in range(3):
            np.testing.assert_array_equal(got[i][0], want[:, 2 * i])
            np.testing.assert_array_equal(got[i][1], want[:, 2 * i + 1])
        seen.append(reads)
    assert all(r == list(range(16)) for r in seen)
    src = SRC.read_text()
    # The kernel's select: the entry loop is unrolled over all 16 entries and
    # the nibble only forms the mask.
    assert "const uint32_t m = 0u - (uint32_t)(v == (uint32_t)e);" in src
    assert "s[cs] |= (uint32_t)tab[(e * kSlotsPerEntry + cs) * 32 + lane] & m;" in src


def test_model_scalar_mult_equals_plain_and_the_host_curve(eng):
    """The whole kernel schedule in the model: uint16 table, 64 windows,
    blend, bit-identical to the plain version, and k·P on the host curve."""
    m = Model(eng)
    pts = [G, host_points(9, 1)[0], None, G]
    ks = [N - 1, random.Random(10).randrange(N), 7, 2]
    block = np.zeros((3, 2 * eng.k + 1, 4), dtype=np.int32)
    eng.encode_points_into(pts, block)
    nib = ec_rns._nibbles(ks)
    P = eng.unstack(torch.from_numpy(block))
    got = m.scalar_mult(tuple(to_lanes(eng, c) for c in P), nib)
    plain = eng.unstack(ec_rns._scalar_mult(eng, torch.from_numpy(block), torch.from_numpy(nib)))
    for g, w in zip(got, plain):
        assert_same(eng, g, w)
    assert m.max_ext < EXT_BOUND
    decoded = eng.decode_points(eng.stack(tuple(from_lanes(eng, c) for c in got)).numpy())
    assert decoded == [P256.scalar_mult(p, k) if p else None for p, k in zip(pts, ks)]
