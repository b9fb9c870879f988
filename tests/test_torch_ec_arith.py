"""A model of K5's arithmetic (``ops/csrc/ec_p256.cu``) in its fragment
layout, in numpy.

K5 runs a group of 8 P-256 scalar mults per block of 2 warps: rns_mma.cuh's
Chain at k = 27, one warp per 16-channel M tile, the 8 points as the
mma's N.  Thread (warp, lane = 4g + t) holds 4 (channel, slot) pairs,
p = 2h + cs: channel j = 16·warp + g + 8h of B and B′ and slot 2t + cs,
and per slot its 2^12 residue; the 2^12 channel is output j = k of both
extensions (tile 1, g = 3, h = 1), and channels past it are inert (p = 1,
constants 0).  The CUDA kernel cannot run on the CPU, so this file models
it step for step in that layout, on the constants the kernel reads
(``rns.consts(16, 256).kern``, P-256's key rows ``eng.ukey`` and the field
table ``eng.field``): the Barrett and Shoup steps, each base extension
through the m16n8k32 s8 fragments (the model of
``tests/test_torch_k2_arith.py``) with its Karatsuba recombination and
bounds, α from the thread at j = k, ``is_zero`` as a per-slot (min, max)
over xor shuffles and both warps, the per-slot selects of the group law,
the uint16 window table and the one-hot blend, and the kernel's one loop
of doubling and add steps.  The model is held against the plain versions
(``ec_rns._P256RNS``'s ``fmul``/``is_zero``/``jac_double``/``jac_add``
and ``_scalar_mult``) bit for bit, and a whole scalar mult against the
host curve.

A number is the triplet (b, q, r) of uint64 arrays (G groups, 64 threads,
4 pairs) and (G, 64, 2 slots).
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
from test_torch_k2_arith import mma_m16n8k32
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CSRC = Path(__file__).resolve().parents[1] / "bftkv_tpu_torch" / "ops" / "csrc"
SRC = CSRC / "ec_p256.cu"
M32 = np.uint64(0xFFFFFFFF)
MASK = np.uint64(rns.PR - 1)
EXT_BOUND = 1 << 29  # an extension sum's bound: 27 · 4095² < 2^29
PLANE_BOUND = 1 << 22  # a Karatsuba plane product's bound
SLOTS = 8
SSTRIDE = 48  # rns_mma Geo: sigma's plane stride at one K step
G = (P256.gx, P256.gy)
N = P256.n
STEPS = 14 + 64 * 5
Q_ROW, ROWS = 28, 55  # the window table's rows of one coordinate: B at j <= k, B' at k + 1 + j
FIELD_Q, FIELD_COLS, R_COL = 32, 68, 64


@pytest.fixture(scope="module")
def eng():
    return ec_rns.engine("cpu")


@pytest.fixture(scope="module")
def model(eng):
    return Model(eng)


def u64(t) -> np.ndarray:
    """int32 words (a tensor or an array of uint32 bit patterns) → uint64."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.astype(np.int64).astype(np.uint64) & M32


def _bytes(words: np.ndarray) -> np.ndarray:
    """uint32 words (..., n) → their 4 bytes each as signed int8, lowest first."""
    return np.ascontiguousarray(words, dtype="<u4").view(np.int8).reshape(*words.shape, 4)


def _fragment_maps():
    """PTX's m16n8k32 layouts as index arrays: A element (lane, register,
    byte) at (row, column), B element (lane, register, byte) at (k row,
    column), C element (lane, i) at (row, column)."""
    lane, reg, byte = np.meshgrid(np.arange(32), np.arange(4), np.arange(4), indexing="ij")
    grp, tid = lane >> 2, lane & 3
    a_row = grp + 8 * (reg & 1)
    a_col = 4 * tid + 16 * (reg >> 1) + byte
    lane, reg, byte = np.meshgrid(np.arange(32), np.arange(2), np.arange(4), indexing="ij")
    b_row = 4 * (lane & 3) + 16 * reg + byte
    b_col = lane >> 2
    lane, i = np.meshgrid(np.arange(32), np.arange(4), indexing="ij")
    c_row = (lane >> 2) + 8 * (i >> 1)
    c_col = 2 * (lane & 3) + (i & 1)
    return a_row, a_col, b_row, b_col, c_row, c_col


A_ROW, A_COL, B_ROW, B_COL, C_ROW, C_COL = _fragment_maps()


def mma_fast(a_regs: np.ndarray, b_regs: np.ndarray) -> np.ndarray:
    """mma.m16n8k32 s8 with a zero accumulator, batched over leading axes:
    a_regs (..., 32, 4), b_regs (..., 32, 2) uint32 → C (..., 32, 4) int64,
    through the same PTX layouts as ``mma_m16n8k32`` (held against it)."""
    lead = a_regs.shape[:-2]
    ab = _bytes(a_regs).astype(np.int64)
    bb = _bytes(b_regs).astype(np.int64)
    A = np.zeros(lead + (16, 32), np.int64)
    B = np.zeros(lead + (32, 8), np.int64)
    A[..., A_ROW, A_COL] = ab
    B[..., B_ROW, B_COL] = bb
    return (A @ B)[..., C_ROW, C_COL]


def vmin2(a, b):
    lo = np.minimum(a & 0xFFFF, b & 0xFFFF)
    return lo | (np.minimum(a >> 16, b >> 16) << np.uint64(16))


def vmax2(a, b):
    lo = np.maximum(a & 0xFFFF, b & 0xFFFF)
    return lo | (np.maximum(a >> 16, b >> 16) << np.uint64(16))


class Model:
    """The kernel's Field on its 64 threads, for G groups of 8 points."""

    def __init__(self, eng, exact_mma: bool = False):
        self.eng = eng
        self.k = k = eng.k
        self.exact_mma = exact_mma
        kc = eng.cn.kern
        th = np.arange(64)
        self.warp, lane = th >> 5, th & 31
        self.g, self.t = lane >> 2, lane & 3
        self.j = self.warp[:, None] * 16 + self.g[:, None] + 8 * np.arange(2)[None, :]  # (64, 2)
        self.chan, self.red = self.j < k, self.j == k
        self.slot = 2 * self.t[:, None] + np.arange(2)[None, :]  # (64, 2)
        hp = np.array([0, 0, 1, 1])  # pair p → h
        self.jp, self.cp = self.j[:, hp], self.chan[:, hp]  # (64, 4)
        self.slot_p = self.slot[:, [0, 1, 0, 1]]
        x = np.where(self.cp, self.jp, 0)

        def per_pair(vec, off=0, inert=0):
            v = u64(vec)[off + x]
            return np.where(self.cp, v, np.uint64(inert))

        self.pb, self.pq = per_pair(kc["p_all"], 0, 1), per_pair(kc["p_all"], k, 1)
        self.mub, self.muq = per_pair(kc["mu_all"], 0, M32), per_pair(kc["mu_all"], k, M32)
        for name in ("invMi_b", "Mq_mod_b", "invM_q"):
            setattr(self, name, per_pair(kc[name]))
            setattr(self, name + "_sh", per_pair(kc[name + "_sh"]))
        self.invMi_q = per_pair(kc["invMi_q"])
        n_all, n_r, nnb = (u64(u)[0] for u in eng.ukey[:3])
        self.nq = per_pair(n_all, k)
        # Chain::init's folded multipliers: σ over B is d·(−N⁻¹·(M/m_j)⁻¹),
        # σ over B′ is (d + q̂N)·(M⁻¹·(M′/m_j)⁻¹), each mod p_j.
        self.qsig = self.barrett(per_pair(nnb) * self.invMi_b, self.pb, self.mub)
        self.rsig = self.barrett(self.invM_q * self.invMi_q, self.pq, self.muq)
        shoup_const = lambda w, p: (w << np.uint64(32)) // p
        self.qsig_sh, self.rsig_sh = shoup_const(self.qsig, self.pb), shoup_const(self.rsig, self.pq)
        self.nq_sh = shoup_const(self.nq, self.pq)
        self.nr = n_r[0]
        self.invMq_pr, self.invM_pr = np.uint64(eng.cn.invMq_pr), np.uint64(eng.cn.invM_pr)
        self.E = eng.cn.kern["E_mma"].numpy()  # (2, 2, 2 tiles, 1, 32, 16) int8
        # The field table as the kernel stages it: B at column j, B' at 32 + j,
        # the 2^12 channel at 64; zero elsewhere.
        f = u64(eng.field)
        sf = np.zeros((f.shape[0], FIELD_COLS), np.uint64)
        sf[:, :k], sf[:, FIELD_Q : FIELD_Q + k], sf[:, R_COL] = f[:, :k], f[:, k : 2 * k], f[:, 2 * k]
        self.sf = sf
        self.rows = {n: i for i, n in enumerate(ec_rns.FIELD_ROWS)}
        self.max_ext = self.max_plane = 0
        self.reads: list | None = None

    # -- word arithmetic --------------------------------------------------------

    @staticmethod
    def reduce(r, p):
        """rns_mma's reduce: min(r, r − p) in uint32, r mod p for r < 2p."""
        assert (r < 2 * p).all()  # one conditional subtraction is enough
        return np.minimum(r, (r - p) & M32)

    @classmethod
    def barrett(cls, x, p, mu):
        assert (x <= M32).all()
        return cls.reduce((x - ((x * mu) >> np.uint64(32)) * p) & M32, p)

    @classmethod
    def shoup(cls, a, w, w_sh, p):
        assert (a <= M32).all()
        return cls.reduce(((a * w) - ((a * w_sh) >> np.uint64(32)) * p) & M32, p)

    def field(self, row: str, which: str):
        """Field-table constants at this thread's pairs ((64, 4), b or q) or
        the 2^12 channel's (a scalar)."""
        r = self.sf[self.rows[row]]
        if which == "r":
            return r[R_COL]
        return r[self.jp + (FIELD_Q if which == "q" else 0)]

    # -- the base extension through the fragments -----------------------------

    def extend(self, e: int, sigma: np.ndarray) -> np.ndarray:
        """S[p] = Σ_i σ[slot][i]·E_e[i][j] at every thread's pairs, exact:
        σ as int8 planes [slot][i] (put_sigma), B fragments read from them,
        three plane products a tile and S = ll + 64·(ss − ll − hh) + 4096·hh
        mod 2^32."""
        lead = sigma.shape[0]
        sig = np.zeros((lead, 2, SLOTS, SSTRIDE), np.uint8)
        gi = np.arange(lead)[:, None, None]
        sig[gi, 0, self.slot_p[None], self.jp[None]] = (sigma & np.uint64(63)).astype(np.uint8)
        sig[gi, 1, self.slot_p[None], self.jp[None]] = (sigma >> np.uint64(6)).astype(np.uint8)
        words = sig.view("<u4")  # (G, 2, 8, 12)
        grp, tid = np.arange(32) >> 2, np.arange(32) & 3
        b = [np.stack([words[:, pl, grp, tid], words[:, pl, grp, 4 + tid]], -1) for pl in (0, 1)]
        S = np.zeros((lead, 64, 4), np.uint64)
        for w in range(2):  # warp w runs M tile w
            al = self.E[e, 0, w, 0].view("<u4")  # (32 lanes, 4 words)
            ah = self.E[e, 1, w, 0].view("<u4")
            add = lambda x, y: ((x.astype(np.uint64) + y) & M32).astype(np.uint32)
            parts = []
            for a, bb in ((al, b[0]), (ah, b[1]), (add(al, ah), add(b[0], b[1]))):
                if self.exact_mma:
                    c = np.stack([mma_m16n8k32(a, x, np.zeros((32, 4), np.int32)) for x in bb])
                else:
                    c = mma_fast(np.broadcast_to(a, (lead,) + a.shape), bb)
                parts.append(c.astype(np.int64))
            ll, hh, ss = parts
            self.max_plane = max(self.max_plane, int(max(x.max() for x in parts)))
            assert all((x >= 0).all() and (x < PLANE_BOUND).all() for x in parts)
            s = (ll + (((ss - ll - hh) & 0xFFFFFFFF) << 6) + (hh << 12)) & 0xFFFFFFFF
            S[:, 32 * w : 32 * w + 32] = s.astype(np.uint64)
        self.max_ext = max(self.max_ext, int(S.max()))
        assert (S < EXT_BOUND).all()
        return S

    def red_of(self, S):
        """Per slot, the sum at the pair j = k (meaningful at its thread)."""
        return np.where(self.red[None, :, 1:2], S[..., 2:4], S[..., 0:2])

    def mul(self, a, b):
        """Chain::mont: a·b·M⁻¹ mod p in RNS (Bajard AMM + Shenoy)."""
        br, sh = self.barrett, self.shoup
        dq = br(a[1] * b[1], self.pq, self.muq)
        db = br(a[0] * b[0], self.pb, self.mub)
        sig0 = sh(db, self.qsig, self.qsig_sh, self.pb)
        dr = (a[2] * b[2]) & MASK
        S = self.extend(0, sig0)
        tq = sh(br(S, self.pq, self.muq), self.nq, self.nq_sh, self.pq)
        x = self.reduce(dq + tq, self.pq)
        rq = sh(x, self.invM_q, self.invM_q_sh, self.pq)
        sig1 = sh(x, self.rsig, self.rsig_sh, self.pq)
        qr = self.red_of(S) & MASK
        rr = (((dr + qr * self.nr) & MASK) * self.invM_pr) & MASK
        S = self.extend(1, sig1)
        # alpha[slot] from the thread at j = k, through shared memory.
        red_th = np.flatnonzero(self.red.any(axis=1))
        al = (((self.red_of(S) - rr) & MASK) * self.invMq_pr) & MASK  # (G, 64, 2)
        alpha = np.zeros((S.shape[0], SLOTS), np.uint64)
        alpha[:, self.slot[red_th].ravel()] = al[:, red_th].reshape(S.shape[0], -1)
        eb = br(S, self.pb, self.mub)
        corr = sh(alpha[:, self.slot_p], self.Mq_mod_b, self.Mq_mod_b_sh, self.pb)
        return self.reduce(eb + self.pb - corr, self.pb), rq, rr

    # -- channelwise ops ---------------------------------------------------------

    def add(self, a, b):
        return (self.reduce(a[0] + b[0], self.pb), self.reduce(a[1] + b[1], self.pq),
                (a[2] + b[2]) & MASK)

    def dbl(self, a):
        return self.add(a, a)

    def sub(self, a, b, s: str):
        x = self.reduce(a[0] + self.pb - b[0], self.pb) + self.field(s, "b")
        y = self.reduce(a[1] + self.pq - b[1], self.pq) + self.field(s, "q")
        return (self.reduce(x, self.pb), self.reduce(y, self.pq),
                (a[2] - b[2] + self.field(s, "r")) & MASK)

    # -- is_zero per slot --------------------------------------------------------

    def is_zero4(self, vals):
        """Per-slot masks (G, 64, 2) of each v ≡ 0 (mod p): w over B at each
        thread's pairs, the slot pair as uint16 halves, (min, max) over the
        warp's lanes by xor shuffles 4, 8, 16, over both warps through shared
        memory; zero iff min == max <= 64."""
        pinv = self.field("pinv_b", "b")
        lanes = np.arange(32)
        out = []
        for v in vals:
            w = self.barrett(v[0] * pinv, self.pb, self.mub)  # (G, 64, 4)
            lo = np.full(w.shape[:2], M32, np.uint64)
            hi = np.zeros(w.shape[:2], np.uint64)
            for h in range(2):
                w2 = w[..., 2 * h] | (w[..., 2 * h + 1] << np.uint64(16))
                lo = np.where(self.chan[:, h], vmin2(lo, w2), lo)
                hi = np.where(self.chan[:, h], vmax2(hi, w2), hi)
            lo, hi = lo.reshape(-1, 2, 32), hi.reshape(-1, 2, 32)
            for off in (4, 8, 16):
                lo, hi = vmin2(lo, lo[..., lanes ^ off]), vmax2(hi, hi[..., lanes ^ off])
            zs_lo, zs_hi = lo[..., :4], hi[..., :4]  # lanes g = 0 write (warp, t)
            lo = vmin2(zs_lo[:, 0], zs_lo[:, 1])[:, self.t]  # (G, 64): this thread's t
            hi = vmax2(zs_hi[:, 0], zs_hi[:, 1])[:, self.t]
            z = np.zeros(lo.shape + (2,), bool)
            for cs in range(2):
                lh, hh = (lo >> np.uint64(16 * cs)) & 0xFFFF, (hi >> np.uint64(16 * cs)) & 0xFFFF
                z[..., cs] = (lh == hh) & (hh <= 2 * ec_rns._S_SMALL)
            out.append(z)
        return out

    @staticmethod
    def pick(m, a, b):
        """Per-slot select of a where m (G, 64, 2), else b."""
        mp = m[..., [0, 1, 0, 1]]
        return (np.where(mp, a[0], b[0]), np.where(mp, a[1], b[1]), np.where(m, a[2], b[2]))

    # -- the group law -------------------------------------------------------------

    def mul_n(self, a, b):
        """One round of independent products (the kernel's mont_n)."""
        return [self.mul(x, y) for x, y in zip(a, b)]

    def jac_double(self, P):
        """The kernel's jac_double in its rounds: (δ, γ, YZ), (Xγ, α, γ²),
        (α²), (α·(4β − X3))."""
        X, Y, Z = P
        delta, gamma, yz = self.mul_n((Z, Y, Y), (Z, Y, Z))
        Z3 = self.dbl(yz)
        t0 = self.sub(X, delta, "sp_l1")
        t1 = self.add(X, delta)
        beta, alpha, g2 = self.mul_n((X, t0, gamma), (gamma, self.add(self.dbl(t1), t1), gamma))
        beta4 = self.dbl(self.dbl(beta))
        X3 = self.sub(self.mul(alpha, alpha), self.dbl(beta4), "sp_l1")
        Y3 = self.sub(self.mul(alpha, self.sub(beta4, X3, "sp_l2")),
                      self.dbl(self.dbl(self.dbl(g2))), "sp_l1")
        return X3, Y3, Z3

    def add_part(self, A, B):
        """The kernel's add_part, in its rounds: W (B where A = O, A where
        B = O, O where A = −B, else A + B) and the per-slot mask of A = B."""
        Z1Z1, Z2Z2, Y1Z2 = self.mul_n((A[2], B[2], A[1]), (A[2], B[2], B[2]))
        Y2Z1, U1, U2 = self.mul_n((B[1], A[0], B[0]), (A[2], Z2Z2, Z1Z1))
        S1, S2, Z1Z2 = self.mul_n((Y1Z2, Y2Z1, A[2]), (Z2Z2, Z1Z1, B[2]))
        H, R = self.sub(U2, U1, "sp_small"), self.sub(S2, S1, "sp_small")
        inf1, inf2, zh, zr = self.is_zero4((A[2], B[2], H, R))
        H2, RR, Z3 = self.mul_n((H, R, Z1Z2), (H, R, H))
        H3, U1H2 = self.mul_n((H2, U1), (H, H2))
        X3 = self.sub(self.sub(RR, H3, "sp_l1"), self.dbl(U1H2), "sp_l1")
        S1H3, yprod = self.mul_n((S1, R), (H3, self.sub(U1H2, X3, "sp_l2")))
        Y3 = self.sub(yprod, S1H3, "sp_l1")
        same_x = zh & ~inf1 & ~inf2
        is_dbl, to_inf = same_x & zr, same_x & ~zr
        zero = tuple(np.zeros_like(x) for x in Z3)
        gen = (X3, Y3, self.pick(to_inf, zero, Z3))
        W = tuple(self.pick(inf1, b, self.pick(inf2, a, w)) for a, b, w in zip(A, B, gen))
        return W, is_dbl

    def jac_add(self, A, B):
        W, is_dbl = self.add_part(A, B)
        D = self.jac_double(A)
        return tuple(self.pick(is_dbl, d, w) for d, w in zip(D, W))

    # -- the window table and the blend --------------------------------------------

    def new_table(self, groups: int) -> np.ndarray:
        return np.zeros((groups, 16, 3, ROWS, 4), np.uint64)  # uint32 words

    def put(self, tab, e, P):
        """Rows j <= k of B (the 2^12 residue at row k) and j < k of B′;
        inert positions store nothing."""
        for c, v in enumerate(P):
            for h in range(2):
                live, red = self.chan[:, h], self.red[:, h]
                b = v[0][..., 2 * h] | (v[0][..., 2 * h + 1] << np.uint64(16))
                r = v[2][..., 0] | (v[2][..., 1] << np.uint64(16))
                q = v[1][..., 2 * h] | (v[1][..., 2 * h + 1] << np.uint64(16))
                tab[:, e, c, self.j[red, h], self.t[red]] = r[:, red]
                tab[:, e, c, self.j[live, h], self.t[live]] = b[:, live]
                tab[:, e, c, Q_ROW + self.j[live, h], self.t[live]] = q[:, live]

    def select(self, tab, nib):
        """The kernel's blend: all 16 entries read, at addresses fixed by
        entry and position, masked by the slots' nibbles (G, 64, 2)."""
        v = np.zeros(tab.shape[:1] + (3, 4, 64), np.uint64)
        for e in range(16):
            if self.reads is not None:
                self.reads.append(e)
            m = (np.where(nib[..., 0] == e, 0xFFFF, 0) | np.where(nib[..., 1] == e, 0xFFFF0000, 0)
                 ).astype(np.uint64)
            for h in range(2):
                bl, ql = self.chan[:, h] | self.red[:, h], self.chan[:, h]
                bw = tab[:, e, :, np.where(bl, self.j[:, h], 0), self.t].transpose(1, 2, 0)
                qw = tab[:, e, :, Q_ROW + np.where(ql, self.j[:, h], 0), self.t].transpose(1, 2, 0)
                v[:, :, h] |= np.where(bl, m[:, None] & bw, 0)
                v[:, :, 2 + h] |= np.where(ql, m[:, None] & qw, 0)
        out = []
        for c in range(3):
            half = lambda w, cs: (w >> np.uint64(16 * cs)) & 0xFFFF
            b = np.stack([np.where(self.red[:, p >> 1], 0, half(v[:, c, p >> 1], p & 1))
                          for p in range(4)], -1)
            q = np.stack([half(v[:, c, 2 + (p >> 1)], p & 1) for p in range(4)], -1)
            rw = np.where(self.red[:, 1], v[:, c, 1], v[:, c, 0])
            out.append((b, q, np.stack([half(rw, 0), half(rw, 1)], -1)))
        return tuple(out)

    def identity(self, groups: int):
        one = (np.broadcast_to(self.field("one", "b"), (groups, 64, 4)).copy(),
               np.broadcast_to(self.field("one", "q"), (groups, 64, 4)).copy(),
               np.full((groups, 64, 2), self.field("one", "r"), np.uint64))
        zero = tuple(np.zeros_like(x) for x in one)
        return one, one, zero

    # -- the block's loads, stores and the kernel's loop --------------------------

    def load(self, block: np.ndarray):
        """(3, 2k+1, T) residues → G = ⌈T/8⌉ groups; slots past T copy T − 1."""
        k, t = self.k, block.shape[-1]
        groups = -(-t // SLOTS)
        col = np.minimum(np.arange(groups)[:, None, None] * SLOTS + self.slot_p[None], t - 1)
        colr = np.minimum(np.arange(groups)[:, None, None] * SLOTS + self.slot[None], t - 1)
        x = np.where(self.cp, self.jp, 0)[None]
        blk = block.astype(np.int64).astype(np.uint64)
        return tuple((np.where(self.cp, blk[c, x, col], 0), np.where(self.cp, blk[c, k + x, col], 0),
                      blk[c, 2 * k][colr]) for c in range(3))

    def store(self, P, t: int, sentinel: int) -> np.ndarray:
        k = self.k
        out = np.full((3, 2 * k + 1, t), sentinel, np.int64)
        groups = P[0][0].shape[0]
        for c, v in enumerate(P):
            for gi in range(groups):
                for th in range(64):
                    for p in range(4):
                        h, cs = p >> 1, p & 1
                        pt = gi * SLOTS + self.slot[th, cs]
                        if pt >= t:
                            continue
                        if self.chan[th, h]:
                            out[c, self.j[th, h], pt] = v[0][gi, th, p]
                            out[c, k + self.j[th, h], pt] = v[1][gi, th, p]
                        elif self.red[th, h]:
                            out[c, 2 * k, pt] = v[2][gi, th, cs]
        return out

    def scalar_mult(self, block: np.ndarray, nib: np.ndarray, sentinel: int = -1) -> np.ndarray:
        """The kernel: table t[0] = O, t[1] = P, then one loop of 334 steps
        (14 table adds, then per window 4 doublings and an add), each a
        doubling and, on add steps, add_part and the per-slot select."""
        t = block.shape[-1]
        A = self.load(block)
        groups = A[0][0].shape[0]
        col = np.minimum(np.arange(groups)[:, None, None] * SLOTS + self.slot[None], t - 1)
        tab = self.new_table(groups)
        self.put(tab, 0, self.identity(groups))
        self.put(tab, 1, A)
        for s in range(STEPS):
            u = s - 14
            if s == 14:
                A = self.identity(groups)
            add_step = s < 14 or u % 5 == 4
            if add_step:
                v = np.ones((groups, 64, 2), np.int64) if s < 14 else nib[u // 5][col]
                W, is_dbl = self.add_part(A, self.select(tab, v))
            D = self.jac_double(A)
            A = tuple(self.pick(is_dbl, d, w) for d, w in zip(D, W)) if add_step else D
            if s < 14:
                self.put(tab, s + 2, A)
        return self.store(A, t, sentinel)


# -- conversions between the plain triplets and the fragment layout -------------


def to_frag(model, eng, trips):
    """Plain triplets of X, Y, Z (b (T,k), q (T,k), r (T,1)) → the groups'
    fragment numbers, as the kernel loads them."""
    return model.load(eng.stack(trips).numpy())


def frag_to_plain(model, eng, P, t):
    return eng.unstack(torch.from_numpy(model.store(P, t, -1).astype(np.int32)))


def num_to_plain(model, eng, v, t):
    zero = tuple(np.zeros_like(x) for x in v)
    return frag_to_plain(model, eng, (v, zero, zero), t)[0]


def assert_same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def rand_res(eng, t, seed, hi=False):
    """Seeded residues (``hi``: every channel at p − 1, the sums' worst case)."""
    rng = np.random.default_rng(seed)
    ctx = eng.ctx
    pick = lambda p, n: np.full(n, p - 1) if hi else rng.integers(0, p, n)
    b = np.stack([pick(p, t) for p in ctx.pb], axis=1)
    q = np.stack([pick(p, t) for p in ctx.pq], axis=1)
    r = pick(4096, (t, 1)).reshape(t, 1)
    return tuple(torch.from_numpy(x.astype(np.int64)) for x in (b, q, r))


def num(model, eng, trip):
    """One plain number → its fragment number (as the X of a point)."""
    zero = tuple(torch.zeros_like(x) for x in trip)
    return to_frag(model, eng, (trip, zero, zero))[0]


def points(eng, pts):
    block = np.zeros((3, 2 * eng.k + 1, len(pts)), dtype=np.int32)
    eng.encode_points_into(pts, block)
    return eng.unstack(torch.from_numpy(block))


def host_points(seed, count):
    rng = random.Random(seed)
    return [P256.scalar_base_mult(rng.randrange(1, N)) for _ in range(count)]


# -- the kernel's layout constants ----------------------------------------------


def test_group_constants_match_the_kernel_source(eng):
    src = SRC.read_text()
    const = lambda name, text=src: int(re.search(rf"constexpr \w+ {name} = (\d+)", text).group(1))
    assert const("kK") == eng.k == 27
    assert re.search(r"constexpr int kChan = 2 \* kK \+ 1;", src)
    assert const("kNwin") == cuda_ec.NWIN == ec_rns._NWIN
    assert const("kEntries") == 16
    assert re.search(r"constexpr int kSteps = kTableAdds \+ kNwin \* 5;", src)
    assert re.search(r"constexpr int kTableAdds = kEntries - 2;", src)
    assert re.search(r"constexpr int kQRow = kK \+ 1;", src) and Q_ROW == eng.k + 1
    assert re.search(r"constexpr int kRows = kQRow \+ kK;", src) and ROWS == 2 * eng.k + 1
    assert const("kFieldCols") == FIELD_COLS and const("kRCol") == R_COL
    assert const("kFieldQ") == FIELD_Q
    assert const("kZeroAlphaMax") == 2 * ec_rns._S_SMALL
    assert const("kSlots", (CSRC / "rns_mma.cuh").read_text()) == SLOTS
    body = re.search(r"enum FieldRow : int \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in body.split(",")]
    norm = lambda n: n.lower().replace("_", "")
    assert [norm(n[1:]) for n in names[:-1]] == [norm(n) for n in ec_rns.FIELD_ROWS]
    assert names[-1] == "kFieldRows"
    assert eng.field.shape == (len(ec_rns.FIELD_ROWS), 2 * eng.k + 1)
    # Two M tiles of 16 and one K step of 32: two warps, channels j < 32.
    assert rns.mma_dims(eng.k) == (2 * 16, 32) and FIELD_Q == rns.mma_dims(eng.k)[0]
    assert "__launch_bounds__(64)" in src and "__shfl_sync" not in src


def test_fragment_layout_holds_the_redundant_channel_at_tile_1_g3_h1(model, eng):
    k = eng.k
    m = model
    red = np.argwhere(m.red)
    assert [(int(m.warp[th]), int(m.g[th]), int(h)) for th, h in red] == [(1, 3, 1)] * 4
    assert sorted(int(m.t[th]) for th, _ in red) == [0, 1, 2, 3]
    # Every (channel j < k, slot) pair of a group is held exactly once.
    held = {(int(m.jp[th, p]), int(m.slot_p[th, p])) for th in range(64) for p in range(4)
            if m.cp[th, p]}
    assert held == {(j, s) for j in range(k) for s in range(SLOTS)}
    assert int(m.cp.sum()) == k * SLOTS
    # Inert pairs (j > k and the B/B' values at j = k): p = 1, constants 0.
    inert = ~m.cp
    assert (m.pb[inert] == 1).all() and (m.pq[inert] == 1).all() and (m.mub[inert] == M32).all()
    for name in ("invMi_b", "invMi_q", "Mq_mod_b", "invM_q", "qsig", "rsig", "nq"):
        assert not getattr(m, name)[inert].any(), name
    for row in ec_rns.FIELD_ROWS:
        assert not m.field(row, "b")[inert].any() and not m.field(row, "q")[inert].any(), row
    assert int(m.nr) == int(eng.ctx.key_rows(P256.p)[1])
    assert m.field("one", "r") == eng.ctx.M % P256.p % rns.PR
    # The table: every stored word is one thread's own, and every row is used.
    spots = [(int(m.j[th, h]), int(m.t[th])) for th in range(64) for h in range(2)
             if m.chan[th, h] or m.red[th, h]]
    spots += [(Q_ROW + int(m.j[th, h]), int(m.t[th])) for th in range(64) for h in range(2)
              if m.chan[th, h]]
    assert len(spots) == len(set(spots)) == ROWS * 4


def test_barrett_and_shoup_steps_are_exact_for_every_channel(model):
    m = model
    rng = np.random.default_rng(1)
    xs = np.concatenate([rng.integers(0, 1 << 32, 3000, dtype=np.uint64),
                         np.array([0, 1, (1 << 32) - 1, (1 << 29) - 1, (1 << 24) - 1], np.uint64)])
    x = np.broadcast_to(xs[:, None, None], (xs.size, 64, 4))
    for p, mu in ((m.pb, m.mub), (m.pq, m.muq)):
        np.testing.assert_array_equal(m.barrett(x, p, mu), x % p)
    a = x & np.uint64((1 << 24) - 1)  # Shoup's operands are residue products < 2^24
    for w, w_sh, p in ((m.qsig, m.qsig_sh, m.pb), (m.rsig, m.rsig_sh, m.pq),
                       (m.nq, m.nq_sh, m.pq), (m.invM_q, m.invM_q_sh, m.pq),
                       (m.Mq_mod_b, m.Mq_mod_b_sh, m.pb)):
        np.testing.assert_array_equal(m.shoup(a, w, w_sh, p), (a * w) % p)


def test_vectorised_fragments_equal_the_per_lane_mma():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 1 << 32, (3, 32, 4), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, (3, 32, 2), dtype=np.uint64).astype(np.uint32)
    want = np.stack([mma_m16n8k32(a[i], b[i], np.zeros((32, 4), np.int32)) for i in range(3)])
    np.testing.assert_array_equal(mma_fast(a, b), want.astype(np.int64))


@pytest.mark.parametrize("inputs", ["random", "all_max", "zeros"])
def test_fragment_extension_equals_the_plain_dot_and_stays_in_bounds(eng, inputs):
    """σ (8 slots, k) at the threads' pairs → S through the per-lane mma of
    tests/test_torch_k2_arith.py, against rns._dot, exactly."""
    m = Model(eng, exact_mma=True)
    rng = np.random.default_rng(7)
    cn = eng.cn
    for e, (ps, E) in enumerate(((cn.pb, cn.E1f), (cn.pq, cn.E2f))):
        p = ps.numpy()
        sigma = {"random": rng.integers(0, p, (SLOTS, eng.k)), "zeros": np.zeros((SLOTS, eng.k)),
                 "all_max": np.broadcast_to(p - 1, (SLOTS, eng.k))}[inputs].astype(np.int64)
        want = rns._dot(torch.as_tensor(sigma), E).numpy()  # (8, k+1)
        frag = np.where(m.cp, sigma[m.slot_p, np.where(m.cp, m.jp, 0)], 0).astype(np.uint64)
        S = m.extend(e, frag[None])[0]
        live = m.jp <= eng.k
        np.testing.assert_array_equal(S[live], want[m.slot_p[live], m.jp[live]])
        assert not S[~live].any()
    assert m.max_ext < EXT_BOUND and m.max_plane < PLANE_BOUND
    if inputs == "all_max":  # the bound is near its worst case here
        assert m.max_ext > EXT_BOUND // 8


@pytest.mark.parametrize("inputs", ["random", "all_max", "zeros"])
def test_product_through_the_fragments_equals_plain(model, eng, inputs):
    a = rand_res(eng, 16, 3, hi=inputs == "all_max")
    b = rand_res(eng, 16, 4, hi=inputs == "all_max")
    if inputs == "zeros":
        a = tuple(x * 0 for x in a)
    got = model.mul(num(model, eng, a), num(model, eng, b))
    assert_same(num_to_plain(model, eng, got, 16), eng.fmul(a, b))
    assert model.max_ext < EXT_BOUND


@pytest.mark.parametrize("op", ["fadd", "fdbl", "fsub_small", "fsub_l1", "fsub_l2"])
def test_channelwise_op_equals_plain(model, eng, op):
    a, b = rand_res(eng, 16, 5), rand_res(eng, 16, 6)
    fa, fb = num(model, eng, a), num(model, eng, b)
    if op == "fadd":
        got, want = model.add(fa, fb), eng.fadd(a, b)
    elif op == "fdbl":
        got, want = model.dbl(fa), eng.fdbl(a)
    else:
        s = {"small": ec_rns._S_SMALL, "l1": ec_rns._S_L1, "l2": ec_rns._S_L2}[op[5:]]
        got, want = model.sub(fa, fb, "sp_" + op[5:]), eng.fsub(a, b, s)
    assert_same(num_to_plain(model, eng, got, 16), want)


def test_is_zero_per_slot_equals_plain(model, eng):
    p = P256.p
    vals = [c * p for c in (0, 1, 2, 63, 64, 65, 1000)] + [1, p + 1, 5 * p + 1] + \
        [random.Random(3).randrange(p) for _ in range(6)]
    mk = lambda mods: torch.tensor([[v % q for q in mods] for v in vals], dtype=torch.int64)
    v = (mk(eng.ctx.pb), mk(eng.ctx.pq), mk([4096]))
    want = eng.is_zero(v).tolist()
    assert want[:10] == [True] * 5 + [False] * 5
    (z,) = model.is_zero4([num(model, eng, v)])
    # Every thread holds its two slots' flags; all threads of a slot agree.
    got = [None] * len(vals)
    for gi in range(z.shape[0]):
        for th in range(64):
            for cs in range(2):
                pt = gi * SLOTS + int(model.slot[th, cs])
                assert got[pt] in (None, bool(z[gi, th, cs]))
                got[pt] = bool(z[gi, th, cs])
    assert got == want


def _edge_group(eng):
    """One group of 8 with every edge case of the unified add: A + B, P + P,
    P + (−P), O + Q, P + O, O + O, G + G, and a swapped pair."""
    P, Q = host_points(5, 2)
    negP = (P[0], (-P[1]) % P256.p)
    A = points(eng, [P, P, P, None, P, None, G, Q])
    B = points(eng, [Q, P, negP, Q, None, None, G, P])
    return A, B


def test_jac_double_equals_plain_and_keeps_the_identity_z_exactly_zero(model, eng):
    A, _ = _edge_group(eng)
    got = model.jac_double(to_frag(model, eng, A))
    plain = frag_to_plain(model, eng, got, 8)
    for g_, w in zip(plain, eng.jac_double(*A)):
        assert_same(g_, w)
    for col in (3, 5):  # the identity columns: Z exactly 0 in every channel
        assert not any(x[col].any() for x in plain[2])


def test_jac_add_with_per_slot_selects_equals_plain_on_the_edge_group(model, eng):
    A, B = _edge_group(eng)
    W, is_dbl = model.add_part(to_frag(model, eng, A), to_frag(model, eng, B))
    slot_flag = {int(model.slot[th, cs]): bool(is_dbl[0, th, cs]) for th in range(64)
                 for cs in range(2)}
    assert [slot_flag[s] for s in range(8)] == [False, True] + [False] * 4 + [True, False]
    got = model.jac_add(to_frag(model, eng, A), to_frag(model, eng, B))
    plain = frag_to_plain(model, eng, got, 8)
    for g_, w in zip(plain, eng.jac_add(A, B)):
        assert_same(g_, w)
    for col in (2, 5):  # P + (−P) and O + O: Z exactly 0
        assert not any(x[col].any() for x in plain[2])
    assert not eng.is_zero(plain[2])[[0, 1, 3, 4, 6, 7]].any()


def test_one_hot_blend_reads_every_entry_whatever_the_nibble(model):
    rng = np.random.default_rng(8)
    m = model
    tab = rng.integers(0, 1 << 32, (2, 16, 3, ROWS, 4), dtype=np.uint64)
    for v in range(16):
        m.reads = []
        nib = np.full((2, 64, 2), v)
        nib[1, :, 1] = (v + 5) % 16  # slots differ within a group
        got = m.select(tab, nib)
        m.reads, reads = None, m.reads
        assert reads == list(range(16))
        for gi in range(2):
            for th in range(64):
                for p in range(4):
                    h, cs = p >> 1, p & 1
                    e = int(nib[gi, th, cs])
                    word = lambda row: (int(tab[gi, e, 0, row, m.t[th]]) >> (16 * cs)) & 0xFFFF
                    live = bool(m.chan[th, h])
                    b = word(int(m.j[th, h])) if live else 0
                    q = word(Q_ROW + int(m.j[th, h])) if live else 0
                    assert int(got[0][0][gi, th, p]) == b and int(got[0][1][gi, th, p]) == q
                    if m.red[th, h]:
                        assert int(got[0][2][gi, th, cs]) == word(int(m.j[th, h]))
    src = SRC.read_text()
    # The kernel's select: the loop runs over all 16 entries and the nibble
    # only forms the mask.
    assert "for (int e = 0; e < kEntries; ++e) {" in src
    assert "if (chan[h] || red[h]) v[h] |= m & *word(e, c, j[h]);" in src
    assert "((0u - (uint32_t)(nib[0] == (uint32_t)e)) & 0xFFFFu)" in src


def test_model_scalar_mult_equals_plain_and_the_host_curve(eng):
    """The kernel's whole loop in the model at T=8 (one group: the
    identity, scalars 0, 1, 2, n − 1, a random scalar of a random point,
    and raw windows of n, whose last add is P + (−P)), bit-identical to
    the plain version, nothing written past T, and k·P on the host curve."""
    m = Model(eng)
    P = host_points(9, 1)[0]
    pts = [None, G, G, G, G, P, G, G]
    ks = [5, 0, 1, 2, N - 1, random.Random(10).randrange(N), N, 7]
    block = np.zeros((3, 2 * eng.k + 1, 8), dtype=np.int32)
    eng.encode_points_into(pts, block)
    nib = ec_rns._nibbles(ks)
    nib[:, 6] = [(N >> (4 * (63 - w))) & 0xF for w in range(64)]
    got = m.scalar_mult(block, nib)
    plain = ec_rns._scalar_mult(eng, torch.from_numpy(block), torch.from_numpy(nib)).numpy()
    np.testing.assert_array_equal(got, plain)
    assert not plain[2, :, 6].any()  # raw n: P + (−P), Z exactly 0
    assert m.max_ext < EXT_BOUND and m.max_plane < PLANE_BOUND
    want = [P256.scalar_mult(p, k % N) if p else None for p, k in zip(pts, ks)]
    assert eng.decode_points(got.astype(np.int32)) == want
