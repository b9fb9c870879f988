"""P-256 scalar multiplication on the RNS field core — the port's RNS EC engine.

Counterpart of ``bftkv_tpu/ops/ec_rns.py``.  Field elements live as
residues over P-256's RNS context (``rns.context(16, 256)``: k = 27
primes per base B and B′ plus the 2^12 redundant channel); a field
multiply is the RNS Montgomery product of :func:`rns._mont_mul` with
P-256's prime as the fixed modulus, so the engine reuses it with the
prime's key rows.  The reference's design carries over unchanged:

- values are kept in redundant form (< c·p); adds and subtracts are
  channelwise and do not reduce, and a subtraction adds a fixed multiple
  of p (the three slacks ``_S_SMALL``, ``_S_L1``, ``_S_L2``) to stay
  positive;
- ``is_zero`` is the α-consistency test (v ≡ 0 mod p iff
  w_j = v_j·p⁻¹ mod p_j agrees across B), exact for values below
  (min prime)·p, so the group law only tests fresh values: differences
  of products with the small slack, and Z, which ``jac_double`` keeps
  eligible (Z3 = 2·Y1·Z1) and which stays an exact 0 for the identity;
- scalar mult is a 16-entry window table (15 unified adds) and 64 fixed
  4-bit windows of 4 doublings, a one-hot blend select over all 16
  entries and one unified add — the same schedule for every column.

Two layouts: the plain versions here are channels-last, a number being
the triplet (b (T, k), q (T, k), r (T, 1)) of int64 canonical residues
that :func:`rns._mont_mul` takes; the staged operands and the kernel's
output keep the reference's channel-major block (3, 2k+1, T) — X, Y, Z
on the first axis, the B, B′ and 2^12 rows stacked on the second.

:func:`scalar_mult_hosts` stages points and nibbles into a slot of the
``ec`` width class of :mod:`bftkv_tpu_torch.ops.devbuf` and goes through
:func:`bftkv_tpu_torch.ops.cuda_ec.scalar_mult_cuda`, which launches
kernel K5 (``csrc/ec_p256.cu``) for CUDA tensors and runs
:func:`_scalar_mult` (the plain version) only for CPU tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch.crypto.ec import P256
from bftkv_tpu_torch.ops import devbuf, rns

__all__ = ["LANE_ROWS", "scalar_mult_hosts", "scalar_base_mult_hosts"]

_DIGITS = 16  # 256 bits / 16-bit digits: the context rns.context(16, 256)
_WINDOW = 4
_NWIN = 256 // _WINDOW

# fsub slack multiples of p.  SMALL: for differences of fmul outputs
# (< 30p) that must stay is_zero-eligible.  L1: subtrahend is an fmul
# output or a short add-chain of them (< 2^12·p).  L2: subtrahend is
# itself an L1 fsub output (< 2^14.1·p).
_S_SMALL = 32
_S_L1 = 1 << 14
_S_L2 = 1 << 16

_PR_MASK = rns.PR - 1

#: Rows of the kernel's lane-constant table (``csrc/ec_p256.cu``, enum
#: ``Row``): one int32 per lane of a warp.  Lane j < k owns channel j of B
#: (the ``b`` slot) and of B′ (the ``q`` slot); lane k holds the 2^12
#: channel in its ``q`` slot (modulus 4096, ``nq`` = N mod 2^12,
#: ``invM_q`` = M⁻¹ mod 2^12) and computes the second extension's 2^12
#: output in its ``b`` slot (``pb`` = 4096); lanes past k are idle (moduli
#: 4096, constants 0).  Then the extension matrices, one row per source
#: channel: ``E1[i][lane]`` (B → B′ and 2^12) and ``E2[j][lane]``
#: (B′ → B and 2^12).
LANE_ROWS = (
    "pb", "mub", "pq", "muq", "neg_ninv_b", "invMi_b", "nq", "invM_q", "invMi_q",
    "Mq_mod_b", "pinv_b", "one_b", "one_q", "sp_small_b", "sp_small_q", "sp_l1_b",
    "sp_l1_q", "sp_l2_b", "sp_l2_q", "invMq_pr",
)
LANES = 32


class _P256RNS:
    """Fixed-modulus RNS field context on one device (plain versions)."""

    def __init__(self, device: torch.device):
        ctx = rns.context(_DIGITS, 256)
        self.ctx = ctx
        self.k = k = ctx.k
        self.device = device
        self.cn = rns.consts(_DIGITS, 256, device)
        p = P256.p
        t64 = lambda xs: torch.as_tensor(np.asarray(xs, dtype=np.int64), device=device)
        row = lambda xs: t64(xs).reshape(1, -1)  # (1, w): broadcasts over T
        n_all, n_r, neg_ninv_b = ctx.key_rows(p)[:3]
        # The key tuple rns._mont_mul reads: N over [B | B'], N mod 2^12, -N^-1 over B.
        self.key = (row(n_all), row([n_r]), row(neg_ninv_b))
        self.pinv_b = row([pow(p % q, -1, q) for q in ctx.pb])
        self.moduli = np.asarray(ctx.pb + ctx.pq + [rns.PR], dtype=np.int64)

        def const_of(v: int):
            return (row([v % q for q in ctx.pb]), row([v % q for q in ctx.pq]),
                    row([v % rns.PR]))

        self.sp = {s: const_of(s * p) for s in (_S_SMALL, _S_L1, _S_L2)}
        self.one_m = const_of(ctx.M % p)
        self.zero = const_of(0)
        # Bytes → residues: the weight of byte i in channel j, 256^i mod m_j.
        self.byte_weights = np.asarray(
            [[pow(256, i, int(m)) for m in self.moduli] for i in range(32)], dtype=np.int64
        )
        self.lane = torch.as_tensor(lane_table(ctx), device=device)
        if device.type == "cuda":
            # Built on the first caller's stream; every flush worker's
            # stream reads these tensors, so wait for their copies once.
            torch.cuda.current_stream(device).synchronize()

    # -- field ops (triplets (b (T,k), q (T,k), r (T,1)), int64) ------------

    def fmul(self, a, b):
        """RNS Montgomery product (Bajard AMM + Shenoy) modulo P-256's prime."""
        return rns._mont_mul(self.cn, a, b, self.key)

    def fadd(self, a, b):
        cn = self.cn
        return (
            rns._barrett(a[0] + b[0], cn.pb),
            rns._barrett(a[1] + b[1], cn.pq),
            (a[2] + b[2]) & _PR_MASK,
        )

    def fsub(self, a, b, s: int = _S_L1):
        """a − b + s·p (s·p ≡ 0 mod p keeps the residue class; s must
        exceed b's bound coefficient so the value stays positive)."""
        cn = self.cn
        sp = self.sp[s]
        return (
            rns._barrett(a[0] - b[0] + sp[0], cn.pb),
            rns._barrett(a[1] - b[1] + sp[1], cn.pq),
            (a[2] - b[2] + sp[2]) & _PR_MASK,
        )

    def fdbl(self, a):
        return self.fadd(a, a)

    def is_zero(self, v):
        """(T,) bool: v ≡ 0 (mod p), exact for v < (min prime)·p."""
        w = rns._mulmod(v[0], self.pinv_b, self.cn.pb)
        alpha = w[:, :1]
        return (w == alpha).all(dim=1) & (alpha[:, 0] <= 2 * _S_SMALL)

    @staticmethod
    def select(cond, a, b):
        """Per-column triplet select; cond is (T,)."""
        c = cond[:, None]
        return tuple(torch.where(c, x, y) for x, y in zip(a, b))

    # -- group law (Jacobian, unified / branch-free) ------------------------

    def jac_double(self, X1, Y1, Z1):
        """dbl-2001-b shape for a = −3, except Z3 = 2·Y1·Z1: a mult
        keeps Z3 < 60p (is_zero-eligible) and maps the identity's
        exact-0 Z to exact 0 (0 is absorbing through fmul/fadd)."""
        delta = self.fmul(Z1, Z1)
        gamma = self.fmul(Y1, Y1)
        beta = self.fmul(X1, gamma)
        t0 = self.fsub(X1, delta, _S_L1)
        t1 = self.fadd(X1, delta)
        alpha = self.fmul(t0, self.fadd(self.fdbl(t1), t1))
        beta4 = self.fdbl(self.fdbl(beta))  # < 120p
        X3 = self.fsub(self.fmul(alpha, alpha), self.fdbl(beta4), _S_L1)
        Z3 = self.fdbl(self.fmul(Y1, Z1))
        g2 = self.fmul(gamma, gamma)
        Y3 = self.fsub(
            self.fmul(alpha, self.fsub(beta4, X3, _S_L2)),
            self.fdbl(self.fdbl(self.fdbl(g2))),
            _S_L1,
        )
        return X3, Y3, Z3

    def jac_add(self, P1, P2):
        X1, Y1, Z1 = P1
        X2, Y2, Z2 = P2
        Z1Z1 = self.fmul(Z1, Z1)
        Z2Z2 = self.fmul(Z2, Z2)
        U1 = self.fmul(X1, Z2Z2)
        U2 = self.fmul(X2, Z1Z1)
        S1 = self.fmul(self.fmul(Y1, Z2), Z2Z2)
        S2 = self.fmul(self.fmul(Y2, Z1), Z1Z1)
        # H/R: differences of fmul outputs with the SMALL slack — the
        # only values (besides Z) the is_zero test ever sees.
        H = self.fsub(U2, U1, _S_SMALL)
        R = self.fsub(S2, S1, _S_SMALL)
        H2 = self.fmul(H, H)
        H3 = self.fmul(H2, H)
        U1H2 = self.fmul(U1, H2)
        X3 = self.fsub(
            self.fsub(self.fmul(R, R), H3, _S_L1), self.fdbl(U1H2), _S_L1
        )
        Y3 = self.fsub(
            self.fmul(R, self.fsub(U1H2, X3, _S_L2)),
            self.fmul(S1, H3),
            _S_L1,
        )
        Z3 = self.fmul(self.fmul(Z1, Z2), H)

        dX, dY, dZ = self.jac_double(X1, Y1, Z1)

        inf1 = self.is_zero(Z1)
        inf2 = self.is_zero(Z2)
        same_x = self.is_zero(H) & ~inf1 & ~inf2
        same_y = self.is_zero(R)
        is_dbl = same_x & same_y
        to_inf = same_x & ~same_y  # P + (−P) = O

        X = self.select(is_dbl, dX, X3)
        Y = self.select(is_dbl, dY, Y3)
        Z = self.select(is_dbl, dZ, Z3)
        Z = self.select(to_inf, tuple(torch.zeros_like(c) for c in Z), Z)
        X = self.select(inf1, X2, self.select(inf2, X1, X))
        Y = self.select(inf1, Y2, self.select(inf2, Y1, Y))
        Z = self.select(inf1, Z2, self.select(inf2, Z1, Z))
        return X, Y, Z

    # -- layouts -------------------------------------------------------------

    def unstack(self, block: torch.Tensor):
        """(3, 2k+1, T) residue block → three channels-last int64 triplets."""
        k = self.k
        b = block.to(torch.int64)
        return tuple((c[:k].T, c[k : 2 * k].T, c[2 * k :].T) for c in b)

    @staticmethod
    def stack(pt) -> torch.Tensor:
        """Inverse of :meth:`unstack`: (3, 2k+1, T) int32."""
        return torch.stack(
            [torch.cat([c[0], c[1], c[2]], dim=1).T for c in pt]
        ).to(torch.int32).contiguous()

    # -- host codecs ---------------------------------------------------------

    def encode_points_into(self, pts: list, res: np.ndarray) -> None:
        """Affine host points (None = identity) → their Montgomery-form
        residues, written into the columns of ``res`` (3, 2k+1, t): each
        value (x·M) mod p as 32 little-endian bytes, turned into residues
        by one integer product with the byte weights 256^i mod m_j.  The
        values equal the reference's ``encode_points_into``."""
        p, M = P256.p, self.ctx.M
        one = M % p
        xs, ys, zs = [], [], []
        for pt in pts:
            if pt is None:
                xs.append(one)  # placeholder; Z = 0 marks identity
                ys.append(one)
                zs.append(0)
            else:
                xs.append((pt[0] * M) % p)
                ys.append((pt[1] * M) % p)
                zs.append(one)
        for c, vals in enumerate((xs, ys, zs)):
            sums = rns.bytes_rows(vals, 32).astype(np.int64) @ self.byte_weights
            res[c] = (sums % self.moduli).T

    def strip_sigma(self, block: torch.Tensor) -> torch.Tensor:
        """Jacobian Montgomery residues (3, 2k+1, T) → σ (3, T, k) int32 on
        this engine's device: one product by ones strips the Montgomery
        factor (the three coordinates stacked into one product), then
        σ_i = v_i·(M/m_i)⁻¹ mod m_i over B — the device half of the
        reference's ``decode_points``."""
        t = block.shape[-1]
        trip = tuple(torch.cat(c, dim=0) for c in zip(*self.unstack(block)))  # (3T, w)
        plain = self.fmul(trip, tuple(torch.ones_like(c) for c in trip))
        sigma = rns._mulmod(plain[0], self.cn.invMi_b, self.cn.pb)
        return sigma.reshape(3, t, self.k).to(torch.int32)

    def decode_sigma(self, sigma: np.ndarray) -> list:
        """σ (3, T, k) of X, Y, Z → affine host points: the CRT rebuild and
        a host ``pow`` inverse per point — the host half of the reference's
        ``decode_points``."""
        p = P256.p
        xs, ys, zs = ([v % p for v in rns._sigma_to_ints(self.ctx, s)] for s in sigma)
        pts = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                pts.append(None)
                continue
            zi = pow(z, -1, p)
            zi2 = zi * zi % p
            pts.append((x * zi2 % p, y * zi2 * zi % p))
        return pts

    def decode_points(self, block: np.ndarray) -> list:
        """Jacobian Montgomery residues (3, 2k+1, T) → affine host points:
        :meth:`strip_sigma` on this engine's device, then
        :meth:`decode_sigma` on the host, as the reference's."""
        block = torch.as_tensor(block, device=self.device)
        return self.decode_sigma(self.strip_sigma(block).cpu().numpy())


def lane_table(ctx) -> np.ndarray:
    """The kernel's (len(LANE_ROWS) + 2k, 32) int32 lane constants (see
    :data:`LANE_ROWS`) for P-256's prime over ``ctx``."""
    k = ctx.k
    if k + 1 > LANES:
        raise ValueError(f"k={k}: the kernel holds k + 1 <= {LANES} channels in one warp")
    p = P256.p
    n_all, n_r, neg_ninv_b = ctx.key_rows(p)[:3]
    tab = {name: np.zeros(LANES, dtype=np.int64) for name in LANE_ROWS}
    for name in ("pb", "pq"):
        tab[name][:] = rns.PR
    pb = np.asarray(ctx.pb, dtype=np.int64)
    pq = np.asarray(ctx.pq, dtype=np.int64)
    tab["pb"][:k] = pb
    tab["pq"][:k] = pq
    tab["neg_ninv_b"][:k] = np.asarray(neg_ninv_b, dtype=np.int64)
    tab["invMi_b"][:k] = np.asarray(ctx.invMi_b, dtype=np.int64)
    tab["nq"][:k] = np.asarray(n_all[k:], dtype=np.int64)
    tab["nq"][k] = int(n_r)
    tab["invM_q"][:k] = np.asarray(ctx.invM_q, dtype=np.int64)
    tab["invM_q"][k] = int(ctx.invM_pr)
    tab["invMi_q"][:k] = np.asarray(ctx.invMi_q, dtype=np.int64)
    tab["Mq_mod_b"][:k] = np.asarray(ctx.Mq_mod_b, dtype=np.int64)
    tab["pinv_b"][:k] = [pow(p % int(q), -1, int(q)) for q in pb]
    one = ctx.M % p
    for name, v in (("one", one), ("sp_small", _S_SMALL * p), ("sp_l1", _S_L1 * p),
                    ("sp_l2", _S_L2 * p)):
        tab[f"{name}_b"][:k] = [v % int(q) for q in pb]
        tab[f"{name}_q"][:k] = [v % int(q) for q in pq]
        tab[f"{name}_q"][k] = v % rns.PR
    tab["invMq_pr"][:] = int(ctx.invMq_pr)
    tab["mub"] = rns.barrett_mu(tab["pb"]).astype(np.int64)
    tab["muq"] = rns.barrett_mu(tab["pq"]).astype(np.int64)
    E1 = (ctx._E1[0] + 64.0 * ctx._E1[1]).astype(np.int64)  # (k, k+1)
    E2 = (ctx._E2[0] + 64.0 * ctx._E2[1]).astype(np.int64)
    e1 = np.zeros((k, LANES), dtype=np.int64)
    e2 = np.zeros((k, LANES), dtype=np.int64)
    e1[:, : k + 1] = E1
    e2[:, : k + 1] = E2
    out = np.concatenate([np.stack([tab[name] for name in LANE_ROWS]), e1, e2])
    return out.astype(np.uint32).view(np.int32)


@functools.lru_cache(maxsize=8)
def _engine_on(dev: str) -> _P256RNS:
    return _P256RNS(torch.device(dev))


def engine(device=None) -> _P256RNS:
    """The engine's constants on ``device`` (resolved; cached per device)."""
    return _engine_on(str(devmod.resolve(device)))


def _bcast(c, t: int):
    return tuple(a.expand(t, a.shape[1]) for a in c)


def _identity(eng: _P256RNS, t: int):
    one_m = _bcast(eng.one_m, t)
    return (one_m, one_m, _bcast(eng.zero, t))


def _table(eng: _P256RNS, P):
    """Window table t[j] = j·P (t[0] = identity), 15 unified adds, as
    (16, T, w) tensors per coordinate and channel group."""
    tab = [_identity(eng, P[0][0].shape[0]), P]
    for _ in range(14):
        tab.append(eng.jac_add(tab[-1], P))
    return [[torch.stack([e[i][j] for e in tab]) for j in range(3)] for i in range(3)]


def _window(eng: _P256RNS, acc, cat, nib_row: torch.Tensor):
    """One window: 4 doublings, the one-hot blend of entry ``nib_row``
    (T,) over all 16 table entries, one unified add."""
    for _ in range(_WINDOW):
        acc = eng.jac_double(*acc)
    entries = torch.arange(16, device=nib_row.device)[:, None, None]
    m16 = (nib_row.to(torch.int64)[None, :, None] == entries).to(torch.int64)  # (16, T, 1)
    q = tuple(tuple((m16 * cat[i][j]).sum(dim=0) for j in range(3)) for i in range(3))
    return eng.jac_add(acc, q)


def _scalar_mult(eng: _P256RNS, res: torch.Tensor, nib: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (the reference's ``_scalar_mult_fn``): k·P per
    column.  ``res``: (3, 2k+1, T) int32 Montgomery residues of P;
    ``nib``: (64, T) window values, most significant first.  Returns the
    Jacobian Montgomery residues of k·P, (3, 2k+1, T) int32."""
    P = eng.unstack(res)
    cat = _table(eng, P)
    acc = _identity(eng, res.shape[-1])
    for w in nib:
        acc = _window(eng, acc, cat, w)
    return eng.stack(acc)


def _nibbles(scalars: list[int]) -> np.ndarray:
    """(NWIN, T) uint8 window values of k mod n, most-significant first."""
    b = rns.bytes_rows([s % P256.n for s in scalars], 32)  # little-endian bytes
    nib = np.empty((len(scalars), 2 * 32), dtype=np.uint8)
    nib[:, 0::2] = b & 0xF
    nib[:, 1::2] = b >> 4
    return np.ascontiguousarray(nib[:, ::-1].T)


def _ec_staging(padded: int, dev: torch.device) -> devbuf.Lease:
    """One K5 launch's slot: the staged residues and nibbles, σ of the
    output (:meth:`_P256RNS.strip_sigma`), and the ``pad_lo`` watermark (host only): columns ``pad_lo:``
    already hold the identity encoding and nibble 0 from an earlier call
    in this slot, so a call re-encodes only its live columns and the
    columns an earlier, larger batch dirtied.  The third width class of
    the staging rings (``ec``), one ring per padded width."""
    k = rns.context(_DIGITS, 256).k
    spec = {
        "res": ((3, 2 * k + 1, padded), torch.int32),
        "nib": ((_NWIN, padded), torch.uint8),
        "sigma": ((3, padded, k), torch.int32),
        "pad_lo": ((1,), torch.int64, padded),
    }
    return devbuf.lease(f"ec:{padded}:{dev}", spec, dev, width="ec")


def scalar_mult_hosts(points: list, scalars: list[int], device=None) -> list:
    """Batched k·P for affine host points (None = identity) and integer
    scalars; the same contract as the reference's (power-of-two padding,
    floor 8; pad columns hold the identity and scalar 0).  One launch of
    K5 on ``cuda`` (the plain version on ``cpu``) and the Montgomery strip
    on the same device; the host rebuilds the integers from σ.  An error
    of the build or the launch propagates."""
    from bftkv_tpu_torch.ops import cuda_ec

    dev = devmod.resolve(device)
    if not points:
        return []
    if len(scalars) != len(points):
        raise ValueError(f"{len(points)} points, {len(scalars)} scalars")
    eng = engine(dev)
    t = len(points)
    padded = max(8, 1 << (t - 1).bit_length())
    lease = _ec_staging(padded, dev)
    with lease.launch() as slot:
        res, nib, lo = slot["res"], slot["nib"], slot["pad_lo"]
        pad_lo = int(lo[0])
        # Columns below max(t, pad_lo) may be dirtied from here on.
        lo[0] = max(t, pad_lo)
        eng.encode_points_into(points, res[:, :, :t])
        nib[:, :t] = _nibbles(scalars)
        if t < pad_lo:
            eng.encode_points_into([None] * (pad_lo - t), res[:, :, t:pad_lo])
            nib[:, t:pad_lo] = 0
        lo[0] = t
        d = slot.upload(("res", "nib"))
        out = cuda_ec.scalar_mult_cuda(d["res"], d["nib"], eng)
        slot.download("sigma", eng.strip_sigma(out))
    return eng.decode_sigma(lease.collect(lambda s: s["sigma"][:, :t].copy()))


def scalar_base_mult_hosts(scalars: list[int], device=None) -> list:
    return scalar_mult_hosts([(P256.gx, P256.gy)] * len(scalars), scalars, device=device)
