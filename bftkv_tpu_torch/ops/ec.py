"""Batched P-256 point arithmetic on the limb engine, and the EC entry points.

Counterpart of ``bftkv_tpu/ops/ec.py`` (K6 there, an XLA program): field
elements are ``(batch, 16)`` tensors of 16-bit digits in Montgomery form
over :mod:`bftkv_tpu_torch.ops.bigint`, points are Jacobian ``(X, Y, Z)``
with Z = 0 encoding the identity.  Here it runs as PyTorch ops, op for op
the reference's program.

Branch-free: the unified group law evaluates both the generic-add and
the doubling formulas and selects per row, and the scalar mult is the
same schedule for every row — fixed 4-bit windows, 64 × (4 doublings +
table select + unified add).  The table select is a one-hot arithmetic
blend over all 16 entries (the reference gathers with ``take_along_axis``
on the scalar's nibble, ``ec.py:235-245``): signing nonces are secret, so
no index or address may depend on them.  The values are the same.

:func:`scalar_mult_hosts` is the EC entry point the ECDSA batches call;
``BFTKV_EC_BACKEND`` picks the engine: ``rns`` (:mod:`ops.ec_rns`,
kernel K5 on ``cuda``), ``limb`` (this module) or ``auto`` (the default:
``rns`` on a ``cuda`` device, ``limb`` on the ``cpu``).  An error of the
RNS engine propagates: it is never answered by the limb engine.
``crypto/ec.py`` is the host oracle of both.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bftkv_tpu_torch import device as devmod
from bftkv_tpu_torch import flags
from bftkv_tpu_torch.crypto.ec import P256
from bftkv_tpu_torch.ops import bigint, limb

__all__ = [
    "P256Domain",
    "add_batch",
    "linear_combine_hosts",
    "p256",
    "scalar_base_mult_hosts",
    "scalar_mult_hosts",
    "scalar_mult_hosts_limb",
    "scalar_mult_jac",
    "to_affine",
]

L = 16  # 256 bits / 16-bit digits
_WINDOW = 4
_NWIN = 256 // _WINDOW


class P256Domain:
    """Host-side constants for the P-256 field and group order (uint32
    digit arrays, as the reference's)."""

    def __init__(self):
        self.dom = bigint.MontgomeryDomain(P256.p, L)
        c = lambda x: limb.int_to_limbs(x, L)
        self.p = self.dom.n
        self.n_prime = self.dom.n_prime
        self.one_m = self.dom.one_mont  # R mod p  (1 in Montgomery form)
        self.rp = c((1 << (16 * L)) - P256.p)  # R - p, for mod-R add of p
        self.p_minus_2 = c(P256.p - 2)
        self.zero = np.zeros(L, dtype=np.uint32)

    # -- host codecs ------------------------------------------------------

    def encode_points(self, pts: list) -> tuple[np.ndarray, ...]:
        """Affine host points (or None) → (X_m, Y_m, Z_m) Jacobian batch."""
        xs, ys, zs = [], [], []
        r = self.dom.r_int
        for pt in pts:
            if pt is None:
                xs.append(self.one_m)
                ys.append(self.one_m)
                zs.append(self.zero)
            else:
                xs.append(limb.int_to_limbs((pt[0] * r) % P256.p, L))
                ys.append(limb.int_to_limbs((pt[1] * r) % P256.p, L))
                zs.append(self.one_m)
        return np.stack(xs), np.stack(ys), np.stack(zs)

    def encode_scalars(self, ks: list[int]) -> np.ndarray:
        return limb.ints_to_limbs([k % P256.n for k in ks], L)

    def decode_points(self, xa, ya, inf) -> list:
        """Affine Montgomery batch (+ infinity mask) → host points."""
        rinv = pow(self.dom.r_int, -1, P256.p)
        out = []
        for x, y, z in zip(
            limb.limbs_to_ints(np.asarray(xa)),
            limb.limbs_to_ints(np.asarray(ya)),
            np.asarray(inf),
        ):
            out.append(None if z else ((x * rinv) % P256.p, (y * rinv) % P256.p))
        return out


@functools.lru_cache(maxsize=1)
def p256() -> P256Domain:
    return P256Domain()


@functools.lru_cache(maxsize=8)
def _dev_consts(dev: str) -> dict:
    d = p256()
    return {
        name: bigint.limbs_from_numpy(getattr(d, name), dev)
        for name in ("p", "n_prime", "rp", "one_m", "p_minus_2")
    }


def _const(name: str, like: torch.Tensor) -> torch.Tensor:
    """Constant ``name`` broadcast to ``like``'s shape, on its device."""
    return _dev_consts(str(like.device))[name].expand(like.shape)


# ---------------------------------------------------------------------------
# Field ops (all operands < p, Montgomery form, shape (..., L), int64 digits)
# ---------------------------------------------------------------------------


def _fmul(a, b):
    return bigint.mont_mul(a, b, _const("p", a), _const("n_prime", a))


def _fadd(a, b):
    s = bigint.carry_resolve(a + b, L + 1)
    t, hi = s[..., :L], s[..., L]
    return bigint._cond_sub(t, _const("p", a), hi)


def _fsub(a, b):
    d = bigint.sub_mod_r(a, b)
    # a < b ⇒ wrapped: subtract (R - p) ≡ add p (mod R).
    wrapped = ~bigint.geq(a, b)
    return torch.where(wrapped[..., None], bigint.sub_mod_r(d, _const("rp", a)), d)


def _fdbl(a):
    return _fadd(a, a)


def _is_zero(a):
    return (a == 0).all(dim=-1)


# ---------------------------------------------------------------------------
# Group law (Jacobian, unified / branch-free)
# ---------------------------------------------------------------------------


def _jac_double(X1, Y1, Z1):
    """dbl-2001-b for a = -3; identity (Z=0) maps to identity."""
    delta = _fmul(Z1, Z1)
    gamma = _fmul(Y1, Y1)
    beta = _fmul(X1, gamma)
    t0 = _fsub(X1, delta)
    t1 = _fadd(X1, delta)
    alpha = _fmul(t0, _fadd(_fdbl(t1), t1))  # 3*(X1-δ)(X1+δ)
    beta4 = _fdbl(_fdbl(beta))
    X3 = _fsub(_fmul(alpha, alpha), _fdbl(beta4))
    t2 = _fadd(Y1, Z1)
    Z3 = _fsub(_fsub(_fmul(t2, t2), gamma), delta)
    g2 = _fmul(gamma, gamma)
    Y3 = _fsub(_fmul(alpha, _fsub(beta4, X3)), _fdbl(_fdbl(_fdbl(g2))))
    return X3, Y3, Z3


def _jac_add(X1, Y1, Z1, X2, Y2, Z2):
    """add-2007-bl shaped unified add with selected edge cases."""
    Z1Z1 = _fmul(Z1, Z1)
    Z2Z2 = _fmul(Z2, Z2)
    U1 = _fmul(X1, Z2Z2)
    U2 = _fmul(X2, Z1Z1)
    S1 = _fmul(_fmul(Y1, Z2), Z2Z2)
    S2 = _fmul(_fmul(Y2, Z1), Z1Z1)
    H = _fsub(U2, U1)
    R = _fsub(S2, S1)
    H2 = _fmul(H, H)
    H3 = _fmul(H2, H)
    U1H2 = _fmul(U1, H2)
    X3 = _fsub(_fsub(_fmul(R, R), H3), _fdbl(U1H2))
    Y3 = _fsub(_fmul(R, _fsub(U1H2, X3)), _fmul(S1, H3))
    Z3 = _fmul(_fmul(Z1, Z2), H)

    dX, dY, dZ = _jac_double(X1, Y1, Z1)

    inf1 = _is_zero(Z1)
    inf2 = _is_zero(Z2)
    same_x = _is_zero(H) & ~inf1 & ~inf2
    same_y = _is_zero(R)
    is_dbl = same_x & same_y
    to_inf = same_x & ~same_y  # P + (-P) = O

    def sel(cond, a, b):
        return torch.where(cond[..., None], a, b)

    X = sel(is_dbl, dX, X3)
    Y = sel(is_dbl, dY, Y3)
    Z = sel(is_dbl, dZ, Z3)
    Z = torch.where(to_inf[..., None], torch.zeros_like(Z), Z)
    X = sel(inf1, X2, sel(inf2, X1, X))
    Y = sel(inf1, Y2, sel(inf2, Y1, Y))
    Z = sel(inf1, Z2, sel(inf2, Z1, Z))
    return X, Y, Z


# ---------------------------------------------------------------------------
# Scalar multiplication
# ---------------------------------------------------------------------------


def scalar_mult_jac(X, Y, Z, k):
    """k·P over the batch, Jacobian in/out, fixed 4-bit windows.

    Uniform schedule: every row does the same 4 doublings + one one-hot
    table blend + one unified add per window.  ``k`` is (batch, 16)
    16-bit digits.
    """
    one_m = _const("one_m", X)
    zero = torch.zeros_like(X)
    # Table t[j] = j·P, j ∈ [0, 16): t[0] = O, t[j] = t[j-1] + P.
    tab = [(one_m, one_m, zero)]
    for _ in range(15):
        tab.append(_jac_add(*tab[-1], X, Y, Z))
    tX, tY, tZ = (torch.stack([t[i] for t in tab], dim=-2) for i in range(3))  # (..., 16, L)
    entries = torch.arange(16, device=X.device)

    acc = (one_m, one_m, zero)
    for j in range(_NWIN):
        widx = _NWIN - 1 - j
        limb_idx = widx // (16 // _WINDOW)
        shift = (widx % (16 // _WINDOW)) * _WINDOW
        wv = (k[..., limb_idx] >> shift) & (2**_WINDOW - 1)
        for _ in range(_WINDOW):
            acc = _jac_double(*acc)
        onehot = (wv[..., None] == entries).to(X.dtype)[..., None]  # (..., 16, 1)
        blend = lambda t: (onehot * t).sum(dim=-2)
        acc = _jac_add(*acc, blend(tX), blend(tY), blend(tZ))
    return acc


def to_affine(X, Y, Z):
    """Jacobian → affine Montgomery coords + infinity mask."""
    p, npr, one_m = _const("p", X), _const("n_prime", X), _const("one_m", X)
    inf = _is_zero(Z)
    # Z = 1 for identity rows so the inversion stays well-defined.
    Zs = torch.where(inf[..., None], one_m, Z)
    zinv = bigint.mont_exp(Zs, _const("p_minus_2", X), p, npr, one_m)
    zinv2 = _fmul(zinv, zinv)
    xa = _fmul(X, zinv2)
    ya = _fmul(Y, _fmul(zinv2, zinv))
    return xa, ya, inf


def add_batch(X1, Y1, Z1, X2, Y2, Z2):
    return _jac_add(X1, Y1, Z1, X2, Y2, Z2)


# ---------------------------------------------------------------------------
# Host-facing helpers
# ---------------------------------------------------------------------------


def _use_rns_backend(dev: torch.device) -> bool:
    """``BFTKV_EC_BACKEND``: "limb" (this module's engine), "rns" (the RNS
    engine, :mod:`bftkv_tpu_torch.ops.ec_rns`), or "auto" (default): RNS
    on a ``cuda`` device — the reference's "RNS on the TPU" with the card
    for the TPU — and limb on the ``cpu``."""
    mode = flags.raw("BFTKV_EC_BACKEND", "auto")
    if mode == "rns":
        return True
    if mode == "auto":
        return dev.type == "cuda"
    return False


def scalar_mult_hosts(points: list, scalars: list[int], device=None) -> list:
    """Batched k·P on ``device`` for host affine points / int scalars.

    Batches pad to power-of-two buckets (floor 8), as the reference's.
    """
    dev = devmod.resolve(device)
    if not points:
        return []
    if _use_rns_backend(dev):
        from bftkv_tpu_torch.ops import ec_rns

        return ec_rns.scalar_mult_hosts(points, scalars, device=dev)
    return scalar_mult_hosts_limb(points, scalars, device=dev)


def scalar_mult_hosts_limb(points: list, scalars: list[int], device=None) -> list:
    """:func:`scalar_mult_hosts` on this module's limb engine, whatever
    ``BFTKV_EC_BACKEND`` says."""
    dev = devmod.resolve(device)
    if not points:
        return []
    d = p256()
    k = len(points)
    padded = max(8, 1 << (k - 1).bit_length())
    points = list(points) + [None] * (padded - k)
    scalars = list(scalars) + [0] * (padded - k)
    X, Y, Z = (bigint.limbs_from_numpy(a, dev) for a in d.encode_points(points))
    ke = bigint.limbs_from_numpy(d.encode_scalars(scalars), dev)
    xa, ya, inf = to_affine(*scalar_mult_jac(X, Y, Z, ke))
    return d.decode_points(xa.cpu().numpy(), ya.cpu().numpy(), inf.cpu().numpy())[:k]


def scalar_base_mult_hosts(scalars: list[int], device=None) -> list:
    return scalar_mult_hosts([(P256.gx, P256.gy)] * len(scalars), scalars, device=device)


def linear_combine_hosts(points: list, scalars: list[int], device=None):
    """Σ k_i·P_i: the scalar mults ride one batched launch; the final Σ
    over the few points is host adds — the threshold-ECDSA combine."""
    acc = None
    for pt in scalar_mult_hosts(points, scalars, device=device):
        acc = P256.add(acc, pt)
    return acc
