"""The port's limb P-256 engine (``bftkv_tpu_torch/ops/ec.py``) against the
reference's (``bftkv_tpu/ops/ec.py``) and the host curve, and the EC entry
point's engine choice.

The reference's field ops and group law are small jitted programs over its
limb engine; the port's are the same programs as PyTorch ops.  On seeded
field elements (16-bit digits, Montgomery form) every result must be equal
bit for bit.  The whole limb scalar mult (4,000 Montgomery products as
op-by-op PyTorch calls, ~15 s on one CPU thread) runs once, on a batch that holds the
edge cases of ``tests/test_ec_ops.py``; the reference's jitted
``scalar_mult_jac`` is never called in this file.
"""

from __future__ import annotations

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bftkv_tpu.ops import ec as ref_ec
from bftkv_tpu_torch.crypto.ec import P256
from bftkv_tpu_torch.ops import ec, ec_rns, limb
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

G = (P256.gx, P256.gy)
N = P256.n


def digits(vals: list[int]) -> np.ndarray:
    return limb.ints_to_limbs(vals, ec.L)


def both(a: np.ndarray):
    """The same digits for the reference (uint32) and the port (int64)."""
    return jnp.asarray(a), torch.from_numpy(a.astype(np.int64))


def same(port, reference) -> None:
    np.testing.assert_array_equal(port.numpy(), np.asarray(reference).astype(np.int64))


def field_elements(seed: int, count: int) -> np.ndarray:
    """Montgomery-form digits of seeded field elements, with 0, 1 and p − 1."""
    rng = random.Random(seed)
    vals = [0, 1, P256.p - 1] + [rng.randrange(P256.p) for _ in range(count - 3)]
    r = ec.p256().dom.r_int
    return digits([v * r % P256.p for v in vals])


@pytest.mark.parametrize("op", ["_fmul", "_fadd", "_fsub", "_fdbl"])
def test_limb_field_op_equals_the_reference(op):
    a = field_elements(1, 16)
    b = field_elements(2, 16)
    b[5] = a[5]  # one column with equal operands (a − b = 0)
    (ra, pa), (rb, pb) = both(a), both(b)
    if op == "_fdbl":
        same(ec._fdbl(pa), ref_ec._fdbl(ra))
    else:
        same(getattr(ec, op)(pa, pb), getattr(ref_ec, op)(ra, rb))


def _group_inputs():
    """Jacobian limb batches with the group law's edge lanes: P + Q, P + P,
    P + (−P), O + P, P + O, O + O, G + G, Q + P."""
    d = ec.p256()
    rng = random.Random(7)
    P, Q = (P256.scalar_base_mult(rng.randrange(1, N)) for _ in range(2))
    negP = (P[0], (-P[1]) % P256.p)
    A = d.encode_points([P, P, P, None, P, None, G, Q])
    B = d.encode_points([Q, P, negP, Q, None, None, G, P])
    return A, B


def test_limb_jac_double_equals_the_reference():
    A, _ = _group_inputs()
    got = ec._jac_double(*(both(x)[1] for x in A))
    want = ref_ec._jac_double(*(both(x)[0] for x in A))
    for g, w in zip(got, want):
        same(g, w)


def test_limb_jac_add_equals_the_reference():
    A, B = _group_inputs()
    got = ec._jac_add(*(both(x)[1] for x in A + B))
    want = ref_ec._jac_add(*(both(x)[0] for x in A + B))
    for g, w in zip(got, want):
        same(g, w)
    assert not got[2][2].any() and not got[2][5].any()  # P + (−P), O + O


def test_limb_add_batch_and_to_affine_match_the_host_curve():
    d = ec.p256()
    a = P256.scalar_base_mult(111)
    b = P256.scalar_base_mult(222)
    neg_a = (a[0], (-a[1]) % P256.p)
    X1, Y1, Z1 = (torch.from_numpy(x.astype(np.int64)) for x in d.encode_points([a, a, a, None, b]))
    X2, Y2, Z2 = (torch.from_numpy(x.astype(np.int64))
                  for x in d.encode_points([b, a, neg_a, b, None]))
    xa, ya, inf = ec.to_affine(*ec.add_batch(X1, Y1, Z1, X2, Y2, Z2))
    out = d.decode_points(xa.numpy(), ya.numpy(), inf.numpy())
    assert out == [P256.add(a, b), P256.double(a), None, b, b]


def test_limb_scalar_mult_matches_the_host_curve(monkeypatch):
    """The one whole limb scalar mult of this file: ``auto`` on the cpu is
    the limb engine (the RNS engine must not be reached)."""
    monkeypatch.delenv("BFTKV_EC_BACKEND", raising=False)

    def no_rns(*a, **kw):
        raise AssertionError("auto on the cpu reached the RNS engine")

    monkeypatch.setattr(ec_rns, "scalar_mult_hosts", no_rns)
    rng = random.Random(3)
    p1 = P256.scalar_base_mult(12345)
    pts = [None, p1, p1, G, p1, G, P256.scalar_base_mult(rng.randrange(1, N)), G]
    ks = [5, 0, N, 2, N - 1, 7, rng.randrange(N), rng.randrange(N)]
    got = ec.scalar_mult_hosts(pts, ks, device="cpu")
    want = [P256.scalar_mult(p, k) if p is not None else None for p, k in zip(pts, ks)]
    assert got == want
    assert got[4] == (p1[0], (-p1[1]) % P256.p)  # (n − 1)·P = −P


@pytest.mark.parametrize("mode,dev,rns", [
    (None, "cpu", False), (None, "cuda", True), ("auto", "cpu", False), ("auto", "cuda", True),
    ("rns", "cpu", True), ("rns", "cuda", True), ("limb", "cpu", False), ("limb", "cuda", False),
])
def test_ec_backend_rule(monkeypatch, mode, dev, rns):
    """``auto`` is ``rns`` on a ``cuda`` device and ``limb`` on the ``cpu``:
    the reference's rule with the card for the TPU."""
    if mode is None:
        monkeypatch.delenv("BFTKV_EC_BACKEND", raising=False)
    else:
        monkeypatch.setenv("BFTKV_EC_BACKEND", mode)
    assert ec._use_rns_backend(torch.device(dev)) is rns


def test_rns_engine_error_is_not_answered_by_the_limb_engine(monkeypatch):
    """The reference falls back to its limb kernel when the RNS engine
    raises (``ops/ec.py:302-312``); the port lets the error reach the
    caller."""
    monkeypatch.setenv("BFTKV_EC_BACKEND", "rns")

    def boom(*a, **kw):
        raise RuntimeError("K5 launch failed")

    monkeypatch.setattr(ec_rns, "scalar_mult_hosts", boom)
    monkeypatch.setattr(ec, "scalar_mult_jac", lambda *a: pytest.fail("limb engine reached"))
    with pytest.raises(RuntimeError, match="K5 launch failed"):
        ec.scalar_mult_hosts([G], [3], device="cpu")


def test_limb_entry_ignores_the_backend_flag(monkeypatch):
    """``scalar_mult_hosts_limb`` is the limb engine whatever
    ``BFTKV_EC_BACKEND`` says; the RNS engine is never reached."""
    monkeypatch.setenv("BFTKV_EC_BACKEND", "rns")

    class Reached(Exception):
        pass

    def limb(*a):
        raise Reached

    monkeypatch.setattr(ec_rns, "scalar_mult_hosts", lambda *a, **kw: pytest.fail("RNS reached"))
    monkeypatch.setattr(ec, "scalar_mult_jac", limb)
    assert ec.scalar_mult_hosts_limb([], [], device="cpu") == []
    with pytest.raises(Reached):
        ec.scalar_mult_hosts_limb([G], [3], device="cpu")


def test_linear_combine_on_the_rns_engine(monkeypatch):
    monkeypatch.setenv("BFTKV_EC_BACKEND", "rns")
    pts = [P256.scalar_base_mult(i + 1) for i in range(5)]
    ks = [3, 1, 4, 1, 5]
    want = None
    for p, k in zip(pts, ks):
        want = P256.add(want, P256.scalar_mult(p, k))
    assert ec.linear_combine_hosts(pts, ks, device="cpu") == want
    k1, k2 = 2**200 + 17, N - 5
    lhs = ec.scalar_base_mult_hosts([(k1 + k2) % N], device="cpu")[0]
    assert lhs == ec.linear_combine_hosts([G, G], [k1, k2], device="cpu")
