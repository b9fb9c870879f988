"""The port's BatchModExp (bftkv_tpu_torch.ops.modexp) on the CPU.

Every route is held against host ``pow``, and all but the RNS route
against the reference's ``BatchModExp`` on the same seeded pairs; spies
on the port's entry points and its counters show which route ran.
Tolerance is exact.
"""

from __future__ import annotations

import random

import pytest

from bftkv_tpu.ops import modexp as ref_modexp
from bftkv_tpu_torch.metrics import registry as metrics
from bftkv_tpu_torch.ops import modexp, rns
from bftkv_tpu_torch.ops import rsa as rsa_ops
from test_torch_utils import one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def routes(monkeypatch):
    """Counts the calls of the RNS and limb entry points (and what the
    limb path was handed)."""
    seen = {"rns": 0, "limb": []}
    real_rns, real_limb = rns.power_mod_rns, rsa_ops.power_batch

    def spy_rns(*args, **kw):
        seen["rns"] += 1
        return real_rns(*args, **kw)

    def spy_limb(base, e, *args, **kw):
        seen["limb"].append((base.shape, e.shape))
        return real_limb(base, e, *args, **kw)

    monkeypatch.setattr(rns, "power_mod_rns", spy_rns)
    monkeypatch.setattr(rsa_ops, "power_batch", spy_limb)
    metrics.reset()
    return seen


def _odd(rng, bits):
    return rng.getrandbits(bits) | 1 | (1 << (bits - 1))


def _check(pairs, n, min_batch=4, reference=True):
    got = modexp.BatchModExp(min_batch, device="cpu").modexp(pairs, n)
    want = [pow(b, e, n) for b, e in pairs]
    assert got == want
    if reference:
        assert ref_modexp.BatchModExp(min_batch).modexp(pairs, n) == want


def test_small_batches_and_even_moduli_stay_on_host(routes):
    rng = random.Random(71)
    n = _odd(rng, 1024)
    _check([(rng.getrandbits(1024), rng.getrandbits(1024)) for _ in range(3)], n)
    _check([(rng.getrandbits(1024), rng.getrandbits(64)) for _ in range(5)], n + 1)
    _check([(5, 7)] * 4, 1)
    assert modexp.BatchModExp(device="cpu").modexp([], n) == []
    assert routes == {"rns": 0, "limb": []}


def test_rns_at_1024_bits(routes):
    rng = random.Random(72)
    n = _odd(rng, 1024)
    # Not against the reference: its RNS route compiles the full-width
    # JAX modexp (tests/test_torch_rns.py holds the RNS engine against it
    # at small contexts).
    _check([(rng.getrandbits(1100), rng.getrandbits(1024)) for _ in range(4)], n,
           reference=False)
    assert routes["rns"] == 1 and routes["limb"] == []
    assert metrics.snapshot()["modexp.rns_staged"] == 4


def test_over_width_exponent_takes_the_limb_path(routes):
    """Exponents past 2048 bits (threshold-RSA fragments) at a small
    modulus: the limb engine, exponent bucketed to 256 limbs."""
    rng = random.Random(73)
    n = _odd(rng, 128)
    _check([(rng.getrandbits(300), rng.getrandbits(2100)) for _ in range(4)], n)
    assert routes["rns"] == 0 and routes["limb"] == [((4, 8), (4, 256))]
    assert "modexp.rns_staged" not in metrics.snapshot()


def test_modulus_the_rns_bases_decline_takes_the_limb_path(routes):
    rng = random.Random(74)
    n = rns.context(64, 1024).pb[0] * (_odd(rng, 250))  # shares a channel prime
    _check([(rng.getrandbits(300), rng.getrandbits(200)) for _ in range(4)], n)
    assert routes["rns"] == 1 and routes["limb"] == [((4, 17), (4, 64))]
    assert "modexp.rns_staged" not in metrics.snapshot()


def test_exponents_over_256_limbs_stay_on_host(routes):
    rng = random.Random(75)
    n = _odd(rng, 64)
    _check([(rng.getrandbits(64), rng.getrandbits(4100)) for _ in range(4)], n)
    assert routes == {"rns": 0, "limb": []}


def test_domain_cache_is_bounded():
    bme = modexp.BatchModExp(device="cpu")
    rng = random.Random(76)
    ns = [_odd(rng, 256) for _ in range(bme._DOM_CACHE_MAX + 3)]
    doms = [bme._domains.get(n, 16) for n in ns]
    assert len(bme._domains) == bme._DOM_CACHE_MAX
    assert (ns[0], 16) not in bme._domains and (ns[-1], 16) in bme._domains
    assert bme._domains.get(ns[-1], 16) is doms[-1]  # a hit, not a rebuild
    assert bme._domains.get(ns[0] + 1, 16) is None  # even: refused
