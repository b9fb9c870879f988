"""Helpers shared by the port's tests (tests/test_torch_*.py), and their
own tests.

Imports torch and the port only, so the card's test file can use it on a
machine without JAX.  The other test modules import it by its bare name,
as they import ``cluster_utils``.
"""

from __future__ import annotations

import random

import pytest
import torch


def moduli(ctx, bits: int, count: int, seed: int) -> list[int]:
    """``count`` seeded odd ``bits``-bit moduli that the RNS context takes."""
    rng = random.Random(seed)
    out = []
    while len(out) < count:
        n = rng.getrandbits(bits) | 1 | (1 << (bits - 1))
        if ctx.key_rows(n) is not None:
            out.append(n)
    return out


@pytest.fixture(scope="module")
def one_torch_thread():
    """Runs a module's tests with one intra-op torch thread.

    The suite runs in several pytest-xdist workers at once; torch's own
    thread pool in each of them oversubscribes the cores many times over
    and makes the plain versions' small products some 50x slower.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bits", [512, 1024, 2048])
def test_moduli_are_seeded_odd_and_accepted(bits):
    from bftkv_tpu_torch.ops import rns

    ctx = rns.context()
    ns = moduli(ctx, bits, 3, seed=bits)
    assert ns == moduli(ctx, bits, 3, seed=bits)
    assert len(set(ns)) == 3
    for n in ns:
        assert n % 2 == 1 and n.bit_length() == bits
        assert ctx.key_rows(n) is not None


def test_one_torch_thread_pins_one_thread(one_torch_thread):
    assert torch.get_num_threads() == 1
