"""The split of the RNS launches over shards (``ops/rns.py``, the
reference's ``_mesh``/``_shardable`` and sharded jits) and the entry
module (``bftkv_tpu_torch/entry.py``, the reference's
``__graft_entry__.py``), on the CPU through the ``shard_over`` seam."""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from bftkv_tpu_torch import entry
from bftkv_tpu_torch.ops import cuda_rns, devbuf, rns
from test_torch_utils import moduli, one_torch_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")


@pytest.fixture
def launches(monkeypatch):
    """Counts the wrapper calls (the plain versions on the CPU) by kind."""
    seen = {"verify": 0, "pow": 0}
    real_v, real_p = cuda_rns.verify_cuda, cuda_rns.pow_cuda

    def v(*a):
        seen["verify"] += 1
        return real_v(*a)

    def p(*a):
        seen["pow"] += 1
        return real_p(*a)

    monkeypatch.setattr(cuda_rns, "verify_cuda", v)
    monkeypatch.setattr(cuda_rns, "pow_cuda", p)
    return seen


@pytest.fixture(scope="module")
def verify_case():
    """300 rows over 3 2048-bit moduli: every third a random em."""
    ctx = rns.context()
    ns = moduli(ctx, 2048, 3, seed=31)
    rng = random.Random(32)
    idx = [rng.randrange(3) for _ in range(300)]
    sigs = [rng.randrange(ns[i]) for i in idx]
    ems = [pow(s, 65537, ns[i]) if j % 3 else rng.randrange(ns[i])
           for j, (s, i) in enumerate(zip(sigs, idx))]
    return sigs, ems, idx, [ctx.key_rows(n) for n in ns], [j % 3 != 0 for j in range(300)]


@pytest.fixture(scope="module")
def pow_case():
    """100 rows over 4 512-bit moduli (k=49 context): padded to 128."""
    mods = moduli(rns.context(32, 512), 512, 4, seed=33)
    rng = random.Random(34)
    bases = [rng.getrandbits(600) for _ in range(100)]
    exps = [rng.getrandbits(512) for _ in range(100)]
    mods = [mods[i % 4] for i in range(100)]
    return bases, exps, mods, [pow(b, e, m) for b, e, m in zip(bases, exps, mods)]


def test_shard_devices_rules(monkeypatch):
    monkeypatch.delenv("BFTKV_SHARD", raising=False)
    assert rns.shard_devices("cpu") is None  # no split without two cards
    with rns.shard_over(["cpu", "cpu", "cpu"]) as devs:
        assert devs == [CPU] * 3 and rns.shard_devices("cpu") == [CPU] * 3
        assert rns._shardable(256, devs) is False and rns._shardable(3 * 128, devs) is True
        monkeypatch.setenv("BFTKV_SHARD", "off")
        assert rns.shard_devices("cpu") is None
    assert rns.shard_devices("cpu") is None and rns._shardable(256, None) is False
    with pytest.raises(ValueError):
        with rns.shard_over([]):
            pass


def test_shard_zero_is_the_callers_card(monkeypatch):
    """Under ``auto`` and through the seam, the shard list starts at the
    caller's card, so shard 0 runs there and on the caller's stream."""
    monkeypatch.delenv("BFTKV_SHARD", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert rns.shard_devices("cuda:0") == cards
    assert rns.shard_devices("cuda:2") == cards[2:] + cards[:2]
    assert rns._row_shards(cards[3], 64) == [cards[3]] + cards[:3]
    with rns.shard_over(["cuda:0", "cuda:1", "cuda:1"]):
        assert rns.shard_devices("cuda:1") == [cards[1], cards[1], cards[0]]
        assert rns.shard_devices("cuda:3") == [cards[0], cards[1], cards[1]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rns.shard_devices("cuda:0") is None


def test_split_verify_equals_unsplit_and_host(verify_case, launches):
    sigs, ems, idx, urows, want = verify_case
    unsplit = rns.verify_e65537_rns_indexed(sigs, ems, idx, urows, device="cpu")
    assert launches["verify"] == 1
    with rns.shard_over(["cpu", "cpu"]):
        split = rns.verify_e65537_rns_indexed(sigs, ems, idx, urows, device="cpu")
    assert launches["verify"] == 3  # 512 padded rows in two shards of 256
    np.testing.assert_array_equal(split, unsplit)
    np.testing.assert_array_equal(split, want)
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())


def test_split_pow_equals_unsplit_and_host_pow(pow_case, launches):
    bases, exps, mods, want = pow_case
    assert rns.power_mod_rns(bases, exps, mods, n_bits=512, device="cpu") == want
    assert launches["pow"] == 1
    with rns.shard_over(["cpu", "cpu"]):
        d = rns.power_mod_rns(bases, exps, mods, n_bits=512, device="cpu", defer=True)
        assert launches["pow"] == 3 and d.events == () and d.event is None
        assert d.wait() == want
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())


def test_unsplit_under_shard_off_or_a_batch_that_does_not_divide(pow_case, launches, monkeypatch):
    bases, exps, mods, want = pow_case
    with rns.shard_over(["cpu", "cpu", "cpu"]):  # 128 padded rows: 3 does not divide
        assert rns.power_mod_rns(bases, exps, mods, n_bits=512, device="cpu") == want
    assert launches["pow"] == 1
    monkeypatch.setenv("BFTKV_SHARD", "off")
    with rns.shard_over(["cpu", "cpu"]):
        assert rns.power_mod_rns(bases, exps, mods, n_bits=512, device="cpu") == want
    assert launches["pow"] == 2


def test_a_shard_error_reaches_the_caller_with_every_slot_released(pow_case, monkeypatch):
    """A launch error of the second shard propagates; the first shard's
    slot, already launched, is released (as is the failed one's)."""
    bases, exps, mods, _want = pow_case
    real = cuda_rns.pow_cuda
    calls = []

    def second_fails(*a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("rns pow kernel launch failed: injected")
        return real(*a)

    monkeypatch.setattr(cuda_rns, "pow_cuda", second_fails)
    with rns.shard_over(["cpu", "cpu"]):
        with pytest.raises(RuntimeError, match="injected"):
            rns.power_mod_rns(bases, exps, mods, n_bits=512, device="cpu", defer=True)
    assert len(calls) == 2
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())


def test_a_shard_error_at_collection_reaches_wait(pow_case, monkeypatch):
    """An error while one shard's result is read (its event, its copy out)
    reaches ``wait()`` after every shard's slot is released."""
    bases, exps, mods, _want = pow_case
    real = devbuf.Lease.collect
    seen = []

    def collect(self, read):
        seen.append(1)
        if len(seen) == 1:
            self.release()
            raise RuntimeError("device lost: injected")
        return real(self, read)

    monkeypatch.setattr(devbuf.Lease, "collect", collect)
    with rns.shard_over(["cpu", "cpu"]):
        d = rns.power_mod_rns(bases, exps, mods, n_bits=512, device="cpu", defer=True)
    with pytest.raises(RuntimeError, match="injected"):
        d.wait()
    assert len(seen) == 2  # the second shard was still collected
    assert all(r["in_flight"] == 0 for r in devbuf.stats().values())


def test_entry_operands_have_the_references_shapes_and_dtypes():
    fn, args = entry.entry("cpu")
    theirs = ref_entry._example_operands(batch=8)
    assert len(args) == len(theirs) == 8
    assert [(a.shape, a.dtype) for a in args] == [(a.shape, a.dtype) for a in theirs]
    ok = fn(*args)
    assert ok.dtype == torch.bool and ok.tolist() == [True] * 8


def test_flat_verify_refuses_halves_out_of_range():
    _fn, args = entry.entry("cpu")
    bad = list(args)
    bad[0] = bad[0].copy()
    bad[0][0, 0] = 256
    with pytest.raises(ValueError, match="below 256"):
        entry.flat_verify(*bad, device="cpu")


@pytest.mark.parametrize("n, pow_shards", [(2, 2), (3, 1)])
def test_dryrun_multichip_on_cpu_shards(n, pow_shards, launches):
    out = entry.dryrun_multichip(n, "cpu")
    assert out == {"devices": ["cpu"] * n, "batch": 2 * n, "votes": 2 * n - 1,
                   "pow_shards": pow_shards}
    assert launches == {"verify": n, "pow": pow_shards}
